"""IoU evaluation + mask matching (Image_Segmentation/evaluation.py parity).

A copy of the numpy module ``gsplat_tpu.evaluation.iou``:

- ``iou``: binarized intersection-over-union (evaluation.py:24-35);
- ``best_ious``: greedy best-match of predicted masks vs ground truth
  (py:38-56);
- ``segmentation_map_from_masks``: stacked binary masks -> int map
  (py:59-69);
- plus multi-class mean-IoU / confusion utilities for the rendered label
  maps the renderer produces (capability beyond the reference).

Arrays are numpy; a label map from ``render`` goes in as
``out["label_map"].cpu().numpy()``.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np


def iou(mask_a: np.ndarray, mask_b: np.ndarray) -> float:
    """Binarized IoU (evaluation.py:24-35); empty-union -> 0."""
    a = np.asarray(mask_a) != 0
    b = np.asarray(mask_b) != 0
    union = np.logical_or(a, b).sum()
    if union == 0:
        return 0.0
    return float(np.logical_and(a, b).sum() / union)


def best_ious(
    predicted_masks: Sequence[np.ndarray],
    ground_truth_masks: Sequence[np.ndarray],
) -> List[float]:
    """For each ground-truth mask, the best IoU over predictions
    (evaluation.py:38-56)."""
    out = []
    for gt in ground_truth_masks:
        best = 0.0
        for pred in predicted_masks:
            best = max(best, iou(pred, gt))
        out.append(best)
    return out


def segmentation_map_from_masks(masks: Sequence[np.ndarray]) -> np.ndarray:
    """Stack binary masks into an int map; later masks overwrite
    (evaluation.py:59-69 semantics). Background = 0, mask i -> i+1."""
    masks = [np.asarray(m) != 0 for m in masks]
    if not masks:
        raise ValueError("no masks given")
    seg = np.zeros(masks[0].shape, dtype=np.int32)
    for i, m in enumerate(masks):
        seg[m] = i + 1
    return seg


def class_ious(pred: np.ndarray, gt: np.ndarray,
               ignore: Tuple[int, ...] = ()) -> Dict[int, float]:
    """Per-class IoU between two integer label maps."""
    pred = np.asarray(pred)
    gt = np.asarray(gt)
    out: Dict[int, float] = {}
    for c in np.unique(np.concatenate([pred.ravel(), gt.ravel()])):
        if int(c) in ignore:
            continue
        out[int(c)] = iou(pred == c, gt == c)
    return out


def mean_iou(pred: np.ndarray, gt: np.ndarray,
             ignore: Tuple[int, ...] = ()) -> float:
    vals = list(class_ious(pred, gt, ignore).values())
    return float(np.mean(vals)) if vals else 0.0


def _round_up(x: np.float32) -> int:
    """Pillow's ``ROUND_UP`` of an f32 value: half away from zero."""
    if x >= 0:
        return int(np.floor(x + np.float32(0.5)))
    return -int(np.floor(-x + np.float32(0.5)))


def _round_down(x: np.float32) -> int:
    """Pillow's ``ROUND_DOWN`` of an f32 value: half toward zero."""
    if x >= 0:
        return int(np.ceil(x - np.float32(0.5)))
    return -int(np.ceil(-x - np.float32(0.5)))


class _Edge:
    """A polygon edge between integer vertices, its slope in f32."""

    def __init__(self, x0: int, y0: int, x1: int, y1: int):
        self.x0, self.y0, self.x1, self.y1 = x0, y0, x1, y1
        self.xmin, self.xmax = min(x0, x1), max(x0, x1)
        self.ymin, self.ymax = min(y0, y1), max(y0, y1)
        self.dx = (np.float32(0.0) if y0 == y1 else
                   np.float32(x1 - x0) / np.float32(y1 - y0))

    def x_at(self, y: int) -> np.float32:
        return np.float32(y - self.y0) * self.dx + np.float32(self.x0)

    def ends_at(self, x: int, y: int) -> bool:
        return (x, y) in ((self.x0, self.y0), (self.x1, self.y1))


def fill_polygon(mask: np.ndarray, points, value: int = 1) -> np.ndarray:
    """Fill a polygon into ``mask`` [H, W] in place, pixel for pixel as
    Pillow's ``ImageDraw.polygon(points, fill=value)`` does: vertices
    truncated to integers; horizontal edges drawn whole; a scan line per
    row through the f32 crossings of the other edges, a crossing at an
    edge's lower end counted twice above the last row, each pair of sorted
    crossings filling ``ROUND_UP(a)..ROUND_DOWN(b)``; and where two edges
    whose slopes have one sign meet at a vertex, the vertex's crossing
    moved to one pixel short of the nearer edge's crossing on the next row
    (the row before, on the last row), so a sharp corner stays joined to
    the rows below it."""
    h, w = mask.shape
    xy = [(int(x), int(y)) for x, y in points]

    def hline(x0: int, y: int, x1: int) -> None:
        if 0 <= y < h:
            x0, x1 = max(x0, 0), min(x1, w - 1)
            if x0 <= x1:
                mask[y, x0:x1 + 1] = value

    edges = []
    for i in range(len(xy) - 1):
        (x0, y0), (x1, y1) = xy[i], xy[i + 1]
        # a horizontal edge that carries on another in its direction
        # extends it
        if i and y0 == y1 == xy[i - 1][1]:
            if x1 > x0 > xy[i - 1][0]:
                edges[-1].xmax = x1
                continue
            if x1 < x0 < xy[i - 1][0]:
                edges[-1].xmin = x1
                continue
        edges.append(_Edge(x0, y0, x1, y1))
    if xy and xy[-1] != xy[0]:
        edges.append(_Edge(*xy[-1], *xy[0]))
    if not edges:
        return mask
    table = []
    for e in edges:
        if e.ymin == e.ymax:
            hline(e.xmin, e.ymin, e.xmax)
        else:
            table.append(e)
    ymin = max(min([h - 1] + [e.ymin for e in edges]), 0)
    ymax = min(max([0] + [e.ymax for e in edges]), h)
    for y in range(ymin, ymax + 1):
        xx = []
        for i, cur in enumerate(table):
            if not cur.ymin <= y <= cur.ymax:
                continue
            xx.append(cur.x_at(y))
            if y == cur.ymax and y < ymax:
                xx.append(xx[-1])
            elif cur.dx != 0 and y in (cur.y0, cur.y1):
                v = cur.x0 if y == cur.y0 else cur.x1
                off = -1 if y == ymax else 1
                for oth in table[:i]:
                    if (oth.dx == 0 or (oth.dx > 0) != (cur.dx > 0)
                            or not oth.ends_at(v, y)
                            or not cur.ymin <= y + off <= cur.ymax
                            or not oth.ymin <= y + off <= oth.ymax):
                        continue
                    a, b = cur.x_at(y + off), oth.x_at(y + off)
                    near = a if abs(a - v) < abs(b - v) else b
                    xx[-1] = np.float32(
                        max(_round_up(near) - 1, v) if near > v
                        else min(_round_up(near) + 1, v))
                    break
        xx.sort()
        for a, b in zip(xx[0::2], xx[1::2]):
            hline(_round_up(a), y, _round_down(b))
    return mask


def labelme_mask(json_path: str, label_name: str, height: int, width: int
                 ) -> np.ndarray:
    """Rasterize a labelme polygon annotation to a binary mask (the
    ground-truth format under Image_Segmentation/labels/): each polygon of
    ``label_name`` filled as the JAX package's ``ImageDraw.polygon(...,
    fill=1)`` fills it (:func:`fill_polygon`), in numpy."""
    import json

    with open(json_path) as f:
        d = json.load(f)
    mask = np.zeros((height, width), dtype=np.int32)
    for shape in d.get("shapes", []):
        if shape.get("label") == label_name:
            fill_polygon(mask, shape["points"])
    return mask
