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


def labelme_mask(json_path: str, label_name: str, height: int, width: int
                 ) -> np.ndarray:
    """Rasterize a labelme polygon annotation to a binary mask (the
    ground-truth format under Image_Segmentation/labels/). Needs ``PIL``,
    imported here and not with the module."""
    import json

    from PIL import Image, ImageDraw

    with open(json_path) as f:
        d = json.load(f)
    img = Image.new("L", (width, height), 0)
    draw = ImageDraw.Draw(img)
    for shape in d.get("shapes", []):
        if shape.get("label") != label_name:
            continue
        pts = [tuple(p) for p in shape["points"]]
        draw.polygon(pts, outline=1, fill=1)
    return np.asarray(img, dtype=np.int32)
