"""Segmentation-map sources for the majority-vote labeler.

A copy of ``gsplat_tpu.label.adapters``: the reference's three backends
behind one switch (deep_learning_segmentation.py:219-238), SegFormer ADE20K
semantic, Mask2Former ADE20K semantic, YOLO11 instance, plus SAM and an
``npy`` source that replays precomputed maps (the intermediate ``.npy``
dumps the reference writes per image, py:165). The model backends' heavy
dependencies (``transformers``, ``ultralytics``, ``PIL``) import lazily and
fail with clear errors when absent; their models run on ``device``, the
card unless the caller names another.
"""

from __future__ import annotations

import colorsys
import os
from typing import Callable, Dict, Optional

import numpy as np
import torch

from gsplat_tpu_torch.io import png
from gsplat_tpu_torch.scene import DeviceLike, resolve_device

SegmentFn = Callable[[str, "np.ndarray"], np.ndarray]  # (name, HxWx3) -> HxW i32


class NpySource:
    """Replays ``{output_dir}/{img_name}_seg.npy`` maps (reference py:165)."""

    def __init__(self, directory: str, suffix: str = "_seg.npy"):
        self.directory = directory
        self.suffix = suffix

    def __call__(self, img_name: str, image: Optional[np.ndarray] = None
                 ) -> np.ndarray:
        path = os.path.join(self.directory, img_name + self.suffix)
        return np.load(path).astype(np.int32)


class SegformerAdapter:
    """nvidia/segformer-b5-finetuned-ade-640-640 semantic segmentation
    (reference py:135-144, 223-227): argmax of logits, nearest-resized to
    the original resolution."""

    MODEL = "nvidia/segformer-b5-finetuned-ade-640-640"

    def __init__(self, model_name: Optional[str] = None,
                 device: DeviceLike = None):
        from transformers import (SegformerForSemanticSegmentation,
                                  SegformerImageProcessor)

        self.device = resolve_device(device)
        name = model_name or self.MODEL
        self.processor = SegformerImageProcessor.from_pretrained(name)
        self.model = SegformerForSemanticSegmentation.from_pretrained(
            name).to(self.device).eval()

    def __call__(self, img_name: str, image: np.ndarray) -> np.ndarray:
        with torch.no_grad():
            inputs = self.processor(images=image, return_tensors="pt").to(
                self.device)
            logits = self.model(**inputs).logits  # [1, C, h, w]
            seg = logits.argmax(dim=1)[0].cpu().numpy().astype(np.int32)
        return _nearest_resize(seg, image.shape[0], image.shape[1])


class Mask2FormerAdapter:
    """facebook/mask2former-swin-large-ade-semantic (reference py:149-158)."""

    MODEL = "facebook/mask2former-swin-large-ade-semantic"

    def __init__(self, model_name: Optional[str] = None,
                 device: DeviceLike = None):
        from transformers import (AutoImageProcessor,
                                  Mask2FormerForUniversalSegmentation)

        self.device = resolve_device(device)
        name = model_name or self.MODEL
        self.processor = AutoImageProcessor.from_pretrained(name)
        self.model = Mask2FormerForUniversalSegmentation.from_pretrained(
            name).to(self.device).eval()

    def __call__(self, img_name: str, image: np.ndarray) -> np.ndarray:
        with torch.no_grad():
            inputs = self.processor(images=image, return_tensors="pt").to(
                self.device)
            outputs = self.model(**inputs)
            seg = self.processor.post_process_semantic_segmentation(
                outputs, target_sizes=[image.shape[:2]])[0]
        return seg.cpu().numpy().astype(np.int32)


class YoloAdapter:
    """YOLO11 instance segmentation (reference py:85-124): confidence > 0.5,
    later instances overwrite earlier, background = -1."""

    def __init__(self, weights: str = "yolo11x-seg.pt",
                 confidence: float = 0.5, device: DeviceLike = None):
        try:
            from ultralytics import YOLO
        except ImportError as e:
            raise ImportError(
                "YoloAdapter requires the 'ultralytics' package, which is "
                "not installed in this environment; use the 'npy', "
                "'segformer' or 'mask2former' backends instead") from e
        self.model = YOLO(weights)
        self.confidence = confidence
        self.device = resolve_device(device)

    def __call__(self, img_name: str, image: np.ndarray) -> np.ndarray:
        results = self.model(image, verbose=False, device=self.device)
        h, w = image.shape[:2]
        seg = np.full((h, w), -1, dtype=np.int32)
        if not results or results[0].masks is None:
            return seg
        r = results[0]
        for mask, box in zip(r.masks.data, r.boxes):
            if float(box.conf) <= self.confidence:
                continue
            m = _nearest_resize(
                mask.cpu().numpy().astype(np.int32), h, w)
            seg[m > 0] = int(box.cls)
        return seg


def masks_to_instance_map(masks, h: int, w: int) -> np.ndarray:
    """Paint binary masks into an instance map: masks sorted by area
    DESCENDING, each painted with its rank, so smaller (detail) masks
    overwrite larger ones; background = -1. This is the reference
    notebook's mask -> segmentation-map step
    (Image_Segmentation/evaluation.py::generate_segmentation_map semantics
    with deterministic ordering)."""
    seg = np.full((h, w), -1, np.int32)
    order = sorted(range(len(masks)),
                   key=lambda i: int(np.asarray(masks[i]).sum()),
                   reverse=True)
    for rank, i in enumerate(order):
        m = _nearest_resize(np.asarray(masks[i]).astype(np.int32), h, w)
        seg[m > 0] = rank
    return seg


class SamAdapter:
    """Segment Anything automatic mask generation (reference:
    Image_Segmentation/Segment_anything.ipynb cells 1-7 — vit_b
    ``SamAutomaticMaskGenerator`` + IoU vs labelme ground truth; here via
    transformers' ``mask-generation`` pipeline on facebook/sam-vit-base).

    Returns an INSTANCE map via :func:`masks_to_instance_map`;
    ``last_masks`` keeps the raw binary masks (area-descending) for IoU
    evaluation against labelme GT
    (gsplat_tpu_torch.evaluation.iou.best_ious)."""

    MODEL = "facebook/sam-vit-base"

    def __init__(self, model_name: Optional[str] = None,
                 device: DeviceLike = None, points_per_batch: int = 32):
        try:
            from transformers import pipeline
        except ImportError as e:
            raise ImportError(
                "SamAdapter requires the 'transformers' package") from e
        self.pipe = pipeline("mask-generation",
                             model=model_name or self.MODEL,
                             device=resolve_device(device))
        self.points_per_batch = points_per_batch
        self.last_masks = None

    def __call__(self, img_name: str, image: np.ndarray) -> np.ndarray:
        from PIL import Image as PILImage

        out = self.pipe(
            PILImage.fromarray(np.asarray(image).astype(np.uint8)),
            points_per_batch=self.points_per_batch)
        masks = [np.asarray(m, bool) for m in out["masks"]]
        h, w = image.shape[:2]
        order = sorted(range(len(masks)),
                       key=lambda i: int(masks[i].sum()), reverse=True)
        self.last_masks = [masks[i] for i in order]
        return masks_to_instance_map(masks, h, w)


BACKENDS: Dict[str, type] = {
    "segformer": SegformerAdapter,
    "mask2former": Mask2FormerAdapter,
    "yolo": YoloAdapter,
    "sam": SamAdapter,
    "npy": NpySource,
}


def make_backend(name: str, **kwargs) -> SegmentFn:
    if name not in BACKENDS:
        raise ValueError(f"unknown backend {name!r}; one of {list(BACKENDS)}")
    return BACKENDS[name](**kwargs)


def _nearest_resize(seg: np.ndarray, h: int, w: int) -> np.ndarray:
    """Nearest-neighbor resize of an int map (reference py:140-143)."""
    if seg.shape == (h, w):
        return seg
    ys = (np.arange(h) * seg.shape[0] / h).astype(np.int64)
    xs = (np.arange(w) * seg.shape[1] / w).astype(np.int64)
    return seg[ys[:, None], xs[None, :]]


def save_visualization(path: str, image: np.ndarray, seg: np.ndarray,
                       num_classes: int = 150) -> None:
    """Side-by-side image / colorized map PNG (reference py:163-214),
    written by the port's own encoder (``io/png.py``), not PIL."""
    colors = np.zeros((num_classes + 1, 3), np.uint8)
    for i in range(num_classes):
        r, g, b = colorsys.hsv_to_rgb(i / num_classes, 0.9, 0.9)
        colors[i + 1] = (int(r * 255), int(g * 255), int(b * 255))
    seg_vis = colors[np.clip(seg + 1, 0, num_classes)]
    h = min(image.shape[0], seg_vis.shape[0])
    side = np.concatenate(
        [np.asarray(image)[:h].astype(np.uint8), seg_vis[:h]], axis=1)
    png.write_png(path, side)
