"""Segmentation evaluation: IoU and mask matching (counterpart of
``gsplat_tpu.evaluation``)."""
