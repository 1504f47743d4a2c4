"""Majority-vote labeling: the seg-map sources and the vote (counterpart of
``gsplat_tpu.label``)."""
