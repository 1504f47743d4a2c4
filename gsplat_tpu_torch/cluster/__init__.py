"""3D clustering labelers: k-means and region growing (counterpart of
``gsplat_tpu.cluster``)."""
