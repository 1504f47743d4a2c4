"""Static assets of the viewer (counterpart of ``gsplat_tpu.assets``)."""
