"""Training: losses, the train steps with scaled Adam, and adaptive density
control (counterpart of ``gsplat_tpu.models``)."""
