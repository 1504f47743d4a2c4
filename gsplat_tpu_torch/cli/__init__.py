"""Command-line entry points (counterpart of ``gsplat_tpu.cli``)."""
