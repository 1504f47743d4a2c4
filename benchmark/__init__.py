"""The benchmark of the PyTorch/CUDA port (``gsplat_tpu_torch``): cells of
a configuration and a traffic mix, their windows, traces and checks against
a plain reference. ``python3 benchmark/run.py --help`` runs one cell."""
