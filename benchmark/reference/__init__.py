"""The plain reference of the benchmark: 3D Gaussian Splatting's projection,
tile binning, front-to-back compositing, viewer edits and the majority
vote, written from their published definitions in plain PyTorch.

It imports nothing of the program under test (``gsplat_tpu_torch``), nor
JAX or ``gsplat_tpu``, and takes nothing the program made: every table it
needs (scene, cameras, seg maps, the viewer's palette) it makes itself from
the benchmark's own generator and the configuration files.

``Precision`` selects how its matrix products round: ``"f32"`` (TF32 off,
the configuration's precision) or ``"tf32"`` (their operands rounded to
TF32's 10-bit mantissa, as a tensor core does), which is the control that
the checks must fail.
"""
