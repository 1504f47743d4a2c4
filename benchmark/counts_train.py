"""The yardstick's arithmetic for a training step, beside the frozen
:mod:`benchmark.counts` and on its peaks.

- The fold (``fold_rows_kernel``, each gaussian's sum of its own gradient
  rows): every row of the frame's bbox slots read once (16 f32), each
  gaussian's start and count read (8 bytes) and its row written (64
  bytes). The slot count is the reference's own binning's
  (``counts.Frame.slots``), never the program's.
- A step's bytes besides its blend kernels, which it must move once: the
  parameters and both Adam moments read and written, the gradient read,
  the view's f32 target read.
"""

from __future__ import annotations

from benchmark import counts

ROW_BYTES = counts.TABLE_COLS * 4
FOLD_KERNEL = "fold_rows_kernel"


def fold_bytes(f: counts.Frame) -> int:
    return f.slots * ROW_BYTES + f.gaussians * (8 + ROW_BYTES)


def fold_least(f: counts.Frame) -> float:
    return counts.least_s(fold_bytes(f), 0, 0)


def step_bytes(gaussians: int, sh_degree: int, width: int,
               height: int) -> int:
    state = gaussians * counts.FLOATS_PER_GAUSSIAN[sh_degree] * 4
    return 7 * state + width * height * 3 * 4
