"""The yardstick's arithmetic: the least work of each kernel role and the
published peaks of the card it is divided by.

Frozen copies, so that a change to the program cannot move the yardstick:

- The per-pair charges and byte rules are those of
  ``gsplat_tpu_torch/utils/roofline.py`` (``Q_TEST_OPS``, ``ALPHA_OPS``,
  ``B1_OPS_PER_LIVE``, ``B2_OPS_PER_LIVE``, ``B5_OPS_PER_LIVE``,
  ``blend_bytes``, ``bound``), as they stood when the benchmark was
  defined. Their reasons are given there: a multiply
  feeding an add is one FMA instruction; every tested (instance, pixel)
  pair needs the q test, every pair past the alpha cut the alpha, one expf
  and the kernel's own operations; each input byte is read once and each
  output byte written once.
- The pair counts they multiply (evaluated, tested and live pairs, bbox
  slots) come from the benchmark's own plain projection
  and blend (``benchmark/reference/render.py``) of the timed frame, never
  from the program's binning, so a kernel that skips more work does not
  move the yardstick.
- The peaks are NVIDIA's published H100 SXM5 figures: 67 TFLOP/s of f32
  outside the tensor cores (an FMA two FLOPs, so 33.5 T f32 instructions a
  second), 16 ``expf`` results a clock per SM on the special-function
  units (CUDA C++ Programming Guide, arithmetic instructions, compute
  capability 9.0) at the 1,980 MHz boost clock over 132 SMs, and 3.35 TB/s
  of HBM3.
"""

from __future__ import annotations

from typing import NamedTuple

F32_FLOPS = 67e12
F32_INSTR_PER_S = F32_FLOPS / 2
SFU_PER_CLOCK_PER_SM = 16
SMS = 132
BOOST_HZ = 1.98e9
EXP_PER_S = SFU_PER_CLOCK_PER_SM * SMS * BOOST_HZ
HBM_BYTES_PER_S = 3.35e12

Q_TEST_OPS = 8
ALPHA_OPS = 3
B1_OPS_PER_LIVE = 6
B2_OPS_PER_LIVE = 24
B5_OPS_PER_LIVE = B1_OPS_PER_LIVE + 1
OPS_PER_LIVE = {"B1": B1_OPS_PER_LIVE, "B2": B2_OPS_PER_LIVE,
                "B5": B5_OPS_PER_LIVE}
TABLE_COLS = 16   # the blend kernels' per-gaussian parameter row, f32
FLOATS_PER_GAUSSIAN = {0: 14, 1: 23, 2: 38, 3: 59}   # by SH degree

# The symbols of the program's kernels, one role each (the names its
# ``csrc/`` sources give them). A role whose symbol no longer appears in a
# trace reads nothing.
KERNELS = {"B1": "blend_fwd_kernel", "B2": "blend_bwd_kernel",
           "B3": "cumsum_rows_kernel", "gathers": "fold_segments_kernel",
           "B4": "enum_keys_kernel", "B5": "blend_vis_kernel"}


class Frame(NamedTuple):
    """What one frame's data needs, counted by the reference."""

    gaussians: int
    slots: int          # bbox tile slots (the fold's rows)
    tiles: int
    width: int
    height: int
    pairs: tuple        # (evaluated, tested, live) at the frame's stop rule


def least_s(nbytes: float, ops: float, exps: float) -> float:
    """Seconds at the published peaks: the larger of the bytes at the HBM
    rate and the f32 instructions (or the expf results, if those take
    longer) at theirs."""
    return max(nbytes / HBM_BYTES_PER_S, ops / F32_INSTR_PER_S,
               exps / EXP_PER_S)


def blend_bytes(kernel: str, f: Frame) -> int:
    common = f.gaussians * TABLE_COLS * 4 + f.slots * 4 + (f.tiles + 1) * 4
    if kernel == "B2":
        return common + f.width * f.height * 8 * 4 + f.slots * TABLE_COLS * 4
    extra = f.slots * 4 if kernel == "B5" else 0
    return common + f.width * f.height * 6 * 4 + extra


def blend_least(kernel: str, f: Frame) -> float:
    _, tested, live = f.pairs
    ops = tested * Q_TEST_OPS + live * (ALPHA_OPS + OPS_PER_LIVE[kernel])
    return least_s(blend_bytes(kernel, f), ops, live)


def frame_bytes(gaussians: int, sh_degree: int, width: int,
                height: int) -> int:
    """Bytes of a viewer frame besides the blend: the parameters read and
    the uint8 frame written."""
    return gaussians * FLOATS_PER_GAUSSIAN[sh_degree] * 4 + width * height * 3


def label_bytes(gaussians: int, sh_degree: int) -> int:
    """Bytes of a labeling view besides the blend: the parameters read and
    the visibility row written."""
    return gaussians * FLOATS_PER_GAUSSIAN[sh_degree] * 4 + gaussians
