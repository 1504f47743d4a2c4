"""Inclusive scans down the 64-row chunk axis (kernels P2).

Counterpart of ``scripts/profile_scan_variants.py``, which compares two
scans of the blend kernels' chunk axis inside Pallas kernels: ``flat``
(log steps 1, 2, ..., 32 over the 64 rows) and ``grouped`` (within 8-row
groups, then the group totals, then the spread). Here each is one CUDA
kernel of ``csrc/scan_probe.cu``, one column a thread with its 64 rows in
registers:

- :func:`scan` ``(x, op, variant)``: an inclusive product or sum scan down
  axis 0 of an f32 [64, P] array (the TPU's ``k_prod`` / ``k_sum``);
- :func:`scan_rounds` ``(x, variant)``: four rounds of
  ``acc <- cumsum(cumprod(acc)) * 1e-6 + x`` (the TPU's ``kernel``).

The plain versions combine in the kernels' order: flat in the TPU
``scan_flat``'s, so the two agree bit for bit; grouped each group in
sequence, so it agrees with ``scan_grouped`` to rounding::

    python -m gsplat_tpu_torch.utils.scan_probe [--bench] [--device cpu]
        [--source PATH]

checks both variants against float64 ``cumprod`` / ``cumsum`` on a seeded
[64, 128] input (the bars of ``_check``: 1e-5 for the product, 1e-3 for the
sum) and, with ``--bench``, times the rounds of both on [64, 1024] over
1024 passes. On the card, ``--source`` times another build of a
``csrc/scan_probe.cu`` with the same C entry point (e.g. an earlier design
from git history) in turns with the committed build (:func:`compare`).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from gsplat_tpu_torch import _kernels
from gsplat_tpu_torch.scene import resolve_device
from gsplat_tpu_torch.utils.blend_probe import _in_turns, _load, _Swap
from gsplat_tpu_torch.utils.profiling import device_timer, graph_ms

CHUNK = 64
GROUP = 8
ROUNDS = 4
BENCH_COLS = 1024
BENCH_REPS = 1024
_MODES = {"prod": 0, "sum": 1, "rounds": 2}
_VARIANTS = ("flat", "grouped")


def _combine(op: str):
    return torch.mul if op == "prod" else torch.add


def _flat_plain(x: torch.Tensor, op: str) -> torch.Tensor:
    """The flat kernel's scan, in ``scan_flat``'s order: log steps
    k = 1, 2, ..., 32 over the 64 rows, row r combining row r - k."""
    f = _combine(op)
    k = 1
    while k < CHUNK:
        x = torch.cat([x[:k], f(x[k:], x[:-k])], dim=0)
        k *= 2
    return x


def _grouped_plain(x: torch.Tensor, op: str) -> torch.Tensor:
    """The grouped kernel's scan: each 8-row group in sequence, the group
    totals combined in order, that exclusive prefix spread over the
    group."""
    f = _combine(op)
    groups = list(x.reshape(CHUNK // GROUP, GROUP, -1).unbind(0))
    for g, rows in enumerate(groups):
        r = list(rows.unbind(0))
        for j in range(1, GROUP):
            r[j] = f(r[j], r[j - 1])
        groups[g] = r
    out = groups[0]
    e = groups[0][-1]
    for g in range(1, len(groups)):
        out = out + [f(v, e) for v in groups[g]]
        e = f(e, groups[g][-1])
    return torch.stack(out, dim=0)


def _scan_plain(x: torch.Tensor, op: str, variant: str) -> torch.Tensor:
    return (_flat_plain if variant == "flat" else _grouped_plain)(x, op)


def _rounds_plain(x: torch.Tensor, variant: str) -> torch.Tensor:
    acc = x
    for _ in range(ROUNDS):
        a = _scan_plain(acc, "prod", variant)
        b = _scan_plain(a, "sum", variant)
        acc = b * 1e-6 + x
    return acc


def _launch(wrapper, variant: str, x: torch.Tensor, mode: str,
            reps: int) -> torch.Tensor:
    out = torch.empty_like(x)
    fn = _kernels.function("scan_probe")
    err = fn(_VARIANTS.index(variant), _MODES[mode], x.data_ptr(), x.shape[1],
             out.data_ptr(), reps, _kernels.stream(x.device))
    wrapper.launches += 1
    _kernels.check("scan_probe", err)
    return out


def flat_scan_kernel(x: torch.Tensor, mode: str, reps: int) -> torch.Tensor:
    """Launch the flat kernel of ``csrc/scan_probe.cu`` (mode ``prod``,
    ``sum`` or ``rounds``; ``reps`` passes that write one output)."""
    return _launch(flat_scan_kernel, "flat", x, mode, reps)


flat_scan_kernel.launches = 0


def grouped_scan_kernel(x: torch.Tensor, mode: str, reps: int
                        ) -> torch.Tensor:
    """Launch the grouped kernel of ``csrc/scan_probe.cu``."""
    return _launch(grouped_scan_kernel, "grouped", x, mode, reps)


grouped_scan_kernel.launches = 0
KERNELS = {"flat": flat_scan_kernel, "grouped": grouped_scan_kernel}


def _validate(name: str, x: torch.Tensor, variant: str, reps: int
                 ) -> None:
    if variant not in _VARIANTS:
        raise ValueError(f"{name}: variant is 'flat' or 'grouped'")
    if x.dtype != torch.float32 or x.dim() != 2 or x.shape[0] != CHUNK or \
            x.shape[1] == 0 or not x.is_contiguous():
        raise ValueError(f"{name} takes a contiguous f32 [64, P] array")
    if not 1 <= reps <= 65535:
        raise ValueError(f"{name} needs 1 <= reps <= 65535")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no kernel for {x.device}")


def scan(x: torch.Tensor, op: str, variant: str) -> torch.Tensor:
    """Inclusive ``op`` ('prod' or 'sum') scan down axis 0 of f32 [64, P].

    Replaces ``scripts/profile_scan_variants.py``'s ``k_prod`` / ``k_sum``
    (``scan_grouped``, and ``scan_flat`` inside ``kernel``). On the card it
    launches ``csrc/scan_probe.cu`` (bound by operations: one combine an
    element); CPU tensors take the plain version."""
    if op not in ("prod", "sum"):
        raise ValueError("scan: op is 'prod' or 'sum'")
    _validate("scan", x, variant, 1)
    if x.device.type == "cpu":
        return _scan_plain(x, op, variant)
    return KERNELS[variant](x, op, 1)


def scan_rounds(x: torch.Tensor, variant: str, reps: int = 1
                ) -> torch.Tensor:
    """Four rounds of ``acc <- scan_sum(scan_prod(acc)) * 1e-6 + x`` on f32
    [64, P], the TPU probe's load. On the card the kernel runs ``reps``
    passes over ``x`` held on chip (the TPU grid's VMEM-resident block), to
    time a compute-bound launch; the result is one pass's, bit for bit.

    Replaces ``scripts/profile_scan_variants.py::kernel``; CPU tensors take
    the plain version (once)."""
    _validate("scan_rounds", x, variant, reps)
    if x.device.type == "cpu":
        return _rounds_plain(x, variant)
    return KERNELS[variant](x, "rounds", reps)


def probe_input(device: torch.device, cols: int = 128) -> torch.Tensor:
    """``_check``'s input: seeded uniform [0.5, 1) of shape [64, cols]."""
    rng = np.random.default_rng(0)
    x = rng.random((CHUNK, cols)).astype(np.float32) * 0.5 + 0.5
    return torch.from_numpy(x).to(device)


def check(device: torch.device) -> dict:
    """Both variants against float64 cumprod / cumsum (bars 1e-5, 1e-3)."""
    x = probe_input(device)
    want = {"prod": torch.cumprod(x.double(), 0),
            "sum": torch.cumsum(x.double(), 0)}
    errs = {}
    for variant in _VARIANTS:
        for op in ("prod", "sum"):
            got = scan(x, op, variant).double()
            errs[f"{variant}_{op}"] = float((got - want[op]).abs().max())
    ok = all(v < (1e-5 if k.endswith("prod") else 1e-3)
             for k, v in errs.items())
    return {"max_abs_err_vs_float64": errs, "ok": ok}


def bench(device: torch.device) -> dict:
    """Seconds per launch of the rounds of each variant on [64, 1024] over
    1024 passes (CUDA events on the card)."""
    x = probe_input(device, BENCH_COLS)
    reps = BENCH_REPS if device.type == "cuda" else 1
    return {variant: device_timer(
        lambda xx, c, v=variant: scan_rounds(xx, v, reps), (x,), iters=5)
        for variant in _VARIANTS}


def compare(device: torch.device, source: str) -> dict:
    """The rounds of both variants on [64, 1024] at 1024 and 256 passes,
    through a build of ``source`` and through the committed build in turns,
    replayed from a CUDA graph (ms a launch), each build's output held
    against the plain rounds (flat bit for bit, grouped max abs error).
    The builds go to ``build/blend_probe/``."""
    _, fn, info = _load("scan_probe_source", "scan_probe",
                        Path(source).read_text())
    x = probe_input(device, BENCH_COLS)
    out = {"source": source, "build": info}
    for variant in _VARIANTS:
        want = _rounds_plain(x, variant)
        for reps in (BENCH_REPS, BENCH_REPS // 4):
            call = lambda: scan_rounds(x, variant, reps)
            with _Swap("scan_probe", fn):
                got = {"variant": call()}
            got["committed"] = call()
            out[f"{variant} x{reps}"] = {
                "bit_equal_to_plain": {k: torch.equal(v, want)
                                       for k, v in got.items()},
                "max_abs_err_vs_plain": {k: float((v - want).abs().max())
                                         for k, v in got.items()},
                "graph_ms": _in_turns(("scan_probe", fn), call, graph_ms)}
    return out


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--bench", action="store_true",
                    help="also time the rounds of both variants")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the card)")
    ap.add_argument("--source", default=None,
                    help="another csrc/scan_probe.cu to time against (card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    res = check(device)
    if args.bench:
        res["rounds_s_per_launch"] = bench(device)
        res["passes_per_launch"] = BENCH_REPS if device.type == "cuda" else 1
    if args.source is not None:
        res["compare"] = compare(device, args.source)
    print(json.dumps(res))
    return 0 if res["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
