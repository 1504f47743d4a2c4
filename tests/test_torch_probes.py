"""The port's card-peak and scan probes (P1, P2), its timing harness and the
roofline report, against the JAX package's scripts on the CPU.

The scripts are imported by path; their Pallas kernels run with
``interpret=True`` on the same seeded numpy inputs as the port's plain
versions (the kernel wrappers take those on CPU tensors). Nothing here
writes ``ROOFLINE.json``.
"""

import functools
import importlib.util
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from gsplat_tpu_torch.utils import profiling, roofline, scan_probe

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]


def _script(name):
    spec = importlib.util.spec_from_file_location(
        f"_{name}", REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def rl():
    return _script("roofline")


@pytest.fixture(scope="module")
def sv():
    return _script("profile_scan_variants")


def _interpret(kernel, x):
    return np.asarray(pl.pallas_call(
        kernel, out_shape=jax.ShapeDtypeStruct(x.shape, jnp.float32),
        interpret=True)(jnp.asarray(x)))


def _block(kind):
    if kind == "ones":
        return np.ones((8, 256), np.float32)
    return (np.random.default_rng(3).random((8, 256)) + 0.5).astype(
        np.float32)


# --- P1: the chains against _fma_kernel / _exp_kernel ---------------------

@pytest.mark.parametrize("kind", ["ones", "uniform"])
@pytest.mark.parametrize("which", ["fma", "expf"])
def test_peak_chains_match_jax(rl, which, kind):
    x = _block(kind)
    kernel = rl._fma_kernel if which == "fma" else rl._exp_kernel
    want = _interpret(kernel, x)
    fn = roofline.fma_chains if which == "fma" else roofline.expf_chains
    # one block of 256 threads per row: thread t reads element t, one round
    got = fn(torch.from_numpy(x.reshape(-1)), blocks=8, iters=1)
    got = got.numpy().reshape(8, 256)
    # XLA on the CPU contracts x * a + b into an FMA, as __fmaf_rn does:
    # the chains agree to float rounding
    assert np.abs(got / want - 1).max() <= 1e-6
    assert fn.launches == 0


def test_peak_chains_carry_over_rounds():
    """iters rounds are one chain of iters x 48 steps, not the first round
    repeated, and thread t reads element t % n."""
    x = torch.from_numpy(_block("uniform").reshape(-1)[:100].copy())
    one = roofline.fma_chains(x, blocks=1, iters=1)
    three = roofline.fma_chains(x, blocks=1, iters=3)
    assert one.shape == (256,)
    assert torch.equal(one[:100], one[100:200])
    assert (three > one).all()
    ex = roofline.expf_chains(x, blocks=1, iters=3)
    # exp(-|c| 1e-3) has its fixed point near 0.999: 8 chains sum to ~7.992
    assert torch.allclose(ex, torch.full_like(ex, 7.992012), atol=1e-5)


def test_peak_wrappers_reject_what_the_kernel_does_not_take():
    x = torch.ones(16)
    for bad in (x.double(), x[::2], torch.ones(2, 8), torch.ones(0)):
        with pytest.raises(ValueError):
            roofline.fma_chains(bad, blocks=1, iters=1)
    for blocks, iters in ((0, 1), (1, 0)):
        with pytest.raises(ValueError):
            roofline.expf_chains(x, blocks=blocks, iters=iters)


def test_bound_takes_the_larger_time():
    rates = roofline.Rates(ops_per_s=1e12, exp_per_s=1e11)
    ms, by, nbytes, ops = roofline.bound(3.35e9, 10**9, 0, rates)
    assert (ms, by, nbytes, ops) == (1.0, "bytes", 3.35e9, 10**9)
    ms, by, _, _ = roofline.bound(0, 10**9, 10**9, rates)
    assert by == "operations" and ms == pytest.approx(10.0)
    sheet = roofline.datasheet_rates(132, 1980.0)
    assert sheet.ops_per_s == roofline.F32_FLOPS / 2
    assert sheet.exp_per_s == pytest.approx(16 * 132 * 1.98e9)


def test_expf_rate_charges_one_instruction_a_step(monkeypatch):
    """The exp chain's step is one FMUL (the -|c| folds into it) besides
    the expf: with fixed launch times the pure rate is exps / (t_exp -
    exps * 1 / fma_rate)."""
    assert roofline.EXP_STEP_OPS == 1
    exps, t_exp, fma_rate = 8e9, 2e-3, 32e12
    assert roofline.pure_expf_rate(exps, t_exp, fma_rate) == pytest.approx(
        exps / (t_exp - exps / fma_rate))
    launch = {roofline.fma_chains: (5, 1e-3), roofline.expf_chains: (3, 2e-3)}
    monkeypatch.setattr(roofline, "_time_launch",
                        lambda fn, x, blocks: launch[fn])
    peaks = roofline.measure_peaks("cpu")
    threads = roofline.BLOCKS_PER_SM * roofline.THREADS
    fma_rate = threads * roofline.CHAINS * roofline.FMA_STEPS * 5 / 1e-3
    exps = threads * roofline.CHAINS * roofline.EXP_STEPS * 3
    assert peaks["fma_per_s"] == pytest.approx(fma_rate)
    assert peaks["expf_per_s"] == pytest.approx(
        exps / (2e-3 - exps / fma_rate))


@pytest.mark.parametrize("issue", [None, 30e12, 34e12])
def test_measured_rates_take_the_larger_f32_peak(issue):
    peaks = dict(fma_per_s=32e12, expf_per_s=4e12, f32_issue_per_s=issue)
    rates = roofline.measured_rates(peaks)
    assert rates.ops_per_s == max(32e12, issue or 0.0)
    assert rates.exp_per_s == 4e12


# --- P2: the scans against scan_flat / scan_grouped / kernel --------------

def _scan_kernel(sv, variant, op):
    f = sv.scan_flat if variant == "flat" else sv.scan_grouped
    combine, identity = ((jnp.multiply, 1.0) if op == "prod"
                         else (jnp.add, 0.0))

    def k(x_ref, o_ref):
        o_ref[...] = f(x_ref[...], combine, identity)

    return k


@pytest.mark.parametrize("variant", ["flat", "grouped"])
@pytest.mark.parametrize("op", ["prod", "sum"])
def test_scan_matches_jax_and_numpy(sv, variant, op):
    x = scan_probe.probe_input("cpu").numpy()
    want = _interpret(_scan_kernel(sv, variant, op), x)
    got = scan_probe.scan(torch.from_numpy(x), op, variant).numpy()
    bar = 1e-6 if op == "prod" else 1e-5
    if variant == "flat":
        # the flat kernel combines in scan_flat's order
        assert np.array_equal(got, want)
    else:
        # the grouped kernel scans each group in sequence, scan_grouped in
        # log steps: a few ulps of the running sum (up to 48 here)
        assert np.abs(got - want).max() <= bar
    ref = np.cumprod(x.astype(np.float64), 0) if op == "prod" else \
        np.cumsum(x.astype(np.float64), 0)
    assert np.abs(got - ref).max() <= bar


@pytest.mark.parametrize("variant", ["flat", "grouped"])
def test_scan_rounds_match_jax(sv, variant):
    x = scan_probe.probe_input("cpu").numpy()
    want = _interpret(functools.partial(sv.kernel, variant), x)
    got = scan_probe.scan_rounds(torch.from_numpy(x), variant).numpy()
    if variant == "flat":
        assert np.array_equal(got, want)
    else:
        assert np.abs(got - want).max() <= 1e-6
    # the rounds move each element by at most 64e-6 of x
    assert np.abs(got - x).max() <= 1e-4


@pytest.mark.parametrize("variant", ["flat", "grouped"])
@pytest.mark.parametrize("op", ["prod", "sum"])
def test_scan_plain_ragged_columns(variant, op):
    # 33 columns: a warp and one more on the card
    x = scan_probe.probe_input("cpu", 33)
    got = scan_probe.scan(x, op, variant).double()
    ref = (torch.cumprod if op == "prod" else torch.cumsum)(x.double(), 0)
    assert got.shape == (64, 33)
    assert (got - ref).abs().max().item() <= (1e-6 if op == "prod" else 1e-5)
    assert torch.equal(scan_probe.scan(x[:, :32].contiguous(), op, variant),
                       scan_probe.scan(x, op, variant)[:, :32])


def test_scan_check_and_wrappers():
    res = scan_probe.check(torch.device("cpu"))
    assert res["ok"], res
    x = scan_probe.probe_input("cpu")
    for bad in (x[:32].contiguous(), x.double(), x.t().contiguous().t()):
        with pytest.raises(ValueError):
            scan_probe.scan(bad, "sum", "flat")
    with pytest.raises(ValueError):
        scan_probe.scan(x, "max", "flat")
    with pytest.raises(ValueError):
        scan_probe.scan_rounds(x, "hillis")
    with pytest.raises(ValueError):
        scan_probe.scan_rounds(x, "flat", reps=0)
    assert scan_probe.flat_scan_kernel.launches == 0
    assert scan_probe.grouped_scan_kernel.launches == 0


# --- timing harness and the report -----------------------------------------

def test_device_timer_runs():
    x = torch.arange(1024.0)

    def step(a, c):
        return torch.sum(a * a) * 1e-30 + c * 1e-30

    dt = profiling.device_timer(step, (x,), iters=3)
    assert dt > 0
    tp = profiling.Throughput()
    rec = tp.record("step", dt, pixels=1024)
    assert rec["mpix_per_s"] > 0
    assert "step" in tp.report()
    assert profiling.fetch_sync(torch.tensor([2.5, 1.0])) == 2.5


def test_device_timer_threads_the_carry():
    seen = []

    def step(a, c):
        seen.append(float(c))
        return c + 1.0

    profiling.device_timer(step, (torch.zeros(1),), iters=3)
    assert seen == [0.0, 1.0, 2.0, 3.0]


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path)) as d:
        torch.ones(8).sum()
    assert d == str(tmp_path)
    assert "traceEvents" in json.loads((tmp_path / "trace.json").read_text())


def _stat(path):
    """(exists, size, mtime_ns) of ``path``."""
    if not path.exists():
        return (False, None, None)
    st = path.stat()
    return (True, st.st_size, st.st_mtime_ns)


def test_roofline_report_on_cpu(tmp_path, capsys):
    # what the report itself could write besides --out: its default output
    # and the JAX package's record (other test workers write elsewhere in
    # the repository at the same time, so the root's listing proves nothing)
    default_before = _stat(roofline.DEFAULT_OUT)
    record = (REPO / "ROOFLINE.json").read_bytes()
    out = tmp_path / "roofline.json"
    assert roofline.main(["--out", str(out), "--device", "cpu"]) == 0
    rep = json.loads(out.read_text())
    assert json.loads(capsys.readouterr().out) == rep
    for key in ("backend", "fma_per_s", "f32_flops_per_s", "expf_per_s",
                "sm_mhz_under_load", "f32_ops_per_s",
                "hbm_bytes_per_s", "q_test_ops_per_tested_pair",
                "fwd_ops_per_live_pair", "bwd_ops_per_live_pair", "pairs",
                "sol_fwd_ms", "sol_bwd_ms", "sol_frame_ms", "sol_mpix_per_s",
                "frame", "peaks", "note"):
        assert key in rep, key
    assert rep["backend"].startswith("cpu")
    assert rep["f32_flops_per_s"] == 2 * rep["fma_per_s"] > 0
    assert rep["f32_ops_per_s"] == rep["fma_per_s"]
    assert rep["sm_mhz_under_load"] is None
    assert rep["expf_per_s"] > 0
    # the bench frame as the port bins it (chip_smoke.py's BENCH_COUNTS)
    assert rep["frame"] == dict(gaussians=100_000, width=800, height=608,
                                tight_instances=191177)
    p = rep["pairs"]
    assert p["evaluated"] >= p["tested"] >= p["live"] > 0
    assert rep["sol_frame_ms"] == pytest.approx(rep["sol_fwd_ms"]
                                                + rep["sol_bwd_ms"])
    assert rep["sol_mpix_per_s"] == pytest.approx(
        800 * 608 / rep["sol_frame_ms"] / 1e3)
    assert _stat(roofline.DEFAULT_OUT) == default_before
    assert (REPO / "ROOFLINE.json").read_bytes() == record
