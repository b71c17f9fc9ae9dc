"""Port parity: the ablation kernels E1-E5 (``ops/ablation_cuda.py``) and
the experiments that drive them (``experiments/exp_kernel.py``,
``experiments/exp_plateau.py``) against the Pallas functions of
``benchmarks/exp_kernel.py`` and ``benchmarks/exp_plateau.py``, on the same
numpy inputs; and the ``linearity`` command without matplotlib.

The JAX scripts are loaded from their files with importlib and run in
Pallas interpret mode (``pltpu.force_tpu_interpret_mode``): they call
``pallas_call`` without ``interpret``.  Their functions read the module
globals ``N, H, W, C, P, TILE`` when they trace, so the fixture sets those
to a small shape first.  The port's wrappers run on CPU tensors, that is,
their plain versions.

Tolerances.  The exposure sums (E1, E5, E4 with ``None``/``mod``/
``round``): rtol 1e-6, atol 1e-7, as ``jnp.sum`` may add the exposures in
another order.  ``exp`` and the merges (E2, E3, E4 ``math``): K1's, value
rtol 2e-5 / atol 1e-6, std rtol 2e-4 / atol 1e-5, for ``exp`` on XLA:CPU
against torch's.
"""
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from camera_linearity_tpu_torch.experiments import (  # noqa: E402
    exp_kernel, exp_plateau)
from camera_linearity_tpu_torch.ops import ablation_cuda  # noqa: E402
from tests.test_torch_cli import _Records, capture_dir  # noqa: E402,F401

REPO = Path(__file__).resolve().parents[1]
SHAPE = (3, 16, 128, 3)  # N, H, W, C
TILE = 512
SUM_TOL = dict(rtol=1e-6, atol=1e-7)
VAL_TOL = dict(rtol=2e-5, atol=1e-6)
STD_TOL = dict(rtol=2e-4, atol=1e-5)


def _load(name):
    spec = importlib.util.spec_from_file_location(
        f"_bench_{name}", REPO / "benchmarks" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def bench():
    """The two JAX scripts at SHAPE, Pallas in interpret mode."""
    ek, ep = _load("exp_kernel"), _load("exp_plateau")
    n, h, w, c = SHAPE
    with pytest.MonkeyPatch.context() as mp, \
            pltpu.force_tpu_interpret_mode():
        for module in (ek, ep):
            for name, value in (("N", n), ("H", h), ("W", w), ("C", c)):
                mp.setattr(module, name, value)
        mp.setattr(ek, "P", h * w)
        mp.setattr(ek, "TILE", TILE)
        jax.clear_caches()
        yield ek, ep
    jax.clear_caches()


@pytest.fixture(scope="module")
def data(bench):
    """make_data(0) of both, as numpy (JAX) and CPU tensors (port)."""
    ek, _ = bench
    want = [np.asarray(a) for a in ek.make_data()]
    got = exp_kernel.make_data(0, SHAPE, "cpu")
    return want, got


def _np(x):
    return np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor)
                      else x)


def _close(got, want, val_tol, std_tol=None):
    (gv, gs), (wv, ws) = got, want
    np.testing.assert_allclose(_np(gv), _np(wv), **val_tol)
    np.testing.assert_allclose(_np(gs), _np(ws), **(std_tol or val_tol))
    assert _np(gv).shape == _np(wv).shape and _np(gs).shape == _np(ws).shape


# ---------------------------------------------------------------------------
# the data and the layouts
# ---------------------------------------------------------------------------

def test_make_data_is_bit_for_bit(data):
    want, got = data
    for w, g in zip(want, got):
        assert g.dtype == torch.float32 and w.dtype == np.float32
        np.testing.assert_array_equal(g.numpy(), w)


def test_cfirst_and_planar_layouts(bench, data):
    ek, ep = bench
    (val, *_), (tval, *_) = data
    np.testing.assert_array_equal(exp_kernel.cfirst(tval).numpy(),
                                  np.asarray(ek.cfirst(val)))
    np.testing.assert_array_equal(exp_plateau.planar(tval).numpy(),
                                  np.asarray(ep.planar(val)))
    assert exp_kernel.cfirst(tval).is_contiguous()


# ---------------------------------------------------------------------------
# E1-E5 against the Pallas functions
# ---------------------------------------------------------------------------

def test_e1_ab_dma(bench, data):
    ek, _ = bench
    (val, std, *_), (tval, tstd, *_) = data
    want = ek.ab_dma(ek.cfirst(val), ek.cfirst(std))
    got = exp_kernel.ab_dma(exp_kernel.cfirst(tval), exp_kernel.cfirst(tstd))
    _close(got, want, SUM_TOL)
    assert tuple(got[0].shape) == (SHAPE[3], 1, SHAPE[1] * SHAPE[2])


def test_e2_ab_math(bench, data):
    ek, _ = bench
    (val, std, t, *_), (tval, tstd, tt, *_) = data
    want = ek.ab_math(ek.cfirst(val), ek.cfirst(std), t)
    got = exp_kernel.ab_math(exp_kernel.cfirst(tval),
                             exp_kernel.cfirst(tstd), tt)
    _close(got, want, VAL_TOL, STD_TOL)


@pytest.mark.parametrize("dead", [False, True])
def test_e3_flat_invt(bench, data, dead):
    ek, _ = bench
    (val, std, t, *_), (tval, tstd, tt, *_) = data
    n = SHAPE[0]
    invt = (1.0 / t).reshape(n, 1)
    want = ek.make_flat_invt(TILE, dead)(val.reshape(n, -1),
                                         std.reshape(n, -1), invt)
    got = exp_kernel.flat_invt(tval.reshape(n, -1), tstd.reshape(n, -1),
                               (1.0 / tt).reshape(n, 1), dead)
    _close(got, want, VAL_TOL, STD_TOL)


@pytest.mark.parametrize("extra", [None, "mod", "round", "exp", "math"])
def test_e4_flat_dma(bench, data, extra):
    ek, _ = bench
    (val, std, *_), (tval, tstd, *_) = data
    n = SHAPE[0]
    want = ek.make_flat_dma(TILE, extra)(val.reshape(n, -1),
                                         std.reshape(n, -1))
    got = exp_kernel.flat_dma(tval.reshape(n, -1), tstd.reshape(n, -1),
                              extra)
    if extra in ("exp", "math"):
        _close(got, want, VAL_TOL, STD_TOL)
    else:
        _close(got, want, SUM_TOL)


@pytest.mark.parametrize("semantics", [None, ("parallel", "parallel")])
def test_e5_plateau_dma(bench, data, semantics):
    _, ep = bench
    (val, std, *_), (tval, tstd, *_) = data
    want = ep.make_dma(8, semantics)(ep.planar(val), ep.planar(std))
    got = exp_plateau.plateau_dma(exp_plateau.planar(tval),
                                  exp_plateau.planar(tstd))
    _close(got, want, SUM_TOL)
    assert tuple(got[0].shape) == (SHAPE[3], SHAPE[1], SHAPE[2])


# ---------------------------------------------------------------------------
# the slice as a whole
# ---------------------------------------------------------------------------

def test_exp_kernel_run_matches_jax(bench, data, capsys):
    ek, _ = bench
    (val, std, t, *_), _ = data
    n = SHAPE[0]
    res = exp_kernel.run(["dma", "math", "flatdma"], device="cpu",
                         shape=SHAPE)
    vcf, scf = ek.cfirst(val), ek.cfirst(std)
    _close(res["ablate_dma"].out, ek.ab_dma(vcf, scf), SUM_TOL)
    _close(res["ablate_math"].out, ek.ab_math(vcf, scf, t), VAL_TOL,
           STD_TOL)
    for dead in (False, True):
        want = ek.make_flat_invt(TILE, dead)(
            val.reshape(n, -1), std.reshape(n, -1), (1.0 / t).reshape(n, 1))
        _close(res[f"flat_invt_dead{dead}"].out, want, VAL_TOL, STD_TOL)
    assert all(r.ms is None for r in res.values())
    out = capsys.readouterr().out
    assert "ablate_dma: not timed on the cpu" in out


def test_exp_plateau_run_matches_jax(bench, data, capsys):
    _, ep = bench
    (val, std, *_), _ = data
    res = exp_plateau.run(["dma"], device="cpu", shape=SHAPE)
    want = ep.make_dma(8)(ep.planar(val), ep.planar(std))
    sweep = res["dma"]
    assert sorted(sweep) == [(t, v) for t in ablation_cuda.THREADS
                             for v in ablation_cuda.VECS]
    for r in sweep.values():
        _close(r.out, want, SUM_TOL)
    assert capsys.readouterr().out.count("dma threads=") == 9


def test_exp_kernel_k1_names(data):
    """``v2`` and ``planar`` run K1 on f32, u8 and std-free stacks; on the
    CPU its wrapper is its plain version, so every error is 0."""
    res = exp_kernel.run(["v2", "planar"], device="cpu", shape=SHAPE)
    assert sorted(res) == ["final_nhwc", "final_nhwc_nostd",
                           "final_nhwc_u8", "v2_nhwc"]
    for key in ("v2_nhwc", "final_nhwc", "final_nhwc_u8"):
        assert res[key].err == 0.0
    v, s = res["final_nhwc_nostd"].out
    assert s is None and tuple(v.shape) == SHAPE[1:]
    assert torch.isfinite(v).all()


def test_experiments_cli(capsys):
    shape = [str(x) for x in SHAPE]
    assert exp_kernel.main(["--device", "cpu", "--shape", *shape, "dma",
                            "relayout"]) == 0
    assert exp_plateau.main(["--device", "cpu", "--shape", *shape,
                             "xla", "kern"]) == 0
    out = capsys.readouterr().out
    for line in ("ablate_dma:", "relayout:", "torch_sum_pair:", "kern:"):
        assert line in out, line


def test_experiments_need_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        exp_kernel.run(["dma"], shape=SHAPE)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        exp_plateau.main(["--shape", *map(str, SHAPE), "dma"])


# ---------------------------------------------------------------------------
# the wrappers and the plain versions
# ---------------------------------------------------------------------------

def _stacks(n=3, length=10):
    rng = np.random.default_rng(7)
    val = torch.as_tensor(rng.uniform(0, 1, (n, length)), dtype=torch.float32)
    return val, val * 0.01


_BAD_CALLS = {
    "float64": lambda v, s: ablation_cuda.exposure_sum(
        v.double(), s.double(), "flat"),
    "std float64": lambda v, s: ablation_cuda.merge_nolut(
        v, s.double(), None, "flat"),
    "non-contiguous": lambda v, s: ablation_cuda.exposure_sum(
        v[:, ::2], s[:, ::2], "flat"),
    "17 exposures": lambda v, s: ablation_cuda.exposure_sum(
        *_stacks(17), "flat"),
    "17 exposures, merge": lambda v, s: ablation_cuda.merge_nolut(
        *_stacks(17), None, "flat"),
    "shapes differ": lambda v, s: ablation_cuda.exposure_sum(
        v, s[:, :5].contiguous(), "flat"),
    "cfirst without its unit axis": lambda v, s: ablation_cuda.exposure_sum(
        v.reshape(1, 3, 2, 5), s.reshape(1, 3, 2, 5), "cfirst"),
    "unknown layout": lambda v, s: ablation_cuda.exposure_sum(v, s, "nhwc"),
    "unknown mode": lambda v, s: ablation_cuda.exposure_sum(
        v, s, "flat", "max"),
    "threads": lambda v, s: ablation_cuda.exposure_sum(
        v, s, "flat", threads=1024),
    "vec": lambda v, s: ablation_cuda.exposure_sum(v, s, "flat", vec=3),
    "planar merge": lambda v, s: ablation_cuda.merge_nolut(
        v.reshape(3, 1, 2, 5), s.reshape(3, 1, 2, 5), None, "planar"),
    "invt length": lambda v, s: ablation_cuda.merge_nolut(
        v, s, [1.0, 2.0], "flat"),
}


@pytest.mark.parametrize("case", sorted(_BAD_CALLS))
def test_wrapper_raises(case):
    val, std = _stacks()
    with pytest.raises((TypeError, ValueError)):
        _BAD_CALLS[case](val, std)


def test_wrappers_on_cpu_run_plain_and_count_nothing():
    val, std = _stacks(16, 9)  # the most exposures, a ragged row
    before = {k: e.launches for k, e in ablation_cuda.KERNELS.items()}
    for mode in ablation_cuda.MODES:
        got = ablation_cuda.exposure_sum(val, std, "flat", mode)
        want = ablation_cuda.exposure_sum_plain(val, std, "flat", mode)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    got = ablation_cuda.merge_nolut(val, std, None, "flat", dead=True)
    want = ablation_cuda.merge_nolut_plain(val, std, None, "flat")
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert before == {k: e.launches for k, e in
                      ablation_cuda.KERNELS.items()}


def test_sum_plain_adds_in_exposure_order():
    """The plain sums equal a float32 sum in exposure order exactly: the
    order the kernel adds in, so the card holds it to 0 error."""
    rng = np.random.default_rng(11)
    x = rng.uniform(0, 1, (2, 6, 40)).astype(np.float32)
    s = rng.uniform(0, 0.02, (2, 6, 40)).astype(np.float32)
    got_v, got_s = ablation_cuda.exposure_sum_plain(
        torch.from_numpy(x.reshape(2, 6, 1, 40)),
        torch.from_numpy(s.reshape(2, 6, 1, 40)), "cfirst", "round")
    acc_v, acc_s = x[:, 0].copy(), s[:, 0].copy()
    for n in range(1, 6):
        acc_v, acc_s = acc_v + x[:, n], acc_s + s[:, n]
    idx = np.clip(np.round(x * np.float32(255)).astype(np.int32), 0, 255)
    acc_v = acc_v + idx.sum(axis=1).astype(np.float32)
    np.testing.assert_array_equal(got_v.numpy().reshape(2, 40), acc_v)
    np.testing.assert_array_equal(got_s.numpy().reshape(2, 40), acc_s)


# ---------------------------------------------------------------------------
# linearity without matplotlib
# ---------------------------------------------------------------------------

_NO_MATPLOTLIB = """
import json, logging, sys
sys.modules["matplotlib"] = None  # as on a machine without it
from camera_linearity_tpu_torch.__main__ import main
from camera_linearity_tpu_torch.utils.observability import get_logger
records = []
class Keep(logging.Handler):
    def emit(self, record):
        records.append(record)
get_logger().addHandler(Keep())
rc = main(json.loads(sys.argv[1]))
print(json.dumps({"rc": rc,
                  "fits": [list(r.args) for r in records
                           if "ODR fit" in r.msg],
                  "warnings": [r.getMessage() for r in records
                               if r.levelno == logging.WARNING]}))
"""


def test_linearity_without_matplotlib(capture_dir, tmp_path):
    pytest.importorskip("matplotlib")  # for the JAX CLI's plots
    from camera_linearity_tpu.__main__ import main as jmain
    from camera_linearity_tpu.utils.observability import get_logger
    d, icrf_path, _ = capture_dir
    args = ["linearity", "--images", str(d), "--icrf", str(icrf_path),
            "--std", "--out"]
    (tmp_path / "port").mkdir()
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, "-c", _NO_MATPLOTLIB,
         json.dumps(["--device", "cpu", *args, str(tmp_path / "port")])],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    port = json.loads(proc.stdout.strip().splitlines()[-1])

    (tmp_path / "jax").mkdir()
    jlogger = get_logger()
    handler = _Records()
    jlogger.addHandler(handler)
    try:
        assert jmain(args + [str(tmp_path / "jax")]) == 0
    finally:
        jlogger.removeHandler(handler)
    want = [r.args for r in handler.records if "ODR fit" in r.msg]

    assert port["rc"] == 0
    assert len(port["fits"]) == len(want) == 2 * 2 * 3  # series, kind, ch
    for g, w in zip(port["fits"], want):
        assert tuple(g[:3]) == tuple(w[:3])
        np.testing.assert_allclose(g[3:], w[3:], rtol=1e-10, atol=1e-12)
    assert list((tmp_path / "port").glob("*.png")) == []
    assert list((tmp_path / "jax").glob("*.png"))
    assert len(port["warnings"]) == 1
    assert "matplotlib" in port["warnings"][0]
