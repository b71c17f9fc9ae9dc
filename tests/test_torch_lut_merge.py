"""Port parity: the lookup-merge experiments E6 and E7
(``ops/lut_merge_cuda.py``) and their entry points
(``experiments/exp_manual_pipeline.py``, ``experiments/exp_int8_planes.py``)
against the Pallas functions of ``benchmarks/exp_manual_pipeline.py`` and
``benchmarks/exp_int8_planes.py``, on the same numpy inputs.

The JAX scripts are loaded from their files with importlib and run in
Pallas interpret mode (``pltpu.force_tpu_interpret_mode``): they call
``pallas_call`` without ``interpret``.  Their functions read the module
globals ``N, H, W, C`` when they trace, so the fixture sets those to a
small shape first: (3, 32, 128, 3) for E6, whose pipeline needs two row
chunks of 8 (H / hb >= 2), and (3, 16, 128, 3) for E7 (H % hb == 0).  Their
draws are taken from their own ``main``, run with a ``build`` that records
its operands.  The port's wrappers run on CPU tensors, that is, their plain
versions.

Torch's first multi-threaded ``exp`` of a process on the CPU has come out
up to 1e-4 off on some runs (a few in a hundred, a whole plane at a time);
a module fixture makes that call first, so the tolerances below hold the
merge and not that start-up.

Tolerances: the port against the Pallas functions at E6's own (value rtol
3e-5 / atol 1e-6, std rtol 3e-4 / atol 2e-6; exp_manual_pipeline.py:
235-238), for the one-hot products and ``exp`` on XLA:CPU against torch's
gather and ``exp``.  The data, the byte planes and the bf16 parts bit for
bit.
"""
import importlib.util
import os
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from camera_linearity_tpu.ops import hdr_pallas2  # noqa: E402
from camera_linearity_tpu_torch.experiments import (  # noqa: E402
    exp_int8_planes, exp_manual_pipeline)
from camera_linearity_tpu_torch.ops import hdr_cuda  # noqa: E402
from camera_linearity_tpu_torch.ops import lut_merge_cuda as lm  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
SHAPE6 = (3, 32, 128, 3)  # N, H, W, C
SHAPE7 = (3, 16, 128, 3)
HB = 8
VAL_TOL = exp_manual_pipeline.VAL_TOL
STD_TOL = exp_manual_pipeline.STD_TOL


def _load(name):
    spec = importlib.util.spec_from_file_location(
        f"_bench_{name}", REPO / "benchmarks" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _patch_shapes(mp, e6, e7):
    for module, shape in ((e6, SHAPE6), (e7, SHAPE7)):
        n, h, w, c = shape
        for name, value in (("N", n), ("H", h), ("W", w), ("C", c)):
            mp.setattr(module, name, value)


class _Captured(Exception):
    pass


def _captured_draws(module, argv, stop: bool):
    """The operands ``module.main`` hands its Pallas calls, by variant:
    ``build`` records them (and raises, with ``stop``, or returns zeros);
    ``jax.jit`` passes the function through, so they arrive as arrays."""
    seen = {}

    def build(variant, hb=HB):
        def call(*args):
            seen[variant] = [np.asarray(a) for a in args]
            if stop:
                raise _Captured
            zeros = jnp.zeros((module.C, module.H, module.W), jnp.float32)
            return zeros, zeros
        return call
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(module, "build", build)
        mp.setattr(module, "timeit", lambda *a, **k: 1.0)
        mp.setattr(module, "jax", types.SimpleNamespace(
            **{**vars(jax), "jit": lambda f: f}))
        mp.setattr(sys, "argv", argv)
        try:
            module.main()
        except _Captured:
            pass
    return seen


@pytest.fixture(scope="module", autouse=True)
def _first_exp():
    torch.exp(torch.rand(3, 32, 128, 3))


@pytest.fixture(scope="module")
def bench():
    """The two JAX scripts at their small shapes, Pallas in interpret mode,
    with the operands their ``main`` draws."""
    e6, e7 = _load("exp_manual_pipeline"), _load("exp_int8_planes")
    with pytest.MonkeyPatch.context() as mp, \
            pltpu.force_tpu_interpret_mode():
        _patch_shapes(mp, e6, e7)
        jax.clear_caches()
        # E6's main stops at its first manual call (hb 16 of H = 32); E7's
        # runs through both variants
        draws6 = _captured_draws(e6, ["exp_manual_pipeline.py"], True)[16]
        draws7 = _captured_draws(e7, ["exp_int8_planes.py"], False)
        yield types.SimpleNamespace(e6=e6, e7=e7, draws6=draws6,
                                    draws7=draws7)
    jax.clear_caches()


def _unpack(packed, hi, lo):
    """(rows, C) f32 table of a radix-packed (C, >= lo, >= hi) operand:
    entry hi * lo_size + lo at row lo, column hi."""
    c = packed.shape[0]
    return packed[:, :lo, :hi].transpose(0, 2, 1).reshape(c, hi * lo).T


@pytest.fixture(scope="module")
def pallas6(bench):
    """E6's Pallas ``build(8)`` on ``make_data``, and the port's data."""
    data = exp_manual_pipeline.make_data(0, SHAPE6, "cpu")
    val, std, _, invt, icrf, diff = (x.numpy() for x in data)
    tabs = hdr_pallas2.pack_tables(jnp.asarray(icrf), jnp.asarray(diff))
    out = bench.e6.build(HB)(jnp.asarray(val), jnp.asarray(std), tabs,
                             jnp.asarray(invt.reshape(-1, 1)))
    return data, tuple(np.asarray(x) for x in out)


@pytest.fixture(scope="module")
def pallas7(bench):
    """E7's Pallas ``build("bf16" / "int8", 8)`` on ``make_data``."""
    data = exp_int8_planes.make_data(0, SHAPE7, "cpu")
    val, std, _, invt, icrf, diff = (x.numpy() for x in data)
    args = (jnp.asarray(val), jnp.asarray(std))
    it = jnp.asarray(invt.reshape(-1, 1))
    e7 = bench.e7
    out = {"bf16": e7.build("bf16", HB)(*args, e7.pack_bf16(icrf, diff), it),
           "int8": e7.build("int8", HB)(*args, e7.pack_int8(icrf, diff), it)}
    return data, {k: tuple(np.asarray(x) for x in v) for k, v in out.items()}


def _close(got, want, val_tol=VAL_TOL, std_tol=STD_TOL):
    (gv, gs), (wv, ws) = got, want
    gv, gs = (np.asarray(x.detach().cpu()) if isinstance(x, torch.Tensor)
              else np.asarray(x) for x in (gv, gs))
    assert gv.shape == np.shape(wv) and gs.shape == np.shape(ws)
    np.testing.assert_allclose(gv, wv, **val_tol)
    np.testing.assert_allclose(gs, ws, **std_tol)


# ---------------------------------------------------------------------------
# the data and the table forms
# ---------------------------------------------------------------------------

def test_e6_make_data_is_the_scripts_draws(bench):
    val, std, tabs, invt = bench.draws6
    got = exp_manual_pipeline.make_data(0, SHAPE6, "cpu")
    gval, gstd, _, ginvt, gicrf, gdiff = (x.numpy() for x in got)
    for g, w in ((gval, val), (gstd, std), (ginvt, invt.reshape(-1)),
                 (gicrf, _unpack(tabs, 16, 16)),
                 (gdiff, _unpack(tabs[:, 16:], 16, 16))):
        assert g.dtype == np.float32 and w.dtype == np.float32
        np.testing.assert_array_equal(g, w)


def test_e7_make_data_is_the_scripts_draws(bench):
    draws = bench.draws7
    val, std, tab_f, invt = draws["bf16"]
    got = exp_int8_planes.make_data(0, SHAPE7, "cpu")
    gval, gstd, _, ginvt, gicrf, gdiff = (x.numpy() for x in got)
    for g, w in ((gval, val), (gstd, std), (ginvt, invt.reshape(-1)),
                 (gicrf, _unpack(tab_f, 64, 64)),
                 (gdiff, _unpack(tab_f[:, 64:], 64, 64))):
        assert g.dtype == np.float32
        np.testing.assert_array_equal(g, w)
    assert all(np.array_equal(a, b) for a, b in zip(draws["int8"][:2],
                                                     (val, std)))


def test_byte_planes_are_pack_int8s_bytes(bench):
    """Plane p of table t is rows (4 t + p) * 64 ... of pack_int8's operand,
    in its radix layout (exp_int8_planes.py:69-82)."""
    _, _, packed, _ = bench.draws7["int8"]
    _, _, _, _, icrf, diff = exp_int8_planes.make_data(0, SHAPE7, "cpu")
    for t, tab in enumerate((icrf, diff)):
        planes = lm.byte_planes(tab)
        assert planes.dtype == torch.uint8 and planes.shape == (4, 4096, 3)
        for p in range(4):
            want = _unpack(packed[:, (4 * t + p) * 64:], 64, 64)
            np.testing.assert_array_equal(planes[p].numpy().view(np.int8),
                                          want)


def _tables_to_split():
    rng = np.random.default_rng(3)
    _, _, _, _, icrf, diff = exp_int8_planes.make_data(0, SHAPE7, "cpu")
    wide = (rng.standard_normal((1000, 3))
            * 10.0 ** rng.integers(-20, 20, (1000, 3))).astype(np.float32)
    return {"icrf": icrf, "icrf_diff": diff, "signed, 1e-20 to 1e20":
            torch.from_numpy(wide)}


@pytest.mark.parametrize("name", list(_tables_to_split()))
def test_bf16_parts_are_kernel_bf16s_split(name):
    """The three parts of exp_int8_planes.py:133-136 bit for bit, and their
    sum in order is the table exactly (so is the byte planes' rebuild):
    every form packs and unpacks to the same bits."""
    tab = _tables_to_split()[name]
    t = jnp.asarray(tab.numpy())
    p0 = t.astype(jnp.bfloat16)
    r1 = t - p0.astype(jnp.float32)
    p1 = r1.astype(jnp.bfloat16)
    p2 = (r1 - p1.astype(jnp.float32)).astype(jnp.bfloat16)
    parts = lm.bf16_parts(tab)
    assert parts.dtype == torch.bfloat16 and parts.shape == (3, *tab.shape)
    for got, want in zip(parts, (p0, p1, p2)):
        np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                      np.asarray(want).view(np.int16))
    for form in lm.FORMS:
        packed = lm.pack_table(tab, form)
        assert packed.dtype == lm.DTYPES[form] and packed.is_contiguous()
        got = lm.unpack_table(packed, form)
        assert got.dtype == torch.float32, form
        assert torch.equal(got.view(torch.int32), tab.view(torch.int32)), form


def test_pack_table_rejects_an_unknown_form():
    with pytest.raises(ValueError, match="form"):
        lm.pack_table(torch.zeros(4, 3), "f16")
    with pytest.raises(ValueError, match="form"):
        lm.unpack_table(torch.zeros(4, 3), "f16")


# ---------------------------------------------------------------------------
# E6 and E7 against the Pallas functions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("setting", [None, (512, 4), (1024, 3), (2048, 2)])
def test_e6_matches_pallas(pallas6, setting):
    (val, std, _, invt, icrf, diff), want = pallas6
    chunk, stages = setting or (None, None)
    got = lm.merge_pipelined(val, std, invt, icrf, diff, chunk, stages)
    _close(got, want)
    assert tuple(got[0].shape) == (SHAPE6[3], SHAPE6[1], SHAPE6[2])


@pytest.mark.parametrize("variant", ["bf16", "int8"])
@pytest.mark.parametrize("form", list(lm.FORMS))
def test_e7_matches_pallas(pallas7, variant, form):
    (val, std, _, invt, icrf, diff), want = pallas7
    tabs = [lm.pack_table(x, form) for x in (icrf, diff)]
    _close(lm.merge_table_form(val, std, invt, *tabs, form), want[variant])


def test_e7_forms_agree_bit_for_bit(pallas7):
    (val, std, _, invt, icrf, diff), want = pallas7
    outs = [lm.merge_table_form(val, std, invt, lm.pack_table(icrf, f),
                                lm.pack_table(diff, f), f)
            for f in lm.FORMS]
    for other in outs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(other, outs[0]))
    # the JAX script's own check of its two variants (:260-263)
    _close(want["int8"], want["bf16"], exp_int8_planes.FORM_VAL_TOL,
           exp_int8_planes.FORM_STD_TOL)


def test_planar_plain_is_k1s_plain_on_channels_last(pallas6):
    (val, std, t, invt, icrf, diff), _ = pallas6
    got = lm.merge_planar_plain(val, std, invt, icrf, diff)
    want = hdr_cuda.fused_plain_invt(val.permute(0, 2, 3, 1),
                                     std.permute(0, 2, 3, 1), invt, icrf,
                                     diff)
    for g, w in zip(got, want):
        assert g.is_contiguous()
        assert torch.equal(g, w.permute(2, 0, 1))
    # through the exposure times, 1/t rounds once more
    k1 = hdr_cuda.merge_fused_plain(val.permute(0, 2, 3, 1),
                                    std.permute(0, 2, 3, 1), t, icrf, diff)
    _close(got, tuple(x.permute(2, 0, 1).numpy() for x in k1))


# ---------------------------------------------------------------------------
# the entry points
# ---------------------------------------------------------------------------

def test_exp_manual_pipeline_run_matches_jax(pallas6, capsys):
    _, want = pallas6
    res = exp_manual_pipeline.run("cpu", SHAPE6)
    sweep = [k for k in res if k.startswith("manual ")]
    assert sweep == [f"manual {k}x{s}"
                     for k, s in lm.pipeline_settings(SHAPE6[0], SHAPE6[3])]
    assert len(sweep) == 9  # 3 exposures: every setting fits
    for key in sweep:
        _close(res[key].out, want)
        assert res[key].ms is None and res[key].err == 0.0
    _close(res["shipped"].out, want)
    out = capsys.readouterr().out
    assert out.count("not timed on the cpu") == 10
    assert "default chunk 2048 x 2" in out


def test_exp_int8_planes_run_matches_jax(pallas7, capsys):
    _, want = pallas7
    res = exp_int8_planes.run("cpu", SHAPE7)
    assert res["bit_equal"] is True
    for form in lm.FORMS:
        _close(res[form].out, want["bf16"])
        assert res[form].ms is None and res[form].err == 0.0
    _close(res["k1"].out, want["int8"])
    out = capsys.readouterr().out
    assert "forms equal bit for bit: True" in out
    assert "u8x4: not timed on the cpu" in out


@pytest.mark.parametrize("module,extra", [
    ("exp_manual_pipeline", ["--chunk", "512", "2048", "--stages", "2"]),
    ("exp_int8_planes", []),
])
def test_python_m_entry_on_the_cpu(module, extra):
    shape = SHAPE6 if module == "exp_manual_pipeline" else SHAPE7
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, "-m",
         f"camera_linearity_tpu_torch.experiments.{module}", "--device",
         "cpu", "--shape", *map(str, shape), *extra],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    out = proc.stdout
    if module == "exp_manual_pipeline":
        assert "manual 512x2: not timed" in out
        assert out.count("not timed") == 3  # shipped, 512 x 2, 2048 x 2
    else:
        assert out.count("not timed") == 4  # three forms and K1
        assert "forms equal bit for bit: True" in out


def test_experiments_need_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        exp_manual_pipeline.run(shape=SHAPE6)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        exp_int8_planes.main(["--shape", *map(str, SHAPE7)])


# ---------------------------------------------------------------------------
# the planner and the route
# ---------------------------------------------------------------------------

def test_plan_of_config_2():
    """6 exposures, 3 channels: the default is the double buffer of the
    largest chunk that fits a block, 2048 elements; every setting of the
    sweep but 2048 x 3 and 2048 x 4 fits."""
    p = lm.plan_pipeline(6, 3)
    assert (p.chunk, p.stages, p.threads, p.bulk) == (2048, 2, 512, 0)
    assert p.smem == 202880 <= hdr_cuda._MAX_SMEM
    assert lm.pipeline_settings(6, 3) == [
        (512, 2), (512, 3), (512, 4), (1024, 2), (1024, 3), (1024, 4),
        (2048, 2)]
    assert lm.plan_pipeline(16, 3) == lm.plan_pipeline(16, 3, 512, 2)
    assert lm.plan_pipeline(1, 3).chunk == 2048


@pytest.mark.parametrize("n", [1, 6, 16])
@pytest.mark.parametrize("chunk", lm.CHUNKS)
@pytest.mark.parametrize("stages", lm.STAGES)
def test_plan_fits_or_raises(n, chunk, stages):
    """A setting either fits a block, with aligned offsets and slots of
    all N value and std planes, or raises; the sweep lists those that
    fit."""
    c, tables = 3, 256 * 3 * 8
    need = _layout_bytes(n, chunk, stages, tables)
    if need > hdr_cuda._MAX_SMEM:
        with pytest.raises(ValueError, match="shared memory"):
            lm.plan_pipeline(n, c, chunk, stages)
        return
    p = lm.plan_pipeline(n, c, chunk, stages)
    assert (p.chunk, p.stages, p.threads) == (chunk, stages, chunk // 4)
    assert p.off_bar >= tables and p.off_bar % 128 == 0
    assert p.off_slots >= p.off_bar + 8 * stages and p.off_slots % 128 == 0
    assert p.slot_bytes == 8 * n * chunk and p.slot_bytes % 16 == 0
    assert p.smem == p.off_slots + stages * p.slot_bytes == need
    assert (chunk, stages) in lm.pipeline_settings(n, c)


def _layout_bytes(n, chunk, stages, tables):
    def align(x):
        return -(-x // 128) * 128
    return align(align(tables) + 8 * stages) + stages * 8 * n * chunk


@pytest.mark.parametrize("chunk,stages", [(128, 2), (4096, 2), (1000, 2),
                                          (1024, 1), (1024, 8)])
def test_plan_rejects_settings_out_of_range(chunk, stages):
    with pytest.raises(ValueError):
        lm.plan_pipeline(6, 3, chunk, stages)


def test_plan_raises_when_no_chunk_fits():
    with pytest.raises(ValueError, match="shared memory"):
        lm.plan_pipeline(16, 3, stages=4)


def test_bulk_route_by_alignment_and_plane():
    plane = 3 * 1200 * 1920
    assert lm.bulk_route(plane, 0, 256, 4096, 8192)
    assert not lm.bulk_route(3 * 37 * 53, 0, 256, 4096, 8192)  # crop
    assert not lm.bulk_route(plane, 4, 256, 4096, 8192)  # base 4 B off
    assert not lm.bulk_route(plane, 0, 256, 4096, 8200)  # an output
    assert lm.bulk_route(4 * 37 * 53, 0, 16)  # planes of 4 x 1961: whole
    assert not lm.bulk_route(2 * 37 * 53, 0, 16)


# ---------------------------------------------------------------------------
# the wrappers
# ---------------------------------------------------------------------------

def _operands(n=3, c=3, h=5, w=7, rows=256):
    rng = np.random.default_rng(5)
    val = torch.as_tensor(rng.uniform(0, 1, (n, c, h, w)), dtype=torch.float32)
    icrf = torch.linspace(0, 1, rows).repeat(c, 1).T.contiguous()
    return val, val * 0.01, [1.0] * n, icrf, icrf * 2


def _e7(*args, **kw):
    val, std, invt, icrf, diff = _operands(rows=4096, **kw)
    return val, std, invt, icrf, diff


_BAD_CALLS = {
    "float64": lambda: lm.merge_pipelined(
        *[x.double() if isinstance(x, torch.Tensor) else x
          for x in _operands()]),
    "non-contiguous": lambda: lm.merge_pipelined(
        *[x.transpose(2, 3) if isinstance(x, torch.Tensor) and x.ndim == 4
          else x for x in _operands()]),
    "17 exposures": lambda: lm.merge_pipelined(*_operands(n=17)),
    "NHWC-like 5-D": lambda: lm.merge_pipelined(
        *[x[None] if isinstance(x, torch.Tensor) and x.ndim == 4 else x
          for x in _operands()]),
    "shapes differ": lambda: lm.merge_pipelined(
        *[x[:, :, :4].contiguous() if i == 1 else x
          for i, x in enumerate(_operands())]),
    "E6 with 4096 rows": lambda: lm.merge_pipelined(*_operands(rows=4096)),
    "E7 with 256 rows": lambda: lm.merge_table_form(*_operands(), "f32"),
    "unknown form": lambda: lm.merge_table_form(*_e7(), "int4"),
    "table channels": lambda: lm.merge_table_form(
        *[x[:, :2].contiguous() if i >= 3 else x
          for i, x in enumerate(_e7())], "f32"),
    "invt length": lambda: lm.merge_table_form(
        *[[1.0, 2.0] if i == 2 else x for i, x in enumerate(_e7())], "f32"),
    "bf16x3 given f32 tables": lambda: lm.merge_table_form(*_e7(), "bf16x3"),
    "u8x4 planes of another table size": lambda: lm.merge_table_form(
        *[lm.byte_planes(x[:256]) if i >= 3 else x
          for i, x in enumerate(_e7())], "u8x4"),
    "chunk": lambda: lm.merge_pipelined(*_operands(), chunk=1000),
    "ring beyond a block": lambda: lm.merge_pipelined(
        *_operands(n=16), chunk=2048, stages=2),
    "empty plane": lambda: lm.merge_pipelined(*_operands(h=0)),
}


@pytest.mark.parametrize("case", sorted(_BAD_CALLS))
def test_wrapper_raises(case):
    with pytest.raises((TypeError, ValueError)):
        _BAD_CALLS[case]()


def test_wrappers_on_cpu_run_plain_and_count_nothing():
    before = {k: e.launches for k, e in lm.KERNELS.items()}
    val, std, invt, icrf, diff = _operands(n=16, h=37, w=53)
    got = lm.merge_pipelined(val, std, invt, icrf, diff, 512, 2)
    want = lm.merge_planar_plain(val, std, invt, icrf, diff)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    val, std, invt, icrf, diff = _e7(n=16, h=37, w=53)
    for form in lm.FORMS:
        got = lm.merge_table_form(val, std, invt, lm.pack_table(icrf, form),
                                  lm.pack_table(diff, form), form)
        want = lm.merge_planar_plain(val, std, invt, icrf, diff)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert before == {k: e.launches for k, e in lm.KERNELS.items()}
    assert [e.replaces for e in lm.KERNELS.values()] == [
        "benchmarks/exp_manual_pipeline.py:161",
        "benchmarks/exp_int8_planes.py:194"]
