"""The CUDA merge kernels K1-K3, the ablation kernels E1-E5 and the
lookup-merge experiments E6-E7 against their plain PyTorch versions.

The tests marked ``cuda`` need a card and skip without one; on a machine
with a card and no JAX, run them with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py

(this file imports no JAX). Card tolerances, f32 against f32, where the
differences come from ``expf`` and FMA contraction: value rtol 2e-5 / atol
1e-6, std rtol 2e-4 / atol 1e-5; the median repair agrees exactly. K1 is
held on both of its routes and every instance: the quad walk at 3, 4, 6, 12
and 16 exposures (instances 4, 8 and 16), the scalar route of a 37 x 53
crop, of 17 exposures and of value or std stacks 4 bytes (u8: 1 byte) off
alignment, 1, 3 and 4 channels and batches, ragged or not; the two routes
must agree bit for bit on the same values. K2 and K3 are held at shapes
that reach their tile edges, both load routes (TMA where a row is a
multiple of 16 bytes, the copy route elsewhere), 1 to 12 exposures,
batches, every stack type, and hot pixels on tile borders, image corners
and next to each other. The ablation kernels (``ops/ablation_cuda.py``) are
held on every layout, mode and launch setting, on rows that end in a ragged
quad and on stacks 4 bytes off 16-byte alignment: the sums exactly (both
add in exposure order), the merges at K1's tolerances. E6
(``ops/lut_merge_cuda.py::merge_pipelined``) is held over (chunk, stages)
settings, 1, 6 and 16 exposures, a ragged last chunk, quads that straddle
two channels (or four, in 1 x 1 planes), and the scalar route of a 37 x 53
crop, of 1 x 1 planes and of stacks 4 bytes off alignment; E7
(``merge_table_form``) in all three table forms, which must agree bit for
bit, on aligned, ragged, 1 x 1 and misaligned stacks; both at K1's
tolerances. The CPU tests check that a wrapper given a CPU tensor runs its
plain version and counts no launch, the K2/K3 tile planner and route
choice, K1's launch planner, and that importing the port neither imports
JAX nor builds a kernel.
"""
import os
import subprocess
import sys
import zlib
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from camera_linearity_tpu_torch.ops import (  # noqa: E402
    ablation_cuda, filters, hdr, hdr_cuda, lut_merge_cuda)

REPO = Path(__file__).resolve().parents[1]
VAL_TOL = dict(rtol=2e-5, atol=1e-6)
STD_TOL = dict(rtol=2e-4, atol=1e-5)


@pytest.fixture
def rng(request):
    # this file's own: on the card it runs without tests/conftest.py
    seed = zlib.crc32(request.node.nodeid.encode()) ^ 1995
    return np.random.default_rng(seed)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _tables(rng, rows, c):
    icrf = np.sort(rng.uniform(0, 1, (rows, c)), axis=0)
    icrf[0], icrf[-1] = 0.0, 1.0
    return icrf, np.gradient(icrf, 2 / (rows - 1), axis=0)


def _stack(rng, shape, kind, max_dn=255):
    if kind == "f32":
        return rng.uniform(0.0, 1.0, shape).astype(np.float32)
    return rng.integers(0, max_dn + 1, shape).astype(
        np.uint8 if kind == "u8" else np.int32)


def _t(a, device):
    return torch.as_tensor(np.asarray(a), device=device)


def _f32(a, device):
    return torch.as_tensor(np.asarray(a, np.float32), device=device)


def _close(got, want):
    (gv, gs), (wv, ws) = got, want
    torch.testing.assert_close(gv, wv, **VAL_TOL)
    if ws is None:
        assert gs is None
    else:
        torch.testing.assert_close(gs, ws, **STD_TOL)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

def _exposures(n, device):
    return _f32(0.002 * 2.0 ** np.arange(n), device)


def _skewed(t):
    """A contiguous copy of ``t`` at storage offset 1: one element (4
    bytes, or 1 for u8) off the allocation's alignment."""
    out = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)[1:]
    return out.view(t.shape).copy_(t)


# (B, N, H, W, C, skewed stack, K1's route with std): ragged sizes, planes
# of a multiple of 4 elements for the quad walk at each instance, and each
# reason for the scalar route
K1_GEOMETRIES = {
    "n4": (None, 4, 21, 60, 3, None, "quad/4"),
    "n3": (None, 3, 16, 40, 3, None, "quad/4"),
    "n6": (None, 6, 16, 40, 3, None, "quad/8"),
    "n12": (None, 12, 8, 20, 3, None, "quad/16"),
    "n16": (None, 16, 8, 20, 3, None, "quad/16"),
    "n17": (None, 17, 8, 20, 3, None, "scalar"),
    "crop": (None, 4, 37, 53, 3, None, "scalar"),
    "skew": (None, 4, 21, 60, 3, "val", "scalar"),
    "skew-std": (None, 4, 21, 60, 3, "std", "scalar"),
    "c1": (None, 6, 21, 60, 1, None, "quad/8"),
    "c4": (None, 6, 21, 61, 4, None, "quad/8"),
    "b2": (2, 6, 21, 60, 3, None, "quad/8"),
    "b2-ragged": (2, 5, 37, 53, 3, None, "scalar"),
}


def _k1_inputs(rng, geometry, kind, bits, use_std, device):
    b, n, h, w, c, skew, route = K1_GEOMETRIES[geometry]
    shape = (n, h, w, c) if b is None else (b, n, h, w, c)
    val = _t(_stack(rng, shape, kind, bits - 1), device)
    std = _f32(rng.uniform(0.001, 0.02, shape), device) if use_std else None
    if skew == "val":
        val = _skewed(val)
    elif skew == "std" and use_std:
        std = _skewed(std)
    elif skew == "std":
        route = "quad/4"  # no std stack, nothing skewed
    icrf, diff = (_f32(a, device) for a in _tables(rng, bits, c))
    return val, std, _exposures(n, device), icrf, diff, route


@pytest.mark.cuda
@pytest.mark.parametrize("geometry", list(K1_GEOMETRIES))
@pytest.mark.parametrize("kind", ["f32", "u8", "i32"])
@pytest.mark.parametrize("bits", [256, 4096])
@pytest.mark.parametrize("compat", ["corrected", "reference"])
@pytest.mark.parametrize("use_std", [True, False])
def test_k1_matches_plain(cuda, rng, geometry, kind, bits, compat, use_std):
    val, std, exposures, icrf, diff, route = _k1_inputs(
        rng, geometry, kind, bits, use_std, cuda)
    assert hdr_cuda.fused_launch_plan(val, std, bits).route == route
    before = hdr_cuda.merge_nhwc_fused.launches
    got = hdr_cuda.merge_nhwc_fused(val, std, exposures, icrf, diff, compat)
    torch.cuda.synchronize()
    assert hdr_cuda.merge_nhwc_fused.launches == before + 1
    _close(got, hdr_cuda.merge_fused_plain(val, std, exposures, icrf, diff,
                                           compat))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["f32", "u8", "i32"])
@pytest.mark.parametrize("bits", [256, 4096])
@pytest.mark.parametrize("compat", ["corrected", "reference"])
def test_k1_routes_agree_bit_for_bit(cuda, rng, kind, bits, compat):
    """The quad walk and the scalar route round every operation alike: the
    same values through both give the same bits."""
    val, std, exposures, icrf, diff, _ = _k1_inputs(rng, "n6", kind, bits,
                                                    True, cuda)
    quad = hdr_cuda.merge_nhwc_fused(val, std, exposures, icrf, diff, compat)
    skewed = _skewed(val)
    assert hdr_cuda.fused_launch_plan(skewed, std, bits).route == "scalar"
    scalar = hdr_cuda.merge_nhwc_fused(skewed, std, exposures, icrf, diff,
                                       compat)
    assert all(torch.equal(a, b) for a, b in zip(quad, scalar))


# (B, N, H, W, C) of merge_batch: a ragged plane (the scalar route), a
# plane of a multiple of 4 elements (the quad walk), 17 exposures (scalar)
K1_BATCHES = {"ragged": (2, 3, 17, 33, 3), "quad": (2, 3, 16, 32, 3),
              "n17": (2, 17, 6, 10, 3)}


@pytest.mark.cuda
@pytest.mark.parametrize("geometry", list(K1_BATCHES))
def test_k1_batch_and_dispatch(cuda, rng, geometry):
    """merge_batch is one K1 launch over a (B, N, H, W, C) batch and
    agrees with merging each scene alone."""
    b, n, h, w, c = K1_BATCHES[geometry]
    val = _f32(rng.uniform(0, 1, (b, n, h, w, c)), cuda)
    std = _f32(rng.uniform(0.001, 0.02, (b, n, h, w, c)), cuda)
    exposures = _exposures(n, cuda)
    icrf, diff = (_f32(a, cuda) for a in _tables(rng, 256, c))
    assert hdr_cuda.fused_launch_plan(val, std, 256).route == \
        ("quad/4" if geometry == "quad" else "scalar")
    before = hdr_cuda.merge_nhwc_fused.launches
    bv, bs = hdr.merge_batch(val, std, exposures, icrf, diff)
    assert hdr_cuda.merge_nhwc_fused.launches == before + 1
    for i in range(b):
        _close((bv[i], bs[i]), hdr.merge_hdr(val[i], std[i], exposures,
                                             icrf, diff, use_kernel=False))


def _route(val, std=None, dark=None):
    """Whether the K2/K3 wrapper takes the TMA route for these stacks."""
    n, h, w, c = val.shape[-4:]
    plan = hdr_cuda.plan_lerp_tiles(
        n, c, val.element_size(), std is not None,
        0 if dark is None else dark.element_size())
    return hdr_cuda.tma_route(plan, w * c, *(
        None if t is None else (t.data_ptr(), t.element_size())
        for t in (val, std, dark)))


# (B, N, H, W, C): no size a multiple of a tile; W*C = 135 takes the copy
# route, W*C = 336 (a multiple of 16) the TMA route for every stack type
K2_GEOMETRIES = {"copy": (None, 3, 19, 45, 3), "n1": (None, 1, 21, 112, 3),
                 "n6": (None, 6, 21, 112, 3), "n12": (None, 12, 9, 112, 3),
                 "b3": (3, 6, 11, 112, 3)}


@pytest.mark.cuda
@pytest.mark.parametrize("geometry", list(K2_GEOMETRIES))
@pytest.mark.parametrize("bits", [1024, 4096, 65536])
@pytest.mark.parametrize("kind", ["f32", "u8", "i32"])
@pytest.mark.parametrize("use_std", [True, False])
def test_k2_matches_plain(cuda, rng, geometry, bits, kind, use_std):
    b, n, h, w, c = K2_GEOMETRIES[geometry]
    shape = (n, h, w, c) if b is None else (b, n, h, w, c)
    val = _t(_stack(rng, shape, kind, bits - 1), cuda)
    std = _f32(rng.uniform(0.001, 0.02, shape), cuda) if use_std else None
    exposures = _exposures(n, cuda)
    base, diff_base = (_f32(a, cuda) for a in _tables(rng, 256, c))
    assert _route(val, std) == (geometry != "copy")
    before = hdr_cuda.merge_nhwc_lerp.launches
    got = hdr_cuda.merge_nhwc_lerp(val, std, exposures, base,
                                   diff_base if use_std else None, bits)
    assert hdr_cuda.merge_nhwc_lerp.launches == before + 1
    _close(got, hdr_cuda.merge_lerp_plain(val, std, exposures, base,
                                          diff_base, bits))


def _hot_darks(rng, shape, as_mask):
    """~5 % hot pixels, plus: all four corners of every exposure; pixels on
    the K3 tiles' borders (rows 7, 8, 15, 16; the pixels holding elements
    63 and 64 of a row); and two pairs of adjacent hot pixels, whose
    medians must each see the other's unrepaired value."""
    n, h, w, c = shape
    dark = (rng.uniform(0, 1, shape) > 0.95).astype(np.float32)
    dark[:, 0, 0, :] = dark[:, 0, -1, :] = 1.0
    dark[:, -1, 0, :] = dark[:, -1, -1, :] = 1.0
    for row in (7, 8, 15, 16):
        if row < h:
            dark[:, row, [1, w // 2], :] = 1.0
    for col in {63 // c, 64 // c}:
        if col < w:
            dark[:, [1, h // 2], col, :] = 1.0
    dark[:, 3, 4:6, :] = 1.0   # side by side
    dark[:, 4:6, 1, :] = 1.0   # one above the other
    return dark.astype(np.uint8) if as_mask else dark


def _stack_with_bright_pairs(rng, shape, device):
    """Values in (0.05, 0.95), the adjacent hot pairs of :func:`_hot_darks`
    set to 1: a median that saw its partner repaired would differ."""
    val = rng.uniform(0.05, 0.95, shape)
    val[:, 3, 4:6, :] = 1.0
    val[:, 4:6, 1, :] = 1.0
    return _f32(val, device)


# (N, H, W, C): H and W*C not tile multiples; W*C = 80 and 192 take the TMA
# route (f32 darks and u8 mask), the 37 x 53 crop (W*C = 159) the copy route
K3_GEOMETRIES = {"n3": (3, 19, 40, 2), "n1": (1, 17, 64, 3),
                 "n6": (6, 35, 64, 3), "n12": (12, 21, 64, 3),
                 "copy-37x53": (6, 37, 53, 3)}


@pytest.mark.cuda
@pytest.mark.parametrize("geometry", list(K3_GEOMETRIES))
@pytest.mark.parametrize("bits", [256, 4096])
@pytest.mark.parametrize("as_mask", [False, True])
@pytest.mark.parametrize("use_std", [True, False])
def test_k3_matches_plain(cuda, rng, geometry, bits, as_mask, use_std):
    shape = K3_GEOMETRIES[geometry]
    n, c = shape[0], shape[-1]
    val = _stack_with_bright_pairs(rng, shape, cuda)
    std = _f32(rng.uniform(0.001, 0.01, shape), cuda) if use_std else None
    dark = _t(_hot_darks(rng, shape, as_mask), cuda)
    exposures = _exposures(n, cuda)
    base, diff_base = (_f32(a, cuda) for a in _tables(rng, 256, c))
    thr = torch.tensor(0.5)
    assert _route(val, std, dark) == (geometry != "copy-37x53")
    before = hdr_cuda.merge_nhwc_lerp_bp.launches
    got = hdr_cuda.merge_nhwc_lerp_bp(val, std, dark, exposures, base,
                                      diff_base if use_std else None, thr,
                                      bits)
    assert hdr_cuda.merge_nhwc_lerp_bp.launches == before + 1
    _close(got, hdr_cuda.merge_lerp_bp_plain(val, std, dark, exposures, base,
                                             diff_base, thr, bits))


@pytest.mark.cuda
def test_k2_k3_unaligned_stacks_take_the_copy_route(cuda, rng):
    """A stack viewed 4 bytes past an aligned base cannot be a TMA source:
    the wrappers load it by the copy route, with the same results."""
    n, h, w, c = 3, 13, 64, 3
    size = n * h * w * c

    def unaligned(a):
        flat = torch.empty(size + 1, dtype=torch.float32, device=cuda)
        flat[1:] = _f32(a, cuda).flatten()
        return flat[1:].view(n, h, w, c)
    val = unaligned(rng.uniform(0.05, 0.95, (n, h, w, c)))
    std = unaligned(rng.uniform(0.001, 0.01, (n, h, w, c)))
    dark = _t(_hot_darks(rng, (n, h, w, c), True), cuda)
    exposures = _exposures(n, cuda)
    base, diff_base = (_f32(a, cuda) for a in _tables(rng, 256, c))
    assert not _route(val, std) and not _route(val, std, dark)
    _close(hdr_cuda.merge_nhwc_lerp(val, std, exposures, base, diff_base,
                                    4096),
           hdr_cuda.merge_lerp_plain(val, std, exposures, base, diff_base,
                                     4096))
    _close(hdr_cuda.merge_nhwc_lerp_bp(val, std, dark, exposures, base,
                                       diff_base, 0.5, 4096),
           hdr_cuda.merge_lerp_bp_plain(val, std, dark, exposures, base,
                                        diff_base, 0.5, 4096))


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["copy", "tma"])
def test_k3_repair_is_exact(cuda, rng, route):
    """One exposure of values on the DN grid through an identity ramp
    table: the merged value is g(idx) = idx / 255 to f32 rounding, so the
    DN it rounds back to is the repaired pixel's own, and it must equal the
    plain median repair exactly (edges, corners, tile borders and adjacent
    hot pixels included)."""
    h, w, c = (23, 31, 3) if route == "copy" else (23, 64, 3)
    val = rng.integers(0, 256, (1, h, w, c)) / 255.0
    val[:, 3, 4:6, :] = val[:, 4:6, 1, :] = 1.0
    val = _f32(val, cuda)
    dark = _t(_hot_darks(rng, (1, h, w, c), False), cuda)
    assert _route(val, None, dark) == (route == "tma")
    ramp = torch.linspace(0, 1, 256, device=cuda, dtype=torch.float32)
    base = ramp[:, None].repeat(1, c).contiguous()
    got, _ = hdr_cuda.merge_nhwc_lerp_bp(val, None, dark, _f32([1.0], cuda),
                                         base, None, 0.5, 256)
    fixed, _ = filters.bad_pixel_filter_stack(val, None, dark, 0.5)
    dn = torch.round(got * 255)
    assert torch.equal(dn, torch.round(fixed[0] * 255))
    assert not torch.equal(dn, torch.round(val[0] * 255))


@pytest.mark.cuda
def test_half_dn_rounds_to_even(cuda, rng):
    """Values whose x * max_dn is exactly k + 0.5 in f32 index k or k + 1 by
    round-half-to-even in the kernel as in torch.round."""
    c = 3
    k = np.arange(0, 255, dtype=np.float32)
    ties = (k + np.float32(0.5)) / np.float32(255)
    ties = ties[(ties * np.float32(255)) == k + np.float32(0.5)]
    assert ties.size > 20
    val = np.resize(ties, (2, 8, ties.size, c)).astype(np.float32)
    icrf, diff = _tables(rng, 256, c)
    args = (_t(val, cuda), None, _f32([0.01, 0.02], cuda), _f32(icrf, cuda),
            _f32(diff, cuda))
    got, _ = hdr_cuda.merge_nhwc_fused(*args)
    want, _ = hdr_cuda.merge_fused_plain(*args)
    torch.testing.assert_close(got, want, **VAL_TOL)


@pytest.mark.cuda
def test_dispatch_routes_to_kernels(cuda, rng):
    n, h, w, c = 3, 16, 24, 3
    val = _f32(rng.uniform(0.05, 0.95, (n, h, w, c)), cuda)
    std = _f32(rng.uniform(0.001, 0.01, (n, h, w, c)), cuda)
    exposures = _f32([0.04, 0.08, 0.16], cuda)
    base, diff_base = (_f32(a, cuda) for a in _tables(rng, 256, c))
    icrf, diff = (_f32(a, cuda) for a in _tables(rng, 4096, c))
    counts = [k.launches for k in hdr_cuda.KERNELS]
    hdr.merge_hdr(val, std, exposures, icrf, diff)
    hdr.merge_hdr(val, std, exposures, icrf, diff, icrf_base=base,
                  icrf_diff_base=diff_base)
    hdr.merge_corrected(val, std, torch.zeros_like(val), exposures, icrf,
                        diff, 0.5, icrf_base=base, icrf_diff_base=diff_base)
    hdr.merge_hdr(val, std, exposures, icrf, diff, use_kernel=False)
    assert [k.launches - c0 for k, c0 in zip(hdr_cuda.KERNELS, counts)] \
        == [1, 1, 1]


@pytest.mark.cuda
def test_wrappers_reject_bad_input(cuda, rng):
    n, h, w, c = 2, 8, 8, 3
    val = _f32(rng.uniform(0, 1, (n, h, w, c)), cuda)
    exposures = _f32([0.01, 0.02], cuda)
    icrf, diff = (_f32(a, cuda) for a in _tables(rng, 256, c))
    with pytest.raises(TypeError):
        hdr_cuda.merge_nhwc_fused(val.double(), None, exposures, icrf, diff)
    with pytest.raises(ValueError):
        hdr_cuda.merge_nhwc_fused(val.transpose(1, 2), None, exposures,
                                  icrf, diff)
    with pytest.raises(ValueError):
        hdr_cuda.merge_nhwc_fused(val, None, exposures, icrf.cpu(), diff)
    with pytest.raises(ValueError):
        hdr_cuda.merge_nhwc_lerp_bp(val, None, val[:1].contiguous(),
                                    exposures, icrf, None, 0.5, 256)
    with pytest.raises(ValueError):  # 16384 x 3 x 2 f32 tables > 227 KB
        big = _f32(np.ones((16384, c)), cuda)
        hdr_cuda.merge_nhwc_fused(val, val, exposures, big, big)


# ---------------------------------------------------------------------------
# the ablation kernels E1-E5, on the card
# ---------------------------------------------------------------------------

# (exposures, outer or channels, row length, misaligned, and the sum's
# launch: threads, vec)
ABLATION_CASES = {
    "config-like": (6, 3, 4096, False, 256, 1),
    "one exposure, ragged rows": (1, 3, 1001, False, 128, 2),
    "16 exposures, 4 B off": (16, 2, 4096, True, 512, 4),
    "9 exposures, ragged": (9, 3, 1001, False, 512, 4),
}


def _ablation_stacks(rng, layout, n, outer, inner, misaligned, device):
    """f32 value and std stacks of ``layout``; ``misaligned`` starts both
    4 bytes past a 16-byte boundary (the kernels' scalar path)."""
    shape = {"cfirst": (outer, n, 1, inner), "flat": (n, outer * inner),
             "planar": (n, outer, 1, inner)}[layout]
    count, skip = int(np.prod(shape)), int(misaligned)
    return [_f32(rng.uniform(lo, hi, count + skip), device)[skip:].view(shape)
            for lo, hi in ((0.0, 1.0), (0.001, 0.02))]


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(ABLATION_CASES))
@pytest.mark.parametrize("mode", list(ablation_cuda.MODES))
@pytest.mark.parametrize("layout", list(ablation_cuda.LAYOUTS))
def test_exposure_sum_matches_plain(cuda, rng, case, mode, layout):
    n, outer, inner, misaligned, threads, vec = ABLATION_CASES[case]
    val, std = _ablation_stacks(rng, layout, n, outer, inner, misaligned,
                                cuda)
    experiment = {"cfirst": "E1", "flat": "E4", "planar": "E5"}[layout]
    before = ablation_cuda.KERNELS[experiment].launches
    got = ablation_cuda.exposure_sum(val, std, layout, mode, threads, vec)
    torch.cuda.synchronize()
    assert ablation_cuda.KERNELS[experiment].launches == before + 1
    want = ablation_cuda.exposure_sum_plain(val, std, layout, mode)
    if mode == "exp":
        _close(got, want)
    else:
        assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(ABLATION_CASES))
@pytest.mark.parametrize("dead", [False, True])
@pytest.mark.parametrize("layout", ["cfirst", "flat"])
def test_merge_nolut_matches_plain(cuda, rng, case, dead, layout):
    n, outer, inner, misaligned, _, _ = ABLATION_CASES[case]
    val, std = _ablation_stacks(rng, layout, n, outer, inner, misaligned,
                                cuda)
    invt = 1.0 / (0.001 * 2.0 ** torch.arange(n, dtype=torch.float32))
    experiment = "E2" if layout == "cfirst" else "E3"
    before = ablation_cuda.KERNELS[experiment].launches
    got = ablation_cuda.merge_nolut(val, std, invt, layout, dead)
    torch.cuda.synchronize()
    assert ablation_cuda.KERNELS[experiment].launches == before + 1
    _close(got, ablation_cuda.merge_nolut_plain(val, std, invt, layout))


@pytest.mark.cuda
def test_merge_nolut_without_invt_counts_as_e4(cuda, rng):
    val, std = _ablation_stacks(rng, "flat", 6, 3, 4096, False, cuda)
    before = ablation_cuda.KERNELS["E4"].launches
    got = ablation_cuda.merge_nolut(val, std, None, "flat")
    torch.cuda.synchronize()
    assert ablation_cuda.KERNELS["E4"].launches == before + 1
    _close(got, ablation_cuda.merge_nolut_plain(val, std, None, "flat"))


# ---------------------------------------------------------------------------
# the lookup-merge experiments E6 and E7, on the card
# ---------------------------------------------------------------------------

def _planar(rng, n, c, h, w, misaligned, device, rows):
    """f32 (N, C, H, W) value and std stacks, ``misaligned`` starting 4
    bytes past a 16-byte boundary, and (rows, C) tables."""
    count, skip = n * c * h * w, int(misaligned)
    val, std = (_f32(rng.uniform(lo, hi, count + skip), device)[skip:]
                .view(n, c, h, w) for lo, hi in ((0.0, 1.0), (0.001, 0.02)))
    icrf, diff = (_f32(a, device) for a in _tables(rng, rows, c))
    invt = 1.0 / (0.001 * 2.0 ** torch.arange(n, dtype=torch.float32))
    return val, std, invt, icrf, diff


# (N, C, H, W, misaligned, chunk, stages, bulk route): planes of 30720,
# 9900 and 4032 elements end in a ragged chunk; C = 4 of 37 x 53 has quads
# that straddle two channels on the bulk route; planes of 1 x 1 put a
# quad's elements in three or four channels
E6_CASES = {
    "n6 default": (6, 3, 40, 256, False, None, None, True),
    "n6 2048x2": (6, 3, 40, 256, False, 2048, 2, True),
    "n6 1024x3": (6, 3, 40, 256, False, 1024, 3, True),
    "n1 512x4, ragged": (1, 3, 33, 100, False, 512, 4, True),
    "n16 512x2, ragged": (16, 3, 21, 64, False, 512, 2, True),
    "c4 37x53, straddling": (6, 4, 37, 53, False, 512, 3, True),
    "c4 1x1, a channel an element": (6, 4, 1, 1, False, 512, 2, True),
    "c3 1x1, scalar": (6, 3, 1, 1, False, None, None, False),
    "crop 37x53, scalar": (6, 3, 37, 53, False, None, None, False),
    "4 B off, scalar": (6, 3, 16, 64, True, 1024, 2, False),
    "n16 4 B off, scalar": (16, 3, 9, 64, True, None, None, False),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(E6_CASES))
def test_merge_pipelined_matches_plain(cuda, rng, case):
    n, c, h, w, misaligned, chunk, stages, bulk = E6_CASES[case]
    val, std, invt, icrf, diff = _planar(rng, n, c, h, w, misaligned, cuda,
                                         256)
    assert lut_merge_cuda.bulk_route(
        c * h * w, val.data_ptr(), std.data_ptr()) == bulk
    before = lut_merge_cuda.KERNELS["E6"].launches
    got = lut_merge_cuda.merge_pipelined(val, std, invt, icrf, diff, chunk,
                                         stages)
    torch.cuda.synchronize()
    assert lut_merge_cuda.KERNELS["E6"].launches == before + 1
    _close(got, lut_merge_cuda.merge_planar_plain(val, std, invt, icrf,
                                                  diff))


# (N, C, H, W, misaligned): 37 x 53 and 1 x 1 planes end in a ragged quad
E7_CASES = {"n6": (6, 3, 40, 256, False), "n1": (1, 3, 21, 60, False),
            "n16": (16, 3, 9, 64, False),
            "ragged 37x53": (6, 3, 37, 53, False),
            "1x1": (6, 3, 1, 1, False),
            "4 B off": (6, 3, 16, 64, True)}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(E7_CASES))
def test_merge_table_form_matches_plain(cuda, rng, case):
    val, std, invt, icrf, diff = _planar(rng, *E7_CASES[case], cuda, 4096)
    want = lut_merge_cuda.merge_planar_plain(val, std, invt, icrf, diff)
    before = lut_merge_cuda.KERNELS["E7"].launches
    pack = lut_merge_cuda.pack_table
    outs = [lut_merge_cuda.merge_table_form(val, std, invt, pack(icrf, f),
                                            pack(diff, f), f)
            for f in lut_merge_cuda.FORMS]
    torch.cuda.synchronize()
    assert lut_merge_cuda.KERNELS["E7"].launches == before + 3
    _close(outs[0], want)
    for other in outs[1:]:  # every form rebuilds each entry exactly
        assert all(torch.equal(a, b) for a, b in zip(other, outs[0]))


@pytest.mark.cuda
def test_lut_merge_wrappers_reject_bad_input(cuda, rng):
    val, std, invt, icrf, diff = _planar(rng, 2, 3, 8, 8, False, cuda, 256)
    with pytest.raises(ValueError):  # tables on another device
        lut_merge_cuda.merge_pipelined(val, std, invt, icrf.cpu(), diff)
    with pytest.raises(ValueError):  # E7 takes 4096-entry tables
        lut_merge_cuda.merge_table_form(val, std, invt, icrf, diff, "f32")
    with pytest.raises(TypeError):
        lut_merge_cuda.merge_pipelined(val.double(), std, invt, icrf, diff)


# ---------------------------------------------------------------------------
# on the CPU
# ---------------------------------------------------------------------------

def test_cpu_tensors_run_the_plain_versions(rng):
    n, h, w, c = 3, 9, 11, 2
    val = torch.as_tensor(rng.uniform(0.05, 0.95, (n, h, w, c)))
    std = torch.as_tensor(rng.uniform(0.001, 0.01, (n, h, w, c)))
    dark = torch.as_tensor(_hot_darks(rng, (n, h, w, c), False))
    exposures = torch.tensor([0.002, 0.004, 0.008])
    icrf, diff = (torch.as_tensor(a) for a in _tables(rng, 256, c))
    counts = [k.launches for k in hdr_cuda.KERNELS]
    pairs = [
        (hdr_cuda.merge_nhwc_fused(val, std, exposures, icrf, diff),
         hdr_cuda.merge_fused_plain(val, std, exposures, icrf, diff)),
        (hdr_cuda.merge_nhwc_lerp(val, std, exposures, icrf, diff, 4096),
         hdr_cuda.merge_lerp_plain(val, std, exposures, icrf, diff, 4096)),
        (hdr_cuda.merge_nhwc_lerp_bp(val, std, dark, exposures, icrf, diff,
                                     0.5, 4096),
         hdr_cuda.merge_lerp_bp_plain(val, std, dark, exposures, icrf, diff,
                                      0.5, 4096)),
    ]
    for (gv, gs), (wv, ws) in pairs:
        torch.testing.assert_close(gv, wv, rtol=0, atol=0)
        torch.testing.assert_close(gs, ws, rtol=0, atol=0)
    assert [k.launches for k in hdr_cuda.KERNELS] == counts


_VAL_SIZES = {"f32": 4, "u8": 1, "i32": 4}
# planes of a multiple of 4 elements, then ragged ones
_PLANES = (4 * 3001, 4 * 3001 + 1, 4 * 3001 + 2, 4 * 3001 + 3)


@pytest.mark.parametrize("kind", list(_VAL_SIZES))
@pytest.mark.parametrize("c", [1, 3, 4, 8])
@pytest.mark.parametrize("rows", [256, 4096])
@pytest.mark.parametrize("use_std", [True, False])
def test_fused_plan_fits_and_routes(kind, c, rows, use_std):
    """For 1 to 40 exposures a K1 plan fits a block's shared memory, two
    blocks an SM wherever the tables allow it, or is refused; the quad walk
    is chosen exactly when the plane is a multiple of 4 elements, the value
    base is aligned to a quad's load (16 bytes, u8 4), the std base to 16
    bytes and N is at most the largest instance, whose smallest that holds
    N it takes."""
    size = _VAL_SIZES[kind]
    tables = rows * c * (8 if use_std else 4)
    val_addrs = (0, 256, size, 4, 8, 12)
    std_addrs = (256, 4, 260, 8) if use_std else (None,)
    for n in range(1, 41):
        if tables + 4 * n > hdr_cuda._MAX_SMEM:
            with pytest.raises(ValueError, match="shared memory"):
                hdr_cuda.plan_fused(n, c, rows, size, use_std, (0, None),
                                    _PLANES[0])
            continue
        for plane in _PLANES:
            for va in val_addrs:
                for sa in std_addrs:
                    p = hdr_cuda.plan_fused(n, c, rows, size, use_std,
                                            (va, sa), plane)
                    assert p.off_invt >= tables and p.off_invt % 16 == 0
                    assert p.off_invt + 4 * n <= p.smem <= hdr_cuda._MAX_SMEM
                    if tables + 4 * n <= hdr_cuda._SMEM_TWO_BLOCKS:
                        assert p.smem <= hdr_cuda._SMEM_TWO_BLOCKS
                    assert p.threads == 256 and p.pairs == int(use_std)
                    quad = (plane % 4 == 0 and va % (4 * size) == 0
                            and (sa is None or sa % 16 == 0)
                            and n <= max(hdr_cuda.MAXN))
                    assert p.quad == int(quad)
                    assert p.maxn == (min(m for m in hdr_cuda.MAXN
                                          if m >= n) if quad else 0)
                    assert p.route == (f"quad/{p.maxn}" if quad
                                       else "scalar")


def test_fused_plan_of_the_configs():
    """Config 2/3 (6 exposures, 3 channels, std) takes the 8-instance with
    6 KB of 256-entry pair tables or 96 KB of 4096-entry ones, both two
    blocks an SM; config 5 (N = 3) the 4-instance; 16384-entry pair tables
    do not fit a block, the same tables without std fit one."""
    plane = 1200 * 1920 * 3
    for rows, off in ((256, 6144), (4096, 98304)):
        p = hdr_cuda.plan_fused(6, 3, rows, 4, True, (0, 0), plane)
        assert (p.quad, p.maxn, p.pairs, p.off_invt, p.smem) == \
            (1, 8, 1, off, off + 24)
        assert p.smem <= hdr_cuda._SMEM_TWO_BLOCKS
    p5 = hdr_cuda.plan_fused(3, 3, 256, 4, True, (0, 0), 2160 * 3840 * 3)
    assert p5.route == "quad/4"
    with pytest.raises(ValueError, match="shared memory"):
        hdr_cuda.plan_fused(6, 3, 16384, 4, True, (0, 0), plane)
    big = hdr_cuda.plan_fused(6, 3, 16384, 4, False, (0, None), plane)
    assert hdr_cuda._SMEM_TWO_BLOCKS < big.smem <= hdr_cuda._MAX_SMEM


@pytest.mark.parametrize("kind", list(_VAL_SIZES))
def test_fused_launch_plan_of_stacks(kind):
    """The wrapper's plan from the stacks themselves: their shape, element
    size and base addresses (CPU tensors here; the kernel is not run)."""
    rng = np.random.default_rng(3)
    val = _t(_stack(rng, (6, 16, 40, 3), kind), "cpu")
    std = torch.ones(val.shape)
    plan = hdr_cuda.fused_launch_plan
    assert val.data_ptr() % 16 == 0 and std.data_ptr() % 16 == 0
    assert plan(val, std, 256).route == "quad/8"
    assert plan(val[:3], std[:3], 4096).route == "quad/4"
    assert plan(val, None, 256).route == "quad/8"
    assert plan(_skewed(val), std, 256).route == "scalar"
    assert plan(val, _skewed(std), 256).route == "scalar"
    assert plan(val[:, :13, :13].contiguous(), None, 256).route == "scalar"
    n17 = torch.cat([val, val, val[:5]])
    assert plan(n17, None, 256).route == "scalar"
    assert plan(n17[:16], None, 256).route == "quad/16"
    if kind == "u8":  # a quad of u8 is a 4-byte load
        four_off = torch.empty(val.numel() + 4, dtype=val.dtype)[4:]
        assert plan(four_off.view(val.shape), None, 256).route == "quad/8"


# (value bytes, dark bytes) of each K2/K3 kernel instance
_LERP_KINDS = {"k2-f32": (4, 0), "k2-u8": (1, 0), "k2-i32": (4, 0),
               "k3-f32-darks": (4, 4), "k3-u8-mask": (4, 1)}


@pytest.mark.parametrize("kind", list(_LERP_KINDS))
@pytest.mark.parametrize("use_std", [True, False])
@pytest.mark.parametrize("c", [1, 3, 4, 8])
def test_lerp_plan_fits_shared_memory(kind, use_std, c):
    """For every exposure count up to 1000, a K2/K3 plan fits a block's
    shared memory, with 128-byte aligned tiles and mbarriers; up to
    MAX_SLOTS exposures it holds them all, where two blocks fit an SM."""
    val_size, dark_size = _LERP_KINDS[kind]
    halo = 1 if dark_size else 0
    tables = 256 * c * 8
    for n in [*range(1, 70), 100, 1000]:
        p = hdr_cuda.plan_lerp_tiles(n, c, val_size, use_std, dark_size)
        assert p.smem <= hdr_cuda._MAX_SMEM
        assert 1 <= p.slots <= min(n, hdr_cuda.MAX_SLOTS)
        if n <= hdr_cuda.MAX_SLOTS:
            assert p.slots == n and p.smem <= hdr_cuda._SMEM_TWO_BLOCKS
        assert p.twe % 16 == 0 and p.pad % 4 == 0 and p.pad >= halo * c
        assert p.rows == p.th + 2 * halo and p.stride == p.twe + 2 * p.pad
        assert 32 <= p.threads <= 256 and p.threads % 32 == 0
        val_b = p.rows * p.stride * val_size
        std_b = p.rows * p.stride * 4 if use_std else 0
        dark_b = p.th * p.twe * dark_size
        assert p.tx_bytes == val_b + std_b + dark_b
        for off in (p.off_std, p.off_dark, p.slot_bytes, p.off_bar,
                    p.off_slots):
            assert off % 128 == 0
        assert p.off_std >= val_b and p.off_dark - p.off_std >= std_b
        assert p.slot_bytes - p.off_dark >= dark_b
        assert p.off_bar >= tables and p.off_slots - p.off_bar >= 8 * p.slots
        assert p.smem >= p.off_slots + p.slots * p.slot_bytes + 128


def test_lerp_plan_of_config_3():
    """K3 at config 3 (6 exposures, 3 channels, f32 value, std and darks):
    16 x 64-element tiles of all 6 exposures, two blocks to an SM."""
    p = hdr_cuda.plan_lerp_tiles(6, 3, 4, True, 4)
    assert (p.th, p.twe, p.pad, p.slots, p.threads) == (16, 64, 4, 6, 256)
    assert p.smem <= hdr_cuda._SMEM_TWO_BLOCKS
    k2 = hdr_cuda.plan_lerp_tiles(6, 3, 4, True)
    assert (k2.th, k2.twe, k2.pad, k2.slots) == (4, 256, 0, 6)


def test_tma_route_by_alignment_and_stride():
    k3 = hdr_cuda.plan_lerp_tiles(6, 3, 4, True, 4)
    k3_mask = hdr_cuda.plan_lerp_tiles(6, 3, 4, True, 1)
    route = hdr_cuda.tma_route
    assert route(k3, 5760, (0, 4), (256, 4), (512, 4))   # config 3
    assert route(k3_mask, 5760, (0, 4), (256, 4), (512, 1))
    assert not route(k3, 159, (0, 4), (256, 4), (512, 4))  # 37 x 53 crop
    assert not route(k3, 5760, (4, 4), (256, 4), (512, 4))  # base 4 B off
    assert not route(k3, 5760, (0, 4), (264, 4), (512, 4))
    # f32 rows of 5764 elements are 16-byte multiples, u8 mask rows not
    assert route(k3, 5764, (0, 4), (256, 4), (512, 4))
    assert not route(k3_mask, 5764, (0, 4), (256, 4), (512, 1))
    k2_u8 = hdr_cuda.plan_lerp_tiles(6, 3, 1, False)
    assert route(k2_u8, 336, (0, 1)) and not route(k2_u8, 324, (0, 1))
    k2 = hdr_cuda.plan_lerp_tiles(6, 3, 4, True)
    assert route(k2, 324, (0, 4), (0, 4))
    # a halo of 100 channels makes a box wider than TMA's 256 elements
    wide = hdr_cuda.plan_lerp_tiles(6, 100, 4, False, 4)
    assert wide.stride > 256 and not route(wide, 6400, (0, 4), None, (0, 4))


def _run_python(code: str) -> str:
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return out.stdout


_PORT_MODULES = [
    "camera_linearity_tpu_torch", "camera_linearity_tpu_torch.config",
    "camera_linearity_tpu_torch.measurand",
    "camera_linearity_tpu_torch.csrc",
    "camera_linearity_tpu_torch.ops.uncertainty",
    "camera_linearity_tpu_torch.ops.linearize",
    "camera_linearity_tpu_torch.ops.filters",
    "camera_linearity_tpu_torch.ops.hdr",
    "camera_linearity_tpu_torch.ops.hdr_cuda",
    "camera_linearity_tpu_torch.ops.stats",
    "camera_linearity_tpu_torch.ops.linearity",
    "camera_linearity_tpu_torch.models.image_set",
    "camera_linearity_tpu_torch.models.exposure_series",
    "camera_linearity_tpu_torch.models.icrf",
    "camera_linearity_tpu_torch.models.calibration",
    "camera_linearity_tpu_torch.models.scipy_strict",
    "camera_linearity_tpu_torch.models.dorf",
    "camera_linearity_tpu_torch.utils.device",
    "camera_linearity_tpu_torch.utils.io",
    "camera_linearity_tpu_torch.utils.state",
    "camera_linearity_tpu_torch.utils.general",
    "camera_linearity_tpu_torch.utils.checkpoint",
    "camera_linearity_tpu_torch.utils.avi",
    "camera_linearity_tpu_torch.utils.observability",
    "camera_linearity_tpu_torch.native",
    "camera_linearity_tpu_torch.native.jpeg_plain",
    "camera_linearity_tpu_torch.native.h264_plain",
    "camera_linearity_tpu_torch.ops.welford",
    "camera_linearity_tpu_torch.models.video",
    "camera_linearity_tpu_torch.models.pipeline",
    "camera_linearity_tpu_torch.utils.tiff",
    "camera_linearity_tpu_torch.native.tiff_plain",
    "camera_linearity_tpu_torch.utils.visualization",
    "camera_linearity_tpu_torch.__main__",
    "camera_linearity_tpu_torch.ops.ablation_cuda",
    "camera_linearity_tpu_torch.experiments.exp_kernel",
    "camera_linearity_tpu_torch.experiments.exp_plateau",
    "camera_linearity_tpu_torch.ops.lut_merge_cuda",
    "camera_linearity_tpu_torch.experiments.exp_manual_pipeline",
    "camera_linearity_tpu_torch.experiments.exp_int8_planes",
    "camera_linearity_tpu_torch.parallel.mesh",
    "camera_linearity_tpu_torch.parallel.sharded",
    "camera_linearity_tpu_torch.parallel.distributed",
]


def test_port_imports_no_jax(tmp_path):
    """Importing the port, and decoding an MJPG AVI and a UtVideo (ULY0)
    AVI with its decoders and the decoders' plain versions, pulls in no
    JAX, cv2, PIL or matplotlib."""
    from tests._torch_utvideo_writer import write_utvideo_avi
    clip = tmp_path / "uly0 5ms.avi"
    rng = np.random.default_rng(0)
    write_utvideo_avi(clip, [[rng.integers(0, 256, s, dtype=np.uint8)
                              for s in ((8, 12), (4, 6), (4, 6))]] * 2, 8, 12,
                      "ULY0", "median", 2)
    out = _run_python(
        "import importlib, sys\n"
        f"for m in {_PORT_MODULES!r}: importlib.import_module(m)\n"
        "import numpy as np\n"
        "from camera_linearity_tpu_torch import native\n"
        "from camera_linearity_tpu_torch.native import jpeg_plain\n"
        "from camera_linearity_tpu_torch.native import utvideo_plain\n"
        "from camera_linearity_tpu_torch.utils import avi\n"
        "frames = list(avi.mjpg_chunks('tests/data/mjpg 5ms.avi'))\n"
        "dst = np.empty((len(frames), 32, 48, 3), np.uint8)\n"
        "native.jpeg_decode_bgr_batch(frames, dst, fast=True)\n"
        "jpeg_plain.decode(frames[0])\n"
        f"info = avi.probe_avi({str(clip)!r})\n"
        "params = avi.utvideo_params(info)\n"
        "chunks = [bytes(c) for c in avi.frame_chunks(\n"
        f"    {str(clip)!r}, info)]\n"
        "dst = np.empty((2, 8, 12, 3), np.uint8)\n"
        "native.utvideo_decode_bgr_batch(chunks, dst, params)\n"
        "assert (dst[1] == utvideo_plain.decode_bgr(chunks[1], params, 8,\n"
        "                                           12)).all()\n"
        "print(sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'cv2', 'PIL',\n"
        "                                    'camera_linearity_tpu',\n"
        "                                    'matplotlib', 'benchmarks')))\n")
    assert out.strip() == "[]"


def test_import_builds_nothing():
    out = _run_python(
        "import subprocess\n"
        "calls = []\n"
        "subprocess.run = lambda *a, **k: calls.append(a)\n"
        "from camera_linearity_tpu_torch import csrc\n"
        "from camera_linearity_tpu_torch.ops import hdr, hdr_cuda\n"
        "from camera_linearity_tpu_torch.models import exposure_series\n"
        "from camera_linearity_tpu_torch.models import pipeline, video\n"
        "from camera_linearity_tpu_torch import native\n"
        "from camera_linearity_tpu_torch.utils import io, tiff\n"
        "import camera_linearity_tpu_torch.__main__\n"
        "from camera_linearity_tpu_torch.ops import ablation_cuda\n"
        "from camera_linearity_tpu_torch.experiments import (exp_kernel,\n"
        "                                                    exp_plateau)\n"
        "from camera_linearity_tpu_torch.ops import lut_merge_cuda\n"
        "from camera_linearity_tpu_torch.experiments import (\n"
        "    exp_int8_planes, exp_manual_pipeline)\n"
        "print(csrc._libs == {}, calls == [],\n"
        "      [k.launches for k in hdr_cuda.KERNELS],\n"
        "      [e.launches for e in ablation_cuda.KERNELS.values()],\n"
        "      [e.launches for e in lut_merge_cuda.KERNELS.values()],\n"
        "      native._tried or bool(native._decoder_libs))\n")
    assert out.strip() == \
        "True True [0, 0, 0] [0, 0, 0, 0, 0] [0, 0] False"


def test_first_use_builds_only_its_group(monkeypatch):
    """A merge kernel's first use builds the two merge sources, never an
    experiments' source; an experiment's first use builds only its own."""
    from camera_linearity_tpu_torch import csrc
    built = []

    def fake_build(names=csrc.SOURCES):
        built.append(tuple(names))
        return {name: Path(f"lib{name}.so") for name in names}
    monkeypatch.setattr(csrc, "_libs", {})
    monkeypatch.setattr(csrc, "build", fake_build)
    monkeypatch.setattr(csrc.ctypes, "CDLL", lambda path: object())
    for name in ("hdr_merge", "exp_lut_merge", "hdr_merge_lerp",
                 "exp_ablation", "hdr_merge", "exp_lut_merge"):
        csrc.library(name)
    assert built == [csrc.MERGE_SOURCES, ("exp_lut_merge",),
                     csrc.MERGE_SOURCES, ("exp_ablation",)]
    assert not {"exp_ablation", "exp_lut_merge"} & set(csrc.MERGE_SOURCES)
    assert set(csrc.SOURCES) == {*csrc.MERGE_SOURCES, "exp_ablation",
                                 "exp_lut_merge"}


_FAKE_NVCC = """#!/bin/sh
# stands in for nvcc: writes the -o file, fails for a source named in FAIL
for a; do src=$a; done
while [ $# -gt 0 ]; do [ "$1" = "-o" ] && out=$2; shift; done
case "$src" in *"$FAIL"*) [ -n "$FAIL" ] && { echo "no" >&2; exit 2; } ;; esac
echo "ptxas info" >&2
: > "$out"
"""


@pytest.mark.parametrize("fail", ["", "exp_ablation", "exp_lut_merge"])
def test_build_compiles_each_source_once(monkeypatch, tmp_path, fail):
    """``build`` runs one compiler per source not built yet, records each
    wall and raises naming a source that failed, keeping the others."""
    from camera_linearity_tpu_torch import csrc
    nvcc = tmp_path / "cuda" / "bin" / "nvcc"
    nvcc.parent.mkdir(parents=True)
    nvcc.write_text(_FAKE_NVCC)
    nvcc.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setenv("FAIL", fail)
    monkeypatch.setattr(csrc, "_BUILD_ROOT", tmp_path / "build")
    monkeypatch.setattr(csrc, "BUILD_SECONDS", {})
    if fail:
        with pytest.raises(RuntimeError, match=f"{fail}.cu: nvcc"):
            csrc.build()
    else:
        paths = csrc.build()
        assert sorted(paths) == sorted(csrc.SOURCES)
    ok = [s for s in csrc.SOURCES if s != fail]
    assert sorted(csrc.BUILD_SECONDS) == sorted(ok)
    for name in ok:
        lib = csrc._lib_path(name)
        assert lib.exists() and (lib.parent / "ptxas.log").exists()
    csrc.BUILD_SECONDS.clear()
    csrc.build(ok)  # built already: nothing runs
    assert csrc.BUILD_SECONDS == {}
