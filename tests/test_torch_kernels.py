"""The CUDA merge kernels K1-K3 against their plain PyTorch versions.

The tests marked ``cuda`` need a card and skip without one; on a machine
with a card and no JAX, run them with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py

(this file imports no JAX).  Card tolerances, f32 against f32, where the
differences come from ``expf`` and FMA contraction: value rtol 2e-5 /
atol 1e-6, std rtol 2e-4 / atol 1e-5; the median repair agrees exactly.
K2 and K3 are held at shapes that reach their tile edges, both load routes
(TMA where a row is a multiple of 16 bytes, the copy route elsewhere), 1 to
12 exposures, batches, every stack type, and hot pixels on tile borders,
image corners and next to each other.  The CPU tests check that a wrapper
given a CPU tensor runs its plain version and counts no launch, the K2/K3
tile planner and route choice, and that importing the port neither imports
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

from camera_linearity_tpu_torch.ops import filters, hdr, hdr_cuda  # noqa: E402

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

@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["f32", "u8", "i32"])
@pytest.mark.parametrize("bits", [256, 4096])
@pytest.mark.parametrize("compat", ["corrected", "reference"])
@pytest.mark.parametrize("use_std", [True, False])
def test_k1_matches_plain(cuda, rng, kind, bits, compat, use_std):
    n, h, w, c = 4, 21, 60, 3  # ragged: no size is a block multiple
    val = _t(_stack(rng, (n, h, w, c), kind, bits - 1), cuda)
    std = _f32(rng.uniform(0.001, 0.02, (n, h, w, c)), cuda) \
        if use_std else None
    exposures = _f32([0.002, 0.004, 0.008, 0.016], cuda)
    icrf, diff = (_f32(a, cuda) for a in _tables(rng, bits, c))
    before = hdr_cuda.merge_nhwc_fused.launches
    got = hdr_cuda.merge_nhwc_fused(val, std, exposures, icrf, diff, compat)
    torch.cuda.synchronize()
    assert hdr_cuda.merge_nhwc_fused.launches == before + 1
    _close(got, hdr_cuda.merge_fused_plain(val, std, exposures, icrf, diff,
                                           compat))


@pytest.mark.cuda
def test_k1_batch_and_dispatch(cuda, rng):
    """merge_batch is one K1 launch over a (B, N, H, W, C) batch and
    agrees with merging each scene alone."""
    b, n, h, w, c = 2, 3, 17, 33, 3
    val = _f32(rng.uniform(0, 1, (b, n, h, w, c)), cuda)
    std = _f32(rng.uniform(0.001, 0.02, (b, n, h, w, c)), cuda)
    exposures = _f32([0.001, 0.004, 0.016], cuda)
    icrf, diff = (_f32(a, cuda) for a in _tables(rng, 256, c))
    before = hdr_cuda.merge_nhwc_fused.launches
    bv, bs = hdr.merge_batch(val, std, exposures, icrf, diff)
    assert hdr_cuda.merge_nhwc_fused.launches == before + 1
    for i in range(b):
        _close((bv[i], bs[i]), hdr.merge_hdr(val[i], std[i], exposures,
                                             icrf, diff, use_kernel=False))


def _exposures(n, device):
    return _f32(0.002 * 2.0 ** np.arange(n), device)


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
    "camera_linearity_tpu_torch.ops.welford",
    "camera_linearity_tpu_torch.models.video",
    "camera_linearity_tpu_torch.models.pipeline",
]


def test_port_imports_no_jax():
    out = _run_python(
        "import importlib, sys\n"
        f"for m in {_PORT_MODULES!r}: importlib.import_module(m)\n"
        "print(sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'cv2',\n"
        "                                    'camera_linearity_tpu')))\n")
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
        "print(csrc._libs == {}, calls == [],\n"
        "      [k.launches for k in hdr_cuda.KERNELS],\n"
        "      native._tried or native._mjpeg_tried)\n")
    assert out.strip() == "True True [0, 0, 0] False"
