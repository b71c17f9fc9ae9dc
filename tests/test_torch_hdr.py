"""Port parity: the HDR merge (ops/hdr.py) and the kernels' plain versions
(ops/hdr_cuda.py) against the JAX package.

* The plain merge paths (``merge_stack``, ``merge_stack_u8``, ``merge_hdr``,
  ``merge_batch``, ``merge_corrected``) on float64 CPU tensors against the
  JAX functions under x64: rtol 1e-10 / atol 1e-12.
* ``merge_fused_plain``, ``merge_lerp_plain`` and ``merge_lerp_bp_plain`` in
  float32 against the Pallas kernels K1-K3, which run in interpret mode on
  the CPU: value rtol 5e-5 / atol 1e-6, std rtol 5e-4 / atol 1e-5, the
  tolerances tests/unit/test_hdr_pallas2.py holds the kernels to (the sums
  run in another order, and the std's weight/bracket cancellation amplifies
  f32 noise near zero).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from camera_linearity_tpu.ops import filters as jfilt  # noqa: E402
from camera_linearity_tpu.ops import hdr as jhdr  # noqa: E402
from camera_linearity_tpu.ops import hdr_pallas2 as jpallas  # noqa: E402
from camera_linearity_tpu_torch.ops import hdr as thdr  # noqa: E402
from camera_linearity_tpu_torch.ops import filters as tfilt  # noqa: E402
from camera_linearity_tpu_torch.ops import hdr_cuda  # noqa: E402
from tests.unit.test_hdr_merge import numpy_reference_merge  # noqa: E402

TOL = dict(rtol=1e-10, atol=1e-12)
K_VAL_TOL = dict(rtol=5e-5, atol=1e-6)
K_STD_TOL = dict(rtol=5e-4, atol=1e-5)
N, H, W, C = 3, 32, 40, 2
EXPOSURES = np.array([0.002, 0.004, 0.008])


def _t(a):
    return None if a is None else torch.as_tensor(np.array(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


def _close(got, want, val_tol=TOL, std_tol=TOL):
    (gv, gs), (wv, ws) = got, want
    np.testing.assert_allclose(gv.numpy(), np.asarray(wv), **val_tol)
    if ws is None:
        assert gs is None
    else:
        np.testing.assert_allclose(gs.numpy(), np.asarray(ws), **std_tol)


def _tables(rng, bits, c=C):
    icrf = np.sort(rng.uniform(0, 1, (bits, c)), axis=0)
    icrf[0], icrf[-1] = 0.0, 1.0
    return icrf, np.gradient(icrf, 2 / (bits - 1), axis=0)


def _interp_tables(rng, bits, c=C):
    """256-point base curves and their np.interp expansion to ``bits``
    entries (the reference's >8-bit construction)."""
    base, diff_base = _tables(rng, 256, c)
    x, xb = np.arange(bits) / (bits - 1), np.arange(256) / 255.0
    icrf = np.stack([np.interp(x, xb, base[:, ch]) for ch in range(c)], 1)
    diff = np.stack([np.interp(x, xb, diff_base[:, ch]) for ch in range(c)],
                    1)
    return base, diff_base, icrf, diff


def _stack(rng, shape=(N, H, W, C)):
    return (rng.uniform(0.02, 0.98, shape), rng.uniform(0.001, 0.02, shape))


def _f32_ties(max_dn):
    """f32 values whose f32 product with max_dn is exactly k + 0.5."""
    k = np.arange(max_dn, dtype=np.float32)
    v = (k + np.float32(0.5)) / np.float32(max_dn)
    return v[v * np.float32(max_dn) == k + np.float32(0.5)]


# ---------------------------------------------------------------------------
# plain merge paths, float64
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("compat", ["corrected", "reference"])
@pytest.mark.parametrize("with_std", [True, False])
def test_merge_stack(rng, compat, with_std):
    val, std = _stack(rng)
    std = std if with_std else None
    icrf, diff = _tables(rng, 256)
    args = (val, std, EXPOSURES, icrf, diff)
    got = thdr.merge_stack(*map(_t, args), compat=compat)
    _close(got, jhdr.merge_stack(*map(_j, args), compat=compat))
    if with_std:
        _close(got, numpy_reference_merge(*args, mode=compat))


@pytest.mark.parametrize("compat", ["corrected", "reference"])
@pytest.mark.parametrize("dtype", [np.uint8, np.int32])
@pytest.mark.parametrize("with_std", [True, False])
def test_merge_stack_u8(rng, compat, dtype, with_std):
    dn = rng.integers(0, 256, (N, H, W, C)).astype(dtype)
    std = rng.uniform(0.001, 0.02, dn.shape) if with_std else None
    icrf, diff = _tables(rng, 256)
    args = (dn, std, EXPOSURES, icrf, diff)
    _close(thdr.merge_stack_u8(*map(_t, args), compat=compat),
           jhdr.merge_stack_u8(*map(_j, args), compat=compat))


@pytest.mark.parametrize("bits", [256, 1024, 4096])
@pytest.mark.parametrize("with_base", [True, False])
@pytest.mark.parametrize("use_kernel", [None, False, True])
def test_merge_hdr_routes(rng, bits, with_base, use_kernel):
    """On CPU tensors every route is the plain path on the expanded tables,
    as the JAX package's is off the TPU."""
    val, std = _stack(rng)
    base, diff_base, icrf, diff = _interp_tables(rng, bits)
    kw = dict(icrf_base=_t(base), icrf_diff_base=_t(diff_base)) \
        if with_base else {}
    jkw = {k: _j(v.numpy()) for k, v in kw.items()}
    args = (val, std, EXPOSURES, icrf, diff)
    _close(thdr.merge_hdr(*map(_t, args), use_kernel=use_kernel, **kw),
           jhdr.merge_hdr(*map(_j, args), use_pallas=use_kernel, **jkw))


def test_merge_hdr_integer_stack(rng):
    dn = rng.integers(0, 256, (N, H, W, C)).astype(np.uint8)
    icrf, diff = _tables(rng, 256)
    args = (dn, None, EXPOSURES, icrf, diff)
    _close(thdr.merge_hdr(*map(_t, args)), jhdr.merge_hdr(*map(_j, args)))


@pytest.mark.parametrize("with_std", [True, False])
@pytest.mark.parametrize("bits", [256, 4096])
def test_merge_batch(rng, with_std, bits):
    val, std = _stack(rng, (2, N, H, W, C))
    std = std if with_std else None
    base, diff_base, icrf, diff = _interp_tables(rng, bits)
    args = (val, std, EXPOSURES, icrf, diff)
    got = thdr.merge_batch(*map(_t, args), icrf_base=_t(base),
                           icrf_diff_base=_t(diff_base))
    assert got[0].shape == (2, H, W, C)
    _close(got, jhdr.merge_batch(*map(_j, args), icrf_base=_j(base),
                                 icrf_diff_base=_j(diff_base)))


def test_sum_of_weights(rng):
    val, _ = _stack(rng)
    for g, w in zip(thdr.sum_of_weights(_t(val)),
                    jhdr.sum_of_weights(_j(val))):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def _darks(rng, shape, as_mask, threshold=0.5):
    """Per-exposure darks, ~5 % hot including the four corners and two
    pairs of adjacent pixels; the last exposure's plane is all zero (no
    matched dark)."""
    dark = rng.uniform(0.0, 0.1, shape)
    hot = rng.uniform(0, 1, shape) < 0.05
    hot[:, 0, 0] = hot[:, 0, -1] = hot[:, -1, 0] = hot[:, -1, -1] = True
    hot[:, 3, 4:6] = hot[:, 4:6, 1] = True
    dark[hot] = rng.uniform(0.6, 1.0, int(hot.sum()))
    dark[-1] = 0.0
    return (dark > threshold).astype(np.uint8) if as_mask else dark


@pytest.mark.parametrize("as_mask", [False, True])
@pytest.mark.parametrize("kernel_size", [3, 5])
@pytest.mark.parametrize("with_flat", [True, False])
@pytest.mark.parametrize("with_std", [True, False])
def test_merge_corrected(rng, as_mask, kernel_size, with_flat, with_std):
    val, std = _stack(rng)
    std = std if with_std else None
    dark = _darks(rng, val.shape, as_mask)
    icrf, diff = _tables(rng, 256)
    flat = rng.uniform(0.6, 1.0, (H, W, C)) if with_flat else None
    flat_std = rng.uniform(0.001, 0.01, (H, W, C)) if with_flat else None
    args = (val, std, dark, EXPOSURES, icrf, diff)
    kw = dict(mid_percentage=0.2, kernel_size=kernel_size)
    _close(thdr.merge_corrected(*map(_t, args), 0.5, _t(flat), _t(flat_std),
                                **kw),
           jhdr.merge_corrected(*map(_j, args), jnp.asarray(0.5), _j(flat),
                                _j(flat_std), **kw))


@pytest.mark.parametrize("compat", ["corrected", "reference"])
def test_merge_corrected_12bit_base_curves(rng, compat):
    val, std = _stack(rng)
    dark = _darks(rng, val.shape, False)
    base, diff_base, icrf, diff = _interp_tables(rng, 4096)
    flat = rng.uniform(0.6, 1.0, (H, W, C))
    args = (val, std, dark, EXPOSURES, icrf, diff)
    _close(thdr.merge_corrected(*map(_t, args), 0.5, _t(flat), None,
                                compat=compat, icrf_base=_t(base),
                                icrf_diff_base=_t(diff_base)),
           jhdr.merge_corrected(*map(_j, args), jnp.asarray(0.5), _j(flat),
                                None, compat=compat, icrf_base=_j(base),
                                icrf_diff_base=_j(diff_base)))


# ---------------------------------------------------------------------------
# the kernels' plain versions, float32, against the Pallas kernels
# ---------------------------------------------------------------------------

def _f32_stack(rng, kind="f32", max_dn=255):
    """An f32 [0,1] stack with a band of exact half-DN ties, or DNs."""
    if kind != "f32":
        return rng.integers(0, max_dn + 1, (N, H, W, C)).astype(
            np.uint8 if kind == "u8" else np.int32)
    val = rng.uniform(0.0, 1.0, (N, H, W, C)).astype(np.float32)
    ties = _f32_ties(max_dn)
    val[:, :2] = np.resize(ties, (N, 2, W, C))
    return val


def _f32(*arrays):
    return [None if a is None else np.asarray(a, np.float32)
            for a in arrays]


@pytest.mark.parametrize("compat,with_std,kind,bits", [
    ("corrected", True, "f32", 256), ("reference", True, "f32", 256),
    ("corrected", False, "f32", 256), ("reference", False, "f32", 256),
    ("corrected", True, "u8", 256), ("reference", True, "f32", 4096),
    ("corrected", False, "i32", 4096)])
def test_fused_plain_matches_pallas_k1(rng, compat, with_std, kind, bits):
    val = _f32_stack(rng, kind, bits - 1)
    std, exposures, icrf, diff = _f32(
        rng.uniform(0.001, 0.02, val.shape) if with_std else None,
        EXPOSURES, *_tables(rng, bits))
    args = (val, std, exposures, icrf, diff)
    got = hdr_cuda.merge_fused_plain(*map(_t, args), compat=compat)
    assert got[0].dtype == torch.float32
    _close(got, jpallas.merge_nhwc_fused(*map(_j, args), compat=compat,
                                         hb=8),
           K_VAL_TOL, K_STD_TOL)


@pytest.mark.parametrize("bits", [1024, 4096])
@pytest.mark.parametrize("with_std", [True, False])
@pytest.mark.parametrize("kind", ["f32", "i32"])
def test_lerp_plain_matches_pallas_k2(rng, bits, with_std, kind):
    val = _f32_stack(rng, kind, bits - 1)
    base, diff_base, _, _ = _interp_tables(rng, bits)
    std, exposures, base, diff_base = _f32(
        rng.uniform(0.001, 0.02, val.shape) if with_std else None,
        EXPOSURES, base, diff_base)
    diff_base = diff_base if with_std else None
    args = (val, std, exposures, base, diff_base)
    _close(hdr_cuda.merge_lerp_plain(*map(_t, args), bits=bits),
           jpallas.merge_nhwc_lerp(*map(_j, args), bits=bits, hb=8),
           K_VAL_TOL, K_STD_TOL)


@pytest.mark.parametrize("bits", [256, 4096])
@pytest.mark.parametrize("as_mask", [False, True])
@pytest.mark.parametrize("with_std", [True, False])
def test_lerp_bp_plain_matches_pallas_k3(rng, bits, as_mask, with_std):
    val = _f32_stack(rng)
    base, diff_base, _, _ = _interp_tables(rng, bits)
    dark = _darks(rng, val.shape, as_mask)
    std, exposures, base, diff_base = _f32(
        rng.uniform(0.001, 0.02, val.shape) if with_std else None,
        EXPOSURES, base, diff_base)
    dark = dark if as_mask else dark.astype(np.float32)
    diff_base = diff_base if with_std else None
    thr = np.float32(0.5)
    got = hdr_cuda.merge_lerp_bp_plain(_t(val), _t(std), _t(dark),
                                       _t(exposures), _t(base),
                                       _t(diff_base), thr, bits)
    want = jpallas.merge_nhwc_lerp_bp(_j(val), _j(std), _j(dark),
                                      _j(exposures), _j(base), _j(diff_base),
                                      jnp.asarray(thr), bits=bits)
    _close(got, want, K_VAL_TOL, K_STD_TOL)


@pytest.mark.parametrize("as_mask", [False, True])
def test_lerp_bp_plain_repairs_adjacent_hot_pixels_like_pallas_k3(rng,
                                                                  as_mask):
    """Hot pixels side by side and one above the other, their raw values at
    1: each one's median sees its partner's unrepaired value, in the plain
    version as in the Pallas kernel (H = 32, a multiple of its 16-row
    blocks), and a repair that saw the partner repaired would differ."""
    val = _f32_stack(rng)
    val[:, 3, 4:6] = val[:, 4:6, 1] = 1.0
    base, diff_base, _, _ = _interp_tables(rng, 4096)
    dark = _darks(rng, val.shape, as_mask)
    std, exposures, base, diff_base = _f32(
        rng.uniform(0.001, 0.02, val.shape), EXPOSURES, base, diff_base)
    dark = dark if as_mask else dark.astype(np.float32)
    thr = np.float32(0.5)
    got = hdr_cuda.merge_lerp_bp_plain(_t(val), _t(std), _t(dark),
                                       _t(exposures), _t(base),
                                       _t(diff_base), thr, 4096)
    want = jpallas.merge_nhwc_lerp_bp(_j(val), _j(std), _j(dark),
                                      _j(exposures), _j(base), _j(diff_base),
                                      jnp.asarray(thr), bits=4096)
    _close(got, want, K_VAL_TOL, K_STD_TOL)
    # repairing in place, one pixel after the other, changes the pairs
    seq = val.copy()
    hot = dark != 0 if as_mask else dark > thr
    for e in range(N - 1):
        for (r, c0) in ((3, 4), (3, 5), (4, 1), (5, 1)):
            win = np.pad(seq[e], ((1, 1), (1, 1), (0, 0)), mode="symmetric")
            seq[e, r, c0] = np.where(hot[e, r, c0],
                                     np.median(win[r:r + 3, c0:c0 + 3],
                                               axis=(0, 1)), seq[e, r, c0])
    fixed, _ = tfilt.bad_pixel_filter_stack(_t(val), None, _t(dark), thr)
    assert not np.allclose(fixed.numpy()[:-1, [3, 3, 4, 5], [4, 5, 1, 1]],
                           seq[:-1, [3, 3, 4, 5], [4, 5, 1, 1]])


def test_lerp_bp_plain_is_repair_then_lerp(rng):
    """K3's plain version is exactly the per-exposure median repair
    followed by K2's, and a 256-entry table is its own base curve: the
    lerp then degenerates to K1's exact lookup."""
    val = _f32_stack(rng)
    std, exposures, icrf, diff = _f32(rng.uniform(0.001, 0.02, val.shape),
                                      EXPOSURES, *_tables(rng, 256))
    dark = _darks(rng, val.shape, False).astype(np.float32)
    got = hdr_cuda.merge_lerp_bp_plain(*map(_t, (val, std, dark, exposures,
                                                 icrf, diff)), 0.5, 256)
    fixed = [jfilt.bad_pixel_filter(_j(val[e]), _j(std[e]), _j(dark[e]),
                                    0.5, 3) for e in range(N)]
    fv = np.stack([np.asarray(v) for v, _ in fixed])
    fs = np.stack([np.asarray(s) for _, s in fixed])
    exact = hdr_cuda.merge_fused_plain(*map(_t, (fv, fs, exposures, icrf,
                                                 diff)))
    _close(got, tuple(x.numpy() for x in exact), dict(rtol=0, atol=0),
           dict(rtol=0, atol=0))


def test_plain_versions_reject_bad_base_curves(rng):
    val, std = _f32(*_stack(rng))
    base, diff_base = _f32(*_tables(rng, 128))
    with pytest.raises(ValueError):
        hdr_cuda.merge_lerp_plain(_t(val), None, _t(EXPOSURES), _t(base),
                                  None, 4096)
    base, _ = _f32(*_tables(rng, 256))
    with pytest.raises(ValueError):
        hdr_cuda.merge_lerp_plain(_t(val), _t(std), _t(EXPOSURES), _t(base),
                                  None, 4096)


@pytest.mark.parametrize("bits", [256, 1024, 4096])
def test_is_piecewise_linear_256(rng, bits):
    _, _, icrf, _ = _interp_tables(rng, bits)
    rough = np.sort(rng.uniform(0, 1, (bits, C)), axis=0)
    for table in (icrf, rough):
        assert hdr_cuda.is_piecewise_linear_256(table) == \
            jpallas.is_piecewise_linear_256(table)
        assert hdr_cuda.is_piecewise_linear_256(_t(table)) == \
            jpallas.is_piecewise_linear_256(table)
