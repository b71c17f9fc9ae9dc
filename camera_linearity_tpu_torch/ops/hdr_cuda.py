"""The HDR-merge kernels K1-K3: CUDA wrappers, launch counts, plain versions.

Port of ``camera_linearity_tpu/ops/hdr_pallas2.py``.  Each Pallas kernel
there becomes a hand-written CUDA kernel, K1 in ``csrc/hdr_merge.cu``, K2
and K3 in ``csrc/hdr_merge_lerp.cu``:

========================  ==========================================
wrapper                   replaces (camera_linearity_tpu/ops/...)
========================  ==========================================
``merge_nhwc_fused``      K1 ``hdr_pallas2.merge_planar_fused``
``merge_nhwc_lerp``       K2 ``hdr_pallas2.merge_planar_lerp``
``merge_nhwc_lerp_bp``    K3 ``hdr_pallas2.merge_planar_lerp_bp``
========================  ==========================================

A wrapper takes ``(N, H, W, C)`` stacks, or ``(B, N, H, W, C)`` batches
for K1 and K2, and returns ``(H, W, C)`` (or ``(B, H, W, C)``) value and
std.  On a CUDA tensor it launches its kernel on the current stream and
adds one to its ``launches`` count, or raises; on a CPU tensor it runs its
plain PyTorch version (``merge_fused_plain``, ``merge_lerp_plain``,
``merge_lerp_bp_plain``), which the tests hold against the JAX kernels and
the kernels are held against on the card.  Importing this module builds
nothing: the libraries are compiled on the first launch (``csrc.library``).

K1 walks the stack in quads of 4 elements a thread (half quads past 8
exposures), or element by element where the quads cannot go:
:func:`plan_fused` picks the route and the instance by exposure count and
lays out its tables' shared memory.  K2 and K3 stage tiles of every
exposure in shared memory.  :func:`plan_lerp_tiles` picks the tile and
lays out the shared memory of a launch, and :func:`tma_route` picks how
the tiles are loaded: by TMA where the stack's base and row pitch allow
it, else by the block's threads.  The planners are
pure Python; each passes its plan to the C launch function as an int array.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .filters import bad_pixel_filter_stack
from .linearize import dn_indices, lut_lookup
from .uncertainty import gaussian_weight

Tensor = torch.Tensor
ValStd = Tuple[Tensor, Optional[Tensor]]

__all__ = ["merge_nhwc_fused", "merge_nhwc_lerp", "merge_nhwc_lerp_bp",
           "merge_fused_plain", "fused_plain_invt", "merge_lerp_plain",
           "merge_lerp_bp_plain", "is_piecewise_linear_256", "KERNELS",
           "FusedPlan", "plan_fused", "fused_launch_plan", "MAXN",
           "TilePlan", "plan_lerp_tiles", "tma_route"]

# shared memory a block may take on Hopper (227 KB), and what each of two
# blocks on one SM may take (228 KB an SM, 1 KB of it reserved per block)
_MAX_SMEM = 232448
_SMEM_TWO_BLOCKS = (233472 - 2 * 1024) // 2
# exposures a K2/K3 block holds at once: K3 keeps its hot tests as the bits
# of a 32-bit word
MAX_SLOTS = 32
# K1's quad-walk instances: exposures a thread holds in registers
MAXN = (4, 8, 16)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _merge_math(x: Tensor, g: Tensor, fp: Optional[Tensor],
                std: Optional[Tensor], inv_t: Tensor,
                compat: str) -> ValStd:
    """The merge on normalized values ``x`` and looked-up ICRF ``g`` (and
    derivative ``fp``), all (..., N, H, W, C), with reciprocal exposure
    times ``inv_t`` (N,), in the kernels' arithmetic: reciprocal sum of
    weights, accumulation over the exposure axis
    (exposure_series.py:317-397)."""
    w, dw = gaussian_weight(x)
    inv_sw = 1.0 / w.sum(dim=-4)
    inv_t = inv_t.reshape(-1, 1, 1, 1)
    val = (w * g * inv_t).sum(dim=-4) * inv_sw
    if std is None:
        return val, None
    inv_sw = inv_sw.unsqueeze(-4)
    dg = fp * std
    bracket = (dw * g + w * dg) * inv_sw - (dw * w * g) * (inv_sw * inv_sw)
    term = bracket * (dg if compat == "reference" else std) * inv_t
    return val, torch.sqrt((term * term).sum(dim=-4))


def _x_and_idx(val: Tensor, max_dn: int, dtype: torch.dtype
               ) -> Tuple[Tensor, Tensor]:
    """Normalized value and table index of a float [0,1] or integer-DN
    stack (hdr_pallas2.py:160-168; integer DNs clamp to the table)."""
    if val.is_floating_point():
        x = val.to(dtype)
        return x, dn_indices(x, max_dn)
    dn = val.long()
    return dn.to(dtype) * (1.0 / max_dn), dn.clamp(0, max_dn)


def _float_type(val: Tensor, table: Tensor) -> torch.dtype:
    return val.dtype if val.is_floating_point() else table.dtype


def _reciprocal(exposures: Tensor, like: Tensor, dtype: torch.dtype
                ) -> Tensor:
    """1 / t in ``dtype``, on the device of ``like``."""
    return 1.0 / exposures.to(device=like.device, dtype=dtype)


def merge_fused_plain(stack_val: Tensor, stack_std: Optional[Tensor],
                      exposures: Tensor, icrf: Tensor, icrf_diff: Tensor,
                      compat: str = "corrected") -> ValStd:
    """K1's math in PyTorch: exact per-channel lookup in (bits, C) tables."""
    inv_t = _reciprocal(exposures, stack_val, _float_type(stack_val, icrf))
    return fused_plain_invt(stack_val, stack_std, inv_t, icrf, icrf_diff,
                            compat)


def fused_plain_invt(stack_val: Tensor, stack_std: Optional[Tensor],
                     inv_t: Tensor, icrf: Tensor, icrf_diff: Tensor,
                     compat: str = "corrected") -> ValStd:
    """:func:`merge_fused_plain` given the reciprocal exposure times
    ``inv_t`` (N,) in place of the exposure times."""
    dtype = _float_type(stack_val, icrf)
    x, idx = _x_and_idx(stack_val, icrf.shape[0] - 1, dtype)
    g = lut_lookup(idx, icrf).to(dtype)
    fp = None if stack_std is None else lut_lookup(idx, icrf_diff).to(dtype)
    inv_t = inv_t.to(device=x.device, dtype=dtype)
    return _merge_math(x, g, fp, stack_std, inv_t, compat)


def _lerp_lookup(idx: Tensor, base: Tensor, bits: int,
                 dtype: torch.dtype) -> Tensor:
    """Interpolant of a (256, C) base curve at DN ``idx`` of a ``bits``
    table: pos = idx * 255/max_dn, j = min(floor(pos), 254),
    g = b[j] + (pos - j)(b[j+1] - b[j])  (hdr_pallas2.py:374-378, 416)."""
    pos = idx.to(dtype) * (255.0 / (bits - 1))
    j = pos.long().clamp(max=254)
    frac = pos - j.to(dtype)
    b = base.to(dtype)
    b0, b1 = lut_lookup(j, b), lut_lookup(j + 1, b)
    return b0 + frac * (b1 - b0)


def merge_lerp_plain(stack_val: Tensor, stack_std: Optional[Tensor],
                     exposures: Tensor, icrf_base: Tensor,
                     icrf_diff_base: Optional[Tensor], bits: int,
                     compat: str = "corrected") -> ValStd:
    """K2's math in PyTorch: the ICRF of a ``bits``-entry table as the
    piecewise-linear interpolant of 256-point base curves."""
    _check_base(icrf_base, icrf_diff_base, stack_std)
    dtype = _float_type(stack_val, icrf_base)
    x, idx = _x_and_idx(stack_val, bits - 1, dtype)
    g = _lerp_lookup(idx, icrf_base, bits, dtype)
    fp = None if stack_std is None else \
        _lerp_lookup(idx, icrf_diff_base, bits, dtype)
    return _merge_math(x, g, fp, stack_std,
                       _reciprocal(exposures, x, dtype), compat)


def merge_lerp_bp_plain(stack_val: Tensor, stack_std: Optional[Tensor],
                        dark: Tensor, exposures: Tensor, icrf_base: Tensor,
                        icrf_diff_base: Optional[Tensor], threshold,
                        bits: int, compat: str = "corrected") -> ValStd:
    """K3's math in PyTorch: per exposure, the 3x3 median repair of the
    pixels that ``dark`` flags hot (``filters.bad_pixel_filter_stack``; an
    integer ``dark`` is a hot-pixel mask), then :func:`merge_lerp_plain`."""
    val, std = bad_pixel_filter_stack(stack_val, stack_std, dark, threshold)
    return merge_lerp_plain(val, std, exposures, icrf_base, icrf_diff_base,
                            bits, compat)


def _check_base(icrf_base: Tensor, icrf_diff_base: Optional[Tensor],
                stack_std: Optional[Tensor]) -> None:
    if icrf_base.shape[0] != 256:
        raise ValueError("lerp base curves must be 256-point, got "
                         f"{tuple(icrf_base.shape)}")
    if stack_std is not None and icrf_diff_base is None:
        raise ValueError("std merge needs icrf_diff_base")


def is_piecewise_linear_256(icrf, tol: float = 1e-3) -> bool:
    """Whether a (bits, C) table is well-approximated by the piecewise-
    linear interpolant of its own 256-point subsample (host check on a
    small array; hdr_pallas2.py:89-114).

    True for the reference's >8-bit ICRFs (np.interp expansions of 256
    solved datapoints, modules/ICRF_calibration_exposure.py:204-216) and for
    any smooth response curve; false for tables with genuine sub-cell
    structure.  The recovered grid is offset from the expansion's own
    breakpoints, so reconstruction error is O(curvature/256^2), not zero:
    exact-parity callers pass the true base curves instead."""
    if isinstance(icrf, Tensor):
        icrf = icrf.cpu().numpy()
    tab = np.asarray(icrf, np.float64)
    bits = tab.shape[0]
    if bits <= 256:
        return False
    x = np.arange(bits) / (bits - 1)
    xb = np.arange(256) / 255.0
    for ch in range(tab.shape[1]):
        base = np.interp(xb, x, tab[:, ch])
        recon = np.interp(x, xb, base)
        if np.max(np.abs(recon - tab[:, ch])) > tol:
            return False
    return True


# ---------------------------------------------------------------------------
# K1 launch plan
# ---------------------------------------------------------------------------

class FusedPlan(NamedTuple):
    """One K1 launch, in the field order of the C struct ``FusedPlan`` of
    ``csrc/hdr_merge.cu``; offsets and sizes in bytes."""
    quad: int        # 1: the quad walk, 0: the scalar route
    maxn: int        # the quad walk's instance (one of MAXN), 0: scalar
    threads: int     # a block
    pairs: int       # 1: (f, f') table pairs (a merge with std), 0: f alone
    off_invt: int    # the N reciprocal exposure times, after the tables
    smem: int        # the launch's dynamic shared memory

    @property
    def route(self) -> str:
        return f"quad/{self.maxn}" if self.quad else "scalar"


def plan_fused(n: int, c: int, rows: int, val_size: int, use_std: bool,
               addrs: Tuple[int, Optional[int]], plane: int) -> FusedPlan:
    """The route, instance and shared-memory layout of a K1 launch over
    ``n`` exposures of ``plane`` (H*W*C) elements of ``c`` channels, whose
    values take ``val_size`` bytes, with ``rows``-entry tables;
    ``addrs`` holds the value and std stacks' base addresses (None for no
    std).

    The quad walk takes a quad of 4 elements a thread (half a quad in the
    16-instance) with one load a plane: it needs a plane of a multiple of
    4 elements, a value base aligned to a quad's load (16 bytes, 4 for u8),
    a 16-byte aligned std base and ``n`` at most the largest instance, and
    takes the smallest instance that holds ``n``.
    Anything else takes the scalar route.  The tables lie channel-major,
    as (f, f') pairs with std, then the reciprocal exposure times.  Raises
    ValueError when they do not fit a block's shared memory."""
    off_invt = _align(rows * c * (8 if use_std else 4), 16)
    smem = off_invt + 4 * n
    if smem > _MAX_SMEM:
        raise ValueError(f"K1's tables need {smem} bytes of shared memory, "
                         f"a block has {_MAX_SMEM}")
    val_addr, std_addr = addrs
    aligned = val_addr % (4 * val_size) == 0 and \
        (std_addr is None or std_addr % 16 == 0)
    maxn = next((m for m in MAXN if n <= m), 0)
    quad = plane % 4 == 0 and aligned and maxn > 0
    return FusedPlan(int(quad), maxn if quad else 0, 256, int(use_std),
                     off_invt, smem)


def fused_launch_plan(stack_val: Tensor, stack_std: Optional[Tensor],
                      rows: int) -> FusedPlan:
    """:func:`plan_fused` of a K1 launch on these stacks with ``rows``-entry
    tables: the plan :func:`merge_nhwc_fused` launches with."""
    n, h, w, c = stack_val.shape[-4:]
    return plan_fused(n, c, rows, stack_val.element_size(),
                      stack_std is not None,
                      (stack_val.data_ptr(), _ptr(stack_std)), h * w * c)


# ---------------------------------------------------------------------------
# K2 / K3 tile plan
# ---------------------------------------------------------------------------

class TilePlan(NamedTuple):
    """One K2/K3 launch's tiling, in the field order of the C struct
    ``TilePlan`` of ``csrc/hdr_merge_lerp.cu``; offsets and sizes in bytes.
    A block owns ``th`` rows x ``twe`` elements of the (H, W*C) output, one
    thread for each 4 of them, and holds ``slots`` exposures' tiles at once
    (every exposure when ``slots`` is N)."""
    th: int          # output tile rows
    twe: int         # output tile elements per row (a multiple of 16)
    pad: int         # K3: halo columns on each side, C rounded up to 4
    slots: int       # exposures held at once
    tma: int         # 1: the TMA route, 0: the copy route
    rows: int        # value / std tile rows: th + 2 halo rows for K3
    stride: int      # value / std tile row pitch, elements: twe + 2 pad
    off_std: int     # std tile within a slot
    off_dark: int    # K3's dark tile (th x twe) within a slot
    slot_bytes: int
    off_bar: int     # the slots' mbarriers, after the tables
    off_slots: int   # slot 0
    smem: int        # the launch's dynamic shared memory
    tx_bytes: int    # bytes TMA writes into a slot

    @property
    def threads(self) -> int:
        return self.th * self.twe // 4


def _align(n: int, to: int = 128) -> int:
    return -(-n // to) * to


def _layout(th: int, twe: int, pad: int, halo: int, slots: int, c: int,
            val_size: int, use_std: bool, dark_size: int) -> TilePlan:
    rows, stride = th + 2 * halo, twe + 2 * pad
    val_b = rows * stride * val_size
    std_b = rows * stride * 4 if use_std else 0
    dark_b = th * twe * dark_size
    off_std = _align(val_b)
    off_dark = off_std + _align(std_b)
    slot_bytes = off_dark + _align(dark_b)
    off_bar = _align(256 * c * 8)  # the (f, f') table pairs come first
    off_slots = off_bar + _align(8 * slots)
    # 128 more: the kernel aligns its base to 128 bytes for TMA
    smem = off_slots + slots * slot_bytes + 128
    return TilePlan(th, twe, pad, slots, 0, rows, stride, off_std, off_dark,
                    slot_bytes, off_bar, off_slots, smem,
                    val_b + std_b + dark_b)


def plan_lerp_tiles(n: int, c: int, val_size: int, use_std: bool,
                    dark_size: int = 0) -> TilePlan:
    """The tile and shared-memory layout of a K2 (``dark_size`` 0) or K3
    (``dark_size`` 4 for f32 darks, 1 for a u8 mask) launch over ``n``
    exposures of ``c`` channels whose values take ``val_size`` bytes.

    The largest tile whose ``n`` exposures fit two blocks on an SM: K2
    rows of 256 elements (1 KB of f32, 4 to 1 rows), K3 rows of 64 elements
    with a one-pixel halo around them (16 to 2 rows).  Beyond that, the
    largest tile with as many exposures as one block holds (at most
    ``MAX_SLOTS``): the exposures then stream through the slots, and pass 2
    loads them again.  Raises ValueError when not even one exposure fits."""
    k3 = dark_size > 0
    twe, heights = (64, (16, 8, 4, 2)) if k3 else (256, (4, 2, 1))
    pad, halo = (-(-c // 4) * 4, 1) if k3 else (0, 0)

    def layout(th, slots):
        return _layout(th, twe, pad, halo, slots, c, val_size, use_std,
                       dark_size)
    if n <= MAX_SLOTS:
        for th in heights:
            plan = layout(th, n)
            if plan.smem <= _SMEM_TWO_BLOCKS:
                return plan
    for slots in range(min(n, MAX_SLOTS), 0, -1):
        plan = layout(heights[0], slots)
        if plan.smem <= _MAX_SMEM:
            return plan
    raise ValueError(f"no K{3 if k3 else 2} tile of {c} channels fits the "
                     f"{_MAX_SMEM} bytes of shared memory a block has")


def tma_route(plan: TilePlan, wc: int, val: Tuple[int, int],
              std: Optional[Tuple[int, int]] = None,
              dark: Optional[Tuple[int, int]] = None) -> bool:
    """Whether TMA can load the tiles of ``plan`` from stacks whose rows
    hold ``wc`` elements; ``val``, ``std`` and ``dark`` give each staged
    stack's (base address, element size).  TMA needs 16-byte aligned bases
    and row pitches, and boxes at most 256 elements wide and tall whose
    rows are a multiple of 16 bytes: ``stride`` elements for the value and
    std tiles, ``twe`` for the dark tile.  The 16-byte output stores of
    that route follow from the value stack's alignment."""
    if max(plan.stride, plan.rows) > 256:
        return False
    staged = [(val, plan.stride), (std, plan.stride), (dark, plan.twe)]
    return all(ptr % 16 == 0 and (wc * size) % 16 == 0
               and (box * size) % 16 == 0
               for arr, box in staged if arr is not None
               for ptr, size in [arr])


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------

_VAL_KIND = {torch.float32: 0, torch.uint8: 1, torch.int32: 2}


def _on_cpu(t: Tensor) -> bool:
    if t.device.type == "cuda":
        return False
    if t.device.type == "cpu":
        return True
    raise ValueError(f"no merge kernel for device {t.device}")


def _ptr(t: Optional[Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _check_stack(name: str, t: Tensor, device: torch.device,
                 dtypes: Tuple[torch.dtype, ...], shape=None) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, the stack on {device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} must be one of {dtypes}, got {t.dtype}")
    if shape is not None and t.shape != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _tables(device: torch.device, channels: int, rows: int,
            *tabs: Optional[Tensor]):
    """f32 contiguous copies of the (rows, C) tables, checked."""
    out = []
    for t in tabs:
        if t is None:
            out.append(None)
            continue
        if t.device != device:
            raise ValueError(f"table is on {t.device}, the stack on {device}")
        if tuple(t.shape) != (rows, channels):
            raise ValueError(f"table has shape {tuple(t.shape)}, expected "
                             f"({rows}, {channels})")
        out.append(t.to(torch.float32).contiguous())
    return out


def _launch_args(stack_val: Tensor, stack_std: Optional[Tensor],
                 exposures: Tensor):
    """Checked batch geometry, reciprocal exposure times and outputs."""
    if stack_val.ndim not in (4, 5):
        raise ValueError("stack must be (N, H, W, C) or (B, N, H, W, C), "
                         f"got {tuple(stack_val.shape)}")
    device = stack_val.device
    batched = stack_val.ndim == 5
    b = stack_val.shape[0] if batched else 1
    n, h, w, c = stack_val.shape[-4:]
    if n == 0:
        raise ValueError("empty exposure stack")
    if exposures.shape != (n,):
        raise ValueError(f"exposures has shape {tuple(exposures.shape)}, "
                         f"expected ({n},)")
    if stack_std is not None:
        _check_stack("stack_std", stack_std, device, (torch.float32,),
                     stack_val.shape)
    # 1/t in f32, as hdr_pallas2.py:496
    inv_t = (1.0 / exposures.to(device=device, dtype=torch.float32)
             ).contiguous()
    out_shape = (b, h, w, c) if batched else (h, w, c)
    out_v = torch.empty(out_shape, dtype=torch.float32, device=device)
    out_s = None if stack_std is None else torch.empty_like(out_v)
    return b, n, h, w, c, inv_t, out_v, out_s


def _addr(t: Optional[Tensor]) -> Optional[Tuple[int, int]]:
    return None if t is None else (t.data_ptr(), t.element_size())


def _lerp_plan(stack_val: Tensor, stack_std: Optional[Tensor],
               dark: Optional[Tensor], b: int, n: int, h: int, w: int,
               c: int):
    """The checked K2/K3 tile plan with its load route, as the int array
    the C launch functions take."""
    plan = plan_lerp_tiles(n, c, stack_val.element_size(),
                           stack_std is not None,
                           0 if dark is None else dark.element_size())
    # the kernels index rows and planes in 32 bits; grid y and z are 16-bit
    if b * n * h >= 2 ** 31 or h * w * c >= 2 ** 31 or b > 65535 or \
            -(-h // plan.th) > 65535:
        raise ValueError(f"stack {tuple(stack_val.shape)} exceeds the "
                         "merge kernels' 32-bit indexing or grid")
    plan = plan._replace(tma=int(tma_route(plan, w * c, _addr(stack_val),
                                           _addr(stack_std), _addr(dark))))
    return (ctypes.c_int * len(plan))(*plan)


def _raise_on(err: int, kernel: str) -> None:
    if err != 0:
        raise RuntimeError(f"{kernel} launch failed: CUDA error {err}")


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def merge_nhwc_fused(stack_val: Tensor, stack_std: Optional[Tensor],
                     exposures: Tensor, icrf: Tensor, icrf_diff: Tensor,
                     compat: str = "corrected") -> ValStd:
    """K1: exact-lookup merge of an (N, H, W, C) or (B, N, H, W, C) stack
    of f32 [0,1] values or uint8 / int32 DNs with (bits, C) tables."""
    if _on_cpu(stack_val):
        return merge_fused_plain(stack_val, stack_std, exposures, icrf,
                                 icrf_diff, compat)
    from .. import csrc
    _check_stack("stack_val", stack_val, stack_val.device, tuple(_VAL_KIND))
    bits, c = icrf.shape[0], stack_val.shape[-1]
    tab, tab_d = _tables(stack_val.device, c, bits, icrf,
                         None if stack_std is None else icrf_diff)
    b, n, h, w, c, inv_t, out_v, out_s = _launch_args(
        stack_val, stack_std, exposures)
    # the kernel indexes a plane in 32 bits
    if h * w * c >= 2 ** 31 or b >= 2 ** 31:
        raise ValueError(f"stack {tuple(stack_val.shape)} exceeds K1's "
                         "32-bit indexing")
    plan = fused_launch_plan(stack_val, stack_std, bits)
    err = csrc.library("hdr_merge").cl_merge_fused(
        stack_val.data_ptr(), _VAL_KIND[stack_val.dtype], _ptr(stack_std),
        tab.data_ptr(), _ptr(tab_d), bits, inv_t.data_ptr(), b, n, h, w, c,
        int(compat == "reference"), ctypes.c_float(1.0 / (bits - 1)),
        out_v.data_ptr(), _ptr(out_s), _stream(),
        (ctypes.c_int * len(plan))(*plan))
    _raise_on(err, "merge_nhwc_fused")
    merge_nhwc_fused.launches += 1
    return out_v, out_s


def merge_nhwc_lerp(stack_val: Tensor, stack_std: Optional[Tensor],
                    exposures: Tensor, icrf_base: Tensor,
                    icrf_diff_base: Optional[Tensor], bits: int,
                    compat: str = "corrected") -> ValStd:
    """K2: merge through 256-point base curves of a ``bits``-entry ICRF, on
    an (N, H, W, C) or (B, N, H, W, C) stack (f32 or uint8 / int32 DNs)."""
    if _on_cpu(stack_val):
        return merge_lerp_plain(stack_val, stack_std, exposures, icrf_base,
                                icrf_diff_base, bits, compat)
    from .. import csrc
    _check_base(icrf_base, icrf_diff_base, stack_std)
    _check_stack("stack_val", stack_val, stack_val.device, tuple(_VAL_KIND))
    tab, tab_d = _tables(stack_val.device, stack_val.shape[-1], 256,
                         icrf_base, None if stack_std is None
                         else icrf_diff_base)
    b, n, h, w, c, inv_t, out_v, out_s = _launch_args(
        stack_val, stack_std, exposures)
    plan = _lerp_plan(stack_val, stack_std, None, b, n, h, w, c)
    err = csrc.library("hdr_merge_lerp").cl_merge_lerp(
        stack_val.data_ptr(), _VAL_KIND[stack_val.dtype], _ptr(stack_std),
        tab.data_ptr(), _ptr(tab_d), bits, inv_t.data_ptr(), b, n, h, w, c,
        int(compat == "reference"), ctypes.c_float(1.0 / (bits - 1)),
        ctypes.c_float(255.0 / (bits - 1)), out_v.data_ptr(), _ptr(out_s),
        _stream(), plan)
    _raise_on(err, "merge_nhwc_lerp")
    merge_nhwc_lerp.launches += 1
    return out_v, out_s


def merge_nhwc_lerp_bp(stack_val: Tensor, stack_std: Optional[Tensor],
                       dark: Tensor, exposures: Tensor, icrf_base: Tensor,
                       icrf_diff_base: Optional[Tensor], threshold,
                       bits: int, compat: str = "corrected") -> ValStd:
    """K3: :func:`merge_nhwc_lerp` with the 3x3 median repair of hot pixels
    as prologue, on an f32 (N, H, W, C) stack.  ``dark`` is (N, H, W, C):
    f32 dark frames (hot where above ``threshold``; all-zero planes for
    exposures without a dark) or a uint8 hot-pixel mask."""
    if _on_cpu(stack_val):
        return merge_lerp_bp_plain(stack_val, stack_std, dark, exposures,
                                   icrf_base, icrf_diff_base, threshold,
                                   bits, compat)
    from .. import csrc
    _check_base(icrf_base, icrf_diff_base, stack_std)
    if stack_val.ndim != 4:
        raise ValueError("stack must be (N, H, W, C), got "
                         f"{tuple(stack_val.shape)}")
    device = stack_val.device
    _check_stack("stack_val", stack_val, device, (torch.float32,))
    _check_stack("dark", dark, device, (torch.float32, torch.uint8),
                 stack_val.shape)
    tab, tab_d = _tables(device, stack_val.shape[-1], 256, icrf_base,
                         None if stack_std is None else icrf_diff_base)
    _, n, h, w, c, inv_t, out_v, out_s = _launch_args(
        stack_val, stack_std, exposures)
    plan = _lerp_plan(stack_val, stack_std, dark, 1, n, h, w, c)
    err = csrc.library("hdr_merge_lerp").cl_merge_lerp_bp(
        stack_val.data_ptr(), _ptr(stack_std), dark.data_ptr(),
        int(dark.dtype == torch.uint8), ctypes.c_float(float(threshold)),
        tab.data_ptr(), _ptr(tab_d), bits, inv_t.data_ptr(), n, h, w, c,
        int(compat == "reference"), ctypes.c_float(255.0 / (bits - 1)),
        out_v.data_ptr(), _ptr(out_s), _stream(), plan)
    _raise_on(err, "merge_nhwc_lerp_bp")
    merge_nhwc_lerp_bp.launches += 1
    return out_v, out_s


merge_nhwc_fused.launches = 0
merge_nhwc_lerp.launches = 0
merge_nhwc_lerp_bp.launches = 0

# every kernel wrapper, for callers that reset or read the launch counts
KERNELS = (merge_nhwc_fused, merge_nhwc_lerp, merge_nhwc_lerp_bp)
