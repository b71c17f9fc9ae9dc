"""The ablation kernels of the config-2 kernel experiments (E1-E5): CUDA
wrappers, launch counts, plain versions.

Port of the Pallas functions of ``benchmarks/exp_kernel.py`` and
``benchmarks/exp_plateau.py``.  They compute two functions, each a
hand-written CUDA kernel in ``csrc/exp_ablation.cu``:

=================  ====================================================
wrapper            replaces (benchmarks/...)
=================  ====================================================
``exposure_sum``   E1 ``exp_kernel.ab_dma`` (cfirst), E4
                   ``exp_kernel.make_flat_dma`` with ``extra`` None,
                   ``mod``, ``round``, ``exp`` (flat), E5
                   ``exp_plateau.make_dma`` (planar)
``merge_nolut``    E2 ``exp_kernel.ab_math`` (cfirst), E3
                   ``exp_kernel.make_flat_invt`` (flat, given 1/t), E4
                   ``make_flat_dma(extra="math")`` (flat, 1/t = 1)
=================  ====================================================

``exposure_sum`` sums the value and the std stacks over the exposure axis
(in exposure order), with E4's extra term on the value; ``merge_nolut`` is
the HDR merge with the ICRF ``g = x`` and ``f' = 1``: K1 without its table
lookup.  The operands keep the JAX functions' layouts, and so do the
results:

==========  ====================  ==========
layout      stacks                result
==========  ====================  ==========
cfirst      (C, N, 1, P)          (C, 1, P)
flat        (N, L)                (1, L)
planar      (N, C, H, W)          (C, H, W)
==========  ====================  ==========

A wrapper checks its operands on every device: f32, contiguous, the
layout's shape, 1 to :data:`MAX_N` exposures.  On a CUDA tensor it then
launches its kernel on the current stream and adds one to the launch count
of the experiment it stands for (``KERNELS["E1"].launches`` ...), or
raises; on a CPU tensor it runs its plain PyTorch version
(``exposure_sum_plain``, ``merge_nolut_plain``).  ``exposure_sum``'s
``threads`` (threads per block) and ``vec`` (16-byte quads per thread and
step) set its launch, the Hopper counterpart of E5's row-block and
``dimension_semantics`` sweep; the merge always launches 256 x 1.
Importing this module builds nothing.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple, Union

import torch

from .hdr_cuda import _raise_on, _stream
from .uncertainty import gaussian_weight

Tensor = torch.Tensor
Invt = Optional[Union[Tensor, Sequence[float]]]

__all__ = ["exposure_sum", "merge_nolut", "exposure_sum_plain",
           "merge_nolut_plain", "KERNELS", "LAYOUTS", "MODES", "THREADS",
           "VECS", "MAX_N"]

LAYOUTS = ("cfirst", "flat", "planar")
MODES = ("none", "mod", "round", "exp")  # the C enum's order
THREADS = (128, 256, 512)
VECS = (1, 2, 4)
MAX_N = 16  # exposures a thread holds in registers


@dataclass
class Experiment:
    """One Pallas function of the experiments and its launches here."""
    wrapper: str
    replaces: str  # file:line of the Pallas function
    launches: int = 0


KERNELS = {
    "E1": Experiment("exposure_sum", "benchmarks/exp_kernel.py:65"),
    "E2": Experiment("merge_nolut", "benchmarks/exp_kernel.py:99"),
    "E3": Experiment("merge_nolut", "benchmarks/exp_kernel.py:122"),
    "E4": Experiment("exposure_sum, merge_nolut",
                     "benchmarks/exp_kernel.py:173"),
    "E5": Experiment("exposure_sum", "benchmarks/exp_plateau.py:83"),
}
_SUM_EXPERIMENT = {"cfirst": "E1", "flat": "E4", "planar": "E5"}


def _geometry(shape, layout: str) -> Tuple[int, int, int, tuple]:
    """(outer, N, inner) of a stack in ``layout``, and its result's shape."""
    if layout == "cfirst" and len(shape) == 4 and shape[2] == 1:
        c, n, _, p = shape
        return c, n, p, (c, 1, p)
    if layout == "flat" and len(shape) == 2:
        n, length = shape
        return 1, n, length, (1, length)
    if layout == "planar" and len(shape) == 4:
        n, c, h, w = shape
        return 1, n, c * h * w, (c, h, w)
    if layout not in LAYOUTS:
        raise ValueError(f"layout must be one of {LAYOUTS}, got {layout!r}")
    raise ValueError(f"a {layout} stack cannot have shape {tuple(shape)}")


def _checked(val: Tensor, std: Tensor, layout: str
             ) -> Tuple[int, int, int, tuple]:
    for name, t in (("val", val), ("std", std)):
        if t.device.type not in ("cpu", "cuda"):
            raise ValueError(f"no ablation kernel for device {t.device}")
        if t.device != val.device:
            raise ValueError(f"{name} is on {t.device}, val on {val.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.shape != val.shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, val "
                             f"{tuple(val.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    outer, n, inner, out_shape = _geometry(val.shape, layout)
    if not 1 <= n <= MAX_N:
        raise ValueError(f"{n} exposures: the kernels take 1 to {MAX_N}")
    return outer, n, inner, out_shape


def _invt_values(invt: Invt, n: int) -> list:
    """The N reciprocal exposure times as host floats (ones for None);
    a CUDA tensor here costs a synchronization."""
    if invt is None:
        return [1.0] * n
    values = torch.as_tensor(invt, dtype=torch.float32).reshape(-1)
    if values.numel() != n:
        raise ValueError(f"invt has {values.numel()} values for {n} "
                         "exposures")
    return values.cpu().tolist()


def _in_order(x: Tensor) -> Tensor:
    """x (outer, N, inner) summed over N in exposure order, as the kernel
    adds."""
    acc = x[:, 0]
    for n in range(1, x.shape[1]):
        acc = acc + x[:, n]
    return acc


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def exposure_sum_plain(val: Tensor, std: Tensor, layout: str,
                       mode: str = "none") -> Tuple[Tensor, Tensor]:
    """``exposure_sum``'s function in PyTorch: the exposure sums of value
    and std, with E4's extra term on the value (exp_kernel.py:196-212)."""
    outer, n, inner, out_shape = _geometry(val.shape, layout)
    x = val.reshape(outer, n, inner)
    out_v = _in_order(x)
    if mode == "mod":
        pos = torch.arange(inner, device=val.device)
        out_v = out_v + (pos % 3).to(val.dtype)
    elif mode == "round":
        idx = torch.round(x * 255.0).to(torch.int32).clamp(0, 255)
        out_v = out_v + idx.sum(dim=1, dtype=torch.int32).to(val.dtype)
    elif mode == "exp":
        out_v = out_v + _in_order(gaussian_weight(x)[0])
    elif mode != "none":
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    out_s = _in_order(std.reshape(outer, n, inner))
    return out_v.reshape(out_shape), out_s.reshape(out_shape)


def merge_nolut_plain(val: Tensor, std: Tensor, invt: Invt,
                      layout: str) -> Tuple[Tensor, Tensor]:
    """``merge_nolut``'s function in PyTorch: the merge of
    exp_kernel.py:79-95 (g = x, dg = s) with reciprocal exposure times
    ``invt`` (N values; None is all ones, E4's ``math``)."""
    outer, n, inner, out_shape = _geometry(val.shape, layout)
    x = val.reshape(outer, n, inner)
    s = std.reshape(outer, n, inner)
    it = torch.as_tensor(_invt_values(invt, n), dtype=val.dtype,
                         device=val.device).reshape(1, n, 1)
    w, dw = gaussian_weight(x)
    inv_sw = 1.0 / w.sum(dim=1, keepdim=True)
    out_v = (w * x * it).sum(dim=1, keepdim=True) * inv_sw
    bracket = (dw * x + w * s) * inv_sw - (dw * w * x) * (inv_sw * inv_sw)
    term = bracket * s * it
    out_s = torch.sqrt((term * term).sum(dim=1))
    return out_v.reshape(out_shape), out_s.reshape(out_shape)


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------

def exposure_sum(val: Tensor, std: Tensor, layout: str, mode: str = "none",
                 threads: int = 256, vec: int = 1) -> Tuple[Tensor, Tensor]:
    """E1 (cfirst), E4 (flat) or E5 (planar): the sums of ``val`` and
    ``std`` over the exposure axis; ``mode`` adds E4's extra term (``mod``,
    ``round`` or ``exp``) to the value."""
    outer, n, inner, out_shape = _checked(val, std, layout)
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    if threads not in THREADS or vec not in VECS:
        raise ValueError(f"launch ({threads} threads, {vec} quads a "
                         f"thread) is not one of {THREADS} x {VECS}")
    if val.device.type == "cpu":
        return exposure_sum_plain(val, std, layout, mode)
    from .. import csrc
    out_v = torch.empty(out_shape, dtype=torch.float32, device=val.device)
    out_s = torch.empty_like(out_v)
    err = csrc.library("exp_ablation").cl_exposure_sum(
        val.data_ptr(), std.data_ptr(), out_v.data_ptr(), out_s.data_ptr(),
        outer, n, inner, MODES.index(mode), threads, vec, _stream())
    _raise_on(err, "exposure_sum")
    KERNELS[_SUM_EXPERIMENT[layout]].launches += 1
    return out_v, out_s


def merge_nolut(val: Tensor, std: Tensor, invt: Invt, layout: str,
                dead: bool = False) -> Tuple[Tensor, Tensor]:
    """E2 (cfirst), E3 (flat, ``invt`` given) or E4's ``math`` (flat,
    ``invt`` None): the merge without a table lookup.  ``invt`` holds the
    N reciprocal exposure times, passed to the kernel by value (a host
    tensor or sequence spares a synchronization); ``dead`` computes E3's
    unused index."""
    outer, n, inner, out_shape = _checked(val, std, layout)
    if layout == "planar":
        raise ValueError("no experiment merges the planar layout")
    values = _invt_values(invt, n)
    if val.device.type == "cpu":
        return merge_nolut_plain(val, std, values, layout)
    from .. import csrc
    out_v = torch.empty(out_shape, dtype=torch.float32, device=val.device)
    out_s = torch.empty_like(out_v)
    err = csrc.library("exp_ablation").cl_merge_nolut(
        val.data_ptr(), std.data_ptr(), (ctypes.c_float * n)(*values),
        out_v.data_ptr(), out_s.data_ptr(), outer, n, inner, int(dead),
        _stream())
    _raise_on(err, "merge_nolut")
    experiment = "E2" if layout == "cfirst" else \
        "E4" if invt is None else "E3"
    KERNELS[experiment].launches += 1
    return out_v, out_s
