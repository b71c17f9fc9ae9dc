"""HDR exposure-stack merging with uncertainty propagation.

Port of ``camera_linearity_tpu/ops/hdr.py``.  The reference merges with two
Python passes over a list of images (reference:
modules/exposure_series.py:317-397); here the stack is one ``(N, H, W, C)``
tensor, merged over the exposure axis.  Weight/accumulation semantics
(exposure_series.py:382-394):

    w_n, dw_n = gaussian_weight(x_n)         # from the *raw* value image
    g_n, dg_n = linearize(x_n, s_n)          # ICRF LUT + derivative * std
    HDR   = sum_n  w_n g_n / (SW t_n)
    std^2 = sum_n (((dw_n g_n + w_n dg_n)/SW - dw_n w_n g_n/SW^2) * D / t_n)^2

where ``SW = sum_n w_n`` and ``D`` is ``dg_n`` in ``compat='reference'``
mode — replicating exposure_series.py:389 exactly — or the input std ``s_n``
in ``compat='corrected'`` mode (first-order propagation; SURVEY.md §7.7).

Dispatch mirrors the JAX package, with a CUDA tensor where it has the TPU:
a CUDA stack goes to the kernels of :mod:`.hdr_cuda` wherever the JAX
package runs Pallas, and everything else runs plain PyTorch on the
tensor's own device.  ``use_pallas=False`` (the JAX name, in its
position) or ``use_kernel=False`` forces the plain path.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import hdr_cuda
from .filters import bad_pixel_filter_stack, flat_field_correction
from .uncertainty import gaussian_weight

Tensor = torch.Tensor
ValStd = Tuple[Tensor, Optional[Tensor]]

__all__ = ["sum_of_weights", "merge_stack", "merge_stack_u8", "merge_hdr",
           "merge_corrected", "merge_batch"]


def merge_batch(batch_val: Tensor, batch_std: Optional[Tensor],
                exposures: Tensor, icrf: Tensor, icrf_diff: Tensor,
                compat: str = "corrected",
                use_pallas: Optional[bool] = None,
                icrf_base: Optional[Tensor] = None,
                icrf_diff_base: Optional[Tensor] = None, *,
                use_kernel: Optional[bool] = None) -> ValStd:
    """Merge a (B, N, H, W, C) batch of scenes into (B, H, W, C): one
    kernel launch on CUDA (the batch is a leading axis of the kernel's
    grid, where the JAX package vmaps), the batched plain path elsewhere.
    Routing is :func:`merge_hdr`'s."""
    return merge_hdr(batch_val, batch_std, exposures, icrf, icrf_diff,
                     compat, use_pallas, icrf_base, icrf_diff_base,
                     use_kernel=use_kernel)


def sum_of_weights(stack_val: Tensor) -> Tuple[Tensor, Tensor]:
    """Sum of gaussian weights over the exposure axis and its square
    (exposure_series.py:317-345)."""
    w, _ = gaussian_weight(stack_val)
    sw = torch.sum(w, dim=0)
    return sw, sw ** 2


def merge_stack(stack_val: Tensor, stack_std: Optional[Tensor],
                exposures: Tensor, icrf: Tensor, icrf_diff: Tensor,
                compat: str = "corrected",
                row_chunk: Optional[int] = None) -> ValStd:
    """Merge a preprocessed ``(N, H, W, C)`` stack into an HDR radiance map.

    ``stack_val`` holds [0,1] float values (dark/bad-pixel corrections are a
    prologue, see models/exposure_series.py); ``exposures`` is ``(N,)``;
    ``icrf``/``icrf_diff`` are ``(bits, C)``.  Returns ``(hdr_val, hdr_std)``
    with ``hdr_std`` None when ``stack_std`` is None.  Leading batch axes
    before N are merged independently.  This is K1's plain version
    (:func:`.hdr_cuda.merge_fused_plain`).  ``row_chunk`` is taken and
    ignored: in the JAX package it bounds the TPU's radix lookup by
    merging slabs of rows, which the port's lookup does not need.
    """
    return hdr_cuda.merge_fused_plain(stack_val, stack_std, exposures, icrf,
                                      icrf_diff, compat)


def merge_stack_u8(stack_dn: Tensor, stack_std: Optional[Tensor],
                   exposures: Tensor, icrf: Tensor, icrf_diff: Tensor,
                   compat: str = "corrected",
                   row_chunk: Optional[int] = None) -> ValStd:
    """Merge directly from an integer-DN stack (the native 8-bit path):
    ``x = dn/max_dn`` reproduces the reference's 8-bit load normalization
    (image_set.py:223), and ``dn`` is itself the LUT index.  ``row_chunk``
    is ignored, as in :func:`merge_stack`."""
    return hdr_cuda.merge_fused_plain(stack_dn, stack_std, exposures, icrf,
                                      icrf_diff, compat)


def merge_corrected(stack_val: Tensor, stack_std: Optional[Tensor],
                    dark_stack: Tensor, exposures: Tensor, icrf: Tensor,
                    icrf_diff: Tensor, dark_threshold,
                    flat_val: Optional[Tensor] = None,
                    flat_std: Optional[Tensor] = None,
                    mid_percentage: float = 0.05,
                    compat: str = "corrected", kernel_size: int = 3,
                    icrf_base: Optional[Tensor] = None,
                    icrf_diff_base: Optional[Tensor] = None) -> ValStd:
    """Corrections merge: bad-pixel prologue -> merge -> flat epilogue
    (BASELINE config 3; the reference runs the prologue as a per-image
    Python pass, exposure_series.py:371-381, and the epilogue as a separate
    call, :415-417).

    ``dark_stack`` is (N, H, W, C) of per-exposure dark frames — all-zero
    planes for exposures without a matched dark (the repair is then an
    exact no-op, like the reference's skip) — or an integer hot-pixel mask
    (``ops.filters.hot_pixel_mask``).  On CUDA a float stack with a 3x3
    window runs the repair and the merge as one kernel (K3); a 256-entry
    table is its own base curve.
    """
    base, diff_b = icrf_base, icrf_diff_base
    if base is None and icrf.shape[0] == 256:
        base, diff_b = icrf, icrf_diff
    if (base is not None and base.shape[0] == 256 and stack_val.is_cuda
            and kernel_size == 3 and stack_val.is_floating_point()):
        hdr_val, hdr_std = hdr_cuda.merge_nhwc_lerp_bp(
            stack_val, stack_std, dark_stack, exposures, base,
            None if stack_std is None else diff_b, dark_threshold,
            bits=icrf.shape[0], compat=compat)
    else:
        fixed_val, fixed_std = bad_pixel_filter_stack(
            stack_val, stack_std, dark_stack, dark_threshold, kernel_size)
        hdr_val, hdr_std = merge_hdr(fixed_val, fixed_std, exposures, icrf,
                                     icrf_diff, compat=compat,
                                     icrf_base=icrf_base,
                                     icrf_diff_base=icrf_diff_base)
    if flat_val is not None:
        hdr_val, hdr_std = flat_field_correction(hdr_val, hdr_std, flat_val,
                                                 flat_std, mid_percentage)
    return hdr_val, hdr_std


def merge_hdr(stack_val: Tensor, stack_std: Optional[Tensor],
              exposures: Tensor, icrf: Tensor, icrf_diff: Tensor,
              compat: str = "corrected", use_pallas: Optional[bool] = None,
              icrf_base: Optional[Tensor] = None,
              icrf_diff_base: Optional[Tensor] = None, *,
              use_kernel: Optional[bool] = None) -> ValStd:
    """Dispatch to the merge implementation for the stack's device.

    A CUDA stack with 256- or 4096-entry tables runs the exact-lookup
    kernel (K1).  For >8-bit depths, 256-point solved curves passed as
    ``icrf_base``/``icrf_diff_base`` select the piecewise-linear kernel (K2):
    the reference's >8-bit tables are np.interp expansions of 256 solved
    datapoints (ICRF_calibration_exposure.py:204-216, 398-402), so the
    interpolant is the same math.  ``icrf``/``icrf_diff`` still drive the
    plain path (and define ``bits``).  Pass ``use_kernel``, or the JAX
    package's ``use_pallas``, to force either (both, with different values,
    raise).  Leading batch axes before N are merged independently
    (``merge_batch``).
    """
    if use_pallas is not None:
        if use_kernel is not None and use_kernel != use_pallas:
            raise ValueError(f"use_pallas={use_pallas} and use_kernel="
                             f"{use_kernel} disagree")
        use_kernel = use_pallas
    # other datapoints resolutions fall through to the exact paths
    if (icrf_base is not None and icrf_base.shape[0] == 256
            and icrf.shape[0] > 256 and stack_val.is_cuda
            and use_kernel is not False):
        return hdr_cuda.merge_nhwc_lerp(
            stack_val, stack_std, exposures, icrf_base,
            None if stack_std is None else icrf_diff_base,
            bits=icrf.shape[0], compat=compat)
    if use_kernel is None:
        use_kernel = stack_val.is_cuda and icrf.shape[0] in (256, 4096)
    if use_kernel and stack_val.is_cuda:
        return hdr_cuda.merge_nhwc_fused(stack_val, stack_std, exposures,
                                         icrf, icrf_diff, compat=compat)
    return hdr_cuda.merge_fused_plain(stack_val, stack_std, exposures, icrf,
                                      icrf_diff, compat)
