"""Shared numeric utilities (reference: modules/general_functions.py).

Port of ``camera_linearity_tpu/utils/general.py``.
"""
from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..config import CameraConfig
from ..ops.linearize import _interp

Tensor = torch.Tensor

__all__ = ["is_broadcastable", "choose_evenly_spaced_points",
           "predict_output_shape",
           "map_linearity_limits", "interpolate_data", "set_thread_priority",
           "stage_to_device", "stage_to_device_async", "transfer_stream"]


def set_thread_priority(nice: int) -> bool:
    """Set the CALLING thread's scheduling niceness (Linux: nice values are
    per-task, and ``who=0`` addresses the current thread).

    The video pipeline's host work is a CPU budget split between decode,
    statistics and transfer threads; decode, its critical path, runs
    boosted.  Negative niceness needs privilege; returns False (no-op)
    where unsupported.
    """
    try:
        os.setpriority(os.PRIO_PROCESS, 0, nice)
        return True
    except (AttributeError, OSError):
        return False


# one transfer stream per CUDA device, made on first use
_TRANSFER_STREAMS: Dict[torch.device, "torch.cuda.Stream"] = {}


def transfer_stream(device) -> "torch.cuda.Stream":
    """The dedicated host-to-device transfer stream of a CUDA ``device``."""
    device = torch.device(device)
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if device not in _TRANSFER_STREAMS:
        _TRANSFER_STREAMS[device] = torch.cuda.Stream(device)
    return _TRANSFER_STREAMS[device]


def stage_to_device(arr: np.ndarray, max_bytes: int = 128 << 20, *,
                    device=None) -> Tensor:
    """A copy of a host array on ``device`` (the current CUDA device by
    default), shipped in slices of at most ``max_bytes`` along axis 0
    (whole where it is smaller or has one row).  The JAX package's
    chunked transfer; on the card the copies are synchronous, so ``arr``
    may be overwritten once this returns.  The pipelines' asynchronous
    copy is :func:`stage_to_device_async`."""
    host = torch.from_numpy(np.ascontiguousarray(arr))
    out = torch.empty(host.shape, dtype=host.dtype,
                      device="cuda" if device is None else device)
    if host.ndim == 0 or host.nbytes <= max_bytes or host.shape[0] <= 1:
        return out.copy_(host)
    pieces = min(-(-host.nbytes // max_bytes), host.shape[0])
    for src, dst in zip(torch.tensor_split(host, pieces),
                        torch.tensor_split(out, pieces)):
        dst.copy_(src)
    return out


def stage_to_device_async(arr: np.ndarray, device,
                          out: Optional[Tensor] = None
                          ) -> Tuple[Tensor, Optional["torch.cuda.Event"]]:
    """Copy a host array to ``device``: ``(tensor, event)``.

    On CUDA the copy is ``non_blocking`` on the device's transfer stream
    (:func:`transfer_stream`) and ``event`` is recorded after it: a
    consumer stream waits on the event before it reads the tensor, and the
    host may overwrite ``arr`` only once the event has completed (from
    pinned memory the copy is asynchronous; from pageable memory it has
    read ``arr`` by the time this returns).  ``out`` is a device tensor of
    ``arr``'s shape and dtype to copy into: the caller keeps it alive until
    the event completes and orders its allocation before the copy (the
    transfer stream ``wait_stream``s the allocating one); without it the
    tensor is allocated on the
    transfer stream and marked as used by the current stream, so freeing
    it waits for the consumer's work.  Elsewhere the result is a copy (it
    never aliases ``arr``) and ``event`` is None.
    """
    device = torch.device(device)
    host = torch.from_numpy(np.ascontiguousarray(arr))
    if device.type != "cuda":
        if out is None:
            return host.to(device, copy=True), None
        out.copy_(host)
        return out, None
    consumer = torch.cuda.current_stream(device)
    stream = transfer_stream(device)
    with torch.cuda.stream(stream):
        if out is None:
            out = torch.empty(host.shape, dtype=host.dtype, device=device)
            out.record_stream(consumer)
        out.copy_(host, non_blocking=True)
        event = torch.cuda.Event()
        event.record(stream)
    return out, event


def is_broadcastable(shape1: Tuple[int, ...], shape2: Tuple[int, ...]) -> bool:
    """NumPy broadcast-compatibility test (general_functions.py:14-24)."""
    if not shape1 or not shape2:
        raise ValueError("Shapes cannot be empty")
    for a, b in zip(shape1[::-1], shape2[::-1]):
        if a == 1 or b == 1 or a == b:
            continue
        return False
    return True


def choose_evenly_spaced_points(array, step_x: int,
                                step_y: Optional[int] = None):
    """Stride-subsample the two leading axes (general_functions.py:27-44)."""
    if step_y is None:
        step_y = step_x
    return array[::step_x, ::step_y, ...]


def predict_output_shape(input_shape: Tuple[int, int], step_x: int,
                         step_y: Optional[int] = None) -> Tuple[int, int]:
    """Output shape of choose_evenly_spaced_points
    (general_functions.py:47-67)."""
    if step_y is None:
        step_y = step_x
    rows, cols = input_shape
    return (rows + step_x - 1) // step_x, (cols + step_y - 1) // step_y


def map_linearity_limits(lower_limit: Optional[int],
                         upper_limit: Optional[int], icrf: Optional[Tensor],
                         config: CameraConfig) -> Tuple[Tensor, Tensor]:
    """Map DN-domain inclusion limits into the linear domain via the ICRF
    (general_functions.py:97-129).

    ``lower_limit``/``upper_limit`` are DN distances from the range edges;
    None falls back to the config's linearity limits.  Without an ICRF the
    limits are normalized to [0,1] (float64 CPU tensors); with one they are
    its entries, on its device.
    """
    chs = config.num_of_chs
    lower = np.array([config.lower_linearity_limit if lower_limit is None
                      else lower_limit] * chs, dtype=float)
    upper = np.array([config.upper_linearity_limit if upper_limit is None
                      else config.max_dn - upper_limit] * chs, dtype=float)
    if icrf is None:
        return (torch.as_tensor(lower / config.max_dn),
                torch.as_tensor(upper / config.max_dn))

    icrf = torch.as_tensor(icrf)
    lo_idx = torch.as_tensor(lower.astype(int), device=icrf.device)
    hi_idx = torch.as_tensor(upper.astype(int), device=icrf.device)
    if icrf.ndim == 1:
        return icrf[lo_idx], icrf[hi_idx]
    ch_idx = torch.arange(chs, device=icrf.device)
    return icrf[lo_idx, ch_idx], icrf[hi_idx, ch_idx]


def interpolate_data(clean_data_arr: Tensor, bits: int,
                     datapoints: int) -> Tensor:
    """Row-wise resample of a (rows, bits) table to ``datapoints`` columns
    (general_functions.py:70-94)."""
    if bits == datapoints:
        return clean_data_arr
    kw = dict(dtype=clean_data_arr.dtype, device=clean_data_arr.device)
    x_old = torch.linspace(0.0, 1.0, bits, **kw)
    x_new = torch.linspace(0.0, 1.0, datapoints, **kw)
    return torch.stack([_interp(x_new, x_old, row)
                        for row in clean_data_arr])
