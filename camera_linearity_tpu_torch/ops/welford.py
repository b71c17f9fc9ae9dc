"""Streaming Welford mean/variance over frame batches.

Port of ``camera_linearity_tpu/ops/welford.py``.  The reference updates
mean/M2 one frame at a time in a Python loop (reference:
modules/video_processing.py:161-219); the JAX package runs the same update
as a ``lax.scan`` over device-resident batches, and here it is a loop of
tensor ops over the frames of a batch on the batch's device, in exactly
the reference's operation order:

    delta = x - mean;  mean += delta / n;  m2 += delta * (x - mean)

No hand kernel: XLA fused this scan on the TPU without Pallas, and the
port keeps it as torch ops until the card shows it is a bottleneck.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from .linearize import linearize

Tensor = torch.Tensor

__all__ = ["WelfordState", "welford_init", "welford_update",
           "welford_update_batch", "welford_update_batch_lut",
           "welford_finalize"]


@dataclass(frozen=True)
class WelfordState:
    count: Tensor  # () int64 - frames consumed
    mean: Tensor   # (H, W, C)
    m2: Tensor     # (H, W, C)


def welford_init(shape, dtype: torch.dtype = torch.float32,
                 device=None) -> WelfordState:
    """An empty state of ``shape`` on ``device`` (the CPU when None, like
    ``torch.zeros``; the entry points pass their resolved device)."""
    return WelfordState(count=torch.zeros((), dtype=torch.int64,
                                          device=device),
                        mean=torch.zeros(shape, dtype=dtype, device=device),
                        m2=torch.zeros(shape, dtype=dtype, device=device))


def welford_update(state: WelfordState, frame: Tensor) -> WelfordState:
    """One frame: delta = x - mean; mean += delta/n; m2 += delta*(x - mean)
    (video_processing.py:206-208, exact order)."""
    count = state.count + 1
    delta = frame - state.mean
    mean = state.mean + delta / count.to(frame.dtype)
    m2 = state.m2 + delta * (frame - mean)
    return WelfordState(count=count, mean=mean, m2=m2)


def welford_update_batch(state: WelfordState, frames: Tensor
                         ) -> WelfordState:
    """Consume a (B, H, W, C) batch frame by frame (order-identical to the
    reference loop)."""
    for frame in frames:
        state = welford_update(state, frame)
    return state


def welford_update_batch_lut(state: WelfordState, frames_dn: Tensor,
                             icrf: Tensor, max_dn: int) -> WelfordState:
    """Consume a (B, H, W, C) integer-DN batch, linearizing each frame
    through the ICRF LUT inside the loop (the reference applies the LUT per
    frame before its update, video_processing.py:200-208): the batch stays
    uint8 on the device, and only one linearized frame exists at a time."""
    for frame in frames_dn:
        x, _ = linearize(frame.long(), None, icrf, max_dn=max_dn)
        state = welford_update(state, x.to(state.mean.dtype))
    return state


def welford_finalize(state: WelfordState, use_std: bool = True
                     ) -> Tuple[Tensor, Optional[Tensor]]:
    """mean and the std of the mean: sqrt(m2/(n-1))/sqrt(n)
    (video_processing.py:210-215)."""
    if not use_std:
        return state.mean, None
    n = state.count.to(state.mean.dtype)
    std_of_mean = torch.sqrt(state.m2 / (n - 1.0)) / torch.sqrt(n)
    return state.mean, std_of_mean
