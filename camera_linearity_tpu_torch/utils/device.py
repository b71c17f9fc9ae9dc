"""The port's default device and its canonical float type per device."""
from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["DEFAULT_DEVICE", "resolve_device", "canonical_float"]

# the entry points run on the card unless the caller asks for the CPU
DEFAULT_DEVICE = torch.device("cuda")


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``device``, or :data:`DEFAULT_DEVICE` when it is None.  A CUDA device
    without a card raises: nothing falls back to the CPU, which a caller
    asks for with ``device="cpu"``."""
    device = DEFAULT_DEVICE if device is None else torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device} requested (the port's default is "
            f"{DEFAULT_DEVICE}) but no CUDA device is available; pass "
            "device='cpu' to run on the CPU")
    return device


def canonical_float(device) -> torch.dtype:
    """float32 on CUDA, the type the merge kernels compute in (as the JAX
    package computes in float32 on the TPU); float64 on the CPU, where the
    parity tests hold the port to the JAX package run with x64
    (tests/conftest.py)."""
    return torch.float32 if torch.device(device).type == "cuda" \
        else torch.float64
