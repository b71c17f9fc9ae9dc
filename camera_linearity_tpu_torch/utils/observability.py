"""Structured logging, per-stage wall times and decoder counts.

Port of ``camera_linearity_tpu/utils/observability.py`` without its
``trace`` (a ``jax.profiler`` context; the port's profiler hook waits for
ROADMAP queue 1 item 5): a namespaced stdlib logger, a process-global
accumulator of each pipeline stage's busy time, a count of the frames each
video decoder produced, and a wall-clock scope that synchronizes the card
so timings are honest under asynchronous CUDA launches.
"""
from __future__ import annotations

import contextlib
import logging
import threading
import time
from typing import Dict, Iterator

import torch

__all__ = ["get_logger", "timed", "stage", "stage_times",
           "reset_stage_times", "snapshot_stage_times", "decoded_frames"]

_FORMAT = "%(asctime)s %(name)s %(levelname)s %(message)s"


def get_logger() -> logging.Logger:
    """The package's logger (INFO, one stream handler)."""
    logger = logging.getLogger("camera_linearity_tpu_torch")
    if not logger.handlers:
        handler = logging.StreamHandler()
        handler.setFormatter(logging.Formatter(_FORMAT))
        logger.addHandler(handler)
        logger.setLevel(logging.INFO)
        logger.propagate = False
    return logger


class _Totals:
    """Process-global, thread-safe totals by name.

    ``stage_times``: pipelines report how long each stage of a run spent
    working (decode, statistics, upload, merge, ...), so an end-to-end wall
    number is attributable from the printed totals alone.  Threads report
    concurrently (decode runs on a prefetch thread), so per-stage times are
    busy time, not exclusive wall slices: overlapped stages sum to more
    than the wall clock, and that surplus is the overlap working.
    ``decoded_frames``: frames decoded, by the decoder that decoded them.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._totals: Dict[str, float] = {}

    def add(self, name: str, amount: float) -> None:
        with self._lock:
            self._totals[name] = self._totals.get(name, 0) + amount

    def reset(self) -> None:
        with self._lock:
            self._totals.clear()

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            return dict(self._totals)


stage_times = _Totals()
decoded_frames = _Totals()


def reset_stage_times() -> None:
    """Zero the stage times and the decoder counts."""
    stage_times.reset()
    decoded_frames.reset()


def snapshot_stage_times() -> Dict[str, float]:
    """The stage times so far, in seconds to two decimals."""
    return {k: round(v, 2)
            for k, v in sorted(stage_times.snapshot().items())}


@contextlib.contextmanager
def stage(name: str) -> Iterator[None]:
    """Accumulate this block's wall time under ``name`` in the
    process-global stage recorder (no device sync — callers time host-side
    busy work; device work should be synchronized inside the block when it
    is the quantity being attributed)."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        stage_times.add(name, time.perf_counter() - t0)


@contextlib.contextmanager
def timed(label: str, device=None) -> Iterator[None]:
    """Wall-clock a block and log it; with a card, synchronizes ``device``
    (the current CUDA device by default) before and after, since launches
    return before the work is done."""
    sync = torch.cuda.is_available() and (
        device is None or torch.device(device).type == "cuda")
    if sync:
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if sync:
            torch.cuda.synchronize(device)
        get_logger().info("%s: %.3f s", label, time.perf_counter() - t0)
