"""Structured logging, device traces, per-stage wall times and decoder
counts.

Port of ``camera_linearity_tpu/utils/observability.py``: a namespaced
stdlib logger, a ``torch.profiler`` trace context (where the JAX package
has a ``jax.profiler`` one) with the device-busy time it saw, a
process-global accumulator of each pipeline stage's busy time, a count of
the frames each video decoder produced, and a wall-clock scope that
synchronizes the card so timings are honest under asynchronous CUDA
launches.
"""
from __future__ import annotations

import contextlib
import logging
import os
import threading
import time
from pathlib import Path
from typing import Dict, Iterator, Optional, Tuple, Union

import torch

__all__ = ["get_logger", "trace", "device_busy", "timed", "stage",
           "stage_times", "reset_stage_times", "snapshot_stage_times",
           "decoded_frames"]

_FORMAT = "%(asctime)s %(name)s %(levelname)s %(message)s"


def get_logger(name: str = "camera_linearity_tpu_torch",
               level: int = logging.INFO) -> logging.Logger:
    """The logger ``name`` (by default the package's), given one stream
    handler and ``level`` the first time it is asked for."""
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = logging.StreamHandler()
        handler.setFormatter(logging.Formatter(_FORMAT))
        logger.addHandler(handler)
        logger.setLevel(level)
        logger.propagate = False
    return logger


@contextlib.contextmanager
def trace(log_dir: Union[str, Path]) -> Iterator["torch.profiler.profile"]:
    """Profile the block with ``torch.profiler`` (CPU activity, and CUDA
    activity when a card is there) and export a Chrome trace
    (``trace-<pid>-<ms>.json``, for chrome://tracing or Perfetto) into
    ``log_dir``.  Yields the profiler, for :func:`device_busy`."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(
        log_dir / f"trace-{os.getpid()}-{int(time.time() * 1e3)}.json"))


def device_busy(prof: "torch.profiler.profile") -> Tuple[float, int]:
    """(ms during which at least one kernel or copy ran on the card, and
    their count) in a finished profile: the union of the device
    intervals, so overlapping streams count once.  ``Command Buffer
    Full`` marks the host waiting on a full launch queue, not device
    work, and is left out."""
    from torch.autograd import DeviceType
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == DeviceType.CUDA
                   and e.name != "Command Buffer Full")
    busy_us, end_us = 0.0, float("-inf")
    for a, b in spans:
        busy_us += max(0.0, b - max(a, end_us))
        end_us = max(end_us, b)
    return busy_us / 1e3, len(spans)


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


def snapshot_stage_times(round_to: int = 2) -> Dict[str, float]:
    """The stage times so far, in seconds to ``round_to`` decimals."""
    return {k: round(v, round_to)
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
def timed(label: str, logger: Optional[logging.Logger] = None,
          sync: bool = True, *, device=None) -> Iterator[dict]:
    """Wall-clock a block, log it to ``logger`` (the package's by default)
    and yield a dict that holds the block's ``"seconds"`` once it ends.
    With ``sync`` and a card, synchronizes ``device`` (the current CUDA
    device by default) before and after, since launches return before the
    work is done."""
    logger = logger or get_logger()
    sync = sync and torch.cuda.is_available() and (
        device is None or torch.device(device).type == "cuda")
    if sync:
        torch.cuda.synchronize(device)
    info: dict = {}
    t0 = time.perf_counter()
    try:
        yield info
    finally:
        if sync:
            torch.cuda.synchronize(device)
        info["seconds"] = time.perf_counter() - t0
        logger.info("%s: %.3f s", label, info["seconds"])
