"""Config-2 kernel plateau investigation, on the card: port of
``benchmarks/exp_plateau.py``.

    python -m camera_linearity_tpu_torch.experiments.exp_plateau
        [xla dma kern trace ...] [--device cuda|cpu] [--shape N H W C]
        [--seed S] [--trace-dir DIR]

It separates what K1's time is made of with measurements:

* ``xla``   -- the same traffic as two ``torch.sum`` calls over the
  exposure axis of the (N, H, W, C) stacks: the library's reduction, the
  bandwidth the card delivers to a fused read of both stacks (a yardstick;
  no path of the port calls it), and a read of one stack alone;
* ``dma``   -- E5, ``ops.ablation_cuda.exposure_sum`` on the planar
  layout (N, C, H, W), over the launch sweep (threads per block x quads a
  thread): Hopper's counterpart of the JAX script's row-block x
  ``dimension_semantics`` sweep;
* ``kern``  -- K1 (``ops.hdr_cuda.merge_nhwc_fused``) on the stacks as
  they lie; the JAX script's ``hb`` sweep is Mosaic tuning and is dropped;
* ``trace`` -- a ``torch.profiler`` trace of ten K1 calls
  (``utils.observability.trace``) into ``--trace-dir`` (default
  ``build/trace_plateau`` beside the package).

The device is ``cuda`` unless the caller asks for ``cpu``; without a card
``cuda`` raises.  Times are CUDA events (``exp_kernel.measure``); on the
CPU the plain versions run once, untimed.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path
from typing import Dict, Optional, Sequence

import torch

from ..ops import ablation_cuda, hdr_cuda
from ..utils.device import resolve_device
from .exp_kernel import SHAPE, Result, make_data, measure

Tensor = torch.Tensor

__all__ = ["planar", "plateau_dma", "run", "main"]

TRACE_DIR = Path(__file__).resolve().parents[2] / "build" / "trace_plateau"


def _gb(n: int, h: int, w: int, c: int) -> float:
    """GB the sums move: both stacks read, two (H, W, C) planes written."""
    return (2 * n * h * w * c * 4 + 2 * h * w * c * 4) / 1e9


def _line(label: str, r: Result, gb: float, note: str = "") -> str:
    if r.ms is None:
        return f"{label}: not timed on the cpu"
    return f"{label}: {r.ms:.4f} ms -> {gb / r.ms * 1e3:.0f} GB/s{note}"


def planar(val: Tensor) -> Tensor:
    """(N, H, W, C) -> (N, C, H, W), contiguous: a copy here, where the
    TPU relabelled the layout for free."""
    return val.permute(0, 3, 1, 2).contiguous()


def plateau_dma(vp: Tensor, sp: Tensor, threads: int = 256, vec: int = 1):
    """E5 (exp_plateau.py:83): the exposure sums of planar (N, C, H, W)
    stacks, (C, H, W) each."""
    return ablation_cuda.exposure_sum(vp, sp, "planar", threads=threads,
                                      vec=vec)


def run(names: Sequence[str], device=None, shape: Sequence[int] = SHAPE,
        seed: int = 0, trace_dir: Optional[Path] = None) -> Dict:
    """The JAX script's ``main`` (exp_plateau.py:152-162) on ``device``;
    prints its lines and returns ``{"xla": {name: Result}, "dma":
    {(threads, vec): Result}, "kern": Result, "trace": path}`` for the
    names run."""
    dev = resolve_device(device)
    n, h, w, c = shape
    gb = _gb(n, h, w, c)
    val, std, t, icrf, icrf_diff = make_data(seed, shape, dev)
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"exp_plateau on {where}, shape {tuple(shape)}")
    res: Dict = {}
    if "xla" in names:
        res["xla"] = {
            "torch_sum_pair": measure(
                lambda: (torch.sum(val, 0), torch.sum(std, 0)), dev),
            "torch_sum_single": measure(lambda: (torch.sum(val, 0),), dev)}
        print(_line("torch_sum_pair", res["xla"]["torch_sum_pair"], gb,
                    " effective"))
        print(_line("torch_sum_single", res["xla"]["torch_sum_single"],
                    gb / 2))
    if "dma" in names:
        vp, sp = planar(val), planar(std)
        res["dma"] = {}
        for threads in ablation_cuda.THREADS:
            for vec in ablation_cuda.VECS:
                r = measure(
                    lambda a=threads, b=vec: plateau_dma(vp, sp, a, b), dev)
                res["dma"][threads, vec] = r
                print(_line(f"dma threads={threads:4d} vec={vec}", r, gb))
        del vp, sp
    if "kern" in names:
        res["kern"] = measure(lambda: hdr_cuda.merge_nhwc_fused(
            val, std, t, icrf, icrf_diff), dev)
        r = res["kern"]
        print("kern: not timed on the cpu" if r.ms is None else
              f"kern: {r.ms:.4f} ms -> {h * w / 1e3 / r.ms:.0f} MP/s")
    if "trace" in names:
        from ..utils.observability import device_busy, trace
        out_dir = Path(trace_dir or TRACE_DIR)
        hdr_cuda.merge_nhwc_fused(val, std, t, icrf, icrf_diff)
        with trace(out_dir) as prof:
            for _ in range(10):
                hdr_cuda.merge_nhwc_fused(val, std, t, icrf, icrf_diff)
            if dev.type == "cuda":
                torch.cuda.synchronize()
        busy_ms, spans = device_busy(prof)
        res["trace"] = out_dir
        print(f"trace written to {out_dir} ({spans} device spans, busy "
              f"{busy_ms:.4f} ms)")
    return res


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m camera_linearity_tpu_torch.experiments.exp_plateau",
        description="Config-2 plateau experiments (E5, K1, the library "
                    "reduction).")
    ap.add_argument("names", nargs="*", default=["xla", "dma", "kern"])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--shape", nargs=4, type=int, default=list(SHAPE),
                    metavar=("N", "H", "W", "C"))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--trace-dir", type=Path, default=None)
    args = ap.parse_args(argv)
    run(args.names, args.device, tuple(args.shape), args.seed,
        args.trace_dir)
    return 0


if __name__ == "__main__":
    sys.exit(main())
