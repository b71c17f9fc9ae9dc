"""E6, K1's merge with a hand-written load pipeline, on the card: port of
``benchmarks/exp_manual_pipeline.py``.

    python -m camera_linearity_tpu_torch.experiments.exp_manual_pipeline
        [--device cuda|cpu] [--shape N H W C] [--seed S]
        [--chunk K ...] [--stages S ...]

The JAX script asks whether a pipeline written by hand, with the operands
left in device memory and row chunks double-buffered through on-chip
memory, overlaps the loads and the lookup work that the automatic pipeline
runs one after the other.  Here the pipeline is
``ops.lut_merge_cuda.merge_pipelined``: chunks of the planar stacks staged
in shared memory by bulk copies through a ring of ``stages`` slots.  The
JAX script's ``--hb`` sweep (rows a chunk) becomes a sweep of (chunk
elements, stages): every setting of ``--chunk`` x ``--stages`` that fits
a block (default :data:`~..ops.lut_merge_cuda.CHUNKS` x
:data:`~..ops.lut_merge_cuda.STAGES`).  The "shipped" baseline is K1
(``ops.hdr_cuda.merge_nhwc_fused``) on a channels-last copy of the same
data, as K1 reads the stack as it lies.  On the card each setting is held
to the plain version at the script's tolerance (:235-238).

The device is ``cuda`` unless the caller asks for ``cpu``; without a card
``cuda`` raises.  Times are CUDA events (``exp_kernel.measure``); on the
CPU the plain versions run once, untimed.
"""
from __future__ import annotations

import argparse
import sys
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops import hdr_cuda, lut_merge_cuda as lm
from ..utils.device import resolve_device
from .exp_kernel import SHAPE, Result, measure

Tensor = torch.Tensor

__all__ = ["make_data", "channels_last", "check", "run", "main", "VAL_TOL",
           "STD_TOL"]

# exp_manual_pipeline.py:235-238
VAL_TOL = dict(rtol=3e-5, atol=1e-6)
STD_TOL = dict(rtol=3e-4, atol=2e-6)


def make_data(seed: int = 0, shape: Sequence[int] = SHAPE, device=None
              ) -> Tuple[Tensor, ...]:
    """exp_manual_pipeline.py:196-203 at ``shape`` (N, H, W, C): the same
    numpy draws in the same order, so the same f32 values bit for bit.
    (val, std, t, invt, icrf, icrf_diff) on ``device``: (N, C, H, W)
    stacks, N exposure times and their reciprocals, (256, C) tables."""
    dev = resolve_device(device)
    n, h, w, c = shape
    rng = np.random.default_rng(seed)
    val = rng.uniform(0.02, 0.98, (n, c, h, w)).astype(np.float32)
    std = rng.uniform(0.001, 0.02, (n, c, h, w)).astype(np.float32)
    exposures = 0.001 * 2.0 ** np.arange(n)
    invt = (1.0 / exposures).astype(np.float32)
    icrf = np.sort(rng.uniform(0, 1, (256, c)), axis=0)
    icrf[0], icrf[-1] = 0.0, 1.0
    icrf_diff = np.gradient(icrf, 2 / 255, axis=0)
    return tuple(torch.from_numpy(np.asarray(a, np.float32)).to(dev)
                 for a in (val, std, exposures, invt, icrf, icrf_diff))


def channels_last(x: Tensor) -> Tensor:
    """(N, C, H, W) -> (N, H, W, C), contiguous: the layout K1 reads."""
    return x.permute(0, 2, 3, 1).contiguous()


def check(label: str, got, want, val_tol=VAL_TOL, std_tol=STD_TOL) -> None:
    """Raise AssertionError naming ``label`` when ``got`` (value, std)
    misses ``want`` by more than the tolerances."""
    for name, g, w_, tol in zip(("value", "std"), got, want,
                                (val_tol, std_tol)):
        if not torch.allclose(g, w_, **tol):
            gap = (g - w_).abs().max().item()
            raise AssertionError(f"{label}: {name} outside {tol} of the "
                                 f"plain version (max abs err {gap:.3e})")


def run(device=None, shape: Sequence[int] = SHAPE, seed: int = 0,
        settings: Optional[Sequence[Tuple[int, int]]] = None
        ) -> Dict[str, Result]:
    """The JAX script's ``main`` (exp_manual_pipeline.py:221-241) on
    ``device``: K1 on the channels-last copy as ``shipped``, then E6 at
    each (chunk, stages) of ``settings`` (default: every setting of the
    sweep that fits) as ``manual <chunk>x<stages>``, each held to the plain
    version on the card; prints a line for each and returns their
    results."""
    dev = resolve_device(device)
    n, h, w, c = shape
    val, std, t, invt, icrf, icrf_diff = make_data(seed, shape, dev)
    invt = invt.cpu()  # passed by value: kept on the host
    ref = lm.merge_planar_plain(val, std, invt, icrf, icrf_diff)
    if settings is None:
        settings = lm.pipeline_settings(n, c)
    default = lm.plan_pipeline(n, c)
    res: Dict[str, Result] = {}

    v_cl, s_cl = channels_last(val), channels_last(std)
    res["shipped"] = measure(lambda: tuple(x.permute(2, 0, 1) for x in
                                           hdr_cuda.merge_nhwc_fused(
                                               v_cl, s_cl, t, icrf,
                                               icrf_diff)), dev, ref)
    del v_cl, s_cl
    for chunk, stages in settings:
        r = measure(lambda k=chunk, s=stages: lm.merge_pipelined(
            val, std, invt, icrf, icrf_diff, k, s), dev, ref)
        if dev.type == "cuda":  # on the CPU the wrapper runs ref's code
            check(f"E6 chunk {chunk} x {stages} stages", r.out, ref)
        res[f"manual {chunk}x{stages}"] = r

    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"exp_manual_pipeline on {where}, shape {tuple(shape)}, default "
          f"chunk {default.chunk} x {default.stages} stages")
    mp = h * w * c / 1e6
    for k, r in res.items():
        if r.ms is None:
            print(f"{k:>18}: not timed on the cpu")
        else:
            ok = "" if k == "shipped" else "  parity ok"
            print(f"{k:>18}: {r.ms:.4f} ms  ({mp / r.ms * 1e3:.0f} MP/s){ok}")
    return res


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m "
             "camera_linearity_tpu_torch.experiments.exp_manual_pipeline",
        description="E6: the config-2 merge with a hand-written load "
                    "pipeline, against K1.")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--shape", nargs=4, type=int, default=list(SHAPE),
                    metavar=("N", "H", "W", "C"))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--chunk", type=int, nargs="+", default=list(lm.CHUNKS))
    ap.add_argument("--stages", type=int, nargs="+", default=list(lm.STAGES))
    args = ap.parse_args(argv)
    n, _, _, c = args.shape
    run(args.device, tuple(args.shape), args.seed,
        lm.pipeline_settings(n, c, args.chunk, args.stages))
    return 0


if __name__ == "__main__":
    sys.exit(main())
