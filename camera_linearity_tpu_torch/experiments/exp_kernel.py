"""Kernel experiments for the config-2 merge, on the card: port of
``benchmarks/exp_kernel.py``.

    python -m camera_linearity_tpu_torch.experiments.exp_kernel [names...]
        [--device cuda|cpu] [--shape N H W C] [--seed S]

Names, as in the JAX script (default ``base dma math relayout``; ``base``
does nothing there and here):

- ``dma``: E1 :func:`ab_dma`, the exposure sum of value and std on the
  cfirst layout (C, N, 1, P), the floor set by the bytes;
- ``math``: E2 :func:`ab_math`, the merge with ``g = x`` and ``f' = 1`` on
  the cfirst layout: K1 without its table lookup;
- ``relayout``: :func:`cfirst` of value and std (a copy, not a kernel);
- ``flatdma``: E3 :func:`flat_invt` on the flat layout (N, L), with and
  without the dead index;
- ``v2``: K1 (``ops.hdr_cuda.merge_nhwc_fused``) on the f32 stacks, with
  its max abs error against K1's plain version;
- ``planar``: K1 on f32 values, on uint8 DNs and without std
  (exp_kernel.py:307-322), each with its error where the JAX script
  takes one.

E4 (``make_flat_dma``), which the JAX ``run`` never calls, is
:func:`flat_dma`.  Left out: the ``hb`` sweeps and the
``merge_planar_fused`` calls of ``v2`` and ``planar`` (Mosaic tuning, and a
planar-input kernel the port has no need of: K1 reads the stack as it
lies), and the names ``v2dbg`` and ``v2cf`` (:323-348), which call
``merge_nhwc_fused(debug=...)`` and ``merge_cfirst_v2``:
``camera_linearity_tpu/ops/hdr_pallas2.py`` no longer defines either, so
they fail in the JAX script too.

The device is ``cuda`` unless the caller asks for ``cpu``; without a card
``cuda`` raises.  On the card each name is timed with CUDA events (best
of 3 trials of 20 calls after a warm-up call); on the CPU the plain
versions run once, untimed.  :func:`run` returns each name's outputs and
time.
"""
from __future__ import annotations

import argparse
import sys
from typing import Callable, Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops import ablation_cuda, hdr_cuda
from ..utils.device import resolve_device

Tensor = torch.Tensor

__all__ = ["SHAPE", "Result", "make_data", "cfirst", "measure", "ab_dma",
           "ab_math", "flat_invt", "flat_dma", "run", "main"]

SHAPE = (6, 1200, 1920, 3)  # config 2: (N, H, W, C)


class Result(NamedTuple):
    out: tuple                   # the call's outputs
    ms: Optional[float]          # device ms a call; None on the CPU
    err: Optional[float] = None  # max abs error against a plain version


def make_data(seed: int = 0, shape: Sequence[int] = SHAPE, device=None
              ) -> Tuple[Tensor, ...]:
    """exp_kernel.py:41-50 at ``shape``: the same numpy draws, so the same
    f32 values bit for bit.  (val, std, t, icrf, icrf_diff) on ``device``:
    (N, H, W, C) stacks, N exposure times, (256, C) tables."""
    dev = resolve_device(device)
    n, h, w, c = shape
    rng = np.random.default_rng(seed)
    val = rng.uniform(0.02, 0.98, (n, h, w, c))
    std = rng.uniform(0.001, 0.02, (n, h, w, c))
    t = 0.001 * 2.0 ** np.arange(n)
    icrf = np.sort(rng.uniform(0, 1, (256, c)), axis=0)
    icrf[0], icrf[-1] = 0.0, 1.0
    icrf_diff = np.gradient(icrf, 2 / 255, axis=0)
    return tuple(torch.from_numpy(a.astype(np.float32)).to(dev)
                 for a in (val, std, t, icrf, icrf_diff))


def cfirst(s: Tensor) -> Tensor:
    """(N, H, W, C) -> (C, N, 1, H*W), contiguous (exp_kernel.py:53)."""
    n, h, w, c = s.shape
    return s.reshape(n, h * w, c).permute(2, 0, 1).contiguous().reshape(
        c, n, 1, h * w)


def measure(fn: Callable[[], tuple], device: torch.device,
            ref: Optional[tuple] = None, iters: int = 20,
            trials: int = 3) -> Result:
    """``fn``'s outputs, its device ms a call on the card (CUDA events
    around ``iters`` back-to-back calls, best of ``trials``, after a
    warm-up call) or None on the CPU, and its max abs error against
    ``ref``'s outputs."""
    out = fn()
    err = None
    if ref is not None:
        err = max((a - b).abs().max().item()
                  for a, b in zip(out, ref) if a is not None)
    if device.type != "cuda":
        return Result(out, None, err)
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(trials):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / iters)
    return Result(out, best, err)


# ---------------------------------------------------------------------------
# the Pallas functions' counterparts
# ---------------------------------------------------------------------------

def ab_dma(val: Tensor, std: Tensor):
    """E1 (exp_kernel.py:65): the exposure sums of cfirst (C, N, 1, P)
    stacks, (C, 1, P) each."""
    return ablation_cuda.exposure_sum(val, std, "cfirst")


def ab_math(val: Tensor, std: Tensor, t):
    """E2 (exp_kernel.py:99): the merge without a lookup of cfirst stacks,
    with 1/t in f32 as :106 takes it (a host ``t`` spares a
    synchronization)."""
    inv_t = 1.0 / torch.as_tensor(t, dtype=torch.float32)
    return ablation_cuda.merge_nolut(val, std, inv_t, "cfirst")


def flat_invt(val: Tensor, std: Tensor, invt, dead: bool = False):
    """E3 (exp_kernel.py:122): the merge without a lookup of flat (N, L)
    stacks with reciprocal exposure times ``invt`` ((N, 1) or (N,)), (1, L)
    each; ``dead`` computes the unused index of :128-137."""
    return ablation_cuda.merge_nolut(val, std, invt, "flat", dead=dead)


def flat_dma(val: Tensor, std: Tensor, extra: Optional[str] = None):
    """E4 (exp_kernel.py:173): the exposure sums of flat (N, L) stacks,
    with ``extra`` None, ``"mod"``, ``"round"`` or ``"exp"`` added to the
    value, or with ``"math"`` the merge without a lookup at 1/t = 1."""
    if extra == "math":
        return ablation_cuda.merge_nolut(val, std, None, "flat")
    return ablation_cuda.exposure_sum(val, std, "flat", extra or "none")


# ---------------------------------------------------------------------------

def run(names: Sequence[str], device=None, shape: Sequence[int] = SHAPE,
        seed: int = 0) -> Dict[str, Result]:
    """The JAX script's ``run`` (exp_kernel.py:236-351) on ``device``: each
    named experiment on ``make_data(seed, shape)``; prints a line for each
    and returns their results by the JAX script's keys, without its
    ``hb`` and error suffixes (``relayout`` for its ``xla_relayout``)."""
    dev = resolve_device(device)
    n, h, w, c = shape
    p = h * w
    val, std, t, icrf, icrf_diff = make_data(seed, shape, dev)
    t_host = t.cpu()
    vcf, scf = cfirst(val), cfirst(std)
    res: Dict[str, Result] = {}

    if "dma" in names:
        res["ablate_dma"] = measure(lambda: ab_dma(vcf, scf), dev)
    if "math" in names:
        res["ablate_math"] = measure(lambda: ab_math(vcf, scf, t_host), dev)
    if "relayout" in names:
        res["relayout"] = measure(lambda: (cfirst(val), cfirst(std)), dev)
    if "v2" in names or "planar" in names:
        ref = hdr_cuda.merge_fused_plain(val, std, t, icrf, icrf_diff)

        def k1(v, s=std):
            return hdr_cuda.merge_nhwc_fused(v, s, t, icrf, icrf_diff)
    if "v2" in names:
        res["v2_nhwc"] = measure(lambda: k1(val), dev, ref)
    if "flatdma" in names:
        vf, sf = val.reshape(n, -1), std.reshape(n, -1)
        invt = (1.0 / t_host).reshape(n, 1)
        for dead in (False, True):
            res[f"flat_invt_dead{dead}"] = measure(
                lambda d=dead: flat_invt(vf, sf, invt, d), dev)
    if "planar" in names:
        res["final_nhwc"] = measure(lambda: k1(val), dev, ref)
        # uint8 value stack (the reference's native 8-bit load path)
        dn = torch.from_numpy(np.random.default_rng(1).integers(
            0, 256, (n, h, w, c)).astype(np.uint8)).to(dev)
        ref_u8 = hdr_cuda.merge_fused_plain(dn, std, t, icrf, icrf_diff)
        res["final_nhwc_u8"] = measure(lambda: k1(dn), dev, ref_u8[:1])
        res["final_nhwc_nostd"] = measure(lambda: k1(val, None), dev)
        if res["final_nhwc_nostd"].out[1] is not None:
            raise AssertionError("K1 without std returned a std")

    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"exp_kernel on {where}, shape {tuple(shape)}")
    for k, r in res.items():
        err = "" if r.err is None else f"   (err {r.err:.1e})"
        if r.ms is None:
            print(f"{k:>22}: not timed on the cpu{err}")
        else:
            print(f"{k:>22}: {r.ms:8.4f} ms   {p / 1e3 / r.ms:7.1f} MP/s"
                  f"{err}")
    return res


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m camera_linearity_tpu_torch.experiments.exp_kernel",
        description="Config-2 merge kernel experiments (E1-E4, K1).")
    ap.add_argument("names", nargs="*",
                    default=["base", "dma", "math", "relayout"])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--shape", nargs=4, type=int, default=list(SHAPE),
                    metavar=("N", "H", "W", "C"))
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    run(args.names, args.device, tuple(args.shape), args.seed)
    return 0


if __name__ == "__main__":
    sys.exit(main())
