"""E7, the exact 4096-entry merge with its tables in another form, on the
card: port of ``benchmarks/exp_int8_planes.py``.

    python -m camera_linearity_tpu_torch.experiments.exp_int8_planes
        [--device cuda|cpu] [--shape N H W C] [--seed S]

The JAX script times the 12-bit lookup with its tables held as three bf16
parts against four int8 byte planes: on the TPU the lookup was a one-hot
matrix product, and the form set its cost.  Here a block stages its
channel's two tables in shared memory in the form under test
(``ops.lut_merge_cuda.merge_table_form``): ``bf16x3`` (the script's
``bf16``), ``u8x4`` (its ``int8``) and ``f32``, the control the script has
none of (its f32 path is the shipped kernel).  The tables are packed once,
before the timed calls, as the script packs them.  Only the lookup differs
between the forms, and each rebuilds every entry exactly, so the three
results are held to be equal bit for bit, or at the script's tolerance
(:260-263) where they are not, and on the card each against the plain
version at E6's tolerance (``exp_manual_pipeline.check``).  K1
(``ops.hdr_cuda.merge_nhwc_fused``) at 4096 entries on a channels-last
copy of the same data is the baseline.

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
from .exp_kernel import SHAPE, measure
from .exp_manual_pipeline import channels_last, check

Tensor = torch.Tensor

__all__ = ["make_data", "run", "main", "FORM_VAL_TOL", "FORM_STD_TOL"]

BITS = lm.ROWS["E7"]
# the forms against each other where they differ (exp_int8_planes.py:
# 260-263)
FORM_VAL_TOL = dict(rtol=2e-6, atol=1e-7)
FORM_STD_TOL = dict(rtol=2e-5, atol=1e-7)


def make_data(seed: int = 0, shape: Sequence[int] = SHAPE, device=None
              ) -> Tuple[Tensor, ...]:
    """exp_int8_planes.py:237-245 at ``shape`` (N, H, W, C): the same numpy
    draws in the same order (the tables first), so the same f32 values bit
    for bit.  (val, std, t, invt, icrf, icrf_diff) on ``device``: (N, C, H,
    W) stacks, N exposure times and their reciprocals, (4096, C) tables."""
    dev = resolve_device(device)
    n, h, w, c = shape
    rng = np.random.default_rng(seed)
    icrf = np.sort(rng.uniform(0, 1, (BITS, c)), axis=0)
    icrf[0], icrf[-1] = 0.0, 1.0
    icrf_diff = np.gradient(icrf, 2 / (BITS - 1), axis=0)
    val = rng.uniform(0.02, 0.98, (n, c, h, w)).astype(np.float32)
    std = rng.uniform(0.001, 0.02, (n, c, h, w)).astype(np.float32)
    exposures = 0.001 * 2.0 ** np.arange(n)
    invt = (1.0 / exposures).astype(np.float32)
    return tuple(torch.from_numpy(np.asarray(a, np.float32)).to(dev)
                 for a in (val, std, exposures, invt, icrf, icrf_diff))


def run(device=None, shape: Sequence[int] = SHAPE, seed: int = 0) -> Dict:
    """The JAX script's ``main`` (exp_int8_planes.py:252-272) on
    ``device``: each form against the plain version and against the
    others, K1 at 4096 entries on the channels-last copy;
    prints a line for each, the bf16 / u8 ratio of their times, and
    returns ``{form: Result, ..., "k1": Result, "bit_equal": bool}``
    (whether the forms gave the same bits)."""
    dev = resolve_device(device)
    n, h, w, c = shape
    val, std, t, invt, icrf, icrf_diff = make_data(seed, shape, dev)
    invt = invt.cpu()  # passed by value: kept on the host
    ref = lm.merge_planar_plain(val, std, invt, icrf, icrf_diff)
    res: Dict = {}
    for form in lm.FORMS:
        tabs = [lm.pack_table(x, form) for x in (icrf, icrf_diff)]
        res[form] = measure(lambda f=form, tabs=tabs: lm.merge_table_form(
            val, std, invt, *tabs, f), dev, ref)
        if dev.type == "cuda":  # on the CPU the wrapper runs ref's code
            check(f"E7 {form}", res[form].out, ref)
    first = res["f32"].out
    res["bit_equal"] = all(torch.equal(a, b) for f in lm.FORMS[1:]
                           for a, b in zip(res[f].out, first))
    if not res["bit_equal"]:
        for f in lm.FORMS[1:]:
            check(f"E7 {f} against f32", res[f].out, first, FORM_VAL_TOL,
                  FORM_STD_TOL)
    v_cl, s_cl = channels_last(val), channels_last(std)
    res["k1"] = measure(lambda: tuple(x.permute(2, 0, 1) for x in
                                      hdr_cuda.merge_nhwc_fused(
                                          v_cl, s_cl, t, icrf, icrf_diff)),
                        dev, ref)
    del v_cl, s_cl

    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"exp_int8_planes on {where}, shape {tuple(shape)}, {BITS}-entry "
          f"tables; forms equal bit for bit: {res['bit_equal']}")
    mp = h * w * c / 1e6
    for k in (*lm.FORMS, "k1"):
        r = res[k]
        label = f"{k} (K1, channels-last)" if k == "k1" else k
        if r.ms is None:
            print(f"{label}: not timed on the cpu (err {r.err:.1e})")
        else:
            print(f"{label}: {r.ms:.4f} ms  ({mp / r.ms * 1e3:.0f} MP/s, err "
                  f"{r.err:.1e})")
    if res["u8x4"].ms is not None:
        print(f"ratio bf16x3 / u8x4: {res['bf16x3'].ms / res['u8x4'].ms:.3f}x")
    return res


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m "
             "camera_linearity_tpu_torch.experiments.exp_int8_planes",
        description="E7: the config-3 merge with its 4096-entry tables as "
                    "f32, three bf16 parts or four byte planes, against K1.")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--shape", nargs=4, type=int, default=list(SHAPE),
                    metavar=("N", "H", "W", "C"))
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    run(args.device, tuple(args.shape), args.seed)
    return 0


if __name__ == "__main__":
    sys.exit(main())
