#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases 1-7, the HDR merge: builds the merge kernels K1-K3 from
``camera_linearity_tpu_torch/csrc`` (one ``nvcc`` per source, all at once)
and prints their registers and spills, holds each against its plain
PyTorch version on the card at the shapes of BASELINE config 2 (6 exposures
of 1200 x 1920 x 3, f32 value and std) and config 3 (the same geometry with
dark frames, a flat field and 12-bit tables), and on a 37 x 53 crop that
K2 and K3 load by their copy route, drives the port's entry points once
(``merge_hdr`` and ``ExposureSeries.process_HDR_image``) with the launch
counts reset, checks the end-to-end result against the same call on the
CPU, times each kernel against its plain version and against a
device-to-device ``copy_`` of the same bytes with CUDA events, and times
``process_HDR_image`` end to end on the host clock and under the
profiler.

Phases 8-11, the linearity analysis and the calibration (plain PyTorch; no
kernel of its own): ``process_linearity`` and
``collect_exposure_pair_stats`` at config-2 size against the CPU; every
energy form on a 65,536-pixel crop against the CPU in float64; the
config-4 ICRF solve (3 channels, 2,000 pixels, 6 exposures, popsize 15),
cold and warm, scored by the NumPy oracle of the reference; and the
calibration at full config-2 resolution, unweighted (the histogram form)
and std-weighted (the chunked form), with a profile of one generation of
each.  Inputs come from fixed numpy seeds; tables are gamma-like response
curves.

It prints the card's name and power limit early, one JSON line with the
kernels' results before the last line, and as the last line
``{"ok": true, "device": {...}}``.  Any failure raises: a nonzero exit and
no last line.  Without a CUDA device it exits with code 2.
"""
import json
import subprocess
import sys
import time

import numpy as np
import torch

N, H, W, C = 6, 1200, 1920, 3
EXPOSURES_MS = (40, 80, 160, 320, 640, 1280)  # all above dark_threshold
SEED = 20261016
# f32 kernel against f32 plain version on the card; the differences come
# from expf and FMA contraction
VAL_TOL = dict(rtol=2e-5, atol=1e-6)
STD_TOL = dict(rtol=2e-4, atol=1e-5)
# end to end, the card merges through the 256-point base curves' interpolant
# (K3) and the CPU through their np.interp expansion to 4096 entries: the
# two differ by f32 rounding of the expansion, the tolerance the JAX suite
# holds the same pair to (tests/unit/test_hdr_pallas2.py:141-144)
E2E_VAL_TOL = dict(rtol=2e-4, atol=2e-6)
E2E_STD_TOL = dict(rtol=1e-3, atol=2e-6)
# phase 8: f32 pair statistics over 2.3 M pixels, card against CPU; the sums
# run in another order on each
STATS_TOL = dict(rtol=1e-4, atol=1e-6)
# phase 9: f32 energies on the card against float64 on the CPU
ENERGY_TOL = dict(rtol=1e-5, atol=1e-7)
# phase 10: the solved energy against the NumPy oracle at the same params
ORACLE_RTOL = 1e-5
# phase 10: the recovered curve against x**gamma, the f32 bound of
# tests/unit/test_calibration.py:131
CURVE_ATOL = 0.065
CAL_GAMMAS = (2.0, 2.2, 2.4)
SOURCES = {
    "merge_nhwc_fused": "camera_linearity_tpu_torch/csrc/hdr_merge.cu",
    "merge_nhwc_lerp": "camera_linearity_tpu_torch/csrc/hdr_merge_lerp.cu",
    "merge_nhwc_lerp_bp": "camera_linearity_tpu_torch/csrc/hdr_merge_lerp.cu",
}
REPLACES = {
    "merge_nhwc_fused": "camera_linearity_tpu/ops/hdr_pallas2.py:474",
    "merge_nhwc_lerp": "camera_linearity_tpu/ops/hdr_pallas2.py:533",
    "merge_nhwc_lerp_bp": "camera_linearity_tpu/ops/hdr_pallas2.py:596",
}
# NVIDIA H100 SXM published peaks (NVIDIA's data sheet): HBM bytes per
# second, and f32 operations per second outside the tensor cores
PEAK_BYTES_S = 3.35e12
PEAK_F32_S = 67e12
# f32 operations per element and exposure of the merge with std, counted
# from the kernels' source (quantize, weight, lookups, bracket; expf as 1)
OPS_PER_ELEMENT = 48


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def make_inputs(rng):
    """A bracketed capture of one scene: radiance in [0, 1), the camera's
    gamma-like response, read noise, clipping; per-exposure dark frames
    with ~0.5 % hot pixels (all four corners included) and a vignetted flat
    field."""
    f32 = np.float32
    radiance = rng.random((H, W, C), dtype=f32) ** 2
    gamma = np.array([2.0, 2.2, 2.4], f32)
    t = np.array(EXPOSURES_MS, f32) / 1000
    vals = np.empty((N, H, W, C), f32)
    for e in range(N):
        lin = np.minimum(radiance * (t[e] / t[2]), 1.0)
        vals[e] = np.clip(lin ** (1 / gamma) + rng.normal(
            0, 0.004, (H, W, C)).astype(f32), 0.0, 1.0)
    stds = (0.002 + 0.01 * np.sqrt(vals)).astype(f32)
    darks = (rng.random((N, H, W, C), dtype=f32) * 0.01).astype(f32)
    hot = rng.random((N, H, W, C), dtype=f32) < 0.005
    hot[:, 0, 0] = hot[:, 0, -1] = hot[:, -1, 0] = hot[:, -1, -1] = True
    darks[hot] = 0.05 + 0.45 * rng.random(int(hot.sum()), dtype=f32)
    yy, xx = np.meshgrid(np.linspace(-1, 1, H, dtype=f32),
                         np.linspace(-1, 1, W, dtype=f32), indexing="ij")
    flat = (0.6 + 0.3 * np.cos(0.6 * np.sqrt(yy ** 2 + xx ** 2)))[..., None]
    flat = np.repeat(flat, C, axis=2).astype(f32)
    flat_std = np.full_like(flat, 0.004)
    return t, vals, stds, darks, flat, flat_std


def make_tables():
    """256-point base curves x^gamma per channel, their derivative, and the
    np.interp expansion of both to 4096 entries (the reference's >8-bit
    construction, ICRF_calibration_exposure.py:204-216)."""
    xb = np.arange(256) / 255.0
    base = np.stack([xb ** g for g in (2.0, 2.2, 2.4)], axis=1)
    diff_base = np.gradient(base, 2 / 255, axis=0)
    x = np.arange(4096) / 4095.0
    icrf = np.stack([np.interp(x, xb, base[:, ch]) for ch in range(C)], 1)
    diff = np.stack([np.interp(x, xb, diff_base[:, ch]) for ch in range(C)],
                    1)
    return base, diff_base, icrf, diff


class Results:
    """max |kernel - plain| per kernel over every comparison."""

    def __init__(self):
        self.err = {}

    def check(self, kernel, label, got, want, val_tol=VAL_TOL,
              std_tol=STD_TOL):
        (gv, gs), (wv, ws) = got, want
        torch.testing.assert_close(gv, wv, **val_tol)
        errs = [(gv - wv).abs().max().item()]
        if ws is not None:
            torch.testing.assert_close(gs, ws, **std_tol)
            errs.append((gs - ws).abs().max().item())
        elif gs is not None:
            raise AssertionError(f"{label}: std returned without input std")
        err = max(errs)
        if kernel is not None:
            self.err[kernel] = max(self.err.get(kernel, 0.0), err)
        log(f"  ok  {label}: max abs err {err:.3e}")


def time_samples(fn, runs: int = 10, reps: int = 10, warmup: int = 3):
    """Device ms per call of ``fn``, one sample per run: CUDA events around
    ``reps`` back-to-back calls, so the card is not left idle waiting on
    the host between calls.  The stacks (hundreds of MB) do not fit the
    50 MB L2, so every call reads them from device memory."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / reps)
    return samples


def host_ms(fn, runs: int = 10, warmup: int = 2) -> float:
    """Median host-clock ms of ``fn`` followed by a synchronize."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        samples.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(samples))


def gamma_basis(datapoints: int = 256):
    """Mean curve and 5-component PCA basis of a family of gamma ICRFs
    (benchmarks/bench_calibration.py:20-36): the DoRF database is not in
    the repository."""
    x = np.linspace(0, 1, datapoints)
    curves = np.stack([x ** g for g in np.linspace(1.6, 3.0, 25)])
    mean_icrf = curves.mean(axis=0)
    _, _, vt = np.linalg.svd(curves - mean_icrf, full_matrices=False)
    return mean_icrf, vt[:5].T


def config4_problem(seed=7, n_exp=6, pixels=2000, datapoints=256):
    """The config-4 calibration problem of bench.py:205-224 (built as
    benchmarks/bench_calibration.py:20-36 builds it): per channel, DNs of a
    linear scene seen through CRF = x**(1/gamma)."""
    rng = np.random.default_rng(seed)
    exposures = 0.001 * 2.0 ** np.arange(n_exp)
    mean_icrf, pca = gamma_basis(datapoints)
    stacks = []
    for g in CAL_GAMMAS:
        radiance = rng.uniform(0.01, 0.35, pixels)
        linear = radiance[:, None] * (exposures / exposures[-1])[None, :]
        stacks.append(np.around(np.clip(linear, 0, 1) ** (1 / g)
                                * (datapoints - 1)).astype(np.int32))
    return np.stack(stacks), exposures, mean_icrf, pca


def profile_breakdown(label: str, fn, top: int = 8,
                      by_kernel: bool = False) -> None:
    """One call of ``fn`` under ``torch.profiler`` after one warm-up call:
    the call's host-clock time, the union of its kernels' device
    intervals (busy), the idle share, and its top ops by the device time
    of the kernels each launched; with ``by_kernel``, also its top kernels
    by name (the merge kernels, launched through ctypes, belong to no
    op)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # "Command Buffer Full" marks the host waiting on a full launch queue,
    # not device work
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == DeviceType.CUDA
                   and e.name != "Command Buffer Full")
    busy_us, end_us = 0.0, float("-inf")
    for a, b in spans:
        busy_us += max(0.0, b - max(a, end_us))
        end_us = max(end_us, b)
    busy_ms = busy_us / 1e3
    if busy_ms == 0:
        log(f"  profile {label}: {wall_ms:.3f} ms with the profiler on; "
            "the profiler saw no device time (not measured)")
        return
    log(f"  profile {label}: {wall_ms:.3f} ms with the profiler on, "
        f"{len(spans)} kernels, device busy {busy_ms:.3f} ms, idle share "
        f"{max(0.0, 1 - busy_ms / wall_ms) * 100:.1f} %")
    if by_kernel:
        kernel_us = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA and \
                    e.name != "Command Buffer Full":
                kernel_us[e.name] = kernel_us.get(e.name, 0.0) + \
                    e.time_range.end - e.time_range.start
        for name, us in sorted(kernel_us.items(), key=lambda kv: -kv[1]
                               )[:top]:
            log(f"    kernel {us / 1e3:9.3f} ms {us / 1e3 / busy_ms * 100:5.1f}"
                f" % of busy  {name[:70]}")

    def dev_us(evt):
        return getattr(evt, "self_device_time_total",
                       getattr(evt, "self_cuda_time_total", 0.0))
    ops = sorted((e for e in prof.key_averages()
                  if e.device_type == DeviceType.CPU and dev_us(e) > 0
                  and e.key != "Command Buffer Full"),
                 key=dev_us, reverse=True)
    total_ms = sum(dev_us(e) for e in ops) / 1e3
    for e in ops[:top]:
        ms = dev_us(e) / 1e3
        log(f"    {ms:9.3f} ms {ms / total_ms * 100:5.1f} % x{e.count:<5d} "
            f"{e.key[:70]}")


def compare(label: str, got, want, tol, failures: list) -> float:
    """Max relative gap of ``got`` (any device) against ``want``; a miss
    of ``tol`` is recorded in ``failures`` and raised at the phase's end,
    so that one run prints every gap."""
    g = got.detach().double().cpu()
    w = want.detach().double().cpu()
    same_inf = torch.equal(torch.isinf(g), torch.isinf(w))
    fin = torch.isfinite(w)
    gap = ((g[fin] - w[fin]).abs() / w[fin].abs().clamp_min(1e-300)).max()
    gap = gap.item() if fin.any() else 0.0
    ok = same_inf and torch.allclose(g[fin], w[fin], **tol)
    log(f"  {'ok ' if ok else 'BAD'} {label}: max rel gap {gap:.3e}"
        f"{'' if same_inf else ' (inf pattern differs)'}")
    if not ok:
        failures.append(label)
    return gap


def raise_failures(phase: str, failures: list) -> None:
    if failures:
        raise AssertionError(f"{phase}: {', '.join(failures)} outside "
                             "tolerance")


def linearity_phases(dev, t_np, vals_np, stds_np) -> None:
    """Phases 8-11: the linearity analysis and the calibration."""
    from camera_linearity_tpu_torch import CameraConfig
    from camera_linearity_tpu_torch.models import calibration as cal
    from camera_linearity_tpu_torch.models.exposure_series import \
        ExposureSeries
    from camera_linearity_tpu_torch.models.image_set import ImageSet
    from camera_linearity_tpu_torch.models.scipy_strict import \
        reference_energy
    from camera_linearity_tpu_torch.ops import linearity as lin
    from camera_linearity_tpu_torch.utils.state import (
        channel_stacks_from_numpy, measurand_from_numpy, pca_from_numpy)

    def profile_generation(label, energy_fn, data):
        """One DE generation of C solvers of 75 members in [-1, 1]^5 under
        ``energy_fn``, profiled."""
        gens = [torch.Generator(dev).manual_seed(7 + c) for c in range(C)]
        pop0 = torch.as_tensor(np.stack([
            cal.sobol_init_population(75, 5, 7 + c) for c in range(C)]),
            device=dev, dtype=data[0].dtype)

        def energy(pop):
            return energy_fn(pop * 2.0 - 1.0, *data)
        state = cal._State(pop0, energy(pop0), torch.tensor(0, device=dev),
                           torch.zeros(C, dtype=torch.bool, device=dev),
                           torch.full((C,), 1000, device=dev))
        profile_breakdown(f"one generation, {label}", lambda: cal._generation(
            state, energy, gens, (0.0, 1.95), 0.4, 0.0, 0.0))

    # --- phase 8: the linearity analysis at config-2 size ------------------
    log("phase 8: process_linearity + collect_exposure_pair_stats "
        f"(config 2: {N} x {H} x {W} x {C}), card against CPU f32")

    def series(device):
        return ExposureSeries(input_image_sets=[
            ImageSet(f"{ms}ms BF sample 50x.tif", device=device,
                     measurand=measurand_from_numpy(
                         vals_np[e], stds_np[e], device=device,
                         dtype=torch.float32))
            for e, ms in enumerate(EXPOSURES_MS)])

    failures = []
    for use_std in (True, False):
        got_series, cpu_series = series(dev), series("cpu")
        got_series.process_linearity(use_std=use_std)
        got = got_series.collect_exposure_pair_stats()
        cpu_series.process_linearity(use_std=use_std)
        want = cpu_series.collect_exposure_pair_stats()
        log(f"  use_std={use_std}: {len(got_series.exposure_pairs)} pairs")
        for kind, g, w in (("abs", got[0], want[0]), ("rel", got[1], want[1])):
            for key in ("means", "stds", "errors"):
                if w[key] is None:
                    if g[key] is not None:
                        failures.append(f"{kind} {key} not None")
                    continue
                shape = np.shape(g[key])
                if shape != (len(got_series.exposure_pairs), C) or \
                        not np.isfinite(g[key]).all():
                    failures.append(f"{kind} {key} shape {shape} or "
                                    "non-finite")
                compare(f"use_std={use_std} {kind} {key}",
                        torch.as_tensor(g[key]), torch.as_tensor(w[key]),
                        STATS_TOL, failures)
        ms = host_ms(lambda: (got_series.process_linearity(use_std=use_std),
                              got_series.collect_exposure_pair_stats()),
                     runs=5, warmup=1)
        log(f"  process_linearity + collect, use_std={use_std}: {ms:.3f} ms "
            "(host clock, median of 5)")
        del got_series, cpu_series
    raise_failures("phase 8", failures)

    # --- phase 9: every energy form, card f32 against CPU f64 --------------
    p_crop, s_cand, n_pairs = 65536, 75, N * (N - 1) // 2
    log(f"phase 9: energies on a {p_crop}-pixel crop, {C} channels, {N} "
        f"exposures, S = {s_cand} candidates; card f32 against CPU f64")
    dn_full = np.round(vals_np * 255).astype(np.int32).reshape(
        N, H * W, C).transpose(2, 1, 0)                       # (C, P, N)
    std_full = stds_np.reshape(N, H * W, C).transpose(2, 1, 0)
    mean_icrf, pca = gamma_basis()
    rng = np.random.default_rng(SEED + 9)
    # 40 gamma curves, feasible, and 35 members of a DE population's
    # first generation, most of them infeasible
    x = np.linspace(0, 1, 256)
    curves = np.concatenate([
        x ** rng.uniform(1.6, 3.0, (C, 40, 1)),
        mean_icrf + rng.uniform(-1, 1, (C, s_cand - 40, 5)) @ pca.T],
        axis=1)                                               # (C, S, dp)
    pinned = lin.pin_endpoints(torch.as_tensor(curves))
    infeasible = lin.monotonicity_penalty_mask(pinned)
    log(f"  infeasible candidates: {int(infeasible.sum())} of "
        f"{infeasible.numel()}")
    if infeasible.all() or not infeasible.any():
        raise AssertionError("phase 9 needs feasible and infeasible "
                             "candidates")
    ii, jj = lin.upper_triangle_pairs(N)
    t_exp = np.asarray(t_np, float)

    def inputs(device, dtype):
        return (torch.as_tensor(curves, device=device, dtype=dtype),
                torch.as_tensor(dn_full[:, :p_crop], device=device),
                torch.as_tensor(std_full[:, :p_crop], device=device,
                                dtype=dtype),
                torch.as_tensor(t_exp, device=device, dtype=dtype))
    g_c, g_dn, g_std, g_t = inputs(dev, torch.float32)
    c_c, c_dn, c_std, c_t = inputs("cpu", torch.float64)
    failures = []
    g_h = lin.pair_dn_histograms(g_dn, ii, jj, 256)
    c_h = lin.pair_dn_histograms(c_dn, ii, jj, 256)
    if not torch.equal(g_h.cpu(), c_h):
        failures.append("pair_dn_histograms not equal")
    log(f"  {'ok ' if torch.equal(g_h.cpu(), c_h) else 'BAD'} "
        f"pair_dn_histograms {tuple(g_h.shape)} equal, "
        f"{int(c_h.sum())} counts")
    for penalty in ("soft", "hard"):
        for w_std in (True, False):
            want = lin.population_linearity_energies_chunked(
                c_c, c_dn, c_std if w_std else None, c_t, 5, 250, ii, jj,
                penalty=penalty, chunk=8192)
            got = lin.population_linearity_energies(
                g_c, g_dn, g_std if w_std else None, g_t, 5, 250, ii, jj,
                penalty=penalty)
            compare(f"onehot (whole stack), {penalty}, std={w_std}", got,
                    want, ENERGY_TOL, failures)
            got = lin.population_linearity_energies_chunked(
                g_c, g_dn, g_std if w_std else None, g_t, 5, 250, ii, jj,
                penalty=penalty, chunk=10007)
            compare(f"chunked (chunk 10007), {penalty}, std={w_std}", got,
                    want, ENERGY_TOL, failures)
            if not w_std:
                got = lin.population_linearity_energies_hist(
                    g_c, g_h, g_t, 5, 250, ii, jj, penalty=penalty)
                compare(f"hist, {penalty}", got, want, ENERGY_TOL, failures)
    feasible = curves[~infeasible.numpy()].reshape(-1, 256)[:C]  # (C, dp)

    def smooth(c, h, t):
        leaf = c.clone().requires_grad_(True)
        e = lin.linearity_energy_hist_smooth(leaf, h, t, 5, 250, ii, jj)
        grad, = torch.autograd.grad(e.sum(), leaf)
        return e.detach(), grad
    g_e, g_g = smooth(torch.as_tensor(feasible, device=dev,
                                      dtype=torch.float32), g_h, g_t)
    c_e, c_g = smooth(torch.as_tensor(feasible), c_h, c_t)
    compare("smooth energy", g_e, c_e, ENERGY_TOL, failures)
    scale = c_g.abs().max().item()
    gap = ((g_g.double().cpu() - c_g).abs().max() / scale).item()
    log(f"  smooth energy gradient: max |card - CPU| / max |grad| = "
        f"{gap:.3e} (max |grad| {scale:.3e})")
    compare("smooth energy gradient", g_g, c_g, ENERGY_TOL, failures)
    del g_c, g_dn, g_std, c_c, c_dn, c_std
    raise_failures("phase 9", failures)

    # --- phase 10: the config-4 solve -----------------------------------
    stacks, exposures, mean4, pca4 = config4_problem()
    log(f"phase 10: config-4 ICRF solve ({stacks.shape[0]} channels, "
        f"{stacks.shape[1]} pixels, {stacks.shape[2]} exposures, popsize "
        "15, maxiter 1000, tol 0.01, seed 7, default refinement and "
        "polish)")
    if torch.get_float32_matmul_precision() != "highest" or \
            torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 is on: the ICRF matvec must run in "
                             "full float32")
    stages = []
    solver = cal.differential_evolution_batched

    def recording_solver(*args, **kwargs):
        res, frozen = solver(*args, **kwargs)
        stages.append((res.n_iter, frozen.tolist()))
        return res, frozen
    cal.differential_evolution_batched = recording_solver
    cfg4 = CameraConfig(num_of_chs=3, datapoints=256)
    channel_stacks = channel_stacks_from_numpy(stacks, None, exposures,
                                               device=dev)
    pca_t, mean_t = pca_from_numpy(np.stack([pca4] * 3),
                                   np.stack([mean4] * 3), device=dev)

    def solve4():
        out = cal.calibration(-1.0, 1.0, channel_stacks=channel_stacks,
                              pca_arrays=pca_t, mean_icrf_arrays=mean_t,
                              config=cfg4, popsize=15, maxiter=1000,
                              tol=0.01, rng_seed=7, return_params=True)
        torch.cuda.synchronize()
        return out
    t0 = time.perf_counter()
    solve4()
    cold_s = time.perf_counter() - t0
    stages.clear()
    t0 = time.perf_counter()
    icrf4, e_init, e_final, _, params4 = solve4()
    warm_s = time.perf_counter() - t0
    log(f"  cold {cold_s:.4f} s, warm {warm_s:.4f} s (host clock, the whole "
        "calibration() call)")
    for name, (nit, frozen) in zip(("global", "refine 1", "refine 2"),
                                   stages):
        log(f"  {name}: {nit} generations, channels froze at {frozen}")
    log(f"  energies: initial {e_init.tolist()}, final {e_final.tolist()}")
    failures = []
    x = np.linspace(0, 1, 256)
    for c, gamma in enumerate(CAL_GAMMAS):
        oracle = reference_energy(params4[c], mean4, pca4,
                                  stacks[c][:, None, :], None, 5, 250, True,
                                  exposures, 256)
        err = np.max(np.abs(icrf4[:, c] - x ** gamma))
        rel = abs(e_final[c] - oracle) / oracle
        log(f"  channel {c}: final {e_final[c]:.8f}, oracle {oracle:.8f} "
            f"(rel gap {rel:.2e}), max |icrf - x**{gamma}| {err:.4f}")
        if not rel <= ORACLE_RTOL:
            failures.append(f"channel {c} energy against the oracle")
        if not e_final[c] < e_init[c]:
            failures.append(f"channel {c} energy did not fall")
        if not err < CURVE_ATOL:
            failures.append(f"channel {c} curve")
    raise_failures("phase 10", failures)
    g_ii = torch.as_tensor(ii, device=dev).long()
    g_jj = torch.as_tensor(jj, device=dev).long()
    profile_generation(
        "whole-stack form (config 4)",
        cal._make_population_energy(True, "soft", 5, 250, 256, False),
        (pca_t, mean_t, channel_stacks[0], channel_stacks[2], g_ii, g_jj))

    # --- phase 11: full resolution at config-2 geometry -------------------
    log(f"phase 11: calibration at full resolution ({C} x {H * W} pixels x "
        f"{N} exposures)")
    made = []
    factories = {name: getattr(cal, name) for name in (
        "_make_population_energy", "_make_population_energy_hist",
        "_make_population_energy_chunked")}
    for name, factory in factories.items():
        def recorder(*args, _name=name, _fn=factory):
            made.append(_name)
            return _fn(*args)
        setattr(cal, name, recorder)
    cfg2 = CameraConfig(num_of_chs=C, datapoints=256)
    full = dict(pca_arrays=pca_t, mean_icrf_arrays=mean_t, config=cfg2)
    stacks_u = channel_stacks_from_numpy(dn_full, None, t_exp, device=dev)
    stages.clear()
    t0 = time.perf_counter()
    _, e0_u, e1_u, _ = cal.calibration(-1.0, 1.0, channel_stacks=stacks_u,
                                       **full)
    torch.cuda.synchronize()
    wall_u = time.perf_counter() - t0
    log(f"  unweighted, energy_form auto -> {made}: {wall_u:.4f} s "
        f"(histogram build included); generations per stage "
        f"{[n for n, _ in stages]}; energies {e0_u.tolist()} -> "
        f"{e1_u.tolist()}")
    # the first energy made is the DE objective; the polish makes the
    # histogram form again for its acceptance test
    failures = []
    if made[0] != "_make_population_energy_hist":
        failures.append(f"auto picked {made[0]}, not the histogram form")
    if not np.all(e1_u < e0_u):
        failures.append("unweighted energies did not fall")
    stacks_w = channel_stacks_from_numpy(dn_full, std_full, t_exp,
                                         device=dev)
    made.clear()
    stages.clear()
    t0 = time.perf_counter()
    _, e0_w, e1_w, _ = cal.calibration(
        -1.0, 1.0, channel_stacks=stacks_w, energy_form="chunked",
        maxiter=10, tol=0.0, refine_rounds=0, polish_steps=0, **full)
    torch.cuda.synchronize()
    wall_w = time.perf_counter() - t0
    gens = stages[0][0]
    log(f"  std-weighted, chunked: {wall_w:.4f} s for {gens} generations "
        f"and the initial energies, {wall_w / (gens + 1) * 1e3:.1f} ms per "
        f"generation; energies {e0_w.tolist()} -> {e1_w.tolist()}")
    if made != ["_make_population_energy_chunked"] or \
            not np.all(e1_w <= e0_w):
        failures.append(f"std-weighted solve: {made}, {e0_w} -> {e1_w}")
    raise_failures("phase 11", failures)
    cal.differential_evolution_batched = solver
    for name, factory in factories.items():
        setattr(cal, name, factory)

    # one generation of each form under the profiler
    hists = lin.pair_dn_histograms(stacks_u[0], ii, jj, 256)
    profile_generation(
        "hist (unweighted)",
        cal._make_population_energy_hist(True, "soft", 5, 250, 256),
        (pca_t, mean_t, hists, stacks_u[2], g_ii, g_jj))
    profile_generation(
        "chunked (std-weighted)",
        cal._make_population_energy_chunked(True, "soft", 5, 250, 256,
                                            True, 16384),
        (pca_t, mean_t, stacks_w[0], stacks_w[2], g_ii, g_jj, stacks_w[1]))
    del stacks_u, stacks_w, hists


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from camera_linearity_tpu_torch import CameraConfig, csrc
    from camera_linearity_tpu_torch.models.exposure_series import \
        ExposureSeries
    from camera_linearity_tpu_torch.models.image_set import ImageSet
    from camera_linearity_tpu_torch.ops import filters, hdr, hdr_cuda
    from camera_linearity_tpu_torch.utils.state import (
        icrf_tables_from_numpy, measurand_from_numpy)

    # --- phase 1: the card ------------------------------------------------
    dev = torch.device("cuda")
    gpu = gpu_line()
    log(gpu)
    log(f"torch {torch.__version__}, cuda {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}, "
        f"count {torch.cuda.device_count()}")

    # --- phase 2: build ---------------------------------------------------
    t0 = time.perf_counter()
    lib_paths = csrc.build()
    for name in lib_paths:
        csrc.library(name)
    log(f"build: {time.perf_counter() - t0:.1f} s")
    for name, path in lib_paths.items():
        log(f"  {name}: {path}")

    rng = np.random.default_rng(SEED)
    t_np, vals_np, stds_np, darks_np, flat_np, flat_std_np = make_inputs(rng)
    base_np, diff_base_np, icrf_np, diff_np = make_tables()
    exposures = torch.as_tensor(t_np, device=dev)
    val = torch.as_tensor(vals_np, device=dev)
    std = torch.as_tensor(stds_np, device=dev)
    dark = torch.as_tensor(darks_np, device=dev)
    icrf8, diff8, _, _ = icrf_tables_from_numpy(base_np, diff_base_np,
                                                device=dev)
    icrf12, diff12, base, diff_base = icrf_tables_from_numpy(
        icrf_np, diff_np, base_np, diff_base_np, device=dev)
    thr = torch.tensor(CameraConfig().dark_threshold, dtype=torch.float32)
    res = Results()

    # --- phase 3: K1 against its plain version, through merge_hdr --------
    log("K1 merge_nhwc_fused vs merge_fused_plain (config 2)")
    for compat in ("corrected", "reference"):
        for s in (std, None):
            res.check("merge_nhwc_fused", f"{compat}, std={s is not None}",
                      hdr.merge_hdr(val, s, exposures, icrf8, diff8, compat),
                      hdr_cuda.merge_fused_plain(val, s, exposures, icrf8,
                                                 diff8, compat))
    dn = torch.round(val * 255).to(torch.uint8)
    res.check("merge_nhwc_fused", "uint8 DNs",
              hdr.merge_hdr(dn, std, exposures, icrf8, diff8),
              hdr_cuda.merge_fused_plain(dn, std, exposures, icrf8, diff8))
    res.check("merge_nhwc_fused", "4096-entry exact tables",
              hdr.merge_hdr(val, std, exposures, icrf12, diff12),
              hdr_cuda.merge_fused_plain(val, std, exposures, icrf12,
                                         diff12))
    batch_v = torch.stack([val, val.flip(1)])
    batch_s = torch.stack([std, std.flip(1)])
    res.check("merge_nhwc_fused", "merge_batch B=2",
              hdr.merge_batch(batch_v, batch_s, exposures, icrf8, diff8),
              hdr_cuda.merge_fused_plain(batch_v, batch_s, exposures, icrf8,
                                         diff8))
    del batch_v, batch_s, dn

    # --- phase 4: K2 against its plain version, through merge_hdr --------
    log("K2 merge_nhwc_lerp vs merge_lerp_plain (config 3 tables)")
    for compat in ("corrected", "reference"):
        for s in (std, None):
            res.check("merge_nhwc_lerp", f"{compat}, std={s is not None}",
                      hdr.merge_hdr(val, s, exposures, icrf12, diff12,
                                    compat, icrf_base=base,
                                    icrf_diff_base=diff_base),
                      hdr_cuda.merge_lerp_plain(val, s, exposures, base,
                                                diff_base, 4096, compat))
    sv, ss = (x[:, :37, :53].contiguous() for x in (val, std))
    res.check("merge_nhwc_lerp", "37 x 53 crop (copy route)",
              hdr_cuda.merge_nhwc_lerp(sv, ss, exposures, base, diff_base,
                                       4096),
              hdr_cuda.merge_lerp_plain(sv, ss, exposures, base, diff_base,
                                        4096))

    # --- phase 5: K3 against its plain version, through merge_corrected --
    log("K3 merge_nhwc_lerp_bp vs merge_lerp_bp_plain (config 3)")
    mask = filters.hot_pixel_mask(dark, thr)
    log(f"  hot pixels: {mask.float().mean().item() * 100:.3f} %")
    for label, d in (("float darks", dark), ("uint8 mask", mask)):
        res.check("merge_nhwc_lerp_bp", f"{label}, 256-entry tables",
                  hdr.merge_corrected(val, std, d, exposures, icrf8, diff8,
                                      thr),
                  hdr_cuda.merge_lerp_bp_plain(val, std, d, exposures,
                                               icrf8, diff8, thr, 256))
        res.check("merge_nhwc_lerp_bp", f"{label}, 4096-entry tables",
                  hdr.merge_corrected(val, std, d, exposures, icrf12,
                                      diff12, thr, icrf_base=base,
                                      icrf_diff_base=diff_base),
                  hdr_cuda.merge_lerp_bp_plain(val, std, d, exposures, base,
                                               diff_base, thr, 4096))
    sv, ss, sd = (x[:, :37, :53].contiguous() for x in (val, std, dark))
    res.check("merge_nhwc_lerp_bp", "37 x 53 crop (copy route)",
              hdr.merge_corrected(sv, ss, sd, exposures, icrf12, diff12, thr,
                                  icrf_base=base, icrf_diff_base=diff_base),
              hdr_cuda.merge_lerp_bp_plain(sv, ss, sd, exposures, base,
                                           diff_base, thr, 4096))
    del mask
    torch.cuda.synchronize()

    # --- phase 6: the entry points, launch counts reset -------------------
    log("main path: merge_hdr (config 2), merge_hdr with base curves and "
        "process_HDR_image (config 3)")
    cfg = CameraConfig(bit_depth=12, compat_mode="corrected")
    assert min(EXPOSURES_MS) / 1000 >= cfg.dark_threshold

    def series(device, dtype):
        sets = [ImageSet(f"{ms}ms BF sample 50x.tif", config=cfg,
                         device=device,
                         measurand=measurand_from_numpy(
                             vals_np[e], stds_np[e], device=device,
                             dtype=dtype))
                for e, ms in enumerate(EXPOSURES_MS)]
        # 40 ms matches exactly; 80 ms takes the 100 ms dark scaled down;
        # the longer exposures have no dark (no repair), as in the reference
        darks = [ImageSet(f"{ms}ms BF dark 50x.tif", config=cfg,
                          device=device,
                          measurand=measurand_from_numpy(
                              darks_np[e], device=device, dtype=dtype))
                 for e, ms in ((0, 40), (1, 100))]
        flat = ImageSet("BF flat 50x.tif", config=cfg, device=device,
                        measurand=measurand_from_numpy(
                            flat_np, flat_std_np, device=device,
                            dtype=dtype))
        return ExposureSeries(input_image_sets=sets, config=cfg), darks, flat

    gpu_series, gpu_darks, gpu_flat = series(dev, torch.float32)
    for k in hdr_cuda.KERNELS:
        k.launches = 0
    out_k1 = hdr.merge_hdr(val, std, exposures, icrf8, diff8)
    out_k2 = hdr.merge_hdr(val, std, exposures, icrf12, diff12,
                           icrf_base=base, icrf_diff_base=diff_base)
    k3_before = hdr_cuda.merge_nhwc_lerp_bp.launches
    hdr_set = gpu_series.process_HDR_image(
        ICRF=icrf12, ICRF_diff=diff12, ICRF_base=base,
        ICRF_diff_base=diff_base, list_of_dark_fields=gpu_darks,
        flat_field=gpu_flat)
    k3_delta = hdr_cuda.merge_nhwc_lerp_bp.launches - k3_before
    torch.cuda.synchronize()
    launches = {k.__name__: k.launches for k in hdr_cuda.KERNELS}
    log(f"  launches: {launches}")
    if k3_delta != 1:
        raise AssertionError(f"process_HDR_image launched K3 {k3_delta} "
                             "times, expected 1")
    for name, count in launches.items():
        if count < 1:
            raise AssertionError(f"{name} was not launched by the main path")

    res.check(None, "merge_hdr config 2 vs merge_fused_plain", out_k1,
              hdr_cuda.merge_fused_plain(val, std, exposures, icrf8, diff8))
    res.check(None, "merge_hdr base curves vs merge_lerp_plain", out_k2,
              hdr_cuda.merge_lerp_plain(val, std, exposures, base, diff_base,
                                        4096))
    gv, gs = hdr_set.measurand.val, hdr_set.measurand.std
    for name, x in (("val", gv), ("std", gs)):
        if tuple(x.shape) != (H, W, C) or not torch.isfinite(x).all():
            raise AssertionError(f"process_HDR_image {name}: shape "
                                 f"{tuple(x.shape)} or non-finite values")
    t0 = time.perf_counter()
    cpu_series, cpu_darks, cpu_flat = series("cpu", torch.float32)
    c8, cd8, cbase, cdbase = icrf_tables_from_numpy(
        icrf_np, diff_np, base_np, diff_base_np, device="cpu",
        dtype=torch.float32)
    cpu_set = cpu_series.process_HDR_image(
        ICRF=c8, ICRF_diff=cd8, ICRF_base=cbase, ICRF_diff_base=cdbase,
        list_of_dark_fields=cpu_darks, flat_field=cpu_flat)
    log(f"  CPU reference run: {time.perf_counter() - t0:.1f} s")
    res.check(None, "process_HDR_image card vs CPU (f32, plain path)",
              (gv.cpu(), gs.cpu()),
              (cpu_set.measurand.val, cpu_set.measurand.std),
              E2E_VAL_TOL, E2E_STD_TOL)
    del cpu_series, cpu_set, out_k1, out_k2

    # --- phase 7: kernel and plain times ----------------------------------
    log("times (median of CUDA-event samples, plain and kernel in turns; "
        "MP/s = H*W per second; GB/s = bytes the merge must move; bound = "
        "those bytes at 3.35 TB/s or its f32 operations at 67 TFLOP/s, the "
        "larger; copy = a device-to-device copy_ moving the same bytes)")
    for name, path in lib_paths.items():
        log(f"  registers and spills, {name}.cu (ptxas):")
        for line in (path.parent / "ptxas.log").read_text().splitlines():
            if any(k in line for k in ("Compiling entry", "Used", "spill")):
                log(f"    {line.strip()}")
    plane = H * W * C * 4
    cases = {  # name: (kernel, plain, bytes read and written)
        "merge_nhwc_fused": (
            lambda: hdr_cuda.merge_nhwc_fused(val, std, exposures, icrf8,
                                              diff8),
            lambda: hdr_cuda.merge_fused_plain(val, std, exposures, icrf8,
                                               diff8),
            (2 * N + 2) * plane),
        "merge_nhwc_lerp": (
            lambda: hdr_cuda.merge_nhwc_lerp(val, std, exposures, base,
                                             diff_base, 4096),
            lambda: hdr_cuda.merge_lerp_plain(val, std, exposures, base,
                                              diff_base, 4096),
            (2 * N + 2) * plane),
        "merge_nhwc_lerp_bp": (
            lambda: hdr_cuda.merge_nhwc_lerp_bp(val, std, dark, exposures,
                                                base, diff_base, thr, 4096),
            lambda: hdr_cuda.merge_lerp_bp_plain(val, std, dark, exposures,
                                                 base, diff_base, thr,
                                                 4096),
            (3 * N + 2) * plane),
    }
    times = {}
    for name, (kernel, plain, nbytes) in cases.items():
        # a copy reads and writes its bytes: half the merge's, each way
        src = torch.empty(nbytes // 8, dtype=torch.float32, device=dev)
        dst = torch.empty_like(src)

        def copy():
            dst.copy_(src)
        k_s, p_s, c_s = [], [], []
        for fn, out in ((plain, p_s), (copy, c_s), (kernel, k_s),
                        (kernel, k_s), (copy, c_s), (plain, p_s)):
            out += time_samples(fn, runs=10, reps=2 if fn is plain else 10)
        del src, dst
        k_ms, p_ms, c_ms = (float(np.median(x)) for x in (k_s, p_s, c_s))
        bytes_ms = nbytes / PEAK_BYTES_S * 1e3
        ops_ms = OPS_PER_ELEMENT * N * H * W * C / PEAK_F32_S * 1e3
        bound_ms = max(bytes_ms, ops_ms)
        times[name] = dict(
            ms=k_ms, plain_ms=p_ms, copy_ms=c_ms, bytes=nbytes,
            bound_ms=bound_ms,
            bound_by="bytes" if bytes_ms >= ops_ms else "operations",
            share=bound_ms / k_ms)
        log(f"  {name}: kernel {k_ms:.4f} ms ({H * W / k_ms / 1e3:.1f} "
            f"MP/s, {nbytes / k_ms / 1e6:.1f} GB/s of {nbytes / 1e6:.0f} "
            f"MB), bound {bound_ms:.4f} ms ({times[name]['bound_by']}; "
            f"{times[name]['share'] * 100:.1f} % of it), copy {c_ms:.4f} ms "
            f"({c_ms / k_ms * 100:.1f} % of the kernel's time), plain "
            f"{p_ms:.4f} ms ({H * W / p_ms / 1e3:.1f} MP/s); kernel samples "
            f"{min(k_s):.4f}-{max(k_s):.4f} ms")

    # end to end: the host clock around process_HDR_image on the card
    def merge_e2e():
        return gpu_series.process_HDR_image(
            ICRF=icrf12, ICRF_diff=diff12, ICRF_base=base,
            ICRF_diff_base=diff_base, list_of_dark_fields=gpu_darks,
            flat_field=gpu_flat)
    e2e_ms = host_ms(merge_e2e)
    log(f"  process_HDR_image (config 3, end to end): {e2e_ms:.4f} ms "
        f"({H * W / e2e_ms / 1e3:.1f} MP/s)")
    profile_breakdown("process_HDR_image (config 3)", merge_e2e,
                      by_kernel=True)
    del gpu_series, gpu_darks, gpu_flat, val, std, dark
    torch.cuda.empty_cache()

    linearity_phases(dev, t_np, vals_np, stds_np)

    # no single PyTorch call computes the merge: no library yardstick
    kernels = [{"name": name, "route": "cuda", "source": SOURCES[name],
                "replaces": REPLACES[name], "launches": launches[name],
                "max_abs_err": res.err[name], **times[name],
                "library_ms": None} for name in REPLACES]
    log(gpu)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
