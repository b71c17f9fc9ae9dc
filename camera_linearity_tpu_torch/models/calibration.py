"""ICRF calibration: population-batched differential evolution.

Port of ``camera_linearity_tpu/models/calibration.py``.  The reference
steps SciPy's ``DifferentialEvolutionSolver`` from Python, one candidate at
a time per channel in joblib worker processes (reference:
modules/ICRF_calibration_exposure.py:288-402).  Here every channel's whole
population evaluates as one batched energy per generation, a (C, S)
computation on the solve's device.

DE semantics follow SciPy's ``strategy='currenttobest1bin'`` with
``updating='deferred'``: per-generation dithered mutation factor, binomial
crossover with a guaranteed crossover point, out-of-bounds trial components
resampled uniformly, greedy selection.  The reference's convergence rule is
kept: stop when std(E) <= tol * |mean(E)|, at ``maxiter`` generations, or
when the best energy falls below ``energy_limit``
(ICRF_calibration_exposure.py:357-370).

The JAX package runs the whole solve as one ``lax.while_loop``; here the
generation loop runs on the host, but a generation is a sequence of tensor
operations with no host read: the convergence test stays on the device and
the host reads the done flags every ``SYNC_EVERY`` generations.  Converged
channels are frozen, and a generation counts only while some channel is
live, so the population, ``n_iter`` and ``frozen_at`` equal those of a
per-generation check.

Each generation splits into drawing (:func:`draw_generation`, from one
``torch.Generator`` per channel, seeded ``seed + c``) and a pure step
(:func:`evolve_population`) that takes the draws as arguments, so a test
can feed the JAX package's own draws into the step.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..config import CameraConfig, DEFAULT_CONFIG
from ..ops import linearity as lin_ops
from ..ops.linearize import interpolate_curve
from ..parallel import distributed as pdist
from ..parallel.mesh import axis_size, block_of, mesh_device
from ..utils import general as gf
from ..utils import io
from ..utils.checkpoint import DECheckpoint
from ..utils.device import canonical_float, resolve_device
from .icrf import icrf_from_params
from .image_set import ImageSet

Tensor = torch.Tensor

__all__ = ["DEResult", "Draws", "draw_generation", "evolve_population",
           "differential_evolution", "differential_evolution_batched",
           "calibration", "initialize_channel_image_stacks",
           "sobol_init_population"]

# generations between two host reads of the done flags and the counter
SYNC_EVERY = 8


@dataclass
class DEResult:
    """Solver output: best member + full final state."""
    x: Tensor                # (..., D) best parameters (denormalized)
    energy: Tensor           # (...) best energy
    population: Tensor       # (..., S, D) final population (denormalized)
    energies: Tensor         # (..., S) final energies
    n_iter: int
    converged: bool
    initial_energy: Tensor   # (...) best energy of the initial population


def sobol_init_population(num_members: int, num_params: int,
                          seed) -> np.ndarray:
    """Sobol' sequence init in the normalized [0,1]^D space, bit-exact with
    SciPy's ``init='sobol'`` (``init_population_qmc``: ``qmc.Sobol(d,
    seed=rng).random(n)``; reference solve loop
    ICRF_calibration_exposure.py:357-370 with ``seed=<int>``).

    SciPy seeds the sampler with the solver's ``RandomState``, not the raw
    int, and an int seed here goes through the same conversion; drawing the
    next power-of-two block and truncating gives the same point set as
    ``random(n)`` without SciPy's balance-properties warning.
    """
    from scipy.stats import qmc
    rng = np.random.RandomState(seed) if isinstance(seed, (int, np.integer)) \
        else seed
    sampler = qmc.Sobol(d=num_params, seed=rng)
    m = max(1, int(np.ceil(np.log2(num_members))))
    return sampler.random_base2(m)[:num_members]


class Draws(NamedTuple):
    """One generation's random draws for C solvers of S members in D
    dimensions."""
    scale: Tensor     # (C,) dithered mutation factor
    r0: Tensor        # (C, S) member index, != i
    r1: Tensor        # (C, S) member index, != i, != r0
    cross: Tensor     # (C, S, D) uniform < recombination
    fill: Tensor      # (C, S) the guaranteed crossover point
    resample: Tensor  # (C, S, D) uniform values for out-of-bounds entries


def draw_generation(generators: List[torch.Generator], s: int, d: int,
                    mutation: Tuple[float, float], recombination: float,
                    dtype: torch.dtype) -> Draws:
    """Draw one generation: solver c draws from ``generators[c]``, one
    float64 ``uniform_`` row each, from which the indices come by
    flooring.  ``r0`` is uniform over the members other than i, ``r1``
    over those other than i and r0, as in the JAX package."""
    c = len(generators)
    dev = generators[0].device
    u = torch.empty((c, 1 + 3 * s + 2 * s * d), dtype=torch.float64,
                    device=dev)
    for row, gen in zip(u, generators):
        row.uniform_(generator=gen)

    def ints(col: int, n: int) -> Tensor:
        return (u[:, col:col + s] * n).long().clamp_max(n - 1)

    m_lo, m_hi = mutation
    i = torch.arange(s, device=dev)
    a, b, fill = ints(1, s - 1), ints(1 + s, s - 2), ints(1 + 2 * s, d)
    r0 = a + (a >= i).long()
    lo, hi = torch.minimum(i, r0), torch.maximum(i, r0)
    r1 = b + (b >= lo).long()
    r1 = r1 + (r1 >= hi).long()
    rest = u[:, 1 + 3 * s:].reshape(c, 2, s, d)
    return Draws(scale=(m_lo + (m_hi - m_lo) * u[:, 0]).to(dtype),
                 r0=r0, r1=r1, cross=rest[:, 0] < recombination, fill=fill,
                 resample=rest[:, 1].to(dtype))


def evolve_population(pop: Tensor, energies: Tensor, draws: Draws) -> Tensor:
    """Trial population from given draws: pop (C, S, D), energies (C, S).

    currenttobest1bin per member i (reference solve loop
    ICRF_calibration_exposure.py:357-370): mutant = x_i + F (x_best - x_i
    + x_r0 - x_r1), binomial crossover with one guaranteed point, and
    out-of-[0,1] components resampled uniformly (SciPy
    _ensure_constraint).  Members are read by an indexed gather, where the
    JAX package multiplies one-hot matrices on the TPU.
    """
    d = pop.shape[-1]

    def rows(idx: Tensor) -> Tensor:
        return torch.gather(pop, -2, idx[..., None].expand(*idx.shape, d))

    best = rows(torch.argmin(energies, dim=-1, keepdim=True))   # (C, 1, D)
    mutant = pop + draws.scale[:, None, None] * (
        best - pop + rows(draws.r0) - rows(draws.r1))
    cross = draws.cross | (torch.arange(d, device=pop.device)
                           == draws.fill[..., None])
    trial = torch.where(cross, mutant, pop)
    return torch.where((trial < 0.0) | (trial > 1.0), draws.resample, trial)


def _batched_energy(energy_fn: Callable, population_energy: bool,
                    channel_data: Tuple) -> Callable[[Tensor], Tensor]:
    """(C, S, D) parameters -> (C, S) energies.

    With ``population_energy`` the function takes the whole batch:
    ``energy_fn(params (C, S, D), *channel_data) -> (C, S)``.  Otherwise
    ``energy_fn(params (D,), *data_c) -> scalar`` is mapped over members
    and channels with ``torch.func.vmap``; each element of
    ``channel_data`` has a leading channel axis, or is None.
    """
    if population_energy:
        return lambda params: energy_fn(params, *channel_data)
    shared = (None,) * len(channel_data)
    per_member = torch.func.vmap(energy_fn, in_dims=(0,) + shared)
    per_channel = torch.func.vmap(
        per_member,
        in_dims=(0,) + tuple(None if x is None else 0 for x in channel_data))
    return lambda params: per_channel(params, *channel_data)


class _State(NamedTuple):
    pop: Tensor        # (C, S, D) normalized
    energies: Tensor   # (C, S)
    nit: Tensor        # () generations while some channel was live
    done: Tensor       # (C,) bool
    frozen_at: Tensor  # (C,) generation at which each channel converged


def _generation(state: _State, energy: Callable[[Tensor], Tensor],
                generators: List[torch.Generator],
                mutation: Tuple[float, float], recombination: float,
                tol: float, energy_limit: float) -> _State:
    """One generation of every channel, with no host read."""
    pop, energies, nit, done, frozen_at = state
    _, s, d = pop.shape
    draws = draw_generation(generators, s, d, mutation, recombination,
                            pop.dtype)
    trials = evolve_population(pop, energies, draws)
    trial_energies = energy(trials)
    live = ~torch.all(done)
    accept = (trial_energies < energies) & ~done[:, None] & live
    pop = torch.where(accept[..., None], trials, pop)
    energies = torch.where(accept, trial_energies, energies)
    nit = nit + live.long()

    finite = torch.all(torch.isfinite(energies), dim=-1)
    e_mean = torch.where(finite, torch.mean(energies, dim=-1), math.inf)
    e_std = torch.where(finite, torch.std(energies, dim=-1, correction=0),
                        math.inf)
    newly_done = (e_std <= tol * torch.abs(e_mean)) | \
        (torch.amin(energies, dim=-1) < energy_limit)
    frozen_at = torch.where(~done & newly_done, nit, frozen_at)
    return _State(pop, energies, nit, done | newly_done, frozen_at)


def _progress(state: _State) -> Tuple[int, bool]:
    """(generation counter, all channels done): one host read."""
    nit, all_done = torch.stack([state.nit,
                                 torch.all(state.done).long()]).tolist()
    return nit, bool(all_done)


def _population_size(popsize: int, d: int, mesh, pop_axis: str) -> int:
    """S for ``popsize`` and D parameters, rounded up to a multiple of
    the mesh axis's length when the population shards over it."""
    s = max(5, popsize * d)
    if mesh is None:
        return s
    n_shards = axis_size(mesh, pop_axis)
    return -(-s // n_shards) * n_shards


def _resume(checkpoint_path, mesh):
    """The DE state to resume from (``DECheckpoint.try_load``), or None.
    With a mesh the process of rank 0, which writes the checkpoint, alone
    reads it and broadcasts the state to every process: a path on a disk
    of its own, or an older file on one host only, must not let the
    processes resume from different states."""
    if checkpoint_path is None:
        return None
    if mesh is None:
        return DECheckpoint.try_load(checkpoint_path)
    found = [DECheckpoint.try_load(checkpoint_path)
             if dist.get_rank() == 0 else None]
    dist.broadcast_object_list(found, src=0)
    return found[0]


def differential_evolution_batched(energy_fn: Callable,
                                   channel_data: Tuple,
                                   num_channels: int,
                                   num_params: int,
                                   bounds_lower, bounds_upper,
                                   x0: Optional[np.ndarray] = None,
                                   popsize: int = 15,
                                   mutation: Tuple[float, float] = (0.0, 1.95),
                                   recombination: float = 0.4,
                                   tol: float = 0.01,
                                   maxiter: int = 1000,
                                   energy_limit: float = 0.0,
                                   seed: int = 7,
                                   mesh=None, pop_axis: str = "data",
                                   checkpoint_path=None,
                                   checkpoint_every: int = 0,
                                   population_energy: bool = False,
                                   device=None):
    """All channels' DE solves, batched over channels and members.

    ``energy_fn`` and ``channel_data`` as :func:`_batched_energy` says.
    ``bounds_lower``/``bounds_upper``/``x0`` may be (D,) shared or (C, D)
    per channel (the refinement stages of :func:`calibration` re-solve each
    channel in a box around its own best).  ``device`` defaults to the
    device of the first tensor in ``channel_data`` (the card without one);
    the float type is that device's canonical one.  Converged channels
    freeze in place until every channel is done (the reference solves
    channels in separate joblib processes,
    ICRF_calibration_exposure.py:383-386).

    With ``checkpoint_path``, the state saves every ``checkpoint_every``
    generations (at the end when 0) and a solve resumes from a readable
    checkpoint found there.

    With ``mesh`` (parallel/mesh.py), the population shards over the
    mesh axis ``pop_axis``: S rounds up to a multiple of its length, as in
    the JAX package, so the population changes with the mesh.  Every
    process draws the whole generation from the same generators, evaluates
    the energies of its own slice of S only and gathers everyone's, so
    every process holds the same state.  Only the process of rank 0 writes
    the checkpoint, and only it reads one: it broadcasts what it found, so
    every process resumes from the same state or every one starts fresh.

    Returns a DEResult whose fields carry a leading channel axis, and the
    (C,) generation at which each channel froze (``maxiter`` when it did
    not, or when the solve resumed).
    """
    if device is None:
        device = next((x.device for x in channel_data
                       if isinstance(x, Tensor)), None)
    if device is None and mesh is not None:
        device = mesh_device(mesh)
    device = resolve_device(device)
    dtype = canonical_float(device)
    c, d = num_channels, num_params
    s = _population_size(popsize, d, mesh, pop_axis)
    lower_np = np.broadcast_to(np.asarray(bounds_lower, float), (c, d)).copy()
    upper_np = np.broadcast_to(np.asarray(bounds_upper, float), (c, d)).copy()
    lower = torch.as_tensor(lower_np, dtype=dtype, device=device)
    upper = torch.as_tensor(upper_np, dtype=dtype, device=device)

    def denorm(pop_norm: Tensor) -> Tensor:
        shape = (c,) + (1,) * (pop_norm.ndim - 2) + (d,)
        return lower.reshape(shape) + pop_norm * (upper - lower).reshape(
            shape)

    batched = _batched_energy(energy_fn, population_energy, channel_data)

    if mesh is None:
        def energy(pop_norm: Tensor) -> Tensor:
            return batched(denorm(pop_norm))
    else:
        group = mesh.get_group(pop_axis)
        mine = block_of(s, mesh, pop_axis, "members")

        def energy(pop_norm: Tensor) -> Tensor:
            local = batched(denorm(pop_norm[:, mine]))
            return torch.cat(pdist.all_gather(local, group), dim=1)

    generators = [torch.Generator(device).manual_seed(seed + ch)
                  for ch in range(c)]
    resumed = _resume(checkpoint_path, mesh)
    frozen0 = torch.full((c,), maxiter, device=device)
    if resumed is not None:
        pop_r, energies_r, gen_states, nit_r, done_r = resumed
        for gen, st in zip(generators, gen_states):
            gen.set_state(st)
        state = _State(pop_r.to(device, dtype), energies_r.to(device, dtype),
                       torch.tensor(nit_r, device=device),
                       done_r.to(device), frozen0)
    else:
        pops = np.stack([sobol_init_population(s, d, seed + ch)
                         for ch in range(c)])
        if x0 is not None:
            x0_np = np.broadcast_to(np.asarray(x0, float), (c, d))
            pops[:, 0] = np.clip((x0_np - lower_np) / (upper_np - lower_np),
                                 0, 1)
        pop0 = torch.as_tensor(pops, dtype=dtype, device=device)
        state = _State(pop0, energy(pop0), torch.tensor(0, device=device),
                       torch.zeros(c, dtype=torch.bool, device=device),
                       frozen0)
    e0 = torch.amin(state.energies, dim=-1)

    segment = checkpoint_every if (checkpoint_path is not None
                                   and checkpoint_every) else maxiter
    nit, all_done = _progress(state)
    while not all_done and nit < maxiter:
        end = min(maxiter, nit + segment)
        while not all_done and nit < end:
            for _ in range(min(SYNC_EVERY, end - nit)):
                state = _generation(state, energy, generators, mutation,
                                    recombination, tol, energy_limit)
            nit, all_done = _progress(state)
        if checkpoint_path is not None:
            if mesh is None or dist.get_rank() == 0:
                DECheckpoint.save(checkpoint_path, state.pop, state.energies,
                                  generators, nit, state.done)
            if mesh is not None:  # no process reads it before it is whole
                dist.barrier()

    best = torch.argmin(state.energies, dim=-1)
    ch = torch.arange(c, device=device)
    return DEResult(x=denorm(state.pop[ch, best][:, None])[:, 0],
                    energy=state.energies[ch, best],
                    population=denorm(state.pop), energies=state.energies,
                    n_iter=nit, converged=all_done,
                    initial_energy=e0), state.frozen_at


def differential_evolution(energy_fn: Callable[[Tensor], Tensor],
                           num_params: int, bounds_lower, bounds_upper,
                           x0: Optional[np.ndarray] = None,
                           popsize: int = 15,
                           mutation: Tuple[float, float] = (0.0, 1.95),
                           recombination: float = 0.4,
                           tol: float = 0.01,
                           maxiter: int = 1000,
                           energy_limit: float = 0.0,
                           seed: int = 7, device=None) -> DEResult:
    """One DE solve; ``energy_fn`` maps (D,) params -> scalar and is mapped
    over the population with ``torch.func.vmap``.  The batched solver with
    one channel, its generator seeded ``seed``, on ``device`` (by default
    the card)."""
    res, _ = differential_evolution_batched(
        energy_fn, (), 1, num_params, bounds_lower, bounds_upper, x0=x0,
        popsize=popsize, mutation=mutation, recombination=recombination,
        tol=tol, maxiter=maxiter, energy_limit=energy_limit, seed=seed,
        device=device)
    return DEResult(x=res.x[0], energy=res.energy[0],
                    population=res.population[0], energies=res.energies[0],
                    n_iter=res.n_iter, converged=res.converged,
                    initial_energy=res.initial_energy[0])


# ---------------------------------------------------------------------------
# calibration entry point (reference ICRF_calibration_exposure.py:219-402)
# ---------------------------------------------------------------------------

def initialize_channel_image_stacks(image_path: Path, use_std: bool,
                                    data_spacing,
                                    config: CameraConfig = DEFAULT_CONFIG,
                                    device=None):
    """Load, stride-subsample and stack calibration images per channel
    (ICRF_calibration_exposure.py:219-285).

    Returns (value_stacks (C, P, N) integer DNs, std_stacks (C, P, N) or
    None, exposures (N,), pixel_ratio), as tensors on ``device`` (by
    default the card).
    """
    device = resolve_device(device)
    sets = ImageSet.multiple_from_path(image_path, config=config,
                                       device=device)
    sets.sort(key=lambda s: s.features["exposure"])
    if isinstance(data_spacing, tuple):
        x_step, y_step = data_spacing
    else:
        x_step = y_step = data_spacing

    vals, stds, exposures = [], [], []
    for s in sets:
        exposures.append(s.features["exposure"])
        s.load_value_image(bit64=True)
        if use_std:
            s.load_std_image()
        v = gf.choose_evenly_spaced_points(s.measurand.val, x_step, y_step)
        vals.append(v.reshape(-1, v.shape[-1]))
        if use_std:
            st = gf.choose_evenly_spaced_points(s.measurand.std, x_step,
                                                y_step)
            stds.append(st.reshape(-1, st.shape[-1]))
        s.release()

    # (N, P, C) -> (C, P, N); raw DNs load as whole floats
    value_stacks = torch.stack(vals).permute(2, 1, 0).long()
    std_stacks = torch.stack(stds).permute(2, 1, 0) if use_std else None
    full = config.im_size_x * config.im_size_y
    pixel_ratio = value_stacks.shape[1] / full if full else 0.0
    return (value_stacks, std_stacks,
            torch.tensor(exposures, dtype=canonical_float(device),
                         device=device), pixel_ratio)


def _curves(params, pca, mean, use_mean, datapoints):
    return icrf_from_params(params, pca, mean if use_mean else None,
                            datapoints=datapoints)


def _make_population_energy(use_mean: bool, penalty: str, lower_dn: int,
                            upper_dn: int, datapoints: int, with_std: bool):
    """Channel-batched energy over the whole DN stack (the JAX package's
    one-hot form; a gather here)."""
    def fn(params, pca, mean, stack, exposures, ii, jj, *rest):
        return lin_ops.population_linearity_energies(
            _curves(params, pca, mean, use_mean, datapoints), stack,
            rest[0] if with_std else None, exposures, lower_dn, upper_dn,
            ii, jj, penalty=penalty)
    return fn


def _make_population_energy_hist(use_mean: bool, penalty: str,
                                 lower_dn: int, upper_dn: int,
                                 datapoints: int):
    """Channel-batched energy from per-pair joint DN histograms: O(K *
    bits^2) per member, whatever the resolution (the unweighted objective
    depends on the data only through those histograms)."""
    def fn(params, pca, mean, hists, exposures, ii, jj):
        return lin_ops.population_linearity_energies_hist(
            _curves(params, pca, mean, use_mean, datapoints), hists,
            exposures, lower_dn, upper_dn, ii, jj, penalty=penalty)
    return fn


def _make_population_energy_chunked(use_mean: bool, penalty: str,
                                    lower_dn: int, upper_dn: int,
                                    datapoints: int, with_std: bool,
                                    chunk: int):
    """Channel-batched energy streamed over pixel chunks: any resolution,
    with or without stds."""
    def fn(params, pca, mean, stack, exposures, ii, jj, *rest):
        return lin_ops.population_linearity_energies_chunked(
            _curves(params, pca, mean, use_mean, datapoints), stack,
            rest[0] if with_std else None, exposures, lower_dn, upper_dn,
            ii, jj, penalty=penalty, chunk=chunk)
    return fn


def _polish(params: Tensor, lower: Tensor, upper: Tensor, use_mean: bool,
            penalty: str, lower_dn: int, upper_dn: int, datapoints: int,
            steps: int, lr: float, pca: Tensor, mean: Tensor, hists: Tensor,
            exposures: Tensor, ii, jj) -> Tuple[Tensor, Tensor]:
    """Post-DE gradient polish of (C, D) parameters: Adam on the grad-safe
    histogram energy, per channel, keeping the result only where the exact
    DE objective strictly improves.  Returns (params, exact energies).

    Adam is optax's ``adam(lr)``: b1 0.9, b2 0.999, eps 1e-8 added outside
    the square root.  Each step is projected onto the (D,) bounds
    ``[lower, upper]``, and a channel whose gradient is not finite keeps
    its parameters and moments for that step: the JAX package's polish is
    unconstrained, so it can leave the bounds, and a NaN gradient (a curve
    reaching 0 inside its limits) makes its parameters NaN.  The
    reference's stepped SciPy solver never polishes
    (ICRF_calibration_exposure.py:357-370).
    """
    b1, b2, eps = 0.9, 0.999, 1e-8
    exact = _make_population_energy_hist(use_mean, penalty, lower_dn,
                                         upper_dn, datapoints)

    def smooth(p):
        return lin_ops.linearity_energy_hist_smooth(
            _curves(p[:, None], pca, mean, use_mean, datapoints)[:, 0],
            hists, exposures, lower_dn, upper_dn, ii, jj)

    p = params.detach()
    mu = torch.zeros_like(p)
    nu = torch.zeros_like(p)
    for t in range(1, steps + 1):
        leaf = p.requires_grad_(True)
        grad, = torch.autograd.grad(smooth(leaf).sum(), leaf)
        p = leaf.detach()
        finite = torch.isfinite(grad).all(dim=-1, keepdim=True)
        grad = torch.where(finite, grad, 0.0)
        mu_t = (1 - b1) * grad + b1 * mu
        nu_t = (1 - b2) * grad ** 2 + b2 * nu
        mu_hat = mu_t / (1 - b1 ** t)
        nu_hat = nu_t / (1 - b2 ** t)
        stepped = torch.clamp(p - lr * (mu_hat / (torch.sqrt(nu_hat) + eps)),
                              lower, upper)
        p = torch.where(finite, stepped, p)
        mu = torch.where(finite, mu_t, mu)
        nu = torch.where(finite, nu_t, nu)

    data = (pca, mean, hists, exposures, ii, jj)
    e_old = exact(params[:, None], *data)[:, 0]
    e_new = exact(p[:, None], *data)[:, 0]
    better = e_new < e_old
    return (torch.where(better[:, None], p, params),
            torch.where(better, e_new, e_old))


def calibration(lower_PCA_limit: float, upper_PCA_limit: float,
                initial_function=None,
                data_spacing=150,
                data_limits: Tuple[int, int] = (5, 250),
                use_std: bool = False,
                image_path: Optional[Path] = None,
                energy_limit: float = 0.0,
                rng_seed: int = 7,
                config: CameraConfig = DEFAULT_CONFIG,
                channel_stacks=None,
                pca_arrays=None,
                mean_icrf_arrays=None,
                popsize: int = 15,
                maxiter: int = 1000,
                tol: float = 0.01,
                mutation: Tuple[float, float] = (0.0, 1.95),
                recombination: float = 0.4,
                penalty: str = "soft",
                mesh=None, pop_axis: str = "data",
                checkpoint_path=None, checkpoint_every: int = 0,
                polish_steps: int = 200, polish_lr: float = 5e-3,
                refine_rounds: int = 2, refine_width: float = 0.075,
                refine_maxiter: int = 500, return_base: bool = False,
                energy_form: str = "auto", return_params: bool = False,
                device=None):
    """Solve the per-channel ICRF by differential evolution
    (ICRF_calibration_exposure.py:288-402).

    Data come from ``image_path`` (loaded and subsampled like the
    reference) or from ``channel_stacks`` = (value_stacks (C, P, N) DNs,
    std_stacks or None, exposures (N,)), tensors or numpy arrays
    (``utils/state.py::channel_stacks_from_numpy`` makes them).  The PCA
    basis and mean curves load from the config's files unless given as
    arrays (C, datapoints, K) / (C, datapoints).  The solve runs on
    ``device``, by default the value stacks' device, or the card for numpy
    input and for images loaded from ``image_path``.

    ``energy_form`` picks the population objective: "auto" (by memory
    footprint, the JAX package's rule), "onehot" (the whole stack at once;
    a gather here), "hist" (per-pair joint DN histograms, unweighted data
    only) or "chunked" (pixel chunks).  All compute the same objective.

    After the global stage, ``refine_rounds`` re-solve each channel with
    tol 0 in a box around its best, each round 4x narrower; the box is
    clipped to the declared bounds, so a refined solution never leaves
    them (the JAX package does not clip).  The polish projects each Adam
    step onto the same bounds (the JAX package's polish is unconstrained).
    A channel takes a refined or polished answer only on strict
    improvement.

    Returns (ICRF (bits, C), initial_energies (C,), final_energies (C,),
    pixel_ratio) as numpy arrays; with ``return_base`` the solved
    (datapoints, C) curve follows, whose np.interp expansion the table
    is; with ``return_params`` the solved (C, num_params) parameters come
    last.

    ``mesh``/``pop_axis`` shard every stage's population over the mesh
    axis (:func:`differential_evolution_batched`).  The polish then runs
    on every process, and the answer of the process of rank 0 goes to all:
    float sums on two cards need not agree to the bit.
    """
    cfg = config
    chs = cfg.num_of_chs

    if channel_stacks is not None:
        value_stacks, std_stacks, exposures = channel_stacks
        pixel_ratio = 0.0
    else:
        value_stacks, std_stacks, exposures, pixel_ratio = \
            initialize_channel_image_stacks(image_path, use_std,
                                            data_spacing, config=cfg,
                                            device=device)
    if device is None and isinstance(value_stacks, Tensor):
        device = value_stacks.device
    device = resolve_device(device)
    dtype = canonical_float(device)

    if pca_arrays is None:
        pca_arrays = np.stack([
            io.read_txt_to_array(cfg.pca_files[c], cfg.data_path)
            for c in range(chs)])
    use_mean_icrf = initial_function is None
    if use_mean_icrf:
        if mean_icrf_arrays is None:
            mean_icrf_arrays = np.stack([
                io.read_txt_to_array(cfg.mean_icrf_files[c], cfg.data_path)
                for c in range(chs)])
    else:
        mean_icrf_arrays = None

    num_pca = pca_arrays.shape[-1]
    if use_mean_icrf:
        limits = [(lower_PCA_limit, upper_PCA_limit)] * num_pca
        x0 = [0.0] * num_pca
    else:
        limits = [(1.0, 8.0)] + [(lower_PCA_limit, upper_PCA_limit)] * num_pca
        x0 = [3.0] + [0.0] * num_pca
    lower_b = np.array([lo for lo, _ in limits])
    upper_b = np.array([hi for _, hi in limits])

    def on_device(x, dt):
        return torch.as_tensor(x, device=device, dtype=dt)

    value_stacks = on_device(value_stacks, torch.int64)
    n = value_stacks.shape[-1]
    ii, jj = lin_ops.upper_triangle_pairs(n)
    ii, jj = on_device(ii, torch.int64), on_device(jj, torch.int64)
    lower_dn, upper_dn = int(data_limits[0]), int(data_limits[1])
    exposures = on_device(exposures, dtype)
    pca = on_device(pca_arrays, dtype)                         # (C, dp, K)
    # a placeholder keeps the energies' signature uniform without a mean
    mean = on_device(mean_icrf_arrays, dtype) if use_mean_icrf else \
        torch.zeros((chs, cfg.datapoints), dtype=dtype, device=device)
    use_std_stacks = std_stacks is not None
    std = on_device(std_stacks, dtype) if use_std_stacks else None

    if energy_form not in ("auto", "onehot", "hist", "chunked"):
        raise ValueError(f"unknown energy_form {energy_form!r}; expected "
                         "'auto', 'onehot', 'hist' or 'chunked'")
    if energy_form == "hist" and use_std_stacks:
        raise ValueError("energy_form='hist' cannot weight by per-pixel "
                         "stds (the histogram condenses pixels away); use "
                         "'onehot' or 'chunked'")
    # the JAX package's rule, so both packages pick the same form: its
    # one-hot of the data, (P*N, datapoints) f32, must fit in 1 GiB
    total_obs = int(np.prod(value_stacks.shape[1:]))
    if energy_form == "auto":
        use_onehot = total_obs * cfg.datapoints * 4 <= (1 << 30)
        use_hist = not use_onehot and not use_std_stacks
    else:
        use_onehot = energy_form == "onehot"
        use_hist = energy_form == "hist"

    hists = None
    if use_onehot:
        energy_fn = _make_population_energy(
            use_mean_icrf, penalty, lower_dn, upper_dn, cfg.datapoints,
            use_std_stacks)
        channel_data = (pca, mean, value_stacks, exposures, ii, jj)
    elif use_hist:
        hists = lin_ops.pair_dn_histograms(value_stacks, ii, jj,
                                           cfg.datapoints)
        energy_fn = _make_population_energy_hist(
            use_mean_icrf, penalty, lower_dn, upper_dn, cfg.datapoints)
        channel_data = (pca, mean, hists, exposures, ii, jj)
    else:
        energy_fn = _make_population_energy_chunked(
            use_mean_icrf, penalty, lower_dn, upper_dn, cfg.datapoints,
            use_std_stacks, 16384)
        channel_data = (pca, mean, value_stacks, exposures, ii, jj)
    if use_std_stacks and not use_hist:
        channel_data = channel_data + (std,)

    solve = dict(population_energy=True, popsize=popsize, mutation=mutation,
                 recombination=recombination, energy_limit=energy_limit,
                 mesh=mesh, pop_axis=pop_axis, device=device)
    result, _ = differential_evolution_batched(
        energy_fn, channel_data, chs, len(x0), lower_b, upper_b,
        x0=np.array(x0), maxiter=maxiter, tol=tol, seed=rng_seed,
        checkpoint_path=checkpoint_path, checkpoint_every=checkpoint_every,
        **solve)
    best_x = result.x
    initial_energies = result.initial_energy.cpu().numpy().astype(float)
    final_energies = result.energy.cpu().numpy().astype(float)

    # Refinement: re-solve each channel with tol=0 in a narrowed box around
    # its best (the global stage finds the basin, a short local DE its
    # floor), clipped to the declared bounds.
    for rr in range(refine_rounds):
        span = refine_width * (upper_b - lower_b) / (4.0 ** rr)
        bx = best_x.cpu().numpy().astype(float)
        result_r, _ = differential_evolution_batched(
            energy_fn, channel_data, chs, len(x0),
            np.maximum(bx - span, lower_b), np.minimum(bx + span, upper_b),
            x0=bx, maxiter=refine_maxiter, tol=0.0,
            seed=rng_seed + 1000 * (rr + 1), **solve)
        energy_r = result_r.energy.cpu().numpy().astype(float)
        improved = energy_r < final_energies
        best_x = torch.where(torch.as_tensor(improved, device=device)[:, None],
                             result_r.x, best_x)
        final_energies = np.where(improved, energy_r, final_energies)

    # Gradient polish (unweighted objective only) within the declared
    # bounds, accepted per channel only on strict improvement of the exact
    # DE objective.
    if polish_steps and not use_std_stacks:
        if hists is None:
            hists = lin_ops.pair_dn_histograms(value_stacks, ii, jj,
                                               cfg.datapoints)
        best_x, polished_e = _polish(
            best_x, on_device(lower_b, dtype), on_device(upper_b, dtype),
            use_mean_icrf, penalty, lower_dn, upper_dn,
            cfg.datapoints, int(polish_steps), float(polish_lr), pca, mean,
            hists, exposures, ii, jj)
        if mesh is not None:
            agreed = torch.cat([best_x, polished_e[:, None]], dim=1)
            dist.broadcast(agreed, src=0)
            best_x, polished_e = agreed[:, :-1], agreed[:, -1]
        final_energies = polished_e.cpu().numpy().astype(float)

    curves = _curves(best_x[:, None], pca, mean, use_mean_icrf,
                     cfg.datapoints)[:, 0]
    icrf_out = curves.detach().cpu().numpy().astype(float).T  # (dp, C)
    # endpoint renormalization + clip (:388-396)
    icrf_out = icrf_out + (1.0 - icrf_out[-1:])
    icrf_out[0] = 0.0
    icrf_out = np.clip(icrf_out, 0.0, 1.0)

    icrf_interpolated = interpolate_curve(torch.as_tensor(icrf_out),
                                          cfg.bits).numpy()
    out = (icrf_interpolated, initial_energies, final_energies, pixel_ratio)
    if return_base:
        out = out + (icrf_out,)
    if return_params:
        out = out + (best_x.cpu().numpy().astype(float),)
    return out
