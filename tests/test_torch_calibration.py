"""Port parity: the ICRF calibration (models/calibration.py, icrf.py,
dorf.py, scipy_strict.py, utils/checkpoint.py and the calibration inputs of
utils/state.py) against the JAX package.

JAX's PRNG and ``torch.Generator`` cannot match draw for draw, so the
trajectory tests make the JAX package's own draws in the test (its key
chain, calibration.py:230-232 and :94-117) and feed them to the port's
step: one generation equals ``_evolve_population`` exactly, and 15
generations of the batched solve equal ``differential_evolution_batched``
within 1e-12.  Everything else runs on the port's own generators: the
property tests of tests/unit/test_calibration.py and test_scipy_parity.py,
at small sizes (<= 200 pixels, popsize <= 10, maxiter <= 150).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import camera_linearity_tpu as jpkg  # noqa: E402
import camera_linearity_tpu_torch as tpkg  # noqa: E402
from camera_linearity_tpu.models import calibration as jcal  # noqa: E402
from camera_linearity_tpu.models import dorf as jdorf  # noqa: E402
from camera_linearity_tpu.models import icrf as jicrf  # noqa: E402
from camera_linearity_tpu.models import scipy_strict as jstrict  # noqa: E402
from camera_linearity_tpu.ops import linearity as jlin  # noqa: E402
from camera_linearity_tpu_torch.models import calibration as tcal  # noqa
from camera_linearity_tpu_torch.models import dorf as tdorf  # noqa: E402
from camera_linearity_tpu_torch.models import icrf as ticrf  # noqa: E402
from camera_linearity_tpu_torch.models import \
    scipy_strict as tstrict  # noqa: E402
from camera_linearity_tpu_torch.ops import linearity as tlin  # noqa: E402
from camera_linearity_tpu_torch.utils.checkpoint import \
    DECheckpoint  # noqa: E402
from camera_linearity_tpu_torch.utils.state import (  # noqa: E402
    channel_stacks_from_numpy, pca_from_numpy)
from camera_linearity_tpu_torch.parallel import mesh as pmesh  # noqa: E402
from tests._torch_parallel_worker import world_of_one  # noqa: E402
from tests.unit.test_dorf import _write_dorf  # noqa: E402
from tests.unit.test_scipy_parity import _np_energy  # noqa: E402

TOL = dict(rtol=1e-12, atol=1e-14)
MUTATION, RECOMBINATION = (0.0, 1.95), 0.4


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test: the suite runs in several processes
    at once (pytest -n), and torch's own thread pool in each would
    oversubscribe the cores (a calibration test ran 4x slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return None if a is None else torch.as_tensor(np.array(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


def _basis(datapoints=256, k=5):
    x = np.linspace(0, 1, datapoints)
    curves = np.stack([x ** g for g in np.linspace(1.6, 3.0, 25)])
    mean_icrf = curves.mean(axis=0)
    _, _, vt = np.linalg.svd(curves - mean_icrf, full_matrices=False)
    return mean_icrf, vt[:k].T


def _problem(gammas=(2.2,), n_exp=5, pixels=200, seed=1995):
    """Per channel, DNs of a linear scene through CRF = x**(1/gamma), and
    the gamma-family PCA basis: solving recovers ICRF = x**gamma
    (tests/unit/test_calibration.py:88-111)."""
    rng = np.random.default_rng(seed)
    exposures = 0.001 * 2.0 ** np.arange(n_exp)
    stacks = []
    for g in gammas:
        radiance = rng.uniform(0.01, 0.35, pixels)
        linear = radiance[:, None] * (exposures / exposures[-1])[None, :]
        stacks.append(np.around(np.clip(linear, 0, 1) ** (1 / g)
                                * 255).astype(np.int32))
    mean_icrf, pca = _basis()
    return np.stack(stacks), exposures, mean_icrf, pca


def _kw(stacks, exposures, mean_icrf, pca, std=None, **kw):
    """The port's calibration inputs, carried over from numpy by
    utils/state.py as a JAX package user's arrays would be."""
    c = stacks.shape[0]
    pca_t, mean_t = pca_from_numpy(np.stack([pca] * c),
                                   np.stack([mean_icrf] * c), device="cpu")
    return dict(channel_stacks=channel_stacks_from_numpy(
                    stacks, std, exposures, device="cpu"),
                pca_arrays=pca_t, mean_icrf_arrays=mean_t,
                config=tpkg.CameraConfig(num_of_chs=c, datapoints=256), **kw)


# ---------------------------------------------------------------------------
# icrf, sobol, state helpers
# ---------------------------------------------------------------------------

def test_icrf_from_params_modes(rng):
    pca = rng.normal(size=(64, 3))
    mean = np.linspace(0, 1, 64)
    p = rng.normal(size=3)
    np.testing.assert_allclose(
        ticrf.icrf_from_params(_t(p), _t(pca), _t(mean)).numpy(),
        np.asarray(jicrf.icrf_from_params(_j(p), _j(pca), _j(mean))), **TOL)
    p2 = np.concatenate([[2.0], p])
    np.testing.assert_allclose(
        ticrf.icrf_from_params(_t(p2), _t(pca), None, datapoints=64).numpy(),
        np.asarray(jicrf.icrf_from_params(_j(p2), _j(pca), None,
                                          datapoints=64)), **TOL)


@pytest.mark.parametrize("use_mean", [True, False])
def test_icrf_from_params_batched(rng, use_mean):
    """A (C, S, K) population over per-channel (C, dp, K) bases gives each
    member's curve."""
    c, s, k, dp = 2, 4, 3, 32
    pca = rng.normal(size=(c, dp, k))
    mean = rng.uniform(0, 1, (c, dp)) if use_mean else None
    params = rng.normal(size=(c, s, k + (0 if use_mean else 1)))
    params[..., 0] = np.abs(params[..., 0]) + 1.0
    got = ticrf.icrf_from_params(_t(params), _t(pca), _t(mean)).numpy()
    assert got.shape == (c, s, dp)
    for ch in range(c):
        want = jax.vmap(lambda p: jicrf.icrf_from_params(
            p, _j(pca[ch]), None if mean is None else _j(mean[ch]),
            datapoints=dp))(_j(params[ch]))
        np.testing.assert_allclose(got[ch], np.asarray(want), **TOL)


def test_sobol_init_matches_jax():
    for n, d, seed in [(45, 5, 7), (15, 6, 0)]:
        np.testing.assert_array_equal(tcal.sobol_init_population(n, d, seed),
                                      jcal.sobol_init_population(n, d, seed))


def test_calibration_inputs_from_numpy(rng):
    stacks, exposures, mean_icrf, pca = _problem((2.0, 2.4), pixels=20)
    std = rng.uniform(0.001, 0.01, stacks.shape)
    v, s, e = channel_stacks_from_numpy(stacks, std, exposures,
                                        device="cpu")
    assert v.dtype == torch.int64 and s.dtype == e.dtype == torch.float64
    np.testing.assert_array_equal(v.numpy(), stacks)
    v, s, e = channel_stacks_from_numpy(stacks, None, exposures,
                                        device="cpu", dtype=torch.float32)
    assert s is None and e.dtype == torch.float32
    p, m = pca_from_numpy(np.stack([pca] * 2), np.stack([mean_icrf] * 2),
                          device="cpu")
    assert p.shape == (2, 256, 5) and m.shape == (2, 256)
    assert pca_from_numpy(np.stack([pca]), device="cpu")[1] is None
    with pytest.raises(ValueError):
        channel_stacks_from_numpy(stacks.astype(float), None, exposures,
                                  device="cpu")
    with pytest.raises(ValueError):
        channel_stacks_from_numpy(stacks, None, exposures[:3], device="cpu")
    with pytest.raises(ValueError):
        pca_from_numpy(pca, device="cpu")


# ---------------------------------------------------------------------------
# trajectories under the JAX package's own draws
# ---------------------------------------------------------------------------

def _jax_channel_draws(key, s, d):
    """One channel's generation in the JAX package: the key split of
    calibration.py:230-232 and the draws of _evolve_population (:94-117).
    Returns (next key, generation key, draws as numpy)."""
    key, k_scale, k_gen = jax.random.split(key, 3)
    scale = jax.random.uniform(k_scale, (), jnp.float64, *MUTATION)
    k_r0, k_r1, k_cross, k_fill, k_bounds = jax.random.split(k_gen, 5)
    i = np.arange(s)
    a = np.asarray(jax.random.randint(k_r0, (s,), 0, s - 1))
    r0 = a + (a >= i)
    b = np.asarray(jax.random.randint(k_r1, (s,), 0, s - 2))
    r1 = b + (b >= np.minimum(i, r0))
    r1 = r1 + (r1 >= np.maximum(i, r0))
    cross = np.asarray(jax.random.uniform(k_cross, (s, d))) < RECOMBINATION
    fill = np.asarray(jax.random.randint(k_fill, (s,), 0, d))
    resample = np.asarray(jax.random.uniform(k_bounds, (s, d), jnp.float64))
    return key, k_gen, (float(scale), r0, r1, cross, fill, resample)


def _as_draws(per_channel):
    cols = list(zip(*per_channel))
    return tcal.Draws(*(torch.as_tensor(np.array(col)) for col in cols))


def test_one_generation_equals_jax(rng):
    s, d = 40, 5
    pop = rng.uniform(0, 1, (s, d))
    energies = rng.uniform(0, 1, s)
    key = jax.random.PRNGKey(3)
    for _ in range(3):
        key, k_gen, draws = _jax_channel_draws(key, s, d)
        want = jcal._evolve_population(k_gen, _j(pop), _j(energies),
                                       jnp.float64(draws[0]), RECOMBINATION)
        got = tcal.evolve_population(_t(pop[None]), _t(energies[None]),
                                     _as_draws([draws]))[0]
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert ((got >= 0) & (got <= 1)).all()
        pop = np.asarray(want)


class _JaxDraws:
    """Stands in for ``draw_generation``: each call returns the next
    generation of the JAX key chain of ``differential_evolution_batched``
    (keys seeded seed + c, calibration.py:352)."""

    def __init__(self, seed, channels):
        self.keys = [jax.random.PRNGKey(seed + c) for c in range(channels)]
        self.calls = 0

    def __call__(self, generators, s, d, mutation, recombination, dtype):
        assert tuple(mutation) == MUTATION and recombination == RECOMBINATION
        self.calls += 1
        per_channel = []
        for c, key in enumerate(self.keys):
            self.keys[c], _, draws = _jax_channel_draws(key, s, d)
            per_channel.append(draws)
        return _as_draws(per_channel)


def test_batched_solve_trajectory_equals_jax(monkeypatch):
    """15 generations (tol 0) of the two-channel calibration energy: the
    port's solver, fed the JAX draws, lands on the JAX population and
    energies."""
    stacks, exposures, mean_icrf, pca = _problem((2.0, 2.4), pixels=60)
    c, seed, maxiter = 2, 11, 15
    ii, jj = jlin.upper_triangle_pairs(stacks.shape[-1])
    j_energy = jcal._make_population_energy(True, "soft", 5, 250, 256,
                                            False)
    onehots = jnp.stack([jlin.build_data_onehot(_j(st), 256, jnp.float64)
                         for st in stacks])
    j_data = (_j(np.stack([pca] * c)), _j(np.stack([mean_icrf] * c)),
              onehots, _j(np.tile(exposures, (c, 1))),
              _j(np.tile(ii, (c, 1))), _j(np.tile(jj, (c, 1))))
    t_energy = tcal._make_population_energy(True, "soft", 5, 250, 256,
                                            False)
    t_data = (_t(np.stack([pca] * c)), _t(np.stack([mean_icrf] * c)),
              _t(stacks).long(), _t(exposures), _t(ii), _t(jj))
    kw = dict(x0=np.zeros(5), popsize=8, mutation=MUTATION,
              recombination=RECOMBINATION, tol=0.0, maxiter=maxiter,
              seed=seed, population_energy=True)
    want, want_frozen = jcal.differential_evolution_batched(
        j_energy, j_data, c, 5, np.full(5, -1.0), np.full(5, 1.0), **kw)
    draws = _JaxDraws(seed, c)
    monkeypatch.setattr(tcal, "draw_generation", draws)
    got, got_frozen = tcal.differential_evolution_batched(
        t_energy, t_data, c, 5, np.full(5, -1.0), np.full(5, 1.0), **kw)
    assert draws.calls == maxiter == got.n_iter == want.n_iter
    np.testing.assert_allclose(got.population.numpy(),
                               np.asarray(want.population), **TOL)
    np.testing.assert_allclose(got.energies.numpy(),
                               np.asarray(want.energies), **TOL)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), **TOL)
    np.testing.assert_allclose(got.initial_energy.numpy(),
                               np.asarray(want.initial_energy), **TOL)
    np.testing.assert_array_equal(got_frozen.numpy(),
                                  np.asarray(want_frozen))


# ---------------------------------------------------------------------------
# the solver loop on the port's own generators
# ---------------------------------------------------------------------------

def _sphere(p, center):
    # offset by 1, so that the relative convergence test can pass
    return 1.0 + torch.sum((p - center) ** 2)


def _sphere_solve(**kw):
    centers = _t(np.array([[0.3, -0.2, 0.1], [-0.5, 0.4, 0.0],
                           [0.05, 0.05, -0.6]]))
    args = dict(popsize=8, maxiter=60, tol=1e-3, mutation=(0.3, 1.0),
                recombination=0.7, seed=11)
    args.update(kw)
    return tcal.differential_evolution_batched(
        _sphere, (centers,), 3, 3, np.full(3, -1.0), np.full(3, 1.0), **args)


def test_sync_every_keeps_nit_and_frozen_at(monkeypatch):
    """Reading the done flags every SYNC_EVERY generations gives the
    population, energies, n_iter and frozen_at of a per-generation check."""
    coarse, coarse_frozen = _sphere_solve()
    monkeypatch.setattr(tcal, "SYNC_EVERY", 1)
    fine, fine_frozen = _sphere_solve()
    assert coarse.converged and fine.converged
    assert coarse.n_iter == fine.n_iter < 60
    np.testing.assert_array_equal(coarse_frozen.numpy(), fine_frozen.numpy())
    assert len(set(fine_frozen.tolist())) > 1  # channels froze apart
    assert int(fine_frozen.max()) == fine.n_iter
    np.testing.assert_array_equal(coarse.population.numpy(),
                                  fine.population.numpy())
    np.testing.assert_array_equal(coarse.energies.numpy(),
                                  fine.energies.numpy())


def test_de_solves_sphere_and_respects_bounds():
    res = tcal.differential_evolution(
        lambda x: torch.sum((x - 0.3) ** 2), 4, np.full(4, -2.0),
        np.full(4, 2.0), popsize=10, maxiter=150, tol=1e-4,
        mutation=(0.3, 1.0), recombination=0.7, seed=3, device="cpu")
    np.testing.assert_allclose(res.x.numpy(), 0.3, atol=1e-2)
    assert float(res.energy) < 1e-4 and res.energy < res.initial_energy
    res = tcal.differential_evolution(
        lambda x: torch.sum(x ** 2), 3, np.array([1.0, 1.0, 1.0]),
        np.array([2.0, 3.0, 4.0]), x0=np.array([1.5, 1.5, 1.5]), popsize=8,
        maxiter=50, seed=1, device="cpu")
    pop = res.population.numpy()
    assert (pop >= 1 - 1e-9).all() and (pop <= np.array([2, 3, 4]) + 1e-9
                                        ).all()
    np.testing.assert_allclose(res.x.numpy(), 1.0, atol=0.05)
    res = tcal.differential_evolution(
        lambda x: torch.sum(x ** 2), 2, np.full(2, -1.0), np.full(2, 1.0),
        popsize=10, maxiter=150, energy_limit=0.5, seed=0, device="cpu")
    assert res.n_iter < 150


def test_checkpointed_solve_and_resume(tmp_path):
    plain, _ = _sphere_solve(tol=1e-12)
    ckpt = tmp_path / "de.pt"
    chk, _ = _sphere_solve(tol=1e-12, checkpoint_path=ckpt,
                           checkpoint_every=20)
    assert DECheckpoint.exists(ckpt) and chk.n_iter == plain.n_iter == 60
    np.testing.assert_array_equal(chk.population.numpy(),
                                  plain.population.numpy())
    # stop after 20 generations, then resume to 60: the same trajectory
    ckpt2 = tmp_path / "resume.pt"
    partial, _ = _sphere_solve(tol=1e-12, maxiter=20, checkpoint_path=ckpt2,
                               checkpoint_every=10)
    assert partial.n_iter == 20
    resumed, _ = _sphere_solve(tol=1e-12, checkpoint_path=ckpt2,
                               checkpoint_every=10)
    assert resumed.n_iter == 60
    np.testing.assert_array_equal(resumed.population.numpy(),
                                  plain.population.numpy())
    np.testing.assert_array_equal(resumed.energies.numpy(),
                                  plain.energies.numpy())


def test_corrupt_checkpoint_degrades_to_fresh_start(tmp_path):
    ckpt = tmp_path / "de.pt"
    _sphere_solve(tol=1e-12, maxiter=20, checkpoint_path=ckpt,
                  checkpoint_every=10)
    ckpt.write_bytes(ckpt.read_bytes()[:100])   # died mid-save
    assert DECheckpoint.try_load(ckpt) is None
    recovered, _ = _sphere_solve(tol=1e-12, checkpoint_path=ckpt)
    plain, _ = _sphere_solve(tol=1e-12)
    np.testing.assert_array_equal(recovered.population.numpy(),
                                  plain.population.numpy())
    torch.save({"pop": torch.zeros(2, 3)}, ckpt)  # missing fields
    assert DECheckpoint.try_load(ckpt) is None


# ---------------------------------------------------------------------------
# calibration(): properties on the port's own generators
# ---------------------------------------------------------------------------

def test_calibration_recovers_gamma_curve():
    stacks, exposures, mean_icrf, pca = _problem()
    icrf, e0, e1, ratio = tcal.calibration(
        -1.0, 1.0, **_kw(stacks, exposures, mean_icrf, pca),
        popsize=10, maxiter=150, tol=1e-3, rng_seed=5)
    assert icrf.shape == (256, 1) and ratio == 0.0
    assert e1[0] < e0[0] and e1[0] < 0.03
    truth = np.linspace(0, 1, 256) ** 2.2
    assert np.max(np.abs(icrf[:, 0] - truth)) < 0.05
    assert icrf[0, 0] == 0.0 and np.all(np.diff(icrf[:, 0]) >= -1e-9)
    # the final energy is the reference's energy at the solved curve
    params = pca.T @ (icrf[:, 0] - mean_icrf)
    np.testing.assert_allclose(
        _np_energy(params, stacks[0], exposures, mean_icrf, pca), e1[0],
        rtol=1e-6)


def test_calibration_energy_forms_agree(tmp_path):
    stacks, exposures, mean_icrf, pca = _problem()
    kw = _kw(stacks, exposures, mean_icrf, pca, popsize=8, maxiter=15,
             tol=1e-9, rng_seed=5, refine_rounds=0, polish_steps=0)
    res = {form: tcal.calibration(-1.0, 1.0, **kw, energy_form=form)
           for form in ("onehot", "hist", "chunked")}
    e_ref = float(res["onehot"][2][0])
    for form, (icrf_f, _, e1, _) in res.items():
        assert np.isfinite(icrf_f).all()
        assert abs(float(e1[0]) - e_ref) < 1e-9, (form, float(e1[0]), e_ref)
    np.testing.assert_allclose(res["hist"][0], res["onehot"][0], atol=1e-9)
    with pytest.raises(ValueError, match="unknown energy_form"):
        tcal.calibration(-1.0, 1.0, **kw, energy_form="bogus")
    std_kw = dict(kw, channel_stacks=(stacks, np.full(stacks.shape, 0.01),
                                      exposures),  # numpy input works too
                  device="cpu")
    with pytest.raises(ValueError, match="hist"):
        tcal.calibration(-1.0, 1.0, **std_kw, energy_form="hist")
    _, _, e1c, _ = tcal.calibration(-1.0, 1.0, **std_kw,
                                    energy_form="chunked")
    _, _, e1o, _ = tcal.calibration(-1.0, 1.0, **std_kw,
                                    energy_form="onehot")
    np.testing.assert_allclose(float(e1c[0]), float(e1o[0]), rtol=1e-9)
    # a mesh of one process shards nothing: the same solve
    with world_of_one(tmp_path):
        meshed = tcal.calibration(-1.0, 1.0, **kw, energy_form="onehot",
                                  mesh=pmesh.make_mesh(device="cpu"))
    for got, want in zip(meshed, res["onehot"]):
        np.testing.assert_array_equal(got, want)


def test_calibration_without_mean_icrf():
    stacks, exposures, _, pca = _problem()
    icrf, e0, e1, _ = tcal.calibration(
        -1.0, 1.0, initial_function=np.zeros(256),
        channel_stacks=(stacks, None, exposures), pca_arrays=pca[None],
        config=tpkg.CameraConfig(num_of_chs=1, datapoints=256), popsize=10,
        maxiter=120, tol=1e-3, rng_seed=2, device="cpu")
    assert e1[0] < e0[0]
    assert np.all(np.diff(icrf[:, 0]) >= -1e-9)


def test_calibration_return_base_expansion():
    stacks, exposures, mean_icrf, pca = _problem()
    kw = _kw(stacks, exposures, mean_icrf, pca)
    kw["config"] = tpkg.CameraConfig(num_of_chs=1, datapoints=256,
                                     bit_depth=12)
    icrf, _, _, _, base, params = tcal.calibration(
        -1.0, 1.0, **kw, popsize=10, maxiter=40, tol=1e-3, rng_seed=5,
        refine_rounds=0, polish_steps=0, return_base=True,
        return_params=True)
    assert base.shape == (256, 1) and icrf.shape == (4096, 1)
    assert params.shape == (1, 5)
    x, xb = np.arange(4096) / 4095.0, np.arange(256) / 255.0
    np.testing.assert_allclose(icrf[:, 0], np.interp(x, xb, base[:, 0]),
                               rtol=0, atol=1e-12)


def test_calibration_matches_or_beats_scipy():
    """Seeded SciPy and the port on the same problem and hyperparameters,
    both scored by the reference's float64 energy
    (tests/unit/test_scipy_parity.py:62-113, at a smaller size)."""
    from scipy.optimize._differentialevolution import \
        DifferentialEvolutionSolver
    stacks, exposures, mean_icrf, pca = _problem((2.0, 2.4), n_exp=6,
                                                 pixels=120, seed=7)
    maxiter = 60
    scipy_e = []
    for c in range(2):
        with DifferentialEvolutionSolver(
                lambda p: _np_energy(p, stacks[c], exposures, mean_icrf,
                                     pca),
                [(-1, 1)] * 5, strategy="currenttobest1bin", tol=0.01,
                x0=[0] * 5, mutation=(0, 1.95), recombination=0.4,
                init="sobol", popsize=10, rng=7) as solver:
            for nit, _ in enumerate(solver, start=1):
                if solver.converged() or nit == maxiter:
                    break
            scipy_e.append(_np_energy(np.asarray(solver.x), stacks[c],
                                      exposures, mean_icrf, pca))
    icrf, _, _, _ = tcal.calibration(
        -1.0, 1.0, **_kw(stacks, exposures, mean_icrf, pca), popsize=10,
        maxiter=maxiter, tol=0.01, rng_seed=7, refine_maxiter=60)
    for c in range(2):
        params = pca.T @ (icrf[:, c] - mean_icrf)
        dev_e = _np_energy(params, stacks[c], exposures, mean_icrf, pca)
        assert dev_e <= scipy_e[c] * (1 + 1e-6), (c, dev_e, scipy_e[c])


def test_refinement_box_stays_within_bounds(capsys):
    """With bounds so narrow that the optimum sits on one, the refinement
    box bx +- span crosses the bound: the port clips it, so its refined
    parameters stay inside [lower, upper].  The JAX solve's parameters are
    printed, not asserted."""
    stacks, exposures, mean_icrf, pca = _problem((1.7,), pixels=120)
    lo, hi = -0.05, 0.05
    kw = dict(popsize=6, maxiter=30, tol=1e-3, rng_seed=3, polish_steps=0,
              refine_maxiter=30, return_params=True)
    *_, params = tcal.calibration(
        lo, hi, **_kw(stacks, exposures, mean_icrf, pca), **kw)
    span = 0.075 * (hi - lo)
    assert np.any((params < lo + span) | (params > hi - span)), params
    assert np.all((params >= lo) & (params <= hi)), params
    cfg = jpkg.CameraConfig(num_of_chs=1, datapoints=256)
    *_, j_params = jcal.calibration(
        lo, hi, channel_stacks=(_j(stacks), None, _j(exposures)),
        pca_arrays=pca[None], mean_icrf_arrays=mean_icrf[None], config=cfg,
        **kw)
    print(f"port params {params}; JAX params {j_params} (bounds "
          f"[{lo}, {hi}])")


def test_polish_stays_within_bounds():
    """An optimum outside narrow bounds: the JAX package's polish walks out
    of [lower, upper], the port's projects every Adam step back and ends
    inside, with a lower energy than without the polish."""
    stacks, exposures, mean_icrf, pca = _problem((3.0,), pixels=120)
    lo, hi = -0.1, 0.1
    kw = dict(popsize=6, maxiter=30, tol=1e-3, rng_seed=3, refine_rounds=0,
              return_params=True)
    *_, e1, _, params = tcal.calibration(
        lo, hi, **_kw(stacks, exposures, mean_icrf, pca), **kw)
    *_, e0, _, _ = tcal.calibration(
        lo, hi, **_kw(stacks, exposures, mean_icrf, pca), **kw,
        polish_steps=0)
    *_, j_params = jcal.calibration(
        lo, hi, channel_stacks=(_j(stacks), None, _j(exposures)),
        pca_arrays=pca[None], mean_icrf_arrays=mean_icrf[None],
        config=jpkg.CameraConfig(num_of_chs=1, datapoints=256), **kw)
    assert np.any((j_params < lo) | (j_params > hi)), j_params
    assert np.all((params >= lo) & (params <= hi)), params
    assert e1[0] < e0[0]


def test_polish_skips_a_step_whose_gradient_is_not_finite(monkeypatch):
    """A channel whose first gradient is NaN keeps its parameters for that
    step and is polished by the later ones; the other channel is not held
    back.  (Without the skip its parameters turn NaN and the polish is
    lost.)"""
    stacks, exposures, mean_icrf, pca = _problem((3.0, 1.7), pixels=120)
    kw = _kw(stacks, exposures, mean_icrf, pca)
    *_, params = tcal.calibration(-1.0, 1.0, **kw, popsize=6, maxiter=30,
                                  rng_seed=3, refine_rounds=0, polish_steps=0,
                                  return_params=True)
    pca_t, mean_t = kw["pca_arrays"], kw["mean_icrf_arrays"]
    ii, jj = (torch.as_tensor(a) for a in tlin.upper_triangle_pairs(5))
    hists = tlin.pair_dn_histograms(torch.as_tensor(stacks).long(), ii, jj,
                                    256)
    smooth = tlin.linearity_energy_hist_smooth
    calls = []

    def first_call_nan_on_channel_1(*args):
        e = smooth(*args)
        calls.append(1)
        if len(calls) == 1:
            e = e * torch.tensor([1.0, float("nan")], dtype=e.dtype)
        return e
    monkeypatch.setattr(tcal.lin_ops, "linearity_energy_hist_smooth",
                        first_call_nan_on_channel_1)
    params = torch.as_tensor(params)
    bound = torch.ones(5, dtype=torch.float64)
    data = (pca_t, mean_t, hists, torch.as_tensor(exposures), ii, jj)
    polished, energies = tcal._polish(params, -bound, bound, True, "soft", 5,
                                      250, 256, 20, 1e-3, *data)
    exact = tcal._make_population_energy_hist(True, "soft", 5, 250, 256)
    before = exact(params[:, None], *data)[:, 0]
    assert torch.isfinite(polished).all()
    assert torch.all(energies < before), (energies, before)
    assert not torch.equal(polished[1], params[1])


# ---------------------------------------------------------------------------
# scipy_strict (copied) and dorf
# ---------------------------------------------------------------------------

def test_scipy_strict_matches_jax_package_and_hybrid_runs():
    stacks, exposures, mean_icrf, pca = _problem((2.0, 2.4), pixels=40)
    kw = dict(channel_stacks=(stacks, None, exposures),
              pca_arrays=np.stack([pca] * 2),
              mean_icrf_arrays=np.stack([mean_icrf] * 2), maxiter=3,
              popsize=4, config=tpkg.CameraConfig(num_of_chs=2))
    got = tstrict.calibration_strict(-1.0, 1.0, **kw)
    want = jstrict.calibration_strict(
        -1.0, 1.0, **dict(kw, config=jpkg.CameraConfig(num_of_chs=2)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    icrf, dev_e, s_init, s_final, n_it = tstrict.calibration_hybrid(
        -1.0, 1.0, **{k: v for k, v in kw.items() if k != "maxiter"},
        strict_maxiter=2, device_kwargs=dict(maxiter=20, refine_rounds=0,
                                             polish_steps=0, device="cpu"))
    assert icrf.shape == (256, 2) and np.all(np.isfinite(dev_e))
    assert np.all(s_final <= s_init)


def test_dorf_matches_jax(tmp_path, rng):
    p = _write_dorf(tmp_path, [("aRed", 2.0), ("bRed", 2.1),
                               ("aGreen", 2.2), ("bGreen", 2.3),
                               ("aBlue", 2.4), ("bBlue", 2.5),
                               ("gammaCurve", 1.8)])
    for kw in (dict(include_gamma=False), dict(include_gamma=True),
               dict(color_split=False)):
        for g, w in zip(tdorf.read_dorf_data(p, dorf_datapoints=32, **kw),
                        jdorf.read_dorf_data(p, dorf_datapoints=32, **kw)):
            np.testing.assert_array_equal(g, w)
    curves = jdorf.read_dorf_data(p, dorf_datapoints=32)
    inv = tdorf.invert_and_interpolate(curves, 64, 32)
    for g, w in zip(inv, jdorf.invert_and_interpolate(curves, 64, 32)):
        np.testing.assert_array_equal(g, w)
    cov = rng.normal(size=(40, 40))
    cov = cov @ cov.T
    np.testing.assert_allclose(
        tdorf.principal_components(_t(cov), 4).numpy(),
        np.asarray(jdorf.principal_components(_j(cov), 4)), rtol=1e-9,
        atol=1e-10)
    data = rng.uniform(0, 1, (6, 40))
    np.testing.assert_allclose(
        tdorf.covariance_matrix(_t(data), _t(data.mean(0))).numpy(),
        np.asarray(jdorf.covariance_matrix(_j(data), _j(data.mean(0)))),
        **TOL)

    files = dict(data_path=str(tmp_path), dorf_file="dorfCurves.txt",
                 dorf_datapoints=32, datapoints=64, num_of_pca_params=2,
                 icrf_files=("ICRF_b.txt", "ICRF_g.txt", "ICRF_r.txt"),
                 mean_icrf_files=("mean_b.txt", "mean_g.txt", "mean_r.txt"),
                 pca_files=("pca_b.txt", "pca_g.txt", "pca_r.txt"))
    processed, means = tdorf.process_CRF_data(tpkg.CameraConfig(**files),
                                              dorf_path=p)
    assert processed[0].shape == (2, 64) and means[0].shape == (64,)
    bases = tdorf.analyze_principal_components(tpkg.CameraConfig(**files))
    want = jdorf.analyze_principal_components(jpkg.CameraConfig(**files),
                                              save=False)
    for g, w in zip(bases, want):
        # two curves per channel span one direction: the second component
        # lies in a degenerate null space, arbitrary in either package
        assert g.shape == (64, 2)
        np.testing.assert_allclose(g[:, 0], w[:, 0], rtol=1e-9, atol=1e-10)
        np.testing.assert_allclose(g[0], 0.0, atol=1e-12)


def test_initialize_channel_image_stacks(tmp_path, rng):
    iio = pytest.importorskip("imageio.v3")
    for ms in (40, 10, 20):
        iio.imwrite(tmp_path / f"{ms}ms BF a 50x.tif",
                    rng.integers(0, 256, (12, 10, 3)).astype(np.uint8))
    cfg = tpkg.CameraConfig(im_size_x=10, im_size_y=12)
    got = tcal.initialize_channel_image_stacks(tmp_path, False, (3, 4),
                                               config=cfg, device="cpu")
    want = jcal.initialize_channel_image_stacks(
        tmp_path, False, (3, 4), config=jpkg.CameraConfig(im_size_x=10,
                                                          im_size_y=12))
    assert got[0].shape == (3, 12, 3) and got[1] is None
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    assert got[3] == want[3] == 12 / 120
