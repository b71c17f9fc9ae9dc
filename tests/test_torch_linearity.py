"""Port parity: ops/linearity.py, the calibration energy in all its forms,
against the JAX package and the NumPy oracle of the reference
(``oracle_energy``, tests/unit/test_linearity.py:56).

The same seeded DN stacks, std stacks and candidate curves (valid ones and
invalid ones, under both the ``"hard"`` and the ``"soft"`` penalty) go
through the JAX function and its port in float64 on the CPU: energies
rtol 1e-10, the joint DN histograms exactly, and the smooth energy's
autograd gradient against ``jax.grad`` at rtol 1e-8.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from camera_linearity_tpu.ops import linearity as jlin  # noqa: E402
from camera_linearity_tpu_torch.ops import linearity as tlin  # noqa: E402
from tests.unit.test_linearity import oracle_energy  # noqa: E402

E_TOL = dict(rtol=1e-10, atol=0)
GRAD_TOL = dict(rtol=1e-8, atol=1e-12)
N, P, LO, HI = 5, 150, 5, 250


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


def _problem(rng, n=N, pixels=P, channels=None):
    """DNs of a linear scene through a gamma CRF, stds, and exposures;
    ``channels`` adds a leading channel axis."""
    exposures = 0.001 * 2.0 ** np.arange(n)
    lead = () if channels is None else (channels,)
    radiance = rng.uniform(0.05, 60.0, lead + (pixels, 1))
    dn = np.clip((radiance * exposures) ** (1 / 2.2), 0, 1)
    stack_dn = np.around(dn * 255).astype(np.int32)
    std = rng.uniform(0.001, 0.02, stack_dn.shape)
    return stack_dn, std, exposures


def _curves(rng, s=8, dp=256):
    """Valid monotone candidates and invalid ones: flat after pinning,
    decreasing, above 1, below 0, and with a dip."""
    x = np.linspace(0, 1, dp)
    valid = [x ** g for g in rng.uniform(1.5, 3.0, s - 5)]
    dip = x ** 2.2
    dip[100:110] -= 0.05
    low = x ** 2.2 - 0.3 * np.sin(np.pi * x)   # below 0 after pinning
    high = x ** 2.2 + 0.8 * x * (1 - x) ** 0.2  # above 1 after pinning
    return np.stack(valid + [np.full(dp, 0.5), x[::-1].copy(), high, low,
                             dip])


def _oracle(curves, stack_dn, std, exposures):
    return np.array([oracle_energy(c, stack_dn[:, None, :],
                                   None if std is None else std[:, None, :],
                                   exposures, LO, HI) for c in curves])


def _check(got, want, oracle=None, penalty="hard"):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], **E_TOL)
    if oracle is not None:
        valid = np.isfinite(oracle)
        np.testing.assert_allclose(got[valid], oracle[valid], **E_TOL)
        if penalty == "hard":
            assert np.all(np.isinf(got[~valid]))
        else:
            assert np.all(got[~valid] >= 1e3)


def _pairs(n=N):
    return jlin.upper_triangle_pairs(n)


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def test_pair_helpers(rng):
    ii, jj = tlin.upper_triangle_pairs(6)
    np.testing.assert_array_equal(ii, _pairs(6)[0])
    np.testing.assert_array_equal(jj, _pairs(6)[1])
    exposures = np.array([0.0001, 0.01, 0.02, 0.1])
    for got, want in zip(tlin.valid_exposure_pairs(exposures),
                         jlin.valid_exposure_pairs(exposures)):
        np.testing.assert_array_equal(got, want)
    curves = _curves(rng)
    pinned = tlin.pin_endpoints(_t(curves))
    want_pinned = np.stack([np.asarray(jlin.pin_endpoints(_j(c)))
                            for c in curves])
    np.testing.assert_allclose(pinned.numpy(), want_pinned, rtol=1e-15)
    np.testing.assert_array_equal(
        tlin.monotonicity_penalty_mask(pinned).numpy(),
        [bool(jlin.monotonicity_penalty_mask(_j(c))) for c in want_pinned])
    np.testing.assert_allclose(
        tlin.constraint_violation(pinned).numpy(),
        [float(jlin.constraint_violation(_j(c))) for c in want_pinned],
        rtol=1e-12)


@pytest.mark.parametrize("use_relative", [True, False])
@pytest.mark.parametrize("use_std", [True, False])
def test_pairwise_linearity(rng, use_std, use_relative):
    stack_dn, std, exposures = _problem(rng)
    g = stack_dn / 255.0
    ii, jj = _pairs()
    got = tlin.pairwise_linearity(_t(g), _t(std) if use_std else None,
                                  _t(exposures), ii, jj, use_relative)
    want = jlin.pairwise_linearity(_j(g), _j(std) if use_std else None,
                                   _j(exposures), _j(ii), _j(jj),
                                   use_relative)
    for a, b in zip(got, want):
        if b is None:
            assert a is None
        else:
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-13)


def test_build_data_onehot_is_the_gather(rng):
    stack_dn, _, _ = _problem(rng)
    onehot = tlin.build_data_onehot(_t(stack_dn), 256, torch.float64)
    np.testing.assert_array_equal(
        onehot.numpy(), np.asarray(jlin.build_data_onehot(
            _j(stack_dn), 256, jnp.float64)))
    curves = _t(_curves(rng))
    np.testing.assert_array_equal((onehot @ curves.T).numpy(),
                                  curves.T[_t(stack_dn).reshape(-1)].numpy())


# ---------------------------------------------------------------------------
# energies
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("penalty", ["hard", "soft"])
@pytest.mark.parametrize("use_std", [True, False])
def test_linearity_energy_and_chunked(rng, use_std, penalty):
    stack_dn, std, exposures = _problem(rng)
    std = std if use_std else None
    ii, jj = _pairs()
    curves = _curves(rng)
    oracle = _oracle(curves, stack_dn, std, exposures)
    args_t = (_t(stack_dn), _t(std), _t(exposures), LO, HI, ii, jj)
    args_j = (_j(stack_dn), _j(std), _j(exposures), LO, HI, _j(ii), _j(jj))
    want = jax.vmap(lambda c: jlin.linearity_energy(
        c, *args_j, penalty=penalty))(_j(curves))
    got = torch.stack([tlin.linearity_energy(_t(c), *args_t,
                                             penalty=penalty)
                       for c in curves])
    _check(got, want, oracle, penalty)
    want_c = jax.vmap(lambda c: jlin.linearity_energy_chunked(
        c, *args_j, penalty=penalty, chunk=64))(_j(curves))
    got_c = torch.stack([tlin.linearity_energy_chunked(
        _t(c), *args_t, penalty=penalty, chunk=64) for c in curves])
    _check(got_c, want_c, oracle, penalty)


@pytest.mark.parametrize("penalty", ["hard", "soft"])
@pytest.mark.parametrize("use_std", [True, False])
def test_population_energies(rng, use_std, penalty):
    """The whole-stack form (the JAX one-hot matmul) and the chunked form,
    with a chunk that does not divide P."""
    stack_dn, std, exposures = _problem(rng)
    std = std if use_std else None
    ii, jj = _pairs()
    curves = _curves(rng)
    oracle = _oracle(curves, stack_dn, std, exposures)
    onehot = jlin.build_data_onehot(_j(stack_dn), 256, jnp.float64)
    want = jlin.population_linearity_energies(
        _j(curves), onehot, _j(std), _j(exposures), LO, HI, _j(ii), _j(jj),
        penalty=penalty)
    got = tlin.population_linearity_energies(
        _t(curves), _t(stack_dn), _t(std), _t(exposures), LO, HI, ii, jj,
        penalty=penalty)
    _check(got, want, oracle, penalty)
    want_c = jlin.population_linearity_energies_chunked(
        _j(curves), _j(stack_dn), _j(std), _j(exposures), LO, HI, _j(ii),
        _j(jj), penalty=penalty, chunk=64)
    got_c = tlin.population_linearity_energies_chunked(
        _t(curves), _t(stack_dn), _t(std), _t(exposures), LO, HI, ii, jj,
        penalty=penalty, chunk=64)
    _check(got_c, want_c, oracle, penalty)


@pytest.mark.parametrize("penalty", ["hard", "soft"])
def test_hist_energies_and_histograms(rng, penalty):
    stack_dn, _, exposures = _problem(rng)
    ii, jj = _pairs()
    hists = tlin.pair_dn_histograms(_t(stack_dn), ii, jj, 256)
    want_h = jlin.pair_dn_histograms(_j(stack_dn), _j(ii), _j(jj), 256)
    np.testing.assert_array_equal(hists.numpy(), np.asarray(want_h))
    assert hists.dtype == torch.int32
    curves = _curves(rng)
    oracle = _oracle(curves, stack_dn, None, exposures)
    want = jlin.population_linearity_energies_hist(
        _j(curves), want_h, _j(exposures), LO, HI, _j(ii), _j(jj),
        penalty=penalty)
    got = tlin.population_linearity_energies_hist(
        _t(curves), hists, _t(exposures), LO, HI, ii, jj, penalty=penalty)
    _check(got, want, oracle, penalty)
    with pytest.raises(ValueError, match="outside"):
        tlin.pair_dn_histograms(_t(stack_dn), ii, jj, 128)


def test_energies_batch_over_channels(rng):
    """A leading channel axis (as the calibration passes it) gives each
    channel's own energies."""
    stack_dn, std, exposures = _problem(rng, channels=2)
    ii, jj = _pairs()
    curves = np.stack([_curves(rng), _curves(rng)])
    hists = tlin.pair_dn_histograms(_t(stack_dn), ii, jj, 256)
    batched = [
        tlin.population_linearity_energies(
            _t(curves), _t(stack_dn), _t(std), _t(exposures), LO, HI, ii, jj),
        tlin.population_linearity_energies_chunked(
            _t(curves), _t(stack_dn), None, _t(exposures), LO, HI, ii, jj,
            chunk=64),
        tlin.population_linearity_energies_hist(
            _t(curves), hists, _t(exposures), LO, HI, ii, jj)]
    for c in range(2):
        single = [
            tlin.population_linearity_energies(
                _t(curves[c]), _t(stack_dn[c]), _t(std[c]), _t(exposures),
                LO, HI, ii, jj),
            tlin.population_linearity_energies_chunked(
                _t(curves[c]), _t(stack_dn[c]), None, _t(exposures), LO, HI,
                ii, jj, chunk=64),
            tlin.population_linearity_energies_hist(
                _t(curves[c]), hists[c], _t(exposures), LO, HI, ii, jj)]
        for b, s in zip(batched, single):
            np.testing.assert_allclose(b[c].numpy(), s.numpy(), rtol=1e-13)


def _smooth_inputs(rng):
    stack_dn, _, exposures = _problem(rng)
    ii, jj = _pairs()
    hists = np.asarray(jlin.pair_dn_histograms(_j(stack_dn), _j(ii),
                                               _j(jj), 256))
    x = np.linspace(0, 1, 256)
    bumpy = x ** 2.1 + 0.02 * np.sin(7 * np.pi * x)
    dip = x ** 2.2
    dip[120:126] -= 0.03                     # infeasible: not monotone
    high = x ** 2.2 + 0.8 * x * (1 - x) ** 0.2  # infeasible: above 1
    # (a curve that is 0 inside its own limits divides by 0 in either
    # package: the smooth energy serves near-feasible iterates)
    return hists, exposures, ii, jj, [x ** 2.2, bumpy, dip, high]


def test_smooth_energy_and_gradient(rng):
    hists, exposures, ii, jj, curves = _smooth_inputs(rng)

    @jax.jit
    def jax_e(c):
        return jlin.linearity_energy_hist_smooth(
            c, _j(hists), _j(exposures), LO, HI, _j(ii), _j(jj))
    jax_grad = jax.jit(jax.grad(jax_e))
    for c in curves:
        leaf = _t(c).requires_grad_(True)
        e = tlin.linearity_energy_hist_smooth(
            leaf, _t(hists), _t(exposures), LO, HI, ii, jj)
        grad, = torch.autograd.grad(e, leaf)
        np.testing.assert_allclose(e.item(), float(jax_e(_j(c))), **E_TOL)
        want = np.asarray(jax_grad(_j(c)))
        assert np.all(np.isfinite(grad.numpy()))
        np.testing.assert_allclose(grad.numpy(), want, **GRAD_TOL)
    # curves (C, dp) with histograms (C, K, b, b): one energy per channel
    batched = tlin.linearity_energy_hist_smooth(
        _t(np.stack(curves[:2])), _t(np.stack([hists, hists])),
        _t(exposures), LO, HI, ii, jj)
    np.testing.assert_allclose(
        batched.numpy(), [float(jax_e(_j(c))) for c in curves[:2]], **E_TOL)


@pytest.mark.parametrize("use_std", [True, False])
def test_energies_random_sweep(rng, use_std):
    """Random monotone candidates over random pair counts and limits: every
    form against the oracle."""
    for _ in range(3):
        n = int(rng.integers(3, 7))
        stack_dn, std, exposures = _problem(rng, n=n,
                                            pixels=int(rng.integers(4, 60)))
        std = std if use_std else None
        lo, hi = int(rng.integers(0, 40)), int(rng.integers(200, 256))
        curves = np.sort(rng.uniform(0, 1, (4, 256)), axis=1)
        curves[:, 0], curves[:, -1] = 0.0, 1.0
        oracle = np.array([oracle_energy(c, stack_dn[:, None, :],
                                         None if std is None
                                         else std[:, None, :], exposures,
                                         lo, hi) for c in curves])
        ii, jj = _pairs(n)
        args = (_t(stack_dn), _t(std), _t(exposures), lo, hi, ii, jj)
        forms = [tlin.population_linearity_energies(_t(curves), *args),
                 tlin.population_linearity_energies_chunked(
                     _t(curves), *args, chunk=7)]
        if std is None:
            forms.append(tlin.population_linearity_energies_hist(
                _t(curves), tlin.pair_dn_histograms(_t(stack_dn), ii, jj,
                                                    256),
                _t(exposures), lo, hi, ii, jj))
        for got in forms:
            got = got.numpy()
            np.testing.assert_array_equal(np.isinf(got), np.isinf(oracle))
            fin = np.isfinite(oracle)
            np.testing.assert_allclose(got[fin], oracle[fin], **E_TOL)
