"""Port parity: the statistics (ops/stats.py), the Measurand statistics
methods, utils/general.py, ImageSet differences and interpolation, and the
linearity analysis of ExposureSeries (``process_linearity``,
``collect_exposure_pair_stats``) against the JAX package.

Both packages get the same numpy inputs from the per-test ``rng``; the port
runs on float64 CPU tensors and the JAX package on the CPU under x64.
Tolerance rtol 1e-12 (atol 1e-14), and rtol 1e-10 for the KDE.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import camera_linearity_tpu as jpkg  # noqa: E402
import camera_linearity_tpu_torch as tpkg  # noqa: E402
from camera_linearity_tpu.models import exposure_series as jes  # noqa: E402
from camera_linearity_tpu.models import image_set as jis  # noqa: E402
from camera_linearity_tpu.ops import stats as jstats  # noqa: E402
from camera_linearity_tpu.utils import general as jgf  # noqa: E402
from camera_linearity_tpu_torch.models import \
    exposure_series as tes  # noqa: E402
from camera_linearity_tpu_torch.models import image_set as tis  # noqa: E402
from camera_linearity_tpu_torch.ops import stats as tstats  # noqa: E402
from camera_linearity_tpu_torch.utils import general as tgf  # noqa: E402

TOL = dict(rtol=1e-12, atol=1e-14)
KDE_TOL = dict(rtol=1e-10, atol=1e-12)
H, W, C = 18, 14, 3


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


def _close(got, want, tol=TOL):
    if want is None:
        assert got is None
        return
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), **tol)


def _close_dicts(got, want, tol=TOL):
    assert got.keys() == want.keys()
    for key in want:
        _close(got[key], want[key], tol)


def _data(rng, nan_frac=0.1, shape=(H, W, C)):
    val = rng.uniform(0.0, 1.0, shape)
    std = rng.uniform(0.001, 0.05, shape)
    val[rng.uniform(0, 1, shape) < nan_frac] = np.nan
    return val, std


# ---------------------------------------------------------------------------
# ops/stats.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("axis", [None, 0, (0, 1)])
@pytest.mark.parametrize("use_std", [True, False])
def test_dimension_statistics(rng, axis, use_std):
    val, std = _data(rng)
    std = std if use_std else None
    _close_dicts(tstats.dimension_statistics(_t(val), _t(std), axis=axis),
                 jstats.dimension_statistics(_j(val), _j(std), axis=axis))


@pytest.mark.parametrize("axis", [0, (0, 1)])
def test_nanaverage(rng, axis):
    val, std = _data(rng)
    weights = 1.0 / std
    weights[rng.uniform(0, 1, weights.shape) < 0.1] = np.nan
    val[:, 0] = np.nan  # a column with no valid weight gives NaN
    _close(tstats.nanaverage(_t(val), _t(weights), axis=axis),
           jstats.nanaverage(_j(val), _j(weights), axis=axis))


@pytest.mark.parametrize("weighted", [True, False])
def test_weighted_avg_and_std(rng, weighted):
    val = rng.normal(size=200)
    w = rng.uniform(0.1, 2.0, 200) if weighted else None
    for got, want in zip(tstats.weighted_avg_and_std(_t(val), _t(w)),
                         jstats.weighted_avg_and_std(_j(val), _j(w))):
        _close(got, want)


@pytest.mark.parametrize("sides", ["both", "lower", "upper", "none"])
@pytest.mark.parametrize("use_std", [True, False])
def test_apply_thresholds(rng, sides, use_std):
    val, std = _data(rng, nan_frac=0.0)
    std = std if use_std else None
    lower = rng.uniform(0.1, 0.3, C) if sides in ("both", "lower") else None
    upper = rng.uniform(0.7, 0.9, C) if sides in ("both", "upper") else None
    got = tstats.apply_thresholds(_t(val), _t(std), _t(lower), _t(upper))
    want = jstats.apply_thresholds(_j(val), _j(std), _j(lower), _j(upper))
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("included_range", [None, (0.2, 0.8)])
@pytest.mark.parametrize("use_std", [True, False])
def test_weighted_histogram(rng, included_range, use_std):
    val, std = _data(rng)
    std[rng.uniform(0, 1, std.shape) < 0.05] = 0.0  # zero stds drop out
    std = std if use_std else None
    got = tstats.weighted_histogram(_t(val[..., 0]), 16, included_range,
                                    None if std is None else _t(std[..., 0]))
    want = jstats.weighted_histogram(_j(val[..., 0]), 16, included_range,
                                     None if std is None
                                     else _j(std[..., 0]))
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("chunk", [131072, 37])
@pytest.mark.parametrize("use_std", [True, False])
def test_gaussian_kde(rng, chunk, use_std):
    val, std = _data(rng)
    std[0, 0] = 0.0
    std = std if use_std else None
    x = np.linspace(-0.2, 1.2, 41)
    _close(tstats.gaussian_kde(_t(val), _t(x), _t(std), chunk=chunk),
           jstats.gaussian_kde(_j(val), _j(x), _j(std), chunk=chunk),
           KDE_TOL)


@pytest.mark.parametrize("weighted", [True, False])
def test_weighted_percentile(rng, weighted):
    val = rng.normal(size=101)
    w = rng.integers(1, 4, 101).astype(float) if weighted else None
    pct = np.array([10.0, 25.0, 50.0, 75.0, 99.0])
    _close(tstats.weighted_percentile(_t(val), _t(pct), _t(w)),
           jstats.weighted_percentile(_j(val), _j(pct), _j(w)))
    _close(tstats.weighted_percentile(_t(val)),
           jstats.weighted_percentile(_j(val)))


# ---------------------------------------------------------------------------
# Measurand statistics methods
# ---------------------------------------------------------------------------

def _measurands(val, std):
    return tpkg.Measurand(_t(val), _t(std)), jpkg.Measurand(_j(val), _j(std))


@pytest.mark.parametrize("use_std", [True, False])
def test_measurand_statistics(rng, use_std):
    val, std = _data(rng)
    tm, jm = _measurands(val, std if use_std else None)
    for axis in (None, (0, 1)):
        _close_dicts(tm.compute_dimension_statistics(axis=axis),
                     jm.compute_dimension_statistics(axis=axis))
    for rng_ in (None, (0.1, 0.9)):
        got = tm.compute_channel_histogram(12, rng_, use_std=use_std)
        want = jm.compute_channel_histogram(12, rng_, use_std=use_std)
        assert got.keys() == want.keys() == {0, 1, 2}
        for c in want:
            for g, w in zip(got[c], want[c]):
                _close(g, w)
    got = tm.compute_kernel_density_estimate(25, channels=[0, 2],
                                             use_std=use_std)
    want = jm.compute_kernel_density_estimate(25, channels=[0, 2],
                                              use_std=use_std)
    assert got.keys() == want.keys() == {0, 2}
    for c in want:
        for g, w in zip(got[c], want[c]):
            _close(g, w, KDE_TOL)


@pytest.mark.parametrize("use_std", [True, False])
def test_measurand_apply_thresholds(rng, use_std):
    val, std = _data(rng, nan_frac=0.0)
    tm, jm = _measurands(val, std if use_std else None)
    for lower, upper in (([0.2, None, 0.1], [0.8, 0.9, None]),
                         (None, [0.7, 0.7, 0.7]),
                         (np.array([0.1, 0.2, 0.3]), None)):
        got = tm.apply_thresholds(lower, upper)
        want = jm.apply_thresholds(lower, upper)
        _close(got.val, want.val)
        _close(got.std, want.std)
    with pytest.raises(ValueError, match="Threshold length"):
        tm.apply_thresholds([0.1, 0.2])


# ---------------------------------------------------------------------------
# utils/general.py
# ---------------------------------------------------------------------------

def test_general_helpers(rng):
    arr = rng.uniform(0, 1, (17, 23, 3))
    for steps in ((4,), (3, 5)):
        _close(tgf.choose_evenly_spaced_points(_t(arr), *steps),
               jgf.choose_evenly_spaced_points(_j(arr), *steps))
        assert tgf.predict_output_shape((17, 23), *steps) == \
            jgf.predict_output_shape((17, 23), *steps)
    table = rng.uniform(0, 1, (5, 64))
    for points in (64, 256, 20):
        _close(tgf.interpolate_data(_t(table), 64, points),
               jgf.interpolate_data(_j(table), 64, points))


@pytest.mark.parametrize("limit", [None, 10])
@pytest.mark.parametrize("icrf_ndim", [0, 1, 2])
def test_map_linearity_limits(rng, limit, icrf_ndim):
    cfg = tpkg.CameraConfig()
    jcfg = jpkg.CameraConfig()
    icrf = None if icrf_ndim == 0 else np.sort(
        rng.uniform(0, 1, (256, C) if icrf_ndim == 2 else 256), axis=0)
    got = tgf.map_linearity_limits(limit, limit, _t(icrf), cfg)
    want = jgf.map_linearity_limits(limit, limit, _j(icrf), jcfg)
    for g, w in zip(got, want):
        _close(g, w)


# ---------------------------------------------------------------------------
# ImageSet differences and interpolation, ExposurePair
# ---------------------------------------------------------------------------

def _set_pair(name, val, std):
    cfg, jcfg = tpkg.CameraConfig(), jpkg.CameraConfig()
    return (tis.ImageSet(name, config=cfg,
                         measurand=tpkg.Measurand(_t(val), _t(std))),
            jis.ImageSet(name, config=jcfg,
                         measurand=jpkg.Measurand(_j(val), _j(std))))


@pytest.mark.parametrize("use_std", [True, False])
def test_image_set_difference_and_interpolation(rng, use_std):
    (v0, s0), (v1, s1) = _data(rng, 0.0), _data(rng, 0.0)
    if not use_std:
        s0 = s1 = None
    t0, j0 = _set_pair("10ms BF a 50x.tif", v0, s0)
    t1, j1 = _set_pair("40ms BF a 50x.tif", v1, s1)
    for got, want in zip(tis.ImageSet.compute_difference(t0, t1),
                         jis.ImageSet.compute_difference(j0, j1)):
        assert got.features == want.features and got.path == want.path
        _close(got.val, want.val)
        _close(got.std, want.std)
    got = tis.ImageSet.exposure_interpolation(t0, t1, 0.025)
    want = jis.ImageSet.exposure_interpolation(j0, j1, 0.025)
    assert got.features == want.features and got.path is None
    _close(got.val, want.val)
    _close(got.std, want.std)
    with pytest.raises(TypeError):
        tis.ImageSet.exposure_interpolation(t0, t1, 1)
    with pytest.raises(ValueError):
        tis.ImageSet.exposure_interpolation(t0, t1, 0.5)


def test_exposure_pair_methods(rng):
    (v0, s0), (v1, s1) = _data(rng), _data(rng)
    t0, j0 = _set_pair("10ms BF a 50x.tif", v0, s0)
    t1, j1 = _set_pair("40ms BF a 50x.tif", v1, s1)
    tp, jp = tes.ExposurePair(t0, t1), jes.ExposurePair(j0, j1)
    assert tp.exposure_ratio == jp.exposure_ratio
    for p in (tp, jp):
        p.compute_difference()
    for use_std in (True, False):
        got = tp.process_linearity_distribution(10, (-0.5, 0.5),
                                                use_std=use_std)
        want = jp.process_linearity_distribution(10, (-0.5, 0.5),
                                                 use_std=use_std)
        for g, w in zip(got, want):
            for c in w:
                for a, b in zip(g[c], w[c]):
                    _close(a, b)
    for p in (tp, jp):
        p.compute_stats(axis=(0, 1))
    assert tp.absolute_difference is None
    _close_dicts(tp.absolute_stats, jp.absolute_stats)
    _close_dicts(tp.relative_stats, jp.relative_stats)


# ---------------------------------------------------------------------------
# ExposureSeries.process_linearity and collect_exposure_pair_stats
# ---------------------------------------------------------------------------

EXPOSURES_MS = (5, 10, 20, 40, 80, 400)


def _series(rng, with_icrf):
    n = len(EXPOSURES_MS)
    vals = rng.uniform(0.0, 1.0, (n, H, W, C))
    stds = rng.uniform(0.001, 0.02, (n, H, W, C))
    pairs = [_set_pair(f"{ms}ms BF a 50x.tif", vals[e], stds[e])
             for e, ms in enumerate(EXPOSURES_MS)]
    cfg, jcfg = tpkg.CameraConfig(), jpkg.CameraConfig()
    icrf = np.sort(rng.uniform(0, 1, (256, C)), axis=0) if with_icrf \
        else None
    return (tes.ExposureSeries(input_image_sets=[t for t, _ in pairs],
                               config=cfg),
            jes.ExposureSeries(input_image_sets=[j for _, j in pairs],
                               config=jcfg), icrf)


def _close_collected(got, want):
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for key in w:
            if w[key] is None:
                assert g[key] is None
            else:
                np.testing.assert_allclose(g[key], w[key], **TOL)


@pytest.mark.parametrize("limit", [None, 20])
@pytest.mark.parametrize("with_icrf", [True, False])
@pytest.mark.parametrize("use_std", [True, False])
def test_process_linearity(rng, use_std, with_icrf, limit):
    t_series, j_series, icrf = _series(rng, with_icrf)
    t_series.process_linearity(_t(icrf), limit, use_std=use_std)
    j_series.process_linearity(_j(icrf), limit, use_std=use_std)
    # the ratio filter drops 5 of the 15 pairs (5/80 and every pair with
    # 400, 40/400 by float rounding): 10 pairs, more than one batch of 8
    assert len(t_series.exposure_pairs) == len(j_series.exposure_pairs) == 10
    for tp, jp in zip(t_series.exposure_pairs, j_series.exposure_pairs):
        _close_dicts(tp.absolute_stats, jp.absolute_stats)
        _close_dicts(tp.relative_stats, jp.relative_stats)
    for ts, js in zip(t_series.input_image_sets, j_series.input_image_sets):
        _close(ts.val, js.val)  # the thresholds' NaNs land alike
    got = t_series.collect_exposure_pair_stats()
    want = j_series.collect_exposure_pair_stats()
    assert (got[0]["errors"] is None) == (not use_std)
    _close_collected(got, want)


def test_process_linearity_batched_matches_per_pair(rng):
    """More pairs than one batch of 8, and hand-built pairs of sets outside
    the series (one call per pair) agree with the batched path."""
    t_series, _, _ = _series(rng, False)
    t_series.process_linearity(use_std=True)
    batched = t_series.collect_exposure_pair_stats()
    sets = t_series.input_image_sets
    foreign = tes.ExposureSeries(input_image_sets=sets)
    foreign.exposure_pairs = [tes.ExposurePair(p.short_exposure,
                                               p.long_exposure)
                              for p in t_series.exposure_pairs]
    outsider = tis.ImageSet("10ms BF a 50x.tif",
                            measurand=sets[1].measurand)
    foreign.exposure_pairs.append(tes.ExposurePair(sets[0], outsider))
    foreign.process_linearity(use_std=True)
    per_pair = foreign.collect_exposure_pair_stats()
    for b, p in zip(batched, per_pair):
        for key in ("means", "stds", "errors"):
            np.testing.assert_allclose(p[key][:-1], b[key], **TOL)
