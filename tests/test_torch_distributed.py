"""Port parity: the multi-process flow, wired through the ``CL_*``
environment, as tests/integration/test_distributed.py runs the JAX
package's.

Gloo worlds on the CPU in float64 (tests/_torch_parallel_worker.py), each
group under its own timeout:

* two processes run ``batch_video_to_hdr`` on 4 scenes of small raw
  ``RGBA`` AVIs: the call routes to the distributed path, each process
  gets its disjoint contiguous block back, the merges agree with the JAX
  package's single-process merge of the same files (decoded by cv2) within
  1e-9, at full float width and with the f16 std on the wire, and the
  calibration leg gives both processes the curve the process of rank 0
  solved;
* the population-sharded DE equals the port's single-process DE at the
  rounded S (the same ``n_iter`` and ``frozen_at``, energies within rtol
  1e-12; popsize 15 and D = 5 give 76 members at 4 processes), also when
  it resumes from a checkpoint that only rank 0's path holds, and, where
  8 divides S, the JAX package's ``mesh``/``pop_axis`` solve on its
  8-device CPU mesh under the JAX draws
  (test_torch_calibration.py::test_batched_solve_trajectory_equals_jax);
* ``python -m camera_linearity_tpu_torch --device cpu doctor`` reports
  each process of two.
"""
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")
cv2 = pytest.importorskip("cv2")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import camera_linearity_tpu_torch as tpkg  # noqa: E402
from camera_linearity_tpu.models import calibration as jcal  # noqa: E402
from camera_linearity_tpu.models import pipeline as jpipe  # noqa: E402
from camera_linearity_tpu.ops import hdr as jhdr  # noqa: E402
from camera_linearity_tpu.ops import linearity as jlin  # noqa: E402
from camera_linearity_tpu.parallel import mesh as jmesh  # noqa: E402
from camera_linearity_tpu_torch.models import calibration as tcal  # noqa
from camera_linearity_tpu_torch.models import pipeline as tpipe  # noqa
from camera_linearity_tpu_torch.utils.checkpoint import (  # noqa: E402
    load_pytree, save_pytree)
from tests._torch_parallel_worker import launch  # noqa: E402
from tests.test_torch_calibration import (  # noqa: E402
    MUTATION, RECOMBINATION, TOL, _JaxDraws, _kw, _problem)
from tests.test_torch_pipeline import ICRF, _spec, make_scene  # noqa: E402

MERGE_ATOL = 1e-9
SCENES = ("s0", "s1", "s2", "s3")

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8,
                                reason="needs 8 virtual devices")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    root = tmp_path_factory.mktemp("scenes")
    return {name: make_scene(root / name, seed, gain=1 + 0.2 * seed)
            for seed, name in enumerate(SCENES)}


@pytest.fixture(scope="module")
def pipeline_run(tmp_path_factory, scenes):
    directory = tmp_path_factory.mktemp("pipeline")
    save_pytree(directory / "pipeline_inputs.pt", {
        "scenes": [(k, [str(p) for p in v]) for k, v in scenes.items()],
        "icrf": ICRF, "spec": _spec()})
    launch("pipeline", directory, 2)
    return [load_pytree(directory / f"pipeline_{r}.pt") for r in range(2)]


def _jax_merge(paths, icrf):
    val, std, exposures, _ = jpipe.videos_to_stacks(paths, decoder="cv2")
    icrf_j = jnp.asarray(icrf)
    from camera_linearity_tpu.ops.linearize import icrf_derivative
    v, s = jhdr.merge_batch(jnp.asarray(val[None]), jnp.asarray(std[None]),
                            jnp.asarray(exposures), icrf_j,
                            icrf_derivative(icrf_j, 256))
    return np.asarray(v[0]), np.asarray(s[0])


def test_each_process_merges_its_own_block(pipeline_run, scenes):
    """Each process's block, in full float width and with the f16 std on
    the wire, which the distributed path stages as one process does."""
    for rank, r in enumerate(pipeline_run):
        mine = list(SCENES[2 * rank:2 * rank + 2])
        assert r["names"] == r["f16_names"] == mine
        for name, v, s in zip(r["names"], r["val"], r["std"]):
            want_v, want_s = _jax_merge(scenes[name], ICRF)
            np.testing.assert_allclose(v.numpy(), want_v, rtol=0,
                                       atol=MERGE_ATOL)
            np.testing.assert_allclose(s.numpy(), want_s, rtol=0,
                                       atol=MERGE_ATOL)
        want = jpipe.batch_video_to_hdr({n: scenes[n] for n in mine},
                                        jnp.asarray(ICRF), wire_std="f16",
                                        decoder="cv2")
        for name, v, s in zip(mine, r["f16_val"], r["f16_std"]):
            np.testing.assert_allclose(
                v.numpy(), np.asarray(want[name].measurand.val), rtol=0,
                atol=MERGE_ATOL)
            np.testing.assert_allclose(
                s.numpy(), np.asarray(want[name].measurand.std), rtol=0,
                atol=MERGE_ATOL)


def test_calibration_leg_gives_every_process_rank_0s_curve(pipeline_run,
                                                           scenes):
    """Rank 0 solves from scene 0 as the single-process leg does; both
    processes merge with its curve."""
    first, second = pipeline_run
    for a, b in zip(first["tables"], second["tables"]):
        assert torch.equal(a, b)
    assert first["finite"]
    val, _, exposures, _ = tpipe.videos_to_stacks(scenes[SCENES[0]],
                                                  device="cpu")
    want = tpipe._calibrate_from_batch(
        torch.as_tensor(val[None]), torch.as_tensor(exposures),
        tpkg.CameraConfig(), _spec())
    for got, w in zip(first["tables"], want):
        np.testing.assert_allclose(got.numpy(), w.numpy(), **TOL)
    icrf = first["tables"][0].numpy()
    for rank, r in enumerate(pipeline_run):
        assert r["cal_names"] == list(SCENES[2 * rank:2 * rank + 2])
        for name, v, s in zip(r["cal_names"], r["cal_val"], r["cal_std"]):
            want_v, want_s = _jax_merge(scenes[name], icrf)
            np.testing.assert_allclose(v.numpy(), want_v, rtol=0,
                                       atol=MERGE_ATOL)
            np.testing.assert_allclose(s.numpy(), want_s, rtol=0,
                                       atol=MERGE_ATOL)


def _de_case(c, popsize, maxiter, tol, seed, gammas, energy_limit=0.0):
    stacks, exposures, mean_icrf, pca = _problem(gammas, pixels=60)
    stacks = stacks.astype(np.int64)
    ii, jj = jlin.upper_triangle_pairs(stacks.shape[-1])
    data = (np.stack([pca] * c), np.stack([mean_icrf] * c), stacks,
            exposures, ii, jj)
    kw = dict(x0=np.zeros(5), popsize=popsize, mutation=MUTATION,
              recombination=RECOMBINATION, tol=tol, maxiter=maxiter,
              seed=seed, energy_limit=energy_limit, population_energy=True)
    return dict(data=data, c=c, d=5, lower=np.full(5, -1.0),
                upper=np.full(5, 1.0), kw=kw)


def _port_solve(case, s, monkeypatch):
    """The port's single-process solve of ``case``, at S members."""
    monkeypatch.setattr(tcal, "_population_size", lambda *a: s)
    return _de_solve(case)


# popsize 15, D = 5: S = 75, 76 at 4 processes; the energy limit stops it
# at generation 26 of 60
ROUNDING = (1, 15, 60, 1e-3, 3, (2.2,), 0.05)
# a calibration whose S = 8 x 4 = 32 needs no rounding at 4 processes
CALIBRATION = dict(popsize=8, maxiter=20, tol=1e-3, rng_seed=5,
                   refine_rounds=1, refine_maxiter=6, polish_steps=10)


def _calibration_problem():
    stacks, exposures, mean_icrf, pca = _problem((2.2,), pixels=80)
    return stacks.astype(np.int64), exposures, mean_icrf, pca[:, :4]


# S = 40 members resumed at generation 5 of 15
RESUME = (1, 8, 15, 0.0, 13, (2.3,))


def _de_solve(case, **kw):
    """The port's single-process solve of ``case``."""
    energy = tcal._make_population_energy(True, "soft", 5, 250, 256, False)
    data = tuple(torch.as_tensor(np.asarray(x)) for x in case["data"])
    return tcal.differential_evolution_batched(
        energy, data, case["c"], case["d"], case["lower"], case["upper"],
        device="cpu", **dict(case["kw"], **kw))


@pytest.fixture(scope="module")
def de_runs(tmp_path_factory):
    """The sharded solves at 4 processes: ``rounding`` (S 75 -> 76),
    ``replay`` (S = 40 under the JAX draws of 15 generations), ``resume``
    (S = 40 from a checkpoint of generation 5 that only rank 0's path
    holds; ``resume_ref.ckpt`` keeps a copy)."""
    directory = tmp_path_factory.mktemp("de")
    replay = _de_case(2, 8, 15, 0.0, 11, (2.0, 2.4))
    jdraws = _JaxDraws(11, 2)
    replay["draws"] = [tuple(jdraws(None, 40, 5, MUTATION, RECOMBINATION,
                                    None)) for _ in range(15)]
    resume = dict(_de_case(*RESUME), resume=True)
    _de_solve(resume, maxiter=5, checkpoint_path=directory / "resume_0.ckpt")
    shutil.copy(directory / "resume_0.ckpt", directory / "resume_ref.ckpt")
    save_pytree(directory / "de_inputs.pt", {
        "solves": {"rounding": _de_case(*ROUNDING),
                   "replay": replay, "resume": resume},
        "calibration": dict(zip(("stacks", "exposures", "mean_icrf",
                                 "pca"), _calibration_problem()),
                            kw=CALIBRATION)})
    launch("de", directory, 4)
    return directory, [load_pytree(directory / f"de_{r}.pt")
                       for r in range(4)]


def _same_result(got, want, want_frozen):
    assert got["n_iter"] == want.n_iter
    np.testing.assert_array_equal(got["frozen"].numpy(),
                                  np.asarray(want_frozen))
    for key in ("population", "energies", "x", "initial_energy"):
        np.testing.assert_allclose(got[key].numpy(),
                                   np.asarray(getattr(want, key)), **TOL)


def test_sharded_de_rounds_s_and_equals_single_process(de_runs,
                                                       monkeypatch):
    _, ranks = de_runs
    case = _de_case(*ROUNDING)
    want, want_frozen = _port_solve(case, 76, monkeypatch)
    for r in ranks:
        assert r["rounding"]["population"].shape == (1, 76, 5)
        _same_result(r["rounding"], want, want_frozen)
    assert want.n_iter < 60  # it stopped early: n_iter and frozen_at say when


def test_sharded_de_equals_jax_mesh_solve_under_its_draws(de_runs,
                                                          monkeypatch):
    _, ranks = de_runs
    case = _de_case(2, 8, 15, 0.0, 11, (2.0, 2.4))
    stacks = case["data"][2]
    j_energy = jcal._make_population_energy(True, "soft", 5, 250, 256,
                                            False)
    onehots = jnp.stack([jlin.build_data_onehot(jnp.asarray(st), 256,
                                                jnp.float64)
                         for st in stacks])
    pca, mean, _, exposures, ii, jj = (np.asarray(x) for x in case["data"])
    j_data = (jnp.asarray(pca), jnp.asarray(mean), onehots,
              jnp.asarray(np.tile(exposures, (2, 1))),
              jnp.asarray(np.tile(ii, (2, 1))),
              jnp.asarray(np.tile(jj, (2, 1))))
    want, want_frozen = jcal.differential_evolution_batched(
        j_energy, j_data, 2, 5, case["lower"], case["upper"],
        mesh=jmesh.make_mesh((8,), ("data",)), pop_axis="data",
        **case["kw"])
    assert np.asarray(want.population).shape == (2, 40, 5)
    for r in ranks:
        _same_result(r["replay"], want, want_frozen)


def test_sharded_de_resumes_from_rank_0s_checkpoint_alone(de_runs):
    """Only rank 0's checkpoint path holds a checkpoint: every process
    resumes from the state rank 0 read, as one process resumes from it."""
    directory, ranks = de_runs
    assert not (directory / "resume_1.ckpt").exists()
    want, want_frozen = _de_solve(_de_case(*RESUME),
                                  checkpoint_path=directory
                                  / "resume_ref.ckpt")
    assert want.n_iter == 15
    for r in ranks:
        _same_result(r["resume"], want, want_frozen)


def test_sharded_calibration_equals_single_process(de_runs):
    """S needs no rounding at 4 processes, so the sharded calibration
    (global stage, refinement, polish and its broadcast) is the
    single-process one; so is a checkpointed one, which only rank 0
    writes."""
    directory, ranks = de_runs
    kw = _kw(*_calibration_problem(), **CALIBRATION)
    want = tcal.calibration(-1.0, 1.0, device="cpu", **kw)
    for r in ranks:
        for got, w in zip(r["calibration"], want):
            np.testing.assert_allclose(np.asarray(got), np.asarray(w), **TOL)
    plain = tcal.calibration(-1.0, 1.0, device="cpu",
                             **dict(kw, refine_rounds=0, polish_steps=0))
    for r in ranks:
        for got, w in zip(r["checkpoint"], plain):
            np.testing.assert_allclose(np.asarray(got), np.asarray(w), **TOL)
    assert (directory / "de.ckpt").exists()


def test_doctor_reports_each_process(tmp_path):
    import sys
    outs = launch("doctor", tmp_path, 2, argv=[
        sys.executable, "-m", "camera_linearity_tpu_torch", "--device",
        "cpu", "doctor"])
    for rank, out in enumerate(outs):
        assert f"multi-host: process {rank} of 2, backend gloo" in out, out
