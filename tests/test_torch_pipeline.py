"""Port parity: the video -> HDR pipeline (models/pipeline.py, BASELINE
config 5) against the JAX package, on the CPU in float64.

Scenes are three exposure videos (4 / 8 / 16 ms) of 24 x 40 x 3 frames,
small lossless AVIs written with cv2's RGBA fourcc from
``numpy.random.default_rng(seed)``; the JAX side decodes them with cv2.
The statistics are exact integer moments in both packages, so the stacks
are equal and the merged HDR value agrees within rtol 1e-10 and its std
within rtol 1e-9.  The calibration leg's DE draws differ by design (one
``torch.Generator`` per channel), so its solved curve is not compared: the
subsampled DN block it solves from is held equal, and the merge with a
fixed "solved" curve is held to the JAX package's.
"""
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
cv2 = pytest.importorskip("cv2")

import jax.numpy as jnp  # noqa: E402

from camera_linearity_tpu.models import calibration as jcal  # noqa: E402
from camera_linearity_tpu.models import pipeline as jpipe  # noqa: E402
from camera_linearity_tpu_torch import native  # noqa: E402
from camera_linearity_tpu_torch.models import calibration as tcal  # noqa
from camera_linearity_tpu_torch.models import pipeline as tpipe  # noqa
from camera_linearity_tpu_torch.ops import hdr_cuda  # noqa: E402
from camera_linearity_tpu_torch.utils import observability as obs  # noqa
from camera_linearity_tpu_torch.parallel import mesh as pmesh  # noqa: E402
from tests._torch_parallel_worker import world_of_one  # noqa: E402
from tests.test_torch_native import write_rgba_avi  # noqa: E402

VAL_TOL = dict(rtol=1e-10, atol=1e-14)
STD_TOL = dict(rtol=1e-9, atol=1e-14)
H, W = 24, 40
EXPOSURES_MS = (4, 8, 16)
ICRF = np.linspace(0, 1, 256)[:, None].repeat(3, 1) ** \
    np.array([1.8, 2.0, 2.2])


def make_scene(directory, seed, n_frames=9, gain=1.0, exposures_ms=None):
    """One scene's exposure videos of a static scene with read noise."""
    directory.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    base = rng.uniform(0.15, 0.45, (H, W, 3)) * gain
    paths = []
    for ms in exposures_ms or EXPOSURES_MS:
        mean = np.clip(base * ms / 16, 0, 1)
        frames = np.clip(mean[None] + rng.normal(0, 0.02, (n_frames, H, W,
                                                            3)), 0, 1)
        path = directory / f"{directory.name} {ms}ms.avi"
        write_rgba_avi(path, np.around(frames * 255).astype(np.uint8))
        paths.append(path)
    return paths


@pytest.fixture
def scenes(tmp_path):
    """Three scenes of distinct content (more scenes than the two pool
    pairs, so the third reuses the first's buffers)."""
    return {name: make_scene(tmp_path / name, seed, gain=1 + 0.4 * seed)
            for seed, name in enumerate(("a", "b", "c"))}


def _close(got_set, want_set):
    gv, gs = got_set.measurand.val, got_set.measurand.std
    np.testing.assert_allclose(gv.numpy(), np.asarray(want_set.measurand.val),
                               **VAL_TOL)
    np.testing.assert_allclose(gs.numpy(), np.asarray(want_set.measurand.std),
                               **STD_TOL)


@pytest.mark.parametrize("wire", [False, True])
def test_videos_to_stacks_equal_jax(scenes, wire):
    paths = scenes["a"][::-1]
    gv, gs, gexp, gpaths = tpipe.videos_to_stacks(paths, wire=wire,
                                                  device="cpu")
    jv, js, jexp, jpaths = jpipe.videos_to_stacks(paths, wire=wire,
                                                  decoder="cv2")
    assert gv.dtype == jv.dtype and gs.dtype == js.dtype
    np.testing.assert_array_equal(gv, jv)
    np.testing.assert_array_equal(gs.view(np.uint8), js.view(np.uint8))
    np.testing.assert_array_equal(gexp, jexp)
    assert gpaths == jpaths == scenes["a"]


def test_videos_to_exposure_series_equal_jax(scenes):
    got = tpipe.videos_to_exposure_series(scenes["a"], device="cpu")
    want = jpipe.videos_to_exposure_series(scenes["a"])
    assert [s.features for s in got.input_image_sets] == \
        [s.features for s in want.input_image_sets]
    for g, w in zip(got.input_image_sets, want.input_image_sets):
        assert g.device == torch.device("cpu")
        np.testing.assert_array_equal(g.measurand.val.numpy(),
                                      np.asarray(w.measurand.val))
        np.testing.assert_array_equal(g.measurand.std.numpy(),
                                      np.asarray(w.measurand.std))


@pytest.mark.parametrize("icrf_diff", [False, True])
def test_video_to_hdr_equals_jax(scenes, icrf_diff):
    diff = np.gradient(ICRF, 2 / 255, axis=0) if icrf_diff else None
    got = tpipe.video_to_hdr(scenes["b"], ICRF, diff, device="cpu")
    want = jpipe.video_to_hdr(scenes["b"], jnp.asarray(ICRF),
                              None if diff is None else jnp.asarray(diff))
    assert got.is_hdr and want.is_hdr
    assert got.path == want.path
    _close(got, want)


@pytest.mark.parametrize("wire", [("f32", "f32"), ("f32", "f16"),
                                  ("u16", "f16"), ("u16", None)])
def test_batch_video_to_hdr_equals_jax(scenes, wire):
    """Three scenes through two pool pairs, for every wire format."""
    wire_val, wire_std = wire
    got = tpipe.batch_video_to_hdr(scenes, ICRF, wire_val=wire_val,
                                   wire_std=wire_std, device="cpu")
    want = jpipe.batch_video_to_hdr(scenes, jnp.asarray(ICRF),
                                    wire_val=wire_val, wire_std=wire_std,
                                    decoder="cv2")
    assert list(got) == list(want) == ["a", "b", "c"]
    for name in got:
        assert got[name].is_hdr and got[name].path == want[name].path
        _close(got[name], want[name])


def test_batch_video_to_hdr_keeps_scenes_apart(scenes):
    """The third scene refills the first's pool pair: every scene's result
    must still be its own (its solo merge), not a later scene's."""
    out = tpipe.batch_video_to_hdr(scenes, ICRF, device="cpu")
    for name, paths in scenes.items():
        solo = tpipe.video_to_hdr(paths, ICRF, device="cpu")
        np.testing.assert_allclose(out[name].measurand.val.numpy(),
                                   solo.measurand.val.numpy(), **VAL_TOL,
                                   err_msg=f"scene {name!r}")
    assert not np.allclose(out["a"].measurand.val.numpy(),
                           out["c"].measurand.val.numpy())


def test_batch_video_to_hdr_runs_the_plain_merge_on_the_cpu(scenes):
    before = [k.launches for k in hdr_cuda.KERNELS]
    tpipe.batch_video_to_hdr({"a": scenes["a"]}, ICRF, device="cpu")
    assert [k.launches for k in hdr_cuda.KERNELS] == before


def test_batch_video_to_hdr_records_stages_and_decoder(scenes):
    obs.reset_stage_times()
    tpipe.batch_video_to_hdr(scenes, ICRF, device="cpu")
    stages = obs.snapshot_stage_times()
    for name in ("decode_s", "stats_s", "finalize_s", "upload_s",
                 "stacks_s", "assemble_s", "merge_s"):
        assert name in stages
    assert obs.decoded_frames.snapshot() == {"raw": 3 * 3 * 9}


def test_rejects_mismatched_exposures_before_decode(tmp_path, monkeypatch):
    scenes = {"s1": make_scene(tmp_path / "s1", 1, 2, exposures_ms=(4, 8)),
              "s2": make_scene(tmp_path / "s2", 2, 2, exposures_ms=(4, 16))}

    def no_decode(*args, **kwargs):
        raise AssertionError("decode started before the exposure check")
    monkeypatch.setattr(tpipe, "videos_to_stacks", no_decode)
    with pytest.raises(ValueError, match="scene 's2' has exposures"):
        tpipe.batch_video_to_hdr(scenes, ICRF, device="cpu")
    with pytest.raises(ValueError, match="scene 's2' has exposures"):
        jpipe.batch_video_to_hdr(scenes, jnp.asarray(ICRF))


def test_rejects_mismatched_geometry_before_decode(tmp_path, monkeypatch):
    small = tmp_path / "small"
    small.mkdir()
    paths = []
    for ms in EXPOSURES_MS:
        path = small / f"small {ms}ms.avi"
        write_rgba_avi(path, np.zeros((2, 8, 8, 3), np.uint8))
        paths.append(path)
    scenes = {"a": make_scene(tmp_path / "a", 1, 2), "small": paths}
    monkeypatch.setattr(tpipe, "videos_to_stacks", None)
    with pytest.raises(ValueError, match="scene 'small' has frame geometry"):
        tpipe.batch_video_to_hdr(scenes, ICRF, device="cpu")


def test_rejects_empty_scenes_and_bad_arguments(scenes):
    with pytest.raises(ValueError, match="scenes is empty"):
        tpipe.batch_video_to_hdr({}, ICRF, device="cpu")
    with pytest.raises(ValueError, match="scene 'a' has no videos"):
        tpipe.batch_video_to_hdr({"a": []}, ICRF, device="cpu")
    with pytest.raises(ValueError, match="wire_std"):
        tpipe.batch_video_to_hdr(scenes, ICRF, wire_std="f8", device="cpu")
    with pytest.raises(ValueError, match="wire_val"):
        tpipe.batch_video_to_hdr(scenes, ICRF, wire_val="u8", device="cpu")


def test_mesh_merge_equals_the_batched_merge(scenes, tmp_path):
    """On one process a mesh holds every scene and row: a ``mesh=`` call
    is accepted, as in the JAX package, and gives the batched merge's
    values."""
    # the first multi-threaded exp of a process on the CPU has come out
    # off in the last bits in some runs (tests/test_torch_lut_merge.py)
    torch.exp(torch.rand(3, 32, 128, 3))
    plain = tpipe.batch_video_to_hdr(scenes, ICRF, device="cpu")
    with world_of_one(tmp_path):
        meshed = tpipe.batch_video_to_hdr(
            scenes, ICRF, mesh=pmesh.data_pixel_mesh(device="cpu"),
            device="cpu")
    assert list(meshed) == list(plain)
    for name in plain:
        for got, want in ((meshed[name].measurand.val,
                           plain[name].measurand.val),
                          (meshed[name].measurand.std,
                           plain[name].measurand.std)):
            np.testing.assert_array_equal(got.numpy(), want.numpy())


def _spec(spacing=7):
    x = np.linspace(0, 1, 256)
    curves = np.stack([x ** g for g in np.linspace(1.6, 3.0, 25)])
    mean = curves.mean(axis=0)
    _, _, vt = np.linalg.svd(curves - mean, full_matrices=False)
    return dict(pca_arrays=np.stack([vt[:3].T] * 3),
                mean_icrf_arrays=np.stack([mean] * 3), spacing=spacing,
                popsize=6, maxiter=4, rng_seed=3)


@pytest.mark.parametrize("wire_val", ["f32", "u16"])
def test_calibration_leg_equals_jax_at_a_fixed_curve(scenes, monkeypatch,
                                                     wire_val):
    """Both packages' solvers are replaced by one that records the DN block
    it is given and returns the same fixed curve: the blocks are equal and
    so are the merges with that curve."""
    solved = np.linspace(0, 1, 256)[:, None].repeat(3, 1) ** 1.7
    seen = {}

    def fake(name, to_numpy):
        def calibration(lower, upper, channel_stacks, **kwargs):
            seen[name] = (to_numpy(channel_stacks[0]),
                          to_numpy(channel_stacks[2]), kwargs)
            return solved, None, None, None
        return calibration
    monkeypatch.setattr(tcal, "calibration",
                        fake("port", lambda t: t.cpu().numpy()))
    monkeypatch.setattr(jcal, "calibration", fake("jax", np.asarray))
    spec = _spec()
    got = tpipe.batch_video_to_hdr(scenes, ICRF, calibrate=spec,
                                   wire_val=wire_val, device="cpu")
    want = jpipe.batch_video_to_hdr(scenes, jnp.asarray(ICRF),
                                    calibrate=spec, wire_val=wire_val,
                                    decoder="cv2")
    (gdn, gexp, gkw), (jdn, jexp, jkw) = seen["port"], seen["jax"]
    assert gdn.shape == (3, -(-H * W // 7), 3)
    np.testing.assert_array_equal(gdn, jdn)
    np.testing.assert_array_equal(gexp, jexp)
    assert gkw["popsize"] == jkw["popsize"] == 6
    assert gkw["device"] == torch.device("cpu")
    for name in got:
        _close(got[name], want[name])


def test_calibration_leg_solves_and_drives_the_merge(scenes):
    obs.reset_stage_times()
    out = tpipe.batch_video_to_hdr({"a": scenes["a"]}, ICRF,
                                   calibrate=_spec(), device="cpu")["a"]
    assert obs.snapshot_stage_times().get("calibrate_s", 0) > 0
    assert torch.isfinite(out.measurand.val).all()
    plain = tpipe.batch_video_to_hdr({"a": scenes["a"]}, ICRF,
                                     device="cpu")["a"]
    assert not torch.allclose(out.measurand.val, plain.measurand.val)


def test_prewarm_leaves_warm_buffers_for_the_run(scenes, monkeypatch):
    monkeypatch.setattr(tpipe, "_SCENE_STACKS",
                        type(tpipe._SCENE_STACKS)())
    info = tpipe.prewarm_batch_video_to_hdr(3, 3, H, W, ICRF,
                                            calibrate=_spec(),
                                            wire_val="u16", device="cpu")
    assert info["h2d_mbps"] > 0
    key = ((3, H, W, 3), np.dtype(np.uint16).str, np.dtype(np.float16).str,
           False)
    assert key in tpipe._SCENE_STACKS
    tpipe.batch_video_to_hdr(scenes, ICRF, wire_val="u16", device="cpu")
    assert key in tpipe._SCENE_STACKS


def test_scene_stack_pool_checkout_is_exclusive():
    shape, dt = (2, 8, 8, 3), np.float64
    k1, p1 = tpipe._checkout_scene_stack_pool(shape, dt)
    k2, p2 = tpipe._checkout_scene_stack_pool(shape, dt)
    ids1 = {id(b) for pair in p1 for b in pair}
    ids2 = {id(b) for pair in p2 for b in pair}
    assert not ids1 & ids2
    tpipe._return_scene_stack_pool(k1, p1)
    tpipe._return_scene_stack_pool(k2, p2)
    _, p3 = tpipe._checkout_scene_stack_pool(shape, dt)
    assert {id(b) for pair in p3 for b in pair} & (ids1 | ids2)
    _, wire = tpipe._checkout_scene_stack_pool(shape, native.WIRE_U16F16)
    assert [b.dtype for b in wire[0]] == [np.uint16, np.float16]


def test_concurrent_calls_are_isolated(scenes):
    """Two concurrent calls of one geometry get distinct buffers and
    accumulators, so neither sums into the other's statistics."""
    serial = {name: tpipe.batch_video_to_hdr({name: scenes[name]}, ICRF,
                                             device="cpu")[name]
              for name in ("a", "c")}
    results, errors = {}, []

    def run(name):
        try:
            results[name] = tpipe.batch_video_to_hdr(
                {name: scenes[name]}, ICRF, device="cpu")[name]
        except Exception as exc:  # noqa: BLE001 — reported below
            errors.append(exc)
    threads = [threading.Thread(target=run, args=(n,)) for n in ("a", "c")]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    assert not errors, errors
    for name in ("a", "c"):
        np.testing.assert_array_equal(results[name].measurand.val.numpy(),
                                      serial[name].measurand.val.numpy())
