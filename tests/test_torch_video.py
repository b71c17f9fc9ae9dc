"""Port parity: the Welford ops (ops/welford.py) and the video statistics
(models/video.py) against the JAX package, on the CPU.

Videos are small lossless AVIs written with cv2's RGBA fourcc from
``numpy.random.default_rng(seed)``: the JAX side decodes them with cv2
(``decoder="cv2"``), the port with its NumPy reader.  Tolerances:

* the Welford ops and ``calculate_std`` in float64: rtol 1e-12;
* the host backend (exact integer moments), noise profiles and
  ``clean_data_edges``: equal;
* the port's device backend (float64 on the CPU) against the reference
  loop's float64 oracle: rtol 1e-12; against the JAX device backend, which
  accumulates in float32 whatever x64 says: rtol 1e-5 / atol 1e-6 (mean),
  rtol 1e-3 / atol 1e-6 (std).
"""
import logging
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
cv2 = pytest.importorskip("cv2")

import jax.numpy as jnp  # noqa: E402

from camera_linearity_tpu import CameraConfig as JConfig  # noqa: E402
from camera_linearity_tpu import native as jnative  # noqa: E402
from camera_linearity_tpu.models import pipeline as jpipe  # noqa: E402
from camera_linearity_tpu.models import video as jvideo  # noqa: E402
from camera_linearity_tpu.ops import welford as jwf  # noqa: E402
from camera_linearity_tpu_torch import CameraConfig, native  # noqa: E402
from camera_linearity_tpu_torch.models import pipeline as tpipe  # noqa
from camera_linearity_tpu_torch.models import video as tvideo  # noqa: E402
from camera_linearity_tpu_torch.ops import welford as twf  # noqa: E402
from camera_linearity_tpu_torch.utils import observability as obs  # noqa
from camera_linearity_tpu_torch.utils.state import \
    welford_state_from_numpy  # noqa: E402
from tests.test_torch_native import (DATA, avi_bytes,  # noqa: E402
                                     write_rgba_avi)
from tests.unit.test_video import numpy_welford  # noqa: E402

TOL = dict(rtol=1e-12, atol=1e-15)
F32_MEAN = dict(rtol=1e-5, atol=1e-6)
F32_STD = dict(rtol=1e-3, atol=1e-6)
H, W = 24, 40


def _frames(seed, n, lo=40, hi=220):
    return np.random.default_rng(seed).integers(lo, hi, (n, H, W, 3),
                                                dtype=np.uint8)


@pytest.fixture
def video(tmp_path):
    """13 frames: with batch_size 8, one full batch and a short one."""
    frames = _frames(13, 13)
    path = tmp_path / "scene 5ms.avi"
    write_rgba_avi(path, frames)
    return path, frames


def _icrf(bits):
    return np.linspace(0, 1, bits)[:, None].repeat(3, 1) ** \
        np.array([2.0, 2.2, 2.4])


# --- ops/welford.py --------------------------------------------------------

@pytest.mark.parametrize("n", [1, 5, 16])
def test_welford_update_and_finalize(n):
    frames = np.random.default_rng(n).uniform(0, 1, (n, 5, 6, 3))
    js = jwf.welford_init((5, 6, 3), dtype=jnp.float64)
    ts = twf.welford_init((5, 6, 3), torch.float64)
    for f in frames:
        js = jwf.welford_update(js, jnp.asarray(f))
        ts = twf.welford_update(ts, torch.as_tensor(f))
    assert int(ts.count) == int(js.count) == n
    np.testing.assert_allclose(ts.mean.numpy(), np.asarray(js.mean), **TOL)
    np.testing.assert_allclose(ts.m2.numpy(), np.asarray(js.m2), **TOL)
    jm, jstd = jwf.welford_finalize(js, use_std=n >= 2)
    tm, tstd = twf.welford_finalize(ts, use_std=n >= 2)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), **TOL)
    if n >= 2:
        np.testing.assert_allclose(tstd.numpy(), np.asarray(jstd), **TOL)
        om, ostd = numpy_welford(frames)
        np.testing.assert_allclose(tstd.numpy(), ostd, **TOL)
    else:
        assert tstd is None and jstd is None


@pytest.mark.parametrize("batches", [(8,), (8, 5), (3, 3, 3)])
def test_welford_update_batch(batches):
    frames = np.random.default_rng(len(batches)).uniform(
        0, 1, (sum(batches), 4, 7, 3))
    js = jwf.welford_init((4, 7, 3), dtype=jnp.float64)
    ts = twf.welford_init((4, 7, 3), torch.float64)
    start = 0
    for b in batches:
        js = jwf.welford_update_batch(js, jnp.asarray(frames[start:start + b]))
        ts = twf.welford_update_batch(ts, torch.as_tensor(
            frames[start:start + b]))
        start += b
    for t, j in zip(twf.welford_finalize(ts), jwf.welford_finalize(js)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)


@pytest.mark.parametrize("bits", [256, 4096])
def test_welford_update_batch_lut(bits):
    max_dn = bits - 1
    frames = np.random.default_rng(bits).integers(0, bits, (6, 4, 5, 3))
    icrf = _icrf(bits)
    js = jwf.welford_init((4, 5, 3), dtype=jnp.float64)
    ts = twf.welford_init((4, 5, 3), torch.float64)
    js = jwf.welford_update_batch_lut(js, jnp.asarray(frames),
                                      jnp.asarray(icrf), max_dn)
    ts = twf.welford_update_batch_lut(ts, torch.as_tensor(frames),
                                      torch.as_tensor(icrf), max_dn)
    for t, j in zip(twf.welford_finalize(ts), jwf.welford_finalize(js)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)
    lin = icrf[frames, np.arange(3)]
    np.testing.assert_allclose(twf.welford_finalize(ts)[1].numpy(),
                               numpy_welford(lin)[1], **TOL)


def test_welford_resumes_a_jax_state():
    frames = np.random.default_rng(2).uniform(0, 1, (9, 3, 4, 3))
    js = jwf.welford_update_batch(jwf.welford_init(
        (3, 4, 3), dtype=jnp.float64), jnp.asarray(frames[:4]))
    ts = welford_state_from_numpy(np.asarray(js.count), np.asarray(js.mean),
                                  np.asarray(js.m2), device="cpu")
    assert ts.mean.dtype == torch.float64 and int(ts.count) == 4
    js = jwf.welford_update_batch(js, jnp.asarray(frames[4:]))
    ts = twf.welford_update_batch(ts, torch.as_tensor(frames[4:]))
    for t, j in zip(twf.welford_finalize(ts), jwf.welford_finalize(js)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)
    with pytest.raises(ValueError, match="one shape"):
        welford_state_from_numpy(1, np.zeros((2, 2)), np.zeros((2, 3)),
                                 device="cpu")


# --- welford_algorithm: the host backend ------------------------------------

@pytest.mark.parametrize("dtype", ["f64", "f32", "wire"])
@pytest.mark.parametrize("use_out", [False, True])
def test_host_backend_equals_jax(video, dtype, use_out):
    path, _ = video
    dt = {"f64": np.float64, "f32": np.float32,
          "wire": native.WIRE_U16F16}[dtype]

    def out():
        if not use_out:
            return None
        vd, sd = dt if dtype == "wire" else (dt, dt)
        return np.zeros((H, W, 3), vd), np.zeros((H, W, 3), sd)
    got = tvideo.welford_algorithm(path, use_std=True, dtype=dt, out=out(),
                                   batch_size=8)
    want = jvideo.welford_algorithm(path, use_std=True, dtype=dt, out=out(),
                                    batch_size=8, decoder="cv2")
    for key in ("mean", "std"):
        assert got[key].dtype == want[key].dtype
        np.testing.assert_array_equal(got[key], want[key])


@pytest.mark.parametrize("use_std", [False, True])
def test_host_backend_quantized_equals_jax(video, use_std):
    path, _ = video
    got = tvideo.welford_algorithm(path, use_std=use_std, quantize=True)
    want = jvideo.welford_algorithm(path, use_std=use_std, quantize=True,
                                    decoder="cv2")
    assert got["mean"].dtype == np.uint8
    np.testing.assert_array_equal(got["mean"], want["mean"])
    if use_std:
        np.testing.assert_array_equal(got["std"], want["std"])
    else:
        assert got["std"] is None and want["std"] is None


@pytest.mark.parametrize("backend", ["host", "device"])
def test_a_single_frame_has_no_std(tmp_path, backend):
    path = tmp_path / "one 5ms.avi"
    write_rgba_avi(path, _frames(1, 1))
    out = (np.full((H, W, 3), 7.0), np.full((H, W, 3), 7.0))
    got = tvideo.welford_algorithm(path, use_std=True, backend=backend,
                                   out=out, device="cpu")
    want = jvideo.welford_algorithm(path, use_std=True, backend=backend,
                                    decoder="cv2")
    assert want["std"] is None and not out[1].any()
    np.testing.assert_allclose(got["mean"], want["mean"], **F32_MEAN)
    assert tvideo.welford_algorithm(path, use_std=True, backend=backend,
                                    device="cpu")["std"] is None


# --- welford_algorithm: the device backend ----------------------------------

@pytest.mark.parametrize("batch_size", [8, 32])
def test_device_backend_against_the_oracle_and_jax(video, batch_size):
    path, frames = video
    got = tvideo.welford_algorithm(path, use_std=True, backend="device",
                                   batch_size=batch_size, device="cpu")
    om, ostd = numpy_welford(frames / 255.0)
    np.testing.assert_allclose(got["mean"], om, **TOL)
    np.testing.assert_allclose(got["std"], ostd, rtol=1e-12, atol=1e-16)
    want = jvideo.welford_algorithm(path, use_std=True, backend="device",
                                    batch_size=batch_size)
    np.testing.assert_allclose(got["mean"], want["mean"], **F32_MEAN)
    np.testing.assert_allclose(got["std"], want["std"], **F32_STD)
    host = tvideo.welford_algorithm(path, use_std=True)
    np.testing.assert_allclose(got["mean"], host["mean"], **TOL)
    np.testing.assert_allclose(got["std"], host["std"], rtol=1e-10)


@pytest.mark.parametrize("icrf_as", ["numpy", "tensor"])
def test_device_backend_with_an_icrf(video, icrf_as):
    path, frames = video
    icrf = _icrf(256)
    arg = icrf if icrf_as == "numpy" else torch.as_tensor(icrf)
    got = tvideo.welford_algorithm(path, ICRF=arg, use_std=True,
                                   batch_size=8, device="cpu")
    om, ostd = numpy_welford(icrf[frames, np.arange(3)])
    np.testing.assert_allclose(got["mean"], om, **TOL)
    np.testing.assert_allclose(got["std"], ostd, rtol=1e-12, atol=1e-16)
    want = jvideo.welford_algorithm(path, ICRF=jnp.asarray(icrf),
                                    use_std=True, batch_size=8)
    np.testing.assert_allclose(got["mean"], want["mean"], **F32_MEAN)
    np.testing.assert_allclose(got["std"], want["std"], **F32_STD)


@pytest.mark.parametrize("dtype", ["f32", "wire"])
def test_device_backend_output_types(video, dtype):
    path, _ = video
    dt = np.float32 if dtype == "f32" else native.WIRE_U16F16
    out = None
    if dtype == "wire":
        out = (np.zeros((H, W, 3), np.uint16), np.zeros((H, W, 3),
                                                        np.float16))
    got = tvideo.welford_algorithm(path, use_std=True, backend="device",
                                   dtype=dt, out=out, batch_size=8,
                                   device="cpu")
    full = tvideo.welford_algorithm(path, use_std=True, backend="device",
                                    batch_size=8, device="cpu")
    if dtype == "f32":
        np.testing.assert_array_equal(got["mean"],
                                      full["mean"].astype(np.float32))
        np.testing.assert_array_equal(got["std"],
                                      full["std"].astype(np.float32))
        return
    assert got["mean"] is out[0] and got["std"] is out[1]
    wm, ws = native.wire_quantize_u16f16(full["mean"], full["std"])
    np.testing.assert_array_equal(out[0], wm)
    np.testing.assert_array_equal(out[1], ws)
    # the JAX device backend quantizes its float32 mean: one grid step
    jwant = jvideo.welford_algorithm(path, use_std=True, backend="device",
                                     dtype=native.WIRE_U16F16, batch_size=8)
    assert np.abs(out[0].astype(int) - jwant["mean"]).max() <= 1


def test_device_backend_quantized(video):
    path, _ = video
    got = tvideo.welford_algorithm(path, ICRF=_icrf(256), use_std=True,
                                   quantize=True, device="cpu")
    want = jvideo.welford_algorithm(path, ICRF=jnp.asarray(_icrf(256)),
                                    use_std=True, quantize=True)
    assert got["mean"].dtype == np.uint8
    # float32 accumulation in JAX may flip a borderline rounding by one DN
    assert np.abs(got["mean"].astype(int) - want["mean"]).max() <= 1
    np.testing.assert_array_equal(got["std"], want["std"])


def test_welford_algorithm_argument_errors(video):
    path, _ = video
    with pytest.raises(ValueError, match="backend"):
        tvideo.welford_algorithm(path, backend="gpu")
    with pytest.raises(ValueError, match="cannot apply an ICRF"):
        tvideo.welford_algorithm(path, ICRF=_icrf(256), backend="host")
    with pytest.raises(ValueError, match="incompatible"):
        tvideo.welford_algorithm(path, quantize=True,
                                 dtype=native.WIRE_U16F16)
    with pytest.raises(ValueError, match="only supported dtype pair"):
        tvideo.welford_algorithm(path, dtype=(np.uint16, np.float32))


def test_two_videos_pool_into_one_mean(tmp_path):
    a, b = _frames(1, 5), _frames(2, 4)
    paths = [tmp_path / "a 5ms.avi", tmp_path / "b 5ms.avi"]
    write_rgba_avi(paths[0], a)
    write_rgba_avi(paths[1], b)
    got = tvideo.welford_algorithm(paths, use_std=True, batch_size=3,
                                   backend="device", device="cpu")
    om, ostd = numpy_welford(np.concatenate([a, b]) / 255.0)
    np.testing.assert_allclose(got["mean"], om, **TOL)
    np.testing.assert_allclose(got["std"], ostd, rtol=1e-12, atol=1e-16)


# --- decoders ------------------------------------------------------------------

def test_decoder_resolution(video, tmp_path, monkeypatch, caplog):
    path, _ = video
    mjpg = DATA / "mjpg 5ms.avi"
    resolve = tvideo._resolve_decoder
    assert resolve("native", [path], H, W, 3) == ["raw"]
    assert resolve("cv2", [path], H, W, 3) == ["cv2"]
    monkeypatch.delenv("CL_DECODER", raising=False)
    assert resolve("auto", [path], H, W, 3) == ["raw"]
    monkeypatch.setenv("CL_DECODER", "cv2")
    assert resolve("auto", [path], H, W, 3) == ["cv2"]
    if native.mjpeg_available():
        assert resolve("native", [mjpg], 32, 48, 3) == ["ffmpeg"]
        assert resolve("turbo_fast", [mjpg], 32, 48, 3) == ["turbo_fast"]
    logger = logging.getLogger("camera_linearity_tpu_torch")
    logger.addHandler(caplog.handler)  # the port's logger does not propagate
    try:
        assert resolve("turbo", [path], H, W, 3) == ["raw"]
    finally:
        logger.removeHandler(caplog.handler)
    assert "not an MJPG AVI" in caplog.text
    with pytest.raises(ValueError, match="unknown decoder"):
        resolve("libav", [path], H, W, 3)
    with pytest.raises(ValueError, match="frame geometry"):
        resolve("native", [mjpg, path], 32, 48, 3)


@pytest.mark.parametrize("fourcc", ["DIV3", "MP42"])
def test_other_codecs_need_cv2(tmp_path, monkeypatch, fourcc):
    # MS-MPEG4 (v3 under DIV3, v2 under MP42), a lossy codec the port has
    # no decoder of
    path = tmp_path / f"{fourcc.lower()} 5ms.avi"
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*fourcc), 10,
                             (W, H))
    frames = _frames(4, 3)
    for f in frames:
        writer.write(f)
    writer.release()
    assert tvideo._resolve_decoder("native", [path], H, W, 3) == ["cv2"]
    got = tvideo.welford_algorithm(path, use_std=True)
    np.testing.assert_array_equal(
        got["mean"], jvideo.welford_algorithm(path, use_std=True,
                                              decoder="cv2")["mean"])
    monkeypatch.setitem(sys.modules, "cv2", None)  # cv2 not installed
    with pytest.raises(ValueError, match=f"codec '{fourcc}'.*needs cv2"):
        tvideo._resolve_decoder("native", [path], H, W, 3)
    with pytest.raises(ValueError, match="needs cv2"):
        tvideo._resolve_decoder("cv2", [path], H, W, 3)


def test_raw_avis_need_no_cv2(video, monkeypatch):
    path, frames = video
    monkeypatch.setitem(sys.modules, "cv2", None)
    assert tvideo.probe_geometry(path) == (H, W)
    got = tvideo.welford_algorithm(path, use_std=True)
    om, _ = numpy_welford(frames / 255.0)
    np.testing.assert_allclose(got["mean"], om, **TOL)


@pytest.mark.parametrize("decoder", ["native", "turbo"])
def test_a_grayscale_mjpg_is_rejected_before_decode(tmp_path, decoder,
                                                    monkeypatch):
    """A 1-component MJPG.  At ``decoder="native"`` (the ``ffmpeg`` mode)
    it decodes to three equal channels, as cv2 gives it, and the port's
    statistics equal the JAX package's default (cv2) at rtol 1e-10.  The
    ``turbo`` mode does not read grayscale: it raises before any frame is
    decoded, naming it (and with ``num_of_chs=3``, naming the component
    count first, as ``_resolve_decoder`` checks it)."""
    monkeypatch.delenv("CL_DECODER", raising=False)
    rng = np.random.default_rng(3)
    frames = []
    for _ in range(3):
        ok, jpeg = cv2.imencode(".jpg", rng.integers(60, 200, (H, W),
                                                     dtype=np.uint8))
        assert ok
        frames.append(jpeg.tobytes())
    path = tmp_path / "gray 5ms.avi"
    path.write_bytes(avi_bytes(b"MJPG", H, W, 24, frames))
    if decoder == "native":
        got = tvideo.welford_algorithm(path, use_std=True, decoder=decoder,
                                       device="cpu")
        want = jvideo.welford_algorithm(path, use_std=True)
        for key in ("mean", "std"):
            np.testing.assert_allclose(got[key], want[key], rtol=1e-10,
                                       atol=1e-15)
        assert np.array_equal(got["mean"][..., 0], got["mean"][..., 1])
        return

    def no_decode(*args, **kwargs):
        raise AssertionError("a frame was decoded")
    monkeypatch.setattr(native, "jpeg_decode_bgr_batch", no_decode)
    with pytest.raises(ValueError, match="1 components.*num_of_chs=3"):
        tvideo.welford_algorithm(path, decoder=decoder)
    with pytest.raises(ValueError, match="grayscale"):
        tvideo.welford_algorithm(path, decoder=decoder,
                                 config=tvideo.CameraConfig(num_of_chs=1))


def _mjpg_scene(directory, seed, n_frames=6):
    """One scene's exposure videos as cv2 writes MJPG AVIs."""
    directory.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    base = rng.uniform(0.15, 0.45, (H, W, 3))
    paths = []
    for ms in (4, 8, 16):
        path = directory / f"{directory.name} {ms}ms.avi"
        out = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"MJPG"), 10,
                              (W, H))
        for _ in range(n_frames):
            frame = np.clip(base * ms / 16 + rng.normal(0, 0.02, (H, W, 3)),
                            0, 1)
            out.write(np.around(frame * 255).astype(np.uint8))
        out.release()
        paths.append(path)
    return paths


@pytest.mark.parametrize("decoder", ["turbo", "turbo_fast"])
def test_mjpg_batch_video_to_hdr_equals_jax(tmp_path, decoder):
    """MJPG scenes through the port's decoder and the JAX package's
    libjpeg one decode to the same frames, so the pipelines agree as on
    raw videos (tests/test_torch_pipeline.py's tolerances)."""
    if not jnative.mjpeg_available():
        pytest.skip("the oracle, the JAX package's libjpeg decoder, did not "
                    "build")
    icrf = _icrf(256)
    scenes = {name: _mjpg_scene(tmp_path / name, seed)
              for seed, name in enumerate(("a", "b"))}
    obs.reset_stage_times()
    got = tpipe.batch_video_to_hdr(scenes, icrf, decoder=decoder,
                                   device="cpu")
    assert obs.decoded_frames.snapshot() == {decoder: 2 * 3 * 6}
    want = jpipe.batch_video_to_hdr(scenes, jnp.asarray(icrf),
                                    decoder=decoder)
    for name in scenes:
        np.testing.assert_allclose(
            got[name].measurand.val.numpy(),
            np.asarray(want[name].measurand.val), rtol=1e-10, atol=1e-14)
        np.testing.assert_allclose(
            got[name].measurand.std.numpy(),
            np.asarray(want[name].measurand.std), rtol=1e-9, atol=1e-14)


def test_a_failed_mjpeg_build_raises_and_never_reaches_cv2(monkeypatch):
    """An MJPG AVI takes the port's decoder or raises: a failed build of
    ``_mjpeg`` is reported, not hidden behind cv2."""
    monkeypatch.setattr(native, "_load_mjpeg", lambda: None)
    monkeypatch.setitem(native._build_errors, "_mjpeg",
                        "g++: simulated failure")

    def no_cv2(why):
        raise AssertionError(f"cv2 was reached: {why}")
    monkeypatch.setattr(tvideo, "_cv2", no_cv2)
    mjpg = DATA / "mjpg 5ms.avi"
    for decoder in ("native", "turbo", "turbo_fast"):
        with pytest.raises(RuntimeError, match="simulated failure"):
            tvideo._resolve_decoder(decoder, [mjpg], 32, 48, 3)
    with pytest.raises(RuntimeError, match="simulated failure"):
        tvideo.welford_algorithm(mjpg, use_std=True)


def test_decoded_frames_are_counted(video):
    path, frames = video
    obs.reset_stage_times()
    tvideo.welford_algorithm(path, use_std=True, batch_size=4)
    assert obs.decoded_frames.snapshot() == {"raw": len(frames)}
    assert obs.snapshot_stage_times()["decode_s"] >= 0


def test_pool_and_prefetch_invariant(video):
    path, _ = video
    pool = [np.zeros((4, H, W, 3), np.uint8) for _ in range(3)]
    with pytest.raises(ValueError, match="cannot back a prefetch depth"):
        next(tvideo._frame_batches_into([path], 4, pool, 2, ["raw"]))


def test_buffer_cache_is_exclusive_and_bounded():
    cache = tvideo._BufferCache(keys=2, per_key=2)
    made = []

    def make():
        made.append(object())
        return made[-1]
    a, b = cache.checkout(("g",), make), cache.checkout(("g",), make)
    assert a is not b
    cache.give_back(("g",), a)
    assert cache.checkout(("g",), make) is a
    for k in range(3):
        cache.give_back((k,), object())
    assert (1,) in cache and (2,) in cache and (0,) not in cache
    assert ("g",) not in cache


# --- noise profiles and the STD tables ---------------------------------------

def test_compute_noise_profiles_equal_jax(video):
    path, _ = video
    got, gmean = tvideo.compute_noise_profiles([path], batch_size=4,
                                               device="cpu")
    want, wmean = jvideo.compute_noise_profiles([path], batch_size=4)
    np.testing.assert_array_equal(gmean, wmean)
    assert got.shape == (256, 256, 3)
    np.testing.assert_array_equal(got, want)
    assert got.sum() == 13 * H * W * 3


def test_clean_data_edges_equal_jax(video):
    path, _ = video
    profiles, _ = tvideo.compute_noise_profiles([path], device="cpu")
    rng = np.random.default_rng(4)
    table = rng.integers(0, 30, (256, 256))
    for arr in (profiles[..., 0], table):
        np.testing.assert_array_equal(
            tvideo.clean_data_edges(arr.copy(), CameraConfig()),
            jvideo.clean_data_edges(arr.copy(), JConfig()))


@pytest.mark.parametrize("as_tensor", [False, True])
def test_calculate_std_equals_jax(as_tensor):
    table = np.random.default_rng(6).integers(0, 50, (256, 256)).astype(
        float)
    table[7] = 0  # a row without counts gives 0
    arg = torch.as_tensor(table) if as_tensor else table
    got = tvideo.calculate_std(arg, CameraConfig(), device="cpu")
    want = np.asarray(jvideo.calculate_std(jnp.asarray(table), JConfig()))
    assert got.dtype == torch.float64 and got[7] == 0
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_process_std_data_equals_jax(tmp_path):
    rng = np.random.default_rng(8)
    files = ("m_b.txt", "m_g.txt", "m_r.txt")
    for name in files:
        np.savetxt(tmp_path / name, rng.integers(0, 40, (256, 256)))
    kw = dict(data_path=str(tmp_path), mean_data_files=files)
    got = tvideo.process_STD_data(CameraConfig(std_file_name="t.txt", **kw),
                                  device="cpu")
    want = jvideo.process_STD_data(JConfig(std_file_name="j.txt", **kw))
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(np.loadtxt(tmp_path / "t.txt"),
                               np.loadtxt(tmp_path / "j.txt"), **TOL)


def test_the_cv2_message_names_every_codec_the_port_reads(monkeypatch):
    """Without cv2, the error lists what the port reads without it: every
    fourcc the resolver routes to one of the port's own readers."""
    from camera_linearity_tpu_torch.utils import avi
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ValueError, match="needs cv2") as exc:
        tvideo._cv2("a test")
    message = str(exc.value)
    families = {"raw": ("RGBA",), "rawvideo": tuple(avi.FOURCC_LAYOUTS),
                "png": avi.PNG_CODECS, "huffyuv": avi.HUFFYUV_CODECS,
                "ffv1": avi.FFV1_CODECS, "utvideo": avi.UTVIDEO_READ,
                "lagarith": avi.LAGARITH_CODECS, "mpeg4": avi.MPEG4_CODECS,
                "h264": avi.H264_CODECS, "mjpeg": ("MJPG",)}
    assert set(families) - {"raw", "mjpeg"} == set(tvideo._DECODER_NAMES)
    for family, fourccs in families.items():
        for fourcc in fourccs:
            assert fourcc.strip() in message, (family, fourcc)
    # which MPEG-4 Part 2 streams: the Advanced Simple tools read, and the
    # ones still refused
    for words in ("Advanced Simple", "B-VOPs", "packed bitstreams",
                  "MPEG quantisation", "not quarter-pel or GMC"):
        assert words in message, words
    # which H.264 streams: I and P slices of the Constrained Baseline,
    # Main and High profiles, and what not
    for words in ("V_MPEG4/ISO/AVC", "Constrained Baseline", "Main and High",
                  "CABAC", "not B slices"):
        assert words in message, words
