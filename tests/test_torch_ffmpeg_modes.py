"""The ``"ffmpeg"`` mode on the MJPG frame modes it reads beyond 4:4:4,
4:2:2 and 4:2:0 of even height: grayscale, 4:1:1, 4:4:0, 4:2:0 and 4:2:2
of odd height (swscale's scaled path), progressive frames (SOF2, with and
without successive approximation) and sequential frames of several scans.

As in ``tests/test_torch_ffmpeg_decode.py`` (whose helpers these tests
use), every frame goes into a one-frame AVI that ``cv2.VideoCapture``
decodes through its bundled FFmpeg; ``jpeg.cpp`` in mode 2 must give the
same bytes, and ``jpeg_plain.py`` the same bytes as ``jpeg.cpp`` on the
smaller frames.  Frames come from ``cv2.imencode`` (libjpeg: the
samplings, 2-D images as grayscale, ``IMWRITE_JPEG_PROGRESSIVE`` with its
successive approximation and per-scan Huffman tables) and from
``tests/_torch_mjpeg_writer.py`` (grayscale, 4:1:1, 4:4:0, spectral
selection without successive approximation, one scan a component).

The committed clips ``tests/data/mjpg gray 5ms``, ``mjpg411 5ms``,
``mjpg440 5ms``, ``mjpg420 odd 5ms`` (the writer's, from a seeded
gradient plus N(0, 6) noise) and ``mjpg progressive 5ms`` (libjpeg's
progressive 4:2:0 through ``cv2.imencode``) carry what cv2 5.0 (FFmpeg 8,
x86-64) decodes them to as ``.cv2.npy``; ``chip_smoke.py`` holds the mode
to them on the card's machine, which has no cv2.  ``FIXTURES`` says how
each was made; ``fixture_frames`` makes them again.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
cv2 = pytest.importorskip("cv2")

from camera_linearity_tpu.models import video as jvideo  # noqa: E402
from camera_linearity_tpu_torch import native  # noqa: E402
from camera_linearity_tpu_torch.models import video as tvideo  # noqa: E402
from camera_linearity_tpu_torch.native import jpeg_plain  # noqa: E402
from camera_linearity_tpu_torch.utils import avi  # noqa: E402
from tests import _torch_mjpeg_writer as writer  # noqa: E402
from tests.test_torch_ffmpeg_decode import (  # noqa: E402
    content, cv2_decode, port, same_as_cv2)
from tests.test_torch_native import DATA  # noqa: E402

SAMPLING = {"444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
            "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
            "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
            "411": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411,
            "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440}
# mode -> (sampling, progressive); "gray" encodes a 2-D image
MODES = {"gray": (None, False), "411": ("411", False),
         "440": ("440", False), "420": ("420", False),
         "422": ("422", False), "progressive 420": ("420", True),
         "progressive 444": ("444", True), "progressive gray": (None, True)}
SIZES = [(2, 2), (8, 8), (37, 53), (38, 53), (64, 3840)]
# name -> (frames, height, width, how the clip was made)
FIXTURES = {"mjpg gray 5ms": (3, 29, 46, "writer gray q75"),
            "mjpg411 5ms": (3, 24, 42, "writer 411 q75 DRI 2"),
            "mjpg440 5ms": (3, 30, 45, "writer 440 q75"),
            "mjpg420 odd 5ms": (3, 37, 52, "writer 420 q75"),
            "mjpg progressive 5ms": (3, 33, 50,
                                     "cv2 progressive 420 q85 DRI 2")}


@pytest.fixture(scope="module", autouse=True)
def built():
    assert native.mjpeg_available(), native.build_error("_mjpeg")


def imencode(img, quality=75, sampling="420", progressive=False, rst=0):
    """libjpeg's frame through cv2.imencode; a 2-D image is grayscale."""
    ok, buf = cv2.imencode(".jpg", img, [
        cv2.IMWRITE_JPEG_QUALITY, quality,
        cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling or "420"],
        cv2.IMWRITE_JPEG_PROGRESSIVE, int(progressive),
        cv2.IMWRITE_JPEG_RST_INTERVAL, rst])
    assert ok
    return buf.tobytes()


def image(mode, kind, h, w, seed):
    img = content(kind, h, w, seed)
    return img[..., 1].copy() if MODES[mode][0] is None else img


# --- bit for bit with cv2 --------------------------------------------------

@pytest.mark.parametrize("kind", ["noise", "smooth"])
@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("mode", list(MODES))
def test_equals_cv2(tmp_path, mode, size, kind):
    """libjpeg's frames at three qualities, with restart intervals of 0,
    1 and 3 (in every scan of a progressive frame)."""
    h, w = size
    sampling, progressive = MODES[mode]
    img = image(mode, kind, h, w, h * w)
    frames = [imencode(img, q, sampling, progressive, rst)
              for q, rst in ((50, 0), (95, 1), (100, 3))]
    for data in frames:
        info = avi._jpeg_sof(data)
        assert info.components == (1 if sampling is None else 3)
        assert (info.sof == 0xC2) == progressive
        assert avi.jpeg_unsupported(data, mode="ffmpeg") is None
    same_as_cv2(tmp_path, frames, h, w, plain=h * w <= 2200)


@pytest.mark.parametrize("mode", ["440", "progressive 420"])
def test_every_quality_equals_cv2(tmp_path, mode):
    """Qualities 1-100, one AVI of 100 frames, each frame against cv2's;
    the plain version on every tenth."""
    h, w = 21, 35
    sampling, progressive = MODES[mode]
    frames = [imencode(content("smooth" if q % 2 else "noise", h, w, q), q,
                       sampling, progressive, q % 4) for q in range(1, 101)]
    want = cv2_decode(tmp_path, frames, h, w)
    assert len(want) == len(frames)
    got = np.empty((len(frames), h, w, 3), np.uint8)
    assert native.jpeg_decode_bgr_batch(frames, got, mode="ffmpeg") == \
        len(frames)
    np.testing.assert_array_equal(got, np.stack(want))
    for i in range(0, len(frames), 10):
        rc, frame = jpeg_plain.decode_bgr(frames[i], h, w, "ffmpeg")
        assert rc == 0
        np.testing.assert_array_equal(frame, got[i])


@pytest.mark.parametrize("sampling", ["gray", "411", "440", "420", "444"])
@pytest.mark.parametrize("scans", ["baseline", "separate", "progressive"])
def test_writer_frames_equal_cv2(tmp_path, scans, sampling):
    """The writer's frames: one interleaved scan, one scan a component
    (sequential, several scans) and spectral selection (an interleaved DC
    scan, then AC bands 1-5 and 6-63 a component), with and without
    restart intervals, at sizes that leave partial MCUs."""
    frames, sizes = [], [(37, 53), (38, 54), (9, 3)]
    for h, w in sizes:
        img = content("noise", h, w, h + w)
        if sampling == "gray":
            img = img[..., 0].copy()
        for rst in (0, 2):
            frames.append((writer.encode_jpeg(
                img, 70, "420" if sampling == "gray" else sampling, rst,
                progressive=scans == "progressive",
                separate=scans == "separate"), h, w))
    for data, h, w in frames:
        info = avi._jpeg_sof(data)
        assert info.scans == {"baseline": 1,
                              "separate": info.components,
                              "progressive": 1 + 2 * info.components}[scans]
        same_as_cv2(tmp_path, [data], h, w, plain=True)


@pytest.mark.parametrize("seed", range(12))
def test_random_frames_equal_cv2(tmp_path, seed):
    """Random geometry, quality, mode and restart interval."""
    rng = np.random.default_rng(100 + seed)
    h, w = int(rng.integers(1, 70)), int(rng.integers(1, 90))
    mode = list(MODES)[seed % len(MODES)]
    sampling, progressive = MODES[mode]
    frames = [imencode(image(mode, ["noise", "smooth"][k], h, w, seed + k),
                       int(rng.integers(1, 101)), sampling, progressive,
                       int(rng.integers(0, 5))) for k in range(2)]
    same_as_cv2(tmp_path, frames, h, w, plain=h * w <= 1500)


def test_progressive_restarts_and_tables(tmp_path):
    """libjpeg's progressive scans carry their own DHT segments between
    the scans, and the restart interval runs inside each scan (the AC
    scans by blocks of one component, the DC scans by MCUs); a restart
    resets the EOB run."""
    h, w = 45, 61
    img = content("noise", h, w, 9)
    for rst in (1, 2, 5):
        data = imencode(img, 90, "420", True, rst)
        sos = data.find(b"\xff\xda")
        assert data.find(b"\xff\xc4", sos) > sos  # a DHT after a scan
        assert data.find(b"\xff\xd0", sos) > sos
        same_as_cv2(tmp_path, [data], h, w, plain=True)


# --- what the mode still refuses -------------------------------------------

def _with_sof(data: bytes, marker: int, precision: int = 8) -> bytes:
    at = data.find(b"\xff\xc0")
    return data[:at + 1] + bytes([marker]) + data[at + 2:at + 4] + \
        bytes([precision]) + data[at + 5:]


@pytest.mark.parametrize("marker, precision, feature", [
    (0xC3, 8, "lossless"), (0xC9, 8, "arithmetic coding"),
    (0xCA, 8, "progressive arithmetic coding"), (0xC1, 12, "12-bit"),
    (0xC5, 8, "hierarchical")])
def test_still_refused_by_name(marker, precision, feature):
    """Lossless, arithmetic-coded, hierarchical and 12-bit frames: the
    probe, jpeg.cpp and jpeg_plain.py refuse them in the ffmpeg mode and
    name the feature."""
    data = _with_sof(imencode(content("noise", 24, 40), 75), marker,
                     precision)
    assert feature in avi.jpeg_unsupported(data, mode="ffmpeg")
    with pytest.raises(ValueError, match=feature):
        native.jpeg_decode_bgr(data, np.empty((24, 40, 3), np.uint8),
                               mode="ffmpeg")
    assert port(data, 24, 40)[0] == jpeg_plain.UNSUPPORTED
    assert jpeg_plain.decode_bgr(data, 24, 40, "ffmpeg")[0] == \
        jpeg_plain.UNSUPPORTED


@pytest.mark.parametrize("factors", [(1, 4), (3, 1), (4, 2), (2, 4)])
def test_other_samplings_refused_by_name(factors):
    """Luma factors FFmpeg reads only with its own upscaling (or not at
    all) stay refused, named by their factors."""
    data = bytearray(imencode(content("noise", 32, 32), 75, "444"))
    at = data.find(b"\xff\xc0")
    data[at + 11] = factors[0] << 4 | factors[1]
    data = bytes(data)
    why = avi.jpeg_unsupported(data, mode="ffmpeg")
    assert why == f"sampling {factors[0]}x{factors[1]} 1x1 1x1"
    assert port(data, 32, 32)[0] == jpeg_plain.UNSUPPORTED
    assert jpeg_plain.decode_bgr(data, 32, 32, "ffmpeg")[0] == \
        jpeg_plain.UNSUPPORTED
    with pytest.raises(ValueError, match=why):
        native.jpeg_decode_bgr(data, np.empty((32, 32, 3), np.uint8),
                               mode="ffmpeg")


def test_the_turbo_modes_still_refuse():
    for mode, sampling, progressive in (("gray", None, False),
                                        ("411", "411", False),
                                        ("440", "440", False),
                                        ("prog", "420", True)):
        img = content("noise", 24, 40)
        data = imencode(img[..., 0].copy() if sampling is None else img, 75,
                        sampling, progressive)
        why = avi.jpeg_unsupported(data)
        assert why in ("grayscale", "sampling 4x1 1x1 1x1",
                       "sampling 1x2 1x1 1x1", "progressive"), why
        for fast in (False, True):
            with pytest.raises(ValueError, match=why):
                native.jpeg_decode_bgr(data, np.empty((24, 40, 3), np.uint8),
                                       fast=fast)


# --- the committed clips ---------------------------------------------------

def fixture_frames(name: str):
    """The JPEG frames of a committed clip, made as ``FIXTURES`` says."""
    n, h, w, how = FIXTURES[name]
    frames = []
    for seed in range(n):
        rng = np.random.default_rng(seed)
        y, x = np.mgrid[:h, :w] / max(h, w)
        img = np.clip(np.stack([40 + 170 * x, 60 + 150 * y,
                                220 - 120 * (x + y) / 2], -1)
                      + rng.normal(0, 6, (h, w, 3)), 0, 255).astype(np.uint8)
        if how.startswith("cv2"):
            frames.append(imencode(img, 85, "420", True, 2))
        elif "gray" in how:
            frames.append(writer.encode_jpeg(img[..., 1].copy(), 75))
        else:
            sampling = how.split()[1]
            frames.append(writer.encode_jpeg(
                img, 75, sampling, 2 if "DRI" in how else 0))
    return frames


@pytest.mark.parametrize("name", list(FIXTURES))
def test_committed_clips(name):
    """The committed ``.cv2.npy`` files are what the installed cv2 decodes;
    the ffmpeg mode (native and plain) gives them bit for bit; the writer's
    clips are what the writer makes today."""
    n, h, w, how = FIXTURES[name]
    path = DATA / f"{name}.avi"
    want = np.load(DATA / f"{name}.cv2.npy")
    assert want.shape == (n, h, w, 3)
    assert path.stat().st_size + want.nbytes <= 40_000
    cap = cv2.VideoCapture(str(path))
    frames = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        frames.append(frame)
    cap.release()
    np.testing.assert_array_equal(np.stack(frames), want)
    chunks = list(avi.mjpg_chunks(path))
    if how.startswith("writer"):
        assert chunks == fixture_frames(name)
    got = np.empty((n, h, w, 3), np.uint8)
    assert native.jpeg_decode_bgr_batch(chunks, got, mode="ffmpeg") == n
    np.testing.assert_array_equal(got, want)
    for i, data in enumerate(chunks):
        rc, frame = jpeg_plain.decode_bgr(data, h, w, "ffmpeg")
        assert rc == 0
        np.testing.assert_array_equal(frame, want[i])


# --- end to end: the defaults agree with the JAX package's -----------------

@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    """A grayscale, a 4:4:0 and a progressive clip of 5 frames, 40 x 64."""
    directory = tmp_path_factory.mktemp("modes")
    out = {}
    for name, sampling, progressive in (("gray", None, False),
                                        ("440", "440", False),
                                        ("progressive", "420", True)):
        frames = []
        for seed in range(5):
            img = content("smooth", 40, 64, seed)
            frames.append(imencode(img[..., 1].copy() if sampling is None
                                   else img, 80, sampling, progressive))
        path = directory / f"{name} clip 5ms.avi"
        writer.write_mjpg_avi(path, frames, 40, 64)
        out[name] = path
    return out


@pytest.mark.parametrize("backend", ["host", "device"])
@pytest.mark.parametrize("name", ["gray", "440", "progressive"])
def test_welford_equals_the_jax_packages(clips, name, backend, monkeypatch):
    """At their defaults (``decoder="auto"``, ``CL_DECODER`` unset) the
    port's welford_algorithm (host moments, or the Welford loop with
    ``device="cpu"``) equals the JAX package's, which reads the clip
    through cv2: mean and std at rtol 1e-10."""
    monkeypatch.delenv("CL_DECODER", raising=False)
    got = tvideo.welford_algorithm(clips[name], None, use_std=True,
                                   backend=backend, device="cpu")
    want = jvideo.welford_algorithm(clips[name], None, use_std=True)
    for key in ("mean", "std"):
        assert got[key].shape == (40, 64, 3)
        np.testing.assert_allclose(got[key], want[key], rtol=1e-10,
                                   atol=1e-15)
    if name == "gray":
        assert np.array_equal(got["mean"][..., 0], got["mean"][..., 2])


@pytest.mark.parametrize("name", ["gray", "440", "progressive"])
def test_process_video_equals_the_jax_packages(clips, name, tmp_path,
                                               monkeypatch):
    monkeypatch.delenv("CL_DECODER", raising=False)
    clip = clips[name]
    results = {}
    for who, module in (("port", tvideo), ("jax", jvideo)):
        path = tmp_path / who / clip.name
        path.parent.mkdir()
        path.write_bytes(clip.read_bytes())
        module.process_video(path)
        results[who] = {
            key: cv2.imread(str(path.parent / clip.name.replace(
                ".avi", f".{key}.tif")), cv2.IMREAD_UNCHANGED)
            for key in ("mean", "std")}
    for key in ("mean", "std"):
        want = results["jax"][key]
        assert want is not None and want.dtype == np.float64
        np.testing.assert_allclose(results["port"][key], want, rtol=1e-10,
                                   atol=1e-15)
