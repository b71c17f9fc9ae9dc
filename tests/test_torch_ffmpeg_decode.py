"""The port's JPEG decoder in its ``"ffmpeg"`` mode against
``cv2.VideoCapture``, which is what the JAX package decodes an MJPG AVI
with at its default (``CL_DECODER=cv2``).

Every frame goes into a one-frame AVI (``tests/_torch_mjpeg_writer.py``)
and cv2 decodes it through its bundled FFmpeg; ``jpeg.cpp`` in mode 2 must
give the same bytes, and ``jpeg_plain.py`` (slow: small frames only) the
same bytes as ``jpeg.cpp``.  Frames come from ``cv2.imencode`` (4:4:4,
4:2:2, 4:2:0; every quality from 10 to 100; restart intervals; optimised
Huffman tables), from ``cv2.VideoWriter``, from random quantized
coefficients (dequantized values that wrap int16 and sums that saturate in
the IDCT), and from the committed clips in ``tests/data``: ``mjpg 5ms``
(cv2's writer, 4:2:0, 32 x 48), ``mjpg422 5ms`` (4:2:2, 24 x 40, a restart
every 3 MCUs) and ``mjpg odd 5ms`` (4:2:0, 38 x 53), the last two encoded by
``tests/_torch_mjpeg_writer.py`` from a seeded gradient plus N(0, 6)
noise.  Their ``.cv2.npy`` files hold what ``cv2.VideoCapture`` (cv2 5.0,
FFmpeg 8, x86-64) gives for them; ``chip_smoke.py`` holds the mode to them
on the card's machine, which has no cv2.

Cut and corrupt frames: where cv2 gives no frame (data that ends before the
first SOS marker) the decoder says so and a video ends there, as the JAX
package's cv2 loop does; where cv2 conceals an error the mode cannot
reproduce, the decode raises and names the frame.
"""
from __future__ import annotations

import struct

import numpy as np
import pytest

torch = pytest.importorskip("torch")
cv2 = pytest.importorskip("cv2")

from camera_linearity_tpu.models import video as jvideo  # noqa: E402
from camera_linearity_tpu_torch import native  # noqa: E402
from camera_linearity_tpu_torch.models import video as tvideo  # noqa: E402
from camera_linearity_tpu_torch.native import jpeg_plain  # noqa: E402
from camera_linearity_tpu_torch.utils import avi  # noqa: E402
from camera_linearity_tpu_torch.utils import observability as obs  # noqa
from tests import _torch_mjpeg_writer as writer  # noqa: E402
from tests.test_torch_native import DATA  # noqa: E402

SAMPLING = {"444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
            "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
            "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420}
FIXTURES = {"mjpg 5ms": (4, 32, 48), "mjpg422 5ms": (4, 24, 40),
            "mjpg odd 5ms": (3, 38, 53)}
FFMPEG = native.JPEG_MODES.index("ffmpeg")


@pytest.fixture(scope="module", autouse=True)
def built():
    assert native.mjpeg_available(), native.build_error("_mjpeg")


def content(kind: str, h: int, w: int, seed: int = 0) -> np.ndarray:
    """Seeded noise, or a smooth ramp with mild noise, as BGR uint8."""
    rng = np.random.default_rng(seed)
    if kind == "noise":
        return rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    y, x = np.mgrid[:h, :w] / max(h, w, 2)
    base = np.stack([40 + 170 * x, 60 + 150 * y, 220 - 120 * (x + y) / 2], -1)
    return np.clip(base + rng.normal(0, 4, (h, w, 3)), 0, 255).astype(
        np.uint8)


def imencode(img, quality=75, sampling="420", rst=0, optimize=False):
    ok, buf = cv2.imencode(".jpg", img, [
        cv2.IMWRITE_JPEG_QUALITY, quality,
        cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling],
        cv2.IMWRITE_JPEG_RST_INTERVAL, rst,
        cv2.IMWRITE_JPEG_OPTIMIZE, int(optimize)])
    assert ok
    return buf.tobytes()


def cv2_decode(tmp_path, frames, h, w):
    """What cv2.VideoCapture reads from an MJPG AVI of ``frames``."""
    path = tmp_path / "probe 5ms.avi"
    writer.write_mjpg_avi(path, frames, h, w)
    cap = cv2.VideoCapture(str(path))
    out = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        out.append(frame)
    cap.release()
    return out


def port(data, h, w):
    """(return code, frame) of jpeg.cpp in mode 2."""
    dst = np.zeros((h, w, 3), np.uint8)
    buf = np.frombuffer(data, np.uint8)
    rc = native._load_mjpeg().clt_jpeg_decode_bgr(
        native._as_u8_ptr(buf), buf.size, native._as_u8_ptr(dst), h, w,
        FFMPEG)
    return rc, dst


def same_as_cv2(tmp_path, frames, h, w, plain=False):
    """Each frame, alone in an AVI, decodes in jpeg.cpp's ffmpeg mode to
    cv2's bytes; with ``plain``, jpeg_plain gives jpeg.cpp's."""
    for i, data in enumerate(frames):
        want = cv2_decode(tmp_path, [data], h, w)
        assert len(want) == 1, i
        rc, got = port(data, h, w)
        assert rc == 0, (i, rc)
        np.testing.assert_array_equal(got, want[0], err_msg=f"frame {i}")
        if plain:
            prc, frame = jpeg_plain.decode_bgr(data, h, w, "ffmpeg")
            assert prc == 0
            np.testing.assert_array_equal(frame, got)


# --- (a) bit for bit with cv2 ---------------------------------------------

@pytest.mark.parametrize("sampling", list(SAMPLING))
@pytest.mark.parametrize("kind", ["noise", "smooth"])
@pytest.mark.parametrize("size", [(2, 2), (8, 8), (16, 24), (38, 53),
                                  (40, 72), (64, 3840)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_equals_cv2(tmp_path, size, kind, sampling):
    h, w = size
    img = content(kind, h, w, seed=h * w)
    frames = [imencode(img, q, sampling, rst)
              for q, rst in ((50, 0), (95, 1), (100, 3))]
    same_as_cv2(tmp_path, frames, h, w, plain=h * w <= 2200)


@pytest.mark.parametrize("sampling", list(SAMPLING))
def test_every_quality_equals_cv2(tmp_path, sampling):
    """Qualities 10-100 (the quantizers from 1 to 255), one AVI of 91
    frames, each frame against cv2's; the plain version on every tenth."""
    h, w = 24, 37
    frames = [imencode(content("smooth" if q % 2 else "noise", h, w, q), q,
                       sampling) for q in range(10, 101)]
    want = cv2_decode(tmp_path, frames, h, w)
    assert len(want) == len(frames)
    got = np.empty((len(frames), h, w, 3), np.uint8)
    assert native.jpeg_decode_bgr_batch(frames, got, mode="ffmpeg") == \
        len(frames)
    np.testing.assert_array_equal(got, np.stack(want))
    for i in range(0, len(frames), 10):
        rc, frame = jpeg_plain.decode_bgr(frames[i], h, w)
        assert rc == 0
        np.testing.assert_array_equal(frame, got[i])


@pytest.mark.parametrize("r", range(8))
@pytest.mark.parametrize("sampling", list(SAMPLING))
def test_widths_8k_plus_r(tmp_path, sampling, r):
    """Widths 8k + r (the converter's SIMD tails) and heights that are not
    multiples of 16."""
    h, w = 22, 40 + r
    frames = [imencode(content("noise", h, w, r), 80, sampling, rst)
              for rst in (0, 2)]
    same_as_cv2(tmp_path, frames, h, w, plain=r % 4 == 0)


@pytest.mark.parametrize("seed", range(16))
def test_random_frames_equal_cv2(tmp_path, seed):
    """Random even-height geometry, quality, sampling, restart interval and
    optimised Huffman tables."""
    rng = np.random.default_rng(seed)
    h, w = 2 * int(rng.integers(1, 36)), int(rng.integers(1, 71))
    sampling = list(SAMPLING)[seed % 3]
    frames = [imencode(content(["noise", "smooth"][k % 2], h, w, seed + k),
                       int(rng.integers(1, 101)), sampling,
                       int(rng.integers(0, 5)), bool(k % 2))
              for k in range(3)]
    same_as_cv2(tmp_path, frames, h, w, plain=h * w <= 1500)


def _coefficient_frame(rng, h, w, sampling, restart):
    """A frame from random quantized coefficients and a random DQT, through
    the writer's entropy coder: dequantized AC terms up to 255 x 1023 wrap
    int16, and the IDCT's sums leave 16 bits."""
    hy, vy = writer.SAMPLING[sampling]
    my, mx = -(-h // (8 * vy)), -(-w // (8 * hy))
    q = rng.integers(1, 256, 64)
    coefs = []
    for k in range(3):
        n = my * mx * (hy * vy if k == 0 else 1)
        z = np.zeros((n, 64), np.int64)
        z[:, 0] = rng.integers(-1000, 1000, n)
        z[:, 1:] = rng.integers(-1023, 1024, (n, 63)) * (
            rng.random((n, 63)) < rng.random())
        coefs.append(z.reshape(my, mx, -1, 64))
    order = np.concatenate(coefs, axis=2).reshape(-1, 64)
    per_mcu = hy * vy + 2
    comp = np.tile(np.array([0] * (hy * vy) + [1, 2]), my * mx)
    interval = np.arange(len(order)) // per_mcu // restart if restart \
        else np.zeros(len(order), np.int64)
    scan = writer._entropy(order, comp, interval)
    seg = writer._segments(q[np.argsort(writer._ZIGZAG)], h, w, hy, vy,
                           restart)
    return b"\xff\xd8" + seg + scan + b"\xff\xd9"


@pytest.mark.parametrize("sampling", list(SAMPLING))
def test_extreme_coefficients_equal_cv2(tmp_path, sampling):
    rng = np.random.default_rng(list(SAMPLING).index(sampling))
    for k in range(4):
        h, w = 16 + 2 * k, 17 + 5 * k
        frame = _coefficient_frame(rng, h, w, sampling, k % 3)
        same_as_cv2(tmp_path, [frame], h, w, plain=True)


def _segments(data: bytes):
    out, i = [], 2
    while True:
        m = data[i + 1]
        n = struct.unpack(">H", data[i + 2:i + 4])[0]
        out.append((m, data[i:i + 2 + n]))
        i += 2 + n
        if m == 0xDA:
            return out, data[i:]


def _rebuild(segs, rest, drop=(), edit=None):
    return b"\xff\xd8" + b"".join(edit(m, s) if edit else s
                                  for m, s in segs if m not in drop) + rest


def _rgb_ids(m, seg):
    if m in (0xC0, 0xDA):
        b = bytearray(seg)
        at = (10, 13, 16) if m == 0xC0 else (5, 7, 9)
        for i, c in zip(at, b"RGB"):
            b[i] = c
        return bytes(b)
    return seg


@pytest.mark.parametrize("sampling", ["444", "420"])
def test_edited_headers_equal_cv2(tmp_path, sampling):
    """Fill bytes, 16-bit DQT tables, restart markers of the wrong number
    (FFmpeg takes any RSTn), component IDs 'R', 'G', 'B' with and without
    JFIF and Adobe transforms 0 and 1: FFmpeg reads 4:4:4 as planar RGB
    where the IDs or transform 0 say so (beside a JFIF too), and 4:2:0 as
    YCbCr whatever they say."""
    data = imencode(content("noise", 34, 48, 4), 85, sampling, rst=1)
    segs, rest = _segments(data)

    def dqt16(m, seg):
        if m != 0xDB:
            return seg
        body, out, at = seg[4:], b"", 0
        while at < len(body):
            out += bytes([0x10 | body[at]]) + b"".join(
                struct.pack(">H", v) for v in body[at + 1:at + 65])
            at += 65
        return b"\xff\xdb" + struct.pack(">H", len(out) + 2) + out
    cases = [
        _rebuild(segs, rest, edit=lambda m, s: b"\xff\xff" + s),
        _rebuild(segs, rest.replace(b"\xff\xd1", b"\xff\xff\xff\xd1")),
        _rebuild(segs, rest.replace(b"\xff\xd3", b"\xff\xd6", 1)),
        _rebuild(segs, rest, edit=dqt16),
        _rebuild(segs, rest, drop=(0xE0,), edit=_rgb_ids),
        _rebuild(segs, rest, edit=_rgb_ids)]
    for transform in (0, 1):
        adobe = b"\xff\xee\x00\x0eAdobe\x00\x64\x00\x00\x00\x00" + \
            bytes([transform])
        cases.append(b"\xff\xd8" + adobe + _rebuild(segs, rest,
                                                    drop=(0xE0,))[2:])
    same_as_cv2(tmp_path, cases, 34, 48, plain=True)
    plain = port(data, 34, 48)[1]
    rgb = port(cases[4], 34, 48)[1]
    assert np.array_equal(rgb, plain) == (sampling == "420")


def test_cv2_videowriter_chunks(tmp_path):
    path = tmp_path / "cv2 5ms.avi"
    h, w = 48, 64
    out = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"MJPG"), 10,
                          (w, h))
    assert out.isOpened()
    for seed in range(3):
        out.write(content("noise" if seed % 2 else "smooth", h, w, seed))
    out.release()
    cap = cv2.VideoCapture(str(path))
    want = [cap.read()[1] for _ in range(3)]
    cap.release()
    chunks = list(avi.mjpg_chunks(path))
    got = np.empty((3, h, w, 3), np.uint8)
    native.jpeg_decode_bgr_batch(chunks, got, mode="ffmpeg")
    np.testing.assert_array_equal(got, np.stack(want))
    rc, frame = jpeg_plain.decode_bgr(chunks[0], h, w)
    assert rc == 0
    np.testing.assert_array_equal(frame, got[0])


@pytest.mark.parametrize("name", list(FIXTURES))
def test_committed_clips(name):
    """The committed ``.cv2.npy`` files are what the installed cv2 decodes,
    and the ffmpeg mode (native and plain) gives them bit for bit."""
    n, h, w = FIXTURES[name]
    path = DATA / f"{name}.avi"
    want = np.load(DATA / f"{name}.cv2.npy")
    assert want.shape == (n, h, w, 3)
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
    got = np.empty((n, h, w, 3), np.uint8)
    assert native.jpeg_decode_bgr_batch(chunks, got, mode="ffmpeg") == n
    np.testing.assert_array_equal(got, want)
    for i, data in enumerate(chunks):
        rc, frame = jpeg_plain.decode_bgr(data, h, w)
        assert rc == 0
        np.testing.assert_array_equal(frame, want[i])


def test_modes_the_ffmpeg_mode_does_not_read(tmp_path):
    """4:2:0 and 4:2:2 of odd height take swscale's bicubic scaler, which
    the mode once refused; it now reproduces it, so they decode to cv2's
    bytes (native and plain) and the probe reads them, as it reads 4:4:4
    of odd height.  An unknown mode still raises."""
    for sampling in ("420", "422", "444"):
        data = imencode(content("noise", 37, 53), 75, sampling)
        assert avi.jpeg_unsupported(data, mode="ffmpeg") is None
        assert avi.jpeg_unsupported(data) is None
        same_as_cv2(tmp_path, [data], 37, 53, plain=True)
    with pytest.raises(ValueError, match="unknown JPEG decoder mode"):
        native.jpeg_decode_bgr(data, np.empty((37, 53, 3), np.uint8),
                               mode="libav")


# --- (b) cut and corrupt frames -------------------------------------------

@pytest.mark.parametrize("rst", [0, 2])
def test_cut_frames(tmp_path, rst):
    """A frame cut before its SOS marker: cv2 gives no frame, the decoder
    NO_FRAME.  Cut inside the scan: cv2 conceals the missing MCUs with
    what its frame buffer held; the decoder says UNMATCHED (CORRUPT for a
    cut inside the SOS header) rather than guess.  Cut only in the bytes
    after the last MCU: both give the whole frame."""
    h, w = 38, 53
    data = imencode(content("noise", h, w, 6), 90, "420", rst)
    sos = data.find(b"\xff\xda")
    cuts = list(range(0, sos + 12, 7)) + [sos, sos + 1, sos + 2, sos + 7] + \
        list(range(sos + 20, len(data), 131)) + [len(data) - 2]
    seen = set()
    for cut in cuts:
        frame = data[:cut]
        rc, got = port(frame, h, w)
        want = cv2_decode(tmp_path, [frame], h, w)
        assert (rc == native.JPEG_NO_FRAME) == (not want), (cut, rc)
        if rc == 0:
            np.testing.assert_array_equal(got, want[0])
        else:
            assert rc in (-1, -5, -6), (cut, rc)
        seen.add(rc)
        if cut % 3 == 0:
            assert jpeg_plain.decode_bgr(frame, h, w)[0] == rc
    assert {0, -5, -6} <= seen


@pytest.mark.parametrize("seed", range(10))
def test_corrupt_frames(tmp_path, seed):
    """Corrupt entropy-coded bytes: the frame equals cv2's, or FFmpeg met an
    error (a bad code, a run past 63, bits past the data, a lost restart
    marker) and the decoder says UNMATCHED; cv2 gives a frame either way."""
    rng = np.random.default_rng(seed)
    h, w = 30, 42
    data = bytearray(imencode(content("noise", h, w, seed), 40 + seed * 5,
                              list(SAMPLING)[seed % 3], seed % 3))
    sos = data.find(b"\xff\xda")
    for _ in range(1 + seed % 4):
        data[int(rng.integers(sos + 14, len(data) - 2))] = \
            int(rng.integers(0, 256))
    frame = bytes(data)
    rc, got = port(frame, h, w)
    want = cv2_decode(tmp_path, [frame], h, w)
    assert len(want) == 1
    assert rc in (0, -5), rc
    if rc == 0:
        np.testing.assert_array_equal(got, want[0])
    assert jpeg_plain.decode_bgr(frame, h, w)[0] == rc


def _clip(tmp_path, frames, h, w, name="clip 5ms.avi"):
    path = tmp_path / name
    writer.write_mjpg_avi(path, frames, h, w)
    return path


def test_a_video_ends_where_cv2s_does(tmp_path, monkeypatch):
    """[good, cut before SOS, good]: the JAX package's cv2 loop stops at
    the second frame, and so does the port; an empty chunk is skipped by
    both."""
    monkeypatch.delenv("CL_DECODER", raising=False)
    h, w = 24, 40
    good = [writer.encode_jpeg(content("smooth", h, w, s), 80)
            for s in range(3)]
    cut = good[1][:good[1].find(b"\xff\xda")]
    for frames, n in (([good[0], cut, good[2]], 1),
                      ([good[0], b"", good[1], good[2]], 3)):
        path = _clip(tmp_path, frames, h, w)
        frames_jax = list(jvideo.video_frame_generator(path))
        got = [f for f in tvideo.video_frame_generator(path) if f is not None]
        want = [f for f in frames_jax if f is not None]
        assert len(got) == len(want) == n
        np.testing.assert_array_equal(np.stack(got), np.stack(want))
        w_jax = jvideo.welford_algorithm(path, use_std=True)
        w_port = tvideo.welford_algorithm(path, use_std=True, device="cpu")
        np.testing.assert_allclose(w_port["mean"], w_jax["mean"], rtol=1e-10)


def test_a_concealed_error_raises_naming_the_frame(tmp_path, monkeypatch):
    monkeypatch.delenv("CL_DECODER", raising=False)
    h, w = 24, 40
    good = [writer.encode_jpeg(content("noise", h, w, s), 80)
            for s in range(3)]
    broken = good[1][:len(good[1]) // 2]  # cut inside the scan
    assert port(broken, h, w)[0] == -5
    path = _clip(tmp_path, [good[0], broken, good[2]], h, w)
    assert len(cv2_decode(tmp_path, [good[0], broken, good[2]], h, w)) == 3
    with pytest.raises(ValueError, match=r"clip 5ms\.avi: .*frame 1: data "
                                         "FFmpeg decodes with an error"):
        tvideo.welford_algorithm(path, use_std=True, device="cpu")


# --- (c) the repair: the defaults agree -------------------------------------

@pytest.fixture(scope="module")
def cv2_clip(tmp_path_factory):
    """An MJPG clip of 6 frames written by cv2.VideoWriter (4:2:0, 40 x
    64), noisy enough that the two IDCTs differ."""
    path = tmp_path_factory.mktemp("repair") / "cv2 clip 5ms.avi"
    out = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"MJPG"), 10,
                          (64, 40))
    for seed in range(6):
        out.write(content("smooth", 40, 64, seed))
    out.release()
    return path


def test_default_decode_equals_the_jax_packages(cv2_clip, monkeypatch):
    """At their defaults (``decoder="auto"``, ``CL_DECODER`` unset) the
    port's welford_algorithm equals the JAX package's, which reads the
    clip through cv2: mean and std at rtol 1e-10.  Before the ffmpeg mode
    the port's default was libjpeg-turbo's ISLOW decode, 0.6 DN off."""
    monkeypatch.delenv("CL_DECODER", raising=False)
    obs.decoded_frames.reset()
    got = tvideo.welford_algorithm(cv2_clip, None, use_std=True,
                                   decoder="auto", device="cpu")
    decoded = obs.decoded_frames.snapshot()
    want = jvideo.welford_algorithm(cv2_clip, None, use_std=True)
    for key in ("mean", "std"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-10,
                                   atol=1e-15)
    assert decoded == {"ffmpeg": 6}


def test_turbo_still_differs_from_cv2(cv2_clip, monkeypatch):
    monkeypatch.delenv("CL_DECODER", raising=False)
    got = tvideo.welford_algorithm(cv2_clip, None, use_std=True,
                                   decoder="turbo", device="cpu")
    want = jvideo.welford_algorithm(cv2_clip, None, use_std=True)
    assert np.abs(got["mean"] - want["mean"]).max() > 0.5 / 255


def test_process_video_equals_the_jax_packages(cv2_clip, tmp_path,
                                               monkeypatch):
    monkeypatch.delenv("CL_DECODER", raising=False)
    results = {}
    for name, module in (("port", tvideo), ("jax", jvideo)):
        path = tmp_path / name / cv2_clip.name
        path.parent.mkdir()
        path.write_bytes(cv2_clip.read_bytes())
        module.process_video(path)
        results[name] = {
            key: cv2.imread(str(path.parent / cv2_clip.name.replace(
                ".avi", f".{key}.tif")), cv2.IMREAD_UNCHANGED)
            for key in ("mean", "std")}
    for key in ("mean", "std"):
        want = results["jax"][key]
        assert want is not None and want.dtype == np.float64
        np.testing.assert_allclose(results["port"][key], want, rtol=1e-10,
                                   atol=1e-15)
