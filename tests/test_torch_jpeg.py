"""The port's MJPEG decoder (``native/jpeg.cpp``) and its plain version
(``native/jpeg_plain.py``) against libjpeg-turbo, bit for bit.

The oracle is the JAX package's decoder (``camera_linearity_tpu.native.
jpeg_decode_bgr``), which links the system libjpeg-turbo: ``fast=False``
is JDCT_ISLOW with fancy upsampling, ``fast=True`` JDCT_IFAST with merged
upsampling.  Frames come from ``cv2.imencode`` (qualities, sampling 4:4:4
/ 4:2:2 / 4:2:0, restart intervals, optimized tables), ``cv2.VideoWriter``
MJPG chunks and ``tests/_torch_mjpeg_writer.py``, over seeded noise and
smooth content, and are then edited: DHT removed, fill bytes, 16-bit DQT,
RGB component IDs or an Adobe marker, truncation, corrupt bytes.  Every
case holds the port's decode (frame and return code) to libjpeg's in both
modes, and ``jpeg_plain`` to the port.  A case skips only where its oracle
is missing (libjpeg's headers).
"""
import struct

import numpy as np
import pytest

torch = pytest.importorskip("torch")
cv2 = pytest.importorskip("cv2")
from hypothesis import HealthCheck, given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from camera_linearity_tpu import native as jnative  # noqa: E402
from camera_linearity_tpu_torch import native  # noqa: E402
from camera_linearity_tpu_torch.models import video as tvideo  # noqa: E402
from camera_linearity_tpu_torch.native import jpeg_plain  # noqa: E402
from camera_linearity_tpu_torch.utils import avi  # noqa: E402
from tests import _torch_mjpeg_writer as writer  # noqa: E402
from tests.test_torch_native import DATA, avi_bytes  # noqa: E402

SAMPLING = {"444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
            "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
            "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420}
SIZES = [(1, 1), (8, 8), (17, 9), (37, 53), (64, 3840)]


@pytest.fixture(scope="module")
def oracle():
    assert native.mjpeg_available(), native.build_error("_mjpeg")
    if not jnative.mjpeg_available():
        pytest.skip("the oracle, the JAX package's libjpeg decoder, did not "
                    "build (libjpeg's headers are missing)")
    return jnative


def content(kind: str, h: int, w: int, seed: int = 0) -> np.ndarray:
    """Seeded noise, or a smooth colour ramp, as (h, w, 3) BGR uint8."""
    if kind == "noise":
        return np.random.default_rng(seed).integers(0, 256, (h, w, 3),
                                                    dtype=np.uint8)
    y, x = np.mgrid[:h, :w] / max(h, w, 2)
    return np.stack([40 + 170 * x, 60 + 150 * y, 220 - 120 * (x + y) / 2],
                    -1).astype(np.uint8)


def imencode(img, quality=75, sampling="420", rst=0, optimize=False):
    ok, buf = cv2.imencode(".jpg", img, [
        cv2.IMWRITE_JPEG_QUALITY, quality,
        cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling],
        cv2.IMWRITE_JPEG_RST_INTERVAL, rst,
        cv2.IMWRITE_JPEG_OPTIMIZE, int(optimize)])
    assert ok
    return buf.tobytes()


def decode(lib, data, h, w, fast):
    """(return code, frame) of the decoder's C entry point; the frame is
    what it wrote (rc 0)."""
    dst = np.zeros((h, w, 3), np.uint8)
    buf = np.frombuffer(data, np.uint8)
    u8p = native._as_u8_ptr
    rc = lib._load_mjpeg().clt_jpeg_decode_bgr(
        u8p(buf), buf.size, u8p(dst), h, w, int(fast))
    return rc, dst


def same_as_libjpeg(data, h, w, plain=False):
    """The port equals libjpeg in both modes; with ``plain``, jpeg_plain
    equals the port."""
    for fast in (False, True):
        want_rc, want = decode(jnative, data, h, w, fast)
        got_rc, got = decode(native, data, h, w, fast)
        assert got_rc == want_rc, (fast, got_rc, want_rc)
        if want_rc == 0:
            np.testing.assert_array_equal(got, want, err_msg=f"fast={fast}")
        if plain:
            rc, frame = jpeg_plain.decode_bgr(data, h, w, fast)
            assert rc == got_rc
            if rc == 0:
                np.testing.assert_array_equal(frame, got)


def segments(data: bytes):
    """(marker, whole segment bytes) up to SOS, then the rest."""
    out, i = [], 2
    while True:
        m = data[i + 1]
        n = struct.unpack(">H", data[i + 2:i + 4])[0]
        out.append((m, data[i:i + 2 + n]))
        i += 2 + n
        if m == 0xDA:
            return out, data[i:]


def rebuild(segs, rest, drop=(), edit=None):
    parts = [b"\xff\xd8"]
    for m, seg in segs:
        if m in drop:
            continue
        parts.append(edit(m, seg) if edit else seg)
    return b"".join(parts) + rest


# --- cv2.imencode frames ----------------------------------------------------

@pytest.mark.parametrize("sampling", ["444", "422", "420"])
@pytest.mark.parametrize("kind", ["noise", "smooth"])
@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_equals_libjpeg(oracle, size, kind, sampling):
    h, w = size
    img = content(kind, h, w, seed=h * w)
    qualities = (50, 100) if h * w > 4096 else (50, 75, 95, 100)
    for quality in qualities:
        for rst in (0, 1, 3):
            same_as_libjpeg(imencode(img, quality, sampling, rst), h, w)
    # the plain version on one quality, with restart markers
    same_as_libjpeg(imencode(img, 75, sampling, 2), h, w, plain=True)


@settings(max_examples=40, deadline=None,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(h=st.integers(1, 70), w=st.integers(1, 70),
       quality=st.integers(1, 100), sampling=st.sampled_from(list(SAMPLING)),
       rst=st.integers(0, 4), optimize=st.booleans(),
       kind=st.sampled_from(["noise", "smooth"]), seed=st.integers(0, 99))
def test_random_frames_equal_libjpeg(oracle, h, w, quality, sampling, rst,
                                     optimize, kind, seed):
    img = content(kind, h, w, seed)
    same_as_libjpeg(imencode(img, quality, sampling, rst, optimize), h, w,
                    plain=h * w <= 1200)


def test_standard_tables_are_cv2s(oracle):
    """jpeg_plain's Annex K tables (which jpeg.cpp holds too, and which
    the writer writes) are the DHT cv2 writes without optimization."""
    segs, _ = segments(imencode(content("noise", 16, 16)))
    found = {}
    for m, seg in segs:
        if m != 0xC4:
            continue
        body, at = seg[4:], 0
        while at < len(body):
            index, counts = body[at], tuple(body[at + 1:at + 17])
            found[(index >> 4, index & 15)] = (counts, body[
                at + 17:at + 17 + sum(counts)])
            at += 17 + sum(counts)
    assert found == jpeg_plain.STANDARD_TABLES


@pytest.mark.parametrize("sampling", ["444", "422", "420"])
def test_frames_without_dht(oracle, sampling):
    """MJPEG cameras leave the DHT out: the standard tables decode the
    frame, as libjpeg-turbo does."""
    img = content("noise", 37, 53, seed=3)
    data = imencode(img, 80, sampling, rst=2)
    stripped = rebuild(*segments(data), drop=(0xC4,))
    assert b"\xff\xc4" not in stripped[:stripped.find(b"\xff\xda")]
    same_as_libjpeg(stripped, 37, 53, plain=True)
    for fast in (False, True):
        assert np.array_equal(decode(native, stripped, 37, 53, fast)[1],
                              decode(native, data, 37, 53, fast)[1])


def test_edited_headers(oracle):
    """Fill bytes before markers, 16-bit DQT tables, RGB-coded frames (IDs
    'R', 'G', 'B' without JFIF, or Adobe transform 0) and an Adobe marker
    saying YCbCr."""
    img = content("noise", 33, 47, seed=4)
    data = imencode(img, 85, "420", rst=1)
    segs, rest = segments(data)
    cases = {"fill": rebuild(segs, rest, edit=lambda m, s: b"\xff\xff" + s)}
    rst_filled = rest.replace(b"\xff\xd1", b"\xff\xff\xff\xd1")
    cases["fill in the scan"] = rebuild(segs, rst_filled)

    def dqt16(m, seg):
        if m != 0xDB:
            return seg
        body, out, at = seg[4:], b"", 0
        while at < len(body):
            out += bytes([0x10 | body[at]]) + b"".join(
                struct.pack(">H", v) for v in body[at + 1:at + 65])
            at += 65
        return b"\xff\xdb" + struct.pack(">H", len(out) + 2) + out
    cases["16-bit DQT"] = rebuild(segs, rest, edit=dqt16)

    def rgb_ids(m, seg):
        if m == 0xC0:
            b = bytearray(seg)
            b[10], b[13], b[16] = b"RGB"
            return bytes(b)
        if m == 0xDA:
            b = bytearray(seg)
            b[5], b[7], b[9] = b"RGB"
            return bytes(b)
        return seg
    cases["RGB IDs"] = rebuild(segs, rest, drop=(0xE0,), edit=rgb_ids)
    cases["RGB IDs beside JFIF"] = rebuild(segs, rest, edit=rgb_ids)
    for transform in (0, 1):
        adobe = b"\xff\xee\x00\x0eAdobe\x00\x64\x00\x00\x00\x00" + \
            bytes([transform])
        cases[f"Adobe {transform}"] = b"\xff\xd8" + adobe + rebuild(
            segs, rest, drop=(0xE0,))[2:]
    decoded = {}
    for name, case in cases.items():
        same_as_libjpeg(case, 33, 47, plain=True)
        decoded[name] = decode(native, case, 33, 47, False)[1]
    plain = decode(native, data, 33, 47, False)[1]
    assert np.array_equal(decoded["fill"], plain)
    assert np.array_equal(decoded["Adobe 1"], plain)
    assert np.array_equal(decoded["RGB IDs beside JFIF"], plain)
    assert not np.array_equal(decoded["RGB IDs"], plain)
    assert np.array_equal(decoded["RGB IDs"], decoded["Adobe 0"])


# --- cv2.VideoWriter chunks and the committed file ---------------------------

def test_cv2_videowriter_chunks(oracle, tmp_path):
    path = tmp_path / "cv2 5ms.avi"
    h, w = 48, 64
    out = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"MJPG"), 10,
                          (w, h))
    assert out.isOpened()
    for seed in range(3):
        out.write(content("noise" if seed % 2 else "smooth", h, w, seed))
    out.release()
    chunks = list(avi.mjpg_chunks(path))
    assert len(chunks) == 3
    for data in chunks + list(avi.mjpg_chunks(DATA / "mjpg 5ms.avi")):
        sof = avi._jpeg_sof(data)
        same_as_libjpeg(data, sof.height, sof.width, plain=True)


# --- the modes the decoder does not read -------------------------------------

def _patched_sof(data: bytes, marker=None, precision=None) -> bytes:
    i = data.find(b"\xff\xc0")
    b = bytearray(data)
    if marker is not None:
        b[i + 1] = marker
    if precision is not None:
        b[i + 4] = precision
    return bytes(b)


def _unsupported_frames():
    img = content("noise", 24, 40, seed=5)
    base = imencode(img)
    progressive = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_PROGRESSIVE,
                                             1])[1].tobytes()
    gray = cv2.imencode(".jpg", img[..., 0])[1].tobytes()
    return {
        "progressive": progressive,
        "grayscale": gray,
        "sampling 4x1 1x1 1x1": cv2.imencode(".jpg", img, [
            cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
            cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411])[1].tobytes(),
        "sampling 1x2 1x1 1x1": cv2.imencode(".jpg", img, [
            cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
            cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440])[1].tobytes(),
        "lossless": _patched_sof(base, marker=0xC3),
        "arithmetic coding": _patched_sof(base, marker=0xC9),
        "12-bit samples": _patched_sof(base, precision=12),
    }


@pytest.mark.parametrize("feature", list(_unsupported_frames()))
def test_unsupported_modes_raise_before_decode(oracle, feature, tmp_path,
                                               monkeypatch):
    data = _unsupported_frames()[feature]
    assert avi.jpeg_unsupported(data) == feature
    # a frame on its own: the decoder names the feature
    with pytest.raises(ValueError, match=feature):
        native.jpeg_decode_bgr(data, np.empty((24, 40, 3), np.uint8))
    rc, _ = jpeg_plain.decode_bgr(data, 24, 40, "turbo")
    assert rc == decode(native, data, 24, 40, False)[0] < 0
    # an MJPG AVI of such frames raises before any frame is decoded
    path = tmp_path / "unsupported 5ms.avi"
    path.write_bytes(avi_bytes(b"MJPG", 24, 40, 24, [data] * 3))

    def no_decode(*args, **kwargs):
        raise AssertionError("a frame was decoded")
    monkeypatch.setattr(native, "jpeg_decode_bgr_batch", no_decode)
    chs = 1 if feature == "grayscale" else 3
    with pytest.raises(ValueError, match=feature):
        tvideo.welford_algorithm(path, decoder="turbo",
                                 config=tvideo.CameraConfig(num_of_chs=chs))


def test_multi_scan_is_named():
    info = avi.JpegInfo(16, 16, 3, 8, 0xC0, ((1, 1),) * 3, 3)
    assert avi.jpeg_unsupported(info) == "multi-scan (3 scans)"
    assert avi.jpeg_unsupported(info._replace(scans=1)) is None


# --- truncated and corrupt data ----------------------------------------------

@pytest.mark.parametrize("rst", [0, 2])
def test_truncated_frames_decode_as_libjpeg(oracle, rst):
    """libjpeg-turbo warns, pads with zero bits and leaves the rest of the
    segment gray; behind the JAX package's error manager it returns a
    frame.  Cut inside the headers, the SOS header and the scan."""
    data = imencode(content("noise", 37, 53, seed=6), 90, "420", rst)
    sos = data.find(b"\xff\xda")
    cuts = list(range(sos - 3, sos + 16)) + list(range(sos + 16, len(data),
                                                       29))
    for cut in cuts:
        same_as_libjpeg(data[:cut], 37, 53, plain=cut % 3 == 0)


@pytest.mark.parametrize("seed", range(12))
def test_corrupt_frames_decode_as_libjpeg(oracle, seed):
    """Corrupt entropy-coded bytes: where they make garbage coefficients,
    libjpeg-turbo's SIMD IDCTs wrap and saturate in 16-bit lanes, and so
    does the port."""
    rng = np.random.default_rng(seed)
    data = bytearray(imencode(content("noise", 29, 41, seed), 40 + seed * 5,
                              list(SAMPLING)[seed % 3], seed % 3))
    sos = data.find(b"\xff\xda")
    for _ in range(1 + seed % 4):
        at = int(rng.integers(sos + 14, len(data) - 2))
        data[at] = int(rng.integers(0, 256))
    same_as_libjpeg(bytes(data), 29, 41, plain=True)


def test_decode_errors_name_the_fault(oracle):
    data = imencode(content("smooth", 16, 24))
    with pytest.raises(ValueError, match="geometry"):
        native.jpeg_decode_bgr(data, np.empty((16, 23, 3), np.uint8))
    with pytest.raises(ValueError, match="corrupt"):
        native.jpeg_decode_bgr(b"\xff\xd8\xff\xd9",
                               np.empty((16, 24, 3), np.uint8))
    with pytest.raises(ValueError, match="corrupt"):
        jpeg_plain.decode(b"not a jpeg")
    np.testing.assert_array_equal(jpeg_plain.decode(data),
                                  decode(native, data, 16, 24, False)[1])


# --- the batch entry -------------------------------------------------------

@pytest.mark.parametrize("threads", [1, 3, 8])
def test_batch_equals_per_frame(oracle, threads):
    frames = [imencode(content("noise" if i % 2 else "smooth", 40, 72, i),
                       60 + 5 * i, list(SAMPLING)[i % 3], i % 2)
              for i in range(7)]
    for fast in (False, True):
        dst = np.zeros((7, 40, 72, 3), np.uint8)
        native.jpeg_decode_bgr_batch(frames, dst, fast=fast, threads=threads)
        for i, data in enumerate(frames):
            one = np.empty((40, 72, 3), np.uint8)
            native.jpeg_decode_bgr(data, one, fast=fast)
            np.testing.assert_array_equal(dst[i], one)
    bad = list(frames)
    bad[4] = frames[4][:10]
    with pytest.raises(ValueError, match="corrupt"):
        native.jpeg_decode_bgr_batch(bad, np.zeros((7, 40, 72, 3), np.uint8),
                                     threads=threads)
    with pytest.raises(ValueError, match="holds 6 frames"):
        native.jpeg_decode_bgr_batch(frames, np.zeros((6, 40, 72, 3),
                                                      np.uint8))


# --- the test writer -------------------------------------------------------

def gentle(h: int, w: int, phase: float = 0.0) -> np.ndarray:
    """Content whose colour changes by a few DN a pixel at most."""
    y, x = np.mgrid[:h, :w]
    return np.stack([128 + 30 * np.sin(x / 9 + y / 13 + phase + c)
                     for c in range(3)], -1).round().astype(np.uint8)


@pytest.mark.parametrize("restart", [0, 3])
@pytest.mark.parametrize("sampling", ["444", "422", "420"])
@pytest.mark.parametrize("size", [(8, 8), (37, 53), (64, 96)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_writer_decodes_cleanly_near_its_source(oracle, size, sampling,
                                                restart, capfd):
    """``_torch_mjpeg_writer``'s frames decode through libjpeg with no
    warning, within a few DN of gentle content, and as the port and the
    plain version decode them (noise too)."""
    h, w = size
    img = gentle(h, w)
    data = writer.encode_jpeg(img, 90, sampling, restart)
    assert avi.jpeg_unsupported(data) is None
    info = avi._jpeg_sof(data)
    assert info.sampling == ((*writer.SAMPLING[sampling],), (1, 1), (1, 1))
    assert info.scans == 1 and (b"\xff\xdd" in data) == bool(restart)
    back = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    assert "Corrupt" not in capfd.readouterr().err
    assert np.abs(back.astype(int) - img).max() <= 6
    same_as_libjpeg(data, h, w, plain=True)
    noisy = writer.encode_jpeg(content("noise", h, w, 7), 30, sampling,
                               restart)
    same_as_libjpeg(noisy, h, w, plain=True)
    cv2.imdecode(np.frombuffer(noisy, np.uint8), cv2.IMREAD_COLOR)
    assert "Corrupt" not in capfd.readouterr().err


def test_writer_avi_reads_back(oracle, tmp_path, capfd):
    h, w = 32, 48
    frames = [gentle(h, w), gentle(h, w, phase=1.0)]
    path = tmp_path / "written 5ms.avi"
    writer.write_mjpg_avi(path, [writer.encode_jpeg(f, 90) for f in frames],
                          h, w)
    info = avi.probe_avi(path)
    assert info[:4] == ("MJPG", h, w, 3)
    assert info.jpeg.sampling == ((2, 2), (1, 1), (1, 1))
    chunks = list(avi.mjpg_chunks(path))
    assert len(chunks) == 2
    cap = cv2.VideoCapture(str(path))
    got = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        got.append(frame)
    cap.release()
    assert len(got) == 2 and "Corrupt" not in capfd.readouterr().err
    for data, frame in zip(chunks, got):
        mine = np.empty((h, w, 3), np.uint8)
        native.jpeg_decode_bgr(data, mine)
        assert np.abs(mine.astype(int) - frame).max() <= 8
