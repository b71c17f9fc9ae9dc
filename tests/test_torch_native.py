"""Port parity: the AVI reader (utils/avi.py) and the native staging library
and MJPEG decoder (native/) against the JAX package's copies.

* Raw ``RGBA`` frames read with NumPy equal cv2's decode of the same file
  exactly; MJPEG chunks, probes and native decodes equal the JAX package's.
* ``HostMoments`` (accumulate, finalize to f64 / f32 / the u16+f16 wire)
  and ``wire_quantize_u16f16`` equal the JAX copy's bit for bit.
* Two repairs of the copies, each beside the JAX behaviour (printed, not
  locked in): the RIFF walker survives a container of odd size, and the
  wire finalize narrows to f16 without ``_Float16`` (bit-exact against
  ``np.float16`` on edge values).
"""
import struct
import subprocess
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
cv2 = pytest.importorskip("cv2")

from camera_linearity_tpu import native as jnative  # noqa: E402
from camera_linearity_tpu.utils import avi as javi  # noqa: E402
from camera_linearity_tpu_torch import native as tnative  # noqa: E402
from camera_linearity_tpu_torch.utils import avi as tavi  # noqa: E402

DATA = Path(__file__).parent / "data"
MJPG = DATA / "mjpg 5ms.avi"   # 4 frames of 32 x 48, written by cv2


def write_rgba_avi(path, frames_bgr, fps=10):
    """A lossless AVI of uint8 BGR frames, with cv2's RGBA fourcc (its
    writer crops an odd height or width to the even size below)."""
    h, w = frames_bgr.shape[1:3]
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"RGBA"),
                             fps, (w, h))
    assert writer.isOpened()
    for f in frames_bgr:
        writer.write(f)
    writer.release()


def cv2_frames(path):
    cap = cv2.VideoCapture(str(path))
    out = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        out.append(frame)
    cap.release()
    return np.stack(out)


def chunk(fourcc: bytes, payload: bytes, size=None) -> bytes:
    """A RIFF chunk; ``size`` overrides the declared size."""
    n = len(payload) if size is None else size
    return struct.pack("<4sI", fourcc, n) + payload + \
        (b"\0" if len(payload) & 1 else b"")


def avi_bytes(codec: bytes, h: int, w: int, bits: int, frames,
              movi_extra: bytes = b"") -> bytes:
    """A minimal AVI: hdrl with one video stream, then one movi LIST of
    ``00dc`` chunks; ``movi_extra`` bytes sit inside movi after them."""
    strh = b"vids" + codec + b"\0" * 48
    strf = struct.pack("<IiiHH4sI", 40, w, h, 1, bits, codec,
                       h * w * bits // 8) + b"\0" * 16
    hdrl = b"hdrl" + chunk(b"avih", b"\0" * 56) + chunk(
        b"LIST", b"strl" + chunk(b"strh", strh) + chunk(b"strf", strf))
    movi = b"movi" + b"".join(chunk(b"00dc", f) for f in frames) + \
        movi_extra
    body = b"AVI " + chunk(b"LIST", hdrl) + chunk(b"LIST", movi)
    return chunk(b"RIFF", body)


@pytest.fixture
def rgba_avi(tmp_path):
    frames = np.random.default_rng(5).integers(0, 256, (7, 24, 40, 3),
                                               dtype=np.uint8)
    path = tmp_path / "scene 5ms.avi"
    write_rgba_avi(path, frames)
    return path, frames


# --- the AVI reader --------------------------------------------------------

@pytest.mark.parametrize("shape", [(1, 8, 8), (5, 24, 40), (3, 18, 34)])
def test_raw_frames_equal_cv2(tmp_path, shape):
    frames = np.random.default_rng(sum(shape)).integers(
        0, 256, shape + (3,), dtype=np.uint8)
    path = tmp_path / "x 5ms.avi"
    write_rgba_avi(path, frames)
    got = np.stack([f.copy() for f in tavi.raw_frames(path)])
    np.testing.assert_array_equal(got, cv2_frames(path))
    np.testing.assert_array_equal(got, frames)


def test_probe_avi_reads_the_stream_headers(rgba_avi):
    path, frames = rgba_avi
    assert tavi.probe_avi(path) == ("RGBA", 24, 40, 4)
    assert tavi.probe_avi(MJPG) == ("MJPG", 32, 48, 3)
    assert tavi.probe_avi(MJPG.with_suffix(".npy")) is None
    assert tavi.probe_avi(path.parent / "missing.avi") is None


def test_probe_mjpg_and_chunks_equal_jax(rgba_avi):
    path, _ = rgba_avi
    assert tavi.probe_avi(MJPG)[1:3] == javi.probe_mjpg(MJPG) == (32, 48)
    assert tavi.probe_avi(path).codec != "MJPG" and \
        javi.probe_mjpg(path) is None
    got, want = list(tavi.mjpg_chunks(MJPG)), list(javi.mjpg_chunks(MJPG))
    assert len(got) == 4 and got == want
    first = got[0]
    padded = first[:2] + b"\xff\xff\xff" + first[2:]
    assert tavi._jpeg_sof(padded)[:2] == javi._jpeg_geometry(padded) \
        == (32, 48)


def test_raw_frames_rejects_other_codecs_and_bad_chunks(tmp_path):
    with pytest.raises(ValueError, match="not an RGBA AVI"):
        next(tavi.raw_frames(MJPG))
    bad = tmp_path / "bad 5ms.avi"
    bad.write_bytes(avi_bytes(b"RGBA", 2, 2, 32, [b"\0" * 15]))
    with pytest.raises(ValueError, match="expected 2 x 2 x 4"):
        next(tavi.raw_frames(bad))


def test_truncated_raw_avi_stops_cleanly(rgba_avi, tmp_path):
    path, frames = rgba_avi
    data = path.read_bytes()
    cut = tmp_path / "cut 5ms.avi"
    # the idx1 index trails the frames: cutting 10 KB cuts into them
    cut.write_bytes(data[:len(data) - 10_000])
    got = [f.copy() for f in tavi.raw_frames(cut)]
    assert 0 < len(got) < len(frames)
    np.testing.assert_array_equal(np.stack(got), frames[:len(got)])


def test_walker_survives_an_odd_sized_container(tmp_path, capsys):
    """Repair of the JAX walker (utils/avi.py:39-41): it descends into a
    container before handling an odd size's pad byte, so a movi LIST of odd
    size (here one stray byte after its last frame, then the pad) desyncs
    the walk and the frames of the next segment are lost.  The port tracks
    each container's end."""
    f0, f1 = b"\x01" * 12, b"\x02" * 12
    odd = avi_bytes(b"RGBA", 1, 3, 32, [f0], movi_extra=b"\x7f")
    # a second RIFF AVIX segment continues the stream, as OpenDML does
    avix = chunk(b"RIFF", b"AVIX" + chunk(b"LIST", b"movi" +
                                          chunk(b"00dc", f1)))
    path = tmp_path / "odd 5ms.avi"
    path.write_bytes(odd + avix)
    want = [f0, f1]
    assert list(tavi.mjpg_chunks(path)) == want
    jax_chunks = list(javi.mjpg_chunks(path))
    print(f"JAX walker on an odd-sized movi LIST: {len(jax_chunks)} of 2 "
          "frame chunks")
    assert "JAX walker" in capsys.readouterr().out
    got = [f.copy() for f in tavi.raw_frames(path)]
    np.testing.assert_array_equal(
        np.stack(got), np.stack([np.frombuffer(f, np.uint8).reshape(
            1, 3, 4)[..., 2::-1] for f in want]))


# --- the native stager -------------------------------------------------------

def test_stager_builds_into_the_build_directory():
    assert tnative.available(), tnative.build_error()
    lib = tnative._lib_path()
    assert lib.exists() and lib.parent.name == "native" \
        and lib.parent.parent.name == "build"
    assert lib.name.startswith("_stager-")


@pytest.mark.parametrize("batches", [(5,), (3, 4), (70, 3)])
def test_accum_moments_equal_jax(batches):
    rng = np.random.default_rng(sum(batches))
    frames = rng.integers(0, 256, (sum(batches), 6, 7, 3), dtype=np.uint8)
    acc = {}
    for name, mod in (("port", tnative), ("jax", jnative)):
        s = np.zeros((6, 7, 3), np.uint64)
        q = np.zeros((6, 7, 3), np.uint64)
        start = 0
        for b in batches:
            mod.accum_moments_u8(frames[start:start + b], s, q)
            start += b
        acc[name] = (s, q)
    np.testing.assert_array_equal(acc["port"][0], acc["jax"][0])
    np.testing.assert_array_equal(acc["port"][1], acc["jax"][1])
    flat = frames.reshape(len(frames), -1).astype(np.uint64)
    np.testing.assert_array_equal(acc["port"][1].reshape(-1),
                                  (flat * flat).sum(0))


def test_accum_moments_checks_the_accumulators():
    frames = np.zeros((2, 4, 4, 3), np.uint8)
    with pytest.raises(ValueError, match="uint64"):
        tnative.accum_moments_u8(frames, np.zeros((4, 4, 2), np.uint64),
                                 np.zeros((4, 4, 3), np.uint64))


@pytest.mark.parametrize("dtype", ["f64", "f32", "wire"])
@pytest.mark.parametrize("n_frames", [1, 2, 13])
@pytest.mark.parametrize("use_out", [False, True])
def test_host_moments_finalize_equal_jax(dtype, n_frames, use_out):
    rng = np.random.default_rng(n_frames)
    frames = rng.integers(0, 256, (n_frames, 9, 11, 3), dtype=np.uint8)
    dt = {"f64": np.float64, "f32": np.float32,
          "wire": tnative.WIRE_U16F16}[dtype]
    results = []
    for mod in (tnative, jnative):
        acc = mod.HostMoments((9, 11, 3), 1.0 / 255)
        for part in (frames[:1], frames[1:]):
            if len(part):
                acc.update(part)
        out = None
        if use_out:
            vd, sd = dt if dtype == "wire" else (dt, dt)
            out = (np.zeros((9, 11, 3), vd), np.zeros((9, 11, 3), sd))
        results.append(acc.finalize(use_std=True, dtype=dt, out=out))
    (pm, ps), (jm, js) = results
    assert pm.dtype == jm.dtype
    np.testing.assert_array_equal(pm, jm)
    if n_frames < 2:
        assert ps is None and js is None
    else:
        assert ps.dtype == js.dtype
        np.testing.assert_array_equal(ps.view(np.uint8), js.view(np.uint8))


def test_host_moments_numpy_fallback_equals_native(monkeypatch):
    frames = np.random.default_rng(3).integers(0, 256, (9, 5, 6, 3),
                                               dtype=np.uint8)

    def run():
        acc = tnative.HostMoments((5, 6, 3), 1.0 / 255)
        acc.update(frames)
        return [acc.finalize(dtype=dt) for dt in
                (np.float64, np.float32, tnative.WIRE_U16F16)]
    native_out = run()
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "_tried", True)
    for (nm, ns), (fm, fs) in zip(native_out, run()):
        np.testing.assert_array_equal(nm, fm)
        np.testing.assert_array_equal(ns.view(np.uint8), fs.view(np.uint8))


def test_wire_quantize_equal_jax():
    rng = np.random.default_rng(9)
    mean = np.concatenate([rng.uniform(0, 1, 500),
                           [-0.1, 0.0, 0.5 / 65535, 1.0, 1.2]])
    std = np.concatenate([rng.uniform(0, 0.05, 500),
                          [0.0, 1e-9, 2.0 ** -25, 7e4, 1e-3]])
    for out in (None, (np.empty(505, np.uint16), np.empty(505, np.float16))):
        with np.errstate(over="ignore"):  # 7e4 overflows f16 to inf
            pm, ps = tnative.wire_quantize_u16f16(mean, std, out=out)
            jm, js = jnative.wire_quantize_u16f16(mean, std)
        np.testing.assert_array_equal(pm, jm)
        np.testing.assert_array_equal(ps.view(np.uint16), js.view(np.uint16))
    assert list(pm[-5:]) == [0, 0, 1, 65535, 65535]


F16_EDGES = {
    "zero": 0.0, "negative zero": -0.0, "one": 1.0,
    "largest finite": 65504.0, "just below the overflow tie": 65519.99,
    "overflow tie to inf": 65520.0, "overflow": 1e300,
    "negative overflow": -1e300, "inf": np.inf, "-inf": -np.inf,
    "nan": np.nan, "smallest subnormal": 2.0 ** -24,
    "half the smallest subnormal (tie to zero)": 2.0 ** -25,
    "just above that tie": 2.0 ** -25 * (1 + 2 ** -40),
    "a quarter of the smallest subnormal": 2.0 ** -26,
    "subnormal tie to even (up)": 3 * 2.0 ** -25,
    "subnormal tie to even (down)": 5 * 2.0 ** -25,
    "smallest normal": 2.0 ** -14,
    "largest subnormal rounding up to normal": 2.0 ** -14 - 2.0 ** -25,
    "normal tie to even (down)": 1 + 2 ** -11,
    "normal tie to even (up)": 1 + 3 * 2 ** -11,
    "just above a tie": 1 + 2 ** -11 + 2 ** -40,
    "double subnormal": 5e-324, "a third": 1 / 3, "tie at 2049": 2049.0,
    "tie at 2051": 2051.0,
}


@pytest.mark.parametrize("name", list(F16_EDGES))
def test_narrow_f16_is_numpys_cast(name):
    """The portable f64 -> f16 narrowing of the wire finalize (repair of
    native/stager.cpp:232,249, which needs ``_Float16``) is bit-exact
    against np.float16 on every edge of the format."""
    x = np.array([F16_EDGES[name], -F16_EDGES[name]])
    with np.errstate(all="ignore"):
        want = x.astype(np.float16)
    np.testing.assert_array_equal(tnative.narrow_f16(x).view(np.uint16),
                                  want.view(np.uint16))


def test_narrow_f16_on_every_half_and_midpoint():
    halves = np.arange(65536, dtype=np.uint16).view(np.float16).astype(
        np.float64)
    finite = np.unique(halves[np.isfinite(halves)])
    mids = (finite[:-1] + finite[1:]) / 2
    nan_payloads = np.array([0x7FF0000000000001, 0xFFF8000000000123],
                            np.uint64).view(np.float64)
    for x in (halves, mids, np.nextafter(mids, np.inf),
              np.nextafter(mids, -np.inf), nan_payloads):
        with np.errstate(all="ignore"):
            want = x.astype(np.float16)
        np.testing.assert_array_equal(tnative.narrow_f16(x).view(np.uint16),
                                      want.view(np.uint16))


def test_stager_builds_without_float16(tmp_path, capsys):
    """A compiler without ``_Float16`` (g++ < 12 on x86-64), simulated by
    defining the keyword away: the port's stager compiles, the JAX copy
    does not (its result is printed)."""
    flags = ["g++", "-std=c++17", "-fsyntax-only",
             "-D_Float16=float16_type_unavailable"]
    port = subprocess.run(flags + [str(tnative._SRC)], capture_output=True,
                          text=True, timeout=120)
    assert port.returncode == 0, port.stderr
    jax_src = Path(jnative.__file__).parent / "stager.cpp"
    jax = subprocess.run(flags + [str(jax_src)], capture_output=True,
                         text=True, timeout=120)
    print(f"JAX stager.cpp without _Float16: g++ exit code "
          f"{jax.returncode}")
    assert "exit code" in capsys.readouterr().out


# --- the native MJPEG decoder ------------------------------------------------

@pytest.fixture
def mjpeg():
    if not Path("/usr/include/jpeglib.h").exists():
        pytest.skip("libjpeg's headers (jpeglib.h) are not installed")
    assert tnative.mjpeg_available(), tnative.build_error("_mjpeg")
    return tnative


@pytest.mark.parametrize("fast", [False, True])
def test_mjpeg_decode_equals_jax(mjpeg, fast):
    for payload in tavi.mjpg_chunks(MJPG):
        got = np.empty((32, 48, 3), np.uint8)
        want = np.empty((32, 48, 3), np.uint8)
        mjpeg.jpeg_decode_bgr(payload, got, fast=fast)
        jnative.jpeg_decode_bgr(payload, want, fast=fast)
        np.testing.assert_array_equal(got, want)


def test_committed_mjpeg_frames(mjpeg):
    """The file beside ``chip_smoke.py``'s MJPEG check: libjpeg's decode
    here equals the committed frames exactly, and cv2's decode (another
    IDCT) equals its committed frames and stays within 8 DN of libjpeg's,
    the bound the JAX suite holds the two decoders to."""
    got = []
    for payload in tavi.mjpg_chunks(MJPG):
        dst = np.empty((32, 48, 3), np.uint8)
        mjpeg.jpeg_decode_bgr(payload, dst)
        got.append(dst)
    got = np.stack(got)
    np.testing.assert_array_equal(got, np.load(DATA / "mjpg 5ms.libjpeg.npy"))
    cv = np.load(DATA / "mjpg 5ms.cv2.npy")
    np.testing.assert_array_equal(cv2_frames(MJPG), cv)
    assert np.abs(got.astype(int) - cv).max() <= 8


def test_mjpeg_decode_errors(mjpeg):
    payload = next(tavi.mjpg_chunks(MJPG))
    with pytest.raises(ValueError, match="geometry"):
        mjpeg.jpeg_decode_bgr(payload, np.empty((8, 8, 3), np.uint8))
    with pytest.raises(ValueError, match="libjpeg decode error"):
        mjpeg.jpeg_decode_bgr(b"\xff\xd8garbage", np.empty((8, 8, 3),
                                                          np.uint8))
    with pytest.raises(ValueError, match="dst must be"):
        mjpeg.jpeg_decode_bgr(payload, np.empty((32, 48, 3), np.float32))
