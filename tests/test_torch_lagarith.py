"""The port's Lagarith decoder (``native/lagarith.cpp`` and its plain
version ``native/lagarith_plain.py``) against ``cv2.VideoCapture`` and the
JAX package, on the CPU.

No Lagarith encoder exists here (cv2's FFmpeg has the decoder only), so
clips are written by ``tests/_torch_lagarith_writer.py`` from
``numpy.random.default_rng(seed)``, and cv2's decode of them is the
oracle: every frame type FFmpeg reads (2 and 4 RGB24, 8 RGBA, 3 YUY2, 10
YV12, 5 grey, 6 colour and 9 RGBA solid frames), every escape form (range
coded with 0-3 zero-run escapes, raw, zero-run coded, filled), odd sizes
and planes one sample wide, probability headers that scale, the symbol
255 that takes the rest of the range, streams that mix frame types,
null frames, cut planes, and damaged frames.  Tolerances:

* every frame of the plain version, of ``native.lagarith_decode_bgr_batch``
  and of the port's ``video_frame_generator`` (cv2 blocked) equals cv2's
  bit for bit; RGB frames also equal the pictures written.  Where cv2
  gives no frame (FFmpeg fails the frame, and cv2's loop ends there), the
  port raises a ValueError naming the frame and the plane;
* the committed ``tests/data/lagarith *.avi`` decode to their
  ``.cv2.npy`` (cv2's frames; ``python -m tests.test_torch_lagarith``
  rewrites both), which ``chip_smoke.py`` holds the port to on the card's
  machine, which has no cv2;
* ``tests/_torch_lagarith_enc.cpp`` gives the Python writer's bytes;
* ``welford_algorithm`` and ``process_video`` of the port (host backend),
  cv2 blocked, equal the JAX package's ``decoder="cv2"`` bit for bit, and
  ``batch_video_to_hdr`` the JAX package's at rtol 1e-10 (std 1e-9).
"""
from __future__ import annotations

import struct
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
cv2 = pytest.importorskip("cv2")

import jax.numpy as jnp  # noqa: E402

from camera_linearity_tpu.models import pipeline as jpipe  # noqa: E402
from camera_linearity_tpu.models import video as jvideo  # noqa: E402
from camera_linearity_tpu_torch import native  # noqa: E402
from camera_linearity_tpu_torch.__main__ import main as tmain  # noqa: E402
from camera_linearity_tpu_torch.models import pipeline as tpipe  # noqa
from camera_linearity_tpu_torch.models import video as tvideo  # noqa: E402
from camera_linearity_tpu_torch.native import lagarith_plain as lp  # noqa
from camera_linearity_tpu_torch.native import rawvideo_plain  # noqa: E402
from camera_linearity_tpu_torch.utils import avi  # noqa: E402
from camera_linearity_tpu_torch.utils import observability as obs  # noqa
from tests import _torch_lagarith_writer as lw  # noqa: E402

DATA = Path(__file__).resolve().parent / "data"
KINDS = list(lw.FRAME_TYPES)
# (height, width): odd sizes, one row, one column, planes one sample wide
GEOMETRIES = [(12, 16), (7, 13), (1, 9), (5, 1), (2, 3), (9, 4), (3, 2),
              (16, 36)]
ESCAPES = [None, 0, 1, 2, 3, 4]


def cv2_frames(path) -> np.ndarray:
    """Every frame cv2 gives, (n, H, W, 3), n possibly 0."""
    cap = cv2.VideoCapture(str(path))
    out = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        out.append(frame)
    cap.release()
    return np.stack(out) if out else np.zeros((0,), np.uint8)


def picture(kind: str, h: int, w: int, seed: int = 0, noise: float = 0.1):
    """Blocky content (runs of equal samples, so the zero-run escapes have
    zeros to code) with a share ``noise`` of random samples: an (H, W, 3
    or 4) B, G, R(, A) picture for RGB, (Y, U, V) planes for YUV."""
    rng = np.random.default_rng(seed)
    t = lw.FRAME_TYPES[kind]

    def plane(r, c, k):
        yy, xx = np.mgrid[:r, :c]
        p = ((xx // 6 * 7 + yy // 3 * 11 + 29 * k + seed) % 256)
        hit = rng.random((r, c)) < noise
        return np.where(hit, rng.integers(0, 256, (r, c)), p).astype(
            np.uint8)
    if kind in ("rgb24", "urgb24", "rgba"):
        return np.stack([plane(h, w, k) for k in range(
            4 if kind == "rgba" else 3)], -1)
    shapes = lp.plane_shapes(t, h, w)
    return [plane(r, c, k) for k, (r, c) in enumerate(shapes)]


def want_bgr(kind: str, pic, h: int, w: int) -> np.ndarray:
    """The BGR frame of a picture, converted as the decoder converts its
    planes (RGB: the picture itself)."""
    if kind in ("rgb24", "urgb24", "rgba"):
        return np.ascontiguousarray(pic[..., :3])
    layout = lp.frame_kind(lw.FRAME_TYPES[kind])
    return rawvideo_plain.decode_bgr(b"".join(p.tobytes() for p in pic),
                                     layout, h, w)


def _chunks(path):
    info = avi.probe_avi(path)
    return [bytes(c) for c in avi.frame_chunks(path, info)], info


def _native(chunks, h, w, threads=None, first_frame=0):
    assert native.lagarith_available(), native.build_error("_lagarith")
    dst = np.empty((len(chunks), h, w, 3), np.uint8)
    assert native.lagarith_decode_bgr_batch(
        chunks, dst, threads=threads, first_frame=first_frame) == len(chunks)
    return dst


def _plain(chunks, h, w):
    return np.stack([lp.decode_bgr(c, h, w) for c in chunks])


def _port_frames(path):
    frames = list(tvideo.video_frame_generator(path, decoder="native"))
    assert frames[-1] is None
    return np.stack(frames[:-1])


def _check(path, monkeypatch, want=None, written=None):
    """Plain, native and the frame generator (cv2 blocked) give ``want``
    (default: cv2's frames); ``written``, where given, equals it too."""
    chunks, info = _chunks(path)
    if want is None:
        want = cv2_frames(path)
    assert want.shape == (len(chunks), info.height, info.width, 3)
    if written is not None:
        np.testing.assert_array_equal(want, written)
    np.testing.assert_array_equal(_plain(chunks, info.height, info.width),
                                  want)
    np.testing.assert_array_equal(_native(chunks, info.height, info.width),
                                  want)
    with monkeypatch.context() as m:
        m.setitem(sys.modules, "cv2", None)
        assert tvideo._resolve_decoder(
            "native", [path], info.height, info.width, 3) == ["lagarith"]
        np.testing.assert_array_equal(_port_frames(path), want)


def _outcome(fn):
    """A decode's frames, or the text of the ValueError it raised."""
    try:
        return fn()
    except ValueError as exc:
        return str(exc)


def _same_as_cv2(path, chunks, h, w):
    """cv2 and the port agree on one frame: both decode it to the same
    bytes, or cv2 gives no frame and the plain and native decoders both
    raise, naming a plane.  Returns whether the frame decoded."""
    got = cv2_frames(path)
    plain = _outcome(lambda: _plain(chunks, h, w))
    nat = _outcome(lambda: _native(chunks, h, w))
    if len(got) == len(chunks):
        np.testing.assert_array_equal(plain, got)
        np.testing.assert_array_equal(nat, got)
        return True
    assert len(got) == 0
    assert isinstance(plain, str) and "plane" in plain, plain
    assert isinstance(nat, str) and "frame 0: plane" in nat, nat
    return False


# --- frames ----------------------------------------------------------------

def _encodes(kind, h, w, esc) -> bool:
    try:
        for seed in (0, 1):
            lw.encode_picture(kind, picture(kind, h, w, seed), esc=esc)
    except ValueError:
        return False
    return True


FRAME_CASES = [(k, g, e) for k in KINDS for g in GEOMETRIES for e in ESCAPES
               if _encodes(k, *g, e)]


@pytest.mark.parametrize(
    "kind,geometry,esc", FRAME_CASES,
    ids=[f"{k}-{g[0]}x{g[1]}-esc{e}" for k, g, e in FRAME_CASES])
def test_frames_equal_cv2(tmp_path, kind, geometry, esc, monkeypatch):
    """Every frame type FFmpeg reads, every escape form a writer of it
    uses, at odd sizes and one row or column: the plain version, the
    native decoder and the port's frame generator (cv2 blocked) give
    cv2's frames bit for bit, and RGB frames are the pictures written."""
    h, w = geometry
    pics = [picture(kind, h, w, seed) for seed in (0, 1)]
    path = tmp_path / "clip 5ms.avi"
    lw.write_lagarith_avi(path, [lw.encode_picture(kind, p, esc=esc)
                                 for p in pics], h, w,
                          32 if kind == "rgba" else 24)
    _check(path, monkeypatch, written=np.stack(
        [want_bgr(kind, p, h, w) for p in pics]))


def test_frame_cases_cover_every_escape():
    """The writer's escapes reach every form on every frame type."""
    assert {e for _, _, e in FRAME_CASES} == set(ESCAPES)
    for kind in KINDS:
        assert len({e for k, _, e in FRAME_CASES if k == kind}) >= 5, kind
    assert len(FRAME_CASES) >= 150


@pytest.mark.parametrize("bits", [24, 32])
@pytest.mark.parametrize("stream", ["solid", "yv12 first", "rgb first"])
def test_mixed_streams_and_null_frames_equal_cv2(tmp_path, bits, stream,
                                                 monkeypatch):
    """A frame's type is its own: solid grey, colour and RGBA frames among
    coded frames of every type, and zero-length chunks (Lagarith's null
    frames, which cv2 skips), under a header of 24 or 32 bits."""
    h, w = 9, 14
    solids = [lw.solid_frame(77), lw.solid_frame(10, 20, 30),
              lw.solid_frame(200, 100, 50, 7)]
    coded = [lw.encode_picture(k, picture(k, h, w, i))
             for i, k in enumerate(("yv12", "rgb24", "yuy2", "rgba",
                                    "urgb24"))]
    chunks = {"solid": solids + [b""] + solids[::-1],
              "yv12 first": [coded[0], b"", solids[1], coded[1], b"",
                             coded[0], solids[0], coded[2]],
              "rgb first": [coded[1], solids[2], coded[3], b"", coded[4],
                            coded[0], solids[0], b""]}[stream]
    path = tmp_path / "mixed 5ms.avi"
    lw.write_lagarith_avi(path, chunks, h, w, bits)
    got = cv2_frames(path)
    assert len(got) == sum(1 for c in chunks if c)
    assert (got[0 if stream == "solid" else 1] == {
        "solid": [77] * 3, "yv12 first": [10, 20, 30],
        "rgb first": [200, 100, 50]}[stream]).all()
    _check(path, monkeypatch, want=got)


def test_batches_and_threads_agree():
    """One batch mixing every frame type, on 1, 3 and every thread, with
    ``first_frame`` counting on; a reused plane buffer."""
    h, w = 11, 10
    chunks = [lw.encode_picture(k, picture(k, h, w, i)) for i, k in
              enumerate(KINDS * 2)] + [lw.solid_frame(5), lw.solid_frame(
                  1, 2, 3)]
    want = _plain(chunks, h, w)
    for threads in (1, 3, None):
        np.testing.assert_array_equal(_native(chunks, h, w, threads), want)
    planes = np.empty(len(chunks) * 2 * h * w, np.uint8)
    dst = np.empty((len(chunks), h, w, 3), np.uint8)
    native.lagarith_decode_bgr_batch(chunks, dst, planes=planes)
    np.testing.assert_array_equal(dst, want)


# --- escape forms and the range coder --------------------------------------

def _plane_clip(tmp_path, bodies, h, w, t=lp.ARITH_RGB24, bits=24):
    """A one-frame clip whose planes are ``bodies`` (coded plane bytes, in
    the offsets' order)."""
    chunk = lw._assemble(t, bodies)
    path = tmp_path / "plane 5ms.avi"
    lw.write_lagarith_avi(path, [chunk], h, w, bits)
    return path, [chunk]


FILL = bytes([0xFF, 0])


@pytest.mark.parametrize("esc", [5, 6, 7])
@pytest.mark.parametrize("seed", range(6))
def test_zero_run_planes_equal_cv2(tmp_path, esc, seed):
    """Escapes 5-7, zero runs without the range coder
    (``lag_decode_zero_run_line``, with its quirks: the last two samples
    of a row never written, runs counted from the second byte): the port
    gives cv2's frame, or raises where FFmpeg fails the plane."""
    rng = np.random.default_rng(seed)
    h, w = [(4, 8), (6, 12), (3, 5), (5, 2), (2, 16), (7, 3)][seed]
    zeros = rng.random(4 * h * w + 8) < [0.15, 0.3, 0.5][seed % 3]
    stream = (rng.integers(1, 256, zeros.size) * ~zeros).astype(np.uint8)
    if esc > 5:
        # runs of small counts: the run byte follows the zeros
        stream[np.flatnonzero(zeros[:-3]) + esc - 4] &= 3
    body = bytes([esc]) + stream.tobytes()
    path, chunks = _plane_clip(tmp_path, [FILL, body, FILL], h, w)
    _same_as_cv2(path, chunks, h, w)


def test_zero_run_planes_cover_frames_and_failures(tmp_path):
    """The zero-run cases above include frames cv2 decodes and frames it
    fails, for every escape."""
    seen = set()
    for esc in (5, 6, 7):
        for seed in range(6):
            rng = np.random.default_rng(seed)
            h, w = [(4, 8), (6, 12), (3, 5), (5, 2), (2, 16), (7, 3)][seed]
            zeros = rng.random(4 * h * w + 8) < [0.15, 0.3, 0.5][seed % 3]
            stream = (rng.integers(1, 256, zeros.size) * ~zeros).astype(
                np.uint8)
            if esc > 5:
                stream[np.flatnonzero(zeros[:-3]) + esc - 4] &= 3
            path, chunks = _plane_clip(
                tmp_path, [FILL, bytes([esc]) + stream.tobytes(), FILL], h, w)
            seen.add((esc, _same_as_cv2(path, chunks, h, w)))
    assert {e for e, ok in seen if ok} == {5, 6, 7}
    assert any(not ok for _, ok in seen)


def _coded(sym, counts, esc=0, length=None):
    cum, scale = lp.scale_probs(counts)
    head = bytes([esc]) + (b"" if length is None else
                           struct.pack("<I", length))
    return head + lw.prob_header(counts) + lw.range_encode(sym, cum, scale)


def _probability_case(case: str):
    """A G plane of 6 x 10 residuals under probability counts ``case``;
    the other planes filled."""
    rng = np.random.default_rng(len(case))
    n = 60
    if case == "power of two":
        sym = rng.integers(0, 4, n)
        counts = [16] * 4 + [0] * 252
    elif case == "scaled with a remainder":
        sym = rng.integers(0, 7, n)
        counts = [3, 5, 7, 11, 13, 17, 19] + [0] * 249
    elif case == "255 takes the rest":
        sym = rng.choice([0, 1, 254, 255], n)
        counts = [5, 3] + [0] * 252 + [9, 40]
    elif case == "every symbol":
        sym = rng.integers(0, 256, n)
        counts = list(rng.integers(1, 1000, 256))
    elif case == "counts of up to 31 bits":
        sym = rng.integers(0, 3, n)
        counts = [(1 << 21) + 5, 1 << 20, 77777] + [0] * 253
    elif case == "zero counts between":
        sym = rng.choice([0, 9, 130, 200], n)
        counts = [0] * 256
        for s, c in zip((0, 9, 130, 200), (40, 3, 9, 2)):
            counts[s] = c
    elif case == "a total of 2^23":
        sym = rng.integers(0, 2, n)
        counts = [1 << 22, 1 << 22] + [0] * 254
    else:  # "symbol 0 absent"
        sym = rng.integers(1, 5, n)
        counts = [0, 9, 9, 9, 9] + [0] * 251
    return [int(s) for s in sym], [int(c) for c in counts]


PROBABILITY_CASES = ["power of two", "scaled with a remainder",
                     "255 takes the rest", "every symbol",
                     "counts of up to 31 bits", "zero counts between",
                     "a total of 2^23", "symbol 0 absent"]


@pytest.mark.parametrize("case", PROBABILITY_CASES)
def test_probability_headers_equal_cv2(tmp_path, case):
    """The probability header (Fibonacci-coded bit lengths, zero runs) and
    its scaling to a power of two (FFmpeg's soft-float reciprocal and its
    remainder handed to symbols 0-127), then the range coder, symbol 255
    taking the range above its start."""
    sym, counts = _probability_case(case)
    path, chunks = _plane_clip(tmp_path, [FILL, _coded(sym, counts), FILL],
                               6, 10)
    assert _same_as_cv2(path, chunks, 6, 10)


@pytest.mark.parametrize("length", ["symbols", "samples - 1", "samples",
                                    "more"])
def test_the_stored_length_is_read_as_cv2(tmp_path, length):
    """Escapes 1-3 store a 32-bit length; FFmpeg takes it (and skips it)
    only where it is below the sample count, and otherwise reads the
    probability header from the length's bytes."""
    h, w = 6, 10
    pic = np.zeros((h, w, 3), np.uint8)
    pic[3:, 5:] = 40
    res = lw.residuals(lw.coded_planes(lp.ARITH_RGB24, pic)[1], "median")
    sym = lw.run_symbols(res, 1)
    n = {"symbols": sym.size, "samples - 1": h * w - 1, "samples": h * w,
         "more": h * w + 5}[length]
    body = _coded(sym.tolist(), lw.counts_for(sym), 1, n)
    path, chunks = _plane_clip(tmp_path, [FILL, body, FILL], h, w)
    assert _same_as_cv2(path, chunks, h, w) == (n < h * w)


@pytest.mark.parametrize("plane", [1, 2])
@pytest.mark.parametrize("cut", [1, 2, 4, 8, 16, 64])
def test_cut_planes_read_as_cv2(tmp_path, plane, cut):
    """A plane whose coded bytes are cut: the range coder reads on into
    the next plane, or past the chunk's end into its zero padding, and
    FFmpeg fails the plane once it has read past the end more than four
    times when a row starts."""
    h, w = 12, 20
    rng = np.random.default_rng(cut)
    pic = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    bodies = [lw.encode_plane(p, "median", 0)
              for p in lw.coded_planes(lp.ARITH_RGB24, pic)]
    bodies[plane] = bodies[plane][:-cut]
    path, chunks = _plane_clip(tmp_path, bodies, h, w)
    _same_as_cv2(path, chunks, h, w)


def test_a_cut_last_plane_fails_as_cv2(tmp_path):
    """Cut far enough, the last plane reads past the chunk more than four
    times and both cv2 and the port give it up."""
    h, w = 12, 20
    pic = np.random.default_rng(3).integers(0, 256, (h, w, 3),
                                            dtype=np.uint8)
    bodies = [lw.encode_plane(p, "median", 0)
              for p in lw.coded_planes(lp.ARITH_RGB24, pic)]
    bodies[2] = bodies[2][:len(bodies[2]) // 2]
    path, chunks = _plane_clip(tmp_path, bodies, h, w)
    assert not _same_as_cv2(path, chunks, h, w)


# --- the native encoder ----------------------------------------------------

ENCODER_CASES = [(k, e) for k in KINDS for e in ESCAPES
                 if _encodes(k, 9, 14, e)]


@pytest.mark.parametrize("kind,esc", ENCODER_CASES)
def test_native_encoder_gives_the_writers_bytes(kind, esc):
    h, w = 9, 14
    pics = [picture(kind, h, w, seed, noise) for seed, noise in
            ((0, 0.1), (1, 0.9), (2, 0.0))]

    def either(fn, *args, **kw):
        try:
            return fn(*args, **kw)
        except (ValueError, RuntimeError):
            return "refused"
    python = [either(lw.encode_picture, kind, p, esc=esc) for p in pics]
    assert [either(lw.native_encode, kind, [p], esc=esc, threads=3)
            for p in pics] == [[b] if b != "refused" else b for b in python]
    if "refused" not in python:
        assert lw.native_encode(kind, pics, esc=esc, threads=3) == python


# --- refusals and damaged frames -------------------------------------------

REFUSED_TYPES = [0, 1, 7, 11, 12, 255]


@pytest.mark.parametrize("frame_type", REFUSED_TYPES)
def test_refused_frame_types_raise_before_decode(tmp_path, frame_type,
                                                 monkeypatch):
    """A stream whose first frame is of a type FFmpeg refuses (cv2 gives
    no frame) raises a ValueError naming the type before any frame is
    decoded, and never reaches cv2."""
    h, w = 6, 8
    good = lw.encode_picture("rgb24", picture("rgb24", h, w))
    path = tmp_path / "refused 5ms.avi"
    lw.write_lagarith_avi(path, [bytes([frame_type]) + good[1:], good], h, w)
    assert len(cv2_frames(path)) == 0

    def no_decode(*args, **kwargs):
        raise AssertionError("a frame was decoded or cv2 was reached")
    monkeypatch.setattr(native, "lagarith_decode_bgr_batch", no_decode)
    monkeypatch.setattr(tvideo, "_cv2", no_decode)
    why = f"type {frame_type} .*FFmpeg refuses"
    assert "LAGS" == avi.probe_avi(path).codec
    with pytest.raises(ValueError, match="Lagarith decoder.*" + why):
        tvideo._resolve_decoder("native", [path], h, w, 3)
    with pytest.raises(ValueError, match=why):
        tvideo.welford_algorithm(path, use_std=True)


@pytest.mark.parametrize("frame_type", [1, 7, 11])
def test_a_later_refused_frame_raises_naming_it(tmp_path, frame_type,
                                                monkeypatch):
    """A refused type after readable frames: cv2's loop ends there; the
    port raises naming the frame and its type."""
    h, w = 6, 8
    good = lw.encode_picture("yv12", picture("yv12", h, w))
    chunks = [good, good, bytes([frame_type]) + good[1:], good]
    path = tmp_path / "later 5ms.avi"
    lw.write_lagarith_avi(path, chunks, h, w)
    assert len(cv2_frames(path)) == 2
    with pytest.raises(ValueError, match=f"type {frame_type} "):
        lp.decode_bgr(chunks[2], h, w)
    with pytest.raises(ValueError, match=f"frame 6: frame type {frame_type}"):
        _native(chunks, h, w, first_frame=4)
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ValueError, match=f"frame 2: frame type {frame_type}"):
        list(tvideo.video_frame_generator(path, decoder="native"))


def _damaged(case: str, h: int, w: int):
    """An RGB24 chunk damaged as ``case`` says, the plane it names and
    what the message says."""
    pic = picture("rgb24", h, w, 5, noise=0.5)
    bodies = [lw.encode_plane(p, "median", 0)
              for p in lw.coded_planes(lp.ARITH_RGB24, pic)]
    if case == "offset past the chunk":
        c = bytearray(lw._assemble(lp.ARITH_RGB24, bodies))
        struct.pack_into("<I", c, 5, len(c) + 3)
        return bytes(c), 2, "offset .*past the chunk"
    if case == "header cut":
        return lw._assemble(lp.ARITH_RGB24, bodies)[:7], None, \
            "shorter than its frame header|header needs"
    if case == "escape byte 8":
        bodies[1] = b"\x08" + bodies[1][1:]
        return lw._assemble(lp.ARITH_RGB24, bodies), 1, "escape"
    if case == "a count of 32 bits":
        # bit length 33: Fibonacci 21 + 8 + 3 + 1 in seven bits
        bodies[1] = b"\x00" + bytes([0b10101010, 0, 0, 0, 0, 0])
        return lw._assemble(lp.ARITH_RGB24, bodies), 1, \
            "probability header|bits in its probability"
    if case == "all counts zero":
        bodies[0] = b"\x00" + lw.prob_header([0] * 256) + b"\0" * 8
        return lw._assemble(lp.ARITH_RGB24, bodies), 0, \
            "probability header|all zero"
    if case == "only symbols above 127":
        bodies[0] = b"\x00" + lw.prob_header([0] * 200 + [3, 4, 5] +
                                             [0] * 53) + b"\0" * 8
        return lw._assemble(lp.ARITH_RGB24, bodies), 0, \
            "probability header|0-127"
    if case == "a total of 2^24":
        bodies[2] = b"\x00" + lw.prob_header([1 << 23] * 2 + [0] * 254) + \
            b"\x55" * 40
        return lw._assemble(lp.ARITH_RGB24, bodies), 2, \
            "probability header|2\\^24"
    # "raw plane cut"
    bodies[2] = b"\x04" + bytes(h * w - 1)
    return lw._assemble(lp.ARITH_RGB24, bodies), 2, \
        "end before the plane|raw plane"


DAMAGE = ["offset past the chunk", "header cut", "escape byte 8",
          "a count of 32 bits", "all counts zero", "only symbols above 127",
          "a total of 2^24", "raw plane cut"]


@pytest.mark.parametrize("case", DAMAGE)
def test_a_damaged_frame_raises_naming_it(tmp_path, case, monkeypatch):
    """Damage FFmpeg fails on (cv2's loop ends at the frame) raises in the
    plain and the native decoder and in the frame generator, naming the
    frame and the plane."""
    h, w = 6, 10
    bad, plane, why = _damaged(case, h, w)
    good = lw.encode_picture("rgb24", picture("rgb24", h, w, 1))
    chunks = [good, bad, good]
    path = tmp_path / "damaged 5ms.avi"
    lw.write_lagarith_avi(path, chunks, h, w)
    assert len(cv2_frames(path)) == 1
    where = "" if plane is None else f"plane {plane}: "
    with pytest.raises(ValueError, match=where + f".*({why})"):
        lp.decode_bgr(bad, h, w)
    with pytest.raises(ValueError, match=f"frame 8: {where}.*({why})"):
        _native(chunks, h, w, first_frame=7)
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ValueError, match=f"frame 1: {where}"):
        list(tvideo.video_frame_generator(path, decoder="native"))


def test_a_zero_run_past_its_plane_is_refused(tmp_path, monkeypatch):
    """A zero run longer than what is left of its plane: FFmpeg carries the
    rest into the next plane it decodes (and cv2 gives a frame that
    depends on what its decoder did before), so the port refuses the
    frame, naming the plane, and never reaches cv2."""
    h, w = 6, 10
    sym = [7] * (h * w - 11) + [0, 20]     # then 40 zeros, 10 in the plane
    counts = [1, 1] + [0] * 5 + [8] + [0] * 248
    bodies = [FILL, _coded(sym, counts, 1, len(sym)), FILL]
    path, chunks = _plane_clip(tmp_path, bodies, h, w)
    assert len(cv2_frames(path)) == 1
    why = "plane 1: a zero run that outlasts the plane"
    with pytest.raises(ValueError, match=why):
        lp.decode_bgr(chunks[0], h, w)
    with pytest.raises(ValueError, match="frame 0: plane 1: a zero run"):
        _native(chunks, h, w)
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ValueError, match="frame 0: plane 1: a zero run"):
        list(tvideo.video_frame_generator(path, decoder="native"))


def test_the_first_plane_ffmpeg_decodes_is_named():
    """Of several damaged planes, the one FFmpeg decodes first (RGB: R - G,
    then G, then B - G) is named."""
    h, w = 6, 10
    bodies = [lw.encode_plane(p, "median", 0) for p in lw.coded_planes(
        lp.ARITH_RGB24, picture("rgb24", h, w, 2, 0.5))]
    for k in (0, 1):
        bodies[k] = b"\x09" + bodies[k][1:]
    chunk = lw._assemble(lp.ARITH_RGB24, bodies)
    with pytest.raises(ValueError, match="plane 1: escape byte 0x9"):
        lp.decode_bgr(chunk, h, w)
    with pytest.raises(ValueError, match="frame 0: plane 1: an escape"):
        _native([chunk], h, w)


@pytest.mark.parametrize("seed", range(8))
def test_native_equals_plain_on_damaged_bytes(seed):
    """Chunks with random bytes changed: the native decoder gives the plain
    version's frame, or raises where it raises, naming the same plane."""
    rng = np.random.default_rng(seed)
    h, w = int(rng.integers(2, 9)), int(rng.integers(2, 12))
    kinds = KINDS + ["solid"]
    for trial in range(24):
        kind = kinds[trial % len(kinds)]
        if kind == "solid":
            chunk = bytearray(lw.solid_frame(*rng.integers(0, 256, 3)))
        else:
            chunk = bytearray(lw.encode_picture(
                kind, picture(kind, h, w, trial), esc=(None, 0, 4)[trial % 3]))
        for _ in range(int(rng.integers(1, 4))):
            at = int(rng.integers(1, len(chunk)))
            chunk[at] = int(rng.integers(0, 256))
        if rng.random() < 0.3:
            chunk = chunk[:int(rng.integers(1, len(chunk) + 1))]
        plain = _outcome(lambda: lp.decode_bgr(bytes(chunk), h, w))
        nat = _outcome(lambda: _native([bytes(chunk)], h, w)[0])
        if isinstance(plain, str):
            assert isinstance(nat, str), plain
            named = [m for m in ("plane 0", "plane 1", "plane 2", "plane 3")
                     if m in plain]
            assert all(m in nat for m in named), (plain, nat)
        else:
            np.testing.assert_array_equal(nat, plain)


def test_a_failed_build_raises_and_never_reaches_cv2(tmp_path, monkeypatch):
    path = tmp_path / "lags 5ms.avi"
    lw.write_lagarith_avi(path, [lw.encode_picture(
        "rgb24", picture("rgb24", 6, 8))], 6, 8)
    monkeypatch.setitem(native._decoder_libs, "_lagarith", None)
    monkeypatch.setitem(native._build_errors, "_lagarith",
                        "g++: simulated failure")

    def no_cv2(why):
        raise AssertionError(f"cv2 was reached: {why}")
    monkeypatch.setattr(tvideo, "_cv2", no_cv2)
    with pytest.raises(RuntimeError, match="lagarith.cpp.*simulated failure"):
        tvideo.welford_algorithm(path, use_std=True)


# --- the committed clips ---------------------------------------------------

CLIPS = ["rgb24", "rgba", "yuy2", "yv12", "mixed"]


def clip_chunks(name: str):
    """The frames of ``tests/data/lagarith <name> 5ms.avi`` (48 x 64) and
    its header's bit count."""
    h, w = 48, 64
    if name == "mixed":
        return [lw.encode_picture("yv12", picture("yv12", h, w, 3)), b"",
                lw.solid_frame(10, 20, 30),
                lw.encode_picture("rgb24", picture("rgb24", h, w, 4)),
                lw.solid_frame(77),
                lw.encode_picture("yuy2", picture("yuy2", h, w, 5))], 24
    return [lw.encode_picture(name, picture(name, h, w, seed, noise))
            for seed, noise in ((0, 0.05), (1, 0.5))], \
        32 if name == "rgba" else 24


def clip_path(name: str) -> Path:
    return DATA / f"lagarith {name} 5ms.avi"


@pytest.mark.parametrize("name", CLIPS)
def test_committed_clips_decode_to_cv2s_frames(name, monkeypatch):
    """Each committed clip is the writer's, its ``.cv2.npy`` is cv2's
    frames of it, and the port (cv2 blocked) gives them."""
    path = clip_path(name)
    chunks, bits = clip_chunks(name)
    got, info = _chunks(path)
    assert got == [c for c in chunks if c] and info.bit_count == bits
    want = np.load(path.with_suffix(".cv2.npy"))
    np.testing.assert_array_equal(cv2_frames(path), want)
    _check(path, monkeypatch, want=want)


def write_clips() -> None:
    """Rewrite ``tests/data/lagarith *.avi`` and their ``.cv2.npy``."""
    for name in CLIPS:
        chunks, bits = clip_chunks(name)
        path = clip_path(name)
        lw.write_lagarith_avi(path, chunks, 48, 64, bits)
        np.save(path.with_suffix(".cv2.npy"), cv2_frames(path))


# --- the port's entry points -----------------------------------------------

def test_doctor_reports_the_lagarith_decoder(tmp_path, capsys):
    path = tmp_path / "v 5ms.avi"
    lw.write_lagarith_avi(path, [lw.encode_picture(
        "rgb24", picture("rgb24", 16, 24, s)) for s in range(3)], 16, 24)
    assert tmain(["--device", "cpu", "doctor", "--video", str(path)]) == 0
    out = capsys.readouterr().out
    for line in ("native Lagarith decoder: built; Lagarith AVIs (LAGS)",
                 "decode (lagarith, 1 thread(s))", "decode (native)"):
        assert line in out, line


@pytest.mark.parametrize("kind", ["rgb24", "yv12"])
def test_welford_and_process_video_equal_jax(tmp_path, kind, monkeypatch):
    """With cv2 blocked, the port's ``welford_algorithm`` (host backend)
    and ``process_video`` equal the JAX package's with ``decoder="cv2"``
    bit for bit; the device backend at rtol 1e-9."""
    monkeypatch.delenv("CL_DECODER", raising=False)
    h, w = 14, 24
    chunks = [lw.encode_picture(kind, picture(kind, h, w, s, 0.6))
              for s in range(9)]
    clips = {}
    for who in ("port", "jax"):
        (tmp_path / who).mkdir()
        clips[who] = tmp_path / who / "scene 5ms.avi"
        lw.write_lagarith_avi(clips[who], chunks[:4] + [b""] + chunks[4:],
                              h, w)
    want = jvideo.welford_algorithm(clips["jax"], use_std=True,
                                    decoder="cv2")
    jvideo.process_video(clips["jax"], decoder="cv2")
    with monkeypatch.context() as m:
        m.setitem(sys.modules, "cv2", None)
        obs.reset_stage_times()
        got = tvideo.welford_algorithm(clips["port"], use_std=True)
        assert obs.decoded_frames.snapshot() == {"lagarith": 9}
        dev = tvideo.welford_algorithm(clips["port"], use_std=True,
                                       backend="device", batch_size=4,
                                       device="cpu")
        tvideo.process_video(clips["port"])
    for key in ("mean", "std"):
        np.testing.assert_array_equal(got[key], want[key])
        np.testing.assert_allclose(dev[key], want[key], rtol=1e-9,
                                   atol=1e-15)
        files = [cv2.imread(str(clips[who].with_name(
            f"scene 5ms.{key}.tif")), cv2.IMREAD_UNCHANGED)
            for who in ("port", "jax")]
        assert files[1] is not None and files[1].dtype == np.float64
        np.testing.assert_array_equal(files[0], files[1])


def test_batch_video_to_hdr_equals_jax(tmp_path, monkeypatch):
    """The slice as a whole: Lagarith scenes (RGB24 and YV12 videos)
    through the port's pipeline, cv2 blocked, against the JAX package's,
    which reads them with cv2."""
    monkeypatch.delenv("CL_DECODER", raising=False)
    h, w = 16, 24
    icrf = np.linspace(0, 1, 256)[:, None].repeat(3, 1) ** \
        np.array([2.0, 2.2, 2.4])
    scenes = {}
    for s, name in enumerate(("a", "b")):
        paths = []
        kind = ("rgb24", "yv12")[s]
        for k, ms in enumerate((4, 8, 16)):
            (tmp_path / name).mkdir(exist_ok=True)
            path = tmp_path / name / f"{name} {ms}ms.avi"
            lw.write_lagarith_avi(path, [lw.encode_picture(
                kind, picture(kind, h, w, 10 * s + k + f, 0.7))
                for f in range(5)], h, w)
            paths.append(path)
        scenes[name] = paths
    want = jpipe.batch_video_to_hdr(scenes, jnp.asarray(icrf))
    monkeypatch.setitem(sys.modules, "cv2", None)
    obs.reset_stage_times()
    got = tpipe.batch_video_to_hdr(scenes, icrf, device="cpu")
    assert obs.decoded_frames.snapshot() == {"lagarith": 2 * 3 * 5}
    for name in scenes:
        np.testing.assert_allclose(
            got[name].measurand.val.numpy(),
            np.asarray(want[name].measurand.val), rtol=1e-10, atol=1e-14)
        np.testing.assert_allclose(
            got[name].measurand.std.numpy(),
            np.asarray(want[name].measurand.std), rtol=1e-9, atol=1e-14)


if __name__ == "__main__":
    write_clips()
