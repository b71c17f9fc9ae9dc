"""The port's UtVideo decoder (``native/utvideo.cpp`` and its plain version
``native/utvideo_plain.py``) against ``cv2.VideoCapture`` and the JAX
package, on the CPU.

Clips are written by cv2's own writer (``cv2.VideoWriter(fourcc
"ULY0")``, which writes ULY0 whatever Ut Video fourcc it is asked for)
and by ``tests/_torch_utvideo_writer.py`` from
``numpy.random.default_rng(seed)``: every fourcc (``ULRG``, ``ULRA``,
``ULY0``, ``ULY2``, ``ULY4``, ``ULH0``, ``ULH2``, ``ULH4``) with every
predictor (none, left, gradient, median), odd sizes, 1- and 2-row frames,
1 to 9 slices, fill planes, tables with codes of up to 32 bits and the
interlaced flag.  Tolerances:

* every frame of the plain version, of ``native.utvideo_decode_bgr_batch``
  and of the port's ``video_frame_generator`` (cv2 blocked) equals cv2's
  bit for bit; RGB frames also equal the frames written.  Interlaced
  frames are held to the pictures written instead: cv2 5.0 gives memory
  swscale never wrote for them (it refuses to convert an interlaced frame
  to a progressive one);
* the writer at cv2's settings (``ULY0``, left, FFmpeg's slice count)
  gives cv2's frame chunks byte for byte;
* the rawvideo converter's ``yuv444p`` route and the BT.709 matrix of the
  ``ULH*`` fourccs equal cv2 bit for bit on every value at the range
  edges;
* ``welford_algorithm``, ``process_video`` and ``batch_video_to_hdr`` of
  the port, cv2 blocked, equal the JAX package's defaults (cv2) at rtol
  1e-10 (the device backend's and the pipeline's std at 1e-9).
"""
from __future__ import annotations

import struct
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
cv2 = pytest.importorskip("cv2")

import jax.numpy as jnp  # noqa: E402

from camera_linearity_tpu.models import pipeline as jpipe  # noqa: E402
from camera_linearity_tpu.models import video as jvideo  # noqa: E402
from camera_linearity_tpu_torch import native  # noqa: E402
from camera_linearity_tpu_torch.models import pipeline as tpipe  # noqa
from camera_linearity_tpu_torch.models import video as tvideo  # noqa: E402
from camera_linearity_tpu_torch.native import rawvideo_plain  # noqa: E402
from camera_linearity_tpu_torch.native import utvideo_plain as up  # noqa
from camera_linearity_tpu_torch.utils import avi  # noqa: E402
from camera_linearity_tpu_torch.utils import observability as obs  # noqa
from tests import _torch_libavcodec as lav  # noqa: E402
from tests import _torch_utvideo_writer as uw  # noqa: E402
from tests._torch_rawvideo_writer import pcm_stream  # noqa: E402
from tests.test_torch_native import cv2_frames  # noqa: E402

STATS = dict(rtol=1e-10, atol=1e-15)
FOURCCS = up.UTVIDEO_FOURCCS
PREDICTORS = list(uw.PREDICTORS)
# (height, width, slices): odd sizes, 1- and 2-row frames, 1, 2, 3, 5 and
# 9 slices (3 over 7 rows and 5 over 12 leave slices of unequal height)
GEOMETRIES = [(12, 18, 1), (7, 13, 3), (1, 14, 1), (2, 6, 2), (18, 10, 9),
              (12, 16, 5)]


def _valid(fourcc: str, h: int, w: int, slices: int,
           interlaced: bool = False) -> bool:
    p = uw.stream_params(fourcc, slices, interlaced)
    if up.size_unsupported(p, h, w):
        return False
    # no slice without rows (FFmpeg fails on the empty slice it codes)
    return all(r1 > r0 for k, (rows, _) in enumerate(
        up.plane_shapes(p.layout, h, w)) for r0, r1 in up.slice_rows(
            p, k, rows))


def pictures(fourcc: str, h: int, w: int, n: int = 2, seed: int = 0,
             lo: int = 0, hi: int = 256):
    """Smooth content with noise: (H, W, 3 or 4) frames for RGB, (Y, U, V)
    planes for YUV."""
    rng = np.random.default_rng(seed)
    layout = up.LAYOUTS[fourcc]
    out = []
    for _ in range(n):
        if layout in ("gbrp", "gbrap"):
            yy, xx = np.mgrid[:h, :w]
            base = np.stack([xx * 3 + yy * 5, xx * 7, yy * 11 + xx,
                             xx + yy], -1)
            f = (base + rng.integers(0, 40, (h, w, 4))) % (hi - lo) + lo
            out.append(f[..., :4 if layout == "gbrap" else 3].astype(
                np.uint8))
        else:
            out.append([((np.add.outer(np.arange(r) * 7, np.arange(c) * 3)
                          + rng.integers(0, 40, (r, c))) % (hi - lo) + lo
                         ).astype(np.uint8)
                        for r, c in up.plane_shapes(layout, h, w)])
    return out


def _want(fourcc: str, pics, h: int, w: int) -> np.ndarray:
    """The BGR frames of pictures, converted as the decoder converts
    their planes (RGB: the frames themselves)."""
    p = uw.stream_params(fourcc, 1)
    if p.layout in ("gbrp", "gbrap"):
        return np.stack([f[..., :3] for f in pics])
    return np.stack([rawvideo_plain.decode_bgr(
        b"".join(c.tobytes() for c in pl), up.yuv_layout(p), h, w,
        matrix=up.matrix(p)) for pl in pics])


def _chunks(path):
    info = avi.probe_avi(path)
    return [bytes(c) for c in avi.frame_chunks(path, info)], info


def _native(chunks, info, threads=None):
    assert native.utvideo_available(), native.build_error("_utvideo")
    dst = np.empty((len(chunks), info.height, info.width, 3), np.uint8)
    assert native.utvideo_decode_bgr_batch(
        chunks, dst, avi.utvideo_params(info), threads=threads) == \
        len(chunks)
    return dst


def _plain(chunks, info):
    params = avi.utvideo_params(info)
    return np.stack([up.decode_bgr(c, params, info.height, info.width)
                     for c in chunks])


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
    np.testing.assert_array_equal(_plain(chunks, info), want)
    np.testing.assert_array_equal(_native(chunks, info), want)
    with monkeypatch.context() as m:
        m.setitem(sys.modules, "cv2", None)
        assert tvideo._resolve_decoder(
            "native", [path], info.height, info.width, 3) == ["utvideo"]
        np.testing.assert_array_equal(_port_frames(path), want)


# --- frames ----------------------------------------------------------------

FRAME_CASES = [(f, p, g) for f in FOURCCS for p in PREDICTORS
               for g in GEOMETRIES if _valid(f, *g)]


@pytest.mark.parametrize(
    "fourcc,predictor,geometry", FRAME_CASES,
    ids=[f"{f}-{p}-{g[0]}x{g[1]}x{g[2]}" for f, p, g in FRAME_CASES])
def test_frames_equal_cv2(tmp_path, fourcc, predictor, geometry,
                          monkeypatch):
    """The plain version, the native decoder and the port's frame
    generator (cv2 blocked) give cv2's frames bit for bit."""
    h, w, slices = geometry
    pics = pictures(fourcc, h, w, seed=h * w + slices)
    path = tmp_path / "clip 5ms.avi"
    uw.write_utvideo_avi(path, pics, h, w, fourcc, predictor, slices)
    rgb = fourcc in ("ULRG", "ULRA")
    _check(path, monkeypatch, written=_want(fourcc, pics, h, w) if rgb
           else None)


INTERLACED_CASES = [(f, p) for f in FOURCCS for p in PREDICTORS]


@pytest.mark.parametrize("fourcc,predictor", INTERLACED_CASES)
def test_interlaced_frames_equal_the_pictures(tmp_path, fourcc, predictor,
                                              monkeypatch):
    """The interlaced flag: each pair of rows predicted as one row of
    twice the width, slices of whole pairs (of 4 rows for yuv420p).  cv2
    gives memory swscale never wrote for these frames, so they are held
    to the pictures written (the planes FFmpeg's decoder gives, converted
    as a progressive frame)."""
    h, w, slices = 16, 10, 3
    pics = pictures(fourcc, h, w, seed=len(fourcc + predictor))
    path = tmp_path / "interlaced 5ms.avi"
    uw.write_utvideo_avi(path, pics, h, w, fourcc, predictor, slices,
                         interlaced=True)
    assert avi.utvideo_params(avi.probe_avi(path)).interlaced
    _check(path, monkeypatch, want=_want(fourcc, pics, h, w))


@pytest.mark.skipif(not lav.available(),
                    reason="cv2's libavcodec is not found")
@pytest.mark.parametrize("fourcc", FOURCCS)
def test_interlaced_frames_equal_libavcodecs_planes(tmp_path, fourcc):
    """Interlaced frames, which cv2 does not convert, held to the planes
    cv2's own libavcodec decodes them to (``tests/_torch_libavcodec.py``):
    the plain version's planes (RGB restored from its G, B - G and R - G
    planes) and the pictures written equal them, every predictor."""
    h, w, slices = 16, 10, 3
    for predictor in PREDICTORS:
        pics = pictures(fourcc, h, w, seed=len(fourcc + predictor))
        path = tmp_path / f"interlaced {predictor} 5ms.avi"
        uw.write_utvideo_avi(path, pics, h, w, fourcc, predictor, slices,
                             interlaced=True)
        chunks, info = _chunks(path)
        params = avi.utvideo_params(info)
        got = lav.decode_planes(path)
        assert len(got) == len(pics)
        for chunk, pic, (fmt, planes) in zip(chunks, pics, got):
            mine = up.decode_planes(chunk, params, h, w)[0]
            if params.layout in ("gbrp", "gbrap"):
                assert fmt == params.layout
                g = mine[0].astype(np.int64)
                mine = [g, (mine[1] + g - 0x80) & 255,
                        (mine[2] + g - 0x80) & 255] + mine[3:]
                # the picture is (B, G, R, A): planes G, B, R, A
                pic = [pic[..., 1], pic[..., 0], pic[..., 2]] + \
                    ([pic[..., 3]] if fourcc == "ULRA" else [])
            assert len(planes) == len(mine) == len(pic)
            for k, (a, b, c) in enumerate(zip(planes, mine, pic)):
                np.testing.assert_array_equal(a, b, err_msg=f"plane {k}")
                np.testing.assert_array_equal(a, c, err_msg=f"plane {k}")


@pytest.mark.parametrize("fourcc", ["ULRG", "ULY0", "ULY4"])
@pytest.mark.parametrize("predictor", ["none", "left", "median"])
def test_fill_planes_equal_cv2(tmp_path, fourcc, predictor, monkeypatch):
    """A plane of one residual is stored as a fill symbol (length 0 at it,
    no slice data): a plane of 0x80 under any predictor, and under none a
    plane of any one value, beside coded planes."""
    h, w = 8, 12
    pics = pictures(fourcc, h, w, seed=5)
    for k, pic in enumerate(pics):
        if fourcc == "ULRG":    # G constant: B and R still vary
            pic[..., 1] = 0x80 if predictor != "none" or k else 77
        else:
            pic[0][:] = 0x80 if predictor != "none" or k else 77
            pic[2][:] = 0x80
    path = tmp_path / "fill 5ms.avi"
    chunks = uw.write_utvideo_avi(path, pics, h, w, fourcc, predictor, 2)
    assert any(c[:256].count(0) == 1 for c in chunks)
    _check(path, monkeypatch, written=_want(fourcc, pics, h, w)
           if fourcc == "ULRG" else None)


def _long_lengths() -> np.ndarray:
    """A table of every symbol with codes up to 32 bits long (not full):
    111 codes of 8 bits, one each of 9 to 24 bits, 127 of 31 and 2 of 32
    (each length's codes fill whole codes of the next shorter length, as
    FFmpeg's table builder asks)."""
    lengths = np.zeros(256, np.uint8)
    lengths[:111] = 8
    lengths[111:127] = np.arange(9, 25)
    lengths[127:254] = 31
    lengths[254:] = 32
    return lengths


@pytest.mark.parametrize("fourcc,predictor", [("ULRG", "none"),
                                              ("ULY2", "left"),
                                              ("ULRA", "median")])
def test_long_codes_equal_cv2(tmp_path, fourcc, predictor, monkeypatch):
    """Codes past the decoders' 12-bit first lookup, past 24 bits and of
    32 bits, on noise that uses every symbol."""
    h, w = 10, 16
    rng = np.random.default_rng(12)
    layout = up.LAYOUTS[fourcc]
    if layout.startswith("gbr"):
        pics = [rng.integers(0, 256, (h, w, 3 + (layout == "gbrap")),
                             dtype=np.uint8) for _ in range(2)]
    else:
        pics = [[rng.integers(0, 256, s, dtype=np.uint8)
                 for s in up.plane_shapes(layout, h, w)] for _ in range(2)]
    lengths = [_long_lengths()] * (4 if layout == "gbrap" else 3)
    path = tmp_path / "long 5ms.avi"
    uw.write_utvideo_avi(path, pics, h, w, fourcc, predictor, 2,
                         lengths=lengths)
    _check(path, monkeypatch, written=_want(fourcc, pics, h, w)
           if layout.startswith("gbr") else None)


def _cv2_clip(path, h: int, w: int, n: int = 3, seed: int = 3):
    writer = cv2.VideoWriter(str(path), cv2.CAP_FFMPEG,
                             cv2.VideoWriter_fourcc(*"ULY0"), 10, (w, h))
    assert writer.isOpened()
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:h, :w]
    for _ in range(n):
        writer.write(((np.stack([xx * 3 + yy, xx * 5, yy * 7], -1)
                       + rng.integers(0, 30, (h, w, 3))) % 256
                      ).astype(np.uint8))
    writer.release()


@pytest.mark.parametrize("size", [(48, 64), (480, 40)],
                         ids=["48x64 1 slice", "480x40 2 slices"])
def test_writer_gives_cv2s_chunks(tmp_path, size):
    """cv2's writer writes ULY0 (yuv420p, the left predictor, one slice a
    120 chroma rows); the writer at those settings gives its extradata and
    every frame chunk byte for byte from the planes they hold."""
    h, w = size
    path = tmp_path / "cv2 5ms.avi"
    _cv2_clip(path, h, w)
    chunks, info = _chunks(path)
    assert info.codec == "ULY0" and len(chunks) == 3
    slices = uw.cv2_slices("yuv420p", h)
    assert info.extra[:16] == uw.extradata("yuv420p", slices)
    params = avi.utvideo_params(info)
    assert params.slices == slices == (1 if h < 480 else 2)
    for c in chunks:
        planes, predictor = up.decode_planes(c, params, h, w)
        assert predictor == up.LEFT
        assert uw.encode_frame(planes, params, predictor) == c


@pytest.mark.parametrize("fourcc", ["ULY0", "ULRG", "ULY4"])
@pytest.mark.parametrize("size", [(48, 64), (482, 38)],
                         ids=["48x64", "482x38"])
def test_cv2_written_clips_equal_cv2(tmp_path, fourcc, size, monkeypatch):
    """What cv2's own writer makes for a Ut Video fourcc (always ULY0)."""
    h, w = size
    path = tmp_path / "cv2 5ms.avi"
    writer = cv2.VideoWriter(str(path), cv2.CAP_FFMPEG,
                             cv2.VideoWriter_fourcc(*fourcc), 10, (w, h))
    rng = np.random.default_rng(h)
    for _ in range(2):
        writer.write(rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
    writer.release()
    assert avi.probe_avi(path) == ("ULY0", h, w, 3, None)
    _check(path, monkeypatch)


def _edge_planes(layout: str):
    """Planes that hold every (Y, U, V) of 18 values at the range edges
    and in between (U and V at the chroma size, Y repeated over each
    chroma sample's pixels)."""
    vals = np.array([0, 1, 2, 15, 16, 17, 64, 127, 128, 129, 200, 235, 236,
                     240, 250, 253, 254, 255])
    y, u, v = (a.reshape(-1) for a in np.meshgrid(vals, vals, vals,
                                                  indexing="ij"))
    cw = 54
    ch = -(-y.size // cw)
    pad = lambda a: np.resize(a, ch * cw).reshape(ch, cw).astype(np.uint8)
    y, u, v = pad(y), pad(u), pad(v)
    if layout == "yuv420p":
        y = np.repeat(np.repeat(y, 2, 0), 2, 1)
    elif layout == "yuv422p":
        y = np.repeat(y, 2, 1)
    return [y, u, v]


@pytest.mark.parametrize("fourcc", ["ULY4", "ULH4", "ULH0", "ULH2", "ULY2"])
def test_range_edges_equal_cv2(tmp_path, fourcc, monkeypatch):
    """The yuv444p route (swscale's full-chroma output, whose 32-bit sums
    wrap: a saturated blue comes out 0) and the BT.709 matrix of the
    ``ULH*`` fourccs on every combination of values at the range edges,
    through the rawvideo converter and the UtVideo decoder."""
    layout = up.LAYOUTS[fourcc]
    planes = _edge_planes(layout)
    h, w = planes[0].shape
    path = tmp_path / "edges 5ms.avi"
    uw.write_utvideo_avi(path, [planes], h, w, fourcc, "none", 1)
    want = cv2_frames(path)
    p = uw.stream_params(fourcc, 1)
    raw = b"".join(c.tobytes() for c in planes)
    np.testing.assert_array_equal(rawvideo_plain.decode_bgr(
        raw, up.yuv_layout(p), h, w, matrix=up.matrix(p)), want[0])
    dst = np.empty((1, h, w, 3), np.uint8)
    native.raw_decode_bgr_batch([raw], dst, up.yuv_layout(p),
                                matrix=up.matrix(p))
    np.testing.assert_array_equal(dst, want)
    _check(path, monkeypatch, want=want)


@pytest.mark.parametrize("size", [(1, 1), (7, 9), (13, 30), (2, 5)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("fourcc", ["ULY4", "ULH4"])
def test_yuv444p_route_equals_cv2(tmp_path, fourcc, size, monkeypatch):
    """``ULY4``/``ULH4`` frames of random planes at odd and tiny sizes: the
    rawvideo converter's new ``yuv444p`` layout equals cv2."""
    h, w = size
    rng = np.random.default_rng(h * w)
    pics = [[rng.integers(0, 256, (h, w), dtype=np.uint8) for _ in range(3)]
            for _ in range(2)]
    path = tmp_path / "yuv444p 5ms.avi"
    uw.write_utvideo_avi(path, pics, h, w, fourcc, "left", 1)
    want = cv2_frames(path)
    np.testing.assert_array_equal(_want(fourcc, pics, h, w), want)
    _check(path, monkeypatch, want=want)


def test_unread_header_bits_read_as_cv2(tmp_path, monkeypatch):
    """What FFmpeg does not read, cv2 and the port ignore alike: the
    Huffman flag cleared, extradata past 16 bytes, other flag bits, other
    bits of the frame information and bytes after it."""
    h, w = 8, 12
    pics = pictures("ULRG", h, w, seed=6)
    p = uw.stream_params("ULRG", 2)
    chunks = [uw.encode_frame(uw.to_planes(f, "gbrp"), p, up.MEDIAN)
              for f in pics]
    chunks[1] = chunks[1][:-4] + struct.pack("<I", 0xFFFF037F) + b"\1\2\3"
    extra = bytearray(uw.extradata("gbrp", 2, compression=False))
    extra[13] |= 0x10
    path = tmp_path / "flags 5ms.avi"
    uw.write_chunks_avi(path, chunks, "ULRG", h, w, bytes(extra) + b"\7" * 6)
    assert len(avi.probe_avi(path).extra) == 22
    _check(path, monkeypatch, written=np.stack(pics))


def test_video_as_stream_one_behind_audio(tmp_path, monkeypatch):
    h, w = 6, 8
    pics = pictures("ULRG", h, w, n=3, seed=2)
    path = tmp_path / "s1 5ms.avi"
    uw.write_utvideo_avi(path, pics, h, w, "ULRG", "median", 2, stream=1,
                         others=[pcm_stream([3, 0, 9])])
    assert avi.probe_avi(path).stream == 1
    _check(path, monkeypatch, written=np.stack(pics))


NATIVE_GEOMETRIES = [(1, 2), (2, 2), (4, 6), (9, 13), (16, 34), (31, 40)]


@pytest.mark.parametrize("fourcc", FOURCCS)
def test_native_equals_plain(fourcc):
    """Every predictor, several sizes and slice counts, interlaced or not,
    one thread and several: the native decoder equals the plain version
    bit for bit."""
    rng = np.random.default_rng(len(fourcc) + ord(fourcc[-1]))
    layout = up.LAYOUTS[fourcc]
    cases = 0
    for h, w in NATIVE_GEOMETRIES:
        for slices in (1, 2, 5):
            for interlaced in (False, True):
                p = uw.stream_params(fourcc, slices, interlaced)
                if not _valid(fourcc, h, w, slices, interlaced):
                    continue
                for predictor in range(4):
                    pics = [uw.to_planes(pic, layout) for pic in pictures(
                        fourcc, h, w, 3, seed=int(rng.integers(1 << 30)))]
                    chunks = [uw.encode_frame(pl, p, predictor)
                              for pl in pics]
                    plain = np.stack([up.decode_bgr(c, p, h, w)
                                      for c in chunks])
                    for threads in (1, 3):
                        dst = np.empty((3, h, w, 3), np.uint8)
                        native.utvideo_decode_bgr_batch(chunks, dst, p,
                                                        threads=threads)
                        np.testing.assert_array_equal(
                            dst, plain, err_msg=str((h, w, slices, interlaced,
                                                     predictor, threads)))
                    cases += 1
    assert cases >= 30


# --- refusals and errors ---------------------------------------------------

# name: (fourcc, height, width, extradata, what the refusal names)
REFUSED = {
    "UQY0": ("UQY0", 8, 12, uw.extradata("yuv420p", 1), "Pro.*UQY0"),
    "UQRA": ("UQRA", 8, 12, uw.extradata("gbrap", 1), "Pro.*UQRA"),
    "UMY2": ("UMY2", 8, 12, uw.extradata("yuv422p", 1), "pack mode.*UMY2"),
    "UMRG": ("UMRG", 8, 12, uw.extradata("gbrp", 1), "pack mode.*UMRG"),
    "short extradata": ("ULRG", 8, 12, uw.extradata("gbrp", 1)[:12],
                        "extradata of 12 bytes"),
    "frame information of 8 bytes": ("ULRG", 8, 12,
                                     uw.extradata("gbrp", 1, info_size=8),
                                     "frame-information size of 8"),
    "ULY0 odd width": ("ULY0", 8, 11, uw.extradata("yuv420p", 1),
                       "odd dimensions"),
    "ULY0 odd height": ("ULY0", 7, 12, uw.extradata("yuv420p", 1),
                        "odd dimensions"),
    "ULH2 odd width": ("ULH2", 7, 11, uw.extradata("yuv422p", 1),
                       "odd dimensions"),
    "interlaced ULY0 of 6 rows": ("ULY0", 6, 12, uw.extradata(
        "yuv420p", 1, True), "last rows undecoded"),
    "interlaced ULRG of 7 rows": ("ULRG", 7, 12, uw.extradata(
        "gbrp", 1, True), "last rows undecoded"),
    "interlaced ULY2 of width 2": ("ULY2", 8, 2, uw.extradata(
        "yuv422p", 1, True), "one sample wide"),
}


@pytest.mark.parametrize("case", list(REFUSED))
def test_refused_layouts_raise_before_decode(tmp_path, case, monkeypatch):
    """A stream the decoder does not read raises a ValueError naming it
    before any frame is decoded, and never reaches cv2."""
    fourcc, h, w, extra, why = REFUSED[case]
    path = tmp_path / "refused 5ms.avi"
    uw.write_chunks_avi(path, [b"\x80" * 64] * 2, fourcc, h, w, extra)

    def no_decode(*args, **kwargs):
        raise AssertionError("a frame was decoded or cv2 was reached")
    monkeypatch.setattr(native, "utvideo_decode_bgr_batch", no_decode)
    monkeypatch.setattr(tvideo, "_cv2", no_decode)
    assert avi.probe_avi(path)[:3] == (fourcc, h, w)
    with pytest.raises(ValueError, match=why):
        tvideo._resolve_decoder("native", [path], h, w, 3)
    with pytest.raises(ValueError, match=why):
        tvideo.welford_algorithm(path, use_std=True)


def _damaged(case: str):
    """A ULRG stream of 3 frames whose frame 1 is damaged as ``case``
    says, and the plane and slice the damage is in."""
    h, w = 6, 8
    pics = pictures("ULRG", h, w, n=3, seed=9)
    p = uw.stream_params("ULRG", 2)
    chunks = [uw.encode_frame(uw.to_planes(f, "gbrp"), p, up.LEFT)
              for f in pics]
    c = bytearray(chunks[1])
    plane1 = 256 + 8 + struct.unpack_from("<I", c, 260)[0]   # plane 1's start
    if case == "cut":
        c = c[:plane1 + 264 + 10]
        where, why = "plane 1, slice 0", "runs past the chunk"
    elif case == "code in no table":
        # plane 1 coded with a table of 3 codes of 2 bits (00, 01, 10): 11
        # is in no table
        table = np.full(256, 255, np.uint8)
        table[0x80:0x83] = 2
        body = b"\xff\xff\xff\xff"
        c = c[:plane1] + table.tobytes() + struct.pack("<II", 4, 8) + \
            body * 2 + c[plane1 + 256 + 8 + struct.unpack_from(
                "<I", c, plane1 + 260)[0]:]
        where, why = "plane 1, slice 0", "no code|in no table"
    elif case == "codes past the slice":
        # plane 0's slice 0 said to end 4 bytes early: its codes run on
        end0 = struct.unpack_from("<I", c, 256)[0]
        struct.pack_into("<I", c, 256, end0 - 4)
        where, why = "plane 0, slice 0", "past the slice"
    elif case == "empty slice":
        struct.pack_into("<I", c, 256, 0)
        where, why = "plane 0, slice 0", "empty slice"
    else:  # a code length FFmpeg refuses
        c[plane1 + 3] = 40
        where, why = "plane 1", "code length|lengths FFmpeg"
    chunks[1] = bytes(c)
    return chunks, p, (h, w), where, why


@pytest.mark.parametrize("case", ["cut", "code in no table",
                                  "codes past the slice", "empty slice",
                                  "length 40"])
def test_a_damaged_frame_raises_naming_it(tmp_path, case, monkeypatch):
    """Damage FFmpeg fails on raises in the plain and the native decoder
    and in the frame generator, naming the frame, the plane and the
    slice."""
    chunks, p, (h, w), where, why = _damaged(case)
    with pytest.raises(ValueError, match=why):
        up.decode_bgr(chunks[1], p, h, w)
    np.testing.assert_array_equal(up.decode_bgr(chunks[0], p, h, w),
                                  pictures("ULRG", h, w, n=3, seed=9)[0])
    dst = np.empty((3, h, w, 3), np.uint8)
    with pytest.raises(ValueError, match=f"frame 8: {where}: .*({why})"):
        native.utvideo_decode_bgr_batch(chunks, dst, p, first_frame=7)
    path = tmp_path / "damaged 5ms.avi"
    uw.write_chunks_avi(path, chunks, "ULRG", h, w, uw.extradata("gbrp", 2))
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ValueError, match=f"frame 1: {where}"):
        list(tvideo.video_frame_generator(path, decoder="native"))


def test_a_failed_build_raises_and_never_reaches_cv2(tmp_path, monkeypatch):
    path = tmp_path / "ulrg 5ms.avi"
    uw.write_utvideo_avi(path, pictures("ULRG", 6, 8), 6, 8, "ULRG")
    monkeypatch.setitem(native._decoder_libs, "_utvideo", None)
    monkeypatch.setitem(native._build_errors, "_utvideo",
                        "g++: simulated failure")

    def no_cv2(why):
        raise AssertionError(f"cv2 was reached: {why}")
    monkeypatch.setattr(tvideo, "_cv2", no_cv2)
    with pytest.raises(RuntimeError, match="utvideo.cpp.*simulated failure"):
        tvideo.welford_algorithm(path, use_std=True)


@pytest.mark.parametrize("fourcc", ["ULRG", "ULRA", "ULY0", "ULH4"])
def test_only_yuv_streams_need_the_mjpeg_build(tmp_path, fourcc,
                                               monkeypatch):
    """The YUV layouts convert their planes through ``jpeg.cpp``, so a
    failed build of it raises for them (RuntimeError, before any decode,
    never reaching cv2); an RGB stream decodes without it."""
    h, w = 6, 8
    path = tmp_path / "ut 5ms.avi"
    uw.write_utvideo_avi(path, pictures(fourcc, h, w), h, w, fourcc)
    want = cv2_frames(path)
    monkeypatch.setattr(native, "_load_mjpeg", lambda: None)
    monkeypatch.setitem(native._build_errors, "_mjpeg",
                        "g++: simulated failure")
    monkeypatch.setitem(sys.modules, "cv2", None)
    monkeypatch.setattr(tvideo, "_cv2", lambda why: pytest.fail(why))
    if not fourcc.startswith("ULR"):
        with pytest.raises(RuntimeError, match="jpeg.cpp.*simulated"):
            tvideo._resolve_decoder("native", [path], h, w, 3)
        return
    assert tvideo._resolve_decoder("native", [path], h, w, 3) == ["utvideo"]
    np.testing.assert_array_equal(_port_frames(path), want)


# --- statistics against the JAX package ------------------------------------

@pytest.mark.parametrize("fourcc", ["ULRG", "ULY0"])
def test_welford_and_process_video_equal_jax(tmp_path, fourcc, monkeypatch):
    """With cv2 blocked, the port's ``welford_algorithm`` (host and
    device backends) and ``process_video`` equal the JAX package's
    defaults, which decode with cv2 (rtol 1e-10)."""
    monkeypatch.delenv("CL_DECODER", raising=False)
    h, w = 14, 24
    pics = pictures(fourcc, h, w, n=9, seed=1, lo=40, hi=200)
    clips = {}
    for who in ("port", "jax"):
        (tmp_path / who).mkdir()
        clips[who] = tmp_path / who / "scene 5ms.avi"
        uw.write_utvideo_avi(clips[who], pics, h, w, fourcc, "median", 2)
    want = jvideo.welford_algorithm(clips["jax"], use_std=True)
    jvideo.process_video(clips["jax"])
    with monkeypatch.context() as m:
        m.setitem(sys.modules, "cv2", None)
        obs.reset_stage_times()
        got = tvideo.welford_algorithm(clips["port"], use_std=True)
        assert obs.decoded_frames.snapshot() == {"utvideo": 9}
        dev = tvideo.welford_algorithm(clips["port"], use_std=True,
                                       backend="device", batch_size=4,
                                       device="cpu")
        tvideo.process_video(clips["port"])
    for key in ("mean", "std"):
        np.testing.assert_allclose(got[key], want[key], **STATS)
        np.testing.assert_allclose(dev[key], want[key], rtol=1e-9,
                                   atol=1e-15)
        files = [cv2.imread(str(clips[who].with_name(
            f"scene 5ms.{key}.tif")), cv2.IMREAD_UNCHANGED)
            for who in ("port", "jax")]
        assert files[1] is not None and files[1].dtype == np.float64
        np.testing.assert_allclose(files[0], files[1], **STATS)


@pytest.mark.parametrize("fourcc", ["ULRG", "ULY0"])
def test_batch_video_to_hdr_equals_jax(tmp_path, fourcc, monkeypatch):
    """The slice as a whole: Ut Video scenes through the port's pipeline,
    cv2 blocked, against the JAX package's, which reads them with cv2."""
    monkeypatch.delenv("CL_DECODER", raising=False)
    h, w = 16, 24
    icrf = np.linspace(0, 1, 256)[:, None].repeat(3, 1) ** \
        np.array([2.0, 2.2, 2.4])
    scenes = {}
    for s, name in enumerate(("a", "b")):
        paths = []
        for k, ms in enumerate((4, 8, 16)):
            (tmp_path / name).mkdir(exist_ok=True)
            path = tmp_path / name / f"{name} {ms}ms.avi"
            uw.write_utvideo_avi(path, pictures(fourcc, h, w, n=5,
                                                seed=10 * s + k, lo=40,
                                                hi=200), h, w, fourcc)
            paths.append(path)
        scenes[name] = paths
    want = jpipe.batch_video_to_hdr(scenes, jnp.asarray(icrf))
    monkeypatch.setitem(sys.modules, "cv2", None)
    obs.reset_stage_times()
    got = tpipe.batch_video_to_hdr(scenes, icrf, device="cpu")
    assert obs.decoded_frames.snapshot() == {"utvideo": 2 * 3 * 5}
    for name in scenes:
        np.testing.assert_allclose(
            got[name].measurand.val.numpy(),
            np.asarray(want[name].measurand.val), rtol=1e-10, atol=1e-14)
        np.testing.assert_allclose(
            got[name].measurand.std.numpy(),
            np.asarray(want[name].measurand.std), rtol=1e-9, atol=1e-14)
