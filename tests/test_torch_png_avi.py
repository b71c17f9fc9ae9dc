"""The port's PNG-in-AVI decoder (``native/png.cpp`` and its plain version
``native/png_plain.py``) against ``cv2.VideoCapture`` and the JAX
package, on the CPU.

Clips are written by ``tests/_torch_png_writer.py`` from
``numpy.random.default_rng(seed)`` under the ``MPNG``, ``PNG1`` and
``png `` fourccs (ImageJ/Fiji's "Save As AVI, PNG" and
``cv2.VideoWriter(fourcc "MPNG")``), and by cv2's own writer.
Tolerances:

* every frame of the plain version, of ``native.png_decode_bgr_batch``
  and of the port's ``video_frame_generator`` (cv2 blocked) equals cv2's
  bit for bit, for every colour type and bit depth the decoder reads, all
  five filters alone and mixed, several ``IDAT`` chunks, ancillary
  chunks, ``tRNS`` and odd sizes;
* an Adam7 frame equals the same image written without interlace: cv2
  5.0 gives memory it never wrote there (swscale refuses FFmpeg's
  interlaced frame), so cv2 is not asked;
* ``welford_algorithm``, ``process_video`` and ``batch_video_to_hdr`` of
  the port, cv2 blocked, equal the JAX package's defaults (cv2) at rtol
  1e-10 (the device backend's and the pipeline's std at 1e-9, as
  ``tests/test_torch_rawvideo.py`` holds them).
"""
from __future__ import annotations

import struct
import sys
import zlib

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
from camera_linearity_tpu_torch.native import png_plain  # noqa: E402
from camera_linearity_tpu_torch.utils import avi  # noqa: E402
from camera_linearity_tpu_torch.utils import observability as obs  # noqa
from tests._torch_png_writer import (CHANNELS, chunk,  # noqa: E402
                                     encode_png, write_png_avi)
from tests._torch_rawvideo_writer import pcm_stream  # noqa: E402
from tests.test_torch_native import cv2_frames  # noqa: E402

STATS = dict(rtol=1e-10, atol=1e-15)

# layout: (colour type, bit depth, palette entries, tRNS)
LAYOUTS = {
    "gray1": (0, 1, 0, False), "gray2": (0, 2, 0, False),
    "gray4": (0, 4, 0, False), "gray8": (0, 8, 0, False),
    "gray16": (0, 16, 0, False), "gray8 tRNS": (0, 8, 0, True),
    "gray16 tRNS": (0, 16, 0, True), "rgb8": (2, 8, 0, False),
    "rgb8 tRNS": (2, 8, 0, True), "gray+alpha8": (4, 8, 0, False),
    "gray+alpha16": (4, 16, 0, False), "rgba8": (6, 8, 0, False),
    "rgb16": (2, 16, 0, False), "rgb16 tRNS": (2, 16, 0, True),
    "rgba16": (6, 16, 0, False),
    "palette1": (3, 1, 2, False), "palette2": (3, 2, 3, True),
    "palette4": (3, 4, 16, False), "palette4 tRNS": (3, 4, 11, True),
    "palette8": (3, 8, 256, False), "palette8 tRNS": (3, 8, 200, True),
}
SIZES = [(6, 8), (7, 13), (1, 1), (10, 5)]


def _image(layout: str, rng, h: int, w: int):
    """(image, palette, tRNS) of ``layout`` as ``encode_png`` takes them."""
    ctype, depth, entries, trns = LAYOUTS[layout]
    if ctype == 3:
        palette = rng.integers(0, 256, (entries, 3), dtype=np.uint8)
        t = rng.integers(0, 256, entries // 2 + 1, dtype=np.uint8) \
            if trns else None
        return rng.integers(0, entries, (h, w)), palette, t
    ch = CHANNELS[ctype]
    img = rng.integers(0, 1 << depth, (h, w, ch) if ch > 1 else (h, w))
    t = None
    if trns:   # the first pixel's colour is the transparent one
        first = np.atleast_1d(img[0, 0])
        t = np.frombuffer(struct.pack(f">{len(first)}H", *map(int, first)),
                          np.uint8)
    return img, None, t


def write_clip(path, layout: str, h: int, w: int, n: int = 3, seed: int = 0,
               fourcc: str = "MPNG", images=None, **kw):
    """A PNG AVI of ``layout``; returns its chunks."""
    rng = np.random.default_rng(seed)
    if images is None:
        images = [_image(layout, rng, h, w) for _ in range(n)]
    ctype, depth = LAYOUTS[layout][:2]
    chunks = [encode_png(img, ctype, depth, palette=pal, trns=t, **kw)
              for img, pal, t in images]
    write_png_avi(path, chunks, h, w, fourcc)
    return chunks


def _native(chunks, h, w, threads=None):
    assert native.png_available(), native.build_error("_png")
    dst = np.empty((len(chunks), h, w, 3), np.uint8)
    assert native.png_decode_bgr_batch(chunks, dst, threads=threads) == \
        len(chunks)
    return dst


def _plain(chunks):
    return np.stack([png_plain.decode_bgr(c) for c in chunks])


def _port_frames(path):
    frames = list(tvideo.video_frame_generator(path, decoder="native"))
    assert frames[-1] is None
    return np.stack(frames[:-1])


# --- frames ----------------------------------------------------------------

@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_frames_equal_cv2(tmp_path, layout, size, monkeypatch):
    """The plain version, the native decoder and the port's frame
    generator (cv2 blocked) give cv2's frames bit for bit: mixed filters,
    the data over three IDAT chunks, ancillary chunks before it."""
    h, w = size
    path = tmp_path / "clip 5ms.avi"
    chunks = write_clip(path, layout, h, w, seed=h * w, idat_chunks=3,
                        ancillary=True)
    want = cv2_frames(path)
    assert want.shape == (3, h, w, 3)
    np.testing.assert_array_equal(_plain(chunks), want)
    np.testing.assert_array_equal(_native(chunks, h, w), want)
    monkeypatch.setitem(sys.modules, "cv2", None)
    assert tvideo._resolve_decoder("native", [path], h, w, 3) == ["png"]
    np.testing.assert_array_equal(_port_frames(path), want)


@pytest.mark.parametrize("filters", [0, 1, 2, 3, 4, (4, 3, 1, 0, 2)],
                         ids=lambda f: f"filter {f}")
@pytest.mark.parametrize("fourcc", ["MPNG", "PNG1", "png "])
def test_each_filter_and_fourcc_equal_cv2(tmp_path, filters, fourcc):
    """Each row filter alone and in another mix, under each fourcc FFmpeg
    reads as PNG, at 8 and 16 bits a sample."""
    for layout in ("rgba8", "gray16"):
        path = tmp_path / f"{layout} 5ms.avi"
        chunks = write_clip(path, layout, 9, 11, seed=len(fourcc),
                            fourcc=fourcc, filters=filters)
        want = cv2_frames(path)
        np.testing.assert_array_equal(_plain(chunks), want)
        np.testing.assert_array_equal(_native(chunks, 9, 11, threads=1),
                                      want)


@pytest.mark.parametrize("size", [(1, 1), (2, 2), (3, 5), (8, 8), (9, 17),
                                  (16, 3)], ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("layout", ["gray1", "gray4", "gray16", "rgb8",
                                    "gray+alpha16", "rgba8", "palette2",
                                    "palette8", "rgb16", "rgba16"])
def test_adam7_equals_the_image(tmp_path, layout, size):
    """Adam7, passes empty at the small sizes: plain and native give the
    image the file holds, the frame the same image gives without
    interlace (cv2 gives memory it never wrote there)."""
    h, w = size
    rng = np.random.default_rng(h * w)
    images = [_image(layout, rng, h, w) for _ in range(2)]
    ctype, depth = LAYOUTS[layout][:2]
    flat = [encode_png(i, ctype, depth, palette=p, trns=t)
            for i, p, t in images]
    laced = [encode_png(i, ctype, depth, palette=p, trns=t, interlace=True)
             for i, p, t in images]
    want = _plain(flat)
    np.testing.assert_array_equal(_plain(laced), want)
    np.testing.assert_array_equal(_native(laced, h, w), want)
    path = tmp_path / "laced 5ms.avi"
    write_png_avi(path, laced, h, w)
    np.testing.assert_array_equal(_port_frames(path), want)


@pytest.mark.parametrize("fourcc", ["MPNG", "png ", "PNG1"])
@pytest.mark.parametrize("colour", [True, False], ids=["colour", "gray"])
def test_cv2_written_clips_equal_cv2(tmp_path, fourcc, colour, monkeypatch):
    """What cv2's own writer makes (gray ``MPNG`` states 40 bits a pixel:
    the geometry and channels come from the frames' IHDR)."""
    h, w = 12, 18
    path = tmp_path / "cv2 5ms.avi"
    writer = cv2.VideoWriter(str(path), cv2.CAP_FFMPEG,
                             cv2.VideoWriter_fourcc(*fourcc), 10, (w, h),
                             colour)
    assert writer.isOpened()
    rng = np.random.default_rng(3)
    for _ in range(3):
        frame = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        writer.write(frame if colour else frame[..., 0])
    writer.release()
    want = cv2_frames(path)
    info = avi.probe_avi(path)
    assert info == (fourcc.strip(), h, w, 3, None)
    assert info.bit_count == (24 if colour else 40)
    assert info.png.color_type == (2 if colour else 0)
    chunks = [bytes(c) for c in avi.frame_chunks(path, info)]
    np.testing.assert_array_equal(_plain(chunks), want)
    np.testing.assert_array_equal(_native(chunks, h, w), want)
    monkeypatch.setitem(sys.modules, "cv2", None)
    np.testing.assert_array_equal(_port_frames(path), want)


@pytest.mark.parametrize("ramp", ["R", "G", "B", "gray"])
@pytest.mark.parametrize("layout", ["rgb16", "rgba16"])
def test_16bit_rgb_takes_every_value_as_cv2(tmp_path, layout, ramp):
    """RGB and RGBA at 16 bits go through swscale's YUV conversion: every
    one of the 65536 values of one channel alone (the others 0), or of
    all three at once, gives cv2's bytes."""
    v = np.arange(65536).reshape(256, 256)
    zero = np.zeros_like(v)
    rgb = {"R": (v, zero, zero), "G": (zero, v, zero), "B": (zero, zero, v),
           "gray": (v, v, v)}[ramp]
    ctype = LAYOUTS[layout][0]
    img = np.stack(rgb + ((65535 - v,) if ctype == 6 else ()), -1)
    chunks = [encode_png(img, ctype, 16)]
    path = tmp_path / "ramp 5ms.avi"
    write_png_avi(path, chunks, 256, 256)
    want = cv2_frames(path)
    np.testing.assert_array_equal(_plain(chunks), want)
    np.testing.assert_array_equal(_native(chunks, 256, 256), want)


def test_video_as_stream_one_behind_audio(tmp_path, monkeypatch):
    """The video need not be stream 0: its ``01dc`` chunks are read, the
    audio's skipped."""
    h, w = 7, 9
    rng = np.random.default_rng(5)
    images = [_image("rgb8", rng, h, w) for _ in range(3)]
    chunks = [encode_png(i, 2, 8) for i, _, _ in images]
    path = tmp_path / "s1 5ms.avi"
    write_png_avi(path, chunks, h, w, stream=1,
                  others=[pcm_stream([5, 0, 7])])
    want = cv2_frames(path)
    assert avi.probe_avi(path).stream == 1
    monkeypatch.setitem(sys.modules, "cv2", None)
    np.testing.assert_array_equal(_port_frames(path), want)


def test_native_equals_plain_on_many_frames():
    """Every layout, each size, Adam7 or not, one thread and several: the
    native decoder equals the plain version bit for bit."""
    rng = np.random.default_rng(11)
    for layout in LAYOUTS:
        ctype, depth = LAYOUTS[layout][:2]
        for h, w in ((1, 3), (5, 2), (17, 9), (24, 33)):
            for interlace in (False, True):
                chunks = [encode_png(i, ctype, depth, palette=p, trns=t,
                                     interlace=interlace)
                          for i, p, t in (_image(layout, rng, h, w)
                                          for _ in range(4))]
                for threads in (1, 3):
                    np.testing.assert_array_equal(
                        _native(chunks, h, w, threads), _plain(chunks),
                        err_msg=str((layout, h, w, interlace, threads)))


# --- refusals and errors ---------------------------------------------------

def _no_decode(monkeypatch):
    def no_decode(*args, **kwargs):
        raise AssertionError("a frame was decoded or cv2 was reached")
    monkeypatch.setattr(native, "png_decode_bgr_batch", no_decode)
    monkeypatch.setattr(tvideo, "_cv2", no_decode)


def _with_ihdr(data: bytes, depth: int, ctype: int) -> bytes:
    """A PNG with its IHDR's bit depth and colour type replaced."""
    body = data[16:24] + bytes([depth, ctype]) + data[26:29]
    return data[:8] + chunk(b"IHDR", body) + data[33:]


@pytest.mark.parametrize("case", ["rgb 4-bit", "colour type 5",
                                  "first frame not a png"])
def test_refused_layouts_raise_before_decode(tmp_path, case, monkeypatch):
    """A first frame whose layout the decoder does not read (none of
    PNG's), or that is no PNG, raises a ValueError naming it before any
    frame is decoded, and never reaches cv2."""
    h, w = 6, 8
    rng = np.random.default_rng(0)
    first = encode_png(rng.integers(0, 256, (h, w, 3)), 2, 8)
    frames = {"rgb 4-bit": [_with_ihdr(first, 4, 2), first],
              "colour type 5": [_with_ihdr(first, 8, 5), first],
              "first frame not a png": [first[8:], first]}[case]
    why = {"rgb 4-bit": "colour type 2 at 4 bits",
           "colour type 5": "colour type 5 at 8 bits",
           "first frame not a png": "first frame is no PNG"}[case]
    path = tmp_path / f"{case} 5ms.avi"
    write_png_avi(path, frames, h, w)
    _no_decode(monkeypatch)
    with pytest.raises(ValueError, match=why):
        tvideo._resolve_decoder("native", [path], h, w, 3)
    with pytest.raises(ValueError, match=why):
        tvideo.welford_algorithm(path, use_std=True)


@pytest.mark.parametrize("case", ["ihdr differs", "not a png"])
def test_a_frame_unlike_the_first_raises_naming_it(tmp_path, case,
                                                   monkeypatch):
    """A later frame that is no PNG, or whose IHDR is not the first
    one's, raises a ValueError naming the frame when it is decoded; cv2
    is never reached."""
    h, w = 6, 8
    rng = np.random.default_rng(0)
    first = encode_png(rng.integers(0, 256, (h, w, 3)), 2, 8)
    other = {"ihdr differs": encode_png(rng.integers(0, 256, (h, w, 4)), 6,
                                        8),
             "not a png": first[8:]}[case]
    why = {"ihdr differs": r"its IHDR \(RGBA 8-bit, 6 x 8\) differs",
           "not a png": "no PNG signature"}[case]
    dst = np.empty((2, h, w, 3), np.uint8)
    with pytest.raises(ValueError, match=f"frame 1: {why}"):
        native.png_decode_bgr_batch([first, other], dst)
    path = tmp_path / f"{case} 5ms.avi"
    write_png_avi(path, [first, first, other], h, w)
    monkeypatch.setitem(sys.modules, "cv2", None)
    monkeypatch.setattr(tvideo, "_cv2", lambda why: pytest.fail(why))
    assert tvideo._resolve_decoder("native", [path], h, w, 3) == ["png"]
    with pytest.raises(ValueError, match=f"frame 2: {why}"):
        tvideo.welford_algorithm(path, use_std=True)


def _spoil(data: bytes, case: str) -> bytes:
    """A PNG with one fault FFmpeg conceals (or decodes regardless)."""
    if case == "crc":
        i = data.index(b"IDAT") + 4
        size = struct.unpack(">I", data[i - 8:i - 4])[0]
        return data[:i + size] + bytes([data[i + size] ^ 1]) + \
            data[i + size + 1:]
    i = data.index(b"IDAT")
    size = struct.unpack(">I", data[i - 4:i])[0]
    body = data[i + 4:i + 4 + size]
    raw = zlib.decompress(body)
    if case == "corrupt zlib":
        body = body[:2] + bytes(len(body) - 2)
    elif case == "short zlib":
        body = zlib.compress(raw[:len(raw) // 2])
    elif case == "filter 5":
        body = zlib.compress(bytes([5]) + raw[1:])
    return data[:i - 4] + chunk(b"IDAT", body) + data[i + 8 + size:]


@pytest.mark.parametrize("case", ["crc", "corrupt zlib", "short zlib",
                                  "filter 5", "index past PLTE"])
def test_concealed_errors_raise_naming_the_frame(tmp_path, case,
                                                 monkeypatch):
    """Where FFmpeg conceals an error (or skips the CRC check), the port
    raises, naming the frame: a wrong CRC, a corrupt or short zlib
    stream, a filter type past 4, a palette index past the PLTE
    entries."""
    h, w = 6, 8
    rng = np.random.default_rng(1)
    if case == "index past PLTE":
        idx = rng.integers(0, 4, (h, w))
        idx[2, 3] = 7
        bad = encode_png(idx, 3, 8, palette=rng.integers(0, 256, (4, 3)))
        good = encode_png(idx % 4, 3, 8, palette=rng.integers(0, 256, (4, 3)))
    else:
        good = encode_png(rng.integers(0, 256, (h, w, 3)), 2, 8, filters=0)
        bad = _spoil(good, case)
    why = {"crc": "wrong CRC", "corrupt zlib": "corrupt zlib",
           "short zlib": "zlib stream (holds|ends)",
           "filter 5": "filter type", "index past PLTE": "palette index"}[case]
    with pytest.raises(ValueError, match=why):
        png_plain.decode_bgr(bad)
    dst = np.empty((2, h, w, 3), np.uint8)
    with pytest.raises(ValueError, match=f"frame 4: .*{why}"):
        native.png_decode_bgr_batch([good, bad], dst, first_frame=3)
    path = tmp_path / f"{case} 5ms.avi"
    write_png_avi(path, [good, bad, good], h, w)
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ValueError, match=f"frame 1: .*{why}"):
        tvideo.welford_algorithm(path, use_std=True)


def test_a_failed_build_raises_and_never_reaches_cv2(tmp_path, monkeypatch):
    path = tmp_path / "png 5ms.avi"
    write_clip(path, "rgb8", 6, 8)
    monkeypatch.setitem(native._decoder_libs, "_png", None)
    monkeypatch.setitem(native._build_errors, "_png",
                        "g++: simulated failure")

    def no_cv2(why):
        raise AssertionError(f"cv2 was reached: {why}")
    monkeypatch.setattr(tvideo, "_cv2", no_cv2)
    with pytest.raises(RuntimeError, match="simulated failure"):
        tvideo.welford_algorithm(path, use_std=True)
    with pytest.raises(RuntimeError, match="simulated failure"):
        native.png_decode_bgr_batch([b""], np.empty((1, 6, 8, 3), np.uint8))


def test_probe_takes_the_first_frames_ihdr(tmp_path):
    """Geometry and channels from the first frame's IHDR, not the
    header's (which here states another size and 40 bits)."""
    path = tmp_path / "p 5ms.avi"
    chunks = [encode_png(np.zeros((5, 7), np.uint8), 0, 8)]
    write_png_avi(path, chunks, 50, 70, bit_count=40)
    info = avi.probe_avi(path)
    assert info == ("MPNG", 5, 7, 3, None)
    assert info.png == png_plain.PngInfo(5, 7, 8, 0, 0)
    assert avi.png_unsupported(info) is None


# --- statistics against the JAX package ------------------------------------

STAT_LAYOUTS = ["rgb8", "gray8", "palette8", "gray16", "rgba8"]


def _scene_images(layout, h, w, n, seed):
    """Frames of one exposure: a base level plus noise."""
    rng = np.random.default_rng(seed)
    ctype, depth = LAYOUTS[layout][:2]
    out = []
    for _ in range(n):
        img, pal, t = _image(layout, rng, h, w)
        if ctype != 3:
            top = (1 << depth) - 1
            img = np.clip(top // 4 + img // 2, 0, top)
        out.append((img, pal, t))
    return out


@pytest.mark.parametrize("layout", STAT_LAYOUTS)
def test_welford_and_process_video_equal_jax(tmp_path, layout, monkeypatch):
    """With cv2 blocked, the port's ``welford_algorithm`` (host and
    device backends) and ``process_video`` equal the JAX package's
    defaults, which decode with cv2 (rtol 1e-10)."""
    monkeypatch.delenv("CL_DECODER", raising=False)
    h, w = 14, 22
    images = _scene_images(layout, h, w, 9, 1)
    clips = {}
    for who in ("port", "jax"):
        (tmp_path / who).mkdir()
        clips[who] = tmp_path / who / "scene 5ms.avi"
        write_clip(clips[who], layout, h, w, images=images)
    want = jvideo.welford_algorithm(clips["jax"], use_std=True)
    jvideo.process_video(clips["jax"])
    with monkeypatch.context() as m:
        m.setitem(sys.modules, "cv2", None)
        obs.reset_stage_times()
        got = tvideo.welford_algorithm(clips["port"], use_std=True)
        assert obs.decoded_frames.snapshot() == {"png": 9}
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


def test_batch_video_to_hdr_from_png_equals_jax(tmp_path, monkeypatch):
    """The slice as a whole: PNG scenes through the port's pipeline, cv2
    blocked, against the JAX package's, which reads them with cv2."""
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
            write_clip(path, "rgb8", h, w,
                       images=_scene_images("rgb8", h, w, 5, 10 * s + k))
            paths.append(path)
        scenes[name] = paths
    want = jpipe.batch_video_to_hdr(scenes, jnp.asarray(icrf))
    monkeypatch.setitem(sys.modules, "cv2", None)
    obs.reset_stage_times()
    got = tpipe.batch_video_to_hdr(scenes, icrf, device="cpu")
    assert obs.decoded_frames.snapshot() == {"png": 2 * 3 * 5}
    for name in scenes:
        np.testing.assert_allclose(
            got[name].measurand.val.numpy(),
            np.asarray(want[name].measurand.val), rtol=1e-10, atol=1e-14)
        np.testing.assert_allclose(
            got[name].measurand.std.numpy(),
            np.asarray(want[name].measurand.std), rtol=1e-9, atol=1e-14)


def test_the_lossless_decoders_import_no_cv2_or_jax(tmp_path):
    """Decoding a PNG and a HuffYUV AVI through the frame generator, and
    with both plain versions, pulls in no JAX, cv2, PIL or matplotlib (the
    card's machine has none of them)."""
    from tests._torch_huffyuv_writer import write_huffyuv_avi
    from tests.test_torch_kernels import _run_python
    rng = np.random.default_rng(4)
    frames = [rng.integers(0, 256, (6, 8, 3), dtype=np.uint8)
              for _ in range(2)]
    png, hfyu = tmp_path / "p 5ms.avi", tmp_path / "h 5ms.avi"
    write_png_avi(png, [encode_png(f, 2, 8) for f in frames], 6, 8)
    write_huffyuv_avi(hfyu, frames, 6, 8, "rgb24", "gradient", True)
    out = _run_python(
        "import sys\n"
        "from camera_linearity_tpu_torch.models import video\n"
        "from camera_linearity_tpu_torch.native import (huffyuv_plain,\n"
        "                                               png_plain)\n"
        "from camera_linearity_tpu_torch.utils import avi\n"
        f"for p in ({str(png)!r}, {str(hfyu)!r}):\n"
        "    assert len(list(video.video_frame_generator(p))) == 3\n"
        f"chunk = next(avi.frame_chunks({str(png)!r},\n"
        f"                              avi.probe_avi({str(png)!r})))\n"
        "png_plain.decode_bgr(bytes(chunk))\n"
        f"info = avi.probe_avi({str(hfyu)!r})\n"
        f"chunk = next(avi.frame_chunks({str(hfyu)!r}, info))\n"
        "huffyuv_plain.decode_bgr(bytes(chunk), avi.huffyuv_params(info),\n"
        "                         6, 8)\n"
        "print(sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'cv2', 'PIL',\n"
        "                                    'camera_linearity_tpu',\n"
        "                                    'matplotlib')))\n")
    assert out.strip() == "[]"
