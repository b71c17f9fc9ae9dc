"""The port's HuffYUV decoder (``native/huffyuv.cpp`` and its plain version
``native/huffyuv_plain.py``) against ``cv2.VideoCapture`` and the JAX
package, on the CPU.

Clips are written by ``tests/_torch_huffyuv_writer.py`` from
``numpy.random.default_rng(seed)`` (``HFYU`` and ``FFVH``: RGB24, RGB32,
YUY2 and yuv420p; the left, gradient and median predictors; with and
without G-decorrelation; v2 headers with their tables and v1 headers on
FFmpeg's classic tables; the interlace flag set, cleared and left to its
default), and by cv2's own writer.  Tolerances:

* every frame of the plain version, of ``native.huffyuv_decode_bgr_batch``
  and of the port's ``video_frame_generator`` (cv2 blocked) equals cv2's
  bit for bit; RGB frames also equal the frames written;
* the rawvideo reader's ``Y42B`` (yuv422p, the route HuffYUV's YUY2
  frames take to BGR) equals cv2 bit for bit;
* ``welford_algorithm``, ``process_video`` and ``batch_video_to_hdr`` of
  the port, cv2 blocked, equal the JAX package's defaults (cv2) at rtol
  1e-10 (the device backend's and the pipeline's std at 1e-9).
"""
from __future__ import annotations

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
from camera_linearity_tpu_torch.native import huffyuv_plain  # noqa: E402
from camera_linearity_tpu_torch.native import rawvideo_plain  # noqa: E402
from camera_linearity_tpu_torch.utils import avi  # noqa: E402
from camera_linearity_tpu_torch.utils import observability as obs  # noqa
from tests._torch_huffyuv_writer import (encode_frame,  # noqa: E402
                                         make_stream, stream_params,
                                         to_planes, write_huffyuv_avi,
                                         write_stream_avi)
from tests._torch_rawvideo_writer import (pcm_stream,  # noqa: E402
                                          write_raw_avi)
from tests.test_torch_native import cv2_frames  # noqa: E402

STATS = dict(rtol=1e-10, atol=1e-15)

# name: (layout, predictor, decorrelate)
STREAMS = {
    "rgb24 left": ("rgb24", "left", False),
    "rgb24 left decorrelated": ("rgb24", "left", True),
    "rgb24 gradient": ("rgb24", "gradient", False),
    "rgb24 gradient decorrelated": ("rgb24", "gradient", True),
    "rgb32 left decorrelated": ("rgb32", "left", True),
    "rgb32 gradient": ("rgb32", "gradient", False),
    "yuy2 left": ("yuy2", "left", False),
    "yuy2 gradient": ("yuy2", "gradient", False),
    "yuy2 median": ("yuy2", "median", False),
    "yuv420p left": ("yuv420p", "left", False),
    "yuv420p gradient": ("yuv420p", "gradient", False),
    "yuv420p median": ("yuv420p", "median", False),
}
SIZES = [(6, 8), (7, 12), (12, 16), (9, 20)]


def _frames(rng, h: int, w: int, n: int, lo: int = 0, hi: int = 256):
    """Smooth content with noise (residuals of every size)."""
    yy, xx = np.mgrid[:h, :w]
    base = np.stack([(xx * 3 + yy * 5), xx * 7, yy * 11 + xx], -1)
    return [((base + rng.integers(0, 40, (h, w, 3))) % (hi - lo) + lo
             ).astype(np.uint8) for _ in range(n)]


def _pictures(layout: str, frames, rng):
    if layout == "rgb32":
        return [np.concatenate([f, rng.integers(0, 256, f.shape[:2] + (1,),
                                                dtype=np.uint8)], -1)
                for f in frames]
    if layout == "rgb24":
        return frames
    return [to_planes(f, layout) for f in frames]


def write_clip(path, name: str, h: int, w: int, n: int = 3, seed: int = 0,
               frames=None, **kw):
    """A HuffYUV AVI of stream ``name``; returns (chunks, frames)."""
    layout, predictor, decorrelate = STREAMS[name]
    rng = np.random.default_rng(seed)
    if frames is None:
        frames = _frames(rng, h, w, n)
    write_huffyuv_avi(path, _pictures(layout, frames, rng), h, w, layout,
                      predictor, decorrelate, **kw)
    info = avi.probe_avi(path)
    return [bytes(c) for c in avi.frame_chunks(path, info)], frames


def _native(chunks, info, threads=None):
    assert native.huffyuv_available(), native.build_error("_huffyuv")
    dst = np.empty((len(chunks), info.height, info.width, 3), np.uint8)
    assert native.huffyuv_decode_bgr_batch(
        chunks, dst, avi.huffyuv_params(info), threads=threads) == \
        len(chunks)
    return dst


def _plain(chunks, info):
    params = avi.huffyuv_params(info)
    return np.stack([huffyuv_plain.decode_bgr(c, params, info.height,
                                              info.width) for c in chunks])


def _port_frames(path):
    frames = list(tvideo.video_frame_generator(path, decoder="native"))
    assert frames[-1] is None
    return np.stack(frames[:-1])


def _check(path, chunks, frames, monkeypatch, rgb: bool):
    info = avi.probe_avi(path)
    want = cv2_frames(path)
    assert want.shape == (len(chunks), info.height, info.width, 3)
    if rgb:
        np.testing.assert_array_equal(want, np.stack(frames))
    np.testing.assert_array_equal(_plain(chunks, info), want)
    np.testing.assert_array_equal(_native(chunks, info), want)
    with monkeypatch.context() as m:
        m.setitem(sys.modules, "cv2", None)
        assert tvideo._resolve_decoder(
            "native", [path], info.height, info.width, 3) == ["huffyuv"]
        np.testing.assert_array_equal(_port_frames(path), want)


# --- frames ----------------------------------------------------------------

@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("name", list(STREAMS))
def test_frames_equal_cv2(tmp_path, name, size, monkeypatch):
    """The plain version, the native decoder and the port's frame
    generator (cv2 blocked) give cv2's frames bit for bit; v2 headers."""
    h, w = size   # YUY2 median needs a width that is a multiple of 4
    path = tmp_path / "clip 5ms.avi"
    chunks, frames = write_clip(path, name, h, w, seed=h * w)
    _check(path, chunks, frames, monkeypatch, name.startswith("rgb"))


@pytest.mark.parametrize("name", ["rgb24 left", "rgb24 left decorrelated",
                                  "rgb24 gradient decorrelated",
                                  "rgb32 left decorrelated", "yuy2 left",
                                  "yuy2 gradient", "yuy2 median"])
def test_v1_classic_tables_equal_cv2(tmp_path, name, monkeypatch):
    """v1 headers (no extradata): FFmpeg's classic tables, the predictor
    from the bit count's low bits."""
    path = tmp_path / "v1 5ms.avi"
    chunks, frames = write_clip(path, name, 10, 16, seed=4, version=1)
    info = avi.probe_avi(path)
    assert info.extra == b"" and info.bit_count & 7
    assert avi.huffyuv_params(info).version == 1
    _check(path, chunks, frames, monkeypatch, name.startswith("rgb"))


@pytest.mark.parametrize("interlace", [None, True, False],
                         ids=["default", "set", "cleared"])
@pytest.mark.parametrize("name", ["rgb24 gradient", "yuy2 gradient",
                                  "yuy2 median", "yuv420p gradient",
                                  "yuv420p median"])
def test_interlace_flag_equals_cv2(tmp_path, name, interlace, monkeypatch):
    """The gradient and median predictors reach two rows up when the
    stream is interlaced: by default above 288 rows, or as the extradata
    says."""
    h = 290 if interlace is None else 14
    path = tmp_path / "tall 5ms.avi"
    chunks, frames = write_clip(path, name, h, 8, n=2, seed=7,
                                interlace=interlace)
    assert avi.huffyuv_params(avi.probe_avi(path)).interlaced == \
        (True if interlace is None else interlace)
    _check(path, chunks, frames, monkeypatch, name.startswith("rgb"))


@pytest.mark.parametrize("codec,name", [("HFYU", "yuv420p left"),
                                        ("FFVH", "rgb24 left decorrelated"),
                                        ("FFVH", "yuy2 median")])
def test_either_fourcc_carries_any_layout(tmp_path, codec, name,
                                          monkeypatch):
    path = tmp_path / "x 5ms.avi"
    chunks, frames = write_clip(path, name, 8, 12, seed=9, codec=codec)
    assert avi.probe_avi(path).codec == codec
    _check(path, chunks, frames, monkeypatch, name.startswith("rgb"))


@pytest.mark.parametrize("fourcc", ["HFYU", "FFVH"])
@pytest.mark.parametrize("colour", [True, False], ids=["colour", "gray"])
def test_cv2_written_clips_equal_cv2(tmp_path, fourcc, colour, monkeypatch):
    """What cv2's own writer makes: HFYU RGB24 decorrelated or YUY2 (gray,
    stored as 4:2:2 and one DN off after swscale), FFVH yuv420p."""
    h, w = 12, 20
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
    assert info == (fourcc, h, w, 3, None)
    chunks = [bytes(c) for c in avi.frame_chunks(path, info)]
    np.testing.assert_array_equal(_plain(chunks, info), want)
    np.testing.assert_array_equal(_native(chunks, info), want)
    monkeypatch.setitem(sys.modules, "cv2", None)
    np.testing.assert_array_equal(_port_frames(path), want)


def test_video_as_stream_one_behind_audio(tmp_path, monkeypatch):
    h, w = 6, 8
    rng = np.random.default_rng(2)
    frames = _frames(rng, h, w, 3)
    path = tmp_path / "s1 5ms.avi"
    write_huffyuv_avi(path, frames, h, w, "rgb24", stream=1,
                      others=[pcm_stream([3, 0, 9])])
    want = cv2_frames(path)
    np.testing.assert_array_equal(want, np.stack(frames))
    assert avi.probe_avi(path).stream == 1
    monkeypatch.setitem(sys.modules, "cv2", None)
    np.testing.assert_array_equal(_port_frames(path), want)


@pytest.mark.parametrize("name", list(STREAMS))
def test_native_equals_plain(name):
    """Every stream, v1 and v2, interlaced or not, several sizes, one
    thread and several: the native decoder equals the plain version bit
    for bit."""
    layout, predictor, decorrelate = STREAMS[name]
    rng = np.random.default_rng(len(name))
    for h, w in ((1, 4), (6, 8), (9, 12), (31, 40)):
        for version in ((1, 2) if layout != "yuv420p" else (2,)):
            for interlace in (False, True):
                frames = _frames(rng, h, w, 3)
                pictures = _pictures(layout, frames, rng)
                s = make_stream(layout, predictor, decorrelate, h, interlace,
                                version, pictures)
                why = huffyuv_plain.unsupported(
                    "HFYU", s.bpp, b"", h, w) if version == 1 else None
                params = stream_params(s, version=version)
                if why or (predictor == "median" and layout == "yuv420p"
                           and h < (6 if interlace else 4)):
                    continue
                chunks = [encode_frame(p, s) for p in pictures]
                plain = np.stack([huffyuv_plain.decode_bgr(c, params, h, w)
                                  for c in chunks])
                if layout.startswith("rgb"):
                    np.testing.assert_array_equal(plain, np.stack(frames))
                for threads in (1, 3):
                    dst = np.empty((3, h, w, 3), np.uint8)
                    native.huffyuv_decode_bgr_batch(chunks, dst, params,
                                                    threads=threads)
                    np.testing.assert_array_equal(dst, plain, err_msg=str(
                        (name, h, w, version, interlace, threads)))


@pytest.mark.parametrize("size", [(6, 8), (7, 16), (5, 10)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_y42b_rawvideo_equals_cv2(tmp_path, size, monkeypatch):
    """yuv422p (``Y42B``), the rawvideo layout HuffYUV's YUY2 frames
    convert as: swscale's unscaled path at an even height, its scaled
    path at an odd one."""
    h, w = size
    rng = np.random.default_rng(h * w)
    planes = [rng.integers(0, 256, s, dtype=np.uint8)
              for s in ((h, w), (h, (w + 1) // 2), (h, (w + 1) // 2))]
    chunk = b"".join(p.tobytes() for p in planes)
    path = tmp_path / "y42b 5ms.avi"
    write_raw_avi(path, [chunk] * 2, h, w, "Y42B", bit_count=16)
    want = cv2_frames(path)
    info = avi.probe_avi(path)
    assert info.layout == "yuv422p"
    np.testing.assert_array_equal(
        rawvideo_plain.decode_bgr(chunk, "yuv422p", h, w), want[0])
    dst = np.empty((2, h, w, 3), np.uint8)
    native.raw_decode_bgr_batch([chunk] * 2, dst, "yuv422p")
    np.testing.assert_array_equal(dst, want)
    monkeypatch.setitem(sys.modules, "cv2", None)
    np.testing.assert_array_equal(_port_frames(path), want)


# --- refusals and errors ---------------------------------------------------

def _refused(tmp_path, case):
    path = tmp_path / f"{case} 5ms.avi"
    rng = np.random.default_rng(0)
    h, w = 6, 8
    frames = _frames(rng, h, w, 2)
    planes = [to_planes(f, "yuy2") for f in frames]
    if case == "rgb median":
        write_huffyuv_avi(path, frames, h, w, "rgb24", "median")
        return path, "RGB24 median"
    if case == "per-frame tables":
        s = make_stream("rgb24", pictures=frames)
        from tests._torch_huffyuv_writer import extradata
        ext = bytearray(extradata(s))
        ext[2] |= 0x40
        write_huffyuv_avi(path, frames, h, w, "rgb24", extra=bytes(ext))
        return path, "per-frame Huffman tables"
    if case == "v3 header":
        write_huffyuv_avi(path, frames, h, w, "rgb24", codec="FFVH",
                          extra=bytes([0, 0x18, 0x20, 1]) + bytes(100))
        return path, "v3 header"
    if case == "yuy2 median width":
        frames = _frames(rng, h, 10, 2)
        write_huffyuv_avi(path, [to_planes(f, "yuy2") for f in frames], h,
                          10, "yuy2", "median")
        return path, "width 10, not a multiple of 4"
    if case == "bad tables":
        ext = bytes([0, 16, 0x20, 0]) + bytes([9, 255, 9 | 1 << 5]) * 3
        write_huffyuv_avi(path, planes, h, w, "yuy2", extra=ext)
        return path, "not a (complete )?prefix code"
    write_huffyuv_avi(path, frames, h, w, "rgb24", version=1, bit_count=40)
    return path, "40 bits per pixel"


@pytest.mark.parametrize("case", ["rgb median", "per-frame tables",
                                  "v3 header", "yuy2 median width",
                                  "bad tables", "bit count"])
def test_refused_layouts_raise_before_decode(tmp_path, case, monkeypatch):
    """A stream the decoder does not read raises a ValueError naming it
    before any frame is decoded, and never reaches cv2."""
    path, why = _refused(tmp_path, case)

    def no_decode(*args, **kwargs):
        raise AssertionError("a frame was decoded or cv2 was reached")
    monkeypatch.setattr(native, "huffyuv_decode_bgr_batch", no_decode)
    monkeypatch.setattr(tvideo, "_cv2", no_decode)
    h, w = tvideo.probe_geometry(path)
    with pytest.raises(ValueError, match=why):
        tvideo._resolve_decoder("native", [path], h, w, 3)
    with pytest.raises(ValueError, match=why):
        tvideo.welford_algorithm(path, use_std=True)


def test_a_cut_frame_raises_naming_it(tmp_path, monkeypatch):
    """Codes that run past the chunk (FFmpeg reads padding there) raise in
    the plain and the native decoder, naming the frame."""
    h, w = 6, 8
    rng = np.random.default_rng(6)
    frames = _frames(rng, h, w, 3)
    s = make_stream("rgb24", pictures=frames)
    params = stream_params(s)
    chunks = [encode_frame(f, s) for f in frames]
    cut = chunks[1][:len(chunks[1]) // 2 // 4 * 4]
    with pytest.raises(ValueError, match="past the end"):
        huffyuv_plain.decode_bgr(cut, params, h, w)
    dst = np.empty((3, h, w, 3), np.uint8)
    with pytest.raises(ValueError, match="frame 8: the codes run past"):
        native.huffyuv_decode_bgr_batch([chunks[0], cut, chunks[2]], dst,
                                        params, first_frame=7)


def test_a_failed_build_raises_and_never_reaches_cv2(tmp_path, monkeypatch):
    path = tmp_path / "hfyu 5ms.avi"
    write_clip(path, "rgb24 left", 6, 8)
    monkeypatch.setitem(native._decoder_libs, "_huffyuv", None)
    monkeypatch.setitem(native._build_errors, "_huffyuv",
                        "g++: simulated failure")

    def no_cv2(why):
        raise AssertionError(f"cv2 was reached: {why}")
    monkeypatch.setattr(tvideo, "_cv2", no_cv2)
    with pytest.raises(RuntimeError, match="simulated failure"):
        tvideo.welford_algorithm(path, use_std=True)


@pytest.mark.parametrize("name", ["rgb24 left", "yuy2 left"])
def test_only_yuv_streams_need_the_mjpeg_build(tmp_path, name, monkeypatch):
    """The YUV layouts convert their planes through ``jpeg.cpp``, so a
    failed build of it raises for them (RuntimeError, before any decode,
    never reaching cv2); an RGB stream decodes without it."""
    h, w = 6, 8
    path = tmp_path / "hfyu 5ms.avi"
    _, frames = write_clip(path, name, h, w)
    want = cv2_frames(path)
    monkeypatch.setattr(native, "_load_mjpeg", lambda: None)
    monkeypatch.setitem(native._build_errors, "_mjpeg",
                        "g++: simulated failure")
    monkeypatch.setitem(sys.modules, "cv2", None)
    monkeypatch.setattr(tvideo, "_cv2", lambda why: pytest.fail(why))
    if name.startswith("yuy2"):
        with pytest.raises(RuntimeError, match="jpeg.cpp.*simulated"):
            tvideo._resolve_decoder("native", [path], h, w, 3)
        return
    assert tvideo._resolve_decoder("native", [path], h, w, 3) == ["huffyuv"]
    got = list(tvideo.video_frame_generator(path, decoder="native"))
    np.testing.assert_array_equal(np.stack(got[:-1]), want)


# --- statistics against the JAX package ------------------------------------

STAT_STREAMS = ["rgb24 left decorrelated", "rgb24 gradient", "yuy2 median",
                "yuv420p left"]


@pytest.mark.parametrize("name", STAT_STREAMS)
def test_welford_and_process_video_equal_jax(tmp_path, name, monkeypatch):
    """With cv2 blocked, the port's ``welford_algorithm`` (host and
    device backends) and ``process_video`` equal the JAX package's
    defaults, which decode with cv2 (rtol 1e-10)."""
    monkeypatch.delenv("CL_DECODER", raising=False)
    h, w = 14, 24
    frames = _frames(np.random.default_rng(1), h, w, 9, 40, 200)
    clips = {}
    for who in ("port", "jax"):
        (tmp_path / who).mkdir()
        clips[who] = tmp_path / who / "scene 5ms.avi"
        write_clip(clips[who], name, h, w, frames=frames)
    want = jvideo.welford_algorithm(clips["jax"], use_std=True)
    jvideo.process_video(clips["jax"])
    with monkeypatch.context() as m:
        m.setitem(sys.modules, "cv2", None)
        obs.reset_stage_times()
        got = tvideo.welford_algorithm(clips["port"], use_std=True)
        assert obs.decoded_frames.snapshot() == {"huffyuv": 9}
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


def test_batch_video_to_hdr_from_hfyu_equals_jax(tmp_path, monkeypatch):
    """The slice as a whole: HFYU RGB24 scenes through the port's
    pipeline, cv2 blocked, against the JAX package's, which reads them
    with cv2."""
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
            rng = np.random.default_rng(10 * s + k)
            write_clip(path, "rgb24 left decorrelated", h, w,
                       frames=_frames(rng, h, w, 5, 40, 200))
            paths.append(path)
        scenes[name] = paths
    want = jpipe.batch_video_to_hdr(scenes, jnp.asarray(icrf))
    monkeypatch.setitem(sys.modules, "cv2", None)
    obs.reset_stage_times()
    got = tpipe.batch_video_to_hdr(scenes, icrf, device="cpu")
    assert obs.decoded_frames.snapshot() == {"huffyuv": 2 * 3 * 5}
    for name in scenes:
        np.testing.assert_allclose(
            got[name].measurand.val.numpy(),
            np.asarray(want[name].measurand.val), rtol=1e-10, atol=1e-14)
        np.testing.assert_allclose(
            got[name].measurand.std.numpy(),
            np.asarray(want[name].measurand.std), rtol=1e-9, atol=1e-14)


@pytest.mark.parametrize("layout", ["rgb24", "yuy2"])
def test_long_codes_equal_cv2(tmp_path, layout, monkeypatch):
    """Tables from a smooth frame coding noisy ones, as FFmpeg's and
    cv2's writers code later frames with the first frame's tables: most
    residuals then take codes longer than the decoders' 12-bit first
    lookup (up to the writer's 24 bits)."""
    h, w = 12, 16
    rng = np.random.default_rng(12)
    flat = [np.clip(100 + rng.normal(0, 1.5, (256, 256, 3)), 0, 255
                    ).astype(np.uint8)]
    noisy = [rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
             for _ in range(3)]
    pictures = lambda fs: fs if layout == "rgb24" else [  # noqa: E731
        to_planes(f, layout) for f in fs]
    s = make_stream(layout, "left", layout == "rgb24", h, None, 2,
                    pictures(flat))
    assert s.lengths.max() > 12
    path = tmp_path / "long 5ms.avi"
    chunks = [encode_frame(p, s) for p in pictures(noisy)]
    write_stream_avi(path, chunks, s, h, w, "HFYU")
    _check(path, chunks, noisy, monkeypatch, layout == "rgb24")
