"""The port's reader of uncompressed AVIs (``rawvideo``: ``native/jpeg.cpp``
and its plain version ``native/rawvideo_plain.py``) against
``cv2.VideoCapture`` and the JAX package, on the CPU.

Clips are written by ``tests/_torch_rawvideo_writer.py`` from
``numpy.random.default_rng(seed)``: BI_RGB at 8 bits (gray, colour and
16-entry palettes), 16 bits (RGB555), 24 and 32 bits, bottom-up and
top-down with rows padded to 4 bytes; ``Y800``/``GREY``/``Y8  ``,
``I420``/``IYUV``/``YV12``, ``NV12``, ``YUY2``/``UYVY`` as cv2's writer
lays them out, and ``I444``/``YV24`` (yuv444p, ``YV24`` with its V plane
first) as rawdec reads them (cv2 reads neither ``444P`` nor ``Y444``).
Tolerances:

* every frame of the plain version, of ``native.raw_decode_bgr_batch``
  and of the port's ``video_frame_generator`` (cv2 blocked) equals cv2's
  bit for bit, at even and odd sizes;
* bottom-up 24-bit BI_RGB equals the frames written: cv2 5.0's FFmpeg
  path aborts the process on it (a segmentation fault, at every width
  tried), so cv2 is not asked;
* ``welford_algorithm``, ``process_video`` and ``batch_video_to_hdr`` of
  the port, cv2 blocked, equal the JAX package's defaults (cv2) at rtol
  1e-10 (the pipeline's std at 1e-9, as tests/test_torch_video.py holds
  MJPG scenes).
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
from camera_linearity_tpu_torch.native import rawvideo_plain  # noqa: E402
from camera_linearity_tpu_torch.utils import avi  # noqa: E402
from camera_linearity_tpu_torch.utils import observability as obs  # noqa
from tests._torch_rawvideo_writer import (encode_frame,  # noqa: E402
                                          write_raw_avi)
from tests.test_torch_native import cv2_frames  # noqa: E402

STATS = dict(rtol=1e-10, atol=1e-15)

# kind: (codec, bit count, top-down); the palette kinds differ in palette
KINDS = {
    "pal8 gray": ("DIB", 8, False),
    "pal8 colour": ("DIB", 8, False),
    "pal8 colour top-down": ("DIB", 8, True),
    "pal8 16 entries": ("DIB", 8, False),
    "rgb555": ("DIB", 16, False),
    "rgb555 top-down": ("DIB", 16, True),
    "bgr24": ("DIB", 24, False),
    "bgr24 top-down": ("DIB", 24, True),
    "bgr0": ("DIB", 32, False),
    "bgr0 top-down": ("DIB", 32, True),
    "Y800": ("Y800", 8, False),
    "GREY": ("GREY", 8, False),
    "Y8": ("Y8  ", 8, False),
    "I420": ("I420", 12, False),
    "IYUV": ("IYUV", 12, False),
    "YV12": ("YV12", 12, False),
    "NV12": ("NV12", 12, False),
    "YUY2": ("YUY2", 16, False),
    "UYVY": ("UYVY", 16, False),
    "I444": ("I444", 24, False),
    "YV24": ("YV24", 24, False),
}
SIZES = [(6, 8), (7, 13), (10, 5)]
# cv2 5.0 aborts on bottom-up 24-bit BI_RGB (see below)
CV2_KINDS = [kind for kind in KINDS if kind != "bgr24"]


def _content(kind: str, rng, h: int, w: int, lo: int = 0, hi: int = 256):
    """One frame of ``kind``'s content, as encode_frame takes it."""
    codec, bits, _ = KINDS[kind]
    u8 = lambda *shape: rng.integers(lo, hi, shape, dtype=np.uint8)  # noqa
    if codec == "DIB":
        if bits == 16:
            return rng.integers(0, 1 << 16, (h, w), dtype=np.uint16)
        return u8(h, w) if bits == 8 else u8(h, w, bits // 8)
    if codec.strip() in ("Y800", "GREY", "Y8"):
        return u8(h, w)
    if codec in ("I444", "YV24"):
        return u8(h, w), u8(h, w), u8(h, w)
    ch = h if codec in ("YUY2", "UYVY") else (h + 1) // 2
    return u8(h, w), u8(ch, (w + 1) // 2), u8(ch, (w + 1) // 2)


def _palette(kind: str, rng):
    if kind == "pal8 gray":
        return np.repeat(np.arange(256, dtype=np.uint8)[:, None], 4, 1)
    return rng.integers(0, 256, (16 if "16" in kind else 256, 4),
                        dtype=np.uint8)


def write_clip(path, kind: str, h: int, w: int, n: int = 3, seed: int = 0,
               frames=None):
    """An AVI of ``kind`` at (h, w): returns its chunks, the written
    content and the plain version's frames."""
    codec, bits, top_down = KINDS[kind]
    rng = np.random.default_rng(seed)
    palette = _palette(kind, rng) if bits == 8 and codec == "DIB" else None
    if frames is None:
        frames = [_content(kind, rng, h, w) for _ in range(n)]
    chunks = [encode_frame(codec, f, bits, top_down) for f in frames]
    write_raw_avi(path, chunks, h, w, codec, bits, top_down, palette,
                  clr_used=0 if kind == "pal8 16 entries" else None)
    info = avi.probe_avi(path)
    plain = np.stack([rawvideo_plain.decode_bgr(
        c, info.layout, h, w, info.raw.bottom_up, info.raw.palette)
        for c in chunks])
    return chunks, frames, plain


def _native(chunks, info, threads=None):
    assert native.mjpeg_available(), native.build_error("_mjpeg")
    dst = np.empty((len(chunks), info.height, info.width, 3), np.uint8)
    assert native.raw_decode_bgr_batch(
        chunks, dst, info.layout, bottom_up=info.raw.bottom_up,
        palette=info.raw.palette, threads=threads) == len(chunks)
    return dst


def _port_frames(path):
    frames = list(tvideo.video_frame_generator(path, decoder="native"))
    assert frames[-1] is None
    return np.stack(frames[:-1])


# --- frames ----------------------------------------------------------------

@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("kind", CV2_KINDS)
def test_frames_equal_cv2(tmp_path, kind, size, monkeypatch):
    """The plain version, the native reader and the port's frame
    generator (cv2 blocked) give cv2's frames bit for bit."""
    h, w = size
    path = tmp_path / "clip 5ms.avi"
    chunks, _, plain = write_clip(path, kind, h, w, seed=h * w)
    want = cv2_frames(path)
    assert want.shape == (3, h, w, 3)
    np.testing.assert_array_equal(plain, want)
    info = avi.probe_avi(path)
    np.testing.assert_array_equal(_native(chunks, info), want)
    monkeypatch.setitem(sys.modules, "cv2", None)
    assert tvideo._resolve_decoder("native", [path], h, w, 3) == ["rawvideo"]
    np.testing.assert_array_equal(_port_frames(path), want)


@pytest.mark.parametrize("size", [(6, 8), (7, 13), (5, 2)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_bottom_up_bgr24_equals_the_written_frames(tmp_path, size,
                                                   monkeypatch):
    """Bottom-up 24-bit BI_RGB (the layout FFmpeg and ImageJ write for
    BGR frames): cv2 5.0 aborts the process reading it, so the frames
    written are the reference; top-down 24-bit is held to cv2 above."""
    h, w = size
    path = tmp_path / "bgr24 5ms.avi"
    frames = [np.random.default_rng(i).integers(0, 256, (h, w, 3),
                                                dtype=np.uint8)
              for i in range(3)]
    chunks, _, plain = write_clip(path, "bgr24", h, w, frames=frames)
    info = avi.probe_avi(path)
    assert (info.layout, info.raw.bottom_up) == ("bgr24", True)
    np.testing.assert_array_equal(plain, np.stack(frames))
    np.testing.assert_array_equal(_native(chunks, info), np.stack(frames))
    monkeypatch.setitem(sys.modules, "cv2", None)
    np.testing.assert_array_equal(_port_frames(path), np.stack(frames))


@pytest.mark.parametrize("layout", rawvideo_plain.LAYOUTS)
def test_native_equals_plain(layout):
    """Every layout, either row order, padded and packed rows, odd and
    even sizes, one thread and several: the native reader equals the
    plain version bit for bit."""
    rng = np.random.default_rng(len(layout))
    palette = rng.integers(0, 256, (256, 4), dtype=np.uint8)
    for h, w in ((1, 1), (2, 3), (9, 14), (33, 70), (64, 96)):
        need = rawvideo_plain.frame_bytes(layout, h, w)
        sizes = rawvideo_plain.chunk_sizes(layout, h, w)
        for bottom_up in (False, True):
            for size in sizes + (sizes[-1] + 5,):
                chunks = [rng.integers(0, 256, size, dtype=np.uint8).tobytes()
                          for _ in range(4)]
                plain = np.stack([rawvideo_plain.decode_bgr(
                    c, layout, h, w, bottom_up, palette) for c in chunks])
                for threads in (1, 3):
                    dst = np.empty((4, h, w, 3), np.uint8)
                    native.raw_decode_bgr_batch(
                        chunks, dst, layout, bottom_up, palette, threads)
                    np.testing.assert_array_equal(dst, plain, err_msg=str(
                        (layout, h, w, bottom_up, size, need, threads)))


def test_a_short_chunk_raises_in_the_readers_and_ends_the_video(
        tmp_path, monkeypatch):
    """A chunk shorter than its frame: the readers raise on it, naming
    the frame; in a file it ends the video where cv2's read loop ends
    (the frames before it are read), and an empty chunk is skipped."""
    h, w = 6, 8
    frame = np.arange(h * w, dtype=np.uint8).reshape(h, w)
    full = frame.tobytes()
    dst = np.empty((2, h, w, 3), np.uint8)
    with pytest.raises(ValueError, match="frame 5: gray8 chunk of 47 bytes"):
        native.raw_decode_bgr_batch([full, full[:-1]], dst, "gray8",
                                    first_frame=4)
    with pytest.raises(ValueError, match="chunk of 47 bytes"):
        rawvideo_plain.decode_bgr(full[:-1], "gray8", h, w)
    path = tmp_path / "short 5ms.avi"
    write_raw_avi(path, [full, b"", full, full[:-1], full], h, w, "Y800")
    want = cv2_frames(path)
    assert want.shape[0] == 2
    monkeypatch.setitem(sys.modules, "cv2", None)
    np.testing.assert_array_equal(_port_frames(path), want)


def test_cv2s_own_yuy2_avi_gives_what_cv2_gives(tmp_path, monkeypatch):
    """cv2's writer stores 4:2:0 frames under a ``YUY2`` header, chunks
    shorter than a YUY2 frame: cv2 reads no frame from it, and neither
    does the port; the statistics are the JAX package's (a NaN mean, no
    std)."""
    h, w = 8, 16
    path = tmp_path / "yuy2 5ms.avi"
    writer = cv2.VideoWriter(str(path), cv2.CAP_FFMPEG,
                             cv2.VideoWriter_fourcc(*"YUY2"), 10, (w, h))
    assert writer.isOpened()
    for i in range(3):
        writer.write(np.full((h, w, 3), 40 * i, np.uint8))
    writer.release()
    info = avi.probe_avi(path)
    assert (info.layout, info.raw.bit_count) == ("yuyv422", 12)
    assert cv2.VideoCapture(str(path)).read()[0] is False
    want = jvideo.welford_algorithm(path, use_std=True)
    monkeypatch.setitem(sys.modules, "cv2", None)
    assert list(tvideo.video_frame_generator(path)) == [None]
    got = tvideo.welford_algorithm(path, use_std=True)
    assert got["std"] is None and want["std"] is None
    np.testing.assert_array_equal(got["mean"], np.asarray(want["mean"]))
    assert np.isnan(got["mean"]).all()


# --- refusals --------------------------------------------------------------

def _refused(tmp_path, case):
    h, w = 6, 8
    path = tmp_path / f"{case} 5ms.avi"
    idx = np.zeros((h, w), np.uint8)
    palette = np.zeros((256, 4), np.uint8)
    if case in ("1-bit", "4-bit"):
        bits = int(case[0])
        rows = np.zeros((h, 4), np.uint8).tobytes()  # w bits padded to 4
        write_raw_avi(path, [rows], h, w, "DIB", bits,
                      palette=palette[:1 << bits])
        return path, f"{bits}-bit BI_RGB"
    if case == "bitfields":
        write_raw_avi(path, [np.zeros(h * w * 2, np.uint8).tobytes()], h, w,
                      "DIB", 16, compression=3)
        return path, "BI_BITFIELDS"
    if case == "palette change":
        write_raw_avi(path, [encode_frame("DIB", idx, 8)] * 2, h, w, "DIB",
                      8, palette=palette,
                      extra_chunks=[(1, b"00pc", b"\0" * 8)])
        return path, "palette-change"
    write_raw_avi(path, [idx.tobytes(), idx.tobytes() + b"\0" * 3], h, w,
                  "Y800")
    return path, "gray8 frame chunk of 51 bytes, not the 6 x 8 frame's 48"


@pytest.mark.parametrize("case", ["1-bit", "4-bit", "bitfields",
                                  "palette change", "chunk size"])
def test_refused_layouts_raise_before_decode(tmp_path, case, monkeypatch):
    """What the rawvideo reader does not read raises a ValueError naming
    it before any frame is decoded, whether or not cv2 is installed (the
    file never reaches cv2)."""
    path, why = _refused(tmp_path, case)

    def no_decode(*args, **kwargs):
        raise AssertionError("a frame was decoded")
    monkeypatch.setattr(native, "raw_decode_bgr_batch", no_decode)
    monkeypatch.setattr(tvideo, "_cv2", no_decode)
    h, w = tvideo.probe_geometry(path)
    with pytest.raises(ValueError, match=why):
        tvideo._resolve_decoder("native", [path], h, w, 3)
    with pytest.raises(ValueError, match=why):
        tvideo.welford_algorithm(path, use_std=True)


def test_a_failed_build_raises_and_never_reaches_cv2(tmp_path, monkeypatch):
    path = tmp_path / "i420 5ms.avi"
    write_clip(path, "I420", 6, 8)
    monkeypatch.setattr(native, "_load_mjpeg", lambda: None)
    monkeypatch.setitem(native._build_errors, "_mjpeg",
                        "g++: simulated failure")

    def no_cv2(why):
        raise AssertionError(f"cv2 was reached: {why}")
    monkeypatch.setattr(tvideo, "_cv2", no_cv2)
    with pytest.raises(RuntimeError, match="simulated failure"):
        tvideo.welford_algorithm(path, use_std=True)
    with pytest.raises(RuntimeError, match="simulated failure"):
        native.raw_decode_bgr_batch([b""], np.empty((1, 6, 8, 3), np.uint8),
                                    "i420")


def test_probe_reads_the_whole_header(tmp_path):
    """``probe_avi``: the layout, bit count, row order, and the palette as
    FFmpeg's AVI demuxer reads it (16 entries stated as 0: those 16, the
    rest zero)."""
    path = tmp_path / "p 5ms.avi"
    write_clip(path, "pal8 16 entries", 5, 7)
    info = avi.probe_avi(path)
    assert info == ("DIB", 5, 7, 3, None)
    assert info.raw[:3] == ("pal8", 8, True)
    palette = info.raw.palette
    assert palette.shape == (256, 4) and not palette[16:].any()
    np.testing.assert_array_equal(
        palette[:16], _palette("pal8 16", np.random.default_rng(0)))
    write_clip(path, "bgr0 top-down", 5, 7)
    info = avi.probe_avi(path)
    assert info.raw == ("bgr0", 32, False, None)
    for kind, layout in (("Y8", "gray8"), ("YV12", "yv12"),
                         ("UYVY", "uyvy422")):
        write_clip(path, kind, 6, 8)
        assert avi.probe_avi(path).layout == layout


# --- statistics against the JAX package ------------------------------------

STAT_KINDS = ["pal8 gray", "pal8 colour", "Y800", "I420", "bgr24 top-down",
              "NV12"]


def _scene_frames(kind, h, w, n, seed):
    """Frames of one exposure: a base level plus noise, as content of
    ``kind``."""
    rng = np.random.default_rng(seed)
    return [_content(kind, rng, h, w, 40, 200) for _ in range(n)]


@pytest.mark.parametrize("kind", STAT_KINDS)
def test_welford_and_process_video_equal_jax(tmp_path, kind, monkeypatch):
    """With cv2 blocked, the port's ``welford_algorithm`` (host and
    device backends) and ``process_video`` equal the JAX package's
    defaults, which decode with cv2 (rtol 1e-10)."""
    monkeypatch.delenv("CL_DECODER", raising=False)
    h, w = 14, 22
    frames = _scene_frames(kind, h, w, 9, 1)
    clips = {}
    for who in ("port", "jax"):
        (tmp_path / who).mkdir()
        clips[who] = tmp_path / who / "scene 5ms.avi"
        write_clip(clips[who], kind, h, w, frames=frames)
    want = jvideo.welford_algorithm(clips["jax"], use_std=True)
    jvideo.process_video(clips["jax"])
    with monkeypatch.context() as m:
        m.setitem(sys.modules, "cv2", None)
        obs.reset_stage_times()
        got = tvideo.welford_algorithm(clips["port"], use_std=True)
        assert obs.decoded_frames.snapshot() == {"rawvideo": 9}
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


def test_batch_video_to_hdr_from_i420_equals_jax(tmp_path, monkeypatch):
    """The slice as a whole: I420 scenes (cv2's uncompressed writer
    layout) through the port's pipeline, cv2 blocked, against the JAX
    package's, which reads them with cv2."""
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
            write_clip(path, "I420", h, w,
                       frames=_scene_frames("I420", h, w, 5, 10 * s + k))
            paths.append(path)
        scenes[name] = paths
    want = jpipe.batch_video_to_hdr(scenes, jnp.asarray(icrf))
    monkeypatch.setitem(sys.modules, "cv2", None)
    obs.reset_stage_times()
    got = tpipe.batch_video_to_hdr(scenes, icrf, device="cpu")
    assert obs.decoded_frames.snapshot() == {"rawvideo": 2 * 3 * 5}
    for name in scenes:
        np.testing.assert_allclose(
            got[name].measurand.val.numpy(),
            np.asarray(want[name].measurand.val), rtol=1e-10, atol=1e-14)
        np.testing.assert_allclose(
            got[name].measurand.std.numpy(),
            np.asarray(want[name].measurand.std), rtol=1e-9, atol=1e-14)
