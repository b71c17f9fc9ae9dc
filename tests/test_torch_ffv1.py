"""The port's FFV1 decoder (``native/ffv1.cpp`` and its plain version
``native/ffv1_plain.py``) against ``cv2.VideoCapture`` and the JAX
package, on the CPU.

Clips are written by cv2's own writer (``cv2.VideoWriter(fourcc
"FFV1")``: BGR, gray8 and gray16) and by ``tests/_torch_ffv1_writer.py``
(every variant the decoder reads: versions 0-3, the Golomb-Rice and range
coders, the default and a custom state table, initial context states in
the extradata, context models 0 and 1, one
to many slices, with and without slice CRCs, every frame a keyframe or a
GOP of 12, RGB with and without alpha, gray8, gray16, yuv420p, yuv422p and
yuv444p, odd sizes) from ``numpy.random.default_rng(seed)``, 14 frames
each, so a second GOP's keyframe resets the states.  Tolerances:

* every frame of the plain version, of ``native.ffv1_decode_bgr_batch``
  (fed in two calls, the states carried between them) and of the port's
  ``video_frame_generator`` (cv2 blocked) equals cv2's bit for bit; RGB
  and gray8 frames also equal the frames written (FFV1 is lossless), gray16
  frames their ``gray16_to_8``;
* the Python writer at cv2's settings gives cv2's bytes, extradata and
  every frame chunk, and the native encoder gives the writer's;
* ``welford_algorithm`` and ``batch_video_to_hdr`` of the port, cv2
  blocked, equal the JAX package's (which decodes with cv2) at rtol 1e-10
  (the pipeline's std at 1e-9).
"""
from __future__ import annotations

import functools
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
from camera_linearity_tpu_torch.native import ffv1_plain as fp  # noqa: E402
from camera_linearity_tpu_torch.utils import avi  # noqa: E402
from camera_linearity_tpu_torch.utils import observability as obs  # noqa
from tests import _torch_ffv1_writer as fw  # noqa: E402
from tests._torch_rawvideo_writer import pcm_stream  # noqa: E402
from tests.test_torch_native import cv2_frames  # noqa: E402

STATS = dict(rtol=1e-10, atol=1e-15)
FRAMES = 14

# name: (layout, version, coder, context model, slices, gop, ec, (h, w))
VARIANTS = {
    "bgr0 v3 golomb": ("bgr0", 3, 0, 0, (2, 2), 12, 1, (9, 13)),
    "bgra v3 range custom": ("bgra", 3, 2, 0, (2, 2), 12, 1, (10, 12)),
    "bgr0 v3 range ctx1 no crc": ("bgr0", 3, 1, 1, (3, 2), 12, 0, (11, 14)),
    "bgra v3 golomb one slice": ("bgra", 3, 0, 0, (1, 1), 12, 1, (7, 9)),
    "bgr0 v3 golomb 12 slices": ("bgr0", 3, 0, 1, (4, 3), 12, 1, (16, 24)),
    "bgra v2 range custom ctx1": ("bgra", 2, 2, 1, (2, 3), 12, 0, (12, 9)),
    "bgr0 v1 golomb": ("bgr0", 1, 0, 0, (1, 1), 12, 0, (9, 13)),
    "bgra v0 range": ("bgra", 0, 1, 0, (1, 1), 12, 0, (8, 11)),
    "gray8 v3 golomb ctx1 all keyframes": ("gray8", 3, 0, 1, (2, 2), 1, 1,
                                           (9, 13)),
    "gray8 v3 range": ("gray8", 3, 1, 0, (3, 3), 12, 1, (13, 17)),
    "gray8 v2 golomb": ("gray8", 2, 0, 0, (2, 2), 12, 0, (10, 10)),
    "gray8 v1 range custom": ("gray8", 1, 2, 0, (1, 1), 12, 0, (9, 13)),
    "gray8 v0 golomb ctx1": ("gray8", 0, 0, 1, (1, 1), 12, 0, (9, 13)),
    "gray16 v3 golomb": ("gray16", 3, 0, 0, (2, 2), 12, 1, (9, 13)),
    "gray16 v3 range ctx1 all keyframes": ("gray16", 3, 1, 1, (2, 1), 1, 1,
                                           (8, 12)),
    "gray16 v2 range custom": ("gray16", 2, 2, 0, (1, 2), 12, 0, (9, 13)),
    "gray16 v1 range": ("gray16", 1, 1, 0, (1, 1), 12, 0, (9, 13)),
    "yuv420p v3 golomb odd": ("yuv420p", 3, 0, 0, (2, 2), 12, 1, (9, 13)),
    "yuv420p v3 range custom ctx1": ("yuv420p", 3, 2, 1, (3, 2), 12, 1,
                                     (12, 16)),
    "yuv420p v2 golomb": ("yuv420p", 2, 0, 0, (2, 2), 12, 0, (10, 14)),
    "yuv420p v1 range": ("yuv420p", 1, 1, 0, (1, 1), 12, 0, (11, 15)),
    "yuv422p v3 range custom odd": ("yuv422p", 3, 2, 0, (2, 2), 12, 1,
                                    (9, 13)),
    "yuv422p v3 golomb ctx1": ("yuv422p", 3, 0, 1, (2, 3), 12, 0, (12, 10)),
    "yuv422p v0 golomb": ("yuv422p", 0, 0, 0, (1, 1), 12, 0, (8, 12)),
    "yuv444p v3 golomb odd": ("yuv444p", 3, 0, 0, (2, 2), 12, 1, (9, 13)),
    "yuv444p v3 range custom ctx1": ("yuv444p", 3, 2, 1, (3, 2), 12, 1,
                                     (12, 16)),
    "yuv444p v1 range": ("yuv444p", 1, 1, 0, (1, 1), 12, 0, (11, 15)),
    "gray8 v3 range initial states": ("gray8", 3, 1, 0, (2, 2), 12, 1,
                                      (9, 13)),
    "bgra v2 range custom ctx1 initial states": ("bgra", 2, 2, 1, (1, 2),
                                                 12, 0, (10, 12)),
}


def _frames(rng, h: int, w: int, n: int = FRAMES, lo: int = 0,
            hi: int = 256):
    """Smooth content with noise and a flat block (residuals of every
    size, and runs for the Golomb-Rice run mode)."""
    yy, xx = np.mgrid[:h, :w]
    base = np.stack([(xx * 3 + yy * 5), xx * 7, yy * 11 + xx], -1)
    out = []
    for _ in range(n):
        f = (base + rng.integers(0, 40, (h, w, 3))) % (hi - lo) + lo
        f[h // 3:h // 3 + 3, 1:w // 2] = lo + 17
        out.append(f.astype(np.uint8))
    return out


def _config(name: str) -> fw.Config:
    layout, version, coder, cm, slices, gop, ec, _ = VARIANTS[name]
    return fw.Config(layout, version, coder, cm, slices, gop, ec,
                     4 if version == 3 else 0,
                     initial=name.endswith("initial states"))


def write_variant(path, name: str, seed: int = 0, frames=None):
    """An FFV1 AVI of variant ``name``; returns (chunks, frames)."""
    h, w = VARIANTS[name][-1]
    if frames is None:
        frames = _frames(np.random.default_rng(seed), h, w)
    layout = VARIANTS[name][0]
    chunks = fw.write_ffv1_avi(path, [fw.to_picture(f, layout)
                                      for f in frames], h, w, _config(name))
    return chunks, frames


def _native(chunks, info, threads=None, split: int = 5):
    """The native decoder, fed in two calls (the states carry over)."""
    assert native.ffv1_available(), native.build_error("_ffv1")
    dec = native.Ffv1Decoder(avi.ffv1_params(info), info.height, info.width)
    dst = np.empty((len(chunks), info.height, info.width, 3), np.uint8)
    for part in (slice(0, split), slice(split, None)):
        assert native.ffv1_decode_bgr_batch(
            chunks[part], dst[part], dec, threads=threads) == \
            len(chunks[part])
    assert dec.frames == len(chunks)
    return dst


def _port_frames(path):
    frames = list(tvideo.video_frame_generator(path, decoder="native"))
    assert frames[-1] is None
    return np.stack(frames[:-1])


def _written(frames, layout: str) -> np.ndarray:
    """What cv2 gives for lossless frames written in ``layout``."""
    stack = np.stack(frames)
    if layout in ("bgr0", "bgra", "bgr"):
        return stack
    if layout == "gray8":
        return np.repeat(stack[..., 1:2], 3, -1)
    g16 = fw.to_picture(stack, "gray16")
    return np.repeat(fp.gray16_to_8(g16)[..., None], 3, -1)


def _check(path, chunks, monkeypatch, decoder: str = "ffv1"):
    info = avi.probe_avi(path)
    want = cv2_frames(path)
    assert want.shape == (len(chunks), info.height, info.width, 3)
    np.testing.assert_array_equal(
        fp.decode_bgr(chunks, avi.ffv1_params(info), info.height,
                      info.width), want)
    np.testing.assert_array_equal(_native(chunks, info), want)
    with monkeypatch.context() as m:
        m.setitem(sys.modules, "cv2", None)
        assert tvideo._resolve_decoder(
            "native", [path], info.height, info.width, 3) == [decoder]
        np.testing.assert_array_equal(_port_frames(path), want)
    return want


# --- frames ----------------------------------------------------------------

@pytest.mark.parametrize("name", list(VARIANTS))
def test_variants_equal_cv2(tmp_path, name, monkeypatch):
    """Every variant of the scope, written by the test writer: plain,
    native and the frame generator equal cv2 bit for bit."""
    path = tmp_path / "v 5ms.avi"
    chunks, frames = write_variant(path, name, seed=len(name))
    want = _check(path, chunks, monkeypatch)
    layout = VARIANTS[name][0]
    if not layout.startswith("yuv"):
        np.testing.assert_array_equal(want, _written(frames, layout))


def _cv2_clip(path, layout: str, h: int, w: int, n: int = FRAMES,
              seed: int = 0):
    """A clip of cv2's own FFV1 writer: ``"bgr"``, ``"gray8"`` or
    ``"gray16"``; returns the frames written."""
    rng = np.random.default_rng(seed)
    frames = _frames(rng, h, w, n)
    if layout == "gray16":
        writer = cv2.VideoWriter(
            str(path), cv2.CAP_FFMPEG, cv2.VideoWriter_fourcc(*"FFV1"), 10,
            (w, h), [cv2.VIDEOWRITER_PROP_DEPTH, cv2.CV_16U,
                     cv2.VIDEOWRITER_PROP_IS_COLOR, 0])
    else:
        writer = cv2.VideoWriter(str(path), cv2.CAP_FFMPEG,
                                 cv2.VideoWriter_fourcc(*"FFV1"), 10, (w, h),
                                 layout == "bgr")
    assert writer.isOpened()
    for f in frames:
        writer.write(f if layout == "bgr" else fw.to_picture(f, layout))
    writer.release()
    return frames


@pytest.mark.parametrize("size", [(18, 26), (24, 34)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("layout", ["bgr", "gray8", "gray16"])
def test_cv2_written_clips_equal_cv2(tmp_path, layout, size, monkeypatch):
    """What cv2's own writer makes (version 3, slice CRCs, the Golomb-Rice
    coder at 8 bits and the range coder with a custom table at 16, a GOP
    of 12): plain, native and the frame generator equal cv2 and the frames
    written; the test writer at cv2's settings gives cv2's bytes, and the
    native encoder the writer's."""
    h, w = size
    path = tmp_path / "cv2 5ms.avi"
    frames = _cv2_clip(path, layout, h, w)
    info = avi.probe_avi(path)
    assert info == ("FFV1", h, w, 3, None)
    chunks = [bytes(c) for c in avi.frame_chunks(path, info)]
    want = _check(path, chunks, monkeypatch)
    np.testing.assert_array_equal(want, _written(frames, layout))
    config = fw.cv2_config(layout, h, w)
    assert (config.version, config.ec, info.ffv1.micro_version) == (3, 1, 4)
    assert info.ffv1.coder == config.coder
    assert (info.ffv1.num_h_slices, info.ffv1.num_v_slices) == config.slices
    ext = fw.extradata(config)
    assert info.extra == ext + b"\0" * (len(ext) & 1)
    pictures = [f if layout == "bgr" else fw.to_picture(f, layout)
                for f in frames]
    enc = fw.Encoder(config, h, w)
    assert [enc.encode(p) for p in pictures] == chunks
    assert fw.native_encode(pictures, h, w, config, threads=3) == chunks


def test_cv2_slice_grid_at_4k():
    """The slice grid of cv2's 4K files (12 x 7, 84 slices, probed on a
    2160 x 3840 frame of each layout) and of the other sizes probed."""
    for (h, w), grid in {(2160, 3840): (12, 7), (1080, 1920): (5, 4),
                         (720, 1280): (3, 3), (400, 2000): (4, 2),
                         (2000, 3000): (10, 6), (18, 26): (2, 2),
                         (100, 3000): (2, 2)}.items():
        assert fw.cv2_slices(h, w) == grid


@functools.lru_cache(maxsize=1)
def _twelve_slices():
    """A stream of 12 slices: its frames, chunks, parameters and the plain
    version's decode."""
    name = "bgr0 v3 golomb 12 slices"
    h, w = VARIANTS[name][-1]
    frames = _frames(np.random.default_rng(5), h, w)
    enc = fw.Encoder(_config(name), h, w)
    chunks = [enc.encode(f) for f in frames]
    params = fp.params(fw.extradata(_config(name)))
    return frames, chunks, params, fp.decode_bgr(chunks, params, h, w)


@pytest.mark.parametrize("threads", [1, 3, 16])
def test_native_equals_plain_by_threads(threads):
    """A slice a thread at any thread count: the native decoder equals the
    plain version on a stream of 12 slices, the states carried over
    three calls."""
    frames, chunks, params, want = _twelve_slices()
    h, w = want.shape[1:3]
    dec = native.Ffv1Decoder(params, h, w)
    got = np.empty_like(want)
    for part in (slice(0, 1), slice(1, 12), slice(12, None)):
        native.ffv1_decode_bgr_batch(chunks[part], got[part], dec,
                                     threads=threads)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.stack(frames))


# name: (writer config, {frame: (slice positions, table)} at keyframes)
REGRIDDED = {
    "v3 fewer slices": (
        fw.Config("bgr0", 3, 0, 0, (3, 2), 4, 1, 4),
        {4: ([(0, 0, 3, 1), (0, 1, 3, 1)], 1),
         8: ([(0, 0, 1, 2), (1, 0, 2, 2)], 0)}),
    "v2 other tables": (
        fw.Config("bgr0", 2, 1, 0, (2, 2), 4, 0, 0),
        {4: ([(i % 2, i // 2, 1, 1) for i in range(4)], 1),
         8: ([(0, 0, 2, 1), (0, 1, 2, 1)], 0)}),
}


def _regridded(case: str, n: int = 11):
    """A stream whose keyframes change the slice count and the slices'
    quantisation tables; returns (config, frames, chunks)."""
    config, plan = REGRIDDED[case]
    h, w = 12, 16
    frames = _frames(np.random.default_rng(9), h, w, n)
    enc = fw.Encoder(config, h, w)
    chunks = []
    for i, f in enumerate(frames):
        if i in plan:
            enc.regrid(*plan[i])
        chunks.append(enc.encode(f))
    return config, frames, chunks


@pytest.mark.parametrize("split", [11, 2], ids=["one call", "two calls"])
@pytest.mark.parametrize("case", list(REGRIDDED))
def test_keyframes_that_change_slices_and_tables_in_one_call(tmp_path,
                                                             case, split):
    """Keyframes that change the slice count (version 3: any count up to
    the grid) or the slices' tables (version 2) inside a native call, in
    the first call or after frames whose states a previous call left:
    equal to the plain version, cv2 and the frames written."""
    config, frames, chunks = _regridded(case)
    h, w = frames[0].shape[:2]
    path = tmp_path / "regrid 5ms.avi"
    fw.write_stream_avi(path, chunks, config, h, w)
    want = cv2_frames(path)
    np.testing.assert_array_equal(want, np.stack(frames))
    params = avi.ffv1_params(avi.probe_avi(path))
    np.testing.assert_array_equal(fp.decode_bgr(chunks, params, h, w), want)
    dec = native.Ffv1Decoder(params, h, w)
    got = np.empty_like(want)
    for part in (slice(0, split), slice(split, None)):
        native.ffv1_decode_bgr_batch(chunks[part], got[part], dec, threads=4)
    assert dec.frames == 11
    np.testing.assert_array_equal(got, want)


def test_gray16_takes_every_value_as_cv2(tmp_path):
    """The gray16 -> BGR route, min(255, (v + 128) >> 8), on all 65536
    values of a cv2-written frame."""
    path = tmp_path / "all 5ms.avi"
    values = np.arange(65536, dtype=np.uint16).reshape(256, 256)
    writer = cv2.VideoWriter(
        str(path), cv2.CAP_FFMPEG, cv2.VideoWriter_fourcc(*"FFV1"), 10,
        (256, 256), [cv2.VIDEOWRITER_PROP_DEPTH, cv2.CV_16U,
                     cv2.VIDEOWRITER_PROP_IS_COLOR, 0])
    writer.write(values)
    writer.release()
    want = cv2_frames(path)
    info = avi.probe_avi(path)
    chunks = [bytes(c) for c in avi.frame_chunks(path, info)]
    np.testing.assert_array_equal(
        want[0], np.repeat(fp.gray16_to_8(values)[..., None], 3, -1))
    np.testing.assert_array_equal(_native(chunks, info, split=1), want)


def test_video_as_stream_one_behind_audio(tmp_path, monkeypatch):
    name = "bgra v3 range custom"
    h, w = VARIANTS[name][-1]
    frames = _frames(np.random.default_rng(2), h, w, 5)
    path = tmp_path / "s1 5ms.avi"
    enc = fw.Encoder(_config(name), h, w)
    fw.write_stream_avi(path, [enc.encode(f) for f in frames], _config(name),
                        h, w, stream=1, others=[pcm_stream([3, 0, 9, 4, 1])])
    want = cv2_frames(path)
    np.testing.assert_array_equal(want, np.stack(frames))
    assert avi.probe_avi(path).stream == 1
    monkeypatch.setitem(sys.modules, "cv2", None)
    np.testing.assert_array_equal(_port_frames(path), want)


# --- refusals and errors ---------------------------------------------------

# name: (writer config, what the refusal names)
REFUSED = {
    "yuva444p": (fw.Config("yuva444p"), "yuv444p with alpha"),
    "yuv440p": (fw.Config("yuv440p"), "yuv440p"),
    "yuv411p": (fw.Config("yuv411p"), "yuv411p"),
    "yuv410p": (fw.Config("yuv410p"), "yuv410p"),
    "yuva420p": (fw.Config("yuva420p"), "yuv420p with alpha"),
    "gray with alpha": (fw.Config("ya8"), "gray with alpha"),
    "10-bit gray": (fw.Config("gray10"), "10-bit gray"),
    "10-bit yuv420p": (fw.Config("yuv420p10"), "10-bit yuv420p"),
    "10-bit RGB": (fw.Config("rgb10"), "10-bit RGB"),
    "version 4": (fw.Config("bgr0", version=4, micro_version=3),
                  "version 4"),
    "Bayer": (fw.Config("bgr0", colorspace=2), "colour space 2"),
    "chroma gap": (fw.Config("yuv420p", slices=(2, 3)),
                   "leaves the last chroma row"),
}


def _refused(path, case: str):
    config, why = REFUSED[case]
    h, w = 11, 12
    if case in ("version 4", "Bayer", "10-bit RGB"):
        # a header the decoder refuses; frames cv2 reads none of
        fw.write_stream_avi(path, [b"\x80" * 64] * 2, config, h, w)
        return why
    frame = _frames(np.random.default_rng(4), h, w, 1)[0]
    fw.write_ffv1_avi(path, [fw.to_picture(frame, config.layout)] * 2, h, w,
                      config)
    return why


@pytest.mark.parametrize("case", list(REFUSED))
def test_refused_layouts_raise_before_decode(tmp_path, case, monkeypatch):
    """A stream the decoder does not read raises a ValueError naming it
    before any frame is decoded, and never reaches cv2; cv2 reads each of
    those it reads frames of (all but version 4, Bayer and 10-bit RGB,
    whose frames here are no FFV1)."""
    path = tmp_path / "refused 5ms.avi"
    why = _refused(path, case)
    if case not in ("version 4", "Bayer", "10-bit RGB"):
        assert cv2_frames(path).shape == (2, 11, 12, 3)

    def no_decode(*args, **kwargs):
        raise AssertionError("a frame was decoded or cv2 was reached")
    monkeypatch.setattr(native, "ffv1_decode_bgr_batch", no_decode)
    monkeypatch.setattr(native, "Ffv1Decoder", no_decode)
    monkeypatch.setattr(tvideo, "_cv2", no_decode)
    h, w = tvideo.probe_geometry(path)
    with pytest.raises(ValueError, match=why):
        tvideo._resolve_decoder("native", [path], h, w, 3)
    with pytest.raises(ValueError, match=why):
        tvideo.welford_algorithm(path, use_std=True)
    assert why in avi.ffv1_unsupported(avi.probe_avi(path))


def _clip_chunks(name: str = "bgr0 v3 golomb", n: int = 6):
    h, w = VARIANTS[name][-1]
    frames = _frames(np.random.default_rng(8), h, w, n)
    enc = fw.Encoder(_config(name), h, w)
    return [enc.encode(f) for f in frames], fp.params(fw.extradata(
        _config(name))), (h, w)


def _slice_spans(chunk: bytes):
    """(start, end) of each slice of a version 3 frame with CRCs."""
    spans, end = [], len(chunk)
    while end:
        size = int.from_bytes(chunk[end - 8:end - 5], "big") + 8
        spans.append((end - size, end))
        end -= size
    return spans[::-1]


def _both_raise(chunks, params, hw, match):
    with pytest.raises(fp.Ffv1Error, match=match):
        fp.decode_bgr(chunks, params, *hw)
    dec = native.Ffv1Decoder(params, *hw)
    dst = np.empty((len(chunks),) + hw + (3,), np.uint8)
    with pytest.raises(ValueError, match=match):
        native.ffv1_decode_bgr_batch(chunks, dst, dec)
    with pytest.raises(ValueError, match="an earlier frame failed"):
        native.ffv1_decode_bgr_batch(chunks[:1], dst[:1], dec)


def test_a_flipped_crc_byte_raises_naming_frame_and_slice(tmp_path,
                                                          monkeypatch):
    """A slice whose CRC fails (FFmpeg conceals it from the last frame)
    raises in the plain and the native decoder and through the frame
    generator, naming the frame and the slice."""
    chunks, params, hw = _clip_chunks()
    start, end = _slice_spans(chunks[3])[2]
    bad = bytearray(chunks[3])
    bad[end - 1] ^= 0x40
    chunks[3] = bytes(bad)
    _both_raise(chunks, params, hw, "frame 3: slice 2: its CRC fails")
    path = tmp_path / "crc 5ms.avi"
    fw.write_stream_avi(path, chunks, _config("bgr0 v3 golomb"), *hw)
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ValueError, match="crc 5ms.avi.*frame 3: slice 2: "
                                         "its CRC fails"):
        tvideo.welford_algorithm(path, use_std=True)


def test_a_flipped_crc_after_a_keyframe_that_regrids_names_its_frame():
    """A CRC that fails in the second round of a native call (after a
    keyframe of fewer slices) names its frame and slice in the call."""
    _, frames, chunks = _regridded("v3 fewer slices")
    start, end = _slice_spans(chunks[5])[1]
    bad = bytearray(chunks[5])
    bad[end - 1] ^= 0x40
    chunks[5] = bytes(bad)
    params = fp.params(fw.extradata(REGRIDDED["v3 fewer slices"][0]))
    _both_raise(chunks, params, frames[0].shape[:2],
                "frame 5: slice 1: its CRC fails")


def test_a_slice_size_past_the_chunk_raises():
    chunks, params, hw = _clip_chunks()
    bad = bytearray(chunks[2])
    bad[-8:-5] = (len(bad) + 5).to_bytes(3, "big")
    chunks[2] = bytes(bad)
    _both_raise(chunks, params, hw, "frame 2: the last slice: its size "
                                    "runs past the chunk")


def test_a_first_frame_that_is_no_keyframe_raises():
    chunks, params, hw = _clip_chunks()
    _both_raise(chunks[1:], params, hw, "frame 0: the first frame is no "
                                        "keyframe")


def test_a_cut_slice_raises_where_its_data_end():
    """Range-coded data cut short (their size made good, no CRC) raise
    where the samples run out, naming the frame and the slice."""
    chunks, params, hw = _clip_chunks("bgr0 v3 range ctx1 no crc")
    start, end = _slice_spans_no_crc(chunks[1])[0]
    body = chunks[1][start:end - 3][:12]
    cut = body + len(body).to_bytes(3, "big")
    chunks[1] = cut + chunks[1][end:]
    _both_raise(chunks, params, hw, "frame 1: slice 0: its data end before")


def _slice_spans_no_crc(chunk: bytes):
    spans, end = [], len(chunk)
    while end:
        size = int.from_bytes(chunk[end - 3:end], "big") + 3
        spans.append((end - size, end))
        end -= size
    return spans[::-1]


def test_an_extradata_crc_that_fails_refuses_the_stream(tmp_path):
    name = "gray8 v3 range"
    h, w = VARIANTS[name][-1]
    ext = bytearray(fw.extradata(_config(name)))
    ext[3] ^= 1
    path = tmp_path / "ext 5ms.avi"
    frames = _frames(np.random.default_rng(1), h, w, 2)
    enc = fw.Encoder(_config(name), h, w)
    fw.write_stream_avi(path, [enc.encode(fw.to_picture(f, "gray8"))
                               for f in frames], _config(name), h, w,
                        extra=bytes(ext))
    with pytest.raises(ValueError, match="CRC fails"):
        tvideo._resolve_decoder("native", [path], h, w, 3)


def test_a_failed_build_raises_and_never_reaches_cv2(tmp_path, monkeypatch):
    path = tmp_path / "ffv1 5ms.avi"
    write_variant(path, "gray8 v3 range")
    monkeypatch.setitem(native._decoder_libs, "_ffv1", None)
    monkeypatch.setitem(native._build_errors, "_ffv1",
                        "g++: simulated failure")

    def no_cv2(why):
        raise AssertionError(f"cv2 was reached: {why}")
    monkeypatch.setattr(tvideo, "_cv2", no_cv2)
    with pytest.raises(RuntimeError, match="ffv1.cpp.*simulated failure"):
        tvideo.welford_algorithm(path, use_std=True)
    with pytest.raises(RuntimeError, match="simulated failure"):
        native.Ffv1Decoder(avi.ffv1_params(avi.probe_avi(path)), 13, 17)


@pytest.mark.parametrize("name", ["bgr0 v3 golomb", "yuv420p v3 golomb odd"])
def test_only_yuv_streams_need_the_mjpeg_build(tmp_path, name, monkeypatch):
    """yuv420p and yuv422p convert their planes through ``jpeg.cpp``, so a
    failed build of it raises for them (RuntimeError, before any decode);
    an RGB stream decodes without it."""
    path = tmp_path / "ffv1 5ms.avi"
    write_variant(path, name)
    h, w = VARIANTS[name][-1]
    want = cv2_frames(path)
    monkeypatch.setattr(native, "_load_mjpeg", lambda: None)
    monkeypatch.setitem(native._build_errors, "_mjpeg",
                        "g++: simulated failure")
    monkeypatch.setitem(sys.modules, "cv2", None)
    monkeypatch.setattr(tvideo, "_cv2", lambda why: pytest.fail(why))
    if name.startswith("yuv"):
        with pytest.raises(RuntimeError, match="jpeg.cpp.*simulated"):
            tvideo._resolve_decoder("native", [path], h, w, 3)
        return
    assert tvideo._resolve_decoder("native", [path], h, w, 3) == ["ffv1"]
    np.testing.assert_array_equal(_port_frames(path), want)


# --- the native encoder ----------------------------------------------------

@pytest.mark.parametrize("layout", ["bgra", "bgr0", "gray8", "gray16",
                                    "yuv420p", "yuv422p"])
@pytest.mark.parametrize("coder", [0, 1, 2],
                         ids=["golomb", "range", "custom"])
def test_native_encoder_gives_the_writers_bytes(layout, coder):
    """On small frames of every layout it writes, both coders and both
    context models, odd sizes, several GOPs: the native encoder's bytes
    are the Python writer's."""
    rng = np.random.default_rng(coder * 7 + len(layout))
    for (h, w), slices, cm in (((9, 13), (2, 2), 0), ((16, 24), (3, 2), 1),
                               ((7, 5), (1, 1), coder % 2)):
        config = fw.Config(layout, 3, coder, cm, slices, 5)
        pictures = [fw.to_picture(f, layout)
                    for f in _frames(rng, h, w, 7)]
        enc = fw.Encoder(config, h, w)
        assert fw.native_encode(pictures, h, w, config) == \
            [enc.encode(p) for p in pictures]


# --- statistics against the JAX package ------------------------------------

def test_welford_equals_jax_with_and_without_cv2(tmp_path, monkeypatch):
    """``welford_algorithm`` of the port on a cv2-written FFV1 clip equals
    the JAX package's with ``decoder="cv2"`` (rtol 1e-10), with cv2
    importable and with it blocked; the frames go through the port's own
    decoder either way."""
    monkeypatch.delenv("CL_DECODER", raising=False)
    path = tmp_path / "scene 5ms.avi"
    _cv2_clip(path, "bgr", 16, 24, n=13, seed=3)
    want = jvideo.welford_algorithm(path, use_std=True, decoder="cv2")
    for blocked in (False, True):
        with monkeypatch.context() as m:
            if blocked:
                m.setitem(sys.modules, "cv2", None)
            obs.reset_stage_times()
            got = tvideo.welford_algorithm(path, use_std=True)
            assert obs.decoded_frames.snapshot() == {"ffv1": 13}
        for key in ("mean", "std"):
            np.testing.assert_allclose(got[key], want[key], **STATS)


def test_batch_video_to_hdr_from_ffv1_equals_jax(tmp_path, monkeypatch):
    """The slice as a whole: cv2-written FFV1 scenes (BGR, a keyframe and
    state-carrying frames) through the port's pipeline, cv2 blocked,
    against the JAX package's, which reads them with cv2."""
    monkeypatch.delenv("CL_DECODER", raising=False)
    h, w = 16, 24
    icrf = np.linspace(0, 1, 256)[:, None].repeat(3, 1) ** \
        np.array([2.0, 2.2, 2.4])
    scenes = {}
    for s, name in enumerate(("a", "b")):
        (tmp_path / name).mkdir()
        scenes[name] = []
        for k, ms in enumerate((4, 8, 16)):
            path = tmp_path / name / f"{name} {ms}ms.avi"
            _cv2_clip(path, "bgr", h, w, n=13, seed=10 * s + k)
            scenes[name].append(path)
    want = jpipe.batch_video_to_hdr(scenes, jnp.asarray(icrf))
    monkeypatch.setitem(sys.modules, "cv2", None)
    obs.reset_stage_times()
    got = tpipe.batch_video_to_hdr(scenes, icrf, device="cpu")
    assert obs.decoded_frames.snapshot() == {"ffv1": 2 * 3 * 13}
    for name in scenes:
        np.testing.assert_allclose(
            got[name].measurand.val.numpy(),
            np.asarray(want[name].measurand.val), rtol=1e-10, atol=1e-14)
        np.testing.assert_allclose(
            got[name].measurand.std.numpy(),
            np.asarray(want[name].measurand.std), rtol=1e-9, atol=1e-14)
