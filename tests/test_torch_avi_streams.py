"""The port's AVI reader on files whose video is not stream 0, against
``cv2.VideoCapture`` and the JAX package, on the CPU.

Field recordings often put an audio stream before the video (camcorders,
OBS, capture cards with an audio input): the video's frames are then
``01dc``/``01db`` chunks, interleaved with the audio's ``00wb``.  The clips
are written by ``tests/_torch_rawvideo_writer.py`` and
``tests/_torch_mjpeg_writer.py`` from ``numpy.random.default_rng(seed)``:
MJPG 4:2:0, I420, 24-bit BI_RGB top-down and RGBA, with the video as
stream 0, 1 or 2 beside PCM audio streams (chunks of odd and even sizes),
a second, larger video stream after the first, ``JUNK``/``ix..`` chunks in
the movi list and an ``idx1`` index.  Tolerances:

* every frame of the port's ``video_frame_generator`` (cv2 blocked)
  equals cv2's bit for bit;
* ``welford_algorithm`` at ``device="cpu"`` (host and device backends,
  cv2 blocked) equals the JAX package's, which decodes with cv2, at rtol
  1e-10 (the device backend's std at 1e-9, as
  tests/test_torch_rawvideo.py holds it);
* ``batch_video_to_hdr`` on scenes whose video is stream 1 equals the JAX
  package's at rtol 1e-10 (std 1e-9).
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
from camera_linearity_tpu.utils import avi as javi  # noqa: E402
from camera_linearity_tpu_torch.models import pipeline as tpipe  # noqa
from camera_linearity_tpu_torch.models import video as tvideo  # noqa: E402
from camera_linearity_tpu_torch.utils import avi  # noqa: E402
from camera_linearity_tpu_torch.utils import observability as obs  # noqa
from tests._torch_mjpeg_writer import encode_jpeg, write_mjpg_avi  # noqa
from tests._torch_rawvideo_writer import (encode_frame, pcm_stream,  # noqa
                                          video_headers, video_stream,
                                          write_avi, write_raw_avi)
from tests.test_torch_native import cv2_frames  # noqa: E402

STATS = dict(rtol=1e-10, atol=1e-15)
H, W = 16, 24
CODECS = ["MJPG", "I420", "bgr24 top-down", "RGBA"]
DECODERS = {"MJPG": "ffmpeg", "I420": "rawvideo", "bgr24 top-down":
            "rawvideo", "RGBA": "raw"}


def _bgr(seed: int, n: int = 3, h: int = H, w: int = W, lo=0, hi=256):
    rng = np.random.default_rng(seed)
    return [rng.integers(lo, hi, (h, w, 3), dtype=np.uint8)
            for _ in range(n)]


def _i420(frame: np.ndarray):
    """Y, U, V planes of a BGR frame (any numbers will do: cv2 and the
    port read the same bytes)."""
    y = frame[..., 1]
    return y, frame[::2, ::2, 0], frame[::2, ::2, 2]


def _others(stream: int, odd: bool = True):
    """Audio streams for the video to be stream ``stream``: before it, or
    (for stream 0) one after it; odd chunk sizes where ``odd``."""
    sizes = [[7, 13, 1, 5], [100, 101, 99]]
    if not odd:
        sizes = [[100, 102, 98], [64, 64, 64]]
    return [pcm_stream(s, seed=k) for k, s in enumerate(sizes[:max(stream,
                                                                    1)])]


def write_clip(path, codec: str, frames, stream: int = 0, others=None,
               **kwargs) -> None:
    """``frames`` (BGR) as an AVI of ``codec`` whose video is stream
    ``stream`` beside ``others`` (default: audio, :func:`_others`)."""
    others = _others(stream) if others is None else others
    h, w = frames[0].shape[:2]
    if codec == "MJPG":
        write_mjpg_avi(path, [encode_jpeg(f) for f in frames], h, w,
                       stream=stream, others=others, **kwargs)
    elif codec == "I420":
        write_raw_avi(path, [encode_frame("I420", _i420(f)) for f in frames],
                      h, w, "I420", stream=stream, others=others, **kwargs)
    elif codec == "RGBA":
        rgba = [np.concatenate([f[..., ::-1], np.full((h, w, 1), 255,
                                                      np.uint8)], -1)
                for f in frames]
        write_raw_avi(path, [f.tobytes() for f in rgba], h, w, "RGBA", 32,
                      stream=stream, others=others, **kwargs)
    else:
        write_raw_avi(path, [encode_frame("DIB", f, 24, True)
                             for f in frames], h, w, "DIB", 24, True,
                      stream=stream, others=others, **kwargs)


def _port_frames(path):
    frames = list(tvideo.video_frame_generator(path))
    assert frames[-1] is None
    return np.stack(frames[:-1])


def _held_to_cv2(path, monkeypatch, stream, codec, n=3):
    """The port's frames of ``path`` (cv2 blocked) are cv2's, bit for
    bit; returns them."""
    want = cv2_frames(path)
    assert want.shape == (n, H, W, 3)
    info = avi.probe_avi(path)
    assert info.stream == stream
    with monkeypatch.context() as m:
        m.setitem(sys.modules, "cv2", None)
        assert tvideo._resolve_decoder("native", [path], H, W, 3) == \
            [DECODERS[codec]]
        np.testing.assert_array_equal(_port_frames(path), want)
    return want


# --- frames ----------------------------------------------------------------

@pytest.mark.parametrize("stream", [0, 1, 2])
@pytest.mark.parametrize("codec", CODECS)
def test_frames_equal_cv2_whatever_the_stream(tmp_path, codec, stream,
                                              monkeypatch):
    """The video as stream 0 (an audio stream after it), 1 or 2 (audio
    streams before it, odd chunk sizes among them): cv2's frames."""
    monkeypatch.delenv("CL_DECODER", raising=False)
    path = tmp_path / f"{codec} {stream} 5ms.avi"
    frames = _bgr(10 * stream + CODECS.index(codec))
    write_clip(path, codec, frames, stream)
    want = _held_to_cv2(path, monkeypatch, stream, codec)
    if codec in ("RGBA", "bgr24 top-down"):  # lossless
        np.testing.assert_array_equal(want, np.stack(frames))


@pytest.mark.parametrize("codec", CODECS)
def test_welford_equals_jax_whatever_the_stream(tmp_path, codec,
                                                monkeypatch):
    """``welford_algorithm`` on a stream-1 video at ``device="cpu"`` (cv2
    blocked) equals the JAX package's default (cv2), and the port's on the
    same frames as stream 0."""
    monkeypatch.delenv("CL_DECODER", raising=False)
    frames = _bgr(5, n=6, lo=40, hi=200)
    paths = {}
    for stream in (0, 1):
        paths[stream] = tmp_path / f"s{stream} 5ms.avi"
        write_clip(paths[stream], codec, frames, stream)
    want = jvideo.welford_algorithm(paths[1], use_std=True)
    with monkeypatch.context() as m:
        m.setitem(sys.modules, "cv2", None)
        obs.reset_stage_times()
        got = tvideo.welford_algorithm(paths[1], use_std=True, device="cpu")
        assert obs.decoded_frames.snapshot() == {DECODERS[codec]: 6}
        dev = tvideo.welford_algorithm(paths[1], use_std=True,
                                       backend="device", batch_size=4,
                                       device="cpu")
        zero = tvideo.welford_algorithm(paths[0], use_std=True,
                                        device="cpu")
    for key in ("mean", "std"):
        assert np.isfinite(got[key]).all()
        np.testing.assert_allclose(got[key], want[key], **STATS)
        np.testing.assert_allclose(dev[key], want[key], rtol=1e-9,
                                   atol=1e-15)
        np.testing.assert_array_equal(got[key], zero[key])


def test_audio_first_bgr24_gives_the_jax_mean(tmp_path, monkeypatch):
    """A 16 x 24 top-down 24-bit BI_RGB AVI, PCM audio as stream 0 and
    the video as stream 1 (three ``01db`` frames): the port once read no
    frame of it and gave an all-NaN mean; it gives the JAX package's."""
    monkeypatch.delenv("CL_DECODER", raising=False)
    path = tmp_path / "audio first 5ms.avi"
    frames = _bgr(3)
    write_clip(path, "bgr24 top-down", frames, 1,
               others=[pcm_stream([800, 800, 800])])
    assert len(cv2_frames(path)) == 3
    chunks = list(avi.raw_chunks(path, avi.probe_avi(path)))
    assert len(chunks) == 3
    want = jvideo.welford_algorithm([path])
    monkeypatch.setitem(sys.modules, "cv2", None)
    got = tvideo.welford_algorithm([path], device="cpu")
    assert np.isfinite(got["mean"]).all()
    np.testing.assert_allclose(got["mean"], want["mean"], **STATS)


@pytest.mark.parametrize("codec", ["MJPG", "I420"])
@pytest.mark.parametrize("first", [True, False])
def test_of_two_video_streams_the_first_is_read(tmp_path, codec, first,
                                                monkeypatch):
    """A second, larger video stream (32 x 40 MJPG) after the first, or
    before it: cv2 reads the first video stream, and so does the port."""
    monkeypatch.delenv("CL_DECODER", raising=False)
    big = video_stream([encode_jpeg(f) for f in _bgr(7, h=32, w=40)], 32, 40,
                       "MJPG", 24)
    path = tmp_path / "two videos 5ms.avi"
    frames = _bgr(8)
    if first:
        write_clip(path, codec, frames, 0, others=[big])
        _held_to_cv2(path, monkeypatch, 0, codec)
        return
    write_clip(path, codec, frames, 1, others=[big])
    want = cv2_frames(path)
    assert want.shape == (3, 32, 40, 3)
    info = avi.probe_avi(path)
    assert (info.codec, info.stream, info.height, info.width) == \
        ("MJPG", 0, 32, 40)
    monkeypatch.setitem(sys.modules, "cv2", None)
    np.testing.assert_array_equal(_port_frames(path), want)


@pytest.mark.parametrize("codec", ["MJPG", "bgr24 top-down"])
def test_index_junk_and_other_chunks_are_skipped(tmp_path, codec,
                                                 monkeypatch):
    """``JUNK``, ``ix01`` and a text stream's ``02tx`` chunks in the movi
    list and an ``idx1`` index after it: cv2's frames."""
    monkeypatch.delenv("CL_DECODER", raising=False)
    path = tmp_path / "indexed 5ms.avi"
    extra = [(0, b"JUNK", b"\0" * 11), (1, b"ix01", b"\0" * 24),
             (2, b"02tx", b"caption"), (3, b"JUNK", b"x")]
    write_clip(path, codec, _bgr(9), 1, others=_others(1) + [
        pcm_stream([3, 5, 7], seed=4)], extra_chunks=extra, index=True)
    _held_to_cv2(path, monkeypatch, 1, codec)


def test_mjpg_chunks_takes_the_jax_stream_argument(tmp_path):
    """``mjpg_chunks(path, stream)`` yields the JAX package's chunks of
    that stream; the default is stream 0."""
    path = tmp_path / "mjpg 5ms.avi"
    frames = [encode_jpeg(f) for f in _bgr(2)]
    write_mjpg_avi(path, frames, H, W, stream=2, others=_others(2))
    assert list(avi.mjpg_chunks(path, 2)) == \
        list(javi.mjpg_chunks(path, 2)) == frames
    assert list(avi.mjpg_chunks(path)) == list(javi.mjpg_chunks(path)) == []
    assert avi.probe_avi(path).jpeg == avi._jpeg_sof(frames[0])


# --- files without a frame of the video stream ------------------------------

@pytest.mark.parametrize("codec", ["MJPG", "I420"])
@pytest.mark.parametrize("case", ["mistagged", "no frames"])
def test_no_frame_chunk_of_the_video_raises(tmp_path, codec, case,
                                            monkeypatch):
    """A video header with no frame chunk of its stream: cv2 reads no
    frame (frames tagged as stream 0's, which is audio, or a movi list of
    audio only); the port raises a ValueError naming the stream rather
    than merge zero frames into a NaN mean."""
    frames = _bgr(1)
    payloads = [encode_jpeg(f) for f in frames] if codec == "MJPG" else \
        [encode_frame("I420", _i420(f)) for f in frames]
    strh, strf = video_headers(H, W, codec.encode(), 24 if codec == "MJPG"
                               else 12, 3, max(map(len, payloads)))
    stream = 1 if case == "mistagged" else 0
    extra = [(0, b"00dc", p) for p in payloads] if case == "mistagged" \
        else []
    path = tmp_path / f"{case} 5ms.avi"
    write_avi(path, strh, strf, [], b"dc", extra, stream=stream,
              others=_others(1))
    assert not cv2.VideoCapture(str(path)).read()[0]
    monkeypatch.setitem(sys.modules, "cv2", None)
    why = f"video stream {stream} has no frame chunk \\({stream:02d}dc"
    with pytest.raises(ValueError, match=why):
        avi.probe_avi(path)
    with pytest.raises(ValueError, match=why):
        tvideo.welford_algorithm(path, device="cpu")


def test_palette_changes_of_the_video_stream_are_refused(tmp_path):
    """An ``01pc`` chunk changes the palette of video stream 1: refused
    by name before any decode, as ``00pc`` is for stream 0."""
    h, w = 6, 8
    idx = np.zeros((h, w), np.uint8)
    palette = np.zeros((256, 4), np.uint8)
    path = tmp_path / "pc 5ms.avi"
    write_raw_avi(path, [encode_frame("DIB", idx, 8)] * 2, h, w, "DIB", 8,
                  palette=palette, stream=1, others=_others(1),
                  extra_chunks=[(1, b"01pc", b"\0" * 8)])
    info = avi.probe_avi(path)
    assert avi.raw_unsupported(path, info) == "palette-change (01pc) chunks"
    with pytest.raises(ValueError, match=r"palette-change \(01pc\)"):
        tvideo.welford_algorithm(path, device="cpu")


# --- the slice -------------------------------------------------------------

@pytest.mark.parametrize("codec", ["MJPG", "I420"])
def test_batch_video_to_hdr_on_stream_1_equals_jax(tmp_path, codec,
                                                   monkeypatch):
    """Config 5 on scenes whose videos put audio first: the port's
    pipeline (cv2 blocked) against the JAX package's, which reads them
    with cv2."""
    monkeypatch.delenv("CL_DECODER", raising=False)
    icrf = np.linspace(0, 1, 256)[:, None].repeat(3, 1) ** \
        np.array([2.0, 2.2, 2.4])
    scenes = {}
    for s, name in enumerate(("a", "b")):
        (tmp_path / name).mkdir()
        scenes[name] = []
        for k, ms in enumerate((4, 8, 16)):
            path = tmp_path / name / f"{name} {ms}ms.avi"
            write_clip(path, codec, _bgr(10 * s + k, n=4, lo=30, hi=220), 1)
            scenes[name].append(path)
    want = jpipe.batch_video_to_hdr(scenes, jnp.asarray(icrf))
    monkeypatch.setitem(sys.modules, "cv2", None)
    obs.reset_stage_times()
    got = tpipe.batch_video_to_hdr(scenes, icrf, device="cpu")
    assert obs.decoded_frames.snapshot() == {DECODERS[codec]: 2 * 3 * 4}
    for name in scenes:
        val = got[name].measurand.val.numpy()
        assert np.isfinite(val).all()
        np.testing.assert_allclose(
            val, np.asarray(want[name].measurand.val), rtol=1e-10,
            atol=1e-14)
        np.testing.assert_allclose(
            got[name].measurand.std.numpy(),
            np.asarray(want[name].measurand.std), rtol=1e-9, atol=1e-14)
