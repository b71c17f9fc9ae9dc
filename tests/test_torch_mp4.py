"""The port's QuickTime / ISO BMFF demuxer (``utils/mp4.py``) on the layouts
``cv2.VideoWriter`` never writes, made by ``tests/_torch_mp4_writer.py``,
against ``cv2.VideoCapture`` (cv2 5.0, FFmpeg 8), on the CPU.

Every layout the test muxer writes is either held to cv2 bit for bit
(frames, their count, and ``probe_geometry`` against cv2's ``CAP_PROP``
geometry) with cv2 blocked, or refused with a ValueError naming it before
any decode:

* a ``tkhd`` display matrix of 90, 180 and 270 degrees (alone and times an
  ``mvhd`` matrix): cv2 turns the frames and swaps the geometry;
* ``co64``, ``stsc`` with several runs, ``stz2``, one ``stsz`` size for
  every sample, ``moov`` after and before ``mdat``, a 64-bit and a size-0
  ``mdat``, ``free``/``skip``/``wide`` boxes;
* an audio track first, interleaved with the video, and two video tracks
  (cv2 takes the first);
* MPEG-4 B-VOPs in coded order with ``ctts`` and FFmpeg's edit list of one
  frame's offset, with Xvid user data (the Xvid IDCT) and without; edit
  lists with empty edits, a leading offset (on intra frames and on
  P-VOPs) and an end before the track's;
* ``colr`` tags: BT.709 on ``mp4v``, FFV1 yuv420p and I420 frames,
  BT.601 with a full range and the rest, each read as cv2 converts it or
  refused by name.
"""
from __future__ import annotations

import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
cv2 = pytest.importorskip("cv2")

from camera_linearity_tpu_torch.models import video as tvideo  # noqa: E402
from camera_linearity_tpu_torch.utils import avi, containers  # noqa: E402
from tests import _torch_ffv1_writer as fw  # noqa: E402
from tests import _torch_mp4_writer as mw  # noqa: E402
from tests import _torch_mpeg4_writer as mpw  # noqa: E402
from tests._torch_mjpeg_writer import encode_jpeg  # noqa: E402
from tests._torch_rawvideo_writer import encode_frame  # noqa: E402
from tests.test_torch_containers import (assert_like_cv2, content,  # noqa
                                         cv2_frames, cv2_write)

H, W = 24, 40


def jpegs(n: int = 6, seed: int = 0):
    return [encode_jpeg(f) for f in content(H, W, n, seed)]


def mov(path, samples, **track_kw):
    """A QuickTime file of one ``jpeg`` track of ``samples``."""
    top = {k: track_kw.pop(k) for k in list(track_kw)
           if k in ("moov_first", "co64", "mdat64", "mdat_size0", "spacers",
                    "movie_matrix")}
    mw.write_mp4(path, [mw.video_track(samples, H, W, b"jpeg", qt=True,
                                       **track_kw)], qt=True, **top)


@pytest.fixture(scope="module")
def mpeg4_samples(tmp_path_factory):
    """(chunks, esds extradata) of an MPEG-4 stream cv2's writer wrote:
    an I-VOP and P-VOPs."""
    path = tmp_path_factory.mktemp("mpeg4") / "fmp4.avi"
    cv2_write(path, "FMP4", content(H, W, 9, seed=4))
    info = avi.probe_avi(path)
    return [bytes(c) for c in avi.frame_chunks(path, info)], info.extra


def bvop_stream(n: int = 9, xvid: bool = False):
    """Unpacked MPEG-4 chunks with two B-VOPs between references, in coded
    order, and their display times (the test writer, VOL in the first
    chunk)."""
    pics = [fw.to_picture(f, "yuv420p") for f in content(32, 48, n, 5)]
    pics = [(y, u, v) for y, u, v in pics]
    wr = mpw.Writer(32, 48, user_data=b"XviD0050" if xvid else
                    b"Lavc62.28.101", vol_fields=dict(low_delay=0))
    chunks, times = [], []
    for kind, t in mpw.asp_order(n):
        chunk, _ = wr.encode(pics[t], mpw.smoke_plan(
            kind, 5, t % 2 if kind == "P" else 0, time=t))
        chunks.append(chunk)
        times.append(t)
    return chunks, times


# --- held to cv2 -----------------------------------------------------------

@pytest.mark.parametrize("turn", [0, 90, 180, 270])
def test_display_matrix_turns_the_frames(tmp_path, turn, monkeypatch):
    """A ``tkhd`` matrix of a quarter turn: cv2 turns each frame clockwise
    by it and swaps its geometry; the port gives the same.  So it does
    under an ``mvhd`` matrix of a half turn, which FFmpeg multiplies in."""
    path = tmp_path / f"turn {turn}.mov"
    mov(path, jpegs(3), matrix=mw.rotation_matrix(turn))
    assert containers.probe_video(path).rotation == turn
    assert_like_cv2(path, monkeypatch)
    path = tmp_path / f"turn {turn} movie.mov"
    mov(path, jpegs(3), matrix=mw.rotation_matrix(turn),
        movie_matrix=mw.rotation_matrix(180))
    assert containers.probe_video(path).rotation == (turn + 180) % 360
    assert_like_cv2(path, monkeypatch)


def test_turned_mpeg4_batches(tmp_path, mpeg4_samples, monkeypatch):
    """The turn applies to every frame of a batch the decoder fills at
    once: ``welford_algorithm`` (host backend, batches of 4) on a turned
    MP4 equals the unturned run's statistics turned."""
    chunks, extra = mpeg4_samples
    paths = {}
    for turn in (0, 90):
        paths[turn] = tmp_path / f"scene {turn}.mp4"
        mw.write_mp4(paths[turn], [mw.video_track(
            chunks, H, W, b"mp4v", [mw.esds(extra)],
            matrix=mw.rotation_matrix(turn))])
    assert_like_cv2(paths[90], monkeypatch)
    monkeypatch.setitem(sys.modules, "cv2", None)
    flat = tvideo.welford_algorithm(paths[0], use_std=True, batch_size=4)
    turned = tvideo.welford_algorithm(paths[90], use_std=True, batch_size=4)
    for key in ("mean", "std"):
        np.testing.assert_array_equal(turned[key], np.rot90(flat[key], -1))
    # the batch the frames are decoded into before the turn is kept warm
    # and taken again by the next video of its geometry
    scratch = tvideo._SCRATCH_BUFFERS
    kept = scratch.checkout((4, H, W, 3), lambda: None)
    assert kept is not None and kept.shape == (4, H, W, 3)
    scratch.give_back((4, H, W, 3), kept)
    again = tvideo.welford_algorithm(paths[90], use_std=True, batch_size=4)
    assert scratch.checkout((4, H, W, 3), lambda: None) is kept
    for key in ("mean", "std"):
        np.testing.assert_array_equal(again[key], turned[key])


LAYOUTS = {
    "co64": dict(co64=True),
    "stsc runs": dict(chunks=[1, 2, 3]),
    "stsc runs, moov first": dict(chunks=[2, 1], moov_first=True),
    "stz2": dict(stz2=True),
    "mdat64": dict(mdat64=True),
    "mdat size 0": dict(mdat_size0=True),
    "skip and wide": dict(spacers=(b"skip", b"wide", b"free")),
    "stss": dict(sync=[1, 2, 3, 4, 5, 6]),
    "fiel progressive": dict(children=[mw.fiel(1)]),
    "fiel two fields": dict(children=[mw.fiel(2, 9)]),
}


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_box_layouts_equal_cv2(tmp_path, name, monkeypatch):
    """The box and table layouts FFmpeg's demuxer reads."""
    path = tmp_path / "layout.mov"
    mov(path, jpegs(), **LAYOUTS[name])
    assert_like_cv2(path, monkeypatch)


def test_one_stsz_size_equals_cv2(tmp_path, monkeypatch):
    frames = [encode_frame("I420", fw.to_picture(f, "yuv420p"))
              for f in content(H, W, 4, seed=2)]
    path = tmp_path / "i420.mov"
    mw.write_mp4(path, [mw.video_track(frames, H, W, b"I420", depth=12,
                                       fixed_size=True, chunks=[3])],
                 qt=True)
    assert_like_cv2(path, monkeypatch)


@pytest.mark.parametrize("order", ["audio first", "audio interleaved",
                                   "two video tracks"])
def test_other_tracks_equal_cv2(tmp_path, order, monkeypatch):
    """cv2 takes the first video track; the others' samples, between the
    video's, are skipped."""
    video = mw.video_track(jpegs(), H, W, b"jpeg", qt=True, chunks=[1, 2])
    audio = mw.pcm_track([bytes(range(200))] * 5, chunks=[1])
    other = mw.video_track(jpegs(4, seed=9), H, W, b"jpeg", qt=True)
    tracks = {"audio first": [audio, video],
              "audio interleaved": [video, audio],
              "two video tracks": [video, other]}[order]
    path = tmp_path / "tracks.mov"
    mw.write_mp4(path, tracks, qt=True)
    assert_like_cv2(path, monkeypatch)


@pytest.mark.parametrize("xvid", [False, True], ids=["lavc", "xvid"])
@pytest.mark.parametrize("ext", ["mp4", "mkv"])
def test_bvops_with_ctts_equal_cv2(tmp_path, xvid, ext, monkeypatch):
    """B-VOPs in coded order (unpacked): an MP4 with ``ctts`` and the edit
    list of one frame FFmpeg's muxer writes, and a Matroska file; cv2's
    frames in its order and number, with Xvid user data (the Xvid IDCT)
    and without."""
    from tests import _torch_mkv_writer as kw
    chunks, times = bvop_stream(xvid=xvid)
    path = tmp_path / f"bvop.{ext}"
    if ext == "mkv":
        kw.write_mkv(path, [kw.video_track(chunks, 32, 48,
                                           "V_MPEG4/ISO/ASP")])
    else:
        d = mw.DELTA
        ctts = [(t + 1 - i) * d for i, t in enumerate(times)]
        mw.write_mp4(path, [mw.video_track(
            chunks, 32, 48, b"mp4v", [mw.esds(b"")], ctts=ctts, sync=[1],
            elst=[(len(chunks) * 40, d, 1.0)])])
    want = cv2_frames(path)
    assert len(want) == len(chunks)
    assert_like_cv2(path, monkeypatch)


EDITS = {
    "trivial": [(240, 0, 1.0)],
    "empty edit first": [(100, -1, 1.0), (240, 0, 1.0)],
    "leading offset of 2 frames": [(160, 2 * mw.DELTA, 1.0)],
    "leading offset of 1.5 frames": [(180, 3 * mw.DELTA // 2, 1.0)],
    "ends before the track": [(120, 0, 1.0)],
    "offset and end": [(80, mw.DELTA, 1.0)],
}


@pytest.mark.parametrize("name", list(EDITS))
def test_edit_lists_equal_cv2(tmp_path, name, mpeg4_samples, monkeypatch):
    """An edit list: FFmpeg decodes from the key sample at or before the
    edit's media time and drops the frames shown before it, and cuts the
    track after the first key sample reaching the edit's end; on intra
    frames (MJPEG, and raw ``RGBA``, whose reader yields its frames one a
    call) and on P-VOPs (MPEG-4, one key sample)."""
    path = tmp_path / "edit.mov"
    mov(path, jpegs(), elst=EDITS[name])
    assert_like_cv2(path, monkeypatch)
    path = tmp_path / "edit rgba.mov"
    rgba = [np.concatenate([f[..., ::-1], f[..., :1]], -1).tobytes()
            for f in content(H, W, 6, seed=3)]
    mw.write_mp4(path, [mw.video_track(rgba, H, W, b"RGBA", depth=32,
                                       qt=True, elst=EDITS[name])], qt=True)
    assert containers.probe_video(path).codec == "RGBA"
    assert_like_cv2(path, monkeypatch)
    chunks, extra = mpeg4_samples
    path = tmp_path / "edit.mp4"
    mw.write_mp4(path, [mw.video_track(
        chunks, H, W, b"mp4v", [mw.esds(extra)], sync=[1],
        elst=EDITS[name])])
    assert_like_cv2(path, monkeypatch)


def _i420_samples():
    return [encode_frame("I420", fw.to_picture(f, "yuv420p"))
            for f in content(H, W, 3, seed=6)]


def _ffv1_samples():
    config = fw.Config("yuv420p", slices=(1, 1), gop=3)
    enc = fw.Encoder(config, H, W)
    return [enc.encode(fw.to_picture(f, "yuv420p"))
            for f in content(H, W, 3, seed=6)], fw.extradata(config)


@pytest.mark.parametrize("codec", ["mp4v", "FFV1 yuv420p", "I420"])
@pytest.mark.parametrize("tags", [(1, 1, 1, False), (5, 6, 5, False),
                                  (6, 6, 6, False), (2, 2, 2, False)],
                         ids=["bt709", "bt601", "smpte170m", "unspecified"])
def test_colour_tags_equal_cv2(tmp_path, codec, tags, mpeg4_samples,
                               monkeypatch):
    """``colr`` tags FFmpeg hands to the decoder and cv2's conversion
    follows: BT.709 converts by BT.709, BT.601 and none by BT.601."""
    path = tmp_path / "colr.mov"
    if codec == "mp4v":
        chunks, extra = mpeg4_samples
        track = mw.video_track(chunks, H, W, b"mp4v",
                               [mw.esds(extra), mw.colr_nclx(*tags)])
    elif codec == "I420":
        track = mw.video_track(_i420_samples(), H, W, b"I420", [
            mw.colr_nclc(*tags[:3])], depth=12)
    else:
        samples, extra = _ffv1_samples()
        track = mw.video_track(samples, H, W, b"FFV1",
                               [mw.glbl(extra), mw.colr_nclx(*tags)])
    mw.write_mp4(path, [track], qt=True)
    assert_like_cv2(path, monkeypatch)


# --- refused by name ------------------------------------------------------

def _refusals(tmp_path, mpeg4):
    chunks, extra = mpeg4
    samples = jpegs(3)
    out = {}

    def case(name, match, write):
        path = tmp_path / f"{len(out)}.mov"
        write(path)
        out[name] = (path, match)

    case("fragmented (moof)", "fragmented", lambda p: mov(
        p, samples) or p.write_bytes(p.read_bytes() + mw.box(b"moof", b"")))
    case("fragmented (mvex)", "fragmented", lambda p: mw.write_mp4(
        p, [mw.video_track(samples, H, W, b"jpeg")], moov_extra=mw.box(
            b"mvex", b"")))
    case("compressed moov", "compressed moov", lambda p: mw.write_mp4(
        p, [mw.video_track(samples, H, W, b"jpeg")], moov_extra=mw.box(
            b"cmov", b"")))
    case("external data", "another file", lambda p: mov(p, samples) or
         p.write_bytes(p.read_bytes().replace(
             mw.full_box(b"url ", 0, 1, b""), mw.full_box(b"url ", 0, 0,
                                                          b""))))
    case("encrypted", "encrypted", lambda p: mw.write_mp4(
        p, [mw.video_track(samples, H, W, b"encv",
                           [mw.box(b"sinf", b"")])]))
    case("mjpa", "Motion JPEG format A", lambda p: mw.write_mp4(
        p, [mw.video_track(samples, H, W, b"mjpa", qt=True)], qt=True))
    case("two edits", "edit list of 2 edits", lambda p: mov(
        p, samples, elst=[(40, 0, 1.0), (40, 1024, 1.0)]))
    case("rate 2", "rate 2", lambda p: mov(
        p, samples, elst=[(120, 0, 2.0)]))
    case("45 degrees", "display matrix", lambda p: mov(
        p, samples, matrix=(46341, 46341, 0, -46341, 46341, 0, 0, 0,
                            1 << 30)))
    case("past the end", "sample 2 lies past the end", lambda p: mov(
        p, samples, moov_first=True) or p.write_bytes(
            p.read_bytes()[:-len(samples[2]) // 2]))
    case("empty sample", "sample 1 is empty", lambda p: mov(
        p, [samples[0], b"", samples[2]]))
    case("avc1", r"H\.264 \(avc1\) without its avcC", lambda p: mw.write_mp4(
        p, [mw.video_track([b"\0\0\0\1" + bytes(40)] * 2, H, W, b"avc1")]))
    case("hvc1", r"MP4 codec 'hvc1'.*needs cv2", lambda p: mw.write_mp4(
        p, [mw.video_track([b"\0\0\0\1" + bytes(40)] * 2, H, W, b"hvc1")]))
    case("mp4v of MPEG-2", r"MP4 codec 'mp4v \(object type 0x61\)'.*needs "
         "cv2", lambda p: mw.write_mp4(p, [mw.video_track(
             chunks, H, W, b"mp4v", [mw.esds(extra, oti=0x61)])]))
    case("raw rgb24", r"QuickTime MOV codec 'raw  \(rgb24, depth 24\)'.*"
         "needs cv2", lambda p: mw.write_mp4(p, [mw.video_track(
             [bytes(H * W * 3)] * 2, H, W, b"raw ", qt=True)], qt=True))
    case("full-range I420", "full-range YUV", lambda p: mw.write_mp4(
        p, [mw.video_track(_i420_samples(), H, W, b"I420",
                           [mw.colr_nclx(1, 1, 1, True)], depth=12)]))
    case("BT.2020", "matrix_coefficients 9", lambda p: mw.write_mp4(
        p, [mw.video_track(chunks, H, W, b"mp4v",
                           [mw.esds(extra), mw.colr_nclx(9, 16, 9,
                                                         False)])]))
    return out


REFUSALS = ["fragmented (moof)", "fragmented (mvex)", "compressed moov",
            "external data", "encrypted", "mjpa", "two edits", "rate 2",
            "45 degrees", "past the end", "empty sample", "avc1", "hvc1",
            "mp4v of MPEG-2", "raw rgb24", "full-range I420", "BT.2020"]


@pytest.mark.parametrize("name", REFUSALS)
def test_refused_by_name_before_any_decode(tmp_path, name, mpeg4_samples,
                                           monkeypatch):
    """What the port does not read as cv2 reads it raises a ValueError
    naming it, before any frame is decoded (the decoders are not
    reached); a codec it has no decoder of names the codec and the
    container and says it needs cv2."""
    path, match = _refusals(tmp_path, mpeg4_samples)[name]
    monkeypatch.setitem(sys.modules, "cv2", None)
    for entry in ("mpeg4_decode_bgr_batch", "jpeg_decode_bgr_batch",
                  "raw_decode_bgr_batch", "ffv1_decode_bgr_batch"):
        monkeypatch.setattr(tvideo.native, entry, _no_decode)
    with pytest.raises(ValueError, match=match):
        list(tvideo.video_frame_generator(path))


def _no_decode(*args, **kw):
    raise AssertionError("a frame was decoded")


def test_damaged_sample_names_itself(tmp_path, monkeypatch):
    """A file cut inside its last sample, the sample table intact: the
    probe names the sample past the end of the file."""
    path = tmp_path / "cut.mov"
    samples = jpegs(3)
    mov(path, samples, moov_first=True)
    data = path.read_bytes()
    path.write_bytes(data[:-len(samples[2]) // 2])
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ValueError, match="sample 2 lies past the end"):
        tvideo.probe_geometry(path)
