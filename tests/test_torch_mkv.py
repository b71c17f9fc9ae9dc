"""The port's Matroska demuxer (``utils/mkv.py``) on the layouts
``cv2.VideoWriter`` never writes, made by ``tests/_torch_mkv_writer.py``,
against ``cv2.VideoCapture`` (cv2 5.0, FFmpeg 8), on the CPU.

Every layout the test muxer writes is either held to cv2 bit for bit
(frames, their count, and ``probe_geometry`` against cv2's ``CAP_PROP``
geometry) with cv2 blocked, or refused with a ValueError naming it before
any decode:

* Xiph, EBML and fixed-size lacing; BlockGroups; Clusters and a Segment of
  unknown size; CRC-32 and Void elements; a WebM DocType;
* header stripping and zlib, on the frames and on the CodecPrivate;
* an audio track first and interleaved, two video tracks (cv2 takes the
  first);
* a rectangular ``Projection``: a roll of 90, -90 and 180 degrees, a yaw
  of 180 (FFmpeg's display matrix, which cv2 turns the frames by);
* ``Colour`` on ``V_UNCOMPRESSED`` I420 and ``V_MPEG4/ISO/ASP``: BT.709
  and BT.601 converted as cv2 converts them, a full range refused;
* the codecs under ``V_MS/VFW/FOURCC`` by their BITMAPINFOHEADER
  (MPEG-4 under ``XVID``: the Xvid IDCT by the tag's rule).
"""
from __future__ import annotations

import sys

import pytest

torch = pytest.importorskip("torch")
cv2 = pytest.importorskip("cv2")

from camera_linearity_tpu_torch.models import video as tvideo  # noqa: E402
from camera_linearity_tpu_torch.utils import avi, containers  # noqa: E402
from tests import _torch_ffv1_writer as fw  # noqa: E402
from tests import _torch_mkv_writer as kw  # noqa: E402
from tests._torch_mjpeg_writer import encode_jpeg  # noqa: E402
from tests._torch_rawvideo_writer import encode_frame  # noqa: E402
from tests.test_torch_containers import (_bih, assert_like_cv2,  # noqa
                                         content, cv2_write)

H, W = 24, 40


def jpegs(n: int = 6, seed: int = 0):
    return [encode_jpeg(f) for f in content(H, W, n, seed)]


def mjpeg(path, frames=None, track_kw=None, **kw_args):
    kw.write_mkv(path, [kw.video_track(frames or jpegs(), H, W, "V_MJPEG",
                                       **(track_kw or {}))], **kw_args)


@pytest.fixture(scope="module")
def mpeg4_samples(tmp_path_factory):
    """(chunks, extradata) of an MPEG-4 stream cv2's writer wrote."""
    path = tmp_path_factory.mktemp("mpeg4") / "fmp4.avi"
    cv2_write(path, "FMP4", content(H, W, 7, seed=4))
    info = avi.probe_avi(path)
    return [bytes(c) for c in avi.frame_chunks(path, info)], info.extra


LAYOUTS = {
    "xiph lacing": dict(lace=3, lacing="xiph"),
    "ebml lacing": dict(lace=3, lacing="ebml"),
    "fixed lacing": dict(lace=2, lacing="fixed"),
    "block groups": dict(block_groups=True, keys=[0]),
    "unknown clusters": dict(unknown_cluster=True, per_cluster=2),
    "unknown segment": dict(unknown_segment=True, unknown_cluster=True),
    "crc and void": dict(crc=True, void=True),
    "webm": dict(doctype="webm"),
}


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_ebml_layouts_equal_cv2(tmp_path, name, monkeypatch):
    """The element and block layouts FFmpeg's demuxer reads."""
    path = tmp_path / "layout.mkv"
    frames = jpegs()
    if name == "fixed lacing":      # one size for every frame
        size = max(map(len, frames))
        frames = [f[:-2] + b"\0" * (size - len(f)) + f[-2:] for f in frames]
    mjpeg(path, frames, **LAYOUTS[name])
    if name == "webm":
        assert containers.probe_video(path).container == "webm"
    assert_like_cv2(path, monkeypatch)


@pytest.mark.parametrize("algo,scope", [("strip", 1), ("zlib", 1),
                                        ("strip", 3), ("zlib", 3)])
def test_content_encodings_equal_cv2(tmp_path, algo, scope, mpeg4_samples,
                                     monkeypatch):
    """Header stripping (of the start code prefix every chunk begins
    with) and zlib on the frames, and with scope 3 on the CodecPrivate
    too."""
    import zlib
    chunks, _ = mpeg4_samples
    # the first chunk's headers (VOS, VO, VOL) as the CodecPrivate
    at = chunks[0].index(b"\0\0\1\xb6")
    extra, chunks = chunks[0][:at], [chunks[0][at:]] + chunks[1:]
    head = b"\0\0\1"
    assert all(c.startswith(head) for c in chunks) and \
        extra.startswith(head)
    private = extra
    if scope & 2:
        private = extra[3:] if algo == "strip" else zlib.compress(extra)
    enc = ("strip", head, scope) if algo == "strip" else ("zlib", scope)
    path = tmp_path / "enc.mkv"
    kw.write_mkv(path, [kw.video_track(chunks, H, W, "V_MPEG4/ISO/ASP",
                                       private, encodings=[enc])])
    assert_like_cv2(path, monkeypatch)


@pytest.mark.parametrize("order", ["audio first", "audio interleaved",
                                   "two video tracks"])
def test_other_tracks_equal_cv2(tmp_path, order, monkeypatch):
    video = kw.video_track(jpegs(), H, W, "V_MJPEG", number=2)
    audio = kw.audio_track([bytes(range(100))] * 6, 1)
    tracks = {"audio first": [audio, video],
              "audio interleaved": [video._replace(number=1),
                                    audio._replace(number=2)],
              "two video tracks": [
                  kw.video_track(jpegs(4, 9), H, W, "V_MJPEG", number=1),
                  video]}[order]
    path = tmp_path / "tracks.mkv"
    kw.write_mkv(path, tracks, per_cluster=2)
    assert_like_cv2(path, monkeypatch)


@pytest.mark.parametrize("pose", [(0, 90), (0, -90), (0, 180), (180, 0),
                                  (180, 90), (0, 0)],
                         ids=["roll 90", "roll -90", "roll 180", "yaw 180",
                              "yaw 180 roll 90", "none"])
def test_projection_turns_the_frames(tmp_path, pose, monkeypatch):
    """A rectangular Projection's pose: FFmpeg 8 makes a display matrix of
    its roll (and of a yaw of 180, a flip), and cv2 turns the frames by
    that matrix's angle."""
    yaw, roll = pose
    path = tmp_path / "pose.mkv"
    mjpeg(path, jpegs(3), track_kw=dict(projection={0x7671: 0, 0x7673: yaw,
                                                    0x7675: roll}))
    assert_like_cv2(path, monkeypatch)


@pytest.mark.parametrize("codec", ["I420", "mpeg4"])
@pytest.mark.parametrize("colour", [(1, 1), (5, 1), (2, 0), (1, 0)],
                         ids=["bt709", "bt601", "unspecified", "bt709 "
                              "range unset"])
def test_colour_equals_cv2(tmp_path, codec, colour, mpeg4_samples,
                           monkeypatch):
    """``Colour`` (MatrixCoefficients, Range 1 broadcast or unset):
    BT.709 converts by BT.709, the others by BT.601."""
    matrix, rng = colour
    tags = {0x55B1: matrix}
    if rng:
        tags[0x55B9] = rng
    path = tmp_path / "colour.mkv"
    if codec == "I420":
        frames = [encode_frame("I420", fw.to_picture(f, "yuv420p"))
                  for f in content(H, W, 3, seed=6)]
        track = kw.video_track(frames, H, W, "V_UNCOMPRESSED",
                               colour=tags, colour_space=b"I420")
    else:
        chunks, extra = mpeg4_samples
        track = kw.video_track(chunks, H, W, "V_MPEG4/ISO/ASP", extra,
                               colour=tags)
    kw.write_mkv(path, [track])
    assert_like_cv2(path, monkeypatch)


@pytest.mark.parametrize("colour", [(0, 0), (9, 0), (0, 2)],
                         ids=["identity", "bt2020", "identity full range"])
def test_rgb_colour_tags_equal_cv2(tmp_path, colour, monkeypatch):
    """``Colour`` on RGB frames (FFV1 ``bgr0``): cv2's conversion takes no
    matrix for them, so any MatrixCoefficients and Range read as
    untagged frames do."""
    matrix, rng = colour
    tags = {0x55B1: matrix}
    if rng:
        tags[0x55B9] = rng
    config = fw.Config("bgr0", slices=(1, 1), gop=3)
    enc = fw.Encoder(config, H, W)
    frames = [enc.encode(fw.to_picture(f, "bgr0"))
              for f in content(H, W, 3, seed=7)]
    path = tmp_path / "rgb colour.mkv"
    kw.write_mkv(path, [kw.video_track(frames, H, W, "V_FFV1",
                                       fw.extradata(config), colour=tags)])
    assert containers.probe_video(path).colour[0] == matrix
    assert_like_cv2(path, monkeypatch)


@pytest.mark.parametrize("tag", ["XVID", "FMP4", "DIVX"])
def test_vfw_mpeg4_equals_cv2(tmp_path, tag, mpeg4_samples, monkeypatch):
    """MPEG-4 under ``V_MS/VFW/FOURCC``: the BITMAPINFOHEADER's fourcc is
    the codec tag FFmpeg's bug detection reads (``XVID`` picks the Xvid
    IDCT)."""
    chunks, extra = mpeg4_samples
    path = tmp_path / "vfw.mkv"
    kw.write_mkv(path, [kw.video_track(
        chunks, H, W, "V_MS/VFW/FOURCC", _bih(H, W, tag.encode(), 24,
                                              extra))])
    info = containers.probe_video(path)
    assert avi.mpeg4_params(info) == (tag, extra)
    assert_like_cv2(path, monkeypatch)


# --- refused by name ------------------------------------------------------

def _write_refusal(path, name, mpeg4):
    chunks, extra = mpeg4
    frames = jpegs(3)
    if name == "encrypted":
        mjpeg(path, frames, track_kw=dict(encodings=[("encrypt",)]))
    elif name == "two encodings":
        mjpeg(path, frames, track_kw=dict(encodings=[("zlib", 1),
                                                     ("zlib", 1)]))
    elif name == "bzlib":
        mjpeg(path, frames)
        data = path.read_bytes()
        # ContentCompAlgo 0 -> 1 is written by the writer only for zlib:
        # write a zlib track and patch its algorithm
        mjpeg(path, frames, track_kw=dict(encodings=[("zlib", 1)]))
        data = path.read_bytes()
        at = data.index(bytes.fromhex("42548100"))
        path.write_bytes(data[:at] + bytes.fromhex("42548101") +
                         data[at + 4:])
    elif name == "equirectangular":
        mjpeg(path, frames, track_kw=dict(projection={0x7671: 1}))
    elif name == "pitch":
        mjpeg(path, frames, track_kw=dict(projection={0x7671: 0,
                                                      0x7674: 30.0}))
    elif name == "roll 45":
        mjpeg(path, frames, track_kw=dict(projection={0x7671: 0,
                                                      0x7675: 45.0}))
    elif name == "no colour space":
        kw.write_mkv(path, [kw.video_track([bytes(H * W * 3 // 2)] * 2, H, W,
                                           "V_UNCOMPRESSED")])
    elif name == "tracks after a cluster":
        mjpeg(path, frames)
        data = path.read_bytes()
        t = data.index(bytes.fromhex("1654AE6B"))
        c = data.index(bytes.fromhex("1F43B675"))
        # the Tracks element runs to the first Cluster: move it after
        tracks = data[t:c]
        path.write_bytes(data[:t] + data[c:] + tracks)
    elif name == "block past the end":
        mjpeg(path, frames, per_cluster=1)
        data = path.read_bytes()
        path.write_bytes(data[:-len(frames[-1]) // 2])
    elif name == "empty frame":
        mjpeg(path, [frames[0], b"", frames[2]])
    elif name == "avc":
        kw.write_mkv(path, [kw.video_track([b"\0\0\0\1" + bytes(20)] * 2, H,
                                           W, "V_MPEG4/ISO/AVC")])
    elif name == "hevc":
        kw.write_mkv(path, [kw.video_track([b"\0\0\0\1" + bytes(20)] * 2, H,
                                           W, "V_MPEGH/ISO/HEVC")])
    elif name == "full range":
        kw.write_mkv(path, [kw.video_track(chunks, H, W, "V_MPEG4/ISO/ASP",
                                           extra, colour={0x55B1: 5,
                                                          0x55B9: 2})])
    elif name == "BI_RGB":
        kw.write_mkv(path, [kw.video_track(
            [bytes(H * W * 3)] * 2, H, W, "V_MS/VFW/FOURCC",
            _bih(H, W, b"\0\0\0\0", 24))])
    else:
        raise ValueError(name)


REFUSALS = {
    "encrypted": "is encrypted",
    "two encodings": "2 content encodings",
    "bzlib": "compressed by bzlib",
    "equirectangular": "projection of type 1",
    "pitch": "pitch 30",
    "roll 45": "roll of 45 degrees",
    "no colour space": "ColourSpace 'none'",
    "tracks after a cluster": "Tracks come after its first Cluster",
    "block past the end": "past the end of the file",
    "empty frame": "sample 1 is empty",
    "avc": r"V_MPEG4/ISO/AVC\): a CodecPrivate of 0 bytes that is no avcC",
    "hevc": r"Matroska codec 'V_MPEGH/ISO/HEVC'.*needs cv2",
    "full range": "full-range YUV",
    "BI_RGB": "DIB frames under V_MS/VFW/FOURCC",
}


@pytest.mark.parametrize("name", list(REFUSALS))
def test_refused_by_name_before_any_decode(tmp_path, name, mpeg4_samples,
                                           monkeypatch):
    """What the port does not read as cv2 reads it raises a ValueError
    naming it before any frame is decoded; a codec it has no decoder of
    names the codec and the container and says it needs cv2."""
    path = tmp_path / "refused.mkv"
    _write_refusal(path, name, mpeg4_samples)
    monkeypatch.setitem(sys.modules, "cv2", None)
    for entry in ("mpeg4_decode_bgr_batch", "jpeg_decode_bgr_batch",
                  "raw_decode_bgr_batch"):
        monkeypatch.setattr(tvideo.native, entry, _no_decode)
    with pytest.raises(ValueError, match=REFUSALS[name]):
        list(tvideo.video_frame_generator(path))


def _no_decode(*args, **kw):
    raise AssertionError("a frame was decoded")
