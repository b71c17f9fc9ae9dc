"""H.264 in the containers the port reads, and through its pipeline, on
the CPU: AVI (every fourcc FFmpeg maps to h264 that cv2 opens; the
parameter sets in band or in the extradata), MP4 and QuickTime MOV
(``avc1``, ``avc3``; NAL lengths of 1, 2 and 4 bytes), Matroska
(``V_MPEG4/ISO/AVC`` with its avcC, and ``V_MS/VFW/FOURCC`` of Annex B
frames), each decoded through ``video_frame_generator`` with cv2 blocked
and held to ``cv2.VideoCapture`` bit for bit; the colour tags of the
container against the VUI's; ``welford_algorithm`` and ``video_to_hdr``
on an H.264 MP4 against the same calls on an I420 AVI of the writer's
reconstruction, and ``welford_algorithm`` against the JAX package's with
``decoder="cv2"``; decoding imports no JAX.
"""
from __future__ import annotations

import struct
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
cv2 = pytest.importorskip("cv2")

from camera_linearity_tpu.models import video as jvideo  # noqa: E402
from camera_linearity_tpu_torch.models import pipeline as tpipe  # noqa
from camera_linearity_tpu_torch.models import video as tvideo  # noqa: E402
from camera_linearity_tpu_torch.native import h264_plain as hp  # noqa: E402
from camera_linearity_tpu_torch.utils import containers  # noqa: E402
from camera_linearity_tpu_torch.utils import observability as obs  # noqa
from tests import _torch_h264_writer as hw  # noqa: E402
from tests import _torch_mkv_writer as kw  # noqa: E402
from tests import _torch_mp4_writer as mw  # noqa: E402
from tests._torch_rawvideo_writer import write_raw_avi  # noqa: E402
from tests.test_torch_h264 import cv2_frames  # noqa: E402

H, W = 48, 64
_MEMO: dict = {}


def _stream(config_kw=(), seed: int = 3, n: int = 12):
    key = (tuple(config_kw), seed, n)
    if key not in _MEMO:
        plans = hw.kitchen_sink(seed)[:n]
        _MEMO[key] = hw.encode(hw.scene(len(plans), H, W, seed),
                               hw.Config(H, W, **dict(config_kw)), plans)
    return _MEMO[key]


def _port_frames(path, monkeypatch) -> np.ndarray:
    with monkeypatch.context() as m:
        m.setitem(sys.modules, "cv2", None)
        assert tvideo._resolve_decoder("native", [path], H, W, 3) == ["h264"]
        return np.stack([f.copy() for f in tvideo.video_frame_generator(path)
                         if f is not None])


@pytest.mark.parametrize("tag", list(hp.H264_FOURCCS))
def test_avi_fourcc(tmp_path, tag, monkeypatch):
    """Every AVI fourcc the port routes to its H.264 decoder is one cv2
    opens as H.264, and the port gives its frames."""
    samples, _, _, _ = _stream()
    path = tmp_path / "tag.avi"
    hw.write_h264_avi(path, samples, H, W, tag=tag)
    np.testing.assert_array_equal(_port_frames(path, monkeypatch),
                                  cv2_frames(path))


def _write(kind: str, path: Path, samples, params) -> None:
    if kind == "avi extradata":
        hw.write_h264_avi(path, samples, H, W, extradata=hw.annexb(params))
    elif kind == "mp4 avc1":
        hw.write_h264_mp4(path, samples, params, H, W)
    elif kind == "mp4 avc3":
        hw.write_h264_mp4(path, samples, params, H, W, fourcc=b"avc3")
    elif kind == "mov avc1":
        hw.write_h264_mp4(path, samples, params, H, W, qt=True)
    elif kind == "mp4 2-byte lengths":
        hw.write_h264_mp4(path, samples, params, H, W, size=2)
    elif kind == "mkv avc":
        hw.write_h264_mkv(path, samples, params, H, W)
    elif kind == "mkv 2-byte lengths":
        hw.write_h264_mkv(path, samples, params, H, W, size=2)
    elif kind == "mkv vfw":
        bih = struct.pack("<IiiHH4sIiiII", 40, W, H, 1, 24, b"H264", 0, 0,
                          0, 0, 0)
        kw.write_mkv(path, [kw.video_track([hw.annexb(s) for s in samples],
                                           H, W, "V_MS/VFW/FOURCC", bih)])
    else:
        raise ValueError(kind)


KINDS = ["avi extradata", "mp4 avc1", "mp4 avc3", "mov avc1",
         "mp4 2-byte lengths", "mkv avc", "mkv 2-byte lengths", "mkv vfw"]


@pytest.mark.parametrize("kind", KINDS)
def test_containers(tmp_path, kind, monkeypatch):
    """The same stream in each container gives cv2's frames."""
    samples, params, _, _ = _stream()
    suffix = kind.split()[0]
    path = tmp_path / f"clip.{suffix}"
    _write(kind, path, samples, params)
    info = containers.probe_video(path)
    assert (info.height, info.width) == (H, W)
    np.testing.assert_array_equal(_port_frames(path, monkeypatch),
                                  cv2_frames(path))


def test_one_byte_lengths(tmp_path, monkeypatch):
    """NAL units of 1-byte lengths (an avcC's lengthSizeMinusOne 0): a
    stream whose NAL units are all under 256 bytes."""
    h, w = 16, 32
    o = hw.Options(p_pcm=0, seed=1)
    plans = [hw.PicPlan("IDR", 3, 44, opts=o)] + [
        hw.PicPlan("P", 2, 46, opts=o) for _ in range(3)]
    samples, params, _, _ = hw.encode(hw.scene(4, h, w), hw.Config(h, w),
                                      plans)
    assert max(len(n) for s in samples for n in s) < 256
    path = tmp_path / "one.mp4"
    hw.write_h264_mp4(path, samples, params, h, w, size=1)
    with monkeypatch.context() as m:
        m.setitem(sys.modules, "cv2", None)
        got = np.stack([f.copy() for f in tvideo.video_frame_generator(path)
                        if f is not None])
    np.testing.assert_array_equal(got, cv2_frames(path))


# VUI colour description (matrix) and the container's colr matrix
COLOURS = {"colr BT.709, no VUI colour": (None, 1),
           "colr BT.709, VUI BT.601": (6, 1),
           "colr BT.601, VUI BT.709": (1, 6),
           "colr BT.709, VUI unspecified": (2, 1)}


@pytest.mark.parametrize("name", list(COLOURS))
def test_colour_tags(tmp_path, name, monkeypatch):
    """The VUI's colour description, where there is one, converts the
    frames (unspecified as BT.601); else the container's tags do."""
    vui, colr = COLOURS[name]
    samples, params, _, _ = _stream((("matrix", vui),) if vui is not None
                                    else (), n=4)
    path = tmp_path / "colour.mp4"
    hw.write_h264_mp4(path, samples, params, H, W,
                      children=[mw.colr_nclx(colr, colr, colr, False)])
    np.testing.assert_array_equal(_port_frames(path, monkeypatch),
                                  cv2_frames(path))


def test_full_range_container_tag_refused(tmp_path, monkeypatch):
    """A container's full-range tag over a stream whose VUI says nothing
    is refused by name (the frames would convert at full range)."""
    samples, params, _, _ = _stream(n=2)
    path = tmp_path / "full.mp4"
    hw.write_h264_mp4(path, samples, params, H, W,
                      children=[mw.colr_nclx(1, 1, 6, True)])
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ValueError, match="full-range YUV"):
        list(tvideo.video_frame_generator(path))


def test_hevc_still_needs_cv2(tmp_path, monkeypatch):
    """An HEVC file still goes to cv2; without cv2 the message names the
    codecs the port reads, H.264 among them."""
    samples, params, _, _ = _stream(n=2)
    path = tmp_path / "hevc.mp4"
    mw.write_mp4(path, [mw.video_track([hw.length_prefixed(s) for s in
                                        samples], H, W, b"hvc1")])
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ValueError, match=r"'hvc1'.*needs cv2.*H\.264 \("):
        list(tvideo.video_frame_generator(path))


def _recon_avi(path: Path, recons) -> None:
    write_raw_avi(path, [hp.i420_bytes(r) for r in recons], H, W, "I420")


def test_welford_equals_recon_avi_and_jax(tmp_path, monkeypatch):
    """``welford_algorithm`` (host backend) on an H.264 MP4, cv2 blocked,
    equals the same call on an I420 AVI of the writer's reconstruction
    and the JAX package's with ``decoder="cv2"`` bit for bit."""
    monkeypatch.delenv("CL_DECODER", raising=False)
    samples, params, recons, _ = _stream()
    mp4 = tmp_path / "scene 5ms.mp4"
    hw.write_h264_mp4(mp4, samples, params, H, W)
    raw = tmp_path / "raw" / "scene 5ms.avi"
    raw.parent.mkdir()
    _recon_avi(raw, recons)
    want = jvideo.welford_algorithm(mp4, use_std=True, decoder="cv2")
    with monkeypatch.context() as m:
        m.setitem(sys.modules, "cv2", None)
        obs.reset_stage_times()
        got = tvideo.welford_algorithm(mp4, use_std=True)
        assert obs.decoded_frames.snapshot() == {"h264": 12}
        ref = tvideo.welford_algorithm(raw, use_std=True)
    for key in ("mean", "std"):
        np.testing.assert_array_equal(got[key], want[key])
        np.testing.assert_array_equal(got[key], ref[key])


def test_video_to_hdr_equals_recon_avi(tmp_path, monkeypatch):
    """The slice as a whole: ``video_to_hdr`` of three H.264 videos (an
    MP4, an Annex B AVI and a Matroska file, one of several slices a
    picture) equals the same call on I420 AVIs of the writer's
    reconstruction, bit for bit."""
    monkeypatch.delenv("CL_DECODER", raising=False)
    icrf = np.linspace(0, 1, 256)[:, None].repeat(3, 1) ** \
        np.array([2.0, 2.2, 2.4])
    (tmp_path / "h264").mkdir()
    (tmp_path / "raw").mkdir()
    coded, raws = [], []
    for k, ms in enumerate((4, 8, 16)):
        plans = [hw.PicPlan("IDR", 3, 26, opts=hw.Options(seed=k))] + [
            hw.PicPlan("P", 2, 28, slices=(0, 5) if k == 1 else (),
                       opts=hw.Options(seed=k)) for _ in range(5)]
        pics = hw.scene(6, H, W, k)
        pics = [tuple(np.clip(p.astype(int) * (k + 1) // 3 + 10 * k, 0,
                              255).astype(np.uint8) if i == 0 else p
                      for i, p in enumerate(pic)) for pic in pics]
        samples, params, recons, _ = hw.encode(pics, hw.Config(H, W), plans)
        path = tmp_path / "h264" / f"s {ms}ms.{('mp4', 'avi', 'mkv')[k]}"
        if k == 0:
            hw.write_h264_mp4(path, samples, params, H, W)
        elif k == 1:
            hw.write_h264_avi(path, samples, H, W)
        else:
            hw.write_h264_mkv(path, samples, params, H, W)
        raw = tmp_path / "raw" / f"s {ms}ms.avi"
        _recon_avi(raw, recons)
        coded.append(path)
        raws.append(raw)
    monkeypatch.setitem(sys.modules, "cv2", None)
    got = tpipe.video_to_hdr(coded, icrf, device="cpu")
    want = tpipe.video_to_hdr(raws, icrf, device="cpu")
    np.testing.assert_array_equal(got.measurand.val.numpy(),
                                  want.measurand.val.numpy())
    np.testing.assert_array_equal(got.measurand.std.numpy(),
                                  want.measurand.std.numpy())


def test_decoding_imports_no_jax():
    """Decoding the committed H.264 clips, native and plain, imports no
    JAX, cv2, PIL or matplotlib."""
    root = Path(__file__).resolve().parent.parent
    code = (
        "import sys, numpy as np\n"
        "from camera_linearity_tpu_torch.models import video\n"
        "from camera_linearity_tpu_torch.native import h264_plain\n"
        "from camera_linearity_tpu_torch.utils import containers\n"
        "for p in sorted(__import__('pathlib').Path('tests/data')"
        ".glob('h264 *')):\n"
        "    if p.suffix == '.npy': continue\n"
        "    got = [f for f in video.video_frame_generator(p) "
        "if f is not None]\n"
        "    assert (np.stack(got) == np.load(p.with_suffix('.cv2.npy')))"
        ".all(), p\n"
        "    info = containers.probe_video(p)\n"
        "    chunks = [bytes(c) for c in containers.frame_chunks(p, info)]\n"
        "    h264_plain.decode_planes(chunks[:2], info.extra)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'cv2', 'PIL', 'matplotlib', 'camera_linearity_tpu')]\n"
        "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
