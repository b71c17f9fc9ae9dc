"""The port's video containers beside AVI, QuickTime MOV, MP4 and Matroska
(``utils/containers.py``, ``utils/mp4.py``, ``utils/mkv.py``), against
``cv2.VideoCapture`` and the JAX package, on the CPU.

What ``cv2.VideoWriter`` writes into ``.mp4``, ``.mov`` and ``.mkv`` (cv2
5.0, FFmpeg 8: ``mp4v``, MJPEG, PNG and FFV1 into all three; HuffYUV and
UtVideo into MOV and, under ``V_MS/VFW/FOURCC``, Matroska; uncompressed
``RGBA`` into MOV and Matroska and I420 into Matroska; MPEG-4 under
``XVID`` and ``DIVX`` tags into MOV) is read with cv2 blocked and held to
cv2's frames and ``CAP_PROP`` geometry bit for bit; I420 in a MOV, which
cv2 does not open, raises as the JAX package raises.  The same bitstream
muxed as an AVI and as an MP4, MOV or Matroska file (``tests/_torch_mp4_
writer.py``, ``tests/_torch_mkv_writer.py``) gives the same frames.  The
JAX package's ``welford_algorithm`` (``decoder="cv2"``) equals the port's
on an ``.mp4`` and an ``.mkv`` bit for bit (host backend; rtol 1e-9 on the
device backend), ``process_video`` writes it beside the video (named
``<stem>.<key>.tif``: the JAX package's name would overwrite the video),
and ``batch_video_to_hdr`` equals the JAX package's at rtol 1e-10 (std
1e-9).
"""
from __future__ import annotations

import shutil
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
cv2 = pytest.importorskip("cv2")

import jax.numpy as jnp  # noqa: E402

from camera_linearity_tpu.models import pipeline as jpipe  # noqa: E402
from camera_linearity_tpu.models import video as jvideo  # noqa: E402
from camera_linearity_tpu_torch.__main__ import main as tmain  # noqa: E402
from camera_linearity_tpu_torch.models import pipeline as tpipe  # noqa
from camera_linearity_tpu_torch.models import video as tvideo  # noqa: E402
from camera_linearity_tpu_torch.utils import avi, containers  # noqa: E402
from camera_linearity_tpu_torch.utils import observability as obs  # noqa
from tests import _torch_ffv1_writer as fw  # noqa: E402
from tests import _torch_mkv_writer as kw  # noqa: E402
from tests import _torch_mp4_writer as mw  # noqa: E402
from tests._torch_mjpeg_writer import encode_jpeg, write_mjpg_avi  # noqa
from tests._torch_png_writer import encode_png, write_png_avi  # noqa: E402
from tests._torch_rawvideo_writer import encode_frame, write_raw_avi  # noqa

H, W = 32, 48


def content(h: int = H, w: int = W, n: int = 5, seed: int = 0):
    """Moving smooth BGR frames with noise."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    out = []
    for t in range(n):
        img = (np.sin((xx + 3 * t) / 6.0) + np.cos((yy - 2 * t) / 4.0)) * 70
        img = np.stack([img, np.roll(img, 5, 1), np.roll(img, 9, 0)], -1)
        img = img + 128 + rng.normal(0, 8, (h, w, 3))
        out.append(np.clip(img, 0, 255).astype(np.uint8))
    return out


def cv2_write(path: Path, fourcc: str, frames) -> None:
    h, w = frames[0].shape[:2]
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*fourcc), 25,
                             (w, h))
    assert writer.isOpened(), (path, fourcc)
    for f in frames:
        writer.write(f)
    writer.release()


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


def cv2_geometry(path):
    cap = cv2.VideoCapture(str(path))
    geo = (int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT)),
           int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)))
    cap.release()
    return geo


def port_frames(path, monkeypatch, decoder: str = "native") -> np.ndarray:
    """The port's frames of ``path`` with cv2 blocked."""
    with monkeypatch.context() as m:
        m.setitem(sys.modules, "cv2", None)
        frames = list(tvideo.video_frame_generator(path, decoder=decoder))
    assert frames[-1] is None
    return np.stack(frames[:-1]) if len(frames) > 1 else \
        np.zeros((0,), np.uint8)


def assert_like_cv2(path, monkeypatch, decoder: str = "native") -> None:
    """The port (cv2 blocked) gives cv2's frames bit for bit, as many, and
    ``probe_geometry`` gives cv2's ``CAP_PROP`` geometry."""
    want = cv2_frames(path)
    assert len(want), path
    got = port_frames(path, monkeypatch, decoder)
    assert got.shape == want.shape, (path, got.shape, want.shape)
    np.testing.assert_array_equal(got, want, err_msg=str(path))
    with monkeypatch.context() as m:
        m.setitem(sys.modules, "cv2", None)
        assert tvideo.probe_geometry(path) == cv2_geometry(path)


# --- what cv2.VideoWriter writes ------------------------------------------

CV2_WRITTEN = [("mp4", f) for f in ("mp4v", "MJPG", "png ", "FFV1")] + \
    [("mov", f) for f in ("mp4v", "MJPG", "png ", "FFV1", "HFYU", "FFVH",
                          "ULY0", "RGBA", "XVID", "DIVX")] + \
    [("mkv", f) for f in ("mp4v", "MJPG", "png ", "FFV1", "HFYU", "FFVH",
                          "ULY0", "MPNG", "I420", "RGBA")]


@pytest.mark.parametrize("ext,fourcc", CV2_WRITTEN,
                         ids=[f"{e}-{f.strip()}" for e, f in CV2_WRITTEN])
def test_cv2_written_files_equal_cv2(tmp_path, ext, fourcc, monkeypatch):
    """Each container and codec cv2's writer writes here: the frame
    generator with cv2 blocked gives cv2's frames, and ``probe_geometry``
    cv2's geometry, at a size that is a multiple of 16 and at one that is
    not."""
    for h, w in ((H, W), (26, 38)):
        path = tmp_path / f"{fourcc.strip()} {h}.{ext}"
        cv2_write(path, fourcc, content(h, w, seed=h))
        info = containers.probe_video(path)
        assert info.container == ext
        assert_like_cv2(path, monkeypatch)


def test_raw_i420_mov_fails_as_with_cv2(tmp_path, monkeypatch):
    """cv2 writes I420 into a MOV as ``raw `` of depth 12, which FFmpeg has
    no pixel format for: cv2 does not open it, so the JAX package raises a
    ValueError, and so does the port, naming why, before any decode."""
    path = tmp_path / "i420 5ms.mov"
    cv2_write(path, "I420", content())
    assert not len(cv2_frames(path))
    with pytest.raises(ValueError, match="Unable to open"):
        jvideo.welford_algorithm(path, use_std=True, decoder="cv2")
    with monkeypatch.context() as m:
        m.setitem(sys.modules, "cv2", None)
        with pytest.raises(ValueError, match="'raw ' of depth 12.*cv2 does "
                                             "not open it"):
            tvideo.welford_algorithm(path, use_std=True)


# --- the same bitstream in every container ---------------------------------

def _streams(kind: str, frames):
    """(samples, mp4 video_track kwargs, mkv (codec id, private, kwargs),
    avi writer) of ``frames`` coded as ``kind``."""
    h, w = frames[0].shape[:2]
    if kind == "MJPG":
        s = [encode_jpeg(f) for f in frames]
        return s, dict(fourcc=b"jpeg", qt=True), ("V_MJPEG", b"", {}), \
            lambda p: write_mjpg_avi(p, s, h, w)
    if kind == "PNG":
        s = [encode_png(f[..., ::-1], 2) for f in frames]
        return s, dict(fourcc=b"png ", qt=True), (
            "V_MS/VFW/FOURCC", _bih(h, w, b"MPNG", 24), {}), \
            lambda p: write_png_avi(p, s, h, w)
    if kind == "I420":
        s = [encode_frame("I420", fw.to_picture(f, "yuv420p")) for f in
             frames]
        return s, dict(fourcc=b"I420", depth=12), (
            "V_UNCOMPRESSED", b"", dict(colour_space=b"I420")), \
            lambda p: write_raw_avi(p, s, h, w, "I420")
    if kind == "FFV1":
        config = fw.Config("yuv420p", slices=(2, 2), gop=3)
        enc = fw.Encoder(config, h, w)
        s = [enc.encode(fw.to_picture(f, "yuv420p")) for f in frames]
        extra = fw.extradata(config)
        return s, dict(fourcc=b"FFV1", children=[mw.glbl(extra)]), (
            "V_FFV1", extra, {}), \
            lambda p: fw.write_stream_avi(p, s, config, h, w)
    raise ValueError(kind)


def _bih(h: int, w: int, fourcc: bytes, bits: int, extra: bytes = b""
         ) -> bytes:
    import struct
    return struct.pack("<IiiHH4sIiiII", 40 + len(extra), w, h, 1, bits,
                       fourcc, w * h * 3, 0, 0, 0, 0) + extra


def mux(path: Path, kind: str, samples, mp4_kw: dict, mkv: tuple,
        h: int, w: int) -> None:
    """``samples`` into ``path`` by its suffix: ``.mp4``/``.mov`` (the test
    muxer's ISO or QuickTime flavour) or ``.mkv``."""
    if path.suffix == ".mkv":
        codec, private, kwargs = mkv
        kw.write_mkv(path, [kw.video_track(samples, h, w, codec, private,
                                           **kwargs)])
        return
    kwargs = dict(mp4_kw)
    fourcc = kwargs.pop("fourcc")
    kwargs["qt"] = path.suffix == ".mov"
    mw.write_mp4(path, [mw.video_track(samples, h, w, fourcc, **kwargs)],
                 qt=path.suffix == ".mov")


@pytest.mark.parametrize("ext", ["mp4", "mov", "mkv"])
@pytest.mark.parametrize("kind", ["MJPG", "PNG", "I420", "FFV1"])
def test_remuxed_streams_give_the_avis_frames(tmp_path, kind, ext,
                                              monkeypatch):
    """A bitstream in an AVI and the same samples in a MOV, MP4 or
    Matroska file: the port gives the same frames from both (no cv2
    involved)."""
    frames = content(26, 38, n=4, seed=3)
    samples, mp4_kw, mkv, write_avi = _streams(kind, frames)
    avi_path = tmp_path / "scene 5ms.avi"
    write_avi(avi_path)
    other = tmp_path / f"scene 5ms.{ext}"
    mux(other, kind, samples, mp4_kw, mkv, 26, 38)
    want = port_frames(avi_path, monkeypatch)
    got = port_frames(other, monkeypatch)
    assert len(want) == len(frames)
    np.testing.assert_array_equal(got, want)


def test_containers_are_told_by_their_first_bytes(tmp_path, monkeypatch):
    """The port probes a file by its first bytes, never by its suffix: an
    MP4 named ``.avi`` and a Matroska file named ``.mp4`` read as what
    they are, and as cv2 reads them."""
    frames = content(n=3)
    a = tmp_path / "a.mp4"
    cv2_write(a, "mp4v", frames)
    b = tmp_path / "b.mkv"
    cv2_write(b, "MJPG", frames)
    for src, name, kind in ((a, "a 5ms.avi", "mp4"), (b, "b 5ms.mp4",
                                                       "mkv")):
        dst = tmp_path / name
        shutil.copy(src, dst)
        assert containers.probe_video(dst).container == kind
        np.testing.assert_array_equal(port_frames(dst, monkeypatch),
                                      cv2_frames(src))
    junk = tmp_path / "junk.mp4"
    junk.write_bytes(b"not a video at all")
    assert containers.probe_video(junk) is None


# --- process_video's names --------------------------------------------------

@pytest.mark.parametrize("name,want", [
    ("scene 5ms.avi", ("scene 5ms.mean.tif", "scene 5ms.std.tif")),
    ("scene 5ms.mp4", ("scene 5ms.mean.tif", "scene 5ms.std.tif")),
    ("scene 5ms.AVI", ("scene 5ms.mean.tif", "scene 5ms.std.tif")),
    ("take.avi.mkv", ("take.avi.mean.tif", "take.avi.std.tif"))])
def test_process_video_never_writes_over_the_video(tmp_path, name, want,
                                                   monkeypatch):
    """A name ending in ``.avi`` keeps the JAX package's output names
    (``.avi`` replaced by ``.<key>.tif``); any other becomes
    ``<stem>.<key>.tif``, where the JAX package's replace left the name
    as it was and wrote both TIFFs over the video."""
    path = tmp_path / name
    fourcc = "MJPG"
    cv2_write(path if path.suffix.lower() != ".avi" else
              tmp_path / "tmp.avi", fourcc, content(n=3))
    if path.suffix.lower() == ".avi":
        (tmp_path / "tmp.avi").rename(path)
    before = path.read_bytes()
    monkeypatch.setitem(sys.modules, "cv2", None)
    tvideo.process_video(path)
    assert path.read_bytes() == before
    written = sorted(p.name for p in tmp_path.iterdir() if p != path)
    assert written == sorted(want)


# --- the JAX package ------------------------------------------------------

@pytest.mark.parametrize("ext,fourcc", [("mp4", "mp4v"), ("mkv", "FFV1"),
                                        ("mkv", "mp4v")])
def test_welford_and_process_video_equal_jax(tmp_path, ext, fourcc,
                                             monkeypatch):
    """The JAX package's ``welford_algorithm`` with ``decoder="cv2"``
    against the port's with cv2 blocked, on a file cv2 wrote: bit for bit
    on the host backend, rtol 1e-9 on the device backend; the port's
    ``process_video`` writes the same statistics beside the video (the
    JAX package's ``process_video`` would write them over it)."""
    monkeypatch.delenv("CL_DECODER", raising=False)
    path = tmp_path / f"scene 5ms.{ext}"
    cv2_write(path, fourcc, content(24, 40, n=13, seed=7))
    want = jvideo.welford_algorithm(path, use_std=True, decoder="cv2")
    with monkeypatch.context() as m:
        m.setitem(sys.modules, "cv2", None)
        obs.reset_stage_times()
        got = tvideo.welford_algorithm(path, use_std=True)
        assert sum(obs.decoded_frames.snapshot().values()) == 13
        dev = tvideo.welford_algorithm(path, use_std=True, backend="device",
                                       batch_size=4, device="cpu")
        tvideo.process_video(path)
    for key in ("mean", "std"):
        np.testing.assert_array_equal(got[key], want[key])
        np.testing.assert_allclose(dev[key], want[key], rtol=1e-9,
                                   atol=1e-15)
        tif = cv2.imread(str(tmp_path / f"scene 5ms.{key}.tif"),
                         cv2.IMREAD_UNCHANGED)
        np.testing.assert_array_equal(tif, want[key])


def test_batch_video_to_hdr_equals_jax(tmp_path, monkeypatch):
    """The slice as a whole: two scenes of three exposures, one of MP4s
    (``mp4v``) and one of Matroska files (FFV1 and MJPEG), through the
    port's pipeline with cv2 blocked, against the JAX package's, which
    reads them with cv2."""
    monkeypatch.delenv("CL_DECODER", raising=False)
    h, w = 24, 40
    icrf = np.linspace(0, 1, 256)[:, None].repeat(3, 1) ** \
        np.array([2.0, 2.2, 2.4])
    scenes = {}
    for s, (name, ext, fourccs) in enumerate((
            ("a", "mp4", ("mp4v", "mp4v", "mp4v")),
            ("b", "mkv", ("FFV1", "MJPG", "mp4v")))):
        (tmp_path / name).mkdir()
        paths = []
        for k, ms in enumerate((4, 8, 16)):
            path = tmp_path / name / f"{name} {ms}ms.{ext}"
            frames = [np.clip(f.astype(int) * (k + 1) // 3, 0, 255).astype(
                np.uint8) for f in content(h, w, n=6, seed=10 * s + k)]
            cv2_write(path, fourccs[k], frames)
            paths.append(path)
        scenes[name] = paths
    want = jpipe.batch_video_to_hdr(scenes, jnp.asarray(icrf))
    monkeypatch.setitem(sys.modules, "cv2", None)
    got = tpipe.batch_video_to_hdr(scenes, icrf, device="cpu")
    for name in scenes:
        np.testing.assert_allclose(
            got[name].measurand.val.numpy(),
            np.asarray(want[name].measurand.val), rtol=1e-10, atol=1e-14)
        np.testing.assert_allclose(
            got[name].measurand.std.numpy(),
            np.asarray(want[name].measurand.std), rtol=1e-9, atol=1e-14)


@pytest.mark.parametrize("ext,fourcc,kind", [("mp4", "mp4v", "mpeg4"),
                                             ("mkv", "FFV1", "ffv1")])
def test_doctor_names_the_container(tmp_path, capsys, ext, fourcc, kind):
    """``doctor --video`` times the native decoder of an MP4 or Matroska
    file as it does an AVI's, naming the container."""
    path = tmp_path / f"v 5ms.{ext}"
    cv2_write(path, fourcc, content(16, 32, n=3))
    assert tmain(["--device", "cpu", "doctor", "--video", str(path)]) == 0
    out = capsys.readouterr().out
    name = avi.CONTAINER_NAMES[ext]
    for line in (f"container: {name}", f"decode ({kind}, 1 thread(s))",
                 "decode (native)"):
        assert line in out, (line, out)


# --- committed clips --------------------------------------------------------

DATA = Path(__file__).resolve().parent / "data"
# name -> file suffix; each is cv2's writing, or the test muxer's, of
# cv2's samples
CLIPS = {"mp4v": "mp4", "mjpeg": "mov", "ffv1": "mkv", "turned mp4v": "mp4",
         "bvop ctts": "mp4"}


def clip_path(name: str) -> Path:
    return DATA / f"container {name} 5ms.{CLIPS[name]}"


def write_clip(name: str, path: Path) -> None:
    """A committed clip: cv2's ``mp4v`` MP4, MJPEG MOV and FFV1 Matroska
    file (8 frames of 48 x 64), cv2's ``mp4v`` samples under a 90-degree
    ``tkhd`` matrix, and the test writer's B-VOPs with ``ctts`` and a
    one-frame edit."""
    frames = content(48, 64, n=8, seed=11)
    fourcc = {"mp4v": "mp4v", "mjpeg": "MJPG", "ffv1": "FFV1"}.get(name)
    if fourcc:
        cv2_write(path, fourcc, frames)
        return
    if name == "turned mp4v":
        src = path.with_name("tmp.avi")
        cv2_write(src, "FMP4", frames)
        info = avi.probe_avi(src)
        chunks = [bytes(c) for c in avi.frame_chunks(src, info)]
        src.unlink()
        mw.write_mp4(path, [mw.video_track(chunks, 48, 64, b"mp4v",
                                           [mw.esds(info.extra)],
                                           matrix=mw.rotation_matrix(90))])
        return
    from tests.test_torch_mp4 import bvop_stream
    chunks, times = bvop_stream(xvid=True)
    d = mw.DELTA
    mw.write_mp4(path, [mw.video_track(
        chunks, 32, 48, b"mp4v", [mw.esds(b"")],
        ctts=[(t + 1 - i) * d for i, t in enumerate(times)], sync=[1],
        elst=[(len(chunks) * 40, d, 1.0)])])


@pytest.mark.parametrize("name", list(CLIPS))
def test_committed_clips_decode_to_cv2s_frames(name, monkeypatch):
    """Each committed clip's ``.cv2.npy`` is cv2's frames of it, and the
    port (cv2 blocked) gives them; ``chip_smoke.py`` holds the port to
    them on the card's machine, which has no cv2."""
    path = clip_path(name)
    want = np.load(path.with_suffix(".cv2.npy"))
    np.testing.assert_array_equal(cv2_frames(path), want)
    np.testing.assert_array_equal(port_frames(path, monkeypatch), want)


def write_clips() -> None:
    """Rewrite ``tests/data/container *`` and their ``.cv2.npy``."""
    for name in CLIPS:
        path = clip_path(name)
        write_clip(name, path)
        np.save(path.with_suffix(".cv2.npy"), cv2_frames(path))


if __name__ == "__main__":
    write_clips()
