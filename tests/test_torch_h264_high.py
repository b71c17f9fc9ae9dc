"""The port's H.264 decoder on Main and High profile I and P slices
(CABAC, the 8x8 transform and Intra 8x8, scaling matrices, explicit
weighted prediction) against ``cv2.VideoCapture``, libavcodec's planes,
the writer's reconstruction and the JAX package, on the CPU.

The streams come from ``tests/_torch_h264_writer.py`` (``high_config``,
``high_sink``: seeded choices over every tool; its encoder
``tests/_torch_h264_enc.cpp`` codes CABAC with its own arithmetic
engine).  The writer shares the decoder's stream layer and its code and
context tables, so every stream is held to cv2, whose decoder is FFmpeg's
own, and the context tables to cv2's libavcodec.  Tolerances:

* every frame of the plain version, of ``native.h264_decode_bgr_batch``
  and of the port's ``video_frame_generator`` (cv2 blocked; AVI, MP4,
  MOV and Matroska) equals cv2's bit for bit, and the planes equal
  libavcodec's and the writer's reconstruction;
* one stream codes with every context a frame-coded 4:2:0 I or P slice
  can use (Table 9-34: ctxIdx 3-23, 40-69, 73-275, 399-435), I_PCM inside
  a slice, mvds past the UEG3 prefix and levels past the prefix of
  coeff_abs_level_minus1; others every Intra 8x8 mode, the 8x8
  transform on P macroblocks in CAVLC and in CABAC, every
  luma_log2_weight_denom, reference indices up to 15 and mb_qp_delta -26
  and +25;
* the four context-init tables equal libavcodec's pair for pair;
* ``welford_algorithm``, ``process_video`` and ``batch_video_to_hdr`` on
  High clips equal the JAX package's (``decoder="cv2"``): bit for bit on
  the host backend, rtol 1e-10 (std 1e-9) for the HDR merge;
* the committed ``tests/data/h264 high *`` clips decode to their
  ``.cv2.npy`` (``python -m tests.test_torch_h264_high`` rewrites them).
"""
from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
cv2 = pytest.importorskip("cv2")

from camera_linearity_tpu_torch import native  # noqa: E402
from camera_linearity_tpu_torch.models import video as tvideo  # noqa: E402
from camera_linearity_tpu_torch.native import h264_plain as hp  # noqa: E402
from camera_linearity_tpu_torch.utils import avi, containers  # noqa: E402
from camera_linearity_tpu_torch.utils import observability as obs  # noqa
from tests import _torch_h264_writer as hw  # noqa: E402
from tests import _torch_libavcodec as lav  # noqa: E402
from tests.test_torch_h264 import cv2_frames, native_frames  # noqa: E402

DATA = Path(__file__).resolve().parent / "data"

_L16 = (4, 9, 13, 17, 22, 25, 31, 36, 40, 44, 51, 57, 60, 66, 70, 77)
_L64 = tuple(6 + (7 * k) % 70 for k in range(64))
# (values in zigzag order, "default", None: not present; short lists
# repeat their last value)
SPS_LISTS = (_L16, None, "default", None, (20,) * 5, None, _L64, None)
PPS_LISTS = (None, (30, 12, 40), None, "default", None, _L16[::-1],
             None, "default")

# name: (height, width, high_config keywords, plans)
CASES = {
    "CABAC sink": (48, 64, {}, "sink"),
    "CABAC coverage": (48, 64, {}, "coverage"),
    "CABAC, 4x4 transform only": (48, 64, dict(transform_8x8=False), "sink"),
    "CAVLC, 8x8 transform and weights": (48, 64, dict(cabac=False), "sink"),
    "Main profile CABAC": (48, 64, dict(profile=77, transform_8x8=False),
                           "sink"),
    "Intra 8x8, every mode": (48, 64, {}, "i8"),
    "Intra 8x8 CAVLC, every mode": (48, 64, dict(cabac=False), "i8"),
    "one MB wide": (48, 16, {}, "sink"),
    "cropped 1080-style": (40, 96, dict(crop=(0, 0, 0, 8)), "sink"),
    "16 references": (32, 32, dict(num_ref_frames=16, log2_max_frame_num=5),
                      "many"),
    "mb_qp_delta -26": (48, 64, {}, "dqp26"),
    "mb_qp_delta +25": (48, 64, dict(cabac=False), "dqp25"),
    "SPS matrices": (48, 64, dict(sps_lists=SPS_LISTS), "sink"),
    "PPS matrices, rule A": (48, 64, dict(pps_lists=PPS_LISTS), "sink"),
    "SPS and PPS matrices, rule B": (48, 64, dict(sps_lists=SPS_LISTS,
                                                  pps_lists=PPS_LISTS),
                                     "sink"),
    "default matrices": (48, 64, dict(sps_lists=("default",) * 8), "sink"),
    "8x8-free PPS with matrices": (48, 64, dict(
        transform_8x8=False, sps_lists=SPS_LISTS, pps_lists=PPS_LISTS[:6]),
        "sink"),
    "CAVLC matrices": (48, 64, dict(cabac=False, sps_lists=SPS_LISTS,
                                    pps_lists=PPS_LISTS), "sink"),
    "weighted_bipred_idc in a P-only stream": (48, 64, dict(
        weighted_bipred=1), "sink"),
    "second chroma offset": (48, 64, dict(cqp=3, tweaks=(
        ("second_cqp", -5),)), "sink"),
    "constrained intra": (48, 64, dict(cip=True), "sink"),
    "no weights": (48, 64, dict(weighted=False), "sink"),
}


def _plans(kind: str, seed: int):
    if kind == "sink":
        return hw.high_sink(seed)
    if kind == "coverage":
        return hw.high_coverage_plans()
    if kind == "i8":
        o = hw.Options(seed=seed, p_i8=1000, p_i16=0, p_pcm=0,
                       p_random_mode=1000, p_intra=600)
        return [hw.PicPlan("IDR", 3, 30, slices=(0, 5), opts=o),
                hw.PicPlan("I", 2, 24, opts=o)] + [
            hw.PicPlan("P", 2, 28, opts=o, cabac_init_idc=k)
            for k in range(3)]
    if kind == "many":
        o = hw.Options(seed=seed, search=1)
        wts = hw.weight_plans(18, seed, 16)
        return [hw.PicPlan("IDR", 3, 30, opts=o)] + [
            hw.PicPlan("P", 2, 30, num_ref=min(k + 1, 16), opts=o,
                       cabac_init_idc=k % 3, weights=wts[k])
            for k in range(18)]
    step = {"dqp26": 26, "dqp25": 25}[kind]
    o = hw.Options(seed=seed, p_dqp=1000, qp_min=0, qp_max=51,
                   qp_step=step, p_i16=700, p_skip=0, p_pcm=0)
    return [hw.PicPlan("IDR", 3, 26, opts=o)] + [
        hw.PicPlan("P", 2, 26, opts=o) for _ in range(3)]


_STREAMS: dict = {}


def stream(name: str):
    """(samples as Annex B bytes, NAL samples, parameter sets,
    reconstruction, counts, height, width) of case ``name``, written once
    a process."""
    if name not in _STREAMS:
        h, w, kw, kind = CASES[name]
        seed = hw.HIGH_COVERAGE_SEED if kind == "coverage" else \
            list(CASES).index(name)
        plans = _plans(kind, seed)
        samples, params, recons, counts = hw.encode(
            hw.scene(len(plans), h, w, seed), hw.high_config(h, w, **kw),
            plans)
        _STREAMS[name] = ([hw.annexb(s) for s in samples], samples, params,
                          recons, counts,
                          *hp.geometry(hp.parse_sps(hp.to_rbsp(params[0]))))
    return _STREAMS[name]


def _port_frames(path, monkeypatch) -> np.ndarray:
    with monkeypatch.context() as m:
        m.setitem(sys.modules, "cv2", None)
        return np.stack([f.copy() for f in tvideo.video_frame_generator(path)
                         if f is not None])


@pytest.mark.parametrize("name", list(CASES))
def test_native_plain_and_port_equal_cv2(tmp_path, name, monkeypatch):
    """Native (all samples a call, on every core), plain, the port's frame
    generator (cv2 blocked) and the writer's reconstruction give cv2's
    frames bit for bit."""
    data, samples, params, recons, _, h, w = stream(name)
    path = tmp_path / "high.avi"
    hw.write_h264_avi(path, samples, h, w)
    ref = cv2_frames(path)
    assert len(ref) == len(data)
    assert avi.h264_unsupported(path, avi.probe_avi(path)) is None
    np.testing.assert_array_equal(native_frames(data, h, w), ref)
    np.testing.assert_array_equal(np.stack(hp.decode_bgr(data)), ref)
    np.testing.assert_array_equal(_port_frames(path, monkeypatch), ref)
    matrix = hp.matrix_name(hp.parse_sps(hp.to_rbsp(params[0])))
    for got, planes in zip(ref, recons):
        np.testing.assert_array_equal(native.rawvideo_plain.decode_bgr(
            hp.i420_bytes(planes), "i420_left", h, w, matrix=matrix), got)


@pytest.mark.parametrize("per_call,threads", [(1, 1), (4, 3)])
def test_native_calls_and_threads(per_call, threads):
    """One sample a call on one thread, four a call on three: the frames
    of all at once on every core (slices and GOPs side by side)."""
    data, _, _, _, _, h, w = stream("CABAC sink")
    np.testing.assert_array_equal(
        native_frames(data, h, w, per_call, threads),
        native_frames(data, h, w))


@pytest.mark.parametrize("name", ["CABAC sink", "CABAC coverage",
                                  "CAVLC, 8x8 transform and weights",
                                  "SPS and PPS matrices, rule B"])
def test_planes_equal_libavcodec(tmp_path, name):
    """The plain decoder's yuv420p planes equal libavcodec's (before
    cv2's conversion) and the writer's reconstruction."""
    if not lav.available():
        pytest.skip("cv2's libavcodec is not found")
    data, samples, _, recons, _, h, w = stream(name)
    path = tmp_path / "high.avi"
    hw.write_h264_avi(path, samples, h, w)
    got = hp.decode_planes(data)
    want = lav.decode_planes(path)
    assert len(want) == len(got)
    for (fmt, planes), mine, rec in zip(want, got, recons):
        assert fmt == "yuv420p"
        for a, b, c in zip(planes, mine, rec):
            np.testing.assert_array_equal(a[:b.shape[0], :b.shape[1]], b)
            np.testing.assert_array_equal(b, c)


KINDS = ["avi", "mp4 avc1", "mp4 avc3", "mov avc1", "mkv avc"]


@pytest.mark.parametrize("kind", KINDS)
def test_containers(tmp_path, kind, monkeypatch):
    """The High sink in each container the port reads gives cv2's frames
    through the frame generator (cv2 blocked)."""
    _, samples, params, _, _, h, w = stream("CABAC sink")
    path = tmp_path / f"clip.{kind.split()[0]}"
    if kind == "avi":
        hw.write_h264_avi(path, samples, h, w, tag="X264")
    elif kind == "mkv avc":
        hw.write_h264_mkv(path, samples, params, h, w)
    else:
        hw.write_h264_mp4(path, samples, params, h, w,
                          fourcc=kind.split()[1].encode(),
                          qt=kind.startswith("mov"))
    info = containers.probe_video(path)
    assert (info.height, info.width) == (h, w)
    np.testing.assert_array_equal(_port_frames(path, monkeypatch),
                                  cv2_frames(path))


# the contexts a frame-coded 4:2:0 I or P slice can use (Table 9-34)
CONTEXTS = set(range(3, 24)) | set(range(40, 70)) | set(range(73, 276)) | \
    set(range(399, 436))


def test_coverage_reaches_every_context():
    """The CABAC coverage stream (held to cv2 above) codes with every
    context of CONTEXTS, holds I_PCM macroblocks inside its CABAC slices,
    mvds past the UEG3 prefix, levels past coeff_abs_level_minus1's
    prefix and every QP 0-51; the other streams every Intra 8x8 mode,
    8x8-transform P macroblocks in CAVLC and CABAC, reference index 15
    and mb_qp_delta -26 and +25."""
    cov = hw.coverage(stream("CABAC coverage")[4])
    missing = sorted(i for i in CONTEXTS if not cov["ctx"][i])
    assert missing == []
    assert cov["pcm_cabac"][0] and cov["mvd_escape"][0] and \
        cov["abs_escape"][0]
    assert cov["qp"].all()
    i8 = sum(hw.coverage(stream(n)[4])["i8"] for n in
             ("Intra 8x8, every mode", "Intra 8x8 CAVLC, every mode"))
    assert i8.all()
    assert hw.coverage(stream("CAVLC, 8x8 transform and weights")[4])[
        "t8"][0] > 0
    assert hw.coverage(stream("CABAC sink")[4])["t8"][1] > 0
    assert hw.coverage(stream("16 references")[4])["ref"][15] > 0
    assert hw.coverage(stream("mb_qp_delta -26")[4])["dqp"][0] > 0
    assert hw.coverage(stream("mb_qp_delta +25")[4])["dqp"][51] > 0


def test_weights_reach_every_denominator():
    """The sink's weight tables take every luma_log2_weight_denom and
    chroma_log2_weight_denom 0-7, weights below zero, and its last
    picture's list holds one picture twice, weighted two ways."""
    plans = hw.high_sink(0)
    tables = [p.weights for p in plans if p.weights]
    wts = hw.weight_plans(8)
    assert {t[0] for t in wts} == set(range(8)) == {t[1] for t in wts}
    assert any(e[0] and e[0][0] < 0 for t in tables for e in t[2])
    data, _, _, _, _, h, w = stream("CABAC sink")
    st = hp.Stream()
    jobs = [st.next(s) for s in data]
    last = jobs[-1].slices[0]
    assert last.refs[0] is last.refs[1]
    assert last.header.weights[2][0] != last.header.weights[2][1]


def test_context_tables_equal_libavcodec():
    """The port's four context-init tables (I; P at cabac_init_idc 0-2),
    in h264.cpp and h264_plain.py, equal cv2's libavcodec's pair for pair
    (four 2048-byte int8 tables back to back; I is the one with no
    context of P slices' syntax, ctxIdx 11-59)."""
    path = lav._find("libavcodec")
    if path is None:
        pytest.skip("cv2's libavcodec is not found")
    blob = path.read_bytes()
    sig = np.array([20, -15, 2, 54, 3, 74, 20, -15, 2, 54, 3, 74, -28, 127,
                    -23, 104, -6, 53, -1, 54, 7, 51], np.int8).tobytes()
    at = blob.find(sig)
    assert at >= 0
    lib = np.frombuffer(blob[at:at + 4 * 2048], np.int8).reshape(4, 1024, 2)
    assert all(blob[at + 2048 * k:].startswith(sig) for k in range(4))
    i_table = [k for k in range(4) if not lib[k, 11:60].any()]
    assert len(i_table) == 1
    order = i_table + [k for k in range(4) if k != i_table[0]]
    plain = np.array(hp.CABAC_INIT, np.int8).reshape(4, 460, 2)
    src = (Path(hp.__file__).parent / "h264.cpp").read_text()
    body = src[src.index("kCabacInit[4][460][2] = {"):]
    body = body[body.index("{") + 1:body.index("};")]
    cpp = np.array([int(v) for v in body.replace("{", " ").replace(
        "}", " ").replace(",", " ").split()], np.int8).reshape(4, 460, 2)
    for k in range(4):
        np.testing.assert_array_equal(plain[k], lib[order[k], :460])
        np.testing.assert_array_equal(cpp[k], lib[order[k], :460])


# ---------------------------------------------------------------- JAX

def test_welford_and_process_video_equal_jax(tmp_path, monkeypatch):
    """``welford_algorithm`` on a High MP4 with cv2 blocked equals the JAX
    package's with ``decoder="cv2"`` bit for bit (host backend; rtol
    1e-9 on the device backend), and ``process_video`` writes the same
    statistics beside the video."""
    jvideo = pytest.importorskip("camera_linearity_tpu.models.video")
    monkeypatch.delenv("CL_DECODER", raising=False)
    _, samples, params, _, _, h, w = stream("CABAC sink")
    path = tmp_path / "scene 5ms.mp4"
    hw.write_h264_mp4(path, samples, params, h, w)
    want = jvideo.welford_algorithm(path, use_std=True, decoder="cv2")
    with monkeypatch.context() as m:
        m.setitem(sys.modules, "cv2", None)
        obs.reset_stage_times()
        got = tvideo.welford_algorithm(path, use_std=True)
        assert obs.decoded_frames.snapshot() == {"h264": len(samples)}
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
    """The slice as a whole: two scenes of three High exposures (MP4 and
    Matroska, CABAC and CAVLC, one of several slices a picture) through
    the port's pipeline with cv2 blocked, against the JAX package's, which
    reads them with cv2."""
    jnp = pytest.importorskip("jax.numpy")
    from camera_linearity_tpu.models import pipeline as jpipe
    from camera_linearity_tpu_torch.models import pipeline as tpipe
    monkeypatch.delenv("CL_DECODER", raising=False)
    h, w = 32, 48
    icrf = np.linspace(0, 1, 256)[:, None].repeat(3, 1) ** \
        np.array([2.0, 2.2, 2.4])
    scenes = {}
    for s, (name, ext) in enumerate((("a", "mp4"), ("b", "mkv"))):
        (tmp_path / name).mkdir()
        paths = []
        for k, ms in enumerate((4, 8, 16)):
            o = hw.Options(seed=10 * s + k)
            plans = [hw.PicPlan("IDR", 3, 26, opts=o)] + [
                hw.PicPlan("P", 2, 28, slices=(0, 3) if k == 1 else (),
                           opts=o, cabac_init_idc=j % 3,
                           weights=hw.weight_plans(5, k)[j])
                for j in range(5)]
            pics = hw.scene(6, h, w, 10 * s + k)
            pics = [tuple(np.clip(p.astype(int) * (k + 1) // 3 + 10 * k, 0,
                                  255).astype(np.uint8) if i == 0 else p
                          for i, p in enumerate(pic)) for pic in pics]
            samples, params, _, _ = hw.encode(
                pics, hw.high_config(h, w, cabac=s == 0), plans)
            path = tmp_path / name / f"{name} {ms}ms.{ext}"
            if ext == "mp4":
                hw.write_h264_mp4(path, samples, params, h, w)
            else:
                hw.write_h264_mkv(path, samples, params, h, w)
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


# ---------------------------------------------------------------- clips

def _clip_streams():
    """The committed High clips: (file name, writer) pairs."""
    h, w = 48, 64

    def sink_mp4(path):
        plans = hw.high_sink(4)
        samples, params, _, _ = hw.encode(hw.scene(len(plans), h, w, 4),
                                          hw.high_config(h, w), plans)
        hw.write_h264_mp4(path, samples, params, h, w)

    def matrices_mkv(path):
        plans = hw.high_sink(5)
        samples, params, _, _ = hw.encode(
            hw.scene(len(plans), h, w, 5),
            hw.high_config(h, w, cabac=False, sps_lists=SPS_LISTS,
                           pps_lists=PPS_LISTS), plans)
        hw.write_h264_mkv(path, samples, params, h, w)
    return [("h264 high cabac 5ms.mp4", sink_mp4),
            ("h264 high matrices cavlc 5ms.mkv", matrices_mkv)]


CLIPS = [name for name, _ in _clip_streams()]


@pytest.mark.parametrize("clip", CLIPS)
def test_committed_clip(clip, monkeypatch):
    """A committed High clip decodes (through the port's pipeline with cv2
    blocked) to its .cv2.npy, which is cv2's frames of it here; each stays
    under 100 KB."""
    path = DATA / clip
    want = np.load(path.with_suffix(".cv2.npy"))
    assert path.stat().st_size < 100_000
    np.testing.assert_array_equal(cv2_frames(path), want)
    np.testing.assert_array_equal(_port_frames(path, monkeypatch), want)


def write_clips() -> None:
    """Write the committed High clips and their cv2 frames."""
    for name, write in _clip_streams():
        path = DATA / name
        write(path)
        np.save(path.with_suffix(".cv2.npy"), cv2_frames(path))


if __name__ == "__main__":
    write_clips()
