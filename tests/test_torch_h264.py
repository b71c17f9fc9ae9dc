"""The port's H.264 decoder (``native/h264.cpp`` and its plain version
``native/h264_plain.py``) against ``cv2.VideoCapture``, libavcodec's
planes and the writer's reconstruction, on the CPU.

cv2's FFmpeg here decodes H.264 but has no H.264 encoder, so the streams
come from ``tests/_torch_h264_writer.py`` (its encoder,
``tests/_torch_h264_enc.cpp``, makes seeded choices over every
Constrained Baseline tool).  The writer shares the decoder's stream layer
and code tables, so every stream is held to cv2, whose decoder is
FFmpeg's own.  Tolerances:

* every frame of the plain version, of ``native.h264_decode_bgr_batch``
  (one thread and several, one sample a call and all of them) and of the
  port's ``video_frame_generator`` (cv2 blocked) equals cv2's bit for bit,
  and the planes equal libavcodec's and the writer's reconstruction;
* one stream writes every CAVLC table entry (every coeff_token of each
  nC class and of chroma DC, every total_zeros and run_before, the
  level_prefix escapes 14, 15 and 16) and every QP 0-51, and is held to
  cv2;
* every refused tool raises a ValueError naming it, before any decode
  where the parameter sets or the first slice header show it, naming the
  frame (and the slice and the macroblock) where a later sample does;
* the committed ``tests/data/h264 *`` clips decode to their ``.cv2.npy``
  (``python -m tests.test_torch_h264`` rewrites them), which
  ``chip_smoke.py`` holds the port to on the card's machine.

The containers, the pipeline and the JAX package's cv2 path are in
``tests/test_torch_h264_containers.py``.
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
from camera_linearity_tpu_torch.utils import avi  # noqa: E402
from tests import _torch_h264_writer as hw  # noqa: E402
from tests import _torch_libavcodec as lav  # noqa: E402

DATA = Path(__file__).resolve().parent / "data"


def cv2_frames(path) -> np.ndarray:
    cap = cv2.VideoCapture(str(path))
    out = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        out.append(frame)
    cap.release()
    return np.stack(out) if out else np.zeros((0,), np.uint8)


# name: (height, width, Config keywords, plans); the plans' seed is the
# case's number
CASES = {
    "kitchen sink 64x48": (48, 64, {}, "sink"),
    "cropped 72x40 of 80x48": (40, 72, dict(crop=(0, 8, 0, 8)), "sink"),
    "one MB wide": (48, 16, {}, "sink"),
    "poc type 1": (48, 64, dict(poc_type=1), "sink"),
    "poc type 2": (64, 48, dict(poc_type=2), "sink"),
    "constrained intra, chroma offset": (48, 64, dict(cip=True, cqp=7),
                                         "sink"),
    "negative chroma offset": (48, 64, dict(cqp=-12), "sink"),
    "redundant count, bottom POC": (48, 64, dict(redundant_present=True,
                                                 bottom_poc=True), "sink"),
    "left crop 64": (48, 94, dict(crop=(64, 2, 0, 0)), "sink"),
    "1080-style bottom crop": (40, 96, dict(crop=(0, 0, 0, 8)), "sink"),
    "top crop": (46, 64, dict(crop=(0, 0, 2, 0)), "sink"),
    "main profile": (48, 64, dict(profile=77, constraints=0), "sink"),
    "high profile, second chroma offset": (
        48, 64, dict(profile=100, constraints=0, cqp=2,
                     tweaks=(("second_cqp", -4),)), "sink"),
    "no deblocking control": (48, 64, dict(deblock_control=False), "sink"),
    "ids 3 and 7": (48, 64, dict(sps_id=3, pps_id=7), "sink"),
    "coverage": (48, 64, {}, "coverage"),
    "long-term IDR": (48, 64, dict(num_ref_frames=2), "long"),
    "16 references": (32, 32, dict(num_ref_frames=16, log2_max_frame_num=5),
                      "many"),
    "full range": (48, 64, dict(full_range=True), "sink"),
    "BT.709 VUI": (48, 64, dict(matrix=1), "sink"),
    "wrapping frame_num and POC": (32, 48, dict(log2_max_poc_lsb=4),
                                   "long GOP"),
    "no VUI": (48, 64, dict(reorder=None), "sink"),
    "a reorder delay of 2": (48, 64, dict(reorder=2), "sink"),
}


def _plans(kind: str, seed: int):
    if kind == "sink":
        return hw.kitchen_sink(seed)
    if kind == "coverage":
        return hw.coverage_plans()
    if kind == "long":
        o = hw.Options(seed=seed)
        return [hw.PicPlan("IDR", 3, 28, long_term=True, opts=o)] + [
            hw.PicPlan("P", 2, 28 + k % 5, num_ref=2 if k else 1, opts=o)
            for k in range(5)]
    if kind == "many":
        o = hw.Options(seed=seed, search=1)
        return [hw.PicPlan("IDR", 3, 30, opts=o)] + [
            hw.PicPlan("P", 2, 30, num_ref=min(k + 1, 16), opts=o)
            for k in range(18)]
    o = hw.Options(seed=seed, p_intra=20)
    return [hw.PicPlan("IDR", 3, 30, opts=o)] + [
        hw.PicPlan("P", 2 if k % 3 else 0, 30, opts=o) for k in range(20)]


_STREAMS: dict = {}


def stream(name: str):
    """(samples as Annex B bytes, parameter sets, reconstruction, counts,
    height, width) of case ``name``, written once a process."""
    if name not in _STREAMS:
        h, w, kw, kind = CASES[name]
        # the coverage stream's content is the committed clip's
        seed = hw.COVERAGE_SEED if kind == "coverage" else \
            list(CASES).index(name)
        plans = _plans(kind, seed)
        samples, params, recons, counts = hw.encode(
            hw.scene(len(plans), h, w, seed), hw.Config(h, w, **kw), plans)
        _STREAMS[name] = ([hw.annexb(s) for s in samples], params, recons,
                          counts, *hp.geometry(hp.parse_sps(hp.to_rbsp(
                              params[0]))))
    return _STREAMS[name]


def _avi(tmp_path, name: str) -> Path:
    samples, _, _, _, h, w = stream(name)
    path = tmp_path / "h264.avi"
    hw.write_h264_avi(path, [[s] for s in samples], h, w)
    return path


def native_frames(samples, h: int, w: int, per_call: int = 0,
                  threads=None) -> np.ndarray:
    dec = native.H264Decoder()
    out = np.zeros((len(samples), h, w, 3), np.uint8)
    n = 0
    step = per_call or len(samples)
    for at in range(0, len(samples), step):
        n += native.h264_decode_bgr_batch(samples[at:at + step], out[n:],
                                          dec, threads=threads)
    return out[:n]


@pytest.mark.parametrize("name", list(CASES))
def test_native_and_plain_equal_cv2(tmp_path, name):
    """Native (all samples a call, on every core), plain and the writer's
    reconstruction give cv2's frames bit for bit."""
    samples, _, recons, _, h, w = stream(name)
    path = _avi(tmp_path, name)
    ref = cv2_frames(path)
    assert len(ref) == len(samples)
    np.testing.assert_array_equal(native_frames(samples, h, w), ref)
    sps = hp.parse_sps(hp.to_rbsp(stream(name)[1][0]))
    plain = hp.decode_bgr(samples)
    np.testing.assert_array_equal(np.stack(plain), ref)
    matrix = hp.matrix_name(sps)
    for got, planes in zip(ref, recons):
        want = native.rawvideo_plain.decode_bgr(
            hp.i420_bytes(planes), "i420_left", h, w, matrix=matrix)
        np.testing.assert_array_equal(want, got)


@pytest.mark.parametrize("per_call,threads", [(1, 1), (3, 2), (0, 1)])
def test_native_calls_and_threads(per_call, threads):
    """One sample a call, three a call, all on one thread: the same
    frames as all at once on every core."""
    samples, _, _, _, h, w = stream("kitchen sink 64x48")
    np.testing.assert_array_equal(
        native_frames(samples, h, w, per_call, threads),
        native_frames(samples, h, w))


def test_gops_side_by_side(tmp_path):
    """A batch of several GOPs (a thread each) and a picture of several
    slices (a thread each) give the frames decoded one at a time."""
    h, w = 48, 64
    o = hw.Options(seed=5)
    plans = []
    for g in range(4):
        plans += [hw.PicPlan("IDR", 3, 26 + g, slices=(0, 3, 7), opts=o),
                  hw.PicPlan("P", 2, 28, slices=(0, 6), opts=o),
                  hw.PicPlan("P", 0, 30, opts=o)]
    samples, _, recons, _ = hw.encode(hw.scene(len(plans), h, w, 5),
                                      hw.Config(h, w), plans)
    data = [hw.annexb(s) for s in samples]
    path = tmp_path / "gops.avi"
    hw.write_h264_avi(path, samples, h, w)
    ref = cv2_frames(path)
    np.testing.assert_array_equal(native_frames(data, h, w, threads=8), ref)
    np.testing.assert_array_equal(native_frames(data, h, w, 1, 1), ref)


@pytest.mark.parametrize("name", ["kitchen sink 64x48", "coverage",
                                  "cropped 72x40 of 80x48", "full range"])
def test_planes_equal_libavcodec(tmp_path, name):
    """The plain decoder's yuv420p planes equal libavcodec's (before
    cv2's conversion)."""
    if not lav.available():
        pytest.skip("cv2's libavcodec is not found")
    samples, _, recons, _, h, w = stream(name)
    got = hp.decode_planes(samples)
    want = lav.decode_planes(_avi(tmp_path, name))
    assert len(want) == len(got)
    for (fmt, planes), mine, rec in zip(want, got, recons):
        assert fmt == ("yuvj420p" if name == "full range" else "yuv420p")
        for a, b, c in zip(planes, mine, rec):
            np.testing.assert_array_equal(a[:b.shape[0], :b.shape[1]], b)
            np.testing.assert_array_equal(b, c)


def test_every_cavlc_table_entry_and_qp():
    """The coverage stream (held to cv2 by
    test_native_and_plain_equal_cv2) writes every coeff_token of every nC
    class and chroma DC, every total_zeros and run_before, the
    level_prefix escapes 14, 15 and 16, and every QP 0-51 on coded
    macroblocks; and every macroblock kind, partition and mode."""
    counts = stream("coverage")[3]
    assert hw.missing_codes(counts) == []
    cov = hw.coverage(counts)
    assert cov["qp"].all()
    assert cov["kind"][1:6].all()      # inter, skip, I4, I16, PCM
    assert cov["ptype"].all() and cov["sub"].all()
    assert cov["i4"].all() and cov["i16"].all() and cov["chroma"].all()
    assert cov["far"][0] > 0


def test_code_tables_prefix_free():
    """The code tables are prefix codes (a wrong transcription usually is
    not); cv2 holds their values."""
    def check(pairs):
        codes = [format(c, f"0{n}b") for n, c in pairs if n]
        assert len(set(codes)) == len(codes)
        for a in codes:
            assert not any(b != a and b.startswith(a) for b in codes)
        assert sum(2.0 ** -len(c) for c in codes) <= 1
    for cls in range(4):
        check([(hp.TOKEN_LEN[cls][i], hp.TOKEN_CODE[cls][i])
               for i in range(68) if i & 3 <= i >> 2])
    check([(hp.DC_TOKEN_LEN[i], hp.DC_TOKEN_CODE[i]) for i in range(20)
           if i & 3 <= i >> 2])
    for lens, codes in zip(hp.ZEROS_LEN + hp.DC_ZEROS_LEN + hp.RUN_LEN,
                           hp.ZEROS_CODE + hp.DC_ZEROS_CODE + hp.RUN_CODE):
        check(list(zip(lens, codes)))


# ---------------------------------------------------------------- refusals

def _base(config_kw=None):
    h, w = 48, 64
    cfg = hw.Config(h, w, **(config_kw or {}))
    plans = [hw.PicPlan("IDR", 3, 28), hw.PicPlan("P", 2, 28,
                                                  slices=(0, 6)),
             hw.PicPlan("P", 0, 28), hw.PicPlan("P", 0, 28)]
    samples, params, _, _ = hw.encode(hw.scene(4, h, w), cfg, plans)
    return cfg, samples, params


def _with_params(samples, sps=None, pps=None):
    """The samples with the first one's in-band SPS / PPS replaced."""
    first = [sps if (n[0] & 31) == 7 and sps else pps
             if (n[0] & 31) == 8 and pps else n for n in samples[0]]
    return [first] + samples[1:]


def _refusal(name: str):
    """(samples, match, frame the refusal names or None: before any
    decode)."""
    cfg, samples, params = _base()
    sps_of = lambda **kw: hw.parameter_sets(cfg._replace(**kw))[0]
    pps_of = lambda **kw: hw.parameter_sets(cfg._replace(**kw))[1]
    high = dict(profile=100, constraints=0)
    if name == "CABAC":
        return _with_params(samples, pps=pps_of(tweaks=(("cabac", 1),))), \
            "CABAC", None
    if name == "slice groups":
        return _with_params(samples, pps=pps_of(
            tweaks=(("slice_groups", 2),))), "slice groups", None
    if name == "weighted prediction":
        return _with_params(samples, pps=pps_of(
            tweaks=(("weighted", 1),))), "weighted prediction", None
    if name == "8x8 transform":
        return _with_params(samples, sps_of(**high), pps_of(
            **high, tweaks=(("transform_8x8", 1),))), "8x8 transform", None
    if name == "PPS scaling matrices":
        return _with_params(samples, sps_of(**high), pps_of(
            **high, tweaks=(("pic_scaling", 1),))), "scaling matrices", None
    if name == "SPS scaling matrices":
        return _with_params(samples, sps_of(**high, tweaks=(
            ("scaling", 1),))), "scaling matrices", None
    if name == "10-bit":
        return _with_params(samples, sps_of(**high, tweaks=(
            ("bit_depth", 10),))), "bit depth of 10", None
    if name == "4:2:2":
        return _with_params(samples, sps_of(**high, tweaks=(
            ("chroma_format", 2),))), "chroma_format_idc 2", None
    if name == "lossless":
        return _with_params(samples, sps_of(**high, tweaks=(
            ("bypass", 1),))), "qpprime_y_zero_transform_bypass", None
    if name == "interlaced":
        return _with_params(samples, sps_of(tweaks=(
            ("frame_mbs_only", 0),))), "interlaced coding", None
    if name == "left crop 8":
        return _with_params(samples, sps_of(crop=(8, 0, 0, 0))), \
            "left crop of 8", None
    if name == "BT.2020":
        return _with_params(samples, sps_of(matrix=9)), \
            "matrix_coefficients 9", None
    if name == "full-range BT.709":
        return _with_params(samples, sps_of(full_range=True, matrix=1)), \
            "full-range BT.709", None
    if name in ("B slice", "SP slice", "SI slice"):
        kind = name.split()[0]
        bad = hw.slice_nal(cfg, hw.PicPlan(kind, 2, 28))
        return [samples[0], [bad]], f"{kind} slices", 1
    if name == "B slice first":
        bad = hw.slice_nal(cfg, hw.PicPlan("B", 2, 28))
        return [samples[0][:2] + [bad]], "B slices", None
    if name == "redundant picture":
        cfg, samples, _ = _base(dict(redundant_present=True))
        bad = hw.slice_nal(cfg, hw.PicPlan("P", 2, 28, redundant=1))
        return [samples[0], [bad]], "redundant pictures", 1
    if name == "data partitioning":
        return [samples[0], [bytes([0x22, 0x80])] + samples[1]], \
            "data partitioning", 1
    if name == "gap in frame_num":
        return [samples[0], samples[2]], "gap in frame_num", 1
    if name == "POC that decreases":
        return [samples[0], samples[1], samples[3], samples[2]], \
            "does not increase", 3
    if name == "no IDR first":
        return [samples[0][:2] + samples[1]], "does not start with an IDR", \
            None
    if name == "two pictures a sample":
        return [samples[0], samples[1] + samples[2]], \
            "holds two pictures", 1
    if name == "truncated slice":
        cut = samples[1][0][:len(samples[1][0]) // 2]
        return [samples[0], [cut, samples[1][1]]], \
            r"frame 1: slice 0, macroblock \(\d+, \d+\)", 1
    if name == "missing slice":
        return [samples[0], samples[1][:1]], \
            r"frame 1: slice 0, macroblock \(2, 1\): macroblocks no slice", 1
    raise ValueError(name)


REFUSALS = ["CABAC", "slice groups", "weighted prediction", "8x8 transform",
            "PPS scaling matrices", "SPS scaling matrices", "10-bit", "4:2:2",
            "lossless", "interlaced", "left crop 8", "BT.2020",
            "full-range BT.709", "B slice", "SP slice", "SI slice",
            "B slice first", "redundant picture", "data partitioning",
            "gap in frame_num", "POC that decreases", "no IDR first",
            "two pictures a sample", "truncated slice", "missing slice"]


def _no_decode(*args, **kw):
    raise AssertionError("a frame was decoded")


@pytest.mark.parametrize("name", REFUSALS)
def test_refusal_names_the_tool(tmp_path, name, monkeypatch):
    """Each refused tool raises a ValueError naming it: before any decode
    where the parameter sets or the first slice header show it (the
    frame decoders blocked), else naming the frame; the plain decoder
    names it too."""
    samples, match, frame = _refusal(name)
    path = tmp_path / "refused.avi"
    hw.write_h264_avi(path, samples, 48, 64)
    monkeypatch.setitem(sys.modules, "cv2", None)
    if frame is None:
        info = avi.probe_avi(path)
        assert info.codec in avi.H264_CODECS
        assert avi.h264_unsupported(path, info) is not None
        for entry in ("h264_decode_bgr_batch", "raw_decode_bgr_batch"):
            monkeypatch.setattr(tvideo.native, entry, _no_decode)
    with pytest.raises(ValueError, match=match) as exc:
        list(tvideo.video_frame_generator(path))
    if frame is not None:
        assert f"frame {frame}" in str(exc.value)
    with pytest.raises(hp.H264Error, match=match):
        hp.decode_planes([hw.annexb(s) for s in samples])


# ---------------------------------------------------------------- clips

def _clip_streams():
    """The committed clips: (file name, writer) pairs."""
    h, w = 48, 64

    def coverage(path):
        samples, params, _, _ = hw.encode(
            hw.scene(12, h, w, hw.COVERAGE_SEED), hw.Config(h, w),
            hw.coverage_plans())
        hw.write_h264_mp4(path, samples, params, h, w)

    def sink_avi(path):
        samples, _, _, _ = hw.encode(hw.scene(12, 40, 72, 1),
                                     hw.Config(40, 72, crop=(0, 8, 0, 8),
                                               poc_type=1),
                                     hw.kitchen_sink(1))
        hw.write_h264_avi(path, samples, 40, 72)

    def slices_mkv(path):
        samples, params, _, _ = hw.encode(
            hw.scene(12, h, w, 2), hw.Config(h, w, poc_type=2, cip=True,
                                             cqp=-3),
            hw.kitchen_sink(2))
        hw.write_h264_mkv(path, samples, params, h, w)

    def full_avc3(path):
        samples, params, _, _ = hw.encode(
            hw.scene(12, h, w, 3), hw.Config(h, w, full_range=True),
            hw.kitchen_sink(3))
        hw.write_h264_mp4(path, samples, params, h, w, fourcc=b"avc3")
    return [("h264 coverage 5ms.mp4", coverage),
            ("h264 sink cropped 5ms.avi", sink_avi),
            ("h264 slices 5ms.mkv", slices_mkv),
            ("h264 full range avc3 5ms.mp4", full_avc3)]


CLIPS = [name for name, _ in _clip_streams()]


@pytest.mark.parametrize("clip", CLIPS)
def test_committed_clip(clip, monkeypatch):
    """A committed clip decodes (native, and through the port's pipeline
    with cv2 blocked) to its .cv2.npy, which is cv2's frames of it here;
    each stays under 100 KB."""
    path = DATA / clip
    want = np.load(path.with_suffix(".cv2.npy"))
    assert path.stat().st_size < 100_000
    np.testing.assert_array_equal(cv2_frames(path), want)
    monkeypatch.setitem(sys.modules, "cv2", None)
    got = np.stack([f.copy() for f in tvideo.video_frame_generator(path)
                    if f is not None])
    np.testing.assert_array_equal(got, want)


def write_clips() -> None:
    """Write the committed clips and their cv2 frames."""
    for name, write in _clip_streams():
        path = DATA / name
        write(path)
        np.save(path.with_suffix(".cv2.npy"), cv2_frames(path))


if __name__ == "__main__":
    write_clips()
