"""The port's MPEG-4 Part 2 decoder (``native/mpeg4.cpp`` and its plain
version ``native/mpeg4_plain.py``) against ``cv2.VideoCapture`` and the
JAX package, on the CPU.

Clips come from ``cv2.VideoWriter`` (``FMP4``, ``XVID``, ``DIVX``,
``DX50``, ``MP4V``, ``mp4v``, ``XVIX``, ``3IV2``, ``M4S2``: what FFmpeg's
mpeg4 encoder writes, I- and P-VOPs of 1MV, at sizes that are and are not
multiples of 16) and from ``tests/_torch_mpeg4_writer.py``, whose streams
carry what cv2's writer never writes: 4MV, dquant, AC prediction across
quantisers, every ``intra_dc_vlc_thr``, skipped and intra macroblocks in
P-VOPs, video packets with and without HEC, macroblock stuffing, N-VOPs,
vectors past every edge at each ``fcode``, both rounding types over
black, all three TCOEF escapes, odd sizes, a BT.709 signal type, the
headers in the extradata, the user data of DivX 4 and old FFmpeg builds
(whose border FFmpeg replicates at the visible size) and DivX drop
chunks.  Tolerances:

* every frame of the plain version, of ``native.mpeg4_decode_bgr_batch``
  (one thread and several, one frame a call and several, runs from
  several I-VOPs side by side) and of the port's
  ``video_frame_generator`` (cv2 blocked) equals cv2's bit for bit, and so
  does the writer's own reconstruction; where FFmpeg conceals an error or
  fails a chunk, the port raises naming the frame (and the macroblock);
* every refused feature raises a ValueError naming it before any decode
  where the VOL or the first VOP shows it, and naming its frame where a
  later one does;
* the committed ``tests/data/mpeg4 *.avi`` decode to their ``.cv2.npy``
  (``python -m tests.test_torch_mpeg4`` rewrites both), which
  ``chip_smoke.py`` holds the port to on the card's machine;
* ``tests/_torch_mpeg4_enc.cpp`` gives the Python writer's bytes and
  reconstruction for the plans ``chip_smoke.py`` codes its 4K videos with;
* ``welford_algorithm`` and ``process_video`` of the port (host backend),
  cv2 blocked, equal the JAX package's ``decoder="cv2"`` bit for bit on
  AVIs cv2's writer wrote under each fourcc, and ``batch_video_to_hdr``
  the JAX package's at rtol 1e-10 (std 1e-9), as for the other codecs.
"""
from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
cv2 = pytest.importorskip("cv2")

import jax.numpy as jnp  # noqa: E402

from camera_linearity_tpu.models import pipeline as jpipe  # noqa: E402
from camera_linearity_tpu.models import video as jvideo  # noqa: E402
from camera_linearity_tpu_torch import native  # noqa: E402
from camera_linearity_tpu_torch.__main__ import main as tmain  # noqa: E402
from camera_linearity_tpu_torch.models import pipeline as tpipe  # noqa
from camera_linearity_tpu_torch.models import video as tvideo  # noqa: E402
from camera_linearity_tpu_torch.native import mpeg4_plain as mp  # noqa
from camera_linearity_tpu_torch.native import rawvideo_plain  # noqa: E402
from camera_linearity_tpu_torch.utils import avi  # noqa: E402
from camera_linearity_tpu_torch.utils import observability as obs  # noqa
from tests import _torch_mpeg4_writer as mw  # noqa: E402

DATA = Path(__file__).resolve().parent / "data"
FOURCCS = list(mp.MPEG4_FOURCCS)


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


def _chunks(path):
    info = avi.probe_avi(path)
    return [bytes(c) for c in avi.frame_chunks(path, info)], info


def _plain(path) -> np.ndarray:
    chunks, info = _chunks(path)
    return np.stack(mp.decode_bgr(chunks, *avi.mpeg4_params(info),
                                  info.height, info.width))


def _native(path, threads=None, batch=8) -> np.ndarray:
    assert native.mpeg4_available(), native.build_error("_mpeg4")
    chunks, info = _chunks(path)
    h, w = info.height, info.width
    dec = native.Mpeg4Decoder(*avi.mpeg4_params(info), h, w)
    out = []
    dst = np.empty((batch, h, w, 3), np.uint8)
    for at in range(0, len(chunks), batch):
        n = native.mpeg4_decode_bgr_batch(chunks[at:at + batch], dst, dec,
                                          threads=threads)
        out += list(dst[:n].copy())
    if native.mpeg4_flush(dec, dst):
        out.append(dst[0].copy())
    return np.stack(out)


def _port_frames(path):
    frames = list(tvideo.video_frame_generator(path, decoder="native"))
    assert frames[-1] is None
    return np.stack(frames[:-1])


def _check(path, monkeypatch, want=None, recon=None):
    """Plain, native (one thread a frame at a time; four threads 13
    frames a call) and the frame generator (cv2 blocked) give ``want``
    (default: cv2's frames); ``recon``, where given, equals it too."""
    info = avi.probe_avi(path)
    if want is None:
        want = cv2_frames(path)
    assert len(want) and want.shape[1:] == (info.height, info.width, 3)
    if recon is not None:
        np.testing.assert_array_equal(recon, want)
    np.testing.assert_array_equal(_plain(path), want)
    np.testing.assert_array_equal(_native(path, threads=1, batch=1), want)
    np.testing.assert_array_equal(_native(path, threads=4, batch=13), want)
    with monkeypatch.context() as m:
        m.setitem(sys.modules, "cv2", None)
        assert tvideo._resolve_decoder(
            "native", [path], info.height, info.width, 3) == ["mpeg4"]
        np.testing.assert_array_equal(_port_frames(path), want)


def _outcome(fn):
    """A decode's frames, or the text of the ValueError it raised."""
    try:
        return fn()
    except ValueError as exc:
        return str(exc)


# --- cv2's writer ------------------------------------------------------------

def cv2_clip(path, fourcc: str, h: int, w: int, n: int = 14, seed: int = 0):
    """What ``cv2.VideoWriter`` writes under ``fourcc`` for moving content
    with black patches (n frames, a GOP of 12)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*fourcc), 25,
                             (w, h))
    for t in range(n):
        img = (np.sin((xx + 3 * t) / 6.0) + np.cos((yy - 2 * t) / 4.0)) * 70
        img = np.stack([img, np.roll(img, 5, 1), np.roll(img, 9, 0)], -1)
        img = img + 128 + rng.normal(0, 12, (h, w, 3))
        img[(xx // 8 + yy // 8 + t) % 5 == 0] = 0
        writer.write(np.clip(img, 0, 255).astype(np.uint8))
    writer.release()


@pytest.mark.parametrize("size", [(48, 64), (38, 54), (40, 24)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("fourcc", FOURCCS)
def test_cv2_written_streams_equal_cv2(tmp_path, fourcc, size, monkeypatch):
    """What cv2's writer writes (``MP4V`` goes under ``FMP4``), at sizes
    that are and are not multiples of 16: plain, native and the frame
    generator give cv2's frames, two GOPs of them."""
    h, w = size
    path = tmp_path / f"{fourcc.lower()} 5ms.avi"
    cv2_clip(path, fourcc, h, w, seed=h)
    info = avi.probe_avi(path)
    assert info.codec == ("FMP4" if fourcc == "MP4V" else fourcc)
    assert avi.mpeg4_unsupported(path, info) is None
    want = cv2_frames(path)
    assert len(want) == 14
    _check(path, monkeypatch, want)


# --- the writer's streams -------------------------------------------------

def yuv_pictures(h: int, w: int, n: int, seed: int = 0, noise: float = 10.0):
    """(Y, U, V) planes of moving content with black patches (luma and
    chroma 0, where the no-rounding averages are off by one)."""
    rng = np.random.default_rng(seed)
    h2, w2 = (h + 1) // 2, (w + 1) // 2
    out = []
    for t in range(n):
        yy, xx = np.mgrid[0:h, 0:w]
        y = (np.sin((xx + 3 * t) / 5.0) + np.cos((yy - 2 * t) / 3.0)) * 60 + 110
        y = y + rng.normal(0, noise, (h, w))
        y[(xx // 6 + yy // 7 + t) % 4 == 0] = 0
        cy, cx = np.mgrid[0:h2, 0:w2]
        u = 128 + 60 * np.sin((cx - t) / 4.0) + rng.normal(0, noise, (h2, w2))
        v = 128 + 60 * np.cos((cy + t) / 3.0) + rng.normal(0, noise, (h2, w2))
        u[(cx // 4 + t) % 3 == 0] = 0
        out.append(tuple(np.clip(np.rint(p), 0, 255).astype(np.uint8)
                         for p in (y, u, v)))
    return out


def rand_plan(kind, mbh, mbw, rng, fcode=1, quant=8, rounding=0,
              p_intra=0.1, p_4mv=0.3, p_skip=0.15, dquant=False,
              ac_pred=False, packets=None, dc_thr=0, reach=40, stuffing=()):
    """A plan of random macroblock kinds and vectors (within ``reach``
    half pels and the fcode's range)."""
    modes = mvs = None
    if kind == "P":
        r = rng.random((mbh, mbw))
        modes = np.select([r < p_skip, r < p_skip + p_intra,
                           r < p_skip + p_intra + p_4mv],
                          [mw.SKIP, mw.INTRA, mw.INTER4], mw.INTER)
        top = min(16 << (fcode - 1), reach)
        mvs = rng.integers(-top, top, (mbh, mbw, 4, 2))
    return mw.Plan(kind, quant=quant, rounding=rounding, fcode=fcode,
                   dc_thr=dc_thr, modes=modes, mvs=mvs,
                   dquant=rng.integers(-2, 3, (mbh, mbw)) if dquant else None,
                   ac_pred=rng.random((mbh, mbw)) < 0.6 if ac_pred else None,
                   packets=packets or {}, stuffing=stuffing)


def _packets(rng, n, count):
    """Random video packets: their first macroblocks, each with a
    quantiser (or 0: keep it) and HEC or not."""
    at = sorted(rng.choice(np.arange(1, n), size=min(count, n - 1),
                           replace=False))
    return {int(k): (int(rng.integers(0, 2)) * int(rng.integers(1, 32)),
                     bool(rng.integers(0, 2))) for k in at}


def _case(name: str):
    """A writer case: (h, w, plans, Writer kwargs, AVI kwargs)."""
    rng = np.random.default_rng(sum(map(ord, name)))
    h, w = 40, 56
    mbh, mbw = 3, 4
    I = rand_plan("I", mbh, mbw, rng, quant=4)   # noqa: E741
    P = lambda **kw: rand_plan("P", mbh, mbw, rng, **kw)  # noqa: E731
    wkw, akw = {}, {}
    if name == "1mv":
        plans = [I] + [P(p_4mv=0, rounding=t % 2) for t in range(5)]
    elif name == "4mv":
        plans = [I] + [P(p_4mv=0.9, p_skip=0, p_intra=0, rounding=t % 2)
                       for t in range(5)]
    elif name == "skip":
        plans = [I] + [P(p_skip=0.8, rounding=t % 2) for t in range(4)]
    elif name == "intra_in_p":
        plans = [I] + [P(p_intra=0.7, ac_pred=True, quant=5 + 3 * t)
                       for t in range(4)]
    elif name == "dquant":
        plans = [rand_plan("I", mbh, mbw, rng, quant=6, dquant=True)] + \
            [P(dquant=True, quant=3 + 7 * t, rounding=t % 2)
             for t in range(4)]
    elif name == "ac_pred":
        plans = [rand_plan("I", mbh, mbw, rng, quant=q, ac_pred=True,
                           dquant=True) for q in (2, 9, 30)] + \
            [P(p_intra=0.6, ac_pred=True, dquant=True)]
    elif name.startswith("dc_thr"):
        thr = int(name[-1])
        # quantisers on both sides of the threshold, and dquant across it
        at = mp.DC_THRESHOLD[thr]
        qs = sorted({min(max(q, 1), 31) for q in (at - 1, at, at + 1)} |
                    {2, 31})
        plans = [rand_plan("I", mbh, mbw, rng, quant=q, dquant=True,
                           dc_thr=thr, ac_pred=True) for q in qs] + \
            [P(p_intra=0.5, dquant=True, dc_thr=thr, quant=qs[1])]
    elif name == "packets":
        wkw = dict(resync=True)
        plans = [rand_plan("I", mbh, mbw, rng, quant=5, ac_pred=True,
                           dquant=True, packets=_packets(rng, 12, 4))] + \
            [P(fcode=1 + t, dquant=True, ac_pred=True, p_intra=0.3,
               packets=_packets(rng, 12, 3 + t), rounding=t % 2)
             for t in range(4)]
    elif name == "packets_wide":
        # packets that start mid-row over several rows: the first-row rules
        h, w, mbh, mbw = 64, 112, 4, 7
        wkw = dict(resync=True)
        plans = [rand_plan("I", mbh, mbw, rng, quant=5, ac_pred=True,
                           packets={3: (0, True), 11: (9, False),
                                    16: (0, False)})] + \
            [rand_plan("P", mbh, mbw, rng, fcode=2, p_4mv=0.6, p_intra=0.2,
                       ac_pred=True, packets=_packets(rng, 28, 5),
                       rounding=t % 2) for t in range(4)]
    elif name == "stuffing":
        wkw = dict(resync=bool(rng.integers(0, 2)))
        plans = [rand_plan("I", mbh, mbw, rng, stuffing=(0, 5, 11))] + \
            [P(stuffing=(1, 7)) for _ in range(3)]
    elif name == "gops":
        plans = [I, P(), P(), rand_plan("I", mbh, mbw, rng, quant=11), P(),
                 P(), P(), rand_plan("I", mbh, mbw, rng, quant=3), P()]
    elif name.startswith("far_f"):
        f = int(name[-1])
        # vectors to every edge and past it, at the fcode's full range
        plans = [I] + [P(fcode=f, reach=16 << (f - 1), p_4mv=0.5,
                         rounding=t % 2) for t in range(4)]
    elif name == "rounding":
        # flat blocks of 0 and odd values, half-pel vectors of every kind
        yy, xx = np.mgrid[0:h, 0:w]
        cy, cx = np.mgrid[0:(h + 1) // 2, 0:(w + 1) // 2]
        pic = (np.where((xx // 8 + yy // 8) % 2, 0, 1 + 2 * (xx // 8 % 3)),
               np.where((cx // 8 + cy // 8) % 2, 0, 3),
               np.where((cx // 8 + cy // 8) % 2, 5, 0))
        pic = tuple(p.astype(np.uint8) for p in pic)
        plans, pics = [mw.Plan("I", quant=1)], [pic]
        for rnd in (1, 0):
            for v in ((1, 0), (0, 1), (1, 1), (3, 2), (-1, 5)):
                for mode in (mw.INTER, mw.INTER4):
                    mvs = np.zeros((mbh, mbw, 4, 2), np.int64)
                    mvs[..., 0], mvs[..., 1] = v
                    mvs[:, :, 1:] += np.array([[1, 0], [0, 1], [1, 1]])
                    plans.append(mw.Plan("P", quant=31, rounding=rnd,
                                         modes=np.full((mbh, mbw), mode),
                                         mvs=mvs))
                    plans.append(mw.Plan("I", quant=1))
                    pics += [pic, pic]
        return h, w, plans, wkw, akw, pics
    elif name == "escapes":
        plans = [rand_plan("I", mbh, mbw, rng, quant=1),
                 P(quant=1, p_intra=0.3), P(quant=2), P(quant=1, ac_pred=True,
                                                        p_intra=0.5)]
        return h, w, plans, wkw, akw, yuv_pictures(h, w, len(plans), 3, 70)
    elif name == "nvop":
        plans = [I, P(), mw.Plan("N"), P(), mw.Plan("N"), mw.Plan("N"), P()]
    elif name == "nvop_last":
        plans = [I, P(), mw.Plan("N"), P(), mw.Plan("N")]
    elif name == "bt709":
        wkw = dict(signal=(False, 1))
        plans = [I, P(), P()]
    elif name in ("divx4", "ffmpeg_b4600", "divx_tag_vo0"):
        # bug detection: FFmpeg replicates the visible picture's border
        wkw = dict(edge="visible", user_data={
            "divx4": b"DivX412b1234", "ffmpeg_b4600": b"FFmpeg0.4.6b4600",
            "divx_tag_vo0": None}[name])
        if name == "divx_tag_vo0":
            wkw["vol_fields"] = dict(vo_type=0, vol_control=0)
            akw = dict(tag="DIVX")
        plans = [I] + [P(fcode=4, reach=200, p_4mv=0.5, rounding=t % 2)
                       for t in range(4)]
    elif name == "divx5":
        wkw = dict(user_data=b"DivX503b1393")
        plans = [I] + [P(fcode=4, reach=200, p_4mv=0.5) for t in range(3)]
        akw = dict(tag="DX50")
    elif name == "no_user_data":
        wkw = dict(user_data=None)
        akw = dict(tag="DIVX")
        plans = [I] + [P(fcode=3, reach=100) for _ in range(3)]
    elif name == "extradata":
        wkw = dict(headers_in_chunk=False)
        plans = [I, P(), P(), rand_plan("I", mbh, mbw, rng), P()]
    elif name == "drop_chunks":
        wkw = dict(user_data=b"DivX503b1393")
        plans = [I, P(), P(), P()]
    elif name == "empty_chunks":
        plans = [I, P(), P()]
    else:
        raise KeyError(name)
    return h, w, plans, wkw, akw, None


CASES = ["1mv", "4mv", "skip", "intra_in_p", "dquant", "ac_pred"] + \
    [f"dc_thr{t}" for t in range(8)] + \
    ["packets", "packets_wide", "stuffing", "gops"] + \
    [f"far_f{f}" for f in range(1, 8)] + \
    ["rounding", "escapes", "nvop", "nvop_last", "bt709", "divx4",
     "ffmpeg_b4600", "divx_tag_vo0", "divx5", "no_user_data", "extradata",
     "drop_chunks", "empty_chunks"]


def write_case(path, name: str):
    """The case's AVI; returns the frames FFmpeg outputs, as the writer
    reconstructs them (BGR)."""
    h, w, plans, wkw, akw, pics = _case(name)
    if pics is None:
        pics = yuv_pictures(h, w, len(plans), seed=len(name))
    chunks, recons, wr = mw.encode_video(pics, plans, **wkw)
    outputs = []    # the reconstruction FFmpeg outputs for each chunk
    for plan in plans:
        if plan.kind != "N":
            outputs.append(recons[len(outputs)])
    if plans[-1].kind == "N":
        outputs.append(outputs[-1])
    if name == "drop_chunks":
        chunks = chunks[:2] + [b"\x7f"] + chunks[2:] + [b"\x7f"]
    if name == "empty_chunks":
        chunks = chunks[:1] + [b""] + chunks[1:] + [b""]
    extra = wr.headers() if not wr.headers_in_chunk else b""
    mw.write_mpeg4_avi(path, chunks, h, w, extradata=extra, **akw)
    matrix = "bt709" if name == "bt709" else "bt601"
    return np.stack([rawvideo_plain.decode_bgr(
        mp.i420_bytes(r, h, w), "i420_left", h, w, matrix=matrix)
        for r in outputs])


@pytest.mark.parametrize("name", CASES)
def test_writer_streams_equal_cv2(tmp_path, name, monkeypatch):
    """The writer's streams: cv2 decodes them to the writer's own
    reconstruction, and plain, native and the frame generator give cv2's
    frames (N-VOPs give none, but a last one repeats the last frame;
    DivX drop chunks and empty chunks give none)."""
    path = tmp_path / f"{name} 5ms.avi"
    recon = write_case(path, name)
    _check(path, monkeypatch, recon=recon)


@pytest.mark.parametrize("size", [(37, 53), (33, 48), (48, 33), (17, 9),
                                  (8, 8), (16, 16), (24, 40), (1, 30)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_odd_sizes_equal_cv2(tmp_path, size, monkeypatch):
    """Sizes that are not multiples of 16, odd ones too (swscale's scaled
    path, the chroma sited left as FFmpeg's MPEG-4 decoder tags it)."""
    h, w = size
    mbh, mbw = (h + 15) // 16, (w + 15) // 16
    rng = np.random.default_rng(h * w)
    plans = [rand_plan("I", mbh, mbw, rng, quant=3, ac_pred=True)] + \
        [rand_plan("P", mbh, mbw, rng, fcode=3, reach=60, rounding=t % 2,
                   dquant=True, ac_pred=True) for t in range(4)]
    chunks, recons, _ = mw.encode_video(yuv_pictures(h, w, 5, h), plans)
    path = tmp_path / "odd 5ms.avi"
    mw.write_mpeg4_avi(path, chunks, h, w)
    recon = np.stack([rawvideo_plain.decode_bgr(
        mp.i420_bytes(r, h, w), "i420_left", h, w) for r in recons])
    _check(path, monkeypatch, recon=recon)


@pytest.mark.parametrize("seed", range(8))
def test_random_streams_equal_cv2(tmp_path, seed, monkeypatch):
    """Every feature at random: size, quantisers, fcodes, rounding,
    macroblock kinds, dquant, AC prediction, packets, thresholds."""
    rng = np.random.default_rng(1000 + seed)
    h, w = int(rng.integers(8, 80)), int(rng.integers(8, 100))
    mbh, mbw = (h + 15) // 16, (w + 15) // 16
    n = mbh * mbw
    resync = n > 1 and bool(rng.integers(0, 2))
    pk = lambda: _packets(rng, n, int(rng.integers(1, 5))) \
        if resync else {}   # noqa: E731
    plans = [rand_plan("I", mbh, mbw, rng, quant=int(rng.integers(1, 32)),
                       ac_pred=bool(rng.integers(0, 2)),
                       dquant=bool(rng.integers(0, 2)), packets=pk(),
                       dc_thr=int(rng.integers(0, 8)))]
    for _ in range(int(rng.integers(2, 6))):
        f = int(rng.integers(1, 8))
        plans.append(rand_plan(
            "P", mbh, mbw, rng, fcode=f, quant=int(rng.integers(1, 32)),
            rounding=int(rng.integers(0, 2)),
            dquant=bool(rng.integers(0, 2)),
            ac_pred=bool(rng.integers(0, 2)), packets=pk(),
            dc_thr=int(rng.integers(0, 8)),
            reach=int(rng.choice([40, 16 << (f - 1)])),
            p_intra=float(rng.random() * 0.3),
            p_4mv=float(rng.random() * 0.5),
            p_skip=float(rng.random() * 0.3)))
    chunks, recons, _ = mw.encode_video(
        yuv_pictures(h, w, len(plans), seed), plans, resync=resync)
    path = tmp_path / "random 5ms.avi"
    mw.write_mpeg4_avi(path, chunks, h, w)
    recon = np.stack([rawvideo_plain.decode_bgr(
        mp.i420_bytes(r, h, w), "i420_left", h, w) for r in recons])
    _check(path, monkeypatch, recon=recon)


def test_the_handler_names_xvid(tmp_path):
    """FFmpeg's AVI demuxer takes a stream handled by ``XVID`` as Xvid
    whatever its header's fourcc (it then picks the Xvid IDCT where no
    user data names another encoder): refused."""
    h, w = 32, 48
    chunks, _, _ = mw.encode_video(yuv_pictures(h, w, 2),
                                   [mw.Plan("I"), mw.Plan("P")],
                                   user_data=None)
    for handler, tag, refused in (("XVID", "FMP4", True),
                                  ("DIVX", "FMP4", False),
                                  ("FMP4", "XVID", True)):
        path = tmp_path / f"{handler} {tag} 5ms.avi"
        mw.write_mpeg4_avi(path, chunks, h, w, tag=tag, handler=handler)
        info = avi.probe_avi(path)
        assert info.handler == handler
        why = avi.mpeg4_unsupported(path, info)
        assert (why is not None and "Xvid IDCT" in why) == refused, why


# --- refusals ------------------------------------------------------------------

# feature: (Writer kwargs, the chunks' tag, the words the refusal names)
REFUSED = {
    "interlaced": (dict(vol_fields=dict(interlaced=1)), "FMP4",
                   "interlaced"),
    "sprite": (dict(vol_fields=dict(sprite=1)), "FMP4", "sprites"),
    "gmc": (dict(verid=2, vol_fields=dict(sprite=2)), "FMP4", "GMC"),
    "not_8_bit": (dict(vol_fields=dict(not_8_bit=1)), "FMP4", "not_8_bit"),
    "quant_type": (dict(vol_fields=dict(quant_type=1)), "FMP4",
                   "quant_type 1"),
    "quarter_sample": (dict(verid=2, vol_fields=dict(quarter_sample=1)),
                       "FMP4", "quarter-pel"),
    "complexity": (dict(vol_fields=dict(complexity=1)), "FMP4",
                   "complexity estimation"),
    "data_partitioned": (dict(vol_fields=dict(data_partitioned=1)), "FMP4",
                         "data partitioning"),
    "rvlc": (dict(vol_fields=dict(data_partitioned=1, rvlc=1)), "FMP4",
             "reversible VLCs"),
    "newpred": (dict(verid=2, vol_fields=dict(newpred=1)), "FMP4",
                "newpred"),
    "reduced": (dict(verid=2, vol_fields=dict(reduced=1)), "FMP4",
                "reduced-resolution"),
    "scalability": (dict(vol_fields=dict(scalability=1)), "FMP4",
                    "scalability"),
    "shape_binary": (dict(vol_fields=dict(shape=1)), "FMP4",
                     "video_object_layer_shape 1"),
    "shape_binary_only": (dict(vol_fields=dict(shape=2)), "FMP4",
                          "video_object_layer_shape 2"),
    "shape_gray": (dict(verid=2, vol_fields=dict(shape=3)), "FMP4",
                   "video_object_layer_shape 3"),
    "full_range": (dict(signal=(True, 1)), "FMP4", "full-range"),
    "matrix": (dict(signal=(False, 4)), "FMP4", "matrix_coefficients 4"),
    "xvid_user_data": (dict(user_data=b"XviD0050"), "FMP4", "Xvid IDCT"),
    "xvid_fourcc": (dict(user_data=None), "XVID", "Xvid IDCT"),
    "xvix_fourcc": (dict(user_data=None), "XVIX", "Xvid IDCT"),
    "packed": (dict(user_data=b"DivX503b1393p"), "DX50", "packed"),
}


@pytest.mark.parametrize("feature", list(REFUSED) + ["b_vop", "s_vop",
                                                     "short_header",
                                                     "first_p"])
def test_refused_streams_raise_before_decode(tmp_path, feature,
                                             monkeypatch):
    """Each refused feature raises a ValueError naming it before any
    frame is decoded: ``avi.mpeg4_unsupported``, the resolver and the
    decoders say it."""
    h, w = 32, 48
    pics = yuv_pictures(h, w, 3)
    plans = [mw.Plan("I"), mw.Plan("P"), mw.Plan("P")]
    if feature in REFUSED:
        wkw, tag, words = REFUSED[feature]
        chunks, _, _ = mw.encode_video(pics, plans, **wkw)
    else:
        tag = "FMP4"
        chunks, _, wr = mw.encode_video(pics, plans)
        first = bytearray(chunks[0])
        at = first.find(b"\x00\x00\x01\xb6") + 4
        if feature in ("b_vop", "s_vop"):
            # the first VOP's coding type: 2 (B) or 3 (S)
            first[at] = (first[at] & 0x3F) | ((2 if feature == "b_vop"
                                                else 3) << 6)
            words = {"b_vop": "B-VOPs", "s_vop": "S-VOPs"}[feature]
        elif feature == "short_header":
            first = bytearray(b"\x00\x00\x80\x02\x08") + bytes(40)
            words = "short video header"
        else:
            first = bytearray(wr.headers()) + chunks[1]
            words = "P-VOP before the first I-VOP"
        chunks[0] = bytes(first)
    path = tmp_path / f"{feature} 5ms.avi"
    mw.write_mpeg4_avi(path, chunks, h, w, tag=tag)
    info = avi.probe_avi(path)
    why = avi.mpeg4_unsupported(path, info)
    assert why is not None and words in why, why
    with monkeypatch.context() as m:
        m.setitem(sys.modules, "cv2", None)
        with pytest.raises(ValueError, match="MPEG-4 Part 2 decoder does "
                           "not read") as exc:
            tvideo._resolve_decoder("native", [path], h, w, 3)
        assert words in str(exc.value)
    assert words in _outcome(lambda: _plain(path))
    assert words in _outcome(lambda: _native(path))


@pytest.mark.parametrize("later", ["b_vop", "s_vop", "xvid_user_data",
                                   "vol_size", "no_vop"])
def test_a_later_refused_vop_raises_naming_its_frame(tmp_path, later):
    """A refused feature that shows only in a later chunk raises when it
    is decoded, naming its frame; the frames before it decode."""
    h, w = 32, 48
    chunks, recons, wr = mw.encode_video(
        yuv_pictures(h, w, 4), [mw.Plan("I"), mw.Plan("P"), mw.Plan("P"),
                                mw.Plan("P")])
    bad = bytearray(chunks[2])
    if later in ("b_vop", "s_vop"):
        bad[4] = (bad[4] & 0x3F) | ((2 if later == "b_vop" else 3) << 6)
        words = {"b_vop": "B-VOPs", "s_vop": "S-VOPs"}[later]
    elif later == "xvid_user_data":
        bad = bytearray(b"\x00\x00\x01\xb2XviD0050") + bad
        words = "Xvid IDCT"
    elif later == "vol_size":
        other = mw.Writer(h + 16, w)
        bad = bytearray(other.headers()) + bad
        words = "a VOL of 48 x 48 after one of 48 x 32"
    else:
        bad = bytearray(wr.headers())
        words = "a chunk without a VOP"
    chunks[2] = bytes(bad)
    path = tmp_path / f"{later} 5ms.avi"
    mw.write_mpeg4_avi(path, chunks, h, w)
    info = avi.probe_avi(path)
    assert avi.mpeg4_unsupported(path, info) is None
    for decode in (_plain, _native):
        got = _outcome(lambda: decode(path))
        assert "frame 2: " in got and words in got, got
    frames = []
    with pytest.raises(ValueError, match=f"frame 2: .*{words}"):
        for frame in tvideo.video_frame_generator(path, decoder="native"):
            frames.append(frame)
    want = cv2_frames(path)
    assert len(frames) == 2
    np.testing.assert_array_equal(np.stack(frames), want[:2])


@pytest.mark.parametrize("damage", ["flip", "cut", "zeros", "marker"])
def test_damaged_chunks_raise_naming_the_frame_and_macroblock(tmp_path,
                                                            damage):
    """Bits FFmpeg fails on (and conceals) raise in both decoders, naming
    the frame and the macroblock; cv2's frame there is not the
    writer's."""
    h, w = 48, 64
    rng = np.random.default_rng(5)
    plans = [rand_plan("I", 3, 4, rng, quant=2)] + \
        [rand_plan("P", 3, 4, rng, quant=2) for _ in range(2)]
    chunks, recons, _ = mw.encode_video(yuv_pictures(h, w, 3, 1, 40), plans)
    bad = bytearray(chunks[1])
    if damage == "flip":
        for at in range(len(bad) // 3, len(bad) - 2, 7):
            bad[at] ^= 0x5A
    elif damage == "cut":
        bad = bad[:len(bad) * 2 // 3]
    elif damage == "zeros":
        bad[len(bad) // 2:] = bytes(len(bad) - len(bad) // 2)
    else:
        bad[12:] = b"\xff" * (len(bad) - 12)
    chunks[1] = bytes(bad)
    path = tmp_path / f"{damage} 5ms.avi"
    mw.write_mpeg4_avi(path, chunks, h, w)
    for decode in (_plain, _native):
        got = _outcome(lambda: decode(path))
        assert isinstance(got, str) and "frame 1: macroblock (" in got, got
    want = cv2_frames(path)
    recon = rawvideo_plain.decode_bgr(mp.i420_bytes(recons[1], h, w),
                                      "i420_left", h, w)
    assert len(want) < 2 or not np.array_equal(want[1], recon)


def test_native_equals_plain_on_damaged_chunks():
    """Random damage to random streams: the native decoder gives the plain
    version's frames, or raises where it raises, naming the same frame
    and macroblock."""
    rng = np.random.default_rng(11)
    for trial in range(20):
        h, w = int(rng.integers(8, 50)), int(rng.integers(8, 70))
        mbh, mbw = (h + 15) // 16, (w + 15) // 16
        resync = bool(trial % 2) and mbh * mbw > 1
        plans = [rand_plan("I", mbh, mbw, rng, quant=3, ac_pred=True,
                           packets=_packets(rng, mbh * mbw, 2)
                           if resync else {})] + \
            [rand_plan("P", mbh, mbw, rng, quant=4, fcode=2, ac_pred=True)
             for _ in range(2)]
        chunks, _, wr = mw.encode_video(yuv_pictures(h, w, 3, trial), plans,
                                        resync=resync)
        k = int(rng.integers(0, 3))
        bad = bytearray(chunks[k])
        start = len(wr.headers()) + 12 if k == 0 else 6
        for _ in range(int(rng.integers(1, 4))):
            if len(bad) > start + 1:
                at = int(rng.integers(start, len(bad)))
                bad[at] = int(rng.integers(0, 256))
        if rng.random() < 0.3:
            bad = bad[:int(rng.integers(start, len(bad) + 1))]
        chunks[k] = bytes(bad)
        tag, extra = "FMP4", b""
        plain = _outcome(lambda: np.stack(mp.decode_bgr(chunks, tag, extra,
                                                        h, w)))

        def nat():
            dec = native.Mpeg4Decoder(tag, extra, h, w)
            dst = np.empty((3, h, w, 3), np.uint8)
            n = native.mpeg4_decode_bgr_batch(chunks, dst, dec)
            return dst[:n]
        got = _outcome(nat)
        if isinstance(plain, str):
            assert isinstance(got, str), plain
            where = plain.split("frame ")[1].split(":")[0]
            assert f"frame {where}" in got, (plain, got)
            if "macroblock (" in plain:
                mb = plain.split("macroblock ")[1].split(":")[0]
                assert f"macroblock {mb}" in got, (plain, got)
        else:
            np.testing.assert_array_equal(got, plain)


def test_a_failed_build_raises_and_never_reaches_cv2(tmp_path, monkeypatch):
    path = tmp_path / "fmp4 5ms.avi"
    cv2_clip(path, "FMP4", 16, 32, n=3)
    monkeypatch.setitem(native._decoder_libs, "_mpeg4", None)
    monkeypatch.setitem(native._build_errors, "_mpeg4",
                        "g++: simulated failure")

    def no_cv2(why):
        raise AssertionError(f"cv2 was reached: {why}")
    monkeypatch.setattr(tvideo, "_cv2", no_cv2)
    with pytest.raises(RuntimeError, match="mpeg4.cpp.*simulated failure"):
        tvideo.welford_algorithm(path, use_std=True)
    with pytest.raises(RuntimeError, match="MPEG-4 Part 2 decoder "
                       "unavailable"):
        native.Mpeg4Decoder("FMP4", b"", 16, 32)


# --- the native encoder of chip_smoke.py ----------------------------------

@pytest.mark.parametrize("size", [(48, 64), (37, 53), (16, 16), (9, 30)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_native_encoder_gives_the_writers_bytes(size):
    """``tests/_torch_mpeg4_enc.cpp`` codes the smoke's plans (intra
    I-VOPs, P-VOPs of zero vectors; both rounding types) to the Python
    writer's bytes and reconstruction."""
    h, w = size
    a, b = mw.Writer(h, w), mw.Writer(h, w)
    for t, pic in enumerate(yuv_pictures(h, w, 6, h, 30)):
        plan = mw.smoke_plan("I" if t % 4 == 0 else "P", quant=1 + 6 * t,
                             rounding=t % 2)
        want, rec = a.encode(pic, plan)
        got, rec2 = b.encode_native(pic, plan)
        assert got == want, t
        for x, y in zip(rec, rec2):
            np.testing.assert_array_equal(x, y)


# --- the committed clips ---------------------------------------------------

CLIPS = ["fmp4", "writer", "odd", "divx4"]


def clip_path(name: str) -> Path:
    return DATA / f"mpeg4 {name} 5ms.avi"


def write_clip(name: str, path: Path) -> None:
    """A committed clip: cv2's FMP4 (two GOPs), the writer's mix of
    features at 40 x 56, at an odd 37 x 53, and DivX 4 (the visible
    border replicated)."""
    if name == "fmp4":
        cv2_clip(path, "FMP4", 48, 64, n=14)
        return
    if name == "odd":
        h, w = 37, 53
        rng = np.random.default_rng(3)
        plans = [rand_plan("I", 3, 4, rng, quant=4, ac_pred=True)] + \
            [rand_plan("P", 3, 4, rng, fcode=2, rounding=t % 2, dquant=True,
                       p_4mv=0.5) for t in range(5)]
        chunks, _, _ = mw.encode_video(yuv_pictures(h, w, 6, 3), plans)
        mw.write_mpeg4_avi(path, chunks, h, w)
        return
    if name == "writer":
        h, w = 40, 56
        rng = np.random.default_rng(4)
        plans = [rand_plan("I", 3, 4, rng, quant=5, ac_pred=True,
                           dquant=True, packets={5: (7, True)}, dc_thr=3)]
        for t in range(6):
            plans.append(rand_plan(
                "P", 3, 4, rng, fcode=1 + 2 * (t % 4), reach=16 << (2 * (t % 4)),
                rounding=t % 2, dquant=True, ac_pred=True, p_4mv=0.4,
                p_intra=0.2, packets={3 + t: (0, bool(t % 2))}, dc_thr=t))
            if t == 2:
                plans.append(mw.Plan("N"))
        chunks, _, _ = mw.encode_video(yuv_pictures(h, w, len(plans), 4),
                                       plans, resync=True)
        mw.write_mpeg4_avi(path, chunks, h, w)
        return
    write_case(path, "divx4")


@pytest.mark.parametrize("name", CLIPS)
def test_committed_clips_decode_to_cv2s_frames(name, monkeypatch):
    """Each committed clip's ``.cv2.npy`` is cv2's frames of it, and the
    port (cv2 blocked) gives them."""
    path = clip_path(name)
    want = np.load(path.with_suffix(".cv2.npy"))
    np.testing.assert_array_equal(cv2_frames(path), want)
    _check(path, monkeypatch, want=want)


def write_clips() -> None:
    """Rewrite ``tests/data/mpeg4 *.avi`` and their ``.cv2.npy``."""
    for name in CLIPS:
        path = clip_path(name)
        write_clip(name, path)
        np.save(path.with_suffix(".cv2.npy"), cv2_frames(path))


# --- the port's entry points -----------------------------------------------

def test_doctor_reports_the_mpeg4_decoder(tmp_path, capsys):
    path = tmp_path / "v 5ms.avi"
    cv2_clip(path, "XVID", 16, 32, n=3)
    assert tmain(["--device", "cpu", "doctor", "--video", str(path)]) == 0
    out = capsys.readouterr().out
    for line in ("native MPEG-4 Part 2 decoder: built; MPEG-4 Part 2 AVIs "
                 "(FMP4, XVID", "decode (mpeg4, 1 thread(s))",
                 "decode (native)"):
        assert line in out, line


@pytest.mark.parametrize("fourcc", ["FMP4", "XVID", "DIVX", "DX50"])
def test_welford_and_process_video_equal_jax(tmp_path, fourcc, monkeypatch):
    """An AVI cv2's writer wrote under each fourcc, with cv2 blocked: the
    resolver picks the port's MPEG-4 decoder, and the port's
    ``welford_algorithm`` (host backend) and ``process_video`` equal the
    JAX package's with ``decoder="cv2"`` bit for bit; the device backend
    at rtol 1e-9."""
    monkeypatch.delenv("CL_DECODER", raising=False)
    h, w = 24, 40
    clips = {}
    for who in ("port", "jax"):
        (tmp_path / who).mkdir()
        clips[who] = tmp_path / who / "scene 5ms.avi"
        cv2_clip(clips[who], fourcc, h, w, n=13, seed=7)
    assert clips["port"].read_bytes() == clips["jax"].read_bytes()
    want = jvideo.welford_algorithm(clips["jax"], use_std=True,
                                    decoder="cv2")
    jvideo.process_video(clips["jax"], decoder="cv2")
    with monkeypatch.context() as m:
        m.setitem(sys.modules, "cv2", None)
        assert tvideo._resolve_decoder("native", [clips["port"]], h, w,
                                       3) == ["mpeg4"]
        obs.reset_stage_times()
        got = tvideo.welford_algorithm(clips["port"], use_std=True)
        assert obs.decoded_frames.snapshot() == {"mpeg4": 13}
        dev = tvideo.welford_algorithm(clips["port"], use_std=True,
                                       backend="device", batch_size=4,
                                       device="cpu")
        tvideo.process_video(clips["port"])
    for key in ("mean", "std"):
        np.testing.assert_array_equal(got[key], want[key])
        np.testing.assert_allclose(dev[key], want[key], rtol=1e-9,
                                   atol=1e-15)
        files = [cv2.imread(str(clips[who].with_name(
            f"scene 5ms.{key}.tif")), cv2.IMREAD_UNCHANGED)
            for who in ("port", "jax")]
        assert files[1] is not None and files[1].dtype == np.float64
        np.testing.assert_array_equal(files[0], files[1])


def test_batch_video_to_hdr_equals_jax(tmp_path, monkeypatch):
    """The slice as a whole: scenes of MPEG-4 AVIs (cv2's FMP4, XVID, DIVX
    and DX50, and the writer's 4MV, dquant and packet streams) through the
    port's pipeline, cv2 blocked, against the JAX package's, which reads
    them with cv2."""
    monkeypatch.delenv("CL_DECODER", raising=False)
    h, w = 32, 48
    icrf = np.linspace(0, 1, 256)[:, None].repeat(3, 1) ** \
        np.array([2.0, 2.2, 2.4])
    scenes = {}
    for s, name in enumerate(("a", "b")):
        (tmp_path / name).mkdir()
        paths = []
        for k, ms in enumerate((4, 8, 16)):
            path = tmp_path / name / f"{name} {ms}ms.avi"
            if s == 0:
                cv2_clip(path, ("FMP4", "XVID", "DX50")[k], h, w, n=6,
                         seed=k)
            else:
                rng = np.random.default_rng(k)
                plans = [rand_plan("I", 2, 3, rng, quant=3, ac_pred=True)] + \
                    [rand_plan("P", 2, 3, rng, fcode=2, dquant=True,
                               p_4mv=0.6, packets={2: (5, True)})
                     for _ in range(5)]
                chunks, _, _ = mw.encode_video(
                    yuv_pictures(h, w, 6, 20 + k), plans, resync=True)
                mw.write_mpeg4_avi(path, chunks, h, w, tag="DIVX")
            paths.append(path)
        scenes[name] = paths
    want = jpipe.batch_video_to_hdr(scenes, jnp.asarray(icrf))
    monkeypatch.setitem(sys.modules, "cv2", None)
    obs.reset_stage_times()
    got = tpipe.batch_video_to_hdr(scenes, icrf, device="cpu")
    assert obs.decoded_frames.snapshot() == {"mpeg4": 2 * 3 * 6}
    for name in scenes:
        np.testing.assert_allclose(
            got[name].measurand.val.numpy(),
            np.asarray(want[name].measurand.val), rtol=1e-10, atol=1e-14)
        np.testing.assert_allclose(
            got[name].measurand.std.numpy(),
            np.asarray(want[name].measurand.std), rtol=1e-9, atol=1e-14)


if __name__ == "__main__":
    write_clips()
