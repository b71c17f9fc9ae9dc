"""The port's MPEG-4 Part 2 decoder (``native/mpeg4.cpp`` and its plain
version ``native/mpeg4_plain.py``) on Advanced Simple streams, as Xvid and
DivX 5 write them, against ``cv2.VideoCapture``, libavcodec's planes and
the JAX package, on the CPU.

Streams come from ``tests/_torch_mpeg4_writer.py``: Xvid and DivX user
data (FFmpeg then decodes with the Xvid IDCT, its SSE2 form), the ``XVID``
and ``XVIX`` fourccs without user data, B-VOPs of every macroblock kind
(direct with and without a delta over 1MV, 4MV, skipped and intra
macroblocks, interpolated, backward, forward; ``dbquant``; vectors past
every edge at each ``fcode``/``bcode``; video packets), open and closed
GOPs, VOP times that wrap their second, packed bitstreams (an I- or P-VOP
and a B-VOP in one chunk, an N-VOP or one byte after them), MPEG
quantisation (``quant_type`` 1: the default matrices, custom ones, one cut
short by a 0, one of zeros), the low-delay rules FFmpeg applies (a VOL
without VOL control, B-VOPs in a low-delay VOL, a B-VOP without two
references or outside their times, which FFmpeg skips) and N-VOPs at the
end.  Tolerances:

* every frame of the plain version, of ``native.mpeg4_decode_bgr_batch``
  (one thread one frame a call, four threads 13 frames a call) and of the
  port's ``video_frame_generator`` (cv2 blocked) equals cv2's bit for bit,
  with the same frame count and order, and so does the writer's own
  reconstruction where the case says which frames FFmpeg outputs;
  libavcodec's planes (``tests/_torch_libavcodec.py``: luma under 16
  clips to 0 in BGR) equal the plain version's;
* damaged B-VOPs raise in both decoders naming the frame and the
  macroblock, native and plain alike;
* the committed ``tests/data/mpeg4 asp *.avi`` decode to their
  ``.cv2.npy`` (``python -m tests.test_torch_mpeg4_asp`` rewrites both),
  which ``chip_smoke.py`` holds the port to on the card's machine;
* ``tests/_torch_mpeg4_enc.cpp`` gives the Python writer's bytes and
  reconstruction for the ASP plans ``chip_smoke.py`` codes its 4K videos
  with;
* ``welford_algorithm`` and ``process_video`` of the port (host backend),
  cv2 blocked, equal the JAX package's ``decoder="cv2"`` bit for bit on an
  ASP AVI, and ``batch_video_to_hdr`` the JAX package's at rtol 1e-10
  (std 1e-9), as for the other codecs.
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
from camera_linearity_tpu_torch.models import pipeline as tpipe  # noqa
from camera_linearity_tpu_torch.models import video as tvideo  # noqa: E402
from camera_linearity_tpu_torch.native import mpeg4_plain as mp  # noqa
from camera_linearity_tpu_torch.native import rawvideo_plain  # noqa: E402
from camera_linearity_tpu_torch.utils import avi  # noqa: E402
from camera_linearity_tpu_torch.utils import observability as obs  # noqa
from tests import _torch_libavcodec as lav  # noqa: E402
from tests import _torch_mpeg4_writer as mw  # noqa: E402
from tests.test_torch_mpeg4 import (_check, _chunks, _native, _outcome,  # noqa
                                    _plain, cv2_frames, rand_plan,
                                    yuv_pictures)

DATA = Path(__file__).resolve().parent / "data"
XVID = b"XviD0050"
PACKED = b"DivX503b1393p"


def b_plan(rng, mbh, mbw, time, quant=6, fcode=2, bcode=3, reach=40,
           kinds=(mw.DIRECT, mw.DIRECT_NONE, mw.BI, mw.BWD, mw.FWD),
           delta=6, packets=None):
    """A B-VOP of random macroblock kinds, vectors (within ``reach`` half
    pels and each code's range), direct deltas and ``dbquant``."""
    ftop = min(16 << (fcode - 1), reach)
    btop = min(16 << (bcode - 1), reach)
    return mw.Plan("B", quant=quant, time=time, fcode=fcode, bcode=bcode,
                   modes=rng.choice(list(kinds), (mbh, mbw)),
                   mvs=rng.integers(-ftop, ftop, (mbh, mbw, 4, 2)),
                   bmvs=rng.integers(-btop, btop, (mbh, mbw, 2)),
                   deltas=rng.integers(-delta, delta + 1, (mbh, mbw, 2)),
                   dquant=rng.choice([-2, 0, 2], (mbh, mbw)),
                   packets=packets or {})


def plans_for(order: str, mbh: int, mbw: int, rng, **kw):
    """Plans in coded order from ``order`` ("I0 P3 B1 B2 ..."; a letter
    and the display time, N an N-VOP): random I-, P- and B-VOPs."""
    plans = []
    for item in order.split():
        kind, t = item[0], int(item[1:])
        if kind == "I":
            p = rand_plan("I", mbh, mbw, rng, quant=kw.get("quant", 4),
                          ac_pred=True, dquant=True)
        elif kind == "P":
            p = rand_plan("P", mbh, mbw, rng, fcode=kw.get("fcode", 2),
                          quant=kw.get("quant", 5), rounding=t % 2,
                          p_4mv=kw.get("p_4mv", 0.4), dquant=True,
                          ac_pred=True, reach=kw.get("reach", 40))
        elif kind == "B":
            p = b_plan(rng, mbh, mbw, t, quant=kw.get("quant", 6),
                       fcode=kw.get("fcode", 2), bcode=kw.get("bcode", 3),
                       reach=kw.get("reach", 40), delta=kw.get("delta", 6))
        else:
            p = mw.Plan("N")
        p.time = t
        plans.append(p)
    return plans


CLOSED = "I0 P3 B1 B2 P6 B4 B5 P9 B7 B8 P11 B10"


def asp_case(name: str):
    """A case: (h, w, coded-order plans, Writer kwargs, AVI kwargs,
    placeholder of a packed bitstream or None, whether the writer's
    reconstruction is what FFmpeg outputs)."""
    rng = np.random.default_rng(sum(map(ord, name)))
    h, w, mbh, mbw = 48, 64, 3, 4
    wkw, akw, packed, recon = dict(vol_fields=dict(low_delay=0)), {}, \
        None, True
    order, kw = CLOSED, {}
    if name == "xvid_sp":
        wkw = dict(user_data=XVID)
        order = "I0 P1 P2 P3 P4 P5"
    elif name == "xvid_fourcc":
        # build 0 from the fourcc: the Xvid IDCT and the visible border
        wkw = dict(user_data=None, xvid=True, edge="visible")
        akw = dict(tag="XVID")
        order, kw = "I0 P1 P2 P3 P4", dict(reach=200, fcode=4)
    elif name == "xvix_fourcc":
        wkw = dict(user_data=None, xvid=True, edge="visible",
                   vol_fields=dict(low_delay=0))
        akw = dict(tag="XVIX")
    elif name == "b_unpacked":
        wkw["user_data"] = XVID
    elif name == "b_direct_edges":
        # 4MV references whose vectors point past every edge, the largest
        # deltas, at fcode 3
        wkw["user_data"] = XVID
        kw = dict(p_4mv=0.8, reach=120, fcode=3, bcode=3, delta=31)
    elif name == "b_lavc":
        order = "I0 P2 B1 P4 B3 P6 B5"
    elif name == "b_packed_nvop":
        wkw["user_data"] = (XVID, PACKED)
        packed = mw.nvop_chunk(5, 3)
    elif name == "b_packed_byte":
        wkw["user_data"] = PACKED
        packed = b"\x7f"
        akw = dict(tag="DX50")
    elif name in ("quant_default", "quant_custom", "quant_short",
                  "quant_zero"):
        wkw["user_data"] = XVID
        wkw["vol_fields"]["quant_type"] = 1
        wkw["matrices"] = {
            "quant_default": (None, None),
            "quant_custom": (list(rng.integers(8, 255, 64)),
                             list(rng.integers(1, 90, 64))),
            "quant_short": ([9, 14, 22, 31], [16, 18]),
            "quant_zero": ([], list(rng.integers(12, 40, 20)))}[name]
        kw = dict(quant=3)
    elif name == "lavc_quant":
        wkw["vol_fields"]["quant_type"] = 1
        wkw["matrices"] = (list(rng.integers(8, 60, 50)), None)
    elif name == "time_wrap":
        # five ticks a second: the B-VOPs' times cross seconds
        wkw.update(user_data=XVID, resolution=5)
        order = CLOSED + " P14 B12 B13"
    elif name == "open_gop":
        # B-VOPs after an I-VOP that reference the P-VOP before it
        order = "I0 P3 B1 B2 I6 B4 B5 P9 B7 B8"
    elif name == "gops":
        # closed GOPs: each decodes without the one before it
        order = "I0 P3 B1 B2 P5 B4 I6 P9 B7 B8 I10 P12 B11"
    elif name == "b_packets":
        wkw.update(resync=True, user_data=XVID)
        h, w, mbh, mbw = 64, 80, 4, 5
        plans = plans_for("I0 P3 B1 B2 P6 B4 B5", mbh, mbw, rng)
        for p in plans:
            n = mbh * mbw
            at = sorted(rng.choice(np.arange(1, n), 4, replace=False))
            p.packets = {int(k): (int(rng.integers(0, 2)) *
                                  int(rng.integers(1, 32)),
                                  bool(rng.integers(0, 2))) for k in at}
        return h, w, plans, wkw, akw, packed, recon
    elif name == "b_skips":
        # references mostly skipped: so are the B-VOPs' macroblocks
        plans = plans_for(CLOSED, mbh, mbw, rng)
        for p in plans:
            if p.kind == "P":
                p.modes = np.where(rng.random((mbh, mbw)) < 0.7, mw.SKIP,
                                   p.modes)
        return h, w, plans, wkw, akw, packed, recon
    elif name == "odd_b":
        h, w, mbh, mbw = 37, 53, 3, 4
        wkw["user_data"] = XVID
    elif name == "low_delay_b":
        # a VOL that says low delay: every frame is output in coded order
        wkw = dict(user_data=XVID)
        recon = False
    elif name == "no_vol_control":
        # FFmpeg clears the low-delay flag at the first B-VOP, and outputs
        # the P-VOP before it twice
        wkw = dict(vol_fields=dict(vol_control=0))
        recon = False
    elif name == "b_first":
        # a B-VOP after one reference: FFmpeg skips it
        order = "I0 B1 P3 B2 P6 B4 B5"
        recon = False
    elif name == "b_bad_time":
        # B-VOPs whose times do not lie between their references: skipped
        order = "I0 P3 B1 B4 P6 B6 B5"
        recon = False
    elif name == "nvop_end":
        order = CLOSED + " N11"
    elif name == "nvop_mid":
        order = "I0 P3 B1 B2 N3 P6 B4 B5"
        recon = False
    elif name == "xvid_later":
        order = "I0 P1 P2 P3 P4"
        wkw = dict()
        recon = False
    else:
        raise KeyError(name)
    plans = plans_for(order, mbh, mbw, rng, **kw)
    return h, w, plans, wkw, akw, packed, recon


ASP_CASES = ["xvid_sp", "xvid_fourcc", "xvix_fourcc", "b_unpacked",
             "b_direct_edges", "b_lavc", "b_packed_nvop", "b_packed_byte",
             "quant_default", "quant_custom", "quant_short", "quant_zero",
             "lavc_quant", "time_wrap", "open_gop", "gops", "b_packets",
             "b_skips", "odd_b", "low_delay_b", "no_vol_control", "b_first",
             "b_bad_time", "nvop_end", "nvop_mid", "xvid_later"]


def write_asp(path, name: str):
    """The case's AVI; returns the writer's reconstruction of what FFmpeg
    outputs (BGR), or None where the case leaves that to cv2."""
    h, w, plans, wkw, akw, packed, recon = asp_case(name)
    times = [p.time for p in plans]
    pics = yuv_pictures(h, w, max(times) + 1, seed=len(name))
    chunks, recons, wr = mw.encode_video([pics[t] for t in times], plans,
                                         **wkw)
    if name == "xvid_later":
        # XviD user data from frame 2 on: the Xvid IDCT from there
        chunks[2] = b"\x00\x00\x01\xb2" + XVID + chunks[2]
    if packed is not None:
        chunks = mw.pack(chunks, plans, packed)
    mw.write_mpeg4_avi(path, chunks, h, w, **akw)
    if not recon:
        return None
    low_delay = bool(dict(mw.VOL_DEFAULTS, **wkw.get("vol_fields", {}))
                     ["low_delay"])
    return np.stack([rawvideo_plain.decode_bgr(
        mp.i420_bytes(r, h, w), "i420_left", h, w)
        for r in mw.display_order(plans, recons, low_delay)])


def check_planes(path) -> None:
    """libavcodec's planes of every frame equal the plain version's (where
    the library loads)."""
    if not lav.available():
        return
    chunks, info = _chunks(path)
    got, _ = mp.decode_planes(chunks, *avi.mpeg4_params(info), info.height,
                              info.width)
    want = lav.decode_planes(path)
    assert len(got) == len(want)
    for k, (g, (fmt, planes)) in enumerate(zip(got, want)):
        assert fmt == "yuv420p"
        assert g == b"".join(p.tobytes() for p in planes), k


@pytest.mark.parametrize("name", ASP_CASES)
def test_asp_streams_equal_cv2(tmp_path, name, monkeypatch):
    """Each case: cv2 decodes it to the writer's reconstruction (where the
    case says which frames FFmpeg outputs), plain, native and the frame
    generator give cv2's frames, and libavcodec's planes equal the plain
    version's."""
    path = tmp_path / f"{name} 5ms.avi"
    recon = write_asp(path, name)
    info = avi.probe_avi(path)
    assert avi.mpeg4_unsupported(path, info) is None
    _check(path, monkeypatch, recon=recon)
    check_planes(path)


def test_frame_order_and_count_of_the_delay_rules(tmp_path):
    """The frames FFmpeg outputs where its low-delay rules decide: a
    low-delay VOL outputs in coded order, a VOL without VOL control
    repeats the P-VOP before the first B-VOP, skipped B-VOPs give
    none."""
    got = {}
    for name in ("low_delay_b", "no_vol_control", "b_first", "b_bad_time",
                 "nvop_mid"):
        path = tmp_path / f"{name}.avi"
        write_asp(path, name)
        got[name] = len(cv2_frames(path))
        assert len(_plain(path)) == got[name]
    assert got == {"low_delay_b": 12, "no_vol_control": 13, "b_first": 6,
                   "b_bad_time": 5, "nvop_mid": 7}


@pytest.mark.parametrize("seed", range(8))
def test_random_asp_streams_equal_cv2(tmp_path, seed, monkeypatch):
    """Every feature at random: size, GOP shape, B-VOP count, packing,
    quantisation and matrices, user data, packets, codes and vectors."""
    rng = np.random.default_rng(2000 + seed)
    h, w = int(rng.integers(8, 70)), int(rng.integers(8, 90))
    mbh, mbw = (h + 15) // 16, (w + 15) // 16
    n = mbh * mbw
    resync = n > 1 and bool(rng.integers(0, 2))
    nb = int(rng.integers(1, 4))
    order, t = ["I0"], 0
    for _ in range(int(rng.integers(2, 4))):
        anchor = t + nb + 1
        kind = "I" if rng.random() < 0.2 else "P"
        order.append(f"{kind}{anchor}")
        order += [f"B{t + 1 + k}" for k in range(nb)]
        t = anchor
    fcode, bcode = int(rng.integers(1, 5)), int(rng.integers(1, 5))
    plans = plans_for(" ".join(order), mbh, mbw, rng, fcode=fcode,
                      bcode=bcode, reach=int(rng.choice([40, 200])),
                      quant=int(rng.integers(2, 20)))
    if resync:
        for p in plans:
            at = sorted(rng.choice(np.arange(1, n), min(2, n - 1),
                                   replace=False))
            p.packets = {int(k): (0, bool(rng.integers(0, 2))) for k in at}
    user = [(XVID,), (XVID, PACKED), (PACKED,), (b"Lavc62.28.101",),
            (b"DivX503b1393",)][int(rng.integers(0, 5))]
    fields = dict(low_delay=0, quant_type=int(rng.integers(0, 2)))
    mats = (list(rng.integers(1, 255, int(rng.integers(0, 65)))), None)
    pics = yuv_pictures(h, w, t + 1, seed)
    chunks, recons, _ = mw.encode_video(
        [pics[p.time] for p in plans], plans, resync=resync, user_data=user,
        vol_fields=fields, matrices=mats)
    if PACKED in user and rng.random() < 0.7:
        chunks = mw.pack(chunks, plans, mw.nvop_chunk(5) if rng.random()
                         < 0.5 else b"\x7f")
    path = tmp_path / "random 5ms.avi"
    mw.write_mpeg4_avi(path, chunks, h, w)
    recon = np.stack([rawvideo_plain.decode_bgr(
        mp.i420_bytes(r, h, w), "i420_left", h, w)
        for r in mw.display_order(plans, recons, False)])
    _check(path, monkeypatch, recon=recon)
    check_planes(path)


# --- damaged B-VOPs --------------------------------------------------------

@pytest.mark.parametrize("damage", ["flip", "cut", "zeros", "mb_type"])
def test_damaged_b_vops_raise_naming_the_frame_and_macroblock(tmp_path,
                                                              damage):
    """Bits FFmpeg fails on in a B-VOP raise in both decoders, naming the
    frame and the macroblock."""
    h, w = 48, 64
    rng = np.random.default_rng(7)
    plans = plans_for("I0 P3 B1 B2 P6", 3, 4, rng, quant=2,
                      p_4mv=0.0)
    for p in plans:
        if p.kind == "P":
            p.modes = np.full((3, 4), mw.INTER)
        if p.kind == "B":
            p.modes = np.full((3, 4), mw.BI)
    pics = yuv_pictures(h, w, 7, 1, 40)
    chunks, _, _ = mw.encode_video([pics[p.time] for p in plans], plans,
                                   vol_fields=dict(low_delay=0))
    bad = bytearray(chunks[2])
    at = bad.find(b"\x00\x00\x01\xb6") + 8
    if damage == "flip":
        for k in range(at + 4, len(bad) - 2, 5):
            bad[k] ^= 0x5A
    elif damage == "cut":
        bad = bad[:len(bad) // 2]
    elif damage == "zeros":
        bad[len(bad) // 2:] = bytes(len(bad) - len(bad) // 2)
    else:
        # modb 0, modb2 1, then a 0000 mb_type FFmpeg refuses
        bad[at:] = b"\x40" + bytes(len(bad) - at - 1)
    chunks[2] = bytes(bad)
    path = tmp_path / f"{damage} 5ms.avi"
    mw.write_mpeg4_avi(path, chunks, h, w)
    outs = [_outcome(lambda: decode(path)) for decode in (_plain, _native)]
    for got in outs:
        assert isinstance(got, str) and "frame 2: macroblock (" in got, got
    where = [o.split("frame 2: ")[1].split(":")[0] for o in outs]
    assert where[0] == where[1], outs


def test_native_equals_plain_on_damaged_asp_streams():
    """Random damage to random ASP streams: the native decoder gives the
    plain version's frames, or raises where it raises, naming the same
    frame and macroblock."""
    rng = np.random.default_rng(23)
    for trial in range(16):
        h, w = int(rng.integers(8, 50)), int(rng.integers(8, 70))
        mbh, mbw = (h + 15) // 16, (w + 15) // 16
        plans = plans_for("I0 P3 B1 B2 P5 B4", mbh, mbw, rng, quant=3)
        user = (XVID,) if trial % 2 else (b"Lavc62.28.101",)
        fields = dict(low_delay=0, quant_type=trial % 3 == 0)
        pics = yuv_pictures(h, w, 6, trial)
        chunks, _, wr = mw.encode_video([pics[p.time] for p in plans],
                                        plans, user_data=user,
                                        vol_fields=fields)
        k = int(rng.integers(1, len(chunks)))
        bad = bytearray(chunks[k])
        start = bad.find(b"\x00\x00\x01\xb6") + 7
        for _ in range(int(rng.integers(1, 4))):
            if len(bad) > start + 1:
                at = int(rng.integers(start, len(bad)))
                bad[at] = int(rng.integers(0, 256))
        if rng.random() < 0.3:
            bad = bad[:int(rng.integers(start, len(bad) + 1))]
        chunks[k] = bytes(bad)
        plain = _outcome(lambda: np.stack(mp.decode_bgr(chunks, "FMP4", b"",
                                                        h, w)))

        def nat():
            dec = native.Mpeg4Decoder("FMP4", b"", h, w)
            dst = np.empty((len(chunks) + 1, h, w, 3), np.uint8)
            n = native.mpeg4_decode_bgr_batch(chunks, dst, dec)
            n += native.mpeg4_flush(dec, dst[n:])
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


# --- the native encoder of chip_smoke.py ----------------------------------

@pytest.mark.parametrize("quant", ["h263", "mpeg"])
@pytest.mark.parametrize("size", [(48, 64), (37, 53), (16, 16)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_native_encoder_gives_the_writers_asp_bytes(size, quant):
    """``tests/_torch_mpeg4_enc.cpp`` codes the smoke's ASP plans (B-VOPs
    of direct macroblocks; MPEG quantisation with custom matrices; the
    Xvid IDCT) to the Python writer's bytes and reconstruction."""
    h, w = size
    rng = np.random.default_rng(h)
    kw = dict(vol_fields=dict(low_delay=0), user_data=XVID)
    if quant == "mpeg":
        kw["vol_fields"]["quant_type"] = 1
        kw["matrices"] = (list(rng.integers(1, 200, 64)),
                          list(rng.integers(6, 90, 30)))
    a, b = mw.Writer(h, w, **kw), mw.Writer(h, w, **kw)
    pics = yuv_pictures(h, w, 7, h, 30)
    for t in (0, 3, 1, 2, 6, 4, 5):
        kind = "I" if t == 0 else "P" if t % 3 == 0 else "B"
        plan = mw.smoke_plan(kind, quant=2 + 4 * t, rounding=t % 2, time=t)
        want, rec = a.encode(pics[t], plan)
        got, rec2 = b.encode_native(pics[t], plan)
        assert got == want, t
        for x, y in zip(rec, rec2):
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("size", [(48, 64), (37, 53)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_smoke_asp_video_reads_to_its_reconstruction(tmp_path, size,
                                                     monkeypatch):
    """``chip_smoke.py``'s ASP video (``mw.encode_asp``: packed B-VOPs two
    between references, MPEG quantisation, Xvid and DivX user data) at a
    small size: native and Python coders give the same chunks, and cv2,
    plain, native and the frame generator give its reconstruction."""
    h, w = size
    pics = yuv_pictures(h, w, 12, h)
    mats = (tuple(8 + 3 * i % 40 for i in range(64)), (16, 17, 18, 20))
    chunks, recon = mw.encode_asp(pics, 6, mats)
    py_chunks, py_recon = mw.encode_asp(pics, 6, mats, native=False)
    assert chunks == py_chunks
    for a, b in zip(recon, py_recon):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    path = tmp_path / "asp 5ms.avi"
    mw.write_mpeg4_avi(path, chunks, h, w, tag="XVID")
    want = np.stack([rawvideo_plain.decode_bgr(
        mp.i420_bytes(r, h, w), "i420_left", h, w) for r in recon])
    _check(path, monkeypatch, recon=want)


# --- the committed clips ---------------------------------------------------

CLIPS = ["xvid sp", "xvid packed quant", "divx5 packed", "b 4mv edges",
         "b odd"]


def clip_path(name: str) -> Path:
    return DATA / f"mpeg4 asp {name} 5ms.avi"


def write_clip(name: str, path: Path) -> None:
    """A committed clip: Xvid Simple Profile (no B-VOPs, Xvid user data);
    Xvid packed B-VOPs with MPEG quantisation and custom matrices (one
    cut short); DivX 5 packed B-VOPs (one-byte placeholders, ``DX50``);
    unpacked B-VOPs over 4MV references with direct mode at the edges; an
    odd size with B-VOPs."""
    rng = np.random.default_rng(sum(map(ord, name)))
    h, w, mbh, mbw = 48, 64, 3, 4
    wkw, akw, packed = dict(vol_fields=dict(low_delay=0)), {}, None
    order, kw = CLOSED, {}
    if name == "xvid sp":
        wkw = dict(user_data=XVID)
        order = "I0 P1 P2 P3 P4 P5 P6 P7 P8 P9 P10 P11"
    elif name == "xvid packed quant":
        wkw.update(user_data=(XVID, PACKED), matrices=(
            list(rng.integers(8, 120, 64)), [16, 17, 18, 20, 24, 30]))
        wkw["vol_fields"]["quant_type"] = 1
        packed = mw.nvop_chunk(5)
        akw = dict(tag="XVID")
    elif name == "divx5 packed":
        wkw["user_data"] = PACKED
        packed = b"\x7f"
        akw = dict(tag="DX50")
    elif name == "b 4mv edges":
        wkw["user_data"] = XVID
        kw = dict(p_4mv=0.8, reach=120, fcode=3, bcode=3, delta=31)
    else:
        h, w, mbh, mbw = 37, 53, 3, 4
        wkw["user_data"] = XVID
        order = "I0 P3 B1 B2 P6 B4 B5 P9 B7 B8"
    plans = plans_for(order, mbh, mbw, rng, **kw)
    pics = yuv_pictures(h, w, 12, seed=len(name))
    chunks, _, _ = mw.encode_video([pics[p.time] for p in plans], plans,
                                   **wkw)
    if packed is not None:
        chunks = mw.pack(chunks, plans, packed)
    mw.write_mpeg4_avi(path, chunks, h, w, **akw)


@pytest.mark.parametrize("name", CLIPS)
def test_committed_asp_clips_decode_to_cv2s_frames(name, monkeypatch):
    """Each committed clip (at most 64 x 48 and 12 frames, under 50 kB)
    is cv2's ``.cv2.npy``, and the port (cv2 blocked) gives those frames,
    native and plain; libavcodec's planes equal the plain version's."""
    path = clip_path(name)
    want = np.load(path.with_suffix(".cv2.npy"))
    assert path.stat().st_size < 50_000 and len(want) <= 12
    assert want.shape[1] <= 48 and want.shape[2] <= 64
    np.testing.assert_array_equal(cv2_frames(path), want)
    _check(path, monkeypatch, want=want)
    check_planes(path)


def write_clips() -> None:
    """Rewrite ``tests/data/mpeg4 asp *.avi`` and their ``.cv2.npy``."""
    for name in CLIPS:
        path = clip_path(name)
        write_clip(name, path)
        np.save(path.with_suffix(".cv2.npy"), cv2_frames(path))


# --- the port's entry points -----------------------------------------------

def asp_video(path, h: int, w: int, seed: int) -> None:
    """An Xvid-style ASP AVI: ``XVID`` tag, Xvid user data, packed B-VOPs
    (two between references), MPEG quantisation."""
    rng = np.random.default_rng(seed)
    plans = plans_for(CLOSED, (h + 15) // 16, (w + 15) // 16, rng)
    pics = yuv_pictures(h, w, 12, seed)
    chunks, _, _ = mw.encode_video(
        [pics[p.time] for p in plans], plans, user_data=(XVID, PACKED),
        vol_fields=dict(low_delay=0, quant_type=1))
    mw.write_mpeg4_avi(path, mw.pack(chunks, plans, mw.nvop_chunk(5)), h, w,
                       tag="XVID")


def test_welford_and_process_video_equal_jax(tmp_path, monkeypatch):
    """An ASP AVI with cv2 blocked: the resolver picks the port's MPEG-4
    decoder, and the port's ``welford_algorithm`` (host backend) and
    ``process_video`` equal the JAX package's with ``decoder="cv2"`` bit
    for bit; the device backend at rtol 1e-9."""
    monkeypatch.delenv("CL_DECODER", raising=False)
    h, w = 24, 40
    clips = {}
    for who in ("port", "jax"):
        (tmp_path / who).mkdir()
        clips[who] = tmp_path / who / "scene 5ms.avi"
        asp_video(clips[who], h, w, 7)
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
        assert obs.decoded_frames.snapshot() == {"mpeg4": 12}
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
    """The slice as a whole: scenes of ASP AVIs (Xvid packed B-VOPs with
    MPEG quantisation, unpacked B-VOPs, DivX 5 packed) through the port's
    pipeline, cv2 blocked, against the JAX package's, which reads them
    with cv2."""
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
                asp_video(path, h, w, k)
            else:
                rng = np.random.default_rng(k)
                plans = plans_for(CLOSED, 2, 3, rng)
                pics = yuv_pictures(h, w, 12, 20 + k)
                chunks, _, _ = mw.encode_video(
                    [pics[p.time] for p in plans], plans,
                    user_data=PACKED if k else XVID,
                    vol_fields=dict(low_delay=0))
                if k:
                    chunks = mw.pack(chunks, plans, b"\x7f")
                mw.write_mpeg4_avi(path, chunks, h, w,
                                   tag="DX50" if k else "XVID")
            paths.append(path)
        scenes[name] = paths
    want = jpipe.batch_video_to_hdr(scenes, jnp.asarray(icrf))
    monkeypatch.setitem(sys.modules, "cv2", None)
    obs.reset_stage_times()
    got = tpipe.batch_video_to_hdr(scenes, icrf, device="cpu")
    assert obs.decoded_frames.snapshot() == {"mpeg4": 2 * 3 * 12}
    for name in scenes:
        np.testing.assert_allclose(
            got[name].measurand.val.numpy(),
            np.asarray(want[name].measurand.val), rtol=1e-10, atol=1e-14)
        np.testing.assert_allclose(
            got[name].measurand.std.numpy(),
            np.asarray(want[name].measurand.std), rtol=1e-9, atol=1e-14)


if __name__ == "__main__":
    write_clips()
