"""MPEG-4 Part 2 (Simple Profile) encoder and AVI writer for the port's
MPEG-4 tests (NumPy, no cv2 or FFmpeg).

:class:`Writer` encodes yuv420p pictures into I-, P- and N-VOP chunks
under a per-frame :class:`Plan`: each macroblock's kind (skipped, 1MV,
4MV, intra), its vectors (half pels, any ``fcode``, past every edge), its
``dquant``, its ``ac_pred_flag``, the video packets (resync markers, with
or without HEC) and the VOP's rounding type, quantiser and
``intra_dc_vlc_thr``: the features cv2's writer never uses.  It returns
the chunks and its own reconstruction, the macroblock-aligned planes
FFmpeg's decoder gives: the prediction (``mpeg4_plain``'s motion
compensation and edge rules), plus the dequantised residual through
FFmpeg's simple IDCT.  The levels come from a float DCT of the picture
(or of its residual) and a plain quantiser; the syntax elements (DC and
AC prediction, vector prediction) follow the decoder's rules by driving a
``mpeg4_plain.Decoder``'s predictor state alongside, so a stream that
cv2 decodes to the reconstruction holds both.

``write_mpeg4_avi`` writes the container (``tests/_torch_rawvideo_writer``);
``tests/_torch_mpeg4_enc.cpp`` (:func:`native_entropy`) codes the
macroblock layer of the plans :func:`smoke_plan` makes (intra I-VOPs,
P-VOPs of zero vectors) with the same bytes, for ``chip_smoke.py``'s 4K
videos.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from camera_linearity_tpu_torch.native import mpeg4_plain as mp
from tests._torch_rawvideo_writer import video_headers, write_avi

__all__ = ["Plan", "Writer", "Bits", "write_mpeg4_avi", "pad_planes",
           "smoke_plan", "native_entropy", "encode_video"]

SKIP, INTER, INTER4, INTRA = 0, 1, 2, 3
RESOLUTION = 30     # vop_time_increment_resolution

# the VOL's fields a test may change (``Writer(vol_fields=...)``)
VOL_DEFAULTS = dict(vo_type=1, vol_control=1, shape=0, interlaced=0,
                    sprite=0, not_8_bit=0, quant_type=0, quarter_sample=0,
                    complexity=0, data_partitioned=0, rvlc=0, newpred=0,
                    reduced=0, scalability=0)


class Bits:
    """An MSB-first bit writer: (code, length) pairs, packed at the end."""

    def __init__(self):
        self.codes: List[int] = []
        self.lens: List[int] = []
        self.n = 0

    def put(self, code: int, n: int) -> None:
        if n:
            self.codes.append(code & ((1 << n) - 1))
            self.lens.append(n)
            self.n += n

    def stuff(self) -> None:
        """MPEG-4 stuffing: a 0, then 1s up to the next byte."""
        pad = 7 - (self.n % 8) if self.n % 8 else 7
        self.put(0, 1)
        self.put((1 << pad) - 1, pad)

    def start(self, code: int) -> None:
        assert self.n % 8 == 0
        self.put(0x000001, 24)
        self.put(code & 0xFF, 8)

    def bytes(self) -> bytes:
        if not self.codes:
            return b""
        lens = np.array(self.lens, np.int64)
        codes = np.array(self.codes, np.uint64)
        starts = np.cumsum(lens) - lens
        which = np.repeat(np.arange(lens.size), lens)
        pos = np.arange(self.n) - starts[which]
        shift = (lens[which] - 1 - pos).astype(np.uint64)
        bits = ((codes[which] >> shift) & np.uint64(1)).astype(np.uint8)
        return np.packbits(bits).tobytes()


def _fill_vlc(rl: mp.RunLevel, vlc) -> Dict[Tuple[int, int, int], Tuple]:
    return {(rl.last[i], rl.run[i], rl.level[i]): vlc[i]
            for i in range(len(rl.level))}


_TCOEF = {True: _fill_vlc(mp.RL_INTRA, mp.INTRA_VLC),
          False: _fill_vlc(mp.RL_INTER, mp.INTER_VLC)}


def tcoef_codes(intra: bool, last: int, run: int, level: int):
    """One TCOEF event's codes: the table's, else the first, second or
    third escape, as an encoder picks them."""
    table, rl = _TCOEF[intra], mp.RL_INTRA if intra else mp.RL_INTER
    esc = mp.INTRA_VLC[mp.ESCAPE] if intra else mp.INTER_VLC[mp.ESCAPE]
    mag, sign = abs(level), int(level < 0)
    hit = table.get((last, run, mag))
    if hit:
        return [hit, (sign, 1)]
    top = rl.max_level[last][run] if run < 65 else 0
    hit = table.get((last, run, mag - top)) if top and mag > top else None
    if hit:
        return [esc, (0, 1), hit, (sign, 1)]
    top = rl.max_run[last][mag] if mag < 65 else 0
    if mag < 65 and rl.max_level[last][0] >= mag:
        hit = table.get((last, run - top - 1, mag)) if run > top else None
        if hit:
            return [esc, (2, 2), hit, (sign, 1)]
    assert -2048 <= level <= 2047 and level != 0
    return [esc, (3, 2), (last, 1), (run, 6), (1, 1), (level & 0xFFF, 12),
            (1, 1)]


def mv_codes(diff: int, fcode: int):
    """A vector component's difference, wrapped to the fcode's range, as
    its VLC, sign and residual bits."""
    bits = 5 + fcode
    d = ((diff + (1 << (bits - 1))) % (1 << bits)) - (1 << (bits - 1))
    if d == 0:
        return [mp.MVTAB[0]]
    shift = fcode - 1
    a = abs(d) - 1
    out = [mp.MVTAB[(a >> shift) + 1], (int(d < 0), 1)]
    if shift:
        out.append((a & ((1 << shift) - 1), shift))
    return out


@dataclass
class Plan:
    """How one frame is coded.  ``kind`` "I", "P" or "N" (an N-VOP);
    ``modes`` (mb_h, mb_w) of SKIP/INTER/INTER4/INTRA (an I-VOP: all
    intra); ``mvs`` (mb_h, mb_w, 4, 2) half-pel vectors (1MV takes the
    first); ``dquant`` (mb_h, mb_w) in -2..2 for coded macroblocks;
    ``ac_pred`` (mb_h, mb_w) for intra ones; ``packets`` macroblock
    number: (quant or 0, HEC) of the video packets after the first;
    ``stuffing`` macroblock numbers preceded by a stuffing code."""
    kind: str = "I"
    quant: int = 8
    rounding: int = 0
    fcode: int = 1
    dc_thr: int = 0
    modes: Optional[np.ndarray] = None
    mvs: Optional[np.ndarray] = None
    dquant: Optional[np.ndarray] = None
    ac_pred: Optional[np.ndarray] = None
    packets: Dict[int, Tuple[int, bool]] = field(default_factory=dict)
    stuffing: Sequence[int] = ()


def pad_planes(planes, mb_h: int, mb_w: int):
    """Planes padded (edge replicated) to the macroblock-aligned size."""
    out = []
    for k, p in enumerate(planes):
        s = 16 if k == 0 else 8
        out.append(np.pad(p, ((0, s * mb_h - p.shape[0]),
                              (0, s * mb_w - p.shape[1])), mode="edge"))
    return out


# the forward DCT in integers (each weight times 2^14, so a coefficient is
# 2^28 times the DCT's, DC = 8 x the mean): exact, so the C++ encoder
# picks the same levels
_DCT = np.rint(np.array([[(np.sqrt(0.5) if u == 0 else 1.0) / 2 *
                          np.cos((2 * x + 1) * u * np.pi / 16)
                          for x in range(8)] for u in range(8)])
               * (1 << 14)).astype(np.int64)
ONE = 1 << 28


def _fdct(blocks: np.ndarray) -> np.ndarray:
    """(n, 8, 8) samples -> (n, 64) coefficients times 2^28, natural
    order."""
    return (_DCT @ blocks.astype(np.int64) @ _DCT.T).reshape(-1, 64)


def _all_blocks(planes, mb_h: int, mb_w: int) -> np.ndarray:
    """Every macroblock's six blocks, (mb_h * mb_w, 6, 8, 8)."""
    y = planes[0].reshape(mb_h, 2, 8, mb_w, 2, 8).transpose(0, 3, 1, 4, 2, 5)
    y = y.reshape(mb_h * mb_w, 4, 8, 8)
    c = [p.reshape(mb_h, 8, mb_w, 8).transpose(0, 2, 1, 3).reshape(
        mb_h * mb_w, 1, 8, 8) for p in planes[1:]]
    return np.concatenate([y] + c, 1)


def _put_all(blocks: np.ndarray, mb_h: int, mb_w: int):
    y = blocks[:, :4].reshape(mb_h, mb_w, 2, 2, 8, 8).transpose(
        0, 2, 4, 1, 3, 5).reshape(16 * mb_h, 16 * mb_w)
    c = [blocks[:, k].reshape(mb_h, mb_w, 8, 8).transpose(0, 2, 1, 3)
         .reshape(8 * mb_h, 8 * mb_w) for k in (4, 5)]
    return [np.ascontiguousarray(y)] + [np.ascontiguousarray(p) for p in c]


def _quant_intra(coef: np.ndarray, q: np.ndarray) -> np.ndarray:
    """(n, 6, 64) coefficients (times 2^28) -> levels: the DC over its
    scaler, AC over 2q, rounded half up in magnitude; AC kept where its
    dequantised value fits 12 bits."""
    lv = np.zeros(coef.shape, np.int64)
    ys = np.array(mp.Y_DC_SCALE)[q]
    cs = np.array(mp.C_DC_SCALE)[q]
    d0 = np.stack([ys] * 4 + [cs] * 2, 1) * ONE
    lv[..., 0] = (coef[..., 0] + d0 // 2) // d0
    d = (2 * q)[:, None, None] * ONE
    mag = (np.abs(coef[..., 1:]) + d // 2) // d
    top = ((2047 - ((q - 1) | 1)) // (2 * q))[:, None, None]
    lv[..., 1:] = np.sign(coef[..., 1:]) * np.minimum(mag, top)
    return lv


def _quant_inter(coef: np.ndarray, q: np.ndarray) -> np.ndarray:
    """Levels of an inter residual: over 2q with a dead zone of a
    quarter step, truncated in magnitude, kept within 12 bits
    dequantised."""
    d = (2 * q)[:, None, None] * ONE
    mag = np.maximum(np.abs(coef) - d // 4, 0) // d
    top = ((2047 - ((q - 1) | 1)) // (2 * q))[:, None, None]
    return np.sign(coef) * np.minimum(mag, top)


def _dequant_inter(levels: np.ndarray, q: np.ndarray) -> np.ndarray:
    qmul = (2 * q)[:, None, None]
    qadd = ((q - 1) | 1)[:, None, None]
    return np.where(levels > 0, levels * qmul + qadd,
                    np.where(levels < 0, levels * qmul - qadd, 0))


class Writer:
    """An MPEG-4 Simple Profile encoder of ``height`` x ``width`` frames.
    ``resync`` sets the VOL's resync markers (needed for video packets);
    ``user_data`` (e.g. ``b"Lavc62.28.101"``, or None for none) goes after
    the VOL; ``signal`` (full range, matrix) writes a video signal type in
    the VO header; ``verid`` the VOL's version; ``headers_in_chunk`` False
    leaves the headers (:meth:`headers`) to the extradata.  ``edge`` is the border the
    decoder replicates (``"mb"``: the macroblock-aligned picture's, as
    FFmpeg does for Lavc streams; ``"visible"``: FF_BUG_EDGE's)."""

    def __init__(self, height: int, width: int, resync: bool = False,
                 user_data: Optional[bytes] = b"Lavc62.28.101",
                 signal: Optional[Tuple[bool, int]] = None, verid: int = 1,
                 headers_in_chunk: bool = True, edge: str = "mb",
                 vol_fields=None):
        self.h, self.w = height, width
        self.mb_h, self.mb_w = (height + 15) // 16, (width + 15) // 16
        self.resync, self.user_data, self.signal = resync, user_data, signal
        self.verid, self.headers_in_chunk = verid, headers_in_chunk
        self.edge = edge
        self.tib = max(1, (RESOLUTION - 1).bit_length())
        self.vol_fields = dict(vol_fields or {})
        self.ref = None
        self.frame = 0
        vo = (False, 2) if signal is None else signal
        self.vol = mp.Vol(width, height, 1, verid, True, 0, self.tib, False,
                          0, False, 0, False, False, resync, False, False,
                          False, False, False, *vo)
        st = mp.Decoder()
        st.vol = self.vol
        st._setup()
        st.dc_clip = False
        self.state = st

    # -- headers -------------------------------------------------------------
    def _vol(self, b: Bits) -> None:
        f = dict(VOL_DEFAULTS, resync=int(self.resync), **self.vol_fields)
        verid = self.verid
        b.start(0x20)
        b.put(0, 1)                             # random_accessible_vol
        b.put(f["vo_type"], 8)
        b.put(1, 1)                             # is_object_layer_identifier
        b.put(verid, 4)
        b.put(1, 3)
        b.put(1, 4)                             # square pixels
        b.put(f["vol_control"], 1)
        if f["vol_control"]:
            b.put(1, 2)                         # 4:2:0
            b.put(1, 1)                         # low_delay
            b.put(0, 1)                         # no vbv parameters
        b.put(f["shape"], 2)
        if f["shape"] == 3 and verid != 1:
            b.put(0, 4)
        b.put(1, 1)
        b.put(RESOLUTION, 16)
        b.put(1, 1)
        b.put(0, 1)                             # fixed_vop_rate
        if f["shape"] == 0:
            b.put(1, 1)
            b.put(self.w, 13)
            b.put(1, 1)
            b.put(self.h, 13)
            b.put(1, 1)
        b.put(f["interlaced"], 1)
        b.put(1, 1)                             # obmc_disable
        b.put(f["sprite"], 1 if verid == 1 else 2)
        b.put(f["not_8_bit"], 1)
        if f["not_8_bit"]:
            b.put(5, 4), b.put(8, 4)
        b.put(f["quant_type"], 1)
        if verid != 1:
            b.put(f["quarter_sample"], 1)
        b.put(1 - f["complexity"], 1)           # complexity estimation off
        b.put(1 - f["resync"], 1)               # resync_marker_disable
        b.put(f["data_partitioned"], 1)
        if f["data_partitioned"]:
            b.put(f["rvlc"], 1)
        if verid != 1:
            b.put(f["newpred"], 1)
            if f["newpred"]:
                b.put(0, 3)
            b.put(f["reduced"], 1)
        b.put(f["scalability"], 1)
        b.stuff()

    def headers(self) -> bytes:
        """VOS, VO, VO start, VOL and user data (what a keyframe chunk, or
        the extradata, starts with)."""
        b = Bits()
        b.start(0xB0)
        b.put(1, 8)                             # profile_and_level
        b.start(0xB5)
        b.put(1, 1)
        b.put(1, 4)
        b.put(1, 3)
        b.put(1, 4)                             # video
        if self.signal is None:
            b.put(0, 1)
        else:
            b.put(1, 1)
            b.put(5, 3)                         # video_format
            b.put(int(self.signal[0]), 1)
            b.put(1, 1)                         # colour_description
            b.put(self.signal[1], 8)
            b.put(self.signal[1], 8)
            b.put(self.signal[1], 8)
        b.stuff()
        b.start(0x00)
        self._vol(b)
        if self.user_data is not None:
            b.start(0xB2)
            for ch in self.user_data:
                b.put(ch, 8)
        return b.bytes()


    # -- frames ---------------------------------------------------------------
    def _vop_header(self, plan: Plan) -> Tuple[bytes, Bits]:
        """The chunk's headers (for an I-VOP: the stream's, where they go
        in the chunk, and a GOV) and the VOP header's bits."""
        head = b""
        if plan.kind == "I" and self.headers_in_chunk:
            head = self.headers()
        b = Bits()
        if plan.kind == "I":
            b.start(0xB3)                       # GOV
            b.put(0, 5), b.put(0, 6), b.put(1, 1), b.put(self.frame % 60, 6)
            b.put(1, 1), b.put(0, 1)
            b.stuff()
        b.start(0xB6)
        b.put({"I": 0, "P": 1, "N": 1}[plan.kind], 2)
        b.put(0, 1)                             # modulo_time_base
        b.put(1, 1)
        b.put(self.frame % RESOLUTION, self.tib)
        b.put(1, 1)
        self.frame += 1
        if plan.kind == "N":
            b.put(0, 1)
            return head, b
        b.put(1, 1)                             # vop_coded
        if plan.kind == "P":
            b.put(plan.rounding, 1)
        b.put(plan.dc_thr, 3)
        b.put(plan.quant, 5)
        if plan.kind == "P":
            b.put(plan.fcode, 3)
        return head, b

    def encode(self, planes, plan: Plan) -> Tuple[bytes, Optional[list]]:
        """One chunk (and the reconstruction, MB-aligned planes; None for
        an N-VOP) for ``planes`` (Y, U, V) under ``plan``."""
        mw, mh = self.mb_w, self.mb_h
        head, b = self._vop_header(plan)
        if plan.kind == "N":
            b.stuff()
            return head + b.bytes(), None
        src = pad_planes(planes, mh, mw)
        modes = np.full((mh, mw), INTRA) if plan.kind == "I" else \
            np.full((mh, mw), INTER) if plan.modes is None else \
            np.asarray(plan.modes)
        mvs = np.zeros((mh, mw, 4, 2), np.int64) if plan.mvs is None else \
            np.asarray(plan.mvs, np.int64)
        dq = np.zeros((mh, mw), np.int64) if plan.dquant is None else \
            np.asarray(plan.dquant, np.int64)
        acp = np.zeros((mh, mw), bool) if plan.ac_pred is None else \
            np.asarray(plan.ac_pred, bool)
        qs = self._qscales(plan, modes, dq)
        levels, recon = self._numeric(src, plan, modes, mvs, qs)
        self._layer(b, plan, modes, mvs, dq, acp, qs, levels)
        b.stuff()
        self.ref = recon
        return head + b.bytes(), recon

    def encode_native(self, planes, plan: Plan) -> Tuple[bytes, list]:
        """:meth:`encode` of a :func:`smoke_plan` frame by
        ``tests/_torch_mpeg4_enc.cpp``: the same chunk and reconstruction
        (it leaves the predictor state :meth:`encode` keeps behind, so a
        writer takes one or the other)."""
        lib = native_entropy()
        assert plan.kind in "IP" and plan.modes is None and plan.mvs is None \
            and plan.dquant is None and plan.ac_pred is None and \
            not plan.packets and not plan.stuffing and plan.dc_thr == 0
        head, b = self._vop_header(plan)
        prefix = np.frombuffer(head + b.bytes(), np.uint8)
        y, u, v = (np.ascontiguousarray(p, np.uint8) for p in planes)
        mw, mh = self.mb_w, self.mb_h
        recon = np.empty(384 * mw * mh, np.uint8)
        ref = np.ascontiguousarray(np.concatenate(
            [p.reshape(-1) for p in self.ref])) if plan.kind == "P" else \
            np.zeros(1, np.uint8)
        cap = 2 * y.size + 4 * u.size + prefix.size + 4096
        out = np.empty(cap, np.uint8)
        n = lib.clt_mpeg4_enc_layer(
            int(plan.kind == "P"), y.ctypes.data, u.ctypes.data,
            v.ctypes.data, self.h, self.w, plan.quant, prefix.ctypes.data,
            8 * len(head) + b.n, ref.ctypes.data, recon.ctypes.data,
            out.ctypes.data, cap)
        if n < 0:
            raise RuntimeError("the native MPEG-4 encoder's buffer is short")
        ls = 256 * mw * mh
        rec = [recon[:ls].reshape(16 * mh, 16 * mw),
               recon[ls:ls + 64 * mw * mh].reshape(8 * mh, 8 * mw),
               recon[ls + 64 * mw * mh:].reshape(8 * mh, 8 * mw)]
        self.ref = rec
        return out[:n].tobytes(), rec

    def _qscales(self, plan: Plan, modes, dq) -> np.ndarray:
        """Each macroblock's quantiser after its dquant (a packet's quant
        resets it)."""
        q = plan.quant
        out = np.zeros(modes.size, np.int64)
        for n in range(modes.size):
            if n in plan.packets and plan.packets[n][0]:
                q = plan.packets[n][0]
            if modes.flat[n] != SKIP and dq.flat[n]:
                q = min(max(q + int(dq.flat[n]), 1), 31)
            out[n] = q
        return out

    def _numeric(self, src, plan: Plan, modes, mvs, qs):
        """Levels (n, 6, 64) and the reconstruction."""
        mw, mh = self.mb_w, self.mb_h
        n = mw * mh
        cur = _all_blocks(src, mh, mw).astype(np.int64)
        flat = modes.reshape(-1)
        intra = flat == INTRA
        if plan.kind == "I" or self.ref is None:
            pred = np.zeros_like(cur)
        elif not mvs.any() and not (flat == INTER4).any():
            pred = _all_blocks(self.ref, mh, mw).astype(np.int64)
        else:
            pred = np.zeros_like(cur)
            he, ve = (self.w, self.h) if self.edge == "visible" else \
                (16 * mw, 16 * mh)
            st = self.state
            saved = st.ref
            st.ref = self.ref
            for k in np.flatnonzero(~intra):
                x, y = k % mw, k // mw
                kind = {SKIP: "skip", INTER: "inter", INTER4: "inter4"}[
                    flat[k]]
                mv = tuple(map(tuple, mvs[y, x])) if kind == "inter4" else \
                    ((0, 0),) if kind == "skip" else (tuple(mvs[y, x, 0]),)
                m = mp._Mb(x, y, kind, mv, 0, 0, None)
                pred[k] = st._predict(m, plan.rounding, he, ve)
            st.ref = saved
        levels = np.zeros((n, 6, 64), np.int64)
        out = pred.copy()
        if intra.any():
            coef = _fdct(cur[intra].reshape(-1, 8, 8)).reshape(-1, 6, 64)
            lv = _quant_intra(coef, qs[intra])
            levels[intra] = lv
            sums = mp.idct_sums(np.concatenate(
                [mp._dequant_intra(b, int(q)) for b, q in
                 zip(lv, qs[intra])]).reshape(-1, 64))
            out[intra] = np.clip(sums, 0, 255).reshape(-1, 6, 8, 8)
        coded = (flat == INTER) | (flat == INTER4)
        if coded.any():
            res = cur[coded] - pred[coded]
            coef = _fdct(res.reshape(-1, 8, 8)).reshape(-1, 6, 64)
            lv = _quant_inter(coef, qs[coded])
            levels[coded] = lv
            deq = _dequant_inter(lv, qs[coded])
            sums = mp.idct_sums(deq.reshape(-1, 64)).reshape(-1, 6, 8, 8)
            nz = (lv != 0).any(-1)[..., None, None]
            out[coded] = np.where(nz, np.clip(pred[coded] + sums, 0, 255),
                                  pred[coded])
        return levels, _put_all(out.astype(np.uint8), mh, mw)

    # -- macroblock layer ----------------------------------------------------
    def _layer(self, b: Bits, plan: Plan, modes, mvs, dq, acp, qs, levels):
        st = self.state
        mw, mh = self.mb_w, self.mb_h
        st.qscale = plan.quant
        st.mv = np.zeros((2 * mh, 2 * mw + 2, 2), np.int64)
        st.qtab = np.zeros(mh * st.cwrap, np.int64)
        st.resync, st.first_line = (0, 0), True
        thr = mp.DC_THRESHOLD[plan.dc_thr]
        ptype = 1 if plan.kind == "I" else 2
        for k in range(mw * mh):
            x, y = k % mw, k // mw
            if k in plan.packets:
                q, hec = plan.packets[k]
                b.stuff()
                need = 16 if plan.kind == "I" else plan.fcode + 15
                b.put(0, need), b.put(1, 1)
                b.put(k, (mw * mh - 1).bit_length())
                b.put(q, 5)
                if q:
                    st.qscale = q
                b.put(int(hec), 1)
                if hec:
                    b.put(0, 1), b.put(1, 1)
                    b.put(self.frame - 1, self.tib), b.put(1, 1)
                    b.put(ptype - 1, 2), b.put(plan.dc_thr, 3)
                    if plan.kind == "P":
                        b.put(plan.fcode, 3)
                st.resync, st.first_line = (x, y), True
                st._clean_buffers(x, y)
            if (x, y) == (st.resync[0], st.resync[1] + 1):
                st.first_line = False
            if k in plan.stuffing:
                if plan.kind == "P":
                    b.put(0, 1)
                    b.put(*mp.INTER_MCBPC[20])
                else:
                    b.put(*mp.INTRA_MCBPC[8])
            self._mb(b, plan, int(modes[y, x]), mvs[y, x], int(dq[y, x]),
                     bool(acp[y, x]), levels[k], x, y, thr)

    def _mb(self, b: Bits, plan: Plan, mode: int, mv, dq: int, acp: bool,
            lv: np.ndarray, x: int, y: int, thr: int) -> None:
        st = self.state
        if mode == SKIP:
            b.put(1, 1)
            st._store_mv(x, y, [(0, 0)] * 4)
            st._after(x, y, False)
            return
        if plan.kind == "P":
            b.put(0, 1)
        q_before = st.qscale
        if dq:
            st._set_q(st.qscale + dq)
        if mode == INTRA:
            dc_vlc = q_before < thr
            blocks, cbp = self._intra_levels(lv, x, y, dc_vlc, acp)
            if plan.kind == "P":
                b.put(*mp.INTER_MCBPC[(12 if dq else 4) + (cbp & 3)])
            else:
                b.put(*mp.INTRA_MCBPC[(4 if dq else 0) + (cbp & 3)])
            b.put(int(acp), 1)
            b.put(*mp.CBPY[cbp >> 2])
            if dq:
                b.put(mp.DQUANT.index(dq), 2)
            for n, (dc, events) in enumerate(blocks):
                if dc is not None:
                    size = abs(dc).bit_length()
                    b.put(*mp.DC_LUM[size] if n < 4 else mp.DC_CHROM[size])
                    if size:
                        b.put(dc if dc > 0 else dc + (1 << size) - 1, size)
                        if size > 8:
                            b.put(1, 1)
                for ev in events:
                    for c in ev:
                        b.put(*c)
            st._store_mv(x, y, [(0, 0)] * 4)
            st._after(x, y, True)
            return
        cbp = 0
        for n in range(6):
            if lv[n].any():
                cbp |= 32 >> n
        b.put(*mp.INTER_MCBPC[(24 if dq else 16) + (cbp & 3)]
              if mode == INTER4 else mp.INTER_MCBPC[(8 if dq else 0)
                                                    + (cbp & 3)])
        b.put(*mp.CBPY[(cbp >> 2) ^ 15])
        if dq:
            b.put(mp.DQUANT.index(dq), 2)
        if mode == INTER4:
            for i in range(4):
                px, py = st._pred_mv(x, y, i)
                for c in mv_codes(int(mv[i][0]) - px, plan.fcode) + \
                        mv_codes(int(mv[i][1]) - py, plan.fcode):
                    b.put(*c)
                st.mv[2 * y + (i >> 1), 1 + 2 * x + (i & 1)] = mv[i]
        else:
            px, py = st._pred_mv(x, y, 0)
            for c in mv_codes(int(mv[0][0]) - px, plan.fcode) + \
                    mv_codes(int(mv[0][1]) - py, plan.fcode):
                b.put(*c)
            st._store_mv(x, y, [tuple(mv[0])] * 4)
        for n in range(6):
            if cbp & (32 >> n):
                for ev in block_events(lv[n], mp.ZIGZAG, False, 0):
                    for c in ev:
                        b.put(*c)
        st._after(x, y, False)

    def _intra_levels(self, lv: np.ndarray, x: int, y: int, dc_vlc: bool,
                      acp: bool):
        """Each intra block's DC difference (None where it goes with the
        AC) and TCOEF events, the predictors updated as the decoder
        updates them; and the coded block pattern."""
        st = self.state
        out, cbp = [], 0
        for n in range(6):
            target = lv[n].copy()
            level = int(target[0])
            pred, direction = st._pred_dc(x, y, n, 0)
            diff = level - pred
            st._pred_dc(x, y, n, diff)
            sent = target.copy()
            sent[0] = diff
            if acp:
                p = np.zeros(64, np.int64)
                st._pred_ac(p, x, y, n, direction, 1)
                sent[1:] = target[1:] - p[1:]
            st._pred_ac(target.copy(), x, y, n, direction, 0)
            scan = (mp.ALT_V if direction == 0 else mp.ALT_H) if acp \
                else mp.ZIGZAG
            start = 1 if dc_vlc else 0
            coded = sent[list(scan[start:])].any()
            if coded:
                cbp |= 32 >> n
            events = block_events(sent, scan, True, start) if coded else []
            out.append((diff if dc_vlc else None, events))
        return out, cbp


def block_events(block: np.ndarray, scan, intra: bool, start: int):
    """The TCOEF codes of a block's levels in ``scan`` order from
    ``start``."""
    seq = np.asarray(block)[list(scan)]
    nz = [i for i in range(start, 64) if seq[i]]
    out = []
    prev = start - 1
    for k, i in enumerate(nz):
        last = int(k == len(nz) - 1)
        out.append(tcoef_codes(intra, last, i - prev - 1, int(seq[i])))
        prev = i
    return out


def write_mpeg4_avi(path: Path, payloads: Sequence[bytes], height: int,
                    width: int, tag: str = "FMP4",
                    handler: Optional[str] = None, extradata: bytes = b"",
                    fps: int = 30, stream: int = 0, others=()) -> None:
    """An AVI of MPEG-4 chunks: ``tag`` the BITMAPINFOHEADER's
    compression, ``handler`` the stream header's (the tag where None),
    ``extradata`` after the header."""
    strh, strf = video_headers(height, width, (handler or tag).encode(), 24,
                               len(payloads),
                               max(map(len, payloads), default=0), fps,
                               compression=tag.encode())
    strf = (40 + len(extradata)).to_bytes(4, "little") + strf[4:40] + \
        extradata
    write_avi(path, strh, strf, payloads, b"dc", fps=fps, stream=stream,
              others=others)


def encode_video(pictures, plans: Sequence[Plan], **kw):
    """The chunks and reconstructions of ``pictures`` ((Y, U, V) planes)
    under ``plans`` (N-VOPs give no reconstruction)."""
    h, w = pictures[0][0].shape
    wr = Writer(h, w, **kw)
    chunks, recons = [], []
    for pic, plan in zip(pictures, plans):
        c, r = wr.encode(pic, plan)
        chunks.append(c)
        if r is not None:
            recons.append(r)
    return chunks, recons, wr


def smoke_plan(kind: str, quant: int = 6, rounding: int = 0) -> Plan:
    """The plans ``chip_smoke.py`` codes its 4K videos with: intra I-VOPs,
    P-VOPs whose macroblocks are all 1MV of zero vectors (no packets, no
    dquant, no AC prediction, intra DC through its VLC)."""
    return Plan(kind=kind, quant=quant, rounding=rounding, dc_thr=0)


_ENC_SRC = Path(__file__).resolve().parent / "_torch_mpeg4_enc.cpp"
_enc_lib = None


def native_entropy():
    """``tests/_torch_mpeg4_enc.cpp``, built with g++ on first use into
    ``build/native/``; raises RuntimeError where it does not build."""
    global _enc_lib
    if _enc_lib is not None:
        return _enc_lib
    from camera_linearity_tpu_torch import native
    path = native._lib_path("_mpeg4_enc", _ENC_SRC)
    if not path.exists() and not native._build(path, _ENC_SRC):
        raise RuntimeError("tests/_torch_mpeg4_enc.cpp did not build: "
                           f"{native.build_error('_mpeg4_enc')}")
    lib = ctypes.CDLL(str(path))
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.clt_mpeg4_enc_layer.argtypes = [i, vp, vp, vp, i, i, i, vp,
                                        ctypes.c_longlong, vp, vp, vp,
                                        ctypes.c_size_t]
    lib.clt_mpeg4_enc_layer.restype = ctypes.c_longlong
    _enc_lib = lib
    return lib
