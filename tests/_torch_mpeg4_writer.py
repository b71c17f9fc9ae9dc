"""MPEG-4 Part 2 (Simple and Advanced Simple Profile) encoder and AVI
writer for the port's MPEG-4 tests (NumPy, no cv2 or FFmpeg).

:class:`Writer` encodes yuv420p pictures into I-, P-, B- and N-VOP chunks
under a per-frame :class:`Plan`, in coded order: each macroblock's kind
(skipped, 1MV, 4MV, intra; a B-VOP's direct with or without a delta,
interpolated, backward, forward), its vectors (half pels, any ``fcode``
and ``bcode``, past every edge), its ``dquant`` (``dbquant``), its
``ac_pred_flag``, the video packets (resync markers, with or without HEC)
and the VOP's display time, rounding type, quantiser and
``intra_dc_vlc_thr``: the features cv2's writer never uses.  The VOL may
ask for MPEG quantisation (``quant_type`` 1, the default or custom
matrices), and the user data may name Xvid or DivX builds; the writer then
reconstructs with the Xvid IDCT where FFmpeg picks it (``xvid``).  It
returns the chunks and its own reconstruction, the macroblock-aligned
planes FFmpeg's decoder gives: the prediction (``mpeg4_plain``'s motion
compensation and edge rules, a B-VOP's average of both references), plus
the dequantised residual through FFmpeg's simple or Xvid IDCT.  The levels
come from a float DCT of the picture (or of its residual) and a plain
quantiser; the syntax elements (DC and AC prediction, vector prediction,
direct mode) follow the decoder's rules by driving a
``mpeg4_plain.Decoder``'s predictor state alongside, so a stream that cv2
decodes to the reconstruction holds both.  :func:`pack` turns the chunks
into a packed bitstream's (an I- or P-VOP and the B-VOP after it in one
chunk, a placeholder for the delayed frame), as DivX 5 and Xvid write.

``write_mpeg4_avi`` writes the container (``tests/_torch_rawvideo_writer``);
``tests/_torch_mpeg4_enc.cpp`` (:func:`native_entropy`) codes the
macroblock layer of the plans :func:`smoke_plan` makes (intra I-VOPs,
P-VOPs of zero vectors, B-VOPs of direct macroblocks without a delta,
either quantisation and IDCT) with the same bytes, for ``chip_smoke.py``'s
4K videos.
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
           "smoke_plan", "native_entropy", "encode_video", "pack",
           "display_order", "asp_order", "encode_asp", "nvop_chunk"]

SKIP, INTER, INTER4, INTRA = 0, 1, 2, 3
# a B-VOP's macroblock kinds (a macroblock the latest reference skipped is
# skipped whatever its kind)
DIRECT, DIRECT_NONE, BI, BWD, FWD = 4, 5, 6, 7, 8
RESOLUTION = 30     # vop_time_increment_resolution

# the VOL's fields a test may change (``Writer(vol_fields=...)``)
VOL_DEFAULTS = dict(vo_type=1, vol_control=1, low_delay=1, shape=0,
                    interlaced=0, sprite=0, not_8_bit=0, quant_type=0,
                    quarter_sample=0, complexity=0, data_partitioned=0,
                    rvlc=0, newpred=0, reduced=0, scalability=0)


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
    """How one frame is coded.  ``kind`` "I", "P", "B" or "N" (an N-VOP);
    ``modes`` (mb_h, mb_w) of SKIP/INTER/INTER4/INTRA (an I-VOP: all
    intra) or, for a B-VOP, DIRECT/DIRECT_NONE/BI/BWD/FWD (default
    DIRECT: direct, the delta from ``deltas``, default 0); ``mvs`` (mb_h,
    mb_w, 4, 2) half-pel vectors (1MV and a B-VOP's forward vector take
    the first), ``bmvs`` (mb_h, mb_w, 2) a B-VOP's backward vectors,
    ``deltas`` (mb_h, mb_w, 2) its direct macroblocks' deltas (-32..31); ``dquant`` (mb_h, mb_w) in -2..2 for
    coded macroblocks (a B-VOP's -2, 0 or 2, for its coded macroblocks
    that are not direct); ``ac_pred`` (mb_h, mb_w) for intra ones;
    ``packets`` macroblock number: (quant or 0, HEC) of the video packets
    after the first; ``stuffing`` macroblock numbers preceded by a
    stuffing code; ``time`` the display time in VOP time ticks (default:
    the chunk's index)."""
    kind: str = "I"
    quant: int = 8
    rounding: int = 0
    fcode: int = 1
    bcode: int = 1
    dc_thr: int = 0
    modes: Optional[np.ndarray] = None
    mvs: Optional[np.ndarray] = None
    bmvs: Optional[np.ndarray] = None
    deltas: Optional[np.ndarray] = None
    dquant: Optional[np.ndarray] = None
    ac_pred: Optional[np.ndarray] = None
    packets: Dict[int, Tuple[int, bool]] = field(default_factory=dict)
    stuffing: Sequence[int] = ()
    time: Optional[int] = None


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


def _quant_mpeg_intra(coef: np.ndarray, q: np.ndarray, matrix
                      ) -> np.ndarray:
    """quant_type 1's intra levels: the DC as for H.263, each AC over
    ``q * matrix / 8``, rounded half up in magnitude, kept where the
    decoder's 16-bit product and the 12-bit escape hold it (0 where the
    matrix is)."""
    lv = _quant_intra(coef, q)
    qw = (2 * q[:, None] * np.asarray(matrix, np.int64)[None, 1:])[:, None,
                                                                  :]
    d = np.maximum(qw, 1) * ONE
    mag = (16 * np.abs(coef[..., 1:]) + d // 2) // d
    top = np.minimum(np.minimum(2047 * 16 // np.maximum(qw, 1),
                                32767 // np.maximum(qw, 1)), 2047)
    lv[..., 1:] = np.where(qw > 0, np.sign(coef[..., 1:]) *
                           np.minimum(mag, top), 0)
    return lv


def _quant_mpeg_inter(coef: np.ndarray, q: np.ndarray, matrix
                      ) -> np.ndarray:
    """quant_type 1's inter levels: ``|coef| 8 / (q matrix) - 1/4``
    truncated, kept where ``(2 |level| + 1) q matrix / 32`` fits 12 bits,
    its 16-bit product and the 12-bit escape (``2 q``: the decoder's
    doubled quantiser)."""
    qw = (2 * q[:, None] * np.asarray(matrix, np.int64)[None, :])[:, None, :]
    d = np.maximum(qw, 1) * ONE
    mag = np.maximum(64 * np.abs(coef) - d, 0) // (4 * d)
    top = np.minimum(np.minimum((2047 * 32 // np.maximum(qw, 1) - 1) // 2,
                                (65535 // np.maximum(qw, 1) - 1) // 2), 2047)
    return np.where(qw > 0, np.sign(coef) * np.minimum(mag, top), 0)


def matrix_values(values) -> Optional[Tuple[int, ...]]:
    """The natural-order matrix a VOL's ``values`` (zigzag order; fewer
    than 64: a 0 ends them and the last repeats) load, as the decoder
    reads them."""
    b = Bits()
    for v in values:
        b.put(v, 8)
    if len(values) < 64:
        b.put(0, 8)
    return mp._load_matrix(mp._Bits(b.bytes()))


class Writer:
    """An MPEG-4 Simple / Advanced Simple Profile encoder of ``height`` x
    ``width`` frames, fed in coded order.  ``resync`` sets the VOL's resync
    markers (needed for video packets); ``user_data`` (e.g.
    ``b"Lavc62.28.101"``, a tuple of several such strings, or None for
    none) goes after the VOL; ``signal`` (full range, matrix) writes a
    video signal type in the VO header; ``verid`` the VOL's version;
    ``headers_in_chunk`` False leaves the headers (:meth:`headers`) to the
    extradata.  ``edge`` is the border the decoder replicates (``"mb"``:
    the macroblock-aligned picture's, as FFmpeg does for Lavc streams;
    ``"visible"``: FF_BUG_EDGE's).  ``vol_fields`` sets VOL fields
    (``quant_type`` 1 with ``matrices``: the intra and inter matrices'
    values in zigzag order, None for the default, fewer than 64 ended by a
    0; ``low_delay`` 0 for a stream with B-VOPs); ``xvid`` whether the
    decoder uses the Xvid IDCT (default: where a user data string is
    Xvid's); ``resolution`` the VOL's ticks a second."""

    def __init__(self, height: int, width: int, resync: bool = False,
                 user_data=b"Lavc62.28.101",
                 signal: Optional[Tuple[bool, int]] = None, verid: int = 1,
                 headers_in_chunk: bool = True, edge: str = "mb",
                 vol_fields=None, xvid: Optional[bool] = None,
                 resolution: int = RESOLUTION, matrices=(None, None)):
        self.h, self.w = height, width
        self.mb_h, self.mb_w = (height + 15) // 16, (width + 15) // 16
        self.resync, self.signal = resync, signal
        self.user_data = () if user_data is None else (user_data,) \
            if isinstance(user_data, bytes) else tuple(user_data)
        self.verid, self.headers_in_chunk = verid, headers_in_chunk
        self.edge = edge
        self.resolution = resolution
        self.tib = max(1, (resolution - 1).bit_length())
        self.vol_fields = dict(vol_fields or {})
        self.xvid = any(u.startswith(b"XviD") for u in self.user_data) \
            if xvid is None else xvid
        self.idct = mp.xvid_idct_sums if self.xvid else mp.idct_sums
        self.matrices = tuple(matrices)
        mats = (None, None)
        if dict(VOL_DEFAULTS, **self.vol_fields)["quant_type"]:
            mats = tuple(d if m is None else matrix_values(m) for m, d in
                         zip(self.matrices, (mp.DEFAULT_INTRA,
                                             mp.DEFAULT_INTER)))
        self.intra_matrix, self.inter_matrix = mats
        self.fwd = self.ref = None   # the references: older, latest
        self.frame = 0
        # the decoder's clock, mirrored (GOV headers and I- and P-VOPs move
        # it; a B-VOP's times are counted from it)
        self.time_base = self.last_time_base = 0
        self.last_non_b_time = self.pp_time = self.pb = 0
        vo = (False, 2) if signal is None else signal
        self.vol = mp.Vol(width, height, 1, verid, True, 0, self.tib, False,
                          0, False, 0, False, False, resync, False, False,
                          False, False, False, *vo, resolution=resolution,
                          intra_matrix=mats[0], inter_matrix=mats[1])
        st = mp.Decoder()
        st.vol = self.vol
        st._setup()
        st.dc_clip = False
        st.frame = mp.FrameHeader("I", intra_matrix=mats[0],
                                  inter_matrix=mats[1])
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
            b.put(f["low_delay"], 1)
            b.put(0, 1)                         # no vbv parameters
        b.put(f["shape"], 2)
        if f["shape"] == 3 and verid != 1:
            b.put(0, 4)
        b.put(1, 1)
        b.put(self.resolution, 16)
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
        if f["quant_type"]:
            for values in self.matrices:
                b.put(values is not None, 1)
                for v in values or ():
                    b.put(v, 8)
                if values is not None and len(values) < 64:
                    b.put(0, 8)
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
        for text in self.user_data:
            b.start(0xB2)
            for ch in text:
                b.put(ch, 8)
        return b.bytes()

    # -- frames ---------------------------------------------------------------
    def _vop_header(self, plan: Plan) -> Tuple[bytes, Bits]:
        """The chunk's headers (for an I-VOP: the stream's, where they go
        in the chunk, and a GOV of its second) and the VOP header's bits;
        moves the mirrored clock as the decoder will."""
        head = b""
        if plan.kind == "I" and self.headers_in_chunk:
            head = self.headers()
        t = self.frame if plan.time is None else plan.time
        secs, inc = divmod(t, self.resolution)
        b = Bits()
        if plan.kind == "I":
            b.start(0xB3)                       # GOV
            b.put(secs // 3600, 5), b.put(secs // 60 % 60, 6), b.put(1, 1)
            b.put(secs % 60, 6), b.put(1, 1), b.put(0, 1)
            b.stuff()
            self.time_base = secs
        b.start(0xB6)
        b.put({"I": 0, "P": 1, "N": 1, "B": 2}[plan.kind], 2)
        if plan.kind == "B":
            modulo = secs - self.last_time_base
            tick = (self.last_time_base + modulo) * self.resolution + inc
            self.pb = (self.pp_time - (self.last_non_b_time - tick)) & 0xFFFF
        else:
            modulo = secs - self.time_base
            self.last_time_base, self.time_base = self.time_base, secs
            tick = secs * self.resolution + inc
            self.pp_time = (tick - self.last_non_b_time) & 0xFFFF
            self.last_non_b_time = tick
        assert modulo >= 0, "a VOP before its time base (reorder the plans)"
        b.put((1 << modulo) - 1, modulo)        # modulo_time_base
        b.put(0, 1)
        b.put(1, 1)
        b.put(inc, self.tib)
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
        if plan.kind in "PB":
            b.put(plan.fcode, 3)
        if plan.kind == "B":
            b.put(plan.bcode, 3)
        return head, b

    def encode(self, planes, plan: Plan) -> Tuple[bytes, Optional[list]]:
        """One chunk (and the reconstruction, MB-aligned planes; None for
        an N-VOP) for ``planes`` (Y, U, V) under ``plan``."""
        mw, mh = self.mb_w, self.mb_h
        head, b = self._vop_header(plan)
        if plan.kind == "N":
            b.stuff()
            return head + b.bytes(), None
        st = self.state
        # (a B-VOP with no distance between its references, which FFmpeg
        # skips, is coded as if they were a tick apart)
        st.frame = mp.FrameHeader(plan.kind, pb=self.pb,
                                  pp=self.pp_time or 1,
                                  intra_matrix=self.intra_matrix,
                                  inter_matrix=self.inter_matrix)
        src = pad_planes(planes, mh, mw)
        modes = np.full((mh, mw), INTRA) if plan.kind == "I" else \
            np.asarray(plan.modes) if plan.modes is not None else \
            np.full((mh, mw), INTER if plan.kind == "P" else DIRECT)
        if plan.kind == "B":
            modes = np.where(st.colo_skip.reshape(mh, mw), SKIP, modes)
        mvs = np.zeros((mh, mw, 4, 2), np.int64) if plan.mvs is None else \
            np.asarray(plan.mvs, np.int64)
        dq = np.zeros((mh, mw), np.int64) if plan.dquant is None else \
            np.asarray(plan.dquant, np.int64)
        acp = np.zeros((mh, mw), bool) if plan.ac_pred is None else \
            np.asarray(plan.ac_pred, bool)
        if plan.kind == "B":
            levels, recon, qs, vecs = self._numeric_b(src, plan, modes, mvs,
                                                      dq)
            self._layer(b, plan, modes, mvs, dq, acp, qs, levels, vecs)
            b.stuff()
            return head + b.bytes(), recon
        qs = self._qscales(plan, modes, dq)
        levels, recon = self._numeric(src, plan, modes, mvs, qs)
        self._layer(b, plan, modes, mvs, dq, acp, qs, levels)
        b.stuff()
        self._keep(modes, mvs)
        self.fwd, self.ref = self.ref, recon
        return head + b.bytes(), recon

    def _keep(self, modes, mvs) -> None:
        """An I- or P-VOP's vectors as the decoder's ``motion_val`` holds
        them (the predictor state's, after the macroblock layer), skipped
        and 4MV macroblocks, which the B-VOPs after it read."""
        st = self.state
        flat = modes.reshape(-1)
        mv = st.mv[:, 1:-1].reshape(self.mb_h, 2, self.mb_w, 2, 2)
        st.colo_mv[:] = mv.transpose(0, 2, 1, 3, 4).reshape(-1, 4, 2)
        st.colo_skip[:] = flat == SKIP
        st.colo_four[:] = flat == INTER4

    def encode_native(self, planes, plan: Plan) -> Tuple[bytes, list]:
        """:meth:`encode` of a :func:`smoke_plan` frame by
        ``tests/_torch_mpeg4_enc.cpp``: the same chunk and reconstruction
        (it leaves the predictor state :meth:`encode` keeps behind, so a
        writer takes one or the other)."""
        lib = native_entropy()
        assert plan.kind in "IPB" and plan.modes is None and \
            plan.mvs is None and plan.dquant is None and \
            plan.ac_pred is None and not plan.packets and \
            not plan.stuffing and plan.dc_thr == 0 and not self.resync
        head, b = self._vop_header(plan)
        prefix = np.frombuffer(head + b.bytes(), np.uint8)
        y, u, v = (np.ascontiguousarray(p, np.uint8) for p in planes)
        mw, mh = self.mb_w, self.mb_h
        recon = np.empty(384 * mw * mh, np.uint8)

        def flat(ref):
            return np.ascontiguousarray(np.concatenate(
                [p.reshape(-1) for p in ref])) if ref is not None else \
                np.zeros(1, np.uint8)
        ref = flat(self.ref if plan.kind != "I" else None)
        fwd = flat(self.fwd if plan.kind == "B" else None)
        mats = np.array((self.intra_matrix or (0,) * 64) +
                        (self.inter_matrix or (0,) * 64), np.int32)
        cap = 2 * y.size + 4 * u.size + prefix.size + 4096
        out = np.empty(cap, np.uint8)
        kind = "IPB".index(plan.kind)
        n = lib.clt_mpeg4_enc_layer(
            kind, y.ctypes.data, u.ctypes.data, v.ctypes.data, self.h,
            self.w, plan.quant, prefix.ctypes.data, 8 * len(head) + b.n,
            ref.ctypes.data, fwd.ctypes.data, recon.ctypes.data,
            int(self.intra_matrix is not None), mats.ctypes.data,
            int(self.xvid), out.ctypes.data, cap)
        if n < 0:
            raise RuntimeError("the native MPEG-4 encoder's buffer is short")
        ls = 256 * mw * mh
        rec = [recon[:ls].reshape(16 * mh, 16 * mw),
               recon[ls:ls + 64 * mw * mh].reshape(8 * mh, 8 * mw),
               recon[ls + 64 * mw * mh:].reshape(8 * mh, 8 * mw)]
        if plan.kind != "B":
            self.fwd, self.ref = self.ref, rec
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

    def _quant_inter(self, coef, q):
        if self.inter_matrix is not None:
            return _quant_mpeg_inter(coef, q, self.inter_matrix)
        return _quant_inter(coef, q)

    def _residual(self, levels, q: int) -> np.ndarray:
        """(6, 64) inter levels of one macroblock -> their IDCT sums (the
        dequantisation the decoder applies, then its IDCT)."""
        if self.inter_matrix is not None:
            deq = mp.dequant_mpeg_inter(levels, q, self.inter_matrix)
        else:
            deq = _dequant_inter(levels[None], np.array([q]))[0]
        return self.idct(deq.reshape(-1, 64)).reshape(6, 8, 8)

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
            for k in np.flatnonzero(~intra):
                x, y = k % mw, k // mw
                kind = {SKIP: "skip", INTER: "inter", INTER4: "inter4"}[
                    flat[k]]
                mv = tuple(map(tuple, mvs[y, x])) if kind == "inter4" else \
                    ((0, 0),) if kind == "skip" else (tuple(mvs[y, x, 0]),)
                pred[k] = st._predict(self.ref, x, y, kind, mv,
                                      plan.rounding, he, ve)
        levels = np.zeros((n, 6, 64), np.int64)
        out = pred.copy()
        if intra.any():
            coef = _fdct(cur[intra].reshape(-1, 8, 8)).reshape(-1, 6, 64)
            if self.intra_matrix is not None:
                lv = _quant_mpeg_intra(coef, qs[intra], self.intra_matrix)
                deq = [mp.dequant_mpeg_intra(b, int(q), self.intra_matrix)
                       for b, q in zip(lv, qs[intra])]
            else:
                lv = _quant_intra(coef, qs[intra])
                deq = [mp._dequant_intra(b, int(q))
                       for b, q in zip(lv, qs[intra])]
            levels[intra] = lv
            sums = self.idct(np.concatenate(deq).reshape(-1, 64))
            out[intra] = np.clip(sums, 0, 255).reshape(-1, 6, 8, 8)
        coded = (flat == INTER) | (flat == INTER4)
        if coded.any():
            res = cur[coded] - pred[coded]
            coef = _fdct(res.reshape(-1, 8, 8)).reshape(-1, 6, 64)
            lv = self._quant_inter(coef, qs[coded])
            levels[coded] = lv
            sums = np.stack([self._residual(b, int(q))
                             for b, q in zip(lv, qs[coded])])
            nz = (lv != 0).any(-1)[..., None, None]
            out[coded] = np.where(nz, np.clip(pred[coded] + sums, 0, 255),
                                  pred[coded])
        return levels, _put_all(out.astype(np.uint8), mh, mw)

    def _b_vectors(self, k: int, mode: int, mvs, bmvs, deltas):
        """A B-VOP macroblock's (kind, forward vectors, backward vectors,
        four) as the decoder derives them."""
        st = self.state
        y, x = divmod(k, self.mb_w)
        if mode == SKIP:
            return "skip", ((0, 0),), (), False
        if mode in (DIRECT, DIRECT_NONE):
            d = (0, 0) if mode == DIRECT_NONE else tuple(deltas[y, x])
            four = bool(st.colo_four[k])
            f, b = st._direct(k, int(d[0]), int(d[1]), four)
            return "direct", f, b, four
        f = (tuple(mvs[y, x, 0]),) if mode in (FWD, BI) else ()
        b = (tuple(bmvs[y, x]),) if mode in (BWD, BI) else ()
        return {FWD: "fwd", BWD: "bwd", BI: "bi"}[mode], f, b, False

    def _numeric_b(self, src, plan: Plan, modes, mvs, dq):
        """A B-VOP's levels, reconstruction, quantisers and each
        macroblock's vectors: its quantiser takes a ``dbquant`` only where
        the macroblock codes a block (and is not direct), so the levels are
        found macroblock by macroblock."""
        mw, mh = self.mb_w, self.mb_h
        n = mw * mh
        st = self.state
        bmvs = np.zeros((mh, mw, 2), np.int64) if plan.bmvs is None else \
            np.asarray(plan.bmvs, np.int64)
        deltas = np.zeros((mh, mw, 2), np.int64) if plan.deltas is None \
            else np.asarray(plan.deltas, np.int64)
        self._delta = deltas
        he, ve = (self.w, self.h) if self.edge == "visible" else \
            (16 * mw, 16 * mh)
        cur = _all_blocks(src, mh, mw).astype(np.int64)
        flat = modes.reshape(-1)
        levels = np.zeros((n, 6, 64), np.int64)
        out = np.zeros_like(cur)
        qs = np.zeros(n, np.int64)
        vecs = []
        q = plan.quant
        for k in range(n):
            y, x = divmod(k, mw)
            if k in plan.packets and plan.packets[k][0]:
                q = plan.packets[k][0]
            kind, f, b, four = self._b_vectors(k, int(flat[k]), mvs, bmvs,
                                               deltas)
            vecs.append((f, b))
            m = mp._Mb(x, y, kind, f, 0, q, None, b, four)
            # (a B-VOP after a single reference, which FFmpeg skips, is
            # coded against it both ways)
            pred = st._predict_b(m, self.ref if self.fwd is None else
                                 self.fwd, self.ref, he, ve).astype(np.int64)
            out[k] = pred
            if flat[k] in (SKIP, DIRECT_NONE):
                qs[k] = q
                continue
            coef = _fdct(cur[k] - pred).reshape(1, 6, 64)
            mq = q
            if flat[k] != DIRECT and dq.flat[k]:
                mq = min(max(q + int(dq.flat[k]), 1), 31)
            lv = self._quant_inter(coef, np.array([mq]))[0]
            if lv.any():
                q = mq
                levels[k] = lv
                sums = self._residual(lv, q)
                nz = (lv != 0).any(-1)[:, None, None]
                out[k] = np.where(nz, np.clip(pred + sums, 0, 255), pred)
            qs[k] = q
        return levels, _put_all(out.astype(np.uint8), mh, mw), qs, vecs

    # -- macroblock layer ----------------------------------------------------
    def _layer(self, b: Bits, plan: Plan, modes, mvs, dq, acp, qs, levels,
               vecs=None):
        st = self.state
        mw, mh = self.mb_w, self.mb_h
        st.qscale = plan.quant
        st.mv = np.zeros((2 * mh, 2 * mw + 2, 2), np.int64)
        st.qtab = np.zeros(mh * st.cwrap, np.int64)
        st.resync, st.first_line = (0, 0), True
        st.last_mv[:] = 0
        thr = mp.DC_THRESHOLD[plan.dc_thr]
        ptype = {"I": 1, "P": 2, "B": 3}[plan.kind]
        for k in range(mw * mh):
            x, y = k % mw, k // mw
            if k in plan.packets:
                q, hec = plan.packets[k]
                b.stuff()
                need = 16 if plan.kind == "I" else plan.fcode + 15 if \
                    plan.kind == "P" else max(plan.fcode, plan.bcode, 2) + 15
                b.put(0, need), b.put(1, 1)
                b.put(k, (mw * mh - 1).bit_length())
                b.put(q, 5)
                if q:
                    st.qscale = q
                b.put(int(hec), 1)
                if hec:
                    b.put(0, 1), b.put(1, 1)
                    b.put(0, self.tib), b.put(1, 1)
                    b.put(ptype - 1, 2), b.put(plan.dc_thr, 3)
                    if plan.kind != "I":
                        b.put(plan.fcode, 3)
                    if plan.kind == "B":
                        b.put(plan.bcode, 3)
                st.resync, st.first_line = (x, y), True
                st._clean_buffers(x, y)
            if (x, y) == (st.resync[0], st.resync[1] + 1):
                st.first_line = False
            if plan.kind == "B":
                self._mb_b(b, plan, int(modes[y, x]), vecs[k], mvs[y, x],
                           int(qs[k]), levels[k], x, y)
                continue
            if k in plan.stuffing:
                if plan.kind == "P":
                    b.put(0, 1)
                    b.put(*mp.INTER_MCBPC[20])
                else:
                    b.put(*mp.INTRA_MCBPC[8])
            self._mb(b, plan, int(modes[y, x]), mvs[y, x], int(dq[y, x]),
                     bool(acp[y, x]), levels[k], x, y, thr)

    def _mb_b(self, b: Bits, plan: Plan, mode: int, vecs, mv, q: int,
              lv: np.ndarray, x: int, y: int) -> None:
        """A B-VOP macroblock: ``modb``, ``mb_type``, ``cbpb``,
        ``dbquant`` (towards ``q``) and the vectors (``vecs``: its forward
        and backward ones, each predicted from the last of its direction;
        a direct one's delta from the plan)."""
        st = self.state
        if x == 0:
            st.last_mv[:] = 0
        if mode in (SKIP, DIRECT_NONE):
            if mode == DIRECT_NONE:
                b.put(1, 1)
            st._after(x, y, False)
            return
        cbp = 0
        for n in range(6):
            if lv[n].any():
                cbp |= 32 >> n
        b.put(0, 1)                            # modb
        b.put(int(cbp == 0), 1)
        b.put(1, {DIRECT: 1, BI: 2, BWD: 3, FWD: 4}[mode])
        if cbp:
            b.put(cbp, 6)
        if mode != DIRECT and cbp:
            dq = q - st.qscale
            b.put(int(dq != 0), 1)
            if dq:
                b.put(int(dq > 0), 1)
            st._set_q(q)
        fwd, bwd = vecs
        if mode in (FWD, BI):
            for c in (0, 1):
                for code in mv_codes(int(fwd[0][c]) - int(st.last_mv[0, c]),
                                     plan.fcode):
                    b.put(*code)
            st.last_mv[0] = fwd[0]
        if mode in (BWD, BI):
            for c in (0, 1):
                for code in mv_codes(int(bwd[0][c]) - int(st.last_mv[1, c]),
                                     plan.bcode):
                    b.put(*code)
            st.last_mv[1] = bwd[0]
        if mode == DIRECT:
            for c in (0, 1):
                for code in mv_codes(int(self._delta[y, x, c]), 1):
                    b.put(*code)
        for n in range(6):
            if cbp & (32 >> n):
                for ev in block_events(lv[n], mp.ZIGZAG, False, 0):
                    for c in ev:
                        b.put(*c)
        st._after(x, y, False)

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
    """The chunks and reconstructions of ``pictures`` ((Y, U, V) planes,
    one a plan) under ``plans``, both in coded order (N-VOPs give no
    reconstruction)."""
    h, w = pictures[0][0].shape
    wr = Writer(h, w, **kw)
    chunks, recons = [], []
    for pic, plan in zip(pictures, plans):
        c, r = wr.encode(pic, plan)
        chunks.append(c)
        if r is not None:
            recons.append(r)
    return chunks, recons, wr


def display_order(plans: Sequence[Plan], recons, low_delay: bool):
    """The reconstructions (of the coded plans, in coded order) in the
    order FFmpeg outputs them: an I- or P-VOP at once where the stream is
    low-delay, else when the next one comes (and the last at the end); a
    B-VOP at once where two references precede it, else never; a last
    N-VOP repeats the last I- or P-VOP."""
    out, held, anchors, it = [], None, 0, iter(recons)
    for plan in plans:
        if plan.kind == "N":
            continue
        r = next(it)
        if plan.kind == "B":
            if anchors >= 2:
                out.append(r)
            continue
        if low_delay:
            out.append(r)
        elif held is not None:
            out.append(held)
        held, anchors = r, anchors + 1
    if held is not None and (not low_delay or plans[-1].kind == "N"):
        out.append(held)
    return out


def nvop_chunk(time_bits: int, increment: int = 0) -> bytes:
    """A P-type N-VOP (``vop_coded`` 0) alone: a packed bitstream's
    placeholder."""
    b = Bits()
    b.start(0xB6)
    b.put(1, 2), b.put(0, 1), b.put(1, 1), b.put(increment, time_bits)
    b.put(1, 1), b.put(0, 1)
    b.stuff()
    return b.bytes()


def pack(chunks: Sequence[bytes], plans: Sequence[Plan],
         placeholder: bytes) -> List[bytes]:
    """A packed bitstream's chunks (DivX 5, Xvid's packed mode) from the
    coded-order ones: an I- or P-VOP followed by a B-VOP takes it into its
    chunk, each further B-VOP keeps its own, and ``placeholder`` (an
    N-VOP, or a few bytes) ends the run, where the delayed frame's chunk
    would be."""
    out, i = [], 0
    while i < len(chunks):
        if plans[i].kind in "IP" and i + 1 < len(chunks) and \
                plans[i + 1].kind == "B":
            out.append(chunks[i] + chunks[i + 1])
            i += 2
            while i < len(chunks) and plans[i].kind == "B":
                out.append(chunks[i])
                i += 1
            out.append(placeholder)
        else:
            out.append(chunks[i])
            i += 1
    return out


def asp_order(n: int) -> List[Tuple[str, int]]:
    """The coded order of ``n`` displayed frames with two B-VOPs between
    references, as Xvid and DivX code by default: (kind, display time),
    an I-VOP first and a P-VOP last."""
    anchors = list(range(0, n - 1, 3)) + [n - 1]
    order = [("I", 0)]
    for a, b in zip(anchors, anchors[1:]):
        order.append(("P", b))
        order += [("B", t) for t in range(a + 1, b)]
    return order


# the smoke's ASP videos: Xvid user data (the Xvid IDCT) and DivX packed
# user data, as Xvid's packed mode writes them
ASP_USER_DATA = (b"XviD0050", b"DivX503b1393p")


def encode_asp(pictures, quant: int, matrices, native: bool = True):
    """``chip_smoke.py``'s ASP video of ``pictures`` ((Y, U, V) planes in
    display order): :func:`asp_order`, :func:`smoke_plan`'s macroblocks,
    ``quant_type`` 1 with ``matrices``, ``ASP_USER_DATA``, packed (an
    N-VOP after each run of B-VOPs), coded by
    ``tests/_torch_mpeg4_enc.cpp`` (``native``) or :meth:`Writer.encode`.
    Returns the chunks and the reconstruction in display order."""
    h, w = pictures[0][0].shape
    wr = Writer(h, w, user_data=ASP_USER_DATA, matrices=matrices,
                vol_fields=dict(low_delay=0, quant_type=1))
    chunks, plans, recons = [], [], {}
    for kind, t in asp_order(len(pictures)):
        plan = smoke_plan(kind, quant, t % 2 if kind == "P" else 0, time=t)
        chunk, recons[t] = (wr.encode_native if native else wr.encode)(
            pictures[t], plan)
        chunks.append(chunk)
        plans.append(plan)
    return pack(chunks, plans, nvop_chunk(wr.tib)), \
        [recons[t] for t in range(len(pictures))]


def smoke_plan(kind: str, quant: int = 6, rounding: int = 0,
               time: Optional[int] = None) -> Plan:
    """The plans ``chip_smoke.py`` codes its 4K videos with: intra I-VOPs,
    P-VOPs whose macroblocks are all 1MV of zero vectors, B-VOPs whose
    macroblocks are all direct with a zero delta, their blocks coded (no
    packets, no dquant, no AC prediction, intra DC through its VLC)."""
    return Plan(kind=kind, quant=quant, rounding=rounding, dc_thr=0,
                time=time)


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
                                        ctypes.c_longlong, vp, vp, vp, i, vp,
                                        i, vp, ctypes.c_size_t]
    lib.clt_mpeg4_enc_layer.restype = ctypes.c_longlong
    _enc_lib = lib
    return lib
