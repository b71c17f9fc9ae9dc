"""Plain version of the port's MPEG-4 Part 2 decoder (``mpeg4.cpp``): the
frame chunks of an MPEG-4 Part 2 AVI (``FMP4``, ``XVID``, ``DIVX``,
``DX50``, ...) into their yuv420p planes and into the (H, W, 3) BGR uint8
frames ``cv2.VideoCapture`` gives for them.

cv2 reads such an AVI through FFmpeg 8: the AVI demuxer, the ``mpeg4``
decoder (mpeg4videodec.c, h263dec.c, mpegvideo_motion.c) and swscale to
BGR24.  Written from ISO/IEC 14496-2 and those sources; the tables are the
standard's (``libavcodec``'s copies were compared byte for byte).  The
Simple Profile is read, as ``cv2.VideoWriter`` writes it and as a camera or
FFmpeg may write it, and so are the Advanced Simple tools Xvid and DivX 5
use by default:

* headers: the VOS, VO (its video signal type: the BT.709 matrix is taken,
  as swscale takes it from the frame) and VOL headers from the first
  keyframe chunk or from the ``strf`` bytes after the BITMAPINFOHEADER;
  user data, for the ``Lavc``, ``XviD``, ``DivX`` and ``FFmpeg`` strings
  FFmpeg's bug detection reads; GOV headers (skipped);
* I- and P-VOPs: ``mcbpc``/``cbpy``, ``dquant``, ``ac_pred_flag``,
  not-coded (skipped) macroblocks; intra DC through its own VLC or, from
  the ``intra_dc_vlc_thr`` of the VOP and the quantiser before the
  macroblock's ``dquant`` (FFmpeg's order), as the first AC coefficient;
  DC and AC prediction from the left and top blocks, the direction from
  the DC gradients, AC prediction rescaled across quantisers with
  rounding away from zero and the alternate scans; the three TCOEF escape
  modes (the third one's level dequantised and clipped to 12 bits, a zero
  level taken as ``-qadd`` as FFmpeg takes it); H.263 dequantisation in
  16-bit lanes; 1MV and 4MV vectors with median prediction, ``fcode``
  wrapping and FFmpeg's rules at the first row of a video packet;
* motion compensation in half pels with ``vop_rounding_type``: the
  reference is read through FFmpeg's edge emulation, which replicates the
  border of the macroblock-aligned picture (of the visible one where
  FFmpeg's bug detection sets ``FF_BUG_EDGE``: DivX 4, old Lavc); 4MV
  luma and chroma blocks clip their position to the visible picture
  first, as ``hpel_motion`` does; chroma vectors as FFmpeg derives them
  (the 1MV vector halved, a half pel where it is not a multiple of four;
  the 4MV sum with the H.263 rounding table).  Without rounding, the
  8-wide horizontal and vertical half-pel averages (4MV luma, all chroma)
  are FFmpeg's x86 MMXEXT ones, which average ``max(a - 1, 0)`` with
  ``b`` (``a`` the left pixel, or the one in an odd row of the block):
  off by one where ``a`` is 0 and ``b`` is odd; the 16-wide ones are
  exact (probed on libavcodec's planes, and held by
  ``tests/test_torch_mpeg4.py``'s rounding case);
* video packets (resync markers) with ``macroblock_number``,
  ``quant_scale`` and HEC, which reset the prediction at their bounds as
  FFmpeg resets it (``ff_mpeg4_clean_buffers``);
* the IDCT: FFmpeg's ``simple_idct`` as its x86-64 SSE2/AVX routines
  compute it (``jpeg_plain``'s, which the MJPEG decoder holds), put for
  intra blocks and added to the prediction, clipped, for inter ones;
* N-VOPs (``vop_coded`` 0): FFmpeg outputs no frame for them, nor for a
  chunk without a VOP (a header alone); an empty chunk the demuxer drops;
* the Xvid IDCT where FFmpeg's bug detection finds an Xvid build (``XviD``
  user data, or build 0 from an ``XVID``/``XVIX`` fourcc without ``Lavc``,
  ``DivX`` or ``FFmpeg`` user data), in the form cv2's x86-64 build runs
  (``ff_xvid_idct_sse2``, for intra and inter blocks; it stays on once
  switched), with the workarounds the build sets (FF_BUG_EDGE up to build
  12, FF_BUG_DC_CLIP up to 32);
* B-VOPs: ``modb``, ``mb_type`` (direct, interpolated, backward,
  forward), ``dbquant``, ``vop_fcode_backward``, forward and backward
  vectors predicted from the last of their direction (zeroed at each
  macroblock row and video packet); direct mode scales the latest
  reference's vectors as ``motion_val`` holds them (one or four) by the
  VOP times (``modulo_time_base`` and GOV time codes counted as FFmpeg
  counts them), plus the delta; a macroblock the latest reference skipped
  is skipped (the forward reference, no vector); the two predictions
  averaged rounding up.  A B-VOP is never a reference; FFmpeg skips one
  without two references before it or whose time does not lie between
  theirs.  FFmpeg's order: with ``low_delay`` 0 (the VOL's, or its rules
  for a VOL without VOL control) an I- or P-VOP is output when the next one
  is decoded, the last at the end; else at once;
* packed bitstreams (``DivX...p`` user data, DivX 5 and Xvid's packed
  mode): a chunk's I- or B-VOP after the one decoded waits for the next
  chunk, which FFmpeg then does not read (a placeholder: an N-VOP, or a
  few bytes);
* ``quant_type`` 1: the default or the VOL's matrices (a matrix cut short
  by a 0 repeats its last value), FFmpeg's x86 MPEG-2 dequantisers with
  the quantiser doubled in 16-bit lanes, mismatch control for inter
  blocks only.

The yuv420p frame (the visible part of the macroblock-aligned planes)
converts to BGR24 as the rawvideo reader's ``i420`` (``rawvideo_plain``):
swscale's unscaled path at an even height, its scaled path at an odd one.

Refused by name (:func:`unsupported`, before any decode where the VOL or
the first VOP shows it; a later VOP that is refused raises naming its
frame): S-VOPs (GMC) and sprites, quarter-pel, interlaced VOLs, data
partitioning and reversible VLCs, the short video header, shapes other
than rectangular, ``not_8_bit``, newpred, reduced resolution,
scalability, complexity estimation, a full-range video signal and
matrices other than BT.601 and BT.709.  A frame FFmpeg would decode with
an error, which it conceals, raises :class:`Mpeg4Error` naming the frame
and the macroblock.
"""
from __future__ import annotations

import re
from typing import List, NamedTuple, Optional, Tuple

import numpy as np

from .jpeg_plain import _W, _i16, _i32, _sat16, _simple_1d
from .rawvideo_plain import decode_bgr as _raw_bgr

__all__ = ["MPEG4_FOURCCS", "Mpeg4Error", "Vol", "Bugs", "parse_vol",
           "stream_headers", "vop_header", "xvid_build", "unsupported",
           "matrix_name", "FrameHeader", "Stream", "Decoder", "idct_sums",
           "xvid_idct_sums", "dequant_mpeg_intra", "dequant_mpeg_inter",
           "DEFAULT_INTRA", "DEFAULT_INTER", "i420_bytes", "decode_planes",
           "decode_bgr"]

# the fourccs FFmpeg maps to its mpeg4 decoder that cv2 reads here
# (cv2.VideoWriter writes MP4V under FMP4); stripped of trailing spaces
MPEG4_FOURCCS = ("FMP4", "XVID", "DIVX", "DX50", "MP4V", "mp4v", "XVIX",
                 "3IV2", "M4S2")


class Mpeg4Error(ValueError):
    """A stream or frame the decoder refuses or FFmpeg fails on."""


# -- tables (ISO/IEC 14496-2 annex B; libavcodec's h263data.c,
# mpeg4data.h) as (code, length) pairs in symbol order ----------------------
INTRA_MCBPC = ((1, 1), (1, 3), (2, 3), (3, 3), (1, 4), (1, 6), (2, 6),
               (3, 6), (1, 9))
# symbol = 4 * kind + cbpc for kinds inter, intra, inter+q, intra+q, 4MV;
# 20 is stuffing, 21-23 unused, 24-27 4MV+q
INTER_MCBPC = tuple(zip(
    (1, 3, 2, 5, 3, 4, 3, 3, 3, 7, 6, 5, 4, 4, 3, 2, 2, 5, 4, 5, 1, 0, 0, 0,
     2, 12, 14, 15),
    (1, 4, 4, 6, 5, 8, 8, 7, 3, 7, 7, 9, 6, 9, 9, 9, 3, 7, 7, 8, 9, 0, 0, 0,
     11, 13, 13, 13)))
CBPY = ((3, 4), (5, 5), (4, 5), (9, 4), (3, 5), (7, 4), (2, 6), (11, 4),
        (2, 5), (3, 6), (5, 4), (10, 4), (4, 4), (8, 4), (6, 4), (3, 2))
MVTAB = ((1, 1), (1, 2), (1, 3), (1, 4), (3, 6), (5, 7), (4, 7), (3, 7),
         (11, 9), (10, 9), (9, 9), (17, 10), (16, 10), (15, 10), (14, 10),
         (13, 10), (12, 10), (11, 10), (10, 10), (9, 10), (8, 10), (7, 10),
         (6, 10), (5, 10), (4, 10), (7, 11), (6, 11), (5, 11), (4, 11),
         (3, 11), (2, 11), (3, 12), (2, 12))
DC_LUM = ((3, 3), (3, 2), (2, 2), (2, 3), (1, 3), (1, 4), (1, 5), (1, 6),
          (1, 7), (1, 8), (1, 9), (1, 10), (1, 11))
DC_CHROM = ((3, 2), (2, 2), (1, 2), (1, 3), (1, 4), (1, 5), (1, 6), (1, 7),
            (1, 8), (1, 9), (1, 10), (1, 11), (1, 12))
# TCOEF: 102 (run, level, last) codes and the escape (the last pair)
INTER_VLC = (
    (2, 2), (15, 4), (21, 6), (23, 7), (31, 8), (37, 9), (36, 9), (33, 10),
    (32, 10), (7, 11), (6, 11), (32, 11), (6, 3), (20, 6), (30, 8), (15, 10),
    (33, 11), (80, 12), (14, 4), (29, 8), (14, 10), (81, 12), (13, 5),
    (35, 9), (13, 10), (12, 5), (34, 9), (82, 12), (11, 5), (12, 10),
    (83, 12), (19, 6), (11, 10), (84, 12), (18, 6), (10, 10), (17, 6),
    (9, 10), (16, 6), (8, 10), (22, 7), (85, 12), (21, 7), (20, 7), (28, 8),
    (27, 8), (33, 9), (32, 9), (31, 9), (30, 9), (29, 9), (28, 9), (27, 9),
    (26, 9), (34, 11), (35, 11), (86, 12), (87, 12), (7, 4), (25, 9),
    (5, 11), (15, 6), (4, 11), (14, 6), (13, 6), (12, 6), (19, 7), (18, 7),
    (17, 7), (16, 7), (26, 8), (25, 8), (24, 8), (23, 8), (22, 8), (21, 8),
    (20, 8), (19, 8), (24, 9), (23, 9), (22, 9), (21, 9), (20, 9), (19, 9),
    (18, 9), (17, 9), (7, 10), (6, 10), (5, 10), (4, 10), (36, 11), (37, 11),
    (38, 11), (39, 11), (88, 12), (89, 12), (90, 12), (91, 12), (92, 12),
    (93, 12), (94, 12), (95, 12), (3, 7))
INTRA_VLC = (
    (2, 2), (6, 3), (15, 4), (13, 5), (12, 5), (21, 6), (19, 6), (18, 6),
    (23, 7), (31, 8), (30, 8), (29, 8), (37, 9), (36, 9), (35, 9), (33, 9),
    (33, 10), (32, 10), (15, 10), (14, 10), (7, 11), (6, 11), (32, 11),
    (33, 11), (80, 12), (81, 12), (82, 12), (14, 4), (20, 6), (22, 7),
    (28, 8), (32, 9), (31, 9), (13, 10), (34, 11), (83, 12), (85, 12),
    (11, 5), (21, 7), (30, 9), (12, 10), (86, 12), (17, 6), (27, 8), (29, 9),
    (11, 10), (16, 6), (34, 9), (10, 10), (13, 6), (28, 9), (8, 10), (18, 7),
    (27, 9), (84, 12), (20, 7), (26, 9), (87, 12), (25, 8), (9, 10), (24, 8),
    (35, 11), (23, 8), (25, 9), (24, 9), (7, 10), (88, 12), (7, 4), (12, 6),
    (22, 8), (23, 9), (6, 10), (5, 11), (4, 11), (89, 12), (15, 6), (22, 9),
    (5, 10), (14, 6), (4, 10), (17, 7), (36, 11), (16, 7), (37, 11), (19, 7),
    (90, 12), (21, 8), (91, 12), (20, 8), (19, 8), (26, 8), (21, 9), (20, 9),
    (19, 9), (18, 9), (17, 9), (38, 11), (39, 11), (92, 12), (93, 12),
    (94, 12), (95, 12), (3, 7))
ESCAPE = 102


def _runs(spec):
    """(levels, runs) of a TCOEF table from its (run, max level) rows."""
    levels, runs = [], []
    for run, top in spec:
        levels += range(1, top + 1)
        runs += [run] * top
    return levels, runs


# (levels, runs, index of the first "last" code) of the two tables
_INTRA_SPEC = ([(0, 27), (1, 10), (2, 5), (3, 4), (4, 3), (5, 3), (6, 3),
                (7, 3), (8, 2), (9, 2)] + [(r, 1) for r in range(10, 15)],
               [(0, 8), (1, 3)] + [(r, 2) for r in range(2, 7)]
               + [(r, 1) for r in range(7, 21)])
_INTER_SPEC = ([(0, 12), (1, 6), (2, 4)] + [(r, 3) for r in range(3, 7)]
               + [(r, 2) for r in range(7, 11)]
               + [(r, 1) for r in range(11, 27)],
               [(0, 3), (1, 2)] + [(r, 1) for r in range(2, 41)])


class RunLevel(NamedTuple):
    """A TCOEF table: each code's level, run and last flag, and
    ff_rl_init's max_level[last][run] and max_run[last][level]."""
    level: Tuple[int, ...]
    run: Tuple[int, ...]
    last: Tuple[int, ...]
    max_level: Tuple[Tuple[int, ...], Tuple[int, ...]]
    max_run: Tuple[Tuple[int, ...], Tuple[int, ...]]


def _run_level(spec) -> RunLevel:
    l0, r0 = _runs(spec[0])
    l1, r1 = _runs(spec[1])
    max_level, max_run = [], []
    for levels, runs in ((l0, r0), (l1, r1)):
        ml, mr = [0] * 65, [0] * 65
        for lv, rn in zip(levels, runs):
            ml[rn] = max(ml[rn], lv)
            mr[lv] = max(mr[lv], rn)
        max_level.append(tuple(ml))
        max_run.append(tuple(mr))
    return RunLevel(tuple(l0 + l1), tuple(r0 + r1),
                    (0,) * len(l0) + (1,) * len(l1), tuple(max_level),
                    tuple(max_run))


RL_INTRA = _run_level(_INTRA_SPEC)
RL_INTER = _run_level(_INTER_SPEC)

ZIGZAG = (0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26,
          33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28, 35, 42, 49, 56,
          57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38,
          31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63)
ALT_H = (0, 1, 2, 3, 8, 9, 16, 17, 10, 11, 4, 5, 6, 7, 15, 14, 13, 12, 19,
         18, 24, 25, 32, 33, 26, 27, 20, 21, 22, 23, 28, 29, 30, 31, 34, 35,
         40, 41, 48, 49, 42, 43, 36, 37, 38, 39, 44, 45, 46, 47, 50, 51, 56,
         57, 58, 59, 52, 53, 54, 55, 60, 61, 62, 63)
ALT_V = (0, 8, 16, 24, 1, 9, 2, 10, 17, 25, 32, 40, 48, 56, 57, 49, 41, 33,
         26, 18, 3, 11, 4, 12, 19, 27, 34, 42, 50, 58, 35, 43, 51, 59, 20, 28,
         5, 13, 6, 14, 21, 29, 36, 44, 52, 60, 37, 45, 53, 61, 22, 30, 7, 15,
         23, 31, 38, 46, 54, 62, 39, 47, 55, 63)
Y_DC_SCALE = (0, 8, 8, 8, 8, 10, 12, 14, 16, 17, 18, 19, 20, 21, 22, 23, 24,
              25, 26, 27, 28, 29, 30, 31, 32, 34, 36, 38, 40, 42, 44, 46)
C_DC_SCALE = (0, 8, 8, 8, 8, 9, 9, 10, 10, 11, 11, 12, 12, 13, 13, 14, 14,
              15, 15, 16, 16, 17, 17, 18, 18, 19, 20, 21, 22, 23, 24, 25)
DC_THRESHOLD = (99, 13, 15, 17, 19, 21, 23, 0)
DQUANT = (-1, -2, 1, 2)
# ff_h263_round_chroma's table: the 4MV chroma vector from the luma sum
CHROMA_ROUND = (0, 0, 0, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2)

# the start codes the decoder acts on (the VOS, GOV and VO start codes
# it skips)
VO, VOL_FIRST, VOL_LAST, USER_DATA, VOP = 0x1B5, 0x120, 0x12F, 0x1B2, 0x1B6
VOP_TYPES = "IPBS"


def _lut(codes, nbits: int) -> list:
    """A table over every ``nbits``-bit window: (symbol, code length), or
    (-1, 0) where no code starts the window."""
    table = [(-1, 0)] * (1 << nbits)
    for sym, (code, n) in enumerate(codes):
        if n == 0:
            continue
        base = code << (nbits - n)
        for k in range(1 << (nbits - n)):
            assert table[base + k][1] == 0, "prefix clash"
            table[base + k] = (sym, n)
    return table


_LUT_INTRA_MCBPC = (_lut(INTRA_MCBPC, 9), 9)
_LUT_INTER_MCBPC = (_lut(INTER_MCBPC, 13), 13)
_LUT_CBPY = (_lut(CBPY, 6), 6)
_LUT_MV = (_lut(MVTAB, 12), 12)
_LUT_DC = ((_lut(DC_LUM, 11), 11), (_lut(DC_CHROM, 12), 12))
_LUT_TCOEF = ((_lut(INTER_VLC, 12), 12), (_lut(INTRA_VLC, 12), 12))


class _Bad(Exception):
    """Data FFmpeg fails to decode (it then conceals the frame)."""


class _Bits:
    """An MSB-first bit reader that reads zeros past its end, as FFmpeg's
    padded buffers do."""
    __slots__ = ("data", "pos", "end")

    def __init__(self, data: bytes):
        self.data = bytes(data) + bytes(8)
        self.pos = 0
        self.end = 8 * len(data)

    def peek(self, n: int) -> int:
        p = self.pos
        v = int.from_bytes(self.data[p >> 3:(p >> 3) + 5], "big")
        return (v >> (40 - (p & 7) - n)) & ((1 << n) - 1)

    def get(self, n: int) -> int:
        if n == 0:
            return 0
        v = self.peek(n)
        self.pos += n
        return v

    def sget(self, n: int) -> int:
        v = self.get(n)
        return v - (1 << n) if v >> (n - 1) else v

    def vlc(self, lut) -> int:
        sym, n = lut[0][self.peek(lut[1])]
        if not n:
            raise _Bad("no code")
        self.pos += n
        return sym

    def align(self) -> None:
        self.pos = (self.pos + 7) & ~7

    def left(self) -> int:
        return self.end - self.pos


class Vol(NamedTuple):
    """What the port reads of a video object layer header (and of the VO
    header before it: the video signal type)."""
    width: int
    height: int
    vo_type: int
    verid: int
    vol_control: bool
    shape: int
    time_increment_bits: int
    interlaced: bool
    sprite: int
    not_8_bit: bool
    quant_type: int
    quarter_sample: bool
    complexity_estimation: bool
    resync_marker: bool
    data_partitioned: bool
    rvlc: bool
    newpred: bool
    reduced_resolution: bool
    scalability: bool
    full_range: bool = False
    matrix: int = 2     # ISO/IEC 23001-8 matrix_coefficients; 2: none given
    low_delay: Optional[bool] = None   # the VOL control's, None: none given
    resolution: int = 30               # vop_time_increment_resolution
    # quant_type 1's matrices in natural order (None: quant_type 0)
    intra_matrix: Optional[Tuple[int, ...]] = None
    inter_matrix: Optional[Tuple[int, ...]] = None


class Bugs(NamedTuple):
    """What FFmpeg's bug detection (``ff_mpeg4_workaround_bugs``) reads
    from the user data and the fourcc: -1 where nothing was found."""
    lavc_build: int = -1
    xvid_build: int = -1
    divx_version: int = -1
    divx_build: int = -1
    divx_packed: bool = False


def _user_data(raw: bytes, bugs: Bugs) -> Bugs:
    """decode_user_data: the builds FFmpeg finds in one user data string."""
    text = raw.split(b"\0")[0].decode("latin-1")
    m = re.match(r"DivX(\d+)(?:Build|b)(\d+)(.?)", text)
    if m:
        bugs = bugs._replace(divx_version=int(m[1]), divx_build=int(m[2]),
                             divx_packed=m[3] == "p")
    build = None
    m = re.match(r"FFmpe[^b]*b(\d+)", text)
    if m:
        build = int(m[1])
    m2 = re.match(r"Lavc(\d+)\.(\d+)\.(\d+)", text)
    if build is None and m2:
        build = ((int(m2[1]) & 255) << 16) + ((int(m2[2]) & 255) << 8) \
            + (int(m2[3]) & 255)
    if build is None and text == "ffmpeg":
        build = 4600
    if build is not None:
        bugs = bugs._replace(lavc_build=build)
    m = re.match(r"XviD(\d+)", text)
    if m:
        bugs = bugs._replace(xvid_build=int(m[1]))
    return bugs


def _marker(r: _Bits) -> None:
    r.get(1)   # FFmpeg's check_marker only logs a missing one


# ff_mpeg4_default_intra_matrix / _non_intra_matrix, natural order
DEFAULT_INTRA = (8, 17, 18, 19, 21, 23, 25, 27, 17, 18, 19, 21, 23, 25, 27,
                 28, 20, 21, 22, 23, 24, 26, 28, 30, 21, 22, 23, 24, 26, 28,
                 30, 32, 22, 23, 24, 26, 28, 30, 32, 35, 23, 24, 26, 28, 30,
                 32, 35, 38, 25, 26, 28, 30, 32, 35, 38, 41, 27, 28, 30, 32,
                 35, 38, 41, 45)
DEFAULT_INTER = (16, 17, 18, 19, 20, 21, 22, 23, 17, 18, 19, 20, 21, 22, 23,
                 24, 18, 19, 20, 21, 22, 23, 24, 25, 19, 20, 21, 22, 23, 24,
                 26, 27, 20, 21, 22, 23, 25, 26, 27, 28, 21, 22, 23, 24, 26,
                 27, 28, 30, 22, 23, 24, 26, 27, 28, 30, 31, 23, 24, 25, 27,
                 28, 30, 31, 33)


def _load_matrix(r: _Bits) -> Tuple[int, ...]:
    """A quantisation matrix of the VOL: up to 64 values in zigzag order;
    a 0 ends it early and the last value before it fills the rest (all of
    it 0 where the first value is)."""
    m, last, i = [0] * 64, 0, 0
    while i < 64:
        if r.left() < 8:
            raise Mpeg4Error("a VOL whose quantisation matrix the data cut "
                             "short")
        v = r.get(8)
        if not v:
            break
        last = m[ZIGZAG[i]] = v
        i += 1
    for k in range(i, 64):
        m[ZIGZAG[k]] = last
    return tuple(m)


def parse_vol(r: _Bits, vo: Tuple[bool, int]) -> Vol:
    """decode_vol_header, at the bit after the start code; ``vo`` is the
    VO header's (full range, matrix)."""
    r.get(1)                                   # random_accessible_vol
    vo_type = r.get(8)
    if r.get(1):                               # is_object_layer_identifier
        verid = r.get(4)
        r.get(3)
    else:
        verid = 1
    if r.get(4) == 15:                         # extended PAR
        r.get(16)
    vol_control = bool(r.get(1))
    low_delay = None
    if vol_control:
        r.get(2)                               # chroma_format
        low_delay = bool(r.get(1))
        if r.get(1):                           # vbv_parameters
            r.get(15), _marker(r), r.get(15), _marker(r), r.get(15)
            _marker(r), r.get(3), r.get(11), _marker(r), r.get(15)
            _marker(r)
    shape = r.get(2)
    if shape == 3 and verid != 1:
        r.get(4)
    _marker(r)
    resolution = r.get(16)
    if not resolution:
        raise Mpeg4Error("a VOL of vop_time_increment_resolution 0")
    tib = max(1, (resolution - 1).bit_length())
    _marker(r)
    if r.get(1):                               # fixed_vop_rate
        r.get(tib)
    width = height = 0
    interlaced, sprite, not8, quant_type, qpel = False, 0, False, 0, False
    cplx, resync, dp, rvlc, newpred, rr, scal = (False,) * 7
    mats = (None, None)
    if shape != 2:
        if shape == 0:
            _marker(r)
            width = r.get(13)
            _marker(r)
            height = r.get(13)
            _marker(r)
        interlaced = bool(r.get(1))
        r.get(1)                               # obmc_disable
        sprite = r.get(1 if verid == 1 else 2)
        if not sprite:
            not8 = bool(r.get(1))
            if not8:
                r.get(8)
            quant_type = r.get(1)
            if quant_type:
                intra = _load_matrix(r) if r.get(1) else DEFAULT_INTRA
                inter = _load_matrix(r) if r.get(1) else DEFAULT_INTER
                mats = (intra, inter)
            qpel = bool(r.get(1)) if verid != 1 else False
            cplx = not r.get(1)
            if not cplx:
                resync = not r.get(1)
                dp = bool(r.get(1))
                rvlc = bool(r.get(1)) if dp else False
                if verid != 1:
                    newpred = bool(r.get(1))
                    if newpred:
                        r.get(3)
                    rr = bool(r.get(1))
                scal = bool(r.get(1))
    return Vol(width, height, vo_type, verid, vol_control, shape, tib,
               interlaced, sprite, not8, quant_type, qpel, cplx, resync, dp,
               rvlc, newpred, rr, scal, *vo, low_delay=low_delay,
               resolution=resolution, intra_matrix=mats[0],
               inter_matrix=mats[1])


def _visual_object(r: _Bits) -> Tuple[bool, int]:
    """mpeg4_decode_visual_object: (full range, matrix)."""
    if r.get(1):
        r.get(7)
    full, matrix = False, 2
    if r.get(4) in (1, 2):                     # video, still texture
        if r.get(1):                           # video_signal_type
            r.get(3)
            full = bool(r.get(1))
            if r.get(1):                       # colour_description
                r.get(16)
                matrix = r.get(8)
    return full, matrix


class VopHeader(NamedTuple):
    type: str            # "I", "P", "B" or "S"
    coded: bool
    rounding: int
    dc_threshold: int
    quant: int
    fcode: int
    bcode: int = 1
    seconds: int = 0     # modulo_time_base: the seconds it adds
    increment: int = 0   # vop_time_increment
    error: Optional[str] = None   # a field FFmpeg refuses (read after the
    #                               times, which may skip the VOP first)


class Headers(NamedTuple):
    """What one chunk's headers hold: the VOL (or None), the VO's signal
    type, the user data's builds, whether a short video header starts the
    chunk, the VOP header (None where the chunk holds no VOP) with the bit
    reader at its macroblock data, and the time code (in seconds) of the
    last GOV header before the VOP (None: none)."""
    vol: Optional[Vol]
    vo: Optional[Tuple[bool, int]]
    bugs: Bugs
    short_header: bool
    vop: Optional[VopHeader]
    bits: Optional[_Bits]
    gov: Optional[int] = None


GOV = 0x1B3


def stream_headers(data: bytes, vol: Optional[Vol] = None,
                   bugs: Bugs = Bugs(), vo=(False, 2)) -> Headers:
    """ff_mpeg4_decode_picture_header on one chunk (or the extradata):
    every start code up to the first VOP, whose header is read with the
    latest VOL (``vol``, where the chunk has none)."""
    r = _Bits(data)
    if r.peek(22) == 0x20:   # a short video header (H.263 picture start)
        return Headers(vol, vo, bugs, True, None, None)
    code, new_vol, new_vo, gov = 0xFF, None, None, None
    while r.pos < r.end:
        code = ((code << 8) | r.get(8)) & 0xFFFFFFFF
        if code & 0xFFFFFF00 != 0x100:
            continue
        if VOL_FIRST <= code <= VOL_LAST and new_vol is None:
            new_vo = new_vo or vo
            new_vol = parse_vol(r, new_vo)
        elif code == USER_DATA:
            start = r.pos >> 3
            n = 0
            while n < 255 and r.pos < r.end and r.peek(23):
                r.get(8)
                n += 1
            bugs = _user_data(r.data[start:start + n], bugs)
        elif code == VO:
            new_vo = _visual_object(r)
        elif code == GOV and r.peek(23):       # mpeg4_decode_gop_header
            hours, minutes = r.get(5), r.get(6)
            _marker(r)
            gov = r.get(6) + 60 * (minutes + 60 * hours)
        elif code == VOP:
            v = new_vol or vol
            if v is None:
                raise Mpeg4Error("a VOP before any VOL header")
            return Headers(new_vol, new_vo, bugs, False, vop_header(r, v), r,
                           gov)
        r.align()
        code = 0xFF
    return Headers(new_vol, new_vo, bugs, False, None, None, gov)


def vop_header(r: _Bits, vol: Vol) -> VopHeader:
    """decode_vop_header for a rectangular, progressive VOL; the reader is
    left at the macroblock data (at the end for an N-VOP)."""
    kind = VOP_TYPES[r.get(2)]
    seconds = 0
    while r.get(1):                            # modulo_time_base
        seconds += 1
    _marker(r)
    if not r.peek(vol.time_increment_bits + 1) & 1:
        raise Mpeg4Error("a VOP whose time increment does not fit the VOL "
                         "(FFmpeg guesses its width)")
    increment = r.get(vol.time_increment_bits)
    _marker(r)
    if not r.get(1):
        return VopHeader(kind, False, 0, 0, 0, 1, 1, seconds, increment)
    rounding = r.get(1) if kind in "PS" else 0
    dc_thr = DC_THRESHOLD[r.get(3)]
    if kind == "S":
        return VopHeader(kind, True, rounding, dc_thr, 0, 1, 1, seconds,
                         increment)
    quant = r.get(5)
    fcode = r.get(3) if kind in "PB" else 1
    bcode = r.get(3) if kind == "B" else 1
    error = None
    if quant == 0 or fcode == 0 or bcode == 0:
        error = ("a VOP header FFmpeg refuses (vop_quant, vop_fcode_forward "
                 "or vop_fcode_backward 0)")
    return VopHeader(kind, True, rounding, dc_thr, quant, fcode, bcode,
                     seconds, increment, error)


def xvid_build(tag: str, vol: Vol, bugs: Bugs) -> Bugs:
    """The first lines of ff_mpeg4_workaround_bugs: the Xvid build and
    DivX version FFmpeg assumes from the fourcc where no user data gave
    one."""
    none = bugs.xvid_build == -1 and bugs.divx_version == -1 and \
        bugs.lavc_build == -1
    if none and tag in ("XVID", "XVIX", "RMP4", "ZMP4", "SIPP"):
        bugs = bugs._replace(xvid_build=0)
    none = bugs.xvid_build == -1 and bugs.divx_version == -1 and \
        bugs.lavc_build == -1
    if none and tag == "DIVX" and vol.vo_type == 0 and not vol.vol_control:
        bugs = bugs._replace(divx_version=400)
    if bugs.xvid_build >= 0 and bugs.divx_version >= 0:
        bugs = bugs._replace(divx_version=-1, divx_build=-1)
    return bugs


def _u(x: int) -> int:
    return x & 0xFFFFFFFF   # C's unsigned comparison of an int


def edge_bug(bugs: Bugs) -> bool:
    """FF_BUG_EDGE: FFmpeg then replicates the visible picture's border,
    not the macroblock-aligned one's."""
    return _u(bugs.xvid_build) <= 12 or _u(bugs.lavc_build) < 4670 or \
        _u(bugs.divx_version) < 500


def dc_clip_bug(bugs: Bugs) -> bool:
    """FF_BUG_DC_CLIP: a predicted DC above 2047 is then not clipped."""
    return _u(bugs.xvid_build) <= 32 or _u(bugs.lavc_build) <= 4712


def unsupported(vol: Optional[Vol], bugs: Bugs = Bugs(),
                vop: Optional[VopHeader] = None, tag: str = "FMP4",
                short_header: bool = False) -> Optional[str]:
    """What of a stream the decoder does not read, or None: its VOL and
    (``vop``) a VOP's type; ``bugs`` and ``tag`` are not asked about (every
    build FFmpeg's bug detection finds is read)."""
    if short_header:
        return "the short video header (H.263 baseline)"
    if vol is None:
        return "no VOL header in the extradata or the first chunk"
    if vol.shape != 0:
        return f"video_object_layer_shape {vol.shape} (only rectangular)"
    if vol.sprite:
        return ("sprites" if vol.sprite == 1 else "GMC sprites (S-VOPs)") \
            + f" (sprite_enable {vol.sprite})"
    if vol.not_8_bit:
        return "not_8_bit"
    if vol.interlaced:
        return "an interlaced VOL"
    if vol.quarter_sample:
        return "quarter-pel motion (quarter_sample)"
    if vol.complexity_estimation:
        return "complexity estimation headers"
    if vol.data_partitioned:
        return "data partitioning" + (" with reversible VLCs"
                                      if vol.rvlc else "")
    if vol.newpred:
        return "newpred"
    if vol.reduced_resolution:
        return "reduced-resolution VOPs"
    if vol.scalability:
        return "scalability"
    if vol.full_range:
        return "a full-range video signal (video_range 1)"
    if vol.matrix not in (1, 2, 5, 6):
        return f"matrix_coefficients {vol.matrix} (BT.601 and BT.709 only)"
    if vol.width < 1 or vol.height < 1:
        return f"a VOL of {vol.width} x {vol.height}"
    if vop is not None and vop.type == "S":
        return "S-VOPs (GMC)"
    return None


def matrix_name(vol: Vol, container: Optional[str] = None) -> str:
    """The rawvideo converter's matrix for the stream's frames: the VOL's,
    or where it names none (2) the container's (``container``, from its
    colour tags; FFmpeg's decoder keeps the demuxer's then)."""
    if vol.matrix == 2 and container:
        return container
    return "bt709" if vol.matrix == 1 else "bt601"


def idct_sums(blocks: np.ndarray) -> np.ndarray:
    """FFmpeg's simple_idct as ff_simple_idct8_{put,add}_sse2 compute it,
    before the final clip: (n, 64) int16 coefficients in natural order ->
    (n, 8, 8) ints (``jpeg_plain._idct_simple`` clips them to 0..255; the
    add routine clips prediction + this)."""
    v = blocks.astype(np.int64).reshape(-1, 8, 8)
    W4 = _W[4]
    rows = _sat16(_i32(_simple_1d(v, W4 * v[..., 0] + (1 << 10))) >> 11)
    dc_only = ~(v[..., 1:] != 0).any(-1)
    rows = np.where(dc_only[..., None], _i16(v[..., :1] * 8), rows)
    cols = np.swapaxes(rows, 1, 2)
    out = _i32(_simple_1d(cols, W4 * _i16(cols[..., 0] + 32))) >> 20
    return np.swapaxes(out, 1, 2)


# xvid_idct_sse2's row tables (rows 0 and 4, 1 and 7, 2 and 6, 3 and 5)
# and rounders, and the column pass's constants as 16-bit lanes
_XVID_TAB = ((22725, 21407, 19266, 16384, 12873, 8867, 4520),
             (31521, 29692, 26722, 22725, 17855, 12299, 6270),
             (29692, 27969, 25172, 21407, 16819, 11585, 5906),
             (26722, 25172, 22654, 19266, 15137, 10426, 5315))
_XVID_ROW_TAB = (0, 1, 2, 3, 0, 3, 2, 1)
_XVID_RND = (65536, 3597, 2260, 1203, 0, 120, 512, 512)
_TAN1, _TAN2, _TAN3, _SQRT2 = 13036, 27146, 43790 - 65536, 23170


def xvid_idct_sums(blocks: np.ndarray) -> np.ndarray:
    """FFmpeg's Xvid IDCT as ff_xvid_idct_{put,add}_sse2 compute it, before
    the final clip: (n, 64) int16 coefficients in natural order -> (n, 8,
    8) ints.  Rows: 32-bit sums with each row's rounder, shifted by 11 and
    saturated to 16 bits; rows 0-2 are always transformed (an empty one
    gives its rounder's share), rows 3-7 only where nonzero.  Columns:
    16-bit saturating adds and ``pmulhw`` products, shifted by 6 (probed
    against cv2's libavcodec on random blocks; the C version differs on
    empty rows 1-2 and where a sum leaves 16 bits)."""
    b = blocks.astype(np.int64).reshape(-1, 8, 8)
    x = np.zeros_like(b)
    for r in range(8):
        c1, c2, c3, c4, c5, c6, c7 = _XVID_TAB[_XVID_ROW_TAB[r]]
        v = b[:, r]
        k = c4 * v[:, 0] + _XVID_RND[r]
        a0 = k + c2 * v[:, 2] + c4 * v[:, 4] + c6 * v[:, 6]
        a1 = k + c6 * v[:, 2] - c4 * v[:, 4] - c2 * v[:, 6]
        a2 = k - c6 * v[:, 2] - c4 * v[:, 4] + c2 * v[:, 6]
        a3 = k - c2 * v[:, 2] + c4 * v[:, 4] - c6 * v[:, 6]
        b0 = c1 * v[:, 1] + c3 * v[:, 3] + c5 * v[:, 5] + c7 * v[:, 7]
        b1 = c3 * v[:, 1] - c7 * v[:, 3] - c1 * v[:, 5] - c5 * v[:, 7]
        b2 = c5 * v[:, 1] - c1 * v[:, 3] + c7 * v[:, 5] + c3 * v[:, 7]
        b3 = c7 * v[:, 1] - c5 * v[:, 3] + c3 * v[:, 5] - c1 * v[:, 7]
        o = _sat16(_i32(np.stack([a0 + b0, a1 + b1, a2 + b2, a3 + b3,
                                  a3 - b3, a2 - b2, a1 - b1, a0 - b0], 1))
                   >> 11)
        if r >= 3:
            o = np.where((v != 0).any(1)[:, None], o, 0)
        x[:, r] = o
    X = [x[:, k] for k in range(8)]
    S = _sat16
    tm35 = S(S(((X[3] * _TAN3) >> 16) + X[3]) - X[5])
    tp35 = S(S(((X[5] * _TAN3) >> 16) + X[5]) + X[3])
    tp17 = S(((X[7] * _TAN1) >> 16) + X[1])
    tm17 = S(((X[1] * _TAN1) >> 16) - X[7])
    t1, b3, b0, t2 = S(tp17 - tp35), S(tm17 - tm35), S(tp35 + tp17), \
        S(tm35 + tm17)
    b2 = (S(t1 - t2) * _SQRT2) >> 16
    b1 = (S(t2 + t1) * _SQRT2) >> 16
    b1, b2 = S(b1 + b1), S(b2 + b2)
    tp26 = S(((X[6] * _TAN2) >> 16) + X[2])
    tm26 = S(((X[2] * _TAN2) >> 16) - X[6])
    tm04, tp04 = S(X[0] - X[4]), S(X[4] + X[0])
    a3, a0, a2, a1 = S(tp04 - tp26), S(tp26 + tp04), S(tm04 - tm26), \
        S(tm26 + tm04)
    out = [S(b0 + a0), S(b1 + a1), S(b2 + a2), S(b3 + a3), S(a3 - b3),
           S(a2 - b2), S(a1 - b1), S(a0 - b0)]
    return np.stack([v >> 6 for v in out], 1)


def _abs16(v: np.ndarray) -> np.ndarray:
    """|v| of int16 lanes as ``pxor`` + ``psubw`` leave it (|-32768| is
    0x8000), as 0..65535."""
    return np.where(v < 0, -v, v) & 0xFFFF


def dequant_mpeg_intra(blocks: np.ndarray, q: int, matrix) -> np.ndarray:
    """dct_unquantize_mpeg2_intra as FFmpeg's x86 routine computes it (it
    runs where the decoder is not bit-exact, as cv2's is not): each AC
    level times ``2 q matrix`` (MPEG-2's routine takes the MPEG-4
    quantiser doubled), in 16-bit lanes, shifted right by 4 as a signed
    word, its sign put back; no mismatch control (probed against cv2's
    libavcodec).  The DC times its scaler, as for H.263 quantisation.
    (6, 64) levels of a macroblock's blocks, natural order."""
    b = _i16(blocks.astype(np.int64))
    qw = (2 * q * np.asarray(matrix, np.int64)) & 0xFFFF
    p = _i16(_abs16(b) * qw) >> 4
    p = _i16(np.where(b < 0, -p, p))
    out = np.where(b != 0, p, 0)
    scale = np.array([Y_DC_SCALE[q]] * 4 + [C_DC_SCALE[q]] * 2)
    out[:, 0] = _i16(b[:, 0] * scale[:len(b)])
    return out


def dequant_mpeg_inter(block: np.ndarray, q: int, matrix) -> np.ndarray:
    """dct_unquantize_mpeg2_inter as FFmpeg's x86 routine computes it:
    ``((2 |level| + 1) 2 q matrix) >> 5`` in 16-bit lanes (a logical
    shift), its sign put back, then mismatch control: coefficient 63's
    lowest bit flipped where the sum of the others and of it is even."""
    b = _i16(np.asarray(block, np.int64))
    qw = (2 * q * np.asarray(matrix, np.int64)) & 0xFFFF
    p = ((((2 * _abs16(b)) & 0xFFFF) * qw + qw) & 0xFFFF) >> 5
    p = _i16(np.where(b < 0, -p, p))
    out = np.where(b != 0, p, 0)
    out[..., 63] ^= (out.sum(-1) - 1) & 1
    return out


def _mid(a: int, b: int, c: int) -> int:
    return max(min(a, b), min(max(a, b), c))


class _Mb(NamedTuple):
    x: int
    y: int
    kind: str           # "skip", "inter", "inter4", "intra"
    mvs: tuple          # ((mx, my),) or four of them (B: the forward ones)
    cbp: int
    qscale: int
    blocks: Optional[np.ndarray]   # (6, 64) int16, natural order
    bmvs: tuple = ()    # a B-VOP's backward vectors
    four: bool = False  # a B-VOP's direct macroblock of four vectors


class FrameHeader(NamedTuple):
    """What a chunk is to FFmpeg: ``kind`` "I", "P" or "B" (a coded VOP,
    its header ``vop``, its macroblock data in ``data`` from bit ``bit``),
    "N" (an N-VOP: no frame), "skip" (a B-VOP FFmpeg skips: no reference
    before it, or times that do not fit between its references) or "drop"
    (a DivX or Xvid stream's one-byte chunk: no frame).  ``data`` is the
    chunk, or the VOP a packed bitstream's chunk before it held.
    ``edge`` whether the frame replicates the visible picture's border
    (FF_BUG_EDGE as of this frame), ``dc_clip`` FF_BUG_DC_CLIP, ``xvid``
    whether FFmpeg has switched to the Xvid IDCT; ``output`` what FFmpeg
    outputs once the frame is decoded: "self", "last" (the reference
    before this I- or P-VOP, a decoder with B-frames' one-frame delay) or
    None; ``pb``/``pp`` a B-VOP's distances in time to its forward
    reference and between its references (direct mode's scale);
    ``intra_matrix``/``inter_matrix`` quant_type 1's matrices (natural
    order) or None."""
    kind: str
    vop: Optional[VopHeader] = None
    bit: int = 0
    edge: bool = False
    dc_clip: bool = False
    xvid: bool = False
    data: bytes = b""
    output: Optional[str] = None
    pb: int = 0
    pp: int = 0
    intra_matrix: Optional[Tuple[int, ...]] = None
    inter_matrix: Optional[Tuple[int, ...]] = None


MAX_NVOP_SIZE = 19   # a chunk up to this size takes a pending packed VOP


class Stream:
    """The headers of one MPEG-4 Part 2 stream, chunk by chunk, as
    FFmpeg's context keeps them: the VOL, the VO's signal type and the
    user data's builds carry from chunk to chunk, and so do the VOP times
    (B-VOPs' direct mode scales by them), the low-delay flag (whether
    I- and P-VOPs are output at once or when the next one comes), the
    references decoded so far and a packed bitstream's pending VOP.
    ``tag`` is the codec tag FFmpeg's demuxer sets (an AVI's fourcc, an
    MP4 sample entry's, none for Matroska's ``V_MPEG4/*``: its bug
    detection reads it), ``extradata`` the stream's (the ``strf`` bytes
    after the BITMAPINFOHEADER, an ``esds`` DecoderSpecificInfo, a
    Matroska CodecPrivate)."""

    def __init__(self, tag: str = "FMP4", extradata: bytes = b"",
                 height: Optional[int] = None, width: Optional[int] = None):
        self.tag = tag
        self.vol: Optional[Vol] = None
        self.vo = (False, 2)
        self.bugs = Bugs()
        self.edge_bug = False      # FFmpeg's h_edge_pos as of this frame
        self.xvid = False          # the Xvid IDCT (once on, it stays)
        self.size = (height, width)
        self.chunks = 0            # chunks taken
        self.anchors = 0           # I- and P-VOPs decoded among them
        self.skipped_last = False  # the last chunk was an N-VOP
        self.low_delay = True      # ff_h263_decode_init's
        self.pictures = 0          # FFmpeg's picture_number
        self.time_base = self.last_time_base = 0
        self.last_non_b_time = self.pp_time = 0
        self.pending: Optional[bytes] = None   # a packed chunk's next VOP
        if extradata:
            self._take(stream_headers(extradata, None, self.bugs, self.vo))

    def _take(self, hd: Headers) -> None:
        if hd.vo is not None:
            self.vo = hd.vo
        if hd.vol is not None:
            v = hd.vol
            if v.shape == 0 and self.vol is not None and \
                    (v.width, v.height) != \
                    (self.vol.width, self.vol.height):
                raise Mpeg4Error(f"a VOL of {v.width} x {v.height} after "
                                 f"one of {self.vol.width} x "
                                 f"{self.vol.height}")
            if v.shape == 0 and self.size[0] is not None and \
                    (v.height, v.width) != self.size:
                raise Mpeg4Error(f"a VOL of {v.width} x {v.height} in a "
                                 f"stream of {self.size[1]} x "
                                 f"{self.size[0]}")
            self.vol = v
            if v.low_delay is not None:
                self.low_delay = v.low_delay
            elif not self.pictures:
                self.low_delay = v.vo_type in (1, 17)   # (Advanced) Simple
        if hd.gov is not None:
            self.time_base = hd.gov
        self.bugs = hd.bugs

    def _data(self, chunk: bytes) -> Tuple[bytes, bool]:
        """The bytes FFmpeg decodes for a chunk: a packed bitstream's
        pending VOP where one is (and the chunk is a placeholder, or the
        stream packed), else the chunk; and whether it was the pending
        one."""
        if self.pending is None:
            return chunk, False
        pending, self.pending = self.pending, None
        keep = len(pending)
        if self.bugs.divx_packed:
            # a chunk that starts a new sequence (VOS) discards it
            at = chunk.find(b"\0\0\1")
            if 0 <= at < len(chunk) - 3 and chunk[at + 3] == 0xB0:
                keep = 0
        if keep and (self.bugs.divx_packed or len(chunk) <= MAX_NVOP_SIZE):
            return pending, True
        return chunk, False

    def next(self, chunk: bytes) -> FrameHeader:
        """The next (non-empty) chunk's header; raises Mpeg4Error naming
        the frame (its chunk's index) for what the decoder refuses."""
        index = self.chunks
        self.chunks += 1
        self.skipped_last = False
        data, buffered = self._data(chunk)
        try:
            hd = stream_headers(data, self.vol, self.bugs, self.vo)
            self._take(hd)
        except Mpeg4Error as exc:
            raise Mpeg4Error(f"frame {index}: {exc}") from None
        why = unsupported(self.vol, self.bugs, hd.vop, self.tag,
                          hd.short_header)
        if why:
            raise Mpeg4Error(f"frame {index}: {why}")
        bugs = xvid_build(self.tag, self.vol, self.bugs)
        if hd.vop is None:
            if len(data) == 1 and (bugs.divx_version >= 0 or
                                   bugs.xvid_build >= 0):
                return FrameHeader("drop")
            raise Mpeg4Error(f"frame {index}: a chunk without a VOP (FFmpeg "
                             "fails it, and cv2's read ends there)")
        vop, v = hd.vop, self.vol
        if vop.type == "B" and self.low_delay and not v.vol_control:
            self.low_delay = False     # "low_delay flag set incorrectly"
        # the VOP's time: I-, P- (and N-) VOPs move the time base, a B-VOP
        # lies between its references or FFmpeg skips it
        pb = 0
        if vop.type != "B":
            self.last_time_base = self.time_base
            self.time_base += vop.seconds
            t = self.time_base * v.resolution + vop.increment
            self.pp_time = (t - self.last_non_b_time) & 0xFFFF
            self.last_non_b_time = t
        else:
            t = (self.last_time_base + vop.seconds) * v.resolution + \
                vop.increment
            pb = (self.pp_time - (self.last_non_b_time - t)) & 0xFFFF
            if not 0 < pb < self.pp_time:
                return FrameHeader("skip", vop)
        if not vop.coded:
            self.skipped_last = True
            return FrameHeader("N", vop)
        if vop.error:
            raise Mpeg4Error(f"frame {index}: {vop.error}")
        if v.vo_type == 0 and not v.vol_control and \
                self.bugs.divx_version == -1 and not self.pictures:
            self.low_delay = True      # DivX 4, old Xvid, OpenDivX
        self.pictures += 1
        mbs = ((v.width + 15) // 16) * ((v.height + 15) // 16)
        if vop.type != "B" and hd.bits.left() < mbs // 2:
            raise Mpeg4Error(f"frame {index}: a VOP of fewer bits than half "
                             "its macroblocks (FFmpeg drops it)")
        # ff_mpeg4_workaround_bugs: the IDCT and DC clip serve this frame,
        # the border (h_edge_pos, set in the header) the next ones
        edge = self.edge_bug
        self.edge_bug = edge or edge_bug(bugs)
        self.xvid = self.xvid or bugs.xvid_build >= 0
        if vop.type == "P" and not self.anchors:
            raise Mpeg4Error(f"frame {index}: a P-VOP before the first "
                             "I-VOP")
        if vop.type == "B" and self.anchors < 2:
            return FrameHeader("skip", vop)
        output = "self" if vop.type == "B" or self.low_delay else \
            "last" if self.anchors else None
        self.anchors += vop.type != "B"
        if self.bugs.divx_packed:
            # ff_mpeg4_frame_end: a chunk that holds an I- or B-VOP after
            # the one decoded keeps it for the next chunk, from where the
            # decoded VOP's data end (its macroblock data hold no start
            # code, so from the first start code after where they start:
            # what FFmpeg parses next is the same)
            at = 0 if buffered else hd.bits.pos >> 3
            if len(chunk) - at > 7:
                i = chunk.find(b"\0\0\1\xb6", at)
                if 0 <= i < len(chunk) - 4 and not chunk[i + 4] & 0x40:
                    self.pending = chunk[chunk.find(b"\0\0\1", at):]
        return FrameHeader(vop.type, vop, hd.bits.pos, edge,
                           dc_clip_bug(bugs), self.xvid, data, output, pb,
                           self.pp_time, v.intra_matrix, v.inter_matrix)

    def flush(self) -> bool:
        """At the stream's end: whether FFmpeg outputs its last I- or
        P-VOP once more (a decoder with B-frames' delay holds it back; a
        stream that ended with an N-VOP repeats it)."""
        out = (not self.low_delay or self.skipped_last) and self.anchors > 0
        self.skipped_last = False
        if out:
            self.anchors = 0   # FFmpeg lets the picture go: once only
        return out


class Decoder(Stream):
    """One MPEG-4 Part 2 stream's plain decoder: beside the headers
    (:class:`Stream`), FFmpeg's prediction state (DC and AC predictors
    with their borders, the macroblocks last coded intra), the two
    references (macroblock-aligned planes: the last I- or P-VOP and the
    one before it) and the last one's vectors and skipped macroblocks
    (B-VOPs' direct mode and skips read them) carry from frame to frame,
    so it takes the stream's chunks in order, from its first."""

    fwd = ref = None               # the references: older, latest

    def _setup(self) -> None:
        if getattr(self, "mb_w", None) is not None:
            return
        v = self.vol
        self.mb_w, self.mb_h = (v.width + 15) // 16, (v.height + 15) // 16
        mw, mh = self.mb_w, self.mb_h
        self.wrap, self.cwrap = 2 * mw + 1, mw + 1
        # flat, as FFmpeg's: luma at wrap + 1 + row * wrap + col (a row and
        # a column of border), chroma at cwrap + 1 + row * cwrap + col
        self.dc = [np.full((2 * mh + 1) * self.wrap + 1, 1024, np.int64),
                   np.full((mh + 1) * self.cwrap + 1, 1024, np.int64),
                   np.full((mh + 1) * self.cwrap + 1, 1024, np.int64)]
        self.ac = [np.zeros((len(d), 16), np.int64) for d in self.dc]
        self.mbintra = np.ones(mh * self.cwrap, bool)
        # the latest reference's vectors (a macroblock's four) and
        # skipped and 4MV macroblocks
        self.colo_mv = np.zeros((mh * mw, 4, 2), np.int64)
        self.colo_skip = np.zeros(mh * mw, bool)
        self.colo_four = np.zeros(mh * mw, bool)
        self.last_mv = np.zeros((2, 2), np.int64)

    def decode(self, chunk: bytes) -> Optional[List[np.ndarray]]:
        """The frame FFmpeg outputs for the next chunk, as
        macroblock-aligned (Y, U, V) planes, or None where it outputs none
        (an N-VOP, a skipped B-VOP, a drop chunk, the first I-VOP of a
        stream with B-frames' delay)."""
        at = f"frame {self.chunks}: "
        fh = self.next(chunk)
        if fh.kind not in "IPB":
            return None
        self._setup()
        self.dc_clip = fh.dc_clip
        self.frame = fh
        r = _Bits(fh.data)
        r.pos = fh.bit
        mbs = self._parse(r, fh.vop, at)
        if fh.kind == "B":
            return self._reconstruct(mbs, fh, self.fwd, self.ref)
        planes = self._reconstruct(mbs, fh, self.ref, None)
        out = planes if fh.output == "self" else \
            self.ref if fh.output == "last" else None
        self.fwd, self.ref = self.ref, planes
        return out

    def flush(self) -> Optional[List[np.ndarray]]:
        """At the stream's end: the last I- or P-VOP where FFmpeg outputs
        it then (:meth:`Stream.flush`), else None."""
        return self.ref if Stream.flush(self) else None

    # -- macroblock layer ------------------------------------------------------
    def _parse(self, r: _Bits, vop: VopHeader, at: str) -> List[_Mb]:
        mw, mh = self.mb_w, self.mb_h
        self.qscale = vop.quant
        self.mv = np.zeros((2 * mh, 2 * mw + 2, 2), np.int64)
        self.qtab = np.zeros(mh * self.cwrap, np.int64)
        self.last_mv[:] = 0
        mbs: List[_Mb] = []
        mb_num = mw * mh
        b = vop.type == "B"
        x = y = 0
        while True:
            # decode_slice: a video packet from (x, y)
            self.resync = (x, y)
            self.first_line = True
            while y < mh:
                while x < mw:
                    if (x, y) == (self.resync[0], self.resync[1] + 1):
                        self.first_line = False
                    try:
                        mb = self._mb_b(r, vop, x, y) if b else \
                            self._mb(r, vop, x, y)
                    except _Bad as exc:
                        raise Mpeg4Error(
                            f"{at}macroblock ({x}, {y}): {exc}") from None
                    if r.pos > r.end:
                        raise Mpeg4Error(f"{at}macroblock ({x}, {y}): the "
                                         "data end inside it")
                    mbs.append(mb)
                    n = y * mw + x
                    nxt = self._resync_next(r, vop) if \
                        self.vol.resync_marker and n + 1 < mb_num else 0
                    if b and nxt > n + 1 and self.colo_skip[n + 1]:
                        nxt = 0        # a B-VOP reads on through a skip
                    x += 1
                    if nxt:
                        if nxt != n + 1:
                            raise Mpeg4Error(
                                f"{at}macroblock ({x - 1}, {y}): a video "
                                f"packet that starts at macroblock {nxt}, "
                                f"not {n + 1}")
                        break
                else:
                    x = 0
                    y += 1
                    continue
                break
            if len(mbs) == mb_num:
                if vop.type != "B":
                    self._keep_vectors(mbs)
                return mbs
            # ff_h263_resync + the video packet header
            r.get(1)
            r.align()
            x, y = self._packet_header(r, vop, at)
            if y * mw + x != len(mbs):
                raise Mpeg4Error(f"{at}a video packet header at "
                                 f"macroblock {y * mw + x}, not "
                                 f"{len(mbs)}")
            self._clean_buffers(x, y)

    def _keep_vectors(self, mbs: List[_Mb]) -> None:
        """An I- or P-VOP's vectors as FFmpeg's ``motion_val`` holds them
        at its end (zero for intra macroblocks, and for a block 3 whose
        right neighbour zeroed it: ``ff_h263_pred_motion`` at a packet's
        first row), skipped and 4MV macroblocks, which the B-VOPs after it
        read."""
        mv = self.mv[:, 1:-1].reshape(self.mb_h, 2, self.mb_w, 2, 2)
        self.colo_mv[:] = mv.transpose(0, 2, 1, 3, 4).reshape(-1, 4, 2)
        for k, m in enumerate(mbs):
            self.colo_skip[k] = m.kind == "skip"
            self.colo_four[k] = m.kind == "inter4"

    @staticmethod
    def _prefix(vop: VopHeader) -> int:
        """ff_mpeg4_get_video_packet_prefix_length: a resync marker's
        zeros."""
        return 16 if vop.type == "I" else vop.fcode + 15 \
            if vop.type != "B" else max(vop.fcode, vop.bcode, 2) + 15

    def _resync_next(self, r: _Bits, vop: VopHeader) -> int:
        """mpeg4_is_resync at a macroblock's end: the number of the
        macroblock a video packet starts with, or 0 (the reader skips
        macroblock stuffing, as FFmpeg's does; B-VOPs have none)."""
        ptype = 1 if vop.type == "I" else 2
        v = r.peek(16)
        while vop.type != "B" and v <= 0xFF and v >> (8 - ptype) == 1:
            r.pos += 8 + ptype
            v = r.peek(16)
        count = r.pos
        if count + 8 >= r.end:
            return 0
        prefix = (0x7F00, 0x7E00, 0x7C00, 0x7800, 0x7000, 0x6000, 0x4000,
                  0x0000)[count & 7]
        if v != prefix:
            return 0
        save = r.pos
        r.get(1)
        r.align()
        n = 0
        while n < 32 and not r.get(1):
            n += 1
        bits = (self.mb_w * self.mb_h - 1).bit_length()
        mb = r.get(bits)
        r.pos = save
        return mb if n >= self._prefix(vop) and \
            0 < mb < self.mb_w * self.mb_h else 0

    def _packet_header(self, r: _Bits, vop: VopHeader, at: str):
        """ff_mpeg4_decode_video_packet_header: the packet's first
        macroblock; takes its quantiser (HEC fields are skipped, as FFmpeg
        skips them)."""
        n = 0
        while n < 32 and not r.get(1):
            n += 1
        need = self._prefix(vop)
        if n != need:
            raise Mpeg4Error(f"{at}a resync marker of {n} zeros, not "
                             f"{need}")
        mb_num = self.mb_w * self.mb_h
        mb = r.get((mb_num - 1).bit_length())
        if not 0 < mb < mb_num:
            raise Mpeg4Error(f"{at}a video packet at macroblock {mb}")
        q = r.get(5)
        if q:
            self.qscale = q
        if r.get(1):                           # header_extension_code
            while r.get(1):
                pass
            _marker(r)
            r.get(self.vol.time_increment_bits)
            _marker(r)
            r.get(2)
            r.get(3)
            if vop.type != "I":
                r.get(3)
            if vop.type == "B":
                r.get(3)
        return mb % self.mb_w, mb // self.mb_w

    def _clean_buffers(self, x: int, y: int) -> None:
        """ff_mpeg4_clean_buffers at a packet's first macroblock: the AC
        predictors above and to the left (a linear run, as FFmpeg's
        memset) are zeroed, and so are a B-VOP's vector predictors."""
        w, cw = self.wrap, self.cwrap
        l_xy = w + 1 + (2 * y - 1) * w + 2 * x - 1
        self.ac[0][l_xy:l_xy + 2 * w + 1] = 0
        c_xy = cw + 1 + (y - 1) * cw + x - 1
        for c in (1, 2):
            self.ac[c][c_xy:c_xy + cw + 1] = 0
        self.last_mv[:] = 0

    def _set_q(self, q: int) -> None:
        self.qscale = min(max(q, 1), 31)

    def _mb(self, r: _Bits, vop: VopHeader, x: int, y: int) -> _Mb:
        """mpeg4_decode_mb for an I- or P-VOP, with the bookkeeping of
        ff_h263_update_motion_val and ff_mpv_reconstruct_mb."""
        if vop.type == "P":
            while True:
                if r.get(1):                   # not_coded
                    self._store_mv(x, y, [(0, 0)] * 4)
                    self._after(x, y, False)
                    return _Mb(x, y, "skip", ((0, 0),), 0, self.qscale,
                               None)
                cbpc = r.vlc(_LUT_INTER_MCBPC)
                if cbpc != 20:
                    break
            dquant = cbpc & 8
            intra = bool(cbpc & 4)
        else:
            while True:
                cbpc = r.vlc(_LUT_INTRA_MCBPC)
                if cbpc != 8:
                    break
            dquant = cbpc & 4
            intra = True
        if intra:
            ac_pred = r.get(1)
            cbpy = r.vlc(_LUT_CBPY)
            cbp = (cbpc & 3) | (cbpy << 2)
            dc_vlc = self.qscale < vop.dc_threshold
            if dquant:
                self._set_q(self.qscale + DQUANT[r.get(2)])
            blocks = np.zeros((6, 64), np.int64)
            for n in range(6):
                self._intra_block(r, blocks[n], x, y, n, cbp & 32, dc_vlc,
                                  ac_pred)
                cbp += cbp
            self._store_mv(x, y, [(0, 0)] * 4)
            self._after(x, y, True)
            return _Mb(x, y, "intra", ((0, 0),), 63, self.qscale, blocks)
        cbpy = r.vlc(_LUT_CBPY) ^ 15
        cbp = (cbpc & 3) | (cbpy << 2)
        if dquant:
            self._set_q(self.qscale + DQUANT[r.get(2)])
        if cbpc & 16:
            mvs = []
            for i in range(4):
                px, py = self._pred_mv(x, y, i)
                mx = self._motion(r, px, vop.fcode)
                my = self._motion(r, py, vop.fcode)
                self.mv[2 * y + (i >> 1), 1 + 2 * x + (i & 1)] = (mx, my)
                mvs.append((mx, my))
            kind = "inter4"
        else:
            px, py = self._pred_mv(x, y, 0)
            mx = self._motion(r, px, vop.fcode)
            my = self._motion(r, py, vop.fcode)
            self._store_mv(x, y, [(mx, my)] * 4)
            mvs = [(mx, my)]
            kind = "inter"
        blocks = np.zeros((6, 64), np.int64)
        coded = cbp
        for n in range(6):
            if cbp & 32:
                self._inter_block(r, blocks[n])
            cbp += cbp
        self._after(x, y, False)
        return _Mb(x, y, kind, tuple(mvs), coded & 63, self.qscale, blocks)

    def _mb_b(self, r: _Bits, vop: VopHeader, x: int, y: int) -> _Mb:
        """mpeg4_decode_mb for a B-VOP: a macroblock the latest reference
        skipped is skipped (the forward reference, no vector); else
        ``modb`` (1: direct, no delta, no blocks), ``mb_type`` (direct,
        interpolated, backward, forward), ``cbpb``, ``dbquant`` (not for
        direct) and the vectors: forward and backward ones predicted from
        the last of their direction (zeroed at each row's start and each
        packet's), direct mode's delta at fcode 1."""
        if x == 0:
            self.last_mv[:] = 0
        k = y * self.mb_w + x
        if self.colo_skip[k]:
            self._after(x, y, False)
            return _Mb(x, y, "skip", ((0, 0),), 0, self.qscale, None)
        cbp, delta = 0, False
        if r.get(1):                           # modb: direct, no more
            kind = "direct"
        else:
            modb2 = r.get(1)
            code = r.peek(4)
            if not code:
                raise _Bad("illegal MB_type")
            n = 4 - code.bit_length()          # 1, 01, 001, 0001
            r.get(n + 1)
            kind = ("direct", "bi", "bwd", "fwd")[n]
            delta = kind == "direct"
            if not modb2:
                cbp = r.get(6)
            if kind != "direct" and cbp and r.get(1):
                self._set_q(self.qscale + 4 * r.get(1) - 2)
        fwd = bwd = ()
        if kind in ("fwd", "bi"):
            mx = self._motion(r, int(self.last_mv[0, 0]), vop.fcode)
            my = self._motion(r, int(self.last_mv[0, 1]), vop.fcode)
            self.last_mv[0] = (mx, my)
            fwd = ((mx, my),)
        if kind in ("bwd", "bi"):
            mx = self._motion(r, int(self.last_mv[1, 0]), vop.bcode)
            my = self._motion(r, int(self.last_mv[1, 1]), vop.bcode)
            self.last_mv[1] = (mx, my)
            bwd = ((mx, my),)
        four = False
        if kind == "direct":
            mx = self._motion(r, 0, 1) if delta else 0
            my = self._motion(r, 0, 1) if delta else 0
            four = bool(self.colo_four[k])
            fwd, bwd = self._direct(k, mx, my, four)
        blocks = np.zeros((6, 64), np.int64)
        for n in range(6):
            if cbp & (32 >> n):
                self._inter_block(r, blocks[n])
        self._after(x, y, False)
        return _Mb(x, y, kind, fwd, cbp, self.qscale, blocks, bwd, four)

    def _direct(self, k: int, mx: int, my: int, four: bool):
        """ff_mpeg4_set_direct_mv: the latest reference's vector (each of
        a 4MV macroblock's four) scaled by pb / pp, plus the delta, and the
        backward vector (the forward one less the reference's, or the
        reference's scaled by (pb - pp) / pp where the delta is 0); C's
        division, which truncates."""
        pb, pp = self.frame.pb, self.frame.pp
        fwd, bwd = [], []
        for i in range(4 if four else 1):
            f, b = [], []
            for p, d in zip(self.colo_mv[k, i], (mx, my)):
                p = int(p)
                f.append(_tdiv(p * pb, pp) + d)
                b.append(f[-1] - p if d else _tdiv(p * (pb - pp), pp))
            fwd.append(tuple(f))
            bwd.append(tuple(b))
        return tuple(fwd), tuple(bwd)

    def _after(self, x: int, y: int, intra: bool) -> None:
        """ff_mpv_reconstruct_mb's bookkeeping: the macroblock's quantiser,
        and a non-intra one's DC and AC predictors reset where it was last
        coded intra (ff_clean_intra_table_entries)."""
        xy = y * self.cwrap + x
        self.qtab[xy] = self.qscale
        if intra:
            self.mbintra[xy] = True
            return
        if not self.mbintra[xy]:
            return
        w = self.wrap
        b = w + 1 + 2 * y * w + 2 * x
        for i in (b, b + 1, b + w, b + w + 1):
            self.dc[0][i] = 1024
            self.ac[0][i] = 0
        c = self.cwrap + 1 + xy
        for k in (1, 2):
            self.dc[k][c] = 1024
            self.ac[k][c] = 0
        self.mbintra[xy] = False

    # -- motion vectors ----------------------------------------------------------
    def _store_mv(self, x: int, y: int, mvs) -> None:
        for i, mv in enumerate(mvs):
            self.mv[2 * y + (i >> 1), 1 + 2 * x + (i & 1)] = mv

    def _mvat(self, row: int, col: int):
        """motion_val at luma block (row, col); col -1 and 2 * mb_w are the
        picture's border column (zero)."""
        return self.mv[row, col + 1]

    def _pred_mv(self, x: int, y: int, block: int) -> Tuple[int, int]:
        """ff_h263_pred_motion (h263.c), with its rules for the first row
        of a video packet."""
        row, col = 2 * y + (block >> 1), 2 * x + (block & 1)
        off = (2, 1, 1, -1)[block]
        A = self._mvat(row, col - 1)
        rx, ry = self.resync
        if self.first_line and block < 3:
            if block == 0:
                if x == rx:
                    return 0, 0
                if x + 1 == rx:
                    C = self._mvat(row - 1, col + off)
                    if x == 0:
                        return int(C[0]), int(C[1])
                    return (_mid(int(A[0]), 0, int(C[0])),
                            _mid(int(A[1]), 0, int(C[1])))
                return int(A[0]), int(A[1])
            if block == 1:
                if x + 1 == rx:
                    C = self._mvat(row - 1, col + off)
                    return (_mid(int(A[0]), 0, int(C[0])),
                            _mid(int(A[1]), 0, int(C[1])))
                return int(A[0]), int(A[1])
            B = self._mvat(row - 1, col)
            C = self._mvat(row - 1, col + off)
            if x == rx:
                A[:] = 0         # FFmpeg zeroes the left block's vector
            return (_mid(int(A[0]), int(B[0]), int(C[0])),
                    _mid(int(A[1]), int(B[1]), int(C[1])))
        B = self._mvat(row - 1, col)
        C = self._mvat(row - 1, col + off)
        return (_mid(int(A[0]), int(B[0]), int(C[0])),
                _mid(int(A[1]), int(B[1]), int(C[1])))

    @staticmethod
    def _motion(r: _Bits, pred: int, fcode: int) -> int:
        """ff_h263_decode_motion: a vector component, wrapped to the
        fcode's range."""
        code = r.vlc(_LUT_MV)
        if code == 0:
            return pred
        sign = r.get(1)
        shift = fcode - 1
        val = code
        if shift:
            val = ((val - 1) << shift) | r.get(shift)
            val += 1
        if sign:
            val = -val
        val += pred
        bits = 5 + fcode
        val &= (1 << bits) - 1
        return val - (1 << bits) if val >> (bits - 1) else val

    # -- blocks --------------------------------------------------------------------
    def _pred_dc(self, x: int, y: int, n: int, level: int
                 ) -> Tuple[int, int]:
        """ff_mpeg4_pred_dc: (level + prediction, direction: 0 left, 1
        top); stores the scaled DC as FFmpeg does."""
        if n < 4:
            scale = Y_DC_SCALE[self.qscale]
            wrap = self.wrap
            idx = wrap + 1 + (2 * y + (n >> 1)) * wrap + 2 * x + (n & 1)
            dc = self.dc[0]
        else:
            scale = C_DC_SCALE[self.qscale]
            wrap = self.cwrap
            idx = wrap + 1 + y * wrap + x
            dc = self.dc[n - 3]
        a, b, c = int(dc[idx - 1]), int(dc[idx - 1 - wrap]), \
            int(dc[idx - wrap])
        rx, ry = self.resync
        if self.first_line and n != 3:
            if n != 2:
                b = c = 1024
            if n != 1 and x == rx:
                b = a = 1024
        if x == rx and y == ry + 1 and n in (0, 4, 5):
            b = 1024
        if abs(a - b) < abs(b - c):
            pred, direction = c, 1
        else:
            pred, direction = a, 0
        pred = (pred + (scale >> 1)) // scale
        level += pred
        stored = level * scale
        if stored & ~2047:
            if stored < 0:
                stored = 0
            elif not self.dc_clip:
                stored = 2047
        dc[idx] = stored
        return level, direction

    def _pred_ac(self, block: np.ndarray, x: int, y: int, n: int,
                 direction: int, ac_pred: int) -> None:
        """ff_mpeg4_pred_ac: adds the left column or top row of the
        neighbour (rescaled where its quantiser differs) and stores the
        block's own for its neighbours."""
        if n < 4:
            wrap = self.wrap
            idx = wrap + 1 + (2 * y + (n >> 1)) * wrap + 2 * x + (n & 1)
            ac = self.ac[0]
        else:
            wrap = self.cwrap
            idx = wrap + 1 + y * wrap + x
            ac = self.ac[n - 3]
        q = self.qscale
        if ac_pred:
            if direction == 0:
                src = ac[idx - 1]
                qn = int(self.qtab[y * self.cwrap + x - 1]) if x else q
                same = x == 0 or q == qn or n in (1, 3)
                for i in range(1, 8):
                    v = int(src[i]) if same else _rdiv(int(src[i]) * qn, q)
                    block[i * 8] = _i16s(block[i * 8] + v)
            else:
                src = ac[idx - wrap]
                qn = int(self.qtab[(y - 1) * self.cwrap + x]) if y else q
                same = y == 0 or q == qn or n in (2, 3)
                for i in range(1, 8):
                    v = int(src[8 + i]) if same else \
                        _rdiv(int(src[8 + i]) * qn, q)
                    block[i] = _i16s(block[i] + v)
        ac[idx, 1:8] = block[8:64:8]
        ac[idx, 9:16] = block[1:8]

    def _intra_block(self, r: _Bits, block: np.ndarray, x: int, y: int,
                     n: int, coded: int, dc_vlc: bool, ac_pred: int) -> None:
        """mpeg4_decode_block for an intra block: the levels, predicted,
        in the quantised domain (``_reconstruct`` dequantises them)."""
        if dc_vlc:
            size = r.vlc(_LUT_DC[n >= 4])
            if size == 0:
                level = 0
            else:
                level = r.get(size)
                if not level >> (size - 1):
                    level -= (1 << size) - 1
                if size > 8:
                    r.get(1)                   # marker, only logged
            level, direction = self._pred_dc(x, y, n, level)
            block[0] = _i16s(level)
            i = 0
        else:
            i = -1
            _, direction = self._pred_dc(x, y, n, 0)
        if coded:
            scan = (ALT_V if direction == 0 else ALT_H) if ac_pred \
                else ZIGZAG
            i = self._tcoef(r, block, scan, RL_INTRA, 1, 0, i)
        if not dc_vlc:
            level, direction = self._pred_dc(x, y, n, int(block[0]))
            block[0] = _i16s(level)
        self._pred_ac(block, x, y, n, direction, ac_pred)

    def _inter_block(self, r: _Bits, block: np.ndarray) -> None:
        """An inter block's levels: dequantised as they are read (H.263
        quantisation), or raw (quant_type 1: ``_reconstruct`` dequantises
        them)."""
        q = self.qscale
        if self.frame.inter_matrix is not None:
            self._tcoef(r, block, ZIGZAG, RL_INTER, 1, 0, -1)
        else:
            self._tcoef(r, block, ZIGZAG, RL_INTER, 2 * q, (q - 1) | 1, -1)

    @staticmethod
    def _tcoef(r: _Bits, block: np.ndarray, scan, rl: RunLevel, qmul: int,
               qadd: int, i: int) -> int:
        """The TCOEF loop of mpeg4_decode_block; levels dequantised with
        (qmul, qadd) as FFmpeg's rl_vlc tables hold them."""
        lut = _LUT_TCOEF[rl is RL_INTRA]
        while True:
            sym = r.vlc(lut)
            if sym == ESCAPE:
                mode = r.peek(2)
                if mode == 3:                  # 11: the third escape
                    r.get(2)
                    last = r.get(1)
                    run = r.get(6)
                    if not r.get(1):
                        raise _Bad("1. marker bit missing in 3. esc")
                    level = r.sget(12)
                    if not r.get(1):
                        raise _Bad("2. marker bit missing in 3. esc")
                    level = level * qmul + qadd if level > 0 else \
                        level * qmul - qadd
                    if not -2048 <= level <= 2047:
                        level = -2048 if level < 0 else 2047
                    i += run + 1
                else:
                    r.get(1 if mode < 2 else 2)
                    sym = r.vlc(lut)
                    if sym == ESCAPE:
                        raise _Bad("an escape inside an escape")
                    lv, run, last = rl.level[sym], rl.run[sym], rl.last[sym]
                    if mode < 2:               # 0: the first escape
                        lv += rl.max_level[last][run]
                        i += run + 1
                    else:                      # 10: the second escape
                        i += run + rl.max_run[last][lv] + 2
                    level = lv * qmul + qadd
                    if r.get(1):
                        level = -level
            else:
                level = rl.level[sym] * qmul + qadd
                last = rl.last[sym]
                i += rl.run[sym] + 1
                if r.get(1):
                    level = -level
            if i > 63 or (i == 63 and not last):
                raise _Bad("ac-tex damaged")
            block[scan[i]] = _i16s(level)
            if last:
                return i

    # -- reconstruction --------------------------------------------------------
    def _reconstruct(self, mbs: List[_Mb], fh: FrameHeader, fwd, bwd
                     ) -> List[np.ndarray]:
        """The frame's planes: intra macroblocks dequantised and put; the
        others predicted from ``fwd`` (and, for a B-VOP, ``bwd``: put, then
        averaged with the backward prediction) plus their coded blocks'
        residual, dequantised (quant_type 1) and added."""
        mw, mh = self.mb_w, self.mb_h
        planes = [np.zeros((16 * mh, 16 * mw), np.uint8),
                  np.zeros((8 * mh, 8 * mw), np.uint8),
                  np.zeros((8 * mh, 8 * mw), np.uint8)]
        v, vop = self.vol, fh.vop
        he, ve = (v.width, v.height) if fh.edge else (16 * mw, 16 * mh)
        idct = xvid_idct_sums if fh.xvid else idct_sums
        intra = [m for m in mbs if m.kind == "intra"]
        if intra:
            deq = [dequant_mpeg_intra(m.blocks, m.qscale, fh.intra_matrix)
                   if fh.intra_matrix is not None else
                   _dequant_intra(m.blocks, m.qscale) for m in intra]
            sums = idct(np.stack(deq).reshape(-1, 64))
            px = np.clip(sums, 0, 255).astype(np.uint8).reshape(-1, 6, 8, 8)
            for m, blk in zip(intra, px):
                _put(planes, m.x, m.y, blk)
        inter = [m for m in mbs if m.kind != "intra"]
        coded = [m for m in inter if m.cbp]
        if coded and fh.inter_matrix is not None:
            res = np.stack([dequant_mpeg_inter(m.blocks, m.qscale,
                                               fh.inter_matrix)
                            for m in coded])
        else:
            res = np.stack([_i16(m.blocks) for m in coded]) if coded else []
        res = idct(res.reshape(-1, 64)).reshape(-1, 6, 8, 8) if coded \
            else []
        res = dict(zip((id(m) for m in coded), res))
        for m in inter:
            if vop.type == "B":
                pred = self._predict_b(m, fwd, bwd, he, ve)
            else:
                pred = self._predict(fwd, m.x, m.y, m.kind, m.mvs,
                                     vop.rounding, he, ve)
            if m.cbp:
                sums = res[id(m)]
                for n in range(6):
                    if m.cbp & (32 >> n):
                        pred[n] = np.clip(pred[n].astype(np.int64) + sums[n],
                                          0, 255)
            _put(planes, m.x, m.y, pred)
        return planes

    def _predict_b(self, m: _Mb, fwd, bwd, he: int, ve: int) -> np.ndarray:
        """A B-VOP macroblock's prediction: with rounding (B-VOPs have no
        rounding type), the forward one put, the backward one put or
        averaged with it, rounding up (``avg_pixels``)."""
        kind = "inter4" if m.four else "inter"
        if m.kind == "skip":
            return self._predict(fwd, m.x, m.y, "skip", ((0, 0),), 0, he, ve)
        out = None
        if m.mvs:
            out = self._predict(fwd, m.x, m.y, kind, m.mvs, 0, he, ve)
        if m.bmvs:
            back = self._predict(bwd, m.x, m.y, kind, m.bmvs, 0, he, ve)
            out = back if out is None else \
                ((out.astype(np.int64) + back + 1) >> 1).astype(np.uint8)
        return out

    def _predict(self, ref, x: int, y: int, kind: str, mvs, rnd: int,
                 he: int, ve: int) -> np.ndarray:
        """The six 8 x 8 predictions from ``ref`` of macroblock (x, y),
        inter or skipped (ff_mpv_motion: mpeg_motion for 1MV, hpel_motion
        and chroma_4mv_motion for 4MV)."""
        out = np.zeros((6, 8, 8), np.uint8)
        v = self.vol
        if kind == "inter4":
            sx = sy = 0
            for i, (mx, my) in enumerate(mvs):
                src_x = x * 16 + (i & 1) * 8 + (mx >> 1)
                src_y = y * 16 + (i >> 1) * 8 + (my >> 1)
                dxy = 0
                src_x = min(max(src_x, -16), v.width)
                if src_x != v.width:
                    dxy |= mx & 1
                src_y = min(max(src_y, -16), v.height)
                if src_y != v.height:
                    dxy |= (my & 1) << 1
                emu = _u(src_x) >= max(he - (mx & 1) - 7, 0) or \
                    _u(src_y) >= max(ve - (my & 1) - 7, 0)
                out[i] = _hpel(ref[0], src_x, src_y, 8, 8, dxy, rnd, emu,
                               he, ve)
                sx += mx
                sy += my
            mx = CHROMA_ROUND[sx & 15] + ((sx >> 3) & ~1)
            my = CHROMA_ROUND[sy & 15] + ((sy >> 3) & ~1)
            dxy = ((my & 1) << 1) | (mx & 1)
            src_x = min(max(x * 8 + (mx >> 1), -8), v.width >> 1)
            if src_x == v.width >> 1:
                dxy &= ~1
            src_y = min(max(y * 8 + (my >> 1), -8), v.height >> 1)
            if src_y == v.height >> 1:
                dxy &= ~2
            emu = _u(src_x) >= max((he >> 1) - (dxy & 1) - 7, 0) or \
                _u(src_y) >= max((ve >> 1) - (dxy >> 1) - 7, 0)
            for c in (1, 2):
                out[3 + c] = _hpel(ref[c], src_x, src_y, 8, 8, dxy, rnd, emu,
                                   he >> 1, ve >> 1)
            return out
        mx, my = mvs[0]
        dxy = ((my & 1) << 1) | (mx & 1)
        src_x = x * 16 + (mx >> 1)
        src_y = y * 16 + (my >> 1)
        uvdxy = dxy | (my & 2) | ((mx & 2) >> 1)
        emu = _u(src_x) >= max(he - (mx & 1) - 15, 0) or \
            _u(src_y) >= max(ve - (my & 1) - 15, 0)
        lum = _hpel(ref[0], src_x, src_y, 16, 16, dxy, rnd, emu, he, ve)
        out[:4] = lum.reshape(2, 8, 2, 8).transpose(0, 2, 1, 3).reshape(
            4, 8, 8)
        for c in (1, 2):
            out[3 + c] = _hpel(ref[c], src_x >> 1, src_y >> 1, 8, 8, uvdxy,
                               rnd, emu, he >> 1, ve >> 1)
        return out


def _tdiv(a: int, b: int) -> int:
    """C's integer division (truncating toward zero)."""
    q = abs(a) // abs(b)
    return q if (a < 0) == (b < 0) else -q


def _i16s(v: int) -> int:
    return ((int(v) + 32768) & 0xFFFF) - 32768


def _rdiv(a: int, b: int) -> int:
    """ROUNDED_DIV: half away from zero, C's truncating division."""
    n = a + (b >> 1) if a >= 0 else a - (b >> 1)
    return n // b if n >= 0 else -((-n) // b)


def _dequant_intra(blocks: np.ndarray, q: int) -> np.ndarray:
    """dct_unquantize_h263_intra in 16-bit lanes: the DC times its scaler,
    each nonzero AC level times 2q, plus or minus (q - 1) | 1."""
    out = _i16(blocks.astype(np.int64))
    qmul, qadd = 2 * q, (q - 1) | 1
    ac = out[:, 1:]
    deq = np.where(ac > 0, ac * qmul + qadd, ac * qmul - qadd)
    out[:, 1:] = np.where(ac != 0, _i16(deq), 0)
    scale = np.array([Y_DC_SCALE[q]] * 4 + [C_DC_SCALE[q]] * 2)
    out[:, 0] = _i16(out[:, 0] * scale)
    return out


def _put(planes, x: int, y: int, blocks: np.ndarray) -> None:
    """The six 8 x 8 blocks of macroblock (x, y) into the planes."""
    lum = planes[0][16 * y:16 * y + 16, 16 * x:16 * x + 16]
    for n in range(4):
        lum[8 * (n >> 1):8 * (n >> 1) + 8, 8 * (n & 1):8 * (n & 1) + 8] = \
            blocks[n]
    planes[1][8 * y:8 * y + 8, 8 * x:8 * x + 8] = blocks[4]
    planes[2][8 * y:8 * y + 8, 8 * x:8 * x + 8] = blocks[5]


def _hpel(plane: np.ndarray, sx: int, sy: int, bw: int, bh: int, dxy: int,
          rnd: int, emu: bool, ew: int, eh: int) -> np.ndarray:
    """A (bh, bw) half-pel prediction at (sx, sy) of ``plane``: read
    through FFmpeg's edge emulation (the border of ``ew`` x ``eh``
    replicated) where ``emu``, else straight; averaged as FFmpeg's x86
    put_pixels (``rnd`` 0) or put_no_rnd_pixels (``rnd`` 1) do: the
    16-wide ones exact, the 8-wide horizontal and vertical ones (4MV luma,
    all chroma) averaging ``max(a - 1, 0)`` with ``b``, ``a`` the left
    pixel or the one in an odd row of the block."""
    xs = sx + np.arange(bw + (dxy & 1))
    ys = sy + np.arange(bh + (dxy >> 1))
    if emu:
        xs = np.clip(xs, 0, ew - 1)
        ys = np.clip(ys, 0, eh - 1)
    p = plane[ys[:, None], xs[None, :]].astype(np.int64)
    if dxy == 0:
        return p.astype(np.uint8)
    if dxy == 3:
        s = p[:-1, :-1] + p[:-1, 1:] + p[1:, :-1] + p[1:, 1:]
        return ((s + 2 - rnd) >> 2).astype(np.uint8)
    if rnd and bw == 8 and dxy == 2:
        odd = np.arange(bh + 1)[:, None] % 2 == 1
        p = np.where(odd, np.maximum(p - 1, 0), p)
    a, b = (p[:, :-1], p[:, 1:]) if dxy == 1 else (p[:-1], p[1:])
    if rnd and bw == 8:
        if dxy == 1:
            a = np.maximum(a - 1, 0)
        rnd = 0
    return ((a + b + 1 - rnd) >> 1).astype(np.uint8)


def i420_bytes(planes, height: int, width: int) -> bytes:
    """The visible picture of the macroblock-aligned planes, packed as the
    rawvideo reader's ``i420`` frame."""
    h2, w2 = (height + 1) // 2, (width + 1) // 2
    return b"".join([np.ascontiguousarray(planes[0][:height, :width])
                     .tobytes(),
                     np.ascontiguousarray(planes[1][:h2, :w2]).tobytes(),
                     np.ascontiguousarray(planes[2][:h2, :w2]).tobytes()])


def decode_planes(chunks, tag: str = "FMP4", extradata: bytes = b"",
                  height: Optional[int] = None, width: Optional[int] = None
                  ) -> Tuple[List[bytes], Optional[Vol]]:
    """The i420 frames (bytes of the visible picture) FFmpeg outputs for
    a stream's chunks (empty chunks, which the AVI demuxer drops, are
    skipped), and the stream's VOL."""
    dec = Decoder(tag, extradata, height, width)
    out = []
    for chunk in chunks:
        if len(chunk) == 0:
            continue
        planes = dec.decode(bytes(chunk))
        if planes is not None:
            out.append(i420_bytes(planes, dec.vol.height, dec.vol.width))
    last = dec.flush()
    if last is not None:
        out.append(i420_bytes(last, dec.vol.height, dec.vol.width))
    return out, dec.vol


def decode_bgr(chunks, tag: str = "FMP4", extradata: bytes = b"",
               height: Optional[int] = None, width: Optional[int] = None
               ) -> List[np.ndarray]:
    """The (H, W, 3) BGR uint8 frames ``cv2.VideoCapture`` gives for a
    stream's chunks."""
    frames, vol = decode_planes(chunks, tag, extradata, height, width)
    return [_raw_bgr(f, "i420_left", vol.height, vol.width,
                     matrix=matrix_name(vol)) for f in frames]
