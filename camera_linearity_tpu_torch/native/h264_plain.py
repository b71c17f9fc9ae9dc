"""Plain version of the port's H.264 decoder (``h264.cpp``), and the
stream layer both share: the frames ``cv2.VideoCapture`` gives for an
H.264 stream of the Constrained Baseline tools, pure Python and NumPy.

cv2 reads such a stream through FFmpeg 8's h264 decoder and swscale.  The
decoding process of H.264 is exact by the standard (an integer transform,
defined interpolation and deblocking), so every conforming decoder gives
the same planes; they then convert as the rawvideo reader's ``i420_left``
layout (FFmpeg sites H.264's chroma left; the picture heights are even)
or, for a full-range stream, its ``yuvj420p`` conversion, by the VUI's
matrix (BT.601 or BT.709).

What it reads:

* NAL units: Annex B (start codes of 3 and 4 bytes) or length-prefixed
  (1, 2 or 4 bytes: ``lengthSizeMinusOne`` of an ``avcC``), emulation
  prevention; AUD, SEI, filler, end-of-sequence and end-of-stream NAL
  units and the SVC/MVC types 14, 15 and 20 are skipped; sequence and
  picture parameter sets by id, in the extradata or in band.
* SPS: 8-bit 4:2:0, ``pic_order_cnt_type`` 0, 1 and 2, up to 16
  reference frames, ``frame_mbs_only_flag`` 1, frame cropping (a left
  crop in multiples of 64 luma samples: FFmpeg keeps a smaller one only
  to the multiple of 64 below it, so that the frame's data pointers stay
  aligned, and cv2 scales that wider frame to the cropped width), the
  VUI (its ``video_full_range_flag`` and colour description choose the
  conversion; HRD parameters and ``bitstream_restriction`` are read
  past).
* PPS: CAVLC, one slice group, no weighted prediction, any
  ``chroma_qp_index_offset`` (and a ``second_chroma_qp_index_offset``),
  ``deblocking_filter_control_present_flag``,
  ``constrained_intra_pred_flag``, ``redundant_pic_cnt_present_flag``
  (the count must be 0).  As FFmpeg, a PPS of a Baseline, Main or
  Extended SPS with constraint flags 0-2 set has no fields after
  ``redundant_pic_cnt_present_flag``.
* Slices: I and P, any number in a picture (in increasing order of their
  first macroblock), ``num_ref_idx_active_override``, reference list
  modification, ``dec_ref_pic_marking`` (the sliding window and every
  memory management operation, long-term references and MMCO 5 among
  them), ``slice_qp_delta``, ``disable_deblocking_filter_idc`` 0-2 and
  the filter offsets.
* Macroblocks (:class:`Decoder`): I_PCM, Intra4x4, Intra16x16, the inter
  partitions and P_Skip, CAVLC residuals, quarter-sample luma and
  eighth-sample chroma interpolation with clamped reference coordinates,
  the 4x4 inverse transform and the deblocking filter.
* Output: each picture as soon as it is decoded, the order FFmpeg gives
  for streams whose POCs increase in decode order between IDR pictures
  (and MMCO 5); one picture a sample (an AVI chunk, an MP4 sample, a
  Matroska frame).

What it refuses (:func:`unsupported` and :class:`H264Error`, naming the
tool): CABAC, B, SP and SI slices, interlaced coding (PAFF/MBAFF), the
8x8 transform, scaling matrices, weighted prediction, bit depths over 8,
chroma formats other than 4:2:0, ``qpprime_y_zero_transform_bypass``,
slice groups, redundant pictures, a left crop that is no multiple of 64,
gaps in ``frame_num``, POCs that do not increase, a stream that does not
start with an IDR picture, a sample of two pictures, and damaged or
truncated slices (which FFmpeg conceals), naming the frame, the slice
and the macroblock.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["H264_FOURCCS", "probe", "H264Error", "Sps", "Pps", "SliceHeader",
           "Stream", "Decoder", "unsupported", "split_annexb", "split_lengths",
           "avcc_params", "parse_sps", "parse_pps", "parse_slice_header",
           "geometry", "matrix_name", "crop_origin", "failure",
           "decode_planes", "decode_bgr", "i420_bytes", "TOKEN_LEN",
           "TOKEN_CODE", "DC_TOKEN_LEN", "DC_TOKEN_CODE", "ZEROS_LEN",
           "ZEROS_CODE", "DC_ZEROS_LEN", "DC_ZEROS_CODE", "RUN_LEN", "RUN_CODE"]


class H264Error(ValueError):
    """An H.264 stream the port refuses, or cannot decode as FFmpeg does."""


# ---------------------------------------------------------------- tables

ALPHA = (0,) * 16 + (4, 4, 5, 6, 7, 8, 9, 10, 12, 13, 15, 17, 20, 22, 25,
                     28, 32, 36, 40, 45, 50, 56, 63, 71, 80, 90, 101, 113,
                     127, 144, 162, 182, 203, 226, 255, 255)
BETA = (0,) * 16 + (2, 2, 2, 3, 3, 3, 3, 4, 4, 4, 6, 6, 7, 7, 8, 8, 9, 9,
                    10, 10, 11, 11, 12, 12, 13, 13, 14, 14, 15, 15, 16, 16,
                    17, 17, 18, 18)
TC0 = ((0, 0, 0),) * 17 + (
    (0, 0, 1), (0, 0, 1), (0, 0, 1), (0, 0, 1), (0, 1, 1), (0, 1, 1),
    (1, 1, 1), (1, 1, 1), (1, 1, 1), (1, 1, 1), (1, 1, 2), (1, 1, 2),
    (1, 1, 2), (1, 1, 2), (1, 2, 3), (1, 2, 3), (2, 2, 3), (2, 2, 4),
    (2, 3, 4), (2, 3, 4), (3, 3, 5), (3, 4, 6), (3, 4, 6), (4, 5, 7),
    (4, 5, 8), (4, 6, 9), (5, 7, 10), (6, 8, 11), (6, 8, 13), (7, 10, 14),
    (8, 11, 16), (9, 12, 18), (10, 13, 20), (11, 15, 23), (13, 17, 25))
CHROMA_QP = tuple(range(30)) + (29, 30, 31, 32, 32, 33, 34, 34, 35, 35, 36,
                                36, 37, 37, 37, 38, 38, 38, 39, 39, 39, 39)
ZIGZAG = (0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15)
NORM = ((10, 16, 13), (11, 18, 14), (13, 20, 16), (14, 23, 18),
        (16, 25, 20), (18, 29, 23))
NORM_CLASS = (0, 2, 0, 2, 2, 1, 2, 1, 0, 2, 0, 2, 2, 1, 2, 1)
CBP_INTRA = (47, 31, 15, 0, 23, 27, 29, 30, 7, 11, 13, 14, 39, 43, 45, 46,
             16, 3, 5, 10, 12, 19, 21, 26, 28, 35, 37, 42, 44, 1, 2, 4,
             8, 17, 18, 20, 24, 6, 9, 22, 25, 32, 33, 34, 36, 40, 38, 41)
CBP_INTER = (0, 16, 1, 2, 4, 8, 32, 3, 5, 10, 12, 15, 47, 7, 11, 13,
             14, 6, 9, 31, 35, 37, 42, 44, 33, 34, 36, 40, 39, 43, 45, 46,
             17, 18, 20, 24, 19, 21, 26, 28, 23, 27, 29, 30, 22, 25, 38, 41)
# coeff_token: [nC class][TotalCoeff * 4 + TrailingOnes]; classes
# 0 <= nC < 2, 2 <= nC < 4, 4 <= nC < 8, 8 <= nC
TOKEN_LEN = (
    (1, 0, 0, 0, 6, 2, 0, 0, 8, 6, 3, 0, 9, 8, 7, 5, 10, 9, 8, 6, 11, 10, 9,
     7, 13, 11, 10, 8, 13, 13, 11, 9, 13, 13, 13, 10, 14, 14, 13, 11, 14,
     14, 14, 13, 15, 15, 14, 14, 15, 15, 15, 14, 16, 15, 15, 15, 16, 16, 16,
     15, 16, 16, 16, 16, 16, 16, 16, 16),
    (2, 0, 0, 0, 6, 2, 0, 0, 6, 5, 3, 0, 7, 6, 6, 4, 8, 6, 6, 4, 8, 7, 7, 5,
     9, 8, 8, 6, 11, 9, 9, 6, 11, 11, 11, 7, 12, 11, 11, 9, 12, 12, 12, 11,
     12, 12, 12, 11, 13, 13, 13, 12, 13, 13, 13, 13, 13, 14, 13, 13, 14, 14,
     14, 13, 14, 14, 14, 14),
    (4, 0, 0, 0, 6, 4, 0, 0, 6, 5, 4, 0, 6, 5, 5, 4, 7, 5, 5, 4, 7, 5, 5, 4,
     7, 6, 6, 4, 7, 6, 6, 4, 8, 7, 7, 5, 8, 8, 7, 6, 9, 8, 8, 7, 9, 9, 8, 8,
     9, 9, 9, 8, 10, 9, 9, 9, 10, 10, 10, 10, 10, 10, 10, 10, 10, 10, 10,
     10),
    (6, 0, 0, 0) + (6,) * 64)
TOKEN_CODE = (
    (1, 0, 0, 0, 5, 1, 0, 0, 7, 4, 1, 0, 7, 6, 5, 3, 7, 6, 5, 3, 7, 6, 5, 4,
     15, 6, 5, 4, 11, 14, 5, 4, 8, 10, 13, 4, 15, 14, 9, 4, 11, 10, 13, 12,
     15, 14, 9, 12, 11, 10, 13, 8, 15, 1, 9, 12, 11, 14, 13, 8, 7, 10, 9,
     12, 4, 6, 5, 8),
    (3, 0, 0, 0, 11, 2, 0, 0, 7, 7, 3, 0, 7, 10, 9, 5, 7, 6, 5, 4, 4, 6, 5,
     6, 7, 6, 5, 8, 15, 6, 5, 4, 11, 14, 13, 4, 15, 10, 9, 4, 11, 14, 13,
     12, 8, 10, 9, 8, 15, 14, 13, 12, 11, 10, 9, 12, 7, 11, 6, 8, 9, 8, 10,
     1, 7, 6, 5, 4),
    (15, 0, 0, 0, 15, 14, 0, 0, 11, 15, 13, 0, 8, 12, 14, 12, 15, 10, 11,
     11, 11, 8, 9, 10, 9, 14, 13, 9, 8, 10, 9, 8, 15, 14, 13, 13, 11, 14,
     10, 12, 15, 10, 13, 12, 11, 14, 9, 12, 8, 10, 13, 8, 13, 7, 9, 12, 9,
     12, 11, 10, 5, 8, 7, 6, 1, 4, 3, 2),
    (3, 0, 0, 0, 0, 1, 0, 0, 4, 5, 6, 0) + tuple(range(8, 64)))
DC_TOKEN_LEN = (2, 0, 0, 0, 6, 1, 0, 0, 6, 6, 3, 0, 6, 7, 7, 6, 6, 8, 8, 7)
DC_TOKEN_CODE = (1, 0, 0, 0, 7, 1, 0, 0, 4, 6, 1, 0, 3, 3, 2, 5, 2, 3, 2, 0)
ZEROS_LEN = (
    (1, 3, 3, 4, 4, 5, 5, 6, 6, 7, 7, 8, 8, 9, 9, 9),
    (3, 3, 3, 3, 3, 4, 4, 4, 4, 5, 5, 6, 6, 6, 6),
    (4, 3, 3, 3, 4, 4, 3, 3, 4, 5, 5, 6, 5, 6),
    (5, 3, 4, 4, 3, 3, 3, 4, 3, 4, 5, 5, 5),
    (4, 4, 4, 3, 3, 3, 3, 3, 4, 5, 4, 5), (6, 5, 3, 3, 3, 3, 3, 3, 4, 3, 6),
    (6, 5, 3, 3, 3, 2, 3, 4, 3, 6), (6, 4, 5, 3, 2, 2, 3, 3, 6),
    (6, 6, 4, 2, 2, 3, 2, 5), (5, 5, 3, 2, 2, 2, 4), (4, 4, 3, 3, 1, 3),
    (4, 4, 2, 1, 3), (3, 3, 1, 2), (2, 2, 1), (1, 1))
ZEROS_CODE = (
    (1, 3, 2, 3, 2, 3, 2, 3, 2, 3, 2, 3, 2, 3, 2, 1),
    (7, 6, 5, 4, 3, 5, 4, 3, 2, 3, 2, 3, 2, 1, 0),
    (5, 7, 6, 5, 4, 3, 4, 3, 2, 3, 2, 1, 1, 0),
    (3, 7, 5, 4, 6, 5, 4, 3, 3, 2, 2, 1, 0),
    (5, 4, 3, 7, 6, 5, 4, 3, 2, 1, 1, 0), (1, 1, 7, 6, 5, 4, 3, 2, 1, 1, 0),
    (1, 1, 5, 4, 3, 3, 2, 1, 1, 0), (1, 1, 1, 3, 3, 2, 2, 1, 0),
    (1, 0, 1, 3, 2, 1, 1, 1), (1, 0, 1, 3, 2, 1, 1), (0, 1, 1, 2, 1, 3),
    (0, 1, 1, 1, 1), (0, 1, 1, 1), (0, 1, 1), (0, 1))
DC_ZEROS_LEN = ((1, 2, 3, 3), (1, 2, 2), (1, 1))
DC_ZEROS_CODE = ((1, 1, 1, 0), (1, 1, 0), (1, 0))
RUN_LEN = ((1, 1), (1, 2, 2), (2, 2, 2, 2), (2, 2, 2, 3, 3),
           (2, 2, 3, 3, 3, 3), (2, 3, 3, 3, 3, 3, 3),
           (3, 3, 3, 3, 3, 3, 3, 4, 5, 6, 7, 8, 9, 10, 11))
RUN_CODE = ((1, 0), (1, 1, 0), (3, 2, 1, 0), (3, 2, 1, 1, 0),
            (3, 2, 3, 2, 1, 0), (3, 0, 1, 3, 2, 5, 4),
            (7, 6, 5, 4, 3, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1))
# luma4x4BlkIdx -> the block's (x, y) in 4x4 units
BLK_X = (0, 1, 0, 1, 2, 3, 2, 3, 0, 1, 0, 1, 2, 3, 2, 3)
BLK_Y = (0, 0, 1, 1, 0, 0, 1, 1, 2, 2, 3, 3, 2, 2, 3, 3)

# the AVI fourccs FFmpeg 8's AVI demuxer maps to its h264 decoder (its
# BITMAPINFOHEADER tags, and the QuickTime ones it falls back to) that cv2
# opens as H.264
H264_FOURCCS = ("H264", "h264", "X264", "x264", "avc1", "AVC1", "DAVC",
                "SMV2", "VSSH", "Q264", "V264", "GAVC", "UMSV", "tshd",
                "INMC", "avc3", "AVC3")

# NAL unit types
NAL_SLICE, NAL_DPA, NAL_DPB, NAL_DPC, NAL_IDR = 1, 2, 3, 4, 5
NAL_SEI, NAL_SPS, NAL_PPS = 6, 7, 8
# SPS profile_idc values with the chroma and bit-depth fields
_HIGH_PROFILES = {100, 110, 122, 244, 44, 83, 86, 118, 128, 138, 139, 134,
                  135}


# ---------------------------------------------------------------- NAL units

def split_annexb(data: bytes) -> List[bytes]:
    """The NAL units of an Annex B byte stream (3- and 4-byte start
    codes; the zero bytes before a start code belong to none)."""
    out = []
    i = data.find(b"\x00\x00\x01")
    while i >= 0:
        start = i + 3
        j = data.find(b"\x00\x00\x01", start)
        end = len(data) if j < 0 else j
        nal = data[start:end].rstrip(b"\x00")
        if nal:
            out.append(nal)
        i = j
    return out


def split_lengths(data: bytes, size: int) -> List[bytes]:
    """The NAL units of a sample whose units each follow a ``size``-byte
    big-endian length; raises where a length runs past the sample."""
    out, at = [], 0
    while at + size <= len(data):
        n = int.from_bytes(data[at:at + size], "big")
        at += size
        if at + n > len(data):
            raise H264Error(f"a NAL unit of {n} bytes past the sample's end")
        if n:
            out.append(data[at:at + n])
        at += n
    return out


def avcc_params(extra: bytes) -> Tuple[int, List[bytes]]:
    """(NAL length size, [SPS and PPS NAL units]) of an ``avcC``
    (AVCDecoderConfigurationRecord); raises where it is no avcC."""
    if len(extra) < 7 or extra[0] != 1:
        raise H264Error(f"an avcC of {len(extra)} bytes whose version is "
                        f"{extra[0] if extra else 'missing'}, not 1")
    size = (extra[4] & 3) + 1
    if size == 3:
        raise H264Error("an avcC of 3-byte NAL lengths")
    nals, at = [], 5
    for count_mask in (0x1F, 0xFF):
        if at >= len(extra):
            raise H264Error("an avcC that ends inside its parameter sets")
        n = extra[at] & count_mask
        at += 1
        for _ in range(n):
            if at + 2 > len(extra):
                raise H264Error("an avcC that ends inside its parameter sets")
            length = int.from_bytes(extra[at:at + 2], "big")
            at += 2
            if at + length > len(extra):
                raise H264Error("an avcC that ends inside its parameter "
                                "sets")
            nals.append(extra[at:at + length])
            at += length
    return size, nals


def to_rbsp(nal: bytes) -> bytes:
    """The RBSP of a NAL unit (its header byte dropped, emulation
    prevention bytes removed)."""
    return nal[1:].replace(b"\x00\x00\x03", b"\x00\x00")


def stop_bit(rbsp: bytes) -> int:
    """The position of the rbsp_stop_one_bit (trailing zero bytes
    ignored); -1 where there is none."""
    end = len(rbsp.rstrip(b"\x00"))
    if not end:
        return -1
    last = rbsp[end - 1]
    return end * 8 - 1 - ((last & -last).bit_length() - 1)


class Bits:
    """An MSB-first reader of an RBSP; reads past the end give zeros."""

    def __init__(self, data: bytes, pos: int = 0, end: Optional[int] = None):
        self.data = bytes(data) + b"\x00" * 8
        self.pos = pos
        self.end = stop_bit(data) if end is None else end

    def u(self, n: int) -> int:
        if n > 32:
            return (self.u(n - 16) << 16) | self.u(16)
        p = self.pos
        v = int.from_bytes(self.data[p >> 3:(p >> 3) + 5], "big")
        self.pos = p + n
        return (v >> (40 - (p & 7) - n)) & ((1 << n) - 1)

    def bit(self) -> int:
        p = self.pos
        self.pos = p + 1
        return (self.data[p >> 3] >> (7 - (p & 7))) & 1

    def ue(self) -> int:
        zeros = 0
        while not self.bit():
            zeros += 1
            if zeros > 31:
                raise _Bad(-1)
        return (1 << zeros) - 1 + self.u(zeros)

    def se(self) -> int:
        k = self.ue()
        return (k + 1) >> 1 if k & 1 else -(k >> 1)

    def more(self) -> bool:
        return self.pos < self.end


class _Bad(Exception):
    """A decoding failure with h264.cpp's return code."""

    def __init__(self, code: int):
        super().__init__(code)
        self.code = code


# the return codes' meanings (h264.cpp's)
REASONS = {
    -1: "bits FFmpeg fails to decode (it conceals the picture)",
    -2: "the slice data end inside a macroblock",
    -3: "macroblocks no slice covers (FFmpeg conceals them)",
    -4: "an earlier picture failed to decode (the references are lost)",
    -5: "a reference index with no picture behind it",
    -6: "a slice that starts inside another",
    -7: "a slice that runs past the picture's last macroblock"}


# ---------------------------------------------------------------- SPS, PPS

@dataclass
class Sps:
    id: int = 0
    profile: int = 66
    constraints: int = 0
    level: int = 30
    chroma_format: int = 1
    bit_depth: int = 8
    bit_depth_chroma: int = 8
    bypass: bool = False
    scaling: bool = False
    log2_max_frame_num: int = 4
    poc_type: int = 0
    log2_max_poc_lsb: int = 4
    delta_always_zero: bool = False
    offset_non_ref: int = 0
    offset_top_bottom: int = 0
    offsets_ref: Tuple[int, ...] = ()
    num_ref_frames: int = 1
    gaps_allowed: bool = False
    mbw: int = 1
    mbh: int = 1
    frame_mbs_only: bool = True
    crop: Tuple[int, int, int, int] = (0, 0, 0, 0)   # left, right, top, bottom
    full_range: bool = False
    # (colour_primaries, transfer_characteristics, matrix_coefficients)
    colour: Optional[Tuple[int, int, int]] = None
    chroma_loc: int = 0
    reorder: Optional[int] = None                    # max_num_reorder_frames


@dataclass
class Pps:
    id: int = 0
    sps_id: int = 0
    cabac: bool = False
    bottom_poc: bool = False
    slice_groups: int = 1
    num_ref_idx: Tuple[int, int] = (1, 1)
    weighted: bool = False
    weighted_bipred: int = 0
    init_qp: int = 26
    cqp: Tuple[int, int] = (0, 0)
    deblock_control: bool = False
    cip: bool = False
    redundant: bool = False
    transform_8x8: bool = False
    scaling: bool = False


def _scaling_lists(r: Bits, n: int) -> None:
    for i in range(n):
        if r.bit():
            last, nxt = 8, 8
            for _ in range(16 if i < 6 else 64):
                if nxt:
                    nxt = (last + r.se() + 256) % 256
                last = nxt or last


def _hrd(r: Bits) -> None:
    count = r.ue() + 1
    r.u(8)
    for _ in range(count):
        r.ue()
        r.ue()
        r.bit()
    r.u(20)


def parse_sps(rbsp: bytes) -> Sps:
    r = Bits(rbsp)
    s = Sps()
    s.profile = r.u(8)
    s.constraints = r.u(8)
    s.level = r.u(8)
    s.id = r.ue()
    if s.id > 31:
        raise H264Error(f"an SPS id of {s.id}")
    if s.profile in _HIGH_PROFILES:
        s.chroma_format = r.ue()
        if s.chroma_format == 3:
            r.bit()
        s.bit_depth = r.ue() + 8
        s.bit_depth_chroma = r.ue() + 8
        s.bypass = bool(r.bit())
        s.scaling = bool(r.bit())
        if s.scaling:
            _scaling_lists(r, 8 if s.chroma_format != 3 else 12)
    s.log2_max_frame_num = r.ue() + 4
    s.poc_type = r.ue()
    if s.poc_type == 0:
        s.log2_max_poc_lsb = r.ue() + 4
    elif s.poc_type == 1:
        s.delta_always_zero = bool(r.bit())
        s.offset_non_ref = r.se()
        s.offset_top_bottom = r.se()
        s.offsets_ref = tuple(r.se() for _ in range(r.ue()))
    elif s.poc_type != 2:
        raise H264Error(f"pic_order_cnt_type {s.poc_type}")
    s.num_ref_frames = r.ue()
    s.gaps_allowed = bool(r.bit())
    s.mbw = r.ue() + 1
    map_h = r.ue() + 1
    s.frame_mbs_only = bool(r.bit())
    s.mbh = map_h * (1 if s.frame_mbs_only else 2)
    if not s.frame_mbs_only:
        r.bit()
    r.bit()    # direct_8x8_inference_flag
    if r.bit():
        ux = 2 if s.chroma_format in (1, 2) else 1
        uy = (2 if s.chroma_format == 1 else 1) * (
            1 if s.frame_mbs_only else 2)
        left, right, top, bottom = (r.ue() for _ in range(4))
        s.crop = (left * ux, right * ux, top * uy, bottom * uy)
    if r.bit():
        _vui(r, s)
    return s


def _vui(r: Bits, s: Sps) -> None:
    if r.bit():                       # aspect_ratio_info_present_flag
        if r.u(8) == 255:
            r.u(32)
    if r.bit():                       # overscan_info_present_flag
        r.bit()
    if r.bit():                       # video_signal_type_present_flag
        r.u(3)
        s.full_range = bool(r.bit())
        if r.bit():
            s.colour = (r.u(8), r.u(8), r.u(8))
    if r.bit():                       # chroma_loc_info_present_flag
        s.chroma_loc = r.ue()
        r.ue()
    if r.bit():                       # timing_info_present_flag
        r.u(32)
        r.u(32)
        r.bit()
    nal_hrd = r.bit()
    if nal_hrd:
        _hrd(r)
    vcl_hrd = r.bit()
    if vcl_hrd:
        _hrd(r)
    if nal_hrd or vcl_hrd:
        r.bit()
    r.bit()                           # pic_struct_present_flag
    if r.bit():                       # bitstream_restriction_flag
        r.bit()
        for _ in range(4):
            r.ue()
        s.reorder = r.ue()
        r.ue()


def parse_pps(rbsp: bytes, spss: Dict[int, Sps]) -> Pps:
    r = Bits(rbsp)
    p = Pps()
    p.id = r.ue()
    p.sps_id = r.ue()
    if p.id > 255 or p.sps_id not in spss:
        raise H264Error(f"a PPS ({p.id}) of an SPS ({p.sps_id}) the stream "
                        "has not given")
    sps = spss[p.sps_id]
    p.cabac = bool(r.bit())
    p.bottom_poc = bool(r.bit())
    p.slice_groups = r.ue() + 1
    if p.slice_groups > 1:
        return p          # refused by unsupported(); its map is not read
    p.num_ref_idx = (r.ue() + 1, r.ue() + 1)
    p.weighted = bool(r.bit())
    p.weighted_bipred = r.u(2)
    p.init_qp = 26 + r.se()
    r.se()                # pic_init_qs_minus26
    c = r.se()
    p.cqp = (c, c)
    p.deblock_control = bool(r.bit())
    p.cip = bool(r.bit())
    p.redundant = bool(r.bit())
    # FFmpeg reads on only where the profile may have more (h264_ps.c:
    # more_rbsp_data_in_pps)
    if r.more() and not (sps.profile in (66, 77, 88) and
                         sps.constraints >> 5 & 7):
        p.transform_8x8 = bool(r.bit())
        p.scaling = bool(r.bit())
        if p.scaling:
            _scaling_lists(r, 6 + (2 if sps.chroma_format != 3 else 6) *
                           p.transform_8x8)
        p.cqp = (c, r.se())
    return p


def sps_unsupported(s: Sps) -> Optional[str]:
    if s.chroma_format != 1:
        return f"chroma_format_idc {s.chroma_format} (4:2:0 only)"
    if s.bit_depth != 8 or s.bit_depth_chroma != 8:
        return (f"a bit depth of {s.bit_depth} (luma) and "
                f"{s.bit_depth_chroma} (chroma) (8 bits only)")
    if s.bypass:
        return "qpprime_y_zero_transform_bypass (lossless macroblocks)"
    if s.scaling:
        return "scaling matrices (seq_scaling_matrix_present_flag)"
    if not s.frame_mbs_only:
        return "interlaced coding (frame_mbs_only_flag 0: PAFF or MBAFF)"
    if s.num_ref_frames > 16:
        return f"{s.num_ref_frames} reference frames"
    if s.crop[0] % 64:
        return (f"a left crop of {s.crop[0]} luma samples, not a multiple "
                "of 64 (FFmpeg then keeps a wider frame, which cv2 scales "
                "to the cropped width)")
    if s.full_range and s.colour is not None and s.colour[2] == 1:
        return "a full-range BT.709 signal"
    if s.colour is not None and s.colour[2] not in (1, 2, 5, 6):
        return (f"matrix_coefficients {s.colour[2]} (BT.601 and BT.709 "
                "only)")
    return None


def pps_unsupported(p: Pps) -> Optional[str]:
    if p.cabac:
        return "CABAC (entropy_coding_mode_flag 1)"
    if p.slice_groups > 1:
        return f"slice groups (FMO: {p.slice_groups} groups)"
    if p.weighted:
        return "weighted prediction (weighted_pred_flag 1)"
    if p.transform_8x8:
        return "the 8x8 transform (transform_8x8_mode_flag 1)"
    if p.scaling:
        return "scaling matrices (pic_scaling_matrix_present_flag)"
    return None


def unsupported(sps: Optional[Sps] = None, pps: Optional[Pps] = None,
                header: Optional["SliceHeader"] = None) -> Optional[str]:
    """What of a stream the decoder does not read, or None: from its SPS,
    PPS and (``header``) a slice header."""
    if sps is not None:
        why = sps_unsupported(sps)
        if why:
            return why
    if pps is not None:
        why = pps_unsupported(pps)
        if why:
            return why
    if header is not None:
        if header.type in (1, 3, 4):
            return ("P", "B", "I", "SP", "SI")[header.type] + " slices"
        if header.redundant:
            return f"redundant pictures (redundant_pic_cnt {header.redundant})"
    return None


def geometry(s: Sps) -> Tuple[int, int]:
    """(height, width) of the frames cv2 gives for ``s``: the coded size
    less the crop (the codec context's size, which cv2 converts to)."""
    left, right, top, bottom = s.crop
    return s.mbh * 16 - top - bottom, s.mbw * 16 - left - right


def crop_origin(s: Sps) -> Tuple[int, int]:
    """(top, left) of cv2's frames in the coded picture."""
    return s.crop[2], s.crop[0]


def matrix_name(s: Sps, container: Optional[str] = None) -> str:
    """The converter's matrix for the stream's frames: the VUI's colour
    description where it has one (BT.709 for matrix_coefficients 1, else
    BT.601: FFmpeg's decoder then sets the frame's, unspecified included),
    else the container's (``container``, from its colour tags), else
    BT.601; ``"bt601_full"`` for a full-range stream."""
    if s.colour is not None:
        name = "bt709" if s.colour[2] == 1 else "bt601"
    else:
        name = container or "bt601"
    return name + "_full" if s.full_range else name


# ---------------------------------------------------------------- slices

@dataclass
class SliceHeader:
    nal_type: int = 1
    ref_idc: int = 0
    first_mb: int = 0
    type: int = 2            # 0 P, 1 B, 2 I, 3 SP, 4 SI
    pps_id: int = 0
    frame_num: int = 0
    idr_id: int = 0
    poc_lsb: int = 0
    delta_bottom: int = 0
    delta_poc: Tuple[int, int] = (0, 0)
    redundant: int = 0
    num_ref: int = 1
    modifications: List[Tuple[int, int]] = field(default_factory=list)
    no_output_prior: bool = False
    long_term: bool = False
    mmcos: Optional[List[Tuple[int, ...]]] = None
    qp: int = 26
    disable: int = 0
    off_a: int = 0
    off_b: int = 0
    data_bit: int = 0        # slice_data's first bit in the RBSP

    @property
    def idr(self) -> bool:
        return self.nal_type == NAL_IDR


def parse_slice_header(rbsp: bytes, nal_type: int, ref_idc: int,
                       spss: Dict[int, Sps], ppss: Dict[int, Pps]
                       ) -> Tuple[SliceHeader, Sps, Pps]:
    r = Bits(rbsp)
    h = SliceHeader(nal_type=nal_type, ref_idc=ref_idc)
    h.first_mb = r.ue()
    t = r.ue()
    if t > 9:
        raise H264Error(f"slice_type {t}")
    h.type = t % 5
    h.pps_id = r.ue()
    if h.pps_id not in ppss:
        raise H264Error(f"a slice of a PPS ({h.pps_id}) the stream has not "
                        "given")
    pps = ppss[h.pps_id]
    sps = spss[pps.sps_id]
    why = unsupported(sps, pps)
    if why:
        return h, sps, pps    # the caller refuses it
    h.frame_num = r.u(sps.log2_max_frame_num)
    if h.idr:
        h.idr_id = r.ue()
    if sps.poc_type == 0:
        h.poc_lsb = r.u(sps.log2_max_poc_lsb)
        if pps.bottom_poc:
            h.delta_bottom = r.se()
    elif sps.poc_type == 1 and not sps.delta_always_zero:
        d0 = r.se()
        h.delta_poc = (d0, r.se() if pps.bottom_poc else 0)
    if pps.redundant:
        h.redundant = r.ue()
    if h.type == 1:
        r.bit()
    h.num_ref = pps.num_ref_idx[0]
    if h.type in (0, 1, 3):
        if r.bit():
            h.num_ref = r.ue() + 1
            if h.type == 1:
                r.ue()
        if h.num_ref > 32:
            raise H264Error(f"num_ref_idx_l0_active of {h.num_ref}")
    if h.type in (1, 3, 4) or h.redundant:
        return h, sps, pps    # refused by unsupported()
    if h.type != 2:
        if r.bit():
            while True:
                idc = r.ue()
                if idc == 3:
                    break
                if idc > 2:
                    raise H264Error(
                        f"modification_of_pic_nums_idc {idc}")
                h.modifications.append((idc, r.ue()))
                if len(h.modifications) > h.num_ref + 1:
                    raise H264Error("more reference list modifications "
                                    "than entries")
    if ref_idc:
        if h.idr:
            h.no_output_prior = bool(r.bit())
            h.long_term = bool(r.bit())
        elif r.bit():
            h.mmcos = []
            while True:
                op = r.ue()
                if op == 0:
                    break
                if op > 6:
                    raise H264Error(f"memory_management_control_operation "
                                    f"{op}")
                args: Tuple[int, ...] = ()
                if op in (1, 3):
                    args += (r.ue() + 1,)
                if op == 2:
                    args += (r.ue(),)
                if op in (3, 6):
                    args += (r.ue(),)
                if op == 4:
                    args += (r.ue(),)
                h.mmcos.append((op,) + args)
                if len(h.mmcos) > 66:
                    raise H264Error("more than 66 memory management "
                                    "operations")
    h.qp = pps.init_qp + r.se()
    if not 0 <= h.qp <= 51:
        raise H264Error(f"a slice QP of {h.qp}")
    if pps.deblock_control:
        h.disable = r.ue()
        if h.disable > 2:
            raise H264Error(f"disable_deblocking_filter_idc {h.disable}")
        if h.disable != 1:
            h.off_a = r.se() * 2
            h.off_b = r.se() * 2
            if not (-12 <= h.off_a <= 12 and -12 <= h.off_b <= 12):
                raise H264Error("deblocking filter offsets out of range")
    h.data_bit = r.pos
    return h, sps, pps


# ---------------------------------------------------------------- pictures

@dataclass
class Picture:
    """A decoded picture in the DPB."""
    slot: int
    id: int
    frame_num: int
    poc: int
    ref: Optional[str] = None      # "short", "long" or None
    long_idx: int = -1
    mmco5: bool = False


@dataclass
class Slice:
    header: SliceHeader
    rbsp: bytes
    end_bit: int
    refs: List[Optional[Picture]]
    pps: Pps


@dataclass
class Job:
    """A picture to decode: its frame slot, chain (the GOP it belongs to:
    pictures of one chain decode in order, chains side by side) and
    slices; ``index`` is its frame number in the stream."""
    pic: Picture
    chain: int
    slices: List[Slice]
    sps: Sps
    index: int

    def native_params(self, s: Slice) -> List[int]:
        """h264.cpp's SliceParams of slice ``s`` (kParams ints)."""
        h = s.header
        refs = [-1] * 32
        ids = [-1] * 32
        for i, p in enumerate(s.refs[:32]):
            if p is not None:
                refs[i], ids[i] = p.slot, p.id
        return [h.first_mb, 0 if h.type == 0 else 2, h.qp, h.disable,
                h.off_a, h.off_b, s.pps.cqp[0], s.pps.cqp[1], int(s.pps.cip),
                h.num_ref if h.type == 0 else 0] + refs + ids


class Stream:
    """The stream layer of an H.264 decoder: NAL units, parameter sets,
    slice headers, POCs, the reference marking and lists, and which
    frame slot each picture decodes into.  ``extradata``: an avcC (its
    NAL length size then splits the samples) or Annex B parameter sets or
    nothing (the samples are Annex B).  :meth:`next` takes the stream's
    samples in order and returns the :class:`Job` of the picture a sample
    holds, or None; ``slots`` frame slots are handed out, a slot coming
    free once its picture is no reference and has been output (the caller
    says so: :meth:`release`)."""

    def __init__(self, extradata: bytes = b""):
        self.spss: Dict[int, Sps] = {}
        self.ppss: Dict[int, Pps] = {}
        self.length_size = 0
        if extradata[:1] == b"\x01":
            self.length_size, nals = avcc_params(extradata)
        else:
            nals = split_annexb(extradata)
        for nal in nals:
            self._parameter_set(nal)
        self.dpb: List[Picture] = []
        self.frames = 0          # samples read
        self.chain = -1
        self.next_id = 0
        self.busy: set = set()   # slots of pictures not yet released
        self.pinned: set = set()  # slots a picture of this batch reads
        self.started = False
        # POC and frame_num state
        self.prev_ref_frame_num = 0
        self.prev_frame_num = 0
        self.prev_frame_num_offset = 0
        self.prev_poc_msb = 0
        self.prev_poc_lsb = 0
        self.last_poc: Optional[int] = None
        self.max_long_idx = -1   # "no long-term frame indices"
        self.sps: Optional[Sps] = None
        self._tops = (0, 0)      # the current picture's field POCs
        self._poc0_next = (0, 0)  # its (msb, lsb) where it is a reference

    # ------------------------------------------------------------ NALs
    def _parameter_set(self, nal: bytes) -> None:
        kind = nal[0] & 0x1F
        try:
            if kind == NAL_SPS:
                s = parse_sps(to_rbsp(nal))
                self.spss[s.id] = s
            elif kind == NAL_PPS:
                p = parse_pps(to_rbsp(nal), self.spss)
                self.ppss[p.id] = p
        except IndexError:
            raise H264Error("a parameter set that ends early") from None

    def nals(self, sample: bytes) -> List[bytes]:
        if self.length_size:
            return split_lengths(sample, self.length_size)
        return split_annexb(sample)

    def slices_of(self, sample: bytes) -> List[Tuple[SliceHeader, Sps, Pps,
                                                     bytes]]:
        """The slices of a sample, parameter sets taken in on the way."""
        out = []
        for nal in self.nals(sample):
            kind = nal[0] & 0x1F
            if kind in (NAL_SPS, NAL_PPS):
                self._parameter_set(nal)
            elif kind in (NAL_SLICE, NAL_IDR):
                rbsp = to_rbsp(nal)
                h, sps, pps = parse_slice_header(rbsp, kind, nal[0] >> 5 & 3,
                                                 self.spss, self.ppss)
                why = unsupported(sps, pps, h)
                if why:
                    raise H264Error(why)
                out.append((h, sps, pps, rbsp))
            elif kind in (NAL_DPA, NAL_DPB, NAL_DPC):
                raise H264Error("data partitioning (NAL unit types 2-4)")
            # the others are skipped: SEI, AUD, end of sequence and
            # stream, filler, SPS extension, prefix, subset SPS and the
            # SVC/MVC slice extensions (FFmpeg decodes the base layer)
        return out

    # ------------------------------------------------------------ pictures
    def _free_slot(self) -> int:
        used = {p.slot for p in self.dpb} | self.busy | self.pinned
        slot = 0
        while slot in used:
            slot += 1
        return slot

    def release(self, slot: int) -> None:
        """The picture in ``slot`` has been output."""
        self.busy.discard(slot)

    def end_batch(self) -> None:
        """The pictures handed out so far are decoded: the slots they
        read may be handed out again (pictures of one batch may decode
        side by side, a GOP a thread)."""
        self.pinned.clear()

    def next(self, sample: bytes) -> Optional[Job]:
        """The :class:`Job` of the picture ``sample`` holds, or None (a
        sample of parameter sets or SEI only).  Raises
        :class:`H264Error` naming the frame where the stream is refused."""
        index = self.frames
        self.frames += 1
        try:
            found = self.slices_of(bytes(sample))
        except H264Error as exc:
            raise H264Error(f"frame {index}: {exc}") from None
        except IndexError:
            raise H264Error(f"frame {index}: a slice header that ends "
                            "early") from None
        if not found:
            return None
        try:
            return self._picture(found, index)
        except H264Error as exc:
            raise H264Error(f"frame {index}: {exc}") from None

    def _picture(self, found, index: int) -> Job:
        h0, sps, pps0, _ = found[0]
        for k, (h, s, p, _) in enumerate(found):
            if k and h.first_mb <= found[k - 1][0].first_mb:
                if h.first_mb == 0:
                    raise H264Error("a sample that holds two pictures")
                raise H264Error(f"slices out of order (slice {k} starts at "
                                f"macroblock {h.first_mb})")
            if (h.frame_num, h.idr, h.ref_idc != 0, h.poc_lsb, h.idr_id,
                    p.sps_id) != (h0.frame_num, h0.idr, h0.ref_idc != 0,
                                  h0.poc_lsb, h0.idr_id, pps0.sps_id):
                raise H264Error("a sample that holds two pictures")
        if h0.first_mb != 0:
            raise H264Error(f"a picture whose first slice starts at "
                            f"macroblock {h0.first_mb}")
        if not self.started and not h0.idr:
            raise H264Error("a stream that does not start with an IDR "
                            "picture")
        if self.sps is not None and (sps.mbw, sps.mbh) != (self.sps.mbw,
                                                          self.sps.mbh):
            raise H264Error(f"a picture of {sps.mbw * 16} x {sps.mbh * 16} "
                            f"after {self.sps.mbw * 16} x "
                            f"{self.sps.mbh * 16}")
        self.started = True
        self.sps = sps
        max_fn = 1 << sps.log2_max_frame_num
        if h0.idr:
            self.dpb = []
            self.prev_ref_frame_num = 0
            self.chain += 1
            self.last_poc = None
        elif h0.frame_num != self.prev_ref_frame_num and \
                h0.frame_num != (self.prev_ref_frame_num + 1) % max_fn:
            raise H264Error(f"a gap in frame_num ({h0.frame_num} after "
                            f"{self.prev_ref_frame_num})")
        poc = self._poc(h0, sps)
        if self.last_poc is not None and poc <= self.last_poc:
            raise H264Error(f"a POC ({poc}) that does not increase (after "
                            f"{self.last_poc}; FFmpeg's reorder delay is not "
                            "fitted)")
        self.last_poc = poc
        pic = Picture(self._free_slot(), self.next_id, h0.frame_num, poc)
        self.next_id += 1
        slices = []
        for h, s, p, rbsp in found:
            refs = self._ref_list(h, sps) if h.type == 0 else []
            self.pinned.update(p.slot for p in refs if p is not None)
            slices.append(Slice(h, rbsp, stop_bit(rbsp), refs, p))
        self._mark(pic, h0, sps)
        self.busy.add(pic.slot)
        return Job(pic, self.chain, slices, sps, index)

    def _poc(self, h: SliceHeader, sps: Sps) -> int:
        max_fn = 1 << sps.log2_max_frame_num
        if sps.poc_type == 0:
            if h.idr:
                self.prev_poc_msb = self.prev_poc_lsb = 0
            max_lsb = 1 << sps.log2_max_poc_lsb
            lsb, plsb, pmsb = h.poc_lsb, self.prev_poc_lsb, self.prev_poc_msb
            if lsb < plsb and plsb - lsb >= max_lsb // 2:
                msb = pmsb + max_lsb
            elif lsb > plsb and lsb - plsb > max_lsb // 2:
                msb = pmsb - max_lsb
            else:
                msb = pmsb
            top = msb + lsb
            bottom = top + h.delta_bottom
            if h.ref_idc:
                self._poc0_next = (msb, lsb)
        else:
            if h.idr:
                offset = 0
            elif self.prev_frame_num > h.frame_num:
                offset = self.prev_frame_num_offset + max_fn
            else:
                offset = self.prev_frame_num_offset
            if sps.poc_type == 1:
                n = len(sps.offsets_ref)
                absn = offset + h.frame_num if n else 0
                if not h.ref_idc and absn > 0:
                    absn -= 1
                expected = 0
                if absn > 0:
                    cycles, within = divmod(absn - 1, n)
                    expected = cycles * sum(sps.offsets_ref) + \
                        sum(sps.offsets_ref[:within + 1])
                if not h.ref_idc:
                    expected += sps.offset_non_ref
                top = expected + h.delta_poc[0]
                bottom = top + sps.offset_top_bottom + h.delta_poc[1]
            else:
                t = 0 if h.idr else 2 * (offset + h.frame_num) - \
                    (0 if h.ref_idc else 1)
                top = bottom = t
            self.prev_frame_num_offset = offset
        self.prev_frame_num = h.frame_num
        self._tops = (top, bottom)
        return min(top, bottom)

    def _ref_list(self, h: SliceHeader, sps: Sps) -> List[Optional[Picture]]:
        max_fn = 1 << sps.log2_max_frame_num
        shorts = [p for p in self.dpb if p.ref == "short"]

        def pic_num(p: Picture) -> int:
            return p.frame_num - max_fn if p.frame_num > h.frame_num \
                else p.frame_num
        shorts.sort(key=pic_num, reverse=True)
        longs = sorted((p for p in self.dpb if p.ref == "long"),
                       key=lambda p: p.long_idx)
        init: List[Optional[Picture]] = (shorts + longs)[:h.num_ref]
        lst = init + [None] * (h.num_ref - len(init))
        pred = h.frame_num
        idx = 0
        for idc, value in h.modifications:
            if idc in (0, 1):
                diff = value + 1
                if idc == 0:
                    no_wrap = pred - diff
                    if no_wrap < 0:
                        no_wrap += max_fn
                else:
                    no_wrap = pred + diff
                    if no_wrap >= max_fn:
                        no_wrap -= max_fn
                pred = no_wrap
                num = no_wrap - max_fn if no_wrap > h.frame_num else no_wrap
                found = [p for p in shorts if pic_num(p) == num]
                if not found:
                    raise H264Error(f"a reference list modification to "
                                    f"picture number {num}, which is no "
                                    "short-term reference")
                target = found[0]
                same = lambda p: p is not None and p.ref == "short" and \
                    pic_num(p) == num
            else:
                found = [p for p in longs if p.long_idx == value]
                if not found:
                    raise H264Error(f"a reference list modification to "
                                    f"long-term picture {value}, which is "
                                    "no long-term reference")
                target = found[0]
                same = lambda p: p is not None and p.ref == "long" and \
                    p.long_idx == value
            lst = lst[:idx] + [target] + [p for p in lst[idx:]
                                          if not same(p)]
            lst = (lst + [None] * h.num_ref)[:h.num_ref]
            idx += 1
        return lst

    def _mark(self, pic: Picture, h: SliceHeader, sps: Sps) -> None:
        max_fn = 1 << sps.log2_max_frame_num
        top, bottom = self._tops
        if not h.ref_idc:
            return
        if h.idr:
            self.dpb = []
            if h.long_term:
                pic.ref, pic.long_idx = "long", 0
                self.max_long_idx = 0
            else:
                pic.ref = "short"
                self.max_long_idx = -1
        elif h.mmcos is None:
            shorts = [p for p in self.dpb if p.ref == "short"]
            longs = [p for p in self.dpb if p.ref == "long"]
            if len(shorts) + len(longs) >= max(sps.num_ref_frames, 1) \
                    and shorts:
                def wrap(p: Picture) -> int:
                    return p.frame_num - max_fn \
                        if p.frame_num > h.frame_num else p.frame_num
                oldest = min(shorts, key=wrap)
                oldest.ref = None
            pic.ref = "short"
        else:
            pic.ref = "short"

            def num_of(p: Picture) -> int:
                return p.frame_num - max_fn if p.frame_num > h.frame_num \
                    else p.frame_num
            for op in h.mmcos:
                kind = op[0]
                if kind in (1, 3):
                    num = h.frame_num - op[1]
                    hit = [p for p in self.dpb if p.ref == "short" and
                           num_of(p) == num]
                    if not hit:
                        raise H264Error(f"memory management operation "
                                        f"{kind} on picture number {num}, "
                                        "which is no short-term reference")
                    if kind == 1:
                        hit[0].ref = None
                    else:
                        for p in self.dpb:
                            if p.ref == "long" and p.long_idx == op[2]:
                                p.ref = None
                        hit[0].ref, hit[0].long_idx = "long", op[2]
                elif kind == 2:
                    for p in self.dpb:
                        if p.ref == "long" and p.long_idx == op[1]:
                            p.ref = None
                elif kind == 4:
                    self.max_long_idx = op[1] - 1
                    for p in self.dpb:
                        if p.ref == "long" and p.long_idx > self.max_long_idx:
                            p.ref = None
                elif kind == 5:
                    for p in self.dpb:
                        p.ref = None
                    self.max_long_idx = -1
                    pic.mmco5 = True
                elif kind == 6:
                    for p in self.dpb:
                        if p.ref == "long" and p.long_idx == op[1]:
                            p.ref = None
                    pic.ref, pic.long_idx = "long", op[1]
        self.dpb = [p for p in self.dpb if p.ref is not None]
        if sum(p.ref is not None for p in self.dpb) >= \
                max(sps.num_ref_frames, 1):
            raise H264Error(f"more reference frames than the SPS's "
                            f"{sps.num_ref_frames}")
        self.dpb.append(pic)
        if pic.mmco5:
            temp = min(top, bottom)
            top -= temp
            pic.frame_num = 0
            self.prev_ref_frame_num = 0
            self.prev_frame_num = 0
            self.prev_frame_num_offset = 0
            self.prev_poc_msb, self.prev_poc_lsb = 0, top
            self.last_poc = top
            pic.poc = top
        else:
            self.prev_ref_frame_num = h.frame_num
            if sps.poc_type == 0:
                self.prev_poc_msb, self.prev_poc_lsb = self._poc0_next


def failure(job: Job, rc: int, where: int) -> str:
    """The message of picture ``job`` failing with h264.cpp's return code
    ``rc`` at macroblock ``where``."""
    mbw = job.sps.mbw
    at = ""
    if where >= 0:
        k = max(i for i, s in enumerate(job.slices)
                if s.header.first_mb <= where) if any(
            s.header.first_mb <= where for s in job.slices) else 0
        at = f"slice {k}, macroblock ({where % mbw}, {where // mbw}): "
    return f"frame {job.index}: {at}" + REASONS.get(rc, f"return code {rc}")


def probe(extradata: bytes, first: bytes) -> Tuple[Optional[Sps],
                                                  Optional[str]]:
    """(the SPS of a stream's first picture, what of the stream the
    decoder does not read or None) from its extradata (an avcC, Annex B
    parameter sets or nothing) and its first sample, before any decode:
    the parameter sets and the first slice header
    (:func:`unsupported`), the first picture's kind.  The SPS is None
    where none is found (and the reason says so)."""
    st = None
    try:
        st = Stream(extradata)
        job = st.next(first) if first else None
    except H264Error as exc:
        sps = next(iter(st.spss.values()), None) if st is not None else None
        return sps, str(exc).removeprefix("frame 0: ")
    if job is None:
        sps = next(iter(st.spss.values()), None)
        return sps, None if sps is not None else \
            "no sequence parameter set in the extradata or the first sample"
    return job.sps, None


# ---------------------------------------------------------------- CAVLC

def _vlc(lengths, codes, values) -> Dict[Tuple[int, int], int]:
    return {(n, c): v for n, c, v in zip(lengths, codes, values) if n}


def _tables():
    token = []
    for cls in range(4):
        vals = [(i >> 2, i & 3) for i in range(68)]
        keep = [i for i, (tc, t1) in enumerate(vals) if t1 <= tc]
        token.append(_vlc([TOKEN_LEN[cls][i] for i in keep],
                          [TOKEN_CODE[cls][i] for i in keep], keep))
    keep = [i for i in range(20) if i & 3 <= i >> 2]
    dc = _vlc([DC_TOKEN_LEN[i] for i in keep],
              [DC_TOKEN_CODE[i] for i in keep], keep)
    zeros = [_vlc(ZEROS_LEN[t], ZEROS_CODE[t], range(16 - t))
             for t in range(15)]
    dc_zeros = [_vlc(DC_ZEROS_LEN[t], DC_ZEROS_CODE[t], range(4 - t))
                for t in range(3)]
    run = [_vlc(RUN_LEN[z], RUN_CODE[z], range(15)) for z in range(7)]
    return token, dc, zeros, dc_zeros, run


_TOKEN, _DC_TOKEN, _ZEROS, _DC_ZEROS, _RUN = _tables()


def _read_vlc(r: Bits, table: Dict[Tuple[int, int], int]) -> int:
    code = 0
    for n in range(1, 17):
        code = (code << 1) | r.bit()
        v = table.get((n, code))
        if v is not None:
            return v
    raise _Bad(-1)


def _nc_class(nc: int) -> int:
    return 0 if nc < 2 else 1 if nc < 4 else 2 if nc < 8 else 3


def read_block(r: Bits, nc: int, start: int, max_coeff: int,
               coef: List[int]) -> int:
    """residual_block_cavlc: up to ``max_coeff`` levels into
    ``coef[start:]`` in scan order (nC -1: chroma DC); TotalCoeff."""
    tok = _read_vlc(r, _DC_TOKEN if nc < 0 else _TOKEN[_nc_class(nc)])
    total, ones = tok >> 2, tok & 3
    if total > max_coeff:
        raise _Bad(-1)
    if not total:
        return 0
    level = []
    suffix_len = 1 if total > 10 and ones < 3 else 0
    for i in range(total):
        if i < ones:
            level.append(-1 if r.bit() else 1)
            continue
        prefix = 0
        while not r.bit():
            prefix += 1
            if prefix > 28:
                raise _Bad(-1)
        code = min(15, prefix) << suffix_len
        size = suffix_len
        if prefix == 14 and suffix_len == 0:
            size = 4
        if prefix >= 15:
            size = prefix - 3
        if size:
            code += r.u(size)
        if prefix >= 15 and suffix_len == 0:
            code += 15
        if prefix >= 16:
            code += (1 << (prefix - 3)) - 4096
        if i == ones and ones < 3:
            code += 2
        lv = (-code - 1) >> 1 if code & 1 else (code + 2) >> 1
        level.append(lv)
        if suffix_len == 0:
            suffix_len = 1
        if abs(lv) > (3 << (suffix_len - 1)) and suffix_len < 6:
            suffix_len += 1
    zeros = 0
    if total < max_coeff:
        zeros = _read_vlc(r, _DC_ZEROS[total - 1] if nc < 0
                          else _ZEROS[total - 1])
    if zeros + total > max_coeff:
        raise _Bad(-1)
    pos = total + zeros - 1
    for i in range(total):
        run = 0
        if i < total - 1 and zeros > 0:
            run = _read_vlc(r, _RUN[min(zeros, 7) - 1])
            if run > zeros:
                raise _Bad(-1)
            zeros -= run
        coef[start + pos] = level[i]
        pos -= run + 1
    return total


# ---------------------------------------------------------------- transform

def _clip1(v: int) -> int:
    return 0 if v < 0 else 255 if v > 255 else v


def add_block(plane: np.ndarray, y0: int, x0: int, lv: Sequence[int],
              qp: int, dc: Optional[int] = None) -> None:
    """Dequantise and inverse-transform a 4x4 block of levels (raster; its
    DC given already scaled where ``dc`` is not None) and add it to the
    plane at (y0, x0)."""
    q6, q = divmod(qp, 6)
    d = [((lv[i] * NORM[q][NORM_CLASS[i]]) << q6) if lv[i] else 0
         for i in range(16)]
    if dc is not None:
        d[0] = dc
    if not any(d):
        return
    e = [0] * 16
    for r in range(4):
        x0_, x1, x2, x3 = d[r * 4:r * 4 + 4]
        a0, a1 = x0_ + x2, x0_ - x2
        a2, a3 = (x1 >> 1) - x3, x1 + (x3 >> 1)
        e[r * 4:r * 4 + 4] = [a0 + a3, a1 + a2, a1 - a2, a0 - a3]
    for c in range(4):
        a0, a1 = e[c] + e[8 + c], e[c] - e[8 + c]
        a2, a3 = (e[4 + c] >> 1) - e[12 + c], e[4 + c] + (e[12 + c] >> 1)
        for k, v in enumerate((a0 + a3, a1 + a2, a1 - a2, a0 - a3)):
            plane[y0 + k, x0 + c] = _clip1(int(plane[y0 + k, x0 + c]) +
                                           ((v + 32) >> 6))


def luma_dc(c: Sequence[int], qp: int) -> List[int]:
    """Intra16x16 DC levels (raster of blocks) -> each block's DC."""
    f = [0] * 16
    for r in range(4):
        x0, x1, x2, x3 = c[r * 4:r * 4 + 4]
        f[r * 4:r * 4 + 4] = [x0 + x1 + x2 + x3, x0 + x1 - x2 - x3,
                              x0 - x1 - x2 + x3, x0 - x1 + x2 - x3]
    g = [0] * 16
    for k in range(4):
        x0, x1, x2, x3 = f[k], f[4 + k], f[8 + k], f[12 + k]
        g[k], g[4 + k] = x0 + x1 + x2 + x3, x0 + x1 - x2 - x3
        g[8 + k], g[12 + k] = x0 - x1 - x2 + x3, x0 - x1 + x2 - x3
    scale, q6 = 16 * NORM[qp % 6][0], qp // 6
    if qp >= 36:
        return [(v * scale) << (q6 - 6) for v in g]
    return [(v * scale + (1 << (5 - q6))) >> (6 - q6) for v in g]


def chroma_dc(c: Sequence[int], qpc: int) -> List[int]:
    f = (c[0] + c[1] + c[2] + c[3], c[0] - c[1] + c[2] - c[3],
         c[0] + c[1] - c[2] - c[3], c[0] - c[1] - c[2] + c[3])
    scale, q6 = 16 * NORM[qpc % 6][0], qpc // 6
    return [((v * scale) << q6) >> 5 for v in f]


# ---------------------------------------------------------------- intra

def pred4x4(top: List[int], left: List[int], mode: int, has_top: bool,
            has_left: bool) -> List[List[int]]:
    """A 4x4 intra prediction: ``top`` p[-1..7, -1] (top[0] the corner),
    ``left`` p[-1, 0..3]."""
    T = lambda x: top[x + 1]
    L = lambda y: top[0] if y < 0 else left[y]
    out = [[0] * 4 for _ in range(4)]
    for y in range(4):
        for x in range(4):
            if mode == 0:
                v = T(x)
            elif mode == 1:
                v = L(y)
            elif mode == 2:
                st, sl = sum(top[1:5]), sum(left[:4])
                v = (st + sl + 4) >> 3 if has_top and has_left else \
                    (sl + 2) >> 2 if has_left else \
                    (st + 2) >> 2 if has_top else 128
            elif mode == 3:
                v = (T(6) + 3 * T(7) + 2) >> 2 if x == 3 and y == 3 else \
                    (T(x + y) + 2 * T(x + y + 1) + T(x + y + 2) + 2) >> 2
            elif mode == 4:
                if x > y:
                    v = (T(x - y - 2) + 2 * T(x - y - 1) + T(x - y) + 2) >> 2
                elif x < y:
                    v = (L(y - x - 2) + 2 * L(y - x - 1) + L(y - x) + 2) >> 2
                else:
                    v = (T(0) + 2 * T(-1) + L(0) + 2) >> 2
            elif mode == 5:
                z = 2 * x - y
                if z >= 0 and not z & 1:
                    v = (T(x - (y >> 1) - 1) + T(x - (y >> 1)) + 1) >> 1
                elif z > 0:
                    v = (T(x - (y >> 1) - 2) + 2 * T(x - (y >> 1) - 1) +
                         T(x - (y >> 1)) + 2) >> 2
                elif z == -1:
                    v = (L(0) + 2 * T(-1) + T(0) + 2) >> 2
                else:
                    v = (L(y - 1) + 2 * L(y - 2) + L(y - 3) + 2) >> 2
            elif mode == 6:
                z = 2 * y - x
                if z >= 0 and not z & 1:
                    v = (L(y - (x >> 1) - 1) + L(y - (x >> 1)) + 1) >> 1
                elif z > 0:
                    v = (L(y - (x >> 1) - 2) + 2 * L(y - (x >> 1) - 1) +
                         L(y - (x >> 1)) + 2) >> 2
                elif z == -1:
                    v = (L(0) + 2 * T(-1) + T(0) + 2) >> 2
                else:
                    v = (T(x - 1) + 2 * T(x - 2) + T(x - 3) + 2) >> 2
            elif mode == 7:
                k = x + (y >> 1)
                v = (T(k) + T(k + 1) + 1) >> 1 if not y & 1 else \
                    (T(k) + 2 * T(k + 1) + T(k + 2) + 2) >> 2
            else:
                z = x + 2 * y
                k = y + (x >> 1)
                if z < 5 and not z & 1:
                    v = (L(k) + L(k + 1) + 1) >> 1
                elif z < 5:
                    v = (L(k) + 2 * L(k + 1) + L(k + 2) + 2) >> 2
                elif z == 5:
                    v = (L(2) + 3 * L(3) + 2) >> 2
                else:
                    v = L(3)
            out[y][x] = v
    return out


def pred_plane(top: List[int], left: List[int], n: int) -> np.ndarray:
    """The plane prediction of an n x n block (16 luma, 8 chroma)."""
    T = lambda x: top[x + 1]
    L = lambda y: top[0] if y < 0 else left[y]
    half = n // 2
    H = sum((k + 1) * (T(half + k) - T(half - 2 - k)) for k in range(half))
    V = sum((k + 1) * (L(half + k) - L(half - 2 - k)) for k in range(half))
    a = 16 * (L(n - 1) + T(n - 1))
    b = (5 * H + 32) >> 6 if n == 16 else (34 * H + 32) >> 6
    c = (5 * V + 32) >> 6 if n == 16 else (34 * V + 32) >> 6
    yy, xx = np.mgrid[0:n, 0:n]
    return np.clip((a + b * (xx - (half - 1)) + c * (yy - (half - 1)) + 16)
                   >> 5, 0, 255)


# ---------------------------------------------------------------- inter

def mc_luma(ref: np.ndarray, x: int, y: int, w: int, h: int, mvx: int,
            mvy: int) -> np.ndarray:
    """The w x h luma prediction at (x, y) from ``ref`` moved by (mvx, mvy)
    quarter samples, reference coordinates clamped."""
    H, W = ref.shape
    xi, yi, fx, fy = x + (mvx >> 2), y + (mvy >> 2), mvx & 3, mvy & 3
    rows = np.clip(np.arange(yi - 2, yi + h + 3), 0, H - 1)
    cols = np.clip(np.arange(xi - 2, xi + w + 3), 0, W - 1)
    win = ref[rows[:, None], cols[None, :]].astype(np.int64)
    tap = lambda a: (a[0] - 5 * a[1] + 20 * a[2] + 20 * a[3] - 5 * a[4] +
                     a[5])
    G = win[2:2 + h + 1, 2:2 + w + 1]                 # G, and one past
    b1 = tap([win[:, k:k + w] for k in range(6)])     # rows -2..h+2
    h1 = tap([win[k:k + h, :] for k in range(6)])     # cols -2..w+2
    clip = lambda v: np.clip(v, 0, 255)
    B = clip((b1 + 16) >> 5)                          # (h + 5, w)
    Hh = clip((h1 + 16) >> 5)                         # (h, w + 5)
    j1 = tap([b1[k:k + h] for k in range(6)])         # (h, w)
    J = clip((j1 + 512) >> 10)
    g = G[:h, :w]
    b = B[2:2 + h, :w]
    hh = Hh[:h, 2:2 + w]
    j = J[:h, :w]
    avg = lambda p, q: (p + q + 1) >> 1
    case = {
        (0, 0): lambda: g,
        (1, 0): lambda: avg(g, b),
        (2, 0): lambda: b,
        (3, 0): lambda: avg(G[:h, 1:w + 1], b),
        (0, 1): lambda: avg(g, hh),
        (1, 1): lambda: avg(b, hh),
        (2, 1): lambda: avg(b, j),
        (3, 1): lambda: avg(b, Hh[:h, 3:3 + w]),
        (0, 2): lambda: hh,
        (1, 2): lambda: avg(hh, j),
        (2, 2): lambda: j,
        (3, 2): lambda: avg(j, Hh[:h, 3:3 + w]),
        (0, 3): lambda: avg(G[1:h + 1, :w], hh),
        (1, 3): lambda: avg(hh, B[3:3 + h, :w]),
        (2, 3): lambda: avg(j, B[3:3 + h, :w]),
        (3, 3): lambda: avg(Hh[:h, 3:3 + w], B[3:3 + h, :w]),
    }
    return case[(fx, fy)]().astype(np.uint8)


def mc_chroma(ref: np.ndarray, x: int, y: int, w: int, h: int, mvx: int,
              mvy: int) -> np.ndarray:
    H, W = ref.shape
    xi, yi, fx, fy = x + (mvx >> 3), y + (mvy >> 3), mvx & 7, mvy & 7
    rows = np.clip(np.arange(yi, yi + h + 1), 0, H - 1)
    cols = np.clip(np.arange(xi, xi + w + 1), 0, W - 1)
    win = ref[rows[:, None], cols[None, :]].astype(np.int64)
    v = ((8 - fx) * (8 - fy) * win[:h, :w] + fx * (8 - fy) * win[:h, 1:] +
         (8 - fx) * fy * win[1:, :w] + fx * fy * win[1:, 1:] + 32) >> 6
    return v.astype(np.uint8)


# ---------------------------------------------------------------- macroblocks

NONE, INTER, SKIP, I4, I16, PCM = 0, 1, 2, 3, 4, 5


class _Slot:
    """A frame slot: the planes (macroblock-aligned) and what each
    macroblock left for prediction and deblocking."""

    def __init__(self, mbw: int, mbh: int):
        self.mbw, self.mbh = mbw, mbh
        n = mbw * mbh
        self.y = np.zeros((mbh * 16, mbw * 16), np.uint8)
        self.u = np.zeros((mbh * 8, mbw * 8), np.uint8)
        self.v = np.zeros((mbh * 8, mbw * 8), np.uint8)
        self.kind = [NONE] * n
        self.qp = [0] * n
        self.slice = [-1] * n
        self.i4 = [[-1] * 16 for _ in range(n)]
        self.nnz = [[0] * 24 for _ in range(n)]
        self.mv = [[(0, 0)] * 16 for _ in range(n)]
        self.ref = [[-1] * 16 for _ in range(n)]
        self.rpic = [[-1] * 16 for _ in range(n)]


class _Ctx:
    def __init__(self, cur: _Slot, index: int, p: Dict):
        self.cur, self.index, self.p = cur, index, p


def _partitions(ptype: int, subs: Sequence[int]):
    """(x, y, w, h, owner, shape) of an inter MB's (sub-)partitions in
    decoding order (shape 1: 16x8, 2: 8x16)."""
    if ptype == 0:
        return [(0, 0, 16, 16, 0, 0)]
    if ptype == 1:
        return [(0, 0, 16, 8, 0, 1), (0, 8, 16, 8, 1, 1)]
    if ptype == 2:
        return [(0, 0, 8, 16, 0, 2), (8, 0, 8, 16, 1, 2)]
    out = []
    for i in range(4):
        x0, y0 = (i & 1) * 8, (i >> 1) * 8
        s = subs[i]
        if s == 0:
            out.append((x0, y0, 8, 8, i, 0))
        elif s == 1:
            out += [(x0, y0, 8, 4, i, 0), (x0, y0 + 4, 8, 4, i, 0)]
        elif s == 2:
            out += [(x0, y0, 4, 8, i, 0), (x0 + 4, y0, 4, 8, i, 0)]
        else:
            out += [(x0 + (k & 1) * 4, y0 + (k >> 1) * 4, 4, 4, i, 0)
                    for k in range(4)]
    return out


class Decoder:
    """The plain decoder of an H.264 stream: :class:`Stream` for the
    headers and the DPB, the macroblock layer and the deblocking filter
    in Python and NumPy (slow: keep its pictures small).  :meth:`decode`
    takes the stream's samples in order and returns the yuv420p planes
    of the picture a sample holds (cropped as cv2 gives them), or None;
    raises :class:`H264Error` naming the frame, the slice and the
    macroblock where the stream is refused or does not decode."""

    def __init__(self, extradata: bytes = b""):
        self.stream = Stream(extradata)
        self.slots: Dict[int, _Slot] = {}

    def decode(self, sample: bytes) -> Optional[Tuple[np.ndarray, ...]]:
        job = self.stream.next(sample)
        if job is None:
            return None
        sps = job.sps
        slot = self.slots.get(job.pic.slot)
        if slot is None or (slot.mbw, slot.mbh) != (sps.mbw, sps.mbh):
            slot = self.slots[job.pic.slot] = _Slot(sps.mbw, sps.mbh)
        slot.__init__(sps.mbw, sps.mbh)
        params = []
        for i, s in enumerate(job.slices):
            p = dict(zip(("first_mb", "type", "qp", "disable", "off_a",
                          "off_b", "cqp0", "cqp1", "cip", "nref"),
                         job.native_params(s)[:10]))
            p["refs"] = [None if r is None else self.slots[r.slot]
                         for r in s.refs]
            p["ids"] = [-1 if r is None else r.id for r in s.refs]
            params.append(p)
            try:
                self._slice(_Ctx(slot, i, p), s)
            except _Bad as exc:
                raise H264Error(failure(job, exc.code, self._at)) from None
        n = sps.mbw * sps.mbh
        missing = [a for a in range(n) if slot.slice[a] < 0]
        if missing:
            raise H264Error(failure(job, -3, missing[0]))
        self._deblock(slot, params)
        self.stream.release(job.pic.slot)
        self.stream.end_batch()
        top, left = crop_origin(sps)
        h, w = geometry(sps)
        return (slot.y[top:top + h, left:left + w].copy(),
                slot.u[top // 2:(top + h) // 2,
                       left // 2:(left + w) // 2].copy(),
                slot.v[top // 2:(top + h) // 2,
                       left // 2:(left + w) // 2].copy())

    # ------------------------------------------------------------ slices
    def _slice(self, s: _Ctx, sl: Slice) -> None:
        c, p = s.cur, s.p
        r = Bits(sl.rbsp, sl.header.data_bit, sl.end_bit)
        n = c.mbw * c.mbh
        mb, qp = p["first_mb"], p["qp"]
        self._at = mb
        if mb >= n:
            raise _Bad(-7)

        def begin(a: int) -> Tuple[int, int, int]:
            if a >= n:
                raise _Bad(-7)
            if c.slice[a] >= 0:
                raise _Bad(-6)
            c.slice[a] = s.index
            self._at = a
            return a, a % c.mbw, a // c.mbw
        more = True
        while more:
            if p["type"] == 0:
                run = r.ue()
                if r.pos > r.end:
                    raise _Bad(-2)
                for _ in range(run):
                    m = begin(mb)
                    mb += 1
                    c.nnz[m[0]] = [0] * 24
                    self._reconstruct(s, m, {"kind": SKIP, "qp": qp})
                if run:
                    more = r.more()
            if more:
                m = begin(mb)
                mb += 1
                d, qp = self._parse(r, s, m, qp)
                if r.pos > r.end:
                    raise _Bad(-2)
                self._reconstruct(s, m, d)
                more = r.more()

    # ------------------------------------------------------------ neighbours
    @staticmethod
    def _avail(s: _Ctx, mx: int, my: int) -> bool:
        c = s.cur
        return 0 <= mx < c.mbw and 0 <= my < c.mbh and \
            c.slice[my * c.mbw + mx] == s.index

    def _neighbour(self, s: _Ctx, m, xn: int, yn: int, done: int):
        """(available, refIdx, mv) of the partition covering (xn, yn)."""
        none = (False, -1, (0, 0))
        a, mx, my = m
        if yn > 15:
            return none
        if xn < 0:
            mx -= 1
            if yn < 0:
                my -= 1
        elif xn <= 15:
            if yn < 0:
                my -= 1
        else:
            if yn >= 0:
                return none
            mx += 1
            my -= 1
        bx, by = ((xn + 16) & 15) >> 2, ((yn + 16) & 15) >> 2
        c = s.cur
        if (mx, my) == (m[1], m[2]):
            if not done >> (by * 4 + bx) & 1:
                return none
        elif not self._avail(s, mx, my):
            return none
        na = my * c.mbw + mx
        ref = c.ref[na][by * 4 + bx]
        return True, ref, c.mv[na][by * 4 + bx] if ref >= 0 else (0, 0)

    def _mvp(self, s: _Ctx, m, x: int, y: int, w: int, shape: int,
             ref: int, done: int) -> Tuple[int, int]:
        A = self._neighbour(s, m, x - 1, y, done)
        B = self._neighbour(s, m, x, y - 1, done)
        C = self._neighbour(s, m, x + w, y - 1, done)
        if not C[0]:
            C = self._neighbour(s, m, x - 1, y - 1, done)
        if shape == 1:
            if y == 0 and B[1] == ref:
                return B[2]
            if y != 0 and A[1] == ref:
                return A[2]
        elif shape == 2:
            if x == 0 and A[1] == ref:
                return A[2]
            if x != 0 and C[1] == ref:
                return C[2]
        if not B[0] and not C[0] and A[0]:
            B = C = A
        match = [n for n in (A, B, C) if n[1] == ref]
        if len(match) == 1:
            return match[0][2]
        med = lambda a, b, c: max(min(a, b), min(max(a, b), c))
        return (med(A[2][0], B[2][0], C[2][0]),
                med(A[2][1], B[2][1], C[2][1]))

    def _skip_mv(self, s: _Ctx, m) -> Tuple[int, int]:
        A = self._neighbour(s, m, -1, 0, 0)
        B = self._neighbour(s, m, 0, -1, 0)
        if not A[0] or not B[0]:
            return 0, 0
        if A[1] == 0 and A[2] == (0, 0) or B[1] == 0 and B[2] == (0, 0):
            return 0, 0
        return self._mvp(s, m, 0, 0, 16, 0, 0, 0)

    def _tc(self, s: _Ctx, m, comp: int, bx: int, by: int) -> int:
        n = 2 if comp else 4
        _, mx, my = m
        if bx < 0:
            mx, bx = mx - 1, bx + n
        if by < 0:
            my, by = my - 1, by + n
        c = s.cur
        if (mx, my) != (m[1], m[2]) and not self._avail(s, mx, my):
            return -1
        nnz = c.nnz[my * c.mbw + mx]
        return nnz[16 + (comp - 1) * 4 + by * 2 + bx] if comp else \
            nnz[by * 4 + bx]

    def _nc(self, s: _Ctx, m, comp: int, bx: int, by: int) -> int:
        na = self._tc(s, m, comp, bx - 1, by)
        nb = self._tc(s, m, comp, bx, by - 1)
        if na >= 0 and nb >= 0:
            return (na + nb + 1) >> 1
        return na if na >= 0 else nb if nb >= 0 else 0

    # ------------------------------------------------------------ parsing
    def _parse(self, r: Bits, s: _Ctx, m, qp: int):
        c, p = s.cur, s.p
        t = r.ue()
        d = {"kind": NONE, "cbp": 0}
        if p["type"] == 0:
            if t < 5:
                d["kind"], d["ptype"] = INTER, t
            else:
                t -= 5
        if d["kind"] != INTER:
            if t > 25:
                raise _Bad(-1)
            if t == 25:
                r.pos = (r.pos + 7) & ~7
                d["kind"] = PCM
                d["pcm"] = [r.u(8) for _ in range(384)]
                d["qp"] = qp
                return d, qp
            if t == 0:
                d["kind"] = I4
            else:
                d["kind"] = I16
                d["i16"] = (t - 1) % 4
                d["cbp"] = (((t - 1) // 4) % 3) << 4 | (15 if t >= 13 else 0)
        nref = p["nref"]
        if d["kind"] == I4:
            modes = []
            for _ in range(16):
                modes.append(-1 if r.bit() else r.u(3))
            d["rem"] = modes
        if d["kind"] in (I4, I16):
            d["cmode"] = r.ue()
            if d["cmode"] > 3:
                raise _Bad(-1)
        else:
            te = lambda: (1 - r.bit()) if nref == 2 else r.ue()
            if d["ptype"] >= 3:
                d["sub"] = [r.ue() for _ in range(4)]
                if max(d["sub"]) > 3:
                    raise _Bad(-1)
                d["ref"] = [te() if nref > 1 and d["ptype"] == 3 else 0
                            for _ in range(4)]
            else:
                d["sub"] = [0] * 4
                d["ref"] = [te() if nref > 1 else 0
                            for _ in range(1 if d["ptype"] == 0 else 2)]
            if max(d["ref"]) >= nref:
                raise _Bad(-1)
            parts = _partitions(d["ptype"], d["sub"])
            d["mvd"] = [(r.se(), r.se()) for _ in parts]
        if d["kind"] != I16:
            code = r.ue()
            if code > 47:
                raise _Bad(-1)
            d["cbp"] = CBP_INTRA[code] if d["kind"] == I4 else \
                CBP_INTER[code]
        if d["cbp"] or d["kind"] == I16:
            delta = r.se()
            if not -26 <= delta <= 25:
                raise _Bad(-1)
            qp = (qp + delta + 52) % 52
        d["qp"] = qp
        a = m[0]
        c.nnz[a] = [0] * 24
        if d["cbp"] or d["kind"] == I16:
            self._residual(r, s, m, d)
        if d["kind"] == I4:
            c.kind[a] = I4
            d["i4"] = [0] * 16
            for blk in range(16):
                pred = self._i4_pred(s, m, blk)
                rem = d["rem"][blk]
                mode = pred if rem < 0 else rem if rem < pred else rem + 1
                d["i4"][blk] = mode
                c.i4[a][BLK_Y[blk] * 4 + BLK_X[blk]] = mode
        return d, qp

    def _residual(self, r: Bits, s: _Ctx, m, d: Dict) -> None:
        nnz = s.cur.nnz[m[0]]
        i16 = d["kind"] == I16
        d["luma"] = [[0] * 16 for _ in range(16)]
        d["ldc"] = [0] * 16
        if i16:
            scan = [0] * 16
            read_block(r, self._nc(s, m, 0, 0, 0), 0, 16, scan)
            for k in range(16):
                d["ldc"][ZIGZAG[k]] = scan[k]
        for blk in range(16):
            if not d["cbp"] >> (blk >> 2) & 1:
                continue
            bx, by = BLK_X[blk], BLK_Y[blk]
            scan = [0] * 16
            nc = self._nc(s, m, 0, bx, by)
            tc = read_block(r, nc, 1, 15, scan) if i16 else \
                read_block(r, nc, 0, 16, scan)
            for k in range(1 if i16 else 0, 16):
                d["luma"][blk][ZIGZAG[k]] = scan[k]
            nnz[by * 4 + bx] = tc
        cc = d["cbp"] >> 4
        d["cdc"] = [[0] * 4, [0] * 4]
        d["cac"] = [[[0] * 16 for _ in range(4)] for _ in range(2)]
        for k in range(2):
            if cc & 3:
                read_block(r, -1, 0, 4, d["cdc"][k])
        for k in range(2):
            for blk in range(4):
                if not cc & 2:
                    continue
                scan = [0] * 16
                tc = read_block(r, self._nc(s, m, k + 1, blk & 1, blk >> 1),
                                1, 15, scan)
                for j in range(1, 16):
                    d["cac"][k][blk][ZIGZAG[j]] = scan[j]
                nnz[16 + k * 4 + blk] = tc

    def _i4_pred(self, s: _Ctx, m, blk: int) -> int:
        c = s.cur
        dc = False

        def mode_of(x: int, y: int) -> int:
            nonlocal dc
            _, mx, my = m
            if x < 0:
                mx, x = mx - 1, x + 4
            if y < 0:
                my, y = my - 1, y + 4
            if (mx, my) != (m[1], m[2]):
                if not self._avail(s, mx, my):
                    dc = True
                    return 2
                k = c.kind[my * c.mbw + mx]
                if k < I4 and s.p["cip"]:
                    dc = True
                    return 2
                if k != I4:
                    return 2
            return c.i4[my * c.mbw + mx][y * 4 + x]
        bx, by = BLK_X[blk], BLK_Y[blk]
        a, b = mode_of(bx - 1, by), mode_of(bx, by - 1)
        return 2 if dc else min(a, b)

    # ------------------------------------------------------------ rebuild
    def _intra_avail(self, s: _Ctx, mx: int, my: int) -> bool:
        if not self._avail(s, mx, my):
            return False
        return not s.p["cip"] or s.cur.kind[my * s.cur.mbw + mx] >= I4

    @staticmethod
    def _edge(plane: np.ndarray, py: int, px: int, n: int, top: bool,
              left: bool, corner: bool, tr: bool, tr_n: int):
        t = [0] * (1 + n + tr_n)
        t[0] = int(plane[py - 1, px - 1]) if corner else 0
        if top:
            row = plane[py - 1]
            for x in range(n):
                t[1 + x] = int(row[px + x])
            for x in range(n, n + tr_n):
                t[1 + x] = int(row[px + x]) if tr else t[n]
        lft = [int(plane[py + y, px - 1]) if left else 0 for y in range(n)]
        return t, lft

    def _reconstruct(self, s: _Ctx, m, d: Dict) -> None:
        c, p = s.cur, s.p
        a, mx, my = m
        kind = d["kind"]
        c.kind[a] = kind
        c.i4[a] = [-1] * 16
        Y0, X0 = my * 16, mx * 16
        if kind == PCM:
            pcm = np.array(d["pcm"], np.uint8)
            c.y[Y0:Y0 + 16, X0:X0 + 16] = pcm[:256].reshape(16, 16)
            c.u[my * 8:my * 8 + 8, mx * 8:mx * 8 + 8] = \
                pcm[256:320].reshape(8, 8)
            c.v[my * 8:my * 8 + 8, mx * 8:mx * 8 + 8] = \
                pcm[320:].reshape(8, 8)
            c.ref[a], c.mv[a] = [-1] * 16, [(0, 0)] * 16
            c.nnz[a] = [16] * 24
            c.qp[a] = 0
            return
        c.qp[a] = d["qp"]
        intra = kind in (I4, I16)
        if intra:
            c.ref[a], c.mv[a], c.rpic[a] = [-1] * 16, [(0, 0)] * 16, \
                [-1] * 16
        tA, tB = self._intra_avail(s, mx - 1, my), \
            self._intra_avail(s, mx, my - 1)
        tC, tD = self._intra_avail(s, mx + 1, my - 1), \
            self._intra_avail(s, mx - 1, my - 1)
        qp = d["qp"]
        qpc = [CHROMA_QP[min(max(qp + p["cqp%d" % k], 0), 51)]
               for k in range(2)]
        if kind == I4:
            for blk in range(16):
                bx, by = BLK_X[blk], BLK_Y[blk]
                top = True if by else tB
                left = True if bx else tA
                corner = True if bx and by else tD if not bx and not by \
                    else tB if bx else tA
                if by == 0:
                    tr = tB if bx < 3 else tC
                elif bx == 3:
                    tr = False
                else:
                    nb = (bx + 1) + (by - 1) * 4
                    idx = next(k for k in range(16)
                               if BLK_X[k] + BLK_Y[k] * 4 == nb)
                    tr = idx < blk
                t, lft = self._edge(c.y, Y0 + by * 4, X0 + bx * 4, 4, top,
                                    left, corner, tr, 4)
                pr = pred4x4(t, lft, d["i4"][blk], top, left)
                c.y[Y0 + by * 4:Y0 + by * 4 + 4, X0 + bx * 4:X0 + bx * 4 + 4] \
                    = np.array(pr, np.uint8)
                c.i4[a][by * 4 + bx] = d["i4"][blk]
                if d["cbp"]:
                    add_block(c.y, Y0 + by * 4, X0 + bx * 4, d["luma"][blk],
                              qp)
        elif kind == I16:
            t, lft = self._edge(c.y, Y0, X0, 16, tB, tA, tD, False, 0)
            mode = d["i16"]
            if mode == 0:
                pr = np.tile(np.array(t[1:17]), (16, 1))
            elif mode == 1:
                pr = np.tile(np.array(lft)[:, None], (1, 16))
            elif mode == 2:
                st, sl = sum(t[1:17]), sum(lft)
                v = (st + sl + 16) >> 5 if tB and tA else (sl + 8) >> 4 \
                    if tA else (st + 8) >> 4 if tB else 128
                pr = np.full((16, 16), v)
            else:
                pr = pred_plane(t, lft, 16)
            c.y[Y0:Y0 + 16, X0:X0 + 16] = pr.astype(np.uint8)
            dcs = luma_dc(d["ldc"], qp)
            for blk in range(16):
                bx, by = BLK_X[blk], BLK_Y[blk]
                add_block(c.y, Y0 + by * 4, X0 + bx * 4, d["luma"][blk], qp,
                          dcs[by * 4 + bx])
        else:
            ref, mv = [0] * 16, [(0, 0)] * 16
            if kind == SKIP:
                v = self._skip_mv(s, m)
                mv = [v] * 16
                parts = [(0, 0, 16, 16, 0, 0)]
            else:
                parts = _partitions(d["ptype"], d["sub"])
                done = 0
                c.ref[a], c.mv[a] = ref, mv    # the MB's own, as they come
                for k, (x, y, w, h, owner, shape) in enumerate(parts):
                    rf = d["ref"][owner]
                    px, py = self._mvp(s, m, x, y, w, shape, rf, done)
                    v = (px + d["mvd"][k][0], py + d["mvd"][k][1])
                    for yy in range(y // 4, (y + h) // 4):
                        for xx in range(x // 4, (x + w) // 4):
                            ref[yy * 4 + xx] = rf
                            mv[yy * 4 + xx] = v
                            done |= 1 << (yy * 4 + xx)
            c.ref[a], c.mv[a] = ref, mv
            for k in range(16):
                if ref[k] >= p["nref"] or p["refs"][ref[k]] is None:
                    raise _Bad(-5)
            c.rpic[a] = [p["ids"][ref[k]] for k in range(16)]
            for x, y, w, h, _, _ in parts:
                k = (y // 4) * 4 + x // 4
                rs = p["refs"][ref[k]]
                vx, vy = mv[k]
                c.y[Y0 + y:Y0 + y + h, X0 + x:X0 + x + w] = mc_luma(
                    rs.y, X0 + x, Y0 + y, w, h, vx, vy)
                cy, cx = my * 8 + y // 2, mx * 8 + x // 2
                c.u[cy:cy + h // 2, cx:cx + w // 2] = mc_chroma(
                    rs.u, cx, cy, w // 2, h // 2, vx, vy)
                c.v[cy:cy + h // 2, cx:cx + w // 2] = mc_chroma(
                    rs.v, cx, cy, w // 2, h // 2, vx, vy)
            if kind == SKIP:
                return
            if d["cbp"] & 15:
                for blk in range(16):
                    add_block(c.y, Y0 + BLK_Y[blk] * 4, X0 + BLK_X[blk] * 4,
                              d["luma"][blk], qp)
        if intra:
            for k, plane in enumerate((c.u, c.v)):
                t, lft = self._edge(plane, my * 8, mx * 8, 8, tB, tA, tD,
                                    False, 0)
                cm = d["cmode"]
                if cm == 0:
                    pr = np.zeros((8, 8), np.int64)
                    for by in range(2):
                        for bx in range(2):
                            st = sum(t[1 + bx * 4:5 + bx * 4])
                            sl = sum(lft[by * 4:by * 4 + 4])
                            v = 128
                            if bx == by:
                                v = (st + sl + 4) >> 3 if tB and tA else \
                                    (sl + 2) >> 2 if tA else \
                                    (st + 2) >> 2 if tB else 128
                            elif bx == 1:
                                v = (st + 2) >> 2 if tB else \
                                    (sl + 2) >> 2 if tA else 128
                            else:
                                v = (sl + 2) >> 2 if tA else \
                                    (st + 2) >> 2 if tB else 128
                            pr[by * 4:by * 4 + 4, bx * 4:bx * 4 + 4] = v
                elif cm == 1:
                    pr = np.tile(np.array(lft)[:, None], (1, 8))
                elif cm == 2:
                    pr = np.tile(np.array(t[1:9]), (8, 1))
                else:
                    pr = pred_plane(t, lft, 8)
                plane[my * 8:my * 8 + 8, mx * 8:mx * 8 + 8] = \
                    pr.astype(np.uint8)
        if d["cbp"] >> 4:
            for k, plane in enumerate((c.u, c.v)):
                dcs = chroma_dc(d["cdc"][k], qpc[k])
                for blk in range(4):
                    add_block(plane, my * 8 + (blk >> 1) * 4,
                              mx * 8 + (blk & 1) * 4, d["cac"][k][blk],
                              qpc[k], dcs[blk])

    # ------------------------------------------------------------ deblocking
    @staticmethod
    def _bs(c: _Slot, pa: int, pb: int, qa: int, qb: int,
            mb_edge: bool) -> int:
        if c.kind[pa] >= I4 or c.kind[qa] >= I4:
            return 4 if mb_edge else 3
        if c.nnz[pa][pb] or c.nnz[qa][qb]:
            return 2
        if c.rpic[pa][pb] != c.rpic[qa][qb]:
            return 1
        (ax, ay), (bx, by) = c.mv[pa][pb], c.mv[qa][qb]
        return int(abs(ax - bx) >= 4 or abs(ay - by) >= 4)

    def _deblock(self, c: _Slot, params: List[Dict]) -> None:
        for my in range(c.mbh):
            for mx in range(c.mbw):
                self._deblock_mb(c, params, mx, my)

    def _deblock_mb(self, c: _Slot, params, mx: int, my: int) -> None:
        a = my * c.mbw + mx
        p = params[c.slice[a]]
        if p["disable"] == 1:
            return
        left = mx > 0 and not (p["disable"] == 2 and
                               c.slice[a - 1] != c.slice[a])
        top = my > 0 and not (p["disable"] == 2 and
                              c.slice[a - c.mbw] != c.slice[a])
        for vert in (True, False):
            for e in range(4):
                if e == 0 and not (left if vert else top):
                    continue
                pa = a if e else (a - 1 if vert else a - c.mbw)
                bs = []
                for k in range(4):
                    qb = k * 4 + e if vert else e * 4 + k
                    pb = k * 4 + (e + 3) % 4 if vert else ((e + 3) % 4) * 4 + k
                    bs.append(self._bs(c, pa, pb, a, qb, e == 0))
                if not any(bs):
                    continue
                qpp, qpq = c.qp[pa], c.qp[a]
                self._filter(c.y, vert, my * 16, mx * 16, e * 4, bs,
                             (qpp + qpq + 1) >> 1, p, False, 4)
                if e & 1:
                    continue
                for k, plane in enumerate((c.u, c.v)):
                    off = p["cqp%d" % k]
                    cp = CHROMA_QP[min(max(qpp + off, 0), 51)]
                    cq = CHROMA_QP[min(max(qpq + off, 0), 51)]
                    self._filter(plane, vert, my * 8, mx * 8, e * 2, bs,
                                 (cp + cq + 1) >> 1, p, True, 2)

    @staticmethod
    def _filter(plane: np.ndarray, vert: bool, y0: int, x0: int, at: int,
                bs: List[int], qav: int, p: Dict, chroma: bool,
                per: int) -> None:
        ia = min(max(qav + p["off_a"], 0), 51)
        ib = min(max(qav + p["off_b"], 0), 51)
        alpha, beta = ALPHA[ia], BETA[ib]
        for k in range(4):
            if not bs[k]:
                continue
            tc0 = TC0[ia][bs[k] - 1] if bs[k] < 4 else 0
            for i in range(per):
                idx = (y0 + k * per + i, x0 + at) if vert else \
                    (y0 + at, x0 + k * per + i)
                _filter_line(plane, idx, vert, bs[k], alpha, beta, tc0,
                             chroma)


def _filter_line(plane: np.ndarray, q0: Tuple[int, int], vert: bool, bs: int,
                 alpha: int, beta: int, tc0: int, chroma: bool) -> None:
    y, x = q0

    def at(k: int) -> Tuple[int, int]:   # k < 0: p side
        return (y, x + k) if vert else (y + k, x)
    P = [int(plane[at(-1 - i)]) for i in range(3 if not chroma else 2)]
    Q = [int(plane[at(i)]) for i in range(3 if not chroma else 2)]
    p0, p1, q0v, q1 = P[0], P[1], Q[0], Q[1]
    if not (abs(p0 - q0v) < alpha and abs(p1 - p0) < beta and
            abs(q1 - q0v) < beta):
        return
    if chroma:
        if bs < 4:
            tc = tc0 + 1
            delta = min(max((((q0v - p0) * 4) + (p1 - q1) + 4) >> 3, -tc), tc)
            plane[at(-1)] = _clip1(p0 + delta)
            plane[at(0)] = _clip1(q0v - delta)
        else:
            plane[at(-1)] = (2 * p1 + p0 + q1 + 2) >> 2
            plane[at(0)] = (2 * q1 + q0v + p1 + 2) >> 2
        return
    p2, q2 = P[2], Q[2]
    ap, aq = abs(p2 - p0), abs(q2 - q0v)
    if bs < 4:
        tc = tc0 + (ap < beta) + (aq < beta)
        delta = min(max((((q0v - p0) * 4) + (p1 - q1) + 4) >> 3, -tc), tc)
        plane[at(-1)] = _clip1(p0 + delta)
        plane[at(0)] = _clip1(q0v - delta)
        if ap < beta:
            plane[at(-2)] = p1 + min(max(
                (p2 + ((p0 + q0v + 1) >> 1) - 2 * p1) >> 1, -tc0), tc0)
        if aq < beta:
            plane[at(1)] = q1 + min(max(
                (q2 + ((p0 + q0v + 1) >> 1) - 2 * q1) >> 1, -tc0), tc0)
        return
    p3, q3 = int(plane[at(-4)]), int(plane[at(3)])
    strong = abs(p0 - q0v) < ((alpha >> 2) + 2)
    if ap < beta and strong:
        plane[at(-1)] = (p2 + 2 * p1 + 2 * p0 + 2 * q0v + q1 + 4) >> 3
        plane[at(-2)] = (p2 + p1 + p0 + q0v + 2) >> 2
        plane[at(-3)] = (2 * p3 + 3 * p2 + p1 + p0 + q0v + 4) >> 3
    else:
        plane[at(-1)] = (2 * p1 + p0 + q1 + 2) >> 2
    if aq < beta and strong:
        plane[at(0)] = (p1 + 2 * p0 + 2 * q0v + 2 * q1 + q2 + 4) >> 3
        plane[at(1)] = (p0 + q0v + q1 + q2 + 2) >> 2
        plane[at(2)] = (2 * q3 + 3 * q2 + q1 + q0v + p0 + 4) >> 3
    else:
        plane[at(0)] = (2 * q1 + q0v + p1 + 2) >> 2


def decode_planes(samples: Sequence[bytes], extradata: bytes = b""
                  ) -> List[Tuple[np.ndarray, ...]]:
    """The yuv420p planes (cropped) of every picture of a stream's
    samples, plain."""
    dec = Decoder(extradata)
    out = []
    for sample in samples:
        planes = dec.decode(bytes(sample))
        if planes is not None:
            out.append(planes)
    return out


def i420_bytes(planes: Tuple[np.ndarray, ...]) -> bytes:
    return b"".join(np.ascontiguousarray(p).tobytes() for p in planes)


def decode_bgr(samples: Sequence[bytes], extradata: bytes = b"",
               container: Optional[str] = None) -> List[np.ndarray]:
    """The BGR frames cv2 gives for a stream's samples, plain: the planes
    of :func:`decode_planes` through the rawvideo reader's plain
    ``i420_left`` conversion, by :func:`matrix_name`."""
    from .rawvideo_plain import decode_bgr as raw_bgr
    dec = Decoder(extradata)
    out = []
    for sample in samples:
        planes = dec.decode(bytes(sample))
        if planes is not None:
            h, w = planes[0].shape
            out.append(raw_bgr(i420_bytes(planes), "i420_left", h, w,
                               matrix=matrix_name(dec.stream.sps,
                                                  container)))
    return out
