"""Plain version of the port's H.264 decoder (``h264.cpp``), and the
stream layer both share: the frames ``cv2.VideoCapture`` gives for an
H.264 stream of I and P slices of the Constrained Baseline, Main and High
profiles, pure Python and NumPy.

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
* SPS: 8-bit 4:2:0, scaling lists (kept in zigzag order, with the
  default lists of ``UseDefaultScalingMatrixFlag`` and fall-back rule A),
  ``pic_order_cnt_type`` 0, 1 and 2, up to 16
  reference frames, ``frame_mbs_only_flag`` 1, frame cropping (a left
  crop in multiples of 64 luma samples: FFmpeg keeps a smaller one only
  to the multiple of 64 below it, so that the frame's data pointers stay
  aligned, and cv2 scales that wider frame to the cropped width), the
  VUI (its ``video_full_range_flag`` and colour description choose the
  conversion; HRD parameters and ``bitstream_restriction`` are read
  past).
* PPS: CAVLC or CABAC, one slice group, explicit weighted prediction
  (``weighted_bipred_idc`` is read; a B slice is refused), the 8x8
  transform, scaling lists (they replace the SPS's; fall-back rule B where
  the SPS has lists), any ``chroma_qp_index_offset`` and
  ``second_chroma_qp_index_offset`` (Cr's, in the deblocking too),
  ``deblocking_filter_control_present_flag``,
  ``constrained_intra_pred_flag``, ``redundant_pic_cnt_present_flag``
  (the count must be 0).  As FFmpeg, a PPS of a Baseline, Main or
  Extended SPS with constraint flags 0-2 set has no fields after
  ``redundant_pic_cnt_present_flag``.
* Slices: I and P, any number in a picture (in increasing order of their
  first macroblock), ``num_ref_idx_active_override``, reference list
  modification (a picture twice in a list too), ``pred_weight_table``,
  ``dec_ref_pic_marking`` (the sliding window and every memory management
  operation, long-term references and MMCO 5 among them),
  ``cabac_init_idc``, ``slice_qp_delta``, ``disable_deblocking_filter_idc``
  0-2 and the filter offsets.
* Macroblocks (:class:`Decoder`): I_PCM (inside a CABAC slice too),
  Intra4x4, Intra8x8 (its reference samples filtered), Intra16x16, the
  inter partitions and P_Skip, CAVLC and CABAC residuals (the arithmetic
  decoding engine, every binarization and context an I or P slice
  reaches), quarter-sample luma and eighth-sample chroma interpolation
  with clamped reference coordinates, explicit weights, the 4x4 and 8x8
  inverse transforms with the scaling matrices' LevelScale, and the
  deblocking filter (no 4-sample luma edges inside an 8x8 transform).
* Output: each picture as soon as it is decoded, the order FFmpeg gives
  for streams whose POCs increase in decode order between IDR pictures
  (and MMCO 5); one picture a sample (an AVI chunk, an MP4 sample, a
  Matroska frame).

What it refuses (:func:`unsupported` and :class:`H264Error`, naming the
tool): B, SP and SI slices (and ``weighted_bipred_idc`` with them),
interlaced coding (PAFF/MBAFF), bit depths over 8, chroma formats other
than 4:2:0 (monochrome among them), ``qpprime_y_zero_transform_bypass``,
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
           "ZEROS_CODE", "DC_ZEROS_LEN", "DC_ZEROS_CODE", "RUN_LEN", "RUN_CODE",
           "CABAC_INIT", "Cabac", "ZIGZAG8", "DEFAULT_4X4", "DEFAULT_8X8",
           "scaling_matrices", "level_scales", "pred8x8", "add_block8"]


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

# the context variables' (m, n) of ctxIdx 0-459, flat: [0] I slices,
# [1 + cabac_init_idc] P slices
CABAC_INIT = (
    (20, -15, 2, 54, 3, 74, 20, -15, 2, 54, 3, 74, -28, 127, -23, 104,
     -6, 53, -1, 54, 7, 51, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
     0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
     0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
     0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
     0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
     0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
     0, 0, 0, 0, 0, 0, 0, 0, 0, 41, 0, 63, 0, 63, 0, 63,
     -9, 83, 4, 86, 0, 97, -7, 72, 13, 41, 3, 62, 0, 11, 1, 55,
     0, 69, -17, 127, -13, 102, 0, 82, -7, 74, -21, 107, -27, 127, -31, 127,
     -24, 127, -18, 95, -27, 127, -21, 114, -30, 127, -17, 123, -12, 115, -16, 122,
     -11, 115, -12, 63, -2, 68, -15, 84, -13, 104, -3, 70, -8, 93, -10, 90,
     -30, 127, -1, 74, -6, 97, -7, 91, -20, 127, -4, 56, -5, 82, -7, 76,
     -22, 125, -7, 93, -11, 87, -3, 77, -5, 71, -4, 63, -4, 68, -12, 84,
     -7, 62, -7, 65, 8, 61, 5, 56, -2, 66, 1, 64, 0, 61, -2, 78,
     1, 50, 7, 52, 10, 35, 0, 44, 11, 38, 1, 45, 0, 46, 5, 44,
     31, 17, 1, 51, 7, 50, 28, 19, 16, 33, 14, 62, -13, 108, -15, 100,
     -13, 101, -13, 91, -12, 94, -10, 88, -16, 84, -10, 86, -7, 83, -13, 87,
     -19, 94, 1, 70, 0, 72, -5, 74, 18, 59, -8, 102, -15, 100, 0, 95,
     -4, 75, 2, 72, -11, 75, -3, 71, 15, 46, -13, 69, 0, 62, 0, 65,
     21, 37, -15, 72, 9, 57, 16, 54, 0, 62, 12, 72, 24, 0, 15, 9,
     8, 25, 13, 18, 15, 9, 13, 19, 10, 37, 12, 18, 6, 29, 20, 33,
     15, 30, 4, 45, 1, 58, 0, 62, 7, 61, 12, 38, 11, 45, 15, 39,
     11, 42, 13, 44, 16, 45, 12, 41, 10, 49, 30, 34, 18, 42, 10, 55,
     17, 51, 17, 46, 0, 89, 26, -19, 22, -17, 26, -17, 30, -25, 28, -20,
     33, -23, 37, -27, 33, -23, 40, -28, 38, -17, 33, -11, 40, -15, 41, -6,
     38, 1, 41, 17, 30, -6, 27, 3, 26, 22, 37, -16, 35, -4, 38, -8,
     38, -3, 37, 3, 38, 5, 42, 0, 35, 16, 39, 22, 14, 48, 27, 37,
     21, 60, 12, 68, 2, 97, -3, 71, -6, 42, -5, 50, -3, 54, -2, 62,
     0, 58, 1, 63, -2, 72, -1, 74, -9, 91, -5, 67, -5, 27, -3, 39,
     -2, 44, 0, 46, -16, 64, -8, 68, -10, 78, -6, 77, -10, 86, -12, 92,
     -15, 55, -10, 60, -6, 62, -4, 65, -12, 73, -8, 76, -7, 80, -9, 88,
     -17, 110, -11, 97, -20, 84, -11, 79, -6, 73, -4, 74, -13, 86, -13, 96,
     -11, 97, -19, 117, -8, 78, -5, 33, -4, 48, -2, 53, -3, 62, -13, 71,
     -10, 79, -12, 86, -13, 90, -14, 97, 0, 0, -6, 93, -6, 84, -8, 79,
     0, 66, -1, 71, 0, 62, -2, 60, -2, 59, -5, 75, -3, 62, -4, 58,
     -9, 66, -1, 79, 0, 71, 3, 68, 10, 44, -7, 62, 15, 36, 14, 40,
     16, 27, 12, 29, 1, 44, 20, 36, 18, 32, 5, 42, 1, 48, 10, 62,
     17, 46, 9, 64, -12, 104, -11, 97, -16, 96, -7, 88, -8, 85, -7, 85,
     -9, 85, -13, 88, 4, 66, -3, 77, -3, 76, -6, 76, 10, 58, -1, 76,
     -1, 83, -7, 99, -14, 95, 2, 95, 0, 76, -5, 74, 0, 70, -11, 75,
     1, 68, 0, 65, -14, 73, 3, 62, 4, 62, -1, 68, -13, 75, 11, 55,
     5, 64, 12, 70, 15, 6, 6, 19, 7, 16, 12, 14, 18, 13, 13, 11,
     13, 15, 15, 16, 12, 23, 13, 23, 15, 20, 14, 26, 14, 44, 17, 40,
     17, 47, 24, 17, 21, 21, 25, 22, 31, 27, 22, 29, 19, 35, 14, 50,
     10, 57, 7, 63, -2, 77, -4, 82, -3, 94, 9, 69, -12, 109, 36, -35,
     36, -34, 32, -26, 37, -30, 44, -32, 34, -18, 34, -15, 40, -15, 33, -7,
     35, -5, 33, 0, 38, 2, 33, 13, 23, 35, 13, 58, 29, -3, 26, 0,
     22, 30, 31, -7, 35, -15, 34, -3, 34, 3, 36, -1, 34, 5, 32, 11,
     35, 5, 34, 12, 39, 11, 30, 29, 34, 26, 29, 39, 19, 66, 31, 21,
     31, 31, 25, 50, -17, 120, -20, 112, -18, 114, -11, 85, -15, 92, -14, 89,
     -26, 71, -15, 81, -14, 80, 0, 68, -14, 70, -24, 56, -23, 68, -24, 50,
     -11, 74, 23, -13, 26, -13, 40, -15, 49, -14, 44, 3, 45, 6, 44, 34,
     33, 54, 19, 82, -3, 75, -1, 23, 1, 34, 1, 43, 0, 54, -2, 55,
     0, 61, 1, 64, 0, 68, -9, 92, -14, 106, -13, 97, -15, 90, -12, 90,
     -18, 88, -10, 73, -9, 79, -14, 86, -10, 73, -10, 70, -10, 69, -5, 66,
     -9, 64, -5, 58, 2, 59, 21, -10, 24, -11, 28, -8, 28, -1, 29, 3,
     29, 9, 35, 20, 29, 36, 14, 67),
    (20, -15, 2, 54, 3, 74, 20, -15, 2, 54, 3, 74, -28, 127, -23, 104,
     -6, 53, -1, 54, 7, 51, 23, 33, 23, 2, 21, 0, 1, 9, 0, 49,
     -37, 118, 5, 57, -13, 78, -11, 65, 1, 62, 12, 49, -4, 73, 17, 50,
     18, 64, 9, 43, 29, 0, 26, 67, 16, 90, 9, 104, -46, 127, -20, 104,
     1, 67, -13, 78, -11, 65, 1, 62, -6, 86, -17, 95, -6, 61, 9, 45,
     -3, 69, -6, 81, -11, 96, 6, 55, 7, 67, -5, 86, 2, 88, 0, 58,
     -3, 76, -10, 94, 5, 54, 4, 69, -3, 81, 0, 88, -7, 67, -5, 74,
     -4, 74, -5, 80, -7, 72, 1, 58, 0, 41, 0, 63, 0, 63, 0, 63,
     -9, 83, 4, 86, 0, 97, -7, 72, 13, 41, 3, 62, 0, 45, -4, 78,
     -3, 96, -27, 126, -28, 98, -25, 101, -23, 67, -28, 82, -20, 94, -16, 83,
     -22, 110, -21, 91, -18, 102, -13, 93, -29, 127, -7, 92, -5, 89, -7, 96,
     -13, 108, -3, 46, -1, 65, -1, 57, -9, 93, -3, 74, -9, 92, -8, 87,
     -23, 126, 5, 54, 6, 60, 6, 59, 6, 69, -1, 48, 0, 68, -4, 69,
     -8, 88, -2, 85, -6, 78, -1, 75, -7, 77, 2, 54, 5, 50, -3, 68,
     1, 50, 6, 42, -4, 81, 1, 63, -4, 70, 0, 67, 2, 57, -2, 76,
     11, 35, 4, 64, 1, 61, 11, 35, 18, 25, 12, 24, 13, 29, 13, 36,
     -10, 93, -7, 73, -2, 73, 13, 46, 9, 49, -7, 100, 9, 53, 2, 53,
     5, 53, -2, 61, 0, 56, 0, 56, -13, 63, -5, 60, -1, 62, 4, 57,
     -6, 69, 4, 57, 14, 39, 4, 51, 13, 68, 3, 64, 1, 61, 9, 63,
     7, 50, 16, 39, 5, 44, 4, 52, 11, 48, -5, 60, -1, 59, 0, 59,
     22, 33, 5, 44, 14, 43, -1, 78, 0, 60, 9, 69, 11, 28, 2, 40,
     3, 44, 0, 49, 0, 46, 2, 44, 2, 51, 0, 47, 4, 39, 2, 62,
     6, 46, 0, 54, 3, 54, 2, 58, 4, 63, 6, 51, 6, 57, 7, 53,
     6, 52, 6, 55, 11, 45, 14, 36, 8, 53, -1, 82, 7, 55, -3, 78,
     15, 46, 22, 31, -1, 84, 25, 7, 30, -7, 28, 3, 28, 4, 32, 0,
     34, -1, 30, 6, 30, 6, 32, 9, 31, 19, 26, 27, 26, 30, 37, 20,
     28, 34, 17, 70, 1, 67, 5, 59, 9, 67, 16, 30, 18, 32, 18, 35,
     22, 29, 24, 31, 23, 38, 18, 43, 20, 41, 11, 63, 9, 59, 9, 64,
     -1, 94, -2, 89, -9, 108, -6, 76, -2, 44, 0, 45, 0, 52, -3, 64,
     -2, 59, -4, 70, -4, 75, -8, 82, -17, 102, -9, 77, 3, 24, 0, 42,
     0, 48, 0, 55, -6, 59, -7, 71, -12, 83, -11, 87, -30, 119, 1, 58,
     -3, 29, -1, 36, 1, 38, 2, 43, -6, 55, 0, 58, 0, 64, -3, 74,
     -10, 90, 0, 70, -4, 29, 5, 31, 7, 42, 1, 59, -2, 58, -3, 72,
     -3, 81, -11, 97, 0, 58, 8, 5, 10, 14, 14, 18, 13, 27, 2, 40,
     0, 58, -3, 70, -6, 79, -8, 85, 0, 0, -13, 106, -16, 106, -10, 87,
     -21, 114, -18, 110, -14, 98, -22, 110, -21, 106, -18, 103, -21, 107, -23, 108,
     -26, 112, -10, 96, -12, 95, -5, 91, -9, 93, -22, 94, -5, 86, 9, 67,
     -4, 80, -10, 85, -1, 70, 7, 60, 9, 58, 5, 61, 12, 50, 15, 50,
     18, 49, 17, 54, 10, 41, 7, 46, -1, 51, 7, 49, 8, 52, 9, 41,
     6, 47, 2, 55, 13, 41, 10, 44, 6, 50, 5, 53, 13, 49, 4, 63,
     6, 64, -2, 69, -2, 59, 6, 70, 10, 44, 9, 31, 12, 43, 3, 53,
     14, 34, 10, 38, -3, 52, 13, 40, 17, 32, 7, 44, 7, 38, 13, 50,
     10, 57, 26, 43, 14, 11, 11, 14, 9, 11, 18, 11, 21, 9, 23, -2,
     32, -15, 32, -15, 34, -21, 39, -23, 42, -33, 41, -31, 46, -28, 38, -12,
     21, 29, 45, -24, 53, -45, 48, -26, 65, -43, 43, -19, 39, -10, 30, 9,
     18, 26, 20, 27, 0, 57, -14, 82, -5, 75, -19, 97, -35, 125, 27, 0,
     28, 0, 31, -4, 27, 6, 34, 8, 30, 10, 24, 22, 33, 19, 22, 32,
     26, 31, 21, 41, 26, 44, 23, 47, 16, 65, 14, 71, 8, 60, 6, 63,
     17, 65, 21, 24, 23, 20, 26, 23, 27, 32, 28, 23, 28, 24, 23, 40,
     24, 32, 28, 29, 23, 42, 19, 57, 22, 53, 22, 61, 11, 86, 12, 40,
     11, 51, 14, 59, -4, 79, -7, 71, -5, 69, -9, 70, -8, 66, -10, 68,
     -19, 73, -12, 69, -16, 70, -15, 67, -20, 62, -19, 70, -16, 66, -22, 65,
     -20, 63, 9, -2, 26, -9, 33, -9, 39, -7, 41, -2, 45, 3, 49, 9,
     45, 27, 36, 59, -6, 66, -7, 35, -7, 42, -8, 45, -5, 48, -12, 56,
     -6, 60, -5, 62, -8, 66, -8, 76, -5, 85, -6, 81, -10, 77, -7, 81,
     -17, 80, -18, 73, -4, 74, -10, 83, -9, 71, -9, 67, -1, 61, -8, 66,
     -14, 66, 0, 59, 2, 59, 21, -13, 33, -14, 39, -7, 46, -2, 51, 2,
     60, 6, 61, 17, 55, 34, 42, 62),
    (20, -15, 2, 54, 3, 74, 20, -15, 2, 54, 3, 74, -28, 127, -23, 104,
     -6, 53, -1, 54, 7, 51, 22, 25, 34, 0, 16, 0, -2, 9, 4, 41,
     -29, 118, 2, 65, -6, 71, -13, 79, 5, 52, 9, 50, -3, 70, 10, 54,
     26, 34, 19, 22, 40, 0, 57, 2, 41, 36, 26, 69, -45, 127, -15, 101,
     -4, 76, -6, 71, -13, 79, 5, 52, 6, 69, -13, 90, 0, 52, 8, 43,
     -2, 69, -5, 82, -10, 96, 2, 59, 2, 75, -3, 87, -3, 100, 1, 56,
     -3, 74, -6, 85, 0, 59, -3, 81, -7, 86, -5, 95, -1, 66, -1, 77,
     1, 70, -2, 86, -5, 72, 0, 61, 0, 41, 0, 63, 0, 63, 0, 63,
     -9, 83, 4, 86, 0, 97, -7, 72, 13, 41, 3, 62, 13, 15, 7, 51,
     2, 80, -39, 127, -18, 91, -17, 96, -26, 81, -35, 98, -24, 102, -23, 97,
     -27, 119, -24, 99, -21, 110, -18, 102, -36, 127, 0, 80, -5, 89, -7, 94,
     -4, 92, 0, 39, 0, 65, -15, 84, -35, 127, -2, 73, -12, 104, -9, 91,
     -31, 127, 3, 55, 7, 56, 7, 55, 8, 61, -3, 53, 0, 68, -7, 74,
     -9, 88, -13, 103, -13, 91, -9, 89, -14, 92, -8, 76, -12, 87, -23, 110,
     -24, 105, -10, 78, -20, 112, -17, 99, -78, 127, -70, 127, -50, 127, -46, 127,
     -4, 66, -5, 78, -4, 71, -8, 72, 2, 59, -1, 55, -7, 70, -6, 75,
     -8, 89, -34, 119, -3, 75, 32, 20, 30, 22, -44, 127, 0, 54, -5, 61,
     0, 58, -1, 60, -3, 61, -8, 67, -25, 84, -14, 74, -5, 65, 5, 52,
     2, 57, 0, 61, -9, 69, -11, 70, 18, 55, -4, 71, 0, 58, 7, 61,
     9, 41, 18, 25, 9, 32, 5, 43, 9, 47, 0, 44, 0, 51, 2, 46,
     19, 38, -4, 66, 15, 38, 12, 42, 9, 34, 0, 89, 4, 45, 10, 28,
     10, 31, 33, -11, 52, -43, 18, 15, 28, 0, 35, -22, 38, -25, 34, 0,
     39, -18, 32, -12, 102, -94, 0, 0, 56, -15, 33, -4, 29, 10, 37, -5,
     51, -29, 39, -9, 52, -34, 69, -58, 67, -63, 44, -5, 32, 7, 55, -29,
     32, 1, 0, 0, 27, 36, 33, -25, 34, -30, 36, -28, 38, -28, 38, -27,
     34, -18, 35, -16, 34, -14, 32, -8, 37, -6, 35, 0, 30, 10, 28, 18,
     26, 25, 29, 41, 0, 75, 2, 72, 8, 77, 14, 35, 18, 31, 17, 35,
     21, 30, 17, 45, 20, 42, 18, 45, 27, 26, 16, 54, 7, 66, 16, 56,
     11, 73, 10, 67, -10, 116, -23, 112, -15, 71, -7, 61, 0, 53, -5, 66,
     -11, 77, -9, 80, -9, 84, -10, 87, -34, 127, -21, 101, -3, 39, -5, 53,
     -7, 61, -11, 75, -15, 77, -17, 91, -25, 107, -25, 111, -28, 122, -11, 76,
     -10, 44, -10, 52, -10, 57, -9, 58, -16, 72, -7, 69, -4, 69, -5, 74,
     -9, 86, 2, 66, -9, 34, 1, 32, 11, 31, 5, 52, -2, 55, -2, 67,
     0, 73, -8, 89, 3, 52, 7, 4, 10, 8, 17, 8, 16, 19, 3, 37,
     -1, 61, -5, 73, -1, 70, -4, 78, 0, 0, -21, 126, -23, 124, -20, 110,
     -26, 126, -25, 124, -17, 105, -27, 121, -27, 117, -17, 102, -26, 117, -27, 116,
     -33, 122, -10, 95, -14, 100, -8, 95, -17, 111, -28, 114, -6, 89, -2, 80,
     -4, 82, -9, 85, -8, 81, -1, 72, 5, 64, 1, 67, 9, 56, 0, 69,
     1, 69, 7, 69, -7, 69, -6, 67, -16, 77, -2, 64, 2, 61, -6, 67,
     -3, 64, 2, 57, -3, 65, -3, 66, 0, 62, 9, 51, -1, 66, -2, 71,
     -2, 75, -1, 70, -9, 72, 14, 60, 16, 37, 0, 47, 18, 35, 11, 37,
     12, 41, 10, 41, 2, 48, 12, 41, 13, 41, 0, 59, 3, 50, 19, 40,
     3, 66, 18, 50, 19, -6, 18, -6, 14, 0, 26, -12, 31, -16, 33, -25,
     33, -22, 37, -28, 39, -30, 42, -30, 47, -42, 45, -36, 49, -34, 41, -17,
     32, 9, 69, -71, 63, -63, 66, -64, 77, -74, 54, -39, 52, -35, 41, -10,
     36, 0, 40, -1, 30, 14, 28, 26, 23, 37, 12, 55, 11, 65, 37, -33,
     39, -36, 40, -37, 38, -30, 46, -33, 42, -30, 40, -24, 49, -29, 38, -12,
     40, -10, 38, -3, 46, -5, 31, 20, 29, 30, 25, 44, 12, 48, 11, 49,
     26, 45, 22, 22, 23, 22, 27, 21, 33, 20, 26, 28, 30, 24, 27, 34,
     18, 42, 25, 39, 18, 50, 12, 70, 21, 54, 14, 71, 11, 83, 25, 32,
     21, 49, 21, 54, -5, 85, -6, 81, -10, 77, -7, 81, -17, 80, -18, 73,
     -4, 74, -10, 83, -9, 71, -9, 67, -1, 61, -8, 66, -14, 66, 0, 59,
     2, 59, 17, -10, 32, -13, 42, -9, 49, -5, 53, 0, 64, 3, 68, 10,
     66, 27, 47, 57, -5, 71, 0, 24, -1, 36, -2, 42, -2, 52, -9, 57,
     -6, 63, -4, 65, -4, 67, -7, 82, -3, 81, -3, 76, -7, 72, -6, 78,
     -12, 72, -14, 68, -3, 70, -6, 76, -5, 66, -5, 62, 0, 57, -4, 61,
     -9, 60, 1, 54, 2, 58, 17, -10, 32, -13, 42, -9, 49, -5, 53, 0,
     64, 3, 68, 10, 66, 27, 47, 57),
    (20, -15, 2, 54, 3, 74, 20, -15, 2, 54, 3, 74, -28, 127, -23, 104,
     -6, 53, -1, 54, 7, 51, 29, 16, 25, 0, 14, 0, -10, 51, -3, 62,
     -27, 99, 26, 16, -4, 85, -24, 102, 5, 57, 6, 57, -17, 73, 14, 57,
     20, 40, 20, 10, 29, 0, 54, 0, 37, 42, 12, 97, -32, 127, -22, 117,
     -2, 74, -4, 85, -24, 102, 5, 57, -6, 93, -14, 88, -6, 44, 4, 55,
     -11, 89, -15, 103, -21, 116, 19, 57, 20, 58, 4, 84, 6, 96, 1, 63,
     -5, 85, -13, 106, 5, 63, 6, 75, -3, 90, -1, 101, 3, 55, -4, 79,
     -2, 75, -12, 97, -7, 50, 1, 60, 0, 41, 0, 63, 0, 63, 0, 63,
     -9, 83, 4, 86, 0, 97, -7, 72, 13, 41, 3, 62, 7, 34, -9, 88,
     -20, 127, -36, 127, -17, 91, -14, 95, -25, 84, -25, 86, -12, 89, -17, 91,
     -31, 127, -14, 76, -18, 103, -13, 90, -37, 127, 11, 80, 5, 76, 2, 84,
     5, 78, -6, 55, 4, 61, -14, 83, -37, 127, -5, 79, -11, 104, -11, 91,
     -30, 127, 0, 65, -2, 79, 0, 72, -4, 92, -6, 56, 3, 68, -8, 71,
     -13, 98, -4, 86, -12, 88, -5, 82, -3, 72, -4, 67, -8, 72, -16, 89,
     -9, 69, -1, 59, 5, 66, 4, 57, -4, 71, -2, 71, 2, 58, -1, 74,
     -4, 44, -1, 69, 0, 62, -7, 51, -4, 47, -6, 42, -3, 41, -6, 53,
     8, 76, -9, 78, -11, 83, 9, 52, 0, 67, -5, 90, 1, 67, -15, 72,
     -5, 75, -8, 80, -21, 83, -21, 64, -13, 31, -25, 64, -29, 94, 9, 75,
     17, 63, -8, 74, -5, 35, -2, 27, 13, 91, 3, 65, -7, 69, 8, 77,
     -10, 66, 3, 62, -3, 68, -20, 81, 0, 30, 1, 7, -3, 23, -21, 74,
     16, 66, -23, 124, 17, 37, 44, -18, 50, -34, -22, 127, 4, 39, 0, 42,
     7, 34, 11, 29, 8, 31, 6, 37, 7, 42, 3, 40, 8, 33, 13, 43,
     13, 36, 4, 47, 3, 55, 2, 58, 6, 60, 8, 44, 11, 44, 14, 42,
     7, 48, 4, 56, 4, 52, 13, 37, 9, 49, 19, 58, 10, 48, 12, 45,
     0, 69, 20, 33, 8, 63, 35, -18, 33, -25, 28, -3, 24, 10, 27, 0,
     34, -14, 52, -44, 39, -24, 19, 17, 31, 25, 36, 29, 24, 33, 34, 15,
     30, 20, 22, 73, 20, 34, 19, 31, 27, 44, 19, 16, 15, 36, 15, 36,
     21, 28, 25, 21, 30, 20, 31, 12, 27, 16, 24, 42, 0, 93, 14, 56,
     15, 57, 26, 38, -24, 127, -24, 115, -22, 82, -9, 62, 0, 53, 0, 59,
     -14, 85, -13, 89, -13, 94, -11, 92, -29, 127, -21, 100, -14, 57, -12, 67,
     -11, 71, -10, 77, -21, 85, -16, 88, -23, 104, -15, 98, -37, 127, -10, 82,
     -8, 48, -8, 61, -8, 66, -7, 70, -14, 75, -10, 79, -9, 83, -12, 92,
     -18, 108, -4, 79, -22, 69, -16, 75, -2, 58, 1, 58, -13, 78, -9, 83,
     -4, 81, -13, 99, -13, 81, -6, 38, -13, 62, -6, 58, -2, 59, -16, 73,
     -10, 76, -13, 86, -9, 83, -10, 87, 0, 0, -22, 127, -25, 127, -25, 120,
     -27, 127, -19, 114, -23, 117, -25, 118, -26, 117, -24, 113, -28, 118, -31, 120,
     -37, 124, -10, 94, -15, 102, -10, 99, -13, 106, -50, 127, -5, 92, 17, 57,
     -5, 86, -13, 94, -12, 91, -2, 77, 0, 71, -1, 73, 4, 64, -7, 81,
     5, 64, 15, 57, 1, 67, 0, 68, -10, 67, 1, 68, 0, 77, 2, 64,
     0, 68, -5, 78, 7, 55, 5, 59, 2, 65, 14, 54, 15, 44, 5, 60,
     2, 70, -2, 76, -18, 86, 12, 70, 5, 64, -12, 70, 11, 55, 5, 56,
     0, 69, 2, 65, -6, 74, 5, 54, 7, 54, -6, 76, -11, 82, -2, 77,
     -2, 77, 25, 42, 17, -13, 16, -9, 17, -12, 27, -21, 37, -30, 41, -40,
     42, -41, 48, -47, 39, -32, 46, -40, 52, -51, 46, -41, 52, -39, 43, -19,
     32, 11, 61, -55, 56, -46, 62, -50, 81, -67, 45, -20, 35, -2, 28, 15,
     34, 1, 39, 1, 30, 17, 20, 38, 18, 45, 15, 54, 0, 79, 36, -16,
     37, -14, 37, -17, 32, 1, 34, 15, 29, 15, 24, 25, 34, 22, 31, 16,
     35, 18, 31, 28, 33, 41, 36, 28, 27, 47, 21, 62, 18, 31, 19, 26,
     36, 24, 24, 23, 27, 16, 24, 30, 31, 29, 22, 41, 22, 42, 16, 60,
     15, 52, 14, 60, 3, 78, -16, 123, 21, 53, 22, 56, 25, 61, 21, 33,
     19, 50, 17, 61, -3, 78, -8, 74, -9, 72, -10, 72, -18, 75, -12, 71,
     -11, 63, -5, 70, -17, 75, -14, 72, -16, 67, -8, 53, -14, 59, -9, 52,
     -11, 68, 9, -2, 30, -10, 31, -4, 33, -1, 33, 7, 31, 12, 37, 23,
     31, 38, 20, 64, -9, 71, -7, 37, -8, 44, -11, 49, -10, 56, -12, 59,
     -8, 63, -9, 67, -6, 68, -10, 79, -3, 78, -8, 74, -9, 72, -10, 72,
     -18, 75, -12, 71, -11, 63, -5, 70, -17, 75, -14, 72, -16, 67, -8, 53,
     -14, 59, -9, 52, -11, 68, 9, -2, 30, -10, 31, -4, 33, -1, 33, 7,
     31, 12, 37, 23, 31, 38, 20, 64))

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
    # the scaling lists as coded (zigzag order; None: not present) and
    # the matrices they give (raster: six 4x4, two 8x8; flat without)
    lists: Tuple[Optional[Tuple[int, ...]], ...] = ()
    matrices: Tuple[Tuple[int, ...], ...] = ()


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
    lists: Tuple[Optional[Tuple[int, ...]], ...] = ()
    matrices: Tuple[Tuple[int, ...], ...] = ()   # as Sps.matrices


# Table 7-3 and 7-4: the default scaling lists (zigzag order)
DEFAULT_4X4 = ((6, 13, 13, 20, 20, 20, 28, 28, 28, 28, 32, 32, 32, 37, 37,
                42),
               (10, 14, 14, 20, 20, 20, 24, 24, 24, 24, 27, 27, 27, 30, 30,
                34))
DEFAULT_8X8 = (
    (6, 10, 10, 13, 11, 13, 16, 16, 16, 16, 18, 18, 18, 18, 18, 23, 23, 23,
     23, 23, 23, 25, 25, 25, 25, 25, 25, 25, 27, 27, 27, 27, 27, 27, 27, 27,
     29, 29, 29, 29, 29, 29, 29, 31, 31, 31, 31, 31, 31, 33, 33, 33, 33, 33,
     36, 36, 36, 36, 38, 38, 38, 40, 40, 42),
    (9, 13, 13, 15, 13, 15, 17, 17, 17, 17, 19, 19, 19, 19, 19, 21, 21, 21,
     21, 21, 21, 22, 22, 22, 22, 22, 22, 22, 24, 24, 24, 24, 24, 24, 24, 24,
     25, 25, 25, 25, 25, 25, 25, 27, 27, 27, 27, 27, 27, 28, 28, 28, 28, 28,
     30, 30, 30, 30, 32, 32, 32, 33, 33, 35))
# scan position -> raster position in an 8x8 block (frame zigzag)
ZIGZAG8 = (0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19,
           26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28, 35, 42, 49,
           56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52,
           45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63)
FLAT = (16,) * 16, (16,) * 64


def _scaling_lists(r: Bits, n: int) -> Tuple[Optional[Tuple[int, ...]], ...]:
    """scaling_list() of n lists: each None where not present, else its
    values in zigzag order (the default list where the first delta gives
    useDefaultScalingMatrixFlag)."""
    out: List[Optional[Tuple[int, ...]]] = []
    for i in range(n):
        if not r.bit():
            out.append(None)
            continue
        size = 16 if i < 6 else 64
        last, nxt, vals = 8, 8, []
        for j in range(size):
            if nxt:
                delta = r.se()
                if not -128 <= delta <= 127:
                    raise H264Error(f"a delta_scale of {delta}")
                nxt = (last + delta + 256) % 256
                if j == 0 and nxt == 0:
                    vals = list((DEFAULT_4X4 if size == 16 else
                                 DEFAULT_8X8)[0 if i in (0, 1, 2, 6) else 1])
                    break
            vals.append(nxt or last)
            last = vals[-1]
        out.append(tuple(vals))
    return tuple(out)


def scaling_matrices(lists, fallback=None) -> Tuple[Tuple[int, ...], ...]:
    """The weightScale matrices (raster: lists 0-5 4x4, 6-7 8x8) of coded
    scaling lists (zigzag, None: not present) by fall-back rule A, or by
    rule B where ``fallback`` (the SPS's matrices, raster) is given."""
    lists = tuple(lists) + (None,) * (8 - len(lists))
    out: List[Tuple[int, ...]] = []
    for i, lst in enumerate(lists[:8]):
        size = 16 if i < 6 else 64
        zz = ZIGZAG if size == 16 else ZIGZAG8
        if lst is not None:
            raster = [0] * size
            for k, v in enumerate(lst):
                raster[zz[k]] = v
            out.append(tuple(raster))
        elif i in (0, 3, 6, 7):
            if fallback is not None:
                out.append(fallback[i])
            else:
                d = (DEFAULT_4X4 if size == 16 else DEFAULT_8X8)[
                    0 if i in (0, 6) else 1]
                raster = [0] * size
                for k, v in enumerate(d):
                    raster[zz[k]] = v
                out.append(tuple(raster))
        else:
            out.append(out[i - 1])
    return tuple(out)


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
            s.lists = _scaling_lists(r, 8 if s.chroma_format != 3 else 12)
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
    s.matrices = scaling_matrices(s.lists) if s.scaling else \
        (FLAT[0],) * 6 + (FLAT[1],) * 2
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
            p.lists = _scaling_lists(r, 6 + (2 if sps.chroma_format != 3
                                             else 6) * p.transform_8x8)
        p.cqp = (c, r.se())
    # the PPS's lists replace the SPS's (fall-back rule B where the SPS
    # has matrices); without lists it takes the SPS's matrices
    p.matrices = scaling_matrices(p.lists, sps.matrices if sps.scaling
                                  else None) if p.scaling else sps.matrices
    return p


def sps_unsupported(s: Sps) -> Optional[str]:
    if s.chroma_format != 1:
        return f"chroma_format_idc {s.chroma_format} (" + \
            ("monochrome; " if s.chroma_format == 0 else "") + "4:2:0 only)"
    if s.bit_depth != 8 or s.bit_depth_chroma != 8:
        return (f"a bit depth of {s.bit_depth} (luma) and "
                f"{s.bit_depth_chroma} (chroma) (8 bits only)")
    if s.bypass:
        return "qpprime_y_zero_transform_bypass (lossless macroblocks)"
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
    if p.slice_groups > 1:
        return f"slice groups (FMO: {p.slice_groups} groups)"
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
            why = ("P", "B", "I", "SP", "SI")[header.type] + " slices"
            if header.type == 1 and pps is not None and pps.weighted_bipred:
                why += f" (weighted_bipred_idc {pps.weighted_bipred})"
            return why
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
    cabac_init_idc: int = 0
    # pred_weight_table: (luma_log2_weight_denom, chroma_log2_weight_denom,
    # [(luma weight, offset, Cb weight, offset, Cr weight, offset)] a
    # reference index); None without explicit weights
    weights: Optional[Tuple[int, int, List[Tuple[int, ...]]]] = None
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
        if pps.weighted:
            h.weights = _pred_weight_table(r, h.num_ref)
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
    if pps.cabac and h.type != 2:
        h.cabac_init_idc = r.ue()
        if h.cabac_init_idc > 2:
            raise H264Error(f"cabac_init_idc {h.cabac_init_idc}")
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


def _pred_weight_table(r: Bits, num_ref: int):
    """pred_weight_table of a P slice (4:2:0): the denominators and each
    reference index's weights and offsets (the defaults where its flags
    are 0)."""
    lwd, cwd = r.ue(), r.ue()
    if lwd > 7 or cwd > 7:
        raise H264Error(f"log2 weight denominators of {lwd} and {cwd}")
    table = []
    for _ in range(num_ref):
        w = [1 << lwd, 0, 1 << cwd, 0, 1 << cwd, 0]
        coded: List[int] = []
        if r.bit():
            w[0:2] = coded[0:0] = r.se(), r.se()
        if r.bit():
            w[2:6] = r.se(), r.se(), r.se(), r.se()
            coded += w[2:6]
        if not all(-128 <= v <= 127 for v in coded):
            raise H264Error(f"a weight or offset out of range: {w}")
        table.append(tuple(w))
    return lwd, cwd, table


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
        pps = s.pps
        lwd, cwd, table = h.weights if h.weights else (0, 0, [])
        wt = [1 << lwd, 0, 1 << cwd, 0, 1 << cwd, 0] * 32
        for i, w in enumerate(table[:32]):
            wt[i * 6:i * 6 + 6] = w
        return [h.first_mb, 0 if h.type == 0 else 2, h.qp, h.disable,
                h.off_a, h.off_b, pps.cqp[0], pps.cqp[1], int(pps.cip),
                h.num_ref if h.type == 0 else 0] + refs + ids + [
                    int(pps.cabac), h.cabac_init_idc, int(pps.transform_8x8),
                    int(h.weights is not None), lwd, cwd] + \
            [v for m in pps.matrices for v in m] + wt


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


# normAdjust8x8 (8.5.9): [qP % 6][class of the position]
NORM8 = ((20, 18, 32, 19, 25, 24), (22, 19, 35, 21, 28, 26),
         (26, 23, 42, 24, 33, 31), (28, 25, 45, 26, 35, 33),
         (32, 28, 51, 30, 40, 38), (36, 32, 58, 34, 46, 43))


def _norm8_class(i: int) -> int:
    y, x = i >> 3, i & 7
    if x % 4 == 0 and y % 4 == 0:
        return 0
    if x % 2 == 1 and y % 2 == 1:
        return 1
    if x % 4 == 2 and y % 4 == 2:
        return 2
    if (x % 4 == 0 and y % 2 == 1) or (x % 2 == 1 and y % 4 == 0):
        return 3
    if (x % 4 == 0 and y % 4 == 2) or (x % 4 == 2 and y % 4 == 0):
        return 4
    return 5


def level_scales(matrices) -> Tuple[List, List]:
    """LevelScale4x4 [list][qP % 6][raster] of lists 0-5 and
    LevelScale8x8 of lists 6-7 (as [0] and [1]) of weightScale matrices."""
    ls4 = [[[matrices[k][i] * NORM[m][NORM_CLASS[i]] for i in range(16)]
            for m in range(6)] for k in range(6)]
    ls8 = [[[matrices[6 + k][i] * NORM8[m][_norm8_class(i)]
             for i in range(64)] for m in range(6)] for k in range(2)]
    return ls4, ls8


def dequant4(c: int, ls: int, qp: int) -> int:
    """A 4x4 block's level at LevelScale ls (8.5.12.1, not the DCs)."""
    q6 = qp // 6
    return (c * ls) << (q6 - 4) if q6 >= 4 else \
        (c * ls + (1 << (3 - q6))) >> (4 - q6)


def add_block(plane: np.ndarray, y0: int, x0: int, lv: Sequence[int],
              ls: Sequence[int], qp: int, dc: Optional[int] = None) -> None:
    """Dequantise (LevelScale4x4 ``ls`` at qp % 6) and inverse-transform a
    4x4 block of levels (raster; its DC given already scaled where ``dc``
    is not None) and add it to the plane at (y0, x0)."""
    d = [dequant4(lv[i], ls[i], qp) if lv[i] else 0 for i in range(16)]
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


def _idct8(d: List[int]) -> List[int]:
    """The 8-point inverse transform of 8.5.13.2."""
    d0, d1, d2, d3, d4, d5, d6, d7 = d
    e0, e1 = d0 + d4, -d3 + d5 - d7 - (d7 >> 1)
    e2, e3 = d0 - d4, d1 + d7 - d3 - (d3 >> 1)
    e4, e5 = (d2 >> 1) - d6, -d1 + d7 + d5 + (d5 >> 1)
    e6, e7 = d2 + (d6 >> 1), d3 + d5 + d1 + (d1 >> 1)
    f0, f1, f2, f3 = e0 + e6, e1 + (e7 >> 2), e2 + e4, e3 + (e5 >> 2)
    f4, f5, f6, f7 = e2 - e4, (e3 >> 2) - e5, e0 - e6, e7 - (e1 >> 2)
    return [f0 + f7, f2 + f5, f4 + f3, f6 + f1, f6 - f1, f4 - f3, f2 - f5,
            f0 - f7]


def add_block8(plane: np.ndarray, y0: int, x0: int, lv: Sequence[int],
               ls: Sequence[int], qp: int) -> None:
    """Dequantise (LevelScale8x8 ``ls`` at qp % 6) and inverse-transform an
    8x8 block of levels (raster) and add it to the plane at (y0, x0)."""
    q6 = qp // 6
    d = [0 if not c else (c * s) << (q6 - 6) if q6 >= 6 else
         (c * s + (1 << (5 - q6))) >> (6 - q6) for c, s in zip(lv, ls)]
    if not any(d):
        return
    rows = [_idct8(d[r * 8:r * 8 + 8]) for r in range(8)]
    cols = [_idct8([rows[r][c] for r in range(8)]) for c in range(8)]
    for y in range(8):
        for x in range(8):
            plane[y0 + y, x0 + x] = _clip1(int(plane[y0 + y, x0 + x]) +
                                           ((cols[x][y] + 32) >> 6))


def luma_dc(c: Sequence[int], qp: int, ls: int) -> List[int]:
    """Intra16x16 DC levels (raster of blocks) -> each block's DC; ls:
    LevelScale4x4(qp % 6, 0, 0)."""
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
    q6 = qp // 6
    if qp >= 36:
        return [(v * ls) << (q6 - 6) for v in g]
    return [(v * ls + (1 << (5 - q6))) >> (6 - q6) for v in g]


def chroma_dc(c: Sequence[int], qpc: int, ls: int) -> List[int]:
    f = (c[0] + c[1] + c[2] + c[3], c[0] - c[1] + c[2] - c[3],
         c[0] + c[1] - c[2] - c[3], c[0] - c[1] - c[2] + c[3])
    q6 = qpc // 6
    return [((v * ls) << q6) >> 5 for v in f]


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


def pred8x8(plane: np.ndarray, py: int, px: int, top: bool, left: bool,
            corner: bool, tr: bool, mode: int) -> np.ndarray:
    """An Intra_8x8 prediction (8.3.2.2) of the block at (py, px): the
    reference samples gathered, filtered (8.3.2.2.1), then ``mode``."""
    p, lf, c = [0] * 16, [0] * 8, 0
    if top:
        row = plane[py - 1]
        p[:8] = [int(row[px + x]) for x in range(8)]
        p[8:] = [int(row[px + x]) if tr else p[7] for x in range(8, 16)]
    if left:
        lf = [int(plane[py + y, px - 1]) for y in range(8)]
    if corner:
        c = int(plane[py - 1, px - 1])
    fp, fl, fc = [0] * 16, [0] * 8, c
    if top:
        fp[0] = (c + 2 * p[0] + p[1] + 2) >> 2 if corner else \
            (3 * p[0] + p[1] + 2) >> 2
        for x in range(1, 15):
            fp[x] = (p[x - 1] + 2 * p[x] + p[x + 1] + 2) >> 2
        fp[15] = (p[14] + 3 * p[15] + 2) >> 2
    if corner:
        if top and left:
            fc = (p[0] + 2 * c + lf[0] + 2) >> 2
        elif top:
            fc = (3 * c + p[0] + 2) >> 2
        elif left:
            fc = (3 * c + lf[0] + 2) >> 2
    if left:
        fl[0] = (c + 2 * lf[0] + lf[1] + 2) >> 2 if corner else \
            (3 * lf[0] + lf[1] + 2) >> 2
        for y in range(1, 7):
            fl[y] = (lf[y - 1] + 2 * lf[y] + lf[y + 1] + 2) >> 2
        fl[7] = (lf[6] + 3 * lf[7] + 2) >> 2
    T = lambda x: fc if x < 0 else fp[x]
    L = lambda y: fc if y < 0 else fl[y]
    out = np.zeros((8, 8), np.int64)
    if mode == 2:
        st, sl = sum(fp[:8]), sum(fl)
        dc = (st + sl + 8) >> 4 if top and left else (sl + 4) >> 3 if left \
            else (st + 4) >> 3 if top else 128
    for y in range(8):
        for x in range(8):
            if mode == 0:
                v = fp[x]
            elif mode == 1:
                v = fl[y]
            elif mode == 2:
                v = dc
            elif mode == 3:
                v = (fp[14] + 3 * fp[15] + 2) >> 2 if x == 7 and y == 7 else \
                    (fp[x + y] + 2 * fp[x + y + 1] + fp[x + y + 2] + 2) >> 2
            elif mode == 4:
                if x > y:
                    v = (T(x - y - 2) + 2 * T(x - y - 1) + T(x - y) + 2) >> 2
                elif x < y:
                    v = (L(y - x - 2) + 2 * L(y - x - 1) + L(y - x) + 2) >> 2
                else:
                    v = (T(0) + 2 * fc + L(0) + 2) >> 2
            elif mode == 5:
                z = 2 * x - y
                if z >= 0 and not z & 1:
                    v = (T(x - (y >> 1) - 1) + T(x - (y >> 1)) + 1) >> 1
                elif z > 0:
                    v = (T(x - (y >> 1) - 2) + 2 * T(x - (y >> 1) - 1) +
                         T(x - (y >> 1)) + 2) >> 2
                elif z == -1:
                    v = (L(0) + 2 * fc + T(0) + 2) >> 2
                else:
                    v = (L(y - 2 * x - 1) + 2 * L(y - 2 * x - 2) +
                         L(y - 2 * x - 3) + 2) >> 2
            elif mode == 6:
                z = 2 * y - x
                if z >= 0 and not z & 1:
                    v = (L(y - (x >> 1) - 1) + L(y - (x >> 1)) + 1) >> 1
                elif z > 0:
                    v = (L(y - (x >> 1) - 2) + 2 * L(y - (x >> 1) - 1) +
                         L(y - (x >> 1)) + 2) >> 2
                elif z == -1:
                    v = (L(0) + 2 * fc + T(0) + 2) >> 2
                else:
                    v = (T(x - 2 * y - 1) + 2 * T(x - 2 * y - 2) +
                         T(x - 2 * y - 3) + 2) >> 2
            elif mode == 7:
                k = x + (y >> 1)
                v = (fp[k] + fp[k + 1] + 1) >> 1 if not y & 1 else \
                    (fp[k] + 2 * fp[k + 1] + fp[k + 2] + 2) >> 2
            else:
                z, k = x + 2 * y, y + (x >> 1)
                if z < 13 and not z & 1:
                    v = (fl[k] + fl[k + 1] + 1) >> 1
                elif z < 13:
                    v = (fl[k] + 2 * fl[k + 1] + fl[k + 2] + 2) >> 2
                elif z == 13:
                    v = (fl[6] + 3 * fl[7] + 2) >> 2
                else:
                    v = fl[7]
            out[y, x] = v
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

NONE, INTER, SKIP, I4, I16, PCM, I8 = 0, 1, 2, 3, 4, 5, 6
_NXN = (I4, I8)

# rangeTabLPS [pStateIdx][qCodIRangeIdx] and transIdxLPS (9.3.3.2)
RANGE_LPS = (
    (128, 176, 208, 240), (128, 167, 197, 227), (128, 158, 187, 216),
    (123, 150, 178, 205), (116, 142, 169, 195), (111, 135, 160, 185),
    (105, 128, 152, 175), (100, 122, 144, 166), (95, 116, 137, 158),
    (90, 110, 130, 150), (85, 104, 123, 142), (81, 99, 117, 135),
    (77, 94, 111, 128), (73, 89, 105, 122), (69, 85, 100, 116),
    (66, 80, 95, 110), (62, 76, 90, 104), (59, 72, 86, 99), (56, 69, 81, 94),
    (53, 65, 77, 89), (51, 62, 73, 85), (48, 59, 69, 80), (46, 56, 66, 76),
    (43, 53, 63, 72), (41, 50, 59, 69), (39, 48, 56, 65), (37, 45, 54, 62),
    (35, 43, 51, 59), (33, 41, 48, 56), (32, 39, 46, 53), (30, 37, 43, 50),
    (29, 35, 41, 48), (27, 33, 39, 45), (26, 31, 37, 43), (24, 30, 35, 41),
    (23, 28, 33, 39), (22, 27, 32, 37), (21, 26, 30, 35), (20, 24, 29, 33),
    (19, 23, 27, 31), (18, 22, 26, 30), (17, 21, 25, 28), (16, 20, 23, 27),
    (15, 19, 22, 25), (14, 18, 21, 24), (14, 17, 20, 23), (13, 16, 19, 22),
    (12, 15, 18, 21), (12, 14, 17, 20), (11, 14, 16, 19), (11, 13, 15, 18),
    (10, 12, 15, 17), (10, 12, 14, 16), (9, 11, 13, 15), (9, 11, 12, 14),
    (8, 10, 12, 14), (8, 9, 11, 13), (7, 9, 11, 12), (7, 9, 10, 12),
    (7, 8, 10, 11), (6, 8, 9, 11), (6, 7, 9, 10), (6, 7, 8, 9), (2, 2, 2, 2))
TRANS_LPS = (0, 0, 1, 2, 2, 4, 4, 5, 6, 7, 8, 9, 9, 11, 11, 12, 13, 13, 15,
             15, 16, 16, 18, 18, 19, 19, 21, 21, 22, 22, 23, 24, 24, 25, 26,
             26, 27, 27, 28, 29, 29, 30, 30, 30, 31, 32, 32, 33, 33, 33, 34,
             34, 35, 35, 35, 36, 36, 36, 37, 37, 37, 38, 38, 63)
# ctxIdxOffset of coded_block_flag, significant_coeff_flag,
# last_significant_coeff_flag and coeff_abs_level_minus1 by ctxBlockCat
# (0 Intra16x16 DC, 1 Intra16x16 AC, 2 luma 4x4, 3 chroma DC, 4 chroma AC,
# 5 luma 8x8, which has no coded_block_flag in 4:2:0)
CBF_BASE = (85, 89, 93, 97, 101)
SIG_BASE = (105, 120, 134, 149, 152, 402)
LAST_BASE = (166, 181, 195, 210, 213, 417)
ABS_BASE = (227, 237, 247, 257, 266, 426)
# ctxIdxInc of significant_coeff_flag and last_significant_coeff_flag of
# an 8x8 block (frame coded) by scan position (Table 9-43)
SIG8 = (0, 1, 2, 3, 4, 5, 5, 4, 4, 3, 3, 4, 4, 4, 5, 5, 4, 4, 4, 4, 3, 3, 6,
        7, 7, 7, 8, 9, 10, 9, 8, 7, 7, 6, 11, 12, 13, 11, 6, 7, 8, 9, 14, 10,
        9, 8, 6, 11, 12, 13, 11, 6, 9, 14, 10, 9, 11, 12, 13, 11, 14, 10, 12)
LAST8 = (0, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2, 2, 2, 2, 2,
         2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 3, 3, 3, 3, 3, 3, 3, 3, 4, 4, 4, 4,
         4, 4, 4, 4, 5, 5, 5, 5, 6, 6, 6, 6, 7, 7, 7, 7, 8, 8, 8)


class Cabac:
    """The arithmetic decoding engine (9.3.1.2, 9.3.3.2) on a slice's bits
    and its context variables, initialised from SliceQPY."""

    def __init__(self, r: Bits, islice: bool, idc: int, qp: int):
        t = CABAC_INIT[0 if islice else 1 + idc]
        q = min(max(qp, 0), 51)
        self.st = []
        for i in range(460):
            pre = min(max(((t[2 * i] * q) >> 4) + t[2 * i + 1], 1), 126)
            self.st.append((63 - pre) << 1 if pre <= 63 else
                           ((pre - 64) << 1) | 1)
        self.r, self.lim = r, r.end + 1
        self.init_engine()

    def init_engine(self) -> None:
        self.range = 510
        self.offset = self.r.u(9)
        if self.offset >= 510:
            raise _Bad(-1)

    def _read(self) -> int:
        if self.r.pos >= self.lim:
            raise _Bad(-2)
        return self.r.bit()

    def decision(self, ctx: int) -> int:
        s = self.st[ctx]
        state, mps = s >> 1, s & 1
        lps = RANGE_LPS[state][(self.range >> 6) & 3]
        self.range -= lps
        if self.offset >= self.range:
            b = 1 - mps
            self.offset -= self.range
            self.range = lps
            self.st[ctx] = (TRANS_LPS[state] << 1) | \
                (1 - mps if state == 0 else mps)
        else:
            b = mps
            self.st[ctx] = (min(state + 1, 62) << 1) | mps
        while self.range < 256:
            self.range <<= 1
            self.offset = (self.offset << 1) | self._read()
        return b

    def bypass(self) -> int:
        self.offset = (self.offset << 1) | self._read()
        if self.offset >= self.range:
            self.offset -= self.range
            return 1
        return 0

    def terminate(self) -> int:
        self.range -= 2
        if self.offset >= self.range:
            return 1
        while self.range < 256:
            self.range <<= 1
            self.offset = (self.offset << 1) | self._read()
        return 0

    def eg(self, base: int, k: int) -> int:
        """base plus a k-th order Exp-Golomb suffix (UEGk)."""
        while self.bypass():
            base += 1 << k
            k += 1
            if k > 24:
                raise _Bad(-1)
        while k:
            k -= 1
            base += self.bypass() << k
        return base


class _Slot:
    """A frame slot: the planes (macroblock-aligned) and what each
    macroblock left for prediction, CABAC's contexts and deblocking."""

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
        self.t8 = [0] * n          # transform_size_8x8_flag
        self.cbp = [0] * n         # luma | chroma << 4 (I_PCM: 15 | 2 << 4)
        self.cbfdc = [0] * n       # coded_block_flag of luma, Cb, Cr DC
        self.cmode = [0] * n       # intra_chroma_pred_mode (0: not intra)
        self.mvd = [[(0, 0)] * 16 for _ in range(n)]   # min(|mvd|, 255)


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


_PARAM_NAMES = ("first_mb", "type", "qp", "disable", "off_a", "off_b", "cqp0",
                "cqp1", "cip", "nref")


def _weight(block: np.ndarray, logwd: int, w: int, o: int) -> np.ndarray:
    """Explicit weighted sample prediction (8.4.2.3.2) of a block."""
    b = block.astype(np.int64)
    v = ((b * w + (1 << (logwd - 1))) >> logwd) + o if logwd >= 1 else \
        b * w + o
    return np.clip(v, 0, 255).astype(np.uint8)


class Decoder:
    """The plain decoder of an H.264 stream: :class:`Stream` for the
    headers and the DPB, the macroblock layer (CAVLC and CABAC) and the
    deblocking filter in Python and NumPy (slow: keep its pictures small).
    :meth:`decode` takes the stream's samples in order and returns the
    yuv420p planes of the picture a sample holds (cropped as cv2 gives
    them), or None; raises :class:`H264Error` naming the frame, the slice
    and the macroblock where the stream is refused or does not decode."""

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
            flat = job.native_params(s)
            p = dict(zip(_PARAM_NAMES, flat[:10]))
            p["refs"] = [None if r is None else self.slots[r.slot]
                         for r in s.refs]
            p["ids"] = [-1 if r is None else r.id for r in s.refs]
            p["cabac"], p["init_idc"], p["t8mode"] = flat[74:77]
            lwd, cwd, table = s.header.weights or (0, 0, [])
            p["weights"] = (lwd, cwd, table) if s.header.weights else None
            p["ls4"], p["ls8"] = level_scales(s.pps.matrices)
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
        if p["cabac"]:
            r.pos = (r.pos + 7) & ~7        # cabac_alignment_one_bit
            cb = Cabac(r, p["type"] == 2, p["init_idc"], qp)
            self._last_dqp = 0
            while True:
                m = begin(mb)
                mb += 1
                skip = False
                if p["type"] == 0:
                    A, B = self._nb_mb(s, m, -1, 0), self._nb_mb(s, m, 0, -1)
                    skip = cb.decision(11 + (A >= 0 and c.kind[A] != SKIP) +
                                       (B >= 0 and c.kind[B] != SKIP))
                if skip:
                    c.nnz[m[0]] = [0] * 24
                    self._reconstruct(s, m, {"kind": SKIP, "qp": qp,
                                             "cbp": 0})
                    self._last_dqp = 0
                else:
                    d, qp = self._parse_cabac(cb, r, s, m, qp)
                    self._reconstruct(s, m, d)
                if cb.terminate():
                    return
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
                    self._reconstruct(s, m, {"kind": SKIP, "qp": qp,
                                             "cbp": 0})
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

    def _nb_mb(self, s: _Ctx, m, dx: int, dy: int) -> int:
        """The MB (dx, dy) MBs from the current one in its slice, or -1."""
        mx, my = m[1] + dx, m[2] + dy
        return my * s.cur.mbw + mx if self._avail(s, mx, my) else -1

    def _nb_block(self, s: _Ctx, m, bx: int, by: int) -> Tuple[int, int]:
        """(MB, raster 4x4 block) of 4x4 position (bx, by) of the current
        MB (-1 reaching left or up); MB -1 where it is not available."""
        dx, dy = (-1, bx + 4) if bx < 0 else (0, bx), \
            (-1, by + 4) if by < 0 else (0, by)
        a = self._nb_mb(s, m, dx[0], dy[0]) if dx[0] or dy[0] else m[0]
        return a, dy[1] * 4 + dx[1]

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
        d = {"kind": NONE, "cbp": 0, "t8": 0}
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
                if r.pos + 3072 > r.end:
                    raise _Bad(-2)
                d["kind"] = PCM
                d["pcm"] = [r.u(8) for _ in range(384)]
                d["qp"] = qp
                return d, qp
            if t == 0:
                d["kind"] = I4
                if p["t8mode"] and r.bit():
                    d["kind"], d["t8"] = I8, 1
            else:
                d["kind"] = I16
                d["i16"] = (t - 1) % 4
                d["cbp"] = (((t - 1) // 4) % 3) << 4 | (15 if t >= 13 else 0)
        nref = p["nref"]
        if d["kind"] in _NXN:
            modes = []
            for _ in range(4 if d["kind"] == I8 else 16):
                modes.append(-1 if r.bit() else r.u(3))
            d["rem"] = modes
        if d["kind"] in (I4, I8, I16):
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
            d["cbp"] = CBP_INTRA[code] if d["kind"] in _NXN else \
                CBP_INTER[code]
        if self._t8_coded(p, d):
            d["t8"] = r.bit()
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
        self._nxn_modes(s, m, d)
        return d, qp

    @staticmethod
    def _t8_coded(p: Dict, d: Dict) -> bool:
        """Does an inter MB's syntax hold transform_size_8x8_flag?"""
        return d["kind"] == INTER and bool(d["cbp"] & 15) and \
            bool(p["t8mode"]) and (d["ptype"] < 3 or not any(d["sub"]))

    def _nxn_modes(self, s: _Ctx, m, d: Dict) -> None:
        """The Intra NxN modes from their syntax, each stored as it comes."""
        if d["kind"] not in _NXN:
            return
        c, a = s.cur, m[0]
        c.kind[a] = d["kind"]
        n8 = d["kind"] == I8
        d["modes"] = []
        for blk in range(4 if n8 else 16):
            bx = (blk & 1) * 2 if n8 else BLK_X[blk]
            by = (blk >> 1) * 2 if n8 else BLK_Y[blk]
            pred = self._i4_pred(s, m, bx, by)
            rem = d["rem"][blk]
            mode = pred if rem < 0 else rem if rem < pred else rem + 1
            d["modes"].append(mode)
            for k in range(4 if n8 else 1):
                c.i4[a][(by + (k >> 1)) * 4 + bx + (k & 1)] = mode

    def _residual(self, r: Bits, s: _Ctx, m, d: Dict) -> None:
        nnz = s.cur.nnz[m[0]]
        i16 = d["kind"] == I16
        d["luma"] = [[0] * 16 for _ in range(16)]
        d["luma8"] = [[0] * 64 for _ in range(4)]
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
            if d["t8"]:        # four 4x4 reads interleaved into the 8x8
                for k in range(16):
                    d["luma8"][blk >> 2][ZIGZAG8[4 * k + (blk & 3)]] = \
                        scan[k]
            else:
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

    def _i4_pred(self, s: _Ctx, m, bx: int, by: int) -> int:
        """The predicted Intra4x4/8x8 mode of the block whose top-left 4x4
        block is (bx, by)."""
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
                if k not in _NXN:
                    return 2
            return c.i4[my * c.mbw + mx][y * 4 + x]
        a, b = mode_of(bx - 1, by), mode_of(bx, by - 1)
        return 2 if dc else min(a, b)

    # ------------------------------------------------------------ CABAC
    def _parse_cabac(self, cb: Cabac, r: Bits, s: _Ctx, m, qp: int):
        c, p = s.cur, s.p
        A, B = self._nb_mb(s, m, -1, 0), self._nb_mb(s, m, 0, -1)
        d = {"kind": NONE, "cbp": 0, "t8": 0}
        islice = p["type"] == 2
        mb_type = -1
        if not islice and not cb.decision(14):
            d["kind"] = INTER
            if not cb.decision(15):
                d["ptype"] = 3 if cb.decision(16) else 0
            else:
                d["ptype"] = 1 if cb.decision(17) else 2
        else:
            if islice:
                term = lambda n: n >= 0 and c.kind[n] not in _NXN
                ctx = (3 + term(A) + term(B), 6, 7, 8, 9, 10)
            else:
                ctx = (17, 18, 19, 19, 20, 20)
            if not cb.decision(ctx[0]):
                mb_type = 0
            elif cb.terminate():
                mb_type = 25
            else:
                mb_type = 1 + 12 * cb.decision(ctx[1])
                if cb.decision(ctx[2]):
                    mb_type += 4 + 4 * cb.decision(ctx[3])
                mb_type += 2 * cb.decision(ctx[4])
                mb_type += cb.decision(ctx[5])
        if mb_type == 25:
            r.pos = (r.pos + 7) & ~7
            if r.pos + 3072 > r.end:
                raise _Bad(-2)
            d["kind"] = PCM
            d["pcm"] = [r.u(8) for _ in range(384)]
            cb.init_engine()
            d["qp"] = qp
            self._last_dqp = 0
            return d, qp
        t8 = lambda: (A >= 0 and c.t8[A]) + (B >= 0 and c.t8[B])
        if mb_type == 0:
            d["kind"] = I4
            if p["t8mode"] and cb.decision(399 + t8()):
                d["kind"], d["t8"] = I8, 1
        elif mb_type > 0:
            d["kind"] = I16
            d["i16"] = (mb_type - 1) % 4
            d["cbp"] = (((mb_type - 1) // 4) % 3) << 4 | \
                (15 if mb_type >= 13 else 0)
        nref = p["nref"]
        if d["kind"] in _NXN:
            rem = []
            for _ in range(4 if d["kind"] == I8 else 16):
                if cb.decision(68):
                    rem.append(-1)
                else:
                    rem.append(cb.decision(69) | cb.decision(69) << 1 |
                               cb.decision(69) << 2)
            d["rem"] = rem
        if d["kind"] in (I4, I8, I16):
            v = 0
            if cb.decision(64 + (A >= 0 and c.cmode[A] != 0) +
                           (B >= 0 and c.cmode[B] != 0)):
                v = 1
                while v < 3 and cb.decision(67):
                    v += 1
            d["cmode"] = v
        else:
            sub = [0] * 4
            if d["ptype"] == 3:
                for i in range(4):
                    if cb.decision(21):
                        sub[i] = 0
                    elif not cb.decision(22):
                        sub[i] = 1
                    else:
                        sub[i] = 2 if cb.decision(23) else 3
            d["sub"] = sub
            ref = c.ref[m[0]]
            nown = 1 if d["ptype"] == 0 else 2 if d["ptype"] < 3 else 4
            d["ref"] = []
            for i in range(nown):
                x0 = i * 2 if d["ptype"] == 2 else (i & 1) * 2 \
                    if d["ptype"] == 3 else 0
                y0 = i * 2 if d["ptype"] == 1 else (i >> 1) * 2 \
                    if d["ptype"] == 3 else 0
                rf = 0
                if nref > 1:
                    na, ba = self._nb_block(s, m, x0 - 1, y0)
                    nb, bb = self._nb_block(s, m, x0, y0 - 1)
                    ta = na >= 0 and c.ref[na][ba] > 0
                    tb = nb >= 0 and c.ref[nb][bb] > 0
                    if cb.decision(54 + ta + 2 * tb):
                        rf, ctx = 1, 58
                        while cb.decision(ctx):
                            ctx = 59
                            rf += 1
                            if rf >= nref:
                                raise _Bad(-1)
                d["ref"].append(rf)
                w = 4 if d["ptype"] in (0, 1) else 2
                h = 4 if d["ptype"] in (0, 2) else 2
                for y in range(y0, y0 + h):
                    for x in range(x0, x0 + w):
                        ref[y * 4 + x] = rf
            mvd = c.mvd[m[0]]
            d["mvd"] = []
            for x, y, w, h, _, _ in _partitions(d["ptype"], sub):
                bx, by = x // 4, y // 4
                na, ba = self._nb_block(s, m, bx - 1, by)
                nb, bb = self._nb_block(s, m, bx, by - 1)
                v = []
                for comp in range(2):
                    total = (mvd[ba][comp] if na == m[0] else
                             c.mvd[na][ba][comp] if na >= 0 else 0) + \
                        (mvd[bb][comp] if nb == m[0] else
                         c.mvd[nb][bb][comp] if nb >= 0 else 0)
                    v.append(self._mvd(cb, 47 if comp else 40, total))
                d["mvd"].append(tuple(v))
                a2 = (min(abs(v[0]), 255), min(abs(v[1]), 255))
                for yy in range(by, by + h // 4):
                    for xx in range(bx, bx + w // 4):
                        mvd[yy * 4 + xx] = a2
        if d["kind"] != I16:
            luma_term = lambda n, bit: n >= 0 and not c.cbp[n] >> bit & 1
            cbp = 0
            for b8 in range(4):
                ta = (not cbp >> (b8 - 1) & 1) if b8 & 1 else \
                    luma_term(A, b8 + 1)
                tb = (not cbp >> (b8 - 2) & 1) if b8 & 2 else \
                    luma_term(B, b8 + 2)
                cbp |= cb.decision(73 + ta + 2 * tb) << b8
            ca = c.cbp[A] >> 4 if A >= 0 else 0
            cbb = c.cbp[B] >> 4 if B >= 0 else 0
            if cb.decision(77 + (ca != 0) + 2 * (cbb != 0)):
                cbp |= (1 + cb.decision(81 + (ca == 2) + 2 * (cbb == 2))) \
                    << 4
            d["cbp"] = cbp
        if self._t8_coded(p, d):
            d["t8"] = cb.decision(399 + t8())
        c.nnz[m[0]] = [0] * 24
        if d["cbp"] or d["kind"] == I16:
            v, ctx = 0, 60 + (self._last_dqp != 0)
            while cb.decision(ctx):
                ctx = 62 if ctx < 62 else 63
                v += 1
                if v > 52:
                    raise _Bad(-1)
            delta = (v + 1) // 2 if v & 1 else -(v // 2)
            if not -26 <= delta <= 25:
                raise _Bad(-1)
            qp = (qp + delta + 52) % 52
            self._last_dqp = delta
            d["qp"] = qp
            self._residual_cabac(cb, s, m, d)
        else:
            self._last_dqp = 0
            d["qp"] = qp
        self._nxn_modes(s, m, d)
        return d, qp

    @staticmethod
    def _mvd(cb: Cabac, base: int, total: int) -> int:
        if not cb.decision(base + (0 if total < 3 else 1 if total <= 32
                                   else 2)):
            return 0
        v, ctx = 1, base + 3
        while v < 9 and cb.decision(ctx):
            if v < 4:
                ctx += 1
            v += 1
        if v >= 9:
            v = cb.eg(v, 3)
        return -v if cb.bypass() else v

    @staticmethod
    def _block(cb: Cabac, cat: int, maxc: int) -> List[int]:
        """residual_block_cabac's levels of a coefficient list (its
        coded_block_flag read already)."""
        sig, last, absb = SIG_BASE[cat], LAST_BASE[cat], ABS_BASE[cat]
        pos, ended = [], False
        for i in range(maxc - 1):
            inc = SIG8[i] if cat == 5 else min(i, 2) if cat == 3 else i
            if cb.decision(sig + inc):
                pos.append(i)
                linc = LAST8[i] if cat == 5 else min(i, 2) if cat == 3 \
                    else i
                if cb.decision(last + linc):
                    ended = True
                    break
        if not ended:
            pos.append(maxc - 1)
        out = [0] * maxc
        gt1 = eq1 = 0
        for i in reversed(pos):
            v = 0
            if cb.decision(absb + (0 if gt1 else min(4, 1 + eq1))):
                ctx = absb + 5 + min(4 - (cat == 3), gt1)
                v = 1
                while v < 14 and cb.decision(ctx):
                    v += 1
                if v == 14:
                    v = cb.eg(14, 0)
            if v:
                gt1 += 1
            else:
                eq1 += 1
            out[i] = -(v + 1) if cb.bypass() else v + 1
        return out

    def _residual_cabac(self, cb: Cabac, s: _Ctx, m, d: Dict) -> None:
        c = s.cur
        nnz = c.nnz[m[0]]
        intra = d["kind"] in (I4, I8, I16)
        A, B = self._nb_mb(s, m, -1, 0), self._nb_mb(s, m, 0, -1)
        d["luma"] = [[0] * 16 for _ in range(16)]
        d["luma8"] = [[0] * 64 for _ in range(4)]
        d["ldc"] = [0] * 16
        d["cdc"] = [[0] * 4, [0] * 4]
        d["cac"] = [[[0] * 16 for _ in range(4)] for _ in range(2)]
        dc_term = lambda n, bit: int(intra) if n < 0 else c.cbfdc[n] >> bit & 1

        def term(n: int, v: int) -> int:
            return int(intra) if n < 0 else int(v != 0)
        if d["kind"] == I16:
            if cb.decision(CBF_BASE[0] + dc_term(A, 0) + 2 * dc_term(B, 0)):
                lst = self._block(cb, 0, 16)
                for k in range(16):
                    d["ldc"][ZIGZAG[k]] = lst[k]
        for b8 in range(4):
            if not d["cbp"] >> b8 & 1:
                continue
            if d["t8"]:
                lst = self._block(cb, 5, 64)
                for k in range(64):
                    d["luma8"][b8][ZIGZAG8[k]] = lst[k]
                n = sum(v != 0 for v in lst)
                bx, by = (b8 & 1) * 2, (b8 >> 1) * 2
                for k in range(4):
                    nnz[(by + (k >> 1)) * 4 + bx + (k & 1)] = n
                continue
            for blk in range(b8 * 4, b8 * 4 + 4):
                bx, by = BLK_X[blk], BLK_Y[blk]
                na, ba = self._nb_block(s, m, bx - 1, by)
                nb, bb = self._nb_block(s, m, bx, by - 1)
                ta = term(na, c.nnz[na][ba] if na >= 0 else 0)
                tb = term(nb, c.nnz[nb][bb] if nb >= 0 else 0)
                i16 = d["kind"] == I16
                cat = 1 if i16 else 2
                if not cb.decision(CBF_BASE[cat] + ta + 2 * tb):
                    continue
                lst = self._block(cb, cat, 16 - i16)
                for k in range(16 - i16):
                    d["luma"][blk][ZIGZAG[k + i16]] = lst[k]
                nnz[by * 4 + bx] = sum(v != 0 for v in lst)
        cc = d["cbp"] >> 4
        if cc:
            for k in range(2):
                if cb.decision(CBF_BASE[3] + dc_term(A, 1 + k) +
                               2 * dc_term(B, 1 + k)):
                    d["cdc"][k] = self._block(cb, 3, 4)
        if cc == 2:
            for k in range(2):
                for blk in range(4):
                    bx, by = blk & 1, blk >> 1

                    def cterm(x: int, y: int) -> int:
                        dx, dy = (-1, x + 2) if x < 0 else (0, x), \
                            (-1, y + 2) if y < 0 else (0, y)
                        n = self._nb_mb(s, m, dx[0], dy[0]) \
                            if dx[0] or dy[0] else m[0]
                        return term(n, c.nnz[n][16 + k * 4 + dy[1] * 2 +
                                                 dx[1]] if n >= 0 else 0)
                    if not cb.decision(CBF_BASE[4] + cterm(bx - 1, by) +
                                       2 * cterm(bx, by - 1)):
                        continue
                    lst = self._block(cb, 4, 15)
                    for j in range(15):
                        d["cac"][k][blk][ZIGZAG[j + 1]] = lst[j]
                    nnz[16 + k * 4 + blk] = sum(v != 0 for v in lst)

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

    @staticmethod
    def _store(c: _Slot, a: int, d: Dict) -> None:
        """What the next MBs' CABAC contexts read of MB a."""
        kind = d["kind"]
        c.t8[a] = d.get("t8", 0)
        c.cbp[a] = 15 | 2 << 4 if kind == PCM else 0 if kind == SKIP \
            else d["cbp"]
        c.cmode[a] = d["cmode"] if kind in (I4, I8, I16) else 0
        dc = 0
        if kind == I16 and any(d.get("ldc", ())):
            dc |= 1
        for k in range(2):
            if any(d.get("cdc", ((), ()))[k]):
                dc |= 2 << k
        c.cbfdc[a] = 7 if kind == PCM else 0 if kind == SKIP else dc
        mvd = [(0, 0)] * 16
        if kind == INTER:
            for (x, y, w, h, _, _), v in zip(
                    _partitions(d["ptype"], d["sub"]), d["mvd"]):
                for yy in range(y // 4, (y + h) // 4):
                    for xx in range(x // 4, (x + w) // 4):
                        mvd[yy * 4 + xx] = (min(abs(v[0]), 255),
                                            min(abs(v[1]), 255))
        c.mvd[a] = mvd

    def _reconstruct(self, s: _Ctx, m, d: Dict) -> None:
        c, p = s.cur, s.p
        a, mx, my = m
        kind = d["kind"]
        c.kind[a] = kind
        self._store(c, a, d)
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
        intra = kind in (I4, I8, I16)
        if intra:
            c.ref[a], c.mv[a], c.rpic[a] = [-1] * 16, [(0, 0)] * 16, \
                [-1] * 16
        tA, tB = self._intra_avail(s, mx - 1, my), \
            self._intra_avail(s, mx, my - 1)
        tC, tD = self._intra_avail(s, mx + 1, my - 1), \
            self._intra_avail(s, mx - 1, my - 1)
        qp = d["qp"]
        q = qp % 6
        ls4, ls8 = p["ls4"], p["ls8"]
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
                pr = pred4x4(t, lft, d["modes"][blk], top, left)
                c.y[Y0 + by * 4:Y0 + by * 4 + 4, X0 + bx * 4:X0 + bx * 4 + 4] \
                    = np.array(pr, np.uint8)
                c.i4[a][by * 4 + bx] = d["modes"][blk]
                if d["cbp"]:
                    add_block(c.y, Y0 + by * 4, X0 + bx * 4, d["luma"][blk],
                              ls4[0][q], qp)
        elif kind == I8:
            for b8 in range(4):
                bx, by = (b8 & 1) * 8, (b8 >> 1) * 8
                top, left = True if by else tB, True if bx else tA
                corner = True if bx and by else tD if not bx and not by \
                    else tB if bx else tA
                tr = (tB, tC, True, False)[b8]
                c.y[Y0 + by:Y0 + by + 8, X0 + bx:X0 + bx + 8] = pred8x8(
                    c.y, Y0 + by, X0 + bx, top, left, corner, tr,
                    d["modes"][b8]).astype(np.uint8)
                for k in range(4):
                    c.i4[a][(by // 4 + (k >> 1)) * 4 + bx // 4 + (k & 1)] = \
                        d["modes"][b8]
                if d["cbp"] >> b8 & 1:
                    add_block8(c.y, Y0 + by, X0 + bx, d["luma8"][b8],
                               ls8[0][q], qp)
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
            dcs = luma_dc(d["ldc"], qp, ls4[0][q][0])
            for blk in range(16):
                bx, by = BLK_X[blk], BLK_Y[blk]
                add_block(c.y, Y0 + by * 4, X0 + bx * 4, d["luma"][blk],
                          ls4[0][q], qp, dcs[by * 4 + bx])
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
            wts = p["weights"]
            for x, y, w, h, _, _ in parts:
                k = (y // 4) * 4 + x // 4
                rs = p["refs"][ref[k]]
                vx, vy = mv[k]
                ly = mc_luma(rs.y, X0 + x, Y0 + y, w, h, vx, vy)
                cy, cx = my * 8 + y // 2, mx * 8 + x // 2
                lu = mc_chroma(rs.u, cx, cy, w // 2, h // 2, vx, vy)
                lv = mc_chroma(rs.v, cx, cy, w // 2, h // 2, vx, vy)
                if wts is not None:
                    lwd, cwd, table = wts
                    wt = table[ref[k]] if ref[k] < len(table) else \
                        (1 << lwd, 0, 1 << cwd, 0, 1 << cwd, 0)
                    ly = _weight(ly, lwd, wt[0], wt[1])
                    lu = _weight(lu, cwd, wt[2], wt[3])
                    lv = _weight(lv, cwd, wt[4], wt[5])
                c.y[Y0 + y:Y0 + y + h, X0 + x:X0 + x + w] = ly
                c.u[cy:cy + h // 2, cx:cx + w // 2] = lu
                c.v[cy:cy + h // 2, cx:cx + w // 2] = lv
            if kind == SKIP:
                return
            if d["t8"]:
                for b8 in range(4):
                    if d["cbp"] >> b8 & 1:
                        add_block8(c.y, Y0 + (b8 >> 1) * 8,
                                   X0 + (b8 & 1) * 8, d["luma8"][b8],
                                   ls8[1][q], qp)
            elif d["cbp"] & 15:
                for blk in range(16):
                    add_block(c.y, Y0 + BLK_Y[blk] * 4, X0 + BLK_X[blk] * 4,
                              d["luma"][blk], ls4[3][q], qp)
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
                ls = ls4[(1 if intra else 4) + k][qpc[k] % 6]
                dcs = chroma_dc(d["cdc"][k], qpc[k], ls[0])
                for blk in range(4):
                    add_block(plane, my * 8 + (blk >> 1) * 4,
                              mx * 8 + (blk & 1) * 4, d["cac"][k][blk],
                              ls, qpc[k], dcs[blk])

    # ------------------------------------------------------------ deblocking
    @staticmethod
    def _coded(c: _Slot, a: int, b: int) -> bool:
        """Does the transform block of 4x4 block b (raster) of MB a hold a
        level (its 8x8 block where the MB takes the 8x8 transform)?"""
        if not c.t8[a]:
            return c.nnz[a][b] != 0
        b0 = b & 10
        return any(c.nnz[a][k] for k in (b0, b0 + 1, b0 + 4, b0 + 5))

    def _bs(self, c: _Slot, pa: int, pb: int, qa: int, qb: int,
            mb_edge: bool) -> int:
        if c.kind[pa] >= I4 or c.kind[qa] >= I4:
            return 4 if mb_edge else 3
        if self._coded(c, pa, pb) or self._coded(c, qa, qb):
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
                if e & 1 and c.t8[a]:
                    continue        # no 4x4 edges inside an 8x8 transform
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
