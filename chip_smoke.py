#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases 1-7, the HDR merge: builds the merge kernels K1-K3 from
``camera_linearity_tpu_torch/csrc`` (one ``nvcc`` per source, all at once;
the experiments' sources build on beside phases 3-6, which wait only for
the merge sources, and phase 7's timing waits for them) and prints their
registers and spills, holds each against its plain PyTorch
version on the card at the shapes of BASELINE config 2 (6 exposures of 1200
x 1920 x 3, f32 value and std) and config 3 (the same geometry with dark
frames, a flat field and 12-bit tables), and on a 37 x 53 crop that K2 and
K3 load by their copy route; K1 on each of its routes and instances (f32,
u8 and i32 stacks, 256 and 4096 entries, 3, 6, 12 and 18 exposures, 1, 3
and 4 channels, batches, a 37 x 53 crop and a stack 4 bytes off alignment,
the two routes bit for bit alike on the same values), drives the port's
entry points once (``merge_hdr`` and ``ExposureSeries.process_HDR_image``)
with the launch counts reset, checks the end-to-end result against the same
call on the CPU, times each kernel against its plain version and against a
device-to-device ``copy_`` of the same bytes with CUDA events, and times
``process_HDR_image`` end to end on the host clock and under the profiler.

Phases 8-11, the linearity analysis and the calibration (plain PyTorch; no
kernel of its own): ``process_linearity`` and
``collect_exposure_pair_stats`` at config-2 size against the CPU; every
energy form on a 32,768-pixel crop against the CPU in float64; the
config-4 ICRF solve (3 channels, 2,000 pixels, 6 exposures, popsize 15),
cold and warm, scored by the NumPy oracle of the reference; and the
calibration at full config-2 resolution, unweighted (the histogram form)
and std-weighted (the chunked form), with a profile of one generation of
each.  Inputs come from fixed numpy seeds; tables are gamma-like response
curves.

Phases 12-14, BASELINE config 5 (video -> HDR): build the native host
library and the port's MJPEG decoder and rawvideo reader
(``native/jpeg.cpp``, no libjpeg),
decode ``tests/data/mjpg 5ms.avi`` in its three modes (``turbo`` equal to
the committed libjpeg frames bit for bit, ``ffmpeg`` to the committed
``cv2.VideoCapture`` frames, and so on every committed ``*.cv2.npy``) and
hold ``jpeg.cpp`` to ``native/jpeg_plain.py`` bit for bit on frames this
script encodes (37 x 53, 38 x 53 and 64 x 3840 noise; 4:4:4, 4:2:2,
4:2:0, 4:1:1, 4:4:0 and grayscale, baseline and progressive; with and
without DRI; the three modes, the turbo ones refusing the frame modes
only ``ffmpeg`` reads, in both); write three raw RGBA exposure
videos of 12 frames at 2160 x 3840
into a temporary directory, and the same content as MJPG AVIs
(``tests/_torch_mjpeg_writer.py``, as ``cv2.VideoWriter`` writes them; a
pool of distinct frames cycled to 12, cached under ``build/``), and as
grayscale MJPG for every exposure and 4:1:1, 4:4:0 and progressive 4:2:0
MJPG for the brightest, timing one 4K frame's decode on one thread and a
video's frames on all, in every mode; hold the rawvideo reader to
``native/rawvideo_plain.py`` bit for bit on one 4K frame of each layout
it reads (8-bit paletted, RGB555 and 24-bit BI_RGB bottom-up, 32-bit
top-down, gray8, I420, YV12, NV12, YUY2, UYVY, and yuv444p, the planes of
a Ut Video ULY4 frame) and time it on one thread and over a batch of 12
on all; hold the PNG, HuffYUV, FFV1, UtVideo and Lagarith decoders
(``native/png.cpp``, ``native/huffyuv.cpp``, ``native/ffv1.cpp``,
``native/utvideo.cpp``, ``native/lagarith.cpp``) to ``png_plain.py``,
``huffyuv_plain.py``, ``ffv1_plain.py``, ``utvideo_plain.py`` and
``lagarith_plain.py`` bit for bit on a full-width
64-row strip of each of ``LOSSLESS_LAYOUTS`` (PNG RGB 8-bit with the five
filters cycled, PNG gray 8-bit, PNG RGB 16-bit with the filters cycled,
HFYU RGB24 gradient decorrelated, HFYU YUY2 left, FFVH yuv420p median),
``FFV1_LAYOUTS`` (cv2's BGR, gray8 and gray16, a Golomb-Rice yuv420p and
a range-coded BGR of context model 1, two frames: a keyframe and one that
carries its states; encoded by ``tests/_torch_ffv1_enc.cpp``) and
``UTVIDEO_LAYOUTS`` (ULY0 as cv2 writes it: left, 9 slices; ULRG median,
ULY2 gradient and ULY4 left in FFmpeg's 18 slices) and
``LAGARITH_LAYOUTS`` (RGB24 range coded with zero runs, RGBA with a
filled alpha plane, YUY2, YV12, and a stream mixing solid and coded
frames; encoded by ``tests/_torch_lagarith_enc.cpp``), the plain versions
in spawned processes, and on 4K frames of each to what cv2 gives for the
pictures written, and time them, once each (PNG, HuffYUV, UtVideo and
Lagarith one frame on one thread and over a batch of 12 on all, FFV1 and
Lagarith one frame on all, a slice or a plane a thread); hold the
Lagarith decoder to the committed ``tests/data/lagarith *.avi``'s cv2
frames (``.cv2.npy``); hold the MPEG-4 Part 2 decoder
(``native/mpeg4.cpp``) to ``mpeg4_plain.py`` and to the writer's
reconstruction on a 64 x 3840 strip of phase 14's I420 planes
(``mpeg4_strip``: an I-VOP and P-VOPs of skipped, 1MV, 4MV and intra
macroblocks, vectors past every edge, dquant, AC prediction, both rounding
types; the writer and the plain decode in a spawned process), to the
committed ``tests/data/mpeg4 *.avi``'s cv2 frames, and on 4K to the
reconstruction of 14 (g)'s brightest video, and time it once each: the I-VOP
on one thread, on all (a macroblock row a thread) and as a frame of a
batch of 12 (a GOP a thread), the 11 P-VOPs on one thread, on all and
as frames of 12 decoders at once; the same for the Advanced Simple tools
(``mpeg4_asp_strip``: B-VOPs of every kind, packed and unpacked, the Xvid
IDCT, ``quant_type`` 1 with custom matrices; 14 (h)'s brightest ``XVID``
video, its Xvid-IDCT I-VOP and a B-VOP timed); hold the H.264 decoder
(``native/h264.cpp``) to ``h264_plain.py`` and to the writer's
reconstruction on the same strip (``h264_strip``: the first pictures of
``tests/_torch_h264_writer.kitchen_sink``, several slices, reference
list modification, MMCOs, every macroblock kind; coded and decoded
plain in a spawned process), to the committed ``tests/data/h264 *``
clips' cv2 frames, on 4K to ``h264_plain.py`` (``H264Plain4K``: an IDR
and a P picture of 8 slices coded and decoded plain in two processes of
their own, started with the smoke, the P picture from the writer's
reconstruction of the IDR, and the one-slice stream of the same
pictures) and to the reconstruction of 14 (j)'s
brightest video, and time it once each: that video's IDR picture on one
thread, on all (a slice a thread) and as a frame of a batch of 12 (a GOP
a thread), its P pictures on one thread, on all and as frames of 12
decoders at once, a one-slice stream's IDR and P pictures on all (a
serial chain), and the ``avc1`` MP4's demux beside its
AVI; the same for the Main and High profiles' tools (``H264HighWork``, from
the smoke's start: a 64 x 3840 strip of ``high_sink``'s CABAC, Intra 8x8,
8x8 transform, weights and duplicated reference held to ``h264_plain.py``
and the reconstruction, 14 (k)'s brightest High video held to its
reconstruction and timed as above, its one-slice stream, its MP4's
demux); log when each job of the plain-decode window ended; mux 14 (i)'s MP4, MOV and
Matroska files from those AVIs' bitstreams (``ContainerVideos``, in the
window where no call is timed), hold the committed ``tests/data/container
*`` clips (MP4, MOV and Matroska files cv2 wrote, one under a 90-degree
matrix, one of B-VOPs with ``ctts``) to their cv2 frames through
``video_frame_generator``, and time the demuxers (``demux_rows``: the
brightest MP4 and Matroska video probed and read, beside the AVI of the
same bitstream); write the raw videos' frames again as
I420 AVIs (``yuv_planes``, as ``cv2.VideoWriter(fourcc "I420")`` lays them
out); run ``welford_algorithm``
on the card against the host backend and the CPU in float64, and
``compute_noise_profiles`` against the CPU; run ``batch_video_to_hdr`` on
8 scenes with the calibration leg, from raw AVIs once with the u16/f16
wire and once with f32/f32, then from MJPG AVIs with ``turbo_fast`` and
u16/f16, with ``turbo`` and f32/f32, and at the default decoder
(``"auto"`` with ``CL_DECODER`` unset: the ``ffmpeg`` mode, cv2's bytes)
and u16/f16, holding scenes 0 and 7 against
the plain merge, the stacks against a NumPy moments oracle (fed, for
MJPG, by ``jpeg_plain.py``'s decode of crop videos) and the leg's energy
against the reference's; then ``video_to_hdr`` through K3 on each kind;
then the default decoder on the grayscale MJPG (``batch_video_to_hdr``
u16/f16 held alike, its staged channels equal, and ``video_to_hdr``),
then the I420 AVIs through the rawvideo reader (``batch_video_to_hdr``
u16/f16, the oracle fed by ``rawvideo_plain.py``'s decode of the I420
crops, and ``video_to_hdr``), and
``welford_algorithm`` on the card over the 4:4:0 and the progressive
video against the oracle at the crop.  It times the device Welford and
K1 at B = 8 beside their bounds, K3's share of ``video_to_hdr``, and
``welford_algorithm`` on one MJPG video by decoder threads.

Phase 14 (b), config 5 from AVIs whose video is not stream 0: phase 14's
default-decoder MJPG videos written again with a PCM audio stream 0 and
the video as stream 1 (odd-sized audio chunks between the frames);
``batch_video_to_hdr`` (K1, B = 8) and ``video_to_hdr`` (K3) on them,
held to phase 14's results on the stream-0 files bit for bit and timed
beside them; one I420 video read through ``raw_chunks`` as stream 2,
held to stream 0's frames; ``timed(label, logger)`` and
``timed(label, device=dev)`` checked to synchronize the card; and
``stage_to_device(arr, max_bytes)`` checked to copy in slices onto it.

Phases 14 (c)-(f), config 5 from the lossless compressed AVIs
ImageJ/Fiji, ``cv2.VideoWriter``, archives and capture tools write: phase
14's raw frames encoded again (each distinct frame once, in phase 12's
plain-decode window, cached under ``build/``; so are 14 (g)'s) as PNG
AVIs (``MPNG``),
HuffYUV AVIs (``HFYU`` RGB24, left, decorrelated), FFV1 AVIs as
``cv2.VideoWriter(fourcc "FFV1")`` writes BGR (version 3, slice CRCs,
Golomb-Rice, 12 x 7 slices, a GOP of 12; the native encoder) and Ut Video
``ULRG`` AVIs (left, 18 slices, as FFmpeg's ``-c:v utvideo`` writes
them) and Lagarith RGB24 AVIs, and phase 14's I420 planes as ``ULY0``
AVIs as ``cv2.VideoWriter(fourcc "ULY0")`` writes them (left, 9 slices)
and as Lagarith YV12 AVIs.
(c): ONE ``batch_video_to_hdr`` (K1, B = 8) at the default decoder whose
8 scenes are one PNG, one HuffYUV, two FFV1, two ULRG and two Lagarith
RGB24 scenes (each file takes its own decoder), held to phase 14's raw
u16/f16 results bit for bit, its MP/s, ``decode_s`` and launches beside
the raw run's, and ``video_to_hdr`` (K3) on the PNG and the HuffYUV
videos; (d) on the FFV1 videos; (e) on the ULRG videos, each held to the
raw ``video_to_hdr`` bit for bit, and on the ULY0 videos, held to phase
14's I420 ``video_to_hdr`` bit for bit; (f) on the Lagarith RGB24
videos, held to the raw one, and on the Lagarith YV12 videos, held to
the I420 one, bit for bit; (g) on MPEG-4 Part 2 ``FMP4`` AVIs of phase
14's I420 planes (``tests/_torch_mpeg4_enc.cpp``: an I-VOP and 11 P-VOPs a
video, as ``cv2.VideoWriter`` writes them), held bit for bit to
``video_to_hdr`` on I420 AVIs of the writer's reconstruction, with its
wall, K3's launch and MP/s; (h) likewise on Advanced Simple ``XVID`` AVIs
of the same planes, as Xvid's packed mode writes them (two packed B-VOPs
between references, ``quant_type`` 1, the Xvid IDCT); (i) on the same
bitstreams in other containers (``tests/_torch_mp4_writer.py``,
``tests/_torch_mkv_writer.py``): (g)'s ``FMP4`` and (h)'s ``XVID`` in MP4,
phase 14's MJPG scene in QuickTime MOV (``jpeg``), (d)'s FFV1 scene in
Matroska, each held bit for bit to the AVI run of the same bitstream,
and ``welford_algorithm`` on the ``FMP4`` MP4 under a 90-degree ``tkhd``
matrix, held exactly to ``np.rot90`` of the AVI's statistics; (j) on
H.264 videos of phase 14's I420 planes (``tests/_torch_h264_enc.cpp``:
an IDR and 11 P pictures a video as ``x264 --profile baseline --tune
zerolatency`` codes at its defaults: QPs H264_QP, H264_SLICES slices a
picture; a reference list modification and an MMCO in the first; coded
in phase
12's window, cached under ``build/``) in ``avc1`` MP4s, held bit for bit
to ``video_to_hdr`` on I420 AVIs of the writer's reconstruction, and the
same bitstreams in Annex B AVIs and in Matroska, held to the MP4 run; (k)
on H.264 High videos (``H264HighWork``: config 5's three exposures made
again on the host from SEED, coded from the smoke's start in a process
of its own at niceness 10, as ``x264 --profile high --tune zerolatency``
codes at its defaults: CABAC, 8x8dct with Intra 8x8 and 4x4, weightp 2,
``--cqm flat``, QPs H264_QP, H264_SLICES slices a picture; a duplicated,
weighted reference in the first) in ``avc1`` MP4s, held bit for bit to
``video_to_hdr`` on I420 AVIs of the writer's reconstruction.

Phases 15-16, config 3's captures as files and the command line: build
the native TIFF codec, write and read the captures, read one config-3
plane in each TIFF layout the reader gained (``tests/_torch_tiff_writer.py``:
BigTIFF, PackBits, Deflate 32946, planar, signed and 32-bit integers,
12-bit, MinIsWhite, palette, CMYK, gray + alpha, Orientation, FillOrder 2)
under both flags against the arrays cv2 returns, the native PackBits
against its plain version; then one plane in each JPEG, YCbCr and fax
layout (JPEG YCbCr 4:2:0 in strips and in 256 x 256 tiles, JPEG 4:4:4
RGB, JPEG gray, uncompressed YCbCr 2x2, 1-bit uncompressed and PackBits,
4-bit gray, CCITT Group 3 1-D) read natively and by the plain reader
(``PlainCodecs``: ``jpeg_plain.py``, ``tiff_plain.py``, a chunk a task in
spawned processes) under both flags, bit for bit alike, and every committed
``tests/data/tiff *.tif`` against its cv2 arrays; and run ``calibrate``,
``merge`` (then again on the captures rewritten as BigTIFF + PackBits +
planar, held to the first at 0 error, and on them rewritten as
JPEG-compressed YCbCr 4:2:0 tiles, one K3 launch, held at 0 error to
``process_HDR_image`` on the plain reader's arrays), ``video`` (on the
raw and the MJPG videos), ``dorf``, ``linearity`` and ``doctor``
in-process;
``linearity`` logs its fits with or without matplotlib (the card's machine
has none: then no PNG is written and one warning says so).

Phase 17, the kernel experiments E1-E5 (``benchmarks/exp_kernel.py`` and
``exp_plateau.py``, ported to ``csrc/exp_ablation.cu``) at config 2: each
variant against its plain version (the sums exactly, but for ``exp``'s
value), the experiments' entry points with the launch counts reset, times beside a ``copy_`` of the
same bytes and the two-``torch.sum`` yardstick, E5's launch sweep, and K1's
time split into bytes, arithmetic and lookup.

Phase 18, the lookup-merge experiments E6 and E7
(``benchmarks/exp_manual_pipeline.py`` and ``exp_int8_planes.py``, ported
to ``csrc/exp_lut_merge.cu``) on planar copies of config 2/3's stacks: E6
at every (chunk, stages) setting of its sweep and by its scalar route on a
37 x 53 crop, E7 in its three table forms (held to give the same bits),
each against the plain version; the experiments' entry points with the
launch counts reset; times beside a ``copy_`` of the same bytes, the bound,
K1 at 8 and 12 bits on the same data and the plain version; E6's sweep;
and K1's split extended by E6 and E7.

Phase 19, K1's design choices: each entry of ``K1_VARIANTS`` is a text
edit of ``csrc/hdr_merge.cu``, built beside the source as it is, held
against the plain version and timed with it, in turns, at config 2 (8 and
12 bits), at 12 exposures and at config 5's B = 8, beside a ``copy_`` of
the same bytes.

Phase 20, the multi-process layer (``parallel/``), in phase 12's
directory, on the first PHASE20_FRAMES frames of config 5's I420 videos
(the single-process ``batch_video_to_hdr``, phase 14's path, on them
first: the reference): (a) an NCCL world of one in this process runs
``batch_video_to_hdr_distributed`` on config 5's 8 scenes with the
calibration leg (held to the reference, and timed beside its call made
again in the same world), ``merge_batch_sharded``
of config 3's stack with base curves (K2, held to its plain version), the
sharded statistics on config 2's planes (held to ``ops/stats.py``) and the population-sharded
config-4 solve (held to phase 10's); (b) two processes share the one card
over gloo (this script run again with ``--phase20-worker RANK PORT DIR``),
each decoding and merging 4 scenes with one K1 launch, held to (a), with
the statistics' rows and the solve's population split between them.  The
card has no peer, so no multi-GPU speed is measured.

Phase 21, the port's examples (``examples/torch_*.py``), each run once on
the card in a process of its own at a small size; the distributed one as
an NCCL world of one.

It prints the card's name and power limit early, each phase's wall
(``PHASE_WALLS``: from the line that starts a phase to the next one's)
and one JSON line with the kernels' results before the last line, and as
the last line
``{"ok": true, "device": {...}}``.  Any failure raises: a nonzero exit and
no last line.  Without a CUDA device it exits with code 2.
"""
import json
import logging
import os
import re
import shutil
import struct
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch

N, H, W, C = 6, 1200, 1920, 3
EXPOSURES_MS = (40, 80, 160, 320, 640, 1280)  # all above dark_threshold
SEED = 20261016
# f32 kernel against f32 plain version on the card; the differences come
# from expf and FMA contraction
VAL_TOL = dict(rtol=2e-5, atol=1e-6)
STD_TOL = dict(rtol=2e-4, atol=1e-5)
# end to end, the card merges through the 256-point base curves' interpolant
# (K3) and the CPU through their np.interp expansion to 4096 entries: the
# two differ by f32 rounding of the expansion, the tolerance the JAX suite
# holds the same pair to (tests/unit/test_hdr_pallas2.py:141-144)
E2E_VAL_TOL = dict(rtol=2e-4, atol=2e-6)
E2E_STD_TOL = dict(rtol=1e-3, atol=2e-6)
# phase 8: f32 pair statistics over 2.3 M pixels, card against CPU; the sums
# run in another order on each
STATS_TOL = dict(rtol=1e-4, atol=1e-6)
# phase 9: f32 energies on the card against float64 on the CPU
ENERGY_TOL = dict(rtol=1e-5, atol=1e-7)
# phase 10: the solved energy against the NumPy oracle at the same params
ORACLE_RTOL = 1e-5
# phase 10: the recovered curve against x**gamma, the f32 bound of
# tests/unit/test_calibration.py:131
CURVE_ATOL = 0.065
CAL_GAMMAS = (2.0, 2.2, 2.4)
# phases 12-14, BASELINE config 5 (benchmarks/bench_video.py:144-202): 8
# scenes of 3 exposure videos at 4K; frames cut from 1000 to 12 a video
H5, W5, SCENES5, FRAMES5 = 2160, 3840, 8, 12
EXPOSURES5_MS = (5, 10, 20)
# phases 15-16: config 3's captures as files; the three longest exposures
# reach dark_threshold (35 ms) and get dark frames
FILE_EXPOSURES_MS = (5, 10, 20, 40, 80, 160)
CROP_ROWS = 64   # rows held against the CPU in float64 and the oracle
# phases 12-14, config 5 from MJPG AVIs as cv2.VideoWriter writes them:
# each exposure cycles a pool of 4 distinct frames (bench_video.py cycles
# 12) at a quality whose 4K frames weigh what cv2's do (1.9-2.5 MB); the
# oracle's crops are 16 rows taller than CROP_ROWS, so that their first
# CROP_ROWS rows decode as the full frame's (fancy upsampling reads the
# chroma row below)
MJPG_POOL, MJPG_QUALITY, MJPG_CROP_ROWS = 4, 25, CROP_ROWS + 16
ROOT = Path(__file__).resolve().parent
# phase 20 (b): a worker process that has not finished by then fails it
PHASE20_WORKER_TIMEOUT_S = 300
# phase 20's videos: the first frames of config 5's I420 ones
PHASE20_FRAMES = 4
SOURCES = {
    "merge_nhwc_fused": "camera_linearity_tpu_torch/csrc/hdr_merge.cu",
    "merge_nhwc_lerp": "camera_linearity_tpu_torch/csrc/hdr_merge_lerp.cu",
    "merge_nhwc_lerp_bp": "camera_linearity_tpu_torch/csrc/hdr_merge_lerp.cu",
}
REPLACES = {
    "merge_nhwc_fused": "camera_linearity_tpu/ops/hdr_pallas2.py:474",
    "merge_nhwc_lerp": "camera_linearity_tpu/ops/hdr_pallas2.py:533",
    "merge_nhwc_lerp_bp": "camera_linearity_tpu/ops/hdr_pallas2.py:596",
}
# NVIDIA H100 SXM published peaks (NVIDIA's data sheet): HBM bytes per
# second, and f32 operations per second outside the tensor cores
PEAK_BYTES_S = 3.35e12
PEAK_F32_S = 67e12
# f32 operations per element and exposure of the merge with std, counted
# from the kernels' source (quantize, weight, lookups, bracket; expf as 1)
OPS_PER_ELEMENT = 48
# phase 17: the ablation kernels; the merge without a lookup's f32
# operations per element and exposure (weight, sums, bracket; expf as 1)
ABLATION_SOURCE = "camera_linearity_tpu_torch/csrc/exp_ablation.cu"
ABLATION_MERGE_OPS = 30
# phase 18: the lookup-merge experiments; their f32 operations per element
# and exposure are K1's (OPS_PER_ELEMENT)
LUT_SOURCE = "camera_linearity_tpu_torch/csrc/exp_lut_merge.cu"


# each phase's wall: a line "phase N[ (x)]:" or "phase N (x)," starts
# phase "N[ (x)]", which runs until the next one starts or, for a
# sub-phase, until its own line "phase N (x): <seconds> s", after which
# phase N runs on (phases 1-7 log no such line: they run from the start
# to phase 8)
PHASE_WALLS: dict = {}
_PHASE = ["1-7", time.perf_counter()]
_PHASE_LINE = re.compile(r"phase (\d+(?: \([a-z]\))?)[:,]")
_PHASE_END = re.compile(r"phase (\d+)(?: \([a-z]\))?: [\d.]+ s$")


def log(msg: str) -> None:
    line = _PHASE_END.match(msg) or _PHASE_LINE.match(msg)
    if line:
        close_phase(line.group(1))
    print(msg, flush=True)


def close_phase(name: str = "") -> dict:
    """Add the running phase's seconds to PHASE_WALLS and start phase
    ``name``; returns PHASE_WALLS."""
    now = time.perf_counter()
    PHASE_WALLS[_PHASE[0]] = PHASE_WALLS.get(_PHASE[0], 0.0) + now - _PHASE[1]
    _PHASE[:] = [name, now]
    return PHASE_WALLS


def phase_mark(what: str) -> None:
    """A line with the seconds since the running phase began, after
    ``what``: where a long phase's time goes."""
    log(f"  {what}: {time.perf_counter() - _PHASE[1]:.1f} s into phase "
        f"{_PHASE[0]}")


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def make_inputs(rng):
    """A bracketed capture of one scene: radiance in [0, 1), the camera's
    gamma-like response, read noise, clipping; per-exposure dark frames
    with ~0.5 % hot pixels (all four corners included) and a vignetted flat
    field."""
    f32 = np.float32
    radiance = rng.random((H, W, C), dtype=f32) ** 2
    gamma = np.array([2.0, 2.2, 2.4], f32)
    t = np.array(EXPOSURES_MS, f32) / 1000
    vals = np.empty((N, H, W, C), f32)
    for e in range(N):
        lin = np.minimum(radiance * (t[e] / t[2]), 1.0)
        vals[e] = np.clip(lin ** (1 / gamma) + rng.normal(
            0, 0.004, (H, W, C)).astype(f32), 0.0, 1.0)
    stds = (0.002 + 0.01 * np.sqrt(vals)).astype(f32)
    darks = (rng.random((N, H, W, C), dtype=f32) * 0.01).astype(f32)
    hot = rng.random((N, H, W, C), dtype=f32) < 0.005
    hot[:, 0, 0] = hot[:, 0, -1] = hot[:, -1, 0] = hot[:, -1, -1] = True
    darks[hot] = 0.05 + 0.45 * rng.random(int(hot.sum()), dtype=f32)
    yy, xx = np.meshgrid(np.linspace(-1, 1, H, dtype=f32),
                         np.linspace(-1, 1, W, dtype=f32), indexing="ij")
    flat = (0.6 + 0.3 * np.cos(0.6 * np.sqrt(yy ** 2 + xx ** 2)))[..., None]
    flat = np.repeat(flat, C, axis=2).astype(f32)
    flat_std = np.full_like(flat, 0.004)
    return t, vals, stds, darks, flat, flat_std


def make_tables():
    """256-point base curves x^gamma per channel, their derivative, and the
    np.interp expansion of both to 4096 entries (the reference's >8-bit
    construction, ICRF_calibration_exposure.py:204-216)."""
    xb = np.arange(256) / 255.0
    base = np.stack([xb ** g for g in (2.0, 2.2, 2.4)], axis=1)
    diff_base = np.gradient(base, 2 / 255, axis=0)
    x = np.arange(4096) / 4095.0
    icrf = np.stack([np.interp(x, xb, base[:, ch]) for ch in range(C)], 1)
    diff = np.stack([np.interp(x, xb, diff_base[:, ch]) for ch in range(C)],
                    1)
    return base, diff_base, icrf, diff


class Results:
    """max |kernel - plain| per kernel over every comparison."""

    def __init__(self):
        self.err = {}

    def check(self, kernel, label, got, want, val_tol=VAL_TOL,
              std_tol=STD_TOL):
        (gv, gs), (wv, ws) = got, want
        torch.testing.assert_close(gv, wv, **val_tol)
        errs = [(gv - wv).abs().max().item()]
        if ws is not None:
            torch.testing.assert_close(gs, ws, **std_tol)
            errs.append((gs - ws).abs().max().item())
        elif gs is not None:
            raise AssertionError(f"{label}: std returned without input std")
        err = max(errs)
        if kernel is not None:
            self.err[kernel] = max(self.err.get(kernel, 0.0), err)
        log(f"  ok  {label}: max abs err {err:.3e}")


def time_samples(fn, runs: int = 10, reps: int = 10, warmup: int = 3):
    """Device ms per call of ``fn``, one sample per run: CUDA events around
    ``reps`` back-to-back calls, so the card is not left idle waiting on
    the host between calls.  The stacks (hundreds of MB) do not fit the
    50 MB L2, so every call reads them from device memory."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / reps)
    return samples


def host_ms(fn, runs: int = 10, warmup: int = 2) -> float:
    """Median host-clock ms of ``fn`` followed by a synchronize."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        samples.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(samples))


def gamma_basis(datapoints: int = 256):
    """Mean curve and 5-component PCA basis of a family of gamma ICRFs
    (benchmarks/bench_calibration.py:20-36): the DoRF database is not in
    the repository."""
    x = np.linspace(0, 1, datapoints)
    curves = np.stack([x ** g for g in np.linspace(1.6, 3.0, 25)])
    mean_icrf = curves.mean(axis=0)
    _, _, vt = np.linalg.svd(curves - mean_icrf, full_matrices=False)
    return mean_icrf, vt[:5].T


def config4_problem(seed=7, n_exp=6, pixels=2000, datapoints=256):
    """The config-4 calibration problem of bench.py:205-224 (built as
    benchmarks/bench_calibration.py:20-36 builds it): per channel, DNs of a
    linear scene seen through CRF = x**(1/gamma)."""
    rng = np.random.default_rng(seed)
    exposures = 0.001 * 2.0 ** np.arange(n_exp)
    mean_icrf, pca = gamma_basis(datapoints)
    stacks = []
    for g in CAL_GAMMAS:
        radiance = rng.uniform(0.01, 0.35, pixels)
        linear = radiance[:, None] * (exposures / exposures[-1])[None, :]
        stacks.append(np.around(np.clip(linear, 0, 1) ** (1 / g)
                                * (datapoints - 1)).astype(np.int32))
    return np.stack(stacks), exposures, mean_icrf, pca


def profile_breakdown(label: str, fn, top: int = 8,
                      by_kernel: bool = False) -> None:
    """One call of ``fn`` under ``torch.profiler`` after one warm-up call:
    the call's host-clock time, the union of its kernels' device
    intervals (busy), the idle share, and its top ops by the device time
    of the kernels each launched; with ``by_kernel``, also its top kernels
    by name (the merge kernels, launched through ctypes, belong to no
    op)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from camera_linearity_tpu_torch.utils.observability import device_busy
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy_ms, n_spans = device_busy(prof)
    if busy_ms == 0:
        log(f"  profile {label}: {wall_ms:.3f} ms with the profiler on; "
            "the profiler saw no device time (not measured)")
        return
    log(f"  profile {label}: {wall_ms:.3f} ms with the profiler on, "
        f"{n_spans} kernels, device busy {busy_ms:.3f} ms, idle share "
        f"{max(0.0, 1 - busy_ms / wall_ms) * 100:.1f} %")
    if by_kernel:
        kernel_us = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA and \
                    e.name != "Command Buffer Full":
                kernel_us[e.name] = kernel_us.get(e.name, 0.0) + \
                    e.time_range.end - e.time_range.start
        for name, us in sorted(kernel_us.items(), key=lambda kv: -kv[1]
                               )[:top]:
            log(f"    kernel {us / 1e3:9.3f} ms {us / 1e3 / busy_ms * 100:5.1f}"
                f" % of busy  {name[:70]}")

    def dev_us(evt):
        return getattr(evt, "self_device_time_total",
                       getattr(evt, "self_cuda_time_total", 0.0))
    ops = sorted((e for e in prof.key_averages()
                  if e.device_type == DeviceType.CPU and dev_us(e) > 0
                  and e.key != "Command Buffer Full"),
                 key=dev_us, reverse=True)
    total_ms = sum(dev_us(e) for e in ops) / 1e3
    for e in ops[:top]:
        ms = dev_us(e) / 1e3
        log(f"    {ms:9.3f} ms {ms / total_ms * 100:5.1f} % x{e.count:<5d} "
            f"{e.key[:70]}")


def compare(label: str, got, want, tol, failures: list) -> float:
    """Max relative gap of ``got`` (any device) against ``want``; a miss
    of ``tol`` is recorded in ``failures`` and raised at the phase's end,
    so that one run prints every gap."""
    g = got.detach().double().cpu()
    w = want.detach().double().cpu()
    same_inf = torch.equal(torch.isinf(g), torch.isinf(w))
    fin = torch.isfinite(w)
    gap = ((g[fin] - w[fin]).abs() / w[fin].abs().clamp_min(1e-300)
           ).max().item() if fin.any() else 0.0
    ok = same_inf and torch.allclose(g[fin], w[fin], **tol)
    log(f"  {'ok ' if ok else 'BAD'} {label}: max rel gap {gap:.3e}"
        f"{'' if same_inf else ' (inf pattern differs)'}")
    if not ok:
        failures.append(label)
    return gap


def raise_failures(phase: str, failures: list) -> None:
    if failures:
        raise AssertionError(f"{phase}: {', '.join(failures)} outside "
                             "tolerance")


def linearity_phases(dev, t_np, vals_np, stds_np) -> dict:
    """Phases 8-11: the linearity analysis and the calibration.  Returns
    phase 10's warm config-4 solve (ICRF, final energies)."""
    from camera_linearity_tpu_torch import CameraConfig
    from camera_linearity_tpu_torch.models import calibration as cal
    from camera_linearity_tpu_torch.models.exposure_series import \
        ExposureSeries
    from camera_linearity_tpu_torch.models.image_set import ImageSet
    from camera_linearity_tpu_torch.models.scipy_strict import \
        reference_energy
    from camera_linearity_tpu_torch.ops import linearity as lin
    from camera_linearity_tpu_torch.utils.state import (
        channel_stacks_from_numpy, measurand_from_numpy, pca_from_numpy)

    def profile_generation(label, energy_fn, data):
        """One DE generation of C solvers of 75 members in [-1, 1]^5 under
        ``energy_fn``, profiled."""
        gens = [torch.Generator(dev).manual_seed(7 + c) for c in range(C)]
        pop0 = torch.as_tensor(np.stack([
            cal.sobol_init_population(75, 5, 7 + c) for c in range(C)]),
            device=dev, dtype=data[0].dtype)

        def energy(pop):
            return energy_fn(pop * 2.0 - 1.0, *data)
        state = cal._State(pop0, energy(pop0), torch.tensor(0, device=dev),
                           torch.zeros(C, dtype=torch.bool, device=dev),
                           torch.full((C,), 1000, device=dev))
        profile_breakdown(f"one generation, {label}", lambda: cal._generation(
            state, energy, gens, (0.0, 1.95), 0.4, 0.0, 0.0))

    # --- phase 8: the linearity analysis at config-2 size ------------------
    log("phase 8: process_linearity + collect_exposure_pair_stats "
        f"(config 2: {N} x {H} x {W} x {C}), card against CPU f32")

    def series(device):
        return ExposureSeries(input_image_sets=[
            ImageSet(f"{ms}ms BF sample 50x.tif", device=device,
                     measurand=measurand_from_numpy(
                         vals_np[e], stds_np[e], device=device,
                         dtype=torch.float32))
            for e, ms in enumerate(EXPOSURES_MS)])

    failures = []
    for use_std in (True, False):
        got_series, cpu_series = series(dev), series("cpu")
        got_series.process_linearity(use_std=use_std)
        got = got_series.collect_exposure_pair_stats()
        cpu_series.process_linearity(use_std=use_std)
        want = cpu_series.collect_exposure_pair_stats()
        log(f"  use_std={use_std}: {len(got_series.exposure_pairs)} pairs")
        for kind, g, w in (("abs", got[0], want[0]), ("rel", got[1], want[1])):
            for key in ("means", "stds", "errors"):
                if w[key] is None:
                    if g[key] is not None:
                        failures.append(f"{kind} {key} not None")
                    continue
                shape = np.shape(g[key])
                if shape != (len(got_series.exposure_pairs), C) or \
                        not np.isfinite(g[key]).all():
                    failures.append(f"{kind} {key} shape {shape} or "
                                    "non-finite")
                compare(f"use_std={use_std} {kind} {key}",
                        torch.as_tensor(g[key]), torch.as_tensor(w[key]),
                        STATS_TOL, failures)
        ms = host_ms(lambda: (got_series.process_linearity(use_std=use_std),
                              got_series.collect_exposure_pair_stats()),
                     runs=5, warmup=1)
        log(f"  process_linearity + collect, use_std={use_std}: {ms:.3f} ms "
            "(host clock, median of 5)")
        del got_series, cpu_series
    raise_failures("phase 8", failures)

    # --- phase 9: every energy form, card f32 against CPU f64 --------------
    p_crop, s_cand, n_pairs = 32768, 75, N * (N - 1) // 2
    log(f"phase 9: energies on a {p_crop}-pixel crop, {C} channels, {N} "
        f"exposures, S = {s_cand} candidates; card f32 against CPU f64")
    dn_full = np.round(vals_np * 255).astype(np.int32).reshape(
        N, H * W, C).transpose(2, 1, 0)                       # (C, P, N)
    std_full = stds_np.reshape(N, H * W, C).transpose(2, 1, 0)
    mean_icrf, pca = gamma_basis()
    rng = np.random.default_rng(SEED + 9)
    # 40 gamma curves, feasible, and 35 members of a DE population's
    # first generation, most of them infeasible
    x = np.linspace(0, 1, 256)
    curves = np.concatenate([
        x ** rng.uniform(1.6, 3.0, (C, 40, 1)),
        mean_icrf + rng.uniform(-1, 1, (C, s_cand - 40, 5)) @ pca.T],
        axis=1)                                               # (C, S, dp)
    pinned = lin.pin_endpoints(torch.as_tensor(curves))
    infeasible = lin.monotonicity_penalty_mask(pinned)
    log(f"  infeasible candidates: {int(infeasible.sum())} of "
        f"{infeasible.numel()}")
    if infeasible.all() or not infeasible.any():
        raise AssertionError("phase 9 needs feasible and infeasible "
                             "candidates")
    ii, jj = lin.upper_triangle_pairs(N)
    t_exp = np.asarray(t_np, float)

    def inputs(device, dtype):
        return (torch.as_tensor(curves, device=device, dtype=dtype),
                torch.as_tensor(dn_full[:, :p_crop], device=device),
                torch.as_tensor(std_full[:, :p_crop], device=device,
                                dtype=dtype),
                torch.as_tensor(t_exp, device=device, dtype=dtype))
    g_c, g_dn, g_std, g_t = inputs(dev, torch.float32)
    c_c, c_dn, c_std, c_t = inputs("cpu", torch.float64)
    failures = []
    g_h = lin.pair_dn_histograms(g_dn, ii, jj, 256)
    c_h = lin.pair_dn_histograms(c_dn, ii, jj, 256)
    if not torch.equal(g_h.cpu(), c_h):
        failures.append("pair_dn_histograms not equal")
    log(f"  {'ok ' if torch.equal(g_h.cpu(), c_h) else 'BAD'} "
        f"pair_dn_histograms {tuple(g_h.shape)} equal, "
        f"{int(c_h.sum())} counts")
    for penalty in ("soft", "hard"):
        for w_std in (True, False):
            want = lin.population_linearity_energies_chunked(
                c_c, c_dn, c_std if w_std else None, c_t, 5, 250, ii, jj,
                penalty=penalty, chunk=8192)
            got = lin.population_linearity_energies(
                g_c, g_dn, g_std if w_std else None, g_t, 5, 250, ii, jj,
                penalty=penalty)
            compare(f"onehot (whole stack), {penalty}, std={w_std}", got,
                    want, ENERGY_TOL, failures)
            got = lin.population_linearity_energies_chunked(
                g_c, g_dn, g_std if w_std else None, g_t, 5, 250, ii, jj,
                penalty=penalty, chunk=10007)
            compare(f"chunked (chunk 10007), {penalty}, std={w_std}", got,
                    want, ENERGY_TOL, failures)
            if not w_std:
                got = lin.population_linearity_energies_hist(
                    g_c, g_h, g_t, 5, 250, ii, jj, penalty=penalty)
                compare(f"hist, {penalty}", got, want, ENERGY_TOL, failures)
    feasible = curves[~infeasible.numpy()].reshape(-1, 256)[:C]  # (C, dp)

    def smooth(c, h, t):
        leaf = c.clone().requires_grad_(True)
        e = lin.linearity_energy_hist_smooth(leaf, h, t, 5, 250, ii, jj)
        grad, = torch.autograd.grad(e.sum(), leaf)
        return e.detach(), grad
    g_e, g_g = smooth(torch.as_tensor(feasible, device=dev,
                                      dtype=torch.float32), g_h, g_t)
    c_e, c_g = smooth(torch.as_tensor(feasible), c_h, c_t)
    compare("smooth energy", g_e, c_e, ENERGY_TOL, failures)
    scale = c_g.abs().max().item()
    gap = ((g_g.double().cpu() - c_g).abs().max() / scale).item()
    log(f"  smooth energy gradient: max |card - CPU| / max |grad| = "
        f"{gap:.3e} (max |grad| {scale:.3e})")
    compare("smooth energy gradient", g_g, c_g, ENERGY_TOL, failures)
    del g_c, g_dn, g_std, c_c, c_dn, c_std
    raise_failures("phase 9", failures)

    # --- phase 10: the config-4 solve -----------------------------------
    stacks, exposures, mean4, pca4 = config4_problem()
    log(f"phase 10: config-4 ICRF solve ({stacks.shape[0]} channels, "
        f"{stacks.shape[1]} pixels, {stacks.shape[2]} exposures, popsize "
        "15, maxiter 1000, tol 0.01, seed 7, default refinement and "
        "polish)")
    if torch.get_float32_matmul_precision() != "highest" or \
            torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 is on: the ICRF matvec must run in "
                             "full float32")
    stages = []
    solver = cal.differential_evolution_batched

    def recording_solver(*args, **kwargs):
        res, frozen = solver(*args, **kwargs)
        stages.append((res.n_iter, frozen.tolist()))
        return res, frozen
    cal.differential_evolution_batched = recording_solver
    cfg4 = CameraConfig(num_of_chs=3, datapoints=256)
    channel_stacks = channel_stacks_from_numpy(stacks, None, exposures,
                                               device=dev)
    pca_t, mean_t = pca_from_numpy(np.stack([pca4] * 3),
                                   np.stack([mean4] * 3), device=dev)

    def solve4():
        out = cal.calibration(-1.0, 1.0, channel_stacks=channel_stacks,
                              pca_arrays=pca_t, mean_icrf_arrays=mean_t,
                              config=cfg4, popsize=15, maxiter=1000,
                              tol=0.01, rng_seed=7, return_params=True)
        torch.cuda.synchronize()
        return out
    t0 = time.perf_counter()
    solve4()
    cold_s = time.perf_counter() - t0
    stages.clear()
    t0 = time.perf_counter()
    icrf4, e_init, e_final, _, params4 = solve4()
    warm_s = time.perf_counter() - t0
    log(f"  cold {cold_s:.4f} s, warm {warm_s:.4f} s (host clock, the whole "
        "calibration() call)")
    for name, (nit, frozen) in zip(("global", "refine 1", "refine 2"),
                                   stages):
        log(f"  {name}: {nit} generations, channels froze at {frozen}")
    log(f"  energies: initial {e_init.tolist()}, final {e_final.tolist()}")
    failures = []
    x = np.linspace(0, 1, 256)
    for c, gamma in enumerate(CAL_GAMMAS):
        oracle = reference_energy(params4[c], mean4, pca4,
                                  stacks[c][:, None, :], None, 5, 250, True,
                                  exposures, 256)
        err = np.max(np.abs(icrf4[:, c] - x ** gamma))
        rel = abs(e_final[c] - oracle) / oracle
        log(f"  channel {c}: final {e_final[c]:.8f}, oracle {oracle:.8f} "
            f"(rel gap {rel:.2e}), max |icrf - x**{gamma}| {err:.4f}")
        if not rel <= ORACLE_RTOL:
            failures.append(f"channel {c} energy against the oracle")
        if not e_final[c] < e_init[c]:
            failures.append(f"channel {c} energy did not fall")
        if not err < CURVE_ATOL:
            failures.append(f"channel {c} curve")
    raise_failures("phase 10", failures)
    g_ii = torch.as_tensor(ii, device=dev).long()
    g_jj = torch.as_tensor(jj, device=dev).long()
    profile_generation(
        "whole-stack form (config 4)",
        cal._make_population_energy(True, "soft", 5, 250, 256, False),
        (pca_t, mean_t, channel_stacks[0], channel_stacks[2], g_ii, g_jj))

    # --- phase 11: full resolution at config-2 geometry -------------------
    log(f"phase 11: calibration at full resolution ({C} x {H * W} pixels x "
        f"{N} exposures)")
    made = []
    factories = {name: getattr(cal, name) for name in (
        "_make_population_energy", "_make_population_energy_hist",
        "_make_population_energy_chunked")}
    for name, factory in factories.items():
        def recorder(*args, _name=name, _fn=factory):
            made.append(_name)
            return _fn(*args)
        setattr(cal, name, recorder)
    cfg2 = CameraConfig(num_of_chs=C, datapoints=256)
    full = dict(pca_arrays=pca_t, mean_icrf_arrays=mean_t, config=cfg2)
    stacks_u = channel_stacks_from_numpy(dn_full, None, t_exp, device=dev)
    stages.clear()
    t0 = time.perf_counter()
    _, e0_u, e1_u, _ = cal.calibration(-1.0, 1.0, channel_stacks=stacks_u,
                                       **full)
    torch.cuda.synchronize()
    wall_u = time.perf_counter() - t0
    log(f"  unweighted, energy_form auto -> {made}: {wall_u:.4f} s "
        f"(histogram build included); generations per stage "
        f"{[n for n, _ in stages]}; energies {e0_u.tolist()} -> "
        f"{e1_u.tolist()}")
    # the first energy made is the DE objective; the polish makes the
    # histogram form again for its acceptance test
    failures = []
    if made[0] != "_make_population_energy_hist":
        failures.append(f"auto picked {made[0]}, not the histogram form")
    if not np.all(e1_u < e0_u):
        failures.append("unweighted energies did not fall")
    stacks_w = channel_stacks_from_numpy(dn_full, std_full, t_exp,
                                         device=dev)
    made.clear()
    stages.clear()
    t0 = time.perf_counter()
    _, e0_w, e1_w, _ = cal.calibration(
        -1.0, 1.0, channel_stacks=stacks_w, energy_form="chunked",
        maxiter=10, tol=0.0, refine_rounds=0, polish_steps=0, **full)
    torch.cuda.synchronize()
    wall_w = time.perf_counter() - t0
    gens = stages[0][0]
    log(f"  std-weighted, chunked: {wall_w:.4f} s for {gens} generations "
        f"and the initial energies, {wall_w / (gens + 1) * 1e3:.1f} ms per "
        f"generation; energies {e0_w.tolist()} -> {e1_w.tolist()}")
    if made != ["_make_population_energy_chunked"] or \
            not np.all(e1_w <= e0_w):
        failures.append(f"std-weighted solve: {made}, {e0_w} -> {e1_w}")
    raise_failures("phase 11", failures)
    cal.differential_evolution_batched = solver
    for name, factory in factories.items():
        setattr(cal, name, factory)

    # one generation of each form under the profiler
    hists = lin.pair_dn_histograms(stacks_u[0], ii, jj, 256)
    profile_generation(
        "hist (unweighted)",
        cal._make_population_energy_hist(True, "soft", 5, 250, 256),
        (pca_t, mean_t, hists, stacks_u[2], g_ii, g_jj))
    profile_generation(
        "chunked (std-weighted)",
        cal._make_population_energy_chunked(True, "soft", 5, 250, 256,
                                            True, 16384),
        (pca_t, mean_t, stacks_w[0], stacks_w[2], g_ii, g_jj, stacks_w[1]))
    del stacks_u, stacks_w, hists
    return {"config4": (icrf4, e_final)}


def write_rgba_avi(path, frames_rgba, height: int, width: int) -> None:
    """An AVI of ``RGBA`` frames as ``cv2.VideoWriter_fourcc(*"RGBA")``
    writes one: one video stream, one movi LIST of ``00dc`` chunks of
    H * W * 4 top-down bytes (R, G, B, A); no index (the port's reader
    walks the chunks)."""
    n, frame_bytes = len(frames_rgba), height * width * 4

    def chunk(fourcc, payload):
        return struct.pack("<4sI", fourcc, len(payload)) + payload
    avih = struct.pack("<14I", 33333, frame_bytes * 30, 0, 0x10, n, 0, 1,
                       frame_bytes, width, height, 0, 0, 0, 0)
    strh = struct.pack("<4s4sIHHIIIIIIII4h", b"vids", b"RGBA", 0, 0, 0, 0, 1,
                       30, 0, n, frame_bytes, 0xFFFFFFFF, 0, 0, 0, width,
                       height)
    strf = struct.pack("<IiiHH4sIiiII", 40, width, height, 1, 32, b"RGBA",
                       frame_bytes, 0, 0, 0, 0)
    hdrl = chunk(b"LIST", b"hdrl" + chunk(b"avih", avih) + chunk(
        b"LIST", b"strl" + chunk(b"strh", strh) + chunk(b"strf", strf)))
    movi_size = 4 + n * (8 + frame_bytes)
    with open(path, "wb") as f:
        f.write(struct.pack("<4sI4s", b"RIFF", 4 + len(hdrl) + 8 + movi_size,
                            b"AVI "))
        f.write(hdrl)
        f.write(struct.pack("<4sI4s", b"LIST", movi_size, b"movi"))
        for frame in frames_rgba:
            f.write(struct.pack("<4sI", b"00dc", frame_bytes))
            f.write(memoryview(frame).cast("B"))


def yuv_planes(bgr, vs: int = 1, hs: int = 1):
    """Limited-range BT.601 Y, U, V planes (uint8, on the host) of a (H, W,
    3) BGR uint8 tensor of even H and W: the integer formula (66 R + 129 G
    + 25 B + 128) >> 8 + 16 and its chroma pair, the chroma averaged over
    each 2 x 2 block (``vs`` 1: 4:2:0) or each pair across (``vs`` 0:
    4:2:2), rounding, or at full size (``vs`` and ``hs`` 0: 4:4:4)."""
    x = bgr.to(torch.int32)
    b, g, r = x[..., 0], x[..., 1], x[..., 2]
    y = ((66 * r + 129 * g + 25 * b + 128) >> 8) + 16
    h, w = y.shape
    out = [y]
    for c in ((-38 * r - 74 * g + 112 * b + 128) >> 8) + 128, \
            ((112 * r - 94 * g - 18 * b + 128) >> 8) + 128:
        blocks = c.view(h >> vs, 1 << vs, w >> hs, 1 << hs).sum((1, 3))
        n = 1 << (vs + hs)
        out.append((blocks + n // 2) // n)
    return [p.to(torch.uint8).cpu().numpy() for p in out]


def config5_content(dev):
    """The distinct frames of BASELINE config 5's exposure videos, as
    ``benchmarks/bench_video.py`` makes them (a uniform base x exposure x
    230 plus N(0, 6) noise, clipped to uint8), generated on the card from
    seed 42: for each exposure, MJPG_POOL RGBA frames (host arrays) and
    the same frames as I420 chunks at full size and as CROP_ROWS-row
    crops (``yuv_planes``)."""
    from tests._torch_rawvideo_writer import encode_frame
    gen = torch.Generator(device=dev).manual_seed(42)
    base = torch.rand((H5, W5, 3), generator=gen, device=dev)
    rgba = torch.full((H5, W5, 4), 255, dtype=torch.uint8, device=dev)
    content = []
    for ms in EXPOSURES5_MS:
        level = (base * (ms / max(EXPOSURES5_MS)) * 230).clamp(0, 255)
        hosts, i420, i420_crop = [], [], []
        for _ in range(MJPG_POOL):
            bgr = (level + 6 * torch.randn((H5, W5, 3), generator=gen,
                                           device=dev)).clamp(0, 255).to(
                torch.uint8)
            rgba[..., :3] = bgr.flip(-1)
            hosts.append(rgba.to("cpu", copy=True).numpy())
            y, u, v = yuv_planes(bgr)
            i420.append(encode_frame("I420", (y, u, v)))
            i420_crop.append(encode_frame("I420", (
                y[:CROP_ROWS], u[:CROP_ROWS // 2], v[:CROP_ROWS // 2])))
        content.append((hosts, i420, i420_crop))
    return content


def make_videos(directory, content):
    """Config 5's exposure videos from ``content`` (:func:`config5_content`:
    MJPG_POOL distinct frames a video, cycled to FRAMES5, as the MJPG
    videos cycle them), written as raw RGBA AVIs: ``scene <ms>ms.avi`` at
    full size and ``crop <ms>ms.avi`` of their first CROP_ROWS rows; and
    the same frames as I420 AVIs in the layout ``cv2.VideoWriter(fourcc
    "I420")`` writes (``i420 scene <ms>ms.avi`` and ``i420 crop
    <ms>ms.avi``).  Returns the RGBA path lists, each exposure's (frames,
    CROP_ROWS, W, 3) BGR crop for the NumPy oracle, its first MJPG_POOL
    frames (BGR) for the MJPG videos and the I420 path lists."""
    from tests._torch_rawvideo_writer import write_raw_avi
    paths, crop_paths, crops, pools = [], [], [], []
    i420_paths, i420_crop_paths = [], []
    for ms, (hosts, i420_d, i420_crop_d) in zip(EXPOSURES5_MS, content):
        cycle = lambda frames: [frames[i % MJPG_POOL]  # noqa: E731
                                for i in range(FRAMES5)]
        full = cycle(hosts)
        crop = cycle([h[:CROP_ROWS].copy() for h in hosts])
        for name, frames, rows, out in (("scene", full, H5, paths),
                                        ("crop", crop, CROP_ROWS,
                                         crop_paths)):
            out.append(directory / f"{name} {ms}ms.avi")
            write_rgba_avi(out[-1], frames, rows, W5)
        for name, frames, rows, out in (
                ("i420 scene", cycle(i420_d), H5, i420_paths),
                ("i420 crop", cycle(i420_crop_d), CROP_ROWS,
                 i420_crop_paths)):
            out.append(directory / f"{name} {ms}ms.avi")
            write_raw_avi(out[-1], frames, rows, W5, "I420")
        crops.append(np.stack(crop)[..., 2::-1])
        pools.append(np.stack([f[..., 2::-1] for f in hosts]))
    return paths, crop_paths, crops, pools, (i420_paths, i420_crop_paths)


def config5_prework(out: str) -> None:
    """:class:`Config5Prework`'s work, in a spawned process of its own at
    niceness 10 (it takes the cores the phases before phase 12 leave
    idle): read config 5's content (:func:`config5_content`, written by
    the smoke at its start), write its videos into ``out`` as phase 12
    does (:func:`make_videos`) and code what phase 12 would code from
    them, into the same ``build/`` caches (each keyed by the frames, the
    writers' sources and the settings): the MJPG videos of every
    MJPG_VARIANTS mode, 14 (c)-(f)'s lossless videos, 14 (g)/(h)'s MPEG-4
    videos and 14 (j)'s H.264 videos, with a plain pool of its own.  Phase
    12 then finds them there.  Writes ``done.json`` (each step's seconds)
    last, and removes the videos."""
    import json
    import shutil
    from concurrent.futures import ThreadPoolExecutor
    from camera_linearity_tpu_torch.utils.general import set_thread_priority
    set_thread_priority(10)
    out = Path(out)
    t0 = time.perf_counter()
    with np.load(out / "content.npz") as z:
        content = [([z[f"rgba{e}_{i}"] for i in range(MJPG_POOL)],
                    [z[f"i420{e}_{i}"].tobytes() for i in range(MJPG_POOL)],
                    [z[f"crop{e}_{i}"].tobytes() for i in range(MJPG_POOL)])
                   for e in range(len(EXPOSURES5_MS))]
    directory = out / "videos"
    directory.mkdir(parents=True, exist_ok=True)
    paths, _, _, pools, (i420_paths, _) = make_videos(directory, content)
    del content
    t1 = time.perf_counter()
    pool = plain_pool()
    lossless = LosslessVideos(paths, i420_paths)
    mpeg4 = Mpeg4Videos(i420_paths)
    h264 = H264Videos(i420_paths)
    with ThreadPoolExecutor(len(MJPG_VARIANTS)) as mjpg:
        futures = [mjpg.submit(make_mjpg_videos, pools if variant in (
            "420", "gray") else pools[-1:], pool, variant)
            for variant in MJPG_VARIANTS]
        lossless.submit(pool)
        mpeg4.submit()
        h264.submit()
        for f in futures:
            f.result()
        t2 = time.perf_counter()
        lossless.finish()
        mpeg4.finish()
        h264.finish()
    pool.shutdown()
    shutil.rmtree(directory, ignore_errors=True)
    (out / "content.npz").unlink(missing_ok=True)
    done = {"videos_s": t1 - t0, "mjpg_s": t2 - t1,
            "codecs_s": time.perf_counter() - t1,
            "lossless_s": lossless.encode_s, "mpeg4_s": mpeg4.encode_s,
            "h264_s": h264.encode_s}
    tmp = out / f"done.tmp{os.getpid()}"
    tmp.write_text(json.dumps(done))
    os.replace(tmp, out / "done.json")


class Config5Prework:
    """Config 5's videos coded from the smoke's start
    (:func:`config5_prework`, in a spawned process of its own), so that
    phase 12's MJPEG part and plain-decode window find them in their
    caches.  ``content`` is :func:`config5_content`'s, which phase 12
    writes its videos from too.  :meth:`result` waits for the process and
    returns its seconds and the wait."""

    def __init__(self, content):
        import multiprocessing
        self.dir = ROOT / "build" / "chip_smoke_prework" / str(os.getpid())
        self.dir.mkdir(parents=True, exist_ok=True)
        arrays = {}
        for e, (hosts, i420, crop) in enumerate(content):
            for i in range(MJPG_POOL):
                arrays[f"rgba{e}_{i}"] = hosts[i]
                arrays[f"i420{e}_{i}"] = np.frombuffer(i420[i], np.uint8)
                arrays[f"crop{e}_{i}"] = np.frombuffer(crop[i], np.uint8)
        np.savez(self.dir / "content.npz", **arrays)
        # not a daemon: it has a process pool of its own
        self.proc = multiprocessing.get_context("spawn").Process(
            target=config5_prework, args=(str(self.dir),))
        self.proc.start()

    def result(self) -> dict:
        import json
        import shutil
        t0 = time.perf_counter()
        self.proc.join()
        waited = time.perf_counter() - t0
        if self.proc.exitcode != 0:
            raise AssertionError("config 5's videos coded from the smoke's "
                                 f"start: exit code {self.proc.exitcode}")
        got = json.loads((self.dir / "done.json").read_text())
        shutil.rmtree(self.dir, ignore_errors=True)
        got["waited_s"] = waited
        return got


def raw_layout_chunks(bgr_host, bgr_dev):
    """One 4K frame of the smoke's content in each layout of the port's
    rawvideo reader, as their writers store it: layout -> (chunk,
    bottom-up, palette).  BI_RGB at 8 bits (the green channel through a
    palette that is not the identity), 16 and 24 bits bottom-up as camera
    SDKs write them, 32 bits top-down; gray8 the green channel; the YUV
    layouts from ``yuv_planes`` (yuv444p, the planes of a Ut Video ULY4
    frame, which no rawvideo fourcc carries, at full chroma size)."""
    from tests._torch_rawvideo_writer import encode_frame
    b, g, r = (bgr_host[..., k].astype(np.uint16) for k in range(3))
    i = np.arange(256, dtype=np.uint16)
    palette = np.stack([i, 255 - i, (i * 7) & 255, 0 * i], -1).astype(
        np.uint8)
    y, u, v = yuv_planes(bgr_dev)
    y2, u2, v2 = yuv_planes(bgr_dev, vs=0)
    planes444 = np.concatenate([c.reshape(-1) for c in yuv_planes(
        bgr_dev, vs=0, hs=0)]).tobytes()
    green = np.ascontiguousarray(bgr_host[..., 1])
    dib = lambda frame, bits, bottom_up=True: encode_frame(  # noqa: E731
        "DIB", frame, bits, top_down=not bottom_up)
    return {
        "pal8": (dib(green, 8), True, palette),
        "rgb555": (dib((r >> 3) << 10 | (g >> 3) << 5 | b >> 3, 16), True,
                   None),
        "bgr24": (dib(bgr_host, 24), True, None),
        "bgr0": (dib(np.concatenate([bgr_host, bgr_host[..., :1]], -1),
                     32, False), False, None),
        "gray8": (encode_frame("Y800", green), False, None),
        "i420": (encode_frame("I420", (y, u, v)), False, None),
        "yv12": (encode_frame("YV12", (y, u, v)), False, None),
        "nv12": (encode_frame("NV12", (y, u, v)), False, None),
        "yuyv422": (encode_frame("YUY2", (y2, u2, v2)), False, None),
        "uyvy422": (encode_frame("UYVY", (y2, u2, v2)), False, None),
        "yuv444p": (planes444, False, None),
    }


def moments_oracle(frames_u8):
    """(mean, std of the mean) of uint8 frames in float64, by the
    operations of the fused native finalize (HostMoments)."""
    n = float(len(frames_u8))
    s = frames_u8.astype(np.float64).sum(0)
    q = (frames_u8.astype(np.float64) ** 2).sum(0)
    scale = 1.0 / 255
    m2 = np.maximum((q - s * s / n) * (scale * scale), 0.0)
    return s / n * scale, np.sqrt(m2 / (n - 1.0)) / np.sqrt(n)


def max_gap(got, want) -> float:
    return float(np.max(np.abs(np.asarray(got, np.float64)
                               - np.asarray(want, np.float64))))


def check_gap(label, got, want, atol, failures, rtol=0.0):
    """|got - want| <= atol + rtol |want| everywhere; prints the largest
    difference."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    gap = np.abs(got - want)
    ok = bool(np.all(gap <= atol + rtol * np.abs(want)))
    log(f"  {'ok ' if ok else 'BAD'} {label}: max abs diff {gap.max():.3e}"
        f" (atol {atol:.3e}{f', rtol {rtol:.3e}' if rtol else ''})")
    if not ok:
        failures.append(label)


# the MJPG frame modes beside cv2.VideoWriter's 4:2:0: name -> the writer's
# (sampling, progressive), grayscale being the frames' green channel
MJPG_VARIANTS = {"420": ("420", False), "gray": ("420", False),
                 "411": ("411", False), "440": ("440", False),
                 "progressive": ("420", True)}


def encode_mjpg_frame(frame, sampling: str, progressive: bool) -> bytes:
    """One frame of :func:`make_mjpg_videos`, in a process of the plain
    pool (the writer holds the GIL)."""
    from tests import _torch_mjpeg_writer as writer
    return writer.encode_jpeg(frame, MJPG_QUALITY, sampling,
                              progressive=progressive)


def make_mjpg_videos(pools, procs, variant: str = "420"):
    """Config 5's exposure videos as MJPG AVIs, written by the NumPy writer
    of ``tests/_torch_mjpeg_writer.py`` (a frame a task of ``procs``, the
    plain pool) as ``cv2.VideoWriter`` writes them
    (4:2:0, one quantization table, no DRI), or in another frame mode of
    MJPG_VARIANTS: each exposure's MJPG_POOL distinct frames (``pools``,
    BGR) cycled to FRAMES5, as ``benchmarks/bench_video.py:59-66`` cycles
    its pool, at full size and as MJPG_CROP_ROWS-row crops.  Cached under
    ``build/`` by the frames' bytes, the variant and the writer's source.
    Returns (paths, crop paths, seconds spent encoding, or None when the
    cache had them)."""
    import hashlib
    from tests import _torch_mjpeg_writer as writer

    sampling, progressive = MJPG_VARIANTS[variant]
    gray = variant == "gray"
    key = hashlib.md5(usedforsecurity=False)
    key.update(Path(writer.__file__).read_bytes())
    key.update(f"{MJPG_QUALITY} {FRAMES5} {MJPG_CROP_ROWS}".encode())
    if variant != "420":
        key.update(variant.encode())
    for pool in pools:
        key.update(np.ascontiguousarray(pool).data)
    cache = ROOT / "build" / "chip_smoke_mjpg" / key.hexdigest()[:12]
    exposures = EXPOSURES5_MS[-len(pools):]
    paths = [cache / f"mjpg scene {ms}ms.avi" for ms in exposures]
    crop_paths = [cache / f"mjpg crop {ms}ms.avi" for ms in exposures]
    if all(p.exists() for p in paths + crop_paths):
        return paths, crop_paths, None
    t0 = time.perf_counter()
    cache.mkdir(parents=True, exist_ok=True)
    jobs = [f for pool in pools for f in pool] + \
        [f[:MJPG_CROP_ROWS] for pool in pools for f in pool]
    futures = [procs.submit(encode_mjpg_frame, np.ascontiguousarray(
        f[..., 1] if gray else f), sampling, progressive) for f in jobs]
    coded = [f.result() for f in futures]
    full, crop = coded[:len(coded) // 2], coded[len(coded) // 2:]
    for e in range(len(pools)):
        for out, frames, rows in ((paths[e], full, H5),
                                  (crop_paths[e], crop, MJPG_CROP_ROWS)):
            own = frames[e * MJPG_POOL:(e + 1) * MJPG_POOL]
            tmp = out.with_suffix(f".tmp{os.getpid()}")
            writer.write_mjpg_avi(
                tmp, [own[i % MJPG_POOL] for i in range(FRAMES5)], rows, W5)
            os.replace(tmp, out)
    return paths, crop_paths, time.perf_counter() - t0


def plain_crop_frames(crop_path, mode: str):
    """The first CROP_ROWS rows of every frame of an MJPG crop video, as
    ``native/jpeg_plain.py`` decodes them in ``mode``: the NumPy oracle's
    input.  Each distinct payload is decoded once."""
    from camera_linearity_tpu_torch.native import jpeg_plain
    from camera_linearity_tpu_torch.utils import avi
    decoded, frames = {}, []
    for payload in avi.mjpg_chunks(crop_path):
        if payload not in decoded:
            decoded[payload] = jpeg_plain.decode(payload, mode)[:CROP_ROWS]
        frames.append(decoded[payload])
    return np.stack(frames)


def rewrite_with_audio(src, dst, stream: int, codec: str) -> int:
    """Write ``src``'s frames again as ``dst``, the video as AVI stream
    ``stream`` behind as many 8 kHz PCM audio streams, the first of them
    with odd-sized chunks (267 bytes a frame at 30 fps, padded to a word),
    all interleaved with the frames.  ``codec`` is ``"MJPG"`` or
    ``"I420"``.  Returns the frame count."""
    from camera_linearity_tpu_torch.utils import avi
    from tests._torch_mjpeg_writer import write_mjpg_avi
    from tests._torch_rawvideo_writer import pcm_stream, write_raw_avi
    if codec == "MJPG":
        frames = list(avi.mjpg_chunks(src))
    else:
        frames = [c.tobytes() for c in avi.raw_chunks(src,
                                                      avi.probe_avi(src))]
    audio = [pcm_stream([267 if k == 0 else 266] * len(frames), seed=k)
             for k in range(stream)]
    if codec == "MJPG":
        write_mjpg_avi(dst, frames, H5, W5, stream=stream, others=audio)
    else:
        write_raw_avi(dst, frames, H5, W5, "I420", stream=stream,
                      others=audio)
    return len(frames)


def stream_phase(dev, directory, mjpg_paths, i420_paths, stream0, runs,
                 run_batch, run_video_to_hdr) -> dict:
    """Phase 14 (b): config 5 from AVIs whose video is not stream 0.
    Phase 14's MJPG videos (the default decoder's, 4:2:0) are written
    again with a PCM audio stream 0 and the video as stream 1;
    ``batch_video_to_hdr`` (K1, B = 8) and ``video_to_hdr`` (K3) on them
    equal phase 14's results on the stream-0 files bit for bit
    (``stream0``).  One I420 video is read through ``raw_chunks`` as
    stream 2, its frames held to stream 0's; ``timed(label, logger)``
    and ``timed(label, device=dev)`` are held to synchronize the card;
    and ``stage_to_device(arr, max_bytes)`` to copy in slices onto it.
    Returns the phase's times."""
    from camera_linearity_tpu_torch import native
    from camera_linearity_tpu_torch.utils import avi
    from camera_linearity_tpu_torch.utils import observability as obs
    from camera_linearity_tpu_torch.utils.general import stage_to_device
    t_phase = time.perf_counter()
    log(f"phase 14 (b): config 5 from AVIs whose video is stream 1 or 2 "
        f"(PCM audio before it); {gpu_line()}")
    failures = []
    t0 = time.perf_counter()
    s1_paths = []
    for p in mjpg_paths:
        s1_paths.append(directory / p.name.replace("mjpg", "mjpg stream 1"))
        if rewrite_with_audio(p, s1_paths[-1], 1, "MJPG") != FRAMES5:
            failures.append(f"{p.name}: frame count")
    write_s = time.perf_counter() - t0
    infos = [avi.probe_avi(p) for p in s1_paths]
    log(f"  rewrote {len(s1_paths)} MJPG videos with the video as stream 1 "
        f"in {write_s:.2f} s; probed streams {[i.stream for i in infos]}")
    if [i.stream for i in infos] != [1] * len(s1_paths):
        failures.append(f"probed streams {[i.stream for i in infos]}")

    run = run_batch(s1_paths)
    run.pop("merge")
    out = run.pop("out")
    runs["batch_video_to_hdr u16/f16 (MJPG stream 1, auto)"] = run
    same = all(torch.equal(a, b) for name, pair in out.items()
               for a, b in zip(pair, stream0["out"][name]))
    log(f"  {'ok ' if same else 'BAD'} batch_video_to_hdr, stream 1 vs "
        f"phase 14's stream 0 ({stream0['label']}): "
        f"{'bit for bit equal' if same else 'different'}, "
        f"{len(out)} scenes")
    if not same or list(out) != list(stream0["out"]):
        failures.append("batch_video_to_hdr against phase 14's stream 0")
    del out
    before = runs[stream0["label"]]
    log(f"  stream 1: wall {run['wall']:.3f} s, {run['mps']:.2f} MP/s; "
        f"phase 14 stream 0: wall {before['wall']:.3f} s, "
        f"{before['mps']:.2f} MP/s ({gpu_line()})")
    torch.cuda.empty_cache()
    v2h_s, _, got = run_video_to_hdr(s1_paths)
    same = all(torch.equal(a, b) for a, b in zip(got,
                                                 stream0["video_to_hdr"]))
    log(f"  {'ok ' if same else 'BAD'} video_to_hdr, stream 1 vs stream 0: "
        f"{'bit for bit equal' if same else 'different'}; {v2h_s:.3f} s")
    if not same:
        failures.append("video_to_hdr against phase 14's stream 0")
    del got

    # one I420 video as stream 2, read through raw_chunks
    s2 = directory / i420_paths[0].name.replace("i420", "i420 stream 2")
    rewrite_with_audio(i420_paths[0], s2, 2, "I420")
    decoded = []
    for p in (i420_paths[0], s2):
        info = avi.probe_avi(p)
        chunks = [c.copy() for c in avi.raw_chunks(p, info)]
        frames = np.empty((len(chunks), H5, W5, 3), np.uint8)
        native.raw_decode_bgr_batch(chunks, frames, info.layout,
                                    bottom_up=info.raw.bottom_up)
        decoded.append((info.stream, frames))
    (st0, f0), (st2, f2) = decoded
    same = (st0, st2) == (0, 2) and f2.shape[0] == FRAMES5 and \
        np.array_equal(f0, f2)
    log(f"  {'ok ' if same else 'BAD'} I420 read through raw_chunks as "
        f"stream {st2}: {f2.shape[0]} frames, equal to stream {st0}'s")
    if not same:
        failures.append("I420 stream 2 against stream 0")
    del decoded, f0, f2

    # timed() synchronizes the card whether it is given a logger (JAX's
    # second argument) or the device; a logger never reaches the device
    sync = torch.cuda.synchronize
    calls = []

    def counting(device=None):
        calls.append(device)
        sync(device)
    cycles = 200_000_000
    start, end = torch.cuda.Event(True), torch.cuda.Event(True)
    torch.cuda.synchronize()
    start.record()
    torch.cuda._sleep(cycles)
    end.record()
    end.synchronize()
    sleep_s = start.elapsed_time(end) / 1e3
    logger = obs.get_logger("chip_smoke.timed")
    torch.cuda.synchronize = counting
    try:
        with obs.timed("timed(label, logger)", logger) as by_logger:
            torch.cuda._sleep(cycles)
        with obs.timed("timed(label, device=dev)", device=dev) as by_device:
            torch.cuda._sleep(cycles)
    finally:
        torch.cuda.synchronize = sync
    ok = calls == [None, None, dev, dev] and min(
        by_logger["seconds"], by_device["seconds"]) >= 0.9 * sleep_s
    log(f"  {'ok ' if ok else 'BAD'} timed: synchronize called with "
        f"{calls}; a {sleep_s * 1e3:.1f} ms sleep on the card timed "
        f"{by_logger['seconds'] * 1e3:.1f} ms (logger), "
        f"{by_device['seconds'] * 1e3:.1f} ms (device)")
    if not ok:
        failures.append("timed")

    # the JAX package's stage_to_device(arr, max_bytes): chunked along
    # axis 0 onto the current device
    frames = np.random.default_rng(0).integers(
        0, 256, (FRAMES5, CROP_ROWS, W5, 3), dtype=np.uint8)
    staged = stage_to_device(frames, max_bytes=1 << 20)
    ok = staged.device == torch.device("cuda", torch.cuda.current_device()) \
        and torch.equal(staged.cpu(), torch.from_numpy(frames))
    log(f"  {'ok ' if ok else 'BAD'} stage_to_device: {frames.nbytes} bytes "
        f"in slices of at most 1 MiB onto {staged.device}, equal")
    if not ok:
        failures.append("stage_to_device")
    raise_failures("phase 14 (b)", failures)
    wall = time.perf_counter() - t_phase
    log(f"phase 14 (b): {wall:.1f} s")
    return dict(wall_s=wall, write_s=write_s, mps=run["mps"],
                batch_wall_s=run["wall"], video_to_hdr_s=v2h_s,
                stream0_mps=before["mps"], stream0_wall_s=before["wall"],
                timed_sleep_ms=sleep_s * 1e3)


# phase 12's rows of the PNG, HuffYUV, FFV1 and UtVideo decoders: one 4K
# frame of each layout (two for FFV1: a keyframe and a frame that carries
# its states) held to what cv2 gives for the picture written, and the same
# layout on a full-width strip of STRIP_ROWS rows held to its plain version
# (FFmpeg decodes no RGB HuffYUV with the median predictor: the median row
# is yuv420p's; FFV1's first three rows are cv2's own layouts, UtVideo's
# first row is what cv2's writer writes, at its 4K slice count also on the
# strip; the other UtVideo rows take FFmpeg's slice count, 18 at 4K)
STRIP_ROWS = 64
LOSSLESS_LAYOUTS = ("PNG RGB8 mixed filters", "PNG gray8",
                    "PNG RGB16 mixed filters",
                    "HFYU RGB24 gradient decorrelated", "HFYU YUY2 left",
                    "FFVH yuv420p median")
FFV1_LAYOUTS = ("FFV1 BGR (cv2: Golomb-Rice)",
                "FFV1 gray8 (cv2: Golomb-Rice)",
                "FFV1 gray16 (cv2: range coder, custom table)",
                "FFV1 yuv420p Golomb-Rice, context model 1",
                "FFV1 BGR range coder, default table, context model 1")
# name: (fourcc, predictor)
UTVIDEO_LAYOUTS = {"ULY0 as cv2 writes it (left, 9 slices)": ("ULY0", "left"),
                   "ULRG median": ("ULRG", "median"),
                   "ULY2 gradient": ("ULY2", "gradient"),
                   "ULY4 left": ("ULY4", "left")}
# name: the frames' kinds (tests/_torch_lagarith_writer.FRAME_TYPES, or
# "solid": a solid colour frame) and escape (None: the writer's choice, 1
# where zero runs pay).  The RGB24 frame has a flat band of a quarter of
# its rows, so that its planes code zero runs; RGBA's alpha is 255, a
# filled plane; the mixed stream's solid frames come between coded ones
LAGARITH_LAYOUTS = {
    "LAGS RGB24 (range coded, median, zero runs)": (("rgb24",), 1),
    "LAGS RGBA (alpha a filled plane)": (("rgba",), None),
    "LAGS YUY2": (("yuy2",), None),
    "LAGS YV12": (("yv12",), None),
    "LAGS mixed solid and coded": (("rgb24", "solid", "yv12", "solid"),
                                   None)}


def yuv_bgr(planes, layout: str, rows: int) -> np.ndarray:
    """What cv2 gives for the (Y, U, V) ``planes`` of ``layout`` (``"i420"``,
    ``"yuv422p"`` or ``"yuv444p"``) at ``rows`` x W5: the port's rawvideo
    converter, which phase 12 holds to ``rawvideo_plain.py`` (on 4K frames
    for I420 and yuv444p, and through the plain decoders' strips for
    all)."""
    from camera_linearity_tpu_torch import native
    raw = np.concatenate([np.ascontiguousarray(c).reshape(-1)
                          for c in planes])
    out = np.empty((1, rows, W5, 3), np.uint8)
    native.raw_decode_bgr_batch([raw], out, layout)
    return out[0]


def ffv1_layout(name: str, rows: int, frames_host, frames_dev):
    """FFV1 layout ``name`` at ``rows`` x W5: its writer settings, the
    pictures of the frames' first ``rows`` rows and what cv2 gives for
    them."""
    from camera_linearity_tpu_torch.native import ffv1_plain
    from tests import _torch_ffv1_writer as fw
    bgr = [f[:rows] for f in frames_host]
    if name.startswith("FFV1 gray8"):
        config = fw.cv2_config("gray8", rows, W5)
        pictures = [np.ascontiguousarray(f[..., 1]) for f in bgr]
        want = [np.repeat(p[..., None], 3, -1) for p in pictures]
    elif name.startswith("FFV1 gray16"):
        config = fw.cv2_config("gray16", rows, W5)
        pictures = [fw.to_picture(f, "gray16") for f in bgr]
        want = [np.repeat(ffv1_plain.gray16_to_8(p)[..., None], 3, -1)
                for p in pictures]
    elif name.startswith("FFV1 yuv420p"):
        config = fw.Config("yuv420p", 3, 0, 1, fw.cv2_slices(rows, W5, 1, 1))
        pictures = [yuv_planes(f[:rows]) for f in frames_dev]
        want = [yuv_bgr(p, "i420", rows) for p in pictures]
    elif "range" in name:
        config = fw.Config("bgr0", 3, 1, 1, fw.cv2_slices(rows, W5))
        pictures, want = bgr, bgr
    else:
        config = fw.cv2_config("bgr", rows, W5)
        pictures, want = bgr, bgr
    return config, pictures, want


def lossless_layout_chunks(frames_host, frames_dev, rows: int,
                           want: bool = True) -> dict:
    """The smoke's content in each of LOSSLESS_LAYOUTS, FFV1_LAYOUTS and
    UTVIDEO_LAYOUTS at ``rows`` x W5 (the first frame, and for FFV1 the
    first two), as its writer stores it: name -> (kind, chunks, the
    decoder's parameters: the PNG's ``IHDR``, the HuffYUV, FFV1 or UtVideo
    stream's; with ``want`` the frames cv2 gives for the pictures
    written).  PNG rows cycle the five filters; gray is the green channel;
    PNG RGB16 takes each channel as its high byte and the next channel as
    its low one, FFV1 gray16 the green channel and the red; the YUV
    layouts come from ``yuv_planes``; HuffYUV is interlaced at both sizes;
    FFV1 comes from the native encoder; UtVideo takes its 4K slice count
    at both sizes; Lagarith comes from the native encoder
    (``lagarith_layout_chunks``).  The layouts encode side by side, a
    thread each."""
    from concurrent.futures import ThreadPoolExecutor
    from camera_linearity_tpu_torch import native
    from camera_linearity_tpu_torch.native import png_plain
    from camera_linearity_tpu_torch.native import utvideo_plain
    from tests import _torch_ffv1_writer as fw
    from tests import _torch_huffyuv_writer as hw
    from tests import _torch_utvideo_writer as uw
    from tests._torch_png_writer import encode_png
    tasks = {}      # name -> its encode, run side by side below
    bgr = frames_host[0][:rows]
    rgb = bgr[..., ::-1]
    rgb16 = rgb.astype(np.uint16) << 8 | np.roll(rgb, -1, axis=-1)
    for name, image, ctype, depth, expect in (
            ("PNG RGB8 mixed filters", rgb, 2, 8, lambda: bgr),
            ("PNG gray8", bgr[..., 1], 0, 8,
             lambda: np.repeat(bgr[..., 1:2], 3, -1)),
            ("PNG RGB16 mixed filters", rgb16, 2, 16,
             lambda: png_plain.rgb16_to_bgr(rgb16))):
        def png(image=image, ctype=ctype, depth=depth, expect=expect):
            chunk = encode_png(image, ctype, depth, filters="mixed")
            return ("png", [chunk], png_plain.read_header(chunk),
                    [expect()] if want else None)
        tasks[name] = png
    for name, codec, layout, predictor, decorrelate, vs in (
            ("HFYU RGB24 gradient decorrelated", "HFYU", "rgb24",
             "gradient", True, None),
            ("HFYU YUY2 left", "HFYU", "yuy2", "left", False, 0),
            ("FFVH yuv420p median", "FFVH", "yuv420p", "median", False, 1)):
        def huffyuv(codec=codec, layout=layout, predictor=predictor,
                    decorrelate=decorrelate, vs=vs):
            picture = bgr if vs is None else yuv_planes(
                frames_dev[0][:rows], vs=vs)
            s = hw.make_stream(layout, predictor, decorrelate, rows, True, 2,
                               [picture])
            expect = None
            if want:
                expect = bgr if vs is None else \
                    yuv_bgr(picture, "i420" if vs else "yuv422p", rows)
            return ("huffyuv", [hw.encode_frame(picture, s)],
                    hw.stream_params(s, codec),
                    None if expect is None else [expect])
        tasks[name] = huffyuv
    for name in FFV1_LAYOUTS:
        def ffv1(name=name):
            config, pictures, expect = ffv1_layout(name, rows, frames_host,
                                                   frames_dev)
            return ("ffv1", fw.native_encode(pictures, rows, W5, config),
                    fw.stream_params(config), expect if want else None)
        tasks[name] = ffv1
    for name, (fourcc, predictor) in UTVIDEO_LAYOUTS.items():
        def utvideo(fourcc=fourcc, predictor=predictor):
            layout = utvideo_plain.LAYOUTS[fourcc]
            params = uw.stream_params(fourcc, uw.cv2_slices(layout, H5))
            if layout == "gbrp":
                picture, expect = bgr, bgr
            else:
                raw = {"yuv420p": "i420"}.get(layout, layout)
                picture = yuv_planes(frames_dev[0][:rows], *{
                    "yuv420p": (1, 1), "yuv422p": (0, 1),
                    "yuv444p": (0, 0)}[layout])
                expect = yuv_bgr(picture, raw, rows) if want else None
            chunk = uw.encode_frame(uw.to_planes(picture, layout), params,
                                    uw.PREDICTORS[predictor])
            return ("utvideo", [chunk], params, [expect] if want else None)
        tasks[name] = utvideo
    tasks["Lagarith"] = lambda: lagarith_layout_chunks(frames_host,
                                                       frames_dev, rows, want)
    # the encodes are independent: a thread each (the writers' NumPy and
    # the native encoders release the GIL); the planes' converter loads
    # first, once
    native._mjpeg()
    with ThreadPoolExecutor(os.cpu_count() or 1) as ex:
        futures = {name: ex.submit(task) for name, task in tasks.items()}
        out = {name: f.result() for name, f in futures.items()
               if name != "Lagarith"}
        out.update(futures["Lagarith"].result())
    return out


def lagarith_layout_chunks(frames_host, frames_dev, rows: int,
                           want: bool = True) -> dict:
    """LAGARITH_LAYOUTS at ``rows`` x W5, as ``lossless_layout_chunks``
    gives the others: each frame from the first frame's first ``rows``
    rows, coded by ``tests/_torch_lagarith_enc.cpp`` (the Python writer's
    bytes); the YUV planes from ``yuv_planes``."""
    from tests import _torch_lagarith_writer as lw
    bgr = frames_host[0][:rows]
    out = {}
    for name, (kinds, esc) in LAGARITH_LAYOUTS.items():
        chunks, expect = [], []
        for i, kind in enumerate(kinds):
            if kind == "solid":
                value = (17 * i, 255 - 31 * i, 99)
                chunks.append(lw.solid_frame(*value))
                expect.append(np.broadcast_to(np.array(
                    value, np.uint8), bgr.shape))
                continue
            if kind in ("rgb24", "rgba"):
                picture = bgr.copy()
                if esc:
                    picture[:rows // 4] = (40, 160, 220)
                if kind == "rgba":
                    picture = np.concatenate([picture, np.full(
                        picture.shape[:2] + (1,), 255, np.uint8)], -1)
                expect.append(picture[..., :3])
            else:
                vs = 1 if kind == "yv12" else 0
                picture = yuv_planes(frames_dev[0][:rows], vs=vs)
                if want:
                    expect.append(yuv_bgr(picture, "i420" if vs else
                                          "yuv422p", rows))
            chunks += lw.native_encode(kind, [picture], esc=esc)
        out[name] = ("lagarith", chunks, None, expect if want else None)
    return out


def lagarith_clips() -> list:
    """Phase 12's check of the committed ``tests/data/lagarith *.avi``:
    each decoded natively against its ``.cv2.npy`` (cv2's frames, taken
    where cv2 is): a line each, and the names that differ."""
    from camera_linearity_tpu_torch import native
    from camera_linearity_tpu_torch.utils import avi
    failures = []
    for clip in sorted((ROOT / "tests" / "data").glob("lagarith *.avi")):
        cv = np.load(clip.with_suffix(".cv2.npy"))
        info = avi.probe_avi(clip)
        chunks = [bytes(c) for c in avi.frame_chunks(clip, info)]
        got = np.empty((len(chunks), info.height, info.width, 3), np.uint8)
        native.lagarith_decode_bgr_batch(chunks, got)
        same = got.shape == cv.shape and np.array_equal(got, cv)
        log(f"  {'ok ' if same else 'BAD'} Lagarith decode of "
            f"'{clip.name}' ({len(cv)} x {cv.shape[1]} x {cv.shape[2]}): "
            f"{'equals' if same else 'differs from'} the committed "
            f"cv2.VideoCapture frames")
        if not same:
            failures.append(clip.name)
    return failures


def plain_decode(kind: str, chunks, spec, rows: int, width: int):
    """The plain version's frames of ``chunks`` (a spawned process)."""
    from camera_linearity_tpu_torch.native import (ffv1_plain, huffyuv_plain,
                                                   lagarith_plain, png_plain,
                                                   utvideo_plain)
    if kind == "png":
        return np.stack([png_plain.decode_bgr(c) for c in chunks])
    if kind == "lagarith":
        return np.stack([lagarith_plain.decode_bgr(c, rows, width)
                         for c in chunks])
    if kind in ("huffyuv", "utvideo"):
        plain = huffyuv_plain if kind == "huffyuv" else utvideo_plain
        return np.stack([plain.decode_bgr(c, spec, rows, width)
                         for c in chunks])
    return ffv1_plain.decode_bgr(chunks, spec, rows, width)


def lossless_layout_rows(frames_host, frames_dev, videos, mpeg4_videos,
                         strip_pictures, pool, container_videos=None,
                         mjpg_paths=(), h264_videos=None,
                         h264_plain4k=None, h264_high=None) -> dict:
    """Phase 12's PNG, HuffYUV, FFV1, UtVideo and Lagarith rows: each of
    LOSSLESS_LAYOUTS, FFV1_LAYOUTS, UTVIDEO_LAYOUTS and LAGARITH_LAYOUTS on
    a full-width STRIP_ROWS-row strip, the native decoder held to its
    plain version bit for bit (the plain versions first, a process each,
    with phase 14 (c)-(f)'s ``videos`` and the 4K frames encoded beside
    them, never beside a timed call), then on 4K frames held to what cv2
    gives for the pictures written, and timed: PNG, HuffYUV, UtVideo and
    Lagarith on one thread and over a batch of FRAMES5 on every core,
    FFV1 and Lagarith one frame on every core (a slice, or a plane, a
    thread); and the committed Lagarith clips against cv2's frames.  The
    MPEG-4 strip (:func:`mpeg4_strip` of ``strip_pictures``) is coded and
    decoded by the plain version in the pool too, and 14 (g)'s
    ``mpeg4_videos`` coded on a thread beside it; :func:`mpeg4_rows` then
    takes its rows.  So do the H.264 strip (:func:`h264_strip`) and 14
    (j)'s ``h264_videos`` (threads beside it), and :func:`h264_rows` (with
    ``h264_plain4k``, :class:`H264Plain4K`), and :func:`h264_high_rows`
    (``h264_high``, :class:`H264HighWork`).  Then 14 (i)'s
    ``container_videos``
    (:class:`ContainerVideos`) are muxed from those videos and
    ``mjpg_paths``, before any timed call; the committed container clips
    are held to cv2's frames, and the demux rows (:func:`demux_rows`)
    taken last.  Returns the rows' times."""
    from camera_linearity_tpu_torch import native
    strips = lossless_layout_chunks(frames_host, frames_dev, STRIP_ROWS,
                                    want=False)
    t0 = time.perf_counter()
    futures = {name: pool.submit(plain_decode, kind, chunks, spec,
                                 STRIP_ROWS, W5)
               for name, (kind, chunks, spec, _) in strips.items()}
    mpeg4_future = pool.submit(mpeg4_strip, strip_pictures)
    asp_future = pool.submit(mpeg4_asp_strip, strip_pictures)
    h264_future = pool.submit(h264_strip, strip_pictures) \
        if h264_videos is not None else None
    videos.submit(pool)
    mpeg4_videos.submit()
    if h264_videos is not None:
        h264_videos.submit()
    # when each of the window's jobs ended, seconds from its start (the
    # callbacks run on the jobs' threads)
    ends, ends_lock = {}, threading.Lock()

    def watch(name, futs):
        def done(_, n=name):
            with ends_lock:
                ends[n] = max(ends.get(n, 0.0), time.perf_counter() - t0)
        for f in futs or ():
            f.add_done_callback(done)
    for name, f in futures.items():
        watch(f"the plain {name} strip", [f])
    watch("the plain MPEG-4 strip", [mpeg4_future])
    watch("the plain MPEG-4 ASP strip", [asp_future])
    if h264_future is not None:
        watch("the H.264 strip (coded, plain)", [h264_future])
    for codec, futs in (getattr(videos, "_pending", None) or {}).items():
        watch(f"14 (c)-(f)'s {codec} videos", futs)
    for (k, asp), f in zip(getattr(mpeg4_videos, "jobs", ()),
                           mpeg4_videos._future or ()):
        watch(f"14 ({'h' if asp else 'g'})'s video {k}", [f])
    if h264_videos is not None:
        for k, f in enumerate(h264_videos._futures or ()):
            watch(f"14 (j)'s video {k}", [f])
    # the 4K frames are encoded here while the pool works
    t1 = time.perf_counter()
    layouts = lossless_layout_chunks(frames_host, frames_dev, H5)
    encode_s = time.perf_counter() - t1
    with ends_lock:
        ends["the 4K layouts' frames (a thread each)"] = \
            time.perf_counter() - t0
    plain = {name: f.result() for name, f in futures.items()}
    videos.finish()
    mpeg4_strip_out = mpeg4_future.result()
    asp_strip_out = asp_future.result()
    mpeg4_videos.finish()
    h264_strip_out = None
    if h264_videos is not None:
        h264_strip_out = h264_future.result()
        h264_videos.finish()
    plain_s = time.perf_counter() - t0
    with ends_lock:
        last = sorted(ends.items(), key=lambda kv: -kv[1])
    log(f"  the window ({plain_s:.1f} s): its jobs' last ends, s from its "
        f"start: " + "; ".join(f"{n} {e:.1f}" for n, e in last[:6])
        + f" ({len(ends)} jobs; the last: {last[0][0]})")
    phase_mark("the plain strips and the videos' encodes (the window)")
    remux_s = None
    if container_videos is not None:
        remux_s = container_videos.write(mpeg4_videos, videos, mjpg_paths)
    planes = np.empty(FRAMES5 * native.frame_bytes("yuv444p", H5, W5),
                      np.uint8)

    def decode(kind, spec, chunks, dst, **kw):
        if kind == "png":
            return native.png_decode_bgr_batch(chunks, dst, spec, **kw)
        if kind == "huffyuv":
            return native.huffyuv_decode_bgr_batch(chunks, dst, spec,
                                                   planes=planes, **kw)
        if kind == "utvideo":
            return native.utvideo_decode_bgr_batch(chunks, dst, spec,
                                                   planes=planes, **kw)
        if kind == "lagarith":
            return native.lagarith_decode_bgr_batch(chunks, dst,
                                                    planes=planes, **kw)
        # a decoder a sequence: FFV1 carries its states from frame to frame
        return native.ffv1_decode_bgr_batch(
            chunks, dst, native.Ffv1Decoder(spec, *dst.shape[1:3]),
            planes=planes, **kw)
    failures, rows = lagarith_clips(), {}
    if container_videos is not None:
        log(f"  phase 14 (i)'s MP4, MOV and Matroska files muxed from the "
            f"AVIs' bitstreams in {remux_s:.1f} s (tests/_torch_mp4_writer."
            f"py, tests/_torch_mkv_writer.py)")
        failures += container_clips()
    for name, (kind, chunks, spec, want) in layouts.items():
        s_kind, s_chunks, s_spec, _ = strips[name]
        strip = np.empty((len(s_chunks), STRIP_ROWS, W5, 3), np.uint8)
        decode(s_kind, s_spec, s_chunks, strip)
        plain_same = np.array_equal(strip, plain[name])
        frames = np.empty((len(chunks), H5, W5, 3), np.uint8)
        decode(kind, spec, chunks, frames)
        same = all(np.array_equal(f, w) for f, w in zip(frames, want))
        if not (same and plain_same):
            failures.append(name)
        # the decodes above warmed every call below: each is timed once
        one = frames[:1]
        serial = kind in ("ffv1", "lagarith")
        single = host_ms(lambda: decode(kind, spec, chunks[:1], one,
                                        threads=1), runs=1, warmup=0)
        one_wide = None
        if serial:
            one_wide = host_ms(lambda: decode(kind, spec, chunks[:1], one),
                               runs=1, warmup=0)
        wide = one_wide
        how = [f"{single:.1f} ms on one thread"]
        if serial:
            how.append(f"{one_wide:.1f} ms one frame on {os.cpu_count()} "
                       f"threads (a {'slice' if kind == 'ffv1' else 'plane'}"
                       " a thread)")
        if kind != "ffv1":
            many = np.empty((FRAMES5, H5, W5, 3), np.uint8)
            wide = host_ms(lambda: decode(
                kind, spec, (chunks * FRAMES5)[:FRAMES5], many),
                runs=1, warmup=0 if serial else 1) / FRAMES5
            how.append(f"{wide:.1f} ms a frame over a batch of {FRAMES5} on "
                       f"{os.cpu_count()} threads")
            del many
        rows[name] = dict(one_thread=single, all_threads=wide,
                          frame_mb=len(chunks[0]) / 1e6)
        if serial and kind != "ffv1":
            rows[name]["one_frame_all_threads"] = one_wide
        log(f"  {'ok ' if same and plain_same else 'BAD'} {name}: one 4K "
            f"frame ({len(chunks[0]) / 1e6:.3f} MB) {'; '.join(how)} (host "
            f"clock, one run); "
            f"{len(chunks)} 4K frame(s) {'equal' if same else 'differ from'}"
            f" the pictures written as cv2 gives them; the {STRIP_ROWS} x "
            f"{W5} strip {'equals' if plain_same else 'differs from'} the "
            f"plain version, max |.| {max_gap(strip, plain[name]):.0f} DN")
        del frames, strip
    log(f"  PNG, HuffYUV, FFV1, UtVideo, Lagarith: the strips decoded by "
        f"the plain versions in {plain_s:.1f} s (a spawned process each), "
        f"{len(layouts)} layouts encoded at 4K beside them in "
        f"{encode_s:.1f} s, phase 14 (c)-(f)'s videos "
        + ("from the cache" if videos.encode_s is None else
           f"encoded beside them in {videos.encode_s:.1f} s (FFV1 and "
           "Lagarith native, on threads)"))
    log("  MPEG-4 strips (Simple, Advanced Simple) coded and decoded by the "
        "plain version in the pool; 14 (g)'s and (h)'s videos " + ("from the cache" if mpeg4_videos.encode_s is
                              None else f"coded beside them in "
                              f"{mpeg4_videos.encode_s:.1f} s (native, on a "
                              "thread)"))
    raise_failures("phase 12, the PNG, HuffYUV, FFV1, UtVideo and Lagarith "
                   "decoders against their plain versions, the pictures "
                   "written and the committed clips", failures)
    phase_mark("the PNG, HuffYUV, FFV1, UtVideo and Lagarith rows")
    rows.update(mpeg4_rows(mpeg4_strip_out, asp_strip_out, mpeg4_videos))
    phase_mark("the MPEG-4 rows")
    if h264_videos is not None:
        log("  H.264 strip coded and decoded by the plain version in the "
            "pool; 14 (j)'s videos " + (
                "from the cache" if h264_videos.encode_s is None else
                f"coded beside them in {h264_videos.encode_s:.1f} s (native, "
                "a thread a video)"))
        rows.update(h264_rows(h264_strip_out, h264_videos, h264_plain4k))
        phase_mark("the H.264 rows")
    if h264_high is not None:
        rows.update(h264_high_rows(h264_high))
        phase_mark("the H.264 High rows")
    if container_videos is not None:
        rows.update(demux_rows(container_videos))
    return rows


class LosslessVideos:
    """Phase 14 (c)-(e)'s videos: phase 14's raw videos (``paths``)
    written again, each distinct frame encoded once, as PNG AVIs (``MPNG``,
    RGB 8-bit, the rows' filters cycled), as HuffYUV AVIs (``HFYU`` RGB24,
    left predictor, G-decorrelated: what cv2's writer writes, tables from
    the first frame's top quarter), as FFV1 AVIs as
    ``cv2.VideoWriter(fourcc "FFV1")`` writes BGR (version 3, slice CRCs,
    the Golomb-Rice coder, bgra, its 12 x 7 slices at 4K, a GOP of 12:
    each video a keyframe and 11 frames that carry its states) and as Ut
    Video ``ULRG`` AVIs as FFmpeg's ``-c:v utvideo`` writes them (the left
    predictor, 18 slices at 4K; phase 12 holds the median one);
    and phase 14's I420 videos (``i420_paths``) as ``ULY0`` AVIs as
    ``cv2.VideoWriter(fourcc "ULY0")`` writes them (the left predictor, 9
    slices); and as Lagarith AVIs: the raw frames as RGB24 frames, the
    I420 planes as YV12 frames (``tests/_torch_lagarith_enc.cpp``, the
    writer's escape choice).  Cached under ``build/`` by the frames' bytes
    and the writers' sources, as the MJPG videos are; otherwise
    :meth:`submit` hands the PNG, HuffYUV and UtVideo encodes to a process
    pool (phase 12's, beside its plain decodes, where no call is timed),
    the FFV1 ones to a thread (``tests/_torch_ffv1_enc.cpp`` on every
    core, a video at a time) and the Lagarith ones to another (the native
    encoder, a frame a thread), and :meth:`finish` writes the AVIs.  Then
    ``written`` holds each codec's paths, ``sizes`` the bytes of its
    chunks and ``encode_s`` the seconds from submit to finish (None when
    the cache had them)."""

    CODECS = ("PNG", "HFYU RGB24", "FFV1", "ULRG", "ULY0", "LAGS RGB24",
              "LAGS YV12")
    # the Lagarith videos' frame kinds
    LAGARITH = {"LAGS RGB24": "rgb24", "LAGS YV12": "yv12"}
    # the Ut Video fourccs' predictors
    UTVIDEO = {"ULRG": "left", "ULY0": "left"}

    def __init__(self, paths, i420_paths):
        import hashlib
        from camera_linearity_tpu_torch.utils import avi
        from tests import _torch_ffv1_writer as fw
        from tests import _torch_huffyuv_writer as hw
        from tests import _torch_lagarith_writer as lw
        from tests import _torch_png_writer as pw
        from tests import _torch_rawvideo_writer as rw
        from tests import _torch_utvideo_writer as uw
        # RGB, as PNG stores it
        self.frames = [np.ascontiguousarray(f[..., ::-1]) for p in paths
                       for f in avi.raw_frames(p)]
        # the I420 frames' (Y, U, V) planes
        self.i420 = []
        for p in i420_paths:
            for c in avi.raw_chunks(p, avi.probe_avi(p)):
                y = c[:H5 * W5].reshape(H5, W5)
                u, v = c[H5 * W5:H5 * W5 * 3 // 2].reshape(
                    2, H5 // 2, W5 // 2)
                self.i420.append([y.copy(), u.copy(), v.copy()])
        key = hashlib.md5(usedforsecurity=False)
        for src in (pw.__file__, hw.__file__, rw.__file__, fw.__file__,
                    fw._ENC_SRC, uw.__file__, lw.__file__, lw._ENC_SRC):
            key.update(Path(src).read_bytes())
        for f in self.frames:
            key.update(f.data)
        for planes in self.i420:
            for c in planes:
                key.update(c.data)
        self.cache = ROOT / "build" / "chip_smoke_lossless" / \
            key.hexdigest()[:12]
        self.written = {codec: [
            self.cache / f"{codec.lower()} {p.name}"
            for p in paths] for codec in self.CODECS}
        self.sizes, self.encode_s, self._pending = None, None, None
        sizes_file = self.cache / "sizes.json"
        if sizes_file.exists() and all(
                p.exists() for ps in self.written.values() for p in ps):
            self.sizes = json.loads(sizes_file.read_text())
            self.frames = self.i420 = None

    def utvideo(self, fourcc: str):
        """The Ut Video stream parameters and extradata of ``fourcc``."""
        from camera_linearity_tpu_torch.native import utvideo_plain
        from tests import _torch_utvideo_writer as uw
        layout = utvideo_plain.LAYOUTS[fourcc]
        extra = uw.extradata(layout, uw.cv2_slices(layout, H5))
        return utvideo_plain.params(fourcc, extra), extra

    def submit(self, pool) -> None:
        from concurrent.futures import ThreadPoolExecutor
        from tests import _torch_ffv1_writer as fw
        from tests import _torch_huffyuv_writer as hw
        from tests import _torch_lagarith_writer as lw
        from tests import _torch_utvideo_writer as uw
        from tests._torch_png_writer import encode_png
        if self.frames is None:
            return
        self._t0 = time.perf_counter()
        # each video cycles MJPG_POOL distinct frames: the intra codecs
        # code those once (FFV1 carries its states from frame to frame, so
        # it codes every frame)
        distinct = [f for i, f in enumerate(self.frames)
                    if i % FRAMES5 < MJPG_POOL]
        # the PNG frames go out first; the HuffYUV tables meanwhile
        png = [pool.submit(encode_png, f, 2, 8) for f in distinct]
        self.stream = hw.make_stream("rgb24", "left", True, H5, None, 2,
                                     [self.frames[0][:H5 // 4, :, ::-1]])
        self.ffv1 = fw.cv2_config("bgr", H5, W5)
        self._encoder = ThreadPoolExecutor(2, "native-encode")
        bgr = [f[..., ::-1] for f in self.frames]
        bgr_d = [f[..., ::-1] for f in distinct]
        i420_d = [f for i, f in enumerate(self.i420)
                  if i % FRAMES5 < MJPG_POOL]

        def ffv1_video(frames):
            return fw.native_encode([np.ascontiguousarray(f) for f in frames],
                                    H5, W5, self.ffv1)
        self._pending = {"PNG": png, "HFYU RGB24": [
            pool.submit(hw.encode_frame, f, self.stream) for f in bgr_d],
            "FFV1": [self._encoder.submit(ffv1_video, bgr[i:i + FRAMES5])
                     for i in range(0, len(bgr), FRAMES5)]}
        for fourcc, pictures in (("ULRG", bgr_d), ("ULY0", i420_d)):
            params = self.utvideo(fourcc)[0]
            predictor = uw.PREDICTORS[self.UTVIDEO[fourcc]]
            self._pending[fourcc] = [
                pool.submit(uw.encode_frame, uw.to_planes(f, params.layout),
                            params, predictor) for f in pictures]
        # one thread codes both Lagarith sets, each a frame a thread
        lags = self._encoder.submit(lambda: [lw.native_encode(
            kind, bgr_d if kind == "rgb24" else i420_d)
            for kind in self.LAGARITH.values()])
        self._pending["LAGS RGB24"] = [lags]
        self.frames = self.i420 = None

    def finish(self) -> None:
        from tests import _torch_ffv1_writer as fw
        from tests import _torch_huffyuv_writer as hw
        from tests import _torch_lagarith_writer as lw
        from tests import _torch_utvideo_writer as uw
        from tests._torch_png_writer import write_png_avi
        if self._pending is None:
            return
        self.cache.mkdir(parents=True, exist_ok=True)
        self.sizes = {}
        try:
            lags = self._pending.pop("LAGS RGB24")[0].result()
            self._pending.update({codec: lags[i] for i, codec in enumerate(
                self.LAGARITH)})
            for codec, futures in self._pending.items():
                chunks = futures if codec in self.LAGARITH else \
                    [f.result() for f in futures]
                if codec == "FFV1":   # a list of chunks a video
                    chunks = [c for video in chunks for c in video]
                else:   # each distinct frame's chunk, cycled
                    chunks = [chunks[i // FRAMES5 * MJPG_POOL
                                     + i % FRAMES5 % MJPG_POOL]
                              for i in range(FRAMES5 * len(
                                  self.written[codec]))]
                for i, out in enumerate(self.written[codec]):
                    part = chunks[i * FRAMES5:(i + 1) * FRAMES5]
                    tmp = out.with_suffix(f".tmp{os.getpid()}")
                    if codec == "PNG":
                        write_png_avi(tmp, part, H5, W5, "MPNG")
                    elif codec == "FFV1":
                        fw.write_stream_avi(tmp, part, self.ffv1, H5, W5)
                    elif codec in self.UTVIDEO:
                        uw.write_chunks_avi(tmp, part, codec, H5, W5,
                                            self.utvideo(codec)[1])
                    elif codec in self.LAGARITH:
                        lw.write_lagarith_avi(tmp, part, H5, W5)
                    else:
                        hw.write_stream_avi(tmp, part, self.stream, H5, W5,
                                            "HFYU")
                    os.replace(tmp, out)
                self.sizes[codec] = sum(map(len, chunks))
        finally:
            self._encoder.shutdown(cancel_futures=True)
        (self.cache / "sizes.json").write_text(json.dumps(self.sizes))
        self._pending = None
        self.encode_s = time.perf_counter() - self._t0


# phase 12's MPEG-4 Part 2 rows and phase 14 (g): the quantiser of the 4K
# videos (tests/_torch_mpeg4_enc.cpp: an I-VOP, then 11 P-VOPs of zero
# vectors) and the strip's frames
MPEG4_QUANT = 6
MPEG4_STRIP_FRAMES = 5
# the ASP videos' and strip's quant_type 1 matrices: a custom intra one and
# an inter one cut short by a 0 (its last value fills the rest)
MPEG4_ASP_MATRICES = (tuple(8 + 3 * i % 40 for i in range(64)),
                      (16, 17, 18, 20, 22, 26, 30, 36))


def mpeg4_strip(pictures, seed: int = SEED):
    """Phase 12's MPEG-4 strip, in a spawned process: ``pictures`` ((Y, U,
    V) planes of STRIP_ROWS x W5) coded by ``tests/_torch_mpeg4_writer.py``
    as an I-VOP (AC prediction, dquant) and P-VOPs of skipped, 1MV, 4MV
    and intra macroblocks, vectors at fcode 3 past every edge of the strip,
    dquant, both rounding types; decoded by ``mpeg4_plain.py``.  Returns
    (chunks, the plain frames, the writer's reconstruction as BGR)."""
    from camera_linearity_tpu_torch.native import mpeg4_plain, rawvideo_plain
    from tests import _torch_mpeg4_writer as mw
    rows, width = pictures[0][0].shape
    mbh, mbw = rows // 16, width // 16
    rng = np.random.default_rng(seed)
    plans = [mw.Plan("I", quant=MPEG4_QUANT,
                     ac_pred=rng.random((mbh, mbw)) < 0.5,
                     dquant=rng.integers(-2, 3, (mbh, mbw)))]
    for t in range(len(pictures) - 1):
        r = rng.random((mbh, mbw))
        plans.append(mw.Plan(
            "P", quant=MPEG4_QUANT + 2, rounding=t % 2, fcode=3,
            modes=np.select([r < 0.15, r < 0.3, r < 0.6],
                            [mw.SKIP, mw.INTRA, mw.INTER4], mw.INTER),
            mvs=rng.integers(-64, 64, (mbh, mbw, 4, 2)),
            dquant=rng.integers(-2, 3, (mbh, mbw)),
            ac_pred=rng.random((mbh, mbw)) < 0.5))
    chunks, recons, _ = mw.encode_video(pictures, plans)
    plain = mpeg4_plain.decode_bgr(chunks, "FMP4", b"", rows, width)
    recon = [rawvideo_plain.decode_bgr(mpeg4_plain.i420_bytes(r, rows, width),
                                       "i420_left", rows, width)
             for r in recons]
    return chunks, np.stack(plain), np.stack(recon)


def mpeg4_asp_strip(pictures, seed: int = SEED):
    """Phase 12's Advanced Simple strip, in a spawned process: ``pictures``
    ((Y, U, V) planes of STRIP_ROWS x W5, display order) coded by
    ``tests/_torch_mpeg4_writer.py`` in ``asp_order`` (an I-VOP, P-VOPs
    of skipped, 1MV, 4MV and intra macroblocks, B-VOPs of direct (with
    deltas), interpolated, backward and forward macroblocks and dbquant,
    two between references) with Xvid user data (the Xvid IDCT),
    ``quant_type`` 1 with MPEG4_ASP_MATRICES, and packed as Xvid packs;
    the unpacked chunks decoded by ``mpeg4_plain.py``.  Returns (the
    unpacked chunks, the packed ones, the plain frames, the writer's
    reconstruction as BGR in display order)."""
    from camera_linearity_tpu_torch.native import mpeg4_plain, rawvideo_plain
    from tests import _torch_mpeg4_writer as mw
    rows, width = pictures[0][0].shape
    mbh, mbw = rows // 16, width // 16
    rng = np.random.default_rng(seed)
    plans = []
    for kind, t in mw.asp_order(len(pictures)):
        if kind == "I":
            plans.append(mw.Plan("I", quant=MPEG4_QUANT, time=t,
                                 ac_pred=rng.random((mbh, mbw)) < 0.5,
                                 dquant=rng.integers(-2, 3, (mbh, mbw))))
        elif kind == "P":
            r = rng.random((mbh, mbw))
            plans.append(mw.Plan(
                "P", quant=MPEG4_QUANT + 2, rounding=t % 2, fcode=3, time=t,
                modes=np.select([r < 0.15, r < 0.3, r < 0.6],
                                [mw.SKIP, mw.INTRA, mw.INTER4], mw.INTER),
                mvs=rng.integers(-64, 64, (mbh, mbw, 4, 2)),
                dquant=rng.integers(-2, 3, (mbh, mbw)),
                ac_pred=rng.random((mbh, mbw)) < 0.5))
        else:
            plans.append(mw.Plan(
                "B", quant=MPEG4_QUANT + 4, fcode=3, bcode=2, time=t,
                modes=rng.choice([mw.DIRECT, mw.DIRECT_NONE, mw.BI, mw.BWD,
                                  mw.FWD], (mbh, mbw)),
                mvs=rng.integers(-64, 64, (mbh, mbw, 4, 2)),
                bmvs=rng.integers(-32, 32, (mbh, mbw, 2)),
                deltas=rng.integers(-8, 9, (mbh, mbw, 2)),
                dquant=rng.choice([-2, 0, 2], (mbh, mbw))))
    chunks, recons, wr = mw.encode_video(
        [pictures[p.time] for p in plans], plans,
        user_data=mw.ASP_USER_DATA, matrices=MPEG4_ASP_MATRICES,
        vol_fields=dict(low_delay=0, quant_type=1))
    packed = mw.pack(chunks, plans, mw.nvop_chunk(wr.tib))
    plain = mpeg4_plain.decode_bgr(chunks, "XVID", b"", rows, width)
    recon = [rawvideo_plain.decode_bgr(mpeg4_plain.i420_bytes(r, rows, width),
                                       "i420_left", rows, width)
             for r in mw.display_order(plans, recons, False)]
    return chunks, packed, np.stack(plain), np.stack(recon)


class Mpeg4Videos:
    """Phase 14 (g)'s and (h)'s videos: phase 14's I420 planes
    (``i420_paths``) as MPEG-4 Part 2 AVIs, coded by
    ``tests/_torch_mpeg4_enc.cpp`` (the Python writer's bytes): (g)
    ``FMP4``, each video an I-VOP and 11 P-VOPs of zero vectors at
    MPEG4_QUANT, with ``Lavc`` user data as cv2's writer writes; (h)
    ``XVID`` as Xvid writes Advanced Simple video (``mw.encode_asp``:
    Xvid and DivX packed user data, two packed B-VOPs of direct
    macroblocks between references, ``quant_type`` 1 with
    MPEG4_ASP_MATRICES); and as I420 AVIs of the writer's own
    reconstruction in display order, which 14 (g) and (h) hold the port's
    decode to.  Cached under ``build/`` by the planes and the writer's
    sources, as the lossless videos are; otherwise :meth:`submit` codes
    them on threads (the encoder is native and releases the GIL; a video
    chains its VOPs, so a thread a video and kind) and :meth:`finish`
    waits.  ``fmp4``, ``recon``,
    ``asp`` and ``asp_recon`` hold the paths, ``encode_s`` the seconds
    from submit to finish (None when the cache had them)."""

    def __init__(self, i420_paths):
        import hashlib
        from camera_linearity_tpu_torch.utils import avi
        from tests import _torch_mpeg4_writer as mw
        from tests import _torch_rawvideo_writer as rw
        self.planes = []      # a video's (Y, U, V) planes, frame by frame
        for p in i420_paths:
            video = []
            for c in avi.raw_chunks(p, avi.probe_avi(p)):
                y = c[:H5 * W5].reshape(H5, W5)
                u, v = c[H5 * W5:H5 * W5 * 3 // 2].reshape(
                    2, H5 // 2, W5 // 2)
                video.append((y.copy(), u.copy(), v.copy()))
            self.planes.append(video)
        key = hashlib.md5(usedforsecurity=False)
        for src in (mw.__file__, mw._ENC_SRC, rw.__file__):
            key.update(Path(src).read_bytes())
        key.update(str((MPEG4_QUANT, MPEG4_ASP_MATRICES)).encode())
        for video in self.planes:
            for frame in video:
                for c in frame:
                    key.update(c.data)
        self.cache = ROOT / "build" / "chip_smoke_mpeg4" / \
            key.hexdigest()[:12]
        self.fmp4 = [self.cache / f"fmp4 {p.name}" for p in i420_paths]
        self.recon = [self.cache / f"recon {p.name}" for p in i420_paths]
        self.asp = [self.cache / f"xvid {p.name}" for p in i420_paths]
        self.asp_recon = [self.cache / f"xvid recon {p.name}"
                          for p in i420_paths]
        self.encode_s, self._future = None, None
        if all(p.exists() for p in self.fmp4 + self.recon + self.asp +
               self.asp_recon):
            self.planes = None

    def _code(self, k: int, asp: bool) -> float:
        """Video ``k`` as ``FMP4`` (``asp``: as ``XVID``) and its
        reconstruction; returns when it ended, seconds from submit."""
        from tests import _torch_mpeg4_writer as mw
        from tests._torch_rawvideo_writer import encode_frame, write_raw_avi
        with self._lock:     # one build of the encoder
            mw.native_entropy()
        video = self.planes[k]
        if asp:
            chunks, recs = mw.encode_asp(video, MPEG4_QUANT,
                                         MPEG4_ASP_MATRICES)
        else:
            wr = mw.Writer(H5, W5)
            chunks, recs = [], []
            for t, planes in enumerate(video):
                chunk, rec = wr.encode_native(planes, mw.smoke_plan(
                    "I" if t == 0 else "P", MPEG4_QUANT, t % 2))
                chunks.append(chunk)
                recs.append(rec)
        frames = [encode_frame("I420", (
            rec[0][:H5, :W5], rec[1][:H5 // 2, :W5 // 2],
            rec[2][:H5 // 2, :W5 // 2])) for rec in recs]
        coded, recon = (self.asp[k], self.asp_recon[k]) if asp else \
            (self.fmp4[k], self.recon[k])
        for out, write in (
                (coded, lambda tmp: mw.write_mpeg4_avi(
                    tmp, chunks, H5, W5, tag="XVID" if asp else "FMP4")),
                (recon, lambda tmp: write_raw_avi(
                    tmp, frames, H5, W5, "I420"))):
            tmp = out.with_suffix(f".tmp{os.getpid()}")
            write(tmp)
            os.replace(tmp, out)
        return time.perf_counter() - self._t0

    def submit(self) -> None:
        import threading
        from concurrent.futures import ThreadPoolExecutor
        if self.planes is None:
            return
        self.cache.mkdir(parents=True, exist_ok=True)
        self._t0 = time.perf_counter()
        self._lock = threading.Lock()
        self.jobs = jobs = [(k, asp) for k in range(len(self.planes))
                            for asp in (False, True)]
        coder = ThreadPoolExecutor(len(jobs), "mpeg4-encode")
        self._future = [coder.submit(self._code, *job) for job in jobs]
        coder.shutdown(wait=False)

    def finish(self) -> None:
        if self._future is None:
            return
        self.ends = [f.result() for f in self._future]
        self._future = None
        self.planes = None
        self.encode_s = time.perf_counter() - self._t0


# phase 12's H.264 rows and phase 14 (j): the 4K videos
# (tests/_torch_h264_enc.cpp: an IDR and 11 P pictures a video) as x264
# codes Constrained Baseline for real-time use, ``x264 --profile baseline
# --tune zerolatency``, at its defaults (x264's documented defaults; x264
# is not run: cv2 here has no H.264 encoder).  Its default rate factor,
# 23, held as a constant QP (``--qp 23``: P slices at 23, I slices at 20
# by the default ``--ipratio 1.40``, 6 log2 1.4 = 2.9 lower; no
# per-macroblock QP: ``--qp`` turns adaptive quantisation off); a slice a
# thread (zerolatency's sliced threads), a thread a core of the card's
# 8-core host.  Without ``--tune`` x264 codes one slice a picture: phase
# 12 times such a stream too (H264Plain4K), a serial chain.  Phase 12
# times the brightest video
H264_QP = (20, 23)
H264_SLICES = 8
H264_TIMED = 2
# the P pictures each of phase 12's 12 decoders at once decodes
H264_P_AT_ONCE = 4


def h264_strip(pictures, seed: int = SEED):
    """Phase 12's H.264 strip, in a spawned process: ``pictures`` ((Y, U,
    V) planes of STRIP_ROWS x W5) coded by ``tests/_torch_h264_writer.py``
    as the first pictures of its ``kitchen_sink`` (an IDR of two slices,
    P pictures of one to three slices and one to three references, a
    non-reference one, a reference list modification, MMCOs 4 and 3 (a
    long-term reference), every macroblock kind, partition and intra
    mode, vectors far outside the strip, mb_qp_delta); decoded by
    ``h264_plain.py``.  Returns (the samples as Annex B, the plain frames,
    the writer's reconstruction as BGR)."""
    from camera_linearity_tpu_torch.native import h264_plain, rawvideo_plain
    from tests import _torch_h264_writer as hw
    rows, width = pictures[0][0].shape
    plans = hw.kitchen_sink(seed % 1000)[:len(pictures)]
    samples, _, recons, _ = hw.encode(pictures, hw.Config(rows, width),
                                      plans)
    data = [hw.annexb(s) for s in samples]
    plain = h264_plain.decode_bgr(data)
    recon = [rawvideo_plain.decode_bgr(h264_plain.i420_bytes(r), "i420_left",
                                       rows, width) for r in recons]
    return data, np.stack(plain), np.stack(recon)


class H264Videos:
    """Phase 14 (j)'s videos: phase 14's I420 planes (``i420_paths``)
    coded as H.264 by ``tests/_torch_h264_enc.cpp`` (a thread a video,
    beside the window's other work): each video an IDR
    and 11 P pictures (QPs H264_QP, H264_SLICES slices a picture; the
    writer's default choices, :meth:`plans`), the
    first video with a reference list modification (picture 3) and an
    MMCO (picture 6); written as ``avc1`` MP4s, as Annex B AVIs
    (``H264``) and as Matroska (``V_MPEG4/ISO/AVC``) of the same
    bitstream, and the writer's reconstruction as I420 AVIs, which 14 (j)
    holds the port's decode to.  Cached under ``build/`` by the I420
    files and the writer's and decoder's sources, as 14 (g)'s are;
    otherwise :meth:`submit` codes them on threads (a video each, its
    planes read there: the encoder is native and its calls release the
    GIL) and :meth:`finish` waits.
    ``mp4``, ``avi``, ``mkv`` and ``recon`` hold the paths, ``encode_s``
    the seconds from submit to finish (None when the cache had them)."""

    def __init__(self, i420_paths):
        import hashlib
        from tests import _torch_h264_writer as hw
        from tests import _torch_rawvideo_writer as rw
        self.i420 = list(i420_paths)
        key = hashlib.md5(usedforsecurity=False)
        for src in (hw.__file__, hw._ENC_SRC, rw.__file__,
                    ROOT / "camera_linearity_tpu_torch" / "native" /
                    "h264.cpp", *self.i420):
            key.update(Path(src).read_bytes())
        key.update(repr([self.plans(k) for k in range(len(self.i420))]
                        ).encode())
        self.cache = ROOT / "build" / "chip_smoke_h264" / key.hexdigest()[:12]
        stems = [p.stem.replace("i420 ", "") for p in i420_paths]
        self.mp4 = [self.cache / f"h264 {s}.mp4" for s in stems]
        self.avi = [self.cache / f"h264 {s}.avi" for s in stems]
        self.mkv = [self.cache / f"h264 {s}.mkv" for s in stems]
        self.recon = [self.cache / f"h264 recon {s}.avi" for s in stems]
        self.encode_s, self._futures = None, None
        self.cached = all(p.exists() for p in self.mp4 + self.avi + self.mkv +
                          self.recon)

    @staticmethod
    def plans(k: int, n: int = H264_SLICES):
        """Video ``k``'s pictures, of ``n`` slices of whole macroblock
        rows (as x264 splits a picture): the writer's default choices
        (``tests/_torch_h264_writer.Options``: P_Skip, intra macroblocks,
        every partition, quarter-sample vectors) without I_PCM, vectors
        far outside the picture or QP changes, and without a search: the
        scene does not move."""
        from tests import _torch_h264_writer as hw
        o = hw.Options(seed=k, p_pcm=0, p_far=0, search=0, p_dqp=0)
        slices = tuple(dict.fromkeys(i * (H5 // 16) // n * (W5 // 16)
                                     for i in range(n)))
        plans = [hw.PicPlan("IDR", 3, H264_QP[0], slices=slices, opts=o)]
        for t in range(1, FRAMES5):
            plans.append(hw.PicPlan(
                "P", 2, H264_QP[1], slices=slices, opts=o,
                num_ref=2 if k == 0 and t == 3 else None,
                modifications=((0, 1),) if k == 0 and t == 3 else (),
                mmcos=((1, 0),) if k == 0 and t == 6 else None))
        return plans

    def _code(self, k: int) -> None:
        from tests import _torch_h264_writer as hw
        from camera_linearity_tpu_torch import native
        from camera_linearity_tpu_torch.native import h264_plain
        from camera_linearity_tpu_torch.utils import avi
        from tests._torch_rawvideo_writer import write_raw_avi
        if k == 0:     # the decoder too, which phase 12 calls after it
            native.h264_available()
        planes = []     # the video's (Y, U, V) planes, frame by frame
        for c in avi.raw_chunks(self.i420[k], avi.probe_avi(self.i420[k])):
            y = c[:H5 * W5].reshape(H5, W5)
            u, v = c[H5 * W5:H5 * W5 * 3 // 2].reshape(2, H5 // 2, W5 // 2)
            planes.append((y.copy(), u.copy(), v.copy()))
        samples, params, recons, _ = hw.encode(planes, hw.Config(H5, W5),
                                               self.plans(k))
        for out, write in (
                (self.mp4[k], lambda tmp: hw.write_h264_mp4(
                    tmp, samples, params, H5, W5)),
                (self.avi[k], lambda tmp: hw.write_h264_avi(
                    tmp, samples, H5, W5)),
                (self.mkv[k], lambda tmp: hw.write_h264_mkv(
                    tmp, samples, params, H5, W5)),
                (self.recon[k], lambda tmp: write_raw_avi(
                    tmp, [h264_plain.i420_bytes(r) for r in recons], H5, W5,
                    "I420"))):
            tmp = out.with_name(f"tmp{os.getpid()} {out.name}")
            write(tmp)
            os.replace(tmp, out)

    def submit(self) -> None:
        from concurrent.futures import ThreadPoolExecutor
        if self.cached:
            return
        self.cache.mkdir(parents=True, exist_ok=True)
        self._t0 = time.perf_counter()
        coder = ThreadPoolExecutor(len(self.i420), "h264-encode")
        self._futures = [coder.submit(self._code, k)
                         for k in range(len(self.i420))]
        coder.shutdown(wait=False)

    def finish(self) -> None:
        if self._futures is None:
            return
        for f in self._futures:
            f.result()
        self._futures = None
        self.cached = True
        self.encode_s = time.perf_counter() - self._t0


def h264_clips() -> list:
    """Phase 12's check of the committed ``tests/data/h264 *`` clips (the
    coverage stream: every CAVLC table entry and QP; the kitchen sink,
    cropped, in an AVI; several slices with constrained intra in
    Matroska; a full-range ``avc3``): each through
    ``video_frame_generator`` against its ``.cv2.npy``; a line each, and
    the names that differ."""
    from camera_linearity_tpu_torch.models import video
    from camera_linearity_tpu_torch.utils import containers
    failures = []
    for clip in sorted((ROOT / "tests" / "data").glob("h264 *")):
        if clip.suffix == ".npy":
            continue
        cv = np.load(clip.with_suffix(".cv2.npy"))
        info = containers.probe_video(clip)
        got = np.stack([f for f in video.video_frame_generator(clip)
                        if f is not None])
        same = got.shape == cv.shape and np.array_equal(got, cv)
        log(f"  {'ok ' if same else 'BAD'} H.264 '{clip.name}' "
            f"({info.container_name}, {info.codec_name}, {len(cv)} x "
            f"{cv.shape[1]} x {cv.shape[2]}): "
            f"{'equals' if same else 'differs from'} the committed "
            f"cv2.VideoCapture frames")
        if not same:
            failures.append(clip.name)
    return failures


def h264_plain_4k(out: str, part: str, seed: int = SEED) -> None:
    """Half of :class:`H264Plain4K`'s work, in a spawned process of its own
    (each takes a core the phases before phase 12 leave idle, and the two
    finish in half the time one took): build ``h264.cpp`` and the test
    encoder, which phase 12 then loads; make 1 + H264_P_AT_ONCE 4K
    pictures as config 5's brightest video is made (a uniform base x 230
    plus N(0, 6) noise, from ``seed``; the writer's BT.601
    ``i420_planes``); code the first two as 14 (j)'s brightest video is
    coded (:meth:`H264Videos.plans`).  ``part`` "idr": decode the IDR
    with ``h264_plain.py``, and code all the pictures again with one slice
    a picture (x264 without ``--tune``); "p": decode the P picture with
    ``h264_plain.py`` from the writer's reconstruction of the IDR (which
    part "idr" holds to the plain decode of the IDR).  Writes the samples
    (Annex B), the plain frame, the reconstructions (BGR, as cv2 gives
    them) and the seconds of each step to ``out`` (``.npz``)."""
    from camera_linearity_tpu_torch import native
    from camera_linearity_tpu_torch.native import h264_plain, rawvideo_plain
    from tests import _torch_h264_writer as hw
    t0 = time.perf_counter()
    native.h264_available()
    hw.native_encoder()
    t1 = time.perf_counter()
    rng = np.random.default_rng(seed)
    base = rng.random((H5, W5, 3)) * 230
    pictures = [hw.i420_planes(np.clip(
        base + 6 * rng.standard_normal((H5, W5, 3)), 0, 255).astype(np.uint8))
        for _ in range(1 + H264_P_AT_ONCE)]
    del base
    streams = {}
    for name, n, count in (("sliced", H264_SLICES, 2),
                           ("chain", 1, len(pictures))):
        if name == "chain" and part != "idr":
            continue
        samples, _, recons, _ = hw.encode(
            pictures[:count], hw.Config(H5, W5),
            H264Videos.plans(H264_TIMED, n)[:count])
        streams[name] = ([hw.annexb(s) for s in samples], np.stack([
            rawvideo_plain.decode_bgr(h264_plain.i420_bytes(r), "i420_left",
                                      H5, W5) for r in recons]), recons)
    t2 = time.perf_counter()
    data = streams["sliced"][0]
    dec = h264_plain.Decoder()
    if part == "idr":
        plain = dec.decode(data[0])
    else:
        # the IDR's headers and picture buffer, its planes the writer's
        job = dec.stream.next(data[0])
        slot = h264_plain._Slot(job.sps.mbw, job.sps.mbh)
        slot.y[:], slot.u[:], slot.v[:] = streams["sliced"][2][0]
        dec.slots[job.pic.slot] = slot
        dec.stream.release(job.pic.slot)
        dec.stream.end_batch()
        plain = dec.decode(data[1])
    arrays = {"plain": rawvideo_plain.decode_bgr(
        h264_plain.i420_bytes(plain), "i420_left", H5, W5),
        "seconds": np.array([t1 - t0, t2 - t1, time.perf_counter() - t2])}
    for name, (data, recon, _) in streams.items():
        arrays[f"{name}_data"] = np.frombuffer(b"".join(data), np.uint8)
        arrays[f"{name}_sizes"] = np.array([len(d) for d in data])
        arrays[f"{name}_recon"] = recon
    np.savez(out, **arrays)


class H264Plain4K:
    """Phase 12's check of ``h264.cpp`` on 4K pictures against a decoder
    independent of its macroblock layer, and its one-slice stream:
    :func:`h264_plain_4k` in two spawned processes (daemons: they end
    with the smoke), started with the smoke, since the plain decode of a
    4K picture takes a minute or more of a core: one decodes the IDR, the
    other the P picture.  :meth:`result` waits for both and returns a
    dict: ``sliced`` and ``chain`` (the samples, the writer's
    reconstruction), ``plain`` (the sliced IDR and P picture as
    ``h264_plain.py`` decodes them), ``seconds`` (each process's building,
    coding and plain decoding) and ``waited``."""

    def __init__(self):
        import multiprocessing
        cache = ROOT / "build" / "chip_smoke_h264"
        cache.mkdir(parents=True, exist_ok=True)
        self.outs = {part: cache / f"plain 4k {part} {os.getpid()}.npz"
                     for part in ("idr", "p")}
        ctx = multiprocessing.get_context("spawn")
        self.procs = {part: ctx.Process(target=h264_plain_4k,
                                        args=(str(out), part), daemon=True)
                      for part, out in self.outs.items()}
        for proc in self.procs.values():
            proc.start()

    def result(self) -> dict:
        t0 = time.perf_counter()
        for proc in self.procs.values():
            proc.join()
        got = {"waited": time.perf_counter() - t0, "seconds": {}}
        for part, proc in self.procs.items():
            if proc.exitcode != 0:
                raise AssertionError("phase 12, the 4K H.264 pictures' plain "
                                     f"decode ({part}): exit code "
                                     f"{proc.exitcode}")
        plain = []
        for part, out in self.outs.items():
            with np.load(out) as z:
                for name in ("sliced", "chain"):
                    if f"{name}_data" not in z or name in got:
                        continue
                    blob = z[f"{name}_data"].tobytes()
                    sizes = z[f"{name}_sizes"]
                    got[name] = ([blob[e - n:e] for e, n in
                                  zip(np.cumsum(sizes), sizes)],
                                 z[f"{name}_recon"])
                plain.append(z["plain"])
                got["seconds"][part] = z["seconds"].tolist()
            out.unlink()
        got["plain"] = np.stack(plain)
        return got


# phase 12's High rows and phase 14 (k): what ``x264 --profile high --tune
# zerolatency`` writes at its documented defaults (preset medium): CABAC,
# the 8x8 transform (``--8x8dct``) with Intra 8x8 and 4x4 (``--partitions``
# i8x8,i4x4 among them), ``--weightp 2`` (a pred_weight_table in every P
# slice), no B frames, ``--cqm flat`` (no matrices), the rate factor 23
# held as constant QPs (P 23, I 20, as H264_QP) and a slice a thread, 8 on
# the card's 8-core host (x264 is not run).  One-slice streams of the same
# content stand for phones' hardware encoders, which write one slice a
# picture.
H264_HIGH_LEVEL = 51


def h264_high_plans(k: int, n: int = H264_SLICES):
    """Video ``k``'s pictures at the High traffic: H264Videos.plans's
    choices (no I_PCM, far vectors, QP changes or search) with Intra 8x8
    and 8x8-transform inter macroblocks, a pred_weight_table in every P
    slice (its flags 0: the scene does not fade), and in the first video
    picture 3's list holding the previous picture twice, the copy weighted
    (``--weightp 2``'s duplicate)."""
    from tests import _torch_h264_writer as hw
    o = hw.Options(seed=k, p_pcm=0, p_far=0, search=0, p_dqp=0)
    slices = tuple(dict.fromkeys(i * (H5 // 16) // n * (W5 // 16)
                                 for i in range(n)))
    plans = [hw.PicPlan("IDR", 3, H264_QP[0], slices=slices, opts=o)]
    for t in range(1, FRAMES5):
        dup = k == 0 and t == 3
        plans.append(hw.PicPlan(
            "P", 2, H264_QP[1], slices=slices, opts=o,
            num_ref=2 if dup else None,
            modifications=((0, 0), (0, 15)) if dup else (),
            weights=(5, 5, ((None, None), ((31, 1), None)) if dup else ())))
    return plans


def h264_high_work(out: str, seed: int = SEED) -> None:
    """:class:`H264HighWork`'s work, in a spawned process of its own at
    niceness 10 (it takes the cores the phases before phase 12 leave
    idle): build ``h264.cpp`` and the test encoder; make config 5's three
    exposure videos again on the host, as ``make_videos`` makes them (a
    uniform base x exposure x 230 plus N(0, 6) noise, MJPG_POOL distinct
    frames cycled to FRAMES5, from ``seed``; the writer's BT.601
    ``i420_planes``); code each at the High traffic
    (:func:`h264_high_plans`, a thread a video) into ``out`` as an ``avc1``
    MP4 and the writer's reconstruction as an I420 AVI; code the brightest
    one's first 1 + H264_P_AT_ONCE pictures as a one-slice stream; code
    the first STRIP_ROWS rows of its first MPEG4_STRIP_FRAMES pictures as
    ``tests/_torch_h264_writer.high_sink`` codes them (CABAC, both
    transforms, every intra mode, weights, a duplicated reference, several
    slices and references, MMCOs) and decode that strip with
    ``h264_plain.py``.  Writes ``high.npz`` (the one-slice stream and the
    strip's samples, frames and reconstruction, each step's seconds) last."""
    from concurrent.futures import ThreadPoolExecutor
    from camera_linearity_tpu_torch import native
    from camera_linearity_tpu_torch.native import h264_plain, rawvideo_plain
    from camera_linearity_tpu_torch.utils.general import set_thread_priority
    from tests import _torch_h264_writer as hw
    from tests._torch_rawvideo_writer import write_raw_avi
    set_thread_priority(10)
    out = Path(out)
    t0 = time.perf_counter()
    native.h264_available()
    hw.native_encoder()
    t1 = time.perf_counter()
    rng = np.random.default_rng(seed)
    base = rng.random((H5, W5, 3))
    videos = []
    for ms in EXPOSURES5_MS:
        level = base * (ms / max(EXPOSURES5_MS)) * 230
        pool = [hw.i420_planes(np.clip(level + 6 * rng.standard_normal(
            (H5, W5, 3)), 0, 255).astype(np.uint8)) for _ in range(MJPG_POOL)]
        videos.append([pool[i % MJPG_POOL] for i in range(FRAMES5)])
    del base
    t2 = time.perf_counter()
    config = hw.high_config(H5, W5, level=H264_HIGH_LEVEL)

    def code(k):
        set_thread_priority(10)
        ms = EXPOSURES5_MS[k]
        samples, params, recons, _ = hw.encode(videos[k], config,
                                               h264_high_plans(k))
        hw.write_h264_mp4(out / f"high scene {ms}ms.mp4", samples, params,
                          H5, W5)
        write_raw_avi(out / f"high recon {ms}ms.avi",
                      [h264_plain.i420_bytes(r) for r in recons], H5, W5,
                      "I420")

    def chain():
        set_thread_priority(10)
        count = 1 + H264_P_AT_ONCE
        samples, _, recons, _ = hw.encode(
            videos[H264_TIMED][:count], config,
            h264_high_plans(H264_TIMED, 1)[:count])
        return [hw.annexb(s) for s in samples], np.stack([
            rawvideo_plain.decode_bgr(h264_plain.i420_bytes(r), "i420_left",
                                      H5, W5) for r in recons])

    def strip():
        set_thread_priority(10)
        pictures = [tuple(np.ascontiguousarray(p[:r]) for p, r in (
            (y, STRIP_ROWS), (u, STRIP_ROWS // 2), (v, STRIP_ROWS // 2)))
            for y, u, v in videos[H264_TIMED][:MPEG4_STRIP_FRAMES]]
        plans = hw.high_sink(seed % 1000)[:len(pictures)]
        samples, _, recons, _ = hw.encode(
            pictures, hw.high_config(STRIP_ROWS, W5), plans)
        data = [hw.annexb(s) for s in samples]
        ts = time.perf_counter()
        plain = np.stack(h264_plain.decode_bgr(data))
        recon = np.stack([rawvideo_plain.decode_bgr(
            h264_plain.i420_bytes(r), "i420_left", STRIP_ROWS, W5)
            for r in recons])
        return data, plain, recon, time.perf_counter() - ts

    with ThreadPoolExecutor(len(videos) + 2) as ex:
        coded = [ex.submit(code, k) for k in range(len(videos))]
        chain_f, strip_f = ex.submit(chain), ex.submit(strip)
        for f in coded:
            f.result()
        chain_data, chain_recon = chain_f.result()
        strip_data, strip_plain, strip_recon, plain_s = strip_f.result()
    arrays = {"chain_recon": chain_recon, "strip_plain": strip_plain,
              "strip_recon": strip_recon,
              "seconds": np.array([t1 - t0, t2 - t1,
                                   time.perf_counter() - t2, plain_s])}
    for name, data in (("chain", chain_data), ("strip", strip_data)):
        arrays[f"{name}_data"] = np.frombuffer(b"".join(data), np.uint8)
        arrays[f"{name}_sizes"] = np.array([len(d) for d in data])
    tmp = out / f"high.tmp{os.getpid()}.npz"
    np.savez(tmp, **arrays)
    os.replace(tmp, out / "high.npz")


class H264HighWork:
    """Phase 12's High rows' and phase 14 (k)'s inputs:
    :func:`h264_high_work` in a spawned process of its own (a daemon),
    started with the smoke.  ``mp4`` and ``recon`` hold the three
    exposure videos' paths; :meth:`result` waits for the process and
    returns a dict: ``chain`` (the one-slice stream's samples and the
    writer's reconstruction), ``strip`` (the strip's samples, its plain
    frames and the writer's reconstruction), ``seconds`` (the process's
    building, content, coding and the strip's plain decode) and
    ``waited``."""

    def __init__(self):
        import multiprocessing
        self.dir = ROOT / "build" / "chip_smoke_h264_high" / str(os.getpid())
        self.dir.mkdir(parents=True, exist_ok=True)
        self.mp4 = [self.dir / f"high scene {ms}ms.mp4"
                    for ms in EXPOSURES5_MS]
        self.recon = [self.dir / f"high recon {ms}ms.avi"
                      for ms in EXPOSURES5_MS]
        self.proc = multiprocessing.get_context("spawn").Process(
            target=h264_high_work, args=(str(self.dir),), daemon=True)
        self.proc.start()
        self._got = None

    def result(self) -> dict:
        if self._got is not None:
            return self._got
        t0 = time.perf_counter()
        self.proc.join()
        got = {"waited": time.perf_counter() - t0}
        if self.proc.exitcode != 0:
            raise AssertionError("phase 12, the High 4K H.264 videos' "
                                 f"coding: exit code {self.proc.exitcode}")
        with np.load(self.dir / "high.npz") as z:
            split = {}
            for name in ("chain", "strip"):
                blob = z[f"{name}_data"].tobytes()
                sizes = z[f"{name}_sizes"]
                split[name] = [blob[e - n:e] for e, n in
                               zip(np.cumsum(sizes), sizes)]
            got["chain"] = (split["chain"], z["chain_recon"])
            got["strip"] = (split["strip"], z["strip_plain"],
                            z["strip_recon"])
            got["seconds"] = z["seconds"].tolist()
        self._got = got
        return got

    def close(self) -> None:
        """Remove the videos (the directory is the smoke's own)."""
        import shutil
        shutil.rmtree(self.dir, ignore_errors=True)


def h264_rows(strip, videos, plain4k) -> dict:
    """Phase 12's H.264 rows, after its plain-decode window: ``strip``
    (:func:`h264_strip`'s result from the pool) decoded natively and held
    to the plain frames and the writer's reconstruction; the committed
    clips against cv2's frames; ``plain4k``'s (:class:`H264Plain4K`)
    sliced 4K IDR and P picture held to ``h264_plain.py``'s frames and
    the writer's reconstruction, its one-slice stream to the writer's
    reconstruction; then 14 (j)'s brightest video of ``videos``
    (:class:`H264Videos`, coded in the window; H264_SLICES slices a
    picture) read from its MP4 and held to its reconstruction, and timed
    (host clock): its IDR picture on one thread, on every core (a slice a
    thread) and as a frame of a batch of 12 IDR pictures in one call (a
    GOP a thread), each one run after a warm one of the same call; its
    first H264_P_AT_ONCE P pictures after the IDR in one decoder (one
    run) on one thread, on every core and as frames of 12 decoders of the
    video at once (a thread each); the one-slice stream's IDR and P
    pictures on every core (a serial chain);
    and the demux of the video's MP4 beside its AVI.  Returns the rows'
    times."""
    from concurrent.futures import ThreadPoolExecutor
    from camera_linearity_tpu_torch import native
    from camera_linearity_tpu_torch.utils import avi, containers
    failures = h264_clips()
    data, plain, recon = strip
    rows, width = plain.shape[1:3]
    got = np.empty((len(data), rows, width, 3), np.uint8)
    native.h264_decode_bgr_batch(data, got, native.H264Decoder())
    strip_same = np.array_equal(got, plain) and np.array_equal(got, recon)
    log(f"  {'ok ' if strip_same else 'BAD'} H.264 strip of {rows} x "
        f"{width}, {len(data)} pictures (an IDR of two slices, P pictures "
        f"of up to three slices and three references, a non-reference one, "
        f"a reference list modification, MMCOs 4 and 3, every macroblock "
        f"kind, partition and mode, vectors past the edges; "
        f"{sum(map(len, data)) / 1e3:.0f} kB): native "
        f"{'equals' if strip_same else 'differs from'} h264_plain.py and the "
        f"writer's reconstruction, max |.| {max_gap(got, plain):.0f} DN")
    if not strip_same:
        failures.append("the H.264 strip")
    four_k = plain4k.result()
    (data, recon), plain = four_k["sliced"], four_k["plain"]
    secs = four_k["seconds"]
    took = "; ".join(
        f"the {part.upper()} picture's: {v[0]:.1f} s building h264.cpp and "
        f"the encoder, {v[1]:.1f} s coding, {v[2]:.1f} s the plain decode"
        for part, v in secs.items())
    got = np.empty_like(plain)
    native.h264_decode_bgr_batch(data, got, native.H264Decoder())
    same = np.array_equal(got, plain) and np.array_equal(got, recon)
    log(f"  {'ok ' if same else 'BAD'} H.264 4K IDR and P picture of "
        f"{H264_SLICES} slices (QPs {H264_QP}, 14 (j)'s brightest video's "
        f"choices, on config 5's brightest content made again from seed "
        f"{SEED}; {len(data[0]) / 1e6:.3f} MB, {len(data[1]) / 1e6:.3f} MB): "
        f"native {'equals' if same else 'differs from'} h264_plain.py and "
        f"the writer's reconstruction, max |.| {max_gap(got, plain):.0f} DN "
        f"(two processes from the smoke's start, the P picture decoded "
        f"from the writer's reconstruction of the IDR; {took}; "
        f"{four_k['waited']:.1f} s waited for them here)")
    if not same:
        failures.append("the H.264 4K pictures against h264_plain.py")
    chain, recon = four_k["chain"]
    got = np.empty_like(recon)
    native.h264_decode_bgr_batch(chain, got, native.H264Decoder())
    same = np.array_equal(got, recon)
    log(f"  {'ok ' if same else 'BAD'} H.264 4K one-slice stream of the "
        f"same pictures ({len(chain)} pictures): native "
        f"{'equals' if same else 'differs from'} the writer's "
        f"reconstruction")
    if not same:
        failures.append("the H.264 4K one-slice stream")
    del got, plain, recon, four_k

    def samples(path):
        info = containers.probe_video(path)
        return info, [bytes(c) for c in containers.frame_chunks(path, info)]
    info, video = samples(videos.mp4[H264_TIMED])
    why = avi.h264_unsupported(videos.mp4[H264_TIMED], info)
    frames = np.empty((len(video), H5, W5, 3), np.uint8)
    native.h264_decode_bgr_batch(video, frames,
                                 native.H264Decoder(avi.h264_params(info)))
    recon_chunks = [bytes(c) for c in avi.raw_chunks(
        videos.recon[H264_TIMED], avi.probe_avi(videos.recon[H264_TIMED]))]
    want = np.empty_like(frames)
    native.raw_decode_bgr_batch(recon_chunks, want, "i420")
    same = np.array_equal(frames, want)
    del want
    log(f"  {'ok ' if same else 'BAD'} H.264 4K video ({info.codec_name} "
        f"MP4, {why or 'read'}; {H264_SLICES} slices a picture, "
        f"IDR {len(video[0]) / 1e6:.3f} MB, P pictures "
        f"{np.mean([len(c) for c in video[1:]]) / 1e6:.3f} MB): its "
        f"{len(video)} frames {'equal' if same else 'differ from'} the "
        f"writer's reconstruction")
    if not same or why:
        failures.append("the H.264 4K video")
    raise_failures("phase 12, the H.264 decoder against its plain version, "
                   "the writer's reconstruction and the committed clips",
                   failures)
    times = h264_times(video, chain, avi.h264_params(info), frames,
                       info.codec_name, f"{H264_SLICES} slices")
    del frames
    # the demux: the MP4 probed and every frame read, beside its AVI
    times.update(demux_h264(videos.mp4[H264_TIMED], videos.avi[H264_TIMED]))
    return {f"h264 {k}": v for k, v in times.items()}


def h264_times(video, chain, extra, frames, codec, slices,
               what="Constrained Baseline") -> dict:
    """The H.264 decoder's 4K rows (host clock) on ``video`` (a 4K MP4's
    samples; ``extra`` its avcC) and ``chain`` (a one-slice stream's
    Annex B samples): the IDR picture on one thread, on every core (a slice
    a thread) and as a frame of a batch of 12 IDR pictures in one call (a
    GOP a thread), each one run after a warm one; the first
    H264_P_AT_ONCE P pictures after the IDR in one decoder (one run) on
    one thread, on every core and as frames of 12 decoders of the video at
    once (a thread each); the one-slice stream's IDR and P pictures on
    every core (a serial chain).  ``frames`` is a buffer of at least
    1 + H264_P_AT_ONCE 4K frames.  Logs them and returns them by name."""
    from concurrent.futures import ThreadPoolExecutor
    from camera_linearity_tpu_torch import native
    cores = os.cpu_count() or 1
    one = frames[:1]

    def decoder(avc):    # the MP4's avcC, or the Annex B one-slice stream
        return native.H264Decoder(extra if avc else b"")

    def idr_ms(clip, avc, threads):   # a run after a warm one
        d = decoder(avc)
        return host_ms(lambda: native.h264_decode_bgr_batch(
            clip[:1], one, d, threads=threads), runs=1, warmup=1)

    def p_ms(clip, avc, threads):     # the first H264_P_AT_ONCE
        d = decoder(avc)
        native.h264_decode_bgr_batch(clip[:1], one, d)
        t0 = time.perf_counter()
        native.h264_decode_bgr_batch(clip[1:1 + H264_P_AT_ONCE],
                                     frames[1:], d, threads=threads)
        return (time.perf_counter() - t0) * 1e3 / H264_P_AT_ONCE
    times = {"IDR one thread": idr_ms(video, True, 1),
             "IDR all threads": idr_ms(video, True, None),
             "P one thread": p_ms(video, True, 1),
             "P all threads": p_ms(video, True, None),
             "one slice IDR all threads": idr_ms(chain, False, None),
             "one slice P all threads": p_ms(chain, False, None)}
    batch = np.zeros((12, H5, W5, 3), np.uint8)
    d = decoder(True)
    times["IDR a frame of 12"] = host_ms(
        lambda: native.h264_decode_bgr_batch(video[:1] * 12, batch, d),
        runs=1, warmup=1) / 12
    del batch
    # 12 decoders of the video at once, each on its own thread, over its
    # first H264_P_AT_ONCE P pictures
    decoders = [decoder(True) for _ in range(12)]
    outs = [np.zeros((1, H5, W5, 3), np.uint8) for _ in range(12)]
    with ThreadPoolExecutor(12) as ex:     # each decodes the IDR first
        list(ex.map(lambda i: native.h264_decode_bgr_batch(
            video[:1], outs[i], decoders[i], threads=1), range(12)))

    def one_video(i):
        for chunk in video[1:1 + H264_P_AT_ONCE]:
            native.h264_decode_bgr_batch([chunk], outs[i], decoders[i],
                                         threads=1)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(12) as ex:
        list(ex.map(one_video, range(12)))
    times["P a frame of 12 videos"] = (time.perf_counter() - t0) * 1e3 / \
        (12 * H264_P_AT_ONCE)
    del decoders, outs
    log(f"  H.264 4K ({what}; {codec}, QPs {H264_QP}; host clock; "
        f"{cores} threads): the brightest video ({slices}): IDR "
        f"{times['IDR one thread']:.1f} ms on one thread, "
        f"{times['IDR all threads']:.1f} ms on {cores} threads (a slice a "
        f"thread), {times['IDR a frame of 12']:.1f} ms a frame of a batch "
        f"of 12 (a GOP a thread), each one run after a warm one; P "
        f"pictures {times['P one thread']:.1f} ms on one thread, "
        f"{times['P all threads']:.1f} ms on {cores} threads, "
        f"{times['P a frame of 12 videos']:.1f} ms a frame when 12 decoders "
        f"of the video run at once (a thread each), the first "
        f"{H264_P_AT_ONCE} after the IDR, one run; the one-slice stream "
        f"(IDR {len(chain[0]) / 1e6:.3f} MB, P pictures "
        f"{np.mean([len(c) for c in chain[1:]]) / 1e6:.3f} MB): IDR "
        f"{times['one slice IDR all threads']:.1f} ms, P "
        f"{times['one slice P all threads']:.1f} ms on {cores} threads (a "
        f"serial chain: only the deblocking and the conversion spread)")
    return times


def demux_h264(mp4, avi_path=None) -> dict:
    """The demux of a 4K H.264 MP4 (probed and every frame read, no
    decode), beside the Annex B AVI of the same bitstream where given;
    host clock, one run after a warm one.  Logs it and returns ms a
    frame."""
    from camera_linearity_tpu_torch.utils import containers
    timed = {}
    for kind, p in (("MP4", mp4), ("AVI", avi_path)):
        if p is None:
            continue
        for _ in range(2):     # a warm run, then the timed one
            t0 = time.perf_counter()
            i = containers.probe_video(p)
            size = sum(c.size for c in containers.frame_chunks(
                p, i, ring=FRAMES5))
            secs = time.perf_counter() - t0
        timed[kind] = (secs, size, i.codec_name)
    secs, size, codec = timed["MP4"]
    times = {"demux MP4 ms a frame": secs / FRAMES5 * 1e3}
    line = (f"  demux H.264 {codec} MP4 ({Path(mp4).name}): "
            f"{secs / FRAMES5 * 1e3:.3f} ms a 4K frame "
            f"({size / FRAMES5 / 1e6:.3f} MB), {size / 1e6 / secs:.0f} MB/s")
    if "AVI" in timed:
        times["demux AVI ms a frame"] = timed["AVI"][0] / FRAMES5 * 1e3
        line += (f"; the Annex B AVI of the same bitstream "
                 f"{timed['AVI'][0] / FRAMES5 * 1e3:.3f} ms a frame")
    log(line + " (the probe and every frame read, no decode; host clock, "
        "one run after a warm one)")
    return times


def h264_phase(h264_videos, v2h, run_video_to_hdr) -> dict:
    """Phase 14 (j): config 5 from H.264 (:class:`H264Videos`):
    ``video_to_hdr`` (K3) on the ``avc1`` MP4s, held bit for bit to
    ``video_to_hdr`` on I420 AVIs of the writer's reconstruction, and on
    the same bitstream in Annex B AVIs and in Matroska, each held to the
    MP4 run.  Times go into ``v2h``; returns 14 (j)'s."""
    from camera_linearity_tpu_torch.utils import avi, containers
    failures, out = [], {}
    info = containers.probe_video(h264_videos.mp4[0])
    log(f"phase 14 (j): config 5 from H.264 of phase 14's I420 planes "
        f"(tests/_torch_h264_enc.cpp: an IDR and {FRAMES5 - 1} P pictures a "
        f"video as x264 --profile baseline --tune zerolatency codes at its "
        f"defaults: QPs {H264_QP}, {H264_SLICES} slices a picture; a "
        f"reference list modification and an MMCO in the first video): "
        f"{avi.h264_unsupported(h264_videos.mp4[0], info) or 'read'}; the "
        f"avc1 MP4s held to I420 AVIs of the writer's reconstruction, the "
        f"Annex B AVIs and the Matroska files to the MP4s; {gpu_line()}")
    v2h["H.264 MP4"], _, got = run_video_to_hdr(
        "video_to_hdr (H.264 avc1 MP4)", h264_videos.mp4, "h264")
    v2h["I420 of the H.264 reconstruction"], _, want = run_video_to_hdr(
        "video_to_hdr (I420 of the H.264 reconstruction)",
        h264_videos.recon, "rawvideo")
    same = all(torch.equal(a, b) for a, b in zip(got, want))
    del want
    frame_mb = sum(c.size for p in h264_videos.mp4 for c in
                   containers.frame_chunks(p, containers.probe_video(p))) \
        / 1e6 / (FRAMES5 * len(h264_videos.mp4))
    mps = FRAMES5 * len(h264_videos.mp4) * H5 * W5 / 1e6 / v2h["H.264 MP4"]
    out["MP4"] = dict(wall_s=v2h["H.264 MP4"], mps=mps, k3_launches=1,
                      frame_mb=frame_mb)
    log(f"  {'ok ' if same else 'BAD'} video_to_hdr from the avc1 MP4s vs "
        f"I420 of the writer's reconstruction: "
        f"{'bit for bit equal' if same else 'different'}; "
        f"{v2h['H.264 MP4']:.3f} s, {mps:.2f} MP/s ({FRAMES5} x "
        f"{len(h264_videos.mp4)} frames of {H5} x {W5}, {frame_mb:.3f} MB a "
        f"frame), one K3 launch")
    if not same:
        failures.append("video_to_hdr from the H.264 MP4s against the "
                        "reconstruction")
    for kind, paths in (("AVI", h264_videos.avi), ("Matroska",
                                                   h264_videos.mkv)):
        label = f"video_to_hdr (H.264 in {kind})"
        v2h[f"H.264 {kind}"], _, other = run_video_to_hdr(label, paths,
                                                          "h264")
        same = all(torch.equal(a, b) for a, b in zip(other, got))
        mps = FRAMES5 * len(paths) * H5 * W5 / 1e6 / v2h[f"H.264 {kind}"]
        out[kind] = dict(wall_s=v2h[f"H.264 {kind}"], mps=mps,
                         k3_launches=1)
        log(f"  {'ok ' if same else 'BAD'} {label} vs the MP4 run of the "
            f"same bitstream: {'bit for bit equal' if same else 'different'}"
            f"; {v2h[f'H.264 {kind}']:.3f} s, {mps:.2f} MP/s, one K3 launch")
        if not same:
            failures.append(f"{label} against the MP4")
        del other
    del got
    raise_failures("phase 14 (j)", failures)
    return out


def h264_high_rows(high) -> dict:
    """Phase 12's High rows, after the Constrained Baseline ones: ``high``'s
    (:class:`H264HighWork`, coded from the smoke's start) strip decoded
    natively and held to ``h264_plain.py``'s frames and the writer's
    reconstruction; the brightest of its three 4K videos at the High
    traffic read from its MP4 and held to its reconstruction, its one-slice
    stream likewise; then :func:`h264_times` on them, and the MP4's demux.
    (The committed ``tests/data/h264 high *`` clips are among
    :func:`h264_clips`'.)  Returns the rows' times."""
    from camera_linearity_tpu_torch import native
    from camera_linearity_tpu_torch.utils import avi, containers
    got = high.result()
    secs = got["seconds"]
    failures = []
    data, plain, recon = got["strip"]
    rows, width = plain.shape[1:3]
    out = np.empty((len(data), rows, width, 3), np.uint8)
    native.h264_decode_bgr_batch(data, out, native.H264Decoder())
    same = np.array_equal(out, plain) and np.array_equal(out, recon)
    log(f"  {'ok ' if same else 'BAD'} H.264 High strip of {rows} x {width}, "
        f"{len(data)} pictures (tests/_torch_h264_writer.high_sink: CABAC at "
        f"each cabac_init_idc, Intra 8x8 and 4x4, the 8x8 transform on P "
        f"macroblocks, explicit weights, several slices and references, "
        f"MMCOs; {sum(map(len, data)) / 1e3:.0f} kB): native "
        f"{'equals' if same else 'differs from'} h264_plain.py and the "
        f"writer's reconstruction, max |.| {max_gap(out, plain):.0f} DN "
        f"(the plain decode {secs[3]:.1f} s in the High process)")
    if not same:
        failures.append("the H.264 High strip")
    del out, plain, recon
    info = containers.probe_video(high.mp4[H264_TIMED])
    video = [bytes(c) for c in containers.frame_chunks(high.mp4[H264_TIMED],
                                                        info)]
    why = avi.h264_unsupported(high.mp4[H264_TIMED], info)
    frames = np.empty((len(video), H5, W5, 3), np.uint8)
    native.h264_decode_bgr_batch(video, frames,
                                 native.H264Decoder(avi.h264_params(info)))
    want = np.empty_like(frames)
    native.raw_decode_bgr_batch([bytes(c) for c in avi.raw_chunks(
        high.recon[H264_TIMED], avi.probe_avi(high.recon[H264_TIMED]))],
        want, "i420")
    same = np.array_equal(frames, want)
    del want
    log(f"  {'ok ' if same else 'BAD'} H.264 High 4K video "
        f"({info.codec_name} MP4, {why or 'read'}; CABAC, 8x8dct, weightp "
        f"2, {H264_SLICES} slices a picture, QPs {H264_QP}; IDR "
        f"{len(video[0]) / 1e6:.3f} MB, P pictures "
        f"{np.mean([len(c) for c in video[1:]]) / 1e6:.3f} MB): its "
        f"{len(video)} frames {'equal' if same else 'differ from'} the "
        f"writer's reconstruction (coded in a process of its own from the "
        f"smoke's start: {secs[0]:.1f} s building, {secs[1]:.1f} s making "
        f"the content, {secs[2]:.1f} s coding; {got['waited']:.1f} s waited "
        f"for it here)")
    if not same or why:
        failures.append("the H.264 High 4K video")
    chain, recon = got["chain"]
    out = np.empty_like(recon)
    native.h264_decode_bgr_batch(chain, out, native.H264Decoder())
    same = np.array_equal(out, recon)
    log(f"  {'ok ' if same else 'BAD'} H.264 High 4K one-slice stream of the "
        f"same pictures ({len(chain)} pictures): native "
        f"{'equals' if same else 'differs from'} the writer's "
        f"reconstruction")
    if not same:
        failures.append("the H.264 High 4K one-slice stream")
    del out, recon
    raise_failures("phase 12, the H.264 decoder on High streams against its "
                   "plain version and the writer's reconstruction", failures)
    times = h264_times(video, chain, avi.h264_params(info), frames,
                       info.codec_name, f"{H264_SLICES} slices",
                       what="High: CABAC, 8x8dct, weightp 2")
    del frames
    times.update(demux_h264(high.mp4[H264_TIMED]))
    return {f"h264 high {k}": v for k, v in times.items()}


def h264_high_phase(high, v2h, run_video_to_hdr) -> dict:
    """Phase 14 (k): config 5 from H.264 High (:class:`H264HighWork`):
    ``video_to_hdr`` (K3) on the three ``avc1`` MP4s at the High traffic,
    held bit for bit to ``video_to_hdr`` on I420 AVIs of the writer's
    reconstruction.  Times go into ``v2h``; returns 14 (k)'s."""
    from camera_linearity_tpu_torch.utils import avi, containers
    failures = []
    info = containers.probe_video(high.mp4[0])
    log(f"phase 14 (k): config 5 from H.264 High MP4s (config 5's content "
        f"made again on the host from seed {SEED}; tests/_torch_h264_enc.cpp:"
        f" an IDR and {FRAMES5 - 1} P pictures a video as x264 --profile "
        f"high --tune zerolatency codes at its defaults: CABAC, 8x8dct, "
        f"Intra 8x8 and 4x4, weightp 2, QPs {H264_QP}, {H264_SLICES} slices "
        f"a picture; a duplicated, weighted reference in the first video): "
        f"{avi.h264_unsupported(high.mp4[0], info) or 'read'}; held to I420 "
        f"AVIs of the writer's reconstruction; {gpu_line()}")
    v2h["H.264 High MP4"], _, got = run_video_to_hdr(
        "video_to_hdr (H.264 High avc1 MP4)", high.mp4, "h264")
    v2h["I420 of the H.264 High reconstruction"], _, want = run_video_to_hdr(
        "video_to_hdr (I420 of the H.264 High reconstruction)", high.recon,
        "rawvideo")
    same = all(torch.equal(a, b) for a, b in zip(got, want))
    del got, want
    frame_mb = sum(c.size for p in high.mp4 for c in
                   containers.frame_chunks(p, containers.probe_video(p))) \
        / 1e6 / (FRAMES5 * len(high.mp4))
    mps = FRAMES5 * len(high.mp4) * H5 * W5 / 1e6 / v2h["H.264 High MP4"]
    log(f"  {'ok ' if same else 'BAD'} video_to_hdr from the High avc1 MP4s "
        f"vs I420 of the writer's reconstruction: "
        f"{'bit for bit equal' if same else 'different'}; "
        f"{v2h['H.264 High MP4']:.3f} s, {mps:.2f} MP/s ({FRAMES5} x "
        f"{len(high.mp4)} frames of {H5} x {W5}, {frame_mb:.3f} MB a "
        f"frame), one K3 launch")
    if not same:
        failures.append("video_to_hdr from the H.264 High MP4s against the "
                        "reconstruction")
    raise_failures("phase 14 (k)", failures)
    return {"MP4": dict(wall_s=v2h["H.264 High MP4"], mps=mps, k3_launches=1,
                        frame_mb=frame_mb)}


class ContainerVideos:
    """Phase 14 (i)'s files: bitstreams of phase 14's AVIs remuxed by the
    test muxers (``tests/_torch_mp4_writer.py``, ``tests/_torch_mkv_
    writer.py``) into ``directory``: 14 (g)'s ``FMP4`` and 14 (h)'s
    ``XVID`` videos into MP4 (``mp4v``), a copy of the brightest ``FMP4``
    one under a 90-degree ``tkhd`` matrix, phase 14's default-decoder MJPG
    scene into QuickTime MOV (``jpeg``) and 14 (d)'s FFV1 scene into
    Matroska (``V_FFV1``, the stream's extradata as its CodecPrivate).
    :meth:`write` muxes them, in phase 12's window (no call is timed
    beside it), and returns its seconds."""

    def __init__(self, directory):
        self.directory = directory
        self.fmp4, self.xvid, self.mjpeg, self.ffv1 = [], [], [], []
        self.turned, self.sources = None, {}

    def write(self, mpeg4_videos, lossless_videos, mjpg_paths) -> float:
        from camera_linearity_tpu_torch.utils import avi
        from tests import _torch_ffv1_writer as fw
        from tests import _torch_mkv_writer as kw
        from tests import _torch_mp4_writer as mw
        t0 = time.perf_counter()

        def chunks(path):
            return [bytes(c) for c in avi.frame_chunks(path,
                                                       avi.probe_avi(path))]
        for src in mpeg4_videos.fmp4:
            out = self.directory / f"{src.stem}.mp4"
            mw.write_mp4(out, [mw.video_track(chunks(src), H5, W5, b"mp4v",
                                              [mw.esds(b"")])])
            self.fmp4.append(out)
        self.turned = self.directory / f"turned {mpeg4_videos.fmp4[-1].stem}.mp4"
        mw.write_mp4(self.turned, [mw.video_track(
            chunks(mpeg4_videos.fmp4[-1]), H5, W5, b"mp4v", [mw.esds(b"")],
            matrix=mw.rotation_matrix(90))])
        for src in mpeg4_videos.asp:
            out = self.directory / f"{src.stem}.mp4"
            mw.write_mp4(out, [mw.video_track(chunks(src), H5, W5, b"mp4v",
                                              [mw.esds(b"")])])
            self.xvid.append(out)
        for src in mjpg_paths:
            out = self.directory / f"mjpeg {src.stem}.mov"
            mw.write_mp4(out, [mw.video_track(chunks(src), H5, W5, b"jpeg",
                                              qt=True)], qt=True)
            self.mjpeg.append(out)
        extra = fw.extradata(fw.cv2_config("bgr", H5, W5))
        for src in lossless_videos.written["FFV1"]:
            out = self.directory / f"{src.stem}.mkv"
            kw.write_mkv(out, [kw.video_track(chunks(src), H5, W5, "V_FFV1",
                                              extra)])
            self.ffv1.append(out)
        self.sources = dict(fmp4=mpeg4_videos.fmp4[-1],
                            ffv1=lossless_videos.written["FFV1"][-1])
        return time.perf_counter() - t0


def demux_rows(container_videos) -> dict:
    """Phase 12's demux rows: the brightest MP4 (``FMP4``) and Matroska
    (FFV1) video of phase 14 (i) probed and every frame read (no decode),
    beside the same bitstream's AVI walked by ``avi.frame_chunks``; host
    clock, one run after a warm one; ms a 4K frame and MB/s."""
    from camera_linearity_tpu_torch.utils import containers
    rows = {}
    for name, path, src in (
            ("MP4 (FMP4)", container_videos.fmp4[-1],
             container_videos.sources["fmp4"]),
            ("Matroska (FFV1)", container_videos.ffv1[-1],
             container_videos.sources["ffv1"])):
        timed = {}
        for kind, p in (("container", path), ("AVI", src)):
            for _ in range(2):     # a warm run, then the timed one
                t0 = time.perf_counter()
                info = containers.probe_video(p)
                size = sum(c.size for c in containers.frame_chunks(
                    p, info, ring=FRAMES5))
                secs = time.perf_counter() - t0
            timed[kind] = (secs, size)
        secs, size = timed["container"]
        avi_s = timed["AVI"][0]
        rows[f"demux {name}"] = dict(
            ms_per_frame=secs / FRAMES5 * 1e3, mb_per_s=size / 1e6 / secs,
            frame_mb=size / FRAMES5 / 1e6,
            avi_ms_per_frame=avi_s / FRAMES5 * 1e3)
        log(f"  demux {name}: {secs / FRAMES5 * 1e3:.3f} ms a 4K frame "
            f"({size / FRAMES5 / 1e6:.3f} MB), {size / 1e6 / secs:.0f} MB/s"
            f"; the AVI of the same bitstream {avi_s / FRAMES5 * 1e3:.3f} ms"
            f" a frame (the probe and every frame read, no decode; host "
            f"clock, one run after a warm one)")
    return rows


def container_clips() -> list:
    """Phase 12's check of the committed ``tests/data/container *`` clips
    (MP4, MOV and Matroska files cv2 wrote, and the test muxer's, one
    under a 90-degree matrix, one of B-VOPs with ``ctts``): each through
    ``video_frame_generator`` (the card's machine has no cv2) against its
    ``.cv2.npy``; a line each, and the names that differ."""
    from camera_linearity_tpu_torch.models import video
    from camera_linearity_tpu_torch.utils import containers
    failures = []
    for clip in sorted((ROOT / "tests" / "data").glob("container *")):
        if clip.suffix not in (".mp4", ".mov", ".mkv"):
            continue
        cv = np.load(clip.with_suffix(".cv2.npy"))
        info = containers.probe_video(clip)
        got = np.stack([f for f in video.video_frame_generator(clip)
                        if f is not None])
        same = got.shape == cv.shape and np.array_equal(got, cv)
        log(f"  {'ok ' if same else 'BAD'} '{clip.name}' ({info.container_name}"
            f", {info.codec_name}{f', turned {info.rotation}' if info.rotation else ''}"
            f", {len(cv)} x {cv.shape[1]} x {cv.shape[2]}): "
            f"{'equals' if same else 'differs from'} the committed "
            f"cv2.VideoCapture frames")
        if not same:
            failures.append(clip.name)
    return failures


def mpeg4_clips() -> list:
    """Phase 12's check of the committed ``tests/data/mpeg4 *.avi``: each
    decoded natively against its ``.cv2.npy`` (cv2's frames, taken where
    cv2 is): a line each, and the names that differ."""
    from camera_linearity_tpu_torch import native
    from camera_linearity_tpu_torch.utils import avi
    failures = []
    for clip in sorted((ROOT / "tests" / "data").glob("mpeg4 *.avi")):
        cv = np.load(clip.with_suffix(".cv2.npy"))
        info = avi.probe_avi(clip)
        chunks = [bytes(c) for c in avi.frame_chunks(clip, info)]
        dec = native.Mpeg4Decoder(*avi.mpeg4_params(info), info.height,
                                  info.width)
        got = np.empty((len(chunks) + 1, info.height, info.width, 3),
                       np.uint8)
        n = native.mpeg4_decode_bgr_batch(chunks, got, dec)
        n += native.mpeg4_flush(dec, got[n:])
        same = got[:n].shape == cv.shape and np.array_equal(got[:n], cv)
        log(f"  {'ok ' if same else 'BAD'} MPEG-4 decode of '{clip.name}' "
            f"({info.codec}, {len(cv)} x {cv.shape[1]} x {cv.shape[2]}): "
            f"{'equals' if same else 'differs from'} the committed "
            f"cv2.VideoCapture frames")
        if not same:
            failures.append(clip.name)
    return failures


def mpeg4_rows(strip, asp_strip, videos) -> dict:
    """Phase 12's MPEG-4 Part 2 rows, after its plain-decode window:
    ``strip`` (:func:`mpeg4_strip`'s result from the pool) decoded
    natively and held to the plain frames and the writer's
    reconstruction; the committed clips against cv2's frames; then the
    brightest 4K video of ``videos`` (:class:`Mpeg4Videos`, coded in the
    window) decoded and held to its reconstruction, and timed (host clock,
    a run each after a warm one): its I-VOP on one thread, on every core
    (a macroblock row a thread) and as a frame of a batch of 12 I-VOPs in
    one call (the GOPs side by side, a GOP a thread); its 11 P-VOPs on
    one thread and on every core (a frame parsed while the one before it
    is rebuilt), and as frames of 12 decoders of the video run at once (a
    thread each).  The Advanced Simple rows alike: ``asp_strip``
    (:func:`mpeg4_asp_strip`), unpacked and packed, held to the plain
    frames and the reconstruction; the brightest 4K ``XVID`` video held
    to its reconstruction; its Xvid-IDCT I-VOP (MPEG quantisation) on one
    thread, on every core and as a frame of a batch of 12 I-VOPs, and a
    B-VOP (from a packed chunk) on one thread, on every core and as a
    frame of 12 decoders at once.  Returns the rows' times."""
    from concurrent.futures import ThreadPoolExecutor
    from camera_linearity_tpu_torch import native
    from camera_linearity_tpu_torch.utils import avi
    failures = mpeg4_clips()
    chunks, plain, recon = strip
    rows, width = plain.shape[1:3]
    dec = native.Mpeg4Decoder("FMP4", b"", rows, width)
    got = np.empty((len(chunks), rows, width, 3), np.uint8)
    native.mpeg4_decode_bgr_batch(chunks, got, dec)
    strip_same = np.array_equal(got, plain) and np.array_equal(got, recon)
    log(f"  {'ok ' if strip_same else 'BAD'} MPEG-4 strip of {rows} x "
        f"{width}, {len(chunks)} frames (I-VOP, then P-VOPs of skipped, "
        f"1MV, 4MV and intra macroblocks, vectors past the edges, dquant, "
        f"AC prediction, both rounding types; "
        f"{sum(map(len, chunks)) / 1e3:.0f} kB): native "
        f"{'equals' if strip_same else 'differs from'} mpeg4_plain.py and "
        f"the writer's reconstruction, max |.| {max_gap(got, plain):.0f} DN")
    if not strip_same:
        failures.append("the MPEG-4 strip")
    unpacked, packed, asp_plain, asp_recon = asp_strip
    outs = []
    for chunks_ in (unpacked, packed):
        dec = native.Mpeg4Decoder("XVID", b"", rows, width)
        got = np.empty((len(chunks_) + 1, rows, width, 3), np.uint8)
        n = native.mpeg4_decode_bgr_batch(chunks_, got, dec)
        n += native.mpeg4_flush(dec, got[n:])
        outs.append(got[:n])
    asp_same = all(o.shape == asp_plain.shape and np.array_equal(o, asp_plain)
                   for o in outs) and np.array_equal(asp_plain, asp_recon)
    gap = max((max_gap(o, asp_plain) for o in outs
               if o.shape == asp_plain.shape), default=-1)
    log(f"  {'ok ' if asp_same else 'BAD'} MPEG-4 Advanced Simple strip of "
        f"{rows} x {width}, {len(asp_plain)} frames (B-VOPs of every kind "
        f"two between references, packed and unpacked; Xvid IDCT; "
        f"quant_type 1, custom matrices; {sum(map(len, packed)) / 1e3:.0f} "
        f"kB): native {'equals' if asp_same else 'differs from'} "
        f"mpeg4_plain.py and the writer's reconstruction, max |.| {gap:.0f} "
        f"DN")
    if not asp_same:
        failures.append("the MPEG-4 Advanced Simple strip")
    info = avi.probe_avi(videos.fmp4[-1])
    tag, extra = avi.mpeg4_params(info)
    why = avi.mpeg4_unsupported(videos.fmp4[-1], info)
    firsts = [bytes(next(iter(avi.frame_chunks(p, avi.probe_avi(p)))))
              for p in videos.fmp4]
    video = [bytes(c) for c in avi.frame_chunks(videos.fmp4[-1], info)]
    frames = np.empty((len(video), H5, W5, 3), np.uint8)
    native.mpeg4_decode_bgr_batch(video, frames,
                                  native.Mpeg4Decoder(tag, extra, H5, W5))
    recon_chunks = [bytes(c) for c in avi.raw_chunks(
        videos.recon[-1], avi.probe_avi(videos.recon[-1]))]
    want = np.empty_like(frames)
    native.raw_decode_bgr_batch(recon_chunks, want, "i420")
    same = np.array_equal(frames, want)
    del want
    log(f"  {'ok ' if same else 'BAD'} MPEG-4 4K video ({info.codec}, "
        f"{why or 'read'}; I-VOP {len(video[0]) / 1e6:.3f} MB, P-VOPs "
        f"{np.mean([len(c) for c in video[1:]]) / 1e6:.3f} MB): its "
        f"{len(video)} frames {'equal' if same else 'differ from'} the "
        f"writer's reconstruction")
    if not same or why:
        failures.append("the MPEG-4 4K video")
    asp_info = avi.probe_avi(videos.asp[-1])
    asp_tag, asp_extra = avi.mpeg4_params(asp_info)
    asp_why = avi.mpeg4_unsupported(videos.asp[-1], asp_info)
    asp_video = [bytes(c) for c in avi.frame_chunks(videos.asp[-1], asp_info)]
    asp_firsts = [bytes(next(iter(avi.frame_chunks(p, avi.probe_avi(p)))))
                  for p in videos.asp]
    asp_frames = np.empty((len(asp_video) + 1, H5, W5, 3), np.uint8)
    dec = native.Mpeg4Decoder(asp_tag, asp_extra, H5, W5)
    n = native.mpeg4_decode_bgr_batch(asp_video, asp_frames, dec)
    n += native.mpeg4_flush(dec, asp_frames[n:])
    recon_chunks = [bytes(c) for c in avi.raw_chunks(
        videos.asp_recon[-1], avi.probe_avi(videos.asp_recon[-1]))]
    want = np.empty((len(recon_chunks), H5, W5, 3), np.uint8)
    native.raw_decode_bgr_batch(recon_chunks, want, "i420")
    asp_same = n == len(want) and np.array_equal(asp_frames[:n], want)
    del want
    log(f"  {'ok ' if asp_same else 'BAD'} MPEG-4 Advanced Simple 4K video "
        f"({asp_info.codec}, {asp_why or 'read'}; I-VOP "
        f"{len(asp_video[0]) / 1e6:.3f} MB, packed P- and B-VOP chunks "
        f"{np.mean([len(c) for c in asp_video[1:] if len(c) > 100]) / 1e6:.3f}"
        f" MB): its {n} frames from {len(asp_video)} chunks "
        f"{'equal' if asp_same else 'differ from'} the writer's "
        f"reconstruction")
    if not asp_same or asp_why:
        failures.append("the MPEG-4 Advanced Simple 4K video")
    raise_failures("phase 12, the MPEG-4 decoder against its plain version, "
                   "the writer's reconstruction and the committed clips",
                   failures)
    cores = os.cpu_count() or 1

    def fresh():
        return native.Mpeg4Decoder(tag, extra, H5, W5)
    one = frames[:1]
    times = {}
    # a decoder a timed call, made before it (the decode above warmed
    # every path)
    d1, d2, d3 = fresh(), fresh(), fresh()
    times["I one thread"] = host_ms(lambda: native.mpeg4_decode_bgr_batch(
        video[:1], one, d1, threads=1), runs=1, warmup=0)
    times["I all threads"] = host_ms(lambda: native.mpeg4_decode_bgr_batch(
        video[:1], one, d2), runs=1, warmup=0)
    batch = np.zeros((12, H5, W5, 3), np.uint8)
    gops = (firsts * 12)[:12]
    times["I a frame of 12"] = host_ms(
        lambda: native.mpeg4_decode_bgr_batch(gops, batch, d3), runs=1,
        warmup=0) / 12

    def p_time(threads):
        d = fresh()
        native.mpeg4_decode_bgr_batch(video[:1], one, d)
        t0 = time.perf_counter()
        native.mpeg4_decode_bgr_batch(video[1:], frames[1:], d,
                                      threads=threads)
        return (time.perf_counter() - t0) * 1e3 / (len(video) - 1)
    times["P one thread"] = p_time(1)
    times["P all threads"] = p_time(None)
    # 12 decoders of the video at once, each on its own thread and frame
    decoders = [fresh() for _ in range(12)]
    outs = [np.zeros((1, H5, W5, 3), np.uint8) for _ in range(12)]
    with ThreadPoolExecutor(12) as ex:     # each decodes the I-VOP first
        list(ex.map(lambda i: native.mpeg4_decode_bgr_batch(
            video[:1], outs[i], decoders[i], threads=1), range(12)))

    def one_video(i):
        for chunk in video[1:]:
            native.mpeg4_decode_bgr_batch([chunk], outs[i], decoders[i],
                                          threads=1)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(12) as ex:
        list(ex.map(one_video, range(12)))
    times["P a frame of 12 videos"] = (time.perf_counter() - t0) * 1e3 / \
        (12 * (len(video) - 1))
    del decoders, outs, batch, frames
    log(f"  MPEG-4 4K ({info.codec}, quantiser {MPEG4_QUANT}, host clock, "
        f"one run after a warm one; {cores} threads): I-VOP "
        f"{times['I one thread']:.1f} ms on one thread, "
        f"{times['I all threads']:.1f} ms one frame on {cores} threads (a "
        f"macroblock row a thread), {times['I a frame of 12']:.1f} ms a "
        f"frame of a batch of 12 (a GOP a thread); P-VOP "
        f"{times['P one thread']:.1f} ms on one thread, "
        f"{times['P all threads']:.1f} ms a frame on {cores} threads "
        f"({len(video) - 1} in a call), "
        f"{times['P a frame of 12 videos']:.1f} ms a frame when 12 "
        f"decoders of the video run at once (a thread each)")
    # the Advanced Simple video: its Xvid-IDCT I-VOP, and a B-VOP (the one
    # the second chunk holds after its P-VOP, decoded with the third)
    def asp_fresh():
        return native.Mpeg4Decoder(asp_tag, asp_extra, H5, W5)
    one = asp_frames[:1]
    d1, d2, d3 = asp_fresh(), asp_fresh(), asp_fresh()
    times["ASP I one thread"] = host_ms(
        lambda: native.mpeg4_decode_bgr_batch(asp_video[:1], one, d1,
                                              threads=1), runs=1, warmup=0)
    times["ASP I all threads"] = host_ms(
        lambda: native.mpeg4_decode_bgr_batch(asp_video[:1], one, d2),
        runs=1, warmup=0)
    batch = np.zeros((12, H5, W5, 3), np.uint8)
    gops = (asp_firsts * 12)[:12]
    times["ASP I a frame of 12"] = host_ms(
        lambda: native.mpeg4_decode_bgr_batch(gops, batch, d3), runs=1,
        warmup=0) / 12
    del batch

    def primed():
        d = asp_fresh()
        native.mpeg4_decode_bgr_batch(asp_video[:2], asp_frames[:2], d)
        return d

    def b_time(threads):
        d = primed()
        t0 = time.perf_counter()
        native.mpeg4_decode_bgr_batch(asp_video[2:3], one, d,
                                      threads=threads)
        return (time.perf_counter() - t0) * 1e3
    times["ASP B one thread"] = b_time(1)
    times["ASP B all threads"] = b_time(None)
    decoders = [primed() for _ in range(12)]
    outs = [np.zeros((1, H5, W5, 3), np.uint8) for _ in range(12)]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(12) as ex:
        list(ex.map(lambda i: native.mpeg4_decode_bgr_batch(
            asp_video[2:3], outs[i], decoders[i], threads=1), range(12)))
    times["ASP B a frame of 12 decoders"] = (time.perf_counter() - t0) * \
        1e3 / 12
    del decoders, outs, asp_frames
    log(f"  MPEG-4 Advanced Simple 4K ({asp_info.codec}, quantiser "
        f"{MPEG4_QUANT}, quant_type 1, Xvid IDCT; host clock, one run after "
        f"a warm one; {cores} threads): I-VOP "
        f"{times['ASP I one thread']:.1f} ms on one thread, "
        f"{times['ASP I all threads']:.1f} ms one frame on {cores} threads, "
        f"{times['ASP I a frame of 12']:.1f} ms a frame of a batch of 12; "
        f"B-VOP {times['ASP B one thread']:.1f} ms on one thread, "
        f"{times['ASP B all threads']:.1f} ms on {cores} threads, "
        f"{times['ASP B a frame of 12 decoders']:.1f} ms a frame when 12 "
        f"decoders run at once (a thread each)")
    return {f"mpeg4 {k}": v for k, v in times.items()}


# phase 14 (c)'s one batch_video_to_hdr call: (codec, its scenes), and the
# decoder each codec's frames go through
MIXED = (("PNG", 1), ("HFYU RGB24", 1), ("FFV1", 2), ("ULRG", 2),
         ("LAGS RGB24", 2))
DECODED_AS = {"PNG": "png", "HFYU RGB24": "huffyuv", "FFV1": "ffv1",
              "ULRG": "utvideo", "ULY0": "utvideo", "LAGS RGB24": "lagarith",
              "LAGS YV12": "lagarith"}


def container_phase(container_videos, mpeg4_videos, avi_v2h, v2h,
                    run_video_to_hdr) -> dict:
    """Phase 14 (i): config 5 from MP4, QuickTime MOV and Matroska files
    (:class:`ContainerVideos`): ``video_to_hdr`` (K3) on 14 (g)'s ``FMP4``
    and 14 (h)'s ``XVID`` bitstreams in MP4, phase 14's MJPG scene in MOV
    and 14 (d)'s FFV1 scene in Matroska, each held bit for bit to the AVI
    run of the same bitstream (``avi_v2h``); and ``welford_algorithm``
    (host backend) on the ``FMP4`` MP4 under a 90-degree matrix, its mean
    and std held exactly to ``np.rot90`` of the same run on the AVI (the
    statistic is per pixel).  Times go into ``v2h``; returns 14 (i)'s."""
    from camera_linearity_tpu_torch.models import video
    from camera_linearity_tpu_torch.utils import containers
    failures, out = [], {}
    infos = {name: containers.probe_video(paths[0]) for name, paths in (
        ("FMP4", container_videos.fmp4), ("XVID", container_videos.xvid),
        ("MJPG", container_videos.mjpeg), ("FFV1", container_videos.ffv1))}
    log("phase 14 (i): config 5 from MP4, QuickTime MOV and Matroska files "
        "of phase 14's bitstreams (tests/_torch_mp4_writer.py, tests/"
        "_torch_mkv_writer.py): " + ", ".join(
            f"{name} in {i.container_name} ({i.codec_name})"
            for name, i in infos.items()) + f"; {gpu_line()}")
    for name, paths, decoded_as in (
            ("FMP4", container_videos.fmp4, "mpeg4"),
            ("XVID", container_videos.xvid, "mpeg4"),
            ("MJPG", container_videos.mjpeg, "ffmpeg"),
            ("FFV1", container_videos.ffv1, "ffv1")):
        kind = infos[name].container_name
        label = f"video_to_hdr ({name} in {kind})"
        v2h[f"{name} {kind}"], _, got = run_video_to_hdr(label, paths,
                                                         decoded_as)
        same = all(torch.equal(a, b) for a, b in zip(got, avi_v2h[name]))
        mps = FRAMES5 * len(paths) * H5 * W5 / 1e6 / v2h[f"{name} {kind}"]
        out[f"{name} {kind}"] = dict(wall_s=v2h[f"{name} {kind}"], mps=mps,
                                     k3_launches=1)
        log(f"  {'ok ' if same else 'BAD'} {label} vs the AVI of the same "
            f"bitstream: {'bit for bit equal' if same else 'different'}; "
            f"{v2h[f'{name} {kind}']:.3f} s, {mps:.2f} MP/s, one K3 launch")
        if not same:
            failures.append(f"{label} against the AVI")
        del got
    # the default batch (32): each geometry's first call faults its decode
    # pool in (and the turned one its scratch batch), its second finds
    # them warm
    walls = {"turned": [], "AVI": []}
    stats = {}
    for _ in range(2):
        for name, path in (("turned", container_videos.turned),
                           ("AVI", mpeg4_videos.fmp4[-1])):
            t0 = time.perf_counter()
            stats[name] = video.welford_algorithm(path, use_std=True)
            walls[name].append(time.perf_counter() - t0)
    turned, flat = stats["turned"], stats["AVI"]
    info = containers.probe_video(container_videos.turned)
    same = all(np.array_equal(turned[k], np.rot90(flat[k], -1))
               for k in ("mean", "std"))
    out["welford turned MP4"] = dict(
        wall_s=walls["turned"][1], avi_wall_s=walls["AVI"][1],
        first_wall_s=walls["turned"][0], avi_first_wall_s=walls["AVI"][0],
        batch_size=32, shape=list(turned["mean"].shape))
    log(f"  {'ok ' if same else 'BAD'} welford_algorithm (host backend, "
        f"its default batch of 32) on the FMP4 MP4 under a "
        f"{info.rotation}-degree tkhd matrix: mean and std "
        f"{tuple(turned['mean'].shape)} "
        f"{'equal' if same else 'differ from'} np.rot90 of the AVI's "
        f"{tuple(flat['mean'].shape)}; host clock, first / second call: "
        f"{walls['turned'][0]:.3f} / {walls['turned'][1]:.3f} s, the "
        f"AVI's {walls['AVI'][0]:.3f} / {walls['AVI'][1]:.3f} s")
    if not same:
        failures.append("welford_algorithm on the turned MP4 against the "
                        "AVI's turned")
    raise_failures("phase 14 (i)", failures)
    return out


def lossless_phase(videos, mpeg4_videos, raw, i420, runs, run_batch,
                   run_video_to_hdr, container_videos, mjpg_v2h,
                   h264_videos=None, h264_high=None) -> dict:
    """Phases 14 (c)-(f): config 5 from the lossless compressed AVIs
    ImageJ/Fiji, ``cv2.VideoWriter``, archives and capture tools write,
    phase 14's raw frames as ``videos`` (:class:`LosslessVideos`, written
    in phase 12) holds them.  (c): ONE ``batch_video_to_hdr`` (K1, B = 8) at
    the default decoder whose 8 scenes' videos are PNG, HuffYUV, FFV1,
    ``ULRG`` and Lagarith RGB24 AVIs (``MIXED``: one PNG and one HuffYUV
    scene, two of each other codec; each file takes its own decoder),
    equal to phase 14's raw u16/f16 results bit for bit (``raw``), the
    codecs being lossless; then ``video_to_hdr`` (K3) on the PNG and the
    HuffYUV scene; (d) on the FFV1 one; (e) on the ``ULRG`` one, each equal
    to raw's, and on the ``ULY0`` AVIs of phase 14's I420 planes, equal to
    phase 14's I420 ``video_to_hdr`` (``i420``); (f) on the Lagarith RGB24
    scene, equal to raw's, and on the Lagarith YV12 AVIs of the I420
    planes, equal to I420's; (g) on the MPEG-4 Part 2 (``FMP4``) AVIs of
    the I420 planes (``mpeg4_videos``, :class:`Mpeg4Videos`), equal to
    ``video_to_hdr`` on I420 AVIs of the writer's reconstruction, its wall,
    K3's launches and MP/s; (h) likewise on ``XVID``; (i) on the MP4, MOV
    and Matroska files of ``container_videos`` (:func:`container_phase`),
    held to the AVI runs of the same bitstreams (``mjpg_v2h``: phase 14's
    MJPG ``video_to_hdr``); (j) on the H.264 videos of ``h264_videos``
    (:func:`h264_phase`).  Returns the phases' times (``encode_s`` None
    where the cache had the videos)."""
    from camera_linearity_tpu_torch.utils import avi
    t_phase = time.perf_counter()
    log(f"phase 14 (c): config 5 from PNG, HuffYUV, FFV1, UtVideo and "
        f"Lagarith AVIs of phase 14's raw frames in one call ("
        + ", ".join(f"{c}: {k}" for c, k in MIXED) + f" scenes); "
        f"{gpu_line()}")
    failures = []
    written, sizes, encode_s = videos.written, videos.sizes, videos.encode_s
    # the chunks alone, as the frame fillers read them (no decode)
    t0 = time.perf_counter()
    one = written["PNG"][0]
    read_mb = sum(c.size for c in avi.frame_chunks(
        one, avi.probe_avi(one), ring=FRAMES5)) / 1e6
    read_s = time.perf_counter() - t0
    n = FRAMES5 * len(written["PNG"])
    log(f"  {n} distinct frames per codec "
        + ("from the cache" if encode_s is None else
           f"encoded in {encode_s:.1f} s in phase 12") + ": "
        + ", ".join(f"{k} {v / n / 1e6:.2f} MB a frame"
                    for k, v in sizes.items())
        + f"; one PNG video's chunks read (no decode) at "
        f"{read_mb / read_s:.0f} MB/s ({read_mb:.0f} MB, host clock)")
    before = runs[raw["label"]]
    label = ("batch_video_to_hdr u16/f16 ("
             + ", ".join(f"{c} x {k}" for c, k in MIXED) + " scenes, auto)")
    scenes = [written[c] for c, k in MIXED for _ in range(k)]
    assert len(scenes) == SCENES5
    run = run_batch(label, scenes, {DECODED_AS[c]: k * n for c, k in MIXED})
    run.pop("merge")
    out = run.pop("out")
    runs[label] = run
    same = list(out) == list(raw["out"]) and all(
        torch.equal(a, b) for name, pair in out.items()
        for a, b in zip(pair, raw["out"][name]))
    log(f"  {'ok ' if same else 'BAD'} batch_video_to_hdr from "
        f"{', '.join(c for c, _ in MIXED)} vs phase 14's raw "
        f"({raw['label']}): "
        f"{'bit for bit equal' if same else 'different'}, {len(out)} "
        f"scenes; {run['mps']:.2f} MP/s, decode_s "
        f"{run['stages'].get('decode_s', 0):.3f}, launches "
        f"{run['launches']} (raw: {before['mps']:.2f} MP/s, decode_s "
        f"{before['stages'].get('decode_s', 0):.3f}; {gpu_line()})")
    if not same:
        failures.append("batch_video_to_hdr from the lossless codecs "
                        "against raw")
    del out
    torch.cuda.empty_cache()
    v2h, walls = {}, {}
    for codec in ("PNG", "HFYU RGB24", "FFV1", "ULRG", "ULY0", "LAGS RGB24",
                  "LAGS YV12"):
        if codec in ("FFV1", "ULRG", "LAGS RGB24"):
            sub = {"FFV1": "c", "ULRG": "d", "LAGS RGB24": "e"}[codec]
            raise_failures(f"phase 14 ({sub})", failures)
            walls[sub] = time.perf_counter() - t_phase
            log(f"phase 14 ({sub}): {walls[sub]:.1f} s")
            t_phase = time.perf_counter()
            info = avi.probe_avi(written[codec][0])
        if codec == "FFV1":
            log(f"phase 14 (d): config 5 from FFV1 AVIs of phase 14's raw "
                f"frames, as cv2.VideoWriter writes BGR; "
                f"{info.ffv1.num_h_slices} x {info.ffv1.num_v_slices} "
                f"slices, a GOP of {FRAMES5}: "
                f"{avi.ffv1_unsupported(info) or 'read'} "
                f"({avi.ffv1_plain.layout_name(info.ffv1)}); {gpu_line()}")
        elif codec == "ULRG":
            uly0 = avi.probe_avi(written["ULY0"][0])
            log(f"phase 14 (e): config 5 from UtVideo AVIs: ULRG of phase "
                f"14's raw frames ({videos.UTVIDEO['ULRG']} predictor, "
                f"{avi.utvideo_plain.layout_name(avi.utvideo_params(info))}"
                f"), ULY0 of its I420 planes as cv2.VideoWriter writes them "
                f"({videos.UTVIDEO['ULY0']} predictor, "
                f"{avi.utvideo_plain.layout_name(avi.utvideo_params(uly0))}"
                f"): {avi.utvideo_unsupported(info) or 'read'}, "
                f"{avi.utvideo_unsupported(uly0) or 'read'}; {gpu_line()}")
        elif codec == "LAGS RGB24":
            yv12 = written["LAGS YV12"][0]
            log(f"phase 14 (f): config 5 from Lagarith AVIs: RGB24 frames "
                f"of phase 14's raw frames, YV12 frames of its I420 planes "
                f"(tests/_torch_lagarith_enc.cpp): "
                + ", ".join(avi.lagarith_unsupported(p, avi.probe_avi(p))
                            or "read" for p in (written[codec][0], yv12))
                + f"; {gpu_line()}")
        want, what = (i420, "phase 14's I420") if codec in (
            "ULY0", "LAGS YV12") else (raw, "raw")
        v2h[codec], _, got = run_video_to_hdr(f"video_to_hdr ({codec})",
                                              written[codec],
                                              DECODED_AS[codec])
        same = all(torch.equal(a, b) for a, b in zip(got,
                                                     want["video_to_hdr"]))
        log(f"  {'ok ' if same else 'BAD'} video_to_hdr from {codec} vs "
            f"{what}: {'bit for bit equal' if same else 'different'}; "
            f"{v2h[codec]:.3f} s, one K3 launch")
        if not same:
            failures.append(f"video_to_hdr from {codec} against {what}")
        if codec == "FFV1":    # 14 (i) holds its Matroska remux to it
            avi_v2h = {"FFV1": got}
        del got
    raise_failures("phase 14 (f)", failures)
    walls["f"] = time.perf_counter() - t_phase
    log(f"phase 14 (f): {walls['f']:.1f} s")
    t_phase = time.perf_counter()
    info = avi.probe_avi(mpeg4_videos.fmp4[0])
    log(f"phase 14 (g): config 5 from MPEG-4 Part 2 ({info.codec}) AVIs of "
        f"phase 14's I420 planes (tests/_torch_mpeg4_enc.cpp: an I-VOP and "
        f"{FRAMES5 - 1} P-VOPs a video, quantiser {MPEG4_QUANT}): "
        f"{avi.mpeg4_unsupported(mpeg4_videos.fmp4[0], info) or 'read'}; "
        f"held to I420 AVIs of the writer's reconstruction; {gpu_line()}")
    v2h["FMP4"], _, got = run_video_to_hdr("video_to_hdr (FMP4)",
                                           mpeg4_videos.fmp4, "mpeg4")
    v2h["I420 of the FMP4 reconstruction"], _, want = run_video_to_hdr(
        "video_to_hdr (I420 of the FMP4 reconstruction)",
        mpeg4_videos.recon, "rawvideo")
    same = all(torch.equal(a, b) for a, b in zip(got, want))
    mps = FRAMES5 * len(mpeg4_videos.fmp4) * H5 * W5 / 1e6 / v2h["FMP4"]
    mpeg4 = dict(wall_s=v2h["FMP4"], mps=mps, k3_launches=1,
                 frame_mb=sum(c.size for p in mpeg4_videos.fmp4
                              for c in avi.frame_chunks(p, avi.probe_avi(p)))
                 / 1e6 / (FRAMES5 * len(mpeg4_videos.fmp4)))
    log(f"  {'ok ' if same else 'BAD'} video_to_hdr from FMP4 vs I420 of the "
        f"writer's reconstruction: {'bit for bit equal' if same else 'different'}"
        f"; {v2h['FMP4']:.3f} s, {mps:.2f} MP/s ({FRAMES5} x "
        f"{len(mpeg4_videos.fmp4)} frames of {H5} x {W5}, "
        f"{mpeg4['frame_mb']:.3f} MB a frame), one K3 launch")
    if not same:
        failures.append("video_to_hdr from FMP4 against the reconstruction")
    avi_v2h["FMP4"] = got
    del got, want
    raise_failures("phase 14 (g)", failures)
    walls["g"] = time.perf_counter() - t_phase
    log(f"phase 14 (g): {walls['g']:.1f} s")
    t_phase = time.perf_counter()
    info = avi.probe_avi(mpeg4_videos.asp[0])
    log(f"phase 14 (h): config 5 from MPEG-4 Part 2 Advanced Simple "
        f"({info.codec}) AVIs of phase 14's I420 planes "
        f"(tests/_torch_mpeg4_enc.cpp as Xvid's packed mode writes: XviD "
        f"and DivX 'p' user data, the Xvid IDCT, two packed B-VOPs between "
        f"references, quant_type 1; {FRAMES5} displayed frames a video, "
        f"quantiser {MPEG4_QUANT}): "
        f"{avi.mpeg4_unsupported(mpeg4_videos.asp[0], info) or 'read'}; "
        f"held to I420 AVIs of the writer's reconstruction; {gpu_line()}")
    v2h["XVID ASP"], _, got = run_video_to_hdr("video_to_hdr (XVID ASP)",
                                               mpeg4_videos.asp, "mpeg4")
    v2h["I420 of the XVID ASP reconstruction"], _, want = run_video_to_hdr(
        "video_to_hdr (I420 of the XVID ASP reconstruction)",
        mpeg4_videos.asp_recon, "rawvideo")
    same = all(torch.equal(a, b) for a, b in zip(got, want))
    mps = FRAMES5 * len(mpeg4_videos.asp) * H5 * W5 / 1e6 / v2h["XVID ASP"]
    mpeg4_asp = dict(wall_s=v2h["XVID ASP"], mps=mps, k3_launches=1,
                     frame_mb=sum(c.size for p in mpeg4_videos.asp
                                  for c in avi.frame_chunks(
                                      p, avi.probe_avi(p)))
                     / 1e6 / (FRAMES5 * len(mpeg4_videos.asp)))
    log(f"  {'ok ' if same else 'BAD'} video_to_hdr from XVID ASP vs I420 "
        f"of the writer's reconstruction: "
        f"{'bit for bit equal' if same else 'different'}; "
        f"{v2h['XVID ASP']:.3f} s, {mps:.2f} MP/s ({FRAMES5} x "
        f"{len(mpeg4_videos.asp)} frames of {H5} x {W5}, "
        f"{mpeg4_asp['frame_mb']:.3f} MB a frame), one K3 launch")
    if not same:
        failures.append("video_to_hdr from XVID ASP against the "
                        "reconstruction")
    avi_v2h["XVID"] = got
    del got, want
    raise_failures("phase 14 (h)", failures)
    walls["h"] = time.perf_counter() - t_phase
    log(f"phase 14 (h): {walls['h']:.1f} s")
    avi_v2h["MJPG"] = mjpg_v2h
    t_phase = time.perf_counter()
    containers_out = container_phase(container_videos, mpeg4_videos,
                                     avi_v2h, v2h, run_video_to_hdr)
    del avi_v2h
    walls["i"] = time.perf_counter() - t_phase
    log(f"phase 14 (i): {walls['i']:.1f} s")
    h264_out = None
    if h264_videos is not None:
        t_phase = time.perf_counter()
        h264_out = h264_phase(h264_videos, v2h, run_video_to_hdr)
        walls["j"] = time.perf_counter() - t_phase
        log(f"phase 14 (j): {walls['j']:.1f} s")
    h264_high_out = None
    if h264_high is not None:
        t_phase = time.perf_counter()
        h264_high_out = h264_high_phase(h264_high, v2h, run_video_to_hdr)
        walls["k"] = time.perf_counter() - t_phase
        log(f"phase 14 (k): {walls['k']:.1f} s")
    return dict(walls_s=walls, encode_s=encode_s, read_mbps=read_mb / read_s,
                mpeg4=mpeg4, mpeg4_asp=mpeg4_asp, containers=containers_out,
                mpeg4_encode_s=mpeg4_videos.encode_s, h264=h264_out,
                h264_high=h264_high_out,
                h264_encode_s=None if h264_videos is None else
                h264_videos.encode_s,
                raw_mps=before["mps"],
                raw_decode_s=before["stages"].get("decode_s", 0),
                frame_mb={k: v / n / 1e6 for k, v in sizes.items()},
                run=dict(wall=run["wall"], mps=run["mps"],
                         decode_s=run["stages"].get("decode_s", 0),
                         launches=run["launches"]),
                video_to_hdr_s=v2h)


def video_phases(dev, res, directory, h264_plain4k, h264_high, content,
                 prework) -> dict:
    """Phases 12-14: config 5, the video -> HDR pipeline, with the raw
    videos written into ``directory`` and the MJPG ones cached under
    ``build/``; ``h264_plain4k`` (:class:`H264Plain4K`) the plain decode of
    4K H.264 pictures and ``h264_high`` (:class:`H264HighWork`) the High
    videos, both begun with the smoke; ``content`` config 5's frames
    (:func:`config5_content`) and ``prework`` (:class:`Config5Prework`)
    their videos' coding, begun with the smoke too.  Returns each kernel's
    launches on these paths, its config-5 times and both sets of 4K
    videos' paths."""
    from concurrent.futures import ThreadPoolExecutor
    from camera_linearity_tpu_torch import native
    from camera_linearity_tpu_torch.models import calibration as cal
    from camera_linearity_tpu_torch.models import pipeline, video
    from camera_linearity_tpu_torch.models.scipy_strict import \
        reference_energy
    from camera_linearity_tpu_torch.native import jpeg_plain
    from camera_linearity_tpu_torch.ops import hdr as hdr_ops
    from camera_linearity_tpu_torch.ops import hdr_cuda
    from camera_linearity_tpu_torch.ops import welford as wf
    from camera_linearity_tpu_torch.utils import avi
    from camera_linearity_tpu_torch.utils import observability as obs
    from tests import _torch_mjpeg_writer as writer

    # --- phase 12: native builds, the MJPEG checks, the videos ------------
    log("phase 12: native host library, MJPEG decoder, config-5 videos "
        f"(host: {os.cpu_count()} CPUs)")
    t0 = time.perf_counter()
    if not native.available():
        raise AssertionError("the native stager did not build: "
                             f"{native.build_error()}")
    log(f"  stager built and loaded in {time.perf_counter() - t0:.2f} s: "
        f"{native._lib_path()}")
    t0 = time.perf_counter()
    if not native.mjpeg_available():
        raise AssertionError("the MJPEG decoder did not build: "
                             f"{native.build_error('_mjpeg')}")
    log(f"  MJPEG decoder (jpeg.cpp, no libjpeg) built and loaded in "
        f"{time.perf_counter() - t0:.2f} s: "
        f"{native._lib_path('_mjpeg', native._MJPEG_SRC)}")
    data = ROOT / "tests" / "data"
    payloads = list(avi.mjpg_chunks(data / "mjpg 5ms.avi"))
    want = np.load(data / "mjpg 5ms.libjpeg.npy")
    cv = np.load(data / "mjpg 5ms.cv2.npy")
    for mode in native.JPEG_MODES:
        got = np.empty((len(payloads), 32, 48, 3), np.uint8)
        native.jpeg_decode_bgr_batch(payloads, got, mode=mode)
        same = np.array_equal(got, want)
        if mode == "turbo" and not same:
            raise AssertionError("the turbo decode of mjpg 5ms.avi differs "
                                 "from the committed libjpeg frames")
        if mode == "ffmpeg" and not np.array_equal(got, cv):
            raise AssertionError("the ffmpeg decode of mjpg 5ms.avi differs "
                                 "from the committed cv2 frames")
        log(f"  {'ok ' if same or mode != 'turbo' else 'BAD'} {mode} decode "
            f"of 'mjpg 5ms.avi' ({len(got)} frames): "
            f"{'equals' if same else 'differs from'} the committed libjpeg "
            f"(islow, fancy) frames, max |.| {max_gap(got, want):.0f} DN; "
            f"max |. - cv2| {max_gap(got, cv):.0f} DN")
    # the ffmpeg mode against every committed cv2.VideoCapture decode of
    # an MJPG clip (phase 12's Lagarith rows take the Lagarith clips)
    for clip in sorted(data.glob("mjpg*.cv2.npy")):
        name = clip.name[:-len(".cv2.npy")]
        cv = np.load(clip)
        got = np.empty_like(cv)
        chunks = list(avi.mjpg_chunks(data / f"{name}.avi"))
        n = native.jpeg_decode_bgr_batch(chunks, got, mode="ffmpeg")
        same = n == len(cv) and np.array_equal(got, cv)
        log(f"  {'ok ' if same else 'BAD'} ffmpeg decode of '{name}.avi' "
            f"({len(cv)} x {cv.shape[1]} x {cv.shape[2]}): "
            f"{'equals' if same else 'differs from'} the committed "
            f"cv2.VideoCapture frames, max |.| {max_gap(got, cv):.0f} DN")
        if not same:
            raise AssertionError(f"the ffmpeg decode of {name}.avi differs "
                                 "from its committed cv2 frames")
    rng = np.random.default_rng(SEED)
    failures, cases = [], 0
    t_jpeg = time.perf_counter()
    lib = native._load_mjpeg()
    todo = []
    for h, w in ((37, 53), (38, 53), (64, 3840)):
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        # (sampling, progressive, frame): every sampling of the writer,
        # grayscale, and progressive 4:2:0, 4:4:4 and grayscale
        kinds = [(s, False, img) for s in writer.SAMPLING] + [
            (s, True, img) for s in ("420", "444")] + [
            ("gray", p, np.ascontiguousarray(img[..., 0]))
            for p in (False, True)]
        for sampling, progressive, src in kinds:
            for restart in (0, 7):
                frame = writer.encode_jpeg(
                    src, 75, "420" if sampling == "gray" else sampling,
                    restart, progressive=progressive)
                for m, mode in enumerate(native.JPEG_MODES):
                    todo.append((h, w, sampling, progressive, restart, frame,
                                 m, mode))
    # the plain decodes (pure Python) a process a task, beside the videos'
    # encodes below (none of it timed); phase 12's plain strips, and
    # phases 15 (b) to 16 (b), take the same processes later
    pool = plain_pool()
    plains = [pool.submit(jpeg_plain.decode_bgr, frame, h, w, mode)
              for h, w, _, _, _, frame, _, mode in todo]
    pre = prework.result()
    log(f"  config 5's videos coded from the smoke's start in a process of "
        f"its own (Config5Prework): {pre['videos_s']:.1f} s writing them, "
        f"the MJPG modes {pre['mjpg_s']:.1f} s, every codec "
        f"{pre['codecs_s']:.1f} s (lossless {pre['lossless_s'] or 0:.1f}, "
        f"MPEG-4 {pre['mpeg4_s'] or 0:.1f}, H.264 {pre['h264_s'] or 0:.1f});"
        f" {pre['waited_s']:.1f} s waited for it here; below, each finds "
        "its cache")
    t0 = time.perf_counter()
    paths, crop_paths, crops, pools, (i420_paths, i420_crop_paths) = \
        make_videos(directory, content)
    del content
    log(f"  wrote {len(paths)} videos of {FRAMES5} x {H5} x {W5} x 3 "
        f"(RGBA, {paths[0].stat().st_size / 1e6:.1f} MB each; I420, "
        f"{i420_paths[0].stat().st_size / 1e6:.1f} MB each) and their "
        f"{CROP_ROWS}-row crops in {time.perf_counter() - t0:.1f} s")
    info = avi.probe_avi(paths[0])
    if info[:4] != ("RGBA", H5, W5, 3):
        raise AssertionError(f"probe_avi: {info}")
    info = avi.probe_avi(i420_paths[0])
    if (info.codec, info.height, info.width, info.layout) != (
            "I420", H5, W5, "i420"):
        raise AssertionError(f"probe_avi (I420): {info}")
    # every MJPG video's frames go to the pool at once (a thread each
    # submits its own and writes its AVIs)
    mjpg_jobs = ThreadPoolExecutor(len(MJPG_VARIANTS), "mjpg")
    mjpg_futures = {variant: mjpg_jobs.submit(
        make_mjpg_videos, pools if variant in ("420", "gray") else
        pools[-1:], pool, variant) for variant in MJPG_VARIANTS}
    mjpg_jobs.shutdown(wait=False)
    mjpg_paths, mjpg_crop_paths, enc_s = mjpg_futures.pop("420").result()
    sizes = [len(p) for p in avi.mjpg_chunks(mjpg_paths[-1])][:MJPG_POOL]
    log(f"  MJPG: {len(mjpg_paths)} videos of {FRAMES5} frames cycling a "
        f"pool of {MJPG_POOL} distinct frames each (quality "
        f"{MJPG_QUALITY}, 4:2:0, no DRI; {MJPG_CROP_ROWS}-row crops "
        f"beside them), "
        + ("from the cache" if enc_s is None else f"encoded in {enc_s:.1f} s")
        + f": {mjpg_paths[0].parent}")
    info = avi.probe_avi(mjpg_paths[0])
    if info[:4] != ("MJPG", H5, W5, 3) or avi.jpeg_unsupported(info.jpeg):
        raise AssertionError(f"probe_avi: {info}")
    # the default decoder's other frame modes: grayscale MJPG (the frames'
    # green channel) for every exposure, for phase 14; 4:1:1, 4:4:0 and
    # progressive 4:2:0 for the brightest (timed below, beside the 4:2:0)
    variants = {variant: f.result() for variant, f in mjpg_futures.items()}
    enc = [v[2] for v in variants.values() if v[2] is not None]
    log(f"  MJPG in the other modes (quality {MJPG_QUALITY}, no DRI): "
        f"grayscale x {len(variants['gray'][0])} exposures, 4:1:1, 4:4:0 "
        f"and progressive 4:2:0 (spectral selection) x 1, "
        + (f"encoded in {max(enc):.1f} s, beside the 4:2:0 videos" if enc
           else "from the cache"))
    for (h, w, sampling, progressive, restart, frame, m, mode), plain \
            in zip(todo, plains):
        buf = np.frombuffer(frame, np.uint8)
        got = np.zeros((h, w, 3), np.uint8)
        rc = lib.clt_jpeg_decode_bgr(
            native._as_u8_ptr(buf), buf.size,
            native._as_u8_ptr(got), h, w, m)
        prc, want = plain.result()
        cases += 1
        # the turbo modes read only 4:4:4, 4:2:2 and 4:2:0 in one scan:
        # both refuse the rest
        refused = mode != "ffmpeg" and (
            progressive or sampling in ("gray", "411", "440"))
        if rc != prc or (rc != 0) != refused or \
                rc == 0 and not np.array_equal(got, want):
            failures.append(
                f"{h} x {w} {sampling}"
                f"{' progressive' if progressive else ''} DRI "
                f"{restart} {mode}: rc {rc}, plain {prc}")
    log(f"  {'ok ' if not failures else 'BAD'} jpeg.cpp == jpeg_plain.py bit "
        f"for bit on {cases} decodes (noise at 37 x 53, 38 x 53 and 64 x "
        f"3840; 4:4:4, 4:2:2, 4:2:0, 4:1:1, 4:4:0, grayscale, and "
        f"progressive 4:2:0, 4:4:4 and grayscale; no DRI and DRI 7; the "
        f"three modes, the turbo ones refusing the new modes; the plain "
        f"decodes in spawned processes beside the videos' encodes, "
        f"{time.perf_counter() - t_jpeg:.1f} s from their start)")
    raise_failures("phase 12, jpeg.cpp against jpeg_plain.py", failures)
    phase_mark("the MJPEG checks and the MJPG videos")
    # one 4K frame of the brightest exposure: one thread, then a batch of
    # the video's frames on every core
    frame = next(avi.mjpg_chunks(mjpg_paths[-1]))
    batch = list(avi.mjpg_chunks(mjpg_paths[-1]))
    decode_ms = {}
    for mode in native.JPEG_MODES:
        one = np.empty((1, H5, W5, 3), np.uint8)
        many = np.empty((len(batch), H5, W5, 3), np.uint8)
        native.jpeg_decode_bgr_batch([frame], one, mode=mode)  # warm
        single = host_ms(lambda: native.jpeg_decode_bgr_batch(
            [frame], one, mode=mode, threads=1), runs=1, warmup=0)
        wide = host_ms(lambda: native.jpeg_decode_bgr_batch(
            batch, many, mode=mode), runs=1, warmup=1) / len(batch)
        decode_ms[mode] = dict(one_thread=single, all_threads=wide)
        log(f"  {mode}: one 4K frame ({len(frame) / 1e6:.3f} MB) "
            f"{single:.1f} ms on one thread; {wide:.1f} ms a frame over a "
            f"batch of {len(batch)} on {os.cpu_count()} threads (host "
            "clock, one run after a warm one)")
        del one, many
    log(f"  frame bytes of the pool: {[s / 1e6 for s in sizes]} MB")
    for variant, (vpaths, _, _) in variants.items():
        info = avi.probe_avi(vpaths[-1])
        comps = 1 if variant == "gray" else 3
        if info[:4] != ("MJPG", H5, W5, comps) or \
                avi.jpeg_unsupported(info.jpeg, mode="ffmpeg") or \
                not avi.jpeg_unsupported(info.jpeg):
            raise AssertionError(f"probe_avi ({variant}): {info}")
        vbatch = list(avi.mjpg_chunks(vpaths[-1]))
        one = np.empty((1, H5, W5, 3), np.uint8)
        many = np.empty((len(vbatch), H5, W5, 3), np.uint8)
        native.jpeg_decode_bgr_batch(vbatch[:1], one, mode="ffmpeg")  # warm
        single = host_ms(lambda: native.jpeg_decode_bgr_batch(
            vbatch[:1], one, mode="ffmpeg", threads=1), runs=1, warmup=0)
        wide = host_ms(lambda: native.jpeg_decode_bgr_batch(
            vbatch, many, mode="ffmpeg"), runs=1, warmup=1) / len(vbatch)
        decode_ms[f"ffmpeg {variant}"] = dict(
            one_thread=single, all_threads=wide, frame_mb=len(vbatch[0]) / 1e6)
        log(f"  ffmpeg {variant}: one 4K frame ({len(vbatch[0]) / 1e6:.3f} "
            f"MB) {single:.1f} ms on one thread; {wide:.1f} ms a frame over "
            f"a batch of {len(vbatch)} on {os.cpu_count()} threads (host "
            f"clock, one run after a warm one; {info.jpeg.scans} scans a "
            f"frame)")
        del one, many
    # the rawvideo reader (in jpeg.cpp) on one 4K frame of each layout it
    # reads, held to rawvideo_plain.py bit for bit; one thread, then a
    # batch of FRAMES5 on every core, beside the MJPEG times above.  The
    # plain versions run first, on a thread a layout (NumPy releases the
    # GIL), and never beside a timed call
    from camera_linearity_tpu_torch.native import rawvideo_plain
    bgr_dev = torch.as_tensor(pools[-1][0], device=dev)
    failures, t0 = [], time.perf_counter()
    layouts = raw_layout_chunks(pools[-1][0], bgr_dev)
    with ThreadPoolExecutor(max_workers=os.cpu_count() or 1) as ex:
        plain = dict(zip(layouts, ex.map(
            lambda item: rawvideo_plain.decode_bgr(item[1][0], item[0], H5,
                                                   W5, *item[1][1:]),
            layouts.items())))
    plain_s = time.perf_counter() - t0
    for layout, (chunk, bottom_up, palette) in layouts.items():
        want = plain.pop(layout)
        one = np.empty((1, H5, W5, 3), np.uint8)
        many = np.empty((FRAMES5, H5, W5, 3), np.uint8)
        decode = lambda chunks, dst, **kw: native.raw_decode_bgr_batch(  # noqa
            chunks, dst, layout, bottom_up=bottom_up, palette=palette, **kw)
        decode([chunk], one)
        same = np.array_equal(one[0], want)
        if not same:
            failures.append(layout)
        single = host_ms(lambda: decode([chunk], one, threads=1), runs=1,
                         warmup=0)
        wide = host_ms(lambda: decode([chunk] * FRAMES5, many), runs=1,
                       warmup=1) / FRAMES5
        decode_ms[f"rawvideo {layout}"] = dict(
            one_thread=single, all_threads=wide, frame_mb=len(chunk) / 1e6)
        log(f"  {'ok ' if same else 'BAD'} rawvideo {layout}"
            f"{' bottom-up' if bottom_up else ''}: one 4K frame "
            f"({len(chunk) / 1e6:.3f} MB) {single:.1f} ms on one thread; "
            f"{wide:.1f} ms a frame over a batch of {FRAMES5} on "
            f"{os.cpu_count()} threads (host clock, one run after a warm "
            f"one); {'equals' if same else 'differs from'} "
            f"rawvideo_plain.py, "
            f"max |.| {max_gap(one[0], want):.0f} DN")
        del one, many, want
    log(f"  rawvideo: {len(layouts)} layouts checked in "
        f"{time.perf_counter() - t0:.1f} s (the plain versions "
        f"{plain_s:.1f} s of it, on {os.cpu_count()} threads)")
    del layouts
    raise_failures("phase 12, the rawvideo reader against "
                   "rawvideo_plain.py", failures)
    phase_mark("the MJPEG and rawvideo rows")
    lossless_videos = LosslessVideos(paths, i420_paths)
    mpeg4_videos = Mpeg4Videos(i420_paths)
    h264_videos = H264Videos(i420_paths)
    container_videos = ContainerVideos(directory)
    # the MPEG-4 strip's pictures: the first rows of phase 14's I420 planes
    strip_pictures = []
    for c in [bytes(c) for c in avi.raw_chunks(
            i420_paths[-1], avi.probe_avi(i420_paths[-1]))][
            :MPEG4_STRIP_FRAMES]:
        c = np.frombuffer(c, np.uint8)
        y = c[:H5 * W5].reshape(H5, W5)
        u, v = c[H5 * W5:H5 * W5 * 3 // 2].reshape(2, H5 // 2, W5 // 2)
        strip_pictures.append(tuple(np.ascontiguousarray(p[:rows]) for p, rows
                                    in ((y, STRIP_ROWS), (u, STRIP_ROWS // 2),
                                        (v, STRIP_ROWS // 2))))
    decode_ms.update(lossless_layout_rows(
        pools[-1][:2], [bgr_dev, torch.as_tensor(pools[-1][1], device=dev)],
        lossless_videos, mpeg4_videos, strip_pictures, pool,
        container_videos, mjpg_paths, h264_videos, h264_plain4k, h264_high))
    del bgr_dev
    icrf = (np.linspace(0, 1, 256)[:, None].repeat(3, 1)
            ** np.array([2.0, 2.2, 2.4]))

    # --- phase 13: the Welford statistics on the card ---------------------
    log(f"phase 13: welford_algorithm on the card, batch_size 8 "
        f"({FRAMES5} frames: a batch of 8 and one of {FRAMES5 - 8})")
    failures = []
    host = video.welford_algorithm(paths[0], use_std=True, backend="host")
    obs.reset_stage_times()
    t0 = time.perf_counter()
    on_card = video.welford_algorithm(paths[0], use_std=True,
                                      backend="device", batch_size=8)
    t_dev = time.perf_counter() - t0
    decoded = obs.decoded_frames.snapshot()
    log(f"  device backend: {t_dev:.3f} s host clock, decoders {decoded}")
    if decoded != {"raw": FRAMES5}:
        failures.append(f"decoders {decoded}")
    lut_card = video.welford_algorithm(paths[0], ICRF=icrf, use_std=True,
                                       batch_size=8)
    cpu = video.welford_algorithm(crop_paths[0], use_std=True,
                                  backend="device", batch_size=8,
                                  device="cpu")
    lut_cpu = video.welford_algorithm(crop_paths[0], ICRF=icrf,
                                      use_std=True, batch_size=8,
                                      device="cpu")
    for label, got, want in (
            ("device vs host backend", on_card, host),
            ("device vs CPU f64 (crop)", {k: v[:CROP_ROWS] for k, v in
                                          on_card.items()}, cpu),
            ("device with ICRF vs CPU f64 (crop)",
             {k: v[:CROP_ROWS] for k, v in lut_card.items()}, lut_cpu)):
        check_gap(f"{label}, mean", got["mean"], want["mean"], 2e-6,
                  failures)
        check_gap(f"{label}, std", got["std"], want["std"], 2e-5, failures)
    om, ostd = moments_oracle(crops[0])
    check_gap("host backend vs NumPy oracle (crop), mean",
              host["mean"][:CROP_ROWS], om, 0.0, failures)
    prof_card, mean_card = video.compute_noise_profiles([paths[0]],
                                                        batch_size=4)
    prof_cpu, mean_cpu = video.compute_noise_profiles([paths[0]],
                                                      batch_size=4,
                                                      device="cpu")
    same = np.array_equal(prof_card, prof_cpu) and \
        np.array_equal(mean_card, mean_cpu)
    log(f"  {'ok ' if same else 'BAD'} compute_noise_profiles card == CPU: "
        f"{int(prof_card.sum())} counts")
    if not same:
        failures.append("compute_noise_profiles")
    raise_failures("phase 13", failures)

    batch = next(video._staged_batches([paths[0]], 8, dev, ["raw"],
                                       (H5, W5, 3))).clone()
    state0 = wf.welford_init((H5, W5, 3), torch.float32, dev)
    icrf_t = torch.as_tensor(icrf, dtype=torch.float32, device=dev)
    frame_bytes = H5 * W5 * 3
    wf_bytes = frame_bytes + 4 * 4 * frame_bytes / 8   # u8 in; mean, m2 rw
    wf_bound = wf_bytes / PEAK_BYTES_S * 1e3
    welford = {}
    for name, fn in (
            ("welford_update_batch", lambda: wf.welford_update_batch(
                state0, batch.to(torch.float32) / 255)),
            ("welford_update_batch_lut", lambda: wf.welford_update_batch_lut(
                state0, batch, icrf_t, 255))):
        ms = float(np.median(time_samples(fn, runs=5, reps=2, warmup=1))) / 8
        welford[name] = ms
        log(f"  {name}: {ms:.4f} ms per frame (CUDA events, B = 8), bound "
            f"{wf_bound:.4f} ms ({wf_bytes / 1e6:.1f} MB per frame at 3.35 "
            f"TB/s; {wf_bound / ms * 100:.1f} % of it)")
    del batch, state0

    # --- phase 14: batch_video_to_hdr and video_to_hdr --------------------
    mean_icrf, pca = gamma_basis()
    spec = dict(pca_arrays=np.stack([pca] * 3),
                mean_icrf_arrays=np.stack([mean_icrf] * 3),
                spacing=max(1, H5 * W5 // 2000), popsize=15, maxiter=1000,
                tol=0.01, rng_seed=7)
    n_frames = FRAMES5 * len(paths) * SCENES5
    log(f"phase 14: batch_video_to_hdr, {SCENES5} scenes x "
        f"{len(paths)} exposures x {H5} x {W5} x 3, calibration leg on "
        f"(spacing {spec['spacing']}, popsize 15, maxiter 1000, tol 0.01): "
        "raw RGBA u16/f16 and f32/f32, then MJPG turbo_fast u16/f16, "
        "turbo f32/f32 and the default decoder (ffmpeg, CL_DECODER unset) "
        "u16/f16, then I420 (rawvideo) u16/f16")
    # record what the pipeline hands the merge (ops/hdr.py's entry points,
    # looked up at call time) and the solver, to hold them to the plain
    # versions and the oracle afterwards
    rec = {}
    originals = {name: getattr(hdr_ops, name) for name in (
        "merge_batch", "merge_corrected")}
    solve = cal.calibration

    def recorder(name):
        def call(*args, **kwargs):
            rec[name] = (args, kwargs)
            return originals[name](*args, **kwargs)
        return call

    def recording_solve(*args, **kwargs):
        out = solve(*args, **kwargs, return_params=True)
        rec["solve"] = (kwargs["channel_stacks"], out)
        return out[:4]

    def run_batch(label, scene_paths, oracle_frames, wire_val, wire_std,
                  decoder, decoded_as):
        """One batch_video_to_hdr call with the counts reset, held to the
        plain merge, the NumPy oracle at the crop and the reference
        energy; returns what phase 14 keeps of it.  ``scene_paths``: every
        scene's exposure videos, or a list of SCENES5 such lists (one a
        scene); ``decoded_as``: the decoder every frame goes through, or
        the frames each decoder is to decode."""
        failures = []
        if not isinstance(scene_paths[0], (list, tuple)):
            scene_paths = [scene_paths] * SCENES5
        if isinstance(decoded_as, str):
            decoded_as = {decoded_as: n_frames}
        # the one-time costs (builds, prefaults, the leg's first run) are
        # paid once a wire: a second prewarm of the same wire found them
        # paid (prefault 0.000 s) and ran the leg again, 4-6 s a call
        if (wire_val, wire_std) not in prewarmed:
            t0 = time.perf_counter()
            warm = pipeline.prewarm_batch_video_to_hdr(
                SCENES5, len(scene_paths[0]), H5, W5, icrf, calibrate=spec,
                wire_val=wire_val, wire_std=wire_std)
            prewarmed.add((wire_val, wire_std))
            log(f"  prewarm {wire_val}/{wire_std}: "
                f"{time.perf_counter() - t0:.1f} s; h2d {warm['h2d_mbps']} "
                "MB/s (one pinned std plane, host clock)")
        for k in hdr_cuda.KERNELS:
            k.launches = 0
        obs.reset_stage_times()
        rec.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = pipeline.batch_video_to_hdr(
            {f"scene{i}": scene_paths[i] for i in range(SCENES5)}, icrf,
            wire_val=wire_val, wire_std=wire_std, calibrate=spec,
            decoder=decoder)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {k.__name__: k.launches for k in hdr_cuda.KERNELS}
        launches[label] = counts
        decoded = obs.decoded_frames.snapshot()
        stages = obs.snapshot_stage_times()
        mps = n_frames * H5 * W5 / 1e6 / wall
        log(f"  {label}: wall {wall:.3f} s, {mps:.2f} MP/s ({n_frames} "
            f"frames x {H5} x {W5}); launches {counts}; decoders "
            f"{decoded}")
        log(f"  stages: {stages}")
        if counts != {"merge_nhwc_fused": 1, "merge_nhwc_lerp": 0,
                      "merge_nhwc_lerp_bp": 0}:
            failures.append(f"launches {counts}")
        if decoded != decoded_as:
            failures.append(f"decoders {decoded}")
        (bv, bs, ex, ic, icd), _ = rec["merge_batch"]
        for s in (0, SCENES5 - 1):
            got = out[f"scene{s}"].measurand
            res.check("merge_nhwc_fused", f"{label}: scene {s} vs "
                      "merge_fused_plain", (got.val, got.std),
                      hdr_cuda.merge_fused_plain(bv[s], bs[s], ex, ic,
                                                 icd))
        for e, crop in enumerate(oracle_frames):
            om, ostd = moments_oracle(crop)
            gv = bv[0, e, :CROP_ROWS].cpu().numpy()
            gs = bs[0, e, :CROP_ROWS].cpu().numpy()
            if wire_val == "f32":
                check_gap(f"exposure {e} stack vs oracle, val", gv,
                          om.astype(np.float32), 0.0, failures)
                check_gap(f"exposure {e} stack vs oracle, std", gs,
                          ostd.astype(np.float32), 0.0, failures)
            else:  # the wire's bounds, plus the f32 roundings of the
                # dequantization (grid constant and product)
                check_gap(f"exposure {e} stack vs oracle, val", gv, om,
                          2.0 ** -17 + 2.0 ** -23, failures)
                check_gap(f"exposure {e} stack vs oracle, std", gs, ostd,
                          2.0 ** -25, failures, rtol=2.0 ** -11)
        stacks, solved = rec["solve"]
        dn = stacks[0].cpu().numpy()
        t_exp = stacks[2].cpu().numpy().astype(float)
        for c in range(3):
            oracle = reference_energy(solved[4][c], spec[
                "mean_icrf_arrays"][c], spec["pca_arrays"][c],
                dn[c][:, None, :], None, 5, 250, True, t_exp, 256)
            gap = abs(solved[2][c] - oracle) / oracle
            log(f"  calibration leg, channel {c}: final energy "
                f"{solved[2][c]:.8f}, oracle {oracle:.8f} (rel gap "
                f"{gap:.2e}), {dn.shape[1]} pixels")
            if not gap <= ORACLE_RTOL:
                failures.append(f"channel {c} energy against the oracle")
        for name, got in out.items():
            v = got.measurand.val
            if tuple(v.shape) != (H5, W5, 3) or \
                    not torch.isfinite(v).all() or \
                    not torch.isfinite(got.measurand.std).all():
                failures.append(f"{name} shape or non-finite values")
        raise_failures(f"phase 14, {label}", failures)
        kept = dict(wall=wall, mps=mps, stages=stages, launches=counts,
                    merge=(bv, bs, ex, ic, icd),
                    out={k: (v.measurand.val, v.measurand.std)
                         for k, v in out.items()})
        del out
        rec.clear()
        return kept

    def run_video_to_hdr(label, video_paths, decoded_as):
        """video_to_hdr on one scene with the counts reset: one K3 launch,
        held to its plain version."""
        for k in hdr_cuda.KERNELS:
            k.launches = 0
        obs.reset_stage_times()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hdr_set = pipeline.video_to_hdr(video_paths, icrf)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = {k.__name__: k.launches for k in hdr_cuda.KERNELS}
        decoded = obs.decoded_frames.snapshot()
        launches[label] = counts
        log(f"  {label}: {seconds:.3f} s host clock; launches {counts}; "
            f"decoders {decoded}; stages {obs.snapshot_stage_times()}")
        if counts != {"merge_nhwc_fused": 0, "merge_nhwc_lerp": 0,
                      "merge_nhwc_lerp_bp": 1}:
            raise AssertionError(f"{label} launches {counts}")
        if decoded != {decoded_as: FRAMES5 * len(video_paths)}:
            raise AssertionError(f"{label} decoders {decoded}")
        # no darks and no flat: K3 reads zero dark planes, and a 256-entry
        # table is its own base curve
        val, std, dark, ex, ic, icd, thr = rec["merge_corrected"][0][:7]
        if rec["merge_corrected"][0][7:] != (None, None) or dark.any():
            raise AssertionError(f"{label} passed a flat or a dark")
        res.check("merge_nhwc_lerp_bp", f"{label} vs merge_lerp_bp_plain",
                  (hdr_set.measurand.val, hdr_set.measurand.std),
                  hdr_cuda.merge_lerp_bp_plain(val, std, dark, ex, ic, icd,
                                               thr, 256))
        out = (hdr_set.measurand.val, hdr_set.measurand.std)
        del hdr_set
        return seconds, (val, std, dark, ex, ic, icd, thr), out

    for name in originals:
        setattr(hdr_ops, name, recorder(name))
    cal.calibration = recording_solve
    launches, k1_times, runs, prewarmed = {}, {}, {}, set()
    try:
        for wire_val, wire_std in (("u16", "f16"), ("f32", "f32")):
            label = f"batch_video_to_hdr {wire_val}/{wire_std}"
            run = run_batch(label, paths, crops, wire_val, wire_std,
                            "auto", "raw")
            runs[label] = run
            if wire_val == "u16":
                k1_times = time_k1_batch(dev, *run.pop("merge"))
                # phase 14 (c) holds the lossless codecs to this run
                raw_u16 = dict(label=label, out=run.pop("out"))
            run.pop("merge", None)
            run.pop("out", None)
            torch.cuda.empty_cache()

        # video_to_hdr for one scene: one K3 launch
        t_v2h_s, (val, std, dark, ex, ic, icd, thr), \
            raw_u16["video_to_hdr"] = run_video_to_hdr("video_to_hdr", paths,
                                                       "raw")

        def k3():
            hdr_cuda.merge_nhwc_lerp_bp(val, std, dark, ex, ic, icd, thr,
                                        256)
        k3_bytes = (3 * len(paths) + 2) * frame_bytes * 4
        src = torch.empty(k3_bytes // 8, dtype=torch.float32, device=dev)
        dst = torch.empty_like(src)

        def copy():
            dst.copy_(src)
        def k3_plain():
            hdr_cuda.merge_lerp_bp_plain(val, std, dark, ex, ic, icd, thr,
                                         256)
        k3_s, c3_s, p3_s = [], [], []
        for fn, out, reps in ((k3_plain, p3_s, 1), (copy, c3_s, 5),
                              (k3, k3_s, 5), (k3, k3_s, 5), (copy, c3_s, 5),
                              (k3_plain, p3_s, 1)):
            out += time_samples(fn, runs=5, reps=reps)
        del src, dst
        k3_ms, k3_copy = float(np.median(k3_s)), float(np.median(c3_s))
        k3_plain_ms = float(np.median(p3_s))
        k3_bound = k3_bytes / PEAK_BYTES_S * 1e3
        log(f"  K3 in video_to_hdr: {k3_ms:.4f} ms (CUDA events), "
            f"{k3_bytes / 1e6:.1f} MB (3 zero dark planes included), bound "
            f"{k3_bound:.4f} ms ({k3_bound / k3_ms * 100:.1f} % of it), "
            f"copy {k3_copy:.4f} ms, plain {k3_plain_ms:.4f} ms; "
            f"{k3_ms / (t_v2h_s * 1e3) * 100:.3f} % of video_to_hdr's "
            f"{t_v2h_s * 1e3:.1f} ms")
        del val, std, dark
        torch.cuda.empty_cache()

        # the same scenes from MJPG AVIs, through the port's decoder; the
        # oracle reads the crops through jpeg_plain.py
        t0 = time.perf_counter()
        plain_crops = {mode: [plain_crop_frames(p, mode)
                              for p in mjpg_crop_paths]
                       for mode in native.JPEG_MODES}
        log(f"  jpeg_plain.py decoded the MJPG crops for the oracle in "
            f"{time.perf_counter() - t0:.1f} s")
        # "auto" with CL_DECODER unset: the default, cv2's bytes
        cl_decoder = os.environ.pop("CL_DECODER", None)
        try:
            for wire_val, wire_std, decoder, decoded_as in (
                    ("u16", "f16", "turbo_fast", "turbo_fast"),
                    ("f32", "f32", "turbo", "turbo"),
                    ("u16", "f16", "auto", "ffmpeg")):
                label = (f"batch_video_to_hdr {wire_val}/{wire_std} "
                         f"(MJPG, {decoder})")
                run = run_batch(label, mjpg_paths, plain_crops[decoded_as],
                                wire_val, wire_std, decoder, decoded_as)
                run.pop("merge")
                out = run.pop("out")
                if decoder == "auto":  # phase 14 (b) holds stream 1 to it
                    stream0 = dict(label=label, out=out)
                del out
                runs[label] = run
                torch.cuda.empty_cache()
            t_v2h_mjpg, _, stream0["video_to_hdr"] = run_video_to_hdr(
                "video_to_hdr (MJPG)", mjpg_paths, "ffmpeg")
            # grayscale MJPG at the default decoder: three equal channels,
            # as cv2 gives them; the oracle reads the crops through
            # jpeg_plain.py's ffmpeg mode
            gray_paths, gray_crop_paths, _ = variants["gray"]
            t0 = time.perf_counter()
            gray_crops = [plain_crop_frames(p, "ffmpeg")
                          for p in gray_crop_paths]
            log(f"  jpeg_plain.py decoded the grayscale MJPG crops in "
                f"{time.perf_counter() - t0:.1f} s")
            label = "batch_video_to_hdr u16/f16 (MJPG gray, auto)"
            run = run_batch(label, gray_paths, gray_crops, "u16", "f16",
                            "auto", "ffmpeg")
            run.pop("out")
            bv = run.pop("merge")[0]   # the staged means, (S, E, H, W, 3)
            runs[label] = run
            if not (torch.equal(bv[..., 0], bv[..., 1]) and
                    torch.equal(bv[..., 1], bv[..., 2])):
                raise AssertionError(f"{label}: the staged channels differ")
            del bv
            torch.cuda.empty_cache()
            t_v2h_gray, _, _ = run_video_to_hdr("video_to_hdr (MJPG gray)",
                                             gray_paths, "ffmpeg")
            # the same scenes from I420 AVIs, through the rawvideo reader;
            # the oracle reads the crops through rawvideo_plain.py
            from camera_linearity_tpu_torch.native import rawvideo_plain
            i420_crops = [np.stack([
                rawvideo_plain.decode_bgr(c, "i420", CROP_ROWS, W5)
                for c in avi.raw_chunks(p, avi.probe_avi(p))])
                for p in i420_crop_paths]
            label = "batch_video_to_hdr u16/f16 (I420, auto)"
            run = run_batch(label, i420_paths, i420_crops, "u16", "f16",
                            "auto", "rawvideo")
            run.pop("merge")
            run.pop("out")
            runs[label] = run
            torch.cuda.empty_cache()
            t_v2h_i420, _, i420_v2h = run_video_to_hdr(
                "video_to_hdr (I420)", i420_paths, "rawvideo")
            streams = stream_phase(
                dev, directory, mjpg_paths, i420_paths, stream0, runs,
                lambda paths: run_batch(
                    "batch_video_to_hdr u16/f16 (MJPG stream 1, auto)",
                    paths, plain_crops["ffmpeg"], "u16", "f16", "auto",
                    "ffmpeg"),
                lambda paths: run_video_to_hdr(
                    "video_to_hdr (MJPG stream 1)", paths, "ffmpeg"))
            mjpg_v2h = stream0["video_to_hdr"]
            del stream0
            lossless = lossless_phase(
                lossless_videos, mpeg4_videos, raw_u16,
                dict(video_to_hdr=i420_v2h), runs,
                lambda label, paths, decoded_as: run_batch(
                    label, paths, crops, "u16", "f16", "auto", decoded_as),
                run_video_to_hdr, container_videos, mjpg_v2h, h264_videos,
                h264_high)
            del raw_u16, i420_v2h, mjpg_v2h
        finally:
            if cl_decoder is not None:
                os.environ["CL_DECODER"] = cl_decoder
        log("  config 5, MJPG beside raw RGBA (host clock; stages overlap):")
        for label, run in runs.items():
            st = run["stages"]
            log(f"    {label}: wall {run['wall']:.3f} s, {run['mps']:.2f} "
                f"MP/s, decode_s {st.get('decode_s', 0):.3f}, stats_s "
                f"{st.get('stats_s', 0):.3f}, finalize_s "
                f"{st.get('finalize_s', 0):.3f}, calibrate_s "
                f"{st.get('calibrate_s', 0):.3f}, merge_s "
                f"{st.get('merge_s', 0):.3f}")
        log(f"    video_to_hdr: raw {t_v2h_s:.3f} s, MJPG {t_v2h_mjpg:.3f} s, "
            f"MJPG gray {t_v2h_gray:.3f} s, I420 {t_v2h_i420:.3f} s")
    finally:
        for name, fn in originals.items():
            setattr(hdr_ops, name, fn)
        cal.calibration = solve
    torch.cuda.empty_cache()

    # welford_algorithm on the card over a 4:4:0 video and a progressive
    # 4:2:0 one at the default decoder, held to the oracle at the crop
    failures, welford_modes = [], {}
    cl_decoder = os.environ.pop("CL_DECODER", None)
    try:
        for variant in ("440", "progressive"):
            vpaths, vcrops, _ = variants[variant]
            obs.reset_stage_times()
            t0 = time.perf_counter()
            got = video.welford_algorithm(vpaths[-1], use_std=True,
                                          backend="device", batch_size=8)
            seconds = time.perf_counter() - t0
            decoded = obs.decoded_frames.snapshot()
            welford_modes[variant] = seconds
            log(f"  welford_algorithm on the card, MJPG {variant}: "
                f"{seconds:.3f} s host clock, decoders {decoded}")
            if decoded != {"ffmpeg": FRAMES5}:
                failures.append(f"{variant} decoders {decoded}")
            om, ostd = moments_oracle(plain_crop_frames(vcrops[-1], "ffmpeg"))
            check_gap(f"MJPG {variant} device vs NumPy oracle (crop), mean",
                      got["mean"][:CROP_ROWS], om, 2e-6, failures)
            check_gap(f"MJPG {variant} device vs NumPy oracle (crop), std",
                      got["std"][:CROP_ROWS], ostd, 2e-5, failures)
    finally:
        if cl_decoder is not None:
            os.environ["CL_DECODER"] = cl_decoder
    raise_failures("phase 14, welford_algorithm on 4:4:0 and progressive "
                   "MJPG", failures)

    # decode and statistics together on one MJPG video, by decoder threads
    threads = sorted({2, 4, os.cpu_count() or 1})
    batch_decode = native.jpeg_decode_bgr_batch
    t_by_threads = {}
    try:
        for t in threads:
            native.jpeg_decode_bgr_batch = (
                lambda p, d, t=t, **kw: batch_decode(p, d, **{
                    **kw, "threads": t}))
            t_by_threads[t] = host_ms(lambda: video.welford_algorithm(
                mjpg_paths[-1], use_std=True, decoder="turbo_fast"),
                runs=3, warmup=1)
    finally:
        native.jpeg_decode_bgr_batch = batch_decode
    log(f"  welford_algorithm (host backend, turbo_fast) on one MJPG video "
        f"of {FRAMES5} frames, by decoder threads: "
        + ", ".join(f"{t}: {ms:.0f} ms" for t, ms in t_by_threads.items()))
    return dict(paths=paths, mjpg_paths=mjpg_paths, i420_paths=i420_paths,
                pool=pool, launches=launches,
                welford_ms=welford, icrf=icrf, spec=spec,
                welford_bound_ms=wf_bound, k1=k1_times,
                mjpg=dict(decode_ms=decode_ms, frame_bytes=sizes,
                          runs={k: dict(wall=r["wall"], mps=r["mps"],
                                        stages=r["stages"])
                                for k, r in runs.items()},
                          video_to_hdr_s=dict(raw=t_v2h_s, mjpg=t_v2h_mjpg,
                                              mjpg_gray=t_v2h_gray,
                                              i420=t_v2h_i420),
                          streams=streams, lossless=lossless,
                          welford_modes_s=welford_modes,
                          welford_ms_by_threads=t_by_threads),
                k3=dict(ms=k3_ms, plain_ms=k3_plain_ms, bytes=k3_bytes,
                        bound_ms=k3_bound, copy_ms=k3_copy,
                        video_to_hdr_ms=t_v2h_s * 1e3))


class LogRecords(logging.Handler):
    """Keeps the port logger's records, to read the numbers a command
    logged (its arguments, not its text)."""

    def __init__(self):
        super().__init__()
        self.records = []

    def emit(self, record):
        self.records.append(record)

    def arg(self, prefix: str):
        found = [r.args[0] for r in self.records
                 if r.msg.startswith(prefix)]
        if not found:
            raise AssertionError(f"nothing logged as {prefix!r}")
        return np.asarray(found[-1])


def write_captures(root, dev) -> dict:
    """BASELINE config 3's captures as files: 6 exposures of 1200 x 1920 x
    3 at FILE_EXPOSURES_MS (a gamma-like response of one scene plus read
    noise, as 8-bit LZW value TIFFs and float64 STD TIFFs), dark frames
    with ~0.5 % hot pixels for the exposures at or above dark_threshold,
    a vignetted flat with its STD, the gamma PCA basis, and a config.ini
    naming them.  Generated on the card from a seed.  Returns {path:
    array written}."""
    from camera_linearity_tpu_torch import CameraConfig
    from camera_linearity_tpu_torch.utils import tiff
    gen = torch.Generator(device=dev).manual_seed(SEED + 15)

    def rand(*shape):
        return torch.rand(shape, generator=gen, device=dev,
                          dtype=torch.float64)

    def dn(x):
        return torch.round(x.clamp(0, 1) * 255).to(torch.uint8)
    written = {}

    def put(path, tensor):
        arr = tensor.cpu().numpy()
        tiff.imwrite(path, arr)
        written[path] = arr
    images, darks, flats = (root / n for n in ("images", "darks", "flats"))
    for d in (images, darks, flats):
        d.mkdir()
    radiance = rand(H, W, C) ** 2
    gamma = torch.tensor([2.0, 2.2, 2.4], dtype=torch.float64, device=dev)
    for ms in FILE_EXPOSURES_MS:
        lin = (radiance * (ms / 40)).clamp(max=1.0)
        noise = torch.randn((H, W, C), generator=gen, device=dev,
                            dtype=torch.float64)
        val = dn(lin ** (1 / gamma) + 0.004 * noise)
        put(images / f"{ms}ms BF sample 50x.tif", val)
        put(images / f"{ms}ms BF sample 50x STD.tif",
            0.002 + 0.01 * torch.sqrt(val.double() / 255.0))
    for ms in FILE_EXPOSURES_MS:
        if ms / 1000 < CameraConfig().dark_threshold:
            continue
        dark = rand(H, W, C) * 0.01
        hot = rand(H, W, C) < 0.005
        dark[hot] = 0.05 + 0.45 * rand(int(hot.sum()))
        put(darks / f"{ms}ms BF dark 50x.tif", dn(dark))
    yy, xx = torch.meshgrid(
        torch.linspace(-1, 1, H, dtype=torch.float64, device=dev),
        torch.linspace(-1, 1, W, dtype=torch.float64, device=dev),
        indexing="ij")
    flat = (0.6 + 0.3 * torch.cos(0.6 * torch.sqrt(yy ** 2 + xx ** 2)))
    put(flats / "BF flat 50x.tif", dn(flat[..., None].expand(H, W, C)))
    put(flats / "BF flat 50x STD.tif",
        torch.full((H, W, C), 0.004, dtype=torch.float64, device=dev))
    mean_icrf, pca = gamma_basis()
    for ch in "bgr":
        np.savetxt(root / f"pca_{ch}.txt", pca)
        np.savetxt(root / f"mean_{ch}.txt", mean_icrf)
    (root / "config.ini").write_text(f"""[Integer data]
channels = 3
bit depth = 8
final datapoints = 256
number of principal components = {pca.shape[1]}

[String data]
dark frames path = {darks}
flat fields path = {flats}
principal components = pca_b.txt,pca_g.txt,pca_r.txt
mean ICRFs = mean_b.txt,mean_g.txt,mean_r.txt
""")
    return written


def codec_rates(arr, path) -> dict:
    """Write and read MB/s of one plane through the port's codec on the
    host clock (median of 3; MB of the array's bytes)."""
    from camera_linearity_tpu_torch.utils import tiff
    w, r = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        tiff.imwrite(path, arr)
        w.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        tiff.imread(path, tiff.IMREAD_UNCHANGED)
        r.append(time.perf_counter() - t0)
    mb = arr.nbytes / 1e6
    return dict(mb=mb, write_mbps=mb / float(np.median(w)),
                read_mbps=mb / float(np.median(r)),
                file_mb=path.stat().st_size / 1e6)


def same_image(got, want) -> bool:
    """``got`` is ``want`` bit for bit (dtype and shape too), or both are
    None."""
    if got is None or want is None:
        return got is None and want is None
    return got.dtype == want.dtype and got.shape == want.shape and \
        np.array_equal(got, want)


def tiff_layout_phase(root) -> dict:
    """Phase 15 (b): one config-3 plane (H x W, 3 samples, one for gray)
    in each TIFF layout the reader gained, written by
    ``tests/_torch_tiff_writer.py`` and read under IMREAD_UNCHANGED and
    IMREAD_COLOR: held bit for bit to the arrays of ``layout_cases``
    (``tests/test_torch_tiff.py`` holds those formulas to cv2 on the
    CPU), the PackBits plane's chunks decoded natively and by the plain
    version.  Returns each layout's read MB/s (IMREAD_UNCHANGED, host
    clock, median of 3; MB of the samples written)."""
    from camera_linearity_tpu_torch import native
    from camera_linearity_tpu_torch.native import tiff_plain
    from camera_linearity_tpu_torch.utils import tiff
    from tests._torch_tiff_writer import build_tiff, layout_cases
    log(f"phase 15 (b): the layouts the TIFF reader gained, one {H} x {W} "
        "plane each, under both flags")
    path = root / "layout.tif"
    rates, failures = {}, []
    for name, px, kw, want_u, want_c in layout_cases(H, W, SEED + 16):
        build_tiff(path, "<", px, **kw)
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            got_u = tiff.imread(path, tiff.IMREAD_UNCHANGED)
            walls.append(time.perf_counter() - t0)
        got_c = tiff.imread(path, tiff.IMREAD_COLOR)
        ok = same_image(got_u, want_u) and same_image(got_c, want_c)
        mbps = None if want_u is None else \
            px.nbytes / 1e6 / float(np.median(walls))
        rates[name] = mbps
        shapes = [None if g is None else f"{g.dtype} {g.shape}"
                  for g in (got_u, got_c)]
        log(f"  {'ok ' if ok else 'BAD'} {name}: {shapes}; read "
            + ("None, as cv2" if mbps is None else f"{mbps:.1f} MB/s")
            + f" ({path.stat().st_size / 1e6:.1f} MB on disk)")
        if not ok:
            failures.append(name)
        if name == "PackBits u8 RGB":
            data = np.fromfile(path, np.uint8)
            ifd = tiff._Ifd(data, "<", int(data[4:8].view("<u4")[0]))
            offsets, counts, rps = ifd.get(273), ifd.get(279), ifd.one(278)
            sizes = np.minimum(rps, H - rps * np.arange(offsets.size)) * \
                W * px.shape[2]
            starts = np.concatenate([[0], np.cumsum(sizes[:-1])])
            out = np.empty(int(sizes.sum()), np.uint8)
            native.packbits_decode_chunks(data, offsets, counts, out,
                                          starts, sizes)
            plain = b"".join(tiff_plain.packbits_decode(
                data[o:o + c].tobytes(), int(n))
                for o, c, n in zip(offsets, counts, sizes))
            same = out.tobytes() == plain
            log(f"  {'ok ' if same else 'BAD'} native PackBits == "
                f"tiff_plain.packbits_decode on the {offsets.size} strips")
            if not same:
                failures.append("native PackBits against its plain version")
    path.unlink()
    raise_failures("phase 15 (b)", failures)
    return rates


# phase 15 (b): the JPEG, YCbCr, bilevel and CCITT layouts, one config-3
# plane each: (name, samples: "rgb" the first capture's 8-bit values in file
# order, "gray" its green channel, "nibble" that >> 4, "bilevel" a hatch
# over the flat's disk, "units" the values taken as Y, Cb, Cr; keywords)
JPEG_LAYOUTS = (
    ("JPEG YCbCr 4:2:0 strips", "rgb", dict(compression=7, ycbcr=(2, 2),
                                            quality=90, rps=16)),
    ("JPEG YCbCr 4:2:0 tiles 256", "rgb", dict(compression=7, ycbcr=(2, 2),
                                               quality=90, tile=(256, 256))),
    ("JPEG 4:4:4 RGB", "rgb", dict(compression=7, quality=90, rps=16)),
    ("JPEG gray", "gray", dict(compression=7, quality=90, rps=16)),
    ("YCbCr 2x2 uncompressed", "units", dict(ycbcr=(2, 2), rps=16)),
    ("1-bit uncompressed", "bilevel", dict(bits=1, rps=64)),
    ("1-bit PackBits", "bilevel", dict(bits=1, compression=32773, rps=64)),
    ("4-bit gray (cv2: None)", "nibble", dict(bits=4, rps=64)),
    ("CCITT G3 1-D", "bilevel", dict(bits=1, compression=3, rps=64,
                                     extra_tags=[(262, 3, [0])])),
)
# phase 16 (b), third series: config 3's 8-bit files as libtiff writes
# JPEG-compressed YCbCr 4:2:0
JPEG_SERIES = dict(compression=7, ycbcr=(2, 2), quality=90, tile=(256, 256))


def plain_pool():
    """Processes for the plain decoders (pure Python, one chunk a task);
    spawned, so that none inherits the CUDA context."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor
    return ProcessPoolExecutor(max_workers=os.cpu_count() or 1,
                               mp_context=multiprocessing.get_context(
                                   "spawn"))


class PlainCodecs:
    """Within ``with``, ``utils/tiff.imread`` decodes JPEG, CCITT and
    PackBits chunks with the plain versions (``jpeg_plain.decode_tiff``,
    ``tiff_plain.ccitt_decode``, ``tiff_plain.packbits_decode``), the
    chunks spread over ``pool``: the plain reader."""

    def __init__(self, pool):
        self.pool = pool

    @staticmethod
    def chunk_bytes(src, offsets, counts):
        return [src[o:o + c].tobytes() for o, c in
                zip(np.asarray(offsets).tolist(),
                    np.asarray(counts).tolist())]

    def jpeg(self, tables, src, offsets, counts, dst, dst_offsets, heights,
             width, form, sampling=(1, 1)):
        from camera_linearity_tpu_torch.native import jpeg_plain
        chunks = self.chunk_bytes(src, offsets, counts)
        n = len(chunks)
        rcs = []
        for (code, frame), at in zip(self.pool.map(
                jpeg_plain.decode_tiff, [bytes(tables)] * n, chunks,
                [int(h) for h in heights], [width] * n, [form] * n,
                [tuple(sampling)] * n, chunksize=2),
                np.asarray(dst_offsets).tolist()):
            if code == 0:
                dst[at:at + frame.size] = frame.reshape(-1)
            rcs.append(code)
        return np.array(rcs, np.int32)

    def ccitt(self, src, offsets, counts, dst, dst_offsets, dst_sizes, rows,
              width, compression, t4_options=0):
        from camera_linearity_tpu_torch.native import tiff_plain
        chunks = self.chunk_bytes(src, offsets, counts)
        n = len(chunks)
        got = []
        for raw, at in zip(self.pool.map(
                tiff_plain.ccitt_decode, chunks, [width] * n,
                [int(r) for r in rows], [compression] * n,
                [t4_options] * n, chunksize=2),
                np.asarray(dst_offsets).tolist()):
            dst[at:at + len(raw)] = np.frombuffer(raw, np.uint8)
            got.append(len(raw))
        return np.array(got, np.int64)

    @staticmethod
    def packbits(src, offsets, counts, dst, dst_offsets, dst_sizes):
        from camera_linearity_tpu_torch.native import tiff_plain
        got = []
        for chunk, at, size in zip(PlainCodecs.chunk_bytes(src, offsets,
                                                           counts),
                                   np.asarray(dst_offsets).tolist(),
                                   np.asarray(dst_sizes).tolist()):
            raw = tiff_plain.packbits_decode(chunk, size)
            dst[at:at + len(raw)] = np.frombuffer(raw, np.uint8)
            got.append(len(raw))
        return np.array(got, np.int64)

    def __enter__(self):
        from camera_linearity_tpu_torch import native
        self.saved = (native.jpeg_decode_tiff_chunks,
                      native.ccitt_decode_chunks,
                      native.packbits_decode_chunks)
        native.jpeg_decode_tiff_chunks = self.jpeg
        native.ccitt_decode_chunks = self.ccitt
        native.packbits_decode_chunks = self.packbits
        return self

    def __exit__(self, *exc):
        from camera_linearity_tpu_torch import native
        (native.jpeg_decode_tiff_chunks, native.ccitt_decode_chunks,
         native.packbits_decode_chunks) = self.saved


def jpeg_layout_samples(kind, capture, flat):
    """The samples of a ``JPEG_LAYOUTS`` plane (see there)."""
    if kind in ("rgb", "units"):
        return np.ascontiguousarray(capture[..., ::-1])
    if kind == "gray":
        return np.ascontiguousarray(capture[..., 1])
    if kind == "nibble":
        return capture[..., 1] >> 4
    yy, xx = np.mgrid[:capture.shape[0], :capture.shape[1]]
    disk = flat[..., 0] > np.median(flat[..., 0])
    return (((xx // 7 + yy // 11) % 3 == 0) ^ disk).astype(np.uint8)


def tiff_jpeg_layout_phase(root, capture, flat, pool) -> dict:
    """Phase 15 (b), the JPEG, YCbCr and fax layouts: one config-3 plane
    in each of ``JPEG_LAYOUTS`` (written by
    ``tests/_torch_tiff_writer.py`` in ``pool``), read under IMREAD_UNCHANGED and IMREAD_COLOR natively and
    by the plain reader (``PlainCodecs``), bit for bit alike, None
    included; then every committed ``tests/data/tiff *.tif`` under both
    flags against the cv2 arrays beside it.  Returns each layout's read
    MB/s (IMREAD_UNCHANGED, host clock, median of 3; MB of the samples
    written; None where cv2 gives None)."""
    from camera_linearity_tpu_torch.utils import tiff
    from tests._torch_tiff_writer import build_tiff
    log(f"phase 15 (b), JPEG, YCbCr and fax layouts: one {H} x {W} plane "
        "each, native against the plain reader under both flags")
    failures, rates = [], {}
    flags = (tiff.IMREAD_UNCHANGED, tiff.IMREAD_COLOR)
    t0 = time.perf_counter()
    paths, samples = {}, {}
    jobs = []
    for k, (name, kind, kw) in enumerate(JPEG_LAYOUTS):
        paths[name] = root / f"layout{k}.tif"
        samples[name] = jpeg_layout_samples(kind, capture, flat)
        jobs.append(pool.submit(build_tiff, paths[name], "<", samples[name],
                                **kw))
    for job in jobs:
        job.result()
    log(f"  {len(jobs)} planes written in {time.perf_counter() - t0:.2f} s "
        f"({os.cpu_count()} processes)")
    for name, kind, kw in JPEG_LAYOUTS:
        path = paths[name]
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            got_u = tiff.imread(path, tiff.IMREAD_UNCHANGED)
            walls.append(time.perf_counter() - t0)
        got_c = tiff.imread(path, tiff.IMREAD_COLOR)
        t0 = time.perf_counter()
        with PlainCodecs(pool):
            plain = [tiff.imread(path, f) for f in flags]
        t_plain = time.perf_counter() - t0
        ok = same_image(got_u, plain[0]) and same_image(got_c, plain[1])             and (got_u is None) == ("None" in name)
        mbps = None if got_u is None else             samples[name].nbytes / 1e6 / float(np.median(walls))
        rates[name] = mbps
        shapes = [None if g is None else f"{g.dtype} {g.shape}"
                  for g in (got_u, got_c)]
        log(f"  {'ok ' if ok else 'BAD'} {name}: {shapes} == the plain "
            f"reader's ({t_plain:.2f} s); read "
            + ("None, as cv2" if mbps is None else f"{mbps:.1f} MB/s")
            + f" ({path.stat().st_size / 1e6:.2f} MB on disk)")
        if not ok:
            failures.append(name)
        path.unlink()
    committed = sorted((ROOT / "tests" / "data").glob("tiff *.tif"))
    for path in committed:
        with np.load(path.with_suffix(".cv2.npz")) as z:
            want = [z[k] if k in z.files else None
                    for k in ("unchanged", "color")]
        got = [tiff.imread(path, f) for f in flags]
        ok = all(same_image(g, w) for g, w in zip(got, want))
        if not ok:
            failures.append(path.name)
    log(f"  {'ok ' if len(committed) == 14 and not failures else 'BAD'} "
        f"{len(committed)} committed tests/data/tiff *.tif == their "
        "*.cv2.npz (cv2's arrays) under both flags")
    if len(committed) != 14:
        failures.append(f"{len(committed)} committed files, not 14")
    raise_failures("phase 15 (b), JPEG, YCbCr and fax layouts", failures)
    return rates


def rewrite_captures(root, dest, written, values=None, pool=None) -> Path:
    """Config 3's captures (``written``: path -> array, from
    ``write_captures``) rewritten under ``dest``: the 8-bit values, darks
    and flat as BigTIFF + PackBits + PlanarConfiguration 2 (strips of 16
    rows), or with the ``build_tiff`` keywords ``values``; the float64
    STD files as BigTIFF planar uncompressed, or, with ``values``, as
    uncompressed strips; with a config.ini naming the new darks and
    flats.  ``pool``: the processes writing the files.  Returns the
    ini."""
    from tests._torch_tiff_writer import build_tiff
    jobs = []
    for path, arr in written.items():
        out = dest / path.relative_to(root)
        out.parent.mkdir(parents=True, exist_ok=True)
        if values is not None:
            kw = values if arr.dtype == np.uint8 else dict(rps=16)
        else:
            kw = dict(bigtiff=True, planar=True, rps=16,
                      **(dict(compression=32773) if arr.dtype == np.uint8
                         else {}))
        args = (build_tiff, out, "<", arr[..., ::-1])
        if pool is None:
            build_tiff(*args[1:], **kw)
        else:
            jobs.append(pool.submit(*args, **kw))
    for job in jobs:
        job.result()
    for txt in root.glob("*.txt"):
        if txt.name.startswith(("pca_", "mean_")):
            shutil.copy(txt, dest / txt.name)
    ini = (root / "config.ini").read_text()
    for sub in ("darks", "flats"):
        ini = ini.replace(str(root / sub), str(dest / sub))
    (dest / "config.ini").write_text(ini)
    return dest / "config.ini"


def params_of_curve(curve, mean_icrf, pca):
    """PCA parameters whose pinned curve is ``curve``: the pinned curve is
    (mean[k] - mean[-1] + 1) + (pca[k] - pca[-1]) @ p, linear in p; a
    least-squares fit over the inner points recovers p."""
    a = pca[1:-1] - pca[-1]
    b = curve[1:-1] - mean_icrf[1:-1] + mean_icrf[-1] - 1.0
    p = np.linalg.lstsq(a, b, rcond=None)[0]
    fit = mean_icrf + pca @ p
    fit = fit + (1 - fit[-1])
    fit[0] = 0.0
    return p, float(np.max(np.abs(fit - curve)))


def file_phases(dev, res, video_paths, mjpg_paths, pool) -> dict:
    """Phases 15-16: the port's TIFF codec and its command line, from
    files, on the default device.  Returns the command line's kernel
    launches and the numbers measured."""
    import importlib.util
    from camera_linearity_tpu_torch import CameraConfig, native
    from camera_linearity_tpu_torch.__main__ import (_load_icrf,
                                                     _load_icrf_base)
    from camera_linearity_tpu_torch.__main__ import main as cli
    from camera_linearity_tpu_torch.models import calibration as cal
    from camera_linearity_tpu_torch.models import video
    from camera_linearity_tpu_torch.models.exposure_series import \
        ExposureSeries
    from camera_linearity_tpu_torch.models.image_set import ImageSet
    from camera_linearity_tpu_torch.models.scipy_strict import \
        reference_energy
    from camera_linearity_tpu_torch.ops import hdr as hdr_ops
    from camera_linearity_tpu_torch.ops import hdr_cuda
    from camera_linearity_tpu_torch.utils import observability as obs
    from camera_linearity_tpu_torch.utils import tiff

    numbers = {}
    # --- phase 15: the codec and config 3's captures as files -------------
    log("phase 15: the native TIFF codec and BASELINE config 3's captures "
        f"as files ({len(FILE_EXPOSURES_MS)} exposures of {H} x {W} x {C}"
        f" at {FILE_EXPOSURES_MS} ms)")
    t0 = time.perf_counter()
    if not native.tiff_available():
        raise AssertionError("the native TIFF codec did not build: "
                             f"{native.build_error('_tiff')}")
    log(f"  codec built and loaded in {time.perf_counter() - t0:.2f} s: "
        f"{native._lib_path('_tiff', native._TIFF_SRC)}")
    tmp = tempfile.TemporaryDirectory(prefix="clt_files_")
    root = Path(tmp.name)
    try:
        t0 = time.perf_counter()
        written = write_captures(root, dev)
        t_write = time.perf_counter() - t0
        t0 = time.perf_counter()
        for path, arr in written.items():
            got = tiff.imread(path, tiff.IMREAD_UNCHANGED)
            if got is None or got.dtype != arr.dtype or \
                    not np.array_equal(got, arr):
                raise AssertionError(f"{path.name} does not read back as "
                                     "written")
        t_read = time.perf_counter() - t0
        total = sum(a.nbytes for a in written.values()) / 1e6
        on_disk = sum(p.stat().st_size for p in written) / 1e6
        log(f"  ok  {len(written)} files ({total:.1f} MB of arrays, "
            f"{on_disk:.1f} MB on disk) written in {t_write:.2f} s "
            f"(generation included) and read back bit for bit in "
            f"{t_read:.2f} s")
        images = root / "images"
        first = f"{FILE_EXPOSURES_MS[0]}ms BF sample 50x"
        for label, name in (("u8 LZW", f"{first}.tif"),
                            ("f64", f"{first} STD.tif")):
            rates = codec_rates(written[images / name], root / "rate.tif")
            numbers[f"codec_{label.replace(' ', '_')}"] = rates
            log(f"  {label} plane ({rates['mb']:.1f} MB, "
                f"{rates['file_mb']:.1f} MB on disk): write "
                f"{rates['write_mbps']:.1f} MB/s, read "
                f"{rates['read_mbps']:.1f} MB/s (host clock, median of 3)")
        numbers["codec_layouts_read_mbps"] = tiff_layout_phase(root)
        # phase 12's spawned processes, phases 15 (b) to 16 (b)
        numbers["codec_jpeg_layouts_read_mbps"] = tiff_jpeg_layout_phase(
            root, written[images / f"{first}.tif"],
            written[root / "flats" / "BF flat 50x.tif"], pool)

        # --- phase 16: the command line in-process ------------------------
        ini = str(root / "config.ini")
        cfg = CameraConfig.from_ini(ini)
        icrf_path = root / "icrf.txt"
        logs = LogRecords()
        port_logger = obs.get_logger()  # set up before a handler is added
        port_logger.addHandler(logs)
        failures = []
        log("phase 16 (a): calibrate --images DIR --spacing 150 --maxiter "
            "1000 --seed 7 (default device)")
        t0 = time.perf_counter()
        rc = cli(["--config", ini, "calibrate", "--images", str(images),
                  "--spacing", "150", "--maxiter", "1000", "--seed", "7",
                  "--out", str(icrf_path)])
        torch.cuda.synchronize()
        numbers["calibrate_s"] = time.perf_counter() - t0
        e0 = logs.arg("initial energies")
        e1 = logs.arg("final energies")
        base_curve = np.loadtxt(root / "icrf_base.txt")
        icrf_file = np.loadtxt(icrf_path)
        log(f"  rc {rc}, {numbers['calibrate_s']:.3f} s host clock "
            f"(cold); energies {e0.tolist()} -> {e1.tolist()}; ICRF "
            f"{icrf_file.shape}, base {base_curve.shape}")
        if rc != 0 or not np.all(e1 <= e0) or icrf_file.shape != (256, C):
            failures.append("calibrate's rc, energies or ICRF")
        stacks, _, _, _ = cal.initialize_channel_image_stacks(
            images, False, 150, config=cfg)
        dn = stacks.cpu().numpy()
        t_exp = np.array(FILE_EXPOSURES_MS, float) / 1000
        mean_icrf, pca = gamma_basis()
        for c in range(C):
            params, fit_err = params_of_curve(base_curve[:, c], mean_icrf,
                                              pca)
            oracle = reference_energy(params, mean_icrf, pca,
                                      dn[c][:, None, :], None, 5, 250, True,
                                      t_exp, 256)
            gap = abs(e1[c] - oracle) / oracle
            log(f"  channel {c}: logged final {e1[c]:.8f}, oracle on the "
                f"written curve {oracle:.8f} (rel gap {gap:.2e}; curve "
                f"refit {fit_err:.1e}), {dn.shape[1]} pixels")
            if not gap <= ORACLE_RTOL or not fit_err < 1e-5:
                failures.append(f"channel {c} energy against the oracle")
        raise_failures("phase 16 (a)", failures)

        log("phase 16 (b): merge --images DIR --icrf <calibrated> --std "
            "(darks and flat from config.ini)")
        out_dir = root / "hdr"
        merge_args = ["--config", ini, "merge", "--images", str(images),
                      "--icrf", str(icrf_path), "--std", "--out",
                      str(out_dir)]
        for k in hdr_cuda.KERNELS:
            k.launches = 0
        torch.cuda.synchronize()
        rc = cli(merge_args)
        torch.cuda.synchronize()
        counts = {k.__name__: k.launches for k in hdr_cuda.KERNELS}
        log(f"  rc {rc}; launches {counts} (1 series)")
        if rc != 0 or counts != {"merge_nhwc_fused": 0, "merge_nhwc_lerp": 0,
                                 "merge_nhwc_lerp_bp": 1}:
            raise AssertionError(f"merge: rc {rc}, launches {counts}")
        got = [tiff.imread(out_dir / f"sample BF 50x HDR{s}.tif",
                           tiff.IMREAD_UNCHANGED) for s in ("", " STD")]

        def merged(device, images=images, cfg=cfg):
            """process_HDR_image on the series and frames the command
            loads, with the tables it loads, on ``device``."""
            d = torch.device(device)
            icrf, icrf_diff = _load_icrf(icrf_path, cfg, d)
            base, diff_base = _load_icrf_base(icrf_path, d)
            (series,) = ExposureSeries.from_dir_path(images, config=cfg,
                                                     device=d)
            series.load_value_images()
            series.load_std_images()
            darks = ImageSet.multiple_from_path(cfg.default_dark_path,
                                                config=cfg, device=d)
            for s in darks:
                s.load_value_image()
            flats = ImageSet.multiple_from_path(cfg.default_flat_path,
                                                config=cfg, device=d)
            for s in flats:
                s.load_value_image()
                s.load_std_image()
            hdr = series.process_HDR_image(
                ICRF=icrf, ICRF_diff=icrf_diff, list_of_dark_fields=darks,
                flat_field=series.input_image_sets[0].get_flat_field(flats),
                ICRF_base=base, ICRF_diff_base=diff_base)
            return hdr.measurand.val, hdr.measurand.std
        rec = {}
        original = hdr_ops.merge_corrected

        def recorder(*args, **kwargs):
            rec["args"], rec["kwargs"] = args, kwargs
            return original(*args, **kwargs)
        hdr_ops.merge_corrected = recorder
        try:
            card = merged(dev)
        finally:
            hdr_ops.merge_corrected = original
        for label, g, w in (("HDR", got[0], card[0]),
                            ("HDR STD", got[1], card[1])):
            same = g is not None and g.dtype == np.float64 and \
                np.array_equal(g, w.cpu().numpy().astype(np.float64))
            log(f"  {'ok ' if same else 'BAD'} {label} file == "
                "process_HDR_image on the card, exactly")
            if not same:
                failures.append(f"{label} file against the card")
        val, std, dark, ex = rec["args"][:4]
        thr = rec["args"][6]
        base, diff_base = rec["kwargs"]["icrf_base"], \
            rec["kwargs"]["icrf_diff_base"]
        res.check("merge_nhwc_lerp_bp", "the command's inputs vs "
                  "merge_lerp_bp_plain",
                  hdr_cuda.merge_nhwc_lerp_bp(val, std, dark, ex, base,
                                              diff_base, thr, 256),
                  hdr_cuda.merge_lerp_bp_plain(val, std, dark, ex, base,
                                               diff_base, thr, 256))
        del val, std, dark, card, rec
        t0 = time.perf_counter()
        cpu = merged("cpu")
        log(f"  CPU float64 reference run: {time.perf_counter() - t0:.1f} s")
        res.check(None, "merge files vs the CPU in float64",
                  (torch.as_tensor(got[0]), torch.as_tensor(got[1])), cpu,
                  E2E_VAL_TOL, E2E_STD_TOL)
        del cpu
        raise_failures("phase 16 (b)", failures)
        walls, splits = [], []
        for run in range(4):  # one warm run, then 3 timed
            obs.reset_stage_times()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            cli(merge_args)
            torch.cuda.synchronize()
            if run:
                walls.append(time.perf_counter() - t0)
                splits.append(obs.stage_times.snapshot())
        k = int(np.argsort(walls)[1])
        numbers["merge_s"] = dict(walls=walls, median=walls[k],
                                  split_of_median=splits[k])
        log(f"  merge walls {[round(w, 4) for w in walls]} s (host clock, "
            f"after one warm run); the median's split "
            f"{ {n: round(v, 4) for n, v in splits[k].items()} }")
        with obs.trace(root / "trace") as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            cli(merge_args)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        busy_ms, n_dev = obs.device_busy(prof)
        (trace_file,) = (root / "trace").glob("*.json")
        numbers["merge_traced"] = dict(wall_s=wall, busy_ms=busy_ms,
                                       device_ops=n_dev,
                                       busy_share=busy_ms / 1e3 / wall)
        log(f"  under trace: {wall:.4f} s wall, device busy {busy_ms:.3f} ms"
            f" over {n_dev} kernels and copies: busy share "
            f"{busy_ms / 1e3 / wall * 100:.2f} % (trace "
            f"{trace_file.stat().st_size / 1e6:.1f} MB)")
        launches = {"CLI merge (phase 16)": counts}

        log("phase 16 (b), second series: the same captures as BigTIFF + "
            "PackBits + planar 8-bit values, darks and flat and BigTIFF "
            "planar float64 STD files")
        alt = root / "layouts"
        t0 = time.perf_counter()
        alt_ini = rewrite_captures(root, alt, written)
        t_rewrite = time.perf_counter() - t0
        for k in hdr_cuda.KERNELS:
            k.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rc = cli(["--config", str(alt_ini), "merge", "--images",
                  str(alt / "images"), "--icrf", str(icrf_path), "--std",
                  "--out", str(alt / "hdr")])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts2 = {k.__name__: k.launches for k in hdr_cuda.KERNELS}
        numbers["merge_layouts"] = dict(rewrite_s=t_rewrite, wall_s=wall)
        log(f"  rewritten in {t_rewrite:.2f} s; rc {rc}, {wall:.3f} s host "
            f"clock (one run); launches {counts2} (1 series)")
        if rc != 0 or counts2 != {"merge_nhwc_fused": 0,
                                  "merge_nhwc_lerp": 0,
                                  "merge_nhwc_lerp_bp": 1}:
            raise AssertionError(f"merge of the rewritten series: rc {rc}, "
                                 f"launches {counts2}")
        for suffix, want in zip(("", " STD"), got):
            g = tiff.imread(alt / "hdr" / f"sample BF 50x HDR{suffix}.tif",
                            tiff.IMREAD_UNCHANGED)
            err = None if g is None or g.shape != want.shape else \
                float(np.max(np.abs(g - want)))
            log(f"  {'ok ' if err == 0 else 'BAD'} HDR{suffix} of the "
                f"rewritten series against the LZW series': max abs error "
                f"{err}")
            if err != 0:
                failures.append(f"HDR{suffix} of the rewritten series")
        raise_failures("phase 16 (b), second series", failures)
        shutil.rmtree(alt)
        launches["CLI merge, BigTIFF + PackBits + planar (phase 16)"] = \
            counts2

        log("phase 16 (b), third series: the same captures as "
            "JPEG-compressed YCbCr 4:2:0 TIFFs (quality 90, 256 x 256 "
            "tiles) for the 8-bit values, darks and flat, uncompressed "
            "float64 STD files")
        jdir = root / "jpeg"
        t0 = time.perf_counter()
        jpeg_ini = rewrite_captures(root, jdir, written, JPEG_SERIES, pool)
        t_rewrite = time.perf_counter() - t0
        for k in hdr_cuda.KERNELS:
            k.launches = 0
        obs.reset_stage_times()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rc = cli(["--config", str(jpeg_ini), "merge", "--images",
                  str(jdir / "images"), "--icrf", str(icrf_path), "--std",
                  "--out", str(jdir / "hdr")])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        split = obs.stage_times.snapshot()
        counts3 = {k.__name__: k.launches for k in hdr_cuda.KERNELS}
        numbers["merge_jpeg"] = dict(rewrite_s=t_rewrite, wall_s=wall,
                                     split=split)
        log(f"  rewritten in {t_rewrite:.2f} s ({os.cpu_count()} "
            f"processes); rc {rc}, {wall:.3f} s host clock (one run; "
            f"stages { {n: round(v, 4) for n, v in split.items()} }); "
            f"launches {counts3} (1 series)")
        if rc != 0 or counts3 != {"merge_nhwc_fused": 0,
                                  "merge_nhwc_lerp": 0,
                                  "merge_nhwc_lerp_bp": 1}:
            raise AssertionError(f"merge of the JPEG series: rc {rc}, "
                                 f"launches {counts3}")
        t0 = time.perf_counter()
        with PlainCodecs(pool):
            plain_card = merged(dev, jdir / "images",
                                CameraConfig.from_ini(str(jpeg_ini)))
        log(f"  process_HDR_image on the plain reader's arrays (card): "
            f"{time.perf_counter() - t0:.2f} s")
        for suffix, want in zip(("", " STD"), plain_card):
            g = tiff.imread(jdir / "hdr" / f"sample BF 50x HDR{suffix}.tif",
                            tiff.IMREAD_UNCHANGED)
            want = want.cpu().numpy().astype(np.float64)
            err = None if g is None or g.shape != want.shape else \
                float(np.max(np.abs(g - want)))
            log(f"  {'ok ' if err == 0 else 'BAD'} HDR{suffix} of the JPEG "
                "series against process_HDR_image on the plain reader's "
                f"arrays: max abs error {err}")
            if err != 0:
                failures.append(f"HDR{suffix} of the JPEG series")
        del plain_card
        raise_failures("phase 16 (b), third series", failures)
        shutil.rmtree(jdir)
        pool.shutdown()
        pool = None
        launches["CLI merge, JPEG YCbCr 4:2:0 tiles (phase 16)"] = counts3

        for kind, paths, vdir in (("raw RGBA", video_paths, "videos"),
                                  ("MJPG", mjpg_paths, "mjpg_videos")):
            log(f"phase 16 (c): video --videos DIR ({len(paths)} {kind} "
                f"videos of {FRAMES5} x {H5} x {W5} from phase 12)")
            vdir = root / vdir
            vdir.mkdir()
            for p in paths:  # the MJPG ones live in build/'s cache
                os.symlink(p, vdir / p.name)
            obs.reset_stage_times()
            t0 = time.perf_counter()
            rc = cli(["video", "--videos", str(vdir)])
            wall = time.perf_counter() - t0
            split = obs.stage_times.snapshot()
            numbers["video_s" if kind == "raw RGBA" else "video_mjpg_s"] = \
                dict(wall=wall, split=split)
            log(f"  rc {rc}, {wall:.3f} s host clock; stages "
                f"{ {n: round(v, 4) for n, v in split.items()} }; decoders "
                f"{obs.decoded_frames.snapshot()}")
            for p in paths:
                want = video.welford_algorithm(p, use_std=True)
                for key, name in (("mean", p.stem + ".tif"),
                                  ("std", p.stem + " STD.tif")):
                    g = tiff.imread(vdir / key / name, tiff.IMREAD_UNCHANGED)
                    same = g is not None and np.array_equal(g, want[key])
                    log(f"  {'ok ' if same else 'BAD'} {key}/{name} == "
                        "welford_algorithm in memory, exactly")
                    if not same:
                        failures.append(f"{key}/{name}")
            raise_failures(f"phase 16 (c), {kind}", failures)

        log("phase 16 (d): dorf on a synthetic dorfCurves.txt")
        data = root / "dorf"
        data.mkdir()
        x = np.linspace(0, 1, 64)
        lines = []
        for name, g in [("aRed", 2.0), ("aGreen", 2.2), ("aBlue", 2.4),
                        ("bRed", 2.1), ("bGreen", 2.3), ("bBlue", 2.5)]:
            lines += [name, "t", "i", "I =",
                      " ".join(f"{v:.5f}" for v in x),
                      " ".join(f"{v:.5f}" for v in x ** g)]
        (data / "dorfCurves.txt").write_text("\n".join(lines) + "\n")
        (data / "config.ini").write_text("""[Integer data]
channels = 3
bit depth = 8
final datapoints = 64
original DoRF datapoints = 64
number of principal components = 1

[String data]
source DoRF data = dorfCurves.txt
ICRFs = icrf_b.txt,icrf_g.txt,icrf_r.txt
mean ICRFs = mean_b.txt,mean_g.txt,mean_r.txt
principal components = pca_b.txt,pca_g.txt,pca_r.txt
""")
        rc = cli(["--config", str(data / "config.ini"), "dorf", "--data",
                  str(data)])
        for ch in "bgr":
            pc = np.loadtxt(data / f"pca_{ch}.txt")
            mean = np.loadtxt(data / f"mean_{ch}.txt")
            if rc != 0 or pc.shape != (64,) or mean.shape != (64,) or \
                    not np.isfinite(pc).all() or pc[0] != 0.0 or \
                    not np.any(pc):
                failures.append(f"dorf pca_{ch}")
        log(f"  rc {rc}; pca_[bgr].txt and mean_[bgr].txt of 64 finite "
            f"points, each component zero-anchored: {not failures}")
        raise_failures("phase 16 (d)", failures)

        # the plots need matplotlib (the card's machine has none); the
        # fits are logged either way, and a missing matplotlib is warned
        plots = importlib.util.find_spec("matplotlib") is not None
        log(f"phase 16 (e): linearity --std (matplotlib "
            f"{'installed' if plots else 'not installed: no PNG'})")
        first = len(logs.records)
        t0 = time.perf_counter()
        rc = cli(["--config", ini, "linearity", "--images", str(images),
                  "--icrf", str(icrf_path), "--std", "--out", str(root)])
        wall = time.perf_counter() - t0
        ran = logs.records[first:]
        fits = [r.args for r in ran if "ODR fit" in r.msg]
        warned = [r for r in ran if r.levelno == logging.WARNING
                  and "matplotlib" in r.getMessage()]
        png = (root / "linearity_relative_0.png").exists()
        numbers["cli_linearity_s"] = wall
        log(f"  rc {rc}; {len(fits)} fits logged in {wall:.3f} s; plots "
            f"{'written' if png else 'not written'}, {len(warned)} "
            "matplotlib warning(s)")
        for f in fits:
            log(f"    {f[1]} {f[2]}: A={f[3]:.5g} B={f[5]:.5g}")
        if rc != 0 or len(fits) != 2 * C or png != plots or \
                len(warned) != (0 if plots else 1) or \
                not all(np.isfinite(f[3:]).all() for f in fits):
            raise AssertionError("phase 16 (e): linearity")

        log("phase 16 (f): doctor")
        if cli(["doctor"]) != 0:
            raise AssertionError("phase 16 (f): doctor")
        port_logger.removeHandler(logs)
    finally:
        if pool is not None:
            pool.shutdown(cancel_futures=True)
        tmp.cleanup()
    return dict(launches=launches, numbers=numbers)


def ablation_phase(dev, val, std, exposures, k1: dict) -> dict:
    """Phase 17: the ablation kernels E1-E5 (``csrc/exp_ablation.cu``) at
    config 2.  Holds every variant against its plain version (the sums
    exactly; ``exp``'s value and the merges at K1's tolerances), drives
    the experiments' entry points with the launch counts reset, times each
    variant in phase 7's interleaved order beside a ``copy_`` of the same
    bytes and, for the plain sums, the two-``torch.sum`` yardstick, sweeps
    E5's launch settings, and splits K1's time (``k1``, phase 7's) into
    bytes, arithmetic and lookup.  Returns the kernels' JSON entries."""
    from camera_linearity_tpu_torch.experiments import exp_kernel, exp_plateau
    from camera_linearity_tpu_torch.ops import ablation_cuda as ab
    t_phase = time.perf_counter()
    n, h, w, c = val.shape
    log(f"phase 17: the ablation kernels E1-E5 at config 2 ({n} x {h} x "
        f"{w} x {c}, f32 value and std)")
    vcf, scf = exp_kernel.cfirst(val), exp_kernel.cfirst(std)
    vf, sf = val.reshape(n, -1), std.reshape(n, -1)
    vp, sp = exp_plateau.planar(val), exp_plateau.planar(std)
    invt = 1.0 / exposures.cpu()  # passed by value: kept on the host

    def sums(v, s, layout, mode="none"):
        return (lambda: ab.exposure_sum(v, s, layout, mode),
                lambda: ab.exposure_sum_plain(v, s, layout, mode))

    def merges(v, s, it, layout, dead=False):
        return (lambda: ab.merge_nolut(v, s, it, layout, dead),
                lambda: ab.merge_nolut_plain(v, s, it, layout))
    # which of (value, std) is held bit for bit; the rest at K1's
    # tolerances.  Every sum's std adds in exposure order, as its plain
    # version does; so does its value but for exp's expf terms.
    exact, exact_std, close = (True, True), (False, True), (False, False)
    # variant: (experiment, (kernel, plain), exactness, library call, f32
    # operations per element and exposure, counted from exp_ablation.cu)
    variants = {
        "E1 cfirst sum": ("E1", sums(vcf, scf, "cfirst"), exact,
                          lambda: (vcf.sum(1), scf.sum(1)), 2),
        "E2 cfirst merge": ("E2", merges(vcf, scf, invt, "cfirst"), close,
                            None, ABLATION_MERGE_OPS),
        "E3 flat merge": ("E3", merges(vf, sf, invt, "flat"), close, None,
                          ABLATION_MERGE_OPS),
        "E3 flat merge, dead index": ("E3", merges(vf, sf, invt, "flat",
                                                   True), close, None,
                                      ABLATION_MERGE_OPS),
        "E4 flat sum": ("E4", sums(vf, sf, "flat"), exact,
                        lambda: (vf.sum(0, keepdim=True),
                                 sf.sum(0, keepdim=True)), 2),
        "E4 flat sum + mod": ("E4", sums(vf, sf, "flat", "mod"), exact,
                              None, 2),
        "E4 flat sum + round": ("E4", sums(vf, sf, "flat", "round"), exact,
                                None, 7),
        "E4 flat sum + exp": ("E4", sums(vf, sf, "flat", "exp"), exact_std,
                              None, 8),
        "E4 flat math": ("E4", merges(vf, sf, None, "flat"), close, None,
                         ABLATION_MERGE_OPS),
        "E5 planar sum": ("E5", sums(vp, sp, "planar"), exact,
                          lambda: (vp.sum(0), sp.sum(0)), 2),
    }

    # each variant, each E5 launch setting, a ragged and a misaligned
    # stack against the plain version
    err = {e: 0.0 for e in ab.KERNELS}
    failures = []

    def hold(label, experiment, got, want, exactness):
        gap = max((g - w_).abs().max().item() for g, w_ in zip(got, want))
        ok = all(torch.equal(g, w_) if ex else torch.allclose(g, w_, **tol)
                 for g, w_, ex, tol in zip(got, want, exactness,
                                           (VAL_TOL, STD_TOL)))
        err[experiment] = max(err[experiment], gap)
        held = {exact: " (exact)", exact_std: " (std exact)"}.get(exactness,
                                                                  "")
        log(f"  {'ok ' if ok else 'BAD'} {label}: max abs err {gap:.3e}"
            f"{held}")
        if not ok:
            failures.append(label)
    for label, (experiment, (kernel, plain), exactness, _, _) in \
            variants.items():
        hold(label, experiment, kernel(), plain(), exactness)
    for threads in ab.THREADS:
        for vec in ab.VECS:
            hold(f"E5 planar sum, {threads} threads x {vec} quads", "E5",
                 ab.exposure_sum(vp, sp, "planar", threads=threads, vec=vec),
                 ab.exposure_sum_plain(vp, sp, "planar"), exact)
    ragged = [x[:, 3:].contiguous() for x in (vf, sf)]  # L % 4 == 1
    skewed = [torch.empty(x.numel() + 1, device=dev)[1:].view_as(x)
              for x in (vf, sf)]  # 4 bytes off 16-byte alignment
    for dst, x in zip(skewed, (vf, sf)):
        dst.copy_(x)
    for label, (v, s) in (("ragged rows", ragged), ("misaligned", skewed)):
        hold(f"E4 flat sum + round, {label}", "E4",
             ab.exposure_sum(v, s, "flat", "round"),
             ab.exposure_sum_plain(v, s, "flat", "round"), exact)
        hold(f"E3 flat merge, {label}", "E3",
             ab.merge_nolut(v, s, invt, "flat"),
             ab.merge_nolut_plain(v, s, invt, "flat"), close)
    del ragged, skewed
    raise_failures("phase 17", failures)

    # the experiments' entry points, launch counts reset
    log("  main path: exp_kernel.run(dma, math, flatdma), flat_dma (every "
        "extra), exp_plateau.run(dma)")
    for e in ab.KERNELS.values():
        e.launches = 0
    run_k = exp_kernel.run(["dma", "math", "flatdma"], device=dev)
    flat = {extra: exp_kernel.flat_dma(vf, sf, extra)
            for extra in (None, "mod", "round", "exp", "math")}
    run_p = exp_plateau.run(["dma"], device=dev)
    torch.cuda.synchronize()
    launches = {e: k.launches for e, k in ab.KERNELS.items()}
    log(f"  launches: {launches}")
    outs = [r.out for r in run_k.values()] + list(flat.values()) + \
        [r.out for r in run_p["dma"].values()]
    if not all(torch.isfinite(x).all() for o in outs for x in o):
        raise AssertionError("phase 17: an experiment returned non-finite "
                             "values")
    for e, count in launches.items():
        if count < 1:
            raise AssertionError(f"phase 17: {e} was not launched by the "
                                 "experiments")
    del run_k, run_p, flat, outs

    # times, in phase 7's interleaved order
    nbytes = (2 * n + 2) * h * w * c * 4
    bytes_ms = nbytes / PEAK_BYTES_S * 1e3
    src = torch.empty(nbytes // 8, dtype=torch.float32, device=dev)
    dst = torch.empty_like(src)

    def copy():
        dst.copy_(src)
    log(f"  times ({nbytes / 1e6:.2f} MB each, bound {bytes_ms:.4f} ms at "
        "3.35 TB/s; median of CUDA-event samples; copy = copy_ of the same "
        "bytes; library = two torch.sum over the exposure axis)")
    timed = {}
    for label, (experiment, (kernel, plain), _, library, ops) in \
            variants.items():
        k_s, p_s, c_s, l_s = [], [], [], []
        order = [(plain, p_s), (copy, c_s)] + \
            ([(library, l_s)] if library else []) + \
            [(kernel, k_s), (kernel, k_s)] + \
            ([(library, l_s)] if library else []) + \
            [(copy, c_s), (plain, p_s)]
        for fn, out in order:
            out += time_samples(fn, runs=10, reps=2 if fn is plain else 10)
        k_ms, p_ms, c_ms = (float(np.median(x)) for x in (k_s, p_s, c_s))
        l_ms = float(np.median(l_s)) if library else None
        ops_ms = ops * n * h * w * c / PEAK_F32_S * 1e3
        bound = max(bytes_ms, ops_ms)
        timed[label] = dict(ms=k_ms, plain_ms=p_ms, copy_ms=c_ms,
                            library_ms=l_ms, bound_ms=bound,
                            bound_by="bytes" if bytes_ms >= ops_ms
                            else "operations", share=bound / k_ms)
        lib = "" if l_ms is None else f", library {l_ms:.4f} ms"
        log(f"  {label}: kernel {k_ms:.4f} ms ({nbytes / k_ms / 1e6:.1f} "
            f"GB/s, {bound / k_ms * 100:.1f} % of the bound), copy "
            f"{c_ms:.4f} ms{lib}, plain {p_ms:.4f} ms; kernel samples "
            f"{min(k_s):.4f}-{max(k_s):.4f} ms")

    log("  E5 launch sweep (planar sum; threads per block x 16-byte quads "
        "a thread; the default is 256 x 1)")
    sweep = {}
    for threads in ab.THREADS:
        for vec in ab.VECS:
            samples = time_samples(lambda: ab.exposure_sum(
                vp, sp, "planar", threads=threads, vec=vec), runs=5, reps=10)
            ms = float(np.median(samples))
            sweep[f"{threads}x{vec}"] = ms
            log(f"    {threads:4d} threads x {vec} quads: {ms:.4f} ms "
                f"({nbytes / ms / 1e6:.1f} GB/s, "
                f"{bytes_ms / ms * 100:.1f} % of the bound)")
    del src, dst, vcf, scf, vp, sp

    e1, e2 = timed["E1 cfirst sum"]["ms"], timed["E2 cfirst merge"]["ms"]
    e3, e4 = timed["E3 flat merge"]["ms"], timed["E4 flat sum"]["ms"]
    split = dict(k1_ms=k1["ms"], lookup_ms=k1["ms"] - e2,
                 math_ms=e2 - e1, e1_over_copy=e1 / timed["E1 cfirst sum"][
                     "copy_ms"], lookup_flat_ms=k1["ms"] - e3,
                 math_flat_ms=e3 - e4)
    log(f"  K1 split (K1 {k1['ms']:.4f} ms from phase 7, NHWC = the flat "
        f"layout): lookup K1 - E2 {split['lookup_ms']:.4f} ms, math E2 - E1 "
        f"{split['math_ms']:.4f} ms, E1 / copy_ {split['e1_over_copy']:.3f};"
        f" on the flat layout: lookup K1 - E3 {split['lookup_flat_ms']:.4f} "
        f"ms, math E3 - E4 {split['math_flat_ms']:.4f} ms")

    # one JSON entry for each experiment, by its first variant
    first = {"E1": "E1 cfirst sum", "E2": "E2 cfirst merge",
             "E3": "E3 flat merge", "E4": "E4 flat sum",
             "E5": "E5 planar sum"}
    kernels = []
    for e, label in first.items():
        entry = {"name": f"{ab.KERNELS[e].wrapper} ({e})", "route": "cuda",
                 "source": ABLATION_SOURCE,
                 "replaces": ab.KERNELS[e].replaces,
                 "launches": launches[e],
                 "launches_by_path": {"experiments (phase 17)": launches[e]},
                 "max_abs_err": err[e], "bytes": nbytes, **timed[label],
                 "variants": {k: v for k, v in timed.items()
                              if variants[k][0] == e}}
        kernels.append(entry)
    kernels[-1]["sweep_ms"] = sweep
    kernels[0]["k1_split"] = split
    log(f"  phase 17: {time.perf_counter() - t_phase:.1f} s")
    return dict(kernels=kernels, launches=launches, e2_ms=e2)


def lut_phase(dev, val, std, exposures, tables, e2_ms: float) -> dict:
    """Phase 18: the lookup-merge experiments E6 and E7
    (``csrc/exp_lut_merge.cu``) on planar copies of config 2/3's stacks.
    Holds E6 at every setting of its sweep, and by its scalar route on a
    37 x 53 crop, and E7 in its three table forms against the plain
    version at K1's tolerances, the forms against each other bit for bit
    (at the JAX script's tolerance, logged, where they differ); drives the
    experiments' entry points with the launch counts reset; times each in
    phase 7's interleaved order beside a ``copy_`` of the same bytes and K1
    at 8 and 12 bits on the same (channels-last) stacks; sweeps E6's
    settings; and extends K1's split with E2's time (``e2_ms``, phase
    17's).  ``tables`` is (icrf8, diff8, icrf12, diff12).  Returns the
    kernels' JSON entries."""
    from camera_linearity_tpu_torch import csrc
    from camera_linearity_tpu_torch.experiments import (exp_int8_planes,
                                                        exp_manual_pipeline)
    from camera_linearity_tpu_torch.ops import hdr_cuda
    from camera_linearity_tpu_torch.ops import lut_merge_cuda as lm
    t_phase = time.perf_counter()
    icrf8, diff8, icrf12, diff12 = tables
    n, h, w, c = val.shape
    log(f"phase 18: the lookup-merge experiments E6 and E7 at config 2/3 "
        f"({n} x {c} x {h} x {w} planar f32 value and std)")
    lib = csrc.build(["exp_lut_merge"])["exp_lut_merge"]
    seconds = csrc.BUILD_SECONDS.get("exp_lut_merge")
    log("  exp_lut_merge.cu: " + ("built before this run" if seconds is None
                                  else f"nvcc {seconds:.1f} s (phase 2)")
        + "; registers and spills (ptxas):")
    for line in (lib.parent / "ptxas.log").read_text().splitlines():
        if any(k in line for k in ("Compiling entry", "Used", "spill")):
            log(f"    {line.strip()}")
    vp, sp = (x.permute(0, 3, 1, 2).contiguous() for x in (val, std))
    invt = 1.0 / exposures.cpu()  # passed by value: kept on the host

    def e6(v=vp, s=sp, chunk=None, stages=None):
        return lm.merge_pipelined(v, s, invt, icrf8, diff8, chunk, stages)

    packed12 = {f: [lm.pack_table(x, f) for x in (icrf12, diff12)]
                for f in lm.FORMS}  # packed once, as exp_int8_planes packs

    def e7(form):
        return lm.merge_table_form(vp, sp, invt, *packed12[form], form)

    def plain(v, s, tab, diff):
        return lambda: lm.merge_planar_plain(v, s, invt, tab, diff)
    plain8, plain12 = plain(vp, sp, icrf8, diff8), plain(vp, sp, icrf12,
                                                         diff12)
    want8, want12 = plain8(), plain12()

    err = {"E6": 0.0, "E7": 0.0}
    failures = []

    def hold(label, experiment, got, want, tols=(VAL_TOL, STD_TOL)):
        gap = max((g - w_).abs().max().item() for g, w_ in zip(got, want))
        ok = all(torch.allclose(g, w_, **tol)
                 for g, w_, tol in zip(got, want, tols))
        err[experiment] = max(err[experiment], gap)
        log(f"  {'ok ' if ok else 'BAD'} {label}: max abs err {gap:.3e}")
        if not ok:
            failures.append(label)
    default = lm.plan_pipeline(n, c)
    settings = lm.pipeline_settings(n, c)
    for chunk, stages in settings:
        mark = " (the default)" if (chunk, stages) == (default.chunk,
                                                       default.stages) else ""
        hold(f"E6 {chunk} x {stages} stages{mark}", "E6", e6(chunk=chunk,
                                                              stages=stages),
             want8)
    cv, cs = (x[:, :, :37, :53].contiguous() for x in (vp, sp))
    if lm.bulk_route(cv[0].numel(), cv.data_ptr(), cs.data_ptr()):
        raise AssertionError("phase 18: the 37 x 53 crop took the bulk route")
    hold("E6 37 x 53 crop (scalar route)", "E6", e6(cv, cs),
         plain(cv, cs, icrf8, diff8)())
    outs = {f: e7(f) for f in lm.FORMS}
    for f, out in outs.items():
        hold(f"E7 {f}", "E7", out, want12)
    bit_equal = all(torch.equal(a, b) for f in lm.FORMS[1:]
                    for a, b in zip(outs[f], outs["f32"]))
    log(f"  E7 forms equal bit for bit: {bit_equal}")
    if not bit_equal:
        for f in lm.FORMS[1:]:
            hold(f"E7 {f} against f32 (exp_int8_planes.py:260-263)", "E7",
                 outs[f], outs["f32"], (exp_int8_planes.FORM_VAL_TOL,
                                        exp_int8_planes.FORM_STD_TOL))
    del cv, cs, outs
    raise_failures("phase 18", failures)

    # the experiments' entry points, launch counts reset
    log("  main path: exp_manual_pipeline.run(), exp_int8_planes.run()")
    for e in lm.KERNELS.values():
        e.launches = 0
    run6 = exp_manual_pipeline.run(device=dev)
    run7 = exp_int8_planes.run(device=dev)
    torch.cuda.synchronize()
    launches = {e: k.launches for e, k in lm.KERNELS.items()}
    log(f"  launches: {launches}")
    results = [r for r in run6.values()] + [run7[k] for k in (*lm.FORMS,
                                                               "k1")]
    if not all(torch.isfinite(x).all() for r in results for x in r.out):
        raise AssertionError("phase 18: an experiment returned non-finite "
                             "values")
    if not run7["bit_equal"]:
        log("  exp_int8_planes.run: the forms differ in some bits")
    for e, count in launches.items():
        if count < 1:
            raise AssertionError(f"phase 18: {e} was not launched by the "
                                 "experiments")
    run_ms = {"E6": {k: r.ms for k, r in run6.items()},
              "E7": {k: run7[k].ms for k in (*lm.FORMS, "k1")}}
    del run6, run7, results

    # times, in phase 7's interleaved order
    nbytes = (2 * n + 2) * h * w * c * 4
    bytes_ms = nbytes / PEAK_BYTES_S * 1e3
    ops_ms = OPS_PER_ELEMENT * n * h * w * c / PEAK_F32_S * 1e3
    bound = max(bytes_ms, ops_ms)
    src = torch.empty(nbytes // 8, dtype=torch.float32, device=dev)
    dst = torch.empty_like(src)

    def copy():
        dst.copy_(src)

    def k1(tab, diff):
        return (lambda: hdr_cuda.merge_nhwc_fused(val, std, exposures, tab,
                                                  diff),
                lambda: hdr_cuda.merge_fused_plain(val, std, exposures, tab,
                                                   diff))
    variants = {  # label: (experiment, kernel, plain)
        f"E6 {default.chunk} x {default.stages}": ("E6", e6, plain8),
        "E7 f32": ("E7", lambda: e7("f32"), plain12),
        "E7 bf16x3": ("E7", lambda: e7("bf16x3"), plain12),
        "E7 u8x4": ("E7", lambda: e7("u8x4"), plain12),
        "K1 8-bit": (None, *k1(icrf8, diff8)),
        "K1 12-bit": (None, *k1(icrf12, diff12)),
    }
    log(f"  times ({nbytes / 1e6:.2f} MB each, bound {bound:.4f} ms at "
        "3.35 TB/s; median of CUDA-event samples; copy = copy_ of the same "
        "bytes; K1 on the channels-last stacks of the same values)")
    timed = {}
    for label, (_, kernel, plain_fn) in variants.items():
        k_s, p_s, c_s = [], [], []
        for fn, out in ((plain_fn, p_s), (copy, c_s), (kernel, k_s),
                        (kernel, k_s), (copy, c_s), (plain_fn, p_s)):
            out += time_samples(fn, runs=10,
                                reps=2 if fn is plain_fn else 10)
        k_ms, p_ms, c_ms = (float(np.median(x)) for x in (k_s, p_s, c_s))
        timed[label] = dict(ms=k_ms, plain_ms=p_ms, copy_ms=c_ms,
                            library_ms=None, bound_ms=bound,
                            bound_by="bytes" if bytes_ms >= ops_ms
                            else "operations", share=bound / k_ms)
        log(f"  {label}: kernel {k_ms:.4f} ms ({nbytes / k_ms / 1e6:.1f} "
            f"GB/s, {bound / k_ms * 100:.1f} % of the bound), copy "
            f"{c_ms:.4f} ms, plain {p_ms:.4f} ms; kernel samples "
            f"{min(k_s):.4f}-{max(k_s):.4f} ms")

    plan = hdr_cuda.fused_launch_plan
    log(f"  K1 routes: 8-bit {plan(val, std, icrf8.shape[0]).route}, "
        f"12-bit {plan(val, std, icrf12.shape[0]).route}")
    log("  E6 sweep (chunk elements x stages; scalar = the route of a stack "
        "4 bytes off alignment)")
    skewed = [torch.empty(x.numel() + 1, device=dev)[1:].view_as(x)
              for x in (vp, sp)]
    for dst_, x in zip(skewed, (vp, sp)):
        dst_.copy_(x)
    hold("E6 scalar route, 4 bytes off", "E6", e6(*skewed), want8)
    raise_failures("phase 18", failures)
    sweep = {}
    runs = {f"{k}x{s}": (lambda k=k, s=s: e6(chunk=k, stages=s))
            for k, s in settings}
    runs["scalar"] = lambda: e6(*skewed)
    for label, fn in runs.items():
        sweep[label] = float(np.median(time_samples(fn, runs=5, reps=10)))
        log(f"    {label:>9}: {sweep[label]:.4f} ms "
            f"({nbytes / sweep[label] / 1e6:.1f} GB/s, "
            f"{bound / sweep[label] * 100:.1f} % of the bound)")
    del src, dst, skewed, vp, sp

    e6_ms = timed[f"E6 {default.chunk} x {default.stages}"]["ms"]
    f32_ms = timed["E7 f32"]["ms"]
    k1_8, k1_12 = timed["K1 8-bit"]["ms"], timed["K1 12-bit"]["ms"]
    split = dict(e6_minus_e2_ms=e6_ms - e2_ms, k1_minus_e6_ms=k1_8 - e6_ms,
                 k1_12_minus_e7_f32_ms=k1_12 - f32_ms,
                 e7_f32_minus_e2_ms=f32_ms - e2_ms,
                 u8x4_over_f32=timed["E7 u8x4"]["ms"] / f32_ms,
                 bf16x3_over_f32=timed["E7 bf16x3"]["ms"] / f32_ms,
                 bf16x3_over_u8x4=timed["E7 bf16x3"]["ms"]
                 / timed["E7 u8x4"]["ms"])
    log(f"  K1 split (E2 {e2_ms:.4f} ms from phase 17): staging and lookup "
        f"E6 - E2 {split['e6_minus_e2_ms']:.4f} ms; K1's own design K1 - "
        f"E6 {split['k1_minus_e6_ms']:.4f} ms (K1 8-bit {k1_8:.4f}); lookup "
        f"at 4096 entries E7 f32 - E2 {split['e7_f32_minus_e2_ms']:.4f} ms, "
        f"K1 12-bit - E7 f32 {split['k1_12_minus_e7_f32_ms']:.4f} ms (K1 "
        f"12-bit {k1_12:.4f}); table form u8x4 / f32 "
        f"{split['u8x4_over_f32']:.3f}, bf16x3 / f32 "
        f"{split['bf16x3_over_f32']:.3f}, bf16x3 / u8x4 "
        f"{split['bf16x3_over_u8x4']:.3f}")

    kernels = []
    for e, label in (("E6", f"E6 {default.chunk} x {default.stages}"),
                     ("E7", "E7 bf16x3")):
        kernels.append({
            "name": f"{lm.KERNELS[e].wrapper} ({e})", "route": "cuda",
            "source": LUT_SOURCE, "replaces": lm.KERNELS[e].replaces,
            "launches": launches[e],
            "launches_by_path": {"experiments (phase 18)": launches[e]},
            "max_abs_err": err[e], "bytes": nbytes, **timed[label],
            "variants": {k: v for k, v in timed.items()
                         if variants[k][0] == e},
            "k1_ms": {"8-bit": k1_8, "12-bit": k1_12}, "run_ms": run_ms[e]})
    kernels[0]["sweep_ms"] = sweep
    kernels[0]["k1_split"] = split
    kernels[1]["bit_equal"] = bit_equal
    log(f"  phase 18: {time.perf_counter() - t_phase:.1f} s")
    return dict(kernels=kernels, launches=launches)


def k1_checks(res, val, std, exposures, icrf8, diff8, icrf12, diff12
              ) -> dict:
    """Phase 3: K1 against its plain version at config-2 size through
    ``merge_hdr`` and ``merge_batch``, and on each route and instance of
    its planner (``hdr_cuda.plan_fused``): the quad walk at 3, 6 and 12
    exposures (instances 4, 8 and 16) and the scalar route of a 37 x 53
    crop, of 18 exposures and of a stack 4 bytes off alignment; f32, u8
    and i32 stacks, 256 and 4096 entries, both compat modes, with and
    without std, 1, 3 and 4 channels, B = 2 with a plane of a multiple of
    4 elements and a ragged one.  The offset stack holds the same values
    as the aligned one, so the two routes must give the same bits.
    Returns each case's route."""
    from camera_linearity_tpu_torch.ops import hdr, hdr_cuda
    routes = {}

    def check(label, route, v, s, ex, tab, dtab, compat="corrected",
              merge=hdr_cuda.merge_nhwc_fused):
        got_route = hdr_cuda.fused_launch_plan(v, s, tab.shape[0]).route
        routes[label] = got_route
        if got_route != route:
            raise AssertionError(f"phase 3, {label}: K1 took the {got_route}"
                                 f" route, expected {route}")
        got = merge(v, s, ex, tab, dtab, compat)
        res.check("merge_nhwc_fused", f"{label} [{got_route}]", got,
                  hdr_cuda.merge_fused_plain(v, s, ex, tab, dtab, compat))
        return got

    log("K1 merge_nhwc_fused vs merge_fused_plain (config 2), every route "
        "and instance")
    for compat in ("corrected", "reference"):
        for s in (std, None):
            check(f"merge_hdr {compat}, std={s is not None}", "quad/8", val,
                  s, exposures, icrf8, diff8, compat, hdr.merge_hdr)
            check(f"4096-entry exact tables, {compat}, std={s is not None}",
                  "quad/8", val, s, exposures, icrf12, diff12, compat,
                  hdr.merge_hdr)
    for dtype, name in ((torch.uint8, "uint8"), (torch.int32, "int32")):
        dn = torch.round(val * 255).to(dtype)
        check(f"{name} DNs", "quad/8", dn, std, exposures, icrf8, diff8)
        check(f"{name} DNs, 4096-entry tables", "quad/8", dn, std,
              exposures, icrf12, diff12)
    dn = torch.round(val * 4095).to(torch.int32)
    check("int32 12-bit DNs, 4096-entry tables", "quad/8", dn, std,
          exposures, icrf12, diff12)
    del dn
    quad = check("config 2, f32, std", "quad/8", val, std, exposures, icrf8,
                 diff8, "reference")
    sv, ss = (x.new_empty(x.numel() + 1)[1:].view_as(x).copy_(x)
              for x in (val, std))
    scalar = check("stack 4 bytes off alignment", "scalar", sv, ss,
                   exposures, icrf8, diff8, "reference")
    same = all(torch.equal(a, b) for a, b in zip(quad, scalar))
    log(f"  quad walk and scalar route equal bit for bit: {same}")
    if not same:
        raise AssertionError("phase 3: K1's routes differ on the same values")
    del sv, ss, quad, scalar
    check("N = 3 (config 5's count)", "quad/4", val[:3], std[:3],
          exposures[:3], icrf8, diff8)
    check("N = 3, uint8 DNs, value only", "quad/4",
          torch.round(val[:3] * 255).to(torch.uint8), None, exposures[:3],
          icrf8, diff8)
    v12, s12 = (torch.cat([x, x.flip(1)]) for x in (val, std))
    ex12 = torch.cat([exposures, exposures * 1.5])
    check("N = 12", "quad/16", v12, s12, ex12, icrf8, diff8)
    check("N = 12, 4096-entry tables, reference", "quad/16", v12, s12, ex12,
          icrf12, diff12, "reference")
    v18, s18 = (torch.cat([x, x[:6].flip(2)]) for x in (v12, s12))
    ex18 = torch.cat([ex12, exposures * 3.0])
    check("N = 18", "scalar", v18, s18, ex18, icrf8, diff8)
    del v12, s12, v18, s18
    cv, cs = (x[:, :37, :53].contiguous() for x in (val, std))
    for compat in ("corrected", "reference"):
        check(f"37 x 53 crop, {compat}", "scalar", cv, cs, exposures, icrf8,
              diff8, compat)
    check("37 x 53 crop, 4096-entry tables, value only", "scalar", cv, None,
          exposures, icrf12, diff12)
    check("merge_batch B = 2, 37 x 53 crops", "scalar",
          torch.stack([cv, cv.flip(1)]), torch.stack([cs, cs.flip(1)]),
          exposures, icrf8, diff8,
          merge=lambda v, s, ex, tab, dtab, compat:
          hdr.merge_batch(v, s, ex, tab, dtab, compat))
    del cv, cs
    bv, bs = torch.stack([val, val.flip(1)]), torch.stack([std, std.flip(1)])
    check("merge_batch B = 2", "quad/8", bv, bs, exposures, icrf8, diff8,
          merge=lambda v, s, ex, tab, dtab, compat:
          hdr.merge_batch(v, s, ex, tab, dtab, compat))
    del bv, bs
    v1, s1 = (x[..., :1].contiguous() for x in (val, std))
    check("C = 1", "quad/8", v1, s1, exposures, icrf8[:, :1].contiguous(),
          diff8[:, :1].contiguous())
    v4, s4 = (torch.cat([x, x[..., :1]], dim=-1) for x in (val, std))
    for tab, dtab, rows in ((icrf8, diff8, 256), (icrf12, diff12, 4096)):
        check(f"C = 4, {rows}-entry tables", "quad/8", v4, s4, exposures,
              torch.cat([tab, tab[:, :1]], dim=1),
              torch.cat([dtab, dtab[:, :1]], dim=1))
    del v1, s1, v4, s4
    torch.cuda.synchronize()
    return routes


def ptxas_entries(text: str) -> dict:
    """Registers and spill bytes of each kernel entry in a ``ptxas -v``
    log, by entry name (demangled where ``c++filt`` is there)."""
    import re
    import shutil
    entries, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            entries[name] = {}
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            entries[name]["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            entries[name]["registers"] = int(m.group(1))
    if entries and shutil.which("c++filt"):
        out = subprocess.run(["c++filt"], input="\n".join(entries),
                             capture_output=True, text=True, timeout=60)
        names = out.stdout.splitlines()
        if out.returncode == 0 and len(names) == len(entries):
            entries = dict(zip(names, entries.values()))
    return entries


def time_k1_batch(dev, bv, bs, ex, ic, icd) -> dict:
    """K1 on config 5's (B, N, H, W, C) batch: kernel, plain version (one
    call per scene, the whole batch's intermediates would not fit beside
    it), and a device-to-device ``copy_`` moving the same bytes."""
    from camera_linearity_tpu_torch.ops import hdr_cuda
    b = bv.shape[0]
    nbytes = 2 * bv.numel() * 4 + 2 * (bv.numel() // bv.shape[1]) * 4
    src = torch.empty(nbytes // 8, dtype=torch.float32, device=dev)
    dst = torch.empty_like(src)

    def kernel():
        hdr_cuda.merge_nhwc_fused(bv, bs, ex, ic, icd)

    def plain():
        for s in range(b):
            hdr_cuda.merge_fused_plain(bv[s], bs[s], ex, ic, icd)

    def copy():
        dst.copy_(src)
    k_s, p_s, c_s = [], [], []
    for fn, out in ((plain, p_s), (copy, c_s), (kernel, k_s), (kernel, k_s),
                    (copy, c_s), (plain, p_s)):
        out += time_samples(fn, runs=3 if fn is plain else 10,
                            reps=1 if fn is plain else 5,
                            warmup=1 if fn is plain else 3)
    del src, dst
    k_ms, p_ms, c_ms = (float(np.median(x)) for x in (k_s, p_s, c_s))
    bound = nbytes / PEAK_BYTES_S * 1e3
    route = hdr_cuda.fused_launch_plan(bv, bs, ic.shape[0]).route
    log(f"  K1 at B = {b} ({route}): kernel {k_ms:.4f} ms "
        f"({nbytes / k_ms / 1e6:.1f} "
        f"GB/s of {nbytes / 1e9:.3f} GB), bound {bound:.4f} ms "
        f"({bound / k_ms * 100:.1f} % of it), copy {c_ms:.4f} ms, plain "
        f"{p_ms:.4f} ms ({b} scene-sized calls); kernel samples "
        f"{min(k_s):.4f}-{max(k_s):.4f} ms")
    return dict(ms=k_ms, plain_ms=p_ms, copy_ms=c_ms, bytes=nbytes,
                bound_ms=bound, share=bound / k_ms, plan_route=route)


# K1's design choices, each as text edits (old, new) of csrc/hdr_merge.cu
_PREFETCH = """    {  // the next unit's lines stream into L2 meanwhile
      int nb = b, nu = u;
      advance(nb, nu, stride, units);
      if (nb < a.B) {
        const long long next = nb * scene + V * nu;
#pragma unroll
        for (int n = 0; n < MAXN; ++n) {
          if (n < a.N) {
            asm volatile("prefetch.global.L2 [%0];"
                         :: "l"(val + next + (long long)n * a.plane));
            if (STD)
              asm volatile("prefetch.global.L2 [%0];"
                           :: "l"(a.std + next + (long long)n * a.plane));
          }
        }
      }
    }
"""
_BASE = "    int base[V];  // each lane's table entries: channel * rows\n"
_HALF_QUAD = "  static constexpr int V = MAXN > 8 ? 2 : 4;"
K1_VARIANTS = {
    "whole quad at MAXN 16, one block an SM": [
        (_HALF_QUAD, "  static constexpr int V = 4;"),
        ("__launch_bounds__(kMaxThreads, 2)\nquad_kernel",
         "__launch_bounds__(kMaxThreads, MAXN > 8 ? 1 : 2)\nquad_kernel")],
    "whole quad at MAXN 16, 128 registers": [
        (_HALF_QUAD, "  static constexpr int V = 4;")],
    "L2 prefetch of the next unit": [(_BASE, _PREFETCH + _BASE)],
    "idx and dw recomputed in pass 2": [
        ("""          quantize(x[n][k], a, xf, idx[n]);
          const float d = xf - 0.5f;
          w[n] = weight(d);
          if (STD) dw[n] = weight_slope(d, w[n]);""",
         """          quantize(x[n][k], a, xf, idx[n]);
          w[n] = weight(xf - 0.5f);"""),
        ("""          float g, fp;
          lookup<STD>(smem, base[k], idx[n], g, fp);
          accumulate<STD>(w[n], STD ? dw[n] : 0.0f, g, fp,""",
         """          float g, fp, xf;
          quantize(x[n][k], a, xf, idx[n]);
          lookup<STD>(smem, base[k], idx[n], g, fp);
          accumulate<STD>(w[n], STD ? weight_slope(xf - 0.5f, w[n]) : 0.0f,
                          g, fp,""")],
    "cached loads and stores (no streaming hint)": [
        ("__ldcs(reinterpret_cast<const typename Vec<TV, V>::T*>(p))",
         "__ldg(reinterpret_cast<const typename Vec<TV, V>::T*>(p))"),
        ("__stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], "
         "v[3]));", "*reinterpret_cast<float4*>(p) = "
         "make_float4(v[0], v[1], v[2], v[3]);"),
        ("__stcs(reinterpret_cast<float2*>(p), make_float2(v[0], v[1]));",
         "*reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);")],
    "multiply-adds contracted": [
        ("namespace {\n", "namespace {\n"
         "__device__ __forceinline__ float mul_(float a, float b) "
         "{ return a * b; }\n"
         "__device__ __forceinline__ float add_(float a, float b) "
         "{ return a + b; }\n"
         "__device__ __forceinline__ float sub_(float a, float b) "
         "{ return a - b; }\n"),
        ("__fmul_rn(", "mul_("), ("__fadd_rn(", "add_("),
        ("__fsub_rn(", "sub_(")],
}


def k1_variant_phase(dev, val, std, ex, tables) -> dict:
    """Phase 19: builds every entry of ``K1_VARIANTS`` beside
    ``csrc/hdr_merge.cu`` as it is (one ``nvcc`` each, all at once), holds
    each against the plain version, and times each through
    ``merge_nhwc_fused`` (its library swapped in) in turns, twice, beside a
    ``copy_`` of the same bytes, on config 2's stacks ``val`` and ``std``
    with ``tables`` (icrf8, diff8, icrf12, diff12), on 12 exposures of them
    and on a random config-5 batch; logs each variant's registers and
    spills.  Returns each case's times by variant."""
    import ctypes
    from concurrent.futures import ThreadPoolExecutor
    from camera_linearity_tpu_torch import csrc
    from camera_linearity_tpu_torch.ops import hdr_cuda
    t_phase = time.perf_counter()
    icrf8, diff8, icrf12, diff12 = tables
    log(f"phase 19: K1's design choices, {len(K1_VARIANTS)} variants of "
        "hdr_merge.cu")
    source = (Path(csrc.__file__).parent / "hdr_merge.cu").read_text()
    texts = {"as it is": source}
    for name, edits in K1_VARIANTS.items():
        text = source
        for old, new in edits:
            if text.count(old) < 1:
                raise AssertionError(f"variant {name!r}: {old[:60]!r} not "
                                     "found in hdr_merge.cu")
            text = text.replace(old, new)
        texts[name] = text
    root = Path(__file__).resolve().parent / "build" / "k1_variants"
    root.mkdir(parents=True, exist_ok=True)

    def build(item):
        i, (name, text) = item
        src, lib = root / f"v{i}.cu", root / f"libv{i}.so"
        src.write_text(text)
        out = subprocess.run([csrc._nvcc(), *csrc.NVCC_FLAGS, "-o", str(lib),
                              str(src)], capture_output=True, text=True)
        if out.returncode != 0:
            raise RuntimeError(f"{name}: nvcc failed\n{out.stderr}")
        return name, csrc._declare(ctypes.CDLL(str(lib))), out.stderr
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(texts)) as pool:
        built = list(pool.map(build, enumerate(texts.items())))
    log(f"  built {len(built)} K1 variants in "
        f"{time.perf_counter() - t0:.1f} s")
    libs = {name: lib for name, lib, _ in built}
    for name, _, ptxas in built:
        entries = ptxas_entries(ptxas)
        log(f"  {name}: " + "; ".join(
            f"{e.split('quad_kernel')[-1].split('(')[0]} "
            f"{v.get('registers')} regs {v.get('spill_bytes')} B spills"
            for e, v in entries.items()
            if "quad_kernel<float" in e or "quad_kernelIf" in e))

    g = torch.Generator(device=dev).manual_seed(SEED)
    b5 = torch.rand((SCENES5, 3, H5, W5, 3), device=dev, generator=g)
    s5 = torch.rand(b5.shape, device=dev, generator=g) * 0.02 + 0.001
    ex5 = torch.as_tensor(np.array(EXPOSURES5_MS, np.float32) / 1000,
                          device=dev)
    cases = {
        "config 2, 8-bit": (val, std, ex, icrf8, diff8),
        "config 2, 4096 entries": (val, std, ex, icrf12, diff12),
        "N = 12": (torch.cat([val, val.flip(1)]),
                   torch.cat([std, std.flip(1)]),
                   torch.cat([ex, ex * 1.5]), icrf8, diff8),
        "config 5, B = 8": (b5, s5, ex5, icrf8, diff8),
    }
    saved = csrc._libs.get("hdr_merge")
    results = {}
    try:
        for label, args in cases.items():
            v, s = args[:2]
            n = v.shape[-4]
            nbytes = (2 * n + 2) * (v.numel() // n) * 4
            src = torch.empty(nbytes // 8, dtype=torch.float32, device=dev)
            dst = torch.empty_like(src)
            # a batch is held to the plain version on its first scene
            want = hdr_cuda.merge_fused_plain(v[0] if v.ndim == 5 else v,
                                              s[0] if v.ndim == 5 else s,
                                              *args[2:])

            def run(lib, args=args):
                csrc._libs["hdr_merge"] = lib
                return hdr_cuda.merge_nhwc_fused(*args)
            for name, lib in libs.items():
                got = [x[0] if v.ndim == 5 else x for x in run(lib)]
                torch.testing.assert_close(got[0], want[0], **VAL_TOL)
                torch.testing.assert_close(got[1], want[1], **STD_TOL)
            runs = {name: (lambda lib=lib: run(lib))
                    for name, lib in libs.items()}
            runs["copy_"] = lambda: dst.copy_(src)
            times = {name: [] for name in runs}
            for name in [*runs, *reversed(runs)]:
                times[name].append(float(np.median(time_samples(
                    runs[name], runs=5, reps=5 if v.ndim == 5 else 10))))
            del src, dst, want
            bound = nbytes / PEAK_BYTES_S * 1e3
            route = hdr_cuda.fused_launch_plan(v, s, args[3].shape[0]).route
            results[label] = dict(bound_ms=bound, plan_route=route, ms=times)
            log(f"  {label} ({route}; bound {bound:.4f} ms): " + ", ".join(
                f"{k} {'/'.join(f'{t:.4f}' for t in ts)}"
                for k, ts in times.items()))
    finally:
        if saved is None:
            csrc._libs.pop("hdr_merge", None)
        else:
            csrc._libs["hdr_merge"] = saved
    del cases, b5, s5
    torch.cuda.empty_cache()
    log(f"  phase 19: {time.perf_counter() - t_phase:.1f} s")
    return results


def free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def distributed_phase(dev, res, directory, config5, vals_np, stds_np, t_np,
                      tables, config4) -> dict:
    """Phase 20: the multi-process layer (``parallel/``) on the card.

    Its videos are the first PHASE20_FRAMES frames of config 5's I420
    ones (``phase20 <name>``, read by the rawvideo reader), and its
    reference phase 14's path, the single-process ``batch_video_to_hdr``
    (f32/f32), run on them before the world starts.  (a) An NCCL world of one, in this process:
    ``batch_video_to_hdr_distributed`` on config 5's 8 scenes with the
    calibration leg, held to that reference, then the reference's call
    timed again in the same world; ``merge_batch_sharded`` of config 3's
    stack
    with base curves (K2), held to its plain version; the sharded
    statistics on config 2's planes, held to ``ops/stats.py``; the
    population-sharded config-4 solve, held to phase 10's.  (b) Two
    processes sharing the one card over gloo (this script run again with
    ``--phase20-worker``), each decoding and merging 4 scenes, held to (a).
    Returns each path's kernel launches."""
    from camera_linearity_tpu_torch import CameraConfig
    from camera_linearity_tpu_torch.models import calibration as cal
    from camera_linearity_tpu_torch.models import pipeline
    from camera_linearity_tpu_torch.ops import hdr_cuda, stats
    from camera_linearity_tpu_torch.ops.uncertainty import scale_difference
    from camera_linearity_tpu_torch.parallel import distributed as pdist
    from camera_linearity_tpu_torch.parallel import mesh as pmesh
    from camera_linearity_tpu_torch.parallel import sharded
    from camera_linearity_tpu_torch.utils import observability as obs
    from camera_linearity_tpu_torch.utils.checkpoint import (load_pytree,
                                                             save_pytree)
    from camera_linearity_tpu_torch.utils.state import (
        channel_stacks_from_numpy, pca_from_numpy)

    from camera_linearity_tpu_torch.utils import avi
    t_phase = time.perf_counter()
    log("phase 20 (a): an NCCL world of one: batch_video_to_hdr_distributed "
        f"on {SCENES5} scenes with the calibration leg ({PHASE20_FRAMES} "
        "frames a video), merge_batch_sharded with base curves, the sharded "
        "statistics, the population-sharded config-4 solve")
    spec, icrf = config5["spec"], config5["icrf"]
    # the first PHASE20_FRAMES frames of each I420 video
    from tests._torch_rawvideo_writer import write_raw_avi
    paths = []
    for src in config5["i420_paths"]:
        paths.append(directory / f"phase20 {src.name}")
        write_raw_avi(paths[-1], [bytes(c) for _, c in zip(
            range(PHASE20_FRAMES), avi.raw_chunks(src, avi.probe_avi(src)))],
            H5, W5, "I420")
    scene_map = {f"scene{i}": paths for i in range(SCENES5)}
    n_frames = PHASE20_FRAMES * len(paths) * SCENES5
    failures = []
    # the reference: phase 14's single-process path on these videos
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = pipeline.batch_video_to_hdr(scene_map, icrf, calibrate=spec)
    torch.cuda.synchronize()
    f32 = dict(wall=time.perf_counter() - t0, out={
        k: (v.measurand.val, v.measurand.std) for k, v in ref.items()})
    f32["mps"] = n_frames * H5 * W5 / 1e6 / f32["wall"]
    del ref
    log(f"  the reference: batch_video_to_hdr (f32/f32) outside the world "
        f"on the first {PHASE20_FRAMES} frames of config 5's I420 videos, "
        f"{f32['wall']:.3f} s")

    # --- (a) an NCCL world of one -----------------------------------------
    pdist.initialize(f"localhost:{free_port()}", 1, 0, timeout_s=120)
    try:
        mesh = pdist.scene_mesh()
        if list(mesh.shape) != [1, 1] or \
                torch.distributed.get_backend() != "nccl" or \
                pmesh.mesh_device(mesh).type != "cuda":
            raise AssertionError(f"phase 20 (a): mesh {mesh}, backend "
                                 f"{torch.distributed.get_backend()}")
        for k in hdr_cuda.KERNELS:
            k.launches = 0
        obs.reset_stage_times()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = pipeline.batch_video_to_hdr_distributed(scene_map, icrf,
                                                      calibrate=spec)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {k.__name__: k.launches for k in hdr_cuda.KERNELS}
        stages = obs.snapshot_stage_times()
        # phase 14's single-process call, in the same world and after the
        # distributed one: both run beside the process group's threads
        obs.reset_stage_times()
        t0 = time.perf_counter()
        plain_out = pipeline.batch_video_to_hdr(scene_map, icrf,
                                                calibrate=spec)
        torch.cuda.synchronize()
        wall_plain = time.perf_counter() - t0
        stages_plain = obs.snapshot_stage_times()
        for name, got in plain_out.items():
            want_v, want_s = f32["out"][name]
            if not (torch.allclose(got.measurand.val, want_v, **VAL_TOL) and
                    torch.allclose(got.measurand.std, want_s, **STD_TOL)):
                failures.append(f"{name}: batch_video_to_hdr in the world "
                                "against the single-process call outside")
        del plain_out
        # config 3's stack as a batch of one with 256-point base curves
        icrf12, diff12, base, diff_base = tables
        bv, bs = (torch.as_tensor(a[None], device=dev)
                  for a in (vals_np, stds_np))
        ex = torch.as_tensor(t_np, device=dev)
        for k in hdr_cuda.KERNELS:
            k.launches = 0
        got = sharded.merge_batch_sharded(
            bv, bs, ex, icrf12, diff12, mesh, icrf_base=base,
            icrf_diff_base=diff_base)
        torch.cuda.synchronize()
        base_counts = {k.__name__: k.launches for k in hdr_cuda.KERNELS}
        res.check("merge_nhwc_lerp", "merge_batch_sharded, config 3 tables "
                  "with base curves, vs merge_lerp_plain",
                  (got[0][0], got[1][0]),
                  hdr_cuda.merge_lerp_plain(bv[0], bs[0], ex, base,
                                            diff_base, 4096))
        del bv, bs, got
        mps = n_frames * H5 * W5 / 1e6 / wall
        log(f"  wall {wall:.3f} s, {mps:.2f} MP/s; the single-process "
            f"call outside the world: {f32['wall']:.3f} s, "
            f"{f32['mps']:.2f} MP/s (host clock, one call each)")
        log(f"  stages: {stages}")
        log(f"  batch_video_to_hdr (phase 14's path) in the same world, "
            f"after it: wall {wall_plain:.3f} s, "
            f"{n_frames * H5 * W5 / 1e6 / wall_plain:.2f} MP/s (host "
            f"clock); stages {stages_plain}")
        log(f"  launches: batch_video_to_hdr_distributed {counts}, "
            f"merge_batch_sharded with base curves {base_counts}")
        if counts != {"merge_nhwc_fused": 1, "merge_nhwc_lerp": 0,
                      "merge_nhwc_lerp_bp": 0}:
            failures.append(f"launches {counts}")
        if base_counts != {"merge_nhwc_fused": 0, "merge_nhwc_lerp": 1,
                           "merge_nhwc_lerp_bp": 0}:
            failures.append(f"launches with base curves {base_counts}")
        if list(out) != list(scene_map):
            failures.append(f"scenes {list(out)}")
        gaps = [0.0, 0.0]
        for name, got in out.items():
            want_v, want_s = f32["out"][name]
            for i, (g, w, tol) in enumerate((
                    (got.measurand.val, want_v, VAL_TOL),
                    (got.measurand.std, want_s, STD_TOL))):
                if tuple(g.shape) != (H5, W5, 3) or not g.is_cuda or \
                        not torch.isfinite(g).all():
                    failures.append(f"{name}: shape, device or values")
                    continue
                gaps[i] = max(gaps[i], (g - w).abs().max().item())
                if not torch.allclose(g, w, **tol):
                    failures.append(f"{name} against the single-process "
                                    "call")
        log(f"  {'ok ' if not failures else 'BAD'} {SCENES5} scenes against "
            f"the single-process call (phase 14's path, f32/f32): largest "
            f"gap {gaps[0]:.3e} (value), {gaps[1]:.3e} (std)")
        a_out = {k: (v.measurand.val, v.measurand.std) for k, v in
                 out.items()}
        del out

        # the statistics of config 2's first exposure, and the pair (0, 1)
        ratio = float(t_np[0] / t_np[1])
        planes = [torch.as_tensor(a, device=dev) for a in (
            vals_np[0], stds_np[0], vals_np[1], stds_np[1])]
        got = sharded.dimension_statistics_sharded(planes[0], planes[1],
                                                   mesh)
        want = stats.dimension_statistics(planes[0], planes[1], axis=(0, 1))
        for k in ("mean", "std", "error"):
            compare(f"dimension_statistics_sharded {k}", got[k], want[k],
                    dict(rtol=1e-5, atol=0.0), failures)
        pair = sharded.pair_stats_sharded(planes[0], planes[2], planes[1],
                                          planes[3], ratio, mesh)
        (av, astd), (rv, rstd) = scale_difference(
            planes[0], planes[1], planes[2], planes[3], ratio)
        for label, g, (v, s_) in (("absolute", pair[0], (av, astd)),
                                  ("relative", pair[1], (rv, rstd))):
            # the sharded statistics (as JAX's) leave out every element
            # whose value or std is not finite (a relative difference over
            # a zero DN), where dimension_statistics keeps an infinite std
            # in ``error``; NaN, the reference's mask, leaves them out there
            keep = torch.isfinite(v) & torch.isfinite(s_)
            v, s_ = (torch.where(keep, x, torch.nan) for x in (v, s_))
            w = stats.dimension_statistics(v, s_, axis=(0, 1))
            for k in ("mean", "std", "error"):
                compare(f"pair_stats_sharded {label} {k}", g[k], w[k],
                        dict(rtol=1e-5, atol=0.0), failures)
        a_stats = {k: v.cpu() for k, v in got.items()}

        # the config-4 solve with its population over the mesh
        stacks, exposures, mean4, pca4 = config4_problem()
        pca_t, mean_t = pca_from_numpy(np.stack([pca4] * 3),
                                       np.stack([mean4] * 3), device=dev)
        t0 = time.perf_counter()
        icrf4, _, e4, _ = cal.calibration(
            -1.0, 1.0, channel_stacks=channel_stacks_from_numpy(
                stacks, None, exposures, device=dev),
            pca_arrays=pca_t, mean_icrf_arrays=mean_t,
            config=CameraConfig(num_of_chs=3, datapoints=256), popsize=15,
            maxiter=1000, tol=0.01, rng_seed=7, mesh=pmesh.make_mesh(),
            pop_axis="data")
        log(f"  sharded config-4 solve (S = 75 on 1 process): "
            f"{time.perf_counter() - t0:.4f} s host clock; final energies "
            f"{e4.tolist()}")
        compare("sharded config-4 final energies vs phase 10",
                torch.as_tensor(e4), torch.as_tensor(config4[1]),
                dict(rtol=1e-5, atol=0.0), failures)
        compare("sharded config-4 ICRF vs phase 10", torch.as_tensor(icrf4),
                torch.as_tensor(config4[0]), dict(rtol=0.0, atol=1e-5),
                failures)
    finally:
        pdist.shutdown()
    raise_failures("phase 20 (a)", failures)

    # --- (b) two processes sharing the one card over gloo -----------------
    log("phase 20 (b): two processes on the one card over gloo, 4 scenes "
        "each (a check of the multi-process path, not a multi-GPU speed)")
    torch.cuda.empty_cache()  # the workers share the card
    save_pytree(directory / "phase20_inputs.pt", {
        "paths": [str(p) for p in paths], "icrf": icrf, "spec": spec,
        "planes": [vals_np[0], stds_np[0]]})
    port = str(free_port())
    logs = [open(directory / f"phase20_{r}.log", "w+") for r in range(2)]
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()),
                               "--phase20-worker", str(r), port,
                               str(directory)], stdout=logs[r],
                              stderr=subprocess.STDOUT) for r in range(2)]
    try:
        rcs = [p.wait(timeout=PHASE20_WORKER_TIMEOUT_S) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.seek(0)
        texts = [f.read() for f in logs]
        for f in logs:
            f.close()
    wall_b = time.perf_counter() - t0
    for r, text in enumerate(texts):
        for line in text.strip().splitlines()[-6:]:
            log(f"  [process {r}] {line}")
    if any(p.returncode != 0 for p in procs):
        raise AssertionError(f"phase 20 (b): worker exit codes "
                             f"{[p.returncode for p in procs]}")
    results = [load_pytree(directory / f"phase20_{r}.pt") for r in range(2)]
    log(f"  both processes: {wall_b:.3f} s wall from launch to exit "
        "(host clock; two processes sharing one card, NOT a multi-GPU "
        "speed)")
    names = list(scene_map)
    gaps = [0.0, 0.0]
    b_launches = {k.__name__: 0 for k in hdr_cuda.KERNELS}
    for r, res_b in enumerate(results):
        log(f"  process {r}: scenes {res_b['names']}, batch_video_to_hdr "
            f"{res_b['wall']:.3f} s ({res_b['mps']:.2f} MP/s of its own "
            f"frames), launches {res_b['launches']}, stages "
            f"{res_b['stages']}")
        if res_b["names"] != names[4 * r:4 * r + 4]:
            failures.append(f"process {r} scenes {res_b['names']}")
        if res_b["launches"] != {"merge_nhwc_fused": 1,
                                 "merge_nhwc_lerp": 0,
                                 "merge_nhwc_lerp_bp": 0}:
            failures.append(f"process {r} launches {res_b['launches']}")
        for k, n in res_b["launches"].items():
            b_launches[k] += n
        for i, name in enumerate(res_b["names"]):
            for j, (g, tol) in enumerate(((res_b["val"][i], VAL_TOL),
                                          (res_b["std"][i], STD_TOL))):
                w = a_out[name][j].cpu()
                gaps[j] = max(gaps[j], (g - w).abs().max().item())
                if not torch.allclose(g, w, **tol):
                    failures.append(f"process {r} {name} against (a)")
        for k in ("mean", "std", "error"):
            compare(f"process {r} statistics {k} (rows over 2) vs (a)",
                    res_b["stats"][k], a_stats[k],
                    dict(rtol=1e-5, atol=0.0), failures)
    log(f"  {SCENES5} scenes against (a): largest gap {gaps[0]:.3e} "
        f"(value), {gaps[1]:.3e} (std)")
    first, second = results
    for key in ("stats", "solve"):
        same = all(torch.equal(torch.as_tensor(x), torch.as_tensor(y))
                   for x, y in zip(
                       (first[key][k] for k in sorted(first[key])),
                       (second[key][k] for k in sorted(second[key]))))
        log(f"  {'ok ' if same else 'BAD'} the processes' {key} agree bit "
            "for bit")
        if not same:
            failures.append(f"{key} differ between the processes")
    e0, e1 = (np.asarray(first["solve"][k]) for k in ("e0", "e1"))
    log(f"  sharded config-4 solve over 2 processes (S = 76): energies "
        f"{e0.tolist()} -> {e1.tolist()}")
    if not (np.isfinite(np.asarray(first["solve"]["icrf"])).all()
            and np.all(e1 <= e0)):
        failures.append("the 2-process solve")
    raise_failures("phase 20 (b)", failures)
    log(f"  phase 20: {time.perf_counter() - t_phase:.1f} s")
    return {"batch_video_to_hdr_distributed (phase 20 a)": counts,
            "merge_batch_sharded with base curves (phase 20 a)": base_counts,
            "distributed, 2 processes on one card (phase 20 b)": b_launches}


def phase20_worker(rank: int, port: str, directory: str) -> int:
    """One process of phase 20 (b): joins a gloo world of two on cuda:0,
    runs ``batch_video_to_hdr`` (which takes the distributed path) on its 4
    of the 8 scenes with the calibration leg, the sharded statistics with
    the rows of config 2's first exposure split over the two processes, and
    the config-4 solve with its population split over them; saves what it
    got for the parent."""
    from camera_linearity_tpu_torch import CameraConfig
    from camera_linearity_tpu_torch.models import calibration as cal
    from camera_linearity_tpu_torch.models import pipeline
    from camera_linearity_tpu_torch.ops import hdr_cuda
    from camera_linearity_tpu_torch.parallel import distributed as pdist
    from camera_linearity_tpu_torch.parallel import mesh as pmesh
    from camera_linearity_tpu_torch.parallel import sharded
    from camera_linearity_tpu_torch.utils import observability as obs
    from camera_linearity_tpu_torch.utils.checkpoint import (load_pytree,
                                                             save_pytree)
    from camera_linearity_tpu_torch.utils.state import (
        channel_stacks_from_numpy, pca_from_numpy)

    directory = Path(directory)
    x = load_pytree(directory / "phase20_inputs.pt")
    pdist.initialize(f"localhost:{port}", 2, rank, backend="gloo",
                     timeout_s=PHASE20_WORKER_TIMEOUT_S)
    try:
        if pdist.process_count() != 2 or torch.cuda.current_device() != 0:
            raise AssertionError("not a world of two on cuda:0")
        paths = [Path(p) for p in x["paths"]]
        scene_map = {f"scene{i}": paths for i in range(SCENES5)}
        for k in hdr_cuda.KERNELS:
            k.launches = 0
        obs.reset_stage_times()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = pipeline.batch_video_to_hdr(scene_map, x["icrf"],
                                          calibrate=x["spec"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k.__name__: k.launches for k in hdr_cuda.KERNELS}
        stages = obs.snapshot_stage_times()
        frames = PHASE20_FRAMES * len(paths) * len(out)
        log(f"batch_video_to_hdr: {list(out)} in {wall:.3f} s, launches "
            f"{launches}")

        rows = pmesh.data_pixel_mesh()
        band = pmesh.block_of(H, rows, "pixel", "rows")
        val, std = (torch.as_tensor(a[band], device="cuda")
                    for a in x["planes"])
        stats = sharded.dimension_statistics_sharded(val, std, rows)

        stacks, exposures, mean4, pca4 = config4_problem()
        pca_t, mean_t = pca_from_numpy(np.stack([pca4] * 3),
                                       np.stack([mean4] * 3), device="cuda")
        icrf4, e0, e1, _ = cal.calibration(
            -1.0, 1.0, channel_stacks=channel_stacks_from_numpy(
                stacks, None, exposures, device="cuda"),
            pca_arrays=pca_t, mean_icrf_arrays=mean_t,
            config=CameraConfig(num_of_chs=3, datapoints=256), popsize=15,
            maxiter=1000, tol=0.01, rng_seed=7, mesh=pmesh.make_mesh(),
            pop_axis="data")
        log(f"config-4 solve: {e0.tolist()} -> {e1.tolist()}")
        save_pytree(directory / f"phase20_{rank}.pt", {
            "names": list(out), "wall": wall,
            "mps": frames * H5 * W5 / 1e6 / wall, "stages": stages,
            "launches": launches,
            "val": torch.stack([o.measurand.val for o in out.values()]),
            "std": torch.stack([o.measurand.std for o in out.values()]),
            "stats": {k: v for k, v in stats.items()},
            "solve": {"icrf": icrf4, "e0": e0, "e1": e1}})
    finally:
        pdist.shutdown()
    return 0


# the port's examples at a small size: (arguments, a line the output holds)
EXAMPLES = {
    "torch_end_to_end": (["--size", "16", "--maxiter", "60"],
                         "pairwise relative-difference means"),
    "torch_video_pipeline": (["--frames", "6", "--size", "16", "24"],
                             "HDR from video on cuda"),
    "torch_distributed_batch": (["--scenes", "2", "--frames", "3"],
                                "over nccl on cuda"),
}


def examples_phase(directory: Path) -> dict:
    """Phase 21: each of examples/torch_*.py once on the card, as a user
    runs it (a process of its own, the three side by side; the distributed
    one as an NCCL world of one).  Returns each one's wall seconds."""
    log(f"phase 21: the port's examples on the card ({', '.join(EXAMPLES)})")
    from concurrent.futures import ThreadPoolExecutor
    env = {k: v for k, v in os.environ.items() if not k.startswith("CL_")}
    walls, failures = {}, []

    def run(name):
        extra = EXAMPLES[name][0]
        t0 = time.perf_counter()
        out = subprocess.run(
            [sys.executable, str(ROOT / "examples" / f"{name}.py"),
             str(directory / name), "--device", "cuda", *extra],
            cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
        return out, time.perf_counter() - t0
    # side by side: each is mostly its process's start-up
    with ThreadPoolExecutor(len(EXAMPLES)) as ex:
        outs = dict(zip(EXAMPLES, ex.map(run, EXAMPLES)))
    for name, (extra, expect) in EXAMPLES.items():
        out, walls[name] = outs[name]
        ok = out.returncode == 0 and expect in out.stdout
        last = (out.stdout.strip().splitlines() or [""])[-1]
        log(f"  {'ok ' if ok else 'BAD'} {name} {' '.join(extra)}: rc "
            f"{out.returncode}, {walls[name]:.1f} s; {last}")
        if not ok:
            log(out.stderr[-3000:])
            failures.append(name)
    raise_failures("phase 21, the examples", failures)
    return walls


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from camera_linearity_tpu_torch import CameraConfig, csrc
    from camera_linearity_tpu_torch.models.exposure_series import \
        ExposureSeries
    from camera_linearity_tpu_torch.models.image_set import ImageSet
    from camera_linearity_tpu_torch.ops import filters, hdr, hdr_cuda
    from camera_linearity_tpu_torch.utils.state import (
        icrf_tables_from_numpy, measurand_from_numpy)

    # --- phase 1: the card ------------------------------------------------
    t_start = _PHASE[1] = time.perf_counter()
    dev = torch.device("cuda")
    gpu = gpu_line()
    log(gpu)
    log(f"torch {torch.__version__}, cuda {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}, "
        f"count {torch.cuda.device_count()}")
    # phase 12's plain decode of 4K H.264 pictures takes minutes of a core,
    # and its High videos' coding too: they start now, in processes of
    # their own, and phase 12 reads them
    h264_plain4k = H264Plain4K()
    h264_high = H264HighWork()
    # config 5's frames, made on the card now (phase 12 writes its videos
    # from them), and their videos' coding from now on, in a process of
    # its own: phase 12 finds them in their caches
    content = config5_content(dev)
    prework = Config5Prework(content)

    # --- phase 2: build ---------------------------------------------------
    # every source's nvcc starts now; phases 3-6 wait only for the merge
    # sources, the experiments' build goes on beside them (phase 7 waits)
    from concurrent.futures import ThreadPoolExecutor
    t0 = time.perf_counter()
    experiments = [n for n in csrc.SOURCES if n not in csrc.MERGE_SOURCES]
    builder = ThreadPoolExecutor(1, "nvcc")
    exp_build = builder.submit(csrc.build, experiments)
    builder.shutdown(wait=False)
    lib_paths = csrc.build(csrc.MERGE_SOURCES)
    for name in lib_paths:
        csrc.library(name)
    log(f"build: {time.perf_counter() - t0:.1f} s (the merge sources; "
        f"{', '.join(experiments)} build on beside phases 3-6)")
    for name, path in lib_paths.items():
        seconds = csrc.BUILD_SECONDS.get(name)
        log(f"  {name}: {path}, " + ("built already" if seconds is None
                                     else f"nvcc {seconds:.1f} s"))
    if all(name in csrc.BUILD_SECONDS for name in csrc.MERGE_SOURCES):
        log("  a merge kernel's first use builds "
            f"{' + '.join(csrc.MERGE_SOURCES)}: "
            f"{max(csrc.BUILD_SECONDS[n] for n in csrc.MERGE_SOURCES):.1f} s"
            " (the slower nvcc of the two)")

    rng = np.random.default_rng(SEED)
    t_np, vals_np, stds_np, darks_np, flat_np, flat_std_np = make_inputs(rng)
    base_np, diff_base_np, icrf_np, diff_np = make_tables()
    exposures = torch.as_tensor(t_np, device=dev)
    val = torch.as_tensor(vals_np, device=dev)
    std = torch.as_tensor(stds_np, device=dev)
    dark = torch.as_tensor(darks_np, device=dev)
    icrf8, diff8, _, _ = icrf_tables_from_numpy(base_np, diff_base_np,
                                                device=dev)
    icrf12, diff12, base, diff_base = icrf_tables_from_numpy(
        icrf_np, diff_np, base_np, diff_base_np, device=dev)
    thr = torch.tensor(CameraConfig().dark_threshold, dtype=torch.float32)
    res = Results()

    # --- phase 3: K1 against its plain version, on every route -----------
    k1_routes = k1_checks(res, val, std, exposures, icrf8, diff8, icrf12,
                          diff12)

    # --- phase 4: K2 against its plain version, through merge_hdr --------
    log("K2 merge_nhwc_lerp vs merge_lerp_plain (config 3 tables)")
    for compat in ("corrected", "reference"):
        for s in (std, None):
            res.check("merge_nhwc_lerp", f"{compat}, std={s is not None}",
                      hdr.merge_hdr(val, s, exposures, icrf12, diff12,
                                    compat, icrf_base=base,
                                    icrf_diff_base=diff_base),
                      hdr_cuda.merge_lerp_plain(val, s, exposures, base,
                                                diff_base, 4096, compat))
    sv, ss = (x[:, :37, :53].contiguous() for x in (val, std))
    res.check("merge_nhwc_lerp", "37 x 53 crop (copy route)",
              hdr_cuda.merge_nhwc_lerp(sv, ss, exposures, base, diff_base,
                                       4096),
              hdr_cuda.merge_lerp_plain(sv, ss, exposures, base, diff_base,
                                        4096))

    # --- phase 5: K3 against its plain version, through merge_corrected --
    log("K3 merge_nhwc_lerp_bp vs merge_lerp_bp_plain (config 3)")
    mask = filters.hot_pixel_mask(dark, thr)
    log(f"  hot pixels: {mask.float().mean().item() * 100:.3f} %")
    for label, d in (("float darks", dark), ("uint8 mask", mask)):
        res.check("merge_nhwc_lerp_bp", f"{label}, 256-entry tables",
                  hdr.merge_corrected(val, std, d, exposures, icrf8, diff8,
                                      thr),
                  hdr_cuda.merge_lerp_bp_plain(val, std, d, exposures,
                                               icrf8, diff8, thr, 256))
        res.check("merge_nhwc_lerp_bp", f"{label}, 4096-entry tables",
                  hdr.merge_corrected(val, std, d, exposures, icrf12,
                                      diff12, thr, icrf_base=base,
                                      icrf_diff_base=diff_base),
                  hdr_cuda.merge_lerp_bp_plain(val, std, d, exposures, base,
                                               diff_base, thr, 4096))
    sv, ss, sd = (x[:, :37, :53].contiguous() for x in (val, std, dark))
    res.check("merge_nhwc_lerp_bp", "37 x 53 crop (copy route)",
              hdr.merge_corrected(sv, ss, sd, exposures, icrf12, diff12, thr,
                                  icrf_base=base, icrf_diff_base=diff_base),
              hdr_cuda.merge_lerp_bp_plain(sv, ss, sd, exposures, base,
                                           diff_base, thr, 4096))
    del mask
    torch.cuda.synchronize()

    # --- phase 6: the entry points, launch counts reset -------------------
    log("main path: merge_hdr (config 2), merge_hdr with base curves and "
        "process_HDR_image (config 3)")
    cfg = CameraConfig(bit_depth=12, compat_mode="corrected")
    assert min(EXPOSURES_MS) / 1000 >= cfg.dark_threshold

    def series(device, dtype):
        sets = [ImageSet(f"{ms}ms BF sample 50x.tif", config=cfg,
                         device=device,
                         measurand=measurand_from_numpy(
                             vals_np[e], stds_np[e], device=device,
                             dtype=dtype))
                for e, ms in enumerate(EXPOSURES_MS)]
        # 40 ms matches exactly; 80 ms takes the 100 ms dark scaled down;
        # the longer exposures have no dark (no repair), as in the reference
        darks = [ImageSet(f"{ms}ms BF dark 50x.tif", config=cfg,
                          device=device,
                          measurand=measurand_from_numpy(
                              darks_np[e], device=device, dtype=dtype))
                 for e, ms in ((0, 40), (1, 100))]
        flat = ImageSet("BF flat 50x.tif", config=cfg, device=device,
                        measurand=measurand_from_numpy(
                            flat_np, flat_std_np, device=device,
                            dtype=dtype))
        return ExposureSeries(input_image_sets=sets, config=cfg), darks, flat

    gpu_series, gpu_darks, gpu_flat = series(dev, torch.float32)
    for k in hdr_cuda.KERNELS:
        k.launches = 0
    out_k1 = hdr.merge_hdr(val, std, exposures, icrf8, diff8)
    out_k2 = hdr.merge_hdr(val, std, exposures, icrf12, diff12,
                           icrf_base=base, icrf_diff_base=diff_base)
    k3_before = hdr_cuda.merge_nhwc_lerp_bp.launches
    hdr_set = gpu_series.process_HDR_image(
        ICRF=icrf12, ICRF_diff=diff12, ICRF_base=base,
        ICRF_diff_base=diff_base, list_of_dark_fields=gpu_darks,
        flat_field=gpu_flat)
    k3_delta = hdr_cuda.merge_nhwc_lerp_bp.launches - k3_before
    torch.cuda.synchronize()
    launches = {k.__name__: k.launches for k in hdr_cuda.KERNELS}
    log(f"  launches: {launches}")
    if k3_delta != 1:
        raise AssertionError(f"process_HDR_image launched K3 {k3_delta} "
                             "times, expected 1")
    for name, count in launches.items():
        if count < 1:
            raise AssertionError(f"{name} was not launched by the main path")

    res.check(None, "merge_hdr config 2 vs merge_fused_plain", out_k1,
              hdr_cuda.merge_fused_plain(val, std, exposures, icrf8, diff8))
    res.check(None, "merge_hdr base curves vs merge_lerp_plain", out_k2,
              hdr_cuda.merge_lerp_plain(val, std, exposures, base, diff_base,
                                        4096))
    gv, gs = hdr_set.measurand.val, hdr_set.measurand.std
    for name, x in (("val", gv), ("std", gs)):
        if tuple(x.shape) != (H, W, C) or not torch.isfinite(x).all():
            raise AssertionError(f"process_HDR_image {name}: shape "
                                 f"{tuple(x.shape)} or non-finite values")
    t0 = time.perf_counter()
    cpu_series, cpu_darks, cpu_flat = series("cpu", torch.float32)
    c8, cd8, cbase, cdbase = icrf_tables_from_numpy(
        icrf_np, diff_np, base_np, diff_base_np, device="cpu",
        dtype=torch.float32)
    cpu_set = cpu_series.process_HDR_image(
        ICRF=c8, ICRF_diff=cd8, ICRF_base=cbase, ICRF_diff_base=cdbase,
        list_of_dark_fields=cpu_darks, flat_field=cpu_flat)
    log(f"  CPU reference run: {time.perf_counter() - t0:.1f} s")
    res.check(None, "process_HDR_image card vs CPU (f32, plain path)",
              (gv.cpu(), gs.cpu()),
              (cpu_set.measurand.val, cpu_set.measurand.std),
              E2E_VAL_TOL, E2E_STD_TOL)
    del cpu_series, cpu_set, out_k1, out_k2

    # --- phase 7: kernel and plain times ----------------------------------
    # no nvcc beside the timed launches: the experiments' build ends first
    t0 = time.perf_counter()
    exp_paths = exp_build.result()
    log(f"  the experiments' build, begun in phase 2: waited "
        f"{time.perf_counter() - t0:.1f} s for it before the times")
    log("times (median of CUDA-event samples, plain and kernel in turns; "
        "MP/s = H*W per second; GB/s = bytes the merge must move; bound = "
        "those bytes at 3.35 TB/s or its f32 operations at 67 TFLOP/s, the "
        "larger; copy = a device-to-device copy_ moving the same bytes)")
    instances = {}
    for name, path in lib_paths.items():
        log(f"  registers and spills, {name}.cu (ptxas):")
        entries = ptxas_entries((path.parent / "ptxas.log").read_text())
        for entry, info in entries.items():
            log(f"    {info.get('registers')} registers, "
                f"{info.get('spill_bytes')} bytes of spills: {entry}")
        if name == "hdr_merge":
            instances = entries
    plane = H * W * C * 4
    cases = {  # name: (kernel, plain, bytes read and written)
        "merge_nhwc_fused": (
            lambda: hdr_cuda.merge_nhwc_fused(val, std, exposures, icrf8,
                                              diff8),
            lambda: hdr_cuda.merge_fused_plain(val, std, exposures, icrf8,
                                               diff8),
            (2 * N + 2) * plane),
        "merge_nhwc_lerp": (
            lambda: hdr_cuda.merge_nhwc_lerp(val, std, exposures, base,
                                             diff_base, 4096),
            lambda: hdr_cuda.merge_lerp_plain(val, std, exposures, base,
                                              diff_base, 4096),
            (2 * N + 2) * plane),
        "merge_nhwc_lerp_bp": (
            lambda: hdr_cuda.merge_nhwc_lerp_bp(val, std, dark, exposures,
                                                base, diff_base, thr, 4096),
            lambda: hdr_cuda.merge_lerp_bp_plain(val, std, dark, exposures,
                                                 base, diff_base, thr,
                                                 4096),
            (3 * N + 2) * plane),
    }
    times = {}
    for name, (kernel, plain, nbytes) in cases.items():
        # a copy reads and writes its bytes: half the merge's, each way
        src = torch.empty(nbytes // 8, dtype=torch.float32, device=dev)
        dst = torch.empty_like(src)

        def copy():
            dst.copy_(src)
        k_s, p_s, c_s = [], [], []
        for fn, out in ((plain, p_s), (copy, c_s), (kernel, k_s),
                        (kernel, k_s), (copy, c_s), (plain, p_s)):
            out += time_samples(fn, runs=10, reps=2 if fn is plain else 10)
        del src, dst
        k_ms, p_ms, c_ms = (float(np.median(x)) for x in (k_s, p_s, c_s))
        bytes_ms = nbytes / PEAK_BYTES_S * 1e3
        ops_ms = OPS_PER_ELEMENT * N * H * W * C / PEAK_F32_S * 1e3
        bound_ms = max(bytes_ms, ops_ms)
        times[name] = dict(
            ms=k_ms, plain_ms=p_ms, copy_ms=c_ms, bytes=nbytes,
            bound_ms=bound_ms,
            bound_by="bytes" if bytes_ms >= ops_ms else "operations",
            share=bound_ms / k_ms)
        if name == "merge_nhwc_fused":
            times[name]["plan_route"] = hdr_cuda.fused_launch_plan(
                val, std, icrf8.shape[0]).route
            log("  merge_nhwc_fused takes the "
                f"{times[name]['plan_route']} route")
        log(f"  {name}: kernel {k_ms:.4f} ms ({H * W / k_ms / 1e3:.1f} "
            f"MP/s, {nbytes / k_ms / 1e6:.1f} GB/s of {nbytes / 1e6:.0f} "
            f"MB), bound {bound_ms:.4f} ms ({times[name]['bound_by']}; "
            f"{times[name]['share'] * 100:.1f} % of it), copy {c_ms:.4f} ms "
            f"({c_ms / k_ms * 100:.1f} % of the kernel's time), plain "
            f"{p_ms:.4f} ms ({H * W / p_ms / 1e3:.1f} MP/s); kernel samples "
            f"{min(k_s):.4f}-{max(k_s):.4f} ms")

    # end to end: the host clock around process_HDR_image on the card
    def merge_e2e():
        return gpu_series.process_HDR_image(
            ICRF=icrf12, ICRF_diff=diff12, ICRF_base=base,
            ICRF_diff_base=diff_base, list_of_dark_fields=gpu_darks,
            flat_field=gpu_flat)
    e2e_ms = host_ms(merge_e2e)
    log(f"  process_HDR_image (config 3, end to end): {e2e_ms:.4f} ms "
        f"({H * W / e2e_ms / 1e3:.1f} MP/s)")
    profile_breakdown("process_HDR_image (config 3)", merge_e2e,
                      by_kernel=True)
    del gpu_series, gpu_darks, gpu_flat, dark
    torch.cuda.empty_cache()
    for name, path in exp_paths.items():
        seconds = csrc.BUILD_SECONDS.get(name)
        log(f"  {name}: {path}, " + ("built already" if seconds is None
                                     else f"nvcc {seconds:.1f} s"))
        log(f"  registers and spills, {name}.cu (ptxas):")
        for entry, info in ptxas_entries(
                (path.parent / "ptxas.log").read_text()).items():
            log(f"    {info.get('registers')} registers, "
                f"{info.get('spill_bytes')} bytes of spills: {entry}")
    lib_paths.update(exp_paths)
    ablation = ablation_phase(dev, val, std, exposures,
                              times["merge_nhwc_fused"])
    lut = lut_phase(dev, val, std, exposures, (icrf8, diff8, icrf12, diff12),
                    ablation["e2_ms"])
    k1_variants = k1_variant_phase(dev, val, std, exposures,
                                   (icrf8, diff8, icrf12, diff12))
    del val, std
    torch.cuda.empty_cache()

    calibration = linearity_phases(dev, t_np, vals_np, stds_np)
    with tempfile.TemporaryDirectory(prefix="clt_config5_") as tmp:
        config5 = video_phases(dev, res, Path(tmp), h264_plain4k, h264_high,
                               content, prework)
        del content
        h264_high.close()
        files = file_phases(dev, res, config5["paths"], config5["mjpg_paths"],
                            config5.pop("pool"))
        distributed = distributed_phase(
            dev, res, Path(tmp), config5, vals_np, stds_np, t_np,
            (icrf12, diff12, base, diff_base), calibration["config4"])
        example_walls = examples_phase(Path(tmp))

    # every main path's launches: phase 6's, config 5's, the command
    # line's and the multi-process layer's, each counted from zero around
    # its own run
    paths = {"merge_hdr + process_HDR_image (phase 6)": launches,
             **config5["launches"], **files["launches"], **distributed}
    # no single PyTorch call computes the merge: no library yardstick
    kernels = [{"name": name, "route": "cuda", "source": SOURCES[name],
                "replaces": REPLACES[name],
                "launches": sum(p[name] for p in paths.values()),
                "launches_by_path": {k: p[name] for k, p in paths.items()},
                "max_abs_err": res.err[name], **times[name],
                "library_ms": None} for name in REPLACES]
    kernels[0]["config5_B8"] = config5["k1"]
    kernels[0]["routes_checked"] = k1_routes
    kernels[0]["instances"] = instances
    kernels[0]["variants_ms"] = k1_variants
    kernels[2]["config5_video_to_hdr"] = config5["k3"]
    kernels += ablation["kernels"] + lut["kernels"]
    if any(k["route"] not in ("cuda", "triton") for k in kernels):
        raise AssertionError("a kernel's route is neither cuda nor triton")
    log(json.dumps({"welford_ms_per_frame": config5["welford_ms"],
                    "welford_bound_ms": config5["welford_bound_ms"]}))
    log(json.dumps({"config5_mjpg": config5["mjpg"],
                    "host_cpus": os.cpu_count()}))
    log(json.dumps({"files": files["numbers"]}))
    log(json.dumps({"examples_s": example_walls}))
    log(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all")
    walls = close_phase()
    log(json.dumps({"phase_walls_s": {k: round(v, 1) for k, v in
                                      walls.items()}}))
    log(gpu)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--phase20-worker"]:
        sys.exit(phase20_worker(int(sys.argv[2]), sys.argv[3], sys.argv[4]))
    sys.exit(main())
