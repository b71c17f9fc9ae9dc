"""H.264 test streams of the Constrained Baseline, Main and High tools of
I and P slices, and the AVI, MP4 and Matroska files that carry them.

cv2's FFmpeg here has the h264 decoder but no H.264 encoder, so the tests
make their streams here: this module writes the parameter sets and the
slice headers (:class:`Config`, :class:`PicPlan`), keeps the decoded
picture buffer through the port's own stream layer (``h264_plain.Stream``,
which gives each slice its reference list and each picture its frame
slot), and has ``tests/_torch_h264_enc.cpp`` code the slice data with
seeded choices over every tool (:class:`Options`) and reconstruct the
pictures: CAVLC, or CABAC through that file's arithmetic encoder (its own
engine, the decoder's context tables), Intra 4x4 / 8x8 / 16x16, the 4x4
and the forward 8x8 transform, scaling matrices (:class:`Config`'s
``sps_lists`` and ``pps_lists``) and explicit weights
(:class:`PicPlan`'s ``weights``).  :func:`encode` returns the samples (one picture each, as NAL
units), the reconstruction (what a decoder gives, cropped as FFmpeg crops
it) and the counts of what was written (CAVLC codes, macroblock kinds,
QPs, the CABAC contexts coded with: :func:`coverage`).

The writer and the port's decoder share the stream layer and the code
tables, so the tests hold every stream to ``cv2.VideoCapture`` (and to
libavcodec's planes, ``tests/_torch_libavcodec.py``), whose decoder is
FFmpeg's own.
"""
from __future__ import annotations

import ctypes
import re
import struct
import threading
from pathlib import Path
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from camera_linearity_tpu_torch.native import h264_plain as hp

__all__ = ["Options", "Config", "PicPlan", "encode", "annexb", "high_config",
           "high_sink", "high_coverage_plans", "weight_plans",
           "length_prefixed", "avcc", "write_h264_avi", "write_h264_mp4",
           "write_h264_mkv", "coverage", "scene", "native_encoder",
           "i420_planes", "kitchen_sink"]


class Options(NamedTuple):
    """The encoder's choices (per mille where ``p_``): ``part_mask`` the
    inter partitions it may take (bit t: 16x16, 16x8, 8x16, P_8x8,
    P_8x8ref0), ``sub_mask`` the sub-partitions (8x8, 8x4, 4x8, 4x4),
    ``p_dqp`` how often a macroblock takes a QP of [qp_min, qp_max],
    ``search`` the whole-sample search range, ``p_far`` vectors far outside
    the picture, ``p_random_mode`` intra modes at random (else the best),
    ``coverage`` blocks whose levels are set to an unwritten
    (TotalCoeff, TrailingOnes), ``zero_mv`` every vector zero."""
    seed: int = 0
    p_skip: int = 150
    p_intra: int = 60
    p_pcm: int = 5
    p_i16: int = 300
    part_mask: int = 31
    p_dqp: int = 100
    qp_min: int = 16
    qp_max: int = 40
    search: int = 2
    p_far: int = 10
    p_random_mode: int = 300
    coverage: int = 0
    p_subpel: int = 500
    zero_mv: int = 0
    sub_mask: int = 15
    p_i8: int = 400      # Intra NxN macroblocks of the 8x8 transform
    p_t8: int = 500      # inter macroblocks of the 8x8 transform (where allowed)
    qp_step: int = 1     # the QP sweep's step (p_dqp 1000)


class Config(NamedTuple):
    """The SPS and PPS: ``crop`` (left, right, top, bottom) in luma
    samples (even), ``full_range``/``matrix`` the VUI's video signal
    type (``matrix`` None: no colour description), ``reorder`` the VUI's
    max_num_reorder_frames (None: no bitstream_restriction), ``profile``
    and ``constraints`` the SPS's first bytes (66 and 0xC0: Constrained
    Baseline)."""
    height: int
    width: int
    poc_type: int = 0
    log2_max_frame_num: int = 4
    log2_max_poc_lsb: int = 5
    num_ref_frames: int = 4
    crop: Tuple[int, int, int, int] = (0, 0, 0, 0)
    full_range: bool = False
    matrix: Optional[int] = None
    reorder: Optional[int] = 0
    init_qp: int = 26
    cqp: int = 0
    deblock_control: bool = True
    cip: bool = False
    redundant_present: bool = False
    bottom_poc: bool = False
    profile: int = 66
    constraints: int = 0xC0
    level: int = 30
    num_ref_idx: int = 1
    sps_id: int = 0
    pps_id: int = 0
    # what the SPS and PPS write besides (for streams the decoder
    # refuses, and the High profile's fields): ("chroma_format", 2),
    # ("bit_depth", 10), ("bypass", 1), ("frame_mbs_only", 0),
    # ("mbaff", 1); ("slice_groups", 2), ("second_cqp", v) (the PPS's
    # High-profile extension)
    tweaks: Tuple[Tuple[str, int], ...] = ()
    cabac: bool = False
    transform_8x8: bool = False
    weighted: bool = False
    weighted_bipred: int = 0
    # scaling lists (None: no matrix flag; else eight entries for the SPS,
    # six or eight for the PPS, each None (not present), "default"
    # (useDefaultScalingMatrixFlag) or its values in zigzag order, which
    # may stop short: the rest repeat the last)
    sps_lists: Optional[Tuple] = None
    pps_lists: Optional[Tuple] = None


class PicPlan(NamedTuple):
    """One picture: ``kind`` ``"IDR"``, ``"I"`` or ``"P"``; ``ref_idc``
    (0: not a reference); the slice QP; ``slices`` the first macroblock of
    each slice (one slice where empty); ``num_ref`` an override of the
    PPS's reference count; ``modifications`` (idc, value) pairs of the
    reference list modification; ``mmcos`` memory management operations
    as they are coded ((1, difference_of_pic_nums_minus1), (2,
    long_term_pic_num), (3, difference_minus1, long_term_frame_idx), (4,
    max_long_term_frame_idx_plus1), (5,), (6, long_term_frame_idx));
    ``long_term`` an IDR's long_term_reference_flag; the deblocking
    control (``disable``, ``alpha``, ``beta``: the div2 offsets);
    ``opts`` the encoder's choices."""
    kind: str = "P"
    ref_idc: int = 1
    qp: int = 26
    slices: Tuple[int, ...] = ()
    num_ref: Optional[int] = None
    modifications: Tuple[Tuple[int, int], ...] = ()
    mmcos: Optional[Tuple[Tuple[int, ...], ...]] = None
    long_term: bool = False
    disable: int = 0
    alpha: int = 0
    beta: int = 0
    opts: Options = Options()
    redundant: int = 0
    cabac_init_idc: int = 0
    # pred_weight_table where the PPS has weighted_pred_flag: (luma denom,
    # chroma denom, entries): an entry a reference index, (luma, chroma)
    # with luma (weight, offset) or None and chroma (Cb weight, offset,
    # Cr weight, offset) or None (their flags 0); indices past the entries
    # take no weights
    weights: Optional[Tuple] = None


class _Bits:
    def __init__(self):
        self.bits: List[int] = []

    def u(self, v: int, n: int) -> None:
        self.bits.extend((v >> (n - 1 - i)) & 1 for i in range(n))

    def ue(self, v: int) -> None:
        x = v + 1
        n = x.bit_length()
        self.u(0, n - 1)
        self.u(x, n)

    def se(self, v: int) -> None:
        self.ue(2 * v - 1 if v > 0 else -2 * v)

    def raw(self) -> Tuple[bytes, int]:
        n = len(self.bits)
        pad = self.bits + [0] * (-n % 8)
        return bytes(int("".join(map(str, pad[i:i + 8])), 2)
                     for i in range(0, len(pad), 8)), n

    def rbsp(self) -> bytes:
        self.u(1, 1)
        while len(self.bits) % 8:
            self.bits.append(0)
        return self.raw()[0]


def nal(kind: int, ref_idc: int, rbsp: bytes) -> bytes:
    """A NAL unit: its header byte, then ``rbsp`` with emulation
    prevention."""
    body = re.sub(b"\x00\x00(?=[\x00-\x03])", b"\x00\x00\x03", rbsp)
    return bytes([(ref_idc << 5) | kind]) + body


def _sps(c: Config) -> bytes:
    t = dict(c.tweaks)
    b = _Bits()
    b.u(c.profile, 8)
    b.u(c.constraints, 8)
    b.u(c.level, 8)
    b.ue(c.sps_id)
    if c.profile in (100, 110, 122, 244, 44, 83, 86, 118, 128):
        b.ue(t.get("chroma_format", 1))
        if t.get("chroma_format", 1) == 3:
            b.u(0, 1)
        b.ue(t.get("bit_depth", 8) - 8)
        b.ue(t.get("bit_depth", 8) - 8)
        b.u(t.get("bypass", 0), 1)
        b.u(int(c.sps_lists is not None), 1)
        if c.sps_lists is not None:
            _write_lists(b, c.sps_lists)
    b.ue(c.log2_max_frame_num - 4)
    b.ue(c.poc_type)
    if c.poc_type == 0:
        b.ue(c.log2_max_poc_lsb - 4)
    elif c.poc_type == 1:
        b.u(0, 1)          # delta_pic_order_always_zero_flag
        b.se(1)            # offset_for_non_ref_pic
        b.se(0)            # offset_for_top_to_bottom_field
        b.ue(1)
        b.se(2)            # offset_for_ref_frame[0]
    b.ue(c.num_ref_frames)
    b.u(0, 1)
    mbw, mbh = _mbs(c)
    b.ue(mbw - 1)
    b.ue(mbh - 1)
    b.u(t.get("frame_mbs_only", 1), 1)
    if not t.get("frame_mbs_only", 1):
        b.u(t.get("mbaff", 0), 1)     # mb_adaptive_frame_field_flag
    b.u(1, 1)              # direct_8x8_inference_flag
    if any(c.crop):
        b.u(1, 1)
        for v in c.crop:
            b.ue(v // 2)
    else:
        b.u(0, 1)
    vui = c.full_range or c.matrix is not None or c.reorder is not None
    b.u(int(vui), 1)
    if vui:
        b.u(0, 1)          # aspect_ratio_info_present_flag
        b.u(0, 1)          # overscan_info_present_flag
        signal = c.full_range or c.matrix is not None
        b.u(int(signal), 1)
        if signal:
            b.u(5, 3)
            b.u(int(c.full_range), 1)
            b.u(int(c.matrix is not None), 1)
            if c.matrix is not None:
                b.u(c.matrix, 8)
                b.u(c.matrix, 8)
                b.u(c.matrix, 8)
        b.u(0, 1)          # chroma_loc_info_present_flag
        b.u(1, 1)          # timing_info_present_flag
        b.u(1, 32)
        b.u(60, 32)
        b.u(1, 1)
        b.u(0, 1)
        b.u(0, 1)
        b.u(0, 1)          # pic_struct_present_flag
        b.u(int(c.reorder is not None), 1)
        if c.reorder is not None:
            b.u(1, 1)
            b.ue(0)
            b.ue(0)
            b.ue(16)
            b.ue(16)
            b.ue(c.reorder)
            b.ue(c.num_ref_frames)
    return nal(hp.NAL_SPS, 3, b.rbsp())


def _pps(c: Config) -> bytes:
    t = dict(c.tweaks)
    b = _Bits()
    b.ue(c.pps_id)
    b.ue(c.sps_id)
    b.u(int(c.cabac), 1)
    b.u(int(c.bottom_poc), 1)
    b.ue(t.get("slice_groups", 1) - 1)
    if t.get("slice_groups", 1) > 1:
        b.ue(0)            # interleaved map: the run lengths
        for _ in range(t["slice_groups"]):
            b.ue(0)
    b.ue(c.num_ref_idx - 1)
    b.ue(0)
    b.u(int(c.weighted), 1)
    b.u(c.weighted_bipred, 2)
    b.se(c.init_qp - 26)
    b.se(0)
    b.se(c.cqp)
    b.u(int(c.deblock_control), 1)
    b.u(int(c.cip), 1)
    b.u(int(c.redundant_present), 1)
    if c.transform_8x8 or c.pps_lists is not None or "second_cqp" in t:
        b.u(int(c.transform_8x8), 1)
        b.u(int(c.pps_lists is not None), 1)
        if c.pps_lists is not None:
            _write_lists(b, c.pps_lists)
        b.se(t.get("second_cqp", c.cqp))
    return nal(hp.NAL_PPS, 3, b.rbsp())


def _write_lists(b: _Bits, lists) -> None:
    """scaling_list() entries (see Config.sps_lists)."""
    for i, lst in enumerate(lists):
        b.u(int(lst is not None), 1)
        if lst is None:
            continue
        size = 16 if i < 6 else 64
        if lst == "default":
            b.se(-8)           # nextScale 0 at j 0
            continue
        last = 8
        for v in lst:
            b.se((v - last + 128) % 256 - 128)
            last = v
        if len(lst) < size:
            b.se((0 - last + 128) % 256 - 128)   # nextScale 0: the rest repeat


def _mbs(c: Config) -> Tuple[int, int]:
    left, right, top, bottom = c.crop
    return ((c.width + left + right + 15) // 16,
            (c.height + top + bottom + 15) // 16)


_ENC_SRC = Path(__file__).resolve().parent / "_torch_h264_enc.cpp"
_enc_lib = None
_enc_lock = threading.Lock()   # one build where threads encode at once


def native_encoder():
    """``tests/_torch_h264_enc.cpp``, built with g++ on first use into
    ``build/native/``; raises RuntimeError where it does not build."""
    with _enc_lock:
        return _native_encoder()


def _native_encoder():
    global _enc_lib
    if _enc_lib is not None:
        return _enc_lib
    from camera_linearity_tpu_torch import native
    path = native._lib_path("_h264_enc", _ENC_SRC)
    if not path.exists() and not native._build(path, _ENC_SRC, ("-fwrapv",)):
        raise RuntimeError("tests/_torch_h264_enc.cpp did not build: "
                           f"{native.build_error('_h264_enc')}")
    lib = ctypes.CDLL(str(path))
    vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.clt_h264enc_new.argtypes = [i, i, i]
    lib.clt_h264enc_new.restype = vp
    lib.clt_h264enc_free.argtypes = [vp]
    lib.clt_h264_grow.argtypes = [vp, i]
    lib.clt_h264enc_slice.argtypes = [vp, i, i, vp, vp, vp, vp, i, vp, ll,
                                      vp, vp, vp, ll]
    lib.clt_h264enc_slice.restype = ll
    lib.clt_h264enc_deblock.argtypes = [vp, i, vp, i]
    lib.clt_h264enc_planes.argtypes = [vp, i, vp]
    lib.clt_h264enc_counts.restype = i
    _enc_lib = lib
    return lib


def _slice_header(c: Config, p: PicPlan, first_mb: int, frame_num: int,
                  poc_lsb: int, idr_id: int) -> Tuple[bytes, int]:
    b = _Bits()
    b.ue(first_mb)
    b.ue({"IDR": 7, "I": 7, "P": 5, "B": 6, "SP": 8, "SI": 9}[p.kind])
    b.ue(c.pps_id)
    b.u(frame_num, c.log2_max_frame_num)
    if p.kind == "IDR":
        b.ue(idr_id)
    if c.poc_type == 0:
        b.u(poc_lsb, c.log2_max_poc_lsb)
        if c.bottom_poc:
            b.se(0)
    elif c.poc_type == 1:
        b.se(0)
        if c.bottom_poc:
            b.se(0)
    if c.redundant_present:
        b.ue(p.redundant)
    if p.kind == "B":
        b.u(1, 1)          # direct_spatial_mv_pred_flag
    if p.kind in ("P", "B", "SP"):
        if p.num_ref is not None:
            b.u(1, 1)
            b.ue(p.num_ref - 1)
            if p.kind == "B":
                b.ue(0)
        else:
            b.u(0, 1)
        if p.modifications:
            b.u(1, 1)
            for idc, v in p.modifications:
                b.ue(idc)
                b.ue(v)
            b.ue(3)
        else:
            b.u(0, 1)
        if p.kind == "B":
            b.u(0, 1)          # ref_pic_list_modification_flag_l1
        if (c.weighted and p.kind == "P") or (c.weighted_bipred == 1 and
                                              p.kind == "B"):
            _write_weights(b, p, c)
    if p.ref_idc:
        if p.kind == "IDR":
            b.u(0, 1)
            b.u(int(p.long_term), 1)
        elif p.mmcos is not None:
            b.u(1, 1)
            for op in p.mmcos:
                for v in op:
                    b.ue(v)
            b.ue(0)
        else:
            b.u(0, 1)
    if c.cabac and p.kind not in ("IDR", "I", "SI"):
        b.ue(p.cabac_init_idc)
    b.se(p.qp - c.init_qp)
    if c.deblock_control:
        b.ue(p.disable)
        if p.disable != 1:
            b.se(p.alpha)
            b.se(p.beta)
    return b.raw()


def _write_weights(b: _Bits, p: PicPlan, c: Config) -> None:
    lwd, cwd, entries = p.weights or (0, 0, ())
    n = p.num_ref if p.num_ref is not None else c.num_ref_idx
    b.ue(lwd)
    b.ue(cwd)
    lists = 2 if p.kind == "B" else 1
    for _ in range(lists):
        for i in range(n):
            luma, chroma = entries[i] if i < len(entries) else (None, None)
            b.u(int(luma is not None), 1)
            if luma is not None:
                b.se(luma[0])
                b.se(luma[1])
            b.u(int(chroma is not None), 1)
            if chroma is not None:
                for v in chroma:
                    b.se(v)


def i420_planes(bgr: np.ndarray) -> Tuple[np.ndarray, ...]:
    """BT.601 limited-range yuv420p planes of a BGR uint8 picture (even
    sides), as content for the encoder."""
    f = bgr.astype(np.float64)
    b, g, r = f[..., 0], f[..., 1], f[..., 2]
    y = 16 + (65.481 * r + 128.553 * g + 24.966 * b) / 255
    u = 128 + (-37.797 * r - 74.203 * g + 112.0 * b) / 255
    v = 128 + (112.0 * r - 93.786 * g - 18.214 * b) / 255
    sub = lambda c: c.reshape(c.shape[0] // 2, 2, c.shape[1] // 2,
                              2).mean((1, 3))
    return tuple(np.clip(np.rint(p), 0, 255).astype(np.uint8)
                 for p in (y, sub(u), sub(v)))


def scene(n: int, height: int, width: int, seed: int = 0
          ) -> List[Tuple[np.ndarray, ...]]:
    """``n`` pictures of a textured scene that pans and brightens (yuv420p
    planes): gradients, edges, a moving disc and noise."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:height, 0:width].astype(np.float64)
    base = 60 + 90 * (xx / max(width, 1)) + 40 * np.sin(yy / 5.0)
    tex = rng.normal(0, 12, (height, width))
    out = []
    for t in range(n):
        cx, cy = width * (0.3 + 0.05 * t), height * 0.5
        disc = (xx - cx) ** 2 + (yy - cy) ** 2 < \
            (min(height, width) / 4) ** 2
        lum = base * (1 + 0.04 * t) + np.roll(tex, t, axis=1) + 70 * disc
        b = np.clip(lum + 30 * np.cos(xx / 7 + t), 0, 255)
        g = np.clip(lum, 0, 255)
        r = np.clip(lum + 40 * disc - 20, 0, 255)
        out.append(i420_planes(np.stack([b, g, r], -1).astype(np.uint8)))
    return out


def _pad(planes, mbw: int, mbh: int, crop) -> Tuple[np.ndarray, ...]:
    left, right, top, bottom = crop
    y, u, v = planes
    out = []
    for p, s in ((y, 1), (u, 2), (v, 2)):
        full = np.pad(p, ((top // s, mbh * 16 // s - top // s - p.shape[0]),
                          (left // s, mbw * 16 // s - left // s - p.shape[1])),
                      mode="edge")
        out.append(np.ascontiguousarray(full, np.uint8))
    return tuple(out)


def encode(pictures: Sequence[Tuple[np.ndarray, ...]], config: Config,
           plans: Sequence[PicPlan]):
    """Code ``pictures`` (yuv420p planes of ``config``'s size, cropped
    size) by ``plans``.  Returns (samples: a list of NAL units a picture,
    the first with the SPS and PPS in band; the parameter sets; the
    reconstruction as FFmpeg outputs it (yuv420p planes, cropped by
    ``h264_plain.geometry``); the counts)."""
    lib = native_encoder()
    mbw, mbh = _mbs(config)
    sps, pps = _sps(config), _pps(config)
    stream = hp.Stream(annexb([sps, pps]))
    handle = lib.clt_h264enc_new(mbw, mbh, 40)
    counts = np.zeros(lib.clt_h264enc_counts(), np.int32)
    samples, recons = [], []
    frame_num, prev_ref_fn, poc_k, idr_id = 0, 0, 0, 0
    max_fn = 1 << config.log2_max_frame_num
    sps_parsed = stream.spss[config.sps_id]
    top, left = hp.crop_origin(sps_parsed)
    oh, ow = hp.geometry(sps_parsed)
    try:
        for t, (pic, plan) in enumerate(zip(pictures, plans)):
            src = _pad(pic, mbw, mbh, config.crop)
            if plan.kind == "IDR":
                frame_num, prev_ref_fn, poc_k = 0, 0, 0
            else:
                frame_num = (prev_ref_fn + 1) % max_fn
                poc_k += 1
            lsb = (2 * poc_k - (0 if plan.ref_idc else 1)) % \
                (1 << config.log2_max_poc_lsb)
            # the slices that start inside the picture
            firsts = tuple(f for f in plan.slices if f < mbw * mbh) or (0,)
            heads = [_slice_header(config, plan, f, frame_num, lsb, idr_id)
                     for f in firsts]
            kind = hp.NAL_IDR if plan.kind == "IDR" else hp.NAL_SLICE
            probe = b"".join(
                b"\x00\x00\x00\x01" + nal(kind, plan.ref_idc,
                                          _with_stop(*h)) for h in heads)
            job = stream.next(probe)
            nals = []
            params = []
            for i, (f, (head, nbits)) in enumerate(zip(firsts, heads)):
                last = firsts[i + 1] if i + 1 < len(firsts) else mbw * mbh
                prm = np.array(job.native_params(job.slices[i]), np.int32)
                params.append(prm)
                opts = np.array(plan.opts._replace(
                    seed=plan.opts.seed * 7919 + t * 31 + i), np.int32)
                cap = 1024 + (last - f) * 1200
                out = np.empty(cap, np.uint8)
                size = lib.clt_h264enc_slice(
                    handle, job.pic.slot, i, src[0].ctypes.data,
                    src[1].ctypes.data, src[2].ctypes.data, prm.ctypes.data,
                    last, head, nbits, opts.ctypes.data, counts.ctypes.data,
                    out.ctypes.data, cap)
                if size < 0:
                    raise RuntimeError(f"the encoder failed ({size}) on "
                                       f"picture {t}, slice {i}")
                nals.append(nal(kind, plan.ref_idc, out[:size].tobytes()))
            allp = np.stack(params)
            lib.clt_h264enc_deblock(handle, job.pic.slot, allp.ctypes.data,
                                    len(params))
            full = np.empty(mbw * mbh * 384, np.uint8)
            lib.clt_h264enc_planes(handle, job.pic.slot, full.ctypes.data)
            y = full[:mbw * mbh * 256].reshape(mbh * 16, mbw * 16)
            u = full[mbw * mbh * 256:mbw * mbh * 320].reshape(mbh * 8, mbw * 8)
            v = full[mbw * mbh * 320:].reshape(mbh * 8, mbw * 8)
            recons.append((y[top:top + oh, left:left + ow].copy(),
                           u[top // 2:(top + oh) // 2,
                             left // 2:(left + ow) // 2].copy(),
                           v[top // 2:(top + oh) // 2,
                             left // 2:(left + ow) // 2].copy()))
            stream.release(job.pic.slot)
            stream.end_batch()
            samples.append(([sps, pps] if t == 0 else []) + nals)
            if plan.ref_idc:
                prev_ref_fn = frame_num
                if plan.mmcos and any(op[0] == 5 for op in plan.mmcos):
                    prev_ref_fn, poc_k = 0, 0
            if plan.kind == "IDR":
                idr_id += 1
    finally:
        lib.clt_h264enc_free(handle)
    return samples, (sps, pps), recons, counts


def _with_stop(head: bytes, nbits: int) -> bytes:
    """A slice header's bits with the stop bit after them (what the stream
    layer reads of a slice)."""
    b = _Bits()
    b.bits = [(head[i >> 3] >> (7 - (i & 7))) & 1 for i in range(nbits)]
    return b.rbsp()


def annexb(nals: Sequence[bytes]) -> bytes:
    return b"".join(b"\x00\x00\x00\x01" + n for n in nals)


def length_prefixed(nals: Sequence[bytes], size: int = 4) -> bytes:
    return b"".join(len(n).to_bytes(size, "big") + n for n in nals)


def avcc(sps: bytes, pps: bytes, size: int = 4) -> bytes:
    """An AVCDecoderConfigurationRecord of one SPS and one PPS."""
    return bytes([1, sps[1], sps[2], sps[3], 0xFC | (size - 1), 0xE1]) + \
        struct.pack(">H", len(sps)) + sps + b"\x01" + \
        struct.pack(">H", len(pps)) + pps


def write_h264_avi(path: Path, samples: Sequence[Sequence[bytes]], height: int,
                   width: int, tag: str = "H264", fps: int = 30,
                   extradata: Optional[bytes] = None) -> None:
    """An AVI of Annex B chunks, fourcc ``tag``: the parameter sets in
    band, or (``extradata``) that after the BITMAPINFOHEADER and none in
    the chunks."""
    from tests._torch_rawvideo_writer import video_headers, write_avi
    if extradata is not None:
        samples = [[n for n in s if (n[0] & 0x1F) not in (hp.NAL_SPS,
                                                          hp.NAL_PPS)]
                   for s in samples]
    payloads = [annexb(s) for s in samples]
    strh, strf = video_headers(height, width, tag.encode(), 24,
                               len(payloads),
                               max(map(len, payloads), default=0), fps)
    if extradata:
        strf = (40 + len(extradata)).to_bytes(4, "little") + strf[4:40] + \
            extradata
    write_avi(path, strh, strf, payloads, b"dc", fps=fps)


def write_h264_mp4(path: Path, samples: Sequence[Sequence[bytes]],
                   params: Tuple[bytes, bytes], height: int, width: int,
                   fourcc: bytes = b"avc1", size: int = 4,
                   children: Sequence[bytes] = (), qt: bool = False) -> None:
    """An MP4 (MOV with ``qt``) of length-prefixed samples under an
    ``avcC`` of the parameter sets; ``avc1`` drops the in-band parameter
    sets, ``avc3`` keeps them."""
    from tests import _torch_mp4_writer as mw
    body = [[n for n in s if fourcc != b"avc1" or (n[0] & 0x1F) not in
             (hp.NAL_SPS, hp.NAL_PPS)] for s in samples]
    track = mw.video_track([length_prefixed(s, size) for s in body], height,
                           width, fourcc, [mw.box(b"avcC", avcc(
                               *params, size))] + list(children), qt=qt)
    mw.write_mp4(path, [track], qt=qt)


def write_h264_mkv(path: Path, samples: Sequence[Sequence[bytes]],
                   params: Tuple[bytes, bytes], height: int, width: int,
                   size: int = 4, colour=None) -> None:
    """A Matroska file of ``V_MPEG4/ISO/AVC`` frames (length-prefixed,
    the parameter sets in the avcC CodecPrivate)."""
    from tests import _torch_mkv_writer as kw
    body = [[n for n in s if (n[0] & 0x1F) not in (hp.NAL_SPS, hp.NAL_PPS)]
            for s in samples]
    track = kw.video_track([length_prefixed(s, size) for s in body], height,
                           width, "V_MPEG4/ISO/AVC", avcc(*params, size),
                           colour=colour)
    kw.write_mkv(path, [track])


# the encoder's counts (tests/_torch_h264_enc.cpp's layout)
_COUNTS = (("token", 4 * 68), ("dc_token", 20), ("zeros", 15 * 16),
           ("dc_zeros", 12), ("run", 7 * 15), ("prefix", 32), ("kind", 8),
           ("ptype", 5), ("sub", 4), ("i4", 9), ("i16", 4), ("chroma", 4),
           ("qp", 52), ("ref", 32), ("far", 1), ("ctx", 460), ("i8", 9),
           ("t8", 2), ("dqp", 52), ("mvd_escape", 1), ("abs_escape", 1),
           ("pcm_cabac", 1))


def coverage(counts: np.ndarray) -> dict:
    """The encoder's counts by name."""
    out, at = {}, 0
    for name, n in _COUNTS:
        out[name] = counts[at:at + n]
        at += n
    return out


def missing_codes(counts: np.ndarray) -> List[str]:
    """The CAVLC table entries a stream of ``counts`` did not write."""
    c = coverage(counts)
    miss = []
    for cls in range(4):
        for tc in range(17):
            for t1 in range(min(3, tc) + 1):
                if not c["token"][cls * 68 + tc * 4 + t1]:
                    miss.append(f"coeff_token nC class {cls} ({tc}, {t1})")
    for tc in range(5):
        for t1 in range(min(3, tc) + 1):
            if not c["dc_token"][tc * 4 + t1]:
                miss.append(f"chroma DC coeff_token ({tc}, {t1})")
    for t in range(15):
        for z in range(16 - t):
            if not c["zeros"][t * 16 + z]:
                miss.append(f"total_zeros TotalCoeff {t + 1}: {z}")
    for t in range(3):
        for z in range(4 - t):
            if not c["dc_zeros"][t * 4 + z]:
                miss.append(f"chroma DC total_zeros TotalCoeff {t + 1}: {z}")
    for z in range(7):
        for r in range(z + 2 if z < 6 else 15):
            if not c["run"][z * 15 + r]:
                miss.append(f"run_before zerosLeft {z + 1}: {r}")
    for p in (14, 15, 16):
        if not c["prefix"][p]:
            miss.append(f"level_prefix {p}")
    return miss


def kitchen_sink(seed: int = 0, coverage: int = 0, qp: Tuple[int, int] = (
        16, 40), **opts) -> List[PicPlan]:
    """Twelve pictures over the stream-level tools: an IDR of two slices,
    P pictures of one to three slices and one to three references, a
    non-reference one, reference list modifications (short- and long-term),
    every memory management operation (MMCO 5 last but one), a non-IDR I
    picture, deblocking off, on without slice edges, and with offsets."""
    o = Options(seed=seed, coverage=coverage, qp_min=qp[0], qp_max=qp[1],
                **opts)
    return [
        PicPlan("IDR", 3, 28, (0, 5), opts=o, alpha=2, beta=-3),
        PicPlan("P", 2, 30, (0, 4, 9), opts=o, disable=2),
        PicPlan("P", 2, 26, (), num_ref=2, opts=o),
        PicPlan("P", 0, 33, (0, 7), num_ref=2, opts=o, alpha=-6, beta=6),
        PicPlan("P", 2, 24, (), num_ref=3, modifications=((0, 1),), opts=o,
                mmcos=((4, 2), (3, 0, 0))),
        PicPlan("P", 2, 29, (), num_ref=3, modifications=((2, 0), (0, 0)),
                opts=o, disable=1),
        PicPlan("P", 2, 31, (0, 3), num_ref=2, opts=o,
                mmcos=((2, 0), (6, 1))),
        PicPlan("I", 2, 27, (), opts=o),
        PicPlan("P", 2, 25, (), num_ref=3, opts=o, mmcos=((1, 0),)),
        PicPlan("P", 2, 32, (), num_ref=2, opts=o, mmcos=((5,),)),
        PicPlan("P", 2, 28, (), opts=o),
        PicPlan("P", 1, 30, (0, 2, 6), num_ref=2, opts=o),
    ]


# the seed whose coverage stream (64 x 48, its scene of that seed) writes
# every CAVLC table entry, every QP and every macroblock kind and mode
COVERAGE_SEED = 10


def coverage_plans(seed: int = COVERAGE_SEED) -> List[PicPlan]:
    """The kitchen sink in the encoder's coverage mode, every macroblock
    at the next QP of 0-51 (a sweep), intra, Intra16x16 and I_PCM
    macroblocks more often: the 64 x 48 stream of ``COVERAGE_SEED``
    writes every CAVLC table entry."""
    return kitchen_sink(seed, coverage=500, qp=(0, 51), p_dqp=1000,
                        p_i16=600, p_intra=150, p_pcm=30)


def slice_nal(config: Config, plan: PicPlan, frame_num: int = 1,
              poc_lsb: int = 2, first_mb: int = 0,
              data: bytes = b"\xa5\x5a") -> bytes:
    """A slice NAL unit of ``plan``'s header (any slice type: B, SP and SI
    among them) and ``data`` after it, for streams the decoder refuses at
    that slice."""
    head, nbits = _slice_header(config, plan, first_mb, frame_num, poc_lsb,
                                0)
    b = _Bits()
    b.bits = [(head[i >> 3] >> (7 - (i & 7))) & 1 for i in range(nbits)]
    for byte in data:
        b.u(byte, 8)
    kind = hp.NAL_IDR if plan.kind == "IDR" else hp.NAL_SLICE
    return nal(kind, plan.ref_idc, b.rbsp())


def parameter_sets(config: Config) -> Tuple[bytes, bytes]:
    """The SPS and PPS NAL units of ``config``."""
    return _sps(config), _pps(config)


def high_config(height: int, width: int, **kw) -> Config:
    """A High-profile stream's parameter sets: CABAC, the 8x8 transform and
    explicit weights unless ``kw`` says otherwise (level 4.0)."""
    base = dict(profile=100, constraints=0, level=40, cabac=True,
                transform_8x8=True, weighted=True)
    base.update(kw)
    return Config(height, width, **base)


def weight_plans(n: int, seed: int = 0, num_ref: int = 3):
    """``n`` pred_weight_tables of P pictures: the denominators through 0-7
    (luma up, chroma down), weights below zero and past 1 << denom,
    offsets of either sign, flags off for some indices."""
    rng = np.random.default_rng(seed)
    out = []
    for k in range(n):
        lwd, cwd = k % 8, 7 - k % 8
        ents = []
        for i in range(num_ref):
            pick = (k + i) % 4
            luma = None if pick == 3 else (
                int(rng.integers(-128, 128)) if pick == 0 else
                min((1 << lwd) + int(rng.integers(-3, 4)), 127),
                int(rng.integers(-40, 41)))
            chroma = None if pick == 2 else (
                int(rng.integers(-128, 128)), int(rng.integers(-30, 31)),
                min(max((1 << cwd) - 2, -128), 127),
                int(rng.integers(-30, 31)))
            ents.append((luma, chroma))
        out.append((lwd, cwd, tuple(ents)))
    return out


def high_sink(seed: int = 0, coverage: int = 0, qp: Tuple[int, int] = (
        16, 40), **opts) -> List[PicPlan]:
    """:func:`kitchen_sink` with a High stream's slice fields: each P
    picture's cabac_init_idc (0-2 in turn) and weights
    (:func:`weight_plans`), and a last picture whose reference list holds
    the previous picture twice (x264's ``--weightp 2`` duplicate), each
    copy weighted its own way."""
    o = Options(seed=seed, coverage=coverage, qp_min=qp[0], qp_max=qp[1],
                **opts)
    plans = kitchen_sink(seed, coverage, qp, **opts)
    weights = iter(weight_plans(len(plans), seed, 3))
    out = []
    for k, p in enumerate(plans):
        if p.kind == "P":
            lwd, cwd, ents = next(weights)
            p = p._replace(cabac_init_idc=k % 3,
                           weights=(lwd, cwd, ents[:p.num_ref or 1]))
        out.append(p)
    out.append(PicPlan("P", 2, 27, (), num_ref=3, opts=o,
                       modifications=((0, 0), (0, 15)), cabac_init_idc=1,
                       weights=(5, 3, (((40, 3), None),
                                       ((20, -9), (10, 2, 6, -3)),
                                       ((33, 1), None)))))
    return out


# the seed whose High coverage stream (64 x 48, its scene of that seed)
# codes with every context of a frame-coded 4:2:0 I or P slice
HIGH_COVERAGE_SEED = 10


def high_coverage_plans(seed: int = HIGH_COVERAGE_SEED) -> List[PicPlan]:
    """:func:`high_sink` in the encoder's coverage mode: every MB at the
    next QP of 0-51, intra, Intra16x16 and I_PCM macroblocks more often,
    coefficients at every position, levels past the prefix."""
    return high_sink(seed, coverage=400, qp=(0, 51), p_dqp=1000,
                     p_i16=400, p_intra=150, p_pcm=30, p_far=60)
