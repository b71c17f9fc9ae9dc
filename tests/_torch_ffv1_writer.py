"""FFV1 encoder and AVI writer for the port's FFV1 tests and
``chip_smoke.py`` (Python and NumPy, no cv2 or FFmpeg).

``Encoder`` codes frames as FFmpeg 8's ffv1enc.c codes them
(``camera_linearity_tpu_torch/native/ffv1_plain.py`` has the decoder's
rules, which this inverts): versions 0 and 1 (the header in every
keyframe, one slice), 2 (the header in the extradata, the slice layout in
every keyframe) and 3 (a slice header in every slice, slice CRCs with
``ec``); the Golomb-Rice coder with its run mode, or the range coder with
the default or a custom state-transition table; context models 0 and 1;
RGB (with or without alpha), gray at 8 or 16 bits and planar YUV; any
slice grid and GOP.  At cv2's own settings (:func:`cv2_config`: BGR as
FFmpeg's bgra with a constant alpha, gray8 and gray16; version 3 micro 4,
``ec`` 1, the Golomb-Rice coder at 8 bits and the range coder with
FFmpeg's ``ver2_state`` table at 16, context model 0, its slice grid and
a GOP of 12) it gives the bytes ``cv2.VideoWriter(fourcc "FFV1")``
writes.  Every sample is coded in Python, so keep frames small;
``tests/_torch_ffv1_enc.cpp`` (:func:`native_encoder`) codes cv2's
layouts at 4K and gives these bytes.

``write_ffv1_avi`` writes the container with
``tests/_torch_rawvideo_writer.write_avi``, laid out as cv2 lays it out:
the extradata after the BITMAPINFOHEADER (24 bits a pixel, the image
size W * H * 3), the frames in ``00dc`` chunks.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from camera_linearity_tpu_torch.native import ffv1_plain as fp
from tests._torch_rawvideo_writer import video_headers, write_avi

__all__ = ["Config", "cv2_config", "cv2_slices", "Encoder", "extradata",
           "write_ffv1_avi", "write_stream_avi", "stream_params",
           "native_encoder", "native_encode", "to_picture", "VER2_STATE",
           "LAYOUTS"]

# FFmpeg's ver2_state (ffv1enc.c): the custom state-transition table its
# range coder writes into the header
VER2_STATE = np.frombuffer(bytes.fromhex(
    "000a0a0a0a1010101c10101d2a3114313b191a1a1b1f212121222225432627272828"
    "294f2b2c2d2d3030403233345834354a37393a3a4a3c653d3e5442424445575247"
    "614949524b6f4d5e4e5751536155535e5663595a636f5c5d865f626962696e666c"
    "6676676a6a716d707270747d737475757e777d79797b917c7e837f81a582848a85"
    "879188898b928d8f8e9094939b97959796989d999a9ca89ea2a1a0aca3a9a4a6b8"
    "a7aab1aeabadb6b0b4b2afbdb3b5bab7c0b9c8bbbfbcbec5c1c4c5c2c3c4c6cac7"
    "c9d2cbcfcccdced0d6d1d3ddd4d5d7e0d8d9dadbdcdee4dfe1e2e0e3e5f0e6e7e8"
    "e9eaebeceeefedf2f1f3f2f4f5f6f7f8f9fafbfcfcfdfeff"), np.uint8)

# the quantisation tables FFmpeg writes, as the run lengths of each of
# their five inputs' levels 0, 1, ... over the differences 0..127: per
# bit depth, context model 0 then 1 (quant11 and quant5 at 8 bits,
# quant9_10bit and quant5_10bit past 8)
_QUANT_RUNS = {
    8: ([[1, 1, 3, 7, 23, 93]] * 3 + [[128]] * 2,
        [[1, 1, 3, 7, 23, 93]] * 2 + [[1, 3, 124]] * 3),
    16: ([[5, 8, 14, 29, 72]] * 3 + [[128]] * 2,
         [[5, 8, 14, 29, 72]] * 2 + [[11, 39, 78]] * 3),
}

# layout: (colour space, chroma planes, h shift, v shift, alpha, bits)
LAYOUTS = {
    "bgr0": (1, True, 0, 0, False, 8), "bgra": (1, True, 0, 0, True, 8),
    "gray8": (0, False, 0, 0, False, 8), "gray16": (0, False, 0, 0, False, 16),
    "yuv420p": (0, True, 1, 1, False, 8), "yuv422p": (0, True, 1, 0, False, 8),
    "yuv444p": (0, True, 0, 0, False, 8), "yuv440p": (0, True, 0, 1, False, 8),
    "yuv411p": (0, True, 2, 0, False, 8), "yuv410p": (0, True, 2, 2, False, 8),
    "ya8": (0, False, 0, 0, True, 8), "yuva420p": (0, True, 1, 1, True, 8),
    "yuva444p": (0, True, 0, 0, True, 8),
    "gray10": (0, False, 0, 0, False, 10),
    "yuv420p10": (0, True, 1, 1, False, 10),
    "rgb10": (1, True, 0, 0, False, 10),
}


class Config(NamedTuple):
    """A stream's settings: ``layout`` (a key of ``LAYOUTS``), version,
    coder (0 Golomb-Rice, 1 range, 2 range with ``transition``), context
    model, the slice grid (num_h, num_v), GOP, ``ec`` and the micro
    version (version 3)."""
    layout: str
    version: int = 3
    coder: int = 0
    context_model: int = 0
    slices: Tuple[int, int] = (2, 2)
    gop: int = 12
    ec: int = 1
    micro_version: int = 4
    transition: Optional[np.ndarray] = None
    colorspace: Optional[int] = None   # overrides the layout's (Bayer: 2)
    initial: bool = False   # initial states for the context model's table

    def initial_states(self, contexts: int) -> Optional[np.ndarray]:
        """The (contexts, 32) initial states a keyframe resets the range
        coder's contexts to, with ``initial`` (versions 2+; a pattern in
        64..191), else None (128)."""
        if not self.initial or self.version < 2:
            return None
        j, k = np.mgrid[:contexts, :fp.CONTEXT_SIZE]
        return (64 + (j * 7 + k * 13) % 128).astype(np.uint8)

    @property
    def spec(self):
        return LAYOUTS[self.layout]

    @property
    def bits(self) -> int:
        return self.spec[5]

    @property
    def plane_count(self) -> int:
        cs, chroma, _, _, alpha, _ = self.spec
        return (1 + (chroma or self.version < 4) + alpha) \
            if self.version >= 2 else 2 + alpha

    def table(self) -> Optional[np.ndarray]:
        if self.coder != 2:
            return None
        return VER2_STATE if self.transition is None else self.transition


def cv2_slices(height: int, width: int, chroma_h: int = 0,
               chroma_v: int = 0) -> Tuple[int, int]:
    """The slice grid FFmpeg 8's encoder picks with ``slices`` unset, as
    ``cv2.VideoWriter`` leaves it (ffv1enc.c's search, probed on cv2's
    files from 18 x 26 to 2160 x 3840): the first (num_h, num_v), num_v
    from 2 and num_h from num_v to 2 * num_v, whose slices hold at most
    360 x 288 pixels."""
    max_h, max_v = -(-width >> chroma_h), -(-height >> chroma_v)
    for nv in range(min(2, max_v), 33):
        for nh in range(nv, 2 * nv + 1):
            if nh > max_h or nv > max_v:
                continue
            if -(-width // nh) * -(-height // nv) <= 360 * 288:
                return nh, nv
    raise ValueError(f"no slice grid for {height} x {width}")


def cv2_config(layout: str, height: int, width: int) -> Config:
    """cv2.VideoWriter(fourcc "FFV1")'s settings for ``"bgr"`` (coded as
    bgra), ``"gray8"`` and ``"gray16"``."""
    name = {"bgr": "bgra"}.get(layout, layout)
    cs, chroma, hs, vs, alpha, bits = LAYOUTS[name]
    return Config(name, 3, 2 if bits > 8 else 0, 0,
                  cv2_slices(height, width, hs, vs), 12, 1, 4)


def _quant_tables(runs_set) -> Tuple[np.ndarray, int]:
    """A (5, 256) table from five inputs' run lengths, scaled as
    read_quant_tables scales them; and its context count."""
    tables, count = [], 1
    for runs in runs_set:
        t = np.zeros(256, np.int64)
        i = 0
        for v, n in enumerate(runs):
            t[i:i + n] = count * v
            i += n
        t[129:256] = -t[127:0:-1]
        t[128] = -t[127]
        tables.append(t)
        count *= 2 * len(runs) - 1
    return np.stack(tables), (count + 1) // 2


class _RacWriter:
    """FFmpeg's range encoder (rangecoder.h)."""

    def __init__(self, one=None, zero=None):
        self.out = bytearray()
        self.low, self.range = 0, 0xFF00
        self.outstanding_count, self.outstanding_byte = 0, -1
        self.one = one or fp._DEFAULT_ONE
        self.zero = zero or fp._DEFAULT_ZERO

    def _renorm(self) -> None:
        while self.range < 0x100:
            if self.outstanding_byte < 0:
                self.outstanding_byte = self.low >> 8
            elif self.low <= 0xFF00:
                self.out.append(self.outstanding_byte)
                self.out += b"\xff" * self.outstanding_count
                self.outstanding_count = 0
                self.outstanding_byte = self.low >> 8
            elif self.low >= 0x10000:
                self.out.append(self.outstanding_byte + 1)
                self.out += b"\x00" * self.outstanding_count
                self.outstanding_count = 0
                self.outstanding_byte = (self.low >> 8) - 0x100
            else:
                self.outstanding_count += 1
            self.low = (self.low & 0xFF) << 8
            self.range <<= 8

    def bit(self, state, i: int, bit: int) -> None:
        s = state[i]
        r1 = (self.range * s) >> 8
        if not bit:
            self.range -= r1
            state[i] = self.zero[s]
        else:
            self.low += self.range - r1
            self.range = r1
            state[i] = self.one[s]
        self._renorm()

    def symbol(self, state, v: int, signed: bool = False) -> None:
        """put_symbol."""
        if not v:
            self.bit(state, 0, 1)
            return
        a = abs(v)
        e = a.bit_length() - 1
        self.bit(state, 0, 0)
        for i in range(e):
            self.bit(state, 1 + min(i, 9), 1)
        self.bit(state, 1 + min(e, 9), 0)
        for i in range(e - 1, -1, -1):
            self.bit(state, 22 + min(i, 9), (a >> i) & 1)
        if signed:
            self.bit(state, 11 + min(e, 10), int(v < 0))

    def terminate(self, version: int = 0) -> bytes:
        """ff_rac_terminate; version 1 first codes a 0 in a state of 129
        (the bit a version 3.2+ decoder reads before Golomb-Rice data)."""
        if version == 1:
            self.bit(bytearray([129]), 0, 0)
        self.range = 0xFF
        self.low += 0xFF
        self._renorm()
        self.range = 0xFF
        self._renorm()
        return bytes(self.out)


class _BitWriter:
    def __init__(self):
        self.bits: List[int] = []

    def put(self, n: int, v: int) -> None:
        for i in range(n - 1, -1, -1):
            self.bits.append((v >> i) & 1)

    def flush(self) -> bytes:
        bits = self.bits + [0] * (-len(self.bits) % 8)
        return np.packbits(np.array(bits, np.uint8)).tobytes() \
            if bits else b""


class _SliceCoder:
    """One slice's coding state across frames: per plane its context
    states (range) or Golomb-Rice states."""

    def __init__(self, enc: "Encoder"):
        self.enc = enc
        self.states: List[list] = []
        self.vlc: List[list] = []
        self.run_index = 0

    def reset(self) -> None:
        enc = self.enc
        n = enc.context_counts[enc.context_model]
        init = enc.config.initial_states(n)
        self.states = [[bytearray([128] * fp.CONTEXT_SIZE) if init is None
                        else bytearray(init[j].tobytes()) for j in range(n)]
                       for _ in range(enc.config.plane_count)]
        self.vlc = [[[0, 4, 0, 1] for _ in range(n)]
                    for _ in range(enc.config.plane_count)]

    def _vlc(self, pb: _BitWriter, st: list, v: int, bits: int) -> None:
        """put_vlc_symbol."""
        drift, error_sum, bias, count = st
        v = fp._fold(v - bias, bits)
        k, i = 0, count
        while i < error_sum:
            k += 1
            i += i
        code = ~v if 2 * drift + count < 0 else v
        u = 2 * code if code >= 0 else -2 * code - 1       # set_sr_golomb
        e = u >> k
        if e < 12:
            pb.put(e + k + 1, (1 << k) + (u & ((1 << k) - 1)))
        else:
            pb.put(12 + bits, u - 12 + 1)
        error_sum += abs(v)
        drift += v
        if count == 128:
            count >>= 1
            drift >>= 1
            error_sum >>= 1
        count += 1
        if drift <= -count:
            bias = max(bias - 1, -128)
            drift = max(drift + count, -count + 1)
        elif drift > 0:
            bias = min(bias + 1, 127)
            drift = min(drift - count, 0)
        st[:] = drift, error_sum, bias, count

    def line(self, rac: _RacWriter, pb: Optional[_BitWriter], cur: list,
             prev: list, values, plane: int, bits: int, w: int) -> None:
        """encode_line of ``values`` (the row's samples, stored as the
        decoder stores them) into ``cur``, the decoder's row buffer."""
        q0, q1, q2, q3, q4 = self.enc.quant[self.enc.context_model]
        five = bool(q3[127] or q4[127])
        states, vlc = self.states[plane], self.vlc[plane]
        run_mode = run_count = 0
        run_index = self.run_index
        log2 = fp.LOG2_RUN
        for x in range(w):
            i = x + 3
            L, T, LT, RT = cur[i - 1], prev[i], prev[i - 1], prev[i + 1]
            ctx = q0[(L - LT) & 0xFF] + q1[(LT - T) & 0xFF] + \
                q2[(T - RT) & 0xFF]
            if five:
                ctx += q3[(cur[i - 2] - L) & 0xFF] + q4[(cur[i] - T) & 0xFF]
            a, b, c = L, L + T - LT, T
            if a > b:
                a, b = b, a
            pred = b if b < c else (a if a > c else c)
            v = int(values[x])
            diff = v - pred
            if ctx < 0:
                ctx, diff = -ctx, -diff
            diff = fp._fold(diff, bits)
            if pb is None:
                rac.symbol(states[ctx], diff, True)
            else:
                if ctx == 0:
                    run_mode = 1
                if run_mode:
                    if diff:
                        while run_count >= 1 << log2[run_index]:
                            run_count -= 1 << log2[run_index]
                            run_index += 1
                            pb.put(1, 1)
                        pb.put(1 + log2[run_index], run_count)
                        if run_index:
                            run_index -= 1
                        run_count = run_mode = 0
                        if diff > 0:
                            diff -= 1
                    else:
                        run_count += 1
                if run_mode == 0:
                    self._vlc(pb, vlc[ctx], diff, bits)
            cur[i] = v
        if run_mode:
            while run_count >= 1 << log2[run_index]:
                run_count -= 1 << log2[run_index]
                run_index += 1
                pb.put(1, 1)
            if run_count:
                pb.put(1, 1)
        self.run_index = run_index

    def plane(self, rac, pb, samples: np.ndarray, plane: int,
              bits: int) -> None:
        """encode_plane: ``samples`` (h, w) as the decoder stores them."""
        h, w = samples.shape
        rows = [[0] * (w + 6), [0] * (w + 6)]
        self.run_index = 0
        for y in range(h):
            rows[0], rows[1] = rows[1], rows[0]
            prev, cur = rows
            cur[2] = prev[3]
            prev[w + 3] = prev[w + 2]
            self.line(rac, pb, cur, prev, samples[y], plane, bits, w)

    def rgb(self, rac, pb, bgra: np.ndarray, alpha: bool) -> None:
        """encode_rgb_frame at 8 bits: ``bgra`` (h, w, 4)."""
        h, w = bgra.shape[:2]
        px = bgra.astype(np.int64)
        b, g, r, a = (px[..., k] for k in range(4))
        b, r = b - g, r - g
        g = g + ((b + r) >> 2)
        b, r = b + 256, r + 256
        planes = [g, b, r, a][:4 if alpha else 3]
        rows = [[[0] * (w + 6), [0] * (w + 6)] for _ in range(4)]
        self.run_index = 0
        for y in range(h):
            for k, samples in enumerate(planes):
                rr = rows[k]
                rr[0], rr[1] = rr[1], rr[0]
                prev, cur = rr
                cur[2] = prev[3]
                prev[w + 3] = prev[w + 2]
                self.line(rac, pb, cur, prev, samples[y], (k + 1) // 2, 9, w)


class Encoder:
    """Codes the frames of one stream in order (each slice's contexts
    carry from frame to frame, reset at every ``gop``-th)."""

    def __init__(self, config: Config, height: int, width: int):
        self.config, self.height, self.width = config, height, width
        runs = _QUANT_RUNS[8 if config.bits <= 8 else 16]
        made = [_quant_tables(r) for r in runs]
        self.quant = [[list(map(int, row)) for row in t] for t, _ in made]
        self.context_counts = [n for _, n in made]
        self.one, self.zero = fp._tables(config.table())
        nh, nv = config.slices if config.version >= 2 else (1, 1)
        self.frames = 0
        self.regrid([(i % nh, i // nh, 1, 1) for i in range(nh * nv)],
                    config.context_model)

    def regrid(self, positions, context_model: int) -> None:
        """Code from the next frame, which must be a keyframe, in slices
        at ``positions`` ((sx, sy, sw, sh) on the config's grid) with the
        quantisation table ``context_model`` (versions 2 and 3)."""
        self.grid, self.context_model = list(positions), context_model
        self.rects = fp.slice_rects(self._params(), self.height, self.width,
                                    self.grid)
        self.coders = [_SliceCoder(self) for _ in self.grid]

    def _params(self) -> fp.Ffv1Params:
        c = self.config
        cs, chroma, hs, vs, alpha, bits = c.spec
        nh, nv = c.slices if c.version >= 2 else (1, 1)
        return fp.Ffv1Params(c.version, c.micro_version, c.coder, None,
                             cs, bits, chroma, hs, vs, alpha, nh, nv, (),
                             (), (), c.ec, c.plane_count)

    def _header(self, rac: _RacWriter) -> None:
        """write_header: the version 0/1 global header, or version 2's
        slice layout, after a keyframe bit."""
        c, state = self.config, bytearray([128] * fp.CONTEXT_SIZE)
        if c.version < 2:
            cs, chroma, hs, vs, alpha, bits = c.spec
            rac.symbol(state, c.version)
            rac.symbol(state, c.coder)
            if c.coder == 2:
                for i in range(1, 256):
                    rac.symbol(state, int(c.table()[i]) - rac.one[i], True)
            rac.symbol(state, c.colorspace if c.colorspace is not None
                       else cs)
            if c.version > 0:
                rac.symbol(state, bits)
            rac.bit(state, 0, int(chroma))
            rac.symbol(state, hs)
            rac.symbol(state, vs)
            rac.bit(state, 0, int(alpha))
            _write_quant_tables(rac, _QUANT_RUNS[8 if bits <= 8 else 16][
                c.context_model])
        elif c.version == 2:
            rac.symbol(state, len(self.grid))
            for sx, sy, sw, sh in self.grid:
                for v in (sx, sy, sw - 1, sh - 1):
                    rac.symbol(state, v)
                for _ in range(c.plane_count):
                    rac.symbol(state, self.context_model)

    def encode(self, picture) -> bytes:
        """One frame's chunk.  ``picture``: (H, W, 3) B, G, R (alpha 255
        where the layout has one) or (H, W, 4) B, G, R, A for RGB; (H, W)
        for gray; (Y, U, V) planes for YUV (chroma ceil(H / 2^v) x
        ceil(W / 2^h))."""
        c = self.config
        key = c.gop <= 1 or self.frames % c.gop == 0
        self.frames += 1
        out = bytearray()
        for s, ((sx, sy, sw, sh), rect) in enumerate(zip(self.grid,
                                                         self.rects)):
            rac = _RacWriter()
            if s == 0:
                rac.bit(bytearray([128]), 0, int(key))
                if key:
                    self._header(rac)
            rac.one, rac.zero = self.one, self.zero
            coder = self.coders[s]
            if key:
                coder.reset()
            if c.version > 2:
                state = bytearray([128] * fp.CONTEXT_SIZE)
                for v in (sx, sy, sw - 1, sh - 1):
                    rac.symbol(state, v)
                for _ in range(c.plane_count):
                    rac.symbol(state, self.context_model)
                for v in (3, 0, 1):     # progressive, SAR 0/1
                    rac.symbol(state, v)
            pb = None
            head = b""
            if c.coder == 0:
                pb = _BitWriter()
                if c.version > 2 or s == 0:
                    head = rac.terminate(int(c.version > 2))
            self._slice(coder, rac, pb, picture, rect)
            body = head + pb.flush() if pb is not None else rac.terminate(1)
            if s or c.version > 2:
                body += len(body).to_bytes(3, "big")
            if c.ec and c.version > 2:
                body += b"\0"
                body += fp.crc32(body).to_bytes(4, "big")
            out += body
        return bytes(out)

    def _slice(self, coder: _SliceCoder, rac, pb, picture, rect) -> None:
        c = self.config
        cs, chroma, hs, vs, alpha, bits = c.spec
        x, y, w, h = rect
        if cs == 1:
            px = np.asarray(picture)
            if px.shape[-1] == 3:
                px = np.concatenate([px, np.full(px.shape[:2] + (1,), 255,
                                                 np.uint8)], -1)
            coder.rgb(rac, pb, px[y:y + h, x:x + w], alpha)
            return
        planes = [picture] if not chroma and not alpha else list(picture)
        coder.plane(rac, pb, _stored(planes[0][y:y + h, x:x + w], bits), 0,
                    bits)
        if chroma:
            cw, ch = -(-w >> hs), -(-h >> vs)
            cx, cy = x >> hs, y >> vs
            for k in (1, 2):
                coder.plane(rac, pb, _stored(
                    planes[k][cy:cy + ch, cx:cx + cw], bits), 1, bits)
        if alpha:   # ya8's alpha takes the second contexts
            coder.plane(rac, pb, _stored(planes[-1][y:y + h, x:x + w], bits),
                        2 if chroma else 1, bits)


def _stored(samples: np.ndarray, bits: int) -> np.ndarray:
    """Samples as the codec's int16 buffers hold them (16 bits wrap)."""
    v = np.asarray(samples).astype(np.int64)
    return np.where(v >= 32768, v - 65536, v) if bits == 16 else v


def _write_quant_tables(rac: _RacWriter, runs_set) -> None:
    for runs in runs_set:
        state = bytearray([128] * fp.CONTEXT_SIZE)
        for n in runs:
            rac.symbol(state, n - 1)


def extradata(config: Config) -> bytes:
    """The ``strf`` extradata of a version 2+ stream (write_extradata);
    empty for versions 0 and 1."""
    c = config
    if c.version < 2:
        return b""
    cs, chroma, hs, vs, alpha, bits = c.spec
    rac = _RacWriter()
    state = bytearray([128] * fp.CONTEXT_SIZE)
    rac.symbol(state, c.version)
    if c.version > 2:
        rac.symbol(state, c.micro_version)
    rac.symbol(state, c.coder)
    if c.coder == 2:
        for i in range(1, 256):
            rac.symbol(state, int(c.table()[i]) - fp._DEFAULT_ONE[i], True)
    rac.symbol(state, c.colorspace if c.colorspace is not None else cs)
    rac.symbol(state, bits)
    rac.bit(state, 0, int(chroma))
    rac.symbol(state, hs)
    rac.symbol(state, vs)
    rac.bit(state, 0, int(alpha))
    rac.symbol(state, c.slices[0] - 1)
    rac.symbol(state, c.slices[1] - 1)
    runs = _QUANT_RUNS[8 if bits <= 8 else 16]
    rac.symbol(state, len(runs))
    tables = [_quant_tables(r) for r in runs]
    for r in runs:
        _write_quant_tables(rac, r)
    for i, (_, contexts) in enumerate(tables):
        init = c.initial_states(contexts) if i == c.context_model else None
        rac.bit(state, 0, int(init is not None))
        if init is not None:   # each state as its difference from the one
            # of the context before, an int8 (write_extradata)
            state2 = [bytearray([128] * fp.CONTEXT_SIZE)
                      for _ in range(fp.CONTEXT_SIZE)]
            for j in range(contexts):
                for k in range(fp.CONTEXT_SIZE):
                    pred = int(init[j - 1, k]) if j else 128
                    d = (int(init[j, k]) - pred) & 255
                    rac.symbol(state2[k], d - 256 if d > 127 else d, True)
    if c.version > 2:
        rac.symbol(state, c.ec)
        if c.micro_version > 2:
            rac.symbol(state, int(c.gop < 2))
    data = rac.terminate(0)
    if c.version > 2:
        data += fp.crc32(data).to_bytes(4, "big")
    return data


def to_picture(frame_bgr: np.ndarray, layout: str):
    """Test content for ``layout`` from a BGR uint8 frame: RGB as is;
    gray8 its green channel; gray16 its green channel as the high byte and
    red as the low; YUV its green channel as Y and its blue and red
    channels, subsampled by taking the first sample of each block, as U
    and V."""
    cs, chroma, hs, vs, alpha, bits = LAYOUTS[layout]
    b, g, r = (frame_bgr[..., k] for k in range(3))
    if cs == 1:
        return frame_bgr
    if alpha and not chroma:
        return g, r
    if not chroma:
        if bits == 16:
            return g.astype(np.uint16) << 8 | r
        return g if bits <= 8 else (g.astype(np.uint16) << (bits - 8)
                                    | r >> (16 - bits))
    step_y, step_x = 1 << vs, 1 << hs
    planes = [g, b[::step_y, ::step_x], r[::step_y, ::step_x]]
    if bits > 8:
        planes = [p.astype(np.uint16) << (bits - 8) for p in planes]
    if alpha:
        planes.append(np.full_like(g, 255))
    return tuple(planes)


def write_stream_avi(path: Path, payloads: Sequence[bytes], config: Config,
                     height: int, width: int, stream: int = 0, others=(),
                     fps: int = 30, extra: Optional[bytes] = None) -> None:
    """The AVI of frames already encoded for ``config``; the extradata is
    padded to an even size, as FFmpeg's AVI muxer pads it."""
    ext = extradata(config) if extra is None else extra
    ext += b"\0" * (len(ext) & 1)
    strh, strf = video_headers(height, width, b"FFV1", 24, len(payloads),
                               max(map(len, payloads), default=0), fps,
                               compression=b"FFV1",
                               image_size=width * height * 3)
    write_avi(path, strh, strf + ext, payloads, b"dc", fps=fps,
              stream=stream, others=others)


def write_ffv1_avi(path: Path, pictures: Sequence, height: int, width: int,
                   config: Config, **kw) -> List[bytes]:
    """An AVI of ``pictures`` (as :meth:`Encoder.encode` takes them);
    returns the chunks."""
    enc = Encoder(config, height, width)
    chunks = [enc.encode(p) for p in pictures]
    write_stream_avi(path, chunks, config, height, width, **kw)
    return chunks


def stream_params(config: Config, first_chunk: bytes = b"") -> fp.Ffv1Params:
    """The decoder's parameters for a stream of ``config``."""
    return fp.params(extradata(config), first_chunk)


# --- the native encoder of cv2's layouts -----------------------------------

_ENC_SRC = Path(__file__).resolve().parent / "_torch_ffv1_enc.cpp"
_enc_lib = None


def native_encoder():
    """``tests/_torch_ffv1_enc.cpp``, built with g++ on first use into
    ``build/native/`` (as the port's native libraries are); raises
    RuntimeError where it does not build."""
    global _enc_lib
    if _enc_lib is not None:
        return _enc_lib
    from camera_linearity_tpu_torch import native
    path = native._lib_path("_ffv1_enc", _ENC_SRC)
    if not path.exists() and not native._build(path, _ENC_SRC):
        raise RuntimeError("tests/_torch_ffv1_enc.cpp did not build: "
                           f"{native.build_error('_ffv1_enc')}")
    lib = ctypes.CDLL(str(path))
    vp, sz, i = ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int
    lib.clt_ffv1_enc_new.argtypes = [i, i, i, i, i, i, i, i, i]
    lib.clt_ffv1_enc_new.restype = vp
    lib.clt_ffv1_enc_free.argtypes = [vp]
    lib.clt_ffv1_enc_frame.argtypes = [vp, vp, vp, sz, i]
    lib.clt_ffv1_enc_frame.restype = ctypes.c_int64
    _enc_lib = lib
    return lib


_NATIVE_LAYOUTS = ("bgr0", "bgra", "gray8", "gray16", "yuv420p", "yuv422p")


def native_encode(pictures, height: int, width: int, config: Config,
                  threads: int = 0) -> List[bytes]:
    """The chunks of ``pictures`` coded by the native encoder (version 3,
    ``ec`` 1, micro version 4, the layouts of ``_NATIVE_LAYOUTS``), a
    slice a thread on up to ``threads`` threads (0: every CPU).  The same
    bytes as :class:`Encoder`'s."""
    import os
    c = config
    if c.layout not in _NATIVE_LAYOUTS or c.version != 3 or c.ec != 1 or \
            c.micro_version != 4 or c.coder == 2 and c.transition is not None:
        raise ValueError(f"the native encoder writes cv2's settings only, "
                         f"not {c}")
    lib = native_encoder()
    cs, chroma, hs, vs, alpha, bits = c.spec
    handle = lib.clt_ffv1_enc_new(height, width, _NATIVE_LAYOUTS.index(
        c.layout), c.coder, c.context_model, c.slices[0], c.slices[1], c.gop,
        threads or os.cpu_count() or 1)
    try:
        out = []
        for picture in pictures:
            if cs == 1:
                px = np.asarray(picture, np.uint8)
                if px.shape[-1] == 3:
                    px = np.concatenate([px, np.full(
                        px.shape[:2] + (1,), 255, np.uint8)], -1)
                src = np.ascontiguousarray(px)
            elif not chroma:
                src = np.ascontiguousarray(picture,
                                           np.uint16 if bits > 8 else np.uint8)
            else:
                src = np.concatenate([np.ascontiguousarray(p, np.uint8)
                                      .reshape(-1) for p in picture])
            cap = src.nbytes * 2 + 4096 * c.slices[0] * c.slices[1] + 65536
            buf = np.empty(cap, np.uint8)
            n = lib.clt_ffv1_enc_frame(handle, src.ctypes.data,
                                       buf.ctypes.data, cap, 0)
            if n < 0:
                raise RuntimeError(f"the native FFV1 encoder failed ({n})")
            out.append(buf[:n].tobytes())
        return out
    finally:
        lib.clt_ffv1_enc_free(handle)
