"""Plain version of the port's FFV1 decoder (``ffv1.cpp``): the frame chunks
of an ``FFV1`` AVI into the (H, W, 3) BGR uint8 frames ``cv2.VideoCapture``
gives for them, written from RFC 9043 and FFmpeg 8's ffv1dec.c.

cv2 reads such an AVI through FFmpeg: the AVI demuxer, the ffv1 decoder
and swscale to BGR24.  A stream's parameters (:class:`Ffv1Params`) come
from the ``strf`` extradata for versions 2 and 3 (:func:`read_extradata`,
a range-coded header closed by a CRC-32 in version 3) and from the first
keyframe for versions 0 and 1 (:func:`read_keyframe_header`; every
keyframe repeats it).  A frame:

* starts with one range-coded bit, set on a keyframe;
* holds one slice (versions 0 and 1) or several, each ending, from the
  second on (version 2) or all (version 3), in a 3-byte big-endian size
  and, where the extradata's ``ec`` is set, an error byte and a CRC-32
  over the whole slice; the slices are found from the chunk's end;
* a version 3 slice opens with its header (position on the slice grid,
  each plane's quantisation table, picture structure, aspect ratio);
* codes every sample's residual after the median predictor of its left,
  top and top-left neighbours, in a context that the quantisation tables
  give from the differences of up to five neighbours (context model 0:
  three, 1: five).  The range coder (``coder`` 1, or 2 with the custom
  state-transition table of the header) codes each residual as a symbol
  in its context's 32 states; the Golomb-Rice coder (``coder`` 0) as an
  adaptive Golomb-Rice code, with a run mode in context 0;
* keeps its contexts' states, slice by slice, from one frame to the
  next; a keyframe resets them (to 128, or to the extradata's initial
  states).

Planes: YUV (colour space 0) is coded plane after plane (Y, then U and V
at the chroma size, no chroma for gray); RGB (colour space 1) line by
line as G, B - G, R - G and alpha through the JPEG 2000 reversible colour
transform, at 9 bits.  The BGR cv2 gives: RGB straight (the alpha
dropped); gray8 in all three channels; gray16 as ``min(255, (v + 128) >>
8)`` (swscale's gray16 to 8 bits, probed on all 65536 values); yuv420p,
yuv422p and yuv444p through swscale's limited-range BT.601 conversion, as
the port's rawvideo reader converts ``I420``, ``Y42B`` and a Ut Video
``ULY4`` frame's planes (``rawvideo_plain.decode_bgr``; cv2 gives a
yuv444p FFV1 frame and a ``ULY4`` frame of the same planes the same BGR).

Refused (:func:`unsupported`), before any decode: version 4 and past,
RGB or YUV of more than 8 bits, gray of other than 8 or 16 bits, YUV or
gray with alpha, yuv440p, yuv411p, yuv410p, a colour space
other than YCbCr and RGB (Bayer or reserved; FFmpeg reads none), ``ec``
2 (CRCs of another start) and, given the geometry, a slice grid whose
last slices leave a chroma row or column undecoded.  A frame
raises :class:`Ffv1Error`, naming it and its slice, where FFmpeg would
conceal an error or give memory it never wrote: a slice whose CRC fails,
a slice whose size runs past the chunk, a slice header out of range,
data that end before the slice's samples, a slice that leaves the last
chroma row or column undecoded (:func:`chroma_gap`), and a first frame
that is no keyframe.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import numpy as np

from .rawvideo_plain import decode_bgr as _raw_bgr

__all__ = ["FFV1_FOURCCS", "CODERS", "Ffv1Error", "Ffv1Params", "crc32",
           "read_extradata", "read_keyframe_header", "params",
           "unsupported", "chroma_gap", "layout_name", "yuv_layout",
           "slice_rects", "Decoder", "gray16_to_8", "to_bgr", "decode_bgr",
           "LOG2_RUN", "CONTEXT_SIZE"]

FFV1_FOURCCS = ("FFV1",)
CODERS = ("golomb", "range", "range custom")
GOLOMB, RANGE, RANGE_CUSTOM = 0, 1, 2
CONTEXT_SIZE = 32
MAX_QUANT_TABLES = 8
MAX_SLICES = 1024
# ff_log2_run: the run lengths' exponents of the Golomb-Rice run mode
LOG2_RUN = (0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2, 2, 3, 3, 3, 3, 4, 4, 5, 5, 6, 6,
            7, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21, 22,
            23, 24)


class Ffv1Error(ValueError):
    """An FFV1 stream or frame the decoder does not read."""


def _build_states(factor: int = int(0.05 * (1 << 32)), max_p: int = 248
                  ) -> Tuple[List[int], List[int]]:
    """ff_build_rac_states: the default (one, zero) state transitions."""
    one = 1 << 32
    one_state, zero_state = [0] * 256, [0] * 256
    last_p8, p = 0, one // 2
    for _ in range(128):
        p8 = (256 * p + one // 2) >> 32
        if p8 <= last_p8:
            p8 = last_p8 + 1
        if last_p8 and last_p8 < 256 and p8 <= max_p:
            one_state[last_p8] = p8
        p += ((one - p) * factor + one // 2) >> 32
        last_p8 = p8
    for i in range(256 - max_p, max_p + 1):
        if one_state[i]:
            continue
        p = (i * one + 128) >> 8
        p += ((one - p) * factor + one // 2) >> 32
        p8 = (256 * p + one // 2) >> 32
        if p8 <= i:
            p8 = i + 1
        one_state[i] = min(p8, max_p)
    for i in range(1, 255):
        zero_state[i] = 256 - one_state[256 - i]
    return one_state, zero_state


_DEFAULT_ONE, _DEFAULT_ZERO = _build_states()


def _tables(transition) -> Tuple[List[int], List[int]]:
    """(one, zero) transitions: the default ones, or a custom table's."""
    if transition is None:
        return _DEFAULT_ONE, _DEFAULT_ZERO
    one, zero = list(_DEFAULT_ONE), list(_DEFAULT_ZERO)
    for j in range(1, 256):
        one[j] = int(transition[j])
        zero[256 - j] = 256 - one[j]
    return one, zero


def _crc_table() -> List[int]:
    table = []
    for i in range(256):
        c = i << 24
        for _ in range(8):
            c = ((c << 1) ^ 0x04C11DB7 if c & 0x80000000 else c << 1) \
                & 0xFFFFFFFF
        table.append(c)
    return table


_CRC = _crc_table()


def crc32(data, crc: int = 0) -> int:
    """FFmpeg's AV_CRC_32_IEEE: CRC-32 of polynomial 0x04C11DB7, most
    significant bit first, from ``crc``, no final xor.  A slice or an
    extradata whose last four bytes hold its CRC (big-endian) gives the
    start value."""
    for b in bytes(data):
        crc = ((crc << 8) & 0xFFFFFFFF) ^ _CRC[(crc >> 24) ^ b]
    return crc


class _Rac:
    """FFmpeg's range decoder (rangecoder.h) over ``data[start:end]``;
    bytes past the end read as none (``overread`` counts them)."""

    def __init__(self, data, start: int, end: int, one=None, zero=None):
        self.data = data
        self.start, self.end = start, end
        self.low = (data[start] << 8 | data[start + 1]) \
            if end - start >= 2 else 0
        self.pos = start + 2
        self.range = 0xFF00
        self.overread = 0
        if self.low >= 0xFF00:
            self.low, self.end = 0xFF00, self.pos
        self.one = one or _DEFAULT_ONE
        self.zero = zero or _DEFAULT_ZERO

    def bit(self, state, i: int) -> int:
        s = state[i]
        r1 = (self.range * s) >> 8
        rng = self.range - r1
        if self.low < rng:
            state[i] = self.zero[s]
            bit = 0
        else:
            self.low -= rng
            state[i] = self.one[s]
            rng = r1
            bit = 1
        if rng < 0x100:
            rng <<= 8
            self.low <<= 8
            if self.pos < self.end:
                self.low += self.data[self.pos]
                self.pos += 1
            else:
                self.overread += 1
        self.range = rng
        return bit

    def symbol(self, state, signed: bool = False) -> int:
        """get_symbol: 0, or an exponent, mantissa and sign coded in the
        32 states of ``state``."""
        bit = self.bit
        if bit(state, 0):
            return 0
        e = 0
        while bit(state, 1 + min(e, 9)):
            e += 1
            if e > 31:
                raise Ffv1Error("a symbol of more than 32 bits")
        a = 1
        for i in range(e - 1, -1, -1):
            a += a + bit(state, 22 + min(i, 9))
        if signed and bit(state, 11 + min(e, 10)):
            return -a
        return a


class _Bits:
    """The Golomb-Rice coder's bit reader: most significant bit first,
    bits past the end read as zeros."""

    def __init__(self, data, start: int, end: int):
        self.data, self.start, self.end = data, start, end
        self.pos = start * 8
        self.limit = end * 8

    def left(self) -> int:
        return self.limit - self.pos

    def get(self, n: int) -> int:
        v = 0
        data, pos, end = self.data, self.pos, self.end
        for _ in range(n):
            byte = pos >> 3
            b = (data[byte] >> (7 - (pos & 7))) & 1 if byte < end else 0
            v = v << 1 | b
            pos += 1
        self.pos = pos
        return v

    def golomb(self, k: int, esc_len: int) -> int:
        """get_ur_golomb with limit 12, then the signed fold of
        get_sr_golomb."""
        q = 0
        while q < 12 and not self.get(1):
            q += 1
        if q < 12:
            v = (q << k) + (self.get(k) if k else 0)
        else:
            v = self.get(esc_len) + 11
        return (v >> 1) ^ -(v & 1)


class Ffv1Params(NamedTuple):
    """A stream's global header: version (and micro version), coder
    (``CODERS``), the custom state-transition table (256 entries, or
    None), colour space (0 YUV, 1 RGB), bits a sample, chroma planes,
    chroma shifts, alpha, the slice grid, the quantisation tables
    (``quant_tables[i]``: (5, 256) int) with their context counts, each
    table's initial states ((contexts, 32) uint8, or None for 128), the
    error-check flag ``ec`` and the planes that carry contexts."""
    version: int
    micro_version: int
    coder: int
    transition: Optional[np.ndarray]
    colorspace: int
    bits: int
    chroma_planes: bool
    h_shift: int
    v_shift: int
    transparency: bool
    num_h_slices: int
    num_v_slices: int
    quant_tables: Tuple[np.ndarray, ...]
    context_counts: Tuple[int, ...]
    initial_states: Tuple[Optional[np.ndarray], ...]
    ec: int
    plane_count: int

    @property
    def combined_version(self) -> int:
        return self.version << 16 | self.micro_version


def _read_quant_table(rac: _Rac, scale: int) -> Tuple[List[int], int]:
    state = bytearray([128] * CONTEXT_SIZE)
    table = [0] * 256
    i = v = 0
    while i < 128:
        n = rac.symbol(state) + 1
        if n > 128 - i:
            raise Ffv1Error("a quantisation table of more than 128 entries")
        for _ in range(n):
            table[i] = scale * v
            i += 1
        v += 1
    for i in range(1, 128):
        table[256 - i] = -table[i]
    table[128] = -table[127]
    return table, 2 * v - 1


def _read_quant_tables(rac: _Rac) -> Tuple[np.ndarray, int]:
    tables, count = [], 1
    for _ in range(5):
        table, n = _read_quant_table(rac, count)
        tables.append(table)
        count *= n
        if count > 32768:
            raise Ffv1Error("more than 32768 contexts")
    return np.array(tables, np.int32), (count + 1) // 2


def _plane_count(version: int, chroma_planes: bool, alpha: bool) -> int:
    return 1 + (chroma_planes or version < 4) + alpha


def read_extradata(extra: bytes) -> Ffv1Params:
    """The global header of a version 2, 3 or 4 stream from its ``strf``
    extradata (read_extra_header); raises :class:`Ffv1Error` for a CRC that
    fails (version 3 and past: the last four bytes close a CRC-32 over the
    whole, from 0) or a header out of range.  A header of ``ec`` 2, whose
    CRCs start elsewhere, is returned unchecked; :func:`unsupported` names
    it."""
    data = bytes(extra)
    crc_ok = len(data) >= 4 and crc32(data) == 0
    try:
        p = _read_extradata(data)
    except Ffv1Error:
        if not crc_ok and _Rac(data, 0, len(data)).symbol(
                bytearray([128] * CONTEXT_SIZE)) > 2:
            raise Ffv1Error("the extradata's CRC fails") from None
        raise
    if p.version > 2 and not crc_ok and p.ec != 2:
        raise Ffv1Error("the extradata's CRC fails")
    return p


def _read_extradata(data: bytes) -> Ffv1Params:
    if len(data) < 2:
        raise Ffv1Error("no FFV1 extradata")
    rac = _Rac(data, 0, len(data))
    state = bytearray([128] * CONTEXT_SIZE)
    version = rac.symbol(state)
    if version < 2:
        raise Ffv1Error(f"version {version} in the extradata")
    micro = 0
    if version > 2:
        rac.end -= 4
        micro = rac.symbol(state)
    coder = rac.symbol(state)
    transition = None
    if coder == RANGE_CUSTOM:
        transition = np.zeros(256, np.uint8)
        for i in range(1, 256):
            transition[i] = (rac.symbol(state, True) + _DEFAULT_ONE[i]) & 255
    colorspace = rac.symbol(state)
    bits = rac.symbol(state)
    chroma_planes = bool(rac.bit(state, 0))
    h_shift = rac.symbol(state)
    v_shift = rac.symbol(state)
    alpha = bool(rac.bit(state, 0))
    num_h = 1 + rac.symbol(state)
    num_v = 1 + rac.symbol(state)
    if h_shift > 4 or v_shift > 4:
        raise Ffv1Error(f"chroma shifts {h_shift}, {v_shift}")
    count = rac.symbol(state)
    if not 0 < count <= MAX_QUANT_TABLES:
        raise Ffv1Error(f"{count} quantisation tables")
    tables, contexts = [], []
    for _ in range(count):
        t, n = _read_quant_tables(rac)
        tables.append(t)
        contexts.append(n)
    initial = []
    state2 = [bytearray([128] * CONTEXT_SIZE) for _ in range(CONTEXT_SIZE)]
    for i in range(count):
        states = None
        if rac.bit(state, 0):
            states = np.zeros((contexts[i], CONTEXT_SIZE), np.uint8)
            for j in range(contexts[i]):
                for k in range(CONTEXT_SIZE):
                    pred = int(states[j - 1, k]) if j else 128
                    states[j, k] = (pred + rac.symbol(state2[k], True)) & 255
        initial.append(states)
    ec = 0
    if version > 2:
        ec = rac.symbol(state)
        if micro > 2:
            rac.symbol(state)   # intra: every frame a keyframe
    return Ffv1Params(version, micro, coder, transition, colorspace, bits,
                      chroma_planes, h_shift, v_shift, alpha, num_h, num_v,
                      tuple(tables), tuple(contexts), tuple(initial), ec,
                      _plane_count(version, chroma_planes, alpha))


def _read_v01_header(rac: _Rac) -> Ffv1Params:
    """read_header of a version 0 or 1 keyframe, from ``rac`` just past
    the keyframe bit."""
    state = bytearray([128] * CONTEXT_SIZE)
    version = rac.symbol(state)
    if version >= 2:
        raise Ffv1Error(f"version {version} in a keyframe header")
    coder = rac.symbol(state)
    transition = None
    if coder == RANGE_CUSTOM:
        transition = np.zeros(256, np.uint8)
        for i in range(1, 256):
            st = rac.symbol(state, True) + rac.one[i]
            if not 1 <= st <= 255:
                raise Ffv1Error(f"state transition {st}")
            transition[i] = st
    colorspace = rac.symbol(state)
    bits = rac.symbol(state) if version > 0 else 8
    chroma_planes = bool(rac.bit(state, 0))
    h_shift = rac.symbol(state)
    v_shift = rac.symbol(state)
    alpha = bool(rac.bit(state, 0))
    if h_shift > 4 or v_shift > 4:
        raise Ffv1Error(f"chroma shifts {h_shift}, {v_shift}")
    table, contexts = _read_quant_tables(rac)
    return Ffv1Params(version, 0, coder, transition, colorspace, bits,
                      chroma_planes, h_shift, v_shift, alpha, 1, 1, (table,),
                      (contexts,), (None,), 0, 2 + alpha)


def read_keyframe_header(chunk) -> Ffv1Params:
    """The global header of a version 0 or 1 stream from a keyframe's
    chunk; raises :class:`Ffv1Error` where the chunk is no keyframe."""
    data = bytes(chunk)
    if len(data) < 2:
        raise Ffv1Error("an empty frame")
    rac = _Rac(data, 0, len(data))
    if not rac.bit(bytearray([128]), 0):
        raise Ffv1Error("the first frame is no keyframe")
    return _read_v01_header(rac)


def params(extra: bytes, first_chunk=None) -> Ffv1Params:
    """A stream's :class:`Ffv1Params`: from its extradata where that holds
    a version 2+ header, else from its first frame's keyframe header
    (``first_chunk``: the chunk, or a callable that reads it, called only
    for such a stream)."""
    if len(extra) >= 2 and _Rac(bytes(extra), 0, len(extra)).symbol(
            bytearray([128] * CONTEXT_SIZE)) >= 2:
        return read_extradata(extra)
    if callable(first_chunk):
        first_chunk = first_chunk()
    if first_chunk is None:
        raise Ffv1Error("a version 0/1 stream needs its first frame")
    return read_keyframe_header(first_chunk)


_YUV = {(1, 1): "yuv420p", (1, 0): "yuv422p", (0, 0): "yuv444p",
        (0, 1): "yuv440p", (2, 0): "yuv411p", (2, 2): "yuv410p"}


def layout_name(p: Ffv1Params) -> str:
    """The pixel format FFmpeg decodes the stream to (e.g. ``"bgr0"``,
    ``"gray16"``, ``"yuv420p"``), with the version and coder."""
    if p.colorspace == 1:
        fmt = ("bgra" if p.transparency else "bgr0") if p.bits <= 8 else \
            f"rgb{'a' * p.transparency} {p.bits}-bit"
    elif p.colorspace == 0 and not p.chroma_planes:
        fmt = ("gray" if p.bits <= 8 else f"gray{p.bits}") + \
            "a" * p.transparency
    elif p.colorspace == 0:
        fmt = _YUV.get((p.h_shift, p.v_shift),
                       f"yuv shifts {p.h_shift},{p.v_shift}")
        fmt = fmt.replace("yuv", "yuva") if p.transparency else fmt
        if p.bits > 8:
            fmt += f" {p.bits}-bit"
    else:
        fmt = f"colour space {p.colorspace}"
    return f"{fmt}, version {p.version}, {CODERS[p.coder]} coder" \
        if p.coder < len(CODERS) else f"{fmt}, version {p.version}"


def chroma_gap(p: Ffv1Params, height: int, width: int, rect) -> bool:
    """Whether a slice at the bottom or the right edge leaves the last
    chroma row or column undecoded (its luma starts at an odd row or
    column of an odd height or width): FFmpeg gives memory it never wrote
    there, and its encoder picks no such slice grid."""
    if not p.chroma_planes or p.colorspace != 0:
        return False
    x, y, w, h = rect
    return (x + w == width and (x >> p.h_shift) + (-(-w >> p.h_shift))
            < -(-width >> p.h_shift)) or \
        (y + h == height and (y >> p.v_shift) + (-(-h >> p.v_shift))
         < -(-height >> p.v_shift))


def unsupported(p: Ffv1Params, height: Optional[int] = None,
                width: Optional[int] = None) -> Optional[str]:
    """What of a stream the port's decoder does not read, or None; with
    the geometry, also a slice grid whose last slices leave a chroma row
    or column undecoded (:func:`chroma_gap`)."""
    if p.version > 3:
        return f"version {p.version}"
    if p.coder > RANGE_CUSTOM:
        return f"coder {p.coder}"
    if p.ec > 1:
        return f"error correction {p.ec} (CRCs of another start)"
    if p.colorspace not in (0, 1):
        return (f"colour space {p.colorspace} (neither YCbCr nor RGB: Bayer "
                "or reserved)")
    bits = p.bits or 8
    if p.colorspace == 1:
        if p.h_shift or p.v_shift:
            return "RGB with chroma subsampling"
        if bits > 8:
            return f"{bits}-bit RGB"
        return None
    if not p.chroma_planes:
        if p.transparency:
            return "gray with alpha"
        if bits not in (8, 16) and bits > 8:
            return f"{bits}-bit gray"
        return None
    fmt = _YUV.get((p.h_shift, p.v_shift),
                   f"chroma shifts {p.h_shift}, {p.v_shift}")
    if p.transparency:
        return f"{fmt} with alpha"
    if bits > 8:
        return f"{bits}-bit {fmt}"
    if fmt not in ("yuv420p", "yuv422p", "yuv444p"):
        return fmt
    if height is not None and p.version >= 2 and chroma_gap(
            p, height, width, slice_rects(p, height, width, [(
                p.num_h_slices - 1, p.num_v_slices - 1, 1, 1)])[0]):
        return (f"a {p.num_h_slices} x {p.num_v_slices} slice grid that "
                f"leaves the last chroma row or column of {height} x "
                f"{width} undecoded")
    return None


def yuv_layout(p: Ffv1Params) -> Optional[str]:
    """The rawvideo layout a YUV stream's planes convert as (``"i420"``,
    ``"yuv422p"`` or ``"yuv444p"``); None for RGB and gray."""
    if p.colorspace != 0 or not p.chroma_planes:
        return None
    return {(1, 1): "i420", (1, 0): "yuv422p", (0, 0): "yuv444p"}.get(
        (p.h_shift, p.v_shift))


def _coord(size: int, n: int, k: int) -> int:
    return size * k // n


def slice_rects(p: Ffv1Params, height: int, width: int, positions
                ) -> List[Tuple[int, int, int, int]]:
    """(x, y, w, h) of each slice from its grid position (sx, sy, sw, sh)
    (ff_slice_coord before version 4.3: ``size * s // n``)."""
    out = []
    for sx, sy, sw, sh in positions:
        x, y = _coord(width, p.num_h_slices, sx), \
            _coord(height, p.num_v_slices, sy)
        out.append((x, y, _coord(width, p.num_h_slices, sx + sw) - x,
                    _coord(height, p.num_v_slices, sy + sh) - y))
    return out


class SliceState:
    """The contexts one slice carries from frame to frame: per plane its
    quantisation table, and its range-coder states (a bytearray of 32 a
    context) or Golomb-Rice states ([drift, error_sum, bias, count] a
    context)."""

    def __init__(self):
        self.tables: List[int] = []
        self.states: List[list] = []
        self.vlc: List[list] = []

    def reset(self, p: Ffv1Params) -> None:
        self.states, self.vlc = [], []
        for idx in self.tables:
            n = p.context_counts[idx]
            init = p.initial_states[idx]
            self.states.append(
                [bytearray(init[j].tobytes()) if init is not None else
                 bytearray([128] * CONTEXT_SIZE) for j in range(n)])
            self.vlc.append([[0, 4, 0, 1] for _ in range(n)])


def _fold(v: int, bits: int) -> int:
    m = 1 << bits
    v &= m - 1
    return v - m if v >= m >> 1 else v


class _Slice:
    """One slice of one frame: its coder, rectangle and states."""

    def __init__(self, p: Ffv1Params, rac: _Rac, bits: Optional[_Bits],
                 state: SliceState, rect, quant):
        self.p, self.rac, self.bits, self.state = p, rac, bits, state
        self.quant = quant    # the tables as lists of ints
        self.x, self.y, self.w, self.h = rect
        self.run_index = 0

    def _end(self) -> bool:
        if self.bits is None:
            return self.rac.overread > 2
        return self.bits.left() < 1

    def line(self, cur: list, prev: list, plane: int, bits: int,
             w: int) -> None:
        """decode_line: ``cur``/``prev`` are sample rows with 3 entries of
        padding a side (index x + 3); ``cur`` still holds the row two up,
        the context's TT."""
        q0, q1, q2, q3, q4 = self.quant[self.state.tables[plane]]
        five = bool(q3[127] or q4[127])
        golomb = self.bits is not None
        rac, states = self.rac, self.state.states[plane]
        vlc = self.state.vlc[plane]
        mask, wrap = (1 << bits) - 1, bits == 16
        if self._end():
            raise Ffv1Error("its data end before its samples")
        run_mode = run_count = 0
        run_index = self.run_index
        x = 0
        while x < w:
            if not x & 1023 and self._end():
                raise Ffv1Error("its data end before its samples")
            i = x + 3
            L, T, LT, RT = cur[i - 1], prev[i], prev[i - 1], prev[i + 1]
            ctx = q0[(L - LT) & 0xFF] + q1[(LT - T) & 0xFF] + \
                q2[(T - RT) & 0xFF]
            if five:
                ctx += q3[(cur[i - 2] - L) & 0xFF] + q4[(cur[i] - T) & 0xFF]
            sign = ctx < 0
            if sign:
                ctx = -ctx
            if not golomb:
                diff = rac.symbol(states[ctx], True)
            else:
                if ctx == 0 and run_mode == 0:
                    run_mode = 1
                if run_mode:
                    if run_count == 0 and run_mode == 1:
                        if self.bits.get(1):
                            run_count = 1 << LOG2_RUN[run_index]
                            if x + run_count <= w:
                                run_index += 1
                        else:
                            n = LOG2_RUN[run_index]
                            run_count = self.bits.get(n) if n else 0
                            if run_index:
                                run_index -= 1
                            run_mode = 2
                    run_count -= 1
                    if run_count < 0:
                        run_mode = run_count = 0
                        diff = self._vlc(vlc[ctx], bits)
                        if diff >= 0:
                            diff += 1
                    else:
                        diff = 0
                else:
                    diff = self._vlc(vlc[ctx], bits)
            if sign:
                diff = -diff
            a, b, c = L, L + T - LT, T     # mid_pred(L, L + T - LT, T)
            if a > b:
                a, b = b, a
            pred = b if b < c else (a if a > c else c)
            v = (pred + diff) & mask
            cur[i] = v - 65536 if wrap and v >= 32768 else v
            x += 1
        self.run_index = run_index

    def _vlc(self, st: list, bits: int) -> int:
        """get_vlc_symbol and update_vlc_state; ``st`` is [drift,
        error_sum, bias, count]."""
        drift, error_sum, bias, count = st
        k, i = 0, count
        while i < error_sum:
            k += 1
            i += i
        v = self.bits.golomb(k, bits)
        if (2 * drift + count) < 0:
            v = ~v
        ret = _fold(v + bias, bits)
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
        return ret

    def plane(self, w: int, h: int, plane: int, bits: int) -> np.ndarray:
        """decode_plane: a (h, w) plane of one context set."""
        rows = [[0] * (w + 6), [0] * (w + 6)]
        out = np.empty((h, w), np.int64)
        self.run_index = 0
        for y in range(h):
            rows[0], rows[1] = rows[1], rows[0]
            prev, cur = rows
            cur[2] = prev[3]
            prev[w + 3] = prev[w + 2]
            self.line(cur, prev, plane, bits, w)
            out[y] = cur[3:w + 3]
        return out & ((1 << bits) - 1)

    def rgb(self, w: int, h: int, alpha: bool) -> np.ndarray:
        """decode_rgb_frame at 8 bits: (h, w, 4) B, G, R, A."""
        planes = 4 if alpha else 3
        rows = [[[0] * (w + 6), [0] * (w + 6)] for _ in range(4)]
        out = np.zeros((h, w, 4), np.uint8)
        self.run_index = 0
        for y in range(h):
            for k in range(planes):
                r = rows[k]
                r[0], r[1] = r[1], r[0]
                prev, cur = r
                cur[2] = prev[3]
                prev[w + 3] = prev[w + 2]
                self.line(cur, prev, (k + 1) // 2, 9, w)
            g = np.array(rows[0][1][3:w + 3], np.int64)
            b = np.array(rows[1][1][3:w + 3], np.int64) - 256
            r = np.array(rows[2][1][3:w + 3], np.int64) - 256
            a = np.array(rows[3][1][3:w + 3], np.int64)
            g -= (b + r) >> 2
            b += g
            r += g
            word = (b + (g << 8) + (r << 16) + (a << 24)) & 0xFFFFFFFF
            out[y] = word.astype("<u4").view(np.uint8).reshape(w, 4)
        return out


class Decoder:
    """One stream's decoder: the state each slice carries from frame to
    frame lives here, so frames are decoded in order, from a keyframe."""

    def __init__(self, p: Ffv1Params, height: int, width: int):
        why = unsupported(p, height, width)
        if why:
            raise Ffv1Error(f"an FFV1 layout the decoder does not read: {why}"
                            f" ({layout_name(p)})")
        self.p, self.height, self.width = p, height, width
        self.one, self.zero = _tables(p.transition)
        self.quant = [[list(map(int, row)) for row in t]
                      for t in p.quant_tables]
        self.slices: List[SliceState] = []
        self.rects: List[Tuple[int, int, int, int]] = []
        self.keyframe_seen = False
        self.frames = 0

    def _find_slices(self, data: bytes, frame: int
                     ) -> List[Tuple[int, int]]:
        """(start, end) of each slice, walked from the chunk's end: version
        2's slices after the first end in their 3-byte size, version 3's
        all in their trailer (size, and error byte and CRC with ``ec``)."""
        p = self.p
        if p.version <= 1:
            return [(0, len(data))]
        trailer = 3 + 5 * bool(p.ec)
        spans, end = [], len(data)

        def size_at(end: int, slice_no) -> int:
            size = int.from_bytes(data[end - trailer:end - trailer + 3],
                                  "big") + trailer if end >= trailer else -1
            if not 0 <= size <= end:
                raise Ffv1Error(f"frame {frame}: {slice_no}: its size runs "
                                "past the chunk")
            return size
        if p.version == 2:
            for s in range(len(self.slices) - 1, 0, -1):
                size = size_at(end, f"slice {s}")
                spans.append((end - size, end))
                end -= size
            spans.append((0, end))
        else:
            while end > trailer:
                try:
                    size = size_at(end, "the last slice")
                except Ffv1Error:
                    if spans:   # FFmpeg's count of slices stops here
                        break
                    raise
                spans.append((end - size, end))
                end -= size
                if len(spans) > MAX_SLICES:
                    raise Ffv1Error(f"frame {frame}: more than {MAX_SLICES} "
                                    "slices")
            if not spans or end:
                raise Ffv1Error(f"frame {frame}: slice 0: its size runs past "
                                "the chunk")
        return spans[::-1]

    def decode(self, chunk) -> np.ndarray:
        """The next frame: (H, W, 4) B, G, R, A for RGB, else its planes
        ``[Y]`` or ``[Y, U, V]`` (uint16 for gray16, uint8 otherwise)."""
        data = bytes(chunk)
        frame, p = self.frames, self.p
        self.frames += 1
        if len(data) < 2:
            raise Ffv1Error(f"frame {frame}: an empty chunk")
        rac0 = _Rac(data, 0, len(data))
        key = rac0.bit(bytearray([128]), 0)
        if key:
            if p.version <= 1:
                h = _read_v01_header(rac0)
                if (h.colorspace, h.bits, h.chroma_planes, h.h_shift,
                        h.v_shift, h.transparency) != (
                        p.colorspace, p.bits, p.chroma_planes, p.h_shift,
                        p.v_shift, p.transparency):
                    raise Ffv1Error(f"frame {frame}: a keyframe header that "
                                    "changes the stream's layout")
                p = self.p = h
                self.one, self.zero = _tables(p.transition)
                self.quant = [[list(map(int, row)) for row in t]
                              for t in p.quant_tables]
                self.slices = [SliceState()]
                self.slices[0].tables = [0] * p.plane_count
                self.rects = [(0, 0, self.width, self.height)]
            elif p.version == 2:
                self._v2_layout(rac0)
            self.keyframe_seen = True
        elif not self.keyframe_seen:
            raise Ffv1Error(f"frame {frame}: the first frame is no keyframe")
        spans = self._find_slices(data, frame)
        if p.version == 3:
            if key:
                self.slices = [SliceState() for _ in spans]
            elif len(spans) != len(self.slices):
                raise Ffv1Error(f"frame {frame}: {len(spans)} slices, the "
                                f"keyframe had {len(self.slices)}")
        planes = self._planes()
        for s, (start, end) in enumerate(spans):
            try:
                self._slice(data, s, start, end, rac0, key, planes)
            except Ffv1Error as exc:
                if str(exc).startswith("frame "):
                    raise
                raise Ffv1Error(f"frame {frame}: slice {s}: {exc}") from exc
        return planes

    def _v2_layout(self, rac: _Rac) -> None:
        p, state = self.p, bytearray([128] * CONTEXT_SIZE)
        count = rac.symbol(state)
        if not 0 < count <= p.num_h_slices * p.num_v_slices:
            raise Ffv1Error(f"a keyframe of {count} slices")
        self.slices, positions = [], []
        for _ in range(count):
            pos = (rac.symbol(state), rac.symbol(state),
                   rac.symbol(state) + 1, rac.symbol(state) + 1)
            self._check_grid(pos)
            positions.append(pos)
            st = SliceState()
            for _ in range(p.plane_count):
                idx = rac.symbol(state)
                if idx >= len(p.quant_tables):
                    raise Ffv1Error("a quantisation table index out of range")
                st.tables.append(idx)
            self.slices.append(st)
        self.rects = slice_rects(p, self.height, self.width, positions)

    def _check_grid(self, pos) -> None:
        sx, sy, sw, sh = pos
        if sx > self.p.num_h_slices - sw or sy > self.p.num_v_slices - sh:
            raise Ffv1Error(f"a slice at {sx}, {sy} of {sw} x {sh} outside "
                            f"the {self.p.num_h_slices} x "
                            f"{self.p.num_v_slices} grid")

    def _planes(self):
        p, h, w = self.p, self.height, self.width
        if p.colorspace == 1:
            return np.zeros((h, w, 4), np.uint8)
        dt = np.uint16 if p.bits > 8 else np.uint8
        planes = [np.zeros((h, w), dt)]
        if p.chroma_planes:
            ch, cw = -(-h >> p.v_shift), -(-w >> p.h_shift)
            planes += [np.zeros((ch, cw), dt), np.zeros((ch, cw), dt)]
        return planes

    def _slice(self, data, s: int, start: int, end: int, rac0: _Rac,
               key: bool, planes) -> None:
        p = self.p
        if p.ec and crc32(data[start:end]):
            raise Ffv1Error("its CRC fails")
        if s == 0:
            rac = rac0
            rac.end = end
        else:
            rac = _Rac(data, start, end)
        rac.one, rac.zero = self.one, self.zero
        state = self.slices[s]
        if p.version == 3:
            hs = bytearray([128] * CONTEXT_SIZE)
            pos = (rac.symbol(hs), rac.symbol(hs), rac.symbol(hs) + 1,
                   rac.symbol(hs) + 1)
            self._check_grid(pos)
            rect = slice_rects(p, self.height, self.width, [pos])[0]
            tables = []
            for _ in range(p.plane_count):
                idx = rac.symbol(hs)
                if idx >= len(p.quant_tables):
                    raise Ffv1Error("a quantisation table index out of range")
                tables.append(idx)
            if not key and tables != state.tables:
                raise Ffv1Error("a quantisation table that changes between "
                                "keyframes")
            state.tables = tables
            rac.symbol(hs)                       # picture structure
            rac.symbol(hs), rac.symbol(hs)       # sample aspect ratio
        else:
            rect = self.rects[s]
        if chroma_gap(p, self.height, self.width, rect):
            raise Ffv1Error("it leaves the last chroma row or column "
                            "undecoded")
        if key:
            state.reset(p)
        x, y, w, h = rect
        bits = None
        if p.coder == GOLOMB:
            if p.combined_version >= 0x30002:
                rac.bit(bytearray([129]), 0)
            skip = rac.pos - start - 1 if p.version > 2 or (x == 0 and y == 0) \
                else 0
            bits = _Bits(data, start + skip, end)
        sl = _Slice(p, rac, bits, state, rect, self.quant)
        if w <= 0 or h <= 0:
            return
        if p.colorspace == 1:
            planes[y:y + h, x:x + w] = sl.rgb(w, h, p.transparency)
            return
        depth = p.bits if p.bits > 8 else 8
        planes[0][y:y + h, x:x + w] = sl.plane(w, h, 0, depth)
        if p.chroma_planes:
            cw, ch = -(-w >> p.h_shift), -(-h >> p.v_shift)
            cx, cy = x >> p.h_shift, y >> p.v_shift
            for k in (1, 2):
                planes[k][cy:cy + ch, cx:cx + cw] = sl.plane(cw, ch, 1, depth)


def gray16_to_8(v: np.ndarray) -> np.ndarray:
    """swscale's gray16 -> 8 bits as cv2 gets BGR from a gray16 frame."""
    return np.minimum(255, (v.astype(np.int32) + 128) >> 8).astype(np.uint8)


def to_bgr(p: Ffv1Params, planes, height: int, width: int) -> np.ndarray:
    """The (H, W, 3) BGR frame cv2 gives for a decoded picture."""
    if p.colorspace == 1:
        return np.ascontiguousarray(planes[..., :3])
    if not p.chroma_planes:
        y = planes[0] if p.bits <= 8 else gray16_to_8(planes[0])
        return np.repeat(y[..., None], 3, -1)
    raw = b"".join(np.ascontiguousarray(c).tobytes() for c in planes)
    return _raw_bgr(raw, yuv_layout(p), height, width)


def decode_bgr(chunks, p: Ffv1Params, height: int,
               width: int) -> np.ndarray:
    """The (n, H, W, 3) BGR frames of a stream's chunks, from its first
    (a keyframe), as cv2 gives them."""
    dec = Decoder(p, height, width)
    return np.stack([to_bgr(dec.p, dec.decode(c), height, width)
                     for c in chunks])
