"""Plain version of the port's Lagarith decoder (``lagarith.cpp``): one
frame chunk of a Lagarith (``LAGS``) AVI into its planes and into the
(H, W, 3) BGR uint8 frame ``cv2.VideoCapture`` gives for it.

cv2 reads such an AVI through FFmpeg 8: the AVI demuxer, the lagarith
decoder (lagarith.c, lagarithrac.c) and swscale to BGR24.  Every frame is
intra, and its first byte is its type (``FRAME_TYPES``), so the layout can
change from frame to frame:

* 2 (unaligned RGB24), 4 (RGB24) and 8 (RGBA): after the type, the
  little-endian offsets of the G plane and of the R - G plane (and, for
  RGBA, of the A plane); the B - G plane starts right after them (byte 9,
  or 13).  The planes are coded bottom-up, the first coded row being the
  picture's last; B and R are their planes plus G, mod 256; A is decoded
  and dropped (cv2 gives BGR);
* 3 (YUY2, yuv422p) and 10 (YV12, yuv420p): after the type, the offsets
  of the U and V planes (YV12: of V, then U); Y starts at byte 9.  The
  planes are coded top-down, chroma ``(width + 1) // 2`` wide (and
  ``(height + 1) // 2`` high for YV12), and convert to BGR as the port's
  rawvideo reader converts ``yuv422p`` and ``i420`` planes (swscale's
  limited-range BT.601; ``rawvideo_plain.decode_bgr``);
* 5 (solid grey: byte 1 in every channel), 6 (solid colour: bytes 1-3
  are B, G and R) and 9 (solid RGBA: bytes 1-4 are B, G, R and A).

A plane starts with its escape byte:

* 0-3: range coded.  For 1-3 a 32-bit length follows, which FFmpeg takes
  (and skips) only where it is below the plane's sample count.  Then the
  probability header, read most significant bit first: 256 counts, each
  as a Fibonacci code of its bit length (terminated by two ones, at most
  seven bits) and the bits below its top one; a zero count is followed
  by the number of zero counts after it.  Counts whose total is not a
  power of two are scaled to the next power of two with FFmpeg's
  soft-float reciprocal, and the rest handed out one at a time to the
  nonzero counts of symbols 0-127 in order (:func:`scale_probs`).  The
  range coder starts at the next byte and reads its bits eight at a
  time; at the end of the chunk it reads the last bytes again (the
  chunk's padding is zero) and FFmpeg fails the plane where that has
  happened more than four times when a row starts.  With escape ``e`` >
  0, ``e`` zero symbols in a row are followed by a symbol ``x`` that adds
  ``(x * 2) ^ (x >> 7)`` (``x`` as int8) more zeros; runs cross rows;
* 4: stored raw; 5-7: zero runs without the range coder (FFmpeg's
  ``lag_decode_zero_run_line``, followed line by line with its quirks);
* 0xff: the plane is the value in the next byte (no prediction).

Every plane but a filled one is then predicted: the first row from the
left (a running sum from 0), each other row by the median of left, top
and left + top - top-left, the gradient not wrapped, the left of a row's
first sample being the last sample of the row above and its top-left the
last sample two rows up (row 1: the row above's last sample, or for YV12
its first).  YUY2 has its own rules: the first luma sample is stored as
it is and the running sum starts after it; row 1 adds its first four
luma (two chroma) samples to the row above's last, then takes the median
with a wrapped gradient, as do the rows after it.

Refused before any decode (:func:`unsupported`): the frame types FFmpeg
refuses (1 uncompressed, 7 the old arithmetic RGB coder, 11 reduced
resolution YV12, and any other).  A frame FFmpeg fails to decode raises
:class:`LagarithError` naming the plane: a chunk shorter than its header,
a plane offset past the chunk, a probability header FFmpeg refuses (a
count of more than 31 bits, counts that overflow or are all zero, a
scaled total it cannot use), data that end early, an invalid escape
byte; so does a zero run that outlasts its plane, which FFmpeg carries
into the next plane.
"""
from __future__ import annotations

import struct
from typing import List, Optional, Tuple

import numpy as np

from .rawvideo_plain import decode_bgr as _raw_bgr

__all__ = ["LAGARITH_FOURCCS", "FRAME_TYPES", "READ_TYPES",
           "LagarithError", "unsupported", "frame_header", "frame_kind",
           "decode_order",
           "plane_shapes", "prob_bits", "read_prob_header", "scale_probs",
           "softfloat_reciprocal", "softfloat_mul", "zero_run",
           "decode_plane", "decode_planes", "decode_bgr"]

LAGARITH_FOURCCS = ("LAGS",)

(RAW, U_RGB24, ARITH_YUY2, ARITH_RGB24, SOLID_GRAY, SOLID_COLOR,
 OLD_ARITH_RGB, ARITH_RGBA, SOLID_RGBA, ARITH_YV12, REDUCED_RES) = range(1, 12)
FRAME_TYPES = {RAW: "uncompressed", U_RGB24: "unaligned RGB24",
               ARITH_YUY2: "YUY2", ARITH_RGB24: "RGB24",
               SOLID_GRAY: "solid grey", SOLID_COLOR: "solid colour",
               OLD_ARITH_RGB: "old arithmetic RGB", ARITH_RGBA: "RGBA",
               SOLID_RGBA: "solid RGBA", ARITH_YV12: "YV12",
               REDUCED_RES: "reduced-resolution YV12"}
READ_TYPES = (U_RGB24, ARITH_YUY2, ARITH_RGB24, SOLID_GRAY, SOLID_COLOR,
              ARITH_RGBA, SOLID_RGBA, ARITH_YV12)
# the bytes a frame of each type needs before its planes
HEADER_BYTES = {U_RGB24: 9, ARITH_RGB24: 9, ARITH_RGBA: 13, ARITH_YUY2: 9,
                ARITH_YV12: 9, SOLID_GRAY: 2, SOLID_COLOR: 4, SOLID_RGBA: 5}
MAX_OVERREAD = 4


class LagarithError(ValueError):
    """A Lagarith frame the decoder does not read, or one FFmpeg fails to
    decode."""


def type_name(frame_type: int) -> str:
    """E.g. ``"type 4 (RGB24)"``."""
    return f"type {frame_type} ({FRAME_TYPES.get(frame_type, 'unknown')})"


def unsupported(frame_type: int, height: int, width: int,
                bit_count: int = 24) -> Optional[str]:
    """What of a frame of ``frame_type`` at ``height`` x ``width`` the
    decoder does not read, or None.  The stream's ``biBitCount``
    (``bit_count``) picks the planes FFmpeg gives a solid frame (24: three,
    else four), which come out as the same BGR frame: it refuses
    nothing."""
    if frame_type not in READ_TYPES:
        return f"frame {type_name(frame_type)}, which FFmpeg refuses"
    if width < 1 or height < 1:
        return f"an image of {height} x {width}"
    return None


def frame_kind(frame_type: int) -> str:
    """What a frame of ``frame_type`` decodes to: ``"bgr"`` (RGB and solid
    frames), or the rawvideo layout of its planes (``"yuv422p"`` for
    YUY2, ``"i420"`` for YV12)."""
    return {ARITH_YUY2: "yuv422p", ARITH_YV12: "i420"}.get(frame_type, "bgr")


def plane_shapes(frame_type: int, height: int,
                 width: int) -> List[Tuple[int, int]]:
    """Each coded plane's (rows, columns), in the order of
    :func:`frame_header`'s offsets (RGB: B - G, G, R - G, A; YUY2: Y, U,
    V; YV12: Y, V, U)."""
    if frame_type in (U_RGB24, ARITH_RGB24, ARITH_RGBA):
        return [(height, width)] * (4 if frame_type == ARITH_RGBA else 3)
    cw = (width + 1) // 2
    ch = (height + 1) // 2 if frame_type == ARITH_YV12 else height
    return [(height, width), (ch, cw), (ch, cw)]


def decode_order(frame_type: int) -> List[int]:
    """The order FFmpeg decodes a frame's planes in (indices into
    :func:`plane_shapes`): RGB's R - G plane first, then G, B - G and A;
    YUV's Y, then the chroma planes as the offsets give them."""
    if frame_type in (U_RGB24, ARITH_RGB24, ARITH_RGBA):
        return [2, 1, 0, 3][:4 if frame_type == ARITH_RGBA else 3]
    return [0, 1, 2]


def frame_header(payload) -> Tuple[int, List[int]]:
    """A chunk's frame type and its planes' offsets (empty for a solid
    frame), in :func:`plane_shapes`' order."""
    data = bytes(payload)
    if not data:
        raise LagarithError("an empty chunk")
    t = data[0]
    need = HEADER_BYTES.get(t, 1)
    if len(data) < need:
        raise LagarithError(f"a {type_name(t)} chunk of {len(data)} bytes "
                            f"(its header needs {need})")
    if t == ARITH_RGBA:
        gu, bv, a = struct.unpack_from("<3I", data, 1)
        return t, [13, gu, bv, a]
    if t in (U_RGB24, ARITH_RGB24, ARITH_YUY2, ARITH_YV12):
        gu, bv = struct.unpack_from("<2I", data, 1)
        return t, [9, gu, bv]
    return t, []


def prob_bits(value: int) -> str:
    """The bits (as text) of one probability-header count: the Fibonacci
    code of its bit length plus one's length, then the bits below that
    top bit; the inverse of ``lag_decode_prob``."""
    n = (value + 1).bit_length()
    fib, code = [1, 2, 3, 5, 8, 13, 21], ["0"] * 7
    rest, top = n, -1
    for k in range(6, -1, -1):
        if fib[k] <= rest:
            code[k] = "1"
            rest -= fib[k]
            top = max(top, k)
    if rest or n > 32:
        raise ValueError(f"a count of {value} has no code")
    head = "".join(code[:top + 1]) + ("1" if top < 6 else "")
    return head + format(value + 1, "b")[1:]


class _Bits:
    """FFmpeg's bit reader over a plane's bytes: most significant bit
    first, zeros past the end."""

    def __init__(self, data: bytes, start: int, end: int) -> None:
        self.data, self.pos, self.limit = data, 8 * start, 8 * end

    def read(self, n: int) -> int:
        v = 0
        for _ in range(n):
            p = self.pos
            bit = (self.data[p >> 3] >> (7 - (p & 7))) & 1 \
                if p < self.limit else 0
            v = v << 1 | bit
            self.pos += 1
        return v


def _read_prob(bits: _Bits) -> int:
    series = (1, 2, 3, 5, 8, 13, 21)
    bit = prev = 0
    n = 0
    for s in series:
        if prev and bit:
            break
        prev = bit
        bit = bits.read(1)
        if bit and not prev:
            n += s
    n -= 1
    if n < 0 or n > 31:
        raise LagarithError(f"a count of {n + 1} bits in its probability "
                            "header")
    if n == 0:
        return 0
    return (bits.read(n) | 1 << n) - 1


def softfloat_reciprocal(denom: int) -> int:
    """The 52-bit mantissa of ``1 / denom`` as FFmpeg computes it."""
    shift = (denom - 1).bit_length()
    ret = (1 << 52) // denom
    err = (1 << 52) - ret * denom
    ret <<= shift
    err <<= shift
    err += denom // 2
    return ret + err // denom


def softfloat_mul(x: int, mantissa: int) -> int:
    """``(uint32_t)(x * f)``, ``f`` the mantissa of
    :func:`softfloat_reciprocal`."""
    m64 = (1 << 64) - 1
    lo = (x * (mantissa & 0xFFFFFFFF)) & m64
    hi = (x * (mantissa >> 32)) & m64
    hi = (hi + (lo >> 32)) & m64
    lo &= 0xFFFFFFFF
    lo += 1 << max((hi >> 21).bit_length() - 1, 0)
    hi = (hi + (lo >> 32)) & m64
    return (hi >> 20) & 0xFFFFFFFF


def scale_probs(probs) -> Tuple[List[int], int]:
    """The cumulative table (258 entries: 0, then the cumulative counts)
    and the scale (log2 of the total) FFmpeg's decoder codes with, from a
    header's 256 counts.  Raises :class:`LagarithError` where FFmpeg
    refuses them."""
    prob = [0] + [int(p) for p in probs]
    total = sum(prob)
    if total > 0xFFFFFFFF:
        raise LagarithError("probability counts whose sum overflows")
    if not total:
        raise LagarithError("probability counts that are all zero")
    scale = total.bit_length() - 1
    if total & (total - 1):
        mul = softfloat_reciprocal(total)
        for i in range(1, 257):
            prob[i] = softfloat_mul(prob[i], mul)
        if not sum(prob[1:129]):
            raise LagarithError("scaled probabilities of symbols 0-127 "
                                "that are all zero")
        scale += 1
        if scale >= 32:
            raise LagarithError(f"a scale of {scale} bits")
        target = 1 << scale
        scaled = sum(prob[1:257])
        if scaled > target:
            raise LagarithError("scaled probabilities over their target")
        rest, i = target - scaled, 1
        while rest:
            if prob[i]:
                prob[i] += 1
                rest -= 1
            i = (i & 0x7F) + 1
    if scale > 23:
        raise LagarithError(f"a probability total of 2^{scale} (the range "
                            "coder keeps 23 bits)")
    cum = [0] * 258
    for i in range(1, 257):
        cum[i] = cum[i - 1] + prob[i]
    cum[257] = 0xFFFFFFFF
    return cum, scale


def read_prob_header(data: bytes, start: int, end: int
                     ) -> Tuple[List[int], int, int]:
    """The header's counts, read from byte ``start`` (zeros past ``end``),
    scaled: (cumulative table, scale, the byte after the header)."""
    bits = _Bits(data, start, end)
    probs, i = [], 0
    while i < 256:
        p = _read_prob(bits)
        if sum(probs) + p > 0xFFFFFFFF:
            raise LagarithError("probability counts whose sum overflows")
        probs.append(p)
        i += 1
        if not p:
            run = min(_read_prob(bits), 256 - i)
            probs += [0] * run
            i += run
    cum, scale = scale_probs(probs)
    return cum, scale, -(-bits.pos // 8)


def zero_run(x: int) -> int:
    """The zeros a run symbol ``x`` adds: ``(x * 2) ^ (x >> 7)``, x as int8."""
    s = x - 256 if x > 127 else x
    return ((s * 2) ^ (s >> 7)) & 255


class _Range:
    """lagarithrac's range decoder over ``data`` from ``start``; bytes
    from ``end`` on (the chunk's end) read as its last bytes, zero-padded."""

    def __init__(self, data: bytes, start: int, end: int, cum: List[int],
                 scale: int) -> None:
        self.data = data
        self.pos, self.end = start, max(end, start)
        self.stop = len(data)
        self.cum, self.scale = cum, scale
        self.range = 0x80
        self.low = (self.data[start] if start < self.stop else 0) >> 1
        self.overread = 0

    def get(self) -> int:
        cum, data = self.cum, self.data
        while self.range <= 0x800000:
            p = self.pos
            b0 = data[p] if p < self.stop else 0
            b1 = data[p + 1] if p + 1 < self.stop else 0
            self.low = ((self.low << 8) | ((b0 << 8 | b1) >> 1) & 0xFF) \
                & 0xFFFFFFFF
            self.range = (self.range << 8) & 0xFFFFFFFF
            if p < self.end:
                self.pos += 1
            else:
                self.overread += 1
        rs = self.range >> self.scale
        low = self.low
        if low >= rs * cum[255]:
            # 255 takes all the range above its start
            self.range -= rs * cum[255]
            self.low = low - rs * cum[255]
            return 255
        lo, hi = 0, 254
        while lo < hi:
            mid = (lo + hi + 1) >> 1
            if low >= rs * cum[mid]:
                lo = mid
            else:
                hi = mid - 1
        self.range = rs * (cum[lo + 1] - cum[lo])
        self.low = low - rs * cum[lo]
        return lo


def _mid(a: int, b: int, c: int) -> int:
    return max(min(a, b), min(max(a, b), c))


def _predict(rows: np.ndarray, yuv420: bool) -> None:
    """lag_pred_line over a plane in coded order, in place (int64)."""
    h, w = rows.shape
    rows[0] = np.cumsum(rows[0]) & 255
    if h < 2:
        return
    flat = rows.reshape(-1).tolist()
    for r in range(1, h):
        base = r * w
        left = flat[base - 1]
        if r == 1:
            tl = flat[0] if yuv420 else left
        else:
            tl = flat[base - w - 1]
        for i in range(w):
            t = flat[base - w + i]
            left = (_mid(left, t, left + t - tl) + flat[base + i]) & 255
            tl = t
            flat[base + i] = left
    rows[:] = np.array(flat, np.int64).reshape(h, w)


def _predict_yuy2(rows: np.ndarray, luma: bool) -> None:
    """lag_pred_line_yuy2 over a plane, in place (int64)."""
    h, w = rows.shape
    first = int(rows[0, 0])
    if luma:
        rows[0, 0] = 0
    rows[0] = np.cumsum(rows[0]) & 255
    if luma:
        rows[0, 0] = first
    if h < 2:
        return
    flat = rows.reshape(-1).tolist()
    for r in range(1, h):
        base = r * w
        left = flat[base - 1]
        if r == 1:
            head = 4 if luma else 2
            tl = flat[head - 1] if head <= w else None
            i = 0
            while i < min(head, w):
                left = (left + flat[base + i]) & 255
                flat[base + i] = left
                i += 1
        else:
            tl = flat[base - w - 1]
            i = 0
        for i in range(i, w):
            t = flat[base - w + i]
            left = (_mid(left, t, (left + t - tl) & 255)
                    + flat[base + i]) & 255
            tl = t
            flat[base + i] = left
    rows[:] = np.array(flat, np.int64).reshape(h, w)


class _State:
    """What FFmpeg's context carries from plane to plane: the zeros left
    of a run."""
    zeros_rem = 0


def _zero_run_line(row: list, data: bytes, src: int, src_end: int,
                   width: int, esc: int, st: _State) -> int:
    """lag_decode_zero_run_line: one row from ``data[src:]``, the bytes
    it read returned."""
    start = src
    mask1 = 0xFF if esc < 2 else 0
    mask2 = 0xFF if esc < 3 else 0
    end = width - 2
    d = i = 0
    found = False
    while True:
        if st.zeros_rem:
            count = min(st.zeros_rem, width - i)
            if end - d < count:
                raise LagarithError("a zero run longer than its row")
            st.zeros_rem -= count
            d += count
        again = False
        while d < end:
            i = 0
            while not found and d + i < end:
                i += 1
                if i + 2 >= src_end - src:
                    raise LagarithError("zero-run data that end early")
                found = not (data[src + i] | (data[src + i + 1] & mask1)
                             | (data[src + i + 2] & mask2))
            if found:
                found = False
                i += esc
                if i > end - d or i >= src_end - src:
                    raise LagarithError("zero-run data that end early")
                row[d:d + i] = data[src:src + i]
                d += i
                st.zeros_rem = zero_run(data[src + i])
                src += i + 1
                again = True
                break
            row[d:d + i] = data[src:src + i]
            src += i
            d += i
        if not again:
            return src - start


def decode_plane(data: bytes, offset: int, rows: int, cols: int,
                 predictor: str, st: Optional[_State] = None) -> np.ndarray:
    """One plane at ``offset`` of the chunk ``data``, (rows, cols) uint8
    in coded order.  ``predictor``: ``"median"``, ``"yv12"`` (row 1's
    top-left from its first sample), ``"yuy2_luma"`` or
    ``"yuy2_chroma"``."""
    st = st or _State()
    size = len(data) - offset
    if size < 2:
        raise LagarithError("a plane of fewer than 2 bytes")
    esc = data[offset]
    n = rows * cols
    if esc == 0xFF:
        return np.full((rows, cols), data[offset + 1], np.uint8)
    if esc < 4:
        if size < 5:
            raise LagarithError("a range-coded plane of fewer than 5 bytes")
        at = offset + 1
        if esc and struct.unpack_from("<I", data, offset + 1)[0] < n:
            at += 4
        cum, scale, body = read_prob_header(data, at, len(data))
        rac = _Range(data, body, len(data), cum, scale)
        out = []
        zeros, limit = 0, esc or -1
        for _ in range(rows):
            if rac.overread > MAX_OVERREAD:
                raise LagarithError("range-coded data that end early")
            line = []
            while len(line) < cols:
                if st.zeros_rem:
                    k = min(st.zeros_rem, cols - len(line))
                    line += [0] * k
                    st.zeros_rem -= k
                    continue
                v = rac.get()
                line.append(v)
                zeros = zeros + 1 if v == 0 else 0
                if zeros == limit:
                    st.zeros_rem = zero_run(rac.get())
                    zeros = 0
            out.append(line)
        res = np.array(out, np.int64).reshape(rows, cols)
    elif esc < 8:
        esc -= 4
        src, end = offset + 1, len(data)
        if esc:
            res = np.zeros((rows, cols), np.int64)
            for r in range(rows):
                row = [0] * cols
                src += _zero_run_line(row, data, src, end, cols, esc, st)
                res[r] = row[:cols]
        else:
            if end - src < n:
                raise LagarithError(f"a raw plane of {end - src} bytes "
                                    f"(it needs {n})")
            res = np.frombuffer(data, np.uint8, n, src).reshape(
                rows, cols).astype(np.int64)
    else:
        raise LagarithError(f"escape byte {esc:#x}")
    if predictor in ("median", "yv12"):
        _predict(res, predictor == "yv12")
    else:
        _predict_yuy2(res, predictor == "yuy2_luma")
    return res.astype(np.uint8)


def decode_planes(payload, height: int,
                  width: int) -> Tuple[int, List[np.ndarray]]:
    """One chunk's frame type and decoded planes, picture rows first:
    B, G, R (and A) for RGB, B, G, R for a solid frame (each (H, W)
    uint8), Y, U, V for YUV.  Raises :class:`LagarithError` naming the
    plane FFmpeg fails on, and for a frame type the decoder does not
    read."""
    data = bytes(payload)
    t, offsets = frame_header(data)
    why = unsupported(t, height, width)
    if why:
        raise LagarithError(why)
    if not offsets:
        full = [np.full((height, width), v, np.uint8) for v in (
            (data[1],) * 3 if t == SOLID_GRAY else data[1:4])]
        return t, full
    shapes = plane_shapes(t, height, width)
    for k in decode_order(t):
        off = offsets[k]
        if off >= len(data):
            raise LagarithError(f"plane {k}: its offset {off} is past the "
                                f"chunk of {len(data)} bytes")
    st = _State()
    planes = [None] * len(shapes)
    if t == ARITH_YUY2:
        preds = ["yuy2_luma"] + ["yuy2_luma" if c == width else
                                 "yuy2_chroma" for _, c in shapes[1:]]
    else:
        preds = ["yv12" if t == ARITH_YV12 else "median"] * len(shapes)
    for k in decode_order(t):
        (r, c), pred = shapes[k], preds[k]
        try:
            planes[k] = decode_plane(data, offsets[k], r, c, pred, st)
        except LagarithError as exc:
            raise LagarithError(f"plane {k}: {exc}") from None
        if st.zeros_rem:
            raise LagarithError(f"plane {k}: a zero run that outlasts the "
                                "plane (FFmpeg carries it into the next "
                                "plane it decodes)")
    if t in (ARITH_YUY2, ARITH_YV12):
        y, a, b = planes
        return t, [y, a, b] if t == ARITH_YUY2 else [y, b, a]
    b, g, r = planes[:3]
    g64 = g.astype(np.int64)
    out = [((b + g64) & 255), g64, ((r + g64) & 255)]
    out = [p[::-1].astype(np.uint8) for p in out]
    if t == ARITH_RGBA:
        out.append(np.ascontiguousarray(planes[3][::-1]))
    return t, out


def decode_bgr(payload, height: int, width: int) -> np.ndarray:
    """One chunk's (H, W, 3) BGR uint8 frame, as cv2 gives it."""
    t, planes = decode_planes(payload, height, width)
    kind = frame_kind(t)
    if kind == "bgr":
        return np.stack(planes[:3], -1)
    return _raw_bgr(b"".join(p.tobytes() for p in planes), kind, height,
                    width)
