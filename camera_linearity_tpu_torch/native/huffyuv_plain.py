"""Plain version of the port's HuffYUV decoder (``huffyuv.cpp``): one frame
chunk of an ``HFYU`` or ``FFVH`` AVI into the (H, W, 3) BGR uint8 frame
``cv2.VideoCapture`` gives for it.

cv2 reads such an AVI through FFmpeg 8: the AVI demuxer, the
huffyuv/ffvhuff decoder (huffyuvdec.c) and swscale to BGR24.  The stream's
parameters come from the BITMAPINFOHEADER (:func:`params`):

* v2 (four bytes or more of extradata, the fourth zero, and a bit count
  without low bits): byte 0 the predictor (low 6 bits: 0 left, 1
  gradient, 2 median) and G-decorrelation (bit 6); byte 1 the bits per
  pixel (0: the bit count's); byte 2 bits 4-5 the interlace flag (1 on,
  2 off, else the default) and bit 6 per-frame tables (refused); then the
  code lengths of the three tables, run-length coded (3 bits of repeat, 0
  for 8 more, then 5 bits of length);
* v1 (no extradata, or a bit count with low bits): FFmpeg's built-in
  "classic" tables (``CLASSIC_*``, the luma one for all three at 24 and 32
  bits) and the predictor from the bit count's low 3 bits (1 left, 2 left
  decorrelated, 3 gradient, decorrelated at 24 and 32 bits, 4 median,
  else left).

The default interlace flag is ``height > 288``: then the gradient and
median predictors reach two rows up.  Codes are canonical as FFmpeg's
``ff_huffyuv_generate_bits_table`` makes them (the longest codes take the
smallest values, a length's codes in symbol order); the chunk is read as
32-bit little-endian words, each word's bits most significant first.

Layouts: RGB24 (bit count 24: stored bottom-up, each pixel's B, G, R, or
G, B - G, R - G decorrelated), RGB32 (32: B, G, R, A, the alpha dropped;
cv2 gives BGR), YUY2 (16: yuv422p, Y U Y V a pair) and, for ``FFVH``,
yuv420p (12: a gray row of Y pairs between full rows).  RGB is given
exactly; the YUV layouts go through swscale's limited-range BT.601
conversion, as the port's rawvideo reader converts yuv422p (``Y42B``) and
yuv420p (``I420``): ``rawvideo_plain.decode_bgr``.

Refused (:func:`unsupported`), before any decode: per-frame tables,
ffvhuff's v3 formats (extradata whose fourth byte is not 0), RGB with the
median predictor (FFmpeg's decoder does not decode it), a YUV layout of
odd width, the median predictor on YUY2 of a width not a multiple of 4
and on yuv420p of a height under 4 (6 interlaced), a bit count FFmpeg
does not decode, and tables that are not a complete
prefix code.  A chunk whose codes run past its end raises, naming the
frame (FFmpeg would read padding there).
"""
from __future__ import annotations

import itertools
from typing import NamedTuple, Optional, Tuple

import numpy as np

from .rawvideo_plain import decode_bgr as _raw_bgr

__all__ = ["HUFFYUV_FOURCCS", "PREDICTORS", "HuffyuvParams", "HuffyuvError",
           "params", "unsupported", "layout_name", "read_lengths",
           "canonical_codes", "decode_planes", "decode_bgr", "yuv_layout",
           "CLASSIC_LUMA", "CLASSIC_CHROMA"]

HUFFYUV_FOURCCS = ("HFYU", "FFVH")
LEFT, GRADIENT, MEDIAN = 0, 1, 2
PREDICTORS = ("left", "gradient", "median")
_LAYOUTS = {12: "yuv420p", 16: "YUY2", 24: "RGB24", 32: "RGB32"}

# FFmpeg's classic tables (huffyuvdec.c): the code lengths, run-length
# coded as v2 extradata is, and the codes themselves
_CLASSIC_SHIFT_LUMA = bytes.fromhex(
    "2224234587e809100a180b170c100d0a0e080f0810081114100acfcecdec0b080a15"
    "09170808c7464544")
_CLASSIC_SHIFT_CHROMA = bytes.fromhex(
    "422425262728294b4c4d6eef90515253545576b73839585938599a393a391a8d3938"
    "3a393a39b877d6f574535231504f4e4d2c4b29282726252422")
_CLASSIC_ADD_LUMA = bytes.fromhex(
    "0309050c0a23201d1b32302d2c29272549464441403d3a383532312e2c2926244441"
    "3f3d3a373533302e2d2b292726242321201e1d1b1a19302f2e2c2b29282725242322"
    "201f1e1c1b1a1817161413252322211f1e1d1b1a1817151412110f1d1b1a18161513"
    "11100e1a1917151312100f1b1917151311100e1a19171512110e0c11130d0409020b"
    "0107080010030e060c0a050f120b0a0d0f10131416181b0f121416181a0e11141618"
    "1b0f121417191c101316191c202415191d21262a2d311c1f2225282a2c2f31323436"
    "38393b3c3e40424345232527282a2b2d2f3033343637393b3c3e3f42434547482628"
    "2a2b2e2f31331a1c1e1f212212130b0d0708")
_CLASSIC_ADD_CHROMA = bytes.fromhex(
    "03010202020203030705070508060b09070d0b0a0908070509070604070508070b08"
    "0d0b130f16171421201c1b1d334d2b2d4c512e524b3738903a503c4a933f8f414243"
    "4445464748494a4b4c4d4e4f505152535455565758595a5b1b1e1516110e05066436"
    "2f3233356a6b6c6d6e6f707172730475765c5e797a037c6702010081828378777e7d"
    "88898a8b8c8d8e868784856840653e39665f5d3b3d1c61603431301d2019182e1762"
    "2d2c2b142a29131263280f2726100d0c0b250a09082407807f697b74232221911f4f"
    "2a924e1a533031322c2f1a1f1e1211131518190d0e10111214150c0e0f090a060906"
    "0508060c080a070906040602020303030302")


class HuffyuvError(ValueError):
    """A HuffYUV stream the decoder does not read, or a frame FFmpeg would
    decode with an error it conceals."""


class HuffyuvParams(NamedTuple):
    """What a stream's header says: the codec, the header's version (1:
    the classic tables, 2: tables in the extradata), the predictor (0
    left, 1 gradient, 2 median), G-decorrelation, bits per pixel (12, 16,
    24, 32), the interlace flag and the (3, 256) code lengths and codes
    of the three tables (luma or B, chroma U or G, chroma V or R)."""
    codec: str
    version: int
    predictor: int
    decorrelate: bool
    bpp: int
    interlaced: bool
    lengths: np.ndarray
    codes: np.ndarray


def read_lengths(data: bytes, n: int = 256) -> Tuple[np.ndarray, int]:
    """One table's ``n`` code lengths from its run-length coding, and the
    bytes it took."""
    out = np.zeros(n, np.uint8)
    i = pos = 0
    while i < n:
        if pos >= len(data):
            raise HuffyuvError("a code-length table runs past the extradata")
        repeat, value = data[pos] >> 5, data[pos] & 31
        pos += 1
        if repeat == 0:
            if pos >= len(data):
                raise HuffyuvError("a code-length table runs past the "
                                   "extradata")
            repeat = data[pos]
            pos += 1
        if i + repeat > n:
            raise HuffyuvError("a code-length table of more than 256 codes")
        out[i:i + repeat] = value
        i += repeat
    return out, pos


def canonical_codes(lengths: np.ndarray) -> np.ndarray:
    """The codes ``ff_huffyuv_generate_bits_table`` gives the lengths: from
    the longest length down, each length's first code is half the sum of
    the next length's count and first code; a length's codes go to its
    symbols in order.  Raises for lengths that do not make a complete
    prefix code."""
    counts = np.bincount(lengths, minlength=33)[:33]
    first = [0] * 33
    for n in range(32, 0, -1):
        if (counts[n] + first[n]) & 1:
            raise HuffyuvError("code lengths that are not a prefix code")
        first[n - 1] = (counts[n] + first[n]) >> 1
    if first[0] != 1 and counts[1:].any():
        raise HuffyuvError("code lengths that are not a complete prefix code")
    codes = np.zeros(len(lengths), np.uint32)
    for sym, n in enumerate(lengths):
        if n:
            codes[sym] = first[n]
            first[n] += 1
    return codes


def _classic() -> Tuple[np.ndarray, np.ndarray]:
    """The classic (lengths, codes) of luma and chroma; a code is the low
    ``length`` bits of its table entry, as FFmpeg's VLC tables take
    it."""
    lengths = np.stack([read_lengths(_CLASSIC_SHIFT_LUMA)[0],
                        read_lengths(_CLASSIC_SHIFT_CHROMA)[0]])
    adds = np.stack([np.frombuffer(_CLASSIC_ADD_LUMA, np.uint8),
                     np.frombuffer(_CLASSIC_ADD_CHROMA, np.uint8)])
    return lengths, (adds & ((1 << lengths.astype(np.uint32)) - 1)
                     ).astype(np.uint32)


CLASSIC_LUMA, CLASSIC_CHROMA = (
    tuple(a[k] for a in _classic()) for k in (0, 1))


def params(codec: str, bit_count: int, extradata: bytes,
           height: int) -> HuffyuvParams:
    """A stream's :class:`HuffyuvParams` from its fourcc, BITMAPINFOHEADER
    bit count and extradata (the ``strf`` bytes past 40).  Raises
    :class:`HuffyuvError` naming what FFmpeg's decoder (or this one) does
    not read."""
    interlaced = height > 288
    if extradata and not (bit_count & 7 and bit_count != 12):
        if len(extradata) < 4 or extradata[3] != 0:
            raise HuffyuvError("a v3 header (ffvhuff's extended formats: "
                               f"extradata {bytes(extradata[:4]).hex()})")
        method = extradata[0]
        predictor, decorrelate = method & 63, bool(method & 64)
        bpp = extradata[1] or bit_count & ~7
        flag = (extradata[2] & 0x30) >> 4
        interlaced = True if flag == 1 else False if flag == 2 else interlaced
        if extradata[2] & 0x40:
            raise HuffyuvError("per-frame Huffman tables (context=1)")
        lengths, at = [], 4
        for _ in range(3):
            table, used = read_lengths(extradata[at:])
            lengths.append(table)
            at += used
        lengths = np.stack(lengths)
        codes = np.stack([canonical_codes(t) for t in lengths])
        version = 2
    else:
        predictor, decorrelate = {1: (LEFT, False), 2: (LEFT, True),
                                  3: (GRADIENT, bit_count >= 24),
                                  4: (MEDIAN, False)}.get(bit_count & 7,
                                                          (LEFT, False))
        bpp = bit_count & ~7
        (ll, cl), (lc, cc) = CLASSIC_LUMA, CLASSIC_CHROMA
        rgb = bpp >= 24
        lengths = np.stack([ll, ll if rgb else lc, ll if rgb else lc])
        codes = np.stack([cl, cl if rgb else cc, cl if rgb else cc])
        version = 1
    if predictor > MEDIAN:
        raise HuffyuvError(f"predictor {predictor}")
    if bpp not in _LAYOUTS:
        raise HuffyuvError(f"{bpp} bits per pixel in a {codec} stream")
    return HuffyuvParams(codec, version, predictor, decorrelate, bpp,
                         interlaced, lengths, codes)


def layout_name(p: HuffyuvParams) -> str:
    """E.g. ``"HFYU RGB24 gradient decorrelated"``."""
    return (f"{p.codec} {_LAYOUTS[p.bpp]} {PREDICTORS[p.predictor]}"
            + " decorrelated" * p.decorrelate
            + " interlaced" * p.interlaced)


def unsupported(codec: str, bit_count: int, extradata: bytes, height: int,
                width: int) -> Optional[str]:
    """What of a HuffYUV stream's header the decoder does not read, or
    None."""
    try:
        p = params(codec, bit_count, extradata, height)
    except HuffyuvError as exc:
        return str(exc)
    if p.bpp >= 24 and p.predictor == MEDIAN:
        return f"{layout_name(p)} (FFmpeg decodes RGB with left or gradient)"
    if p.bpp < 24 and width & 1:
        return f"{layout_name(p)} of odd width {width}"
    if p.bpp == 16 and p.predictor == MEDIAN and width % 4:
        return f"{layout_name(p)} of width {width}, not a multiple of 4"
    if p.bpp == 12 and p.predictor == MEDIAN and \
            height < (6 if p.interlaced else 4):
        # FFmpeg's first rows then reach past the picture's rows
        return f"{layout_name(p)} of height {height}"
    if width < 2 or height < 1:
        return f"an image of {height} x {width}"
    return None


class _Table:
    """One table's decoder: the next 12 bits look up codes of up to 12
    bits (``lut``: length << 8 | symbol), longer ones are found by
    length."""

    def __init__(self, lengths: np.ndarray, codes: np.ndarray) -> None:
        self.lut = [0] * 4096
        self.long = {}
        for sym, (n, code) in enumerate(zip(lengths.tolist(), codes.tolist())):
            if not n:
                continue
            if n <= 12:
                base = code << (12 - n)
                for k in range(1 << (12 - n)):
                    self.lut[base + k] = n << 8 | sym
            else:
                self.long[(n, code)] = sym

    def entry(self, window: int) -> int:
        """length << 8 | symbol of the code at the top of the 32-bit
        ``window``."""
        e = self.lut[window >> 20]
        if e:
            return e
        for n in range(13, 33):
            sym = self.long.get((n, window >> (32 - n)))
            if sym is not None:
                return n << 8 | sym
        raise HuffyuvError("a code that is in no table")


class _Bits:
    """The chunk's bits: 32-bit little-endian words, each read from its
    most significant bit; ``windows[i]`` holds words i and i + 1, so the
    32 bits at any position are one shift away."""

    def __init__(self, payload) -> None:
        n = len(payload) // 4
        words = np.zeros(n + 3, np.uint64)
        words[:n] = np.frombuffer(payload, "<u4", n)
        self.windows = ((words[:-1] << np.uint64(32)) | words[1:]).tolist()
        self.end = 32 * n
        self.pos = 0

    def get(self, k: int) -> int:
        """The next ``k`` (up to 32) bits as they are."""
        p = self.pos
        self.pos = p + k
        return (self.windows[p >> 5] >> (64 - (p & 31) - k)) & ((1 << k) - 1)

    def symbols(self, tables, count: int) -> np.ndarray:
        """``count`` symbols, symbol k coded with table ``tables[k %
        len(tables)]``."""
        windows, p, out = self.windows, self.pos, []
        append = out.append
        for lut, tab in itertools.islice(itertools.cycle(
                [(t.lut, t) for t in tables]), count):
            w = (windows[p >> 5] >> (32 - (p & 31))) & 0xFFFFFFFF
            e = lut[w >> 20] or tab.entry(w)
            p += e >> 8
            append(e & 255)
        if p > self.end:
            raise HuffyuvError("the codes run past the end of the chunk")
        self.pos = p
        return np.array(out, np.int64)


def _left(dst: np.ndarray, diff: np.ndarray, acc: int) -> int:
    """add_left_pred: dst = acc + running sum of diff (mod 256); returns
    the last sum."""
    if not len(diff):
        return acc
    out = (acc + np.cumsum(diff, dtype=np.int64)) & 255
    dst[:] = out
    return int(out[-1])


def _median(dst: np.ndarray, top: np.ndarray, diff: np.ndarray, left: int,
            left_top: int) -> Tuple[int, int]:
    """add_median_pred: each sample the median of left, top and left + top
    - top-left (mod 256), plus its diff."""
    l, lt, out = left, left_top, []
    append = out.append
    for t, d in zip(top.tolist(), diff.tolist()):
        g = (l + t - lt) & 255
        lo, hi = (l, t) if l < t else (t, l)
        l = ((lo if g < lo else hi if g > hi else g) + d) & 255
        lt = t
        append(l)
    if out:
        dst[:] = out
    return l, lt


def _read_yuv(bits: _Bits, tabs, count: int):
    """decode_422_bitstream: ``count`` luma and count / 2 of each chroma,
    Y U Y V a pair."""
    t0, t1, t2 = tabs
    q = bits.symbols((t0, t1, t0, t2), count // 2 * 4).reshape(-1, 4)
    return q[:, 0::2].reshape(-1), q[:, 1], q[:, 3]


def _read_gray(bits: _Bits, tab: _Table, count: int) -> np.ndarray:
    """decode_gray_bitstream: ``count`` luma samples (even)."""
    return bits.symbols((tab,), count // 2 * 2)


def _decode_yuv(bits: _Bits, p: HuffyuvParams, tabs, h: int, w: int):
    """decode_slice's YUV branch: (Y, U, V) planes."""
    w2 = w >> 1
    ch = h if p.bpp == 16 else (h + 1) // 2
    Y = np.zeros((h, w), np.uint8)
    U = np.zeros((ch, w2), np.uint8)
    V = np.zeros((ch, w2), np.uint8)
    fy = fc = 2 if p.interlaced else 1
    twelve = p.bpp == 12
    V[0, 0] = leftv = bits.get(8)
    Y[0, 1] = lefty = bits.get(8)
    U[0, 0] = leftu = bits.get(8)
    Y[0, 0] = bits.get(8)
    ty, tu, tv = _read_yuv(bits, tabs, w - 2)
    lefty = _left(Y[0, 2:], ty, lefty)
    leftu = _left(U[0, 1:], tu, leftu)
    leftv = _left(V[0, 1:], tv, leftv)
    if p.predictor != MEDIAN:
        y = cy = 1
        while y < h:
            if twelve:
                lefty = _left(Y[y], _read_gray(bits, tabs[0], w), lefty)
                if p.predictor == GRADIENT and y > p.interlaced:
                    Y[y] += Y[y - fy]
                y += 1
                if y >= h:
                    break
            ty, tu, tv = _read_yuv(bits, tabs, w)
            lefty = _left(Y[y], ty, lefty)
            leftu = _left(U[cy], tu, leftu)
            leftv = _left(V[cy], tv, leftv)
            if p.predictor == GRADIENT and cy > p.interlaced:
                Y[y] += Y[y - fy]
                U[cy] += U[cy - fc]
                V[cy] += V[cy - fc]
            y += 1
            cy += 1
        return Y, U, V
    y = cy = 1
    if y >= h:
        return Y, U, V
    if p.interlaced:
        ty, tu, tv = _read_yuv(bits, tabs, w)
        lefty = _left(Y[1], ty, lefty)
        leftu = _left(U[1], tu, leftu)
        leftv = _left(V[1], tv, leftv)
        y += 1
        cy += 1
        if y >= h:
            return Y, U, V
    ty, tu, tv = _read_yuv(bits, tabs, 4)
    lefty = _left(Y[fy, :4], ty, lefty)
    leftu = _left(U[fc, :2], tu, leftu)
    leftv = _left(V[fc, :2], tv, leftv)
    ty, tu, tv = _read_yuv(bits, tabs, w - 4)
    lefty, topy = _median(Y[fy, 4:], Y[0, 4:], ty, lefty, int(Y[0, 3]))
    leftu, topu = _median(U[fc, 2:], U[0, 2:], tu, leftu, int(U[0, 1]))
    leftv, topv = _median(V[fc, 2:], V[0, 2:], tv, leftv, int(V[0, 1]))
    y += 1
    cy += 1
    while y < h:
        if twelve:
            while 2 * cy > y:
                lefty, topy = _median(Y[y], Y[y - fy],
                                      _read_gray(bits, tabs[0], w), lefty,
                                      topy)
                y += 1
            if y >= h:
                break
        ty, tu, tv = _read_yuv(bits, tabs, w)
        lefty, topy = _median(Y[y], Y[y - fy], ty, lefty, topy)
        leftu, topu = _median(U[cy], U[cy - fc], tu, leftu, topu)
        leftv, topv = _median(V[cy], V[cy - fc], tv, leftv, topv)
        y += 1
        cy += 1
    return Y, U, V


def _decode_rgb(bits: _Bits, p: HuffyuvParams, tabs, h: int,
                w: int) -> np.ndarray:
    """decode_slice's RGB branch: (H, W, 4) B, G, R, A, top row first
    (the stream's first row is the bottom one)."""
    px = np.zeros((h, w, 4), np.uint8)
    alpha = p.bpp == 32
    if alpha:
        a, r, g, b = (bits.get(8) for _ in range(4))
    else:
        r, g, b = (bits.get(8) for _ in range(3))
        a = 255
        bits.get(8)
    left = np.array([b, g, r, a], np.int64)
    px[h - 1, 0] = left
    t0, t1, t2 = tabs

    def read_row(count: int) -> np.ndarray:
        """decode_bgr_bitstream: B, G, R (G, B - G, R - G decorrelated)
        and A (32 bits) a pixel; A is 0 at 24 bits."""
        order = (t1, t0, t2) if p.decorrelate else (t0, t1, t2)
        q = bits.symbols(order + (t2,) * alpha, count * (3 + alpha)
                         ).reshape(count, 3 + alpha)
        t = np.zeros((count, 4), np.int64)
        if p.decorrelate:
            g = q[:, 0]
            t[:, 0], t[:, 1], t[:, 2] = (q[:, 1] + g) & 255, g, \
                (q[:, 2] + g) & 255
        else:
            t[:, :3] = q[:, :3]
        if alpha:
            t[:, 3] = q[:, 3]
        return t

    def left_row(dst: np.ndarray, t: np.ndarray) -> None:
        if len(t):
            out = (left + np.cumsum(t, 0)) & 255
            dst[:] = out
            left[:] = out[-1]
    fy = 2 if p.interlaced else 1
    left_row(px[h - 1, 1:], read_row(w - 1))
    for y in range(h - 2, -1, -1):
        left_row(px[y], read_row(w))
        if p.predictor == GRADIENT:
            if not alpha:
                left[3] = 0
            if y < h - 1 - p.interlaced:
                px[y] += px[y + fy]
    return px


def decode_planes(payload, p: HuffyuvParams, height: int, width: int):
    """One chunk's decoded picture as FFmpeg holds it: RGB as (H, W, 4) B,
    G, R, A; YUV as its (Y, U, V) planes.  Raises :class:`HuffyuvError`
    where the codes run past the chunk."""
    bits = _Bits(payload)
    tabs = [_Table(p.lengths[k], p.codes[k]) for k in range(3)]
    if p.bpp >= 24:
        return _decode_rgb(bits, p, tabs, height, width)
    return _decode_yuv(bits, p, tabs, height, width)


def yuv_layout(p: HuffyuvParams) -> Optional[str]:
    """The rawvideo layout a YUV stream's planes convert as (``"i420"`` or
    ``"yuv422p"``); None for RGB."""
    return {12: "i420", 16: "yuv422p"}.get(p.bpp)


def decode_bgr(payload, p: HuffyuvParams, height: int,
               width: int) -> np.ndarray:
    """One chunk's (H, W, 3) BGR uint8 frame, as cv2 gives it."""
    out = decode_planes(payload, p, height, width)
    if p.bpp >= 24:
        return np.ascontiguousarray(out[..., :3])
    planes = b"".join(np.ascontiguousarray(c).tobytes() for c in out)
    return _raw_bgr(planes, yuv_layout(p), height, width)
