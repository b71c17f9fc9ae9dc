"""HuffYUV encoder and AVI writer for the port's HuffYUV tests and
``chip_smoke.py`` (NumPy, no cv2 or FFmpeg).

``encode_frame`` writes one frame as FFmpeg's huffyuv/ffvhuff encoder
lays it out (``camera_linearity_tpu_torch/native/huffyuv_plain.py`` has
the decoder's rules, which this inverts): the first pixels raw, then each
sample's residual after the left, gradient or median predictor as a
Huffman code; RGB bottom row first, optionally G-decorrelated; YUY2
(yuv422p) a Y U Y V group a pair; yuv420p a gray row of Y pairs between
the full rows; the bits most significant first in 32-bit little-endian
words.  Every residual is computed from the known picture, so a 4K frame
encodes with array operations, the median predictor's included.

``write_huffyuv_avi`` writes the container with
``tests/_torch_rawvideo_writer.write_avi``: v2 streams carry their
predictor, bits per pixel, interlace flag and code-length tables (built
from the frames' residual counts) in the ``strf`` bytes after the
BITMAPINFOHEADER, as cv2's ``HFYU`` / ``FFVH`` writer puts them; v1
streams carry none and code with FFmpeg's classic tables, the predictor
in the bit count's low bits.
"""
from __future__ import annotations

import heapq
from pathlib import Path
from typing import List, NamedTuple, Optional, Sequence

import numpy as np

from camera_linearity_tpu_torch.native import huffyuv_plain as hp
from tests._torch_rawvideo_writer import video_headers, write_avi

__all__ = ["Stream", "make_stream", "encode_frame", "write_huffyuv_avi",
           "write_stream_avi", "stream_params",
           "extradata", "store_lengths", "huffman_lengths", "to_planes",
           "frame_symbols", "pack", "pack_codes", "BPP", "PREDICTORS"]

BPP = {"yuv420p": 12, "yuy2": 16, "rgb24": 24, "rgb32": 32}
PREDICTORS = {"left": 0, "gradient": 1, "median": 2}


class Stream(NamedTuple):
    """What the encoder needs of a stream: bits per pixel, predictor (0
    left, 1 gradient, 2 median), decorrelation, the interlace flag the
    decoder will take and the (3, 256) code lengths and codes."""
    bpp: int
    predictor: int
    decorrelate: bool
    interlaced: bool
    lengths: np.ndarray
    codes: np.ndarray


def _left_codes(values: np.ndarray, acc: int):
    """Residuals the decoder's add_left_pred turns into ``values`` from
    ``acc``; and the new acc."""
    v = values.astype(np.int64)
    prev = np.concatenate([[acc], v[:-1]])
    return (v - prev) & 255, (int(v[-1]) if len(v) else acc)


def _median_codes(values: np.ndarray, top: np.ndarray, left: int,
                  left_top: int):
    """Residuals the decoder's add_median_pred turns into ``values`` above
    ``top``; and the new (left, left_top)."""
    v, t = values.astype(np.int64), top.astype(np.int64)
    if not len(v):
        return v, left, left_top
    lv = np.concatenate([[left], v[:-1]])
    lt = np.concatenate([[left_top], t[:-1]])
    g = (lv + t - lt) & 255
    med = np.maximum(np.minimum(lv, t), np.minimum(np.maximum(lv, t), g))
    return (v - med) & 255, int(v[-1]), int(t[-1])


class _Symbols:
    """The frame's fields in stream order: (table, value) pairs, table -1
    for a raw 8-bit field."""

    def __init__(self) -> None:
        self.tables: List[np.ndarray] = []
        self.values: List[np.ndarray] = []

    def raw(self, *values: int) -> None:
        self.tables.append(np.full(len(values), -1, np.int64))
        self.values.append(np.array(values, np.int64))

    def yuv(self, y, u, v) -> None:
        """Y U Y V a pair."""
        n = len(u)
        t = np.tile(np.array([0, 1, 0, 2]), n)
        s = np.stack([y[0::2], u, y[1::2], v], 1).reshape(-1)
        self.tables.append(t)
        self.values.append(s)

    def gray(self, y) -> None:
        self.tables.append(np.zeros(len(y), np.int64))
        self.values.append(np.asarray(y, np.int64))

    def rgb(self, px: np.ndarray, decorrelate: bool, alpha: bool) -> None:
        """(n, 4) residuals of B, G, R, A."""
        b, g, r, a = (px[:, k].astype(np.int64) for k in range(4))
        if decorrelate:
            cols, tabs = [g, (b - g) & 255, (r - g) & 255], [1, 0, 2]
        else:
            cols, tabs = [b, g, r], [0, 1, 2]
        if alpha:
            cols.append(a)
            tabs.append(2)
        self.tables.append(np.tile(np.array(tabs), len(b)))
        self.values.append(np.stack(cols, 1).reshape(-1))

    def arrays(self):
        return np.concatenate(self.tables), np.concatenate(self.values)


def _yuv_symbols(planes, s: Stream) -> _Symbols:
    """Mirror of the decoder's YUV branch, residuals from the planes."""
    Y, U, V = (np.asarray(c, np.int64) for c in planes)
    h, w = Y.shape
    fy = fc = 2 if s.interlaced else 1
    twelve = s.bpp == 12
    out = _Symbols()
    out.raw(int(V[0, 0]), int(Y[0, 1]), int(U[0, 0]), int(Y[0, 0]))
    dy, ly = _left_codes(Y[0, 2:], Y[0, 1])
    du, lu = _left_codes(U[0, 1:], U[0, 0])
    dv, lv = _left_codes(V[0, 1:], V[0, 0])
    out.yuv(dy, du, dv)
    if s.predictor != 2:
        grad = s.predictor == 1
        y = cy = 1
        while y < h:
            if twelve:
                acc = Y[y] - Y[y - fy] if grad and y > s.interlaced else Y[y]
                d, ly = _left_codes(acc & 255, ly)
                out.gray(d)
                y += 1
                if y >= h:
                    break
            up = grad and cy > s.interlaced
            accs = [Y[y] - Y[y - fy] if up else Y[y],
                    U[cy] - U[cy - fc] if up else U[cy],
                    V[cy] - V[cy - fc] if up else V[cy]]
            dy, ly = _left_codes(accs[0] & 255, ly)
            du, lu = _left_codes(accs[1] & 255, lu)
            dv, lv = _left_codes(accs[2] & 255, lv)
            out.yuv(dy, du, dv)
            y += 1
            cy += 1
        return out
    y = cy = 1
    if y >= h:
        return out
    if s.interlaced:
        dy, ly = _left_codes(Y[1], ly)
        du, lu = _left_codes(U[1], lu)
        dv, lv = _left_codes(V[1], lv)
        out.yuv(dy, du, dv)
        y += 1
        cy += 1
        if y >= h:
            return out
    dy, ly = _left_codes(Y[fy, :4], ly)
    du, lu = _left_codes(U[fc, :2], lu)
    dv, lv = _left_codes(V[fc, :2], lv)
    out.yuv(dy, du, dv)
    dy, ly, ty = _median_codes(Y[fy, 4:], Y[0, 4:], ly, int(Y[0, 3]))
    du, lu, tu = _median_codes(U[fc, 2:], U[0, 2:], lu, int(U[0, 1]))
    dv, lv, tv = _median_codes(V[fc, 2:], V[0, 2:], lv, int(V[0, 1]))
    out.yuv(dy, du, dv)
    y += 1
    cy += 1
    while y < h:
        if twelve:
            while 2 * cy > y:
                d, ly, ty = _median_codes(Y[y], Y[y - fy], ly, ty)
                out.gray(d)
                y += 1
            if y >= h:
                break
        dy, ly, ty = _median_codes(Y[y], Y[y - fy], ly, ty)
        du, lu, tu = _median_codes(U[cy], U[cy - fc], lu, tu)
        dv, lv, tv = _median_codes(V[cy], V[cy - fc], lv, tv)
        out.yuv(dy, du, dv)
        y += 1
        cy += 1
    return out


def _rgb_symbols(px: np.ndarray, s: Stream) -> _Symbols:
    """Mirror of the decoder's RGB branch; ``px`` (H, W, 4) B, G, R, A
    top row first.  The stream is the bottom row first; the left
    predictor's sums run on across rows, so each residual is a sample's
    accumulator less the one before it in stream order."""
    rows = np.asarray(px, np.int64)[::-1]
    h = rows.shape[0]
    alpha = s.bpp == 32
    fy = 2 if s.interlaced else 1
    acc = rows.copy()
    if s.predictor == 1:   # row j of the stream gets row j - fy added
        acc[1 + s.interlaced:] -= rows[1 + s.interlaced - fy:h - fy]
    flat = (acc & 255).reshape(-1, 4)
    out = _Symbols()
    b, g, r, a = (int(v) for v in flat[0])
    out.raw(*((a, r, g, b) if alpha else (r, g, b, 0)))
    if len(flat) > 1:
        out.rgb((flat[1:] - flat[:-1]) & 255, s.decorrelate, alpha)
    return out


def frame_symbols(picture, s: Stream):
    """(tables, values) of one frame's fields in stream order (a picture
    as :func:`encode_frame` takes it)."""
    if s.bpp < 24:
        return _yuv_symbols(picture, s).arrays()
    px = np.asarray(picture)
    if px.shape[-1] == 3:
        px = np.concatenate([px, np.full(px.shape[:2] + (1,), 255,
                                         px.dtype)], -1)
    return _rgb_symbols(px, s).arrays()


def pack(tables: np.ndarray, values: np.ndarray, s: Stream) -> bytes:
    """The fields as a chunk: codes (raw fields 8 bits) most significant
    bit first, zero-padded to a word, stored as 32-bit little-endian
    words."""
    # a fourth table for the raw fields: every value its own 8-bit code
    key = np.where(tables < 0, 3, tables) * 256 + values
    codes = np.concatenate([s.codes.reshape(-1), np.arange(256)]).astype(
        np.uint64)[key]
    lengths = np.concatenate([s.lengths.reshape(-1), np.full(256, 8)]
                             ).astype(np.int64)[key]
    return pack_codes(codes, lengths)


def pack_codes(codes: np.ndarray, lengths: np.ndarray) -> bytes:
    """Codes (uint64, the low ``lengths`` bits of each, up to 32) most
    significant bit first, zero-padded to a word, as 32-bit little-endian
    words; empty for no codes."""
    if not codes.size:
        return b""
    lengths = lengths.astype(np.int64)
    ends = np.cumsum(lengths)
    starts = ends - lengths
    words = -(-int(ends[-1]) // 32)
    # each code (up to 32 bits) lands in its start word and the next: the
    # two halves of the code placed at its bit offset in 64 bits; the
    # codes' bits are disjoint, so summing the halves (exact in float64,
    # each word < 2 ** 32) sets them
    placed = codes << (64 - lengths - (starts & 31)).astype(np.uint64)
    at = starts >> 5
    out = np.bincount(at, (placed >> np.uint64(32)).astype(np.float64),
                      words + 1)
    out += np.bincount(at + 1, (placed & np.uint64(0xFFFFFFFF)).astype(
        np.float64), words + 1)
    return out[:words].astype("<u4").tobytes()


def huffman_lengths(counts: np.ndarray, limit: int = 24) -> np.ndarray:
    """Code lengths of a Huffman code for ``counts`` + 1 (every symbol
    gets a code), no longer than ``limit`` bits."""
    counts = np.asarray(counts, np.int64) + 1
    while True:
        heap = [(int(c), [k]) for k, c in enumerate(counts)]
        heapq.heapify(heap)
        lengths = np.zeros(len(counts), np.int64)
        while len(heap) > 1:
            c0, s0 = heapq.heappop(heap)
            c1, s1 = heapq.heappop(heap)
            lengths[s0 + s1] += 1
            heapq.heappush(heap, (c0 + c1, s0 + s1))
        if lengths.max() <= limit:
            return lengths.astype(np.uint8)
        counts = counts // 2 + 1


def store_lengths(lengths: np.ndarray) -> bytes:
    """A table's lengths run-length coded as FFmpeg's store_table codes
    them: runs of up to 255, ``value | repeat << 5`` for up to 7, else
    ``value`` then ``repeat``."""
    out, i, n = bytearray(), 0, len(lengths)
    while i < n:
        value, repeat = int(lengths[i]), 0
        while i < n and lengths[i] == value and repeat < 255:
            i += 1
            repeat += 1
        out += bytes([value, repeat]) if repeat > 7 else \
            bytes([value | repeat << 5])
    return bytes(out)


def make_stream(layout: str, predictor: str = "left",
                decorrelate: bool = False, height: int = 0,
                interlace: Optional[bool] = None, version: int = 2,
                pictures: Sequence = ()) -> Stream:
    """A stream's parameters; v2 tables from the residual counts of
    ``pictures`` (each as :func:`encode_frame` takes it), v1 the classic
    tables.  ``interlace`` None leaves the flag to the decoder's default
    (``height > 288``)."""
    bpp, pred = BPP[layout], PREDICTORS[predictor]
    interlaced = height > 288 if interlace is None else interlace
    if version == 1:
        # the bit count's predictor 3 is gradient, decorrelated for RGB
        decorrelate = decorrelate or (pred == 1 and bpp >= 24)
        (ll, cl), (lc, cc) = hp.CLASSIC_LUMA, hp.CLASSIC_CHROMA
        rgb = bpp >= 24
        lengths = np.stack([ll, ll if rgb else lc, ll if rgb else lc])
        codes = np.stack([cl, cl if rgb else cc, cl if rgb else cc])
        return Stream(bpp, pred, decorrelate, interlaced, lengths, codes)
    probe = Stream(bpp, pred, decorrelate, interlaced,
                   np.zeros((3, 256), np.uint8), np.zeros((3, 256), np.uint32))
    counts = np.zeros((3, 256), np.int64)
    for picture in pictures:
        t, v = frame_symbols(picture, probe)
        keep = t >= 0
        counts += np.bincount(t[keep] * 256 + v[keep],
                              minlength=768).reshape(3, 256)
    lengths = np.stack([huffman_lengths(c) for c in counts])
    codes = np.stack([hp.canonical_codes(t) for t in lengths])
    return Stream(bpp, pred, decorrelate, interlaced, lengths, codes)


def extradata(s: Stream, interlace: Optional[bool] = None) -> bytes:
    """A v2 stream's extradata: method, bits per pixel, the interlace
    flag (0x10 on, 0x20 off, 0 for the decoder's default), 0, then the
    three tables."""
    flag = 0 if interlace is None else 0x10 if interlace else 0x20
    return bytes([s.predictor | s.decorrelate << 6, s.bpp, flag, 0]) + \
        b"".join(store_lengths(t) for t in s.lengths)


def encode_frame(picture, s: Stream) -> bytes:
    """One frame's chunk.  ``picture``: (H, W, 3) B, G, R or (H, W, 4)
    B, G, R, A for RGB; (Y (H, W), U, V (rows, W / 2)) for YUV, the
    chroma rows H for YUY2 and ceil(H / 2) for yuv420p."""
    return pack(*frame_symbols(picture, s), s)


def write_huffyuv_avi(path: Path, pictures: Sequence, height: int,
                      width: int, layout: str = "rgb24",
                      predictor: str = "left", decorrelate: bool = False,
                      codec: Optional[str] = None, version: int = 2,
                      interlace: Optional[bool] = None,
                      bit_count: Optional[int] = None,
                      extra: Optional[bytes] = None, stream: int = 0,
                      others=(), fps: int = 30) -> Stream:
    """An AVI of ``pictures`` (as :func:`encode_frame` takes them) in
    ``layout`` (``"rgb24"``, ``"rgb32"``, ``"yuy2"``, ``"yuv420p"``),
    under ``codec`` (default ``FFVH`` for yuv420p, else ``HFYU``).
    ``interlace`` None writes no interlace flag (the decoder's default,
    ``height > 288``); ``bit_count`` and ``extra`` override the header's
    (v1's default bit count has the predictor in its low bits).  Returns
    the stream's parameters."""
    s = make_stream(layout, predictor, decorrelate, height, interlace,
                    version, pictures)
    write_stream_avi(path, [encode_frame(p, s) for p in pictures], s,
                     height, width, codec or ("FFVH" if layout == "yuv420p"
                                              else "HFYU"),
                     version, interlace, bit_count, extra, stream, others,
                     fps)
    return s


def write_stream_avi(path: Path, payloads: Sequence[bytes], s: Stream,
                     height: int, width: int, codec: str = "HFYU",
                     version: int = 2, interlace: Optional[bool] = None,
                     bit_count: Optional[int] = None,
                     extra: Optional[bytes] = None, stream: int = 0,
                     others=(), fps: int = 30) -> None:
    """The AVI of frames already encoded for ``s`` (see
    :func:`write_huffyuv_avi`)."""
    if version == 1:
        low = {(0, False): 1, (0, True): 2, (1, False): 3, (1, True): 3,
               (2, False): 4}[(s.predictor, s.decorrelate)]
        bits, ext = s.bpp | low, b""
    else:
        bits, ext = s.bpp, extradata(s, interlace)
    if bit_count is not None:
        bits = bit_count
    if extra is not None:
        ext = extra
    tag = codec.encode()
    strh, strf = video_headers(height, width, tag, bits, len(payloads),
                               max(map(len, payloads), default=0), fps,
                               compression=tag,
                               image_size=width * height * 3)
    write_avi(path, strh, strf + ext, payloads, b"dc", fps=fps,
              stream=stream, others=others)


def stream_params(s: Stream, codec: str = "HFYU", version: int = 2
                  ) -> hp.HuffyuvParams:
    """The decoder's parameters for frames encoded for ``s``."""
    return hp.HuffyuvParams(codec, version, s.predictor, s.decorrelate,
                            s.bpp, s.interlaced, s.lengths, s.codes)


def to_planes(frame_bgr: np.ndarray, layout: str):
    """Test content for a YUV layout from a BGR frame: its G channel as
    Y, its B and R channels' even columns (and, for yuv420p, even rows) as
    U and V."""
    b, g, r = (frame_bgr[..., k] for k in range(3))
    if layout == "yuy2":
        return g, b[:, 0::2], r[:, 0::2]
    return g, b[0::2, 0::2], r[0::2, 0::2]

