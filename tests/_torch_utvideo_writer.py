"""Ut Video encoder and AVI writer for the port's UtVideo tests and
``chip_smoke.py`` (NumPy, no cv2 or FFmpeg).

``encode_frame`` writes one frame as FFmpeg's utvideo encoder
(utvideoenc.c) lays it out
(``camera_linearity_tpu_torch/native/utvideo_plain.py`` has the decoder's
rules, which this inverts): each plane's 256 code lengths, its slices'
cumulative end offsets and their data, then the frame-information word
(the predictor in bits 8-9).  A slice codes each sample's residual after
the none, left, gradient or median predictor (computed from the known
picture with array operations, so a 4K frame encodes in seconds), most
significant bit first, zero-padded to 32 bits and stored as 32-bit
little-endian words.  The code lengths are FFmpeg's
``ff_huff_gen_len_table`` of the plane's residual counts (replayed with
its heap and ties, so cv2's frames come out byte for byte), or given;
a plane of one residual is a fill plane (length 0 at that symbol, 255 at
the others, empty slices).

``write_utvideo_avi`` writes the container with
``tests/_torch_rawvideo_writer.write_avi`` and the 16 bytes of extradata
FFmpeg's encoder writes (version ``0x010000f0``, the original format,
frame-information size 4, the flags: slices - 1 in the top byte, bit 0
Huffman coding, ``0x800`` interlaced).  At :func:`cv2_slices` and the
left predictor a ``ULY0`` stream's chunks equal what
``cv2.VideoWriter`` writes for the same planes.
"""
from __future__ import annotations

import struct
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np

from camera_linearity_tpu_torch.native import utvideo_plain as up
from tests._torch_huffyuv_writer import pack_codes
from tests._torch_rawvideo_writer import video_headers, write_avi

__all__ = ["PREDICTORS", "ORIGINAL_FORMATS", "cv2_slices", "flags",
           "extradata", "huff_lengths", "codes_for", "residuals",
           "encode_plane", "encode_frame", "to_planes",
           "write_utvideo_avi", "write_chunks_avi", "stream_params"]

PREDICTORS = {"none": 0, "left": 1, "gradient": 2, "median": 3}
# what FFmpeg's encoder stores as the original format, by layout
ORIGINAL_FORMATS = {"gbrp": b"\0\0\1\x18", "gbrap": b"\0\0\2\x18",
                    "yuv420p": b"YV12", "yuv422p": b"YUY2",
                    "yuv444p": b"YV24"}


def cv2_slices(layout: str, height: int) -> int:
    """FFmpeg's default slice count: one per 120 rows of the chroma
    height, 1 to 256."""
    sub = height // 2 if layout == "yuv420p" else height
    return min(max(sub // 120, 1), 256)


def flags(slices: int, interlaced: bool = False,
          compression: bool = True) -> int:
    return (slices - 1) << 24 | up.INTERLACED * interlaced | int(compression)


def extradata(layout: str, slices: int, interlaced: bool = False,
              compression: bool = True, info_size: int = 4) -> bytes:
    return b"\xf0\0\0\x01" + ORIGINAL_FORMATS[layout] + struct.pack(
        "<II", info_size, flags(slices, interlaced, compression))


def _sift(h: list, root: int, size: int) -> None:
    """huffman.c's heap_sift over [value, name] pairs."""
    while root * 2 + 1 < size:
        child = root * 2 + 1
        if child < size - 1 and h[child][0] > h[child + 1][0]:
            child += 1
        if h[root][0] > h[child][0]:
            h[root], h[child] = h[child], h[root]
            root = child
        else:
            break


def huff_lengths(counts: np.ndarray) -> np.ndarray:
    """``ff_huff_gen_len_table(dst, counts, 256, skip0=1)``: code lengths
    for the used symbols (255 for the others), under 32 bits; a longer
    code makes it retry with a doubled offset added to every count."""
    used = [s for s in range(len(counts)) if counts[s]]
    size = len(used)
    out = np.full(len(counts), 255, np.uint8)
    offset = 1
    while True:
        h = [[(int(counts[s]) << 14) + offset, i] for i, s in enumerate(used)]
        for i in range(size // 2 - 1, -1, -1):
            _sift(h, i, size)
        up_ = [0] * (2 * size)
        for nxt in range(size, 2 * size - 1):
            min1 = h[0][0]
            up_[h[0][1]] = nxt
            h[0][0] = 1 << 63
            _sift(h, 0, size)
            up_[h[0][1]] = nxt
            h[0][1] = nxt
            h[0][0] += min1
            _sift(h, 0, size)
        ln = [0] * (2 * size)
        for i in range(2 * size - 3, size - 1, -1):
            ln[i] = ln[up_[i]] + 1
        ok = True
        for i, s in enumerate(used):
            out[s] = ln[up_[i]] + 1
            if out[s] >= 32:
                ok = False
                break
        if ok:
            return out
        offset <<= 1


def codes_for(lengths: np.ndarray) -> np.ndarray:
    """utvideoenc.c's calculate_codes: sorted by (length, symbol), codes
    given from the last (longest, largest symbol) up, from 0."""
    he = sorted(((int(n), s) for s, n in enumerate(lengths)))
    last = 255
    while he[last][0] == 255 and last:
        last -= 1
    codes = np.zeros(len(lengths), np.uint64)
    code = 0
    for i in range(last, -1, -1):
        n, s = he[i]
        codes[s] = code >> (32 - n)
        code += 0x80000000 >> (n - 1)
    return codes


def _mid(a, b, c):
    return np.maximum(np.minimum(a, b), np.minimum(np.maximum(a, b), c))


def residuals(rows: np.ndarray, predictor: int) -> np.ndarray:
    """One slice's residuals ((rows, columns) uint8 in, int64 out, mod
    256; an interlaced slice's row pairs as rows of twice the width)."""
    x = rows.astype(np.int64)
    if predictor == up.NONE or not x.size:
        return x
    flat = x.reshape(-1)
    if predictor == up.LEFT:
        return ((flat - np.concatenate([[0x80], flat[:-1]])) & 255
                ).reshape(x.shape)
    res = np.empty_like(x)
    res[0] = (x[0] - np.concatenate([[0x80], x[0, :-1]])) & 255
    if len(x) < 2:
        return res
    top, cur = x[:-1], x[1:]
    if predictor == up.GRADIENT:
        pred = top.copy()
        pred[:, 1:] = (top[:, 1:] - top[:, :-1] + cur[:, :-1]) & 255
        res[1:] = (cur - pred) & 255
        return res
    # median: the left neighbours run on from the end of the row above
    w = x.shape[1]
    left = np.concatenate([[0], flat[:-1]])[w:].reshape(cur.shape)
    tflat = top.reshape(-1)
    lt = np.concatenate([[0], tflat[:-1]]).reshape(top.shape)
    pred = _mid(left, top, (left + top - lt) & 255)
    pred[0, 0] = top[0, 0]
    res[1:] = (cur - pred) & 255
    return res


def encode_plane(plane: np.ndarray, k: int, p: up.UtvideoParams,
                 predictor: int, lengths: Optional[np.ndarray] = None
                 ) -> bytes:
    """Plane ``k`` of a frame: its code lengths, slice end offsets and
    slices.  ``lengths`` (256 values, 255 unused) replaces the counts'
    Huffman code."""
    rows, cols = plane.shape
    pair = 2 if p.interlaced else 1
    spans = up.slice_rows(p, k, rows)
    res = [residuals(plane[r0:r1].reshape((r1 - r0) // pair, cols * pair),
                     predictor).reshape(-1) for r0, r1 in spans]
    allres = np.concatenate(res) if res else np.zeros(0, np.int64)
    counts = np.bincount(allres, minlength=256)
    if lengths is None:
        nz = np.flatnonzero(counts)
        if len(nz) == 1:
            table = np.full(256, 255, np.uint8)
            table[nz[0]] = 0
            return table.tobytes() + bytes(4 * p.slices)
        lengths = huff_lengths(counts)
    lengths = np.asarray(lengths, np.uint8)
    codes = codes_for(lengths)
    used = np.where(lengths == 255, 0, lengths)
    data = [pack_codes(codes[r], used[r]) for r in res]
    ends = np.cumsum([len(d) for d in data])
    return lengths.tobytes() + struct.pack(f"<{p.slices}I", *ends) + \
        b"".join(data)


def encode_frame(planes: Sequence[np.ndarray], p: up.UtvideoParams,
                 predictor: int, lengths: Optional[Sequence] = None
                 ) -> bytes:
    """One frame's chunk from its stored planes (:func:`to_planes`)."""
    return b"".join(encode_plane(
        pl, k, p, predictor, None if lengths is None else lengths[k])
        for k, pl in enumerate(planes)) + struct.pack("<I", predictor << 8)


def to_planes(picture, layout: str) -> List[np.ndarray]:
    """The stored planes of a picture: for RGB a (H, W, 3) B, G, R or
    (H, W, 4) B, G, R, A frame as G, B - G + 0x80, R - G + 0x80 (and A);
    for YUV the (Y, U, V) planes as given."""
    if layout in ("gbrp", "gbrap"):
        px = np.asarray(picture).astype(np.int64)
        g = px[..., 1]
        planes = [g, (px[..., 0] - g + 0x80) & 255,
                  (px[..., 2] - g + 0x80) & 255]
        if layout == "gbrap":
            planes.append(px[..., 3])
        return [pl.astype(np.uint8) for pl in planes]
    return [np.ascontiguousarray(c, np.uint8) for c in picture]


def stream_params(fourcc: str, slices: int, interlaced: bool = False
                  ) -> up.UtvideoParams:
    return up.params(fourcc, extradata(up.LAYOUTS[fourcc], slices,
                                       interlaced))


def write_chunks_avi(path: Path, payloads: Sequence[bytes], fourcc: str,
                     height: int, width: int, extra: bytes,
                     stream: int = 0, others=(), fps: int = 30) -> None:
    """The AVI of frames already encoded, under ``fourcc`` with ``extra``
    after the BITMAPINFOHEADER."""
    tag = fourcc.encode()
    bits = 32 if fourcc.endswith("RA") else 24
    strh, strf = video_headers(height, width, tag, bits, len(payloads),
                               max(map(len, payloads), default=0), fps,
                               compression=tag,
                               image_size=width * height * 3)
    write_avi(path, strh, strf + extra, payloads, b"dc", fps=fps,
              stream=stream, others=others)


def write_utvideo_avi(path: Path, pictures: Sequence, height: int,
                      width: int, fourcc: str = "ULRG",
                      predictor: str = "left", slices: Optional[int] = None,
                      interlaced: bool = False, compression: bool = True,
                      lengths: Optional[Sequence] = None, stream: int = 0,
                      others=(), fps: int = 30) -> List[bytes]:
    """An AVI of ``pictures`` (as :func:`to_planes` takes them for the
    fourcc's layout) coded with ``predictor`` in ``slices`` slices
    (default :func:`cv2_slices`); returns the frame chunks."""
    layout = up.LAYOUTS[fourcc]
    if slices is None:
        slices = cv2_slices(layout, height)
    extra = extradata(layout, slices, interlaced, compression)
    p = up.params(fourcc, extra)
    chunks = [encode_frame(to_planes(pic, layout), p, PREDICTORS[predictor],
                           lengths) for pic in pictures]
    write_chunks_avi(path, chunks, fourcc, height, width, extra, stream,
                     others, fps)
    return chunks
