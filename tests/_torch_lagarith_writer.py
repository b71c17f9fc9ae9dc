"""Lagarith encoder and AVI writer for the port's Lagarith tests (NumPy, no
cv2 or FFmpeg).

``encode_frame`` writes one frame chunk as FFmpeg's lagarith decoder reads
it (``camera_linearity_tpu_torch/native/lagarith_plain.py`` has the rules,
which this inverts): the frame type, the planes' offsets, then each
plane.  A plane holds the residuals of the decoder's predictor (computed
from the known picture with array operations) under one escape form:

* 0-3: range coded (the encoder mirrors ``lagarithrac``'s decoder: it
  renormalises before each symbol, and the carry runs back into the
  bytes written), escape ``e`` > 0 replacing the zeros after ``e`` zero
  residuals with one run symbol, and storing the symbol count as the
  32-bit length (FFmpeg takes it only where it is below the sample count:
  a plane with too few zeros for that is refused here unless ``length``
  is given).  The probability header holds the symbols' counts, scaled
  down to a total of at most 2^22 and nudged until every coded symbol
  keeps a nonzero probability after the decoder's own scaling;
* 4: raw residuals; 0xff: a filled plane (a constant plane, no
  prediction).  The tests write the zero-run planes (escapes 5-7) by
  hand.

``tests/_torch_lagarith_enc.cpp`` (:func:`native_encode`) gives the same
bytes for the range-coded, raw and filled forms, a frame a thread, for
the 4K videos of ``chip_smoke.py``.

``write_lagarith_avi`` writes the container with
``tests/_torch_rawvideo_writer.write_avi`` (``LAGS``, ``biBitCount`` 24 or
32); ``encode_picture`` is the frame of a BGR picture (RGB24 or RGBA) or
of (Y, U, V) planes (YUY2, YV12).
"""
from __future__ import annotations

import ctypes
import os
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np

from camera_linearity_tpu_torch.native import lagarith_plain as lp
from tests._torch_rawvideo_writer import video_headers, write_avi

__all__ = ["FRAME_TYPES", "prob_header", "range_encode", "counts_for",
           "residuals", "run_symbols", "encode_plane", "encode_frame",
           "encode_picture", "coded_planes", "solid_frame",
           "write_lagarith_avi", "native_encoder", "native_encode"]

# name: frame type
FRAME_TYPES = {"rgb24": lp.ARITH_RGB24, "urgb24": lp.U_RGB24,
               "rgba": lp.ARITH_RGBA, "yuy2": lp.ARITH_YUY2,
               "yv12": lp.ARITH_YV12}
MAX_TOTAL = 1 << 22


def prob_header(probs: Sequence[int]) -> bytes:
    """The probability header of 256 counts, zero-padded to a byte: each
    count's code, a zero count followed by the number of zero counts after
    it."""
    bits, i = [], 0
    probs = [int(p) for p in probs]
    while i < 256:
        bits.append(lp.prob_bits(probs[i]))
        i += 1
        if not probs[i - 1]:
            run = 0
            while i + run < 256 and not probs[i + run]:
                run += 1
            bits.append(lp.prob_bits(run))
            i += run
    text = "".join(bits)
    text += "0" * (-len(text) % 8)
    return int(text, 2).to_bytes(len(text) // 8, "big") if text else b""


def range_encode(symbols: Sequence[int], cum: Sequence[int],
                 scale: int) -> bytes:
    """The range coder's bytes for ``symbols`` under the decoder's
    cumulative table ``cum`` (``lagarith_plain.scale_probs``)."""
    out = bytearray()
    low, rng, width = 0, 0x80, 7
    for s in symbols:
        while rng <= 0x800000:
            low <<= 8
            rng <<= 8
            width += 8
            if width > 31:
                out.append(low >> 31)
                low &= (1 << 31) - 1
                width = 31
        rs = rng >> scale
        low += rs * cum[s]
        rng = rng - rs * cum[255] if s == 255 else \
            rs * (cum[s + 1] - cum[s])
        if low >> width:
            low -= 1 << width
            j = len(out) - 1
            while out[j] == 0xFF:
                out[j] = 0
                j -= 1
            out[j] += 1
    total = (int.from_bytes(bytes(out), "big") << width) | low
    nbits = 8 * len(out) + width
    pad = -nbits % 8
    return (total << pad).to_bytes((nbits + pad) // 8, "big")


def counts_for(symbols: np.ndarray) -> List[int]:
    """Header counts for ``symbols``: their histogram, scaled down to a
    total of at most 2^22, with every coded symbol's scaled probability
    nonzero (and one of symbols 0-127 nonzero, as FFmpeg asks)."""
    hist = np.bincount(np.asarray(symbols, np.int64), minlength=256)
    total = int(hist.sum())
    if total > MAX_TOTAL:
        hist = np.where(hist > 0, np.maximum(hist * MAX_TOTAL // total, 1),
                        0)
    counts = [int(v) for v in hist]
    if not any(counts[:128]):
        counts[0] = 1
    for _ in range(64):
        cum, _scale = lp.scale_probs(counts)
        dead = [s for s in range(256) if hist[s] and cum[s + 1] == cum[s]]
        if not dead:
            return counts
        for s in dead:
            counts[s] += 1 + counts[s]
    raise ValueError("no counts keep every symbol")


def _mid(a, b, c):
    return np.maximum(np.minimum(a, b), np.minimum(np.maximum(a, b), c))


def residuals(plane: np.ndarray, predictor: str) -> np.ndarray:
    """The residuals (uint8) of a plane in coded order under the
    decoder's ``predictor`` (``"median"``, ``"yv12"``, ``"yuy2_luma"``,
    ``"yuy2_chroma"``)."""
    x = np.asarray(plane, np.int64)
    h, w = x.shape
    flat = x.reshape(-1)
    res = np.empty_like(flat)
    first = flat[:w]
    res[:w] = first - np.concatenate([[0], first[:-1]])
    yuy2 = predictor.startswith("yuy2")
    if predictor == "yuy2_luma":
        res[0] = first[0]
        if w > 1:
            res[1] = first[1]
    if h > 1:
        j = np.arange(w, h * w)
        left, top = flat[j - 1], flat[j - w]
        tl = flat[np.maximum(j - w - 1, 0)]
        tl[0] = flat[0] if predictor == "yv12" else flat[w - 1]
        grad = left + top - tl
        pred = _mid(left, top, grad & 255 if yuy2 else grad)
        if yuy2:
            head = min(4 if predictor == "yuy2_luma" else 2, w)
            pred[:head] = left[:head]
        res[w:] = flat[w:] - pred
    return (res & 255).astype(np.uint8).reshape(h, w)


def run_symbols(res: np.ndarray, esc: int) -> np.ndarray:
    """The coded symbols of residuals (flattened) under escape ``esc``:
    after ``esc`` zeros in a row, one symbol for up to 255 more."""
    flat = np.asarray(res, np.uint8).reshape(-1)
    if not esc:
        return flat.copy()
    out, zeros, p, n = [], 0, 0, flat.size
    nz = np.flatnonzero(flat)
    nxt = np.searchsorted
    while p < n:
        v = int(flat[p])
        out.append(v)
        p += 1
        zeros = zeros + 1 if v == 0 else 0
        if zeros == esc:
            k = nxt(nz, p)
            stop = int(nz[k]) if k < nz.size else n
            run = min(stop - p, 255)
            out.append(run // 2 if run % 2 == 0 else 256 - (run + 1) // 2)
            p += run
            zeros = 0
    return np.array(out, np.uint8)


def encode_plane(plane: np.ndarray, predictor: str,
                 esc: Optional[int] = None) -> bytes:
    """One plane (coded order) under escape ``esc`` (0-4; None: 1 where
    its zero runs leave fewer symbols than samples, else 0); a constant
    plane as a filled one (escape 0xff)."""
    x = np.asarray(plane, np.uint8)
    if x.size and (x == x.flat[0]).all():
        return bytes([0xFF, int(x.flat[0])])
    res = residuals(x, predictor)
    if esc is None:
        esc = int(run_symbols(res, 1).size < x.size)
    if esc == 4:
        return b"\4" + res.tobytes()
    sym = run_symbols(res, esc)
    if esc and sym.size >= x.size:
        raise ValueError(f"{sym.size} symbols for {x.size} samples: FFmpeg "
                         "would not take the length")
    counts = counts_for(sym)
    cum, scale = lp.scale_probs(counts)
    head = bytes([esc]) + (int(sym.size).to_bytes(4, "little") if esc
                           else b"")
    return head + prob_header(counts) + range_encode(sym.tolist(), cum,
                                                     scale)


def _predictors(frame_type: int, width: int, shapes) -> List[str]:
    if frame_type == lp.ARITH_YUY2:
        return ["yuy2_luma"] + ["yuy2_luma" if c == width else "yuy2_chroma"
                                for _, c in shapes[1:]]
    return ["yv12" if frame_type == lp.ARITH_YV12 else "median"] * len(shapes)


def coded_planes(frame_type: int, picture) -> List[np.ndarray]:
    """A picture's planes as the chunk stores them, in coded order: for
    RGB a (H, W, 3) B, G, R or (H, W, 4) B, G, R, A picture as B - G, G,
    R - G (and A), bottom row first; for YUY2 (Y, U, V) and YV12 (Y, V, U)
    from (Y, U, V) planes."""
    if frame_type in (lp.ARITH_YUY2, lp.ARITH_YV12):
        y, u, v = (np.ascontiguousarray(c, np.uint8) for c in picture)
        return [y, u, v] if frame_type == lp.ARITH_YUY2 else [y, v, u]
    px = np.asarray(picture).astype(np.int64)[::-1]
    g = px[..., 1]
    planes = [(px[..., 0] - g) & 255, g, (px[..., 2] - g) & 255]
    if frame_type == lp.ARITH_RGBA:
        planes.append(px[..., 3])
    return [pl.astype(np.uint8) for pl in planes]


def encode_frame(frame_type: int, planes: Sequence[np.ndarray],
                 esc: Optional[int] = None,
                 width: Optional[int] = None) -> bytes:
    """A chunk of coded planes (:func:`coded_planes`) under escape
    ``esc`` (as :func:`encode_plane` takes it).  ``width`` is the
    picture's (it picks YUY2's luma rule; default the first plane's)."""
    width = planes[0].shape[1] if width is None else width
    preds = _predictors(frame_type, width, [p.shape for p in planes])
    return _assemble(frame_type, [encode_plane(p, preds[k], esc)
                                  for k, p in enumerate(planes)])


def _assemble(frame_type: int, bodies: Sequence[bytes]) -> bytes:
    """A chunk of coded plane bodies: the type, the offsets, the bodies."""
    head = 13 if frame_type == lp.ARITH_RGBA else 9
    offs = np.cumsum([head] + [len(b) for b in bodies])
    fields = [int(offs[1]), int(offs[2])] + \
        ([int(offs[3])] if frame_type == lp.ARITH_RGBA else [])
    return bytes([frame_type]) + b"".join(
        f.to_bytes(4, "little") for f in fields) + b"".join(bodies)


def encode_picture(kind: str, picture, **kw) -> bytes:
    """The chunk of a picture (:func:`coded_planes`) as frame ``kind``
    (a key of ``FRAME_TYPES``)."""
    t = FRAME_TYPES[kind]
    planes = coded_planes(t, picture)
    return encode_frame(t, planes, width=planes[0].shape[1], **kw)


def solid_frame(*values: int) -> bytes:
    """A solid frame: one value (grey), three (B, G, R) or four (B, G, R,
    A)."""
    t = {1: lp.SOLID_GRAY, 3: lp.SOLID_COLOR, 4: lp.SOLID_RGBA}[len(values)]
    return bytes([t, *values])


def write_lagarith_avi(path: Path, payloads: Sequence[bytes], height: int,
                       width: int, bit_count: int = 24, stream: int = 0,
                       others=(), fps: int = 30) -> None:
    """An AVI of Lagarith frame chunks (empty ones are null frames)."""
    strh, strf = video_headers(height, width, b"LAGS", bit_count,
                               len(payloads),
                               max(map(len, payloads), default=0), fps,
                               image_size=width * height * bit_count // 8)
    write_avi(path, strh, strf, payloads, b"dc", fps=fps, stream=stream,
              others=others)


# --- the native encoder ----------------------------------------------------

_ENC_SRC = Path(__file__).resolve().parent / "_torch_lagarith_enc.cpp"
_enc_lib = None


def native_encoder():
    """``tests/_torch_lagarith_enc.cpp``, built with g++ on first use into
    ``build/native/`` (as the port's native libraries are); raises
    RuntimeError where it does not build."""
    global _enc_lib
    if _enc_lib is not None:
        return _enc_lib
    from camera_linearity_tpu_torch import native
    path = native._lib_path("_lagarith_enc", _ENC_SRC)
    if not path.exists() and not native._build(path, _ENC_SRC):
        raise RuntimeError("tests/_torch_lagarith_enc.cpp did not build: "
                           f"{native.build_error('_lagarith_enc')}")
    lib = ctypes.CDLL(str(path))
    i = ctypes.c_int
    lib.clt_lagarith_enc_frame.argtypes = [i, ctypes.c_void_p, i, i, i,
                                           ctypes.c_void_p, ctypes.c_size_t]
    lib.clt_lagarith_enc_frame.restype = ctypes.c_longlong
    _enc_lib = lib
    return lib


def native_encode(kind: str, pictures, esc: Optional[int] = None,
                  threads: int = 0) -> List[bytes]:
    """The chunks of ``pictures`` as frame ``kind`` (as
    :func:`encode_picture` takes them, escape 0-4 or None), a frame a
    thread on up to ``threads`` threads (0: every CPU).  The same bytes as
    :func:`encode_picture`'s."""
    lib = native_encoder()
    t = FRAME_TYPES[kind]

    def code(pic):
        if t in (lp.ARITH_YUY2, lp.ARITH_YV12):
            src = np.concatenate([np.ascontiguousarray(c, np.uint8).reshape(-1)
                                  for c in pic])
            h, w = np.shape(pic[0])
        else:
            src = np.ascontiguousarray(pic, np.uint8)
            h, w = src.shape[:2]
        cap = 2 * src.size + 4096
        buf = np.empty(cap, np.uint8)
        n = lib.clt_lagarith_enc_frame(t, src.ctypes.data, h, w,
                                       -1 if esc is None else esc,
                                       buf.ctypes.data, cap)
        if n < 0:
            raise RuntimeError(f"the native Lagarith encoder failed ({n})")
        return buf[:n].tobytes()

    with ThreadPoolExecutor(threads or os.cpu_count() or 1) as pool:
        return list(pool.map(code, pictures))
