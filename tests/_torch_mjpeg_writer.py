"""An MJPG AVI writer in NumPy, for the tests and ``chip_smoke.py``.

The machine with the card has neither cv2 nor PIL, so ``chip_smoke.py``
encodes its config-5 videos with this.  It writes what ``cv2.VideoWriter``
writes for ``VideoWriter_fourcc(*"MJPG")`` (``tests/data/mjpg 5ms.avi``):
baseline JPEG frames in 4:2:0 (Y 2x2, Cb and Cr 1x1), one quantization
table for all three components, Annex K's Huffman tables in a DHT, no DRI,
and no APP0 (component IDs 1, 2, 3 say YCbCr); one ``00dc`` chunk a frame.
It also writes 4:4:4, 4:2:2, 4:1:1 and 4:4:0, grayscale, restart
intervals, one scan a component and progressive frames (spectral
selection), the modes of FFmpeg's MJPEG decoder the port reproduces.

The encoder: JFIF's YCbCr conversion, chroma means over each chroma
sample's luma pixels, the FDCT as two
matrix products per 8 x 8 block, libjpeg's quality scaling of Annex K's
luminance table, and vectorised entropy coding, bit packing and byte
stuffing.  Every step works block by block, so a frame's first MCU rows
encode to the same coefficients whatever rows follow them.  Test tooling,
not a feature of the package: it imports nothing of it.
"""
from __future__ import annotations

import struct
from pathlib import Path
from typing import Iterable, Sequence

import numpy as np

from tests._torch_rawvideo_writer import Stream, video_headers, write_avi

__all__ = ["encode_jpeg", "write_mjpg_avi", "QUALITY", "SAMPLING"]

QUALITY = 75

_LUMINANCE = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99],
    np.int64)
_ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])

# Annex K.3: (counts of code lengths 1..16, symbols)
_DC_LUM = ((0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0), bytes(range(12)))
_DC_CHROM = ((0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0),
             bytes(range(12)))
_AC_LUM = ((0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D), bytes.fromhex(
    "01020300041105122131410613516107227114328191a1082342b1c11552d1f0"
    "2433627282090a161718191a25262728292a3435363738393a43444546474849"
    "4a535455565758595a636465666768696a737475767778797a83848586878889"
    "8a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5"
    "c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8"
    "f9fa"))
_AC_CHROM = ((0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77),
             bytes.fromhex(
    "000102031104052131061241510761711322328108144291a1b1c109233352f0"
    "156272d10a162434e125f11718191a262728292a35363738393a434445464748"
    "494a535455565758595a636465666768696a737475767778797a828384858687"
    "88898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3"
    "c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8"
    "f9fa"))

# the orthonormal DCT-II matrix, which is JPEG's FDCT scaling
_U = np.arange(8)[:, None]
_DCT = np.cos((2 * np.arange(8)[None, :] + 1) * _U * np.pi / 16) * \
    np.where(_U == 0, np.sqrt(1 / 8), 1 / 2)


def _codes(spec):
    """Canonical Huffman codes: (code, length) arrays indexed by symbol."""
    counts, symbols = spec
    code = np.zeros(256, np.int64)
    length = np.zeros(256, np.int64)
    c, p = 0, 0
    for n, k in enumerate(counts, 1):
        for _ in range(k):
            code[symbols[p]], length[symbols[p]] = c, n
            c += 1
            p += 1
        c <<= 1
    return code, length


_TABLES = [(_codes(_DC_LUM), _codes(_AC_LUM)),
           (_codes(_DC_CHROM), _codes(_AC_CHROM))]


def _quant_table(quality: int) -> np.ndarray:
    """jcparam.c's jpeg_quality_scaling and jpeg_add_quant_table
    (baseline: entries kept in 1..255)."""
    quality = min(max(quality, 1), 100)
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    return np.clip((_LUMINANCE * scale + 50) // 100, 1, 255)


def _blocks(plane: np.ndarray) -> np.ndarray:
    """(rows, cols) -> (rows/8, cols/8, 8, 8)."""
    r, c = plane.shape
    return plane.reshape(r // 8, 8, c // 8, 8).swapaxes(1, 2)


def _size(v: np.ndarray) -> np.ndarray:
    """JPEG's magnitude category: the bit length of |v|."""
    a = np.abs(v)
    n = np.zeros(a.shape, np.int64)
    while np.any(a >> n):
        n += (a >> n) != 0
    return n


def _bits(v: np.ndarray, n: np.ndarray) -> np.ndarray:
    """The n extra bits of v (negative v: its ones' complement)."""
    return np.where(v < 0, v + (1 << n) - 1, v)


# (horizontal, vertical) sampling factors of Y; Cb and Cr are 1x1
SAMPLING = {"444": (1, 1), "422": (2, 1), "420": (2, 2), "411": (4, 1),
            "440": (1, 2)}


def encode_jpeg(bgr: np.ndarray, quality: int = QUALITY,
                sampling: str = "420", restart: int = 0,
                progressive: bool = False, separate: bool = False,
                convert: bool = True) -> bytes:
    """One frame as a JPEG: an (H, W, 3) BGR uint8 frame in ``sampling``
    ("420", as ``cv2.VideoWriter`` writes it, "422", "444", "411" or
    "440"), or an (H, W) uint8 frame as grayscale (one component, Y the
    frame itself); a restart marker every ``restart`` MCUs (blocks in a
    one-component scan).  Baseline, one interleaved scan; or with
    ``progressive`` (SOF2) spectral selection without successive
    approximation: an interleaved DC scan, then AC bands 1-5 and 6-63 of
    each component in turn.  ``convert=False`` codes the three channels
    as they are, in their order (no YCbCr conversion: RGB in a TIFF)."""
    gray = bgr.ndim == 2
    hy, vy = (1, 1) if gray else SAMPLING[sampling]
    h, w = bgr.shape[:2]
    ph, pw = -(-h // (8 * vy)) * 8 * vy, -(-w // (8 * hy)) * 8 * hy
    if gray:
        img = np.pad(bgr.astype(np.float64), ((0, ph - h), (0, pw - w)),
                     mode="edge")
        planes = [img]
    else:
        img = np.pad(bgr.astype(np.float64),
                     ((0, ph - h), (0, pw - w), (0, 0)), mode="edge")
        b, g, r = img[..., 0], img[..., 1], img[..., 2]
        if convert:
            y = 0.299 * r + 0.587 * g + 0.114 * b
            cb = -0.168736 * r - 0.331264 * g + 0.5 * b + 128
            cr = 0.5 * r - 0.418688 * g - 0.081312 * b + 128
        else:
            y, cb, cr = b, g, r
        planes = [np.clip(np.round(y), 0, 255)]
        for c in (cb, cr):
            c = c.reshape(ph // vy, vy, pw // hy, hy).mean(axis=(1, 3))
            planes.append(np.clip(np.round(c), 0, 255))
    q = _quant_table(quality)
    qz = q[_ZIGZAG].astype(np.float64)
    mcu_y, mcu_x = ph // (8 * vy), pw // (8 * hy)
    coefs = []
    for plane in planes:
        f = _DCT @ (_blocks(plane - 128.0)) @ _DCT.T
        z = f.reshape(f.shape[:2] + (64,))[..., _ZIGZAG] / qz
        coefs.append((np.sign(z) * np.floor(np.abs(z) + 0.5)).astype(
            np.int64))
    factors = [(hy, vy)] + [(1, 1)] * (len(planes) - 1)
    if progressive:
        scans = [(tuple(range(len(planes))), 0, 0)] + [
            ((k,), ss, se) for ss, se in ((1, 5), (6, 63))
            for k in range(len(planes))]
    elif separate:
        scans = [((k,), 0, 63) for k in range(len(planes))]
    else:
        scans = [(tuple(range(len(planes))), 0, 63)]
    out = b""
    for comps, ss, se in scans:
        order, comp, unit = _scan_blocks(coefs, comps, factors, mcu_y, mcu_x,
                                         h, w, hy, vy)
        interval = unit // restart if restart else np.zeros_like(unit)
        out += _sos(comps, ss, se) + _entropy(order, comp, interval, ss, se)
    seg = _headers(q, h, w, factors, restart, progressive)
    return b"\xff\xd8" + seg + out + b"\xff\xd9"


def _scan_blocks(coefs, comps, factors, mcu_y, mcu_x, h, w, hy, vy):
    """A scan's blocks in coding order, with each one's component and
    unit: MCU order over the padded frame for several components; for
    one, its own blocks row by row (ceil(W / 8 / (hmax / h)) across)."""
    if len(comps) > 1:
        parts, comp = [], []
        for k in comps:
            hk, vk = factors[k]
            z = coefs[k].reshape(mcu_y, vk, mcu_x, hk, 64).swapaxes(1, 2)
            parts.append(z.reshape(mcu_y, mcu_x, hk * vk, 64))
            comp += [k] * (hk * vk)
        order = np.concatenate(parts, axis=2).reshape(-1, 64)
        n = len(comp)
        return (order, np.tile(np.array(comp), mcu_y * mcu_x),
                np.arange(len(order)) // n)
    k = comps[0]
    hk, vk = factors[k]
    nby = -(-h // (8 * (vy // vk)))
    nbx = -(-w // (8 * (hy // hk)))
    order = coefs[k][:nby, :nbx].reshape(-1, 64)
    return order, np.full(len(order), k), np.arange(len(order))


def _entropy(blocks: np.ndarray, comp: np.ndarray, interval: np.ndarray,
             ss: int = 0, se: int = 63) -> bytes:
    """Huffman-code the band ``ss``..``se`` (zigzag) of blocks (coding
    order) into stuffed bytes: the DC differences where the band starts at
    0, each component against its previous block in the same restart
    interval; the AC terms as run/size symbols with ZRLs and an EOB where
    the band's last terms are zero; each restart interval apart."""
    nb = len(blocks)
    values, lengths, keys = [], [], []
    table = np.where(comp == 0, 0, 1)
    if ss == 0:
        dc = blocks[:, 0]
        diff = np.empty(nb, np.int64)
        for c in np.unique(comp):
            at = np.flatnonzero(comp == c)
            prev = np.concatenate([[0], dc[at][:-1]])
            first = np.concatenate([[True],
                                    interval[at][1:] != interval[at][:-1]])
            diff[at] = dc[at] - np.where(first, 0, prev)
        n = _size(diff)
        for t in (0, 1):
            sel = table == t
            (code, length), _ = _TABLES[t]
            nn = n[sel]
            values.append((code[nn] << nn) | _bits(diff[sel], nn))
            lengths.append(length[nn] + nn)
            keys.append(np.flatnonzero(sel) * 128)
    lo = max(ss, 1)
    if se >= lo:
        # AC coefficients: run/size symbols, ZRLs for runs over 15, EOB
        ac = blocks[:, lo:se + 1]
        bi, k = np.nonzero(ac)
        k = k + lo
        prev = np.full_like(k, lo - 1)
        if len(k) > 1:
            prev[1:] = np.where(bi[1:] == bi[:-1], k[:-1], lo - 1)
        run = k - prev - 1
        v = blocks[bi, k]
        s = _size(v)
        t = table[bi]
        for tt in (0, 1):
            _, (code, length) = _TABLES[tt]
            sel = t == tt
            sym = ((run[sel] % 16) << 4) | s[sel]
            values.append((code[sym] << s[sel]) | _bits(v[sel], s[sel]))
            lengths.append(length[sym] + s[sel])
            keys.append(bi[sel] * 128 + 2 * k[sel] + 1)
            # ZRLs sort before their symbol (a run over 15 leaves room)
            reps = np.repeat(np.arange(sel.sum()), run[sel] // 16)
            values.append(np.full(len(reps), code[0xF0]))
            lengths.append(np.full(len(reps), length[0xF0]))
            keys.append(bi[sel][reps] * 128 + 2 * k[sel][reps] - 1)
        last = np.full(nb, lo - 1, np.int64)
        np.maximum.at(last, bi, k)
        eob = np.flatnonzero(last < se)
        for tt in (0, 1):
            _, (code, length) = _TABLES[tt]
            sel = eob[table[eob] == tt]
            values.append(np.full(len(sel), code[0x00]))
            lengths.append(np.full(len(sel), length[0x00]))
            keys.append(sel * 128 + 127)
    keys = np.concatenate(keys)
    order = np.argsort(keys, kind="stable")
    values = np.concatenate(values)[order]
    lengths = np.concatenate(lengths)[order]
    # each restart interval packs on its own, then RSTn between them
    item_interval = interval[keys[order] // 128]
    cuts = np.flatnonzero(np.diff(item_interval)) + 1
    parts = []
    for i, (a, b) in enumerate(zip(np.concatenate([[0], cuts]),
                                   np.concatenate([cuts, [len(values)]]))):
        if i:
            parts.append(bytes([0xFF, 0xD0 + (i - 1) % 8]))
        parts.append(_pack(values[a:b], lengths[a:b]))
    return b"".join(parts)


def _pack(values: np.ndarray, lengths: np.ndarray) -> bytes:
    """Concatenate codes MSB first, pad with 1 bits, stuff 0xFF bytes."""
    out = []
    shifts = np.arange(31, -1, -1)
    for at in range(0, len(values), 1 << 20):
        v = values[at:at + (1 << 20), None]
        n = lengths[at:at + (1 << 20), None]
        bits = ((v >> shifts) & 1).astype(np.uint8)
        out.append(bits[shifts[None, :] < n])
    bits = np.concatenate(out) if out else np.zeros(0, np.uint8)
    bits = np.concatenate([bits, np.ones(-len(bits) % 8, np.uint8)])
    data = np.packbits(bits)
    ff = np.flatnonzero(data == 0xFF)
    return np.insert(data, ff + 1, 0).tobytes()


def _seg(marker: int, body: bytes) -> bytes:
    return struct.pack(">BBH", 0xFF, marker, len(body) + 2) + body


def _segments(q: np.ndarray, h: int, w: int, hy: int, vy: int,
              restart: int) -> bytes:
    """DQT (one table), DHT (Annex K's four), DRI where there are restart
    markers, SOF0 (table 0 for every component), SOS (one interleaved
    scan of the three)."""
    return _headers(q, h, w, [(hy, vy), (1, 1), (1, 1)], restart) + \
        _sos((0, 1, 2), 0, 63)


def _headers(q: np.ndarray, h: int, w: int, factors, restart: int,
             progressive: bool = False) -> bytes:
    """DQT (one table), DHT (Annex K's four), DRI where there are restart
    markers, SOF0 (SOF2 when progressive; table 0 for every component,
    the first sampled ``factors[0]``, the others 1x1)."""
    dqt = _seg(0xDB, b"\x00" + bytes(q[_ZIGZAG].astype(np.uint8)))
    dht = b""
    for index, (counts, symbols) in ((0x00, _DC_LUM), (0x10, _AC_LUM),
                                     (0x01, _DC_CHROM), (0x11, _AC_CHROM)):
        dht += bytes([index]) + bytes(counts) + symbols
    dri = _seg(0xDD, struct.pack(">H", restart)) if restart else b""
    comps = b"".join(bytes([k + 1, hk << 4 | vk, 0])
                     for k, (hk, vk) in enumerate(factors))
    sof = _seg(0xC2 if progressive else 0xC0,
               struct.pack(">BHHB", 8, h, w, len(factors)) + comps)
    return dqt + _seg(0xC4, dht) + dri + sof


def _sos(comps, ss: int, se: int) -> bytes:
    """A scan header: component k + 1 with tables 0 (k = 0) or 1."""
    return _seg(0xDA, bytes([len(comps)]) + b"".join(
        bytes([k + 1, 0x00 if k == 0 else 0x11]) for k in comps)
        + bytes([ss, se, 0]))


def write_mjpg_avi(path: Path, frames: Iterable[bytes], height: int,
                   width: int, fps: int = 30, stream: int = 0,
                   others: Sequence[Stream] = (), index: bool = False,
                   extra_chunks: Sequence[tuple] = ()) -> None:
    """An AVI of JPEG frames (bytes) with the ``MJPG`` fourcc, as
    ``write_rgba_avi`` writes raw ones: one movi LIST of ``NNdc`` chunks
    (word-aligned), ``NN`` the video's stream number ``stream``, beside
    ``others`` and ``extra_chunks`` (``tests/_torch_rawvideo_writer.py``'s
    ``write_avi``); no index unless ``index``."""
    frames = list(frames)
    strh, strf = video_headers(height, width, b"MJPG", 24, len(frames),
                               max((len(f) for f in frames), default=0), fps,
                               image_size=width * height * 3)
    write_avi(path, strh, strf, frames, b"dc", extra_chunks, fps, stream,
              others, index)
