"""Plain Python / NumPy version of the native JPEG decoder (``jpeg.cpp``).

The tests and ``chip_smoke.py`` hold the native library to it bit for bit:
the same marker walk and byte source (libjpeg's fake EOI bytes past the
end), the same Huffman decode (in Python, one symbol at a time, with the
same zero bits past the data and restart handling), and the same integer
IDCTs, upsampling and colour tables (vectorised NumPy), in each of the
three modes (``MODES``): ``"turbo"`` and ``"turbo_fast"`` give
libjpeg-turbo's bytes, ``"ffmpeg"`` what ``cv2.VideoCapture`` gives for an
MJPG frame (FFmpeg's MJPEG decoder, then swscale to BGR24).  Nothing in the
package calls it; a 4K frame takes it about a minute.

The ``"ffmpeg"`` mode, stage by stage, as FFmpeg 8 (libavcodec 62,
libswscale 9) runs on x86-64:

* the frame's pixel format from its sampling (mjpegdec.c's pix_fmt_id,
  all-even factors halved): one component is gray8 at any factors; three
  are yuvj444p, 422p (Y 2x1), 420p (2x2), 411p (4x1) or 440p (1x2), the
  chroma 1x1; the rest UNSUPPORTED;
* sequential scans, one or several, as libjpeg reads them, but the DC
  predictor runs on dequantized values (it starts at 1024, the level
  shift, and each block's DC is the running sum clipped to int16), and a
  restart marker is any RSTn;
* progressive (SOF2) scans into the frame's coefficients, dequantized as
  they are read: a first DC scan clears the block and keeps the running
  sum of ``diff * (q << Al)`` from 1024 (wrapped to int16, not clipped); a
  DC refinement adds ``bit * q << Al``; a first AC band stores ``level *
  (q << Al)`` with EOB runs; an AC refinement adds ``+-(q << Al)`` to the
  nonzero terms up to the last nonzero index the block has had; a
  restart resets the DC sums and the EOB run.  At EOI every block goes
  through the IDCT;
* the ``simple_idct`` of its SSE2/AVX routine (``ff_simple_idct8_*``):
  W1-W7 = 22725, 21407, 19266, 16383, 12873, 8867, 4520, a row pass first
  (a row with no AC term is ``DC << 3`` in 16 bits, else ``(sum + 2^10)
  >> 11`` saturated to int16), then the column pass (the DC rounding 32
  added in 16 bits, ``sum >> 20`` in 32 bits), clamped to 0..255;
* cv2 asks swscale for BGR24 at the same size with SWS_BICUBIC.  gray8 is
  Y in all three channels.  4:2:0 and 4:2:2 of even height take its
  unscaled SSSE3 converter: chroma replicated, ``pmulhw`` with the
  full-range BT.601 coefficients (``y + ((c * 8 - 1024) * k >> 16)``, k =
  14516, -2819, -5850, 11485).  4:4:4 takes the scaler's full-chroma
  output: ``(y << 22 + 2^21 + (c - 128 << 9) * k) >> 22``, which rounds,
  its sums in 32 bits that wrap (only limited-range input gets there);
  with component IDs 'R', 'G', 'B' or Adobe transform 0 it is planar RGB.
  4:1:1, 4:4:0 and 4:2:0/4:2:2 of odd height take the scaled path
  (``_swscale_bgr``): the chroma resampled by ``init_filter``'s integer
  bicubic to the output's chroma size, then the MMXEXT output on all rows
  but the last two (which take the C output), or the full-chroma C output
  for an odd width;
* data FFmpeg would meet with an error it conceals (a bad Huffman code, a
  run past the 64th coefficient or the band, bits past the end of the
  data, a restart interval that does not end at its marker, a component
  no sequential scan codes): UNMATCHED, not a guess.
"""
from __future__ import annotations

import re
from typing import List, NamedTuple, Optional, Tuple

import numpy as np

__all__ = ["decode", "decode_bgr", "decode_tiff", "splice_tables",
           "STANDARD_TABLES", "MODES", "TIFF_FORMS", "OK", "CORRUPT",
           "GEOMETRY", "COMPONENTS", "UNSUPPORTED", "UNMATCHED", "NO_FRAME",
           "SAMPLING"]

# clt_jpeg_decode_bgr's return codes; NO_FRAME (the "ffmpeg" mode only):
# the data ends before the first scan, where FFmpeg returns no frame;
# SAMPLING (TIFF chunks only): sampling factors libtiff refuses
OK, CORRUPT, GEOMETRY, COMPONENTS, UNSUPPORTED, UNMATCHED, NO_FRAME = \
    0, -1, -2, -3, -4, -5, -6
SAMPLING = -8
_REASONS = {CORRUPT: "corrupt JPEG data", GEOMETRY: "frame geometry",
            COMPONENTS: "a component count the mode does not read (2 or 4; "
                        "1 outside the 'ffmpeg' mode)",
            UNSUPPORTED: "a mode the decoder does not read",
            UNMATCHED: "data FFmpeg decodes with an error it conceals",
            NO_FRAME: "the data ends before the first scan",
            SAMPLING: "sampling factors other than the TIFF tags say"}

# the decoder's modes, by their number in jpeg.cpp
MODES = ("turbo", "turbo_fast", "ffmpeg")
# the output forms of a TIFF chunk, by their number in jpeg.cpp, as libtiff
# sets up libjpeg for TIFFReadRGBA*: photometric YCbCr converted to RGB
# (JPEGCOLORMODE_RGB: jpeg_color_space YCbCr whatever the markers say),
# three components as stored (JCS_UNKNOWN: RGB), one component (gray)
TIFF_FORMS = ("ycc", "stored", "gray")

# COM segments that change how FFmpeg's MJPEG decoder reads a frame
# (limited range, flipped or interlaced frames)
_FFMPEG_COMMENTS = (b"CS=ITU601", b"Intel(R) JPEG", b"Metasoft MJPEG",
                    b"MULTISCOPE II", b"AVID")


def mode_name(mode) -> str:
    """A mode's name from its name or the old ``fast`` flag (False:
    ``"turbo"``, True: ``"turbo_fast"``)."""
    if isinstance(mode, (bool, np.bool_)):
        return MODES[int(mode)]
    if mode not in MODES:
        raise ValueError(f"unknown JPEG decoder mode {mode!r}; expected one "
                         f"of {MODES}")
    return mode

_EOI = 0xD9
_LOOK = 9

# zigzag index -> natural index, with libjpeg's 16 guard entries
_NATURAL = [0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
            12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
            35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
            58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63
            ] + [63] * 16

_AAN_SCALES = np.array([
    16384, 22725, 21407, 19266, 16384, 12873, 8867, 4520,
    22725, 31521, 29692, 26722, 22725, 17855, 12299, 6270,
    21407, 29692, 27969, 25172, 21407, 16819, 11585, 5906,
    19266, 26722, 25172, 22654, 19266, 15137, 10426, 5315,
    16384, 22725, 21407, 19266, 16384, 12873, 8867, 4520,
    12873, 17855, 16819, 15137, 12873, 10114, 6967, 3552,
    8867, 12299, 11585, 10426, 8867, 6967, 4799, 2446,
    4520, 6270, 5906, 5315, 4520, 3552, 2446, 1247], np.int64)

# Annex K.3's tables: (counts of lengths 1..16, symbols), by (class, slot)
# with class 0 DC and 1 AC
_AC_LUM = bytes.fromhex(
    "01020300041105122131410613516107227114328191a1082342b1c11552d1f0"
    "2433627282090a161718191a25262728292a3435363738393a43444546474849"
    "4a535455565758595a636465666768696a737475767778797a83848586878889"
    "8a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5"
    "c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8"
    "f9fa")
_AC_CHROM = bytes.fromhex(
    "000102031104052131061241510761711322328108144291a1b1c109233352f0"
    "156272d10a162434e125f11718191a262728292a35363738393a434445464748"
    "494a535455565758595a636465666768696a737475767778797a828384858687"
    "88898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3"
    "c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8"
    "f9fa")
STANDARD_TABLES = {
    (0, 0): ((0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0),
             bytes(range(12))),
    (1, 0): ((0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D), _AC_LUM),
    (0, 1): ((0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0),
             bytes(range(12))),
    (1, 1): ((0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77),
             _AC_CHROM),
}


class _Source:
    """Bytes as libjpeg's memory source gives them: FF D9 FF D9 ... past
    the end."""

    def __init__(self, data: bytes):
        self.data = data
        self.n = len(data)
        self.pos = 0
        self.sos = False  # the walk has met the first SOS marker
        # the data and enough fake EOI bytes for a segment search
        self.ext = data + b"\xff\xd9" * 4

    def at(self, i: int) -> int:
        if i < self.n:
            return self.data[i]
        return _EOI if (i - self.n) & 1 else 0xFF

    def next_marker(self) -> int:
        while True:
            c = self.at(self.pos)
            self.pos += 1
            while c != 0xFF:
                c = self.at(self.pos)
                self.pos += 1
            while c == 0xFF:
                c = self.at(self.pos)
                self.pos += 1
            if c:
                return c


# the end of entropy-coded data: 0xFF (fill 0xFFs too) before a byte that
# is neither a stuffed zero nor 0xFF
_SEGMENT_END = re.compile(rb"\xff+[^\x00\xff]")
_STUFFED = re.compile(rb"\xff+\x00")


class _Huff:
    """A derived table: ``look[9 bits] = (length << 8) | symbol`` for codes
    up to 9 bits, 0 for longer ones, which walk ``maxcode``."""

    def __init__(self, bits, val, dc: bool):
        sizes = []
        for length in range(1, 17):
            sizes += [length] * bits[length - 1]
        if len(sizes) > 256:
            raise _Fault(CORRUPT)
        codes, code = [], 0
        si = sizes[0] if sizes else 0
        p = 0
        while p < len(sizes):
            while p < len(sizes) and sizes[p] == si:
                codes.append(code)
                code += 1
                p += 1
            if code >= 1 << si:
                raise _Fault(CORRUPT)
            code <<= 1
            si += 1
        self.maxcode = [0] * 18
        self.valoff = [0] * 18
        p = 0
        for length in range(1, 17):
            if bits[length - 1]:
                self.valoff[length] = p - codes[p]
                p += bits[length - 1]
                self.maxcode[length] = codes[p - 1]
            else:
                self.maxcode[length] = -1
        self.maxcode[17] = 0xFFFFF
        self.val = list(val) + [0] * (256 - len(val))
        self.look = [0] * (1 << _LOOK)
        p = 0
        for length in range(1, _LOOK + 1):
            for _ in range(bits[length - 1]):
                at = codes[p] << (_LOOK - length)
                for k in range(1 << (_LOOK - length)):
                    self.look[at + k] = (length << 8) | self.val[p]
                p += 1
        if dc and any(v > 15 for v in val[:len(sizes)]):
            raise _Fault(CORRUPT)


class _Fault(Exception):
    def __init__(self, code: int):
        super().__init__(code)
        self.code = code


class _Header:
    def __init__(self):
        self.sof = self.precision = self.height = self.width = 0
        self.comps: List[dict] = []
        self.qt = [None] * 4
        self.huff = {}            # (class, slot) -> (bits, val)
        self.restart = 0
        self.jfif = self.adobe = False
        self.transform = 0
        self.comments: List[bytes] = []  # the first 14 bytes of each COM
        self.scan: List[int] = []  # frame index of each scan slot
        self.ss = self.se = self.ah = self.al = 0  # the scan's Ss, Se, Ah, Al


def _read_header(src: _Source, mode: str = "turbo") -> _Header:
    """Markers from SOI to the first SOS (``jpeg.cpp``'s read_header).  The
    ``"ffmpeg"`` mode also reads progressive (SOF2) frames, grayscale and
    scans of fewer than three components."""
    if src.at(0) != 0xFF or src.at(1) != 0xD8:
        raise _Fault(CORRUPT)
    src.pos = 2
    hd = _Header()
    if _walk(src, hd, mode, header=True) != 0xDA:
        raise _Fault(CORRUPT)
    return hd


def _walk(src: _Source, hd: _Header, mode: str, header: bool) -> int:
    """Reads marker segments into hd up to and including the next SOS (its
    scan header read), or up to EOI between scans; returns that marker."""
    ffmpeg, tiff = mode == "ffmpeg", mode == "tiff"
    while True:
        m = src.next_marker()
        if m in (_EOI, 0xD8):
            if header or m == 0xD8:
                raise _Fault(CORRUPT if header else UNMATCHED)
            return m
        if 0xD0 <= m <= 0xD7 or m == 0x01:
            continue
        length = (src.at(src.pos) << 8) | src.at(src.pos + 1)
        body = length - 2
        skipped = 0xE0 <= m <= 0xEF or m == 0xFE
        keep = min(body, 14) if skipped else body
        seg = bytes(src.at(src.pos + 2 + i) for i in range(max(keep, 0)))
        src.pos += length if length >= 2 else 2
        if m in (0xC0, 0xC1) or (ffmpeg and m == 0xC2):
            if hd.sof or body < 6:
                raise _Fault(CORRUPT if header else UNMATCHED)
            hd.sof, hd.precision = m, seg[0]
            hd.height = (seg[1] << 8) | seg[2]
            hd.width = (seg[3] << 8) | seg[4]
            ncomp = seg[5]
            if hd.height <= 0 or hd.width <= 0 or ncomp <= 0 or \
                    body != 6 + 3 * ncomp:
                raise _Fault(CORRUPT)
            if hd.precision != 8:
                raise _Fault(UNSUPPORTED)
            if ncomp not in ((1, 3) if ffmpeg or tiff else (3,)):
                raise _Fault(COMPONENTS)
            hd.comps = [dict(id=seg[6 + 3 * c], h=seg[7 + 3 * c] >> 4,
                             v=seg[7 + 3 * c] & 15, tq=seg[8 + 3 * c])
                        for c in range(ncomp)]
        elif 0xC0 <= m <= 0xCF and m not in (0xC4, 0xCC):
            raise _Fault(UNSUPPORTED)
        elif m == 0xC4:
            at = 0
            while body - at > 16:
                index = seg[at]
                bits = tuple(seg[at + 1:at + 17])
                count = sum(bits)
                at += 17
                if count > 256 or count > body - at:
                    raise _Fault(CORRUPT)
                if index & ~0x10 > 3:
                    raise _Fault(CORRUPT)
                hd.huff[(1 if index & 0x10 else 0, index & 0x0F)] = (
                    bits, seg[at:at + count])
                at += count
            if at != body:
                raise _Fault(CORRUPT)
        elif m == 0xDB:
            at = 0
            while at < body:
                prec, slot = seg[at] >> 4, seg[at] & 15
                at += 1
                size = 128 if prec else 64
                if slot > 3 or at + size > body:
                    raise _Fault(CORRUPT)
                raw = np.frombuffer(seg[at:at + size],
                                    ">u2" if prec else np.uint8)
                table = np.empty(64, np.int64)
                table[_NATURAL[:64]] = raw
                hd.qt[slot] = table
                at += size
            if at != body:
                raise _Fault(CORRUPT)
        elif m == 0xDD:
            if body != 2:
                raise _Fault(CORRUPT)
            hd.restart = (seg[0] << 8) | seg[1]
        elif m == 0xE0:
            if body >= 14 and seg[:5] == b"JFIF\0":
                hd.jfif = True
        elif m == 0xEE:
            if body >= 12 and seg[:5] == b"Adobe":
                hd.adobe, hd.transform = True, seg[11]
        elif m == 0xDA:
            src.sos = True
            if not hd.sof:
                raise _Fault(CORRUPT)
            _read_sos(hd, seg, body, ffmpeg, tiff)
            return m
        elif skipped or m in (0xCC, 0xDC):
            if m == 0xFE:
                hd.comments.append(seg)
        else:
            raise _Fault(CORRUPT)


def _read_sos(hd: _Header, seg: bytes, body: int, ffmpeg: bool,
              tiff: bool = False) -> None:
    """A scan header: the frame index and table slots of each component,
    and the spectral selection and successive approximation (Ss, Se, Ah,
    Al) that progressive scans use."""
    n = seg[0] if body >= 1 else 0
    if body != 4 + 2 * n or not 1 <= n <= 4:
        raise _Fault(CORRUPT)
    if n != (len(hd.comps) if tiff else 3) and not ffmpeg:
        raise _Fault(UNSUPPORTED)
    if n > len(hd.comps):
        raise _Fault(CORRUPT)
    used = set()
    hd.scan = []
    for i in range(n):
        cid, tabs = seg[1 + 2 * i], seg[2 + 2 * i]
        c = next((c for c in range(len(hd.comps))
                  if hd.comps[c]["id"] == cid and c not in used), None)
        if c is None:
            raise _Fault(CORRUPT)
        used.add(c)
        hd.comps[c]["td"], hd.comps[c]["ta"] = tabs >> 4, tabs & 15
        hd.scan.append(c)
    hd.ss, hd.se = seg[1 + 2 * n], seg[2 + 2 * n]
    hd.ah, hd.al = seg[3 + 2 * n] >> 4, seg[3 + 2 * n] & 15


class _Bits:
    """The entropy-coded bits of one segment (up to its marker), then zero
    bits; ``short`` turns true once a bit past the data is taken."""

    def __init__(self, src: _Source, against_marker: Optional[int] = None):
        if against_marker is not None:  # an empty segment at a marker
            data, self.marker = b"", against_marker
        else:
            pos = src.pos
            if pos > src.n + 1:  # past the end only the parity matters
                pos = src.n + ((pos - src.n) & 1)
            m = _SEGMENT_END.search(src.ext, pos)
            data = _STUFFED.sub(b"\xff", src.ext[pos:m.start()])
            self.marker = src.ext[m.end() - 1]
            src.pos = m.end()
        self.real = 8 * len(data)
        # 32-bit big-endian windows at every byte; an MCU reads at most
        # 10 blocks x 64 x 32 bits past the data
        a = np.frombuffer(data + bytes(2600), np.uint8).astype(np.uint32)
        self.win = ((a[:-3] << 24) | (a[1:-2] << 16) | (a[2:-1] << 8)
                    | a[3:]).tolist()
        self.p = 0


def _symbol(win: list, p: int, tab: _Huff) -> Tuple[int, int]:
    """One Huffman symbol at bit p: (symbol, next bit); a bad code reads
    17 bits and gives 0, as libjpeg does."""
    w = win[p >> 3]
    e = tab.look[(w >> (23 - (p & 7))) & 0x1FF]
    if e:
        return e & 0xFF, p + (e >> 8)
    b17 = (w >> (15 - (p & 7))) & 0x1FFFF
    n = _LOOK + 1
    while (b17 >> (17 - n)) > tab.maxcode[n]:
        n += 1
    if n > 16:
        return 0, p + n
    return tab.val[((b17 >> (17 - n)) + tab.valoff[n]) & 0xFF], p + n


def _take(win: list, p: int, n: int) -> Tuple[int, int]:
    """n <= 16 bits at bit p: (value, next bit)."""
    return (win[p >> 3] >> (32 - (p & 7) - n)) & ((1 << n) - 1), p + n


def _blocks(hd: _Header, src: _Source, mcux: int, mcuy: int, hmax: int,
            vmax: int, tables) -> Tuple[List[np.ndarray], int]:
    """The quantized coefficients of every block, per component as
    (blocks down, blocks across, 64) int16 in natural order, and the
    source's marker after the scan (``jpeg.cpp``'s run, without the
    IDCT)."""
    coefs = [np.zeros((mcuy * c["v"], mcux * c["h"], 64), np.int16)
             for c in hd.comps]
    bits = _Bits(src)
    short = False
    pred = [0] * 3
    togo, next_rst = hd.restart, 0
    natural = _NATURAL
    for my in range(mcuy):
        for mx in range(mcux):
            if hd.restart and togo == 0:
                m = bits.marker
                against = None
                if m == 0xD0 + next_rst:
                    pass
                else:  # jpeg_resync_to_restart
                    while True:
                        if m < 0xC0:
                            action = 2
                        elif m < 0xD0 or m > 0xD7:
                            action = 3
                        elif m in (0xD0 + ((next_rst + 1) & 7),
                                   0xD0 + ((next_rst + 2) & 7)):
                            action = 3
                        elif m in (0xD0 + ((next_rst - 1) & 7),
                                   0xD0 + ((next_rst - 2) & 7)):
                            action = 2
                        else:
                            action = 1
                        if action == 2:
                            m = src.next_marker()
                            continue
                        if action == 3:
                            against = m
                        break
                next_rst = (next_rst + 1) & 7
                pred = [0, 0, 0]
                togo = hd.restart
                bits = _Bits(src, against)
                if against is None:
                    short = False
            if not short:
                win, p = bits.win, bits.p
                for k in hd.scan:
                    c = hd.comps[k]
                    dct, act = tables[(0, c["td"])], tables[(1, c["ta"])]
                    for by in range(c["v"]):
                        row = coefs[k][my * c["v"] + by]
                        for bx in range(c["h"]):
                            blk = row[mx * c["h"] + bx]
                            t, p = _symbol(win, p, dct)
                            diff = 0
                            if t:
                                x, p = _take(win, p, t)
                                diff = x - (1 << t) + 1 \
                                    if x < 1 << (t - 1) else x
                            pred[k] = (pred[k] + diff + 2 ** 31) \
                                % 2 ** 32 - 2 ** 31
                            blk[0] = (pred[k] + 32768) % 65536 - 32768
                            z = 1
                            while z < 64:
                                t, p = _symbol(win, p, act)
                                r, s = t >> 4, t & 15
                                if s:
                                    z += r
                                    x, p = _take(win, p, s)
                                    blk[natural[z]] = x - (1 << s) + 1 \
                                        if x < 1 << (s - 1) else x
                                elif r != 15:
                                    break
                                else:
                                    z += 15
                                z += 1
                bits.p = p
                if p > bits.real:
                    short = True
            if hd.restart:
                togo -= 1
    return coefs, bits.marker


def _extend(x: int, s: int) -> int:
    return x - (1 << s) + 1 if x < 1 << (s - 1) else x


def _wrap16(v: int) -> int:
    return (v + 32768) % 65536 - 32768


def _units(hd: _Header, hmax: int, vmax: int):
    """The scan's units in order: for each, a list of (component, block
    row, block column); an interleaved scan's unit is an MCU, a
    one-component scan's a block of that component (FFmpeg counts
    ceil(width / (8 * hmax / h)) blocks across, and so down)."""
    if len(hd.scan) > 1:
        mcux = -(-hd.width // (8 * hmax))
        mcuy = -(-hd.height // (8 * vmax))
        for my in range(mcuy):
            for mx in range(mcux):
                yield [(k, my * hd.comps[k]["v"] + by, mx * hd.comps[k]["h"]
                        + bx) for k in hd.scan
                       for by in range(hd.comps[k]["v"])
                       for bx in range(hd.comps[k]["h"])]
    else:
        k = hd.scan[0]
        c = hd.comps[k]
        nbx = -(-hd.width // (8 * (hmax // c["h"])))
        nby = -(-hd.height // (8 * (vmax // c["v"])))
        for by in range(nby):
            for bx in range(nbx):
                yield [(k, by, bx)]


def _scan_ffmpeg(hd: _Header, src: _Source, coefs, last_nnz, hmax: int,
                 vmax: int, progressive: bool) -> int:
    """One scan as FFmpeg's MJPEG decoder reads it (mjpegdec.c), into the
    frame's dequantized coefficients; returns the marker after it.

    Sequential: each DC is the dequantized running sum from 1024 clipped
    to int16, each AC term ``level * q`` in int16.  Progressive: a first
    DC scan clears the block and keeps the running sum of ``diff * (q <<
    Al)`` (wrapped, not clipped); a DC refinement adds ``bit * q << Al``;
    AC bands store ``level * (q << Al)`` with EOB runs; AC refinements
    add ``+-(q << Al)`` to nonzero terms up to the block's last nonzero
    index seen so far.  A restart is any RSTn after the interval's padding
    bits (all ones or all zeros) and resets the DC sums and the EOB run.
    What FFmpeg would stop at with an error raises UNMATCHED."""
    ss, se, ah, al = hd.ss, hd.se, hd.ah, hd.al
    if progressive and (se > 63 or se < ss or (ss == 0) != (se == 0) or
                        (ss and len(hd.scan) != 1)):
        raise _Fault(UNMATCHED)
    tables = _scan_tables(hd, progressive)
    q = {k: hd.qt[hd.comps[k]["tq"]] for k in hd.scan}
    qz = {k: [int(q[k][_NATURAL[z]]) for z in range(64)] for k in hd.scan}
    natural = _NATURAL
    bits = _Bits(src)
    pred = {k: 1024 for k in hd.scan}
    togo, eobrun = hd.restart, 0
    first = True
    for unit in _units(hd, hmax, vmax):
        if hd.restart and togo == 0 and not first:
            rest = bits.real - bits.p
            if not 0 <= rest < 8 or not 0xD0 <= bits.marker <= 0xD7 or \
                    _take(bits.win, bits.p, rest)[0] not in (
                        0, (1 << rest) - 1):
                raise _Fault(UNMATCHED)
            pred = {k: 1024 for k in hd.scan}
            togo, eobrun = hd.restart, 0
            bits = _Bits(src)
        first = False
        win, p = bits.win, bits.p
        for k, by, bx in unit:
            blk = coefs[k][by, bx]
            if not progressive or ss == 0 and not ah:
                at = p
                t, p = _symbol(win, p, tables[(k, 0)])
                if p - at > 16:  # a bad code
                    raise _Fault(UNMATCHED)
                diff = 0
                if t:
                    x, p = _take(win, p, t)
                    diff = _extend(x, t)
                blk[:] = 0
                if progressive:
                    pred[k] = (pred[k] + diff * (qz[k][0] << al)
                               + 2 ** 31) % 2 ** 32 - 2 ** 31
                    blk[0] = _wrap16(pred[k])
                    continue
                pred[k] = (pred[k] + diff * qz[k][0] + 2 ** 31) % 2 ** 32 \
                    - 2 ** 31
                blk[0] = min(max(pred[k], -32768), 32767)
                z = 1
                act = tables[(k, 1)]
                while z < 64:
                    at = p
                    t, p = _symbol(win, p, act)
                    r, s = t >> 4, t & 15
                    if p - at > 16 or (z + r > 63 if s else r not in (0, 15)):
                        raise _Fault(UNMATCHED)
                    if s:
                        z += r
                        x, p = _take(win, p, s)
                        blk[natural[z]] = _wrap16(_extend(x, s) * qz[k][z])
                    elif r != 15:
                        break
                    else:
                        z += 15
                    z += 1
            elif ss == 0:  # DC refinement
                x, p = _take(win, p, 1)
                blk[0] = _wrap16(int(blk[0]) + ((x * qz[k][0]) << al))
            elif not ah:
                p, eobrun = _ac_first(win, p, blk, tables[(k, 1)], qz[k],
                                      ss, se, al, eobrun, last_nnz[k], by, bx)
            else:
                p, eobrun = _ac_refine(win, p, blk, tables[(k, 1)], qz[k],
                                       ss, se, al, eobrun, last_nnz[k], by,
                                       bx)
        bits.p = p
        if p > bits.real:
            raise _Fault(UNMATCHED)
        if hd.restart:
            togo -= 1
    return bits.marker


def _ac_first(win, p, blk, tab, qz, ss, se, al, eobrun, nnz, by, bx):
    """decode_block_progressive: one block of a first AC scan."""
    if eobrun:
        return p, eobrun - 1
    i = ss
    while True:
        at = p
        t, p = _symbol(win, p, tab)
        if p - at > 16:
            raise _Fault(UNMATCHED)
        run, size = t >> 4, t & 15
        if size:
            i += run
            x, p = _take(win, p, size)
            if i >= se:
                if i > se:
                    raise _Fault(UNMATCHED)
                blk[_NATURAL[se]] = _wrap16(_extend(x, size) * (qz[se] << al))
                break
            blk[_NATURAL[i]] = _wrap16(_extend(x, size) * (qz[i] << al))
        elif run == 15:
            i += 15
            if i >= se:
                raise _Fault(UNMATCHED)
        else:
            val = 1 << run
            if run:
                x, p = _take(win, p, run)
                val += x
            eobrun = val - 1
            break
        i += 1
    nnz[by, bx] = max(nnz[by, bx], i)
    return p, eobrun


def _ac_refine(win, p, blk, tab, qz, ss, se, al, eobrun, nnz, by, bx):
    """decode_block_refinement: one block of an AC refinement scan."""
    last = min(se, int(nnz[by, bx]))
    i = ss

    def refine(p, i):
        j = _NATURAL[i]
        x, p = _take(win, p, 1)
        q = qz[i] if blk[j] >= 0 else -qz[i]
        blk[j] = _wrap16(int(blk[j]) + ((x * q) << al))
        return p

    def zero_run(p, i, run):
        while True:
            if i > last:
                i += run
                if i > se:
                    raise _Fault(UNMATCHED)
                return p, i
            if blk[_NATURAL[i]]:
                p = refine(p, i)
            elif run == 0:
                return p, i
            else:
                run -= 1
            i += 1

    if eobrun:
        eobrun -= 1
    else:
        while True:
            at = p
            t, p = _symbol(win, p, tab)
            if p - at > 16:
                raise _Fault(UNMATCHED)
            run = t >> 4
            if t & 15:
                x, p = _take(win, p, 1)
                p, i = zero_run(p, i, run)
                blk[_NATURAL[i]] = _wrap16(qz[i] << al if x else
                                           -(qz[i] << al))
                if i == se:
                    nnz[by, bx] = max(nnz[by, bx], i)
                    return p, eobrun
            elif run == 15:
                p, i = zero_run(p, i, run)
            else:
                val = 1 << run
                if run:
                    x, p = _take(win, p, run)
                    val += x
                eobrun = val - 1
                break
            i += 1
        nnz[by, bx] = max(nnz[by, bx], i)
    while i <= last:
        if blk[_NATURAL[i]]:
            p = refine(p, i)
        i += 1
    return p, eobrun


def _i16(x: np.ndarray) -> np.ndarray:
    return (x + 32768) % 65536 - 32768


def _sat16(x: np.ndarray) -> np.ndarray:
    return np.clip(x, -32768, 32767)


def _sample(x: np.ndarray) -> np.ndarray:
    return (np.clip(x, -128, 127) + 128).astype(np.uint8)


def _islow_1d(x, shift, pass1):
    """One pass of jpeg_idct_islow over axis 1 of x (n, 8, 8), in
    jidctint-avx2's 16-bit lanes: returns the eight descaled outputs."""
    F0298, F0390, F0541, F0765, F0899, F1175 = 2446, 3196, 4433, 6270, \
        7373, 9633
    F1501, F1847, F1961, F2053, F2562, F3072 = 12299, 15137, 16069, \
        16819, 20995, 25172
    z2, z3 = x[:, 2], x[:, 6]
    z1 = (z2 + z3) * F0541
    tmp2 = z1 + z3 * -F1847
    tmp3 = z1 + z2 * F0765
    tmp0 = _i16(x[:, 0] + x[:, 4]) * 8192
    tmp1 = _i16(x[:, 0] - x[:, 4]) * 8192
    t10, t13, t11, t12 = tmp0 + tmp3, tmp0 - tmp3, tmp1 + tmp2, tmp1 - tmp2
    tmp0, tmp1, tmp2, tmp3 = x[:, 7], x[:, 5], x[:, 3], x[:, 1]
    z1 = (tmp0 + tmp3) * -F0899
    z2 = (tmp1 + tmp2) * -F2562
    z3 = _i16(tmp0 + tmp2)
    z4 = _i16(tmp1 + tmp3)
    z5 = (z3 + z4) * F1175
    z3 = z3 * -F1961 + z5
    z4 = z4 * -F0390 + z5
    tmp0 = tmp0 * F0298 + z1 + z3
    tmp1 = tmp1 * F2053 + z2 + z4
    tmp2 = tmp2 * F3072 + z2 + z3
    tmp3 = tmp3 * F1501 + z1 + z4
    rnd = 1 << (shift - 1)
    out = [t10 + tmp3, t11 + tmp2, t12 + tmp1, t13 + tmp0,
           t13 - tmp0, t12 - tmp1, t11 - tmp2, t10 - tmp3]
    out = np.stack([(o + rnd) >> shift for o in out], 1)
    return _sat16(out) if pass1 else out


def _idct_islow(coef: np.ndarray, q: np.ndarray) -> np.ndarray:
    """(n, 64) int16 coefficients -> (n, 8, 8) uint8 samples."""
    c = coef.astype(np.int64).reshape(-1, 8, 8)
    v = _i16(c * q.astype(np.int16).astype(np.int64).reshape(8, 8))
    ac = (c[:, 1:] != 0).any(axis=(1, 2))
    # pass 1 down the columns (axis 1), pass 2 along the rows
    cols = _islow_1d(v, 11, True)                        # (n, row, col)
    dc_only = np.broadcast_to(_i16(v[:, 0:1, :] * 4), cols.shape)
    ws = np.where(ac[:, None, None], cols, dc_only)      # (n, row, col)
    return _sample(_islow_1d(np.swapaxes(ws, 1, 2), 18, False)
                   ).swapaxes(1, 2)


def _aan(x, c):
    return (_i16(x * 4) * (c * 64)) >> 16


def _ifast_1d(x):
    """jpeg_idct_ifast's butterflies over axis 1 of x (n, 8, 8), in
    jidctfst-sse2's 16-bit lanes."""
    F1082, F1414, F1847, F1613 = 277, 362, 473, 669 - 256
    tmp10, tmp11 = _i16(x[:, 0] + x[:, 4]), _i16(x[:, 0] - x[:, 4])
    tmp13 = _i16(x[:, 2] + x[:, 6])
    tmp12 = _i16(_aan(_i16(x[:, 2] - x[:, 6]), F1414) - tmp13)
    tmp0, tmp3 = _i16(tmp10 + tmp13), _i16(tmp10 - tmp13)
    tmp1, tmp2 = _i16(tmp11 + tmp12), _i16(tmp11 - tmp12)
    z13, z10 = _i16(x[:, 5] + x[:, 3]), _i16(x[:, 5] - x[:, 3])
    z11, z12 = _i16(x[:, 1] + x[:, 7]), _i16(x[:, 1] - x[:, 7])
    tmp7 = _i16(z11 + z13)
    tmp11 = _aan(_i16(z11 - z13), F1414)
    z10s, z12s = _i16(z10 * 4), _i16(z12 * 4)
    z5 = (_i16(z10s + z12s) * (F1847 * 64)) >> 16
    tmp10 = _i16(((z12s * (F1082 * 64)) >> 16) - z5)
    tmp12 = _i16(_i16(((z10s * (-F1613 * 64)) >> 16) - z10) + z5)
    tmp6 = _i16(tmp12 - tmp7)
    tmp5 = _i16(tmp11 - tmp6)
    tmp4 = _i16(tmp10 + tmp5)
    return np.stack([_i16(tmp0 + tmp7), _i16(tmp1 + tmp6),
                     _i16(tmp2 + tmp5), _i16(tmp3 - tmp4),
                     _i16(tmp3 + tmp4), _i16(tmp2 - tmp5),
                     _i16(tmp1 - tmp6), _i16(tmp0 - tmp7)], 1)


def _idct_ifast(coef: np.ndarray, q: np.ndarray) -> np.ndarray:
    c = coef.astype(np.int64).reshape(-1, 8, 8)
    v = _i16(c * q.astype(np.int16).astype(np.int64).reshape(8, 8))
    ws = _ifast_1d(v)                                     # (n, row, col)
    return _sample(_ifast_1d(np.swapaxes(ws, 1, 2)) >> 5).swapaxes(1, 2)


# FFmpeg's simple_idct (8-bit): W_k = round(cos(k pi / 16) sqrt(2) 2^14),
# W4 one less
_W = (None, 22725, 21407, 19266, 16383, 12873, 8867, 4520)


def _i32(x: np.ndarray) -> np.ndarray:
    return (x + 2 ** 31) % 2 ** 32 - 2 ** 31


def _simple_1d(x, a0):
    """simple_idct's butterflies along the last axis of x, with the DC
    term ``a0`` given: the eight sums before the shift."""
    W1, W2, W3, W4, W5, W6, W7 = _W[1:]
    a1, a2, a3 = a0 + W6 * x[..., 2], a0 - W6 * x[..., 2], \
        a0 - W2 * x[..., 2]
    a0 = a0 + W2 * x[..., 2]
    b0 = W1 * x[..., 1] + W3 * x[..., 3] + W5 * x[..., 5] + W7 * x[..., 7]
    b1 = W3 * x[..., 1] - W7 * x[..., 3] - W1 * x[..., 5] - W5 * x[..., 7]
    b2 = W5 * x[..., 1] - W1 * x[..., 3] + W7 * x[..., 5] + W3 * x[..., 7]
    b3 = W7 * x[..., 1] - W5 * x[..., 3] + W3 * x[..., 5] - W1 * x[..., 7]
    a0 = a0 + W4 * x[..., 4] + W6 * x[..., 6]
    a1 = a1 - W4 * x[..., 4] - W2 * x[..., 6]
    a2 = a2 - W4 * x[..., 4] + W2 * x[..., 6]
    a3 = a3 + W4 * x[..., 4] - W6 * x[..., 6]
    return np.stack([a0 + b0, a1 + b1, a2 + b2, a3 + b3,
                     a3 - b3, a2 - b2, a1 - b1, a0 - b0], -1)


def _idct_simple(coef: np.ndarray, q: np.ndarray) -> np.ndarray:
    """(n, 64) int16 coefficients, the DC already dequantized -> (n, 8, 8)
    uint8 samples, as ff_simple_idct8_put_sse2/avx computes them."""
    c = coef.astype(np.int64).reshape(-1, 8, 8)
    v = _i16(c * q.astype(np.int64).reshape(8, 8))
    v[:, 0, 0] = c[:, 0, 0]
    W4 = _W[4]
    # rows: a row with no AC term is DC << 3 in 16 bits
    rows = _sat16(_i32(_simple_1d(v, W4 * v[..., 0] + (1 << 10))) >> 11)
    dc_only = ~(v[..., 1:] != 0).any(-1)
    rows = np.where(dc_only[..., None], _i16(v[..., :1] * 8), rows)
    # columns: the rounding (1 << 19) / W4 = 32 added to the DC in 16 bits
    cols = np.swapaxes(rows, 1, 2)
    out = _i32(_simple_1d(cols, W4 * _i16(cols[..., 0] + 32))) >> 20
    return np.clip(np.swapaxes(out, 1, 2), 0, 255).astype(np.uint8)


def _cdiv(a: int, b: int) -> int:
    """C's integer division (toward zero)."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b > 0) else -q


class SwsRange(NamedTuple):
    """swscale's BT.601 tables for one input range, as
    ff_yuv2rgb_c_init_tables makes them: the pmulhw luma coefficient and
    offset of its SIMD outputs (``((y << 3) - yo) * yc >> 16``); the
    chroma coefficients with 13 fractional bits (u -> b, u -> g, v -> g,
    v -> r); the C output's with 16 (v -> r, u -> b, u -> g, v -> g); and
    the luma scale ``cy`` and offset ``oy`` (16 fractional bits) of the
    full-chroma output and of the C output's lookup table."""
    yc: int
    yo: int
    ub: int
    ug: int
    vg: int
    vr: int
    crv: int
    cbu: int
    cgu: int
    cgv: int
    cy: int
    oy: int


def _round16(x: int) -> int:
    """swscale's roundToInt16: (x + 2^15) >> 16, clipped to int16."""
    return max(min((x + (1 << 15)) >> 16, 32767), -32768)


# swscale's inverse coefficients (ff_yuv2rgb_coeffs) of the BT.601
# matrix, its default, and of BT.709
BT601 = (104597, 132201, 25675, 53279)
BT709 = (117489, 138438, 13975, 34925)


def _sws_range(limited: bool, matrix: Tuple[int, ...] = BT601
               ) -> SwsRange:
    """The tables of ff_yuv2rgb_c_init_tables for ``matrix`` (inverse
    coefficients v -> r, u -> b, u -> g, v -> g; the default BT.601):
    full range scales the chroma by 224/255, limited range the luma by
    255/219 from an offset of 16 (C divisions, toward zero); the C
    output's coefficients are then divided by the luma scale, as its
    lookup table applies that."""
    crv, cbu, cgu, cgv = matrix[0], matrix[1], -matrix[2], -matrix[3]
    cy, oy = 1 << 16, 0
    if limited:
        cy, oy = cy * 255 // 219, 16 << 16
    else:
        crv, cbu, cgu, cgv = (_cdiv(k * 224, 255) for k in (crv, cbu, cgu,
                                                             cgv))
    return SwsRange(_round16(cy << 13), _round16(oy << 3),
                    *(_round16(k << 13) for k in (cbu, cgu, cgv, crv)),
                    *(_cdiv((k << 16) + 0x8000, cy)
                      for k in (crv, cbu, cgu, cgv)), cy, oy)


# full range (yuvj, what FFmpeg's MJPEG decoder gives) and limited range
# (yuv420p, what a raw I420/YV12 frame is); limited range under the BT.709
# matrix (the frames of a stream tagged so, which cv2 converts by the tag)
SWS_FULL, SWS_LIMITED = _sws_range(False), _sws_range(True)
SWS_LIMITED_709 = _sws_range(True, BT709)


def _sws_table(t: np.ndarray, rng: SwsRange) -> np.ndarray:
    """The C output's luma lookup table at index ``t`` (its y_table from
    ``yoffs``: 384 entries in at full range, 326 at limited range)."""
    at = 326 if rng.oy else 384
    return np.clip(((at + t) * rng.cy - (384 << 16) - rng.oy + 0x8000) >> 16,
                   0, 255)


def _ffmpeg_bgr(y: np.ndarray, cb: np.ndarray, cr: np.ndarray,
                subsampled: bool, rng: SwsRange = SWS_FULL) -> np.ndarray:
    """BGR24 from full-size planes as swscale converts them: the unscaled
    SSSE3 path (pmulhw, truncating) for subsampled chroma, the full-chroma
    scaler (rounding) for 4:4:4; ``rng`` is the input's range."""
    y, cb, cr = (a.astype(np.int64) for a in (y, cb, cr))
    if subsampled:
        yy = _pmulhw((y << 3) - rng.yo, rng.yc)
        u, v = cb * 8 - 1024, cr * 8 - 1024
        bgr = (yy + _pmulhw(u, rng.ub),
               yy + _pmulhw(u, rng.ug) + _pmulhw(v, rng.vg),
               yy + _pmulhw(v, rng.vr))
    else:
        # 32-bit sums that wrap, as swscale's unsigned arithmetic does
        # (limited range can pass 2^31: a saturated blue comes out 0)
        yy = ((y << 9) - (rng.oy >> 7)) * rng.yc + (1 << 21)
        u, v = (cb - 128) << 9, (cr - 128) << 9
        bgr = (_i32(yy + u * rng.ub) >> 22,
               _i32(yy + u * rng.ug + v * rng.vg) >> 22,
               _i32(yy + v * rng.vr) >> 22)
    return np.stack(bgr, -1).clip(0, 255).astype(np.uint8)


def init_filter(inc: int, src_w: int, dst_w: int, align: int, one: int,
                src_pos: int, dst_pos: int) -> Tuple[np.ndarray, np.ndarray]:
    """swscale's initFilter for SWS_BICUBIC (B = 0, C = 0.6): (dst_w, size)
    integer coefficients summing to ``one`` and each output's first
    source index.  A unit step at the same position is the one-tap
    identity; otherwise each output's taps come from the Keys cubic at
    its distance in 1/2^17 pixels, cut where a side's weight is below
    0.002 of the filter's scale, padded to ``align`` taps, folded inside
    [0, src_w) and rounded to integers with the error carried along."""
    fone = 1 << (54 - min(max((src_w // dst_w).bit_length() - 1, 0), 8))
    if abs(inc - 0x10000) < 10 and src_pos == dst_pos:
        size = 1
        filt = [[fone] for _ in range(dst_w)]
        pos = list(range(dst_w))
    else:
        size = 5 if inc <= 1 << 16 else 1 + (4 * src_w + dst_w - 1) // dst_w
        size = max(min(size, src_w - 2), 1)
        b, c = 0, int(0.6 * (1 << 24))
        x = ((dst_pos * inc) >> 7) - ((src_pos * 0x10000) >> 7)
        filt, pos = [], []
        for _ in range(dst_w):
            xx = _cdiv(x - (size - 2) * (1 << 16), 1 << 17)
            pos.append(xx)
            row = []
            for _ in range(size):
                d = abs(xx * (1 << 17) - x) << 13
                if inc > 1 << 16:
                    d = _cdiv(d * dst_w, src_w)
                if d >= 1 << 31:
                    coeff = 0
                else:
                    dd = (d * d) >> 30
                    ddd = (dd * d) >> 30
                    if d < 1 << 30:
                        coeff = (12 * (1 << 24) - 9 * b - 6 * c) * ddd + \
                            (-18 * (1 << 24) + 12 * b + 6 * c) * dd + \
                            (6 * (1 << 24) - 2 * b) * (1 << 30)
                    else:
                        coeff = (-b - 6 * c) * ddd + (6 * b + 30 * c) * dd + \
                            (-12 * b - 48 * c) * d + (8 * b + 24 * c) * (1 << 30)
                row.append(_cdiv(coeff, (1 << 54) // fone))
                xx += 1
            filt.append(row)
            x += 2 * inc
    cut = 0.002 * fone
    min_size = 0
    for i in range(dst_w - 1, -1, -1):
        row = filt[i]
        acc = 0
        for _ in range(size):
            acc += abs(row[0])
            if acc > cut or (i < dst_w - 1 and pos[i] >= pos[i + 1]):
                break
            row[:] = row[1:] + [0]
            pos[i] += 1
        n, acc = size, 0
        for j in range(size - 1, 0, -1):
            acc += abs(row[j])
            if acc > cut:
                break
            n -= 1
        min_size = max(min_size, n)
    if min_size == 1 and align == 2:
        align = 1
    new = (min_size + align - 1) & ~(align - 1)
    filt = [[row[j] if j < size else 0 for j in range(new)] for row in filt]
    size = new
    for i, row in enumerate(filt):
        if pos[i] < 0:
            for j in range(1, size):
                left = max(j + pos[i], 0)
                row[left] += row[j]
                row[j] = 0
            pos[i] = 0
        if pos[i] + size > src_w:
            shift = pos[i] + min(size - src_w, 0)
            acc = 0
            for j in range(size - 1, -1, -1):
                if pos[i] + j >= src_w:
                    acc += row[j]
                    row[j] = 0
            for j in range(size - 1, -1, -1):
                row[j] = 0 if j < shift else row[j - shift]
            pos[i] -= shift
            row[src_w - 1 - pos[i]] += acc
    out = np.zeros((dst_w, size), np.int64)
    for i, row in enumerate(filt):
        total = _cdiv(sum(row) + one // 2, one) or 1
        err = 0
        for j, v in enumerate(row):
            v += err
            iv = (v + (total >> 1)) // total if v >= 0 else \
                -((-v + (total >> 1)) // total)
            out[i, j] = iv
            err = v - iv * total
    return out, np.array(pos, np.int64)


def _hscale(plane: np.ndarray, coef: np.ndarray, pos: np.ndarray):
    """swscale's horizontal pass (hScale8To15): 15-bit samples."""
    idx = np.minimum(pos[:, None] + np.arange(coef.shape[1]),
                     plane.shape[1] - 1)
    v = (plane.astype(np.int64)[:, idx] * coef).sum(-1)
    return np.minimum(v >> 7, 32767)


def _pmulhw(a, b):
    return (a * b) >> 16


def _w16(a):
    return (a + 32768) % 65536 - 32768


def _swscale_bgr(y: np.ndarray, cb: np.ndarray, cr: np.ndarray, hs: int,
                 vs: int, rng: SwsRange = SWS_FULL,
                 h_pos: int = 128) -> np.ndarray:
    """BGR24 from yuvj planes with chroma shifted (hs, vs) through
    swscale's scaled path with cv2's SWS_BICUBIC: the chroma resampled to
    the output's chroma size by ``init_filter``'s filters (across to
    ceil(W / 2) for an even width, where two pixels share a chroma
    sample, to W for an odd one; down to H), then per output row: the
    full-chroma C output for an odd width (32-bit sums, rounding), else
    the MMXEXT output (16-bit ``pmulhw`` sums from the rounder 4, one or
    two chroma rows by their own rule where the vertical filter has one
    tap or two summing to 4096) on every row but the last two, which take
    the C output (lookup tables); ``rng`` is the input's range, ``h_pos``
    the chroma samples' place across their pixel in 256ths (128: the
    centre, swscale's default; 64: sited left, as FFmpeg's MPEG-4 decoder
    tags its frames)."""
    height, width = y.shape
    full = width & 1
    cw, ch = -(-width >> hs), -(-height >> vs)
    dw = width if full else -(-width >> 1)
    xinc = ((cw << 16) + (dw >> 1)) // dw
    yinc = ((ch << 16) + (height >> 1)) // height
    # swscale's default chroma position puts every sample at its centre:
    # 128/256 of its own pixel in the source and the output alike (a
    # source sited left: 64)
    hc, hp = init_filter(xinc, cw, dw, 4, 1 << 14, h_pos, 128)
    vc, vp = init_filter(yinc, ch, height, 2, 1 << 12, 128, 128)
    yb = y.astype(np.int64) << 7
    ub, vb = _hscale(cb, hc, hp), _hscale(cr, hc, hp)
    taps = vc.shape[1]
    rows = np.minimum(vp[:, None] + np.arange(taps), ch - 1)   # (H, taps)
    # two taps take yuv2packed1 where both are weights (uint16 sums)
    two = (vc.sum(1) == 4096) & (vc[:, -1] >= 0) & (vc[:, -1] <= 4096) \
        & (vc[:, 0] >= 0) if taps == 2 else np.zeros(height, bool)
    alpha = np.where(taps == 1, 0, vc[:, -1]) if taps <= 2 else \
        np.zeros(height, np.int64)
    one_tap = (taps == 1) | two          # the yuv2packed1 rows
    u0, v0 = ub[rows[:, 0]], vb[rows[:, 0]]
    u1, v1 = ub[rows[:, -1]], vb[rows[:, -1]]
    usum = (ub[rows] * vc[:, :, None]).sum(1)                 # (H, dw)
    vsum = (vb[rows] * vc[:, :, None]).sum(1)
    a = alpha[:, None]
    if full:
        yy = yb * 4
        blend = lambda c0, c1: (c0 * (4096 - a) + c1 * a - (128 << 19)) >> 10
        u = np.where(one_tap[:, None], np.where(a == 0, (u0 - (128 << 7)) * 4,
                                                blend(u0, u1)),
                     ((1 << 9) - (128 << 19) + usum) >> 10)
        v = np.where(one_tap[:, None], np.where(a == 0, (v0 - (128 << 7)) * 4,
                                                blend(v0, v1)),
                     ((1 << 9) - (128 << 19) + vsum) >> 10)
        yy = (yy - (rng.oy >> 7)) * rng.yc + (1 << 21)
        out = [yy + u * rng.ub, yy + u * rng.ug + v * rng.vg,
               yy + v * rng.vr]
        return np.stack([np.clip(_i32(c), 0, (1 << 30) - 1) >> 22
                         for c in out], -1).astype(np.uint8)
    # MMXEXT rows
    y8 = yb >> 4
    u8 = np.where(a < 2048, u0 >> 4, ((u0 + u1) & 0xFFFF) >> 5)
    v8 = np.where(a < 2048, v0 >> 4, ((v0 + v1) & 0xFFFF) >> 5)
    ux, vx = np.full(u0.shape, 4, np.int64), np.full(v0.shape, 4, np.int64)
    for j in range(taps):
        ux = _w16(ux + _pmulhw(ub[rows[:, j]], vc[:, j, None]))
        vx = _w16(vx + _pmulhw(vb[rows[:, j]], vc[:, j, None]))
    u8 = _w16(np.where(one_tap[:, None], u8, ux) - 1024)
    v8 = _w16(np.where(one_tap[:, None], v8, vx) - 1024)
    yv = _pmulhw(_w16(np.where(one_tap[:, None], y8, _w16(4 + (yb >> 4)))
                      - rng.yo), rng.yc)
    pair = lambda c: np.repeat(c, 2, 1)[:, :width]
    ug, vg = pair(_pmulhw(u8, rng.ug)), pair(_pmulhw(v8, rng.vg))
    mmx = np.stack([yv + pair(_pmulhw(u8, rng.ub)), yv + _w16(ug + vg),
                    yv + pair(_pmulhw(v8, rng.vr))], -1)
    # C rows
    yc = np.where(one_tap[:, None], (yb + 64) >> 7, ((1 << 18) + yb * 4096) >> 19)
    cblend = lambda c0, c1: (c0 * (4096 - a) + c1 * a + (128 << 11)) >> 19
    uc = np.where(one_tap[:, None], np.where(a < 2048, (u0 + 64) >> 7,
                                             cblend(u0, u1)),
                  ((1 << 18) + usum) >> 19)
    vc_ = np.where(one_tap[:, None], np.where(a < 2048, (v0 + 64) >> 7,
                                              cblend(v0, v1)),
                   ((1 << 18) + vsum) >> 19)
    bad = ((yc[:, 0::2] | yc[:, 1::2] | uc | vc_) & 0x100) != 0
    uc, vc_ = np.where(bad, np.clip(uc, 0, 255), uc), \
        np.where(bad, np.clip(vc_, 0, 255), vc_)
    yc = np.where(pair(bad), np.clip(yc, 0, 255), yc)
    uc, vc_ = pair(uc), pair(vc_)
    c_out = _sws_table(np.stack(
        [yc + ((uc * rng.cbu) >> 16) - (rng.cbu >> 9),
         yc + ((uc * rng.cgu) >> 16) - (rng.cgu >> 9)
         + ((vc_ * rng.cgv) >> 16) - (rng.cgv >> 9),
         yc + ((vc_ * rng.crv) >> 16) - (rng.crv >> 9)], -1), rng)
    last = (np.arange(height) >= height - 2)[:, None, None]
    return np.clip(np.where(last, c_out, mmx), 0, 255).astype(np.uint8)


# jdcolor.c's tables (SCALEBITS 16)
def _fix(x: float) -> int:
    return int(x * 65536.0 + 0.5)


_X = np.arange(256, dtype=np.int64) - 128
_CR_R = (_fix(1.40200) * _X + (1 << 15)) >> 16
_CB_B = (_fix(1.77200) * _X + (1 << 15)) >> 16
_CR_G = -_fix(0.71414) * _X
_CB_G = -_fix(0.34414) * _X + (1 << 15)


def _upsample(plane: np.ndarray, dh: int, dw: int, hx: int, vx: int,
              fancy: bool, height: int, width: int) -> np.ndarray:
    """A component's samples at full size (jdsample.c): fancy (triangle)
    h2v1/h2v2 where asked and the component is over 2 samples wide, else
    replicated."""
    c = plane[:dh, :dw].astype(np.int64)
    if hx == 1 and vx == 1:
        return c[:height, :width]
    if not fancy or dw <= 2:
        return np.repeat(np.repeat(c, vx, 0), hx, 1)[:height, :width]
    if vx == 2:
        y = np.arange(height)
        r = y >> 1
        nr = np.clip(np.where(y & 1, r + 1, r - 1), 0, dh - 1)
        cs = 3 * c[r] + c[nr]
        here, rnd, sh = 3 * cs, (8, 7), 4
    else:
        cs = c[:height]
        here, rnd, sh = 3 * cs, (1, 2), 2
    left = np.concatenate([cs[:, :1], cs[:, :-1]], 1)
    right = np.concatenate([cs[:, 1:], cs[:, -1:]], 1)
    out = np.empty((cs.shape[0], 2 * dw), np.int64)
    out[:, 0::2] = (here + left + rnd[0]) >> sh
    out[:, 1::2] = (here + right + rnd[1]) >> sh
    return out[:, :width]


def decode_bgr(data: bytes, height: int, width: int, mode="ffmpeg"
               ) -> Tuple[int, Optional[np.ndarray]]:
    """``clt_jpeg_decode_bgr`` in plain Python: ``(return code, frame)``,
    the frame (H, W, 3) BGR uint8 wherever the native decoder writes one
    (a fault after the scan still leaves it), else None.  ``mode``: one of
    ``MODES``, or a bool as the old ``fast`` argument (False ``"turbo"``,
    True ``"turbo_fast"``)."""
    mode = mode_name(mode)
    src = _Source(bytes(data))
    try:
        hd = _read_header(src, mode)
    except _Fault as fault:
        if mode == "ffmpeg" and not src.sos and src.pos >= src.n:
            return NO_FRAME, None
        return fault.code, None
    try:
        frame, code = _decode(hd, src, mode, height, width)
    except _Fault as fault:
        return fault.code, None
    return code, frame


def _decode(hd: _Header, src: _Source, mode: str, height: int,
            width: int, form: Optional[str] = None,
            sampling: Tuple[int, int] = (1, 1)):
    if mode == "ffmpeg":
        return _decode_ffmpeg(hd, src, height, width), OK
    fast = mode == "turbo_fast"
    comps = hd.comps
    for c in comps:
        if not (1 <= c["h"] <= 4 and 1 <= c["v"] <= 4):
            raise _Fault(CORRUPT)
    hmax = max(c["h"] for c in comps)
    vmax = max(c["v"] for c in comps)
    if sum(c["h"] * c["v"] for c in comps) > 10:
        raise _Fault(CORRUPT)
    if form is not None:  # libtiff's checks (tif_jpeg.c, JPEGPreDecode)
        if len(comps) != (1 if form == "gray" else 3):
            raise _Fault(COMPONENTS)
        want = [sampling if form == "ycc" else (1, 1)] + \
            [(1, 1)] * (len(comps) - 1)
        if [(c["h"], c["v"]) for c in comps] != want:
            raise _Fault(SAMPLING)
    if len(comps) == 3:
        c0, c1, c2 = comps
        if (c0["h"], c0["v"]) != (hmax, vmax) or \
                (c1["h"], c1["v"]) != (c2["h"], c2["v"]) or \
                hmax % c1["h"] or vmax % c1["v"] or \
                (hmax // c1["h"], vmax // c1["v"]) not in ((1, 1), (2, 1),
                                                          (2, 2)):
            raise _Fault(UNSUPPORTED)
    ids = bytes(c["id"] for c in comps)
    if form is not None:  # libtiff sets the colour space itself
        rgb = form == "stored"
    elif hd.jfif:
        rgb = False
    elif hd.adobe:
        rgb = hd.transform == 0
    else:
        rgb = ids == b"RGB"
    quant = []
    for c in comps:
        if c["tq"] > 3 or hd.qt[c["tq"]] is None:
            raise _Fault(CORRUPT)
        q = hd.qt[c["tq"]]
        quant.append((q * _AAN_SCALES + (1 << 11)) >> 12 if fast else q)
    huff = dict(STANDARD_TABLES)
    huff.update(hd.huff)
    tables = {}
    for c in comps:
        for cls, slot in ((0, c["td"]), (1, c["ta"])):
            if slot > 3 or ((cls, slot) not in huff):
                raise _Fault(CORRUPT)
            tables[(cls, slot)] = _Huff(*huff[(cls, slot)], dc=cls == 0)
    if (hd.height, hd.width) != (height, width):
        raise _Fault(GEOMETRY)
    mcux = -(-hd.width // (8 * hmax))
    mcuy = -(-hd.height // (8 * vmax))
    coefs, marker = _blocks(hd, src, mcux, mcuy, hmax, vmax, tables)
    idct = _idct_ifast if fast else _idct_islow
    full = []
    for c, coef, q in zip(comps, coefs, quant):
        nby, nbx = coef.shape[:2]
        plane = idct(coef.reshape(-1, 64), q).reshape(nby, nbx, 8, 8)
        plane = plane.transpose(0, 2, 1, 3).reshape(nby * 8, nbx * 8)
        dh = -(-hd.height * c["v"] // vmax)
        dw = -(-hd.width * c["h"] // hmax)
        full.append(_upsample(plane, dh, dw, hmax // c["h"], vmax // c["v"],
                              not fast, height, width))
    if len(full) == 1:
        frame = full[0].astype(np.uint8)
    elif rgb:
        frame = np.stack([full[2], full[1], full[0]], -1).astype(np.uint8)
    else:
        y, cb, cr = full
        frame = np.stack([y + _CB_B[cb],
                          y + ((_CB_G[cb] + _CR_G[cr]) >> 16),
                          y + _CR_R[cr]], -1).clip(0, 255).astype(np.uint8)
    if form is not None and frame.ndim == 3:  # libjpeg's order: RGB
        frame = np.ascontiguousarray(frame[..., ::-1])
    return frame, _trailer(src, marker)


# FFmpeg's pixel format for a sampling, by its pix_fmt_id after
# mjpegdec.c's normalisation (factors all even are halved): the luma
# factors of the three-component formats it reads without its own
# upscaling, as (chroma shift across, chroma shift down)
_FFMPEG_FORMATS = {0x11111100: (0, 0), 0x21111100: (1, 0),
                   0x22111100: (1, 1), 0x41111100: (2, 0),
                   0x12111100: (0, 1)}


def ffmpeg_format(comps) -> Optional[Tuple[int, int]]:
    """The chroma shifts (across, down) of the yuvj format FFmpeg decodes a
    3-component sampling to, ``(0, 0)`` for grayscale (any factors), or
    None for a sampling the ``"ffmpeg"`` mode does not read."""
    if len(comps) == 1:
        return (0, 0) if 1 <= comps[0][0] <= 4 and 1 <= comps[0][1] <= 4 \
            else None
    pid = 0
    for i, (h, v) in enumerate(comps):
        pid |= h << (28 - 8 * i) | v << (24 - 8 * i)
    if not pid & 0xD0D0D0D0:
        pid -= (pid & 0xF0F0F0F0) >> 1
    if not pid & 0x0D0D0D0D:
        pid -= (pid & 0x0F0F0F0F) >> 1
    return _FFMPEG_FORMATS.get(pid)


def _decode_ffmpeg(hd: _Header, src: _Source, height: int,
                   width: int) -> np.ndarray:
    """The frame as FFmpeg decodes it and swscale converts it to BGR24:
    every scan's coefficients (``_scan_ffmpeg``), then ``simple_idct``
    on each component's blocks, then the conversion of the planes."""
    comps = hd.comps
    for c in comps:
        if not (1 <= c["h"] <= 4 and 1 <= c["v"] <= 4):
            raise _Fault(CORRUPT)
    hmax = max(c["h"] for c in comps)
    vmax = max(c["v"] for c in comps)
    if sum(c["h"] * c["v"] for c in comps) > 10:
        raise _Fault(CORRUPT)
    shifts = ffmpeg_format([(c["h"], c["v"]) for c in comps])
    ids = bytes(c["id"] for c in comps)
    gray = len(comps) == 1
    if shifts is None or (not gray and (
            (comps[1]["h"], comps[1]["v"]) != (comps[2]["h"], comps[2]["v"])
            or ids == b"QFA")):
        raise _Fault(UNSUPPORTED)
    if any(c.startswith(_FFMPEG_COMMENTS) for c in hd.comments):
        raise _Fault(UNMATCHED)
    rgb = not gray and shifts == (0, 0) and (
        hd.adobe and hd.transform == 0 or ids == b"RGB")
    for c in comps:
        if c["tq"] > 3 or hd.qt[c["tq"]] is None:
            raise _Fault(CORRUPT)
    progressive = hd.sof == 0xC2
    mcux = -(-hd.width // (8 * hmax))
    mcuy = -(-hd.height // (8 * vmax))
    coefs = [np.zeros((mcuy * c["v"], mcux * c["h"], 64), np.int16)
             for c in comps]
    last_nnz = [np.zeros(cf.shape[:2], np.uint8) for cf in coefs]
    if (hd.height, hd.width) != (height, width):
        _scan_tables(hd, progressive)
        raise _Fault(GEOMETRY)
    coded = set()
    while True:
        _scan_ffmpeg(hd, src, coefs, last_nnz, hmax, vmax, progressive)
        coded.update(hd.scan)
        src.pos -= 2  # back to the marker after the scan
        if _walk(src, hd, "ffmpeg", header=False) == _EOI:
            break
    if len(coded) != len(comps):
        raise _Fault(UNMATCHED)
    planes = []
    for c, coef in zip(comps, coefs):
        nby, nbx = coef.shape[:2]
        plane = _idct_simple(coef.reshape(-1, 64), np.ones(64, np.int64))
        plane = plane.reshape(nby, nbx, 8, 8).transpose(0, 2, 1, 3)
        planes.append(plane.reshape(nby * 8, nbx * 8))
    y = planes[0][:height, :width]
    if gray:
        return np.repeat(y[..., None], 3, -1)
    hs, vs = shifts
    ch, cw = -(-height >> vs), -(-width >> hs)
    cb, cr = (p[:ch, :cw] for p in planes[1:])
    if rgb:
        return np.stack([cr, cb, y], -1)
    if shifts == (0, 0):
        return _ffmpeg_bgr(y, cb, cr, subsampled=False)
    if hs == 1 and height % 2 == 0:  # 4:2:2 and 4:2:0: the unscaled path
        full = [np.repeat(np.repeat(c, 1 + vs, 0), 2, 1)[:height, :width]
                for c in (cb, cr)]
        return _ffmpeg_bgr(y, *full, subsampled=True)
    return _swscale_bgr(y, cb, cr, hs, vs)


def _classes(hd: _Header, progressive: bool) -> List[int]:
    """The Huffman classes (0 DC, 1 AC) the scan decodes with."""
    if not progressive:
        return [0, 1]
    if hd.ss:
        return [1]
    return [] if hd.ah else [0]


def _scan_tables(hd: _Header, progressive: bool) -> dict:
    """The scan's derived Huffman tables by (component, class); CORRUPT
    where it names a slot no table fills, or a table libjpeg rejects."""
    huff = dict(STANDARD_TABLES)
    huff.update(hd.huff)
    slots = {(k, cls): hd.comps[k]["ta"] if cls else hd.comps[k]["td"]
             for k in hd.scan for cls in _classes(hd, progressive)}
    if any(slot > 3 or (cls, slot) not in huff
           for (k, cls), slot in slots.items()):
        raise _Fault(CORRUPT)
    return {(k, cls): _Huff(*huff[(cls, slot)], dc=cls == 0)
            for (k, cls), slot in slots.items()}


def _trailer(src: _Source, m: int) -> int:
    """The markers after the scan, up to EOI (``jpeg.cpp``'s trailer)."""
    while True:
        if m == _EOI:
            return OK
        if m == 0xDA:
            return UNSUPPORTED
        if m == 0xD8 or (0xC0 <= m <= 0xCF and m not in (0xC4, 0xCC)):
            return CORRUPT
        if not (0xD0 <= m <= 0xD7 or m == 0x01):
            if not (m in (0xC4, 0xCC, 0xDB, 0xDC, 0xDD, 0xFE)
                    or 0xE0 <= m <= 0xEF):
                return CORRUPT
            length = (src.at(src.pos) << 8) | src.at(src.pos + 1)
            src.pos += max(length, 2)
        m = src.next_marker()


def decode(data: bytes, mode=False) -> np.ndarray:
    """One JPEG's (H, W, 3) BGR uint8 frame in ``mode`` (as
    :func:`decode_bgr` takes it; the default is ``"turbo"``); a ValueError
    where the native decoder returns a fault."""
    mode = mode_name(mode)
    src = _Source(bytes(data))
    try:
        hd = _read_header(src, mode)
        frame, code = _decode(hd, src, mode, hd.height, hd.width)
    except _Fault as fault:
        code, frame = fault.code, None
    if code != OK:
        raise ValueError(f"jpeg_plain.decode: {_REASONS[code]}")
    return frame


def splice_tables(tables: bytes, chunk: bytes) -> bytes:
    """One stream from a TIFF's JPEGTables (SOI, tables, EOI) and an
    abbreviated chunk: the tables' segments after the chunk's SOI, which
    is what libjpeg reading both streams in turn keeps.  No tables: the
    chunk."""
    if not tables:
        return bytes(chunk)
    if tables[:2] != b"\xff\xd8" or tables[-2:] != b"\xff\xd9" or \
            chunk[:2] != b"\xff\xd8":
        raise _Fault(CORRUPT)
    return bytes(tables[:-2]) + bytes(chunk[2:])


def decode_tiff(tables: bytes, chunk: bytes, height: int, width: int,
                form: str, sampling: Tuple[int, int] = (1, 1)
                ) -> Tuple[int, Optional[np.ndarray]]:
    """``clt_jpeg_decode_tiff_batch``'s decode of one TIFF chunk in plain
    Python: ``(return code, samples)``, the samples (height, width, 3)
    RGB (``form`` "ycc" or "stored") or (height, width) uint8 ("gray"),
    decoded as the ``"turbo"`` mode decodes (islow IDCT, fancy
    upsampling, jdcolor's tables).  The frame must have one component for
    "gray" and three otherwise (COMPONENTS), the first sampled as
    ``sampling`` for "ycc" and every other one 1x1 (SAMPLING), and be
    ``height`` x ``width`` (GEOMETRY)."""
    if form not in TIFF_FORMS:
        raise ValueError(f"unknown TIFF form {form!r}; expected one of "
                         f"{TIFF_FORMS}")
    try:
        src = _Source(splice_tables(tables, chunk))
        hd = _read_header(src, "tiff")
        frame, code = _decode(hd, src, "turbo", height, width, form,
                              sampling)
    except _Fault as fault:
        return fault.code, None
    return code, frame
