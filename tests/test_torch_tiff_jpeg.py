"""The port's TIFF reader on JPEG, YCbCr, bilevel and fax TIFFs: JPEG chunks
(compression 7: YCbCr, RGB and gray, strips and tiles, with JPEGTables),
YCbCr in subsampling units under every other compression, bilevel and
CCITT fax (compression 2, 3 one- and two-dimensional, 4), 1-, 2- and
4-bit gray, gray of 3 or 4 samples, signed packed samples and an 8-bit
palette without its ColorMap.

* ``utils/tiff.imread`` returns what ``cv2.imread`` returns, bit for bit
  under IMREAD_UNCHANGED and IMREAD_COLOR, None included, on files from
  ``tests/_torch_tiff_writer.py`` and from PIL (libtiff's own JPEG and
  fax encoders), and on the small files committed under ``tests/data``
  (``tiff *.tif``, with cv2's arrays in ``*.cv2.npz``, which
  ``chip_smoke.py`` holds the port to on the card's machine);
* libtiff's choices hold where the JPEG markers disagree with the tags
  (the photometric decides the colour space; a chunk sampled otherwise
  than YCbCrSubSampling says gives cv2's None);
* the native JPEG-chunk and CCITT decodes equal their plain versions
  (``native/jpeg_plain.py``'s ``decode_tiff``, ``native/tiff_plain.py``'s
  ``ccitt_decode``), and both raise on chunks libtiff reads only by
  concealing an error.

``python -m tests.test_torch_tiff_jpeg`` rewrites the committed files and
their cv2 arrays (it needs cv2 and PIL).
"""
import struct
from pathlib import Path

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from camera_linearity_tpu_torch import native  # noqa: E402
from camera_linearity_tpu_torch.native import jpeg_plain  # noqa: E402
from camera_linearity_tpu_torch.native import tiff_plain  # noqa: E402
from camera_linearity_tpu_torch.utils import tiff  # noqa: E402
from tests._torch_tiff_writer import build_tiff, ccitt_encode  # noqa: E402

DATA = Path(__file__).resolve().parent / "data"
SHAPE = (37, 53)


def assert_same(got, want, what=""):
    if want is None:
        assert got is None, what
        return
    assert got is not None and got.dtype == want.dtype, what
    assert got.shape == want.shape, what
    np.testing.assert_array_equal(got, want, err_msg=what)


def _pairs(path):
    """(the port's, cv2's) reads of ``path`` under both flags."""
    flags = (cv2.IMREAD_UNCHANGED, cv2.IMREAD_COLOR)
    return ([tiff.imread(path, f) for f in flags],
            [cv2.imread(str(path), f) for f in flags])


def smooth(shape=SHAPE, channels=3, seed=21):
    """Gradients plus noise: content a JPEG codes at realistic sizes."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:shape[0], :shape[1]]
    base = np.stack([(xx * 4.5) % 256, (yy * 3.1) % 256,
                     ((xx + yy) * 1.7) % 256, (xx * yy) % 256], -1)
    px = base[..., :channels] + rng.normal(0, 25, (*shape, channels))
    return px.clip(0, 255).astype(np.uint8)


def bilevel(shape=SHAPE, seed=22):
    """0/1 (1 black) blobs with ragged edges: runs of many lengths."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:shape[0], :shape[1]]
    v = np.sin(xx / 3.0) + np.cos(yy / 4.0) + rng.normal(0, 0.4, shape)
    return (v > 0.2).astype(np.uint8)[..., None]


def draw(kind, channels, seed=23):
    rng = np.random.default_rng(seed)
    if kind.startswith("b"):  # unsigned values of that many bits
        return rng.integers(0, 1 << int(kind[1:]), (*SHAPE, channels),
                            np.uint16 if int(kind[1:]) > 8 else np.uint8)
    dt = np.dtype(kind)
    return rng.integers(0, np.iinfo(dt).max, (*SHAPE, channels), dt,
                        endpoint=True)


WHITE, BLACK, PALETTE = ((262, 3, [k]) for k in (0, 1, 3))
RBW = (532, 5, [16, 1, 235, 1, 128, 1, 240, 1, 128, 1, 240, 1])
LUMA = (529, 5, [2126, 10000, 7152, 10000, 722, 10000])

# name: (samples, build_tiff keywords); strips of 16 rows or tiles of
# 16 x 32 are added
LAYOUTS = {
    "JPEG YCbCr 4:4:4": ("smooth", dict(compression=7, ycbcr=(1, 1))),
    "JPEG YCbCr 4:2:2": ("smooth", dict(compression=7, ycbcr=(2, 1))),
    "JPEG YCbCr 4:2:0": ("smooth", dict(compression=7, ycbcr=(2, 2))),
    "JPEG YCbCr 4:2:0 quality 40": ("smooth", dict(
        compression=7, ycbcr=(2, 2), quality=40)),
    "JPEG RGB": ("smooth", dict(compression=7)),
    "JPEG gray": ("smooth1", dict(compression=7)),
    "JPEG gray MinIsWhite": ("smooth1", dict(compression=7,
                                             extra_tags=[WHITE])),
    "JPEG YCbCr 4:2:0 Orientation 3": ("smooth", dict(
        compression=7, ycbcr=(2, 2), extra_tags=[(274, 3, [3])])),
    "YCbCr 1x1": ("u1", dict(ycbcr=(1, 1))),
    "YCbCr 1x1 LZW predictor 2": ("u1", dict(ycbcr=(1, 1), compression=5,
                                             predictor=2)),
    "YCbCr 2x1 LZW": ("u1", dict(ycbcr=(2, 1), compression=5)),
    "YCbCr 2x2": ("u1", dict(ycbcr=(2, 2))),
    "YCbCr 2x2 Deflate": ("u1", dict(ycbcr=(2, 2), compression=8)),
    "YCbCr 2x2 Deflate 32946": ("u1", dict(ycbcr=(2, 2),
                                           compression=32946)),
    "YCbCr 2x2 PackBits": ("u1", dict(ycbcr=(2, 2), compression=32773)),
    "YCbCr 1x2": ("u1", dict(ycbcr=(1, 2))),
    "YCbCr 4x1": ("u1", dict(ycbcr=(4, 1))),
    "YCbCr 4x2 LZW": ("u1", dict(ycbcr=(4, 2), compression=5)),
    "YCbCr 1x4 (cv2: None)": ("u1", dict(ycbcr=(1, 4))),
    "YCbCr 2x4 (cv2: None)": ("u1", dict(ycbcr=(2, 4))),
    "YCbCr 2x2 ReferenceBlackWhite": ("u1", dict(ycbcr=(2, 2),
                                                 extra_tags=[RBW])),
    "YCbCr 2x1 YCbCrCoefficients": ("u1", dict(ycbcr=(2, 1),
                                               extra_tags=[LUMA, RBW])),
    "YCbCr 1x1 Orientation 2": ("u1", dict(ycbcr=(1, 1),
                                           extra_tags=[(274, 3, [2])])),
    "1-bit gray": ("b1", dict(bits=1, extra_tags=[BLACK])),
    "1-bit MinIsWhite": ("b1", dict(bits=1, extra_tags=[WHITE])),
    "1-bit LZW": ("b1", dict(bits=1, compression=5)),
    "1-bit PackBits": ("b1", dict(bits=1, compression=32773,
                                  extra_tags=[WHITE])),
    "1-bit Deflate FillOrder 2": ("b1", dict(bits=1, compression=8,
                                             fill_order=2)),
    "2-bit gray (cv2: None)": ("b2", dict(bits=2)),
    "4-bit gray (cv2: None)": ("b4", dict(bits=4, compression=5)),
    "4-bit MinIsWhite (cv2: None)": ("b4", dict(bits=4,
                                                extra_tags=[WHITE])),
    "CCITT RLE": ("bilevel", dict(bits=1, compression=2,
                                  extra_tags=[WHITE])),
    "CCITT RLE MinIsBlack": ("bilevel", dict(bits=1, compression=2,
                                             extra_tags=[BLACK])),
    "CCITT G3 1-D": ("bilevel", dict(bits=1, compression=3,
                                     extra_tags=[WHITE])),
    "CCITT G3 1-D fill bits": ("bilevel", dict(bits=1, compression=3,
                                               fax_fill=True)),
    "CCITT G3 1-D FillOrder 2": ("bilevel", dict(
        bits=1, compression=3, fill_order=2, extra_tags=[WHITE])),
    "gray of 3 u8": ("u1x3", dict(extra_tags=[BLACK])),
    "gray of 4 u8 MinIsWhite": ("u1x4", dict(extra_tags=[WHITE])),
    "gray of 3 u16": ("u2x3", dict(extra_tags=[BLACK], compression=5,
                                   predictor=2)),
    "gray of 4 u16 MinIsWhite": ("u2x4", dict(extra_tags=[WHITE])),
    "signed 10-bit": ("b10", dict(bits=10, fmt=2)),
    "signed 12-bit": ("b12", dict(bits=12, fmt=2, compression=32773)),
    "signed 14-bit": ("b14", dict(bits=14, fmt=2)),
    "palette 8-bit without ColorMap": ("u1x1", dict(extra_tags=[PALETTE])),
    "palette 4-bit without ColorMap (cv2: None)": ("b4", dict(
        bits=4, extra_tags=[PALETTE])),
    "palette 1-bit without ColorMap (cv2: None)": ("b1", dict(
        bits=1, extra_tags=[PALETTE])),
}


def samples(kind):
    if kind == "smooth":
        return smooth()
    if kind == "smooth1":
        return smooth(channels=1)
    if kind == "bilevel":
        return bilevel()
    if kind.startswith("b"):
        return draw(kind, 1)
    base, _, n = kind.partition("x")
    return draw(base, int(n or 3))


@pytest.mark.parametrize("chunks", [dict(rps=16), dict(tile=(16, 32))],
                         ids=["strips", "tiles"])
@pytest.mark.parametrize("order", ["<", ">"], ids=["II", "MM"])
@pytest.mark.parametrize("name", list(LAYOUTS))
def test_new_layouts_equal_cv2(tmp_path, name, order, chunks):
    kind, kw = LAYOUTS[name]
    path = tmp_path / "n.tif"
    build_tiff(path, order, samples(kind), **kw, **chunks)
    got, want = _pairs(path)
    assert (want[0] is None) == ("None" in name), name
    for g, w in zip(got, want):
        assert_same(g, w, name)


@pytest.mark.parametrize("chunks", [dict(rps=8), dict(rps=SHAPE[0])],
                         ids=["strips", "one strip"])
def test_ycbcr_4x4_units_equal_cv2(tmp_path, chunks):
    """4 x 4 units in strips (in tiles cut by the image's edge libtiff
    writes wrong pixels, and the reader refuses them: test_torch_tiff)."""
    build_tiff(tmp_path / "u.tif", "<", samples("u1"), ycbcr=(4, 4),
               **chunks)
    for g, w in zip(*_pairs(tmp_path / "u.tif")):
        assert_same(g, w)


@pytest.mark.parametrize("chunks", [dict(rps=5), dict(rps=15),
                                    dict(tile=(8, 24)), dict(tile=(24, 8))],
                         ids=str)
def test_jpeg_chunks_of_any_size_equal_cv2(tmp_path, chunks):
    """4:2:0 JPEG chunks whose rows or columns are no multiple of the
    MCU (libtiff writes multiples of 16; it reads any)."""
    build_tiff(tmp_path / "q.tif", "<", smooth(), compression=7,
               ycbcr=(2, 2), **chunks)
    for g, w in zip(*_pairs(tmp_path / "q.tif")):
        assert w is not None
        assert_same(g, w)


PIL_CASES = [("1", dict(compression="group3")),
             ("1", dict(compression="group4")),
             ("1", dict(compression="tiff_ccitt")),
             ("1", dict(compression="group3", tiffinfo={292: 1})),
             ("1", dict(compression="group3", tiffinfo={292: 5})),
             ("1", dict(compression="group3", tiffinfo={292: 1, 278: 8})),
             ("1", dict(compression="group4", tiffinfo={278: 8})),
             ("1", {}), ("1", dict(compression="packbits")),
             ("RGB", dict(compression="jpeg")),
             ("RGB", dict(compression="jpeg", quality=30,
                          tiffinfo={278: 16})),
             ("L", dict(compression="jpeg")),
             ("YCbCr", dict(compression="jpeg"))]


def _pil_file(path, mode, options, shape=SHAPE):
    Image = pytest.importorskip("PIL.Image")
    if mode == "1":
        im = Image.fromarray(((1 - bilevel(shape)[..., 0]) * 255).astype(
            np.uint8)).convert("1")
    else:
        im = Image.fromarray(smooth(shape)).convert(mode)
    im.save(path, **options)


def _pil_id(mode, options):
    info = "-".join(map(str, options.get("tiffinfo", {}).values()))
    return f"{mode}-{options.get('compression', 'raw')}-{info or 'default'}"


@pytest.mark.parametrize("mode,options", PIL_CASES,
                         ids=[_pil_id(m, o) for m, o in PIL_CASES])
def test_pil_files_equal_cv2(tmp_path, mode, options):
    path = tmp_path / "pil.tif"
    _pil_file(path, mode, options, shape=(70, 98))
    got, want = _pairs(path)
    for g, w in zip(got, want):
        assert w is not None
        assert_same(g, w)


@pytest.mark.parametrize("channels", [1, 3])
def test_cv2_written_jpeg_tiffs_equal_cv2(tmp_path, channels):
    """cv2's own writer (libtiff's JPEG encoder, RGB photometric)."""
    path = tmp_path / "cv2.tif"
    img = smooth((40, 48))[..., :channels]  # cv2 writes one strip
    assert cv2.imwrite(str(path), img if channels == 3 else img[..., 0],
                       [cv2.IMWRITE_TIFF_COMPRESSION, 7])
    got, want = _pairs(path)
    for g, w in zip(got, want):
        assert w is not None
        assert_same(g, w)


# --- JPEG markers against the tags ------------------------------------------

JFIF = b"\xff\xe0\x00\x10JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00"
ADOBE = [b"\xff\xee\x00\x0eAdobe\x00\x64\x00\x00\x00\x00" + bytes([t])
         for t in (0, 1)]


def _chunks_of(path):
    data = np.fromfile(path, np.uint8)
    order = "<" if data[0] == 0x49 else ">"
    ifd = tiff._Ifd(data, order, struct.unpack(order + "I",
                                                data[4:8].tobytes())[0])
    tiled = 324 in ifd.tags
    offsets, counts = (ifd.get(324), ifd.get(325)) if tiled else \
        (ifd.get(273), ifd.get(279))
    return data, ifd, offsets, counts


def _with_chunks(path, kw, edit):
    """A file of ``kw`` (``kind`` its samples) with every chunk replaced
    by ``edit(chunk)``: the new chunks and a new IFD (the old entries,
    the chunks' offsets and counts replaced) appended."""
    build_tiff(path, "<", samples(kw.pop("kind")), **kw)
    data, ifd, offsets, counts = _chunks_of(path)
    body = bytearray(data.tobytes())
    new_offsets, new_counts = [], []
    for o, c in zip(offsets.tolist(), counts.tolist()):
        chunk = edit(data[o:o + c].tobytes())
        new_offsets.append(len(body))
        new_counts.append(len(chunk))
        body += chunk + b"\0" * (len(chunk) % 2)
    first = struct.unpack("<I", data[4:8].tobytes())[0]
    n = struct.unpack("<H", data[first:first + 2].tobytes())[0]
    entries = {}
    for k in range(n):
        e = data[first + 2 + 12 * k:first + 14 + 12 * k].tobytes()
        entries[struct.unpack("<H", e[:2])[0]] = e
    tiled = 324 in ifd.tags
    for tag, values in ((324 if tiled else 273, new_offsets),
                        (325 if tiled else 279, new_counts)):
        at = values[0] if len(values) == 1 else len(body)
        if len(values) > 1:
            body += struct.pack(f"<{len(values)}I", *values)
        entries[tag] = struct.pack("<HHII", tag, 4, len(values), at)
    ifd_at = len(body)
    body += struct.pack("<H", len(entries)) + b"".join(
        entries[t] for t in sorted(entries)) + b"\0\0\0\0"
    body[4:8] = struct.pack("<I", ifd_at)
    path.write_bytes(bytes(body))


def _insert_after_soi(segment):
    return lambda chunk: chunk[:2] + segment + chunk[2:]


def _ids_rgb(chunk):
    """Component IDs 'R', 'G', 'B' in the frame and scan headers."""
    out = bytearray(chunk)
    for marker in (b"\xff\xc0", b"\xff\xda"):
        at = out.index(marker)
        n = out[at + 4 if marker == b"\xff\xda" else at + 9]
        first = at + 5 if marker == b"\xff\xda" else at + 10
        step = 2 if marker == b"\xff\xda" else 3
        for c in range(n):
            out[first + step * c] = b"RGB"[c]
    return bytes(out)


MARKER_CASES = {
    "YCbCr with JFIF": (dict(ycbcr=(2, 2)), _insert_after_soi(JFIF)),
    "YCbCr with Adobe transform 0": (dict(ycbcr=(2, 1)),
                                     _insert_after_soi(ADOBE[0])),
    "YCbCr with IDs R, G, B": (dict(ycbcr=(2, 2)), _ids_rgb),
    "RGB with JFIF": ({}, _insert_after_soi(JFIF)),
    "RGB with Adobe transform 1": ({}, _insert_after_soi(ADOBE[1])),
}


@pytest.mark.parametrize("name", list(MARKER_CASES))
def test_photometric_decides_the_colour_space(tmp_path, name):
    """libtiff sets libjpeg's colour space from the photometric (YCbCr
    converted, RGB as stored), whatever JFIF, Adobe or the component IDs
    say; the port does the same."""
    kw, edit = MARKER_CASES[name]
    path = tmp_path / "m.tif"
    _with_chunks(path, dict(kind="smooth", compression=7, rps=16, **kw),
                 edit)
    got, want = _pairs(path)
    assert want[0] is not None
    for g, w in zip(got, want):
        assert_same(g, w, name)


@pytest.mark.parametrize("stream,tags", [((2, 2), [(530, 3, [2, 1])]),
                                         ((1, 1), [(530, 3, [2, 2])]),
                                         ((2, 2), [(262, 3, [2])])],
                         ids=["2x2 under 2x1", "1x1 under 2x2",
                              "2x2 under RGB"])
def test_sampling_other_than_the_tags_gives_none(tmp_path, stream, tags):
    """A chunk sampled otherwise than YCbCrSubSampling (or subsampled
    under RGB) is an error to libtiff: cv2 gives None, and so does the
    port."""
    build_tiff(tmp_path / "s.tif", "<", smooth(), compression=7,
               ycbcr=stream, rps=16, extra_tags=tags)
    got, want = _pairs(tmp_path / "s.tif")
    assert want == [None, None] and got == [None, None]


@pytest.mark.parametrize("stream", [(1, 1), (2, 1), (2, 2)])
def test_missing_subsampling_is_the_first_chunks(tmp_path, stream):
    """Without YCbCrSubSampling libtiff takes the first chunk's sampling
    (JPEGFixupTags), not the tag's default 2 x 2."""
    path = tmp_path / "f.tif"
    build_tiff(path, "<", smooth(), compression=7, ycbcr=stream, rps=16)
    raw = bytearray(path.read_bytes())
    first = struct.unpack("<I", raw[4:8])[0]
    n = struct.unpack("<H", raw[first:first + 2])[0]
    for k in range(n):  # retag 530 as a private tag no reader knows
        at = first + 2 + 12 * k
        if struct.unpack("<H", raw[at:at + 2])[0] == 530:
            raw[at:at + 2] = struct.pack("<H", 65000)
    path.write_bytes(bytes(raw))
    got, want = _pairs(path)
    for g, w in zip(got, want):
        assert w is not None
        assert_same(g, w)


def test_a_gray_photometric_over_three_components_gives_none(tmp_path):
    build_tiff(tmp_path / "c.tif", "<", smooth(), compression=7, rps=16,
               extra_tags=[(262, 3, [1]), (277, 3, [1]), (258, 3, [8])])
    got, want = _pairs(tmp_path / "c.tif")
    assert want == [None, None] and got == [None, None]


@pytest.mark.parametrize("fault,message", [
    ("precision 12", "a JPEG mode it does not read"),
    ("progressive", "a JPEG mode it does not read"),
    ("cut before the scan", "corrupt JPEG data"),
    ("a taller frame", "its frame is not 16 x 53")])
def test_unread_jpeg_chunks_raise_naming_the_chunk(tmp_path, fault,
                                                   message):
    def edit(chunk):
        at = chunk.index(b"\xff\xc0")
        if fault == "precision 12":
            return chunk[:at + 4] + b"\x0c" + chunk[at + 5:]
        if fault == "progressive":
            return chunk[:at + 1] + b"\xc2" + chunk[at + 2:]
        if fault == "cut before the scan":
            return chunk[:at]
        h = struct.unpack(">H", chunk[at + 5:at + 7])[0]
        return chunk[:at + 5] + struct.pack(">H", h + 8) + chunk[at + 7:]
    path = tmp_path / "j.tif"
    _with_chunks(path, dict(kind="smooth", compression=7, ycbcr=(2, 2),
                            rps=16), edit)
    for flags in (tiff.IMREAD_UNCHANGED, tiff.IMREAD_COLOR):
        with pytest.raises(ValueError, match=f"JPEG chunk 0: {message}"):
            tiff.imread(path, flags)


# --- native against plain ----------------------------------------------------

def _jpeg_chunks(path):
    data, ifd, offsets, counts = _chunks_of(path)
    tables = ifd.get(347, np.array([], np.int64)).astype(np.uint8).tobytes()
    ch = tiff._chunks(ifd, tiff._layout(ifd))
    return data, tables, offsets, counts, ch.heights, ch.cols


@pytest.mark.parametrize("case", [
    ("ycc", (2, 2), dict(rps=16)), ("ycc", (2, 1), dict(tile=(16, 32))),
    ("ycc", (1, 1), dict(rps=37)), ("stored", None, dict(rps=16)),
    ("stored", None, dict(tile=(16, 32))), ("gray", None, dict(rps=16)),
    ("gray", None, dict(tile=(32, 16)))], ids=str)
def test_native_jpeg_chunks_equal_plain(tmp_path, case):
    form, sampling, chunks = case
    px = smooth(channels=1) if form == "gray" else smooth()
    path = tmp_path / "p.tif"
    build_tiff(path, "<", px, compression=7, ycbcr=sampling, **chunks)
    data, tables, offsets, counts, heights, width = _jpeg_chunks(path)
    per = width * (1 if form == "gray" else 3)
    sizes = heights * per
    starts = np.concatenate([[0], np.cumsum(sizes[:-1])])
    out = np.full(int(sizes.sum()), 7, np.uint8)
    rcs = native.jpeg_decode_tiff_chunks(tables, data, offsets, counts, out,
                                         starts, heights, width, form,
                                         sampling or (1, 1))
    assert rcs.tolist() == [0] * len(rcs)
    for k, (o, c, h, s) in enumerate(zip(offsets, counts, heights, starts)):
        code, plain = jpeg_plain.decode_tiff(tables, data[o:o + c].tobytes(),
                                             int(h), width, form,
                                             sampling or (1, 1))
        assert code == 0
        np.testing.assert_array_equal(
            out[s:s + h * per].reshape(plain.shape), plain, err_msg=k)


def test_native_jpeg_chunk_codes_equal_plain(tmp_path):
    """A sampling, component count, geometry or stream the decode refuses
    returns the same code natively and plainly."""
    path = tmp_path / "q.tif"
    build_tiff(path, "<", smooth(), compression=7, ycbcr=(2, 2), rps=16)
    data, tables, offsets, counts, heights, width = _jpeg_chunks(path)
    chunk = data[offsets[0]:offsets[0] + counts[0]]
    for form, sampling, h, tab, want in (
            ("ycc", (2, 1), 16, tables, jpeg_plain.SAMPLING),
            ("stored", (1, 1), 16, tables, jpeg_plain.SAMPLING),
            ("gray", (1, 1), 16, tables, jpeg_plain.COMPONENTS),
            ("ycc", (2, 2), 15, tables, jpeg_plain.GEOMETRY),
            ("ycc", (2, 2), 16, tables[:-2], jpeg_plain.CORRUPT),
            ("ycc", (2, 2), 16, b"", jpeg_plain.CORRUPT)):
        out = np.empty(h * width * 3, np.uint8)
        (rc,) = native.jpeg_decode_tiff_chunks(tab, chunk, [0], [chunk.size],
                                               out, [0], [h], width, form,
                                               sampling)
        code, _ = jpeg_plain.decode_tiff(tab, chunk.tobytes(), h, width,
                                         form, sampling)
        assert rc == code == want, (form, sampling, h, len(tab))
    (rc,) = native.jpeg_decode_tiff_chunks(tables, chunk, [chunk.size], [4],
                                           out, [0], [16], width, "ycc",
                                           (2, 2))
    assert rc == -9


def _ccitt_cases(tmp_path):
    """(label, path): the writer's Modified Huffman and T.4 1-D files and
    libtiff's (PIL's) T.4 2-D and T.6 ones, several strips each."""
    out = []
    for label, kw in (("RLE", dict(compression=2)),
                      ("G3 1-D", dict(compression=3)),
                      ("G3 1-D fill", dict(compression=3, fax_fill=True))):
        path = tmp_path / f"{label}.tif"
        build_tiff(path, "<", bilevel((70, 98)), bits=1, rps=16, **kw)
        out.append((label, path))
    for label, options in (("G3 2-D", dict(compression="group3",
                                            tiffinfo={292: 1, 278: 16})),
                           ("G3 2-D fill", dict(compression="group3",
                                                tiffinfo={292: 5, 278: 16})),
                           ("G4", dict(compression="group4",
                                       tiffinfo={278: 16}))):
        path = tmp_path / f"{label}.tif"
        _pil_file(path, "1", options, shape=(70, 98))
        out.append((label, path))
    return out


def _ccitt_layout(path):
    data, ifd, offsets, counts = _chunks_of(path)
    lay = tiff._layout(ifd)
    ch = tiff._chunks(ifd, lay)
    return data, lay, offsets, counts, ch.sizes, ch.heights, ch.cols


def test_native_ccitt_equals_plain(tmp_path):
    for label, path in _ccitt_cases(tmp_path):
        data, lay, offsets, counts, sizes, rows, width = _ccitt_layout(path)
        starts = np.concatenate([[0], np.cumsum(sizes[:-1])])
        out = np.full(int(sizes.sum()), 0xAA, np.uint8)
        got = native.ccitt_decode_chunks(data, offsets, counts, out, starts,
                                         sizes, rows, width, lay.compression,
                                         lay.t4)
        assert got.tolist() == sizes.tolist(), label
        plain = b"".join(tiff_plain.ccitt_decode(
            data[o:o + c].tobytes(), width, int(r), lay.compression, lay.t4)
            for o, c, r in zip(offsets, counts, rows))
        assert out.tobytes() == plain, label


@pytest.mark.parametrize("fault", ["cut", "bad code", "no EOL"])
def test_concealed_ccitt_errors_raise(tmp_path, fault):
    """Chunks libtiff reads only by concealing an error (a cut chunk, a
    code no table holds, a T.4 row without its EOL) raise natively, in
    the plain version and in ``imread``, naming the chunk."""
    rows = bilevel((20, 40))[..., 0]
    stream = bytearray(ccitt_encode(rows, 3))
    if fault == "cut":
        stream = stream[:len(stream) // 2]
    elif fault == "bad code":  # an EOL, then 8 zeros and a one: no code
        bits = tiff_plain.EOL + "000000001" + "1" * 11
        stream = bytearray(np.packbits(np.array(list(bits), np.uint8) - 48)
                           .tobytes())
    else:
        stream[0:2] = b"\xff\xff"
    with pytest.raises(ValueError):
        tiff_plain.ccitt_decode(bytes(stream), 40, 20, 3)
    src = np.frombuffer(bytes(stream), np.uint8).copy()
    out = np.empty(20 * 5, np.uint8)
    with pytest.raises(ValueError, match="CCITT chunk 0"):
        native.ccitt_decode_chunks(src, [0], [src.size], out, [0],
                                   [out.size], [20], 40, 3)
    path = tmp_path / "f.tif"
    build_tiff(path, "<", rows[..., None], bits=1, compression=3)
    data = bytearray(path.read_bytes())
    at, n = 8, len(ccitt_encode(rows, 3))
    data[at:at + n] = bytes(stream) + b"\0" * (n - len(stream))
    path.write_bytes(bytes(data))
    with pytest.raises(ValueError, match="CCITT chunk 0"):
        tiff.imread(path, tiff.IMREAD_UNCHANGED)


# --- what BAD_TAGS listed as refused and now reads --------------------------

# the refusal message test_torch_tiff's BAD_TAGS held, the samples and the
# keywords of a file in that layout (real JPEG and CCITT chunks), and
# whether cv2 reads it
READ_NOW = [
    ("Compression=7", "smooth", dict(compression=7, ycbcr=(2, 2)), True),
    ("Compression=3", "bilevel", dict(compression=3, bits=1), True),
    ("PhotometricInterpretation=6", "u1", dict(ycbcr=(2, 2)), True),
    ("BitsPerSample=1", "b1", dict(bits=1), True),
    ("BitsPerSample=4", "b4", dict(bits=4), False),
    ("BitsPerSample=12 with SampleFormat=2", "b12", dict(bits=12, fmt=2),
     True),
    ("SamplesPerPixel=3 with PhotometricInterpretation=1", "u1",
     dict(extra_tags=[BLACK]), True),
    ("ColorMap=missing", "u1x1", dict(extra_tags=[PALETTE]), True),
]


@pytest.mark.parametrize("was,kind,spec,cv2_reads", READ_NOW,
                         ids=[w for w, *_ in READ_NOW])
def test_formerly_refused_layouts_read(tmp_path, was, kind, spec,
                                       cv2_reads):
    """What the reader refused with ``was`` now reads as cv2 reads it
    (None where cv2 gives None)."""
    build_tiff(tmp_path / "r.tif", "<", samples(kind), rps=16, **spec)
    got, want = _pairs(tmp_path / "r.tif")
    assert (want[0] is not None) == cv2_reads
    for g, w in zip(got, want):
        assert_same(g, w, was)


# --- the committed files -----------------------------------------------------

def committed_files():
    """name -> a function writing that file at ``path`` (the writer's
    layouts, and libtiff's own encoders through PIL)."""
    def writer(kind, **kw):
        return lambda path: build_tiff(path, "<", samples(kind), **kw)

    def pil(mode, **options):
        return lambda path: _pil_file(path, mode, options)
    return {
        "tiff jpeg ycbcr420 strips": writer("smooth", compression=7,
                                            ycbcr=(2, 2), rps=16),
        "tiff jpeg ycbcr422 tiles": writer("smooth", compression=7,
                                           ycbcr=(2, 1), tile=(16, 32)),
        "tiff jpeg ycbcr444 pil": pil("YCbCr", compression="jpeg"),
        "tiff jpeg rgb pil": pil("RGB", compression="jpeg"),
        "tiff jpeg gray pil": pil("L", compression="jpeg"),
        "tiff ycbcr22 lzw": writer("u1", ycbcr=(2, 2), compression=5,
                                   rps=16),
        "tiff bilevel deflate": writer("b1", bits=1, compression=8, rps=16,
                                       extra_tags=[WHITE]),
        "tiff ccitt rle pil": pil("1", compression="tiff_ccitt"),
        "tiff ccitt g3 1d": writer("bilevel", bits=1, compression=3,
                                   rps=16, extra_tags=[WHITE]),
        "tiff ccitt g3 2d pil": pil("1", compression="group3",
                                    tiffinfo={292: 1}),
        "tiff ccitt g4 pil": pil("1", compression="group4"),
        "tiff gray of 3 u16": writer("u2x3", extra_tags=[BLACK], rps=16),
        "tiff signed 12-bit": writer("b12", bits=12, fmt=2, rps=16),
        "tiff palette without colormap": writer("u1x1", rps=16,
                                                extra_tags=[PALETTE]),
    }


def load_cv2_arrays(path: Path):
    """The committed cv2 arrays of ``path``: [IMREAD_UNCHANGED,
    IMREAD_COLOR], None where cv2 gave None."""
    with np.load(path.with_suffix(".cv2.npz")) as z:
        return [z[k] if k in z.files else None for k in ("unchanged",
                                                         "color")]


@pytest.mark.parametrize("name", list(committed_files()))
def test_committed_files_equal_their_cv2_arrays(name):
    path = DATA / f"{name}.tif"
    want = load_cv2_arrays(path)
    got, theirs = _pairs(path)
    for g, t, w in zip(got, theirs, want):
        assert_same(t, w, f"cv2 on {name}")
        assert_same(g, w, name)


def write_committed_files(directory: Path = DATA) -> None:
    for name, write in committed_files().items():
        path = directory / f"{name}.tif"
        write(path)
        arrays = {k: a for k, a in zip(
            ("unchanged", "color"), (cv2.imread(str(path), f) for f in (
                cv2.IMREAD_UNCHANGED, cv2.IMREAD_COLOR))) if a is not None}
        np.savez_compressed(path.with_suffix(".cv2.npz"), **arrays)


if __name__ == "__main__":
    write_committed_files()
