"""The port's TIFF codec (utils/tiff.py, native/tiff.cpp) against OpenCV.

* The reader returns what ``cv2.imread`` returns, bit for bit, under
  IMREAD_UNCHANGED and IMREAD_COLOR, on files cv2 writes (u8 with 1/3/4
  channels, u16 with 1/3/4, f32 and f64; cv2's default, none, LZW and
  Deflate), on files PIL writes (PackBits, palette, CMYK, gray + alpha,
  BigTIFF) and on files built with ``tests/_torch_tiff_writer.py``
  (both byte orders, strips and tiles, BigTIFF, PackBits, Deflate 32946,
  planar, signed and 32/64-bit integers, packed 10/12/14-bit samples,
  MinIsWhite, palettes, CMYK, gray + alpha, unassociated alpha,
  Orientation 1-8, FillOrder 2), including cv2's Nones.  One exception:
  cv2 reads planar samples wider than 8 bits under IMREAD_UNCHANGED as if
  they were chunky; the port gives the stored image there.
* IMREAD_COLOR's conversions: gray u16 as ``v >> 8``, RGB u16 as
  ``round(v / 257)``, gray repeated, alpha dropped, None for floats.
* cv2 reads the port's files back to the arrays written, and the LZW
  strips the port writes are libtiff's byte for byte.
* The native LZW, PackBits and predictors equal the plain versions
  (native/tiff_plain.py); refused layouts raise before any decode, naming
  the tag.
"""
import struct

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from camera_linearity_tpu_torch import native  # noqa: E402
from camera_linearity_tpu_torch.native import tiff_plain  # noqa: E402
from camera_linearity_tpu_torch.utils import tiff  # noqa: E402
from tests._torch_tiff_writer import (build_tiff, layout_cases,  # noqa
                                      packbits_encode)

KINDS = [("u8", 1), ("u8", 3), ("u8", 4), ("u16", 1), ("u16", 3),
         ("u16", 4), ("f32", 1), ("f32", 3), ("f64", 1), ("f64", 3)]
COMPRESSIONS = [None, 1, 5, 8]   # cv2's default, none, LZW, Deflate


def make_array(kind, channels, shape=(37, 53), seed=0):
    rng = np.random.default_rng(seed)
    shape = shape if channels == 1 else (*shape, channels)
    if kind.startswith("u"):
        dt = np.uint8 if kind == "u8" else np.uint16
        return rng.integers(0, np.iinfo(dt).max, shape, dt, endpoint=True)
    return rng.random(shape).astype(np.float32 if kind == "f32"
                                    else np.float64)


def assert_same(got, want):
    if want is None:
        assert got is None
        return
    assert got is not None and got.dtype == want.dtype
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("compression", COMPRESSIONS)
@pytest.mark.parametrize("kind,channels", KINDS)
def test_reader_equals_cv2(tmp_path, kind, channels, compression):
    arr = make_array(kind, channels, shape=(70, 150))  # several strips
    path = str(tmp_path / "x.tif")
    params = [] if compression is None else \
        [cv2.IMWRITE_TIFF_COMPRESSION, compression]
    assert cv2.imwrite(path, arr, params)
    for flags in (cv2.IMREAD_UNCHANGED, cv2.IMREAD_COLOR):
        assert_same(tiff.imread(path, flags), cv2.imread(path, flags))


@pytest.mark.parametrize("kind,channels", KINDS)
def test_cv2_reads_the_ports_files(tmp_path, kind, channels):
    arr = make_array(kind, channels, shape=(300, 40), seed=1)
    path = str(tmp_path / "y.tif")
    tiff.imwrite(path, arr)
    assert_same(cv2.imread(path, cv2.IMREAD_UNCHANGED), arr)
    for flags in (cv2.IMREAD_UNCHANGED, cv2.IMREAD_COLOR):
        assert_same(tiff.imread(path, flags), cv2.imread(path, flags))


def test_written_strips_are_libtiffs(tmp_path):
    """uint8 and uint16 files: the same strips (LZW after predictor 2) as
    the ones libtiff writes under cv2."""
    for kind in ("u8", "u16"):
        arr = make_array(kind, 3, shape=(64, 333), seed=2)
        ours, theirs = tmp_path / "ours.tif", tmp_path / "theirs.tif"
        tiff.imwrite(ours, arr)
        cv2.imwrite(str(theirs), arr)
        strips = []
        for path in (ours, theirs):
            data = np.fromfile(path, np.uint8)
            ifd = tiff._Ifd(data, "<", struct.unpack("<I", data[4:8])[0])
            assert ifd.one(259) == 5 and ifd.one(317) == 2
            strips.append([data[o:o + c].tobytes() for o, c in
                           zip(ifd.get(273), ifd.get(279))])
        assert strips[0] == strips[1]


def test_imread_color_conversions(tmp_path):
    v = np.arange(65536, dtype=np.uint16).reshape(256, 256)
    gray, rgb = tmp_path / "gray.tif", tmp_path / "rgb.tif"
    tiff.imwrite(gray, v)
    bgr16 = np.stack([v, v[::-1], v.T], -1)
    tiff.imwrite(rgb, bgr16)
    got = tiff.imread(gray, tiff.IMREAD_COLOR)
    np.testing.assert_array_equal(got, np.repeat((v >> 8).astype(np.uint8)
                                                 [..., None], 3, axis=2))
    np.testing.assert_array_equal(
        tiff.imread(rgb, tiff.IMREAD_COLOR),
        np.round(bgr16 / 257).astype(np.uint8))
    for path in (gray, rgb):
        assert_same(tiff.imread(path, tiff.IMREAD_COLOR),
                    cv2.imread(str(path), cv2.IMREAD_COLOR))
    u8 = make_array("u8", 4, seed=3)
    tiff.imwrite(tmp_path / "bgra.tif", u8)
    np.testing.assert_array_equal(
        tiff.imread(tmp_path / "bgra.tif", tiff.IMREAD_COLOR), u8[..., :3])
    g8 = make_array("u8", 1, seed=4)
    tiff.imwrite(tmp_path / "g8.tif", g8)
    np.testing.assert_array_equal(
        tiff.imread(tmp_path / "g8.tif", tiff.IMREAD_COLOR),
        np.repeat(g8[..., None], 3, axis=2))
    for kind in ("f32", "f64"):
        tiff.imwrite(tmp_path / f"{kind}.tif", make_array(kind, 3))
        assert tiff.imread(tmp_path / f"{kind}.tif", tiff.IMREAD_COLOR) is None
        assert tiff.imread(tmp_path / f"{kind}.tif",
                           tiff.IMREAD_UNCHANGED) is not None


# --- files built with struct ---------------------------------------------

STRUCT_CASES = [
    ("<", "u8", 3, dict(compression=5, predictor=2, rps=7)),
    (">", "u8", 3, dict(compression=5, predictor=2, rps=7)),
    (">", "u16", 3, dict(compression=5, predictor=2, rps=5)),
    (">", "u16", 1, dict(compression=1, rps=9)),
    (">", "u16", 4, dict(compression=8, predictor=2, rps=16)),
    (">", "f32", 3, dict(compression=1, rps=3)),
    (">", "f64", 1, dict(compression=8, rps=11)),
    ("<", "u8", 3, dict(compression=5, predictor=2, tile=(16, 16))),
    (">", "u16", 3, dict(compression=5, predictor=2, tile=(16, 32))),
    (">", "f32", 3, dict(compression=1, tile=(32, 16))),
]


@pytest.mark.parametrize("order,kind,channels,layout", STRUCT_CASES)
def test_struct_built_files(tmp_path, order, kind, channels, layout):
    px = make_array(kind, channels, shape=(37, 53), seed=5)
    if px.ndim == 2:
        px = px[..., None]
    path = tmp_path / "s.tif"
    build_tiff(path, order, px, **layout)
    want = px[..., 0] if channels == 1 else px[..., [2, 1, 0, 3][:channels]]
    np.testing.assert_array_equal(tiff.imread(path, tiff.IMREAD_UNCHANGED),
                                  want)
    for flags in (cv2.IMREAD_UNCHANGED, cv2.IMREAD_COLOR):
        assert_same(tiff.imread(path, flags), cv2.imread(str(path), flags))


# --- the layouts read beyond cv2's own files -------------------------------

def _cv2_pair(path):
    return [cv2.imread(str(path), f) for f in (cv2.IMREAD_UNCHANGED,
                                               cv2.IMREAD_COLOR)]


def _port_pair(path):
    return [tiff.imread(path, f) for f in (tiff.IMREAD_UNCHANGED,
                                           tiff.IMREAD_COLOR)]


def _bgr(px):
    return px[..., 0] if px.shape[2] == 1 else \
        px[..., [2, 1, 0, 3][:px.shape[2]]]


def _draw(kind, channels, shape=(37, 53), seed=11):
    rng = np.random.default_rng(seed)
    shape = (*shape, channels)
    if kind.startswith("b"):  # packed unsigned samples of that many bits
        return rng.integers(0, 1 << int(kind[1:]), shape, np.uint16)
    dt = np.dtype(kind)
    if dt.kind == "f":
        return rng.random(shape).astype(dt)
    info = np.iinfo(dt)
    return rng.integers(info.min, info.max, shape, dt, endpoint=True)


WHITE, RGB, PALETTE, CMYK = ((262, 3, [k]) for k in (0, 2, 3, 5))
CMAP16 = np.random.default_rng(3).integers(0, 65536, 3 * 256).tolist()
CMAP8 = np.random.default_rng(4).integers(0, 256, 3 * 256).tolist()


def _palette(bits, cmap=CMAP16):
    n = 1 << bits
    c = np.asarray(cmap).reshape(3, -1)[:, :n].ravel().tolist()
    return [PALETTE, (320, 3, c)]


# name: (sample kind, samples per pixel, build_tiff keywords, planar wide
# samples: cv2 misreads them under IMREAD_UNCHANGED)
LAYOUTS = {
    "BigTIFF u8 RGB": ("u1", 3, dict(bigtiff=True), False),
    "BigTIFF u16 RGBA": ("u2", 4, dict(bigtiff=True), False),
    "BigTIFF f64 gray LZW": ("f8", 1, dict(bigtiff=True, compression=5),
                             False),
    "PackBits u8 RGB": ("u1", 3, dict(compression=32773), False),
    "PackBits u16 gray": ("u2", 1, dict(compression=32773), False),
    "PackBits f32 RGB": ("f4", 3, dict(compression=32773), False),
    "Deflate 32946 u8 RGB": ("u1", 3, dict(compression=32946, predictor=2),
                             False),
    "Deflate 32946 u16 gray": ("u2", 1, dict(compression=32946), False),
    "planar u8 RGB LZW": ("u1", 3, dict(planar=True, compression=5,
                                        predictor=2), False),
    "planar u8 RGBA": ("u1", 4, dict(planar=True), False),
    "planar u8 RGB PackBits": ("u1", 3, dict(planar=True,
                                             compression=32773), False),
    "planar u16 RGB Deflate": ("u2", 3, dict(planar=True, compression=8,
                                             predictor=2), True),
    "planar u16 RGBA": ("u2", 4, dict(planar=True), True),
    "planar f32 RGB": ("f4", 3, dict(planar=True), True),
    "planar f64 RGB": ("f8", 3, dict(planar=True), True),
    "planar i16 RGB": ("i2", 3, dict(planar=True), True),
    "planar 12-bit RGB": ("b12", 3, dict(planar=True, bits=12), True),
    "int8 gray": ("i1", 1, {}, False),
    "int8 RGB": ("i1", 3, {}, False),
    "int8 RGBA unassociated": ("i1", 4, dict(extra_tags=[(338, 3, [2])]),
                               False),
    "int16 gray predictor": ("i2", 1, dict(compression=5, predictor=2),
                             False),
    "int16 RGB": ("i2", 3, {}, False),
    "int32 gray predictor": ("i4", 1, dict(compression=8, predictor=2),
                             False),
    "int32 RGB": ("i4", 3, {}, False),
    "uint32 gray": ("u4", 1, {}, False),
    "uint32 RGB": ("u4", 3, dict(compression=32773), False),
    "uint64 gray": ("u8", 1, {}, False),
    "int64 gray predictor": ("i8", 1, dict(compression=8, predictor=2),
                             False),
    "f32 gray predictor 2": ("f4", 1, dict(compression=8, predictor=2),
                             False),
    "10-bit gray": ("b10", 1, dict(bits=10), False),
    "12-bit gray": ("b12", 1, dict(bits=12, compression=32773), False),
    "14-bit gray": ("b14", 1, dict(bits=14, compression=8), False),
    "12-bit RGB": ("b12", 3, dict(bits=12), False),
    "12-bit RGBA": ("b12", 4, dict(bits=12), False),
    "MinIsWhite u8": ("u1", 1, dict(extra_tags=[WHITE]), False),
    "MinIsWhite u16": ("u2", 1, dict(extra_tags=[WHITE]), False),
    "MinIsWhite int8": ("i1", 1, dict(extra_tags=[WHITE]), False),
    "MinIsWhite int16": ("i2", 1, dict(extra_tags=[WHITE]), False),
    "MinIsWhite 12-bit": ("b12", 1, dict(bits=12, extra_tags=[WHITE]),
                          False),
    "MinIsWhite f32": ("f4", 1, dict(extra_tags=[WHITE]), False),
    "MinIsWhite gray+alpha u8": ("u1", 2, dict(extra_tags=[WHITE]), False),
    "gray+alpha u8": ("u1", 2, {}, False),
    "gray+alpha u8 unassociated": ("u1", 2, dict(extra_tags=[(338, 3, [2])]),
                                   False),
    "gray+alpha u8 planar": ("u1", 2, dict(planar=True), False),
    "gray+alpha u16": ("u2", 2, dict(extra_tags=[(338, 3, [1])]), False),
    "gray+alpha int16": ("i2", 2, {}, False),
    "gray+alpha 12-bit": ("b12", 2, dict(bits=12), False),
    "gray+alpha f32": ("f4", 2, {}, False),
    "RGB of 2 samples u8": ("u1", 2, dict(extra_tags=[RGB, (338, 3, [2])]),
                            False),
    "RGB of 2 samples u16": ("u2", 2, dict(extra_tags=[RGB]), False),
    "RGB of 1 sample u8": ("u1", 1, dict(extra_tags=[RGB]), False),
    "RGB of 1 sample u16": ("u2", 1, dict(extra_tags=[RGB]), False),
    "RGBA u8 unassociated": ("u1", 4, dict(extra_tags=[(338, 3, [2])]),
                             False),
    "RGBA u8 associated": ("u1", 4, dict(extra_tags=[(338, 3, [1])]),
                           False),
    "RGBA u8 unspecified": ("u1", 4, dict(extra_tags=[(338, 3, [0])]),
                            False),
    "RGBA u16 unassociated": ("u2", 4, dict(extra_tags=[(338, 3, [2])]),
                              False),
    "RGBA u8 planar unassociated": ("u1", 4, dict(
        planar=True, extra_tags=[(338, 3, [2])]), False),
    "palette 8-bit": ("u1", 1, dict(extra_tags=_palette(8)), False),
    "palette 8-bit, 8-bit colormap": ("u1", 1, dict(
        extra_tags=_palette(8, CMAP8)), False),
    "palette int8": ("i1", 1, dict(extra_tags=_palette(8)), False),
    "palette 8-bit + alpha": ("u1", 2, dict(extra_tags=_palette(8)), False),
    "palette 4-bit": ("b4", 1, dict(bits=4, extra_tags=_palette(4)), False),
    "palette 1-bit": ("b1", 1, dict(bits=1, extra_tags=_palette(1)), False),
    "CMYK u8": ("u1", 4, dict(extra_tags=[CMYK]), False),
    "CMYK u8 planar": ("u1", 4, dict(planar=True, extra_tags=[CMYK]),
                       False),
    "CMYK u8 InkSet 1": ("u1", 4, dict(extra_tags=[CMYK, (332, 3, [1])]),
                         False),
    "FillOrder 2 LZW": ("u1", 3, dict(fill_order=2, compression=5), False),
    "FillOrder 2 PackBits u16": ("u2", 3, dict(fill_order=2,
                                               compression=32773), False),
    "FillOrder 2 Deflate": ("u1", 3, dict(fill_order=2, compression=8),
                            False),
}


def _layout_files(tmp_path, name, order, chunks):
    kind, spp, kw, planar_wide = LAYOUTS[name]
    px = _draw(kind, spp)
    path = tmp_path / "l.tif"
    build_tiff(path, order, px, **kw, **chunks)
    return px, path, planar_wide


@pytest.mark.parametrize("chunks", [dict(rps=5), dict(tile=(16, 32))],
                         ids=["strips", "tiles"])
@pytest.mark.parametrize("order", ["<", ">"], ids=["II", "MM"])
@pytest.mark.parametrize("name", list(LAYOUTS))
def test_layouts_equal_cv2(tmp_path, name, order, chunks):
    px, path, planar_wide = _layout_files(tmp_path, name, order, chunks)
    got, want = _port_pair(path), _cv2_pair(path)
    if planar_wide:  # cv2 reads the planes as if chunky: the stored image
        want[0] = _bgr(px << 4 if "12-bit" in name else px)
    for g, w in zip(got, want):
        assert_same(g, w)


@pytest.mark.parametrize("kind,spp", [("u1", 3), ("u2", 1), ("f4", 3),
                                      ("b12", 1)])
def test_fill_order_2_uncompressed_strips(tmp_path, kind, spp):
    """Uncompressed FillOrder 2 (its tiles are refused: cv2 gives None
    for some tile sizes and not for others)."""
    px = _draw(kind, spp)
    build_tiff(tmp_path / "f.tif", ">", px, fill_order=2, rps=5,
               bits=12 if kind == "b12" else None)
    for g, w in zip(_port_pair(tmp_path / "f.tif"),
                    _cv2_pair(tmp_path / "f.tif")):
        assert_same(g, w)


@pytest.mark.parametrize("shape", [(37, 53), (40, 40)], ids=["37x53",
                                                            "40x40"])
@pytest.mark.parametrize("chunks", [dict(rps=5), dict(tile=(16, 16))],
                         ids=["strips", "tiles"])
@pytest.mark.parametrize("kind", ["u1", "u2", "f4"])
@pytest.mark.parametrize("orientation", range(1, 9))
def test_orientation_equals_cv2(tmp_path, orientation, kind, chunks, shape):
    px = _draw(kind, 3, shape)
    path = tmp_path / "o.tif"
    build_tiff(path, "<", px, extra_tags=[(274, 3, [orientation])],
               **chunks)
    for g, w in zip(_port_pair(path), _cv2_pair(path)):
        assert_same(g, w)


@pytest.mark.parametrize("height,width", [(37, 53), (40, 40)])
@pytest.mark.parametrize("case", [c[0] for c in layout_cases(8, 8)])
def test_layout_table_is_cv2s(tmp_path, case, height, width):
    """The formulas ``chip_smoke.py`` holds the port to on the card are
    what cv2 returns (bar its planar misread) and what the port returns."""
    name, px, kw, want_u, want_c = next(c for c in layout_cases(height,
                                                                width)
                                        if c[0] == case)
    path = tmp_path / "t.tif"
    build_tiff(path, "<", px, **kw)
    got, theirs = _port_pair(path), _cv2_pair(path)
    assert_same(got[0], want_u)
    assert_same(got[1], want_c)
    if "planar" not in name or px.dtype.itemsize == 1:
        assert_same(theirs[0], want_u)
    assert_same(theirs[1], want_c)


PIL_CASES = [("RGB", dict(compression="packbits")),
             ("L", dict(compression="packbits")),
             ("I;16", dict(compression="packbits")),
             ("P", {}), ("P", dict(compression="packbits")), ("PA", {}),
             ("CMYK", {}), ("CMYK", dict(compression="packbits")),
             ("LA", {}), ("RGB", dict(big_tiff=True)),
             ("I;16", dict(big_tiff=True)), ("RGBA", dict(big_tiff=True))]


@pytest.mark.parametrize("mode,options", PIL_CASES,
                         ids=[f"{m}-{'-'.join(o) or 'plain'}"
                              for m, o in PIL_CASES])
def test_pil_files_equal_cv2(tmp_path, mode, options):
    Image = pytest.importorskip("PIL.Image")
    rng = np.random.default_rng(12)
    if mode == "I;16":
        im = Image.fromarray(rng.integers(0, 65536, (37, 53), np.uint16))
    else:
        im = Image.fromarray(rng.integers(0, 256, (37, 53, 3), np.uint8)
                             ).convert(mode)
    path = tmp_path / "pil.tif"
    im.save(path, **options)
    for g, w in zip(_port_pair(path), _cv2_pair(path)):
        assert w is not None
        assert_same(g, w)


READ_NOW = [  # refused by the port until the layouts above were added
    ("PlanarConfiguration=2", dict(planar=True)),
    ("SampleFormat=2", dict(fmt=2)),
    ("PhotometricInterpretation=0", dict(extra_tags=[WHITE])),
    ("Orientation=3", dict(extra_tags=[(274, 3, [3])])),
    ("FillOrder=2", dict(fill_order=2)),
    ("SamplesPerPixel=2", dict(extra_tags=[RGB])),
]


@pytest.mark.parametrize("was,spec", READ_NOW, ids=[m for m, _ in READ_NOW])
def test_formerly_refused_tags_read(tmp_path, was, spec):
    """What the reader refused with ``was`` reads as cv2 reads it (None
    for RGB of 2 samples, as cv2 gives)."""
    px = make_array("u8", 2 if was.startswith("Samples") else
                    1 if "Photometric" in was else 3, seed=6)
    build_tiff(tmp_path / "r.tif", "<", px, **spec)
    want = _cv2_pair(tmp_path / "r.tif")
    assert (want[0] is None) == was.startswith("Samples")
    for g, w in zip(_port_pair(tmp_path / "r.tif"), want):
        assert_same(g, w)


# message, (sample kind, samples per pixel), build_tiff keywords, does cv2
# read it (the rest cv2 itself refuses: None under both flags).  The rows
# for Compression=7, PhotometricInterpretation=6, BitsPerSample=1 and 4,
# signed 12-bit, gray of 3 samples and a missing ColorMap read now and
# moved to tests/test_torch_tiff_jpeg.py's READ_NOW.
YCBCR = (262, 3, [6])
BAD_TAGS = [
    ("Compression=6", ("u1", 3), dict(extra_tags=[(259, 3, [6])]), False),
    ("Compression=3", ("u1", 1), dict(extra_tags=[(259, 3, [3])]), False),
    ("Compression=34925", ("u1", 3), dict(extra_tags=[(259, 3, [34925])]),
     False),
    ("Compression=50000", ("u1", 3), dict(extra_tags=[(259, 3, [50000])]),
     False),
    ("Compression=50001", ("u1", 3), dict(extra_tags=[(259, 3, [50001])]),
     False),
    ("PhotometricInterpretation=8", ("u1", 3), dict(extra_tags=[
        (262, 3, [8])]), True),
    ("PhotometricInterpretation=9", ("u1", 3), dict(extra_tags=[
        (262, 3, [9])]), False),
    ("PhotometricInterpretation=10", ("u1", 3), dict(extra_tags=[
        (262, 3, [10])]), False),
    ("Compression=34712", ("u1", 3), dict(extra_tags=[(259, 3, [34712])]),
     True),
    ("Compression=7 with 4 8-bit samples", ("u1", 4),
     dict(extra_tags=[(259, 3, [7]), CMYK]), False),
    ("Compression=7 with 3 8-bit samples, PhotometricInterpretation=2, "
     "PlanarConfiguration=2", ("u1", 3),
     dict(planar=True, extra_tags=[(259, 3, [7])]), False),
    ("Compression=7 with 1 16-bit samples", ("u2", 1),
     dict(extra_tags=[(259, 3, [7])]), False),
    ("Compression=4 with 3 samples of 8 bits", ("u1", 3),
     dict(extra_tags=[(259, 3, [4])]), False),
    ("T4Options=2", ("b1", 1), dict(bits=1, extra_tags=[(259, 3, [3]),
                                                        (292, 4, [2])]),
     True),
    ("YCbCrSubSampling=\\[3, 1\\]", ("u1", 3),
     dict(extra_tags=[YCBCR, (530, 3, [3, 1])]), False),
    ("Predictor=2 with YCbCrSubSampling=\\[2, 2\\]", ("u1", 3),
     dict(compression=5, predictor=2, extra_tags=[YCBCR]), True),
    ("RowsPerStrip=5 with YCbCrSubSampling=\\[2, 2\\]", ("u1", 3),
     dict(rps=5, extra_tags=[YCBCR]), True),
    ("YCbCrSubSampling=\\[4, 4\\] in tiles", ("u1", 3),
     dict(tile=(16, 16), extra_tags=[YCBCR, (530, 3, [4, 4])]), False),
    ("PhotometricInterpretation=6 with 3 16-bit", ("u2", 3),
     dict(extra_tags=[YCBCR]), False),
    ("PhotometricInterpretation=4", ("u1", 1), dict(extra_tags=[
        (262, 3, [4])]), False),
    ("BitsPerSample=2 with PhotometricInterpretation=3", ("b2", 1),
     dict(bits=2, extra_tags=_palette(2)), False),
    ("BitsPerSample=16 with PhotometricInterpretation=3", ("u2", 1),
     dict(extra_tags=[PALETTE, (320, 3, [7] * (3 << 16))]), False),
    ("BitsPerSample=16 with SampleFormat=3", ("f2", 1), {}, False),
    ("BitsPerSample=12 with SampleFormat=2 and SamplesPerPixel=3",
     ("b12", 3), dict(bits=12, fmt=2), True),
    ("BitsPerSample=\\[8, 8, 12\\]", ("u1", 3),
     dict(extra_tags=[(258, 3, [8, 8, 12])]), False),
    ("SampleFormat=\\[1, 1, 2\\]", ("u1", 3),
     dict(extra_tags=[(339, 3, [1, 1, 2])]), False),
    ("PhotometricInterpretation=5 with SamplesPerPixel=4, BitsPerSample=16",
     ("u2", 4), dict(extra_tags=[CMYK]), False),
    ("PhotometricInterpretation=5 with SamplesPerPixel=3", ("u1", 3),
     dict(extra_tags=[CMYK]), False),
    ("SamplesPerPixel=5", ("u1", 5), {}, False),
    ("SamplesPerPixel=3 with PhotometricInterpretation=1 and 32-bit",
     ("u4", 3), dict(extra_tags=[(262, 3, [1])]), True),
    ("SamplesPerPixel=2 with PhotometricInterpretation=3", ("b4", 2),
     dict(bits=4, extra_tags=_palette(4)), False),
    ("Predictor=3 with 8-bit SampleFormat=1", ("u1", 3),
     dict(compression=8, extra_tags=[(317, 3, [3])]), False),
    ("Predictor=2 with 12-bit", ("b12", 1),
     dict(bits=12, compression=8, extra_tags=[(317, 3, [2])]), False),
    ("ColorMap=missing, with 1 8-bit SampleFormat=2", ("i1", 1),
     dict(extra_tags=[PALETTE]), True),
    ("FillOrder=2 with uncompressed tiles", ("u1", 3),
     dict(fill_order=2, tile=(16, 16)), False),
    ("Orientation=9", ("u1", 3), dict(extra_tags=[(274, 3, [9])]), None),
    ("FillOrder=3", ("u1", 3), dict(extra_tags=[(266, 3, [3])]), None),
    ("RowsPerStrip=0", ("u1", 3), dict(extra_tags=[(278, 4, [0])]), None),
    ("an image of 53 x 0", ("u1", 3), dict(extra_tags=[(257, 4, [0])]),
     None),
]


@pytest.mark.parametrize("message,sample,spec,cv2_reads", BAD_TAGS,
                         ids=[m.replace("\\", "") for m, *_ in BAD_TAGS])
def test_unsupported_tags_raise(tmp_path, message, sample, spec, cv2_reads):
    """Each layout that stays refused raises before any decode (the
    chunks are cut to nothing, so a decode would fail otherwise), naming
    its tag and value; cv2 refuses those marked so too."""
    px = _draw(*sample, seed=6)
    build_tiff(tmp_path / "bad.tif", "<", px, **spec)
    if cv2_reads is not None:
        assert (_cv2_pair(tmp_path / "bad.tif")[0] is not None) == cv2_reads
    data = bytearray((tmp_path / "bad.tif").read_bytes())
    ifd = tiff._Ifd(np.frombuffer(bytes(data), np.uint8), "<",
                    struct.unpack("<I", data[4:8])[0])
    for at in ifd.get(273, ifd.get(324, np.array([], np.int64))).tolist():
        data[at:at + 4] = b"\xff\xfe\xfd\xfc"   # corrupt every chunk
    (tmp_path / "bad.tif").write_bytes(bytes(data))
    for flags in (tiff.IMREAD_UNCHANGED, tiff.IMREAD_COLOR):
        with pytest.raises(ValueError, match=message):
            tiff.imread(tmp_path / "bad.tif", flags)


def test_unassociated_alpha_raises_under_color(tmp_path):
    """Unassociated alpha no longer raises under IMREAD_COLOR: 8-bit RGBA
    goes through libtiff's RGBA reader under both flags, which
    premultiplies the colour by the alpha, as cv2 gives."""
    px = make_array("u8", 4, seed=7)
    build_tiff(tmp_path / "a.tif", "<", px, extra_tags=[(338, 3, [2])])
    a = px[..., 3:].astype(np.uint32)
    pre = ((px[..., :3] * a + 127) // 255).astype(np.uint8)
    want = np.concatenate([pre[..., ::-1], px[..., 3:]], axis=2)
    got = _port_pair(tmp_path / "a.tif")
    np.testing.assert_array_equal(got[0], want)
    np.testing.assert_array_equal(got[1], want[..., :3])
    for g, w in zip(got, _cv2_pair(tmp_path / "a.tif")):
        assert_same(g, w)


def test_truncated_chunks_raise_naming_the_chunk(tmp_path):
    px = make_array("u8", 3, seed=8)
    for compression, name in ((32773, "PackBits"), (5, "LZW")):
        build_tiff(tmp_path / "t.tif", "<", px, compression=compression,
                   rps=9)
        data = np.fromfile(tmp_path / "t.tif", np.uint8)
        ifd = tiff._Ifd(data, "<", struct.unpack("<I", data[4:8])[0])
        counts = ifd.get(279).copy()
        counts[2] //= 2  # the third strip loses half its bytes
        build_tiff(tmp_path / "t.tif", "<", px, compression=compression,
                   rps=9, extra_tags=[(279, 4, counts.tolist())])
        with pytest.raises(ValueError, match=f"{name} chunk 2 decodes to"):
            tiff.imread(tmp_path / "t.tif", tiff.IMREAD_UNCHANGED)


def test_imwrite_leaves_its_input_alone(tmp_path):
    for channels in (1, 3):
        arr = make_array("u16", channels, seed=9)
        before = arr.copy()
        tiff.imwrite(tmp_path / "w.tif", arr)
        np.testing.assert_array_equal(arr, before)


def test_missing_and_foreign_files(tmp_path):
    assert tiff.imread(tmp_path / "none.tif") is None
    (tmp_path / "png.tif").write_bytes(b"\x89PNG\r\n\x1a\n" + b"\0" * 32)
    with pytest.raises(ValueError, match="not a TIFF"):
        tiff.imread(tmp_path / "png.tif")
    (tmp_path / "big.tif").write_bytes(b"II+\0" + b"\0" * 32)
    with pytest.raises(ValueError, match="BigTIFF"):
        tiff.imread(tmp_path / "big.tif")
    with pytest.raises(ValueError, match="flags"):
        tiff.imread(tmp_path / "none.tif", 0)
    with pytest.raises(ValueError, match="dtype"):
        tiff.imwrite(tmp_path / "i.tif", np.zeros((4, 4), np.int32))


# --- native against plain --------------------------------------------------

@pytest.mark.parametrize("n", [0, 1, 2, 257, 5000, 40000])
@pytest.mark.parametrize("content", ["noise", "ramp", "zeros"])
def test_native_lzw_equals_plain(n, content):
    rng = np.random.default_rng(n)
    data = {"noise": rng.integers(0, 256, n, np.uint8),
            "ramp": (np.arange(n) // 7 % 256).astype(np.uint8),
            "zeros": np.zeros(n, np.uint8)}[content]
    plain = tiff_plain.lzw_encode(data.tobytes())
    assert tiff_plain.lzw_decode(plain) == data.tobytes()
    (ours,) = native.lzw_encode_chunks(data, [0], [n])
    assert ours.tobytes() == plain
    out = np.empty(n, np.uint8)
    got = native.lzw_decode_chunks(ours, [0], [ours.size], out, [0], [n])
    assert int(got[0]) == n
    np.testing.assert_array_equal(out, data)


def test_native_lzw_batches_and_errors():
    rng = np.random.default_rng(8)
    parts = [rng.integers(0, 9, k, np.uint8) for k in (100, 3000, 1)]
    src = np.concatenate(parts)
    sizes = [p.size for p in parts]
    starts = np.cumsum([0] + sizes[:-1])
    enc = native.lzw_encode_chunks(src, starts, sizes)
    assert [e.tobytes() for e in enc] == [tiff_plain.lzw_encode(p.tobytes())
                                          for p in parts]
    packed = np.concatenate(enc)
    at = np.cumsum([0] + [e.size for e in enc[:-1]])
    out = np.zeros(src.size, np.uint8)
    native.lzw_decode_chunks(packed, at, [e.size for e in enc], out, starts,
                             sizes)
    np.testing.assert_array_equal(out, src)
    with pytest.raises(ValueError, match="more than"):
        native.lzw_decode_chunks(packed, at[:1], [enc[0].size], out[:50], [0],
                                 [50])
    with pytest.raises(ValueError, match="outside the file"):
        native.lzw_decode_chunks(packed, [packed.size], [4], out, [0], [10])
    with pytest.raises(ValueError, match="corrupt"):
        # a first code above 255 after the Clear
        bad = np.frombuffer(bytes([0x80, 0x7F, 0xFF, 0xFF]), np.uint8)
        native.lzw_decode_chunks(bad, [0], [4], out, [0], [10])


@pytest.mark.parametrize("size,spp,swap", [(1, 1, False), (1, 3, False),
                                           (2, 1, False), (2, 3, True),
                                           (2, 4, False)])
def test_native_horizontal_predictor_equals_plain(size, spp, swap):
    rng = np.random.default_rng(size * 10 + spp)
    dt = np.uint8 if size == 1 else np.uint16
    px = rng.integers(0, np.iinfo(dt).max, (9, 13 * spp), dt, endpoint=True)
    diffed = tiff_plain.predictor_apply(px, spp)
    buf = px.copy().reshape(-1).view(np.uint8)
    native.predictor_apply(buf, 9, 13 * spp, spp, size)
    np.testing.assert_array_equal(buf.view(dt).reshape(px.shape), diffed)
    order = ">" if swap else "<"
    file_bytes = diffed.astype(diffed.dtype.newbyteorder(order)).view(
        np.uint8).reshape(9, -1)
    plain = tiff_plain.predictor_undo(file_bytes, spp, size, 2, swap)
    np.testing.assert_array_equal(plain, px)
    buf = file_bytes.copy().reshape(-1)
    native.predictor_undo(buf, 9, 13 * spp, spp, size, 2, swap)
    np.testing.assert_array_equal(buf.view(dt).reshape(px.shape), px)


@pytest.mark.parametrize("size,spp", [(4, 1), (4, 3), (8, 3)])
def test_native_float_predictor_equals_plain(size, spp):
    """Predictor 3 on the rows libtiff writes (cv2's Deflate floats), and
    on bytes made here: native == plain."""
    rng = np.random.default_rng(size + spp)
    rows = rng.integers(0, 256, (7, 11 * spp * size), np.uint8)
    plain = tiff_plain.predictor_undo(rows, spp, size, 3)
    buf = rows.copy().reshape(-1)
    native.predictor_undo(buf, 7, 11 * spp, spp, size, 3, False)
    np.testing.assert_array_equal(buf.view(f"=f{size}").reshape(plain.shape)
                                  .view(np.uint8), plain.view(np.uint8))


PACKBITS_STREAMS = {
    "empty": (b"", 0),
    "literal of 1": (bytes([0, 7]), 1),
    "literal of 128": (bytes([127]) + bytes(range(128)), 128),
    "run of 2": (bytes([255, 9]), 2),
    "run of 128": (bytes([129, 9]), 128),
    "no-op bytes": (bytes([128, 1, 5, 6, 128, 254, 3, 128]), 5),
    "runs and literals": (bytes([2, 1, 2, 3, 253, 4, 0, 5, 129, 6]), 133),
    "longer than the room": (bytes([129, 9, 2, 1, 2, 3]), 100),
    "literal cut short": (bytes([1, 7, 4, 1, 2]), 10),
    "run cut short": (bytes([3, 1, 2, 3, 4, 250]), 10),
}


@pytest.mark.parametrize("name", list(PACKBITS_STREAMS))
def test_native_packbits_equals_plain(name):
    stream, room = PACKBITS_STREAMS[name]
    plain = tiff_plain.packbits_decode(stream, room)
    src = np.frombuffer(stream, np.uint8).copy()
    out = np.full(max(room, 1), 0xAA, np.uint8)
    (got,) = native.packbits_decode_chunks(src, [0], [src.size], out, [0],
                                           [room])
    assert int(got) == len(plain)
    assert out[:len(plain)].tobytes() == plain
    if "cut" in name:
        assert len(plain) < room


@pytest.mark.parametrize("n", [0, 1, 127, 128, 129, 5000])
@pytest.mark.parametrize("content", ["noise", "runs", "zeros"])
def test_packbits_round_trip(n, content):
    rng = np.random.default_rng(n)
    data = {"noise": rng.integers(0, 256, n, np.uint8),
            "runs": np.repeat(rng.integers(0, 3, n), rng.integers(
                1, 300, n))[:n].astype(np.uint8),
            "zeros": np.zeros(n, np.uint8)}[content]
    stream = packbits_encode(data.tobytes())
    assert tiff_plain.packbits_decode(stream, n) == data.tobytes()
    parts = np.frombuffer(stream * 2, np.uint8).copy()
    out = np.zeros(2 * n, np.uint8)
    got = native.packbits_decode_chunks(parts, [0, len(stream)],
                                        [len(stream)] * 2, out, [0, n],
                                        [n, n])
    assert got.tolist() == [n, n]
    np.testing.assert_array_equal(out, np.tile(data, 2))
    with pytest.raises(ValueError, match="PackBits chunk [01] lies outside"):
        native.packbits_decode_chunks(parts, [0, parts.size], [1, 4], out,
                                      [0, n], [n, n])


@pytest.mark.parametrize("size", [4, 8])
def test_native_wide_horizontal_predictor_equals_plain(size):
    rng = np.random.default_rng(size)
    dt = np.dtype(f"u{size}")
    px = rng.integers(0, np.iinfo(dt).max, (5, 21), dt, endpoint=True)
    diffed = tiff_plain.predictor_apply(px, 3)
    file_bytes = diffed.astype(dt.newbyteorder(">")).view(np.uint8).reshape(
        5, -1)
    np.testing.assert_array_equal(
        tiff_plain.predictor_undo(file_bytes, 3, size, 2, True), px)
    buf = file_bytes.copy().reshape(-1)
    native.predictor_undo(buf, 5, 21, 3, size, 2, True)
    np.testing.assert_array_equal(buf.view(dt).reshape(px.shape), px)
