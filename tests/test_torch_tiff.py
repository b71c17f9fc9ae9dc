"""The port's TIFF codec (utils/tiff.py, native/tiff.cpp) against OpenCV.

* The reader returns what ``cv2.imread`` returns, bit for bit, under
  IMREAD_UNCHANGED and IMREAD_COLOR, on files cv2 writes (u8 with 1/3/4
  channels, u16 with 1/3/4, f32 and f64; cv2's default, none, LZW and
  Deflate) and on files built here with ``struct`` (big-endian, many
  strips, tiles).
* IMREAD_COLOR's conversions: gray u16 as ``v >> 8``, RGB u16 as
  ``round(v / 257)``, gray repeated, alpha dropped, None for floats.
* cv2 reads the port's files back to the arrays written, and the LZW
  strips the port writes are libtiff's byte for byte.
* The native LZW and predictors equal the plain versions
  (native/tiff_plain.py); unsupported tags raise, naming the tag.
"""
import struct
import zlib

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from camera_linearity_tpu_torch import native  # noqa: E402
from camera_linearity_tpu_torch.native import tiff_plain  # noqa: E402
from camera_linearity_tpu_torch.utils import tiff  # noqa: E402

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

def build_tiff(path, order, px, *, compression=1, predictor=1, rps=None,
               tile=None, extra_tags=(), fmt=None):
    """A one-IFD TIFF of (H, W, S) samples ``px`` (file channel order) in
    byte order ``order`` ("<" or ">"): strips of ``rps`` rows, or tiles of
    ``tile`` = (th, tw); the chunks LZW- (plain encoder) or
    Deflate-compressed after horizontal differencing when asked.
    ``extra_tags`` are (tag, type, values) entries added or replacing."""
    height, width, spp = px.shape
    size = px.dtype.itemsize
    if tile is None:
        rps = rps or height
        pieces = [px[r:r + rps] for r in range(0, height, rps)]
    else:
        th, tw = tile
        pad = np.zeros((-(-height // th) * th, -(-width // tw) * tw, spp),
                       px.dtype)
        pad[:height, :width] = px
        pieces = [pad[r:r + th, c:c + tw] for r in range(0, pad.shape[0], th)
                  for c in range(0, pad.shape[1], tw)]
    chunks = []
    for piece in pieces:
        rows = np.ascontiguousarray(piece).reshape(piece.shape[0], -1)
        if predictor == 2:
            rows = tiff_plain.predictor_apply(rows, spp)
        raw = rows.astype(rows.dtype.newbyteorder(order)).tobytes()
        if compression == 5:
            raw = tiff_plain.lzw_encode(raw)
        elif compression == 8:
            raw = zlib.compress(raw)
        chunks.append(raw)
    kind = 3 if px.dtype.kind == "f" else 1
    offsets, at = [], 8
    for c in chunks:
        offsets.append(at)
        at += len(c) + len(c) % 2
    tags = {256: (4, [width]), 257: (4, [height]), 258: (3, [8 * size] * spp),
            259: (3, [compression]), 262: (3, [1 if spp == 1 else 2]),
            277: (3, [spp]), 284: (3, [1]),
            339: (3, [fmt or kind] * spp)}
    if predictor != 1:
        tags[317] = (3, [predictor])
    if tile is None:
        tags.update({273: (4, offsets), 278: (4, [rps]),
                     279: (4, [len(c) for c in chunks])})
    else:
        tags.update({322: (3, [tile[1]]), 323: (3, [tile[0]]),
                     324: (4, offsets), 325: (4, [len(c) for c in chunks])})
    for tag, typ, values in extra_tags:
        tags[tag] = (typ, values)
    body = b"".join(c + b"\0" * (len(c) % 2) for c in chunks)
    extra, entries = bytearray(), []
    ifd_at = at
    values_at = ifd_at + 2 + 12 * len(tags) + 4
    for tag in sorted(tags):
        typ, values = tags[tag]
        raw = struct.pack(f"{order}{len(values)}{'H' if typ == 3 else 'I'}",
                          *values)
        if len(raw) <= 4:
            field = raw.ljust(4, b"\0")
        else:
            field = struct.pack(order + "I", values_at + len(extra))
            extra += raw
        entries.append(struct.pack(order + "HHI", tag, typ, len(values))
                       + field)
    magic = b"II" if order == "<" else b"MM"
    with open(path, "wb") as f:
        f.write(magic + struct.pack(order + "HI", 42, ifd_at) + body
                + struct.pack(order + "H", len(tags)) + b"".join(entries)
                + struct.pack(order + "I", 0) + bytes(extra))


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


BAD_TAGS = [
    ("Compression=7", dict(extra_tags=[(259, 3, [7])])),
    ("PlanarConfiguration=2", dict(extra_tags=[(284, 3, [2])])),
    ("SampleFormat=2", dict(fmt=2)),
    ("BitsPerSample=[8, 8, 12]", dict(extra_tags=[(258, 3, [8, 8, 12])])),
    ("PhotometricInterpretation=0", dict(extra_tags=[(262, 3, [0])])),
    ("Orientation=3", dict(extra_tags=[(274, 3, [3])])),
    ("FillOrder=2", dict(extra_tags=[(266, 3, [2])])),
    ("Predictor=3", dict(extra_tags=[(317, 3, [3])])),
    ("SamplesPerPixel=2", dict(extra_tags=[(277, 3, [2])])),
    ("RowsPerStrip=0", dict(extra_tags=[(278, 4, [0])])),
    ("an image of 53 x 0", dict(extra_tags=[(257, 4, [0])])),
]


@pytest.mark.parametrize("message,spec", BAD_TAGS,
                         ids=[m for m, _ in BAD_TAGS])
def test_unsupported_tags_raise(tmp_path, message, spec):
    px = make_array("u8", 3, seed=6)
    build_tiff(tmp_path / "bad.tif", "<", px, **spec)
    for flags in (tiff.IMREAD_UNCHANGED, tiff.IMREAD_COLOR):
        with pytest.raises(ValueError, match=message.replace(
                "[", r"\[").replace("]", r"\]")):
            tiff.imread(tmp_path / "bad.tif", flags)


def test_unassociated_alpha_raises_under_color(tmp_path):
    px = make_array("u8", 4, seed=7)
    build_tiff(tmp_path / "a.tif", "<", px, extra_tags=[(338, 3, [2])])
    np.testing.assert_array_equal(
        tiff.imread(tmp_path / "a.tif", tiff.IMREAD_UNCHANGED),
        px[..., [2, 1, 0, 3]])
    with pytest.raises(ValueError, match="ExtraSamples"):
        tiff.imread(tmp_path / "a.tif", tiff.IMREAD_COLOR)


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
