"""TIFF (C7, TIFF parts 1, 2a and 2b): classic TIFF and BigTIFF, the first
IFD, strips or tiles of gray (1, 2, 4, 8, 16 bits, MINISBLACK or
MINISWHITE), RGB (8, 16 bits) or palette (1, 2, 4, 8 bits) samples with any
extra samples, CMYK (8 bits), YCbCr (8 bits, every subsampling libtiff's
RGBA reader puts) or CIELAB (8, 16 bits), either planar configuration and
fill order, uncompressed, PackBits, LZW (old-style codes too), deflate or
JPEG, with or without the horizontal predictor, or a compression that
names no codec (zeros), read by the port as the reference reads it
(cv2.imread, else PIL's convert("RGB")), against cv2, PIL and tsr_tpu on
the CPU:

- every TIFF fixture of tests/data/images (Pillow's and cv2's writers, and
  files built by image_writers.tiff_file: big endian, the IFD first, an
  8-bit ColorMap, old-style LZW, orientation 3, no StripByteCounts, an LZW
  strip that breaks off; the part 2a and 2b layouts) decodes equal to
  cv2.imread, max diff 0;
- orientations 1-8: cv2 flips 2-4 and gives None for 5-8 but of a square
  image, which it transposes; PIL reads them rotated (a raw image of one
  tile in a mode Pillow maps from the file: at the rotated size first);
- every cut point of files whose IFD comes first, and seeded mutations of
  the IFD, the strip or tile table and the compressed data:
  probe(reader="cv2") gives (0, 0) exactly where cv2.imread gives None, and
  decode equals cv2, else PIL, else raises; a mutation that makes a layout
  the port does not decode (what is left of TIFF part 2c: Pillow's LZMA
  and ZSTD compressions and its LAB mode, as Pillow parses the IFD) raises
  naming TIFF;
- libtiff's 16 to 8-bit rules (gray v >> 8, RGB (v + 128) // 257) over
  every value, and its premultiplying of unassociated alpha at every
  (value, alpha) pair; its CMYK, YCbCr and CIELAB conversions over tables
  of values; the Compression tag's three sets of numbers;
- the layouts still foreign (LZMA, ZSTD, Pillow's LAB) raise naming TIFF
  and probe (0, 0);
- load_canvas, both probes and generate_tree through both packages.

Max diff 0 throughout.
"""

import importlib.util
import io
import lzma
import struct
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch
from PIL import Image, TiffImagePlugin

from tsr_tpu import offline as joffline
from tsr_tpu_torch import native, offline

FIXTURES = Path(__file__).resolve().parent / "data" / "images"
_spec = importlib.util.spec_from_file_location(
    "image_fixtures", FIXTURES / "make_fixtures.py")
make_fixtures = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(make_fixtures)

torch.set_num_threads(2)
SIZE = 32
EXPECTED = np.load(FIXTURES / "expected.npz")
TIFFS = [n for n in make_fixtures.CASES if n.startswith("tiff")]
TIFF_SKIPS = [n for n in make_fixtures.SKIP_CASES if n.startswith("tiff")]
quiet = lambda s: None  # noqa: E731


def _reference(path):
    """(reader, RGB) of what the reference reads: ("cv2", ...), ("pil",
    ...), ("raise", None) where cv2.imread raises, ("none", None) where
    both refuse."""
    try:
        img = cv2.imread(str(path))
    except cv2.error:
        return "raise", None
    if img is not None:
        return "cv2", img[:, :, ::-1]
    try:
        return "pil", np.asarray(Image.open(path).convert("RGB"))
    except Exception:
        return "none", None


def _ifd(data):
    """{tag: (type, values)} of the first IFD as libtiff reads it (classic
    or BigTIFF, the first of duplicate tags; the integers of integer
    types), or None where it does not parse."""
    e = ">" if data[:2] == b"MM" else "<"
    big = data[2:4] in (b"+\0", b"\0+")
    fmt = {1: "B", 3: "H", 4: "I", 6: "b", 8: "h", 9: "i", 16: "Q", 17: "q"}
    try:
        at = struct.unpack(e + ("Q" if big else "I"),
                           data[8:16] if big else data[4:8])[0]
        n = struct.unpack(e + ("Q" if big else "H"),
                          data[at:at + (8 if big else 2)])[0]
        out = {}
        for k in range(min(n, 4096)):
            pos = at + (8 if big else 2) + (20 if big else 12) * k
            tag, typ = struct.unpack(e + "HH", data[pos:pos + 4])
            count = struct.unpack(e + ("Q" if big else "I"),
                                  data[pos + 4:pos + (12 if big else 8)])[0]
            if tag in out or typ not in fmt or count > len(data):
                continue
            size = struct.calcsize(fmt[typ]) * count
            field = data[pos + (12 if big else 8):pos + (20 if big else 12)]
            if size > len(field):
                off = struct.unpack(e + ("Q" if big else "I"), field)[0]
                field = data[off:off + size]
            if len(field) < size:
                continue
            out[tag] = (typ, struct.unpack(e + fmt[typ] * count, field[:size]))
        return out
    except (struct.error, ValueError):
        return None


# the compressions the port reads as the reference does (NeXT and WebP:
# refused as both refuse them)
DECODED_COMPRESSIONS = (1, 2, 3, 4, 5, 6, 7, 8, 32766, 32771, 32773, 32809,
                        32946, 34676, 34677, 50001)
DECODED_MODES = ("1", "L", "LA", "P", "PA", "I;16", "I;16B", "I", "F", "RGB",
                 "RGBA", "CMYK")


def _part2(data):
    """True where the first IFD shows a layout the port does not decode
    (TIFF part 2c) as Pillow parses it (the last of duplicate tags): a mode
    of Pillow's other than 1, L, LA, P, PA, I;16, I, F, RGB(A) and CMYK, or
    a compression other than part 1's, CCITT's, old-style and new JPEG,
    NeXT, ThunderScan, SGILog and WebP."""
    try:
        f = io.BytesIO(data)
        head = f.read(8)
        if head[2] == 43:
            head += f.read(8)
        ifd = TiffImagePlugin.ImageFileDirectory_v2(head)
        f.seek(ifd.next)
        ifd.load(f)
    except Exception:
        return False
    get = ifd.get
    if get(259, 1) not in DECODED_COMPRESSIONS:
        return True
    sf, bps = get(339, (1,)), get(258, (1,))
    sf = sf if isinstance(sf, tuple) else (sf,)
    bps = bps if isinstance(bps, tuple) else (bps,)
    if len(sf) > 1 and max(sf) == min(sf) == 1:
        sf = (1,)
    spp = get(277, 1)
    if not isinstance(spp, int):
        return False
    if spp < len(bps):
        bps = bps[:spp]
    elif spp > len(bps) and len(bps) == 1:
        bps = bps * spp
    key = (ifd.prefix, get(262, 0), sf, get(266, 1), bps, get(338, ()))
    mode = TiffImagePlugin.OPEN_INFO.get(key)
    return mode is not None and mode[0] not in DECODED_MODES


def _jpeg_rows(stream):
    """(rows, columns) of the first frame of a JPEG stream, or None."""
    for m in (b"\xff\xc0", b"\xff\xc1", b"\xff\xc2", b"\xff\xc3",
              b"\xff\xc9", b"\xff\xca"):
        at = stream.find(m)
        if at >= 0 and len(stream) >= at + 9:
            return struct.unpack(">HH", stream[at + 5:at + 9])
    return None


def _ifd_values(data, tag, limit):
    """The first ``limit`` integer values of ``tag`` in the first IFD, as
    libtiff reads a strip or tile table (however many the entry's count
    claims), or ()."""
    e = ">" if data[:2] == b"MM" else "<"
    big = data[2:4] in (b"+\0", b"\0+")
    word, entry, head = ("Q", 20, 8) if big else ("I", 12, 2)
    fmt = {3: "H", 4: "I", 16: "Q"}
    try:
        at = struct.unpack(e + word, data[8:16] if big else data[4:8])[0]
        n = struct.unpack(e + ("Q" if big else "H"), data[at:at + head])[0]
        for k in range(min(n, 4096)):
            pos = at + head + entry * k
            t, typ = struct.unpack(e + "HH", data[pos:pos + 4])
            if t != tag:
                continue
            if typ not in fmt:
                return ()
            wide = struct.calcsize(word)
            count = struct.unpack(e + word, data[pos + 4:pos + 4 + wide])[0]
            size = struct.calcsize(fmt[typ])
            field = pos + 4 + wide
            if count * size > wide:
                field = struct.unpack(e + word, data[field:field + wide])[0]
            count = min(count, limit)
            raw = data[field:field + count * size]
            return struct.unpack(e + fmt[typ] * (len(raw) // size), raw)
    except (struct.error, ValueError):
        pass
    return ()


def _pil_reads_unwritten(data):
    """True where a JPEG strip's or tile's frame has fewer rows or columns
    than Pillow unpacks of the strip or tile it stands for: Pillow decodes
    it into a buffer it does not zero, so its pixels there are whatever
    memory held, which no reader can give again (the port refuses such a
    file)."""
    ifd = _ifd(data) or {}

    def first(tag, default):
        values = ifd.get(tag, (0, ()))[1]
        return values[0] if values else default

    w, h = first(256, 0), first(257, 0)
    if first(259, 1) != 7 or not w or not h:
        return False
    tiled = 322 in ifd
    tw = first(322, 0) if tiled else w
    th = first(323, 0) if tiled else first(278, h)
    if not tw or not th:
        return False
    across = -(-w // tw) if tiled else 1
    chunks = across * -(-h // th) * (first(277, 1) if first(284, 1) == 2
                                     else 1)
    offsets = _ifd_values(data, 324 if tiled else 273, chunks)
    counts = _ifd_values(data, 325 if tiled else 279, chunks) or [
        len(data)] * len(offsets)  # estimated: to the end of the file
    for i, (o, c) in enumerate(zip(offsets, counts)):
        frame = _jpeg_rows(data[o:o + c])
        if frame is None:
            continue
        k = i % (across * -(-h // th))
        y, x = k // across * th, k % across * tw
        if frame[0] < min(th, h - y) or frame[1] < min(tw, w - x):
            return True
    return False


def _reads_as_reference(path):
    """probe(reader="cv2") is cv2's (h, w), (0, 0) where cv2 gives None or
    raises (and marked where it raises); decode equals cv2, else PIL, max
    diff 0, else raises; where the port raises naming TIFF, the layout is
    one of TIFF part 2c. Returns the reader."""
    data = Path(path).read_bytes()
    reader, want = _reference(path)
    (dims,), (raised,) = native.probe([str(path)], reader="cv2", raises=True)
    try:
        got, err = native.decode(str(path)), ""
    except RuntimeError as e:
        got, err = None, str(e)
    if "holds TIFF data" in err:  # raising, as the reference does, or
        assert dims.tolist() == [0, 0] and not raised  # on a part 2c layout
        assert reader == "none" or _part2(data), (reader, path)
        return "tiff part 2c"
    assert dims.tolist() == (list(want.shape[:2]) if reader == "cv2"
                             else [0, 0]), (reader, path)
    assert bool(raised) == (reader == "raise")
    if want is None:
        assert got is None, path
        return reader
    if got is None and reader == "pil" and _pil_reads_unwritten(data):
        return "pil, unwritten memory"
    assert got is not None, (reader, err)
    np.testing.assert_array_equal(got, want, err_msg=str(path))
    return reader


# ------------------------------------------------------------ fixtures

@pytest.mark.parametrize("name", TIFFS)
def test_fixture_decodes_as_cv2(name):
    """Each TIFF fixture: decode equals cv2.imread's pixels and
    expected.npz, max diff 0; both probes give its (h, w); load_batch
    reads it; load_canvas puts decode's pixels at the top-left of its slot
    and zeros around them."""
    p = str(FIXTURES / name)
    want = cv2.imread(p)[:, :, ::-1]
    np.testing.assert_array_equal(want, EXPECTED[f"decoded__{name}"])
    got = native.decode(p)
    np.testing.assert_array_equal(got, want)
    h, w = want.shape[:2]
    for reader in ("cv2", "port"):
        assert native.probe([p], reader=reader).tolist() == [[h, w]]
    assert native.load_batch([p], SIZE).shape == (1, SIZE, SIZE, 3)
    out = np.full((1, h + 3, w + 5, 3), 7, np.uint8)
    assert native.load_canvas([p], out).tolist() == [[h, w]]
    np.testing.assert_array_equal(out[0, :h, :w], got)
    assert not out[0, h:].any() and not out[0, :, w:].any()


def test_fixtures_cover_the_layouts():
    """The fixtures hold both byte orders, classic TIFF and BigTIFF of both,
    every compression (none, PackBits, LZW, both deflates, CCITT RLE, group
    3 and 4, RLE/W), predictor 2,
    gray, MINISWHITE, RGB and palette, samples of 1, 4, 8 and 16 bits,
    SampleFormat 2, ExtraSamples 0, 1 and 2 and two extra samples, planar
    configuration 2, FillOrder 2, one strip and many, tiles (a size no
    multiple of 16, one larger than the image), the IFD first and last;
    CMYK, YCbCr at each subsampling libtiff's reader puts, CIELAB, JPEG
    compression of gray, RGB, YCbCr and CMYK data in strips and tiles, a
    compression that names no codec; and the rules where PIL's pixels
    differ from cv2's (an 8-bit ColorMap, 16-bit samples, unassociated
    alpha, CMYK with K, CIELAB)."""
    seen = set()
    for name in TIFFS:
        data = (FIXTURES / name).read_bytes()
        ifd = {tag: v for tag, (_, v) in _ifd(data).items()}
        big = data[2:4] in (b"+\0", b"\0+")
        offsets = ifd.get(273, ifd.get(324))
        at = struct.unpack(("<" if data[:2] == b"II" else ">")
                           + ("Q" if big else "I"),
                           data[8:16] if big else data[4:8])[0]
        seen |= {("order", data[:2]), ("bigtiff", data[:2], big),
                 ("compression", ifd[259][0]),
                 ("photometric", ifd[262][0]),
                 ("predictor", ifd.get(317, (1,))[0]),
                 ("bits", ifd.get(258, (1,))[0]),
                 ("sampleformat", ifd.get(339, (1,))[0]),
                 ("extra", ifd.get(338, ())), ("planar", ifd.get(284, (1,))[0]),
                 ("fillorder", ifd.get(266, (1,))[0]),
                 ("tiles", 322 in ifd), ("chunks", len(offsets) > 1),
                 ("ifd_first", at < min(offsets))}
        if 322 in ifd:
            seen |= {("tile_not_16", ifd[322][0] % 16 != 0 or ifd[323][0] % 16 != 0),
                     ("tile_past_image", ifd[322][0] > ifd[256][0]
                      and ifd[323][0] > ifd[257][0])}
        if ifd[262][0] == 6 and ifd[259][0] != 7:
            seen.add(("subsampling", ifd.get(530, (2, 2))))
        if ifd[259][0] == 7:
            seen.add(("jpeg", ifd[262][0], 322 in ifd))
    for key in (("order", b"II"), ("order", b"MM"), ("bigtiff", b"II", True),
                ("bigtiff", b"MM", True), ("compression", 1),
                ("compression", 5), ("compression", 8),
                ("compression", 32773), ("compression", 32946),
                ("photometric", 0), ("photometric", 1), ("photometric", 2),
                ("photometric", 3), ("predictor", 2), ("bits", 1),
                ("bits", 4), ("bits", 8), ("bits", 16), ("sampleformat", 2),
                ("extra", (0,)), ("extra", (1,)), ("extra", (2,)),
                ("extra", (2, 0)), ("planar", 2), ("fillorder", 2),
                ("tiles", True), ("tiles", False), ("chunks", True),
                ("chunks", False), ("ifd_first", True), ("ifd_first", False),
                ("tile_not_16", True), ("tile_past_image", True),
                ("photometric", 5), ("photometric", 6), ("photometric", 8),
                ("compression", 7), ("compression", 99),
                ("subsampling", (1, 1)), ("subsampling", (2, 1)),
                ("subsampling", (2, 2)), ("subsampling", (4, 1)),
                ("subsampling", (4, 2)), ("subsampling", (4, 4)),
                ("subsampling", (1, 2)), ("jpeg", 1, False), ("jpeg", 2, False),
                ("jpeg", 6, False), ("jpeg", 6, True), ("jpeg", 5, True),
                ("compression", 2), ("compression", 3), ("compression", 4),
                ("compression", 32771)):
        assert key in seen, key
    for name in ("tiff_colormap_8bit.png", "tiff16_gray.png",
                 "tiff_cv2_rgb16.ppm", "tiff_pil_rgba.png",
                 "tiff_tiles_16bit_gray.png", "tiff_cmyk_k_planar.bmp",
                 "tiff_cielab.png"):
        p = FIXTURES / name
        pil = np.asarray(Image.open(p).convert("RGB"))
        assert not np.array_equal(pil, native.decode(str(p))), name


@pytest.mark.parametrize("name", TIFF_SKIPS)
def test_skip_fixture_reads_as_reference(name):
    """Each TIFF cv2 refuses (orientations 5 and 6, a strip byte count of
    0, a cut file, predictor 3): probe(reader="cv2") gives (0, 0); decode
    gives PIL's pixels where PIL reads it, and raises where it does not;
    where PIL reads it, load_canvas and the header probe give decode's
    size."""
    p = FIXTURES / "skip" / name
    assert _reads_as_reference(p) in ("pil", "none")
    key = f"decoded_skip__{name}"
    if key in EXPECTED.files:
        img = native.decode(str(p))
        np.testing.assert_array_equal(img, EXPECTED[key])
        h, w = img.shape[:2]
        assert native.probe([str(p)]).tolist() == [[h, w]]
        out = np.zeros((1, h, w, 3), np.uint8)
        assert native.load_canvas([str(p)], out).tolist() == [[h, w]]
        np.testing.assert_array_equal(out[0], img)


# -------------------------------------------------------- orientations

def _oriented(kind, orientation):
    rng = np.random.default_rng(40 + orientation)
    img = make_fixtures.smooth(rng, 13, 17)
    if kind == "rgb strips":
        return make_fixtures.tiff_file(img, rps=4, orientation=orientation)
    if kind == "gray one strip":
        return make_fixtures.tiff_file(make_fixtures.gray(img),
                                       orientation=orientation)
    return make_fixtures.tiff_file(  # palette, LZW
        make_fixtures.gray(img), photometric=3,
        cmap=rng.integers(0, 65536, 768), compression=5,
        orientation=orientation)


@pytest.mark.parametrize("kind", ["rgb strips", "gray one strip",
                                  "palette lzw"])
@pytest.mark.parametrize("orientation", range(1, 9))
def test_orientation_reads_as_reference(tmp_path, kind, orientation):
    """Orientation 1-4: cv2 reads the file flipped and the port gives its
    pixels and size by both probes; 5-8: cv2 gives None, the cv2 probe
    (0, 0), and decode, load_canvas and the header probe give PIL's
    rotated image (for a gray or palette image of one uncompressed strip,
    Pillow's mapping at the rotated size, then the rotation)."""
    p = tmp_path / "o.png"
    p.write_bytes(_oriented(kind, orientation))
    reader = _reads_as_reference(p)
    assert reader == ("cv2" if orientation <= 4 else "pil")
    img = native.decode(str(p))
    assert native.probe([str(p)]).tolist() == [list(img.shape[:2])]
    out = np.zeros((1, 20, 20, 3), np.uint8)
    h, w = img.shape[:2]
    assert native.load_canvas([str(p)], out).tolist() == [[h, w]]
    np.testing.assert_array_equal(out[0, :h, :w], img)


# ------------------------------------------------------------------ cuts

# files whose IFD comes first, so a cut falls in the strips: both byte
# orders, each compression, gray, RGB and palette
CUT_FILES = ("tiff_be_raw_rgb.bmp", "tiff_be_lzw_gray_predictor.bmp",
             "tiff_ifd_first_packbits_rgb.png",
             "tiff_ifd_first_deflate_predictor_rgb.png",
             "tiff_colormap_8bit.png", "tiff_old_style_lzw.png",
             "tiff_orientation_3.png", "skip/tiff_orientation_6.png",
             "tiff_tiles_odd_width.png", "tiff_bigtiff_lzw.png",
             "tiff_jpeg_420.png", "tiff_jpeg_pil_ycbcr.png",
             "tiff_ycbcr_22_lzw.ppm", "tiff_cmyk_k_planar.bmp")


@pytest.mark.parametrize("name", CUT_FILES)
def test_every_cut_point_reads_as_reference(tmp_path, name):
    """The file cut at every length from 8 bytes to one short of whole:
    cv2 refuses any strip that runs past the end, PIL reads what its own
    reader or libtiff still decode whole, and the port reads each cut as
    the reference does."""
    data = (FIXTURES / name).read_bytes()
    p = tmp_path / "cut.png"
    readers = set()
    for cut in range(8, len(data)):
        p.write_bytes(data[:cut])
        readers.add(_reads_as_reference(p))
    assert "none" in readers


# ------------------------------------------------------------- mutations

# the bytes the IFD parsers care about: small tag types and values, 0xff
VALUES = [0, 1, 2, 3, 4, 5, 6, 7, 8, 16, 255, 0x80]


def _mutations(rng, seeds, n, spans):
    """``n`` files from ``seeds``, each with bytes overwritten, flipped,
    cut, inserted or deleted, or set to one of VALUES, in one of the
    ``spans(data)`` of the seed file (its IFD, strip table or strips)."""
    for _ in range(n):
        src = seeds[int(rng.integers(len(seeds)))]
        data = bytearray(src.read_bytes())
        choices = spans(bytes(data))
        lo, hi = choices[int(rng.integers(len(choices)))]
        kind = int(rng.integers(6))
        for _ in range(int(rng.integers(1, 4))):
            i = int(rng.integers(max(lo, 2), max(min(hi, len(data)), lo + 1,
                                                 3)))
            i = min(i, len(data) - 1)
            if kind == 0:
                data[i] = int(rng.integers(256))
            elif kind == 1:
                data = data[:max(i, 8)]
            elif kind == 2:
                data[i] ^= 1 << int(rng.integers(8))
            elif kind == 3:
                data[i:i] = bytes(rng.integers(0, 256, int(rng.integers(
                    1, 4)), dtype=np.uint8))
            elif kind == 4:
                del data[i:i + 1 + int(rng.integers(16))]
            else:
                data[i] = int(rng.choice(VALUES))
        yield bytes(data)


def _spans(where):
    """The [lo, hi) byte spans of a file's header and IFD (classic or
    BigTIFF), of its strip or tile table (the offsets' and byte counts'
    entries, and their arrays where they lie outside the IFD) or of its
    strips or tiles."""
    def spans(data):
        e = ">" if data[:2] == b"MM" else "<"
        big = data[2:4] in (b"+\0", b"\0+")
        word, entry, count = ("Q", 20, 8) if big else ("I", 12, 2)
        at = struct.unpack(e + word, data[8:16] if big else data[4:8])[0]
        n = struct.unpack(e + ("Q" if big else "H"), data[at:at + count])[0]
        if where == "ifd":
            return [(at, at + count + entry * n + struct.calcsize(word))] + (
                [(2, 16)] if big else [])
        table, arrays = [], {}
        for k in range(n):
            pos = at + count + entry * k
            tag, typ, num = struct.unpack(e + "HH" + word,
                                          data[pos:pos + 4 + struct.calcsize(word)])
            if tag not in (273, 279, 324, 325):
                continue
            fmt = e + {3: "H", 4: "I", 16: "Q"}[typ] * num
            size = struct.calcsize(fmt)
            field = pos + entry - struct.calcsize(word)
            table.append((pos, pos + entry))
            if size > struct.calcsize(word):
                value = struct.unpack(e + word, data[field:field + struct.calcsize(word)])[0]
                table.append((value, value + size))
                arrays[tag in (279, 325)] = struct.unpack(
                    fmt, data[value:value + size])
            else:
                arrays[tag in (279, 325)] = struct.unpack(
                    fmt, data[field:field + size])
        if where == "strip table":
            return table
        if True not in arrays:  # the counts estimated: to the file's end
            return [(min(arrays[False]), len(data))]
        return [(o, o + c) for o, c in zip(arrays[False], arrays[True])]
    return spans


MUTATION_SEEDS = sorted(FIXTURES / n for n in TIFFS) + sorted(
    FIXTURES / "skip" / n for n in ("tiff_orientation_6.png",
                                    "tiff_byte_count_0.png"))


@pytest.mark.parametrize("where", ["ifd", "strip table", "strips"])
@pytest.mark.parametrize("seed", range(2))
def test_mutated_tiles_and_bigtiff_read_as_reference(tmp_path, where, seed):
    """60 files a seed and region from a tiled file and a BigTIFF, each
    with its header and IFD (8-byte counts and offsets), its tile or strip
    table (LONG8 arrays) or its tiles and strips mutated: the port's probe
    and decode read each as the reference does."""
    rng = np.random.default_rng(4100 + 10 * seed + ["ifd", "strip table",
                                                    "strips"].index(where))
    p = tmp_path / "m.png"
    seeds = [FIXTURES / "tiff_tiles_odd_width.png",
             FIXTURES / "tiff_bigtiff_lzw.png",
             FIXTURES / "tiff_bigtiff_be_tiles.bmp"]
    for data in _mutations(rng, seeds, 60, _spans(where)):
        p.write_bytes(data)
        _reads_as_reference(p)


@pytest.mark.parametrize("where", ["ifd", "strip table", "strips"])
@pytest.mark.parametrize("seed", range(2))
def test_mutated_ycbcr_and_jpeg_read_as_reference(tmp_path, where, seed):
    """60 files a seed and region from a JPEG-compressed YCbCr 4:2:0 file
    (whole streams a strip), Pillow's JPEG YCbCr file (a JPEGTables tag and
    abbreviated streams) and subsampled YCbCr (2 x 2 blocks, LZW), each
    with its IFD (the subsampling, the tables), its strip table or its
    streams and blocks mutated: the port's probe and decode read each as
    the reference does."""
    rng = np.random.default_rng(4200 + 10 * seed + ["ifd", "strip table",
                                                    "strips"].index(where))
    p = tmp_path / "m.png"
    seeds = [FIXTURES / "tiff_jpeg_420.png",
             FIXTURES / "tiff_jpeg_pil_ycbcr.png",
             FIXTURES / "tiff_ycbcr_22_lzw.ppm"]
    for data in _mutations(rng, seeds, 60, _spans(where)):
        p.write_bytes(data)
        _reads_as_reference(p)


@pytest.mark.parametrize("where", ["ifd", "strip table", "strips"])
@pytest.mark.parametrize("seed", range(4))
def test_mutated_files_read_as_reference(tmp_path, where, seed):
    """60 files a seed and region, each a TIFF fixture with its IFD, its
    strip table (the StripOffsets and StripByteCounts entries and arrays)
    or its strips mutated: the port's probe and decode read each as the
    reference does (a broken strip as far as cv2 decodes it)."""
    rng = np.random.default_rng(4000 + 10 * seed + ["ifd", "strip table",
                                                    "strips"].index(where))
    p = tmp_path / "m.png"
    for data in _mutations(rng, MUTATION_SEEDS, 60, _spans(where)):
        p.write_bytes(data)
        _reads_as_reference(p)


# ------------------------------------------------------- libtiff's rules

def test_sixteen_bit_ramps_read_as_cv2(tmp_path):
    """Every 16-bit value, as gray (big and little endian, MINISBLACK and
    MINISWHITE) and as RGB: cv2 keeps a gray sample's high byte and rounds
    an RGB one to (v + 128) // 257 (libtiff's two rules), and the port reads
    each file as cv2 does; PIL clips gray at 255 and keeps RGB's high
    byte."""
    ramp = np.arange(65536, dtype=np.uint16).reshape(256, 256)
    rgb = np.dstack([ramp, ramp.T, ramp[::-1]])
    p = tmp_path / "ramp.png"
    for kw in ({"photometric": 1}, {"photometric": 0, "big": True},
               {"compression": 5, "predictor": 2}):
        p.write_bytes(make_fixtures.tiff_file(ramp, bits=16, rps=64, **kw))
        want = 255 - (ramp >> 8) if kw.get("photometric") == 0 else ramp >> 8
        np.testing.assert_array_equal(cv2.imread(str(p))[:, :, 0], want)
        assert _reads_as_reference(p) == "cv2"
    for kw in ({}, {"big": True, "compression": 8, "predictor": 2}):
        p.write_bytes(make_fixtures.tiff_file(rgb, bits=16, rps=64, **kw))
        np.testing.assert_array_equal(cv2.imread(str(p))[:, :, ::-1],
                                      (rgb.astype(int) + 128) // 257)
        np.testing.assert_array_equal(
            np.asarray(Image.open(p).convert("RGB")), rgb >> 8)
        assert _reads_as_reference(p) == "cv2"


@pytest.mark.parametrize("bits", [8, 16])
@pytest.mark.parametrize("extra", [0, 1, 2, 999])
def test_alpha_at_every_value_reads_as_cv2(tmp_path, bits, extra):
    """RGB plus one extra sample at every (value, alpha) pair: ExtraSamples
    2 (and Corel's 999) is unassociated alpha, which libtiff premultiplies
    as (v x a + 127) // 255; 1 and 0 (unspecified, past 3 samples) are
    associated and kept. The port reads each as cv2 does, planar too."""
    v, a = np.meshgrid(np.arange(256), np.arange(256), indexing="ij")
    img = np.dstack([v, 255 - v, (v * 7) % 256, a])
    want = (img[:, :, :3] * a[:, :, None] + 127) // 255 if extra in (2, 999) \
        else img[:, :, :3]
    scale = 257 if bits == 16 else 1
    p = tmp_path / "alpha.png"
    for planar in (1, 2):
        p.write_bytes(make_fixtures.tiff_file(
            img * scale, bits=bits, extra=[extra], rps=64, planar=planar))
        np.testing.assert_array_equal(cv2.imread(str(p))[:, :, ::-1], want)
        assert _reads_as_reference(p) == "cv2"


# --------------------------------------------------------- TIFF part 2a

def _part2a_files():
    """The layouts the port did not decode before TIFF part 2a (each a
    case that its test held against a raise), and more."""
    rng = np.random.default_rng(50)
    img = make_fixtures.smooth(rng, 12, 16)
    g = make_fixtures.gray(img)
    out = {}
    for mode in ("1", "RGBA", "I;16", "LA"):
        out[mode] = make_fixtures.pil_tiff(img, mode)
    out["minisWhite"] = make_fixtures.tiff_file(g, photometric=0)
    out["planar 2"] = make_fixtures.tiff_file(g, tags={284: (3, [2])})
    out["bigtiff"] = make_fixtures.tiff_file(img, bigtiff=True, rps=5)
    out["bigtiff be"] = make_fixtures.tiff_file(img, bigtiff=True, big=True,
                                                compression=8)
    out["tiles"] = make_fixtures.tiff_file(img, tile=(16, 16), compression=5)
    out["fillorder 2"] = make_fixtures.tiff_file(g, fillorder=2,
                                                 compression=32773)
    out["2-bit"] = make_fixtures.tiff_file(g >> 6, bits=2)
    out["4-bit palette"] = make_fixtures.tiff_file(
        g >> 4, bits=4, photometric=3, cmap=rng.integers(0, 65536, 48))
    return out


@pytest.mark.parametrize("name", sorted(_part2a_files()))
def test_part2a_layouts_read_as_reference(tmp_path, name):
    """1-bit, RGBA (unassociated alpha), 16-bit gray, gray + alpha,
    MINISWHITE, planar configuration 2, BigTIFF of both byte orders, tiles,
    FillOrder 2 and 4-bit palettes: cv2 reads each and the port gives its
    pixels and size; 2-bit gray only PIL reads, and the port gives PIL's."""
    p = tmp_path / "p2a.png"
    p.write_bytes(_part2a_files()[name])
    reader = _reads_as_reference(p)
    assert reader == ("pil" if name == "2-bit" else "cv2")
    img = native.decode(str(p))
    assert native.probe([str(p)]).tolist() == [list(img.shape[:2])]


def _jpeg_stream(sampling):
    return lambda block: make_fixtures.jpeg_stream(block, sampling)


def _part2b_files():
    """The layouts of TIFF part 2b (the first four each a case that an
    earlier test held against a raise), as cv2 reads each."""
    rng = np.random.default_rng(50)
    img = make_fixtures.smooth(rng, 12, 16)
    ycc = rng.integers(0, 256, (11, 13, 3))
    cmyk = rng.integers(0, 256, (11, 13, 4))
    tiff = make_fixtures.tiff_file
    out = {"CMYK": make_fixtures.pil_tiff(img, "CMYK"),
           "LAB": make_fixtures.pil_tiff(img, "LAB"),
           "YCbCr": tiff(img, photometric=6, compression=8,
                         tags={530: (3, [1, 1])}),
           "jpeg": make_fixtures.pil_tiff(img, "RGB", compression="jpeg"),
           "CMYK separate": tiff(cmyk, photometric=5, planar=2, rps=4),
           "CMYK tiles": tiff(cmyk, photometric=5, tile=(16, 16),
                              compression=5, predictor=2),
           "YCbCr separate": tiff(ycc, photometric=6, planar=2,
                                  tags={530: (3, [1, 1])}, compression=5),
           "CIELAB 16-bit": tiff(rng.integers(0, 65536, (5, 7, 3)),
                                 photometric=8, bits=16, big=True),
           "unknown compression": tiff(img, tags={259: (3, [40000])}),
           "jpeg gray": tiff(make_fixtures.gray(img), rps=8,
                             jpeg=lambda b: make_fixtures.jpeg_stream(b[:, :, 0])),
           "jpeg RGB": make_fixtures.pil_tiff(img[:9], "RGB",
                                              compression="jpeg"),
           "jpeg YCbCr 4:2:0": tiff(img, photometric=6, rps=8,
                                    jpeg=_jpeg_stream((2, 2)),
                                    tags={530: (3, [2, 2])}),
           "jpeg YCbCr 4:2:0 no tag": tiff(img, photometric=6, rps=8,
                                           jpeg=_jpeg_stream((2, 2))),
           "jpeg CMYK": make_fixtures.pil_tiff(img, "CMYK",
                                               compression="jpeg"),
           "jpeg tiled": tiff(img, photometric=6, tile=(16, 16),
                              jpeg=_jpeg_stream((2, 1)),
                              tags={530: (3, [2, 1])})}
    for hs, vs in ((1, 1), (2, 1), (2, 2), (4, 1), (4, 2), (4, 4), (1, 2)):
        out[f"YCbCr {hs}x{vs}"] = tiff(ycc, ycc=(hs, vs), rps=4)
        out[f"YCbCr {hs}x{vs} tiles"] = tiff(ycc, ycc=(hs, vs), tile=(16, 16),
                                             compression=32773)
    return out


@pytest.mark.parametrize("name", sorted(_part2b_files()))
def test_part2b_layouts_read_as_reference(tmp_path, name):
    """CMYK (Pillow's, separate planes, an extra sample), CIELAB (8 and
    16 bits), YCbCr (separate planes, and packed in blocks at every
    subsampling libtiff's RGBA reader puts, in strips and tiles), JPEG
    compression (gray, RGB, YCbCr 4:2:0 with the subsampling tag and
    without it, CMYK, tiles) and a compression that names no codec: cv2
    reads each, and the port gives its pixels and size by both probes."""
    p = tmp_path / "p2b.png"
    p.write_bytes(_part2b_files()[name])
    assert _reads_as_reference(p) == "cv2"
    img = native.decode(str(p))
    assert native.probe([str(p)]).tolist() == [list(img.shape[:2])]


def _part2c_files():
    rng = np.random.default_rng(50)
    img = make_fixtures.smooth(rng, 12, 16)
    return {"zstd": make_fixtures.pil_tiff(img, "RGB", compression="zstd"),
            "lzma": make_fixtures.tiff_file(
                img, compression=34925, strips=[lzma.compress(img.tobytes())]),
            "LAB separate": make_fixtures.tiff_file(img, photometric=8,
                                                    planar=2),
            "LAB orientation 5": make_fixtures.tiff_file(img, photometric=8,
                                                         orientation=5)}


@pytest.mark.parametrize("name", sorted(_part2c_files()))
def test_part2_layouts_raise_naming_tiff(tmp_path, name):
    """ZSTD and LZMA compression, and CIELAB in separate planes or at
    orientation 5 (what is left of TIFF part 2c): PIL reads them (LAB
    through LittleCMS), cv2 none; the port does not decode them: decode and
    the header probe raise naming TIFF, the cv2 probe gives (0, 0). (The
    32-bit integer and float cases this test held read since the port
    decodes Pillow's I and F modes: tests/test_torch_port_tiff_modes.py.)"""
    p = tmp_path / "p2.png"
    p.write_bytes(_part2c_files()[name])
    assert cv2.imread(str(p)) is None
    Image.open(p).convert("RGB")
    assert _part2(p.read_bytes())
    with pytest.raises(RuntimeError, match="holds TIFF data"):
        native.decode(str(p))
    with pytest.raises(RuntimeError, match="holds TIFF data"):
        native.probe([str(p)])
    assert native.probe([str(p)], reader="cv2").tolist() == [[0, 0]]


# ------------------------------------------------ libtiff's colour rules

def test_cmyk_ramp_reads_as_cv2(tmp_path):
    """Every (C, K) pair, with M and Y moved along: libtiff turns CMYK into
    RGB as k (255 - C) // 255 with k = 255 - K; PIL's cmyk2rgb rounds
    instead. The port reads it as cv2 does, contiguous and planar."""
    c, k = np.meshgrid(np.arange(256), np.arange(256), indexing="ij")
    cmyk = np.dstack([c, (c * 3 + k) % 256, 255 - c, k])
    want = (255 - cmyk[:, :, 3:]) * (255 - cmyk[:, :, :3]) // 255
    p = tmp_path / "cmyk.png"
    for planar in (1, 2):
        p.write_bytes(make_fixtures.tiff_file(cmyk, photometric=5, rps=64,
                                              planar=planar))
        np.testing.assert_array_equal(cv2.imread(str(p))[:, :, ::-1], want)
        assert _reads_as_reference(p) == "cv2"
    assert not np.array_equal(np.asarray(Image.open(p).convert("RGB")), want)


@pytest.mark.parametrize("refbw", [None, (16, 235, 128, 240, 128, 240),
                                   (0, 100, 30, 200, 90, 91)])
def test_ycbcr_grid_reads_as_cv2(tmp_path, refbw):
    """Every Y against a grid of Cb and Cr, under libtiff's default
    ReferenceBlackWhite and two others, with Rec. 601 and Rec. 709
    coefficients: libtiff's fixed-point tables (TIFFYCbCrToRGBInit) give
    cv2's pixels, and the port reads each file as cv2 does."""
    y, cb, cr = np.meshgrid(np.arange(256), np.r_[0:256:5, 255],
                            np.r_[0:256:5, 255], indexing="ij")
    ycc = np.dstack([y.reshape(256, -1), cb.reshape(256, -1),
                     cr.reshape(256, -1)])
    p = tmp_path / "ycc.png"
    for luma in (None, (0.2126, 0.7152, 0.0722)):
        tags = {}
        if refbw is not None:
            tags[532] = (5, list(refbw))
        if luma is not None:
            tags[529] = (5, list(luma))
        p.write_bytes(make_fixtures.tiff_file(ycc, ycc=(1, 1), rps=64,
                                              tags=tags))
        assert _reads_as_reference(p) == "cv2"


def test_cielab_grid_reads_as_cv2(tmp_path):
    """Every L* against a grid of signed a* and b*, 8-bit, under the D50
    white point and D65's: libtiff's float conversion (TIFFCIELabToXYZ,
    TIFFXYZToRGB) gives cv2's pixels, and the port reads each as cv2
    does."""
    lab = np.meshgrid(np.arange(256), np.r_[0:256:3], np.r_[0:256:3],
                      indexing="ij")
    lab = np.dstack([c.reshape(256, -1) for c in lab])
    p = tmp_path / "lab.png"
    for tags in ({}, {318: (5, [0.3127, 0.329])}):
        p.write_bytes(make_fixtures.tiff_file(lab, photometric=8, rps=64,
                                              tags=tags))
        assert _reads_as_reference(p) == "cv2"


# a sample of the sweep of the Compression tag over 0-65535 (one small
# uncompressed file in cv2.imread): numbers that name no codec (zeros),
# codecs cv2's libtiff leaves out (None), codecs whose setup refuses this
# 8-bit RGB file (None: CCITT takes 1-bit samples, NeXT 2-bit, ThunderScan
# 4-bit, SGILog LogL or LogLuv data), and part 1's and JPEG (decoded as
# the data allows)
SWEEP = {"no codec": (0, 9, 99, 300, 32767, 32908, 34660, 40000, 50002,
                      65535),
         "not configured": (6, 32909, 34661, 34887, 34925, 50000, 50001),
         "setup refuses 8-bit RGB": (2, 3, 4, 32766, 32771, 32809, 34676,
                                     34677),
         "decoded": (1, 5, 7, 8, 32773, 32946)}


@pytest.mark.parametrize("kind", sorted(SWEEP))
def test_compression_numbers_read_as_cv2(tmp_path, kind):
    """The Compression tag set to each number of a sample of each set: a
    number that names no codec reads as zeros of the image's size, a codec
    left out of cv2's build or whose setup refuses the file gives None (and
    PIL refuses it too), and the port reads each file as the reference
    does."""
    img = make_fixtures.smooth(np.random.default_rng(51), 4, 5)
    p = tmp_path / "c.png"
    for c in SWEEP[kind]:
        p.write_bytes(make_fixtures.tiff_file(img, tags={259: (3, [c])}))
        got = cv2.imread(str(p))
        if kind == "no codec":
            assert got is not None and got.shape == (4, 5, 3) and not got.any()
        elif kind != "decoded":
            assert got is None, c
        reader = _reads_as_reference(p)
        if kind == "setup refuses 8-bit RGB":
            assert reader == "none", c


# --------------------------------------------------------- generate_tree

def test_generate_tree_writes_what_the_reference_writes(tmp_path):
    """generate_tree("noise") through both packages over every TIFF
    fixture and TIFF skip file: the same count and file names, the skipped
    files counted in the port's log."""
    root = tmp_path / "src"
    files = [FIXTURES / n for n in TIFFS] + [FIXTURES / "skip" / n
                                             for n in TIFF_SKIPS]
    for k, p in enumerate(files):
        out = root / f"c{k % 3}" / p.name
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_bytes(p.read_bytes())
    lines = []
    n = offline.generate_tree(str(root), str(tmp_path / "ours"), "noise",
                              log=lines.append, device="cpu")
    m = joffline.generate_tree(str(root), str(tmp_path / "ref"), "noise",
                               log=quiet)
    assert n == m == len(TIFFS)
    assert f"Skipped {len(TIFF_SKIPS)} unreadable files" in lines
    ours = sorted(str(p.relative_to(tmp_path / "ours"))
                  for p in (tmp_path / "ours").glob("*/*"))
    ref = sorted(str(p.relative_to(tmp_path / "ref"))
                 for p in (tmp_path / "ref").glob("*/*"))
    assert ours == ref and len(ours) == n
