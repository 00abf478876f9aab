"""TIFF part 2c, the CCITT codecs: Compression 2 (CCITT RLE), 3 (group 3,
1-D and 2-D), 4 (group 4) and 32771 (RLE/W), read by the port as the
reference reads them (cv2.imread, else PIL's convert("RGB")), max diff 0.

libtiff's decoders (tif_fax3.c) are copied with their recovery: a bad code
ends its row, a group 3 row starts after the next EOL, and where the data
runs out before one the decoder takes the data to have no EOLs for the rest
of the file ("Try to decode (read) fax Group 3 data without EOL") and reads
the row again from the chunk's first byte; a group 4 strip may end early
and succeed; RLE/W aligns its rows to 16-bit words of the file's mapping.
Pillow writes all four codecs here; the files cover:

- the matrix: each codec (group 3 with Group3Options 1, 4 and 5),
  MINISWHITE and MINISBLACK, FillOrder 1 and 2, several RowsPerStrip,
  orientations 1-8 of square and non-square images (5-8 of a non-square
  one: PIL's read), a Predictor tag (which CCITT ignores), drawn from a
  seeded stream;
- tiles: each tile's pixels a one-strip Pillow file, its bytes placed by
  image_writers.tiff_file;
- damage: cut points and seeded mutations of the strips;
- group 3 data without EOLs, in whole or in part, across strips (the
  mode stays set), written by chip_smoke.py's T.4 coder, and RLE/W strips
  at odd offsets;
- chip_smoke.py's fax page as group 4 and group 3 2-D, which cv2 reads as
  the bitmap it was built from.

Where PIL reads a chunk that libtiff decodes with success and leaves rows
unwritten (a group 4 strip that ends early, a tile that runs out of data),
Pillow's pixels there are whatever its unzeroed buffer held: the port
refuses such a file, and the tests tell it by reading the chunk through
Pillow's libtiff twice, over buffers of 0x00 and 0xFF.
"""

import ctypes
import glob
import importlib.util
import io
import os
import struct
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

from tsr_tpu_torch import native

torch.set_num_threads(2)
HERE = Path(__file__).resolve().parent
_spec = importlib.util.spec_from_file_location(
    "image_writers", HERE / "data" / "image_writers.py")
writers = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(writers)
_spec = importlib.util.spec_from_file_location(
    "chip_smoke", HERE.parent / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

CODECS = {"rle": "tiff_ccitt", "rlew": "tiff_raw_16", "g3": "group3",
          "g4": "group4"}
NUMBERS = {"tiff_ccitt": 2, "group3": 3, "group4": 4, "tiff_raw_16": 32771}


def _bits(rng, h, w):
    """Seeded bilevel pixels (True black): blobs of a cubic upsampling."""
    x = rng.integers(0, 256, (h // 4 + 2, w // 4 + 2)).astype(np.uint8)
    return cv2.resize(x, (w, h), interpolation=cv2.INTER_CUBIC) > 128


def _pillow(bits, compression, info=None):
    """Pillow's TIFF of ``bits`` in mode 1 with ``compression`` and the
    ``tiffinfo`` tags ``info``."""
    buf = io.BytesIO()
    Image.fromarray(np.where(bits, 0, 255).astype(np.uint8)).convert(
        "1").save(buf, "TIFF", compression=compression,
                  **({"tiffinfo": info} if info else {}))
    return buf.getvalue()


def _tags(data):
    """{tag: the value field as an integer} of a little-endian classic
    TIFF's first IFD."""
    at = struct.unpack("<I", data[4:8])[0]
    n = struct.unpack("<H", data[at:at + 2])[0]
    tags = {}
    for k in range(n):
        tag, typ, _, value = struct.unpack("<HHII", data[at + 2 + 12 * k:
                                                         at + 14 + 12 * k])
        tags[tag] = value & 0xFFFF if typ == 3 else value
    return tags


def _first_strip(data):
    """The bytes of a little-endian TIFF's one strip."""
    tags = _tags(data)
    return data[tags[273]:tags[273] + tags[279]]


# ---------------------------------------------- libtiff through Pillow

def _libtiff():
    import PIL._imaging  # noqa: F401  (loads Pillow's libraries)
    lib = ctypes.CDLL(glob.glob(str(Path(Image.__file__).parent.parent
                                    / "pillow.libs" / "libtiff*"))[0])
    lib.TIFFOpen.restype = ctypes.c_void_p
    lib.TIFFOpen.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
    lib.TIFFClose.argtypes = [ctypes.c_void_p]
    lib.TIFFIsTiled.argtypes = [ctypes.c_void_p]
    for name in ("TIFFNumberOfTiles", "TIFFNumberOfStrips"):
        getattr(lib, name).restype = ctypes.c_uint32
        getattr(lib, name).argtypes = [ctypes.c_void_p]
    for name in ("TIFFTileSize", "TIFFStripSize", "TIFFTileRowSize",
                 "TIFFScanlineSize"):
        getattr(lib, name).restype = ctypes.c_ssize_t
        getattr(lib, name).argtypes = [ctypes.c_void_p]
    for name in ("TIFFReadEncodedTile", "TIFFReadEncodedStrip"):
        getattr(lib, name).restype = ctypes.c_ssize_t
        getattr(lib, name).argtypes = [ctypes.c_void_p, ctypes.c_uint32,
                                       ctypes.c_void_p, ctypes.c_ssize_t]
    return lib


def _libtiff_leaves_rows_unwritten(path):
    """True where libtiff decodes a strip or tile of ``path`` with success
    and leaves bits of its rows unwritten: Pillow's buffer holds whatever
    memory held there."""
    lib = _libtiff()
    reads = []
    for fill in (0x00, 0xFF):
        t = lib.TIFFOpen(str(path).encode(), b"r")
        if not t:
            return False
        tiled = lib.TIFFIsTiled(t)
        n = lib.TIFFNumberOfTiles(t) if tiled else lib.TIFFNumberOfStrips(t)
        size = lib.TIFFTileSize(t) if tiled else lib.TIFFStripSize(t)
        row = lib.TIFFTileRowSize(t) if tiled else lib.TIFFScanlineSize(t)
        read = lib.TIFFReadEncodedTile if tiled else lib.TIFFReadEncodedStrip
        chunks = []
        for i in range(n):
            buf = ctypes.create_string_buffer(bytes([fill]) * size, size)
            got = read(t, i, buf, size)
            chunks.append((got, buf.raw))
        lib.TIFFClose(t)
        reads.append((chunks, row))
    try:
        ifd = Image.open(path).tag_v2
        w = int(ifd.get(322) or ifd.get(256))
    except Exception:
        return False
    (zeros, row), (ones, _) = reads
    for (got, a), (_, b) in zip(zeros, ones):
        if got <= 0:
            continue
        for r in range(got // row):
            x = np.unpackbits(np.frombuffer(a[r * row:(r + 1) * row], np.uint8))
            y = np.unpackbits(np.frombuffer(b[r * row:(r + 1) * row], np.uint8))
            if (x[:w] != y[:w]).any():
                return True
    return False


def _reads_as_reference(path):
    """probe(reader="cv2") is cv2's (h, w), (0, 0) where cv2 gives None;
    decode equals cv2, else PIL, max diff 0, else raises (also where PIL's
    pixels are memory libtiff left unwritten). Returns the reader."""
    want = cv2.imread(str(path))
    reader = "cv2"
    if want is None:
        try:
            want, reader = np.asarray(Image.open(path).convert("RGB")), "pil"
        except Exception:
            reader = "none"
    else:
        want = want[:, :, ::-1]
    dims = native.probe([str(path)], reader="cv2").tolist()
    assert dims == ([list(want.shape[:2])] if reader == "cv2" else [[0, 0]])
    try:
        got = native.decode(str(path))
    except RuntimeError as e:
        assert "holds TIFF data" not in str(e), path
        got = None
    if reader == "none":
        assert got is None
    elif got is None and reader == "pil" and \
            _libtiff_leaves_rows_unwritten(path):
        return "pil, unwritten memory"
    else:
        assert got is not None, (reader, path)
        np.testing.assert_array_equal(got, want, err_msg=str(path))
    return reader


# -------------------------------------------------------------- files

def _matrix(codec):
    """Seeded layouts of ``codec``: {name: bytes}."""
    rng = np.random.default_rng(300 + sorted(CODECS).index(codec))
    out = {}
    for k in range(24):
        square = k % 3 == 0
        h = int(rng.integers(4, 40))
        w = h if square else int(rng.integers(4, 70))
        info = {262: int(rng.integers(0, 2)), 274: k % 8 + 1}
        if codec == "g3":
            info[292] = (1, 4, 5, 0)[k % 4]
        if k % 2:
            info[266] = 2
        if k % 4 == 1:
            info[278] = int(rng.integers(1, h + 1))
        if k % 6 == 5:
            info[317] = 2
        out[f"{k}_{h}x{w}"] = _pillow(_bits(rng, h, w), CODECS[codec], info)
    return out


def _tiled(codec, rng):
    """The tiled files of ``codec``: each tile's pixels a one-strip Pillow
    file whose strip tiff_file places; upright, under orientation 6, and
    with a FillOrder 2 tag over the tiles' MSB-first bits (damage that sends
    2-D rows' reference lines past their runs, into what earlier rows and
    tiles left in libtiff's run arrays)."""
    h, w = int(rng.integers(10, 40)), int(rng.integers(10, 70))
    tw, th = 16 * int(rng.integers(1, 3)), 16 * int(rng.integers(1, 3))
    bits = _bits(rng, h, w)
    info = {292: 5} if codec == "g3" else {}
    strips = []
    for y in range(0, h, th):
        for x in range(0, w, tw):
            block = np.zeros((th, tw), bool)
            part = bits[y:y + th, x:x + tw]
            block[:part.shape[0], :part.shape[1]] = part
            strips.append(_first_strip(_pillow(block, CODECS[codec], info)))
    tags = {292: (4, [5])} if codec == "g3" else {}
    return [writers.tiff_file(bits.astype(np.uint8), photometric=1, bits=1,
                              compression=NUMBERS[CODECS[codec]],
                              tile=(tw, th), strips=strips, tags=tags,
                              orientation=orientation, fillorder=fillorder)
            for orientation, fillorder in ((None, 1), (6, 1), (None, 2))]


@pytest.mark.parametrize("codec", sorted(CODECS))
def test_ccitt_matrix_reads_as_reference(tmp_path, codec):
    """Each codec over the seeded matrix (photometric, FillOrder,
    RowsPerStrip, orientations 1-8, square or not, a Predictor tag, group
    3's options): cv2's pixels, else PIL's, max diff 0, and cv2's size or
    (0, 0) from the cv2 probe."""
    p = tmp_path / "m.png"
    readers = set()
    for name, data in _matrix(codec).items():
        p.write_bytes(data)
        readers.add(_reads_as_reference(p))
    assert {"cv2", "pil"} <= readers


@pytest.mark.parametrize("codec", sorted(CODECS))
def test_ccitt_tiles_read_as_reference(tmp_path, codec):
    """Tiles of each codec, the same tiles under orientation 6 (PIL reads
    the non-square ones through libtiff, a tile at a time) and under a
    FillOrder 2 tag that does not hold."""
    rng = np.random.default_rng(330 + 11 * sorted(CODECS).index(codec))
    p = tmp_path / "t.png"
    for _ in range(4):
        upright, turned, reversed_bits = _tiled(codec, rng)
        p.write_bytes(upright)
        assert _reads_as_reference(p) == "cv2"
        for data in (turned, reversed_bits):
            p.write_bytes(data)
            _reads_as_reference(p)


@pytest.mark.parametrize("codec", sorted(CODECS))
def test_ccitt_damage_reads_as_reference(tmp_path, codec):
    """Cut points of a strip-per-image file and of a file of many strips,
    and seeded byte and bit mutations of their data: the reference's
    pixels, max diff 0, or a raise where both refuse."""
    rng = np.random.default_rng(340 + sorted(CODECS).index(codec))
    p = tmp_path / "d.png"
    bits = _bits(rng, 24, 40)
    info = {292: 1} if codec == "g3" else {}
    sources = [_pillow(bits, CODECS[codec], info),
               _pillow(bits, CODECS[codec], {**info, 278: 5, 266: 2})]
    for data in sources:
        for cut in sorted(set(rng.integers(8, len(data), 14).tolist())):
            p.write_bytes(data[:cut])
            _reads_as_reference(p)
        for _ in range(24):
            d = bytearray(data)
            for _ in range(int(rng.integers(1, 4))):
                i = int(rng.integers(8, len(d)))
                d[i] = (int(rng.integers(0, 256)) if rng.random() < 0.5
                        else d[i] ^ (1 << int(rng.integers(0, 8))))
            p.write_bytes(bytes(d))
            _reads_as_reference(p)


def test_ccitt_layouts_read_as_reference(tmp_path):
    """The layouts libtiff's fax setup takes or refuses ("Bits/sample must
    be 1", one sample a pixel or separate planes) and what each reader
    makes of them: a 1-bit palette (cv2's palette routine), gray of 2, 4
    and 8 bits, two 1-bit samples contiguous and in separate planes, RGB;
    group 4 and group 3 data alike."""
    rng = np.random.default_rng(362)
    h, w = 10, 20
    img = _bits(rng, h, w)
    p = tmp_path / "l.png"
    readers = []
    for codec in ("group4", "group3"):
        strip = _first_strip(_pillow(img, codec))
        number = NUMBERS[codec]
        cases = [
            writers.tiff_file(img.astype(np.uint8), photometric=3, bits=1,
                              cmap=[0, 65535, 65535, 0, 0, 65535],
                              compression=number, strips=[strip]),
            writers.tiff_file(np.dstack([img, img]).astype(np.uint8),
                              bits=1, photometric=1, extra=[2],
                              compression=number, strips=[strip]),
            writers.tiff_file(np.dstack([img, img]).astype(np.uint8),
                              bits=1, photometric=1, extra=[2], planar=2,
                              compression=number, strips=[strip, strip]),
            writers.tiff_file(np.dstack([img] * 3).astype(np.uint8), bits=1,
                              photometric=2, compression=number,
                              strips=[strip])]
        for bits in (2, 4, 8):
            cases.append(writers.tiff_file(img.astype(np.uint8), bits=bits,
                                           photometric=1, compression=number,
                                           strips=[strip]))
        for data in cases:
            p.write_bytes(data)
            readers.append(_reads_as_reference(p))
    assert readers.count("cv2") == 2 and "none" in readers


def _group3(strips, h, w, rps, two_d=False):
    return writers.tiff_file(np.zeros((h, w), np.uint8), compression=3,
                             bits=1, rps=rps, photometric=0, strips=strips,
                             tags={292: (4, [1])} if two_d else None)


def test_group3_without_eols_reads_as_cv2(tmp_path):
    """Group 3 data whose EOLs are missing: in whole (libtiff then reads
    the rows as they come), after the first rows (the row where the data
    runs out is read again from the strip's first byte), in one strip of
    two (the mode stays set for the next strip), in 2-D data with its tag
    bits: cv2's pixels, max diff 0."""
    rng = np.random.default_rng(360)
    h, w = 12, 40
    img = _bits(rng, h, w)
    a = [chip_smoke.fax_changes(r) for r in img]
    one_d = [chip_smoke.fax_row_1d(x, w) for x in a]
    eol = chip_smoke.FAX_EOL

    def pack(s):
        s += "0" * (-len(s) % 8)
        return np.packbits(np.frombuffer(s.encode(), np.uint8) - 48).tobytes()

    two_d, ref = [], []
    for y, x in enumerate(a):
        two_d.append("1" + one_d[y] if y % 4 == 0
                     else "0" + chip_smoke.fax_row_2d(x, ref, w))
        ref = x
    files = {
        "none": _group3([pack("".join(one_d))], h, w, h),
        "first two": _group3([pack("".join(
            (eol if y < 2 else "") + r for y, r in enumerate(one_d)))], h, w, h),
        "strip 0 none": _group3([pack("".join(one_d[:6])),
                                 pack("".join(eol + r for r in one_d[6:]))],
                                h, w, 6),
        "strip 1 none": _group3([pack("".join(eol + r for r in one_d[:6])),
                                 pack("".join(one_d[6:]))], h, w, 6),
        "2-D none": _group3([pack("".join(two_d))], h, w, h, True),
        "2-D first three": _group3([pack("".join(
            (eol if y < 3 else "") + r for y, r in enumerate(two_d)))],
            h, w, h, True)}
    p = tmp_path / "g3.png"
    for name, data in files.items():
        p.write_bytes(data)
        assert _reads_as_reference(p) == "cv2", name


def test_rlew_at_odd_offsets_reads_as_reference(tmp_path):
    """RLE/W aligns each row to a 16-bit word of the file's mapping: strips
    at odd and even offsets (a byte appended to the first), read by cv2
    and, under orientation 6 of the non-square image, by PIL."""
    rng = np.random.default_rng(361)
    p = tmp_path / "w.png"
    for h, w in ((12, 30), (9, 23)):
        img = _bits(rng, h, w)
        strips = [_first_strip(_pillow(img[y:y + 4], "tiff_raw_16"))
                  for y in range(0, h, 4)]
        for pad in (b"", b"\0"):
            for orientation in (None, 6):
                p.write_bytes(writers.tiff_file(
                    img.astype(np.uint8), compression=32771, bits=1, rps=4,
                    photometric=1, strips=[strips[0] + pad] + strips[1:],
                    orientation=orientation))
                _reads_as_reference(p)


def test_fax_page_reads_as_its_bitmap(tmp_path):
    """chip_smoke.py's page, as group 4 and group 3 2-D from its T.6 / T.4
    coder: cv2.imread reads each as the bitmap it was built from, and the
    port decodes each to it."""
    h, w = chip_smoke.FAX_PAGE
    page = chip_smoke.fax_page(h, w, chip_smoke.SEED)
    assert 0.02 < page.mean() < 0.3
    p = tmp_path / "page.png"
    for group4 in (True, False):
        p.write_bytes(chip_smoke.fax_tiff(page, group4))
        want = np.repeat(np.where(page, 0, 255).astype(np.uint8)[:, :, None],
                         3, axis=2)
        np.testing.assert_array_equal(cv2.imread(str(p)), want)
        np.testing.assert_array_equal(native.decode(str(p)), want)


def test_ccitt_fixtures_cover_the_codecs():
    """The committed CCITT fixtures hold each codec, group 3 both 1-D and
    2-D, and PIL's RLE/W reads the same damaged image as cv2's."""
    fixtures = HERE / "data" / "images"
    seen = set()
    for p in sorted(fixtures.glob("tiff_*")):
        data = p.read_bytes()
        if data.startswith(b"II*\0"):
            tags = _tags(data)
            seen.add((tags.get(259, 1), tags.get(292, 0) & 1))
    assert {(2, 0), (3, 0), (3, 1), (4, 0), (32771, 0)} <= seen
    rlew = fixtures / "tiff_ccitt_rlew.png"
    np.testing.assert_array_equal(np.asarray(Image.open(rlew).convert("RGB")),
                                  cv2.imread(str(rlew))[:, :, ::-1])
    assert os.path.getsize(rlew) < 400
