"""TIFF (C7, TIFF part 1): classic TIFF, the first IFD, strips of 8-bit
gray, RGB or palette samples, uncompressed, PackBits, LZW (old-style codes
too) or deflate, with or without the horizontal predictor, read by the port
as the reference reads it (cv2.imread, else PIL's convert("RGB")), against
cv2, PIL and tsr_tpu on the CPU:

- every TIFF fixture of tests/data/images (Pillow's and cv2's writers, and
  files built by make_fixtures.tiff_file: big endian, the IFD first, an
  8-bit ColorMap, old-style LZW, orientation 3, no StripByteCounts, an LZW
  strip that breaks off) decodes equal to cv2.imread, max diff 0;
- orientations 1-8: cv2 flips 2-4 and gives None for 5-8, which PIL reads
  rotated (a gray or palette image of one uncompressed strip as Pillow
  maps it: at the rotated size first);
- every cut point of files whose IFD comes first, and seeded mutations of
  the IFD, the strip table and the compressed data: probe(reader="cv2")
  gives (0, 0) exactly where cv2.imread gives None, and decode equals cv2,
  else PIL, else raises; a mutation that makes a layout the port does not
  decode (TIFF part 2: other bits, Photometric, compression, planar
  configuration, extra samples, tiles, as Pillow parses the IFD) raises
  naming TIFF;
- the layouts of TIFF part 2 raise naming TIFF and probe (0, 0);
- load_canvas, both probes and generate_tree through both packages.

Max diff 0 throughout.
"""

import importlib.util
import io
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
TIFFS = [n for n in make_fixtures.CASES if n.startswith("tiff_")]
TIFF_SKIPS = [n for n in make_fixtures.SKIP_CASES if n.startswith("tiff_")]
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


def _part2(data):
    """True where Pillow's parse of the first IFD shows a layout the port
    does not decode (TIFF part 2); False where it shows one it decodes or
    does not parse."""
    try:
        f = io.BytesIO(data)
        ifd = TiffImagePlugin.ImageFileDirectory_v2(f.read(8))
        f.seek(ifd.next)
        ifd.load(f)
    except Exception:
        return False
    get = ifd.get
    bps, sf = get(258, (1,)), get(339, (1,))
    bps = bps if isinstance(bps, tuple) else (bps,)
    sf = sf if isinstance(sf, tuple) else (sf,)
    spp = get(277, 1)
    part1 = (get(259, 1) in (1, 5, 8, 32773, 32946)
             and (get(262), spp) in ((1, 1), (2, 3), (3, 1))
             and set(bps) == {8} and len(bps) in (1, spp)
             and not get(338, ()) and get(284, 1) == 1 and get(266, 1) == 1
             and set(sf) == {1} and 322 not in ifd and 323 not in ifd)
    return not part1


def _reads_as_reference(path):
    """probe(reader="cv2") is cv2's (h, w), (0, 0) where cv2 gives None or
    raises (and marked where it raises); decode equals cv2, else PIL, max
    diff 0, else raises; where the port raises naming TIFF, the layout is
    one of TIFF part 2. Returns the reader."""
    data = Path(path).read_bytes()
    reader, want = _reference(path)
    (dims,), (raised,) = native.probe([str(path)], reader="cv2", raises=True)
    try:
        got, err = native.decode(str(path)), ""
    except RuntimeError as e:
        got, err = None, str(e)
    if "holds TIFF data" in err:  # raising, as the reference does, or
        assert dims.tolist() == [0, 0] and not raised  # on a part 2 layout
        assert reader == "none" or _part2(data), (reader, path)
        return "tiff part 2"
    assert dims.tolist() == (list(want.shape[:2]) if reader == "cv2"
                             else [0, 0]), (reader, path)
    assert bool(raised) == (reader == "raise")
    if want is None:
        assert got is None, path
        return reader
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
    """The fixtures hold both byte orders, every compression (none,
    PackBits, LZW, both deflates), predictor 2, gray, RGB and palette, one
    strip and many, the IFD first and last, and the 8-bit ColorMap rule
    (where PIL's pixels differ from cv2's)."""
    seen = set()
    for name in TIFFS:
        data = (FIXTURES / name).read_bytes()
        f = io.BytesIO(data)
        ifd = TiffImagePlugin.ImageFileDirectory_v2(f.read(8))
        at = ifd.next
        f.seek(at)
        ifd.load(f)
        seen |= {("order", data[:2]), ("compression", ifd[259]),
                 ("photometric", ifd[262]), ("predictor", ifd.get(317, 1)),
                 ("strips", len(ifd[273]) > 1),
                 ("ifd_first", at < min(ifd[273]))}
    for key in (("order", b"II"), ("order", b"MM"), ("compression", 1),
                ("compression", 5), ("compression", 8),
                ("compression", 32773), ("compression", 32946),
                ("photometric", 1), ("photometric", 2), ("photometric", 3),
                ("predictor", 2), ("strips", True), ("strips", False),
                ("ifd_first", True), ("ifd_first", False)):
        assert key in seen, key
    p = FIXTURES / "tiff_colormap_8bit.png"
    pil = np.asarray(Image.open(p).convert("RGB"))
    assert not np.array_equal(pil, native.decode(str(p)))


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
             "tiff_orientation_3.png", "skip/tiff_orientation_6.png")


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
    """The [lo, hi) byte spans of a file's IFD, of its strip table (the
    StripOffsets and StripByteCounts entries, and their arrays where they
    lie outside the IFD) or of its strips."""
    def spans(data):
        e = ">" if data[:2] == b"MM" else "<"
        at = struct.unpack(e + "I", data[4:8])[0]
        n = struct.unpack(e + "H", data[at:at + 2])[0]
        if where == "ifd":
            return [(at, at + 2 + 12 * n + 4)]
        table, arrays = [], {}
        for k in range(n):
            pos = at + 2 + 12 * k
            tag, typ, count, value = struct.unpack(e + "HHII",
                                                   data[pos:pos + 12])
            if tag not in (273, 279):
                continue
            fmt = e + ("H" if typ == 3 else "I") * count
            size = struct.calcsize(fmt)
            table.append((pos, pos + 12))
            if size > 4:
                table.append((value, value + size))
                arrays[tag] = struct.unpack(fmt, data[value:value + size])
            else:
                arrays[tag] = struct.unpack(fmt, data[pos + 8:pos + 8 + size])
        if where == "strip table":
            return table
        if 279 not in arrays:  # the counts estimated: to the file's end
            return [(min(arrays[273]), len(data))]
        return [(o, o + c) for o, c in zip(arrays[273], arrays[279])]
    return spans


MUTATION_SEEDS = sorted(FIXTURES / n for n in TIFFS) + sorted(
    FIXTURES / "skip" / n for n in ("tiff_orientation_6.png",
                                    "tiff_byte_count_0.png"))


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


# ---------------------------------------------------------- TIFF part 2

def _part2_files():
    rng = np.random.default_rng(50)
    img = make_fixtures.smooth(rng, 12, 16)
    out = {}
    for mode in ("1", "RGBA", "CMYK", "I;16"):
        out[mode] = make_fixtures.pil_tiff(img, mode)
    out["jpeg"] = make_fixtures.pil_tiff(img, "RGB", compression="jpeg")
    out["minisWhite"] = make_fixtures.tiff_file(make_fixtures.gray(img),
                                                photometric=0)
    out["planar 2"] = make_fixtures.tiff_file(
        make_fixtures.gray(img), tags={284: (3, [2])})
    out["bigtiff"] = b"II+\0" + bytes(12)
    return out


@pytest.mark.parametrize("name", sorted(_part2_files()))
def test_part2_layouts_raise_naming_tiff(tmp_path, name):
    """1-bit, RGBA (an extra sample), CMYK, 16-bit, JPEG-compressed,
    MINISWHITE, planar configuration 2 and BigTIFF data: cv2 reads each
    (the planar file as gray), the port does not decode it: decode and the
    header probe raise naming TIFF, the cv2 probe gives (0, 0)."""
    p = tmp_path / "p2.png"
    p.write_bytes(_part2_files()[name])
    if name != "bigtiff":
        assert cv2.imread(str(p)) is not None
    with pytest.raises(RuntimeError, match="holds TIFF data"):
        native.decode(str(p))
    with pytest.raises(RuntimeError, match="holds TIFF data"):
        native.probe([str(p)])
    assert native.probe([str(p)], reader="cv2").tolist() == [[0, 0]]


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
