"""The PNG, PNM, PAM, BMP, GIF, Sun raster, PFM and Radiance HDR files the
reference reads (cv2.imread, else PIL's convert("RGB")) and the port once
refused or read differently, against cv2, PIL and tsr_tpu on the CPU:

- C5: ASCII P1-P3 (rescaled to 8 bits), bitmap P4 and PAM P7 of every
  TUPLTYPE, with cv2's quirks;
- C6: 16-bit BMP (5-5-5, and 5-6-5 as BI_BITFIELDS), 32-bit BI_BITFIELDS
  with a V5 header, the OS/2 core header, RLE8 and RLE4;
- C4: damaged files: probe(reader="cv2") gives (0, 0) exactly where
  cv2.imread gives None (cut anywhere, a bad critical CRC, a damaged zlib
  stream, a cut ASCII body or RLE stream...), and decode gives cv2's
  pixels, else PIL's, else raises; generate_tree skips what the reference
  skips;
- C7, part 1: GIF (OpenCV's own decoder: the whole file walked, the canvas
  in the background colour, a transparent pixel keeping it) and Sun raster
  (cv2's 1/8/24/32-bit raw files, PIL's RT_BYTE_ENCODED and RT_FORMAT_RGB,
  which OpenCV 5 refuses), cut and mutated too;
- C7, part 2: PFM (cv2's colour "PF": big or little endian by the scale's
  sign, divided by its magnitude, rounded half to even with NaN, infinities
  and values past the int range reading 0; PIL's gray "Pf", which cv2
  refuses under IMREAD_COLOR: truncated) and Radiance HDR (run-length
  encoded and flat, x 255 and rounded), cut and mutated too;
- C7: AVIF and JPEG 2000 data (a JP2 file and a raw codestream) under
  .png/.jpg names, and a ZSTD-compressed TIFF, raise naming their format
  (the port does not decode them); the TIFF fixtures themselves are
  tests/test_torch_port_tiff.py's;
- C8, the first step: the formats only Pillow reads (its own writers'
  files, named .png) raise naming the format where Pillow's checks of the
  first bytes tell it (TGA and XBM, which have none the port copies, raise
  unnamed); the cv2 probe gives (0, 0).

The fixtures are tests/data/images (make_fixtures.py): sides 4 to 400.
"""

import importlib.util
import re
from pathlib import Path

import cv2
import jax
import numpy as np
import pytest
import torch
from PIL import Image

from tsr_tpu import checkpoint as jckpt
from tsr_tpu import infer as jinfer
from tsr_tpu import offline as joffline
from tsr_tpu.data import gtsrb as jgtsrb
from tsr_tpu.models import ResUNet as JResUNet
from tsr_tpu_torch import infer as tinfer
from tsr_tpu_torch import native, offline, parity
from tsr_tpu_torch.data import gtsrb
from tsr_tpu_torch.models import ResUNet

FIXTURES = Path(__file__).resolve().parent / "data" / "images"
_spec = importlib.util.spec_from_file_location(
    "image_fixtures", FIXTURES / "make_fixtures.py")
make_fixtures = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(make_fixtures)

torch.set_num_threads(2)
HI = jax.lax.Precision.HIGHEST
SIZE = 32
EXPECTED = np.load(FIXTURES / "expected.npz")
quiet = lambda s: None  # noqa: E731


def _reference(path):
    """(reader, RGB) of what the reference reads: ("cv2", ...), ("pil",
    ...), or ("none", None) where both refuse (or cv2 raises)."""
    try:
        img = cv2.imread(str(path))
    except cv2.error:
        return "none", None
    if img is not None:
        return "cv2", img[:, :, ::-1]
    try:
        return "pil", np.asarray(Image.open(path).convert("RGB"))
    except Exception:
        return "none", None


def _reads_as_reference(path):
    """probe(reader="cv2") is cv2's (h, w), (0, 0) where cv2 gives None;
    decode equals cv2 (on the pixels cv2 writes), else PIL, max diff 0,
    else raises."""
    data = Path(path).read_bytes()
    reader, want = _reference(path)
    probe = native.probe([str(path)], reader="cv2").tolist()
    assert probe == [list(want.shape[:2]) if reader == "cv2" else [0, 0]]
    if want is None:
        with pytest.raises(RuntimeError):
            native.decode(str(path))
        return reader
    got = native.decode(str(path))
    assert got.shape == want.shape
    mask = (make_fixtures.cv2_written(data, want.shape[:2])
            if reader == "cv2" else np.ones(want.shape[:2], bool))
    np.testing.assert_array_equal(got[mask], want[mask], err_msg=str(path))
    return reader


CASES = list(make_fixtures.CASES)
SKIPS = list(make_fixtures.SKIP_CASES)


@pytest.mark.parametrize("name", CASES)
def test_fixture_decodes_as_cv2(name):
    """Every C5/C6 fixture (and the PNGs libpng reads with a warning):
    decode equals expected.npz (cv2.imread's pixels, those it leaves
    unwritten 0), max diff 0; the cv2-reader probe and the header probe
    give its (h, w); load_batch reads it."""
    p = str(FIXTURES / name)
    want = EXPECTED[f"decoded__{name}"]
    np.testing.assert_array_equal(native.decode(p), want)
    for reader in ("cv2", "port"):
        assert native.probe([p], reader=reader).tolist() == [
            list(want.shape[:2])]
    assert native.load_batch([p], SIZE).shape == (1, SIZE, SIZE, 3)


@pytest.mark.parametrize("name", SKIPS)
def test_skip_class_reads_as_reference(name):
    """Each file cv2.imread gives None for: probe(reader="cv2") gives
    (0, 0); decode gives PIL's pixels where PIL reads it
    (decoded_skip__<name>) and raises where it does not."""
    p = str(FIXTURES / "skip" / name)
    assert native.probe([p], reader="cv2").tolist() == [[0, 0]]
    key = f"decoded_skip__{name}"
    if key in EXPECTED.files:
        np.testing.assert_array_equal(native.decode(p), EXPECTED[key])
    else:
        with pytest.raises(RuntimeError, match="failed to decode"):
            native.decode(p)
        with pytest.raises(RuntimeError, match="decoded 0/1"):
            native.load_batch([p], SIZE)


@pytest.mark.parametrize("name,fmt,cv2_reads", [
    ("avif.png", "AVIF", True), ("jp2.jpg", "JPEG 2000", False),
    ("tiff_zstd.png", "TIFF", False), ("j2k.png", "JPEG 2000", False)])
def test_foreign_format_raises_naming_it(name, fmt, cv2_reads):
    """C7: data of a format the port does not decode (AVIF, which cv2
    reads by its signature), a JPEG 2000 file of the feature it leaves out
    (sub-sampled components, which cv2 refuses) or a TIFF layout it does
    not decode (ZSTD, which only PIL reads), raises naming the format on
    every reader path; the probes refuse it; cv2 reads it or not as
    ``cv2_reads`` says."""
    p = str(FIXTURES / "skip" / name)
    assert (cv2.imread(p) is not None) == cv2_reads
    match = f"holds {fmt} data, which the port does not decode"
    with pytest.raises(RuntimeError, match=match):
        native.decode(p)
    with pytest.raises(RuntimeError, match=match):
        native.load_batch([p], SIZE)
    with pytest.raises(RuntimeError, match=match):
        native.load_canvas([p], np.zeros((1, 64, 64, 3), np.uint8))
    with pytest.raises(RuntimeError, match=match):
        native.probe([p])
    assert native.probe([p], reader="cv2").tolist() == [[0, 0]]


def test_committed_fixtures_equal_cv2_and_pil(tmp_path):
    """The committed files still equal what make_fixtures writes here, and
    expected.npz what cv2 and PIL read from them (cv2's unwritten PAM
    pixels aside), and the reference's generate_tree count."""
    fresh = make_fixtures.make(tmp_path)
    assert sorted(fresh) == sorted(EXPECTED.files)
    for key in EXPECTED.files:
        np.testing.assert_array_equal(fresh[key], EXPECTED[key], err_msg=key)
    for name in CASES:
        p = FIXTURES / name
        assert p.read_bytes() == (tmp_path / name).read_bytes(), name
        img = cv2.imread(str(p))[:, :, ::-1]
        mask = make_fixtures.cv2_written(p.read_bytes(), img.shape[:2])
        np.testing.assert_array_equal(img[mask],
                                      EXPECTED[f"decoded__{name}"][mask])
    for name in SKIPS + list(make_fixtures.FOREIGN):
        p = FIXTURES / "skip" / name
        assert p.read_bytes() == (tmp_path / "skip" / name).read_bytes()
    assert int(EXPECTED["generate_tree_written"]) == len(CASES)
    assert sum(p.stat().st_size for p in FIXTURES.rglob("*")
               if p.is_file()) < 400 * 1024


# ------------------------------------------------------ C7: GIF and Sun

# fixtures where cv2's rule and PIL's give different pixels: the port
# gives cv2's (PIL paints a transparent index and the area outside the
# frame in palette colours, reads a 1-bit Sun raster inverted and a 32-bit
# one's bytes 0-2)
DIFFERING = ("gif_transparent.png", "gif_frame_offset.png", "sun_1bit.ppm",
             "sun_32bit.ppm")


@pytest.mark.parametrize("name", DIFFERING)
def test_gif_and_sun_follow_cv2_where_pil_differs(name):
    """decode equals cv2.imread's pixels on files where PIL's differ (so
    the fixture tells the two rules apart), max diff 0."""
    p = str(FIXTURES / name)
    want = cv2.imread(p)[:, :, ::-1]
    pil = np.asarray(Image.open(p).convert("RGB"))
    assert pil.shape != want.shape or not np.array_equal(pil, want)
    np.testing.assert_array_equal(native.decode(p), want)


GIF_SUN = [n for n in CASES if n.startswith(("gif_", "sun_"))] + [
    "skip/" + n for n in SKIPS if n.startswith(("gif_", "sun_"))
    and f"decoded_skip__{n}" in EXPECTED.files]


def _canvas_and_probe(name):
    """load_canvas puts decode's pixels at the top-left of the slot and
    zeros around them; the header probe gives the decoded (h, w) where cv2
    reads the file."""
    p = str(FIXTURES / name)
    img = native.decode(p)
    h, w = img.shape[:2]
    out = np.full((1, h + 3, w + 5, 3), 7, np.uint8)
    assert native.load_canvas([p], out).tolist() == [[h, w]]
    np.testing.assert_array_equal(out[0, :h, :w], img)
    assert not out[0, h:].any() and not out[0, :, w:].any()
    if not name.startswith("skip/"):
        assert native.probe([p]).tolist() == [[h, w]]


@pytest.mark.parametrize("name", GIF_SUN)
def test_gif_and_sun_load_canvas_and_probe(name):
    """Each readable GIF and Sun raster (cv2's, and PIL's where cv2
    refuses): load_canvas puts decode's pixels at the top-left of its slot
    and zeros around them; the header probe gives the decoded (h, w) where
    cv2 reads the file (it reads cv2's header first, so a GIF whose frame
    leaves the screen probes at the screen's size)."""
    _canvas_and_probe(name)


# -------------------------------------------------- C7: PFM and Radiance

PFM_HDR = [n for n in CASES if n.startswith(("pfm", "hdr_"))] + [
    "skip/" + n for n in SKIPS if n.startswith(("pfm", "hdr_"))
    and f"decoded_skip__{n}" in EXPECTED.files]


@pytest.mark.parametrize("name", PFM_HDR)
def test_pfm_and_hdr_load_canvas_and_probe(name):
    """Each readable PFM and Radiance HDR (cv2's, and the gray PFM PIL
    reads where cv2 refuses it): load_canvas puts decode's pixels at the
    top-left of its slot and zeros around them; the header probe gives the
    decoded (h, w) where cv2 reads the file."""
    _canvas_and_probe(name)


def _cv2_u8(v):
    """cv::saturate_cast<uchar>(float): half to even, NaN, infinities and
    values past the int range 0."""
    v = np.asarray(v, np.float32)
    inside = (v > -2.0 ** 31) & (v < 2.0 ** 31)
    return np.where(inside, np.clip(np.rint(np.where(inside, v, 0)), 0, 255),
                    0).astype(np.uint8)


def _pfm_model(data):
    """A PFM file's pixels as the two readers' arithmetic gives them, from
    numpy: colour "PF" as cv2 (samples x (float)(1 / |scale|), rounded);
    gray "Pf" as PIL's convert("RGB") (truncated, clamped, NaN 0)."""
    fields = re.match(rb"P([Ff])\n(\S+)\s(\S+)\s(\S+)\s", data)
    w, h, scale = int(fields[2]), int(fields[3]), float(fields[4])
    ch = 3 if fields[1] == b"F" else 1
    body = np.frombuffer(data, ">f4" if scale >= 0 else "<f4",
                         w * h * ch, fields.end()).reshape(h, w, ch)[::-1]
    if ch == 3:
        return _cv2_u8(body * np.float32(1 / abs(scale)))
    with np.errstate(invalid="ignore"):
        gray = np.where(np.isnan(body), 0, np.clip(body, 0, 255))
    return np.repeat(gray.astype(np.uint8), 3, axis=2)


def _hdr_flat_model(data):
    """A flat Radiance HDR's pixels as cv2's arithmetic gives them, from
    numpy: R, G, B x (float)2^(e - 136), x 255, rounded (0 where e is
    0)."""
    head, res = re.match(rb"(.*?\n\n)(-Y (\d+) \+X (\d+)\n)", data,
                         re.S).groups()[:2]
    h, w = map(int, re.match(rb"-Y (\d+) \+X (\d+)", res).groups())
    px = np.frombuffer(data, np.uint8, w * h * 4, len(head) + len(res))
    px = px.reshape(h, w, 4)
    f = np.ldexp(1.0, px[..., 3:].astype(int) - 136).astype(np.float32)
    v = px[..., :3].astype(np.float32) * f * np.float32(255)
    return np.where(px[..., 3:] > 0, _cv2_u8(v), 0).astype(np.uint8)


PFM_HDR_ARITHMETIC = [n for n in CASES if n.startswith("pfm")] + [
    "hdr_flat.png", "hdr_narrow.png", "skip/pfm_gray.png",
    "skip/pfm_gray_big_endian.ppm"]


@pytest.mark.parametrize("name", PFM_HDR_ARITHMETIC)
def test_pfm_and_hdr_arithmetic(name):
    """decode equals the readers' arithmetic rebuilt in numpy from the
    file's bytes: cv2 scales a PFM by 1 / |scale| and a Radiance HDR by 255
    (so a PFM of samples 0-255 reads back whole), rounds half to even and
    reads NaN, infinities and values past 2^31 as 0; PIL truncates a gray
    PFM; and the fixture's pixels are not all 0 and 1."""
    data = (FIXTURES / name).read_bytes()
    want = _pfm_model(data) if data.startswith(b"P") else _hdr_flat_model(
        data)
    got = native.decode(str(FIXTURES / name))
    np.testing.assert_array_equal(got, want)
    assert got.max() > 1


def test_foreign_formats_match_codec_header():
    """native.FORMATS names codec.h's foreign-format statuses in their
    order (after FEATURES), so _failure names the format a status means;
    GIF, Sun raster, PFM, Radiance HDR and WebP are gone from both."""
    header = (Path(native.__file__).parent / "codec.h").read_text()
    start = header.index("enum Status")
    enum = header[start:header.index("};", start)]
    codes = [int(v) for v in re.findall(r"= (-\d+),", enum)]
    assert codes == list(range(-1, -len(native.FEATURES)
                               - len(native.FORMATS) - 1, -1))
    assert native.FORMATS == ("TIFF", "JPEG 2000", "AVIF", "PCX", "SGI",
                              "ICO/CUR", "DDS", "QOI", "ICNS", "MSP", "IM",
                              "SPIDER")
    assert "kGif" not in enum and "kSunRaster" not in enum
    assert "kWebp" not in enum and "WebP" not in native.FORMATS
    assert "kPfm" not in enum and "kHdr" not in enum
    for status, fmt in enumerate(native.FORMATS, len(native.FEATURES) + 1):
        assert f"holds {fmt} data" in str(native._failure("x", -status))


# ----------------------------------------------- C8: Pillow-only formats

# C8's record: Pillow's writers, each file named .png; the name the port
# gives (None: "failed to decode", no check of Pillow's that the port
# copies tells the format)
PIL_ONLY = {"TGA": None, "PCX": "PCX", "SGI": "SGI", "ICO": "ICO/CUR",
            "IM": "IM", "DDS": "DDS", "MSP": "MSP", "XBM": None,
            "SPIDER": "SPIDER", "QOI": "QOI", "ICNS": "ICNS"}


@pytest.mark.parametrize("fmt", sorted(PIL_ONLY))
def test_pil_only_format_raises_naming_it(tmp_path, fmt):
    """A 20 x 24 image saved by Pillow in a format cv2 does not read and
    the port does not decode: cv2 gives None, PIL reads it, the cv2 probe
    gives (0, 0), and decode, load_batch and the header probe raise naming
    the format where Pillow's own check of the first bytes tells it."""
    img = Image.fromarray(make_fixtures.smooth(np.random.default_rng(60),
                                               20, 24))
    img = img.convert({"MSP": "1", "XBM": "1", "SPIDER": "F"}.get(fmt, "RGB"))
    p = tmp_path / f"{fmt.lower()}.png"
    # Pillow's SPIDER writer registers the file's suffix (.png) as SPIDER
    # for the rest of the process: later saves of .png files would write
    # SPIDER; its table is put back as it was
    extensions = dict(Image.EXTENSION)
    try:
        img.save(p, fmt)
    finally:
        Image.EXTENSION.clear()
        Image.EXTENSION.update(extensions)
    assert cv2.imread(str(p)) is None
    assert Image.open(p).format == fmt
    Image.open(p).convert("RGB")
    name = PIL_ONLY[fmt]
    match = (f"holds {name} data, which the port does not decode" if name
             else "failed to decode")
    with pytest.raises(RuntimeError, match=match):
        native.decode(str(p))
    with pytest.raises(RuntimeError, match=match):
        native.load_batch([str(p)], SIZE)
    with pytest.raises(RuntimeError, match=match if name else "image headers"):
        native.probe([str(p)])
    assert native.probe([str(p)], reader="cv2").tolist() == [[0, 0]]


# ------------------------------------------------------------ C4: cuts

# one file of each class: PNG, PNM ASCII, PAM, BMP raw and RLE, GIF (plain,
# interlaced with a transparent index, a frame inside a larger screen), Sun
# raster (raw, and the RLE PIL reads), PFM (cv2's colour, PIL's gray) and
# Radiance HDR (run-length encoded, flat, and RLE falling back to flat)
CUT_FILES = ("png_text_bad_crc.png", "p3_max255.ppm", "p1_ascii.ppm",
             "pam_rgb.ppm", "bmp16_565_bitfields.bmp", "bmp_rle8.bmp",
             "bmp_rle4.bmp", "gif_mid_clear.png", "gif_transparent.png",
             "gif_frame_offset.png", "sun_8bit_map.ppm",
             "skip/sun_rle8.ppm", "pfm_big_endian.ppm", "skip/pfm_gray.png",
             "hdr_rle.png", "hdr_narrow.png", "hdr_flat_fallback.png")


def _cut_cases():
    cases = []
    for name in CUT_FILES:
        n = len((FIXTURES / name).read_bytes())
        cuts = sorted(set(np.linspace(0, n, 21, dtype=int)[:-1].tolist()
                          + [n - k for k in (1, 2, 3, 5, 8, 13)]))
        cases += [(name, c) for c in cuts]
    return cases


@pytest.mark.parametrize("name,cut", _cut_cases())
def test_cut_file_reads_as_reference(tmp_path, name, cut):
    """A fixture cut short: probe(reader="cv2") is (0, 0) exactly where
    cv2.imread gives None (a cut PNG anywhere before IEND's end, a cut
    ASCII body, an RLE stream that stops before its last row is done, a
    raw body short of its last row's padding, a GIF cut anywhere before its
    trailer), and decode equals cv2, else PIL (which reads a PNG cut after
    its image data, a BMP or Sun raster short of the last row's padding, a
    GIF cut after its first frame), else raises."""
    p = tmp_path / Path(name).name
    p.write_bytes((FIXTURES / name).read_bytes()[:cut])
    _reads_as_reference(p)


# -------------------------------------------------------- C4: mutations

@pytest.mark.parametrize("seed", range(8))
def test_mutated_files_read_as_reference(tmp_path, seed):
    """60 files a seed, each a fixture (readable or damaged) with bytes
    overwritten, flipped, cut, inserted or deleted, or set to a byte the
    parsers care about: where cv2 reads one, the port's probe and decode
    equal it; where only PIL does, decode equals PIL and the probe refuses
    it; where neither does, both refuse it."""
    seeds = [p for p in sorted(FIXTURES.glob("*.*")) + sorted(
        (FIXTURES / "skip").glob("*.*"))
        if p.suffix != ".py" and p.suffix != ".npz"
        and p.name not in make_fixtures.FOREIGN
        and not p.name.startswith("tiff")]  # test_torch_port_tiff.py's
    _mutate_and_check(tmp_path, np.random.default_rng(2000 + seed), seeds,
                      [0, 255, 32, 10, 35, 48, 49], 160)


def _mutate_and_check(tmp_path, rng, seeds, values, head_bytes, words=()):
    """60 files from ``seeds``: bytes overwritten, flipped, cut, inserted or
    deleted, set to one of ``values`` or, with ``words``, one of them
    inserted (half of them in the first ``head_bytes``), each read as the
    reference reads it."""
    for k in range(60):
        src = seeds[int(rng.integers(len(seeds)))]
        data = bytearray(src.read_bytes())
        kind = int(rng.integers(7 if words else 6))
        head = rng.integers(2) == 0
        for _ in range(int(rng.integers(1, 4))):
            i = int(rng.integers(2, min(len(data), head_bytes) if head
                                 else len(data)))
            if kind == 0:
                data[i] = int(rng.integers(256))
            elif kind == 1:
                data = data[:max(i, 8)]
            elif kind == 2:
                data[i] ^= 1 << int(rng.integers(8))
            elif kind == 3:
                data[i:i] = bytes(rng.integers(0, 256, int(rng.integers(1, 4)),
                                               dtype=np.uint8))
            elif kind == 4:
                del data[i:i + 1 + int(rng.integers(16))]
            elif kind == 5:
                data[i] = int(rng.choice(values))
            else:
                data[i:i] = words[int(rng.integers(len(words)))]
        p = tmp_path / f"m{k}{src.suffix}"
        p.write_bytes(bytes(data))
        _reads_as_reference(p)


# the header words and bytes the PFM and Radiance readers care about
PFM_HDR_WORDS = (b"FORMAT=32-bit_rle_rgbe\n", b"\n", b"#", b"-Y ", b"+X ",
                 b" ", b"nan", b"inf", b"-", b"\0", b"1e5", b"_", b"\r",
                 b"\t", b"\x02\x02", b"\x81")


@pytest.mark.parametrize("seed", range(4))
def test_mutated_pfm_and_hdr_read_as_reference(tmp_path, seed):
    """60 files a seed, each a PFM or Radiance HDR fixture (readable or
    damaged) mutated as above, or with a header word inserted (a FORMAT
    line, a line feed, a sign, NaN, a NUL, an RLE scanline start...): the
    port's probe and decode read it as the reference reads it."""
    seeds = [p for p in sorted(FIXTURES.glob("*.*")) + sorted(
        (FIXTURES / "skip").glob("*.*"))
        if p.name.startswith(("pfm", "hdr_"))]
    _mutate_and_check(tmp_path, np.random.default_rng(3000 + seed), seeds,
                      [0, 255, 32, 10, 13, 35, 48, 49, 2, 128, 129, 45],
                      60, PFM_HDR_WORDS)


# ------------------------------------------------------- generate_tree

def _motivation_tree(root: Path) -> Path:
    """Seven .ppm files: five P6 written by cv2, one of them cut in half,
    and an ASCII P2 (the reference writes 6)."""
    rng = np.random.default_rng(70)
    for k in range(6):
        p = root / f"0000{k % 2}" / f"img{k}.ppm"
        p.parent.mkdir(parents=True, exist_ok=True)
        cv2.imwrite(str(p), make_fixtures.smooth(rng, 28 + k, 30 - k))
    cut = root / "00000" / "img2.ppm"
    cut.write_bytes(cut.read_bytes()[:len(cut.read_bytes()) // 2])
    img = make_fixtures.smooth(rng, 25, 31)
    (root / "00001" / "ascii.ppm").write_bytes(
        make_fixtures.pnm_ascii(2, make_fixtures.gray(img), 255))
    return root


def _fixture_tree(root: Path) -> Path:
    """Every CASES and SKIP_CASES file in a three-class tree."""
    files = [FIXTURES / n for n in CASES] + [FIXTURES / "skip" / n
                                              for n in SKIPS]
    for k, p in enumerate(files):
        out = root / f"c{k % 3}" / p.name
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_bytes(p.read_bytes())
    return root


@pytest.mark.parametrize("tree", ["motivation", "fixtures"])
def test_generate_tree_writes_what_the_reference_writes(tmp_path, tree):
    """generate_tree("noise") through both packages: the same count, the
    same file names, and the port's log counts the rest as skipped; on
    the seven-file tree (a cut .ppm, an ASCII .ppm) 6 files, where the
    port once raised in the batch."""
    src = (_motivation_tree if tree == "motivation" else _fixture_tree)(
        tmp_path / "src")
    lines = []
    n = offline.generate_tree(str(src), str(tmp_path / "ours"), "noise",
                              log=lines.append, device="cpu")
    m = joffline.generate_tree(str(src), str(tmp_path / "ref"), "noise",
                               log=quiet)
    total = len(offline.tree_files(str(src)))
    want = 6 if tree == "motivation" else int(
        EXPECTED["generate_tree_written"])
    assert n == m == want
    assert f"Skipped {total - want} unreadable files" in lines
    ours = sorted(str(p.relative_to(tmp_path / "ours"))
                  for p in (tmp_path / "ours").glob("*/*"))
    ref = sorted(str(p.relative_to(tmp_path / "ref"))
                 for p in (tmp_path / "ref").glob("*/*"))
    assert ours == ref and len(ours) == want


# --------------------------------------------------------- reader paths

# the readable fixtures whose pixels cv2 writes whole, and the damaged
# files PIL reads (the reference's fallback)
READABLE = [FIXTURES / n for n in CASES
            if not n.startswith(("pam_gray_alpha", "pam_rgb_alpha"))] + [
    FIXTURES / "skip" / k.split("__", 1)[1] for k in EXPECTED.files
    if k.startswith("decoded_skip__")]


@pytest.mark.parametrize("resize", ["cv2", "pil"])
def test_decode_resize_and_image_folder_match_reference(tmp_path, resize):
    """gtsrb._decode_resize at SIZE within 1 LSB of tsr_tpu's (cv2.imread,
    else PIL, then its resize) on every readable fixture, and the port's
    ImageFolder loads them as tsr_tpu's does."""
    old = (gtsrb.RESIZE_BACKEND, jgtsrb.RESIZE_BACKEND)
    try:
        gtsrb.set_resize_backend(resize)
        jgtsrb.set_resize_backend(resize)
        for p in READABLE:
            got = gtsrb._decode_resize(str(p), SIZE).astype(int)
            want = jgtsrb._decode_resize(str(p), SIZE).astype(int)
            assert np.abs(got - want).max() <= 1, p.name
        root = tmp_path / "tree"
        for k, p in enumerate(READABLE):
            out = root / f"c{k % 2}" / p.name
            out.parent.mkdir(parents=True, exist_ok=True)
            out.write_bytes(p.read_bytes())
        ours, ref = gtsrb.ImageFolder(str(root), SIZE), jgtsrb.ImageFolder(
            str(root), SIZE)
        assert len(ours) == len(ref) == len(READABLE)
        for i in range(len(ref)):
            (a, la), (b, lb) = ours.load(i), ref.load(i)
            assert la == lb and np.abs(a.astype(int) - b).max() <= 1
    finally:
        gtsrb.set_resize_backend(old[0])
        jgtsrb.set_resize_backend(old[1])


def test_restore_tree_decodes_as_reference(tmp_path):
    """restore_tree (host resize, metrics on, PIL's resize in both
    packages, so the resized inputs are bit-equal) through both packages on
    the readable fixtures with a pass-through restorer (its input plus
    parity.OFFSET, so the restored files show every decoded pixel): the
    restored PNGs equal tsr_tpu's and the PSNR/SSIM agree."""
    root = tmp_path / "src"
    for k, p in enumerate(READABLE):
        out = root / f"c{k % 2}" / p.name
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_bytes(p.read_bytes())
    torch.manual_seed(6)
    tr = parity.pass_through(ResUNet(widths=(8, 16, 32),
                                     bottleneck_width=64)).eval()
    jr = JResUNet(widths=(8, 16, 32), bottleneck_width=64, precision=HI)
    jrv = jckpt.resunet_from_pth({k: v.numpy() for k, v in
                                  tr.state_dict().items()})
    kw = dict(clean_dir=str(root), batch_size=8, size=SIZE, log=quiet,
              resize="host")
    old = (gtsrb.RESIZE_BACKEND, jgtsrb.RESIZE_BACKEND)
    try:
        gtsrb.set_resize_backend("pil")
        jgtsrb.set_resize_backend("pil")
        ours = tinfer.restore_tree(tr, str(root), str(tmp_path / "ours"),
                                   device="cpu", **kw)
        ref = jinfer.restore_tree(jr.apply, jrv, str(root),
                                  str(tmp_path / "ref"),
                                  has_batch_stats=True, **kw)
    finally:
        gtsrb.set_resize_backend(old[0])
        jgtsrb.set_resize_backend(old[1])
    files = sorted((tmp_path / "ref").glob("*/*.png"))
    assert len(files) == len(READABLE) == ours["images"]
    for p in files:
        mine = tmp_path / "ours" / p.relative_to(tmp_path / "ref")
        np.testing.assert_array_equal(cv2.imread(str(mine)),
                                      cv2.imread(str(p)), err_msg=p.name)
    assert ours["psnr"] == pytest.approx(ref["psnr"], abs=1e-4)
    assert ours["ssim"] == pytest.approx(ref["ssim"], abs=1e-5)
