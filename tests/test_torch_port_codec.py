"""The port's own codec against cv2 and tsr_tpu on the CPU: JPEG decode
(every sampling factor cv2 writes, qualities, progressive, optimized
Huffman, restart intervals, gray, EXIF orientation, Adobe RGB), JPEG and
BMP encode, the PNG/PPM/BMP variants cv2.imread reads, the features the
decoder once refused (read now where cv2 or PIL reads them), the committed
fixtures, and JPEG trees through
generate_tree, ImageFolder / PairedFolder, restore_tree and
evaluate_directory.

Images are written inside the tests with cv2 and PIL (the reference's
codecs); trees hold at most 12 files at small sizes, ResUNet (8, 16, 32) /
64 and a small VGG at size 32, weights carried over from tsr_tpu.
"""

import importlib.util
import io
import json
import struct
import zlib
from pathlib import Path

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from tsr_tpu import eval as jeval
from tsr_tpu import infer as jinfer
from tsr_tpu import offline as joffline
from tsr_tpu.data import gtsrb as jgtsrb
from tsr_tpu.models import ResUNet as JResUNet
from tsr_tpu.models import VGG16 as JVGG16
from tsr_tpu.ops import distortions as jdist
from tsr_tpu_torch import checkpoint, native, offline
from tsr_tpu_torch import eval as teval
from tsr_tpu_torch import infer as tinfer
from tsr_tpu_torch.data import gtsrb
from tsr_tpu_torch.models import ResUNet, VGG16

FIXTURES = Path(__file__).resolve().parent / "data" / "jpeg"
_spec = importlib.util.spec_from_file_location(
    "make_fixtures", FIXTURES / "make_fixtures.py")
make_fixtures = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(make_fixtures)
smooth = make_fixtures.smooth

torch.set_num_threads(2)
HI = jax.lax.Precision.HIGHEST
SIZE = 32
SMALL_CFG = (8, 8, "M", 16, "M", 16, "M")
quiet = lambda s: None  # noqa: E731


def _diff(a, b):
    return np.abs(np.asarray(a).astype(int) - np.asarray(b).astype(int))


def _assert_reads_as_cv2(path):
    """decode equals cv2.imread (BGR -> RGB) exactly, and probe gives the
    decoded (h, w)."""
    want = cv2.imread(str(path))
    assert want is not None, path
    got = native.decode(str(path))
    np.testing.assert_array_equal(got, want[:, :, ::-1], err_msg=str(path))
    assert native.probe([str(path)]).tolist() == [list(got.shape[:2])]


# ------------------------------------------------------------ JPEG decode

MATRIX_SIZES = ((7, 40), (40, 7), (23, 45), (16, 16), (3, 5), (260, 231))


@pytest.mark.parametrize("sampling", sorted(make_fixtures.SAMPLING))
def test_jpeg_decode_matches_cv2(tmp_path, sampling):
    """At one sampling factor: qualities 10, 75 and 95, baseline,
    progressive and optimized Huffman, restart intervals 0 and 3, sizes
    that are not multiples of 8 or 16, from 3x5 to 260x231."""
    rng = np.random.default_rng(20)
    p = tmp_path / "x.jpg"
    for h, w in MATRIX_SIZES:
        bgr = smooth(rng, h, w)
        for quality in (10, 75, 95):
            for prog, opt in ((0, 0), (1, 0), (0, 1)):
                for rst in (0, 3):
                    cv2.imwrite(str(p), bgr, [
                        cv2.IMWRITE_JPEG_QUALITY, quality,
                        cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                        make_fixtures.SAMPLING[sampling],
                        cv2.IMWRITE_JPEG_PROGRESSIVE, prog,
                        cv2.IMWRITE_JPEG_OPTIMIZE, opt,
                        cv2.IMWRITE_JPEG_RST_INTERVAL, rst])
                    _assert_reads_as_cv2(p)


@pytest.mark.parametrize("progressive", [0, 1])
def test_jpeg_decode_gray_matches_cv2(tmp_path, progressive):
    """One-component JPEGs replicate their gray to RGB, as cv2 does."""
    rng = np.random.default_rng(21)
    for h, w in MATRIX_SIZES:
        p = tmp_path / f"g{h}x{w}.jpg"
        cv2.imwrite(str(p), smooth(rng, h, w)[:, :, 1],
                    [cv2.IMWRITE_JPEG_PROGRESSIVE, progressive,
                     cv2.IMWRITE_JPEG_RST_INTERVAL, 2 * progressive])
        _assert_reads_as_cv2(p)


@pytest.mark.parametrize("orientation", range(1, 9))
def test_jpeg_exif_orientation_matches_cv2(tmp_path, orientation):
    """EXIF orientation 1-8, written by PIL and in both TIFF byte orders,
    applied as cv2.imread applies it; probe swaps (h, w) for 5-8."""
    rng = np.random.default_rng(22)
    img = smooth(rng, 21, 34)
    exif = Image.Exif()
    exif[0x0112] = orientation
    p = tmp_path / "pil.jpg"
    Image.fromarray(img).save(p, exif=exif, quality=90)
    _assert_reads_as_cv2(p)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", quality=90)
    for order in ("II", "MM"):
        p = tmp_path / f"{order}.jpg"
        p.write_bytes(make_fixtures.with_app1(
            buf.getvalue(), b"Exif\0\0"
            + make_fixtures.tiff_orientation(order, orientation)))
        _assert_reads_as_cv2(p)
        want = (34, 21) if orientation >= 5 else (21, 34)
        assert native.probe([str(p)]).tolist() == [list(want)]


def test_jpeg_probe_walks_past_a_large_app1(tmp_path):
    """An EXIF APP1 of 64 KiB before the SOF: the probe walks the markers
    to it (and to the orientation), past the first 4096 bytes."""
    rng = np.random.default_rng(23)
    buf = io.BytesIO()
    Image.fromarray(smooth(rng, 19, 30)).save(buf, "JPEG")
    payload = b"Exif\0\0" + make_fixtures.tiff_orientation("II", 6)
    payload += bytes(65533 - len(payload))
    p = tmp_path / "big.jpg"
    p.write_bytes(make_fixtures.with_app1(buf.getvalue(), payload))
    assert p.stat().st_size > 65536
    _assert_reads_as_cv2(p)
    assert native.probe([str(p)]).tolist() == [[30, 19]]


def test_jpeg_adobe_rgb_matches_cv2(tmp_path):
    """An Adobe APP14 with transform 0 holds RGB, not YCbCr (PIL's
    keep_rgb)."""
    rng = np.random.default_rng(24)
    for h, w in ((25, 38), (9, 70)):
        p = tmp_path / f"rgb{h}.jpg"
        Image.fromarray(smooth(rng, h, w)).save(p, quality=85,
                                                 keep_rgb=True)
        assert b"Adobe" in p.read_bytes()
        _assert_reads_as_cv2(p)


def test_jpeg_stray_bytes_and_missing_eoi_read_as_cv2(tmp_path):
    """Bytes before a marker are skipped and a file that ends after its
    last scan without EOI reads whole, as libjpeg reads them (it warns);
    so do bytes after EOI."""
    rng = np.random.default_rng(33)
    for prog in (0, 1):
        enc = cv2.imencode(".jpg", smooth(rng, 30, 41),
                           [cv2.IMWRITE_JPEG_PROGRESSIVE, prog])[1].tobytes()
        dqt = enc.index(b"\xff\xdb")
        for name, data in (("stray", enc[:dqt] + b"\x00\x17" + enc[dqt:]),
                           ("no_eoi", enc[:-2]), ("tail", enc + b"junk")):
            p = tmp_path / f"{name}{prog}.jpg"
            p.write_bytes(data)
            _assert_reads_as_cv2(p)


# ------------------------------------------------------------- encoders

ENCODE_SIZES = ((1, 1), (2, 3), (7, 40), (40, 7), (8, 8), (16, 16),
                (9, 15), (17, 33), (37, 53), (64, 48), (100, 1),
                (260, 231))


@pytest.mark.parametrize("size", ENCODE_SIZES)
def test_jpeg_and_bmp_writers_match_cv2_bytes(tmp_path, size):
    """write_images's .jpg, .jpeg and .bmp files are byte-equal to
    cv2.imwrite's at its defaults."""
    rng = np.random.default_rng(25 + size[0] * 1000 + size[1])
    for img in (smooth(rng, *size),
                rng.integers(0, 256, size + (3,), dtype=np.uint8)):
        paths = [str(tmp_path / f"ours{ext}") for ext in (".jpg", ".jpeg",
                                                          ".bmp")]
        native.write_images(paths, [img] * 3)
        for p, ext in zip(paths, (".jpg", ".jpeg", ".bmp")):
            want = tmp_path / f"cv2{ext}"
            assert cv2.imwrite(str(want), img[:, :, ::-1])
            assert Path(p).read_bytes() == want.read_bytes(), (size, ext)


# ---------------------------------------------------- PNG / PPM / BMP

def _png(rgb_or_gray: np.ndarray, depth: int, ctype: int, interlace: int,
         palette: bytes = b"") -> bytes:
    """A PNG of ``rgb_or_gray`` (samples already at ``depth``), every row
    with filter byte ``row % 5`` as stored (an unfiltered image then reads
    back as the filters' inverse, which cv2 computes too), Adam7 where
    ``interlace``."""
    a = rgb_or_gray if rgb_or_gray.ndim == 3 else rgb_or_gray[:, :, None]
    h, w, ch = a.shape
    passes = ([(0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
               (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2)] if interlace
              else [(0, 0, 1, 1)])
    raw = b""
    for x0, y0, dx, dy in passes:
        sub = a[y0::dy, x0::dx]
        if sub.size == 0:
            continue
        for r, row in enumerate(sub):
            vals = row.reshape(-1)
            if depth == 16:
                data = vals.astype(">u2").tobytes()
            elif depth == 8:
                data = vals.astype(np.uint8).tobytes()
            else:
                bits = np.unpackbits(vals.astype(np.uint8)[:, None],
                                     axis=1)[:, 8 - depth:].reshape(-1)
                data = np.packbits(bits).tobytes()
            raw += bytes([r % 5]) + data

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    out = b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, depth, ctype, 0, 0, interlace))
    if palette:
        out += chunk(b"PLTE", palette)
    return out + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b"")


def _png_cases(rng):
    """(name, PNG bytes) of the variants cv2 reads and the 8-bit,
    non-interlaced decoder of the file-tree slice rejected."""
    rgb16 = rng.integers(0, 65536, (13, 11, 3))
    rgb16[0, 0] = (0x80FF, 0x7F80, 0x0001)  # high byte, not rounded
    gray16 = rng.integers(0, 65536, (9, 14))
    rgba16 = rng.integers(0, 65536, (7, 10, 4))
    rgb8 = rng.integers(0, 256, (19, 23, 3))
    pal = bytes(rng.integers(0, 256, 3 * 16, dtype=np.uint8))
    cases = [("rgb16", _png(rgb16, 16, 2, 0)),
             ("gray16", _png(gray16, 16, 0, 0)),
             ("rgba16", _png(rgba16, 16, 6, 0)),
             ("rgb8_adam7", _png(rgb8, 8, 2, 1)),
             ("rgb16_adam7", _png(rgb16, 16, 2, 1)),
             ("gray8_adam7_1x1", _png(gray16[:1, :1] >> 8, 8, 0, 1))]
    for depth in (1, 2, 4):
        g = rng.integers(0, 2 ** depth, (11, 13))
        cases.append((f"gray{depth}", _png(g, depth, 0, 0)))
        cases.append((f"gray{depth}_adam7", _png(g, depth, 0, 1)))
        idx = rng.integers(0, min(2 ** depth, 16), (10, 17))
        cases.append((f"palette{depth}", _png(idx, depth, 3, 0, pal)))
        cases.append((f"palette{depth}_adam7", _png(idx, depth, 3, 1, pal)))
    return cases


@pytest.mark.parametrize("case", range(18))
def test_png_variant_matches_cv2(tmp_path, case):
    """16-bit (the high byte), Adam7, 1/2/4-bit gray and palette: each
    equal to cv2.imread, with the probe's (h, w)."""
    name, data = _png_cases(np.random.default_rng(26))[case]
    p = tmp_path / f"{name}.png"
    p.write_bytes(data)
    _assert_reads_as_cv2(p)


def test_png_exif_orientation_matches_cv2(tmp_path):
    """A PNG's eXIf chunk orients it in cv2.imread, and here."""
    rng = np.random.default_rng(27)
    img = rng.integers(0, 256, (5, 9, 3), dtype=np.uint8)
    for orientation in (3, 6, 7):
        exif = Image.Exif()
        exif[0x0112] = orientation
        p = tmp_path / f"o{orientation}.png"
        Image.fromarray(img).save(p, exif=exif)
        _assert_reads_as_cv2(p)


def test_ppm_variants_match_cv2(tmp_path):
    """P5 (gray) and maxvals other than 255: cv2 keeps an 8-bit sample as
    stored and a 16-bit one's high byte."""
    rng = np.random.default_rng(28)
    cases = {
        "p6_max100": (b"P6\n6 5\n100\n", rng.integers(0, 101, (5, 6, 3)),
                      np.uint8),
        "p6_max1000": (b"P6\n6 5\n1000\n", rng.integers(0, 1001, (5, 6, 3)),
                       ">u2"),
        "p5": (b"P5\n# gray\n7 4\n255\n", rng.integers(0, 256, (4, 7)),
               np.uint8),
        "p5_max65535": (b"P5 7 4 65535\n", rng.integers(0, 65536, (4, 7)),
                        ">u2"),
    }
    for name, (header, px, dtype) in cases.items():
        p = tmp_path / f"{name}.ppm"
        p.write_bytes(header + px.astype(dtype).tobytes())
        _assert_reads_as_cv2(p)


def test_bmp_palette_variants_match_cv2(tmp_path):
    """8-bit palette (PIL's "P" and "L") and 1-bit BMPs."""
    rng = np.random.default_rng(29)
    img = Image.fromarray(smooth(rng, 13, 22))
    for name, im in (("p8", img.quantize(colors=40)),
                     ("l8", img.convert("L")), ("b1", img.convert("1"))):
        p = tmp_path / f"{name}.bmp"
        im.save(p)
        assert p.read_bytes()[28] in (1, 8)
        _assert_reads_as_cv2(p)


@pytest.mark.parametrize("resize", ["cv2", "pil"])
def test_decode_resize_matches_reference(tmp_path, resize):
    """gtsrb._decode_resize at 224 within 1 LSB of tsr_tpu's (cv2.imread
    then its resize) on JPEG, 16-bit PNG, P5 and palette-BMP files."""
    rng = np.random.default_rng(30)
    paths = sorted(str(p) for p in FIXTURES.glob("*.jpg"))
    p = tmp_path / "rgb16.png"
    p.write_bytes(_png_cases(rng)[0][1])
    paths.append(str(p))
    p = tmp_path / "gray.ppm"
    p.write_bytes(b"P5\n40 30\n255\n"
                  + rng.integers(0, 256, 1200, dtype=np.uint8).tobytes())
    paths.append(str(p))
    p = tmp_path / "pal.bmp"
    Image.fromarray(smooth(rng, 30, 41)).quantize(colors=64).save(p)
    paths.append(str(p))
    old = (gtsrb.RESIZE_BACKEND, jgtsrb.RESIZE_BACKEND)
    try:
        gtsrb.set_resize_backend(resize)
        jgtsrb.set_resize_backend(resize)
        for p in paths:
            assert _diff(gtsrb._decode_resize(p, 224),
                         jgtsrb._decode_resize(p, 224)).max() <= 1, p
    finally:
        gtsrb.set_resize_backend(old[0])
        jgtsrb.set_resize_backend(old[1])


# ------------------------------------------- the features the port refused

def _sos_offsets(data: bytes):
    return [i for i in range(len(data) - 1)
            if data[i] == 0xFF and data[i + 1] == 0xDA]


_writers_spec = importlib.util.spec_from_file_location(
    "jpeg_writers", FIXTURES / "jpeg_writers.py")
jpeg_writers = importlib.util.module_from_spec(_writers_spec)
_writers_spec.loader.exec_module(jpeg_writers)

# the features the decoder refused before it read damaged data, block
# smoothing, CMYK/YCCK, lossless and arithmetic coding: each keeps its case
FORMER_FEATURES = (
    "arithmetic coding",
    "a sample precision other than 8 bits (12-bit JPEG)",
    "lossless JPEG",
    "4-component JPEG (CMYK/YCCK)",
    "hierarchical JPEG",
    "a component count other than 1, 3 or 4",
    "progressive data that leaves coefficients incomplete (block smoothing)",
)


def _unsupported(kind, rng) -> bytes:
    """A JPEG that uses ``kind``, made from cv2's or PIL's by hand (the
    lossless and two-component files by tests/data/jpeg/jpeg_writers.py)."""
    ok, enc = cv2.imencode(".jpg", smooth(rng, 20, 28))
    base = enc.tobytes()
    sof = base.index(b"\xff\xc0")
    if kind in ("arithmetic coding", "hierarchical JPEG"):
        code = {"arithmetic coding": 0xC9, "hierarchical JPEG": 0xC5}[kind]
        return base[:sof + 1] + bytes([code]) + base[sof + 2:]
    if kind == "lossless JPEG":  # gray: cv2 gives None, PIL reads it
        return jpeg_writers.lossless([smooth(rng, 20, 28)[:, :, 1]], psv=6)
    if kind.startswith("a sample precision"):
        return base[:sof + 4] + bytes([12]) + base[sof + 5:]
    if kind.startswith("a component count"):
        return jpeg_writers.two_components(20, 28)
    if kind.startswith("4-component"):
        buf = io.BytesIO()
        Image.fromarray(smooth(rng, 20, 28)).convert("CMYK").save(buf,
                                                                  "JPEG")
        return buf.getvalue()
    if kind.startswith("progressive data"):  # its first two scans only
        ok, enc = cv2.imencode(".jpg", smooth(rng, 20, 28),
                               [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
        data = enc.tobytes()
        return data[:_sos_offsets(data)[2]] + b"\xff\xd9"
    raise ValueError(kind)


def _reference_read(path):
    """The reference's reader: cv2.imread as RGB, else PIL's
    convert("RGB"); None where both refuse."""
    img = cv2.imread(str(path))
    if img is not None:
        return img[:, :, ::-1]
    try:
        return np.asarray(Image.open(path).convert("RGB"))
    except Exception:
        return None


@pytest.mark.parametrize("feature", FORMER_FEATURES)
def test_unsupported_jpeg_features_raise_naming_them(tmp_path, feature):
    """Each feature the decoder once refused: arithmetic coding, lossless
    JPEG (gray, which cv2 leaves to PIL), CMYK and incomplete progressive
    data (block smoothing) now decode equal to what the reference reads
    (cv2.imread, or PIL where cv2 gives None), in decode and load_batch,
    and probe gives their size (reader="cv2" gives the lossless file
    (0, 0), as cv2 refuses it); 12-bit, hierarchical and two components,
    which neither cv2 nor PIL reads, still raise a RuntimeError that names
    the feature in decode and load_batch, and in probe, and reader="cv2"
    gives them (0, 0); nothing returns zeros."""
    p = tmp_path / "x.jpg"
    p.write_bytes(_unsupported(feature, np.random.default_rng(31)))
    want = _reference_read(p)
    cv2_reads = cv2.imread(str(p)) is not None
    if want is not None:
        np.testing.assert_array_equal(native.decode(str(p)), want)
        assert native.load_batch([str(p)], SIZE).shape == (1, SIZE, SIZE, 3)
        assert native.probe([str(p)]).tolist() == [[20, 28]]
        assert native.probe([str(p)], reader="cv2").tolist() == (
            [[20, 28]] if cv2_reads else [[0, 0]])
        assert feature in ("arithmetic coding", "lossless JPEG",
                           "4-component JPEG (CMYK/YCCK)") or (
            feature.startswith("progressive data"))
        return
    name = feature[:12]
    with pytest.raises(RuntimeError, match="it uses " + name):
        native.decode(str(p))
    with pytest.raises(RuntimeError, match="decoded 0/1.*" + name):
        native.load_batch([str(p)], SIZE)
    with pytest.raises(RuntimeError, match="probed 0/1.*" + name):
        native.probe([str(p)])
    assert native.probe([str(p)], reader="cv2").tolist() == [[0, 0]]


def test_truncated_or_corrupt_jpeg_raises(tmp_path):
    """A JPEG cut short in its scan (cv2 fills the rest with grey) and one
    whose scan data is not Huffman code (cv2 reads it as bad codes) decode
    equal to cv2.imread; one whose DHT holds more codes of a length than
    fit raises, as cv2 refuses it: probe passes its header, and
    reader="cv2" gives it (0, 0)."""
    ok, enc = cv2.imencode(".jpg", smooth(np.random.default_rng(32), 40,
                                           56))
    data = enc.tobytes()
    sos = _sos_offsets(data)[0]
    cut = tmp_path / "cut.jpg"
    cut.write_bytes(data[:(sos + len(data)) // 2])
    junk = tmp_path / "junk.jpg"
    junk.write_bytes(data[:sos + 14] + bytes([0xFF, 0x00]) * 400
                     + b"\xff\xd9")
    dht = data.index(b"\xff\xc4")  # luma DC: 0 1 5 1 1 ... -> 2 0 4 1 ...
    counts = bytearray(data[dht + 5:dht + 21])
    counts[0], counts[1], counts[2] = 2, 0, 4
    table = tmp_path / "table.jpg"
    table.write_bytes(data[:dht + 5] + bytes(counts) + data[dht + 21:])
    assert cv2.imread(str(table)) is None
    for p in (cut, junk):
        _assert_reads_as_cv2(p)
        assert native.probe([str(p)], reader="cv2").tolist() == [[40, 56]]
    with pytest.raises(RuntimeError, match="failed to decode"):
        native.decode(str(table))
    assert native.probe([str(table)]).tolist() == [[40, 56]]
    assert native.probe([str(table)], reader="cv2").tolist() == [[0, 0]]


# ------------------------------------------------------------- fixtures

def test_fixtures_equal_cv2_and_the_port(tmp_path):
    """The committed fixtures still equal what cv2 and PIL give here
    (rewritten into a temporary directory by make_fixtures), and the port
    decodes and encodes them equally: the cv2-written cases, the damaged
    and rarer files of FEATURE_CASES (equal to cv2.imread, or to PIL for
    the lossless gray file), the SKIP_CASES files (which the port refuses,
    as cv2 and PIL do), and the reference's generate_tree count over them.
    chip_smoke.py holds the port to these files on the card's machine,
    which has neither cv2 nor PIL."""
    want = np.load(FIXTURES / "expected.npz")
    fresh = make_fixtures.make(tmp_path)
    assert sorted(fresh) == sorted(want.files)
    for key in want.files:
        np.testing.assert_array_equal(fresh[key], want[key], err_msg=key)
    names = [name for name, _, _ in make_fixtures.CASES] + [
        name for name, _ in make_fixtures.FEATURE_CASES]
    for name in names:
        p = FIXTURES / f"{name}.jpg"
        assert p.read_bytes() == (tmp_path / f"{name}.jpg").read_bytes()
        np.testing.assert_array_equal(native.decode(str(p)),
                                      want[f"decoded__{name}"])
    for name in make_fixtures.SKIP_CASES:
        p = FIXTURES / "skip" / f"{name}.jpg"
        assert p.read_bytes() == (tmp_path / "skip" / f"{name}.jpg"
                                  ).read_bytes()
        with pytest.raises(RuntimeError, match="decode"):
            native.decode(str(p))
    tree = [FIXTURES / f"{name}.jpg" for name, _ in
            make_fixtures.FEATURE_CASES] + [
        FIXTURES / "skip" / f"{name}.jpg" for name in make_fixtures.SKIP_CASES]
    read = native.probe([str(p) for p in tree], reader="cv2")[:, 0] > 0
    assert read.sum() == want["generate_tree_written"] == sum(
        cv2.imread(str(p)) is not None for p in tree)
    for k in range(len(make_fixtures.ENCODE_SIZES)):
        out = tmp_path / f"enc{k}.jpg"
        native.write_images([str(out)], [want[f"encode_input__{k}"]])
        assert out.read_bytes() == want[f"encode_bytes__{k}"].tobytes()
    assert sum(p.stat().st_size for p in FIXTURES.iterdir()) < 200 * 1024


# ---------------------------------------------------------- JPEG trees

# natives in three of tsr_tpu's offline buckets (32x32, 48x48, 32x48),
# padded by 0 or at least the K=12 blur's halo of 5 on both axes in half of
# them, by 1-4 px on an axis in the other half; one 7-px side
TREE_SIZES = [(26, 27), (30, 32), (7, 20), (32, 32), (40, 41), (45, 43),
              (33, 47), (48, 36), (24, 37), (29, 46), (18, 33), (31, 40)]


def _write_tree(root: Path, sizes, seed, suffixes=(".jpg",)):
    """Class folders c0, c1, c2 of images at ``sizes``, written by cv2 with
    the suffixes in turn."""
    rng = np.random.default_rng(seed)
    for k, (h, w) in enumerate(sizes):
        p = root / f"c{k % 3}" / f"img{k:02d}{suffixes[k % len(suffixes)]}"
        p.parent.mkdir(parents=True, exist_ok=True)
        cv2.imwrite(str(p), smooth(rng, h, w))
    return root


@pytest.fixture(scope="module")
def jpeg_tree(tmp_path_factory):
    return _write_tree(tmp_path_factory.mktemp("jpeg"), TREE_SIZES, 0)


def _files(root: Path):
    return {str(p.relative_to(root)): p for p in sorted(root.glob("*/*"))}


def test_generate_tree_blur_on_jpeg_tree_matches_reference(jpeg_tree,
                                                           tmp_path):
    """generate_tree("blur") on a 12-file .jpg tree vs tsr_tpu: .jpg files
    by the same names; each equals cv2's encode of the reference's blur of
    the decoded source at native size (with its min-max), byte for byte,
    except where a cvRound tie moved a value by 1 LSB (under 0.1 % of the
    values: then the decoded files differ by a few LSB in that block);
    against the file tsr_tpu.offline.generate_tree writes the same wherever
    its bucket pads by 0 or at least the kernel's halo of 5. Where two
    files decode equal, their bytes are equal. The marker JSON is the
    reference's."""
    ours, ref = tmp_path / "ours", tmp_path / "ref"
    assert offline.generate_tree(str(jpeg_tree), str(ours), "blur",
                                 log=quiet, device="cpu") == 12
    joffline.generate_tree(str(jpeg_tree), str(ref), "blur", log=quiet)
    got, want = _files(ours), _files(ref)
    assert sorted(got) == sorted(want) and all(k.endswith(".jpg")
                                              for k in got)
    native_blur = jax.jit(lambda x: jdist.apply_motion_blur(x, 12, 45.0))
    byte_equal, roomy, departs = 0, 0, []
    for k in want:
        src = cv2.imread(str(jpeg_tree / k))[:, :, ::-1]
        blurred = np.asarray(native_blur(src))
        enc = cv2.imencode(".jpg", blurred[:, :, ::-1])[1].tobytes()
        mine = got[k].read_bytes()
        dec = cv2.imread(str(got[k])).astype(int)
        if mine == enc:
            byte_equal += 1
        else:
            assert _diff(dec, cv2.imdecode(np.frombuffer(enc, np.uint8),
                                           1)).max() <= 8, k
        theirs = want[k].read_bytes()
        if (dec == cv2.imread(str(want[k]))).all():
            assert mine == theirs, k
        if theirs != enc:
            departs.append(k)
        if all(joffline._bucket(n) - n in (0,) + tuple(range(5, 300))
               for n in src.shape[:2]):
            roomy += 1
            assert mine == theirs or mine != enc, k
            assert k not in departs
    assert byte_equal >= 10 and 0 < roomy < len(want)
    # the reference departs from native-size blur on some of the files
    # whose pad is 1-4 px (ROADMAP section C), and on no other
    assert departs
    assert (json.loads((ours / ".distortion").read_text())
            == json.loads((ref / ".distortion").read_text()))


def test_generate_tree_keeps_each_suffix_as_reference(tmp_path):
    """On a tree of .jpg, .jpeg and .bmp files, noise writes each file
    with its source's suffix and compound writes .png, file for file as
    tsr_tpu names them."""
    src = _write_tree(tmp_path / "src", TREE_SIZES[:4], 1,
                      (".jpg", ".jpeg", ".bmp"))
    for kind in ("noise", "compound"):
        n = offline.generate_tree(str(src), str(tmp_path / f"o_{kind}"),
                                  kind, log=quiet, device="cpu")
        m = joffline.generate_tree(str(src), str(tmp_path / f"r_{kind}"),
                                   kind, log=quiet)
        got = sorted(_files(tmp_path / f"o_{kind}"))
        assert n == m == 4 and got == sorted(_files(tmp_path / f"r_{kind}"))
        suffixes = {Path(k).suffix for k in got}
        assert suffixes == ({".png"} if kind == "compound"
                            else {".jpg", ".jpeg", ".bmp"})
        sources = {str(Path(k).with_suffix("")): p
                   for k, p in _files(src).items()}
        for k, p in _files(tmp_path / f"o_{kind}").items():
            want = cv2.imread(str(sources[str(Path(k).with_suffix(""))]))
            assert cv2.imread(str(p)).shape == want.shape, k


def test_generate_tree_skips_unreadable_files_as_reference(jpeg_tree,
                                                           tmp_path):
    """A zero-byte .jpg and a .png that is no image are skipped, and the
    count is tsr_tpu's; the log says how many. native.decode and
    load_batch still raise on them."""
    src = tmp_path / "src"
    for k, p in enumerate(sorted(jpeg_tree.glob("*/*.jpg"))[:4]):
        (src / p.parent.name).mkdir(parents=True, exist_ok=True)
        (src / p.parent.name / p.name).write_bytes(p.read_bytes())
    (src / "c0" / "empty.jpg").write_bytes(b"")
    (src / "c1").mkdir(exist_ok=True)
    (src / "c1" / "notes.png").write_text("not an image")
    lines = []
    n = offline.generate_tree(str(src), str(tmp_path / "ours"), "noise",
                              log=lines.append, device="cpu")
    m = joffline.generate_tree(str(src), str(tmp_path / "ref"), "noise",
                               log=quiet)
    assert n == m == 4
    assert "Skipped 2 unreadable files" in lines
    assert sorted(_files(tmp_path / "ours")) == sorted(
        _files(tmp_path / "ref"))
    for p in (src / "c0" / "empty.jpg", src / "c1" / "notes.png"):
        with pytest.raises(RuntimeError, match="decode"):
            native.decode(str(p))
        with pytest.raises(RuntimeError, match="decoded 0/1"):
            native.load_batch([str(p)], SIZE)


def test_image_folder_and_paired_folder_on_jpeg_trees(jpeg_tree, tmp_path):
    """ImageFolder and PairedFolder (a .jpg distorted file paired with its
    .jpg clean twin by relative path) against tsr_tpu's: the same samples
    and pairs, batches within 1 LSB."""
    ours = gtsrb.ImageFolder(str(jpeg_tree), size=SIZE)
    ref = jgtsrb.ImageFolder(str(jpeg_tree), size=SIZE)
    assert ours.samples == ref.samples and len(ours) == 12
    idx = np.arange(12)
    assert _diff(ours.load_batch(idx)[0], ref.load_batch(idx)[0]).max() <= 1
    np.testing.assert_array_equal(ours.load_batch(idx)[1],
                                  ref.load_batch(idx)[1])
    dist = tmp_path / "noise"
    offline.generate_tree(str(jpeg_tree), str(dist), "noise", log=quiet,
                          device="cpu")
    pairs = gtsrb.PairedFolder(str(jpeg_tree), str(dist), size=SIZE,
                               exts=(".jpg",))
    jpairs = jgtsrb.PairedFolder(str(jpeg_tree), str(dist), size=SIZE,
                                 exts=(".jpg",))
    assert pairs.pairs == jpairs.pairs and len(pairs) == 12
    assert all(d.endswith(".jpg") for d, _ in pairs.pairs)
    for a, b in zip(pairs.load_batch(idx), jpairs.load_batch(idx)):
        assert _diff(a, b).max() <= 1


@pytest.fixture(scope="module")
def models():
    """A small ResUNet and VGG16 judge at SIZE in both frameworks, the
    port's weights carried over from the reference's."""
    rng = np.random.default_rng(12)
    jr = JResUNet(widths=(8, 16, 32), bottleneck_width=64, precision=HI)
    jrv = jax.tree.map(np.array, jax.jit(jr.init)(
        jax.random.PRNGKey(2), jnp.zeros((1, SIZE, SIZE, 3))))
    for stats in jrv["batch_stats"].values():
        for bn in stats.values():
            bn["mean"] = rng.normal(0, 0.05, bn["mean"].shape).astype(
                np.float32)
    jj = JVGG16(num_classes=3, cfg=SMALL_CFG, fc_width=32, precision=HI)
    jjv = jj.init(jax.random.PRNGKey(3), jnp.zeros((1, SIZE, SIZE, 3)))
    tr = ResUNet(widths=(8, 16, 32), bottleneck_width=64)
    tr.load_state_dict(checkpoint.resunet_from_jax(jrv))
    tj = VGG16(num_classes=3, cfg=SMALL_CFG, fc_width=32, input_size=SIZE)
    tj.load_state_dict(checkpoint.vgg16_from_jax(jjv))
    return (jr, jrv, jj, jjv), (tr.eval(), tj.eval())


@pytest.fixture(scope="module")
def jpeg_walk(tmp_path_factory):
    """A .jpg clean tree of 12 images whose natives straddle SIZE, its .jpg
    distorted twin (written by cv2), and .ppm copies of both trees'
    decoded pixels."""
    root = tmp_path_factory.mktemp("jwalk")
    rng = np.random.default_rng(8)
    sizes = [(int(h), int(w)) for h, w in rng.integers(12, 46, (12, 2))]
    clean = _write_tree(root / "clean", sizes, 1)
    dist, ppm = root / "distorted", root / "ppm"
    for p in sorted(clean.glob("*/*.jpg")):
        img = cv2.imread(str(p)).astype(int)
        out = dist / p.relative_to(clean)
        out.parent.mkdir(parents=True, exist_ok=True)
        cv2.imwrite(str(out), np.clip(img + rng.integers(-25, 26, img.shape),
                                      0, 255).astype(np.uint8))
        for tree, src in (("clean", p), ("distorted", out)):
            twin = (ppm / tree / p.relative_to(clean)).with_suffix(".ppm")
            twin.parent.mkdir(parents=True, exist_ok=True)
            cv2.imwrite(str(twin), cv2.imread(str(src)))
    return clean, dist, ppm


@pytest.mark.parametrize("resize", ["device", "host"])
def test_restore_tree_and_evaluate_directory_on_jpeg_trees(models, jpeg_walk,
                                                           tmp_path, resize):
    """restore_tree on the .jpg distorted tree with its .jpg clean twins,
    and evaluate_directory on the .jpg clean tree, against tsr_tpu on
    shared weights, with the tree tests' tolerances: restored .png pixels
    within 2 LSB with under 1 % of values differing, PSNR within 0.05 dB,
    SSIM within 1e-3; n and top-1 equal, confidence within 1e-4.

    tsr_tpu reads a .jpg through cv2 and resizes it with cv2.resize, to
    which the port's resize is held within 1 LSB
    (test_decode_resize_matches_reference); a .ppm it resizes with its
    native loader, as the port does. Where the walk resizes every image on
    the host, the restored pixels are therefore held to tsr_tpu's run on
    .ppm copies of the trees' decoded pixels (the same inputs) with those
    tolerances, and to its .jpg run within the 2 LSB alone."""
    (jr, jrv, jj, jjv), (tr, tj) = models
    clean, dist, ppm = jpeg_walk
    kw = dict(batch_size=5, size=SIZE, resize=resize, log=quiet)
    got = tinfer.restore_tree(tr, str(dist), str(tmp_path / "ours"),
                              clean_dir=str(clean), device="cpu", **kw)
    ours = {k: cv2.imread(str(p)) for k, p in
            _files(tmp_path / "ours").items()}
    assert got["images"] == 12 and all(k.endswith(".png") for k in ours)
    runs = [(dist, clean, "ref")]
    if resize == "host":
        runs.append((ppm / "distorted", ppm / "clean", "ref_ppm"))
    for src, cl, name in runs:
        want = jinfer.restore_tree(jr.apply, jrv, str(src),
                                   str(tmp_path / name), clean_dir=str(cl),
                                   has_batch_stats=True, **kw)
        ref = {k: cv2.imread(str(p)) for k, p in
               _files(tmp_path / name).items()}
        assert want["images"] == 12 and sorted(ours) == sorted(ref)
        d = np.concatenate([_diff(ours[k], ref[k]).reshape(-1)
                            for k in ref])
        assert d.max() <= 2, name
        if resize == "device" or name == "ref_ppm":
            assert (d > 0).mean() < 0.01, (name, (d > 0).mean())
            assert abs(got["psnr"] - want["psnr"]) < 0.05
            assert abs(got["ssim"] - want["ssim"]) < 1e-3
    res = teval.evaluate_directory(tj, str(clean), batch_size=5, size=SIZE,
                                   restorer=tr, resize=resize, device="cpu")
    jres = jeval.evaluate_directory(
        lambda v, x, train=False: jj.apply(v, x, train=train), jjv,
        str(clean), batch_size=5, size=SIZE,
        restorer_apply=lambda v, x: jr.apply(v, x, train=False),
        restorer_vars=jrv, resize=resize)
    assert res["n"] == jres["n"] == 12
    assert res["top1"] == jres["top1"]
    assert abs(res["confidence"] - jres["confidence"]) <= 1e-4
