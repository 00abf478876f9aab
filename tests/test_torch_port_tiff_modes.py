"""TIFF part 2c-iii, Pillow's I, F and I;12 modes and old-style JPEG
(Compression 6), and WebP inside TIFF (fault C13), read by the port as the
reference reads them (cv2.imread, else PIL's convert("RGB"), else refused
as both refuse), max diff 0.

- I and F: 16-bit signed (I;16S, I;16BS), 32-bit integer (I;32N read as a
  signed INT32, I;32S, I;32BS) and float (F;32F, F;32BF) samples under
  Photometric 0 and 1, both byte orders, through Pillow's own decoder
  (uncompressed strips and tiles, any Predictor tag ignored) and through
  libtiff (LZW, both deflates, PackBits; the horizontal predictor at 16 and
  32 bits, the floating-point one, which libtiff undoes byte plane by byte
  plane): libtiff hands Pillow its samples in the host's order, which
  Pillow's big-endian rawmodes read swapped. convert("RGB") clips I to
  0..255 and truncates F toward zero (NaN and what is not above 0 give 0,
  255 and past give 255). cv2 reads 16-bit signed samples (so I;16S is
  PIL's at orientations 5-8) and none of the others.
- I;12: 12-bit gray (Pillow's I;12 unpacker, unscaled, into I;16, then
  clipped), little-endian only; libtiff's horizontal predictor refuses 12
  bits.
- Old-style JPEG: libtiff 4.7's tif_ojpeg.c over Pillow's libtiff, a whole
  stream at JPEGInterchangeFormat or the tables at JPEGQTables,
  JPEGDCTables and JPEGACTables with the data in strips (several strips
  joined by the restart markers the codec writes), YCbCr at 1x1, 2x1,
  2x2, 1x2 and 4x1 sampling (from the frame, whatever YCbCrSubsampling
  says), read through libtiff's RGBA reader; gray through the strips.
- Damage: cut points and seeded mutations of each kind against PIL (the
  same pixels where PIL reads, a raise where it raises); missing tables
  and offsets past the file.
- C13: a WebP strip or tile (50001) is refused by both readers (Pillow's
  libtiff has no WebP codec): decode raises "failed to decode", not
  naming TIFF, the probes give (0, 0) or raise, load_batch raises.
- data.gtsrb._decode_resize equals tsr_tpu's on each layout PIL reads;
  chip_smoke.py's built files (phase 13) decode to the digests it holds of
  PIL's pixels; generate_tree through both packages skips them all.
"""

import hashlib
import importlib.util
import io
import lzma
import re
import struct
import zlib
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

from tsr_tpu import offline as joffline
from tsr_tpu.data import gtsrb as jgtsrb
from tsr_tpu_torch import native, offline
from tsr_tpu_torch.data import gtsrb

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
quiet = lambda s: None  # noqa: E731

# sample kinds: (numpy type, SampleFormat)
KINDS = {"I;16S": ("i2", 2), "I;32N": ("u4", 1), "I;32S": ("i4", 2),
         "F": ("f4", 3)}


def _reference(path):
    """(reader, RGB): cv2's, else PIL's, else ("none", None); cv2 raising
    is ("raise", None)."""
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


def _reads_as_reference(path):
    """probe(reader="cv2") is cv2's (h, w), (0, 0) where cv2 gives None;
    decode equals cv2, else PIL, max diff 0, else raises without naming
    TIFF; where PIL reads, the header probe gives its size. Returns the
    reader."""
    reader, want = _reference(path)
    dims = native.probe([str(path)], reader="cv2").tolist()
    assert dims == ([list(want.shape[:2])] if reader == "cv2" else [[0, 0]])
    try:
        got = native.decode(str(path))
    except RuntimeError as e:
        assert "holds TIFF data" not in str(e), path
        got = None
    if want is None:
        assert got is None, path
        return reader
    assert got is not None, (reader, path)
    np.testing.assert_array_equal(got, want, err_msg=str(path))
    if reader == "pil":
        assert native.probe([str(path)]).tolist() == [list(want.shape[:2])]
    return reader


# ------------------------------------------------------------ writers

def sample_file(arr, kind, photometric=1, big=False, compression=1,
                predictor=1, rps=None, tile=None, tags=None, **kw):
    """A TIFF of the numbers ``arr`` ([h, w]) as ``kind`` samples
    (KINDS), either byte order, strips of ``rps`` rows or ``tile`` tiles,
    ``compression`` 1, 5, 8, 32946 or 32773, with the horizontal predictor
    (2) or the floating-point one (3, chip_smoke.fp_predictor_bytes)."""
    fmt, sf = KINDS[kind]
    e = ">" if big else "<"
    a = np.asarray(arr).astype(e + fmt)
    h, w = a.shape
    nb = a.dtype.itemsize

    def encode(block):
        cols = block.shape[1]
        if predictor == 2:
            u = block.view(e + f"u{nb}").astype(np.int64)
            u[:, 1:] -= u[:, :-1].copy()
            raw = (u & ((1 << 8 * nb) - 1)).astype(e + f"u{nb}").tobytes()
        elif predictor == 3:
            raw = chip_smoke.fp_predictor_bytes(block)
        else:
            raw = block.tobytes()
        row = cols * nb
        return (raw if compression == 1 else writers.lzw(raw)
                if compression == 5 else zlib.compress(raw)
                if compression in (8, 32946) else b"".join(
                    writers.packbits(raw[i:i + row])
                    for i in range(0, len(raw), row)))

    if tile is None:
        rps = h if rps is None else rps
        strips = [encode(a[y:y + rps]) for y in range(0, h, rps)]
    else:
        tw, th = tile
        strips = []
        for y in range(0, h, th):
            for x in range(0, w, tw):
                block = np.zeros((th, tw), a.dtype)
                part = a[y:y + th, x:x + tw]
                block[:part.shape[0], :part.shape[1]] = part
                strips.append(encode(block))
    t = {339: (3, [sf])}
    t.update(tags or {})
    return writers.tiff_file(np.zeros((h, w), np.uint8), bits=8 * nb,
                             photometric=photometric, big=big,
                             compression=compression, predictor=predictor,
                             rps=rps, tile=tile, strips=strips, tags=t, **kw)


def i12_file(img, compression=1, predictor=1, rps=None, big=False, **kw):
    """A 12-bit gray TIFF of ``img`` ([h, w], 0..4095), its rows packed by
    chip_smoke.pack_i12."""
    h, w = img.shape
    rps = h if rps is None else rps
    strips = []
    for y in range(0, h, rps):
        r = chip_smoke.pack_i12(img[y:y + rps])
        raw = b"".join(r)
        strips.append(raw if compression == 1 else writers.lzw(raw)
                      if compression == 5 else zlib.compress(raw)
                      if compression in (8, 32946)
                      else b"".join(writers.packbits(x) for x in r))
    return writers.tiff_file(np.zeros((h, w), np.uint8), bits=12,
                             photometric=1, compression=compression,
                             predictor=predictor, rps=rps, big=big,
                             strips=strips, **kw)


def jpeg_stream(img, sampling=(2, 2), rst_rows=0):
    """cv2's baseline JPEG of ``img`` (RGB or gray) at ``sampling``, with a
    restart marker every ``rst_rows`` MCU rows."""
    factor = {(1, 1): cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
              (2, 1): cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
              (2, 2): cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
              (1, 2): cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440,
              (4, 1): cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411}[sampling]
    hs = sampling[0] if img.ndim == 3 else 1
    p = [cv2.IMWRITE_JPEG_QUALITY, 95]
    if rst_rows:
        p += [cv2.IMWRITE_JPEG_RST_INTERVAL,
              -(-img.shape[1] // (8 * hs)) * rst_rows]
    if img.ndim == 2:
        return cv2.imencode(".jpg", img, p)[1].tobytes()
    p += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, factor]
    return cv2.imencode(".jpg", np.ascontiguousarray(img[:, :, ::-1]),
                        p)[1].tobytes()


def ojpeg_file(img, layout="stream", sampling=(2, 2), rps=None,
               photometric=6, tags=None):
    """An old-style JPEG TIFF of ``img`` (chip_smoke.ojpeg_bytes): the
    whole stream at JPEGInterchangeFormat, or the tables in tags and the
    data in strips of ``rps`` rows (the stream written with a restart
    marker at each strip's end)."""
    h, w = img.shape[:2]
    vs = sampling[1] if img.ndim == 3 else 1
    rst = (rps // (8 * vs)) if rps and rps < h else 0
    return chip_smoke.ojpeg_bytes(jpeg_stream(img, sampling, rst), h, w,
                                  layout, rps=rps, photometric=photometric,
                                  tags=tags)


def _smooth(rng, h, w):
    img = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
    return cv2.GaussianBlur(img, (5, 5), 2)


def _values(rng, kind, h, w):
    """Seeded samples of ``kind``: a ramp around 0..255 with values below
    0 and past 255 (far past for 32 bits; F with a fraction, NaN, +-inf,
    255.5; I;32N up to 2^32 - 1)."""
    y, x = np.mgrid[:h, :w]
    v = ((x * 37 + y * 23) % 600 - 150 + rng.integers(-20, 20, (h, w)))
    if kind == "F":
        v = v + rng.random((h, w)) * 2 - 0.5
        v.flat[:4] = [np.nan, np.inf, -np.inf, 255.5]
        return v.astype(np.float32)
    if kind == "I;32S":
        v[0, :3] = [-2 ** 31, 2 ** 31 - 1, 70000]
    if kind == "I;32N":
        v = np.abs(v)
        v[0, :3] = [2 ** 31, 2 ** 32 - 1, 70000]
    return v


# ------------------------------------------------------------ I and F

@pytest.mark.parametrize("mode", ["I", "F"])
def test_pillow_written_int32_and_float32_read_as_pil(tmp_path, mode):
    """Pillow's own 32-bit integer and float TIFFs of an RGB image (the
    "int32" and "float32" cases of tests/test_torch_port_tiff.py's
    test_part2_layouts_raise_naming_tiff, which raised naming TIFF until
    the port decoded these modes): cv2 refuses them ("can not handle
    images with 32-bit samples"), PIL reads them, and so does the port,
    max diff 0, both probes as the reference."""
    rng = np.random.default_rng(50)
    img = writers.smooth(rng, 12, 16)
    p = tmp_path / "p2.png"
    p.write_bytes(writers.pil_tiff(img, mode))
    assert _reads_as_reference(p) == "pil"
    assert Image.open(p).mode == mode


@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("big", [False, True])
def test_i_and_f_layouts_read_as_reference(tmp_path, kind, big):
    """Each sample kind in each byte order, under Photometric 0 and 1,
    uncompressed (Pillow's decoder; predictor tags ignored) and through
    libtiff (LZW, both deflates, PackBits; predictors 1, 2 and 3), in one
    strip, strips of 4 rows and 16 x 16 tiles, and at orientation 6 (cv2
    refuses it but for a square image; PIL reads it turned): the port reads
    each as the reference does, PIL's rows where Pillow reads them."""
    rng = np.random.default_rng(sum(map(ord, kind)) + big)
    arr = _values(rng, kind, 9, 13)
    p = tmp_path / "m.tif"
    readers = set()
    for photometric in (0, 1):
        for compression in (1, 5, 8, 32946, 32773):
            for predictor in (1, 2, 3):
                for layout in ({}, {"rps": 4}, {"tile": (16, 16)},
                               {"orientation": 6}):
                    p.write_bytes(sample_file(
                        arr, kind, photometric, big, compression, predictor,
                        **layout))
                    readers.add(_reads_as_reference(p))
    # Pillow has no mode for big-endian unsigned 32-bit samples
    assert ("pil" in readers) != (kind == "I;32N" and big)


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_mode_conversions_over_values(tmp_path, kind):
    """convert("RGB") of every value of interest: I clipped to 0..255
    (I;32N's values from 2^31 up read negative), F truncated toward zero
    with NaN and -inf 0 and +inf 255; both of Pillow's routes."""
    fmt, _ = KINDS[kind]
    if kind == "F":
        vals = np.array([-5, -0.7, -0.0, 0, 1e-45, 0.4, 0.5, 0.99999, 1,
                         2.9999, 128.5, 254.6, 254.99998, 255, 255.5, 256,
                         1e9, 2 ** 31, np.nan, np.inf, -np.inf], np.float64)
    else:
        info = np.iinfo(np.dtype(fmt))
        vals = np.array([v for v in (
            int(info.min), int(info.min) + 1, -70000, -300, -1, 0, 1, 127,
            128, 254, 255, 256, 300, 65535, 65536, 2 ** 31 - 1, 2 ** 31,
            int(info.max)) if info.min <= v <= info.max])
    arr = np.resize(vals, (3, len(vals)))
    p = tmp_path / "v.tif"
    for compression in (1, 8):
        p.write_bytes(sample_file(arr, kind, compression=compression,
                                  orientation=6))
        assert _reads_as_reference(p) == "pil"


def test_f_predictor_3_planes_and_lengths(tmp_path):
    """The floating-point predictor over rows of 1 to 9 floats, LZW and
    deflate, strips and tiles, little- and big-endian (libtiff's fpAcc
    gives the host's order, which F;32BF reads swapped), and over 16-bit
    and 8-bit samples (no mode, or refused by PredictorSetup)."""
    rng = np.random.default_rng(77)
    p = tmp_path / "p3.tif"
    for w in range(1, 10):
        arr = (rng.standard_normal((5, w)) * 200 + 100).astype(np.float32)
        for big in (False, True):
            for compression in (5, 8):
                for layout in ({}, {"rps": 2}, {"tile": (16, 16)}):
                    p.write_bytes(sample_file(arr, "F", big=big,
                                              compression=compression,
                                              predictor=3, **layout))
                    assert _reads_as_reference(p) == "pil"
    for bits in (8, 16):
        img = rng.integers(0, 255, (6, 7)).astype(np.uint16 if bits == 16
                                                   else np.uint8)
        p.write_bytes(writers.tiff_file(img, bits=bits, compression=8,
                                        tags={317: (3, [3])}))
        assert _reads_as_reference(p) == "none"


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_i_and_f_damage_reads_as_reference(tmp_path, kind):
    """Cut points and seeded byte mutations of a deflate file with the
    horizontal predictor and an uncompressed tiled one: the same pixels as
    PIL where it reads, a raise where it raises."""
    rng = np.random.default_rng(300 + sum(map(ord, kind)))
    arr = _values(rng, kind, 10, 12)
    p = tmp_path / "d.tif"
    for base in (sample_file(arr, kind, compression=8, predictor=2, rps=3),
                 sample_file(arr, kind, tile=(16, 16), orientation=6)):
        for cut in sorted(set(rng.integers(8, len(base), 25).tolist())):
            p.write_bytes(base[:cut])
            _reads_as_reference(p)
        for _ in range(40):
            d = bytearray(base)
            for _ in range(int(rng.integers(1, 4))):
                d[int(rng.integers(8, len(d)))] = int(rng.integers(0, 256))
            p.write_bytes(bytes(d))
            _reads_as_reference(p)


def test_refused_i_and_f_layouts(tmp_path):
    """Layouts of 32-bit or signed samples Pillow has no mode for (a 32-bit
    integer or a 16-bit signed sample under Photometric 0, I;32N
    big-endian, a float of 16 or 64 bits, 32-bit RGB) and predictor 2 at
    12 bits: both readers refuse them, and the port does too, without
    naming TIFF."""
    rng = np.random.default_rng(5)
    arr = _values(rng, "I;32S", 6, 7)
    p = tmp_path / "r.tif"
    for data in (sample_file(arr, "I;32S", photometric=0),
                 sample_file(arr, "I;16S", photometric=0, orientation=6),
                 sample_file(np.abs(arr), "I;32N", big=True),
                 writers.tiff_file(np.zeros((6, 7), np.uint8), bits=64,
                                   strips=[bytes(6 * 7 * 8)],
                                   tags={339: (3, [3])}),
                 writers.tiff_file(np.zeros((6, 7, 3), np.uint8), bits=32,
                                   strips=[bytes(6 * 7 * 12)],
                                   tags={339: (3, [3, 3, 3])}),
                 i12_file(rng.integers(0, 4096, (6, 7)), compression=8,
                          predictor=2)):
        p.write_bytes(data)
        assert _reads_as_reference(p) == "none"


# ------------------------------------------------------------ I;12

@pytest.mark.parametrize("w", [1, 7, 8, 13])
def test_i12_reads_as_reference(tmp_path, w):
    """12-bit gray of odd and even widths (a row's last sample alone in
    its bytes), uncompressed and through libtiff (LZW, both deflates,
    PackBits), strips of 9 and 4 rows, orientations 1 and 6: PIL reads the
    little-endian files, values unscaled and clipped (0, 255 and 256 among
    them); big-endian 12-bit samples have no mode in Pillow (refused);
    cv2 reads none."""
    rng = np.random.default_rng(120 + w)
    img = rng.integers(0, 4096, (9, w))
    img[0, :min(w, 3)] = [0, 255, 256][:min(w, 3)]
    p = tmp_path / "i12.tif"
    for compression in (1, 5, 8, 32946, 32773):
        for rps in (9, 4):
            for big in (False, True):
                for orientation in (None, 6):
                    p.write_bytes(i12_file(img, compression, rps=rps, big=big,
                                           orientation=orientation))
                    assert _reads_as_reference(p) == ("none" if big else "pil")


def test_i12_damage_reads_as_reference(tmp_path):
    """Cut points and mutations of uncompressed and LZW 12-bit files."""
    rng = np.random.default_rng(126)
    img = rng.integers(0, 4096, (11, 9))
    p = tmp_path / "i12.tif"
    for base in (i12_file(img, rps=4), i12_file(img, 5, rps=4)):
        for cut in sorted(set(rng.integers(8, len(base), 25).tolist())):
            p.write_bytes(base[:cut])
            _reads_as_reference(p)
        for _ in range(40):
            d = bytearray(base)
            d[int(rng.integers(8, len(d)))] = int(rng.integers(0, 256))
            p.write_bytes(bytes(d))
            _reads_as_reference(p)


# ------------------------------------------------------------ old-style JPEG

SAMPLINGS = [(1, 1), (2, 1), (2, 2), (1, 2), (4, 1)]


@pytest.mark.parametrize("sampling", SAMPLINGS)
def test_ojpeg_stream_reads_as_pil(tmp_path, sampling):
    """The whole stream at JPEGInterchangeFormat (one strip over the same
    bytes), at each sampling, of sizes that fill no MCU and that fill
    them, with YCbCrSubsampling absent, 2 x 2, 1 x 1 and the frame's own:
    libtiff takes the sampling from the frame; PIL's pixels are those of
    libtiff's RGBA reader over the raw sampling blocks, not a plain JPEG
    decode's (checked unequal at 4:2:0). cv2 refuses all ("not
    configured")."""
    rng = np.random.default_rng(10 + sampling[0] * 4 + sampling[1])
    p = tmp_path / "oj.tif"
    for h, w in ((16, 16), (21, 35), (8, 9), (40, 24)):
        img = _smooth(rng, h, w)
        for sub in (None, (2, 2), (1, 1), sampling):
            tags = {530: (3, list(sub))} if sub else None
            p.write_bytes(ojpeg_file(img, sampling=sampling, tags=tags))
            assert _reads_as_reference(p) == "pil"
    if sampling == (2, 2):
        plain = cv2.imdecode(np.frombuffer(jpeg_stream(img, sampling),
                                           np.uint8), cv2.IMREAD_COLOR)
        assert not np.array_equal(native.decode(str(p)), plain[:, :, ::-1])


@pytest.mark.parametrize("sampling", [(1, 1), (2, 1), (2, 2), (1, 2)])
def test_ojpeg_tables_in_tags_read_as_pil(tmp_path, sampling):
    """The tables at JPEGQTables, JPEGDCTables and JPEGACTables (chroma
    components sharing theirs), the entropy-coded data in one strip or in
    strips of 16 or 32 rows (the codec joins them with the restart markers
    it writes, its restart interval one strip's MCUs), with and without a
    JPEGRestartInterval tag."""
    rng = np.random.default_rng(20 + sampling[0] * 4 + sampling[1])
    p = tmp_path / "oj.tif"
    for h, w in ((16, 16), (40, 35), (64, 24), (9, 13)):
        img = _smooth(rng, h, w)
        for rps in (None, 16, 32):
            if rps and (rps >= h or rps % (8 * sampling[1])):
                continue
            for ri in (None, 1):
                tags = {515: (3, [ri])} if ri else None
                p.write_bytes(ojpeg_file(img, "tables", sampling, rps=rps,
                                         tags=tags))
                assert _reads_as_reference(p) == "pil"


@pytest.mark.parametrize("layout", ["stream", "tables"])
def test_ojpeg_gray_reads_as_pil(tmp_path, layout):
    """One-sample gray (Photometric 1 or 0) in one strip and in strips of
    8 rows: read through libtiff's strips. Without SamplesPerPixel (Pillow
    then takes three samples, libtiff one) or Photometric (libtiff then
    takes YCbCr of one sample), or with Photometric 6: both refuse it."""
    rng = np.random.default_rng(30 + len(layout))
    p = tmp_path / "g.tif"
    for h, w in ((16, 16), (40, 35), (9, 13)):
        gray = np.ascontiguousarray(_smooth(rng, h, w)[:, :, 1])
        for rps in (None, 8):
            if layout == "stream" and rps:
                continue
            for photometric, drop in ((1, ()), (0, ()), (1, (277,)),
                                      (1, (262,))):
                data = ojpeg_file(gray, layout, rps=rps,
                                  photometric=photometric)
                p.write_bytes(_drop_tags(data, drop))
                reader = _reads_as_reference(p)
                assert reader == ("none" if drop else "pil")
            p.write_bytes(ojpeg_file(gray, layout, rps=rps, photometric=6))
            assert _reads_as_reference(p) == "none"


def _drop_tags(data, tags):
    """``data`` with the IFD entries of ``tags`` given tag number 65000
    (unknown to both readers) in place."""
    d = bytearray(data)
    n = struct.unpack("<H", d[8:10])[0]
    for k in range(n):
        at = 10 + 12 * k
        if struct.unpack("<H", d[at:at + 2])[0] in tags:
            d[at:at + 2] = struct.pack("<H", 65000)
    return bytes(d)


def test_ojpeg_photometric_and_tag_guesses(tmp_path):
    """libtiff's guesses for old-style JPEG: Photometric missing or RGB is
    YCbCr, and SamplesPerPixel missing three samples of it (Pillow's mode
    takes photometric 6 and three samples too); one strip offset and byte
    count under PlanarConfiguration 2 is taken as contiguous. Without
    BitsPerSample libtiff takes 8 bits, Pillow's mode 1: both refuse."""
    rng = np.random.default_rng(40)
    img = _smooth(rng, 24, 20)
    p = tmp_path / "g.tif"
    for photometric, drop, extra, want in (
            (2, (), None, "pil"), (6, (262,), None, "pil"),
            (6, (277,), None, "pil"), (6, (), {284: (3, [2])}, "pil"),
            (6, (258,), None, "none"), (6, (277, 258), None, "none")):
        data = ojpeg_file(img, photometric=photometric, tags=extra)
        p.write_bytes(_drop_tags(data, drop))
        assert _reads_as_reference(p) == want, (photometric, drop, extra)


def _ojpeg_bases(rng):
    img = _smooth(rng, 40, 35)
    gray = np.ascontiguousarray(img[:, :, 0])
    return {"stream": ojpeg_file(img),
            "stream 1x1": ojpeg_file(img, sampling=(1, 1),
                                     tags={530: (3, [1, 1])}),
            "tables": ojpeg_file(img, "tables", rps=16),
            "gray tables": ojpeg_file(gray, "tables", rps=8, photometric=1),
            "gray stream": ojpeg_file(gray, photometric=1)}


@pytest.mark.parametrize("name", ["stream", "stream 1x1", "tables",
                                  "gray tables", "gray stream"])
def test_ojpeg_damage_reads_as_pil(tmp_path, name):
    """Cut points and seeded mutations of 1 to 3 bytes (the IFD, the
    stream's markers and tables, the entropy-coded data, the tables in
    tags): the port gives PIL's pixels where PIL reads (data run short,
    restart markers and tables broken, strips whose reads fail and leave
    libtiff's buffer as it was), and raises where PIL raises."""
    rng = np.random.default_rng(50 + len(name))
    base = _ojpeg_bases(rng)[name]
    p = tmp_path / "d.tif"
    readers = set()
    for cut in sorted(set(rng.integers(8, len(base), 40).tolist())):
        p.write_bytes(base[:cut])
        readers.add(_reads_as_reference(p))
    for _ in range(100):
        d = bytearray(base)
        for _ in range(int(rng.integers(1, 4))):
            d[int(rng.integers(8, len(d)))] = int(rng.integers(0, 256))
        p.write_bytes(bytes(d))
        readers.add(_reads_as_reference(p))
    assert {"pil", "none"} <= readers


def test_ojpeg_missing_tables_and_offsets(tmp_path):
    """Tables missing (no JPEGQTables tag, an offset of 0), tables or
    stream past the end of the file, a JPEGInterchangeFormat length of 0
    or past the file, strips past the file or of no bytes, byte counts of
    0, a restart interval that disagrees with the strips, and Huffman
    tables of the wrong class: PIL's pixels or its raise."""
    rng = np.random.default_rng(60)
    img = _smooth(rng, 48, 24)
    big = 1 << 30
    p = tmp_path / "m.tif"
    cases = [ojpeg_file(img, "tables", rps=16, tags=t) for t in (
        {519: (4, [0])}, {520: (4, [0, 0, 0])}, {521: (4, [big, big, big])},
        {519: (4, [big])}, {279: (4, [0, 0, 0])}, {273: (4, [big, 8, 8])},
        {273: (4, lambda o: [o[0], o[1], big])}, {515: (3, [3])},
        {521: (4, lambda o: [o[7], o[8], o[8]])},
        {520: (4, lambda o: [o[3], o[5], o[4]])})]
    cases += [ojpeg_file(img, tags=t) for t in (
        {513: (4, [big])}, {514: (4, [0])}, {514: (4, [big])},
        {514: (4, [20])}, {273: (4, [big])}, {279: (4, [0])},
        {513: (4, [0])}, {513: (4, [0]), 273: (4, [0])})]
    readers = []
    for data in cases:
        p.write_bytes(data)
        readers.append(_reads_as_reference(p))
    assert "pil" in readers and "none" in readers


def test_ojpeg_probes_and_load_batch(tmp_path):
    """The header probe gives PIL's size, generate_tree's cv2 probe (0, 0),
    and load_batch resizes the image PIL reads as PIL resizes it."""
    rng = np.random.default_rng(70)
    img = _smooth(rng, 30, 20)
    p = tmp_path / "o.tif"
    p.write_bytes(ojpeg_file(img, "tables", rps=16))
    assert native.probe([str(p)]).tolist() == [[30, 20]]
    assert native.probe([str(p)], reader="cv2").tolist() == [[0, 0]]
    want = Image.open(p).convert("RGB").resize((16, 16), Image.BILINEAR)
    np.testing.assert_array_equal(
        native.load_batch([str(p)], 16, resize="pil")[0], np.asarray(want))


# ------------------------------------------------------------ C13

def _webp_files():
    rng = np.random.default_rng(80)
    img = _smooth(rng, 20, 24)
    webp = cv2.imencode(".webp", img)[1].tobytes()
    tile = cv2.imencode(".webp", np.zeros((16, 16, 3), np.uint8))[1].tobytes()
    return {"strip": writers.tiff_file(img, compression=50001,
                                       strips=[webp]),
            "tiles": writers.tiff_file(img, compression=50001,
                                       tile=(16, 16), strips=[tile] * 4),
            "damaged": writers.tiff_file(img, compression=50001,
                                         strips=[webp[:len(webp) // 2]]),
            "planar 2": writers.tiff_file(img, compression=50001, planar=2,
                                          strips=[webp] * 3),
            "gray": writers.tiff_file(img[:, :, 0], compression=50001,
                                      strips=[webp])}


@pytest.mark.parametrize("name", sorted(_webp_files()))
def test_webp_in_tiff_reads_as_unreadable(tmp_path, name):
    """C13: a WebP-compressed TIFF (50001) in strips, tiles, separate
    planes, gray or with its stream cut: cv2 gives None ("not configured")
    and Pillow raises at load ("WEBP compression support is not
    configured"), so the port raises "failed to decode", not naming TIFF;
    the cv2 probe gives (0, 0), the header probe raises without naming
    TIFF and load_batch raises "decoded 0/1"."""
    p = tmp_path / "w.png"
    p.write_bytes(_webp_files()[name])
    assert _reads_as_reference(p) == "none"
    with pytest.raises(RuntimeError, match="failed to decode"):
        native.decode(str(p))
    with pytest.raises(RuntimeError, match="failed to decode"):
        native.probe([str(p)])
    with pytest.raises(RuntimeError, match="decoded 0/1"):
        native.load_batch([str(p)], 32)


def test_lzma_in_tiff_still_names_tiff(tmp_path):
    """LZMA inside TIFF (34925, an .xz stream): Pillow reads it, cv2 gives
    None; the port does not decode it and names TIFF (queue A item 3e)."""
    rng = np.random.default_rng(81)
    img = _smooth(rng, 12, 16)
    p = tmp_path / "x.png"
    p.write_bytes(writers.tiff_file(img, compression=34925,
                                    strips=[lzma.compress(img.tobytes())]))
    np.testing.assert_array_equal(np.asarray(Image.open(p).convert("RGB")),
                                  img)
    assert cv2.imread(str(p)) is None
    with pytest.raises(RuntimeError, match="holds TIFF data"):
        native.decode(str(p))
    assert native.probe([str(p)], reader="cv2").tolist() == [[0, 0]]


# ------------------------------------------------------------ the paths

def _path_files(rng):
    img = _smooth(rng, 30, 26)
    gray = np.ascontiguousarray(img[:, :, 1])
    return {"i16s": sample_file(_values(rng, "I;16S", 30, 26), "I;16S",
                                orientation=6),
            "i32s_be": sample_file(_values(rng, "I;32S", 30, 26), "I;32S",
                                   big=True, compression=8, predictor=2),
            "f_pred3": sample_file(_values(rng, "F", 30, 26), "F",
                                   compression=8, predictor=3, rps=8),
            "f_tiles": sample_file(_values(rng, "F", 30, 26), "F",
                                   photometric=0, tile=(16, 16)),
            "i12": i12_file(rng.integers(0, 300, (30, 26)), 5, rps=8),
            "ojpeg stream": ojpeg_file(img, sampling=(2, 1)),
            "ojpeg tables": ojpeg_file(img, "tables", rps=16),
            "ojpeg gray": ojpeg_file(gray, "tables", photometric=1)}


@pytest.mark.parametrize("resize", ["cv2", "pil"])
def test_decode_resize_matches_reference(tmp_path, resize):
    """data.gtsrb._decode_resize(p, 32) against tsr_tpu's on each layout
    (PIL's pixels, then the backend's resize): equal under the PIL
    backend; under cv2's, within the 1 LSB the port's cv2-convention
    resize keeps to cv2.resize (tests/test_torch_port_codec.py), the
    decoded pixels equal (the PIL backend's check, and
    test_i_and_f_layouts_read_as_reference)."""
    rng = np.random.default_rng(90)
    saved = (gtsrb.RESIZE_BACKEND, jgtsrb.RESIZE_BACKEND)
    gtsrb.set_resize_backend(resize)
    jgtsrb.set_resize_backend(resize)
    try:
        for name, data in _path_files(rng).items():
            p = tmp_path / f"{name.replace(' ', '_')}.png"
            p.write_bytes(data)
            assert _reads_as_reference(p) == "pil"
            got = gtsrb._decode_resize(str(p), 32).astype(int)
            want = jgtsrb._decode_resize(str(p), 32).astype(int)
            assert got.shape == want.shape == (32, 32, 3)
            assert np.abs(got - want).max() <= (resize == "cv2"), name
    finally:
        gtsrb.set_resize_backend(saved[0])
        jgtsrb.set_resize_backend(saved[1])


def test_chip_smoke_built_files_match_their_digests(tmp_path):
    """chip_smoke.py's phase 13 files (tiff_modes_files: I;16S at
    orientation 6, big-endian I;32S, F with NaN, infinities, negatives and
    values past 255, I;12, F deflate with the floating-point predictor,
    old-style JPEG of each layout from the port's own JPEG writer, and the
    F and old-style JPEG files of its decode rates' size): PIL's RGB
    pixels of each hash to the digest the script holds, cv2 refuses each,
    and the port decodes each to them."""
    files = chip_smoke.tiff_modes_files(tmp_path)
    assert sorted(files) == sorted(chip_smoke.TIFF_MODES_DIGESTS)
    for name, p in files.items():
        assert cv2.imread(str(p)) is None, name
        want = np.asarray(Image.open(p).convert("RGB"))
        if name.startswith("rate_modes_"):
            assert want.shape[:2] == chip_smoke.BUILT_TIFF_SIZE
        digest = hashlib.sha256(np.ascontiguousarray(want).tobytes())
        assert digest.hexdigest() == chip_smoke.TIFF_MODES_DIGESTS[name], name
        np.testing.assert_array_equal(native.decode(str(p)), want)
        assert native.probe([str(p)]).tolist() == [list(want.shape[:2])]


def test_chip_smoke_ojpeg_writer_splits_at_restarts():
    """chip_smoke.ojpeg_bytes of a stream with restart markers: one strip
    a restart interval, the markers dropped, the tables after the strips
    at the offsets the tags give."""
    rng = np.random.default_rng(95)
    img = _smooth(rng, 48, 24)
    stream = jpeg_stream(img, (2, 2), rst_rows=1)
    data = chip_smoke.ojpeg_bytes(stream, 48, 24, "tables", rps=16)
    ifd = {}
    n = struct.unpack("<H", data[8:10])[0]
    for k in range(n):
        tag, typ, count, value = struct.unpack("<HHII",
                                               data[10 + 12 * k:22 + 12 * k])
        vals = ([value] if count == 1 else list(struct.unpack(
            f"<{count}I", data[value:value + 4 * count])))
        ifd[tag] = vals
    assert len(ifd[273]) == 3 and ifd[278] == [16]
    for off, count in zip(ifd[273], ifd[279]):
        assert not re.search(rb"\xff[\xd0-\xd7]", data[off:off + count])
    qt = next(p for m, p in chip_smoke.jpeg_segments(stream) if m == 0xDB)
    assert data[ifd[519][0]:ifd[519][0] + 64] == qt[1:65]


def test_generate_tree_skips_them_as_the_reference_does(tmp_path):
    """generate_tree("noise") through both packages over a tree of these
    layouts (PIL alone reads them; its cv2 probe skips them), a WebP TIFF
    (neither reads it) and one file cv2 reads: the same count and file
    names."""
    rng = np.random.default_rng(99)
    root = tmp_path / "src"
    files = {f"{k.replace(' ', '_')}.png": v
             for k, v in _path_files(rng).items()}
    files["webp.png"] = _webp_files()["strip"]
    files["ok.png"] = writers.tiff_file(_smooth(rng, 20, 24))
    for k, (name, data) in enumerate(sorted(files.items())):
        out = root / f"c{k % 3}" / name
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_bytes(data)
    lines = []
    n = offline.generate_tree(str(root), str(tmp_path / "ours"), "noise",
                              log=lines.append, device="cpu")
    m = joffline.generate_tree(str(root), str(tmp_path / "ref"), "noise",
                               log=quiet)
    assert n == m == 1
    assert f"Skipped {len(files) - 1} unreadable files" in lines
    ours = sorted(str(p.relative_to(tmp_path / "ours"))
                  for p in (tmp_path / "ours").glob("*/*"))
    ref = sorted(str(p.relative_to(tmp_path / "ref"))
                 for p in (tmp_path / "ref").glob("*/*"))
    assert ours == ref and len(ours) == n
