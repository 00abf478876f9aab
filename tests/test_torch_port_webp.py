"""WebP part 1, the RIFF container and lossless VP8L, read by the port as
the reference reads them (cv2.imread, else PIL's convert("RGB"), else
refused as both refuse), max diff 0:

- the fixtures of tests/data/webp (make_fixtures.py): cv2's and Pillow's
  lossless files in RGB and RGBA, few colours (2, 4, 16, 256: each
  bundling width), content large enough for Pillow's meta prefix codes,
  animations (the first frame, one at an offset on a larger canvas; the
  canvas around it zeros), EXIF orientations 2-8 (which cv2 applies and
  PIL does not), an ICC and an unknown chunk, trailing bytes, an EXIF
  chunk running past the file and a reserved VP8X flag (WebPDemux refuses
  both: cv2 reads them unrotated, PIL not at all), and streams
  chip_smoke.vp8l_bytes writes with each VP8L feature; under skip/ a valid
  1 x 1 file of 28 bytes (PIL reads it, cv2 wants 32) and the layouts and
  streams both readers refuse: decode raises "failed to decode", never
  naming WebP, the cv2 probe gives (0, 0), load_batch raises; a lossy
  still image and animation read as cv2 reads them (WebP part 2's decoder,
  whose own tests are test_torch_port_webp_lossy.py);
- each VP8L feature held also to libwebp itself (Pillow's bundled libwebp
  through ctypes, alpha included) and to the pixels written: the 16
  predictor modes, colour caches of 1 to 11 bits, colour indexing at every
  colour count's bundling, each of the 120 distance-map codes;
- every cut point of three fixtures and 1,200 seeded bit flips;
- header-only animations at cv2's size limits (C10): cv2 raises past 2^20
  a side or 2^30 pixels, PIL reads up to its own limit;
- data.gtsrb._decode_resize and generate_tree against tsr_tpu's, and the
  640 x 480 file phase 13 of chip_smoke.py builds, which cv2 and PIL read
  equal to its source.
"""

import ctypes
import importlib.util
import io
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
FIXTURES = HERE / "data" / "webp"
_spec = importlib.util.spec_from_file_location(
    "webp_fixtures", FIXTURES / "make_fixtures.py")
make_fixtures = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(make_fixtures)
cases = make_fixtures.image_cases
chip_smoke = cases.chip_smoke
EXPECTED = np.load(FIXTURES / "expected.npz")
CASES, SKIPS = make_fixtures.names()
SIZE = 32
quiet = lambda s: None  # noqa: E731
# skip cases whose container both readers refuse (the header probe too);
# the others are refused in their VP8L data, past what a header shows
CONTAINER_REFUSED = ("webp_cut.png", "webp_canvas_14x10.png",
                     "webp_canvas_12x11.png", "webp_frame_overflow.png",
                     "webp_riff_plus_8.png", "webp_riff_minus_2.png",
                     "webp_bad_later_frame.png", "webp_version_1.png")


def _libwebp():
    """Pillow's bundled libwebp (its decoder, the readers' own)."""
    lib = cases._libwebp()
    lib.WebPDecodeRGBA.restype = ctypes.POINTER(ctypes.c_uint8)
    lib.WebPDecodeRGBA.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                                   ctypes.POINTER(ctypes.c_int),
                                   ctypes.POINTER(ctypes.c_int)]
    lib.WebPFree.argtypes = [ctypes.c_void_p]
    return lib


LIBWEBP = _libwebp()


def libwebp_rgba(data):
    """WebPDecodeRGBA's pixels, or None where it fails."""
    w, h = ctypes.c_int(), ctypes.c_int()
    p = LIBWEBP.WebPDecodeRGBA(data, len(data), ctypes.byref(w),
                               ctypes.byref(h))
    if not p:
        return None
    out = np.ctypeslib.as_array(p, (h.value, w.value, 4)).copy()
    LIBWEBP.WebPFree(p)
    return out


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
    """probe(reader="cv2") gives cv2's (h, w), (0, 0) where cv2 gives None
    and marks a raise; decode equals cv2, else PIL, max diff 0, else
    raises without naming WebP; where a reader reads, the header probe
    gives its size. Returns the reader."""
    reader, want = _reference(path)
    dims, raised = native.probe([str(path)], reader="cv2", raises=True)
    assert dims.tolist() == ([list(want.shape[:2])] if reader == "cv2"
                             else [[0, 0]]), path
    assert raised.tolist() == [reader == "raise"]
    try:
        got = native.decode(str(path))
    except RuntimeError as e:
        assert "WebP" not in str(e), (path, e)
        got = None
    if want is None:
        assert got is None, (reader, path)
        return reader
    assert got is not None, (reader, path)
    np.testing.assert_array_equal(got, want, err_msg=str(path))
    assert native.probe([str(path)]).tolist() == [list(want.shape[:2])]
    return reader


# --------------------------------------------------------- the fixtures

@pytest.mark.parametrize("name", CASES)
def test_fixture_decodes_as_cv2(name):
    """Every WebP fixture cv2 reads: decode equals expected.npz (cv2's
    pixels), max diff 0; both probes give its (h, w); load_batch and
    load_canvas read it."""
    p = str(FIXTURES / name)
    want = EXPECTED[f"decoded__{name}"]
    np.testing.assert_array_equal(native.decode(p), want)
    for reader in ("cv2", "port"):
        assert native.probe([p], reader=reader).tolist() == [
            list(want.shape[:2])]
    assert native.load_batch([p], SIZE).shape == (1, SIZE, SIZE, 3)
    canvas = np.zeros((1, 64, 64, 3), np.uint8)
    assert native.load_canvas([p], canvas).tolist() == [list(want.shape[:2])]
    np.testing.assert_array_equal(canvas[0, :want.shape[0], :want.shape[1]],
                                  want)


@pytest.mark.parametrize("name", SKIPS)
def test_skip_class_reads_as_reference(name):
    """Each file cv2.imread gives None for: the cv2 probe gives (0, 0);
    decode gives PIL's pixels where PIL reads it (the 28-byte file, whose
    header probe gives its size) and otherwise raises "failed to decode"
    (not naming WebP), load_batch "decoded 0/1"; the header probe refuses
    a container both readers refuse."""
    p = str(FIXTURES / "skip" / name)
    assert native.probe([p], reader="cv2").tolist() == [[0, 0]]
    key = f"decoded_skip__{name}"
    if key in EXPECTED.files:
        want = EXPECTED[key]
        np.testing.assert_array_equal(native.decode(p), want)
        assert native.probe([p]).tolist() == [list(want.shape[:2])]
        return
    with pytest.raises(RuntimeError, match="failed to decode"):
        native.decode(p)
    with pytest.raises(RuntimeError, match="decoded 0/1"):
        native.load_batch([p], SIZE)
    if name in CONTAINER_REFUSED:
        with pytest.raises(RuntimeError, match="failed to decode"):
            native.probe([p])


def test_committed_fixtures_equal_cv2_and_pil(tmp_path):
    """The committed files equal what make_fixtures writes here, each case
    and skip case reads as the reference reads it now (cv2 and PIL
    live), expected.npz holds what they read, and the directory stays
    small."""
    fresh = make_fixtures.make(tmp_path)
    assert sorted(fresh) == sorted(EXPECTED.files)
    for key in EXPECTED.files:
        np.testing.assert_array_equal(fresh[key], EXPECTED[key], err_msg=key)
    readers = {}
    for name in CASES:
        p = FIXTURES / name
        assert p.read_bytes() == (tmp_path / name).read_bytes(), name
        readers[name] = _reads_as_reference(p)
    for name in SKIPS:
        p = FIXTURES / "skip" / name
        assert p.read_bytes() == (tmp_path / "skip" / name).read_bytes()
        readers[name] = _reads_as_reference(p)
    assert {readers[n] for n in CASES} == {"cv2"}
    assert [n for n in SKIPS if readers[n] == "pil"] == [
        "webp_tiny_28_bytes.png"]
    assert int(EXPECTED["generate_tree_written"]) == len(CASES)
    assert sum(p.stat().st_size for p in FIXTURES.rglob("*")
               if p.is_file()) < 120 * 1024


def test_fixtures_hold_what_they_name():
    """The fixtures differ where their names say: cv2 rotates by the EXIF
    orientation and PIL does not (each of 2-8 transposes or flips), the
    file whose EXIF chunk runs past the end and the one with a reserved
    flag read unrotated by cv2 and not at all by PIL, the animation's
    canvas is zero around its first frame, and the RGBA files carry alpha
    that both readers drop."""
    for o in range(2, 9):
        p = FIXTURES / f"webp_exif_{o}.png"
        pil = np.asarray(Image.open(p).convert("RGB"))
        got = EXPECTED[f"decoded__{p.name}"]
        assert got.shape[:2] == (pil.shape[:2][::-1] if o >= 5
                                 else pil.shape[:2])
        if o < 5:
            assert not np.array_equal(got, pil)
    for name in ("webp_exif_past_end.png", "webp_reserved_flag.png"):
        got = EXPECTED[f"decoded__{name}"]
        assert got.shape[:2] == (10, 12)
        with pytest.raises(OSError):
            Image.open(FIXTURES / name).convert("RGB")
    anim = EXPECTED["decoded__webp_anim_offset.png"]
    assert anim.shape == (16, 20, 3)
    frame = anim[2:12, 4:16]
    rest = anim.copy()
    rest[2:12, 4:16] = 0
    assert frame.max() > 0 and rest.max() == 0
    for name in ("webp_pil_rgba.png", "webp_vp8l_cache_1.png"):
        assert Image.open(FIXTURES / name).mode == "RGBA"


# ------------------------------------------- each VP8L feature, by hand

WRITTEN = cases.webp_writer_cases(np.random.default_rng(cases.WEBP_SEED + 1))


def _vp8l_reads_as_written(tmp_path, img, payload, name="f.png"):
    """A VP8L stream in a simple RIFF file: libwebp decodes it to ``img``
    (RGBA, max diff 0), and the port reads it as the reference."""
    data = chip_smoke.webp_riff([(b"VP8L", payload)])
    rgba = libwebp_rgba(data)
    assert rgba is not None
    if img.shape[2] == 3:
        img = np.concatenate([img, np.full(img.shape[:2] + (1,), 255,
                                           np.uint8)], 2)
    np.testing.assert_array_equal(rgba, img)
    p = tmp_path / name
    p.write_bytes(data)
    assert _reads_as_reference(p) == ("cv2" if len(data) >= 32 else "pil")
    np.testing.assert_array_equal(native.decode(str(p)), img[..., :3])


@pytest.mark.parametrize("name", sorted(WRITTEN))
def test_written_feature_reads_as_reference(tmp_path, name):
    """Each of webp_writer_cases' streams (a fresh draw, not the
    fixtures'): libwebp, cv2 and PIL decode it alike, and so does the
    port."""
    p = tmp_path / f"{name}.png"
    p.write_bytes(chip_smoke.webp_riff([(b"VP8L", WRITTEN[name])]))
    assert libwebp_rgba(p.read_bytes()) is not None
    assert _reads_as_reference(p) == "cv2"


@pytest.mark.parametrize("mode", range(16))
def test_predictor_mode(tmp_path, mode):
    """A predictor transform with every block in one mode (0-13; 14 and 15
    predict opaque black, as 0), on RGBA noise, so each channel's sums
    and clamps (modes 11-13) run: the pixels written, max diff 0."""
    rng = np.random.default_rng(700 + mode)
    img = rng.integers(0, 256, (13, 11, 4)).astype(np.uint8)
    img[4:9, 3:8] = (250, 3, 128, 255)
    modes = np.full((4, 3), mode)
    _vp8l_reads_as_written(tmp_path, img, chip_smoke.vp8l_bytes(
        img, [("predictor", 2, modes), ("cross", 3, rng.integers(
            -128, 128, (2, 2, 3)))]))


@pytest.mark.parametrize("bits", range(1, 12))
def test_colour_cache(tmp_path, bits):
    """Colour caches of 1 to 11 bits (the hash's top bits of argb x
    0x1e35a7bd), on few colours so most pixels are cache hits."""
    rng = np.random.default_rng(800 + bits)
    img = cases.webp_palette_image(rng, 40, 14, 15)
    _vp8l_reads_as_written(tmp_path, img, chip_smoke.vp8l_bytes(
        img, cache_bits=bits, lz77=False))


@pytest.mark.parametrize("k", [1, 2, 3, 4, 5, 16, 17, 255, 256])
def test_colour_indexing(tmp_path, k):
    """Colour indexing over k colours: 8, 4, 2 or 1 pixels a byte, widths
    that leave a byte part full, the palette delta-coded."""
    rng = np.random.default_rng(900 + k)
    img = cases.webp_palette_image(rng, k, 17 if k < 200 else 16, 19)
    _vp8l_reads_as_written(tmp_path, img, chip_smoke.vp8l_bytes(
        img, [("palette",)]))


@pytest.mark.parametrize("code", range(1, 121))
def test_distance_map_code(tmp_path, code):
    """Distance code ``code`` of the 120-entry map on an image 5 wide
    (where dx + dy x 5 falls below 1, the distance is 1): nine rows of
    literals, then one copy of a row."""
    rng = np.random.default_rng(1000 + code)
    w = 5
    px = rng.integers(0, 256, (9 * w, 3))
    argb = (0xff000000 | px[:, 0] << 16 | px[:, 1] << 8 | px[:, 2]).tolist()
    dx, dy = chip_smoke.VP8L_PLANE[code - 1]
    dist = max(dx + dy * w, 1)
    full = list(argb)
    for _ in range(w):  # a copy reads the pixels it has just written
        full.append(full[-dist])
    img = np.array([(a >> 16 & 255, a >> 8 & 255, a & 255) for a in full],
                   np.uint8).reshape(10, w, 3)
    tokens = [("lit", a) for a in argb] + [("copy", w, code)]
    _vp8l_reads_as_written(tmp_path, img, chip_smoke.vp8l_bytes(
        img, tokens=tokens))


def test_written_640x480_file(tmp_path):
    """The file phase 13 builds on the card (chip_smoke.webp_built): cv2,
    PIL and libwebp read it equal to its source, and so does the port."""
    img, data = chip_smoke.webp_built()
    assert img.shape == (480, 640, 3)
    p = tmp_path / "built.png"
    p.write_bytes(data)
    np.testing.assert_array_equal(cv2.imread(str(p))[:, :, ::-1], img)
    np.testing.assert_array_equal(
        np.asarray(Image.open(p).convert("RGB")), img)
    np.testing.assert_array_equal(libwebp_rgba(data)[..., :3], img)
    np.testing.assert_array_equal(native.decode(str(p)), img)


def test_header_probe_reads_exif_past_64_kib(tmp_path):
    """The header probe walks a WebP's chunks by seeking: a VP8X file of
    the built image whose EXIF chunk (orientation 6) lies past the first 64
    KiB probes at cv2's rotated size, as it decodes."""
    img, data = chip_smoke.webp_built()
    payload = dict(cases.webp_chunks(data))[b"VP8L"]
    p = tmp_path / "rotated.png"
    p.write_bytes(chip_smoke.webp_riff([
        cases.vp8x(640, 480, 0x08), (b"VP8L", payload),
        (b"EXIF", cases.exif_tiff(6))]))
    assert p.stat().st_size > 1 << 17
    assert _reads_as_reference(p) == "cv2"
    assert native.probe([str(p)]).tolist() == [[640, 480]]


# -------------------------------------------------- containers, by hand

def test_raw_vp8l_stream_and_file_size_limit(tmp_path):
    """A raw VP8L stream (no RIFF) of 32 bytes or more, which cv2 reads and
    PIL does not, and one shorter, which neither reads; a file past 64 MiB
    (trailing zeros after a valid file), which cv2 refuses
    (OPENCV_IMGCODECS_WEBP_MAX_FILE_SIZE) and PIL reads."""
    rng = np.random.default_rng(61)
    img = cases.smooth(rng, 9, 10)
    raw = chip_smoke.vp8l_bytes(img)
    assert len(raw) >= 32
    for name, data, reader in (("raw.png", raw, "cv2"),
                               ("raw_short.png", chip_smoke.vp8l_bytes(
                                   np.zeros((1, 1, 3), np.uint8)), "none")):
        p = tmp_path / name
        p.write_bytes(data)
        assert _reads_as_reference(p) == reader
    p = tmp_path / "big.png"
    p.write_bytes(chip_smoke.webp_riff([(b"VP8L", raw)]) + bytes(64 << 20))
    assert _reads_as_reference(p) == "pil"


def test_lossy_image_decodes_as_cv2(tmp_path):
    """Where the image a reader decodes is lossy (a still VP8X of a "VP8 "
    chunk, an animation whose first frame is, the second lossless), the
    reader paths read it as cv2 does (its lossy decode, WebP part 2), as
    for Pillow's default file; both probes give its size."""
    rng = np.random.default_rng(62)
    buf = io.BytesIO()
    Image.fromarray(cases.smooth(rng, 8, 8)).save(buf, "WEBP")
    vp8 = dict(cases.webp_chunks(buf.getvalue()))[b"VP8 "]
    lossless = chip_smoke.vp8l_bytes(cases.smooth(rng, 8, 8))
    files = {"still.png": chip_smoke.webp_riff([cases.vp8x(8, 8, 0),
                                                (b"VP8 ", vp8)]),
             "anim.png": chip_smoke.webp_riff([
                 cases.vp8x(8, 8, 0x02), (b"ANIM", bytes(6)),
                 cases.anmf(0, 0, 8, 8, [(b"VP8 ", vp8)]),
                 cases.anmf(0, 0, 8, 8, [(b"VP8L", lossless)])])}
    for name, data in files.items():
        p = tmp_path / name
        p.write_bytes(data)
        want = cv2.imread(str(p))[:, :, ::-1]
        np.testing.assert_array_equal(native.decode(str(p)), want)
        assert native.load_batch([str(p)], SIZE).shape == (1, SIZE, SIZE, 3)
        for reader in ("port", "cv2"):
            assert native.probe([str(p)], reader=reader).tolist() == [[8, 8]]


# the canvases of header-only animations (one 1 x 1 frame) at cv2's limits
SIZES = [(1 << 20, 16), ((1 << 20) + 1, 16), (16, (1 << 20) + 1),
         (40000, 30000), (1 << 24, 1), (1 << 24, 256), (1 << 23, 128)]


def _anim_header(w, h, still=False):
    frame = chip_smoke.vp8l_bytes(np.full((1, 1, 3), 90, np.uint8))
    if still:  # a still image in a canvas of another size
        return chip_smoke.webp_riff([cases.vp8x(w, h, 0),
                                     (b"VP8L", frame)])
    return chip_smoke.webp_riff([cases.vp8x(w, h, 0x02),
                                 (b"ANIM", bytes(6)),
                                 cases.anmf(0, 0, 1, 1, [(b"VP8L", frame)])])


def _cv2_outcome(path):
    try:
        img = cv2.imread(str(path))
    except cv2.error:
        return "raise"
    return "none" if img is None else "read"


@pytest.mark.parametrize("w,h,still", [s + (False,) for s in SIZES]
                         + [((1 << 20) + 1, 1, True)])
def test_header_sizes_raise_where_cv2_raises(tmp_path, w, h, still):
    """cv2.imread raises on a canvas past imread's size rule (sides 1 to
    2^20, 2^30 pixels; a still VP8X's canvas is checked before its image
    is), gives None past libwebp's 2^32-pixel area (PIL too), reads the
    rest (the canvas zeros but for its 1 x 1 frame); the port's cv2 probe
    marks the same, and the reader paths raise naming the rule where cv2
    raises, else read as the reference."""
    p = tmp_path / "h.png"
    p.write_bytes(_anim_header(w, h, still))
    want = _cv2_outcome(p)
    (dims,), (raised,) = native.probe([str(p)], reader="cv2", raises=True)
    got = "raise" if raised else "none" if dims[0] == 0 else "read"
    assert got == want, (w, h, want)
    if want == "raise":
        for call in (lambda: native.decode(str(p)),
                     lambda: native.load_batch([str(p)], SIZE),
                     lambda: native.probe([str(p)])):
            with pytest.raises(RuntimeError, match="cv2.imread raises"):
                call()
        return
    _reads_as_reference(p)


def test_header_sizes_give_each_outcome(tmp_path):
    """The sizes above give all three of cv2's outcomes."""
    seen = set()
    for w, h in SIZES:
        p = tmp_path / "h.png"
        p.write_bytes(_anim_header(w, h))
        seen.add(_cv2_outcome(p))
    assert seen == {"raise", "read", "none"}


# ---------------------------------------------------------------- damage

CUT_FIXTURES = ("webp_exif_6.png", "webp_vp8l_three_transforms.png",
                "webp_anim_3_frames.png")
CUT_BLOCK = 128


def _cut_cases():
    out = []
    for name in CUT_FIXTURES:
        n = (FIXTURES / name).stat().st_size
        out += [(name, lo) for lo in range(0, n, CUT_BLOCK)]
    return out


@pytest.mark.parametrize("name,lo", _cut_cases())
def test_cut_points_read_as_reference(tmp_path, name, lo):
    """Every cut point of three fixtures (a still VP8X with EXIF, a stream
    of three transforms, a three-frame animation), CUT_BLOCK a case: the
    port reads or refuses exactly where the reference does."""
    data = (FIXTURES / name).read_bytes()
    p = tmp_path / "cut.png"
    for cut in range(lo, min(lo + CUT_BLOCK, len(data))):
        p.write_bytes(data[:cut])
        _reads_as_reference(p)


@pytest.mark.parametrize("seed", range(8))
def test_bit_flips_read_as_reference(tmp_path, seed):
    """150 seeded single-bit flips a seed over the fixtures cv2 reads (1,200
    in all): the port reads or refuses exactly where the reference does,
    with its pixels, orientation included."""
    rng = np.random.default_rng(3000 + seed)
    p = tmp_path / "flip.png"
    for _ in range(150):
        src = FIXTURES / CASES[int(rng.integers(len(CASES)))]
        data = bytearray(src.read_bytes())
        i = int(rng.integers(len(data)))
        data[i] ^= 1 << int(rng.integers(8))
        p.write_bytes(bytes(data))
        _reads_as_reference(p)


def test_riff_and_chunk_sizes(tmp_path):
    """RIFF sizes 8 too large and 2 too small, 1 to 7 trailing bytes, a
    VP8X chunk of 12 bytes (both refuse: the decoder wants 10), an odd
    chunk's padding byte missing at the end: each read as the reference
    reads it."""
    rng = np.random.default_rng(63)
    still = chip_smoke.vp8l_bytes(cases.smooth(rng, 7, 9))
    plain = chip_smoke.webp_riff([(b"VP8L", still)])
    ext = chip_smoke.webp_riff([cases.vp8x(9, 7, 0x08), (b"VP8L", still),
                                (b"EXIF", cases.exif_tiff(3))])
    files = [cases.with_riff_size(plain, 8), cases.with_riff_size(plain, -2),
             cases.with_riff_size(ext, 8), cases.with_riff_size(ext, -2),
             chip_smoke.webp_riff([cases.vp8x(9, 7, 0, size=12),
                                   (b"VP8L", still)])]
    files += [plain + bytes(k) for k in range(1, 8)]
    files += [ext + bytes(k) for k in (1, 7)]
    odd = chip_smoke.webp_riff([(b"VP8L", still + b"\x00" * (
        1 - len(still) % 2))])
    files += [odd[:-1], cases.with_riff_size(odd[:-1], -1)]
    # RIFF 8 too large and 2 too small are refused by both, but cv2 reads
    # the extended file 2 too small, whose last chunk (EXIF) WebPDemux
    # refuses, unrotated; trailing bytes are read by both; the odd chunk's
    # missing pad byte is refused while the RIFF size counts it, read by
    # cv2 once the RIFF size does not
    readers = []
    for k, data in enumerate(files):
        p = tmp_path / f"s{k}.png"
        p.write_bytes(data)
        readers.append(_reads_as_reference(p))
    assert readers == ["none"] * 3 + ["cv2", "none"] + ["cv2"] * 9 + [
        "none", "cv2"]


# ----------------------------------------------------------- the paths

def _tree(root):
    """Every WebP case and skip case in a three-class tree."""
    files = [FIXTURES / n for n in CASES] + [FIXTURES / "skip" / n
                                              for n in SKIPS]
    for k, p in enumerate(files):
        out = root / f"c{k % 3}" / p.name
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_bytes(p.read_bytes())
    return root


def test_generate_tree_writes_what_the_reference_writes(tmp_path):
    """generate_tree("noise") through both packages on the tree of every
    WebP fixture: the same count (the files cv2 reads) and file names, the
    rest logged as skipped."""
    src = _tree(tmp_path / "src")
    lines = []
    n = offline.generate_tree(str(src), str(tmp_path / "ours"), "noise",
                              log=lines.append, device="cpu")
    m = joffline.generate_tree(str(src), str(tmp_path / "ref"), "noise",
                               log=quiet)
    want = int(EXPECTED["generate_tree_written"])
    assert n == m == want
    assert f"Skipped {len(CASES) + len(SKIPS) - want} unreadable files" in (
        lines)
    ours = sorted(str(p.relative_to(tmp_path / "ours"))
                  for p in (tmp_path / "ours").glob("*/*"))
    ref = sorted(str(p.relative_to(tmp_path / "ref"))
                 for p in (tmp_path / "ref").glob("*/*"))
    assert ours == ref and len(ours) == want


READABLE = [FIXTURES / n for n in CASES] + [
    FIXTURES / "skip" / k.split("__", 1)[1] for k in EXPECTED.files
    if k.startswith("decoded_skip__")]


@pytest.mark.parametrize("resize", ["cv2", "pil"])
def test_decode_resize_and_image_folder_match_reference(tmp_path, resize):
    """gtsrb._decode_resize at SIZE within 1 LSB of tsr_tpu's (cv2.imread,
    else PIL, then its resize) on every readable WebP fixture, and the
    port's ImageFolder loads them as tsr_tpu's does."""
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


def test_load_batch_matches_decode_then_resize():
    """load_batch of the readable fixtures on four threads equals each
    image loaded alone (the batch path reads WebP as decode does)."""
    paths = [str(p) for p in READABLE]
    batch = native.load_batch(paths, SIZE, threads=4)
    for p, got in zip(paths, batch):
        np.testing.assert_array_equal(got, native.load_batch([p], SIZE)[0])
