"""JPEG 2000 part 1 (the JP2 file and the raw codestream: lossless 5/3 and
lossy 9/7, tiles and tile-parts, layers, the five progression orders,
precincts, code-blocks of 4 to 64 a side, SOP and EPH) read by the port as
the reference reads it (cv2.imread, else PIL's convert("RGB"), else
refused as both refuse), max diff 0:

- the fixtures of tests/data/jpeg2000 (make_fixtures.py): cv2's writer,
  Pillow's with every option, OpenJPEG's encoder through ctypes (SOP and
  EPH markers), tile-parts split and interleaved, Psot 0, SOP markers
  added, precisions 12 and 16, trailing bytes, and the 640 x 480 9/7 file
  phase 13 of chip_smoke.py times (its digest); under skip/ the files cv2
  refuses: those PIL reads (an image offset, a raw codestream of 1 or 2
  components, 16-bit gray, signed samples, precisions under 8, a JP2
  without its colr box) and the damaged files both refuse, which decode
  raises "failed to decode" for, never naming JPEG 2000;
- each fixture's components against OpenJPEG's own opj_decode (Pillow's
  bundled libopenjp2 through ctypes), before either reader converts them;
- the header probe, for every fixture and reader path, at decode's size;
- cv2's and PIL's conversions of 16-bit and signed samples;
- the feature the port leaves out (sub-sampled components) raising naming
  JPEG 2000;
- every cut point of three fixtures and seeded byte mutations;
- generate_tree, restore_tree and evaluate_directory against tsr_tpu's on
  a tree of JPEG 2000 files.
"""

import ctypes
import hashlib
import importlib.util
from pathlib import Path

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tsr_tpu import eval as jeval
from tsr_tpu import infer as jinfer
from tsr_tpu import offline as joffline
from tsr_tpu.data import gtsrb as jgtsrb
from tsr_tpu.models import ResUNet as JResUNet
from tsr_tpu.models import VGG16 as JVGG16
from tsr_tpu_torch import checkpoint, native, offline
from tsr_tpu_torch import eval as teval
from tsr_tpu_torch import infer as tinfer
from tsr_tpu_torch.data import gtsrb
from tsr_tpu_torch.models import ResUNet, VGG16
from test_torch_port_webp import _reference

torch.set_num_threads(2)
HERE = Path(__file__).resolve().parent
FIXTURES = HERE / "data" / "jpeg2000"
_spec = importlib.util.spec_from_file_location(
    "jpeg2000_fixtures", FIXTURES / "make_fixtures.py")
make_fixtures = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(make_fixtures)
cases = make_fixtures.cases_module
chip_smoke = make_fixtures.chip_smoke
EXPECTED = np.load(FIXTURES / "expected.npz")
CASES, SKIPS = make_fixtures.names()
BIG = make_fixtures.BIG
PIL_SKIPS = tuple(n for n in SKIPS if f"decoded_skip__{n}" in EXPECTED.files)
SIZE = 32
HI = jax.lax.Precision.HIGHEST
SMALL_CFG = (8, 8, "M", 16, "M", 16, "M")
quiet = lambda s: None  # noqa: E731
NAMED = "holds JPEG 2000 data, which the port does not decode"


def _path(name):
    return FIXTURES / (name if name in CASES or name == BIG else
                       f"skip/{name}")


def port_components(data):
    """The port's components (tsrio_jpeg2000_planes): (x0, y0, [int32
    [h, w] per component]), or None."""
    cap = 1 << 22
    buf = np.zeros(cap, np.int32)
    info = (ctypes.c_int * 5)()
    if not native._lib().tsrio_jpeg2000_planes(
            data, len(data), buf.ctypes.data_as(
                ctypes.POINTER(ctypes.c_int32)), cap, info):
        return None
    nc, h, w = info[0], info[1], info[2]
    return info[3], info[4], [buf[k * h * w:(k + 1) * h * w].reshape(h, w)
                              for k in range(nc)]


def unsupported_feature(data):
    """The feature the port leaves out (ROADMAP item 8d) that ``data``
    uses, by its headers, or None: sub-sampled components."""
    at = cases.codestream_at(data)
    if at < 0:
        return None
    p = at + 2
    while p + 4 <= len(data):
        m = int.from_bytes(data[p:p + 2], "big")
        n = int.from_bytes(data[p + 2:p + 4], "big")
        body = data[p + 4:p + 2 + n]
        if m == 0xFF51 and len(body) >= 36:
            comps = body[36:]
            if any(comps[i + 1] != 1 or comps[i + 2] != 1
                   for i in range(0, len(comps) - 2, 3)):
                return "sub-sampled components"
        if m in (0xFF93, 0xFF90) or n < 2:
            if m == 0xFF90:
                p += 12
                continue
            break
        p += 2 + n
    return None


def _reads_as_reference(path):
    """probe(reader="cv2") gives cv2's (h, w), (0, 0) where cv2 gives None
    and marks a raise; decode equals cv2, else PIL, max diff 0, else raises
    "failed to decode"; it names JPEG 2000 only for a file of a feature
    the port leaves out. Where a reader reads, the header probe gives its
    size. Returns the reader ("named" for such a file)."""
    data = Path(path).read_bytes()
    reader, want = _reference(path)
    try:
        got = native.decode(str(path))
    except RuntimeError as e:
        if "JPEG 2000" in str(e):
            assert unsupported_feature(data), (path, reader)
            return "named"
        got = None
    dims, raised = native.probe([str(path)], reader="cv2", raises=True)
    assert dims.tolist() == ([list(want.shape[:2])] if reader == "cv2"
                             else [[0, 0]]), path
    assert raised.tolist() == [reader == "raise"]
    if want is None:
        assert got is None, (reader, path)
        return reader
    assert got is not None, (reader, path)
    np.testing.assert_array_equal(got, want, err_msg=str(path))
    assert native.probe([str(path)]).tolist() == [list(want.shape[:2])]
    return reader


# --------------------------------------------------------- the fixtures

@pytest.mark.parametrize("name", CASES + (BIG,))
def test_fixture_decodes_as_cv2(name):
    """Every fixture cv2 reads: decode equals expected.npz (cv2's pixels;
    the big file its digest), max diff 0; both probes give its (h, w);
    load_batch and load_canvas read it."""
    p = str(FIXTURES / name)
    img = native.decode(p)
    if name == BIG:
        assert img.shape[:2] == chip_smoke.JPEG2000_BIG_SIZE
        assert hashlib.sha256(img.tobytes()).hexdigest() == (
            chip_smoke.JPEG2000_BIG_DIGEST)
        want = img
    else:
        want = EXPECTED[f"decoded__{name}"]
        np.testing.assert_array_equal(img, want)
    for reader in ("cv2", "port"):
        assert native.probe([p], reader=reader).tolist() == [
            list(want.shape[:2])]
    assert native.load_batch([p], SIZE).shape == (1, SIZE, SIZE, 3)
    side = max(64, *want.shape[:2])
    canvas = np.zeros((1, side, side, 3), np.uint8)
    assert native.load_canvas([p], canvas).tolist() == [list(want.shape[:2])]
    np.testing.assert_array_equal(canvas[0, :want.shape[0], :want.shape[1]],
                                  want)


@pytest.mark.parametrize("name", SKIPS)
def test_skip_class_reads_as_reference(name):
    """Each file cv2.imread gives None for: the cv2 probe gives (0, 0);
    decode gives PIL's pixels where PIL reads it, and otherwise raises
    "failed to decode" (not naming JPEG 2000), load_batch "decoded
    0/1"."""
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


def test_committed_fixtures_equal_cv2_and_pil(tmp_path):
    """The committed files equal what make_fixtures writes here, each case
    and skip case reads as the reference reads it now (cv2 and PIL live),
    expected.npz holds what they read, the big file's digest is cv2's, and
    the directory stays under 200 KiB."""
    fresh = make_fixtures.make(tmp_path)
    assert sorted(fresh) == sorted(EXPECTED.files)
    for key in EXPECTED.files:
        np.testing.assert_array_equal(fresh[key], EXPECTED[key], err_msg=key)
    readers = {}
    for name in CASES + (BIG,):
        p = FIXTURES / name
        assert p.read_bytes() == (tmp_path / name).read_bytes(), name
        readers[name] = _reads_as_reference(p)
    for name in SKIPS:
        p = FIXTURES / "skip" / name
        assert p.read_bytes() == (tmp_path / "skip" / name).read_bytes()
        readers[name] = _reads_as_reference(p)
    assert {readers[n] for n in CASES + (BIG,)} == {"cv2"}
    assert sorted(n for n in SKIPS if readers[n] == "pil") == sorted(
        PIL_SKIPS)
    part2 = [n for n in PIL_SKIPS if n.startswith("j2k2_")]
    assert len(PIL_SKIPS) - len(part2) == 10 and len(part2) == 3
    assert all(readers[n] == "none" for n in SKIPS if n not in PIL_SKIPS)
    img, data = make_fixtures.build_big()
    assert (FIXTURES / BIG).read_bytes() == data
    ref = cv2.imread(str(FIXTURES / BIG))[:, :, ::-1].copy()
    assert hashlib.sha256(ref.tobytes()).hexdigest() == (
        chip_smoke.JPEG2000_BIG_DIGEST)
    assert np.abs(ref.astype(int) - img).mean() < 4  # lossy, near its source
    assert int(EXPECTED["generate_tree_written"]) == len(CASES) + 1
    assert sum(p.stat().st_size for p in FIXTURES.rglob("*")
               if p.is_file()) < 200 * 1024


def test_fixtures_hold_what_they_name():
    """The fixtures carry the features their names claim: the transform,
    progression order, layers, precincts, code-blocks, tiles and
    tile-parts, SOP and EPH markers, the image offset, the precision."""
    def cod(name):
        return cases.cod_fields(_path(name).read_bytes())

    for order, k in (("lrcp", 0), ("rlcp", 1), ("rpcl", 2), ("pcrl", 3),
                     ("cprl", 4)):
        scod, prog, layers, mct, *_ = cod(f"j2k_pil_{order}_precincts_16.png")
        assert (scod & 1, prog, layers, mct) == (1, k, 2, 1)
    assert cod("j2k_pil_97.jpg")[-1] == 0 and cod(
        "j2k_pil_lossless.png")[-1] == 1
    assert cod("j2k_pil_cblk_4x4.png")[5:7] == (0, 0)
    assert cod("j2k_pil_cblk_64x4.jpg")[5:7] == (4, 0)
    assert cod("j2k_opj_sop_eph.png")[0] == 6
    assert cod("j2k_opj_eph_97.jpg")[0] == 4
    assert cod("j2k_sop_from_plt.png")[0] & 2
    data = _path("j2k_opj_sop_eph.png").read_bytes()
    assert data.count(b"\xff\x91\x00\x04") > 10 and b"\xff\x92" in data
    for name, parts in (("j2k_tile_parts.png", 3),
                        ("j2k_tile_parts_psot_0.png", 3)):
        main, tparts, _ = cases.parse(_path(name).read_bytes())
        assert max(p[1] for p in tparts) == parts - 1, name
    assert all(p[2] == 0 for p in cases.parse(
        _path("j2k_tile_parts_tnsot_0.png").read_bytes())[1])
    assert len(cases.parse(_path("j2k_pil_tiles_16.png").read_bytes()[
        cases.codestream_at(_path("j2k_pil_tiles_16.png").read_bytes()):])[
        1]) == 4
    for name, off in (("j2k_offset_tiles.png", (5, 7)),
                      ("j2k_offset.jpg", (3, 1))):
        x0, y0, _ = port_components(_path(name).read_bytes())
        assert (x0, y0) == off
    data = _path("j2k_precision_12.png").read_bytes()
    assert data[cases.siz_component(data, 0)] == 11


# ----------------------------------------------------------- OpenJPEG

@pytest.mark.parametrize("name", CASES + PIL_SKIPS + (BIG,))
def test_components_equal_openjpeg(name):
    """The port's components equal what OpenJPEG's opj_decode gives
    (Pillow's bundled libopenjp2 through ctypes), offset and all, before
    either reader converts them: 16-bit, 12-bit, signed and 1-7-bit
    samples exactly."""
    data = _path(name).read_bytes()
    want = cases.opj_components(data)
    got = port_components(data)
    assert want is not None and got is not None
    assert got[:2] == want[:2]
    assert len(got[2]) == len(want[2])
    for a, b in zip(got[2], want[2]):
        np.testing.assert_array_equal(a, b, err_msg=name)


def test_damaged_files_fail_in_openjpeg_and_the_port():
    """The skip files both readers refuse fail in opj_decode too, and in
    the port's decoder."""
    for name in SKIPS:
        if name in PIL_SKIPS:
            continue
        data = _path(name).read_bytes()
        assert cases.opj_components(data) is None, name
        assert port_components(data) is None, name


@pytest.mark.parametrize("name", CASES + SKIPS + (BIG,))
def test_header_probe_gives_decodes_size(name):
    """The header probe (the first 64 KiB: ihdr and the SIZ marker) gives,
    on every fixture and for each reader path, the size decode returns: the
    cv2 probe cv2's where cv2 reads the file, (0, 0) where it does not;
    the header probe the size of the reader that reads it."""
    p = str(_path(name))
    try:
        shape = list(native.decode(p).shape[:2])
    except RuntimeError:
        shape = None
    cv2_reads = name in CASES or name == BIG
    assert native.probe([p], reader="cv2").tolist() == (
        [shape] if cv2_reads else [[0, 0]])
    if shape is not None:
        assert native.probe([p]).tolist() == [shape]



def test_header_probe_past_the_first_64_kib(tmp_path):
    """A JP2 file whose boxes before the codestream, or a raw codestream
    whose main header (a long COM marker), run past the first 64 KiB: the
    header probe reads on and gives decode's size."""
    jp2 = _path("j2k_pil_lossless.png").read_bytes()
    at = jp2.find(b"jp2h") - 4
    big_box = cases.box(b"xml ", b"<a/>" * 20000)
    raw = _path("j2k_pil_raw.jpg").read_bytes()
    for name, data in (("box.png", jp2[:at] + big_box + jp2[at:]),
                       ("com.png", cases.insert_main(
                           raw, 0xFF64, b"\0\1" + b"c" * 65000))):
        p = tmp_path / name
        p.write_bytes(data)
        assert len(data) > 65536
        assert _reads_as_reference(p) == "cv2"
        assert native.probe([str(p)]).tolist() == [
            list(native.decode(str(p)).shape[:2])]

# -------------------------------------------------- the readers' rules

def test_sixteen_and_twelve_bits_as_each_reader_converts(tmp_path):
    """cv2 shifts every sample by (the largest precision - 8) and casts to
    8 bits; PIL's I;16 mode clamps to 255 on its way to RGB, and its RGB
    unpacker rounds (+ 2^(prec - 9)) before the shift and wraps: the two
    differ by up to 255 on one file, and the port gives each its own."""
    data = _path("j2k_cv2_gray_u16.png").read_bytes()
    comp = cases.opj_components(data)[2][0]
    got = native.decode(str(_path("j2k_cv2_gray_u16.png")))
    np.testing.assert_array_equal(got[:, :, 0], (comp >> 8).astype(np.uint8))
    raw = _path("j2k_raw_i16.png")
    comp = cases.opj_components(raw.read_bytes())[2][0]
    got = native.decode(str(raw))
    np.testing.assert_array_equal(got[:, :, 0], np.minimum(comp, 255))
    assert np.abs(got[:, :, 0].astype(int) - (comp >> 8)).max() >= 200
    # a signed 12-bit RGB file: cv2 refuses signed samples, PIL rounds
    lossless = _path("j2k_pil_lossless.png").read_bytes()
    signed = lossless
    for c in range(3):
        signed = cases.set_byte(signed, cases.siz_component(signed, c),
                                0x80 | 11)
    p = tmp_path / "signed12.png"
    p.write_bytes(signed)
    assert _reads_as_reference(p) == "pil"
    comps = cases.opj_components(signed)[2]
    want = np.stack([((c.astype(np.int64) + 2048 + 8) >> 4) & 255
                     for c in comps], -1)
    np.testing.assert_array_equal(native.decode(str(p)), want)


def test_image_offset_and_colour_spaces(tmp_path):
    """cv2 refuses an image offset ("tiles are not supported") and a raw
    codestream of fewer than 3 components (it takes the unspecified colour
    space for sRGB); PIL reads them, as it reads a JP2 of any enumerated
    colour space but CMYK, sYCC and eYCC by its component count. No
    orientation applies: JP2 has no EXIF box."""
    for name in ("j2k_offset_tiles.png", "j2k_offset.jpg", "j2k_raw_gray.png",
                 "j2k_raw_la.png", "j2k_no_colr_gray.png"):
        assert _reads_as_reference(_path(name)) == "pil", name
    rgb = _path("j2k_pil_lossless.png").read_bytes()
    gray = _path("j2k_pil_gray.png").read_bytes()
    seen = {}
    for enumcs in (0, 16, 17, 20, 255):
        for label, data in (("rgb", rgb), ("gray", gray)):
            p = tmp_path / f"{label}_{enumcs}.png"
            p.write_bytes(cases.set_colr(data, enumcs))
            seen[label, enumcs] = _reads_as_reference(p)
    assert seen["rgb", 17] == "cv2" and seen["rgb", 255] == "cv2"
    assert seen["gray", 255] == seen["gray", 0] == "pil"


UNSUPPORTED = cases.unsupported_cases(np.random.default_rng(
    cases.JPEG2000_SEED + 2))


@pytest.mark.parametrize("name", sorted(UNSUPPORTED))
def test_unsupported_feature_raises_naming_jpeg2000(tmp_path, name):
    """A valid file of the feature the port leaves out (sub-sampled
    components in a raw codestream and in an sYCC JP2 file) raises naming
    JPEG 2000 on every reader path; the cv2 probe refuses it; the
    reference reads it."""
    data, feature = UNSUPPORTED[name]
    p = tmp_path / name
    p.write_bytes(data)
    assert _reference(p)[0] in ("cv2", "pil"), feature
    assert unsupported_feature(data), feature
    for call in (lambda: native.decode(str(p)),
                 lambda: native.load_batch([str(p)], SIZE),
                 lambda: native.probe([str(p)])):
        with pytest.raises(RuntimeError, match=NAMED):
            call()
    assert native.probe([str(p)], reader="cv2").tolist() == [[0, 0]]


def test_trailing_boxes_after_the_codestream(tmp_path):
    """cv2 reads past whatever follows the codestream; PIL's
    opj_end_decompress reads the boxes there: a second jp2h without an
    ihdr, a box shorter than its header, the signature box again or a cdef
    of no channel fail it, ignored header boxes and unknown or cut boxes do
    not."""
    def box(kind, body, length=None):
        return (length or 8 + len(body)).to_bytes(4, "big") + kind + body

    tails = [b"abc", b"\0" * 8, box(b"xxxx", b"1234"),
             box(b"xxxx", b"12", 100), box(b"xxxx", b"", 4),
             box(b"jp2h", b""), box(b"jp2h", box(b"ihdr", bytes(14))),
             box(b"jP  ", b"\r\n\x87\n"), box(b"ihdr", bytes(14)),
             box(b"colr", b"\x01\0\0\0\0\0\x11"), box(b"cdef", b"\0\0"),
             box(b"jp2c", b""), b"\xff" * 30]
    seen = set()
    for k, tail in enumerate(tails):
        for src in ("j2k_cv2_default.jpg", "j2k_offset.jpg"):
            p = tmp_path / f"t{k}_{src}"
            p.write_bytes(_path(src).read_bytes() + tail)
            seen.add((src, _reads_as_reference(p)))
    assert seen == {("j2k_cv2_default.jpg", "cv2"), ("j2k_offset.jpg", "pil"),
                    ("j2k_offset.jpg", "none")}


# ------------------------------------------------ cuts and mutations

CUT_FIXTURES = ("j2k_pil_tiles_97.jpg", "j2k_tile_parts_tnsot_0.png",
                "j2k_opj_sop_eph.png")
CUT_BLOCK = 250


def _cut_cases():
    out = []
    for name in CUT_FIXTURES:
        n = _path(name).stat().st_size
        out += [(name, lo) for lo in range(0, n, CUT_BLOCK)]
    return out


@pytest.mark.parametrize("name,lo", _cut_cases())
def test_cut_points_read_as_reference(tmp_path, name, lo):
    """Every cut point of three fixtures (9/7 tiles in a JP2, tile-parts
    with TNsot 0, SOP and EPH markers), CUT_BLOCK a case: the port reads or
    refuses exactly where the reference does (a cut right after a
    tile-part's SOT leaves PIL a black image and cv2 nothing)."""
    data = _path(name).read_bytes()
    p = tmp_path / "cut.png"
    for cut in range(lo, min(lo + CUT_BLOCK, len(data))):
        p.write_bytes(data[:cut])
        _reads_as_reference(p)


MUTATION_SOURCES = [n for n in CASES if _path(n).stat().st_size < 1500]


@pytest.mark.parametrize("seed", range(8))
def test_byte_mutations_read_as_reference(tmp_path, seed):
    """60 seeded mutations a seed (a bit flip, a byte set to 0, 0xFF or a
    random value, one to four of them) over the smaller fixtures cv2 reads
    (480 in all; headers, packet headers and code-block data among them):
    the port reads or refuses exactly where the reference does, with its
    pixels, or names JPEG 2000 for a file the mutation gave a feature the
    port leaves out."""
    rng = np.random.default_rng(6000 + seed)
    p = tmp_path / "mut.png"
    for _ in range(60):
        src = _path(MUTATION_SOURCES[int(rng.integers(len(MUTATION_SOURCES)))])
        data = bytearray(src.read_bytes())
        for _ in range(int(rng.integers(1, 5))):
            i = int(rng.integers(len(data)))
            data[i] = int(rng.choice([data[i] ^ (1 << int(rng.integers(8))),
                                      0, 0xFF, int(rng.integers(256))]))
        p.write_bytes(bytes(data))
        _reads_as_reference(p)


def test_header_byte_mutations_read_as_reference(tmp_path):
    """Every byte of a small JP2 file's boxes and main header set to 0,
    0xFF, its bit 7 or bit 0 flipped: the port reads or refuses exactly
    where the reference does (the JP2 box rules, IHDR against SIZ, the
    marker segments' checks, EPH without markers, code-block styles), or
    names JPEG 2000 for a feature the port leaves out."""
    data = _path("j2k_pil_rates_2_layers.jpg").read_bytes()
    end = data.find(b"\xff\x90") + 14
    p = tmp_path / "head.png"
    seen = set()
    for i in range(end):
        for v in {0, 0xFF, data[i] ^ 0x80, data[i] ^ 1} - {data[i]}:
            p.write_bytes(bytes(data[:i]) + bytes([v]) + data[i + 1:])
            seen.add(_reads_as_reference(p))
    assert {"cv2", "pil", "none"} <= seen


# ----------------------------------------------------------- the paths

def _tree(root, files):
    for k, p in enumerate(files):
        out = root / f"c{k % 3}" / p.name
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_bytes(p.read_bytes())
    return root


READABLE = [FIXTURES / n for n in CASES + (BIG,)] + [
    FIXTURES / "skip" / n for n in PIL_SKIPS]


@pytest.mark.parametrize("kind", ["noise", "blur"])
def test_generate_tree_writes_what_the_reference_writes(tmp_path, kind):
    """generate_tree through both packages on the tree of every fixture:
    the same count (the files cv2 reads) and file names, the rest logged as
    skipped; blur's files (a fixed kernel) within 2 LSB of the
    reference's."""
    src = _tree(tmp_path / "src", [FIXTURES / n for n in CASES + (BIG,)]
                + [FIXTURES / "skip" / n for n in SKIPS])
    lines = []
    n = offline.generate_tree(str(src), str(tmp_path / "ours"), kind,
                              log=lines.append, device="cpu")
    m = joffline.generate_tree(str(src), str(tmp_path / "ref"), kind,
                               log=quiet)
    want = int(EXPECTED["generate_tree_written"])
    assert n == m == want
    assert f"Skipped {len(SKIPS)} unreadable files" in lines
    ours = sorted(str(p.relative_to(tmp_path / "ours"))
                  for p in (tmp_path / "ours").glob("*/*"))
    ref = sorted(str(p.relative_to(tmp_path / "ref"))
                 for p in (tmp_path / "ref").glob("*/*"))
    assert ours == ref and len(ours) == want
    if kind == "blur":
        for k in ref:
            a = cv2.imread(str(tmp_path / "ours" / k)).astype(int)
            b = cv2.imread(str(tmp_path / "ref" / k)).astype(int)
            assert np.abs(a - b).max() <= 2, k


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
        root = _tree(tmp_path / "tree", READABLE)
        ours, ref = gtsrb.ImageFolder(str(root), SIZE), jgtsrb.ImageFolder(
            str(root), SIZE)
        assert len(ours) == len(ref) == len(READABLE)
        for i in range(len(ref)):
            (a, la), (b, lb) = ours.load(i), ref.load(i)
            assert la == lb and np.abs(a.astype(int) - b).max() <= 1
    finally:
        gtsrb.set_resize_backend(old[0])
        jgtsrb.set_resize_backend(old[1])


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


def _walk(root):
    """A clean tree of twelve JPEG 2000 files (JP2 and raw codestreams, 5/3
    and 9/7, sides straddling SIZE) and its distorted twin (the same images
    with grain, written by Pillow as JPEG 2000 under the same names)."""
    rng = np.random.default_rng(9)
    clean, dist = root / "clean", root / "distorted"
    for k in range(12):
        h, w = (int(v) for v in rng.integers(14, 46, 2))
        img = cases.smooth(rng, h, w, amp=6)
        noisy = np.clip(img.astype(int) + rng.integers(-25, 26, img.shape),
                        0, 255).astype(np.uint8)
        kw = [{}, {"irreversible": True}, {"no_jp2": True},
              {"irreversible": True, "quality_mode": "rates",
               "quality_layers": [6]}][k % 4]
        name = f"c{k % 3}/img{k:02d}.{('png', 'jpg')[k % 2]}"
        for tree, src in ((clean, img), (dist, noisy)):
            (tree / name).parent.mkdir(parents=True, exist_ok=True)
            (tree / name).write_bytes(cases.pil_j2k(src, **kw))
    return clean, dist


@pytest.mark.parametrize("resize", ["device", "host"])
def test_restore_tree_and_evaluate_directory_on_jpeg2000_trees(
        models, tmp_path, resize):
    """restore_tree on a JPEG 2000 distorted tree with its clean twins, and
    evaluate_directory on the clean tree, against tsr_tpu on shared
    weights: restored .png pixels within 2 LSB, PSNR within 0.05 dB, SSIM
    within 1e-3 where the resize runs on the device (host resizes compare
    the port's resize with cv2.resize, within 1 LSB, so within the 2 LSB
    alone); n and top-1 equal, confidence within 1e-4."""
    (jr, jrv, jj, jjv), (tr, tj) = models
    clean, dist = _walk(tmp_path)
    kw = dict(batch_size=5, size=SIZE, resize=resize, log=quiet)
    got = tinfer.restore_tree(tr, str(dist), str(tmp_path / "ours"),
                              clean_dir=str(clean), device="cpu", **kw)
    want = jinfer.restore_tree(jr.apply, jrv, str(dist), str(tmp_path / "ref"),
                               clean_dir=str(clean), has_batch_stats=True,
                               **kw)
    ours = {str(p.relative_to(tmp_path / "ours")): cv2.imread(str(p))
            for p in sorted((tmp_path / "ours").glob("*/*"))}
    ref = {str(p.relative_to(tmp_path / "ref")): cv2.imread(str(p))
           for p in sorted((tmp_path / "ref").glob("*/*"))}
    assert got["images"] == want["images"] == 12 and sorted(ours) == sorted(
        ref)
    d = np.concatenate([np.abs(ours[k].astype(int) - ref[k]).reshape(-1)
                        for k in ref])
    assert d.max() <= 2
    if resize == "device":
        assert (d > 0).mean() < 0.01
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


def test_load_batch_matches_decode_then_resize():
    """load_batch of the readable fixtures on four threads equals each
    image loaded alone (the batch path reads JPEG 2000 as decode does)."""
    paths = [str(p) for p in READABLE]
    batch = native.load_batch(paths, SIZE, threads=4)
    for p, got in zip(paths, batch):
        np.testing.assert_array_equal(got, native.load_batch([p], SIZE)[0])
