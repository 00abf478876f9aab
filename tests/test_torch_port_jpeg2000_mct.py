"""JPEG 2000 part 5, Part 2's multi-component markers (CBD, MCT, MCC, MCO),
read by the port as the reference reads them (cv2.imread, else PIL's
convert("RGB"), else refused as both refuse), max diff 0, through
native.decode, load_batch and load_canvas:

- CBD: each component's depth and sign, which cv2's rules (a precision
  of 8 or more, no sign), Pillow's unpackers, the clamp and the 9/7's
  steps take, while the DC level shift stays SIZ's;
- MCT arrays of each element type (int16 read unsigned, int32, float32
  and float64 truncated as x86-64 truncates), MCC collections and MCO
  stages: one stage's offset array becomes the tile's DC level shifts,
  an MCO of no stage or of a collection OpenJPEG discards zeroes them,
  more than one stage changes nothing; the decorrelation matrix is
  checked and never applied (an identity matrix reads as diag(2, 1, 1));
- OpenJPEG's record keeping: a later array replaces one of its index,
  only the first collection is ever found, a segment that only warns
  leaves what it wrote, a main header's records reach every tile and a
  tile-part header's only its tile; its refusals;
- the committed fixtures of tests/data/jpeg2000_mct and their components
  against opj_decode, seeded random segments, cut points and mutations,
  and generate_tree, _decode_resize and ImageFolder through both packages.
"""

import functools
import importlib.util
import random
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

from tsr_tpu import offline as joffline
from tsr_tpu.data import gtsrb as jgtsrb
from tsr_tpu_torch import native, offline
from tsr_tpu_torch.data import gtsrb
from test_torch_port_jpeg2000 import (NAMED, SIZE, _reads_as_reference,
                                      cases, chip_smoke, port_components,
                                      quiet)
from test_torch_port_jpeg2000_colour import (_matches_openjpeg,
                                             _reads_everywhere, _write)

torch.set_num_threads(2)
HERE = Path(__file__).resolve().parent
FIXTURES = HERE / "data" / "jpeg2000_mct"
_spec = importlib.util.spec_from_file_location(
    "jpeg2000_mct_fixtures", FIXTURES / "make_fixtures.py")
make_fixtures = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(make_fixtures)
EXPECTED = np.load(FIXTURES / "expected.npz")
CASES, SKIPS = make_fixtures.names()
PIL_SKIPS = tuple(n for n in SKIPS if f"decoded_skip__{n}" in EXPECTED.files)
CBD, MCT, MCC, MCO = cases.CBD, cases.MCT, cases.MCC, cases.MCO


def _path(name):
    return FIXTURES / (name if name in CASES else f"skip/{name}")


def _components(data):
    """The port's components, held equal to opj_decode's."""
    _matches_openjpeg(data)
    return port_components(data)


@functools.lru_cache(maxsize=None)
def _bases():
    """Pillow's RGB files the built cases add segments to: raw 5/3, raw
    9/7, JP2 5/3, and raw 5/3 in 8 x 8 tiles."""
    img = cases.smooth(np.random.default_rng(28), 13, 15, amp=20)
    return {"raw": cases.pil_j2k(img, no_jp2=True),
            "raw97": cases.pil_j2k(img, no_jp2=True, irreversible=True),
            "jp2": cases.pil_j2k(img),
            "tiled": cases.pil_j2k(img, no_jp2=True, tile_size=(8, 8))}


def _shifted(base, shifts, wrap):
    """``base``'s components (5/3, DC level shift 128) with the DC level
    shifts ``shifts`` in its place, clamped to 8 bits; the sum in int32
    wrapping (the 5/3's) or exact."""
    out = []
    for comp, s in zip(base, shifts):
        v = comp.astype(np.int64) - 128 + s
        if wrap:
            v = (v + 2**31) % 2**32 - 2**31
        out.append(np.clip(v, 0, 255))
    return out


# ------------------------------------------------------ the DC level shift

I32_MIN = -2**31
OFFSETS = {  # element: (values written, the shifts OpenJPEG takes)
    "int16": ([5, -6, 300], [5, 65530, 300]),
    "int32": ([2**31 - 1, -6, 127], [2**31 - 1, -6, 127]),
    "float32": ([10.5, -20.25, 3e10], [10, -20, I32_MIN]),
    "float64": ([float("nan"), -0.75, 129.99], [I32_MIN, 0, 129])}


@pytest.mark.parametrize("element", sorted(OFFSETS))
def test_offset_array_becomes_the_dc_level_shift(tmp_path, element):
    """An MCO stage over an offset array of each element type: each
    component's samples shifted by its element as
    j2k_mct_read_functions_to_int32 reads it (int16 unsigned, a float
    truncated, NaN and floats past int32 0x80000000), the 5/3's sum
    wrapping in int32, in the port as in opj_decode, and the files read
    as the reference reads them."""
    values, shifts = OFFSETS[element]
    raw = _bases()["raw"]
    data = cases.with_segments(raw, [
        (MCT, cases.mct_body(1, values, element)),
        (MCC, cases.mcc_body(2, 3, offset=1)), (MCO, cases.mco_body(2))])
    got = _components(data)[2]
    for a, b in zip(got, _shifted(_components(raw)[2], shifts, True)):
        np.testing.assert_array_equal(a, b)
    assert _reads_everywhere(_write(tmp_path, element, data)) == "cv2"
    lossy = cases.with_segments(_bases()["raw97"], [
        (MCT, cases.mct_body(1, values, element)),
        (MCC, cases.mcc_body(2, 3, offset=1)), (MCO, cases.mco_body(2))])
    assert _reads_everywhere(_write(tmp_path, "97", lossy)) == "cv2"
    _matches_openjpeg(lossy)


def test_mco_stages_and_the_first_collection(tmp_path):
    """An MCO of no stage zeroes every DC level shift (128 off); of two
    stages it changes nothing; of a stage no collection has, or of the
    second collection (opj_j2k_add_mct's search never steps past the
    first), it zeroes them; of the first collection it applies its
    offsets."""
    raw = _bases()["raw"]
    plain = _components(raw)[2]
    arrays = [(MCT, cases.mct_body(1, [5, 6, 7]))]
    first = [(MCC, cases.mcc_body(2, 3, offset=1)),
             (MCC, cases.mcc_body(3, 3))]
    shifts = {
        "none": ([(MCO, cases.mco_body())], [0, 0, 0]),
        "two": ([(MCO, cases.mco_body(2, 3))], [128] * 3),
        "unknown": (arrays + first + [(MCO, cases.mco_body(9))], [0, 0, 0]),
        "second": (arrays + first[::-1] + [(MCO, cases.mco_body(2))],
                   [0, 0, 0]),
        "first": (arrays + first + [(MCO, cases.mco_body(2))], [5, 6, 7])}
    for name, (segs, want) in shifts.items():
        data = cases.with_segments(raw, segs)
        for a, b in zip(_components(data)[2], _shifted(plain, want, True)):
            np.testing.assert_array_equal(a, b, err_msg=name)
        assert _reads_everywhere(_write(tmp_path, name, data)) == "cv2"


def _without_segments(data):
    """``data`` with its main header's CBD, MCT, MCC and MCO segments
    taken out."""
    for at, m, body in reversed(cases.main_markers(data)):
        if m in (CBD, MCT, MCC, MCO):
            data = data[:at] + data[at + 4 + len(body):]
    return data


def test_identity_matrix_reads_as_diag_matrix(tmp_path):
    """The decorrelation matrix is checked (its size) and never applied:
    the identity and diag(2, 1, 1) fixtures read alike in cv2 and the
    port, both as the file without the segments (their offsets are the
    default 128)."""
    a = native.decode(str(_path("j2k5_matrix_identity.png")))
    b = native.decode(str(_path("j2k5_matrix_diag_2_1_1.png")))
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        EXPECTED["decoded__j2k5_matrix_identity.png"],
        EXPECTED["decoded__j2k5_matrix_diag_2_1_1.png"])
    plain = _write(tmp_path, "plain", _without_segments(
        _path("j2k5_matrix_diag_2_1_1.png").read_bytes()))
    np.testing.assert_array_equal(a, cv2.imread(str(plain))[:, :, ::-1])
    np.testing.assert_array_equal(a, native.decode(str(plain)))


def test_dc_level_shift_is_per_tile():
    """An MCO of no stage in tile 0's tile-part header moves tile 0 by 128
    and no other tile; a main header's arrays and collection reach every
    tile, so tile 1's MCO applies them and tile 3 its own array of the same
    index (which replaces the copy it took)."""
    tiled = cases.parse(_path("j2k5_tile_part_mco.png").read_bytes())
    main, parts, tail = tiled
    parts[0][3] = [m for m in parts[0][3] if m[0] != MCO]
    plain = _components(cases.emit(main, parts, tail))[2]
    one = _components(_path("j2k5_tile_part_mco.png").read_bytes())[2]
    both = _components(
        _path("j2k5_tiles_name_main_collection.png").read_bytes())[2]
    for c in range(3):
        want = plain[c].copy()
        want[:12, :12] = np.clip(plain[c][:12, :12] - 128, 0, 255)
        np.testing.assert_array_equal(one[c], want)
        want = plain[c].copy()
        want[:12, 12:] = np.clip(plain[c][:12, 12:] - 128 + 100 + 10 * c,
                                 0, 255)
        want[12:, 12:] = np.clip(plain[c][12:, 12:] - 128 + 60 + 10 * c,
                                 0, 255)
        np.testing.assert_array_equal(both[c], want)


# ------------------------------------------------------------------ CBD

@pytest.mark.parametrize("depth", [6, 8, 9, 12, 16, 31, 32])
def test_cbd_depth_as_each_reader_takes_it(tmp_path, depth):
    """CBD's depth on the 5/3 and the 9/7 (whose steps it scales), raw and
    JP2, unsigned and signed: the DC level shift stays SIZ's 128, the
    clamp takes CBD's depth; cv2 reads 8 bits and more unsigned (shifting
    to 8 bits), PIL the rest, both refuse a depth past 31."""
    seen = set()
    for base in ("raw", "raw97", "jp2"):
        for signed in (False, True):
            data = cases.with_segments(_bases()[base], [
                (CBD, cases.cbd_body([depth] * 3, signed=signed))])
            reader = _reads_everywhere(_write(tmp_path, base, data))
            _matches_openjpeg(data)
            seen.add((signed, reader))
    want = ("none" if depth > 31 else "pil" if depth < 8 else "cv2", "none"
            if depth > 31 else "pil")
    assert seen == {(False, want[0]), (True, want[1])}


def test_cbd_refusals(tmp_path):
    """Both readers refuse a CBD of a count other than the image's, of a
    size other than the count + 2, and a CBD in a tile-part header (it is
    legal in the main header only); the port refuses them without naming
    JPEG 2000."""
    raw = _bases()["raw"]
    for name, data in (
            ("count", cases.with_segments(raw, [
                (CBD, cases.cbd_body([8] * 3, count=4))])),
            ("short", cases.with_segments(raw, [
                (CBD, cases.cbd_body([8] * 2, count=3))])),
            ("tile", cases.in_tile_part(raw, 0, [
                (CBD, cases.cbd_body([8] * 3))]))):
        assert _reads_everywhere(_write(tmp_path, name, data)) == "none"
        with pytest.raises(RuntimeError, match="failed to decode"):
            native.decode(str(_write(tmp_path, name, data)))


# -------------------------------------------------- OpenJPEG's records

def _records():
    """{name: (bytes, reader)}: files that reach OpenJPEG's record keeping
    of MCT arrays and MCC collections."""
    raw, tiled = _bases()["raw"], _bases()["tiled"]
    off = lambda i, v, e="int16": (MCT, cases.mct_body(i, v, e))  # noqa
    col = lambda i, **kw: (MCC, cases.mcc_body(i, 3, **kw))  # noqa
    mco = lambda *s: (MCO, cases.mco_body(*s))  # noqa
    out = {
        # a later array of an index replaces the earlier one
        "array_replaced": ([off(1, [1, 2, 3]), col(2, offset=1),
                            off(1, [100, 110, 120]), mco(2)], "cv2"),
        # Ymct not 0 empties the array of its index: its size is then wrong
        "array_emptied": ([off(1, [1, 2, 3]), col(2, offset=1),
                           (MCT, cases.mct_body(1, [7, 8, 9], ymct=1)),
                           mco(2)], "none"),
        # Zmct not 0 leaves the array as it was
        "zmct_skipped": ([off(1, [1, 2, 3]), col(2, offset=1),
                          (MCT, cases.mct_body(1, [7, 8, 9], zmct=1)),
                          mco(2)], "cv2"),
        # a collection of index 2 read again keeps its slot
        "collection_replaced": ([off(1, [1, 2, 3]), off(3, [9, 9, 9]),
                                 col(2, offset=1), col(2, offset=3),
                                 mco(2)], "cv2"),
        # a first segment that only warns (shuffled indices) leaves its
        # index and count in the slot a collection of no arrays (Qmcc 0)
        # then takes
        "stale_slot": ([off(1, [1, 2, 3]),
                        col(2, offset=1, order=[0, 2, 1]),
                        (MCC, cases.mcc_body(4, 3, collections=0)),
                        mco(4)], "cv2"),
        # 2-byte component indices
        "wide_indices": ([off(1, [40, 50, 60]), col(2, offset=1, wide=True),
                          mco(2)], "cv2"),
        # the decorrelation matrix's element size counts: 9 int16 fit
        "matrix_int16": ([(MCT, cases.mct_body(1, [1] * 9, "int16",
                                               array=1)),
                          col(2, deco=1), mco(2)], "cv2"),
        "matrix_and_float64_offsets": ([(MCT, cases.mct_body(
            1, [1.0] * 9, "float32", array=1)), off(5, [0, 0, 0], "float64"),
            col(2, deco=1, offset=5), mco(2)], "cv2"),
        "extra_byte": ([off(1, [1, 2, 3]), col(2, offset=1, extra=b"\0"),
                        mco(2)], "none"),
        "mco_extra_byte": ([(MCO, b"\x01\x02\x00")], "none"),
        "mco_empty_segment": ([(MCO, b"")], "none"),
        "mct_short": ([(MCT, b"\0\0\0\x01\0\0")], "none"),
        "mcc_short": ([(MCC, b"\0\0\x01\0\0\0")], "none"),
        "mcc_deco_missing": ([off(1, [1, 2, 3]), col(2, deco=7, offset=1)],
                             "none"),
    }
    # eleven collections: the slots grow past OpenJPEG's ten
    many = [off(1, [30, 40, 50])] + [col(i, offset=1) for i in range(2, 13)]
    out["eleven_collections"] = (many + [mco(2)], "cv2")
    built = {k: (cases.with_segments(raw, s), r) for k, (s, r) in out.items()}
    built["tile_records_apart"] = (cases.in_tile_part(
        cases.in_tile_part(cases.with_segments(tiled, [
            off(1, [1, 2, 3]), col(2, offset=1)]), 0, [
            off(1, [90, 91, 92]), mco(2)]), 1, [mco(2)]), "cv2")
    built["tile_collection_missing"] = (cases.in_tile_part(
        tiled, 2, [col(2, offset=1)]), "none")
    return built


RECORDS = _records()


@pytest.mark.parametrize("name", sorted(RECORDS))
def test_record_keeping_reads_as_reference(tmp_path, name):
    """Each file that reaches OpenJPEG's keeping of MCT arrays and MCC
    collections (replaced arrays and collections, warned segments and the
    slots they leave, 2-byte indices, the element sizes of a matrix, the
    slots grown past ten, records per tile) reads as the reference reads
    it, with opj_decode's components."""
    data, reader = RECORDS[name]
    assert _reads_everywhere(_write(tmp_path, name, data)) == reader
    _matches_openjpeg(data)


def _random_segments(r, nc):
    """1-6 random CBD, MCT, MCC and MCO segments for an image of ``nc``
    components, most of them well formed."""
    idx = lambda: r.choice([0, 1, 2, 3, 1, 2, 255])  # noqa: E731
    out = []
    for _ in range(r.randint(1, 6)):
        k = r.random()
        if k < 0.12:
            depth = r.choice([8, 8, 12, 16, 6, 31, 32, 9])
            out.append((CBD, cases.cbd_body([depth] * nc,
                                            signed=r.random() < 0.1)))
        elif k < 0.45:
            element = r.choice(sorted(cases.ELEMENTS))
            n = r.choice([nc, nc, nc * nc, nc + 1])
            pick = ([0, 5, -3, 128, 255, 1000, 30000, -30000]
                    if element.startswith("int") else
                    [0.0, 1.5, -20.25, 3e10, float("nan"), 127.9, -0.5])
            out.append((MCT, cases.mct_body(
                idx(), [r.choice(pick) for _ in range(n)], element,
                array=r.choice([1, 2]), zmct=int(r.random() < 0.1),
                ymct=int(r.random() < 0.1))))
        elif k < 0.75:
            kw = r.choice([{}] * 8 + [{"zmcc": 1}, {"ymcc": 1},
                                      {"collections": 2}, {"collections": 0},
                                      {"xmcc": 0}, {"wcount": nc - 1},
                                      {"wide": True}, {"extra": b"\0"}])
            out.append((MCC, cases.mcc_body(
                idx(), nc if r.random() < 0.8 else r.choice([1, 2, nc + 1]),
                deco=r.choice([0, 0, 1, 2, 3]), offset=r.choice([0, 1, 2, 3]),
                **kw)))
        else:
            out.append((MCO, cases.mco_body(
                *[idx() for _ in range(r.choice([0, 1, 1, 1, 2]))])))
    return out


@pytest.mark.parametrize("seed", range(4))
def test_random_segments_read_as_reference(tmp_path, seed):
    """60 files a seed of random CBD, MCT, MCC and MCO segments in the main
    header, and some in tile-part headers, over gray, RGB and RGBA, raw and
    JP2, 5/3 and 9/7: each reads as the reference reads it, with
    opj_decode's components; all three readers' outcomes come up."""
    r = random.Random(seed)
    rng = np.random.default_rng(seed)
    img = cases.smooth(rng, 11, 13, amp=20)
    bases = [(cases.pil_j2k(img, no_jp2=True), 3),
             (cases.pil_j2k(img, no_jp2=True, irreversible=True), 3),
             (cases.pil_j2k(img), 3),
             (cases.pil_j2k(img[:, :, 0], no_jp2=True), 1),
             (cases.pil_j2k(np.dstack([img, img[:, :, :1]]), "RGBA"), 4),
             (cases.pil_j2k(img, no_jp2=True, tile_size=(8, 8)), 3)]
    seen = set()
    for k in range(60):
        base, nc = r.choice(bases)
        segs = _random_segments(r, nc)
        if base is bases[-1][0] and r.random() < 0.6:
            data = cases.with_segments(base, [s for s in segs if s[0] == CBD])
            for t in range(4):
                data = cases.in_tile_part(data, t, [
                    s for s in segs if s[0] != CBD and r.random() < 0.6])
        else:
            data = cases.with_segments(base, segs)
        seen.add(_reads_as_reference(_write(tmp_path, f"r{k}", data)))
        _matches_openjpeg(data)
    assert seen == {"cv2", "pil", "none"}


# --------------------------------------------------------- the fixtures

@pytest.mark.parametrize("name", CASES)
def test_fixture_decodes_as_cv2(name):
    """Every j2k5_ fixture cv2 reads: decode equals expected.npz (cv2's
    pixels), max diff 0; both probes give its (h, w); load_batch and
    load_canvas read it; its components equal opj_decode's."""
    p = str(FIXTURES / name)
    want = EXPECTED[f"decoded__{name}"]
    np.testing.assert_array_equal(native.decode(p), want)
    for reader in ("cv2", "port"):
        assert native.probe([p], reader=reader).tolist() == [
            list(want.shape[:2])]
    assert native.load_batch([p], SIZE).shape == (1, SIZE, SIZE, 3)
    canvas = np.zeros((1, 128, 128, 3), np.uint8)
    assert native.load_canvas([p], canvas).tolist() == [list(want.shape[:2])]
    np.testing.assert_array_equal(canvas[0, :want.shape[0], :want.shape[1]],
                                  want)
    _matches_openjpeg(Path(p).read_bytes())


@pytest.mark.parametrize("name", SKIPS)
def test_skip_fixture_reads_as_reference(name):
    """Each skip/ file: the cv2 probe gives (0, 0); decode gives PIL's
    pixels where PIL reads it (a CBD of depth 6, a signed CBD, a raw gray
    codestream with an offset array), and otherwise raises "failed to
    decode", not naming JPEG 2000 (a CBD of the wrong count, an MCC naming
    an array no MCT holds, a matrix and an offset array of the wrong
    size); its components equal opj_decode's."""
    p = str(FIXTURES / "skip" / name)
    assert native.probe([p], reader="cv2").tolist() == [[0, 0]]
    _matches_openjpeg(Path(p).read_bytes())
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
    """The committed files equal what make_fixtures writes here, each reads
    as the reference reads it now (cv2 and PIL live), 3 of the skip files
    PIL reads (chip_smoke.JPEG2000_MCT_PIL_READS), and the directory stays
    under 64 KiB."""
    fresh = make_fixtures.make(tmp_path)
    assert sorted(fresh) == sorted(EXPECTED.files)
    for key in EXPECTED.files:
        np.testing.assert_array_equal(fresh[key], EXPECTED[key], err_msg=key)
    for name in CASES:
        assert (FIXTURES / name).read_bytes() == (tmp_path / name).read_bytes()
        assert _reads_as_reference(FIXTURES / name) == "cv2"
    readers = []
    for name in SKIPS:
        p = FIXTURES / "skip" / name
        assert p.read_bytes() == (tmp_path / "skip" / name).read_bytes()
        readers.append(_reads_as_reference(p))
    assert readers.count("pil") == len(PIL_SKIPS) == (
        chip_smoke.JPEG2000_MCT_PIL_READS)
    assert readers.count("none") == len(SKIPS) - len(PIL_SKIPS)
    assert int(EXPECTED["generate_tree_written"]) == len(CASES)
    assert sum(p.stat().st_size for p in FIXTURES.rglob("*")
               if p.is_file()) < 64 * 1024


def test_fixtures_hold_what_they_name():
    """Each fixture holds a CBD, MCT, MCC or MCO segment in its main or a
    tile-part header (never one the port names JPEG 2000 for); the
    opj_set_MCT files hold all four, COD's MCT byte 1 and 0."""
    for name in CASES + tuple(f"skip/{n}" for n in SKIPS):
        data = (FIXTURES / name).read_bytes()
        main, parts, _ = cases.parse(data[cases.codestream_at(data):])
        markers = {m for _, m, _ in cases.main_markers(data)} | {
            m for part in parts for m, _ in part[3]}
        assert markers & {CBD, MCT, MCC, MCO}, name
    for byte in (1, 0):
        data = _path(f"j2k5_opj_set_mct_{byte}.jpg").read_bytes()
        assert {CBD, MCT, MCC, MCO} <= {
            m for _, m, _ in cases.main_markers(data)}
        assert cases.cod_fields(data)[3] == byte


def test_cut_points_and_mutations_read_as_reference(tmp_path):
    """Every cut point through the headers of two fixtures (a tile-part
    MCO, a main header's collection named from tile-part headers) and 30
    seeded byte mutations inside the new segments of three: the port reads
    or refuses exactly where the reference does, never naming JPEG
    2000."""
    p = tmp_path / "cut.png"
    for name in ("j2k5_tile_part_mco.png",
                 "j2k5_tiles_name_main_collection.png"):
        data = _path(name).read_bytes()
        for cut in range(0, data.find(b"\xff\x93") + 8):
            p.write_bytes(data[:cut])
            assert _reads_as_reference(p) != "named"
    rng = np.random.default_rng(28)
    sources = [_path(n).read_bytes() for n in (
        "j2k5_opj_set_mct_1.jpg", "j2k5_tiles_name_main_collection.png",
        "j2k5_offsets_float64_jp2_97.jpg")]
    for _ in range(30):
        d = bytearray(sources[int(rng.integers(len(sources)))])
        spots = [k for k in range(len(d) - 3) if d[k] == 0xFF
                 and d[k + 1] in (0x74, 0x75, 0x77, 0x78)]
        for _ in range(int(rng.integers(1, 4))):
            k = spots[int(rng.integers(len(spots)))]
            j = k + 2 + int(rng.integers(int.from_bytes(d[k + 2:k + 4],
                                                        "big") + 1))
            if j < len(d):
                d[j] = int(rng.choice([d[j] ^ (1 << int(rng.integers(8))), 0,
                                       0xFF, int(rng.integers(256))]))
        p.write_bytes(bytes(d))
        assert _reads_as_reference(p) != "named"


def test_fixture_brings_a_bucket_of_its_own():
    """The 100 x 14 fixture lies in generate_tree buckets (128 x 32 for
    blur, compound and blur_rand) no fixture of the other image
    directories brings, so that phase 13 holds B2 and B3 there."""
    others = []
    for d in ("images", "webp", "webp_lossy", "jpeg2000", "jpeg2000_colour",
              "jpeg2000_ht"):
        root = HERE / "data" / d
        others += [str(p) for p in root.iterdir()
                   if p.suffix in chip_smoke.IMAGE_SUFFIXES]
    sides = [tuple(s) for s in native.probe(others, reader="cv2").tolist()
             if s[0] > 0]
    mine = native.probe([str(_path("j2k5_100x14_offsets_97.jpg"))],
                        reader="cv2").tolist()
    assert mine == [[100, 14]]
    for kind in ("blur", "compound", "blur_rand"):
        halo = offline.HALO[kind]
        bucket = (offline._bucket_with_room(100, halo),
                  offline._bucket_with_room(14, halo))
        assert bucket not in {(offline._bucket_with_room(h, halo),
                               offline._bucket_with_room(w, halo))
                              for h, w in sides}


# ----------------------------------------------------------- the paths

def _tree(root, files):
    for k, (name, data) in enumerate(files):
        out = root / f"c{k % 3}" / name
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_bytes(data)
    return root


def test_generate_tree_writes_what_the_reference_writes(tmp_path):
    """generate_tree (blur) through both packages on a tree of the
    committed fixtures, their skip files and the record files: the same
    files written (those cv2 reads) and skipped, none named JPEG 2000;
    the blurred files within 2 LSB of the reference's."""
    files = [(p.name, p.read_bytes()) for p in FIXTURES.glob("j2k5_*")]
    files += [(p.name, p.read_bytes())
              for p in (FIXTURES / "skip").glob("j2k5_*")]
    files += [(f"{n}.png", d) for n, (d, _) in RECORDS.items()]
    src = _tree(tmp_path / "src", files)
    readable = [p for p in src.glob("*/*") if cv2.imread(str(p)) is not None]
    assert len(readable) == len(CASES) + sum(
        r == "cv2" for _, r in RECORDS.values())
    lines = []
    n = offline.generate_tree(str(src), str(tmp_path / "ours"), "blur",
                              log=lines.append, device="cpu")
    m = joffline.generate_tree(str(src), str(tmp_path / "ref"), "blur",
                               log=quiet)
    assert n == m == len(readable)
    assert f"Skipped {len(files) - n} unreadable files" in lines
    ref = sorted(str(p.relative_to(tmp_path / "ref"))
                 for p in (tmp_path / "ref").glob("*/*"))
    assert sorted(str(p.relative_to(tmp_path / "ours"))
                  for p in (tmp_path / "ours").glob("*/*")) == ref
    for k in ref:
        a = cv2.imread(str(tmp_path / "ours" / k)).astype(int)
        b = cv2.imread(str(tmp_path / "ref" / k)).astype(int)
        assert np.abs(a - b).max() <= 2, k
    for p in src.glob("*/*"):
        try:
            native.decode(str(p))
        except RuntimeError as e:
            assert NAMED not in str(e)


@pytest.mark.parametrize("resize", ["cv2", "pil"])
def test_decode_resize_and_image_folder_match_reference(tmp_path, resize):
    """gtsrb._decode_resize at SIZE within 1 LSB of tsr_tpu's (cv2.imread,
    else PIL, then its resize) on every fixture a reader reads, and the
    port's ImageFolder loads them as tsr_tpu's does."""
    readable = [_path(n) for n in CASES + PIL_SKIPS]
    old = (gtsrb.RESIZE_BACKEND, jgtsrb.RESIZE_BACKEND)
    try:
        gtsrb.set_resize_backend(resize)
        jgtsrb.set_resize_backend(resize)
        for p in readable:
            got = gtsrb._decode_resize(str(p), SIZE).astype(int)
            want = jgtsrb._decode_resize(str(p), SIZE).astype(int)
            assert np.abs(got - want).max() <= 1, p.name
        root = _tree(tmp_path / "tree", [(p.name, p.read_bytes())
                                          for p in readable])
        ours, ref = gtsrb.ImageFolder(str(root), SIZE), jgtsrb.ImageFolder(
            str(root), SIZE)
        assert len(ours) == len(ref) == len(readable)
        for i in range(len(ref)):
            (a, la), (b, lb) = ours.load(i), ref.load(i)
            assert la == lb and np.abs(a.astype(int) - b).max() <= 1
    finally:
        gtsrb.set_resize_backend(old[0])
        jgtsrb.set_resize_backend(old[1])
