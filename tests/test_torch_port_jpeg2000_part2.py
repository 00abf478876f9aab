"""JPEG 2000 part 2 (code-block styles, POC, PPM and PPT, RGN) read by the
port as the reference reads it (cv2.imread, else PIL's convert("RGB"),
else refused as both refuse), max diff 0, through native.decode,
load_batch and load_canvas:

- every code-block style bit alone (BYPASS, RESET, TERMALL, VSC, PTERM,
  SEGSYM) and the combinations 5 and 63, on 5/3 and 9/7 with 1-3 layers
  (OpenJPEG's encoder through ctypes), and the segments of BYPASS and
  TERMALL over three layers;
- POC in the main header and in a tile-part header: several entries that
  change the order, entries that leave packets unread (OpenJPEG then
  decodes each component up to the highest resolution a packet reached,
  and each reader lays that image out its own way), CSpoc past the
  components, an order past CPRL, a COD order past CPRL under a POC;
- PPM over tiles, tile-parts and markers, PPT over tiles in Zppt order,
  SOP kept or dropped, and OpenJPEG's refusals (PPT beside PPM, a Z index
  twice, an Nppm past its headers or cut across markers, no headers);
- RGN: OpenJPEG's own ROI streams (opj_cparameters_t's roi_compno and
  roi_shift) in the main and tile-part headers, shifts 1 to 31, ROI under
  BYPASS, a nonzero Srgn;
- PTERM set on a stream coded without it, and SEGSYM symbols that are
  wrong (chip_smoke.j2k_bytes), which neither reader acts on;
- the components against OpenJPEG's opj_decode, both probes against
  decode, cut points and byte mutations of part 2's fixtures against cv2
  and PIL live, generate_tree through both packages on a tree of these
  files, and chip_smoke.py's built 640 x 480 file (9/7, style 63, a POC,
  PPT) against the digest of cv2's pixels.
"""

import functools
import hashlib

import cv2
import numpy as np
import pytest

from tsr_tpu import offline as joffline
from tsr_tpu_torch import native, offline
from test_torch_port_jpeg2000 import (FIXTURES, SIZE, _reads_as_reference,
                                      cases, chip_smoke, port_components,
                                      quiet)

PART2 = sorted(p.name for p in FIXTURES.glob("j2k2_*"))
PART2_SKIPS = sorted(p.name for p in (FIXTURES / "skip").glob("j2k2_*"))
STYLES = (1, 2, 4, 8, 16, 32, 5, 63)
RATES = {1: (), 2: (30, 8), 3: (40, 15, 6)}


def _style_name(mode, irreversible, layers):
    return f"style_{mode}_{'97' if irreversible else '53'}_{layers}_layers"


@functools.lru_cache(maxsize=None)
def _built():
    """{name: bytes} of the files built here once: the style matrix, POC,
    PPM/PPT and RGN variants."""
    rng = np.random.default_rng(2525)
    img = cases.smooth(rng, 23, 26, amp=8)
    gray = img[:, :, 0]
    out = {}
    for mode in STYLES:
        for irr in (0, 1):
            for layers, rates in RATES.items():
                out[_style_name(mode, irr, layers)] = cases.opj_encode(
                    img, mode=mode, irreversible=irr, cblk=(16, 16),
                    rates=rates or ((10,) if irr else ()))
    # POC: an LRCP stream of one precinct a resolution with SOP and EPH,
    # its packets reordered by the entries (those no entry reaches dropped)
    sop = cases.opj_encode(img, csty=6, rates=(30, 10, 4), numres=4)
    sop97 = cases.opj_encode(img, csty=6, rates=(30, 10, 4), numres=4,
                             irreversible=1)
    gray_sop = cases.opj_encode(gray, csty=6, rates=(30, 10, 4), numres=4)
    every = [(0, 0, 3, 1, 3, 1), (1, 0, 1, 4, 3, 4), (0, 0, 3, 4, 3, 0)]
    pocs = {
        "every_packet": every,
        "one_entry_rpcl": [(0, 0, 3, 4, 3, 2)],
        "by_component": [(0, 2, 3, 4, 3, 3), (0, 0, 3, 4, 2, 1)],
        "resolutions_left": [(0, 0, 3, 2, 3, 1)],
        "layers_left": [(0, 0, 1, 4, 3, 0)],
        "component_left": [(0, 0, 3, 4, 2, 0)],
        "cspoc_past": [(0, 3, 3, 4, 3, 0), (0, 0, 3, 4, 3, 0)],
        "order_7": [(0, 0, 3, 2, 3, 7), (0, 0, 3, 4, 3, 1)],
        "repoc_past": [(0, 0, 3, 200, 3, 1)],
    }
    for name, entries in pocs.items():
        for where in ("main", "tile"):
            out[f"poc_{name}_{where}"] = cases.reorder_poc(sop, entries,
                                                           where)
        out[f"poc_{name}_97"] = cases.reorder_poc(sop97, entries, "tile")
        out[f"poc_{name}_gray"] = cases.reorder_poc(
            gray_sop, [(r0, min(c0, 1), l1, r1, min(c1, 1), p)
                       for r0, c0, l1, r1, c1, p in entries])
    # PIL's path over tiles of a reduced image: its tile buffer is zeroed
    # for each tile
    out["poc_resolutions_left_gray_tiles"] = cases.insert_poc(
        cases.opj_encode(gray, rates=(30, 10, 4), numres=4, tile=(24, 16)),
        [(0, 0, 3, 1, 1, 0)])
    # a POC that reads no packet of a stream that holds them all
    out["poc_no_layer_main"] = cases.insert_poc(sop, [(0, 0, 0, 4, 3, 0)])
    out["poc_no_layer_tile"] = cases.to_tile_headers(
        out["poc_no_layer_main"], 0xFF5F)
    # a tile's own POC after the main header's: the two read in turn
    m, parts, tail = cases.parse(cases.reorder_poc(sop, every, "tile"))
    parts[0][3] = [(0xFF5F, cases.poc_body(every[2:]))]
    out["poc_main_then_tile"] = cases.emit(cases.insert_poc(
        m + cases._SOT, every[:2])[:-len(cases._SOT)], parts, tail)
    prg = next(p for p, mk, b in cases.main_markers(sop) if mk == 0xFF52) + 5
    out["poc_cod_order_9"] = cases.set_byte(
        cases.reorder_poc(sop, [(0, 0, 3, 4, 3, 1)]), prg, 9)
    out["cod_order_9"] = cases.set_byte(sop, prg, 9)
    # PPM and PPT
    tiled = cases.opj_encode(img, csty=6, rates=(20, 6), tile=(12, 8))
    tiled97 = cases.opj_encode(img, csty=6, rates=(20, 6), tile=(16, 16),
                               irreversible=1, mode=63)
    out["ppm_one_marker"] = cases.to_ppm(sop)
    out["ppm_markers"] = cases.to_ppm(sop, size=29)
    out["ppm_tiles"] = cases.to_ppm(tiled, size=45)
    out["ppm_tiles_no_sop"] = cases.to_ppm(tiled97, size=70, sop=False)
    out["ppm_tile_parts"] = cases.split_tile_parts(
        cases.to_ppm(tiled, size=80), rng, interleave=False)
    out["ppm_tile_parts_interleaved"] = cases.split_tile_parts(
        cases.to_ppm(tiled, size=80), rng)
    out["ppm_nppm_wrong"] = cases.to_ppm(
        tiled, nppm=lambda runs: [len(r) + (-5, 5)[k % 2]
                                  for k, r in enumerate(runs)])
    out["ppm_nppm_past"] = cases.to_ppm(
        tiled, nppm=lambda runs: [len(r) for r in runs[:-1]] + [999])
    out["ppm_nppm_across_markers"] = cases.to_ppm(sop, size=3,
                                                  split_nppm=True)
    out["ppm_no_headers"] = cases.insert_main(sop, 0xFF60, b"\0\0\0\0\0")
    out["ppm_no_headers_no_eph"] = cases.insert_main(
        cases.opj_encode(img, rates=(20,)), 0xFF60, b"\0\0\0\0\0")
    out["ppt_one_marker"] = cases.to_ppt(sop)
    out["ppt_markers_reversed"] = cases.to_ppt(
        sop, size=17, order=lambda n: range(n - 1, -1, -1))
    out["ppt_tiles"] = cases.to_ppt(tiled, size=33)
    out["ppt_tiles_97_no_sop"] = cases.to_ppt(tiled97, sop=False)
    out["ppt_tile_parts"] = cases.split_tile_parts(cases.to_ppt(tiled), rng)
    out["ppt_gray_poc"] = cases.to_ppt(
        out["poc_every_packet_gray"], size=40)
    ppt = cases.to_ppt(sop, size=40)
    out["ppt_beside_ppm"] = cases.insert_main(ppt, 0xFF60, b"\0\0\0\0\0")
    m, parts, tail = cases.parse(ppt)
    parts[0][3] = parts[0][3][:1] + parts[0][3][2:]  # Zppt 1 missing
    out["ppt_z_missing"] = cases.emit(m, parts, tail)
    parts[0][3] = parts[0][3] + parts[0][3][:1]
    out["ppt_z_twice"] = cases.emit(m, parts, tail)
    # RGN: OpenJPEG's ROI, in the main header or each tile's
    for shift in (1, 4, 9, 17, 26, 31):
        out[f"rgn_shift_{shift}"] = cases.opj_encode(img, roi=(0, shift))
    out["rgn_component_2_97"] = cases.opj_encode(
        img, roi=(2, 5), irreversible=1, rates=(15,))
    out["rgn_bypass_3_layers"] = cases.opj_encode(
        img, roi=(1, 6), mode=1, rates=(30, 10, 4))
    out["rgn_style_63_97"] = cases.opj_encode(
        img, roi=(0, 3), mode=63, irreversible=1, rates=(20, 6))
    out["rgn_tiles"] = cases.to_tile_headers(cases.opj_encode(
        img, roi=(0, 7), tile=(16, 12)), 0xFF5E)
    out["rgn_gray_tiles"] = cases.to_tile_headers(cases.opj_encode(
        gray, roi=(0, 5), tile=(12, 12)), 0xFF5E)
    rgn = out["rgn_shift_4"]
    at = rgn.find(b"\xff\x5e\x00\x05") + 5
    out["rgn_srgn_1"] = cases.set_byte(rgn, at, 1)
    out["rgn_size"] = cases.insert_main(cases.opj_encode(img), 0xFF5E,
                                        b"\0\0\2\0")
    return out


def _write(tmp_path, name):
    p = tmp_path / f"{name}.png"
    p.write_bytes(_built()[name])
    return p


def _reads_everywhere(p):
    """_reads_as_reference, then load_batch and load_canvas where a reader
    reads: the canvas holds decode's pixels. Returns the reader."""
    reader = _reads_as_reference(p)
    if reader in ("cv2", "pil"):
        want = native.decode(str(p))
        assert native.load_batch([str(p)], SIZE).shape == (1, SIZE, SIZE, 3)
        side = max(64, *want.shape[:2])
        canvas = np.zeros((1, side, side, 3), np.uint8)
        assert native.load_canvas([str(p)], canvas).tolist() == [
            list(want.shape[:2])]
        np.testing.assert_array_equal(
            canvas[0, :want.shape[0], :want.shape[1]], want)
    return reader


def _matches_openjpeg(data):
    """The port's components equal opj_decode's (or both fail)."""
    want, got = cases.opj_components(data), port_components(data)
    assert (want is None) == (got is None)
    if want is not None:
        assert got[:2] == want[:2]
        for a, b in zip(got[2], want[2]):
            np.testing.assert_array_equal(a, b)


# ------------------------------------------------------ code-block styles

@pytest.mark.parametrize("mode", STYLES)
@pytest.mark.parametrize("irreversible", [0, 1])
@pytest.mark.parametrize("layers", sorted(RATES))
def test_code_block_styles_read_as_cv2(tmp_path, mode, irreversible, layers):
    """Each code-block style bit alone and the combinations 5 and 63
    (BYPASS, RESET and TERMALL; all six), on 5/3 and 9/7 with 1-3 layers:
    decode, load_batch and load_canvas give cv2's pixels, the components
    opj_decode's."""
    name = _style_name(mode, irreversible, layers)
    data = _built()[name]
    assert cases.cod_fields(data)[7] == mode
    assert cases.cod_fields(data)[2] == layers
    assert _reads_everywhere(_write(tmp_path, name)) == "cv2"
    _matches_openjpeg(data)


@pytest.mark.parametrize("mode", [1, 4])
def test_segments_over_three_layers(tmp_path, mode):
    """BYPASS (segments of 10, 2, 1, 2, 1 ... passes) and TERMALL (a pass
    a segment): one 32 x 32 code-block whose passes come in each of three
    layers, so that segments continue from one layer into the next, read
    as cv2 reads them, as opj_decode gives them."""
    img = cases.smooth(np.random.default_rng(7), 32, 32, amp=30)
    data = cases.opj_encode(img, numres=1, csty=6, mode=mode,
                            rates=(8, 4, 2), cblk=(32, 32))
    for _, _, _, _, tile in cases.parse(data)[1]:
        pk = cases.packets(tile)
        assert len(pk) == 9  # three components in three layers
        assert all(len(body) > 0 for _, _, body in pk)
    p = tmp_path / "segments.png"
    p.write_bytes(data)
    assert _reads_everywhere(p) == "cv2"
    _matches_openjpeg(data)


def test_pterm_and_segsym_change_nothing(tmp_path):
    """PTERM only changes how OpenJPEG's encoder ends a pass: the PTERM bit
    set on a stream coded without it reads as before in both readers and
    the port. SEGSYM's symbols are read and dropped: a stream whose
    cleanup passes end with 0101 in place of 1010 reads as the one with the
    right symbols in both readers and the port."""
    data = _built()[_style_name(4, 1, 3)]
    at = next(p for p, m, b in cases.main_markers(data) if m == 0xFF52) + 12
    assert data[at] == 4
    p, q = tmp_path / "plain.png", tmp_path / "pterm.png"
    p.write_bytes(data)
    q.write_bytes(cases.set_byte(data, at, 4 | 16))
    assert _reads_everywhere(p) == _reads_everywhere(q) == "cv2"
    np.testing.assert_array_equal(native.decode(str(p)),
                                  native.decode(str(q)))
    img = cases.smooth(np.random.default_rng(8), 40, 52, amp=9)
    right, wrong = (chip_smoke.j2k_bytes(img, levels=2, style=4 | 32,
                                         segsym_value=v)
                    for v in (0b1010, 0b0101))
    assert right != wrong
    p.write_bytes(right)
    q.write_bytes(wrong)
    assert _reads_everywhere(p) == _reads_everywhere(q) == "cv2"
    np.testing.assert_array_equal(cv2.imread(str(p)), cv2.imread(str(q)))
    np.testing.assert_array_equal(native.decode(str(p)),
                                  native.decode(str(q)))


# ---------------------------------------------------- POC, PPM, PPT, RGN

MARKER_CASES = sorted(n for n in _built() if not n.startswith("style_"))


@pytest.mark.parametrize("name", MARKER_CASES)
def test_marker_cases_read_as_reference(tmp_path, name):
    """Each POC, PPM, PPT and RGN case reads as the reference reads it
    (its pixels, or refused where both refuse), through decode, load_batch
    and load_canvas, and its components equal opj_decode's."""
    reader = _reads_everywhere(_write(tmp_path, name))
    assert reader != "named", name
    _matches_openjpeg(_built()[name])


def test_marker_cases_hold_their_features():
    """The cases carry the markers their names claim; OpenJPEG refuses
    the damaged ones (a PPT beside a PPM, a Zppt twice or missing, Nppm
    counts that do not fit their headers or an Nppm cut across markers, a
    PPM of no headers, an RGN shift that takes a code-block past 30
    bit-planes, an RGN of the wrong length, a COD order past CPRL without a
    POC) and reads every other PPM and PPT case."""
    built = _built()
    readers = {}
    for name, data in built.items():
        if name.startswith("style_"):
            continue
        markers = {m for _, m, _ in cases.main_markers(data)}
        tile_markers = {m for part in cases.parse(data)[1] for m, _ in part[3]}
        if name.startswith("poc_"):
            assert 0xFF5F in markers | tile_markers, name
        if name.startswith("ppm_"):
            assert 0xFF60 in markers, name
        if name.startswith("ppt_"):
            assert 0xFF61 in tile_markers, name
        if name.startswith("rgn_"):
            assert 0xFF5E in markers | tile_markers, name
        readers[name] = cases.opj_components(data) is not None
    refused = {n for n, ok in readers.items() if not ok}
    assert {n for n in refused if n.startswith(("ppm", "ppt"))} == {
        "ppm_nppm_wrong", "ppm_nppm_past", "ppm_nppm_across_markers",
        "ppm_no_headers", "ppm_no_headers_no_eph", "ppt_beside_ppm",
        "ppt_z_missing", "ppt_z_twice"}
    assert {"rgn_shift_26", "rgn_shift_31", "rgn_size",
            "cod_order_9"} <= refused


def test_poc_orders_and_unread_packets():
    """A POC that changes the order of every packet, in the main header or
    a tile-part header, reads the components of the stream it reorders; a
    tile's POC follows the main header's; entries that leave resolutions
    unread give opj_decode's reduced image: the samples of the highest
    resolution read at the top left, zeros around them."""
    built = _built()
    sop = cases.opj_components(cases.opj_encode(
        cases.smooth(np.random.default_rng(2525), 23, 26, amp=8), csty=6,
        rates=(30, 10, 4), numres=4))
    for name in ("poc_every_packet_main", "poc_every_packet_tile",
                 "poc_one_entry_rpcl_main", "poc_by_component_tile",
                 "poc_main_then_tile", "poc_cspoc_past_main",
                 "poc_order_7_tile", "poc_repoc_past_main",
                 "poc_cod_order_9"):
        got = port_components(built[name])
        for a, b in zip(got[2], sop[2]):
            np.testing.assert_array_equal(a, b, err_msg=name)
    got = port_components(built["poc_resolutions_left_main"])[2][0]
    # resolutions 0-1 of 4 read: a 23 x 26 image reduced by 4
    assert got[6:].max() == 0 and got[:, 7:].max() == 0
    assert got[:6, :7].max() > 0
    # no packet read: resolution 0 alone, 3 x 4, its level shift only
    got = port_components(built["poc_no_layer_main"])[2]
    assert all((c[:3, :4] == 128).all() and c[3:].max() == 0
               and c[:, 4:].max() == 0 for c in got)
    assert port_components(built["cod_order_9"]) is None


# ------------------------------------------------ cuts and mutations

CUT_FIXTURES = ("j2k2_ppm_tile_parts.png", "j2k2_ppt_tiles_97.jpg",
                "j2k2_style_63_97_3_layers.jpg",
                "j2k2_poc_tile_uncovered.png", "j2k2_rgn_tiles_97.jpg")
CUT_BLOCK = 400


def _cut_cases():
    out = []
    for name in CUT_FIXTURES:
        n = (FIXTURES / name).stat().st_size
        out += [(name, lo) for lo in range(0, n, CUT_BLOCK)]
    return out


@pytest.mark.parametrize("name,lo", _cut_cases())
def test_cut_points_read_as_reference(tmp_path, name, lo):
    """Every cut point of five part 2 fixtures (PPM over tile-parts, PPT
    over tiles, style 63 over three layers, a POC that leaves packets
    unread, RGN in tile-part headers), CUT_BLOCK a case: the port reads or
    refuses exactly where the reference does."""
    data = (FIXTURES / name).read_bytes()
    p = tmp_path / "cut.png"
    for cut in range(lo, min(lo + CUT_BLOCK, len(data))):
        p.write_bytes(data[:cut])
        _reads_as_reference(p)


@pytest.mark.parametrize("seed", range(6))
def test_byte_mutations_read_as_reference(tmp_path, seed):
    """60 seeded mutations a seed (a bit flip, a byte set to 0, 0xFF or a
    random value, one to four of them) over part 2's fixtures (360 in
    all): the port reads or refuses exactly where the reference does, with
    its pixels, or names JPEG 2000 for a file the mutation gave a feature
    the port leaves out."""
    rng = np.random.default_rng(7000 + seed)
    p = tmp_path / "mut.png"
    for _ in range(60):
        src = FIXTURES / PART2[int(rng.integers(len(PART2)))]
        data = bytearray(src.read_bytes())
        for _ in range(int(rng.integers(1, 5))):
            i = int(rng.integers(len(data)))
            data[i] = int(rng.choice([data[i] ^ (1 << int(rng.integers(8))),
                                      0, 0xFF, int(rng.integers(256))]))
        p.write_bytes(bytes(data))
        _reads_as_reference(p)


@pytest.mark.parametrize("name", ["j2k2_poc_main_3_entries.png",
                                  "j2k2_rgn_tiles_97.jpg",
                                  "j2k2_ppt_no_sop.png"])
def test_header_byte_mutations_read_as_reference(tmp_path, name):
    """Every byte of the main header and the first tile-part header of a
    POC, an RGN-in-tiles and a PPT fixture set to 0, 0xFF, its bit 7 or
    bit 0 flipped: the port reads or refuses exactly where the reference
    does (POC, RGN and PPT fields, code-block styles among them)."""
    data = (FIXTURES / name).read_bytes()
    end = data.find(b"\xff\x93")
    p = tmp_path / "head.png"
    seen = set()
    for i in range(2, end):
        for v in {0, 0xFF, data[i] ^ 0x80, data[i] ^ 1} - {data[i]}:
            p.write_bytes(data[:i] + bytes([v]) + data[i + 1:])
            seen.add(_reads_as_reference(p))
    assert {"cv2", "none"} <= seen


# ----------------------------------------------------------- the paths

def test_generate_tree_writes_what_the_reference_writes(tmp_path):
    """generate_tree (blur) through both packages on a tree of every file
    built here and part 2's fixtures and skip files: the same files
    written (those cv2 reads) and skipped, within 2 LSB of the
    reference's."""
    src = tmp_path / "src"
    files = [(f"{n}.png", d) for n, d in _built().items()] + [
        (p.name, p.read_bytes()) for p in FIXTURES.glob("j2k2_*")] + [
        (p.name, p.read_bytes()) for p in (FIXTURES / "skip").glob("j2k2_*")]
    for k, (name, data) in enumerate(files):
        out = src / f"c{k % 3}" / name
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_bytes(data)
    want = sum(cv2.imread(str(p)) is not None for p in src.glob("*/*"))
    lines = []
    n = offline.generate_tree(str(src), str(tmp_path / "ours"), "blur",
                              log=lines.append, device="cpu")
    m = joffline.generate_tree(str(src), str(tmp_path / "ref"), "blur",
                               log=quiet)
    assert n == m == want and want > 100
    assert f"Skipped {len(files) - want} unreadable files" in lines
    ref = sorted(str(p.relative_to(tmp_path / "ref"))
                 for p in (tmp_path / "ref").glob("*/*"))
    assert sorted(str(p.relative_to(tmp_path / "ours"))
                  for p in (tmp_path / "ours").glob("*/*")) == ref
    for k in ref:
        a = cv2.imread(str(tmp_path / "ours" / k)).astype(int)
        b = cv2.imread(str(tmp_path / "ref" / k)).astype(int)
        assert np.abs(a - b).max() <= 2, k


def test_part2_fixtures_are_committed():
    """make_fixtures wrote part 2's fixtures (15 cv2 reads, 12 skip files
    of which PIL reads 3) beside part 1's."""
    assert len(PART2) == 15 and len(PART2_SKIPS) == 12
    pil = [n for n in PART2_SKIPS if n.startswith("j2k2_raw_gray")]
    assert len(pil) == 3


def test_built_file_of_phase_13(tmp_path):
    """chip_smoke.py's built file: the 640 x 480 source of JPEG2000_BIG
    coded by its own writer (9/7, style 63 over three layers, a POC of
    three entries, every packet header in PPT markers) reads in cv2 and
    PIL to the pixels of JPEG2000_BUILT_DIGEST, near its source, and the
    port gives them."""
    img, data = chip_smoke.j2k_built()
    src, _ = cases.build_big(np.random.default_rng(cases.JPEG2000_SEED + 1))
    np.testing.assert_array_equal(img, src)
    assert cases.cod_fields(data)[2] == 3 and cases.cod_fields(data)[7] == 63
    assert 0xFF5F in {m for _, m, _ in cases.main_markers(data)}
    assert 0xFF61 in {m for m, _ in cases.parse(data)[1][0][3]}
    p = tmp_path / chip_smoke.JPEG2000_BUILT
    p.write_bytes(data)
    ref = cv2.imread(str(p))[:, :, ::-1].copy()
    assert hashlib.sha256(ref.tobytes()).hexdigest() == (
        chip_smoke.JPEG2000_BUILT_DIGEST)
    assert np.sqrt(np.mean((ref.astype(float) - img) ** 2)) < 3
    np.testing.assert_array_equal(native.decode(str(p)), ref)
    assert native.probe([str(p)], reader="cv2").tolist() == [[480, 640]]
