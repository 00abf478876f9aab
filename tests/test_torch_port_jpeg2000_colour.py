"""JPEG 2000 part 3, the JP2 colour boxes, read by the port as the reference
reads them (cv2.imread, else PIL's convert("RGB"), else refused as both
refuse), max diff 0, through native.decode, load_batch and load_canvas:

- colr: sRGB, gray on 3 components (cv2 copies comp 0), sYCC on 5/3 and
  9/7 at 8 and 12 bits and with 4 components (cv2: the samples shifted
  to 8 bits, then COLOR_YUV2BGR; PIL, where cv2 refuses an image offset,
  signed samples or a precision under 8: its own YCbCr conversion), an
  ICC profile and CIELab with 7 and 35-byte bodies (taken for sRGB), CMYK
  (PIL's cmyk2rgb) and eYCC (refused by both, whatever its components);
- cdef: a swap, the reverse, an opacity channel first (OpenJPEG's swap
  loop, not a clean permutation), alpha last, every channel on asoc 0
  (PIL ignores cdef);
- pclr without its cmap (OpenJPEG drops it; PIL reads mode P under an
  sRGB colr), pclr and cmap under gray and sRGB with 2 and 256 entries
  (indices past NE clamped), MTYP 0 and 1 mixed, 1 to 5 columns (sYCC
  of 5: cv2 converts the first 3), entries
  of 4, 12, 16 and 32 bits, Pillow's palette (duplicates merged, columns
  of one byte, black past its colours);
- OpenJPEG's refusals (check_color and the box readers) and what it only
  warns about, box mutations held against both readers live, and seeded
  random colour boxes;
- the faults this part repairs: eYCC and a file of more than 4 components
  refused without naming JPEG 2000, Pillow's j2ku_gray_rgb stepping
  from byte x0, a header box skipped before jp2h making later ones read
  (JP2_STATE_UNKNOWN);
- the committed fixtures of tests/data/jpeg2000_colour, generate_tree
  through both packages on a tree of these files, and chip_smoke.py's
  built 640 x 480 sYCC file against the digest of cv2's pixels.
"""

import functools
import hashlib
import importlib.util
import random
import struct
from pathlib import Path

import cv2
import numpy as np
import pytest
from PIL import Image

from tsr_tpu import offline as joffline
from tsr_tpu_torch import native, offline
from test_torch_port_jpeg2000 import (SIZE, _reads_as_reference, cases,
                                      chip_smoke, port_components, quiet)

HERE = Path(__file__).resolve().parent
FIXTURES = HERE / "data" / "jpeg2000_colour"
_spec = importlib.util.spec_from_file_location(
    "jpeg2000_colour_fixtures", FIXTURES / "make_fixtures.py")
make_fixtures = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(make_fixtures)
EXPECTED = np.load(FIXTURES / "expected.npz")
CASES, SKIPS = make_fixtures.names()
PIL_SKIPS = tuple(n for n in SKIPS if f"decoded_skip__{n}" in EXPECTED.files)


def _rgba(img):
    return np.dstack([img, img[:, :, :1] // 2 + 64])


def _rows(n, npc, seed, bits=8):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 1 << min(bits, 32), (n, npc), dtype=np.uint64
                        ).tolist()


@functools.lru_cache(maxsize=None)
def _built():
    """{name: bytes} of the files built here once: every colr, cdef and
    pclr/cmap case."""
    rng = np.random.default_rng(2626)
    img = cases.smooth(rng, 14, 19, amp=40)
    rgb, rgba = cases.pil_j2k(img), cases.pil_j2k(_rgba(img), "RGBA")
    gray, la = cases.pil_j2k(img, "L"), cases.pil_j2k(img, "LA")
    lossy = cases.pil_j2k(img, irreversible=True)
    offset = cases.pil_j2k(img, offset=(3, 1), tile_size=(30, 20))
    index = cases.pil_j2k(np.tile(np.arange(19, dtype=np.uint8) * 13,
                                  (14, 1)), "L")
    wide = cases.pil_j2k(np.tile(np.arange(19, dtype=np.uint8) * 13 + 5,
                                 (14, 1)), "L")
    colr = cases.set_colr
    out = {
        "colr_srgb": colr(rgb, 16), "colr_gray_on_3": colr(rgb, 17),
        "colr_gray_on_4": colr(rgba, 17),
        "sycc_53": colr(rgb, 18), "sycc_97": colr(lossy, 18),
        "sycc_53_12bit": colr(cases.with_precision(rgb, 12), 18),
        "sycc_97_12bit": colr(cases.with_precision(lossy, 12), 18),
        "sycc_16bit": colr(cases.cv2_j2k(  # cv2 writes 32 pixels a side
            cases.smooth(rng, 33, 34).astype(np.uint16) * 257 + 3), 18),
        "sycc_rgba": colr(rgba, 18), "sycc_gray": colr(gray, 18),
        "sycc_la": colr(la, 18), "sycc_offset": colr(offset, 18),
        "sycc_signed": colr(cases.with_precision(rgb, 8, True), 18),
        "sycc_6bit": colr(cases.with_precision(rgb, 6), 18),
        "sycc_offset_rgba": colr(cases.pil_j2k(
            _rgba(img), "RGBA", offset=(2, 5), tile_size=(8, 8)), 18),
        "icc": cases.with_colr(rgb, b"\x02\0\0" + bytes(range(60))),
        "icc_one_byte": cases.with_colr(gray, b"\x02\0\0\x07"),
        "cielab_7": cases.with_colr(rgb, b"\x01\0\0\0\0\0\x0e"),
        "cielab_35": cases.with_colr(rgb, b"\x01\0\0\0\0\0\x0e"
                                     + bytes(range(1, 29))),
        "cielab_20": cases.with_colr(rgb, b"\x01\0\0\0\0\0\x0e" + bytes(13)),
        "srgb_20": cases.with_colr(rgb, b"\x01\0\0\0\0\0\x10" + bytes(13)),
        "meth_3": cases.with_colr(gray, b"\x03\0\0\0\0\0\x0c"),
        "cmyk": colr(rgba, 12), "cmyk_offset": colr(cases.pil_j2k(
            _rgba(img), "RGBA", offset=(1, 2), tile_size=(9, 9)), 12),
        "cmyk_3": colr(rgb, 12),
        "cmyk_srgb_second": cases.with_box(rgba, cases.box(
            b"colr", b"\x01\0\0\0\0\0\x0c")),
        "cdef_swap": cases.with_box(rgb, cases.cdef_box(
            [(0, 0, 2), (1, 0, 1), (2, 0, 3)])),
        "cdef_reverse": cases.with_box(rgb, cases.cdef_box(
            [(0, 0, 3), (1, 0, 2), (2, 0, 1)])),
        "cdef_alpha_first": cases.with_box(rgb, cases.cdef_box(
            [(0, 1, 0), (1, 0, 1), (2, 0, 2)])),
        "cdef_alpha_last_swapped": cases.with_box(
            cases.without_box(rgba, b"cdef"), cases.cdef_box(
                [(0, 0, 3), (1, 0, 2), (2, 0, 1), (3, 1, 0)])),
        "cdef_asoc_0": cases.with_box(rgb, cases.cdef_box(
            [(0, 0, 0), (1, 0, 0), (2, 0, 0)])),
        "cdef_whole_image": cases.with_box(rgb, cases.cdef_box(
            [(0, 2, 65535), (1, 0, 3), (2, 0, 2)])),
        "cdef_opacity_moves_nothing": cases.with_box(rgb, cases.cdef_box(
            [(0, 1, 3), (1, 0, 2), (2, 0, 1)])),
        "cdef_sycc": colr(cases.with_box(rgb, cases.cdef_box(
            [(0, 0, 1), (1, 0, 3), (2, 0, 2)])), 18),
    }
    pal3 = _rows(256, 3, 1)
    for cs, name in ((17, "gray"), (16, "srgb"), (0, "no_colr")):
        base = colr(gray, cs) if cs else cases.without_box(gray, b"colr")
        ibase = colr(index, cs) if cs else cases.without_box(index, b"colr")
        out[f"pclr_no_cmap_{name}"] = cases.with_box(
            base, cases.pclr_box(pal3[:40]))
        for ne in (2, 256):
            out[f"pclr_cmap_{name}_{ne}"] = cases.with_box(cases.with_box(
                ibase, cases.pclr_box(pal3[:ne])),
                cases.cmap_box([(0, 1, i) for i in range(3)]))
        out[f"pclr_cmap_mixed_mtyp_{name}"] = cases.with_box(cases.with_box(
            ibase, cases.pclr_box(pal3[:200], bits=[3, 7, 7])),
            cases.cmap_box([(0, 0, 0), (0, 1, 1), (0, 1, 2)]))
    srgb_index = colr(index, 16)
    for npc in (1, 2, 4, 5):
        out[f"pclr_{npc}_columns"] = cases.with_box(cases.with_box(
            srgb_index, cases.pclr_box(_rows(250, npc, npc))),
            cases.cmap_box([(0, 1, i) for i in range(npc)]))
        out[f"pclr_{npc}_columns_no_cmap"] = cases.with_box(
            srgb_index, cases.pclr_box(_rows(250, npc, npc + 9)))
    for bits, name in ((3, 4), (11, 12), (15, 16), (31, 32), (0x87, 8)):
        rows = _rows(256, 3, bits, 1 + (bits & 0x7F))
        out[f"pclr_bits_{name}{'_signed' if bits & 0x80 else ''}"] = (
            cases.with_box(cases.with_box(
                srgb_index, cases.pclr_box(rows, bits=[bits] * 3)),
                cases.cmap_box([(0, 1, i) for i in range(3)])))
    dup = [pal3[k % 7] for k in range(256)]
    out["pclr_5_columns_sycc"] = colr(out["pclr_5_columns"], 18)
    out["pclr_duplicates_no_cmap"] = cases.with_box(
        colr(wide, 16), cases.pclr_box(dup))
    out["pclr_la_no_cmap"] = cases.with_box(colr(la, 16),
                                            cases.pclr_box(pal3[:30]))
    out["pclr_offset_no_cmap"] = cases.with_box(colr(cases.pil_j2k(
        img, "L", offset=(2, 2), tile_size=(30, 20)), 16),
        cases.pclr_box(pal3[:90]))
    out["pclr_12bit_index"] = cases.with_box(cases.with_box(
        cases.with_precision(srgb_index, 12), cases.pclr_box(pal3)),
        cases.cmap_box([(0, 1, i) for i in range(3)]))
    # cv2's readHeader refuses signed and narrow samples on the
    # codestream's components, before the palette gives 8-bit ones
    for label, bits, signed in (("6bit", 6, False), ("signed", 8, True)):
        out[f"pclr_{label}_index"] = cases.with_box(cases.with_box(
            cases.with_precision(srgb_index, bits, signed),
            cases.pclr_box(pal3)), cases.cmap_box([(0, 1, i)
                                                   for i in range(3)]))
    out["pclr_cmap_two_comps"] = cases.with_box(cases.with_box(
        colr(rgb, 16), cases.pclr_box(pal3[:64])),
        cases.cmap_box([(1, 1, 0), (2, 1, 1), (0, 1, 2)]))
    out["pclr_weird_cmap"] = cases.with_box(cases.with_box(
        srgb_index, cases.pclr_box(pal3[:64])),
        cases.cmap_box([(0, 1, 0), (0, 0, 0), (0, 1, 2)]))
    out["pclr_cdef"] = cases.with_box(cases.with_box(cases.with_box(
        srgb_index, cases.pclr_box(pal3[:64])),
        cases.cmap_box([(0, 1, i) for i in range(3)])),
        cases.cdef_box([(0, 0, 3), (1, 0, 2), (2, 0, 1)]))
    return out


def _eycc_files():
    """eYCC colr boxes on every kind of file: gray, gray and alpha, RGB 5/3
    and 9/7, RGBA, 12 and 16 bits, a palette, an image offset."""
    rng = np.random.default_rng(2627)
    img = cases.smooth(rng, 11, 13, amp=20)
    srcs = {"gray": cases.pil_j2k(img, "L"), "la": cases.pil_j2k(img, "LA"),
            "rgb": cases.pil_j2k(img),
            "rgb_97": cases.pil_j2k(img, irreversible=True),
            "rgba": cases.pil_j2k(_rgba(img), "RGBA"),
            "rgb_12bit": cases.with_precision(cases.pil_j2k(img), 12),
            "rgb_16bit": cases.cv2_j2k(cases.smooth(rng, 32, 32).astype(
                np.uint16) * 257),
            "rgb_offset": cases.pil_j2k(img, offset=(3, 1),
                                        tile_size=(30, 20))}
    out = {k: cases.set_colr(v, 24) for k, v in srcs.items()}
    out["palette"] = cases.with_box(cases.with_box(
        cases.set_colr(cases.pil_j2k(img, "L"), 24),
        cases.pclr_box(_rows(256, 3, 5))),
        cases.cmap_box([(0, 1, i) for i in range(3)]))
    return out


def _write(tmp_path, name, data):
    p = tmp_path / f"{name}.png"
    p.write_bytes(data)
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
    """The port's components equal opj_decode's, the colour boxes applied
    (or both fail)."""
    want, got = cases.opj_components(data), port_components(data)
    assert (want is None) == (got is None)
    if want is not None:
        assert got[:2] == want[:2]
        assert len(got[2]) == len(want[2])
        for a, b in zip(got[2], want[2]):
            np.testing.assert_array_equal(a, b)


# ------------------------------------------------------------ the cases

READERS = {
    "colr_srgb": "cv2", "colr_gray_on_3": "cv2", "colr_gray_on_4": "cv2",
    "sycc_53": "cv2", "sycc_97": "cv2", "sycc_53_12bit": "cv2",
    "sycc_97_12bit": "cv2", "sycc_16bit": "cv2", "sycc_rgba": "cv2",
    "sycc_gray": "none", "sycc_la": "none", "sycc_offset": "pil",
    "sycc_signed": "pil", "sycc_6bit": "pil", "sycc_offset_rgba": "pil",
    "icc": "cv2", "icc_one_byte": "pil", "cielab_7": "cv2",
    "cielab_35": "cv2", "cielab_20": "cv2", "srgb_20": "cv2",
    "meth_3": "pil", "cmyk": "pil", "cmyk_offset": "pil", "cmyk_3": "none",
    "cmyk_srgb_second": "cv2", "cdef_swap": "cv2", "cdef_reverse": "cv2",
    "cdef_alpha_first": "cv2", "cdef_alpha_last_swapped": "cv2",
    "cdef_asoc_0": "cv2", "cdef_whole_image": "cv2",
    "cdef_opacity_moves_nothing": "cv2", "cdef_sycc": "cv2",
    "pclr_no_cmap_gray": "cv2", "pclr_no_cmap_srgb": "pil",
    "pclr_no_cmap_no_colr": "none", "pclr_cmap_gray_2": "cv2",
    "pclr_cmap_gray_256": "cv2", "pclr_cmap_srgb_2": "cv2",
    "pclr_cmap_srgb_256": "cv2", "pclr_cmap_no_colr_2": "cv2",
    "pclr_cmap_no_colr_256": "cv2", "pclr_cmap_mixed_mtyp_gray": "cv2",
    "pclr_cmap_mixed_mtyp_srgb": "cv2", "pclr_cmap_mixed_mtyp_no_colr": "cv2",
    "pclr_1_columns": "pil", "pclr_1_columns_no_cmap": "pil",
    "pclr_2_columns": "pil", "pclr_2_columns_no_cmap": "pil",
    "pclr_4_columns": "cv2", "pclr_4_columns_no_cmap": "pil",
    "pclr_5_columns": "cv2", "pclr_5_columns_no_cmap": "pil",
    "pclr_5_columns_sycc": "cv2",
    "pclr_bits_4": "cv2", "pclr_bits_12": "cv2", "pclr_bits_16": "cv2",
    "pclr_bits_32": "cv2", "pclr_bits_8_signed": "cv2",
    "pclr_duplicates_no_cmap": "pil", "pclr_la_no_cmap": "pil",
    "pclr_offset_no_cmap": "pil", "pclr_12bit_index": "cv2",
    "pclr_6bit_index": "pil", "pclr_signed_index": "pil",
    "pclr_cmap_two_comps": "cv2", "pclr_weird_cmap": "cv2",
    "pclr_cdef": "cv2"}


def test_cases_cover_what_they_name():
    """Every case built here is listed with the reader that reads it."""
    assert sorted(_built()) == sorted(READERS)


@pytest.mark.parametrize("name", sorted(READERS))
def test_colour_case_reads_as_reference(tmp_path, name):
    """Each colr, cdef and pclr/cmap case reads as the reference reads it
    (cv2's pixels, else PIL's, else refused as both refuse), through
    decode, load_batch and load_canvas, both probes at decode's size; its
    components after the colour boxes equal opj_decode's."""
    data = _built()[name]
    assert _reads_everywhere(_write(tmp_path, name, data)) == READERS[name]
    _matches_openjpeg(data)


def test_sycc_is_cv2s_yuv_matrix_not_bt601(tmp_path):
    """cv2 reads sYCC through its own COLOR_YUV2BGR on the components
    shifted to 8 bits: the port gives cvtColor's pixels, which stand up to
    32 away from the BT.601 YCbCr formula PIL uses."""
    for name, shift in (("sycc_53", 0), ("sycc_53_12bit", 4)):
        data = _built()[name]
        comps = cases.opj_components(data)[2]
        yuv = np.stack([(c >> shift).astype(np.uint8) for c in comps], -1)
        want = cv2.cvtColor(yuv, cv2.COLOR_YUV2BGR)[:, :, ::-1]
        got = native.decode(str(_write(tmp_path, name, data)))
        np.testing.assert_array_equal(got, want)
    yuv = np.mgrid[0:256:15, 0:256:5, 0:256:5].reshape(3, 1, -1).transpose(
        1, 2, 0).astype(np.uint8)
    cv = cv2.cvtColor(yuv, cv2.COLOR_YUV2BGR)[0, :, ::-1].astype(int)
    pil = np.asarray(Image.fromarray(yuv, "YCbCr").convert("RGB"))[0]
    assert np.abs(cv - pil).max() >= 30


def test_cdef_alpha_first_is_the_swap_loop(tmp_path):
    """An opacity channel first and colour channels at asoc 1 and 2:
    OpenJPEG's opj_jp2_apply_cdef swaps comps 1 and 0, then 2 and 1, and
    the image's comps come out (1, 2, 0): cv2's RGB is the base's (G, B,
    R), not the (B, R, G) a clean permutation would give."""
    base = cases.opj_components(_built()["colr_srgb"])[2]
    got = native.decode(str(_write(tmp_path, "a", _built()[
        "cdef_alpha_first"])))
    for c, k in enumerate((1, 2, 0)):
        np.testing.assert_array_equal(got[:, :, c], base[k])


def test_palette_reads(tmp_path):
    """A cmap under a gray colr: cv2 copies palette column 0 three times;
    indices past NE take the last entry; PIL reads mode P only under an
    sRGB colr (its table has no other), its palette the entries' first
    bytes with duplicates merged and black past them."""
    built = _built()
    got = native.decode(str(_write(tmp_path, "g", built[
        "pclr_cmap_gray_256"])))
    assert (got[:, :, 0] == got[:, :, 1]).all() and (
        got[:, :, 0] == got[:, :, 2]).all()
    comps = cases.opj_components(built["pclr_cmap_srgb_2"])[2]
    pal = _rows(256, 3, 1)[:2]
    assert {tuple(int(c[y, x]) for c in comps) for y in range(14)
            for x in range(19)} <= {tuple(p) for p in pal}
    p = _write(tmp_path, "d", built["pclr_duplicates_no_cmap"])
    assert Image.open(p).mode == "P"
    got = native.decode(str(p))
    assert len({tuple(v) for v in got.reshape(-1, 3)}) <= 7 + 1


# ------------------------------------------------------- the refusals

@pytest.mark.parametrize("name", sorted(_eycc_files()))
def test_eycc_refused_by_both_readers(tmp_path, name):
    """eYCC on every kind of file: cv2 refuses the colour space ("Unsupported
    color space conversion"), PIL has no unpacker for it; the port reads it
    as unreadable: the cv2 probe (0, 0), decode "failed to decode", never
    naming JPEG 2000 (it named it before this part)."""
    p = _write(tmp_path, name, _eycc_files()[name])
    assert _reads_everywhere(p) == "none"
    with pytest.raises(RuntimeError, match="failed to decode"):
        native.decode(str(p))
    assert cases.opj_components(p.read_bytes()) is not None


def test_more_than_four_components_refused(tmp_path):
    """A raw codestream and a JP2 file of 5 components: cv2 refuses more
    than 4 ("Unsupported number of components"), PIL has no mode for them;
    OpenJPEG decodes them. The port reads them as unreadable, never
    naming JPEG 2000."""
    img = cases.smooth(np.random.default_rng(5), 12, 14)
    raw = cases.opj_encode(np.dstack([img, img[:, :, :2]]), numres=2)
    jp2 = cases.pil_j2k(img)
    at = jp2.find(b"jp2c") - 4
    jp2 = jp2[:at] + struct.pack(">I4s", 8 + len(raw), b"jp2c") + raw
    i = jp2.find(b"ihdr") + 12
    jp2 = (jp2[:i] + struct.pack(">H", 5) + jp2[i + 2:]).replace(b"bpcc",
                                                                 b"xxxx")
    for name, data in (("raw", raw), ("jp2", jp2)):
        p = _write(tmp_path, name, data)
        assert cases.opj_components(data) is not None
        assert _reads_everywhere(p) == "none"
        with pytest.raises(RuntimeError, match="failed to decode"):
            native.decode(str(p))


def _mutations():
    """{name: bytes} of box mutations: pclr NE 0 and 1025, no columns, a
    second pclr, cmap before pclr, past the palette's columns or the
    components, MTYP 2, a column mapped twice or never, a direct use with
    PCOL 1, a second cmap; cdef past the channels, an association past
    them, a channel twice or missing, no entries, a second cdef; colr,
    pclr, cmap and cdef bodies cut; an empty ICC profile."""
    rng = np.random.default_rng(2628)
    img = cases.smooth(rng, 10, 12, amp=30)
    gray, rgb = cases.pil_j2k(img, "L"), cases.pil_j2k(img)
    pal = _rows(20, 3, 3)
    pc = cases.pclr_box(pal)
    cm = cases.cmap_box([(0, 1, i) for i in range(3)])

    def pclr_cmap(base, pclr=pc, cmap=cm):
        return cases.with_box(cases.with_box(base, pclr), cmap)

    def cut(b, k):
        return struct.pack(">I", len(b) - k) + b[4:-k]

    out = {}
    for cs, name in ((16, "srgb"), (17, "gray")):
        g = cases.set_colr(gray, cs)
        out[f"pclr_ne_0_{name}"] = cases.with_box(g, cases.pclr_box(
            [], bits=[7] * 3))
        out[f"pclr_ne_1025_{name}"] = cases.with_box(g, cases.pclr_box(
            _rows(1025, 1, 4)))
        out[f"pclr_no_columns_{name}"] = cases.with_box(g, cases.box(
            b"pclr", struct.pack(">HB", 4, 0)))
        out[f"pclr_twice_{name}"] = cases.with_box(cases.with_box(g, pc), pc)
        out[f"cmap_before_pclr_{name}"] = cases.with_box(
            cases.with_box(g, cm), pc)
        out[f"cmap_past_columns_{name}"] = pclr_cmap(g, cmap=cases.cmap_box(
            [(0, 1, 0), (0, 1, 1), (0, 1, 3)]))
        out[f"cmap_past_components_{name}"] = pclr_cmap(
            g, cmap=cases.cmap_box([(0, 1, 0), (1, 1, 1), (0, 1, 2)]))
        out[f"cmap_mtyp_2_{name}"] = pclr_cmap(g, cmap=cases.cmap_box(
            [(0, 1, 0), (0, 2, 1), (0, 1, 2)]))
        out[f"cmap_column_twice_{name}"] = pclr_cmap(g, cmap=cases.cmap_box(
            [(0, 1, 0), (0, 1, 0), (0, 1, 2)]))
        out[f"cmap_direct_pcol_1_{name}"] = pclr_cmap(
            g, cmap=cases.cmap_box([(0, 1, 0), (0, 0, 1), (0, 1, 2)]))
        out[f"cmap_twice_{name}"] = cases.with_box(pclr_cmap(g), cm)
        out[f"pclr_cut_{name}"] = cases.with_box(g, cut(pc, 5))
        out[f"cmap_cut_{name}"] = pclr_cmap(g, cmap=cut(cm, 2))
    r = cases.set_colr(rgb, 16)
    for entries, name in (([(0, 0, 1), (1, 0, 2), (5, 0, 3)], "past"),
                          ([(0, 0, 1), (1, 0, 2), (2, 0, 9)], "asoc_past"),
                          ([(0, 0, 1), (1, 0, 2), (1, 0, 3)], "twice"),
                          ([(0, 0, 1), (1, 0, 2)], "missing"),
                          ([], "empty")):
        out[f"cdef_{name}"] = cases.with_box(r, cases.cdef_box(entries))
    cd = cases.cdef_box([(0, 0, 1), (1, 0, 2), (2, 0, 3)])
    out["cdef_twice"] = cases.with_box(cases.with_box(r, cd), cd)
    out["cdef_cut"] = cases.with_box(r, cut(cd, 3))
    out["colr_cut_6"] = cases.with_colr(r, b"\x01\0\0\0\0\x12")
    out["colr_cut_2"] = cases.with_colr(r, b"\x01\0")
    out["icc_empty"] = cases.with_colr(r, b"\x02\0\0")
    return out


MUTATIONS = _mutations()


@pytest.mark.parametrize("name", sorted(MUTATIONS))
def test_box_mutations_read_as_reference(tmp_path, name):
    """Each box mutation reads as cv2 and PIL read it live (OpenJPEG's
    refusals in its box readers and opj_jp2_check_color; PIL ignores cdef
    and parses its own palette): where both refuse, decode raises "failed
    to decode" and never names JPEG 2000; the components equal
    opj_decode's or both fail."""
    data = MUTATIONS[name]
    reader = _reads_everywhere(_write(tmp_path, name, data))
    assert reader != "named"
    if reader == "none":
        with pytest.raises(RuntimeError, match="failed to decode"):
            native.decode(str(tmp_path / f"{name}.png"))
    _matches_openjpeg(data)


def test_mutations_are_refused_by_openjpeg_and_cv2(tmp_path):
    """OpenJPEG's opj_decode refuses every mutation, and so does the port's
    decoder; cv2 reads none of them; PIL reads those whose box it ignores
    (every cdef, and a cmap under an sRGB colr, where Pillow's own palette
    reads the pclr), and the port gives its pixels."""
    pil = set()
    for name, data in MUTATIONS.items():
        assert cases.opj_components(data) is None, name
        assert port_components(data) is None, name
        p = _write(tmp_path, name, data)
        assert cv2.imread(str(p)) is None, name
        try:
            native.decode(str(p))
        except RuntimeError:
            continue
        pil.add(name)
    assert {n for n in pil if not n.startswith("cdef_")} == {
        f"cmap_{k}_srgb" for k in ("column_twice", "direct_pcol_1", "mtyp_2",
                                   "past_columns", "past_components")}
    assert {n for n in pil if n.startswith("cdef_")} == {
        "cdef_asoc_past", "cdef_missing", "cdef_past"}


# ------------------------------------------------------ repaired faults

def test_pil_gray_rgb_steps_from_byte_x0(tmp_path):
    """Pillow's j2ku_gray_rgb (an RGB or RGBA mode over 1 or 2 gray
    components, as an ihdr count above the codestream's gives) starts each
    tile row at byte x0 of its 4-byte pixels, not at pixel x0: over tiles
    with an image offset (which cv2 refuses) the port lays them out as
    Pillow does, where it laid them out by pixel before."""
    img = cases.smooth(np.random.default_rng(6), 13, 17, amp=60)
    for mode, nc in (("L", 3), ("L", 4), ("LA", 3)):
        data = cases.pil_j2k(img, mode, offset=(5, 7), tile_size=(8, 8))
        i = data.find(b"ihdr") + 12
        data = data[:i] + struct.pack(">H", nc) + data[i + 2:]
        p = _write(tmp_path, f"{mode}_{nc}", data)
        assert _reads_everywhere(p) == "pil"
        by_pixel = cases.opj_components(data)[2][0].astype(np.uint8)
        assert (native.decode(str(p))[:, :, 0] != by_pixel).any()


def test_boxes_after_a_skipped_box_are_read(tmp_path):
    """A box OpenJPEG skips (unknown, or a header box before jp2h) sets
    JP2_STATE_UNKNOWN, every state bit: header boxes after it, still
    before jp2h, are read then. A pclr and cmap behind an xml box apply;
    the same two alone leave the pclr skipped and the cmap read, which
    fails for want of a pclr."""
    img = cases.smooth(np.random.default_rng(7), 11, 15, amp=60)
    pc = cases.pclr_box(_rows(5, 3, 8))
    cm = cases.cmap_box([(0, 1, i) for i in range(3)])
    xml = cases.box(b"xml ", b"<a/>")
    seen = {}
    for cs in (16, 17):
        base = cases.set_colr(cases.pil_j2k(img, "L"), cs)
        at = base.find(b"jp2h") - 4
        for label, boxes in (("pclr_cmap", pc + cm),
                             ("xml_pclr_cmap", xml + pc + cm),
                             ("xml_cdef", xml + cases.cdef_box([(0, 0, 1)]))):
            data = base[:at] + boxes + base[at:]
            seen[cs, label] = _reads_everywhere(_write(tmp_path, label, data))
            _matches_openjpeg(data)
    assert seen[17, "pclr_cmap"] == "none"
    assert seen[16, "xml_pclr_cmap"] == seen[17, "xml_pclr_cmap"] == "cv2"


@pytest.mark.parametrize("seed", range(4))
def test_random_colour_boxes_read_as_reference(tmp_path, seed):
    """50 seeded files a seed of random colr, pclr, cmap and cdef boxes
    (valid and not) over gray, gray and alpha, RGB and RGBA files, some
    with an image offset, signed or narrow samples or a wrong ihdr count:
    the port reads or refuses exactly where the reference does, with its
    pixels and OpenJPEG's components."""
    rnd = random.Random(seed)
    rng = np.random.default_rng(900 + seed)
    img = cases.smooth(rng, 9, 12, amp=60)
    srcs = []
    for mode, a in (("L", img), ("LA", img), ("RGB", img),
                    ("RGBA", _rgba(img))):
        srcs.append(cases.pil_j2k(a, mode))
        srcs.append(cases.pil_j2k(a, mode, offset=(3, 1), tile_size=(8, 8)))
    for k in range(50):
        data = rnd.choice(srcs)
        if rnd.random() < 0.25:
            data = cases.with_precision(data, rnd.choice((6, 12)),
                                        rnd.random() < 0.3)
        data = cases.set_colr(data, rnd.choice((0, 12, 14, 16, 16, 17, 17,
                                                18, 18, 24)),
                              meth=rnd.choice((1, 1, 1, 2)))
        if rnd.random() < 0.2:
            i = data.find(b"ihdr") + 12
            data = data[:i] + struct.pack(">H", rnd.randint(1, 4)) + data[
                i + 2:]
        if rnd.random() < 0.6:
            npc = rnd.choice((1, 2, 3, 3, 4))
            ne = rnd.choice((1, 3, 40, 256, 300))
            rows = _rows(ne, npc, rnd.randrange(1000))
            if rnd.random() < 0.4:
                rows = [rows[j % rnd.randint(1, 9)] for j in range(ne)]
            data = cases.with_box(data, cases.pclr_box(rows))
            if rnd.random() < 0.6:
                data = cases.with_box(data, cases.cmap_box([
                    (rnd.choice((0, 0, 0, 1)), rnd.choice((1, 1, 1, 0)),
                     rnd.choice((i, i, i, 0, 1))) for i in range(npc)]))
        if rnd.random() < 0.4:
            n = rnd.randint(1, 4)
            data = cases.with_box(data, cases.cdef_box([
                (rnd.choice((i, i, i, 0, 4)), rnd.choice((0, 0, 1, 2)),
                 rnd.choice((0, 1, 2, 3, 4, 65535))) for i in range(n)]))
        p = _write(tmp_path, f"r{k}", data)
        assert _reads_as_reference(p) != "named"
        _matches_openjpeg(data)


# --------------------------------------------------------- the fixtures

@pytest.mark.parametrize("name", CASES)
def test_fixture_decodes_as_cv2(name):
    """Every j2k3_ fixture cv2 reads: decode equals expected.npz (cv2's
    pixels), max diff 0; both probes give its (h, w); load_batch and
    load_canvas read it."""
    p = str(FIXTURES / name)
    want = EXPECTED[f"decoded__{name}"]
    np.testing.assert_array_equal(native.decode(p), want)
    for reader in ("cv2", "port"):
        assert native.probe([p], reader=reader).tolist() == [
            list(want.shape[:2])]
    assert native.load_batch([p], SIZE).shape == (1, SIZE, SIZE, 3)
    canvas = np.zeros((1, 200, 200, 3), np.uint8)
    assert native.load_canvas([p], canvas).tolist() == [list(want.shape[:2])]
    np.testing.assert_array_equal(canvas[0, :want.shape[0], :want.shape[1]],
                                  want)


@pytest.mark.parametrize("name", SKIPS)
def test_skip_fixture_reads_as_reference(name):
    """Each skip/ file: the cv2 probe gives (0, 0); decode gives PIL's
    pixels where PIL reads it (CMYK, a palette, sYCC with an offset), and
    otherwise raises "failed to decode", not naming JPEG 2000."""
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


def test_committed_fixtures_equal_cv2_and_pil(tmp_path):
    """The committed files equal what make_fixtures writes here, each reads
    as the reference reads it now (cv2 and PIL live), 3 of the skip files
    PIL reads (chip_smoke.JPEG2000_COLOUR_PIL_READS), and the directory
    stays under 40 KiB."""
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
        chip_smoke.JPEG2000_COLOUR_PIL_READS)
    assert int(EXPECTED["generate_tree_written"]) == len(CASES)
    assert sum(p.stat().st_size for p in FIXTURES.rglob("*")
               if p.is_file()) < 40 * 1024


@pytest.mark.parametrize("name", ["j2k3_cmap_mixed_mtyp.png",
                                  "skip/j2k3_pclr_no_cmap_srgb.png",
                                  "j2k3_sycc_97.jpg", "skip/j2k3_cmyk.png"])
def test_cut_points_and_mutations_read_as_reference(tmp_path, name):
    """Every cut point of a palette file cv2 reads, one PIL reads, an sYCC
    9/7 file and a CMYK file, and 40 seeded byte mutations of each: the
    port reads or refuses exactly where the reference does, or names JPEG
    2000 for a file a mutation gave sub-sampled components or HTJ2K."""
    data = (FIXTURES / name).read_bytes()
    p = tmp_path / "cut.png"
    for cut in range(len(data)):
        p.write_bytes(data[:cut])
        assert _reads_as_reference(p) != "named"
    rng = np.random.default_rng(len(data))
    for _ in range(40):
        m = bytearray(data)
        for _ in range(int(rng.integers(1, 4))):
            i = int(rng.integers(len(m)))
            m[i] = int(rng.choice([m[i] ^ (1 << int(rng.integers(8))), 0,
                                   0xFF, int(rng.integers(256))]))
        p.write_bytes(bytes(m))
        _reads_as_reference(p)


def test_fixture_brings_a_bucket_of_its_own():
    """The 10 x 180 palette fixture lies in generate_tree buckets (32 x 192
    for blur, compound and blur_rand) no fixture of the other image
    directories brings, so that phase 13 holds B2 and B3 there."""
    others = []
    for d in ("images", "webp", "webp_lossy", "jpeg2000"):
        root = HERE / "data" / d
        others += [str(p) for p in root.iterdir()
                   if p.suffix in chip_smoke.IMAGE_SUFFIXES]
    sides = [tuple(s) for s in native.probe(others, reader="cv2").tolist()
             if s[0] > 0]
    mine = native.probe([str(FIXTURES / "j2k3_pclr_10x180.png")],
                        reader="cv2").tolist()
    assert mine == [[10, 180]]
    for kind in ("blur", "compound", "blur_rand"):
        halo = offline.HALO[kind]
        bucket = (offline._bucket_with_room(10, halo),
                  offline._bucket_with_room(180, halo))
        assert bucket not in {(offline._bucket_with_room(h, halo),
                               offline._bucket_with_room(w, halo))
                              for h, w in sides}


# ----------------------------------------------------------- the paths

def test_generate_tree_writes_what_the_reference_writes(tmp_path):
    """generate_tree (blur) through both packages on a tree of every case
    built here, the eYCC files, the mutations and the committed fixtures:
    the same files written (those cv2 reads) and skipped, within 2 LSB of
    the reference's."""
    src = tmp_path / "src"
    files = [(f"{n}.png", d) for n, d in {**_built(), **_eycc_files(),
                                          **MUTATIONS}.items()]
    files += [(p.name, p.read_bytes()) for p in FIXTURES.glob("j2k3_*")]
    files += [(p.name, p.read_bytes())
              for p in (FIXTURES / "skip").glob("j2k3_*")]
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
    assert n == m == want and want > 50
    assert f"Skipped {len(files) - want} unreadable files" in lines
    ref = sorted(str(p.relative_to(tmp_path / "ref"))
                 for p in (tmp_path / "ref").glob("*/*"))
    assert sorted(str(p.relative_to(tmp_path / "ours"))
                  for p in (tmp_path / "ours").glob("*/*")) == ref
    for k in ref:
        a = cv2.imread(str(tmp_path / "ours" / k)).astype(int)
        b = cv2.imread(str(tmp_path / "ref" / k)).astype(int)
        assert np.abs(a - b).max() <= 2, k


def test_built_file_of_phase_13(tmp_path):
    """chip_smoke.py's built colour file: the 640 x 480 source of
    JPEG2000_BIG as full-range YCbCr stored Y, Cr, Cb, coded by its own
    writer (9/7, no ICT) in a JP2 file of an sYCC colr box and a cdef that
    moves channels 1 and 2 back: cv2 reads it to the pixels of
    JPEG2000_COLOUR_DIGEST, and the port gives them; PIL, which ignores
    cdef, reads it otherwise."""
    img, data = chip_smoke.j2k_colour_built()
    np.testing.assert_array_equal(img, chip_smoke.j2k_source())
    assert cases.cod_fields(data)[3] == 0 and b"cdef" in data[:200]
    p = tmp_path / chip_smoke.JPEG2000_COLOUR_BUILT
    p.write_bytes(data)
    ref = cv2.imread(str(p))[:, :, ::-1].copy()
    assert hashlib.sha256(ref.tobytes()).hexdigest() == (
        chip_smoke.JPEG2000_COLOUR_DIGEST)
    np.testing.assert_array_equal(native.decode(str(p)), ref)
    assert np.abs(np.asarray(Image.open(p).convert("RGB")).astype(int)
                  - ref).max() > 50
    for reader in ("cv2", "port"):
        assert native.probe([str(p)], reader=reader).tolist() == [[480, 640]]
