"""JPEG 2000 part 4, HTJ2K (ITU-T T.814): HT code-blocks and the CAP and
CPF markers, read by the port as the reference reads them (cv2.imread,
else PIL's convert("RGB"), else refused as both refuse), max diff 0,
through native.decode, load_batch and load_canvas:

- files of the test encoder (tests/data/htj2k_encode.py): the 5/3 with
  RCT and the 9/7 with ICT and scalar expounded steps, gray, RGB and RGBA,
  8 and 12 bits, code-blocks of 64 x 64 down to 4 x 4, 16 x 64, 4 x 1024
  and 1024 x 4, tiles, 0 to 5 levels, 1 to 3 layers, every progression
  order, SOP and EPH, the raw codestream and JP2 (with a cdef box); cv2
  gives the encoder's input back for every lossless one;
- CAP alone, CPF alone and both on a part 1 file, which decode as the
  file without them; both refused in a tile-part header;
- signed samples and an image offset, which only PIL reads;
- SigProp and MagRef passes of seeded random bytes (2 and 3 passes, VSC,
  in the cleanup's layer or a later one: OpenJPEG gives a later packet's
  first refinement pass to the cleanup's segment unless TERMALL is set);
- each of OpenJPEG's HT rules reached and held against both readers live:
  ROI, more than 3 passes, Mb over 30, zero bit-planes past Mb, only the
  cleanup pass where they equal Mb, an empty second segment, the segment
  lengths, Scup, the MEL stream's first bytes (where the block's address
  mod 4 decides), U_q past the zero bit-planes + 1 in the first and the
  later row pairs, and VLC significance outside the block; seeded
  mutations of the MEL, VLC and MagSgn bytes;
- the VLC tables (native/ht_tables.h): found in cv2's and Pillow's
  libraries, every codeword written by the encoder into a file cv2 decodes
  to its input;
- the committed fixtures of tests/data/jpeg2000_ht with the 640 x 480 file
  phase 13 of chip_smoke.py times, and generate_tree through both packages.
"""

import functools
import hashlib
import importlib.util
import random
from pathlib import Path

import cv2
import numpy as np
import pytest

from tsr_tpu import offline as joffline
from tsr_tpu_torch import native, offline
from test_torch_port_jpeg2000 import (NAMED, SIZE, _reads_as_reference,
                                      cases, chip_smoke, quiet)
from test_torch_port_jpeg2000_colour import (_matches_openjpeg,
                                             _reads_everywhere, _write)
from test_torch_port_webp import _reference

HERE = Path(__file__).resolve().parent
FIXTURES = HERE / "data" / "jpeg2000_ht"
_spec = importlib.util.spec_from_file_location(
    "jpeg2000_ht_fixtures", FIXTURES / "make_fixtures.py")
make_fixtures = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(make_fixtures)
_spec = importlib.util.spec_from_file_location(
    "extract_ht_tables", FIXTURES / "extract_ht_tables.py")
tables = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(tables)
ht = cases.ht  # the test encoder
EXPECTED = np.load(FIXTURES / "expected.npz")
CASES, SKIPS = make_fixtures.names()
BIG = make_fixtures.BIG
PIL_SKIPS = tuple(n for n in SKIPS if f"decoded_skip__{n}" in EXPECTED.files)


def _messages(data):
    out = []
    cases.opj_components(data, out)
    return out


def _rgba(img):
    return np.dstack([img, img[:, :, :1] // 2 + 64])


# -------------------------------------------------- the encoder's files

@functools.lru_cache(maxsize=None)
def _built():
    """{name: (bytes, reader, the image cv2 gives back, or None)}: the
    encoder's files over its options, built once."""
    rng = np.random.default_rng(2727)
    img = cases.smooth(rng, 21, 26, amp=20)
    noisy = rng.integers(0, 256, (17, 19, 3), dtype=np.uint8)
    gray = img[:, :, 1]
    out = {}

    def add(name, data, reader="cv2", back=None):
        out[name] = (data, reader, back)
    add("53_rct_jp2", ht.encode(img, levels=2, jp2=True), back=img)
    add("53_rct_raw", ht.encode(img, levels=2), back=img)
    add("53_noise", ht.encode(noisy, levels=3, cblk=(8, 8)), back=noisy)
    add("53_no_mct", ht.encode(img, levels=2, mct=False, jp2=True), back=img)
    add("97_ict_jp2", ht.encode(img, levels=3, reversible=False, step=0.5,
                                jp2=True))
    add("97_ict_raw", ht.encode(img, levels=3, reversible=False, step=3.0))
    add("97_steps_by_band", ht.encode(
        img, levels=3, reversible=False, jp2=True,
        step=lambda r, b: 0.4 * (1 + r) * (1.5 if b == 3 else 1.0)))
    add("gray_53_jp2", ht.encode(gray, levels=2, jp2=True),
        back=np.dstack([gray] * 3))
    add("gray_97_jp2", ht.encode(gray, levels=2, reversible=False, step=1.0,
                                 jp2=True))
    g12 = gray.astype(np.uint16) * 16 + 9
    add("gray_12bit_53", ht.encode(g12, levels=2, precision=12, jp2=True),
        back=np.dstack([(g12 >> 4).astype(np.uint8)] * 3))
    add("rgb_12bit_97", ht.encode(img.astype(np.uint16) * 16, levels=2,
                                  precision=12, reversible=False, step=4.0,
                                  jp2=True))
    add("rgba_53", ht.encode(_rgba(img), levels=2, jp2=True), back=img)
    add("la_gray_colr", ht.encode(np.dstack([gray, gray // 2]), levels=1,
                                  jp2=True), back=np.dstack([gray] * 3))
    for cb in ((64, 64), (32, 32), (16, 64), (4, 1024), (1024, 4), (4, 4),
               (64, 4)):
        add(f"cblk_{cb[0]}x{cb[1]}", ht.encode(img, levels=2, cblk=cb),
            back=img)
    for lv in (0, 1, 4):
        add(f"levels_{lv}", ht.encode(img, levels=lv, cblk=(16, 16)),
            back=img)
    big = cases.smooth(rng, 40, 64, amp=10)
    add("levels_5_97", ht.encode(big, levels=5, reversible=False, step=1.0,
                                 jp2=True))
    for order in ht.PROGRESSIONS:
        add(f"order_{order}_3_layers", ht.encode(
            img, levels=2, cblk=(8, 8), layers=3, progression=order,
            jp2=True), back=img)
    add("tiles_53", ht.encode(img, levels=1, tile=(12, 8), cblk=(8, 8)),
        back=img)
    add("tiles_97_layers", ht.encode(img, levels=1, tile=(16, 16),
                                     reversible=False, step=1.0, layers=2,
                                     progression="PCRL", jp2=True))
    add("sop_eph", ht.encode(img, levels=2, sop=True, eph=True, layers=2),
        back=img)
    add("no_cap", ht.encode(img, levels=1, cap=False), back=img)
    add("cpf_no_cap", ht.encode(img, levels=1, cap=False, cpf=3), back=img)
    add("guard_bits_7", ht.encode(img, levels=2, guard=7), back=img)
    add("empty_blocks_included", ht.encode(
        np.full((20, 20, 3), 128, np.uint8), levels=1, include_empty=True),
        back=np.full((20, 20, 3), 128, np.uint8))
    add("flat_no_block", ht.encode(np.full((9, 11, 3), 128, np.uint8),
                                   levels=1),
        back=np.full((9, 11, 3), 128, np.uint8))
    for h, w in ((1, 1), (1, 13), (13, 1), (7, 5), (2, 33)):
        tiny = noisy[:h, :w] if h <= 17 and w <= 19 else rng.integers(
            0, 256, (h, w, 3), dtype=np.uint8)
        add(f"tiny_{h}x{w}", ht.encode(tiny, levels=0), back=tiny)
    add("cdef_swap", cases.with_box(ht.encode(img, levels=1, jp2=True),
                                    cases.cdef_box([(0, 0, 3), (1, 0, 2),
                                                    (2, 0, 1)])),
        back=img[:, :, ::-1])
    add("sycc_colr", ht.encode(img, levels=1, mct=False, jp2=True,
                               enumcs=18))
    # only PIL reads these
    add("signed", ht.encode(img, levels=1, signed=True, jp2=True), "pil")
    add("offset", ht.encode(img, levels=1, offset=(3, 5), tile=(16, 16),
                            jp2=True), "pil")
    add("raw_gray", ht.encode(gray, levels=2), "pil")
    add("precision_6", ht.encode(img >> 2, levels=1, precision=6,
                                 jp2=True), "pil")
    return out


@pytest.mark.parametrize("name", sorted(_built()))
def test_encoder_file_reads_as_reference(tmp_path, name):
    """Each encoder-made HTJ2K file reads as the reference reads it (cv2's
    pixels, else PIL's) through decode, load_batch and load_canvas, both
    probes at decode's size; cv2 gives back the encoder's input where the
    file is lossless; its components equal opj_decode's."""
    data, reader, back = _built()[name]
    p = _write(tmp_path, name, data)
    assert _reads_everywhere(p) == reader
    if back is not None:
        np.testing.assert_array_equal(cv2.imread(str(p))[:, :, ::-1], back)
    _matches_openjpeg(data)


# ------------------------------------------------------ CAP and CPF

def test_cap_and_cpf_are_read_and_left_aside(tmp_path):
    """CAP alone, CPF alone and both (in either order) on Pillow's part 1
    file, and CAP of a longer body and CPF of none: cv2 reads each as the
    file without them, and so does the port (they raised naming JPEG 2000
    before); in a tile-part header both readers refuse them, and so does
    the port, without naming JPEG 2000."""
    img = cases.smooth(np.random.default_rng(4), 14, 17, amp=10)
    base = cases.pil_j2k(img)
    raw = cases.pil_j2k(img, no_jp2=True)
    want = cv2.imread(str(_write(tmp_path, "base", base)))[:, :, ::-1]
    for name, data in (
            ("cap", cases.insert_main(base, 0xFF50, ht.CAP_BODY)),
            ("cpf", cases.insert_main(base, 0xFF59, b"\x00\x01")),
            ("cap_cpf", cases.insert_main(cases.insert_main(
                base, 0xFF59, b"\x00\x01"), 0xFF50, ht.CAP_BODY)),
            ("cpf_cap", cases.insert_main(cases.insert_main(
                base, 0xFF50, ht.CAP_BODY), 0xFF59, b"\x00\x01")),
            ("cap_long", cases.insert_main(base, 0xFF50, bytes(range(40)))),
            ("cpf_empty", cases.insert_main(raw, 0xFF59, b""))):
        p = _write(tmp_path, name, data)
        assert _reads_everywhere(p) == "cv2", name
        np.testing.assert_array_equal(native.decode(str(p)), want)
        _matches_openjpeg(data)
    main, parts, tail = cases.parse(raw)
    for marker, body in ((0xFF50, ht.CAP_BODY), (0xFF59, b"\x00\x01")):
        parts[0][3] = [(marker, body)]
        data = cases.emit(main, parts, tail)
        p = _write(tmp_path, f"tile_{marker:x}", data)
        assert _reads_everywhere(p) == "none"
        with pytest.raises(RuntimeError, match="failed to decode"):
            native.decode(str(p))


@pytest.mark.parametrize("name,marker,body", [
    ("cbd", 0xFF78, cases.CBD_BODY), ("mco", 0xFF77, cases.MCO_BODY),
    ("mct", 0xFF74, b"\x00\x00\x00\x00\x00"), ("mcc", 0xFF75, b"\x00\x00")])
def test_multi_component_markers_still_raise_naming_jpeg2000(tmp_path, name,
                                                             marker, body):
    """Part 2's CBD, MCT, MCC and MCO markers (ROADMAP 8h) on an HTJ2K file,
    which the port raised naming JPEG 2000 for until JPEG 2000 part 5: now
    no reader path names JPEG 2000 for them, and each reads as the
    reference reads it (tests/test_torch_port_jpeg2000_mct.py holds the
    markers themselves): cv2 reads the CBD file and the MCO file (its stage
    of none zeroes the DC level shift), both readers refuse an MCT or MCC
    segment too short for its fields; the components are opj_decode's."""
    data = cases.insert_main(ht.encode(cases.smooth(
        np.random.default_rng(5), 11, 13), levels=1), marker, body)
    p = _write(tmp_path, name, data)
    want = "cv2" if name in ("cbd", "mco") else "none"
    assert (cv2.imread(str(p)) is not None) == (want == "cv2")
    for call in (lambda: native.decode(str(p)),
                 lambda: native.load_batch([str(p)], SIZE),
                 lambda: native.probe([str(p)])):
        try:
            call()
        except RuntimeError as e:
            assert NAMED not in str(e)
    assert _reads_everywhere(p) == want
    _matches_openjpeg(data)


# --------------------------------------------------- refinement passes

def _refined(seed):
    """Files of a cleanup pass one bit-plane up and SigProp / MagRef bytes
    drawn from ``seed``: 1 or 2 refinement passes in the cleanup's packet
    or the next layer's, under styles 0, VSC, TERMALL and both."""
    r = random.Random(seed)
    rng = np.random.default_rng(seed)
    out = {}
    for k in range(6):
        img = cases.smooth(rng, r.randint(5, 24), r.randint(5, 24), amp=30)
        style = r.choice((0, 8, 4, 12))
        later = k % 3 == 2
        out[f"s{seed}_{k}_style{style}{'_later' if later else ''}"] = (
            ht.encode(img, levels=r.choice((0, 1, 2)), plane=1, style=style,
                      cblk=r.choice(((64, 64), (8, 8), (16, 4), (4, 16))),
                      layers=2 if later else 1, layer_of=lambda key: 0,
                      refine=ht.random_refine((1, 2), (1, 14),
                                              1.0 if later else 0.0),
                      rng=r, jp2=True))
    return out


@pytest.mark.parametrize("seed", range(4))
def test_refinement_passes_read_as_reference(tmp_path, seed):
    """SigProp and MagRef passes the encoder does not code, of seeded random
    bytes with 2 or 3 passes to a block: live against both readers, with
    OpenJPEG's components (its MagRef in the reverse stream, SigProp's
    membership across stripes, VSC, the terminating stripes of every
    height mod 4)."""
    for name, data in _refined(seed).items():
        _reads_everywhere(_write(tmp_path, name, data))
        _matches_openjpeg(data)


def test_refinement_passes_change_the_pixels(tmp_path):
    """The same cleanup segments with and without the SigProp and MagRef
    bytes: cv2 reads both, the refined one otherwise (the passes run), and
    the port gives each."""
    img = cases.smooth(np.random.default_rng(9), 16, 20, amp=40)
    shots = {}
    for label, refine in (("plain", None), ("refined", ht.random_refine(
            (2,), (6, 10)))):
        data = ht.encode(img, levels=1, plane=1, refine=refine,
                         rng=random.Random(3), jp2=True)
        p = _write(tmp_path, label, data)
        assert _reads_everywhere(p) == "cv2"
        shots[label] = native.decode(str(p))
    assert (shots["plain"] != shots["refined"]).any()


def test_later_layer_refinement_is_read_as_openjpeg_splits_it(tmp_path):
    """Refinement passes in the layer after the cleanup's. OpenJPEG's
    packet header gives the first segment one pass and the next all the
    rest, whatever a segment holds: without TERMALL the cleanup's segment is
    not full, so a later packet's first refinement pass joins it, and a
    single such pass makes the cleanup's Scup be read from the refinement
    bytes, which both readers refuse ("2 <= Scup"); with TERMALL it gets a
    segment of its own, and two passes without TERMALL leave the second
    one a segment. The port reads each as both readers do."""
    img = cases.smooth(np.random.default_rng(10), 12, 12, amp=30)
    seen = {}
    for passes, style in ((1, 0), (1, 4), (2, 0), (2, 4)):
        data = ht.encode(img, levels=0, plane=1, style=style, layers=2,
                         layer_of=lambda key: 0, refine=lambda key, rng: (
                             passes, bytes(range(7, 13)), True), jp2=True)
        seen[passes, style] = _reads_everywhere(_write(
            tmp_path, f"{passes}_{style}", data))
        _matches_openjpeg(data)
        if seen[passes, style] == "none":
            assert any("2 <= Scup" in m for m in _messages(data))
    assert seen == {(1, 0): "none", (1, 4): "cv2", (2, 0): "cv2",
                    (2, 4): "cv2"}


# --------------------------------------------------------- HT's rules

def _rule_files():
    """{rule: (bytes, the message OpenJPEG gives or None, reader)}: a file
    that reaches each of opj_t1_ht_decode_cblk's rules."""
    rng = np.random.default_rng(11)
    img = cases.smooth(rng, 12, 14, amp=40)
    raw = ht.encode(img, levels=1)

    def enc(**kw):
        return ht.encode(img, levels=1, **kw)

    def scup(v):
        return lambda key, d: cases.with_scup(d, v)

    def first_block(f):
        return lambda key, d: f(d) if key[2:] == (0, 0, 0) else d

    def mel_ff(d):
        d = bytearray(d)
        s = len(d) - ((d[-1] << 4) + (d[-2] & 0xF))
        d[s:s + 2] = b"\xff\xa0"
        return bytes(d)

    def qcd_expn_31(data):  # every band's exponent 31: Mb past 30
        p, body = next((p, b) for p, m, b in cases.main_markers(data)
                       if m == 0xFF5C)
        out = bytearray(data)
        out[p + 5:p + 4 + len(body)] = b"\xf8" * (len(body) - 1)
        return bytes(out)
    return {
        "roi": (cases.insert_main(raw, 0xFF5E, b"\0\0\x03"),
                "We do not support ROI", "none"),
        "passes_4": (enc(plane=1, refine=ht.random_refine((3,), (2, 4))),
                     "more than 3 coding passes", "none"),
        "mb_past_30": (qcd_expn_31(raw), "32 bits are not enough", "none"),
        "zero_planes_past_mb": (enc(zero_planes=lambda k, z: z + 1),
                                "zero bitplanes in", "none"),
        "zero_planes_under": (enc(zero_planes=lambda k, z: max(0, z - 2)),
                              "U_q is larger than zero bitplanes", "none"),
        "only_cleanup": (enc(refine=ht.random_refine((2,), (3, 5))), None,
                         "cv2"),
        "empty_second_segment": (enc(plane=1, refine=ht.random_refine(
            (2,), (0, 0))), "zero length for 2nd", "cv2"),
        "lengths": (enc(mutate=first_block(lambda d: d[:1])),
                    "Invalid codeblock length values", "none"),
        "scup_0": (enc(mutate=scup(0)), "2 <= Scup", "none"),
        "scup_1": (enc(mutate=scup(1)), "2 <= Scup", "none"),
        "scup_4080": (enc(mutate=scup(4080)), "2 <= Scup", "none"),
        "scup_past_lcup": (enc(mutate=scup(4000)), "2 <= Scup", "none"),
        "mel_sequence": (enc(mutate=first_block(mel_ff)),
                         "Incorrect MEL segment sequence", "none"),
    }


RULES = _rule_files()


@pytest.mark.parametrize("rule", sorted(RULES))
def test_each_ht_rule_reads_as_reference(tmp_path, rule):
    """Each of OpenJPEG's HT rules has a file that reaches it (OpenJPEG's
    own message, where it gives one every time), read by the port as cv2
    and PIL read it: refused without naming JPEG 2000 where they fail, the
    cleanup pass alone where they drop the refinement passes."""
    data, message, reader = RULES[rule]
    p = _write(tmp_path, rule, data)
    assert _reads_everywhere(p) == reader
    if message is not None:
        assert any(message in m for m in _messages(data)), _messages(data)
    if reader == "none":
        with pytest.raises(RuntimeError, match="failed to decode"):
            native.decode(str(p))
    _matches_openjpeg(data)


def test_only_cleanup_rule_drops_the_refinement(tmp_path):
    """Zero bit-planes equal to Mb (the cleanup pass at the last bit-plane)
    with refinement passes: OpenJPEG decodes the cleanup pass alone
    (warning once a process), so the file reads as the same file without
    the refinement bytes."""
    img = cases.smooth(np.random.default_rng(12), 12, 14, amp=40)
    a = ht.encode(img, levels=1, refine=ht.random_refine((2,), (3, 5)))
    b = ht.encode(img, levels=1)
    pa, pb = _write(tmp_path, "a", a), _write(tmp_path, "b", b)
    assert _reads_everywhere(pa) == _reads_everywhere(pb) == "cv2"
    np.testing.assert_array_equal(native.decode(str(pa)),
                                  native.decode(str(pb)))
    np.testing.assert_array_equal(native.decode(str(pb)), img)


def test_u_q_rule_of_the_later_row_pairs(tmp_path):
    """A wrong zero bit-plane count that leaves the first row pair's U_q
    within bounds and not a later pair's: OpenJPEG's second U_q message,
    and the port refuses the file as both readers do."""
    rng = np.random.default_rng(13)
    img = np.full((8, 8), 128, np.uint8)
    img[4:, 4:] = rng.integers(0, 256, (4, 4))
    data = ht.encode(img, levels=0, zero_planes=lambda k, z: z - 3,
                     jp2=True)
    assert any("U_q islarger" in m for m in _messages(data))
    assert _reads_everywhere(_write(tmp_path, "u", data)) == "none"
    _matches_openjpeg(data)


def test_vlc_significance_outside_the_block(tmp_path):
    """A 3 x 3 block whose last quad pair's VLC codeword makes a sample
    past the block significant: found by flipping VLC bits until OpenJPEG
    says so; the port refuses it as both readers do."""
    img = np.full((3, 3), 128, np.uint8)
    img[2, 2] = 200
    rnd = random.Random(14)
    found = 0
    for _ in range(300):
        def flip(key, d, s=rnd.randrange(1 << 30)):
            r = random.Random(s)
            d = bytearray(d)
            i = r.randrange(len(d) - ((d[-1] << 4) + (d[-2] & 0xF)),
                            len(d) - 1)
            d[i] ^= 1 << (r.randrange(4, 8) if i == len(d) - 2
                          else r.randrange(8))
            return bytes(d)
        data = ht.encode(img, levels=0, mutate=flip)
        if any("outside the codeblock" in m for m in _messages(data)):
            assert _reads_everywhere(_write(tmp_path, "v", data)) == "none"
            found += 1
            if found == 3:
                break
    assert found == 3


def test_mel_check_depends_on_the_blocks_address(tmp_path):
    """The MEL decoder checks only the bytes it reads one at a time up to a
    4-byte boundary of the block's address (in the tile's data, or its own
    buffer where a block comes in more than one piece): the same MEL bytes
    FF A5 are refused at some offsets and read at others, by OpenJPEG and
    by the port alike."""
    rng = np.random.default_rng(15)
    r = random.Random(15)
    seen = set()

    def mel(key, d):
        d = bytearray(d)
        s = len(d) - ((d[-1] << 4) + (d[-2] & 0xF))
        if s + 2 < len(d) - 1:
            d[s:s + 2] = b"\xff\xa5"
        return bytes(d)
    for k in range(40):
        img = rng.integers(0, 256, (r.randint(4, 16), r.randint(4, 16)),
                           dtype=np.uint8)
        data = ht.encode(img, levels=0, sop=r.random() < 0.5, mutate=mel,
                         cap=r.random() < 0.5)
        reader = _reads_everywhere(_write(tmp_path, f"m{k}", data))
        seen.add(reader)
        _matches_openjpeg(data)
    assert seen == {"pil", "none"}


@pytest.mark.parametrize("part", ["mel", "vlc", "magsgn"])
def test_stream_mutations_read_as_reference(tmp_path, part):
    """30 seeded files with random bytes in one stream of a code-block's
    cleanup segment (MEL's first bytes, VLC's last, anywhere in MagSgn),
    some with refinement passes: the port reads or refuses each as cv2 and
    PIL do, never naming JPEG 2000, with OpenJPEG's components."""
    seed = ("mel", "vlc", "magsgn").index(part)
    r, rng = random.Random(seed), np.random.default_rng(seed)
    for k in range(30):
        img = cases.smooth(rng, r.randint(4, 20), r.randint(4, 20), amp=40)

        def mutate(key, d, s=r.randrange(1 << 30)):
            rr = random.Random(s)
            d = bytearray(d)
            scup = (d[-1] << 4) + (d[-2] & 0xF)
            s0 = len(d) - scup
            lo, hi = {"magsgn": (0, s0), "mel": (s0, min(s0 + 4, len(d) - 2)),
                      "vlc": (max(s0, len(d) - 8), len(d) - 2)}[part]
            for _ in range(rr.randint(1, 3)):
                if hi > lo:
                    d[rr.randrange(lo, hi)] = rr.randrange(256)
            return bytes(d)
        refine = ht.random_refine((1, 2), (1, 8)) if k % 3 == 0 else None
        data = ht.encode(img, levels=r.choice((0, 1)), mutate=mutate,
                         plane=1 if refine else 0, refine=refine, rng=r,
                         jp2=True)
        reader = _reads_everywhere(_write(tmp_path, f"{part}{k}", data))
        assert reader != "named"
        if k % 5 == 0:
            _matches_openjpeg(data)


@pytest.mark.parametrize("seed", range(3))
def test_byte_mutations_read_as_reference(tmp_path, seed):
    """60 seeded byte mutations over the tile data of encoder-made files
    (packet headers and code-blocks alike): read as the reference reads
    them, never naming JPEG 2000."""
    r = random.Random(100 + seed)
    rng = np.random.default_rng(100 + seed)
    bases = [ht.encode(cases.smooth(rng, r.randint(6, 24), r.randint(6, 24),
                                    amp=30), levels=r.choice((0, 1, 2)),
                       cblk=r.choice(((64, 64), (8, 8), (4, 16))),
                       layers=r.choice((1, 2)), jp2=True) for _ in range(4)]
    for k in range(60):
        d = bytearray(r.choice(bases))
        sod = d.find(b"\xff\x93") + 2
        for _ in range(r.randint(1, 3)):
            i = r.randrange(sod, len(d) - 2)
            d[i] = r.choice([d[i] ^ (1 << r.randrange(8)), r.randrange(256),
                             0xFF, 0])
        assert _reads_everywhere(_write(tmp_path, f"b{k}", bytes(d))) != (
            "named")


# ------------------------------------------------------------ the tables

def test_tables_are_cv2s_and_pillows():
    """ht_tables.h holds the two 1024-entry tables the extraction script
    finds in Pillow's libopenjp2, and the same bytes stand in cv2's
    library (OpenJPEG 2.5.3 linked into it)."""
    t0, t1 = ht.vlc_tables()
    found = tables.find_tables(tables.pillow_libopenjp2().read_bytes())
    np.testing.assert_array_equal(found[0], t0)
    np.testing.assert_array_equal(found[1], t1)
    assert tables.header_text(t0, t1) == ht.HT_TABLES.read_text()
    lib = (Path(cv2.__file__).parent / "cv2.abi3.so").read_bytes()
    assert lib.find(t0.astype("<u2").tobytes()) >= 0
    assert lib.find(t1.astype("<u2").tobytes()) >= 0


def _quad_field(rng, h, w):
    """Coefficients quad by quad: a random significance pattern, a top
    exponent, each significant sample at it or under it."""
    qh, qw = h // 2, w // 2
    rho = rng.integers(0, 16, (qh, qw))
    top = rng.integers(1, 9, (qh, qw))
    out = np.zeros((h, w), np.int64)
    for k in range(4):
        e = np.where(rng.random((qh, qw)) < 0.6, top,
                     rng.integers(1, top + 1))
        lo = np.where(e > 1, (1 << np.maximum(e - 2, 0)) + 1, 1)
        hi = np.where(e > 1, 1 << np.maximum(e - 1, 0), 1)
        mu = rng.integers(lo, hi + 1)
        sign = np.where(rng.random((qh, qw)) < 0.5, -1, 1)
        out[k & 1::2, k >> 1::2] = ((rho >> k) & 1) * mu * sign
    return out


def test_every_codeword_is_written_into_a_file_cv2_decodes(tmp_path):
    """Every (context, codeword) of both tables (444 of the first row
    pair's, 358 of the others') is written by the encoder into some file
    of 12-bit coefficients (one level 0 resolution, so the pixels are the
    coefficients) that cv2 decodes to the encoder's input, and the port to
    cv2's pixels."""
    total = {(t, c, code, length)
             for t, tbl in enumerate(ht.codewords())
             for (c, _, _), v in tbl.items()
             for code, length, _, _ in v}
    assert len(total) == 802
    used = set()
    r, rng = random.Random(3), np.random.default_rng(3)
    for k in range(40):
        img = (_quad_field(rng, 16, 1024) + 2048).astype(np.uint16)
        data = ht.encode(img, levels=0, precision=12, cblk=(1024, 4), rng=r,
                         used=used)
        p = _write(tmp_path, f"cw{k}", data)
        back = cv2.imread(str(p), cv2.IMREAD_UNCHANGED)
        np.testing.assert_array_equal(back, img)
        if k % 4 == 0:
            _reads_as_reference(p)
        if used >= total:
            break
    assert used == total


# --------------------------------------------------------- the fixtures

@pytest.mark.parametrize("name", CASES + (BIG,))
def test_fixture_decodes_as_cv2(name):
    """Every j2k4_ fixture cv2 reads: decode equals expected.npz (cv2's
    pixels; the big file's digest), max diff 0; both probes give its
    (h, w); load_batch and load_canvas read it."""
    p = str(FIXTURES / name)
    img = native.decode(p)
    if name == BIG:
        assert img.shape == (480, 640, 3)
        assert hashlib.sha256(img.tobytes()).hexdigest() == (
            chip_smoke.JPEG2000_HT_DIGEST)
        want = img
    else:
        want = EXPECTED[f"decoded__{name}"]
        np.testing.assert_array_equal(img, want)
    for reader in ("cv2", "port"):
        assert native.probe([p], reader=reader).tolist() == [
            list(want.shape[:2])]
    assert native.load_batch([p], SIZE).shape == (1, SIZE, SIZE, 3)
    side = max(200, *want.shape[:2])
    canvas = np.zeros((1, side, side, 3), np.uint8)
    assert native.load_canvas([p], canvas).tolist() == [list(want.shape[:2])]
    np.testing.assert_array_equal(canvas[0, :want.shape[0], :want.shape[1]],
                                  want)


@pytest.mark.parametrize("name", SKIPS)
def test_skip_fixture_reads_as_reference(name):
    """Each skip/ file: the cv2 probe gives (0, 0); decode gives PIL's
    pixels where PIL reads it (signed samples, an image offset, a raw gray
    codestream), and otherwise raises "failed to decode", not naming JPEG
    2000 (RGN with HT, the mixed HT style, 4 passes, Scup 4080)."""
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
    """The committed files equal what make_fixtures writes here (the big
    one too), each reads as the reference reads it now (cv2 and PIL live),
    3 of the skip files PIL reads (chip_smoke.JPEG2000_HT_PIL_READS), the
    big file's cv2 pixels are chip_smoke.JPEG2000_HT_DIGEST, and the
    directory stays under 200 KiB."""
    fresh = make_fixtures.make(tmp_path)
    assert sorted(fresh) == sorted(EXPECTED.files)
    for key in EXPECTED.files:
        np.testing.assert_array_equal(fresh[key], EXPECTED[key], err_msg=key)
    for name in CASES + (BIG,):
        assert (FIXTURES / name).read_bytes() == (tmp_path / name).read_bytes()
        assert _reads_as_reference(FIXTURES / name) == "cv2"
    readers = []
    for name in SKIPS:
        p = FIXTURES / "skip" / name
        assert p.read_bytes() == (tmp_path / "skip" / name).read_bytes()
        readers.append(_reads_as_reference(p))
    assert readers.count("pil") == len(PIL_SKIPS) == (
        chip_smoke.JPEG2000_HT_PIL_READS)
    big = cv2.imread(str(FIXTURES / BIG))[:, :, ::-1].copy()
    assert hashlib.sha256(big.tobytes()).hexdigest() == (
        chip_smoke.JPEG2000_HT_DIGEST)
    assert np.sqrt(np.mean((big.astype(float) - chip_smoke.j2k_source())
                           ** 2)) < 3
    assert int(EXPECTED["generate_tree_written"]) == len(CASES) + 1
    assert sum(p.stat().st_size for p in FIXTURES.rglob("*")
               if p.is_file()) < 200 * 1024


def test_fixtures_are_what_they_name():
    """The fixtures are HTJ2K where they say so (COD's style bit 6 and a
    CAP marker), the CAP and CPF file a part 1 file, and the skip files
    carry the feature both readers refuse."""
    for name in CASES + (BIG,) + tuple(f"skip/{n}" for n in SKIPS):
        data = (FIXTURES / name).read_bytes()
        markers = {m for _, m, _ in cases.main_markers(data)}
        style = cases.cod_fields(data)[7]
        if "cap_cpf_part1" in name:
            assert style & 0x40 == 0 and {0xFF50, 0xFF59} <= markers
        else:
            assert style & 0x40 and 0xFF50 in markers, name
    assert 0xFF5E in {m for _, m, _ in cases.main_markers(
        (FIXTURES / "skip" / "j2k4_rgn.png").read_bytes())}
    assert cases.cod_fields((FIXTURES / "skip" / "j2k4_mixed_style.png")
                            .read_bytes())[7] & 0x80


def test_fixture_brings_a_bucket_of_its_own():
    """The 150 x 12 fixture lies in generate_tree buckets (for blur,
    compound and blur_rand) no fixture of the other image directories
    brings, so that phase 13 holds B2 and B3 there."""
    others = []
    for d in ("images", "webp", "webp_lossy", "jpeg2000", "jpeg2000_colour"):
        root = HERE / "data" / d
        others += [str(p) for p in root.iterdir()
                   if p.suffix in chip_smoke.IMAGE_SUFFIXES]
    sides = [tuple(s) for s in native.probe(others, reader="cv2").tolist()
             if s[0] > 0]
    mine = native.probe([str(FIXTURES / "j2k4_150x12_97.jpg")],
                        reader="cv2").tolist()
    assert mine == [[150, 12]]
    for kind in ("blur", "compound", "blur_rand"):
        halo = offline.HALO[kind]
        bucket = (offline._bucket_with_room(150, halo),
                  offline._bucket_with_room(12, halo))
        assert bucket not in {(offline._bucket_with_room(h, halo),
                               offline._bucket_with_room(w, halo))
                              for h, w in sides}


# ----------------------------------------------------------- the paths

def test_generate_tree_writes_what_the_reference_writes(tmp_path):
    """generate_tree (blur) through both packages on a tree of the
    encoder's files, the rule files, the committed fixtures and their
    skip files: the same files written (those cv2 reads) and skipped; the
    decoded pixels the reference's exactly, the blurred files within 2 LSB
    of the reference's."""
    src = tmp_path / "src"
    files = [(f"{n}.png", d) for n, (d, _, _) in _built().items()]
    files += [(f"rule_{n}.png", d) for n, (d, _, _) in RULES.items()]
    files += [(p.name, p.read_bytes()) for p in FIXTURES.glob("j2k4_*")]
    files += [(p.name, p.read_bytes())
              for p in (FIXTURES / "skip").glob("j2k4_*")]
    for k, (name, data) in enumerate(files):
        out = src / f"c{k % 3}" / name
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_bytes(data)
    readable = [p for p in src.glob("*/*") if cv2.imread(str(p)) is not None]
    for p in readable:
        np.testing.assert_array_equal(native.decode(str(p)),
                                      cv2.imread(str(p))[:, :, ::-1])
    lines = []
    n = offline.generate_tree(str(src), str(tmp_path / "ours"), "blur",
                              log=lines.append, device="cpu")
    m = joffline.generate_tree(str(src), str(tmp_path / "ref"), "blur",
                               log=quiet)
    assert n == m == len(readable) and n > 50
    assert f"Skipped {len(files) - n} unreadable files" in lines
    ref = sorted(str(p.relative_to(tmp_path / "ref"))
                 for p in (tmp_path / "ref").glob("*/*"))
    assert sorted(str(p.relative_to(tmp_path / "ours"))
                  for p in (tmp_path / "ours").glob("*/*")) == ref
    for k in ref:
        a = cv2.imread(str(tmp_path / "ours" / k)).astype(int)
        b = cv2.imread(str(tmp_path / "ref" / k)).astype(int)
        assert np.abs(a - b).max() <= 2, k
    assert all(_reference(p)[0] != "raise" for p in src.glob("*/*"))
