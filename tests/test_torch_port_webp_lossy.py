"""WebP part 2, lossy VP8 with its ALPH chunk, read by the port as the
reference reads it (cv2.imread, else PIL's convert("RGB"), else refused as
both refuse), max diff 0:

- the fixtures of tests/data/webp_lossy (make_fixtures.py): cv2's and
  Pillow's lossy writers at odd sizes (1 x 1, 1 x N, N x 1) and qualities
  5-100, libwebp's encoder (through ctypes) with 1-4 segments, simple and
  normal filters, sharpness 0-7, filter strength 0, 1-8 token
  partitions, RGBA with ALPH methods 0 and 1, filters 0-3 and
  pre-processing, an animation's lossy first frame at an offset, EXIF
  orientations 2-8, trailing bytes, a raw VP8 stream cv2 reads, the VP8
  writer's frames (loop-filter deltas, profile 3, the colour-space,
  clamping and scale bits, a segment map without segment data), and the
  640 x 480 file phase 13 of chip_smoke.py times (its digest); under
  skip/ the files cv2 refuses: the ALPH damage PIL reads past (its demux
  drops the chunk where the VP8X has no alpha flag) and the frames both
  refuse: decode raises "failed to decode", never naming WebP, the cv2
  probe gives (0, 0), load_batch raises;
- the VP8 core held to libwebp itself (Pillow's bundled libwebp through
  ctypes): the Y, U and V planes against WebPDecodeYUV, the loop filter
  and the upsampler against WebPDecode with bypass_filtering or
  no_fancy_upsampling set;
- the VP8 writer's features one by one, at odd sizes;
- every cut point of three fixtures, every cut of two ALPH streams (the
  VP8L end-of-stream rule of each of libwebp's alpha paths) and 1,000
  seeded bit flips;
- cv2's raw-VP8 rule (32 bytes whose first partition ends inside them);
- data.gtsrb._decode_resize, ImageFolder and generate_tree against
  tsr_tpu's on a tree of lossy files.
"""

import ctypes
import hashlib
import importlib.util
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
from test_torch_port_webp import _reads_as_reference

torch.set_num_threads(2)
HERE = Path(__file__).resolve().parent
FIXTURES = HERE / "data" / "webp_lossy"
_spec = importlib.util.spec_from_file_location(
    "webp_lossy_fixtures", FIXTURES / "make_fixtures.py")
make_fixtures = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(make_fixtures)
cases = make_fixtures.image_cases
chip_smoke = cases.chip_smoke
EXPECTED = np.load(FIXTURES / "expected.npz")
CASES, SKIPS = make_fixtures.names()
BIG = make_fixtures.BIG
SIZE = 32
quiet = lambda s: None  # noqa: E731
riff = chip_smoke.webp_riff


# ------------------------------------------------------ libwebp, by ctypes

class _Features(ctypes.Structure):
    _fields_ = [("width", ctypes.c_int), ("height", ctypes.c_int),
                ("has_alpha", ctypes.c_int), ("has_animation", ctypes.c_int),
                ("format", ctypes.c_int), ("pad", ctypes.c_uint32 * 5)]


class _Rgba(ctypes.Structure):
    _fields_ = [("rgba", ctypes.POINTER(ctypes.c_uint8)),
                ("stride", ctypes.c_int), ("size", ctypes.c_size_t)]


class _Yuva(ctypes.Structure):
    _fields_ = [(n, ctypes.c_void_p) for n in "yuva"] + [
        (n, ctypes.c_int) for n in ("y_stride", "u_stride", "v_stride",
                                    "a_stride")] + [
        (n, ctypes.c_size_t) for n in ("y_size", "u_size", "v_size",
                                       "a_size")]


class _Union(ctypes.Union):
    _fields_ = [("RGBA", _Rgba), ("YUVA", _Yuva)]


class _DecBuffer(ctypes.Structure):
    _fields_ = [("colorspace", ctypes.c_int), ("width", ctypes.c_int),
                ("height", ctypes.c_int), ("is_external_memory", ctypes.c_int),
                ("u", _Union), ("pad", ctypes.c_uint32 * 4),
                ("private_memory", ctypes.c_void_p)]


class _Options(ctypes.Structure):
    _fields_ = [(n, ctypes.c_int) for n in (
        "bypass_filtering no_fancy_upsampling use_cropping crop_left crop_top "
        "crop_width crop_height use_scaling scaled_width scaled_height "
        "use_threads dithering_strength flip alpha_dithering_strength"
    ).split()] + [("pad", ctypes.c_uint32 * 5)]


class _DecoderConfig(ctypes.Structure):
    _fields_ = [("input", _Features), ("output", _DecBuffer),
                ("options", _Options)]


LIBWEBP = cases._libwebp()
LIBWEBP.WebPDecodeYUV.restype = ctypes.POINTER(ctypes.c_uint8)
LIBWEBP.WebPDecodeYUV.argtypes = [
    ctypes.c_char_p, ctypes.c_size_t, ctypes.POINTER(ctypes.c_int),
    ctypes.POINTER(ctypes.c_int),
    ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
    ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
    ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
LIBWEBP.WebPFree.argtypes = [ctypes.c_void_p]
DECODER_ABI = 0x0209  # any 2.x: libwebp checks the major version alone


def libwebp_yuv(data):
    """WebPDecodeYUV's Y, U and V planes (cropped), or None."""
    w, h, ys, uvs = (ctypes.c_int() for _ in range(4))
    u, v = ctypes.POINTER(ctypes.c_uint8)(), ctypes.POINTER(ctypes.c_uint8)()
    y = LIBWEBP.WebPDecodeYUV(data, len(data), ctypes.byref(w),
                              ctypes.byref(h), ctypes.byref(u),
                              ctypes.byref(v), ctypes.byref(ys),
                              ctypes.byref(uvs))
    if not y:
        return None
    uw, uh = (w.value + 1) // 2, (h.value + 1) // 2

    def plane(p, rows, cols, stride):
        a = np.ctypeslib.as_array(p, ((rows - 1) * stride + cols,))
        return np.stack([a[r * stride:r * stride + cols] for r in range(rows)])
    out = (plane(y, h.value, w.value, ys.value), plane(u, uh, uw, uvs.value),
           plane(v, uh, uw, uvs.value))
    LIBWEBP.WebPFree(y)
    return out


def libwebp_rgb(data, bypass_filtering=0, no_fancy_upsampling=0):
    """WebPDecode to RGB with the options given, or None."""
    cfg = _DecoderConfig()
    assert LIBWEBP.WebPInitDecoderConfigInternal(ctypes.byref(cfg),
                                                 DECODER_ABI)
    cfg.options.bypass_filtering = bypass_filtering
    cfg.options.no_fancy_upsampling = no_fancy_upsampling
    cfg.output.colorspace = 0  # MODE_RGB
    if LIBWEBP.WebPDecode(data, len(data), ctypes.byref(cfg)) != 0:
        return None
    b = cfg.output
    rgba = b.u.RGBA
    a = np.ctypeslib.as_array(rgba.rgba, (rgba.size,))
    out = np.stack([a[r * rgba.stride:r * rgba.stride + 3 * b.width]
                    for r in range(b.height)]).reshape(b.height, b.width, 3)
    LIBWEBP.WebPFreeDecBuffer(ctypes.byref(cfg.output))
    return out


def port_planes(data, flags):
    """The port's decode of a lossy still image step by step
    (tsrio_webp_lossy_planes): flags 1 the loop filter, 2 RGB, 4 the fancy
    upsampler; the planes (Y, U, V) or the RGB image, or None."""
    cap = 4 * len(data) * 64 + (1 << 16)
    buf = np.zeros(cap, np.uint8)
    dims = (ctypes.c_int * 2)()
    ok = native._lib().tsrio_webp_lossy_planes(
        data, len(data), flags, buf.ctypes.data_as(
            ctypes.POINTER(ctypes.c_uint8)), cap, dims)
    if not ok:
        return None
    h, w = dims[0], dims[1]
    if flags & 2:
        return buf[:h * w * 3].reshape(h, w, 3)
    uw, uh = (w + 1) // 2, (h + 1) // 2
    return (buf[:h * w].reshape(h, w),
            buf[h * w:h * w + uw * uh].reshape(uh, uw),
            buf[h * w + uw * uh:h * w + 2 * uw * uh].reshape(uh, uw))


# ----------------------------------------------------------- the readers

def _write_reads_as_reference(tmp_path, data, name="f.png"):
    p = tmp_path / name
    p.write_bytes(data)
    return _reads_as_reference(p)


# --------------------------------------------------------- the fixtures

@pytest.mark.parametrize("name", CASES + (BIG,))
def test_fixture_decodes_as_cv2(name):
    """Every lossy fixture cv2 reads: decode equals expected.npz (cv2's
    pixels; the big file its digest), max diff 0; both probes give its
    (h, w); load_batch and load_canvas read it."""
    p = str(FIXTURES / name)
    img = native.decode(p)
    if name == BIG:
        assert img.shape[:2] == chip_smoke.WEBP_LOSSY_BIG_SIZE
        assert hashlib.sha256(img.tobytes()).hexdigest() == (
            chip_smoke.WEBP_LOSSY_BIG_DIGEST)
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
    decode gives PIL's pixels where PIL reads it (the ALPH damage its
    demux drops) and otherwise raises "failed to decode" (not naming
    WebP), load_batch "decoded 0/1"."""
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
        f"webp_lossy_alpha_{k}_no_flag.png"
        for k in ("reserved", "method_3", "preprocessing_2"))
    img, data = make_fixtures.build_big()
    assert (FIXTURES / BIG).read_bytes() == data
    ref = cv2.imread(str(FIXTURES / BIG))[:, :, ::-1].copy()
    assert hashlib.sha256(ref.tobytes()).hexdigest() == (
        chip_smoke.WEBP_LOSSY_BIG_DIGEST)
    assert np.abs(ref.astype(int) - img).mean() < 6  # lossy, near its source
    assert int(EXPECTED["generate_tree_written"]) == len(CASES) + 1
    assert sum(p.stat().st_size for p in FIXTURES.rglob("*")
               if p.is_file()) < 200 * 1024


def _chunks(name):
    return dict(cases.webp_chunks((FIXTURES / name).read_bytes()))


def _frame_tag(vp8):
    tag = int.from_bytes(vp8[:3], "little")
    return {"profile": (tag >> 1) & 7, "partition": tag >> 5,
            "w": int.from_bytes(vp8[6:8], "little") & 0x3fff,
            "h": int.from_bytes(vp8[8:10], "little") & 0x3fff,
            "scale": (vp8[7] >> 6, vp8[9] >> 6)}


def test_fixtures_hold_what_they_name():
    """The fixtures differ where their names say: cv2 rotates by the EXIF
    orientation and PIL does not, the ALPH files carry the header bits
    their names give (each of the four filters, methods 0 and 1,
    pre-processing), the file without the alpha flag keeps its ALPH chunk,
    the animation's canvas is zero around its first frame, the raw stream
    has no RIFF, the writer's frames carry profile 3, the scale bits, 8
    partitions, and the token partitions libwebp's encoder was asked
    for."""
    for o in range(2, 9):
        p = FIXTURES / f"webp_lossy_exif_{o}.png"
        pil = np.asarray(Image.open(p).convert("RGB"))
        got = EXPECTED[f"decoded__{p.name}"]
        assert got.shape[:2] == (pil.shape[:2][::-1] if o >= 5
                                 else pil.shape[:2])
        if o < 5:
            assert not np.array_equal(got, pil)
    for f in range(4):
        head = _chunks(f"webp_lossy_alpha_filter_{f}.png")[b"ALPH"][0]
        assert (head >> 2) & 3 == f
    assert _chunks("webp_lossy_alpha_raw.png")[b"ALPH"][0] & 3 == 0
    assert _chunks("webp_lossy_alpha_lossless.png")[b"ALPH"][0] & 3 == 1
    assert _chunks("webp_lossy_alpha_levels.png")[b"ALPH"][0] >> 4 == 1
    no_flag = _chunks("webp_lossy_alpha_no_flag.png")
    assert no_flag[b"VP8X"][0] & 0x10 == 0 and b"ALPH" in no_flag
    anim = EXPECTED["decoded__webp_lossy_anim_offset.png"]
    assert anim.shape == (30, 40, 3)
    rest = anim.copy()
    rest[4:24, 6:32] = 0
    assert anim[4:24, 6:32].max() > 0 and rest.max() == 0
    raw = (FIXTURES / "webp_lossy_raw_vp8.png").read_bytes()
    assert raw[3:6] == b"\x9d\x01\x2a" and _frame_tag(raw)["partition"] < 32
    assert _frame_tag(_chunks("webp_lossy_writer_profile_3.png")[
        b"VP8 "])["profile"] == 3
    bits = _frame_tag(_chunks("webp_lossy_writer_header_bits.png")[b"VP8 "])
    assert bits["scale"] == (2, 3) and bits["profile"] == 1
    for name, parts in (("enc_partitions_2", 2), ("enc_partitions_4", 4),
                        ("enc_partitions_8", 8), ("writer_partitions_8", 8),
                        ("enc_segments_1", 1)):
        vp8 = _chunks(f"webp_lossy_{name}.png")[b"VP8 "]
        assert _partitions(vp8) == parts, name


def _partitions(vp8):
    """The token partitions a VP8 frame declares (its first partition
    decoded up to the count by a boolean decoder in Python)."""
    first = vp8[10:10 + _frame_tag(vp8)["partition"]]
    value, bits, rng, pos = 0, 0, 255, 0

    def bit(prob):
        nonlocal value, bits, rng, pos
        split = 1 + (((rng - 1) * prob) >> 8)
        while bits < 8:
            value = (value << 8) | (first[pos] if pos < len(first) else 0)
            pos += 1
            bits += 8
        big = split << (bits - 8)
        if value >= big:
            rng -= split
            value -= big
            b = 1
        else:
            rng = split
            b = 0
        while rng < 128:
            rng <<= 1
            bits -= 1
        return b

    def val(n):
        return sum(bit(128) << k for k in range(n - 1, -1, -1))
    val(2)  # colour space, clamping
    if bit(128):  # segmentation
        update_map, update_data = bit(128), bit(128)
        if update_data:
            bit(128)
            for n in (7,) * 4 + (6,) * 4:
                if bit(128):
                    val(n + 1)
        if update_map:
            for _ in range(3):
                if bit(128):
                    val(8)
    val(10)  # filter type, level, sharpness
    if bit(128) and bit(128):
        for _ in range(8):
            if bit(128):
                val(7)
    return 1 << val(2)


# -------------------------------------------------- the core, by libwebp

STILLS = [n for n in CASES if not n.startswith(("webp_lossy_anim",
                                                "webp_lossy_exif"))]


@pytest.mark.parametrize("name", STILLS + [BIG])
def test_planes_and_steps_equal_libwebp(name):
    """The port's Y, U and V planes equal WebPDecodeYUV's; its RGB without
    the loop filter WebPDecode's with bypass_filtering, its point-sampled
    RGB WebPDecode's with no_fancy_upsampling, and its full decode
    WebPDecode's (each max diff 0)."""
    data = (FIXTURES / name).read_bytes()
    want = libwebp_yuv(data)
    got = port_planes(data, 1)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    for flags, kw in ((2 | 4, {"bypass_filtering": 1}),
                      (1 | 2, {"no_fancy_upsampling": 1}),
                      (1 | 2 | 4, {})):
        np.testing.assert_array_equal(port_planes(data, flags),
                                      libwebp_rgb(data, **kw), err_msg=kw)


def test_unfiltered_planes_differ_where_filtered():
    """The loop filter changes the frames it runs on (so the bypass
    comparison above holds it): a fixture with a normal and one with a
    simple filter decode differently without it, the one filtered at
    level 0 does not."""
    for name, changes in (("webp_lossy_enc_normal_sharp_5.png", True),
                          ("webp_lossy_enc_simple_filter.png", True),
                          ("webp_lossy_enc_filter_off.png", False)):
        data = (FIXTURES / name).read_bytes()
        a, b = port_planes(data, 2 | 4), port_planes(data, 1 | 2 | 4)
        assert (not np.array_equal(a, b)) == changes, name


# ------------------------------------------------ the VP8 writer, by case

WRITER = [
    ("plain", {}), ("simple_filter", {"simple": True, "level": 40}),
    ("no_filter", {"level": 0}),
    ("sharpness", {"level": 63, "sharpness": 7}),
    ("ref_delta", {"lf_delta": ((10, 0, 0, 0), (0, 0, 0, 0))}),
    ("mode_delta", {"lf_delta": ((0, 0, 0, 0), (-15, 0, 0, 0)),
                    "level": 12}),
    ("deltas_past_63", {"lf_delta": ((40, 1, 2, 3), (40, -1, -2, -3)),
                        "level": 50}),
    ("deltas_below_0", {"lf_delta": ((-40, 0, 0, 0), (20, 0, 0, 0)),
                        "level": 8}),
    ("profile_1", {"profile": 1}), ("profile_2", {"profile": 2}),
    ("profile_3", {"profile": 3}),
    ("colour_space_clamp", {"colorspace": 1, "clamp": 1}),
    ("scale", {"scale": (3, 1)}),
    ("map_only", {"segments": {"update_map": True,
                               "probs": (40, 200, 255)}, "seg": 4}),
    ("no_map_data", {"segments": {"update_map": False, "data": (
        True, (10, 50, 90, 127), (0, 20, 40, 63))}}),
    ("delta_data", {"segments": {"update_map": True, "probs": (128, 64, 32),
                                 "data": (False, (-20, 0, 20, 40),
                                          (-10, 0, 10, 30))},
                    "seg": 4, "level": 20}),
    ("segment_filter_no_global", {"segments": {
        "update_map": True, "data": (True, (40, 40, 40, 40),
                                     (30, 30, 30, 30))},
        "seg": 4, "level": 0}),
    ("partitions_2", {"partitions": 1}), ("partitions_4", {"partitions": 2}),
    ("partitions_8", {"partitions": 3}),
    ("skip_flags", {"skip_prob": 60, "skip": 0.5}),
    ("all_4x4", {"i4": 1.0}), ("all_16x16", {"i4": 0.0}),
    ("big_levels", {"amp": 400, "q": (127, 15, 15, 15, 15, 15)}),
    ("quant_0", {"q": (0, -15, -15, -15, -15, -15)}),
]


@pytest.mark.parametrize("name,kw", WRITER, ids=[n for n, _ in WRITER])
@pytest.mark.parametrize("w,h", [(1, 1), (19, 9), (40, 35)])
def test_writer_frame_reads_as_reference(tmp_path, name, kw, w, h):
    """Each VP8 writer feature (what libwebp's encoder never writes among
    them) at odd sizes: the port reads the frame as cv2 does, its planes
    equal WebPDecodeYUV's."""
    kw = dict(kw)
    seg, skip = kw.pop("seg", 1), kw.pop("skip", 0.0)
    i4, amp = kw.pop("i4", 0.5), kw.pop("amp", 3)
    rng = np.random.default_rng(zlib.crc32(f"{name} {w} {h}".encode()))
    mbs = cases.vp8_random_mbs(rng, w, h, i4_share=i4, segments=seg,
                               skip_share=skip, amp=amp)
    data = riff([(b"VP8 ", cases.vp8_bytes(w, h, mbs, **kw))])
    assert _write_reads_as_reference(tmp_path, data) == "cv2"
    for a, b in zip(port_planes(data, 1), libwebp_yuv(data)):
        np.testing.assert_array_equal(a, b)


def test_writer_refusals(tmp_path):
    """What the writer makes that the readers refuse: an empty last
    partition (for every partition count; where the chunk is odd, cv2's
    whole-file decode takes its pad byte as the partition's data, which
    reads where no row uses that partition, so the pad byte is also left
    out), a profile past 3 (the header bits of the frame tag), a hidden
    frame."""
    rng = np.random.default_rng(71)
    mbs = cases.vp8_random_mbs(rng, 40, 35)
    for parts in (1, 2, 3):
        body = cases.vp8_bytes(40, 35, mbs, partitions=parts, empty_last=True)
        data = riff([(b"VP8 ", body)])
        if len(body) % 2:
            _write_reads_as_reference(tmp_path, data)
            data = cases.with_riff_size(data[:-1], -1)
        assert _write_reads_as_reference(tmp_path, data) == "none", parts
    body = cases.vp8_bytes(40, 35, mbs)
    tag = int.from_bytes(body[:3], "little")
    for new in [(tag & ~14) | (p << 1) for p in range(4, 8)] + [tag & ~16]:
        data = riff([(b"VP8 ", new.to_bytes(3, "little") + body[3:])])
        assert _write_reads_as_reference(tmp_path, data) == "none", new


# ---------------------------------------------------------- containers

def test_lossy_first_frames_and_alpha_rules(tmp_path):
    """The container's rules for a lossy image: a still VP8X with and
    without the alpha flag (cv2 decodes the ALPH chunk either way, PIL
    only with it), ALPH inside ANMF (honoured without the flag), the last
    of two ALPH chunks, an empty or one-byte ALPH chunk, a raw plane one
    byte short or exact, an animation whose first frame is lossy and its
    second lossless and the reverse."""
    rng = np.random.default_rng(72)
    rgba = np.concatenate([cases.grain(rng, 12, 18), rng.integers(
        0, 256, (12, 18, 1)).astype(np.uint8)], 2)
    ch = dict(cases.webp_chunks(cases.libwebp_encode(rgba, 60)))
    vp8, alph = ch[b"VP8 "], ch[b"ALPH"]
    bad = b"\xc0" + alph[1:]
    lossless = chip_smoke.vp8l_bytes(rgba[..., :3])
    files = {}
    for flag in (0, 0x10):
        for name, a in (("good", alph), ("bad", bad), ("empty", b""),
                        ("one", b"\x00"), ("short", b"\x00" + bytes(215)),
                        ("exact", b"\x00" + bytes(216))):
            files[f"{name}_{flag}"] = riff([cases.vp8x(18, 12, flag),
                                            (b"ALPH", a), (b"VP8 ", vp8)])
        files[f"two_{flag}"] = riff([cases.vp8x(18, 12, flag),
                                     (b"ALPH", bad), (b"ALPH", alph),
                                     (b"VP8 ", vp8)])
    files["anmf_no_flag"] = riff([
        cases.vp8x(20, 14, 0x02), (b"ANIM", bytes(6)),
        cases.anmf(2, 2, 18, 12, [(b"ALPH", alph), (b"VP8 ", vp8)])])
    files["anmf_bad_alpha"] = riff([
        cases.vp8x(20, 14, 0x02), (b"ANIM", bytes(6)),
        cases.anmf(2, 2, 18, 12, [(b"ALPH", bad), (b"VP8 ", vp8)])])
    files["lossy_then_lossless"] = riff([
        cases.vp8x(18, 12, 0x02), (b"ANIM", bytes(6)),
        cases.anmf(0, 0, 18, 12, [(b"VP8 ", vp8)]),
        cases.anmf(0, 0, 18, 12, [(b"VP8L", lossless)])])
    files["lossless_then_lossy"] = riff([
        cases.vp8x(18, 12, 0x02), (b"ANIM", bytes(6)),
        cases.anmf(0, 0, 18, 12, [(b"VP8L", lossless)]),
        cases.anmf(0, 0, 18, 12, [(b"VP8 ", vp8)])])
    readers = {k: _write_reads_as_reference(tmp_path, d)
               for k, d in files.items()}
    assert readers == {
        "good_0": "cv2", "bad_0": "pil", "empty_0": "pil", "one_0": "pil",
        "short_0": "pil", "exact_0": "cv2", "two_0": "cv2",
        "good_16": "cv2", "bad_16": "none", "empty_16": "none",
        "one_16": "none", "short_16": "none", "exact_16": "cv2",
        "two_16": "cv2", "anmf_no_flag": "cv2", "anmf_bad_alpha": "none",
        "lossy_then_lossless": "cv2", "lossless_then_lossy": "cv2"}


def test_raw_vp8_stream_rule(tmp_path):
    """cv2 reads a raw VP8 stream (no RIFF) of 32 bytes or more whose first
    partition ends inside the first 32 (its signature check hands
    WebPGetFeatures 32 bytes), equal to its RIFF twin; not one whose first
    partition is 32 bytes or more, nor one under 32 bytes; PIL reads
    none. The header probe follows cv2."""
    rng = np.random.default_rng(73)
    got = {}
    for name, img in (("flat_16", np.full((16, 16, 3), 50, np.uint8)),
                      ("flat_64", np.full((64, 64, 3), 200, np.uint8)),
                      ("flat_200", np.full((200, 300, 3), 10, np.uint8)),
                      ("grain_64", cases.grain(rng, 64, 64))):
        vp8 = cases.vp8_payload(cases.libwebp_encode(img, 75))
        partition = int.from_bytes(vp8[:3], "little") >> 5
        got[name] = (_write_reads_as_reference(tmp_path, vp8),
                     partition < 32 <= len(vp8))
        if got[name][0] == "cv2":
            twin = tmp_path / "twin.png"
            twin.write_bytes(riff([(b"VP8 ", vp8)]))
            np.testing.assert_array_equal(native.decode(str(tmp_path / "f.png")),
                                          native.decode(str(twin)))
    assert all((reader == "cv2") == rule for reader, rule in got.values())
    assert {reader for reader, _ in got.values()} == {"cv2", "none"}


def test_lossy_trailing_and_riff_sizes(tmp_path):
    """A still image's last token partition runs on past its chunk in cv2's
    whole-file decode (trailing bytes, a RIFF size short of the file) and
    stops at the chunk in PIL's frame decode: each file read as the
    reference reads it."""
    rng = np.random.default_rng(74)
    f = cases.webp_lossy_cv2(cases.grain(rng, 20, 30), 50)
    body = cases.vp8_payload(f)
    cut = riff([(b"VP8 ", body[:-6])])
    files = [f + bytes(k) for k in (1, 2, 7)] + [
        cut, cut + body[-6:], cases.with_riff_size(f, -4),
        cases.with_riff_size(f, 8)]
    for data in files:
        _write_reads_as_reference(tmp_path, data)


# ---------------------------------------------------------------- damage

CUT_FIXTURES = ("webp_lossy_exif_6.png", "webp_lossy_alpha_lossless.png",
                "webp_lossy_writer_partitions_8.png")
CUT_BLOCK = 160


def _cut_cases():
    out = []
    for name in CUT_FIXTURES:
        n = (FIXTURES / name).stat().st_size
        out += [(name, lo) for lo in range(0, n, CUT_BLOCK)]
    return out


@pytest.mark.parametrize("name,lo", _cut_cases())
def test_cut_points_read_as_reference(tmp_path, name, lo):
    """Every cut point of three fixtures (a still VP8X with EXIF, an RGBA
    file with a VP8L ALPH chunk, the writer's 8 partitions), CUT_BLOCK a
    case: the port reads or refuses exactly where the reference does."""
    data = (FIXTURES / name).read_bytes()
    p = tmp_path / "cut.png"
    for cut in range(lo, min(lo + CUT_BLOCK, len(data))):
        p.write_bytes(data[:cut])
        _reads_as_reference(p)


@pytest.mark.parametrize("palette", [True, False])
def test_alpha_stream_cut_points(tmp_path, palette):
    """Every cut of a VP8L ALPH stream (colour indexing alone: libwebp's
    8-bit path, which forgives a read past the data at the last pixel; a
    plain stream: its 32-bit path, which does not), with and without the
    VP8X alpha flag: the port reads or refuses where the reference
    does."""
    rng = np.random.default_rng(75)
    rgb = cases.grain(rng, 10, 14)
    a = (rng.integers(0, 3, (10, 14)) * 120).astype(np.uint8)
    green = np.stack([np.zeros_like(a), a, np.zeros_like(a)], -1)
    stream = chip_smoke.vp8l_bytes(
        green, [("palette",)] if palette else [])[5:]
    vp8 = cases.vp8_payload(cases.libwebp_encode(rgb, 60))
    seen = set()
    for cut in range(1, len(stream) + 1):
        for flag in (0x10, 0):
            data = riff([cases.vp8x(14, 10, flag), (b"ALPH", b"\x01"
                                                    + stream[:cut]),
                         (b"VP8 ", vp8)])
            seen.add(_write_reads_as_reference(tmp_path, data))
    assert seen == {"cv2", "pil", "none"}


FLIP_SOURCES = [n for n in CASES if (FIXTURES / n).stat().st_size < 1500]


@pytest.mark.parametrize("seed", range(8))
def test_bit_flips_read_as_reference(tmp_path, seed):
    """125 seeded flips of one or two bits a seed over the smaller
    fixtures cv2 reads (1,000 in all; ALPH chunks, token partitions and
    headers among them): the port reads or refuses exactly where the
    reference does, with its pixels."""
    rng = np.random.default_rng(5000 + seed)
    p = tmp_path / "flip.png"
    for _ in range(125):
        src = FIXTURES / FLIP_SOURCES[int(rng.integers(len(FLIP_SOURCES)))]
        data = bytearray(src.read_bytes())
        for _ in range(int(rng.integers(1, 3))):
            i = int(rng.integers(12, len(data)))
            data[i] ^= 1 << int(rng.integers(8))
        p.write_bytes(bytes(data))
        _reads_as_reference(p)


# ----------------------------------------------------------- the paths

def _tree(root):
    """Every lossy case, the big file and every skip case in a three-class
    tree."""
    files = ([FIXTURES / n for n in CASES + (BIG,)]
             + [FIXTURES / "skip" / n for n in SKIPS])
    for k, p in enumerate(files):
        out = root / f"c{k % 3}" / p.name
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_bytes(p.read_bytes())
    return root


def test_generate_tree_writes_what_the_reference_writes(tmp_path):
    """generate_tree("noise") through both packages on the tree of every
    lossy fixture: the same count (the files cv2 reads) and file names, the
    rest logged as skipped."""
    src = _tree(tmp_path / "src")
    lines = []
    n = offline.generate_tree(str(src), str(tmp_path / "ours"), "noise",
                              log=lines.append, device="cpu")
    m = joffline.generate_tree(str(src), str(tmp_path / "ref"), "noise",
                               log=quiet)
    want = int(EXPECTED["generate_tree_written"])
    assert n == m == want
    assert f"Skipped {len(CASES) + 1 + len(SKIPS) - want} unreadable " \
        "files" in lines
    ours = sorted(str(p.relative_to(tmp_path / "ours"))
                  for p in (tmp_path / "ours").glob("*/*"))
    ref = sorted(str(p.relative_to(tmp_path / "ref"))
                 for p in (tmp_path / "ref").glob("*/*"))
    assert ours == ref and len(ours) == want


READABLE = [FIXTURES / n for n in CASES + (BIG,)] + [
    FIXTURES / "skip" / k.split("__", 1)[1] for k in EXPECTED.files
    if k.startswith("decoded_skip__")]


@pytest.mark.parametrize("resize", ["cv2", "pil"])
def test_decode_resize_and_image_folder_match_reference(tmp_path, resize):
    """gtsrb._decode_resize at SIZE within 1 LSB of tsr_tpu's (cv2.imread,
    else PIL, then its resize) on every readable lossy fixture, and the
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
    image loaded alone (the batch path reads lossy WebP as decode does)."""
    paths = [str(p) for p in READABLE]
    batch = native.load_batch(paths, SIZE, threads=4)
    for p, got in zip(paths, batch):
        np.testing.assert_array_equal(got, native.load_batch([p], SIZE)[0])
