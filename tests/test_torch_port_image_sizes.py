"""cv2's image-size rules (faults C9 and C10), against cv2, PIL and tsr_tpu
on the CPU:

- C10: imread's validateInputImageSize (each side 1 to 2^20, at most 2^30
  pixels) runs once the format's own header parser has accepted the
  numbers, and past it cv2.imread raises instead of giving None. Header-only
  files of every format the port reads, at sizes on both sides of each
  limit (libpng's 1,000,000 a side, libjpeg's 65,500, the 2^20 side, the
  2^30 area), hold cv2's raise / None / read against the port's
  probe(reader="cv2", raises=True); the reader paths raise where cv2
  raises, and the port's generate_tree raises a RuntimeError naming the
  file, where the reference's raises a cv2.error, before it writes
  anything;
- C9: no 64 Mpx cap: an 8200 x 8200 PNG (written into tmp_path) probes,
  decodes equal to cv2.imread (max diff 0), loads and resizes; the PIL
  readers keep Pillow's own limit (2 x Image.MAX_IMAGE_PIXELS), past which
  the reference's fallback raises.
"""

import importlib.util
import struct
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

# the header builders phase 13 of chip_smoke.py runs on the card
_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)
png_header, tiff_header = chip_smoke.gray_png, chip_smoke.tiff_header

torch.set_num_threads(2)
quiet = lambda s: None  # noqa: E731

# (w, h) on both sides of every limit; none of them makes cv2 allocate more
# than a few MB before it gives None or raises
SIZES = [(0, 5), (5, 0), (40000, 30000), (2000000, 1), (1, 2000000),
         (1 << 20, 1), ((1 << 20) + 1, 1), (1000000, 1), (1000001, 1),
         (32768, 32769), (65535, 65535), (65501, 2), (65500, 2)]


def jpeg_header(w, h):
    """A gray baseline JPEG's markers up to its first scan, then EOI."""
    dqt = b"\xff\xdb" + struct.pack(">HB", 67, 0) + bytes([1] * 64)
    dht = b"".join(b"\xff\xc4" + struct.pack(">HB", 20, c) + bytes([1] + [0] * 15)
                   + b"\0" for c in (0x00, 0x10))
    sof = b"\xff\xc0" + struct.pack(">HBHHB", 11, 8, h, w, 1) + b"\x01\x11\0"
    sos = b"\xff\xda" + struct.pack(">HB", 8, 1) + b"\x01\0\0\x3f\0"
    return b"\xff\xd8" + dqt + dht + sof + sos + bytes(4) + b"\xff\xd9"


HEADERS = {
    "png": png_header,
    "pgm": lambda w, h: b"P5\n%d %d\n255\n" % (w, h),
    "pbm_ascii": lambda w, h: b"P1\n%d %d\n" % (w, h),
    "pam": lambda w, h: (b"P7\nWIDTH %d\nHEIGHT %d\nDEPTH 3\nMAXVAL 255\n"
                         b"ENDHDR\n" % (w, h)),
    "bmp": lambda w, h: (b"BM" + struct.pack("<IHHI", 54, 0, 0, 54)
                         + struct.pack("<IiiHHIIiiII", 40, w, h, 1, 24, 0,
                                       0, 0, 0, 0, 0)),
    "sun": lambda w, h: struct.pack(">8I", 0x59a66a95, w, h, 24, 0, 1, 0, 0),
    "hdr": lambda w, h: (b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n"
                         b"-Y %d +X %d\n" % (h, w)),
    "pfm": lambda w, h: b"PF\n%d %d\n-1.0\n" % (w, h),
    "gif": lambda w, h: (b"GIF89a" + struct.pack("<HHBBB", w, h, 0, 0, 0)
                         + b";"),
    "jpeg": jpeg_header,
    "tiff": tiff_header,
}
SIXTEEN_BITS = ("gif", "jpeg")  # their sides are 16-bit fields
# and unsigned 32-bit ones at their largest (a TIFF strip of more than
# INT64_MAX bytes, which libtiff reads as size 0)
LARGEST = [(2 ** 32 - 1, 2 ** 32 - 1), (2 ** 32 - 1, 1)]


def _cv2(path):
    try:
        img = cv2.imread(str(path))
    except cv2.error:
        return "raise"
    return "none" if img is None else "read"


def _port(path):
    (dims,), (raised,) = native.probe([str(path)], reader="cv2",
                                      raises=True)
    return "raise" if raised else "none" if dims[0] == 0 else "read"


@pytest.mark.parametrize("fmt", sorted(HEADERS))
def test_header_sizes_raise_where_cv2_raises(tmp_path, fmt):
    """At every size, the cv2 probe's outcome is cv2.imread's (raise, None
    or read); where cv2 raises, decode, load_batch and load_canvas raise
    naming the rule, and the header probe raises; and the sizes give all
    three outcomes but read where the format's own parser refuses first."""
    seen = set()
    p = tmp_path / f"h.{fmt}"
    for w, h in SIZES + (LARGEST if fmt not in SIXTEEN_BITS + ("bmp",)
                         else []):
        if fmt in SIXTEEN_BITS and max(w, h) > 65535:
            continue
        p.write_bytes(HEADERS[fmt](w, h))
        want = _cv2(p)
        assert _port(p) == want, (fmt, w, h, want)
        seen.add(want)
        if want != "raise":
            continue
        with pytest.raises(RuntimeError, match="cv2.imread raises on it"):
            native.decode(str(p))
        with pytest.raises(RuntimeError, match="cv2.imread raises on it"):
            native.load_batch([str(p)], 16)
        with pytest.raises(RuntimeError, match="cv2.imread raises on it"):
            native.load_canvas([str(p)], np.zeros((1, 8, 8, 3), np.uint8))
        with pytest.raises(RuntimeError, match="cv2.imread raises on it"):
            native.probe([str(p)])
    assert "raise" in seen and "none" in seen


def test_probe_raises_needs_the_cv2_reader(tmp_path):
    """raises=True returns (dims, raised) with the cv2 reader alone."""
    with pytest.raises(ValueError, match="reader='cv2'"):
        native.probe([str(tmp_path / "x.png")], raises=True)
    dims, raised = native.probe([], reader="cv2", raises=True)
    assert dims.shape == (0, 2) and raised.shape == (0,)


# ------------------------------------------------------- generate_tree

def _tree(root, bad_name, bad_data):
    """A three-file tree: two small PNGs cv2 writes, and ``bad_data``
    under ``bad_name`` between them."""
    rng = np.random.default_rng(9)
    for k, name in enumerate(("a.png", bad_name, "z.png")):
        p = root / f"0000{k % 2}" / name
        p.parent.mkdir(parents=True, exist_ok=True)
        if name == bad_name:
            p.write_bytes(bad_data)
        else:
            cv2.imwrite(str(p), rng.integers(0, 256, (20, 24, 3), np.uint8))
    return root


RAISING = {name: (png_header if name.startswith("png") else tiff_header)(
    *size) for name, size in chip_smoke.RAISING_HEADERS.items()}


@pytest.mark.parametrize("name", sorted(RAISING))
def test_generate_tree_raises_where_the_reference_raises(tmp_path, name):
    """A header-only 40000 x 30000 PNG or a 2000000 x 1 TIFF in the source
    tree: the reference's generate_tree raises cv2.error, the port's a
    RuntimeError that names the file, before it writes anything."""
    src = _tree(tmp_path / "src", name, RAISING[name])
    with pytest.raises(cv2.error):
        joffline.generate_tree(str(src), str(tmp_path / "ref"), "noise",
                               log=quiet)
    with pytest.raises(RuntimeError, match=name):
        offline.generate_tree(str(src), str(tmp_path / "ours"), "noise",
                              log=quiet, device="cpu")
    assert not (tmp_path / "ours").exists()


@pytest.mark.parametrize("name", sorted(RAISING))
def test_reader_paths_raise_where_the_reference_raises(tmp_path, name):
    """_decode_resize raises in both packages (cv2.error in the
    reference's), and so do the port's decode and ImageFolder."""
    p = tmp_path / "c" / name
    p.parent.mkdir()
    p.write_bytes(RAISING[name])
    with pytest.raises(cv2.error):
        jgtsrb._decode_resize(str(p), 32)
    with pytest.raises(RuntimeError, match="cv2.imread raises on it"):
        gtsrb._decode_resize(str(p), 32)
    with pytest.raises(RuntimeError):
        gtsrb.ImageFolder(str(tmp_path), 32).load(0)


def test_tiff_width_0_is_skipped_by_both(tmp_path):
    """A TIFF of width 0 gives None in libtiff, before imread's size rule:
    both generate_trees skip it and write the other two files."""
    src = _tree(tmp_path / "src", "w0.png", tiff_header(0, 10))
    lines = []
    n = offline.generate_tree(str(src), str(tmp_path / "ours"), "noise",
                              log=lines.append, device="cpu")
    m = joffline.generate_tree(str(src), str(tmp_path / "ref"), "noise",
                               log=quiet)
    assert n == m == 2 and "Skipped 1 unreadable files" in lines


# ------------------------------------------------------------------ C9

def test_8200_png_reads_as_cv2(tmp_path):
    """An 8200 x 8200 gray PNG (past the port's old 64 Mpx cap; the file
    phase 13 of chip_smoke.py builds): both
    probes give (8200, 8200), generate_tree's cv2 probe keeps it, decode
    equals cv2.imread (max diff 0), load_batch resizes it within 1 LSB of
    cv2.resize, and load_canvas fills a resize_to slot with the same
    pixels."""
    side = chip_smoke.BIG_PNG_SIDE
    x = np.arange(side, dtype=np.uint32)
    rows = ((x[None, :] * 7 + x[:, None] * 3) % 251).astype(np.uint8)
    p = tmp_path / "big.png"
    p.write_bytes(png_header(side, side, rows))
    for reader in ("port", "cv2"):
        assert native.probe([str(p)], reader=reader).tolist() == [[side,
                                                                    side]]
    dims, raised = native.probe([str(p)], reader="cv2", raises=True)
    assert dims.tolist() == [[side, side]] and not raised.any()
    want = cv2.imread(str(p))[:, :, ::-1]
    np.testing.assert_array_equal(want[:, :, 1], rows)
    got = native.decode(str(p))
    assert got.shape == (side, side, 3)
    np.testing.assert_array_equal(got, want)
    del got
    small = cv2.resize(np.ascontiguousarray(want), (32, 32),
                       interpolation=cv2.INTER_LINEAR).astype(int)
    batch = native.load_batch([str(p)], 32)
    assert np.abs(batch[0].astype(int) - small).max() <= 1
    out = np.zeros((1, 32, 32, 3), np.uint8)
    assert native.load_canvas([str(p)], out, resize_to=32).tolist() == [
        [32, 32]]
    np.testing.assert_array_equal(out, batch)


def test_pil_limit_raises_as_the_reference_does(tmp_path):
    """A gray PFM ("Pf", which cv2 refuses and PIL reads) of 20000 x 10000
    pixels, past 2 x Image.MAX_IMAGE_PIXELS: cv2 gives None, PIL raises
    DecompressionBombError, so the reference's reader raises; the port's
    cv2 probe gives (0, 0) without the raise mark and its decode raises."""
    p = tmp_path / "c" / "bomb.png"
    p.parent.mkdir()
    p.write_bytes(b"Pf\n20000 10000\n-1.0\n" + bytes(64))
    assert 20000 * 10000 > 2 * Image.MAX_IMAGE_PIXELS
    assert cv2.imread(str(p)) is None
    with pytest.raises(Image.DecompressionBombError):
        jgtsrb._decode_resize(str(p), 32)
    assert _port(p) == "none"
    with pytest.raises(RuntimeError, match="failed to decode"):
        native.decode(str(p))
    with pytest.raises(RuntimeError, match="failed to decode"):
        native.load_batch([str(p)], 32)
