"""C11: FF FF 00 in JPEG entropy data, read as the reference reads it.

libjpeg-turbo 3.1 (jdhuff.c) decodes an MCU of a sequential Huffman scan
with no restart interval through ``decode_mcu_fast`` where no marker is
unread and its source's buffer holds at least 512 bytes a block of the MCU.
The fast pass reads ``FF`` then any byte but ``00`` (another ``FF`` too) as
a marker and feeds zero bits; the MCU is then decoded again by the slow
pass, which reads ``FF FF 00`` as one ``FF`` data byte and writes only the
coefficients it decodes over the fast pass's. Which pass runs depends on
the source: ``cv2.imread`` of a .jpg reads through libjpeg's stdio source,
refilled 4096 bytes at a time; libtiff hands a JPEG-compressed strip or
tile whole (cv2's reader and PIL's alike). Progressive, arithmetic and
lossless scans have no fast pass, and neither do scans with restart
intervals.

The sweeps set the byte before each of a seeded choice of FF 00 pairs to FF
(some before it too, for FF FF FF 00), in cv2-written files at 4:2:0, 4:4:4
and gray, with and without restart intervals, progressive, at sizes that
put the sites on both sides of the fast pass's threshold and beside the
stdio source's 4096-byte refills, and in Pillow's JPEG-compressed TIFFs
(orientation 6 of a non-square image: PIL's read), and every pair of an
arithmetic and a lossless file; the port decodes each to the reference's
pixels, max diff 0. ``chip_smoke.py``'s C11 files and
their digests are checked against cv2.
"""

import hashlib
import importlib.util
import io
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

from tsr_tpu_torch import native

torch.set_num_threads(2)
_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)
_spec = importlib.util.spec_from_file_location(
    "jpeg_writers", Path(__file__).resolve().parent / "data" / "jpeg"
    / "jpeg_writers.py")
jpeg_writers = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(jpeg_writers)


def _smooth(rng, h, w):
    """Noise over a cubic upsampling of coarse noise: entropy data with
    many FF bytes."""
    coarse = rng.integers(0, 256, (h // 8 + 2, w // 8 + 2, 3)).astype(np.uint8)
    img = cv2.resize(coarse, (w, h), interpolation=cv2.INTER_CUBIC)
    return np.clip(img + rng.integers(0, 24, img.shape), 0, 255).astype(np.uint8)


def _sites(data, rng, n):
    """``n`` FF 00 pairs of ``data``'s entropy data (after its last SOS):
    the last before and the first after each 4096-byte boundary, the rest
    drawn from ``rng``."""
    start = data.rfind(b"\xff\xda") + 2
    sites = [i for i in range(start, len(data) - 2)
             if data[i] == 0xFF and data[i + 1] == 0]
    chosen = set()
    for k in range(4096, len(data), 4096):
        chosen.update([i for i in sites if i < k][-1:]
                      + [i for i in sites if i >= k][:1])
    rest = [i for i in sites if i not in chosen]
    take = min(len(rest), max(0, n - len(chosen)))
    chosen.update(rng.choice(rest, take, replace=False).tolist())
    return sorted(chosen)


def _mutated(data, site, run):
    """``data`` with the byte before the FF 00 at ``site`` set to FF (and,
    for a run, the byte before that too)."""
    d = bytearray(data)
    d[site - 1] = 0xFF
    if run and site >= 2:
        d[site - 2] = 0xFF
    return bytes(d)


def _reference(path):
    img = cv2.imread(str(path))
    if img is not None:
        return img[:, :, ::-1]
    try:
        return np.asarray(Image.open(path).convert("RGB"))
    except Exception:
        return None


KINDS = {  # (rows, columns, cv2.imwrite parameters)
    "420": (200, 240, [cv2.IMWRITE_JPEG_QUALITY, 90]),
    "444": (136, 320, [cv2.IMWRITE_JPEG_QUALITY, 95,
                       cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                       cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444]),
    "gray": (120, 600, [cv2.IMWRITE_JPEG_QUALITY, 97]),
    "420_restart": (160, 240, [cv2.IMWRITE_JPEG_QUALITY, 95,
                               cv2.IMWRITE_JPEG_RST_INTERVAL, 2]),
    "gray_restart": (96, 480, [cv2.IMWRITE_JPEG_QUALITY, 97,
                               cv2.IMWRITE_JPEG_RST_INTERVAL, 3]),
    "progressive": (160, 240, [cv2.IMWRITE_JPEG_QUALITY, 95,
                               cv2.IMWRITE_JPEG_PROGRESSIVE, 1]),
}


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_ff_ff_00_reads_as_cv2(tmp_path, kind):
    """The byte before seeded FF 00 pairs set to FF (some FF FF FF 00):
    decode equals cv2.imread, max diff 0, at 4:2:0 (the fast pass needs
    3072 bytes buffered), 4:4:4 (1536) and gray (512), with restart
    intervals and progressive (no fast pass), sites beside the stdio
    source's 4096-byte refills among them."""
    h, w, params = KINDS[kind]
    rng = np.random.default_rng(sorted(KINDS).index(kind) + 110)
    img = _smooth(rng, h, w)
    if kind.startswith("gray"):
        img = cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)
    ok, enc = cv2.imencode(".jpg", img, params)
    assert ok
    data = enc.tobytes()
    assert len(data) > 2 * 4096
    p = tmp_path / "c11.jpg"
    for k, site in enumerate(_sites(data, rng, 36)):
        p.write_bytes(_mutated(data, site, k % 5 == 4))
        want = cv2.imread(str(p))
        assert want is not None
        np.testing.assert_array_equal(native.decode(str(p)), want[:, :, ::-1],
                                      err_msg=f"{kind} at {site}")


@pytest.mark.parametrize("orientation", [1, 6])
def test_ff_ff_00_in_jpeg_tiff_reads_as_reference(tmp_path, orientation):
    """Pillow's JPEG-compressed RGB TIFFs (56 x 40 as C11 was found, and
    larger), every FF 00 of their entropy data given an FF before it: cv2's
    pixels (libtiff hands libjpeg the strip whole), and PIL's for
    orientation 6 of the non-square image, which cv2 refuses; max diff 0."""
    rng = np.random.default_rng(120 + orientation)
    p = tmp_path / "c11.png"
    n = 0
    for h, w in ((40, 56), (96, 128)):
        buf = io.BytesIO()
        kw = {}
        if orientation != 1:
            exif = Image.Exif()
            exif[274] = orientation
            kw["exif"] = exif
        Image.fromarray(_smooth(rng, h, w)).save(buf, "TIFF",
                                                 compression="jpeg", **kw)
        data = buf.getvalue()
        start = data.rfind(b"\xff\xda") + 2
        end = data.rfind(b"\xff\xd9")
        for site in range(start, end):
            if data[site] != 0xFF or data[site + 1] != 0:
                continue
            p.write_bytes(_mutated(data, site, False))
            want = _reference(p)
            assert want is not None
            np.testing.assert_array_equal(native.decode(str(p)), want,
                                          err_msg=f"{h}x{w} at {site}")
            n += 1
    assert n >= 10


def test_chip_smoke_c11_digests_are_cv2s(tmp_path):
    """chip_smoke.py's C11 files (the port's JPEG writer, the byte before
    each chosen FF 00 set to FF): C11_DIGESTS are SHA-256 of cv2.imread's
    pixels, and the port decodes each to them; the files reach both sides
    of the fast pass's threshold and the 4096-byte refills."""
    files = chip_smoke.c11_files(tmp_path)
    assert sorted(files) == sorted(chip_smoke.C11_DIGESTS)
    assert any(s % 4096 < 1024 for s in files)
    assert any(s % 4096 >= 1024 for s in files)
    for site, p in files.items():
        want = np.ascontiguousarray(cv2.imread(str(p))[:, :, ::-1])
        assert hashlib.sha256(want.tobytes()).hexdigest() == \
            chip_smoke.C11_DIGESTS[site], site
        got = np.ascontiguousarray(native.decode(str(p)))
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("coding", ["arithmetic", "lossless"])
def test_ff_ff_00_without_a_fast_pass_reads_as_cv2(tmp_path, coding):
    """Arithmetic (SOF9) and lossless (SOF3, three components) data have no
    fast pass in libjpeg-turbo: every FF 00 given an FF before it reads as
    one FF data byte, as the port reads it, cv2's pixels, max diff 0."""
    rng = np.random.default_rng(130)
    img = _smooth(rng, 64, 96)
    data = (jpeg_writers.arithmetic(img) if coding == "arithmetic" else
            jpeg_writers.lossless([img[:, :, k] for k in range(3)], psv=1))
    start = data.rfind(b"\xff\xda") + 2
    sites = [i for i in range(start, len(data) - 2)
             if data[i] == 0xFF and data[i + 1] == 0]
    assert sites
    p = tmp_path / "c11.jpg"
    for site in sites:
        p.write_bytes(_mutated(data, site, False))
        want = cv2.imread(str(p))
        assert want is not None
        np.testing.assert_array_equal(native.decode(str(p)), want[:, :, ::-1])
