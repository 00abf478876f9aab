"""Writes the fixtures of ``tests/test_torch_port_image_formats.py``,
``tests/test_torch_port_tiff.py`` and of ``chip_smoke.py``'s image formats
phase into this directory: the cases of ``tests/data/image_cases.py``
(which lists what each holds), made with cv2, PIL and the byte writers of
``tests/data/image_writers.py``:

- ``<case>``: CASES, files cv2.imread reads;
- ``skip/<case>``: SKIP_CASES, files cv2.imread gives None for (cut,
  corrupt, a refused variant), some of which PIL reads; and FOREIGN, AVIF
  data (what cv2 reads and the port does not decode), JPEG 2000 files of
  the feature the port's decoder leaves out (sub-sampled components) under
  .png and .jpg names, and a ZSTD-compressed TIFF (what PIL reads and the
  port does not decode);
- ``expected.npz``: ``decoded__<case>`` = what the reference's readers give
  for each CASES file as RGB (``cv2.imread``; the pixels cv2 leaves
  unwritten, see ``cv2_written``, set to 0), ``decoded_skip__<case>`` =
  PIL's ``convert("RGB")`` of each SKIP_CASES file PIL reads, and
  ``generate_tree_written`` = how many files of the CASES + SKIP_CASES
  tree the reference's ``generate_tree`` writes (those cv2 reads; FOREIGN
  files stay out of it, as the port does not decode them).

Run from the root of the checkout: ``python tests/data/images/make_fixtures.py``.
The tests check that the committed files still equal what cv2 and PIL give.
"""

import importlib.util
import io
import re
import struct
import zipfile
import zlib
from pathlib import Path

import cv2
import numpy as np
from PIL import Image

HERE = Path(__file__).resolve().parent
SEED = 12

# the byte writers, shared with the tests
_spec = importlib.util.spec_from_file_location(
    "image_writers", HERE.parent / "image_writers.py")
writers = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(writers)
globals().update({name: getattr(writers, name) for name in writers.__all__})

# the cases of every format, and their seeds
_spec = importlib.util.spec_from_file_location(
    "image_cases", HERE.parent / "image_cases.py")
image_cases = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(image_cases)
globals().update({name: getattr(image_cases, name) for name in dir(image_cases)
                  if name.endswith(("cases", "_SEED"))})
_spec = importlib.util.spec_from_file_location(
    "jpeg2000_cases", Path(__file__).resolve().parents[1] / "jpeg2000_cases.py")
jpeg2000_cases = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(jpeg2000_cases)


# ---------------------------------------------------------------- cases


def foreign(rng):
    """AVIF data and JPEG 2000 files of the feature the port's decoder
    leaves out (sub-sampled components, in a JP2 file and in a raw
    codestream) under .png and .jpg names, and Pillow's ZSTD-compressed
    TIFF (a TIFF layout the port does not decode)."""
    out = {}
    out["tiff_zstd.png"] = pil_tiff(smooth(np.random.default_rng(
        TIFF2C_SEED + 1), 4, 6), "RGB", compression="zstd")
    for name, fmt, h, w in (("avif.png", "AVIF", 24, 30),
                            ("jp2.jpg", "JPEG2000", 28, 22),
                            ("j2k.png", "JPEG2000", 26, 32)):
        img = smooth(rng, h, w)
        if fmt == "AVIF":  # cv2's writer
            ok, enc = cv2.imencode(".avif", img[:, :, ::-1])
            assert ok
            out[name] = enc.tobytes()
        elif name == "jp2.jpg":
            out[name] = jpeg2000_cases.subsampled(jpeg2000_cases.pil_j2k(img))
        else:  # small: the directory's size is bounded
            out[name] = jpeg2000_cases.subsampled(
                jpeg2000_cases.opj_encode(img[:8, :8], numres=2))
    return out


def cv2_written(data, shape):
    """[h, w] bool: the pixels cv2.imread writes when it reads ``data``.
    OpenCV's PAM decoder converts a row of 2 or 4 samples a pixel
    (GRAYSCALE_ALPHA, RGB_ALPHA) pixel by pixel over the row's first
    ``width`` samples only, and leaves the rest of its image
    uninitialised; every other file is written whole."""
    h, w = shape
    mask = np.ones((h, w), bool)
    if data.startswith(b"P7"):
        head = data[:data.find(b"ENDHDR")].decode("latin-1")
        depth = re.search(r"DEPTH[ \t\v\f]+(\d+)", head)
        if depth and int(depth[1]) in (2, 4):
            mask[:] = np.arange(w) * int(depth[1]) < w
    return mask


def reference_read(path):
    """What the reference's readers give for ``path`` as RGB:
    ``cv2.imread``, else PIL's ``convert("RGB")``; None where both
    refuse."""
    img = cv2.imread(str(path))
    if img is not None:
        return img[:, :, ::-1].copy()
    try:
        return np.asarray(Image.open(path).convert("RGB"))
    except Exception:
        return None


def make(out: Path = HERE) -> dict:
    """Writes the fixtures into ``out``; returns the npz's arrays."""
    rng = np.random.default_rng(SEED)
    arrays = {}
    (out / "skip").mkdir(parents=True, exist_ok=True)
    written = 0
    gif_rng = np.random.default_rng(GIF_SEED)
    pfm_rng = np.random.default_rng(PFM_HDR_SEED)
    tiff_rng = np.random.default_rng(TIFF_SEED)
    tiff2_rng = np.random.default_rng(TIFF2_SEED)
    tiff2b_rng = np.random.default_rng(TIFF2B_SEED)
    tiff2c_rng = np.random.default_rng(TIFF2C_SEED)
    for name, data in {**cases(rng), **gif_sun_cases(gif_rng),
                       **pfm_hdr_cases(pfm_rng),
                       **tiff_cases(tiff_rng),
                       **tiff2_cases(tiff2_rng),
                       **tiff2b_cases(tiff2b_rng),
                       **tiff2c_cases(tiff2c_rng)}.items():
        p = out / name
        p.write_bytes(data)
        img = cv2.imread(str(p))
        assert img is not None, name
        img = img[:, :, ::-1].copy()
        img[~cv2_written(data, img.shape[:2])] = 0
        arrays[f"decoded__{name}"] = img
        written += 1
    for name, data in {**skip_cases(rng), **foreign(rng),
                       **gif_sun_skip_cases(gif_rng),
                       **pfm_hdr_skip_cases(pfm_rng),
                       **tiff_skip_cases(tiff_rng),
                       **tiff2_skip_cases(tiff2_rng),
                       **tiff2b_skip_cases(tiff2b_rng)}.items():
        p = out / "skip" / name
        p.write_bytes(data)
        assert cv2.imread(str(p)) is None or name in FOREIGN, name
        img = None if name in FOREIGN else reference_read(p)
        if img is not None:
            arrays[f"decoded_skip__{name}"] = img
    arrays["generate_tree_written"] = np.array(written)
    save_arrays(out / "expected.npz", arrays)
    return arrays


def save_arrays(path, arrays):
    """np.savez's layout with each array compressed by LZMA, deflate or
    bzip2, whichever gives it the fewest bytes (a third smaller than
    savez_compressed's deflate here); np.load reads it."""
    with zipfile.ZipFile(path, "w") as zf:
        for key, a in arrays.items():
            buf = io.BytesIO()
            np.lib.format.write_array(buf, np.asanyarray(a),
                                      allow_pickle=False)
            member = zipfile.ZipInfo(key + ".npy", (1980, 1, 1, 0, 0, 0))
            packed = [(len(_compressed(buf.getvalue(), c)), c)
                      for c in (zipfile.ZIP_LZMA, zipfile.ZIP_DEFLATED,
                                zipfile.ZIP_BZIP2)]
            zf.writestr(member, buf.getvalue(), compress_type=min(packed)[1],
                        compresslevel=9)


def _compressed(data, compression):
    """``data`` as a zip member compressed with ``compression``."""
    out = io.BytesIO()
    with zipfile.ZipFile(out, "w") as zf:
        zf.writestr("a", data, compress_type=compression, compresslevel=9)
    return out.getvalue()


def _names():
    rng = np.random.default_rng(SEED)
    gif_rng = np.random.default_rng(GIF_SEED)
    pfm_rng = np.random.default_rng(PFM_HDR_SEED)
    tiff_rng = np.random.default_rng(TIFF_SEED)
    tiff2_rng = np.random.default_rng(TIFF2_SEED)
    tiff2b_rng = np.random.default_rng(TIFF2B_SEED)
    tiff2c_rng = np.random.default_rng(TIFF2C_SEED)
    found = (tuple(cases(rng)) + tuple(gif_sun_cases(gif_rng))
             + tuple(pfm_hdr_cases(pfm_rng)) + tuple(tiff_cases(tiff_rng))
             + tuple(tiff2_cases(tiff2_rng)) + tuple(tiff2b_cases(tiff2b_rng))
             + tuple(tiff2c_cases(tiff2c_rng)))
    return found, (tuple(skip_cases(rng)) + tuple(gif_sun_skip_cases(gif_rng))
                   + tuple(pfm_hdr_skip_cases(pfm_rng))
                   + tuple(tiff_skip_cases(tiff_rng))
                   + tuple(tiff2_skip_cases(tiff2_rng))
                   + tuple(tiff2b_skip_cases(tiff2b_rng)))


CASES, SKIP_CASES = _names()
FOREIGN = ("avif.png", "jp2.jpg", "tiff_zstd.png", "j2k.png")

if __name__ == "__main__":
    make()
