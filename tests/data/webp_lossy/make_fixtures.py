"""Writes the lossy WebP fixtures of ``tests/test_torch_port_webp_lossy.py``
and of ``chip_smoke.py``'s image formats phase into this directory: the
cases of ``tests/data/image_cases.py`` (``webp_lossy_cases``,
``webp_lossy_skip_cases``, from WEBP_LOSSY_SEED), made with cv2, Pillow,
libwebp's encoder through ctypes and the VP8 writer ``vp8_bytes``:

- ``<case>``: files cv2.imread reads;
- ``skip/<case>``: files cv2.imread gives None for, some of which PIL
  reads;
- ``webp_lossy_640x480_q75.jpg``: the 640 x 480 file phase 13 times
  (``build_big``), checked by the SHA-256 of cv2's RGB
  (``chip_smoke.WEBP_LOSSY_BIG_DIGEST``), not by its pixels;
- ``expected.npz``: ``decoded__<case>`` = ``cv2.imread``'s RGB of each
  case, ``decoded_skip__<case>`` = PIL's ``convert("RGB")`` of each skip
  case PIL reads, ``generate_tree_written`` = how many files of the cases,
  the big file and the skip cases together the reference's
  ``generate_tree`` writes.

They live apart from ``tests/data/webp``, whose size a test bounds. Run
from the root of the checkout: ``python
tests/data/webp_lossy/make_fixtures.py``. The tests check that the
committed files still equal what cv2 and PIL give.
"""

import importlib.util
from pathlib import Path

import cv2
import numpy as np
from PIL import Image

HERE = Path(__file__).resolve().parent

_spec = importlib.util.spec_from_file_location(
    "image_cases", HERE.parent / "image_cases.py")
image_cases = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(image_cases)
chip_smoke = image_cases.chip_smoke
# the npz writer the image fixtures use (LZMA members)
_spec = importlib.util.spec_from_file_location(
    "image_fixtures", HERE.parent / "images" / "make_fixtures.py")
image_fixtures = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(image_fixtures)
BIG = chip_smoke.WEBP_LOSSY_BIG


def build_big():
    """The 640 x 480 gradient-and-grain image (a stream of its own from
    WEBP_LOSSY_SEED) and cv2's WebP of it at quality 75."""
    rng = np.random.default_rng(image_cases.WEBP_LOSSY_SEED)
    h, w = chip_smoke.WEBP_LOSSY_BIG_SIZE
    img = image_cases.grain(rng, h, w, amp=3)
    return img, image_cases.webp_lossy_cv2(img, 75)


def make(out: Path = HERE) -> dict:
    """Writes the fixtures into ``out``; returns the npz's arrays."""
    rng = np.random.default_rng(image_cases.WEBP_LOSSY_SEED)
    cases = image_cases.webp_lossy_cases(rng)
    skips = image_cases.webp_lossy_skip_cases(rng)
    (out / "skip").mkdir(parents=True, exist_ok=True)
    (out / BIG).write_bytes(build_big()[1])
    arrays = {}
    for name, data in cases.items():
        p = out / name
        p.write_bytes(data)
        img = cv2.imread(str(p))
        assert img is not None, name
        arrays[f"decoded__{name}"] = img[:, :, ::-1].copy()
    for name, data in skips.items():
        p = out / "skip" / name
        p.write_bytes(data)
        assert cv2.imread(str(p)) is None, name
        try:
            arrays[f"decoded_skip__{name}"] = np.asarray(
                Image.open(p).convert("RGB"))
        except Exception:
            pass
    arrays["generate_tree_written"] = np.array(len(cases) + 1)
    image_fixtures.save_arrays(out / "expected.npz", arrays)
    return arrays


def names():
    """(the cases, the skip cases) by name, the big file left out."""
    rng = np.random.default_rng(image_cases.WEBP_LOSSY_SEED)
    return (tuple(image_cases.webp_lossy_cases(rng)),
            tuple(image_cases.webp_lossy_skip_cases(rng)))


if __name__ == "__main__":
    make()
