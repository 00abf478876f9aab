"""Writes the WebP fixtures of ``tests/test_torch_port_webp.py`` and of
``chip_smoke.py``'s image formats phase into this directory: the cases of
``tests/data/image_cases.py`` (``webp_cases``, ``webp_skip_cases``, from
WEBP_SEED), made with cv2, PIL and ``chip_smoke.vp8l_bytes``:

- ``<case>``: files cv2.imread reads;
- ``skip/<case>``: files cv2.imread gives None for, one of which PIL reads;
- ``expected.npz``: ``decoded__<case>`` = ``cv2.imread``'s RGB of each
  case, ``decoded_skip__<case>`` = PIL's ``convert("RGB")`` of each skip
  case PIL reads, ``generate_tree_written`` = how many files of the cases
  and skip cases together the reference's ``generate_tree`` writes.

They live apart from ``tests/data/images``, whose size a test bounds.
Run from the root of the checkout: ``python tests/data/webp/make_fixtures.py``.
The tests check that the committed files still equal what cv2 and PIL
give.
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
# the npz writer the image fixtures use (LZMA members)
_spec = importlib.util.spec_from_file_location(
    "image_fixtures", HERE.parent / "images" / "make_fixtures.py")
image_fixtures = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(image_fixtures)


def make(out: Path = HERE) -> dict:
    """Writes the fixtures into ``out``; returns the npz's arrays."""
    rng = np.random.default_rng(image_cases.WEBP_SEED)
    cases = image_cases.webp_cases(rng)
    skips = image_cases.webp_skip_cases(rng)
    (out / "skip").mkdir(parents=True, exist_ok=True)
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
    arrays["generate_tree_written"] = np.array(len(cases))
    image_fixtures.save_arrays(out / "expected.npz", arrays)
    return arrays


def names():
    """(the cases, the skip cases) by name."""
    rng = np.random.default_rng(image_cases.WEBP_SEED)
    return (tuple(image_cases.webp_cases(rng)),
            tuple(image_cases.webp_skip_cases(rng)))


if __name__ == "__main__":
    make()
