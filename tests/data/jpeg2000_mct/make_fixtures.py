"""Writes the fixtures of JPEG 2000 part 5 (Part 2's multi-component
markers: CBD, MCT, MCC, MCO) for ``tests/test_torch_port_jpeg2000_mct.py``
and ``chip_smoke.py``'s image formats phase into this directory: the cases
of ``tests/data/jpeg2000_cases.py``'s ``mct_cases`` and ``mct_skip_cases``,
named ``j2k5_*``, from JPEG2000_SEED + 6 (Pillow's part 1 files with the
segments added by byte edits, and OpenJPEG's own opj_set_MCT output):

- ``<case>``: files cv2.imread reads;
- ``skip/<case>``: files cv2.imread gives None for, some of which PIL
  reads;
- ``expected.npz``: ``decoded__<case>`` = ``cv2.imread``'s RGB of each
  case, ``decoded_skip__<case>`` = PIL's ``convert("RGB")`` of each skip
  case PIL reads, ``generate_tree_written`` = how many files of the cases
  and the skip cases together the reference's ``generate_tree`` writes.

Run from the root of the checkout: ``python
tests/data/jpeg2000_mct/make_fixtures.py``. The tests check that the
committed files still equal what cv2 and PIL give.
"""

import importlib.util
from pathlib import Path

import cv2
import numpy as np
from PIL import Image

HERE = Path(__file__).resolve().parent


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


cases_module = _load("jpeg2000_cases", HERE.parent / "jpeg2000_cases.py")
# the npz writer the image fixtures use (LZMA members)
image_fixtures = _load("image_fixtures", HERE.parent / "images"
                       / "make_fixtures.py")
chip_smoke = image_fixtures.image_cases.chip_smoke


def _cases():
    rng = np.random.default_rng(cases_module.JPEG2000_SEED + 6)
    return cases_module.mct_cases(rng), cases_module.mct_skip_cases(rng)


def make(out: Path = HERE) -> dict:
    """Writes the fixtures into ``out``; returns the npz's arrays."""
    cases, skips = _cases()
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
    cases, skips = _cases()
    return tuple(cases), tuple(skips)


if __name__ == "__main__":
    make()
