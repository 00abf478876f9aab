"""Writes the JPEG 2000 fixtures of ``tests/test_torch_port_jpeg2000.py``
and of ``chip_smoke.py``'s image formats phase into this directory: the
cases of ``tests/data/jpeg2000_cases.py`` (``cases``, ``skip_cases``, from
JPEG2000_SEED; part 2's ``part2_cases``, ``part2_skip_cases``, named
``j2k2_*``, from JPEG2000_SEED + 3), made with cv2's and Pillow's writers,
OpenJPEG's encoder through ctypes and byte edits of their codestreams:

- ``<case>``: files cv2.imread reads;
- ``skip/<case>``: files cv2.imread gives None for, some of which PIL
  reads;
- ``j2k_640x480_97.jpg``: the 640 x 480 lossy 9/7 file phase 13 times
  (``build_big``), checked by the SHA-256 of cv2's RGB
  (``chip_smoke.JPEG2000_BIG_DIGEST``), not by its pixels;
- ``expected.npz``: ``decoded__<case>`` = ``cv2.imread``'s RGB of each
  case, ``decoded_skip__<case>`` = PIL's ``convert("RGB")`` of each skip
  case PIL reads, ``generate_tree_written`` = how many files of the cases,
  the big file and the skip cases together the reference's
  ``generate_tree`` writes.

Run from the root of the checkout: ``python
tests/data/jpeg2000/make_fixtures.py``. The tests check that the committed
files still equal what cv2 and PIL give.
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
BIG = chip_smoke.JPEG2000_BIG


def build_big():
    """The 640 x 480 image (a stream of its own, from JPEG2000_SEED + 1)
    and Pillow's lossy 9/7 JP2 of it."""
    return cases_module.build_big(
        np.random.default_rng(cases_module.JPEG2000_SEED + 1))


def _cases():
    """Part 1's cases from JPEG2000_SEED, part 2's from a stream of their
    own (JPEG2000_SEED + 3), so that neither moves the other's bytes."""
    rng = np.random.default_rng(cases_module.JPEG2000_SEED)
    cases, skips = cases_module.cases(rng), cases_module.skip_cases(rng)
    rng = np.random.default_rng(cases_module.JPEG2000_SEED + 3)
    cases.update(cases_module.part2_cases(rng))
    skips.update(cases_module.part2_skip_cases(rng))
    return cases, skips


def make(out: Path = HERE) -> dict:
    """Writes the fixtures into ``out``; returns the npz's arrays."""
    cases, skips = _cases()
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
    cases, skips = _cases()
    return tuple(cases), tuple(skips)


if __name__ == "__main__":
    make()
