"""Writes the HTJ2K fixtures (JPEG 2000 part 4: HT code-blocks, the CAP
and CPF markers) of ``tests/test_torch_port_jpeg2000_ht.py`` and of
``chip_smoke.py``'s image formats phase into this directory: the cases of
``tests/data/jpeg2000_cases.py``'s ``ht_cases`` and ``ht_skip_cases``,
named ``j2k4_*``, from JPEG2000_SEED + 5, written by the test encoder
``tests/data/htj2k_encode.py`` (and Pillow's part 1 writer for the CAP and
CPF file):

- ``<case>``: files cv2.imread reads, and ``j2k4_640x480_97.jpg``
  (``ht_big``), the file phase 13 times, held to
  ``chip_smoke.JPEG2000_HT_DIGEST``;
- ``skip/<case>``: files cv2.imread gives None for, some of which PIL
  reads;
- ``expected.npz``: ``decoded__<case>`` = ``cv2.imread``'s RGB of each
  case (not the big file's), ``decoded_skip__<case>`` = PIL's
  ``convert("RGB")`` of each skip case PIL reads,
  ``generate_tree_written`` = how many files of the cases and the skip
  cases together the reference's ``generate_tree`` writes.

Run from the root of the checkout: ``python
tests/data/jpeg2000_ht/make_fixtures.py``. The tests check that the
committed files still equal what cv2 and PIL give. The VLC tables the
encoder and the port share are written by ``extract_ht_tables.py`` beside
this file.
"""

import importlib.util
from pathlib import Path

import cv2
import numpy as np
from PIL import Image

HERE = Path(__file__).resolve().parent
BIG = "j2k4_640x480_97.jpg"


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
    rng = np.random.default_rng(cases_module.JPEG2000_SEED + 5)
    return cases_module.ht_cases(rng), cases_module.ht_skip_cases(rng)


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
    (out / BIG).write_bytes(cases_module.ht_big())
    assert cv2.imread(str(out / BIG)) is not None
    arrays["generate_tree_written"] = np.array(len(cases) + 1)
    image_fixtures.save_arrays(out / "expected.npz", arrays)
    return arrays


def names():
    """(the cases, the skip cases) by name."""
    cases, skips = _cases()
    return tuple(cases), tuple(skips)


if __name__ == "__main__":
    make()
