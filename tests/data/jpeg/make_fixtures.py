"""Writes the JPEG fixtures of ``tests/test_torch_port_codec.py`` and of
``chip_smoke.py``'s JPEG phase into this directory, with cv2 and PIL:

- ``<case>.jpg``: small files over the decoder's cases (sampling factors,
  qualities, progressive, optimized Huffman, restart intervals, gray, EXIF
  orientation in both TIFF byte orders, an Adobe RGB file);
- ``expected.npz``: ``decoded__<case>`` = ``cv2.imread(<case>.jpg)`` as RGB,
  ``encode_input__<k>`` = seeded RGB arrays and ``encode_bytes__<k>`` =
  the bytes ``cv2.imwrite("x.jpg", bgr)`` writes for them.

Run from the root of the checkout: ``python tests/data/jpeg/make_fixtures.py``.
The test checks that the committed files still equal what cv2 gives.
"""

import io
import struct
from pathlib import Path

import cv2
import numpy as np
from PIL import Image

HERE = Path(__file__).resolve().parent
SEED = 10
# cv2.IMWRITE_JPEG_SAMPLING_FACTOR_* by name
SAMPLING = {"444": 0x111111, "422": 0x211111, "420": 0x221111,
            "440": 0x121111, "411": 0x411111}
# (case, (h, w), cv2 params or a PIL writer's name)
CASES = (
    ("s444_q95", (37, 53), dict(sampling="444", quality=95)),
    ("s422_q75_w7", (40, 7), dict(sampling="422", quality=75)),
    ("s420_default", (53, 37), {}),
    ("s440_q10", (23, 31), dict(sampling="440", quality=10)),
    ("s411_q75", (33, 65), dict(sampling="411", quality=75)),
    ("progressive_q75", (31, 29), dict(quality=75, progressive=1)),
    ("optimized_q95", (29, 47), dict(quality=95, optimize=1)),
    ("restart2_s422", (27, 41), dict(sampling="422", quality=75, rst=2)),
    ("gray_q75", (19, 23), dict(gray=True, quality=75)),
    ("gray_progressive", (13, 21), dict(gray=True, progressive=1)),
    ("exif6_le", (21, 34), "exif6_le"),
    ("exif8_be", (26, 17), "exif8_be"),
    ("adobe_rgb", (22, 30), "adobe_rgb"),
)
ENCODE_SIZES = ((1, 1), (7, 40), (37, 53), (17, 33), (64, 48), (3, 130))


def smooth(rng, h, w):
    """A smooth random RGB image (a coarse field upsampled, plus grain)."""
    coarse = rng.integers(0, 256, (h // 6 + 2, w // 6 + 2, 3))
    img = cv2.resize(coarse.astype(np.float32), (w, h),
                     interpolation=cv2.INTER_CUBIC)
    return np.clip(img + rng.normal(0, 10, img.shape), 0,
                   255).astype(np.uint8)


def tiff_orientation(order: str, orientation: int) -> bytes:
    """A TIFF stream whose IFD0 holds only tag 0x0112."""
    e = "<" if order == "II" else ">"
    return (order.encode() + struct.pack(e + "HI", 42, 8)
            + struct.pack(e + "H", 1)
            + struct.pack(e + "HHIH", 0x112, 3, 1, orientation) + b"\0\0"
            + struct.pack(e + "I", 0))


def with_app1(jpeg: bytes, payload: bytes) -> bytes:
    """``jpeg`` with an APP1 of ``payload`` after its JFIF APP0."""
    app1 = b"\xff\xe1" + struct.pack(">H", len(payload) + 2) + payload
    return jpeg[:20] + app1 + jpeg[20:]


def write_case(path: Path, img: np.ndarray, how) -> None:
    if isinstance(how, str):
        buf = io.BytesIO()
        if how == "adobe_rgb":  # RGB components behind an Adobe APP14
            Image.fromarray(img).save(buf, "JPEG", quality=90, keep_rgb=True)
            path.write_bytes(buf.getvalue())
            return
        Image.fromarray(img).save(buf, "JPEG", quality=90)
        order = "II" if how.endswith("le") else "MM"
        payload = b"Exif\0\0" + tiff_orientation(order, int(how[4]))
        path.write_bytes(with_app1(buf.getvalue(), payload))
        return
    params = [cv2.IMWRITE_JPEG_QUALITY, how.get("quality", 95),
              cv2.IMWRITE_JPEG_PROGRESSIVE, how.get("progressive", 0),
              cv2.IMWRITE_JPEG_OPTIMIZE, how.get("optimize", 0),
              cv2.IMWRITE_JPEG_RST_INTERVAL, how.get("rst", 0)]
    if "sampling" in how:
        params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                   SAMPLING[how["sampling"]]]
    bgr = img[:, :, 0] if how.get("gray") else img[:, :, ::-1]
    assert cv2.imwrite(str(path), bgr, params)


def make(out: Path = HERE) -> dict:
    """Writes the fixtures into ``out``; returns the npz's arrays."""
    rng = np.random.default_rng(SEED)
    arrays = {}
    for name, (h, w), how in CASES:
        p = out / f"{name}.jpg"
        write_case(p, smooth(rng, h, w), how)
        arrays[f"decoded__{name}"] = cv2.imread(str(p))[:, :, ::-1].copy()
    for k, (h, w) in enumerate(ENCODE_SIZES):
        img = smooth(rng, h, w)
        ok, enc = cv2.imencode(".jpg", img[:, :, ::-1])
        assert ok
        arrays[f"encode_input__{k}"] = img
        arrays[f"encode_bytes__{k}"] = enc.reshape(-1)
    np.savez_compressed(out / "expected.npz", **arrays)
    return arrays


if __name__ == "__main__":
    make()
