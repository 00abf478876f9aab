"""Writes the JPEG fixtures of ``tests/test_torch_port_codec.py``,
``tests/test_torch_port_jpeg_features.py`` and of ``chip_smoke.py``'s JPEG
phases into this directory, with cv2, PIL and ``jpeg_writers.py``:

- ``<case>.jpg``: small files over the decoder's cases (sampling factors,
  qualities, progressive, optimized Huffman, restart intervals, gray, EXIF
  orientation in both TIFF byte orders, an Adobe RGB file), then
  FEATURE_CASES: scans cut short or corrupt (block smoothing among them),
  CMYK and YCCK, lossless gray and RGB, arithmetic coding;
- ``skip/<case>.jpg``: SKIP_CASES, files that neither cv2.imread nor PIL
  reads (12-bit, hierarchical, two components, a cut in the headers,
  lossless YCbCr, lossless arithmetic);
- ``expected.npz``: ``decoded__<case>`` = what the reference reads from
  ``<case>.jpg`` as RGB (``cv2.imread``, or PIL's ``convert("RGB")`` where
  cv2 gives None: the lossless gray file), ``encode_input__<k>`` = seeded
  RGB arrays and ``encode_bytes__<k>`` = the bytes ``cv2.imwrite("x.jpg",
  bgr)`` writes for them, and ``generate_tree_written`` = how many files of
  the FEATURE_CASES and SKIP_CASES tree the reference's ``generate_tree``
  writes (those ``cv2.imread`` reads).

Run from the root of the checkout: ``python tests/data/jpeg/make_fixtures.py``.
The tests check that the committed files still equal what cv2 and PIL give.
"""

import io
import struct
from pathlib import Path

import importlib.util

import cv2
import numpy as np
from PIL import Image

HERE = Path(__file__).resolve().parent
_spec = importlib.util.spec_from_file_location("jpeg_writers",
                                               HERE / "jpeg_writers.py")
jw = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(jw)
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
FEATURE_SEED = 11
# (case, (h, w)): what cv2.imread reads with a warning or libjpeg reads
# rarely, each made by feature_bytes
FEATURE_CASES = (
    ("cut_baseline", (40, 48)),          # data ends mid-scan: grey below
    ("cut_progressive_dc", (40, 48)),    # DC scan only: DC interpolation
    ("cut_progressive_scan3", (40, 48)),  # mid-scan 3: both latches
    ("cut_progressive_rst", (40, 48)),   # restart interval 2, mid-scan 5
    ("no_eoi_progressive", (24, 32)),
    ("corrupt_huffman", (24, 32)),       # FF00 x 400: bad Huffman codes
    ("corrupt_bytes", (32, 40)),         # bytes of the scan overwritten
    ("rst_replaced", (32, 40)),          # RST2 written as RST4: resync
    ("cmyk", (24, 32)),                  # PIL's CMYK (Adobe transform 0)
    ("ycck", (24, 32)),                  # the same relabelled transform 2
    ("lossless_gray", (24, 32)),         # cv2: None; PIL reads it
    ("lossless_rgb", (24, 32)),          # predictor 7, restarts
    ("arith_sequential", (32, 40)),      # SOF9, 4:2:0, restarts
    ("arith_progressive", (32, 40)),     # SOF10, DAC conditioning
    ("arith_relabelled", (24, 32)),      # Huffman data read as SOF9
)
# files neither cv2.imread nor PIL reads: the reader paths raise, and
# generate_tree skips them as the reference does
SKIP_CASES = ("precision12", "hierarchical", "two_components",
              "cut_in_header", "lossless_ycc", "lossless_arith")


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


def sos_offsets(data: bytes):
    return [i for i in range(len(data) - 1)
            if data[i] == 0xFF and data[i + 1] == 0xDA]


def encode(img, **how) -> bytes:
    """cv2's encode of an RGB image with IMWRITE_JPEG_* options."""
    params = []
    for key, flag in (("quality", cv2.IMWRITE_JPEG_QUALITY),
                      ("progressive", cv2.IMWRITE_JPEG_PROGRESSIVE),
                      ("rst", cv2.IMWRITE_JPEG_RST_INTERVAL)):
        if key in how:
            params += [flag, how[key]]
    ok, enc = cv2.imencode(".jpg", img[:, :, ::-1], params)
    assert ok
    return enc.tobytes()


def relabel_sof(data: bytes, code: int) -> bytes:
    i = data.index(b"\xff\xc0")
    return data[:i + 1] + bytes([code]) + data[i + 2:]


def feature_bytes(name, img) -> bytes:
    """The bytes of FEATURE_CASES' or SKIP_CASES' ``name`` made from an
    RGB image."""
    if name == "cut_baseline":
        d = encode(img, quality=75)
        s = sos_offsets(d)[0]
        return d[:s + (len(d) - s) * 3 // 5]
    if name.startswith("cut_progressive") or name == "no_eoi_progressive":
        d = encode(img, quality=75, progressive=1,
                   rst=2 if name.endswith("rst") else 0)
        s = sos_offsets(d)
        if name == "cut_progressive_dc":
            return d[:s[1]]
        if name == "cut_progressive_scan3":
            return d[:(s[2] + s[3]) // 2]
        if name == "cut_progressive_rst":
            return d[:(s[4] + s[5]) // 2]
        return d[:-2]
    if name == "corrupt_huffman":
        d = encode(img)
        s = sos_offsets(d)[0]
        return d[:s + 14] + bytes([0xFF, 0x00]) * 400 + b"\xff\xd9"
    if name == "corrupt_bytes":
        d = bytearray(encode(img, quality=90))
        s = sos_offsets(d)[0] + 14
        for k in (0.3, 0.55, 0.8):
            i = s + int((len(d) - 2 - s) * k)
            while d[i] == 0xFF or d[i - 1] == 0xFF:
                i += 1
            d[i] ^= 0x5A
        return bytes(d)
    if name == "rst_replaced":
        d = bytearray(encode(img, quality=75, rst=1))
        i = d.index(b"\xff\xd2", sos_offsets(d)[0])
        d[i + 1] = 0xD4
        return bytes(d)
    if name in ("cmyk", "ycck"):
        buf = io.BytesIO()
        Image.fromarray(img).convert("CMYK").save(buf, "JPEG", quality=85)
        d = buf.getvalue()
        if name == "ycck":
            i = d.index(b"Adobe") + 11
            d = d[:i] + bytes([2]) + d[i + 1:]
        return d
    if name == "lossless_gray":
        return jw.lossless([img[:, :, 1]], psv=4, pt=1)
    if name == "lossless_rgb":
        return jw.lossless([img[:, :, k] for k in range(3)], psv=7, restart=3)
    if name == "arith_sequential":
        return jw.arithmetic(img, restart=2)
    if name == "arith_progressive":
        return jw.arithmetic(img, progressive=True,
                             dac=[(0, 0x31), (1, 0x20), (16, 3)])
    if name == "arith_relabelled":
        return relabel_sof(encode(img), 0xC9)
    if name == "precision12":
        d = encode(img)
        i = d.index(b"\xff\xc0")
        return d[:i + 4] + bytes([12]) + d[i + 5:]
    if name == "hierarchical":
        return relabel_sof(encode(img), 0xC5)
    if name == "two_components":
        return jw.two_components(*img.shape[:2])
    if name == "cut_in_header":
        d = encode(img)
        return d[:d.index(b"\xff\xc4") + 40]
    if name == "lossless_ycc":
        d = jw.lossless([img[:, :, k] for k in range(3)])
        return d[:2] + jw.segment(0xE0, b"JFIF\0\1\1\0\0\1\0\1\0\0") + d[2:]
    if name == "lossless_arith":
        d = jw.lossless([img[:, :, k] for k in range(3)])
        i = d.index(b"\xff\xc3")
        return d[:i + 1] + b"\xcb" + d[i + 2:]
    raise ValueError(name)


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
    rng = np.random.default_rng(FEATURE_SEED)
    written = 0
    for name, (h, w) in FEATURE_CASES:
        p = out / f"{name}.jpg"
        p.write_bytes(feature_bytes(name, smooth(rng, h, w)))
        arrays[f"decoded__{name}"] = reference_read(p)
        assert arrays[f"decoded__{name}"] is not None, name
        written += cv2.imread(str(p)) is not None
    (out / "skip").mkdir(exist_ok=True)
    for name in SKIP_CASES:
        p = out / "skip" / f"{name}.jpg"
        p.write_bytes(feature_bytes(name, smooth(rng, 20, 28)))
        assert reference_read(p) is None, name
    arrays["generate_tree_written"] = np.array(written)
    np.savez_compressed(out / "expected.npz", **arrays)
    return arrays


if __name__ == "__main__":
    make()
