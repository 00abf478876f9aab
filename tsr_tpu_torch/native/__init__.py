"""The port's image IO: ``tsrio.cpp`` bound with ``ctypes``.

The port's own copy of ``tsr_tpu/native`` and its only codec (no module of
the port imports cv2 or PIL): PNG/PPM/BMP decode at native size, a
cv2.INTER_LINEAR-convention bilinear resize (within 1 LSB of cv2), header
probes and whole batches decoded into padded canvases on native threads
(one call a batch, so the tree walks' Python threads stay off the
interpreter lock), and threaded PNG and PPM writers (:func:`write_png_batch`,
:func:`write_images`). ``g++`` builds the source on first use into
``build/tsr_tpu_torch_native/`` at the root of the checkout; the library's
name carries a hash of the source and the flags (``kernels/_build.py``).
The flags leave out ``-march=native``, so a library built on one x86-64
host loads on another. A failed build, decode or write raises.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional, Sequence, Union

import numpy as np

from tsr_tpu_torch.kernels import _build

SOURCE = Path(__file__).resolve().parent / "tsrio.cpp"
BUILD_DIR = _build.BUILD_DIR.parent / "tsr_tpu_torch_native"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")
LIBS = ("-lz",)
_FORMATS = {"png": 0, "ppm": 1}

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None

Images = Union[np.ndarray, Sequence[np.ndarray]]


def library_path() -> Path:
    return _build.hashed_library(SOURCE, CXX_FLAGS + LIBS, BUILD_DIR)


def build() -> Path:
    """Compile the library if it is missing; raises with g++'s output when
    the build fails."""
    out = library_path()
    if out.exists():
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the IO library cannot be built")
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE),
                           *LIBS], capture_output=True, text=True,
                          timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed for {SOURCE}:\n{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    return out


def _lib() -> ctypes.CDLL:
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            u8p = ctypes.POINTER(ctypes.c_uint8)
            lib.tsrio_load_batch.restype = ctypes.c_int
            lib.tsrio_load_batch.argtypes = [
                ctypes.c_char_p, ctypes.c_int, ctypes.c_int, u8p,
                ctypes.c_int]
            lib.tsrio_decode.restype = ctypes.c_int
            lib.tsrio_decode.argtypes = [
                ctypes.c_char_p, u8p, ctypes.c_long,
                ctypes.POINTER(ctypes.c_int)]
            lib.tsrio_probe.restype = ctypes.c_int
            lib.tsrio_probe.argtypes = [
                ctypes.c_char_p, ctypes.c_int, ctypes.POINTER(ctypes.c_int),
                ctypes.c_int]
            lib.tsrio_load_canvas.restype = ctypes.c_int
            lib.tsrio_load_canvas.argtypes = [
                ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, u8p,
                ctypes.POINTER(ctypes.c_int), ctypes.c_int]
            lib.tsrio_write_batch.restype = ctypes.c_int
            lib.tsrio_write_batch.argtypes = [
                ctypes.c_char_p, ctypes.c_int, ctypes.POINTER(ctypes.c_int),
                ctypes.POINTER(ctypes.c_void_p), ctypes.c_int, ctypes.c_int]
            _LIB = lib
        return _LIB


def _joined(paths: Sequence[str]) -> bytes:
    paths = [os.fspath(p) for p in paths]
    if any("\n" in p for p in paths):
        raise ValueError("a path holds a newline")
    return "\n".join(paths).encode()


def decode(path: str, max_side: int = 4096) -> np.ndarray:
    """Decode one PNG/PPM/BMP at native size -> uint8 ``[H, W, 3]`` RGB."""
    cap = max_side * max_side * 3
    buf = np.empty(cap, np.uint8)
    dims = (ctypes.c_int * 2)()
    ok = _lib().tsrio_decode(
        os.fspath(path).encode(),
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), cap, dims)
    if not ok:
        raise RuntimeError(f"tsrio failed to decode {path}")
    w, h = dims[0], dims[1]
    return buf[:w * h * 3].reshape(h, w, 3).copy()


def load_batch(paths: Sequence[str], size: int, threads: int = 8
               ) -> np.ndarray:
    """Decode and bilinear-resize ``paths`` into a uint8 ``[N, size, size,
    3]`` RGB batch; raises if any image fails."""
    out = np.empty((len(paths), size, size, 3), np.uint8)
    if not len(paths):
        return out
    ok = _lib().tsrio_load_batch(
        _joined(paths), len(paths), size,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), threads)
    if ok != len(paths):
        raise RuntimeError(f"tsrio decoded {ok}/{len(paths)} images")
    return out


def probe(paths: Sequence[str], threads: int = 8) -> np.ndarray:
    """``(h, w)`` of each image from its file header alone, as int32
    ``[N, 2]``; raises if any header does not parse."""
    dims = np.zeros((len(paths), 2), np.int32)
    if not len(paths):
        return dims
    ok = _lib().tsrio_probe(
        _joined(paths), len(paths),
        dims.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), threads)
    if ok != len(paths):
        raise RuntimeError(f"tsrio probed {ok}/{len(paths)} image headers")
    return dims


def load_canvas(paths: Sequence[str], out: np.ndarray, resize_to: int = 0,
                reflect: bool = False, threads: int = 8) -> np.ndarray:
    """Decode ``paths`` at native size into ``out`` (uint8 ``[N, H, W, 3]``,
    C-contiguous, written in place), each image at the top-left of its
    slot and the rest of the slot zeros or, with ``reflect``, the image's
    reflect-101 continuation tiled as ``offline._pad_reflect`` tiles it.
    With ``resize_to > 0`` an image with a side >= ``resize_to`` is
    resized (as :func:`load_batch`) to fill a ``resize_to`` x
    ``resize_to`` slot. Returns each image's ``(h, w)`` in ``out`` as int32
    ``[N, 2]``; raises if an image fails or does not fit its slot."""
    if (out.dtype != np.uint8 or out.ndim != 4 or out.shape[3] != 3
            or out.shape[0] != len(paths)
            or not out.flags["C_CONTIGUOUS"]):
        raise ValueError(f"out must be C-contiguous uint8 [{len(paths)}, "
                         f"H, W, 3], got {out.dtype} {out.shape}")
    dims = np.zeros((len(paths), 2), np.int32)
    if not len(paths):
        return dims
    ok = _lib().tsrio_load_canvas(
        _joined(paths), len(paths), out.shape[1], out.shape[2], resize_to,
        int(reflect), out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        dims.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), threads)
    if ok != len(paths):
        raise RuntimeError(f"tsrio loaded {ok}/{len(paths)} images into "
                           f"[{out.shape[1]}, {out.shape[2]}] slots")
    return dims


def _write(paths: Sequence[str], images: Images, fmt: str,
           threads: int) -> None:
    images = [np.ascontiguousarray(im, np.uint8) for im in images]
    if len(images) != len(paths):
        raise ValueError(f"{len(images)} images for {len(paths)} paths")
    if any(im.ndim != 3 or im.shape[2] != 3 for im in images):
        raise ValueError("images must be uint8 [H, W, 3]")
    if not images:
        return
    dims = (ctypes.c_int * (2 * len(images)))(
        *[d for im in images for d in im.shape[:2]])
    ptrs = (ctypes.c_void_p * len(images))(*[im.ctypes.data for im in images])
    ok = _lib().tsrio_write_batch(_joined(paths), len(images), dims, ptrs,
                                  _FORMATS[fmt], threads)
    if ok != len(images):
        raise RuntimeError(f"tsrio wrote {ok}/{len(images)} {fmt} files")


def write_png_batch(paths: Sequence[str], images: Images,
                    threads: int = 8) -> None:
    """Threaded PNG encode + write of uint8 RGB images (a ``[N, H, W, 3]``
    batch or a sequence of ``[h, w, 3]`` arrays of any sizes). Parent
    directories must exist; raises on any failure."""
    _write(paths, images, "png", threads)


def write_images(paths: Sequence[str], images: Images,
                 threads: int = 8) -> None:
    """Write each image in the format its path's suffix names: ``.png`` or
    binary ``.ppm`` (P6); any other suffix raises."""
    groups = {}
    for p, im in zip(paths, images):
        fmt = Path(p).suffix.lower()[1:]
        if fmt not in _FORMATS:
            raise ValueError(f"cannot write {p}: the port writes .png and "
                             ".ppm only")
        groups.setdefault(fmt, ([], []))
        groups[fmt][0].append(p)
        groups[fmt][1].append(im)
    if len(paths) != len(images):
        raise ValueError(f"{len(images)} images for {len(paths)} paths")
    for fmt, (ps, ims) in groups.items():
        _write(ps, ims, fmt, threads)
