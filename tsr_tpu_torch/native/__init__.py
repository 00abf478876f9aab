"""The port's image IO: ``tsrio.cpp``, ``jpeg.cpp``, ``formats.cpp``,
``gif.cpp``, ``hdr.cpp``, ``tiff.cpp``, ``webp.cpp``, ``vp8.cpp`` and
``jpeg2000.cpp`` bound with ``ctypes``.

The port's own copy of ``tsr_tpu/native`` and its only codec (no module of
the port imports cv2 or PIL, and the library links nothing but zlib). It
reads every file the reference reads, as the reference does: with
``cv2.imread``'s pixels, else, where cv2 gives None, with those of PIL's
``convert("RGB")``, the reference's fallback. PNG of any bit depth, color
type and interlacing; PNM (ASCII P1-P3, binary P4-P6, any maxval) and PAM
(P7); BMP (palette, 16/24/32-bit, BI_BITFIELDS, RLE8/RLE4, the OS/2 core
header); GIF (the first frame, as OpenCV's own decoder composes it) and
Sun raster (1/8/24/32-bit; run-length encoded and RGB-ordered ones as PIL
reads them, which OpenCV refuses); PFM (colour as cv2 reads it: either byte
order, divided by the scale's magnitude, rounded to 8 bits; gray as PIL
reads it, which cv2 refuses) and Radiance HDR (run-length encoded or flat,
x 255 and rounded); TIFF (classic or BigTIFF, either byte order, the
first IFD, strips or tiles of gray, RGB or palette samples of 1 to 16 bits
with any extra samples, CMYK, YCbCr at any subsampling and CIELAB, either
planar configuration and fill order, uncompressed, PackBits, LZW, deflate,
CCITT RLE, group 3, group 4, RLE/W, JPEG or ThunderScan, SGILog's LogL and
LogLuv as cv2 reads them, or a compression that names no codec,
orientations as cv2 applies them, else as PIL does; Pillow's 32-bit,
float, 16-bit signed and 12-bit modes and old-style JPEG as PIL reads
them); WebP (the RIFF container, a still image or an animation's first
frame on its zeroed canvas; lossless VP8L with every transform, colour
cache and prefix code; lossy VP8 with its segments, loop filters, token
partitions and ALPH chunk, upsampled as libwebp upsamples it; a raw VP8L
stream, a raw VP8 stream whose first partition ends inside 32 bytes, the
EXIF orientation and cv2's 32-byte and 64 MiB limits as cv2 reads them,
the files under 32 bytes as PIL reads them); JPEG 2000 (a JP2 file or a
raw codestream: lossless 5/3 and lossy 9/7, tiles and tile-parts, layers,
the five progression orders and POC, precincts, every code-block style,
SOP and EPH, PPM and PPT, RGN, components of 1-16 bits; the JP2 colour
boxes: pclr and cmap, cdef, sYCC, ICC, CIELab and CMYK colr; HTJ2K's HT
code-blocks, their cleanup, SigProp and MagRef passes, and the CAP and CPF
markers; Part 2's CBD, MCT, MCC and MCO markers, whose offset arrays set
each tile's DC level shift; as OpenJPEG 2.5 decodes it for cv2, which
refuses signed
samples, precisions under 8, an image offset, more than 4 components,
CMYK and eYCC, and reads sYCC through its own YUV matrix, and for PIL,
which reads CMYK, its own palette and sYCC where cv2 does not; sub-sampled
components are left out); JPEG
(baseline, progressive and arithmetic coded, CMYK and YCCK, data cut short
or corrupt as libjpeg recovers it, FF FF 00 in entropy data as
libjpeg-turbo's fast and slow Huffman passes read it, lossless); EXIF
orientation applied as
cv2 applies it, in PNG's eXIf too. Damaged files read as cv2 or PIL read
them (``formats.cpp``, ``gif.cpp`` and ``tiff.cpp`` copy both readers,
``hdr.cpp`` cv2's: PIL reads no HDR). Data of a format cv2 reads and the
port does not decode (:data:`FORMATS`: JPEG 2000 of sub-sampled
components, AVIF, and TIFF of
another layout: LZMA or ZSTD compression,
Pillow's LAB...), or
that only
PIL reads and the port does not decode (PCX, SGI, ICO/CUR, DDS, QOI, ICNS,
MSP, IM, SPIDER, told by Pillow's own checks of the first bytes), raises
naming the format. Image sizes follow the reference's rules: cv2's (where
``cv2.imread`` raises, the port raises too, and never falls back to PIL),
and Pillow's limit on the files only PIL reads. It writes ``.ppm``,
``.bmp`` and
``.jpg``/``.jpeg`` files byte-equal to
``cv2.imwrite``'s at its defaults, and ``.png`` files pixel-equal to
cv2's. Around the
codecs: a cv2.INTER_LINEAR-convention bilinear resize (within 1 LSB of
cv2) or PIL's BILINEAR resize (bit-equal to PIL), header probes and whole
batches decoded into padded canvases on native threads (one call a batch,
so the tree walks' Python threads stay off the interpreter lock), and
threaded writers (:func:`write_png_batch`, :func:`write_images`).

A JPEG that uses a feature the codec does not implement (:data:`FEATURES`)
raises a ``RuntimeError`` that names it. ``g++`` builds the sources on
first use into ``build/tsr_tpu_torch_native/`` at the root of the
checkout; the library's name carries a hash of every source, the shared
header and the flags (``kernels/_build.py``). The flags leave out
``-march=native``, so a library built on one x86-64 host loads on
another, and keep every floating-point step unfused
(``-ffp-contract=off``), as libtiff's SGILog and CIELAB conversions take
them. A failed build, decode or write raises.
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

_HERE = Path(__file__).resolve().parent
SOURCES = (_HERE / "tsrio.cpp", _HERE / "jpeg.cpp", _HERE / "formats.cpp",
           _HERE / "gif.cpp", _HERE / "hdr.cpp", _HERE / "tiff.cpp",
           _HERE / "webp.cpp", _HERE / "vp8.cpp", _HERE / "jpeg2000.cpp")
HEADERS = (_HERE / "codec.h", _HERE / "ht_tables.h")
BUILD_DIR = _build.BUILD_DIR.parent / "tsr_tpu_torch_native"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread",
             "-ffp-contract=off")
LIBS = ("-lz",)
# suffix -> the writer's format code
_FORMATS = {".png": 0, ".ppm": 1, ".jpg": 2, ".jpeg": 2, ".bmp": 3}
# a failed decode's or probe's negative status -> the JPEG feature it
# names, in codec.h's order (0 is a file that does not parse)
FEATURES = (
    "a sample precision other than 8 bits (12-bit JPEG)",
    "hierarchical JPEG",
    "a component count other than 1, 3 or 4",
    "lossless arithmetic coding",
    "a lossless JPEG in YCbCr or YCCK (a color transform)",
)
# the formats cv2.imread reads and the port does not decode, told by their
# signatures, then those only PIL reads (by Pillow's own checks of the first
# bytes), in codec.h's order after FEATURES
FORMATS = ("TIFF", "JPEG 2000", "AVIF", "PCX", "SGI", "ICO/CUR", "DDS",
           "QOI", "ICNS", "MSP", "IM", "SPIDER")
_READERS = {"port": 0, "cv2": 1}
_RESIZE_MODES = {"cv2": 0, "pil": 1}

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None

Images = Union[np.ndarray, Sequence[np.ndarray]]


def library_path() -> Path:
    return _build.hashed_library(SOURCES + HEADERS, CXX_FLAGS + LIBS,
                                 BUILD_DIR)


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
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp),
                           *map(str, SOURCES), *LIBS], capture_output=True,
                          text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed for {SOURCES}:\n{proc.stderr}")
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
                ctypes.c_int, ctypes.c_int]
            lib.tsrio_decode.restype = ctypes.c_int
            lib.tsrio_decode.argtypes = [
                ctypes.c_char_p, ctypes.POINTER(ctypes.c_int),
                ctypes.POINTER(ctypes.c_void_p),
                ctypes.POINTER(ctypes.c_void_p)]
            lib.tsrio_release.restype = None
            lib.tsrio_release.argtypes = [ctypes.c_void_p]
            lib.tsrio_probe.restype = ctypes.c_int
            lib.tsrio_probe.argtypes = [
                ctypes.c_char_p, ctypes.c_int, ctypes.POINTER(ctypes.c_int),
                ctypes.c_int, ctypes.c_int]
            lib.tsrio_load_canvas.restype = ctypes.c_int
            lib.tsrio_load_canvas.argtypes = [
                ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, u8p,
                ctypes.POINTER(ctypes.c_int), ctypes.c_int]
            lib.tsrio_write_batch.restype = ctypes.c_int
            lib.tsrio_write_batch.argtypes = [
                ctypes.c_char_p, ctypes.c_int, ctypes.POINTER(ctypes.c_int),
                ctypes.POINTER(ctypes.c_void_p), ctypes.c_int, ctypes.c_int]
            lib.tsrio_webp_lossy_planes.restype = ctypes.c_int
            lib.tsrio_webp_lossy_planes.argtypes = [
                ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int, u8p,
                ctypes.c_size_t, ctypes.POINTER(ctypes.c_int)]
            lib.tsrio_jpeg2000_planes.restype = ctypes.c_int
            lib.tsrio_jpeg2000_planes.argtypes = [
                ctypes.c_char_p, ctypes.c_size_t,
                ctypes.POINTER(ctypes.c_int32), ctypes.c_size_t,
                ctypes.POINTER(ctypes.c_int)]
            _LIB = lib
        return _LIB


def _joined(paths: Sequence[str]) -> bytes:
    paths = [os.fspath(p) for p in paths]
    if any("\n" in p for p in paths):
        raise ValueError("a path holds a newline")
    return "\n".join(paths).encode()


RAISES = 2  # codec.h's kRaises: cv2.imread raises on the file


def _failure(path, status: int) -> RuntimeError:
    """The error of a decode or probe of ``path`` that gave ``status``."""
    if status == RAISES:
        return RuntimeError(f"tsrio refuses {path}: cv2.imread raises on it "
                            "(its header gives a side of 0 or past 2^20, "
                            "or more than 2^30 pixels)")
    if -len(FEATURES) <= status < 0:
        return RuntimeError(f"tsrio cannot decode {path}: it uses "
                            f"{FEATURES[-status - 1]}, which the port's "
                            "JPEG decoder does not implement")
    if status < 0:
        return RuntimeError(f"tsrio cannot decode {path}: it holds "
                            f"{FORMATS[-status - 1 - len(FEATURES)]} data, "
                            "which the port does not decode")
    return RuntimeError(f"tsrio failed to decode {path}")


def _first_failure(paths: Sequence[str], decoded: int) -> RuntimeError:
    """The error of a batch decode that decoded ``decoded`` of ``paths``,
    with the error of the first path that fails to decode alone."""
    for p in paths:
        try:
            decode(p)
        except RuntimeError as e:
            return RuntimeError(f"tsrio decoded {decoded}/{len(paths)} "
                                f"images: {e}")
    return RuntimeError(f"tsrio decoded {decoded}/{len(paths)} images")


def decode(path: str) -> np.ndarray:
    """Decode one image at native size -> uint8 ``[H, W, 3]`` RGB, as
    ``cv2.imread(path)[:, :, ::-1]`` decodes it (else as PIL's
    ``convert("RGB")``, the reference's fallback), into an array sized from
    the decoded image; raises a ``RuntimeError`` where it fails (an image
    too large for the host's memory among them)."""
    dims = (ctypes.c_int * 2)()
    handle, pixels = ctypes.c_void_p(), ctypes.c_void_p()
    lib = _lib()
    status = lib.tsrio_decode(os.fspath(path).encode(), dims,
                              ctypes.byref(handle), ctypes.byref(pixels))
    if status != 1:
        raise _failure(path, status)
    try:
        w, h = dims[0], dims[1]
        out = np.empty((h, w, 3), np.uint8)
        ctypes.memmove(out.ctypes.data, pixels, out.nbytes)
    finally:
        lib.tsrio_release(handle)
    return out


def load_batch(paths: Sequence[str], size: int, threads: int = 8,
               resize: str = "cv2") -> np.ndarray:
    """Decode and bilinear-resize ``paths`` into a uint8 ``[N, size, size,
    3]`` RGB batch; raises if any image fails. ``resize`` is ``"cv2"``
    (cv2.INTER_LINEAR's convention, within 1 LSB of cv2) or ``"pil"``
    (bit-equal to PIL's ``Image.resize(..., BILINEAR)``, which
    antialiases a downscale)."""
    if resize not in _RESIZE_MODES:
        raise ValueError(f"unknown resize {resize!r}; one of "
                         f"{tuple(_RESIZE_MODES)}")
    out = np.empty((len(paths), size, size, 3), np.uint8)
    if not len(paths):
        return out
    ok = _lib().tsrio_load_batch(
        _joined(paths), len(paths), size,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), threads,
        _RESIZE_MODES[resize])
    if ok != len(paths):
        raise _first_failure(paths, ok)
    return out


def probe(paths: Sequence[str], threads: int = 8, reader: str = "port",
          raises: bool = False):
    """``(h, w)`` of each image as :func:`decode` gives it (EXIF
    orientation applied), as int32 ``[N, 2]``.

    ``reader="port"`` reads each file's header alone (cv2's header, else
    PIL's) and raises if one does not parse, names a feature of
    :data:`FEATURES` or a format of :data:`FORMATS`.
    ``reader="cv2"`` never raises: it gives ``(0, 0)`` exactly where
    ``cv2.imread`` gives None, reading each whole file as cv2 does, short of
    storing its pixels:

    - JPEG: its markers and entropy data (a header that does not parse,
      damage libjpeg refuses, a feature of :data:`FEATURES`, and gray
      lossless JPEG, which the port reads as PIL does);
    - PNG: libpng's rules: a bad CRC on IHDR, PLTE (palette images) or
      IDAT, an unknown critical chunk or a chunk name that is not letters,
      a zlib stream that errs or ends before the last row (after it, its
      errors and extra data are warnings), a filter type past 4, IDATs
      that are not consecutive, and a missing or cut IEND (its CRC
      unchecked; bytes after it ignored) refuse the file; a bad ancillary
      CRC does not;
    - PNM and PAM: every sample the header promises (an ASCII number but
      a P1 digit must be followed by a byte; a binary body may not be
      short), cv2's header rules (PAM: "P7" then a line break, known
      fields, a TUPLTYPE that fits DEPTH);
    - BMP: every row of the body, padding included, or an RLE stream that
      reaches the last row (RLE4 needs an end-of-line code after it);
      cv2's header rules (a 16-bit BI_BITFIELDS file takes its masks from
      after the header, so one with them only inside a V2-V5 header is
      refused);
    - GIF: every block up to the trailer (a byte between blocks that is
      none of ``!``, ``,`` and ``;`` refuses the file), then the first
      frame: a graphic control extension of 4 bytes and a disposal method
      of 0-3, a frame inside the logical screen, a minimum code size of
      2-11, an LZW stream that fills the frame exactly (a code past the
      table, a string past the last pixel, or data after it that does not
      end its block refuses it), every index in a colour table;
    - Sun raster: RT_OLD or RT_STANDARD (RT_BYTE_ENCODED and RT_FORMAT_RGB,
      which PIL reads, are refused), 1, 8, 24 or 32 bits, no map or an
      RMT_EQUAL_RGB map of at most 2^depth entries (1 and 8 bits), every
      row padded to 16 bits;
    - PFM: colour "PF" only (a gray "Pf", which PIL reads and the port
      decodes as PIL does, is refused), a line feed after the magic, each
      field ended by one whitespace byte and no byte past 127 in it, a
      nonzero scale, every row of the body;
    - Radiance HDR: a "FORMAT=32-bit_rle_rgbe" line before the blank line
      that ends the header, a "-Y h +X w" resolution line (any other
      orientation is refused), every scanline present, each run or literal
      inside its scanline and each RLE scanline of the header's width;
    - TIFF (classic or BigTIFF, the first IFD): libtiff's directory rules
      (the first of duplicate tags wins; a bad ImageWidth, ImageLength,
      RowsPerStrip, TileWidth, TileLength, SamplesPerPixel, Compression,
      BitsPerSample, SampleFormat, PlanarConfiguration or ExtraSamples, or
      no strip or tile offsets, refuses the file; a palette without a
      usable ColorMap reads gray; a missing or implausible byte count is
      estimated), then OpenCV's: a Photometric tag, samples of 1, 8 or 16
      bits (4 of a palette; LogLuv's of any that libtiff's RGBA reader
      reads at 8), at most 4 a pixel, a layout libtiff's RGBA reader takes, the first plane's strips or tiles each with a nonzero
      byte count inside the file (an uncompressed tile of its exact size;
      a chunk that fails to decode reads as far as it decoded, the rest
      0; a JPEG stream libtiff's checks refuse, a codec OpenCV's build
      leaves out, a codec whose setup refuses the layout: NeXT at every
      depth, ThunderScan of other than 4 bits, SGILog of other than LogL
      or LogLuv data), and an orientation of 1-4 (5-8 give None
      but for a square image; the port decodes them as PIL does, rotated);
    - WebP (``RIFF`` ``WEBP``, or a raw VP8L or VP8 stream): 32 bytes or
      more and at most 64 MiB, the first 32 accepted by WebPGetFeatures (a
      raw VP8 stream's first partition must end inside them); a still
      image (libwebp's header parse over the whole file, its VP8L data or
      last VP8 token partition allowed to run on past its chunk) or an
      animation (WebPDemux: every chunk and frame, a frame inside its
      canvas), then the VP8L stream (each prefix code complete, every
      backward reference inside the image, no read past the data) or the
      VP8 frame (a key frame, its partitions inside the data, no mode row
      or macroblock past the end of its partition) and its ALPH chunk
      (the header byte's method, pre-processing and reserved bits; the raw
      size, or a VP8L stream as above); the EXIF orientation applied where
      WebPDemux accepts the file and the VP8X flag stores the chunk;
    - JPEG 2000 (a JP2 file or a raw codestream): OpenJPEG 2.5's strict
      reading of the JP2 boxes, the main header, every tile-part and
      packet, and its checks of the cdef and cmap boxes, then cv2's rules
      (1-4 components, none signed, a precision of 8 or more, no image
      offset, no CMYK or eYCC colour space, 3 components or more after
      the palette unless the colour space is gray);
    - any format of :data:`FORMATS` is refused (cv2 reads it; the port
      does not decode it).

    A header whose size imread's validateInputImageSize refuses (a side of
    0 or past 2^20, more than 2^30 pixels; checked once the format's own
    header parser has accepted the numbers: a PNG's chunks up to its first
    IDAT, a JPEG's markers up to its first SOS, a GIF's every block, a
    TIFF's directory) makes cv2.imread raise, not give None: the reference
    reads no pixels of the file and does not fall back to PIL. The cv2
    probe gives ``(0, 0)`` for it too; with ``raises=True`` it returns
    ``(dims, raised)``, ``raised`` a bool ``[N]`` array that marks these
    files (``reader="cv2"`` only). The reader paths raise on them, and on
    an image past PIL's limit (2 x ``Image.MAX_IMAGE_PIXELS``) that cv2
    does not read."""
    if reader not in _READERS:
        raise ValueError(f"unknown reader {reader!r}; one of "
                         f"{tuple(_READERS)}")
    if raises and reader != "cv2":
        raise ValueError("raises=True needs reader='cv2'")
    dims = np.zeros((len(paths), 2), np.int32)
    if not len(paths):
        return (dims, np.zeros(0, bool)) if raises else dims
    ok = _lib().tsrio_probe(
        _joined(paths), len(paths),
        dims.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), threads,
        _READERS[reader])
    raised = (dims[:, 0] == 0) & (dims[:, 1] == RAISES)
    if ok != len(paths):
        if reader == "port":
            for p, (h, status) in zip(paths, dims.tolist()):
                if h == 0:
                    raise RuntimeError(f"tsrio probed {ok}/{len(paths)} "
                                       f"image headers: "
                                       f"{_failure(p, status)}")
        dims[dims[:, 0] == 0] = 0
    return (dims, raised) if raises else dims


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
        for p, (h, status) in zip(paths, dims.tolist()):
            if h == 0 and status not in (0, 1):
                raise RuntimeError(f"tsrio loaded {ok}/{len(paths)} images:"
                                   f" {_failure(p, status)}")
        raise RuntimeError(f"tsrio loaded {ok}/{len(paths)} images into "
                           f"[{out.shape[1]}, {out.shape[2]}] slots")
    return dims


def _write(paths: Sequence[str], images: Images, fmt: str,
           threads: int) -> None:
    """Writes ``images`` to ``paths`` in format ``fmt`` (a suffix of
    :data:`_FORMATS`)."""
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
    _write(paths, images, ".png", threads)


def write_images(paths: Sequence[str], images: Images,
                 threads: int = 8) -> None:
    """Write each image in the format its path's suffix names: ``.png``,
    binary ``.ppm`` (P6), ``.bmp`` (24-bit) or ``.jpg``/``.jpeg`` (baseline
    JFIF, quality 95, 4:2:0), each byte-equal to what ``cv2.imwrite``
    writes at its defaults (PNG: pixel-equal); any other suffix raises."""
    groups = {}
    for p, im in zip(paths, images):
        fmt = Path(p).suffix.lower()
        if fmt not in _FORMATS:
            raise ValueError(f"cannot write {p}: the port writes "
                             f"{', '.join(sorted(_FORMATS))} only")
        groups.setdefault(fmt, ([], []))
        groups[fmt][0].append(p)
        groups[fmt][1].append(im)
    if len(paths) != len(images):
        raise ValueError(f"{len(images)} images for {len(paths)} paths")
    for fmt, (ps, ims) in groups.items():
        _write(ps, ims, fmt, threads)
