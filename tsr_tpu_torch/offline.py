"""Offline dataset generation: distorted file trees from clean file trees.

Port of ``tsr_tpu/offline.py`` (the reference's offline generators,
ref:02/03/04 and ref:16): read each ``<class>/<img>`` of the clean tree,
distort it at **native resolution** (the reference distorts before its
transforms resize, so blur strength is relative to native pixels), and
write it to a mirrored tree (the source's suffix kept for noise/blur/fog
and the ``*_rand`` kinds per ref:02:47-54, so a ``.jpg`` tree gives
``.jpg`` trees; ``.png`` for compound per ref:16:55).

Native sizes vary per image, so images are **bucketed**: reflect-101-padded
up to the next bucket size, distorted as a batch on the device, and cropped
back. For pointwise distortions the pad is irrelevant; for blur,
reflect-101 padding composes exactly with ``filter2d``'s own reflect-101
border (the kernels B2/B3 on the card) where the pad is 0 or at least the
kernel's bottom/right halo, so a blurring kind takes the next bucket that
leaves that room (``_bucket_with_room``) and the cropped result equals
native-size processing. Decoding and writing go through the port's IO
library (``tsr_tpu_torch.native``), which reads and writes every suffix of
``gtsrb.IMG_EXTENSIONS`` as cv2 does (JPEG at cv2.imwrite's defaults). A
file that cv2.imread would not read, damaged or not, is skipped, as the
reference skips it (``native.probe(..., reader="cv2")``, a whole read of
each file).
"""

from __future__ import annotations

import concurrent.futures as cf
import json
from collections import Counter
from pathlib import Path
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from tsr_tpu_torch import configs, native
from tsr_tpu_torch.data import gtsrb
from tsr_tpu_torch.device import as_tensor, resolve_device
from tsr_tpu_torch.ops import blur as blur_ops
from tsr_tpu_torch.ops import distortions
from tsr_tpu_torch.ops import image as image_ops

BUCKETS = (32, 48, 64, 96, 128, 160, 192, 224, 256)


def _bucket(n: int) -> int:
    for b in BUCKETS:
        if n <= b:
            return b
    return ((n + 31) // 32) * 32


def _halo(ksize: int) -> int:
    """Rows (columns) a ``ksize`` correlation reads below (right of) its
    anchor ``ksize // 2``."""
    return ksize - 1 - ksize // 2


def _bucket_with_room(n: int, halo: int) -> int:
    """The smallest bucket that equals ``n`` or pads it by at least
    ``halo``. Bucket padding composes with ``filter2d``'s reflect-101
    border only then: with a pad of 1 to ``halo - 1`` the filter reads
    past the canvas and reflects the canvas, not the image (the
    reference's ``_bucket`` alone misses this: ROADMAP section C)."""
    b = _bucket(n)
    while 0 < b - n < halo:
        b = _bucket(b + 1)
    return b


def _pad_reflect(img: np.ndarray, h: int, w: int) -> np.ndarray:
    """``img`` reflect-101-padded at the bottom and right to ``(h, w)``,
    the reflection tiled where the image is smaller than the pad: the
    reference's padding, and the plain version of what
    ``native.load_canvas(reflect=True)`` writes for a whole batch."""
    ph, pw = h - img.shape[0], w - img.shape[1]
    if ph == 0 and pw == 0:
        return img
    # A side of 1 cannot reflect (a pad of dim-1 == 0 would spin the loop
    # below forever on a 1xN crop): edge-pad it to 2 first.
    out = img
    if out.shape[0] == 1 or out.shape[1] == 1:
        out = np.pad(out, ((0, int(out.shape[0] == 1)),
                           (0, int(out.shape[1] == 1)), (0, 0)),
                     mode="edge")
    while out.shape[0] < h or out.shape[1] < w:
        eh = min(h - out.shape[0], out.shape[0] - 1)
        ew = min(w - out.shape[1], out.shape[1] - 1)
        out = np.pad(out, ((0, max(eh, 0)), (0, max(ew, 0)), (0, 0)),
                     mode="reflect")
    return out[:h, :w]


# --------------------------------------------------------------- the kinds
# Each takes the padded uint8 batch on its device and a torch.Generator on
# the same device, plus its draws as keywords (a test injects the JAX
# reference's), and returns the distorted uint8 batch.

def _noise(x, g, noise=None):
    return distortions.add_gaussian_noise(
        x, g, var=configs.NoiseConfig().var, device=x.device, noise=noise)


def _blur(x, g):
    # no final min-max renormalize here (ref:03:29): that stage is per
    # image over native pixels only, so it runs after the bucket pad is
    # cropped off (see _POST); on a low-contrast image the pad's blur halo
    # would shift the min/max
    cfg = configs.BlurConfig()
    return distortions.apply_motion_blur(x, cfg.degree, cfg.angle,
                                         minmax_normalize=False,
                                         device=x.device)


def _fog(x, g, jitter=None):
    return distortions.add_fog(x, g,
                               fog_intensity=configs.FogConfig().intensity,
                               device=x.device, jitter=jitter)


def _compound(x, g, noise=None):
    return distortions.apply_compound_distortion(x, g, device=x.device,
                                                 noise=noise)


# Strength-jittered variants (--strength-jitter on scripts 02/03/04): the
# strength is drawn per image. The ranges bracket the reference's severe
# offline points (noise var 0.02 ref:02:23, blur degree 12 ref:03:34, fog
# intensity 0.8 ref:04:42) and the mild cascade stress (0.01 / 5 / 0.1,
# ref:13:33-56).

def _uniform(b, lo, hi, g, device):
    return torch.rand(b, generator=g, device=device) * (hi - lo) + lo


def _noise_rand(x, g, var=None, noise=None):
    if var is None:
        var = _uniform(x.shape[0], 0.005, 0.03, g, x.device)
    return distortions.add_gaussian_noise(x, g, var=var, device=x.device,
                                          noise=noise)


def _fog_rand(x, g, intensity=None):
    # per-image intensity, t = 1 - i (the mild chain's form, ref:13:51),
    # spanning t in [0.15, 0.95] before the default clip
    if intensity is None:
        intensity = _uniform(x.shape[0], 0.05, 0.85, g, x.device)
    return distortions.add_fog(x, None, fog_intensity=intensity,
                               t_jitter=None, device=x.device)


def _blur_rand(x, g, degrees=None, angles=None):
    # per-sample kernels (B2 on the card); no min-max epilogue: this tree
    # trains cascade restorers whose deployment inputs (ref:13:40-47 mild
    # blur) are not renormalized either
    b = x.shape[0]
    if degrees is None:
        degrees = torch.randint(4, distortions.MAX_BLUR_DEGREE + 1, (b,),
                                generator=g, device=x.device)
    if angles is None:
        angles = _uniform(b, 0.0, 360.0, g, x.device)
    kernels = blur_ops.motion_blur_kernels(
        as_tensor(degrees, x.device), as_tensor(angles, x.device),
        max_degree=distortions.MAX_BLUR_DEGREE)
    blurred = blur_ops.filter2d(x.to(torch.float32), kernels)
    return image_ops.saturate_uint8(blurred, round=True)


# kind -> (fn(batch_u8, generator, **draws) -> batch_u8, output suffix or
# None to keep the source's); the reference's middle field, whether fn
# takes a key, is left out: every fn takes the generator and "blur" ignores
# it
KINDS: Dict[str, Tuple[Callable, Optional[str]]] = {
    "noise": (_noise, None),
    "blur": (_blur, None),
    "fog": (_fog, None),
    "compound": (_compound, ".png"),
    "noise_rand": (_noise_rand, None),
    "fog_rand": (_fog_rand, None),
    "blur_rand": (_blur_rand, None),
}


def _minmax_u8_host(img_u8: np.ndarray) -> np.ndarray:
    """``cv2.normalize(x, x, 0, 255, NORM_MINMAX)`` on one native-size uint8
    image (ref:03:29): joint min/max over pixels and channels, cvRound."""
    lo, hi = int(img_u8.min()), int(img_u8.max())
    if hi <= lo:
        return np.zeros_like(img_u8)
    scaled = (img_u8.astype(np.float32) - lo) * (255.0 / (hi - lo))
    return np.clip(np.rint(scaled), 0, 255).astype(np.uint8)


# per-image host-side epilogue applied after the bucket pad is cropped
_POST = {"blur": _minmax_u8_host}

# bottom/right halo of each blurring kind's kernel: its bucket pad must be
# 0 or at least this wide (_bucket_with_room)
HALO = {"blur": _halo(max(configs.BlurConfig().degree, 3)),
        "compound": _halo(configs.CompoundConfig().blur_degree),
        "blur_rand": _halo(distortions.MAX_BLUR_DEGREE)}


def tree_files(src_dir: str) -> List[Path]:
    """The tree's ``<class>/<img>`` files, sorted."""
    return sorted(p for p in Path(src_dir).glob("*/*")
                  if p.suffix.lower() in gtsrb.IMG_EXTENSIONS)


def bucketed_batches(files: List[Path], batch_size: int, halo: int = 0,
                     threads: int = 8, dims: Optional[np.ndarray] = None
                     ) -> Iterator[Tuple[Tuple[int, int], list, np.ndarray]]:
    """Group ``files`` by ``(bh, bw) = (_bucket_with_room(h, halo),
    _bucket_with_room(w, halo))`` of their native sizes (``dims``, or read
    from the headers) and yield ``((bh, bw), [(path, (h, w))], padded uint8
    [n, bh, bw, 3])`` for each chunk of ``batch_size``, buckets in sorted
    order. Each chunk is decoded straight into its canvas on native
    threads, the pad filled as :func:`_pad_reflect` fills it; a failure
    raises."""
    if dims is None:
        dims = native.probe([str(p) for p in files], threads=threads)
    groups: Dict[Tuple[int, int], list] = {}
    for p, (h, w) in zip(files, dims.tolist()):
        groups.setdefault((_bucket_with_room(h, halo),
                           _bucket_with_room(w, halo)), []).append((p, (h, w)))
    for (bh, bw), items in sorted(groups.items()):
        for s in range(0, len(items), batch_size):
            chunk = items[s:s + batch_size]
            batch = np.empty((len(chunk), bh, bw, 3), np.uint8)
            native.load_canvas([str(p) for p, _ in chunk], batch,
                               reflect=True, threads=threads)
            yield (bh, bw), chunk, batch


def generate_tree(
    src_dir: str,
    dst_dir: str,
    kind: str,
    seed: int = 0,
    batch_size: int = 256,
    log: Callable[[str], None] = print,
    device="cuda",
) -> int:
    """Distort every image under ``src_dir`` into ``dst_dir`` (class tree
    preserved) on ``device``. Returns the number of images written: a file
    cv2.imread would not read is skipped and counted in the log (with the
    skipped files' suffixes), as the reference skips it:
    ``native.probe(..., reader="cv2")`` reads each whole file as cv2 does
    first, then each batch is decoded into its canvas. Skipped: a header
    that does not parse; a JPEG with damage libjpeg refuses, 12-bit,
    hierarchical or gray lossless, of 2 components; a PNG, PNM, PAM or BMP
    cut short anywhere (a PNG up to the end of IEND), a PNG with a bad
    CRC on IHDR, PLTE (palette) or IDAT, a damaged zlib stream or filter
    byte, an unknown critical chunk; an ASCII PNM with a byte past its
    numbers missing or a comment glued to one; an RLE BMP whose stream stops
    before its last row; a 16-bit BMP with a V2-V5 header; a GIF cut
    anywhere before its trailer, with a byte between blocks that is no
    block, a first frame outside the screen, a disposal method past 3, a
    broken or short LZW stream or an index past its colour tables; a Sun
    raster cut short, run-length encoded (RT_BYTE_ENCODED) or of type
    RT_FORMAT_RGB; a gray PFM ("Pf"), a PFM cut short or of scale 0 or
    without a line feed after its magic; a Radiance HDR cut short, without
    its FORMAT=32-bit_rle_rgbe line, in any orientation but "-Y h +X w",
    with a run past its scanline or a scanline width not the header's; a
    TIFF whose directory libtiff refuses, without a Photometric tag, with a
    strip whose byte count is 0 or that runs past the end of the file, or of
    orientation 5-8; data of a format or TIFF layout the port does not
    decode (TIFF tiles and samples of other than 8 bits, BigTIFF, WebP,
    JPEG 2000, AVIF). PIL reads some of them (a gray PFM, a TIFF of
    orientation 5-8 among them), and the reader paths decode those as PIL
    does.

    A file on which cv2.imread raises (a header whose size imread's
    validateInputImageSize refuses: a side of 0 or past 2^20, more than
    2^30 pixels) stops the reference's generate_tree with a cv2.error after
    it has written the buckets that sort before that file's. This one
    raises a ``RuntimeError`` that names the file before it writes
    anything: ``dst_dir`` stays as it was.

    One generator seeded with ``seed`` draws a seed for each batch's own
    generator on ``device`` (the reference splits its key per batch), so a
    tree is reproducible from ``seed``. Writes ``dst_dir/.distortion``, the
    provenance marker (``kind``, ``seed``, ``images``) training scripts read
    to tell reference-exact severities from the jittered ``*_rand`` trees.
    """
    device = resolve_device(device)
    fn, suffix = KINDS[kind]
    post = _POST.get(kind)
    src = Path(src_dir)
    dst = Path(dst_dir)
    files = tree_files(src_dir)
    log(f"Found {len(files)} images, generating '{kind}' data...")
    dims, raised = native.probe([str(p) for p in files], reader="cv2",
                                raises=True)
    if raised.any():
        bad = [str(p) for p, r in zip(files, raised) if r]
        raise RuntimeError(
            f"cv2.imread raises on {bad[0]} (its header gives a side of 0 or "
            "past 2^20, or more than 2^30 pixels), so the reference's "
            f"generate_tree stops there; {len(bad)} such file(s), nothing "
            "written")
    readable = dims[:, 0] > 0
    if not readable.all():
        log(f"Skipped {int((~readable).sum())} unreadable files")
        skipped = Counter(p.suffix.lower() for p, ok in zip(files, readable)
                          if not ok)
        log("  by suffix: " + ", ".join(f"{k} {n}" for k, n in
                                        sorted(skipped.items())))
        files = [p for p, ok in zip(files, readable) if ok]
        dims = dims[readable]
    root = torch.Generator().manual_seed(seed)
    written = 0
    # the next batch's device work overlaps the last one's encode + write
    with cf.ThreadPoolExecutor(1) as writer:
        pending = []
        for _, chunk, batch in bucketed_batches(files, batch_size,
                                                HALO.get(kind, 0),
                                                dims=dims):
            sub = int(torch.randint(2 ** 62, (1,), generator=root))
            g = torch.Generator(device=device).manual_seed(sub)
            out = fn(as_tensor(batch, device), g).cpu().numpy()
            paths, crops = [], []
            for (p, (h, w)), o in zip(chunk, out):
                outp = dst / p.relative_to(src)
                if suffix:
                    outp = outp.with_suffix(suffix)
                outp.parent.mkdir(parents=True, exist_ok=True)
                crop = o[:h, :w]
                crops.append(post(crop) if post is not None else crop)
                paths.append(str(outp))
            pending.append(writer.submit(native.write_images, paths, crops))
            written += len(paths)
        for f in pending:
            f.result()  # re-raises a failed write
    dst.mkdir(parents=True, exist_ok=True)
    (dst / ".distortion").write_text(
        json.dumps({"kind": kind, "seed": seed, "images": written}))
    log(f"Done: {written} images -> {dst}")
    return written
