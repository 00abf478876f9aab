"""GTSRB-style image trees on the host: decode, resize, batch, prefetch.

Port of ``tsr_tpu/data/gtsrb.py``:

- :func:`download_gtsrb` (ref:01:5-18): fetch and unpack the training
  split, or raise with instructions where there is no network;
- :data:`IMG_EXTENSIONS`, the suffixes a tree walk collects;
- :func:`_decode_resize` / :func:`_decode_resize_batch`: decode and
  bilinear-resize through the port's IO library (``tsr_tpu_torch.native``)
  with the :data:`RESIZE_BACKEND` that :func:`set_resize_backend` picks:
  ``"cv2"`` (the cv2.INTER_LINEAR convention, within 1 LSB of
  ``cv2.resize``) or ``"pil"`` (bit-equal to PIL's BILINEAR);
- :class:`ImageFolder`: torchvision ``ImageFolder`` semantics (ref:05:32,
  06:39), classes the sorted subdirectory names, samples sorted per class;
- :class:`PairedFolder`: the restorers' (distorted, clean) pairs, matched
  by relative path with a ``.png`` fallback (ref:07:35-72), and
  :func:`train_val_split`;
- :func:`batches`: an epoch-based batch iterator with a background
  prefetch thread, standing in for DataLoader workers (ref:05:39, 07:137).

The IO library reads every suffix of :data:`IMG_EXTENSIONS` with
cv2.imread's pixels (else PIL's, the reference's fallback), whatever the
data under it: PPM/PGM (P6, P5, any maxval), PNG (any bit depth, color
type and interlacing), BMP (24/32-bit, 1/4/8-bit palette), GIF, TIFF and
the rest ``tsr_tpu_torch.native`` lists, and JPEG (baseline and
progressive, EXIF orientation applied), so a JPEG tree loads
as a PPM tree does, and ``PairedFolder(exts=(".jpg",))`` pairs a ``.jpg``
distorted file with its ``.jpg`` clean twin. A file it cannot decode
raises when it is loaded, and a JPEG that uses a feature the decoder does
not implement (arithmetic coding, 12-bit, lossless, hierarchical, CMYK)
raises naming it.
"""

from __future__ import annotations

import queue
import threading
from pathlib import Path
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from tsr_tpu_torch import configs, native

IMG_EXTENSIONS = (".ppm", ".png", ".jpg", ".jpeg", ".bmp")

DEFAULT_ROOT = "./data/gtsrb/GTSRB/Training"
GTSRB_URL = (
    "https://sid.erda.dk/public/archives/"
    "daaeac0d7ce1152aea9b61d9f1e19370/GTSRB-Training_fixed.zip"
)


def download_gtsrb(root: str = "./data") -> str:
    """Fetch and extract the GTSRB training split (ref:01:5-18).

    Returns the Training-tree path; an existing tree is returned without
    any network call. Without a network this raises with instructions
    rather than failing mysteriously.
    """
    target = Path(root) / "gtsrb" / "GTSRB" / "Training"
    if target.exists():
        return str(target)
    import io
    import urllib.request
    import zipfile

    try:
        with urllib.request.urlopen(GTSRB_URL, timeout=60) as r:
            data = r.read()
    except Exception as e:
        raise RuntimeError(
            f"Could not download GTSRB ({e}). If you have a copy, place the "
            f"class folders under {target} (ref layout: "
            "<Training>/<class>/<img>.ppm)."
        ) from e
    with zipfile.ZipFile(io.BytesIO(data)) as zf:
        zf.extractall(Path(root) / "gtsrb")
    return str(target)


# Host resize backend: "cv2" (the default, INTER_LINEAR's convention) or
# "pil" (PIL's BILINEAR, bit-equal: the reference's torchvision
# transforms.Resize, ref:05:24-29, 07:124-126). The two agree within 1 LSB
# on upscales (GTSRB is mostly 30-60 px -> 224), but PIL antialiases a
# DOWNSCALE where cv2 INTER_LINEAR does not (PARITY.md "Resize parity"):
# parity runs on trees holding sources larger than the model input should
# set "pil".
RESIZE_BACKEND = "cv2"


def set_resize_backend(backend: str) -> None:
    if backend not in ("cv2", "pil"):
        raise ValueError(f"unknown resize backend {backend!r}")
    global RESIZE_BACKEND
    RESIZE_BACKEND = backend


def _decode_resize(path: str, size: int) -> np.ndarray:
    """One image as uint8 ``[size, size, 3]`` RGB."""
    return native.load_batch([path], size, threads=1,
                             resize=RESIZE_BACKEND)[0]


def _decode_resize_batch(paths: Sequence[str], size: int,
                         threads: int = 8) -> np.ndarray:
    """``paths`` as a uint8 ``[N, size, size, 3]`` RGB batch, decoded and
    resized on ``threads`` native threads."""
    return native.load_batch(list(paths), size, threads=threads,
                             resize=RESIZE_BACKEND)


class ImageFolder:
    """torchvision-ImageFolder-equivalent directory scanner.

    ``classes`` are the sorted subdirectory names (the reference's label
    indexing, ref:05:32); ``samples`` is a list of (path, label).
    ``threads`` native threads decode each :meth:`load_batch`.
    """

    def __init__(self, root: str, size: int = configs.IMAGE_SIZE,
                 threads: int = 8):
        self.root = Path(root)
        self.size = size
        self.threads = threads
        if not self.root.exists():
            raise FileNotFoundError(f"{root} does not exist")
        self.classes = sorted(
            d.name for d in self.root.iterdir() if d.is_dir())
        self.class_to_idx = {c: i for i, c in enumerate(self.classes)}
        self.samples: List[Tuple[str, int]] = []
        for c in self.classes:
            for p in sorted((self.root / c).iterdir()):
                if p.suffix.lower() in IMG_EXTENSIONS:
                    self.samples.append((str(p), self.class_to_idx[c]))

    def __len__(self):
        return len(self.samples)

    def load(self, idx: int) -> Tuple[np.ndarray, int]:
        path, label = self.samples[idx]
        return _decode_resize(path, self.size), label

    def load_batch(self, indices) -> Tuple[np.ndarray, np.ndarray]:
        paths = [self.samples[i][0] for i in indices]
        labels = np.asarray([self.samples[i][1] for i in indices], np.int32)
        return _decode_resize_batch(paths, self.size, self.threads), labels


class PairedFolder:
    """(distorted, clean) pairs matched by relative path with ``.png``
    fallback (ref:07:44-55); ``threads`` native threads decode each
    :meth:`load_batch`."""

    def __init__(self, clean_root: str, distorted_root: str,
                 size: int = configs.IMAGE_SIZE,
                 exts: Sequence[str] = (".ppm",), threads: int = 8):
        self.size = size
        self.threads = threads
        clean_root = Path(clean_root)
        distorted_root = Path(distorted_root)
        clean_files: List[Path] = []
        for ext in exts:
            clean_files += list(clean_root.glob(f"*/*{ext}"))
        self.pairs: List[Tuple[str, str]] = []
        for c_path in sorted(clean_files):
            rel = c_path.relative_to(clean_root)
            d_path = distorted_root / rel
            if not d_path.exists():
                d_path = d_path.with_suffix(".png")
            if d_path.exists():
                self.pairs.append((str(d_path), str(c_path)))

    def __len__(self):
        return len(self.pairs)

    def load(self, idx: int) -> Tuple[np.ndarray, np.ndarray]:
        d, c = self.pairs[idx]
        return (_decode_resize(d, self.size), _decode_resize(c, self.size))

    def load_batch(self, indices) -> Tuple[np.ndarray, np.ndarray]:
        """``(distorted, clean)`` uint8 ``[N, size, size, 3]`` batches."""
        d_paths = [self.pairs[i][0] for i in indices]
        c_paths = [self.pairs[i][1] for i in indices]
        return (_decode_resize_batch(d_paths, self.size, self.threads),
                _decode_resize_batch(c_paths, self.size, self.threads))


def train_val_split(n: int, train_frac: float, seed: int = 0
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Random index split like torch.random_split (ref:05:35-37): numpy's
    ``default_rng(seed).permutation(n)``, the first ``int(train_frac *
    n)`` for training."""
    perm = np.random.default_rng(seed).permutation(n)
    k = int(train_frac * n)
    return perm[:k], perm[k:]


def batches(
    dataset,
    indices: Optional[np.ndarray] = None,
    batch_size: int = 32,
    shuffle: bool = True,
    seed: int = 0,
    drop_remainder: bool = True,
    prefetch: int = 2,
    epochs: Optional[int] = 1,
    transform=None,
) -> Iterator:
    """Epoch-based batch iterator with background prefetch.

    Yields ``dataset.load_batch(chunk)`` for each chunk of ``indices``
    (``(images, labels)`` for :class:`ImageFolder`), decoded on native
    threads inside one producer thread. ``transform`` (batch tuple ->
    batch tuple) also runs in the producer: an upload to the device there
    overlaps the consumer's device work. A failure in the producer is
    re-raised in the consumer.
    """
    if indices is None:
        indices = np.arange(len(dataset))
    q: queue.Queue = queue.Queue(maxsize=prefetch)
    stop = threading.Event()

    def put(item) -> bool:
        """Bounded put that still honours the consumer's early exit."""
        while not stop.is_set():
            try:
                q.put(item, timeout=0.5)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        # a bare thread death would leave the consumer blocked on q.get()
        # forever: every failure goes to the consumer instead
        try:
            rng = np.random.default_rng(seed)
            epoch = 0
            while epochs is None or epoch < epochs:
                order = rng.permutation(indices) if shuffle else indices
                limit = (len(order) // batch_size * batch_size
                         if drop_remainder else len(order))
                for s in range(0, limit, batch_size):
                    if stop.is_set():
                        return
                    item = dataset.load_batch(order[s:s + batch_size])
                    if transform is not None:
                        item = transform(item)
                    if not put(item):
                        return
                epoch += 1
            put(None)
        except BaseException as e:  # noqa: BLE001 — re-raised by the consumer
            put(e)

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is None:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
