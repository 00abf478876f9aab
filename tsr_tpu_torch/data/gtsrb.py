"""GTSRB-style image trees on the host: decode, resize, batch, prefetch.

Port of the part of ``tsr_tpu/data/gtsrb.py`` that the file-tree pipeline
runs:

- :data:`IMG_EXTENSIONS`, the suffixes a tree walk collects;
- :func:`_decode_resize` / :func:`_decode_resize_batch`: decode and
  bilinear-resize through the port's IO library (``tsr_tpu_torch.native``,
  the cv2.INTER_LINEAR convention, within 1 LSB of ``cv2.resize``);
- :class:`ImageFolder`: torchvision ``ImageFolder`` semantics (ref:05:32,
  06:39), classes the sorted subdirectory names, samples sorted per class;
- :func:`batches`: an epoch-based batch iterator with a background
  prefetch thread, standing in for DataLoader workers (ref:05:39, 07:137).

The IO library decodes PPM, PNG and BMP; a ``.jpg`` in a tree raises when
it is loaded, as does any file it cannot decode.
"""

from __future__ import annotations

import queue
import threading
from pathlib import Path
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from tsr_tpu_torch import configs, native

IMG_EXTENSIONS = (".ppm", ".png", ".jpg", ".jpeg", ".bmp")


def _decode_resize(path: str, size: int) -> np.ndarray:
    """One image as uint8 ``[size, size, 3]`` RGB."""
    return native.load_batch([path], size, threads=1)[0]


def _decode_resize_batch(paths: Sequence[str], size: int,
                         threads: int = 8) -> np.ndarray:
    """``paths`` as a uint8 ``[N, size, size, 3]`` RGB batch, decoded and
    resized on ``threads`` native threads."""
    return native.load_batch(list(paths), size, threads=threads)


class ImageFolder:
    """torchvision-ImageFolder-equivalent directory scanner.

    ``classes`` are the sorted subdirectory names (the reference's label
    indexing, ref:05:32); ``samples`` is a list of (path, label).
    """

    def __init__(self, root: str, size: int = configs.IMAGE_SIZE):
        self.root = Path(root)
        self.size = size
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
        return _decode_resize_batch(paths, self.size), labels


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
