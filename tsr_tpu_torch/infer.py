"""Batched restoration inference over file trees.

Port of ``tsr_tpu/infer.py`` (ref:08 restores image by image, ref:17 in
batches of 32): files are decoded on host threads, restored on the card in
large batches, and written back as PNG with the class folders kept
(ref:08:102-109, 17:89-99). PSNR/SSIM against the clean tree, resized the
same way, are computed on the card inside the restore step (ref:08:111-129;
the JAX package's device formulation, ``ops.image.psnr``/``ssim``).

The tree walk is a three-stage pipeline:

  producer thread   decode (and resize) batches on native threads, stage
                    them in pinned host memory and copy them to the card
                    on a dedicated copy stream (``device.Transfers``)
  main thread       order the compute stream after the copy, dispatch the
                    restore step, queue its output's copy back to pinned
                    memory on a second stream, hand the batch to the pool
  worker pool       wait for that copy, PNG-encode and write (the native
                    threaded encoder), collect the metrics

so decode, upload, device compute, download and encode + write overlap.
``max_inflight`` bounds the batches whose output is not yet written.

``resize="device"`` (the default) uploads images at NATIVE resolution
(GTSRB's are mostly 30-60 px), bucket-padded to 64/128/192, and the step
resizes them on the card (``ops.image.resize_from_padded``, within 1 LSB
of cv2); images at or above the output size are resized on the host and
pass the device resize as an exact identity. ``resize="host"`` resizes
every image on the host and uploads it at the output size.

Batches of the device mode are emitted as their bucket fills, so output
order differs from file order: every result goes to its file through the
batch's item indices.
"""

from __future__ import annotations

import collections
import concurrent.futures as cf
import queue
import threading
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from tsr_tpu_torch import configs, native
from tsr_tpu_torch.data import gtsrb
from tsr_tpu_torch.device import Transfers, as_tensor, resolve_device
from tsr_tpu_torch.ops import image as image_ops


class Clock:
    """Host seconds by stage, summed over threads (thread-safe)."""

    def __init__(self):
        self.seconds: Dict[str, float] = collections.defaultdict(float)
        self._lock = threading.Lock()

    def add(self, stage: str, t0: float) -> None:
        dt = time.perf_counter() - t0
        with self._lock:
            self.seconds[stage] += dt


def make_restore_step(restorer: nn.Module, with_metrics: bool = False,
                      device="cuda") -> Callable:
    """``step(images_u8)`` -> restored uint8 NHWC batch (clamp + PNG
    quantization, ref:08:96-98); with ``with_metrics``, ``step(images_u8,
    clean_u8)`` -> ``(restored, psnr [B], ssim [B])`` against the clean
    uint8 batch. The restorer runs in eval mode on ``device``."""
    device = resolve_device(device)
    restorer.eval()

    @torch.inference_mode()
    def step(images_u8):
        x01 = image_ops.to_float01(as_tensor(images_u8, device))
        out = restorer(x01.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        return torch.trunc(image_ops.scale255(out.clamp(0.0, 1.0))).to(
            torch.uint8)

    if not with_metrics:
        return step

    @torch.inference_mode()
    def step_metrics(images_u8, clean_u8):
        restored = step(images_u8)
        clean = as_tensor(clean_u8, device)
        return (restored, image_ops.psnr(restored, clean),
                image_ops.ssim(restored, clean))

    return step_metrics


def make_native_restore_step(restorer: nn.Module, out_size: int,
                             with_metrics: bool = False,
                             device="cuda") -> Callable:
    """Native-upload variant of :func:`make_restore_step`:
    ``step(padded_u8, sizes_hw[, clean_u8])`` resizes a bucket-padded
    native-resolution batch to ``out_size`` on the device
    (``ops.image.resize_from_padded``), then restores it."""
    device = resolve_device(device)
    inner = make_restore_step(restorer, with_metrics, device)

    @torch.inference_mode()
    def step(padded_u8, sizes_hw, *clean_u8):
        x = image_ops.resize_from_padded(as_tensor(padded_u8, device),
                                         as_tensor(sizes_hw, device),
                                         out_size)
        return inner(x, *clean_u8)

    return step


# Native-upload bucket sides. Coarse: bucket padding only costs upload
# bytes, and few canvas shapes keep the device's kernels few.
_NATIVE_BUCKETS = (64, 128, 192)


def native_plan(dims: np.ndarray, out_size: int, batch_size: int
                ) -> List[Tuple[int, List[int]]]:
    """The batches of :func:`native_batches` as ``(canvas side, item
    indices)`` in emission order, from each image's native ``(h, w)``: in
    file order, an image joins the smallest of ``_NATIVE_BUCKETS`` below
    ``out_size`` that holds its larger side (else the ``out_size`` bucket),
    a bucket is emitted when it fills, and the partly filled buckets follow
    in ascending order."""
    groups: Dict[int, List[int]] = {}
    plan = []
    for i, m in enumerate(np.asarray(dims).max(axis=1).tolist()):
        b = next((b for b in _NATIVE_BUCKETS if m <= b < out_size), out_size)
        groups.setdefault(b, []).append(i)
        if len(groups[b]) == batch_size:
            plan.append((b, groups.pop(b)))
    return plan + sorted(groups.items())


def native_batches(paths: List[str], out_size: int, batch_size: int,
                   aux_fn: Optional[Callable] = None,
                   pad_batch: bool = True,
                   decode_workers: int = 8,
                   prefetch: int = 3,
                   device="cuda",
                   clock: Optional[Clock] = None):
    """Producer generator for the device-resize paths (:func:`restore_tree`
    and ``eval.evaluate_directory``).

    Reads every image's native size from its header, plans the bucketed
    batches (:func:`native_plan`), then decodes each batch at NATIVE
    resolution straight into its zero-padded canvas on ``decode_workers``
    native threads, one call a batch, and yields ``(padded [B, S, S, 3]
    uint8, sizes [B, 2] int32, aux, item_indices)`` with both tensors on
    ``device``, ready for the current stream. ``aux_fn(item_indices)``,
    run in the producer thread, supplies the batch's host payload. With
    ``pad_batch`` the batch is padded to ``batch_size`` rows (filler rows
    resize a 1x1 black pixel). Images with a side >= ``out_size`` are
    resized on the host and ride the ``out_size`` bucket, where the device
    resize is an exact identity. The producer runs ``prefetch`` batches
    ahead in a background thread; it stops when the consumer stops early,
    and a failure there is re-raised here. ``clock`` collects host seconds
    for ``decode`` and ``upload``.
    """
    device = resolve_device(device)
    xfer = Transfers(device)
    clock = clock or Clock()

    def emit(bucket, idxs):
        t0 = time.perf_counter()
        rows = batch_size if pad_batch else len(idxs)
        padded = np.zeros((rows, bucket, bucket, 3), np.uint8)
        sizes = np.ones((rows, 2), np.int32)
        sizes[:len(idxs)] = native.load_canvas(
            [paths[i] for i in idxs], padded[:len(idxs)],
            resize_to=out_size, threads=decode_workers)
        clock.add("decode", t0)
        aux = aux_fn(idxs) if aux_fn is not None else None
        t0 = time.perf_counter()
        tensors, event = xfer.up(padded, sizes)
        clock.add("upload", t0)
        return (*tensors, aux, idxs, event)

    q: queue.Queue = queue.Queue(maxsize=prefetch)
    stop = threading.Event()

    def put(x) -> bool:
        """Bounded put that honours the consumer's early exit."""
        while not stop.is_set():
            try:
                q.put(x, timeout=0.5)
                return True
            except queue.Full:
                continue
        return False

    def produce():
        try:
            t0 = time.perf_counter()
            dims = native.probe(paths, threads=decode_workers)
            clock.add("decode", t0)
            for bucket, idxs in native_plan(dims, out_size, batch_size):
                if stop.is_set() or not put(emit(bucket, idxs)):
                    return
            put(None)
        except BaseException as e:  # noqa: BLE001 — re-raised by the consumer
            put(e)

    t = threading.Thread(target=produce, daemon=True)
    t.start()
    try:
        while True:
            got = q.get()
            if got is None:
                return
            if isinstance(got, BaseException):
                raise got
            padded, sizes, aux, idxs, event = got
            xfer.arrive((padded, sizes), event)
            yield padded, sizes, aux, idxs
    finally:
        stop.set()


class _RestorePairs:
    """(distorted file, optional clean twin by relative path, then with a
    ``.ppm`` or ``.png`` suffix): ``load_batch`` gives ``(bad_u8, clean_u8,
    has_clean)``, a missing twin as a zero image and a False mask."""

    def __init__(self, files: List[Path], distorted_root: Path,
                 clean_root: Optional[Path], size: int,
                 clock: Optional[Clock] = None):
        self.size = size
        self.clock = clock or Clock()
        self.items: List[Tuple[str, Optional[str]]] = []
        for p in files:
            cp = None
            if clean_root is not None:
                cand = clean_root / p.relative_to(distorted_root)
                for c in (cand, cand.with_suffix(".ppm"),
                          cand.with_suffix(".png")):
                    if c.exists():
                        cp = str(c)
                        break
            self.items.append((str(p), cp))

    def __len__(self):
        return len(self.items)

    def load_batch(self, indices, bad: bool = True,
                   rows: Optional[int] = None):
        """``(bad, clean, has_clean)`` of ``indices``; ``bad=False`` skips
        the distorted images (None), and ``rows`` pads ``clean`` with zero
        rows to that many."""
        t0 = time.perf_counter()
        out = None
        if bad:
            out = gtsrb._decode_resize_batch(
                [self.items[i][0] for i in indices], self.size)
        clean_paths = [self.items[i][1] for i in indices]
        mask = np.asarray([c is not None for c in clean_paths], bool)
        clean = np.zeros((rows or len(indices), self.size, self.size, 3),
                         np.uint8)
        if mask.any():
            clean[np.flatnonzero(mask)] = gtsrb._decode_resize_batch(
                [c for c in clean_paths if c is not None], self.size)
        self.clock.add("decode", t0)
        return out, clean, mask


def restore_tree(
    restorer: nn.Module,
    distorted_dir: str,
    restored_dir: str,
    clean_dir: Optional[str] = None,
    batch_size: int = 64,
    size: int = configs.IMAGE_SIZE,
    compute_metrics: bool = True,
    workers: int = 3,
    max_inflight: int = 4,
    resize: str = "device",
    log: Callable[[str], None] = print,
    device="cuda",
) -> Dict[str, object]:
    """Restore every image under ``distorted_dir`` into ``restored_dir`` (as
    ``.png``, class tree preserved); with ``clean_dir``, also the mean
    PSNR/SSIM against the clean twins (ref:08:111-135), computed on the
    device. Pipelined as the module docstring says: ``workers`` sizes the
    download + write pool, ``max_inflight`` bounds the batches in flight
    (device memory about ``max_inflight * batch * size^2 * 3`` bytes of
    outputs). ``resize`` is ``"device"`` (native upload, device resize) or
    ``"host"`` (resize on the host, upload at ``size``); under the ``"pil"``
    resize backend the host path runs whatever ``resize`` says, as in the
    reference (only the host resize is PIL's).

    Returns ``images``, ``images_per_sec`` and, where clean twins exist,
    ``psnr`` and ``ssim``; also ``seconds`` (the walk's wall time),
    ``batches``, and ``host_seconds``: host time by stage, summed over
    threads (``decode``, ``upload``, ``dispatch`` for the main thread's
    step calls, ``download`` for the pool's waits on the copy back, and
    ``write`` for encode + write).
    """
    device = resolve_device(device)
    if resize not in ("device", "host"):
        raise ValueError(f"resize must be 'device' or 'host', got {resize!r}")
    if gtsrb.RESIZE_BACKEND != "cv2":
        resize = "host"
    distorted = Path(distorted_dir)
    restored = Path(restored_dir)
    files = sorted(p for p in distorted.glob("*/*")
                   if p.suffix.lower() in gtsrb.IMG_EXTENSIONS)
    out_paths = [str((restored / p.relative_to(distorted)).with_suffix(
        ".png")) for p in files]
    for d in {Path(p).parent for p in out_paths}:
        d.mkdir(parents=True, exist_ok=True)

    with_metrics = compute_metrics and clean_dir is not None
    clock = Clock()
    ds = _RestorePairs(files, distorted,
                       Path(clean_dir) if with_metrics else None, size,
                       clock)
    xfer = Transfers(device)

    if resize == "device":
        step = make_native_restore_step(restorer, size, with_metrics, device)

        def clean_twins(idxs):  # runs in the producer thread
            """The batch's clean twins, resized and uploaded (a missing
            twin a zero image, False in the mask), with the upload's
            event."""
            _, clean, mask = ds.load_batch(idxs, bad=False,
                                           rows=batch_size)
            t0 = time.perf_counter()
            (clean,), event = xfer.up(clean)
            clock.add("upload", t0)
            return clean, event, mask

        it = native_batches([d for d, _ in ds.items], size, batch_size,
                            aux_fn=clean_twins if with_metrics else None,
                            device=device, clock=clock)

        def dispatch(batch):
            padded, sizes, aux, idxs = batch
            if not with_metrics:
                return (step(padded, sizes),), np.zeros(len(idxs), bool), idxs
            clean, event, mask = aux
            xfer.arrive((clean,), event)
            return step(padded, sizes, clean), mask, idxs
    else:
        step = make_restore_step(restorer, with_metrics, device)

        def upload(item):  # runs in the producer thread
            t0 = time.perf_counter()
            bad, clean, mask = item
            tensors, event = xfer.up(*((bad, clean) if with_metrics
                                       else (bad,)))
            clock.add("upload", t0)
            return tensors, event, mask

        def indexed(gen):
            k = 0
            for tensors, event, mask in gen:
                xfer.arrive(tensors, event)
                b = tensors[0].shape[0]
                yield tensors, mask, list(range(k, k + b))
                k += b

        it = indexed(gtsrb.batches(ds, batch_size=batch_size, shuffle=False,
                                   drop_remainder=False, epochs=1,
                                   transform=upload))

        def dispatch(batch):
            tensors, mask, idxs = batch
            out = step(*tensors)
            return (out if with_metrics else (out,)), mask, idxs

    sem = threading.Semaphore(max_inflight)

    def finish(hosts, event, paths, mask):
        """Pool task: wait for one batch's copy back, write its PNGs,
        return its metrics on the rows with a clean twin."""
        try:
            t0 = time.perf_counter()
            Transfers.wait(event)
            clock.add("download", t0)
            t0 = time.perf_counter()
            native.write_png_batch(paths, hosts[0].numpy())
            clock.add("write", t0)
            if with_metrics and mask.any():
                return hosts[1].numpy()[mask], hosts[2].numpy()[mask]
            return None
        finally:
            sem.release()

    n = n_batches = 0
    futures = []
    t_start = time.perf_counter()
    with cf.ThreadPoolExecutor(workers) as pool:
        for batch in it:
            sem.acquire()  # caps the batches not yet written
            t0 = time.perf_counter()
            outs, mask, idxs = dispatch(batch)
            k = len(idxs)
            hosts, event = xfer.down(*(o[:k] for o in outs))
            clock.add("dispatch", t0)
            futures.append(pool.submit(finish, hosts, event,
                                       [out_paths[i] for i in idxs],
                                       mask[:k]))
            n += k
            n_batches += 1
        scored = [f.result() for f in futures]  # re-raises worker errors

    dt = time.perf_counter() - t_start
    res: Dict[str, object] = {"images": n,
                              "images_per_sec": n / max(dt, 1e-9),
                              "seconds": dt, "batches": n_batches,
                              "host_seconds": dict(clock.seconds)}
    log(f"Restored {n} images in {dt:.1f}s "
        f"({res['images_per_sec']:.1f} img/s, decode+restore+encode "
        f"pipelined)")
    scored = [m for m in scored if m is not None]
    if scored:
        res["psnr"] = float(np.mean(np.concatenate([p for p, _ in scored])))
        res["ssim"] = float(np.mean(np.concatenate([s for _, s in scored])))
        log(f"Average PSNR: {res['psnr']:.2f} dB")
        log(f"Average SSIM: {res['ssim']:.4f}")
    return res
