"""Evaluation: the fused restore -> classify step, its batch harness and
the directory harness.

Port of ``tsr_tpu/eval.py``. One step runs

    uint8 batch -> [0,1] -> ResUNet -> clamp -> (uint8 quantize) ->
    ImageNet-normalize -> VGG16 judge -> top-1

on one device with no host round trip (with ``native_size``, a device
resize from native resolution first). ``quantize=True`` keeps the
reference's save-to-PNG uint8 quantization (ref:08:96-98) for exact
parity. Batches are NHWC; the models are NCHW, so the step permutes once
at each model boundary (a view: the batch stays channels-last in memory).
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Iterable, Optional

import numpy as np
import torch
from torch import nn

from tsr_tpu_torch import configs
from tsr_tpu_torch.data import gtsrb
from tsr_tpu_torch.device import Transfers, as_tensor, resolve_device
from tsr_tpu_torch.ops import image as image_ops


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


def restore_batch(restorer: nn.Module, bad01: torch.Tensor,
                  quantize: bool = True) -> torch.Tensor:
    """Restore a float01 NHWC batch; clamp to [0,1] (ref:08:96, 17:86) and
    optionally apply the PNG-save uint8 quantization (trunc, ref:08:98)."""
    out = _nhwc(restorer(_nchw(bad01))).clamp(0.0, 1.0)
    if quantize:
        out = torch.trunc(image_ops.scale255(out)) / 255.0
    return out


def make_fused_eval_step(restorer: Optional[nn.Module], judge: nn.Module,
                         quantize: bool = True, with_metrics: bool = False,
                         native_size: Optional[int] = None,
                         device="cuda") -> Callable:
    """Build the fused (restore ->) classify step on ``device``.

    Returns ``step(images_u8, labels, clean_u8=None)`` -> dict with
    ``correct`` (scalar), ``pred`` and ``confidence`` ``[B]``, and with
    ``with_metrics`` ``psnr`` / ``ssim`` ``[B]`` against ``clean_u8``.
    Pass ``restorer=None`` for classify-only evaluation (ref:06). Inputs
    may be numpy arrays or tensors; results stay on ``device``. The models
    are switched to eval mode and must already live on ``device``.

    With ``native_size=S`` (the device-resize serving path), ``images_u8``
    is a pair ``(padded_u8 [B, Hp, Wp, 3], sizes_hw [B, 2])`` of
    native-resolution pixels, resized to ``S`` on the device
    (``ops.image.resize_from_padded``): only native bytes cross to the card.
    """
    device = resolve_device(device)
    if restorer is not None:
        restorer.eval()
    judge.eval()

    @torch.inference_mode()
    def step(images_u8, labels, clean_u8=None) -> Dict[str, torch.Tensor]:
        if native_size is not None:
            padded, sizes = images_u8
            images_u8 = image_ops.resize_from_padded(
                as_tensor(padded, device), as_tensor(sizes, device),
                native_size)
        x01 = image_ops.to_float01(as_tensor(images_u8, device))
        labels = as_tensor(labels, device)
        out = {}
        if restorer is not None:
            x01 = restore_batch(restorer, x01, quantize=quantize)
        logits = judge(_nchw(image_ops.imagenet_normalize(x01)))
        logits = logits.to(torch.float32)
        pred = logits.argmax(-1)
        out["pred"] = pred
        out["correct"] = (pred == labels).sum()
        out["confidence"] = torch.softmax(logits, -1).amax(-1)
        if with_metrics and clean_u8 is not None:
            clean = as_tensor(clean_u8, device)
            restored_u8 = torch.trunc(image_ops.scale255(x01))
            out["psnr"] = image_ops.psnr(restored_u8, clean)
            out["ssim"] = image_ops.ssim(restored_u8.to(torch.uint8), clean)
        return out

    return step


def evaluate_batches(step: Callable, batch_iter: Iterable,
                     with_metrics: bool = False,
                     device="cuda") -> Dict[str, float]:
    """Drive a fused eval step over batches.

    ``batch_iter`` yields ``(images_u8, labels)`` or ``(images_u8, labels,
    clean_u8)``. Returns aggregate top-1, mean confidence (and mean
    PSNR/SSIM), and steady-state ``images_per_sec``: batch 0 is the warm-up
    and the window after it ends with a device synchronise on CUDA.
    """
    device = resolve_device(device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    t0 = time.perf_counter()
    total = timed = 0
    t_warm = None
    corrects, psnrs, ssims, confs = [], [], [], []
    for batch in batch_iter:
        images, labels = batch[0], batch[1]
        clean = batch[2] if len(batch) > 2 else None
        out = step(images, labels, clean)
        corrects.append(out["correct"])
        confs.append(out["confidence"])
        if with_metrics and "psnr" in out:
            psnrs.append(out["psnr"])
            ssims.append(out["ssim"])
        total += len(labels)
        if t_warm is None:
            sync()
            t_warm = time.perf_counter()
        else:
            timed += len(labels)
    sync()
    if timed:
        ips = timed / max(time.perf_counter() - t_warm, 1e-9)
    else:
        ips = total / max(time.perf_counter() - t0, 1e-9)
    correct = int(sum(int(c) for c in corrects))

    def mean(chunks):
        return float(np.mean(torch.cat(chunks).float().cpu().numpy()))

    res = {"top1": correct / max(total, 1), "n": total,
           "images_per_sec": ips,
           "confidence": mean(confs) if confs else float("nan")}
    if psnrs:
        res["psnr"] = mean(psnrs)
        res["ssim"] = mean(ssims)
    return res


def evaluate_directory(judge: nn.Module, data_dir: str, batch_size: int = 64,
                       size: int = configs.IMAGE_SIZE,
                       restorer: Optional[nn.Module] = None,
                       quantize: bool = True, resize: str = "host",
                       device="cuda", mesh=None) -> Dict[str, float]:
    """Directory top-1 evaluation (ref:06:23-59): ``ImageFolder`` over
    ``data_dir``, optional fused restoration before the judge.

    ``resize="host"`` (the default: the reference's input semantics)
    decodes and resizes on host threads; the prefetch thread uploads each
    batch through pinned memory on a copy stream, so the upload of batch
    k+1 overlaps the device work of batch k. ``resize="device"`` uploads
    native-resolution pixels and resizes them on the card
    (``ops.image.resize_from_padded``, within 1 LSB of cv2); it needs the
    cv2 resize backend, and under ``"pil"`` the host path runs, as in the
    reference.

    ``mesh`` (a ``parallel.mesh.Mesh``) runs the harness data-parallel on
    the mesh's device: the models are replicated from its first rank and
    each batch is split over its data axis, the uneven tail batch computed
    whole on every rank and counted once; the counts (and confidences)
    are reduced over the axis, so every rank returns the one-device
    result, with the global images/s. As in the reference, a mesh takes
    the host-resize path whatever ``resize`` says.
    """
    if resize not in ("host", "device"):
        raise ValueError(f"resize must be 'host' or 'device', got {resize!r}")
    device = mesh.device if mesh is not None else resolve_device(device)
    ds = gtsrb.ImageFolder(data_dir, size=size)
    if (resize == "device" and mesh is None
            and gtsrb.RESIZE_BACKEND == "cv2"):
        return _evaluate_directory_native(ds, judge, batch_size, size,
                                          restorer, quantize, device)
    if mesh is not None:
        from tsr_tpu_torch.parallel import mesh as pmesh

        for m in (judge, restorer):
            if m is not None:
                pmesh.shard_variables(m, mesh)
    step = make_fused_eval_step(restorer, judge, quantize=quantize,
                                device=device)
    if mesh is not None:
        step = _mesh_step(step, mesh)
    xfer = Transfers(device)

    def arrived(gen):
        for tensors, event in gen:
            xfer.arrive(tensors, event)
            yield tuple(tensors)

    it = gtsrb.batches(ds, batch_size=batch_size, shuffle=False,
                       drop_remainder=False, epochs=1,
                       transform=lambda item: xfer.up(*item))
    return evaluate_batches(step, arrived(it), device=device)


def _mesh_step(step, mesh):
    """``step`` on this rank's rows of every global batch (or on the whole
    uneven tail), with the count summed and the confidences gathered over
    the data axis, so :func:`evaluate_batches` sees the global batch's."""
    from tsr_tpu_torch.parallel import mesh as pmesh
    from tsr_tpu_torch.parallel.collectives import all_gather_cat

    def mesh_step(images, labels, clean=None):
        (images, labels), split = pmesh.shard_batch_or_replicate(
            (images, labels), mesh)
        out = step(images, labels)
        if split:
            out["correct"] = mesh.data_sum(out["correct"])
            out["confidence"] = all_gather_cat(out["confidence"], 0,
                                               mesh.data_group)
        return out

    return mesh_step


def _evaluate_directory_native(ds, judge, batch_size, size, restorer,
                               quantize, device):
    """Device-resize variant of the directory harness: the bucketing
    producer (``infer.native_batches``) uploads native-resolution pixels
    and the fused step resizes them on the card. ``pad_batch=False``: the
    labels count real rows only."""
    from tsr_tpu_torch import infer

    labels_all = np.asarray([lab for _, lab in ds.samples], np.int64)
    paths = [p for p, _ in ds.samples]
    step = make_fused_eval_step(restorer, judge, quantize=quantize,
                                native_size=size, device=device)
    xfer = Transfers(device)

    def labels_of(idxs):
        # uploaded in the producer like the pixels: a copy from pageable
        # memory here would wait for the device and stall the dispatch
        return xfer.up(labels_all[idxs])

    def gen():
        for padded, sizes, (labels, event), _ in infer.native_batches(
                paths, size, batch_size, aux_fn=labels_of, pad_batch=False,
                device=device):
            xfer.arrive(labels, event)
            yield (padded, sizes), labels[0]

    return evaluate_batches(step, gen(), device=device)
