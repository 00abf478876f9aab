"""The unified ResUNet trainer with the clean set on the device.

Port of ``tsr_tpu/train/loops.py::train_unified_on_device`` (ref:14:227-267):
the clean uint8 set is uploaded once, each epoch gathers its batches on the
device from a fresh permutation, the random mix runs on the device inside
each step, and the validation loss is summed over a padded, masked val set.
Best/periodic checkpoints and resume are not ported yet: the trainer returns
its state and the per-epoch losses.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from tsr_tpu_torch import configs
from tsr_tpu_torch.device import as_tensor, resolve_device
from tsr_tpu_torch.ops import distortions
from tsr_tpu_torch.train import common


def _val_wrap_pad(va_idx: np.ndarray, bs: int) -> Tuple[np.ndarray,
                                                         np.ndarray]:
    """Wrap-pad validation indices to a batch multiple.

    Returns ([vsteps, bs] int64 indices, [vsteps, bs] float32 mask); padded
    slots repeat the head of the val set and carry mask 0, so masked sums
    are exact."""
    va_idx = np.asarray(va_idx, np.int64)
    n = len(va_idx)
    if n == 0:
        raise ValueError(
            "empty validation set — the train split left no val samples; "
            "lower train_split or grow the dataset")
    vsteps = max(1, (n + bs - 1) // bs)
    total = vsteps * bs
    # modular wrap: correct even when the pad exceeds the val set itself
    idx = va_idx[np.arange(total) % n]
    mask = (np.arange(total) < n).astype(np.float32)
    return idx.reshape(vsteps, bs), mask.reshape(vsteps, bs)


def _per_sample_restoration_loss(pred, clean01, pixel, perceptual_weight,
                                 vgg_apply):
    """[B] per-sample restoration loss matching losses.restoration_loss."""
    if pixel == "mse":
        pix = ((pred - clean01) ** 2).mean(dim=(1, 2, 3))
    else:
        pix = (pred - clean01).abs().mean(dim=(1, 2, 3))
    if vgg_apply is not None:
        d = vgg_apply(pred) - vgg_apply(clean01)
        pix = pix + perceptual_weight * (d ** 2).mean(dim=(1, 2, 3))
    return pix


def auto_remat(cfg: configs.UnifiedTrainConfig, vgg_apply) -> object:
    """``"vgg"`` for batches over 64 with a perceptual term (the frozen
    VGG's activations are what outgrows memory there), else ``False``."""
    return "vgg" if (vgg_apply is not None and cfg.batch_size > 64) else False


def train_unified_on_device(
    state: common.TrainState,
    clean_u8,
    tr_idx,
    va_idx,
    cfg: configs.UnifiedTrainConfig,
    vgg_apply: Optional[Callable] = None,
    log: Callable[[str], None] = print,
    remat=None,
    device="cuda",
) -> Tuple[common.TrainState, List[Dict]]:
    """Unified ResUNet training (ref:14:227-267) with the clean set on
    ``device``. ``state.model`` (and ``vgg_apply``'s net) must already
    live there.

    Randomness comes from ``cfg.seed``: a host generator seeds each epoch's
    permutation generator and each step's mix generator on ``device``, so
    a run is reproducible and no draw waits for the device. ``remat``
    (None = :func:`auto_remat`) goes to
    :func:`common.make_unified_train_step`.

    Returns ``(state, history)``: one dict per epoch with ``train_loss``
    (mean over steps), per-step ``step_loss`` / ``pixel_loss`` /
    ``perceptual_loss`` lists, ``val_loss`` (mean per validation image,
    model in eval mode), ``train_seconds`` (the epoch's steps, closed by a
    device synchronise) and ``images_per_sec`` over them: the train steps'
    rate, validation left out (the reference's log line times both).
    """
    device = resolve_device(device)
    bs = cfg.batch_size
    if remat is None:
        remat = auto_remat(cfg, vgg_apply)
    clean_d = as_tensor(clean_u8, device)
    tr_idx_d = torch.as_tensor(np.asarray(tr_idx, np.int64), device=device)
    steps = len(tr_idx_d) // bs
    if steps == 0:
        raise ValueError(f"fewer than one batch: {len(tr_idx_d)} < {bs}")
    va_pad, va_mask = _val_wrap_pad(va_idx, bs)
    n_val = len(va_idx)
    va_pad_d = torch.as_tensor(va_pad, device=device)
    va_mask_d = torch.as_tensor(va_mask, device=device)

    step_fn = common.make_unified_train_step(
        cfg.mix, cfg.perceptual_weight, vgg_apply, remat=remat)
    host = torch.Generator().manual_seed(cfg.seed)

    def child() -> torch.Generator:
        seed = int(torch.randint(0, 2 ** 62, (1,), generator=host))
        return torch.Generator(device=device).manual_seed(seed)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    history = []
    for epoch in range(cfg.epochs):
        sync()
        t0 = time.perf_counter()
        perm = torch.randperm(len(tr_idx_d), generator=child(), device=device)
        batches = tr_idx_d[perm[:steps * bs]].reshape(steps, bs)
        auxes = []
        for s in range(steps):
            cb = clean_d.index_select(0, batches[s])
            auxes.append(step_fn(state, cb, child()))
        per_step = {k: torch.stack([a[k] for a in auxes]).tolist()
                    for k in auxes[0]}  # one device synchronise
        dt = time.perf_counter() - t0

        state.model.eval()
        tot = torch.zeros((), device=device)
        with torch.no_grad():
            for bidx, mask in zip(va_pad_d, va_mask_d):
                cb = clean_d.index_select(0, bidx)
                bad01, clean01 = distortions.make_training_pair(
                    cb, child(), cfg.mix, device=device)
                pred = state.model(bad01.permute(0, 3, 1, 2))
                ls = _per_sample_restoration_loss(
                    pred, clean01.permute(0, 3, 1, 2), "l1",
                    cfg.perceptual_weight, vgg_apply)
                tot += (ls * mask).sum()
        state.model.train()
        vl = tot.item() / n_val
        rec = {"epoch": epoch + 1,
               "train_loss": float(np.mean(per_step["loss"])),
               "step_loss": per_step["loss"],
               "pixel_loss": per_step["pixel_loss"],
               "perceptual_loss": per_step.get("perceptual_loss", []),
               "val_loss": vl, "train_seconds": dt,
               "images_per_sec": steps * bs / max(dt, 1e-9)}
        history.append(rec)
        log(f"Epoch {epoch + 1}/{cfg.epochs} train loss "
            f"{rec['train_loss']:.5f} ({rec['images_per_sec']:.1f} img/s, "
            "train steps only)")
        log(f"  val loss {vl:.5f}")
    return state, history
