"""The restorers' trainers with their data on the device.

Port of ``tsr_tpu/train/loops.py``'s device-resident restorer loops:

- :func:`train_restorer_on_device` (ref:07:122-181, ref:07adv:115-182):
  the specialized and advanced SimpleUNets on stored (distorted, clean)
  uint8 pairs, both trees uploaded once, with periodic and best
  checkpoints (``zoo.save_checkpoint``);
- :func:`train_unified_on_device` (ref:14:227-267): the clean uint8 set
  uploaded once, the random mix on the device inside each step; it returns
  its state and per-epoch losses and writes no checkpoint.

Each epoch gathers its batches on the device from a fresh permutation, and
the validation loss is summed over a padded, masked val set.
"""

from __future__ import annotations

import copy
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from tsr_tpu_torch import configs, zoo
from tsr_tpu_torch.device import as_tensor, resolve_device
from tsr_tpu_torch.ops import distortions
from tsr_tpu_torch.ops import image as image_ops
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


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _epoch_record(epoch: int, per_step: Dict[str, List[float]],
                  val_loss: float, seconds: float, images: int) -> Dict:
    """One epoch's entry of a trainer's history."""
    return {"epoch": epoch + 1,
            "train_loss": float(np.mean(per_step["loss"])),
            "step_loss": per_step["loss"],
            "pixel_loss": per_step["pixel_loss"],
            "perceptual_loss": per_step.get("perceptual_loss", []),
            "val_loss": val_loss, "train_seconds": seconds,
            "images_per_sec": images / max(seconds, 1e-9)}


def train_restorer_on_device(
    state: common.TrainState,
    bad_u8,
    clean_u8,
    tr_idx,
    va_idx,
    epochs: int,
    batch_size: int,
    pixel: str = "mse",
    perceptual_weight: float = 0.1,
    vgg_apply: Optional[Callable] = None,
    save_path: Optional[str] = None,
    checkpoint_every: int = 0,
    save_best: bool = False,
    log: Callable[[str], None] = print,
    ckpt_config: Optional[dict] = None,
    seed: int = 0,
    device="cuda",
) -> Tuple[common.TrainState, List[Dict]]:
    """Specialized (MSE / Adam, ref:07:122-181) or advanced (L1 +
    perceptual / Adam, ref:07adv:115-182) restorer training with both
    uint8 trees on ``device``. ``state.model`` (and ``vgg_apply``'s net)
    must already live there.

    Each epoch takes a permutation of ``tr_idx`` from one host generator
    seeded with ``seed`` (the same order on any device) and runs
    ``len(tr_idx) // batch_size`` steps, the remainder dropped. With
    ``save_path``: ``checkpoint_every`` writes the state through to disk
    every that many epochs (ref:07:177-178); ``save_best`` snapshots the
    state with the lowest validation loss on the device and writes it once
    at the end (ref:14:265-267); with neither, the final state is written.

    Returns ``(state, history)``: one dict per epoch with ``train_loss``
    (mean over steps), the per-step ``step_loss`` (and ``pixel_loss`` /
    ``perceptual_loss``) lists, ``val_loss`` (mean per validation image,
    model in eval mode), ``train_seconds`` (the epoch's steps, closed by a
    device synchronise) and ``images_per_sec`` over them.
    """
    device = resolve_device(device)
    bs = batch_size
    bad_d = as_tensor(bad_u8, device)
    clean_d = as_tensor(clean_u8, device)
    tr_idx = torch.as_tensor(np.asarray(tr_idx, np.int64))
    steps = len(tr_idx) // bs
    if steps == 0:
        raise ValueError(f"fewer than one batch: {len(tr_idx)} < {bs}")
    va_pad, va_mask = _val_wrap_pad(va_idx, bs)
    n_val = len(va_idx)
    va_pad_d = torch.as_tensor(va_pad, device=device)
    va_mask_d = torch.as_tensor(va_mask, device=device)

    step_fn = common.make_restoration_train_step(pixel, perceptual_weight,
                                                 vgg_apply)
    host = torch.Generator().manual_seed(seed)
    best_loss, best_tree = float("inf"), None
    history = []
    for epoch in range(epochs):
        perm = torch.randperm(len(tr_idx), generator=host)
        batches = tr_idx[perm[:steps * bs]].reshape(steps, bs).to(device)
        _sync(device)
        t0 = time.perf_counter()
        auxes = [step_fn(state, bad_d.index_select(0, b),
                         clean_d.index_select(0, b)) for b in batches]
        per_step = {k: torch.stack([a[k] for a in auxes]).tolist()
                    for k in auxes[0]}  # one device synchronise
        dt = time.perf_counter() - t0

        state.model.eval()
        tot = torch.zeros((), device=device)
        with torch.no_grad():
            for bidx, mask in zip(va_pad_d, va_mask_d):
                xb = image_ops.to_float01(bad_d.index_select(0, bidx))
                yb = image_ops.to_float01(clean_d.index_select(0, bidx))
                pred = state.model(xb.permute(0, 3, 1, 2))
                ls = _per_sample_restoration_loss(
                    pred, yb.permute(0, 3, 1, 2), pixel, perceptual_weight,
                    vgg_apply)
                tot += (ls * mask).sum()
        state.model.train()
        vl = tot.item() / n_val
        rec = _epoch_record(epoch, per_step, vl, dt, steps * bs)
        history.append(rec)
        log(f"Epoch {epoch + 1}/{epochs} train loss {rec['train_loss']:.6f} "
            f"({rec['images_per_sec']:.1f} img/s, train steps only)")
        log(f"  val loss {vl:.6f}")
        if save_path:
            if checkpoint_every and (epoch + 1) % checkpoint_every == 0:
                zoo.save_checkpoint(save_path, state, ckpt_config)
            if save_best and vl < best_loss:
                best_loss = vl
                best_tree = copy.deepcopy(zoo.state_tree(state))
                log("  new best (val loss)")
    if save_path:
        if save_best and best_tree is not None:
            zoo.save_checkpoint(save_path, best_tree, ckpt_config)
            log(f"saved best checkpoint (val loss {best_loss:.6f})")
        elif not save_best:
            zoo.save_checkpoint(save_path, state, ckpt_config)
    return state, history


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

    history = []
    for epoch in range(cfg.epochs):
        _sync(device)
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
        rec = _epoch_record(epoch, per_step, vl, dt, steps * bs)
        history.append(rec)
        log(f"Epoch {epoch + 1}/{cfg.epochs} train loss "
            f"{rec['train_loss']:.5f} ({rec['images_per_sec']:.1f} img/s, "
            "train steps only)")
        log(f"  val loss {vl:.5f}")
    return state, history
