"""The judge's and the restorers' train steps and their state.

Port of ``tsr_tpu/train/common.py``: the judge's path, ``judge_optimizer``
(SGD with momentum, or AdamW on a linear warmup behind global-norm
clipping) with ``make_judge_train_step`` (ImageNet-normalized uint8
batches -> VGG16 in train mode -> cross-entropy) and
``make_judge_eval_step``; the restorers' paths: the unified one,
``unified_optimizer`` (AdamW + a per-step cosine schedule) and
``make_unified_train_step`` (random mix on the device -> ResUNet in train
mode -> L1 + 0.1 x VGG perceptual loss -> AdamW), and the specialized and
advanced SimpleUNet ones, ``restoration_optimizer`` / ``advanced_optimizer``
(Adam at a constant rate) with ``make_restoration_train_step`` (MSE, or
L1 + 0.1 x perceptual, on stored (distorted, clean) pairs) and
``make_restoration_eval_step``. The JAX state is a pytree threaded through
a jitted step; here it is the module, its optimizer and schedule, and a
step count, updated in place.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Callable, Dict, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from tsr_tpu_torch import configs, losses
from tsr_tpu_torch.models.layers import frozen_running_stats
from tsr_tpu_torch.ops import distortions
from tsr_tpu_torch.ops import image as image_ops


@dataclasses.dataclass
class TrainState:
    """A model in training: its optimizer, the optimizer's learning-rate
    schedule, and the count of steps taken."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    schedule: torch.optim.lr_scheduler.LRScheduler
    step: int = 0

    def apply_gradients(self) -> None:
        """One optimizer update from the gradients in ``.grad``, then the
        schedule's next learning rate; the gradients are cleared."""
        self.optimizer.step()
        self.schedule.step()
        self.optimizer.zero_grad(set_to_none=True)
        self.step += 1


class ClippedAdamW(torch.optim.AdamW):
    """``optax.chain(clip_by_global_norm(1.0), adamw(...))``: each step
    first scales every gradient by ``max_norm / norm`` when the global
    norm is at least ``max_norm``. ``torch.nn.utils.clip_grad_norm_``
    divides by ``norm + 1e-6`` instead, so the clip is done here, on the
    device, with no host synchronise."""

    max_norm = 1.0

    @torch.no_grad()
    def step(self, closure=None):
        grads = [p.grad for group in self.param_groups
                 for p in group["params"] if p.grad is not None]
        if grads:
            norm = torch.linalg.vector_norm(torch.stack(
                [torch.linalg.vector_norm(g, dtype=torch.float32)
                 for g in grads]))
            scale = torch.where(norm < self.max_norm, 1.0,
                                self.max_norm / norm)
            for g in grads:
                g.mul_(scale.to(g.dtype))
        return super().step(closure)


def judge_optimizer(params, cfg: configs.JudgeTrainConfig):
    """SGD(lr=1e-3, momentum=0.9) (ref:05:60), or for
    ``cfg.optimizer == "adamw"`` the from-scratch path: global-norm
    clipping at 1.0 and AdamW(lr, wd) on a linear warmup from 0 over
    ``cfg.warmup_steps`` (a constant rate when that is 0). Returns
    ``(optimizer, schedule)``.

    The warmup is optax's ``linear_schedule(0, lr, warmup)`` evaluated at
    the count before each update, so the first update has rate 0 (weight
    decay included) while Adam's moments still take its gradient. optax's
    ``trace`` momentum (``m = g + mu * m``) is torch's SGD without
    dampening or Nesterov.
    """
    if cfg.optimizer == "adamw":
        opt = ClippedAdamW(params, lr=cfg.learning_rate, betas=(0.9, 0.999),
                           eps=1e-8, weight_decay=cfg.weight_decay)
        warmup = max(1, cfg.warmup_steps)

        def factor(count):
            return min(count / warmup, 1.0) if cfg.warmup_steps else 1.0
    elif cfg.optimizer == "sgd":
        opt = torch.optim.SGD(params, lr=cfg.learning_rate,
                              momentum=cfg.momentum)

        def factor(count):
            return 1.0
    else:
        raise ValueError(f"unknown judge optimizer {cfg.optimizer!r}")
    return opt, torch.optim.lr_scheduler.LambdaLR(opt, factor)


def create_judge_state(model: nn.Module, cfg: configs.JudgeTrainConfig
                       ) -> TrainState:
    return TrainState(model, *judge_optimizer(model.parameters(), cfg))


def unified_optimizer(params, cfg: configs.UnifiedTrainConfig,
                      steps_per_epoch: int):
    """AdamW(2e-4, wd=1e-4) + cosine annealing over T_max epochs
    (ref:14:222-223), evaluated per step as optax's
    ``cosine_decay_schedule(lr, T_max * steps_per_epoch)`` at the count
    before each update: step 0 runs at the full rate. Returns
    ``(optimizer, schedule)``.

    ``torch.optim.AdamW`` decays ``p * (1 - lr * wd)`` before the Adam
    update; optax adds ``lr * wd * p`` to it. Both read the same ``p``, so
    the two are one update in exact arithmetic.
    """
    decay_steps = max(1, cfg.cosine_t_max * steps_per_epoch)
    opt = torch.optim.AdamW(params, lr=cfg.learning_rate, betas=(0.9, 0.999),
                            eps=1e-8, weight_decay=cfg.weight_decay)

    def factor(count):
        return 0.5 * (1.0 + math.cos(math.pi * min(count, decay_steps)
                                     / decay_steps))

    return opt, torch.optim.lr_scheduler.LambdaLR(opt, factor)


def create_unified_state(model: nn.Module, cfg: configs.UnifiedTrainConfig,
                         steps_per_epoch: int) -> TrainState:
    return TrainState(model, *unified_optimizer(model.parameters(), cfg,
                                                steps_per_epoch))


def _adam(params, lr: float):
    """``optax.adam(lr)``: b1 0.9, b2 0.999, eps 1e-8 added outside the
    square root (optax's ``eps_root`` 0), a constant rate. Returns
    ``(optimizer, schedule)``; the schedule keeps the rate."""
    opt = torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)
    return opt, torch.optim.lr_scheduler.LambdaLR(opt, lambda count: 1.0)


def restoration_optimizer(params, cfg: configs.RestorationTrainConfig):
    """Adam(lr=1e-3) (ref:07:143), as :func:`_adam`."""
    return _adam(params, cfg.learning_rate)


def advanced_optimizer(params, cfg: configs.AdvancedTrainConfig):
    """Adam(lr=2e-4) (ref:07adv:135), as :func:`_adam`."""
    return _adam(params, cfg.learning_rate)


def create_restoration_state(model: nn.Module, cfg) -> TrainState:
    """A SimpleUNet's state under :func:`restoration_optimizer` (a
    ``RestorationTrainConfig``) or :func:`advanced_optimizer` (an
    ``AdvancedTrainConfig``): both are Adam at ``cfg.learning_rate``."""
    return TrainState(model, *_adam(model.parameters(), cfg.learning_rate))


def unified_loss(model: nn.Module, bad01: torch.Tensor,
                 clean01: torch.Tensor, perceptual_weight: float = 0.1,
                 vgg_apply: Optional[Callable] = None, remat=False,
                 pixel: str = "l1"
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """A restorer's forward on a training pair: the model (a ResUNet in
    train mode: batch statistics, running statistics updated once) ->
    ``pixel`` loss (L1, the unified and advanced trainers; ``"mse"``, the
    specialized one) + ``perceptual_weight`` x MSE of ``vgg_apply``
    features. ``bad01`` and ``clean01`` are float01 ``[B, H, W, C]``.
    Returns ``(loss, aux)``; ``loss.backward()`` gives the parameters'
    gradients.

    The clean branch's features run under ``no_grad`` (the reference's
    ``stop_gradient``), so none of its activations are kept. ``remat``:
    ``True`` checkpoints the ResUNet forward (recomputed in backward with
    its running statistics frozen), ``"vgg"`` only the perceptual VGG on
    the prediction.
    """
    x = bad01.permute(0, 3, 1, 2)
    y = clean01.permute(0, 3, 1, 2)
    if remat is True:
        pred = checkpoint(
            model, x, use_reentrant=False, preserve_rng_state=False,
            context_fn=lambda: (contextlib.nullcontext(),
                                frozen_running_stats(model)))
    else:
        pred = model(x)
    perc = None
    if vgg_apply is not None:
        def vgg_a(a):
            if remat == "vgg":
                return checkpoint(vgg_apply, a, use_reentrant=False,
                                  preserve_rng_state=False)
            return vgg_apply(a)

        def perc(a, b):
            with torch.no_grad():
                fb = vgg_apply(b)
            return losses.mse_loss(vgg_a(a), fb)
    return losses.restoration_loss(pred, y, perceptual=perc,
                                   perceptual_weight=perceptual_weight,
                                   pixel=pixel)


def make_unified_train_step(mix_cfg: configs.RandomMixConfig,
                            perceptual_weight: float = 0.1,
                            vgg_apply: Optional[Callable] = None,
                            remat=False) -> Callable:
    """Unified ResUNet step with the random mix on the device.

    Returns ``step(state, clean_u8, generator) -> aux``: the clean uint8
    ``[B, H, W, 3]`` batch (on the model's device) goes through
    :func:`ops.distortions.make_training_pair` with ``generator`` (on the
    card the mix runs kernels B1 and B2 once per scale group), then
    :func:`unified_loss`, backward and one AdamW update. ``aux`` holds the
    detached ``loss``, ``pixel_loss`` and (with ``vgg_apply``)
    ``perceptual_loss``, left on the device.

    ``remat`` selects the rematerialization placement: ``False`` none;
    ``"vgg"`` the perceptual VGG on the prediction; ``True`` the ResUNet.
    """

    def step(state: TrainState, clean_u8: torch.Tensor,
             generator: torch.Generator) -> Dict[str, torch.Tensor]:
        bad01, clean01 = distortions.make_training_pair(
            clean_u8, generator, mix_cfg, device=clean_u8.device)
        state.model.train()
        loss, aux = unified_loss(state.model, bad01, clean01,
                                 perceptual_weight, vgg_apply, remat)
        loss.backward()
        state.apply_gradients()
        return {k: v.detach() for k, v in aux.items()}

    return step


def _float01(x: torch.Tensor) -> torch.Tensor:
    """A uint8 batch as float01; a float batch as it is."""
    return image_ops.to_float01(x) if x.dtype == torch.uint8 else x


def make_restoration_train_step(pixel: str = "mse",
                                perceptual_weight: float = 0.1,
                                vgg_apply: Optional[Callable] = None
                                ) -> Callable:
    """Restorer step on stored (distorted, clean) pairs.

    Returns ``step(state, bad, clean) -> aux``: uint8 or float01 ``[B, H,
    W, C]`` batches on the model's device (uint8 is converted there, a
    quarter of float32's upload), :func:`unified_loss` with ``pixel``
    (``"mse"``: ref:07:142; ``"l1"`` with ``vgg_apply``, the frozen
    perceptual features: ref:07adv:150-154), backward and one optimizer
    update. ``aux`` holds the detached losses, left on the device.
    """

    def step(state: TrainState, bad: torch.Tensor,
             clean: torch.Tensor) -> Dict[str, torch.Tensor]:
        state.model.train()
        loss, aux = unified_loss(state.model, _float01(bad), _float01(clean),
                                 perceptual_weight, vgg_apply, pixel=pixel)
        loss.backward()
        state.apply_gradients()
        return {k: v.detach() for k, v in aux.items()}

    return step


def make_restoration_eval_step(pixel: str = "mse",
                               perceptual_weight: float = 0.1,
                               vgg_apply: Optional[Callable] = None
                               ) -> Callable:
    """Validation loss step (ref:07:166-173, ref:14:255-260): ``step(state,
    bad, clean) -> aux`` with the model in eval mode and no gradients; the
    model's mode is restored after."""

    @torch.no_grad()
    def step(state: TrainState, bad: torch.Tensor,
             clean: torch.Tensor) -> Dict[str, torch.Tensor]:
        was_training = state.model.training
        state.model.eval()
        try:
            _, aux = unified_loss(state.model, _float01(bad),
                                  _float01(clean), perceptual_weight,
                                  vgg_apply, pixel=pixel)
        finally:
            state.model.train(was_training)
        return aux

    return step


def judge_input(images_u8: torch.Tensor) -> torch.Tensor:
    """uint8 ``[B, H, W, 3]`` -> ImageNet-normalized float ``[B, 3, H, W]``."""
    x = image_ops.imagenet_normalize(image_ops.to_float01(images_u8))
    return x.permute(0, 3, 1, 2)


def make_judge_train_step(label_smoothing: float = 0.0) -> Callable:
    """Judge fine-tune step: ImageNet-normalized input, CE loss
    (ref:05:75-87).

    Returns ``step(state, images_u8, labels) -> {"loss", "accuracy"}``:
    a uint8 ``[B, H, W, 3]`` batch and its integer labels on the judge's
    device, the judge in train mode (dropout; a ``use_batchnorm`` judge's
    batch norms on batch statistics, their running statistics moved by
    Flax's rule), :func:`losses.cross_entropy_loss`, backward and one
    optimizer update. The metrics are detached and left on the device.
    Dropout draws from torch's generator of the device.
    """

    def step(state: TrainState, images_u8: torch.Tensor,
             labels: torch.Tensor) -> Dict[str, torch.Tensor]:
        state.model.train()
        logits = state.model(judge_input(images_u8))
        loss = losses.cross_entropy_loss(logits, labels, label_smoothing)
        loss.backward()
        state.apply_gradients()
        acc = (logits.detach().argmax(-1) == labels).float().mean()
        return {"loss": loss.detach(), "accuracy": acc}

    return step


def make_judge_eval_step() -> Callable:
    """Top-1 correctness count (ref:06:49-55): ``step(state, images_u8,
    labels) -> (correct count, logits)`` with the judge in eval mode and
    no gradients, both left on the device; the judge's mode is restored
    after."""

    @torch.no_grad()
    def step(state: TrainState, images_u8: torch.Tensor,
             labels: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        was_training = state.model.training
        state.model.eval()
        try:
            logits = state.model(judge_input(images_u8))
        finally:
            state.model.train(was_training)
        return (logits.argmax(-1) == labels).sum(), logits

    return step
