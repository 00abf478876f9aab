"""The unified ResUNet train step and its state.

Port of ``tsr_tpu/train/common.py``'s unified path: ``unified_optimizer``
(AdamW + a per-step cosine schedule) and ``make_unified_train_step``
(random mix on the device -> ResUNet in train mode -> L1 + 0.1 x VGG
perceptual loss -> AdamW). The JAX state is a pytree threaded through a
jitted step; here it is the module, its optimizer and schedule, and a step
count, updated in place.
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


def unified_loss(model: nn.Module, bad01: torch.Tensor,
                 clean01: torch.Tensor, perceptual_weight: float = 0.1,
                 vgg_apply: Optional[Callable] = None, remat=False
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The unified step's forward on a training pair: ResUNet (in train
    mode: batch statistics, running statistics updated once) -> L1 +
    ``perceptual_weight`` x MSE of ``vgg_apply`` features. ``bad01`` and
    ``clean01`` are float01 ``[B, H, W, C]``. Returns ``(loss, aux)``;
    ``loss.backward()`` gives the parameters' gradients.

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
                                   pixel="l1")


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
