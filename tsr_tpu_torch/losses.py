"""Training losses.

Port of ``tsr_tpu/losses.py``:

- MSE pixel loss (ref:07:142)
- L1 pixel loss (ref:14:219)
- VGG perceptual loss: mean squared distance in ``features[:16]`` space of a
  frozen VGG16 (ref:07adv:95-112, ref:14:189-196). Reference quirk preserved:
  the perceptual network receives **un-normalized [0,1] images**, no
  ImageNet normalization (ref:07adv:150-151, ref:14:239).
- Cross-entropy for the judge (ref:05:59).

Images are NCHW here, as the port's models take them; every loss is a mean
over all elements, so the layout does not change its value.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from tsr_tpu_torch.models import vgg as vgg_mod


def mse_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return ((pred - target) ** 2).mean()


def l1_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return (pred - target).abs().mean()


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       label_smoothing: float = 0.0) -> torch.Tensor:
    """Mean softmax cross-entropy of ``[B, C]`` logits against integer
    labels. With ``label_smoothing`` = a the target is optax's
    ``smooth_labels``: ``onehot * (1 - a) + a / C``, the formula
    ``F.cross_entropy`` uses too."""
    return F.cross_entropy(logits, labels.long(),
                           label_smoothing=label_smoothing)


def freeze(vgg: vgg_mod.VGG16) -> vgg_mod.VGG16:
    """Eval mode and ``requires_grad=False`` on every parameter: gradients
    still flow through the net to its input, never into it (the
    reference's ``requires_grad = False``)."""
    vgg.eval()
    vgg.requires_grad_(False)
    return vgg


def perceptual_features(vgg: vgg_mod.VGG16,
                        upto: int = vgg_mod.PERCEPTUAL_TAP + 1
                        ) -> Callable[[torch.Tensor], torch.Tensor]:
    """Freeze ``vgg`` and return ``x01 -> features[:upto](x01)``
    (:func:`models.vgg.feature_slice_apply`): the ``vgg_apply`` the unified
    train step and trainer take."""
    freeze(vgg)
    return lambda x01: vgg_mod.feature_slice_apply(vgg, x01, upto)


def make_perceptual_loss(vgg: vgg_mod.VGG16, upto: int = 16
                         ) -> Callable[[torch.Tensor, torch.Tensor],
                                       torch.Tensor]:
    """Build ``phi(x), phi(y) -> mean((phi(x)-phi(y))**2)`` with a frozen
    VGG ``features[:upto]`` slice (ref:07adv:95-112).

    As the reference's, the tap is ``upto - 1`` in the built variant's own
    indexing (not translated for a batch-norm variant; use
    :func:`perceptual_features` for that).
    """
    freeze(vgg)
    tap = upto - 1

    def perceptual(x01, y01):
        return mse_loss(vgg(x01, tap_layer=tap), vgg(y01, tap_layer=tap))

    return perceptual


def restoration_loss(pred: torch.Tensor, target: torch.Tensor,
                     perceptual: Optional[Callable] = None,
                     perceptual_weight: float = 0.1, pixel: str = "l1"
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Combined restoration loss.

    ``pixel='mse'`` with no perceptual = specialized trainer (ref:07:142);
    ``pixel='l1'`` + 0.1·perceptual = advanced/unified trainers
    (ref:07adv:150-154, ref:14:238-242).
    Returns (loss, aux dict).
    """
    pix = mse_loss(pred, target) if pixel == "mse" else l1_loss(pred, target)
    aux = {"pixel_loss": pix}
    loss = pix
    if perceptual is not None:
        p = perceptual(pred, target)
        aux["perceptual_loss"] = p
        loss = loss + perceptual_weight * p
    aux["loss"] = loss
    return loss, aux
