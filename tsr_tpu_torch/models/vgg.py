"""VGG16 — the judge classifier and feature extractor (NCHW).

Port of ``tsr_tpu/models/vgg.py`` with torchvision's layout and names
(``features.N`` / ``classifier.N``), so torchvision-format state dicts load
unchanged and ``tap_layer=k`` returns the activation right after
``features[k]`` (2 = conv1_2, the hidden-state heatmaps' tap; 15 =
relu3_3, the end of the perceptual slice ``features[:16]``; 30 = the final
pool, the GAP embeddings' tap).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from tsr_tpu_torch.device import compute_dtype
from tsr_tpu_torch.models.layers import BatchNorm2d, Conv2d, Linear

# torchvision vgg16 'D' configuration: conv widths with 'M' maxpools.
VGG16_CFG: Tuple = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
                    512, 512, 512, "M", 512, 512, 512, "M")

PERCEPTUAL_TAP = 15   # end of features[:16] == relu3_3 (ref:07adv:102-103)
HIDDEN_STATE_TAP = 2  # conv1_2 pre-activation output (ref:11:93)
GAP_TAP = 30          # final pool -> [B, 512, 7, 7] (ref:12:37-44)


class VGG16(nn.Module):
    """VGG16-D with a classifier head.

    The judge path expects ImageNet-normalized input (ref:05:27-29);
    normalization is the caller's job. ``input_size`` fixes the first FC
    layer's width (``last conv width * (input_size / 2**pools)**2``).
    """

    def __init__(self, num_classes: int = 43, cfg: Tuple = VGG16_CFG,
                 fc_width: int = 4096, use_batchnorm: bool = False,
                 dropout_rate: float = 0.5, input_size: int = 224,
                 dtype=torch.float32):
        super().__init__()
        self.cfg = tuple(cfg)
        self.use_batchnorm = use_batchnorm
        self.dtype = compute_dtype(dtype)
        layers = []
        in_c = 3
        side = input_size
        for v in self.cfg:
            if v == "M":
                layers.append(nn.MaxPool2d(2, 2))
                side //= 2
            else:
                layers.append(Conv2d(in_c, v, 3, padding=1))
                if use_batchnorm:
                    layers.append(BatchNorm2d(v))
                layers.append(nn.ReLU())
                in_c = v
        self.features = nn.Sequential(*layers)
        self.classifier = nn.Sequential(
            Linear(in_c * side * side, fc_width), nn.ReLU(),
            nn.Dropout(dropout_rate),
            Linear(fc_width, fc_width), nn.ReLU(), nn.Dropout(dropout_rate),
            Linear(fc_width, num_classes))

    def tap_index(self, plain_idx: int) -> int:
        """Translate a plain-vgg16 ``features`` index (the reference's
        numbering) into this variant's index: vgg16_bn puts a BatchNorm
        after every conv, shifting every later index. Identity without
        batch norm."""
        if not self.use_batchnorm:
            return plain_idx
        plain = bn = 0
        for v in self.cfg:
            if v == "M":
                if plain_idx == plain:
                    return bn
                plain += 1
                bn += 1
            else:
                if plain_idx == plain:      # the conv itself
                    return bn
                if plain_idx == plain + 1:  # its relu (conv, bn, relu)
                    return bn + 2
                plain += 2
                bn += 3
        raise ValueError(f"plain tap index {plain_idx} out of range")

    def forward(self, x: torch.Tensor, tap_layer: Optional[int] = None,
                return_features: bool = False):
        """Args:
          x: ``[B, 3, H, W]`` float.
          tap_layer: if set, return the activation right after
            ``features[tap_layer]``.
          return_features: if True, return ``(logits, final pool output)``.
        Outputs are in the input's dtype.
        """
        orig_dtype = x.dtype
        h = x.to(self.dtype)
        if tap_layer is not None:
            if not 0 <= tap_layer < len(self.features):
                raise ValueError(f"tap_layer {tap_layer} out of range")
            return self.features[:tap_layer + 1](h).to(orig_dtype)
        feats = self.features(h)
        logits = self.classifier(torch.flatten(feats, 1)).to(orig_dtype)
        if return_features:
            return logits, feats.to(orig_dtype)
        return logits


def feature_slice_apply(vgg: VGG16, x: torch.Tensor,
                        upto: int = PERCEPTUAL_TAP + 1) -> torch.Tensor:
    """Run ``features[:upto]`` (plain-vgg16 torch indexing), i.e. tap at
    ``upto - 1`` translated for batch-norm variants by ``tap_index``. The
    perceptual loss uses ``upto=16`` (ref:07adv:102-103). The module's own
    mode (eval for a frozen net) decides its batch norms' statistics."""
    return vgg(x, tap_layer=vgg.tap_index(upto - 1))
