"""ResUNet — the unified all-distortion restorer (NCHW).

Port of ``tsr_tpu/models/resunet.py``, laid out and named as the
reference's torch module (ref:14:96-186): a conv+PReLU stem ``enc1``,
``ResidualBlock``s (conv3-BN-PReLU-conv3-BN with a 1x1-conv-BN shortcut
when channels change, fused by ReLU(a+b)) at ``widths``, a
``bottleneck`` of three blocks, ConvTranspose(k=2, s=2) upsampling and
channel-concat skips. The reference's ``F.interpolate`` shape fix before
each concat is a no-op at spatial sizes divisible by 8, which the
forward checks instead. In train mode its batch norms normalize with batch
statistics and update their running statistics by Flax's rule
(``models/layers.py``).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from tsr_tpu_torch.device import compute_dtype
from tsr_tpu_torch.models.layers import (BatchNorm2d, Conv2d, ConvTranspose2d,
                                         PReLU)


class ResidualBlock(nn.Module):
    """ref:14:96-115."""

    def __init__(self, in_c: int, out_c: int):
        super().__init__()
        self.conv_block = nn.Sequential(
            Conv2d(in_c, out_c, 3, padding=1), BatchNorm2d(out_c), PReLU(),
            Conv2d(out_c, out_c, 3, padding=1), BatchNorm2d(out_c))
        self.shortcut = nn.Sequential()
        if in_c != out_c:
            self.shortcut = nn.Sequential(Conv2d(in_c, out_c, 1),
                                          BatchNorm2d(out_c))

    def forward(self, x):
        return F.relu(self.conv_block(x) + self.shortcut(x))


class ResUNet(nn.Module):
    """Residual U-Net (ref:14:117-186); ``len(widths)`` levels.

    Args:
      widths: encoder widths, reference (64, 128, 256).
      bottleneck_width: reference 512.
      dtype: compute dtype (parameters stay float32).
    """

    def __init__(self, widths: Sequence[int] = (64, 128, 256),
                 bottleneck_width: int = 512, dtype=torch.float32):
        super().__init__()
        self.widths = tuple(widths)
        self.dtype = compute_dtype(dtype)
        w0, wl = self.widths[0], self.widths[-1]
        self.enc1 = nn.Sequential(Conv2d(3, w0, 3, padding=1), PReLU())
        in_c = w0
        for i, w in enumerate(self.widths):
            setattr(self, f"res{i + 1}", ResidualBlock(in_c, w))
            in_c = w
        self.bottleneck = nn.Sequential(
            ResidualBlock(wl, bottleneck_width),
            ResidualBlock(bottleneck_width, bottleneck_width),
            ResidualBlock(bottleneck_width, wl))
        # dec: up3(256->128) concat r3 -> dec3(384->128), ...; up1 maps
        # 64->64 (ref:14:140-147)
        up = [w0] + list(self.widths[:-1])
        in_c = wl
        for i in reversed(range(len(self.widths))):
            setattr(self, f"up{i + 1}", ConvTranspose2d(in_c, up[i], 2,
                                                        stride=2))
            out_c = self.widths[max(i - 1, 0)]
            setattr(self, f"dec{i + 1}",
                    ResidualBlock(up[i] + self.widths[i], out_c))
            in_c = out_c
        self.final = Conv2d(w0, 3, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """``[B, 3, H, W]`` float -> ``[B, 3, H, W]`` in the input's dtype."""
        div = 2 ** len(self.widths)
        if x.shape[2] % div or x.shape[3] % div:
            raise ValueError(f"ResUNet needs H and W divisible by {div}, "
                             f"got {tuple(x.shape)}")
        orig_dtype = x.dtype
        h = self.enc1(x.to(self.dtype))
        skips = []
        for i in range(len(self.widths)):
            h = getattr(self, f"res{i + 1}")(h)
            skips.append(h)
            h = F.max_pool2d(h, 2, 2)
        h = self.bottleneck(h)
        for i in reversed(range(len(self.widths))):
            h = getattr(self, f"up{i + 1}")(h)
            h = getattr(self, f"dec{i + 1}")(torch.cat((h, skips[i]), dim=1))
        return self.final(h).to(orig_dtype)
