"""SimpleUNet — the specialized single-distortion restorer (NCHW).

Port of ``tsr_tpu/models/unet.py``, laid out and named as the reference's
torch module (ref:07:75-120): double-conv encoder blocks ``enc1``/``enc2``
(64, 128), a ``bottleneck`` at twice the last width, ConvTranspose(k=2,
s=2) upsampling ``up2``/``up1``, channel-concat skips with the decoder
output *first* (ref:07:112,116), and a 1x1 ``final`` conv to RGB. No
normalization layers; plain ReLU. A reference ``restoration_*.pth`` loads
by ``load_state_dict`` with no mapping.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from tsr_tpu_torch.device import compute_dtype
from tsr_tpu_torch.models.layers import Conv2d, ConvTranspose2d


class DoubleConv(nn.Sequential):
    """conv3x3 -> ReLU -> conv3x3 -> ReLU (ref:07:79-92); the convolutions
    are ``.0`` and ``.2``."""

    def __init__(self, in_c: int, out_c: int):
        super().__init__(Conv2d(in_c, out_c, 3, padding=1), nn.ReLU(),
                         Conv2d(out_c, out_c, 3, padding=1), nn.ReLU())


class SimpleUNet(nn.Module):
    """``len(widths)``-level U-Net restorer (ref:07:75-120).

    Args:
      widths: encoder widths, reference (64, 128); the bottleneck is
        ``2 * widths[-1]``.
      out_channels: output image channels.
      dtype: compute dtype (parameters stay float32).
      input_minmax: per-image min-max stretch of the input, over H, W and
        C in float32, before the cast to the compute dtype:
        ``(x - lo) / max(hi - lo, 1e-6)``. Fog is a global affine map that
        the conv stack's receptive field cannot estimate; the stretch is
        the one global statistic it lacks. Recorded in a checkpoint's
        ``config.json``, so ``zoo.load_model`` rebuilds it.
    """

    def __init__(self, widths: Sequence[int] = (64, 128),
                 out_channels: int = 3, dtype=torch.float32,
                 input_minmax: bool = False):
        super().__init__()
        self.widths = tuple(widths)
        self.dtype = compute_dtype(dtype)
        self.input_minmax = input_minmax
        in_c = 3
        for i, w in enumerate(self.widths):
            setattr(self, f"enc{i + 1}", DoubleConv(in_c, w))
            in_c = w
        self.bottleneck = DoubleConv(in_c, 2 * in_c)
        in_c = 2 * in_c
        for i in reversed(range(len(self.widths))):
            w = self.widths[i]
            setattr(self, f"up{i + 1}", ConvTranspose2d(in_c, w, 2, stride=2))
            setattr(self, f"dec{i + 1}", DoubleConv(2 * w, w))
            in_c = w
        self.final = Conv2d(in_c, out_channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """``[B, 3, H, W]`` float -> ``[B, out_channels, H, W]`` in the
        input's dtype."""
        div = 2 ** len(self.widths)
        if x.shape[2] % div or x.shape[3] % div:
            raise ValueError(f"SimpleUNet needs H and W divisible by {div}, "
                             f"got {tuple(x.shape)}")
        orig_dtype = x.dtype
        if self.input_minmax:
            x = x.to(torch.float32)
            lo = x.amin(dim=(1, 2, 3), keepdim=True)
            hi = x.amax(dim=(1, 2, 3), keepdim=True)
            x = (x - lo) / (hi - lo).clamp_min(1e-6)
        h = x.to(self.dtype)
        skips = []
        for i in range(len(self.widths)):
            h = getattr(self, f"enc{i + 1}")(h)
            skips.append(h)
            h = F.max_pool2d(h, 2, 2)
        h = self.bottleneck(h)
        for i in reversed(range(len(self.widths))):
            h = getattr(self, f"up{i + 1}")(h)
            # decoder output first, as torch.cat((d, e), dim=1) at
            # ref:07:112,116
            h = getattr(self, f"dec{i + 1}")(torch.cat((h, skips[i]), dim=1))
        return self.final(h).to(orig_dtype)
