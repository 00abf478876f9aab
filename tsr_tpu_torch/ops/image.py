"""Image dtype round-trips, resizing, normalization and quality metrics
(NHWC).

Port of ``tsr_tpu/ops/image.py``. The reference round-trips through uint8
between distortion stages with numpy-cast semantics (truncation toward
zero, modulo-256 wrap) and cv2 rounding inside filter2D; those bit-level
behaviours shape the distortion distribution and are reproduced exactly.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from tsr_tpu_torch import configs


def to_float01(images_u8: torch.Tensor) -> torch.Tensor:
    """uint8 [0,255] -> float32 [0,1]."""
    return images_u8.to(torch.float32) / 255.0


def scale255(f01: torch.Tensor, eps: float = 1e-3) -> torch.Tensor:
    """``f01 * 255`` with near-integer snapping.

    ``(u/255)*255`` can land a hair below the integer numpy reaches exactly
    (division may run as a multiply by the reciprocal); snapping restores
    the lossless uint8 -> [0,1] -> uint8 pass-through while leaving genuinely
    fractional distorted values untouched.
    """
    x = f01.to(torch.float32) * 255.0
    r = torch.round(x)
    return torch.where((x - r).abs() <= eps, r, x)


def numpy_uint8_cast(x: torch.Tensor) -> torch.Tensor:
    """Emulate ``np.uint8(x)`` for float ``x``: truncate toward zero, then
    wrap modulo 256 (negatives become bright pixels, ref:02:20-26)."""
    t = torch.remainder(torch.trunc(x.to(torch.float32)), 256.0)
    return t.to(torch.uint8)


def saturate_uint8(x: torch.Tensor, round: bool = False) -> torch.Tensor:
    """cv2-style ``saturate_cast<uchar>``: clip to [0,255], optionally after
    cvRound (round-half-to-even, as ``torch.round``) instead of truncation."""
    x = x.to(torch.float32)
    x = torch.round(x) if round else torch.trunc(x)
    return x.clamp(0.0, 255.0).to(torch.uint8)


def clip01_to_uint8(x01: torch.Tensor) -> torch.Tensor:
    """``np.clip(x*255, 0, 255).astype(np.uint8)`` (ref:04:30, 14:64, 16:37)."""
    return saturate_uint8(scale255(x01), round=False)


def resize_linear(x: torch.Tensor, size) -> torch.Tensor:
    """``jax.image.resize(x, ..., "linear")`` on a float ``[B, H, W, C]``
    batch: bilinear with half-pixel centres, and a triangle filter widened
    by the scale when downsampling (antialiasing), which is what
    ``antialias=True`` selects here; without it a downsample differs by
    0.3-0.5. ``size`` is an int (square) or ``(height, width)``."""
    if isinstance(size, int):
        size = (size, size)
    out = F.interpolate(x.permute(0, 3, 1, 2), size=tuple(size),
                        mode="bilinear", align_corners=False, antialias=True)
    return out.permute(0, 2, 3, 1)


def imagenet_normalize(x01: torch.Tensor) -> torch.Tensor:
    """ImageNet mean/std normalization over the last (channel) axis
    (ref:05:27-29)."""
    mean = torch.tensor(configs.IMAGENET_MEAN, dtype=x01.dtype,
                        device=x01.device)
    std = torch.tensor(configs.IMAGENET_STD, dtype=x01.dtype,
                       device=x01.device)
    return (x01 - mean) / std


def psnr(a_u8: torch.Tensor, b_u8: torch.Tensor,
         data_range: float = 255.0) -> torch.Tensor:
    """Peak signal-to-noise ratio over the last three axes, skimage-compatible
    (ref:08:123)."""
    a = a_u8.to(torch.float32)
    b = b_u8.to(torch.float32)
    mse = ((a - b) ** 2).mean(dim=(-3, -2, -1))
    return 10.0 * torch.log10((data_range ** 2) / mse)


def ssim(a_u8: torch.Tensor, b_u8: torch.Tensor, data_range: float = 255.0,
         win_size: int = 7) -> torch.Tensor:
    """Structural similarity with skimage's defaults (ref:08:125): uniform
    ``win_size`` window per channel, sample covariance (N-1), statistics
    over the VALID window positions, averaged per image.

    Args:
      a_u8, b_u8: ``[B, H, W, C]``.
    Returns:
      ``[B]`` mean SSIM per image.
    """
    a = a_u8.to(torch.float32).permute(0, 3, 1, 2)
    b = b_u8.to(torch.float32).permute(0, 3, 1, 2)
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    n = win_size * win_size
    cov_norm = n / (n - 1.0)

    def filt(x):
        return F.avg_pool2d(x, win_size, stride=1)

    ux, uy = filt(a), filt(b)
    uxx, uyy, uxy = filt(a * a), filt(b * b), filt(a * b)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)
    s = ((2 * ux * uy + c1) * (2 * vxy + c2)) / (
        (ux * ux + uy * uy + c1) * (vx + vy + c2))
    return s.mean(dim=(1, 2, 3))
