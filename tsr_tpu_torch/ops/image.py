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


def minmax_normalize_u8(images_f32: torch.Tensor) -> torch.Tensor:
    """``cv2.normalize(x, x, 0, 255, NORM_MINMAX)`` on a uint8 batch
    (ref:03:29): joint min/max over all pixels *and* channels per image,
    scaled to [0,255] with cvRound + saturation; a constant image becomes 0.

    Args:
      images_f32: ``[B, H, W, C]`` float32 holding integral uint8 values.
    Returns:
      uint8 ``[B, H, W, C]``.
    """
    lo = images_f32.amin(dim=(1, 2, 3), keepdim=True)
    hi = images_f32.amax(dim=(1, 2, 3), keepdim=True)
    scale = torch.where(hi > lo, 255.0 / (hi - lo), torch.zeros_like(hi))
    return saturate_uint8((images_f32 - lo) * scale, round=True)


def _bilinear_taps(native: torch.Tensor, out: int):
    """Per-image two-tap bilinear sampling of one axis for native extents
    ``native`` ``[B]`` (half-pixel centres, edge clamp, no antialias: the
    cv2.INTER_LINEAR convention): ``(i0, i1, w)`` ``[B, out]``, output ``o``
    being ``x[i0]*(1-w) + x[i1]*w``. At the clamped edge ``i0 == i1`` and
    ``w == 0``."""
    n = native.to(torch.float32).reshape(-1, 1)
    o = torch.arange(out, dtype=torch.float32, device=native.device)
    # a tensor divisor: CUDA divides by a Python scalar as a multiply by its
    # reciprocal, an ulp off the CPU's (and the reference's) quotient
    src = (o + 0.5) * (n / torch.full_like(n, out)) - 0.5
    src = torch.minimum(src.clamp_min(0.0), n - 1.0)
    i0f = torch.floor(src)
    w = src - i0f
    i0 = i0f.to(torch.int64)
    i1 = torch.minimum(i0 + 1, native.to(torch.int64).reshape(-1, 1) - 1)
    return i0, i1, w


def resize_from_padded(padded_u8: torch.Tensor, sizes_hw: torch.Tensor,
                       out_size: int) -> torch.Tensor:
    """Per-image bilinear resize of native-size images on a padded canvas.

    Args:
      padded_u8: ``[B, Hp, Wp, C]`` uint8, image ``b`` in its top-left
        ``sizes_hw[b]`` corner (the rest is never sampled).
      sizes_hw: ``[B, 2]`` integer native (height, width), on the device of
        ``padded_u8``; it is never read back to the host.
      out_size: output side.
    Returns:
      ``[B, out_size, out_size, C]`` uint8, ``clip(rint(.))`` of the float32
      resize: within 1 LSB of cv2.resize(INTER_LINEAR), whose fixed-point
      coefficients differ; an exact copy where the native size equals
      ``out_size``.

    Port of ``tsr_tpu/ops/image.py::resize_from_padded``, which contracts
    each axis with a dense one-hot weight matrix for the TPU's matrix unit.
    Each output row and column has two nonzero weights, so here each axis is
    a gather of its two source lines and a lerp (rows, then columns) from
    index tensors computed on the device: the same float32 products and sum,
    with no matrix product that TF32 could round.
    """
    b, _, _, c = padded_u8.shape
    x = padded_u8.to(torch.float32)
    sizes = sizes_hw.to(padded_u8.device)
    i0, i1, w = _bilinear_taps(sizes[:, 0], out_size)  # rows [B, out]

    def rows(idx):
        return torch.gather(x, 1, idx[:, :, None, None].expand(
            -1, -1, x.shape[2], c))

    wy = w[:, :, None, None]
    t = rows(i0) * (1.0 - wy) + rows(i1) * wy       # [B, out, Wp, C]
    j0, j1, wx = _bilinear_taps(sizes[:, 1], out_size)  # columns [B, out]

    def cols(idx):
        return torch.gather(t, 2, idx[:, None, :, None].expand(
            -1, out_size, -1, c))

    wx = wx[:, None, :, None]
    out = cols(j0) * (1.0 - wx) + cols(j1) * wx     # [B, out, out, C]
    return torch.round(out).clamp(0.0, 255.0).to(torch.uint8)


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
