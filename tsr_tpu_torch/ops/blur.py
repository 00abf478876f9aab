"""Linear motion-blur: kernel synthesis + batched per-sample correlation.

Port of ``tsr_tpu/ops/blur.py``. The reference builds its blur kernel as
``cv2.warpAffine(np.diag(np.ones(d)), cv2.getRotationMatrix2D((d/2, d/2),
angle, 1), (d, d)) / d`` and applies it with ``cv2.filter2D`` (ref:03:11-30,
ref:14:50-60). The rotated diagonal is evaluated in closed form, a bilinear
sample of the implicit diagonal image, for a whole batch of per-sample
``degree``/``angle`` at once into a fixed ``max_degree`` buffer.

``filter2d`` has cv2 semantics: correlation (no kernel flip),
BORDER_REFLECT_101, anchor ``k // 2``, and is exact for any kernel, as
``tsr_tpu.ops.blur.filter2d``'s grouped convolution is. A CPU tensor takes
the plain PyTorch version; a CUDA tensor takes the hand-written kernels
(``tsr_tpu_torch.kernels.blur``): B2 (each row's span of nonzero taps) by
default, B3 (all K*K taps) after ``set_backend("dense")`` and for every
shared kernel. Given the random mix's ``f`` and ``gate_blur``, the kernel
also runs the mix's epilogue and returns its uint8.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from tsr_tpu_torch.kernels import blur as blur_kernels

_BACKEND = "sparse"


def set_backend(name: str) -> None:
    """Select the per-sample blur kernel: ``"sparse"`` (B2, each row's span
    of nonzero taps, the default) or ``"dense"`` (B3, all K*K taps). Both
    give the same correlation."""
    global _BACKEND
    if name not in ("sparse", "dense"):
        raise ValueError(f"unknown blur backend {name!r}")
    _BACKEND = name


def motion_blur_kernels(degrees, angles, max_degree: int) -> torch.Tensor:
    """Closed-form cv2-parity motion-blur kernels, ``[B, max_degree,
    max_degree]`` float32 on the device of ``degrees``.

    Evaluates ``warpAffine(diag(ones(degree)), getRotationMatrix2D((degree/2,
    degree/2), angle, 1), (degree, degree)) / degree`` (ref:03:17-21) per
    sample. Each ``degree``-sized kernel sits so that its cv2 anchor
    (``degree // 2``) coincides with the buffer anchor (``max_degree //
    2``), making one ``filter2d`` call correct for any mix of degrees.
    """
    degrees = torch.as_tensor(degrees)
    angles = torch.as_tensor(angles, device=degrees.device)
    dev = degrees.device
    deg_i = degrees.to(torch.int64).reshape(-1, 1, 1)
    deg = deg_i.to(torch.float32)
    theta = angles.to(torch.float32).reshape(-1, 1, 1) * (math.pi / 180.0)
    a = torch.cos(theta)
    b = torch.sin(theta)
    # getRotationMatrix2D((cx,cy), angle, 1):
    #   M = [[a, b, (1-a)cx - b*cy], [-b, a, b*cx + (1-a)cy]]
    cx = deg / 2.0
    cy = deg / 2.0
    tx = (1.0 - a) * cx - b * cy
    ty = b * cx + (1.0 - a) * cy

    off = (max_degree // 2) - torch.div(deg_i, 2, rounding_mode="floor")

    # buffer coords (u=row, v=col) -> kernel coords (i=row=y, j=col=x)
    grid = torch.arange(max_degree, device=dev, dtype=torch.int64)
    i = (grid.reshape(1, -1, 1) - off).to(torch.float32)
    j = (grid.reshape(1, 1, -1) - off).to(torch.float32)

    # warpAffine inverts M internally: src = A^T (dst - t) for a rotation
    sx = a * (j - tx) - b * (i - ty)
    sy = b * (j - tx) + a * (i - ty)

    # bilinear sample of the implicit diagonal image D[r,c] = (r == c < d)
    # with BORDER_CONSTANT(0), cv2's warpAffine default
    x0 = torch.floor(sx)
    y0 = torch.floor(sy)
    dx = sx - x0
    dy = sy - y0

    def diag_at(r, c):
        inside = (r >= 0) & (r < deg) & (c >= 0) & (c < deg)
        return ((r == c) & inside).to(torch.float32)

    val = ((1 - dy) * (1 - dx) * diag_at(y0, x0)
           + (1 - dy) * dx * diag_at(y0, x0 + 1)
           + dy * (1 - dx) * diag_at(y0 + 1, x0)
           + dy * dx * diag_at(y0 + 1, x0 + 1))
    in_window = ((i >= 0) & (i < deg) & (j >= 0) & (j < deg)).to(
        torch.float32)
    return val * in_window / deg


def motion_blur_kernel(degree: int, angle: float, max_degree: int,
                       device="cpu") -> torch.Tensor:
    """One ``[max_degree, max_degree]`` kernel (see :func:`motion_blur_kernels`)."""
    return motion_blur_kernels(
        torch.tensor([int(degree)], device=device),
        torch.tensor([float(angle)], device=device),
        max_degree)[0]


def filter2d(images: torch.Tensor, kernels: torch.Tensor,
             f: Optional[torch.Tensor] = None,
             gate_blur: Optional[torch.Tensor] = None) -> torch.Tensor:
    """cv2.filter2D-parity correlation with per-sample or shared kernels.

    Args:
      images: float32 ``[B, H, W, C]``.
      kernels: ``[B, K, K]`` (one kernel per sample) or ``[K, K]`` (shared).
      f, gate_blur: optional float32 ``[B, H, W, C]`` and bool ``[B]``: the
        random mix's no-blur image and blur gates.

    Returns:
      float32 ``[B, H, W, C]``, same spatial size (reflect-101 border); with
      ``f`` and ``gate_blur``, the random mix's uint8
      (``kernels.blur.random_mix_epilogue_plain`` of the blur).

    A shared kernel is broadcast and takes B3.
    """
    images = images.to(torch.float32)
    kernels = kernels.to(torch.float32)
    if kernels.ndim == 2:
        kernels = kernels.expand(images.shape[0], *kernels.shape)
        return blur_kernels.filter2d_dense(images, kernels, f, gate_blur)
    if _BACKEND == "sparse":
        return blur_kernels.filter2d_sparse(images, kernels, f, gate_blur)
    return blur_kernels.filter2d_dense(images, kernels, f, gate_blur)
