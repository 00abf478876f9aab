"""Host (numpy) PSNR and SSIM of uint8 batches, for the scripts and for
library users who hold images on the host.

Port of ``tsr_tpu/ops/image_host.py``, the same formulas as
``ops.image.psnr`` / ``ops.image.ssim`` (skimage-compatible,
ref:08:123-125): a uniform ``win_size`` window, 'valid' crop,
sample-covariance normalization, the mean over pixels and channels.

The reference filters with ``cv2.boxFilter`` (BORDER_CONSTANT, then the
valid crop), which sums each window in float64 and scales the sum to
float32; the port may not import cv2, so :func:`_uniform_valid` does the
same from float64 cumulative sums.

No module or script of the port calls these. In the JAX package their
caller is ``infer.restore_tree``'s host scoring; the port's
``restore_tree`` scores on the card instead (``ops.image.psnr`` /
``ssim`` in its fused step). They are the library's host API, kept equal
to ``tsr_tpu.ops.image_host`` for callers whose images are on the host.
"""

from __future__ import annotations

import numpy as np


def psnr(a_u8: np.ndarray, b_u8: np.ndarray,
         data_range: float = 255.0) -> np.ndarray:
    """[B,H,W,C] uint8 x2 -> [B] PSNR in dB (ops.image.psnr equivalent)."""
    a = a_u8.astype(np.float32)
    b = b_u8.astype(np.float32)
    axes = tuple(range(a.ndim - 3, a.ndim))
    mse = np.mean((a - b) ** 2, axis=axes)
    with np.errstate(divide="ignore"):
        return 10.0 * np.log10((data_range ** 2) / mse)


def _uniform_valid(x: np.ndarray, win: int) -> np.ndarray:
    """'valid' uniform ``win`` x ``win`` mean of a float32 ``[H, W, C]``
    image: each window's sum from float64 cumulative sums, times
    ``1 / win**2``, cast to float32 -> ``[H - win + 1, W - win + 1, C]``."""
    s = np.zeros((x.shape[0] + 1, x.shape[1] + 1) + x.shape[2:], np.float64)
    s[1:, 1:] = x.astype(np.float64).cumsum(0).cumsum(1)
    box = (s[win:, win:] - s[:-win, win:] - s[win:, :-win]
           + s[:-win, :-win])
    return (box * (1.0 / (win * win))).astype(np.float32)


def ssim(a_u8: np.ndarray, b_u8: np.ndarray, data_range: float = 255.0,
         win_size: int = 7) -> np.ndarray:
    """[B,H,W,C] uint8 x2 -> [B] mean SSIM (ops.image.ssim equivalent)."""
    k1, k2 = 0.01, 0.03
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    n = win_size * win_size
    cov_norm = n / (n - 1.0)

    out = np.empty(a_u8.shape[0], np.float32)
    for i in range(a_u8.shape[0]):
        a = a_u8[i].astype(np.float32)
        b = b_u8[i].astype(np.float32)
        ux = _uniform_valid(a, win_size)
        uy = _uniform_valid(b, win_size)
        uxx = _uniform_valid(a * a, win_size)
        uyy = _uniform_valid(b * b, win_size)
        uxy = _uniform_valid(a * b, win_size)
        vx = cov_norm * (uxx - ux * ux)
        vy = cov_norm * (uyy - uy * uy)
        vxy = cov_norm * (uxy - ux * uy)
        s = ((2 * ux * uy + c1) * (2 * vxy + c2)) / (
            (ux * ux + uy * uy + c1) * (vx + vy + c2))
        out[i] = float(np.mean(s))
    return out
