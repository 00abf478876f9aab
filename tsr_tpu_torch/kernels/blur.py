"""Per-sample 2-D correlation: kernels B2 (sparse runs) and B3 (dense runs)
in ``csrc/blur_taps.cu``, plus their plain PyTorch versions.

Port of ``tsr_tpu/kernels/blur_pallas.py``. Semantics match
``tsr_tpu_torch.ops.blur.filter2d``: correlation (no kernel flip),
reflect-101 border, anchor ``K // 2``.

Both kernels are exact for any kernel. Each call first builds, on the card,
a run list per sample from its ``[K, K]`` weights: B2 keeps each row's span
from its first to its last nonzero tap and skips empty rows, B3 keeps every
row whole. A motion-blur kernel is a rasterized line (at most 41 nonzeros
at K=15 over degrees 5-15 and every angle), so B2 runs few taps. The TPU
kernel instead keeps each sample's top ``min(K*K, 3K)`` taps by value
(``lax.top_k``), which is exact only when they cover the nonzeros; it does
for every kernel the random mix draws. :func:`sparse_taps` and
:func:`sparse_kernels` reproduce that selection, ties broken as
``lax.top_k`` breaks them (lowest index first).

With ``f`` and ``gate_blur`` a kernel also runs the random mix's epilogue
in its store and returns the mix's final uint8
(:func:`random_mix_epilogue_plain`).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from tsr_tpu_torch.kernels import _build
from tsr_tpu_torch.kernels._build import Kernel
from tsr_tpu_torch.ops import image as image_ops

# x, kernels, kernel sample stride, runs, runs' words, f, gate, B, H, W, C,
# K, out, out_u8, stream
_ARGTYPES = ([ctypes.c_void_p] * 2 + [ctypes.c_int64, ctypes.c_void_p,
                                      ctypes.c_int64]
             + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 5
             + [ctypes.c_void_p] * 3)
BLUR_SPARSE = Kernel("blur_sparse", "blur_taps.cu", "tsr_blur_sparse",
                     _ARGTYPES)
BLUR_DENSE = Kernel("blur_dense", "blur_taps.cu", "tsr_blur_dense", _ARGTYPES)


def default_max_taps(ksize: int) -> int:
    return min(ksize * ksize, 3 * ksize)


def sparse_taps(kernels: torch.Tensor, max_taps: int):
    """Each sample's ``max_taps`` largest taps, as the TPU kernel keeps
    them: ``(w [B,T] f32, flat index [B,T] int64)`` into the row-major
    ``K*K`` kernel (blur weights are >= 0). Equal weights keep the lower
    index first, as ``lax.top_k`` does."""
    flat = kernels.reshape(kernels.shape[0], -1).to(torch.float32)
    w, idx = torch.sort(flat, dim=1, descending=True, stable=True)
    return w[:, :max_taps], idx[:, :max_taps]


def sparse_kernels(kernels: torch.Tensor, max_taps: int) -> torch.Tensor:
    """The kernels with every tap outside the top ``max_taps`` set to zero:
    the dense kernel whose correlation the TPU's sparse kernel computes."""
    w, idx = sparse_taps(kernels, max_taps)
    flat = torch.zeros_like(kernels.reshape(kernels.shape[0], -1),
                            dtype=torch.float32)
    return flat.scatter(1, idx, w).reshape(kernels.shape)


def run_words(ksize: int) -> int:
    """32-bit words of one sample's run list (``run_words`` in the source)."""
    return 4 + 4 * ksize + ksize * ((ksize + 3) // 4 * 4)


def filter2d_plain(images: torch.Tensor, kernels: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of B2/B3: reflect-101 pad + grouped conv.

    Args:
      images: float32 ``[B, H, W, C]``.
      kernels: float32 ``[B, K, K]``.
    """
    b, h, w, c = images.shape
    k = kernels.shape[-1]
    lo, hi = k // 2, k - 1 - k // 2
    x = images.to(torch.float32).permute(0, 3, 1, 2).reshape(1, b * c, h, w)
    x = F.pad(x, (lo, hi, lo, hi), mode="reflect")  # torch 'reflect' == cv2 REFLECT_101
    weight = kernels.to(torch.float32).repeat_interleave(c, dim=0)
    out = F.conv2d(x, weight.reshape(b * c, 1, k, k), groups=b * c)
    return out.reshape(b, c, h, w).permute(0, 2, 3, 1).contiguous()


def random_mix_epilogue_plain(blurred: torch.Tensor, f: torch.Tensor,
                              gate_blur: torch.Tensor) -> torch.Tensor:
    """The random mix after its blur: cvRound/saturate the blur, keep it
    where the sample's blur gate is on and ``f`` elsewhere, then
    ``clip01_to_uint8`` (ref:14:56-64). Plain version of the kernels'
    epilogue mode."""
    blurred_u8f = image_ops.saturate_uint8(blurred, round=True).to(
        torch.float32)
    f = torch.where(gate_blur.reshape(-1, 1, 1, 1), blurred_u8f / 255.0, f)
    return image_ops.clip01_to_uint8(f)


def _launch(kernel: Kernel, images: torch.Tensor, kernels: torch.Tensor,
            f: Optional[torch.Tensor], gate_blur: Optional[torch.Tensor]
            ) -> torch.Tensor:
    if images.dtype != torch.float32 or images.ndim != 4:
        raise ValueError(f"images must be float32 [B,H,W,C], got "
                         f"{images.dtype} {tuple(images.shape)}")
    b, h, w, c = images.shape
    if not 1 <= c <= 4:
        raise ValueError(f"blur kernel takes 1-4 channels, got {c}")
    if (kernels.dtype != torch.float32 or kernels.ndim != 3
            or kernels.shape[0] != b or kernels.shape[1] != kernels.shape[2]):
        raise ValueError(f"kernels must be float32 [{b},K,K], got "
                         f"{kernels.dtype} {tuple(kernels.shape)}")
    ksize = kernels.shape[-1]
    if ksize // 2 >= min(h, w):
        raise ValueError(f"reflect-101 border of a K={ksize} kernel needs "
                         f"H and W above {ksize // 2}, got {h}x{w}")
    dev = images.device
    if kernels.device != dev:
        raise ValueError("kernels and images on different devices")
    images = images.contiguous()
    if kernels.stride()[1:] != (ksize, 1):  # a broadcast sample stride is kept
        kernels = kernels.contiguous()
    if (f is None) != (gate_blur is None):
        raise ValueError("the epilogue needs both f and gate_blur")
    runs = torch.empty(b * run_words(ksize), dtype=torch.float32, device=dev)
    if f is None:
        out = torch.empty_like(images)
        ptrs = (0, 0, out.data_ptr(), 0)
    else:
        if (f.dtype != torch.float32 or f.shape != images.shape
                or f.device != dev):
            raise ValueError(f"f must be float32 {tuple(images.shape)} on "
                             f"{dev}, got {f.dtype} {tuple(f.shape)}")
        if (gate_blur.dtype != torch.bool or gate_blur.shape != (b,)
                or gate_blur.device != dev):
            raise ValueError(f"gate_blur must be bool [{b}] on {dev}")
        f = f.contiguous()
        gate_blur = gate_blur.contiguous()
        out = torch.empty(images.shape, dtype=torch.uint8, device=dev)
        ptrs = (f.data_ptr(), gate_blur.data_ptr(), 0, out.data_ptr())
    if out.numel() == 0:
        return out
    kernel.launch(images.data_ptr(), kernels.data_ptr(), kernels.stride(0),
                  runs.data_ptr(), runs.numel(), ptrs[0], ptrs[1], b, h, w,
                  c, ksize, ptrs[2], ptrs[3],
                  torch.cuda.current_stream(dev).cuda_stream)
    return out


def _filter2d(kernel: Kernel, images, kernels, f, gate_blur):
    if not _build.on_cuda(images):
        out = filter2d_plain(images, kernels)
        return out if f is None else random_mix_epilogue_plain(out, f,
                                                               gate_blur)
    return _launch(kernel, images, kernels, f, gate_blur)


def filter2d_sparse(images: torch.Tensor, kernels: torch.Tensor,
                    f: Optional[torch.Tensor] = None,
                    gate_blur: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Kernel B2: correlation over each row's span of nonzero taps.

    Args:
      images: float32 ``[B, H, W, C]``.
      kernels: float32 ``[B, K, K]``.
      f, gate_blur: optional float32 ``[B, H, W, C]`` and bool ``[B]``;
        with them the result is the random mix's uint8
        (:func:`random_mix_epilogue_plain`).
    """
    return _filter2d(BLUR_SPARSE, images, kernels, f, gate_blur)


def filter2d_dense(images: torch.Tensor, kernels: torch.Tensor,
                   f: Optional[torch.Tensor] = None,
                   gate_blur: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Kernel B3: correlation over all K*K taps of each sample's kernel
    (arguments as :func:`filter2d_sparse`)."""
    return _filter2d(BLUR_DENSE, images, kernels, f, gate_blur)
