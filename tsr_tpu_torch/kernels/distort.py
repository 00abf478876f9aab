"""Kernel B1: fused fog + noise prologue of the random-mix distortion
(``csrc/fog_noise.cu``), plus its plain PyTorch version.

Port of ``tsr_tpu/kernels/distort.py::fused_fog_noise``. Outputs:

  f_noblur   float01 image after the fog and noise gates (no-blur branch)
  pre_blur   ``clip(trunc(snap(f*255)), 0, 255)``: the blur's uint8-valued
             float input (ref:14:52)

The kernel-backed random mix that drives it (the port of
``apply_random_distortions_pallas``) is
``tsr_tpu_torch.ops.distortions.apply_random_distortions``: the port has
one random mix, and it runs on the kernels.
"""

from __future__ import annotations

import ctypes

import torch

from tsr_tpu_torch.kernels import _build
from tsr_tpu_torch.kernels._build import Kernel

FOG_NOISE = Kernel(
    "fog_noise", "fog_noise.cu", "tsr_fog_noise",
    [ctypes.c_void_p] * 6 + [ctypes.c_float, ctypes.c_int, ctypes.c_int64,
                             ctypes.c_int64] + [ctypes.c_void_p] * 3)


def fog_noise_plain(clean_u8, gate_fog, t, gate_noise, sigma,
                    atmosphere: float = 0.9, noise=None, generator=None):
    """Plain PyTorch version of B1, with the kernel's arithmetic.

    ``noise`` is an optional pre-drawn N(0,1) field shaped like
    ``clean_u8``; without it the field is drawn from ``generator``.
    """
    x = clean_u8.to(torch.float32) * (1.0 / 255.0)
    t = t.to(torch.float32).reshape(-1, 1, 1, 1)
    fogged = x * t + atmosphere * (1.0 - t)
    x = torch.where(gate_fog.reshape(-1, 1, 1, 1) != 0, fogged, x)
    if noise is None:
        noise = torch.randn(x.shape, generator=generator, device=x.device,
                            dtype=torch.float32)
    sigma = sigma.to(torch.float32).reshape(-1, 1, 1, 1)
    x = torch.where(gate_noise.reshape(-1, 1, 1, 1) != 0,
                    x + sigma * noise.to(torch.float32), x)
    s = x * 255.0
    r = torch.round(s)
    s = torch.where((s - r).abs() <= 1e-3, r, s)
    return x, torch.trunc(s).clamp(0.0, 255.0)


def fused_fog_noise(clean_u8, seed, gate_fog, t, gate_noise, sigma,
                    atmosphere: float = 0.9, noise=None, row0: int = 0,
                    group_rows=None):
    """Run the fused fog + noise prologue.

    Args:
      clean_u8: uint8 ``[B, H, W, C]``.
      seed: int64 tensor ``[1]`` (or an int) keying the kernel's Philox
        noise stream; on the CPU it seeds the plain version's generator
        when no ``noise`` is given.
      gate_fog / gate_noise: int32 ``[B]`` (0/1).
      t: float32 ``[B]`` fog transmission.
      sigma: float32 ``[B]`` noise stddev.
      noise: CPU only, a pre-drawn N(0,1) field for the group (rows
        ``row0:row0 + B`` are used); the CUDA kernel draws its own.
      row0: the global index of the call's first sample in its noise
        group (a rank's rows of a batch): the kernel keys sample ``b``'s
        Philox counter with ``b + row0``, so split calls with their
        ``row0`` draw the unsplit call's noise. 0 keeps the stream of a
        whole batch.
      group_rows: the group's sample count (default ``row0 + B``); the
        CPU version draws the group's field from ``seed`` and takes its
        rows.

    Returns:
      ``(f_noblur, pre_blur)``, both float32 ``[B, H, W, C]``.
    """
    b = clean_u8.shape[0]
    group_rows = row0 + b if group_rows is None else group_rows
    if not 0 <= row0 <= group_rows - b:
        raise ValueError(f"rows {row0}:{row0 + b} outside a group of "
                         f"{group_rows}")
    if not _build.on_cuda(clean_u8):
        if noise is None:
            generator = torch.Generator().manual_seed(
                int(torch.as_tensor(seed).reshape(-1)[0]))
            noise = torch.randn((group_rows, *clean_u8.shape[1:]),
                                generator=generator)
        elif noise.shape[0] < row0 + b:
            raise ValueError(f"noise has {noise.shape[0]} rows; rows "
                             f"{row0}:{row0 + b} are needed")
        return fog_noise_plain(clean_u8, gate_fog, t, gate_noise, sigma,
                               atmosphere, noise[row0:row0 + b])
    if noise is not None:
        raise ValueError("the CUDA kernel draws its own noise from `seed`; "
                         "`noise` is for the CPU version")
    if clean_u8.dtype != torch.uint8 or clean_u8.ndim != 4:
        raise ValueError(f"clean_u8 must be uint8 [B,H,W,C], got "
                         f"{clean_u8.dtype} {tuple(clean_u8.shape)}")
    dev = clean_u8.device
    clean_u8 = clean_u8.contiguous()
    seed = torch.as_tensor(seed, dtype=torch.int64, device=dev).reshape(1)
    params = []
    for name, v, dtype in (("gate_fog", gate_fog, torch.int32),
                           ("t", t, torch.float32),
                           ("gate_noise", gate_noise, torch.int32),
                           ("sigma", sigma, torch.float32)):
        if v.shape != (b,) or v.device != dev:
            raise ValueError(f"{name} must be [{b}] on {dev}, got "
                             f"{tuple(v.shape)} on {v.device}")
        params.append(v.to(dtype).contiguous())
    f = torch.empty(clean_u8.shape, dtype=torch.float32, device=dev)
    pre = torch.empty_like(f)
    if f.numel() == 0:
        return f, pre
    FOG_NOISE.launch(clean_u8.data_ptr(), params[0].data_ptr(),
                     params[1].data_ptr(), params[2].data_ptr(),
                     params[3].data_ptr(), seed.data_ptr(), float(atmosphere),
                     b, clean_u8[0].numel(), int(row0), f.data_ptr(),
                     pre.data_ptr(),
                     torch.cuda.current_stream(dev).cuda_stream)
    return f, pre
