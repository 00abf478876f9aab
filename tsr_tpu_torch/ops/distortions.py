"""Batched distortion simulators for the serving slice.

Port of the random mix and the demo's compound chain of
``tsr_tpu/ops/distortions.py``:

- per-sample random mix (ref:14:31-64, Fog -> Noise -> Blur, p=0.5 each),
  on kernels B1 (fog + noise) and B2/B3 (blur);
- demo compound chain (ref:15:93-120, Fog -> Noise -> Blur).

Public functions take uint8 ``[B, H, W, C]`` batches (a single ``[H, W,
C]`` image is promoted) and return uint8, preserving the reference's
uint8 round-trip semantics between stages. Randomness comes from an
explicit ``torch.Generator``. The draws are split from the math
(:func:`draw_random_mix`, :func:`random_mix_from_draws`) so a test can
inject the JAX reference's draws.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from tsr_tpu_torch import configs
from tsr_tpu_torch.device import as_tensor, resolve_device
from tsr_tpu_torch.kernels import distort as distort_kernels
from tsr_tpu_torch.ops import blur as blur_ops
from tsr_tpu_torch.ops import image as image_ops

MAX_BLUR_DEGREE = 15  # static buffer bound; covers every reference setting


@dataclasses.dataclass(frozen=True)
class MixDraws:
    """One batch's random-mix parameters, all ``[B]`` except ``seed``."""
    gate_fog: torch.Tensor    # bool
    t: torch.Tensor           # float32 fog transmission
    gate_noise: torch.Tensor  # bool
    sigma: torch.Tensor       # float32 noise stddev
    gate_blur: torch.Tensor   # bool
    degrees: torch.Tensor     # int blur length
    angles: torch.Tensor      # float32 blur angle, degrees
    seed: torch.Tensor        # int64 [1]: keys B1's noise stream
    atmosphere: float = 0.9

    def to(self, device) -> "MixDraws":
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self) if f.name != "atmosphere"})


def draw_random_mix(batch: int, generator: torch.Generator,
                    cfg: configs.RandomMixConfig = configs.RandomMixConfig()
                    ) -> MixDraws:
    """Per-sample gates and parameters (ref:14:38-55), drawn on the
    generator's device."""
    dev = generator.device

    def uniform(lo=0.0, hi=1.0):
        u = torch.rand(batch, generator=generator, device=dev)
        return u * (hi - lo) + lo

    def randint(lo, hi):  # inclusive, as ref:14:54-55
        return torch.randint(lo, hi + 1, (batch,), generator=generator,
                             device=dev)

    gate_fog = uniform() < cfg.prob_fog
    t = 1.0 - uniform(*cfg.fog_intensity) * uniform(*cfg.fog_t_jitter)
    gate_noise = uniform() < cfg.prob_noise
    sigma = torch.sqrt(uniform(*cfg.noise_var))
    seed = torch.randint(0, 2 ** 31 - 1, (1,), generator=generator,
                         device=dev)
    gate_blur = uniform() < cfg.prob_blur
    degrees = randint(*cfg.blur_degree)
    angles = randint(*cfg.blur_angle).to(torch.float32)
    return MixDraws(gate_fog, t, gate_noise, sigma, gate_blur, degrees,
                    angles, seed, cfg.fog_atmosphere)


def random_mix_from_draws(images_u8: torch.Tensor, draws: MixDraws,
                          noise: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """The random mix's math for given draws: B1 (fog + noise + pre-blur
    round-trip) -> per-sample blur (B2, or B3 after
    ``ops.blur.set_backend("dense")``) -> cvRound/saturate -> gate select
    -> uint8. On the card the blur kernel runs the steps after the blur in
    its store; on the CPU they are ``kernels.blur.random_mix_epilogue_plain``.

    ``noise`` (CPU only) is a pre-drawn N(0,1) field; without it the noise
    comes from B1's Philox stream keyed by ``draws.seed``.
    """
    f, pre_blur = distort_kernels.fused_fog_noise(
        images_u8, draws.seed, draws.gate_fog.to(torch.int32), draws.t,
        draws.gate_noise.to(torch.int32), draws.sigma,
        atmosphere=draws.atmosphere, noise=noise)
    kernels = blur_ops.motion_blur_kernels(draws.degrees, draws.angles,
                                           max_degree=MAX_BLUR_DEGREE)
    return blur_ops.filter2d(pre_blur, kernels, f=f,
                             gate_blur=draws.gate_blur)


def _batched(images_u8, device):
    x = as_tensor(images_u8, device)
    if x.ndim == 3:
        return x[None], True
    return x, False


def apply_random_distortions(
        images_u8, generator: torch.Generator,
        cfg: configs.RandomMixConfig = configs.RandomMixConfig(),
        device="cuda") -> torch.Tensor:
    """Per-sample random distortion mix, Fog -> Noise -> Blur, each with its
    own probability (ref:14:31-64). Every sample draws independent gates
    and parameters from ``generator``; the whole batch stays on ``device``.
    """
    device = resolve_device(device)
    x, squeeze = _batched(images_u8, device)
    draws = draw_random_mix(x.shape[0], generator, cfg).to(device)
    out = random_mix_from_draws(x, draws)
    return out[0] if squeeze else out


def make_compound_distortion(
        images_u8, generator: Optional[torch.Generator] = None,
        cfg: configs.CompoundConfig = configs.CompoundConfig(),
        device="cuda", noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The unified demo's compound chain (ref:15:93-120): Fog -> Noise
    (clipped) -> trunc to uint8 -> shared-kernel blur (B3 on the card),
    returning the blurred uint8 directly.

    ``noise`` is an optional pre-drawn N(0,1) field; otherwise it is drawn
    from ``generator``.
    """
    device = resolve_device(device)
    x, squeeze = _batched(images_u8, device)
    f = image_ops.to_float01(x)
    t = 1.0 - cfg.fog_intensity
    f = f * t + cfg.fog_atmosphere * (1.0 - t)
    if noise is None:
        noise = torch.randn(f.shape, generator=generator, device=device)
    std = torch.sqrt(torch.tensor(cfg.noise_var, dtype=torch.float32))
    f = f + std.item() * as_tensor(noise, device).to(torch.float32)
    f = f.clamp(0.0, 1.0)
    u8 = torch.trunc(image_ops.scale255(f)).to(torch.uint8)  # ref:15:110
    kernel = blur_ops.motion_blur_kernel(
        cfg.blur_degree, cfg.blur_angle, max_degree=cfg.blur_degree,
        device=device)
    blurred = blur_ops.filter2d(u8.to(torch.float32), kernel)
    out = image_ops.saturate_uint8(blurred, round=True)
    return out[0] if squeeze else out
