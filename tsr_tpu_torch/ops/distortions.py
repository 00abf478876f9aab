"""Batched distortion simulators.

Port of ``tsr_tpu/ops/distortions.py`` without the ``mild_*`` variants:

- AWGN (ref:02:12-27), motion blur (ref:03:11-30) and fog (ref:04:12-31),
  the offline generator's single distortions;
- the offline compound chain (ref:16:14-37, Blur -> Fog -> Noise);
- per-sample random mix (ref:14:31-64, Fog -> Noise -> Blur, p=0.5 each),
  on kernels B1 (fog + noise) and B2/B3 (blur);
- the same mix at emulated native resolutions, and the training pair built
  from it (ref:14:75-93);
- demo compound chain (ref:15:93-120, Fog -> Noise -> Blur).

Public functions take uint8 ``[B, H, W, C]`` batches (a single ``[H, W,
C]`` image is promoted) and return uint8, preserving the reference's
uint8 round-trip semantics between stages. A shared blur kernel runs on
B3 on the card. Randomness comes from an explicit ``torch.Generator``;
each function also takes its draws injected (``noise=``, ``jitter=``,
:func:`random_mix_from_draws`) so a test can hand it the JAX reference's.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

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
    seed: torch.Tensor        # int64 [S]: each keys one B1 noise stream
    atmosphere: float = 0.9

    def to(self, device) -> "MixDraws":
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self) if f.name != "atmosphere"})

    def group(self, start: int, stop: int, index: int) -> "MixDraws":
        """Samples ``start:stop``, their noise keyed by seed ``index``."""
        return dataclasses.replace(self, seed=self.seed[index:index + 1], **{
            f.name: getattr(self, f.name)[start:stop]
            for f in dataclasses.fields(self)
            if f.name not in ("seed", "atmosphere")})


def draw_random_mix(batch: int, generator: torch.Generator,
                    cfg: configs.RandomMixConfig = configs.RandomMixConfig(),
                    n_seeds: int = 1) -> MixDraws:
    """Per-sample gates and parameters (ref:14:38-55), drawn on the
    generator's device, with ``n_seeds`` noise seeds (one per B1 call)."""
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
    seed = torch.randint(0, 2 ** 31 - 1, (n_seeds,), generator=generator,
                         device=dev)
    gate_blur = uniform() < cfg.prob_blur
    degrees = randint(*cfg.blur_degree)
    angles = randint(*cfg.blur_angle).to(torch.float32)
    return MixDraws(gate_fog, t, gate_noise, sigma, gate_blur, degrees,
                    angles, seed, cfg.fog_atmosphere)


def random_mix_from_draws(images_u8: torch.Tensor, draws: MixDraws,
                          noise: Optional[torch.Tensor] = None,
                          kernels: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """The random mix's math for given draws: B1 (fog + noise + pre-blur
    round-trip) -> per-sample blur (B2, or B3 after
    ``ops.blur.set_backend("dense")``) -> cvRound/saturate -> gate select
    -> uint8. On the card the blur kernel runs the steps after the blur in
    its store; on the CPU they are ``kernels.blur.random_mix_epilogue_plain``.

    ``noise`` (CPU only) is a pre-drawn N(0,1) field; without it the noise
    comes from B1's Philox stream keyed by ``draws.seed[0]``. ``kernels``
    are the draws' motion kernels when the caller has built them already.
    """
    f, pre_blur = distort_kernels.fused_fog_noise(
        images_u8, draws.seed[:1], draws.gate_fog.to(torch.int32), draws.t,
        draws.gate_noise.to(torch.int32), draws.sigma,
        atmosphere=draws.atmosphere, noise=noise)
    if kernels is None:
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


def scale_groups(batch: int, scales: Sequence[int]
                 ) -> List[Tuple[int, int, int, int]]:
    """``(index, start, stop, scale)`` of each non-empty group: ``batch //
    len(scales)`` samples each by position, the last taking the remainder
    (ref ``apply_random_distortions_multiscale``)."""
    n_g = len(scales)
    g = batch // n_g
    groups = []
    for i, s in enumerate(scales):
        n = g + (batch - g * n_g if i == n_g - 1 else 0)
        if n:
            groups.append((i, i * g, i * g + n, s))
    return groups


def random_mix_multiscale_from_draws(
        images_u8: torch.Tensor, draws: MixDraws, scales: Sequence[int],
        noise: Optional[Sequence[Optional[torch.Tensor]]] = None
        ) -> torch.Tensor:
    """The multiscale mix's math for given draws: each group of
    :func:`scale_groups` is downsampled to its scale (``resize_linear``,
    then ``clip01_to_uint8``), put through :func:`random_mix_from_draws`,
    and upsampled back; a scale at or above the batch's size distorts the
    group as it is.

    ``draws`` cover the whole batch, with one seed per scale (group ``i``
    keys B1's noise with ``draws.seed[i]``); the motion kernels are built
    once for the batch and sliced. ``noise`` (CPU only) holds one N(0,1)
    field per scale, at that scale (``None`` for an empty group).
    """
    h, w = images_u8.shape[1:3]
    kernels = blur_ops.motion_blur_kernels(draws.degrees, draws.angles,
                                           max_degree=MAX_BLUR_DEGREE)
    outs = []
    for i, start, stop, s in scale_groups(images_u8.shape[0], scales):
        sub = images_u8[start:stop]
        args = (draws.group(start, stop, i), None if noise is None
                else noise[i], kernels[start:stop])
        if s >= h:
            outs.append(random_mix_from_draws(sub, *args))
            continue
        small = image_ops.resize_linear(image_ops.to_float01(sub), s)
        bad = random_mix_from_draws(
            image_ops.clip01_to_uint8(small).contiguous(), *args)
        up = image_ops.resize_linear(image_ops.to_float01(bad), (h, w))
        outs.append(image_ops.clip01_to_uint8(up))
    return torch.cat(outs, dim=0)


def apply_random_distortions_multiscale(
        images_u8, generator: torch.Generator,
        cfg: configs.RandomMixConfig, device="cuda") -> torch.Tensor:
    """Random mix applied at emulated native resolutions (ref:14:79-92
    distorts the native file before its resize to 224).

    The batch splits into ``len(cfg.apply_scales)`` groups by position
    (training batches arrive freshly permuted, so per-sample scales are
    effectively random); each is downsampled to its scale, distorted there
    with the uint8 round-trip kept, and upsampled back. The gates and
    parameters of the whole batch are drawn once from ``generator``, so
    the mix runs B1 and B2 once per group.
    """
    device = resolve_device(device)
    x, squeeze = _batched(images_u8, device)
    draws = draw_random_mix(x.shape[0], generator, cfg,
                            n_seeds=len(cfg.apply_scales)).to(device)
    out = random_mix_multiscale_from_draws(x, draws, cfg.apply_scales)
    return out[0] if squeeze else out


def make_training_pair(
        clean_u8, generator: torch.Generator,
        cfg: configs.RandomMixConfig = configs.RandomMixConfig(),
        device="cuda") -> Tuple[torch.Tensor, torch.Tensor]:
    """(clean uint8 batch, generator) -> (bad float01, clean float01), both
    ``[B, H, W, C]`` on ``device``: the on-device counterpart of the
    reference's ``DynamicDistortionDataset.__getitem__`` (ref:14:75-93).
    With ``cfg.apply_scales`` set the mix runs at emulated native
    resolutions (:func:`apply_random_distortions_multiscale`)."""
    device = resolve_device(device)
    clean = as_tensor(clean_u8, device)
    if cfg.apply_scales:
        bad = apply_random_distortions_multiscale(clean, generator, cfg,
                                                  device)
    else:
        bad = apply_random_distortions(clean, generator, cfg, device)
    return image_ops.to_float01(bad), image_ops.to_float01(clean)


def _normal(shape, generator, device, noise) -> torch.Tensor:
    """The injected N(0,1) field ``noise``, or one drawn from
    ``generator``."""
    if noise is None:
        return torch.randn(shape, generator=generator, device=device)
    return as_tensor(noise, device).to(torch.float32)


def _std(var):
    """``sqrt(var)`` in float32: a Python float for a scalar variance (as
    ``jnp.sqrt`` of a weak-typed scalar), a tensor for a per-image one."""
    if isinstance(var, torch.Tensor):
        return torch.sqrt(var.to(torch.float32))
    return torch.sqrt(torch.tensor(var, dtype=torch.float32)).item()


def _per_image(v, device):
    """A scalar as it is, a per-image value as ``[B, 1, 1, 1]`` float32."""
    if isinstance(v, (int, float)):
        return v
    return as_tensor(v, device).to(torch.float32).reshape(-1, 1, 1, 1)


def add_gaussian_noise(images_u8, generator: Optional[torch.Generator] = None,
                       var=0.02, mean: float = 0.0, device="cuda",
                       noise=None) -> torch.Tensor:
    """Additive Gaussian noise in [0,1] space with the reference's cast
    semantics (ref:02:12-27): ``img/255 + mean + sqrt(var) * N(0,1)``; the
    lower clip bound is ``-1`` where any value of the image went negative,
    else ``0``; then ``np.uint8(out*255)``, which *wraps* negatives.

    ``var`` is a float or a per-image ``[B]`` tensor; ``noise`` an optional
    pre-drawn N(0,1) field, else drawn from ``generator``.
    """
    device = resolve_device(device)
    x, squeeze = _batched(images_u8, device)
    f = image_ops.to_float01(x)
    out = f + (mean + _std(_per_image(var, device))
               * _normal(f.shape, generator, device, noise))
    any_neg = out.amin(dim=(1, 2, 3), keepdim=True) < 0
    low = torch.where(any_neg, -1.0, 0.0)
    out = torch.minimum(torch.maximum(out, low), torch.ones_like(out))
    out = image_ops.numpy_uint8_cast(image_ops.scale255(out))
    return out[0] if squeeze else out


def apply_motion_blur(images_u8, degree: int = 12, angle: float = 45.0,
                      minmax_normalize: bool = True,
                      device="cuda") -> torch.Tensor:
    """Linear motion blur on uint8 images (ref:03:11-30): one shared
    ``max(degree, 3)``-sized kernel, so kernel B3 on the card, then cvRound
    and saturate. ``minmax_normalize`` applies the offline generator's
    final ``cv2.normalize(..., NORM_MINMAX)`` (ref:03:29); the online paths
    (ref:13, 14, 16) skip it."""
    device = resolve_device(device)
    x, squeeze = _batched(images_u8, device)
    kernel = blur_ops.motion_blur_kernel(degree, angle,
                                         max_degree=max(int(degree), 3),
                                         device=device)
    blurred = blur_ops.filter2d(x.to(torch.float32), kernel)
    out = image_ops.saturate_uint8(blurred, round=True)
    if minmax_normalize:
        out = image_ops.minmax_normalize_u8(out.to(torch.float32))
    return out[0] if squeeze else out


def add_fog(images_u8, generator: Optional[torch.Generator] = None,
            fog_intensity=0.8, atmosphere: float = 0.9,
            t_jitter: Optional[Tuple[float, float]] = (0.8, 1.2),
            t_clip: Optional[Tuple[float, float]] = (0.1, 0.9),
            device="cuda", jitter=None) -> torch.Tensor:
    """Atmospheric scattering ``I = J*t + A*(1-t)`` (ref:04:12-31).

    ``t = 1 - intensity * U(t_jitter)`` per image, clipped to ``t_clip``;
    ``t_jitter=None`` takes ``U = 1`` (the fixed chains, ref:16:28,
    13:51). ``fog_intensity`` is a float or a per-image ``[B]`` tensor;
    ``jitter`` an optional pre-drawn ``[B]`` of U(t_jitter), else drawn
    from ``generator``.
    """
    device = resolve_device(device)
    x, squeeze = _batched(images_u8, device)
    f = image_ops.to_float01(x)
    b = f.shape[0]
    if t_jitter is None:
        jit_u = torch.ones((b, 1, 1, 1), device=device)
    elif jitter is not None:
        jit_u = _per_image(jitter, device)
    else:
        if generator is None:
            raise ValueError("add_fog with t_jitter needs a generator")
        u = torch.rand((b, 1, 1, 1), generator=generator, device=device)
        jit_u = u * (t_jitter[1] - t_jitter[0]) + t_jitter[0]
    t = 1.0 - _per_image(fog_intensity, device) * jit_u
    if t_clip is not None:
        t = t.clamp(t_clip[0], t_clip[1])
    out = f * t + atmosphere * (1.0 - t)
    out = image_ops.clip01_to_uint8(out)
    return out[0] if squeeze else out


def apply_compound_distortion(
        images_u8, generator: Optional[torch.Generator] = None,
        cfg: configs.CompoundConfig = configs.CompoundConfig(),
        device="cuda", noise=None) -> torch.Tensor:
    """The offline compound generator's chain (ref:16:14-37): blur(10, 45)
    on uint8 (a shared K=10 kernel, B3 on the card; cvRound + saturate) ->
    fog with fixed ``t = 1 - 0.5`` -> AWGN(0.02) with no clip in between ->
    ``clip(x*255, 0, 255).astype(uint8)`` (no negative wrap here).
    ``noise`` is an optional pre-drawn N(0,1) field, else drawn from
    ``generator``."""
    device = resolve_device(device)
    x, squeeze = _batched(images_u8, device)
    kernel = blur_ops.motion_blur_kernel(cfg.blur_degree, cfg.blur_angle,
                                         max_degree=cfg.blur_degree,
                                         device=device)
    blurred = blur_ops.filter2d(x.to(torch.float32), kernel)
    f = image_ops.saturate_uint8(blurred, round=True).to(torch.float32) / 255.0
    t = 1.0 - cfg.fog_intensity
    f = f * t + cfg.fog_atmosphere * (1.0 - t)
    f = f + _std(cfg.noise_var) * _normal(f.shape, generator, device, noise)
    out = image_ops.clip01_to_uint8(f)
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
    f = f + _std(cfg.noise_var) * _normal(f.shape, generator, device, noise)
    f = f.clamp(0.0, 1.0)
    u8 = torch.trunc(image_ops.scale255(f)).to(torch.uint8)  # ref:15:110
    kernel = blur_ops.motion_blur_kernel(
        cfg.blur_degree, cfg.blur_angle, max_degree=cfg.blur_degree,
        device=device)
    blurred = blur_ops.filter2d(u8.to(torch.float32), kernel)
    out = image_ops.saturate_uint8(blurred, round=True)
    return out[0] if squeeze else out
