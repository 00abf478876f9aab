"""Configuration constants and presets the port needs.

The port's own copy of ``tsr_tpu/configs.py`` (image size, class count,
ImageNet statistics, the single distortions, the compound chain, the
random mix, the unified trainer and the eval batch), with the reference
scripts' values as defaults.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

IMAGE_SIZE = 224          # all reference paths resize to 224x224 (ref:05:25, 07:126)
NUM_CLASSES = 43          # GTSRB classes (ref:05:54)

# ImageNet normalization used by every judge path (ref:05:27-29, 06:35-38)
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


@dataclasses.dataclass(frozen=True)
class NoiseConfig:
    """AWGN in [0,1] space (ref:02:12-27)."""
    var: float = 0.02            # ref:02:44
    mean: float = 0.0


@dataclasses.dataclass(frozen=True)
class BlurConfig:
    """Linear motion blur: rotated diag(ones(degree)) kernel (ref:03:11-30)."""
    degree: int = 12             # ref:03:41
    angle: float = 45.0          # ref:03:41
    minmax_normalize: bool = True  # only the offline generator renormalizes (ref:03:29)


@dataclasses.dataclass(frozen=True)
class FogConfig:
    """Atmospheric scattering I = J*t + A*(1-t) (ref:04:12-31)."""
    intensity: float = 0.8       # ref:04:42
    atmosphere: float = 0.9      # A, ref:04:19
    t_jitter: Tuple[float, float] = (0.8, 1.2)  # ref:04:24
    t_clip: Optional[Tuple[float, float]] = (0.1, 0.9)  # ref:04:25


@dataclasses.dataclass(frozen=True)
class CompoundConfig:
    """Compound chain Blur(10,45) / Fog(0.5) / Noise(0.02) (ref:16:14-37);
    the unified demo applies it as Fog -> Noise -> Blur (ref:15:93-120)."""
    blur_degree: int = 10        # ref:16:21
    blur_angle: float = 45.0
    fog_intensity: float = 0.5   # ref:16:28 (t = 1 - intensity, no jitter, no clip)
    fog_atmosphere: float = 0.9
    noise_var: float = 0.02      # ref:16:32


@dataclasses.dataclass(frozen=True)
class RandomMixConfig:
    """Per-sample random mix for unified training, order Fog->Noise->Blur (ref:14:31-64)."""
    prob_fog: float = 0.5        # ref:14:26
    prob_noise: float = 0.5      # ref:14:24
    prob_blur: float = 0.5       # ref:14:25
    fog_intensity: Tuple[float, float] = (0.3, 0.7)   # ref:14:40
    fog_atmosphere: float = 0.9
    fog_t_jitter: Tuple[float, float] = (0.8, 1.2)    # ref:14:42
    noise_var: Tuple[float, float] = (0.01, 0.03)     # ref:14:47
    blur_degree: Tuple[int, int] = (5, 15)            # ref:14:54 (inclusive)
    blur_angle: Tuple[int, int] = (0, 360)            # ref:14:55 (inclusive)
    # Emulated native resolutions for distortion application. The reference
    # distorts native images BEFORE Resize(224) (ref:14:79-92), so blur
    # radius / noise grain scale with the upsample factor. The default ()
    # means no emulation (distort at the stored resolution);
    # UnifiedTrainConfig.mix enables (40, 56, 80, 112), spanning the
    # stand-in's (and GTSRB's) native crop sizes.
    apply_scales: Tuple[int, ...] = ()


@dataclasses.dataclass(frozen=True)
class UnifiedTrainConfig:
    """Unified ResUNet on dynamic mixed distortions (ref:14:14-27, 219-223)."""
    batch_size: int = 16
    epochs: int = 25
    learning_rate: float = 2e-4
    weight_decay: float = 1e-4
    perceptual_weight: float = 0.1   # ref:14:242
    train_split: float = 0.95        # ref:14:209-211
    cosine_t_max: int = 25           # ref:14:223
    # native-resolution emulation ON for unified training (ref:14 distorts
    # native files; the stand-in ships 40-104 px crops)
    mix: RandomMixConfig = dataclasses.field(
        default_factory=lambda: RandomMixConfig(
            apply_scales=(40, 56, 80, 112)))
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class EvalConfig:
    """Accuracy harness (ref:06:11, 06:41)."""
    batch_size: int = 64
