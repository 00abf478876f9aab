"""End-to-end demo pipelines: the cascade stress test and the unified demo.

Port of ``tsr_tpu/pipeline.py``:

- :func:`cascade_stress` (ref:13:94-239): distort step by step Blur -> Fog
  -> Noise with the mild parameters (the blur on kernel B3 on the card),
  restore by chaining the three specialized SimpleUNets Noise -> Fog ->
  Blur **on the raw, unclamped tensor between stages** (ref:13:181;
  clamped only for the viewing copies, ref:13:184), and score the judge's
  confidence at all 7 stages; :func:`cascade_variant` labels the restorers
  from their checkpoints' provenance.
- :func:`unified_demo` (ref:15:131-229): the compound chain in the demo's
  Fog -> Noise -> Blur order (its blur on B3 on the card), one ResUNet
  restore, and VGG confidence on the clean, distorted and restored
  batches.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from tsr_tpu_torch import configs
from tsr_tpu_torch.device import as_tensor, resolve_device
from tsr_tpu_torch.ops import distortions, image as image_ops


# Restoration chain order for the cascade (ref:13:27)
RESTORATION_ORDER = ("noise", "fog", "blur")
# Distortion order for the cascade (ref:13:153-169)
DISTORTION_ORDER = ("blur", "fog", "noise")

# Net restored-confidence delta per cascade restorer variant, as the JAX
# package measured them (RESULTS.md cascade section); the reference's own
# regime is +0.103 (0.749 -> 0.852, ref:13:226-238).
VARIANT_TABLE = {
    "A": ("reference-exact severe trees, no identity anchor", -0.248),
    "B": ("severe trees + identity anchor", -0.082),
    "B'": ("B + min-max fog restorer", -0.016),
    "C": ("severity-jittered trees + identity anchor + min-max fog",
          +0.187),
}


def cascade_variant(task_configs: Mapping[str, Optional[dict]]
                    ) -> Tuple[str, str]:
    """Which cascade variant (RESULTS.md A/B/B'/C) a set of restorer
    checkpoints represents, from their recorded provenance (``config.json``:
    ``identity_frac`` / ``input_minmax`` / ``severity``).

    Returns ``(code, description)``; code is '?' when no checkpoint
    recorded provenance.
    """
    cfgs = [task_configs.get(t) or {} for t in RESTORATION_ORDER]
    if not any(c for c in cfgs):
        return "?", "no provenance recorded (pre-r5 checkpoints)"
    jittered = any(c.get("severity") == "jittered" for c in cfgs)
    anchored = any(c.get("identity_frac", 0) > 0 for c in cfgs)
    minmax_fog = bool((task_configs.get("fog") or {}).get("input_minmax"))
    if jittered:
        code = "C"
    elif minmax_fog and anchored:
        code = "B'"
    elif anchored:
        code = "B"
    else:
        code = "A"
    return code, VARIANT_TABLE[code][0]


@torch.inference_mode()
def _judge_confidence(judge: nn.Module, x01: torch.Tensor):
    """NHWC float01 batch -> (pred [B], max softmax probability [B])."""
    logits = judge(image_ops.imagenet_normalize(x01).permute(0, 3, 1, 2))
    probs = torch.softmax(logits.to(torch.float32), -1)
    conf, pred = probs.max(-1)
    return pred, conf


@torch.inference_mode()
def unified_demo(clean_u8, resunet: nn.Module, judge: nn.Module,
                 generator: Optional[torch.Generator] = None,
                 cfg: configs.CompoundConfig = configs.CompoundConfig(),
                 bad_u8=None, device="cuda") -> Dict[str, object]:
    """ref:15: compound distort (Fog -> Noise -> Blur), blind unified
    restore, judge confidence on clean / bad / restored.

    Pass ``bad_u8`` when the compound distortion was applied elsewhere
    (ref:15:170-174 distorts the native image before the resize);
    otherwise it is drawn from ``generator``. The models must live on
    ``device``. Returns numpy arrays, as the JAX version does.
    """
    device = resolve_device(device)
    resunet.eval()
    judge.eval()
    clean = as_tensor(clean_u8, device)
    if bad_u8 is None:
        bad = distortions.make_compound_distortion(clean, generator, cfg,
                                                   device=device)
    else:
        bad = as_tensor(bad_u8, device)

    x01 = image_ops.to_float01(bad).permute(0, 3, 1, 2)
    restored01 = resunet(x01).clamp(0.0, 1.0).permute(0, 2, 3, 1)

    results = {}
    for name, x in (("clean", image_ops.to_float01(clean)),
                    ("bad", image_ops.to_float01(bad)),
                    ("restored", restored01)):
        p, c = _judge_confidence(judge, x)
        results[name] = {"pred": p.cpu().numpy(),
                         "confidence": c.cpu().numpy()}
    restored_u8 = torch.trunc(image_ops.scale255(restored01)).to(torch.uint8)
    return {"bad_u8": bad.cpu().numpy(),
            "restored_u8": restored_u8.cpu().numpy(),
            "judge": results}


@torch.inference_mode()
def cascade_stress(clean_u8, restorers: Mapping[str, nn.Module],
                   judge: nn.Module,
                   generator: Optional[torch.Generator] = None,
                   mild: configs.MildConfig = configs.MildConfig(),
                   precomputed_stages=None, device="cuda",
                   noise=None) -> Dict[str, object]:
    """Run the 7-stage cascade on a uint8 ``[B, H, W, 3]`` batch.

    ``restorers`` maps each task of :data:`RESTORATION_ORDER` to its
    SimpleUNet (each may differ, e.g. a fog restorer with
    ``input_minmax``); they and ``judge`` must live on ``device``.
    ``precomputed_stages`` (four ``(name, uint8 batch)`` pairs: Clean,
    + Blur, + Fog, + Noise) lets the caller supply the distortions applied
    at native resolution and resized (ref:13:147-169); otherwise they are
    applied here, the noise drawn from ``generator`` or given as a
    pre-drawn N(0,1) field ``noise``.

    Returns numpy arrays, as the JAX version does: ``stages`` (seven
    ``(name, batch)``: four uint8, then the three restored float01 copies,
    clamped), per-stage ``preds`` and ``confidences``, and
    ``mean_confidence`` of the clean, distorted and restored stages
    (ref:13:226-238).
    """
    device = resolve_device(device)
    if precomputed_stages is not None:
        stages: List[Tuple[str, torch.Tensor]] = [
            (name, as_tensor(x, device)) for name, x in precomputed_stages]
        if len(stages) != 4:
            raise ValueError("expect Clean/+Blur/+Fog/+Noise stages, got "
                             f"{[name for name, _ in stages]}")
    else:
        # Phase 1: Blur -> Fog -> Noise, uint8 between stages
        # (ref:13:153-169)
        x = as_tensor(clean_u8, device)
        stages = [("Clean", x)]
        x = distortions.mild_blur(x, mild, device=device)
        stages.append(("+ Blur", x))
        x = distortions.mild_fog(x, mild, device=device)
        stages.append(("+ Fog", x))
        x = distortions.mild_noise(x, generator, mild, device=device,
                                   noise=noise)
        stages.append(("+ Noise (final bad)", x))

    # Phase 2: restore Noise -> Fog -> Blur, the raw (unclamped) float
    # tensor chained between models (ref:13:174-189)
    t = image_ops.to_float01(stages[-1][1]).permute(0, 3, 1, 2)
    for task in RESTORATION_ORDER:
        t = restorers[task].eval()(t)
        stages.append((f"Restored {task}",
                       t.clamp(0.0, 1.0).permute(0, 2, 3, 1)))  # ref:13:184

    # Phase 3: judge confidence at all 7 stages (ref:13:191-206); the last
    # restored stage is judged clamped
    preds, confs = [], []
    judge.eval()
    for _, img in stages:
        x01 = image_ops.to_float01(img) if img.dtype == torch.uint8 else img
        p, c = _judge_confidence(judge, x01)
        preds.append(p.cpu().numpy())
        confs.append(c.cpu().numpy())
    return {
        "stages": [(name, img.cpu().numpy()) for name, img in stages],
        "preds": preds,
        "confidences": confs,
        "mean_confidence": {"clean": float(np.mean(confs[0])),
                            "distorted": float(np.mean(confs[3])),
                            "restored": float(np.mean(confs[6]))},
    }
