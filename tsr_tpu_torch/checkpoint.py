"""Weight bridge from the JAX models' variables to the port's state dicts.

Takes Flax variables as nested dicts of numpy arrays (``{"params": ...,
"batch_stats": ...}``, as ``jax.device_get`` returns them) and returns a
``state_dict`` for the port's modules, which carry the reference torch
names. Layout conventions (those of ``tsr_tpu/checkpoint.py``):

- Flax ``Conv`` kernels are HWIO; torch wants OIHW.
- Flax ``ConvTranspose`` kernels are ``[kh, kw, in, out]`` and spatially
  mirrored relative to torch's ``[in, out, kh, kw]``.
- Flax ``Dense`` kernels are ``[in, out]``; torch ``Linear`` wants
  ``[out, in]``.
- The PReLU slope is a scalar; torch wants shape ``[1]``.
- BN scale/bias live under ``params``, mean/var under ``batch_stats``.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, order="C"))


def _conv(p) -> Dict[str, torch.Tensor]:
    return {"weight": _t(np.transpose(p["kernel"], (3, 2, 0, 1))),
            "bias": _t(p["bias"])}


def _conv_t(p) -> Dict[str, torch.Tensor]:
    k = np.asarray(p["kernel"])[::-1, ::-1]
    return {"weight": _t(np.transpose(k, (2, 3, 0, 1))), "bias": _t(p["bias"])}


def _dense(p) -> Dict[str, torch.Tensor]:
    return {"weight": _t(np.transpose(p["kernel"])), "bias": _t(p["bias"])}


def _bn(p, s) -> Dict[str, torch.Tensor]:
    return {"weight": _t(p["scale"]), "bias": _t(p["bias"]),
            "running_mean": _t(s["mean"]), "running_var": _t(s["var"]),
            "num_batches_tracked": torch.tensor(0, dtype=torch.int64)}


def _add(sd, prefix, tensors):
    for name, v in tensors.items():
        sd[f"{prefix}.{name}"] = v


def _res_block(sd, prefix, p, s):
    _add(sd, f"{prefix}.conv_block.0", _conv(p["conv1"]))
    _add(sd, f"{prefix}.conv_block.1", _bn(p["bn1"], s["bn1"]))
    sd[f"{prefix}.conv_block.2.weight"] = _t(p["prelu"]["alpha"]).reshape(1)
    _add(sd, f"{prefix}.conv_block.3", _conv(p["conv2"]))
    _add(sd, f"{prefix}.conv_block.4", _bn(p["bn2"], s["bn2"]))
    if "shortcut_conv" in p:
        _add(sd, f"{prefix}.shortcut.0", _conv(p["shortcut_conv"]))
        _add(sd, f"{prefix}.shortcut.1",
             _bn(p["shortcut_bn"], s["shortcut_bn"]))


def resunet_from_jax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """``tsr_tpu.models.ResUNet`` variables -> ``tsr_tpu_torch`` ResUNet
    state dict (the reference's torch names, ref:14:117-186)."""
    params, stats = variables["params"], variables["batch_stats"]
    sd: Dict[str, torch.Tensor] = {}
    _add(sd, "enc1.0", _conv(params["stem_conv"]))
    sd["enc1.1.weight"] = _t(params["stem_prelu"]["alpha"]).reshape(1)
    for name in params:
        if re.fullmatch(r"(res|dec)\d+", name):
            _res_block(sd, name, params[name], stats[name])
        elif m := re.fullmatch(r"bottleneck(\d)", name):
            _res_block(sd, f"bottleneck.{int(m.group(1)) - 1}",
                       params[name], stats[name])
        elif re.fullmatch(r"up\d+", name):
            _add(sd, name, _conv_t(params[name]))
    _add(sd, "final", _conv(params["final"]))
    return sd


def simple_unet_from_jax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """``tsr_tpu.models.SimpleUNet`` variables -> ``tsr_tpu_torch``
    SimpleUNet state dict (the reference's torch names, ref:07:75-120:
    ``enc1.0.weight``, ``up2.weight``, ``final.bias``, ...)."""
    sd: Dict[str, torch.Tensor] = {}
    for name, p in variables["params"].items():
        if re.fullmatch(r"up\d+", name):
            _add(sd, name, _conv_t(p))
        elif name == "final":
            _add(sd, name, _conv(p))
        else:  # a DoubleConv: Sequential(conv, relu, conv, relu)
            _add(sd, f"{name}.0", _conv(p["conv1"]))
            _add(sd, f"{name}.2", _conv(p["conv2"]))
    return sd


def vgg16_from_jax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """``tsr_tpu.models.VGG16`` variables -> ``tsr_tpu_torch`` VGG16 state
    dict (torchvision names; the bn variant's BN layers included)."""
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    sd: Dict[str, torch.Tensor] = {}
    for name, p in params.items():
        if m := re.fullmatch(r"features_bn_(\d+)", name):
            _add(sd, f"features.{m.group(1)}", _bn(p, stats[name]))
        elif m := re.fullmatch(r"features_(\d+)", name):
            _add(sd, f"features.{m.group(1)}", _conv(p))
        elif m := re.fullmatch(r"classifier_(\d+)", name):
            _add(sd, f"classifier.{m.group(1)}", _dense(p))
    return sd
