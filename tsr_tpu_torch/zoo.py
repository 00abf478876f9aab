"""Model zoo: constructors, checkpoints and loading for the three model
families.

Port of ``tsr_tpu/zoo.py``. A checkpoint keeps the JAX package's on-disk
shape, ``<base>/{model,train,config.json}``:

- ``model``: the model's state dict in the reference's ``.pth`` format
  (``torch.save`` of float32 CPU tensors under the reference's torch
  names), which reference torch code loads with ``load_state_dict``;
- ``train``: the optimizer's and schedule's state and the step count, for
  resume;
- ``config.json``: architecture options (``input_minmax``,
  ``num_classes``, ``use_batchnorm``, ``cfg``, ``fc_width``) and the
  caller's training provenance (``identity_frac``, ``severity``), the keys
  the JAX package writes. :func:`load_model` rebuilds the architecture
  from it.

Orbax checkpoints written by ``tsr_tpu`` are not read here (the port has
no JAX or orbax); migrate them through ``tsr_tpu.checkpoint``'s
``*_to_state_dict`` and ``save_pth`` into a directory's ``model`` beside
the JAX checkpoint's ``config.json`` (README), then load the directory.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import torch
from torch import nn

from tsr_tpu_torch import configs
from tsr_tpu_torch.device import resolve_device
from tsr_tpu_torch.models import ResUNet, SimpleUNet, VGG16
from tsr_tpu_torch.train import common

KINDS = ("simple_unet", "resunet", "vgg16")


def build_simple_unet(dtype=torch.float32, input_minmax: bool = False,
                      device="cuda") -> SimpleUNet:
    """A fresh reference-width SimpleUNet (64, 128) on ``device``."""
    with torch.device(resolve_device(device)):
        return SimpleUNet(dtype=dtype, input_minmax=input_minmax)


def build_resunet(dtype=torch.float32, device="cuda") -> ResUNet:
    """A fresh reference-width ResUNet (64, 128, 256 / 512) on ``device``."""
    with torch.device(resolve_device(device)):
        return ResUNet(dtype=dtype)


def build_judge(num_classes: int = configs.NUM_CLASSES,
                use_batchnorm: bool = False, dtype=torch.float32,
                size: int = configs.IMAGE_SIZE, device="cuda",
                **arch) -> VGG16:
    """A fresh VGG16 judge for ``size`` x ``size`` input on ``device``;
    ``arch`` may set ``cfg`` and ``fc_width``."""
    with torch.device(resolve_device(device)):
        return VGG16(num_classes=num_classes, use_batchnorm=use_batchnorm,
                     input_size=size, dtype=dtype, **arch)


def load_model(kind: str, path: Optional[str],
               size: int = configs.IMAGE_SIZE,
               num_classes: int = configs.NUM_CLASSES,
               use_batchnorm: bool = False, dtype=torch.float32,
               device="cuda") -> nn.Module:
    """``kind`` in :data:`KINDS`; ``path`` a checkpoint directory written
    by :func:`save_checkpoint` (or its ``model`` file), a reference-format
    ``.pth`` state dict, or None (fresh weights from torch's global RNG).
    Returns the module on ``device`` in eval mode, its parameters float32
    and its compute in ``dtype``.

    A checkpoint's ``config.json`` overrides the architecture arguments,
    so callers need not know how a model was built.
    """
    meta = {}
    if path and not path.endswith(".pth"):
        meta = checkpoint_config(path)
        num_classes = meta.get("num_classes", num_classes)
        use_batchnorm = meta.get("use_batchnorm", use_batchnorm)
    if kind == "simple_unet":
        model = build_simple_unet(dtype, meta.get("input_minmax", False),
                                  device)
    elif kind == "resunet":
        model = build_resunet(dtype, device)
    elif kind == "vgg16":
        arch = {}
        if "cfg" in meta:
            arch["cfg"] = tuple(meta["cfg"])
        if "fc_width" in meta:
            arch["fc_width"] = meta["fc_width"]
        model = build_judge(num_classes, use_batchnorm, dtype, size, device,
                            **arch)
    else:
        raise ValueError(f"unknown model kind {kind!r}; one of {KINDS}")
    if path:
        weights = path if path.endswith(".pth") else _model_path(path)
        model.load_state_dict(torch.load(weights, map_location="cpu",
                                         weights_only=True))
    return model.eval()


def _model_path(path: str) -> str:
    """Accept either the checkpoint base path or its model file; refuse an
    orbax checkpoint (its ``model`` is a directory)."""
    model = path if os.path.basename(path) == "model" else os.path.join(
        path, "model")
    if os.path.isdir(model):
        raise ValueError(
            f"{path} is an orbax checkpoint written by the JAX package "
            "(tsr_tpu), which the port cannot read. Export its weights "
            "with tsr_tpu.checkpoint's *_to_state_dict and save_pth, then "
            "pass the .pth file or put it at <dir>/model beside the "
            "checkpoint's config.json (README, 'The PyTorch/CUDA port').")
    return model


def state_tree(state: common.TrainState) -> dict:
    """What a checkpoint holds of ``state``: the model's state dict, the
    optimizer's and schedule's state and the step count (references to the
    live tensors; ``copy.deepcopy`` it for a snapshot)."""
    return {"model": state.model.state_dict(),
            "optimizer": state.optimizer.state_dict(),
            "schedule": state.schedule.state_dict(), "step": state.step}


def save_checkpoint(base_path: str, state, config: Optional[dict] = None
                    ) -> None:
    """Write ``state`` (a ``TrainState``, or a :func:`state_tree` of one)
    as ``<base>/model`` (the state dict, float32 on the CPU), ``<base>/
    train`` (optimizer, schedule, step) and, given ``config``,
    ``<base>/config.json``."""
    tree = state if isinstance(state, dict) else state_tree(state)
    os.makedirs(base_path, exist_ok=True)
    torch.save({k: v.detach().cpu() for k, v in tree["model"].items()},
               os.path.join(base_path, "model"))
    torch.save({k: tree[k] for k in ("optimizer", "schedule", "step")},
               os.path.join(base_path, "train"))
    if config is not None:
        with open(os.path.join(base_path, "config.json"), "w") as f:
            json.dump(config, f, indent=1)


def checkpoint_config(base_path: str) -> dict:
    """A checkpoint's ``config.json`` (architecture options and training
    provenance), looked up beside ``base_path`` or in it; {} if absent."""
    for cand in (os.path.join(base_path, "config.json"),
                 os.path.join(os.path.dirname(base_path), "config.json")):
        if os.path.exists(cand):
            with open(cand) as f:
                return json.load(f)
    return {}


def load_train_state(base_path: str, state: common.TrainState
                     ) -> common.TrainState:
    """Resume: load a checkpoint's model weights, optimizer and schedule
    state and step count into ``state`` (built like the one saved, on its
    device), and return it."""
    weights = _model_path(base_path)
    tree = torch.load(os.path.join(base_path, "train"), map_location="cpu",
                      weights_only=True)
    state.model.load_state_dict(torch.load(weights,
                                           map_location="cpu",
                                           weights_only=True))
    state.optimizer.load_state_dict(tree["optimizer"])
    state.schedule.load_state_dict(tree["schedule"])
    state.step = tree["step"]
    return state
