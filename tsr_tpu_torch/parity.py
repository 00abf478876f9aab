"""Seeded weights whose outputs depend on their inputs, for holding two
runs of the command lines equal (the port against the JAX package, the
card against the CPU) with reports that can differ.

With their plain init, a VGG16 judge's penultimate features hardly vary
from image to image (about 1e-5 of their norm at 32 px), so every image
takes one class, and a random SimpleUNet's or ResUNet's output hardly
depends on its input. Accuracy reports of such weights read
``100 / num_classes`` on every tree, whatever a script did to the images.

:func:`spread_judge` gives the judge torchvision's VGG init and makes its
last layer a nearest-centroid rule over its own features of labelled
trees, restored or not; :func:`pass_through` cuts a restorer's deep path
so that it returns its input plus :data:`OFFSET`. Both write
reference-format state dicts, so the same ``.pth`` files feed either
package.
"""

from __future__ import annotations

from typing import Iterable, Optional, Tuple

import torch
from torch import nn

from tsr_tpu_torch import eval as tsr_eval
from tsr_tpu_torch.data import gtsrb
from tsr_tpu_torch.models import ResUNet, SimpleUNet, VGG16

# what pass_through adds: +20.4 LSB, away from a rounding tie, and bright
# pixels pass 1, so the fused step's clamp matters
OFFSET = 0.08


def spread_judge(judge: VGG16,
                 runs: Iterable[Tuple[str, Optional[nn.Module]]],
                 size: int) -> VGG16:
    """Re-initialise ``judge`` in place as torchvision's VGG does
    (kaiming-normal convolutions for ReLU by fan-out, N(0, 0.01) dense
    layers, zero biases) from torch's global RNG, then set its last layer
    to a nearest-centroid rule over its penultimate features of the
    images it sees in ``runs``: each ``(tree, restorer or None)`` as
    ``eval.evaluate_directory`` feeds it at ``size`` on the CPU (the
    models must be there).

    A distortion or a restorer moves all of a run's features alike, and
    by more than the classes differ; read by the rule, that shift would
    put the run's images in one class. So the class directions are taken
    orthogonal to the runs' mean shifts, and the logits are centred on the
    mean feature and scaled so that the margins are of order one. Returns
    ``judge``."""
    with torch.no_grad():
        for m in judge.modules():
            if isinstance(m, nn.Conv2d):
                nn.init.kaiming_normal_(m.weight, mode="fan_out",
                                        nonlinearity="relu")
                nn.init.zeros_(m.bias)
            elif isinstance(m, nn.Linear):
                nn.init.normal_(m.weight, 0.0, 0.01)
                nn.init.zeros_(m.bias)
    head = judge.classifier[-1]
    feats, per_run, labels = [], [], []
    hook = head.register_forward_hook(
        lambda mod, inputs, out: feats.append(inputs[0].double().cpu()))
    try:
        for tree, restorer in runs:
            tsr_eval.evaluate_directory(judge, str(tree), size=size,
                                        restorer=restorer, device="cpu")
            per_run.append(torch.cat(feats))
            feats.clear()
            labels += [lab for _, lab in
                       gtsrb.ImageFolder(str(tree), size=size).samples]
    finally:
        hook.remove()
    f, labels = torch.cat(per_run), torch.tensor(labels)
    centre = f.mean(0)
    shifts = torch.stack([r.mean(0) - centre for r in per_run], 1)
    u, sv, _ = torch.linalg.svd(shifts, full_matrices=False)
    u = u[:, sv > sv[0] * 1e-9]
    mu = torch.stack([f[labels == k].mean(0)
                      for k in range(head.out_features)])
    d = mu - mu.mean(0)
    d = d - (d @ u) @ u.T
    d = d / d.pow(2).sum(1).mean()
    with torch.no_grad():
        head.weight.copy_(d)
        head.bias.copy_(-(d @ centre))
    return judge


def _pick(conv: nn.Conv2d, src: int = 0, offset: float = 0.0) -> None:
    """``conv`` copies input channels ``src..src+2`` to its outputs 0-2
    (the kernel's centre tap) and adds ``offset`` there; every other
    weight and bias is zero."""
    nn.init.zeros_(conv.weight)
    nn.init.zeros_(conv.bias)
    k = conv.weight.shape[-1] // 2
    for c in range(3):
        conv.weight[c, src + c, k, k] = 1.0
    conv.bias[:3] = offset


def pass_through(restorer: nn.Module) -> nn.Module:
    """Set a SimpleUNet's or ResUNet's weights in place so that it returns
    its (non-negative) input plus :data:`OFFSET` per pixel: the first level
    copies the image into its skip, the last decoder block reads only that
    skip, and the deeper levels feed nothing. In a ResUNet the copy passes
    the stem's PReLU and two ReLUs on non-negative values and one
    eval-mode batch norm at its initial statistics (a factor of
    ``1 / sqrt(1 + 1e-5)``)."""
    with torch.no_grad():
        if isinstance(restorer, SimpleUNet):
            for conv in (restorer.enc1[0], restorer.enc1[2],
                         restorer.dec1[2]):
                _pick(conv)
            # dec1 reads cat(decoder output, skip): the skip comes second
            _pick(restorer.dec1[0], src=restorer.widths[0])
        elif isinstance(restorer, ResUNet):
            _pick(restorer.enc1[0])
            # res1 (identity shortcut) and dec1: the residual branch's last
            # batch norm gives zero
            for block in (restorer.res1, restorer.dec1):
                nn.init.zeros_(block.conv_block[-1].weight)
                nn.init.zeros_(block.conv_block[-1].bias)
            shortcut = restorer.dec1.shortcut[0]
            _pick(shortcut, src=shortcut.in_channels - restorer.widths[0])
        else:
            raise TypeError(f"pass_through takes a SimpleUNet or a ResUNet, "
                            f"not {type(restorer).__name__}")
        _pick(restorer.final, offset=OFFSET)
    return restorer
