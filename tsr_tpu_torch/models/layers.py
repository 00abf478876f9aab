"""Layers that keep float32 parameters and compute in their input's dtype.

This is what Flax's ``dtype=`` means in the JAX models: parameters stay
float32 and are cast to the compute dtype (bf16 on the serving path) at
each call. Parameter names and shapes are torch's own, so reference
``.pth`` state dicts load unchanged.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch import nn


def _cast(p, dtype):
    return None if p is None else p.to(dtype)


class Conv2d(nn.Conv2d):
    def forward(self, x):
        return self._conv_forward(x, self.weight.to(x.dtype),
                                  _cast(self.bias, x.dtype))


class ConvTranspose2d(nn.ConvTranspose2d):
    def forward(self, x):
        return F.conv_transpose2d(
            x, self.weight.to(x.dtype), _cast(self.bias, x.dtype),
            self.stride, self.padding, self.output_padding, self.groups,
            self.dilation)


class Linear(nn.Linear):
    def forward(self, x):
        return F.linear(x, self.weight.to(x.dtype), _cast(self.bias, x.dtype))


class BatchNorm2d(nn.BatchNorm2d):
    """Batch norm computed in float32, output in the input dtype (Flax's
    BatchNorm promotes to its float32 statistics the same way).

    Train mode follows Flax's rule (``tsr_tpu/models/resunet.py:48-54``):
    normalize with the batch mean and the biased variance, and move each
    running statistic 0.1 of the way to the batch's, the running variance
    toward the biased variance too. ``F.batch_norm``'s own update uses the
    unbiased variance (1.6 % higher at 64 values per channel), so the
    statistics are updated here, from the mean and ``1/sqrt(var + eps)``
    that the normalization already computed. ``update_stats = False`` (see
    :func:`frozen_running_stats`) normalizes without updating them.
    """

    update_stats = True

    def forward(self, x):
        if not self.training:
            y = F.batch_norm(x.to(torch.float32), self.running_mean,
                             self.running_var, self.weight, self.bias, False,
                             0.0, self.eps)
            return y.to(x.dtype)
        y, mean, invstd = torch.native_batch_norm(
            x.to(torch.float32), self.weight, self.bias, None, None, True,
            0.0, self.eps)
        if self.update_stats:
            with torch.no_grad():
                self.running_mean.lerp_(mean, self.momentum)
                self.running_var.lerp_(invstd.pow(-2) - self.eps,
                                       self.momentum)
        return y.to(x.dtype)


def batchnorm_fed_biases(module: nn.Module) -> set:
    """Names of the convolution biases in ``module`` that feed a batch norm
    directly (a ``Conv2d`` followed by a ``BatchNorm2d`` in one
    ``nn.Sequential``). The norm subtracts such a bias out again, so its
    exact gradient is 0."""
    names = set()
    for prefix, seq in module.named_modules():
        if not isinstance(seq, nn.Sequential):
            continue
        kids = list(seq.named_children())
        for (name, conv), (_, bn) in zip(kids, kids[1:]):
            if (isinstance(conv, nn.Conv2d) and conv.bias is not None
                    and isinstance(bn, nn.BatchNorm2d)):
                names.add(f"{prefix}.{name}.bias" if prefix else
                          f"{name}.bias")
    return names


@contextlib.contextmanager
def frozen_running_stats(module: nn.Module):
    """Train-mode batch norms of ``module`` normalize with batch statistics
    but leave their running statistics alone inside the block: a
    checkpointed forward recomputed during backward must not move them a
    second time."""
    bns = [m for m in module.modules() if isinstance(m, BatchNorm2d)]
    for m in bns:
        m.update_stats = False
    try:
        yield
    finally:
        for m in bns:
            m.update_stats = True


class PReLU(nn.PReLU):
    """Single shared slope (``weight`` of shape ``[1]``), init 0.25."""

    def forward(self, x):
        return torch.where(x >= 0, x, self.weight.to(x.dtype) * x)
