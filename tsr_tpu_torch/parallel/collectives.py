"""Collectives with their backward: the data axis's synced statistics and
the model axis's Megatron operators.

Under XLA these come from the sharding of a jitted step; here each is a
``torch.autograd.Function`` around ``torch.distributed`` on one process
group. Every collective runs on the tensor's own device with the group's
backend (NCCL, or gloo on the CPU and on CUDA tensors when ranks share a
card). A group of one rank still runs the collective (the identity).
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over ``group``, in a new tensor (no autograd)."""
    out = x.detach().clone().contiguous()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out


def all_gather_cat(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim`` in group rank order (no
    autograd)."""
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.detach().contiguous(), group=group)
    return torch.cat(parts, dim=dim)


class _SumOverGroup(torch.autograd.Function):
    """Forward and backward both all-reduce: ``y = sum_r x_r`` feeds every
    rank's loss, so each rank's ``x`` receives the sum of their gradients
    (the synced batch statistics)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g, ctx.group), None


class _CopyToGroup(torch.autograd.Function):
    """Megatron's ``f``: identity forward, all-reduce backward. The input
    of a column-parallel layer is replicated over the group and each rank
    sends back the gradient of its own columns only."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g, ctx.group), None


class _ReduceFromGroup(torch.autograd.Function):
    """Megatron's ``g``: all-reduce forward, identity backward (the output
    of a row-parallel layer is a sum of the ranks' partial products)."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromGroup(torch.autograd.Function):
    """All-gather forward along ``dim``; backward keeps this rank's slice
    of the gradient (what follows is computed alike on every rank, so the
    gradient is the same on each)."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        ctx.size = x.shape[dim]
        return all_gather_cat(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        rank = dist.get_rank(ctx.group)
        return g.narrow(ctx.dim, rank * ctx.size, ctx.size).contiguous(), \
            None, None


def sum_over_group(x, group):
    return _SumOverGroup.apply(x, group)


def copy_to_group(x, group):
    return _CopyToGroup.apply(x, group)


def reduce_from_group(x, group):
    return _ReduceFromGroup.apply(x, group)


def gather_from_group(x, dim, group):
    return _GatherFromGroup.apply(x, dim, group)
