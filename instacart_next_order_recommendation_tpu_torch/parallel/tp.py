"""Megatron's tensor-parallel region markers over the model group.

Counterpart of the JAX package's ``parallel/tp.py``. For a column-parallel
then row-parallel pair (attention's QKV then its output projection, the
FFN's two matrices) the forward is written against local shards and needs
two linear operators:

- ``tp_enter`` (Megatron's *f*): identity forward, all-reduce backward.
  Placed where a replicated activation enters a column-parallel region:
  each rank's backward carries only its shard's part of the input's
  gradient.
- ``tp_exit`` (Megatron's *g*): all-reduce forward, identity backward.
  Placed on the row-parallel product's partial sum: the gradient of a
  replicated activation is already whole on every rank.

With both in place the gradients of replicated parameters come out whole
and equal on every model rank, and those of split parameters local to
their shard. ``group=None`` (no tensor parallelism) makes both the identity.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _Exit(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def tp_enter(x: torch.Tensor, group) -> torch.Tensor:
    """Identity forward / all-reduce backward over ``group``."""
    return x if group is None else _Enter.apply(x, group)


def tp_exit(x: torch.Tensor, group) -> torch.Tensor:
    """All-reduce forward / identity backward over ``group``."""
    return x if group is None else _Exit.apply(x, group)
