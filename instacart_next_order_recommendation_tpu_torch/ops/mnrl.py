"""MultipleNegativesRankingLoss over in-batch negatives, on one device or
across a data group.

Counterpart of the JAX package's ``ops/mnrl.py::mnrl_loss``: softmax
cross-entropy over ``scale * (Q . P^T)`` where each query's positive is the
diagonal and every other positive in the batch is a negative. With
``group`` (the data group of a process mesh) the positives of every rank
are gathered, so the negatives are the global batch, and each rank's labels
shift by its rank times the local batch. Plain PyTorch: the JAX package has
no kernel here either.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from instacart_next_order_recommendation_tpu_torch.parallel.mesh import all_gather_rows


class _GatherRows(torch.autograd.Function):
    """``all_gather_rows`` whose backward all-reduces the whole gradient and
    keeps this rank's rows: the transpose of a gather (JAX's psum-scatter),
    since every rank's loss reads every rank's positives."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        ctx.rows = x.shape[0]
        return all_gather_rows(x, group)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        rank = dist.get_rank(ctx.group)
        return grad[rank * ctx.rows : (rank + 1) * ctx.rows], None


def mnrl_loss(
    query_emb: torch.Tensor, positive_emb: torch.Tensor, scale: float = 30.0, group=None
) -> torch.Tensor:
    """Mean softmax CE over in-batch negatives; ``[B, D]`` L2-normalised
    anchor and positive embeddings -> scalar f32 loss (this rank's queries
    against the group's positives when ``group`` is given)."""
    local_b = query_emb.shape[0]
    positives = positive_emb.to(torch.float32)
    shift = 0
    if group is not None:
        positives = _GatherRows.apply(positives, group)
        shift = dist.get_rank(group) * local_b
    logits = (query_emb.to(torch.float32) @ positives.T) * scale
    rows = torch.arange(local_b, device=logits.device)
    return (torch.logsumexp(logits, dim=1) - logits[rows, rows + shift]).mean()
