"""MultipleNegativesRankingLoss over in-batch negatives, on one device.

Counterpart of the JAX package's ``ops/mnrl.py::mnrl_loss`` without
``axis_name``: softmax cross-entropy over ``scale * (Q . P^T)`` where each
query's positive is the diagonal and every other positive in the batch is a
negative. Plain PyTorch: the JAX package has no kernel here either.
"""

from __future__ import annotations

import torch


def mnrl_loss(query_emb: torch.Tensor, positive_emb: torch.Tensor, scale: float = 30.0) -> torch.Tensor:
    """Mean softmax CE over in-batch negatives; ``[B, D]`` L2-normalised
    anchor and positive embeddings -> scalar f32 loss."""
    logits = (query_emb.to(torch.float32) @ positive_emb.to(torch.float32).T) * scale
    return (torch.logsumexp(logits, dim=1) - logits.diagonal()).mean()
