"""Catalog index resident on one GPU, with cosine top-k.

Counterpart of the single-device branch of the JAX package's
``index/sharded.py``. The catalog is stored f32 on the device; ``topk``
returns the same ids as a full stable sort of the scores, or, with
``extraction="packed"``, of their 20-bit packed keys.
"""

from __future__ import annotations

import numpy as np
import torch

from instacart_next_order_recommendation_tpu_torch.device import resolve_device
from instacart_next_order_recommendation_tpu_torch.ops import cosine_topk


class ShardedCatalogIndex:
    """Catalog embeddings resident on one device (no row sharding yet)."""

    def __init__(
        self,
        embeddings: np.ndarray | torch.Tensor,
        mesh=None,
        device: str | torch.device | None = None,
        extraction: str = "exact",
    ):
        """``embeddings``: ``[N, D]`` unit-norm catalog matrix (host or device).
        ``mesh``: only ``None`` (one device) in this version.
        ``extraction``: ``"exact"`` (identical to a full stable sort) or
        ``"packed"`` (the packed kernel: scores compared at 20-bit precision,
        so near-tied candidates may swap, and returned quantized)."""
        if mesh is not None:
            raise ValueError("ShardedCatalogIndex: row sharding over a mesh is not ported yet")
        if extraction not in ("exact", "packed"):
            raise ValueError(f"extraction must be 'exact' or 'packed', got {extraction!r}")
        self.packed = extraction == "packed"
        self.device = resolve_device(device)
        self.catalog = torch.as_tensor(embeddings, dtype=torch.float32).to(self.device).contiguous()
        self.n_total, self.dim = self.catalog.shape

    def topk_device(
        self,
        queries: np.ndarray | torch.Tensor,
        k: int,
        candidate_mask: np.ndarray | torch.Tensor | None = None,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Top-k as device tensors, without a host sync.

        ``candidate_mask`` is an optional ``[n_total]`` row filter (1 =
        eligible) applied on the device before the top-k.
        """
        k = min(k, self.n_total)
        queries = torch.as_tensor(queries).to(device=self.device, dtype=torch.float32)
        mask = None
        if candidate_mask is not None:
            mask = torch.as_tensor(candidate_mask).to(device=self.device, dtype=torch.int32)
        return cosine_topk(
            queries, self.catalog, k, n_valid=self.n_total, candidate_mask=mask,
            packed=self.packed,
        )

    def topk(
        self,
        queries: np.ndarray | torch.Tensor,
        k: int,
        candidate_mask: np.ndarray | torch.Tensor | None = None,
    ) -> tuple[np.ndarray, np.ndarray]:
        """Global top-k: returns (scores [B, k], indices [B, k]) on the host."""
        s, i = self.topk_device(queries, k, candidate_mask=candidate_mask)
        return s.cpu().numpy(), i.cpu().numpy()
