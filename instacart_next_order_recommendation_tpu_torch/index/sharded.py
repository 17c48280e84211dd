"""Catalog index resident on one GPU, with cosine top-k.

Counterpart of the single-device branch of the JAX package's
``index/sharded.py``. The catalog is stored on the device in f32 or bf16;
queries are cast to the catalog's dtype, and scores accumulate in f32.
``topk`` returns the same ids as a full stable sort of the scores, or, with
``extraction="packed"``, of their 20-bit packed keys.
"""

from __future__ import annotations

import numpy as np
import torch

from instacart_next_order_recommendation_tpu_torch.device import resolve_device
from instacart_next_order_recommendation_tpu_torch.ops import cosine_topk

# The catalog storage dtypes, by the JAX package's names.
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class ShardedCatalogIndex:
    """Catalog embeddings resident on one device (no row sharding yet)."""

    def __init__(
        self,
        embeddings: np.ndarray | torch.Tensor,
        mesh=None,
        device: str | torch.device | None = None,
        extraction: str = "exact",
        dtype: str = "float32",
    ):
        """``embeddings``: ``[N, D]`` unit-norm catalog matrix (host or device).
        ``mesh``: only ``None`` (one device) in this version.
        ``dtype``: the catalog's storage dtype on the device, ``"float32"`` or
        ``"bfloat16"`` (half the memory and the bytes a scan reads; rankings
        can swap only between near-tied candidates). bf16 goes through the
        bf16 form of the kernels: no upcast on the card.
        ``extraction``: ``"exact"`` (identical to a full stable sort) or
        ``"packed"`` (the packed kernel: scores compared at 20-bit precision,
        so near-tied candidates may swap, and returned quantized)."""
        if mesh is not None:
            raise ValueError("ShardedCatalogIndex: row sharding over a mesh is not ported yet")
        if extraction not in ("exact", "packed"):
            raise ValueError(f"extraction must be 'exact' or 'packed', got {extraction!r}")
        if dtype not in DTYPES:
            raise ValueError(f"dtype must be one of {sorted(DTYPES)}, got {dtype!r}")
        self.packed = extraction == "packed"
        self.device = resolve_device(device)
        self.dtype = DTYPES[dtype]
        self.catalog = torch.as_tensor(embeddings).to(self.device, self.dtype).contiguous()
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
        queries = torch.as_tensor(queries).to(device=self.device, dtype=self.dtype)
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
