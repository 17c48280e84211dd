"""Catalog index resident on the device, or row-sharded over a device mesh,
with cosine top-k.

Counterpart of the JAX package's ``index/sharded.py``. The catalog is stored
in f32 or bf16; queries are cast to the catalog's dtype, and scores
accumulate in f32. ``topk`` returns the same ids as a full stable sort of
the scores, or, with ``extraction="packed"``, of their 20-bit packed keys.

With a mesh whose ``data`` axis is above 1 the rows are padded to
``shard_rows * dp`` and each data device holds one block of ``shard_rows``
rows. A query runs K3 (or K4) on every shard at ``min(k, shard_rows)``, with
the shard's own count of real rows (the last shard may be short or empty),
offsets the ids to global rows, brings the candidates to the first device
and merges them with one stable sort by descending score over the
shard-major candidates: score order, then global id, as the JAX package's
``lax.top_k`` over its all-gathered candidates gives.
"""

from __future__ import annotations

import numpy as np
import torch

from instacart_next_order_recommendation_tpu_torch.device import resolve_device
from instacart_next_order_recommendation_tpu_torch.ops import cosine_topk
from instacart_next_order_recommendation_tpu_torch.parallel.mesh import (
    Mesh,
    data_devices,
    pad_to_multiple,
)

# The catalog storage dtypes, by the JAX package's names.
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class ShardedCatalogIndex:
    """Catalog embeddings resident on one device or row-sharded over a mesh."""

    def __init__(
        self,
        embeddings: np.ndarray | torch.Tensor,
        mesh: Mesh | None = None,
        device: str | torch.device | None = None,
        extraction: str = "exact",
        dtype: str = "float32",
    ):
        """``embeddings``: ``[N, D]`` unit-norm catalog matrix (host or device).
        ``mesh``: a device mesh (``parallel.build_mesh``) whose ``data`` axis
        shards the rows, one block per data device; the candidates merge on
        the first, where results land (``device`` is then ignored). None or
        one data shard: the whole catalog on ``device``.
        ``dtype``: the catalog's storage dtype on the device, ``"float32"`` or
        ``"bfloat16"`` (half the memory and the bytes a scan reads; rankings
        can swap only between near-tied candidates). bf16 goes through the
        bf16 form of the kernels: no upcast on the card.
        ``extraction``: ``"exact"`` (identical to a full stable sort) or
        ``"packed"`` (the packed kernel: scores compared at 20-bit precision,
        so near-tied candidates may swap, and returned quantized)."""
        if extraction not in ("exact", "packed"):
            raise ValueError(f"extraction must be 'exact' or 'packed', got {extraction!r}")
        if dtype not in DTYPES:
            raise ValueError(f"dtype must be one of {sorted(DTYPES)}, got {dtype!r}")
        self.packed = extraction == "packed"
        self.dtype = DTYPES[dtype]
        shard_devices = data_devices(mesh)
        self.mesh = mesh
        embeddings = torch.as_tensor(embeddings)
        self.n_total, self.dim = embeddings.shape
        if shard_devices is None:
            self.dp = 1
            self.shard_rows = self.n_total
            self.device = resolve_device(device) if mesh is None else mesh.data_devices[0]
            self.catalog = embeddings.to(self.device, self.dtype).contiguous()
            return
        self.dp = len(shard_devices)
        self.shard_rows = pad_to_multiple(self.n_total, self.dp) // self.dp
        self.device = shard_devices[0]
        self.catalog = None  # no single resident catalog: see ``shards``
        self.shards = []
        for i, dev in enumerate(shard_devices):
            block = embeddings[i * self.shard_rows : (i + 1) * self.shard_rows]
            shard = torch.zeros((self.shard_rows, self.dim), dtype=self.dtype, device=dev)
            shard[: len(block)] = block.to(dev, self.dtype)
            self.shards.append(shard)

    def shard_valid(self, i: int) -> int:
        """Real (unpadded) rows of shard ``i``."""
        return min(max(self.n_total - i * self.shard_rows, 0), self.shard_rows)

    def topk_device(
        self,
        queries: np.ndarray | torch.Tensor,
        k: int,
        candidate_mask: np.ndarray | torch.Tensor | None = None,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Top-k as device tensors on ``self.device``, without a host sync.

        ``candidate_mask`` is an optional ``[n_total]`` row filter (1 =
        eligible) applied on the device before the top-k.
        """
        k = min(k, self.n_total)
        queries = torch.as_tensor(queries)
        mask = None
        if candidate_mask is not None:
            mask = torch.as_tensor(candidate_mask).to(dtype=torch.int32)
        if self.dp == 1:
            if mask is not None:
                mask = mask.to(self.device)
            return cosine_topk(
                queries.to(device=self.device, dtype=self.dtype), self.catalog, k,
                n_valid=self.n_total, candidate_mask=mask, packed=self.packed,
            )
        if mask is not None:
            mask = torch.nn.functional.pad(mask, (0, self.shard_rows * self.dp - mask.shape[0]))
        k_local = min(k, self.shard_rows)
        scores, ids = [], []
        for i, shard in enumerate(self.shards):
            rows = slice(i * self.shard_rows, (i + 1) * self.shard_rows)
            s, idx = cosine_topk(
                queries.to(device=shard.device, dtype=self.dtype), shard, k_local,
                n_valid=self.shard_valid(i),
                candidate_mask=None if mask is None else mask[rows].to(shard.device),
                packed=self.packed,
            )
            scores.append(s.to(self.device))
            ids.append(idx.to(self.device) + i * self.shard_rows)
        # Shard-major: within a shard by score then row, shards in row order,
        # so a stable sort by score alone orders equal scores by global id.
        all_s, all_i = torch.cat(scores, dim=1), torch.cat(ids, dim=1)
        top_s, pos = torch.sort(all_s, dim=1, descending=True, stable=True)
        return top_s[:, :k].contiguous(), torch.gather(all_i, 1, pos[:, :k])

    def topk(
        self,
        queries: np.ndarray | torch.Tensor,
        k: int,
        candidate_mask: np.ndarray | torch.Tensor | None = None,
    ) -> tuple[np.ndarray, np.ndarray]:
        """Global top-k: returns (scores [B, k], indices [B, k]) on the host."""
        s, i = self.topk_device(queries, k, candidate_mask=candidate_mask)
        return s.cpu().numpy(), i.cpu().numpy()
