"""Exact cosine top-k retrieval: plain version and kernel wrapper.

Counterpart of the JAX package's ``ops/topk.py`` (Pallas
``_topk_block_kernel`` plus a ``lax.top_k`` merge). Embeddings are unit-norm,
so the dot product is the cosine. Results are identical to a full stable
descending sort: ties go to the lowest catalog index.

The kernel (``csrc/topk.cu``) takes each 256-row catalog block's top-k; the
merge over the ``[B, n_blocks * k]`` candidates, laid out block-major, is a
stable descending sort, so a lower block wins a tie as a lower index does.
"""

from __future__ import annotations

import ctypes

import torch

from instacart_next_order_recommendation_tpu_torch.ops import _build

_NEG_INF = -1e30
BLOCK_N = 256  # catalog rows per kernel block (csrc/topk.cu: BN); the kernel takes k <= BLOCK_N


def cosine_topk_reference(
    queries: torch.Tensor,
    catalog: torch.Tensor,
    k: int,
    n_valid: int | None = None,
    candidate_mask: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Dense scores, masks, stable descending sort, first k.

    ``[B, D] x [N, D] -> (scores [B, k] f32, indices [B, k] int32)``.
    ``n_valid`` masks rows at and past it; ``candidate_mask`` is an ``[N]``
    row filter (1 = eligible). Masked rows score -1e30.
    """
    scores = queries.to(torch.float32) @ catalog.to(torch.float32).T
    if n_valid is not None:
        col = torch.arange(catalog.shape[0], device=scores.device)
        scores = torch.where(col[None, :] < n_valid, scores, _NEG_INF)
    if candidate_mask is not None:
        keep = candidate_mask.to(scores.device)[None, :] != 0
        scores = torch.where(keep, scores, _NEG_INF)
    vals, order = torch.sort(scores, dim=1, descending=True, stable=True)
    return vals[:, :k].contiguous(), order[:, :k].to(torch.int32)


_SIGNATURES = {
    "topk_blocks": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p],
}


def cosine_topk(
    queries: torch.Tensor,
    catalog: torch.Tensor,
    k: int,
    n_valid: int | None = None,
    candidate_mask: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k. A CPU tensor takes the plain version; a CUDA tensor
    launches the block kernel and merges, or raises on what it does not take
    (f32 only, D % 16 == 0, 1 <= k <= 256)."""
    if queries.device.type == "cpu":
        return cosine_topk_reference(queries, catalog, k, n_valid, candidate_mask)
    if queries.device.type != "cuda":
        raise ValueError(f"cosine_topk: no kernel for device {queries.device}")
    if queries.dtype != torch.float32 or catalog.dtype != torch.float32:
        raise ValueError(
            f"cosine_topk kernel takes float32, got {queries.dtype} and {catalog.dtype}"
        )
    if queries.dim() != 2 or catalog.dim() != 2 or queries.shape[1] != catalog.shape[1]:
        raise ValueError(
            f"cosine_topk: shapes {tuple(queries.shape)} and {tuple(catalog.shape)} do not match"
        )
    b, d = queries.shape
    n = catalog.shape[0]
    if d % 16 or not 1 <= k <= min(BLOCK_N, n) or b < 1 or catalog.device != queries.device:
        raise ValueError(
            f"cosine_topk kernel takes D % 16 == 0 and 1 <= k <= min({BLOCK_N}, N) on one "
            f"device; got D={d}, k={k}, N={n}, B={b}"
        )
    queries = queries.contiguous()
    catalog = catalog.contiguous()
    mask = None
    if candidate_mask is not None:
        mask = candidate_mask.to(device=queries.device, dtype=torch.int32).contiguous()
        if tuple(mask.shape) != (n,):
            raise ValueError(f"cosine_topk: candidate_mask must be [{n}], got {tuple(mask.shape)}")
    n_valid = n if n_valid is None else min(int(n_valid), n)
    n_blocks = -(-n // BLOCK_N)
    cand_s = torch.empty((b, n_blocks * k), dtype=torch.float32, device=queries.device)
    cand_i = torch.empty((b, n_blocks * k), dtype=torch.int32, device=queries.device)
    lib = _build.load("topk", _SIGNATURES)
    err = lib.topk_blocks(
        _build.ptr(queries), _build.ptr(catalog),
        None if mask is None else _build.ptr(mask),
        _build.ptr(cand_s), _build.ptr(cand_i), b, n, d, n_valid, k,
        _build.stream_of(queries),
    )
    _build.check(lib, err, "topk_blocks")
    cosine_topk.launches += 1
    if n_blocks == 1:
        return cand_s, cand_i
    vals, pos = torch.sort(cand_s, dim=1, descending=True, stable=True)
    return vals[:, :k].contiguous(), torch.gather(cand_i, 1, pos[:, :k])


cosine_topk.launches = 0
