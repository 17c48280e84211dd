"""Cosine top-k retrieval: plain versions and kernel wrapper.

Counterpart of the JAX package's ``ops/topk.py`` (Pallas
``_topk_block_kernel`` or, with ``packed=True``, ``_topk_block_kernel_packed``,
plus a ``lax.top_k`` merge). Embeddings are unit-norm, so the dot product is
the cosine. Exact results are identical to a full stable descending sort:
ties go to the lowest catalog index. Packed results rank each score by the
top 20 bits of its order-preserving bit pattern (the JAX kernel's packed
key), ties again to the lowest index, and return the quantized scores.

The kernels (``csrc/topk.cu``: K3 exact, K4 packed, each on f32 rows or,
as the JAX index stores a bf16 catalog, on bf16 rows) take the top k of
each catalog slice (``slice_plan``: whole 128-row tiles, as many slices as
fill the card) for a tile of queries (``query_tile``), as unique 64-bit
keys (score order bits, then the inverted row), and a second kernel
selects each query's top k of its ``n_slices * k`` candidates, so ties go
to the lowest index across slices as within one. A k above ``BLOCK_N``
takes the dense route instead, exact whether or not ``packed`` was asked
for, chosen by k alone as the JAX package's dispatcher chooses (k >
block_n goes to the exact dense scores + sort there): the scores product
is left to ``torch.matmul``, as JAX leaves it to XLA, and a stable
descending sort selects.
"""

from __future__ import annotations

import ctypes

import torch

from instacart_next_order_recommendation_tpu_torch.ops import _build

_NEG_INF = -1e30
BLOCK_N = 256  # the kernel takes k <= BLOCK_N; above it, the dense route
TILE_N = 128  # catalog rows per kernel tile (csrc/topk.cu: BM); slices are whole tiles
_SIGN = -(2**31)  # 0x80000000 as an int32
_LOW = 0xFFF  # the packed key's 12 column bits


def _masked_scores(queries, catalog, n_valid, candidate_mask) -> torch.Tensor:
    """f32 ``[B, N]`` scores with rows at and past ``n_valid`` and rows whose
    ``candidate_mask`` is 0 set to -1e30."""
    scores = queries.to(torch.float32) @ catalog.to(torch.float32).T
    if n_valid is not None:
        col = torch.arange(catalog.shape[0], device=scores.device)
        scores = torch.where(col[None, :] < n_valid, scores, _NEG_INF)
    if candidate_mask is not None:
        keep = candidate_mask.to(scores.device)[None, :] != 0
        scores = torch.where(keep, scores, _NEG_INF)
    return scores


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
    scores = _masked_scores(queries, catalog, n_valid, candidate_mask)
    vals, order = torch.sort(scores, dim=1, descending=True, stable=True)
    return vals[:, :k].contiguous(), order[:, :k].to(torch.int32)


def quantized_keys(scores: torch.Tensor) -> torch.Tensor:
    """The packed kernel's comparison key of each f32 score, as an int32:
    the order-preserving bit pattern (``bits < 0 ? ~bits ^ sign : bits``)
    with its low 12 bits cleared."""
    bits = scores.contiguous().view(torch.int32)
    sortable = torch.where(bits < 0, (~bits) ^ _SIGN, bits)
    return sortable & ~_LOW


def quantized_scores(keys: torch.Tensor) -> torch.Tensor:
    """The f32 score each quantized key stands for (the JAX kernel's
    ``s_bits``)."""
    return torch.where(keys >= 0, keys, ~(keys ^ _SIGN)).view(torch.float32)


def cosine_topk_packed_reference(
    queries: torch.Tensor,
    catalog: torch.Tensor,
    k: int,
    n_valid: int | None = None,
    candidate_mask: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the packed extraction: the masked dense scores,
    ranked by ``quantized_keys`` in a stable descending sort (ties to the
    lowest index, as the JAX kernel's in-block column bits and its
    block-major merge give together), first k, scores quantized."""
    keys = quantized_keys(_masked_scores(queries, catalog, n_valid, candidate_mask))
    top, order = torch.sort(keys, dim=1, descending=True, stable=True)
    return quantized_scores(top[:, :k]).contiguous(), order[:, :k].to(torch.int32)


_SIGNATURES = {
    name: [ctypes.c_void_p] * 6 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    for name in ("topk_slices", "topk_slices_bf16")
}
# The entry point for each operand dtype the kernels take.
_ENTRY = {torch.float32: "topk_slices", torch.bfloat16: "topk_slices_bf16"}


def query_tile(b: int, k: int) -> int:
    """Queries per kernel block: 8 for a batch of at most 8; else 64, or 32
    for k > 128, whose per-query lists of 256 keys take the shared memory
    (csrc/topk.cu: ``Shape``)."""
    if b <= 8:
        return 8
    return 32 if k > 128 else 64


def slice_plan(b: int, n: int, k: int, sm_count: int) -> tuple[int, int]:
    """``(slice_rows, n_slices)``: the catalog cut into slices of whole
    ``TILE_N``-row tiles, as few as fill the card with one wave of blocks
    (two resident per SM at 8 queries a block, one above; csrc/topk.cu's
    launch bounds): fewer slices mean fewer candidates to merge. Measured on
    f32 rows; bf16 rows (half the bytes a tile) take the same plan."""
    blocks = sm_count * (2 if query_tile(b, k) == 8 else 1)
    n_tiles = -(-n // TILE_N)
    want = max(1, min(n_tiles, blocks // -(-b // query_tile(b, k))))
    tiles = -(-n_tiles // want)
    return tiles * TILE_N, -(-n_tiles // tiles)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous and 16-byte aligned (the kernel's cp.async copies)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def cosine_topk(
    queries: torch.Tensor,
    catalog: torch.Tensor,
    k: int,
    n_valid: int | None = None,
    candidate_mask: torch.Tensor | None = None,
    packed: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k, exact or (``packed=True``, k <= 256) on the packed keys. A CPU
    tensor takes the plain version; a CUDA tensor launches the slice and
    merge kernels (K3, or K4 when packed; 1 <= k <= 256), or takes the exact
    dense route (k > 256), or raises on what it does not take (queries and
    catalog both f32 or both bf16, D % 16 == 0). Scores are f32 either way;
    bf16 operands are not upcast on the card."""
    packed = packed and k <= BLOCK_N
    if queries.device.type == "cpu":
        plain = cosine_topk_packed_reference if packed else cosine_topk_reference
        return plain(queries, catalog, k, n_valid, candidate_mask)
    if queries.device.type != "cuda":
        raise ValueError(f"cosine_topk: no kernel for device {queries.device}")
    entry = _ENTRY.get(queries.dtype)
    if entry is None or catalog.dtype != queries.dtype:
        raise ValueError(
            "cosine_topk kernel takes float32 or bfloat16 queries and catalog of one dtype, "
            f"got {queries.dtype} and {catalog.dtype}"
        )
    if queries.dim() != 2 or catalog.dim() != 2 or queries.shape[1] != catalog.shape[1]:
        raise ValueError(
            f"cosine_topk: shapes {tuple(queries.shape)} and {tuple(catalog.shape)} do not match"
        )
    b, d = queries.shape
    n = catalog.shape[0]
    dense = k > BLOCK_N
    if (
        d % 16
        or not 1 <= k <= (n if dense else min(BLOCK_N, n))
        or b < 1
        or catalog.device != queries.device
    ):
        raise ValueError(
            f"cosine_topk takes D % 16 == 0 and 1 <= k <= N (the kernel k <= {BLOCK_N}) on "
            f"one device; got D={d}, k={k}, N={n}, B={b}"
        )
    queries = _aligned(queries)
    catalog = _aligned(catalog)
    mask = None
    if candidate_mask is not None:
        mask = candidate_mask.to(device=queries.device, dtype=torch.int32).contiguous()
        if tuple(mask.shape) != (n,):
            raise ValueError(f"cosine_topk: candidate_mask must be [{n}], got {tuple(mask.shape)}")
    n_valid = n if n_valid is None else min(int(n_valid), n)
    if dense:
        _build.count(cosine_topk, "dense_calls")
        return cosine_topk_reference(queries, catalog, k, n_valid, mask)
    sm_count = torch.cuda.get_device_properties(queries.device).multi_processor_count
    slice_rows, n_slices = slice_plan(b, n, k, sm_count)
    cand = torch.empty((b, n_slices * k), dtype=torch.int64, device=queries.device)
    out_s = torch.empty((b, k), dtype=torch.float32, device=queries.device)
    out_i = torch.empty((b, k), dtype=torch.int32, device=queries.device)
    lib = _build.load("topk", _SIGNATURES)
    err = getattr(lib, entry)(
        _build.ptr(queries), _build.ptr(catalog),
        None if mask is None else _build.ptr(mask),
        _build.ptr(cand), _build.ptr(out_s), _build.ptr(out_i), b, n, d, n_valid, k,
        int(packed), query_tile(b, k), slice_rows, n_slices, _build.stream_of(queries),
    )
    _build.check(lib, err, entry)
    bf16 = queries.dtype == torch.bfloat16
    if packed:
        _build.count(cosine_topk, "packed_launches")
        if bf16:
            _build.count(cosine_topk, "packed_bf16_launches")
    else:
        _build.count(cosine_topk)
        if bf16:
            _build.count(cosine_topk, "bf16_launches")
    return out_s, out_i


cosine_topk.launches = 0  # K3, on f32 or bf16 rows
cosine_topk.packed_launches = 0  # K4, on f32 or bf16 rows
cosine_topk.bf16_launches = 0  # of them, K3 on bf16 rows
cosine_topk.packed_bf16_launches = 0  # K4 on bf16 rows
cosine_topk.dense_calls = 0
