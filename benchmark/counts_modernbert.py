"""Operations and bytes of ModernBERT's layer and of each of its kernels.

Each count is of the work the contract of the computation needs, from the
shapes the benchmark hands to the program (a sequence at its real length
rounded up to 16), never of what one implementation chooses to do. The
peaks are ``counts.py``'s (one H100 SXM, dense, 700 W).
"""

from __future__ import annotations

import numpy as np

from benchmark.counts import PEAK_BF16, PEAK_BYTES, SEQ_QUANTUM, bound_s  # noqa: F401

WINDOW_HALF = 64  # ModernBERT-base: local_attention 128, keys with |i - j| <= 64


def band_pairs(s, half: int = WINDOW_HALF):
    """(query, key) pairs with |i - j| <= half in a row of s tokens:
    (2 half + 1) s - half (half + 1) where s > half, every pair below."""
    s = np.asarray(s, dtype=np.float64)
    return np.where(s > half, (2 * half + 1) * s - half * (half + 1), s * s)


def product_ops(s, h: int, inter: int):
    """The four products of one layer (Wqkv, Wo, Wi of 2I columns, Wo_mlp),
    2 x m x n x k each: 2 s (4 h^2 + 3 h inter) for s tokens."""
    return 2.0 * np.asarray(s, dtype=np.float64) * (4 * h * h + 3 * h * inter)


def global_attention_ops(s, h: int):
    """Q K^T and P V over every key: 4 s^2 h."""
    s = np.asarray(s, dtype=np.float64)
    return 4.0 * s * s * h


def band_attention_ops(s, h: int, half: int = WINDOW_HALF):
    """Q K^T and P V over the band: 4 h (129 s - 4,160) at half 64."""
    return 4.0 * h * band_pairs(s, half)


def layer_counts(cfg: dict) -> tuple[int, int]:
    """(global layers, windowed layers)."""
    n, every = cfg["num_hidden_layers"], cfg["global_attn_every_n_layers"]
    g = sum(1 for i in range(n) if i % every == 0)
    return g, n - g


def tower_flops(lengths, cfg: dict) -> float:
    """A tower's forward over sequences of these real token lengths, each
    rounded up to ``SEQ_QUANTUM``."""
    s = -(-np.asarray(lengths, dtype=np.float64) // SEQ_QUANTUM) * SEQ_QUANTUM
    h, inter = cfg["hidden_size"], cfg["intermediate_size"]
    n_glob, n_win = layer_counts(cfg)
    half = cfg["local_attention"] // 2
    return float(np.sum(
        cfg["num_hidden_layers"] * product_ops(s, h, inter) + n_glob * global_attention_ops(s, h)
        + n_win * band_attention_ops(s, h, half)
    ))


def serve_flops(lengths, cfg: dict, n_catalog: int) -> float:
    """Queries of these lengths encoded and scored against every product."""
    return tower_flops(lengths, cfg) + 2.0 * len(lengths) * n_catalog * cfg["hidden_size"]


def attention_bytes(b: int, s: int, h: int) -> float:
    """q, k and v read and the output written once (bf16), the key bias (f32)."""
    return b * s * h * 2 * 4 + b * s * 4


def global_attention_bound_s(b: int, s: int, h: int) -> float:
    return bound_s(attention_bytes(b, s, h), b * float(global_attention_ops(s, h)), PEAK_BF16)


def band_attention_bound_s(b: int, s: int, h: int, half: int = WINDOW_HALF) -> float:
    return bound_s(attention_bytes(b, s, h), b * float(band_attention_ops(s, h, half)), PEAK_BF16)


def gemm_bound_s(m: int, h: int, inter: int) -> float:
    """The layer's four products on m token rows, each at its own bound: the
    bf16 operands and weights read once, the outputs written once, and the
    two residual products' f32 residual read and f32 sum written."""
    products = (  # (ops, bytes)
        (2.0 * m * h * 3 * h, m * h * 2 + h * 3 * h * 2 + m * 3 * h * 2),
        (2.0 * m * h * h, m * h * 2 + h * h * 2 + m * h * 4 * 2),
        (2.0 * m * h * 2 * inter, m * h * 2 + h * 2 * inter * 2 + m * 2 * inter * 2),
        (2.0 * m * inter * h, m * inter * 2 + inter * h * 2 + m * h * 4 * 2),
    )
    return sum(bound_s(n_bytes, ops, PEAK_BF16) for ops, n_bytes in products)


def rope_bytes(m: int, s: int, h: int) -> float:
    """q and k read and written (bf16), the cos and sin tables read (f32)."""
    return m * 2 * h * 2 * 2 + s * 32 * 4 * 2


def geglu_bytes(m: int, inter: int) -> float:
    """[a | g] read and the product written (bf16)."""
    return m * 2 * inter * 2 + m * inter * 2


def rownorm_bytes(m: int, h: int) -> float:
    """The f32 row read and its bf16 norm written."""
    return m * h * 4 + m * h * 2 + h * 4


def scheduled_band_pairs(s: int, half: int = WINDOW_HALF, tile: int = 64) -> int:
    """The in-range pairs of one row of s tokens that a banded kernel of
    ``tile``-query and ``tile``-key tiles schedules: for each query tile,
    every key of each key tile that meets the band of one of its queries,
    cut at s (what the program's ``attn.pairs.window`` counter counts)."""
    n = -(-s // tile)
    total = 0
    for qt in range(n):
        q0 = qt * tile
        lo = max(0, q0 - half) // tile
        hi = min(n, (q0 + tile - 1 + half) // tile + 1)
        total += (min(s, q0 + tile) - q0) * (min(s, hi * tile) - lo * tile)
    return total
