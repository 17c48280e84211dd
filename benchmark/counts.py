"""Operations, bytes and the card's peaks: the yardstick of every share.

Each count is of the work the contract of the computation needs, from the
shapes the benchmark hands to the program, never of what one implementation
chooses to do (a recompute, a split product, padding the program adds).

Peaks of one NVIDIA H100 SXM5 80GB (NVIDIA H100 Tensor Core GPU data sheet,
SXM column, dense rates without sparsity, at its 700 W limit):
bf16 989.4 TFLOP/s, TF32 494.7 TFLOP/s, HBM3 3.35 TB/s.
"""

from __future__ import annotations

import numpy as np

PEAK_BF16 = 989e12  # FLOP/s, data sheet, H100 SXM, dense
PEAK_TF32 = 495e12  # FLOP/s, data sheet, H100 SXM, dense
PEAK_BYTES = 3.35e12  # B/s, data sheet, H100 SXM, HBM3

SEQ_QUANTUM = 16  # a sequence counts at its real length rounded up to this


def round_up(n: int, q: int = SEQ_QUANTUM) -> int:
    return -(-int(n) // q) * q


def bound_s(n_bytes: float, ops: float, peak_ops: float) -> float:
    """The least time the card could take: the larger of operations over
    the compute peak and bytes over the memory peak."""
    return max(ops / peak_ops, n_bytes / PEAK_BYTES)


def layer_ops(b: int, s: int, h: int, inter: int) -> float:
    """One post-LN BERT layer's forward on ``b`` rows of ``s`` tokens: the
    four projections and the FFN (2 x m x n x k each) and attention's two
    products (QK^T and PV: 4 x s^2 x h a row)."""
    return 2.0 * b * s * (4 * h * h + 2 * h * inter) + 4.0 * b * s * s * h


def layer_weight_bytes(h: int, inter: int) -> int:
    """The layer's weights as served: bf16 matrices and biases, f32 LayerNorm."""
    return (4 * h * h + 2 * h * inter) * 2 + (6 * h + inter) * 2 + 4 * h * 4


def k1_bound_s(b: int, s: int, h: int, inter: int, masked: bool = False) -> float:
    """K1, the fused layer forward: x read and y written once (bf16), the
    two dropout masks read in the training form, the key bias and the
    weights read once; ``layer_ops`` at the bf16 peak."""
    tensors = 2 + (2 if masked else 0)
    n_bytes = b * s * h * 2 * tensors + b * s * 4 + layer_weight_bytes(h, inter)
    return bound_s(n_bytes, layer_ops(b, s, h, inter), PEAK_BF16)


def k5_bound_s(b: int, s: int, h: int, inter: int, masked: bool = True) -> float:
    """K5, the fused layer backward: the gradient's own operations only,
    twice the layer forward's (the input and the weight gradient of every
    product), with no forward recompute; x, the upstream gradient and the
    masks read, dx written, the weights read and their gradients written
    (f32) once."""
    n_bytes = (
        b * s * h * 2 * (3 + (2 if masked else 0)) + b * s * 4
        + layer_weight_bytes(h, inter) + 2 * layer_weight_bytes(h, inter)
    )
    return bound_s(n_bytes, 2.0 * layer_ops(b, s, h, inter), PEAK_BF16)


def k3_bound_s(b: int, n: int, d: int, k: int) -> float:
    """K3, exact cosine top-k in f32: 2 x B x N x D at the TF32 peak (the
    floor of any tensor-core form of the f32 contract), the catalog and the
    queries read and the k scores and ids written once."""
    n_bytes = n * d * 4 + b * d * 4 + b * k * 8
    return bound_s(n_bytes, 2.0 * b * n * d, PEAK_TF32)


def tower_flops(lengths, h: int, inter: int, layers: int) -> float:
    """A tower's forward over sequences of these real token lengths, each
    rounded up to ``SEQ_QUANTUM``: what the queries need, whatever the
    program pads them to."""
    s = -(-np.asarray(lengths, dtype=np.float64) // SEQ_QUANTUM) * SEQ_QUANTUM
    return float(np.sum(2.0 * s * (4 * h * h + 2 * h * inter) + 4.0 * s * s * h)) * layers


def serve_flops(lengths, h: int, inter: int, layers: int, n_catalog: int) -> float:
    """Queries of these lengths encoded and scored against every product."""
    return tower_flops(lengths, h, inter, layers) + 2.0 * len(lengths) * n_catalog * h


def train_flops(anchor_lengths, positive_lengths, h: int, inter: int, layers: int) -> float:
    """One MNRL step: both towers forward and backward, three times the
    forward of both sides."""
    return 3.0 * (
        tower_flops(anchor_lengths, h, inter, layers)
        + tower_flops(positive_lengths, h, inter, layers)
    )
