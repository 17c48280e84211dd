"""The operation and byte counts against counts made by hand."""

import numpy as np
import pytest

from benchmark import counts


def test_layer_ops_by_hand():
    # MiniLM widths, one row of 16 tokens: four 384x384 projections and the
    # 384x1536 FFN pair, 2 x m x n x k each, plus QK^T and PV.
    b, s, h, i = 1, 16, 384, 1536
    by_hand = 2 * 16 * 384 * 384 * 4 + 2 * 16 * 384 * 1536 * 2 + 2 * (2 * 16 * 16 * 384)
    assert counts.layer_ops(b, s, h, i) == by_hand


def test_k1_bound_is_operations_at_the_bf16_peak_at_serve_shapes():
    ops = counts.layer_ops(256, 192, 768, 3072)
    assert counts.k1_bound_s(256, 192, 768, 3072) == pytest.approx(ops / 989e12)


def test_k1_bound_is_bytes_where_the_work_is_small():
    # One row of 16 tokens: the weights' bytes dominate.
    h, i = 384, 1536
    weights = (4 * h * h + 2 * h * i) * 2 + (6 * h + i) * 2 + 4 * h * 4
    n_bytes = 16 * h * 2 * 2 + 16 * 4 + weights
    assert counts.k1_bound_s(1, 16, h, i) == pytest.approx(n_bytes / 3.35e12)


def test_k5_bound_leaves_out_the_forward_recompute():
    # The gradient's own work: twice the forward, never three times.
    b, s, h, i = 512, 256, 384, 1536
    assert counts.k5_bound_s(b, s, h, i) == pytest.approx(2 * counts.layer_ops(b, s, h, i) / 989e12)
    assert counts.k5_bound_s(b, s, h, i) < 3 * counts.layer_ops(b, s, h, i) / 989e12


def test_k3_bound_is_2bnd_at_the_tf32_peak_or_the_catalog_bytes():
    b, n, d, k = 256, 49688, 768, 10
    ops_s = 2 * b * n * d / 495e12
    bytes_s = (n * d * 4 + b * d * 4 + b * k * 8) / 3.35e12
    assert counts.k3_bound_s(b, n, d, k) == pytest.approx(max(ops_s, bytes_s))
    # One query reads the whole catalog: bytes bound it.
    assert counts.k3_bound_s(1, n, d, k) == pytest.approx((n * d * 4 + d * 4 + k * 8) / 3.35e12)


def test_counts_take_real_lengths_not_the_padding():
    # The same sequences count the same however the program pads them: a
    # length of 20 counts as 32, whether the batch went in at 32 or 256.
    real = np.array([20, 9, 31])
    f = counts.tower_flops(real, 384, 1536, 6)
    assert f == counts.tower_flops(np.array([32, 16, 32]), 384, 1536, 6)
    per_seq = [2 * s * (4 * 384 * 384 + 2 * 384 * 1536) + 4 * s * s * 384 for s in (32, 16, 32)]
    assert f == pytest.approx(6 * sum(per_seq))


def test_serve_and_train_flops():
    lengths = np.array([40, 17])
    tower = counts.tower_flops(lengths, 768, 3072, 12)
    assert counts.serve_flops(lengths, 768, 3072, 12, 1000) == pytest.approx(
        tower + 2 * 2 * 1000 * 768)
    a, p = np.array([200, 120]), np.array([20, 25])
    assert counts.train_flops(a, p, 384, 1536, 6) == pytest.approx(
        3 * (counts.tower_flops(a, 384, 1536, 6) + counts.tower_flops(p, 384, 1536, 6)))


def test_round_up():
    assert [counts.round_up(n) for n in (1, 16, 17, 255, 256)] == [16, 16, 32, 256, 256]
