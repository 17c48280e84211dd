"""K2's decomposition (csrc/pool_norm.cu), modelled in torch on the CPU and
held against the JAX package's ``masked_mean_pool_l2norm_reference`` and
``masked_mean_pool_l2norm_pallas(..., interpret=True)``.

The model follows the kernel step by step: a batch row's S split over the
ranks of a cluster (``pool_plan``'s ``cluster`` and ``chunk``), each
block's mask staged as f32 weights 2048 positions at a time and counted by
one warp, its threads laid out as chunk lanes (one 8-wide or 1-wide chunk
of a token row each, several column passes where a row has more chunks
than the block has threads) and row lanes (every ``rows``-th token row),
``ROWS`` token rows in flight per thread with an accumulator each, the
accumulators added in order, the row lanes' sums added in order, the ranks'
sums and counts added in rank order, and the squared norm summed per thread,
per warp by the butterfly and over the warps in order. The inputs are
bf16-valued and the weights 0 or 1, so every product is exact and the
model's mul-add is the kernel's fma. The CUDA kernel itself is held against
the plain version on the GPU in tests/test_torch_kernels_gpu.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instacart_next_order_recommendation_tpu.ops.pool_norm import (
    masked_mean_pool_l2norm_pallas,
    masked_mean_pool_l2norm_reference as jax_pool_reference,
)
from instacart_next_order_recommendation_tpu_torch.ops.pool_norm import (
    MAX_CLUSTER,
    MAX_HIDDEN,
    PoolPlan,
    masked_mean_pool_l2norm,
    masked_mean_pool_l2norm_reference,
    pool_plan,
)

MASK_TILE = 2048  # csrc/pool_norm.cu: token positions whose weights a block stages at once
MAX_WARPS = 16    # csrc/pool_norm.cu: the kernel's launch bound, 512 threads
SMEM_LIMIT = 232_448  # the dynamic shared memory one block may opt into on an H100


# ------------------------------------------------------------ the kernel's layout


def lanes(h: int, vec: int, threads: int) -> tuple[int, int, int, int]:
    """``lanes_of``: (chunks in a row, chunk lanes a pass, row lanes, passes)."""
    chunks = -(-h // vec)
    per_pass = min(chunks, threads)
    return chunks, per_pass, threads // per_pass, -(-chunks // per_pass)


def smem_bytes(h: int, vec: int, threads: int) -> int:
    _, per_pass, rows, passes = lanes(h, vec, threads)
    return (rows * passes * per_pass * vec + MASK_TILE + 64) * 4


def rank_ranges(plan: PoolPlan, s: int) -> list[range]:
    """The token rows each cluster rank takes."""
    out = []
    for rank in range(plan.cluster):
        begin = min(s, rank * plan.chunk)
        out.append(range(begin, min(s, begin + plan.chunk)))
    return out


def thread_rows(begin: int, end: int, r_lane: int, row_lanes: int, in_flight: int):
    """The token rows of [begin, end) one row lane loads, as (row, slot in
    flight): rows r, r + R, ... taken ``in_flight`` at a time per step."""
    for t0 in range(begin, max(end, begin + 1), MASK_TILE):
        t1 = min(end, t0 + MASK_TILE)
        for s in range(t0 + r_lane, t1, row_lanes * in_flight):
            for u in range(in_flight):
                if s + u * row_lanes < t1:
                    yield s + u * row_lanes, u


# ------------------------------------------------------------ the model


def warp_sum(v: torch.Tensor) -> torch.Tensor:
    """``warp_sum``: the xor butterfly over the last axis (32 lanes); every
    lane ends with the same value, lane 0's is returned."""
    idx = torch.arange(32)
    for o in (16, 8, 4, 2, 1):
        v = v + v[..., idx ^ o]
    return v[..., 0]


def strided_sums(v: torch.Tensor, width: int) -> torch.Tensor:
    """Lane i's sum of v[i], v[i + width], ... in order."""
    pad = (-v.shape[0]) % width
    rows = torch.cat([v, torch.zeros(pad, dtype=v.dtype)]).view(-1, width)
    acc = torch.zeros(width, dtype=v.dtype)
    for row in rows:
        acc = acc + row
    return acc


def model_block(x: torch.Tensor, w: torch.Tensor, begin: int, end: int, vec: int,
                in_flight: int, threads: int) -> tuple[torch.Tensor, torch.Tensor]:
    """One block over token rows [begin, end) of one batch row: its column
    sums [H] and its count, in the kernel's order."""
    h = x.shape[1]
    chunks, per_pass, row_lanes, passes = lanes(h, vec, threads)
    red = torch.zeros(row_lanes, passes * per_pass * vec)
    count = torch.zeros(())
    first, t0 = True, begin
    while first or t0 < end:
        t1 = min(end, t0 + MASK_TILE)
        count = count + warp_sum(strided_sums(w[t0:t1], 32))
        for p in range(passes):
            cc = torch.arange(p * per_pass, min(chunks, (p + 1) * per_pass))
            cols = (cc[:, None] * vec + torch.arange(vec)).flatten()
            cols = cols[cols < h]
            for r in range(row_lanes):
                acc = torch.zeros(in_flight, cols.numel())
                for s in range(t0 + r, t1, row_lanes * in_flight):
                    for u in range(in_flight):
                        su = s + u * row_lanes
                        if su < t1:
                            acc[u] = acc[u] + x[su, cols] * w[su]
                v = acc[0]
                for u in range(1, in_flight):
                    v = v + acc[u]
                red[r, cols] = v if first else red[r, cols] + v
        first, t0 = False, t0 + MASK_TILE
    colsum = red[0, :h]
    for r in range(1, row_lanes):
        colsum = colsum + red[r, :h]
    return colsum, count


def model_pool(hidden: torch.Tensor, mask: torch.Tensor, plan: PoolPlan, vec: int) -> torch.Tensor:
    """The kernel's output for f32 (bf16-valued) ``hidden`` [B, S, H] and a
    0/1 ``mask`` [B, S], in ``plan``'s form and ``vec``-wide loads."""
    b_n, s_n, h = hidden.shape
    threads = plan.warps * 32
    in_flight = plan.rows if vec == 8 else 8  # the 2-byte loads keep 8 rows in flight
    w_all = mask.to(torch.float32)
    out = torch.empty((b_n, h))
    for b in range(b_n):
        parts = [
            model_block(hidden[b], w_all[b], rr.start, rr.stop, vec, in_flight, threads)
            for rr in rank_ranges(plan, s_n)
        ]
        total, cnt = parts[0]
        for colsum, count in parts[1:]:
            total, cnt = total + colsum, cnt + count
        pooled = total / torch.clamp_min(cnt, 1e-9)
        per_thread = strided_sums(pooled * pooled, threads)
        warps = warp_sum(per_thread.view(-1, 32))
        sq = torch.zeros(())
        for v in warps:
            sq = sq + v
        out[b] = pooled / torch.clamp_min(torch.sqrt(sq), 1e-12)
    return out


# ------------------------------------------------------------ inputs


def inputs(batch: int, seq: int, h: int, seed: int):
    """bf16-valued f32 hidden states and a 0/1 int32 mask whose last row is
    all pad (the padded batch buckets carry such rows)."""
    rng = np.random.default_rng(seed)
    hidden = torch.from_numpy(rng.standard_normal((batch, seq, h)).astype(np.float32))
    hidden = hidden.to(torch.bfloat16).float()
    lengths = rng.integers(1, seq + 1, size=batch)
    lengths[-1] = 0
    mask = torch.from_numpy((np.arange(seq)[None] < lengths[:, None]).astype(np.int32))
    return hidden, mask


def jax_outputs(hidden: torch.Tensor, mask: torch.Tensor):
    h, m = jnp.asarray(hidden.numpy()), jnp.asarray(mask.numpy())
    return (
        np.asarray(jax_pool_reference(h, m)),
        np.asarray(masked_mean_pool_l2norm_pallas(h, m, interpret=True)),
    )


# ------------------------------------------------------------ tests


# f32 sums in another order than JAX's over at most a few hundred terms of
# unit scale, on a unit-norm output.
TOL = 1e-6


@pytest.mark.parametrize("h", [384, 768, 100])
@pytest.mark.parametrize(
    "cluster,warps,rows", [(1, 8, 4), (2, 4, 2), (4, 12, 4), (8, 16, 2), (None, None, None)]
)
def test_model_matches_jax(h, cluster, warps, rows):
    b, s = 4, 48
    hidden, mask = inputs(b, s, h, seed=h)
    plan = pool_plan(b, s) if cluster is None else PoolPlan(cluster, warps, rows, -(-s // cluster))
    out = model_pool(hidden, mask, plan, vec=8 if h % 8 == 0 else 1).numpy()
    ref, pallas = jax_outputs(hidden, mask)
    np.testing.assert_allclose(out, ref, atol=TOL)
    np.testing.assert_allclose(out, pallas, atol=TOL)
    assert (out[-1] == 0).all()  # the all-pad row pools to the zero vector
    np.testing.assert_allclose(np.linalg.norm(out[:-1], axis=1), 1.0, atol=TOL)


@pytest.mark.parametrize("cluster", [1, 2])
def test_model_over_mask_tiles_and_column_passes(cluster):
    # S = 2500 takes two mask tiles in one block; H = 1000 at one warp takes
    # four column passes of 32 chunk lanes.
    b, s, h = 2, 2500, 1000
    hidden, mask = inputs(b, s, h, seed=7)
    plan = PoolPlan(cluster, 1, 4, -(-s // cluster))
    assert lanes(h, 8, 32) == (125, 32, 1, 4)
    out = model_pool(hidden, mask, plan, vec=8).numpy()
    ref, _ = jax_outputs(hidden, mask)
    np.testing.assert_allclose(out, ref, atol=TOL)


def test_the_8_and_1_wide_loads_agree():
    # The same shape through both load widths: other lanes, the same sums
    # up to f32 order.
    hidden, mask = inputs(3, 40, 64, seed=8)
    plan = PoolPlan(2, 4, 4, 20)
    wide, narrow = model_pool(hidden, mask, plan, 8), model_pool(hidden, mask, plan, 1)
    np.testing.assert_allclose(wide.numpy(), narrow.numpy(), atol=TOL)


@pytest.mark.parametrize("bad", [float("nan"), float("inf")])
def test_nan_or_inf_at_a_masked_position_reaches_its_row(bad):
    # Masked positions are read and multiplied by their zero weight, as the
    # plain version and JAX's reference do: NaN * 0 and Inf * 0 are NaN.
    hidden, mask = inputs(3, 32, 384, seed=9)
    pad = int(mask[0].sum())
    assert pad < 32
    hidden[0, pad, 5] = bad
    plan = pool_plan(3, 32)
    out = model_pool(hidden, mask, plan, vec=8)
    ref = masked_mean_pool_l2norm_reference(hidden, mask)
    jax_ref, _ = jax_outputs(hidden, mask)
    assert torch.isnan(out[0]).all() and torch.isnan(ref[0]).all() and np.isnan(jax_ref[0]).all()
    assert torch.isfinite(out[1:]).all()
    np.testing.assert_allclose(out[1:].numpy(), jax_ref[1:], atol=TOL)


def test_the_cpu_wrapper_takes_the_plain_version():
    hidden, mask = inputs(3, 32, 384, seed=10)
    before = masked_mean_pool_l2norm.launches
    out = masked_mean_pool_l2norm(hidden, mask)
    assert masked_mean_pool_l2norm.launches == before  # no kernel on the CPU
    assert torch.equal(out, masked_mean_pool_l2norm_reference(hidden, mask))


PLAN_B = sorted({*range(1, 65), 96, 100, 127, 128, 131, 132, 133, 200, 256, 257, 511, 512, 1000,
                 1024, 2048, 4095, 4096})
PLAN_H = (1, 7, 8, 100, 384, 392, 768, 1000, 1024, 4096, 12287, 12288)


@pytest.mark.parametrize("h", PLAN_H)
def test_pool_plan_is_total_and_covers_every_position_once(h):
    for b in PLAN_B:
        for s in range(1, 513):
            plan = pool_plan(b, s)
            assert plan.cluster in (1, 2, 4, 8) and plan.cluster <= MAX_CLUSTER
            assert 1 <= plan.warps <= MAX_WARPS and plan.rows in (2, 4)
            covered = [len(rr) for rr in rank_ranges(plan, s)]
            # Every rank has rows, and the ranks' ranges tile [0, s).
            assert plan.chunk >= 1 and sum(covered) == s and min(covered) > 0, (b, s, h, plan)
            for vec in (8, 1):
                assert smem_bytes(h, vec, plan.warps * 32) <= SMEM_LIMIT


@pytest.mark.parametrize("h", [384, 768, 100, 12288])
@pytest.mark.parametrize("b,s", [(1, 64), (64, 256), (256, 192), (3, 2500)])
def test_lanes_take_every_row_and_column_once(b, s, h):
    # Within a block, the row lanes and the rows in flight take each token
    # row of the rank's range once; the chunk lanes and passes take each
    # column once.
    plan = pool_plan(b, s)
    threads = plan.warps * 32
    for vec in (8, 1) if h % 8 == 0 else (1,):
        chunks, per_pass, row_lanes, passes = lanes(h, vec, threads)
        assert 1 <= row_lanes * per_pass <= threads
        cols = sorted(
            (p * per_pass + c) * vec + j
            for p in range(passes) for c in range(per_pass) for j in range(vec)
            if p * per_pass + c < chunks and (p * per_pass + c) * vec + j < h
        )
        assert cols == list(range(h))
        in_flight = plan.rows if vec == 8 else 8
        for rr in rank_ranges(plan, s):
            taken = sorted(
                row for r in range(row_lanes)
                for row, _ in thread_rows(rr.start, rr.stop, r, row_lanes, in_flight)
            )
            assert taken == list(rr)


def test_pool_plan_rule():
    # The rule the H100's timings set (PERF.md section 6): S over a cluster
    # only while the blocks fill at most half the 132 SMs and each keeps 24
    # token rows; 16 warps and 4 rows in flight at one block per SM, 12 and
    # 2 at up to two, else 8 and 2.
    assert pool_plan(256, 192) == PoolPlan(1, 12, 2, 192)   # the serve batch
    assert pool_plan(512, 32) == PoolPlan(1, 8, 2, 32)      # a catalog batch
    assert pool_plan(64, 256) == PoolPlan(1, 16, 4, 256)    # a train step
    assert pool_plan(1, 192) == PoolPlan(8, 16, 4, 24)      # one recommend
    assert pool_plan(1, 64) == PoolPlan(2, 16, 4, 32)
    assert pool_plan(1, 47).cluster == 1                    # under 24 rows a block
    assert pool_plan(32, 256) == PoolPlan(2, 16, 4, 128)
    assert pool_plan(33, 256).cluster == 2 and pool_plan(34, 256).cluster == 1
    assert pool_plan(8, 192, sm_count=8).cluster == 1


def test_wrapper_refuses_what_the_kernel_does_not_take():
    from instacart_next_order_recommendation_tpu_torch.ops.pool_norm import _launch

    hidden, mask = inputs(2, 16, 64, seed=11)
    with pytest.raises(ValueError):  # no kernel on the CPU
        _launch(hidden.to(torch.bfloat16), mask)
    assert MAX_HIDDEN == 12288
