"""The top-k kernels' decomposition (csrc/topk.cu: K3 exact, K4 packed),
modelled in torch on the CPU and held against the JAX package's
``cosine_topk_reference`` and ``cosine_topk_pallas(..., interpret=True)``.

The model follows the kernel step by step: scores in split TF32 (each f32
operand as two TF32 values, hi hi + hi lo + lo hi), 64-bit keys (the
score's order bits, K4's with the low 12 cleared, then the inverted global
row), each slice of whole 128-row tiles walked 32 rows at a time against
a per-query threshold (the k-th key kept), passing keys collected 32 at a
time and merged into a sorted list of KP keys by the kernel's own bitonic
network, and the merge kernel's selection over the slice-major candidate
keys (the same as a stable descending sort of them). The CUDA kernels
themselves are held against the plain version on the GPU in
tests/test_torch_kernels_gpu.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instacart_next_order_recommendation_tpu.ops.topk import (
    cosine_topk_pallas,
    cosine_topk_reference as jax_topk_reference,
)
from instacart_next_order_recommendation_tpu_torch.ops.topk import (
    BLOCK_N,
    TILE_N,
    cosine_topk_packed_reference,
    cosine_topk_reference,
    query_tile,
    slice_plan,
)

SIGN = 1 << 31
LOW32 = 0xFFFFFFFF
# The kernel's keys are unsigned; here the top bit is flipped so that int64
# order is the kernel's order, and its empty key 0 becomes the int64 minimum.
EMPTY = torch.iinfo(torch.int64).min


# ------------------------------------------------------------ split TF32


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32``: f32 rounded to 10 mantissa bits, to nearest,
    ties away from zero (half an ulp added to the magnitude, then cut)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_trunc(x: torch.Tensor) -> torch.Tensor:
    """What the tensor core reads of an f32 register given as TF32: its top
    19 bits, the low 13 cut."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def split_tf32(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``split_tf32`` of mma_common.cuh as the tensor core reads it: hi
    rounded to TF32, lo = x - hi (exact in f32) truncated to TF32."""
    hi = tf32_rna(x)
    return hi, tf32_trunc(x - hi)


def split_tf32_scores(q: torch.Tensor, c: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """The kernel's three tensor-core products, small terms first, summed in
    ``dtype`` (float64: the split's error alone)."""
    hq, lq = (t.to(dtype) for t in split_tf32(q))
    hc, lc = (t.to(dtype) for t in split_tf32(c))
    return (lq @ hc.T + hq @ lc.T) + hq @ hc.T


# ------------------------------------------------------------ keys


def order_bits(s: torch.Tensor) -> torch.Tensor:
    u = s.contiguous().view(torch.int32).to(torch.int64) & LOW32
    return torch.where(u >= SIGN, ~u & LOW32, u | SIGN)


def make_keys(scores: torch.Tensor, rows: torch.Tensor, packed: bool) -> torch.Tensor:
    """``make_key`` of the kernel, as signed int64: +0 and -0 one key."""
    s = torch.where(scores == 0, torch.zeros_like(scores), scores)
    ob = order_bits(s)
    if packed:
        ob = ob & ~0xFFF
    hi = ob ^ SIGN
    hi = torch.where(hi >= SIGN, hi - (1 << 32), hi)
    return (hi << 32) | (LOW32 - rows)


def decode(keys: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Score and row of each key; an empty slot reads -inf and -1."""
    ob = ((keys >> 32) & LOW32) ^ SIGN
    u = torch.where(ob >= SIGN, ob & 0x7FFFFFFF, ~ob & LOW32)
    u = torch.where(u >= SIGN, u - (1 << 32), u).to(torch.int32)
    rows = (LOW32 - (keys & LOW32)).to(torch.int32)
    empty = keys == EMPTY
    scores = torch.where(empty, torch.tensor(-float("inf")), u.view(torch.float32))
    return scores, torch.where(empty, torch.tensor(-1, dtype=torch.int32), rows)


# ------------------------------------------------------------ selection


def merge_network(top: torch.Tensor, pend: torch.Tensor) -> torch.Tensor:
    """``merge_pending``'s network, lane by lane: ``top`` [Q, KP] sorted
    descending (slot e * 32 + lane), ``pend`` [Q, 32] in any order, empties
    EMPTY. Returns the best KP of both, descending."""
    lane = torch.arange(32)
    p = pend.clone()
    size = 2
    while size <= 32:
        stride = size // 2
        while stride:
            o = p[:, lane ^ stride]
            up = (lane & size) == 0
            lower = (lane & stride) == 0
            p = torch.where(lower == up, torch.minimum(p, o), torch.maximum(p, o))
            stride //= 2
        size *= 2
    e_slots = top.shape[1] // 32
    v = top.reshape(-1, e_slots, 32).clone()
    v[:, -1] = torch.maximum(v[:, -1], p)
    es = e_slots // 2
    while es:
        for e in range(e_slots):
            if e & es == 0:
                a, b = v[:, e].clone(), v[:, e + es].clone()
                v[:, e], v[:, e + es] = torch.maximum(a, b), torch.minimum(a, b)
        es //= 2
    stride = 16
    while stride:
        o = v[:, :, lane ^ stride]
        v = torch.where((lane & stride) != 0, torch.minimum(v, o), torch.maximum(v, o))
        stride //= 2
    return v.reshape(top.shape)


def kp_of(k: int) -> int:
    return max(32, 1 << (k - 1).bit_length())


def select_slice(keys: torch.Tensor, k: int) -> tuple[torch.Tensor, int]:
    """One slice's top k per query ([Q, L] keys, rows in order) as the
    kernel's warps find it: 32 rows at a time, a key passes when above the
    query's threshold, passing keys wait in a 32-slot buffer, and a full
    buffer (or the slice's end) merges into the list. Returns [Q, k] keys,
    descending, and the number of merges."""
    nq, length = keys.shape
    kp = kp_of(k)
    top = torch.full((nq, kp), EMPTY, dtype=torch.int64)
    pend = torch.full((nq, 32), EMPTY, dtype=torch.int64)
    thr = torch.full((nq,), EMPTY, dtype=torch.int64)
    cnt = torch.zeros(nq, dtype=torch.int64)
    merges = 0
    for r0 in range(0, length, 32):
        chunk = keys[:, r0 : r0 + 32]
        passing = chunk > thr[:, None]
        rank = torch.cumsum(passing, 1) - passing.long()
        n = passing.sum(1)
        room = 32 - cnt
        q_idx, j_idx = torch.nonzero(passing & (rank < room[:, None]), as_tuple=True)
        pend[q_idx, (cnt[q_idx] + rank[q_idx, j_idx])] = chunk[q_idx, j_idx]
        full = n >= room
        if full.any():
            merges += int(full.sum())
            top[full] = merge_network(top[full], pend[full])
            thr[full] = top[full, k - 1]
            pend[full] = EMPTY
            q_idx, j_idx = torch.nonzero(passing & (rank >= room[:, None]), as_tuple=True)
            pend[q_idx, rank[q_idx, j_idx] - room[q_idx]] = chunk[q_idx, j_idx]
        cnt = torch.where(full, n - room, cnt + n)
    rest = cnt > 0
    if rest.any():
        merges += int(rest.sum())
        top[rest] = merge_network(top[rest], pend[rest])
    return top[:, :k], merges


def masked_scores(q, c, n_valid, mask, split=True) -> torch.Tensor:
    scores = split_tf32_scores(q, c) if split else q @ c.T
    col = torch.arange(c.shape[0])
    if n_valid is not None:
        scores = torch.where(col[None] < n_valid, scores, -1e30)
    if mask is not None:
        scores = torch.where(mask[None] != 0, scores, -1e30)
    return scores


def model_topk(q, c, k, n_valid=None, mask=None, packed=False, slice_rows=None, split=True):
    """The kernels' decomposition end to end: each slice's top k keys
    (empty slots past a short slice's last row), laid out slice-major, then
    the merge kernel's selection over them."""
    n = c.shape[0]
    slice_rows = slice_rows or slice_plan(q.shape[0], n, k, 132)[0]
    assert slice_rows % TILE_N == 0
    scores = masked_scores(q, c, n_valid, mask, split)
    cand = []
    for r0 in range(0, n, slice_rows):
        rows = torch.arange(r0, min(n, r0 + slice_rows))
        cand.append(select_slice(make_keys(scores[:, rows], rows, packed), k)[0])
    cand = torch.cat(cand, 1)
    top, _ = select_slice(cand, k)
    # The same as a stable descending sort of the decoded candidates: a
    # lower slice wins a tie as a lower row does.
    cand_s, cand_i = decode(cand)
    vals, pos = torch.sort(cand_s, dim=1, descending=True, stable=True)
    s, i = decode(top)
    assert torch.equal(i, torch.gather(cand_i, 1, pos[:, :k])) and torch.equal(s, vals[:, :k])
    return s, i


# ------------------------------------------------------------ inputs


def unit_rows(rng, n, d):
    x = rng.standard_normal((n, d))
    return torch.from_numpy((x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32))


def grid_rows(rng, n, d):
    """k / 16 with |k| <= 8: exact in TF32, so every score is exact in f32
    under any summation order and ties are exact."""
    return torch.from_numpy((rng.integers(-8, 9, size=(n, d)) / 16).astype(np.float32))


def jax_ref(q, c, k, n_valid=None, mask=None):
    s, i = jax_topk_reference(
        jnp.asarray(q.numpy()), jnp.asarray(c.numpy()), k, n_valid=n_valid,
        candidate_mask=None if mask is None else jnp.asarray(mask.numpy()),
    )
    return np.asarray(s), np.asarray(i)


def jax_pallas(q, c, k, n_valid=None, mask=None, packed=False, block_n=1024):
    s, i = cosine_topk_pallas(
        jnp.asarray(q.numpy()), jnp.asarray(c.numpy()), k, block_n=block_n, interpret=True,
        n_valid=n_valid, candidate_mask=None if mask is None else jnp.asarray(mask.numpy()),
        packed=packed,
    )
    return np.asarray(s), np.asarray(i)


# ------------------------------------------------------------ tests


@pytest.mark.parametrize("d", [384, 768])
def test_split_tf32_error_bound_on_unit_rows(d):
    rng = np.random.default_rng(d)
    q, c = unit_rows(rng, 32, d), unit_rows(rng, 2000, d)
    exact = q.double() @ c.double().T
    split_only = split_tf32_scores(q, c, torch.float64)
    # |x - hi| <= 2^-11 |x| and lo loses at most 2^-10 of itself (2^-21 of
    # |x|) to truncation; with lo lo left out, at most (2^-22 + 2 * 2^-21)
    # = 1.25 * 2^-20 of sum |q_i c_i|, which is at most 1 for unit rows.
    bound = 1.25 * 2.0**-20 * (q.double().abs() @ c.double().abs().T)
    assert ((split_only - exact).abs() <= bound).all()
    # Random rows sit far inside it: the errors cancel.
    assert ((split_only - exact).abs() <= bound / 8).all()
    # With the f32 accumulation the tensor cores do: within 1e-6 of float64,
    # as close as the plain f32 product is.
    assert (split_tf32_scores(q, c).double() - exact).abs().max().item() <= 1e-6
    # Grid values are exact in TF32: the low parts vanish, scores are exact.
    g = grid_rows(rng, 64, d)
    assert (split_tf32(g)[1] == 0).all()
    assert torch.equal(split_tf32_scores(g[:8], g), g[:8] @ g.T)


def test_tf32_rounding_is_to_nearest_ties_away():
    one = torch.tensor([1.0], dtype=torch.float32).view(torch.int32)
    ulp = 2.0**-10
    steps = torch.tensor([0x1000, 0x0FFF, 0x3000, 0x1001], dtype=torch.int32)
    vals = (one + steps).view(torch.float32)
    assert tf32_rna(vals).tolist() == [1 + ulp, 1.0, 1 + 2 * ulp, 1 + ulp]
    assert tf32_rna(-vals).tolist() == [-(1 + ulp), -1.0, -(1 + 2 * ulp), -(1 + ulp)]


@pytest.mark.parametrize("kp", [32, 64, 128, 256])
def test_merge_network_keeps_the_best_kp_sorted(kp):
    rng = np.random.default_rng(kp)
    for n_top, n_pend in ((0, 32), (kp - 5, 7), (kp, 32), (kp, 1)):
        old = torch.from_numpy(rng.choice(1 << 40, size=(6, kp + 32), replace=False))
        top = torch.full((6, kp), EMPTY, dtype=torch.int64)
        top[:, :n_top] = torch.sort(old[:, :n_top], 1, descending=True).values
        pend = torch.full((6, 32), EMPTY, dtype=torch.int64)
        pend[:, :n_pend] = old[:, kp : kp + n_pend]
        out = merge_network(top, pend)
        want = torch.sort(torch.cat([top, pend], 1), 1, descending=True).values[:, :kp]
        assert torch.equal(out, want)


@pytest.mark.parametrize("k", [1, 10, 16, 100, 256])
def test_threshold_selection_equals_sorting_the_slice(k):
    rng = np.random.default_rng(k)
    scores = torch.from_numpy(rng.standard_normal((5, 1024)).astype(np.float32))
    scores[1] = scores[1].sort(descending=False).values  # every row passes
    scores[2, 300:] = -1e30  # masked rows still fill the list
    rows = torch.arange(4096 - 512, 4096 + 512)  # global rows across 4096
    keys = make_keys(scores, rows, packed=False)
    top, _ = select_slice(keys, k)
    assert torch.equal(top, torch.sort(keys, 1, descending=True).values[:, :k])
    # Rows in random order: about k (1 + ln(L / k)) keys pass, 32 to a merge.
    if k <= 16:
        assert select_slice(keys[[0, 3, 4]], k)[1] <= 3 * 5


def test_slice_plan_and_query_tile():
    assert [query_tile(b, k) for b, k in [(1, 16), (8, 256), (9, 16), (256, 100), (256, 129)]] == [
        8, 8, 64, 64, 32,
    ]
    # The serve batch on a 132-SM H100: 4 query tiles, 33 slices of 12 tiles.
    assert slice_plan(256, 50_000, 16, 132) == (1536, 33)
    assert slice_plan(1, 50_000, 16, 132) == (256, 196)
    assert slice_plan(8, 1_000_000, 10, 132) == (3840, 261)
    assert slice_plan(256, 1_000_000, 10, 132) == (30336, 33)
    for b, n, k, sms in [(1, 100, 16, 132), (5000, 50_000, 10, 132), (70, 3000, 100, 114)]:
        rows, n_slices = slice_plan(b, n, k, sms)
        assert rows % TILE_N == 0 and (n_slices - 1) * rows < n <= n_slices * rows
        assert -(-b // query_tile(b, k)) * n_slices <= max(sms * 2, -(-b // query_tile(b, k)))


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("b,n,k,n_valid,masked", [
    (3, 900, 10, None, False), (4, 1300, 16, 1250, True), (2, 700, 100, None, True),
])
def test_model_matches_jax_on_unit_rows(b, n, k, n_valid, masked, packed):
    rng = np.random.default_rng(n + k)
    q, c = unit_rows(rng, b, 48), unit_rows(rng, n, 48)
    mask = torch.from_numpy((rng.random(n) < 0.7).astype(np.int32)) if masked else None
    s, i = model_topk(q, c, k, n_valid, mask, packed, slice_rows=256)
    # Split TF32 moves scores by far less than their gaps here: the f32
    # plain version and the JAX packages rank alike.
    plain = cosine_topk_packed_reference if packed else cosine_topk_reference
    s_p, i_p = plain(q, c, k, n_valid, mask)
    assert torch.equal(i, i_p)
    np.testing.assert_allclose(s.numpy(), s_p.numpy(), atol=1e-6)
    ref_s, ref_i = jax_pallas(q, c, k, n_valid, mask, packed, block_n=512)
    np.testing.assert_array_equal(i.numpy(), ref_i)
    np.testing.assert_allclose(s.numpy(), ref_s, atol=1e-6)
    if not packed:
        ref_s, ref_i = jax_ref(q, c, k, n_valid, mask)
        np.testing.assert_array_equal(i.numpy(), ref_i)


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("slice_rows", [128, 384, 4224])
def test_grid_ties_inside_and_across_slices_and_4096_rows(slice_rows, packed):
    rng = np.random.default_rng(slice_rows)
    n = 9000
    c = grid_rows(rng, n, 32)
    q = grid_rows(rng, 3, 32)
    tied = [7, 8, 127, 128, 383, 384, 4095, 4096, 4223, 4224, 8191, 8192, 8999]
    c[tied] = c[7].clone()  # ties inside a slice, across slice boundaries, across 4096
    q[0] = c[7]
    for k in (1, 16, 100):
        s, i = model_topk(q, c, k, packed=packed, slice_rows=slice_rows)
        plain = cosine_topk_packed_reference if packed else cosine_topk_reference
        s_p, i_p = plain(q, c, k)
        assert torch.equal(i, i_p) and torch.equal(s, s_p)
        assert i[0, : min(k, len(tied))].tolist() == tied[:k]
        ref_s, ref_i = jax_ref(q, c, k)
        if not packed:
            np.testing.assert_array_equal(i.numpy(), ref_i)
            np.testing.assert_array_equal(s.numpy(), ref_s)
    s, i = model_topk(q, c, 16, packed=packed, slice_rows=slice_rows)
    ref_s, ref_i = jax_pallas(q, c, 16, packed=packed, block_n=4096)
    np.testing.assert_array_equal(i.numpy(), ref_i)
    np.testing.assert_array_equal(s.numpy(), ref_s)


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("k", [1, 10, 16, 100, 256])
def test_masks_n_valid_and_every_form_of_k(k, packed):
    rng = np.random.default_rng(100 + k)
    n = 2000
    c, q = grid_rows(rng, n, 32), grid_rows(rng, 4, 32)
    c[1000:1010] = c[3]
    q[0] = c[3]
    mask = torch.from_numpy((rng.random(n) < 0.5).astype(np.int32))
    mask[[3, 1000, 1005]] = 1
    plain = cosine_topk_packed_reference if packed else cosine_topk_reference
    for n_valid, m in ((None, None), (1900, None), (None, mask), (1500, mask)):
        # Slices of 128 rows: at k > 128 every slice's list has empty slots.
        s, i = model_topk(q, c, k, n_valid, m, packed, slice_rows=128)
        s_p, i_p = plain(q, c, k, n_valid, m)
        assert torch.equal(i, i_p) and torch.equal(s, s_p)
        if not packed:
            np.testing.assert_array_equal(i.numpy(), jax_ref(q, c, k, n_valid, m)[1])


@pytest.mark.parametrize("packed", [False, True])
def test_fewer_eligible_rows_than_k(packed):
    rng = np.random.default_rng(5)
    q, c = unit_rows(rng, 3, 32), unit_rows(rng, 300, 32)
    mask = torch.zeros(300, dtype=torch.int32)
    mask[[3, 77, 150, 299]] = 1
    for slice_rows in (128, 256):
        s, i = model_topk(q, c, 9, mask=mask, packed=packed, slice_rows=slice_rows)
        plain = cosine_topk_packed_reference if packed else cosine_topk_reference
        s_p, i_p = plain(q, c, 9, None, mask)
        assert torch.equal(i, i_p)
        np.testing.assert_allclose(s.numpy(), s_p.numpy(), atol=1e-6)
        # Masked rows fill the tail in index order, not the JAX kernel's repeats.
        assert i[:, 4:].tolist() == [[0, 1, 2, 4, 5]] * 3
        if not packed:
            ref_s, ref_i = jax_ref(q, c, 9, mask=mask)
            np.testing.assert_array_equal(i.numpy(), ref_i)


def test_block_limit_is_the_kernel_limit():
    # The kernel's lists hold up to 256 keys (KP), the public k limit.
    assert kp_of(BLOCK_N) == BLOCK_N and [kp_of(k) for k in (1, 32, 33, 100, 129)] == [
        32, 32, 64, 128, 256,
    ]
