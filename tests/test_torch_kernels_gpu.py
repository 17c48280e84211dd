"""The port's CUDA kernels against their plain PyTorch versions, on the GPU.

Every test here needs an NVIDIA GPU and skips without one. This file imports
no JAX, so it also runs where only PyTorch is installed:

    python -m pytest tests/test_torch_kernels_gpu.py --noconftest -q
"""

import numpy as np
import pytest
import torch

from instacart_next_order_recommendation_tpu_torch.ops import (
    cosine_topk,
    fused_encoder_layer,
    fused_encoder_layer_backward,
    fused_encoder_layer_train,
    masked_mean_pool_l2norm,
    multi_head_attention,
    multi_head_attention_backward,
    multi_head_attention_backward_reference,
    multi_head_attention_reference,
)
from instacart_next_order_recommendation_tpu_torch.ops.fused_layer import (
    WEIGHT_NAMES,
    draw_dropout_masks,
    fused_encoder_layer_backward_reference,
    fused_encoder_layer_reference,
    fused_encoder_layer_train_reference,
    prepare_layer,
)
from instacart_next_order_recommendation_tpu_torch.ops.pool_norm import (
    _SIGNATURES as POOL_SIGNATURES,
    PoolPlan,
    _launch as pool_launch,
    masked_mean_pool_l2norm_reference,
)
from instacart_next_order_recommendation_tpu_torch.ops import _build
from instacart_next_order_recommendation_tpu_torch.ops.topk import (
    _SIGNATURES as TOPK_SIGNATURES,
    cosine_topk_packed_reference,
    cosine_topk_reference,
    quantized_keys,
    quantized_scores,
    query_tile,
    slice_plan,
)

H, INTER, HEADS = 384, 1536, 12
KW = dict(num_heads=HEADS, scale=1 / 32**0.5, eps=1e-12)
# The fused kernels take head_dim 32 (MiniLM-class) and 64 (mpnet-base-class).
HEAD_DIMS = (32, 64)


def _kw(head_dim, hidden=H):
    return dict(num_heads=hidden // head_dim, scale=1 / head_dim**0.5, eps=1e-12)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _layer(dev, seed=0, h=H, inter=INTER):
    g = torch.Generator().manual_seed(seed)
    raw = {
        name: 0.05 * torch.randn(shape, generator=g)
        for name, shape in {
            "q_w": (h, h), "k_w": (h, h), "v_w": (h, h), "o_w": (h, h),
            "q_b": (h,), "k_b": (h,), "v_b": (h,), "o_b": (h,),
            "attn_ln_bias": (h,), "ffn_ln_bias": (h,),
            "ffn_w1": (h, inter), "ffn_b1": (inter,), "ffn_w2": (inter, h), "ffn_b2": (h,),
        }.items()
    }
    raw["attn_ln_scale"] = 1 + 0.1 * torch.randn(h, generator=g)
    raw["ffn_ln_scale"] = 1 + 0.1 * torch.randn(h, generator=g)
    return prepare_layer({k: v.to(dev) for k, v in raw.items()}, torch.bfloat16)


def _mask(batch, seq, dev, seed=1):
    rng = np.random.default_rng(seed)
    lengths = rng.integers(1, seq + 1, size=batch)
    lengths[-1] = 0 if batch > 1 else seq  # one all-pad row
    return torch.from_numpy((np.arange(seq)[None] < lengths[:, None]).astype(np.int32)).to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("head_dim", HEAD_DIMS)
@pytest.mark.parametrize("batch,seq", [(1, 16), (3, 48), (8, 256)])
def test_fused_layer_matches_plain(dev, batch, seq, head_dim):
    layer = _layer(dev)
    kw = _kw(head_dim)
    g = torch.Generator().manual_seed(2)
    x = torch.randn((batch, seq, H), generator=g).to(dev, torch.bfloat16)
    mask = _mask(batch, seq, dev)
    before = fused_encoder_layer.launches
    y = fused_encoder_layer(x, mask, layer, **kw)
    assert fused_encoder_layer.launches == before + 1
    y_ref = fused_encoder_layer_reference(x, mask, layer, **kw)
    torch.cuda.synchronize()
    assert torch.isfinite(y.float()).all()
    # Two bf16 ulps at |y| < 8: another summation order flips roundings.
    assert (y.float() - y_ref.float()).abs().max().item() <= 0.0625


@pytest.mark.cuda
def test_fused_layer_rejects_shapes_it_does_not_take(dev):
    layer = _layer(dev)
    x = torch.zeros((2, 40, H), device=dev, dtype=torch.bfloat16)  # S % 16 != 0
    with pytest.raises(ValueError):
        fused_encoder_layer(x, torch.ones((2, 40), device=dev), layer, **KW)
    with pytest.raises(ValueError):  # f32 has no kernel
        fused_encoder_layer(x[:, :32].float(), torch.ones((2, 32), device=dev), layer, **KW)
    for head_dim in (16, 128):  # JAX's gate admits them; the port's kernels do not
        with pytest.raises(ValueError):
            fused_encoder_layer(x[:, :32], torch.ones((2, 32), device=dev), layer, **_kw(head_dim))
    long = torch.zeros((1, 272, H), device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError):  # S > 256
        fused_encoder_layer(long, torch.ones((1, 272), device=dev), layer, **KW)


@pytest.mark.cuda
@pytest.mark.parametrize("batch,seq", [(1, 16), (5, 64), (3, 256)])
def test_pool_matches_plain(dev, batch, seq):
    g = torch.Generator().manual_seed(3)
    hidden = torch.randn((batch, seq, H), generator=g).to(dev, torch.bfloat16)
    mask = _mask(batch, seq, dev)
    out = masked_mean_pool_l2norm(hidden, mask)
    ref = masked_mean_pool_l2norm_reference(hidden, mask)
    torch.cuda.synchronize()
    assert (out - ref).abs().max().item() <= 1e-5


# K2, absolute: f32 sums in another order than the plain version's, on a
# unit-norm output.
POOL_TOL = 1e-5


def _pool_input(batch, seq, h, dev, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.randn((batch, seq, h), generator=g).to(dev, torch.bfloat16), _mask(batch, seq, dev)


def _pool_err(out, hidden, mask):
    return (out - masked_mean_pool_l2norm_reference(hidden, mask)).abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("h", [384, 768, 100])
@pytest.mark.parametrize("batch", [1, 8, 131, 256, 1024])
@pytest.mark.parametrize("seq", [32, 192])
def test_pool_in_the_forms_the_plan_picks_matches_plain(dev, batch, seq, h):
    hidden, mask = _pool_input(batch, seq, h, dev, seed=batch + seq + h)
    before = masked_mean_pool_l2norm.launches
    out = masked_mean_pool_l2norm(hidden, mask)
    assert masked_mean_pool_l2norm.launches == before + 1
    torch.cuda.synchronize()
    assert out.dtype == torch.float32 and out.shape == (batch, h)
    assert torch.isfinite(out).all()
    assert _pool_err(out, hidden, mask) <= POOL_TOL
    if batch > 1:
        assert (out[-1] == 0).all()  # the all-pad row


@pytest.mark.cuda
@pytest.mark.parametrize("h", [384, 100, 12288])
@pytest.mark.parametrize("cluster", [1, 2, 4, 8])
@pytest.mark.parametrize("rows", [2, 4])
def test_pool_every_form_matches_plain(dev, rows, cluster, h):
    # Every instance (load width by H, rows in flight, cluster or not) at
    # 4 and 16 warps; S = 2500 takes two mask tiles in one block, H = 12288
    # several column passes.
    for batch, seq in [(3, 192), (2, 2500)]:
        hidden, mask = _pool_input(batch, seq, h, dev, seed=rows + cluster + h)
        for warps in (4, 16):
            plan = PoolPlan(cluster, warps, rows, -(-seq // cluster))
            out = pool_launch(hidden, mask, plan)
            torch.cuda.synchronize()
            assert _pool_err(out, hidden, mask) <= POOL_TOL, (batch, seq, plan)


@pytest.mark.cuda
def test_pool_rows_not_16_byte_aligned(dev):
    # A view one element in: the wrapper takes the 2-byte loads.
    hidden, mask = _pool_input(4, 64, 392, dev, seed=21)
    base = torch.empty(hidden.numel() + 1, dtype=torch.bfloat16, device=dev)
    shifted = base[1:].view(hidden.shape)
    shifted.copy_(hidden)
    assert shifted.data_ptr() % 16 != 0
    out = masked_mean_pool_l2norm(shifted, mask)
    torch.cuda.synchronize()
    assert _pool_err(out, hidden, mask) <= POOL_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("bad", [float("nan"), float("inf")])
@pytest.mark.parametrize("batch", [1, 256])
def test_pool_nan_or_inf_at_a_masked_position_reaches_its_row(dev, batch, bad):
    # Masked positions are read and weighted by 0, as in the plain version:
    # NaN * 0 and Inf * 0 are NaN, in whichever form the plan picks.
    seq = 64
    hidden, _ = _pool_input(batch, seq, 384, dev, seed=22)
    mask = torch.ones((batch, seq), dtype=torch.int32, device=dev)
    mask[0, 40:] = 0
    hidden[0, 50, 7] = bad
    out = masked_mean_pool_l2norm(hidden, mask)
    ref = masked_mean_pool_l2norm_reference(hidden, mask)
    torch.cuda.synchronize()
    assert torch.isnan(out[0]).all() and torch.isnan(ref[0]).all()
    assert torch.isfinite(out[1:]).all()


@pytest.mark.cuda
@pytest.mark.parametrize("batch,seq,h", [(1, 64, 384), (8, 192, 768), (64, 256, 768), (256, 192, 384)])
def test_pool_is_bitwise_deterministic(dev, batch, seq, h):
    # A fixed summation order and no atomics, the cluster form included.
    hidden, mask = _pool_input(batch, seq, h, dev, seed=23)
    first = masked_mean_pool_l2norm(hidden, mask)
    second = masked_mean_pool_l2norm(hidden, mask)
    torch.cuda.synchronize()
    assert torch.equal(first.view(torch.int32), second.view(torch.int32))


@pytest.mark.cuda
def test_pool_refuses_what_it_does_not_take(dev):
    hidden, mask = _pool_input(2, 16, 384, dev, seed=24)
    with pytest.raises(ValueError):  # f32 has no kernel
        masked_mean_pool_l2norm(hidden.float(), mask)
    with pytest.raises(ValueError):  # a mask of another shape
        masked_mean_pool_l2norm(hidden, mask[:, :8])
    with pytest.raises(ValueError):  # a mask on another device
        masked_mean_pool_l2norm(hidden, mask.cpu())
    with pytest.raises(ValueError):  # not [B, S, H]
        masked_mean_pool_l2norm(hidden[0], mask[0])
    wide = torch.zeros((1, 4, 12296), dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError):  # H > 12288
        masked_mean_pool_l2norm(wide, torch.ones((1, 4), dtype=torch.int32, device=dev))


@pytest.mark.cuda
def test_pool_entry_takes_only_its_forms(dev):
    # Cluster sizes 1, 2, 4, 8; 1-16 warps; 2 or 4 rows in flight;
    # 8-wide loads only where H % 8 == 0; chunks that cover S.
    lib = _build.load("pool_norm", POOL_SIGNATURES)
    hidden, mask = _pool_input(2, 64, 100, dev, seed=25)
    out = torch.empty((2, 100), device=dev)

    def call(vec=1, cluster=2, warps=4, rows=4, chunk=32):
        return lib.pool_l2norm(
            _build.ptr(hidden), _build.ptr(mask), _build.ptr(out), 2, 64, 100, vec, cluster,
            warps, rows, chunk, _build.stream_of(hidden),
        )

    assert call() == 0
    for bad in (dict(vec=8), dict(vec=2), dict(cluster=3), dict(cluster=16), dict(warps=0),
                dict(warps=17), dict(rows=3), dict(rows=8), dict(chunk=31)):
        assert call(**bad) != 0, bad
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_pool_counts_its_launches_forward_only(dev):
    # The backward is the plain version's vjp: no launch.
    hidden, mask = _pool_input(3, 32, 384, dev, seed=26)
    hidden.requires_grad_(True)
    before = masked_mean_pool_l2norm.launches
    out = masked_mean_pool_l2norm(hidden, mask)
    assert masked_mean_pool_l2norm.launches == before + 1
    out.sum().backward()
    assert masked_mean_pool_l2norm.launches == before + 1
    assert hidden.grad is not None and torch.isfinite(hidden.grad.float()).all()


@pytest.mark.cuda
@pytest.mark.parametrize("batch,k,masked", [(1, 16, False), (20, 256, True), (70, 100, False)])
def test_topk_matches_plain_with_ties(dev, batch, k, masked):
    # Small-integer grid values: every dot product is exact in f32, so any
    # summation order gives the same scores, and ties are exact.
    g = torch.Generator().manual_seed(4)
    c = torch.randint(-8, 9, (3000, H), generator=g).float() / 16
    c[1500:1520] = c[7]  # exact ties across blocks
    q = torch.randint(-8, 9, (batch, H), generator=g).float() / 16
    mask = (torch.rand(3000, generator=g) < 0.5).int() if masked else None
    c, q = c.to(dev), q.to(dev)
    mask = None if mask is None else mask.to(dev)
    s, i = cosine_topk(q, c, k, n_valid=2990, candidate_mask=mask)
    s_ref, i_ref = cosine_topk_reference(q, c, k, n_valid=2990, candidate_mask=mask)
    assert torch.equal(i, i_ref)
    assert torch.equal(s, s_ref)


def _f64_ranking(q, c, k, n_valid=None, mask=None):
    """A ranking independent of the port: float64 scores on the host, rows
    at and past ``n_valid`` or outside ``mask`` at -inf, a stable
    descending sort (ties to the lowest index)."""
    s = q.double().cpu().numpy() @ c.double().cpu().numpy().T
    if n_valid is not None:
        s[:, n_valid:] = -np.inf
    if mask is not None:
        s[:, mask.cpu().numpy() == 0] = -np.inf
    order = np.argsort(-s, axis=1, kind="stable")[:, :k]
    return np.take_along_axis(s, order, axis=1), order


@pytest.mark.cuda
def test_topk_dense_route_above_block(dev):
    # k > 256 takes the dense route (scores + stable sort), chosen by k
    # alone. That route is the plain version by design, so it is held
    # against a float64 ranking on the host: grid values make every score
    # exact in f32 and f64, so ids and scores must be identical, ties to
    # the lowest index.
    g = torch.Generator().manual_seed(6)
    c = torch.randint(-8, 9, (3000, H), generator=g).float() / 16
    c[1500:1520] = c[7]
    q = torch.randint(-8, 9, (5, H), generator=g).float() / 16
    q[0] = c[7]
    mask = (torch.rand(3000, generator=g) < 0.5).int()
    mask[[7, 1500, 1519]] = 1
    c, q, mask = c.to(dev), q.to(dev), mask.to(dev)
    for cand in (None, mask):
        launches, dense = cosine_topk.launches, cosine_topk.dense_calls
        s, i = cosine_topk(q, c, 300, n_valid=2990, candidate_mask=cand)
        assert cosine_topk.dense_calls == dense + 1 and cosine_topk.launches == launches
        s_ref, i_ref = _f64_ranking(q, c, 300, n_valid=2990, mask=cand)
        assert np.array_equal(i.cpu().numpy(), i_ref)
        assert np.array_equal(s.double().cpu().numpy(), s_ref)
        if cand is None:  # row 0's best score is a 21-way tie
            assert i[0, :21].tolist() == [7] + list(range(1500, 1520))
    launches = cosine_topk.launches
    cosine_topk(q, c, 256)  # the block size itself still launches K3
    assert cosine_topk.launches == launches + 1


def _grid(g, rows, d=H):
    """k / 16 with |k| <= 8: exact in TF32 and f32, so the split-TF32
    scores are exact and ties are exact."""
    return torch.randint(-8, 9, (rows, d), generator=g).float() / 16


def _unit(g, rows, d):
    x = torch.randn((rows, d), generator=g)
    return x / x.norm(dim=1, keepdim=True)


def _topk_both(q, c, k, packed, **kw):
    plain = cosine_topk_packed_reference if packed else cosine_topk_reference
    return cosine_topk(q, c, k, packed=packed, **kw), plain(q, c, k, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [384, 768])
@pytest.mark.parametrize("batch,masked", [(1, False), (256, True)])
def test_topk_random_unit_rows_against_float64(dev, d, batch, masked):
    # Split TF32 on tensor cores: each score within 1e-5 of float64, and an
    # id differs from the float64 ranking's only where the two rows' float64
    # scores lie within 2e-5.
    g = torch.Generator().manual_seed(20 + d)
    c, q = _unit(g, 20_000, d), _unit(g, batch, d)
    mask = (torch.rand(20_000, generator=g) < 0.7).int() if masked else None
    c, q = c.to(dev), q.to(dev)
    mask = None if mask is None else mask.to(dev)
    s, i = cosine_topk(q, c, 16, n_valid=19_990, candidate_mask=mask)
    s_ref, i_ref = _f64_ranking(q, c, 16, n_valid=19_990, mask=mask)
    assert np.abs(s.double().cpu().numpy() - s_ref).max() <= 1e-5
    f64 = q.double().cpu().numpy() @ c.double().cpu().numpy().T
    i, rows = i.cpu().numpy(), np.arange(batch)[:, None]
    swapped = i != i_ref
    assert swapped.mean() <= 0.01
    assert (np.abs(f64[rows, i] - f64[rows, i_ref])[swapped] <= 2e-5).all()


@pytest.mark.cuda
@pytest.mark.parametrize("d", [384, 768])
def test_topk_scores_near_one_against_float64(dev, d):
    # Unit rows clustered around one direction, as an untrained tower's
    # embeddings are: scores near 0.97, where the tensor cores' truncating
    # accumulation drifts furthest (4-9e-6 when one accumulator takes every
    # product). Each 32 columns sum into a fresh partial: within 1e-6.
    g = torch.Generator().manual_seed(25 + d)
    base = torch.randn((1, d), generator=g)
    c = base + 0.2 * torch.randn((20_000, d), generator=g)
    q = base + 0.2 * torch.randn((64, d), generator=g)
    c, q = (x / x.norm(dim=1, keepdim=True) for x in (c, q))
    c, q = c.to(dev), q.to(dev)
    s, i = cosine_topk(q, c, 16)
    f64 = q.double().cpu().numpy() @ c.double().cpu().numpy().T
    assert np.median(f64.max(axis=1)) > 0.95
    got = np.take_along_axis(f64, i.long().cpu().numpy(), axis=1)
    assert np.abs(s.double().cpu().numpy() - got).max() <= 1e-6
    s_ref, i_ref = _f64_ranking(q, c, 16)
    swapped = i.cpu().numpy() != i_ref
    assert (np.abs(got - s_ref)[swapped] <= 2e-5).all()


@pytest.mark.cuda
@pytest.mark.parametrize("packed", [False, True])
def test_topk_ties_across_slices_and_4096_rows(dev, packed):
    # Ties inside a slice, at every slice boundary the plan gives this
    # batch, and across 4096-row boundaries (the TPU kernel's packed key
    # held 12 column bits): identical to the plain version, ties to the
    # lowest index.
    n, batch, k = 20_000, 20, 64
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rows, n_slices = slice_plan(batch, n, k, sms)
    assert n_slices > 1
    g = torch.Generator().manual_seed(21)
    c, q = _grid(g, n), _grid(g, batch)
    tied = sorted({7, 8, 4095, 4096, 8191, 8192, 12287, 12288, n - 1}
                  | {r for b in range(rows, n, rows) for r in (b - 1, b)})
    c[tied] = c[7].clone()
    q[0] = c[7]
    c, q = c.to(dev), q.to(dev)
    (s, i), (s_ref, i_ref) = _topk_both(q, c, k, packed)
    assert torch.equal(i, i_ref) and torch.equal(s, s_ref)
    assert i[0, : min(k, len(tied))].tolist() == tied[:k]


@pytest.mark.cuda
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("batch", [1, 70])
def test_topk_fewer_eligible_rows_than_k(dev, batch, packed):
    g = torch.Generator().manual_seed(22)
    c, q = _grid(g, 3000).to(dev), _grid(g, batch).to(dev)
    mask = torch.zeros(3000, dtype=torch.int32, device=dev)
    mask[[3, 77, 150, 299]] = 1
    (s, i), (s_ref, i_ref) = _topk_both(q, c, 9, packed, candidate_mask=mask)
    assert torch.equal(i, i_ref) and torch.equal(s, s_ref)
    # The masked rows fill the tail in index order, at the -1e30 sentinel
    # (K4: the score its quantized key stands for).
    assert i[:, 4:].tolist() == [[0, 1, 2, 4, 5]] * batch
    sentinel = torch.tensor([-1e30], device=dev)
    if packed:
        sentinel = quantized_scores(quantized_keys(sentinel))
    assert (s[:, 4:] == sentinel).all()


@pytest.mark.cuda
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("batch", [1, 9, 70])
@pytest.mark.parametrize("k", [1, 10, 16, 32, 33, 64, 65, 100, 128, 129, 256])
def test_topk_every_form_of_k(dev, k, batch, packed):
    # Every (query tile, list size) form the k rule picks, on grid values
    # with ties: identical to the plain version.
    g = torch.Generator().manual_seed(23)
    c, q = _grid(g, 5000), _grid(g, batch)
    c[2500:2520] = c[11].clone()
    q[0] = c[11]
    mask = (torch.rand(5000, generator=g) < 0.6).int()
    mask[[11, 2500, 2519]] = 1
    c, q, mask = c.to(dev), q.to(dev), mask.to(dev)
    (s, i), (s_ref, i_ref) = _topk_both(q, c, k, packed, n_valid=4990, candidate_mask=mask)
    assert torch.equal(i, i_ref) and torch.equal(s, s_ref)


@pytest.mark.cuda
def test_topk_kernel_takes_only_the_forms_the_k_rule_picks(dev):
    # The rule: 8 queries a block for B <= 8, else 64, or 32 for k > 128,
    # with lists of k rounded up to 32, 64, 128 or 256 keys. The entry
    # point launches exactly those forms and refuses any other tile.
    assert [query_tile(b, k) for b, k in [(8, 256), (9, 128), (9, 129)]] == [8, 64, 32]
    lib = _build.load("topk", TOPK_SIGNATURES)
    q, c = torch.zeros((70, 32), device=dev), torch.zeros((300, 32), device=dev)
    cand = torch.empty((70, 3 * 256), dtype=torch.int64, device=dev)
    out_s = torch.empty((70, 256), device=dev)
    out_i = torch.empty((70, 256), dtype=torch.int32, device=dev)
    for k in (16, 100, 200):
        for tile in (8, 16, 32, 64, 128):
            err = lib.topk_slices(
                _build.ptr(q), _build.ptr(c), None, _build.ptr(cand), _build.ptr(out_s),
                _build.ptr(out_i), 70, 300, 32, 300, k, 0, tile, 128, 3, _build.stream_of(q),
            )
            assert (err == 0) == (tile == 8 or tile == query_tile(70, k)), (k, tile, err)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("d", [16, 48, 400])
def test_topk_widths_and_an_unaligned_catalog(dev, d):
    # D % 32 != 0 leaves a zero-filled half stage; a catalog view that does
    # not start on 16 bytes is copied to one that does.
    g = torch.Generator().manual_seed(24)
    c, q = _grid(g, 3000, d), _grid(g, 5, d)
    base = torch.zeros(3000 * d + 1, device=dev)
    base[1:] = c.flatten().to(dev)
    c_view = base[1:].view(3000, d)
    assert c_view.data_ptr() % 16 != 0
    for packed in (False, True):
        (s, i), (s_ref, i_ref) = _topk_both(q.to(dev), c_view, 16, packed)
        assert torch.equal(i, i_ref) and torch.equal(s, s_ref)


def _dropout(batch, seq, dev, seed=5, h=H):
    g = torch.Generator(device=dev).manual_seed(seed)
    return draw_dropout_masks((batch, seq, h), 0.1, g, dev, torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("head_dim", HEAD_DIMS)
@pytest.mark.parametrize("batch,seq", [(2, 48), (3, 256)])
def test_train_form_matches_plain(dev, batch, seq, head_dim):
    layer = _layer(dev)
    kw = _kw(head_dim)
    g = torch.Generator().manual_seed(7)
    x = torch.randn((batch, seq, H), generator=g).to(dev, torch.bfloat16)
    mask = _mask(batch, seq, dev)
    masks = _dropout(batch, seq, dev)
    keep = ((masks[0] != 0).float().mean().item(), (masks[1] != 0).float().mean().item())
    assert all(0.85 < k < 0.95 for k in keep)  # rate 0.1
    before = fused_encoder_layer_train.launches
    y = fused_encoder_layer_train(x, mask, layer, masks=masks, dropout_rate=0.1, **kw)
    assert fused_encoder_layer_train.launches == before + 1
    y_ref = fused_encoder_layer_train_reference(x, mask, layer, masks=masks, **kw)
    torch.cuda.synchronize()
    assert torch.isfinite(y.float()).all()
    # Two bf16 ulps at |y| < 8, as for the inference form.
    assert (y.float() - y_ref.float()).abs().max().item() <= 0.0625


# Relative to each gradient's largest magnitude: bf16 operands round at
# other points than in the plain version's autograd (dU, P, dL, dhpre, df
# and dao enter the kernel's products as bf16), and the f32 sums over B*S
# rows run in another order.
GRAD_REL_TOL = 2e-2


@pytest.mark.cuda
@pytest.mark.parametrize("head_dim", HEAD_DIMS)
@pytest.mark.parametrize("batch,seq,dropout", [(2, 48, True), (4, 256, False)])
def test_backward_matches_plain(dev, batch, seq, dropout, head_dim):
    layer = _layer(dev)
    kw = _kw(head_dim)
    g = torch.Generator().manual_seed(8)
    x = torch.randn((batch, seq, H), generator=g).to(dev, torch.bfloat16)
    up = torch.randn((batch, seq, H), generator=g).to(dev, torch.bfloat16)
    mask = _mask(batch, seq, dev)
    bias = ((1.0 - mask.float()) * -1e9).contiguous()
    masks = _dropout(batch, seq, dev) if dropout else None
    before = fused_encoder_layer_backward.launches
    dx, dw = fused_encoder_layer_backward(x, bias, up, masks, layer, **kw)
    assert fused_encoder_layer_backward.launches == before + 1
    dx_ref, dw_ref = fused_encoder_layer_backward_reference(x, bias, up, masks, layer, **kw)
    torch.cuda.synchronize()
    pairs = [("dx", dx, dx_ref)] + [(n, dw[n], dw_ref[n]) for n in WEIGHT_NAMES]
    for name, a, b in pairs:
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert torch.isfinite(a.float()).all(), name
        rel = (a.float() - b.float()).abs().max() / b.float().abs().max()
        assert rel.item() <= GRAD_REL_TOL, (name, rel.item())


# Shapes where the tensor-core tiles of K1 and K5 meet their edges: hidden
# 320 (10 heads of 32, 5 of 64; the products' N = 960 and 320 are not
# multiples of the 128-column tile), hidden 1024, an intermediate size of
# 64 x 23, S from one to four 64-key tiles with ragged last tiles (48,
# 240), and B * S rows that are not a multiple of the 128-row tile (144,
# 240, 720); and mpnet-base-class's widths (N = 2304, 768 and 3072) at a
# ragged S. Every batch holds an all-pad row.
FRAGILE = [
    (320, 1280, 3, 48), (320, 1472, 3, 240), (1024, 4096, 2, 16), (1024, 1472, 3, 256),
    (384, 1472, 5, 48), (384, 1536, 3, 240), (768, 3072, 3, 240),
]


def _fragile_case(dev, hidden, inter, batch, seq, seed, head_dim):
    layer = _layer(dev, seed, h=hidden, inter=inter)
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((batch, seq, hidden), generator=g).to(dev, torch.bfloat16)
    return layer, x, _mask(batch, seq, dev), _kw(head_dim, hidden)


@pytest.mark.cuda
@pytest.mark.parametrize("head_dim", HEAD_DIMS)
@pytest.mark.parametrize("hidden,inter,batch,seq", FRAGILE)
def test_fused_layer_forms_match_plain_at_tile_edges(dev, hidden, inter, batch, seq, head_dim):
    layer, x, mask, kw = _fragile_case(dev, hidden, inter, batch, seq, 20, head_dim)
    masks = _dropout(batch, seq, dev, h=hidden)
    y = fused_encoder_layer(x, mask, layer, **kw)
    y_ref = fused_encoder_layer_reference(x, mask, layer, **kw)
    yt = fused_encoder_layer_train(x, mask, layer, masks=masks, dropout_rate=0.1, **kw)
    yt_ref = fused_encoder_layer_train_reference(x, mask, layer, masks=masks, **kw)
    torch.cuda.synchronize()
    for name, a, b in (("K1", y, y_ref), ("K1-train", yt, yt_ref)):
        assert torch.isfinite(a.float()).all(), name
        # Two bf16 ulps at |y| < 8, as at the MiniLM width.
        assert (a.float() - b.float()).abs().max().item() <= 0.0625, name


@pytest.mark.cuda
@pytest.mark.parametrize("head_dim", HEAD_DIMS)
@pytest.mark.parametrize("hidden,inter,batch,seq", FRAGILE)
def test_backward_matches_plain_at_tile_edges(dev, hidden, inter, batch, seq, head_dim):
    layer, x, mask, kw = _fragile_case(dev, hidden, inter, batch, seq, 21, head_dim)
    up = torch.randn(x.shape, generator=torch.Generator().manual_seed(22)).to(dev, torch.bfloat16)
    bias = ((1.0 - mask.float()) * -1e9).contiguous()
    masks = _dropout(batch, seq, dev, h=hidden)
    dx, dw = fused_encoder_layer_backward(x, bias, up, masks, layer, **kw)
    dx_ref, dw_ref = fused_encoder_layer_backward_reference(x, bias, up, masks, layer, **kw)
    torch.cuda.synchronize()
    for name, a, b in [("dx", dx, dx_ref)] + [(n, dw[n], dw_ref[n]) for n in WEIGHT_NAMES]:
        assert torch.isfinite(a.float()).all(), name
        rel = (a.float() - b.float()).abs().max() / b.float().abs().max()
        assert rel.item() <= GRAD_REL_TOL, (name, rel.item())


@pytest.mark.cuda
@pytest.mark.parametrize("head_dim", HEAD_DIMS)
def test_backward_is_deterministic(dev, head_dim):
    # Every sum in a fixed order and no atomics: the same inputs give the
    # same bits in dx and in all twelve weight gradients, at the MiniLM
    # training shape.
    layer = _layer(dev)
    kw = _kw(head_dim)
    g = torch.Generator().manual_seed(23)
    x, up = (torch.randn((64, 256, H), generator=g).to(dev, torch.bfloat16) for _ in range(2))
    mask = _mask(64, 256, dev)
    bias = ((1.0 - mask.float()) * -1e9).contiguous()
    masks = _dropout(64, 256, dev)
    first = fused_encoder_layer_backward(x, bias, up, masks, layer, **kw)
    second = fused_encoder_layer_backward(x, bias, up, masks, layer, **kw)
    torch.cuda.synchronize()
    assert torch.equal(first[0].view(torch.int16), second[0].view(torch.int16))
    for name in WEIGHT_NAMES:
        assert torch.equal(first[1][name].view(torch.int32), second[1][name].view(torch.int32)), name


@pytest.mark.cuda
def test_train_layer_gradients_reach_the_f32_params(dev):
    # Through prepare_layer's casts: the autograd backward launches K5.
    g = torch.Generator().manual_seed(9)
    raw = {
        n: (0.05 * torch.randn(s, generator=g)).to(dev).requires_grad_(True)
        for n, s in {"q_w": (H, H), "k_w": (H, H), "v_w": (H, H), "o_w": (H, H),
                     "q_b": (H,), "k_b": (H,), "v_b": (H,), "o_b": (H,),
                     "attn_ln_scale": (H,), "attn_ln_bias": (H,), "ffn_w1": (H, INTER),
                     "ffn_b1": (INTER,), "ffn_w2": (INTER, H), "ffn_b2": (H,),
                     "ffn_ln_scale": (H,), "ffn_ln_bias": (H,)}.items()
    }
    x = torch.randn((2, 32, H), generator=g).to(dev, torch.bfloat16).requires_grad_(True)
    mask = _mask(2, 32, dev)
    before = fused_encoder_layer_backward.launches
    y = fused_encoder_layer_train(
        x, mask, raw, generator=torch.Generator(device=dev).manual_seed(1), dropout_rate=0.1, **KW
    )
    y.float().square().sum().backward()
    assert fused_encoder_layer_backward.launches == before + 1
    assert x.grad is not None and x.grad.dtype == torch.bfloat16
    for name, t in raw.items():
        assert t.grad is not None and t.grad.dtype == torch.float32, name
        assert torch.isfinite(t.grad).all(), name


@pytest.mark.cuda
def test_backward_rejects_what_it_does_not_take(dev):
    layer = _layer(dev)

    def call(batch, seq, dtype=torch.bfloat16, **kw):
        x = torch.zeros((batch, seq, H), device=dev, dtype=dtype)
        bias = torch.zeros((batch, seq), device=dev)
        fused_encoder_layer_backward(x, bias, x.clone(), None, layer, **{**KW, **kw})

    with pytest.raises(ValueError):  # f32 has no kernel
        call(2, 32, torch.float32)
    with pytest.raises(ValueError):  # S > 256
        call(1, 272)
    for head_dim in (16, 128):  # JAX's gate admits them; the port's kernels do not
        with pytest.raises(ValueError):
            call(2, 32, **_kw(head_dim))
    x = torch.zeros((2, 32, H), device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError):  # a mask of another shape
        fused_encoder_layer_backward(
            x, torch.zeros((2, 32), device=dev), x, (x[:1], x[:1]), layer, **KW
        )


# Attention: relative to each output's largest magnitude. Both kernels sum
# their tensor-core products in another order than the plain version, so a
# bf16 rounding of the forward's P or of any output may flip: one bf16 ulp
# is at most 2^-7 of the largest magnitude. The backward's bf16 operands
# (q, k, v, dO) are the plain version's values; P and dS enter its products
# as two bf16 terms each (about 2^-17 relative), and every gradient is
# rounded to bf16 once.
ATTN_REL_TOL = 1e-2


def _rel(a, b):
    return ((a.float() - b.float()).abs().max() / b.float().abs().max()).item()


@pytest.mark.cuda
@pytest.mark.parametrize("dim", [16, 32, 64, 128])
# 200, 255, 256 and 257 sit on both sides of the forward's one-pass limit
# (S <= 256 at D <= 64) and on ragged tile edges.
@pytest.mark.parametrize("seq", [16, 40, 192, 200, 255, 256, 257, 512])
@pytest.mark.parametrize("batch", [1, 64, 256])
def test_attention_forward_and_backward_match_plain(dev, batch, seq, dim):
    heads = 2
    g = torch.Generator().manual_seed(batch + seq + dim)
    q, k, v, do = (
        torch.randn((batch, heads, seq, dim), generator=g).to(dev, torch.bfloat16) for _ in range(4)
    )
    mask = _mask(batch, seq, dev)  # an all-pad row when batch > 1
    scale = dim**-0.5
    before = multi_head_attention.launches
    out = multi_head_attention(q, k, v, mask, scale)
    assert multi_head_attention.launches == before + 1
    ref = multi_head_attention_reference(q, k, v, mask, scale)
    before = multi_head_attention_backward.launches
    grads = multi_head_attention_backward(q, k, v, mask, do, scale)
    assert multi_head_attention_backward.launches == before + 1
    refs = multi_head_attention_backward_reference(q, k, v, mask, do, scale)
    torch.cuda.synchronize()
    for name, a, b in [("out", out, ref), *zip(("dq", "dk", "dv"), grads, refs)]:
        assert a.dtype == torch.bfloat16 and a.shape == b.shape, name
        assert torch.isfinite(a.float()).all(), name
        assert _rel(a, b) <= ATTN_REL_TOL, (name, _rel(a, b))


@pytest.mark.cuda
def test_attention_backward_is_deterministic(dev):
    # No atomics and a fixed summation order: the same inputs give the same
    # bits in every gradient, at the mpnet training shape.
    g = torch.Generator().manual_seed(15)
    b, heads, s, d = 64, 12, 256, 64
    q, k, v, do = (
        torch.randn((b, heads, s, d), generator=g).to(dev, torch.bfloat16) for _ in range(4)
    )
    mask = _mask(b, s, dev)
    first = multi_head_attention_backward(q, k, v, mask, do, d**-0.5)
    second = multi_head_attention_backward(q, k, v, mask, do, d**-0.5)
    torch.cuda.synchronize()
    for name, a, b2 in zip(("dq", "dk", "dv"), first, second):
        assert torch.equal(a.view(torch.int16), b2.view(torch.int16)), name


def _attention_grads_f32(q, k, v, mask, do, scale, round_p_ds):
    """The backward in f32 on the card, with P and dS rounded to one bf16
    each before their products if ``round_p_ds``."""
    q, k, v, do = (t.float() for t in (q, k, v, do))
    bias = (1.0 - mask.float()) * -1e9
    p = torch.softmax(q @ k.transpose(-1, -2) * scale + bias[:, None, None, :], dim=-1)
    dp = do @ v.transpose(-1, -2)
    ds = p * (dp - (p * dp).sum(dim=-1, keepdim=True))
    if round_p_ds:
        p, ds = (t.to(torch.bfloat16).float() for t in (p, ds))
    dq = ds @ k * scale
    dk = ds.transpose(-1, -2) @ q * scale
    return dq, dk, p.transpose(-1, -2) @ do


@pytest.mark.cuda
def test_attention_backward_splits_p_and_ds(dev):
    # P and dS enter the kernel's products as hi + lo bf16 pairs, so its
    # bf16 gradients are the f32 gradients rounded once: at the mpnet
    # training shape a few elements in a thousand differ, where one bf16
    # rounding of P and dS moves a fifth to two fifths of them. A kernel
    # that dropped the lo terms would miss as often as that rounding does.
    g = torch.Generator().manual_seed(16)
    b, heads, s, d = 64, 12, 256, 64
    q, k, v, do = (
        torch.randn((b, heads, s, d), generator=g).to(dev, torch.bfloat16) for _ in range(4)
    )
    mask = _mask(b, s, dev)
    grads = multi_head_attention_backward(q, k, v, mask, do, d**-0.5)
    exact = _attention_grads_f32(q, k, v, mask, do, d**-0.5, round_p_ds=False)
    single = _attention_grads_f32(q, k, v, mask, do, d**-0.5, round_p_ds=True)
    torch.cuda.synchronize()
    for name, a, e, one in zip(("dq", "dk", "dv"), grads, exact, single):
        want = e.to(torch.bfloat16)
        missed = (a != want).float().mean().item()
        missed_single = (one.to(torch.bfloat16) != want).float().mean().item()
        assert missed_single > 0.1, (name, missed_single)
        assert missed < missed_single / 4, (name, missed, missed_single)


@pytest.mark.cuda
def test_attention_takes_strided_views_and_runs_the_autograd_backward(dev):
    # q, k, v as the unfused layer makes them: views of one [B, S, 3, heads, D].
    g = torch.Generator().manual_seed(12)
    b, s, heads, d = 3, 72, 12, 64
    qkv = torch.randn((b, s, 3, heads, d), generator=g).to(dev, torch.bfloat16)
    q, k, v = (t.permute(0, 2, 1, 3).requires_grad_(True) for t in qkv.unbind(2))
    mask = _mask(b, s, dev)
    before = multi_head_attention_backward.launches
    out = multi_head_attention(q, k, v, mask, d**-0.5)
    up = torch.randn(out.shape, generator=g).to(dev, torch.bfloat16)
    out.backward(up)
    assert multi_head_attention_backward.launches == before + 1
    dense = [t.detach().contiguous() for t in (q, k, v)]
    assert _rel(out, multi_head_attention_reference(*dense, mask, d**-0.5)) <= ATTN_REL_TOL
    refs = multi_head_attention_backward_reference(*dense, mask, up, d**-0.5)
    for t, r in zip((q, k, v), refs):
        assert _rel(t.grad, r) <= ATTN_REL_TOL


@pytest.mark.cuda
def test_attention_rejects_what_it_does_not_take(dev):
    x = torch.zeros((2, 4, 32, 64), device=dev, dtype=torch.bfloat16)
    mask = torch.ones((2, 32), device=dev, dtype=torch.int32)
    with pytest.raises(ValueError):  # f32 has no kernel
        multi_head_attention(x.float(), x.float(), x.float(), mask, 0.125)
    y = torch.zeros((2, 4, 32, 48), device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError):  # head_dim 48
        multi_head_attention(y, y, y, mask, 0.125)
    with pytest.raises(ValueError):  # a mask of another shape
        multi_head_attention(x, x, x, mask[:, :16], 0.125)
    with pytest.raises(ValueError):  # the head dim not contiguous
        t = x.transpose(2, 3)
        multi_head_attention(t, t, t, torch.ones((2, 64), device=dev), 0.125)


@pytest.mark.cuda
@pytest.mark.parametrize("batch,k,masked", [(1, 16, False), (20, 256, True), (70, 100, False)])
def test_packed_topk_identical_to_plain_on_grid_values(dev, batch, k, masked):
    g = torch.Generator().manual_seed(13)
    c = torch.randint(-8, 9, (3000, H), generator=g).float() / 16
    c[1500:1520] = c[7]  # exact ties across blocks
    c[8] = c[7]          # and within one
    q = torch.randint(-8, 9, (batch, H), generator=g).float() / 16
    q[0] = c[7]
    mask = (torch.rand(3000, generator=g) < 0.5).int() if masked else None
    c, q = c.to(dev), q.to(dev)
    mask = None if mask is None else mask.to(dev)
    before = cosine_topk.packed_launches, cosine_topk.launches
    s, i = cosine_topk(q, c, k, n_valid=2990, candidate_mask=mask, packed=True)
    assert (cosine_topk.packed_launches, cosine_topk.launches) == (before[0] + 1, before[1])
    s_ref, i_ref = cosine_topk_packed_reference(q, c, k, n_valid=2990, candidate_mask=mask)
    assert torch.equal(i, i_ref)
    assert torch.equal(s, s_ref)


@pytest.mark.cuda
def test_packed_topk_above_block_takes_the_exact_dense_route(dev):
    # Exact, not quantized: grid values, so the f32 scores equal a float64
    # host ranking's.
    g = torch.Generator().manual_seed(14)
    c = (torch.randint(-8, 9, (3000, H), generator=g).float() / 16).to(dev)
    q = (torch.randint(-8, 9, (5, H), generator=g).float() / 16).to(dev)
    launches, dense = cosine_topk.packed_launches, cosine_topk.dense_calls
    s, i = cosine_topk(q, c, 300, packed=True)
    assert cosine_topk.dense_calls == dense + 1 and cosine_topk.packed_launches == launches
    s_ref, i_ref = _f64_ranking(q, c, 300)
    assert np.array_equal(i.cpu().numpy(), i_ref)
    assert np.array_equal(s.double().cpu().numpy(), s_ref)
