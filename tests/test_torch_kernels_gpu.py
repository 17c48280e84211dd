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
    masked_mean_pool_l2norm_reference,
)
from instacart_next_order_recommendation_tpu_torch.ops.topk import cosine_topk_reference

H, INTER, HEADS = 384, 1536, 12
KW = dict(num_heads=HEADS, scale=1 / 32**0.5, eps=1e-12)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _layer(dev, seed=0):
    g = torch.Generator().manual_seed(seed)
    raw = {
        name: 0.05 * torch.randn(shape, generator=g)
        for name, shape in {
            "q_w": (H, H), "k_w": (H, H), "v_w": (H, H), "o_w": (H, H),
            "q_b": (H,), "k_b": (H,), "v_b": (H,), "o_b": (H,),
            "attn_ln_bias": (H,), "ffn_ln_bias": (H,),
            "ffn_w1": (H, INTER), "ffn_b1": (INTER,), "ffn_w2": (INTER, H), "ffn_b2": (H,),
        }.items()
    }
    raw["attn_ln_scale"] = 1 + 0.1 * torch.randn(H, generator=g)
    raw["ffn_ln_scale"] = 1 + 0.1 * torch.randn(H, generator=g)
    return prepare_layer({k: v.to(dev) for k, v in raw.items()}, torch.bfloat16)


def _mask(batch, seq, dev, seed=1):
    rng = np.random.default_rng(seed)
    lengths = rng.integers(1, seq + 1, size=batch)
    lengths[-1] = 0 if batch > 1 else seq  # one all-pad row
    return torch.from_numpy((np.arange(seq)[None] < lengths[:, None]).astype(np.int32)).to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("batch,seq", [(1, 16), (3, 48), (8, 256)])
def test_fused_layer_matches_plain(dev, batch, seq):
    layer = _layer(dev)
    g = torch.Generator().manual_seed(2)
    x = torch.randn((batch, seq, H), generator=g).to(dev, torch.bfloat16)
    mask = _mask(batch, seq, dev)
    before = fused_encoder_layer.launches
    y = fused_encoder_layer(x, mask, layer, **KW)
    assert fused_encoder_layer.launches == before + 1
    y_ref = fused_encoder_layer_reference(x, mask, layer, **KW)
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


@pytest.mark.cuda
def test_topk_dense_route_above_block(dev):
    # k > 256 takes the dense route (scores + stable sort), chosen by k
    # alone; grid values make every score exact, so ids and scores must be
    # identical to the plain version, ties to the lowest index.
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
        s_ref, i_ref = cosine_topk_reference(q, c, 300, n_valid=2990, candidate_mask=cand)
        assert torch.equal(i, i_ref) and torch.equal(s, s_ref)
        if cand is None:  # row 0's best score is a 21-way tie
            assert i[0, :21].tolist() == [7] + list(range(1500, 1520))
    launches = cosine_topk.launches
    cosine_topk(q, c, 256)  # the block size itself still launches K3
    assert cosine_topk.launches == launches + 1


def _dropout(batch, seq, dev, seed=5):
    g = torch.Generator(device=dev).manual_seed(seed)
    return draw_dropout_masks((batch, seq, H), 0.1, g, dev, torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("batch,seq", [(2, 48), (3, 256)])
def test_train_form_matches_plain(dev, batch, seq):
    layer = _layer(dev)
    g = torch.Generator().manual_seed(7)
    x = torch.randn((batch, seq, H), generator=g).to(dev, torch.bfloat16)
    mask = _mask(batch, seq, dev)
    masks = _dropout(batch, seq, dev)
    keep = ((masks[0] != 0).float().mean().item(), (masks[1] != 0).float().mean().item())
    assert all(0.85 < k < 0.95 for k in keep)  # rate 0.1
    before = fused_encoder_layer_train.launches
    y = fused_encoder_layer_train(x, mask, layer, masks=masks, dropout_rate=0.1, **KW)
    assert fused_encoder_layer_train.launches == before + 1
    y_ref = fused_encoder_layer_train_reference(x, mask, layer, masks=masks, **KW)
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
@pytest.mark.parametrize("batch,seq,dropout", [(2, 48, True), (4, 256, False)])
def test_backward_matches_plain(dev, batch, seq, dropout):
    layer = _layer(dev)
    g = torch.Generator().manual_seed(8)
    x = torch.randn((batch, seq, H), generator=g).to(dev, torch.bfloat16)
    up = torch.randn((batch, seq, H), generator=g).to(dev, torch.bfloat16)
    mask = _mask(batch, seq, dev)
    bias = ((1.0 - mask.float()) * -1e9).contiguous()
    masks = _dropout(batch, seq, dev) if dropout else None
    before = fused_encoder_layer_backward.launches
    dx, dw = fused_encoder_layer_backward(x, bias, up, masks, layer, **KW)
    assert fused_encoder_layer_backward.launches == before + 1
    dx_ref, dw_ref = fused_encoder_layer_backward_reference(x, bias, up, masks, layer, **KW)
    torch.cuda.synchronize()
    pairs = [("dx", dx, dx_ref)] + [(n, dw[n], dw_ref[n]) for n in WEIGHT_NAMES]
    for name, a, b in pairs:
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert torch.isfinite(a.float()).all(), name
        rel = (a.float() - b.float()).abs().max() / b.float().abs().max()
        assert rel.item() <= GRAD_REL_TOL, (name, rel.item())


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
    with pytest.raises(ValueError):  # head_dim 64
        call(2, 32, num_heads=6)
    x = torch.zeros((2, 32, H), device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError):  # a mask of another shape
        fused_encoder_layer_backward(
            x, torch.zeros((2, 32), device=dev), x, (x[:1], x[:1]), layer, **KW
        )
