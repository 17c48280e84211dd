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
    masked_mean_pool_l2norm,
)
from instacart_next_order_recommendation_tpu_torch.ops.fused_layer import (
    fused_encoder_layer_reference,
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
def test_topk_rejects_k_above_block(dev):
    q = torch.zeros((1, H), device=dev)
    c = torch.zeros((1000, H), device=dev)
    with pytest.raises(ValueError):
        cosine_topk(q, c, 257)
