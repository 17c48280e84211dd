"""The ModernBERT layer's CUDA kernels against their plain PyTorch versions.

Every test here needs an NVIDIA GPU and skips without one. This file imports
no JAX, so it also runs where only PyTorch is installed:

    python -m pytest tests/test_torch_modernbert_gpu.py --noconftest -q
"""

import dataclasses

import pytest
import torch

from instacart_next_order_recommendation_tpu_torch.models import modernbert
from instacart_next_order_recommendation_tpu_torch.models.encoder import (
    MODERNBERT_BASE,
    encode,
    init_params,
)
from instacart_next_order_recommendation_tpu_torch.ops import modernbert as mb_ops
from gpu_cases import (
    MB_H as H,
    MB_HEADS as HEADS,
    MB_SERVE_SHAPES as SERVE_SHAPES,
    MB_THETAS as THETAS,
    attention_errors,
    masked_rel,
    modernbert_layers,
    modernbert_serve_mask,
    serve_path_launches,
)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _mask(b, s, dev):
    """Row 0 whole, the others cut short (padded keys and query rows)."""
    lengths = [s] + [max(1, s - 37 * r - 5) for r in range(1, b)]
    mask = torch.zeros(b, s, dtype=torch.int32, device=dev)
    for r, n in enumerate(lengths):
        mask[r, :n] = 1
    return mask


def _close(got, want, mask, tol):
    err = masked_rel(got, want, mask)
    assert err <= tol, err


# The global form's tile edges: S not a multiple of its 128-query and
# 128-key tiles (80, 1040), B=1, and at (1040, 8) rows whose real lengths
# differ by a whole padded key tile (1040 down to 776: keys 896-1023 are
# padding in rows 4-7).
@pytest.mark.cuda
@pytest.mark.parametrize("s,b", [(64, 3), (1024, 2), (8192, 1), (80, 1), (80, 3), (1040, 8)])
@pytest.mark.parametrize("half", [-1, 64])
@pytest.mark.parametrize("theta", THETAS)
def test_attention_against_plain(dev, s, b, half, theta):
    g = torch.Generator(device=dev).manual_seed(s + half)
    qkv = torch.randn(b, s, 3 * H, generator=g, device=dev).to(torch.bfloat16)
    mask = _mask(b, s, dev)
    got = mb_ops.modernbert_attention(qkv, mask, num_heads=HEADS, theta=theta, half=half)
    cos, sin = mb_ops.rope_tables(s, theta, dev)
    want = mb_ops.attention_reference(qkv, mask, cos, sin, num_heads=HEADS, half=half)
    torch.cuda.synchronize()
    # bf16 outputs; P rounded to bf16 tile by tile against a running maximum
    # in the kernel, against the final maximum in the plain version.
    _close(got, want, mask, 2e-2)
    assert mb_ops.modernbert_attention.launches > 0


@pytest.mark.cuda
@pytest.mark.parametrize("b,s", SERVE_SHAPES)
@pytest.mark.parametrize("half", [-1, 64])
def test_attention_at_the_serve_shapes_against_plain(dev, b, s, half):
    """Within 2e-2 of the largest magnitude from the plain version with the
    layer's band and theta, and past it from the plain version with the
    other band and with the other theta."""
    g = torch.Generator(device=dev).manual_seed(23)
    qkv = torch.randn(b, s, 3 * H, generator=g, device=dev).to(torch.bfloat16)
    errs = attention_errors(qkv, modernbert_serve_mask(b, s, dev), half)
    assert errs["max_rel_err"] <= 2e-2 < min(errs["err_other_band"], errs["err_other_theta"]), errs


@pytest.mark.cuda
@pytest.mark.parametrize("s", [80, 1040])
def test_global_call_is_one_launch(dev, s):
    """A global-form call is one launch of ``mb_attn_global_kernel`` (the
    benchmark times the form by that kernel's name), and the wrapper counts
    it once."""
    from torch.profiler import ProfilerActivity, profile

    qkv = torch.randn(2, s, 3 * H, device=dev).to(torch.bfloat16)
    mask = _mask(2, s, dev)
    kw = dict(num_heads=HEADS, theta=THETAS[0], half=-1)
    mb_ops.modernbert_attention(qkv, mask, **kw)  # built and warm
    torch.cuda.synchronize()
    before = mb_ops.modernbert_attention.launches
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        mb_ops.modernbert_attention(qkv, mask, **kw)
        torch.cuda.synchronize()
    assert mb_ops.modernbert_attention.launches == before + 1
    kernels = {e.key: e.count for e in prof.key_averages() if "mb_" in e.key}
    assert sum(n for k, n in kernels.items() if "mb_attn_global_kernel" in k) == 1, kernels


@pytest.mark.cuda
def test_band_is_not_global(dev):
    """The two forms differ where the band cuts (S past the window)."""
    qkv = torch.randn(1, 512, 3 * H, device=dev).to(torch.bfloat16)
    mask = torch.ones(1, 512, dtype=torch.int32, device=dev)
    a = mb_ops.modernbert_attention(qkv, mask, num_heads=HEADS, theta=1e4, half=64)
    b = mb_ops.modernbert_attention(qkv, mask, num_heads=HEADS, theta=1e4, half=-1)
    c = mb_ops.modernbert_attention(qkv, mask, num_heads=HEADS, theta=1.6e5, half=64)
    assert float((a.float() - b.float()).abs().max()) > 0.1
    assert float((a.float() - c.float()).abs().max()) > 0.1


def _layer(dev, first, unit_gain=False):
    """Layer 0 (global) or 1 (banded) of ``modernbert_layers``."""
    return modernbert_layers(dev, 4, unit_gain)[1][0 if first else 1]


@pytest.mark.cuda
@pytest.mark.parametrize("first", [True, False])
@pytest.mark.parametrize("half", [-1, 64])
# (2, 1024) at the published init; the serve cell's shapes at unit gain,
# with its padding.
@pytest.mark.parametrize("b,s", [(2, 1024), *SERVE_SHAPES])
def test_layer_entry_against_plain(dev, first, half, b, s):
    serve = (b, s) in SERVE_SHAPES
    layer = _layer(dev, first, unit_gain=serve)
    x = torch.randn(b, s, H, device=dev)
    mask = (modernbert_serve_mask if serve else _mask)(b, s, dev)
    kw = dict(num_heads=HEADS, eps=1e-5, theta=THETAS[half >= 0], half=half)
    got = mb_ops.modernbert_layer(x, mask, layer, **kw)
    want = mb_ops.layer_reference(x, mask, layer, **kw)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32
    # The residual stream carries x through unchanged: hold the layer's own
    # change, bf16 products of bf16 operands summed in another order.
    _close(got - x, want - x, mask, 2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("b,s", [(3, 200), *SERVE_SHAPES])
def test_final_norm_against_plain(dev, b, s):
    x = torch.randn(b, s, H, device=dev) * 3 + 1
    scale = torch.rand(H, device=dev) + 0.5
    got = mb_ops.modernbert_final_norm(x, scale, eps=1e-5, dtype=torch.bfloat16)
    want = mb_ops._norm(x, scale, 1e-5).to(torch.bfloat16)
    assert float((got.float() - want.float()).abs().max()) <= 2 ** -7 * float(want.abs().max())


@pytest.mark.cuda
def test_encode_on_the_card_against_the_cpu(dev):
    """Three layers at the published widths (0 global, 1 and 2 windowed)
    through ``encode`` on the card, against the port's plain route in f32."""
    cfg = dataclasses.replace(MODERNBERT_BASE, num_layers=3, vocab_size=2000)
    p = init_params(cfg, torch.Generator().manual_seed(9))
    ids = torch.randint(5, 2000, (4, 768), generator=torch.Generator().manual_seed(1))
    mask = _mask(4, 768, "cpu")
    ids = torch.where(mask.bool(), ids, 0)
    with torch.no_grad():
        want = encode(p, ids, mask, dataclasses.replace(cfg, compute_dtype="float32"))
        pd = {g: {n: t.to(dev) for n, t in leaves.items()} for g, leaves in p.items()}
        before = mb_ops.modernbert_layer.launches
        got = encode(pd, ids.to(dev), mask.to(dev), cfg).cpu()
    assert mb_ops.modernbert_layer.launches - before == 3
    cos = (got * want).sum(-1)
    assert float(cos.min()) > 0.999, cos


@pytest.mark.cuda
def test_training_on_the_card_raises(dev):
    """No backward kernel: a forward that would need one raises, naming it."""
    cfg = dataclasses.replace(MODERNBERT_BASE, num_layers=1, vocab_size=100)
    p = {g: {n: t.to(dev) for n, t in leaves.items()}
         for g, leaves in init_params(cfg, torch.Generator().manual_seed(0)).items()}
    ids = torch.ones(2, 32, dtype=torch.long, device=dev)
    mask = torch.ones(2, 32, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="no backward kernel"):
        encode(p, ids, mask, cfg, generator=torch.Generator(device=dev))
    p["layers"]["wi"].requires_grad_(True)
    with pytest.raises(ValueError, match="no backward kernel"):
        encode(p, ids, mask, cfg)
    with torch.no_grad():
        assert encode(p, ids, mask, cfg).shape == (2, H)
    assert modernbert.is_global(cfg, 0)


@pytest.mark.cuda
def test_serve_path_launches(dev):
    """ModernBERT-base's serve path, all 22 layers (``serve_path_launches``):
    ``encode_resident`` over 512 products in batches of 256 runs 44 layer, 2
    final-norm and 2 pool launches; one ``topk_device`` call at each of the
    serve cell's shapes runs 22 layer, 1 final-norm and 1 top-k launches,
    and the profiler sees 8 global and 14 banded attention kernels, the
    products on the GEMM core only (88 launches) and no library kernel."""
    got = serve_path_launches(dev)
    n, n_global, encode = got["layers"], got["global"], got["encode"]
    assert (encode["modernbert_layer"], encode["modernbert_final_norm"],
            encode["masked_mean_pool_l2norm"]) == (2 * n, 2, 2), encode
    for b, s in SERVE_SHAPES:
        call = got[b, s]
        w = call["wrappers"]
        assert (w["modernbert_layer"], w["modernbert_final_norm"], w["cosine_topk"]) == (n, 1, 1), w
        assert call["attention"] == {"global": n_global, "band": n - n_global}, (b, s, call)
        assert call["gemm"] == 4 * n and not call["library"], (b, s, call)
