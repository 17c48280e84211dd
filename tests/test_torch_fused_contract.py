"""The fused layer's whole contract on the CPU: the shapes JAX's gate admits
past the port's first envelope (S past 256, head_dim 16 and 128) and the
residual-saving forward/backward pair, each held against the JAX package.

- The port's plain forward and backward against JAX's ``_call`` and
  ``_call_bwd`` (``_fused_backward``, wgrads form) in interpret mode at
  S = 272 and 320 (past 256, not 128 multiples) and at head_dim 16 and 128;
  the all-pad row, where the JAX kernel attends over its 128-padded keys,
  against JAX's ``_oracle``.
- The four saved residuals against ``_call(save_resid=True)``; the resid
  backward against ``_call_bwd``'s resid form and against the port's
  recompute backward.
- Tiled models, in torch alone, of K1's two-pass attention (the exact row
  max first, the unnormalised P cast to bf16, 1/z after PV) and of K5's
  attention backward at S = 512, where its kernels stream their tiles.
- ``supports`` at every edge of the envelope, and ``encode`` of a
  max_seq_length 512 tower against JAX's ``encode`` at S = 512.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instacart_next_order_recommendation_tpu.models.encoder import (
    TowerConfig as JaxTowerConfig,
    encode as jax_encode,
    init_params as jax_init_params,
)
from instacart_next_order_recommendation_tpu.ops import fused_layer as jax_fused
from instacart_next_order_recommendation_tpu_torch.models.checkpoint import params_from_numpy
from instacart_next_order_recommendation_tpu_torch.models.encoder import TowerConfig, encode
from instacart_next_order_recommendation_tpu_torch.ops import (
    fused_encoder_layer_backward,
    fused_encoder_layer_train,
    multi_head_attention_backward_reference,
    multi_head_attention_reference,
)
from instacart_next_order_recommendation_tpu_torch.ops import fused_layer
from instacart_next_order_recommendation_tpu_torch.ops.fused_layer import (
    WEIGHT_NAMES,
    prepare_layer,
    supports,
)
from tests.test_torch_fused_bwd import tiled_attention_backward
from tests.test_torch_ops import _dropout_np, _jax_layer_args, _layer_np, _mask_np

EPS = 1e-12
TILE = 64

# (seq, hidden, head_dim): past 256 at head_dim 32 (MiniLM-class), and the
# two head_dims the first envelope left out, at the widths JAX's gate takes
# them (hidden % 128 == 0, heads a multiple of 128 / head_dim).
SHAPES = [
    pytest.param(272, 128, 32, id="S272-hd32"),
    pytest.param(320, 128, 32, id="S320-hd32"),
    pytest.param(64, 128, 16, id="S64-hd16"),
    pytest.param(80, 256, 128, id="S80-hd128"),
]


def _kw(hidden, head_dim):
    return dict(num_heads=hidden // head_dim, scale=1.0 / head_dim**0.5, eps=EPS)


def _as_np(a):
    if isinstance(a, torch.Tensor):
        return a.to(torch.float32).numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def _inputs(seq, hidden, batch=2, seed=40, all_pad=False, dropout=True):
    """Seeded numpy inputs for both packages, f32."""
    rng = np.random.default_rng(seed + seq + hidden)
    layer = _layer_np(rng, hidden, 2 * hidden)
    x_np = (0.5 * rng.standard_normal((batch, seq, hidden))).astype(np.float32)
    mask_np = _mask_np(rng, batch, seq, all_pad_row=all_pad)
    g_np = rng.standard_normal((batch, seq, hidden)).astype(np.float32)
    j_masks, t_masks = _dropout_np(rng, x_np.shape, jnp.float32) if dropout else ((), None)
    return layer, x_np, mask_np, g_np, tuple(j_masks), t_masks


def _port(layer, x_np, mask_np):
    w = prepare_layer({k: torch.from_numpy(v) for k, v in layer.items()}, torch.float32)
    bias = torch.from_numpy((1.0 - mask_np.astype(np.float32)) * -1e9)
    return w, torch.from_numpy(x_np), torch.from_numpy(mask_np), bias


def _assert_grads(port, dx_ref, dw_ref, atol):
    dx, dw = port
    np.testing.assert_allclose(_as_np(dx), _as_np(dx_ref), atol=atol)
    for name, ref in zip(WEIGHT_NAMES, dw_ref):
        np.testing.assert_allclose(
            _as_np(dw[name]).reshape(-1), _as_np(ref).reshape(-1), atol=atol,
            err_msg=f"grad mismatch for {name}",
        )


@pytest.mark.parametrize("seq,hidden,head_dim", SHAPES)
def test_plain_layer_matches_jax_kernels(seq, hidden, head_dim):
    kw = _kw(hidden, head_dim)
    # Forward with an all-pad row: the JAX kernel on the rows with a real
    # token, its oracle on all (at S % 128 != 0 the kernel's all-pad row
    # attends over its 128-padded keys, the oracle's and the port's over S).
    layer, x_np, mask_np, g_np, j_masks, t_masks = _inputs(seq, hidden, 2, all_pad=True)
    x, bias, weights = _jax_layer_args(x_np, mask_np, layer, jnp.float32)
    w, xt, mt, bias_t = _port(layer, x_np, mask_np)
    y = fused_layer.fused_encoder_layer_train_reference(xt, mt, w, masks=t_masks, **kw)
    kernel = jax_fused._call(x, bias, *weights, *j_masks, **kw, interpret=True)
    oracle = jax.jit(functools.partial(jax_fused._oracle, **kw))(x, bias, *j_masks, *weights)
    # f32: the JAX kernel's A&S erf (< 2e-6) against torch.erf, and sums in
    # another order (tests/test_torch_ops.py's bound).
    np.testing.assert_allclose(_as_np(y), _as_np(oracle), atol=1e-4)
    real = mask_np.any(axis=1)
    if seq % 128:
        assert not real.all()
    np.testing.assert_allclose(_as_np(y)[real], _as_np(kernel)[real], atol=1e-4)

    # Backward on the row with real tokens, against the JAX kernel's wgrads
    # form (the JAX package's own kernel-vs-oracle bound).
    rows = np.flatnonzero(real)
    g = jnp.asarray(g_np[rows])
    dx_k, dw_k = jax_fused._fused_backward(
        x[rows], bias[rows], tuple(m[rows] for m in j_masks), weights, g, **kw,
        interpret=True, wgrads=True,
    )
    port = fused_encoder_layer_backward(
        xt[rows], bias_t[rows], torch.from_numpy(g_np[rows]),
        tuple(m[rows] for m in t_masks), w, **kw,
    )
    _assert_grads(port, dx_k, dw_k, atol=3e-4)


@pytest.mark.parametrize("seq,hidden,head_dim", [SHAPES[0], SHAPES[3]])
def test_saved_residuals_and_resid_backward_match_jax(seq, hidden, head_dim):
    kw = _kw(hidden, head_dim)
    layer, x_np, mask_np, g_np, j_masks, t_masks = _inputs(seq, hidden, seed=41)
    x, bias, weights = _jax_layer_args(x_np, mask_np, layer, jnp.float32)
    w, xt, _, bias_t = _port(layer, x_np, mask_np)
    y, resids = fused_layer._reference_core(xt, bias_t, w, *t_masks, **kw, keep=True)
    y_j, *resids_j = jax_fused._call(
        x, bias, *weights, *j_masks, **kw, interpret=True, save_resid=True
    )
    np.testing.assert_allclose(_as_np(y), _as_np(y_j), atol=1e-4)
    for name, a, b in zip(("attn", "ao", "x1", "f"), resids, resids_j):
        assert tuple(a.shape) == tuple(b.shape) == x_np.shape, name
        np.testing.assert_allclose(_as_np(a), _as_np(b), atol=1e-4, err_msg=name)

    # The resid backward from the port's residuals: against the JAX kernel's
    # resid form (from JAX's residuals) and the port's recompute backward.
    g = torch.from_numpy(g_np)
    resid = fused_encoder_layer_backward(xt, bias_t, g, t_masks, w, **kw, resids=resids)
    dx_k, dw_k = jax_fused._fused_backward(
        x, bias, j_masks, weights, jnp.asarray(g_np), **kw, interpret=True, wgrads=True,
        resids=tuple(resids_j),
    )
    _assert_grads(resid, dx_k, dw_k, atol=3e-4)
    recompute = fused_encoder_layer_backward(xt, bias_t, g, t_masks, w, **kw)
    _assert_grads(resid, recompute[0], [recompute[1][n] for n in WEIGHT_NAMES], atol=1e-5)


def test_resid_form_in_bf16_is_the_recompute_form_and_the_train_layer_keeps_it(monkeypatch):
    # In bf16 the two plain backwards read the same bf16 values and give the
    # same bits, as K5's two forms do on the card; the training layer keeps
    # the residuals where ``saves_residuals`` says so (and only its inputs
    # above the cap), and its autograd gradient is the plain backward's.
    hidden, seq, head_dim = 128, 272, 32
    kw = _kw(hidden, head_dim)
    layer, x_np, mask_np, g_np, _, t_masks = _inputs(seq, hidden, seed=42)
    w = prepare_layer({k: torch.from_numpy(v) for k, v in layer.items()}, torch.bfloat16)
    xt = torch.from_numpy(x_np).bfloat16()
    bias = torch.from_numpy((1.0 - mask_np.astype(np.float32)) * -1e9)
    masks = tuple(m.bfloat16() for m in t_masks)
    g = torch.from_numpy(g_np).bfloat16()
    _, resids = fused_layer._reference_core(xt, bias, w, *masks, **kw, keep=True)
    a = fused_encoder_layer_backward(xt, bias, g, masks, w, **kw)
    b = fused_encoder_layer_backward(xt, bias, g, masks, w, **kw, resids=resids)
    assert torch.equal(a[0], b[0])
    assert all(torch.equal(a[1][n], b[1][n]) for n in WEIGHT_NAMES)

    assert fused_layer.saves_residuals(2, 512, 384, 1536)
    assert fused_layer.saves_residuals(512, 512, 384, 1536)  # 805 MB a layer
    assert not fused_layer.saves_residuals(512, 512, 768, 3072)  # 1.6 GB a layer
    assert fused_layer.saves_residuals(256, 512, 768, 3072)  # 768 MiB, the cap
    assert not fused_layer.saves_residuals(257, 512, 768, 3072)
    for cap, kept in ((fused_layer.RESID_BYTES_PER_LAYER, True), (0, False)):
        monkeypatch.setattr(fused_layer, "RESID_BYTES_PER_LAYER", cap)
        xr = xt.clone().requires_grad_(True)
        y = fused_encoder_layer_train(
            xr, torch.from_numpy(mask_np), w, masks=masks, dropout_rate=0.1, **kw
        )
        # x, the key bias, two masks and twelve weights, and the residuals.
        assert len(y.grad_fn.saved_tensors) == 16 + 4 * kept
        y.backward(g)
        assert torch.equal(xr.grad, a[0])
    assert fused_encoder_layer_train.resid_launches == 0  # the CPU never counts a launch


def _two_pass_attention(q, k, v, bias, bf16):
    """K1's attention as its two-pass kernel computes it, per 64-query tile:
    pass one the exact row max over the key tiles; pass two, tile by tile,
    P = exp(x - m) cast to bf16 unnormalised, z summed and P V accumulated
    in f32; 1/z applied after PV. q, k, v [B, heads, S, D] f32 (bf16
    values), bias [B, S]."""
    r = (lambda t: t.to(torch.bfloat16).float()) if bf16 else (lambda t: t)
    s = q.shape[2]
    scale = 1.0 / q.shape[-1] ** 0.5
    tiles = [(t0, min(s, t0 + TILE)) for t0 in range(0, s, TILE)]
    out = torch.zeros_like(q)
    for q0, q1 in tiles:
        def scores(k0, k1):
            x = q[:, :, q0:q1] @ k[:, :, k0:k1].transpose(-1, -2)
            return x * scale + bias[:, None, None, k0:k1]

        m = torch.stack([scores(*t).amax(dim=-1) for t in tiles]).amax(dim=0)[..., None]
        z = torch.zeros_like(m)
        acc = torch.zeros_like(q[:, :, q0:q1])
        for k0, k1 in tiles:
            p = torch.exp(scores(k0, k1) - m)
            z = z + p.sum(dim=-1, keepdim=True)
            acc = acc + r(p) @ v[:, :, k0:k1]
        out[:, :, q0:q1] = r(acc / z)
    return out


@pytest.mark.parametrize("head_dim", [16, 32, 64, 128])
def test_two_pass_attention_model_at_s512(head_dim):
    # The model against the plain layer's attention (the same cast points,
    # one softmax over the whole row): f32 agrees to a few ulps; in bf16 only
    # the sums' order differs, which may flip a rounding of P or of an
    # output (one bf16 ulp is 2^-8 relative) on a few elements.
    b, s, hidden = 2, 512, 128
    g = torch.Generator().manual_seed(43)
    x2 = (0.5 * torch.randn((b * s, hidden), generator=g)).bfloat16()
    w = {"qkv_w": (0.1 * torch.randn((hidden, 3 * hidden), generator=g)).bfloat16(),
         "qkv_b": (0.05 * torch.randn(3 * hidden, generator=g)).bfloat16()}
    lengths = torch.tensor([s, 200])
    bias = torch.where(torch.arange(s)[None] < lengths[:, None], 0.0, -1e9)
    heads = hidden // head_dim
    plain = fused_layer._attention(x2, bias, w, b=b, s=s, num_heads=heads, scale=head_dim**-0.5)
    qkv = (x2.float() @ w["qkv_w"].float() + w["qkv_b"].float()).bfloat16().float()
    q, k, v = (
        qkv[:, i * hidden : (i + 1) * hidden].reshape(b, s, heads, head_dim).permute(0, 2, 1, 3)
        for i in range(3)
    )
    model = _two_pass_attention(q, k, v, bias, bf16=True).permute(0, 2, 1, 3).reshape(b * s, -1)
    diff = (model - plain.float()).abs()
    assert (diff.max() / plain.float().abs().max()).item() <= 2.0**-7
    assert (diff > 0).float().mean().item() <= 0.01
    exact = _two_pass_attention(q, k, v, bias, bf16=False)
    torch.testing.assert_close(
        exact, multi_head_attention_reference(q, k, v, (bias == 0).int(), head_dim**-0.5),
        atol=1e-5, rtol=0,
    )


@pytest.mark.parametrize("head_dim", [16, 32, 64, 128])
def test_streamed_attention_backward_model_at_s512(head_dim):
    # K5's attention backward at S = 512 (eight tiles a side: its dQ kernel
    # keeps z online over the streamed key tiles, its dK/dV kernel loops
    # over the streamed query tiles) in f32 against autograd of the plain
    # attention, and its row statistics.
    b, s, hidden = 2, 512, 128
    g = torch.Generator().manual_seed(44)
    qkv = (0.5 * torch.randn((b, s, 3 * hidden), generator=g)).bfloat16().float()
    dattn = torch.randn((b, s, hidden), generator=g)
    lengths = torch.tensor([s, 300])
    mask = (torch.arange(s)[None] < lengths[:, None]).int()
    bias = (1.0 - mask.float()) * -1e9
    heads = hidden // head_dim

    def split(t):
        return t.reshape(b, s, heads, head_dim).permute(0, 2, 1, 3)

    def packed(t):
        return t.permute(0, 2, 1, 3).reshape(b, s, hidden)

    q, k, v = (split(qkv[..., i * hidden : (i + 1) * hidden]) for i in range(3))
    scale = head_dim**-0.5
    attn = packed(multi_head_attention_reference(q, k, v, mask, scale))
    dqkv, (m, z, dz) = tiled_attention_backward(qkv, attn, dattn, bias, False, head_dim)
    plain = multi_head_attention_backward_reference(q, k, v, mask, split(dattn), scale)
    torch.testing.assert_close(dqkv, torch.cat([packed(t) for t in plain], -1), atol=1e-5, rtol=0)
    assert torch.isfinite(m).all() and torch.isfinite(dz).all()
    assert (z >= 1.0).all() and (z <= s).all()


@pytest.mark.parametrize(
    "hidden,heads,seq,inter,ok",
    [
        (384, 12, 512, 1536, True),    # MiniLM-L6 at the towers' longest S
        (384, 12, 528, 1536, False),   # past max_position
        (384, 12, 16, 1536, True),     # the shortest bucket
        (384, 12, 8, 1536, False),     # below one 16-row tile
        (384, 12, 200, 1536, False),   # S % 16 != 0
        (128, 8, 64, 256, True),       # head_dim 16
        (256, 2, 64, 512, True),       # head_dim 128
        (384, 8, 64, 1536, False),     # head_dim 48 does not divide 128
        (512, 2, 64, 1024, False),     # head_dim 256
        (1024, 8, 64, 4096, True),     # the LayerNorm row kernel's widest row
        (1088, 17, 64, 4352, False),   # past it
        (320, 10, 64, 1280, True),     # hidden % 64 == 0, not % 128
        (352, 11, 64, 1280, False),    # hidden % 64 != 0
        (384, 12, 64, 1504, False),    # intermediate % 64 != 0
        (384, 0, 64, 1536, False),
    ],
)
def test_supports_at_every_edge(hidden, heads, seq, inter, ok):
    assert supports(hidden, heads, seq, inter) is ok


def test_encode_at_s512_matches_jax():
    # A one-layer f32 tower whose position table reaches 512: one short
    # batch that buckets to S = 512 takes the fused route in both packages.
    small = dict(vocab_size=97, hidden_size=128, num_layers=1, num_heads=4,
                 intermediate_size=256, max_position=512, compute_dtype="float32")
    params = jax_init_params(JaxTowerConfig(**small), jax.random.key(1))
    host = jax.tree.map(np.asarray, params)
    rng = np.random.default_rng(45)
    for name in ("q_b", "k_b", "v_b", "o_b", "ffn_b1", "ffn_b2"):
        host["layers"][name] = (0.02 * rng.standard_normal(host["layers"][name].shape)).astype(
            np.float32
        )
    ids = rng.integers(5, small["vocab_size"], size=(2, 512)).astype(np.int32)
    ids[1, 300:] = 0
    mask = (ids != 0).astype(np.int32)
    cfg = TowerConfig(**small)
    assert supports(cfg.hidden_size, cfg.num_heads, 512, cfg.intermediate_size)
    ref = np.asarray(jax_encode(jax.tree.map(jnp.asarray, host), jnp.asarray(ids),
                                jnp.asarray(mask), JaxTowerConfig(**small)))
    out = encode(params_from_numpy(host), torch.from_numpy(ids), torch.from_numpy(mask), cfg)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5)


def test_launch_counts_report_the_resid_form(monkeypatch):
    # ``ops.launch_counts`` reports K1-train's and K5's residual-saving
    # launches under ``<name>.resid`` beside every wrapper's launches, and
    # ``reset_launch_counts`` sets every one of those counters to 0.
    from instacart_next_order_recommendation_tpu_torch import ops

    for i, w in enumerate(ops.KERNEL_WRAPPERS):
        for j, attr in enumerate(ops.counter_names(w)):
            monkeypatch.setattr(w, attr, 10 * i + j + 1)
    counts = ops.launch_counts()
    assert counts["fused_encoder_layer_train.resid"] == 12
    assert counts["fused_encoder_layer_backward.resid"] == 22
    assert {n: counts[n] for n in (w.__name__ for w in ops.KERNEL_WRAPPERS)} == {
        w.__name__: 10 * i + 1 for i, w in enumerate(ops.KERNEL_WRAPPERS)
    }
    assert len(counts) == len(ops.KERNEL_WRAPPERS) + 2
    assert ops.counter_names(ops.cosine_topk) == ("launches",)
    ops.reset_launch_counts()
    assert not any(ops.launch_counts().values())
