"""The attention part of the fused layer's backward kernel (K5,
``ops/csrc/fused_layer_bwd.cu``) as a model on the CPU: the same tiling and
the same bf16 casts, written out in f32 torch, held against the JAX
package's ``_bwd_kernel`` (Pallas, interpret mode) and against the port's
plain backward. The CUDA kernel cannot run here; this pins its algebra:

- the dQ pass, per 64-query tile: the scores with the forward's exact row
  max m and sum z (online over the key tiles where the kernel's score row
  does not fit in registers: head_dim 64 at S > 192),
  dz = -sum_d(dA * A) / z, dU = bf16(dA / z),
  dP = dU V^T, dL = bf16(P * (dP + dz)) with P = exp(x - m) unnormalised,
  dQ = scale * dL K summed tile by tile; it leaves m, z and dz per row (and
  dU, which the kernel writes over dA);
- the dK/dV pass, per 64-key tile, looping over the query tiles with only
  those: P^T and dL^T from K Q^T and V dU^T, dV += bf16(P)^T dU,
  dK += dL^T Q, scaled once at the end.

Each case runs at head_dim 32 (MiniLM-class) and 64 (mpnet-base-class).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instacart_next_order_recommendation_tpu.ops import fused_layer as jax_fused
from instacart_next_order_recommendation_tpu_torch.ops import (
    fused_encoder_layer_backward,
    multi_head_attention_backward_reference,
    multi_head_attention_reference,
)
from instacart_next_order_recommendation_tpu_torch.ops.fused_layer import prepare_layer

HIDDEN, INTER = 128, 256
EPS = 1e-12
TILE = 64
# (seq, all_pad, head_dim); the head_dim 64 ids carry a prefix.
CASES = [
    pytest.param(seq, all_pad, hd, id=("" if hd == 32 else "head_dim_64-") + f"{seq}-{all_pad}")
    for hd in (32, 64)
    for seq in (48, 256)
    for all_pad in (False, True)
]


def _scale(head_dim):
    return 1.0 / head_dim**0.5


def _row_in_registers(head_dim, n_tiles):
    """K5's dQ kernel keeps the whole score row in registers by this rule
    (``dq_row_in_registers``), else it sums z online over the key tiles."""
    return n_tiles * 32 + head_dim // 2 + head_dim // 4 <= 160


def _layer_np(rng):
    def w(*shape):
        return (0.05 * rng.standard_normal(shape)).astype(np.float32)

    return {
        "q_w": w(HIDDEN, HIDDEN), "q_b": w(HIDDEN), "k_w": w(HIDDEN, HIDDEN), "k_b": w(HIDDEN),
        "v_w": w(HIDDEN, HIDDEN), "v_b": w(HIDDEN), "o_w": w(HIDDEN, HIDDEN), "o_b": w(HIDDEN),
        "attn_ln_scale": (1.0 + 0.1 * rng.standard_normal(HIDDEN)).astype(np.float32),
        "attn_ln_bias": w(HIDDEN),
        "ffn_w1": w(HIDDEN, INTER), "ffn_b1": w(INTER),
        "ffn_w2": w(INTER, HIDDEN), "ffn_b2": w(HIDDEN),
        "ffn_ln_scale": (1.0 + 0.1 * rng.standard_normal(HIDDEN)).astype(np.float32),
        "ffn_ln_bias": w(HIDDEN),
    }


def tiled_attention_backward(qkv, attn, dattn, bias, bf16, head_dim, cast_dl=True):
    """dqkv [B, S, 3H] of the attention part of the layer, as K5's two
    kernels compute it; every argument an f32 tensor (bf16 values where the
    kernel takes bf16), bias [B, S]. ``bf16`` rounds where the kernel does
    (``cast_dl=False`` leaves dL in f32, to show that cast matters).
    Returns dqkv and the dQ pass's (m, z, dz), each [B, heads, S]."""
    r = (lambda t: t.to(torch.bfloat16).float()) if bf16 else (lambda t: t)
    r_dl = r if cast_dl else (lambda t: t)
    b, s, _ = qkv.shape
    n_heads, scale = HIDDEN // head_dim, _scale(head_dim)
    q, k, v = (_heads(qkv[..., i * HIDDEN : (i + 1) * HIDDEN], head_dim) for i in range(3))
    a, da = _heads(attn, head_dim), _heads(dattn, head_dim)
    kb = bias[:, None, None, :]
    tiles = [(t0, min(s, t0 + TILE)) for t0 in range(0, s, TILE)]
    online = not _row_in_registers(head_dim, len(tiles))

    # dQ pass, per query tile.
    dq = torch.zeros_like(q)
    du = torch.zeros_like(q)
    m, z, dz = (torch.zeros((b, n_heads, s, 1)) for _ in range(3))
    for q0, q1 in tiles:
        x = (q[:, :, q0:q1] @ k.transpose(-1, -2)) * scale + kb
        m_t = x.amax(dim=-1, keepdim=True)
        p = torch.exp(x - m_t)
        z_t = p.sum(dim=-1, keepdim=True)
        if online:  # the first of two passes: z rescaled as the max grows
            m_run = torch.full_like(m_t, -3.0e38)
            z_t = torch.zeros_like(m_t)
            for k0, k1 in tiles:
                m_new = torch.maximum(m_run, x[..., k0:k1].amax(dim=-1, keepdim=True))
                e = torch.exp(x[..., k0:k1] - m_new).sum(dim=-1, keepdim=True)
                z_t = z_t * torch.exp(m_run - m_new) + e
                m_run = m_new
        dz_t = -(da[:, :, q0:q1] * a[:, :, q0:q1]).sum(dim=-1, keepdim=True) / z_t
        du_t = r(da[:, :, q0:q1] / z_t)
        acc = torch.zeros_like(q[:, :, q0:q1])
        for k0, k1 in tiles:
            dp = du_t @ v[:, :, k0:k1].transpose(-1, -2)
            dl = r_dl(p[..., k0:k1] * (dp + dz_t))
            acc = acc + dl @ k[:, :, k0:k1]
        dq[:, :, q0:q1] = r(acc * scale)
        du[:, :, q0:q1] = du_t
        m[:, :, q0:q1], z[:, :, q0:q1], dz[:, :, q0:q1] = m_t, z_t, dz_t

    # dK/dV pass, per key tile, from dU, m and dz alone.
    dk = torch.zeros_like(k)
    dv = torch.zeros_like(v)
    for k0, k1 in tiles:
        acc_k = torch.zeros_like(k[:, :, k0:k1])
        acc_v = torch.zeros_like(acc_k)
        for q0, q1 in tiles:
            xt = (k[:, :, k0:k1] @ q[:, :, q0:q1].transpose(-1, -2)) * scale
            xt = xt + bias[:, None, k0:k1, None]
            pt = torch.exp(xt - m[:, :, q0:q1].transpose(-1, -2))
            dpt = v[:, :, k0:k1] @ du[:, :, q0:q1].transpose(-1, -2)
            dlt = r_dl(pt * (dpt + dz[:, :, q0:q1].transpose(-1, -2)))
            acc_v = acc_v + r(pt) @ du[:, :, q0:q1]
            acc_k = acc_k + dlt @ q[:, :, q0:q1]
        dk[:, :, k0:k1] = r(acc_k * scale)
        dv[:, :, k0:k1] = r(acc_v)

    dqkv = torch.cat([_packed(dq), _packed(dk), _packed(dv)], dim=-1)
    return dqkv, (m[..., 0], z[..., 0], dz[..., 0])


def _case(seq, all_pad, dtype, head_dim, batch=3, seed=30):
    """The JAX kernel's dqkv, and the model's inputs taken from the same
    JAX run: qkv and dattn as the kernel computes them, attn and dao among
    its outputs (the ``wgrads=False`` form of ``_bwd_kernel``)."""
    rng = np.random.default_rng(seed + seq)
    layer = _layer_np(rng)
    x_np = (0.5 * rng.standard_normal((batch, seq, HIDDEN))).astype(np.float32)
    g_np = rng.standard_normal((batch, seq, HIDDEN)).astype(np.float32)
    lengths = rng.integers(seq // 4, seq + 1, size=batch)
    if all_pad:
        lengths[-1] = 0
    mask_np = (np.arange(seq)[None, :] < lengths[:, None]).astype(np.int32)
    cdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    L = {n: jnp.asarray(a) for n, a in layer.items()}
    qkv_w = jnp.concatenate([L["q_w"], L["k_w"], L["v_w"]], axis=1).astype(cdt)
    qkv_b = jnp.concatenate([L["q_b"], L["k_b"], L["v_b"]]).reshape(1, -1).astype(cdt)
    weights = (
        qkv_w, qkv_b, L["o_w"].astype(cdt), L["o_b"].reshape(1, -1).astype(cdt),
        L["attn_ln_scale"].reshape(1, -1), L["attn_ln_bias"].reshape(1, -1),
        L["ffn_w1"].astype(cdt), L["ffn_b1"].reshape(1, -1).astype(cdt),
        L["ffn_w2"].astype(cdt), L["ffn_b2"].reshape(1, -1).astype(cdt),
        L["ffn_ln_scale"].reshape(1, -1), L["ffn_ln_bias"].reshape(1, -1),
    )
    skv = -(-seq // 128) * 128
    bias_np = (1.0 - mask_np.astype(np.float32)) * -1e9
    bias = jnp.asarray(np.pad(bias_np[:, None, :], ((0, 0), (0, 0), (0, skv - seq)),
                              constant_values=-1e9))
    x, g = jnp.asarray(x_np, cdt), jnp.asarray(g_np, cdt)
    kw = dict(num_heads=HIDDEN // head_dim, scale=_scale(head_dim), eps=EPS)
    outs = jax_fused._call_bwd(x, bias, g, *weights, **kw, interpret=True)
    dqkv_jax, dao, attn = outs[1], outs[2], outs[5]
    f32 = jnp.float32
    n = batch * seq
    qkv = (jax.lax.dot_general(x.reshape(n, HIDDEN), qkv_w, (((1,), (0,)), ((), ())),
                               preferred_element_type=f32) + qkv_b.astype(f32)).astype(cdt)
    dattn = jax.lax.dot_general(dao.reshape(n, HIDDEN), weights[2], (((1,), (1,)), ((), ())),
                                preferred_element_type=f32).astype(cdt)

    def t(a, shape):
        return torch.from_numpy(np.asarray(jnp.asarray(a, f32)).reshape(shape).copy())

    model_in = (
        t(qkv, (batch, seq, 3 * HIDDEN)), t(attn, (batch, seq, HIDDEN)),
        t(dattn, (batch, seq, HIDDEN)), torch.from_numpy(bias_np.astype(np.float32)),
    )
    jax_in = (x, bias, g, weights, kw)
    return model_in, t(dqkv_jax, (batch, seq, 3 * HIDDEN)), (x_np, mask_np, g_np, layer), jax_in


def _rows_jax_agrees_on(seq, all_pad, batch=3):
    """Batch rows on which the JAX kernel computes the port's function: at
    S % 128 != 0 its all-pad row attends over 128-padded keys (the quirk
    pinned in tests/test_torch_ops.py), the port's over its S keys."""
    return list(range(batch - 1)) if all_pad and seq % 128 else list(range(batch))


def _heads(t, head_dim):
    b, s, _ = t.shape
    return t.reshape(b, s, HIDDEN // head_dim, head_dim).permute(0, 2, 1, 3)


def _packed(t):
    b, _, s, _ = t.shape
    return t.permute(0, 2, 1, 3).reshape(b, s, HIDDEN)


@pytest.mark.parametrize("seq,all_pad,head_dim", CASES)
def test_tiled_model_matches_jax_bwd_kernel_and_plain_backward_f32(seq, all_pad, head_dim):
    (qkv, _, dattn, bias), dqkv_jax, (x_np, mask_np, g_np, layer), jax_in = _case(
        seq, all_pad, "float32", head_dim
    )
    scale = _scale(head_dim)
    q, k, v = (_heads(qkv[..., i * HIDDEN : (i + 1) * HIDDEN], head_dim) for i in range(3))
    mask = torch.from_numpy(mask_np)
    # A is the forward of these q, k, v (the port's plain attention, f32),
    # also on the all-pad row, where the JAX kernel's own forward differs.
    attn = _packed(multi_head_attention_reference(q, k, v, mask, scale))
    dqkv, (m, z, dz) = tiled_attention_backward(qkv, attn, dattn, bias, False, head_dim)

    # f32 throughout: only the summation order differs (64-row tiles here,
    # 128-lane head groups there, one softmax in the plain version), a few
    # f32 ulps of gradients below 4.
    rows = _rows_jax_agrees_on(seq, all_pad)
    np.testing.assert_allclose(dqkv[rows].numpy(), dqkv_jax[rows].numpy(), atol=1e-5)
    plain = multi_head_attention_backward_reference(
        q, k, v, mask, _heads(dattn, head_dim), scale
    )
    np.testing.assert_allclose(dqkv.numpy(), torch.cat([_packed(t) for t in plain], -1).numpy(),
                               atol=1e-5)
    # The dQ pass's row statistics: z sums exp(x - m) over the row's S keys
    # with m its max; an all-pad row has S equal logits, so z = S.
    assert torch.isfinite(m).all() and torch.isfinite(dz).all()
    assert (z >= 1.0).all() and (z <= seq).all()
    if all_pad:
        torch.testing.assert_close(z[-1], torch.full_like(z[-1], float(seq)))

    # Against the port's plain layer backward (autograd of the plain
    # forward, on the same x and weights), through dWqkv = x^T dqkv and
    # d_bqkv = sum(dqkv), on the rows where dattn is that backward's own
    # (it came from the JAX kernel's f32 backward, within 1e-4 of it).
    w = prepare_layer({n: torch.from_numpy(a) for n, a in layer.items()}, torch.float32)
    xt = torch.from_numpy(x_np)[rows]
    _, grads = fused_encoder_layer_backward(
        xt, torch.from_numpy((1.0 - mask_np[rows].astype(np.float32)) * -1e9),
        torch.from_numpy(g_np)[rows], None, w, **jax_in[4],
    )
    flat = dqkv[rows].reshape(-1, 3 * HIDDEN)
    dw_qkv = xt.reshape(-1, HIDDEN).T @ flat
    torch.testing.assert_close(dw_qkv, grads["qkv_w"], atol=1e-4, rtol=0)
    torch.testing.assert_close(flat.sum(0), grads["qkv_b"], atol=1e-4, rtol=0)
    # And against the JAX kernel's wgrads form, which sums x^T dqkv inside.
    x, jbias, g, weights, kw = jax_in
    take = jnp.asarray(rows)
    _, dw_jax = jax_fused._fused_backward(
        x[take], jbias[take], (), weights, g[take], **kw, interpret=True, wgrads=True
    )
    np.testing.assert_allclose(dw_qkv.numpy(), np.asarray(dw_jax[0]), atol=1e-4)
    np.testing.assert_allclose(flat.sum(0).numpy(), np.asarray(dw_jax[1]).reshape(-1), atol=1e-4)


@pytest.mark.parametrize("seq,all_pad,head_dim", CASES)
def test_tiled_model_matches_jax_bwd_kernel_bf16(seq, all_pad, head_dim):
    (qkv, attn, dattn, bias), dqkv_jax, _, _ = _case(seq, all_pad, "bfloat16", head_dim)
    rows = _rows_jax_agrees_on(seq, all_pad)
    ref = dqkv_jax[rows]
    dqkv = tiled_attention_backward(qkv, attn, dattn, bias, True, head_dim)[0][rows]
    # The same bf16 cast points (dU, bf16(P) and dL before their products,
    # each gradient once). The f32 sums run in another order, which can flip
    # a rounding (one bf16 ulp, 2^-8 relative) of an operand or a result: on
    # a few elements, by at most two ulps of the largest magnitude.
    assert ((dqkv - ref).abs().max() / ref.abs().max()).item() <= 2.0**-7
    assert (dqkv != ref).float().mean().item() <= 0.01
    # dL's cast is one of them: left in f32, dQ and dK move on a tenth of
    # their elements or more.
    no_cast = tiled_attention_backward(
        qkv, attn, dattn, bias, True, head_dim, cast_dl=False
    )[0][rows]
    assert (no_cast[..., : 2 * HIDDEN] != ref[..., : 2 * HIDDEN]).float().mean().item() > 0.1
