"""ModernBERT encoder with mean pooling and L2 normalisation, in float32.

The equations of ``answerdotai/ModernBERT-base`` (arXiv:2412.13663; the
config of ``nomic-ai/modernbert-embed-base``), as transformers 4.57's
``modeling_modernbert.py`` writes them, with no kernel, cache or batching
of the program's:

    x = LN(E[ids])                     LayerNorms have no bias; no position table
    for each layer l:
        x = x + Wo . attn_l(RoPE_theta_l(LN_attn_l(x)))     layer 0: no LN_attn
        x = x + Wo_mlp . (gelu(a) * g),  [a | g] = Wi . LN_mlp(x)
    h = LN_final(x);  embedding = L2(mean of h over the real tokens)

``attn_l`` is softmax(q k^T / sqrt(64) + mask) v over the unpadded keys;
global (RoPE theta ``global_rope_theta``) for l % ``global_attn_every_n_layers``
== 0, else only over keys with |i - j| <= ``local_attention`` // 2 (theta
``local_rope_theta``). RoPE is transformers' ``rotate_half`` form: each
head's halves (x1, x2) go to (x1 cos - x2 sin, x2 cos + x1 sin), the angles
position x theta^(-2j / 64) in f32. GELU is the erf form. No bias anywhere,
every dropout 0.

Departures from the published description, none in the arithmetic: the
attention is computed in blocks of query rows (each block against only the
keys its band can reach), so that S = 8,192 fits; a padded key takes -1e9
where transformers adds float32's lowest value (the same softmax over the
real keys); the word table is indexed by the benchmark's WordPiece ids.

``quant`` is applied to both operands of every matrix product and to every
activation the program stores in its compute dtype (q, k, v after RoPE, the
attention output, a and g, the GeGLU output): the identity for the
reference, and a lower precision for the control. The residual stream stays
f32, as the program keeps it.

Weights are a dict in the program's checkpoint layout: ``embeddings``
(``word``, ``ln_scale``), ``layers`` stacked over the layers (``qkv_w``
``[L, H, 3H]`` mapping x to x @ W with columns q | k | v, ``o_w``,
``attn_ln_scale``, ``mlp_ln_scale``, ``wi`` ``[L, H, 2I]`` with columns
input | gate, ``wo_mlp``) and ``final`` (``ln_scale``).
"""

from __future__ import annotations

import math

import torch

from benchmark.reference.bert import NEG, exact, no_tf32, pool, topk  # noqa: F401

HEAD_DIM = 64
BLOCK = 1024  # query rows a block of the attention


def _ln(x, scale, eps):
    mean = x.mean(-1, keepdim=True)
    var = (x - mean).square().mean(-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + eps) * scale


def _mm(a, b, quant):
    return quant(a) @ quant(b)


def _gelu(x):
    return 0.5 * x * (1.0 + torch.erf(x / math.sqrt(2.0)))


def is_global(cfg: dict, layer: int) -> bool:
    return layer % cfg["global_attn_every_n_layers"] == 0


def rope_tables(s: int, theta: float, device):
    """f32 cos and sin ``[S, 32]`` of positions 0..S-1 at theta^(-2j / 64)."""
    inv = 1.0 / (theta ** (torch.arange(0, HEAD_DIM, 2, dtype=torch.int64).float() / HEAD_DIM))
    ang = torch.arange(s, dtype=torch.int64).float()[:, None] * inv[None, :]
    return ang.cos().to(device), ang.sin().to(device)


def rope(t, cos, sin):
    """``t`` ``[..., S, 64]`` rotated by the tables ``[S, 32]``."""
    x1, x2 = t[..., : HEAD_DIM // 2], t[..., HEAD_DIM // 2 :]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(q, k, v, mask, half: int | None, quant):
    """``[B, heads, S, 64]`` q, k, v (after RoPE), ``mask`` ``[B, S]``;
    ``half`` None for global attention. In blocks of query rows, each
    against only the keys its band can reach, of at most 2^28 logits."""
    b, heads, s, _ = q.shape
    out = torch.empty_like(q)
    key_bias = ((1.0 - mask.to(torch.float32)) * NEG)[:, None, None, :]
    pos = torch.arange(s, device=q.device)
    reach = s if half is None else 2 * half
    block = max(64, min(s, (1 << 28) // (b * heads * min(s, BLOCK + reach))))
    for lo in range(0, s, block):
        hi = min(s, lo + block)
        k_lo, k_hi = (0, s) if half is None else (max(0, lo - half), min(s, hi + half))
        logits = _mm(q[:, :, lo:hi], k[:, :, k_lo:k_hi].transpose(-1, -2), quant)
        logits = logits / math.sqrt(HEAD_DIM) + key_bias[..., k_lo:k_hi]
        if half is not None:
            far = (pos[lo:hi, None] - pos[None, k_lo:k_hi]).abs() > half
            logits = logits.masked_fill(far, float("-inf"))
        out[:, :, lo:hi] = _mm(torch.softmax(logits, -1), v[:, :, k_lo:k_hi], quant)
    return out


def layer(weights, i: int, x, mask, cfg: dict, quant=exact):
    """Layer ``i`` on the f32 states ``x`` ``[B, S, H]``."""
    h, heads, eps = cfg["hidden_size"], cfg["num_attention_heads"], cfg["norm_eps"]
    lw = weights["layers"]
    b, s, _ = x.shape
    glob = is_global(cfg, i)
    theta = cfg["global_rope_theta"] if glob else cfg["local_rope_theta"]
    half = None if glob else cfg["local_attention"] // 2
    cos, sin = rope_tables(s, theta, x.device)
    hin = x if i == 0 else _ln(x, lw["attn_ln_scale"][i], eps)
    qkv = _mm(hin, lw["qkv_w"][i], quant).view(b, s, 3, heads, HEAD_DIM).permute(2, 0, 3, 1, 4)
    q, k = quant(rope(qkv[0], cos, sin)), quant(rope(qkv[1], cos, sin))
    a = attention(q, k, quant(qkv[2]), mask, half, quant)  # [B, heads, S, 64]
    attn = quant(a.transpose(1, 2).reshape(b, s, h))
    x = x + _mm(attn, lw["o_w"][i], quant)
    ag = quant(_mm(_ln(x, lw["mlp_ln_scale"][i], eps), lw["wi"][i], quant))
    inter = ag.shape[-1] // 2
    u = quant(_gelu(ag[..., :inter]) * ag[..., inter:])
    return x + _mm(u, lw["wo_mlp"][i], quant)


def hidden_states(weights, ids, mask, cfg: dict, quant=exact):
    """``[B, S, H]`` final-norm states of ``ids`` (``[B, S]`` long) under
    ``mask`` (``[B, S]``, 1 at real tokens)."""
    emb = weights["embeddings"]
    x = _ln(emb["word"][ids], emb["ln_scale"], cfg["norm_eps"])
    for i in range(cfg["num_hidden_layers"]):
        x = layer(weights, i, x, mask, cfg, quant)
    return _ln(x, weights["final"]["ln_scale"], cfg["norm_eps"])


def embed(weights, ids, mask, cfg, quant=exact):
    """Unit-norm sentence embeddings ``[B, H]``."""
    return pool(hidden_states(weights, ids, mask, cfg, quant), mask)


def embed_lists(weights, rows: list[list[int]], cfg, device, pad: int, tokens: int = 65536,
                quant=exact) -> torch.Tensor:
    """Embeddings of token-id lists, in blocks of rows sorted by length, each
    block padded only to its longest row and holding at most ``tokens``
    padded tokens (at least one row); in input order."""
    order = sorted(range(len(rows)), key=lambda i: len(rows[i]))
    out = torch.empty(len(rows), cfg["hidden_size"], device=device)
    with torch.no_grad():
        lo = 0
        while lo < len(order):
            hi = lo + 1
            while hi < len(order) and (hi + 1 - lo) * len(rows[order[hi]]) <= tokens:
                hi += 1
            idx = order[lo:hi]
            s = max(len(rows[i]) for i in idx)
            ids = torch.full((len(idx), s), pad, dtype=torch.long)
            mask = torch.zeros(len(idx), s, dtype=torch.int32)
            for j, i in enumerate(idx):
                ids[j, : len(rows[i])] = torch.tensor(rows[i])
                mask[j, : len(rows[i])] = 1
            out[torch.tensor(idx, device=device)] = embed(
                weights, ids.to(device), mask.to(device), cfg, quant=quant
            )
            lo = hi
    return out
