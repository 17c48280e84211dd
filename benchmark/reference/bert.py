"""BERT encoder with mean pooling and L2 normalisation, in float32.

The equations of a sentence-transformers BERT tower (all-MiniLM-L6-v2,
e5-base-v2): word + position + token-type-0 embeddings, LayerNorm; per
layer, post-LN: self-attention over the unpadded keys, output projection,
hidden dropout, residual add and LayerNorm; GELU (erf) feed-forward, hidden
dropout, residual add and LayerNorm; then the mean over the real tokens and
division by the L2 norm. Attention-probability dropout is not applied (the
configurations state 0 for it).

``quant`` is applied to both operands of every matrix product and to every
activation the layer stores (its input and output states, the attention and
feed-forward outputs): the identity for the reference, and a lower
precision for the control, at the points where the program stores bf16.

Weights are a dict in the checkpoint layout: ``embeddings`` (``word``,
``position``, ``token_type``, ``ln_scale``, ``ln_bias``) and ``layers``,
each tensor stacked over the layers (``q_w`` ``[L, H, H]`` maps x to x @ W).
"""

from __future__ import annotations

import math

import torch

NEG = -1e9  # added to the logits of padded keys


def exact(t: torch.Tensor) -> torch.Tensor:
    return t


def fp8(t: torch.Tensor) -> torch.Tensor:
    """float8 e4m3 with one scale per tensor (its largest magnitude at 448)."""
    scale = t.detach().abs().amax().clamp_min(1e-30) / 448.0
    q = (t / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
    return t + (q - t).detach()  # straight through in the backward


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def _ln(x, scale, bias, eps):
    mean = x.mean(-1, keepdim=True)
    var = (x - mean).square().mean(-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + eps) * scale + bias


def _mm(a, b, quant):
    return quant(a) @ quant(b)


def _gelu(x):
    return 0.5 * x * (1.0 + torch.erf(x / math.sqrt(2.0)))


def hidden_states(weights, ids, mask, cfg: dict, drop=None, quant=exact):
    """``[B, S, H]`` last-layer states of ``ids`` (``[B, S]`` long) under
    ``mask`` (``[B, S]``, 1 at real tokens). ``drop``: the kept-element
    masks, ``(embedding, [(m1, m2) per layer])`` of bools shaped like the
    states, each kept element scaled by 1 / (1 - rate)."""
    h, heads, eps = cfg["hidden_size"], cfg["num_attention_heads"], cfg["layer_norm_eps"]
    hd = h // heads
    keep = 1.0 - cfg["hidden_dropout_prob"]
    b, s = ids.shape
    emb = weights["embeddings"]
    x = emb["word"][ids] + emb["position"][:s][None] + emb["token_type"][0]
    x = _ln(x, emb["ln_scale"], emb["ln_bias"], eps)
    if drop is not None:
        x = torch.where(drop[0], x / keep, 0.0)
    x = quant(x)
    key_bias = (1.0 - mask.to(torch.float32))[:, None, None, :] * NEG
    lw = weights["layers"]
    for i in range(lw["q_w"].shape[0]):
        def proj(t, name):
            return _mm(t, lw[f"{name}_w"][i], quant) + lw[f"{name}_b"][i]

        def split(t):
            return t.view(b, s, heads, hd).transpose(1, 2)

        q, k, v = split(proj(x, "q")), split(proj(x, "k")), split(proj(x, "v"))
        p = torch.softmax(_mm(q, k.transpose(-1, -2), quant) / math.sqrt(hd) + key_bias, -1)
        a = _mm(p, v, quant).transpose(1, 2).reshape(b, s, h)
        a = quant(_mm(a, lw["o_w"][i], quant) + lw["o_b"][i])
        if drop is not None:
            a = torch.where(drop[1][i][0], a / keep, 0.0)
        x = quant(_ln(quant(x + a), lw["attn_ln_scale"][i], lw["attn_ln_bias"][i], eps))
        f = _gelu(_mm(x, lw["ffn_w1"][i], quant) + lw["ffn_b1"][i])
        f = quant(_mm(f, lw["ffn_w2"][i], quant) + lw["ffn_b2"][i])
        if drop is not None:
            f = torch.where(drop[1][i][1], f / keep, 0.0)
        x = quant(_ln(quant(x + f), lw["ffn_ln_scale"][i], lw["ffn_ln_bias"][i], eps))
    return x


def pool(x, mask):
    m = mask.to(torch.float32)[..., None]
    mean = (x * m).sum(1) / m.sum(1).clamp_min(1e-9)
    return mean / mean.norm(dim=-1, keepdim=True).clamp_min(1e-12)


def embed(weights, ids, mask, cfg, drop=None, quant=exact):
    """Unit-norm sentence embeddings ``[B, H]``."""
    return pool(hidden_states(weights, ids, mask, cfg, drop, quant), mask)


def embed_lists(weights, rows: list[list[int]], cfg, device, pad: int, block: int = 256,
                quant=exact) -> torch.Tensor:
    """Embeddings of token-id lists, in blocks of rows sorted by length,
    each block padded only to its longest row; in input order."""
    order = sorted(range(len(rows)), key=lambda i: len(rows[i]))
    out = torch.empty(len(rows), cfg["hidden_size"], device=device)
    with torch.no_grad():
        for lo in range(0, len(rows), block):
            idx = order[lo : lo + block]
            s = max(len(rows[i]) for i in idx)
            ids = torch.full((len(idx), s), pad, dtype=torch.long)
            mask = torch.zeros(len(idx), s, dtype=torch.int32)
            for j, i in enumerate(idx):
                ids[j, : len(rows[i])] = torch.tensor(rows[i])
                mask[j, : len(rows[i])] = 1
            out[torch.tensor(idx, device=device)] = embed(
                weights, ids.to(device), mask.to(device), cfg, quant=quant
            )
    return out


def topk(queries: torch.Tensor, catalog: torch.Tensor, k: int, block: int = 256):
    """Exact cosine top-k of unit rows: scores and ids, best first."""
    scores, ids = [], []
    for lo in range(0, queries.shape[0], block):
        s = queries[lo : lo + block] @ catalog.T
        v, i = torch.topk(s, k, dim=1)
        scores.append(v)
        ids.append(i)
    return torch.cat(scores), torch.cat(ids)
