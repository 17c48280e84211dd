"""The ModernBERT tower: embeddings, pre-norm layers, final norm, mean pool.

``encode`` (``models/encoder.py``) sends a ``TowerConfig`` whose
``architecture`` is ``"modernbert"`` here, inside its ``tower.encode``
span and counters. The equations are ``answerdotai/ModernBERT-base``'s
(transformers' ``modeling_modernbert.py``), as
``nomic-ai/modernbert-embed-base`` serves it:

    x = LN(E[ids])                                   no position table
    for each layer l:  x = layer_l(x)                (ops/modernbert.py)
    embedding = L2(mean over real tokens of LN_final(x))

with LayerNorms without bias, no bias on any product, every third layer
(0, 3, 6, ...) global with RoPE theta ``global_rope_theta`` and the others
banded to ``|i - j| <= local_attention // 2`` with ``local_rope_theta``. The
residual stream is f32; each layer's products take the compute dtype.

Parameters, stacked over the layers like BERT's: ``embeddings`` (``word``
``[vocab, H]``, ``ln_scale``), ``layers`` (``qkv_w`` ``[L, H, 3H]`` with the
columns q | k | v, ``o_w``, ``attn_ln_scale`` (layer 0's unused: its
attention has no norm), ``mlp_ln_scale``, ``wi`` ``[L, H, 2I]`` with the
columns input | gate, ``wo_mlp`` ``[L, I, H]``) and ``final`` (``ln_scale``).
Each matrix maps x to x @ W (transformers' ``weight.T``).

Serving only on the card: the layer's kernels have no backward, so a
forward that would need one raises there. On the CPU the forward is plain
PyTorch and differentiable.
"""

from __future__ import annotations

import math

import torch

from instacart_next_order_recommendation_tpu_torch.ops import masked_mean_pool_l2norm
from instacart_next_order_recommendation_tpu_torch.ops.modernbert import (
    modernbert_final_norm,
    modernbert_layer,
    prepare_layer,
)

INIT_STD = 0.02  # initializer_range (initializer_cutoff_factor 2: _trunc_normal's cut)


def is_global(config, layer: int) -> bool:
    return layer % config.global_attn_every_n_layers == 0


def layer_attention(config, layer: int) -> tuple[float, int]:
    """(RoPE theta, band half-width or -1 for global) of layer ``layer``."""
    if is_global(config, layer):
        return config.global_rope_theta, -1
    return config.local_rope_theta, config.local_attention // 2


def init_params(config, generator: torch.Generator) -> dict:
    """ModernBERT's init (transformers' ``_init_weights``): normals cut at two
    deviations, std 0.02 for the embeddings and the input projections (Wqkv,
    Wi), 0.02 / sqrt(2 L) for the output projections (Wo, Wo_mlp); norm
    scales one. On the CPU, from ``generator``."""
    from instacart_next_order_recommendation_tpu_torch.models.encoder import _trunc_normal

    h, inter, n = config.hidden_size, config.intermediate_size, config.num_layers
    out_std = INIT_STD / math.sqrt(2.0 * n)

    def tn(std, *shape):
        return _trunc_normal(generator, shape, std)

    def ones(*shape):
        return torch.ones(shape, dtype=torch.float32)

    return {
        "embeddings": {"word": tn(INIT_STD, config.vocab_size, h), "ln_scale": ones(h)},
        "layers": {
            "qkv_w": tn(INIT_STD, n, h, 3 * h),
            "o_w": tn(out_std, n, h, h),
            "attn_ln_scale": ones(n, h),
            "mlp_ln_scale": ones(n, h),
            "wi": tn(INIT_STD, n, h, 2 * inter),
            "wo_mlp": tn(out_std, n, inter, h),
        },
        "final": {"ln_scale": ones(h)},
    }


def prepare_layers(params: dict, config, dtype: torch.dtype) -> list[dict]:
    stacked = params["layers"]
    return [
        prepare_layer({name: t[i] for name, t in stacked.items()}, dtype, first=i == 0)
        for i in range(config.num_layers)
    ]


def _needs_backward(params: dict, layers: list[dict] | None, generator) -> bool:
    if generator is not None:
        return True
    if not torch.is_grad_enabled():
        return False
    tensors = [t for group in params.values() for t in group.values()]
    tensors += [t for layer in layers or () for t in layer.values() if t is not None]
    return any(t.requires_grad for t in tensors)


def forward(params: dict, input_ids: torch.Tensor, attention_mask: torch.Tensor, config,
            layers: list[dict] | None, generator, width: int, dtype: torch.dtype):
    """The tower on the first ``width`` columns: unit-norm embeddings
    ``[B, H]`` (f32)."""
    if input_ids.device.type == "cuda" and _needs_backward(params, layers, generator):
        raise ValueError(
            "ModernBERT trains only on the CPU: its CUDA layer (ops/csrc/modernbert.cu) has no "
            "backward kernel for the banded and RoPE attention; run the forward without a "
            "dropout generator and without gradients to weights"
        )
    if width > config.max_position:
        raise ValueError(f"sequence length {width} exceeds the model's {config.max_position}")
    ids = input_ids[:, :width]
    mask = attention_mask[:, :width].contiguous()
    emb = params["embeddings"]
    x = torch.nn.functional.embedding(ids.long(), emb["word"]).to(torch.float32)
    mean = x.mean(dim=-1, keepdim=True)
    var = (x - mean).square().mean(dim=-1, keepdim=True)
    x = ((x - mean) * torch.rsqrt(var + config.layer_norm_eps) * emb["ln_scale"]).contiguous()
    if layers is None:
        layers = prepare_layers(params, config, dtype)
    for i, layer in enumerate(layers):
        theta, half = layer_attention(config, i)
        x = modernbert_layer(x, mask, layer, num_heads=config.num_heads,
                             eps=config.layer_norm_eps, theta=theta, half=half)
    h = modernbert_final_norm(x, params["final"]["ln_scale"], eps=config.layer_norm_eps,
                              dtype=dtype)
    return masked_mean_pool_l2norm(h, mask)
