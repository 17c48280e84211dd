"""MiniLM-class transformer tower: BERT encoder + mean-pool + L2-norm (inference).

Counterpart of the JAX package's ``models/encoder.py``. Parameters are a
plain dict of tensors with the same names and the same stacked-layer layout
(every ``layers`` entry has a leading ``num_layers`` axis), so weights carry
across packages unchanged (``models/checkpoint.py``).

The forward sums the embeddings and LayerNorms them in f32, casts to the
compute dtype, runs ``fused_encoder_layer`` once per layer, then
``masked_mean_pool_l2norm``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from instacart_next_order_recommendation_tpu_torch.ops import (
    fused_encoder_layer,
    masked_mean_pool_l2norm,
)
from instacart_next_order_recommendation_tpu_torch.ops.fused_layer import prepare_layer

Params = dict[str, Any]

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class TowerConfig:
    """Architecture hyperparameters (BERT-encoder family); the same fields
    as the JAX package's ``TowerConfig``, so ``model_config.json`` is shared."""

    vocab_size: int = 30522
    hidden_size: int = 384
    num_layers: int = 6
    num_heads: int = 12
    intermediate_size: int = 1536
    max_position: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    hidden_dropout: float = 0.1
    max_seq_length: int = 256
    compute_dtype: str = "bfloat16"
    remat: bool = False

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "TowerConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})


# Preset matching all-MiniLM-L6-v2.
MINILM_L6 = TowerConfig()


def _trunc_normal(generator: torch.Generator, shape, stddev: float = 0.02) -> torch.Tensor:
    """Normal truncated to [-2, 2] standard deviations, then scaled: the
    same distribution as the JAX package's init (not the same numbers)."""
    lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
    hi = 0.5 * (1.0 + math.erf(2.0 / math.sqrt(2.0)))
    u = torch.rand(shape, generator=generator, dtype=torch.float64)
    z = math.sqrt(2.0) * torch.erfinv(2.0 * (lo + u * (hi - lo)) - 1.0)
    return (stddev * z.clamp(-2.0, 2.0)).to(torch.float32)


def init_params(config: TowerConfig, generator: torch.Generator) -> Params:
    """BERT-style truncated-normal(0.02) init on the CPU, from ``generator``."""
    h, inter, n = config.hidden_size, config.intermediate_size, config.num_layers

    def tn(*shape):
        return _trunc_normal(generator, shape)

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.float32)

    def ones(*shape):
        return torch.ones(shape, dtype=torch.float32)

    return {
        "embeddings": {
            "word": tn(config.vocab_size, h),
            "position": tn(config.max_position, h),
            "token_type": tn(config.type_vocab_size, h),
            "ln_scale": ones(h),
            "ln_bias": zeros(h),
        },
        "layers": {
            "q_w": tn(n, h, h),
            "q_b": zeros(n, h),
            "k_w": tn(n, h, h),
            "k_b": zeros(n, h),
            "v_w": tn(n, h, h),
            "v_b": zeros(n, h),
            "o_w": tn(n, h, h),
            "o_b": zeros(n, h),
            "attn_ln_scale": ones(n, h),
            "attn_ln_bias": zeros(n, h),
            "ffn_w1": tn(n, h, inter),
            "ffn_b1": zeros(n, inter),
            "ffn_w2": tn(n, inter, h),
            "ffn_b2": zeros(n, h),
            "ffn_ln_scale": ones(n, h),
            "ffn_ln_bias": zeros(n, h),
        },
    }


def prepare_layers(params: Params, config: TowerConfig) -> list[dict]:
    """Per-layer kernel-layout weights in the compute dtype. Made once per
    tower (``TextEncoder`` keeps them) instead of once per forward."""
    dtype = DTYPES[config.compute_dtype]
    stacked = params["layers"]
    return [
        prepare_layer({name: t[i] for name, t in stacked.items()}, dtype)
        for i in range(config.num_layers)
    ]


def _layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float):
    x32 = x.to(torch.float32)
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    return (x32 - mean) * torch.rsqrt(var + eps) * scale + bias


def embed(params: Params, input_ids: torch.Tensor, config: TowerConfig) -> torch.Tensor:
    """Word + position + token-type embeddings, LayerNorm in f32, cast to
    the compute dtype: ``[B, S]`` ids -> ``[B, S, hidden]``."""
    s = input_ids.shape[1]
    if s > config.max_position:
        # Indexing past the position table must fail loudly, never clamp.
        raise ValueError(
            f"sequence length {s} exceeds the position table ({config.max_position})"
        )
    emb = params["embeddings"]
    x = emb["word"][input_ids.long()] + emb["position"][:s][None, :, :] + emb["token_type"][0]
    x = _layer_norm(x, emb["ln_scale"], emb["ln_bias"], config.layer_norm_eps)
    return x.to(DTYPES[config.compute_dtype])


def encode(
    params: Params,
    input_ids: torch.Tensor,
    attention_mask: torch.Tensor,
    config: TowerConfig,
    layers: list[dict] | None = None,
) -> torch.Tensor:
    """Tower forward: token ids -> unit-norm sentence embedding ``[B, hidden]``.

    ``layers`` are ``prepare_layers(params, config)``; made here if omitted.
    """
    x = embed(params, input_ids, config)
    if layers is None:
        layers = prepare_layers(params, config)
    scale = 1.0 / (config.head_dim**0.5)
    for layer in layers:
        x = fused_encoder_layer(
            x,
            attention_mask,
            layer,
            num_heads=config.num_heads,
            scale=scale,
            eps=config.layer_norm_eps,
        )
    return masked_mean_pool_l2norm(x, attention_mask)
