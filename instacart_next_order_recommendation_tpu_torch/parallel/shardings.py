"""The tower's tensor-parallel layout over the ``model`` axis.

Counterpart of the JAX package's ``parallel/shardings.py``, in the port's
terms: for each stacked layer parameter, the dimension that splits over
``model`` (None: replicated). The Megatron layout: Q/K/V and the FFN's first
matrix column-parallel (heads and FFN columns split), the output projection
and the FFN's second matrix row-parallel, biases after a row-parallel sum,
LayerNorms and embeddings replicated. Each rank holds the contiguous block
``model_rank`` of every split dimension, as JAX places a shard.
"""

from __future__ import annotations

from typing import TYPE_CHECKING

import torch

if TYPE_CHECKING:  # models.encoder imports parallel.tp
    from instacart_next_order_recommendation_tpu_torch.models.encoder import Params, TowerConfig

# The dimension of each stacked layer leaf (leading axis: layer) that splits
# over the model axis; None replicates.
TP_SPLIT_DIMS = {
    "q_w": 2,
    "q_b": 1,
    "k_w": 2,
    "k_b": 1,
    "v_w": 2,
    "v_b": 1,
    "o_w": 1,
    "o_b": None,
    "attn_ln_scale": None,
    "attn_ln_bias": None,
    "ffn_w1": 2,
    "ffn_b1": 1,
    "ffn_w2": 1,
    "ffn_b2": None,
    "ffn_ln_scale": None,
    "ffn_ln_bias": None,
}
EMBEDDING_KEYS = ("word", "position", "token_type", "ln_scale", "ln_bias")


def param_specs(config: TowerConfig, tensor_parallel: bool) -> dict:
    """The split dimension of every leaf, shaped like the param tree."""
    return {
        "embeddings": {k: None for k in EMBEDDING_KEYS},
        "layers": {k: (v if tensor_parallel else None) for k, v in TP_SPLIT_DIMS.items()},
    }


def split_dim(path: str) -> int | None:
    """The split dimension of the leaf at ``path`` (``"layers/q_w"``, as
    ``train.trainer.param_leaves`` names them) under tensor parallelism."""
    group, _, name = path.partition("/")
    return TP_SPLIT_DIMS[name] if group == "layers" else None


def validate_tp(config: TowerConfig, tp: int) -> None:
    """Raise unless ``tp`` divides the heads and the intermediate width (the
    JAX package's ``param_shardings`` checks)."""
    if tp <= 1:
        return
    if config.intermediate_size % tp != 0:
        raise ValueError(
            f"model_parallel={tp} must divide intermediate_size={config.intermediate_size}"
        )
    if config.num_heads % tp != 0:
        raise ValueError(f"model_parallel={tp} must divide num_heads={config.num_heads}")


def shard(t: torch.Tensor, dim: int | None, tp: int, rank: int) -> torch.Tensor:
    """Block ``rank`` of ``tp`` along ``dim`` (a copy; ``t`` itself when
    ``dim`` is None)."""
    if dim is None or tp == 1:
        return t
    return t.chunk(tp, dim=dim)[rank].clone()


def shard_params(params: Params, config: TowerConfig, tp: int, rank: int) -> Params:
    """Model rank ``rank``'s slice of a full param tree."""
    validate_tp(config, tp)
    specs = param_specs(config, tp > 1)
    return {
        group: {k: shard(t, specs[group][k], tp, rank) for k, t in leaves.items()}
        for group, leaves in params.items()
    }


def gather_params(shards: list[Params]) -> Params:
    """The full param tree from every model rank's slice, in rank order."""
    first = shards[0]
    out = {}
    for group, leaves in first.items():
        out[group] = {}
        for k, t in leaves.items():
            dim = split_dim(f"{group}/{k}")
            parts = [s[group][k] for s in shards]
            out[group][k] = t if dim is None or len(parts) == 1 else torch.cat(parts, dim=dim)
    return out
