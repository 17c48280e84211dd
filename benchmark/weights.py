"""The tower's weights, made from the seed on the run's device.

One generator on the device and one draw for all the matrices: BERT's
truncated normal (std 0.02, cut at two deviations), biases zero and
LayerNorm scales one, in float32, the type the program keeps its master
copy in (it casts its own bf16 copies). Called once for the program and
again, after the program's state is freed, for the reference, so the two
get the same numbers and share no tensor.
"""

from __future__ import annotations

import math

import torch

STD = 0.02


def leaf_shapes(cfg: dict) -> dict:
    """The checkpoint layout's tensors and their shapes."""
    h, inter, n = cfg["hidden_size"], cfg["intermediate_size"], cfg["num_hidden_layers"]
    return {
        "embeddings": {
            "word": (cfg["vocab_size"], h),
            "position": (cfg["max_position_embeddings"], h),
            "token_type": (cfg["type_vocab_size"], h),
            "ln_scale": (h,), "ln_bias": (h,),
        },
        "layers": {
            "q_w": (n, h, h), "q_b": (n, h), "k_w": (n, h, h), "k_b": (n, h),
            "v_w": (n, h, h), "v_b": (n, h), "o_w": (n, h, h), "o_b": (n, h),
            "attn_ln_scale": (n, h), "attn_ln_bias": (n, h),
            "ffn_w1": (n, h, inter), "ffn_b1": (n, inter),
            "ffn_w2": (n, inter, h), "ffn_b2": (n, h),
            "ffn_ln_scale": (n, h), "ffn_ln_bias": (n, h),
        },
    }


def _is_matrix(group: str, name: str) -> bool:
    return group == "embeddings" and name in ("word", "position", "token_type") or name.endswith(
        ("_w", "_w1", "_w2")
    )


def make(cfg: dict, seed: int, device: torch.device) -> dict:
    """The weights for ``seed``: the same numbers on every call on one kind
    of device."""
    shapes = leaf_shapes(cfg)
    sizes = [
        math.prod(shape)
        for group, leaves in shapes.items()
        for name, shape in leaves.items()
        if _is_matrix(group, name)
    ]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
    hi = 0.5 * (1.0 + math.erf(2.0 / math.sqrt(2.0)))
    u = torch.rand(sum(sizes), generator=gen, device=device, dtype=torch.float32)
    z = torch.erfinv(u.mul_(hi - lo).add_(lo).mul_(2.0).sub_(1.0)).mul_(math.sqrt(2.0) * STD)
    z = z.clamp_(-2.0 * STD, 2.0 * STD)
    parts = iter(z.split(sizes))
    out: dict = {}
    for group, leaves in shapes.items():
        out[group] = {}
        for name, shape in leaves.items():
            if _is_matrix(group, name):
                out[group][name] = next(parts).view(shape)
            elif "scale" in name:
                out[group][name] = torch.ones(shape, device=device)
            else:
                out[group][name] = torch.zeros(shape, device=device)
    return out


def leaves(weights: dict) -> list[tuple[str, torch.Tensor]]:
    """(path, tensor) of every leaf, in sorted path order."""
    return [
        (f"{g}/{n}", weights[g][n]) for g in sorted(weights) for n in sorted(weights[g])
    ]
