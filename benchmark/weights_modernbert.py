"""ModernBERT's weights, made from the seed on the run's device.

One generator on the device and one draw for all the matrices, by
ModernBERT's own init (transformers' ``ModernBertPreTrainedModel._init_weights``):
normals cut at ``initializer_cutoff_factor`` (2) deviations, std
``initializer_range`` (0.02) for the token embeddings and the input
projections (Wqkv, Wi), 0.02 / sqrt(2 L) for the output projections (Wo,
Wo_mlp); the norms' scales one; no biases. In float32. Called once for the
program and again, after the program's state is freed, for the reference,
so the two get the same numbers and share no tensor.
"""

from __future__ import annotations

import math

import torch


def leaf_shapes(cfg: dict) -> dict:
    """The program's checkpoint layout: its tensors, shapes and init stds
    (None: a norm scale, one)."""
    h, inter, n = cfg["hidden_size"], cfg["intermediate_size"], cfg["num_hidden_layers"]
    std = cfg["initializer_range"]
    out = std / math.sqrt(2.0 * n)
    return {
        "embeddings": {"word": ((cfg["vocab_size"], h), std), "ln_scale": ((h,), None)},
        "layers": {
            "qkv_w": ((n, h, 3 * h), std), "o_w": ((n, h, h), out),
            "attn_ln_scale": ((n, h), None), "mlp_ln_scale": ((n, h), None),
            "wi": ((n, h, 2 * inter), std), "wo_mlp": ((n, inter, h), out),
        },
        "final": {"ln_scale": ((h,), None)},
    }


def make(cfg: dict, seed: int, device: torch.device) -> dict:
    """The weights for ``seed``: the same numbers on every call on one kind
    of device."""
    shapes = leaf_shapes(cfg)
    matrices = [(g, n, shape, std) for g, leaves in shapes.items()
                for n, (shape, std) in leaves.items() if std is not None]
    sizes = [math.prod(shape) for _, _, shape, _ in matrices]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    cut = cfg["initializer_cutoff_factor"]
    lo = 0.5 * (1.0 + math.erf(-cut / math.sqrt(2.0)))
    hi = 0.5 * (1.0 + math.erf(cut / math.sqrt(2.0)))
    u = torch.rand(sum(sizes), generator=gen, device=device, dtype=torch.float32)
    z = torch.erfinv(u.mul_(hi - lo).add_(lo).mul_(2.0).sub_(1.0)).mul_(math.sqrt(2.0))
    z = z.clamp_(-cut, cut)
    parts = iter(z.split(sizes))
    out: dict = {g: {} for g in shapes}
    for (g, n, shape, std) in matrices:
        out[g][n] = next(parts).view(shape).mul_(std)
    for g, leaves in shapes.items():
        for n, (shape, std) in leaves.items():
            if std is None:
                out[g][n] = torch.ones(shape, device=device)
    return out
