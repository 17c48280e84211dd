"""Fused masked mean-pooling + L2 normalisation: plain version and kernel wrapper.

Counterpart of the JAX package's ``ops/pool_norm.py`` (Pallas ``_pool_kernel``).
Sentence-transformers pooling: mean over real tokens with the count clamped
to 1e-9, then p=2 normalisation with the norm clamped to 1e-12.

``hidden`` is ``[batch, seq, dim]``; ``mask`` is ``[batch, seq]`` (1 = real).
The output is ``[batch, dim]``, unit L2 norm, f32. The kernel is
``csrc/pool_norm.cu``. The op is differentiable in ``hidden``: the forward
runs the kernel and the backward is the vjp of the plain version, as the
JAX package's ``_pool_with_ref_grad`` does (it has no backward kernel).
"""

from __future__ import annotations

import ctypes

import torch

from instacart_next_order_recommendation_tpu_torch.ops import _build


def masked_mean_pool_l2norm_reference(hidden: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    m = mask.to(torch.float32)[..., None]
    summed = (hidden.to(torch.float32) * m).sum(dim=1)
    count = m.sum(dim=1).clamp_min(1e-9)
    pooled = summed / count
    norm = torch.linalg.vector_norm(pooled, dim=-1, keepdim=True).clamp_min(1e-12)
    return pooled / norm


_SIGNATURES = {"pool_l2norm": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]}


class _PoolWithPlainGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, hidden, mask):
        ctx.save_for_backward(hidden, mask)
        return _launch(hidden, mask)

    @staticmethod
    def backward(ctx, g):
        hidden, mask = ctx.saved_tensors
        with torch.enable_grad():
            h = hidden.detach().requires_grad_(True)
            (dh,) = torch.autograd.grad(masked_mean_pool_l2norm_reference(h, mask), h, g)
        return dh, None


def masked_mean_pool_l2norm(hidden: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel, or raises on what it does not take."""
    if hidden.device.type == "cpu":
        return masked_mean_pool_l2norm_reference(hidden, mask)
    return _PoolWithPlainGrad.apply(hidden, mask)


def _launch(hidden: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    if hidden.device.type != "cuda":
        raise ValueError(f"masked_mean_pool_l2norm: no kernel for device {hidden.device}")
    if hidden.dim() != 3 or hidden.dtype != torch.bfloat16:
        raise ValueError(
            "masked_mean_pool_l2norm kernel takes [B, S, H] bfloat16, "
            f"got {hidden.dtype} {tuple(hidden.shape)}"
        )
    b, s, h = hidden.shape
    if tuple(mask.shape) != (b, s) or mask.device != hidden.device:
        raise ValueError(f"masked_mean_pool_l2norm: mask must be [{b}, {s}] on {hidden.device}")
    if b < 1 or h > 12288:
        raise ValueError(f"masked_mean_pool_l2norm kernel takes B >= 1, H <= 12288; got {b}, {h}")
    hidden = hidden.contiguous()
    mask = mask.to(torch.int32).contiguous()
    out = torch.empty((b, h), dtype=torch.float32, device=hidden.device)
    lib = _build.load("pool_norm", _SIGNATURES)
    err = lib.pool_l2norm(
        _build.ptr(hidden), _build.ptr(mask), _build.ptr(out), b, s, h, _build.stream_of(hidden),
    )
    _build.check(lib, err, "pool_l2norm")
    masked_mean_pool_l2norm.launches += 1
    return out


masked_mean_pool_l2norm.launches = 0
