"""Multi-head attention: plain versions and kernel wrappers.

Counterpart of the JAX package's ``ops/attention.py``: ``multi_head_attention``
there runs the Pallas TPU kernel ``_attn_kernel`` under a custom_vjp that
saves only q, k, v and the mask and whose backward is the recompute kernel
``_attn_bwd_kernel``. Here the same pair is a ``torch.autograd.Function``:
its forward launches ``csrc/attention.cu``'s forward (K6) and its backward
the same source's backward (K7) for tensors on the GPU; a CPU tensor takes
the plain versions, ``multi_head_attention_reference`` (the math of JAX
``_attention_math``) and ``multi_head_attention_backward_reference`` (the
math of ``_attn_bwd_kernel``).

Layout as in the JAX package: q, k, v are ``[batch, heads, seq, head_dim]``
and ``mask`` is ``[batch, seq]`` with 1 = real token, applied as a key bias
of ``(1 - mask) * -1e9``. The softmax runs in f32 and P is normalised before
it is cast to the value dtype for the PV product.
"""

from __future__ import annotations

import ctypes

import torch

from instacart_next_order_recommendation_tpu_torch.ops import _build

_NEG_INF = -1e9
KERNEL_HEAD_DIMS = (16, 32, 64, 128)


def _key_bias(mask: torch.Tensor) -> torch.Tensor:
    return (1.0 - mask.to(torch.float32)) * _NEG_INF


def multi_head_attention_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: torch.Tensor, scale: float
) -> torch.Tensor:
    """Plain version of the forward, on any device and dtype: f32 logits
    from the operands, f32 softmax, P cast to v's dtype, PV summed in f32,
    output in q's dtype."""
    f32 = torch.float32
    logits = (q.to(f32) @ k.to(f32).transpose(-1, -2)) * scale
    logits = logits + _key_bias(mask)[:, None, None, :]
    # The max only shifts the exponent; no gradient flows through it.
    p = torch.exp(logits - logits.amax(dim=-1, keepdim=True).detach())
    p = p / p.sum(dim=-1, keepdim=True)
    return (p.to(v.dtype).to(f32) @ v.to(f32)).to(q.dtype)


def multi_head_attention_backward_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: torch.Tensor,
    do: torch.Tensor,
    scale: float,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the backward: P recomputed in f32, then
    dV = P^T dO, dP = dO V^T, D = rowsum(P * dP), dS = P * (dP - D),
    dQ = scale dS K, dK = scale dS^T Q, all on f32 operands; each gradient
    in its input's dtype."""
    f32 = torch.float32
    q32, k32, v32, do32 = (t.to(f32) for t in (q, k, v, do))
    logits = (q32 @ k32.transpose(-1, -2)) * scale + _key_bias(mask)[:, None, None, :]
    p = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    dv = p.transpose(-1, -2) @ do32
    dp = do32 @ v32.transpose(-1, -2)
    ds = p * (dp - (p * dp).sum(dim=-1, keepdim=True))
    dq = (ds @ k32) * scale
    dk = (ds.transpose(-1, -2) @ q32) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


_STRIDES = ctypes.POINTER(ctypes.c_longlong)
_SIGNATURES = {
    "attention_forward": [ctypes.c_void_p] * 5 + [_STRIDES] + [ctypes.c_int] * 4
    + [ctypes.c_float, ctypes.c_void_p],
    "attention_backward": [ctypes.c_void_p] * 9 + [_STRIDES] + [ctypes.c_int] * 4
    + [ctypes.c_float, ctypes.c_void_p],
}


def _check_operand(name: str, t: torch.Tensor, shape: tuple, device: torch.device) -> None:
    if tuple(t.shape) != shape or t.dtype != torch.bfloat16 or t.device != device:
        raise ValueError(
            f"attention kernel: {name} must be bfloat16 {shape} on {device}, "
            f"got {t.dtype} {tuple(t.shape)} on {t.device}"
        )
    if t.stride(3) != 1 or any(s % 8 for s in t.stride()[:3]) or t.data_ptr() % 16:
        raise ValueError(
            f"attention kernel: {name} needs a contiguous head dim, strides that are "
            f"multiples of 8 and a 16-byte aligned start; got strides {t.stride()}"
        )


def _kernel_inputs(q, k, v, mask, others=()) -> torch.Tensor:
    """Checks what the kernels take and returns the f32 key bias."""
    if q.dim() != 4:
        raise ValueError(f"attention kernel takes [B, heads, S, D], got {tuple(q.shape)}")
    b, h, s, d = q.shape
    if d not in KERNEL_HEAD_DIMS or s < 1 or not 1 <= b <= 65535 or not 1 <= h <= 65535:
        raise ValueError(
            f"attention kernel takes head_dim in {KERNEL_HEAD_DIMS}, 1 <= B <= 65535; "
            f"got B={b}, heads={h}, S={s}, D={d}"
        )
    for name, t in (("q", q), ("k", k), ("v", v), *others):
        _check_operand(name, t, (b, h, s, d), q.device)
    if tuple(mask.shape) != (b, s) or mask.device != q.device:
        raise ValueError(f"attention kernel: mask must be [{b}, {s}] on {q.device}")
    return _key_bias(mask).contiguous()


def _strides(*tensors) -> ctypes.Array:
    return (ctypes.c_longlong * (3 * len(tensors)))(*(s for t in tensors for s in t.stride()[:3]))


def _empty_like_heads(q: torch.Tensor) -> torch.Tensor:
    """A ``[B, heads, S, D]`` view over ``[B, S, heads, D]`` memory: what the
    layer reshapes back to ``[B, S, hidden]`` without a copy."""
    b, h, s, d = q.shape
    return torch.empty((b, s, h, d), dtype=q.dtype, device=q.device).permute(0, 2, 1, 3)


def _forward(q, k, v, mask, scale):
    if q.device.type == "cpu":
        return multi_head_attention_reference(q, k, v, mask, scale)
    if q.device.type != "cuda":
        raise ValueError(f"multi_head_attention: no kernel for device {q.device}")
    bias = _kernel_inputs(q, k, v, mask)
    b, h, s, d = q.shape
    out = _empty_like_heads(q)
    lib = _build.load("attention", _SIGNATURES)
    p = _build.ptr
    err = lib.attention_forward(
        p(q), p(k), p(v), p(bias), p(out), _strides(q, k, v, out), b, h, s, d, scale,
        _build.stream_of(q),
    )
    _build.check(lib, err, "attention_forward")
    _build.count(multi_head_attention)
    return out


def multi_head_attention_backward(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: torch.Tensor,
    do: torch.Tensor,
    scale: float,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dq, dk, dv)`` for upstream gradient ``do``. A CPU tensor takes the
    plain version; a CUDA tensor launches K7 or raises on what it does not
    take."""
    if q.device.type == "cpu":
        return multi_head_attention_backward_reference(q, k, v, mask, do, scale)
    if q.device.type != "cuda":
        raise ValueError(f"multi_head_attention_backward: no kernel for device {q.device}")
    if do.stride(3) != 1 or any(st % 8 for st in do.stride()[:3]) or do.data_ptr() % 16:
        do = do.contiguous()
    bias = _kernel_inputs(q, k, v, mask, (("do", do),))
    b, h, s, d = q.shape
    dq, dk, dv = (_empty_like_heads(q) for _ in range(3))
    stats = torch.empty((3, b, h, s), dtype=torch.float32, device=q.device)
    lib = _build.load("attention", _SIGNATURES)
    p = _build.ptr
    err = lib.attention_backward(
        p(q), p(k), p(v), p(bias), p(do), p(dq), p(dk), p(dv), p(stats),
        _strides(q, k, v, do, dq, dk, dv), b, h, s, d, scale, _build.stream_of(q),
    )
    _build.check(lib, err, "attention_backward")
    _build.count(multi_head_attention_backward)
    return dq, dk, dv


multi_head_attention_backward.launches = 0


class _Attention(torch.autograd.Function):
    """K6 forward, K7 backward (the plain versions on the CPU). Saves only
    q, k, v and the mask, as the JAX custom_vjp does."""

    @staticmethod
    def forward(ctx, q, k, v, mask, scale):
        ctx.scale = scale
        ctx.save_for_backward(q, k, v, mask)
        return _forward(q, k, v, mask, scale)

    @staticmethod
    def backward(ctx, do):
        q, k, v, mask = ctx.saved_tensors
        dq, dk, dv = multi_head_attention_backward(q, k, v, mask, do, ctx.scale)
        return dq, dk, dv, None, None


def multi_head_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: torch.Tensor,
    scale: float,
) -> torch.Tensor:
    """Differentiable attention over ``[B, heads, S, D]`` with a key-padding
    mask ``[B, S]``. A CPU tensor takes the plain versions; a CUDA tensor
    launches the kernels (bf16, head_dim in ``KERNEL_HEAD_DIMS``, any S) or
    raises on what they do not take."""
    return _Attention.apply(q, k, v, mask, scale)


multi_head_attention.launches = 0
