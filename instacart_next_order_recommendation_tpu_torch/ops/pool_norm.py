"""Fused masked mean-pooling + L2 normalisation: plain version and kernel wrapper.

Counterpart of the JAX package's ``ops/pool_norm.py`` (Pallas ``_pool_kernel``).
Sentence-transformers pooling: mean over real tokens with the count clamped
to 1e-9, then p=2 normalisation with the norm clamped to 1e-12.

``hidden`` is ``[batch, seq, dim]``; ``mask`` is ``[batch, seq]`` (1 = real).
The output is ``[batch, dim]``, unit L2 norm, f32. The kernel is
``csrc/pool_norm.cu``, in the form ``pool_plan`` picks from the shape. The
op is differentiable in ``hidden``: the forward runs the kernel and the
backward is the vjp of the plain version, as the JAX package's
``_pool_with_ref_grad`` does (it has no backward kernel).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from instacart_next_order_recommendation_tpu_torch.ops import _build


def masked_mean_pool_l2norm_reference(hidden: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    m = mask.to(torch.float32)[..., None]
    summed = (hidden.to(torch.float32) * m).sum(dim=1)
    count = m.sum(dim=1).clamp_min(1e-9)
    pooled = summed / count
    norm = torch.linalg.vector_norm(pooled, dim=-1, keepdim=True).clamp_min(1e-12)
    return pooled / norm


_SIGNATURES = {"pool_l2norm": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 8 + [ctypes.c_void_p]}
MAX_HIDDEN = 12288
MAX_CLUSTER = 8  # the portable thread-block cluster size


class PoolPlan(NamedTuple):
    """A launch of ``csrc/pool_norm.cu``: each batch row's S split over
    ``cluster`` blocks (a thread-block cluster when above 1) of ``chunk``
    token rows each, ``warps`` warps a block, ``rows`` (2 or 4) token rows
    in flight per thread with 16-byte loads (the 2-byte loads keep 8)."""

    cluster: int
    warps: int
    rows: int
    chunk: int


def pool_plan(b: int, s: int, sm_count: int = 132) -> PoolPlan:
    """The kernel's form for a batch of ``b`` rows of ``s`` tokens on a card
    of ``sm_count`` SMs, any hidden width. S is split over a cluster only
    while the blocks stay within half the SMs and each keeps 24 token rows
    or more; then 16 warps with 4 rows in flight where there is one block
    per SM, 12 warps with 2 rows where there are up to two, else 8 with 2.
    Set from cold timings of every form on an H100 at B in {1, ..., 1024},
    S in {32, 96, 192, 256}, H in {384, 768}
    (PERF.md section 6, K2's redesign)."""
    cluster = 1
    while cluster < MAX_CLUSTER and 4 * b * cluster <= sm_count and s // (2 * cluster) >= 24:
        cluster *= 2
    blocks = b * cluster
    warps, rows = (16, 4) if blocks <= sm_count else (12, 2) if blocks <= 2 * sm_count else (8, 2)
    return PoolPlan(cluster, warps, rows, max(1, -(-s // cluster)))


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


def _launch(hidden: torch.Tensor, mask: torch.Tensor, plan: PoolPlan | None = None) -> torch.Tensor:
    """The kernel on ``hidden`` and ``mask``, in ``plan``'s form (by default
    ``pool_plan``'s for the shape)."""
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
    if b < 1 or h > MAX_HIDDEN:
        raise ValueError(
            f"masked_mean_pool_l2norm kernel takes B >= 1, H <= {MAX_HIDDEN}; got {b}, {h}"
        )
    hidden = hidden.contiguous()
    mask = mask.to(torch.int32).contiguous()
    if plan is None:
        sm_count = torch.cuda.get_device_properties(hidden.device).multi_processor_count
        plan = pool_plan(b, s, sm_count)
    vec = 8 if h % 8 == 0 and hidden.data_ptr() % 16 == 0 else 1
    out = torch.empty((b, h), dtype=torch.float32, device=hidden.device)
    lib = _build.load("pool_norm", _SIGNATURES)
    err = lib.pool_l2norm(
        _build.ptr(hidden), _build.ptr(mask), _build.ptr(out), b, s, h, vec, *plan,
        _build.stream_of(hidden),
    )
    _build.check(lib, err, "pool_l2norm")
    _build.count(masked_mean_pool_l2norm)
    return out


masked_mean_pool_l2norm.launches = 0
