"""The ModernBERT layer (pre-norm, RoPE, global or banded attention,
GeGLU): plain versions and kernel wrappers.

No JAX counterpart: the JAX package has only BERT's post-LN layer. The
layer's equations are ``answerdotai/ModernBERT-base``'s (transformers'
``modeling_modernbert.py``), on an f32 residual stream:

    h    = LN_attn(x)                  (layer 0: x, no norm)
    q, k, v = h Wqkv;  q, k = rope_theta(q), rope_theta(k)
    x'   = x + softmax(scale q k^T + keybias [band]) v  Wo
    y    = x' + (gelu(a) * g) Wo_mlp,  [a | g] = LN_mlp(x') Wi

with LayerNorms without bias, no bias on any product, and the band (keys
with ``|i - j| <= half``) on every layer that is not global. The plain
versions (``*_reference``) compute it in the dtype of the layer's weights:
every product's operands in that dtype and its sum in f32, the softmax,
RoPE, the norms and the residual stream in f32, and the values the kernels
store rounded to that dtype at the kernels' points (h, q, k, v after RoPE,
P, the attention output, a and g, the GeGLU output). In f32 they are the
published equations exactly. The entry points launch ``csrc/modernbert.cu``
for a CUDA tensor (its products on K1's GEMM core) and take the plain
version for a CPU tensor.

The attention wrappers count, while spans record (``utils/profiling.py``),
the (query, key) pairs of each launch: ``attn.pairs.full`` (rows x S^2, every
layer), ``attn.pairs.global`` (rows x S^2 on global layers) and
``attn.pairs.window`` (rows x the in-range pairs of the key tiles a banded
launch schedules).
"""

from __future__ import annotations

import ctypes
import math

import torch

from instacart_next_order_recommendation_tpu_torch.ops import _build
from instacart_next_order_recommendation_tpu_torch.ops.fused_layer import _gelu_exact
from instacart_next_order_recommendation_tpu_torch.utils.profiling import count

HEAD_DIM = 64  # the one head_dim the kernels take (ModernBERT's)
TILE = 64  # query rows and keys a tile of the attention kernels
_NEG_INF = -1e9  # key bias at padded keys, as K1's
NORM_WEIGHTS = ("attn_ln_s", "mlp_ln_s")  # f32; layer 0's attn_ln_s is None

_SIGNATURES = {
    "modernbert_layer_forward": [ctypes.c_void_p] * 17 + [ctypes.c_int] * 6
    + [ctypes.c_float] * 2 + [ctypes.c_void_p],
    "modernbert_attention": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_float]
    + [ctypes.c_void_p],
    "modernbert_rownorm": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_float]
    + [ctypes.c_void_p],
}

_tables: dict[tuple, tuple[torch.Tensor, torch.Tensor]] = {}


def rope_tables(seq: int, theta: float, device, head_dim: int = HEAD_DIM):
    """f32 ``(cos, sin)``, each ``[seq, head_dim / 2]``: the angles of
    positions 0..seq-1 at the frequencies theta^(-2j / head_dim), computed as
    transformers' ModernBERT computes them (an f32 outer product). Kept per
    (seq, theta, device)."""
    key = (int(seq), float(theta), str(device), int(head_dim))
    got = _tables.get(key)
    if got is None:
        inv = 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.int64).float() / head_dim))
        freqs = torch.arange(seq, dtype=torch.int64).float()[:, None] * inv[None, :]
        got = (freqs.cos().to(device).contiguous(), freqs.sin().to(device).contiguous())
        _tables[key] = got
    return got


def key_bias(mask: torch.Tensor) -> torch.Tensor:
    """f32 ``[B, S]``: 0 at real keys, -1e9 at padded ones."""
    return ((1.0 - mask.to(torch.float32)) * _NEG_INF).contiguous()


def window_pairs(seq: int, half: int) -> int:
    """The in-range (query, key) pairs of one row that a banded launch
    schedules: for each 64-query tile, the keys of the 64-key tiles that
    meet the band of any of its queries, both cut at ``seq``."""
    total = 0
    n_tiles = -(-seq // TILE)
    for qt in range(n_tiles):
        q0 = qt * TILE
        lo = max(0, q0 - half) // TILE
        hi = min(n_tiles, (q0 + TILE - 1 + half) // TILE + 1)
        total += (min(seq, q0 + TILE) - q0) * (min(seq, hi * TILE) - lo * TILE)
    return total


def count_pairs(rows: int, seq: int, half: int) -> None:
    """The attention counters of one launch (``half < 0``: global)."""
    full = rows * seq * seq
    count("attn.pairs.full", full)
    if half < 0:
        count("attn.pairs.global", full)
    else:
        count("attn.pairs.window", rows * window_pairs(seq, half))


def _dot(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return a.to(torch.float32) @ w.to(torch.float32)


def _norm(x: torch.Tensor, scale: torch.Tensor | None, eps: float) -> torch.Tensor:
    """LayerNorm without bias in f32 (``scale`` None: x unchanged)."""
    if scale is None:
        return x
    mean = x.mean(dim=-1, keepdim=True)
    cent = x - mean
    var = (cent * cent).mean(dim=-1, keepdim=True)
    return cent * torch.rsqrt(var + eps) * scale


def rope_reference(t: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """``t`` ``[B, heads, S, 64]`` rotated: (x1, x2) -> (x1 c - x2 s, x2 c + x1 s)
    in f32, x1 and x2 the two halves of each head (transformers'
    ``rotate_half`` form), returned in ``t``'s dtype."""
    half = t.shape[-1] // 2
    x1, x2 = t[..., :half].to(torch.float32), t[..., half:].to(torch.float32)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(t.dtype)


def attention_reference(qkv: torch.Tensor, mask: torch.Tensor, cos: torch.Tensor,
                        sin: torch.Tensor, *, num_heads: int, half: int) -> torch.Tensor:
    """Attention of the packed projection ``qkv`` ``[B, S, 3H]`` (before
    RoPE), in its dtype: ``[B, S, H]``. The softmax in f32 over the keys the
    mask keeps and, where ``half >= 0``, within ``half`` of the query; P in
    qkv's dtype for the P V product, divided by the f32 row sum after it (the
    kernel's cast points). One head at a time, so that S = 8,192 fits."""
    b, s, h3 = qkv.shape
    h = h3 // 3
    hd = h // num_heads
    cdt = qkv.dtype

    def heads(i):
        return qkv[..., i * h : (i + 1) * h].reshape(b, s, num_heads, hd).permute(0, 2, 1, 3)

    q, k = rope_reference(heads(0), cos, sin), rope_reference(heads(1), cos, sin)
    v = heads(2)
    bias = key_bias(mask)[:, None, :]
    pos = torch.arange(s, device=qkv.device)
    outside = (pos[:, None] - pos[None, :]).abs() > half if half >= 0 else None
    out = torch.empty(b, num_heads, s, hd, dtype=cdt, device=qkv.device)
    scale = 1.0 / math.sqrt(hd)
    for i in range(num_heads):
        logits = (q[:, i].to(torch.float32) @ k[:, i].to(torch.float32).transpose(-1, -2))
        logits = logits * scale + bias
        if outside is not None:
            logits = logits.masked_fill(outside, float("-inf"))
        p = torch.exp(logits - logits.amax(dim=-1, keepdim=True).detach())
        o = (p.to(cdt).to(torch.float32) @ v[:, i].to(torch.float32)) / p.sum(-1, keepdim=True)
        out[:, i] = o.to(cdt)
    return out.permute(0, 2, 1, 3).reshape(b, s, h)


def layer_reference(x: torch.Tensor, mask: torch.Tensor, layer: dict, *, num_heads: int,
                    eps: float, theta: float, half: int) -> torch.Tensor:
    """One ModernBERT layer on the f32 residual ``x`` ``[B, S, H]``, with
    ``layer`` a ``prepare_layer`` dict (its products' dtype is the compute
    dtype). Differentiable through plain operations."""
    b, s, h = x.shape
    cdt = layer["qkv_w"].dtype
    cos, sin = rope_tables(s, theta, x.device)
    hin = _norm(x, layer["attn_ln_s"], eps).to(cdt)
    qkv = _dot(hin, layer["qkv_w"]).to(cdt)
    attn = attention_reference(qkv, mask, cos, sin, num_heads=num_heads, half=half)
    x = x + _dot(attn, layer["o_w"])
    ag = _dot(_norm(x, layer["mlp_ln_s"], eps).to(cdt), layer["wi"]).to(cdt)
    inter = ag.shape[-1] // 2
    u = (_gelu_exact(ag[..., :inter].to(torch.float32)) * ag[..., inter:].to(torch.float32))
    return x + _dot(u.to(cdt), layer["wo_mlp"])


def prepare_layer(layer: dict, dtype: torch.dtype, first: bool) -> dict:
    """Kernel-layout weights of one layer from its checkpoint tensors: the
    products in the compute dtype, the norms' scales in f32 (layer 0 has no
    attention norm)."""
    return {
        "qkv_w": layer["qkv_w"].to(dtype).contiguous(),
        "o_w": layer["o_w"].to(dtype).contiguous(),
        "wi": layer["wi"].to(dtype).contiguous(),
        "wo_mlp": layer["wo_mlp"].to(dtype).contiguous(),
        "attn_ln_s": None if first else layer["attn_ln_scale"].to(torch.float32).contiguous(),
        "mlp_ln_s": layer["mlp_ln_scale"].to(torch.float32).contiguous(),
    }


def _check_aligned(name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple, device) -> None:
    if tuple(t.shape) != tuple(shape) or t.dtype != dtype or t.device != device:
        raise ValueError(f"modernbert: {name} must be {dtype} {tuple(shape)} on {device}, "
                         f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"modernbert: {name} must be contiguous and 16-byte aligned")


def _check_widths(h: int, num_heads: int, inter: int | None = None) -> None:
    if num_heads <= 0 or h != num_heads * HEAD_DIM or h % 128 or h > 1024 or (
        inter is not None and inter % 64
    ):
        raise ValueError(
            f"modernbert kernels take head_dim {HEAD_DIM}, hidden % 128 == 0 (<= 1024) and "
            f"intermediate % 64 == 0; got hidden={h}, heads={num_heads}, intermediate={inter}"
        )


def modernbert_layer(x: torch.Tensor, mask: torch.Tensor, layer: dict, *, num_heads: int,
                     eps: float, theta: float, half: int) -> torch.Tensor:
    """One ModernBERT layer: f32 ``x`` ``[B, S, H]`` -> f32 ``[B, S, H]``.
    ``half``: the band's half-width, or -1 for a global layer. A CPU tensor
    takes the plain version; a CUDA tensor launches ``csrc/modernbert.cu``
    (bf16 weights), or raises on what it does not take."""
    b, s, h = x.shape
    count_pairs(b, s, half)
    if x.device.type == "cpu":
        return layer_reference(x, mask, layer, num_heads=num_heads, eps=eps, theta=theta,
                               half=half)
    if x.device.type != "cuda":
        raise ValueError(f"modernbert_layer: no kernel for device {x.device}")
    inter = layer["wi"].shape[1] // 2
    _check_widths(h, num_heads, inter)
    dev = x.device
    _check_aligned("x", x, torch.float32, (b, s, h), dev)
    shapes = {"qkv_w": (h, 3 * h), "o_w": (h, h), "wi": (h, 2 * inter), "wo_mlp": (inter, h)}
    for name, shape in shapes.items():
        _check_aligned(name, layer[name], torch.bfloat16, shape, dev)
    for name in NORM_WEIGHTS:
        if layer[name] is not None:
            _check_aligned(name, layer[name], torch.float32, (h,), dev)
    bias = key_bias(mask)
    cos, sin = rope_tables(s, theta, dev)
    m = b * s
    bf = {"dtype": torch.bfloat16, "device": dev}
    hbuf, attn = torch.empty((m, h), **bf), torch.empty((m, h), **bf)
    qkv, ag, u = (torch.empty((m, n), **bf) for n in (3 * h, 2 * inter, inter))
    x_mid, y = torch.empty_like(x), torch.empty_like(x)
    lib = _build.load("modernbert", _SIGNATURES)
    p = _build.ptr
    ln = layer["attn_ln_s"]
    err = lib.modernbert_layer_forward(
        p(x), p(bias), p(cos), p(sin), None if ln is None else p(ln), p(layer["qkv_w"]),
        p(layer["o_w"]), p(layer["mlp_ln_s"]), p(layer["wi"]), p(layer["wo_mlp"]),
        p(hbuf), p(qkv), p(attn), p(x_mid), p(ag), p(u), p(y),
        b, s, h, num_heads, inter, half, 1.0 / math.sqrt(HEAD_DIM), eps, _build.stream_of(x),
    )
    _build.check(lib, err, "modernbert_layer_forward")
    _build.count(modernbert_layer)
    return y


modernbert_layer.launches = 0


def modernbert_attention(qkv: torch.Tensor, mask: torch.Tensor, *, num_heads: int, theta: float,
                         half: int) -> torch.Tensor:
    """The layer's attention alone: RoPE on q and k of ``qkv`` ``[B, S, 3H]``
    (before RoPE, bf16 on the card; not modified), then attention, global
    (``half`` -1) or banded: ``[B, S, H]``."""
    b, s, h3 = qkv.shape
    h = h3 // 3
    count_pairs(b, s, half)
    cos, sin = rope_tables(s, theta, qkv.device)
    if qkv.device.type == "cpu":
        return attention_reference(qkv, mask, cos, sin, num_heads=num_heads, half=half)
    if qkv.device.type != "cuda":
        raise ValueError(f"modernbert_attention: no kernel for device {qkv.device}")
    _check_widths(h, num_heads)
    _check_aligned("qkv", qkv, torch.bfloat16, (b, s, h3), qkv.device)
    work = qkv.clone()  # RoPE runs in place
    out = torch.empty((b, s, h), dtype=torch.bfloat16, device=qkv.device)
    bias = key_bias(mask)
    lib = _build.load("modernbert", _SIGNATURES)
    p = _build.ptr
    err = lib.modernbert_attention(p(work), p(bias), p(cos), p(sin), p(out), b, s, h, num_heads,
                                   half, 1.0 / math.sqrt(HEAD_DIM), _build.stream_of(qkv))
    _build.check(lib, err, "modernbert_attention")
    _build.count(modernbert_attention)
    return out


modernbert_attention.launches = 0


def modernbert_final_norm(x: torch.Tensor, scale: torch.Tensor, *, eps: float,
               dtype: torch.dtype) -> torch.Tensor:
    """The final LayerNorm (no bias) of the f32 residual, in ``dtype``. A
    CPU tensor takes the plain version; a CUDA tensor launches the row
    kernel (``dtype`` bf16)."""
    if x.device.type == "cpu":
        return _norm(x, scale, eps).to(dtype)
    if x.device.type != "cuda":
        raise ValueError(f"modernbert final_norm: no kernel for device {x.device}")
    b, s, h = x.shape
    _check_widths(h, h // HEAD_DIM)
    if dtype != torch.bfloat16:
        raise ValueError(f"modernbert final_norm: the kernel writes bfloat16, not {dtype}")
    _check_aligned("x", x, torch.float32, (b, s, h), x.device)
    _check_aligned("scale", scale, torch.float32, (h,), x.device)
    y = torch.empty((b, s, h), dtype=torch.bfloat16, device=x.device)
    lib = _build.load("modernbert", _SIGNATURES)
    p = _build.ptr
    err = lib.modernbert_rownorm(p(x), p(scale), p(y), b * s, h, eps, _build.stream_of(x))
    _build.check(lib, err, "modernbert_rownorm")
    _build.count(modernbert_final_norm)
    return y


modernbert_final_norm.launches = 0
