"""Fused post-LN BERT encoder layer (inference): plain version and kernel wrapper.

Counterpart of the JAX package's ``ops/fused_layer.py``: ``fused_encoder_layer``
there runs the Pallas TPU kernel ``_kernel``, and ``_oracle`` is its jnp
mirror. Here ``fused_encoder_layer_reference`` is the plain PyTorch version of
the same math, and ``fused_encoder_layer`` launches the hand-written CUDA
kernels in ``csrc/fused_layer.cu`` for a tensor on the GPU. Cast points
follow ``_kernel``: matmuls accumulate in f32 over compute-dtype operands, the
softmax is f32 with 1/sum applied after the PV product, residual adds happen
in the compute dtype, and LayerNorm runs in f32.
"""

from __future__ import annotations

import ctypes

import torch

from instacart_next_order_recommendation_tpu_torch.ops import _build

_NEG_INF = -1e9  # key bias at padded keys: finite, so all-pad rows stay finite
HEAD_DIM = 32
MAX_SEQ = 256


def _gelu_exact(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * x * (1.0 + torch.erf(x * 0.7071067811865476))


def prepare_layer(layer: dict, dtype: torch.dtype) -> dict:
    """Kernel-layout weights of one layer: Q/K/V concatenated, matrices and
    their biases in the compute dtype, LayerNorm parameters in f32."""
    return {
        "qkv_w": torch.cat([layer["q_w"], layer["k_w"], layer["v_w"]], dim=1)
        .to(dtype)
        .contiguous(),
        "qkv_b": torch.cat([layer["q_b"], layer["k_b"], layer["v_b"]]).to(dtype).contiguous(),
        "o_w": layer["o_w"].to(dtype).contiguous(),
        "o_b": layer["o_b"].to(dtype).contiguous(),
        "ln1_s": layer["attn_ln_scale"].to(torch.float32).contiguous(),
        "ln1_b": layer["attn_ln_bias"].to(torch.float32).contiguous(),
        "w1": layer["ffn_w1"].to(dtype).contiguous(),
        "b1": layer["ffn_b1"].to(dtype).contiguous(),
        "w2": layer["ffn_w2"].to(dtype).contiguous(),
        "b2": layer["ffn_b2"].to(dtype).contiguous(),
        "ln2_s": layer["ffn_ln_scale"].to(torch.float32).contiguous(),
        "ln2_b": layer["ffn_ln_bias"].to(torch.float32).contiguous(),
    }


def _prep_inputs(
    x: torch.Tensor, mask: torch.Tensor, layer: dict
) -> tuple[torch.Tensor, dict]:
    """f32 key bias ``[B, S]`` (-1e9 at pads) and the kernel-layout weights.
    ``layer`` is either a raw layer dict (``q_w``, ...) or one that
    ``prepare_layer`` already made."""
    bias = ((1.0 - mask.to(torch.float32)) * _NEG_INF).contiguous()
    weights = layer if "qkv_w" in layer else prepare_layer(layer, x.dtype)
    return bias, weights


def _layer_norm(res: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor, eps: float):
    mean = res.mean(dim=-1, keepdim=True)
    cent = res - mean
    var = (cent * cent).mean(dim=-1, keepdim=True)
    return cent * torch.rsqrt(var + eps) * scale + shift


def _reference_core(x, bias, w, *, num_heads, scale, eps):
    cdt = x.dtype
    f32 = torch.float32
    b, s, h = x.shape
    hd = h // num_heads
    x2 = x.reshape(b * s, h)

    def dot(a, m):
        return a.to(f32) @ m.to(f32)

    qkv = (dot(x2, w["qkv_w"]) + w["qkv_b"].to(f32)).to(cdt).reshape(b, s, 3 * h)

    def heads(t):
        return t.reshape(b, s, num_heads, hd).permute(0, 2, 1, 3).to(f32)

    q, k, v = (heads(qkv[..., i * h : (i + 1) * h]) for i in range(3))
    logits = (q @ k.transpose(-1, -2)) * scale + bias[:, None, None, :]
    p = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    z = p.sum(dim=-1, keepdim=True)
    out = (p.to(cdt).to(f32) @ v) / z
    attn = out.permute(0, 2, 1, 3).reshape(b * s, h).to(cdt)

    ao = (dot(attn, w["o_w"]) + w["o_b"].to(f32)).to(cdt)
    x1 = _layer_norm((x2 + ao).to(f32), w["ln1_s"], w["ln1_b"], eps).to(cdt)
    hid = _gelu_exact(dot(x1, w["w1"]) + w["b1"].to(f32)).to(cdt)
    f = (dot(hid, w["w2"]) + w["b2"].to(f32)).to(cdt)
    y = _layer_norm((x1 + f).to(f32), w["ln2_s"], w["ln2_b"], eps).to(cdt)
    return y.reshape(b, s, h)


def fused_encoder_layer_reference(
    x: torch.Tensor, mask: torch.Tensor, layer: dict, *, num_heads: int, scale: float, eps: float
) -> torch.Tensor:
    """Plain PyTorch version of one layer, on any device and dtype.

    x: ``[B, S, hidden]`` in the compute dtype; mask: ``[B, S]``, 1 = real.
    """
    bias, w = _prep_inputs(x, mask, layer)
    return _reference_core(x, bias, w, num_heads=num_heads, scale=scale, eps=eps)


_SIGNATURES = {
    "fused_layer_forward": [ctypes.c_void_p] * 20
    + [ctypes.c_int] * 5
    + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p],
}


def _check_kernel_inputs(x: torch.Tensor, bias: torch.Tensor, w: dict, num_heads: int) -> None:
    b, s, h = x.shape
    inter = w["w1"].shape[1]
    if x.dtype != torch.bfloat16:
        raise ValueError(f"fused_encoder_layer kernel takes bfloat16, got {x.dtype}")
    if h != num_heads * HEAD_DIM or h % 64 or h > 1024 or inter % 64:
        raise ValueError(
            f"fused_encoder_layer kernel takes head_dim {HEAD_DIM}, hidden % 64 == 0 "
            f"(<= 1024) and intermediate % 64 == 0; got hidden={h}, heads={num_heads}, "
            f"intermediate={inter}"
        )
    if s % 16 or not 16 <= s <= MAX_SEQ:
        raise ValueError(f"fused_encoder_layer kernel takes 16 <= S <= {MAX_SEQ}, S % 16 == 0; got {s}")
    if not 1 <= b <= 65535:
        raise ValueError(f"fused_encoder_layer kernel takes 1 <= B <= 65535; got {b}")
    expected = {
        "qkv_w": (h, 3 * h), "qkv_b": (3 * h,), "o_w": (h, h), "o_b": (h,),
        "w1": (h, inter), "b1": (inter,), "w2": (inter, h), "b2": (h,),
        "ln1_s": (h,), "ln1_b": (h,), "ln2_s": (h,), "ln2_b": (h,),
    }
    for name, shape in expected.items():
        t = w[name]
        want = torch.float32 if name.startswith("ln") else torch.bfloat16
        if tuple(t.shape) != shape or t.dtype != want or t.device != x.device:
            raise ValueError(
                f"fused_encoder_layer: {name} must be {want} {shape} on {x.device}, "
                f"got {t.dtype} {tuple(t.shape)} on {t.device}"
            )
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"fused_encoder_layer: {name} must be contiguous and 16-byte aligned")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("fused_encoder_layer: x must be contiguous and 16-byte aligned")


def _launch(x, bias, w, *, num_heads, scale, eps):
    b, s, h = x.shape
    inter = w["w1"].shape[1]
    m = b * s
    new = {"dtype": x.dtype, "device": x.device}
    qkv = torch.empty((m, 3 * h), **new)
    attn = torch.empty((m, h), **new)
    tmp = torch.empty((m, h), **new)
    x1 = torch.empty((m, h), **new)
    hid = torch.empty((m, inter), **new)
    y = torch.empty_like(x)
    lib = _build.load("fused_layer", _SIGNATURES)
    p = _build.ptr
    err = lib.fused_layer_forward(
        p(x), p(bias), p(w["qkv_w"]), p(w["qkv_b"]), p(w["o_w"]), p(w["o_b"]),
        p(w["ln1_s"]), p(w["ln1_b"]), p(w["w1"]), p(w["b1"]), p(w["w2"]), p(w["b2"]),
        p(w["ln2_s"]), p(w["ln2_b"]), p(qkv), p(attn), p(tmp), p(x1), p(hid), p(y),
        b, s, h, num_heads, inter, scale, eps, _build.stream_of(x),
    )
    _build.check(lib, err, "fused_layer_forward")
    return y


def fused_encoder_layer(
    x: torch.Tensor, mask: torch.Tensor, layer: dict, *, num_heads: int, scale: float, eps: float
) -> torch.Tensor:
    """One post-LN BERT encoder layer. A CPU tensor takes the plain version;
    a CUDA tensor launches the kernel, or raises on what it does not take."""
    bias, w = _prep_inputs(x, mask, layer)
    if x.device.type == "cpu":
        return _reference_core(x, bias, w, num_heads=num_heads, scale=scale, eps=eps)
    if x.device.type != "cuda":
        raise ValueError(f"fused_encoder_layer: no kernel for device {x.device}")
    _check_kernel_inputs(x, bias, w, num_heads)
    y = _launch(x, bias, w, num_heads=num_heads, scale=scale, eps=eps)
    fused_encoder_layer.launches += 1
    return y


fused_encoder_layer.launches = 0
