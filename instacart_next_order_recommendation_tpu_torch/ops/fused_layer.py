"""Fused post-LN BERT encoder layer: plain versions and kernel wrappers.

Counterpart of the JAX package's ``ops/fused_layer.py``: ``fused_encoder_layer``
there runs the Pallas TPU kernel ``_kernel``, ``fused_encoder_layer_train``
runs it with two dropout-mask inputs under a custom_vjp whose backward is
the kernel ``_bwd_kernel``, and ``_oracle`` is the jnp mirror of both.

Here ``fused_encoder_layer_reference`` / ``fused_encoder_layer_train_reference``
are the plain PyTorch versions of the same math (the latter's autograd
gradient is the plain backward, ``fused_encoder_layer_backward_reference``),
and the entry points launch the hand-written CUDA kernels for a tensor on the
GPU: ``csrc/fused_layer.cu`` (K1, forward, with or without masks) and
``csrc/fused_layer_bwd.cu`` (K5, dx and the twelve weight grads), both at
head_dim 32 (MiniLM-class) and 64 (mpnet-base-class). Cast points follow
``_kernel``: matmuls accumulate in f32 over compute-dtype operands, the
softmax is f32 with 1/sum applied after the PV product, residual adds and the
dropout products happen in the compute dtype, and LayerNorm runs in f32.
"""

from __future__ import annotations

import ctypes

import torch

from instacart_next_order_recommendation_tpu_torch.ops import _build

_NEG_INF = -1e9  # key bias at padded keys: finite, so all-pad rows stay finite
HEAD_DIMS = (32, 64)
MAX_SEQ = 256
# Kernel-layout weights in the order the CUDA entry points take them.
WEIGHT_NAMES = (
    "qkv_w", "qkv_b", "o_w", "o_b", "ln1_s", "ln1_b",
    "w1", "b1", "w2", "b2", "ln2_s", "ln2_b",
)


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


def _reference_core(x, bias, w, m1=None, m2=None, *, num_heads, scale, eps):
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
    # The max only shifts the exponent; no gradient flows through it (as
    # the JAX oracle's stop_gradient).
    p = torch.exp(logits - logits.amax(dim=-1, keepdim=True).detach())
    z = p.sum(dim=-1, keepdim=True)
    out = (p.to(cdt).to(f32) @ v) / z
    attn = out.permute(0, 2, 1, 3).reshape(b * s, h).to(cdt)

    ao = (dot(attn, w["o_w"]) + w["o_b"].to(f32)).to(cdt)
    if m1 is not None:
        ao = ao * m1.reshape(b * s, h)
    x1 = _layer_norm((x2 + ao).to(f32), w["ln1_s"], w["ln1_b"], eps).to(cdt)
    hid = _gelu_exact(dot(x1, w["w1"]) + w["b1"].to(f32)).to(cdt)
    f = (dot(hid, w["w2"]) + w["b2"].to(f32)).to(cdt)
    if m2 is not None:
        f = f * m2.reshape(b * s, h)
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


def fused_encoder_layer_train_reference(
    x: torch.Tensor,
    mask: torch.Tensor,
    layer: dict,
    *,
    masks: tuple[torch.Tensor, torch.Tensor] | None,
    num_heads: int,
    scale: float,
    eps: float,
) -> torch.Tensor:
    """Plain PyTorch version of the training form: the layer with the
    dropout masks ``(m1, m2)`` (``{0, 1/keep}`` in the compute dtype) applied
    to the attention projection and the FFN output before their residual
    adds, or none. Differentiable: its autograd gradient is the plain
    backward."""
    bias, w = _prep_inputs(x, mask, layer)
    m1, m2 = masks if masks is not None else (None, None)
    return _reference_core(x, bias, w, m1, m2, num_heads=num_heads, scale=scale, eps=eps)


def fused_encoder_layer_backward_reference(
    x: torch.Tensor,
    bias: torch.Tensor,
    g: torch.Tensor,
    masks: tuple[torch.Tensor, torch.Tensor] | None,
    weights: dict,
    *,
    num_heads: int,
    scale: float,
    eps: float,
) -> tuple[torch.Tensor, dict]:
    """Plain backward: autograd of the plain forward with respect to ``x``
    and the twelve kernel-layout weights, for upstream gradient ``g``.
    Returns ``(dx, {name: grad})``, each grad in its input's dtype."""
    m1, m2 = masks if masks is not None else (None, None)
    with torch.enable_grad():
        xr = x.detach().requires_grad_(True)
        wr = {n: weights[n].detach().requires_grad_(True) for n in WEIGHT_NAMES}
        y = _reference_core(xr, bias, wr, m1, m2, num_heads=num_heads, scale=scale, eps=eps)
        grads = torch.autograd.grad(y, [xr, *wr.values()], g)
    return grads[0], dict(zip(WEIGHT_NAMES, grads[1:]))


_SIGNATURES = {
    "fused_layer_forward": [ctypes.c_void_p] * 22
    + [ctypes.c_int] * 5
    + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p],
}
_BWD_SIGNATURES = {
    "fused_layer_backward_workspace": [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_ulonglong)],
    "fused_layer_backward": [ctypes.c_void_p] * 31
    + [ctypes.c_int] * 5
    + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p],
}


def supports(hidden: int, num_heads: int, seq: int, inter: int) -> bool:
    """Whether the fused-layer kernels (K1 and K5) take this shape: head_dim
    32 or 64 (hidden == num_heads * head_dim), hidden % 64 == 0 and at most
    1024, intermediate % 64 == 0, and 16 <= S <= 256 with S % 16 == 0.
    Named after the JAX package's gate, but this is the port kernels' own
    envelope: JAX's also admits head_dim 16 and 128 and any S % 16 == 0.
    ``encode`` sends every other shape to the unfused layer."""
    return (
        num_heads > 0
        and hidden % num_heads == 0
        and hidden // num_heads in HEAD_DIMS
        and hidden % 64 == 0
        and hidden <= 1024
        and inter % 64 == 0
        and seq % 16 == 0
        and 16 <= seq <= MAX_SEQ
    )


def _check_kernel_inputs(x: torch.Tensor, bias: torch.Tensor, w: dict, num_heads: int) -> None:
    b, s, h = x.shape
    inter = w["w1"].shape[1]
    if x.dtype != torch.bfloat16:
        raise ValueError(f"fused_encoder_layer kernel takes bfloat16, got {x.dtype}")
    if not supports(h, num_heads, s, inter):
        raise ValueError(
            f"fused_encoder_layer kernel takes head_dim 32 or 64, hidden % 64 == 0 "
            f"(<= 1024), intermediate % 64 == 0 and 16 <= S <= {MAX_SEQ} with S % 16 == 0; "
            f"got hidden={h}, heads={num_heads}, intermediate={inter}, S={s}"
        )
    if not 1 <= b <= 65535:
        raise ValueError(f"fused_encoder_layer kernel takes 1 <= B <= 65535; got {b}")
    if bias.shape != (b, s) or bias.dtype != torch.float32 or not bias.is_contiguous():
        raise ValueError(f"fused_encoder_layer: the key bias must be contiguous float32 [{b}, {s}]")
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


def _check_like_x(x: torch.Tensor, name: str, t: torch.Tensor | None) -> None:
    """A [B, S, H] bf16 operand beside x (upstream grad, dropout mask)."""
    if t is None:
        return
    if t.shape != x.shape or t.dtype != torch.bfloat16 or t.device != x.device:
        raise ValueError(
            f"fused_encoder_layer: {name} must be bfloat16 {tuple(x.shape)} on {x.device}, "
            f"got {t.dtype} {tuple(t.shape)} on {t.device}"
        )
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"fused_encoder_layer: {name} must be contiguous and 16-byte aligned")


def _check_masks(x: torch.Tensor, masks) -> tuple:
    if masks is None:
        return None, None
    m1, m2 = masks
    _check_like_x(x, "m1", m1)
    _check_like_x(x, "m2", m2)
    return m1, m2


def _launch(x, bias, w, masks=None, *, num_heads, scale, eps):
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
    m1, m2 = _check_masks(x, masks)
    lib = _build.load("fused_layer", _SIGNATURES)
    p = _build.ptr
    err = lib.fused_layer_forward(
        p(x), p(bias), *(p(w[n]) for n in WEIGHT_NAMES),
        None if m1 is None else p(m1), None if m2 is None else p(m2),
        p(qkv), p(attn), p(tmp), p(x1), p(hid), p(y),
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
    _build.count(fused_encoder_layer)
    return y


fused_encoder_layer.launches = 0


def fused_encoder_layer_backward(
    x: torch.Tensor,
    bias: torch.Tensor,
    g: torch.Tensor,
    masks: tuple[torch.Tensor, torch.Tensor] | None,
    weights: dict,
    *,
    num_heads: int,
    scale: float,
    eps: float,
) -> tuple[torch.Tensor, dict]:
    """Backward of the training-form layer: ``(dx, {name: grad})`` for
    upstream gradient ``g``, each grad in its weight's dtype (summed in f32).
    A CPU tensor takes the plain version; a CUDA tensor launches K5 or
    raises on what it does not take."""
    if x.device.type == "cpu":
        return fused_encoder_layer_backward_reference(
            x, bias, g, masks, weights, num_heads=num_heads, scale=scale, eps=eps
        )
    if x.device.type != "cuda":
        raise ValueError(f"fused_encoder_layer_backward: no kernel for device {x.device}")
    _check_kernel_inputs(x, bias, weights, num_heads)
    _check_like_x(x, "g", g)
    m1, m2 = _check_masks(x, masks)
    b, s, h = x.shape
    inter = weights["w1"].shape[1]
    lib = _build.load("fused_layer_bwd", _BWD_SIGNATURES)
    n_bytes = ctypes.c_ulonglong(0)
    err = lib.fused_layer_backward_workspace(b, s, h, num_heads, inter, ctypes.byref(n_bytes))
    _build.check(lib, err, "fused_layer_backward_workspace")
    workspace = torch.empty(n_bytes.value, dtype=torch.uint8, device=x.device)
    dx = torch.empty_like(x)
    grads = {n: torch.empty(weights[n].shape, dtype=torch.float32, device=x.device)
             for n in WEIGHT_NAMES}
    p = _build.ptr
    err = lib.fused_layer_backward(
        p(x), p(bias), p(g), None if m1 is None else p(m1), None if m2 is None else p(m2),
        *(p(weights[n]) for n in WEIGHT_NAMES), p(dx), *(p(grads[n]) for n in WEIGHT_NAMES),
        p(workspace), b, s, h, num_heads, inter, scale, eps, _build.stream_of(x),
    )
    _build.check(lib, err, "fused_layer_backward")
    _build.count(fused_encoder_layer_backward)
    return dx, {n: grads[n].to(weights[n].dtype) for n in WEIGHT_NAMES}


fused_encoder_layer_backward.launches = 0


class _TrainLayer(torch.autograd.Function):
    """The training-form layer: K1 with masks forward, K5 backward (the
    plain versions on the CPU). Saves only the layer inputs, as the JAX
    custom_vjp does; the backward recomputes the forward."""

    @staticmethod
    def forward(ctx, x, bias, m1, m2, opts, *weights):
        num_heads, scale, eps = opts
        w = dict(zip(WEIGHT_NAMES, weights))
        masks = None if m1 is None else (m1, m2)
        if x.device.type == "cpu":
            y = _reference_core(x, bias, w, m1, m2, num_heads=num_heads, scale=scale, eps=eps)
        elif x.device.type == "cuda":
            _check_kernel_inputs(x, bias, w, num_heads)
            y = _launch(x, bias, w, masks, num_heads=num_heads, scale=scale, eps=eps)
            _build.count(fused_encoder_layer_train)
        else:
            raise ValueError(f"fused_encoder_layer_train: no kernel for device {x.device}")
        ctx.opts = opts
        ctx.has_masks = masks is not None
        ctx.save_for_backward(x, bias, *(masks or ()), *weights)
        return y

    @staticmethod
    def backward(ctx, g):
        num_heads, scale, eps = ctx.opts
        saved = ctx.saved_tensors
        x, bias = saved[:2]
        n_masks = 2 if ctx.has_masks else 0
        masks = tuple(saved[2 : 2 + n_masks]) or None
        weights = dict(zip(WEIGHT_NAMES, saved[2 + n_masks :]))
        dx, dw = fused_encoder_layer_backward(
            x, bias, g.contiguous(), masks, weights, num_heads=num_heads, scale=scale, eps=eps
        )
        return (dx, None, None, None, None, *(dw[n] for n in WEIGHT_NAMES))


def draw_dropout_masks(
    shape: tuple[int, ...],
    dropout_rate: float,
    generator: torch.Generator,
    device: torch.device,
    dtype: torch.dtype,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Two ``{0, 1/keep}`` masks in ``dtype``, m1 then m2, from ``generator``."""
    keep = 1.0 - float(dropout_rate)
    out = []
    for _ in range(2):
        bits = torch.rand(shape, generator=generator, device=device) < keep
        out.append(torch.where(bits, 1.0 / keep, 0.0).to(dtype))
    return out[0], out[1]


def fused_encoder_layer_train(
    x: torch.Tensor,
    mask: torch.Tensor,
    layer: dict,
    *,
    generator: torch.Generator | None = None,
    masks: tuple[torch.Tensor, torch.Tensor] | None = None,
    dropout_rate: float,
    num_heads: int,
    scale: float,
    eps: float,
) -> torch.Tensor:
    """Differentiable layer with BERT hidden dropout.

    The masks are ``masks`` when given, else drawn from ``generator`` (m1
    then m2). ``dropout_rate <= 0`` runs the maskless variant. ``layer`` is
    a raw layer dict or a ``prepare_layer`` one; gradients reach whatever
    tensors it was made from through ``prepare_layer``'s casts.
    """
    bias, w = _prep_inputs(x, mask, layer)
    if 1.0 - float(dropout_rate) >= 1.0:
        masks = None  # maskless variant: no [B, S, H] mask traffic
    elif masks is None:
        if generator is None:
            raise ValueError("fused_encoder_layer_train: dropout needs a generator or masks")
        masks = draw_dropout_masks(x.shape, dropout_rate, generator, x.device, x.dtype)
    m1, m2 = masks if masks is not None else (None, None)
    return _TrainLayer.apply(
        x, bias, m1, m2, (num_heads, scale, eps), *(w[n] for n in WEIGHT_NAMES)
    )


fused_encoder_layer_train.launches = 0
