"""Fused post-LN BERT encoder layer: plain versions and kernel wrappers.

Counterpart of the JAX package's ``ops/fused_layer.py``: ``fused_encoder_layer``
there runs the Pallas TPU kernel ``_kernel``, ``fused_encoder_layer_train``
runs it with two dropout-mask inputs under a custom_vjp whose backward is
the kernel ``_bwd_kernel``, and ``_oracle`` is the jnp mirror of both. With
``save_resid`` the forward also keeps four residuals (attn, the post-dropout
ao, x1, the post-dropout f) and ``_bwd_kernel``'s resid form reads them in
place of four of its recompute steps.

Here ``fused_encoder_layer_reference`` / ``fused_encoder_layer_train_reference``
are the plain PyTorch versions of the same math (the latter's autograd
gradient is the plain backward, ``fused_encoder_layer_backward_reference``,
which with the residuals chains the same steps from the saved values), and
the entry points launch the hand-written CUDA kernels for a tensor on the
GPU: ``csrc/fused_layer.cu`` (K1, forward, with or without masks, with or
without the residuals) and ``csrc/fused_layer_bwd.cu`` (K5, dx and the twelve
weight grads, recomputing the forward or reading the residuals), at every
shape JAX's gate admits (``supports``). Cast points follow ``_kernel``:
matmuls accumulate in f32 over compute-dtype operands, the softmax is f32
with 1/sum applied after the PV product, residual adds and the dropout
products happen in the compute dtype, and LayerNorm runs in f32.
"""

from __future__ import annotations

import ctypes

import torch

from instacart_next_order_recommendation_tpu_torch.ops import _build

_NEG_INF = -1e9  # key bias at padded keys: finite, so all-pad rows stay finite
HEAD_DIMS = (16, 32, 64, 128)
MAX_SEQ = 512  # the towers' max_position
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


def _dot(a: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    return a.to(torch.float32) @ m.to(torch.float32)


def _attention(x2, bias, w, *, b, s, num_heads, scale):
    """attn ``[B*S, H]`` in the compute dtype from the layer input's rows."""
    cdt = x2.dtype
    f32 = torch.float32
    h = x2.shape[1]
    hd = h // num_heads
    qkv = (_dot(x2, w["qkv_w"]) + w["qkv_b"].to(f32)).to(cdt).reshape(b, s, 3 * h)

    def heads(t):
        return t.reshape(b, s, num_heads, hd).permute(0, 2, 1, 3).to(f32)

    q, k, v = (heads(qkv[..., i * h : (i + 1) * h]) for i in range(3))
    logits = (q @ k.transpose(-1, -2)) * scale + bias[:, None, None, :]
    # The max only shifts the exponent; no gradient flows through it (as
    # the JAX oracle's stop_gradient).
    p = torch.exp(logits - logits.amax(dim=-1, keepdim=True).detach())
    z = p.sum(dim=-1, keepdim=True)
    out = (p.to(cdt).to(f32) @ v) / z
    return out.permute(0, 2, 1, 3).reshape(b * s, h).to(cdt)


def _projection(attn, w, m1):
    """ao after dropout: bf16(bf16(attn Wo + bo) * m1)."""
    ao = (_dot(attn, w["o_w"]) + w["o_b"].to(torch.float32)).to(attn.dtype)
    return ao if m1 is None else ao * m1


def _ffn(x1, w, m2):
    """f after dropout: bf16(bf16(gelu(x1 W1 + b1)) W2 + b2) * m2."""
    f32 = torch.float32
    hid = _gelu_exact(_dot(x1, w["w1"]) + w["b1"].to(f32)).to(x1.dtype)
    f = (_dot(hid, w["w2"]) + w["b2"].to(f32)).to(x1.dtype)
    return f if m2 is None else f * m2


def _add_norm(a, r, scale, shift, eps):
    """bf16(LN(float(bf16(a + r)))): the residual add in the compute dtype."""
    return _layer_norm((a + r).to(torch.float32), scale, shift, eps).to(a.dtype)


def _reference_core(x, bias, w, m1=None, m2=None, *, num_heads, scale, eps, keep=False):
    """The layer; with ``keep``, also its four residuals ``(attn, ao, x1,
    f)``, each ``[B, S, H]``, as the JAX kernel's save_resid writes them."""
    b, s, h = x.shape
    x2 = x.reshape(b * s, h)
    m1, m2 = (None if m is None else m.reshape(b * s, h) for m in (m1, m2))
    attn = _attention(x2, bias, w, b=b, s=s, num_heads=num_heads, scale=scale)
    ao = _projection(attn, w, m1)
    x1 = _add_norm(x2, ao, w["ln1_s"], w["ln1_b"], eps)
    f = _ffn(x1, w, m2)
    y = _add_norm(x1, f, w["ln2_s"], w["ln2_b"], eps).reshape(b, s, h)
    if keep:
        return y, tuple(t.reshape(b, s, h) for t in (attn, ao, x1, f))
    return y


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
    resids: tuple | None = None,
) -> tuple[torch.Tensor, dict]:
    """Plain backward: autograd of the plain forward with respect to ``x``
    and the twelve kernel-layout weights, for upstream gradient ``g``.
    Returns ``(dx, {name: grad})``, each grad in its input's dtype.

    With ``resids`` (the forward's ``(attn, ao, x1, f)``) it runs the resid
    form's data flow, step by step from the saved values as K5 does: LN2 on
    the saved x1 and f, the FFN from the saved x1 (its W1 product
    recomputed), LN1 on x and the saved ao, the projection from the saved
    attn, and the attention from x (its qkv product recomputed)."""
    if resids is not None:
        return _resid_backward_reference(
            x, bias, g, masks, weights, resids, num_heads=num_heads, scale=scale, eps=eps
        )
    m1, m2 = masks if masks is not None else (None, None)
    with torch.enable_grad():
        xr = x.detach().requires_grad_(True)
        wr = {n: weights[n].detach().requires_grad_(True) for n in WEIGHT_NAMES}
        y = _reference_core(xr, bias, wr, m1, m2, num_heads=num_heads, scale=scale, eps=eps)
        grads = torch.autograd.grad(y, [xr, *wr.values()], g)
    return grads[0], dict(zip(WEIGHT_NAMES, grads[1:]))


def _resid_backward_reference(x, bias, g, masks, weights, resids, *, num_heads, scale, eps):
    b, s, h = x.shape
    x2, g2, attn, ao, x1, f = (t.reshape(b * s, h) for t in (x, g, *resids))
    m1, m2 = (None, None) if masks is None else (m.reshape(b * s, h) for m in masks)
    dw = {}

    def vjp(fn, inputs: dict, upstream):
        """Gradients of ``fn(**inputs)`` for ``upstream``; the weights among
        the inputs go to ``dw``, the rest are returned by name."""
        with torch.enable_grad():
            leaves = {n: t.detach().requires_grad_(True) for n, t in inputs.items()}
            grads = torch.autograd.grad(fn(**leaves), list(leaves.values()), upstream)
        out = dict(zip(leaves, grads))
        dw.update({n: out.pop(n) for n in list(out) if n in WEIGHT_NAMES})
        return out

    w = lambda *names: {n: weights[n] for n in names}  # noqa: E731
    d = vjp(lambda x1, f, ln2_s, ln2_b: _add_norm(x1, f, ln2_s, ln2_b, eps),
            {"x1": x1, "f": f, **w("ln2_s", "ln2_b")}, g2)
    dx1 = d["x1"] + vjp(lambda x1, **ws: _ffn(x1, ws, m2),
                        {"x1": x1, **w("w1", "b1", "w2", "b2")}, d["f"])["x1"]
    d = vjp(lambda x, ao, ln1_s, ln1_b: _add_norm(x, ao, ln1_s, ln1_b, eps),
            {"x": x2, "ao": ao, **w("ln1_s", "ln1_b")}, dx1)
    dattn = vjp(lambda attn, **ws: _projection(attn, ws, m1),
                {"attn": attn, **w("o_w", "o_b")}, d["ao"])["attn"]
    dx = d["x"] + vjp(
        lambda x, **ws: _attention(x, bias, ws, b=b, s=s, num_heads=num_heads, scale=scale),
        {"x": x2, **w("qkv_w", "qkv_b")}, dattn,
    )["x"]
    return dx.reshape(b, s, h), {n: dw[n] for n in WEIGHT_NAMES}


_SIGNATURES = {
    "fused_layer_forward": [ctypes.c_void_p] * 23
    + [ctypes.c_int] * 6
    + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p],
}
_BWD_SIGNATURES = {
    "fused_layer_backward_workspace": [ctypes.c_int] * 6 + [ctypes.POINTER(ctypes.c_ulonglong)],
    "fused_layer_backward": [ctypes.c_void_p] * 35
    + [ctypes.c_int] * 5
    + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p],
    "fused_gemm": [ctypes.c_int] * 2 + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
    + [ctypes.c_void_p],
    "fused_gemm_wgrad_splits": [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)] * 2,
}


def supports(hidden: int, num_heads: int, seq: int, inter: int) -> bool:
    """Whether the fused-layer kernels (K1 and K5) take this shape: head_dim
    16, 32, 64 or 128 (hidden == num_heads * head_dim: every head_dim that
    divides 128, as the JAX package's gate admits), hidden % 64 == 0 and at
    most 1024 (the LayerNorm row kernel's width), intermediate % 64 == 0, and
    16 <= S <= 512 with S % 16 == 0 (JAX's gate sets no top; the towers'
    max_position of 512 does). ``encode`` sends every other shape to the
    unfused layer."""
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
            f"fused_encoder_layer kernel takes head_dim {HEAD_DIMS}, hidden % 64 == 0 "
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


def _launch(x, bias, w, masks=None, *, num_heads, scale, eps, save_resid=False):
    """K1 on checked inputs: ``y``, or with ``save_resid`` ``(y, (attn, ao,
    x1, f))``, the four residuals ``[B, S, H]`` that K5's resid form reads."""
    b, s, h = x.shape
    inter = w["w1"].shape[1]
    m = b * s
    new = {"dtype": x.dtype, "device": x.device}
    qkv = torch.empty((m, 3 * h), **new)
    attn, ao, x1 = (torch.empty((m, h), **new) for _ in range(3))
    f = torch.empty((m, h), **new) if save_resid else ao
    hid = torch.empty((m, inter), **new)
    y = torch.empty_like(x)
    m1, m2 = _check_masks(x, masks)
    lib = _build.load("fused_layer", _SIGNATURES)
    p = _build.ptr
    err = lib.fused_layer_forward(
        p(x), p(bias), *(p(w[n]) for n in WEIGHT_NAMES),
        None if m1 is None else p(m1), None if m2 is None else p(m2),
        p(qkv), p(attn), p(ao), p(x1), p(hid), p(f), p(y), int(save_resid),
        b, s, h, num_heads, inter, scale, eps, _build.stream_of(x),
    )
    _build.check(lib, err, "fused_layer_forward")
    if save_resid:
        return y, tuple(t.view(b, s, h) for t in (attn, ao, x1, f))
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
    resids: tuple | None = None,
) -> tuple[torch.Tensor, dict]:
    """Backward of the training-form layer: ``(dx, {name: grad})`` for
    upstream gradient ``g``, each grad in its weight's dtype (summed in f32).
    ``resids``: the forward's ``(attn, ao, x1, f)`` (the residual-saving
    form, as JAX's ``_call_bwd(resids=...)``), or None to recompute them.
    A CPU tensor takes the plain version; a CUDA tensor launches K5 or
    raises on what it does not take. Launches of the resid form are also
    counted in ``.resid_launches``."""
    if x.device.type == "cpu":
        return fused_encoder_layer_backward_reference(
            x, bias, g, masks, weights, num_heads=num_heads, scale=scale, eps=eps,
            resids=resids,
        )
    if x.device.type != "cuda":
        raise ValueError(f"fused_encoder_layer_backward: no kernel for device {x.device}")
    _check_kernel_inputs(x, bias, weights, num_heads)
    _check_like_x(x, "g", g)
    for name, r in zip(("attn", "ao", "x1", "f"), resids or ()):
        _check_like_x(x, name, r)
    m1, m2 = _check_masks(x, masks)
    b, s, h = x.shape
    inter = weights["w1"].shape[1]
    lib = _build.load("fused_layer_bwd", _BWD_SIGNATURES)
    n_bytes = ctypes.c_ulonglong(0)
    err = lib.fused_layer_backward_workspace(
        b, s, h, num_heads, inter, int(resids is not None), ctypes.byref(n_bytes)
    )
    _build.check(lib, err, "fused_layer_backward_workspace")
    workspace = torch.empty(n_bytes.value, dtype=torch.uint8, device=x.device)
    dx = torch.empty_like(x)
    grads = {n: torch.empty(weights[n].shape, dtype=torch.float32, device=x.device)
             for n in WEIGHT_NAMES}
    p = _build.ptr
    err = lib.fused_layer_backward(
        p(x), p(bias), p(g), None if m1 is None else p(m1), None if m2 is None else p(m2),
        *(p(weights[n]) for n in WEIGHT_NAMES),
        *((None,) * 4 if resids is None else (p(r) for r in resids)),
        p(dx), *(p(grads[n]) for n in WEIGHT_NAMES),
        p(workspace), b, s, h, num_heads, inter, scale, eps, _build.stream_of(x),
    )
    _build.check(lib, err, "fused_layer_backward")
    _build.count(fused_encoder_layer_backward)
    if resids is not None:
        _build.count(fused_encoder_layer_backward, "resid_launches")
    return dx, {n: grads[n].to(weights[n].dtype) for n in WEIGHT_NAMES}


fused_encoder_layer_backward.launches = 0
fused_encoder_layer_backward.resid_launches = 0


# The residuals' bytes a layer up to which the training layer keeps them:
# the four [B, S, H] bf16 tensors stay alive from each layer's forward to
# its backward, so a tower holds layers x this. 768 MiB is the largest size
# at which whole training steps of both presets were read to fit (PERF.md).
RESID_BYTES_PER_LAYER = 768 << 20


def saves_residuals(batch: int, seq: int, hidden: int, inter: int) -> bool:
    """Whether the training-form layer keeps its four residuals for the
    backward (K1's save_resid, K5's resid form) at this shape, or keeps only
    its inputs and recomputes them. A rule of shape alone, so that the CPU
    and the card take the same form. From H100 readings
    (PERF.md section 6, the residual-saving pair):

    - speed: one layer's step (K1-train + K5) was 4-11% faster in the resid
      form at MiniLM's and mpnet's widths from B=64 to 512 and S=64 to 512;
      whole ``TrainStep``s at S=512 9.3-9.4% faster (MiniLM B=512 and 1024,
      mpnet B=256). At B=1 (six turns) it was 5-7% slower at MiniLM's widths
      (K1-train's resid form 0.022-0.028 ms slower, K5's no faster) and 5-6%
      faster at mpnet's; a batch of 1 holds no in-batch negative, so MNRL
      learns nothing there, and the rule does not split on it.
    - memory: what the form costs is memory held across the tower,
      4*B*S*H*2 bytes a layer. Kept up to ``RESID_BYTES_PER_LAYER``: at 768
      MiB a layer (MiniLM B=512, mpnet B=256, both at S=512) the whole step
      fit, mpnet's at a 44.7 GB peak against the recompute form's 26.2; at
      1.5 GiB a layer mpnet B=512 S=512 did not fit in 80 GB, where the
      recompute form's step peaked at 50.7 GB (MiniLM B=1024 did fit: a
      per-layer cap cannot see the layer count). ``inter`` does not enter:
      the FFN's hidden layer is recomputed in both forms."""
    return 4 * batch * seq * hidden * 2 <= RESID_BYTES_PER_LAYER


class _TrainLayer(torch.autograd.Function):
    """The training-form layer: K1 with masks forward, K5 backward (the
    plain versions on the CPU). Saves the layer inputs and, where
    ``saves_residuals`` says so, the four residuals; else the backward
    recomputes the forward, as the JAX custom_vjp does by default."""

    @staticmethod
    def forward(ctx, x, bias, m1, m2, opts, *weights):
        num_heads, scale, eps = opts
        w = dict(zip(WEIGHT_NAMES, weights))
        masks = None if m1 is None else (m1, m2)
        b, s, h = x.shape
        keep = saves_residuals(b, s, h, w["w1"].shape[1])
        kw = dict(num_heads=num_heads, scale=scale, eps=eps)
        if x.device.type == "cpu":
            out = _reference_core(x, bias, w, m1, m2, keep=keep, **kw)
        elif x.device.type == "cuda":
            _check_kernel_inputs(x, bias, w, num_heads)
            out = _launch(x, bias, w, masks, save_resid=keep, **kw)
            _build.count(fused_encoder_layer_train)
            if keep:
                _build.count(fused_encoder_layer_train, "resid_launches")
        else:
            raise ValueError(f"fused_encoder_layer_train: no kernel for device {x.device}")
        y, resids = out if keep else (out, ())
        ctx.opts = opts
        ctx.n_masks = 0 if masks is None else 2
        ctx.n_resids = len(resids)
        ctx.save_for_backward(x, bias, *(masks or ()), *resids, *weights)
        return y

    @staticmethod
    def backward(ctx, g):
        num_heads, scale, eps = ctx.opts
        x, bias, *rest = ctx.saved_tensors
        masks = tuple(rest[: ctx.n_masks]) or None
        resids = tuple(rest[ctx.n_masks : ctx.n_masks + ctx.n_resids]) or None
        weights = dict(zip(WEIGHT_NAMES, rest[ctx.n_masks + ctx.n_resids :]))
        dx, dw = fused_encoder_layer_backward(
            x, bias, g.contiguous(), masks, weights, num_heads=num_heads, scale=scale, eps=eps,
            resids=resids,
        )
        return (dx, None, None, None, None, *(dw[n] for n in WEIGHT_NAMES))


def draw_dropout_masks(
    shape: tuple[int, ...],
    dropout_rate: float,
    generator: torch.Generator,
    device: torch.device,
    dtype: torch.dtype,
    width: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Two ``{0, 1/keep}`` masks in ``dtype``, m1 then m2, from ``generator``.

    Each is drawn at ``shape`` (``[B, S, H]``, the shape the step was
    handed) and then cut to its first ``width`` columns before the compare
    and cast: the kept values, and the generator's state after the draws,
    are the uncut draw's whatever ``width`` is."""
    keep = 1.0 - float(dropout_rate)
    out = []
    for _ in range(2):
        bits = torch.rand(shape, generator=generator, device=device)[:, :width] < keep
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
    tensors it was made from through ``prepare_layer``'s casts. Launches
    that keep the residuals are also counted in ``.resid_launches``.
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
fused_encoder_layer_train.resid_launches = 0


# ------------------------------------------------------------ GEMM core
# The (form, epilogue) pairs K1 and K5 run on their one GEMM core
# (csrc/fused_layer_common.cuh), with the C enums' values: forms X W
# ("xw", W [K, N]), X W^T ("xwt", W [N, K]) and the split weight gradient
# X^T dY ("atb", X [K, M], dY [K, N]).
GEMM_FORMS = {"xw": 0, "xwt": 1, "atb": 2}
GEMM_EPILOGUES = {
    "bias": 0, "bias_gelu": 1, "bias_gelu_grad": 2, "mul_aux": 3, "add_aux_f32": 4,
    "add_aux_bf16": 5, "partial": 6,
}
GEMM_PAIRS = (
    ("xw", "bias"), ("xw", "bias_gelu"), ("xw", "bias_gelu_grad"), ("xwt", "mul_aux"),
    ("xwt", "add_aux_f32"), ("xwt", "bias"), ("xwt", "add_aux_bf16"), ("atb", "partial"),
)
GEMM_ROW_TILE = 128  # the core's block rows: EPI_MUL_AUX writes one column-sum row per tile


def _gemm_shape(form: str, a: torch.Tensor, w: torch.Tensor) -> tuple[int, int, int]:
    """(M, N, K) of one product of the core."""
    if form == "atb":
        return a.shape[1], w.shape[1], a.shape[0]
    return a.shape[0], (w.shape[0] if form == "xwt" else w.shape[1]), a.shape[1]


def gemm_core_reference(form, epilogue, a, w, *, bias=None, aux=None, splits=1,
                        rows_per_split=0):
    """The plain version of ``gemm_core``: f32 products of the bf16
    operands and the same epilogue."""
    m, n, _ = _gemm_shape(form, a, w)
    af, wf = a.float(), w.float()
    if form == "atb":
        parts = [af[z * rows_per_split:(z + 1) * rows_per_split].T
                 @ wf[z * rows_per_split:(z + 1) * rows_per_split] for z in range(splits)]
        return torch.stack(parts), None
    acc = af @ (wf.T if form == "xwt" else wf)
    if epilogue in ("bias", "bias_gelu", "bias_gelu_grad") and bias is not None:
        acc = acc + bias.float()
    if epilogue == "bias":
        return acc.to(torch.bfloat16), None
    if epilogue == "bias_gelu":
        return _gelu_exact(acc).to(torch.bfloat16), None
    if epilogue == "bias_gelu_grad":
        cdf = 0.5 * (1.0 + torch.erf(acc * 0.7071067811865476))
        pdf = torch.exp(-0.5 * acc * acc) * 0.3989422804014327
        return _gelu_exact(acc).to(torch.bfloat16), cdf + acc * pdf
    if epilogue == "mul_aux":
        d = acc * aux
        tiles = -(-m // GEMM_ROW_TILE)
        pad = torch.zeros((tiles * GEMM_ROW_TILE - m, n), dtype=d.dtype, device=d.device)
        sums = torch.cat([d, pad]).view(tiles, GEMM_ROW_TILE, n).sum(dim=1)
        return d.to(torch.bfloat16), sums
    if epilogue == "add_aux_f32":
        return acc + aux, None
    return (acc + aux).to(torch.bfloat16), None


def gemm_core(form: str, epilogue: str, a: torch.Tensor, w: torch.Tensor, *,
              bias: torch.Tensor | None = None, aux: torch.Tensor | None = None,
              splits: int = 1, rows_per_split: int = 0):
    """One product of K1's and K5's GEMM core alone, for tests and timings
    (the layer's entry points launch the core themselves): ``(c, aux_out)``.
    ``c`` is bf16 ``[M, N]`` (f32 for "add_aux_f32", f32 ``[splits, M, N]``
    partials for "atb"); ``aux_out`` is the f32 gelu' of "bias_gelu_grad",
    the f32 column sums ``[ceil(M / 128), N]`` of "mul_aux", else None.
    ``aux``: f32 ``[M, N]``. A CPU tensor takes the plain version; a CUDA
    tensor launches the core, or raises on what it does not take."""
    if (form, epilogue) not in GEMM_PAIRS:
        raise ValueError(f"gemm_core: the layer runs no ({form}, {epilogue}) product")
    if form == "atb" and (splits < 1 or rows_per_split < 1):
        raise ValueError("gemm_core: the atb form takes splits and rows_per_split")
    m, n, k = _gemm_shape(form, a, w)
    if a.device.type == "cpu":
        return gemm_core_reference(form, epilogue, a, w, bias=bias, aux=aux, splits=splits,
                                   rows_per_split=rows_per_split)
    if a.device.type != "cuda":
        raise ValueError(f"gemm_core: no kernel for device {a.device}")
    for name, t in (("a", a), ("w", w), ("bias", bias)):
        if t is not None and (t.dtype != torch.bfloat16 or not t.is_contiguous()
                              or t.data_ptr() % 16 or t.device != a.device):
            raise ValueError(f"gemm_core: {name} must be contiguous 16-byte aligned bfloat16")
    if aux is not None and (aux.shape != (m, n) or aux.dtype != torch.float32
                            or not aux.is_contiguous()):
        raise ValueError(f"gemm_core: aux must be contiguous float32 [{m}, {n}]")
    if n % 8 or (form != "atb" and k % 8) or (form == "atb" and m % 8):
        raise ValueError("gemm_core: N and the contiguous extents must be multiples of 8")
    if form != "atb" and (w.shape[1] if form == "xwt" else w.shape[0]) != k:
        raise ValueError("gemm_core: a and w disagree on the depth")
    new = {"device": a.device}
    if form == "atb":
        if rows_per_split % 64 or splits * rows_per_split < k or w.shape[0] != k:
            raise ValueError("gemm_core: rows_per_split a multiple of 64 covering the rows")
        c = torch.empty((splits, m, n), dtype=torch.float32, **new)
    else:
        dtype = torch.float32 if epilogue == "add_aux_f32" else torch.bfloat16
        c = torch.empty((m, n), dtype=dtype, **new)
    aux_out = None
    if epilogue == "bias_gelu_grad":
        aux_out = torch.empty((m, n), dtype=torch.float32, **new)
    elif epilogue == "mul_aux":
        aux_out = torch.empty((-(-m // GEMM_ROW_TILE), n), dtype=torch.float32, **new)
    if epilogue in ("mul_aux", "add_aux_f32", "add_aux_bf16") and aux is None:
        raise ValueError(f"gemm_core: {epilogue} needs aux")
    lib = _build.load("fused_layer_bwd", _BWD_SIGNATURES)
    p = _build.ptr
    err = lib.fused_gemm(
        GEMM_FORMS[form], GEMM_EPILOGUES[epilogue], p(a), p(w),
        None if bias is None else p(bias), p(c), None if aux is None else p(aux),
        None if aux_out is None else p(aux_out), m, n, k, splits, rows_per_split,
        _build.stream_of(a),
    )
    _build.check(lib, err, "fused_gemm")
    _build.count(gemm_core)
    return c, aux_out


gemm_core.launches = 0


def wgrad_split_plan(rows: int, k1: int, n: int) -> tuple[int, int]:
    """``(splits, rows_per_split)`` that K5 gives the weight gradient
    ``A[rows, k1]^T B[rows, n]`` on the current CUDA device."""
    lib = _build.load("fused_layer_bwd", _BWD_SIGNATURES)
    splits, per = ctypes.c_int(0), ctypes.c_int(0)
    _build.check(lib, lib.fused_gemm_wgrad_splits(rows, k1, n, ctypes.byref(splits),
                                                  ctypes.byref(per)), "fused_gemm_wgrad_splits")
    return splits.value, per.value
