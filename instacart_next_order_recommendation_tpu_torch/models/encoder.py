"""MiniLM-class transformer tower: BERT encoder + mean-pool + L2-norm.

(A ``TowerConfig`` whose ``architecture`` is ``"modernbert"`` takes
``models/modernbert.py`` instead, through the same ``init_params``,
``prepare_layers`` and ``encode``; everything below describes BERT.)

Counterpart of the JAX package's ``models/encoder.py``. Parameters are a
plain dict of tensors with the same names and the same stacked-layer layout
(every ``layers`` entry has a leading ``num_layers`` axis), so weights carry
across packages unchanged (``models/checkpoint.py``).

The forward sums the embeddings and LayerNorms them in f32, casts to the
compute dtype, runs the layers, then ``masked_mean_pool_l2norm``. Each
layer takes one of two routes, chosen by shape before any launch as the
JAX package chooses: the fused layer where its kernels take the shape
(``fused_layer.supports``), else the unfused layer ``_encoder_layer``
(bf16 projections through ``torch.matmul``, ``multi_head_attention``,
LayerNorm and GELU in f32), which takes any head_dim and sequence length.
Without a dropout generator the forward runs inference; with one it
trains: BERT hidden dropout on the f32 embeddings and inside every layer,
with every mask drawn from that one generator in a fixed order (m1 then m2
of each layer, the same draws on either route). A training forward may run
narrower than the width it is handed (``encode``'s ``width``, from
``tower_widths``): every mask is still drawn at the handed shape, then cut.
The bf16 layer weights are made from the f32 parameters by differentiable
casts, so gradients reach the parameters.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from instacart_next_order_recommendation_tpu_torch.models import modernbert
from instacart_next_order_recommendation_tpu_torch.ops import (
    fused_encoder_layer,
    fused_encoder_layer_train,
    masked_mean_pool_l2norm,
    multi_head_attention,
)
from instacart_next_order_recommendation_tpu_torch.ops.fused_layer import (
    _gelu_exact,
    draw_dropout_masks,
    prepare_layer,
    supports,
)
from instacart_next_order_recommendation_tpu_torch.parallel.tp import tp_enter, tp_exit
from instacart_next_order_recommendation_tpu_torch.utils.profiling import count, count_device, span

Params = dict[str, Any]

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
ARCHITECTURES = ("bert", "modernbert")
MODERNBERT_FIELDS = (
    "architecture", "local_attention", "global_attn_every_n_layers", "global_rope_theta",
    "local_rope_theta",
)


@dataclasses.dataclass(frozen=True)
class TowerConfig:
    """Architecture hyperparameters (BERT-encoder family); the same fields
    as the JAX package's ``TowerConfig``, so ``model_config.json`` is shared."""

    vocab_size: int = 30522
    hidden_size: int = 384
    num_layers: int = 6
    num_heads: int = 12
    intermediate_size: int = 1536
    max_position: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    hidden_dropout: float = 0.1
    max_seq_length: int = 256
    compute_dtype: str = "bfloat16"
    # Recompute each unfused layer in the backward (torch.utils.checkpoint):
    # activation memory O(layers) instead of O(layers x layer). No effect on
    # the fused route, whose backward already keeps only the layer inputs.
    remat: bool = False
    # "bert", or "modernbert" (models/modernbert.py): pre-norm layers without
    # biases, RoPE in place of the position table, GeGLU, and every
    # global_attn_every_n_layers-th layer global (RoPE theta
    # global_rope_theta) while the others attend within local_attention // 2
    # positions (local_rope_theta). BERT leaves these fields at their
    # defaults, and ``to_dict`` leaves them out, so a BERT tower's
    # model_config.json is the JAX package's.
    architecture: str = "bert"
    local_attention: int = 0
    global_attn_every_n_layers: int = 1
    global_rope_theta: float = 0.0
    local_rope_theta: float = 0.0

    def __post_init__(self):
        if self.architecture not in ARCHITECTURES:
            raise ValueError(
                f"architecture must be one of {ARCHITECTURES}, not {self.architecture!r}"
            )

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        if self.architecture == "bert":
            for name in MODERNBERT_FIELDS:
                d.pop(name)
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "TowerConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})


# Preset matching all-MiniLM-L6-v2.
MINILM_L6 = TowerConfig()

# The mpnet-base-class preset (the JAX package's MPNET_BASE_CLASS): head_dim
# 64, which the fused kernels take at 16 <= S <= 512 with S % 16 == 0, as
# JAX's gate does; ragged lengths take the unfused route.
MPNET_BASE_CLASS = TowerConfig(
    vocab_size=30527,
    hidden_size=768,
    num_layers=12,
    num_heads=12,
    intermediate_size=3072,
)

# ModernBERT-base as published (answerdotai/ModernBERT-base, the config of
# nomic-ai/modernbert-embed-base): 768 wide, 22 layers of 12 heads of 64, a
# GeGLU of 1,152, a 128-token window (|i - j| <= 64) with RoPE theta 10,000
# and every third layer global with theta 160,000, 8,192 positions. Served
# only on the card (no backward kernel); dropout 0 as published.
MODERNBERT_BASE = TowerConfig(
    vocab_size=50368,
    hidden_size=768,
    num_layers=22,
    num_heads=12,
    intermediate_size=1152,
    max_position=8192,
    type_vocab_size=0,
    layer_norm_eps=1e-5,
    hidden_dropout=0.0,
    max_seq_length=8192,
    architecture="modernbert",
    local_attention=128,
    global_attn_every_n_layers=3,
    global_rope_theta=160000.0,
    local_rope_theta=10000.0,
)


def is_modernbert(config) -> bool:
    """Whether ``config`` is a ModernBERT tower's. A config without the field
    (the JAX package's ``TowerConfig``, which callers may hand the port) is
    BERT's."""
    return getattr(config, "architecture", "bert") == "modernbert"


def _trunc_normal(generator: torch.Generator, shape, stddev: float = 0.02) -> torch.Tensor:
    """Normal truncated to [-2, 2] standard deviations, then scaled: the
    same distribution as the JAX package's init (not the same numbers)."""
    lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
    hi = 0.5 * (1.0 + math.erf(2.0 / math.sqrt(2.0)))
    u = torch.rand(shape, generator=generator, dtype=torch.float64)
    z = math.sqrt(2.0) * torch.erfinv(2.0 * (lo + u * (hi - lo)) - 1.0)
    return (stddev * z.clamp(-2.0, 2.0)).to(torch.float32)


def init_params(config: TowerConfig, generator: torch.Generator) -> Params:
    """BERT-style truncated-normal(0.02) init on the CPU, from ``generator``
    (ModernBERT's own init for a ModernBERT config)."""
    if is_modernbert(config):
        return modernbert.init_params(config, generator)
    h, inter, n = config.hidden_size, config.intermediate_size, config.num_layers

    def tn(*shape):
        return _trunc_normal(generator, shape)

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.float32)

    def ones(*shape):
        return torch.ones(shape, dtype=torch.float32)

    return {
        "embeddings": {
            "word": tn(config.vocab_size, h),
            "position": tn(config.max_position, h),
            "token_type": tn(config.type_vocab_size, h),
            "ln_scale": ones(h),
            "ln_bias": zeros(h),
        },
        "layers": {
            "q_w": tn(n, h, h),
            "q_b": zeros(n, h),
            "k_w": tn(n, h, h),
            "k_b": zeros(n, h),
            "v_w": tn(n, h, h),
            "v_b": zeros(n, h),
            "o_w": tn(n, h, h),
            "o_b": zeros(n, h),
            "attn_ln_scale": ones(n, h),
            "attn_ln_bias": zeros(n, h),
            "ffn_w1": tn(n, h, inter),
            "ffn_b1": zeros(n, inter),
            "ffn_w2": tn(n, inter, h),
            "ffn_b2": zeros(n, h),
            "ffn_ln_scale": ones(n, h),
            "ffn_ln_bias": zeros(n, h),
        },
    }


def prepare_layers(params: Params, config: TowerConfig) -> list[dict]:
    """Per-layer kernel-layout weights in the compute dtype, made by
    differentiable slices and casts of the stacked f32 parameters. Made once
    per tower for serving (``TextEncoder`` keeps them), once per forward when
    training."""
    dtype = DTYPES[config.compute_dtype]
    if is_modernbert(config):
        return modernbert.prepare_layers(params, config, dtype)
    stacked = params["layers"]
    return [
        prepare_layer({name: t[i] for name, t in stacked.items()}, dtype)
        for i in range(config.num_layers)
    ]


def _layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float):
    x32 = x.to(torch.float32)
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    return (x32 - mean) * torch.rsqrt(var + eps) * scale + bias


def _dropout(
    x: torch.Tensor, rate: float, generator: torch.Generator, handed: int
) -> torch.Tensor:
    """Dropout of x ``[B, S, H]``, its mask drawn at ``[B, handed, H]`` and
    cut to x's S columns."""
    keep = 1.0 - rate
    b, s, h = x.shape
    bits = torch.rand((b, handed, h), generator=generator, device=x.device)[:, :s] < keep
    return torch.where(bits, x / keep, 0.0).to(x.dtype)


def embed(
    params: Params,
    input_ids: torch.Tensor,
    config: TowerConfig,
    generator: torch.Generator | None = None,
    width: int | None = None,
) -> torch.Tensor:
    """Word + position + token-type embeddings, LayerNorm in f32, dropout in
    f32 when a generator is given, cast to the compute dtype: ``[B, S]`` ids
    -> ``[B, S, hidden]``, or ``[B, width, hidden]`` of the first ``width``
    columns alone, the dropout mask still drawn at ``[B, S, hidden]``."""
    b, handed = input_ids.shape
    s = handed if width is None else width
    if s > config.max_position:
        # Indexing past the position table must fail loudly, never clamp.
        raise ValueError(
            f"sequence length {s} exceeds the position table ({config.max_position})"
        )
    emb = params["embeddings"]
    # F.embedding, not emb["word"][ids]: the same gather, but its backward
    # sums repeated ids in segments where advanced indexing's backward
    # serializes them (27 ms of a 125 ms batch-512 step on the H100).
    x = (
        torch.nn.functional.embedding(input_ids[:, :s].long(), emb["word"])
        + emb["position"][:s][None, :, :]
        + emb["token_type"][0]
    )
    x = _layer_norm(x, emb["ln_scale"], emb["ln_bias"], config.layer_norm_eps)
    if generator is not None and config.hidden_dropout > 0.0:
        x = _dropout(x, config.hidden_dropout, generator, handed)
    return x.to(DTYPES[config.compute_dtype])


def _encoder_layer(
    x: torch.Tensor,
    layer: dict,
    mask: torch.Tensor,
    config: TowerConfig,
    masks: tuple[torch.Tensor, torch.Tensor] | None = None,
    model_group=None,
) -> torch.Tensor:
    """One post-LN BERT block without the fused kernels, cast for cast as
    the JAX package's ``_encoder_layer``. x: ``[B, S, hidden]`` in the
    compute dtype; ``layer`` a ``prepare_layer`` dict; ``masks`` the
    ``(m1, m2)`` dropout masks (nonzero = kept) or None.

    ``model_group`` marks a tensor-parallel forward: ``layer`` holds this
    rank's Megatron shards (its heads of Q/K/V and its rows of the output
    projection, its FFN columns and rows; ``parallel/shardings.py``), and
    ``tp_enter``/``tp_exit`` keep the activations whole and the gradients
    right. Hidden activations and every LayerNorm stay full width."""
    b, s, h = x.shape
    hd = config.head_dim
    nh = layer["qkv_w"].shape[1] // (3 * hd)  # this rank's heads
    keep = 1.0 - config.hidden_dropout

    def dropout(t, m):
        if m is None:
            return t
        return torch.where(m != 0, t / keep, 0.0)

    def layer_norm(t, scale, bias):
        return _layer_norm(t, scale, bias, config.layer_norm_eps).to(x.dtype)

    # One [hidden, 3 * hidden] product: the same columns as JAX's three.
    x_in = tp_enter(x, model_group)
    qkv = (torch.matmul(x_in, layer["qkv_w"]) + layer["qkv_b"]).view(b, s, 3, nh, hd)
    q, k, v = (t.permute(0, 2, 1, 3) for t in qkv.unbind(2))
    attn = multi_head_attention(q, k, v, mask, scale=1.0 / hd**0.5)
    attn = torch.matmul(attn.transpose(1, 2).reshape(b, s, nh * hd), layer["o_w"])
    attn = tp_exit(attn, model_group) + layer["o_b"]
    m1, m2 = masks if masks is not None else (None, None)
    x = layer_norm(x + dropout(attn, m1), layer["ln1_s"], layer["ln1_b"])
    ffn = torch.matmul(tp_enter(x, model_group), layer["w1"]) + layer["b1"]
    ffn = _gelu_exact(ffn.to(torch.float32)).to(x.dtype)
    ffn = tp_exit(torch.matmul(ffn, layer["w2"]), model_group) + layer["b2"]
    return layer_norm(x + dropout(ffn, m2), layer["ln2_s"], layer["ln2_b"])


def tower_widths(*masks: torch.Tensor) -> list[int]:
    """The width each attention mask ``[B, S]`` needs: one past the last
    column in which any of its rows holds a real token, rounded up to 16
    (the fused kernels' ``S % 16`` rule) and never wider than S. Every
    mask's in one device read."""
    lasts = []
    for mask in masks:
        cols = torch.arange(1, mask.shape[1] + 1, device=mask.device)
        lasts.append(((mask != 0).any(dim=0) * cols).amax())
    return [
        min(-(-max(last, 1) // 16) * 16, mask.shape[1])
        for last, mask in zip(torch.stack(lasts).tolist(), masks)
    ]


def encode(
    params: Params,
    input_ids: torch.Tensor,
    attention_mask: torch.Tensor,
    config: TowerConfig,
    layers: list[dict] | None = None,
    generator: torch.Generator | None = None,
    model_group=None,
    width: int | None = None,
) -> torch.Tensor:
    """Tower forward: token ids -> unit-norm sentence embedding ``[B, hidden]``.

    ``layers`` are ``prepare_layers(params, config)``; made here if omitted.
    ``generator=None`` runs deterministically (eval/serve); a generator on
    the ids' device trains: dropout masks are drawn from it for the
    embeddings, then m1 and m2 of each layer in turn. The route is chosen
    by shape (``fused_layer.supports``) before any launch. ``config.remat``
    checkpoints each unfused layer; its masks are drawn outside the
    checkpoint, so the recompute sees the same masks.

    ``width`` runs the tower on the first ``width`` columns of the ids and
    the mask alone; the caller vouches that no row holds a real token past
    them (``tower_widths``). Nothing past a row's real tokens reaches its
    embedding: attention and the pool mask those columns, the LayerNorms,
    products and FFN act on each token alone, and a pad token's gradient is
    zero. Every dropout mask is drawn at the handed ``[B, S, hidden]`` shape,
    in the order above, and then cut to ``width`` columns, so each kept
    value and the generator's state after the forward are the uncut
    forward's. Route and form (``supports``, ``saves_residuals``) follow the
    cut shape; every rank of a model group is handed the same batch, so it
    cuts alike.

    ``model_group`` runs the layers on this rank's tensor-parallel shards
    (``params`` local, as ``parallel.shard_params`` cuts them) through the
    unfused layer: the fused kernel's LayerNorm follows the row-parallel
    sum, which would need the all-reduce inside the kernel (the JAX package
    takes its fused route only without a model axis too). Every rank of the
    group must draw the same dropout masks: seed their generators alike.

    While spans record (``utils/profiling.py``) the forward is the span
    ``tower.encode`` and counts ``tower.rows``, ``tower.slots`` (rows times
    the handed width), ``tower.tokens`` (the mask's sum, on the device) and,
    where ``width`` cuts, ``tower.cut_slots`` (rows times the columns cut).
    """
    with span("tower.encode"):
        rows, handed = input_ids.shape
        count("tower.rows", rows)
        count("tower.slots", input_ids.numel())
        count_device("tower.tokens", attention_mask)
        if width is None or width >= handed:
            width = handed
        else:
            count("tower.cut_slots", rows * (handed - width))
        return _forward(
            params, input_ids, attention_mask, config, layers, generator, model_group, width
        )


def _forward(params, input_ids, attention_mask, config, layers, generator, model_group, width):
    if is_modernbert(config):
        if model_group is not None:
            raise ValueError("ModernBERT towers take no tensor-parallel model group")
        return modernbert.forward(params, input_ids, attention_mask, config, layers, generator,
                                  width, DTYPES[config.compute_dtype])
    b, handed = input_ids.shape
    x = embed(params, input_ids, config, generator, width)
    if width < handed:
        attention_mask = attention_mask[:, :width].contiguous()
    if layers is None:
        layers = prepare_layers(params, config)
    drop = generator is not None and config.hidden_dropout > 0.0

    def masks():
        """m1 and m2 of the next layer, drawn at the handed shape, then cut."""
        if not drop:
            return None
        return draw_dropout_masks(
            (b, handed, x.shape[2]), config.hidden_dropout, generator, x.device, x.dtype,
            width=width,
        )

    if model_group is None and supports(
        config.hidden_size, config.num_heads, width, config.intermediate_size
    ):
        kwargs = dict(
            num_heads=config.num_heads,
            scale=1.0 / (config.head_dim**0.5),
            eps=config.layer_norm_eps,
        )
        for layer in layers:
            if generator is None:
                x = fused_encoder_layer(x, attention_mask, layer, **kwargs)
            else:
                x = fused_encoder_layer_train(
                    x,
                    attention_mask,
                    layer,
                    masks=masks(),
                    dropout_rate=config.hidden_dropout,
                    **kwargs,
                )
        return masked_mean_pool_l2norm(x, attention_mask)

    remat = config.remat and torch.is_grad_enabled()
    for layer in layers:
        m = masks()
        if remat:
            x = checkpoint(
                _encoder_layer, x, layer, attention_mask, config, m, model_group,
                use_reentrant=False,
            )
        else:
            x = _encoder_layer(x, layer, attention_mask, config, m, model_group)
    return masked_mean_pool_l2norm(x, attention_mask)
