"""Inputs and checks shared by the GPU tests, ``chip_smoke.py`` and
``scripts/torch_kernel_table.py``: random BERT layers and padding masks at
the port's widths, the fused layer's error limit, ModernBERT-base's layers
and the serve cell's padding, its attention's errors against the plain
version, and the launches of ModernBERT's serve path.

Nothing here runs at import, and nothing needs a GPU until it is called.
"""

import collections
import dataclasses
import re

import numpy as np
import torch

# The fused layer's outputs (K1 in both forms, and the residuals K1 saves):
# two bf16 ulps of the row's largest magnitude, and never less than
# K1_TOL, two ulps at |y| in [4, 8). Another summation order moves the sums
# before each LayerNorm, so an element's error is a few ulps of its row's
# scale, not of its own |y|. Below a row's largest |y| of 8 the limit is
# K1_TOL; above it (wide layers drawn at std 0.05 reach it) the limit
# follows the row's ulp.
K1_TOL = 0.0625

# ModernBERT-base's widths, its global and local RoPE thetas, and the serve
# cell's longest and shortest batch: (rows, tokens).
MB_H, MB_HEADS, MB_INTER = 768, 12, 1152
MB_THETAS = (160000.0, 10000.0)
MB_SERVE_SHAPES = [(16, 8192), (128, 1024)]
# Kernel names of a library the port must not run (cuBLAS, CUTLASS, SDPA,
# flash attention).
LIBRARY_KERNEL_WORDS = ("cublas", "cutlass", "xmma", "nvjet", "sm90_", "flash", "fmha",
                        "efficient_attention", "gemm", "attention")


def bert_layer(dev, g: torch.Generator, h: int, inter: int, std: float) -> dict:
    """One BERT layer's weights drawn from ``g`` (a CPU generator) at
    ``std``, LayerNorm scales near one, prepared for the fused kernels."""
    from instacart_next_order_recommendation_tpu_torch.ops.fused_layer import prepare_layer

    shapes = {
        "q_w": (h, h), "k_w": (h, h), "v_w": (h, h), "o_w": (h, h),
        "q_b": (h,), "k_b": (h,), "v_b": (h,), "o_b": (h,),
        "attn_ln_bias": (h,), "ffn_ln_bias": (h,),
        "ffn_w1": (h, inter), "ffn_b1": (inter,), "ffn_w2": (inter, h), "ffn_b2": (h,),
    }
    raw = {name: std * torch.randn(shape, generator=g) for name, shape in shapes.items()}
    raw["attn_ln_scale"] = 1 + 0.1 * torch.randn(h, generator=g)
    raw["ffn_ln_scale"] = 1 + 0.1 * torch.randn(h, generator=g)
    return prepare_layer({k: v.to(dev) for k, v in raw.items()}, torch.bfloat16)


def padded_mask(batch: int, seq: int, dev, seed: int = 1) -> torch.Tensor:
    """Random real lengths; where B > 1 the last row is all padding."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(1, seq + 1, size=batch)
    lengths[-1] = 0 if batch > 1 else seq
    return torch.from_numpy((np.arange(seq)[None] < lengths[:, None]).astype(np.int32)).to(dev)


def rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """The largest gap relative to ``b``'s largest magnitude."""
    return ((a.float() - b.float()).abs().max() / b.float().abs().max().clamp_min(1e-30)).item()


def bitwise_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """The same shape, dtype and bits."""
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8))


def bf16_ulp(a: torch.Tensor) -> torch.Tensor:
    """The spacing of bf16 values at |a|: 2^(e - 7) for |a| in [2^e, 2^(e+1))."""
    return torch.exp2(torch.floor(torch.log2(a.float().abs().clamp_min(2.0**-126))) - 7)


def k1_excess(y: torch.Tensor, y_ref: torch.Tensor) -> float:
    """The largest of each row's error over its limit (see K1_TOL): the
    output is within the limit where this is at most 1."""
    a, b = y.float(), y_ref.float()
    limit = (2 * bf16_ulp(b.abs().amax(-1, keepdim=True))).clamp_min(K1_TOL)
    return float(((a - b).abs() / limit).max())


# ------------------------------------------------------------------ ModernBERT


def modernbert_layers(dev, seed: int, unit_gain: bool) -> tuple[dict, list]:
    """A two-layer ModernBERT-base (layer 0 global, layer 1 banded), norm
    scales drawn away from one: its params on ``dev`` and its prepared
    layers. ``unit_gain``: projections drawn at fan_in^-1/2, so that
    attention and GeGLU move the layer's output as much as each other (at
    the published 0.02 the attention's share is small)."""
    from instacart_next_order_recommendation_tpu_torch.models.encoder import (
        MODERNBERT_BASE,
        init_params,
        prepare_layers,
    )

    cfg = dataclasses.replace(MODERNBERT_BASE, num_layers=2)
    g = torch.Generator().manual_seed(seed)
    params = init_params(cfg, g)
    if unit_gain:
        for name, fan in (("qkv_w", MB_H), ("o_w", MB_H), ("wi", MB_H), ("wo_mlp", MB_INTER)):
            params["layers"][name].normal_(0.0, fan ** -0.5, generator=g)
    for name in ("attn_ln_scale", "mlp_ln_scale"):
        params["layers"][name].uniform_(0.5, 1.5, generator=g)
    params = {k: {n: t.to(dev) for n, t in v.items()} for k, v in params.items()}
    return params, prepare_layers(params, cfg)


def modernbert_serve_mask(b: int, s: int, dev) -> torch.Tensor:
    """The serve cell's padding: row 0 whole; the others from 7/8 of S down
    to half of it; the last only 40 tokens, inside one band."""
    lengths = [s] + [s - (r * s) // (2 * b) - s // 8 for r in range(1, b - 1)] + [40]
    mask = torch.zeros(b, s, dtype=torch.int32, device=dev)
    for r, n in enumerate(lengths):
        mask[r, :n] = 1
    return mask


def masked_rel(got: torch.Tensor, want: torch.Tensor, mask: torch.Tensor) -> float:
    """Real query rows only: the gap relative to the largest magnitude."""
    real = mask.bool()
    w = want[real].float()
    return float((got[real].float() - w).abs().max()) / float(w.abs().max())


def attention_errors(qkv: torch.Tensor, mask: torch.Tensor, half: int) -> dict[str, float]:
    """``modernbert_attention`` in the form ``half`` picks (-1 global at
    theta 160,000; 64 banded at theta 10,000) against its plain version,
    against the plain version with the other band, and with the other
    theta: each ``masked_rel``."""
    from instacart_next_order_recommendation_tpu_torch.ops import modernbert as mb

    s = qkv.shape[1]
    theta, other_theta = (MB_THETAS[0], MB_THETAS[1]) if half < 0 else MB_THETAS[::-1]
    got = mb.modernbert_attention(qkv, mask, num_heads=MB_HEADS, theta=theta, half=half)
    cos, sin = mb.rope_tables(s, theta, qkv.device)

    def plain(cos, sin, half):
        return mb.attention_reference(qkv, mask, cos, sin, num_heads=MB_HEADS, half=half)

    return {
        "max_rel_err": masked_rel(got, plain(cos, sin, half), mask),
        "err_other_band": masked_rel(got, plain(cos, sin, 64 if half < 0 else -1), mask),
        "err_other_theta": masked_rel(
            got, plain(*mb.rope_tables(s, other_theta, qkv.device), half), mask),
    }


def _kernel_name(name: str) -> str:
    """A demangled kernel name without its return type and parameter list."""
    m = re.search(r"([\w:]+(?:<[^()]*>)?)\(", name)
    return (m.group(1) if m else name).replace("(anonymous namespace)::", "")


def serve_path_launches(dev) -> dict:
    """ModernBERT-base's serve path, all 22 layers (random weights, a
    WordPiece vocab): the wrappers' launches over ``encode_resident`` of 512
    products in batches of 256 (``"encode"``), then for one
    ``FusedServePipeline.topk_device`` call at each of MB_SERVE_SHAPES,
    every row after the first padded, the wrappers' launches, zeroed just
    before (``"wrappers"``), and what the profiler saw of a second call:
    its attention kernels by form, its GEMM-core launches and any library
    kernel. Also the layer count and how many layers are global."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from instacart_next_order_recommendation_tpu_torch.index import ShardedCatalogIndex
    from instacart_next_order_recommendation_tpu_torch.models import modernbert
    from instacart_next_order_recommendation_tpu_torch.models.encoder import (
        MODERNBERT_BASE,
        init_params,
    )
    from instacart_next_order_recommendation_tpu_torch.models.text_encoder import TextEncoder
    from instacart_next_order_recommendation_tpu_torch.ops import (
        cosine_topk,
        masked_mean_pool_l2norm,
    )
    from instacart_next_order_recommendation_tpu_torch.ops import modernbert as mb
    from instacart_next_order_recommendation_tpu_torch.serve.pipeline import FusedServePipeline
    from instacart_next_order_recommendation_tpu_torch.tokenizer import WordPieceTokenizer
    from instacart_next_order_recommendation_tpu_torch.utils.bench_texts import (
        build_catalog_texts,
    )

    wrappers = (mb.modernbert_layer, mb.modernbert_attention, mb.modernbert_final_norm,
                masked_mean_pool_l2norm, cosine_topk)

    def counted(fn) -> dict[str, int]:
        for w in wrappers:
            w.launches = 0
        fn()
        torch.cuda.synchronize()
        return {w.__name__: w.launches for w in wrappers}

    cfg = MODERNBERT_BASE
    catalog = build_catalog_texts(512, np.random.default_rng(23))
    tok = WordPieceTokenizer.train(catalog, vocab_size=30_000)
    params = init_params(cfg, torch.Generator().manual_seed(23))
    params = {k: {n: t.to(dev) for n, t in v.items()} for k, v in params.items()}
    encoder = TextEncoder(params, cfg, tok, max_seq_length=cfg.max_seq_length, device=dev)
    emb = []
    out = {"layers": cfg.num_layers,
           "global": sum(1 for i in range(cfg.num_layers) if modernbert.is_global(cfg, i)),
           "encode": counted(lambda: emb.append(encoder.encode_resident(catalog, batch_size=256)))}
    index = ShardedCatalogIndex(emb[0], mesh=None, device=dev)
    fused = FusedServePipeline(encoder.params, cfg, index.catalog, len(catalog), pad_id=tok.pad_id,
                               layers=encoder.layers, device=dev)
    rng = np.random.default_rng(24)
    for b, s in MB_SERVE_SHAPES:
        ids = rng.integers(5, tok.vocab_size, size=(b, s)).astype(np.int32)
        ids[1:, s - s // 4 :] = tok.pad_id
        call = counted(lambda: fused.topk_device(ids, None, 10))
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fused.topk_device(ids, None, 10)
            torch.cuda.synchronize()
        names = collections.Counter()
        for e in prof.events():
            if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False):
                names[_kernel_name(e.name)] += 1
        out[b, s] = {
            "wrappers": call,
            "attention": {form: sum(n for name, n in names.items()
                                    if f"mb_attn_{form}_kernel" in name)
                          for form in ("global", "band")},
            "gemm": sum(n for name, n in names.items() if name.startswith("fl::gemm_wgmma_kernel")),
            "library": sorted(name for name in names
                              if any(w in name.lower() for w in LIBRARY_KERNEL_WORDS)
                              and not name.startswith(("fl::", "mb::"))),
        }
    return out
