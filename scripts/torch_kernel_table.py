#!/usr/bin/env python3
"""Time every row of PERF.md section 6's kernel table on one NVIDIA GPU.

Run from the repository root:

    python3 scripts/torch_kernel_table.py [--only fused|pool|topk|attention|modernbert]

A row is one kernel at one shape: its milliseconds, CUDA-event medians read
in turns with its plain version and its library yardstick (which the port
never calls); its largest error against the plain version, a reading only
(``tests/test_torch_kernels_gpu.py`` and ``tests/test_torch_modernbert_gpu.py``
hold the limits); and its bound, the least time the card could take.
Bounds come from ``benchmark/counts.py`` and ``benchmark/counts_modernbert.py``
wherever they count the kernel (K1, K3/K4, K5, ModernBERT's attention,
products and passes), so that the table and the benchmark's rooflines count
the same work; K2, K6/K7 and K3's f32-FMA and bf16 forms have formulas of
their own here. A ModernBERT layer row's bound is the layer function's own
work (x read and y written, the weights once, its products and attention
at the counts' operations); its kernels' bounds summed, which count the
intermediates one kernel writes and the next reads, stand beside it
(``kernels_bound_ms``). K3/K4 rows add the merge's share of the call's device time
(``torch.profiler``). The last line is one JSON object: the card and every
row. Exits non-zero where CUDA is absent. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
sys.path.append(str(REPO / "tests"))  # gpu_cases, by module name

from benchmark import counts  # noqa: E402
from benchmark import counts_modernbert as cm  # noqa: E402
from gpu_cases import (  # noqa: E402
    attention_errors,
    bert_layer,
    masked_rel,
    modernbert_layers,
    modernbert_serve_mask,
    padded_mask,
    rel_err,
)

PEAK_F32 = 67e12  # FLOP/s, f32 FMA outside the tensor cores (H100 SXM data sheet)
READ_MS = 20.0  # a chained reading runs about this long
TURNS = 6
BEHIND_CALLS = 30  # calls a reading behind a flush or a spin, each timed alone
FLUSH_BYTES = 256 << 20  # five times the H100's 50 MB L2
SPIN_CYCLES = 200_000  # torch.cuda._sleep: about 0.1 ms at the H100's clock

# (hidden, heads, intermediate)
MINILM = (384, 12, 1536)
MPNET = (768, 12, 3072)
HD16 = (256, 16, 1024)
HD128 = (768, 6, 3072)
FORWARD_SHAPES = [  # (label, widths, B, S)
    ("MiniLM serve", MINILM, 256, 192), ("mpnet serve", MPNET, 256, 192),
    ("MiniLM S=512", MINILM, 64, 512), ("MiniLM S=512", MINILM, 256, 512),
    ("mpnet S=512", MPNET, 64, 512), ("head_dim 16", HD16, 8, 320),
    ("head_dim 128", HD128, 8, 512),
]
TRAIN_SHAPES = [
    ("MiniLM train", MINILM, 64, 256), ("MiniLM flagship", MINILM, 512, 256),
    ("mpnet train", MPNET, 64, 256), ("MiniLM S=512", MINILM, 64, 512),
    ("MiniLM S=512", MINILM, 256, 512), ("mpnet S=512", MPNET, 64, 512),
    ("head_dim 16", HD16, 8, 320), ("head_dim 128", HD128, 8, 512),
]
# K2: the serve batch, one recommend (S=64 and a longer query), a catalog
# batch and a train step, at MiniLM-L6's and mpnet-base-class's widths.
POOL_SHAPES = [(256, 192), (1, 64), (1, 160), (512, 32), (64, 256)]
N_CATALOG = 50_000
N_1M = 1_000_000
# K6/K7 (B, heads, S, head_dim): mpnet-base-class's steps at S=200, its serve
# and training batches, MiniLM-L6 at S=512 and 200, head_dim 128.
ATTENTION_SHAPES = [
    ("mpnet steps S=200", 64, 12, 200, 64), ("mpnet serve", 256, 12, 192, 64),
    ("mpnet train", 64, 12, 256, 64), ("MiniLM S=512", 64, 12, 512, 32),
    ("MiniLM S=200", 64, 12, 200, 32), ("head_dim 128", 64, 12, 512, 128),
]
MODERNBERT_SHAPES = [(16, 8192), (128, 1024)]  # the serve cell's longest and shortest batch


def log(msg: str) -> None:
    print(msg, flush=True)


# ------------------------------------------------------------------ timing


def _chain_ms(fn, iters: int) -> float:
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _behind_ms(fn, before) -> float:
    """The median of BEHIND_CALLS calls, each timed alone behind ``before()``'s
    device work, outside its events: the host enqueues the call while the
    card is busy, so its own overhead is not timed."""
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(BEHIND_CALLS)]
    for start, end in events:
        before()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return float(np.median([start.elapsed_time(end) for start, end in events]))


def flush_l2() -> None:
    """Write a buffer of five times the L2 and read it back, so that the
    cache holds clean lines of it only."""
    torch.ones(FLUSH_BYTES // 4, dtype=torch.float32, device="cuda").sum()


def spin() -> None:
    torch.cuda._sleep(SPIN_CYCLES)


def in_turns(fns: dict, before=None) -> dict[str, float]:
    """Each function's median ms over TURNS readings taken in turns, the
    order reversed every other turn, so that a kernel and its yardsticks see
    the same state of the card. A reading chains calls for about READ_MS
    after a warm-up call or, with ``before`` (``flush_l2`` or ``spin``),
    times calls alone behind it (``_behind_ms``)."""
    iters = {}
    for name, fn in fns.items():
        fn()
        torch.cuda.synchronize()
        iters[name] = max(1, min(200, int(READ_MS / max(_chain_ms(fn, 1), 1e-3))))
    readings: dict[str, list[float]] = {name: [] for name in fns}
    names = list(fns)
    for turn in range(TURNS):
        for name in names if turn % 2 == 0 else names[::-1]:
            fn = fns[name]
            readings[name].append(_chain_ms(fn, iters[name]) if before is None
                                  else _behind_ms(fn, before))
    return {name: float(np.median(r)) for name, r in readings.items()}


def merge_share(fn) -> float | None:
    """The share of one top-k call's device time outside its slice kernel
    (the merge and any other launch), over five calls under torch.profiler;
    None where the profiler saw no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            fn()
        torch.cuda.synchronize()
    total = slices = 0.0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False):
            us = e.time_range.elapsed_us()
            total += us
            slices += us if "topk_slices" in e.name else 0.0
    return None if total == 0 else 1.0 - slices / total


# ------------------------------------------------------------------ bounds


def bound(bound_s: float, ops_s: float) -> dict:
    """A bound in ms and what sets it: the operations where ``bound_s`` is
    the operations' time ``ops_s``, else the bytes."""
    return {"bound_ms": bound_s * 1e3,
            "bound_by": "operations" if math.isclose(bound_s, ops_s) else "bytes"}


def own_bound(n_bytes: float, ops: float, peak: float) -> dict:
    return bound(counts.bound_s(n_bytes, ops, peak), ops / peak)


def k3_bound(b: int, n: int, d: int, k: int) -> dict:
    return bound(counts.k3_bound_s(b, n, d, k), 2.0 * b * n * d / counts.PEAK_TF32)


def k3_fma_bound_ms(b: int, n: int, d: int, k: int) -> float:
    """The f32 function on f32 FMA: K3's bytes against 2 B N D at PEAK_F32."""
    return counts.bound_s(n * d * 4 + b * d * 4 + b * k * 8, 2.0 * b * n * d, PEAK_F32) * 1e3


def k3_bf16_bound(b: int, n: int, d: int, k: int) -> dict:
    """K3/K4 on bf16 rows: the rows and queries at 2 bytes an element, one
    bf16 tensor-core product per multiply-add."""
    return own_bound(n * d * 2 + b * d * 2 + b * k * 8, 2.0 * b * n * d, counts.PEAK_BF16)


def attention_bound(b: int, heads: int, s: int, d: int, backward: bool) -> dict:
    """K6 reads q, k, v and writes o (4 B h S D bf16), 4 B h S^2 D
    operations; K7 reads q, k, v, dO and writes dq, dk, dv (7 B h S D), 10
    B h S^2 D operations; both read the f32 key bias. Operations at the bf16
    peak."""
    unit = b * heads * s * s * d
    tensors, ops = (7, 10 * unit) if backward else (4, 4 * unit)
    return own_bound(tensors * b * heads * s * d * 2 + b * s * 4, ops, counts.PEAK_BF16)


# ------------------------------------------------------------------ rows


class Table:
    def __init__(self, dev, card: str):
        self.dev, self.card = dev, card
        self.rows: list[dict] = []

    def add(self, row: str, shape: str, ms: dict, **fields) -> None:
        entry = {"row": row, "shape": shape, **ms, **fields}
        self.rows.append(entry)
        log(f"{row:<14} {shape:<40} " + " ".join(
            f"{k}={v:.5g}" if isinstance(v, float) else f"{k}={v}"
            for k, v in entry.items() if k not in ("row", "shape")))


def torch_layer(widths, dropout: float, dev) -> torch.nn.Module:
    """nn.TransformerEncoderLayer at these widths: the yardstick of K1 (eval,
    its fused fast path) and of K1-train and K5 (train mode, autograd)."""
    h, heads, inter = widths
    layer = torch.nn.TransformerEncoderLayer(
        d_model=h, nhead=heads, dim_feedforward=inter, dropout=dropout, activation="gelu",
        batch_first=True, norm_first=False,
    ).to(dev, torch.bfloat16)
    return layer.train() if dropout else layer.eval()


def fused_rows(t: Table) -> None:
    """K1 at FORWARD_SHAPES; K1-train, K5 and K5 reading the residuals at
    TRAIN_SHAPES, K1-train in the form ``saves_residuals`` picks, as in
    training."""
    from instacart_next_order_recommendation_tpu_torch.ops import fused_layer
    from instacart_next_order_recommendation_tpu_torch.ops.fused_layer import (
        WEIGHT_NAMES,
        draw_dropout_masks,
        fused_encoder_layer,
        fused_encoder_layer_backward,
        fused_encoder_layer_backward_reference,
        fused_encoder_layer_reference,
        fused_encoder_layer_train,
        fused_encoder_layer_train_reference,
    )

    dev = t.dev
    g = torch.Generator().manual_seed(1)
    for label, (h, heads, inter), b, s in FORWARD_SHAPES:
        kw = dict(num_heads=heads, scale=(h // heads) ** -0.5, eps=1e-12)
        layer = bert_layer(dev, g, h, inter, 0.02)
        x = torch.randn((b, s, h), generator=g).to(dev, torch.bfloat16)
        m = padded_mask(b, s, dev, seed=b + s)
        lib, pad = torch_layer((h, heads, inter), 0.0, dev), m == 0
        with torch.inference_mode():
            err = (fused_encoder_layer(x, m, layer, **kw).float()
                   - fused_encoder_layer_reference(x, m, layer, **kw).float()).abs().max().item()
            ms = in_turns({"ms": lambda: fused_encoder_layer(x, m, layer, **kw),
                           "plain_ms": lambda: fused_encoder_layer_reference(x, m, layer, **kw),
                           "library_ms": lambda: lib(x, src_key_padding_mask=pad)})
        t.add("K1", f"{label} h{h} B={b} S={s}", ms, max_abs_err=err,
              **bound(counts.k1_bound_s(b, s, h, inter),
                      counts.layer_ops(b, s, h, inter) / counts.PEAK_BF16))
    for label, (h, heads, inter), b, s in TRAIN_SHAPES:
        kw = dict(num_heads=heads, scale=(h // heads) ** -0.5, eps=1e-12)
        layer = bert_layer(dev, g, h, inter, 0.02)
        x, up = (torch.randn((b, s, h), generator=g).to(dev, torch.bfloat16) for _ in range(2))
        m = padded_mask(b, s, dev, seed=b + s)
        bias = ((1.0 - m.float()) * -1e9).contiguous()
        masks = draw_dropout_masks((b, s, h), 0.1, torch.Generator(device=dev).manual_seed(b + s),
                                   dev, torch.bfloat16)
        _, resids = fused_layer._launch(x, bias, layer, masks, **kw, save_resid=True)
        lib = torch_layer((h, heads, inter), 0.1, dev)
        xr = x.detach().requires_grad_(True)
        y_lib = lib(xr, src_key_padding_mask=m == 0)
        lib_inputs = [xr, *lib.parameters()]
        fns = {
            "k1": lambda: fused_encoder_layer_train(x, m, layer, masks=masks, dropout_rate=0.1,
                                                    **kw),
            "plain1": lambda: fused_encoder_layer_train_reference(x, m, layer, masks=masks, **kw),
            "lib_fwd": lambda: lib(xr, src_key_padding_mask=m == 0),
            "k5": lambda: fused_encoder_layer_backward(x, bias, up, masks, layer, **kw),
            "k5_resid": lambda: fused_encoder_layer_backward(x, bias, up, masks, layer, **kw,
                                                             resids=resids),
            "plain5": lambda: fused_encoder_layer_backward_reference(x, bias, up, masks, layer,
                                                                     **kw),
            "lib_bwd": lambda: torch.autograd.grad(y_lib, lib_inputs, up, retain_graph=True),
        }
        err1 = (fns["k1"]().float() - fns["plain1"]().float()).abs().max().item()
        (dx, dw), (dx_r, dw_r) = fns["k5"](), fns["plain5"]()
        err5 = max([rel_err(dx, dx_r)] + [rel_err(dw[n], dw_r[n]) for n in WEIGHT_NAMES])
        del dx, dw, dx_r, dw_r
        ms = in_turns(fns)
        what = f"{label} h{h} B={b} S={s}"
        form = "resid" if fused_layer.saves_residuals(b, s, h, inter) else "recompute"
        t.add("K1-train", what, {"ms": ms["k1"], "plain_ms": ms["plain1"],
                                 "library_ms": ms["lib_fwd"]}, form=form, max_abs_err=err1,
              **bound(counts.k1_bound_s(b, s, h, inter, masked=True),
                      counts.layer_ops(b, s, h, inter) / counts.PEAK_BF16))
        k5_bound = bound(counts.k5_bound_s(b, s, h, inter),
                         2.0 * counts.layer_ops(b, s, h, inter) / counts.PEAK_BF16)
        for row, key in (("K5", "k5"), ("K5-resid", "k5_resid")):
            t.add(row, what, {"ms": ms[key], "plain_ms": ms["plain5"],
                              "library_ms": ms["lib_bwd"]}, max_rel_err=err5, **k5_bound)
        del fns, resids, y_lib, lib_inputs, lib
        torch.cuda.empty_cache()


def pool_rows(t: Table) -> None:
    """K2 at POOL_SHAPES, cold (the L2 flushed before each call) and warm
    (behind a spin of the card), in turns with the same function in a few
    PyTorch calls; the form ``pool_plan`` picks."""
    from instacart_next_order_recommendation_tpu_torch.ops import pool_norm

    dev = t.dev
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    g = torch.Generator().manual_seed(21)
    for h in (MINILM[0], MPNET[0]):
        for b, s in POOL_SHAPES:
            y = torch.randn((b, s, h), generator=g).to(dev, torch.bfloat16)
            m = padded_mask(b, s, dev, seed=b + s)
            mf = m.float()
            fns = {
                "ms": lambda: pool_norm.masked_mean_pool_l2norm(y, m),
                "yardstick_ms": lambda: torch.nn.functional.normalize(
                    (y.float() * mf[..., None]).sum(1) / mf.sum(1, keepdim=True).clamp_min(1e-9),
                    dim=-1),
            }
            warm = in_turns(fns, before=spin)
            fns["plain_ms"] = lambda: pool_norm.masked_mean_pool_l2norm_reference(y, m)
            cold = in_turns(fns, before=flush_l2)
            err = (fns["ms"]() - fns["plain_ms"]()).abs().max()
            bnd = own_bound(b * s * h * 2 + b * s * 4 + b * h * 4, 2.0 * b * s * h, PEAK_F32)
            t.add("K2", f"h{h} B={b} S={s}", cold,
                  warm_ms=warm["ms"], yardstick_warm_ms=warm["yardstick_ms"],
                  form=pool_norm.pool_plan(b, s, sms)._asdict(), max_abs_err=err.item(),
                  bound_share_cold=bnd["bound_ms"] / cold["ms"], **bnd)


def unit_rows(n: int, d: int, g: torch.Generator, dev, around: torch.Tensor | None = None):
    """``n`` random unit rows; ``around``: a direction they spread around
    (0.2 of a random row's length), as an untrained tower's embeddings
    cluster."""
    x = torch.randn((n, d), generator=g, device=dev)
    if around is not None:
        x = around + 0.2 * x
    return x / x.norm(dim=1, keepdim=True)


def topk_rows(t: Table) -> None:
    """K3 and K4 on f32 unit rows at the serve path's 50k (one query and the
    batch, each list size the k rule picks) and at 1M rows (K4 beside K3);
    then both on bf16 rows beside the f32 K3 on the same rows."""
    from instacart_next_order_recommendation_tpu_torch.ops.topk import (
        cosine_topk,
        cosine_topk_packed_reference,
        cosine_topk_reference,
    )

    dev = t.dev
    g = torch.Generator(device=dev).manual_seed(9)
    cases = [  # (N, D, B, k, packed, clustered), one catalog for each run of (N, D, clustered)
        (N_CATALOG, 384, 256, 16, False, False), (N_CATALOG, 384, 1, 16, False, False),
        *((N_CATALOG, 384, 256, k, False, False) for k in (10, 100, 256)),
        (N_CATALOG, 384, 256, 16, True, False), (N_CATALOG, 384, 8, 16, True, False),
        (N_CATALOG, 768, 256, 16, False, False), (N_CATALOG, 768, 1, 16, False, False),
        (N_CATALOG, 384, 256, 16, False, True), (N_CATALOG, 384, 256, 16, True, True),
        (N_1M, 384, 8, 10, True, False), (N_1M, 384, 256, 10, True, False),
    ]
    catalog = None
    for n, d, b, k, packed, clustered in cases:
        if catalog is None or catalog[0] != (n, d, clustered):
            catalog = None
            torch.cuda.empty_cache()
            around = torch.randn((1, d), generator=g, device=dev) if clustered else None
            catalog = ((n, d, clustered), unit_rows(n, d, g, dev, around), around)
        _, c, around = catalog
        q = unit_rows(b, d, g, dev, around)
        plain = cosine_topk_packed_reference if packed else cosine_topk_reference
        fns = {"ms": lambda: cosine_topk(q, c, k, packed=packed),
               "plain_ms": lambda: plain(q, c, k),
               "library_ms": lambda: torch.topk(torch.mm(q, c.T), k)}
        if packed:
            fns["k3_ms"] = lambda: cosine_topk(q, c, k)
        s_k, i_k = fns["ms"]()
        s_r, i_r = fns["plain_ms"]()
        ms = in_turns(fns)
        t.add("K4" if packed else "K3",
              f"N={n} D={d} B={b} k={k}" + (" clustered" if clustered else ""), ms,
              max_abs_err=(s_k - s_r).abs().max().item(),
              ids_identical=float((i_k == i_r).float().mean()),
              merge_share=merge_share(fns["ms"]), f32_fma_bound_ms=k3_fma_bound_ms(b, n, d, k),
              **k3_bound(b, n, d, k))
    catalog = None
    for n, b, k in ((N_1M, 8, 10), (N_1M, 256, 10), (N_CATALOG, 256, 16)):
        c = unit_rows(n, 384, g, dev).to(torch.bfloat16)
        q = unit_rows(b, 384, g, dev).to(torch.bfloat16)
        c32, q32 = c.float(), q.float()
        fns = {"k3": lambda: cosine_topk(q, c, k), "k4": lambda: cosine_topk(q, c, k, packed=True),
               "k3_f32": lambda: cosine_topk(q32, c32, k),
               "plain3": lambda: cosine_topk_reference(q, c, k),
               "plain4": lambda: cosine_topk_packed_reference(q, c, k),
               "library": lambda: torch.topk(torch.mm(q, c.T), k)}
        errs = {key: (fns[key]()[0] - fns[f"plain{key[1]}"]()[0]).abs().max().item()
                for key in ("k3", "k4")}
        ms = in_turns(fns)
        for key, row in (("k3", "K3-bf16"), ("k4", "K4-bf16")):
            t.add(row, f"N={n} D=384 B={b} k={k}",
                  {"ms": ms[key], "plain_ms": ms[f"plain{key[1]}"], "library_ms": ms["library"]},
                  f32_k3_ms=ms["k3_f32"], max_abs_err=errs[key],
                  merge_share=merge_share(fns[key]), **k3_bf16_bound(b, n, 384, k))
        del c, q, c32, q32, fns
        torch.cuda.empty_cache()


def attention_rows(t: Table) -> None:
    """K6 and K7 at ATTENTION_SHAPES beside one scaled_dot_product_attention
    call with the same key bias and its autograd backward."""
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    from instacart_next_order_recommendation_tpu_torch.ops import (
        multi_head_attention,
        multi_head_attention_backward,
        multi_head_attention_backward_reference,
        multi_head_attention_reference,
    )

    dev = t.dev
    g = torch.Generator().manual_seed(7)
    for label, b, heads, s, d in ATTENTION_SHAPES:
        q, k, v, do = (torch.randn((b, heads, s, d), generator=g).to(dev, torch.bfloat16)
                       for _ in range(4))
        m = padded_mask(b, s, dev, seed=b + s)
        scale = d**-0.5
        key_bias = ((1.0 - m.float()) * -1e9).to(q.dtype)[:, None, None, :]
        qr, kr, vr = (x.detach().requires_grad_(True) for x in (q, k, v))
        y = sdpa(qr, kr, vr, attn_mask=key_bias, scale=scale)
        fns = {
            "k6": lambda: multi_head_attention(q, k, v, m, scale),
            "plain6": lambda: multi_head_attention_reference(q, k, v, m, scale),
            "sdpa": lambda: sdpa(q, k, v, attn_mask=key_bias, scale=scale),
            "k7": lambda: multi_head_attention_backward(q, k, v, m, do, scale),
            "plain7": lambda: multi_head_attention_backward_reference(q, k, v, m, do, scale),
            "sdpa_bwd": lambda: torch.autograd.grad(y, (qr, kr, vr), do, retain_graph=True),
        }
        err6 = rel_err(fns["k6"](), fns["plain6"]())
        err7 = max(rel_err(a, r) for a, r in zip(fns["k7"](), fns["plain7"]()))
        ms = in_turns(fns)
        what = f"{label} B={b} h={heads} S={s} D={d}"
        t.add("K6", what, {"ms": ms["k6"], "plain_ms": ms["plain6"], "library_ms": ms["sdpa"]},
              max_rel_err=err6, **attention_bound(b, heads, s, d, backward=False))
        t.add("K7", what, {"ms": ms["k7"], "plain_ms": ms["plain7"], "library_ms": ms["sdpa_bwd"]},
              max_rel_err=err7, **attention_bound(b, heads, s, d, backward=True))
        del fns, y, q, k, v, do, qr, kr, vr
        torch.cuda.empty_cache()


def modernbert_rows(t: Table) -> None:
    """ModernBERT's attention (global, theta 160,000; banded, |i - j| <= 64,
    theta 10,000; RoPE and the wrapper's copy of qkv included), its layer in
    both forms and its final norm at MODERNBERT_SHAPES, every row after the
    first padded. The attention's errors against the plain version with the
    other band and with the other theta are read too."""
    from instacart_next_order_recommendation_tpu_torch.models.encoder import MODERNBERT_BASE
    from instacart_next_order_recommendation_tpu_torch.ops import modernbert as mb

    dev, cfg = t.dev, MODERNBERT_BASE
    h, heads, inter = cfg.hidden_size, cfg.num_heads, cfg.intermediate_size
    thetas = {-1: cfg.global_rope_theta, 64: cfg.local_rope_theta}
    params, layers = modernbert_layers(dev, 23, unit_gain=True)
    # The weights read once: four products' bf16 matrices, two f32 norm scales.
    weight_bytes = (4 * h * h + 3 * h * inter) * 2 + 2 * h * 4
    g = torch.Generator(device=dev).manual_seed(23)
    for b, s in MODERNBERT_SHAPES:
        mask = modernbert_serve_mask(b, s, dev)
        qkv = torch.randn(b, s, 3 * h, generator=g, device=dev).to(torch.bfloat16)
        x = torch.randn(b, s, h, generator=g, device=dev)
        m = b * s
        for half in (-1, 64):
            form = "global" if half < 0 else "band"
            theta = thetas[half]
            cos, sin = mb.rope_tables(s, theta, dev)
            kw = dict(num_heads=heads, theta=theta, half=half)
            errs = attention_errors(qkv, mask, half)
            q, k = (mb.rope_reference(
                qkv[..., i * h:(i + 1) * h].reshape(b, s, heads, 64).transpose(1, 2), cos, sin)
                for i in (0, 1))
            v = qkv[..., 2 * h:].reshape(b, s, heads, 64).transpose(1, 2)
            pos = torch.arange(s, device=dev)
            allowed = mask.bool()[:, None, None, :]
            if half >= 0:
                allowed = allowed & ((pos[:, None] - pos[None, :]).abs() <= half)
            ms = in_turns({
                "ms": lambda: mb.modernbert_attention(qkv, mask, **kw),
                "plain_ms": lambda: mb.attention_reference(qkv, mask, cos, sin, num_heads=heads,
                                                           half=half),
                "library_ms": lambda: torch.nn.functional.scaled_dot_product_attention(
                    q, k, v, attn_mask=allowed),
            })
            if half < 0:
                attn_s = cm.global_attention_bound_s(b, s, h)
                attn_ops = b * float(cm.global_attention_ops(s, h))
            else:
                attn_s = cm.band_attention_bound_s(b, s, h)
                attn_ops = b * float(cm.band_attention_ops(s, h))
            t.add(f"MB attn {form}", f"B={b} S={s}", ms, **errs,
                  **bound(attn_s, attn_ops / counts.PEAK_BF16))
            del q, k, v, allowed
            layer = layers[0 if half < 0 else 1]
            lkw = dict(num_heads=heads, eps=cfg.layer_norm_eps, theta=theta, half=half)
            err = masked_rel(mb.modernbert_layer(x, mask, layer, **lkw) - x,
                             mb.layer_reference(x, mask, layer, **lkw) - x, mask)
            ms = in_turns({"ms": lambda: mb.modernbert_layer(x, mask, layer, **lkw),
                           "plain_ms": lambda: mb.layer_reference(x, mask, layer, **lkw)})
            # The bound: the layer function's own work, x read and y written
            # (f32) and the weights once; beside it, its kernels' bounds
            # summed, which count the intermediates each kernel writes and
            # the next reads.
            ops = b * float(cm.product_ops(s, h, inter)) + attn_ops
            passes = cm.rope_bytes(m, s, h) + cm.geglu_bytes(m, inter) + 2 * cm.rownorm_bytes(m, h)
            t.add(f"MB layer {form}", f"B={b} S={s}", ms, library_ms=None, max_rel_err=err,
                  **own_bound(m * h * 8 + weight_bytes, ops, counts.PEAK_BF16),
                  kernels_bound_ms=(cm.gemm_bound_s(m, h, inter) + attn_s
                                    + passes / cm.PEAK_BYTES) * 1e3)
            torch.cuda.empty_cache()
        scale = params["final"]["ln_scale"]
        err = masked_rel(mb.modernbert_final_norm(x, scale, eps=1e-5, dtype=torch.bfloat16),
                         mb._norm(x, scale, 1e-5), mask)
        ms = in_turns({
            "ms": lambda: mb.modernbert_final_norm(x, scale, eps=1e-5, dtype=torch.bfloat16),
            "plain_ms": lambda: mb._norm(x, scale, 1e-5).to(torch.bfloat16),
        })
        t.add("MB final norm", f"B={b} S={s}", ms, library_ms=None, max_rel_err=err,
              bound_ms=cm.rownorm_bytes(m, h) / cm.PEAK_BYTES * 1e3, bound_by="bytes")
        del qkv, x, mask
        torch.cuda.empty_cache()


GROUPS = {"fused": fused_rows, "pool": pool_rows, "topk": topk_rows,
          "attention": attention_rows, "modernbert": modernbert_rows}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--only", choices=tuple(GROUPS), default=None,
                        help="time this group of rows alone")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_kernel_table: CUDA is not available; this script needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"{card}; torch {torch.__version__} cuda {torch.version.cuda}")
    table = Table(torch.device("cuda"), card)
    for name, rows in GROUPS.items():
        if args.only in (None, name):
            rows(table)
    print(json.dumps({"card": card, "kernels": table.rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
