#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

1. Device and build: prints the card (``nvidia-smi`` name and power limit)
   and builds the port's CUDA kernels from ``ops/csrc`` in this checkout.
2. Each kernel against its plain PyTorch version on the card, at the serve
   path's shapes, with the tolerance stated, timed with CUDA events; then
   the training form of the fused layer (K1 with dropout masks) and the
   fused backward (K5) at B in {1, 64, 512} and S in {32, 64, 128, 256}.
3. The serve path at the full width of MiniLM-L6 (random weights from a
   seeded generator): a WordPiece vocab trained on a 50,000-product catalog,
   ``Recommender`` encoding the catalog through the kernels, a few
   ``recommend`` calls (one excluding ids, one filtered to an aisle, one
   whose top_k + |excluded| > 256 takes the dense top-k route), a batch of
   256 queries through ``FusedServePipeline``, and single-query latency.
   The launch counts show the path ran through every kernel, and the
   batch's top-16 ids are held against the plain versions on the card.
4. MNRL training of MiniLM-L6 at full width through
   ``TwoTowerTrainer.train(data=...)``: synthetic (user context, product)
   pairs in the data prep's p5_mp20 form (the last 5 prior orders, at most
   20 real-length product names, so the pairs bucket to S=256 as in
   ``configs/train.yaml``), batch 64 for 2 epochs with an IR eval on a
   2,000-product corpus. The launch counts show 12 train-form K1 and 12 K5
   launches per step; the loss must fall, ``final/`` must load in
   ``Recommender``, and the trained NDCG@10 is printed beside the untrained
   tower's. Then 3 steps at dropout 0 through the kernels and through the
   plain versions, from the same params on the same batches, must agree in
   losses and first-step gradients, while planted K5 faults must not; and
   the flagship batch of 512 is timed. Last, where a training step's time
   goes at B=64 and B=512: host-clock step time, and the device time per
   kernel from ``torch.profiler`` over a few steps.
5. One JSON line describing each kernel, then, as the last line,
   ``{"ok": true, "device": {...}}``.

Exits non-zero, without the last line, when CUDA is absent or any check
fails. Imports nothing of JAX.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
PKG = "instacart_next_order_recommendation_tpu_torch"
JAX_PKG = "instacart_next_order_recommendation_tpu"

# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, f32 FMA, HBM3.
PEAK_BF16 = 989e12
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12

N_PRODUCTS = 50_000
BATCH = 256
K_BATCH = 16
N_SINGLE = 50

TRAIN_PRODUCTS = 2_000
TRAIN_USERS = 1_200
TRAIN_EPOCHS = 2
# configs/data_prep.yaml: contexts of the last 5 prior orders, at most 20
# product names; the last 15% of target orders held out.
MAX_PRIOR_ORDERS = 5
MAX_PRODUCT_NAMES = 20
EVAL_FRAC = 0.15

# Product-name geometry of the JAX package's synthetic Instacart generator
# with long_names=True: real Instacart names run 6-10 words, which is what
# fills max_seq_length 256 in the p5_mp20 contexts.
ADJECTIVES = [
    "Organic", "Fresh", "Whole", "Natural", "Classic", "Golden", "Premium",
    "Sweet", "Crunchy", "Creamy", "Roasted", "Smoked", "Wild", "Baked", "Frozen",
    "Spicy", "Zesty", "Light", "Dark", "Honey",
]
NOUNS = [
    "Milk", "Bread", "Banana", "Yogurt", "Cheese", "Chicken", "Broccoli",
    "Rice", "Coffee", "Granola", "Pasta", "Sauce", "Parmesan", "Apple",
    "Spinach", "Salmon", "Beans", "Cereal", "Juice", "Butter", "Eggs",
    "Tortilla", "Hummus", "Avocado", "Berries", "Oats", "Tea", "Chocolate",
    "Crackers", "Soup",
]
AISLES = [
    "fresh fruits", "fresh vegetables", "packaged cheese", "milk", "yogurt",
    "bread", "cereal", "coffee", "pasta sauce", "frozen meals", "soy lactosefree",
    "baking ingredients", "canned meals beans", "eggs", "juice nectars",
]
DEPARTMENTS = [
    "produce", "dairy eggs", "bakery", "beverages", "pantry", "frozen",
    "canned goods", "breakfast", "snacks", "meat seafood",
]
NAME_MODIFIERS = [
    "Gluten-Free", "Low-Fat", "Unsweetened", "Family Size", "Extra Crunchy",
    "Non-GMO", "Grass-Fed", "Cage-Free", "Stone-Ground", "Small Batch",
    "Reduced Sodium", "No Sugar Added", "Single Origin", "Double Churned",
]
NAME_EXTRAS = [
    "with Honey & Flax", "with Sea Salt", "in Olive Oil", "with Real Fruit",
    "with Ancient Grains", "with Whole Berries", "in Tomato Basil Sauce",
    "with Roasted Garlic", "with Dark Chocolate Chips", "with Almond Butter",
]
NAME_UNITS = [
    "12 oz", "1 Gallon", "6 Pack", "500 g", "2 lb Bag", "16.9 fl oz",
    "Variety Pack of 8", "32 oz Tub", "10 ct Box", "750 ml",
]

K1_TOL = 0.0625  # two bf16 ulps at |y| < 8: another summation order flips roundings
K2_TOL = 1e-5    # f32 sums in another order, unit-norm output
K3_TOL = 0.0     # grid-valued inputs: every dot product is exact in f32
# K5, relative to each gradient's largest magnitude: bf16 operands round at
# other points than in the plain version's autograd (dU, P, dL, dhpre, df and
# dao enter the kernel's products as bf16) and the f32 sums over B*S rows
# run in another order.
K5_REL_TOL = 2e-2
# Three training steps, kernels against plain versions at dropout 0 and a
# constant lr (five times the B=64 recipe's peak, so that each update moves
# the next loss further than bf16 does): the losses, relative, and the first
# step's gradients, relative to each parameter's largest magnitude. The
# forward's bf16 activations differ by an ulp or two, K5 rounds its
# operands at other points than autograd, and Adam moves a weight by about
# lr whatever its gradient's size, so a near-zero gradient whose sign
# differs moves its weight the other way. Each limit lies between the
# sound reading and the reading of a fault planted in K5 (PERF.md records both).
STEP_CHECK_LR = 1e-3
STEP_LOSS_REL_TOL = 2e-2
STEP_GRAD_REL_TOL = 6e-2


def log(msg: str) -> None:
    print(msg, flush=True)


def build_catalog_texts(n: int, rng: np.random.Generator) -> list[str]:
    """Product texts in the corpus template ("Product: X. Aisle: Y. Department: Z.")."""
    adjectives = [
        "Organic", "Fresh", "Whole", "Natural", "Classic", "Golden", "Premium",
        "Sweet", "Crunchy", "Creamy", "Roasted", "Smoked", "Wild", "Baked",
    ]
    nouns = [
        "Milk", "Bread", "Banana", "Yogurt", "Cheese", "Chicken", "Broccoli",
        "Rice", "Coffee", "Granola", "Pasta", "Sauce", "Parmesan", "Apple",
    ]
    aisles = ["fresh fruits", "milk", "bread", "cereal", "coffee", "pasta sauce"]
    depts = ["produce", "dairy eggs", "bakery", "beverages", "pantry"]
    out = []
    for i in range(n):
        name = f"{rng.choice(adjectives)} {rng.choice(nouns)} {i}"
        out.append(
            f"Product: {name}. Aisle: {rng.choice(aisles)}. Department: {rng.choice(depts)}."
        )
    return out


def build_query_texts(n: int, catalog: list[str], rng: np.random.Generator) -> list[str]:
    """User-context-shaped queries: [+Nd wDhH] name, name; ... (serve-time form)."""
    names = [t.split("Product: ")[1].split(".")[0] for t in catalog]
    out = []
    for _ in range(n):
        segments = []
        for _ in range(int(rng.integers(1, 6))):
            k = int(rng.integers(2, 7))
            prods = rng.choice(len(names), size=k, replace=False)
            prefix = (
                f"+{int(rng.integers(1, 30))}d w{int(rng.integers(0, 7))}"
                f"h{int(rng.integers(0, 24))}"
            )
            segments.append(f"[{prefix}] " + ", ".join(names[j] for j in prods))
        out.append("; ".join(segments) + ".")
    return out


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean milliseconds per call on the card (CUDA events after warm-up)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(n_bytes: float, ops: float, peak_ops: float) -> tuple[float, str]:
    t_bytes = n_bytes / PEAK_BYTES * 1e3
    t_ops = ops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def layer_weight_bytes(h: int, inter: int) -> int:
    """The twelve kernel-layout weights: bf16 matrices and biases, f32 LayerNorm."""
    return (4 * h * h + 2 * h * inter) * 2 + (6 * h + inter) * 2 + 4 * h * 4


def k1_bound(b: int, s: int, h: int, inter: int, masked: bool = False) -> tuple[float, str]:
    """x read and y written once (and the two [B, S, H] bf16 dropout masks
    read), the key bias and the weights read once; the four GEMMs and
    attention."""
    n_bytes = b * s * h * 2 * (4 if masked else 2) + b * s * 4 + layer_weight_bytes(h, inter)
    ops = 2 * b * s * (4 * h * h + 2 * h * inter) + 4 * b * s * s * h
    return bound_ms(n_bytes, ops, PEAK_BF16)


def k2_bound(b: int, s: int, h: int) -> tuple[float, str]:
    return bound_ms(b * s * h * 2 + b * s * 4 + b * h * 4, 2 * b * s * h, PEAK_F32)


def k3_bound(b: int, n: int, d: int, k: int, masked: bool) -> tuple[float, str]:
    n_bytes = n * d * 4 + b * d * 4 + b * k * 8 + (n * 4 if masked else 0)
    return bound_ms(n_bytes, 2 * b * n * d, PEAK_F32)


def k5_bound(b: int, s: int, h: int, inter: int, masked: bool) -> tuple[float, str]:
    """Inputs x, g (and masks) and the weights read once, dx and the twelve
    grads written once; forward recompute + dgrad + wgrad GEMMs and the
    attention backward."""
    n_bytes = (
        b * s * h * 2 * (3 + (2 if masked else 0)) + b * s * 4 + 2 * layer_weight_bytes(h, inter)
    )
    ops = 3 * 2 * b * s * (4 * h * h + 2 * h * inter) + 12 * b * s * s * h
    return bound_ms(n_bytes, ops, PEAK_BF16)


def library_train_ms(library, x, pad, up, iters: int) -> tuple[float, float]:
    """One nn.TransformerEncoderLayer forward, and its autograd backward,
    at x's shape (the yardstick for K1-train and K5)."""
    xr = x.detach().requires_grad_(True)
    fwd = cuda_ms(lambda: library(xr, src_key_padding_mask=pad), iters)
    y = library(xr, src_key_padding_mask=pad)
    inputs = [xr, *library.parameters()]
    bwd = cuda_ms(lambda: torch.autograd.grad(y, inputs, up, retain_graph=True), iters)
    return fwd, bwd


def rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return ((a.float() - b.float()).abs().max() / b.float().abs().max().clamp_min(1e-30)).item()


def measure_train_kernels(x, mask, layer, masks, up, library, kw, iters, plain_iters):
    """K1's mask form and K5 at x's shape against their plain versions (the
    plain backward is autograd of the plain forward), timed with CUDA
    events beside one nn.TransformerEncoderLayer forward and backward.
    Returns the two kernels-line rows (without launches), the gradient with
    the largest relative error, and whether every output is finite."""
    from instacart_next_order_recommendation_tpu_torch.ops import (
        fused_encoder_layer_backward,
        fused_encoder_layer_train,
    )
    from instacart_next_order_recommendation_tpu_torch.ops.fused_layer import (
        WEIGHT_NAMES,
        fused_encoder_layer_backward_reference,
        fused_encoder_layer_train_reference,
    )

    b, s, h = x.shape
    inter = layer["w1"].shape[1]
    bias = ((1.0 - mask.float()) * -1e9).contiguous()

    def k1():
        return fused_encoder_layer_train(x, mask, layer, masks=masks, dropout_rate=0.1, **kw)

    def plain1():
        return fused_encoder_layer_train_reference(x, mask, layer, masks=masks, **kw)

    def k5():
        return fused_encoder_layer_backward(x, bias, up, masks, layer, **kw)

    def plain5():
        return fused_encoder_layer_backward_reference(x, bias, up, masks, layer, **kw)

    y = k1()
    e1 = (y.float() - plain1().float()).abs().max().item()
    (dx, dw), (dx_r, dw_r) = k5(), plain5()
    pairs = {"dx": (dx, dx_r), **{n: (dw[n], dw_r[n]) for n in WEIGHT_NAMES}}
    rel = {n: rel_err(a, r) for n, (a, r) in pairs.items()}
    worst = max(rel, key=rel.get)
    finite = all(bool(torch.isfinite(t.float()).all()) for t in (y, dx, *dw.values()))
    lib_fwd, lib_bwd = library_train_ms(library, x, mask == 0, up, iters)
    bound1, by1 = k1_bound(b, s, h, inter, masks is not None)
    bound5, by5 = k5_bound(b, s, h, inter, masks is not None)
    k1_row = dict(
        ms=cuda_ms(k1, iters), plain_ms=cuda_ms(plain1, plain_iters, 1), library_ms=lib_fwd,
        max_abs_err=e1, bound_ms=bound1, bound_by=by1,
    )
    k5_row = dict(
        ms=cuda_ms(k5, iters), plain_ms=cuda_ms(plain5, plain_iters, 1), library_ms=lib_bwd,
        max_abs_err=max((a.float() - r.float()).abs().max().item() for a, r in pairs.values()),
        max_rel_err=rel[worst], bound_ms=bound5, bound_by=by5,
    )
    return k1_row, k5_row, worst, finite


def time_prefix(days: int | None, dow: int, hour: int) -> str:
    """An order's time tag in the data prep's context form."""
    return f"w{dow}h{hour}" if days is None else f"+{days}d w{dow}h{hour}"


def build_training_data(rng: np.random.Generator):
    """(anchors, positives, eval_pairs, eval_queries, eval_corpus, relevant)
    in the form the data prep writes for ``configs/data_prep.yaml``
    (p5_mp20): an anchor is the user's context before the target order
    (the last MAX_PRIOR_ORDERS prior orders, oldest first, at most
    MAX_PRODUCT_NAMES names, then ``Next: <time>``), a positive one product
    of that order. Products have real-length names; each user prefers three
    aisles and reorders about 60% of each basket. The numerically last
    EVAL_FRAC of target orders are held out; their queries drop the
    ``Next:`` clause, as at serve time."""
    n_aisles = len(AISLES)
    per_aisle = len(NOUNS) // n_aisles
    aisle = rng.integers(0, n_aisles, size=TRAIN_PRODUCTS)
    aisle_dept = rng.integers(0, len(DEPARTMENTS), size=n_aisles)
    names: list[str] = []
    for i, a in enumerate(aisle):
        noun = NOUNS[a * per_aisle + int(rng.integers(0, per_aisle))]
        name = (
            f"{rng.choice(NAME_MODIFIERS)} {rng.choice(ADJECTIVES)} {noun} "
            f"{rng.choice(NAME_EXTRAS)}, {rng.choice(NAME_UNITS)}"
        )
        names.append(f"{name} No {i}" if name in names else name)
    catalog = [
        f"Product: {n}. Aisle: {AISLES[a]}. Department: {DEPARTMENTS[aisle_dept[a]]}."
        for n, a in zip(names, aisle)
    ]
    by_aisle = [np.flatnonzero(aisle == a) for a in range(n_aisles)]

    targets = []  # (order id, context, basket) of each user's last order
    order_id = 0
    for _ in range(TRAIN_USERS):
        pref = np.concatenate([by_aisle[a] for a in rng.choice(n_aisles, 3, replace=False)])
        bought: list[int] = []
        orders = []
        for o in range(int(rng.integers(4, 9))):
            order_id += 1
            days = None if o == 0 else int(rng.integers(1, 30))
            prefix = time_prefix(days, int(rng.integers(0, 7)), int(rng.integers(0, 24)))
            n_items = int(rng.integers(3, 10))
            n_re = min(int(round(n_items * 0.6)), len(bought))
            basket = [int(p) for p in rng.choice(bought, size=n_re, replace=False)] if n_re else []
            n_new = n_items - n_re
            n_pref = min(max(1, int(round(n_new * 0.8))), len(pref)) if n_new else 0
            basket += [int(p) for p in rng.choice(pref, size=n_pref, replace=False)]
            basket += [int(p) for p in rng.choice(TRAIN_PRODUCTS, size=n_new - n_pref, replace=False)]
            basket = list(dict.fromkeys(basket))
            orders.append((prefix, basket))
            bought = list(dict.fromkeys(bought + basket))
        segments, total = [], 0
        for prefix, basket in orders[-1 - MAX_PRIOR_ORDERS : -1]:
            take = basket[: MAX_PRODUCT_NAMES - total]
            if not take:
                break
            total += len(take)
            segments.append(f"[{prefix}] " + ", ".join(names[p] for p in take))
        context = "; ".join(segments) + ". Next: " + orders[-1][0]
        targets.append((order_id, context, orders[-1][1]))

    n_eval = max(1, int(len(targets) * EVAL_FRAC))
    train, held = targets[:-n_eval], targets[-n_eval:]
    anchors = [c for _, c, basket in train for _ in basket]
    positives = [catalog[p] for _, _, basket in train for p in basket]
    eval_pairs = (
        [c for _, c, basket in held for _ in basket],
        [catalog[p] for _, _, basket in held for p in basket],
    )
    queries = {str(oid): c.split(" Next:")[0].strip() for oid, c, _ in held}
    relevant = {str(oid): {str(p + 1) for p in basket} for oid, _, basket in held}
    corpus = {str(i + 1): t for i, t in enumerate(catalog)}
    return anchors, positives, eval_pairs, queries, corpus, relevant


def random_layer(h: int, inter: int, g: torch.Generator, dev) -> dict:
    from instacart_next_order_recommendation_tpu_torch.ops.fused_layer import prepare_layer

    shapes = {
        "q_w": (h, h), "k_w": (h, h), "v_w": (h, h), "o_w": (h, h),
        "q_b": (h,), "k_b": (h,), "v_b": (h,), "o_b": (h,),
        "attn_ln_bias": (h,), "ffn_ln_bias": (h,),
        "ffn_w1": (h, inter), "ffn_b1": (inter,), "ffn_w2": (inter, h), "ffn_b2": (h,),
    }
    raw = {n: 0.02 * torch.randn(s, generator=g) for n, s in shapes.items()}
    raw["attn_ln_scale"] = 1 + 0.1 * torch.randn(h, generator=g)
    raw["ffn_ln_scale"] = 1 + 0.1 * torch.randn(h, generator=g)
    return prepare_layer({n: t.to(dev) for n, t in raw.items()}, torch.bfloat16)


def random_mask(b: int, s: int, g: torch.Generator, dev) -> torch.Tensor:
    lengths = torch.randint(1, s + 1, (b,), generator=g)
    if b > 1:
        lengths[-1] = 0  # one all-pad row, as the padded batch buckets carry
    return (torch.arange(s)[None, :] < lengths[:, None]).to(torch.int32).to(dev)


class Smoke:
    def __init__(self):
        self.failures: list[str] = []
        self.kernel_rows: dict[str, dict] = {}

    def check(self, ok: bool, what: str) -> None:
        if not ok:
            self.failures.append(what)
            log(f"FAIL: {what}")

    # ------------------------------------------------------------ phase 2

    def compare_kernels(self, dev) -> None:
        from instacart_next_order_recommendation_tpu_torch.ops import (
            cosine_topk,
            fused_encoder_layer,
            masked_mean_pool_l2norm,
        )
        from instacart_next_order_recommendation_tpu_torch.ops.fused_layer import (
            fused_encoder_layer_reference,
        )
        from instacart_next_order_recommendation_tpu_torch.ops.pool_norm import (
            masked_mean_pool_l2norm_reference,
        )
        from instacart_next_order_recommendation_tpu_torch.ops.topk import (
            cosine_topk_reference,
        )

        h, inter, heads = 384, 1536, 12
        kw = dict(num_heads=heads, scale=1.0 / 32**0.5, eps=1e-12)
        g = torch.Generator().manual_seed(1)
        layer = random_layer(h, inter, g, dev)
        library = torch.nn.TransformerEncoderLayer(
            d_model=h, nhead=heads, dim_feedforward=inter, dropout=0.0, activation="gelu",
            batch_first=True, norm_first=False,
        ).to(dev, torch.bfloat16).eval()
        for b in (1, 256, 512):
            for s in (32, 64, 128, 256):
                x = torch.randn((b, s, h), generator=g).to(dev, torch.bfloat16)
                mask = random_mask(b, s, g, dev)
                y = fused_encoder_layer(x, mask, layer, **kw)
                y_ref = fused_encoder_layer_reference(x, mask, layer, **kw)
                err = (y.float() - y_ref.float()).abs()
                finite = bool(torch.isfinite(y.float()).all())
                iters = 20 if b * s <= 16384 else 5
                ms = cuda_ms(lambda: fused_encoder_layer(x, mask, layer, **kw), iters)
                plain = cuda_ms(lambda: fused_encoder_layer_reference(x, mask, layer, **kw), 2, 1)
                pad = mask == 0
                lib = cuda_ms(lambda: library(x, src_key_padding_mask=pad), iters)
                log(
                    f"K1 fused_encoder_layer B={b} S={s}: max_abs_err={err.max().item():.6g} "
                    f"(tol {K1_TOL}) mean_abs_err={err.mean().item():.3g} finite={finite} "
                    f"ms={ms:.4f} plain_ms={plain:.4f} library_ms={lib:.4f} "
                    f"launches={fused_encoder_layer.launches}"
                )
                self.check(finite and err.max().item() <= K1_TOL, f"K1 B={b} S={s}")

                p = masked_mean_pool_l2norm(y, mask)
                p_ref = masked_mean_pool_l2norm_reference(y, mask)
                err2 = (p - p_ref).abs().max().item()
                ms2 = cuda_ms(lambda: masked_mean_pool_l2norm(y, mask), 20)
                plain2 = cuda_ms(lambda: masked_mean_pool_l2norm_reference(y, mask), 5)
                log(
                    f"K2 masked_mean_pool_l2norm B={b} S={s}: max_abs_err={err2:.3g} "
                    f"(tol {K2_TOL}) ms={ms2:.4f} plain_ms={plain2:.4f} "
                    f"launches={masked_mean_pool_l2norm.launches}"
                )
                self.check(err2 <= K2_TOL and bool(torch.isfinite(p).all()), f"K2 B={b} S={s}")
                del x, y, y_ref, err, p, p_ref
        del library

        # K3: grid-valued catalog and queries, so every score is exact in
        # f32 under any summation order; ids must then be identical.
        n, d = N_PRODUCTS, h
        c = (torch.randint(-8, 9, (n, d), generator=g).float() / 16).to(dev)
        c[25_000:25_010] = c[123]  # deliberate ties, across blocks
        c[124] = c[123]            # and within one
        for b in (1, BATCH):
            q = (torch.randint(-8, 9, (b, d), generator=g).float() / 16).to(dev)
            q[0] = c[123]  # row 0's best score is a ten-way tie
            for k in (16, 256):
                for masked in (False, True):
                    mask = (torch.rand(n, generator=g) < 0.5).int().to(dev) if masked else None
                    if masked:
                        mask[[123, 124, 25_000, 25_005]] = 1
                    s_k, i_k = cosine_topk(q, c, k, n_valid=n, candidate_mask=mask)
                    s_r, i_r = cosine_topk_reference(q, c, k, n_valid=n, candidate_mask=mask)
                    same_ids = bool(torch.equal(i_k, i_r))
                    err3 = (s_k - s_r).abs().max().item()
                    ms3 = cuda_ms(lambda: cosine_topk(q, c, k, n_valid=n, candidate_mask=mask), 10)
                    plain3 = cuda_ms(
                        lambda: cosine_topk_reference(q, c, k, n_valid=n, candidate_mask=mask), 3
                    )
                    tie_ok = masked or i_k[0, :12].tolist() == [123, 124] + list(
                        range(25_000, 25_010)
                    )
                    log(
                        f"K3 cosine_topk B={b} N={n} k={k} mask={masked}: ids_identical={same_ids} "
                        f"tie_order_ok={tie_ok} max_abs_err={err3:.3g} (tol {K3_TOL}) "
                        f"ms={ms3:.4f} plain_ms={plain3:.4f} launches={cosine_topk.launches}"
                    )
                    self.check(
                        same_ids and tie_ok and err3 <= K3_TOL, f"K3 B={b} k={k} mask={masked}"
                    )
        del c
        torch.cuda.empty_cache()

    # ----------------------------------------------------------- phase 2b

    def compare_train_kernels(self, dev) -> None:
        """K1 with dropout masks and K5 against their plain versions at the
        training shapes. The yardstick is one nn.TransformerEncoderLayer
        (dropout 0.1, train mode) forward and backward at the same shape;
        the port never calls it."""
        from instacart_next_order_recommendation_tpu_torch.ops import (
            fused_encoder_layer_backward,
            fused_encoder_layer_train,
        )
        from instacart_next_order_recommendation_tpu_torch.ops.fused_layer import (
            draw_dropout_masks,
        )

        h, inter, heads = 384, 1536, 12
        kw = dict(num_heads=heads, scale=1.0 / 32**0.5, eps=1e-12)
        g = torch.Generator().manual_seed(2)
        layer = random_layer(h, inter, g, dev)
        library = torch.nn.TransformerEncoderLayer(
            d_model=h, nhead=heads, dim_feedforward=inter, dropout=0.1, activation="gelu",
            batch_first=True, norm_first=False,
        ).to(dev, torch.bfloat16).train()
        gen = torch.Generator(device=dev)
        for b in (1, 64, 512):
            for s in (32, 64, 128, 256):
                x = torch.randn((b, s, h), generator=g).to(dev, torch.bfloat16)
                up = torch.randn((b, s, h), generator=g).to(dev, torch.bfloat16)
                mask = random_mask(b, s, g, dev)
                gen.manual_seed(1000 * b + s)
                masks = draw_dropout_masks((b, s, h), 0.1, gen, dev, torch.bfloat16)
                iters = 10 if b * s <= 16384 else 3
                k1, k5, worst, finite = measure_train_kernels(
                    x, mask, layer, masks, up, library, kw, iters, 1
                )
                log(
                    f"K1-train B={b} S={s}: max_abs_err={k1['max_abs_err']:.4g} (tol {K1_TOL}) "
                    f"ms={k1['ms']:.4f} plain_ms={k1['plain_ms']:.4f} "
                    f"library_fwd_ms={k1['library_ms']:.4f} bound_ms={k1['bound_ms']:.4g} "
                    f"({k1['bound_by']}); K5 B={b} S={s}: worst rel_err {worst}="
                    f"{k5['max_rel_err']:.3g} (tol {K5_REL_TOL}) finite={finite} "
                    f"ms={k5['ms']:.4f} plain_ms={k5['plain_ms']:.4f} "
                    f"library_bwd_ms={k5['library_ms']:.4f} bound_ms={k5['bound_ms']:.4g} "
                    f"({k5['bound_by']}); launches K1-train={fused_encoder_layer_train.launches} "
                    f"K5={fused_encoder_layer_backward.launches}"
                )
                self.check(finite and k1["max_abs_err"] <= K1_TOL, f"K1-train B={b} S={s}")
                self.check(finite and k5["max_rel_err"] <= K5_REL_TOL, f"K5 B={b} S={s}")
                del x, up, mask, masks
                torch.cuda.empty_cache()
        del library
        torch.cuda.empty_cache()

    # ------------------------------------------------------------ phase 3

    def serve(self, dev, workdir: Path) -> dict:
        from instacart_next_order_recommendation_tpu_torch.models.checkpoint import save_tower
        from instacart_next_order_recommendation_tpu_torch.models.encoder import (
            MINILM_L6,
            embed,
            init_params,
            prepare_layers,
        )
        from instacart_next_order_recommendation_tpu_torch.ops import (
            cosine_topk,
            fused_encoder_layer,
            masked_mean_pool_l2norm,
        )
        from instacart_next_order_recommendation_tpu_torch.ops.fused_layer import (
            fused_encoder_layer_reference,
        )
        from instacart_next_order_recommendation_tpu_torch.ops.pool_norm import (
            masked_mean_pool_l2norm_reference,
        )
        from instacart_next_order_recommendation_tpu_torch.ops.topk import (
            cosine_topk_reference,
        )
        from instacart_next_order_recommendation_tpu_torch.serve.recommender import Recommender
        from instacart_next_order_recommendation_tpu_torch.tokenizer import WordPieceTokenizer

        wrappers = (fused_encoder_layer, masked_mean_pool_l2norm, cosine_topk)
        cosine_topk.dense_calls = 0
        rng = np.random.default_rng(0)
        t0 = time.perf_counter()
        catalog = build_catalog_texts(N_PRODUCTS, rng)
        queries = build_query_texts(BATCH + N_SINGLE, catalog, rng)
        tok = WordPieceTokenizer.train(catalog, vocab_size=30_000)
        config = dataclasses.replace(MINILM_L6, vocab_size=tok.vocab_size)
        params = init_params(config, torch.Generator().manual_seed(0))
        model_dir = workdir / "model"
        save_tower(model_dir, params, config, tok)
        corpus_path = workdir / "eval_corpus.json"
        corpus_path.write_text(json.dumps({str(i + 1): t for i, t in enumerate(catalog)}))
        log(
            f"setup: {N_PRODUCTS} products, vocab {tok.vocab_size}, MiniLM-L6 "
            f"{config.num_layers}x{config.hidden_size} h{config.num_heads} "
            f"i{config.intermediate_size}, {time.perf_counter() - t0:.1f}s"
        )

        # ---- the main path, counted from zero
        for w in wrappers:
            w.launches = 0
        t0 = time.perf_counter()
        rec = Recommender(model_dir, corpus_path, use_index=False)
        torch.cuda.synchronize()
        construct_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        emb = rec.encoder.encode_resident(rec.product_texts, batch_size=512)
        torch.cuda.synchronize()
        encode_s = time.perf_counter() - t0

        r1 = rec.recommend(queries[0], top_k=10)
        excluded = {r1[0][0], r1[1][0]}
        r2 = rec.recommend(queries[1], top_k=10, exclude_product_ids=excluded)
        r3 = rec.recommend(queries[2], top_k=10, filter_aisles=["milk"])
        big_excluded = {pid for pid, _ in r1}
        r4 = rec.recommend(queries[3], top_k=250, exclude_product_ids=big_excluded)
        latencies = []
        for q in queries[BATCH:]:
            t0 = time.perf_counter()
            rec.recommend(q, top_k=10)
            latencies.append((time.perf_counter() - t0) * 1e3)

        t0 = time.perf_counter()
        ids, tmask = rec.encoder.tokenizer.encode_batch(queries[:BATCH], max_seq_length=256)
        tokenize_ms = (time.perf_counter() - t0) * 1e3
        rec._fused.topk(ids, tmask, K_BATCH)  # warm-up
        batch_ms = []
        for _ in range(5):
            t0 = time.perf_counter()
            b_scores, b_idx = rec._fused.topk(ids, tmask, K_BATCH)
            batch_ms.append((time.perf_counter() - t0) * 1e3)
        counts = {w.__name__: w.launches for w in wrappers}
        dense_calls = cosine_topk.dense_calls
        # ---- end of the main path

        n_forwards = counts["masked_mean_pool_l2norm"]
        log(
            f"main-path launches: {counts} ({n_forwards} tower forwards); dense top-k "
            f"route calls: {dense_calls}"
        )
        self.check(dense_calls == 1, "top_k + |excluded| > 256 took the dense route once")
        # The same request through the plain version: the query's embedding
        # from the kernels, the dense scores and stable sort of
        # cosine_topk_reference, then the same exclusion.
        q4 = rec.encoder.encode_device([queries[3]])
        _, i4 = cosine_topk_reference(q4, rec.index.catalog, 250 + len(big_excluded))
        plain_r4 = [p for p in (rec.product_ids[int(j)] for j in i4[0]) if p not in big_excluded]
        self.check(
            [p for p, _ in r4] == plain_r4[:250], "top-250 with 10 excluded matches the plain version"
        )
        log(f"recommend top_k=250 excluding {len(big_excluded)}: {len(r4)} ids, identical to plain")
        self.check(all(v > 0 for v in counts.values()), "every kernel launched on the main path")
        self.check(
            counts["fused_encoder_layer"] == config.num_layers * n_forwards,
            "six fused-layer launches per forward",
        )
        self.check(len(r1) == 10 and len(r2) == 10 and len(r3) == 10, "recommend sizes")
        self.check(not excluded & {p for p, _ in r2}, "excluded ids stay out")
        self.check(
            all("Aisle: milk." in rec.pid_to_text[p] for p, _ in r3), "aisle filter holds"
        )
        for r in (r1, r2, r3):
            sc = [s for _, s in r]
            self.check(all(np.isfinite(sc)) and sc == sorted(sc, reverse=True), "scores ordered")
        self.check(bool(torch.isfinite(rec.index.catalog).all()), "catalog finite")
        self.check(bool(torch.allclose(emb, rec.index.catalog)), "catalog encode repeatable")
        self.check(bool(np.isfinite(b_scores).all()), "batch scores finite")

        # ---- the same batch through the plain versions on the card
        with torch.inference_mode():
            pad_id = rec.encoder.tokenizer.pad_id
            kw = dict(
                num_heads=config.num_heads, scale=1.0 / config.head_dim**0.5,
                eps=config.layer_norm_eps,
            )

            config_f32 = dataclasses.replace(config, compute_dtype="float32")
            layers_f32 = prepare_layers(rec.encoder.params, config_f32)

            def plain_encode(ids_np, cfg=config, layers=rec.encoder.layers):
                ids_t = torch.from_numpy(ids_np).to(dev)
                m = (ids_t != pad_id).to(torch.int32)
                x = embed(rec.encoder.params, ids_t, cfg)
                for layer in layers:
                    x = fused_encoder_layer_reference(x, m, layer, **kw)
                return masked_mean_pool_l2norm_reference(x, m)

            t0 = time.perf_counter()
            cat_ids = [
                rec.encoder.tokenizer.encode_batch(
                    rec.product_texts[lo : lo + 512], max_seq_length=256
                )[0]
                for lo in range(0, N_PRODUCTS, 512)
            ]
            catalog_tokenize_s = time.perf_counter() - t0
            catalog_plain = torch.cat([plain_encode(c) for c in cat_ids])
            q_plain = plain_encode(ids)
            s_plain, i_plain = cosine_topk_reference(q_plain, catalog_plain, K_BATCH)
            i_kern = torch.from_numpy(b_idx).to(dev)
            agree = float((i_kern == i_plain).float().mean())
            cat_err = (catalog_plain - rec.index.catalog).abs().max().item()
            q_kern = rec.encoder.encode_device(queries[:BATCH])
            q_err = (q_plain - q_kern).abs().max().item()
            # A swap of ids a (kernel) and b (plain) at one rank is a near-tie
            # when their plain scores differ by less than the embedding
            # differences can move both scores: for unit vectors,
            # |q.c - q'.c'| <= ||q - q'|| + ||c - c'||.
            q_delta = (q_plain - q_kern).norm(dim=1)[:, None]
            c_delta = (catalog_plain - rec.index.catalog).norm(dim=1)
            tol = 2 * q_delta + c_delta[i_kern.long()] + c_delta[i_plain.long()]
            plain_of_kern = (q_plain @ catalog_plain.T).gather(1, i_kern.long())
            near_tie = plain_of_kern >= s_plain - tol
            explained = float(((i_kern == i_plain) | near_tie).float().mean())
            spread = (s_plain[:, 0] - s_plain[:, -1]).median().item()
            log(
                f"plain versions on the card: catalog max_abs_err={cat_err:.4g}, batch "
                f"query max_abs_err={q_err:.4g}, median top-1 - top-{K_BATCH} plain score "
                f"spread={spread:.4g}, median swap tolerance={tol.median().item():.4g}; batch "
                f"top-{K_BATCH} ids identical={agree:.4f}, identical or a near-tie="
                f"{explained:.4f} (need >= 0.95), {time.perf_counter() - t0:.1f}s"
            )
            self.check(cat_err <= 5e-3 and q_err <= 5e-3, "embeddings match the plain versions")
            self.check(explained >= 0.95, "batch top-16 agreement with the plain versions")

            # How much of the disagreement is bf16 itself: both bf16 paths
            # against the plain version in f32.
            catalog_f32 = torch.cat([plain_encode(c, config_f32, layers_f32) for c in cat_ids])
            _, i_f32 = cosine_topk_reference(
                plain_encode(ids, config_f32, layers_f32), catalog_f32, K_BATCH
            )
            kern_vs_f32 = float((i_kern == i_f32).float().mean())
            plain_vs_f32 = float((i_plain == i_f32).float().mean())
            log(
                f"top-{K_BATCH} ids identical to the f32 plain path: kernels (bf16) "
                f"{kern_vs_f32:.4f}, plain versions (bf16) {plain_vs_f32:.4f}"
            )

        lat = np.asarray(latencies)
        serve = {
            "products": N_PRODUCTS,
            "vocab": tok.vocab_size,
            "recommender_construct_s": construct_s,
            "catalog_encode_s": encode_s,
            "catalog_encode_products_per_s": N_PRODUCTS / encode_s,
            "batch": BATCH,
            "batch_seq": int(ids.shape[1]),
            "batch_k": K_BATCH,
            "batch_tokenize_ms": tokenize_ms,
            "batch_ms_median": float(np.median(batch_ms)),
            "batch_queries_per_s": BATCH / (float(np.median(batch_ms)) / 1e3),
            "single_query_p50_ms": float(np.percentile(lat, 50)),
            "single_query_p95_ms": float(np.percentile(lat, 95)),
            "single_queries": len(lat),
            "top16_ids_identical_to_plain": agree,
            "top16_identical_or_near_tie": explained,
            "top16_kernels_bf16_vs_plain_f32": kern_vs_f32,
            "top16_plain_bf16_vs_plain_f32": plain_vs_f32,
            "catalog_tokenize_s": catalog_tokenize_s,
            "launches": counts,
        }
        log("serve " + json.dumps(serve))

        # ---- each kernel at the batch's shapes, for the kernels line
        with torch.inference_mode():
            ids_t = torch.from_numpy(ids).to(dev)
            m = (ids_t != pad_id).to(torch.int32)
            x = embed(rec.encoder.params, ids_t, config)
            layer = rec.encoder.layers[0]
            b, s, h = x.shape
            inter = config.intermediate_size
            y = fused_encoder_layer(x, m, layer, **kw)
            e1 = (y.float() - fused_encoder_layer_reference(x, m, layer, **kw).float()).abs()
            library = torch.nn.TransformerEncoderLayer(
                d_model=h, nhead=config.num_heads, dim_feedforward=inter, dropout=0.0,
                activation="gelu", batch_first=True, norm_first=False,
            ).to(dev, torch.bfloat16).eval()
            pad = m == 0
            bnd, by = k1_bound(b, s, h, inter)
            self.kernel_rows["fused_encoder_layer"] = dict(
                ms=cuda_ms(lambda: fused_encoder_layer(x, m, layer, **kw), 20),
                plain_ms=cuda_ms(lambda: fused_encoder_layer_reference(x, m, layer, **kw), 3),
                library_ms=cuda_ms(lambda: library(x, src_key_padding_mask=pad), 20),
                max_abs_err=e1.max().item(), bound_ms=bnd, bound_by=by,
            )
            self.check(e1.max().item() <= K1_TOL, "K1 at the batch shape")
            p = masked_mean_pool_l2norm(y, m)
            e2 = (p - masked_mean_pool_l2norm_reference(y, m)).abs().max().item()
            bnd, by = k2_bound(b, s, h)
            self.kernel_rows["masked_mean_pool_l2norm"] = dict(
                ms=cuda_ms(lambda: masked_mean_pool_l2norm(y, m), 50),
                plain_ms=cuda_ms(lambda: masked_mean_pool_l2norm_reference(y, m), 20),
                library_ms=None, max_abs_err=e2, bound_ms=bnd, bound_by=by,
            )
            self.check(e2 <= K2_TOL, "K2 at the batch shape")
            cat = rec.index.catalog
            s_k, i_k = cosine_topk(p, cat, K_BATCH, n_valid=N_PRODUCTS)
            s_r, i_r = cosine_topk_reference(p, cat, K_BATCH, n_valid=N_PRODUCTS)
            e3 = (s_k - s_r).abs().max().item()
            # Same embeddings in: ids differ only where f32 scores tie to
            # within the summation-order error.
            k3_same = float((i_k == i_r).float().mean())
            log(f"K3 on the batch's embeddings: ids identical={k3_same:.4f}, max_abs_err={e3:.3g}")
            self.check(k3_same >= 0.99, "K3 ids on the batch's embeddings")
            bnd, by = k3_bound(b, N_PRODUCTS, h, K_BATCH, False)
            self.kernel_rows["cosine_topk"] = dict(
                ms=cuda_ms(lambda: cosine_topk(p, cat, K_BATCH, n_valid=N_PRODUCTS), 20),
                plain_ms=cuda_ms(
                    lambda: cosine_topk_reference(p, cat, K_BATCH, n_valid=N_PRODUCTS), 10
                ),
                library_ms=None, max_abs_err=e3, bound_ms=bnd, bound_by=by,
            )
            self.check(e3 <= 1e-5, "K3 scores at the batch shape")
            log(
                f"kernels line measured at the batch's shapes: B={b} S={s} H={h} I={inter}, "
                f"catalog N={N_PRODUCTS}, k={K_BATCH}"
            )
        for name, row in self.kernel_rows.items():
            row["launches"] = counts[name]
        return serve


class TrainPhase:
    """Phase 4: MNRL training through TwoTowerTrainer.train(data=...)."""

    def __init__(self, smoke: "Smoke", dev, workdir: Path):
        self.smoke = smoke
        self.dev = dev
        self.workdir = workdir
        self.data = build_training_data(np.random.default_rng(1))

    def config(self, out: str, **kw):
        from instacart_next_order_recommendation_tpu_torch.train import TrainConfig

        return TrainConfig({
            "processed_dir": str(self.workdir),
            "output_dir": str(self.workdir / out),
            "model_name": "minilm-l6",
            "max_seq_length": 256,
            "vocab_size": 30000,
            "epochs": TRAIN_EPOCHS,
            "train_batch_size": 64,
            "eval_batch_size": 64,
            "learning_rate": 2.0e-4,
            "loss_scale": 30.0,
            "steps_per_dispatch": 1,
            "logging_steps": 10,
            "seed": 42,
            **kw,
        })

    def steps_per_epoch(self, batch: int, epochs: int) -> list[int]:
        from instacart_next_order_recommendation_tpu_torch.data.batching import (
            no_duplicates_batches,
        )

        anchors, positives = self.data[:2]
        return [
            sum(1 for _ in no_duplicates_batches(anchors, positives, batch, 42, e))
            for e in range(1, epochs + 1)
        ]

    def run(self) -> dict:
        from instacart_next_order_recommendation_tpu_torch.eval.evaluator import (
            RetrievalEvaluator,
        )
        from instacart_next_order_recommendation_tpu_torch.models.text_encoder import TextEncoder
        from instacart_next_order_recommendation_tpu_torch.ops import (
            cosine_topk,
            fused_encoder_layer,
            fused_encoder_layer_backward,
            fused_encoder_layer_train,
            masked_mean_pool_l2norm,
        )
        from instacart_next_order_recommendation_tpu_torch.serve.recommender import Recommender
        from instacart_next_order_recommendation_tpu_torch.train import TwoTowerTrainer

        smoke = self.smoke
        anchors, positives, eval_pairs, queries, corpus, relevant = self.data
        corpus_path = self.workdir / "train_corpus.json"
        corpus_path.write_text(json.dumps(corpus))

        # The untrained tower: zero epochs export the initial params as final/.
        t0 = time.perf_counter()
        untrained = TwoTowerTrainer(
            self.config("untrained", epochs=0, run_information_retrieval_evaluator=False)
        ).train(data=self.data)
        evaluator = RetrievalEvaluator(queries, corpus, relevant, batch_size=64)
        with torch.inference_mode():
            ndcg_untrained = evaluator(TextEncoder.load(untrained["final_dir"]))["ndcg_at_10"]
        log(f"untrained tower: NDCG@10 {ndcg_untrained:.4f} ({time.perf_counter() - t0:.1f}s)")

        # ---- the main path, counted from zero
        wrappers = (
            fused_encoder_layer_train, fused_encoder_layer_backward, masked_mean_pool_l2norm,
            fused_encoder_layer, cosine_topk,
        )
        for w in wrappers:
            w.launches = 0
        trainer = TwoTowerTrainer(self.config("trained"))
        t0 = time.perf_counter()
        result = trainer.train(data=self.data)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        counts = {w.__name__: w.launches for w in wrappers}
        # ---- end of the main path

        losses = np.asarray(trainer.step_losses)
        n_epoch = self.steps_per_epoch(64, TRAIN_EPOCHS)
        steps = len(losses)
        log(f"train: {steps} steps (per epoch {n_epoch}), seq {trainer.seq_len}, {train_s:.1f}s")
        log("train per-step loss: " + " ".join(f"{v:.4f}" for v in losses))
        log(f"main-path launches: {counts}")
        hist = result["history"]
        per_epoch = []
        for entry, n in zip(hist, n_epoch):
            per_epoch.append({
                "epoch": entry["epoch"],
                "steps": n,
                "step_ms": entry["epoch_seconds"] / n * 1e3,
                "pairs_per_s": 64 * n / entry["epoch_seconds"],
                "train_loss": entry["train_loss"],
                "eval_loss": entry.get("eval_loss"),
                "ndcg_at_10": entry.get("ndcg_at_10"),
            })
            log(f"  epoch {json.dumps(per_epoch[-1])}")
        head, tail = losses[:10].mean(), losses[-10:].mean()
        smoke.check(trainer.seq_len == 256, "the p5_mp20 contexts bucket to S=256")
        smoke.check(steps == sum(n_epoch), "steps per epoch as the no-duplicates batches give")
        smoke.check(bool(np.isfinite(losses).all()), "training losses finite")
        smoke.check(tail < head, f"loss falls (first 10 mean {head:.4f}, last 10 mean {tail:.4f})")
        smoke.check(
            counts["fused_encoder_layer_train"] == 12 * steps
            and counts["fused_encoder_layer_backward"] == 12 * steps,
            "12 train-form K1 and 12 K5 launches per step",
        )
        smoke.check(all(v > 0 for v in counts.values()), "every kernel launched while training")

        best = max(hist, key=lambda h: h["ndcg_at_10"])
        log(
            f"NDCG@10: trained {best['ndcg_at_10']:.4f} (best epoch {result['best_epoch']}), "
            f"untrained {ndcg_untrained:.4f}"
        )
        qid = next(iter(queries))
        with torch.inference_mode():
            rec = Recommender(result["final_dir"], corpus_path, use_index=False)
            top = rec.recommend(queries[qid], top_k=10)
        hits = len(relevant[qid] & {p for p, _ in top})
        smoke.check(len(top) == 10, "final/ serves through Recommender")
        log(
            f"final/ served by Recommender: top-10 for held-out order {qid} holds {hits} of its "
            f"{len(relevant[qid])} products"
        )

        self.kernel_rows(trainer, result["final_dir"], counts)
        step_check = self.kernels_against_plain_steps(trainer.seq_len)
        flagship = self.flagship()
        breakdown = {b: self.step_breakdown(trainer.seq_len, b) for b in (64, 512)}
        return {
            "train_pairs": len(anchors),
            "batch": 64,
            "seq": trainer.seq_len,
            "steps": steps,
            "train_seconds": train_s,
            "epochs": per_epoch,
            "ndcg_at_10_trained": best["ndcg_at_10"],
            "ndcg_at_10_untrained": ndcg_untrained,
            "launches": counts,
            "three_steps_kernels_vs_plain": step_check,
            "flagship_b512": flagship,
            "step_breakdown": breakdown,
        }

    def batches(self, tokenizer, seq: int, batch: int, n: int) -> list[list[torch.Tensor]]:
        anchors, positives = self.data[:2]
        out = []
        for k in range(n):
            idx = range(k * batch, (k + 1) * batch)
            b = []
            for texts in (anchors, positives):
                ids, mask = tokenizer.encode_batch(
                    [texts[i] for i in idx], max_seq_length=256, pad_to=seq
                )
                b += [torch.from_numpy(ids).to(self.dev), torch.from_numpy(mask).to(self.dev)]
            out.append(b)
        return out

    def kernel_rows(self, trainer, final_dir, counts) -> None:
        """K1-train and K5 at the training batch's shape (first layer of the
        trained tower), for the kernels line."""
        from instacart_next_order_recommendation_tpu_torch.models.checkpoint import load_tower
        from instacart_next_order_recommendation_tpu_torch.models.encoder import embed
        from instacart_next_order_recommendation_tpu_torch.ops.fused_layer import (
            draw_dropout_masks,
            prepare_layer,
        )

        params, cfg, tok = load_tower(final_dir)
        params = {k: ({n: t.to(self.dev) for n, t in v.items()}) for k, v in params.items()}
        a_ids, a_mask = self.batches(tok, trainer.seq_len, 64, 1)[0][:2]
        layer = prepare_layer({n: t[0] for n, t in params["layers"].items()}, torch.bfloat16)
        with torch.no_grad():
            x = embed(params, a_ids, cfg).contiguous()
        kw = dict(num_heads=cfg.num_heads, scale=1.0 / cfg.head_dim**0.5, eps=cfg.layer_norm_eps)
        masks = draw_dropout_masks(
            x.shape, 0.1, torch.Generator(device=self.dev).manual_seed(3), self.dev, x.dtype
        )
        up = torch.randn(x.shape, generator=torch.Generator().manual_seed(4)).to(self.dev, x.dtype)
        library = torch.nn.TransformerEncoderLayer(
            d_model=x.shape[2], nhead=cfg.num_heads, dim_feedforward=cfg.intermediate_size,
            dropout=0.1, activation="gelu", batch_first=True, norm_first=False,
        ).to(self.dev, torch.bfloat16).train()
        k1, k5, worst, finite = measure_train_kernels(x, a_mask, layer, masks, up, library, kw, 20, 3)
        self.smoke.check(finite and k1["max_abs_err"] <= K1_TOL, "K1-train at the training batch shape")
        self.smoke.check(finite and k5["max_rel_err"] <= K5_REL_TOL, "K5 at the training batch shape")
        self.smoke.kernel_rows["fused_encoder_layer_train"] = {
            **k1, "launches": counts["fused_encoder_layer_train"]
        }
        self.smoke.kernel_rows["fused_encoder_layer_backward"] = {
            **k5, "launches": counts["fused_encoder_layer_backward"]
        }
        log(
            f"K1-train/K5 rows measured at the training batch's shape B={x.shape[0]} "
            f"S={x.shape[1]}: K5 worst rel_err {worst}={k5['max_rel_err']:.3g}"
        )

    def fresh_params(self):
        """The untrained tower (its params as new trainable f32 tensors on
        the card), its config and tokenizer."""
        from instacart_next_order_recommendation_tpu_torch.models.checkpoint import load_tower

        init, cfg, tok = load_tower(self.workdir / "untrained" / "final")
        params = {
            k: {n: t.to(self.dev).requires_grad_(True) for n, t in v.items()}
            for k, v in init.items()
        }
        return params, cfg, tok

    def kernels_against_plain_steps(self, seq: int) -> dict:
        """3 AdamW steps at dropout 0 and a constant lr, from the same params
        on the same batches: TrainStep (kernels) against the same steps
        through the plain versions. Compared: the three losses (the second
        and third follow the updates before them) and every parameter's
        gradient at the first step, relative to its largest magnitude.

        Both readings are taken again with a fault planted in K5's output:
        every weight gradient scaled by 0.9, and dx negated. Adam's update
        hardly depends on a gradient's scale, so the losses cannot see the
        first fault; the gradients must. The limits must lie between the
        sound readings and the faults'."""
        from unittest import mock

        from instacart_next_order_recommendation_tpu_torch.models.encoder import (
            embed,
            prepare_layers,
        )
        from instacart_next_order_recommendation_tpu_torch.ops import (
            fused_encoder_layer_backward,
            fused_layer,
            mnrl_loss,
        )
        from instacart_next_order_recommendation_tpu_torch.ops.pool_norm import (
            masked_mean_pool_l2norm_reference,
        )
        from instacart_next_order_recommendation_tpu_torch.train.trainer import (
            TrainStep,
            build_optimizer,
            param_leaves,
        )

        cfg, tok = self.fresh_params()[1:]
        cfg = dataclasses.replace(cfg, hidden_dropout=0.0)
        batches = self.batches(tok, seq, 64, 3)
        kw = dict(num_heads=cfg.num_heads, scale=1.0 / cfg.head_dim**0.5, eps=cfg.layer_norm_eps)

        def plain_encode(params, ids, mask):
            x = embed(params, ids, cfg)
            for layer in prepare_layers(params, cfg):
                x = fused_layer.fused_encoder_layer_train_reference(
                    x, mask, layer, masks=None, **kw
                )
            return masked_mean_pool_l2norm_reference(x, mask)

        def run(plain: bool) -> tuple[list[float], dict]:
            """The three losses and the first step's gradients by leaf."""
            params = self.fresh_params()[0]
            leaves = dict(param_leaves(params))
            opt = build_optimizer(params, 0.0)
            first: dict = {}

            def keep_first(*_):
                if not first:
                    first.update({n: t.grad.detach().clone() for n, t in leaves.items()})

            opt.register_step_pre_hook(keep_first)
            if not plain:
                step = TrainStep(
                    params, cfg, opt, lambda count: STEP_CHECK_LR,
                    loss_scale=30.0, accum=1, device=self.dev,
                )
                return [step(b, seed=0).item() for b in batches], first
            losses = []
            for a_ids, a_mask, p_ids, p_mask in batches:
                loss = mnrl_loss(
                    plain_encode(params, a_ids, a_mask), plain_encode(params, p_ids, p_mask), 30.0
                )
                loss.backward()
                for group in opt.param_groups:
                    group["lr"] = STEP_CHECK_LR
                opt.step()
                opt.zero_grad(set_to_none=True)
                losses.append(loss.item())
            return losses, first

        plain_losses, plain_grads = run(plain=True)

        def readings(losses, grads) -> dict:
            # The key bias is left out: its exact gradient is zero (it adds
            # q.b to every score of a query row, which softmax ignores), so
            # both paths return only rounding noise there.
            rel = {
                n: rel_err(grads[n], plain_grads[n]) for n in plain_grads if n != "layers/k_b"
            }
            worst = sorted(rel, key=rel.get, reverse=True)
            return {
                "losses": losses,
                "loss_rel": max(abs(k - p) / abs(p) for k, p in zip(losses, plain_losses)),
                "grad_rel": rel[worst[0]],
                "grad_worst_leaf": worst[0],
                "grad_worst_3": {n: rel[n] for n in worst[:3]},
                "k_b_max_abs": grads["layers/k_b"].abs().max().item(),
            }

        before = fused_encoder_layer_backward.launches
        sound = readings(*run(plain=False))
        launched = fused_encoder_layer_backward.launches - before

        def planted(change):
            def faulty(*args, **kwargs):
                return change(*fused_encoder_layer_backward(*args, **kwargs))

            # The wrapper counts its launches through its module-level name.
            faulty.launches = 0
            with mock.patch.object(fused_layer, "fused_encoder_layer_backward", faulty):
                return readings(*run(plain=False))

        faults = {
            "weight_grads_x0.9": planted(lambda dx, dw: (dx, {n: 0.9 * g for n, g in dw.items()})),
            "dx_negated": planted(lambda dx, dw: (-dx, dw)),
        }
        log(
            f"3 steps at dropout 0, lr {STEP_CHECK_LR}, kernels vs plain: losses "
            f"{sound['losses']} vs {plain_losses}; loss rel diff {sound['loss_rel']:.3g} "
            f"(tol {STEP_LOSS_REL_TOL}); first-step grads worst leaf {sound['grad_worst_leaf']} "
            f"{sound['grad_rel']:.3g} (tol {STEP_GRAD_REL_TOL}), worst three "
            f"{sound['grad_worst_3']}; K5 launches {launched}; k_b grad max |g|: kernels "
            f"{sound['k_b_max_abs']:.3g}, plain {plain_grads['layers/k_b'].abs().max().item():.3g}"
        )
        for name, f in faults.items():
            log(
                f"  planted fault {name}: loss rel diff {f['loss_rel']:.3g}, grads worst three "
                f"{f['grad_worst_3']}"
            )
        self.smoke.check(
            sound["loss_rel"] <= STEP_LOSS_REL_TOL
            and sound["grad_rel"] <= STEP_GRAD_REL_TOL
            and launched == 36,
            "3 steps: kernels agree with plain",
        )
        self.smoke.check(
            faults["weight_grads_x0.9"]["grad_rel"] > STEP_GRAD_REL_TOL
            and faults["dx_negated"]["grad_rel"] > STEP_GRAD_REL_TOL
            and faults["dx_negated"]["loss_rel"] > STEP_LOSS_REL_TOL,
            "3 steps: the limits catch the planted K5 faults",
        )
        return {"plain_losses": plain_losses, "kernels": sound, "planted_faults": faults}

    def step_breakdown(self, seq: int, batch: int, n_steps: int = 5) -> dict:
        """Where a training step's time goes: ``n_steps`` TrainStep calls
        (dropout 0.1, AdamW) on the host clock with a device sync, then the
        same steps under torch.profiler for each kernel's device time. The
        device's idle share is 1 - (device time / unprofiled step time)."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        from instacart_next_order_recommendation_tpu_torch.train.trainer import (
            TrainStep,
            build_optimizer,
            warmup_cosine_schedule,
        )

        params, cfg, tok = self.fresh_params()
        step = TrainStep(
            params, cfg, build_optimizer(params, 0.0), warmup_cosine_schedule(2e-4, 100),
            loss_scale=30.0, accum=1, device=self.dev,
        )
        batches = self.batches(tok, seq, batch, n_steps)
        for i, b in enumerate(batches[:2]):  # warm-up
            step(b, seed=i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i, b in enumerate(batches):
            step(b, seed=i)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n_steps

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for i, b in enumerate(batches):
                step(b, seed=i)
            torch.cuda.synchronize()
        per_kernel: dict[str, list[float]] = {}
        for e in prof.events():
            # Kernels, copies and fills; not the GPU-side spans of
            # annotations (Optimizer.step, ...), which cover kernels.
            if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False):
                entry = per_kernel.setdefault(e.name, [0.0, 0])
                entry[0] += e.time_range.elapsed_us() / 1e3 / n_steps
                entry[1] += 1
        device_ms = sum(v[0] for v in per_kernel.values())
        top = sorted(per_kernel.items(), key=lambda kv: -kv[1][0])[:12]
        out = {
            "batch": batch,
            "seq": seq,
            "step_ms": wall_ms,
            "pairs_per_s": batch / wall_ms * 1e3,
            "device_ms_per_step": device_ms if device_ms > 0 else "not measured",
            "device_idle_share": 1 - device_ms / wall_ms if device_ms > 0 else "not measured",
            "device_launches_per_step": sum(v[1] for v in per_kernel.values()) / n_steps,
            "top_kernels_ms_per_step": {
                name[:90]: [round(ms, 4), n // n_steps] for name, (ms, n) in top
            },
        }
        log(f"train step breakdown B={batch} S={seq}: " + json.dumps(out))
        return out

    def flagship(self) -> dict:
        """configs/train_large_batch.yaml's batch (512), lr and loss scale,
        on the same data for 2 epochs; timed on the second."""
        from instacart_next_order_recommendation_tpu_torch.train import TwoTowerTrainer

        trainer = TwoTowerTrainer(self.config(
            "flagship", train_batch_size=512, eval_batch_size=256, learning_rate=3.0e-4,
            loss_scale=50.0, epochs=2, run_information_retrieval_evaluator=False,
        ))
        hist = trainer.train(data=self.data)["history"]
        n_epoch = self.steps_per_epoch(512, 2)
        secs = hist[-1]["epoch_seconds"]
        out = {
            "batch": 512,
            "seq": trainer.seq_len,
            "steps_timed": n_epoch[-1],
            "step_ms": secs / n_epoch[-1] * 1e3,
            "pairs_per_s": 512 * n_epoch[-1] / secs,
            "losses": trainer.step_losses,
        }
        self.smoke.check(bool(np.isfinite(trainer.step_losses).all()), "flagship losses finite")
        log(
            f"flagship B=512 S={trainer.seq_len}: {out['step_ms']:.1f} ms/step, "
            f"{out['pairs_per_s']:.0f} pairs/s over {n_epoch[-1]} steps (epoch 2)"
        )
        return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    from instacart_next_order_recommendation_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on {torch.cuda.get_device_name(0)}")

    smoke = Smoke()
    t0 = time.perf_counter()
    logs = _build.build(ptxas_info=True)
    log(f"build: {sorted(logs) or 'all already built'} in {time.perf_counter() - t0:.1f}s")
    for name, text in logs.items():
        for line in text.splitlines():
            if "Used" in line or "spill" in line and "0 bytes spill" not in line:
                log(f"  ptxas {name}: {line.strip()}")

    try:
        t0 = time.perf_counter()
        with torch.inference_mode():
            smoke.compare_kernels(dev)
        smoke.compare_train_kernels(dev)
        log(f"phase 2 (kernels vs plain) {time.perf_counter() - t0:.1f}s")
        build_root = REPO / "build"
        build_root.mkdir(exist_ok=True)
        with tempfile.TemporaryDirectory(prefix="chip_smoke_", dir=build_root) as tmp:
            t0 = time.perf_counter()
            with torch.inference_mode():
                smoke.serve(dev, Path(tmp))
            log(f"phase 3 (serve path) {time.perf_counter() - t0:.1f}s")
            t0 = time.perf_counter()
            train = TrainPhase(smoke, dev, Path(tmp)).run()
            log("train " + json.dumps(train))
            log(f"phase 4 (training) {time.perf_counter() - t0:.1f}s")
    except Exception:  # noqa: BLE001 - report the failure and exit non-zero
        traceback.print_exc()
        smoke.failures.append("exception")

    if smoke.failures:
        log(f"FAILED: {smoke.failures}")
        return 1
    rows = []
    sources = {
        "fused_encoder_layer": ("fused_layer.cu", "ops/fused_layer.py:135"),
        "masked_mean_pool_l2norm": ("pool_norm.cu", "ops/pool_norm.py:34"),
        "cosine_topk": ("topk.cu", "ops/topk.py:154"),
        "fused_encoder_layer_train": ("fused_layer.cu", "ops/fused_layer.py:135"),
        "fused_encoder_layer_backward": ("fused_layer_bwd.cu", "ops/fused_layer.py:718"),
    }
    for name, (src, tpu) in sources.items():
        rows.append({
            "name": name,
            "route": "cuda",
            "source": f"{PKG}/ops/csrc/{src}",
            "replaces": f"{JAX_PKG}/{tpu}",
            **smoke.kernel_rows[name],
        })
    log(smi)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
