#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

1. Device and build: prints the card (``nvidia-smi`` name and power limit)
   and builds the port's CUDA kernels from ``ops/csrc`` in this checkout.
2. Each kernel against its plain PyTorch version on the card, at the serve
   path's shapes, with the tolerance stated, timed with CUDA events.
3. The serve path at the full width of MiniLM-L6 (random weights from a
   seeded generator): a WordPiece vocab trained on a 50,000-product catalog,
   ``Recommender`` encoding the catalog through the kernels, a few
   ``recommend`` calls (one excluding ids, one filtered to an aisle), a
   batch of 256 queries through ``FusedServePipeline``, and single-query
   latency. The launch counts show the path ran through every kernel, and
   the batch's top-16 ids are held against the plain versions on the card.
4. One JSON line describing each kernel, then, as the last line,
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

K1_TOL = 0.0625  # two bf16 ulps at |y| < 8: another summation order flips roundings
K2_TOL = 1e-5    # f32 sums in another order, unit-norm output
K3_TOL = 0.0     # grid-valued inputs: every dot product is exact in f32


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


def k1_bound(b: int, s: int, h: int, inter: int) -> tuple[float, str]:
    weights = (4 * h * h + 2 * h * inter) * 2 + (6 * h + inter) * 2 + 4 * h * 4
    n_bytes = b * s * h * 2 * 2 + b * s * 4 + weights
    ops = 2 * b * s * (4 * h * h + 2 * h * inter) + 4 * b * s * s * h
    return bound_ms(n_bytes, ops, PEAK_BF16)


def k2_bound(b: int, s: int, h: int) -> tuple[float, str]:
    return bound_ms(b * s * h * 2 + b * s * 4 + b * h * 4, 2 * b * s * h, PEAK_F32)


def k3_bound(b: int, n: int, d: int, k: int, masked: bool) -> tuple[float, str]:
    n_bytes = n * d * 4 + b * d * 4 + b * k * 8 + (n * 4 if masked else 0)
    return bound_ms(n_bytes, 2 * b * n * d, PEAK_F32)


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
        # ---- end of the main path

        n_forwards = counts["masked_mean_pool_l2norm"]
        log(f"main-path launches: {counts} ({n_forwards} tower forwards)")
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
        with torch.inference_mode():
            t0 = time.perf_counter()
            smoke.compare_kernels(dev)
            log(f"phase 2 (kernels vs plain) {time.perf_counter() - t0:.1f}s")
            t0 = time.perf_counter()
            build_root = REPO / "build"
            build_root.mkdir(exist_ok=True)
            with tempfile.TemporaryDirectory(prefix="chip_smoke_", dir=build_root) as tmp:
                smoke.serve(dev, Path(tmp))
            log(f"phase 3 (serve path) {time.perf_counter() - t0:.1f}s")
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
