#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

1. Device and build: prints the card (``nvidia-smi`` name and power limit)
   and builds the port's CUDA kernels from ``ops/csrc`` in this checkout;
   fails if ptxas spills in an attention kernel at head_dim 32 or 64, in
   any kernel of the fused layer (K1, K5), in any top-k kernel (K3, K4) or
   in any pool kernel (K2), or if a head_dim 32 or 64 instance of the fused
   layer's attention kernels or an instance of the top-k or pool kernel is
   missing.
2. Each kernel against its plain PyTorch version on the card, with the
   tolerance stated, timed with CUDA events: K1, K2 and K3 (and K4, the
   packed top-k, on the same grid values) at the serve path's shapes; the
   training form of the fused layer (K1 with dropout masks) and the fused
   backward (K5) at B in {1, 64, 512} and S in {32, 64, 128, 256}, K1 and
   K5 as medians of five readings in turns with their
   ``nn.TransformerEncoderLayer`` yardsticks, and K1-train, K5 and K5's
   yardstick at S=256 broken down launch by launch (``torch.profiler``);
   the same three fused-layer kernels (and K2) at head_dim 64
   (mpnet-base-class widths) at B in {1, 64, 256} and S in {32, 64, 128,
   192, 256}, read in turns with their yardsticks at the serve shape
   (256, 192) and the train shape (64, 256); each K1 reading with the
   largest |y| and the worst error in bf16 ulps; the attention forward and
   backward (K6, K7) at the shapes the unfused layer gives them; K3 timed
   at B in {1, 256} over 50k unit rows at D=384 and 768 (and at k in {10,
   100, 256}), K4 at B in {8, 256}, each split by the profiler into the
   slice kernel and the merge and read beside torch.topk(torch.mm(q, C.T),
   k) (two calls, for reference); K4 against K3 over a 1M-row catalog at B
   in {8, 256}, read the same way. K3 and K4 on bf16 rows against their
   plain version over 50k and 1M unit rows at D=384 and 768, B in {1, 8,
   256}, k in {10, 16, 100}, with and without a candidate mask, and timed
   in turns beside the f32 K3 on the same rows and torch.topk(torch.mm(q,
   C.T), k) on the bf16 operands.
3. The serve path at the full width of MiniLM-L6 (random weights from a
   seeded generator): a WordPiece vocab trained on a 50,000-product catalog,
   ``Recommender`` encoding the catalog through the kernels, a few
   ``recommend`` calls (one excluding ids, one filtered to an aisle, one
   whose top_k + |excluded| > 256 takes the dense top-k route), a batch of
   256 queries through ``FusedServePipeline``, and single-query latency.
   The launch counts show the path ran through every kernel, and the
   batch's top-16 ids are held against the plain versions on the card; one
   K1 call at the batch's shape is broken down launch by launch. K2 is
   held against its plain version, two launches bitwise equal, and timed
   cold (a 256 MB buffer written and read between launches) and warm, in
   turns with a few PyTorch calls for the same function, at the batch's
   shape and at one recommend's, a catalog batch's and a train step's
   (B=64, S=256), with the form ``pool_plan`` picks; the same for the
   mpnet-base-class tower.
   Then the same serve path for the mpnet-base-class tower at full width
   (head_dim 64 through the fused layer: 12 K1 per forward, no K6),
   MiniLM-L6 and mpnet-base-class at two lengths their fused kernels do not
   take (S=512 and S=200, through K6), and
   ``Recommender(topk_extraction="packed")`` (K4) against the exact one.
   K3 and K4 are read beside torch.topk(torch.mm(q, C.T), k) at the
   batch's shapes.
3c. The serving tier on phase 3's MiniLM-L6 tower, corpus and queries:
   the native (C++) tokenizer's ids and masks held to its pure-Python
   version on every catalog text and query, both timed;
   ``MonitoredRecommender`` (catalog encode through the native tokenizer,
   single queries against ``Recommender.recommend``, calibrated and
   measured stage timings); ``warm_serve_shapes`` over the whole serve
   lattice, with the first request's latency beside an unwarmed
   recommender's; ``MicroBatcher`` (4 ms window, batches of up to 64) at
   concurrency 1, 8 and 64, every request held to the direct recommend by
   the near-tie rule, exclusions and filters held, every launch accounted
   for; ``model_signature`` and the ``encoder=`` injection on a second
   corpus; and the serve CLI as a subprocess. Launch counts are reset
   before and read after.
3d. The HTTP API (``api.create_app`` with its default factory on CUDA,
   served by ``api.http.make_server`` on local sockets) on phase 3's tower,
   corpus and queries: startup with the serve-lattice warm-up; /health,
   /ready, /metrics; /recommend by user context, user id, query, with
   exclusions, filtered, and on the dense route, each answer held to a
   direct ``MonitoredRecommender.recommend`` by the near-tie rule;
   /feedback single and batch and the request contexts read back from
   SQLite; the API key and the rate limit; load from a client process at
   concurrency 1, 8 and 64 without and with ``BATCH_WINDOW_MS`` (every
   launch accounted for, the device idle share of a profiled run at 64);
   /admin/corpus on the live encoder (alone, timed beside a fresh load,
   and under load at concurrency 8) and /admin/model, with the peak device
   memory; ``ITOR_TOPK_EXTRACTION=packed`` (K4); and the API CLI as a
   subprocess, stopped with SIGINT. Launch counts are reset before and
   read after.
3e. The IVF index and the bf16 catalog: phase 3's MiniLM-L6 tower, 50k
   catalog and queries through ``Recommender(ann=True)`` at full probe
   (top-10 equal to the exact recommender's by the near-tie rule, filtered
   too) and at ``ann_nprobe=8`` (recall@10), under ``MonitoredRecommender``,
   ``warm_serve_shapes`` and a ``MicroBatcher`` at concurrency 8, and the
   serve CLI as a subprocess with ``ann: true`` (K1 and K2, no K3); then
   the IVF bench's clustered 1M x 384 rows built with nlist 1024 in f32 and
   bf16 buckets (seconds by stage, peak memory, every row in exactly one
   bucket), recall@10 at nprobe 8 and 16 against the exact index on the
   bf16 catalog (K3 and K4 on bf16 rows), and device ms at B=8 and B=256
   beside the exact scans. Launch counts are reset before and read after.
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
4b. Hugging Face towers, training's tracing and the baselines, at
   MiniLM-L6's full width, in two parts. Before phase 4's first ``train()``
   (``torch.profiler`` has dropped kernel records in traces taken after
   one): phase 3's seeded tower written as three Hugging Face directories
   (``config.json`` with BertConfig's fields, the vocab and
   ``tokenizer_config.json``; ``pytorch_model.bin`` bare and under
   ``0.auto_model.``, ``model.safetensors`` under ``bert.``, by a writer in
   this script: no transformers), each loaded by ``load_tower`` bitwise
   equal to the source and encoding the 256 serve queries bitwise equal to
   it; ``Recommender`` on one over phase 3's 50k catalog (the same catalog,
   bitwise, and the same top-10 ids for 32 queries); ``/admin/model`` to
   one on a live ``create_app``, its answers held to the direct recommend
   by the near-tie rule; and ``TwoTowerTrainer`` warm-started from one
   (``model_name:`` the directory) for one epoch at B=64 on phase 4's pairs
   with ``ITOR_PROFILE_DIR`` and ``ITOR_LOOP_TIMING=1``: the loss falls, 12
   K1-train and 12 K5 launches a step, a trace whose kernel records hold
   the 60 K1-train and 60 K5 launches of dispatches 1-5 (read with each
   kernel's launches per call, traced just before), the loop-timing lines
   every 25 dispatches, and ``final/`` loads. After phase 4: phase 4's
   users as Instacart CSVs and eval files, ``python -m
   instacart_next_order_recommendation_tpu_torch.baselines`` as a
   subprocess with the untrained tower and with phase 4's trained one (both
   with CF; exit 0, both tables parse, NDCG@10 trained above untrained),
   and CF's top-5 for 20 queries against a plain count of co-occurring
   pairs. Launch counts are reset before and read after.
5. The same training for the mpnet-base-class tower (``model_name:
   mpnet-base``) for one epoch through the fused layer: 24 K1-train and 24
   K5 launches per step, 12 K1 per eval forward, no K6 or K7; the 3-step
   check with planted K5 faults; the same check at S=200, which the fused
   kernels do not take, with planted K7 faults (24 K6 and 24 K7 launches a
   step); B=256 steps with the remat that ``_resolve_remat`` chooses, with
   their peak device memory and launch counts, at S=256 (off: the fused
   backward keeps only the layer inputs) and at S=200 (on: the unfused
   layers under ``torch.utils.checkpoint``, K6 run again in the backward);
   and the profiler's breakdown of a B=64 step.
5b. Multi-GPU on the one card. The device mesh puts two data shards on
   cuda:0: ``ShardedCatalogIndex`` over phase 3's 50k catalog at B=256,
   k=16 (f32, bf16, packed, aisle-masked; two K3 or K4 launches a call)
   against the one-device index by the near-tie rules, dp=4 over 50,001
   rows (a short last shard), the 1M rows of phase 3e at B=8 timed beside
   the one-device scan, IVF's mesh build on them (every row in one bucket,
   recall@10 at nprobe 8 within 0.01 of phase 3e's build, seconds by
   stage), and ``TextEncoder`` over the mesh on the 50k catalog against the
   one-device encode. Then two gloo ranks share cuda:0 (NCCL refuses two
   ranks on one GPU), spawned by this script, each with its own launch
   counts: DP=2 MiniLM-L6 through ``TwoTowerTrainer.train`` for one epoch
   at train_batch_size 32 (global 64; 12 K1-train and 12 K5 a rank a step;
   the loss falls; only rank 0 writes; ``final/`` serves), TP=2
   mpnet-base-class for two epochs at B=64, S=256 (24 K6 and 24 K7 a rank
   a step, no K1 or K5; the loss falls; peak memory a rank), and for each
   3 dropout-0 steps held to the one-process ``TrainStep`` at B=64 by phase
   4's limits (TP at S=200), with planted faults that must break them (no
   division by dp; rank 1's positives left out of the gather; rank 1's
   tp_exit all-reduce left out). Step ms a rank are printed as two ranks
   sharing one card with collectives through gloo: not a scaling figure.
6. The user workflows, in this process through each one's ``main``, at
   MiniLM-L6's full width, launch counts reset before and read after each:
   (a) the port's synthetic CSVs (1,200 users, 2,000 products, real-length
   names) and ``python -m instacart_next_order_recommendation_tpu_torch.data``'s
   ``main`` (every relevant doc in the corpus, no eval query holding the
   next order); (b) ``scripts/torch_run_demo.py`` at its defaults (12
   K1-train and 12 K5 launches a step; K1, K2 and K3 in the recommend and
   HTTP stages); (c) the feedback loop on the demo's model, served by
   ``create_app`` on a local port: ``torch_generate_sample_feedback`` (60
   recommends with their contexts stored, and their funnel events),
   ``torch_feedback_analytics``, and two ``torch_feedback_retrain --once``
   ticks warm-started from the served model, the first with a gate no run
   passes (the served model's signature and answers unchanged), the second
   with one every run passes (the model hot-swapped through
   ``/admin/model``; /recommend then answers the new tower's direct
   recommend by the near-tie rule); (d) ``torch_compare_untrained_vs_trained``
   on the demo's data and model (the collapse indicators); (e)
   ``torch_real_data_run`` on (a)'s prep, warm-started from phase 4b's
   safetensors HF directory, one epoch at B=64, S=256, its results file
   in the temporary directory (random weights: not a parity run).
7. One JSON line describing each kernel (with ``launches_phase_5b`` and
   ``launches_phase_6``), then, as the last line,
   ``{"ok": true, "device": {...}}``.

Exits non-zero, without the last line, when CUDA is absent or any check
fails. Imports nothing of JAX.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import io
import itertools
import json
import os
import re
import sqlite3
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path
from unittest import mock

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
PKG = "instacart_next_order_recommendation_tpu_torch"
JAX_PKG = "instacart_next_order_recommendation_tpu"

# H100 SXM peaks (NVIDIA data sheet, dense): bf16 and TF32 tensor cores,
# f32 FMA, HBM3.
PEAK_BF16 = 989e12
PEAK_TF32 = 495e12
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12

FLUSH_BYTES = 256 << 20
SPIN_CYCLES = 200_000  # torch.cuda._sleep: about 0.1 ms at the H100's clock
HOST_CALLS = 200

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

# K1 (both forms), absolute: two bf16 ulps at |y| in [4, 8), where the
# largest outputs lie. Another summation order moves the sums before each
# LayerNorm, so an element's error is a few ulps of the row's scale, not
# of its own |y|: a small |y| may read several of its own ulps. Every K1
# reading logs the largest |y| and, at the worst element, |y| and the error
# in ulps of it (``k1_error``); PERF.md records them.
K1_TOL = 0.0625
K2_TOL = 1e-5    # f32 sums in another order, unit-norm output
K3_TOL = 0.0     # grid-valued inputs: every dot product is exact in f32
# K5, relative to each gradient's largest magnitude: bf16 operands round at
# other points than in the plain version's autograd (dU, P, dL, dhpre, df and
# dao enter the kernel's products as bf16) and the f32 sums over B*S rows
# run in another order.
K5_REL_TOL = 2e-2
# The kernels of each fused-layer library, as ptxas names them: every one
# must appear in its report, and none may spill.
FUSED_LAYER_KERNELS = {
    "fused_layer": ("gemm_kernel", "attn_fwd_one_pass_kernel", "residual_layernorm_kernel"),
    "fused_layer_bwd": (
        "gemm_kernel", "attn_fwd_one_pass_kernel", "residual_layernorm_kernel",
        "attn_bwd_dq_kernel", "attn_bwd_dkdv_kernel", "ln_bwd_kernel", "colsum_kernel",
    ),
}
# The attention instances of each fused-layer library: head_dim 32 and 64,
# one to four 64-key tiles (S <= 256).
_FWD = [f"attn_fwd_one_pass_kernel<{d},{n},0>" for d in (32, 64) for n in range(1, 5)]
FUSED_LAYER_ATTENTION = {
    "fused_layer": _FWD,
    "fused_layer_bwd": _FWD + [
        f"{k}<{d},{n}>" for k in ("attn_bwd_dq_kernel", "attn_bwd_dkdv_kernel")
        for d in (32, 64) for n in range(1, 5)
    ],
}
# The top-k kernel's instances (csrc/topk.cu): <query tile, list size>, on
# f32 rows and on bf16 rows.
TOPK_KERNELS = [
    f"{name}<{tq},{kp}>" for name in ("topk_slices_kernel", "topk_slices_bf16_kernel")
    for tq, kp in [(8, 32), (8, 64), (8, 128), (8, 256), (64, 32), (64, 64), (64, 128), (32, 256)]
] + [f"topk_merge_kernel<{kp}>" for kp in (32, 64, 128, 256)]
# K2's instances (csrc/pool_norm.cu): <load width, rows in flight, cluster form>.
POOL_KERNELS = [
    f"pool_l2norm_kernel<{vec},{rows},{cluster}>"
    for vec, rows in ((8, 2), (8, 4), (1, 8)) for cluster in (0, 1)
]
# (hidden, heads, intermediate) of MiniLM-L6 (12 heads of 32) and of
# mpnet-base-class (12 heads of 64).
MINILM_WIDTHS = (384, 12, 1536)
MPNET_WIDTHS = (768, 12, 3072)
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
# K6 and K7, relative to each output's largest magnitude: both sum their
# tensor-core products in another order than the plain version, so a bf16
# rounding of K6's P or of any output may flip (one bf16 ulp is at most 2^-7
# of the largest magnitude); K7's P and dS enter its products as two bf16
# terms each (about 2^-17 relative), and each gradient is rounded to bf16
# once.
ATTN_REL_TOL = 1e-2
# A packed top-k id that differs from the exact one at the same rank must be
# a tie within the 20-bit key: exact scores within two quantization steps
# (one step is at most 2^-11 of the score; the kernel's f32 sums may move a
# score across one step boundary).
PACKED_TIE_REL = 2.0**-10
PACKED_N = 1_000_000  # the catalog size the JAX package names for packed extraction
# K3/K4 on bf16 rows against their plain version (which upcasts to f32):
# scores within 1e-5 of the f32 products of the same bf16 values (a bf16
# product is exact in f32; the tensor cores sum in another order), and an
# id that differs from the plain version's at one rank is a near-tie: the
# two rows' f32 scores within BF16_TIE (K4: within PACKED_TIE_REL).
BF16_TOPK_TOL = 1e-5
BF16_TIE = 2e-5
# Phase 3e: the 50k serve through Recommender(ann=True), held to phase 3's
# exact recommender by the near-tie rule (IVF's f32 scores against K3's
# split-TF32 ones of the same embeddings), and the 1M-row build and search.
IVF_QUERIES = 32
IVF_NLIST_50K = 64
IVF_BATCHER_REQUESTS = 128
IVF_TIE_TOL = 1e-5
IVF_1M_NLIST = 1024
IVF_1M_NPROBES = (8, 16)
IVF_KMEANS_ITERS = 4
MPNET_EPOCHS = 1
# This departs from the recipe: configs/train.yaml's 2e-4 (with 9 warmup
# steps over this one epoch) collapsed the 12-layer post-LN tower from random
# weights to one embedding for every text, the loss flat at ln 64, while
# 3e-5 falls steadily. scripts/torch_mpnet_lr_probe.py reads both rates and
# two between, beside a torch.nn tower that shares no code with the port's.
MPNET_LR = 3e-5
REMAT_BATCH = 256
# The length of the mpnet training batches that hold K6 and K7 through
# TrainStep: one the fused kernels refuse (S % 16 != 0).
ATTENTION_TRAIN_SEQ = 200


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


def cuda_ms_median(fn, iters: int, repeats: int = 5) -> float:
    """The median of ``repeats`` readings of ``cuda_ms``: one reading can
    move by a third from call to call (SDPA's backward read 0.890 and 0.581
    ms at one shape on one H100)."""
    return float(np.median([cuda_ms(fn, iters) for _ in range(repeats)]))


def flush_l2() -> None:
    """Leave nothing of a kernel's inputs in the L2: write a buffer of five
    times the H100's 50 MB L2, then read it back, so that the cache holds
    clean lines of the buffer only (dirty lines would be written back
    inside the next timed launch)."""
    torch.ones(FLUSH_BYTES // 4, dtype=torch.float32, device="cuda").sum()


def _behind_ms(fn, iters: int, before, warmup: int = 2) -> float:
    """Median milliseconds of one call, each timed call queued behind
    ``before()``'s device work, outside its CUDA events: the host enqueues
    the call while the card is busy, so its own overhead is not timed."""
    for _ in range(warmup):
        fn()
    events = [
        (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        for _ in range(iters)
    ]
    for start, end in events:
        before()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return float(np.median([start.elapsed_time(end) for start, end in events]))


def cold_ms(fn, iters: int) -> float:
    """One call with the L2 cold: ``flush_l2`` before each timed call."""
    return _behind_ms(fn, iters, flush_l2)


def warm_ms(fn, iters: int) -> float:
    """One call right after the same call (an input under the L2's 50 MB
    is then read from it), each behind a spin of the card of about 0.1 ms."""
    return _behind_ms(fn, iters, lambda: torch.cuda._sleep(SPIN_CYCLES))


def ms_in_turns(fns: dict, iters: int, turns: int = 2, read=cuda_ms_median) -> dict[str, float]:
    """Each function's milliseconds, read in turns: in each of ``turns``
    rounds every function takes a ``read`` reading (``cuda_ms_median``,
    ``cold_ms`` or ``warm_ms``), the order reversed every other round, so
    that a kernel and its yardstick see the same state of the card; the
    median of the rounds."""
    names = list(fns)
    readings: dict[str, list[float]] = {n: [] for n in names}
    for turn in range(turns):
        for n in names if turn % 2 == 0 else names[::-1]:
            readings[n].append(read(fns[n], iters))
    return {n: float(np.median(r)) for n, r in readings.items()}


def _kernel_name(name: str) -> str:
    """A demangled kernel name without its return type and parameter list."""
    m = re.search(r"([\w:]+(?:<[^()]*>)?)\(", name)
    return (m.group(1) if m else name).replace("(anonymous namespace)::", "")


def launch_breakdown(fn, calls: int = 3) -> list[dict]:
    """Every device launch of one ``fn()`` call, in order: kernel, copy or
    fill, its grid and block, registers per thread, dynamic shared memory
    and device microseconds (the median over ``calls`` calls traced in one
    torch.profiler session, CUPTI underneath). Raises if the trace does not
    hold the same launches for every call."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
            torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text())["traceEvents"]
    launches = [
        e for e in sorted(events, key=lambda e: float(e.get("ts", 0)))
        if e.get("ph") == "X" and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
    ]
    n = len(launches) // calls
    names = [_kernel_name(e["name"]) for e in launches]
    if n == 0 or len(launches) != n * calls or any(
        names[c * n : (c + 1) * n] != names[:n] for c in range(calls)
    ):
        raise RuntimeError(f"launch_breakdown: {len(launches)} traced launches over {calls} calls")
    out = []
    for i, e in enumerate(launches[:n]):
        args = e.get("args", {})
        out.append({
            "name": names[i],
            "grid": args.get("grid"),
            "block": args.get("block"),
            "regs": args.get("registers per thread"),
            "smem": args.get("shared memory"),
            "us": float(np.median([float(launches[c * n + i]["dur"]) for c in range(calls)])),
        })
    return out


def show_breakdown(what: str, fn) -> None:
    """``log_breakdown`` of ``launch_breakdown(fn)``. A trace that does not
    hold the same launches for every call (CUPTI on the card has dropped a
    record) is taken again, twice at most, then reported as not measured:
    the profiler is a reading, not a check."""
    for _ in range(3):
        try:
            log_breakdown(what, launch_breakdown(fn))
            return
        except RuntimeError as e:
            err = e
    log(f"{what}: not measured ({err})")


def log_breakdown(what: str, launches: list[dict]) -> None:
    total = sum(x["us"] for x in launches)
    log(f"{what}: {len(launches)} launches, {total / 1e3:.4f} ms of device time")
    for x in launches:
        log(f"  {x['us']:9.1f} us  {x['name']}  grid={x['grid']} block={x['block']} "
            f"regs={x['regs']} smem={x['smem']}")


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


def pool_yardstick(h: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """K2's function in a few PyTorch calls (no single call computes it;
    the port never calls this). ``m`` is the mask in f32."""
    return torch.nn.functional.normalize(
        (h.float() * m[..., None]).sum(1) / m.sum(1, keepdim=True).clamp_min(1e-9), dim=-1
    )


def pool_reading(y: torch.Tensor, m: torch.Tensor, iters: int = 30) -> dict:
    """K2 at one shape on the card: against its plain version (K2_TOL), two
    launches bitwise equal, the form ``pool_plan`` picks, and its time in
    turns with ``pool_yardstick`` (N calls), cold (``cold_ms``: the
    kernels line's ms) and warm (``warm_ms``); the wrapper's host time per
    call, back to back without a sync (what a host-bound caller such as a
    single query waits for); the plain version's time, the bytes bound and
    the cold share of it."""
    from instacart_next_order_recommendation_tpu_torch.ops import pool_norm

    b, s, h = y.shape
    out = pool_norm.masked_mean_pool_l2norm(y, m)
    again = pool_norm.masked_mean_pool_l2norm(y, m)
    ref = pool_norm.masked_mean_pool_l2norm_reference(y, m)
    plan = getattr(pool_norm, "pool_plan", None)  # an older checkout has none
    sms = torch.cuda.get_device_properties(y.device).multi_processor_count
    mf = m.float()
    fns = {
        "kernel": lambda: pool_norm.masked_mean_pool_l2norm(y, m),
        "yardstick": lambda: pool_yardstick(y, mf),
    }
    cold = ms_in_turns(fns, iters, turns=4, read=cold_ms)
    warm = ms_in_turns(fns, iters, turns=4, read=warm_ms)
    fns["kernel"]()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(HOST_CALLS):
        fns["kernel"]()
    host_us = (time.perf_counter() - t0) / HOST_CALLS * 1e6
    torch.cuda.synchronize()
    bnd, by = k2_bound(b, s, h)
    return {
        "shape": [b, s, h],
        "form": plan(b, s, sms)._asdict() if plan else "one block per row",
        "ms": cold["kernel"],
        "warm_ms": warm["kernel"],
        "yardstick_n_calls_ms": cold["yardstick"],
        "yardstick_n_calls_warm_ms": warm["yardstick"],
        "plain_ms": cuda_ms(lambda: pool_norm.masked_mean_pool_l2norm_reference(y, m), 10),
        "library_ms": None,
        "max_abs_err": (out - ref).abs().max().item(),
        "finite": bool(torch.isfinite(out).all()),
        "bitwise_equal": torch.equal(out.view(torch.int32), again.view(torch.int32)),
        "host_us": host_us,
        "bound_ms": bnd,
        "bound_by": by,
        "bound_share_cold": bnd / cold["kernel"],
    }


K2_ROW_KEYS = ("ms", "plain_ms", "library_ms", "max_abs_err", "bound_ms", "bound_by")


def most_common(values) -> int:
    values = list(values)
    return max(set(values), key=values.count)


def pool_ok(row: dict) -> bool:
    return row["finite"] and row["bitwise_equal"] and row["max_abs_err"] <= K2_TOL


def k3_bound(b: int, n: int, d: int, k: int, masked: bool) -> tuple[float, str]:
    """K3/K4 on the unit they run on: the catalog, the queries (and the
    mask) read and the top k written once; three TF32 tensor-core products
    per multiply-add (split TF32), 3 * 2 * B * N * D operations at the TF32
    peak."""
    n_bytes = n * d * 4 + b * d * 4 + b * k * 8 + (n * 4 if masked else 0)
    return bound_ms(n_bytes, 3 * 2 * b * n * d, PEAK_TF32)


def k3_fma_bound(b: int, n: int, d: int, k: int, masked: bool) -> tuple[float, str]:
    """The same bytes against 2 * B * N * D f32 FMA operations: the bound
    of the f32 function on CUDA cores, beside k3_bound."""
    n_bytes = n * d * 4 + b * d * 4 + b * k * 8 + (n * 4 if masked else 0)
    return bound_ms(n_bytes, 2 * b * n * d, PEAK_F32)


def k3_bf16_bound(b: int, n: int, d: int, k: int, masked: bool) -> tuple[float, str]:
    """K3/K4 on bf16 rows: the catalog and the queries (2 bytes an element)
    and the mask read and the top k written once; one bf16 tensor-core
    product per multiply-add, 2 * B * N * D operations at the bf16 peak."""
    n_bytes = n * d * 2 + b * d * 2 + b * k * 8 + (n * 4 if masked else 0)
    return bound_ms(n_bytes, 2 * b * n * d, PEAK_BF16)


def ids_near_tie(scores, got, want, rel: float, tol: float) -> bool:
    """Every rank where the ids ``got`` differ from ``want`` holds two rows
    whose ``scores`` (f32, [B, N]) lie within ``rel`` of the second's
    magnitude plus ``tol``."""
    a = scores.gather(1, got.long())
    b = scores.gather(1, want.long())
    return bool(((got == want) | ((a - b).abs() <= rel * b.abs() + tol)).all())


def topk_split(fn) -> dict | None:
    """Device microseconds of one top-k call from ``launch_breakdown``:
    the slice kernel (an older checkout's block kernel), and the merge
    (every other launch: the merge kernel, or an older checkout's sort and
    gather). None when three traces in a row dropped records (PERF.md
    section 6)."""
    for _ in range(3):
        try:
            launches = launch_breakdown(fn)
        except RuntimeError:
            continue
        kernel = sum(
            x["us"] for x in launches
            if x["name"].lstrip(":").startswith(("topk_slices_kernel", "topk_block_kernel"))
        )
        total = sum(x["us"] for x in launches)
        return {
            "kernel_us": kernel, "merge_us": total - kernel, "merge_share": 1 - kernel / total,
            "launches": [x["name"] for x in launches],
        }
    return None


def topk_reading(q, c, k: int, packed: bool, iters: int = 20) -> dict:
    """One top-k shape on the card: K3 (or K4) against its plain version
    (scores within 1e-5 and at least 99% of ids identical for K3; every
    differing K4 id a 20-bit tie), its time with CUDA events, the
    profiler's kernel and merge times, its bound on the tensor cores and on
    f32 FMA, the plain version's time and, two calls and no library call
    for the function, torch.topk(torch.mm(q, C.T), k) for reference."""
    from instacart_next_order_recommendation_tpu_torch.ops import topk as topk_module
    from instacart_next_order_recommendation_tpu_torch.ops.topk import (
        cosine_topk,
        cosine_topk_packed_reference,
        cosine_topk_reference,
    )

    b, d = q.shape
    n = c.shape[0]
    plain = cosine_topk_packed_reference if packed else cosine_topk_reference
    s_k, i_k = cosine_topk(q, c, k, packed=packed)
    s_r, i_r = plain(q, c, k)
    # The plan's names, where the package read has them (an older
    # checkout's, read by scripts/torch_topk_profile.py, may not).
    plan = getattr(topk_module, "slice_plan", None)
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    row = {
        "B": b, "N": n, "D": d, "k": k, "packed": packed,
        "query_tile": topk_module.query_tile(b, k) if plan else None,
        "slices": plan(b, n, k, sms)[1] if plan else None,
        "max_abs_err": (s_k - s_r).abs().max().item(),
        "ids_identical": float((i_k == i_r).float().mean()),
        "ok": packed_ties_ok(q, c, i_k, i_r) if packed else None,
        "ms": cuda_ms(lambda: cosine_topk(q, c, k, packed=packed), iters),
        "plain_ms": cuda_ms(lambda: plain(q, c, k), max(2, iters // 4)),
        "two_calls_ms": cuda_ms(lambda: torch.topk(torch.mm(q, c.T), k), iters),
    }
    row["bound_ms"], row["bound_by"] = k3_bound(b, n, d, k, False)
    row["f32_fma_bound_ms"] = k3_fma_bound(b, n, d, k, False)[0]
    row["split"] = topk_split(lambda: cosine_topk(q, c, k, packed=packed))
    if not packed:
        row["ok"] = row["max_abs_err"] <= 1e-5 and row["ids_identical"] >= 0.99
    return row


def k5_bound(b: int, s: int, h: int, inter: int, masked: bool) -> tuple[float, str]:
    """Inputs x, g (and masks) and the weights read once, dx and the twelve
    grads written once; forward recompute + dgrad + wgrad GEMMs and the
    attention backward."""
    n_bytes = (
        b * s * h * 2 * (3 + (2 if masked else 0)) + b * s * 4 + 2 * layer_weight_bytes(h, inter)
    )
    ops = 3 * 2 * b * s * (4 * h * h + 2 * h * inter) + 12 * b * s * s * h
    return bound_ms(n_bytes, ops, PEAK_BF16)


def library_train_calls(library, x, pad, up):
    """One nn.TransformerEncoderLayer forward, and its autograd backward,
    at x's shape, as callables (the yardsticks for K1-train and K5)."""
    xr = x.detach().requires_grad_(True)
    y = library(xr, src_key_padding_mask=pad)
    inputs = [xr, *library.parameters()]
    return (
        lambda: library(xr, src_key_padding_mask=pad),
        lambda: torch.autograd.grad(y, inputs, up, retain_graph=True),
    )


def measure_k1(x, m, layer, kw, iters: int = 20):
    """K1 at x's shape against its plain version, timed in turns with one
    nn.TransformerEncoderLayer forward (eval) at the same widths (medians of
    five). Returns the kernels-line row, without launches, and K1's output."""
    from instacart_next_order_recommendation_tpu_torch.ops import fused_encoder_layer
    from instacart_next_order_recommendation_tpu_torch.ops.fused_layer import (
        fused_encoder_layer_reference,
    )

    b, s, h = x.shape
    inter = layer["w1"].shape[1]
    y = fused_encoder_layer(x, m, layer, **kw)
    err = k1_error(y, fused_encoder_layer_reference(x, m, layer, **kw))
    library = torch.nn.TransformerEncoderLayer(
        d_model=h, nhead=kw["num_heads"], dim_feedforward=inter, dropout=0.0,
        activation="gelu", batch_first=True, norm_first=False,
    ).to(x.device, torch.bfloat16).eval()
    pad = m == 0
    t = ms_in_turns({
        "k1": lambda: fused_encoder_layer(x, m, layer, **kw),
        "lib": lambda: library(x, src_key_padding_mask=pad),
    }, iters)
    bnd, by = k1_bound(b, s, h, inter)
    row = dict(
        ms=t["k1"],
        plain_ms=cuda_ms(lambda: fused_encoder_layer_reference(x, m, layer, **kw), 3),
        library_ms=t["lib"], bound_ms=bnd, bound_by=by, **err,
    )
    return row, y


def rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return ((a.float() - b.float()).abs().max() / b.float().abs().max().clamp_min(1e-30)).item()


def bf16_ulp(a: torch.Tensor) -> torch.Tensor:
    """The spacing of bf16 values at |a|: 2^(e - 7) for |a| in [2^e, 2^(e+1))."""
    return torch.exp2(torch.floor(torch.log2(a.float().abs().clamp_min(2.0**-126))) - 7)


def k1_error(y: torch.Tensor, y_ref: torch.Tensor) -> dict:
    """K1's output (either form) against its plain version's: the largest
    absolute error, which K1_TOL holds; the largest |y_ref|; and at the
    element with the largest error, |y_ref| and the error in bf16 ulps of
    |y_ref|."""
    err = (y.float() - y_ref.float()).abs().flatten()
    ref = y_ref.float().abs().flatten()
    i = int(err.argmax())
    return {
        "max_abs_err": err[i].item(),
        "max_abs_ref": ref.max().item(),
        "worst_abs_ref": ref[i].item(),
        "worst_ulps": (err[i] / bf16_ulp(ref[i])).item(),
    }


def attention_bound(b: int, h: int, s: int, d: int, backward: bool) -> tuple[float, str]:
    """The forward reads q, k, v and writes o, 4*B*h*S*D*2 bytes, for the JAX
    cost estimate's 4*B*h*S^2*D operations; the backward reads q, k, v, dO
    and writes dq, dk, dv, 7*B*h*S*D*2 bytes, for 10*B*h*S^2*D. Both read the
    f32 key bias, B*S*4 bytes. Operations at the bf16 tensor-core peak: the
    kernels multiply bf16 operands (the backward's f32 P and dS as bf16
    pairs, which the bound does not charge)."""
    unit = b * h * s * s * d
    tensors, ops = (7, 10 * unit) if backward else (4, 4 * unit)
    return bound_ms(tensors * b * h * s * d * 2 + b * s * 4, ops, PEAK_BF16)


class PlainAttention(torch.autograd.Function):
    """K6's and K7's plain versions as one differentiable op."""

    @staticmethod
    def forward(ctx, q, k, v, mask, scale):
        from instacart_next_order_recommendation_tpu_torch.ops import (
            multi_head_attention_reference,
        )

        ctx.scale = scale
        ctx.save_for_backward(q, k, v, mask)
        return multi_head_attention_reference(q, k, v, mask, scale)

    @staticmethod
    def backward(ctx, do):
        from instacart_next_order_recommendation_tpu_torch.ops import (
            multi_head_attention_backward_reference,
        )

        q, k, v, mask = ctx.saved_tensors
        grads = multi_head_attention_backward_reference(q, k, v, mask, do.contiguous(), ctx.scale)
        return (*grads, None, None)


@contextlib.contextmanager
def plain_kernels():
    """The tower with every kernel replaced by its plain version, forward
    and backward: the fused layer in both forms, attention and the pool."""
    from instacart_next_order_recommendation_tpu_torch.models import encoder as encoder_mod
    from instacart_next_order_recommendation_tpu_torch.ops import fused_layer
    from instacart_next_order_recommendation_tpu_torch.ops.pool_norm import (
        masked_mean_pool_l2norm_reference,
    )

    def attention(q, k, v, mask, scale):
        return PlainAttention.apply(q, k, v, mask, scale)

    def train_layer(x, mask, layer, *, generator=None, masks=None, dropout_rate, **kw):
        if dropout_rate <= 0:
            masks = None
        elif masks is None:
            masks = fused_layer.draw_dropout_masks(x.shape, dropout_rate, generator, x.device, x.dtype)
        return fused_layer.fused_encoder_layer_train_reference(x, mask, layer, masks=masks, **kw)

    with mock.patch.multiple(
        encoder_mod,
        multi_head_attention=attention,
        fused_encoder_layer=fused_layer.fused_encoder_layer_reference,
        fused_encoder_layer_train=train_layer,
        masked_mean_pool_l2norm=masked_mean_pool_l2norm_reference,
    ):
        yield


def measure_attention(q, k, v, mask, do, scale, iters: int, plain_iters: int = 2):
    """K6 and K7 at these inputs against their plain versions, timed with
    CUDA events beside one scaled_dot_product_attention call with the same
    key bias and its autograd backward (the yardsticks; the port never calls
    them). Returns the two kernels-line rows, without launches."""
    from torch.nn.functional import scaled_dot_product_attention

    from instacart_next_order_recommendation_tpu_torch.ops import (
        multi_head_attention,
        multi_head_attention_backward,
        multi_head_attention_backward_reference,
        multi_head_attention_reference,
    )

    b, h, s, d = q.shape
    with torch.no_grad():
        out = multi_head_attention(q, k, v, mask, scale)
        ref = multi_head_attention_reference(q, k, v, mask, scale)
        grads = multi_head_attention_backward(q, k, v, mask, do, scale)
        refs = multi_head_attention_backward_reference(q, k, v, mask, do, scale)
        bias = ((1.0 - mask.float()) * -1e9).to(q.dtype)[:, None, None, :]
        bwd_rel = {n: rel_err(a, r) for n, a, r in zip(("dq", "dk", "dv"), grads, refs)}
        finite = all(bool(torch.isfinite(t.float()).all()) for t in (out, *grads))
        fwd = dict(
            ms=cuda_ms_median(lambda: multi_head_attention(q, k, v, mask, scale), iters),
            plain_ms=cuda_ms(
                lambda: multi_head_attention_reference(q, k, v, mask, scale), plain_iters, 1
            ),
            library_ms=cuda_ms_median(
                lambda: scaled_dot_product_attention(q, k, v, attn_mask=bias, scale=scale), iters
            ),
            max_abs_err=(out.float() - ref.float()).abs().max().item(),
            max_rel_err=rel_err(out, ref),
            finite=finite,
        )
        bwd = dict(
            ms=cuda_ms_median(
                lambda: multi_head_attention_backward(q, k, v, mask, do, scale), iters
            ),
            plain_ms=cuda_ms(
                lambda: multi_head_attention_backward_reference(q, k, v, mask, do, scale),
                plain_iters, 1,
            ),
            max_abs_err=max((a.float() - r.float()).abs().max().item() for a, r in zip(grads, refs)),
            max_rel_err=max(bwd_rel.values()),
            worst=max(bwd_rel, key=bwd_rel.get),
            finite=finite,
        )
    with torch.enable_grad():
        qr, kr, vr = (t.detach().requires_grad_(True) for t in (q, k, v))
        y = scaled_dot_product_attention(qr, kr, vr, attn_mask=bias, scale=scale)
        bwd["library_ms"] = cuda_ms_median(
            lambda: torch.autograd.grad(y, (qr, kr, vr), do, retain_graph=True), iters
        )
        del y
    fwd["bound_ms"], fwd["bound_by"] = attention_bound(b, h, s, d, backward=False)
    bwd["bound_ms"], bwd["bound_by"] = attention_bound(b, h, s, d, backward=True)
    return fwd, bwd


def attention_rows_ok(fwd: dict, bwd: dict) -> bool:
    return (
        fwd["finite"] and fwd["max_rel_err"] <= ATTN_REL_TOL and bwd["max_rel_err"] <= ATTN_REL_TOL
    )


def kernel_row(row: dict) -> dict:
    """The kernels-line keys of a measured row."""
    keys = ("ms", "plain_ms", "library_ms", "max_abs_err", "bound_ms", "bound_by", "launches")
    return {key: row[key] for key in keys}


def layer_qkv(x: torch.Tensor, layer: dict, heads: int):
    """q, k, v of one unfused layer's attention, as ``_encoder_layer`` makes
    them (views of its [B, S, 3, heads, head_dim] projection)."""
    b, s, h = x.shape
    qkv = (torch.matmul(x, layer["qkv_w"]) + layer["qkv_b"]).view(b, s, 3, heads, h // heads)
    return [t.permute(0, 2, 1, 3) for t in qkv.unbind(2)]


def agreement(q_kern, q_plain, cat_kern, cat_plain, i_kern, k: int) -> dict:
    """Top-k ids from the kernels against the plain versions' ranking: the
    share identical, and the share identical or a near-tie. A swap of ids a
    (kernels) and b (plain) at one rank is a near-tie when their plain scores
    differ by less than the embedding differences can move both scores: for
    unit vectors, |q.c - q'.c'| <= ||q - q'|| + ||c - c'||."""
    from instacart_next_order_recommendation_tpu_torch.ops.topk import cosine_topk_reference

    s_plain, i_plain = cosine_topk_reference(q_plain, cat_plain, k)
    q_delta = (q_plain - q_kern).norm(dim=1)[:, None]
    c_delta = (cat_plain - cat_kern).norm(dim=1)
    tol = 2 * q_delta + c_delta[i_kern.long()] + c_delta[i_plain.long()]
    plain_of_kern = (q_plain @ cat_plain.T).gather(1, i_kern.long())
    near_tie = plain_of_kern >= s_plain - tol
    return {
        "identical": float((i_kern == i_plain).float().mean()),
        "identical_or_near_tie": float(((i_kern == i_plain) | near_tie).float().mean()),
        "spread": (s_plain[:, 0] - s_plain[:, -1]).median().item(),
        "median_tol": tol.median().item(),
        "i_plain": i_plain,
    }


def time_serving(rec, queries: list[str]) -> dict:
    """Single-query latencies (``recommend``, top-10) over the queries past
    the batch, then the batch of the first BATCH through
    ``FusedServePipeline.topk`` at top-16: one warm-up and five timed calls."""
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
        scores, idx = rec._fused.topk(ids, tmask, K_BATCH)
        batch_ms.append((time.perf_counter() - t0) * 1e3)
    lat = np.asarray(latencies)
    median = float(np.median(batch_ms))
    return {
        "ids": ids, "scores": scores, "idx": idx,
        "stats": {
            "batch": BATCH,
            "batch_seq": int(ids.shape[1]),
            "batch_k": K_BATCH,
            "batch_tokenize_ms": tokenize_ms,
            "batch_ms_median": median,
            "batch_queries_per_s": BATCH / (median / 1e3),
            "single_query_p50_ms": float(np.percentile(lat, 50)),
            "single_query_p95_ms": float(np.percentile(lat, 95)),
            "single_queries": len(lat),
        },
    }


def plain_encoder(encoder, dev, config, layers):
    """Token ids -> embeddings through ``encode`` on a TextEncoder's params,
    with every kernel replaced by its plain version, on the card."""
    from instacart_next_order_recommendation_tpu_torch.models.encoder import encode

    def run(ids_np: np.ndarray) -> torch.Tensor:
        ids_t = torch.from_numpy(ids_np).to(dev)
        m = (ids_t != encoder.tokenizer.pad_id).to(torch.int32)
        with plain_kernels():
            return encode(encoder.params, ids_t, m, config, layers=layers)

    return run


def catalog_ids(rec) -> list[np.ndarray]:
    """The catalog's token ids in batches of 512, as ``encode_resident`` pads them."""
    return [
        rec.encoder.tokenizer.encode_batch(rec.product_texts[lo : lo + 512], max_seq_length=256)[0]
        for lo in range(0, len(rec.product_texts), 512)
    ]


def packed_ties_ok(queries, catalog, i_packed, i_exact) -> bool:
    """Every rank where the packed ids differ from the exact ones holds a
    tie within the 20-bit key (exact f32 scores within PACKED_TIE_REL)."""
    scores = queries @ catalog.T
    a = scores.gather(1, i_packed.long())
    b = scores.gather(1, i_exact.long())
    return bool(((a - b).abs() <= PACKED_TIE_REL * b.abs() + 1e-6).all())


def measure_train_kernels(x, mask, layer, masks, up, library, kw, iters, plain_iters):
    """K1's mask form and K5 at x's shape against their plain versions (the
    plain backward is autograd of the plain forward), with their bounds;
    unless ``library`` is None, timed with CUDA events in turns with one
    ``library`` (nn.TransformerEncoderLayer) forward and backward (medians of
    five readings). Returns the two kernels-line rows (without launches),
    the gradient with the largest relative error, and whether every output
    is finite."""
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
    (dx, dw), (dx_r, dw_r) = k5(), plain5()
    pairs = {"dx": (dx, dx_r), **{n: (dw[n], dw_r[n]) for n in WEIGHT_NAMES}}
    rel = {n: rel_err(a, r) for n, (a, r) in pairs.items()}
    worst = max(rel, key=rel.get)
    finite = all(bool(torch.isfinite(t.float()).all()) for t in (y, dx, *dw.values()))
    bound1, by1 = k1_bound(b, s, h, inter, masks is not None)
    bound5, by5 = k5_bound(b, s, h, inter, masks is not None)
    k1_row = dict(bound_ms=bound1, bound_by=by1, **k1_error(y, plain1()))
    k5_row = dict(
        max_abs_err=max((a.float() - r.float()).abs().max().item() for a, r in pairs.values()),
        max_rel_err=rel[worst], bound_ms=bound5, bound_by=by5,
    )
    del y, dx, dw, dx_r, dw_r, pairs
    if library is not None:
        lib_fwd, lib_bwd = library_train_calls(library, x, mask == 0, up)
        ms = ms_in_turns({"k1": k1, "lib_fwd": lib_fwd, "k5": k5, "lib_bwd": lib_bwd}, iters)
        k1_row.update(
            ms=ms["k1"], plain_ms=cuda_ms(plain1, plain_iters, 1), library_ms=ms["lib_fwd"]
        )
        k5_row.update(
            ms=ms["k5"], plain_ms=cuda_ms(plain5, plain_iters, 1), library_ms=ms["lib_bwd"]
        )
    return k1_row, k5_row, worst, finite


def time_prefix(days: int | None, dow: int, hour: int) -> str:
    """An order's time tag in the data prep's context form."""
    return f"w{dow}h{hour}" if days is None else f"+{days}d w{dow}h{hour}"


def synthetic_users(rng: np.random.Generator) -> dict:
    """TRAIN_USERS synthetic Instacart users over TRAIN_PRODUCTS products
    with real-length names: ``catalog`` (product i's text; its product id is
    i + 1), ``names``, and each user's orders, oldest first, as (order id,
    days since the prior order or None, day of week, hour, basket of
    product indices). Each user prefers three aisles and reorders about 60%
    of each basket."""
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

    users = []
    order_id = 0
    for _ in range(TRAIN_USERS):
        pref = np.concatenate([by_aisle[a] for a in rng.choice(n_aisles, 3, replace=False)])
        bought: list[int] = []
        orders = []
        for o in range(int(rng.integers(4, 9))):
            order_id += 1
            days = None if o == 0 else int(rng.integers(1, 30))
            dow, hour = int(rng.integers(0, 7)), int(rng.integers(0, 24))
            n_items = int(rng.integers(3, 10))
            n_re = min(int(round(n_items * 0.6)), len(bought))
            basket = [int(p) for p in rng.choice(bought, size=n_re, replace=False)] if n_re else []
            n_new = n_items - n_re
            n_pref = min(max(1, int(round(n_new * 0.8))), len(pref)) if n_new else 0
            basket += [int(p) for p in rng.choice(pref, size=n_pref, replace=False)]
            basket += [int(p) for p in rng.choice(TRAIN_PRODUCTS, size=n_new - n_pref, replace=False)]
            basket = list(dict.fromkeys(basket))
            orders.append((order_id, days, dow, hour, basket))
            bought = list(dict.fromkeys(bought + basket))
        users.append(orders)
    return {"catalog": catalog, "names": names, "users": users}


def held_out_users(users: list) -> int:
    """How many users, the last ones, are held out for evaluation."""
    return max(1, int(len(users) * EVAL_FRAC))


def build_training_data(synthetic: dict):
    """(anchors, positives, eval_pairs, eval_queries, eval_corpus, relevant)
    in the form the data prep writes for ``configs/data_prep.yaml``
    (p5_mp20), from ``synthetic_users``: an anchor is the user's context
    before the target order (the last MAX_PRIOR_ORDERS prior orders, oldest
    first, at most MAX_PRODUCT_NAMES names, then ``Next: <time>``), a
    positive one product of that order. The numerically last EVAL_FRAC of
    target orders are held out; their queries drop the ``Next:`` clause, as
    at serve time."""
    catalog, names = synthetic["catalog"], synthetic["names"]
    targets = []  # (order id, context, basket) of each user's last order
    for orders in synthetic["users"]:
        segments, total = [], 0
        for _, days, dow, hour, basket in orders[-1 - MAX_PRIOR_ORDERS : -1]:
            take = basket[: MAX_PRODUCT_NAMES - total]
            if not take:
                break
            total += len(take)
            prefix = time_prefix(days, dow, hour)
            segments.append(f"[{prefix}] " + ", ".join(names[p] for p in take))
        last_id, days, dow, hour, basket = orders[-1]
        context = "; ".join(segments) + ". Next: " + time_prefix(days, dow, hour)
        targets.append((last_id, context, basket))

    n_eval = held_out_users(targets)
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
        self.pool_rows: dict[int, list[dict]] = {}  # K2 readings by hidden width
        self.ivf_1m: dict = {}  # phase 3e's 1M rows and one-device readings, for phase 5b
        self.launches_5b: dict[str, int] = {}  # phase 5b's launches by kernels-line name
        self.launches_6: dict[str, int] = {}  # phase 6's launches by kernels-line name

    def check(self, ok: bool, what: str) -> None:
        if not ok:
            self.failures.append(what)
            log(f"FAIL: {what}")

    # ------------------------------------------------------------ phase 2

    def compare_forward_kernels(self, dev, widths, batches, seqs, g, timed=None) -> None:
        """K1, and K2 on its output, against their plain versions at
        ``widths`` (hidden, heads, intermediate) over ``batches`` x ``seqs``,
        every batch above 1 with an all-pad row; K1 read in turns with one
        nn.TransformerEncoderLayer forward (eval) at the shapes in ``timed``
        (every shape when None). Inputs and weights are drawn from ``g``."""
        from instacart_next_order_recommendation_tpu_torch.ops import (
            fused_encoder_layer,
            masked_mean_pool_l2norm,
        )
        from instacart_next_order_recommendation_tpu_torch.ops.fused_layer import (
            fused_encoder_layer_reference,
        )
        from instacart_next_order_recommendation_tpu_torch.ops.pool_norm import (
            masked_mean_pool_l2norm_reference,
        )

        h, heads, inter = widths
        kw = dict(num_heads=heads, scale=1.0 / (h // heads) ** 0.5, eps=1e-12)
        layer = random_layer(h, inter, g, dev)
        for b in batches:
            for s in seqs:
                x = torch.randn((b, s, h), generator=g).to(dev, torch.bfloat16)
                mask = random_mask(b, s, g, dev)
                if timed is None or (b, s) in timed:
                    iters = 20 if b * s <= 16384 else 5
                    row, y = measure_k1(x, mask, layer, kw, iters)
                else:
                    y = fused_encoder_layer(x, mask, layer, **kw)
                    row = k1_error(y, fused_encoder_layer_reference(x, mask, layer, **kw))
                    row.update(zip(("bound_ms", "bound_by"), k1_bound(b, s, h, inter)))
                finite = bool(torch.isfinite(y.float()).all())
                log(
                    f"K1 fused_encoder_layer {widths} B={b} S={s}: {json.dumps(row)} "
                    f"(tol {K1_TOL}) finite={finite} launches={fused_encoder_layer.launches}"
                )
                self.check(finite and row["max_abs_err"] <= K1_TOL, f"K1 {widths} B={b} S={s}")

                p = masked_mean_pool_l2norm(y, mask)
                p_ref = masked_mean_pool_l2norm_reference(y, mask)
                err2 = (p - p_ref).abs().max().item()
                ms2 = warm_ms(lambda: masked_mean_pool_l2norm(y, mask), 20)
                plain2 = cuda_ms(lambda: masked_mean_pool_l2norm_reference(y, mask), 5)
                log(
                    f"K2 masked_mean_pool_l2norm H={h} B={b} S={s}: max_abs_err={err2:.3g} "
                    f"(tol {K2_TOL}) warm_ms={ms2:.4f} plain_ms={plain2:.4f} "
                    f"launches={masked_mean_pool_l2norm.launches}"
                )
                self.check(
                    err2 <= K2_TOL and bool(torch.isfinite(p).all()), f"K2 H={h} B={b} S={s}"
                )
                del x, y, p, p_ref
                torch.cuda.empty_cache()

    def compare_kernels(self, dev) -> None:
        """K1 and K2 at MiniLM-L6 widths over B in {1, 256, 512} and S in
        {32, 64, 128, 256}, every shape timed; then K3 and K4."""
        from instacart_next_order_recommendation_tpu_torch.ops import cosine_topk
        from instacart_next_order_recommendation_tpu_torch.ops.topk import (
            cosine_topk_packed_reference,
            cosine_topk_reference,
        )

        g = torch.Generator().manual_seed(1)
        self.compare_forward_kernels(dev, MINILM_WIDTHS, (1, 256, 512), (32, 64, 128, 256), g)

        # K3: grid-valued catalog and queries, so every score is exact in
        # f32 under any summation order; ids must then be identical.
        n, d = N_PRODUCTS, MINILM_WIDTHS[0]
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
                    # K4 on the same grid values: ids and quantized scores
                    # identical to its plain version.
                    s_p, i_p = cosine_topk(q, c, k, n_valid=n, candidate_mask=mask, packed=True)
                    s_pr, i_pr = cosine_topk_packed_reference(
                        q, c, k, n_valid=n, candidate_mask=mask
                    )
                    same4 = bool(torch.equal(i_p, i_pr)) and bool(torch.equal(s_p, s_pr))
                    log(
                        f"K4 cosine_topk packed B={b} N={n} k={k} mask={masked}: ids and scores "
                        f"identical={same4} launches={cosine_topk.packed_launches}"
                    )
                    self.check(same4, f"K4 B={b} k={k} mask={masked}")
        del c
        torch.cuda.empty_cache()

    def compare_attention_kernels(self, dev) -> None:
        """K6 and K7 against their plain versions at the shapes the unfused
        layer gives them: the mpnet-base-class serve batch, one query, the
        catalog batch and the training batch (12 heads, D=64), and the
        MiniLM route's repaired shapes (D=32 at S=512 and S=200); then the
        two other head dims the kernels take (16 and 128), which no preset
        uses. Every batch above 1 carries an all-pad row."""
        shapes = [
            ("mpnet serve", 256, 192, 64), ("mpnet one query", 1, 64, 64),
            ("mpnet catalog", 512, 32, 64), ("mpnet train", 64, 256, 64),
            ("MiniLM S=512", 64, 512, 32), ("MiniLM S=200", 64, 200, 32),
            ("head_dim 16", 64, 136, 16), ("head_dim 128", 64, 512, 128),
        ]
        g = torch.Generator().manual_seed(7)
        for name, b, s, d in shapes:
            q, k, v, do = (
                torch.randn((b, 12, s, d), generator=g).to(dev, torch.bfloat16) for _ in range(4)
            )
            mask = random_mask(b, s, g, dev)
            fwd, bwd = measure_attention(q, k, v, mask, do, d**-0.5, iters=10 if b * s <= 16384 else 3)
            log(
                f"K6/K7 {name} B={b} heads=12 S={s} D={d}: K6 rel_err={fwd['max_rel_err']:.3g} "
                f"ms={fwd['ms']:.4f} plain_ms={fwd['plain_ms']:.4f} sdpa_ms={fwd['library_ms']:.4f} "
                f"bound_ms={fwd['bound_ms']:.4g} ({fwd['bound_by']}); K7 worst rel_err "
                f"{bwd['worst']}={bwd['max_rel_err']:.3g} ms={bwd['ms']:.4f} "
                f"plain_ms={bwd['plain_ms']:.4f} sdpa_bwd_ms={bwd['library_ms']:.4f} "
                f"bound_ms={bwd['bound_ms']:.4g} ({bwd['bound_by']}) (tol {ATTN_REL_TOL})"
            )
            self.check(attention_rows_ok(fwd, bwd), f"K6/K7 {name}")
            del q, k, v, do
            torch.cuda.empty_cache()

    def time_topk(self, dev) -> None:
        """K3 at B in {1, 256} over a 50k-row catalog of unit rows at D=384
        and 768, k=16 (the serve bucket), and at B=256 D=384 for k in {10,
        100, 256} (each list size the k rule picks); K4 at B in {8, 256},
        D=384, k=16. Each held against its plain version and read by
        ``topk_reading``."""
        g = torch.Generator(device=dev).manual_seed(9)
        for d in (384, 768):
            c = torch.randn((N_PRODUCTS, d), generator=g, device=dev)
            c /= c.norm(dim=1, keepdim=True)
            cases = [(False, 1, 16), (False, BATCH, 16)]
            if d == 384:
                cases += [(False, BATCH, k) for k in (10, 100, 256)]
                cases += [(True, 8, 16), (True, BATCH, 16)]
            for packed, b, k in cases:
                q = torch.randn((b, d), generator=g, device=dev)
                q /= q.norm(dim=1, keepdim=True)
                row = topk_reading(q, c, k, packed)
                log(f"{'K4' if packed else 'K3'} timed B={b} N={N_PRODUCTS} D={d} k={k}: "
                    f"{json.dumps(row)} (two_calls_ms: torch.topk(torch.mm(q, C.T), k), "
                    f"two calls, for reference)")
                self.check(row["ok"], f"{'K4' if packed else 'K3'} B={b} D={d} k={k}")
            del c
            torch.cuda.empty_cache()

    def compare_packed_topk(self, dev) -> None:
        """K4 against K3 and against its plain version at the catalog size
        the JAX package names for the packed extraction: 1M x 384 unit rows,
        B in {8, 256}, k=10. Random scores, so K4's ids may differ from K3's
        only at ties within the 20-bit key."""
        from instacart_next_order_recommendation_tpu_torch.ops import cosine_topk
        from instacart_next_order_recommendation_tpu_torch.ops.topk import (
            cosine_topk_packed_reference,
        )

        g = torch.Generator(device=dev).manual_seed(8)
        c = torch.randn((PACKED_N, 384), generator=g, device=dev)
        c /= c.norm(dim=1, keepdim=True)
        self.packed_1m = {}
        for b in (8, 256):
            q = torch.randn((b, 384), generator=g, device=dev)
            q /= q.norm(dim=1, keepdim=True)
            _, i3 = cosine_topk(q, c, 10)
            s4, i4 = cosine_topk(q, c, 10, packed=True)
            s_pr, i_pr = cosine_topk_packed_reference(q, c, 10)
            row = {
                "ids_equal_to_exact": float((i4 == i3).float().mean()),
                "ids_equal_to_plain": float((i4 == i_pr).float().mean()),
                "max_abs_err_vs_plain": (s4 - s_pr).abs().max().item(),
                "exact_ms": cuda_ms(lambda: cosine_topk(q, c, 10), 10),
                "exact_split": topk_split(lambda: cosine_topk(q, c, 10)),
                "packed_ms": cuda_ms(lambda: cosine_topk(q, c, 10, packed=True), 10),
                "packed_split": topk_split(lambda: cosine_topk(q, c, 10, packed=True)),
                "packed_plain_ms": cuda_ms(lambda: cosine_topk_packed_reference(q, c, 10), 2, 1),
                "two_calls_ms": cuda_ms(lambda: torch.topk(torch.mm(q, c.T), 10), 10),
                "bound_ms": k3_bound(b, PACKED_N, 384, 10, False)[0],
                "f32_fma_bound_ms": k3_fma_bound(b, PACKED_N, 384, 10, False)[0],
            }
            ties = packed_ties_ok(q, c, i4, i3) and packed_ties_ok(q, c, i4, i_pr)
            self.packed_1m[b] = row
            log(f"K4 vs K3 at N={PACKED_N} D=384 B={b} k=10: {json.dumps(row)}; "
                f"every differing id a 20-bit tie: {ties} (two_calls_ms: "
                f"torch.topk(torch.mm(q, C.T), k), two calls, for reference)")
            self.check(ties, f"K4 at 1M rows, B={b}: ids differ only at quantization ties")
        del c
        torch.cuda.empty_cache()

    def compare_bf16_topk(self, dev) -> None:
        """K3 and K4 on bf16 rows against their plain version over 50k and
        1M unit rows at D=384 and 768, B in {1, 8, 256}, k in {10, 16, 100},
        with and without a candidate mask (BF16_TOPK_TOL, BF16_TIE); then
        each form timed in turns beside the f32 K3 on the same rows (upcast)
        and beside torch.topk(torch.mm(q, C.T), k) on the bf16 operands
        (timed only: its bf16 scores are not the contract), at the serve
        batch's shape (50k, B=256, k=16) and at 1M rows, B in {8, 256}, k=10."""
        from instacart_next_order_recommendation_tpu_torch.ops import cosine_topk
        from instacart_next_order_recommendation_tpu_torch.ops.topk import (
            _masked_scores,
            quantized_keys,
        )

        g = torch.Generator(device=dev).manual_seed(10)
        timed = {(N_PRODUCTS, 384, BATCH, K_BATCH), (PACKED_N, 384, 8, 10),
                 (PACKED_N, 384, BATCH, 10)}
        self.bf16_timed = []
        for n, d in itertools.product((N_PRODUCTS, PACKED_N), (384, 768)):
            c = torch.randn((n, d), generator=g, device=dev)
            c = (c / c.norm(dim=1, keepdim=True)).to(torch.bfloat16)
            mask = (torch.rand(n, generator=g, device=dev) < 0.5).int()
            worst = {"K3": 0.0, "K4": 0.0}
            for b in (1, 8, BATCH):
                q = torch.randn((b, d), generator=g, device=dev)
                q = (q / q.norm(dim=1, keepdim=True)).to(torch.bfloat16)
                for m in (None, mask):
                    scores = _masked_scores(q, c, n, m)
                    ref_s, ref_i = torch.sort(scores, dim=1, descending=True, stable=True)
                    _, ref_pi = torch.sort(quantized_keys(scores), dim=1, descending=True,
                                           stable=True)
                    for k in (10, 16, 100):
                        s3, i3 = cosine_topk(q, c, k, candidate_mask=m)
                        s4, i4 = cosine_topk(q, c, k, candidate_mask=m, packed=True)
                        err = (s3 - ref_s[:, :k]).abs().max().item()
                        ok3 = err <= BF16_TOPK_TOL and ids_near_tie(
                            scores, i3, ref_i[:, :k], 0.0, BF16_TIE)
                        ok4 = ids_near_tie(scores, i4, ref_pi[:, :k], PACKED_TIE_REL, 1e-6)
                        worst["K3"] = max(worst["K3"], err)
                        worst["K4"] = max(worst["K4"], float((i4 != ref_pi[:, :k]).float().mean()))
                        what = f"N={n} D={d} B={b} k={k} mask={m is not None}"
                        self.check(ok3, f"K3 bf16 {what}")
                        self.check(ok4, f"K4 bf16 {what}")
                    del scores, ref_s, ref_i, ref_pi
                for k in (10, 16):
                    if (n, d, b, k) in timed:
                        self.bf16_timed.append(self.time_bf16_topk(q, c, k))
            log(f"K3/K4 bf16 N={n} D={d} against the plain version: K3 max_abs_err "
                f"{worst['K3']:.3g} (tol {BF16_TOPK_TOL}), K4 ids differing (20-bit ties) at most "
                f"{worst['K4']:.4f}; launches K3 bf16 {cosine_topk.bf16_launches}, "
                f"K4 bf16 {cosine_topk.packed_bf16_launches}")
            del c, mask
            torch.cuda.empty_cache()

    def time_bf16_topk(self, q, c, k: int) -> dict:
        """K3 and K4 on bf16 rows at one shape, in turns with the f32 K3 on
        the same rows (upcast) and torch.topk(torch.mm(q, C.T), k) on the
        bf16 operands; with the bf16 bound and the f32 K3's TF32 bound."""
        from instacart_next_order_recommendation_tpu_torch.ops import cosine_topk

        b, d = q.shape
        n = c.shape[0]
        q32, c32 = q.float(), c.float()
        iters = 20 if b * n <= 8 * PACKED_N else 5
        ms = ms_in_turns({
            "k3_bf16": lambda: cosine_topk(q, c, k),
            "k4_bf16": lambda: cosine_topk(q, c, k, packed=True),
            "k3_f32": lambda: cosine_topk(q32, c32, k),
            "library_bf16": lambda: torch.topk(torch.mm(q, c.T), k),
        }, iters)
        row = {"B": b, "N": n, "D": d, "k": k, **ms,
               "bound_ms": k3_bf16_bound(b, n, d, k, False)[0],
               "bound_by": k3_bf16_bound(b, n, d, k, False)[1],
               "f32_bound_ms": k3_bound(b, n, d, k, False)[0]}
        log(f"K3/K4 bf16 timed (ms in turns; library_bf16: torch.topk(torch.mm(q, C.T), k) on "
            f"the bf16 operands, timed only): {json.dumps(row)}")
        del q32, c32
        return row

    # ----------------------------------------------------------- phase 2b

    def compare_train_kernels(
        self, dev, widths, batches, seqs, seed: int, timed=None, traced=()
    ) -> None:
        """K1 with dropout masks and K5 against their plain versions at
        ``widths`` (hidden, heads, intermediate) over ``batches`` x ``seqs``,
        every batch above 1 with an all-pad row. At the shapes in ``timed``
        (every shape when None) both are read in turns with their yardstick,
        one nn.TransformerEncoderLayer (dropout 0.1, train mode) forward and
        backward at the same shape, which the port never calls; at the shapes
        in ``traced`` the three are traced launch by launch."""
        from instacart_next_order_recommendation_tpu_torch.ops import (
            fused_encoder_layer_backward,
            fused_encoder_layer_train,
        )
        from instacart_next_order_recommendation_tpu_torch.ops.fused_layer import (
            draw_dropout_masks,
        )

        h, heads, inter = widths
        kw = dict(num_heads=heads, scale=1.0 / (h // heads) ** 0.5, eps=1e-12)
        g = torch.Generator().manual_seed(seed)
        layer = random_layer(h, inter, g, dev)
        library = torch.nn.TransformerEncoderLayer(
            d_model=h, nhead=heads, dim_feedforward=inter, dropout=0.1, activation="gelu",
            batch_first=True, norm_first=False,
        ).to(dev, torch.bfloat16).train()
        gen = torch.Generator(device=dev)
        for b in batches:
            for s in seqs:
                x = torch.randn((b, s, h), generator=g).to(dev, torch.bfloat16)
                up = torch.randn((b, s, h), generator=g).to(dev, torch.bfloat16)
                mask = random_mask(b, s, g, dev)
                gen.manual_seed(1000 * b + s)
                masks = draw_dropout_masks((b, s, h), 0.1, gen, dev, torch.bfloat16)
                iters = 10 if b * s <= 16384 else 3
                k1, k5, worst, finite = measure_train_kernels(
                    x, mask, layer, masks, up,
                    library if timed is None or (b, s) in timed else None, kw, iters, 1,
                )
                log(
                    f"K1-train {widths} B={b} S={s}: {json.dumps(k1)} (tol {K1_TOL}); "
                    f"K5: worst rel_err {worst}={k5['max_rel_err']:.3g} (tol {K5_REL_TOL}) "
                    f"{json.dumps(k5)}; finite={finite}; launches "
                    f"K1-train={fused_encoder_layer_train.launches} "
                    f"K5={fused_encoder_layer_backward.launches}"
                )
                self.check(
                    finite and k1["max_abs_err"] <= K1_TOL, f"K1-train {widths} B={b} S={s}"
                )
                self.check(
                    finite and k5["max_rel_err"] <= K5_REL_TOL, f"K5 {widths} B={b} S={s}"
                )
                if (b, s) in traced:
                    bias = ((1.0 - mask.float()) * -1e9).contiguous()
                    show_breakdown(
                        f"K1-train launches at {widths} B={b} S={s}",
                        lambda: fused_encoder_layer_train(
                            x, mask, layer, masks=masks, dropout_rate=0.1, **kw
                        ),
                    )
                    show_breakdown(
                        f"K5 launches at {widths} B={b} S={s}",
                        lambda: fused_encoder_layer_backward(x, bias, up, masks, layer, **kw),
                    )
                    show_breakdown(
                        f"K5's yardstick (layer autograd bwd) launches at {widths} B={b} S={s}",
                        library_train_calls(library, x, mask == 0, up)[1],
                    )
                del x, up, mask, masks
                torch.cuda.empty_cache()
        del library
        torch.cuda.empty_cache()

    def time_pool(self, dev, h: int, shapes, seed: int) -> list[dict]:
        """K2 (``pool_reading``) at width ``h`` and the (B, S) pairs in
        ``shapes``: random bf16 hidden states from a seeded generator, every
        batch above 1 with an all-pad row."""
        g = torch.Generator().manual_seed(seed)
        rows = []
        for b, s in shapes:
            y = torch.randn((b, s, h), generator=g).to(dev, torch.bfloat16)
            m = random_mask(b, s, g, dev)
            row = pool_reading(y, m)
            log(f"K2 masked_mean_pool_l2norm at B={b} S={s} H={h}: {json.dumps(row)}")
            self.check(pool_ok(row), f"K2 at B={b} S={s} H={h}")
            rows.append(row)
        return rows

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
        timed = time_serving(rec, queries)
        counts = {w.__name__: w.launches for w in wrappers}
        dense_calls = cosine_topk.dense_calls
        # ---- end of the main path

        n_forwards = counts["masked_mean_pool_l2norm"]
        log(
            f"main-path launches: {counts} ({n_forwards} tower forwards); dense top-k "
            f"route calls: {dense_calls}"
        )
        self.check(dense_calls == 1, "top_k + |excluded| > 256 took the dense route once")
        # The dense route is the plain version by design (the JAX package has
        # no kernel for k > block either), so it is held against a ranking
        # of its own: float64 scores of the same embeddings on the host, a
        # stable sort, the same exclusion. An id may differ only where the
        # two f64 scores lie within twice the f32 rounding of a D-term dot
        # product of unit vectors (D * 2^-24 each).
        q4 = rec.encoder.encode_device([queries[3]])
        s64 = rec.index.catalog.double().cpu().numpy() @ q4.double().cpu().numpy()[0]
        rows64 = [
            int(j) for j in np.argsort(-s64, kind="stable")
            if rec.product_ids[int(j)] not in big_excluded
        ][:250]
        row_of = {pid: i for i, pid in enumerate(rec.product_ids)}
        rows4 = [row_of[p] for p, _ in r4]
        f32_err = rec.index.catalog.shape[1] * 2.0**-24
        swaps = [(a, b) for a, b in zip(rows4, rows64) if a != b]
        score_err = max(abs(sc - s64[row_of[p]]) for p, sc in r4)
        self.check(
            len(r4) == 250 and not big_excluded & {p for p, _ in r4}
            and all(abs(s64[a] - s64[b]) <= 2 * f32_err for a, b in swaps)
            and score_err <= f32_err,
            "top-250 with 10 excluded matches a float64 ranking on the host",
        )
        log(
            f"recommend top_k=250 excluding {len(big_excluded)}: {len(r4)} ids; against a "
            f"float64 host ranking {len(swaps)} swapped near-ties, max score error "
            f"{score_err:.3g} (tol {f32_err:.3g})"
        )
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
        ids, b_idx = timed["ids"], timed["idx"]
        self.check(bool(np.isfinite(timed["scores"]).all()), "batch scores finite")

        # ---- the same batch through the plain versions on the card
        with torch.inference_mode():
            pad_id = rec.encoder.tokenizer.pad_id
            kw = dict(
                num_heads=config.num_heads, scale=1.0 / config.head_dim**0.5,
                eps=config.layer_norm_eps,
            )
            config_f32 = dataclasses.replace(config, compute_dtype="float32")
            plain_encode = plain_encoder(rec.encoder, dev, config, rec.encoder.layers)
            plain_f32 = plain_encoder(
                rec.encoder, dev, config_f32, prepare_layers(rec.encoder.params, config_f32)
            )
            t0 = time.perf_counter()
            cat_ids = catalog_ids(rec)
            catalog_tokenize_s = time.perf_counter() - t0
            catalog_plain = torch.cat([plain_encode(c) for c in cat_ids])
            q_plain = plain_encode(ids)
            i_kern = torch.from_numpy(b_idx).to(dev)
            cat_err = (catalog_plain - rec.index.catalog).abs().max().item()
            q_kern = rec.encoder.encode_device(queries[:BATCH])
            q_err = (q_plain - q_kern).abs().max().item()
            agreed = agreement(q_kern, q_plain, rec.index.catalog, catalog_plain, i_kern, K_BATCH)
            agree, explained = agreed["identical"], agreed["identical_or_near_tie"]
            i_plain = agreed["i_plain"]
            log(
                f"plain versions on the card: catalog max_abs_err={cat_err:.4g}, batch "
                f"query max_abs_err={q_err:.4g}, median top-1 - top-{K_BATCH} plain score "
                f"spread={agreed['spread']:.4g}, median swap tolerance="
                f"{agreed['median_tol']:.4g}; batch top-{K_BATCH} ids identical={agree:.4f}, "
                f"identical or a near-tie={explained:.4f} (need >= 0.95), "
                f"{time.perf_counter() - t0:.1f}s"
            )
            self.check(cat_err <= 5e-3 and q_err <= 5e-3, "embeddings match the plain versions")
            self.check(explained >= 0.95, "batch top-16 agreement with the plain versions")

            # How much of the disagreement is bf16 itself: both bf16 paths
            # against the plain version in f32.
            catalog_f32 = torch.cat([plain_f32(c) for c in cat_ids])
            _, i_f32 = cosine_topk_reference(plain_f32(ids), catalog_f32, K_BATCH)
            kern_vs_f32 = float((i_kern == i_f32).float().mean())
            plain_vs_f32 = float((i_plain == i_f32).float().mean())
            log(
                f"top-{K_BATCH} ids identical to the f32 plain path: kernels (bf16) "
                f"{kern_vs_f32:.4f}, plain versions (bf16) {plain_vs_f32:.4f}"
            )

        serve = {
            "products": N_PRODUCTS,
            "vocab": tok.vocab_size,
            "recommender_construct_s": construct_s,
            "catalog_encode_s": encode_s,
            "catalog_encode_products_per_s": N_PRODUCTS / encode_s,
            **timed["stats"],
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
            row, y = measure_k1(x, m, layer, kw)
            self.kernel_rows["fused_encoder_layer"] = row
            show_breakdown(
                f"K1 launches at the serve batch's shape B={b} S={s}",
                lambda: fused_encoder_layer(x, m, layer, **kw),
            )
            self.check(row["max_abs_err"] <= K1_TOL, "K1 at the batch shape")
            k2 = pool_reading(y, m)
            log(f"K2 masked_mean_pool_l2norm at the serve batch's shape B={b} S={s} H={h}: "
                f"{json.dumps(k2)}")
            self.check(pool_ok(k2), "K2 at the batch shape")
            self.kernel_rows["masked_mean_pool_l2norm"] = {key: k2[key] for key in K2_ROW_KEYS}
            # K2 at the main path's other shapes: one recommend, a catalog
            # batch (their most common lengths in this run) and a train step.
            s_single = most_common(
                rec.encoder.tokenizer.encode_batch([q], max_seq_length=256)[0].shape[1]
                for q in queries[BATCH:]
            )
            pool_shapes = [(1, s_single), (512, most_common(c.shape[1] for c in cat_ids)),
                           (64, 256)]
            self.pool_rows[h] = [k2, *self.time_pool(dev, h, pool_shapes, seed=21)]
            p = masked_mean_pool_l2norm(y, m)
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
                library_ms=cuda_ms(lambda: torch.topk(torch.mm(p, cat.T), K_BATCH), 20),
                max_abs_err=e3, bound_ms=bnd, bound_by=by,
            )
            self.check(e3 <= 1e-5, "K3 scores at the batch shape")
            log(
                f"kernels line measured at the batch's shapes: B={b} S={s} H={h} I={inter}, "
                f"catalog N={N_PRODUCTS}, k={K_BATCH}; K3's bound on TF32 tensor cores "
                f"{bnd:.4g} ms ({by}), on f32 FMA "
                f"{k3_fma_bound(b, N_PRODUCTS, h, K_BATCH, False)[0]:.4g}"
            )
        for name, row in self.kernel_rows.items():
            row["launches"] = counts[name]
        self.serve_state = dict(
            model_dir=model_dir, corpus_path=corpus_path, queries=queries, tok=tok,
            batch_ids=ids, batch_idx=b_idx, catalog=rec.index.catalog, catalog_texts=catalog,
            pool_shapes=pool_shapes,
        )
        return serve

    def serve_mpnet(self, dev, workdir: Path) -> dict:
        """The mpnet-base-class tower at full width (random weights from a
        seeded generator, the serve phase's vocab) served by Recommender over
        the same 50k products: head_dim 64 at S <= 256 takes the fused
        route, so K1 runs 12 times per forward and K6 never."""
        from instacart_next_order_recommendation_tpu_torch.models.checkpoint import save_tower
        from instacart_next_order_recommendation_tpu_torch.models.encoder import (
            MPNET_BASE_CLASS,
            embed,
            init_params,
        )
        from instacart_next_order_recommendation_tpu_torch.ops import (
            cosine_topk,
            fused_encoder_layer,
            masked_mean_pool_l2norm,
            multi_head_attention,
        )
        from instacart_next_order_recommendation_tpu_torch.ops.topk import (
            cosine_topk_reference,
        )
        from instacart_next_order_recommendation_tpu_torch.serve.recommender import Recommender

        st = self.serve_state
        queries, tok = st["queries"], st["tok"]
        config = MPNET_BASE_CLASS
        if tok.vocab_size > config.vocab_size:
            raise ValueError(f"vocab {tok.vocab_size} exceeds the preset's {config.vocab_size}")
        t0 = time.perf_counter()
        params = init_params(config, torch.Generator().manual_seed(0))
        model_dir = workdir / "mpnet"
        save_tower(model_dir, params, config, tok)
        st["mpnet_dir"] = model_dir
        del params
        log(
            f"setup: mpnet-base-class {config.num_layers}x{config.hidden_size} "
            f"h{config.num_heads} (head_dim {config.head_dim}) i{config.intermediate_size} "
            f"vocab {config.vocab_size}, {time.perf_counter() - t0:.1f}s"
        )

        # ---- the main path, counted from zero
        wrappers = (multi_head_attention, fused_encoder_layer, masked_mean_pool_l2norm, cosine_topk)
        for w in wrappers:
            w.launches = 0
        t0 = time.perf_counter()
        rec = Recommender(model_dir, st["corpus_path"], use_index=False)
        torch.cuda.synchronize()
        construct_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        rec.encoder.encode_resident(rec.product_texts, batch_size=512)
        torch.cuda.synchronize()
        encode_s = time.perf_counter() - t0
        r1 = rec.recommend(queries[0], top_k=10)
        timed = time_serving(rec, queries)
        counts = {w.__name__: w.launches for w in wrappers}
        # ---- end of the main path

        n_forwards = counts["masked_mean_pool_l2norm"]
        log(f"mpnet main-path launches: {counts} ({n_forwards} tower forwards)")
        self.check(
            counts["fused_encoder_layer"] == config.num_layers * n_forwards
            and counts["multi_head_attention"] == 0 and n_forwards > 0 and counts["cosine_topk"] > 0,
            "mpnet serve: 12 K1 launches per forward, no K6",
        )
        ids, b_idx = timed["ids"], timed["idx"]
        self.check(len(r1) == 10 and bool(np.isfinite(timed["scores"]).all()), "mpnet recommend")

        # ---- the same batch through the plain versions on the card
        with torch.no_grad():
            plain_encode = plain_encoder(rec.encoder, dev, config, rec.encoder.layers)
            catalog_plain = torch.cat([plain_encode(c) for c in catalog_ids(rec)])
            q_plain = plain_encode(ids)
        q_kern = rec.encoder.encode_device(queries[:BATCH])
        cat_err = (catalog_plain - rec.index.catalog).abs().max().item()
        q_err = (q_plain - q_kern).abs().max().item()
        agreed = agreement(
            q_kern, q_plain, rec.index.catalog, catalog_plain, torch.from_numpy(b_idx).to(dev),
            K_BATCH,
        )
        log(
            f"mpnet plain versions on the card: catalog max_abs_err={cat_err:.4g}, batch query "
            f"max_abs_err={q_err:.4g}; batch top-{K_BATCH} ids identical="
            f"{agreed['identical']:.4f}, identical or a near-tie="
            f"{agreed['identical_or_near_tie']:.4f} (need >= 0.95)"
        )
        self.check(cat_err <= 5e-3 and q_err <= 5e-3, "mpnet embeddings match the plain versions")
        self.check(agreed["identical_or_near_tie"] >= 0.95, "mpnet top-16 agreement with plain")
        del catalog_plain

        # ---- K1 at head_dim 64 (and K2, K3 at D=768) at the batch's shapes
        with torch.no_grad():
            ids_t = torch.from_numpy(ids).to(dev)
            m = (ids_t != rec.encoder.tokenizer.pad_id).to(torch.int32)
            x = embed(rec.encoder.params, ids_t, config)
            kw = dict(
                num_heads=config.num_heads, scale=1.0 / config.head_dim**0.5,
                eps=config.layer_norm_eps,
            )
            row, y = measure_k1(x, m, rec.encoder.layers[0], kw)
        self.check(row["max_abs_err"] <= K1_TOL, "K1 at the mpnet batch shape")
        self.kernel_rows["fused_encoder_layer_hd64"] = {
            **row, "launches": counts["fused_encoder_layer"]
        }
        b, s, h = x.shape
        with torch.no_grad():
            p = masked_mean_pool_l2norm(y, m)
            k2 = pool_reading(y, m)
            self.pool_rows[h] = [
                k2, *self.time_pool(dev, h, self.serve_state["pool_shapes"], seed=22)
            ]
            cat = rec.index.catalog
            s_k, i_k = cosine_topk(p, cat, K_BATCH, n_valid=N_PRODUCTS)
            s_r, i_r = cosine_topk_reference(p, cat, K_BATCH, n_valid=N_PRODUCTS)
            k3 = dict(
                ms=cuda_ms(lambda: cosine_topk(p, cat, K_BATCH, n_valid=N_PRODUCTS), 20),
                plain_ms=cuda_ms(lambda: cosine_topk_reference(p, cat, K_BATCH, n_valid=N_PRODUCTS), 10),
                max_abs_err=(s_k - s_r).abs().max().item(),
                ids_identical=float((i_k == i_r).float().mean()),
                bound_ms=k3_bound(b, N_PRODUCTS, h, K_BATCH, False)[0],
            )
        log(
            f"at the mpnet batch shape B={b} S={s} H={h}: K1 "
            f"{json.dumps(self.kernel_rows['fused_encoder_layer_hd64'])}; K2 {json.dumps(k2)}; "
            f"K3 N={N_PRODUCTS} D={h} {json.dumps(k3)}"
        )
        self.check(pool_ok(k2) and k3["max_abs_err"] <= 1e-5 and k3["ids_identical"] >= 0.99,
                   "K2 and K3 at the mpnet shapes")
        out = {
            "model": "mpnet-base-class",
            "recommender_construct_s": construct_s,
            "catalog_encode_s": encode_s,
            "catalog_encode_products_per_s": N_PRODUCTS / encode_s,
            **timed["stats"],
            "top16_ids_identical_to_plain": agreed["identical"],
            "top16_identical_or_near_tie": agreed["identical_or_near_tie"],
            "launches": counts,
            "k2_at_batch": k2,
            "k3_at_batch": k3,
        }
        log("mpnet serve " + json.dumps(out))
        return out

    def repaired_shapes(self, dev) -> dict:
        """MiniLM-L6 and mpnet-base-class at two lengths their fused kernels
        do not take: a batch that buckets to S=512 under max_seq_length 512,
        and one that fills max_seq_length 200. Each takes the unfused layer
        (K6 in every layer, no K1) and must match the plain versions."""
        from instacart_next_order_recommendation_tpu_torch.models.text_encoder import TextEncoder
        from instacart_next_order_recommendation_tpu_torch.ops import (
            fused_encoder_layer,
            masked_mean_pool_l2norm,
            multi_head_attention,
        )

        st = self.serve_state
        names = [t.split("Product: ")[1].split(".")[0] for t in st["catalog_texts"][:400]]
        out = {}
        towers = [("MiniLM-L6", st["model_dir"]), ("mpnet-base-class", st["mpnet_dir"])]
        for (tower, model_dir), max_len in itertools.product(towers, (512, 200)):
            enc = TextEncoder.load(model_dir, max_seq_length=max_len)
            # Eight contexts of 10 to 160 product names: the longest runs past
            # max_len tokens and is cut to it.
            texts = [", ".join(names[i * 40 : i * 40 + n]) for i, n in
                     enumerate((160, 10, 40, 80, 20, 120, 60, 30))]
            ids, _ = enc.tokenizer.encode_batch(texts, max_seq_length=max_len)
            wrappers = (multi_head_attention, fused_encoder_layer, masked_mean_pool_l2norm)
            for w in wrappers:
                w.launches = 0
            emb = enc.encode_device(texts)
            torch.cuda.synchronize()
            counts = {w.__name__: w.launches for w in wrappers}
            with torch.no_grad():
                plain = plain_encoder(enc, dev, enc.config, enc.layers)(ids)
            err = (emb - plain).abs().max().item()
            key = f"{tower} S={max_len}"
            out[key] = {"seq": int(ids.shape[1]), "max_abs_err": err, "launches": counts}
            log(f"{tower} at max_seq_length {max_len}: {json.dumps(out[key])}")
            self.check(
                ids.shape[1] == max_len
                and counts["multi_head_attention"] == enc.config.num_layers
                and counts["fused_encoder_layer"] == 0 and err <= 5e-3
                and bool(torch.isfinite(emb).all()),
                f"{tower} at S={max_len} through K6, matching the plain versions",
            )
        return out

    def serve_packed(self, dev) -> dict:
        """Recommender(topk_extraction="packed") on the MiniLM 50k catalog: its
        batch top-16 against the exact Recommender's, ids differing only at
        20-bit ties; K4 launches and K3 does not."""
        from instacart_next_order_recommendation_tpu_torch.ops import cosine_topk
        from instacart_next_order_recommendation_tpu_torch.ops.topk import (
            cosine_topk_packed_reference,
        )
        from instacart_next_order_recommendation_tpu_torch.serve.recommender import Recommender

        st = self.serve_state
        cosine_topk.launches = cosine_topk.packed_launches = 0
        # ---- the main path, counted from zero
        rec = Recommender(st["model_dir"], st["corpus_path"], use_index=False,
                          topk_extraction="packed")
        r1 = rec.recommend(st["queries"][0], top_k=10)
        ids = st["batch_ids"]
        rec._fused.topk(ids, None, K_BATCH)  # warm-up
        batch_ms = []
        for _ in range(5):
            t0 = time.perf_counter()
            _, p_idx = rec._fused.topk(ids, None, K_BATCH)
            batch_ms.append((time.perf_counter() - t0) * 1e3)
        counts = {"cosine_topk_packed": cosine_topk.packed_launches,
                  "cosine_topk": cosine_topk.launches}
        # ---- end of the main path
        with torch.no_grad():
            q = rec.encoder.encode_device(st["queries"][:BATCH])
            i_exact = torch.from_numpy(st["batch_idx"]).to(dev)
            i_packed = torch.from_numpy(p_idx).to(dev)
            same_catalog = bool(torch.equal(rec.index.catalog, st["catalog"]))
            ties = packed_ties_ok(q, rec.index.catalog, i_packed, i_exact)
            share = float((i_packed == i_exact).float().mean())
            # K4 at this batch's shapes, for the kernels line.
            cat = rec.index.catalog
            s4, i4 = cosine_topk(q, cat, K_BATCH, n_valid=N_PRODUCTS, packed=True)
            s_r, i_r = cosine_topk_packed_reference(q, cat, K_BATCH, n_valid=N_PRODUCTS)
            b, h = q.shape
            bnd, by = k3_bound(b, N_PRODUCTS, h, K_BATCH, False)
            self.kernel_rows["cosine_topk_packed"] = dict(
                ms=cuda_ms(lambda: cosine_topk(q, cat, K_BATCH, n_valid=N_PRODUCTS, packed=True), 20),
                plain_ms=cuda_ms(
                    lambda: cosine_topk_packed_reference(q, cat, K_BATCH, n_valid=N_PRODUCTS), 10
                ),
                library_ms=cuda_ms(lambda: torch.topk(torch.mm(q, cat.T), K_BATCH), 20),
                max_abs_err=(s4 - s_r).abs().max().item(), bound_ms=bnd,
                bound_by=by, launches=counts["cosine_topk_packed"],
            )
            k4_same = float((i4 == i_r).float().mean())
        out = {
            "batch_ms_median": float(np.median(batch_ms)),
            "top16_ids_equal_to_exact_recommender": share,
            "k4_ids_equal_to_plain_at_batch": k4_same,
            "launches": counts,
            "k4_row": self.kernel_rows["cosine_topk_packed"],
            "packed_1m": self.packed_1m,
        }
        log("packed serve " + json.dumps(out))
        self.check(
            len(r1) == 10 and counts["cosine_topk_packed"] > 0 and counts["cosine_topk"] == 0,
            "the packed Recommender serves through K4 alone",
        )
        self.check(same_catalog and ties, "packed top-16 differs from exact only at 20-bit ties")
        self.check(k4_same >= 0.99, "K4 ids at the batch shape")
        return out


SERVE_WINDOW_MS = 4.0
SERVE_MAX_BATCH = 64
BATCHER_RUNS = ((1, 128), (8, 512), (64, 1024))  # (concurrency, requests)
SECOND_CORPUS = 5_000


def serve_wrappers() -> tuple:
    from instacart_next_order_recommendation_tpu_torch.ops import (
        cosine_topk,
        fused_encoder_layer,
        masked_mean_pool_l2norm,
    )

    return fused_encoder_layer, masked_mean_pool_l2norm, cosine_topk


def launch_counts() -> dict[str, int]:
    return {w.__name__: w.launches for w in serve_wrappers()}


def near_tie_ok(got: list, want: list, tol: float) -> bool:
    """One request's results against the direct recommend's, by the serve
    path's near-tie rule: the same length, and at every rank the two scores
    within ``tol`` (the same id, or two ids whose scores tie that closely)."""
    return len(got) == len(want) and all(
        abs(sa - sb) <= tol for (_, sa), (_, sb) in zip(got, want)
    )


def percentile_ms(values: list[float], q: float) -> float:
    return float(np.percentile(np.asarray(values), q))


def device_busy_us(prof) -> tuple[float, int]:
    """The device's busy time in a ``torch.profiler`` trace (the union of
    its kernel, copy and memset intervals, in us) and the number of them."""
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text())["traceEvents"]
    spans = sorted(
        (float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events
        if e.get("ph") == "X" and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
    )
    busy_us, end = 0.0, -1.0
    for a, b in spans:
        if b > end:
            busy_us += b - max(a, end)
            end = b
    return busy_us, len(spans)


class ServingTierPhase:
    """Phase 3c: the serving tier at MiniLM-L6's full width over phase 3's
    50,000-product corpus and queries, through the entry points a user calls:
    the native tokenizer held to its Python version, ``MonitoredRecommender``
    (catalog encode, single queries, stage calibration), ``warm_serve_shapes``
    over the whole serve lattice, ``MicroBatcher`` at concurrency 1, 8 and 64,
    the ``encoder=`` injection with ``model_signature``, and the serve CLI
    (``python -m instacart_next_order_recommendation_tpu_torch.serve``) as a
    subprocess."""

    def __init__(self, smoke: "Smoke", dev, workdir: Path):
        self.smoke, self.dev, self.workdir = smoke, dev, workdir
        self.st = smoke.serve_state

    def run(self) -> dict:
        from instacart_next_order_recommendation_tpu_torch.serve import MonitoredRecommender
        from instacart_next_order_recommendation_tpu_torch.serve.precompile import (
            BATCH_BUCKETS,
            K_BUCKETS,
            warm_serve_shapes,
        )
        from instacart_next_order_recommendation_tpu_torch.tokenizer import LENGTH_BUCKETS

        smoke, st = self.smoke, self.st
        queries = st["queries"]
        out: dict = {}

        # ---- the main path, counted from zero
        for w in serve_wrappers():
            w.launches = 0
        t0 = time.perf_counter()
        rec = MonitoredRecommender(st["model_dir"], st["corpus_path"], use_index=False)
        torch.cuda.synchronize()
        out["recommender_construct_s"] = time.perf_counter() - t0
        tokz = rec.encoder.tokenizer
        n_batches = -(-N_PRODUCTS // 512)
        smoke.check(
            (tokz.native_batches, tokz.python_batches) == (n_batches, 0),
            "the catalog encode tokenized through the native path, every batch",
        )
        t0 = time.perf_counter()
        rec.encoder.encode_resident(rec.product_texts, batch_size=512)
        torch.cuda.synchronize()
        encode_s = time.perf_counter() - t0
        out["catalog_encode_products_per_s"] = N_PRODUCTS / encode_s
        out["tokenizer"] = self.tokenizer_check(tokz, rec.product_texts, queries)

        fresh = MonitoredRecommender(
            st["model_dir"], st["corpus_path"], use_index=False, encoder=rec.encoder
        )
        t0 = time.perf_counter()
        fresh.recommend(queries[BATCH], top_k=10)
        out["first_request_unwarmed_ms"] = (time.perf_counter() - t0) * 1e3

        t0 = time.perf_counter()
        n_shapes = warm_serve_shapes(rec, batch_buckets=BATCH_BUCKETS)
        out["warm_s"] = time.perf_counter() - t0
        seqs = [s for s in LENGTH_BUCKETS if s <= rec.encoder.max_seq_length]
        k_effs = [min(k, N_PRODUCTS) for k in K_BUCKETS]
        lattice = (len(BATCH_BUCKETS) * len(seqs) + len(BATCH_BUCKETS) * len(k_effs) * 2
                   + len(seqs) * len(k_effs))
        out["warm_shapes"] = n_shapes
        smoke.check(n_shapes == lattice, f"warm_serve_shapes ran the {lattice}-shape lattice")
        t0 = time.perf_counter()
        rec.recommend(queries[BATCH], top_k=10)
        out["first_request_warmed_ms"] = (time.perf_counter() - t0) * 1e3

        out["monitored"] = self.monitored(rec, fresh, queries)
        out["batcher"] = self.batcher(rec, queries)
        out["signature"] = self.signature_and_injection(rec)
        counts = launch_counts()
        # ---- end of the main path
        out["launches"] = counts
        log(f"serving tier main-path launches: {counts}")
        layers = rec.encoder.config.num_layers
        smoke.check(
            all(v > 0 for v in counts.values())
            and counts["fused_encoder_layer"] == layers * counts["masked_mean_pool_l2norm"],
            f"serving tier: K1, K2 and K3 launched, {layers} K1 per forward",
        )
        out["cli"] = self.cli()
        log("serving tier " + json.dumps(out))
        return out

    def tokenizer_check(self, tokz, catalog: list[str], queries: list[str]) -> dict:
        """The native path's ids and masks against ``encode_batch_reference``
        on every catalog text and query; both timed."""
        smoke = self.smoke
        chunks = [catalog[lo : lo + 512] for lo in range(0, len(catalog), 512)]
        tokz.native_batches = tokz.python_batches = tokz.bailed_rows = 0
        t0 = time.perf_counter()
        native = [tokz.encode_batch(c, max_seq_length=256) for c in chunks]
        native_s = time.perf_counter() - t0
        catalog_route = (tokz.native_batches, tokz.python_batches)
        t0 = time.perf_counter()
        plain = [tokz.encode_batch_reference(c, max_seq_length=256) for c in chunks]
        plain_s = time.perf_counter() - t0
        same = all(np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
                   for a, b in zip(native, plain))
        tokz.native_batches = tokz.python_batches = 0
        t0 = time.perf_counter()
        ids, mask = tokz.encode_batch(queries[:BATCH], max_seq_length=256)
        batch_ms = (time.perf_counter() - t0) * 1e3
        batch_route = (tokz.native_batches, tokz.python_batches)
        t0 = time.perf_counter()
        ref = tokz.encode_batch_reference(queries[:BATCH], max_seq_length=256)
        batch_plain_ms = (time.perf_counter() - t0) * 1e3
        same = same and np.array_equal(ids, ref[0]) and np.array_equal(mask, ref[1])
        single_ms, single_plain_ms = [], []
        for q in queries:
            t0 = time.perf_counter()
            a = tokz.encode_batch([q], max_seq_length=256)
            t1 = time.perf_counter()
            b = tokz.encode_batch_reference([q], max_seq_length=256)
            single_plain_ms.append((time.perf_counter() - t1) * 1e3)
            single_ms.append((t1 - t0) * 1e3)
            same = same and np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
        out = {
            "catalog_native_products_per_s": len(catalog) / native_s,
            "catalog_python_products_per_s": len(catalog) / plain_s,
            "batch_tokenize_ms": batch_ms,
            "batch_tokenize_python_ms": batch_plain_ms,
            "single_query_tokenize_median_ms": float(np.median(single_ms)),
            "single_query_tokenize_python_median_ms": float(np.median(single_plain_ms)),
            "bailed_rows": tokz.bailed_rows,
            "catalog_batches_native_python": catalog_route,
            "serve_batch_native_python": batch_route,
        }
        log("native tokenizer " + json.dumps(out))
        smoke.check(catalog_route[0] > 0 and catalog_route[1] == 0
                    and batch_route[0] > 0 and batch_route[1] == 0,
                    "the catalog and the serve batch tokenized through the native path")
        smoke.check(same, "native token ids and masks equal encode_batch_reference's on all "
                    f"{len(catalog)} catalog texts and {len(queries)} queries")
        return out

    def monitored(self, rec, fresh, queries: list[str]) -> dict:
        """Single queries through MonitoredRecommender against
        ``Recommender.recommend`` on a second recommender over the same
        catalog; the calibrated and measured stage timings."""
        from instacart_next_order_recommendation_tpu_torch.serve import Recommender

        smoke = self.smoke
        same_catalog = bool(torch.equal(rec.index.catalog, fresh.index.catalog))
        latencies, worst, ids_equal, calibrated = [], 0.0, True, True
        for q in queries[BATCH:]:
            t0 = time.perf_counter()
            got = rec.recommend(q, top_k=10, user_id="smoke")
            latencies.append((time.perf_counter() - t0) * 1e3)
            m = rec.last_metrics
            calibrated = calibrated and (
                m is not None and m.stage_timing_source == "calibrated"
                and m.num_recommendations == 10 and m.user_id == "smoke"
                and m.query_embedding_time_ms > 0 and m.similarity_compute_time_ms > 0
            )
            want = Recommender.recommend(fresh, q, top_k=10)
            ids_equal = ids_equal and [p for p, _ in got] == [p for p, _ in want]
            worst = max([worst] + [abs(a - b) for (_, a), (_, b) in zip(got, want)])
        filtered = rec.recommend(queries[0], top_k=10, filter_aisles=["milk"])
        m = rec.last_metrics
        out = {
            "single_query_p50_ms": percentile_ms(latencies, 50),
            "single_query_p95_ms": percentile_ms(latencies, 95),
            "single_queries": len(latencies),
            "max_score_diff_vs_recommender": worst,
            "same_catalog": same_catalog,
            "calibrated_stage_ms": {str(key): v[:2] for key, v in rec._stage_cal._cache.items()},
            "filtered_stage_timing_source": m.stage_timing_source,
        }
        log("monitored recommender " + json.dumps(out))
        smoke.check(ids_equal and worst <= 1e-6,
                    "MonitoredRecommender equals Recommender.recommend (ids, scores within 1e-6)")
        smoke.check(calibrated, "last_metrics filled, calibrated on the fused route")
        smoke.check(
            m.stage_timing_source == "measured" and len(filtered) == 10
            and all("Aisle: milk." in rec.pid_to_text[p] for p, _ in filtered),
            "a filtered request is served and measured",
        )
        return out

    def batcher(self, rec, queries: list[str]) -> dict:
        """MicroBatcher at each concurrency: every request against the direct
        recommend by the near-tie rule, exclusions and filters held, and the
        launches accounted for one by one."""
        from concurrent.futures import ThreadPoolExecutor

        from instacart_next_order_recommendation_tpu_torch.serve import MicroBatcher

        smoke = self.smoke
        direct, excluded_of = {}, {}
        for q in queries:
            direct[q, False] = rec.recommend(q, top_k=10)
            excluded_of[q] = {direct[q, False][0][0], direct[q, False][1][0]}
            direct[q, True] = rec.recommend(q, top_k=10, exclude_product_ids=excluded_of[q])
        filtered_direct = {q: rec.recommend(q, top_k=10, filter_aisles=["milk"])
                           for q in queries}

        def request(i: int):
            q = queries[i % len(queries)]
            if i % 16 == 7:
                return q, "filtered", {"filter_aisles": ["milk"]}
            if i % 4 == 1:
                return q, "excluded", {"exclude_product_ids": excluded_of[q]}
            return q, "plain", {}

        before, cal_before = launch_counts(), len(rec._stage_cal._cache)
        runs, results, chunks, n_filtered = {}, [], 0, 0
        for concurrency, n in BATCHER_RUNS:
            batcher = MicroBatcher(rec, window_ms=SERVE_WINDOW_MS, max_batch=SERVE_MAX_BATCH)
            reqs = [request(i) for i in range(n)]
            k3_before = launch_counts()["cosine_topk"]

            def serve(req, batcher=batcher):
                q, _, kw = req
                return batcher.recommend(q, top_k=10, **kw)

            t0 = time.perf_counter()
            with ThreadPoolExecutor(concurrency) as ex:
                got = list(ex.map(serve, reqs, timeout=600))
            wall = time.perf_counter() - t0
            results += list(zip(reqs, got))
            chunks += sum(-(-size // SERVE_MAX_BATCH) * c for size, c in batcher.drain_sizes.items())
            n_filtered += sum(kind == "filtered" for _, kind, _ in reqs)
            runs[concurrency] = {
                "requests": n,
                "queries_per_s": n / wall,
                "k3_launches": launch_counts()["cosine_topk"] - k3_before,
                "decision_counts": dict(batcher.decision_counts),
                "drain_sizes": dict(sorted(batcher.drain_sizes.items())),
            }
            smoke.check(
                sum(size * c for size, c in batcher.drain_sizes.items())
                == sum(kind != "filtered" for _, kind, _ in reqs),
                f"MicroBatcher at concurrency {concurrency}: every unfiltered request drained, "
                "filtered ones bypassed",
            )
        after, cal_new = launch_counts(), len(rec._stage_cal._cache) - cal_before
        diff = {k: after[k] - before[k] for k in after}
        expected = chunks + n_filtered + cal_new
        log(f"MicroBatcher launches {diff}: {chunks} drains, {n_filtered} filtered requests, "
            f"{cal_new} stage calibrations")
        smoke.check(
            diff["cosine_topk"] == diff["masked_mean_pool_l2norm"] == expected
            and diff["fused_encoder_layer"] == rec.encoder.config.num_layers * expected,
            "MicroBatcher launch counts exact: one forward and one top-k per drain, "
            "filtered request and calibration",
        )
        smoke.check(runs[64]["k3_launches"] < runs[64]["requests"],
                    "MicroBatcher at concurrency 64: fewer K3 launches than requests")
        runs["64_diagnostics"] = self.batcher_diagnostics(rec, [request(i) for i in range(1024)])

        # The near-tie tolerance: how far a query's embedding inside a padded
        # batch lies from its lone embedding (largest over every query in
        # batches of 64 and of 8), twice, plus f32 rounding of a D-term dot.
        with torch.inference_mode():
            lone = torch.cat([rec.encoder.encode_device([q]) for q in queries])
            delta = 0.0
            for size in (SERVE_MAX_BATCH, 8):
                for lo in range(0, len(queries), size):
                    part = queries[lo : lo + size]
                    emb = rec.encoder.encode_device(part, pad_batch_to=size, keep_padding=True)
                    delta = max(delta, (emb[: len(part)] - lone[lo : lo + len(part)])
                                .norm(dim=1).max().item())
        tol = 2 * delta + lone.shape[1] * 2.0**-24
        ok, identical, excl_ok = True, 0, True
        for (q, kind, kw), got in results:
            want = filtered_direct[q] if kind == "filtered" else direct[q, kind == "excluded"]
            ok = ok and near_tie_ok(got, want, tol)
            identical += [p for p, _ in got] == [p for p, _ in want]
            if kind == "excluded":
                excl_ok = excl_ok and excluded_of[q].isdisjoint(p for p, _ in got)
            if kind == "filtered":
                excl_ok = excl_ok and got == want
        out = {"runs": runs, "requests": len(results), "ids_identical": identical / len(results),
               "near_tie_tol": tol, "embedding_delta": delta, "launches": diff}
        log("MicroBatcher " + json.dumps(out))
        smoke.check(ok, "every batched request matches the direct recommend or a near-tie")
        smoke.check(excl_ok, "excluded ids stay out; filtered requests equal the direct ones")
        return out

    @staticmethod
    def batcher_diagnostics(rec, reqs: list) -> dict:
        """Where concurrency 64 loses its time: the same requests once under
        ``torch.profiler`` (device only), for the share of the wall time the
        device is busy (the union of its kernel and copy intervals), and
        once with the interpreter's thread switch interval cut from 5 ms to
        0.5 ms, for how far the threads wait on the interpreter lock."""
        from concurrent.futures import ThreadPoolExecutor

        from torch.profiler import ProfilerActivity, profile

        from instacart_next_order_recommendation_tpu_torch.serve import MicroBatcher

        def run() -> float:
            batcher = MicroBatcher(rec, window_ms=SERVE_WINDOW_MS, max_batch=SERVE_MAX_BATCH)
            t0 = time.perf_counter()
            with ThreadPoolExecutor(64) as ex:
                list(ex.map(lambda r: batcher.recommend(r[0], top_k=10, **r[2]), reqs,
                            timeout=600))
            torch.cuda.synchronize()
            return time.perf_counter() - t0

        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            wall = run()
        busy_us, n_spans = device_busy_us(prof)
        interval = sys.getswitchinterval()
        sys.setswitchinterval(5e-4)
        try:
            fast_switch = run()
        finally:
            sys.setswitchinterval(interval)
        out = {
            "profiled_queries_per_s": len(reqs) / wall,
            "device_busy_ms": busy_us / 1e3,
            "device_idle_share": 1 - busy_us / 1e3 / (wall * 1e3) if n_spans else "not measured",
            "device_launches": n_spans,
            "queries_per_s_switch_0.5ms": len(reqs) / fast_switch,
        }
        log("MicroBatcher at concurrency 64, diagnostics " + json.dumps(out))
        return out

    def signature_and_injection(self, rec) -> dict:
        """``model_signature`` changes when a tower file is rewritten; a
        Recommender built on a second corpus with ``encoder=`` loads no tower."""
        import shutil

        from instacart_next_order_recommendation_tpu_torch.models.text_encoder import TextEncoder
        from instacart_next_order_recommendation_tpu_torch.serve import Recommender
        from instacart_next_order_recommendation_tpu_torch.serve.recommender import (
            model_signature,
        )

        smoke, st = self.smoke, self.st
        copy = self.workdir / "model_copy"
        shutil.copytree(st["model_dir"], copy)
        before = model_signature(copy)
        config = copy / "model_config.json"
        config.write_text(config.read_text() + "\n")
        changed = model_signature(copy) != before
        corpus2 = self.workdir / "second_corpus.json"
        texts = st["catalog_texts"][:SECOND_CORPUS]
        corpus2.write_text(json.dumps({f"s{i}": t for i, t in enumerate(texts)}))
        with mock.patch.object(TextEncoder, "load", side_effect=AssertionError("reloaded")):
            t0 = time.perf_counter()
            swapped = Recommender(st["model_dir"], corpus2, use_index=False, encoder=rec.encoder)
            swap_s = time.perf_counter() - t0
            got = swapped.recommend(st["queries"][0], top_k=10)
        out = {"signature_changed_on_rewrite": changed, "swap_s": swap_s,
               "second_corpus": SECOND_CORPUS,
               "signature_kept": swapped._model_signature == rec._model_signature}
        log("model signature " + json.dumps(out))
        smoke.check(changed, "model_signature changes when a tower file is rewritten")
        smoke.check(
            out["signature_kept"] and swapped.encoder is rec.encoder and len(got) == 10
            and all(p.startswith("s") for p, _ in got),
            "Recommender(encoder=...) on a second corpus serves with no tower reload",
        )
        return out

    def cli(self) -> dict:
        """The serve CLI in a subprocess on the card, from a YAML config; if
        this machine has no PyYAML, InferenceConfig and main's body in this
        process instead."""
        import importlib.util

        from instacart_next_order_recommendation_tpu_torch.serve import recommender as module

        smoke, st = self.smoke, self.st
        raw = {"model_dir": str(st["model_dir"]), "corpus": str(st["corpus_path"]),
               "use_index": False, "query": st["queries"][1], "top_k": 10}
        if importlib.util.find_spec("yaml") is not None:
            config = self.workdir / "inference.yaml"
            config.write_text("".join(f"{k}: {json.dumps(v)}\n" for k, v in raw.items()))
            env = {k: v for k, v in os.environ.items() if k != "INFERENCE_DEVICE"}
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, "-m", f"{PKG}.serve", "--config", str(config)],
                cwd=REPO, env=env, capture_output=True, text=True, timeout=600,
            )
            route, text, rc = "subprocess", proc.stdout, proc.returncode
            if rc != 0:
                log(proc.stderr[-3000:])
        else:
            buf = io.StringIO()
            t0 = time.perf_counter()
            with mock.patch.object(module, "load_yaml_config", lambda path, default: raw), \
                    mock.patch.object(sys, "argv", ["serve"]), contextlib.redirect_stdout(buf):
                module.main()
            route, text, rc = "in-process (no PyYAML)", buf.getvalue(), 0
        lines = [ln for ln in text.splitlines() if "product_id=" in ln]
        out = {"route": route, "exit": rc, "seconds": time.perf_counter() - t0,
               "top_lines": len(lines)}
        log("serve CLI " + json.dumps(out) + "\n" + "\n".join(text.splitlines()[-12:]))
        smoke.check(rc == 0 and "Top-10 recommendations:" in text and len(lines) == 10,
                    "the serve CLI exits 0 and prints its top-10 lines")
        return out


def top_ids(results: list) -> list[str]:
    return [pid for pid, _ in results]


def recall_at(got: np.ndarray, want: np.ndarray) -> float:
    """The mean share of each row of ``want`` that ``got``'s row holds."""
    return float(np.mean([len(set(a) & set(b)) / len(b) for a, b in zip(got, want)]))


def device_peak_bytes(fn) -> tuple[object, int]:
    """``fn()``'s result and the device memory it took at its peak, above
    what was allocated before it."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = fn()
    torch.cuda.synchronize()
    return out, torch.cuda.max_memory_allocated() - base


class IvfPhase:
    """Phase 3e: the IVF index and the bf16 catalog. ``serve_50k``: phase
    3's MiniLM-L6 tower, catalog and queries through ``Recommender(ann=True)``
    at full probe (held to phase 3's exact recommender by the near-tie rule,
    filtered too), at ``ann_nprobe=8`` (recall@10 against it), under
    ``MonitoredRecommender``, ``warm_serve_shapes`` and a ``MicroBatcher`` at
    concurrency 8, and the serve CLI as a subprocess with ``ann: true``: K1
    and K2 for the encodes, no K3. ``catalog_1m``: the IVF bench's clustered
    1M x 384 rows (``scripts/torch_bench_ivf.py``), built with nlist 1024 in
    f32 and bf16 buckets (seconds by stage, peak memory, every row in
    exactly one bucket), recall@10 at nprobe 8 and 16 against the exact
    index on the bf16 catalog (K3 on bf16 rows; K4 on them for the packed
    index, its ids held to K3's by the 20-bit tie rule), device ms at B=8
    and B=256 beside the exact scans, and the bf16 kernels' rows for the
    kernels line. Launch counts are reset before and read after each part."""

    def __init__(self, smoke: "Smoke", dev, workdir: Path, smi: str):
        self.smoke, self.dev, self.workdir, self.smi = smoke, dev, workdir, smi
        self.st = smoke.serve_state

    def run(self) -> dict:
        out = {"serve_50k": self.serve_50k(), "catalog_1m": self.catalog_1m()}
        log("IVF " + json.dumps(out))
        return out

    def serve_50k(self) -> dict:
        from concurrent.futures import ThreadPoolExecutor

        from instacart_next_order_recommendation_tpu_torch.index import IVFCatalogIndex
        from instacart_next_order_recommendation_tpu_torch.ops import cosine_topk
        from instacart_next_order_recommendation_tpu_torch.serve import (
            MicroBatcher,
            MonitoredRecommender,
            Recommender,
        )
        from instacart_next_order_recommendation_tpu_torch.serve.precompile import (
            BATCH_BUCKETS,
            K_BUCKETS,
            warm_serve_shapes,
        )
        from instacart_next_order_recommendation_tpu_torch.tokenizer import LENGTH_BUCKETS

        smoke, st = self.smoke, self.st
        queries = st["queries"][BATCH : BATCH + IVF_QUERIES]
        paths = (st["model_dir"], st["corpus_path"])
        exact = Recommender(*paths, use_index=False)
        want = {q: exact.recommend(q, top_k=10) for q in queries}
        want_milk = {q: exact.recommend(q, top_k=10, filter_aisles=["milk"]) for q in queries}
        out: dict = {}

        # ---- the main path, counted from zero
        for w in serve_wrappers():
            w.launches = 0
        cosine_topk.packed_launches = 0
        ann = dict(use_index=False, encoder=exact.encoder, ann=True, ann_nlist=IVF_NLIST_50K)
        t0 = time.perf_counter()
        full = Recommender(*paths, ann_nprobe=IVF_NLIST_50K, **ann)
        torch.cuda.synchronize()
        out["recommender_construct_s"] = time.perf_counter() - t0
        out["build_s"] = full.index.build_s
        got = {q: full.recommend(q, top_k=10) for q in queries}
        got_milk = {q: full.recommend(q, top_k=10, filter_aisles=["milk"]) for q in queries}
        part = Recommender(*paths, ann_nprobe=8, **ann)
        got8 = [top_ids(part.recommend(q, top_k=10)) for q in queries]
        mon = MonitoredRecommender(*paths, ann_nprobe=IVF_NLIST_50K, **ann)
        t0 = time.perf_counter()
        n_shapes = warm_serve_shapes(mon, batch_buckets=BATCH_BUCKETS)
        out["warm_s"] = time.perf_counter() - t0
        mon_got = {q: mon.recommend(q, top_k=10) for q in queries}
        sources = {mon.last_metrics.stage_timing_source}
        batcher = MicroBatcher(mon, window_ms=SERVE_WINDOW_MS, max_batch=SERVE_MAX_BATCH)
        reqs = [queries[i % len(queries)] for i in range(IVF_BATCHER_REQUESTS)]
        t0 = time.perf_counter()
        with ThreadPoolExecutor(8) as pool:
            batched = list(pool.map(lambda q: batcher.recommend(q, top_k=10), reqs))
        batcher_s = time.perf_counter() - t0
        counts = launch_counts()
        counts["cosine_topk_packed"] = cosine_topk.packed_launches
        # ---- end of the main path

        layers = exact.encoder.config.num_layers
        seqs = [s for s in LENGTH_BUCKETS if s <= mon.encoder.max_seq_length]
        k_effs = [min(k, N_PRODUCTS) for k in K_BUCKETS]
        lattice = len(BATCH_BUCKETS) * (len(seqs) + 2 * len(k_effs))
        out.update({
            "catalog_bitwise_phase_3": bool(torch.equal(full.product_embeddings, st["catalog"])),
            "full_probe_near_tie": all(near_tie_ok(got[q], want[q], IVF_TIE_TOL)
                                       for q in queries),
            "full_probe_ids_identical": float(np.mean(
                [top_ids(got[q]) == top_ids(want[q]) for q in queries])),
            "filtered_near_tie": all(near_tie_ok(got_milk[q], want_milk[q], IVF_TIE_TOL)
                                     for q in queries),
            "recall_at_10_nprobe_8": recall_at(got8, [top_ids(want[q]) for q in queries]),
            "warm_shapes": n_shapes,
            "monitored_near_tie": all(near_tie_ok(mon_got[q], want[q], IVF_TIE_TOL)
                                      for q in queries),
            "monitored_timing": sorted(sources),
            "batcher_requests": len(reqs),
            "batcher_queries_per_s": len(reqs) / batcher_s,
            "batcher_drains": sum(batcher.drain_sizes.values()),
            "batcher_near_tie": all(near_tie_ok(r, want[q], IVF_TIE_TOL)
                                    for r, q in zip(batched, reqs)),
            "launches": counts,
        })
        log(f"IVF serve at 50k: {json.dumps(out)}")
        smoke.check(isinstance(full.index, IVFCatalogIndex) and full._fused is None,
                    "Recommender(ann=True) serves from the IVF index")
        smoke.check(out["full_probe_near_tie"] and out["filtered_near_tie"],
                    "IVF at full probe: top-10 equal to the exact recommender by the near-tie "
                    "rule, filtered too")
        smoke.check(all(all("Aisle: milk." in full.pid_to_text[p] for p in top_ids(r))
                        for r in got_milk.values()), "IVF aisle filter holds")
        smoke.check(n_shapes == lattice, f"warm_serve_shapes on IVF ran its {lattice} index jobs")
        smoke.check(out["monitored_near_tie"] and sources == {"measured"},
                    "MonitoredRecommender(ann=True) takes the index route")
        smoke.check(out["batcher_near_tie"], "MicroBatcher on IVF: every answer the direct one's")
        smoke.check(
            counts["fused_encoder_layer"] > 0 and counts["masked_mean_pool_l2norm"] > 0
            and counts["fused_encoder_layer"] == layers * counts["masked_mean_pool_l2norm"]
            and counts["cosine_topk"] == 0 and counts["cosine_topk_packed"] == 0,
            "IVF serve: K1 and K2 for the encodes, no K3 or K4",
        )
        out["cli"] = self.cli(queries[0], top_ids(got[queries[0]]))
        del exact, full, part, mon
        torch.cuda.empty_cache()
        return out

    def cli(self, query: str, want: list[str]) -> dict:
        """The serve CLI as a subprocess on the card with ``ann: true``: its
        top-10 ids are the direct full-probe recommend's (the build and the
        search are deterministic)."""
        st = self.st
        raw = {"model_dir": str(st["model_dir"]), "corpus": str(st["corpus_path"]),
               "use_index": False, "query": query, "top_k": 10, "ann": True,
               "ann_nlist": IVF_NLIST_50K, "ann_nprobe": IVF_NLIST_50K}
        config = self.workdir / "inference_ann.yaml"
        config.write_text("".join(f"{k}: {json.dumps(v)}\n" for k, v in raw.items()))
        env = {k: v for k, v in os.environ.items() if k != "INFERENCE_DEVICE"}
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", f"{PKG}.serve", "--config", str(config)],
            cwd=REPO, env=env, capture_output=True, text=True, timeout=600,
        )
        if proc.returncode != 0:
            log(proc.stderr[-3000:])
        ids = [ln.split("product_id=")[1].split(" ")[0]
               for ln in proc.stdout.splitlines() if "product_id=" in ln]
        out = {"exit": proc.returncode, "seconds": time.perf_counter() - t0,
               "ids_equal_direct": ids == want}
        log("serve CLI with ann: true " + json.dumps(out))
        self.smoke.check(proc.returncode == 0 and ids == want,
                         "the serve CLI with ann: true exits 0 with the direct top-10")
        return out

    def catalog_1m(self) -> dict:
        from instacart_next_order_recommendation_tpu_torch.index import (
            IVFCatalogIndex,
            ShardedCatalogIndex,
        )
        from instacart_next_order_recommendation_tpu_torch.ops import cosine_topk
        from instacart_next_order_recommendation_tpu_torch.ops.topk import (
            _masked_scores,
            cosine_topk_packed_reference,
            cosine_topk_reference,
        )
        from scripts import torch_bench_ivf as bench

        smoke, dev = self.smoke, self.dev
        t0 = time.perf_counter()
        catalog, queries = bench.clustered_catalog()
        out: dict = {"rows": len(catalog), "dim": catalog.shape[1], "queries": len(queries),
                     "generate_s": time.perf_counter() - t0}
        cat = torch.from_numpy(catalog).to(dev)
        q_all = torch.from_numpy(queries).to(dev)
        del catalog
        k = bench.TOP_K

        def batched_ids(index) -> torch.Tensor:
            return torch.cat([index.topk_device(q_all[lo : lo + BATCH], k)[1]
                              for lo in range(0, len(q_all), BATCH)])

        # ---- the main path, counted from zero
        cosine_topk.launches = cosine_topk.packed_launches = 0
        cosine_topk.bf16_launches = cosine_topk.packed_bf16_launches = 0
        ivfs, builds = {}, {}
        for dtype in ("float32", "bfloat16"):
            t0 = time.perf_counter()
            ivf, peak = device_peak_bytes(lambda: IVFCatalogIndex(
                cat, nlist=IVF_1M_NLIST, kmeans_iters=IVF_KMEANS_ITERS, dtype=dtype))
            ids = ivf._bucket_ids[ivf._bucket_ids >= 0]
            builds[dtype] = {
                "seconds": time.perf_counter() - t0, "by_stage_s": ivf.build_s,
                "bucket_len": ivf.bucket_len, "peak_device_bytes": peak,
                "one_bucket_per_row": ids.numel() == len(cat)
                and torch.unique(ids).numel() == len(cat),
            }
            smoke.check(builds[dtype]["one_bucket_per_row"],
                        f"IVF at 1M ({dtype} buckets): every row in exactly one bucket")
            ivfs[dtype] = ivf
        exact = ShardedCatalogIndex(cat, dtype="bfloat16")
        packed = ShardedCatalogIndex(cat, dtype="bfloat16", extraction="packed")
        exact_ids = batched_ids(exact)
        packed_ids = batched_ids(packed)
        recalls = {}
        for dtype, ivf in ivfs.items():
            for nprobe in IVF_1M_NPROBES:
                ivf.nprobe = nprobe
                recalls[f"{dtype}_nprobe_{nprobe}"] = recall_at(
                    batched_ids(ivf).cpu().numpy(), exact_ids.cpu().numpy())
        counts = {"cosine_topk_bf16": cosine_topk.bf16_launches,
                  "cosine_topk_packed_bf16": cosine_topk.packed_bf16_launches,
                  "cosine_topk": cosine_topk.launches,
                  "cosine_topk_packed": cosine_topk.packed_launches}
        # ---- end of the main path
        ties = all(
            ids_near_tie(_masked_scores(q_all[lo : lo + BATCH], exact.catalog, None, None),
                         packed_ids[lo : lo + BATCH], exact_ids[lo : lo + BATCH],
                         PACKED_TIE_REL, 1e-6)
            for lo in range(0, len(q_all), BATCH)
        )
        out.update({"builds": builds, "recall_at_10": recalls, "launches": counts,
                    "packed_ids_equal_exact": float((packed_ids == exact_ids).float().mean())})
        smoke.check(ties, "K4 on the bf16 catalog: ids differ from K3's only at 20-bit ties")
        smoke.check(counts["cosine_topk_bf16"] > 0 and counts["cosine_topk_packed_bf16"] > 0
                    and counts["cosine_topk_bf16"] == counts["cosine_topk"],
                    "the bf16 catalog served through K3 and K4 on bf16 rows")
        smoke.check(all(0 < r <= 1 for r in recalls.values())
                    and all(recalls[f"{t}_nprobe_16"] >= recalls[f"{t}_nprobe_8"] for t in ivfs),
                    "IVF recall at 1M: more probes, no less recall")

        # Device ms at B=8 and B=256, the exact scans beside, and peak memory.
        exact_f32 = ShardedCatalogIndex(cat)
        timing = {}
        for b in (8, BATCH):
            q = q_all[:b]
            fns = {"k3_f32": lambda: exact_f32.topk_device(q, k),
                   "k3_bf16": lambda: exact.topk_device(q, k),
                   "k4_bf16": lambda: packed.topk_device(q, k)}
            for nprobe in IVF_1M_NPROBES:
                for dtype, ivf in ivfs.items():
                    fns[f"ivf_{dtype}_nprobe_{nprobe}"] = (
                        lambda ivf=ivf, nprobe=nprobe: ivf_search(ivf, nprobe, q, k))
            timing[f"B={b}"] = ms_in_turns(fns, 10 if b == 8 else 3)
        _, timing["search_peak_device_bytes"] = device_peak_bytes(
            lambda: ivf_search(ivfs["bfloat16"], max(IVF_1M_NPROBES), q_all[:BATCH], k))
        out["device_ms"] = timing
        log(f"IVF at 1M x 384 ({self.smi}): {json.dumps(out)}")
        smoke.ivf_1m = {  # on the host: phases 4 and 5 read the card's peak memory
            "catalog": cat.cpu().numpy(), "queries": q_all.cpu().numpy(), "k": k,
            "exact_ids": exact_ids.cpu().numpy(), "recall_nprobe_8": recalls["float32_nprobe_8"],
            "build_s": builds["float32"]["by_stage_s"],
        }

        # The bf16 kernels' rows for the kernels line: B=8, N=1M, k=10.
        q8 = q_all[:8].to(torch.bfloat16)
        c16 = exact.catalog
        for name, packed_form, plain in (
            ("cosine_topk_bf16", False, cosine_topk_reference),
            ("cosine_topk_packed_bf16", True, cosine_topk_packed_reference),
        ):
            s_k, _ = cosine_topk(q8, c16, k, packed=packed_form)
            s_r, _ = plain(q8, c16, k)
            bnd, by = k3_bf16_bound(8, len(cat), cat.shape[1], k, False)
            smoke.kernel_rows[name] = {
                "ms": cuda_ms(lambda: cosine_topk(q8, c16, k, packed=packed_form), 20),
                "plain_ms": cuda_ms(lambda: plain(q8, c16, k), 5),
                "library_ms": cuda_ms(lambda: torch.topk(torch.mm(q8, c16.T), k), 20),
                "max_abs_err": (s_k - s_r).abs().max().item(),
                "bound_ms": bnd, "bound_by": by, "launches": counts[name],
            }
        log(f"bf16 kernel rows at B=8 N={len(cat)} D={cat.shape[1]} k={k}: "
            f"{json.dumps({n: smoke.kernel_rows[n] for n in ('cosine_topk_bf16', 'cosine_topk_packed_bf16')})}")
        smoke.check(smoke.kernel_rows["cosine_topk_bf16"]["max_abs_err"] <= BF16_TOPK_TOL,
                    "K3 bf16 at the 1M serve shape against its plain version")
        del ivfs, exact, packed, exact_f32, cat, q_all
        torch.cuda.empty_cache()
        return out


def ivf_search(ivf, nprobe: int, q, k: int):
    """``ivf``'s top-k of ``q`` at ``nprobe`` probes."""
    ivf.nprobe = nprobe
    return ivf.topk_device(q, k)


API_MAX_CONCURRENCY = 256  # the smoke's servers: load at concurrency 64 never nears it
API_SECOND_CORPUS = 10_000
API_EVAL_USERS = 32
API_METRICS = (
    "recommendation_requests_total", "feedback_events_total", "recommendation_latency_seconds",
    "recommendation_encode_seconds", "feedback_ingest_latency_seconds", "model_loaded",
)
# The load client: a process of its own (the stdlib only), so its threads
# share no interpreter lock with the server's. Posts each body of a JSON
# list to /recommend at the given concurrency over keep-alive connections
# and prints the wall time and each (status, body, ms).
LOAD_CLIENT = r"""
import http.client, json, sys, threading, time
from concurrent.futures import ThreadPoolExecutor

port, concurrency = int(sys.argv[1]), int(sys.argv[2])
with open(sys.argv[3]) as f:
    bodies = json.load(f)
tls = threading.local()


def one(body):
    conn = getattr(tls, "conn", None)
    if conn is None:
        conn = tls.conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    t0 = time.perf_counter()
    conn.request("POST", "/recommend", body=json.dumps(body).encode(),
                 headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    data = resp.read()
    ms = (time.perf_counter() - t0) * 1e3
    if (resp.getheader("Connection") or "").lower() == "close":
        conn.close()
        tls.conn = None
    return resp.status, json.loads(data), ms


t0 = time.perf_counter()
with ThreadPoolExecutor(concurrency) as ex:
    results = list(ex.map(one, bodies))
json.dump({"wall_s": time.perf_counter() - t0, "results": results}, sys.stdout)
"""


class HttpClient:
    """Keep-alive connections to one local server over ``http.client`` (the
    stdlib: the card's machine has no HTTP client library to count on), one
    per calling thread; ``close`` closes them all (a closed one reconnects
    on its next request). A connection idle for ``IDLE_S`` is closed before
    its next request: the server reaps it after its socket timeout."""

    IDLE_S = 10.0

    def __init__(self, port: int):
        import threading

        self.port = port
        self._tls = threading.local()
        self._conns: list = []
        self._lock = threading.Lock()

    def request(self, method: str, path: str, body=None, headers=None) -> tuple[int, dict, bytes]:
        import http.client

        conn = getattr(self._tls, "conn", None)
        if conn is None:
            conn = http.client.HTTPConnection("127.0.0.1", self.port, timeout=600)
            self._tls.conn = conn
            with self._lock:
                self._conns.append(conn)
        if time.monotonic() - getattr(self._tls, "used", 0.0) > self.IDLE_S:
            conn.close()
        payload = None if body is None else json.dumps(body).encode()
        hdrs = {"Content-Type": "application/json"} if payload is not None else {}
        conn.request(method, path, body=payload, headers={**hdrs, **(headers or {})})
        resp = conn.getresponse()
        data = resp.read()
        self._tls.used = time.monotonic()
        if (resp.getheader("Connection") or "").lower() == "close":
            conn.close()
        return resp.status, dict(resp.getheaders()), data

    def post(self, path: str, body, headers=None) -> tuple[int, dict]:
        status, _, data = self.request("POST", path, body, headers)
        return status, json.loads(data)

    def close(self) -> None:
        with self._lock:
            for conn in self._conns:
                conn.close()


class ServedApp:
    """One ``create_app`` served by ``make_server`` on a free local port, in a
    thread; ``stop`` shuts the server, then the app (which flushes the
    request-context writer)."""

    def __init__(self, app):
        import threading

        from instacart_next_order_recommendation_tpu_torch.api.http import make_server

        self.app = app
        t0 = time.perf_counter()
        self.server = make_server(app, host="127.0.0.1", port=0,
                                  max_concurrency=API_MAX_CONCURRENCY)
        torch.cuda.synchronize()
        self.startup_s = time.perf_counter() - t0
        self.port = self.server.server_address[1]
        self.thread = threading.Thread(target=self.server.serve_forever, daemon=True)
        self.thread.start()
        self.client = HttpClient(self.port)

    def stop(self) -> None:
        self.client.close()
        self.server.shutdown()
        self.server.server_close()
        self.thread.join(timeout=60)
        self.app.shutdown()


def ranked(body: dict) -> list[tuple[str, float]]:
    return [(r["product_id"], r["score"]) for r in body["recommendations"]]


class HttpApiPhase:
    """Phase 3d: the HTTP API (``instacart_next_order_recommendation_tpu_torch.api``)
    on phase 3's MiniLM-L6 tower, 50,000-product corpus and queries, over
    local sockets: startup with the serve-lattice warm-up, the probes and
    every route (each answer held to a direct ``MonitoredRecommender.recommend``
    by the near-tie rule), feedback and request contexts read back from
    SQLite, the API key and the rate limit, load at concurrency 1, 8 and 64
    without and with ``BATCH_WINDOW_MS`` (launches accounted for one by
    one), the corpus hot swap on the live encoder (alone and under load),
    the model swap, the packed extraction, and the CLI
    (``python -m instacart_next_order_recommendation_tpu_torch.api``) as a
    subprocess. Launch counts are reset before and read after."""

    def __init__(self, smoke: "Smoke", dev, workdir: Path, serving: dict):
        self.smoke, self.dev, self.serving = smoke, dev, serving
        self.st = smoke.serve_state
        self.root = workdir / "api"
        # Phase 3c's near-tie tolerance: how far a query's embedding moves
        # between a lone call and a padded batch, twice, plus f32 rounding.
        self.tol = serving["batcher"]["near_tie_tol"]

    def run(self) -> dict:
        import shutil

        from instacart_next_order_recommendation_tpu_torch.ops import cosine_topk

        smoke, st, root = self.smoke, self.st, self.root
        (root / "tmp").mkdir(parents=True)
        self.corpus_path = root / "eval_corpus.json"
        shutil.copyfile(st["corpus_path"], self.corpus_path)
        queries = st["queries"]
        self.users = {str(1000 + i): q for i, q in enumerate(queries[:API_EVAL_USERS])}
        (root / "eval_queries.json").write_text(json.dumps(self.users))
        self.db = root / "feedback.db"
        env = {"FEEDBACK_DB_PATH": str(self.db), "PRECOMPILE_ON_STARTUP": "1",
               "RATE_LIMIT": "1000000/minute"}
        unset = ("INFERENCE_DEVICE", "BATCH_WINDOW_MS", "API_KEY", "ITOR_TOPK_EXTRACTION",
                 "ITOR_MONITORED_SINGLE_DISPATCH", "MODEL_DIR", "CORPUS_PATH")
        out: dict = {}
        # Uploaded corpora (and a model swap's embedding cache beside them)
        # go to the phase's own temporary directory.
        with mock.patch.dict(os.environ, env), mock.patch.object(
            tempfile, "tempdir", str(root / "tmp")
        ):
            for name in unset:
                os.environ.pop(name, None)
            # ---- the main path, counted from zero
            for w in serve_wrappers():
                w.launches = 0
            cosine_topk.packed_launches = cosine_topk.dense_calls = 0
            out.update(self.main_path())
            counts = {**launch_counts(), "cosine_topk_packed": cosine_topk.packed_launches}
            # ---- end of the main path
            out["launches"] = counts
            log(f"HTTP API main-path launches: {counts}")
            smoke.check(
                all(v > 0 for v in counts.values())
                and counts["fused_encoder_layer"]
                == self.layers * counts["masked_mean_pool_l2norm"],
                f"HTTP API: K1, K2, K3 and K4 launched, {self.layers} K1 per forward",
            )
            out["cli"] = self.cli()
        monitored, c1 = self.serving["monitored"], out["load_direct"]["runs"][1]
        out["http_vs_direct_concurrency_1_ms"] = {
            "http_p50": c1["p50_ms"], "http_p95": c1["p95_ms"],
            "direct_monitored_p50": monitored["single_query_p50_ms"],
            "direct_monitored_p95": monitored["single_query_p95_ms"],
        }
        log("HTTP API " + json.dumps(out))
        return out

    def main_path(self) -> dict:
        from instacart_next_order_recommendation_tpu_torch.api.app import create_app
        from instacart_next_order_recommendation_tpu_torch.serve import MonitoredRecommender
        from instacart_next_order_recommendation_tpu_torch.serve.precompile import K_BUCKETS
        from instacart_next_order_recommendation_tpu_torch.tokenizer import LENGTH_BUCKETS

        smoke, st = self.smoke, self.st
        out: dict = {}
        direct_app = ServedApp(create_app(st["model_dir"], self.corpus_path))
        try:
            app, rec = direct_app.app, direct_app.app.state["recommender"]
            self.layers = rec.encoder.config.num_layers
            seqs = [s for s in LENGTH_BUCKETS if s <= rec.encoder.max_seq_length]
            k_effs = [min(k, N_PRODUCTS) for k in K_BUCKETS]
            lattice = len(seqs) + 2 * len(k_effs) + len(seqs) * len(k_effs)
            out["startup"] = {"seconds": direct_app.startup_s,
                              "warmed_shapes": app.state.get("warmed_shapes")}
            log(f"HTTP API startup (CUDA, default factory, warm-up): "
                f"{json.dumps(out['startup'])}")
            smoke.check(
                isinstance(rec, MonitoredRecommender) and rec.device.type == "cuda"
                and app.state["device"].type == "cuda"
                and app.state["warmed_shapes"] == lattice,
                f"the API serves a MonitoredRecommender on CUDA, warmed over {lattice} shapes",
            )
            self.direct = self.direct_answers(rec)
            out["routes"] = self.routes(direct_app, rec)
            out["load_direct"] = self.load(direct_app, rec, batched=False)
            out["corpus_swap"] = self.corpus_swap(direct_app)
            out["model_swap"] = self.model_swap(direct_app)
        finally:
            direct_app.stop()
        with mock.patch.dict(os.environ, {"BATCH_WINDOW_MS": str(SERVE_WINDOW_MS)}):
            batched_app = ServedApp(create_app(st["model_dir"], self.corpus_path))
            try:
                batcher = batched_app.app.state["recommender"]
                out["startup_batched"] = {
                    "seconds": batched_app.startup_s,
                    "warmed_shapes": batched_app.app.state.get("warmed_shapes"),
                }
                smoke.check(
                    type(batcher).__name__ == "MicroBatcher"
                    and bool(torch.equal(batcher._rec.index.catalog, rec.index.catalog)),
                    "BATCH_WINDOW_MS serves through a MicroBatcher over the same catalog",
                )
                out["load_batched"] = self.load(batched_app, batcher._rec, batched=True)
                out["swap_under_load"] = self.swap_under_load(batched_app)
            finally:
                batched_app.stop()
        out["packed"] = self.packed()
        return out

    def direct_answers(self, rec) -> dict:
        """Each query's answers from the served recommender itself, called
        directly: plain, excluding its top two, filtered to an aisle."""
        direct = {}
        for q in self.st["queries"]:
            direct[q, "plain"] = rec.recommend(q, top_k=10)
            excluded = sorted({direct[q, "plain"][0][0], direct[q, "plain"][1][0]})
            direct[q, "excluded"] = rec.recommend(q, top_k=10, exclude_product_ids=set(excluded))
            direct[q, "filtered"] = rec.recommend(q, top_k=10, filter_aisles=["milk"])
            direct[q, "exclude_ids"] = excluded
        return direct

    def request_body(self, i: int) -> tuple[str, str, dict]:
        """Request i of a load run, as phase 3c sends them: top-10, 1 in 4
        excluding two ids, 1 in 16 filtered to an aisle."""
        q = self.st["queries"][i % len(self.st["queries"])]
        body = {"user_context": q, "top_k": 10}
        if i % 16 == 7:
            return q, "filtered", {**body, "filter_aisles": ["milk"]}
        if i % 4 == 1:
            return q, "excluded", {**body, "exclude_product_ids": self.direct[q, "exclude_ids"]}
        return q, "plain", body

    def routes(self, served: ServedApp, rec) -> dict:
        """The probes and every route over the socket."""
        import sqlite3

        from instacart_next_order_recommendation_tpu_torch.api import feedback_store
        from instacart_next_order_recommendation_tpu_torch.api.app import create_app
        from instacart_next_order_recommendation_tpu_torch.ops import cosine_topk

        smoke, c, queries, d = self.smoke, served.client, self.st["queries"], self.direct
        status_h, _, health = c.request("GET", "/health")
        status_r, _, ready = c.request("GET", "/ready")
        status_m, hdrs_m, metrics = c.request("GET", "/metrics")
        smoke.check(
            (status_h, json.loads(health), status_r, json.loads(ready), status_m)
            == (200, {"status": "ok"}, 200, {"status": "ready"}, 200)
            and hdrs_m["Content-Type"].startswith("text/plain")
            and all(f"# TYPE {name} " in metrics.decode() for name in API_METRICS)
            and "model_loaded 1.0" in metrics.decode(),
            "/health, /ready and /metrics answer, the six metric families exported",
        )
        users = list(self.users)
        big = {p for p, _ in rec.recommend(queries[5], top_k=200)}
        dense_before, cal_before = cosine_topk.dense_calls, set(rec._stage_cal._cache)
        dense_want = rec.recommend(queries[5], top_k=100, exclude_product_ids=big)
        cases = {
            "user_context": ({"user_context": queries[0], "top_k": 10}, d[queries[0], "plain"],
                             queries[0], "calibrated"),
            "user_id": ({"user_id": users[1], "top_k": 10}, d[queries[1], "plain"],
                        queries[1], "calibrated"),
            "query_and_user_id": (
                {"query": "organic milk", "user_id": users[2], "top_k": 10},
                rec.recommend(f"organic milk {queries[2]}", top_k=10), queries[2], "calibrated"),
            "exclude_product_ids": (
                {"user_context": queries[3], "top_k": 10,
                 "exclude_product_ids": d[queries[3], "exclude_ids"]},
                d[queries[3], "excluded"], queries[3], "calibrated"),
            "filter_aisles": ({"user_context": queries[4], "top_k": 10, "filter_aisles": ["milk"]},
                              d[queries[4], "filtered"], queries[4], "measured"),
            "dense_top_k": ({"user_context": queries[5], "top_k": 100,
                             "exclude_product_ids": sorted(big)},
                            dense_want, queries[5], "calibrated"),
        }
        out, request_ids = {}, []
        for name, (body, want, context, source) in cases.items():
            status, got = c.post("/recommend", body)
            ok = (
                status == 200 and near_tie_ok(ranked(got), want, self.tol)
                and got["purchase_history_used"] == context
                and got["stats"]["num_recommendations"] == len(want)
                and got["stats"]["stage_timing_source"] == source
                and all(rec.pid_to_text[r["product_id"]] == r["product_text"]
                        for r in got["recommendations"])
                and not set(body.get("exclude_product_ids", ())) & {p for p, _ in ranked(got)}
            )
            if name == "filter_aisles":
                ok = ok and all("Aisle: milk." in r["product_text"] for r in got["recommendations"])
            out[name] = {"status": status, "n": len(got.get("recommendations", ())),
                         "identical_ids": status == 200
                         and [p for p, _ in ranked(got)] == [p for p, _ in want]}
            smoke.check(ok, f"/recommend ({name}) over HTTP equals the direct recommend")
            request_ids.append(got.get("request_id"))
        # The fused route serves k = 300 through the dense top-k, and the
        # calibrator's first measurement of that bucket does once more.
        dense_cal = sum(key[2] > 256 for key in set(rec._stage_cal._cache) - cal_before)
        smoke.check(cosine_topk.dense_calls - dense_before == 2 + dense_cal,
                    "top_k + |excluded| > 256 took the dense route (direct and over HTTP)")
        status_400, _ = c.post("/recommend", {"top_k": 5})
        status_422, _ = c.post("/recommend", {"user_context": "x", "top_k": 101})
        smoke.check((status_400, status_422) == (400, 422),
                    "/recommend without a context: 400; with top_k 101: 422")

        # Feedback, single and batch, read back from SQLite; the contexts.
        click = (request_ids[0], "click", d[queries[0], "plain"][0][0])
        events = [{"request_id": request_ids[1], "event_type": t, "product_id": p}
                  for t, (p, _) in zip(("impression", "add_to_cart", "purchase"),
                                       d[queries[1], "plain"])]
        status_1, one = c.post("/feedback", dict(zip(("request_id", "event_type", "product_id"),
                                                     click)))
        status_b, batch = c.post("/feedback", {"events": events})
        status_e, _ = c.post("/feedback", {"events": []})
        feedback_store.flush_request_contexts()
        conn = sqlite3.connect(self.db)
        try:
            rows = conn.execute(
                "SELECT request_id, event_type, product_id FROM feedback_events").fetchall()
            contexts = dict(conn.execute(
                "SELECT request_id, user_context FROM request_contexts").fetchall())
        finally:
            conn.close()
        want_rows = [click] + [(e["request_id"], e["event_type"], e["product_id"])
                               for e in events]
        joined = feedback_store.load_context_events(self.db)
        smoke.check(
            (status_1, one, status_b, batch, status_e)
            == (202, {"status": "accepted", "count": 1}, 202,
                {"status": "accepted", "count": 3}, 400)
            and sorted(rows) == sorted(want_rows),
            "/feedback single and batch accepted (202) and read back from SQLite; empty: 400",
        )
        smoke.check(
            all(contexts.get(r) is not None for r in request_ids)
            and contexts[request_ids[2]] == f"organic milk {queries[2]}"
            and ("click", queries[0], click[2]) in joined,
            "request_contexts rows for every served request after flush_request_contexts; "
            "feedback joins back to its context",
        )
        out["feedback_rows"], out["context_rows"] = len(rows), len(contexts)

        with mock.patch.dict(os.environ, {"API_KEY": "smoke-key"}):
            body = {"user_context": queries[0], "top_k": 10}
            codes = (c.post("/recommend", body)[0],
                     c.post("/recommend", body, {"X-API-Key": "wrong"})[0],
                     c.post("/recommend", body, {"X-API-Key": "smoke-key"})[0],
                     c.post("/recommend", body, {"Authorization": "Bearer smoke-key"})[0],
                     c.request("GET", "/health")[0])
        smoke.check(codes == (401, 401, 200, 200, 200),
                    "API_KEY set: 401 without or with a wrong key, 200 with it; probes open")
        with mock.patch.dict(os.environ, {"RATE_LIMIT": "2/minute"}):
            limited = ServedApp(create_app(load_model_on_startup=False))
            try:
                event = {"request_id": "rl", "event_type": "click", "product_id": "1"}
                rl = [limited.client.post("/feedback", event)[0] for _ in range(3)]
                rl.append(limited.client.request("GET", "/health")[0])
            finally:
                limited.stop()
        smoke.check(rl == [202, 202, 429, 200], "RATE_LIMIT=2/minute: the third request 429")
        out["auth_codes"], out["rate_limit_codes"] = codes, rl
        log("HTTP API routes " + json.dumps(out))
        return out

    def client_run(self, port: int, concurrency: int, bodies: list[dict]) -> dict:
        """``LOAD_CLIENT`` in a process of its own."""
        path = self.root / f"bodies_{concurrency}.json"
        path.write_text(json.dumps(bodies))
        proc = subprocess.run(
            [sys.executable, "-c", LOAD_CLIENT, str(port), str(concurrency), str(path)],
            capture_output=True, text=True, timeout=600,
        )
        if proc.returncode != 0:
            raise RuntimeError(f"load client failed: {proc.stderr[-3000:]}")
        return json.loads(proc.stdout)

    def load(self, served: ServedApp, rec, batched: bool) -> dict:
        """Top-10 requests over HTTP at concurrency 1, 8 and 64 from a client
        process, each held to the direct recommend by the near-tie rule;
        every launch accounted for. Without batching each request is one
        tower forward and one top-k; with it, each drain, filtered request
        and calibration is."""
        smoke = self.smoke
        batcher = served.app.state["recommender"]
        kind = "batched" if batched else "direct"
        before, cal_before = launch_counts(), len(rec._stage_cal._cache)
        runs, checked, chunks, n_filtered = {}, [], 0, 0
        for concurrency, n in BATCHER_RUNS:
            reqs = [self.request_body(i) for i in range(n)]
            drains_before = dict(batcher.drain_sizes) if batched else {}
            got = self.client_run(served.port, concurrency, [body for _, _, body in reqs])
            ms = [r[2] for r in got["results"]]
            checked += [(q, what, status, body)
                        for (q, what, _), (status, body, _) in zip(reqs, got["results"])]
            n_filtered += sum(what == "filtered" for _, what, _ in reqs)
            run = {"requests": n, "queries_per_s": n / got["wall_s"],
                   "p50_ms": percentile_ms(ms, 50), "p95_ms": percentile_ms(ms, 95)}
            if batched:
                drains = {size: cnt - drains_before.get(size, 0)
                          for size, cnt in batcher.drain_sizes.items()
                          if cnt != drains_before.get(size, 0)}
                chunks += sum(-(-size // SERVE_MAX_BATCH) * cnt for size, cnt in drains.items())
                run["drain_sizes"] = dict(sorted(drains.items()))
            runs[concurrency] = run
        after, cal_new = launch_counts(), len(rec._stage_cal._cache) - cal_before
        diff = {k: after[k] - before[k] for k in after}
        expected = (chunks + n_filtered if batched else len(checked)) + cal_new
        ok = all(status == 200 and near_tie_ok(ranked(body), self.direct[q, what], self.tol)
                 for q, what, status, body in checked)
        identical = sum(status == 200 and [p for p, _ in ranked(body)]
                        == [p for p, _ in self.direct[q, what]]
                        for q, what, status, body in checked)
        out = {"runs": runs, "statuses": sorted({status for _, _, status, _ in checked}),
               "ids_identical": identical / len(checked), "launches": diff,
               "calibrations": cal_new, "filtered": n_filtered}
        if batched:
            out["drains"] = chunks
            out["profiled"] = self.profiled_run(served.port)
        else:
            out["without_http"] = self.without_http(served.app, rec)
        log(f"HTTP API load ({kind}) " + json.dumps(out))
        smoke.check(ok, f"every {kind} HTTP request answered 200 with the direct recommend's "
                    "ids or a near-tie")
        smoke.check(
            diff["cosine_topk"] == diff["masked_mean_pool_l2norm"] == expected
            and diff["fused_encoder_layer"] == rec.encoder.config.num_layers * expected,
            f"HTTP API launch counts exact ({kind}): one forward and one top-k per "
            + ("drain, filtered request and calibration" if batched
               else "request and calibration"),
        )
        return out

    def without_http(self, app, rec) -> dict:
        """Where the HTTP layer's time goes: the concurrency-1 requests once
        through ``App.handle`` in this process (routes and middleware, no
        sockets) and once as direct ``recommend`` calls, each serially; and
        the direct calls from 8 and 64 threads of this process."""
        from concurrent.futures import ThreadPoolExecutor

        from instacart_next_order_recommendation_tpu_torch.api.http import TestClient

        client = TestClient(app)
        reqs = [self.request_body(i) for i in range(BATCHER_RUNS[0][1])]

        def direct(req):
            _, _, body = req
            kw = {k: v for k, v in body.items() if k.startswith("filter")}
            return rec.recommend(body["user_context"], top_k=10,
                                 exclude_product_ids=set(body.get("exclude_product_ids", ())),
                                 **kw)

        def timed(fn) -> list[float]:
            ms = []
            for req in reqs:
                t0 = time.perf_counter()
                fn(req)
                ms.append((time.perf_counter() - t0) * 1e3)
            return ms

        import cProfile
        import pstats

        handle = lambda req: client.post("/recommend", json=req[2])  # noqa: E731
        profiler = cProfile.Profile()
        profiler.enable()
        handle_ms = timed(handle)
        profiler.disable()
        text = io.StringIO()
        pstats.Stats(profiler, stream=text).sort_stats("tottime").print_stats(12)
        log("App.handle at concurrency 1 under cProfile (this thread only), by own time:\n"
            + "\n".join(text.getvalue().splitlines()[6:22]))
        handle_ms = timed(handle)
        with mock.patch.dict(os.environ, {"STORE_REQUEST_CONTEXTS": "0"}):
            no_contexts_ms = timed(handle)
        direct_ms = timed(direct)
        out = {"app_handle_p50_ms": percentile_ms(handle_ms, 50),
               "app_handle_p95_ms": percentile_ms(handle_ms, 95),
               "app_handle_no_contexts_p50_ms": percentile_ms(no_contexts_ms, 50),
               "direct_p50_ms": percentile_ms(direct_ms, 50),
               "direct_p95_ms": percentile_ms(direct_ms, 95)}
        for concurrency, n in BATCHER_RUNS[1:]:
            batch = [self.request_body(i) for i in range(n)]
            t0 = time.perf_counter()
            with ThreadPoolExecutor(concurrency) as ex:
                list(ex.map(direct, batch, timeout=600))
            out[f"direct_threads_{concurrency}_queries_per_s"] = n / (time.perf_counter() - t0)
        return out

    def profiled_run(self, port: int) -> dict:
        """1,024 requests at concurrency 64 once under ``torch.profiler``
        (device only): the share of the wall time the device is idle."""
        from torch.profiler import ProfilerActivity, profile

        bodies = [self.request_body(i)[2] for i in range(1024)]
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            got = self.client_run(port, 64, bodies)
            torch.cuda.synchronize()
        busy_us, n_spans = device_busy_us(prof)
        wall_ms = got["wall_s"] * 1e3
        self.smoke.check(all(r[0] == 200 for r in got["results"]),
                         "profiled HTTP run: every request 200")
        return {"queries_per_s": 1024 / got["wall_s"], "device_busy_ms": busy_us / 1e3,
                "device_idle_share": 1 - busy_us / 1e3 / wall_ms if n_spans
                else "not measured", "device_launches": n_spans}

    def second_corpus(self, prefix: str, lo: int) -> dict[str, str]:
        texts = self.st["catalog_texts"][lo : lo + API_SECOND_CORPUS]
        return {f"{prefix}{i}": t for i, t in enumerate(texts)}

    def corpus_swap(self, served: ServedApp) -> dict:
        """POST /admin/corpus with 10,000 products: the live encoder is
        reused (``TextEncoder.load`` patched to raise), answers come from the
        new corpus only and equal a fresh recommender's on it; the swap timed
        beside that fresh load."""
        from instacart_next_order_recommendation_tpu_torch.models.text_encoder import TextEncoder
        from instacart_next_order_recommendation_tpu_torch.serve import MonitoredRecommender

        smoke, app, c, queries = self.smoke, served.app, served.client, self.st["queries"]
        live = app.state["recommender"]
        corpus = self.second_corpus("c", 20_000)
        torch.cuda.reset_peak_memory_stats()
        self.memory_before = torch.cuda.memory_allocated()
        with mock.patch.object(TextEncoder, "load", side_effect=AssertionError("reloaded")):
            t0 = time.perf_counter()
            status, body = c.post("/admin/corpus", {"corpus": corpus})
            swap_s = time.perf_counter() - t0
        swapped = app.state["recommender"]
        t0 = time.perf_counter()
        fresh = MonitoredRecommender(self.st["model_dir"], app.state["corpus_path"],
                                     use_index=False)
        torch.cuda.synchronize()
        fresh_s = time.perf_counter() - t0
        ok = True
        for q in queries[:16]:
            code, got = c.post("/recommend", {"user_context": q, "top_k": 10})
            ok = ok and code == 200 and all(p in corpus for p, _ in ranked(got)) and near_tie_ok(
                ranked(got), fresh.recommend(q, top_k=10), self.tol)
        out = {"status": status, "n_products": body.get("n_products"), "swap_s": swap_s,
               "fresh_load_s": fresh_s}
        log("HTTP API corpus swap " + json.dumps(out))
        smoke.check(
            status == 200 and body == {"status": "ok", "n_products": API_SECOND_CORPUS}
            and swapped is not live and swapped.encoder is live.encoder
            and swapped.device == live.device,
            "/admin/corpus took the fast path: the live encoder, no tower reload",
        )
        smoke.check(ok, "after the corpus swap every answer comes from the new corpus and "
                    "equals a fresh recommender's on it")
        return out

    def model_swap(self, served: ServedApp) -> dict:
        """POST /admin/model to a second tower (other seeded weights): the
        answers follow it; a missing dir is 400. Peak device memory from the
        corpus swap to here."""
        from instacart_next_order_recommendation_tpu_torch.models.checkpoint import save_tower
        from instacart_next_order_recommendation_tpu_torch.models.encoder import init_params
        from instacart_next_order_recommendation_tpu_torch.serve import MonitoredRecommender

        smoke, app, c, st = self.smoke, served.app, served.client, self.st
        live = app.state["recommender"]
        model2 = self.root / "model2"
        save_tower(model2, init_params(live.encoder.config, torch.Generator().manual_seed(1)),
                   live.encoder.config, st["tok"])
        queries = st["queries"][:16]
        before = [ranked(c.post("/recommend", {"user_context": q, "top_k": 10})[1])
                  for q in queries]
        t0 = time.perf_counter()
        status, body = c.post("/admin/model", {"model_dir": str(model2)})
        swap_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        want = MonitoredRecommender(model2, app.state["corpus_path"], use_index=False)
        after = [ranked(c.post("/recommend", {"user_context": q, "top_k": 10})[1])
                 for q in queries]
        missing, _ = c.post("/admin/model", {"model_dir": str(self.root / "no_such_model")})
        out = {"status": status, "swap_s": swap_s, "missing_dir_status": missing,
               "memory_before_swaps_mib": self.memory_before / 2**20,
               "peak_memory_around_swaps_mib": peak / 2**20}
        log("HTTP API model swap " + json.dumps(out))
        smoke.check(
            status == 200 and body["model_dir"] == str(model2)
            and app.state["recommender"].model_dir == model2.resolve(),
            "/admin/model swapped to the second tower",
        )
        smoke.check(
            all(near_tie_ok(a, want.recommend(q, top_k=10), self.tol)
                for q, a in zip(queries, after)) and after != before,
            "after the model swap the answers follow the new tower",
        )
        smoke.check(missing == 400, "/admin/model with a missing dir: 400")
        return out

    def swap_under_load(self, served: ServedApp) -> dict:
        """A corpus swap under live traffic at concurrency 8 on the batched
        app: no failed request, and each answer's ids from one corpus
        generation only."""
        import threading

        from instacart_next_order_recommendation_tpu_torch.models.text_encoder import TextEncoder

        smoke, app, c, queries = self.smoke, served.app, served.client, self.st["queries"]
        stop, errors, seen, served_n = threading.Event(), [], set(), [0]
        lock = threading.Lock()

        def requester(i: int) -> None:
            j = i
            while not stop.is_set():
                code, got = c.post("/recommend", {"user_context": queries[j % len(queries)],
                                                  "top_k": 10})
                j += 8
                gens = {p[0] for p, _ in ranked(got)} if code == 200 else set()
                with lock:
                    served_n[0] += 1
                    if code != 200 or len(gens) != 1:
                        errors.append((code, sorted(gens)))
                        return
                    seen.add(gens.pop())

        with mock.patch.object(TextEncoder, "load", side_effect=AssertionError("reloaded")):
            status_a, _ = c.post("/admin/corpus", {"corpus": self.second_corpus("a", 0)})
            live = app.state["recommender"]
            threads = [threading.Thread(target=requester, args=(i,)) for i in range(8)]
            for t in threads:
                t.start()
            time.sleep(0.5)
            t0 = time.perf_counter()
            status_b, _ = c.post("/admin/corpus", {"corpus": self.second_corpus("b", 10_000)})
            swap_s = time.perf_counter() - t0
            time.sleep(0.5)
            stop.set()
            for t in threads:
                t.join(timeout=120)
        alive = any(t.is_alive() for t in threads)
        final = ranked(c.post("/recommend", {"user_context": queries[0], "top_k": 10})[1])
        out = {"requests": served_n[0], "generations_seen": sorted(seen), "swap_s": swap_s,
               "errors": errors[:5]}
        log("HTTP API swap under load " + json.dumps(out))
        smoke.check(
            (status_a, status_b) == (200, 200) and not alive and not errors
            and seen == {"a", "b"} and {p[0] for p, _ in final} == {"b"}
            and app.state["recommender"]._rec.encoder is live._rec.encoder,
            "a corpus swap under load at concurrency 8: no failed request, every answer from "
            "one corpus generation, the new one serving after",
        )
        return out

    def packed(self) -> dict:
        """An app started with ITOR_TOPK_EXTRACTION=packed: K4 serves, and its
        ids differ from the exact app's only at 20-bit ties."""
        from instacart_next_order_recommendation_tpu_torch.api.app import create_app
        from instacart_next_order_recommendation_tpu_torch.ops import cosine_topk

        smoke, st = self.smoke, self.st
        queries = st["queries"][:8]
        with mock.patch.dict(os.environ, {"ITOR_TOPK_EXTRACTION": "packed"}):
            served = ServedApp(create_app(st["model_dir"], self.corpus_path))
        try:
            rec = served.app.state["recommender"]
            k4_before = cosine_topk.packed_launches
            got = [ranked(served.client.post("/recommend", {"user_context": q, "top_k": 10})[1])
                   for q in queries]
            k4 = cosine_topk.packed_launches - k4_before
            with torch.inference_mode():
                q_emb = rec.encoder.encode_device(queries)
                row = {p: i for i, p in enumerate(rec.product_ids)}
                i_packed = torch.tensor([[row[p] for p, _ in g] for g in got], device=self.dev)
                i_exact = torch.tensor([[row[p] for p, _ in self.direct[q, "plain"]]
                                        for q in queries], device=self.dev)
                ties = packed_ties_ok(q_emb, rec.index.catalog, i_packed, i_exact)
            share = float((i_packed == i_exact).float().mean())
        finally:
            served.stop()
        out = {"k4_launches": k4, "ids_identical": share, "startup_s": served.startup_s}
        log("HTTP API packed extraction " + json.dumps(out))
        smoke.check(rec.index.packed and k4 >= len(queries),
                    "ITOR_TOPK_EXTRACTION=packed: K4 served every request")
        smoke.check(ties, "the packed app's ids equal the exact app's or are 20-bit ties")
        return out

    def cli(self) -> dict:
        """``python -m instacart_next_order_recommendation_tpu_torch.api`` as a
        subprocess: /ready polled, one /recommend, then SIGINT; it exits 0
        and its request context is in the DB."""
        import signal
        import socket
        import sqlite3
        import urllib.error
        import urllib.request

        smoke, st = self.smoke, self.st
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        db = self.root / "cli_feedback.db"
        env = {k: v for k, v in os.environ.items()
               if k not in ("INFERENCE_DEVICE", "BATCH_WINDOW_MS", "PRECOMPILE_ON_STARTUP")}
        env.update(MODEL_DIR=str(st["model_dir"]), CORPUS_PATH=str(self.corpus_path),
                   FEEDBACK_DB_PATH=str(db))
        log_path = self.root / "cli.log"
        url = f"http://127.0.0.1:{port}"
        ready, body, rc = False, None, None
        t0 = time.perf_counter()
        with open(log_path, "w") as log_file:
            proc = subprocess.Popen(
                [sys.executable, "-m", f"{PKG}.api", "--host", "127.0.0.1", "--port", str(port)],
                cwd=REPO, env=env, stdout=log_file, stderr=subprocess.STDOUT,
            )
        try:
            while proc.poll() is None and time.perf_counter() - t0 < 300:
                try:
                    with urllib.request.urlopen(f"{url}/ready", timeout=5) as r:
                        ready = json.loads(r.read()) == {"status": "ready"}
                except (urllib.error.URLError, ConnectionError):
                    pass
                if ready:
                    break
                time.sleep(0.25)
            ready_s = time.perf_counter() - t0
            if ready:
                req = urllib.request.Request(
                    f"{url}/recommend", method="POST",
                    data=json.dumps({"user_context": st["queries"][1], "top_k": 10}).encode(),
                    headers={"Content-Type": "application/json"},
                )
                with urllib.request.urlopen(req, timeout=60) as r:
                    body = json.loads(r.read())
            proc.send_signal(signal.SIGINT)
            rc = proc.wait(timeout=60)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=30)
        context = None
        if body is not None and db.exists():
            conn = sqlite3.connect(db)
            try:
                row = conn.execute("SELECT user_context FROM request_contexts WHERE request_id = ?",
                                   (body["request_id"],)).fetchone()
            finally:
                conn.close()
            context = row[0] if row else None
        out = {"ready_s": ready_s, "exit": rc,
               "recommendations": len(body["recommendations"]) if body else 0,
               "context_stored": context == st["queries"][1]}
        text = log_path.read_text()
        log("HTTP API CLI " + json.dumps(out) + "\n" + "\n".join(text.splitlines()[-8:]))
        smoke.check(ready and rc == 0 and out["context_stored"] and out["recommendations"] == 10,
                    "the API CLI served /ready and /recommend, exited 0 on SIGINT, and its "
                    "request context is in the DB")
        return out


def training_wrappers() -> tuple:
    """Every kernel wrapper a training run may launch, on either route."""
    from instacart_next_order_recommendation_tpu_torch.ops import (
        cosine_topk,
        fused_encoder_layer,
        fused_encoder_layer_backward,
        fused_encoder_layer_train,
        masked_mean_pool_l2norm,
        multi_head_attention,
        multi_head_attention_backward,
    )

    return (
        fused_encoder_layer_train, fused_encoder_layer_backward, masked_mean_pool_l2norm,
        fused_encoder_layer, cosine_topk, multi_head_attention, multi_head_attention_backward,
    )


class TrainPhase:
    """Phase 4: MNRL training of MiniLM-L6 through TwoTowerTrainer.train(data=...)."""

    model_name = "minilm-l6"
    row_suffix = ""  # the kernels-line names of this tower's K1-train and K5 rows

    def __init__(self, smoke: "Smoke", dev, workdir: Path, data=None):
        self.smoke = smoke
        self.dev = dev
        self.workdir = workdir / self.model_name
        self.data = data if data is not None else build_training_data(
            synthetic_users(np.random.default_rng(1))
        )

    def config(self, out: str, **kw):
        from instacart_next_order_recommendation_tpu_torch.train import TrainConfig

        return TrainConfig({
            "processed_dir": str(self.workdir),
            "output_dir": str(self.workdir / out),
            "model_name": self.model_name,
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
        from instacart_next_order_recommendation_tpu_torch.ops import (
            cosine_topk,
            fused_encoder_layer,
            fused_encoder_layer_backward,
            fused_encoder_layer_train,
            fused_layer,
            masked_mean_pool_l2norm,
        )
        from instacart_next_order_recommendation_tpu_torch.serve.recommender import Recommender
        from instacart_next_order_recommendation_tpu_torch.train import TwoTowerTrainer

        smoke = self.smoke
        anchors, positives, eval_pairs, queries, corpus, relevant = self.data
        corpus_path = self.workdir / "train_corpus.json"
        ndcg_untrained = self.untrained(corpus_path)

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
        step_check = self.kernels_against_plain_steps(
            trainer.seq_len,
            {
                "weight_grads_x0.9": (
                    fused_layer, "fused_encoder_layer_backward",
                    lambda dx, dw: (dx, {n: 0.9 * g for n, g in dw.items()}),
                ),
                "dx_negated": (
                    fused_layer, "fused_encoder_layer_backward", lambda dx, dw: (-dx, dw)
                ),
            },
            fused_encoder_layer_backward, 12,
        )
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

    def untrained(self, corpus_path: Path) -> float:
        """Zero epochs export the initial params as ``untrained/final/`` (the
        same seed as the trained run); returns their NDCG@10."""
        from instacart_next_order_recommendation_tpu_torch.eval.evaluator import (
            RetrievalEvaluator,
        )
        from instacart_next_order_recommendation_tpu_torch.models.text_encoder import TextEncoder
        from instacart_next_order_recommendation_tpu_torch.train import TwoTowerTrainer

        queries, corpus, relevant = self.data[3:]
        self.workdir.mkdir(parents=True, exist_ok=True)
        corpus_path.write_text(json.dumps(corpus))
        t0 = time.perf_counter()
        untrained = TwoTowerTrainer(
            self.config("untrained", epochs=0, run_information_retrieval_evaluator=False)
        ).train(data=self.data)
        evaluator = RetrievalEvaluator(queries, corpus, relevant, batch_size=64)
        with torch.inference_mode():
            ndcg = evaluator(TextEncoder.load(untrained["final_dir"]))["ndcg_at_10"]
        log(f"untrained {self.model_name}: NDCG@10 {ndcg:.4f} ({time.perf_counter() - t0:.1f}s)")
        return ndcg

    def batches(self, tokenizer, seq: int, batch: int, n: int) -> list[list[torch.Tensor]]:
        anchors, positives = self.data[:2]
        out = []
        for k in range(n):
            idx = range(k * batch, (k + 1) * batch)
            b = []
            for texts in (anchors, positives):
                ids, mask = tokenizer.encode_batch(
                    [texts[i] for i in idx], max_seq_length=seq, pad_to=seq
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
        self.smoke.kernel_rows["fused_encoder_layer_train" + self.row_suffix] = {
            **k1, "launches": counts["fused_encoder_layer_train"]
        }
        self.smoke.kernel_rows["fused_encoder_layer_backward" + self.row_suffix] = {
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

    def kernels_against_plain_steps(self, seq: int, faults: dict, counter, per_step: int) -> dict:
        """3 AdamW steps at dropout 0 and a constant lr, from the same params
        on the same batches of length ``seq``: TrainStep through the kernels
        against TrainStep with every kernel replaced by its plain version.
        Compared: the three losses (the second and third follow the updates
        before them) and every parameter's gradient at the first step,
        relative to its largest magnitude. The kernels' run counts every
        wrapper's launches from zero (``launches`` in the result).

        Both readings are taken again with each fault in ``faults`` planted
        at run time: ``name -> (module, wrapper name, change)``, the backward
        wrapper's outputs passed through ``change``. Adam's update hardly
        depends on a gradient's scale, so the losses cannot see a scaled
        gradient; the gradients must. The limits must lie between the sound
        readings and the faults': every fault above the gradient limit, one
        above the loss limit. ``counter`` must count ``per_step`` launches
        of the backward kernel per step."""
        from instacart_next_order_recommendation_tpu_torch.train.trainer import (
            TrainStep,
            build_optimizer,
            param_leaves,
        )

        cfg, tok = self.fresh_params()[1:]
        cfg = dataclasses.replace(cfg, hidden_dropout=0.0)
        batches = self.batches(tok, seq, 64, 3)

        def run() -> tuple[list[float], dict]:
            """The three losses and the first step's gradients by leaf."""
            params = self.fresh_params()[0]
            leaves = dict(param_leaves(params))
            opt = build_optimizer(params, 0.0)
            first: dict = {}

            def keep_first(*_):
                if not first:
                    first.update({n: t.grad.detach().clone() for n, t in leaves.items()})

            opt.register_step_pre_hook(keep_first)
            step = TrainStep(
                params, cfg, opt, lambda count: STEP_CHECK_LR,
                loss_scale=30.0, accum=1, device=self.dev,
            )
            return [step(b, seed=0).item() for b in batches], first

        with plain_kernels():
            plain_losses, plain_grads = run()

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

        wrappers = training_wrappers()
        for w in wrappers:
            w.launches = 0
        sound = readings(*run())
        counts = {w.__name__: w.launches for w in wrappers}
        launched = counter.launches

        def planted(module, name, change):
            wrapper = getattr(module, name)

            def faulty(*args, **kwargs):
                return change(*wrapper(*args, **kwargs))

            # Each wrapper counts its launches through its module-level name.
            faulty.launches = 0
            with mock.patch.object(module, name, faulty):
                return readings(*run())

        fault_readings = {name: planted(*spec) for name, spec in faults.items()}
        log(
            f"{self.model_name}: 3 steps at dropout 0, lr {STEP_CHECK_LR}, kernels vs plain: "
            f"losses {sound['losses']} vs {plain_losses}; loss rel diff {sound['loss_rel']:.3g} "
            f"(tol {STEP_LOSS_REL_TOL}); first-step grads worst leaf {sound['grad_worst_leaf']} "
            f"{sound['grad_rel']:.3g} (tol {STEP_GRAD_REL_TOL}), worst three "
            f"{sound['grad_worst_3']}; {counter.__name__} launches {launched}; k_b grad max |g|: "
            f"kernels {sound['k_b_max_abs']:.3g}, plain "
            f"{plain_grads['layers/k_b'].abs().max().item():.3g}"
        )
        for name, f in fault_readings.items():
            log(
                f"  planted fault {name}: loss rel diff {f['loss_rel']:.3g}, grads worst three "
                f"{f['grad_worst_3']}"
            )
        self.smoke.check(
            sound["loss_rel"] <= STEP_LOSS_REL_TOL
            and sound["grad_rel"] <= STEP_GRAD_REL_TOL
            and launched == 3 * per_step,
            f"{self.model_name} 3 steps: kernels agree with plain",
        )
        self.smoke.check(
            all(f["grad_rel"] > STEP_GRAD_REL_TOL for f in fault_readings.values())
            and any(f["loss_rel"] > STEP_LOSS_REL_TOL for f in fault_readings.values()),
            f"{self.model_name} 3 steps: the limits catch the planted faults",
        )
        return {
            "seq": seq, "plain_losses": plain_losses, "kernels": sound,
            "planted_faults": fault_readings, "launches": counts,
        }

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
        # The attention launches (attn_* kernels): K6 and K7 on the unfused
        # route, the attention inside K1 and K5 on the fused route.
        attn = {name: v for name, v in per_kernel.items() if "attn_" in name}
        attn_ms = sum(v[0] for v in attn.values())
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
            "attention_kernels_ms_per_step": {
                name[:90]: [round(ms, 4), n // n_steps] for name, (ms, n) in attn.items()
            },
            "attention_kernels_device_share": attn_ms / device_ms if device_ms > 0 else 0.0,
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


class MpnetTrainPhase(TrainPhase):
    """Phase 5: MNRL training of the mpnet-base-class tower at full width
    (hidden 768, 12 layers, 12 heads of 64, intermediate 3072) through
    TwoTowerTrainer.train(data=...) on the same pairs: at S=256 every layer
    takes the fused route, K1-train forward and K5 backward. The attention
    kernels K6 and K7 stay held through TrainStep at S=200, which the fused
    kernels do not take."""

    model_name = "mpnet-base"
    row_suffix = "_hd64"

    def run(self) -> dict:
        from instacart_next_order_recommendation_tpu_torch.ops import (
            attention,
            fused_encoder_layer_backward,
            fused_layer,
            multi_head_attention_backward,
        )
        from instacart_next_order_recommendation_tpu_torch.train import TwoTowerTrainer

        smoke = self.smoke
        ndcg_untrained = self.untrained(self.workdir / "train_corpus.json")

        # ---- the main path, counted from zero
        wrappers = training_wrappers()
        for w in wrappers:
            w.launches = 0
        trainer = TwoTowerTrainer(
            self.config("trained", epochs=MPNET_EPOCHS, learning_rate=MPNET_LR)
        )
        t0 = time.perf_counter()
        result = trainer.train(data=self.data)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        counts = {w.__name__: w.launches for w in wrappers}
        # ---- end of the main path

        losses = np.asarray(trainer.step_losses)
        n_epoch = self.steps_per_epoch(64, MPNET_EPOCHS)
        steps = len(losses)
        hist = result["history"]
        per_epoch = [
            {
                "epoch": entry["epoch"],
                "steps": n,
                "step_ms": entry["epoch_seconds"] / n * 1e3,
                "pairs_per_s": 64 * n / entry["epoch_seconds"],
                "train_loss": entry["train_loss"],
                "eval_loss": entry.get("eval_loss"),
                "ndcg_at_10": entry.get("ndcg_at_10"),
            }
            for entry, n in zip(hist, n_epoch)
        ]
        log(f"mpnet train: {steps} steps, seq {trainer.seq_len}, {train_s:.1f}s; epochs "
            f"{json.dumps(per_epoch)}")
        log("mpnet train per-step loss: " + " ".join(f"{v:.4f}" for v in losses))
        log(f"mpnet main-path launches: {counts}")
        head, tail = losses[:10].mean(), losses[-10:].mean()
        smoke.check(trainer.seq_len == 256, "mpnet: the p5_mp20 contexts bucket to S=256")
        smoke.check(steps == sum(n_epoch), "mpnet: steps per epoch as the batches give")
        smoke.check(bool(np.isfinite(losses).all()), "mpnet training losses finite")
        smoke.check(tail < head, f"mpnet loss falls (first 10 mean {head:.4f}, last 10 {tail:.4f})")
        eval_forwards = counts["masked_mean_pool_l2norm"] - 2 * steps
        smoke.check(
            counts["fused_encoder_layer_train"] == 24 * steps
            and counts["fused_encoder_layer_backward"] == 24 * steps
            and eval_forwards > 0
            and counts["fused_encoder_layer"] == 12 * eval_forwards
            and counts["cosine_topk"] > 0
            and counts["multi_head_attention"] == counts["multi_head_attention_backward"] == 0,
            "mpnet: 24 K1-train and 24 K5 launches per step, 12 K1 per eval forward, no K6 or K7",
        )
        best = max(hist, key=lambda h: h["ndcg_at_10"])
        log(f"mpnet NDCG@10: trained {best['ndcg_at_10']:.4f}, untrained {ndcg_untrained:.4f}")

        self.kernel_rows(trainer, result["final_dir"], counts)
        step_check = self.kernels_against_plain_steps(
            trainer.seq_len,
            {
                "weight_grads_x0.9": (
                    fused_layer, "fused_encoder_layer_backward",
                    lambda dx, dw: (dx, {n: 0.9 * g for n, g in dw.items()}),
                ),
                "dx_negated": (
                    fused_layer, "fused_encoder_layer_backward", lambda dx, dw: (-dx, dw)
                ),
            },
            fused_encoder_layer_backward, 24,
        )
        # ---- K6 and K7 through TrainStep, at a length the fused kernels refuse
        k7_check = self.kernels_against_plain_steps(
            ATTENTION_TRAIN_SEQ,
            {
                "dk_x0.9": (
                    attention, "multi_head_attention_backward",
                    lambda dq, dk, dv: (dq, 0.9 * dk, dv),
                ),
                "dq_negated": (
                    attention, "multi_head_attention_backward", lambda dq, dk, dv: (-dq, dk, dv)
                ),
            },
            multi_head_attention_backward, 24,
        )
        launched = k7_check["launches"]
        smoke.check(
            launched["multi_head_attention"] == 3 * 24
            and launched["fused_encoder_layer_train"] == launched["fused_encoder_layer_backward"] == 0,
            f"mpnet at S={ATTENTION_TRAIN_SEQ}: 24 K6 and 24 K7 launches per step, no K1 or K5",
        )
        self.attention_rows(result["final_dir"], ATTENTION_TRAIN_SEQ, launched)
        b256 = {
            f"S={seq}": self.remat_sample(seq, remat)
            for seq, remat in ((trainer.seq_len, False), (ATTENTION_TRAIN_SEQ, True))
        }
        breakdown = self.step_breakdown(trainer.seq_len, 64, n_steps=3)
        return {
            "batch": 64,
            "seq": trainer.seq_len,
            "steps": steps,
            "train_seconds": train_s,
            "epochs": per_epoch,
            "ndcg_at_10_trained": best["ndcg_at_10"],
            "ndcg_at_10_untrained": ndcg_untrained,
            "launches": counts,
            "three_steps_kernels_vs_plain": step_check,
            "three_steps_attention_kernels_vs_plain": k7_check,
            "b256_steps": b256,
            "step_breakdown": breakdown,
        }

    def attention_rows(self, final_dir, seq: int, counts: dict) -> None:
        """K6 and K7 at the shape of the batches that run them, B=64 at
        ``seq``, from the trained tower's first layer, for the kernels line;
        ``counts`` are that path's launches."""
        from instacart_next_order_recommendation_tpu_torch.models.checkpoint import load_tower
        from instacart_next_order_recommendation_tpu_torch.models.encoder import embed
        from instacart_next_order_recommendation_tpu_torch.ops.fused_layer import prepare_layer

        params, cfg, tok = load_tower(final_dir)
        params = {k: ({n: t.to(self.dev) for n, t in v.items()}) for k, v in params.items()}
        a_ids, a_mask = self.batches(tok, seq, 64, 1)[0][:2]
        layer = prepare_layer({n: t[0] for n, t in params["layers"].items()}, torch.bfloat16)
        with torch.no_grad():
            x = embed(params, a_ids, cfg)
            q, k, v = layer_qkv(x, layer, cfg.num_heads)
        do = torch.randn(q.shape, generator=torch.Generator().manual_seed(10)).to(self.dev, q.dtype)
        fwd, bwd = measure_attention(q, k, v, a_mask, do, cfg.head_dim**-0.5, iters=20)
        self.smoke.check(attention_rows_ok(fwd, bwd), f"K6/K7 at the mpnet B=64 S={seq} batch")
        for name, row in (("multi_head_attention", fwd), ("multi_head_attention_backward", bwd)):
            self.smoke.kernel_rows[name] = {
                **kernel_row({**row, "launches": counts[name]}), "max_rel_err": row["max_rel_err"]
            }
        log(
            f"K6/K7 rows at the training batch shape B=64 S={seq} heads={cfg.num_heads} "
            f"D={cfg.head_dim}: K6 {json.dumps(self.smoke.kernel_rows['multi_head_attention'])}; "
            f"K7 {json.dumps(self.smoke.kernel_rows['multi_head_attention_backward'])}"
        )

    def remat_sample(self, seq: int, expect_remat: bool, n_steps: int = 5) -> dict:
        """B=256 steps at ``seq`` with the remat that _resolve_remat chooses,
        timed, with the peak device memory and every wrapper's launches; they
        must fit and give finite losses. At S=256 the fused kernels take the
        tower and remat is off (K5 keeps only the layer inputs, where the
        unfused route without remat keeps every layer's activations); at a
        length they refuse it is on, and each unfused layer runs under
        torch.utils.checkpoint, its K6 launched again in the backward."""
        from instacart_next_order_recommendation_tpu_torch.train import TwoTowerTrainer
        from instacart_next_order_recommendation_tpu_torch.train.trainer import (
            TrainStep,
            build_optimizer,
            warmup_cosine_schedule,
        )

        params, cfg, tok = self.fresh_params()
        del params
        trainer = TwoTowerTrainer(self.config("remat", train_batch_size=REMAT_BATCH))
        chosen = trainer._resolve_remat(
            cfg.hidden_size, cfg.num_heads, cfg.intermediate_size, seq
        )
        self.smoke.check(
            chosen == expect_remat,
            f"_resolve_remat turns remat {'on' if expect_remat else 'off'} at "
            f"B={REMAT_BATCH} S={seq}",
        )
        batches = self.batches(tok, seq, REMAT_BATCH, n_steps + 1)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        params = self.fresh_params()[0]
        step = TrainStep(
            params, dataclasses.replace(cfg, remat=chosen), build_optimizer(params, 0.0),
            warmup_cosine_schedule(2e-4, 100), loss_scale=30.0, accum=1, device=self.dev,
        )
        wrappers = training_wrappers()
        for w in wrappers:
            w.launches = 0
        try:
            step(batches[0], seed=0)  # warm-up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses = [step(b, seed=i) for i, b in enumerate(batches[1:], 1)]
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3 / n_steps
            out = {
                "remat": chosen,
                "step_ms": ms,
                "pairs_per_s": REMAT_BATCH / ms * 1e3,
                "max_memory_allocated_gib": torch.cuda.max_memory_allocated() / 2**30,
                "losses": torch.stack(losses).tolist(),
            }
        except torch.cuda.OutOfMemoryError:
            out = {
                "remat": chosen,
                "did_not_fit": True,
                "max_memory_allocated_gib": torch.cuda.max_memory_allocated() / 2**30,
            }
        out["launches"] = {w.__name__: w.launches for w in wrappers}
        del step, params
        torch.cuda.empty_cache()
        log(f"mpnet B={REMAT_BATCH} S={seq}, {n_steps} steps: {json.dumps(out)}")
        self.smoke.check(
            "losses" in out and bool(np.isfinite(out["losses"]).all()),
            f"mpnet B={REMAT_BATCH} S={seq} steps (remat {chosen}) fit, losses finite",
        )
        n = n_steps + 1  # the warm-up step counts too
        expected = {name: 0 for name in out["launches"]}
        expected["masked_mean_pool_l2norm"] = 2 * n
        if chosen:  # two towers of 12 unfused layers, each K6 run again in the backward
            expected.update(multi_head_attention=48 * n, multi_head_attention_backward=24 * n)
        else:
            expected.update(fused_encoder_layer_train=24 * n, fused_encoder_layer_backward=24 * n)
        self.smoke.check(
            out["launches"] == expected,
            f"mpnet B={REMAT_BATCH} S={seq} (remat {chosen}): launches over {n} steps {expected}",
        )
        return out


# Phase 4b: Hugging Face towers, the baselines CLI and training's tracing.
# BERT's name of each tower parameter (under encoder.layer.{i}. for the
# layers); the tower keeps a Linear weight as (in, out), BERT as (out, in).
# The script writes HF directories from its own table, not the loader's, so
# that loading them tests the loader's table too.
BERT_EMBEDDING_NAMES = {
    "word": "embeddings.word_embeddings.weight",
    "position": "embeddings.position_embeddings.weight",
    "token_type": "embeddings.token_type_embeddings.weight",
    "ln_scale": "embeddings.LayerNorm.weight",
    "ln_bias": "embeddings.LayerNorm.bias",
}
BERT_LAYER_NAMES = {
    "q_w": "attention.self.query.weight", "q_b": "attention.self.query.bias",
    "k_w": "attention.self.key.weight", "k_b": "attention.self.key.bias",
    "v_w": "attention.self.value.weight", "v_b": "attention.self.value.bias",
    "o_w": "attention.output.dense.weight", "o_b": "attention.output.dense.bias",
    "attn_ln_scale": "attention.output.LayerNorm.weight",
    "attn_ln_bias": "attention.output.LayerNorm.bias",
    "ffn_w1": "intermediate.dense.weight", "ffn_b1": "intermediate.dense.bias",
    "ffn_w2": "output.dense.weight", "ffn_b2": "output.dense.bias",
    "ffn_ln_scale": "output.LayerNorm.weight", "ffn_ln_bias": "output.LayerNorm.bias",
}
LINEAR_WEIGHTS = {"q_w", "k_w", "v_w", "o_w", "ffn_w1", "ffn_w2"}
# The three layouts phase 4b writes: (weights file, module prefix).
HF_LAYOUTS = (
    ("pytorch_model.bin", ""),
    ("pytorch_model.bin", "0.auto_model."),
    ("model.safetensors", "bert."),
)
HF_RECOMMEND_QUERIES = 32
HF_API_QUERIES = 16
WARM_START_TRACED = 5  # the trainer traces dispatches 1-5 of its first epoch
CF_CHECKED_QUERIES = 20
TRAINER_LOGGER = f"{PKG}.train.trainer"


def bert_state_dict(params: dict, n_layers: int, prefix: str) -> dict[str, torch.Tensor]:
    """The tower's params under BERT's names and layout, each name after
    ``prefix``."""
    sd = {prefix + hf: params["embeddings"][ours] for ours, hf in BERT_EMBEDDING_NAMES.items()}
    for ours, hf in BERT_LAYER_NAMES.items():
        for i in range(n_layers):
            t = params["layers"][ours][i]
            sd[f"{prefix}encoder.layer.{i}.{hf}"] = t.T if ours in LINEAR_WEIGHTS else t
    return {k: v.detach().to("cpu", torch.float32).contiguous() for k, v in sd.items()}


def bert_config_json(cfg) -> dict:
    """BertConfig's fields for a tower config, written by hand (the card's
    machine need not have transformers)."""
    return {
        "architectures": ["BertModel"], "model_type": "bert",
        "vocab_size": cfg.vocab_size, "hidden_size": cfg.hidden_size,
        "num_hidden_layers": cfg.num_layers, "num_attention_heads": cfg.num_heads,
        "intermediate_size": cfg.intermediate_size, "hidden_act": "gelu",
        "hidden_dropout_prob": cfg.hidden_dropout, "attention_probs_dropout_prob": 0.1,
        "max_position_embeddings": cfg.max_position, "type_vocab_size": cfg.type_vocab_size,
        "initializer_range": 0.02, "layer_norm_eps": cfg.layer_norm_eps, "pad_token_id": 0,
        "position_embedding_type": "absolute", "use_cache": True, "classifier_dropout": None,
    }


def write_safetensors(path: Path, tensors: dict[str, torch.Tensor]) -> None:
    """A ``.safetensors`` file of f32 tensors: the header's length (8 bytes,
    little-endian), the JSON header padded to 8 bytes, then the data."""
    import struct

    header, blobs, offset = {"__metadata__": {"format": "pt"}}, [], 0
    for name, t in tensors.items():
        blob = t.numpy().tobytes()
        header[name] = {"dtype": "F32", "shape": list(t.shape),
                        "data_offsets": [offset, offset + len(blob)]}
        blobs.append(blob)
        offset += len(blob)
    head = json.dumps(header).encode()
    head += b" " * (-len(head) % 8)
    path.write_bytes(struct.pack("<Q", len(head)) + head + b"".join(blobs))


def write_hf_dir(path: Path, params: dict, cfg, tok, weights: str, prefix: str) -> Path:
    path.mkdir(parents=True)
    (path / "config.json").write_text(json.dumps(bert_config_json(cfg), indent=2))
    sd = bert_state_dict(params, cfg.num_layers, prefix)
    if weights == "model.safetensors":
        write_safetensors(path / weights, sd)
    else:
        torch.save(sd, path / weights)
    tok.save(path)  # vocab.txt and tokenizer_config.json (do_lower_case)
    return path


def write_instacart_csvs(synthetic: dict, data_dir: Path) -> None:
    """The synthetic users as Instacart's ``orders.csv`` (each user's last
    order ``train``, the others ``prior``) and ``order_products__prior.csv``;
    product i has id i + 1."""
    import csv

    data_dir.mkdir(parents=True)
    with open(data_dir / "orders.csv", "w", newline="") as fo, \
            open(data_dir / "order_products__prior.csv", "w", newline="") as fp:
        orders, products = csv.writer(fo), csv.writer(fp)
        orders.writerow(["order_id", "user_id", "eval_set", "order_number", "order_dow",
                         "order_hour_of_day", "days_since_prior_order"])
        products.writerow(["order_id", "product_id", "add_to_cart_order", "reordered"])
        for uid, user in enumerate(synthetic["users"], 1):
            seen: set[int] = set()
            for n, (oid, days, dow, hour, basket) in enumerate(user, 1):
                last = n == len(user)
                orders.writerow([oid, uid, "train" if last else "prior", n, dow, hour,
                                 "" if days is None else f"{days}.0"])
                if not last:
                    for pos, p in enumerate(basket, 1):
                        products.writerow([oid, p + 1, pos, int(p in seen)])
                seen.update(basket)


def plain_cf_top(synthetic: dict, qids: list[str], k: int) -> dict[str, list[str]]:
    """Item-item CF by a plain count of co-occurring pairs: over every prior
    order of the held-out users, each pair of products in one order counts
    once (a product with itself too); a query's score of a product is its
    count summed over the products the user bought before, the user's
    products are left out, and ties keep corpus order."""
    users = synthetic["users"]
    held = {str(orders[-1][0]): orders for orders in users[-held_out_users(users):]}
    co: dict[int, dict[int, int]] = {}
    for orders in held.values():
        for _, _, _, _, basket in orders[:-1]:
            for a in basket:
                row = co.setdefault(a, {})
                for b in basket:
                    row[b] = row.get(b, 0) + 1
    out = {}
    for qid in qids:
        history = {p for _, _, _, _, basket in held[qid][:-1] for p in basket}
        scores = {c: sum(co.get(c, {}).get(h, 0) for h in history)
                  for c in range(TRAIN_PRODUCTS) if c not in history}
        ranked = sorted(scores, key=lambda c: (-scores[c], c))
        out[qid] = [str(c + 1) for c in ranked[:k]]
    return out


def metric_tables(text: str) -> dict[str, dict[str, float]]:
    """``format_metrics`` tables in a CLI's output: title -> label -> value."""
    out: dict[str, dict[str, float]] = {}
    title = None
    for line in text.splitlines():
        m = re.fullmatch(r"--- (.+) ---", line.strip())
        if m:
            title = m.group(1)
            out[title] = {}
        elif title is not None and re.fullmatch(r"\s+[\w@]+:\s+[-\d.]+", line):
            label, value = line.split(":")
            out[title][label.strip()] = float(value)
    return {t: v for t, v in out.items() if v}


def trace_steps(trace_dir: Path) -> tuple[list[Path], int, list[collections.Counter]]:
    """The Chrome traces in ``trace_dir``; for the one there, its kernel
    records and, for each training step it holds, that step's kernels by
    name without template arguments. A step starts at its first word
    embedding lookup (two a step: the anchor tower, then the positive one);
    a kernel belongs to the step in which its launch was made on the host
    (the CUDA API call its correlation id names; its own start where that
    record is missing)."""
    import bisect

    files = sorted(trace_dir.glob("*.pt.trace.json"))
    if len(files) != 1:
        return files, 0, []
    events = [e for e in json.loads(files[0].read_text())["traceEvents"] if e.get("ph") == "X"]
    starts = sorted(float(e["ts"]) for e in events if e.get("name") == "aten::embedding")[::2]
    launched = {
        e["args"]["correlation"]: float(e["ts"]) for e in events
        if str(e.get("cat")).startswith("cuda_") and "correlation" in e.get("args", {})
    }
    kernels = [e for e in events if e.get("cat") == "kernel"]
    steps = [collections.Counter() for _ in starts]
    for e in kernels:
        t = launched.get(e.get("args", {}).get("correlation"), float(e["ts"]))
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0:
            steps[i][_kernel_name(e["name"]).split("<")[0].split("::")[-1]] += 1
    return files, len(kernels), steps


@contextlib.contextmanager
def logged_messages(name: str):
    """The messages logger ``name`` emits at INFO and above inside the block."""
    import logging

    logger, messages = logging.getLogger(name), []
    handler = logging.Handler(logging.INFO)
    handler.emit = lambda record: messages.append(record.getMessage())
    level = logger.level
    logger.setLevel(logging.INFO)
    logger.addHandler(handler)
    try:
        yield messages
    finally:
        logger.removeHandler(handler)
        logger.setLevel(level)


class HfBaselinesPhase:
    """Phase 4b at MiniLM-L6's full width. ``towers`` (before phase 4's
    first ``train()``): phase 3's seeded tower written as three Hugging Face
    directories (``pytorch_model.bin`` bare and under ``0.auto_model.``,
    ``model.safetensors`` under ``bert.``, with ``config.json``, the vocab
    and ``tokenizer_config.json``; no transformers), each loaded by
    ``load_tower`` bitwise equal to the source and encoding the serve batch
    bitwise equal to it through ``TextEncoder``, ``Recommender`` on one of
    them over phase 3's catalog, ``/admin/model`` to one on a live
    ``create_app``, and a warm start (``model_name:`` the directory) for one
    epoch with ``ITOR_PROFILE_DIR`` and ``ITOR_LOOP_TIMING=1``, its trace
    read kernel by kernel. ``baselines`` (after phase 4): phase 4's users as
    Instacart CSVs and eval files, ``python -m ...baselines`` twice (the
    untrained tower, then phase 4's trained one) with CF, and CF's rankings
    against a plain count of co-occurring pairs. Launch counts are reset
    before and read after."""

    def __init__(self, smoke: "Smoke", dev, workdir: Path, serving: dict, synthetic: dict,
                 data: tuple, smi: str):
        self.smoke, self.dev, self.synthetic, self.data, self.smi = (
            smoke, dev, synthetic, data, smi
        )
        self.st = smoke.serve_state
        self.root = workdir / "hf"
        self.tol = serving["batcher"]["near_tie_tol"]

    def towers(self) -> dict:
        from instacart_next_order_recommendation_tpu_torch.models.checkpoint import load_tower
        from instacart_next_order_recommendation_tpu_torch.models.text_encoder import TextEncoder
        from instacart_next_order_recommendation_tpu_torch.serve.recommender import Recommender

        smoke, st = self.smoke, self.st
        queries = st["queries"]
        t0 = time.perf_counter()
        src, src_cfg, tok = load_tower(st["model_dir"])
        dirs = [
            write_hf_dir(self.root / f"{weights.split('.')[0]}_{prefix.strip('.') or 'bare'}",
                         src, src_cfg, tok, weights, prefix)
            for weights, prefix in HF_LAYOUTS
        ]
        out: dict = {"dirs": [d.name for d in dirs], "write_s": time.perf_counter() - t0}

        # ---- the main path, counted from zero
        for w in serve_wrappers():
            w.launches = 0
        with torch.inference_mode():
            want = TextEncoder.load(st["model_dir"]).encode_device(queries[:BATCH])
            for d in dirs:
                params, cfg, hf_tok = load_tower(d)
                same = params.keys() == src.keys() and all(
                    params[g].keys() == src[g].keys()
                    and all(torch.equal(params[g][n], t) for n, t in src[g].items())
                    for g in src
                )
                emb = TextEncoder.load(d).encode_device(queries[:BATCH])
                smoke.check(
                    same and cfg == src_cfg and hf_tok.vocab == tok.vocab,
                    f"{d.name}: load_tower gives the source tower's params bitwise, its config "
                    "and vocab",
                )
                smoke.check(bool(torch.equal(emb, want)),
                            f"{d.name}: the serve batch encodes bitwise equal to the source tower")
            rec_hf = Recommender(dirs[-1], st["corpus_path"], use_index=False)
            rec_src = Recommender(st["model_dir"], st["corpus_path"], use_index=False)
            qs = queries[BATCH : BATCH + HF_RECOMMEND_QUERIES]
            got = [[p for p, _ in rec_hf.recommend(q, top_k=10)] for q in qs]
            ref = [[p for p, _ in rec_src.recommend(q, top_k=10)] for q in qs]
        counts = launch_counts()
        # ---- end of the main path
        out["launches"] = counts
        out["load_encode_recommend_s"] = time.perf_counter() - t0 - out["write_s"]
        smoke.check(bool(torch.equal(rec_hf.index.catalog, st["catalog"])),
                    f"Recommender on {dirs[-1].name}: phase 3's 50k catalog, bitwise")
        smoke.check(got == ref, f"Recommender on {dirs[-1].name}: top-10 ids identical to the "
                                f"source tower's for {len(qs)} queries")
        smoke.check(
            all(v > 0 for v in counts.values())
            and counts["fused_encoder_layer"] == src_cfg.num_layers
            * counts["masked_mean_pool_l2norm"],
            "HF towers: K1, K2 and K3 launched, 6 K1 per forward",
        )
        log(f"HF towers {json.dumps(out)} ({self.smi})")
        del rec_hf, rec_src
        t0 = time.perf_counter()
        out["admin_model"] = self.admin_model(dirs[0])
        out["admin_model_phase_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["warm_start"] = self.warm_start(dirs[1])
        out["warm_start_phase_s"] = time.perf_counter() - t0
        return out

    def admin_model(self, hf_dir: Path) -> dict:
        """``/admin/model`` to an HF directory on a live ``create_app``; the
        answers afterwards against the direct recommend of that tower."""
        import shutil

        from instacart_next_order_recommendation_tpu_torch.api.app import create_app
        from instacart_next_order_recommendation_tpu_torch.serve import MonitoredRecommender

        smoke, st = self.smoke, self.st
        root = self.root / "api"
        (root / "tmp").mkdir(parents=True)
        corpus = root / "eval_corpus.json"
        shutil.copyfile(st["corpus_path"], corpus)
        env = {"FEEDBACK_DB_PATH": str(root / "feedback.db"), "RATE_LIMIT": "1000000/minute"}
        unset = ("INFERENCE_DEVICE", "BATCH_WINDOW_MS", "API_KEY", "ITOR_TOPK_EXTRACTION",
                 "PRECOMPILE_ON_STARTUP", "MODEL_DIR", "CORPUS_PATH")
        with mock.patch.dict(os.environ, env), mock.patch.object(
            tempfile, "tempdir", str(root / "tmp")
        ):
            for name in unset:
                os.environ.pop(name, None)
            served = ServedApp(create_app(st["model_dir"], corpus))
            try:
                c = served.client
                t0 = time.perf_counter()
                status, body = c.post("/admin/model", {"model_dir": str(hf_dir)})
                swap_s = time.perf_counter() - t0
                live = served.app.state["recommender"]
                qs = st["queries"][:HF_API_QUERIES]
                after = [ranked(c.post("/recommend", {"user_context": q, "top_k": 10})[1])
                         for q in qs]
                want = MonitoredRecommender(hf_dir, corpus, use_index=False)
                ok = all(near_tie_ok(a, want.recommend(q, top_k=10), self.tol)
                         for q, a in zip(qs, after))
            finally:
                served.stop()
        out = {"status": status, "swap_s": swap_s, "requests": len(qs)}
        log(f"/admin/model to {hf_dir.name}: {json.dumps(out)}")
        smoke.check(
            status == 200 and body["model_dir"] == str(hf_dir)
            and live.model_dir == hf_dir.resolve(),
            "/admin/model swapped to the HF directory",
        )
        smoke.check(ok, "after /admin/model to the HF directory, /recommend answers the direct "
                        "recommend of that tower by the near-tie rule")
        return out

    def warm_start(self, hf_dir: Path) -> dict:
        """``TwoTowerTrainer`` with ``model_name:`` the HF directory for one
        epoch at B=64 on phase 4's pairs, with ``ITOR_PROFILE_DIR`` and
        ``ITOR_LOOP_TIMING=1``."""
        from instacart_next_order_recommendation_tpu_torch.models.checkpoint import load_tower
        from instacart_next_order_recommendation_tpu_torch.train import (
            TrainConfig,
            TwoTowerTrainer,
        )

        smoke, h = self.smoke, MINILM_WIDTHS[0]
        out_dir, trace_dir = self.root / "warm_start", self.root / "trace"
        cfg = TrainConfig({
            "processed_dir": str(self.root), "output_dir": str(out_dir),
            "model_name": str(hf_dir), "max_seq_length": 256, "epochs": 1,
            "train_batch_size": 64, "eval_batch_size": 64, "learning_rate": 2.0e-4,
            "loss_scale": 30.0, "logging_steps": 10, "seed": 42,
        })
        wrappers = training_wrappers()
        # ---- the main path, counted from zero
        for w in wrappers:
            w.launches = 0
        env = {"ITOR_PROFILE_DIR": str(trace_dir), "ITOR_LOOP_TIMING": "1"}
        with mock.patch.dict(os.environ, env), logged_messages(TRAINER_LOGGER) as messages:
            trainer = TwoTowerTrainer(cfg)
            t0 = time.perf_counter()
            result = trainer.train(data=self.data)
            torch.cuda.synchronize()
            train_s = time.perf_counter() - t0
        counts = {w.__name__: w.launches for w in wrappers}
        # ---- end of the main path

        losses = np.asarray(trainer.step_losses)
        steps = len(losses)
        entry = result["history"][0]
        step_ms = entry["epoch_seconds"] / steps * 1e3
        head, tail = losses[:10].mean(), losses[-10:].mean()
        timing = [m.strip() for m in messages if "loop timing/dispatch" in m]
        timing_ms = [[int(v) for v in re.findall(r"(\d+) ms", t)] for t in timing]
        files, n_kernels, traced = trace_steps(trace_dir)
        # Each K5 launch runs one dQ kernel and recomputes the forward's
        # attention once; each K1-train launch runs that attention once
        # (phase 2's launch-by-launch breakdowns at B=64 S=256 list them).
        per_step = [(c["attn_fwd_one_pass_kernel"] - c["attn_bwd_dq_kernel"],
                     c["attn_bwd_dq_kernel"]) for c in traced]
        final, final_cfg, _ = load_tower(result["final_dir"])
        out = {
            "steps": steps, "seq": trainer.seq_len, "train_s": train_s, "step_ms": step_ms,
            "loss_first10": float(head), "loss_last10": float(tail),
            "ndcg_at_10": entry.get("ndcg_at_10"), "launches": counts,
            "trace_files": [f.name for f in files], "trace_kernel_records": n_kernels,
            "trace_k1_train_k5_launches_per_step": per_step,
            "loop_timing_lines": len(timing),
            # per 25 dispatches: assemble, fold_in, submit, wall (ms a dispatch)
            "loop_timing_ms": timing_ms,
        }
        log(f"warm start from {hf_dir.name}: {json.dumps(out)} ({self.smi})")
        log("warm start per-step loss: " + " ".join(f"{v:.4f}" for v in losses))
        log(f"warm start trace, kernels of step 1: {dict(traced[0]) if traced else None}")
        for line in timing:
            log(f"  {line}")
        smoke.check(trainer.seq_len == 256 and bool(np.isfinite(losses).all()) and tail < head,
                    f"warm start: loss falls (first 10 {head:.4f}, last 10 {tail:.4f})")
        smoke.check(
            counts["fused_encoder_layer_train"] == 12 * steps
            and counts["fused_encoder_layer_backward"] == 12 * steps
            and counts["multi_head_attention"] == counts["multi_head_attention_backward"] == 0,
            "warm start: 12 K1-train and 12 K5 launches per step, no K6/K7",
        )
        smoke.check(
            len(files) == 1 and len(per_step) == WARM_START_TRACED
            and all(k1 > 0 and k5 > 0 for k1, k5 in per_step),
            f"warm start: one trace, whose kernel records hold K1-train and K5 launches in each "
            f"of dispatches 1-{WARM_START_TRACED}",
        )
        smoke.check(len(timing) == steps // 25 and all(
            re.fullmatch(r"loop timing/dispatch: assemble \d+ ms, fold_in \d+ ms, "
                         r"submit \d+ ms, wall \d+ ms", t) for t in timing),
            "warm start: ITOR_LOOP_TIMING logs the JAX line every 25 dispatches")
        smoke.check(
            final_cfg.hidden_size == h and final_cfg.num_layers == 6
            and all(bool(torch.isfinite(t).all()) for v in final.values() for t in v.values()),
            "warm start: final/ loads",
        )
        return out

    def baselines(self, trained_dir: str) -> dict:
        """The baselines CLI as a subprocess on phase 4's users, with the
        untrained tower and with phase 4's trained one; CF's rankings
        against a plain count."""
        from instacart_next_order_recommendation_tpu_torch.baselines import ItemItemCFBaseline

        smoke = self.smoke
        _, _, _, queries, corpus, relevant = self.data
        data_dir, processed = self.root / "data", self.root / "processed"
        write_instacart_csvs(self.synthetic, data_dir)
        (processed / "train_dataset").mkdir(parents=True)  # resolve_processed_dir's marker
        (processed / "eval_queries.json").write_text(json.dumps(queries))
        (processed / "eval_corpus.json").write_text(json.dumps(corpus))
        (processed / "eval_relevant_docs.json").write_text(
            json.dumps({q: sorted(v) for q, v in relevant.items()}))
        runs = {}
        for label, model in (("untrained", None), ("trained", trained_dir)):
            config = self.root / f"baselines_{label}.yaml"
            raw = {"processed_dir": str(processed), "data_dir": str(data_dir), "model": model}
            config.write_text("".join(f"{k}: {json.dumps(v)}\n" for k, v in raw.items()))
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, "-m", f"{PKG}.baselines", "--config", str(config)],
                cwd=REPO, capture_output=True, text=True, timeout=600,
            )
            tables = metric_tables(proc.stdout)
            runs[label] = {"exit": proc.returncode, "seconds": time.perf_counter() - t0,
                           "tables": tables}
            log(f"baselines CLI ({label}): exit {proc.returncode}, "
                f"{runs[label]['seconds']:.1f}s\n{proc.stdout[-1500:]}")
            if proc.returncode != 0:
                log(proc.stderr[-3000:])
            smoke.check(
                proc.returncode == 0 and set(tables) == {
                    "Content-based (untrained tower)", "Collaborative filtering (item-item)"}
                and all(len(t) == 8 for t in tables.values()),
                f"baselines CLI ({label}) exits 0 and prints both metric tables",
            )
        ndcg = {
            "untrained": runs["untrained"]["tables"].get(
                "Content-based (untrained tower)", {}).get("NDCG@10"),
            "cf": runs["untrained"]["tables"].get(
                "Collaborative filtering (item-item)", {}).get("NDCG@10"),
            "trained": runs["trained"]["tables"].get(
                "Content-based (untrained tower)", {}).get("NDCG@10"),
        }
        log(f"NDCG@10 side by side: untrained {ndcg['untrained']}, CF {ndcg['cf']}, "
            f"trained {ndcg['trained']} ({self.smi})")
        smoke.check(None not in ndcg.values() and ndcg["trained"] > ndcg["untrained"],
                    "NDCG@10 of the trained tower above the untrained one's")
        qids = list(queries)[:CF_CHECKED_QUERIES]
        cf = ItemItemCFBaseline(data_dir, processed).rank_all(eval_query_ids=qids)
        plain = plain_cf_top(self.synthetic, qids, 5)
        same = sum(cf[q][:5] == plain[q] for q in qids)
        log(f"CF top-5 against a plain count of co-occurring pairs: {same} of {len(qids)} "
            "identical")
        smoke.check(same == len(qids), "CF top-5 lists equal the plain count's")
        return {"runs": {k: {kk: vv for kk, vv in v.items() if kk != "tables"}
                         for k, v in runs.items()},
                "ndcg_at_10": ndcg, "cf_top5_identical": same}


# Phase 5b: multi-GPU on one card. The device mesh puts two (or four) data
# shards on cuda:0; the process mesh runs two gloo ranks that share cuda:0
# (NCCL refuses two ranks on one GPU; gloo takes all_reduce and broadcast on
# CUDA tensors, the two collectives the port uses there). What this shows:
# the code paths, each shard's and each rank's kernels, and the collectives'
# arithmetic. What it cannot show: interconnect speed or scaling.
MESH_TEXT_TOL = K1_TOL  # TextEncoder over a mesh against one device: K1's stated limit
MESH_RECALL_TOL = 0.01  # IVF's mesh build against the one-device build, recall@10 at nprobe 8
MULTI_GPU_TIMEOUT_S = 300
DP_BATCH = 32  # train_batch_size per data rank: global 64, phase 4's batch
TP_PAIRS = 256  # the TP trainer's pairs: the longest distinct anchors, 4 steps of 64 an epoch
TP_EPOCHS = 2
# The TP trainer's rate: its 8 steps must show the loss falling on pairs it
# has seen once (MPNET_LR's 3e-5 is set for a 96-step epoch).
TP_LR = 1e-4


def multi_gpu_rank(rank: int, world: int, workdir: str) -> None:
    """One of phase 5b's two gloo ranks on cuda:0: the DP=2 MiniLM-L6 run
    and its 3-step check with two planted faults, then the TP=2 mpnet run
    and its 3-step check at S=200 with a planted fault. Each rank keeps its
    own launch counts and writes what it read to ``rank<r>.json`` and its
    whole first-step gradients to ``grads<r>.pt``."""
    import torch.distributed as dist

    sys.path.insert(0, str(REPO))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    work = Path(workdir)
    dist.init_process_group(
        "gloo", init_method=f"file://{work / 'pg_init'}", rank=rank, world_size=world
    )
    try:
        inputs = torch.load(work / "inputs.pt", weights_only=False)
        ranks = RankRuns(rank, work, inputs)
        out = {"rank": rank, "dp": ranks.dp(), "tp": ranks.tp()}
        (work / f"rank{rank}.json").write_text(json.dumps(out))
        torch.save(ranks.grads, work / f"grads{rank}.pt")
    finally:
        dist.destroy_process_group()


class RankRuns:
    """What one rank of phase 5b runs (``multi_gpu_rank``)."""

    def __init__(self, rank: int, work: Path, inputs: dict):
        self.rank, self.work, self.inputs = rank, work, inputs
        self.dev = torch.device("cuda", 0)
        self.grads: dict = {}

    def counted(self, fn) -> tuple[object, dict[str, int], float]:
        """``fn()``, its launches by wrapper from zero, and its seconds."""
        wrappers = training_wrappers()
        for w in wrappers:
            w.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        return result, {w.__name__: w.launches for w in wrappers}, time.perf_counter() - t0

    def train_config(self, name: str, **kw):
        from instacart_next_order_recommendation_tpu_torch.train import TrainConfig

        return TrainConfig({
            "processed_dir": str(self.work),
            "output_dir": str(self.work / f"{name}_rank{self.rank}"),
            "max_seq_length": 256, "vocab_size": 30000, "eval_batch_size": 64,
            "loss_scale": 30.0, "logging_steps": 1000, "seed": 42, **kw,
        })

    def steps(self, tower_dir: str, seq: int, mesh, n: int, faults: dict) -> dict:
        """``n`` TrainSteps at dropout 0 and STEP_CHECK_LR from the tower in
        ``tower_dir`` on this rank's part of ``n`` global batches of 64 at
        length ``seq`` (its rows for a data rank, its shards for a model
        rank): the losses and the first step's whole gradients, then the
        same under each planted fault (``name -> (module, attribute,
        replacement)``). Step ms of steps 2 to n."""
        from instacart_next_order_recommendation_tpu_torch.models.checkpoint import load_tower
        from instacart_next_order_recommendation_tpu_torch.parallel import shard_params
        from instacart_next_order_recommendation_tpu_torch.parallel.mesh import gather_host
        from instacart_next_order_recommendation_tpu_torch.parallel.shardings import split_dim
        from instacart_next_order_recommendation_tpu_torch.train.trainer import (
            TrainStep,
            build_optimizer,
            param_leaves,
        )

        full, cfg, tok = load_tower(tower_dir)
        cfg = dataclasses.replace(cfg, hidden_dropout=0.0)
        anchors, positives = self.inputs["data"][:2]
        rows = slice(mesh.data_rank * (64 // mesh.dp), (mesh.data_rank + 1) * (64 // mesh.dp))
        batches = []
        for k in range(n):
            b = []
            for texts in (anchors, positives):
                ids, mask = tok.encode_batch(texts[k * 64 : (k + 1) * 64][rows],
                                             max_seq_length=seq, pad_to=seq)
                b += [torch.from_numpy(ids).to(self.dev), torch.from_numpy(mask).to(self.dev)]
            batches.append(b)

        def run(n_steps: int) -> tuple[list[float], dict, float]:
            local = shard_params(full, cfg, mesh.tp, mesh.model_rank)
            params = {g: {k: t.to(self.dev, copy=True).requires_grad_(True)
                          for k, t in v.items()} for g, v in local.items()}
            leaves = dict(param_leaves(params))
            opt = build_optimizer(params, 0.0)
            first: dict = {}

            def keep_first(*_):
                if not first:
                    first.update({n: t.grad.detach().cpu() for n, t in leaves.items()})

            opt.register_step_pre_hook(keep_first)
            step = TrainStep(params, cfg, opt, lambda count: STEP_CHECK_LR, loss_scale=30.0,
                             accum=1, device=self.dev, mesh=mesh)
            losses, times = [], []
            for b in batches[:n_steps]:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                losses.append(step(b, seed=0).item())
                times.append(time.perf_counter() - t0)
            if mesh.tp > 1:  # whole gradients: the split leaves gathered over the model group
                first = {n: g if split_dim(n) is None
                         else gather_host(g, split_dim(n), mesh.host_model_group)
                         for n, g in first.items()}
            return losses, first, float(np.mean(times[1:]) * 1e3) if n_steps > 1 else None

        (losses, grads, step_ms), counts, _ = self.counted(lambda: run(n))
        out = {"losses": losses, "step_ms": step_ms, "launches": counts, "faults": {}}
        tag = f"{Path(tower_dir).parent.parent.name}_S{seq}"
        self.grads[tag] = {"sound": grads}
        for name, (module, attr, replacement) in faults.items():
            with mock.patch.object(module, attr, replacement):
                f_losses, f_grads, _ = run(n)
            out["faults"][name] = {"losses": f_losses}
            self.grads[tag][name] = f_grads
        return out

    def dp(self) -> dict:
        """DP=2, MiniLM-L6 at full width: one epoch through the trainer at
        train_batch_size 32 (global 64), warm-started from phase 4's
        untrained tower (the preset's seeded init and vocab, without
        training the vocab again), then the 3-step check with its two
        planted faults."""
        import instacart_next_order_recommendation_tpu_torch.ops.mnrl as mnrl_mod
        from instacart_next_order_recommendation_tpu_torch.parallel import MeshConfig, ProcessMesh
        from instacart_next_order_recommendation_tpu_torch.train import TwoTowerTrainer
        from instacart_next_order_recommendation_tpu_torch.train import trainer as trainer_mod

        cfg = self.train_config("dp", model_name=self.inputs["minilm_untrained"], epochs=1,
                                train_batch_size=DP_BATCH, learning_rate=2.0e-4, data_parallel=2)
        trainer = TwoTowerTrainer(cfg, device=self.dev)
        result, counts, seconds = self.counted(lambda: trainer.train(data=self.inputs["data"]))
        out = {"seconds": seconds, "seq": trainer.seq_len, "losses": trainer.step_losses,
               "history": result["history"], "final_dir": result["final_dir"],
               "launches": counts, "mesh": [trainer.mesh.dp, trainer.mesh.tp]}
        average, gather = trainer_mod.average_over_data, mnrl_mod.all_gather_rows

        def no_division(tensors, group, dp):
            average(tensors, group, 1)

        def rank1_left_out(x, group):
            buf = gather(x, group)
            buf[x.shape[0] :] = 0  # rank 1's positives: not in the gather
            return buf

        mesh = ProcessMesh(MeshConfig(2, 1))
        out["steps"] = self.steps(
            self.inputs["minilm_untrained"], 256, mesh, 3,
            {"no_division_by_dp": (trainer_mod, "average_over_data", no_division),
             "rank1_positives_left_out": (mnrl_mod, "all_gather_rows", rank1_left_out)},
        )
        return out

    def tp(self) -> dict:
        """TP=2, mpnet-base-class at full width: two epochs through the
        trainer, warm-started from phase 5's untrained tower, over the
        TP_PAIRS longest distinct pairs at B=64, S=256, then the
        3-step check at S=200 with rank 1's tp_exit all-reduce left out."""
        import torch.distributed as dist

        from instacart_next_order_recommendation_tpu_torch.parallel import MeshConfig, ProcessMesh
        from instacart_next_order_recommendation_tpu_torch.parallel import tp as tp_mod
        from instacart_next_order_recommendation_tpu_torch.train import TwoTowerTrainer

        anchors, positives, _, queries, corpus, relevant = self.inputs["data"]
        longest, seen = [], set()  # one pair per anchor and per product: batches fill
        for i in np.argsort([-len(a) for a in anchors], kind="stable"):
            if anchors[i] not in seen and positives[i] not in seen and len(longest) < TP_PAIRS:
                longest.append(i)
                seen.update((anchors[i], positives[i]))
        data = ([anchors[i] for i in longest], [positives[i] for i in longest], None,
                queries, corpus, relevant)
        cfg = self.train_config(
            "tp", model_name=self.inputs["mpnet_untrained"], epochs=TP_EPOCHS, train_batch_size=64,
            learning_rate=TP_LR, model_parallel=2, data_parallel=1, save_total_limit=1,
            run_information_retrieval_evaluator=False,
        )
        trainer = TwoTowerTrainer(cfg, device=self.dev)
        torch.cuda.reset_peak_memory_stats()
        result, counts, seconds = self.counted(lambda: trainer.train(data=data))
        out = {"seconds": seconds, "seq": trainer.seq_len, "losses": trainer.step_losses,
               "history": result["history"], "launches": counts,
               "peak_device_bytes": torch.cuda.max_memory_allocated(),
               "mesh": [trainer.mesh.dp, trainer.mesh.tp]}
        real_exit = tp_mod._Exit

        class Rank1SkipsExit(torch.autograd.Function):
            """tp_exit whose all-reduce rank 1 leaves out: it keeps its own
            partial sum (it still joins the collective, so rank 0 does not
            wait for ever)."""

            @staticmethod
            def forward(ctx, x, group):
                summed = real_exit.forward(ctx, x, group)
                return x.contiguous().clone() if dist.get_rank(group) == 1 else summed

            @staticmethod
            def backward(ctx, grad):
                return grad, None

        mesh = ProcessMesh(MeshConfig(1, 2))
        out["steps"] = self.steps(
            self.inputs["mpnet_untrained"], ATTENTION_TRAIN_SEQ, mesh, 3,
            {"rank1_tp_exit_skipped": (tp_mod, "_Exit", Rank1SkipsExit)},
        )
        return out


class MultiGpuPhase:
    """Phase 5b: multi-GPU on one card. The device mesh (dp=2, both shards
    on cuda:0; dp=4 over 50,001 rows): ``ShardedCatalogIndex`` over phase
    3's 50k catalog (f32, bf16, packed, aisle-masked) against the
    one-device index, at 1M x 384 B=8 timed beside it, IVF's mesh build on
    phase 3e's 1M rows against its one-device build, and ``TextEncoder``
    over the mesh on the 50k catalog. The process mesh (two gloo ranks on
    cuda:0, ``multi_gpu_rank``): DP=2 MiniLM-L6 and TP=2 mpnet-base-class
    training, each held to the one-process TrainStep at B=64 with planted
    faults. Launch counts are reset before and read after each part."""

    def __init__(self, smoke: "Smoke", dev, workdir: Path, smi: str, minilm, mpnet):
        self.smoke, self.dev, self.smi = smoke, dev, smi
        self.workdir = workdir / "multi_gpu"
        self.workdir.mkdir(parents=True, exist_ok=True)
        self.minilm, self.mpnet = minilm, mpnet
        self.st = smoke.serve_state

    def run(self) -> dict:
        out = {"device_mesh": self.device_mesh(), "process_mesh": self.process_mesh()}
        out["launches"] = self.smoke.launches_5b = self.counts
        log("multi-GPU " + json.dumps(out))
        return out

    # ------------------------------------------------------------ device mesh

    def device_mesh(self) -> dict:
        from instacart_next_order_recommendation_tpu_torch.index import (
            IVFCatalogIndex,
            ShardedCatalogIndex,
        )
        from instacart_next_order_recommendation_tpu_torch.models.text_encoder import TextEncoder
        from instacart_next_order_recommendation_tpu_torch.ops import cosine_topk
        from instacart_next_order_recommendation_tpu_torch.ops.topk import _masked_scores
        from instacart_next_order_recommendation_tpu_torch.parallel import MeshConfig, build_mesh

        smoke, dev, st = self.smoke, self.dev, self.st
        mesh2 = build_mesh(MeshConfig(2, 1), devices=[dev, dev])
        mesh4 = build_mesh(MeshConfig(4, 1), devices=[dev] * 4)
        catalog = st["catalog"]
        encoder = TextEncoder.load(st["model_dir"], device=dev)
        with torch.inference_mode():
            q = encoder.encode_resident(st["queries"][:BATCH], batch_size=BATCH)
        milk = torch.tensor(["Aisle: milk." in t for t in st["catalog_texts"]], dtype=torch.int32)
        out: dict = {"sharded_50k": {}}

        # ---- the main path, counted from zero
        for w in training_wrappers():
            w.launches = 0
        cosine_topk.packed_launches = 0
        cosine_topk.bf16_launches = cosine_topk.packed_bf16_launches = 0
        for name, kw, mask, rule in (
            ("f32", {}, None, (BF16_TIE, 1e-6)),
            ("masked", {}, milk, (BF16_TIE, 1e-6)),
            ("bf16", {"dtype": "bfloat16"}, None, (BF16_TIE, 1e-6)),
            ("packed", {"extraction": "packed"}, None, (PACKED_TIE_REL, 1e-6)),
        ):
            before = cosine_topk.launches + cosine_topk.packed_launches
            sharded = ShardedCatalogIndex(catalog, mesh2, **kw)
            s_got, got = sharded.topk_device(q, K_BATCH, candidate_mask=mask)
            launched = cosine_topk.launches + cosine_topk.packed_launches - before
            one = ShardedCatalogIndex(catalog, device=dev, **kw)
            s_want, want = one.topk_device(q, K_BATCH, candidate_mask=mask)
            scores = _masked_scores(q, catalog, None, None if mask is None else mask.to(dev))
            out["sharded_50k"][name] = {
                "ids_identical": float((got == want).float().mean()),
                "near_tie": ids_near_tie(scores, got, want, *rule),
                "launches_per_call": launched,
                "max_score_diff": (s_got - s_want).abs().max().item(),
            }
            smoke.check(out["sharded_50k"][name]["near_tie"] and launched == 2,
                        f"ShardedCatalogIndex dp=2 ({name}) on one card: 2 launches a call, "
                        "top-16 ids the one-device index's or near-ties")
        rows = torch.cat([catalog, catalog[:1]])  # 50,001: the last of 4 shards is short
        sharded4 = ShardedCatalogIndex(rows, mesh4)
        got4 = sharded4.topk_device(q, K_BATCH)[1]
        want4 = ShardedCatalogIndex(rows, device=dev).topk_device(q, K_BATCH)[1]
        out["sharded_50001_dp4"] = {
            "shard_valid": [sharded4.shard_valid(i) for i in range(4)],
            "near_tie": ids_near_tie(_masked_scores(q, rows, None, None), got4, want4,
                                     BF16_TIE, 1e-6),
        }
        smoke.check(out["sharded_50001_dp4"]["near_tie"]
                    and out["sharded_50001_dp4"]["shard_valid"][-1] < sharded4.shard_rows,
                    "ShardedCatalogIndex dp=4 over 50,001 rows (a short last shard)")
        with torch.inference_mode():
            t0 = time.perf_counter()
            mesh_encoder = TextEncoder.load(st["model_dir"], mesh=mesh2)
            enc = mesh_encoder.encode_resident(st["catalog_texts"], batch_size=512)
            torch.cuda.synchronize()
            enc_s = time.perf_counter() - t0
        counts = {"cosine_topk": cosine_topk.launches - cosine_topk.bf16_launches,
                  "cosine_topk_bf16": cosine_topk.bf16_launches,
                  "cosine_topk_packed": cosine_topk.packed_launches
                  - cosine_topk.packed_bf16_launches,
                  "cosine_topk_packed_bf16": cosine_topk.packed_bf16_launches}
        counts.update({w.__name__: w.launches for w in serve_wrappers()
                       if w.__name__ != "cosine_topk"})
        # ---- end of the main path
        diff = (enc - catalog).abs().max().item()
        out["text_encoder_50k"] = {"max_abs_diff": diff, "seconds": enc_s,
                                   "shards": len(mesh_encoder.shard_devices)}
        smoke.check(diff <= MESH_TEXT_TOL,
                    f"TextEncoder over a dp=2 mesh equals the one-device encode ({diff:.3g})")
        out["launches"] = counts
        self.counts = dict(counts)
        out.update(self.catalog_1m(mesh2))
        return out

    def catalog_1m(self, mesh2) -> dict:
        """At 1M x 384: the sharded scan's device ms at B=8 beside the
        one-device scan's (the shards run one after the other on one card:
        this says what the merge costs, not what scaling gives), and IVF's
        mesh build against phase 3e's one-device build."""
        from instacart_next_order_recommendation_tpu_torch.index import (
            IVFCatalogIndex,
            ShardedCatalogIndex,
        )
        from instacart_next_order_recommendation_tpu_torch.ops import cosine_topk

        smoke, dev = self.smoke, self.dev
        ivf_1m = self.smoke.ivf_1m
        cat = torch.from_numpy(ivf_1m["catalog"]).to(dev)
        q_all = torch.from_numpy(ivf_1m["queries"]).to(dev)
        k = ivf_1m["k"]
        one = ShardedCatalogIndex(cat, device=dev)
        sharded = ShardedCatalogIndex(cat, mesh2)
        q8 = q_all[:8]
        before = cosine_topk.launches
        same = bool(torch.equal(sharded.topk_device(q8, k)[1], one.topk_device(q8, k)[1]))
        self.counts["cosine_topk"] += cosine_topk.launches - before
        ms = ms_in_turns({"one_device": lambda: one.topk_device(q8, k),
                          "sharded_dp2": lambda: sharded.topk_device(q8, k)}, 20)
        del one, sharded
        t0 = time.perf_counter()
        ivf, peak = device_peak_bytes(lambda: IVFCatalogIndex(
            cat, nlist=IVF_1M_NLIST, kmeans_iters=IVF_KMEANS_ITERS, mesh=mesh2))
        build_s = time.perf_counter() - t0
        ids = ivf._bucket_ids[ivf._bucket_ids >= 0]
        one_bucket = ids.numel() == len(cat) and torch.unique(ids).numel() == len(cat)
        ivf.nprobe = 8
        got = torch.cat([ivf.topk_device(q_all[lo : lo + BATCH], k)[1]
                         for lo in range(0, len(q_all), BATCH)])
        recall = recall_at(got.cpu().numpy(), ivf_1m["exact_ids"])
        out = {
            "sharded_1m_b8": {"ids_equal_one_device": same, "device_ms": ms},
            "ivf_mesh_1m": {
                "seconds": build_s, "by_stage_s": ivf.build_s, "peak_device_bytes": peak,
                "one_bucket_per_row": one_bucket, "recall_at_10_nprobe_8": recall,
                "one_device_recall_at_10_nprobe_8": ivf_1m["recall_nprobe_8"],
                "one_device_by_stage_s": ivf_1m["build_s"],
            },
        }
        log(f"multi-GPU at 1M x 384 ({self.smi}): {json.dumps(out)}")
        smoke.check(same, "ShardedCatalogIndex dp=2 at 1M, B=8: the one-device index's ids")
        smoke.check(one_bucket, "IVF mesh build at 1M: every row in exactly one bucket")
        smoke.check(abs(recall - ivf_1m["recall_nprobe_8"]) <= MESH_RECALL_TOL,
                    f"IVF mesh build at 1M: recall@10 at nprobe 8 {recall:.4f}, the one-device "
                    f"build's {ivf_1m['recall_nprobe_8']:.4f} (within {MESH_RECALL_TOL})")
        del ivf, cat, q_all
        torch.cuda.empty_cache()
        return out

    # ------------------------------------------------------------ process mesh

    def process_mesh(self) -> dict:
        import torch.multiprocessing as mp

        smoke = self.smoke
        work = self.workdir / "ranks"
        work.mkdir(parents=True, exist_ok=True)
        inputs = {
            "data": self.minilm.data,
            "minilm_untrained": str(self.minilm.workdir / "untrained" / "final"),
            "mpnet_untrained": str(self.mpnet.workdir / "untrained" / "final"),
        }
        torch.save(inputs, work / "inputs.pt")
        t0 = time.perf_counter()
        ctx = mp.start_processes(multi_gpu_rank, args=(2, str(work)), nprocs=2, join=False,
                                 start_method="spawn")
        deadline = time.monotonic() + MULTI_GPU_TIMEOUT_S
        while not ctx.join(timeout=max(1.0, deadline - time.monotonic())):
            if time.monotonic() > deadline:
                for p in ctx.processes:
                    p.kill()
                raise RuntimeError(f"phase 5b's gloo ranks outlived {MULTI_GPU_TIMEOUT_S} s")
        ranks = [json.loads((work / f"rank{r}.json").read_text()) for r in range(2)]
        out = {"seconds": time.perf_counter() - t0,
               "note": "two ranks share one card; collectives through gloo"}
        grads = [torch.load(work / f"grads{r}.pt", weights_only=False) for r in range(2)]
        out["dp"] = self.check_dp(ranks, grads)
        out["tp"] = self.check_tp(ranks, grads)
        for name in ("fused_encoder_layer", "fused_encoder_layer_train",
                     "fused_encoder_layer_backward", "masked_mean_pool_l2norm", "cosine_topk",
                     "multi_head_attention", "multi_head_attention_backward"):
            self.counts[name] = self.counts.get(name, 0) + sum(
                r[part]["launches"][name] for r in ranks for part in ("dp", "tp")
            )
        return out

    def reference(self, phase, seq: int) -> tuple[list[float], dict]:
        """The one-process TrainStep at B=64 (kernels) from the same tower on
        the same batches: three losses and the first step's gradients."""
        from instacart_next_order_recommendation_tpu_torch.train.trainer import (
            TrainStep,
            build_optimizer,
            param_leaves,
        )

        params, cfg, tok = phase.fresh_params()
        cfg = dataclasses.replace(cfg, hidden_dropout=0.0)
        leaves = dict(param_leaves(params))
        opt = build_optimizer(params, 0.0)
        first: dict = {}

        def keep_first(*_):
            if not first:
                first.update({n: t.grad.detach().cpu() for n, t in leaves.items()})

        opt.register_step_pre_hook(keep_first)
        step = TrainStep(params, cfg, opt, lambda count: STEP_CHECK_LR, loss_scale=30.0,
                         accum=1, device=self.dev)
        return [step(b, seed=0).item() for b in phase.batches(tok, seq, 64, 3)], first

    def held(self, what: str, runs: list, grads: list, ref: tuple, fault_limits: str) -> dict:
        """Losses and whole first-step gradients of the ranks' step runs, and
        of each planted fault, against the one-process reference, by phase
        4's limits, each reading the worst over the ranks. ``fault_limits``:
        ``"grads"`` (each fault must break the gradient limit) or ``"any"``
        (the loss or the gradient limit)."""
        ref_losses, ref_grads = ref

        def reading(losses: list, by_rank: list) -> dict:
            rel = {n: max(rel_err(g[n], ref_grads[n]) for g in by_rank)
                   for n in ref_grads if n != "layers/k_b"}
            worst = max(rel, key=rel.get)
            return {"loss_rel": max(abs(a - b) / abs(b)
                                    for rank in losses for a, b in zip(rank, ref_losses)),
                    "grad_rel": rel[worst], "grad_worst_leaf": worst}

        sound = reading([r["losses"] for r in runs], [g["sound"] for g in grads])
        faults = {name: reading([r["faults"][name]["losses"] for r in runs],
                                [g[name] for g in grads])
                  for name in runs[0]["faults"]}
        log(f"{what}: losses by rank {[r['losses'] for r in runs]} vs one process {ref_losses}; "
            f"{json.dumps(sound)}; planted faults {json.dumps(faults)}")
        self.smoke.check(sound["loss_rel"] <= STEP_LOSS_REL_TOL
                         and sound["grad_rel"] <= STEP_GRAD_REL_TOL,
                         f"{what}: 3 steps agree with the one-process trainer at B=64")
        broken = {
            name: f["grad_rel"] > STEP_GRAD_REL_TOL
            or (fault_limits == "any" and f["loss_rel"] > STEP_LOSS_REL_TOL)
            for name, f in faults.items()
        }
        self.smoke.check(all(broken.values()),
                         f"{what}: every planted fault breaks the "
                         f"{'gradient limit' if fault_limits == 'grads' else 'limits'}")
        return {"sound": sound, "planted_faults": faults, "ref_losses": ref_losses}

    def check_dp(self, ranks: list, grads: dict) -> dict:
        smoke = self.smoke
        runs = [r["dp"] for r in ranks]
        losses = np.asarray(runs[0]["losses"])
        steps = len(losses)
        head, tail = losses[:10].mean(), losses[-10:].mean()
        out = {
            "steps": steps, "seq": runs[0]["seq"],
            "train_s_per_rank": [r["seconds"] for r in runs],
            "step_ms_epoch": runs[0]["history"][0]["epoch_seconds"] / steps * 1e3,
            "step_ms_per_rank": [r["steps"]["step_ms"] for r in runs],
            "launches_per_rank": [r["launches"] for r in runs],
            "history": runs[0]["history"],
        }
        log(f"DP=2 MiniLM-L6 (two ranks share one card; collectives through gloo; "
            f"{self.smi}): {json.dumps(out)}")
        log("DP=2 per-step loss: " + " ".join(f"{v:.4f}" for v in losses))
        smoke.check(all(r["mesh"] == [2, 1] for r in runs) and runs[0]["seq"] == 256,
                    "DP=2: a (2, 1) process mesh; the pairs bucket to S=256")
        smoke.check(runs[0]["losses"] == runs[1]["losses"]
                    and runs[0]["history"] == runs[1]["history"],
                    "DP=2: both ranks hold the same losses and history")
        smoke.check(bool(np.isfinite(losses).all()) and tail < head,
                    f"DP=2: the loss falls (first 10 mean {head:.4f}, last 10 {tail:.4f})")
        smoke.check(all(r["launches"]["fused_encoder_layer_train"] == 12 * steps
                        and r["launches"]["fused_encoder_layer_backward"] == 12 * steps
                        for r in runs),
                    "DP=2: 12 K1-train and 12 K5 launches per rank per step")
        out_dirs = [Path(runs[0]["final_dir"]).parent, self.workdir / "ranks" / "dp_rank1"]
        smoke.check(any(out_dirs[0].iterdir()) and not out_dirs[1].exists(),
                    "DP=2: only rank 0's output directory holds files")
        from instacart_next_order_recommendation_tpu_torch.serve.recommender import Recommender

        corpus_path = self.minilm.workdir / "train_corpus.json"
        with torch.inference_mode():
            top = Recommender(runs[0]["final_dir"], corpus_path, use_index=False).recommend(
                next(iter(self.minilm.data[3].values())), top_k=10)
        smoke.check(len(top) == 10, "DP=2: final/ loads and serves in Recommender")
        out["three_steps"] = self.held("DP=2 MiniLM-L6", [r["steps"] for r in runs],
                                       [g["minilm-l6_S256"] for g in grads],
                                       self.reference(self.minilm, 256),
                                       "grads")
        return out

    def check_tp(self, ranks: list, grads: dict) -> dict:
        smoke = self.smoke
        runs = [r["tp"] for r in ranks]
        losses = runs[0]["losses"]
        steps = len(losses)
        hist = runs[0]["history"]
        out = {
            "steps": steps, "seq": runs[0]["seq"],
            "train_s_per_rank": [r["seconds"] for r in runs],
            "step_ms_epoch": [h["epoch_seconds"] / (steps / len(hist)) * 1e3 for h in hist],
            "step_ms_per_rank": [r["steps"]["step_ms"] for r in runs],
            "launches_per_rank": [r["launches"] for r in runs],
            "peak_device_bytes_per_rank": [r["peak_device_bytes"] for r in runs],
            "epoch_train_loss": [h["train_loss"] for h in hist], "losses": losses,
        }
        log(f"TP=2 mpnet-base-class (two ranks share one card; collectives through gloo; "
            f"{self.smi}): {json.dumps(out)}")
        smoke.check(all(r["mesh"] == [1, 2] for r in runs) and runs[0]["seq"] == 256,
                    "TP=2: a (1, 2) process mesh at S=256")
        smoke.check(bool(np.isfinite(losses).all()) and len(hist) == TP_EPOCHS
                    and hist[-1]["train_loss"] < hist[0]["train_loss"],
                    "TP=2: the loss falls over the epochs")
        smoke.check(all(r["launches"]["multi_head_attention"] == 24 * steps
                        and r["launches"]["multi_head_attention_backward"] == 24 * steps
                        and r["launches"]["fused_encoder_layer_train"] == 0
                        and r["launches"]["fused_encoder_layer_backward"] == 0
                        and r["launches"]["fused_encoder_layer"] == 0
                        for r in runs),
                    "TP=2: 24 K6 and 24 K7 launches per rank per step, no K1 or K5")
        out["three_steps"] = self.held(
            "TP=2 mpnet-base-class at S=200", [r["steps"] for r in runs],
            [g[f"mpnet-base_S{ATTENTION_TRAIN_SEQ}"] for g in grads],
            self.reference(self.mpnet, ATTENTION_TRAIN_SEQ), "any",
        )
        return out


WORKFLOW_USERS = 1_200  # phase 6 (a)'s CSVs: phase 4's users, real-length names (S=256)
WORKFLOW_PRODUCTS = 2_000
FEEDBACK_REQUESTS = 60  # /recommend calls a sample-feedback run sends
GATE_FAIL_MARGIN = 1.0  # NDCG@10 lies in [0, 1]: no run beats the deployed one by 1.0
GATE_PASS_MARGIN = -1.0  # and every run beats it less 1.0
WORKFLOW_WRAPPERS = ("fused_encoder_layer_train", "fused_encoder_layer_backward",
                     "fused_encoder_layer", "masked_mean_pool_l2norm", "cosine_topk")


class WorkflowsPhase:
    """Phase 6: the user workflows (``scripts/torch_*.py`` and the data
    prep's CLI), each run in this process through its ``main`` at MiniLM-L6's
    full width, with launch counts reset before and read after each one.
    (a) ``generate_instacart_csvs`` and ``python -m ..._torch.data``'s
    ``main``, the artifacts' contracts checked; (b) ``torch_run_demo.main``
    at its defaults (500 users, 800 products, 3 epochs, B=32, S=128), its
    stages' launches read through wrappers that count around them; (c) the
    feedback loop on the demo's model: ``create_app`` on a local port,
    ``torch_generate_sample_feedback``, ``torch_feedback_analytics`` and two
    ``torch_feedback_retrain --once`` ticks, the first with a gate no run can
    pass, the second with one every run passes: the served model's signature
    moves only after the second, and /recommend then answers the new
    tower's direct recommend; (d) ``torch_compare_untrained_vs_trained`` on
    the demo's data and model; (e) ``torch_real_data_run`` on (a)'s CSVs,
    warm-started from phase 4b's HF directory, one epoch at B=64, S=256,
    its results file written inside the temporary directory."""

    def __init__(self, smoke: "Smoke", workdir: Path, smi: str, serving: dict, hf_dir: Path):
        self.smoke, self.smi, self.hf_dir = smoke, smi, hf_dir
        self.root = workdir / "workflows"
        self.root.mkdir(parents=True)
        self.tol = serving["batcher"]["near_tie_tol"]
        self.counts: dict[str, int] = dict.fromkeys(WORKFLOW_WRAPPERS, 0)
        self.seconds: dict[str, float] = {}

    def counted(self, what: str, fn, *args, **kwargs):
        """``fn(*args, **kwargs)`` with every kernel wrapper counted from
        zero; returns its result, the launches by wrapper, and its stdout
        (echoed). Adds the launches to the phase's totals."""
        wrappers = {w.__name__: w for w in training_wrappers()}
        for w in wrappers.values():
            w.launches = 0
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            result = fn(*args, **kwargs)
        self.seconds[what] = time.perf_counter() - t0
        counts = {name: w.launches for name, w in wrappers.items()}
        for name in WORKFLOW_WRAPPERS:
            self.counts[name] += counts[name]
        print(buf.getvalue(), end="", flush=True)
        log(f"{what}: {self.seconds[what]:.1f}s, launches {json.dumps(counts)}")
        return result, counts, buf.getvalue()

    def run(self) -> dict:
        env = {"RATE_LIMIT": "1000000/minute"}
        unset = ("INFERENCE_DEVICE", "BATCH_WINDOW_MS", "API_KEY", "ITOR_TOPK_EXTRACTION",
                 "PRECOMPILE_ON_STARTUP", "MODEL_DIR", "CORPUS_PATH", "FEEDBACK_DB_PATH",
                 "STORE_REQUEST_CONTEXTS", "ITOR_PROFILE_DIR", "ITOR_LOOP_TIMING")
        out: dict = {}
        with mock.patch.dict(os.environ, env):
            for name in unset:
                os.environ.pop(name, None)
            out["prep"] = self.prep()
            out["demo"] = self.demo()
            out["feedback_loop"] = self.feedback_loop()
            out["compare"] = self.compare()
            out["runbook"] = self.runbook()
        out["seconds"] = self.seconds
        out["launches"] = self.smoke.launches_6 = self.counts
        log(f"workflows {json.dumps(out)} ({self.smi})")
        return out

    def prep(self) -> dict:
        """(a) The CSVs, then the data prep's CLI with a YAML config."""
        from instacart_next_order_recommendation_tpu_torch.data.prepare import main as prep_main
        from instacart_next_order_recommendation_tpu_torch.data.synthetic import (
            generate_instacart_csvs,
        )

        smoke = self.smoke
        t0 = time.perf_counter()
        self.csv_dir = generate_instacart_csvs(
            self.root / "csvs", n_users=WORKFLOW_USERS, n_products=WORKFLOW_PRODUCTS, seed=0,
            long_names=True,
        )
        self.seconds["csvs"] = time.perf_counter() - t0
        # The runbook (e) reads the prep from <workdir>/processed/p5_mp20_ef0.1.
        self.runbook_ws = self.root / "runbook"
        config = self.root / "data_prep.yaml"
        config.write_text(json.dumps({"data_dir": str(self.csv_dir),
                                      "output_dir": str(self.runbook_ws / "processed")}))
        rc, counts, _ = self.counted("(a) python -m ..._torch.data", prep_main,
                                     ["--config", str(config)])
        processed = self.runbook_ws / "processed" / "p5_mp20_ef0.1"
        queries = json.loads((processed / "eval_queries.json").read_text())
        corpus = json.loads((processed / "eval_corpus.json").read_text())
        relevant = json.loads((processed / "eval_relevant_docs.json").read_text())
        params = json.loads((processed / "data_prep_params.json").read_text())
        smoke.check(rc == 0 and (processed / "train_dataset").is_dir()
                    and (processed / "eval_dataset").is_dir() and sum(counts.values()) == 0,
                    "(a) the data prep's CLI wrote p5_mp20_ef0.1 (datasets and JSON artifacts)")
        smoke.check(
            len(corpus) == WORKFLOW_PRODUCTS and set(relevant) == set(queries)
            and all(pid in corpus for docs in relevant.values() for pid in docs),
            "(a) every relevant doc is in the corpus",
        )
        smoke.check(
            bool(queries) and not any("next order" in q.lower() or "next:" in q.lower()
                                      for q in queries.values()),
            "(a) no eval query holds the next order (serve-time queries)",
        )
        return {"params": params, "csv_s": self.seconds["csvs"]}

    def demo(self) -> dict:
        """(b) ``torch_run_demo.main`` at its defaults, stage by stage."""
        from scripts import torch_run_demo

        smoke = self.smoke
        stages: dict[str, dict] = {}

        def watched(name, fn):
            def run(*args, **kwargs):
                before = {w.__name__: w.launches for w in training_wrappers()}
                t0 = time.perf_counter()
                result = fn(*args, **kwargs)
                stages[name] = {
                    "seconds": time.perf_counter() - t0,
                    "launches": {w.__name__: w.launches - before[w.__name__]
                                 for w in training_wrappers()},
                }
                return result
            return run

        patches = [mock.patch.object(torch_run_demo, name, watched(name, getattr(torch_run_demo, name)))
                   for name in ("stage_data", "stage_train", "stage_recommend", "stage_api")]
        with contextlib.ExitStack() as stack:
            for p in patches:
                stack.enter_context(p)
            rc, counts, text = self.counted(
                "(b) torch_run_demo.main", torch_run_demo.main,
                ["--workdir", str(self.root / "demo"), "--port", "0"],
            )
        steps = int(re.search(r"trained (\d+) steps", text).group(1))
        self.demo_processed = self.root / "demo" / "processed" / "p5_mp20_ef0.15"
        self.demo_final = self.root / "demo" / "model" / "final"
        best = json.loads((self.root / "demo" / "model" / "best.json").read_text())
        history = json.loads((self.root / "demo" / "model" / "eval_history.json").read_text())
        train, rec, api = (stages[n]["launches"] for n in ("stage_train", "stage_recommend",
                                                           "stage_api"))
        out = {"steps": steps, "ndcg_at_10": best["entry"]["ndcg_at_10"],
               "best_epoch": best["best_epoch"],
               "epoch_seconds": [h["epoch_seconds"] for h in history],
               "stages_s": {n: v["seconds"] for n, v in stages.items()},
               "stage_launches": {n: v["launches"] for n, v in stages.items()}}
        log(f"(b) demo: {steps} steps, NDCG@10 {out['ndcg_at_10']:.4f} (epoch "
            f"{out['best_epoch']}), stages {json.dumps(out['stages_s'])} ({self.smi})")
        smoke.check(rc == 0 and "Demo complete." in text
                    and "POST /recommend -> 200, 3 items" in text
                    and "POST /feedback  -> 202" in text, "(b) the demo ran its five stages")
        smoke.check(
            steps > 0 and train["fused_encoder_layer_train"] == 12 * steps
            and train["fused_encoder_layer_backward"] == 12 * steps
            and counts["fused_encoder_layer_train"] == 12 * steps
            and train["masked_mean_pool_l2norm"] > 0,
            f"(b) demo training: 12 K1-train and 12 K5 launches a step ({steps} steps), K2",
        )
        smoke.check(
            all(stage["fused_encoder_layer"] >= 6 and stage["masked_mean_pool_l2norm"] > 0
                and stage["cosine_topk"] > 0 for stage in (rec, api))
            and all(stage["fused_encoder_layer_train"] == 0 for stage in (rec, api)),
            "(b) demo recommend and HTTP stages: K1, K2 and K3 launched",
        )
        return out

    def served_state(self, app, client, query: str):
        rec = app.state["recommender"]
        status, body = client.post("/recommend", {"user_context": query, "top_k": 10})
        assert status == 200, body
        return (str(app.state["model_dir"]), rec._model_signature), ranked(body)

    def feedback_loop(self) -> dict:
        """(c) Sample feedback, analytics and two retrain ticks against the
        demo's model served by ``create_app`` on a local port."""
        from scripts import (
            torch_feedback_analytics,
            torch_feedback_retrain,
            torch_generate_sample_feedback,
        )

        from instacart_next_order_recommendation_tpu_torch.api.app import create_app
        from instacart_next_order_recommendation_tpu_torch.serve import MonitoredRecommender

        smoke, root = self.smoke, self.root / "feedback"
        root.mkdir()
        db = root / "feedback.db"
        os.environ["FEEDBACK_DB_PATH"] = str(db)
        corpus_path = self.demo_processed / "eval_corpus.json"
        query = next(iter(json.loads((self.demo_processed / "eval_queries.json").read_text())
                          .values()))
        deployed = json.loads((self.demo_final.parent / "best.json").read_text())["entry"]
        state = root / "retrain_state.json"
        state.write_text(json.dumps({"last_event_id": 0, "runs": 0,
                                     "deployed_metric": deployed["ndcg_at_10"]}))
        train_config = root / "train.json"  # YAML is a superset of JSON
        train_config.write_text(json.dumps({
            "model_name": str(self.demo_final), "output_dir": str(root / "runs"), "epochs": 1,
            "train_batch_size": 32, "eval_batch_size": 128, "max_seq_length": 128,
            "learning_rate": 2e-4, "logging_steps": 50,
        }))
        out: dict = {}
        served = ServedApp(create_app(self.demo_final, corpus_path))
        try:
            gen_config = root / "generate.json"
            gen_config.write_text(json.dumps({"url": f"http://127.0.0.1:{served.port}",
                                              "num_requests": FEEDBACK_REQUESTS, "seed": 0}))
            # Eval user ids from the demo's prep, as from a checkout's processed/.
            with mock.patch.object(torch_generate_sample_feedback, "DEFAULT_PROCESSED_DIR",
                                   self.demo_processed.parent):
                rc_gen, gen_counts, gen_text = self.counted(
                    "(c) torch_generate_sample_feedback.main",
                    torch_generate_sample_feedback.main, ["--config", str(gen_config)],
                )
                fa_config = root / "analytics.json"
                fa_config.write_text(json.dumps({"db_path": str(db), "show_funnel_sample": 3}))
                rc_fa, _, fa_text = self.counted(
                    "(c) torch_feedback_analytics.main", torch_feedback_analytics.main,
                    ["--config", str(fa_config)],
                )
                conn = sqlite3.connect(db)
                n_imp = conn.execute("SELECT COUNT(DISTINCT request_id || '/' || product_id) "
                                     "FROM feedback_events WHERE event_type = 'impression'"
                                     ).fetchone()[0]
                n_contexts = conn.execute("SELECT COUNT(*) FROM request_contexts").fetchone()[0]
                conn.close()
                smoke.check(
                    rc_gen == 0 and rc_fa == 0
                    and f"request {FEEDBACK_REQUESTS}/{FEEDBACK_REQUESTS}:" in gen_text
                    and f"Impressions (unique request+product): {n_imp:,}" in fa_text
                    and n_imp >= FEEDBACK_REQUESTS and n_contexts >= FEEDBACK_REQUESTS
                    and gen_counts["cosine_topk"] >= FEEDBACK_REQUESTS
                    and gen_counts["fused_encoder_layer"] > 0,
                    f"(c) {FEEDBACK_REQUESTS} recommends with their contexts stored and their "
                    "funnel events, read back by the analytics",
                )
                before, answer_before = self.served_state(served.app, served.client, query)
                url = f"http://127.0.0.1:{served.port}"
                tick = ["--processed-dir", str(self.demo_processed), "--train-config",
                        str(train_config), "--state-file", str(state), "--once",
                        "--serve-url", url, "--min-new-events", "1"]
                rc1, c1, _ = self.counted(
                    "(c) torch_feedback_retrain.main (gate fails)", torch_feedback_retrain.main,
                    [*tick, "--min-improvement", str(GATE_FAIL_MARGIN)],
                )
                run1 = json.loads(state.read_text())
                after_fail, answer_fail = self.served_state(served.app, served.client, query)
                self.counted("(c) torch_generate_sample_feedback.main (second batch)",
                             torch_generate_sample_feedback.main, ["--config", str(gen_config)])
                rc2, c2, _ = self.counted(
                    "(c) torch_feedback_retrain.main (gate passes)", torch_feedback_retrain.main,
                    [*tick, "--min-improvement", str(GATE_PASS_MARGIN)],
                )
                run2 = json.loads(state.read_text())
                after_pass, answer_pass = self.served_state(served.app, served.client, query)
        finally:
            served.stop()
        gates = []
        for run, margin in ((run1, GATE_FAIL_MARGIN), (run2, GATE_PASS_MARGIN)):
            best = json.loads((root / "runs" / f"run-{run['last_event_id']}" / "best.json")
                              .read_text())
            gates.append({"ndcg_at_10": best["entry"]["ndcg_at_10"], "margin": margin,
                          "deployed_before": deployed["ndcg_at_10"]})
        new_model = Path(run2.get("deployed_model", ""))
        want = MonitoredRecommender(new_model, corpus_path, use_index=False).recommend(
            query, top_k=10
        )
        out.update({"impressions": n_imp, "contexts": n_contexts, "gate": gates,
                    "fb_dataset": str(self.demo_processed.name) + "_fb"})
        log(f"(c) retrain gate: run 1 NDCG@10 {gates[0]['ndcg_at_10']:.4f} against "
            f"{gates[0]['deployed_before']:.4f} + {GATE_FAIL_MARGIN}: not deployed; run 2 "
            f"{gates[1]['ndcg_at_10']:.4f} against {gates[1]['deployed_before']:.4f} "
            f"{GATE_PASS_MARGIN:+}: deployed ({self.smi})")
        smoke.check(rc1 == 0 and rc2 == 0 and run1["runs"] == 1 and run2["runs"] == 2,
                    "(c) two retrain ticks ran")
        smoke.check(
            (self.demo_processed.parent / f"{self.demo_processed.name}_fb" / "train_dataset")
            .is_dir() and all(c["fused_encoder_layer_train"] > 0
                              and c["fused_encoder_layer_train"] == c["fused_encoder_layer_backward"]
                              and c["fused_encoder_layer_train"] % 12 == 0 for c in (c1, c2)),
            "(c) each tick built the _fb dataset and trained on K1-train and K5 (12 a step)",
        )
        smoke.check(after_fail == before and answer_fail == answer_before
                    and "deployed_model" not in run1,
                    "(c) a failed gate leaves the served model (signature and answer) as it was")
        smoke.check(
            after_pass != before and after_pass[0] == str(new_model)
            and new_model.parent.name == f"run-{run2['last_event_id']}"
            and run2["deployed_metric"] == gates[1]["ndcg_at_10"],
            "(c) the passing gate hot-swapped the served model to the new final/",
        )
        smoke.check(near_tie_ok(answer_pass, want, self.tol) and answer_pass != answer_before,
                    "(c) after the swap /recommend answers the new tower's direct recommend "
                    "(near-tie rule)")
        return out

    def compare(self) -> dict:
        """(d) The collapse diagnostics on the demo's data and model."""
        from scripts import torch_compare_untrained_vs_trained

        config = self.root / "compare.json"
        config.write_text(json.dumps({"processed_dir": str(self.demo_processed),
                                      "model_dir": str(self.demo_final), "batch_size": 64}))
        rc, counts, text = self.counted(
            "(d) torch_compare_untrained_vs_trained.main",
            torch_compare_untrained_vs_trained.main, ["--config", str(config)],
        )
        readings = {
            f"{who.lower()}_{what.replace(' ', '_')}": float(v)
            for who, what, v in re.findall(
                r"(Untrained|Trained)\s+(query mean pairwise cos_sim|corpus mean pairwise cos_sim"
                r"|corpus mean std per dim):\s+([-\d.]+)", text)
        }
        self.smoke.check(
            rc == 0 and len(readings) == 6 and "NDCG@10 delta" in text
            and all(counts[k] > 0 for k in ("fused_encoder_layer", "masked_mean_pool_l2norm",
                                            "cosine_topk")),
            "(d) the collapse indicators printed for both towers; K1, K2 and K3 launched",
        )
        log(f"(d) collapse indicators {json.dumps(readings)}")
        return readings

    def runbook(self) -> dict:
        """(e) The real-data runbook on (a)'s CSVs from phase 4b's HF directory."""
        from scripts import torch_real_data_run

        results = self.root / "REAL_RESULTS.md"
        with logged_messages(TRAINER_LOGGER) as messages:
            rc, counts, text = self.counted(
                "(e) torch_real_data_run.main", torch_real_data_run.main,
                ["--data-dir", str(self.csv_dir), "--base-model", str(self.hf_dir),
                 "--workdir", str(self.runbook_ws), "--epochs", "1", "--train-batch-size", "64",
                 "--max-seq-length", "256", "--results", str(results)],
            )
        seq = [int(m.group(1)) for msg in messages
               if (m := re.search(r"padded seq len (\d+)", msg))]
        history = json.loads((self.runbook_ws / "model" / "eval_history.json").read_text())
        vocab = json.loads((self.hf_dir / "config.json").read_text())["vocab_size"]
        self.smoke.check(
            rc == 0 and results.is_file() and "| ndcg_at_10 |" in results.read_text()
            and "skipping prep" in text and "Item-item CF (ours / ref)" in text
            and seq == [256] and len(history) == 1
            and counts["fused_encoder_layer_train"] > 0
            and counts["fused_encoder_layer_train"] == counts["fused_encoder_layer_backward"]
            and all(counts[k] > 0 for k in ("fused_encoder_layer", "masked_mean_pool_l2norm",
                                            "cosine_topk")),
            "(e) the runbook ran on (a)'s prep at S=256 (K1-train, K5, K1, K2, K3) and wrote "
            "its table",
        )
        out = {"history": history, "vocab": vocab, "seq": seq,
               "base_model": self.hf_dir.name}
        log(f"(e) runbook (random-weight HF tower, vocab {vocab}; not a parity run): "
            f"{json.dumps(history)}")
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
    t_start = t0 = time.perf_counter()
    logs = _build.build()  # nvcc's output, this build's or the one kept beside a library
    log(f"build in {time.perf_counter() - t0:.1f}s")
    for name, text in logs.items():
        for line in text.splitlines():
            if "Used" in line or "spill" in line and "0 bytes spill" not in line:
                log(f"  ptxas {name}: {line.strip()}")
    usage = _build.ptxas_usage(logs["attention"])
    log(f"ptxas (registers, spill stores) of the attention kernels: {json.dumps(usage)}")
    on_path = [spill for key, (_, spill) in usage.items() if re.search(r"<(32|64)[,>]", key)]
    smoke.check(
        bool(on_path) and not any(on_path),
        "no ptxas spills in the attention kernels at head_dim 32 and 64",
    )
    usage = _build.ptxas_usage(logs["topk"])
    log(f"ptxas (registers, spill stores) of the topk kernels: {json.dumps(usage)}")
    smoke.check(
        set(TOPK_KERNELS) <= set(usage) and not any(spill for _, spill in usage.values()),
        "every topk kernel (K3/K4, each query tile and list size) in ptxas's report, none spilling",
    )
    usage = _build.ptxas_usage(logs["pool_norm"])
    log(f"ptxas (registers, spill stores) of the pool_norm kernels: {json.dumps(usage)}")
    smoke.check(
        set(POOL_KERNELS) <= set(usage) and not any(spill for _, spill in usage.values()),
        "every pool_norm kernel (K2, each load width, rows in flight and form) in ptxas's "
        "report, none spilling",
    )
    for name in ("fused_layer", "fused_layer_bwd"):
        usage = _build.ptxas_usage(logs[name])
        log(f"ptxas (registers, spill stores) of the {name} kernels: {json.dumps(usage)}")
        smoke.check(
            set(FUSED_LAYER_KERNELS[name]) <= {key.split("<")[0] for key in usage}
            and set(FUSED_LAYER_ATTENTION[name]) <= set(usage)
            and not any(spill for _, spill in usage.values()),
            f"every {name} kernel in ptxas's report (head_dim 32 and 64), none spilling",
        )

    try:
        t0 = time.perf_counter()
        hd64_seqs = (32, 64, 128, 192, 256)
        with torch.inference_mode():
            smoke.compare_kernels(dev)
            smoke.compare_forward_kernels(  # timed at the mpnet serve batch's shape
                dev, MPNET_WIDTHS, (1, 64, 256), hd64_seqs, torch.Generator().manual_seed(12),
                timed={(BATCH, 192)},
            )
        smoke.compare_train_kernels(
            dev, MINILM_WIDTHS, (1, 64, 512), (32, 64, 128, 256), seed=2,
            traced={(64, 256), (512, 256)},
        )
        smoke.compare_train_kernels(  # timed and traced at the mpnet training batch's shape
            dev, MPNET_WIDTHS, (1, 64, 256), hd64_seqs, seed=12,
            timed={(64, 256)}, traced={(64, 256)},
        )
        smoke.compare_attention_kernels(dev)
        smoke.time_topk(dev)
        smoke.compare_packed_topk(dev)
        smoke.compare_bf16_topk(dev)
        log(f"phase 2 (kernels vs plain) {time.perf_counter() - t0:.1f}s")
        build_root = REPO / "build"
        build_root.mkdir(exist_ok=True)
        with tempfile.TemporaryDirectory(prefix="chip_smoke_", dir=build_root) as tmp:
            t0 = time.perf_counter()
            with torch.inference_mode():
                smoke.serve(dev, Path(tmp))
            log(f"phase 3 (serve path) {time.perf_counter() - t0:.1f}s")
            t0 = time.perf_counter()
            serving = ServingTierPhase(smoke, dev, Path(tmp)).run()
            log(f"phase 3c (serving tier) {time.perf_counter() - t0:.1f}s")
            t0 = time.perf_counter()
            HttpApiPhase(smoke, dev, Path(tmp), serving).run()
            log(f"phase 3d (HTTP API) {time.perf_counter() - t0:.1f}s")
            t0 = time.perf_counter()
            smoke.serve_mpnet(dev, Path(tmp))
            smoke.repaired_shapes(dev)
            smoke.serve_packed(dev)
            log(f"phase 3b (mpnet serve, repaired shapes, packed serve) "
                f"{time.perf_counter() - t0:.1f}s")
            t0 = time.perf_counter()
            IvfPhase(smoke, dev, Path(tmp), smi).run()
            log(f"phase 3e (IVF and the bf16 catalog) {time.perf_counter() - t0:.1f}s ({smi})")
            # Phase 4's users; phase 4b trains from an HF directory on their
            # pairs before phase 4's first train() (torch.profiler has
            # dropped kernel records in traces taken after one), and runs
            # the baselines on them after it, with phase 4's trained tower.
            synthetic = synthetic_users(np.random.default_rng(1))
            data = build_training_data(synthetic)
            t0 = time.perf_counter()
            hf_phase = HfBaselinesPhase(smoke, dev, Path(tmp), serving, synthetic, data, smi)
            hf = hf_phase.towers()
            t_hf = time.perf_counter() - t0
            log(f"phase 4b (HF towers, /admin/model, warm start with tracing) {t_hf:.1f}s "
                f"({smi})")
            t0 = time.perf_counter()
            minilm = TrainPhase(smoke, dev, Path(tmp), data=data)
            train = minilm.run()
            log("train " + json.dumps(train))
            log(f"phase 4 (training) {time.perf_counter() - t0:.1f}s")
            t0 = time.perf_counter()
            hf["baselines"] = hf_phase.baselines(str(minilm.workdir / "trained" / "final"))
            t_hf += time.perf_counter() - t0
            log("HF towers and baselines " + json.dumps(hf))
            log(f"phase 4b (baselines) {time.perf_counter() - t0:.1f}s; phase 4b in all "
                f"{t_hf:.1f}s ({smi})")
            t0 = time.perf_counter()
            mpnet = MpnetTrainPhase(smoke, dev, Path(tmp), data=minilm.data)
            train_mpnet = mpnet.run()
            log("mpnet train " + json.dumps(train_mpnet))
            log(f"phase 5 (mpnet training) {time.perf_counter() - t0:.1f}s")
            t0 = time.perf_counter()
            MultiGpuPhase(smoke, dev, Path(tmp), smi, minilm, mpnet).run()
            log(f"phase 5b (multi-GPU on one card) {time.perf_counter() - t0:.1f}s ({smi})")
            t0 = time.perf_counter()
            WorkflowsPhase(smoke, Path(tmp), smi, serving, hf_phase.root / hf["dirs"][-1]).run()
            log(f"phase 6 (workflows) {time.perf_counter() - t0:.1f}s ({smi})")
    except Exception:  # noqa: BLE001 - report the failure and exit non-zero
        traceback.print_exc()
        smoke.failures.append("exception")

    for h, readings in smoke.pool_rows.items():
        for r in readings:
            log(f"K2 H={h} B,S={r['shape'][:2]}: form {r['form']}, cold {r['ms']:.5f} ms "
                f"(bound share {r['bound_share_cold']:.3f}), warm {r['warm_ms']:.5f}, "
                f"yardstick cold {r['yardstick_n_calls_ms']:.5f} / warm "
                f"{r['yardstick_n_calls_warm_ms']:.5f}, plain {r['plain_ms']:.5f}, "
                f"host {r['host_us']:.1f} us a call")
    log(f"total {time.perf_counter() - t_start:.1f}s")
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
        "fused_encoder_layer_hd64": ("fused_layer.cu", "ops/fused_layer.py:135"),
        "fused_encoder_layer_train_hd64": ("fused_layer.cu", "ops/fused_layer.py:135"),
        "fused_encoder_layer_backward_hd64": ("fused_layer_bwd.cu", "ops/fused_layer.py:718"),
        "cosine_topk_packed": ("topk.cu", "ops/topk.py:75"),
        "cosine_topk_bf16": ("topk.cu", "ops/topk.py:154"),
        "cosine_topk_packed_bf16": ("topk.cu", "ops/topk.py:75"),
        "multi_head_attention": ("attention.cu", "ops/attention.py:62"),
        "multi_head_attention_backward": ("attention.cu", "ops/attention.py:164"),
    }
    for name, (src, tpu) in sources.items():
        rows.append({
            "name": name,
            "route": "cuda",
            "source": f"{PKG}/ops/csrc/{src}",
            "replaces": f"{JAX_PKG}/{tpu}",
            **smoke.kernel_rows[name],
            "launches_phase_5b": smoke.launches_5b.get(name, 0),
            "launches_phase_6": smoke.launches_6.get(name, 0),
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
