"""Serve-path warm-up over the serve shape lattice.

Counterpart of the JAX package's ``serve/precompile.py``. There, the first
request of each (batch, seq, k) shape pays an XLA compile, so the lattice is
compiled ahead of traffic. The port has no per-shape program to compile: its
kernels are the libraries ``ops/_build.py`` builds under ``build/kernels/``,
one per source. What a fresh process still pays on first use is the build
(or load) of those libraries, and each shape's first launch: the kernels'
shared-memory and cluster attributes, and the caching allocator's first
blocks of each size. ``warm_serve_shapes`` pays both before traffic.

Two uses:
- **Deploy hooks**: ``python -m
  instacart_next_order_recommendation_tpu_torch.serve.precompile --config
  configs/inference.yaml`` builds the kernel libraries into ``build/`` and
  runs the lattice once.
- **Startup**: a server warms the lattice right after the model loads,
  before it reports ready.
"""

from __future__ import annotations

import argparse
import logging
import time
from pathlib import Path

import numpy as np
import torch

logger = logging.getLogger(__name__)

# The shape lattice the serve path can hit — the SINGLE source of truth:
# request top-k rounds up to K_BUCKETS (recommender._k_bucket, also used by
# the micro-batcher) and micro-batches round up to BATCH_BUCKETS rows
# (serve/batching imports both from here, so the warm-up always covers
# every shape the serve path can dispatch).
K_BUCKETS = (16, 32, 64, 128, 256)
BATCH_BUCKETS = (1, 2, 4, 8, 16, 32, 64)


def warm_serve_shapes(
    recommender,
    k_buckets: tuple[int, ...] = K_BUCKETS,
    batch_buckets: tuple[int, ...] = (1,),
    with_filters: bool = True,
) -> int:
    """Run every (batch, seq, k) serve shape once; returns the shape count.

    The lattice is the JAX package's: each batch bucket encoded at every
    length bucket up to the tower's ``max_seq_length``; the top-k at each
    batch bucket and each k a request can dispatch (``K_BUCKETS`` capped at
    the catalog size), with and without a candidate mask; and the fused
    ids -> top-k pipeline at batch 1 only (lone requests and the
    micro-batcher's lone drains; coalesced drains encode and rank in two
    calls). ``batch_buckets`` beyond 1 matter only when micro-batching is
    on. On the card, the kernel libraries are built first.

    The shapes run one after another: there is no compiler whose work
    threads could overlap, and concurrent launches would only queue on the
    card.
    """
    from instacart_next_order_recommendation_tpu_torch.tokenizer.wordpiece import (
        LENGTH_BUCKETS,
    )

    if not all(hasattr(recommender, a) for a in ("encoder", "index", "product_ids")):
        return 0  # test doubles / custom recommenders: nothing to warm
    enc = recommender.encoder
    on_card = enc.device.type == "cuda"
    t0 = time.time()
    if on_card:
        from instacart_next_order_recommendation_tpu_torch.ops import _build

        _build.build()
    n = len(recommender.product_ids)
    max_seq = enc.max_seq_length
    seq_buckets = tuple(s for s in LENGTH_BUCKETS if s <= max_seq) or (max_seq,)
    dummy = "Product: warmup. Aisle: warmup. Department: warmup."

    # k values a request can actually dispatch (request top-k rounds up to
    # K_BUCKETS and is capped at the catalog size).
    k_effs: list[int] = []
    for k in k_buckets:
        k_effs.append(min(k, n))
        if k_effs[-1] == n:
            break

    def tokenize(b: int, s_len: int):
        return enc.tokenizer.encode_batch(
            [dummy] * b, max_seq_length=max_seq, pad_to=s_len, pad_batch_to=b
        )

    n_shapes = 0
    with torch.inference_mode():
        for b in batch_buckets:
            emb = None
            for s_len in seq_buckets:
                ids, _ = tokenize(b, s_len)
                out = enc._run_encode(enc.upload_ids(ids))
                if emb is None:  # the top-k shapes below depend on (b, k), not seq
                    emb = out
                n_shapes += 1
            for k_eff in k_effs:
                recommender.index.topk(emb, k_eff)
                n_shapes += 1
                if with_filters and hasattr(recommender.index, "topk_device"):
                    recommender.index.topk(emb, k_eff, candidate_mask=np.ones(n, np.int32))
                    n_shapes += 1
        fused = getattr(recommender, "_fused", None)
        if fused is not None and 1 in batch_buckets:
            for s_len in seq_buckets:
                for k_eff in k_effs:
                    ids, mask = tokenize(1, s_len)
                    fused.topk(ids, mask, k_eff)
                    n_shapes += 1
    if on_card:
        torch.cuda.synchronize(enc.device)
    logger.info(
        "warmed %d serve shapes (%d batch x %d seq x %d k) in %.1fs",
        n_shapes,
        len(batch_buckets),
        len(seq_buckets),
        len(k_effs),
        time.time() - t0,
    )
    return n_shapes


def main() -> None:
    from instacart_next_order_recommendation_tpu_torch.serve.recommender import (
        InferenceConfig,
        Recommender,
        apply_inference_device_override,
    )
    from instacart_next_order_recommendation_tpu_torch.utils.logging import (
        setup_colored_logging,
    )

    parser = argparse.ArgumentParser(description="Warm the serve shape lattice")
    parser.add_argument("--config", type=Path, default=None, help="Inference YAML")
    parser.add_argument(
        "--batching", action="store_true",
        help="Also warm micro-batch shapes (BATCH_WINDOW_MS deployments).",
    )
    args = parser.parse_args()
    setup_colored_logging()
    device = apply_inference_device_override()

    cfg = InferenceConfig.load(args.config)
    rec = Recommender(
        model_dir=cfg.model_dir,
        corpus_path=cfg.corpus,
        use_index=cfg.use_index,
        topk_extraction=cfg.topk_extraction,
        device=device,
    )
    batches = BATCH_BUCKETS if args.batching else (1,)
    n = warm_serve_shapes(rec, batch_buckets=batches)
    print(f"warmed {n} serve shapes; kernel libraries built")


if __name__ == "__main__":
    main()
