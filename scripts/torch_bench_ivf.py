#!/usr/bin/env python3
"""The IVF index on one NVIDIA GPU: recall@10 against the exact scan and
device milliseconds a batch, on a clustered 1M-product catalog.

The port's counterpart of ``scripts/bench_ivf.py``, with its generator
(points around 2,000 random unit centers, noise of norm 0.5), its sweep
(nlist 1024 at nprobe 4, 8 and 16; nlist 4096 at 16, 32 and 64;
``kmeans_iters=4``; bf16 buckets), its yardstick (the exact index on a
bf16 catalog, ``ShardedCatalogIndex(dtype="bfloat16")``: K3 on bf16 rows)
and its JSON fields. Times are CUDA events around ``REPS`` calls of
``topk_device`` at B=8 and B=256 (no host round trip to subtract), beside
the exact scan on the bf16 and on the f32 catalog; each build's seconds by
stage come from ``IVFCatalogIndex.build_s``. ``--real-geometry`` takes the
catalog and queries from a trained tower through the port's
``Recommender`` instead.

Run from the repository root on a machine with nvcc (one JSON line on
stdout, progress on stderr):

    python3 scripts/torch_bench_ivf.py [--real-geometry MODEL_DIR CORPUS_JSON]

``--device cpu`` computes the recalls and reports no times (the tests run
it so, at sizes set through the module constants).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]

N_CATALOG = 1_000_000
N_CENTERS = 2_000
DIM = 384
N_QUERIES = 1024
TOP_K = 10
SPREAD = 0.5  # noise norm relative to the unit center (not per dimension)
SWEEP = ((1024, (4, 8, 16)), (4096, (16, 32, 64)))  # (nlist, nprobes)
KMEANS_ITERS = 4
BATCHES = (8, 256)
REPS = 16


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def make_clustered(n: int, centers: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """``scripts/bench_ivf.py``'s generator: the same rows from the same rng."""
    idx = rng.integers(0, len(centers), size=n)
    d = centers.shape[1]
    noise = rng.standard_normal((n, d), dtype=np.float32) * (SPREAD / np.sqrt(d))
    x = centers[idx] + noise
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    return x.astype(np.float32)


def clustered_catalog(seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """The bench's catalog [N_CATALOG, DIM] and queries [N_QUERIES, DIM]."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((N_CENTERS, DIM), dtype=np.float32)
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    return make_clustered(N_CATALOG, centers, rng), make_clustered(N_QUERIES, centers, rng)


def real_geometry_embeddings(model_dir: str, corpus_path: str, device) -> tuple[np.ndarray, np.ndarray]:
    """A trained tower's geometry: the catalog is the corpus encoded by the
    port's ``Recommender``; the queries are the encoded ``eval_queries.json``
    beside the corpus, or a strided slice of the catalog where there is none."""
    from instacart_next_order_recommendation_tpu_torch.serve.recommender import Recommender

    rec = Recommender(model_dir, Path(corpus_path), use_index=True, device=device)
    catalog = np.asarray(rec.product_embeddings, np.float32)
    qpath = Path(corpus_path).parent / "eval_queries.json"
    if qpath.exists():
        texts = list(json.loads(qpath.read_text()).values())[:N_QUERIES]
        queries = np.asarray(rec.encoder.encode(texts), np.float32)
    else:
        queries = catalog[:: max(1, len(catalog) // N_QUERIES)][:N_QUERIES]
    return catalog, queries


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean milliseconds a call on the card (CUDA events after warm-up)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main(argv: list[str] | None = None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--real-geometry", nargs=2, metavar=("MODEL_DIR", "CORPUS_JSON"))
    parser.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = parser.parse_args(argv)
    if str(REPO) not in sys.path:
        sys.path.insert(0, str(REPO))
    from instacart_next_order_recommendation_tpu_torch.device import resolve_device
    from instacart_next_order_recommendation_tpu_torch.index import (
        IVFCatalogIndex,
        ShardedCatalogIndex,
    )

    dev = resolve_device(args.device)
    on_card = dev.type == "cuda"
    card = None
    if on_card:
        torch.backends.cuda.matmul.allow_tf32 = False
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True,
        ).stdout.strip().splitlines()[0]
        log(card)
    if args.real_geometry:
        catalog, queries = real_geometry_embeddings(*args.real_geometry, device=dev)
        base = max(16, int(np.sqrt(len(catalog))))
        sweep_plan = ((base, (4, 8, 16)), (4 * base, (16, 32, 64)))
    else:
        t0 = time.perf_counter()
        catalog, queries = clustered_catalog()
        sweep_plan = SWEEP
        log(f"{len(catalog)} clustered vectors in {time.perf_counter() - t0:.1f}s")
    n_catalog, n_queries = len(catalog), len(queries)
    catalog_d = torch.from_numpy(catalog).to(dev)

    def device_ms(index, batch: int) -> float | None:
        if not on_card:
            return None
        q = torch.from_numpy(queries[:batch]).to(dev)
        return cuda_ms(lambda: index.topk_device(q, TOP_K), REPS)

    def recall_ids(index) -> np.ndarray:
        return np.concatenate(
            [index.topk(queries[lo : lo + 256], TOP_K)[1] for lo in range(0, n_queries, 256)]
        )

    def qps(batch: int, ms: float | None) -> float | None:
        return None if ms is None else batch / ms * 1e3

    results: dict = {
        "catalog_size": n_catalog,
        "top_k": TOP_K,
        "geometry": "trained-tower" if args.real_geometry else "synthetic-clusters",
        "device": card or str(dev),
    }
    exact = ShardedCatalogIndex(catalog_d, device=dev, dtype="bfloat16")
    exact_ids = recall_ids(exact)
    for b in BATCHES:
        ms = device_ms(exact, b)
        results[f"exact_ms_b{b}"], results[f"exact_qps_b{b}"] = ms, qps(b, ms)
    del exact
    exact_f32 = ShardedCatalogIndex(catalog_d, device=dev)
    for b in BATCHES:
        results[f"exact_f32_ms_b{b}"] = device_ms(exact_f32, b)
    del exact_f32
    log(f"exact: {json.dumps(results)}")

    sweep, builds = [], []
    for nlist, nprobes in sweep_plan:
        t0 = time.perf_counter()
        ivf = IVFCatalogIndex(
            catalog_d, nlist=nlist, nprobe=nprobes[0], dtype="bfloat16",
            kmeans_iters=KMEANS_ITERS, device=dev,
        )
        builds.append({"nlist": nlist, "build_s": time.perf_counter() - t0,
                       "by_stage_s": ivf.build_s, "bucket_len": ivf.bucket_len})
        log(f"IVF build {json.dumps(builds[-1])}")
        for nprobe in nprobes:
            ivf.nprobe = min(nprobe, nlist)
            ids = recall_ids(ivf)
            recall = float(np.mean(
                [len(set(ids[q]) & set(exact_ids[q])) / TOP_K for q in range(n_queries)]
            ))
            entry = {"nlist": nlist, "nprobe": nprobe, "recall_at_10": recall}
            for b in BATCHES:
                ms = device_ms(ivf, b)
                entry[f"ms_b{b}"], entry[f"qps_b{b}"] = ms, qps(b, ms)
            log(f"ivf {json.dumps(entry)}")
            sweep.append(entry)
        del ivf
        if on_card:
            torch.cuda.empty_cache()

    good = [r for r in sweep if r["recall_at_10"] >= 0.95]
    if on_card and good:
        best = max(good, key=lambda r: r["qps_b8"])
    else:
        best = max(sweep, key=lambda r: r["recall_at_10"])
    out = {
        "metric": "ivf_recall_qps",
        "value": best["qps_b8"],
        "unit": "queries/s",
        "vs_baseline": best["qps_b8"] / results["exact_qps_b8"] if on_card else None,
        "details": {**results, "best": best, "sweep": sweep, "builds": builds},
    }
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
