"""Profile the port's serve hot path: where do the milliseconds go?

The port's counterpart of ``scripts/profile_serve.py``. On the GPU (or the
CPU with ``--device cpu``) it builds the serve benchmark's workload
(``utils/bench_workload.py``, shared with ``bench_cuda.py``: a 50,000-product
catalog, a WordPiece vocab of 30,000 trained on it, MiniLM-L6 at full width
with random weights from a seeded generator, the catalog encoded by
``encode_resident`` into a ``ShardedCatalogIndex``, and a
``FusedServePipeline`` over it) and reads:

  (a) the device's queries/s of the fused encode and top-k on ids already
      on the device, back to back, at several batch sizes and lengths;
  (b) the host's tokenization queries/s (the port's tokenizer, one thread);
  (c) end-to-end queries/s (tokenize, encode, top-k, results to the host)
      by batch size and thread count.

Each reading is a function that takes its sizes: ``report`` calls them at
the JAX script's sizes on a workload built by ``main`` (or by a caller that
shares one). It prints the card's name and power limit first, a line
for each reading, and one JSON line with them all last.

    python scripts/torch_profile_serve.py [--device cpu]
"""

from __future__ import annotations

# Allow running as `python scripts/<name>.py` from a repo checkout.
import sys as _sys
from pathlib import Path as _Path

_repo_root = str(_Path(__file__).resolve().parents[1])
if _repo_root not in _sys.path:
    _sys.path.insert(0, _repo_root)

import argparse
import json
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from instacart_next_order_recommendation_tpu_torch.utils.bench_texts import TOP_K
from instacart_next_order_recommendation_tpu_torch.utils.bench_workload import (
    MAX_SEQ_LENGTH,
    Workload,
    build_workload,
    card_line,
    sync,
)

TOKENIZE_QUERIES = 4096
DEVICE_BATCHES = (256, 512, 1024)
DEVICE_SEQS = (64, 128)
E2E_BATCHES = (256, 512)
E2E_THREADS = (2, 4, 8)


def token_lengths(w: Workload, n: int = 512) -> dict:
    lens = [len(w.tokenizer.encode(t)) for t in w.queries[:n]]
    return {"p50": float(np.percentile(lens, 50)), "p90": float(np.percentile(lens, 90)),
            "max": int(max(lens))}


def tokenize_qps(w: Workload, n: int = TOKENIZE_QUERIES) -> tuple[dict, np.ndarray]:
    """(b): one thread's queries/s through ``encode_batch``; also returns
    the ids, for (a)."""
    texts = w.queries[:n]
    t0 = time.perf_counter()
    ids, _ = w.tokenizer.encode_batch(texts, max_seq_length=MAX_SEQ_LENGTH)
    dt = time.perf_counter() - t0
    return {"queries": len(texts), "qps": len(texts) / dt, "shape": list(ids.shape)}, ids


def device_qps(
    w: Workload,
    ids_all: np.ndarray,
    batches=DEVICE_BATCHES,
    seqs=DEVICE_SEQS,
    iters: int = 20,
    k: int = TOP_K,
) -> list[dict]:
    """(a): the fused encode and top-k on resident ids, ``iters`` calls back
    to back after one warm-up, synchronized before and after."""
    rows = []
    for b in batches:
        for s in seqs:
            ids = np.ascontiguousarray(ids_all[:b, :s].astype(w.fused.wire_dtype))
            ids_d = torch.from_numpy(ids).to(w.device)
            w.fused.run_device(ids_d, k)
            sync(w.device)
            t0 = time.perf_counter()
            for _ in range(iters):
                w.fused.run_device(ids_d, k)
            sync(w.device)
            dt = time.perf_counter() - t0
            rows.append({"batch": int(ids.shape[0]), "seq": int(ids.shape[1]),
                         "qps": ids.shape[0] * iters / dt, "ms_per_batch": dt / iters * 1e3})
    return rows


def e2e_qps(w: Workload, batches=E2E_BATCHES, threads=E2E_THREADS, k: int = TOP_K) -> list[dict]:
    """(c): every query, tokenized, encoded, ranked and brought to the host
    in batches of ``b`` (length-sorted), by a pool of ``n`` threads; one
    warm pass per batch size first."""
    sorted_queries = sorted(w.queries, key=len)
    rows = []
    for b in batches:
        def serve_batch(lo: int, b=b) -> int:
            batch = sorted_queries[lo : lo + b]
            ids, mask = w.tokenizer.encode_batch(
                batch, max_seq_length=MAX_SEQ_LENGTH, pad_batch_to=b
            )
            packed, _ = w.fused.topk_device(ids, mask, k)
            packed.cpu().numpy()
            return len(batch)

        starts = range(0, len(sorted_queries), b)
        for lo in starts:
            serve_batch(lo)  # warm
        for nt in threads:
            with ThreadPoolExecutor(nt) as ex:
                t0 = time.perf_counter()
                n = sum(ex.map(serve_batch, starts))
                dt = time.perf_counter() - t0
            rows.append({"batch": b, "threads": nt, "qps": n / dt})
    return rows


def report(w: Workload, card: str) -> dict:
    """Every reading at the JAX script's sizes, a line each, then one JSON
    line with them all; returns that summary."""
    lens = token_lengths(w)
    print(f"query token lens: p50={lens['p50']:.0f} p90={lens['p90']:.0f} max={lens['max']}")
    tok, ids_all = tokenize_qps(w)
    print(f"tokenize: {tok['qps']:.0f} q/s single-thread (batch shape {tuple(tok['shape'])})")
    dev_rows = device_qps(w, ids_all)
    for r in dev_rows:
        print(f"device fused B={r['batch']} S={r['seq']}: {r['qps']:.0f} q/s "
              f"({r['ms_per_batch']:.2f} ms/batch)")
    e2e_rows = e2e_qps(w)
    for r in e2e_rows:
        print(f"e2e B={r['batch']} threads={r['threads']}: {r['qps']:.0f} q/s")
    summary = {"metric": "serve_profile", "card": card, "token_lens": lens,
               "tokenize": tok, "device": dev_rows, "e2e": e2e_rows}
    print(json.dumps(summary), flush=True)
    return summary


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description="Serve hot-path profile on the port")
    parser.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = parser.parse_args(argv)

    from instacart_next_order_recommendation_tpu_torch.device import resolve_device

    dev = resolve_device(args.device)
    card = card_line(dev)
    print(card, flush=True)
    report(build_workload(device=dev), card)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
