"""The serve benchmark's workload, built once for every tool that reads it.

``bench_cuda.py`` (the serve benchmark) and ``scripts/torch_profile_serve.py``
(the serve profile) measure the same thing from two sides, so they share one
builder: the JAX repo's ``bench.py`` workload (a 50,000-product catalog and
8,192 user-context queries from ``utils/bench_texts.py``), a WordPiece vocab
of up to 30,000 trained on the catalog, MiniLM-L6 (or another preset) at the
vocab's size with random weights from a seeded ``torch.Generator``, the
catalog encoded by ``encode_resident`` into a ``ShardedCatalogIndex``, and a
``FusedServePipeline`` over it.
"""

from __future__ import annotations

import dataclasses
import subprocess
import time

import numpy as np
import torch

from instacart_next_order_recommendation_tpu_torch.utils.bench_texts import (
    CATALOG_SIZE,
    build_catalog_texts,
    build_query_texts,
)

N_QUERIES = 8192
MAX_SEQ_LENGTH = 256
VOCAB_SIZE = 30_000
CATALOG_BATCH = 256  # bench.py's catalog-encode batch


@dataclasses.dataclass
class Workload:
    tokenizer: object
    fused: object  # FusedServePipeline over the encoded catalog
    queries: list[str]
    device: torch.device
    encoder: object  # the TextEncoder that encoded the catalog
    index: object  # the ShardedCatalogIndex holding it
    catalog: list[str]


def card_line(device: torch.device) -> str:
    """``nvidia-smi``'s name and power limit of the card, or the CPU's name."""
    if device.type != "cuda":
        return "device: cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]


def device_details(device: torch.device) -> dict:
    """The device's name, how many the host has, and its power limit as
    ``nvidia-smi`` reads it (null on the CPU)."""
    if device.type != "cuda":
        return {"name": "cpu", "count": 1, "power_limit": None}
    return {
        "name": torch.cuda.get_device_name(device),
        "count": torch.cuda.device_count(),
        "power_limit": card_line(device).rsplit(", ", 1)[-1],
    }


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def chain_ms(fn, n: int, device: torch.device) -> float:
    """ms a call over ``n`` calls of ``fn`` back to back: CUDA events around
    them on the card (the device's time), the host clock on the CPU."""
    if device.type == "cuda":
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / n
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    return (time.perf_counter() - t0) * 1e3 / n


def build_workload(
    n_products: int = CATALOG_SIZE,
    n_queries: int = N_QUERIES,
    vocab_size: int = VOCAB_SIZE,
    device: str | torch.device | None = None,
    preset=None,
) -> Workload:
    """The serve benchmark's catalog and queries (seed 0), a tokenizer
    trained on the catalog, MiniLM-L6 (or ``preset``) at the vocab's size,
    the catalog encoded into a resident index at ``bench.py``'s catalog
    batch, and the fused pipeline over it."""
    from instacart_next_order_recommendation_tpu_torch.device import resolve_device
    from instacart_next_order_recommendation_tpu_torch.index import ShardedCatalogIndex
    from instacart_next_order_recommendation_tpu_torch.models.encoder import (
        MINILM_L6,
        init_params,
    )
    from instacart_next_order_recommendation_tpu_torch.models.text_encoder import TextEncoder
    from instacart_next_order_recommendation_tpu_torch.serve.pipeline import FusedServePipeline
    from instacart_next_order_recommendation_tpu_torch.tokenizer import WordPieceTokenizer

    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    catalog_texts = build_catalog_texts(n_products, rng)
    query_texts = build_query_texts(n_queries, catalog_texts, rng)
    tokenizer = WordPieceTokenizer.train(catalog_texts, vocab_size=vocab_size)
    config = dataclasses.replace(preset or MINILM_L6, vocab_size=tokenizer.vocab_size)
    params = init_params(config, torch.Generator().manual_seed(0))
    encoder = TextEncoder(params, config, tokenizer, max_seq_length=MAX_SEQ_LENGTH, device=dev)
    catalog_emb = encoder.encode_resident(catalog_texts, batch_size=CATALOG_BATCH)
    index = ShardedCatalogIndex(catalog_emb, mesh=None, device=dev)
    fused = FusedServePipeline(
        encoder.params, config, index.catalog, n_products, pad_id=tokenizer.pad_id,
        layers=encoder.layers, device=dev,
    )
    return Workload(tokenizer, fused, query_texts, dev, encoder, index, catalog_texts)
