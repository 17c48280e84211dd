"""Batch retrieval evaluator.

Counterpart of the JAX package's ``eval/evaluator.py``: encodes the eval
queries and the full corpus on the device with the port's ``TextEncoder``,
retrieves the top-K corpus rows per query with ``cosine_topk`` (the K3
kernel for K <= 256), and computes the IR metric suite on the host.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from instacart_next_order_recommendation_tpu_torch.eval.metrics import (
    compute_ir_metrics_from_arrays,
)
from instacart_next_order_recommendation_tpu_torch.models.text_encoder import TextEncoder
from instacart_next_order_recommendation_tpu_torch.ops import cosine_topk


class RetrievalEvaluator:
    """Evaluates a tower on (queries, corpus, relevant_docs) IR artifacts."""

    def __init__(
        self,
        queries: Mapping[str, str],
        corpus: Mapping[str, str],
        relevant_docs: Mapping[str, set[str]],
        batch_size: int = 64,
        top_k: int = 100,
        name: str = "order-recommendation",
    ):
        if not queries or not corpus:
            raise ValueError("RetrievalEvaluator needs at least one query and document")
        self.query_ids = list(queries.keys())
        self.query_texts = [queries[q] for q in self.query_ids]
        self.corpus_ids = list(corpus.keys())
        self.corpus_texts = [corpus[c] for c in self.corpus_ids]
        self.relevant_docs = {k: set(v) for k, v in relevant_docs.items()}
        self.batch_size = batch_size
        self.top_k = min(top_k, len(self.corpus_ids))
        self.name = name

    def __call__(self, encoder: TextEncoder) -> dict[str, float]:
        # Embeddings stay on the device; only the [n_queries, top_k] index
        # matrix comes back to the host.
        bs = max(self.batch_size, 512)
        corpus_emb = encoder.encode_resident(self.corpus_texts, batch_size=bs)
        query_emb = encoder.encode_resident(self.query_texts, batch_size=bs)
        ranked = self.rank(query_emb, corpus_emb)
        return compute_ir_metrics_from_arrays(
            ranked, self.query_ids, self.relevant_docs, self.corpus_ids
        )

    @torch.inference_mode()
    def rank(self, query_emb, corpus_emb) -> np.ndarray:
        """Top-K corpus row indices per query, best first ([n_queries, K]),
        in fixed-size query chunks on the catalog's device."""
        catalog = torch.as_tensor(corpus_emb, dtype=torch.float32).contiguous()
        queries = torch.as_tensor(query_emb, dtype=torch.float32).to(catalog.device)
        n = queries.shape[0]
        bs = min(max(self.batch_size, 512), n)
        pad = (-n) % bs
        if pad:
            queries = torch.cat([queries, queries.new_zeros((pad, queries.shape[1]))])
        chunks = [
            cosine_topk(queries[lo : lo + bs], catalog, self.top_k)[1]
            for lo in range(0, n + pad, bs)
        ]
        idx = chunks[0] if len(chunks) == 1 else torch.cat(chunks, dim=0)
        return idx[:n].cpu().numpy().astype(np.int64)
