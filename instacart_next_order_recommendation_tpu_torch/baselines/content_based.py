"""Content-based baseline: the same tower architecture, untrained.

The port's copy of the JAX package's ``baselines/content_based.py``. It
isolates the gain from contrastive training: "untrained" is a freshly
initialised tower with a corpus-trained vocab (or any checkpoint directory
passed as ``model``: the shared format or a Hugging Face one), whose
embeddings of the queries and the corpus are ranked by cosine similarity.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np
import torch

from instacart_next_order_recommendation_tpu_torch.models.encoder import MINILM_L6, init_params
from instacart_next_order_recommendation_tpu_torch.models.text_encoder import TextEncoder
from instacart_next_order_recommendation_tpu_torch.tokenizer import WordPieceTokenizer


def untrained_encoder(
    corpus_texts,
    vocab_size: int = 30000,
    seed: int = 0,
    preset=MINILM_L6,
    max_seq_length: int = 256,
    device: str | torch.device | None = None,
) -> TextEncoder:
    """Freshly initialised tower (from ``seed``) with a corpus-trained vocab,
    on ``device`` (None: the GPU)."""
    tok = WordPieceTokenizer.train(corpus_texts, vocab_size=vocab_size)
    cfg = dataclasses.replace(preset, vocab_size=tok.vocab_size, max_seq_length=max_seq_length)
    params = init_params(cfg, torch.Generator().manual_seed(seed))
    return TextEncoder(params, cfg, tok, max_seq_length, device=device)


class ContentBasedBaseline:
    """Rank products for each query by untrained-tower cosine similarity."""

    def __init__(
        self,
        eval_queries: dict[str, str],
        eval_corpus: dict[str, str],
        model: str | Path | TextEncoder | None = None,
        batch_size: int = 64,
        device: str | torch.device | None = None,
    ):
        self.eval_queries = eval_queries
        self.eval_corpus = eval_corpus
        self.product_ids = list(eval_corpus.keys())
        self.corpus_texts = [eval_corpus[pid] for pid in self.product_ids]
        self.batch_size = batch_size
        if isinstance(model, TextEncoder):
            self.encoder = model
        elif model is not None:
            self.encoder = TextEncoder.load(model, device=device)
        else:
            self.encoder = untrained_encoder(self.corpus_texts, device=device)
        self.corpus_embeddings = self.encoder.encode(self.corpus_texts, batch_size=batch_size)

    def rank_all(self, top_k: int | None = None) -> dict[str, list[str]]:
        """query_id -> ranked product ids (descending score).

        ``top_k=None`` ranks the full corpus on the host, as the JAX package
        does (one product and a stable sort); a cutoff ranks through the
        top-k kernel (``RetrievalEvaluator.rank``) instead of a full sort.
        """
        query_ids = list(self.eval_queries.keys())
        query_emb = self.encoder.encode(
            [self.eval_queries[q] for q in query_ids], batch_size=self.batch_size
        )
        if top_k is None:
            sim = query_emb @ self.corpus_embeddings.T
            order = np.argsort(-sim, axis=1, kind="stable")
        else:
            from instacart_next_order_recommendation_tpu_torch.eval.evaluator import (
                RetrievalEvaluator,
            )

            ev = RetrievalEvaluator(
                self.eval_queries, self.eval_corpus, {}, self.batch_size, top_k
            )
            order = ev.rank(
                torch.from_numpy(query_emb).to(self.encoder.device),
                torch.from_numpy(self.corpus_embeddings).to(self.encoder.device),
            )
        ids = np.asarray(self.product_ids, dtype=object)
        return {qid: list(ids[order[i]]) for i, qid in enumerate(query_ids)}
