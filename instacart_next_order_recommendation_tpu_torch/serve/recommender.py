"""Two-tower recommender serving core on one GPU.

Counterpart of the JAX package's ``serve/recommender.py::Recommender``:

- the corpus JSON loads keeping key order (key order is the ranking id order),
- catalog embeddings are built once and cached on disk via EmbeddingIndex,
  in the same cache layout as the JAX package,
- ``recommend(query, top_k, exclude_product_ids)`` returns ``[(pid, score)]``
  with exclusion applied after ranking (fetch top-(k + |excluded|)),
- aisle/department filters become a row mask applied on the device.
"""

from __future__ import annotations

import json
import logging
import os
import re
from pathlib import Path

import numpy as np
import torch

from instacart_next_order_recommendation_tpu_torch.constants import ENV_TOPK_EXTRACTION
from instacart_next_order_recommendation_tpu_torch.device import resolve_device
from instacart_next_order_recommendation_tpu_torch.index.embedding_index import EmbeddingIndex
from instacart_next_order_recommendation_tpu_torch.index.sharded import ShardedCatalogIndex
from instacart_next_order_recommendation_tpu_torch.models.text_encoder import TextEncoder
from instacart_next_order_recommendation_tpu_torch.serve.pipeline import FusedServePipeline

logger = logging.getLogger(__name__)

# Serve lattice for top-k sizes (the JAX package's serve/precompile.py):
# requests round k up to one of these, so the kernels see few shapes.
K_BUCKETS = (16, 32, 64, 128, 256)


class Recommender:
    """Encodes user context, retrieves top-k products by cosine similarity."""

    def __init__(
        self,
        model_dir: Path | str,
        corpus_path: Path | str,
        batch_size: int = 64,
        use_index: bool = True,
        device: str | torch.device | None = None,
        topk_extraction: str | None = None,
    ):
        """``device=None`` means the GPU and raises where there is none.

        ``topk_extraction``: "exact" (default) or "packed", the packed
        score + index kernel (scores quantized to about 3 decimal digits;
        near-tied candidates may swap). ``None`` reads the
        ``ITOR_TOPK_EXTRACTION`` environment variable. Either way a kernel
        serves; the choice is between the two kernels."""
        if topk_extraction is None:
            topk_extraction = (os.getenv(ENV_TOPK_EXTRACTION) or "exact").strip().lower()
        self.device = resolve_device(device)
        self.model_dir = self._resolve_model_dir(model_dir)
        self.corpus_path = Path(corpus_path).resolve()
        self.product_ids, self.product_texts = self._load_corpus()
        self.pid_to_text = dict(zip(self.product_ids, self.product_texts))
        self._build_category_masks()
        self.encoder = TextEncoder.load(self.model_dir, device=self.device)
        self.product_embeddings = self._load_or_build_embeddings(batch_size, use_index)
        self.index = ShardedCatalogIndex(
            self.product_embeddings, device=self.device, extraction=topk_extraction
        )
        self._fused = FusedServePipeline(
            self.encoder.params,
            self.encoder.config,
            self.index.catalog,
            len(self.product_ids),
            pad_id=self.encoder.tokenizer.pad_id,
            layers=self.encoder.layers,
            device=self.device,
            packed=self.index.packed,
        )

    @staticmethod
    def _resolve_model_dir(model_dir: Path | str) -> Path:
        p = Path(model_dir)
        if not p.exists():
            raise FileNotFoundError(f"model dir not found: {model_dir}")
        return p.resolve()

    def _load_corpus(self) -> tuple[list[str], list[str]]:
        with open(self.corpus_path) as f:
            corpus = json.load(f)
        ids = list(corpus.keys())
        return ids, [corpus[pid] for pid in ids]

    # --------------------------------------------------------------- categories

    _CATEGORY_RE = re.compile(r"Aisle:\s*(.+?)\.\s*Department:\s*(.+?)\.\s*$")

    def _build_category_masks(self) -> None:
        """Parse aisle/department from the product text template
        ("Product: X. Aisle: Y. Department: Z.") into per-value row lists."""
        self._aisle_rows: dict[str, list[int]] = {}
        self._department_rows: dict[str, list[int]] = {}
        for row, text in enumerate(self.product_texts):
            m = self._CATEGORY_RE.search(text)
            if not m:
                continue
            self._aisle_rows.setdefault(m.group(1).strip().lower(), []).append(row)
            self._department_rows.setdefault(m.group(2).strip().lower(), []).append(row)
        self._n_rows = len(self.product_texts)

    def _category_mask(
        self,
        filter_aisles: list[str] | None,
        filter_departments: list[str] | None,
    ) -> np.ndarray | None:
        """[N] int32 mask (1 = eligible): OR within a filter list, AND across
        the two lists. None when no filter is active."""
        if not filter_aisles and not filter_departments:
            return None
        mask = np.ones(self._n_rows, dtype=bool)
        for values, rows_by_value in (
            (filter_aisles, self._aisle_rows),
            (filter_departments, self._department_rows),
        ):
            if values:
                group = np.zeros(self._n_rows, dtype=bool)
                for v in values:
                    rows = rows_by_value.get(str(v).strip().lower())
                    if rows:
                        group[rows] = True
                mask &= group
        return mask.astype(np.int32)

    @property
    def aisles(self) -> list[str]:
        return sorted(self._aisle_rows)

    @property
    def departments(self) -> list[str]:
        return sorted(self._department_rows)

    def _load_or_build_embeddings(
        self, batch_size: int, use_index: bool
    ) -> np.ndarray | torch.Tensor:
        disk_index = EmbeddingIndex(self.corpus_path, self.model_dir)
        if use_index:
            cached = disk_index.load(self.product_ids)
            if cached is not None:
                logger.info(
                    "Loaded %d product embeddings from index cache", len(self.product_ids)
                )
                return cached
        # Built on the device and kept there; the host sees the embeddings
        # only when the disk cache needs a copy (one bulk transfer).
        emb_device = self.encoder.encode_resident(
            self.product_texts, batch_size=max(batch_size, 512)
        )
        if use_index:
            embeddings = emb_device.cpu().numpy()
            disk_index.save(self.product_ids, embeddings)
            logger.info("Encoded corpus: %d products", len(self.product_ids))
            return embeddings
        logger.info("Encoded corpus: %d products (device-resident)", len(self.product_ids))
        return emb_device

    # ------------------------------------------------------------------ query

    def _k_bucket(self, fetch_k: int) -> int:
        """Round k up to the serve lattice; callers slice back to fetch_k."""
        k_bucket = next((b for b in K_BUCKETS if b >= fetch_k), fetch_k)
        return min(k_bucket, len(self.product_ids))

    def _rank(
        self, query: str, fetch_k: int, candidate_mask: np.ndarray | None = None
    ) -> tuple[np.ndarray, np.ndarray]:
        k_bucket = self._k_bucket(fetch_k)
        if candidate_mask is None:
            ids, mask = self.encoder.tokenizer.encode_batch(
                [query], max_seq_length=self.encoder.max_seq_length
            )
            scores, indices = self._fused.topk(ids, mask, k_bucket)
        else:
            query_emb = self.encoder.encode_device([query])
            scores, indices = self.index.topk(query_emb, k_bucket, candidate_mask=candidate_mask)
        return scores[:, :fetch_k], indices[:, :fetch_k]

    def recommend(
        self,
        query: str,
        top_k: int = 10,
        exclude_product_ids: set[str] | None = None,
        filter_aisles: list[str] | None = None,
        filter_departments: list[str] | None = None,
    ) -> list[tuple[str, float]]:
        """Top-k (product_id, score); excluded ids skipped after ranking.

        ``filter_aisles``/``filter_departments`` restrict the candidate pool
        on the device (masked retrieval).
        """
        excluded = exclude_product_ids or set()
        fetch_k = min(top_k + len(excluded), len(self.product_ids))
        mask = self._category_mask(filter_aisles, filter_departments)
        scores, indices = self._rank(query, fetch_k, candidate_mask=mask)
        return self._take_top(scores[0], indices[0], top_k, excluded)

    _MASKED_OUT = -1e29  # scores below this are masked-out sentinel rows

    def _take_top(
        self, scores: np.ndarray, indices: np.ndarray, top_k: int, excluded: set[str]
    ) -> list[tuple[str, float]]:
        results: list[tuple[str, float]] = []
        for score, idx in zip(scores, indices):
            if score <= self._MASKED_OUT:  # fewer eligible candidates than k
                break
            pid = self.product_ids[int(idx)]
            if pid in excluded:
                continue
            results.append((pid, float(score)))
            if len(results) >= top_k:
                break
        return results
