"""Information-retrieval metrics.

The port's copy of the JAX package's ``eval/metrics.py`` (numpy only), with
the same semantics:

- Accuracy@k: fraction of queries with >=1 relevant doc in the top-k.
- Recall@k:   per-query hits/|relevant|, averaged.
- MRR@k:      reciprocal rank of the first relevant doc within top-k (0 if none).
- NDCG@k:     binary relevance; DCG with 1/log2(rank+1); the ideal list is the
  *retrieved* top-k relevance values sorted descending (reference behavior —
  note this differs from the textbook IDCG that uses min(k, |relevant|) ones).
- MAP@k:      sum of P@j over relevant hits divided by min(|relevant|, |ranked|).
- Queries with no relevant docs are excluded from every average
  (as the JAX package does).

Two call styles:
- ``compute_ir_metrics(query_rankings, relevant_docs)`` — dict-of-lists parity
  API identical to the reference.
- ``compute_ir_metrics_from_arrays(ranked_ids, query_ids, relevant_docs)`` —
  vectorized batch path for rankings produced on-device (top-K id matrices).
"""

from __future__ import annotations

import math
from typing import Mapping, Sequence

import numpy as np

METRIC_KEYS = (
    "accuracy_at_1",
    "accuracy_at_3",
    "accuracy_at_5",
    "accuracy_at_10",
    "recall_at_10",
    "mrr_at_10",
    "ndcg_at_10",
    "map_at_100",
)

_ZERO_METRICS = {k: 0.0 for k in METRIC_KEYS}


def _recall_at_k(relevant: set[str], ranked: Sequence[str], k: int) -> float:
    if not relevant:
        return 0.0
    hits = sum(1 for pid in ranked[:k] if pid in relevant)
    return hits / len(relevant)


def _reciprocal_rank(relevant: set[str], ranked: Sequence[str], k: int) -> float:
    for rank, pid in enumerate(ranked[:k], start=1):
        if pid in relevant:
            return 1.0 / rank
    return 0.0


def _ndcg_at_k(relevant: set[str], ranked: Sequence[str], k: int) -> float:
    rel = [1.0 if pid in relevant else 0.0 for pid in ranked[:k]]
    dcg = sum(r / math.log2(i + 2) for i, r in enumerate(rel))
    idcg = sum(r / math.log2(i + 2) for i, r in enumerate(sorted(rel, reverse=True)))
    return dcg / idcg if idcg > 0 else 0.0


def _average_precision(relevant: set[str], ranked: Sequence[str], k: int | None = None) -> float:
    if not relevant:
        return 0.0
    if k is not None:
        ranked = ranked[:k]
    if not ranked:
        return 0.0
    score, hits = 0.0, 0
    for j, pid in enumerate(ranked, start=1):
        if pid in relevant:
            hits += 1
            score += hits / j
    return score / min(len(relevant), len(ranked))


def compute_ir_metrics(
    query_rankings: Mapping[str, Sequence[str]],
    relevant_docs: Mapping[str, set[str]],
) -> dict[str, float]:
    """Compute the metric suite over all queries (dict-of-rankings API)."""
    qids = [q for q in query_rankings if relevant_docs.get(q)]
    if not qids:
        return dict(_ZERO_METRICS)

    n = len(qids)
    out = dict.fromkeys(METRIC_KEYS, 0.0)
    for q in qids:
        ranked = query_rankings[q]
        rel = relevant_docs[q]
        for k, key in ((1, "accuracy_at_1"), (3, "accuracy_at_3"), (5, "accuracy_at_5"), (10, "accuracy_at_10")):
            if rel & set(ranked[:k]):
                out[key] += 1.0
        out["recall_at_10"] += _recall_at_k(rel, ranked, 10)
        out["mrr_at_10"] += _reciprocal_rank(rel, ranked, 10)
        out["ndcg_at_10"] += _ndcg_at_k(rel, ranked, 10)
        out["map_at_100"] += _average_precision(rel, ranked, 100)
    return {k: v / n for k, v in out.items()}


def compute_ir_metrics_from_arrays(
    ranked_ids: np.ndarray,
    query_ids: Sequence[str],
    relevant_docs: Mapping[str, set[str]],
    id_lookup: Sequence[str],
) -> dict[str, float]:
    """Vectorized metric computation from a top-K index matrix.

    Args:
        ranked_ids: [n_queries, K] int array of corpus row indices, best first.
            K must be >= 100 for MAP@100 to match the dict API on rankings that
            are truncated at K (the reference ranks the full corpus; with
            |relevant| << 100 the difference is only in queries whose relevant
            docs all rank below K, contributing ~0 either way).
        query_ids: query id per row.
        relevant_docs: query id -> set of relevant product ids.
        id_lookup: corpus row index -> product id string.

    Returns:
        Metric dict identical in keys to :func:`compute_ir_metrics`.
    """
    n_queries, k_max = ranked_ids.shape
    id_arr = np.asarray(id_lookup, dtype=object)

    qmask = np.array([bool(relevant_docs.get(q)) for q in query_ids])
    if not qmask.any():
        return dict(_ZERO_METRICS)

    # Binary relevance matrix for the retrieved lists.
    rel = np.zeros((n_queries, k_max), dtype=np.float64)
    ranked_pid = id_arr[ranked_ids]
    for i, q in enumerate(query_ids):
        docs = relevant_docs.get(q)
        if docs:
            rel[i] = np.isin(ranked_pid[i], list(docs))

    rel = rel[qmask]
    n = rel.shape[0]
    n_rel = np.array(
        [len(relevant_docs[q]) for q, m in zip(query_ids, qmask) if m], dtype=np.float64
    )

    def acc_at(k: int) -> float:
        return float((rel[:, :k].sum(axis=1) > 0).mean())

    recall10 = float((rel[:, :10].sum(axis=1) / n_rel).mean())

    # MRR@10: 1/(first-hit rank) within top-10.
    first_hit = np.argmax(rel[:, :10], axis=1)
    has_hit = rel[:, :10].sum(axis=1) > 0
    mrr10 = float(np.where(has_hit, 1.0 / (first_hit + 1), 0.0).mean())

    # NDCG@10 with reference semantics (ideal = retrieved hits front-loaded).
    # Rankings narrower than 10 (corpus < 10 docs) truncate the discount row
    # to the actual width; rel[:, :10] already slices to at most that width.
    discounts = 1.0 / np.log2(np.arange(min(10, rel.shape[1])) + 2.0)
    dcg = (rel[:, :10] * discounts).sum(axis=1)
    n_hits10 = rel[:, :10].sum(axis=1).astype(np.int64)
    idcg_cum = np.concatenate([[0.0], np.cumsum(discounts)])
    idcg = idcg_cum[n_hits10]
    ndcg10 = float(np.where(idcg > 0, dcg / np.maximum(idcg, 1e-12), 0.0).mean())

    # MAP@100.
    k_map = min(100, k_max)
    rel100 = rel[:, :k_map]
    cum_hits = np.cumsum(rel100, axis=1)
    precision = cum_hits / (np.arange(k_map) + 1.0)
    ap = (precision * rel100).sum(axis=1) / np.minimum(n_rel, float(k_map))
    map100 = float(ap.mean())

    return {
        "accuracy_at_1": acc_at(1),
        "accuracy_at_3": acc_at(3),
        "accuracy_at_5": acc_at(5),
        "accuracy_at_10": acc_at(10),
        "recall_at_10": recall10,
        "mrr_at_10": mrr10,
        "ndcg_at_10": ndcg10,
        "map_at_100": map100,
    }


def format_metrics(name: str, metrics: Mapping[str, float]) -> str:
    """Render the metric table the way the reference baselines runner prints it."""
    lines = [f"\n--- {name} ---"]
    labels = {
        "accuracy_at_1": "Accuracy@1",
        "accuracy_at_3": "Accuracy@3",
        "accuracy_at_5": "Accuracy@5",
        "accuracy_at_10": "Accuracy@10",
        "recall_at_10": "Recall@10",
        "mrr_at_10": "MRR@10",
        "ndcg_at_10": "NDCG@10",
        "map_at_100": "MAP@100",
    }
    for key in METRIC_KEYS:
        lines.append(f"  {labels[key] + ':':<13} {metrics[key]:.4f}")
    return "\n".join(lines)
