"""Compare untrained vs trained towers: IR metrics + embedding-collapse check.

The port's counterpart of ``scripts/compare_untrained_vs_trained.py``: ranks
the same eval set with both towers (encoded on the device, ranked by the
top-k kernel through ``RetrievalEvaluator.rank``), reports the metric suite,
and computes collapse indicators (sampled mean pairwise cosine sim of
queries/corpus and mean per-dimension std — high sim / low std = collapse).

    python scripts/torch_compare_untrained_vs_trained.py \\
        [--config configs/compare_untrained_vs_trained.yaml] [--device cuda]
"""

from __future__ import annotations

# Allow running as `python scripts/<name>.py` from a repo checkout.
import sys as _sys
from pathlib import Path as _Path

_repo_root = str(_Path(__file__).resolve().parents[1])
if _repo_root not in _sys.path:
    _sys.path.insert(0, _repo_root)

import argparse
import logging
import random
from pathlib import Path

import numpy as np

from instacart_next_order_recommendation_tpu_torch.baselines.collaborative_filtering import (
    load_eval_data,
)
from instacart_next_order_recommendation_tpu_torch.baselines.content_based import (
    untrained_encoder,
)
from instacart_next_order_recommendation_tpu_torch.constants import (
    DEFAULT_CONFIG_COMPARE,
    DEFAULT_MODEL_DIR,
    DEFAULT_PROCESSED_DIR,
)
from instacart_next_order_recommendation_tpu_torch.eval.evaluator import RetrievalEvaluator
from instacart_next_order_recommendation_tpu_torch.eval.metrics import (
    compute_ir_metrics_from_arrays,
)
from instacart_next_order_recommendation_tpu_torch.models.text_encoder import TextEncoder
from instacart_next_order_recommendation_tpu_torch.utils.config import (
    load_yaml_config,
    resolve_project_path,
)
from instacart_next_order_recommendation_tpu_torch.utils.logging import setup_colored_logging
from instacart_next_order_recommendation_tpu_torch.utils.resolve import resolve_processed_dir

logger = logging.getLogger(__name__)


def embedding_collapse_metrics(
    query_emb: np.ndarray, corpus_emb: np.ndarray, name: str, sample_pairs: int = 2000
) -> dict[str, float]:
    """Collapse indicators: the mean cosine similarity of sampled pairs of
    queries and of products, and the corpus's mean per-dimension std."""
    rng = random.Random(42)

    def sample_mean_cos_sim(emb: np.ndarray, n: int) -> float:
        if emb.shape[0] < 2:
            return 0.0
        indices = list(range(emb.shape[0]))
        sims = []
        for _ in range(min(n, len(indices) * (len(indices) - 1) // 2)):
            i, j = rng.sample(indices, 2)
            sims.append(float(np.dot(emb[i], emb[j])))
        return float(np.mean(sims)) if sims else 0.0

    return {
        f"{name}_query_mean_pairwise_cos_sim": sample_mean_cos_sim(query_emb, sample_pairs),
        f"{name}_corpus_mean_pairwise_cos_sim": sample_mean_cos_sim(corpus_emb, sample_pairs),
        f"{name}_corpus_mean_std_per_dim": float(np.mean(np.std(corpus_emb, axis=0))),
    }


def evaluate_encoder(encoder: TextEncoder, eval_queries, eval_corpus, eval_relevant, batch_size):
    """IR metrics of ``encoder`` on the eval set, and its query and corpus
    embeddings on the host. The embeddings stay on the encoder's device for
    the ranking (the top-k kernel on the GPU)."""
    evaluator = RetrievalEvaluator(eval_queries, eval_corpus, eval_relevant, batch_size)
    corpus_emb = encoder.encode_resident(evaluator.corpus_texts, batch_size=batch_size)
    query_emb = encoder.encode_resident(evaluator.query_texts, batch_size=batch_size)
    ranked = evaluator.rank(query_emb, corpus_emb)
    metrics = compute_ir_metrics_from_arrays(
        ranked, evaluator.query_ids, evaluator.relevant_docs, evaluator.corpus_ids
    )
    return metrics, query_emb.cpu().numpy(), corpus_emb.cpu().numpy()


def load_config(config_path: Path | None = None) -> dict:
    raw = load_yaml_config(config_path, DEFAULT_CONFIG_COMPARE)
    return {
        "processed_dir": resolve_project_path(raw.get("processed_dir"), DEFAULT_PROCESSED_DIR),
        "model_dir": resolve_project_path(raw.get("model_dir"), DEFAULT_MODEL_DIR),
        "base_model": raw.get("base_model"),  # None = fresh random tower
        "batch_size": int(raw.get("batch_size", 64)),
        "sample_queries": raw.get("sample_queries"),
    }


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        description="Compare untrained vs trained towers; IR metrics and collapse indicators"
    )
    parser.add_argument("--config", type=Path, default=None)
    parser.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = parser.parse_args(argv)
    setup_colored_logging()

    cfg = load_config(args.config)
    processed_dir, msg = resolve_processed_dir(cfg["processed_dir"], DEFAULT_PROCESSED_DIR)
    if msg:
        logger.info("%s", msg)

    eval_queries, eval_corpus, eval_relevant = load_eval_data(processed_dir)
    logger.info("Eval queries: %d, corpus size: %d", len(eval_queries), len(eval_corpus))

    if cfg["sample_queries"] and cfg["sample_queries"] < len(eval_queries):
        rng = random.Random(123)
        qids = rng.sample(list(eval_queries.keys()), cfg["sample_queries"])
        eval_queries = {q: eval_queries[q] for q in qids}
        eval_relevant = {q: eval_relevant[q] for q in qids if q in eval_relevant}
        logger.info("Sampled to %d queries", len(eval_queries))

    logger.info("Untrained tower...")
    if cfg["base_model"]:
        untrained = TextEncoder.load(cfg["base_model"], device=args.device)
    else:
        untrained = untrained_encoder(list(eval_corpus.values()), device=args.device)
    u_metrics, u_q, u_c = evaluate_encoder(
        untrained, eval_queries, eval_corpus, eval_relevant, cfg["batch_size"]
    )
    collapse_u = embedding_collapse_metrics(u_q, u_c, "untrained")

    model_path = Path(cfg["model_dir"]).resolve()
    if not model_path.exists():
        logger.error("Trained model dir not found: %s", model_path)
        return 1
    logger.info("Trained tower: %s", model_path)
    trained = TextEncoder.load(model_path, device=args.device)
    t_metrics, t_q, t_c = evaluate_encoder(
        trained, eval_queries, eval_corpus, eval_relevant, cfg["batch_size"]
    )
    collapse_t = embedding_collapse_metrics(t_q, t_c, "trained")

    def print_metrics(label: str, m: dict[str, float]) -> None:
        print(f"\n--- {label} ---")
        print(f"  Accuracy@1:  {m['accuracy_at_1']:.4f}  |  Accuracy@10: {m['accuracy_at_10']:.4f}")
        print(f"  Recall@10:   {m['recall_at_10']:.4f}  |  MRR@10:      {m['mrr_at_10']:.4f}")
        print(f"  NDCG@10:     {m['ndcg_at_10']:.4f}  |  MAP@100:     {m['map_at_100']:.4f}")

    print_metrics("Untrained (fresh tower)", u_metrics)
    print_metrics("Trained (your checkpoint)", t_metrics)

    print("\n--- Embedding collapse indicators ---")
    print("  (Higher mean pairwise cos_sim = less diversity, possible collapse.)")
    for name, c in (("Untrained", collapse_u), ("Trained", collapse_t)):
        p = name.lower()
        print(f"  {name:<10} query mean pairwise cos_sim:  {c[f'{p}_query_mean_pairwise_cos_sim']:.4f}")
        print(f"  {name:<10} corpus mean pairwise cos_sim: {c[f'{p}_corpus_mean_pairwise_cos_sim']:.4f}")
        print(f"  {name:<10} corpus mean std per dim:      {c[f'{p}_corpus_mean_std_per_dim']:.4f}")

    print("\n--- Summary ---")
    better = "Trained" if t_metrics["accuracy_at_10"] >= u_metrics["accuracy_at_10"] else "Untrained"
    print(
        f"  Accuracy@10: {better} is better "
        f"({t_metrics['accuracy_at_10']:.4f} vs {u_metrics['accuracy_at_10']:.4f})"
    )
    if t_metrics["accuracy_at_10"] < u_metrics["accuracy_at_10"]:
        print("  -> Trained model underperforming untrained may indicate overfitting or collapse.")
    delta = t_metrics["ndcg_at_10"] - u_metrics["ndcg_at_10"]
    print(f"  NDCG@10 delta (trained - untrained): {delta:+.4f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
