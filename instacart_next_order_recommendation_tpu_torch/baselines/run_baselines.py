"""Run the baselines and print the IR metric table.

The port's copy of the JAX package's ``baselines/run_baselines.py``: the
same YAML keys (``processed_dir``, ``data_dir``, ``model``,
``content_only``, ``cf_only``; ``configs/baselines.yaml`` by default), the
shared eval artifacts, and one ``format_metrics`` table per baseline.
``model`` is a tower directory in either package's format or a Hugging Face
one (``load_tower``); without it the content-based baseline is a freshly
initialised MiniLM-L6 on a corpus-trained vocab.

    python -m instacart_next_order_recommendation_tpu_torch.baselines \
        --config configs/baselines.yaml
"""

from __future__ import annotations

import argparse
import logging
from pathlib import Path

import torch

from instacart_next_order_recommendation_tpu_torch.baselines.collaborative_filtering import (
    ItemItemCFBaseline,
    load_eval_data,
)
from instacart_next_order_recommendation_tpu_torch.baselines.content_based import (
    ContentBasedBaseline,
)
from instacart_next_order_recommendation_tpu_torch.constants import (
    DEFAULT_CONFIG_BASELINES,
    DEFAULT_DATA_DIR,
    DEFAULT_PROCESSED_DIR,
)
from instacart_next_order_recommendation_tpu_torch.eval.metrics import (
    compute_ir_metrics,
    format_metrics,
)
from instacart_next_order_recommendation_tpu_torch.utils.config import (
    load_yaml_config,
    resolve_project_path,
)
from instacart_next_order_recommendation_tpu_torch.utils.logging import setup_colored_logging
from instacart_next_order_recommendation_tpu_torch.utils.resolve import resolve_processed_dir

logger = logging.getLogger(__name__)


def load_config(config_path: Path | None = None) -> dict:
    raw = load_yaml_config(config_path, DEFAULT_CONFIG_BASELINES)
    return {
        "processed_dir": resolve_project_path(raw.get("processed_dir"), DEFAULT_PROCESSED_DIR),
        "data_dir": resolve_project_path(raw.get("data_dir"), DEFAULT_DATA_DIR),
        "model": raw.get("model"),  # None = untrained tower
        "content_only": bool(raw.get("content_only", False)),
        "cf_only": bool(raw.get("cf_only", False)),
    }


def main(argv: list[str] | None = None, device: str | torch.device | None = None) -> None:
    """The CLI; ``device`` is where the tower runs (None: the GPU)."""
    parser = argparse.ArgumentParser(description="Run content-based and CF baselines")
    parser.add_argument("--config", type=Path, default=None, help="Path to YAML config")
    args = parser.parse_args(argv)
    setup_colored_logging()

    cfg = load_config(args.config)
    processed_dir, msg = resolve_processed_dir(cfg["processed_dir"], DEFAULT_PROCESSED_DIR)
    if msg:
        logger.info("%s", msg)
    logger.info("Processed dir: %s", processed_dir)

    eval_queries, eval_corpus, eval_relevant_docs = load_eval_data(processed_dir)
    logger.info("Eval queries: %d, corpus size: %d", len(eval_queries), len(eval_corpus))

    if not cfg["cf_only"]:
        logger.info("Building content-based (untrained tower) baseline...")
        cb = ContentBasedBaseline(eval_queries, eval_corpus, model=cfg["model"], device=device)
        cb_metrics = compute_ir_metrics(cb.rank_all(), eval_relevant_docs)
        print(format_metrics("Content-based (untrained tower)", cb_metrics))

    if not cfg["content_only"]:
        logger.info("Building collaborative filtering (item-item) baseline...")
        cf = ItemItemCFBaseline(cfg["data_dir"], processed_dir)
        cf_metrics = compute_ir_metrics(
            cf.rank_all(eval_query_ids=list(eval_queries.keys())), eval_relevant_docs
        )
        print(format_metrics("Collaborative filtering (item-item)", cf_metrics))

    if not cfg["content_only"] and not cfg["cf_only"]:
        print("\n--- Compare with the trained two-tower model (see eval_history.json) ---")


if __name__ == "__main__":
    main()
