"""Feedback-weighted retraining: the merged dataset, the scheduler and the deploy gate.

The port's counterpart of ``scripts/feedback_retrain.py``, on the port's
``api/feedback_store`` (the same SQLite schema) and ``TwoTowerTrainer``.
It mines the feedback DB for engagement events that carry the serving
context (the server-side ``request_contexts`` rows written by /recommend,
else a client-echoed ``metadata.user_context``) and turns them into extra
(anchor, positive) training pairs, weighted by funnel depth (purchase >
add_to_cart > click). The output is a processed-format dataset directory
(``<processed>_fb``) that the trainer reads directly. As a scheduler it
retrains once enough new feedback has arrived, and with ``--serve-url``
deploys a run that passes the eval gate through ``POST /admin/model``.

    python scripts/torch_feedback_retrain.py --processed-dir processed/p5_mp20_ef0.1
    python scripts/torch_feedback_retrain.py --once --train-config configs/train.yaml \\
        --serve-url http://localhost:8000 [--device cuda]
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
import logging
import os
import sqlite3
import time
import urllib.request
from pathlib import Path

from instacart_next_order_recommendation_tpu_torch.api.feedback_store import (
    get_db_path,
    init_db,
    load_context_events,
)
from instacart_next_order_recommendation_tpu_torch.constants import (
    DEFAULT_PROCESSED_DIR,
    EVAL_CORPUS_FILENAME,
)
from instacart_next_order_recommendation_tpu_torch.utils.logging import setup_colored_logging
from instacart_next_order_recommendation_tpu_torch.utils.resolve import resolve_processed_dir

logger = logging.getLogger(__name__)

DEFAULT_WEIGHTS = {"purchase": 3, "add_to_cart": 2, "click": 1}


def build_weighted_pairs(
    events_with_context: list[tuple[str, str, str]],
    corpus: dict[str, str],
    weights: dict[str, int] | None = None,
) -> tuple[list[str], list[str]]:
    """(event_type, user_context, product_id) -> weighted (anchor, positive) pairs.

    Weighting = pair repetition (MNRL has no per-sample weight input; repeating
    a pair k times is the in-batch-negatives equivalent).
    """
    weights = weights or DEFAULT_WEIGHTS
    anchors: list[str] = []
    positives: list[str] = []
    for event_type, context, product_id in events_with_context:
        w = weights.get(event_type, 0)
        text = corpus.get(product_id)
        if w <= 0 or not context or text is None:
            continue
        anchors.extend([context] * w)
        positives.extend([text] * w)
    return anchors, positives


def extract_context_events(db_path: Path, since: str | None = None) -> list[tuple[str, str, str]]:
    """Pull (event_type, user_context, product_id) rows with a serving context.

    One row per feedback event. The serving context comes from the
    server-side ``request_contexts`` table (written by /recommend) when the
    event's request_id has one; otherwise from client-echoed
    ``metadata.user_context`` (legacy fallback).
    """
    if not db_path.exists():
        return []

    out = list(load_context_events(db_path, since=since))

    conn = sqlite3.connect(db_path)
    try:
        rows = conn.execute(
            "SELECT event_type, metadata, product_id FROM feedback_events "
            "WHERE metadata IS NOT NULL AND (request_id IS NULL OR request_id NOT IN "
            "(SELECT request_id FROM request_contexts))"
            + (" AND created_at >= ?" if since else ""),
            (since,) if since else (),
        ).fetchall()
    finally:
        conn.close()
    for event_type, metadata, product_id in rows:
        try:
            meta = json.loads(metadata)
        except (TypeError, json.JSONDecodeError):
            continue
        context = meta.get("user_context") if isinstance(meta, dict) else None
        if context:
            out.append((str(event_type), str(context), str(product_id)))
    return out


def build_dataset(
    processed_dir: Path, db_path: Path, since: str | None = None, output_dir: Path | None = None
) -> Path | None:
    """Mine feedback into a merged processed-format dataset dir (or None)."""
    if processed_dir.name.endswith("_fb"):
        # A previously merged feedback dataset resolved as the input (e.g. a
        # scheduler restart after auto-resolution): merge against the ORIGINAL
        # prep output, or every restart would re-add all historical feedback
        # pairs on top of the already-augmented set.
        base = processed_dir.with_name(processed_dir.name[: -len("_fb")])
        if (base / "train_dataset").exists():
            logger.info("using base dataset %s (input was a _fb merge)", base)
            processed_dir = base
    corpus = json.loads((processed_dir / EVAL_CORPUS_FILENAME).read_text())
    events = extract_context_events(db_path, since=since)
    anchors, positives = build_weighted_pairs(events, corpus)
    if not anchors:
        return None

    from datasets import Dataset, concatenate_datasets, load_from_disk

    base_train = load_from_disk(str(processed_dir / "train_dataset"))
    feedback_ds = Dataset.from_dict({"anchor": anchors, "positive": positives})
    merged = concatenate_datasets([base_train, feedback_ds])

    out_dir = output_dir or processed_dir.parent / f"{processed_dir.name}_fb"
    out_dir.mkdir(parents=True, exist_ok=True)
    merged.save_to_disk(str(out_dir / "train_dataset"))
    for fname in (
        "eval_queries.json",
        "eval_corpus.json",
        "eval_relevant_docs.json",
        "data_prep_params.json",
    ):
        src = processed_dir / fname
        if src.exists():
            (out_dir / fname).write_text(src.read_text())
    logger.info(
        "Wrote %d train pairs (%d from feedback) to %s", len(merged), len(feedback_ds), out_dir
    )
    return out_dir


# --------------------------------------------------------------- scheduling

def count_new_events(db_path: Path, last_event_id: int) -> tuple[int, int]:
    """(n_new, max_id) of feedback events beyond ``last_event_id``."""
    if not db_path.exists():
        return 0, last_event_id
    conn = sqlite3.connect(db_path)
    try:
        n, mx = conn.execute(
            "SELECT COUNT(*), COALESCE(MAX(id), ?) FROM feedback_events WHERE id > ?",
            (last_event_id, last_event_id),
        ).fetchone()
    finally:
        conn.close()
    return int(n), int(mx)


def load_scheduler_state(path: Path) -> dict:
    if path.exists():
        try:
            return json.loads(path.read_text())
        except (OSError, json.JSONDecodeError):
            pass
    return {"last_event_id": 0, "runs": 0}


def check_eval_gate(
    run_dir: Path, state: dict, gate_metric: str, min_improvement: float
) -> tuple[bool, float | None]:
    """Deploy gate: the new run's best eval metric (best.json) must beat the
    last deployed value by ``min_improvement``. (pass, new_metric)."""
    try:
        best = json.loads((run_dir / "best.json").read_text())
    except (OSError, json.JSONDecodeError):
        return False, None
    entry = best.get("entry") or {}
    new_metric = entry.get(gate_metric)
    if new_metric is None:
        return False, None
    deployed = state.get("deployed_metric")
    if deployed is not None and new_metric < deployed + min_improvement:
        return False, float(new_metric)
    return True, float(new_metric)


def deploy_model(serve_url: str, model_dir: Path, api_key: str | None = None) -> dict:
    """POST the checkpoint to the server's /admin/model hot-swap endpoint."""
    body = json.dumps({"model_dir": str(model_dir)}).encode()
    req = urllib.request.Request(
        serve_url.rstrip("/") + "/admin/model",
        data=body,
        headers={"Content-Type": "application/json"},
        method="POST",
    )
    key = api_key or os.getenv("API_KEY")
    if key:
        req.add_header("X-API-Key", key)
    with urllib.request.urlopen(req, timeout=600) as resp:
        return json.loads(resp.read())


def retrain_once(
    processed_dir: Path,
    db_path: Path,
    state_path: Path,
    min_new_events: int,
    train_config: Path | None,
    output_dir: Path | None = None,
    serve_url: str | None = None,
    gate_metric: str = "ndcg_at_10",
    min_improvement: float = 0.0,
    since: str | None = None,
    device=None,
) -> bool:
    """One scheduler tick: build the dataset (and retrain) when enough new
    feedback has accumulated since the last run. Returns True if it ran.

    With ``serve_url`` set, a run that passes the eval gate (best.json
    ``gate_metric`` beats the last deployed value by ``min_improvement``) is
    auto-deployed via POST /admin/model; failing runs leave serving untouched.
    ``device`` is the trainer's (None: the GPU).
    """
    state = load_scheduler_state(state_path)
    n_new, max_id = count_new_events(db_path, state.get("last_event_id", 0))
    if n_new < min_new_events:
        logger.info("retrain skipped: %d new events (< %d)", n_new, min_new_events)
        return False

    out_dir = build_dataset(processed_dir, db_path, since=since, output_dir=output_dir)
    if out_dir is None:
        logger.info("retrain skipped: no events with serving context")
        return False

    if train_config is not None:
        from instacart_next_order_recommendation_tpu_torch.train.trainer import (
            TrainConfig,
            TwoTowerTrainer,
        )
        from instacart_next_order_recommendation_tpu_torch.utils.config import load_yaml_config

        raw = load_yaml_config(train_config, train_config)
        raw["processed_dir"] = str(out_dir)
        # Per-run output dir keyed by the event watermark: the trainer
        # unconditionally overwrites <output_dir>/final, so training a run
        # that then FAILS the eval gate must not clobber the checkpoint the
        # deployed model was loaded from.
        if "output_dir" in raw and serve_url:
            raw["output_dir"] = str(Path(raw["output_dir"]) / f"run-{max_id}")
        cfg = TrainConfig(raw)
        trainer = TwoTowerTrainer(cfg, device=device)
        result = trainer.train()

        if serve_url:
            passed, new_metric = check_eval_gate(
                cfg.output_dir, state, gate_metric, min_improvement
            )
            if passed:
                final_dir = Path(result["final_dir"])
                try:
                    deploy_model(serve_url, final_dir)
                except Exception:
                    logger.exception("model deploy failed; keeping previous model")
                else:
                    state["deployed_metric"] = new_metric
                    state["deployed_model"] = str(final_dir)
                    logger.info(
                        "model_deployed %s=%s model=%s", gate_metric, new_metric, final_dir
                    )
            else:
                logger.info(
                    "eval gate failed: %s=%s (deployed=%s, min_improvement=%s); not deploying",
                    gate_metric,
                    new_metric,
                    state.get("deployed_metric"),
                    min_improvement,
                )

    state["last_event_id"] = max_id
    state["runs"] = state.get("runs", 0) + 1
    state_path.parent.mkdir(parents=True, exist_ok=True)
    state_path.write_text(json.dumps(state))
    return True


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        description="Build a feedback-weighted retrain dataset (optionally on a schedule)"
    )
    parser.add_argument("--processed-dir", type=Path, default=None)
    parser.add_argument("--output-dir", type=Path, required=False, default=None)
    parser.add_argument("--since", default=None)
    parser.add_argument(
        "--interval", type=float, default=None,
        help="Run as a scheduler: seconds between retrain checks.",
    )
    parser.add_argument(
        "--min-new-events", type=int, default=100,
        help="Scheduler mode: minimum new feedback events to trigger a run.",
    )
    parser.add_argument(
        "--train-config", type=Path, default=None,
        help="Scheduler mode: train config to run after each dataset build "
        "(set model_name to the current checkpoint for a warm start).",
    )
    parser.add_argument(
        "--state-file", type=Path, default=Path("data/retrain_state.json"),
        help="Scheduler mode: JSON file tracking the last processed event id.",
    )
    parser.add_argument("--once", action="store_true", help="Scheduler mode: single tick.")
    parser.add_argument(
        "--serve-url", default=None,
        help="Auto-deploy: base URL of a running API server; retrained models "
        "that pass the eval gate are hot-swapped via POST /admin/model.",
    )
    parser.add_argument(
        "--gate-metric", default="ndcg_at_10",
        help="Auto-deploy eval gate metric read from the run's best.json.",
    )
    parser.add_argument(
        "--min-improvement", type=float, default=0.0,
        help="Required gate-metric improvement over the last deployed model.",
    )
    parser.add_argument(
        "--device", default=None,
        help="Training device: cuda (the default) or cpu.",
    )
    args = parser.parse_args(argv)
    setup_colored_logging()

    init_db()
    db_path = get_db_path()
    processed_dir, _ = resolve_processed_dir(
        args.processed_dir or DEFAULT_PROCESSED_DIR, DEFAULT_PROCESSED_DIR
    )

    if args.interval is None and not args.once:
        out_dir = build_dataset(
            processed_dir, db_path, since=args.since, output_dir=args.output_dir
        )
        if out_dir is None:
            print("No feedback events with user_context found; nothing to build.")
        return 0

    while True:
        try:
            retrain_once(
                processed_dir,
                db_path,
                args.state_file,
                args.min_new_events,
                args.train_config,
                output_dir=args.output_dir,
                serve_url=args.serve_url,
                gate_metric=args.gate_metric,
                min_improvement=args.min_improvement,
                since=args.since,
                device=args.device,
            )
        except Exception:
            if args.once:
                raise
            # A transient failure (locked sqlite, full disk, OOM run) must
            # not kill the long-running scheduler; the next tick retries.
            logger.exception("retrain tick failed; retrying next interval")
        if args.once:
            return 0
        time.sleep(args.interval)


if __name__ == "__main__":
    raise SystemExit(main())
