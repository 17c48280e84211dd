"""One-command real-data parity runbook on the port: Kaggle CSVs -> BASELINE.md table.

The port's counterpart of ``scripts/real_data_run.py``. The quality targets in
BASELINE.md (Recall@10 0.129, MRR@10 0.331, NDCG@10 0.153) are measured on
the real Instacart dataset, which is not redistributable. This script makes
the parity number fall out the moment the data exists:

    1. Drop the six Kaggle CSVs (orders.csv, products.csv, aisles.csv,
       departments.csv, order_products__prior.csv, order_products__train.csv)
       into ``data/instacart/`` (or pass --data-dir / set
       ITOR_REAL_DATA_DIR).
    2. Drop a ``sentence-transformers/all-MiniLM-L6-v2`` checkpoint dir
       (config.json + model.safetensors|pytorch_model.bin + vocab.txt) into
       ``models/all-MiniLM-L6-v2`` (or --base-model / ITOR_BASE_MODEL_DIR).
    3. Run ``python scripts/torch_real_data_run.py`` on a machine with an
       NVIDIA GPU.

It then runs the reference recipe through the port: data prep at
p5_mp20_ef0.1, a 5-epoch warm start at batch 64 / seq 256 / lr 5e-5 / MNRL
scale 30 with per-epoch IR eval, the content-based and item-item CF
baselines, and the untrained-vs-trained collapse diagnostics; it prints the
side-by-side per-epoch table against the reference's published numbers and
writes it to ``--results`` (by default ``REAL_RESULTS.md`` in ``--workdir``,
``torch_real_ws/``: names of the port's own, apart from the JAX runbook's
``real_ws/`` and ``REAL_RESULTS.md``).

``--check`` validates the prerequisites and exits without running anything.
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
import os
import time
from pathlib import Path

REQUIRED_CSVS = (
    "orders.csv",
    "products.csv",
    "aisles.csv",
    "departments.csv",
    "order_products__prior.csv",
    "order_products__train.csv",
)

# Reference per-epoch results on the real dataset (recorded in BASELINE.md).
# Keys match eval_history.json's fields.
REFERENCE_EPOCHS = {
    "accuracy_at_1": (0.210, 0.226, 0.239, 0.239, 0.232),
    "accuracy_at_10": (0.464, 0.507, 0.532, 0.540, 0.538),
    "recall_at_10": (0.103, 0.116, 0.125, 0.129, 0.128),
    "mrr_at_10": (0.287, 0.311, 0.329, 0.331, 0.325),
    "ndcg_at_10": (0.125, 0.139, 0.150, 0.153, 0.151),
    "map_at_100": (0.071, 0.078, 0.085, 0.086, 0.085),
}

# Reference baselines on the same eval set (recorded in BASELINE.md).
REFERENCE_BASELINES = {
    "content_based": {
        "accuracy_at_1": 0.046, "accuracy_at_10": 0.136, "recall_at_10": 0.030,
        "mrr_at_10": 0.071, "ndcg_at_10": 0.086, "map_at_100": 0.018,
    },
    "item_item_cf": {
        "accuracy_at_1": 0.030, "accuracy_at_10": 0.148, "recall_at_10": 0.017,
        "mrr_at_10": 0.059, "ndcg_at_10": 0.080, "map_at_100": 0.010,
    },
}

METRIC_KEYS = tuple(REFERENCE_EPOCHS.keys())


def format_baseline_table(rows: dict[str, dict]) -> str:
    """``rows``: label -> metrics dict (ours); reference values side by side."""
    lines = [
        "| Baseline | " + " | ".join(METRIC_KEYS) + " |",
        "|---|" + "---|" * len(METRIC_KEYS),
    ]
    for key, label in (
        ("content_based", "Content-based (untrained tower)"),
        ("item_item_cf", "Item-item CF"),
    ):
        if key not in rows:
            continue
        ours, ref = rows[key], REFERENCE_BASELINES[key]
        cells = [f"{ours[m]:.3f} / {ref[m]:.3f}" for m in METRIC_KEYS]
        lines.append(f"| {label} (ours / ref) | " + " | ".join(cells) + " |")
    return "\n".join(lines)


def check_prerequisites(data_dir: Path, base_model: Path) -> list[str]:
    """Returns a list of human-readable problems; empty = ready to run."""
    problems: list[str] = []
    if not data_dir.is_dir():
        problems.append(f"data dir {data_dir} does not exist")
    else:
        for name in REQUIRED_CSVS:
            if not (data_dir / name).is_file():
                problems.append(f"missing CSV: {data_dir / name}")
    if not base_model.is_dir():
        problems.append(f"base model dir {base_model} does not exist")
    else:
        if not (base_model / "config.json").is_file():
            problems.append(f"missing {base_model / 'config.json'}")
        if not any((base_model / w).is_file() for w in ("model.safetensors", "pytorch_model.bin")):
            problems.append(
                f"missing weights in {base_model} (model.safetensors or pytorch_model.bin)"
            )
        if not (base_model / "vocab.txt").is_file():
            problems.append(f"missing {base_model / 'vocab.txt'} (WordPiece vocab)")
    return problems


def format_table(history: list[dict]) -> str:
    """Side-by-side ours-vs-reference per-epoch table (markdown)."""
    lines = [
        "| Metric | " + " | ".join(f"E{i + 1} ours / ref" for i in range(5)) + " |",
        "|---|" + "---|" * 5,
    ]
    for metric, ref_vals in REFERENCE_EPOCHS.items():
        cells = []
        for i in range(5):
            ours = next((h.get(metric) for h in history if h.get("epoch") == i + 1), None)
            ours_s = f"{ours:.3f}" if ours is not None else "—"
            cells.append(f"{ours_s} / {ref_vals[i]:.3f}")
        lines.append(f"| {metric} | " + " | ".join(cells) + " |")
    return "\n".join(lines)


def build_parser() -> argparse.ArgumentParser:
    """The JAX runbook's flags. The work directory and the results file
    default to names of the port's own (``torch_real_ws/``, the results in
    it), so that a port run never overwrites a JAX run's ``real_ws/`` or
    ``REAL_RESULTS.md``."""
    parser = argparse.ArgumentParser(description="Real-data parity run")
    parser.add_argument(
        "--data-dir",
        type=Path,
        default=Path(os.getenv("ITOR_REAL_DATA_DIR", "data/instacart")),
        help="Directory holding the six Kaggle Instacart CSVs",
    )
    parser.add_argument(
        "--base-model",
        type=Path,
        default=Path(os.getenv("ITOR_BASE_MODEL_DIR", "models/all-MiniLM-L6-v2")),
        help="all-MiniLM-L6-v2 checkpoint dir (HF or sentence-transformers format)",
    )
    parser.add_argument("--workdir", type=Path, default=Path("torch_real_ws"))
    parser.add_argument("--epochs", type=int, default=5)
    parser.add_argument("--train-batch-size", type=int, default=64)
    parser.add_argument("--max-seq-length", type=int, default=256)
    parser.add_argument("--learning-rate", type=float, default=5e-5)
    parser.add_argument(
        "--eval-frac", type=float, default=0.1, help="reference data_prep.yaml eval_frac"
    )
    parser.add_argument(
        "--steps-per-dispatch", type=int, default=8,
        help="batches taken per group (a ragged trailing group is dropped)",
    )
    parser.add_argument(
        "--results", type=Path, default=None,
        help="where to write the side-by-side table (default: <workdir>/REAL_RESULTS.md)",
    )
    parser.add_argument(
        "--check", action="store_true",
        help="only validate prerequisites (data + checkpoint present), then exit",
    )
    parser.add_argument(
        "--skip-baselines", action="store_true",
        help="skip the content-based + item-item CF baseline rows",
    )
    parser.add_argument(
        "--skip-compare", action="store_true",
        help="skip the untrained-vs-trained collapse diagnostics",
    )
    parser.add_argument(
        "--compare-sample-queries", type=int, default=None,
        help="subsample eval queries for the collapse compare (full set by default)",
    )
    parser.add_argument("--device", default=None, help="cuda (the default) or cpu")
    return parser


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    if args.results is None:
        args.results = args.workdir / "REAL_RESULTS.md"

    problems = check_prerequisites(args.data_dir, args.base_model)
    if problems:
        print("NOT READY — real-data run prerequisites missing:")
        for p in problems:
            print(f"  - {p}")
        print(
            "\nPlace the Kaggle CSVs and the all-MiniLM-L6-v2 checkpoint as"
            " described in scripts/torch_real_data_run.py, then re-run."
        )
        return 1
    print(f"prerequisites OK: data={args.data_dir} base_model={args.base_model}")
    if args.check:
        return 0

    from instacart_next_order_recommendation_tpu_torch.utils.logging import (
        setup_colored_logging,
    )

    setup_colored_logging(quiet_loggers=["datasets"])
    args.workdir.mkdir(parents=True, exist_ok=True)

    print("\n=== 1/5 Data prep (reference recipe: p5_mp20_ef%.1g) ===" % args.eval_frac)
    from instacart_next_order_recommendation_tpu_torch.data import InstacartDataPrep

    prep = InstacartDataPrep(
        data_dir=args.data_dir,
        output_dir=args.workdir / "processed",
        max_prior_orders=5,
        max_product_names=20,
        eval_frac=args.eval_frac,
    )
    processed = prep.effective_output_dir()
    if (processed / "train_dataset").exists():
        print(f"processed artifacts already at {processed}; skipping prep")
    else:
        t0 = time.time()
        prep.prepare()
        print(f"prep done in {time.time() - t0:.0f}s -> {processed}")

    print("\n=== 2/5 Warm-started training (reference train.yaml recipe) ===")
    from instacart_next_order_recommendation_tpu_torch.train import TrainConfig, TwoTowerTrainer

    cfg = TrainConfig(
        {
            "processed_dir": str(processed),
            "output_dir": str(args.workdir / "model"),
            "model_name": str(args.base_model),  # warm start from the checkpoint
            "max_seq_length": args.max_seq_length,
            "epochs": args.epochs,
            "train_batch_size": args.train_batch_size,
            "eval_batch_size": 256,
            "learning_rate": args.learning_rate,
            "loss_scale": 30.0,
            "run_information_retrieval_evaluator": True,
            "steps_per_dispatch": args.steps_per_dispatch,
        }
    )
    result = TwoTowerTrainer(cfg, device=args.device).train()
    print(f"training done; final export at {result['final_dir']}")

    from instacart_next_order_recommendation_tpu_torch.baselines.collaborative_filtering import (
        load_eval_data,
    )
    from instacart_next_order_recommendation_tpu_torch.models.text_encoder import TextEncoder

    print("\n=== 3/5 Baselines on the same eval set ===")
    baseline_rows: dict[str, dict] = {}
    if args.skip_baselines:
        print("skipped (--skip-baselines)")
    else:
        from instacart_next_order_recommendation_tpu_torch.baselines import (
            ContentBasedBaseline,
            ItemItemCFBaseline,
        )
        from instacart_next_order_recommendation_tpu_torch.eval.metrics import (
            compute_ir_metrics,
            format_metrics,
        )

        eval_queries, eval_corpus, eval_relevant = load_eval_data(processed)
        t0 = time.time()
        # Cap the untrained tower at the run's seq length: checkpoints may
        # carry a shorter position table than TextEncoder's default.
        cb = ContentBasedBaseline(
            eval_queries,
            eval_corpus,
            model=TextEncoder.load(
                args.base_model, max_seq_length=args.max_seq_length, device=args.device
            ),
        )
        baseline_rows["content_based"] = compute_ir_metrics(cb.rank_all(), eval_relevant)
        print(format_metrics("Content-based (untrained tower)", baseline_rows["content_based"]))
        print(f"  ({time.time() - t0:.0f}s)")
        t0 = time.time()
        cf = ItemItemCFBaseline(args.data_dir, processed)
        baseline_rows["item_item_cf"] = compute_ir_metrics(
            cf.rank_all(eval_query_ids=list(eval_queries.keys())), eval_relevant
        )
        print(format_metrics("Collaborative filtering (item-item)", baseline_rows["item_item_cf"]))
        print(f"  ({time.time() - t0:.0f}s)")

    print("\n=== 4/5 Collapse diagnostics: untrained vs trained ===")
    collapse_block = ""
    if args.skip_compare:
        print("skipped (--skip-compare)")
    else:
        import random

        from scripts.torch_compare_untrained_vs_trained import (
            embedding_collapse_metrics,
            evaluate_encoder,
        )

        eval_queries, eval_corpus, eval_relevant = load_eval_data(processed)
        if args.compare_sample_queries and args.compare_sample_queries < len(eval_queries):
            rng = random.Random(123)
            qids = rng.sample(list(eval_queries.keys()), args.compare_sample_queries)
            eval_queries = {q: eval_queries[q] for q in qids}
            eval_relevant = {q: eval_relevant[q] for q in qids if q in eval_relevant}
        u_metrics, u_q, u_c = evaluate_encoder(
            TextEncoder.load(
                args.base_model, max_seq_length=args.max_seq_length, device=args.device
            ),
            eval_queries, eval_corpus, eval_relevant, 256,
        )
        t_metrics, t_q, t_c = evaluate_encoder(
            TextEncoder.load(
                result["final_dir"], max_seq_length=args.max_seq_length, device=args.device
            ),
            eval_queries, eval_corpus, eval_relevant, 256,
        )
        collapse = {
            **embedding_collapse_metrics(u_q, u_c, "untrained"),
            **embedding_collapse_metrics(t_q, t_c, "trained"),
        }
        delta = t_metrics["ndcg_at_10"] - u_metrics["ndcg_at_10"]
        verdict = (
            "trained better" if delta >= 0 else
            "TRAINED UNDERPERFORMS UNTRAINED (possible overfit/collapse)"
        )
        collapse_block = (
            "## Collapse diagnostics (untrained vs trained)\n\n"
            f"- NDCG@10: untrained {u_metrics['ndcg_at_10']:.4f} -> trained "
            f"{t_metrics['ndcg_at_10']:.4f} (delta {delta:+.4f}; {verdict})\n"
            f"- corpus mean pairwise cos-sim: untrained "
            f"{collapse['untrained_corpus_mean_pairwise_cos_sim']:.4f} -> trained "
            f"{collapse['trained_corpus_mean_pairwise_cos_sim']:.4f}\n"
            f"- corpus mean per-dim std: untrained "
            f"{collapse['untrained_corpus_mean_std_per_dim']:.4f} -> trained "
            f"{collapse['trained_corpus_mean_std_per_dim']:.4f}\n"
        )
        print(collapse_block)

    print("\n=== 5/5 Side-by-side vs reference (BASELINE.md) ===")
    history = json.loads((args.workdir / "model" / "eval_history.json").read_text())
    best = json.loads((args.workdir / "model" / "best.json").read_text())
    table = format_table(history)
    print(table)
    baseline_table = format_baseline_table(baseline_rows) if baseline_rows else ""
    if baseline_table:
        print("\n" + baseline_table)
    report = (
        "# Real-data parity results\n\n"
        f"Recipe: p5_mp20_ef{args.eval_frac} prep, warm start from "
        f"`{args.base_model}`, {args.epochs} epochs, batch "
        f"{args.train_batch_size}, seq {args.max_seq_length}, lr "
        f"{args.learning_rate}, MNRL scale 30 (reference configs/train.yaml).\n\n"
        f"Best checkpoint: epoch {best['best_epoch']} by {best['metric']}.\n\n"
        f"## Trained two-tower, per epoch\n\n{table}\n\n"
        + (f"## Baselines (same eval set)\n\n{baseline_table}\n\n" if baseline_table else "")
        + (collapse_block + "\n" if collapse_block else "")
        + "Reference numbers: the reference repo's README (recorded in "
        "BASELINE.md). Parity target: Recall@10 / MRR@10 within "
        "run-to-run variance of the bolded reference epochs.\n"
    )
    args.results.write_text(report)
    print(f"\nwrote {args.results}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
