"""Synthetic-workspace tower revalidation on the port: generate -> prep -> train -> report.

The port's counterpart of ``scripts/reval_tower.py``: builds a synthetic
Instacart-schema workspace of the requested size, runs the data prep,
trains the chosen preset (or warm-starts from a checkpoint directory) for N
epochs through ``TwoTowerTrainer``, and prints the per-epoch history as one
JSON line.

Examples:
  python scripts/torch_reval_tower.py --model mpnet-base --epochs 1 --batch 32
  python scripts/torch_reval_tower.py --model minilm-l6 --users 2000 --products 4000
"""

from __future__ import annotations

import sys as _sys
from pathlib import Path as _Path

_REPO_ROOT = _Path(__file__).resolve().parents[1]
if str(_REPO_ROOT) not in _sys.path:
    _sys.path.insert(0, str(_REPO_ROOT))

import argparse
import json
import tempfile
import time
from pathlib import Path


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description="Synthetic tower revalidation run")
    parser.add_argument("--model", default="mpnet-base",
                        help="preset name or checkpoint path (trainer model_name)")
    parser.add_argument("--users", type=int, default=2000)
    parser.add_argument("--products", type=int, default=4000)
    parser.add_argument("--epochs", type=int, default=1)
    parser.add_argument("--batch", type=int, default=32)
    parser.add_argument("--seq-length", type=int, default=128)
    parser.add_argument("--learning-rate", type=float, default=2e-4)
    parser.add_argument("--seed", type=int, default=42)
    # Context-length shaping: deeper order histories and bigger baskets make
    # the prepared user contexts fill the seq budget; at the defaults the
    # synthetic contexts tokenize to ~100 tokens, so a `max_seq_length: 256`
    # config effectively trains at S=128.
    parser.add_argument("--orders-per-user", type=int, nargs=2, default=(4, 9),
                        metavar=("LO", "HI"))
    parser.add_argument("--basket-size", type=int, nargs=2, default=(3, 10),
                        metavar=("LO", "HI"))
    parser.add_argument("--max-prior-orders", type=int, default=5,
                        help="data-prep context depth (reference p5)")
    parser.add_argument("--max-product-names", type=int, default=20,
                        help="data-prep TOTAL product-name cap across the "
                        "context (reference mp20); the binding bound on "
                        "context token length for short synthetic names")
    parser.add_argument("--long-names", action="store_true",
                        help="real-name geometry (6-10 word product names): "
                        "the p5_mp20 context fills ~250 tokens like the "
                        "real CSVs do, with the SAME 20-name task "
                        "structure as the short-name runs")
    parser.add_argument("--workdir", type=Path, default=None,
                        help="workspace dir (default: fresh temp dir)")
    parser.add_argument("--no-eval", action="store_true",
                        help="skip the per-epoch IR evaluator")
    parser.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = parser.parse_args(argv)

    from instacart_next_order_recommendation_tpu_torch.data import InstacartDataPrep
    from instacart_next_order_recommendation_tpu_torch.data.synthetic import (
        generate_instacart_csvs,
    )
    from instacart_next_order_recommendation_tpu_torch.train import (
        TrainConfig,
        TwoTowerTrainer,
    )
    from instacart_next_order_recommendation_tpu_torch.utils.logging import (
        setup_colored_logging,
    )

    setup_colored_logging()
    base = args.workdir or Path(tempfile.mkdtemp(prefix="reval_tower_"))
    base.mkdir(parents=True, exist_ok=True)

    t0 = time.time()
    data_dir = generate_instacart_csvs(
        base / "data", n_users=args.users, n_products=args.products, seed=0,
        orders_per_user=tuple(args.orders_per_user),
        basket_size=tuple(args.basket_size),
        long_names=args.long_names,
    )
    prep = InstacartDataPrep(
        data_dir=data_dir, output_dir=base / "processed", eval_frac=0.1,
        max_prior_orders=args.max_prior_orders,
        max_product_names=args.max_product_names,
    )
    prep.prepare()

    cfg = TrainConfig({
        "processed_dir": str(prep.effective_output_dir()),
        "output_dir": str(base / "out"),
        "model_name": args.model,
        "epochs": args.epochs,
        "train_batch_size": args.batch,
        "max_seq_length": args.seq_length,
        "learning_rate": args.learning_rate,
        "seed": args.seed,
        "logging_steps": 50,
        "run_information_retrieval_evaluator": not args.no_eval,
        "vocab_size": 30000,
    })
    result = TwoTowerTrainer(cfg, device=args.device).train()
    print(json.dumps({
        "model": args.model,
        "workdir": str(base),
        "total_seconds": round(time.time() - t0, 1),
        "history": result["history"],
    }), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
