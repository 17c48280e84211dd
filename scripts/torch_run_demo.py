"""End-to-end demo on the port: synthetic data -> prep -> train -> serve -> API smoke test.

The port's counterpart of ``scripts/run_demo.py``: one command that runs the
whole system on the GPU (no external data needed), in five stages, each a
function of its own:

1. synthetic Instacart CSVs (``data/synthetic.py``);
2. the data prep (``InstacartDataPrep``, eval_frac 0.15);
3. training from a random MiniLM-L6 tower (``TwoTowerTrainer``: 3 epochs,
   batch 32, seq 128, lr 2e-4, an 8,000-word vocab);
4. one recommendation through ``MonitoredRecommender``;
5. the HTTP API (``create_app`` on ``api.http``'s server, in a thread):
   /ready, /recommend, /feedback and /metrics over the standard library's
   HTTP client; the server is shut down afterwards.

    python scripts/torch_run_demo.py [--workdir demo_workspace] [--epochs 3] [--device cuda]
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
import threading
import time
import urllib.request
from pathlib import Path

from instacart_next_order_recommendation_tpu_torch.constants import (
    ENV_FEEDBACK_DB_PATH,
    EVAL_CORPUS_FILENAME,
    EVAL_QUERIES_FILENAME,
)
from instacart_next_order_recommendation_tpu_torch.utils.logging import setup_colored_logging

READY_POLLS = 100  # /ready polls, 0.2 s apart


def http_get(url: str, timeout: float = 10):
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return resp.status, resp.read()


def http_post(url: str, body: dict, timeout: float = 60):
    req = urllib.request.Request(
        url, data=json.dumps(body).encode(), method="POST",
        headers={"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.status, json.loads(resp.read())


def stage_data(base: Path, users: int, products: int) -> Path:
    """Stages 1-2: synthetic CSVs under ``base/data``, prepared into
    ``base/processed``; returns the param subdir."""
    print("\n=== 1/5 Synthetic Instacart data ===")
    from instacart_next_order_recommendation_tpu_torch.data.synthetic import (
        generate_instacart_csvs,
    )

    data_dir = generate_instacart_csvs(base / "data", n_users=users, n_products=products, seed=0)

    print("\n=== 2/5 Data prep ===")
    from instacart_next_order_recommendation_tpu_torch.data import InstacartDataPrep

    prep = InstacartDataPrep(data_dir=data_dir, output_dir=base / "processed", eval_frac=0.15)
    prep.prepare()
    return prep.effective_output_dir()


def stage_train(processed: Path, base: Path, epochs: int, device=None) -> dict:
    """Stage 3: trains a MiniLM-L6 tower; returns the trainer's result with
    ``steps``, the optimizer steps taken."""
    print("\n=== 3/5 Training ===")
    from instacart_next_order_recommendation_tpu_torch.train import TrainConfig, TwoTowerTrainer

    cfg = TrainConfig(
        {
            "processed_dir": str(processed),
            "output_dir": str(base / "model"),
            "max_seq_length": 128,
            "epochs": epochs,
            "train_batch_size": 32,
            "eval_batch_size": 128,
            "learning_rate": 2e-4,
            "vocab_size": 8000,
            "logging_steps": 50,
        }
    )
    trainer = TwoTowerTrainer(cfg, device=device)
    result = trainer.train()
    result["steps"] = len(trainer.step_losses)
    print(f"trained {result['steps']} steps; final export at {result['final_dir']}")
    return result


def stage_recommend(final_dir: str, processed: Path, device=None) -> tuple[str, list]:
    """Stage 4: one recommendation for the first eval query; returns the
    query and its top 5."""
    print("\n=== 4/5 CLI-style recommendation ===")
    from instacart_next_order_recommendation_tpu_torch.serve import MonitoredRecommender

    rec = MonitoredRecommender(
        model_dir=final_dir, corpus_path=processed / EVAL_CORPUS_FILENAME, device=device
    )
    eval_queries = json.loads((processed / EVAL_QUERIES_FILENAME).read_text())
    demo_qid, demo_query = next(iter(eval_queries.items()))
    print(f"query (order {demo_qid}): {demo_query[:120]}...")
    top = rec.recommend(demo_query, top_k=5)
    for i, (pid, score) in enumerate(top, 1):
        print(f"  {i}. [{score:.4f}] {rec.pid_to_text[pid]}")
    m = rec.last_metrics
    print(f"  latency: {m.total_latency_ms:.1f} ms (encode {m.query_embedding_time_ms:.1f} ms)")
    return demo_query, top


def stage_api(
    final_dir: str, processed: Path, base: Path, port: int, query: str, device=None
) -> dict:
    """Stage 5: the HTTP API on ``port`` (0: any free port), driven over
    local sockets, then shut down. Returns the /recommend body and the
    statuses."""
    print("\n=== 5/5 API smoke test ===")
    os.environ[ENV_FEEDBACK_DB_PATH] = str(base / "feedback.db")
    from instacart_next_order_recommendation_tpu_torch.api import create_app
    from instacart_next_order_recommendation_tpu_torch.api.http import make_server

    app = create_app(
        model_dir=final_dir, corpus_path=processed / EVAL_CORPUS_FILENAME, device=device
    )
    server = make_server(app, "127.0.0.1", port)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        for _ in range(READY_POLLS):
            try:
                if json.loads(http_get(f"{url}/ready", timeout=2)[1]).get("status") == "ready":
                    break
            except OSError:
                pass
            time.sleep(0.2)
        status, body = http_post(f"{url}/recommend", {"user_context": query, "top_k": 3})
        print(f"POST /recommend -> {status}, {len(body['recommendations'])} items")
        fb_status, fb = http_post(
            f"{url}/feedback",
            {
                "request_id": body["request_id"],
                "event_type": "purchase",
                "product_id": body["recommendations"][0]["product_id"],
            },
            timeout=10,
        )
        print(f"POST /feedback  -> {fb_status} {fb}")
        metrics_text = http_get(f"{url}/metrics")[1].decode()
        served = [
            ln for ln in metrics_text.splitlines() if ln.startswith("recommendation_requests_total")
        ]
        print("metrics:", *served[:2], sep="\n  ")
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
        app.shutdown()
    return {"recommend_status": status, "recommend": body, "feedback_status": fb_status,
            "metrics": served}


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description="Run the end-to-end demo")
    parser.add_argument("--workdir", type=Path, default=Path("demo_workspace"))
    parser.add_argument("--epochs", type=int, default=3)
    parser.add_argument("--users", type=int, default=500)
    parser.add_argument("--products", type=int, default=800)
    parser.add_argument("--port", type=int, default=8123)
    parser.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = parser.parse_args(argv)

    setup_colored_logging(quiet_loggers=["datasets"])
    base = args.workdir
    base.mkdir(parents=True, exist_ok=True)

    processed = stage_data(base, args.users, args.products)
    result = stage_train(processed, base, args.epochs, args.device)
    query, _ = stage_recommend(result["final_dir"], processed, args.device)
    stage_api(result["final_dir"], processed, base, args.port, query, args.device)
    print("\nDemo complete.")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
