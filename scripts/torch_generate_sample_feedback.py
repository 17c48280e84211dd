"""Generate sample recommend + feedback traffic against a running API.

The port's counterpart of ``scripts/generate_sample_feedback.py``, over the
standard library's HTTP client (``urllib.request``): a health pre-check, N
POST /recommend calls (real eval user_ids from eval_queries.json where the
processed data exists, else the canned sample contexts), then one batched
POST /feedback per request with a probabilistic conversion funnel
impression -> click -> add_to_cart -> purchase. For a given seed it sends
the same requests and funnel events as the JAX script.

    python scripts/torch_generate_sample_feedback.py [--config configs/generate_sample_feedback.yaml]
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
import random
import urllib.error
import urllib.request
from pathlib import Path

from instacart_next_order_recommendation_tpu_torch.constants import (
    DEFAULT_CONFIG_GENERATE_SAMPLE_FEEDBACK,
    DEFAULT_PROCESSED_DIR,
    EVAL_QUERIES_FILENAME,
    SAMPLE_USER_CONTEXTS,
)
from instacart_next_order_recommendation_tpu_torch.utils.config import load_yaml_config
from instacart_next_order_recommendation_tpu_torch.utils.resolve import resolve_processed_dir

TIMEOUT_S = 60


def http_json(method: str, url: str, body=None, api_key: str | None = None):
    """One request; returns the decoded JSON body. Raises
    ``urllib.error.HTTPError`` on a status >= 400 and ``urllib.error.URLError``
    (an ``OSError``) when the server cannot be reached."""
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, method=method)
    if data is not None:
        req.add_header("Content-Type", "application/json")
    if api_key:
        req.add_header("X-API-Key", api_key)
    with urllib.request.urlopen(req, timeout=TIMEOUT_S) as resp:
        return json.loads(resp.read() or b"null")


def load_eval_user_ids(processed_dir: Path, limit: int = 50) -> list[str]:
    queries_path = processed_dir / EVAL_QUERIES_FILENAME
    if not queries_path.exists():
        return []
    try:
        data = json.loads(queries_path.read_text())
        return [str(i) for i in list(data.keys())[:limit]]
    except (json.JSONDecodeError, OSError):
        return []


def post_recommend_request(
    base_url: str,
    api_key: str | None,
    user_id: str | None,
    user_context: str | None,
    top_k: int,
) -> tuple[str | None, list[str]]:
    payload: dict = {"top_k": top_k}
    if user_id:
        payload["user_id"] = user_id
    else:
        payload["user_context"] = user_context or SAMPLE_USER_CONTEXTS[0]
    data = http_json("POST", f"{base_url}/recommend", payload, api_key)
    return data.get("request_id"), [r["product_id"] for r in data.get("recommendations", [])]


def build_funnel_events(
    request_id: str,
    product_ids: list[str],
    rng: random.Random,
    click_rate: float,
    atc_rate: float,
    purchase_rate: float,
    user_context: str | None = None,
) -> list[dict]:
    """Impression for every product; then click -> add_to_cart -> purchase chains.

    When ``user_context`` is known it is stored in event metadata so
    scripts/torch_feedback_retrain.py can mine (context, product) training pairs.
    """
    meta = {"metadata": {"user_context": user_context}} if user_context else {}
    events = []
    for pid in product_ids:
        events.append(
            {"request_id": request_id, "event_type": "impression", "product_id": pid, **meta}
        )
        if rng.random() < click_rate:
            events.append(
                {"request_id": request_id, "event_type": "click", "product_id": pid, **meta}
            )
            if rng.random() < atc_rate:
                events.append(
                    {"request_id": request_id, "event_type": "add_to_cart", "product_id": pid, **meta}
                )
                if rng.random() < purchase_rate:
                    events.append(
                        {"request_id": request_id, "event_type": "purchase", "product_id": pid, **meta}
                    )
    return events


def post_feedback(base_url: str, api_key: str | None, events: list[dict]) -> None:
    http_json("POST", f"{base_url}/feedback", {"events": events}, api_key)


def load_config(config_path: Path | None = None) -> dict:
    raw = load_yaml_config(config_path, DEFAULT_CONFIG_GENERATE_SAMPLE_FEEDBACK)
    return {
        "url": str(raw.get("url", "http://localhost:8000")),
        "num_requests": int(raw.get("num_requests", 20)),
        "api_key": raw.get("api_key"),
        "top_k": int(raw.get("top_k", 10)),
        "click_rate": float(raw.get("click_rate", 0.15)),
        "atc_rate": float(raw.get("atc_rate", 0.4)),
        "purchase_rate": float(raw.get("purchase_rate", 0.6)),
        "seed": int(raw.get("seed", 0)),
    }


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description="Generate sample recommend + feedback requests")
    parser.add_argument("--config", type=Path, default=None)
    parser.add_argument("--num-requests", type=int, default=None)
    args = parser.parse_args(argv)
    cfg = load_config(args.config)
    if args.num_requests is not None:
        cfg["num_requests"] = args.num_requests

    rng = random.Random(cfg["seed"])
    base_url = cfg["url"].rstrip("/")

    try:
        http_json("GET", f"{base_url}/health")
    except (OSError, ValueError) as exc:
        print(f"API not reachable at {base_url}: {exc}")
        return 1

    try:
        processed_dir, _ = resolve_processed_dir(DEFAULT_PROCESSED_DIR, DEFAULT_PROCESSED_DIR)
        user_ids = load_eval_user_ids(processed_dir)
    except FileNotFoundError:
        user_ids = []

    total_events = 0
    for i in range(cfg["num_requests"]):
        user_id = rng.choice(user_ids) if user_ids else None
        context = None if user_id else rng.choice(SAMPLE_USER_CONTEXTS)
        try:
            request_id, product_ids = post_recommend_request(
                base_url, cfg["api_key"], user_id, context, cfg["top_k"]
            )
        except urllib.error.HTTPError as exc:
            print(f"  request {i}: recommend failed ({exc.code})")
            continue
        except OSError as exc:
            print(f"  request {i}: recommend transport error ({exc}); continuing")
            continue
        if not request_id or not product_ids:
            continue
        events = build_funnel_events(
            request_id,
            product_ids,
            rng,
            cfg["click_rate"],
            cfg["atc_rate"],
            cfg["purchase_rate"],
            user_context=context,
        )
        try:
            post_feedback(base_url, cfg["api_key"], events)
        except OSError as exc:
            print(f"  request {i}: feedback failed ({exc}); continuing")
            continue
        total_events += len(events)
        print(f"  request {i + 1}/{cfg['num_requests']}: {len(events)} events")

    print(f"Done: {total_events} feedback events sent.")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
