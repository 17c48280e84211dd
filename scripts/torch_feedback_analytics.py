"""Feedback analytics: CTR / add-to-cart rate / purchase rate + per-request funnels.

The port's counterpart of ``scripts/feedback_analytics.py``, on the port's
``api/feedback_store`` (the same SQLite schema, so it reads a DB written by
either server): reads the feedback DB (optional ``since`` filter via the
config), aggregates unique (request_id, product_id) events, and prints
purchase-depth-sorted funnels.

    python scripts/torch_feedback_analytics.py [--config configs/feedback_analytics.yaml]
"""

from __future__ import annotations

# Allow running as `python scripts/<name>.py` from a repo checkout.
import sys as _sys
from pathlib import Path as _Path

_repo_root = str(_Path(__file__).resolve().parents[1])
if _repo_root not in _sys.path:
    _sys.path.insert(0, _repo_root)

import argparse
import os
import sqlite3
from collections import defaultdict
from pathlib import Path

from instacart_next_order_recommendation_tpu_torch.api.feedback_store import get_db_path, init_db
from instacart_next_order_recommendation_tpu_torch.constants import (
    DEFAULT_CONFIG_FEEDBACK_ANALYTICS,
    ENV_FEEDBACK_DB_PATH,
)
from instacart_next_order_recommendation_tpu_torch.utils.config import load_yaml_config


def load_events(db_path: Path, since: str | None = None) -> list[tuple]:
    """(request_id, event_type, product_id, user_id, created_at) rows."""
    if not db_path.exists():
        return []
    conn = sqlite3.connect(db_path)
    try:
        sql = (
            "SELECT request_id, event_type, product_id, user_id, created_at "
            "FROM feedback_events "
        )
        params: tuple = ()
        if since:
            sql += "WHERE created_at >= ? "
            params = (since,)
        sql += "ORDER BY created_at"
        return [tuple(r) for r in conn.execute(sql, params).fetchall()]
    finally:
        conn.close()


def compute_aggregate_metrics(events: list[tuple]) -> dict[str, float]:
    """CTR / ATC / purchase rates over unique (request_id, product_id) pairs."""
    buckets: dict[str, set[tuple[str, str]]] = {
        "impression": set(),
        "click": set(),
        "add_to_cart": set(),
        "purchase": set(),
    }
    for req_id, event_type, product_id, _, _ in events:
        if event_type in buckets:
            buckets[event_type].add((req_id or "", product_id))
    n_imp = len(buckets["impression"])

    def rate(key: str) -> float:
        return len(buckets[key]) / n_imp if n_imp > 0 else 0.0

    return {
        "impression_count": n_imp,
        "click_count": len(buckets["click"]),
        "add_to_cart_count": len(buckets["add_to_cart"]),
        "purchase_count": len(buckets["purchase"]),
        "ctr": rate("click"),
        "add_to_cart_rate": rate("add_to_cart"),
        "purchase_rate": rate("purchase"),
    }


def compute_funnel_per_request(events: list[tuple]) -> dict[str, dict[str, set[str]]]:
    """request_id -> {event_type: set of product_ids}."""
    funnel: dict[str, dict[str, set[str]]] = defaultdict(lambda: defaultdict(set))
    for req_id, event_type, product_id, _, _ in events:
        if req_id:
            funnel[req_id][event_type].add(product_id)
    return {k: dict(v) for k, v in funnel.items()}


def load_config(config_path: Path | None = None) -> dict:
    raw = load_yaml_config(config_path, DEFAULT_CONFIG_FEEDBACK_ANALYTICS)
    return {
        "db_path": raw.get("db_path"),
        "since": raw.get("since"),
        "show_funnel_sample": int(raw.get("show_funnel_sample", 3)),
    }


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        description="Feedback analytics: CTR, add-to-cart rate, purchase rate, funnels"
    )
    parser.add_argument("--config", type=Path, default=None)
    args = parser.parse_args(argv)
    cfg = load_config(args.config)

    if cfg["db_path"]:
        os.environ[ENV_FEEDBACK_DB_PATH] = str(cfg["db_path"])
    init_db()
    db_path = Path(cfg["db_path"]) if cfg["db_path"] else get_db_path()

    events = load_events(db_path, since=cfg["since"])
    if not events:
        suffix = f" since {cfg['since']}" if cfg["since"] else ""
        print(f"No feedback events found in {db_path}{suffix}")
        return 0

    metrics = compute_aggregate_metrics(events)
    print("\n--- Aggregate metrics ---")
    print(f"  Impressions (unique request+product): {metrics['impression_count']:,}")
    print(f"  Clicks: {metrics['click_count']:,}")
    print(f"  Add-to-cart: {metrics['add_to_cart_count']:,}")
    print(f"  Purchases: {metrics['purchase_count']:,}")
    print(f"  CTR (clicks/impressions): {metrics['ctr']:.4f}")
    print(f"  Add-to-cart rate: {metrics['add_to_cart_rate']:.4f}")
    print(f"  Purchase rate: {metrics['purchase_rate']:.4f}")

    funnel = compute_funnel_per_request(events)
    print(f"\n--- Per-request funnel ({len(funnel)} request_ids) ---")
    if cfg["show_funnel_sample"] > 0 and funnel:

        def depth(item):
            _, by_type = item
            return (
                -len(by_type.get("purchase", set())),
                -len(by_type.get("add_to_cart", set())),
                -len(by_type.get("click", set())),
                item[0] or "",
            )

        for req_id, by_type in sorted(funnel.items(), key=depth)[: cfg["show_funnel_sample"]]:
            label = (req_id or "(no request_id)")[:20]
            print(
                f"  {label}: imp={len(by_type.get('impression', set()))} "
                f"click={len(by_type.get('click', set()))} "
                f"add_to_cart={len(by_type.get('add_to_cart', set()))} "
                f"purchase={len(by_type.get('purchase', set()))}"
            )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
