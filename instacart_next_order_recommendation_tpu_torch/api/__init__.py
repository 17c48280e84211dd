"""HTTP API service (stdlib server) on the port's serve path: /recommend
/feedback /admin/corpus /admin/model /health /ready /metrics with auth,
rate limiting, and Prometheus metrics. Run it with
``python -m instacart_next_order_recommendation_tpu_torch.api``."""

from instacart_next_order_recommendation_tpu_torch.api.app import create_app

__all__ = ["create_app"]
