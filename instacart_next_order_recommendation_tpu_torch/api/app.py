"""Application wiring: middleware, probes, metrics endpoint, startup.

The port's copy of the JAX package's ``api/app.py``: startup initializes the
feedback DB and loads a MonitoredRecommender from MODEL_DIR/CORPUS_PATH
(env-resolved with HF fallback); request-logging middleware propagates
``X-Request-ID``; ``/health`` is a liveness probe, ``/ready`` reports model
readiness, ``/metrics`` exports the Prometheus registry; rate limiting
applies to /recommend and /feedback.

The default recommender is the port's ``MonitoredRecommender`` on the app's
device: ``create_app``'s ``device``, else ``INFERENCE_DEVICE``, else CUDA.
Where that is CUDA and there is none, loading raises: the server never
carries on on the CPU unless asked to.
"""

from __future__ import annotations

import functools
import logging
import os
import time
from pathlib import Path
from uuid import uuid4

import torch
from prometheus_client import CONTENT_TYPE_LATEST, generate_latest

from instacart_next_order_recommendation_tpu_torch.api.feedback_store import (
    flush_request_contexts,
    init_db,
)
from instacart_next_order_recommendation_tpu_torch.api.http import App, Request, Response
from instacart_next_order_recommendation_tpu_torch.api.limiter import RateLimiter
from instacart_next_order_recommendation_tpu_torch.api.metrics import API_REGISTRY, MODEL_LOADED
from instacart_next_order_recommendation_tpu_torch.api.routes import (
    corpus,
    feedback,
    model,
    recommend,
)
from instacart_next_order_recommendation_tpu_torch.constants import (
    DEFAULT_CORPUS_PATH,
    DEFAULT_MODEL_DIR,
    ENV_BATCH_WINDOW_MS,
    ENV_CORPUS_PATH,
    ENV_MODEL_DIR,
)
from instacart_next_order_recommendation_tpu_torch.device import resolve_device
from instacart_next_order_recommendation_tpu_torch.serve import MicroBatcher, MonitoredRecommender
from instacart_next_order_recommendation_tpu_torch.serve.recommender import (
    apply_inference_device_override,
)
from instacart_next_order_recommendation_tpu_torch.utils.resolve import (
    resolve_corpus_with_hf_fallback,
)

logger = logging.getLogger(__name__)


def _resolve_model_dir() -> Path:
    value = os.getenv(ENV_MODEL_DIR)
    return Path(value) if value else DEFAULT_MODEL_DIR


def _resolve_corpus_path() -> Path:
    value = os.getenv(ENV_CORPUS_PATH)
    path = Path(value) if value else DEFAULT_CORPUS_PATH
    return resolve_corpus_with_hf_fallback(path)


def default_factory(app: App):
    """``MonitoredRecommender`` on the app's device, resolved at first use
    and kept in ``app.state["device"]``: the value ``create_app`` was given,
    else ``INFERENCE_DEVICE``, else CUDA. Raises where that is CUDA and the
    machine has none."""
    dev = app.state.get("device")
    if not isinstance(dev, torch.device):
        dev = resolve_device(dev if dev is not None else apply_inference_device_override())
        app.state["device"] = dev
    return functools.partial(MonitoredRecommender, device=dev)


def maybe_wrap_micro_batcher(recommender):
    """Wrap the recommender in a MicroBatcher when BATCH_WINDOW_MS > 0."""
    try:
        window_ms = float(os.getenv(ENV_BATCH_WINDOW_MS) or 0.0)
    except ValueError:
        logger.warning("Invalid %s=%r; micro-batching disabled",
                       ENV_BATCH_WINDOW_MS, os.getenv(ENV_BATCH_WINDOW_MS))
        return recommender
    if window_ms <= 0:
        return recommender
    logger.info("Micro-batching enabled: window %.1f ms", window_ms)
    return MicroBatcher(recommender, window_ms=window_ms)


def request_logging_middleware(request: Request, nxt) -> Response:
    start = time.time()
    req_id = request.header("x-request-id") or str(uuid4())
    request.state["request_id"] = req_id
    try:
        response = nxt(request)
    except Exception:
        elapsed_ms = int((time.time() - start) * 1000)
        logger.exception(
            "request_error path=%s method=%s request_id=%s latency_ms=%d",
            request.path,
            request.method,
            req_id,
            elapsed_ms,
        )
        raise
    elapsed_ms = int((time.time() - start) * 1000)
    response.headers["X-Request-ID"] = req_id
    logger.info(
        "request path=%s method=%s status=%d request_id=%s latency_ms=%d",
        request.path,
        request.method,
        response.status_code,
        req_id,
        elapsed_ms,
    )
    return response


def create_app(
    model_dir: Path | str | None = None,
    corpus_path: Path | str | None = None,
    recommender_factory=None,
    rate_limit: str | None = None,
    load_model_on_startup: bool = True,
    device: str | torch.device | None = None,
) -> App:
    """Build the application.

    ``recommender_factory`` is injectable for tests and is called as the JAX
    package calls it, ``factory(model_dir=..., corpus_path=...)``. Without
    one, the port's ``MonitoredRecommender`` serves on ``device``
    (``default_factory``).
    """
    app = App(title="Instacart Next-Order Recommendation API (GPU)")
    app.add_middleware(request_logging_middleware)
    limiter = RateLimiter(rate_limit)
    app.add_middleware(limiter.middleware)
    # Socket server checks the limit before reading request bodies.
    app.early_checks.append(limiter.early_check)
    app.state["device"] = device
    if recommender_factory is not None:
        app.state["recommender_factory"] = recommender_factory

    def startup(app: App) -> None:
        from instacart_next_order_recommendation_tpu_torch.utils.dotenv import load_dotenv

        load_dotenv()
        logger.info("Starting recommendation API service")
        init_db()
        if not load_model_on_startup:
            return
        resolved_model = Path(model_dir) if model_dir else _resolve_model_dir()
        resolved_corpus = (
            Path(corpus_path) if corpus_path else _resolve_corpus_path()
        )
        factory = app.state.get("recommender_factory") or default_factory(app)
        logger.info("Loading recommender model_dir=%s corpus=%s", resolved_model, resolved_corpus)
        recommender = factory(model_dir=resolved_model, corpus_path=resolved_corpus)
        if os.getenv("PRECOMPILE_ON_STARTUP", "").strip() in ("1", "true"):
            from instacart_next_order_recommendation_tpu_torch.serve.precompile import (
                BATCH_BUCKETS,
                warm_serve_shapes,
            )

            batching_on = float(os.getenv(ENV_BATCH_WINDOW_MS) or 0) > 0
            app.state["warmed_shapes"] = warm_serve_shapes(
                recommender, batch_buckets=BATCH_BUCKETS if batching_on else (1,)
            )
        app.state["recommender"] = maybe_wrap_micro_batcher(recommender)
        app.state["model_dir"] = resolved_model
        app.state["corpus_path"] = resolved_corpus
        app.state["ready"] = True
        MODEL_LOADED.set(1)

    def shutdown(app: App) -> None:
        MODEL_LOADED.set(0)
        # Drain the async request-context writer while the DB still exists:
        # contexts enqueued by in-flight /recommend requests must not be
        # dropped (or hit a torn-down DB path) on graceful shutdown.
        flush_request_contexts()
        logger.info("Shutting down recommendation API service")

    app.on_startup.append(startup)
    app.on_shutdown.append(shutdown)

    @app.get("/health")
    def health(request: Request) -> Response:
        return Response(200, {"status": "ok"})

    @app.get("/ready")
    def ready(request: Request) -> Response:
        if not app.state.get("ready") or not app.state.get("recommender"):
            return Response(200, {"status": "not_ready"})
        return Response(200, {"status": "ready"})

    @app.get("/metrics")
    def metrics(request: Request) -> Response:
        return Response(
            200, generate_latest(API_REGISTRY), media_type=CONTENT_TYPE_LATEST
        )

    recommend.register(app)
    feedback.register(app)
    corpus.register(app)
    model.register(app)
    return app


def main() -> None:
    import argparse

    from instacart_next_order_recommendation_tpu_torch.api.http import serve
    from instacart_next_order_recommendation_tpu_torch.utils.logging import setup_colored_logging

    parser = argparse.ArgumentParser(description="Run the recommendation API server")
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=8000)
    parser.add_argument("--model-dir", default=None)
    parser.add_argument("--corpus-path", default=None)
    args = parser.parse_args()

    setup_colored_logging()
    app = create_app(model_dir=args.model_dir, corpus_path=args.corpus_path)
    serve(app, host=args.host, port=args.port)


if __name__ == "__main__":
    main()
