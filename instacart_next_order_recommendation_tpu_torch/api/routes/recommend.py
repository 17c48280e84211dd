"""POST /recommend — top-k product recommendations.

The port's copy of the JAX package's route: context resolution
(user_context, else user_id lookup in eval_queries.json next to the corpus),
optional free-text query prepended to the context, 400 when nothing resolves,
uuid request_id for feedback correlation, per-request stats from
MonitoredRecommender, and Prometheus latency/counter instrumentation
including error counting.
"""

from __future__ import annotations

import json
import logging
import threading
import time
from pathlib import Path
from uuid import uuid4

from instacart_next_order_recommendation_tpu_torch.api.auth import verify_api_key
from instacart_next_order_recommendation_tpu_torch.api.http import ApiError, App, Request, Response
from instacart_next_order_recommendation_tpu_torch.api.metrics import (
    RECOMMENDATION_ENCODE_SECONDS,
    RECOMMENDATION_LATENCY_SECONDS,
    RECOMMENDATION_REQUESTS_TOTAL,
)
from instacart_next_order_recommendation_tpu_torch.api.schemas import (
    InferenceStatistics,
    RecommendationItem,
    RecommendationRequest,
    RecommendationResponse,
)
from instacart_next_order_recommendation_tpu_torch.api.validation import validate
from instacart_next_order_recommendation_tpu_torch.constants import EVAL_QUERIES_FILENAME
from instacart_next_order_recommendation_tpu_torch.serve import MonitoredRecommender

logger = logging.getLogger(__name__)


def _load_eval_queries(corpus_path: Path) -> dict[str, str]:
    queries_path = Path(corpus_path).parent / EVAL_QUERIES_FILENAME
    if not queries_path.exists():
        return {}
    try:
        data = json.loads(queries_path.read_text())
        if isinstance(data, dict):
            return {str(k): str(v) for k, v in data.items()}
    except (OSError, json.JSONDecodeError):
        logger.exception("Failed to load %s", queries_path)
    return {}


def _load_on_demand(app: App, lock: threading.Lock):
    """Load a recommender from env/default paths when startup didn't.

    Serialized: a burst of first requests must not each load the model and
    re-encode the whole catalog concurrently (N-fold memory and latency);
    followers wait on the lock and reuse the leader's instance.
    """
    import os

    from instacart_next_order_recommendation_tpu_torch.api.app import default_factory
    from instacart_next_order_recommendation_tpu_torch.constants import (
        DEFAULT_CORPUS_PATH,
        DEFAULT_MODEL_DIR,
        ENV_CORPUS_PATH,
        ENV_MODEL_DIR,
    )

    with lock:
        recommender = app.state.get("recommender")
        if recommender is not None:  # a concurrent request already loaded it
            return recommender
        model_dir = Path(os.getenv(ENV_MODEL_DIR) or DEFAULT_MODEL_DIR)
        corpus_path = Path(os.getenv(ENV_CORPUS_PATH) or DEFAULT_CORPUS_PATH)
        logger.warning("Recommender not preloaded; loading on-demand")
        try:
            # The default factory resolves the device here: no CUDA (and no
            # INFERENCE_DEVICE=cpu) is a 503, never a CPU recommender.
            factory = app.state.get("recommender_factory") or default_factory(app)
            recommender = factory(model_dir=model_dir, corpus_path=corpus_path)
        except Exception as exc:  # noqa: BLE001
            raise ApiError(503, f"Recommender not loaded and on-demand load failed: {exc}")
        app.state["recommender"] = recommender
        app.state["ready"] = True
        return recommender


def register(app: App) -> None:
    on_demand_lock = threading.Lock()

    @app.post("/recommend")
    def recommend_endpoint(request: Request) -> Response:
        start_time = time.perf_counter()
        try:
            verify_api_key(request)
            payload = validate(RecommendationRequest, request.json())

            recommender = app.state.get("recommender")
            if recommender is None:
                # On-demand fallback load.
                recommender = _load_on_demand(app, on_demand_lock)

            context = payload.user_context
            if context is None and payload.user_id is not None:
                corpus_path = app.state.get("corpus_path") or recommender.corpus_path
                context = _load_eval_queries(Path(corpus_path)).get(str(payload.user_id))

            if payload.query is not None and payload.query.strip():
                retrieval_query = f"{payload.query} {context}" if context else payload.query
            else:
                retrieval_query = context

            if not retrieval_query:
                raise ApiError(
                    400,
                    "Either query (optional) must be provided, or user_context must be "
                    "provided / user_id must be resolvable.",
                )

            request_id = str(uuid4())
            exclude_ids = set(payload.exclude_product_ids or [])
            user_id_str = str(payload.user_id) if payload.user_id is not None else None

            # Category filters are forwarded only when requested, so calls
            # without them reach recommenders that do not take filters.
            filter_kwargs = {}
            if payload.filter_aisles:
                filter_kwargs["filter_aisles"] = payload.filter_aisles
            if payload.filter_departments:
                filter_kwargs["filter_departments"] = payload.filter_departments

            if isinstance(recommender, MonitoredRecommender) or hasattr(
                recommender, "last_metrics"
            ):
                results = recommender.recommend(
                    query=retrieval_query,
                    top_k=payload.top_k,
                    user_id=user_id_str,
                    exclude_product_ids=exclude_ids,
                    **filter_kwargs,
                )
            else:
                results = recommender.recommend(
                    query=retrieval_query,
                    top_k=payload.top_k,
                    exclude_product_ids=exclude_ids,
                    **filter_kwargs,
                )

            items = [
                RecommendationItem(
                    product_id=pid,
                    score=score,
                    product_text=recommender.pid_to_text.get(pid),
                )
                for pid, score in results
            ]

            stats = None
            last_metrics = getattr(recommender, "last_metrics", None)
            if last_metrics is not None:
                stats = InferenceStatistics(
                    total_latency_ms=last_metrics.total_latency_ms,
                    query_embedding_time_ms=last_metrics.query_embedding_time_ms,
                    similarity_compute_time_ms=last_metrics.similarity_compute_time_ms,
                    num_recommendations=last_metrics.num_recommendations,
                    top_score=last_metrics.top_score,
                    avg_score=last_metrics.avg_score,
                    timestamp=last_metrics.timestamp,
                    stage_timing_source=getattr(
                        last_metrics, "stage_timing_source", "measured"
                    ),
                )
                RECOMMENDATION_ENCODE_SECONDS.observe(
                    last_metrics.query_embedding_time_ms / 1000.0
                )

            RECOMMENDATION_LATENCY_SECONDS.observe(time.perf_counter() - start_time)
            RECOMMENDATION_REQUESTS_TOTAL.labels(status="success").inc()
            logger.info("recommendation_served request_id=%s top_k=%d", request_id, len(items))

            # Persist the serving context so feedback joins back to it for
            # retraining (best-effort; never fails the request).
            try:
                from instacart_next_order_recommendation_tpu_torch.api.feedback_store import (
                    record_request_context,
                )

                record_request_context(request_id, retrieval_query, user_id_str)
            except Exception:  # noqa: BLE001
                logger.exception("failed to persist request context")

            response = RecommendationResponse(
                request_id=request_id,
                recommendations=items,
                stats=stats,
                purchase_history_used=context,
            )
            return Response(200, json.loads(response.model_dump_json()))
        except Exception:  # includes ApiError
            RECOMMENDATION_REQUESTS_TOTAL.labels(status="error").inc()
            raise
