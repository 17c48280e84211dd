"""POST /feedback — ingest impression/click/add_to_cart/purchase events.

The port's copy of the JAX package's route: accepts a single event or a
batch, 400 on empty batch, single insert vs batched transaction,
per-event-type Prometheus counters + ingest-latency histogram,
202 ``{"status": "accepted", "count": N}``.
"""

from __future__ import annotations

import logging
import time

from instacart_next_order_recommendation_tpu_torch.api.auth import verify_api_key
from instacart_next_order_recommendation_tpu_torch.api.http import ApiError, App, Request, Response
from instacart_next_order_recommendation_tpu_torch.api.feedback_store import (
    FeedbackEventRecord,
    record_event,
    record_events,
)
from instacart_next_order_recommendation_tpu_torch.api.metrics import (
    FEEDBACK_EVENTS_TOTAL,
    FEEDBACK_INGEST_LATENCY_SECONDS,
)
from instacart_next_order_recommendation_tpu_torch.api.schemas import (
    FeedbackBatchRequest,
    FeedbackEvent,
)
from instacart_next_order_recommendation_tpu_torch.api.validation import validate

logger = logging.getLogger(__name__)


def register(app: App) -> None:
    @app.post("/feedback")
    def feedback_endpoint(request: Request) -> Response:
        verify_api_key(request)
        payload = request.json()
        if isinstance(payload, dict) and "events" in payload:
            events = validate(FeedbackBatchRequest, payload).events
        else:
            events = [validate(FeedbackEvent, payload)]

        if not events:
            raise ApiError(400, "No feedback events provided.")

        records = [
            FeedbackEventRecord(
                request_id=e.request_id,
                event_type=e.event_type,
                user_id=e.user_id,
                product_id=e.product_id,
                user_context_hash=e.user_context_hash,
                metadata=e.metadata,
                created_at=e.created_at,
            )
            for e in events
        ]

        start = time.perf_counter()
        if len(records) == 1:
            record_event(records[0])
        else:
            record_events(records)
        FEEDBACK_INGEST_LATENCY_SECONDS.observe(time.perf_counter() - start)
        for r in records:
            FEEDBACK_EVENTS_TOTAL.labels(event_type=r.event_type).inc()

        logger.info(
            "feedback_ingested count=%d types=%s", len(records), {r.event_type for r in records}
        )
        return Response(202, {"status": "accepted", "count": len(records)})
