"""POST /admin/model — hot-swap the serving model checkpoint.

The port's copy of the JAX package's route. This is the deploy half of the
feedback retrain loop: the scheduler (scripts/feedback_retrain.py) trains on
mined feedback, checks the eval gate against best.json, and POSTs the
passing checkpoint here. The swap follows the corpus route's pattern: build
a NEW recommender against the current corpus (re-encoding the catalog with
the new tower), then swap app state atomically; failure leaves the old model
serving.
"""

from __future__ import annotations

import json
import logging
from pathlib import Path

from instacart_next_order_recommendation_tpu_torch.api.auth import verify_api_key
from instacart_next_order_recommendation_tpu_torch.api.http import ApiError, App, Request, Response
from instacart_next_order_recommendation_tpu_torch.api.schemas import (
    ModelSwapRequest,
    ModelSwapResponse,
)
from instacart_next_order_recommendation_tpu_torch.api.validation import validate

logger = logging.getLogger(__name__)


def read_best_metrics(model_dir: Path) -> dict | None:
    """best.json written by the trainer lives in the run dir next to final/."""
    for candidate in (model_dir / "best.json", model_dir.parent / "best.json"):
        try:
            return json.loads(candidate.read_text())
        except (OSError, json.JSONDecodeError):
            continue
    return None


def register(app: App) -> None:
    @app.post("/admin/model")
    def model_swap_endpoint(request: Request) -> Response:
        verify_api_key(request)
        payload = validate(ModelSwapRequest, request.json())

        model_dir = Path(payload.model_dir)
        if not model_dir.exists():
            raise ApiError(400, f"Model directory does not exist: {model_dir}")

        corpus_path = app.state.get("corpus_path")
        if corpus_path is None:
            raise ApiError(503, "No corpus loaded; cannot swap model.")

        from instacart_next_order_recommendation_tpu_torch.api.app import (
            default_factory,
            maybe_wrap_micro_batcher,
        )

        try:
            factory = app.state.get("recommender_factory") or default_factory(app)
            recommender = factory(model_dir=model_dir, corpus_path=Path(corpus_path))
        except Exception as exc:
            logger.exception("Failed to load recommender with new model")
            raise ApiError(500, f"Failed to load model: {exc}") from exc

        app.state["recommender"] = maybe_wrap_micro_batcher(recommender)
        app.state["model_dir"] = model_dir
        app.state["ready"] = True

        best = read_best_metrics(model_dir)
        logger.info("model_swapped model_dir=%s", model_dir)
        return Response(
            200,
            ModelSwapResponse(status="ok", model_dir=str(model_dir), best=best).model_dump(),
        )
