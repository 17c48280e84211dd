"""POST /admin/corpus — hot-swap the product catalog.

The port's copy of the JAX package's route: validates the upload size
against MAX_CORPUS_UPLOAD_PRODUCTS (env-overridable), writes the corpus to a
temp JSON, builds a NEW recommender (re-encoding the catalog) and swaps it
into app state atomically; failure unlinks the temp file and returns 500.
Rate-limit exempt.
"""

from __future__ import annotations

import json
import logging
import os
import tempfile
import uuid
from pathlib import Path

from instacart_next_order_recommendation_tpu_torch.api.auth import verify_api_key
from instacart_next_order_recommendation_tpu_torch.api.http import ApiError, App, Request, Response
from instacart_next_order_recommendation_tpu_torch.api.schemas import (
    CorpusUploadRequest,
    CorpusUploadResponse,
)
from instacart_next_order_recommendation_tpu_torch.api.validation import validate
from instacart_next_order_recommendation_tpu_torch.constants import (
    DEFAULT_MODEL_DIR,
    ENV_MAX_CORPUS_UPLOAD_PRODUCTS,
    ENV_MODEL_DIR,
    MAX_CORPUS_UPLOAD_PRODUCTS,
)

logger = logging.getLogger(__name__)


def _resolve_model_dir(app: App) -> Path:
    # App state first: /admin/model updates it, and a later corpus upload
    # must rebuild around the CURRENTLY-SERVING model — env-first would
    # silently undo a model swap (env is the startup default only).
    state_dir = app.state.get("model_dir")
    if state_dir:
        return Path(state_dir)
    value = os.getenv(ENV_MODEL_DIR)
    return Path(value) if value else DEFAULT_MODEL_DIR


def _get_max_corpus_products() -> int:
    val = os.getenv(ENV_MAX_CORPUS_UPLOAD_PRODUCTS)
    if val is None:
        return MAX_CORPUS_UPLOAD_PRODUCTS
    try:
        return int(val)
    except ValueError:
        return MAX_CORPUS_UPLOAD_PRODUCTS


def _hot_swap_kwargs(app: App, model_dir: Path) -> dict:
    """The hot-swap fast path: the tower is unchanged, so reuse the live
    encoder (skips the checkpoint reload, the weight upload and the bf16
    layer copies), and skip the disk embedding cache — an uploaded corpus is
    an ephemeral temp file, so embeddings stay device-resident instead of
    round-tripping through the host for a cache nothing will hit."""
    from instacart_next_order_recommendation_tpu_torch.serve.recommender import model_signature

    kwargs: dict = {"use_index": False}
    current = app.state.get("recommender")
    base = getattr(current, "_rec", current)
    enc = getattr(base, "encoder", None)
    # Reuse only when BOTH the path and the checkpoint files are unchanged —
    # a retrain into the same dir must reload from disk, never silently
    # serve the stale in-memory weights.
    if (
        enc is not None
        and getattr(base, "model_dir", None) == Path(model_dir).resolve()
        and getattr(base, "_model_signature", None) == model_signature(base.model_dir)
    ):
        kwargs["encoder"] = enc
        # Recommender refuses an encoder on another device: the successor
        # serves where the live one does.
        kwargs["device"] = base.device
    return kwargs


def register(app: App) -> None:
    @app.post("/admin/corpus")
    def corpus_upload_endpoint(request: Request) -> Response:
        verify_api_key(request)
        payload = validate(CorpusUploadRequest, request.json())

        n = len(payload.corpus)
        max_allowed = _get_max_corpus_products()
        if n > max_allowed:
            raise ApiError(400, f"Corpus has {n} products; max allowed is {max_allowed}.")

        model_dir = _resolve_model_dir(app)
        temp_path = Path(tempfile.gettempdir()) / f"uploaded_corpus_{uuid.uuid4().hex}.json"
        try:
            temp_path.write_text(json.dumps(payload.corpus, indent=0))
        except OSError as exc:
            logger.exception("Failed to write temp corpus file")
            raise ApiError(500, "Failed to write corpus to temporary file.") from exc

        from instacart_next_order_recommendation_tpu_torch.api.app import (
            default_factory,
            maybe_wrap_micro_batcher,
        )

        injected = app.state.get("recommender_factory")
        # Injected test factories keep their own signature: the fast path is
        # the default factory's only.
        kwargs = {} if injected is not None else _hot_swap_kwargs(app, model_dir)
        try:
            factory = injected or default_factory(app)
            recommender = factory(model_dir=model_dir, corpus_path=temp_path, **kwargs)
        except Exception as exc:
            temp_path.unlink(missing_ok=True)
            logger.exception("Failed to load recommender with uploaded corpus")
            raise ApiError(500, f"Failed to load recommender: {exc}") from exc

        prev = app.state.get("uploaded_corpus_path")
        app.state["recommender"] = maybe_wrap_micro_batcher(recommender)
        app.state["corpus_path"] = temp_path
        app.state["uploaded_corpus_path"] = temp_path
        app.state["ready"] = True
        if prev is not None and Path(prev) != temp_path:
            # Repeated hot-swaps must not leak multi-MB temp corpora.
            Path(prev).unlink(missing_ok=True)

        logger.info("corpus_uploaded n_products=%d model_dir=%s", n, model_dir)
        return Response(
            200, CorpusUploadResponse(status="ok", n_products=n).model_dump()
        )
