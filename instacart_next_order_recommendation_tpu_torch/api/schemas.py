"""Pydantic request/response schemas.

Field for field the JAX package's ``api/schemas.py``: the same bounds and
validators, so a request either server accepts the other accepts too.
"""

from __future__ import annotations

from datetime import datetime
from typing import Any, Dict, List, Literal, Optional

from pydantic import BaseModel, Field, field_validator


class RecommendationRequest(BaseModel):
    """POST /recommend body: provide user_context or user_id, plus top_k."""

    query: Optional[str] = Field(
        default=None, description="Optional search query text used as retrieval signal."
    )
    user_context: Optional[str] = Field(
        default=None,
        max_length=10_000,
        description="Full user context string, e.g. '[+7d w4h14] Organic Milk, Whole Wheat Bread.'",
    )
    user_id: Optional[str] = Field(
        default=None, description="User id resolvable to a stored eval query (order_id)."
    )
    top_k: int = Field(default=10, ge=1, le=100)
    exclude_product_ids: List[str] = Field(
        default_factory=list, description="Product ids to exclude from the ranking."
    )
    # Category filters, applied on the device as a candidate mask in the
    # top-k kernel.
    filter_aisles: Optional[List[str]] = Field(
        default=None, description="Restrict candidates to these aisles (case-insensitive)."
    )
    filter_departments: Optional[List[str]] = Field(
        default=None,
        description="Restrict candidates to these departments (case-insensitive).",
    )


class RecommendationItem(BaseModel):
    product_id: str
    score: float
    product_text: Optional[str] = None


class InferenceStatistics(BaseModel):
    total_latency_ms: float
    query_embedding_time_ms: float
    similarity_compute_time_ms: float
    num_recommendations: int
    top_score: float
    avg_score: float
    timestamp: float
    # "measured" = per-request wall
    # clocks; "calibrated" = shape-bucketed device-side estimates (the
    # single-dispatch serve path). Lets dashboards distinguish the two.
    stage_timing_source: str = "measured"


class RecommendationResponse(BaseModel):
    request_id: str
    recommendations: List[RecommendationItem]
    stats: Optional[InferenceStatistics] = None
    purchase_history_used: Optional[str] = None


EventType = Literal["impression", "click", "add_to_cart", "purchase"]


class FeedbackEvent(BaseModel):
    request_id: str
    event_type: EventType
    product_id: str
    user_id: Optional[str] = None
    user_context_hash: Optional[str] = None
    metadata: Optional[Dict[str, Any]] = None
    created_at: Optional[datetime] = None


class FeedbackBatchRequest(BaseModel):
    events: List[FeedbackEvent]


class HealthResponse(BaseModel):
    status: str = "ok"


class CorpusUploadRequest(BaseModel):
    corpus: Dict[str, str] = Field(
        ..., description="Map of product_id to product text (eval_corpus.json format)."
    )

    @field_validator("corpus")
    @classmethod
    def corpus_non_empty(cls, v: Dict[str, str]) -> Dict[str, str]:
        if not v:
            raise ValueError("corpus must be non-empty")
        return v


class CorpusUploadResponse(BaseModel):
    status: str = "ok"
    n_products: int = Field(..., description="Number of products in the uploaded corpus.")


class ModelSwapRequest(BaseModel):
    """POST /admin/model body (the retrain loop's deploy step)."""

    model_config = {"protected_namespaces": ()}

    model_dir: str = Field(..., min_length=1, description="Path to the new model checkpoint dir.")


class ModelSwapResponse(BaseModel):
    model_config = {"protected_namespaces": ()}

    status: str = "ok"
    model_dir: str = Field(..., description="The now-serving model directory.")
    best: Optional[Dict[str, Any]] = Field(
        default=None, description="best.json contents found next to the checkpoint, if any."
    )
