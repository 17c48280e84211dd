"""Serving: the fused ids -> top-k pipeline, Recommender /
MonitoredRecommender, the MicroBatcher and the serve CLI."""

from instacart_next_order_recommendation_tpu_torch.serve.batching import MicroBatcher
from instacart_next_order_recommendation_tpu_torch.serve.recommender import (
    InferenceConfig,
    MonitoredRecommender,
    RecommendationMetrics,
    Recommender,
)

__all__ = [
    "InferenceConfig",
    "MicroBatcher",
    "MonitoredRecommender",
    "Recommender",
    "RecommendationMetrics",
]
