"""Baselines: content-based (untrained tower) and item-item CF."""

from instacart_next_order_recommendation_tpu_torch.baselines.collaborative_filtering import (
    ItemItemCFBaseline,
    load_eval_data,
)
from instacart_next_order_recommendation_tpu_torch.baselines.content_based import (
    ContentBasedBaseline,
)

__all__ = ["ContentBasedBaseline", "ItemItemCFBaseline", "load_eval_data"]
