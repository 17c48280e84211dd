"""The MiniLM- and mpnet-class towers, their checkpoint IO and the text encoder."""

from instacart_next_order_recommendation_tpu_torch.models.encoder import (
    MINILM_L6,
    MPNET_BASE_CLASS,
    TowerConfig,
)

__all__ = ["MINILM_L6", "MPNET_BASE_CLASS", "TowerConfig"]
