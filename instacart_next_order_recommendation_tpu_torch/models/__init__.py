"""The MiniLM- and mpnet-class towers, ModernBERT-base, their checkpoint IO and the text
encoder."""

from instacart_next_order_recommendation_tpu_torch.models.encoder import (
    MINILM_L6,
    MODERNBERT_BASE,
    MPNET_BASE_CLASS,
    TowerConfig,
)

__all__ = ["MINILM_L6", "MODERNBERT_BASE", "MPNET_BASE_CLASS", "TowerConfig"]
