"""Catalog embedding cache and the on-device exact index."""

from instacart_next_order_recommendation_tpu_torch.index.embedding_index import EmbeddingIndex
from instacart_next_order_recommendation_tpu_torch.index.sharded import ShardedCatalogIndex

__all__ = ["EmbeddingIndex", "ShardedCatalogIndex"]
