"""Catalog embedding cache, the on-device exact index and the IVF index."""

from instacart_next_order_recommendation_tpu_torch.index.embedding_index import EmbeddingIndex
from instacart_next_order_recommendation_tpu_torch.index.ivf import IVFCatalogIndex
from instacart_next_order_recommendation_tpu_torch.index.sharded import ShardedCatalogIndex

__all__ = ["EmbeddingIndex", "IVFCatalogIndex", "ShardedCatalogIndex"]
