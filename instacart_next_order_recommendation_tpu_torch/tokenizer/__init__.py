"""Host-side tokenization feeding fixed-shape int32 batches to the tower."""

from instacart_next_order_recommendation_tpu_torch.tokenizer.wordpiece import (
    LENGTH_BUCKETS,
    WordPieceTokenizer,
    bucket_length,
)

__all__ = ["LENGTH_BUCKETS", "WordPieceTokenizer", "bucket_length"]
