"""Training data: the Instacart data prep (CSVs -> (anchor, positive) pairs
and IR eval artifacts), the synthetic CSV generator, and no-duplicates
batching. Run the prep with
``python -m instacart_next_order_recommendation_tpu_torch.data``."""

from instacart_next_order_recommendation_tpu_torch.data.batching import (
    no_duplicates_batches,
    steps_per_epoch,
)
from instacart_next_order_recommendation_tpu_torch.data.prepare import (
    DataPrepConfig,
    InstacartDataPrep,
    strip_next_order_from_context,
)

__all__ = [
    "DataPrepConfig",
    "InstacartDataPrep",
    "no_duplicates_batches",
    "steps_per_epoch",
    "strip_next_order_from_context",
]
