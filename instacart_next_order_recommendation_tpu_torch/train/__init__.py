"""Contrastive training loop (MNRL) on one GPU."""

from instacart_next_order_recommendation_tpu_torch.train.trainer import (
    TrainConfig,
    TwoTowerTrainer,
)

__all__ = ["TrainConfig", "TwoTowerTrainer"]
