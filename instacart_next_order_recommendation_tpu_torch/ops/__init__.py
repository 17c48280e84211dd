"""GPU compute ops: hand-written CUDA kernels beside plain PyTorch versions.

Each op has a plain PyTorch version (``*_reference``) and an entry point that
dispatches on the tensor's device: a CPU tensor takes the plain version, a
CUDA tensor launches the kernel from ``csrc/`` or raises. There is no switch
and no fallback. Each entry point counts its kernel launches in a plain
integer attribute, ``<entry>.launches``.
"""

from instacart_next_order_recommendation_tpu_torch.ops.fused_layer import (
    fused_encoder_layer,
    fused_encoder_layer_backward,
    fused_encoder_layer_train,
)
from instacart_next_order_recommendation_tpu_torch.ops.mnrl import mnrl_loss
from instacart_next_order_recommendation_tpu_torch.ops.pool_norm import (
    masked_mean_pool_l2norm,
)
from instacart_next_order_recommendation_tpu_torch.ops.topk import cosine_topk

__all__ = [
    "cosine_topk",
    "fused_encoder_layer",
    "fused_encoder_layer_backward",
    "fused_encoder_layer_train",
    "masked_mean_pool_l2norm",
    "mnrl_loss",
]
