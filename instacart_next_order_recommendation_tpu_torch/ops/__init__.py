"""GPU compute ops: hand-written CUDA kernels beside plain PyTorch versions.

Each op has a plain PyTorch version (``*_reference``) and an entry point that
dispatches on the tensor's device: a CPU tensor takes the plain version, a
CUDA tensor launches the kernel from ``csrc/`` or raises. There is no switch
and no fallback. Each entry point counts its kernel launches in a plain
integer attribute, ``<entry>.launches``, added to under a lock
(``_build.count``) since several threads may launch at once.
"""

from instacart_next_order_recommendation_tpu_torch.ops.attention import (
    multi_head_attention,
    multi_head_attention_backward,
    multi_head_attention_backward_reference,
    multi_head_attention_reference,
)
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
    "multi_head_attention",
    "multi_head_attention_backward",
    "multi_head_attention_backward_reference",
    "multi_head_attention_reference",
]
