"""GPU compute ops: hand-written CUDA kernels beside plain PyTorch versions.

Each op has a plain PyTorch version (``*_reference``) and an entry point that
dispatches on the tensor's device: a CPU tensor takes the plain version, a
CUDA tensor launches the kernel from ``csrc/`` or raises. There is no switch
and no fallback. Each entry point counts its kernel launches in a plain
integer attribute, ``<entry>.launches``, added to under a lock
(``_build.count``) since several threads may launch at once. K1-train and
K5 also count the launches of their residual-saving form, inside
``.launches``, in ``<entry>.resid_launches``.
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
from instacart_next_order_recommendation_tpu_torch.ops.modernbert import (
    modernbert_attention,
    modernbert_final_norm,
    modernbert_layer,
)
from instacart_next_order_recommendation_tpu_torch.ops.pool_norm import (
    masked_mean_pool_l2norm,
)
from instacart_next_order_recommendation_tpu_torch.ops.topk import cosine_topk

# Every kernel wrapper, by the name its launch counter goes under.
KERNEL_WRAPPERS = (
    fused_encoder_layer,
    fused_encoder_layer_train,
    fused_encoder_layer_backward,
    masked_mean_pool_l2norm,
    cosine_topk,
    multi_head_attention,
    multi_head_attention_backward,
    modernbert_layer,
    modernbert_attention,
    modernbert_final_norm,
)


# The wrappers that also count one form of their kernel apart, by the name
# ``launch_counts`` gives that form: the launches of the residual-saving form
# (``fused_layer.saves_residuals``), counted in ``.resid_launches``.
RESID_COUNTED = (fused_encoder_layer_train, fused_encoder_layer_backward)


def counter_names(wrapper) -> tuple[str, ...]:
    """The attributes ``wrapper`` counts its launches in."""
    return ("launches", "resid_launches") if wrapper in RESID_COUNTED else ("launches",)


def launch_counts() -> dict[str, int]:
    """Each kernel wrapper's launches since its counters were last reset, and
    under ``<name>.resid`` those of K1-train's and K5's residual-saving form."""
    counts = {w.__name__: w.launches for w in KERNEL_WRAPPERS}
    counts.update({f"{w.__name__}.resid": w.resid_launches for w in RESID_COUNTED})
    return counts


def reset_launch_counts() -> None:
    for w in KERNEL_WRAPPERS:
        for name in counter_names(w):
            setattr(w, name, 0)


__all__ = [
    "KERNEL_WRAPPERS",
    "RESID_COUNTED",
    "cosine_topk",
    "counter_names",
    "fused_encoder_layer",
    "fused_encoder_layer_backward",
    "fused_encoder_layer_train",
    "launch_counts",
    "masked_mean_pool_l2norm",
    "mnrl_loss",
    "modernbert_attention",
    "modernbert_final_norm",
    "modernbert_layer",
    "multi_head_attention",
    "multi_head_attention_backward",
    "multi_head_attention_backward_reference",
    "multi_head_attention_reference",
    "reset_launch_counts",
]
