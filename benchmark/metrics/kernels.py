"""The kernels of each piece of the port's work, by demangled name, and the
sums the roofline readers take of them. A kernel a later change adds to a
piece joins its table in a new reader; these tables stay as they are."""

from __future__ import annotations

import re

# Names as ``trace.kernel_name`` gives them, namespace prefixes allowed.
# K1, the fused layer forward: its GEMM core, attention and LayerNorm rows
# (``ops/csrc/fused_layer.cu`` on ``fused_layer_common.cuh``).
K1 = re.compile(
    r"(^|::)(gemm_wgmma_kernel|attn_fwd_one_pass_kernel|attn_fwd_two_pass_kernel"
    r"|residual_layernorm_kernel)\b"
)
# K5, the fused layer backward (``ops/csrc/fused_layer_bwd.cu``): the same
# core and rows where it recomputes, its LayerNorm backward, column sums and
# attention backward; only inside the layer's backward.
K5 = re.compile(
    r"(^|::)(gemm_wgmma_kernel|attn_fwd_one_pass_kernel|attn_fwd_two_pass_kernel"
    r"|residual_layernorm_kernel|ln_bwd_kernel|colsum_kernel|attn_bwd_dq_kernel"
    r"|attn_bwd_dkdv_kernel)\b"
)
# K3, exact cosine top-k (``ops/csrc/topk.cu``): the slice kernel and the merge.
K3 = re.compile(r"(^|::)(topk_slices_kernel|topk_slices_bf16_kernel|topk_merge_kernel)\b")


def seconds(trace, pattern, backward=None) -> float:
    if trace is None:
        return 0.0
    return sum(op.dur for op in trace.ops_named(pattern, backward))


def share(bound_s: float, spent_s: float):
    """A roofline share in %, or None where no kernel time was read."""
    if spent_s <= 0.0 or bound_s <= 0.0:
        return None
    return 100.0 * bound_s / spent_s
