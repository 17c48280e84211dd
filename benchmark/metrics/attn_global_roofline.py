"""Global attention's share of its roofline, in %: the least time for the
global layers of every batch the traced window served
(``counts_modernbert.global_attention_bound_s`` at each call's rows and
longest real row rounded up to 16: 4 s^2 h at the bf16 peak) over the
profiler time of ``mb_attn_global_kernel``."""

from __future__ import annotations

from benchmark import counts_modernbert as cm
from benchmark.metrics import kernels, kernels_modernbert as km


def read(name, reading):
    batches = km.calls(reading)
    if not batches:
        return None
    h = reading.ctx.config["hidden_size"]
    n_global, _ = cm.layer_counts(reading.ctx.config)
    bound = n_global * sum(cm.global_attention_bound_s(b, s, h) for b, s in batches)
    return kernels.share(bound, kernels.seconds(reading.trace, km.ATTN_GLOBAL))
