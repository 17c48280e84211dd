"""K5's share of its roofline, in %: the least time for every fused-layer
backward of the traced window (``counts.k5_bound_s``: the gradient's own
operations, no forward recompute) over the summed profiler time of K5's
kernels launched inside the layer's backward."""

from __future__ import annotations

from benchmark import counts
from benchmark.metrics import kernels


def read(name, reading):
    cfg, rec = reading.ctx.config, reading.window.records
    if "steps" not in rec:
        return None
    h, inter, layers = cfg["hidden_size"], cfg["intermediate_size"], cfg["num_hidden_layers"]
    bound = sum(
        counts.k5_bound_s(s["rows"], s["a_seq"], h, inter)
        + counts.k5_bound_s(s["rows"], s["p_seq"], h, inter)
        for s in rec["steps"]
    )
    return kernels.share(bound * layers, kernels.seconds(reading.trace, kernels.K5, backward=True))
