"""K1's share of its roofline, in %: the least time the card could take for
every fused-layer forward the traced window ran (``counts.k1_bound_s`` at
each call's rows and its longest real row rounded up to 16, with the two
dropout masks in training) over the summed profiler time of K1's kernels
(outside the layer's backward)."""

from __future__ import annotations

from benchmark import counts
from benchmark.metrics import kernels


def read(name, reading):
    cfg, rec = reading.ctx.config, reading.window.records
    h, inter, layers = cfg["hidden_size"], cfg["intermediate_size"], cfg["num_hidden_layers"]
    if "steps" in rec:
        bound = sum(
            counts.k1_bound_s(s["rows"], s["a_seq"], h, inter, masked=True)
            + counts.k1_bound_s(s["rows"], s["p_seq"], h, inter, masked=True)
            for s in rec["steps"]
        )
        spent = kernels.seconds(reading.trace, kernels.K1, backward=False)
    else:
        bound = sum(counts.k1_bound_s(b["rows"], b["seq"], h, inter) for b in rec["all_batches"])
        spent = kernels.seconds(reading.trace, kernels.K1)
    return kernels.share(bound * layers, spent)
