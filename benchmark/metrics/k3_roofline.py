"""K3's share of its roofline, in %: the least time for the exact top-k of
every batch the traced window served (``counts.k3_bound_s``: 2 B N D at the
TF32 peak, or the catalog's bytes) over the summed profiler time of K3's
kernels."""

from __future__ import annotations

from benchmark import counts
from benchmark.metrics import kernels


def read(name, reading):
    cfg, t, rec = reading.ctx.config, reading.ctx.traffic, reading.window.records
    if "all_batches" not in rec:
        return None
    bound = sum(
        counts.k3_bound_s(b["rows"], rec["n_catalog"], cfg["hidden_size"], t["top_k"])
        for b in rec["all_batches"]
    )
    return kernels.share(bound, kernels.seconds(reading.trace, kernels.K3))
