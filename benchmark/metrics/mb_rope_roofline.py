"""The RoPE pass's share of its roofline, in %: q and k of every layer of
every batch the traced window served read and written once, and the cos and
sin tables read (``counts_modernbert.rope_bytes``), at the HBM peak, over
the profiler time of ``mb_rope_kernel``."""

from __future__ import annotations

from benchmark import counts_modernbert as cm
from benchmark.metrics import kernels, kernels_modernbert as km


def read(name, reading):
    batches = km.calls(reading)
    if not batches:
        return None
    cfg = reading.ctx.config
    n_bytes = cfg["num_hidden_layers"] * sum(
        cm.rope_bytes(b * s, s, cfg["hidden_size"]) for b, s in batches)
    return kernels.share(n_bytes / cm.PEAK_BYTES, kernels.seconds(reading.trace, km.ROPE))
