"""The GeGLU pass's share of its roofline, in %: [a | g] read and the
product written once for every layer of every batch the traced window
served (``counts_modernbert.geglu_bytes``), at the HBM peak, over the
profiler time of ``mb_geglu_kernel``."""

from __future__ import annotations

from benchmark import counts_modernbert as cm
from benchmark.metrics import kernels, kernels_modernbert as km


def read(name, reading):
    batches = km.calls(reading)
    if not batches:
        return None
    cfg = reading.ctx.config
    n_bytes = cfg["num_hidden_layers"] * sum(
        cm.geglu_bytes(b * s, cfg["intermediate_size"]) for b, s in batches)
    return kernels.share(n_bytes / cm.PEAK_BYTES, kernels.seconds(reading.trace, km.GEGLU))
