"""The row norms' share of their roofline, in %: the f32 residual row read
and its bf16 norm written once, twice a layer (layer 0's attention input is
the cast alone) and once for the final norm, for every batch the traced
window served (``counts_modernbert.rownorm_bytes``), at the HBM peak, over
the profiler time of ``mb_rownorm_kernel``."""

from __future__ import annotations

from benchmark import counts_modernbert as cm
from benchmark.metrics import kernels, kernels_modernbert as km


def read(name, reading):
    batches = km.calls(reading)
    if not batches:
        return None
    cfg = reading.ctx.config
    passes = 2 * cfg["num_hidden_layers"] + 1
    n_bytes = passes * sum(cm.rownorm_bytes(b * s, cfg["hidden_size"]) for b, s in batches)
    return kernels.share(n_bytes / cm.PEAK_BYTES, kernels.seconds(reading.trace, km.ROWNORM))
