"""Windowed attention's share of its roofline, in %: the least time for the
windowed layers of every batch the traced window served
(``counts_modernbert.band_attention_bound_s``: the band's 4 h (129 s - 4,160)
operations at the bf16 peak, or q, k, v and the output read and written
once, which bound it) over the profiler time of ``mb_attn_band_kernel``."""

from __future__ import annotations

from benchmark import counts_modernbert as cm
from benchmark.metrics import kernels, kernels_modernbert as km


def read(name, reading):
    batches = km.calls(reading)
    if not batches:
        return None
    cfg = reading.ctx.config
    h, half = cfg["hidden_size"], cfg["local_attention"] // 2
    _, n_window = cm.layer_counts(cfg)
    bound = n_window * sum(cm.band_attention_bound_s(b, s, h, half) for b, s in batches)
    return kernels.share(bound, kernels.seconds(reading.trace, km.ATTN_BAND))
