"""The ModernBERT layer's products' share of their roofline, in %: the least
time for the four products (Wqkv, Wo, Wi, Wo_mlp) of every layer of every
batch the traced window served (``counts_modernbert.gemm_bound_s`` on rows x
longest real row rounded up to 16) over the profiler time of the GEMM core
(``gemm_wgmma_kernel``), which runs them."""

from __future__ import annotations

from benchmark import counts_modernbert as cm
from benchmark.metrics import kernels, kernels_modernbert as km


def read(name, reading):
    batches = km.calls(reading)
    if not batches:
        return None
    cfg = reading.ctx.config
    h, inter, n = cfg["hidden_size"], cfg["intermediate_size"], cfg["num_hidden_layers"]
    bound = n * sum(cm.gemm_bound_s(b * s, h, inter) for b, s in batches)
    return kernels.share(bound, kernels.seconds(reading.trace, km.GEMM))
