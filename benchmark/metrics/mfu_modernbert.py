"""The whole ModernBERT serve step's share of the card's bf16 peak, in %:
the operations the window's answered queries need at their real lengths
rounded up to 16 (``counts_modernbert.serve_flops``: the four products of
every layer, global attention's 4 s^2 h on the global layers and the band's
4 h (129 s - 4,160) on the others, and 2 N D a query for the top-k) over
the window's seconds, over 989 TFLOP/s."""

from __future__ import annotations

from benchmark import counts_modernbert as cm


def read(name, reading):
    cfg, rec = reading.ctx.config, reading.window.records
    if "batches" not in rec or "global_attn_every_n_layers" not in cfg:
        return None
    flops = sum(cm.serve_flops(b["lengths"], cfg, rec["n_catalog"]) for b in rec["batches"])
    if flops <= 0:
        return None
    return 100.0 * flops / rec["window_s"] / cm.PEAK_BF16
