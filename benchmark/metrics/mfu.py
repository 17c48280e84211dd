"""The whole step's share of the card's bf16 peak, in %: the operations the
window's work needs (each sequence at its real length rounded up to 16;
serving adds 2 N D a query for the top-k; a training step three times the
forward of both towers) over the window's seconds, over 989 TFLOP/s."""

from __future__ import annotations

from benchmark import counts


def read(name, reading):
    cfg, rec = reading.ctx.config, reading.window.records
    h, inter, layers = cfg["hidden_size"], cfg["intermediate_size"], cfg["num_hidden_layers"]
    if "steps" in rec:
        flops = sum(counts.train_flops(s["a_lengths"], s["p_lengths"], h, inter, layers)
                    for s in rec["steps"])
    else:
        flops = sum(counts.serve_flops(b["lengths"], h, inter, layers, rec["n_catalog"])
                    for b in rec["batches"])
    if flops <= 0:
        return None
    return 100.0 * flops / rec["window_s"] / counts.PEAK_BF16
