"""The share of full attention's (query, key) pairs that the window leaves
out, in %: 100 x (1 - (``attn.pairs.global`` + ``attn.pairs.window``) /
``attn.pairs.full``), the program's counts of every attention launch over
the traced window (global layers at rows x S^2, windowed ones at the pairs
of the key tiles the banded kernel schedules, full at rows x S^2 on every
layer). None from a program without the counts. The log gives the same
share from the window's records beside it: each answered batch at the
tokenizer's bucket of its longest row, pairs as
``counts_modernbert.scheduled_band_pairs`` counts them."""

from __future__ import annotations

from benchmark import counts_modernbert as cm, program_trace
from benchmark.drivers import serve_long
from benchmark.harness import log


def from_records(reading) -> float | None:
    rec, cfg = reading.window.records, reading.ctx.config
    cap = reading.ctx.traffic["max_seq_length"]
    n_global, n_window = cm.layer_counts(cfg)
    half = cfg["local_attention"] // 2
    full = kept = 0
    for b in rec.get("all_batches", []):
        s = serve_long.bucket(int(b["lengths"].max()), cap)
        full += (n_global + n_window) * b["rows"] * s * s
        kept += b["rows"] * (n_global * s * s + n_window * cm.scheduled_band_pairs(s, half))
    return 100.0 * (1.0 - kept / full) if full else None


def read(name, reading):
    c = program_trace.counters()
    full = c.get("attn.pairs.full", 0)
    if not full:
        return None
    share = 100.0 * (1.0 - (c.get("attn.pairs.global", 0) + c.get("attn.pairs.window", 0)) / full)
    log(f"{name}: program {share!r}% (pairs {c.get('attn.pairs.global', 0)} global, "
        f"{c.get('attn.pairs.window', 0)} windowed, {full} full); the window's records "
        f"{from_records(reading)!r}%")
    return share
