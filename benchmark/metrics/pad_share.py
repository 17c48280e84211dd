"""The share of the tower's slots that held padding over the traced window,
in %: 100 x (1 - ``tower.tokens`` / ``tower.slots``), the program's counts
of real tokens (its masks' sum, on the device) and of rows times padded
width over every tower forward. The log gives the same share from the
window's own records beside it: each served batch's real lengths at the
tokenizer's bucket of its longest row, or each step's anchor and positive
lengths at the driver's one padded width, the bucket of the longest pair
(which the records of a window over the whole pool hold)."""

from __future__ import annotations

from benchmark import program_trace, workgen
from benchmark.harness import log


def from_records(reading) -> tuple[int, int, int]:
    """(real tokens, rows, slots) of the window's records, at the widths
    the driver pads to."""
    rec = reading.window.records
    cap = reading.ctx.traffic["max_seq_length"]
    if "steps" in rec:
        steps = rec["steps"]
        tokens = sum(int(s["a_lengths"].sum() + s["p_lengths"].sum()) for s in steps)
        rows = sum(2 * s["rows"] for s in steps)
        longest = max((int(max(s["a_lengths"].max(), s["p_lengths"].max())) for s in steps),
                      default=0)
        return tokens, rows, rows * workgen.bucket_length(longest, cap)
    batches = rec.get("all_batches", [])
    tokens = sum(int(b["lengths"].sum()) for b in batches)
    rows = sum(b["rows"] for b in batches)
    slots = sum(b["rows"] * workgen.bucket_length(int(b["lengths"].max()), cap) for b in batches)
    return tokens, rows, slots


def read(name, reading):
    c = program_trace.counters()
    slots, tokens, rows = c.get("tower.slots", 0), c.get("tower.tokens"), c.get("tower.rows", 0)
    if not slots or tokens is None:
        return None
    share = 100.0 * (1.0 - tokens / slots)
    r_tokens, r_rows, r_slots = from_records(reading)
    r_share = 100.0 * (1.0 - r_tokens / r_slots) if r_slots else None
    log(f"{name}: program {share!r}% ({tokens} real tokens in {slots} slots, {rows} rows); "
        f"the window's records {r_share!r}% ({r_tokens} real tokens in {r_slots} slots, "
        f"{r_rows} rows)")
    return share
