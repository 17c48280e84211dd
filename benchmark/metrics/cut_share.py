"""The share of the tower's handed slots that the program's forwards cut
away over the traced window, in %: 100 x ``tower.cut_slots`` /
``tower.slots``, the program's counts of rows times the columns a forward
did not run (past its longest real row, rounded up to 16) and of rows times
the width it was handed. None from a program without the slot count; 0 from
one that counts slots and cuts nothing. The log gives the share from the
window's own records beside it: each step's anchors and positives at their
widths (``a_seq``, ``p_seq``) against ``drivers/train.py``'s one padded width, the
bucket of the window's longest pair, as ``pad_share`` takes it."""

from __future__ import annotations

from benchmark import program_trace, workgen
from benchmark.harness import log


def from_records(reading) -> tuple[int, int]:
    """(cut slots, slots) of the window's train steps at the records' widths."""
    steps = reading.window.records.get("steps", [])
    cap = reading.ctx.traffic["max_seq_length"]
    longest = max((int(max(s["a_lengths"].max(), s["p_lengths"].max())) for s in steps),
                  default=0)
    handed = workgen.bucket_length(longest, cap)
    cut = sum(s["rows"] * (2 * handed - min(s["a_seq"], handed) - min(s["p_seq"], handed))
              for s in steps)
    return cut, sum(2 * s["rows"] * handed for s in steps)


def read(name, reading):
    c = program_trace.counters()
    slots = c.get("tower.slots", 0)
    if not slots:
        return None
    cut = c.get("tower.cut_slots", 0)
    share = 100.0 * cut / slots
    r_cut, r_slots = from_records(reading)
    r_share = 100.0 * r_cut / r_slots if r_slots else None
    log(f"{name}: program {share!r}% ({cut} of {slots} slots cut); the window's records "
        f"{r_share!r}% ({r_cut} of {r_slots})")
    return share
