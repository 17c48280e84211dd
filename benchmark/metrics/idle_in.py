"""The device's idle share of the traced window inside one of the program's
spans, in %: ``idle_in.serve.upload`` reads the span ``serve.upload``. Of
the gaps between the merged busy intervals of the device's operations (as
``trace.breakdown`` takes them), those whose midpoint lies inside a span of
that name, on any thread, summed over the window's seconds. A gap counts
once, so a cell's ``idle_in`` shares of spans that never overlap sum to at
most its ``idle``."""

from __future__ import annotations

import bisect

from benchmark import program_trace, trace


def idle_inside(tr: trace.Trace, spans: list[tuple[float, float]]) -> float:
    """Seconds of the gaps between ``tr``'s busy intervals whose midpoint
    lies inside one of ``spans`` (on the trace's clock)."""
    _, busy = trace._busy([(op.start, op.start + op.dur) for op in tr.ops])
    _, inside = trace._busy(spans)
    starts = [a for a, _ in inside]
    total = 0.0
    for (_, a), (b, _) in zip(busy, busy[1:]):
        mid = 0.5 * (a + b)
        i = bisect.bisect_right(starts, mid) - 1
        if i >= 0 and mid <= inside[i][1]:
            total += b - a
    return total


def read(name, reading):
    tr = reading.trace
    if tr is None or not tr.ops or tr.window_s <= 0:
        return None
    spans = program_trace.spans(name.split(".", 1)[1])
    if not spans:
        return None
    return 100.0 * idle_inside(tr, spans) / tr.window_s
