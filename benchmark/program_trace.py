"""The program's own spans and counters, read after a traced window.

While a profiler runs, the port (``utils/profiling.py`` of the program)
records a span of each piece of its work, on every thread, and counts its
tower's rows, padded slots and real tokens. This module reads them and puts
span times in seconds on the clock of ``trace.Trace.ops``: the profiler
stamps events in Unix-epoch nanoseconds, and the spans are taken on that
clock. A program without the recorder (an older commit) gives no span and
no counter, and the readers of these numbers return None.
"""

from __future__ import annotations

from instacart_next_order_recommendation_tpu_torch.utils import profiling


def spans(name: str) -> list[tuple[float, float]]:
    """(start, end) in s on the trace's clock of every finished span
    ``name``, on any thread."""
    read = getattr(profiling, "spans", None)
    if read is None:
        return []
    return [(s.start_ns * 1e-9, s.end_ns * 1e-9) for s in read() if s.name == name]


def mean_ms(name: str) -> float | None:
    """Mean host milliseconds of the spans ``name``; None without one."""
    got = spans(name)
    return 1e3 * sum(b - a for a, b in got) / len(got) if got else None


def counters() -> dict[str, int]:
    """The program's counters (one device sync); empty without them."""
    read = getattr(profiling, "counters", None)
    return read() if read is not None else {}
