"""Spans on the host, and the reduction of a ``torch.profiler`` trace.

The benchmark's own spans (``Spans``) wrap its calls into the program's
layers: a name, a thread, a start and an end on the host clock, kept in
memory, and put on the wall clock that the profiler's timestamps use.

``reduce`` turns the profiler's events into what the metric readers read:
every device operation (kernel, copy, fill) with its start and duration,
whether the backward launched it, and the device's busy seconds (the union
of the operations' intervals).
"""

from __future__ import annotations

import bisect
import contextlib
import heapq
import re
import threading
import time
from dataclasses import dataclass, field

DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")
BACKWARD_MARK = "_TrainLayerBackward"


class Spans:
    """Host spans, in memory: (name, thread, start, end) on ``perf_counter``,
    with the offset that puts them on the wall clock a trace uses."""

    def __init__(self):
        self.items: list[tuple[str, int, float, float]] = []
        self.wall_offset = time.time() - time.perf_counter()
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            t1 = time.perf_counter()
            with self._lock:
                self.items.append((name, threading.get_ident(), t0, t1))

    def durations(self, name: str, lo: float = float("-inf"), hi: float = float("inf")):
        """Seconds of each ``name`` span that started in [lo, hi)."""
        return [t1 - t0 for n, _, t0, t1 in self.items if n == name and lo <= t0 < hi]

    def on_wall_clock(self) -> list[tuple[str, float, float]]:
        off = self.wall_offset
        return [(n, t0 + off, t1 + off) for n, _, t0, t1 in self.items]


def kernel_name(name: str) -> str:
    """A demangled kernel name without its return type, its anonymous
    namespaces and its parameter list."""
    name = name.replace("(anonymous namespace)::", "")
    depth = 0
    for i, ch in enumerate(name):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0:
            name = name[:i]
            break
    if name.startswith("void "):
        name = name[5:]
    return name.strip()[:160]


@dataclass
class DeviceOp:
    name: str
    start: float  # s on the trace's clock
    dur: float  # s
    in_backward: bool


@dataclass
class Trace:
    ops: list[DeviceOp]
    window_s: float
    busy_s: float
    spans: list[tuple[str, float, float]] = field(default_factory=list)  # trace clock
    census: dict = field(default_factory=dict)  # what the reduction found, for the log

    def ops_named(self, pattern: re.Pattern, backward: bool | None = None) -> list[DeviceOp]:
        return [
            op for op in self.ops
            if pattern.search(op.name) and (backward is None or op.in_backward == backward)
        ]


def _busy(intervals: list[tuple[float, float]]) -> tuple[float, list[tuple[float, float]]]:
    merged: list[list[float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return sum(b - a for a, b in merged), [(a, b) for a, b in merged]


def _get(e, name, default=None):
    fn = getattr(e, name, None)
    if fn is None:
        return default
    try:
        return fn()
    except (RuntimeError, TypeError):
        return default


def reduce(prof, window_s: float, spans: list | None = None) -> Trace:
    """The trace of ``prof`` (stopped), over a window of ``window_s`` s;
    ``spans``: the host spans on the wall clock. An operation is in the
    backward when the CPU operation it was launched under lies, on its
    thread, inside a ``_TrainLayerBackward`` range (the autograd engine's)."""
    events = prof.profiler.kineto_results.events()
    cpu_ops: dict[int, tuple[int, float]] = {}  # correlation id -> (thread, start)
    backward: dict[int, list[tuple[float, float]]] = {}  # thread -> ranges
    device = []
    kinds: dict[str, int] = {}
    for e in events:
        kind = str(_get(e, "activity_type", ""))
        dev = str(_get(e, "device_type", ""))
        key = f"{dev.rsplit('.', 1)[-1]}/{kind}"
        kinds[key] = kinds.get(key, 0) + 1
        start = _get(e, "start_ns", 0) * 1e-9
        dur = _get(e, "duration_ns", 0) * 1e-9
        name = _get(e, "name", "")
        if kind in DEVICE_ACTIVITIES or (
            dev.endswith("CUDA") and "annotation" not in kind
            and not _get(e, "is_user_annotation", False)
        ):
            device.append((name, start, dur, _get(e, "linked_correlation_id", 0)))
            continue
        if not dev.endswith("CPU"):
            continue
        tid = _get(e, "start_thread_id", 0)
        cpu_ops[_get(e, "correlation_id", 0)] = (tid, start)
        if BACKWARD_MARK in name:
            backward.setdefault(tid, []).append((start, start + dur))
    for ranges in backward.values():
        ranges.sort()
    starts = {tid: [a for a, _ in r] for tid, r in backward.items()}

    def in_backward(linked: int) -> bool:
        op = cpu_ops.get(linked)
        if op is None:
            return False
        tid, t = op
        i = bisect.bisect_right(starts.get(tid, []), t) - 1
        return i >= 0 and t <= backward[tid][i][1]

    ops = [DeviceOp(kernel_name(n), s, d, in_backward(lc)) for n, s, d, lc in device]
    busy, _ = _busy([(op.start, op.start + op.dur) for op in ops])
    out = Trace(ops=ops, window_s=window_s, busy_s=busy, spans=spans or [])
    out.census = {
        "events": kinds,
        "backward_ranges": sum(len(r) for r in backward.values()),
        "in_backward": sum(op.in_backward for op in ops),
    }
    return out


def breakdown(trace: Trace, top: int = 10) -> dict:
    """The device operations that took the most time, and the idle gaps
    between them summed by the benchmark spans open on the host at each
    gap's middle."""
    by_name: dict[str, float] = {}
    for op in trace.ops:
        by_name[op.name] = by_name.get(op.name, 0.0) + op.dur
    _, merged = _busy([(op.start, op.start + op.dur) for op in trace.ops])
    gaps: dict[str, float] = {}
    spans = sorted(trace.spans, key=lambda s: s[1])
    open_spans: list[tuple[float, int, str]] = []  # heap of (end, index, name)
    nxt = 0
    for (_, a), (b, _) in zip(merged, merged[1:]):
        mid = 0.5 * (a + b)
        while nxt < len(spans) and spans[nxt][1] <= mid:
            heapq.heappush(open_spans, (spans[nxt][2], nxt, spans[nxt][0]))
            nxt += 1
        while open_spans and open_spans[0][0] < mid:
            heapq.heappop(open_spans)
        names = sorted({n for _, _, n in open_spans})
        key = "+".join(names) if names else "none"
        gaps[key] = gaps.get(key, 0.0) + (b - a)
    first = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n, s] for n, s in first], "idle_gaps": [[n, s] for n, s in idle]}
