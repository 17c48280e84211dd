"""The port's own spans and counters, and ``torch.profiler`` traces.

:func:`span` marks a piece of the program's work by name. It records while
a ``torch.profiler`` runs anywhere in the process, on every thread (the
profiler's own switch is per thread: ranges opened on a thread it does not
record are dropped), into the list :func:`spans` returns; and on one thread
inside ``with recording() as sink:``, into ``sink``. Off, it reads those
two flags and returns one shared no-op. On, each span keeps its name, its
thread, its start and end in Unix-epoch nanoseconds (the clock the
profiler stamps its events on) and its parent, the innermost span open on
the same thread; on a thread the profiler records it also opens a
``record_function`` range of the same name, so a trace shows it.
:func:`clear` forgets the spans and the counts.

:func:`count` adds a host integer to a named counter; :func:`count_device`
adds the sum of a tensor into an int64 accumulator on the tensor's device,
so nothing waits for the device; :func:`counters` syncs once and returns
plain ints. Both count only while a profiler runs.

Spans and counts in the port: ``serve.upload`` and ``serve.launch``
(``FusedServePipeline``); ``tower.encode`` with ``tower.rows``,
``tower.slots`` (rows x width) and ``tower.tokens`` (the mask's sum) for
every tower forward; ``train.step`` and its ``train.forward``,
``train.backward`` and ``train.optimizer``; ``train.assemble`` and
``train.seeds`` in the trainer's loop, whose ``ITOR_LOOP_TIMING`` line is
read from them through ``recording()``.

The trainer traces its first dispatches through :func:`device_profiler`
(``ITOR_PROFILE_DIR``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import os
import threading
import time

import torch
import torch.autograd.profiler as _profiler

ENV_PROFILE_DIR = "ITOR_PROFILE_DIR"


def device_profiler(trace_dir: str | os.PathLike, cuda: bool) -> torch.profiler.profile:
    """A profiler (not yet started) that records CPU activity, and CUDA
    activity with ``cuda``, and writes a Chrome trace (``*.pt.trace.json``)
    into ``trace_dir`` when it stops."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(
        activities=activities,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(str(trace_dir)),
    )


@dataclasses.dataclass(frozen=True)
class Span:
    """A finished span: ``parent`` is the ``id`` of the innermost span that
    was open on the same thread when it opened (None at the top)."""

    name: str
    thread: int
    start_ns: int
    end_ns: int
    id: int
    parent: int | None


class _Thread(threading.local):
    def __init__(self):
        self.stack: list[_Open] = []  # the spans open on this thread, innermost last
        self.sink: list[Span] | None = None  # the list of this thread's recording()


_lock = threading.Lock()
_local = _Thread()
_ids = itertools.count()
_spans: list[Span] = []
_host_counts: dict[str, int] = {}
_device_counts: dict[tuple[torch.device, str], torch.Tensor] = {}


@contextlib.contextmanager
def recording():
    """Record the spans this thread opens inside the block, with no
    profiler, into the list the block is given (not into :func:`spans`).
    Nothing is counted and no other thread records."""
    outer, _local.sink = _local.sink, []
    try:
        yield _local.sink
    finally:
        _local.sink = outer


_OFF = contextlib.nullcontext()  # the span while nothing records: stateless, shared


class _Open:
    __slots__ = ("name", "id", "parent", "start_ns", "range", "sink", "traced")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = _local.stack
        self.parent = stack[-1].id if stack else None
        self.id = next(_ids)
        stack.append(self)
        self.sink = _local.sink
        self.traced = _profiler._is_profiler_enabled
        self.range = None
        if torch.autograd._profiler_enabled():  # this thread's profiler switch
            self.range = torch.profiler.record_function(self.name)
            self.range.__enter__()
        # Read after the range's enter, and the end after its exit: the
        # profiler stamps them inside those calls, and the two then agree.
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        if self.range is not None:
            self.range.__exit__(*exc)
        end_ns = time.time_ns()
        _local.stack.pop()
        done = Span(self.name, threading.get_ident(), self.start_ns, end_ns, self.id,
                    self.parent)
        if self.sink is not None:
            self.sink.append(done)
        if self.traced:
            with _lock:
                _spans.append(done)
        return False


def span(name: str):
    """A context manager that records the enclosed block as ``name`` while a
    profiler runs or this thread's :func:`recording` is open; a shared
    no-op otherwise."""
    if _profiler._is_profiler_enabled or _local.sink is not None:
        return _Open(name)
    return _OFF


def count(name: str, n: int) -> None:
    """Add the host integer ``n`` to counter ``name`` while a profiler runs."""
    if not _profiler._is_profiler_enabled:
        return
    with _lock:
        _host_counts[name] = _host_counts.get(name, 0) + int(n)


def count_device(name: str, tensor: torch.Tensor) -> None:
    """Add ``tensor.sum()`` to counter ``name`` on the tensor's device
    while a profiler runs, without waiting for it."""
    if not _profiler._is_profiler_enabled:
        return
    with torch.no_grad():
        total = tensor.sum()
    with _lock:
        acc = _device_counts.get((tensor.device, name))
        if acc is None:
            with torch.inference_mode(False):  # a normal tensor, added to in any mode
                acc = torch.zeros((), dtype=torch.int64, device=tensor.device)
            _device_counts[(tensor.device, name)] = acc
        acc.add_(total)


def spans() -> list[Span]:
    """The finished spans a profiler saw open, in the order they closed."""
    with _lock:
        return list(_spans)


def counters() -> dict[str, int]:
    """Every counter's total: the host counts, and the device counts read
    with one sync per device."""
    with _lock:
        out = dict(_host_counts)
        on_device = list(_device_counts.items())
    by_device: dict[torch.device, list[tuple[str, torch.Tensor]]] = {}
    for (device, name), acc in on_device:
        by_device.setdefault(device, []).append((name, acc))
    for items in by_device.values():
        values = torch.stack([acc for _, acc in items]).tolist()
        for (name, _), v in zip(items, values):
            out[name] = out.get(name, 0) + int(v)
    return out


def clear() -> None:
    """Forget every finished span and zero every counter."""
    with _lock:
        _spans.clear()
        _host_counts.clear()
        _device_counts.clear()
