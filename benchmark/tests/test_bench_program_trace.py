"""The readers of the program's own spans and counters: on a traced tiny run
of each cell they read numbers, the padded share equals the one the
window's own records give, an untraced run records nothing, and ``idle_in``
returns None without device operations and never exceeds ``idle``."""

import types

import numpy as np
import pytest
from torch.profiler import ProfilerActivity, profile

from benchmark import harness, program_trace, trace
from benchmark.metrics import idle_in, pad_share
from benchmark.tests import tiny
from instacart_next_order_recommendation_tpu_torch.tokenizer import bucket_length
from instacart_next_order_recommendation_tpu_torch.utils import profiling

NEW = {
    "serve_closed": ["upload_ms.serve", "launch_ms.serve", "pad_share.serve"],
    "train": ["pad_share.train"],
}
IDLE_IN = {
    "serve_closed": ["idle_in.serve.upload", "idle_in.serve.launch"],
    "train": ["idle_in.train.forward", "idle_in.train.backward", "idle_in.train.optimizer"],
}


@pytest.fixture(autouse=True)
def empty_recorder():
    profiling.clear()
    yield
    profiling.clear()


def spied_run(monkeypatch, cell: str, traced: bool):
    """``tiny.run_tiny`` of ``cell``, keeping the driver's state and window."""
    kept = {}
    real = harness.driver

    def driver(kind):
        drv = real(kind)

        def window(ctx, st):
            kept["st"], kept["window"] = st, drv.window(ctx, st)
            return kept["window"]

        return types.SimpleNamespace(setup=drv.setup, window=window, judge=drv.judge)

    monkeypatch.setattr(harness, "driver", driver)
    # A served batch at the tiny size takes 0.5-1 s on a CPU: a 1.5-s window
    # may close before the first answer, and then no metric has a window.
    res = tiny.run_tiny(cell, seconds=4.0, traced=traced)
    return res, kept["st"], kept["window"]


def share_from_records(kind: str, st: dict, win, max_seq_length: int) -> float:
    """The padded share of the window's own records: each served batch's
    lengths at the tokenizer's bucket of its longest row, or each step's
    anchor and positive lengths at the pool's one padded width."""
    rec = win.records
    if kind == "train":
        tokens = sum(int(s["a_lengths"].sum() + s["p_lengths"].sum()) for s in rec["steps"])
        slots = sum(2 * s["rows"] * st["seq"] for s in rec["steps"])
    else:
        tokens = sum(int(b["lengths"].sum()) for b in rec["all_batches"])
        slots = sum(b["rows"] * bucket_length(int(b["lengths"].max()), max_seq_length)
                    for b in rec["all_batches"])
    return 100.0 * (1.0 - tokens / slots)


def made_up_ops(spans: list[tuple[float, float]]) -> list[trace.DeviceOp]:
    """Device operations that leave one gap inside each span: one ending a
    tenth into it, the next starting a tenth before its end."""
    ops = []
    for a, b in spans:
        ops.append(trace.DeviceOp("k", a, 0.1 * (b - a), False))
        ops.append(trace.DeviceOp("k", b - 0.1 * (b - a), 0.1 * (b - a), False))
    return ops


@pytest.mark.parametrize("kind", ["serve_closed", "train"])
def test_a_traced_tiny_run_reads_every_new_metric(monkeypatch, kind):
    cell = tiny.cells_of(kind)[0]
    res, st, win = spied_run(monkeypatch, cell, traced=True)
    assert res["correct"], res["checks"]
    for name in NEW[kind]:
        assert name in res["metrics"], (name, sorted(res["metrics"]))
    # The CPU's trace holds no device operation: idle_in, like idle, reads
    # nothing there.
    assert not set(IDLE_IN[kind]) & set(res["metrics"])
    share = res["metrics"][f"pad_share.{'train' if kind == 'train' else 'serve'}"]["value"]
    _, _, _, traffic, _ = tiny.cell_files(cell)
    traffic = tiny.tiny({}, traffic)[1]
    want = share_from_records(kind, st, win, traffic["max_seq_length"])
    assert share == pytest.approx(want, rel=0, abs=1e-9)
    # The reader's own log line reads the records at the driver's widths too.
    ctx = types.SimpleNamespace(traffic=traffic)
    tokens, _, slots = pad_share.from_records(harness.Reading(ctx, win, None, 0.0))
    assert 100.0 * (1.0 - tokens / slots) == pytest.approx(want, rel=0, abs=1e-9)
    assert 0.0 < share < 100.0
    # With device operations made up around the window's own spans, each
    # idle_in reads a number, and all of them no more than idle.
    names = {n: n.split(".", 1)[1] for n in IDLE_IN[kind]}
    spans = [s for n in names.values() for s in program_trace.spans(n)]
    assert all(program_trace.spans(n) for n in names.values()), names
    first = min(a for a, _ in spans)
    tr = trace.Trace(ops=made_up_ops(spans), window_s=max(b for _, b in spans) - first, busy_s=0)
    tr.busy_s, _ = trace._busy([(op.start, op.start + op.dur) for op in tr.ops])
    reading = harness.Reading(None, win, tr, 0.0)
    got = {n: idle_in.read(n, reading) for n in names}
    assert all(v is not None and v > 0 for v in got.values()), got
    idle = harness.metric_reader("idle.x").read("idle.x", reading)
    assert sum(got.values()) <= idle + 1e-9


@pytest.mark.parametrize("kind", ["serve_closed", "train"])
def test_an_untraced_run_records_no_span(kind):
    res = tiny.run_tiny(tiny.cells_of(kind)[0], seconds=1.0)
    assert res["attempted"] > 0
    assert profiling.spans() == [] and profiling.counters() == {}


def test_idle_in_returns_none_without_ops_or_spans():
    empty = harness.Reading(None, None, trace.Trace(ops=[], window_s=1.0, busy_s=0.0), 0.0)
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span("serve.upload"):
            pass
    assert idle_in.read("idle_in.serve.upload", empty) is None
    assert idle_in.read("idle_in.serve.upload", harness.Reading(None, None, None, 0.0)) is None
    busy = trace.Trace(ops=[trace.DeviceOp("k", 0.0, 1.0, False)], window_s=2.0, busy_s=1.0)
    assert idle_in.read("idle_in.serve.launch", harness.Reading(None, None, busy, 0.0)) is None


def test_idle_in_counts_each_gap_once_and_never_exceeds_idle():
    rng = np.random.default_rng(3)
    for _ in range(20):
        starts = np.sort(rng.uniform(0, 10, 40))
        ops = [trace.DeviceOp("k", float(a), float(d), False)
               for a, d in zip(starts, rng.uniform(0.01, 0.4, 40))]
        tr = trace.Trace(ops=ops, window_s=11.0, busy_s=0.0)
        tr.busy_s, merged = trace._busy([(op.start, op.start + op.dur) for op in ops])
        # Spans of two names that never overlap each other, and one over all.
        cuts = np.sort(rng.uniform(0, 11, 30))
        parts = [[(float(a), float(b)) for a, b in zip(cuts[i::3], cuts[i + 1::3])]
                 for i in range(2)]
        every = idle_in.idle_inside(tr, [(0.0, 11.0)])
        inner = sum(b - a for (_, a), (b, _) in zip(merged, merged[1:]))
        assert every == pytest.approx(inner)
        shares = [idle_in.idle_inside(tr, p) for p in parts]
        assert sum(shares) <= every + 1e-12
        assert every <= tr.window_s - tr.busy_s + 1e-12


def test_readers_read_nothing_from_a_program_without_the_recorder(monkeypatch):
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span("serve.upload"):
            profiling.count("tower.slots", 4)
    assert program_trace.spans("serve.upload") and program_trace.counters()
    # An older program's utils/profiling.py: device_profiler and no recorder.
    monkeypatch.setattr(program_trace, "profiling",
                        types.SimpleNamespace(device_profiler=profiling.device_profiler))
    assert program_trace.spans("serve.upload") == [] and program_trace.counters() == {}
    tr = trace.Trace(ops=[trace.DeviceOp("k", 0.0, 1.0, False),
                          trace.DeviceOp("k", 2.0, 1.0, False)], window_s=3.0, busy_s=2.0)
    reading = harness.Reading(None, None, tr, 0.0)
    for name in ("upload_ms.serve", "launch_ms.serve", "idle_in.serve.upload",
                 "pad_share.serve", "pad_share.train"):
        assert harness.metric_reader(name).read(name, reading) is None, name
