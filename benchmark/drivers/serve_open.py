"""An open loop: calls of ``call`` queries arrive on a Poisson schedule at
``rate`` calls/s, whether or not earlier calls are done.

Each call is ``call`` queries drawn at random from the pool, unsorted. A
feeder releases each call at its due time into a queue; ``tokenizers``
threads tokenize it (the port pads it to the bucket of its longest query),
one dispatcher launches ``FusedServePipeline.topk_device``, ``readers``
threads ``unpack`` it. A call's latency runs from its due time to its ids
on the host, so a stall delays every call behind it. Every call of the
schedule is due inside the window; once the window closes the run waits
for them, ``grace_s`` at most, and a call not answered by then counts as
failed, and as missing its limit. ``serve_p95_ms`` is the 95th percentile
over all of them.
"""

from __future__ import annotations

import queue
import threading
import time

import numpy as np

from benchmark import workgen
from benchmark.drivers import serving

POLL_S = 0.05
MISSING_MS = 1e9  # the latency of a call never answered


def setup(ctx) -> dict:
    st = serving.setup(ctx)
    t = ctx.traffic
    due = workgen.arrival_times(t["rate"], ctx.seconds, ctx.seed)
    rng = workgen.rng_for(ctx.seed, 6)
    pool = st["queries"]
    st["due"] = due
    st["calls"] = [[pool[j] for j in rng.choice(len(pool), t["call"], replace=False)]
                   for _ in range(len(due))]
    serving.warm(ctx, st, st["calls"], None)
    return st


def p95(latencies_ms) -> float:
    return float(np.percentile(np.asarray(latencies_ms, dtype=np.float64), 95))


def latencies_ms(due, t0: float, done_at: dict, deadline: float) -> list[float]:
    """Each scheduled call's latency, from its due time ``t0 + due[i]`` to
    its answer on the host (``done_at[i]``); ``MISSING_MS`` for a call not
    answered by the deadline."""
    out = []
    for i, d in enumerate(due):
        t = done_at.get(i)
        out.append(MISSING_MS if t is None or t > deadline else (t - (t0 + d)) * 1e3)
    return out


def window(ctx, st):
    from benchmark.harness import Window

    t, spans = ctx.traffic, ctx.spans
    tok, fused = st["tok"], st["fused"]
    calls, due = st["calls"], st["due"]
    n_tok, n_read = t["tokenizers"], t["readers"]
    call_q: queue.Queue = queue.Queue()
    tok_q: queue.Queue = queue.Queue()
    disp_q: queue.Queue = queue.Queue()
    stop = threading.Event()
    answered: dict[int, dict] = {}
    released: dict[int, float] = {}
    errors: list[Exception] = []

    def guard(fn):
        def run(*args):
            try:
                fn(*args)
            except Exception as e:  # re-raised in the main thread once all have stopped
                errors.append(e)
                stop.set()
        return run

    def feeder() -> None:
        for i, d in enumerate(due):
            while (wait := t0 + d - time.perf_counter()) > 0:
                if stop.is_set():
                    return
                time.sleep(min(wait, POLL_S))
            released[i] = time.perf_counter()
            call_q.put(i)

    def tokenizer() -> None:
        while True:
            try:
                i = call_q.get(timeout=POLL_S)
            except queue.Empty:
                if stop.is_set():
                    return
                continue
            with spans.span("tokenize"):
                ids, _ = tok.encode_batch(calls[i], max_seq_length=t["max_seq_length"])
            tok_q.put((i, ids))

    def dispatcher() -> None:
        try:
            while True:
                try:
                    i, ids = tok_q.get(timeout=POLL_S)
                except queue.Empty:
                    if stop.is_set():
                        return
                    continue
                with spans.span("dispatch"):
                    packed, k = fused.topk_device(ids, None, t["top_k"])
                disp_q.put((i, ids, packed, k))
        finally:
            for _ in range(n_read):
                disp_q.put(None)

    def reader() -> None:
        while (item := disp_q.get()) is not None:
            i, ids, packed, k = item
            with spans.span("unpack"):
                scores, top = fused.unpack(packed.cpu().numpy(), k)
            answered[i] = {"t": time.perf_counter(), "ids": ids, "n": len(calls[i]),
                           "scores": scores, "top": top}

    threads = [threading.Thread(target=guard(feeder))]
    threads += [threading.Thread(target=guard(tokenizer)) for _ in range(n_tok)]
    threads.append(threading.Thread(target=guard(dispatcher)))
    threads += [threading.Thread(target=guard(reader)) for _ in range(n_read)]
    t0 = time.perf_counter()
    t_close = t0 + ctx.seconds
    for th in threads:
        th.start()
    deadline = t_close + t["grace_s"]
    while len(answered) < len(due) and time.perf_counter() < deadline and not stop.is_set():
        time.sleep(POLL_S)
    # Everything a later stage still holds is drained before the readers stop.
    stop.set()
    for th in threads:
        th.join()
    if errors:
        raise errors[0]

    lat = latencies_ms(due, t0, {i: a["t"] for i, a in answered.items()}, deadline)
    done = []
    for i, x in enumerate(lat):
        if x >= MISSING_MS:
            continue
        a = answered[i]
        a["record"] = serving.batch_record(a["ids"], a["n"], st["pad"])
        a["texts"] = calls[i][: len(a["top"])]
        a["done_in_window"] = a["t"] <= t_close
        done.append(a)
    failed = sum(t["call"] for x in lat if x >= MISSING_MS)
    failed += sum(a["n"] - len(a["top"]) for a in done)
    late = max((released[i] - (t0 + d) for i, d in enumerate(due) if i in released), default=0.0)
    serving.log(f"{len(due)} calls due in {ctx.seconds} s ({len(due) / ctx.seconds:.2f}/s); "
                f"{len(done)} answered, {failed} queries not; p50 {np.median(lat):.2f} ms, "
                f"p95 {p95(lat):.2f} ms, max {max(lat):.2f} ms; feeder at most "
                f"{late * 1e3:.2f} ms late")
    records = {
        "batches": [a["record"] for a in done if a["done_in_window"]],
        "all_batches": [a["record"] for a in done],
        "window_s": ctx.seconds,
        "encode_s": st["encode_s"],
        "n_catalog": len(st["catalog"]),
        "tokenize_s": spans.durations("tokenize", t0, t_close),
        "answered": done,
        "latencies_ms": lat,
    }
    return Window(end_to_end={"serve_p95_ms": p95(lat)}, records=records,
                  attempted=len(due) * t["call"], failed=failed,
                  seconds=ctx.seconds)


def judge(ctx, st, win) -> dict:
    sample = serving.sample_batches(win.records.pop("answered"), ctx.traffic["sample_batches"],
                                    ctx.seed)
    return serving.judge(ctx, st, sample)
