"""A closed loop: the staged batch serve from text, pass after pass.

The queries, sorted by length, go in batches of ``batch`` through the
program's staged serve: ``tokenizers`` threads tokenize batches (the port's
``WordPieceTokenizer.encode_batch``) into a queue of at most ``queue``
batches, one dispatcher launches each batch's fused encode and top-k
(``FusedServePipeline.topk_device``), and ``readers`` threads bring each
packed result to the host and ``unpack`` it. Passes repeat until the window
closes. ``serve_qps`` counts every query whose ids reached the host inside
the window, over the window's seconds.
"""

from __future__ import annotations

import queue
import threading
import time

from benchmark.drivers import serving

POLL_S = 0.05


def served_inside(answered: dict, t_end: float) -> tuple[list[int], int]:
    """The batches whose ids reached the host by ``t_end``, and their
    answered queries: what ``serve_qps`` counts."""
    inside = sorted(g for g, a in answered.items() if a["t"] <= t_end)
    return inside, sum(len(answered[g]["top"]) for g in inside)


def setup(ctx) -> dict:
    st = serving.setup(ctx)
    t = ctx.traffic
    st["queries"] = sorted(st["queries"], key=len)
    b = t["batch"]
    st["batches"] = [st["queries"][lo : lo + b] for lo in range(0, len(st["queries"]), b)]
    serving.warm(ctx, st, st["batches"], b)
    return st


def window(ctx, st):
    from benchmark.harness import Window

    t, spans = ctx.traffic, ctx.spans
    tok, fused = st["tok"], st["fused"]
    batches, nb = st["batches"], len(st["batches"])
    n_tok, n_read = t["tokenizers"], t["readers"]
    tok_q: queue.Queue = queue.Queue(maxsize=t["queue"])
    disp_q: queue.Queue = queue.Queue()
    stop = threading.Event()
    answered: dict[int, dict] = {}
    errors: list[Exception] = []
    tok_alive = [n_tok]
    alive_lock = threading.Lock()

    def guard(fn):
        def run(*args):
            try:
                fn(*args)
            except Exception as e:  # re-raised in the main thread once all have stopped
                errors.append(e)
                stop.set()
        return run

    def tokenizer(first: int) -> None:
        try:
            g = first
            while not stop.is_set():
                texts = batches[g % nb]
                with spans.span("tokenize"):
                    ids, _ = tok.encode_batch(texts, max_seq_length=t["max_seq_length"],
                                              pad_batch_to=t["batch"])
                while True:
                    try:
                        tok_q.put((g, ids, len(texts)), timeout=POLL_S)
                        break
                    except queue.Full:
                        if stop.is_set():
                            return
                g += n_tok
        finally:
            with alive_lock:
                tok_alive[0] -= 1

    def dispatcher() -> None:
        try:
            while True:
                try:
                    g, ids, n = tok_q.get(timeout=POLL_S)
                except queue.Empty:
                    with alive_lock:
                        if tok_alive[0] == 0:
                            return
                    continue
                with spans.span("dispatch"):
                    packed, k = fused.topk_device(ids, None, t["top_k"])
                disp_q.put((g, ids, n, packed, k))
        finally:
            for _ in range(n_read):
                disp_q.put(None)

    def reader() -> None:
        while (item := disp_q.get()) is not None:
            g, ids, n, packed, k = item
            with spans.span("unpack"):
                scores, top = fused.unpack(packed.cpu().numpy(), k)
            answered[g] = {"t": time.perf_counter(), "ids": ids, "n": n,
                           "scores": scores[:n], "top": top[:n]}

    threads = [threading.Thread(target=guard(tokenizer), args=(i,)) for i in range(n_tok)]
    threads.append(threading.Thread(target=guard(dispatcher)))
    threads += [threading.Thread(target=guard(reader)) for _ in range(n_read)]
    t0 = time.perf_counter()
    t_end = t0 + ctx.seconds
    for th in threads:
        th.start()
    while time.perf_counter() < t_end and not stop.is_set():
        time.sleep(min(POLL_S, max(0.0, t_end - time.perf_counter())))
    stop.set()
    for th in threads:
        th.join()
    if errors:
        raise errors[0]

    for g, a in answered.items():
        a["record"] = serving.batch_record(a["ids"], a["n"], st["pad"])
        a["texts"] = batches[g % nb][: len(a["top"])]
    inside, served = served_inside(answered, t_end)
    done = [answered[g] for g in inside]
    records = {
        "batches": [a["record"] for a in done],
        "all_batches": [a["record"] for a in answered.values()],
        "window_s": ctx.seconds,
        "encode_s": st["encode_s"],
        "n_catalog": len(st["catalog"]),
        "tokenize_s": spans.durations("tokenize", t0, t_end),
        "answered": done,
    }
    attempted = sum(a["n"] for a in answered.values())
    failed = attempted - sum(len(a["top"]) for a in answered.values())
    serving.log(f"served {served} queries in {len(inside)} batches inside "
                f"{ctx.seconds} s; {len(answered)} batches answered in all")
    return Window(end_to_end={"serve_qps": served / ctx.seconds}, records=records,
                  attempted=attempted, failed=failed, seconds=ctx.seconds)


def judge(ctx, st, win) -> dict:
    sample = serving.sample_batches(win.records.pop("answered"), ctx.traffic["sample_batches"],
                                    ctx.seed)
    return serving.judge(ctx, st, sample)
