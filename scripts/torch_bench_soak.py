"""Tail-latency soak of the port: mixed lone/bursty traffic through the HTTP server.

The port's counterpart of ``scripts/bench_soak.py``. It serves MiniLM-L6 at
full width (random weights from a seeded generator, a WordPiece vocab of
8,000 trained on the serve benchmark's catalog) through the port's
``api.create_app`` with the ``MicroBatcher`` on (``BATCH_WINDOW_MS``), on
``api.http.make_server`` (``max_concurrency``, ``socket_timeout``), and
drives it over local sockets in phases: lone, burst, mixed,
lone_after_burst, then a connection flood followed by a recovery reading.
It reports each phase's p50/p95/p99 and the batcher's window decisions
(``MicroBatcher.decision_counts``, ``drain_sizes``): the evidence that the
adaptive window neither latches into permanent batch-1 drains under load
(``no_batch1_latch``) nor charges lone traffic windows after a burst
(``no_window_latch``), and that the bounded server sheds a flood of idle
connections with fast 503s and serves again once the socket timeout has
reclaimed their slots (``flood_survived``).

The clients speak HTTP/1.1 keep-alive through the standard library, one
connection per client thread.

    python scripts/torch_bench_soak.py [--phase-seconds 20] [--port 8191] [--device cpu]

Prints one JSON line per phase and a final summary JSON.
"""

from __future__ import annotations

# Allow running as `python scripts/<name>.py` from a repo checkout.
import sys as _sys
from pathlib import Path as _Path

_repo_root = str(_Path(__file__).resolve().parents[1])
if _repo_root not in _sys.path:
    _sys.path.insert(0, _repo_root)

import argparse
import dataclasses
import http.client
import json
import os
import socket
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

from instacart_next_order_recommendation_tpu_torch.utils.bench_texts import (
    build_catalog_texts,
    build_query_texts,
)

READY_POLLS = 900  # /ready polls, 0.2 s apart
# A request on a keep-alive connection the server has closed (its socket
# timeout, or Connection: close near saturation) fails before it is read:
# the client reconnects and sends it once more.
STALE = (http.client.RemoteDisconnected, ConnectionResetError, BrokenPipeError)


def build_workspace(base: Path, n_products: int) -> tuple[Path, Path, list[str]]:
    """MiniLM-L6 at full width with an 8,000-word vocab, the catalog as the
    corpus, and 512 queries (no external data)."""
    import torch

    from instacart_next_order_recommendation_tpu_torch.models.checkpoint import save_tower
    from instacart_next_order_recommendation_tpu_torch.models.encoder import (
        MINILM_L6,
        init_params,
    )
    from instacart_next_order_recommendation_tpu_torch.tokenizer import WordPieceTokenizer

    rng = np.random.default_rng(0)
    catalog = build_catalog_texts(n_products, rng)
    queries = build_query_texts(512, catalog, rng)
    corpus = {str(i + 1): t for i, t in enumerate(catalog)}

    # Keyed by catalog size: a reused workdir with a different --products
    # would otherwise serve a stale tower whose vocab mismatches the corpus.
    model_dir = base / f"model_p{n_products}"
    if not (model_dir / "params.msgpack").exists():
        tok = WordPieceTokenizer.train(catalog, vocab_size=8000)
        cfg = dataclasses.replace(MINILM_L6, vocab_size=tok.vocab_size)
        save_tower(model_dir, init_params(cfg, torch.Generator().manual_seed(0)), cfg, tok)
    corpus_path = base / "eval_corpus.json"
    corpus_path.write_text(json.dumps(corpus))
    return model_dir, corpus_path, queries


class Client:
    """One keep-alive HTTP/1.1 connection to the server, reopened when the
    server has closed it."""

    def __init__(self, port: int, timeout: float = 60.0):
        self.port, self.timeout = port, timeout
        self.conn: http.client.HTTPConnection | None = None

    def post(self, path: str, body: dict) -> tuple[int, bytes]:
        payload = json.dumps(body).encode()
        headers = {"Content-Type": "application/json"}
        for attempt in (0, 1):
            reused = self.conn is not None
            if self.conn is None:
                self.conn = http.client.HTTPConnection("127.0.0.1", self.port, timeout=self.timeout)
            try:
                self.conn.request("POST", path, body=payload, headers=headers)
                resp = self.conn.getresponse()
                data = resp.read()
                if resp.will_close:
                    self.close()
                return resp.status, data
            except STALE:
                self.close()
                if attempt or not reused:
                    raise
        raise AssertionError("unreachable")

    def close(self) -> None:
        if self.conn is not None:
            self.conn.close()
            self.conn = None


def recommend_body(queries: list[str], i: int) -> dict:
    return {"user_context": queries[i % len(queries)], "top_k": 10}


def drive_phase(
    port: int,
    queries: list[str],
    seconds: float,
    concurrency: int,
    gap_s: float = 0.0,
) -> list[float]:
    """Fire /recommend requests for ``seconds``; returns latencies (s).

    concurrency=1: a lone sequential client. Otherwise closed-loop bursts of
    ``concurrency`` requests, one connection per client thread, with an
    idle ``gap_s`` between bursts (the mixed phase). Every connection is
    closed when the phase ends."""
    lat: list[float] = []
    lock = threading.Lock()
    stop = time.time() + seconds
    local = threading.local()
    clients: list[Client] = []

    def one(i: int) -> None:
        client = getattr(local, "client", None)
        if client is None:
            client = local.client = Client(port)
            with lock:
                clients.append(client)
        t0 = time.time()
        status, data = client.post("/recommend", recommend_body(queries, i))
        dt = time.time() - t0
        assert status == 200, data[:200]
        with lock:
            lat.append(dt)

    try:
        if concurrency == 1:
            i = 0
            while time.time() < stop:
                one(i)
                i += 1
                if gap_s:
                    time.sleep(gap_s)
            return lat
        with ThreadPoolExecutor(concurrency) as ex:
            i = 0
            while time.time() < stop:
                for f in [ex.submit(one, i + j) for j in range(concurrency)]:
                    f.result()
                i += concurrency
                if gap_s:
                    time.sleep(gap_s)
        return lat
    finally:
        for c in clients:
            c.close()


def drive_flood_phase(port: int, queries: list[str], seconds: float, flood_connections: int) -> dict:
    """Connection-flood phase: open ``flood_connections`` idle sockets (slow
    clients that never send a request), then keep driving legitimate traffic.

    With the bounded server (``api/http.py::BoundedThreadingHTTPServer``) the
    idle sockets saturate the worker slots, excess legitimate requests get a
    fast 503 instead of queuing, and the per-connection socket timeout
    reclaims the flooded slots, after which traffic must succeed again.
    Returns outcome counts and the latency percentiles of successful requests.
    """
    flood: list[socket.socket] = []
    for _ in range(flood_connections):
        try:
            flood.append(socket.create_connection(("127.0.0.1", port), timeout=5))
        except OSError:
            break

    ok_lat: list[float] = []
    n_503 = n_err = 0
    stop = time.time() + seconds
    client = Client(port, timeout=10)
    i = 0
    while time.time() < stop:
        t0 = time.time()
        try:
            status, _ = client.post("/recommend", recommend_body(queries, i))
            if status == 200:
                ok_lat.append(time.time() - t0)
            elif status == 503:
                n_503 += 1
            else:
                n_err += 1
        except (OSError, http.client.HTTPException):
            client.close()
            n_err += 1
        i += 1
        time.sleep(0.05)
    client.close()
    for s in flood:
        try:
            s.close()
        except OSError:
            pass
    return {
        "flood_connections": len(flood),
        "n_ok": len(ok_lat),
        "n_503": n_503,
        "n_err": n_err,
        **{k: v for k, v in pct(ok_lat).items() if k != "n"},
    }


def pct(lat: list[float]) -> dict:
    if not lat:
        return {"n": 0}
    ms = np.asarray(lat) * 1e3
    return {
        "n": len(lat),
        "p50_ms": round(float(np.percentile(ms, 50)), 2),
        "p95_ms": round(float(np.percentile(ms, 95)), 2),
        "p99_ms": round(float(np.percentile(ms, 99)), 2),
    }


def wait_ready(port: int) -> None:
    for _ in range(READY_POLLS):
        try:
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=2)
            conn.request("GET", "/ready")
            ready = json.loads(conn.getresponse().read()).get("status") == "ready"
            conn.close()
            if ready:
                return
        except (OSError, ValueError, http.client.HTTPException):
            pass  # server still starting
        time.sleep(0.2)
    raise RuntimeError(
        f"server did not become ready in {READY_POLLS * 0.2:.0f}s (model load stalled?)"
    )


def run_soak(args, port: int, queries: list[str], batcher) -> dict:
    """The phases, the latch checks and the flood; returns the summary."""
    have_counters = hasattr(batcher, "decision_counts")

    def snapshot() -> dict:
        if not have_counters:
            return {}
        return {
            "decisions": dict(batcher.decision_counts),
            "drains": dict(sorted(batcher.drain_sizes.items())),
        }

    # Brief traffic warm-up: the serve shapes are warm already; this primes
    # the HTTP and batcher path so phase timings start from steady state.
    drive_phase(port, queries, seconds=1.0, concurrency=args.burst_threads)

    phases = [
        # (name, concurrency, gap_s, description)
        ("lone", 1, 0.05, "sequential client, 50 ms think time"),
        ("burst", args.burst_threads, 0.0, "sustained closed-loop bursts"),
        ("mixed", args.burst_threads, 1.2, "bursts separated by >1 s idle gaps"),
        ("lone_after_burst", 1, 0.05, "sequential again: window must disengage"),
    ]
    summary: dict = {
        "metric": "serve_soak",
        "window_ms": args.window_ms,
        "burst_threads": args.burst_threads,
        "phases": {},
    }
    for name, conc, gap, desc in phases:
        before = snapshot()
        lat = drive_phase(port, queries, args.phase_seconds, conc, gap_s=gap)
        after = snapshot()
        delta = {}
        if have_counters:
            delta = {
                "windowed": after["decisions"]["windowed"] - before["decisions"]["windowed"],
                "immediate": after["decisions"]["immediate"] - before["decisions"]["immediate"],
                "coalesced_drains": sum(
                    c - before["drains"].get(s, 0) for s, c in after["drains"].items() if s > 1
                ),
            }
        row = {"desc": desc, **pct(lat), **delta}
        summary["phases"][name] = row
        print(json.dumps({"phase": name, **row}), flush=True)

    # Latch checks: bursts must coalesce; lone traffic after bursts must not
    # pay windows indefinitely.
    burst_row = summary["phases"]["burst"]
    lone_after = summary["phases"]["lone_after_burst"]
    summary["no_batch1_latch"] = bool(burst_row.get("coalesced_drains", 1) > 0)
    if "windowed" in lone_after and lone_after["n"] > 0:
        summary["no_window_latch"] = bool(
            lone_after["windowed"] <= max(3, 0.05 * lone_after["n"])
        )

    # The flood comes after the latch checks, so it cannot perturb them.
    if args.flood_connections > 0:
        flood_row = drive_flood_phase(
            port, queries,
            seconds=max(args.phase_seconds, 3 * args.socket_timeout),
            flood_connections=args.flood_connections,
        )
        recover = pct(drive_phase(port, queries, seconds=min(args.phase_seconds, 10.0),
                                  concurrency=1, gap_s=0.05))
        flood_row["recovered_p50_ms"] = recover.get("p50_ms")
        summary["phases"]["flood"] = flood_row
        # Survival: some requests completed despite the flood, and the
        # sequential phase after it served.
        summary["flood_survived"] = bool(flood_row["n_ok"] > 0 and recover.get("n", 0) > 0)
        print(json.dumps({"phase": "flood", **flood_row}), flush=True)
    return summary


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description="HTTP serve-path tail-latency soak")
    parser.add_argument("--workdir", type=Path, default=Path("torch_soak_workspace"))
    parser.add_argument("--products", type=int, default=5000)
    parser.add_argument("--phase-seconds", type=float, default=20.0)
    parser.add_argument("--burst-threads", type=int, default=16)
    parser.add_argument("--window-ms", type=float, default=4.0)
    parser.add_argument("--port", type=int, default=8191, help="0: any free port")
    parser.add_argument(
        "--flood-connections", type=int, default=96,
        help="idle connections opened in the flood phase (> max-concurrency "
        "saturates the worker slots); 0 skips the phase",
    )
    parser.add_argument("--max-concurrency", type=int, default=64)
    parser.add_argument(
        "--socket-timeout", type=float, default=5.0,
        help="server-side per-connection socket timeout (s); the flood "
        "phase relies on this to reclaim slots held by idle clients",
    )
    parser.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = parser.parse_args(argv)

    from instacart_next_order_recommendation_tpu_torch.device import resolve_device
    from instacart_next_order_recommendation_tpu_torch.utils.logging import (
        setup_colored_logging,
    )

    device = resolve_device(args.device)  # before any work: no card and no --device cpu raises
    setup_colored_logging(
        quiet_loggers=["recommender.metrics", "instacart_next_order_recommendation_tpu_torch.api"]
    )
    args.workdir.mkdir(parents=True, exist_ok=True)
    model_dir, corpus_path, queries = build_workspace(args.workdir, args.products)

    os.environ["FEEDBACK_DB_PATH"] = str(args.workdir / "feedback.db")
    os.environ["BATCH_WINDOW_MS"] = str(args.window_ms)
    # A load test: the production default (100/minute) would answer 429
    # within the first second.
    os.environ.setdefault("RATE_LIMIT", "10000000/minute")
    from instacart_next_order_recommendation_tpu_torch.api import create_app
    from instacart_next_order_recommendation_tpu_torch.api.http import make_server
    from instacart_next_order_recommendation_tpu_torch.serve.precompile import (
        BATCH_BUCKETS,
        warm_serve_shapes,
    )

    app = create_app(model_dir=model_dir, corpus_path=corpus_path, device=device)
    server = make_server(app, "127.0.0.1", args.port, max_concurrency=args.max_concurrency,
                         socket_timeout=args.socket_timeout)
    port = server.server_address[1]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        wait_ready(port)
        batcher = app.state["recommender"]  # a MicroBatcher when BATCH_WINDOW_MS > 0
        # Warm the serve shapes before timing (what PRECOMPILE_ON_STARTUP
        # gives a deployment), so the early phases measure steady state.
        t0 = time.time()
        n_warm = warm_serve_shapes(
            getattr(batcher, "_rec", batcher),
            k_buckets=(16,),  # the soak's top_k=10 rounds up to bucket 16
            batch_buckets=tuple(b for b in BATCH_BUCKETS if b <= max(16, args.burst_threads)),
            with_filters=False,
        )
        print(f"warmed {n_warm} serve shapes in {time.time() - t0:.1f}s",
              file=_sys.stderr, flush=True)
        summary = run_soak(args, port, queries, batcher)
    finally:
        server.shutdown()
        app.shutdown()
        server.server_close()
        thread.join(timeout=10)
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
