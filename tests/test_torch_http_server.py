"""Socket-level tests of the port's bounded stdlib HTTP server
(``api/http.py``), every case of ``tests/test_http_server.py``: query
parameters, oversize bodies refused before the read (413), bad
Content-Length, ``Connection: close`` near saturation, idle and stalled
sockets reaped, fast 503s past the connection cap, and rate-limit rejection
before the body read (429). Then the interchange with the JAX package: a
feedback DB written by either server is read by the other, and every
constant both packages define has one value.
"""

from __future__ import annotations

import http.client
import socket
import sqlite3
import threading
import time

import pytest

from instacart_next_order_recommendation_tpu import constants as jax_constants
from instacart_next_order_recommendation_tpu.api import feedback_store as jax_store
from instacart_next_order_recommendation_tpu_torch import constants as port_constants
from instacart_next_order_recommendation_tpu_torch.api import feedback_store as port_store
from instacart_next_order_recommendation_tpu_torch.api.http import (
    App,
    Request,
    Response,
    make_server,
)


def _start(app: App, **kw):
    server = make_server(app, host="127.0.0.1", port=0, **kw)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return server, server.server_address[1]


def _stop(server):
    server.shutdown()
    server.server_close()


def _mini_app() -> App:
    app = App(title="test")

    @app.get("/health")
    def health(req: Request) -> Response:
        return Response(200, {"status": "ok"})

    @app.post("/echo")
    def echo(req: Request) -> Response:
        return Response(200, {"len": len(req.body), "query": req.query})

    @app.get("/query")
    def query(req: Request) -> Response:
        return Response(200, req.query)

    return app


def _get(port: int, path: str, timeout: float = 5.0):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


class TestQueryString:
    def test_query_params_parsed_and_routing_ignores_them(self):
        server, port = _start(_mini_app())
        try:
            status, body = _get(port, "/query?a=1&b=two%20words")
            assert status == 200
            import json

            assert json.loads(body) == {"a": "1", "b": "two words"}
            # Query string must not break route matching.
            status, _ = _get(port, "/health?probe=1")
            assert status == 200
        finally:
            _stop(server)


class TestBodyCap:
    def test_oversize_body_rejected_before_read(self):
        server, port = _start(_mini_app(), max_body_bytes=100)
        try:
            # Declare a large body but never send it: the 413 must arrive
            # anyway, proving the server responds from headers alone.
            sock = socket.create_connection(("127.0.0.1", port), timeout=5)
            sock.sendall(
                b"POST /echo HTTP/1.1\r\nHost: x\r\n"
                b"Content-Type: application/json\r\nContent-Length: 100000\r\n\r\n"
            )
            resp = http.client.HTTPResponse(sock)
            resp.begin()
            assert resp.status == 413
            assert b"too large" in resp.read()
            sock.close()
        finally:
            _stop(server)

    def test_body_at_cap_accepted(self):
        server, port = _start(_mini_app(), max_body_bytes=100)
        try:
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=5)
            conn.request("POST", "/echo", body=b"x" * 100)
            resp = conn.getresponse()
            assert resp.status == 200
            conn.close()
        finally:
            _stop(server)


class TestInvalidContentLength:
    def test_negative_content_length_rejected(self):
        """A negative Content-Length must get 400 without any body read —
        rfile.read(-1) would read until EOF, defeating the size cap."""
        server, port = _start(_mini_app(), max_body_bytes=100)
        try:
            sock = socket.create_connection(("127.0.0.1", port), timeout=5)
            sock.sendall(
                b"POST /echo HTTP/1.1\r\nHost: x\r\nContent-Length: -1\r\n\r\n"
            )
            resp = http.client.HTTPResponse(sock)
            resp.begin()
            assert resp.status == 400
            sock.close()
            status, _ = _get(port, "/health")
            assert status == 200
        finally:
            _stop(server)

    def test_garbage_content_length_rejected(self):
        server, port = _start(_mini_app())
        try:
            sock = socket.create_connection(("127.0.0.1", port), timeout=5)
            sock.sendall(
                b"POST /echo HTTP/1.1\r\nHost: x\r\nContent-Length: banana\r\n\r\n"
            )
            resp = http.client.HTTPResponse(sock)
            resp.begin()
            assert resp.status == 400
            sock.close()
        finally:
            _stop(server)


class TestKeepAliveRecycling:
    def test_connection_close_when_nearly_saturated(self):
        """Near the connection cap, responses carry Connection: close so
        pooled idle keep-alives can't pin the server at saturation."""
        server, port = _start(_mini_app(), max_concurrency=2)
        try:
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=5)
            conn.request("GET", "/health")
            resp = conn.getresponse()
            assert resp.status == 200
            # 1 of 2 slots held -> free (1) <= max(1, 2//4) -> saturated.
            assert resp.getheader("Connection") == "close"
            conn.close()
        finally:
            _stop(server)

    def test_keep_alive_preserved_when_unsaturated(self):
        server, port = _start(_mini_app(), max_concurrency=64)
        try:
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=5)
            conn.request("GET", "/health")
            resp = conn.getresponse()
            resp.read()
            assert resp.getheader("Connection") != "close"
            # Connection is reusable.
            conn.request("GET", "/health")
            assert conn.getresponse().status == 200
            conn.close()
        finally:
            _stop(server)


class TestSlowClient:
    def test_idle_connection_times_out_and_server_stays_healthy(self):
        server, port = _start(_mini_app(), socket_timeout=0.5)
        try:
            sock = socket.create_connection(("127.0.0.1", port), timeout=5)
            # Send a partial request line, then stall. The server must drop
            # the connection after its socket timeout rather than waiting
            # forever on the incomplete request.
            sock.sendall(b"GET /heal")
            sock.settimeout(5)
            deadline = time.monotonic() + 4
            closed = False
            while time.monotonic() < deadline:
                try:
                    if sock.recv(1024) == b"":
                        closed = True
                        break
                except socket.timeout:
                    break
            assert closed, "server did not close the stalled connection"
            sock.close()
            status, _ = _get(port, "/health")
            assert status == 200
        finally:
            _stop(server)

    def test_stalled_body_read_closes_connection(self):
        server, port = _start(_mini_app(), socket_timeout=0.5)
        try:
            sock = socket.create_connection(("127.0.0.1", port), timeout=5)
            # Complete headers, but only half the promised body.
            sock.sendall(
                b"POST /echo HTTP/1.1\r\nHost: x\r\nContent-Length: 50\r\n\r\n"
                + b"y" * 10
            )
            sock.settimeout(5)
            data = b"x"
            deadline = time.monotonic() + 4
            while time.monotonic() < deadline:
                try:
                    data = sock.recv(1024)
                    if data == b"":
                        break
                except socket.timeout:
                    break
            assert data == b"", "server did not close on stalled body read"
            sock.close()
            status, _ = _get(port, "/health")
            assert status == 200
        finally:
            _stop(server)


class TestConcurrencyBound:
    def test_flood_gets_fast_503(self):
        server, port = _start(_mini_app(), max_concurrency=2, socket_timeout=5.0)
        try:
            # Occupy both worker slots with idle connections (each holds a
            # handler thread blocked reading the request line).
            holders = [
                socket.create_connection(("127.0.0.1", port), timeout=5)
                for _ in range(2)
            ]
            time.sleep(0.2)  # let both handlers claim their slots
            sock = socket.create_connection(("127.0.0.1", port), timeout=5)
            sock.sendall(b"GET /health HTTP/1.1\r\nHost: x\r\n\r\n")
            resp = http.client.HTTPResponse(sock)
            resp.begin()
            assert resp.status == 503
            assert b"overloaded" in resp.read()
            sock.close()
            for h in holders:
                h.close()
            # Slots must be released once holders disconnect.
            time.sleep(0.3)
            status, _ = _get(port, "/health")
            assert status == 200
        finally:
            _stop(server)


class TestConnectionHandling:
    """Two departures from the JAX server, each a fault of it that costs
    clients time or connections; both pinned on the JAX side by its
    settings."""

    def test_keep_alive_requests_do_not_wait_for_delayed_acks(self):
        """A response goes out in two writes (headers, body). Under Nagle's
        algorithm the body waits for the client's ACK of the headers, which
        a keep-alive client delays (40 ms on Linux), so every request after
        a connection's first pays it. The port's handler sets TCP_NODELAY;
        the JAX one does not."""
        from instacart_next_order_recommendation_tpu.api import http as jax_http

        server, port = _start(_mini_app())
        jax_server = jax_http.make_server(jax_http.App(), host="127.0.0.1", port=0)
        try:
            assert server.RequestHandlerClass.disable_nagle_algorithm is True
            assert jax_server.RequestHandlerClass.disable_nagle_algorithm is False
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=5)
            ms = []
            for _ in range(12):
                t0 = time.perf_counter()
                conn.request("POST", "/echo", body=b'{"a": 1}')
                resp = conn.getresponse()
                resp.read()
                assert resp.status == 200
                ms.append((time.perf_counter() - t0) * 1e3)
            conn.close()
            # A delayed ACK costs 40 ms or more a request.
            assert sorted(ms[1:])[len(ms) // 2] < 30.0, ms
        finally:
            _stop(server)
            jax_server.server_close()

    def test_connection_burst_waits_in_the_listen_backlog(self):
        """64 connections that arrive while the accept loop is not yet
        running all get answered: the listen backlog is the kernel's
        largest. The JAX server keeps socketserver's backlog of 5: there the
        seventh connect of this burst times out, and 64 concurrent clients
        of a handler that holds the interpreter lock see connections reset."""
        from instacart_next_order_recommendation_tpu.api import http as jax_http

        assert jax_http.BoundedThreadingHTTPServer.request_queue_size == 5
        server = make_server(_mini_app(), host="127.0.0.1", port=0, max_concurrency=128)
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        socks = []
        try:
            assert server.request_queue_size == socket.SOMAXCONN >= 64
            port = server.server_address[1]
            for _ in range(64):
                sock = socket.create_connection(("127.0.0.1", port), timeout=10)
                sock.sendall(b"GET /health HTTP/1.1\r\nHost: x\r\nConnection: close\r\n\r\n")
                socks.append(sock)
            thread.start()
            for sock in socks:
                resp = http.client.HTTPResponse(sock)
                resp.begin()
                assert resp.status == 200
                resp.read()
        finally:
            for sock in socks:
                sock.close()
            if thread.is_alive():
                server.shutdown()
            server.server_close()


class TestRateLimitBeforeBody:
    def test_over_limit_rejected_without_body(self):
        from instacart_next_order_recommendation_tpu_torch.api.limiter import RateLimiter

        app = _mini_app()
        limiter = RateLimiter("1/minute")
        app.add_middleware(limiter.middleware)
        app.early_checks.append(limiter.early_check)
        server, port = _start(app)
        try:
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=5)
            conn.request("POST", "/echo", body=b"ok")
            assert conn.getresponse().status == 200
            conn.close()
            # Second request is over limit; declare a body and never send
            # it — the 429 must arrive from headers alone.
            sock = socket.create_connection(("127.0.0.1", port), timeout=5)
            sock.sendall(
                b"POST /echo HTTP/1.1\r\nHost: x\r\nContent-Length: 100000\r\n\r\n"
            )
            resp = http.client.HTTPResponse(sock)
            resp.begin()
            assert resp.status == 429
            sock.close()
        finally:
            _stop(server)

    def test_early_check_does_not_consume_budget(self):
        from instacart_next_order_recommendation_tpu_torch.api.limiter import RateLimiter

        limiter = RateLimiter("2/minute")
        req = Request("POST", "/echo", {}, client_ip="1.2.3.4")
        # Early checks alone never consume budget.
        for _ in range(5):
            assert limiter.early_check(req) is None
        assert limiter.allow("1.2.3.4")
        assert limiter.allow("1.2.3.4")
        assert limiter.early_check(req) is not None
        assert not limiter.allow("1.2.3.4")

    def test_exempt_paths_skip_early_check(self):
        from instacart_next_order_recommendation_tpu_torch.api.limiter import RateLimiter

        limiter = RateLimiter("1/minute")
        assert limiter.allow("9.9.9.9")
        assert limiter.over_limit("9.9.9.9")
        req = Request("GET", "/health", {}, client_ip="9.9.9.9")
        assert limiter.early_check(req) is None


class TestAppWiring:
    def test_create_app_registers_early_check(self, tmp_path, monkeypatch):
        from instacart_next_order_recommendation_tpu_torch.api.app import create_app

        monkeypatch.setenv("FEEDBACK_DB_PATH", str(tmp_path / "feedback.db"))
        app = create_app(load_model_on_startup=False, rate_limit="1/minute")
        assert len(app.early_checks) == 1
        # Exhaust the budget through the middleware path, then the early
        # check (as the socket server would run it) must reject.
        from instacart_next_order_recommendation_tpu_torch.api.http import TestClient

        with TestClient(app, client_ip="7.7.7.7") as client:
            client.post("/feedback", json={"events": []})
            req = Request("POST", "/feedback", {}, client_ip="7.7.7.7")
            early = app.check_early(req)
            assert early is not None and early.status_code == 429


# ------------------------------------------------------------- interchange

STORES = {"port": port_store, "jax": jax_store}


@pytest.mark.parametrize("writer,reader", [("port", "jax"), ("jax", "port")])
def test_feedback_db_read_by_the_other_package(tmp_path, monkeypatch, writer, reader):
    """Feedback events and request contexts written by one package's store
    are joined back by the other's ``load_context_events``, in one schema."""
    db = tmp_path / "feedback.db"
    monkeypatch.setenv("FEEDBACK_DB_PATH", str(db))
    w = STORES[writer]
    w.record_request_context("req-1", "[+7d w4h14] Organic Milk.", "u1")
    w.record_request_context("req-2", "[+3d w1h9] Banana.")
    w.record_event(w.FeedbackEventRecord("req-1", "click", "101", user_id="u1",
                                         metadata={"rank": 1}))
    w.record_events([
        w.FeedbackEventRecord("req-2", "purchase", "202"),
        w.FeedbackEventRecord("req-9", "impression", "303"),  # no context: not joined
    ])
    w.flush_request_contexts()
    got = STORES[reader].load_context_events(db)
    assert sorted(got) == [
        ("click", "[+7d w4h14] Organic Milk.", "101"),
        ("purchase", "[+3d w1h9] Banana.", "202"),
    ]
    # The reader's own writes land in the same tables.
    STORES[reader].init_db()
    STORES[reader].record_event(STORES[reader].FeedbackEventRecord("req-2", "click", "404"))
    assert len(STORES[writer].load_context_events(db)) == 3
    conn = sqlite3.connect(db)
    try:
        schema = sorted(conn.execute("SELECT name, sql FROM sqlite_master").fetchall())
    finally:
        conn.close()
    other = tmp_path / "other.db"
    monkeypatch.setenv("FEEDBACK_DB_PATH", str(other))
    STORES[reader].init_db()
    conn = sqlite3.connect(other)
    try:
        assert sorted(conn.execute("SELECT name, sql FROM sqlite_master").fetchall()) == schema
    finally:
        conn.close()


def test_constants_shared_with_jax_have_one_value():
    shared = [n for n in vars(port_constants) if n.isupper() and n in vars(jax_constants)]
    assert {"ENV_FEEDBACK_DB_PATH", "ENV_HTTP_MAX_BODY_BYTES", "DEFAULT_FEEDBACK_DB_PATH",
            "MAX_CORPUS_UPLOAD_PRODUCTS", "DEFAULT_HTTP_SOCKET_TIMEOUT"} <= set(shared)
    assert {n: getattr(port_constants, n) for n in shared} == {
        n: getattr(jax_constants, n) for n in shared
    }
