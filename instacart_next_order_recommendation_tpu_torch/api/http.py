"""Minimal HTTP framework (stdlib http.server) for the recommendation API.

The port's copy of the JAX package's ``api/http.py``: routing, JSON request
and response handling, middleware (request logging, rate limiting),
FastAPI-compatible error shapes (400/401/422/429 + ``{"detail": ...}``), on
the Python standard library, with a sans-IO core: ``App.handle()`` processes
a request tuple without sockets, so tests drive the full middleware and route
stack in-process (the analog of FastAPI's TestClient).
"""

from __future__ import annotations

import json
import logging
import os
import socket
import threading
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Optional
from urllib.parse import parse_qsl

logger = logging.getLogger(__name__)


class ApiError(Exception):
    """HTTP error with status code and detail payload (FastAPI-compatible)."""

    def __init__(self, status_code: int, detail: Any):
        super().__init__(detail)
        self.status_code = status_code
        self.detail = detail


@dataclass
class Request:
    method: str
    path: str
    headers: dict[str, str]
    body: bytes = b""
    client_ip: str = "127.0.0.1"
    state: dict = field(default_factory=dict)
    # Parsed query-string parameters (last value wins for duplicate keys,
    # the dict(parse_qsl(...)) semantics). The routes are body-driven; the
    # server parses the query string off the request target instead of
    # silently dropping it.
    query: dict[str, str] = field(default_factory=dict)

    def json(self) -> Any:
        if not self.body:
            raise ApiError(422, [{"msg": "Request body required", "type": "missing"}])
        try:
            return json.loads(self.body)
        except json.JSONDecodeError as exc:
            raise ApiError(422, [{"msg": f"Invalid JSON: {exc}", "type": "json_invalid"}])

    def header(self, name: str, default: str | None = None) -> str | None:
        return self.headers.get(name.lower(), default)


@dataclass
class Response:
    status_code: int = 200
    content: Any = None
    headers: dict[str, str] = field(default_factory=dict)
    media_type: str = "application/json"

    def body_bytes(self) -> bytes:
        if isinstance(self.content, bytes):
            return self.content
        if isinstance(self.content, str):
            return self.content.encode()
        return json.dumps(self.content).encode()

    def json(self) -> Any:
        return json.loads(self.body_bytes())


Handler = Callable[[Request], Response]
Middleware = Callable[[Request, Handler], Response]


class App:
    """Route table + middleware chain + shared state."""

    def __init__(self, title: str = ""):
        self.title = title
        self.routes: dict[tuple[str, str], Handler] = {}
        self.middleware: list[Middleware] = []
        # Header-only pre-checks the socket server runs BEFORE reading the
        # request body (request.body is empty at that point). A check returns
        # a Response to reject immediately — used by the rate limiter so an
        # over-limit client cannot make the server buffer its payload.
        self.early_checks: list[Callable[[Request], Optional[Response]]] = []
        self.state: dict[str, Any] = {}
        self.on_startup: list[Callable[[App], None]] = []
        self.on_shutdown: list[Callable[[App], None]] = []
        self._started = False
        self._lock = threading.Lock()

    # -------------------------------------------------------------- registration

    def route(self, method: str, path: str):
        def deco(fn: Handler) -> Handler:
            self.routes[(method.upper(), path)] = fn
            return fn

        return deco

    def get(self, path: str):
        return self.route("GET", path)

    def post(self, path: str):
        return self.route("POST", path)

    def add_middleware(self, mw: Middleware) -> None:
        self.middleware.append(mw)

    # -------------------------------------------------------------- lifecycle

    def startup(self) -> None:
        with self._lock:
            if self._started:
                return
            for fn in self.on_startup:
                fn(self)
            self._started = True

    def shutdown(self) -> None:
        with self._lock:
            if not self._started:
                return
            for fn in self.on_shutdown:
                fn(self)
            self._started = False

    # -------------------------------------------------------------- dispatch

    def handle(self, request: Request) -> Response:
        def terminal(req: Request) -> Response:
            handler = self.routes.get((req.method, req.path))
            if handler is None:
                if any(p == req.path for (_, p) in self.routes):
                    return Response(405, {"detail": "Method Not Allowed"})
                return Response(404, {"detail": "Not Found"})
            # Resolve expected errors (401/400/422/...) INSIDE the terminal
            # handler, below the middleware chain, the way FastAPI resolves
            # HTTPException under its middleware: the request-logging
            # middleware then sees an ordinary 4xx response — it stamps
            # X-Request-ID on it and logs an access line instead of an
            # ERROR-level stack trace for routine client errors.
            try:
                return handler(req)
            except ApiError as exc:
                return Response(exc.status_code, {"detail": exc.detail})

        chain: Handler = terminal
        for mw in reversed(self.middleware):
            chain = _bind(mw, chain)

        try:
            return chain(request)
        except ApiError as exc:
            # A middleware itself rejected the request (e.g. rate limit).
            return Response(exc.status_code, {"detail": exc.detail})
        except Exception:
            logger.exception("Unhandled error on %s %s", request.method, request.path)
            return Response(500, {"detail": "Internal Server Error"})

    def check_early(self, request: Request) -> Optional[Response]:
        """Run the header-only pre-checks; first rejection wins."""
        for check in self.early_checks:
            resp = check(request)
            if resp is not None:
                return resp
        return None


def _bind(mw: Middleware, nxt: Handler) -> Handler:
    def bound(req: Request) -> Response:
        try:
            return mw(req, nxt)
        except ApiError as exc:
            # Convert at the raising layer so outer middleware (request
            # logging) sees a plain status response, not an exception.
            return Response(exc.status_code, {"detail": exc.detail})

    return bound


class TestClient:
    """In-process client driving the full middleware/route stack."""

    __test__ = False  # not a pytest test class

    def __init__(self, app: App, client_ip: str = "127.0.0.1"):
        self.app = app
        self.client_ip = client_ip
        self.app.startup()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.app.shutdown()

    def request(
        self,
        method: str,
        path: str,
        json_body: Any = None,
        headers: Optional[dict[str, str]] = None,
    ) -> Response:
        body = b"" if json_body is None else json.dumps(json_body).encode()
        hdrs = {k.lower(): v for k, v in (headers or {}).items()}
        if json_body is not None:
            hdrs.setdefault("content-type", "application/json")
        # Mirror the socket server: the query string is split off the path
        # (so routing matches) and parsed into Request.query.
        path, _, query_string = path.partition("?")
        query = dict(parse_qsl(query_string)) if query_string else {}
        req = Request(method.upper(), path, hdrs, body, self.client_ip, query=query)
        return self.app.handle(req)

    def get(self, path: str, **kw) -> Response:
        return self.request("GET", path, **kw)

    def post(self, path: str, json: Any = None, **kw) -> Response:
        return self.request("POST", path, json_body=json, **kw)


class BoundedThreadingHTTPServer(ThreadingHTTPServer):
    """ThreadingHTTPServer with a hard cap on concurrently-handled
    connections.

    The stdlib ThreadingHTTPServer is thread-per-connection with no bound,
    so a connection flood spawns unbounded threads. This subclass gates
    `process_request` on a NON-BLOCKING semaphore acquire (it runs in the
    accept loop — any wait there head-of-line-blocks every later
    connection): when all worker slots are taken, the excess connection gets
    an immediate `503 Service Unavailable` and is closed instead of queuing
    forever.

    The unit of admission is the CONNECTION (matching the thread-per-
    connection model): an idle keep-alive connection holds its slot until
    the socket timeout reaps it. To keep pooled keep-alive clients from
    pinning the server near its cap, handlers mark responses
    `Connection: close` while free slots are scarce (``nearly_saturated``)
    so slots recycle under pressure.
    """

    daemon_threads = True
    # The listen backlog: the kernel's largest. socketserver's default of 5
    # resets a burst of new connections that arrives while the accept loop
    # waits for the interpreter lock, before it can answer them (or 503 the
    # excess).
    request_queue_size = socket.SOMAXCONN

    def __init__(self, addr, handler_cls, max_concurrency: int = 64):
        self._slots = threading.BoundedSemaphore(max_concurrency)
        self._max_concurrency = max_concurrency
        self._active = 0
        self._active_lock = threading.Lock()
        super().__init__(addr, handler_cls)

    def nearly_saturated(self) -> bool:
        """True when <=25% of worker slots remain free."""
        with self._active_lock:
            return (self._max_concurrency - self._active) <= max(
                1, self._max_concurrency // 4
            )

    def process_request(self, request, client_address):
        if not self._slots.acquire(blocking=False):
            try:
                request.sendall(
                    b"HTTP/1.1 503 Service Unavailable\r\n"
                    b"Content-Type: application/json\r\n"
                    b"Content-Length: 31\r\n"
                    b"Connection: close\r\n\r\n"
                    b'{"detail": "Server overloaded"}'
                )
            except OSError:
                pass
            self.shutdown_request(request)
            return
        with self._active_lock:
            self._active += 1
        try:
            super().process_request(request, client_address)
        except BaseException:
            self._release_slot()
            raise

    def _release_slot(self) -> None:
        with self._active_lock:
            self._active -= 1
        self._slots.release()

    def process_request_thread(self, request, client_address):
        try:
            super().process_request_thread(request, client_address)
        finally:
            self._release_slot()


def make_server(
    app: App,
    host: str = "0.0.0.0",
    port: int = 8000,
    max_concurrency: int | None = None,
    socket_timeout: float | None = None,
    max_body_bytes: int | None = None,
) -> BoundedThreadingHTTPServer:
    """Build the bounded HTTP server (started; caller runs serve_forever).

    Bounds (overridable per-call or via env; see constants.py):
    `HTTP_MAX_CONCURRENCY` concurrent connections (excess → fast 503),
    `HTTP_SOCKET_TIMEOUT` seconds of per-connection socket inactivity
    (slow clients can't pin a worker), `HTTP_MAX_BODY_BYTES` request-body
    cap (oversize → 413 before the body is read). Rate-limit rejection also
    happens before the body read, via `App.early_checks`.
    """
    from instacart_next_order_recommendation_tpu_torch.constants import (
        DEFAULT_HTTP_MAX_BODY_BYTES,
        DEFAULT_HTTP_MAX_CONCURRENCY,
        DEFAULT_HTTP_SOCKET_TIMEOUT,
        ENV_HTTP_MAX_BODY_BYTES,
        ENV_HTTP_MAX_CONCURRENCY,
        ENV_HTTP_SOCKET_TIMEOUT,
    )

    def _env_num(name: str, default, cast):
        raw = os.getenv(name)
        if raw is None or not raw.strip():
            return default
        try:
            return cast(raw)
        except ValueError:
            logger.warning("Invalid %s=%r; using %s", name, raw, default)
            return default

    if max_concurrency is None:
        max_concurrency = _env_num(ENV_HTTP_MAX_CONCURRENCY, DEFAULT_HTTP_MAX_CONCURRENCY, int)
    if socket_timeout is None:
        socket_timeout = _env_num(ENV_HTTP_SOCKET_TIMEOUT, DEFAULT_HTTP_SOCKET_TIMEOUT, float)
    if max_body_bytes is None:
        max_body_bytes = _env_num(ENV_HTTP_MAX_BODY_BYTES, DEFAULT_HTTP_MAX_BODY_BYTES, int)

    app.startup()

    class _Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"
        # TCP_NODELAY: a response goes out in two writes (headers, body).
        # Under Nagle's algorithm the body waits for the client's ACK of the
        # headers, which a keep-alive client delays (40 ms on Linux): every
        # request after a connection's first would pay it.
        disable_nagle_algorithm = True
        # socketserver honors this in setup(): connection.settimeout(timeout).
        # A stalled read (slow/idle client) raises socket.timeout, which
        # handle_one_request turns into close_connection.
        timeout = socket_timeout

        def _send(self, resp: Response) -> None:
            payload = resp.body_bytes()
            self.send_response(resp.status_code)
            self.send_header("Content-Type", resp.media_type)
            self.send_header("Content-Length", str(len(payload)))
            for k, v in resp.headers.items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(payload)

        def _dispatch(self, method: str) -> None:
            path, _, query_string = self.path.partition("?")
            headers = {k.lower(): v for k, v in self.headers.items()}
            query = dict(parse_qsl(query_string)) if query_string else {}
            req = Request(method, path, headers, b"", self.client_address[0], query=query)

            try:
                length = int(self.headers.get("Content-Length") or 0)
            except ValueError:
                length = -1
            # Header-only rejections happen BEFORE the body read: the
            # server never buffers payloads from over-limit or oversize
            # requests. A negative/garbage Content-Length is rejected too —
            # rfile.read(-1) would read until EOF, an unbounded buffer the
            # size cap exists to prevent. The unread body makes the
            # connection unusable for keep-alive, so close it.
            early = None
            if length < 0:
                early = Response(400, {"detail": "Invalid Content-Length"})
            elif length > max_body_bytes:
                early = Response(413, {"detail": f"Request body too large (max {max_body_bytes} bytes)"})
            else:
                early = app.check_early(req)
            if early is not None:
                early.headers.setdefault("Connection", "close")
                self.close_connection = True
                self._send(early)
                return

            try:
                req.body = self.rfile.read(length) if length else b""
            except socket.timeout:
                self.close_connection = True
                return
            resp = app.handle(req)
            # Recycle keep-alive slots under pressure: the admission unit
            # is the connection, so pooled idle keep-alives near the cap
            # would otherwise 503 new clients while zero requests are in
            # flight.
            if self.server.nearly_saturated():
                resp.headers.setdefault("Connection", "close")
                self.close_connection = True
            self._send(resp)

        def do_GET(self):
            self._dispatch("GET")

        def do_POST(self):
            self._dispatch("POST")

        def log_message(self, fmt, *args):  # route through logging, not stderr
            logger.debug("%s - %s", self.address_string(), fmt % args)

    server = BoundedThreadingHTTPServer((host, port), _Handler, max_concurrency=max_concurrency)
    logger.info(
        "Serving %s on %s:%d (max_concurrency=%d, socket_timeout=%.1fs, max_body=%d)",
        app.title, host, server.server_address[1], max_concurrency, socket_timeout, max_body_bytes,
    )
    return server


def serve(
    app: App,
    host: str = "0.0.0.0",
    port: int = 8000,
    max_concurrency: int | None = None,
    socket_timeout: float | None = None,
    max_body_bytes: int | None = None,
) -> None:
    """Run the app on a bounded threading HTTP server (blocks). See
    `make_server` for the bound semantics and env knobs."""
    server = make_server(app, host, port, max_concurrency, socket_timeout, max_body_bytes)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        app.shutdown()
        server.server_close()
