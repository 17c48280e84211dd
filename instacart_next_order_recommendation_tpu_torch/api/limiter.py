"""Per-IP rate limiting middleware (sliding window).

The port's copy of the JAX package's ``api/limiter.py``: the default limit
comes from the ``RATE_LIMIT`` env var ("100/minute" format), keyed by remote
address; probe, metrics and admin paths are exempt.
"""

from __future__ import annotations

import os
import threading
import time
from collections import defaultdict, deque

from instacart_next_order_recommendation_tpu_torch.api.http import Request, Response
from instacart_next_order_recommendation_tpu_torch.constants import ENV_RATE_LIMIT

_PERIODS = {"second": 1.0, "minute": 60.0, "hour": 3600.0, "day": 86400.0}

EXEMPT_PATHS = {"/health", "/ready", "/metrics", "/admin/corpus", "/admin/model"}


def parse_rate(rate: str) -> tuple[int, float]:
    """Parse "100/minute" -> (100, 60.0); malformed input falls back to the
    default instead of failing service startup on a bad RATE_LIMIT env var."""
    count_s, _, period_s = rate.partition("/")
    period = _PERIODS.get(period_s.strip().rstrip("s"), 60.0)
    try:
        return int(count_s.strip()), period
    except ValueError:
        import logging

        logging.getLogger(__name__).warning(
            "Malformed rate limit %r; using 100/minute", rate
        )
        return 100, 60.0


class RateLimiter:
    """Sliding-window counter per client IP."""

    def __init__(self, rate: str | None = None):
        rate = rate or os.getenv(ENV_RATE_LIMIT, "100/minute")
        self.limit, self.period = parse_rate(rate)
        self._events: dict[str, deque[float]] = defaultdict(deque)
        self._lock = threading.Lock()

    def allow(self, key: str) -> bool:
        now = time.monotonic()
        with self._lock:
            window = self._events[key]
            cutoff = now - self.period
            while window and window[0] < cutoff:
                window.popleft()
            if len(window) >= self.limit:
                return False
            window.append(now)
            # Bound memory: prune idle clients once the table grows large.
            if len(self._events) > 10_000:
                stale = [k for k, w in self._events.items() if not w or w[-1] < cutoff]
                for k in stale:
                    del self._events[k]
            return True

    def over_limit(self, key: str) -> bool:
        """Non-mutating check: True if a request now would be rejected.

        Used by the socket server's header-only pre-check so over-limit
        clients are refused BEFORE their request body is read; it must not
        record the request — the middleware (which runs only for requests
        that pass) does the recording."""
        now = time.monotonic()
        with self._lock:
            window = self._events.get(key)
            if not window:
                return False
            cutoff = now - self.period
            while window and window[0] < cutoff:
                window.popleft()
            return len(window) >= self.limit

    def _reject(self) -> Response:
        return Response(429, {"detail": f"Rate limit exceeded: {self.limit}/{int(self.period)}s"})

    def early_check(self, request: Request) -> Response | None:
        """Header-only pre-check for App.early_checks (body not yet read)."""
        if request.path in EXEMPT_PATHS:
            return None
        return self._reject() if self.over_limit(request.client_ip) else None

    def middleware(self, request: Request, nxt):
        if request.path in EXEMPT_PATHS:
            return nxt(request)
        if not self.allow(request.client_ip):
            return self._reject()
        return nxt(request)
