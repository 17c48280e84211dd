"""Request micro-batching: coalesce concurrent recommend calls into one
batched encode and top-k.

Counterpart of the JAX package's ``serve/batching.py``. One query's encode
and top-k cost is mostly fixed per call at batch 1, so under concurrent
load batching is nearly free: the first request in an idle window becomes
the *leader*, sleeps ``window_ms``, then drains every request that arrived
meanwhile, runs ONE batched encode and top-k over the catalog, and hands
each request its rows. Batches pad to ``BATCH_BUCKETS`` rows, so the
kernels see few shapes.

Drop-in recommender-compatible: exposes ``recommend`` with the same signature
and a thread-local ``last_metrics``; everything else delegates to the wrapped
recommender. Filtered requests (aisle/department masks differ per request)
bypass batching. A server turns it on with ``BATCH_WINDOW_MS``.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Optional

import numpy as np

from instacart_next_order_recommendation_tpu_torch.serve.precompile import (
    BATCH_BUCKETS,
    K_BUCKETS,
)
from instacart_next_order_recommendation_tpu_torch.serve.recommender import (
    RecommendationMetrics,
)

logger = logging.getLogger(__name__)

# Leader wait bound for followers: must exceed a cold start (the kernel
# libraries' first build takes tens of seconds), or every follower in the
# first window errors out while the leader is legitimately building.
_FOLLOWER_TIMEOUT_S = 300.0


def _bucket(n: int) -> int:
    # Shared lattice with serve/precompile so startup warming covers every
    # shape this module can dispatch.
    for b in BATCH_BUCKETS:
        if b >= n:
            return b
    return n


class _Slot:
    __slots__ = ("query", "fetch_k", "event", "scores", "indices", "error", "encode_ms", "sim_ms")

    def __init__(self, query: str, fetch_k: int):
        self.query = query
        self.fetch_k = fetch_k
        self.event = threading.Event()
        self.scores: np.ndarray | None = None
        self.indices: np.ndarray | None = None
        self.error: BaseException | None = None
        self.encode_ms = 0.0
        self.sim_ms = 0.0


class MicroBatcher:
    """Coalesces concurrent recommend() calls within a time window."""

    def __init__(self, recommender, window_ms: float = 4.0, max_batch: int = 64):
        self._rec = recommender
        self._window_s = window_ms / 1000.0
        self._max_batch = max_batch
        self._lock = threading.Lock()
        self._pending: list[_Slot] = []
        self._tls = threading.local()
        self.window_ms = window_ms
        # Adaptive lone-query fast path: the window only pays off when
        # followers actually arrive, i.e. when requests OVERLAP in time — a
        # single sequential client can never coalesce with itself, so it
        # should never pay the window. The leader sleeps the window when (a)
        # the previous drain coalesced >1 request AND did so recently, (b)
        # another request is already pending, or (c) overlapping requests
        # were observed within the last second (an arrival while another
        # request was in flight — without this decay term, steady load whose
        # arrivals land just after each drain would latch the batcher into
        # permanent batch-1 dispatches). Signal (a) decays by time like (c):
        # a burst followed by full idleness must not charge the next lone
        # query a window — after ~1 s without a drain, the last drain size is
        # stale evidence about current traffic.
        self._last_drain = 0
        self._last_drain_t = 0.0
        # Observability (read by chip_smoke.py and a server's metrics): how
        # often the leader paid the window vs dispatched immediately, and the
        # drain size histogram — the evidence that the adaptive heuristic neither
        # latches into permanent batch-1 under load nor charges idle traffic
        # permanent windows.
        self.decision_counts = {"windowed": 0, "immediate": 0}
        self.drain_sizes: dict[int, int] = {}
        self._in_flight = 0
        self._overlap_t = 0.0
        # Objects without the batched internals (e.g. test doubles) pass
        # straight through to their own recommend().
        self._passthrough = not all(
            hasattr(recommender, a) for a in ("encoder", "index", "_take_top")
        )
        try:
            import inspect

            params = inspect.signature(recommender.recommend).parameters
            self._accepts_user_id = "user_id" in params or any(
                p.kind is inspect.Parameter.VAR_KEYWORD for p in params.values()
            )
        except (TypeError, ValueError):
            self._accepts_user_id = True  # mocks/builtins: accept anything

    # Delegate everything the routes touch (pid_to_text, corpus_path, ...).
    def __getattr__(self, name):
        return getattr(self._rec, name)

    @property
    def last_metrics(self) -> Optional[RecommendationMetrics]:
        return getattr(self._tls, "last_metrics", None)

    def recommend(
        self,
        query: str,
        top_k: int = 10,
        user_id: Optional[str] = None,
        exclude_product_ids: set[str] | None = None,
        filter_aisles: list[str] | None = None,
        filter_departments: list[str] | None = None,
    ) -> list[tuple[str, float]]:
        if self._passthrough or filter_aisles or filter_departments:
            # Per-request candidate masks are not batchable, and test
            # doubles without the batched internals handle their own
            # recommend(); both take the direct path with every argument
            # forwarded (filters always — silently dropping them would
            # return unfiltered results; user_id only when the wrapped
            # signature takes it, since plain Recommender does not). The
            # wrapped recommender sets its own last_metrics; mirror it into
            # this thread's slot so the route (which reads the MicroBatcher
            # property — properties win over __getattr__ delegation) sees
            # this request's metrics, not a stale batch's.
            kwargs = dict(top_k=top_k, exclude_product_ids=exclude_product_ids)
            if filter_aisles or filter_departments:
                kwargs.update(
                    filter_aisles=filter_aisles, filter_departments=filter_departments
                )
            if self._accepts_user_id:
                kwargs["user_id"] = user_id
            results = self._rec.recommend(query, **kwargs)
            self._tls.last_metrics = getattr(self._rec, "last_metrics", None)
            return results

        start = time.time()
        excluded = exclude_product_ids or set()
        fetch_k = min(top_k + len(excluded), len(self._rec.product_ids))
        slot = _Slot(query, fetch_k)

        with self._lock:
            if self._in_flight > 0:
                self._overlap_t = start  # concurrent traffic observed
            self._in_flight += 1
            self._pending.append(slot)
            is_leader = len(self._pending) == 1

        try:
            if is_leader:
                with self._lock:
                    busy = (
                        (self._last_drain > 1 and (start - self._last_drain_t) < 1.0)
                        or len(self._pending) > 1
                        or (start - self._overlap_t) < 1.0
                    )
                    self.decision_counts["windowed" if busy else "immediate"] += 1
                if busy:
                    time.sleep(self._window_s)
                # One atomic drain: everything that arrived during the window
                # is this leader's responsibility (chunked to max_batch);
                # anything arriving after the drain sees an empty queue and
                # elects itself.
                with self._lock:
                    drained, self._pending = self._pending, []
                    self._last_drain = len(drained)
                    self._last_drain_t = time.time()
                    n = len(drained)
                    self.drain_sizes[n] = self.drain_sizes.get(n, 0) + 1
                for lo in range(0, len(drained), self._max_batch):
                    self._process(drained[lo : lo + self._max_batch])
            elif not slot.event.wait(timeout=_FOLLOWER_TIMEOUT_S + self._window_s):
                raise TimeoutError("micro-batch leader did not complete in time")
        finally:
            with self._lock:
                self._in_flight -= 1

        if slot.error is not None:
            raise slot.error

        results = self._rec._take_top(slot.scores, slot.indices, top_k, excluded)
        total_ms = (time.time() - start) * 1000
        self._tls.last_metrics = RecommendationMetrics(
            user_id=user_id or "anonymous",
            query_embedding_time_ms=slot.encode_ms,
            similarity_compute_time_ms=slot.sim_ms,
            total_latency_ms=total_ms,
            num_recommendations=len(results),
            top_score=results[0][1] if results else 0.0,
            avg_score=sum(s for _, s in results) / len(results) if results else 0.0,
            timestamp=time.time(),
        )
        return results

    def _process(self, batch: list[_Slot]) -> None:
        try:
            queries = [s.query for s in batch]
            fetch_k = max(s.fetch_k for s in batch)
            k_bucket = next((b for b in K_BUCKETS if b >= fetch_k), fetch_k)
            k_bucket = min(k_bucket, len(self._rec.product_ids))
            pad_rows = _bucket(len(queries))

            from instacart_next_order_recommendation_tpu_torch.serve.recommender import (
                _single_dispatch_on,
            )

            fused = getattr(self._rec, "_fused", None)
            if fused is not None and len(batch) == 1 and _single_dispatch_on():
                # LONE drains take the fused pipeline in one call: tokenize,
                # then encode + top-k, with the stage stats from the
                # calibration table (StageCalibrator), as a lone monitored
                # request does. Multi-request drains encode and rank in two
                # calls, at the bucketed batch shape (the warm-up lattice
                # runs the fused pipeline at batch 1 only).
                enc = self._rec.encoder
                ids, _ = enc.tokenizer.encode_batch(
                    queries,
                    max_seq_length=enc.max_seq_length,
                    pad_batch_to=pad_rows,
                )
                scores, indices = fused.topk(ids, None, k_bucket)
                encode_ms, sim_ms = self._rec._stage_cal.stage_ms(
                    queries, seq=ids.shape[1], k_bucket=k_bucket, pad_rows=pad_rows
                )
            else:
                t0 = time.time()
                # keep_padding: top-k sees the bucketed batch shape (pad
                # rows ride along and their results are ignored). The
                # embedding stays on the device: no host copy and re-upload.
                emb = self._rec.encoder.encode_device(
                    queries, pad_batch_to=pad_rows, keep_padding=True
                )
                encode_ms = (time.time() - t0) * 1000
                t1 = time.time()
                scores, indices = self._rec.index.topk(emb, k_bucket)
                sim_ms = (time.time() - t1) * 1000
            if len(batch) > 1:
                logger.info(
                    "micro_batch size=%d k=%d encode_ms=%.1f sim_ms=%.1f",
                    len(batch),
                    k_bucket,
                    encode_ms,
                    sim_ms,
                )
            for row, s in enumerate(batch):
                s.scores = scores[row, : s.fetch_k]
                s.indices = indices[row, : s.fetch_k]
                s.encode_ms = encode_ms
                s.sim_ms = sim_ms
        except BaseException as exc:  # delivered to every waiter of the batch
            for s in batch:
                s.error = exc
            if not isinstance(exc, Exception):  # interrupts and exits go on up
                raise
        finally:
            for s in batch:
                s.event.set()
