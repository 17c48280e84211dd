"""The port's MicroBatcher against the JAX package's, on the CPU.

The JAX package's ``tests/test_batching.py`` cases that need no HTTP app,
run against the port's batcher, each request's results held to the direct
recommender's and to the JAX batcher's on the same requests. Nothing is
decided by sleeping: ``_Gate`` holds a leader's window open until the test's
requests are all pending (a condition with a timeout), and a recorded
``sleep`` shows whether a leader paid the window at all."""

import dataclasses
import json
import sys
import threading
import time
import types

import jax
import numpy as np
import pytest

from instacart_next_order_recommendation_tpu.models import (
    TowerConfig as JaxTowerConfig,
    init_params as jax_init_params,
    save_tower as jax_save_tower,
)
from instacart_next_order_recommendation_tpu.serve import batching as jax_batching
from instacart_next_order_recommendation_tpu.serve.recommender import (
    Recommender as JaxRecommender,
)
from instacart_next_order_recommendation_tpu.tokenizer import (
    WordPieceTokenizer as JaxWordPieceTokenizer,
)
from instacart_next_order_recommendation_tpu_torch.ops import _build
from instacart_next_order_recommendation_tpu_torch.serve import batching as port_batching
from instacart_next_order_recommendation_tpu_torch.serve.batching import MicroBatcher
from instacart_next_order_recommendation_tpu_torch.serve.precompile import (
    BATCH_BUCKETS,
    K_BUCKETS,
)
from instacart_next_order_recommendation_tpu_torch.serve.recommender import (
    MonitoredRecommender,
    Recommender,
)

TOWER = JaxTowerConfig(
    vocab_size=0, hidden_size=64, num_layers=2, num_heads=2, intermediate_size=128,
    max_position=64, max_seq_length=32, compute_dtype="float32",
)
TIMEOUT_S = 120


def _corpus(n=40):
    nouns = ["Milk", "Bread", "Banana", "Cheese", "Rice", "Coffee"]
    return {
        str(i + 1): f"Product: Organic {nouns[i % len(nouns)]} {i}. Aisle: a{i % 5}. "
        f"Department: d{i % 3}."
        for i in range(n)
    }


@pytest.fixture(scope="module")
def recs(tmp_path_factory):
    """One tower (written by the JAX package) and a 40-product corpus,
    served by the port's Recommender and by JAX's."""
    base = tmp_path_factory.mktemp("batching")
    corpus = _corpus()
    corpus_path = base / "eval_corpus.json"
    corpus_path.write_text(json.dumps(corpus))
    tok = JaxWordPieceTokenizer.train(corpus.values(), vocab_size=600, min_frequency=1)
    cfg = dataclasses.replace(TOWER, vocab_size=tok.vocab_size)
    model_dir = base / "model"
    jax_save_tower(model_dir, jax_init_params(cfg, jax.random.key(3)), cfg, tok)
    ours = Recommender(model_dir, corpus_path, use_index=False, device="cpu")
    theirs = JaxRecommender(model_dir, corpus_path, use_index=False)
    return ours, theirs


@pytest.fixture(scope="module")
def rec(recs):
    return recs[0]


class _Gate:
    """Stands in for a batcher's lock and for its module's ``time.sleep``:
    the leader's window stays open until ``n`` requests are pending."""

    def __init__(self, batcher, module, monkeypatch, n: int):
        self.batcher, self.n = batcher, n
        self.cond = threading.Condition()
        self.sleeps = 0
        batcher._lock = self
        monkeypatch.setattr(module, "time", types.SimpleNamespace(time=time.time,
                                                                  sleep=self.sleep))

    def __enter__(self):
        self.cond.acquire()

    def __exit__(self, *exc):
        self.cond.notify_all()
        self.cond.release()

    def sleep(self, _seconds):
        self.sleeps += 1
        with self.cond:
            ok = self.cond.wait_for(lambda: len(self.batcher._pending) >= self.n,
                                    timeout=TIMEOUT_S)
        if not ok:
            raise TimeoutError(f"only {len(self.batcher._pending)} of {self.n} requests arrived")


def _loaded(batcher):
    """Put a batcher in its loaded regime: a recent coalesced drain."""
    batcher._last_drain = 2
    batcher._last_drain_t = time.time()
    return batcher


def _burst(batcher, module, monkeypatch, calls, preseed=True):
    """Run ``calls`` ((args, kwargs) each) as concurrent requests, coalesced
    into one drain; returns each call's result (or exception) in order."""
    gate = _Gate(batcher, module, monkeypatch, len(calls))
    if preseed:
        _loaded(batcher)
    out = [None] * len(calls)

    def worker(i):
        args, kwargs = calls[i]
        try:
            out[i] = batcher.recommend(*args, **kwargs)
        except Exception as exc:  # noqa: BLE001 - returned to the test
            out[i] = exc

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(len(calls))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=TIMEOUT_S)
    assert not any(t.is_alive() for t in threads)
    return out, gate


def _ids(results):
    return [pid for pid, _ in results]


def _same_results(a, b):
    assert _ids(a) == _ids(b) and len(a) > 0
    np.testing.assert_allclose([s for _, s in a], [s for _, s in b], atol=1e-5)


class _TopkSpy:
    """Index facade recording the (batch, k) shapes topk is called with."""

    def __init__(self, index):
        self._index = index
        self.calls = []

    def topk(self, queries, k, candidate_mask=None):
        self.calls.append((np.asarray(queries).shape[0], k))
        return self._index.topk(queries, k, candidate_mask=candidate_mask)

    def __getattr__(self, name):
        return getattr(self._index, name)


class _RecView:
    """Recommender facade with a spied index (keeps the real encoder/corpus)."""

    def __init__(self, rec, index):
        self._inner = rec
        self.index = index

    def __getattr__(self, name):
        return getattr(self._inner, name)


def test_single_request_matches_direct_and_jax(recs):
    ours, theirs = recs
    batcher = MicroBatcher(ours, window_ms=1.0)
    batched = batcher.recommend("organic milk", top_k=5)
    assert batched == ours.recommend("organic milk", top_k=5)
    _same_results(batched, jax_batching.MicroBatcher(theirs).recommend("organic milk", top_k=5))
    m = batcher.last_metrics
    assert m is not None and m.num_recommendations == 5
    assert batcher.decision_counts == {"windowed": 0, "immediate": 1}


def test_concurrent_requests_coalesce_like_jax(recs, monkeypatch):
    ours, theirs = recs
    calls = [((f"organic milk {i % 4}",), {"top_k": 3}) for i in range(8)]
    spy = _TopkSpy(ours.index)
    batcher = MicroBatcher(ours, window_ms=60.0)
    batcher._rec = _RecView(ours, spy)
    out, gate = _burst(batcher, port_batching, monkeypatch, calls)
    jax_out, _ = _burst(jax_batching.MicroBatcher(theirs, window_ms=60.0), jax_batching,
                        monkeypatch, calls)
    for (args, kwargs), got, want in zip(calls, out, jax_out):
        direct = ours.recommend(*args, **kwargs)
        assert _ids(got) == _ids(direct)
        # scores match up to batched-matmul reduction-order noise
        np.testing.assert_allclose([s for _, s in got], [s for _, s in direct], atol=1e-5)
        _same_results(got, want)
    assert spy.calls == [(8, 16)] and gate.sleeps == 1
    assert batcher.drain_sizes == {8: 1}


def test_per_request_exclusions_in_one_batch(recs, monkeypatch):
    ours, theirs = recs
    base = ours.recommend("organic milk", top_k=5)
    excl = {base[0][0]}
    calls = [(("organic milk",), {"top_k": 5}),
             (("organic milk",), {"top_k": 5, "exclude_product_ids": excl})]
    (plain, excluded), _ = _burst(MicroBatcher(ours, window_ms=50.0), port_batching,
                                  monkeypatch, calls)
    jax_out, _ = _burst(jax_batching.MicroBatcher(theirs, window_ms=50.0), jax_batching,
                        monkeypatch, calls)
    assert _ids(plain) == _ids(base)
    assert excl.isdisjoint(_ids(excluded))
    assert _ids(excluded) == _ids(ours.recommend("organic milk", top_k=5,
                                                 exclude_product_ids=excl))
    _same_results(plain, jax_out[0])
    _same_results(excluded, jax_out[1])


def test_filtered_requests_bypass_batching(recs):
    ours, theirs = recs
    batcher = MicroBatcher(ours, window_ms=1.0)
    direct = ours.recommend("milk", top_k=5, filter_aisles=["a1"])
    got = batcher.recommend("milk", top_k=5, filter_aisles=["a1"])
    assert got == direct and all("Aisle: a1." in ours.pid_to_text[p] for p in _ids(got))
    assert not batcher.drain_sizes and batcher.decision_counts == {"windowed": 0, "immediate": 0}
    _same_results(got, jax_batching.MicroBatcher(theirs).recommend(
        "milk", top_k=5, filter_aisles=["a1"]))


def test_error_propagates_to_all_waiters(rec, monkeypatch):
    class BoomEncoder:
        def encode_device(self, *a, **kw):
            raise RuntimeError("boom")

    class Boom:
        product_ids = rec.product_ids
        encoder = BoomEncoder()

        def __getattr__(self, name):
            return getattr(rec, name)

    calls = [(("milk",), {"top_k": 3})] * 3
    out, _ = _burst(MicroBatcher(Boom(), window_ms=30.0), port_batching, monkeypatch, calls)
    assert [str(e) for e in out] == ["boom"] * 3
    assert all(isinstance(e, RuntimeError) for e in out)


def test_batched_dispatch_uses_bucketed_shapes(rec, monkeypatch):
    """The coalesced top-k runs at the padded batch bucket and a k from the
    serve lattice, so the kernels see the warm-up's shapes."""
    spy = _TopkSpy(rec.index)
    batcher = MicroBatcher(rec, window_ms=60.0)
    batcher._rec = _RecView(rec, spy)
    calls = [((f"organic milk {i}",), {"top_k": 3}) for i in range(3)]
    calls.append((("organic bread",), {"top_k": 20, "exclude_product_ids": {"1", "2"}}))
    _burst(batcher, port_batching, monkeypatch, calls)
    assert spy.calls == [(4, 32)]
    for b, k in spy.calls:
        assert b in BATCH_BUCKETS and k in K_BUCKETS


def test_direct_path_metrics_not_stale(rec):
    """Filtered requests bypass batching; last_metrics must reflect THAT
    request (the property shadows __getattr__ delegation)."""
    mon = MonitoredRecommender(rec.model_dir, rec.corpus_path, use_index=False, device="cpu",
                               encoder=rec.encoder)
    batcher = MicroBatcher(mon, window_ms=1.0)
    batcher.recommend("organic milk", top_k=5)
    assert batcher.last_metrics.num_recommendations == 5
    batcher.recommend("milk", top_k=2, user_id="u7", filter_aisles=["a1"])
    m = batcher.last_metrics
    assert m is not None and m.user_id == "u7" and m.num_recommendations <= 2
    assert m.stage_timing_source == "measured"


def test_monitored_recommender_buckets_k(rec, monkeypatch):
    """A measured request fetches a lattice k (top_k=10 + 2 excluded -> 16)."""
    mon = MonitoredRecommender(rec.model_dir, rec.corpus_path, use_index=False, device="cpu",
                               encoder=rec.encoder)
    spy = _TopkSpy(mon.index)
    mon.index = spy
    monkeypatch.setenv("ITOR_MONITORED_SINGLE_DISPATCH", "0")
    out = mon.recommend("organic milk", top_k=10, exclude_product_ids={"1", "2"})
    assert len(out) == 10 and {"1", "2"}.isdisjoint(_ids(out))
    assert spy.calls == [(1, 16)]


def test_lone_query_skips_window(rec, monkeypatch):
    """Idle traffic: a lone query dispatches at once, without the window."""
    batcher = MicroBatcher(rec, window_ms=400.0)
    gate = _Gate(batcher, port_batching, monkeypatch, 1)
    batcher.recommend("organic milk", top_k=3)  # first drain: size 1
    out = batcher.recommend("organic bread", top_k=3)
    assert out == rec.recommend("organic bread", top_k=3)
    assert gate.sleeps == 0 and batcher.decision_counts == {"windowed": 0, "immediate": 2}


def test_lone_query_after_idle_gap_skips_window(rec, monkeypatch):
    """A burst followed by idleness does not charge the next lone query a
    window: the last-drain signal decays after about a second."""
    batcher = MicroBatcher(rec, window_ms=400.0)
    gate = _Gate(batcher, port_batching, monkeypatch, 1)
    batcher._last_drain = 8  # a burst coalesced...
    batcher._last_drain_t = time.time() - 5.0  # ...but 5 s ago (idle since)
    out = batcher.recommend("organic bread", top_k=3)
    assert out == rec.recommend("organic bread", top_k=3)
    assert gate.sleeps == 0


def test_window_reengages_under_concurrency(rec, monkeypatch):
    """After a coalesced drain the window stays on: the next burst batches too."""
    spy = _TopkSpy(rec.index)
    batcher = MicroBatcher(rec, window_ms=60.0)
    batcher._rec = _RecView(rec, spy)
    calls = [((f"milk {i}",), {"top_k": 3}) for i in range(6)]
    _burst(batcher, port_batching, monkeypatch, calls)
    _burst(batcher, port_batching, monkeypatch, calls, preseed=False)
    assert spy.calls == [(8, 16), (8, 16)]
    assert batcher.decision_counts == {"windowed": 2, "immediate": 0}


def test_overlapping_arrival_engages_the_window(rec, monkeypatch):
    """Without any pre-seeded state: a request that arrives while another is
    in flight marks the traffic as overlapping, so its leader pays the
    window and the request after it coalesces with it."""
    batcher = MicroBatcher(rec, window_ms=40.0)
    fused = rec._fused
    started, release = threading.Event(), threading.Event()

    class HeldPipeline:
        """The first lone drain's fused call waits until released."""

        def topk(self, ids, mask, k):
            if not started.is_set():
                started.set()
                assert release.wait(timeout=TIMEOUT_S)
            return fused.topk(ids, mask, k)

    batcher._rec = types.SimpleNamespace(
        **{k: getattr(rec, k) for k in ("encoder", "index", "_take_top", "product_ids",
                                        "_stage_cal")},
        _fused=HeldPipeline(),
    )
    first = {}
    t = threading.Thread(target=lambda: first.update(r=batcher.recommend("milk", top_k=3)))
    t.start()
    assert started.wait(timeout=TIMEOUT_S)
    calls = [(("organic milk 1",), {"top_k": 3}), (("organic bread 2",), {"top_k": 3})]
    out, gate = _burst(batcher, port_batching, monkeypatch, calls, preseed=False)
    release.set()
    t.join(timeout=TIMEOUT_S)
    assert not t.is_alive()
    assert gate.sleeps == 1
    assert batcher.decision_counts == {"windowed": 1, "immediate": 1}
    assert batcher.drain_sizes == {1: 1, 2: 1}
    for (args, kwargs), got in zip(calls, out):
        _same_results(got, rec.recommend(*args, **kwargs))
    _same_results(first["r"], rec.recommend("milk", top_k=3))


def test_sustained_concurrency_exact_and_counted(rec):
    """Many threads, no stagger: every result equals the direct path, every
    leader records one decision and one drain, and the drains account for
    every request."""
    from concurrent.futures import ThreadPoolExecutor

    batcher = MicroBatcher(rec, window_ms=5.0)
    queries = [f"organic milk {i % 7}" for i in range(48)]
    direct = {q: rec.recommend(q, top_k=4) for q in set(queries)}
    with ThreadPoolExecutor(16) as ex:
        results = list(ex.map(lambda q: (q, batcher.recommend(q, top_k=4)), queries,
                              timeout=TIMEOUT_S))
    for q, got in results:
        assert _ids(got) == _ids(direct[q])
        np.testing.assert_allclose([s for _, s in got], [s for _, s in direct[q]], atol=1e-5)
    decisions = batcher.decision_counts["windowed"] + batcher.decision_counts["immediate"]
    assert decisions == sum(batcher.drain_sizes.values()) > 0
    assert sum(size * n for size, n in batcher.drain_sizes.items()) == 48


def test_fused_lone_drain_and_coalesced_drain_match_direct(recs, monkeypatch):
    """A lone drain takes the fused pipeline with calibrated stage stats; a
    coalesced drain encodes and ranks in two calls. Both give the direct
    monitored results, and JAX's batcher's."""
    ours, theirs = recs
    mon = MonitoredRecommender(ours.model_dir, ours.corpus_path, use_index=False, device="cpu",
                               encoder=ours.encoder)
    batcher = MicroBatcher(mon, window_ms=40.0)
    lone = batcher.recommend("organic milk", top_k=3)
    assert mon._stage_cal._cache, "the lone drain did not take the fused pipeline"
    m_lone = batcher.last_metrics
    assert m_lone is not None and m_lone.query_embedding_time_ms > 0
    assert _ids(lone) == _ids(mon.recommend("organic milk", top_k=3))

    calls = [((f"organic milk {i % 4}",), {"top_k": 3}) for i in range(6)]
    metrics = {}
    real = batcher.recommend

    def recommend_and_keep(query, **kw):
        out = real(query, **kw)
        metrics[query, threading.get_ident()] = batcher.last_metrics
        return out

    monkeypatch.setattr(batcher, "recommend", recommend_and_keep)
    out, _ = _burst(batcher, port_batching, monkeypatch, calls)
    jax_out, _ = _burst(jax_batching.MicroBatcher(theirs, window_ms=40.0), jax_batching,
                        monkeypatch, calls)
    for (args, kwargs), got, want in zip(calls, out, jax_out):
        direct = mon.recommend(*args, **kwargs)
        assert _ids(got) == _ids(direct)
        np.testing.assert_allclose([s for _, s in got], [s for _, s in direct], atol=1e-5)
        _same_results(got, want)
    assert len(metrics) == 6
    for m in metrics.values():
        assert m.query_embedding_time_ms > 0 and m.similarity_compute_time_ms > 0
    assert batcher.drain_sizes == {1: 1, 6: 1}


def test_passthrough_for_objects_without_the_batched_internals():
    class Plain:
        def recommend(self, query, top_k=10, exclude_product_ids=None):
            return [(query, float(top_k))]

    class WithUser(Plain):
        last_metrics = "mine"

        def recommend(self, query, top_k=10, user_id=None, exclude_product_ids=None):
            return [(user_id, float(top_k))]

    assert MicroBatcher(Plain()).recommend("q", top_k=2, user_id="u") == [("q", 2.0)]
    batcher = MicroBatcher(WithUser())
    assert batcher.recommend("q", top_k=3, user_id="u") == [("u", 3.0)]
    assert batcher.last_metrics == "mine"


def test_launch_counters_exact_under_threads():
    """Kernel wrappers count launches from several threads at once (the
    batcher's leaders): the counter loses no update."""

    def fake_kernel():
        pass

    fake_kernel.launches = 0
    barrier = threading.Barrier(8, timeout=TIMEOUT_S)

    def worker():
        barrier.wait()
        for _ in range(2000):
            _build.count(fake_kernel)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=TIMEOUT_S)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert fake_kernel.launches == 16000
