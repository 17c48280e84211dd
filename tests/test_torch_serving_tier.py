"""The port's serving tier against the JAX package's, on the CPU: model
signatures, the encoder injection, MonitoredRecommender and its metrics,
StageCalibrator, the warm-up lattice, InferenceConfig, the serve CLI and
its device override, and the corpus and .env helpers."""

import dataclasses
import json
import logging
import os
import sys
import threading
import types
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from instacart_next_order_recommendation_tpu.models import (
    TowerConfig as JaxTowerConfig,
    init_params as jax_init_params,
    save_tower as jax_save_tower,
)
from instacart_next_order_recommendation_tpu.parallel import MeshConfig, build_mesh
from instacart_next_order_recommendation_tpu.serve import recommender as jax_recommender
from instacart_next_order_recommendation_tpu.serve.precompile import (
    warm_serve_shapes as jax_warm_serve_shapes,
)
from instacart_next_order_recommendation_tpu.tokenizer import (
    WordPieceTokenizer as JaxWordPieceTokenizer,
)
from instacart_next_order_recommendation_tpu.utils import dotenv as jax_dotenv
from instacart_next_order_recommendation_tpu.utils import resolve as jax_resolve
from instacart_next_order_recommendation_tpu_torch.models.text_encoder import TextEncoder
from instacart_next_order_recommendation_tpu_torch.serve import recommender as port_recommender
from instacart_next_order_recommendation_tpu_torch.serve.precompile import (
    BATCH_BUCKETS,
    K_BUCKETS,
    warm_serve_shapes,
)
from instacart_next_order_recommendation_tpu_torch.tokenizer import LENGTH_BUCKETS
from instacart_next_order_recommendation_tpu_torch.utils import dotenv as port_dotenv
from instacart_next_order_recommendation_tpu_torch.utils import resolve as port_resolve

TOWER = JaxTowerConfig(
    vocab_size=0, hidden_size=64, num_layers=2, num_heads=2, intermediate_size=128,
    max_position=64, max_seq_length=32, compute_dtype="float32",
)
AISLES = ["fresh fruits", "milk", "bread", "cereal", "coffee", "pasta sauce"]
QUERIES = [
    "[+7d w4h14] Organic Milk 3, Whole Wheat Bread 8.",
    "[+3d w1h9] Banana 11, Greek Yogurt 40, Honey.",
    "[+1d w0h12] Coffee 77, Oat Milk, Granola 150.",
]
METRIC_FIELDS = [f.name for f in dataclasses.fields(jax_recommender.RecommendationMetrics)]


def _corpus(n=200, offset=0):
    adjs = ["Organic", "Fresh", "Whole", "Crunchy", "Roasted"]
    nouns = ["Milk", "Bread", "Banana", "Yogurt", "Coffee", "Granola", "Pasta"]
    return {
        str(1000 + offset + i): f"Product: {adjs[i % 5]} {nouns[(i + offset) % 7]} {i}. "
        f"Aisle: {AISLES[i % 6]}. Department: d{i % 4}."
        for i in range(n)
    }


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """One tower (written by the JAX package) and one corpus, served by both
    packages' MonitoredRecommender without a disk cache; JAX's on a
    one-device mesh, so it too serves lone requests through its fused
    pipeline."""
    base = tmp_path_factory.mktemp("tier")
    corpus = _corpus()
    corpus_path = base / "eval_corpus.json"
    corpus_path.write_text(json.dumps(corpus))
    tok = JaxWordPieceTokenizer.train(corpus.values(), vocab_size=600, min_frequency=1)
    cfg = dataclasses.replace(TOWER, vocab_size=tok.vocab_size)
    model_dir = base / "model"
    jax_save_tower(model_dir, jax_init_params(cfg, jax.random.key(7)), cfg, tok)
    ours = port_recommender.MonitoredRecommender(
        model_dir, corpus_path, use_index=False, device="cpu"
    )
    mesh = build_mesh(MeshConfig(data_parallel=1, model_parallel=1))
    theirs = jax_recommender.MonitoredRecommender(
        model_dir, corpus_path, use_index=False, mesh=mesh
    )
    assert theirs._fused is not None
    return ours, theirs


def _ids(results):
    return [pid for pid, _ in results]


def _same_results(a, b):
    assert _ids(a) == _ids(b) and len(a) > 0
    np.testing.assert_allclose([s for _, s in a], [s for _, s in b], atol=1e-5)


# ------------------------------------------------------------ model signature


def test_model_signature_matches_jax_and_changes_on_rewrite(served, tmp_path):
    ours, _ = served
    sig = port_recommender.model_signature(ours.model_dir)
    assert sig == jax_recommender.model_signature(ours.model_dir)
    assert sig == ours._model_signature and len(sig) >= 3
    # A copy with one file rewritten to the same size at the same mtime:
    # only the content probe can tell them apart.
    copy = tmp_path / "model"
    copy.mkdir()
    for f in ours.model_dir.iterdir():
        (copy / f.name).write_bytes(f.read_bytes())
        os.utime(copy / f.name, ns=(f.stat().st_atime_ns, f.stat().st_mtime_ns))
    before = port_recommender.model_signature(copy)
    params = copy / "params.msgpack"
    st = params.stat()
    data = bytearray(params.read_bytes())
    data[-1] ^= 0xFF
    params.write_bytes(bytes(data))
    os.utime(params, ns=(st.st_atime_ns, st.st_mtime_ns))
    after = port_recommender.model_signature(copy)
    assert after != before
    assert after == jax_recommender.model_signature(copy)
    assert port_recommender.model_signature(tmp_path / "missing") == ("<unreadable>",)


def test_injected_encoder_skips_the_reload(served, tmp_path, monkeypatch):
    ours, _ = served
    corpus = _corpus(80, offset=500)
    corpus_path = tmp_path / "eval_corpus.json"
    corpus_path.write_text(json.dumps(corpus))
    fresh = port_recommender.Recommender(ours.model_dir, corpus_path, use_index=False,
                                         device="cpu")

    def no_load(*args, **kwargs):
        raise AssertionError("the injected encoder should have been used")

    monkeypatch.setattr(TextEncoder, "load", no_load)
    swapped = port_recommender.Recommender(
        ours.model_dir, corpus_path, use_index=False, device="cpu", encoder=ours.encoder
    )
    assert swapped.encoder is ours.encoder
    assert swapped._model_signature == ours._model_signature
    for q in QUERIES:
        _same_results(swapped.recommend(q, top_k=8), fresh.recommend(q, top_k=8))


# ------------------------------------------------------- MonitoredRecommender


@pytest.mark.parametrize("query", QUERIES)
def test_monitored_recommend_matches_jax(served, query):
    ours, theirs = served
    a = ours.recommend(query, top_k=10, user_id="u1")
    b = theirs.recommend(query, top_k=10, user_id="u1")
    _same_results(a, b)
    ma, mb = ours.last_metrics, theirs.last_metrics
    assert [f.name for f in dataclasses.fields(ma)] == METRIC_FIELDS
    assert ma.stage_timing_source == mb.stage_timing_source == "calibrated"
    assert (ma.user_id, ma.num_recommendations) == (mb.user_id, mb.num_recommendations)
    np.testing.assert_allclose([ma.top_score, ma.avg_score], [mb.top_score, mb.avg_score],
                               atol=1e-5)
    assert ma.query_embedding_time_ms > 0 and ma.similarity_compute_time_ms > 0
    assert ma.total_latency_ms > 0
    # Exclusions apply after ranking, as in JAX.
    excluded = {a[0][0], a[2][0]}
    _same_results(
        ours.recommend(query, top_k=10, exclude_product_ids=excluded),
        theirs.recommend(query, top_k=10, exclude_product_ids=excluded),
    )


@pytest.mark.parametrize("route", ["filtered", "two_calls"])
def test_measured_routes_match_jax(served, monkeypatch, route):
    """A filtered request, or any request with single dispatch off, is timed
    on the wall clock ("measured") in both packages."""
    ours, theirs = served
    kw = {}
    if route == "filtered":
        kw = {"filter_aisles": ["milk", "coffee"], "filter_departments": ["d1"]}
    else:
        monkeypatch.setenv("ITOR_MONITORED_SINGLE_DISPATCH", "0")
    _same_results(ours.recommend(QUERIES[1], top_k=7, **kw),
                  theirs.recommend(QUERIES[1], top_k=7, **kw))
    assert ours.last_metrics.stage_timing_source == "measured"
    assert theirs.last_metrics.stage_timing_source == "measured"
    assert ours.last_metrics.num_recommendations == theirs.last_metrics.num_recommendations


def test_last_metrics_are_per_thread(served):
    ours, _ = served
    barrier = threading.Barrier(4, timeout=60)
    seen = {}

    def worker(i):
        barrier.wait()
        ours.recommend(QUERIES[i % 3], top_k=3 + i, user_id=f"user{i}")
        seen[i] = ours.last_metrics

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    for i in range(4):
        assert (seen[i].user_id, seen[i].num_recommendations) == (f"user{i}", 3 + i)


def test_metrics_log_carries_the_same_fields(served, caplog):
    ours, theirs = served
    extras = []
    for rec in (ours, theirs):
        caplog.clear()
        with caplog.at_level(logging.INFO, logger=rec.metrics_logger.name):
            rec.recommend(QUERIES[0], top_k=4, user_id="u9")
        (record,) = [r for r in caplog.records if r.getMessage() == "recommendation_served"]
        extras.append({k: getattr(record, k) for k in (
            "user_id", "latency_ms", "encode_time_ms", "similarity_time_ms", "num_results",
            "top_score", "avg_score",
        )})
    assert extras[0]["user_id"] == extras[1]["user_id"] == "u9"
    assert extras[0]["num_results"] == extras[1]["num_results"] == 4
    np.testing.assert_allclose(extras[0]["top_score"], extras[1]["top_score"], atol=1e-5)


# ------------------------------------------------------------ StageCalibrator


PACKAGES = {"port": port_recommender, "jax": jax_recommender}


@pytest.fixture(params=sorted(PACKAGES))
def calibrator(request, served):
    """A fresh StageCalibrator of either package, on that package's recommender."""
    ours, theirs = served
    rec = ours if request.param == "port" else theirs
    return PACKAGES[request.param].StageCalibrator(rec)


def test_calibrator_measures_once_then_serves_the_table(calibrator):
    first = calibrator.stage_ms([QUERIES[0]], seq=32, k_bucket=16)
    assert all(v > 0 for v in first)
    assert set(calibrator._cache) == {(1, 32, 16)}
    calibrator._measure = lambda *a: (_ for _ in ()).throw(AssertionError("measured again"))
    assert calibrator.stage_ms([QUERIES[1]], seq=32, k_bucket=16) == first


def test_calibrator_refreshes_a_stale_entry_off_the_request_path(calibrator):
    key = (1, 32, 16)
    calibrator._cache[key] = (7.0, 8.0, 0.0)  # measured long ago
    release = threading.Event()
    real = calibrator._measure

    def slow_measure(*args):
        assert release.wait(timeout=60)
        real(*args)

    calibrator._measure = slow_measure
    # The stale entry is served while one background refresh runs.
    assert calibrator.stage_ms([QUERIES[0]], seq=32, k_bucket=16) == (7.0, 8.0)
    ev = calibrator._inflight[key]
    assert calibrator.stage_ms([QUERIES[0]], seq=32, k_bucket=16) == (7.0, 8.0)
    assert calibrator._inflight[key] is ev  # deduplicated
    release.set()
    assert ev.wait(timeout=60)
    assert calibrator._cache[key][:2] != (7.0, 8.0) and key not in calibrator._inflight


def test_calibrator_coalesces_concurrent_cold_misses(calibrator):
    """Every request but the first finds the measurement in flight and
    waits for it: one measurement, one answer for all."""
    n = 5

    class CountingDict(dict):
        def __init__(self):
            super().__init__()
            self.gets = 0
            self.cond = threading.Condition()

        def get(self, key, default=None):
            with self.cond:
                self.gets += 1
                self.cond.notify_all()
            return super().get(key, default)

    inflight = CountingDict()
    calibrator._inflight = inflight
    calls = []
    real = calibrator._measure

    def gated_measure(*args):
        calls.append(args[0])
        with inflight.cond:  # every request has looked up the in-flight table
            assert inflight.cond.wait_for(lambda: inflight.gets >= n, timeout=60)
        real(*args)

    calibrator._measure = gated_measure
    out = {}

    def worker(i):
        out[i] = calibrator.stage_ms([QUERIES[0]], seq=32, k_bucket=32)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert calls == [(1, 32, 32)]
    assert len(set(out.values())) == 1 and next(iter(out.values())) != (0.05, 0.05)


def test_calibrator_failure_gives_the_placeholder_and_retries(calibrator):
    def broken(*args):
        raise RuntimeError("device hiccup")

    real = calibrator._measure
    calibrator._measure = broken
    assert calibrator.stage_ms([QUERIES[0]], seq=32, k_bucket=64) == (0.05, 0.05)
    assert not calibrator._inflight and not calibrator._cache
    calibrator._measure = real
    assert calibrator.stage_ms([QUERIES[0]], seq=32, k_bucket=64) != (0.05, 0.05)


# ------------------------------------------------------------------- warm-up


def lattice_size(batch_buckets, seq_buckets, k_effs, with_filters=True, fused=True):
    """Shapes warm_serve_shapes runs: every (batch, seq) encode, every
    (batch, k) top-k with and without a mask, the fused pipeline at batch 1."""
    n = len(batch_buckets) * len(seq_buckets)
    n += len(batch_buckets) * len(k_effs) * (2 if with_filters else 1)
    if fused and 1 in batch_buckets:
        n += len(seq_buckets) * len(k_effs)
    return n


def test_warm_serve_shapes_counts_the_jax_lattice(served):
    ours, theirs = served
    n_products = len(ours.product_ids)
    seqs = [s for s in LENGTH_BUCKETS if s <= ours.encoder.max_seq_length]
    assert seqs == [16, 32]
    k_effs = [min(k, n_products) for k in K_BUCKETS]  # 16, 32, 64, 128, 200
    full = lattice_size(BATCH_BUCKETS, seqs, k_effs)
    assert warm_serve_shapes(ours, batch_buckets=BATCH_BUCKETS) == full == 14 + 70 + 10
    # JAX compiles a program per shape: held to the same count on a part
    # of the lattice that keeps its compile time small.
    kw = dict(k_buckets=(16, 256), batch_buckets=(1, 2))
    small = lattice_size((1, 2), seqs, [16, n_products])
    assert warm_serve_shapes(ours, **kw) == jax_warm_serve_shapes(theirs, **kw) == small
    assert warm_serve_shapes(ours, with_filters=False) == lattice_size(
        (1,), seqs, k_effs, with_filters=False
    )
    assert warm_serve_shapes(object()) == 0


# --------------------------------------------------------------- CLI, config


def _write_config(path: Path, **raw) -> Path:
    """A YAML file of plain ``key: value`` lines (json scalars are YAML)."""
    path.write_text("".join(f"{k}: {json.dumps(v)}\n" for k, v in raw.items()))
    return path


def test_inference_config_from_one_dict(served):
    ours, _ = served
    raw = {
        "model_dir": str(ours.model_dir), "corpus": str(ours.corpus_path),
        "use_index": False, "query": "milk", "eval_query_id": 7, "top_k": 4,
        "topk_extraction": "packed", "ann": True, "ann_nlist": 12, "ann_nprobe": 3,
    }
    keys = ("model_dir", "corpus", "use_index", "query", "eval_query_id", "top_k",
            "topk_extraction", "ann", "ann_nlist", "ann_nprobe")
    a = port_recommender.InferenceConfig(raw)
    b = jax_recommender.InferenceConfig(raw)
    for key in keys:
        assert getattr(a, key) == getattr(b, key), key
    defaults = port_recommender.InferenceConfig({"corpus": str(ours.corpus_path)})
    jax_defaults = jax_recommender.InferenceConfig({"corpus": str(ours.corpus_path)})
    assert (defaults.top_k, defaults.use_index, defaults.topk_extraction) == (10, True, None)
    assert (defaults.ann, defaults.ann_nlist, defaults.ann_nprobe) == (False, None, 8)
    for key in keys:
        assert getattr(defaults, key) == getattr(jax_defaults, key), key


@pytest.mark.parametrize("mode", ["query", "eval_query_id", "demo"])
def test_main_prints_the_jax_lines(served, tmp_path, monkeypatch, capsys, mode):
    ours, _ = served
    corpus_dir = tmp_path / "data"
    corpus_dir.mkdir()
    corpus_path = corpus_dir / "eval_corpus.json"
    corpus_path.write_text(ours.corpus_path.read_text())
    (corpus_dir / "eval_queries.json").write_text(json.dumps({"42": QUERIES[2]}))
    raw = {"model_dir": str(ours.model_dir), "corpus": str(corpus_path), "use_index": False,
           "top_k": 5}
    raw.update({"query": {"query": QUERIES[0]}, "eval_query_id": {"eval_query_id": 42},
                "demo": {}}[mode])
    config = _write_config(tmp_path / "inference.yaml", **raw)
    monkeypatch.setenv("INFERENCE_DEVICE", "cpu")
    printed = []
    for package in (port_recommender, jax_recommender):
        monkeypatch.setattr(sys, "argv", ["serve", "--config", str(config)])
        package.main()
        printed.append(capsys.readouterr().out.splitlines())
    assert printed[0] == printed[1]
    assert sum(line.startswith("  ") and "product_id=" in line for line in printed[0]) == 5


def test_inference_device_override(served, monkeypatch):
    ours, _ = served
    monkeypatch.delenv("INFERENCE_DEVICE", raising=False)
    assert port_recommender.apply_inference_device_override() is None
    for value, want in (("cpu", "cpu"), (" CUDA ", "cuda")):
        monkeypatch.setenv("INFERENCE_DEVICE", value)
        assert port_recommender.apply_inference_device_override() == want
    monkeypatch.setenv("INFERENCE_DEVICE", "tpu")
    with pytest.raises(ValueError, match="INFERENCE_DEVICE"):
        port_recommender.apply_inference_device_override()
    # Unset, the CLI and the recommenders mean CUDA, and raise without it.
    monkeypatch.delenv("INFERENCE_DEVICE")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_recommender.MonitoredRecommender(ours.model_dir, ours.corpus_path, use_index=False)
    config = _write_config(Path(ours.corpus_path).parent / "cuda.yaml",
                           model_dir=str(ours.model_dir), corpus=str(ours.corpus_path),
                           use_index=False)
    monkeypatch.setattr(sys, "argv", ["serve", "--config", str(config)])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_recommender.main()


# -------------------------------------------------------- corpus and .env


def test_corpus_resolution_matches_jax(served, tmp_path, monkeypatch):
    ours, _ = served
    for package in (port_resolve, jax_resolve):
        assert package.resolve_corpus_with_hf_fallback(ours.corpus_path) == ours.corpus_path
    # A missing corpus asks the hub; a stand-in hub module that fails keeps
    # this offline, and both packages report the file as not found.
    asked = []

    def hf_hub_download(**kwargs):
        asked.append(kwargs)
        raise OSError("offline")

    monkeypatch.setitem(sys.modules, "huggingface_hub",
                        types.SimpleNamespace(hf_hub_download=hf_hub_download))
    missing = tmp_path / "nowhere" / "eval_corpus.json"
    for package in (port_resolve, jax_resolve):
        with pytest.raises(FileNotFoundError, match="offline"):
            package.resolve_corpus_with_hf_fallback(missing, hf_repo="org/repo")
    assert [a["repo_id"] for a in asked] == ["org/repo", "org/repo"]
    assert asked[0] == asked[1]


def test_load_dotenv_matches_jax(tmp_path, monkeypatch):
    env = tmp_path / ".env"
    env.write_text("# comment\nITOR_T_A=1\nITOR_T_B = 'two words'\nITOR_T_C=\"x\"\n"
                   "bad line\nITOR_T_KEEP=new\n")
    monkeypatch.setenv("ITOR_T_KEEP", "old")
    parsed = []
    for package in (port_dotenv, jax_dotenv):
        for key in ("ITOR_T_A", "ITOR_T_B", "ITOR_T_C"):
            monkeypatch.delenv(key, raising=False)
        parsed.append(package.load_dotenv(env))
        assert os.environ["ITOR_T_B"] == "two words" and os.environ["ITOR_T_KEEP"] == "old"
    assert parsed[0] == parsed[1] and len(parsed[0]) == 4
    assert port_dotenv.load_dotenv(tmp_path / "missing") == {}
