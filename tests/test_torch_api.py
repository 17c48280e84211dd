"""The port's HTTP API against the JAX package's, on the CPU.

Every case of ``tests/test_api.py`` runs on the port's ``create_app`` with a
mock recommender factory, and each request also goes through the JAX
``create_app`` on the same mock: the two must give the same status code,
JSON body and headers (request ids and timestamps masked). The ``/metrics``
exposition must move alike after the same requests. End to end, on one tiny
tower written by the JAX package, the port's app with its default factory
(``INFERENCE_DEVICE=cpu``) returns the JAX app's ids and scores, hot-swaps
its corpus on the live encoder, follows a model swap and keeps each answer
to one corpus generation under load; without CUDA and without
``INFERENCE_DEVICE=cpu`` it refuses to start.
"""

import dataclasses
import functools
import http.client
import json
import sqlite3
import threading
import time
from types import SimpleNamespace

import jax
import numpy as np
import pytest
from prometheus_client.parser import text_string_to_metric_families

from instacart_next_order_recommendation_tpu.api import metrics as jax_metrics
from instacart_next_order_recommendation_tpu.api.app import create_app as jax_create_app
from instacart_next_order_recommendation_tpu.api.http import (
    Request as JaxRequest,
    TestClient as JaxTestClient,
    make_server as jax_make_server,
)
from instacart_next_order_recommendation_tpu.models import (
    TowerConfig as JaxTowerConfig,
    init_params as jax_init_params,
    save_tower as jax_save_tower,
)
from instacart_next_order_recommendation_tpu.parallel import MeshConfig, build_mesh
from instacart_next_order_recommendation_tpu.serve import recommender as jax_recommender
from instacart_next_order_recommendation_tpu.tokenizer import (
    WordPieceTokenizer as JaxWordPieceTokenizer,
)
from instacart_next_order_recommendation_tpu_torch.api import metrics as port_metrics
from instacart_next_order_recommendation_tpu_torch.api.app import create_app
from instacart_next_order_recommendation_tpu_torch.api.http import (
    Request,
    TestClient,
    make_server,
)
from instacart_next_order_recommendation_tpu_torch.models.text_encoder import TextEncoder
from instacart_next_order_recommendation_tpu_torch.serve import (
    RecommendationMetrics,
    Recommender,
)

MASKED = "<masked>"


def make_mock_recommender(**kwargs):
    rec = SimpleNamespace()
    rec.corpus_path = kwargs.get("corpus_path", "mock_corpus.json")
    rec.pid_to_text = {
        "101": "Product: Organic Milk. Aisle: milk. Department: dairy eggs.",
        "102": "Product: Whole Wheat Bread. Aisle: bread. Department: bakery.",
        "103": "Product: Banana. Aisle: fresh fruits. Department: produce.",
    }
    rec.last_metrics = RecommendationMetrics(
        user_id="anonymous",
        query_embedding_time_ms=5.0,
        similarity_compute_time_ms=1.0,
        total_latency_ms=7.0,
        num_recommendations=3,
        top_score=0.9,
        avg_score=0.8,
        timestamp=time.time(),
    )
    rec.calls = []

    def recommend(
        query,
        top_k=10,
        user_id=None,
        exclude_product_ids=None,
        filter_aisles=None,
        filter_departments=None,
    ):
        rec.calls.append(
            {
                "query": query,
                "top_k": top_k,
                "user_id": user_id,
                "exclude_product_ids": exclude_product_ids,
                "filter_aisles": filter_aisles,
                "filter_departments": filter_departments,
            }
        )
        results = [("101", 0.9), ("102", 0.8), ("103", 0.7)]
        excluded = exclude_product_ids or set()
        return [(p, s) for p, s in results if p not in excluded][:top_k]

    rec.recommend = recommend
    return rec


def _mask(value):
    """A JSON body with its request ids and timestamps masked."""
    if isinstance(value, dict):
        return {k: MASKED if k in ("request_id", "timestamp") else _mask(v)
                for k, v in value.items()}
    if isinstance(value, list):
        return [_mask(v) for v in value]
    return value


def _families(text: str) -> list[tuple[str, str, str]]:
    return sorted((f.name, f.type, f.documentation) for f in text_string_to_metric_families(text))


def assert_same_response(ours, theirs, request_id_sent: bool) -> None:
    assert ours.status_code == theirs.status_code
    assert ours.media_type == theirs.media_type
    if ours.media_type == "application/json":
        assert _mask(ours.json()) == _mask(theirs.json())
    else:  # the Prometheus exposition: the same families (values: see the metrics test)
        assert _families(ours.body_bytes().decode()) == _families(theirs.body_bytes().decode())
    assert set(ours.headers) == set(theirs.headers)
    for name in ours.headers:
        if name == "X-Request-ID" and not request_id_sent:
            assert len(ours.headers[name]) == len(theirs.headers[name]) == 36
        else:
            assert ours.headers[name] == theirs.headers[name]


class Pair:
    """Sends each request to the port's app and to the JAX app, requires the
    same answer, and returns the port's."""

    def __init__(self, ours: TestClient, theirs: JaxTestClient):
        self.ours, self.theirs = ours, theirs

    @property
    def apps(self):
        return self.ours.app, self.theirs.app

    def request(self, method, path, json_body=None, headers=None):
        a = self.ours.request(method, path, json_body=json_body, headers=headers)
        b = self.theirs.request(method, path, json_body=json_body, headers=headers)
        sent = any(k.lower() == "x-request-id" for k in (headers or {}))
        assert_same_response(a, b, sent)
        return a

    def get(self, path, **kw):
        return self.request("GET", path, **kw)

    def post(self, path, json=None, **kw):
        return self.request("POST", path, json_body=json, **kw)

    def handle(self, method, path, headers, body):
        a = self.ours.app.handle(Request(method, path, headers, body))
        b = self.theirs.app.handle(JaxRequest(method, path, headers, body))
        assert_same_response(a, b, False)
        return a


@pytest.fixture()
def pair_of(tmp_path, monkeypatch):
    """Both apps on the mock factory, started, one feedback DB between them."""
    monkeypatch.setenv("FEEDBACK_DB_PATH", str(tmp_path / "feedback.db"))
    monkeypatch.delenv("API_KEY", raising=False)

    def make(**kw):
        kw = dict(model_dir=tmp_path, corpus_path=tmp_path / "c.json",
                  recommender_factory=make_mock_recommender, **kw)
        return Pair(TestClient(create_app(**kw)), JaxTestClient(jax_create_app(**kw)))

    made = []

    def start(**kw):
        made.append(make(**kw))
        return made[-1]

    yield start
    for p in made:
        p.ours.app.shutdown()
        p.theirs.app.shutdown()


@pytest.fixture()
def client(pair_of):
    return pair_of()


class TestProbes:
    def test_health(self, client):
        r = client.get("/health")
        assert r.status_code == 200
        assert r.json() == {"status": "ok"}

    def test_ready(self, client):
        r = client.get("/ready")
        assert r.status_code == 200
        assert r.json() == {"status": "ready"}

    def test_request_id_propagation(self, client):
        r = client.get("/health", headers={"X-Request-ID": "rid-123"})
        assert r.headers["X-Request-ID"] == "rid-123"

    def test_request_id_generated(self, client):
        r = client.get("/health")
        assert len(r.headers["X-Request-ID"]) > 10


class TestRecommend:
    def test_happy_path_user_context(self, client):
        r = client.post(
            "/recommend", json={"user_context": "[+7d w4h14] Organic Milk.", "top_k": 3}
        )
        assert r.status_code == 200
        body = r.json()
        assert len(body["recommendations"]) == 3
        assert body["recommendations"][0]["product_id"] == "101"
        assert body["recommendations"][0]["product_text"].startswith("Product: Organic Milk")
        assert body["purchase_history_used"] == "[+7d w4h14] Organic Milk."
        assert body["request_id"]
        assert body["stats"]["num_recommendations"] == 3

    def test_query_prepended_to_context(self, client):
        client.post(
            "/recommend", json={"query": "milk", "user_context": "CTX", "top_k": 1}
        )
        for app in client.apps:
            assert app.state["recommender"].calls[-1]["query"] == "milk CTX"

    def test_400_without_context(self, client):
        r = client.post("/recommend", json={"top_k": 5})
        assert r.status_code == 400

    def test_422_topk_out_of_range(self, client):
        r = client.post("/recommend", json={"user_context": "x", "top_k": 101})
        assert r.status_code == 422
        r = client.post("/recommend", json={"user_context": "x", "top_k": 0})
        assert r.status_code == 422

    def test_exclude_ids_passthrough(self, client):
        r = client.post(
            "/recommend",
            json={"user_context": "x", "top_k": 5, "exclude_product_ids": ["101"]},
        )
        assert r.status_code == 200
        pids = [it["product_id"] for it in r.json()["recommendations"]]
        assert "101" not in pids
        for app in client.apps:
            assert app.state["recommender"].calls[-1]["exclude_product_ids"] == {"101"}

    def test_category_filters_passthrough(self, client):
        r = client.post(
            "/recommend",
            json={
                "user_context": "x",
                "top_k": 5,
                "filter_aisles": ["milk"],
                "filter_departments": ["dairy eggs"],
            },
        )
        assert r.status_code == 200
        for app in client.apps:
            assert app.state["recommender"].calls[-1]["filter_aisles"] == ["milk"]
            assert app.state["recommender"].calls[-1]["filter_departments"] == ["dairy eggs"]

    def test_no_filters_means_no_filter_kwargs(self, client):
        r = client.post("/recommend", json={"user_context": "x", "top_k": 3})
        assert r.status_code == 200
        for app in client.apps:
            assert app.state["recommender"].calls[-1]["filter_aisles"] is None
            assert app.state["recommender"].calls[-1]["filter_departments"] is None

    def test_user_id_lookup_from_eval_queries(self, client, tmp_path):
        corpus_path = tmp_path / "c.json"
        corpus_path.write_text("{}")
        (tmp_path / "eval_queries.json").write_text(json.dumps({"42": "stored ctx"}))
        for app in client.apps:
            app.state["corpus_path"] = corpus_path
        r = client.post("/recommend", json={"user_id": "42"})
        assert r.status_code == 200
        assert r.json()["purchase_history_used"] == "stored ctx"


class TestAuth:
    def test_401_when_key_required(self, client, monkeypatch):
        monkeypatch.setenv("API_KEY", "sekret")
        r = client.post("/recommend", json={"user_context": "x"})
        assert r.status_code == 401

    def test_200_with_x_api_key(self, client, monkeypatch):
        monkeypatch.setenv("API_KEY", "sekret")
        r = client.post(
            "/recommend", json={"user_context": "x"}, headers={"X-API-Key": "sekret"}
        )
        assert r.status_code == 200

    def test_200_with_bearer(self, client, monkeypatch):
        monkeypatch.setenv("API_KEY", "sekret")
        r = client.post(
            "/recommend",
            json={"user_context": "x"},
            headers={"Authorization": "Bearer sekret"},
        )
        assert r.status_code == 200

    def test_401_wrong_key(self, client, monkeypatch):
        monkeypatch.setenv("API_KEY", "sekret")
        r = client.post(
            "/recommend", json={"user_context": "x"}, headers={"X-API-Key": "nope"}
        )
        assert r.status_code == 401

    def test_probes_unauthenticated(self, client, monkeypatch):
        monkeypatch.setenv("API_KEY", "sekret")
        assert client.get("/health").status_code == 200
        assert client.get("/ready").status_code == 200


class TestFeedback:
    def test_single_event_202(self, client):
        r = client.post(
            "/feedback",
            json={"request_id": "r1", "event_type": "click", "product_id": "101"},
        )
        assert r.status_code == 202
        assert r.json() == {"status": "accepted", "count": 1}

    def test_batch_202(self, client):
        events = [
            {"request_id": "r1", "event_type": "impression", "product_id": str(p)}
            for p in (101, 102)
        ] + [{"request_id": "r1", "event_type": "purchase", "product_id": "101"}]
        r = client.post("/feedback", json={"events": events})
        assert r.status_code == 202
        assert r.json()["count"] == 3

    def test_empty_batch_400(self, client):
        r = client.post("/feedback", json={"events": []})
        assert r.status_code == 400

    def test_invalid_event_type_422(self, client):
        r = client.post(
            "/feedback",
            json={"request_id": "r1", "event_type": "explode", "product_id": "101"},
        )
        assert r.status_code == 422

    def test_events_persisted_to_sqlite(self, client, tmp_path):
        client.post(
            "/feedback",
            json={"request_id": "rX", "event_type": "purchase", "product_id": "9"},
        )
        conn = sqlite3.connect(tmp_path / "feedback.db")
        rows = conn.execute(
            "SELECT request_id, event_type, product_id FROM feedback_events"
        ).fetchall()
        conn.close()
        # One row from each app, in the one schema.
        assert rows.count(("rX", "purchase", "9")) == 2


class TestCorpusUpload:
    def test_upload_200_and_swap(self, client):
        r = client.post("/admin/corpus", json={"corpus": {"1": "Product: A.", "2": "Product: B."}})
        assert r.status_code == 200
        assert r.json() == {"status": "ok", "n_products": 2}
        for app in client.apps:
            assert str(app.state["corpus_path"]).endswith(".json")

    def test_empty_corpus_422(self, client):
        r = client.post("/admin/corpus", json={"corpus": {}})
        assert r.status_code == 422

    def test_oversized_corpus_400(self, client, monkeypatch):
        monkeypatch.setenv("MAX_CORPUS_UPLOAD_PRODUCTS", "1")
        r = client.post("/admin/corpus", json={"corpus": {"1": "a", "2": "b"}})
        assert r.status_code == 400

    def test_auth_required_when_enabled(self, client, monkeypatch):
        monkeypatch.setenv("API_KEY", "sekret")
        r = client.post("/admin/corpus", json={"corpus": {"1": "a"}})
        assert r.status_code == 401


def _samples(text: str) -> dict:
    """Counter samples, histogram counts and gauges of an exposition, keyed
    by (sample name, labels); the time-dependent sums, buckets and
    ``_created`` stamps left out."""
    out = {}
    for family in text_string_to_metric_families(text):
        for s in family.samples:
            if s.name.endswith(("_created", "_sum", "_bucket")):
                continue
            out[s.name, tuple(sorted(s.labels.items()))] = s.value
    return out


def _buckets(text: str) -> dict:
    return {
        family.name: sorted({s.labels["le"] for s in family.samples if s.name.endswith("_bucket")})
        for family in text_string_to_metric_families(text) if family.type == "histogram"
    }


class TestMetricsEndpoint:
    def test_metric_names_exported(self, client):
        client.post("/recommend", json={"user_context": "x"})
        client.post(
            "/feedback",
            json={"request_id": "r", "event_type": "click", "product_id": "1"},
        )
        r = client.get("/metrics")
        assert r.status_code == 200
        text = r.body_bytes().decode()
        assert "recommendation_requests_total" in text
        assert "feedback_events_total" in text
        assert "recommendation_latency_seconds" in text
        assert "model_loaded 1.0" in text

    def test_error_counted(self, client):
        client.get("/metrics")
        client.post("/recommend", json={"top_k": 5})  # 400
        after = client.get("/metrics").body_bytes().decode()
        assert 'recommendation_requests_total{status="error"}' in after

    def test_exposition_moves_like_jax(self, client):
        """The same requests move the same counters by the same amounts in
        both registries (each package's own), with the same families,
        labels and histogram buckets."""
        assert port_metrics.API_REGISTRY is not jax_metrics.API_REGISTRY
        before = [_samples(c.get("/metrics").body_bytes().decode())
                  for c in (client.ours, client.theirs)]
        for body in ({"user_context": "x"}, {"user_context": "y", "top_k": 2}, {"top_k": 5},
                     {"user_context": "x", "top_k": 0}):
            client.post("/recommend", json=body)
        client.post("/feedback", json={"request_id": "r", "event_type": "click",
                                       "product_id": "1"})
        client.post("/feedback", json={"events": [
            {"request_id": "r", "event_type": t, "product_id": "2"}
            for t in ("impression", "impression", "purchase")
        ]})
        client.post("/feedback", json={"request_id": "r", "event_type": "boom",
                                       "product_id": "1"})
        client.post("/admin/corpus", json={"corpus": {"1": "Product: A."}})
        texts = [c.get("/metrics").body_bytes().decode() for c in (client.ours, client.theirs)]
        after = [_samples(t) for t in texts]
        moved = [{k: v - b.get(k, 0.0) for k, v in a.items() if v != b.get(k, 0.0)}
                 for a, b in zip(after, before)]
        assert moved[0] == moved[1]
        assert moved[0][("recommendation_requests_total", (("status", "success"),))] == 2
        assert moved[0][("recommendation_requests_total", (("status", "error"),))] == 2
        assert moved[0][("feedback_events_total", (("event_type", "impression"),))] == 2
        assert moved[0][("recommendation_latency_seconds_count", ())] == 2
        assert after[0][("model_loaded", ())] == after[1][("model_loaded", ())] == 1.0
        assert _families(texts[0]) == _families(texts[1])
        assert _buckets(texts[0]) == _buckets(texts[1])


class TestShutdownFlush:
    def test_shutdown_drains_request_context_writer(self, pair_of, tmp_path, monkeypatch):
        """Graceful shutdown commits queued request contexts BEFORE teardown:
        rows enqueued by the async writer must be readable right after the
        app context exits, without the reader calling the flush barrier."""
        db = tmp_path / "f.db"
        monkeypatch.setenv("FEEDBACK_DB_PATH", str(db))
        c = pair_of()
        r = c.post("/recommend", json={"user_context": "milk and bread"})
        assert r.status_code == 200
        c.ours.app.shutdown()
        c.theirs.app.shutdown()
        conn = sqlite3.connect(db)
        try:
            n = conn.execute("SELECT COUNT(*) FROM request_contexts").fetchone()[0]
        finally:
            conn.close()
        assert n == 2  # one context from each app's writer


class TestRateLimit:
    def test_429_after_limit(self, pair_of):
        c = pair_of(rate_limit="3/minute")
        for _ in range(3):
            assert c.post("/recommend", json={"user_context": "x"}).status_code == 200
        assert c.post("/recommend", json={"user_context": "x"}).status_code == 429
        # probes exempt
        assert c.get("/health").status_code == 200


def _http(port: int, method: str, path: str, body=None, headers=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
    try:
        payload = None if body is None else json.dumps(body).encode()
        hdrs = {"Content-Type": "application/json", **(headers or {})}
        conn.request(method, path, body=payload, headers=hdrs)
        resp = conn.getresponse()
        return resp.status, dict(resp.getheaders()), resp.read()
    finally:
        conn.close()


class TestRealSocketServer:
    def test_serve_over_http(self, client):
        answers = []
        for app, make in ((client.ours.app, make_server), (client.theirs.app, jax_make_server)):
            server = make(app, host="127.0.0.1", port=0)
            thread = threading.Thread(target=server.serve_forever, daemon=True)
            thread.start()
            try:
                port = server.server_address[1]
                status, _, body = _http(port, "GET", "/health")
                assert status == 200 and json.loads(body) == {"status": "ok"}
                status, headers, body = _http(
                    port, "POST", "/recommend", {"user_context": "milk", "top_k": 2}
                )
                assert status == 200
                assert len(json.loads(body)["recommendations"]) == 2
                answers.append((status, headers["Content-Type"], _mask(json.loads(body))))
            finally:
                server.shutdown()
                server.server_close()
                thread.join(timeout=10)
        assert answers[0] == answers[1]


class TestHttpFramework:
    def test_404_unknown_path(self, client):
        assert client.get("/nope").status_code == 404

    def test_405_wrong_method(self, client):
        assert client.get("/recommend").status_code == 405

    def test_invalid_json_422(self, client):
        resp = client.handle("POST", "/feedback", {"content-type": "application/json"},
                             b"{not json")
        assert resp.status_code == 422

    def test_empty_body_422(self, client):
        resp = client.handle("POST", "/recommend", {}, b"")
        assert resp.status_code == 422

    def test_unhandled_error_500(self, client):
        for app in client.apps:
            @app.post("/boom")
            def boom(request):
                raise RuntimeError("kaboom")

        resp = client.post("/boom", json={})
        assert resp.status_code == 500
        assert resp.json() == {"detail": "Internal Server Error"}


class TestConcurrency:
    def test_concurrent_requests_thread_safe(self, client):
        from concurrent.futures import ThreadPoolExecutor

        def hit(i):
            if i % 3 == 0:
                return client.post(
                    "/feedback",
                    json={"request_id": f"r{i}", "event_type": "click", "product_id": "1"},
                ).status_code
            return client.post(
                "/recommend", json={"user_context": f"ctx {i}", "top_k": 2}
            ).status_code

        with ThreadPoolExecutor(8) as ex:
            codes = list(ex.map(hit, range(60)))
        assert all(c in (200, 202) for c in codes)


class TestAdminModel:
    def test_model_swap_200(self, client, tmp_path):
        new_model = tmp_path / "run" / "final"
        new_model.mkdir(parents=True)
        (tmp_path / "run" / "best.json").write_text(
            '{"best_epoch": 2, "metric": "ndcg_at_10", "entry": {"ndcg_at_10": 0.3}}'
        )
        r = client.post("/admin/model", json={"model_dir": str(new_model)})
        assert r.status_code == 200
        body = r.json()
        assert body["status"] == "ok"
        assert body["model_dir"] == str(new_model)
        assert body["best"]["entry"]["ndcg_at_10"] == 0.3
        for app in client.apps:
            assert str(app.state["model_dir"]) == str(new_model)

    def test_model_swap_missing_dir_400(self, client, tmp_path):
        r = client.post("/admin/model", json={"model_dir": str(tmp_path / "nope")})
        assert r.status_code == 400

    def test_model_swap_empty_422(self, client):
        r = client.post("/admin/model", json={"model_dir": ""})
        assert r.status_code == 422

    def test_model_swap_requires_api_key(self, client, tmp_path, monkeypatch):
        monkeypatch.setenv("API_KEY", "sek")
        new_model = tmp_path / "m"
        new_model.mkdir()
        r = client.post("/admin/model", json={"model_dir": str(new_model)})
        assert r.status_code == 401
        r = client.post(
            "/admin/model",
            json={"model_dir": str(new_model)},
            headers={"X-API-Key": "sek"},
        )
        assert r.status_code == 200

    def test_failed_load_keeps_old_model(self, client, tmp_path):
        old = [app.state["recommender"] for app in client.apps]

        def broken_factory(**kwargs):
            raise RuntimeError("bad checkpoint")

        for app in client.apps:
            app.state["recommender_factory"] = broken_factory
        new_model = tmp_path / "m2"
        new_model.mkdir()
        r = client.post("/admin/model", json={"model_dir": str(new_model)})
        assert r.status_code == 500
        assert [app.state["recommender"] for app in client.apps] == old


# --------------------------------------------------------------- end to end

TOWER = JaxTowerConfig(
    vocab_size=0, hidden_size=64, num_layers=2, num_heads=2, intermediate_size=128,
    max_position=64, max_seq_length=32, compute_dtype="float32",
)
AISLES = ["fresh fruits", "milk", "bread", "cereal", "coffee", "pasta sauce"]
QUERIES = {
    "7": "[+7d w4h14] Organic Milk 3, Whole Wheat Bread 8.",
    "8": "[+3d w1h9] Banana 11, Greek Yogurt 40, Honey.",
}


def _corpus(n=200, prefix="1"):
    adjs = ["Organic", "Fresh", "Whole", "Crunchy", "Roasted"]
    nouns = ["Milk", "Bread", "Banana", "Yogurt", "Coffee", "Granola", "Pasta"]
    return {
        f"{prefix}{i:03d}": f"Product: {adjs[i % 5]} {nouns[i % 7]} {i}. "
        f"Aisle: {AISLES[i % 6]}. Department: d{i % 4}."
        for i in range(n)
    }


def _write_tower(model_dir, corpus, seed):
    tok = JaxWordPieceTokenizer.train(corpus.values(), vocab_size=600, min_frequency=1)
    cfg = dataclasses.replace(TOWER, vocab_size=tok.vocab_size)
    jax_save_tower(model_dir, jax_init_params(cfg, jax.random.key(seed)), cfg, tok)
    return model_dir


@pytest.fixture(scope="module")
def towers(tmp_path_factory):
    """One corpus (with eval_queries.json beside it) and two towers written
    by the JAX package, with other seeded weights."""
    base = tmp_path_factory.mktemp("api_e2e")
    corpus = _corpus()
    corpus_path = base / "eval_corpus.json"
    corpus_path.write_text(json.dumps(corpus))
    (base / "eval_queries.json").write_text(json.dumps(QUERIES))
    return SimpleNamespace(
        base=base, corpus=corpus, corpus_path=corpus_path,
        model=_write_tower(base / "model", corpus, seed=7),
        model2=_write_tower(base / "model2", corpus, seed=11),
    )


@pytest.fixture(scope="module")
def module_env(towers):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("FEEDBACK_DB_PATH", str(towers.base / "feedback.db"))
        mp.delenv("API_KEY", raising=False)
        mp.delenv("BATCH_WINDOW_MS", raising=False)
        mp.delenv("RATE_LIMIT", raising=False)
        yield mp


def _start_port_app(towers, **kw):
    """The port's app with its default factory, started with
    INFERENCE_DEVICE=cpu."""
    app = create_app(model_dir=towers.model, corpus_path=towers.corpus_path,
                     rate_limit="1000000/minute", **kw)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("INFERENCE_DEVICE", "cpu")
        return TestClient(app)


@pytest.fixture(scope="module")
def e2e(towers, module_env):
    """The JAX app on its MonitoredRecommender (one-device mesh, so lone
    requests take its fused pipeline) and the port's app with its default
    factory on the CPU, over the same tower and corpus."""
    mesh = build_mesh(MeshConfig(data_parallel=1, model_parallel=1))
    factory = functools.partial(jax_recommender.MonitoredRecommender, use_index=False, mesh=mesh)
    theirs = JaxTestClient(jax_create_app(
        model_dir=towers.model, corpus_path=towers.corpus_path, recommender_factory=factory,
        rate_limit="1000000/minute",
    ))
    ours = _start_port_app(towers)
    yield ours, theirs
    ours.app.shutdown()
    theirs.app.shutdown()


def _ranked(body) -> tuple[list[str], list[float]]:
    recs = body["recommendations"]
    return [r["product_id"] for r in recs], [r["score"] for r in recs]


E2E_REQUESTS = {
    "user_context": {"user_context": QUERIES["8"], "top_k": 10},
    "user_id": {"user_id": "7", "top_k": 10},
    "query": {"query": "organic milk", "user_id": "8", "top_k": 6},
    "exclusions": {"user_context": QUERIES["7"], "top_k": 10,
                   "exclude_product_ids": ["1000", "1001", "1013"]},
    "filters": {"user_context": QUERIES["7"], "top_k": 8,
                "filter_aisles": ["milk", "coffee"], "filter_departments": ["d1"]},
}


@pytest.mark.parametrize("name", sorted(E2E_REQUESTS))
def test_recommend_matches_jax_end_to_end(e2e, name):
    ours, theirs = e2e
    body = E2E_REQUESTS[name]
    a, b = ours.post("/recommend", json=body), theirs.post("/recommend", json=body)
    assert a.status_code == b.status_code == 200
    ja, jb = a.json(), b.json()
    ids_a, scores_a = _ranked(ja)
    ids_b, scores_b = _ranked(jb)
    assert ids_a == ids_b and len(ids_a) == body["top_k"]
    np.testing.assert_allclose(scores_a, scores_b, atol=1e-5)
    assert ja["purchase_history_used"] == jb["purchase_history_used"]
    assert [r["product_text"] for r in ja["recommendations"]] == [
        r["product_text"] for r in jb["recommendations"]]
    sa, sb = ja["stats"], jb["stats"]
    assert (sa["num_recommendations"], sa["stage_timing_source"]) == (
        sb["num_recommendations"], sb["stage_timing_source"])
    assert not set(body.get("exclude_product_ids", ())) & set(ids_a)
    if name == "filters":
        assert all("Department: d1." in t and ("Aisle: milk." in t or "Aisle: coffee." in t)
                   for t in (r["product_text"] for r in ja["recommendations"]))
    # The serving device is the one INFERENCE_DEVICE named at startup.
    assert ours.app.state["device"].type == "cpu"


def test_corpus_hot_swap_reuses_the_live_encoder(towers, module_env, monkeypatch):
    ours = _start_port_app(towers)
    live = ours.app.state["recommender"]
    new_corpus = _corpus(60, prefix="9")

    def no_load(*args, **kwargs):
        raise AssertionError("the hot swap reloaded the tower")

    monkeypatch.setattr(TextEncoder, "load", no_load)
    r = ours.post("/admin/corpus", json={"corpus": new_corpus})
    assert r.status_code == 200 and r.json() == {"status": "ok", "n_products": 60}
    swapped = ours.app.state["recommender"]
    assert swapped is not live and swapped.encoder is live.encoder
    assert swapped.device == live.device
    monkeypatch.undo()
    direct = Recommender(towers.model, ours.app.state["corpus_path"], use_index=False,
                         device="cpu")
    for q in QUERIES.values():
        got = ours.post("/recommend", json={"user_context": q, "top_k": 10}).json()
        ids, scores = _ranked(got)
        assert all(p.startswith("9") for p in ids)
        want = direct.recommend(q, top_k=10)
        assert ids == [p for p, _ in want]
        np.testing.assert_allclose(scores, [s for _, s in want], atol=1e-6)
    ours.app.shutdown()


def test_corpus_swap_reloads_retrained_checkpoint(towers, module_env, tmp_path):
    """The fast path reuses the live encoder only while the checkpoint files
    are unchanged: retraining into the same dir and then uploading a corpus
    loads the new weights from disk."""
    import shutil

    model_dir = tmp_path / "model"
    shutil.copytree(towers.model, model_dir)
    app = create_app(model_dir=model_dir, corpus_path=towers.corpus_path)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("INFERENCE_DEVICE", "cpu")
        ours = TestClient(app)
    assert ours.post("/admin/corpus", json={"corpus": _corpus(30, "2")}).status_code == 200
    reused = app.state["recommender"].encoder
    shutil.rmtree(model_dir)
    shutil.copytree(towers.model2, model_dir)
    assert ours.post("/admin/corpus", json={"corpus": _corpus(30, "3")}).status_code == 200
    after = app.state["recommender"].encoder
    assert after is not reused, "stale encoder reused after retrain"
    fresh = TextEncoder.load(model_dir, device="cpu")
    np.testing.assert_array_equal(after.encode_device([QUERIES["7"]]).numpy(),
                                  fresh.encode_device([QUERIES["7"]]).numpy())
    want = Recommender(model_dir, app.state["corpus_path"], use_index=False, device="cpu")
    got = ours.post("/recommend", json={"user_context": QUERIES["7"], "top_k": 5}).json()
    assert _ranked(got)[0] == [p for p, _ in want.recommend(QUERIES["7"], top_k=5)]
    ours.app.shutdown()


def test_model_swap_follows_the_new_tower(towers, module_env):
    ours = _start_port_app(towers)
    q = {"user_context": QUERIES["8"], "top_k": 10}
    before = _ranked(ours.post("/recommend", json=q).json())
    r = ours.post("/admin/model", json={"model_dir": str(towers.model2)})
    assert r.status_code == 200 and r.json()["model_dir"] == str(towers.model2)
    after = _ranked(ours.post("/recommend", json=q).json())
    want = Recommender(towers.model2, towers.corpus_path, use_index=False, device="cpu")
    assert after[0] == [p for p, _ in want.recommend(QUERIES["8"], top_k=10)]
    np.testing.assert_allclose(after[1], [s for _, s in want.recommend(QUERIES["8"], top_k=10)],
                               atol=1e-6)
    assert after != before
    assert ours.post("/admin/model", json={"model_dir": str(towers.base / "nope")}
                     ).status_code == 400
    ours.app.shutdown()


def test_startup_without_cuda_raises(towers, module_env, monkeypatch):
    """No CUDA and no INFERENCE_DEVICE=cpu: the default factory refuses to
    load at startup, and an on-demand load answers 503; neither serves on
    the CPU."""
    monkeypatch.delenv("INFERENCE_DEVICE", raising=False)
    app = create_app(model_dir=towers.model, corpus_path=towers.corpus_path)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TestClient(app)
    assert app.state.get("recommender") is None
    monkeypatch.setenv("MODEL_DIR", str(towers.model))
    monkeypatch.setenv("CORPUS_PATH", str(towers.corpus_path))
    lazy = create_app(load_model_on_startup=False)
    with TestClient(lazy) as client:
        r = client.post("/recommend", json={"user_context": QUERIES["7"]})
        assert r.status_code == 503 and "CUDA is not available" in r.json()["detail"]
    assert lazy.state.get("recommender") is None


def test_recommend_correct_during_corpus_swaps(towers, module_env):
    """Corpus swaps racing live /recommend traffic: every answer comes from
    one corpus generation, none fails, and the last swap serves."""
    ours = _start_port_app(towers)
    ours.post("/admin/corpus", json={"corpus": _corpus(20, "1")})
    stop = threading.Event()
    errors: list[str] = []
    seen: set[str] = set()

    def requester(i: int) -> None:
        while not stop.is_set():
            r = ours.post("/recommend", json={"user_context": f"Organic Milk {i}", "top_k": 5})
            if r.status_code != 200:
                errors.append(f"status {r.status_code}: {r.json()}")
                return
            gens = {p[0] for p in _ranked(r.json())[0]}
            if len(gens) != 1:
                errors.append(f"mixed-generation response: {gens}")
                return
            seen.add(gens.pop())

    def wait_until_served(gen: str) -> None:
        deadline = time.monotonic() + 60
        while gen not in seen and not errors and time.monotonic() < deadline:
            time.sleep(0.005)

    threads = [threading.Thread(target=requester, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    try:
        for g in range(2, 5):
            wait_until_served(str(g - 1))  # live traffic saw the generation before
            r = ours.post("/admin/corpus", json={"corpus": _corpus(20, str(g))})
            assert r.status_code == 200, r.json()
        wait_until_served("4")
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors[:5]
    final = ours.post("/recommend", json={"user_context": "Organic Milk", "top_k": 5})
    assert {p[0] for p in _ranked(final.json())[0]} == {"4"}
    assert seen == {"1", "2", "3", "4"}, seen
    ours.app.shutdown()
