"""The port's user workflows (``scripts/torch_*.py``) against the JAX
package's scripts on the CPU: feedback analytics, the sample-feedback load
generator (the same requests and funnel for a seed, over HTTP), the
feedback retrain loop (mining, the ``_fb`` dataset, the gate, and one run
that deploys through a live port app), the collapse diagnostics, the
real-data runbook's checks and a tiny end-to-end run, the demo's stages,
the tower revalidation, and the CUDA container files."""

import dataclasses
import io
import json
import re
import sqlite3
import sys
import threading
from contextlib import redirect_stdout
from datetime import datetime
from pathlib import Path

import numpy as np
import pytest
import torch

import scripts.compare_untrained_vs_trained as jax_compare
import scripts.feedback_analytics as jax_fa
import scripts.feedback_retrain as jax_fr
import scripts.generate_sample_feedback as jax_gen
import scripts.real_data_run as jax_rd
import scripts.torch_compare_untrained_vs_trained as compare
import scripts.torch_feedback_analytics as fa
import scripts.torch_feedback_retrain as fr
import scripts.torch_generate_sample_feedback as gen
import scripts.torch_real_data_run as rd
import scripts.torch_reval_tower as reval
import scripts.torch_run_demo as demo
from instacart_next_order_recommendation_tpu.models.text_encoder import (
    TextEncoder as JaxTextEncoder,
)
from instacart_next_order_recommendation_tpu_torch.api.app import create_app
from instacart_next_order_recommendation_tpu_torch.api.feedback_store import (
    FeedbackEventRecord,
    flush_request_contexts,
    init_db,
    record_events,
    record_request_context,
)
from instacart_next_order_recommendation_tpu_torch.api.http import TestClient, make_server
from instacart_next_order_recommendation_tpu_torch.data import InstacartDataPrep
from instacart_next_order_recommendation_tpu_torch.data.synthetic import generate_instacart_csvs
from instacart_next_order_recommendation_tpu_torch.models.text_encoder import TextEncoder
from instacart_next_order_recommendation_tpu_torch.serve import Recommender
from instacart_next_order_recommendation_tpu_torch.train import trainer as trainer_mod
from tests.helpers import make_tiny_model_dir
from tests.test_torch_api import make_mock_recommender

REPO = Path(__file__).resolve().parents[1]
TINY_PRESET = dict(
    hidden_size=32, num_layers=2, num_heads=2, intermediate_size=64, max_position=128,
    compute_dtype="float32",
)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for these tiny towers, as the distributed tests
    set: with a thread per core in every test worker, the trainers' small
    products spin on cores the other workers hold (100x slower seen)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Synthetic CSVs, their prep (p5_mp20_ef0.15) and a tiny tower written
    by the JAX package on the prep's corpus."""
    base = tmp_path_factory.mktemp("workflows")
    data = generate_instacart_csvs(base / "data", n_users=60, n_products=80, seed=0)
    prep = InstacartDataPrep(data_dir=data, output_dir=base / "processed", eval_frac=0.15)
    prep.prepare()
    processed = prep.effective_output_dir()
    corpus = json.loads((processed / "eval_corpus.json").read_text())
    model = make_tiny_model_dir(base / "tower", corpus)
    return dict(base=base, data=data, processed=processed, corpus=corpus, model=model)


class Served:
    """A port app on ``make_server`` at a free local port, in a thread."""

    def __init__(self, app):
        self.app = app
        self.server = make_server(app, "127.0.0.1", 0)
        self.url = f"http://127.0.0.1:{self.server.server_address[1]}"
        self.thread = threading.Thread(target=self.server.serve_forever, daemon=True)
        self.thread.start()

    def close(self):
        self.server.shutdown()
        self.server.server_close()
        self.thread.join(timeout=30)
        self.app.shutdown()


def _events_db(tmp_path, monkeypatch) -> Path:
    """One feedback DB: server-side contexts, echoed metadata, duplicates,
    events without a request id, several days."""
    monkeypatch.setenv("FEEDBACK_DB_PATH", str(tmp_path / "f.db"))
    db = init_db()
    record_request_context("r1", "[+2d w3h10] Bread, Milk.", "u1")
    record_request_context("r2", "[+5d w1h9] Coffee.")
    flush_request_contexts()
    day = lambda d: datetime(2026, 3, d, 12, 0)  # noqa: E731
    record_events([
        FeedbackEventRecord("r1", "impression", "5", created_at=day(1)),
        FeedbackEventRecord("r1", "impression", "5", created_at=day(1)),
        FeedbackEventRecord("r1", "impression", "6", created_at=day(2)),
        FeedbackEventRecord("r1", "click", "5", created_at=day(2)),
        FeedbackEventRecord("r1", "add_to_cart", "5", created_at=day(3),
                            metadata={"user_context": "echoed"}),
        FeedbackEventRecord("r1", "purchase", "5", created_at=day(3)),
        FeedbackEventRecord("r2", "impression", "7", created_at=day(4)),
        FeedbackEventRecord("r2", "click", "7", created_at=day(4)),
        FeedbackEventRecord("r9", "click", "6", created_at=day(5),
                            metadata={"user_context": "client ctx"}),
        FeedbackEventRecord("r9", "purchase", "404", created_at=day(5),
                            metadata={"user_context": "client ctx"}),
        FeedbackEventRecord("r8", "click", "6", created_at=day(6), metadata={"other": 1}),
        FeedbackEventRecord(None, "impression", "8", created_at=day(6)),
    ])
    return db


# ---------------------------------------------------------------- analytics


@pytest.mark.parametrize("since", [None, "2026-03-03"])
def test_feedback_analytics_matches_jax(tmp_path, monkeypatch, since):
    db = _events_db(tmp_path, monkeypatch)
    events = fa.load_events(db, since=since)
    assert events == jax_fa.load_events(db, since=since) and events
    assert fa.compute_aggregate_metrics(events) == jax_fa.compute_aggregate_metrics(events)
    assert fa.compute_funnel_per_request(events) == jax_fa.compute_funnel_per_request(events)
    config = tmp_path / "fa.yaml"
    config.write_text(f"db_path: {db}\nsince: {since or 'null'}\nshow_funnel_sample: 2\n")
    assert fa.load_config(config) == jax_fa.load_config(config)

    def printed(main, argv) -> str:
        out = io.StringIO()
        with redirect_stdout(out):
            main(argv)
        return out.getvalue()

    monkeypatch.setattr(sys, "argv", ["fa", "--config", str(config)])
    theirs = printed(lambda argv: jax_fa.main(), None)
    assert printed(fa.main, ["--config", str(config)]) == theirs
    assert "Per-request funnel" in theirs


# ---------------------------------------------------------------- retrain


def test_retrain_mining_and_gate_match_jax(tmp_path, monkeypatch):
    db = _events_db(tmp_path, monkeypatch)
    for since in (None, "2026-03-03"):
        ours = fr.extract_context_events(db, since=since)
        assert ours == jax_fr.extract_context_events(db, since=since) and ours
    corpus = {"5": "Product: A.", "6": "Product: B.", "7": "Product: C."}
    events = fr.extract_context_events(db)
    for weights in (None, {"purchase": 1, "click": 2, "impression": 1}):
        assert fr.build_weighted_pairs(events, corpus, weights) == (
            jax_fr.build_weighted_pairs(events, corpus, weights)
        )
    for last in (0, 3, 12, 50):
        assert fr.count_new_events(db, last) == jax_fr.count_new_events(db, last)
    assert fr.count_new_events(tmp_path / "none.db", 4) == jax_fr.count_new_events(
        tmp_path / "none.db", 4
    )

    run = tmp_path / "run"
    run.mkdir()
    for state in ({}, {"deployed_metric": 0.3}, {"deployed_metric": 0.5}):
        for min_improvement in (0.0, 0.1, -0.3):
            assert fr.check_eval_gate(run, state, "ndcg_at_10", min_improvement) == (
                jax_fr.check_eval_gate(run, state, "ndcg_at_10", min_improvement)
            )  # no best.json yet
            (run / "best.json").write_text(json.dumps({"entry": {"ndcg_at_10": 0.4}}))
            for metric in ("ndcg_at_10", "recall_at_10"):
                assert fr.check_eval_gate(run, state, metric, min_improvement) == (
                    jax_fr.check_eval_gate(run, state, metric, min_improvement)
                )
            (run / "best.json").unlink()
    state_file = tmp_path / "state.json"
    assert fr.load_scheduler_state(state_file) == jax_fr.load_scheduler_state(state_file)
    state_file.write_text("{not json")
    assert fr.load_scheduler_state(state_file) == jax_fr.load_scheduler_state(state_file)


def test_build_dataset_matches_jax_including_the_fb_rule(world, tmp_path, monkeypatch):
    from datasets import load_from_disk

    import shutil

    processed = tmp_path / "processed" / world["processed"].name
    shutil.copytree(world["processed"], processed)
    monkeypatch.setenv("FEEDBACK_DB_PATH", str(tmp_path / "f.db"))
    db = init_db()
    pids = list(world["corpus"])
    for i in range(6):
        record_request_context(f"r{i}", f"[+{i}d w1h9] context {i}")
    flush_request_contexts()
    record_events(
        [FeedbackEventRecord(f"r{i}", t, pids[i]) for i in range(6)
         for t in ("impression", "click", "purchase")[: 1 + i % 3]]
        + [FeedbackEventRecord("rx", "add_to_cart", pids[9], metadata={"user_context": "echo"})]
    )

    def columns(d):
        ds = load_from_disk(str(d / "train_dataset"))
        return list(ds["anchor"]), list(ds["positive"])

    ours = fr.build_dataset(processed, db, output_dir=tmp_path / "ours")
    theirs = jax_fr.build_dataset(processed, db, output_dir=tmp_path / "theirs")
    assert columns(ours) == columns(theirs)
    for name in ("eval_queries.json", "eval_corpus.json", "eval_relevant_docs.json",
                 "data_prep_params.json"):
        assert (ours / name).read_bytes() == (theirs / name).read_bytes()
    n_base = len(load_from_disk(str(processed / "train_dataset")))
    assert len(columns(ours)[0]) == n_base + (0 + 1 + 4) * 2 + 2  # click 1, purchase 3, atc 2

    # The default output is <processed>_fb; given that _fb dir as input, each
    # package merges against the base again instead of compounding.
    fb = fr.build_dataset(processed, db)
    assert fb == processed.parent / f"{processed.name}_fb"
    again = columns(fr.build_dataset(fb, db, output_dir=tmp_path / "ours_again"))
    assert again == columns(jax_fr.build_dataset(fb, db, output_dir=tmp_path / "theirs_again"))
    assert again == columns(ours)
    monkeypatch.setenv("FEEDBACK_DB_PATH", str(tmp_path / "empty.db"))
    assert fr.build_dataset(processed, init_db()) is None


# ---------------------------------------------------------------- sample feedback


@pytest.mark.parametrize("seed", [0, 5])
def test_funnel_events_match_jax(seed):
    import random

    for context in (None, "[+1d w0h12] Coffee."):
        args = ("req", ["101", "102", "103", "104"])
        ours = gen.build_funnel_events(*args, random.Random(seed), 0.6, 0.5, 0.7, context)
        theirs = jax_gen.build_funnel_events(*args, random.Random(seed), 0.6, 0.5, 0.7, context)
        assert ours == theirs


@pytest.mark.parametrize("eval_users", [False, True], ids=["sample_contexts", "eval_users"])
def test_sample_feedback_sends_the_jax_sequence(world, tmp_path, monkeypatch, eval_users):
    """Both generators against one port app (mock recommender) over HTTP,
    each into its own feedback DB: the same requests, funnel events and
    stored contexts for one seed."""
    processed_root = world["processed"].parent if eval_users else tmp_path / "no_processed"
    monkeypatch.setattr(gen, "DEFAULT_PROCESSED_DIR", processed_root)
    monkeypatch.setattr(jax_gen, "DEFAULT_PROCESSED_DIR", processed_root)
    monkeypatch.delenv("API_KEY", raising=False)
    monkeypatch.setenv("FEEDBACK_DB_PATH", str(tmp_path / "boot.db"))
    calls = []

    def factory(**kw):
        rec = make_mock_recommender(**kw)
        rec.calls = calls
        return rec

    served = Served(create_app(
        model_dir=tmp_path, corpus_path=world["processed"] / "eval_corpus.json",
        recommender_factory=factory, rate_limit="100000/minute",
    ))
    config = tmp_path / "gen.yaml"
    config.write_text(f"url: {served.url}\nnum_requests: 6\nseed: 3\nclick_rate: 0.6\ntop_k: 3\n")
    sent = {}
    try:
        for name, run in (
            ("jax", lambda: jax_gen.main()),
            ("port", lambda: gen.main(["--config", str(config)])),
        ):
            monkeypatch.setenv("FEEDBACK_DB_PATH", str(tmp_path / f"{name}.db"))
            monkeypatch.setattr(sys, "argv", ["gen", "--config", str(config)])
            calls.clear()
            run()
            flush_request_contexts()
            conn = sqlite3.connect(tmp_path / f"{name}.db")
            sent[name] = (
                [dict(c) for c in calls],
                conn.execute("SELECT event_type, product_id, metadata FROM feedback_events "
                             "ORDER BY id").fetchall(),
                conn.execute("SELECT user_id, user_context FROM request_contexts").fetchall(),
            )
            conn.close()
    finally:
        served.close()
    assert sent["port"] == sent["jax"]
    assert len(sent["port"][0]) == 6 and len(sent["port"][1]) >= 18
    assert all((uid is not None) == eval_users for uid, _ in sent["port"][2])
    assert gen.load_config(config) == jax_gen.load_config(config)


def test_sample_feedback_unreachable_api_exits_1(tmp_path):
    config = tmp_path / "gen.yaml"
    config.write_text("url: http://127.0.0.1:9\nnum_requests: 1\n")
    assert gen.main(["--config", str(config)]) == 1


# ---------------------------------------------------------------- diagnostics


def test_collapse_metrics_match_jax():
    rng = np.random.default_rng(4)
    for n_q, n_c in ((40, 70), (1, 5), (3, 2)):
        q = rng.normal(size=(n_q, 24)).astype(np.float32)
        c = rng.normal(size=(n_c, 24)).astype(np.float32)
        q /= np.linalg.norm(q, axis=1, keepdims=True)
        c /= np.linalg.norm(c, axis=1, keepdims=True)
        ours = compare.embedding_collapse_metrics(q, c, "trained", sample_pairs=300)
        theirs = jax_compare.embedding_collapse_metrics(q, c, "trained", sample_pairs=300)
        assert ours.keys() == theirs.keys()
        for key in ours:
            assert abs(ours[key] - theirs[key]) <= 1e-6, key


def test_evaluate_encoder_matches_jax(world):
    queries = json.loads((world["processed"] / "eval_queries.json").read_text())
    relevant = {
        k: set(v)
        for k, v in json.loads((world["processed"] / "eval_relevant_docs.json").read_text()).items()
    }
    ours = compare.evaluate_encoder(
        TextEncoder.load(world["model"], device="cpu"), queries, world["corpus"], relevant, 16
    )
    theirs = jax_compare.evaluate_encoder(
        JaxTextEncoder.load(world["model"]), queries, world["corpus"], relevant, 16
    )
    assert ours[0].keys() == theirs[0].keys()
    for key in ours[0]:
        assert abs(ours[0][key] - theirs[0][key]) <= 1e-5, key
    np.testing.assert_allclose(ours[1], np.asarray(theirs[1]), atol=1e-5)
    np.testing.assert_allclose(ours[2], np.asarray(theirs[2]), atol=1e-5)


def test_compare_main_prints_the_jax_readings(world, tmp_path, monkeypatch):
    """Both CLIs on one config (the untrained tower a second seeded
    checkpoint): the same report, each number within 1e-4."""
    untrained = make_tiny_model_dir(tmp_path / "untrained", world["corpus"], seed=3)
    config = tmp_path / "compare.yaml"
    config.write_text(
        f"processed_dir: {world['processed']}\nmodel_dir: {world['model']}\n"
        f"base_model: {untrained}\nbatch_size: 16\nsample_queries: 6\n"
    )
    out_ours, out_theirs = io.StringIO(), io.StringIO()
    with redirect_stdout(out_ours):
        assert compare.main(["--config", str(config), "--device", "cpu"]) == 0
    monkeypatch.setattr(sys, "argv", ["compare", "--config", str(config)])
    with redirect_stdout(out_theirs):
        jax_compare.main()
    number = r"[-+]?\d+\.\d+"
    ours, theirs = out_ours.getvalue(), out_theirs.getvalue()
    assert re.sub(number, "#", ours) == re.sub(number, "#", theirs)
    got = [float(x) for x in re.findall(number, ours)]
    want = [float(x) for x in re.findall(number, theirs)]
    assert len(got) == len(want) > 20
    assert all(abs(a - b) <= 1e-4 for a, b in zip(got, want)), (got, want)
    assert "corpus mean pairwise cos_sim" in ours


# ---------------------------------------------------------------- real-data runbook


def _layouts(tmp_path):
    data, model = tmp_path / "data", tmp_path / "model"
    yield data, model  # nothing there
    data.mkdir()
    (data / "orders.csv").write_text("order_id\n")
    yield data, model
    for name in rd.REQUIRED_CSVS:
        (data / name).write_text("x\n")
    model.mkdir()
    (model / "config.json").write_text("{}")
    yield data, model
    (model / "model.safetensors").write_bytes(b"")
    (model / "vocab.txt").write_text("[PAD]\n")
    yield data, model


def test_real_data_checks_match_jax(tmp_path, capsys):
    for data, model in _layouts(tmp_path):
        assert rd.check_prerequisites(data, model) == jax_rd.check_prerequisites(data, model)
        argv = ["--check", "--data-dir", str(data), "--base-model", str(model)]
        rc_theirs = jax_rd.main(argv)
        theirs = capsys.readouterr().out
        assert rd.main(argv) == rc_theirs
        assert capsys.readouterr().out.replace("torch_real_data_run", "real_data_run") == theirs
    assert rc_theirs == 0
    history = [{"epoch": 1, "ndcg_at_10": 0.1, "recall_at_10": 0.05}, {"epoch": 3, "mrr_at_10": 0.2}]
    assert rd.format_table(history) == jax_rd.format_table(history)
    rows = {"content_based": dict.fromkeys(rd.METRIC_KEYS, 0.25)}
    assert rd.format_baseline_table(rows) == jax_rd.format_baseline_table(rows)
    assert rd.REFERENCE_EPOCHS == jax_rd.REFERENCE_EPOCHS
    assert rd.REFERENCE_BASELINES == jax_rd.REFERENCE_BASELINES


def _tiny_bert_dir(path: Path, data_dir: Path) -> Path:
    """A tiny BERT checkpoint in the sentence-transformers layout, its vocab
    covering the synthetic product words."""
    import torch
    from transformers import BertConfig, BertModel

    words = sorted(
        {
            w.lower().strip(".,:;()")
            for line in (data_dir / "products.csv").read_text().splitlines()[1:]
            for w in line.replace(",", " ").split()
        }
        | {"product", "aisle", "department", "next", "w", "d", "h"}
    )
    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]"] + words + [f"##{w}" for w in words]
    cfg = BertConfig(vocab_size=len(vocab), hidden_size=16, num_hidden_layers=1,
                     num_attention_heads=2, intermediate_size=32, max_position_embeddings=64)
    torch.manual_seed(0)
    model = BertModel(cfg)
    path.mkdir()
    (path / "config.json").write_text(cfg.to_json_string())
    torch.save({f"0.auto_model.{k}": v for k, v in model.state_dict().items()},
               path / "pytorch_model.bin")
    (path / "vocab.txt").write_text("\n".join(vocab) + "\n")
    return path


def test_real_data_defaults_are_not_the_jax_runbooks(monkeypatch):
    # The JAX runbook's parser, as its main builds it (captured before it
    # parses), against the port's: a port run with the defaults writes
    # nothing where a JAX run with its defaults does.
    import argparse

    built = []

    def capture(parser, *args, **kwargs):
        built.append(parser)
        raise SystemExit(0)

    with monkeypatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_args", capture)
        with pytest.raises(SystemExit):
            jax_rd.main([])
    theirs = built[0].parse_known_args([])[0]
    ours = rd.build_parser().parse_args([])
    assert (theirs.workdir, theirs.results) == (Path("real_ws"), Path("REAL_RESULTS.md"))
    assert ours.workdir == Path("torch_real_ws") and ours.results is None
    assert ours.workdir != theirs.workdir
    assert ours.workdir / "REAL_RESULTS.md" != theirs.results
    # The same flags, and --device.
    ours_flags = {a.dest for a in rd.build_parser()._actions}
    assert ours_flags - {"device"} == {a.dest for a in built[0]._actions}


def test_real_data_runbook_end_to_end_tiny(world, tmp_path, capsys):
    model_dir = _tiny_bert_dir(tmp_path / "minilm", world["data"])
    results = tmp_path / "out" / "REAL_RESULTS.md"
    results.parent.mkdir()
    rc = rd.main([
        "--data-dir", str(world["data"]), "--base-model", str(model_dir),
        "--workdir", str(tmp_path / "ws"), "--epochs", "1", "--train-batch-size", "16",
        "--max-seq-length", "32", "--steps-per-dispatch", "1", "--results", str(results),
        "--device", "cpu",
    ])
    assert rc == 0
    report = results.read_text()
    assert "ndcg_at_10" in report and "/ 0.153" in report
    assert "Item-item CF (ours / ref)" in report and "Collapse diagnostics" in report
    out = capsys.readouterr().out
    assert "=== 5/5 Side-by-side vs reference" in out
    history = json.loads((tmp_path / "ws" / "model" / "eval_history.json").read_text())
    assert [h["epoch"] for h in history] == [1] and "ndcg_at_10" in history[0]


# ---------------------------------------------------------------- demo, reval


@pytest.fixture()
def tiny_preset(monkeypatch):
    monkeypatch.setitem(
        trainer_mod._PRESETS, "minilm-l6", dataclasses.replace(trainer_mod.MINILM_L6, **TINY_PRESET)
    )


def test_demo_stages_on_the_cpu(tmp_path, monkeypatch, capsys, tiny_preset):
    monkeypatch.setenv("FEEDBACK_DB_PATH", str(tmp_path / "unused.db"))
    monkeypatch.delenv("API_KEY", raising=False)
    rc = demo.main(["--workdir", str(tmp_path / "ws"), "--users", "40", "--products", "60",
                    "--epochs", "1", "--port", "0", "--device", "cpu"])
    assert rc == 0
    out = capsys.readouterr().out
    for stage in range(1, 6):
        assert f"=== {stage}/5" in out
    steps = int(re.search(r"trained (\d+) steps", out).group(1))
    assert steps > 0
    assert "POST /recommend -> 200, 3 items" in out and "POST /feedback  -> 202" in out
    assert re.search(r'recommendation_requests_total\{status="success"\} [1-9]', out)
    ws = tmp_path / "ws"
    assert (ws / "model" / "final" / "params.msgpack").exists()
    conn = sqlite3.connect(ws / "feedback.db")
    assert conn.execute("SELECT event_type FROM feedback_events").fetchall() == [("purchase",)]
    conn.close()


def test_reval_tower_prints_the_history(tmp_path, capsys, tiny_preset):
    rc = reval.main(["--model", "minilm-l6", "--users", "40", "--products", "60", "--batch", "16",
                     "--workdir", str(tmp_path), "--device", "cpu"])
    assert rc == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["model"] == "minilm-l6" and len(line["history"]) == 1
    assert "ndcg_at_10" in line["history"][0]


# ---------------------------------------------------------------- the loop, live


def test_retrain_once_deploys_to_a_live_port_app(world, tmp_path, monkeypatch):
    """Sample feedback against the port's app (default factory on the CPU),
    then two scheduler ticks warm-started from the served tower: one whose
    gate fails (the served model stays), one whose gate passes (the app
    serves the new final/, and /recommend answers from it)."""
    monkeypatch.setenv("FEEDBACK_DB_PATH", str(tmp_path / "f.db"))
    monkeypatch.setenv("INFERENCE_DEVICE", "cpu")
    monkeypatch.delenv("API_KEY", raising=False)
    monkeypatch.delenv("BATCH_WINDOW_MS", raising=False)
    corpus_path = world["processed"] / "eval_corpus.json"
    served = Served(create_app(model_dir=world["model"], corpus_path=corpus_path,
                               rate_limit="100000/minute"))
    try:
        config = tmp_path / "gen.yaml"
        config.write_text(f"url: {served.url}\nnum_requests: 8\nclick_rate: 0.7\n")
        assert gen.main(["--config", str(config)]) == 0
        train_config = tmp_path / "train.yaml"
        train_config.write_text(
            f"model_name: {world['model']}\noutput_dir: {tmp_path / 'runs'}\nepochs: 1\n"
            "train_batch_size: 16\nmax_seq_length: 64\nlearning_rate: 1.0e-3\n"
        )
        state = tmp_path / "state.json"
        state.write_text(json.dumps({"last_event_id": 0, "runs": 0, "deployed_metric": 0.2}))
        query = next(iter(json.loads((world["processed"] / "eval_queries.json").read_text())
                          .values()))
        client = TestClient(served.app)
        before = client.post("/recommend", json={"user_context": query, "top_k": 5}).json()

        tick = dict(processed_dir=world["processed"], db_path=init_db(), state_path=state,
                    min_new_events=1, train_config=train_config, serve_url=served.url,
                    device="cpu")
        assert fr.retrain_once(**tick, min_improvement=10.0) is True
        assert served.app.state["model_dir"] == world["model"]
        assert "deployed_model" not in fr.load_scheduler_state(state)
        assert gen.main(["--config", str(config)]) == 0
        assert fr.retrain_once(**tick, min_improvement=-1.0) is True
        deployed = Path(fr.load_scheduler_state(state)["deployed_model"])
        assert served.app.state["model_dir"] == deployed != world["model"]
        assert deployed.parent.name.startswith("run-") and (deployed.parent / "best.json").exists()

        after = client.post("/recommend", json={"user_context": query, "top_k": 5}).json()
        direct = Recommender(deployed, corpus_path, use_index=False, device="cpu").recommend(
            query, top_k=5
        )
        assert [r["product_id"] for r in after["recommendations"]] == [p for p, _ in direct]
        np.testing.assert_allclose(
            [r["score"] for r in after["recommendations"]], [s for _, s in direct], atol=1e-6
        )
        assert [r["score"] for r in after["recommendations"]] != [
            r["score"] for r in before["recommendations"]
        ]
        assert (world["processed"].parent / f"{world['processed'].name}_fb" / "train_dataset"
                ).exists()
    finally:
        served.close()


# ---------------------------------------------------------------- the container


def test_cuda_container_runs_the_port_alone():
    text = (REPO / "Dockerfile.cuda").read_text()
    assert re.search(r"^FROM nvidia/cuda:12\.8[.\d]*-devel", text, re.M)
    cmd = re.search(r"^CMD (\[.*\])$", text, re.M).group(1)
    assert json.loads(cmd) == [
        "python", "-m", "instacart_next_order_recommendation_tpu_torch.api",
        "--host", "0.0.0.0", "--port", "8000",
    ]
    # test_port_imports_no_jax runs that entry (its --help) without jax.
    assert (REPO / "instacart_next_order_recommendation_tpu_torch" / "api" / "__main__.py").exists()
    copies = [line.split()[1] for line in text.splitlines() if line.startswith("COPY ")]
    assert "instacart_next_order_recommendation_tpu_torch/" in copies
    assert all(not c.startswith("instacart_next_order_recommendation_tpu/") for c in copies)
    assert "scripts/" not in copies and "scripts/torch_*.py" in copies
    healthcheck = text[text.index("HEALTHCHECK"):text.index("CMD [")]
    assert "urllib.request" in healthcheck and "/health" in healthcheck
    instructions = "\n".join(
        line for line in text.splitlines() if not line.lstrip().startswith("#")
    ).replace("instacart_next_order_recommendation_tpu_torch", "")
    assert "httpx" not in instructions and "jax" not in instructions.lower()
    assert "serve.precompile" in text


def test_cuda_manifests_probe_what_the_port_app_serves(tmp_path, monkeypatch):
    import yaml

    docs = list(yaml.safe_load_all((REPO / "k8s" / "deployment-cuda.yaml").read_text()))
    deployment = next(d for d in docs if d["kind"] == "Deployment")
    (container,) = deployment["spec"]["template"]["spec"]["containers"]
    assert container["resources"]["limits"]["nvidia.com/gpu"] == 1
    assert container["image"].startswith("instacart-next-order-recommendation-cuda")
    probes = {k: container[k]["httpGet"]["path"] for k in ("livenessProbe", "readinessProbe")}
    assert probes == {"livenessProbe": "/health", "readinessProbe": "/ready"}
    jax_docs = list(yaml.safe_load_all((REPO / "k8s" / "deployment.yaml").read_text()))
    jax_container = next(d for d in jax_docs if d["kind"] == "Deployment")["spec"]["template"][
        "spec"]["containers"][0]
    for key in ("livenessProbe", "readinessProbe"):
        assert container[key]["httpGet"] == jax_container[key]["httpGet"]

    monkeypatch.setenv("FEEDBACK_DB_PATH", str(tmp_path / "f.db"))
    app = create_app(model_dir=tmp_path, corpus_path=tmp_path / "c.json",
                     recommender_factory=make_mock_recommender)
    with TestClient(app) as client:
        assert client.get(probes["livenessProbe"]).json() == {"status": "ok"}
        assert client.get(probes["readinessProbe"]).json() == {"status": "ready"}

    pod = next(d for d in yaml.safe_load_all(
        (REPO / "k8s" / "data-loader-pod-cuda.yaml").read_text()) if d["kind"] == "Pod")
    command = pod["spec"]["containers"][0]["command"]
    assert command[:3] == ["python", "-m", "instacart_next_order_recommendation_tpu_torch.data"]
