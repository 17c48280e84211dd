"""The port's training leftovers on the CPU: ``ITOR_PROFILE_DIR`` (a
``torch.profiler`` trace of dispatches 1-5), ``ITOR_LOOP_TIMING`` (the JAX
trainer's log line, read from the recorder's spans), ``utils/profiling.py``'s
recorder, a warm start from a Hugging Face directory through ``train()``,
and a 5-step bf16 trajectory against the JAX package's encode, MNRL and
optax AdamW."""

import json
import logging
import re
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from transformers import BertConfig, BertModel

from instacart_next_order_recommendation_tpu.models import (
    TowerConfig as JaxTowerConfig,
    encode as jax_encode,
    init_params as jax_init_params,
)
from instacart_next_order_recommendation_tpu.ops.mnrl import mnrl_loss as jax_mnrl_loss
from instacart_next_order_recommendation_tpu.train import (
    TrainConfig as JaxTrainConfig,
    TwoTowerTrainer as JaxTwoTowerTrainer,
)
from instacart_next_order_recommendation_tpu_torch.models.checkpoint import (
    load_tower,
    params_from_numpy,
)
from instacart_next_order_recommendation_tpu_torch.models.encoder import TowerConfig
from instacart_next_order_recommendation_tpu_torch.tokenizer import WordPieceTokenizer
from instacart_next_order_recommendation_tpu_torch.train.trainer import (
    TrainConfig,
    TrainStep,
    TwoTowerTrainer,
    build_optimizer,
    warmup_cosine_schedule,
)
from instacart_next_order_recommendation_tpu_torch.utils import profiling

LOOP_LINE = (
    r"loop timing/dispatch: assemble \d+ ms, fold_in \d+ ms, submit \d+ ms, wall \d+ ms"
)


def _data(n_pairs: int):
    """(anchors, positives, eval_pairs, queries, corpus, relevant) in memory:
    distinct anchors, positives over a 40-product corpus."""
    corpus = {str(i + 1): f"Product: Organic Item {i}. Aisle: a{i % 5}." for i in range(40)}
    anchors = [f"[+7d w4h14] user {i} bought item {i % 40} and item {(3 * i) % 40}"
               for i in range(n_pairs)]
    positives = [corpus[str(i % 40 + 1)] for i in range(n_pairs)]
    queries = {"q1": "user 1 bought item 1", "q2": "user 2 bought item 7"}
    relevant = {"q1": {"2"}, "q2": {"8"}}
    return anchors, positives, None, queries, corpus, relevant


@pytest.fixture(scope="module")
def hf_dir(tmp_path_factory):
    """A tiny BERT in Hugging Face layout (``pytorch_model.bin`` under the
    sentence-transformers prefix) with a vocab trained on the data."""
    anchors, positives, _, _, corpus, _ = _data(64)
    tok = WordPieceTokenizer.train(
        list(corpus.values()) + anchors, vocab_size=400, min_frequency=1
    )
    torch.manual_seed(0)
    model = BertModel(BertConfig(
        vocab_size=tok.vocab_size, hidden_size=32, num_hidden_layers=1, num_attention_heads=2,
        intermediate_size=64, max_position_embeddings=64,
    ))
    path = tmp_path_factory.mktemp("hf_tower")
    (path / "config.json").write_text(model.config.to_json_string())
    torch.save({f"0.auto_model.{k}": v for k, v in model.state_dict().items()},
               path / "pytorch_model.bin")
    tok.save(path)
    return path


def _warm_start(hf_dir, out, n_pairs, monkeypatch, env, caplog):
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    cfg = TrainConfig({
        "output_dir": str(out), "model_name": str(hf_dir), "max_seq_length": 32,
        "epochs": 1, "train_batch_size": 8, "learning_rate": 1e-3, "logging_steps": 100,
        "run_information_retrieval_evaluator": False,
    })
    trainer = TwoTowerTrainer(cfg, device="cpu")
    with caplog.at_level(logging.INFO):
        result = trainer.train(data=_data(n_pairs))
    return trainer, result


def test_profile_dir_writes_a_trace_of_dispatches_1_to_5(hf_dir, tmp_path, monkeypatch, caplog):
    trace_dir = tmp_path / "trace"
    trainer, result = _warm_start(
        hf_dir, tmp_path / "out", 56, monkeypatch, {"ITOR_PROFILE_DIR": str(trace_dir)}, caplog
    )
    assert len(trainer.step_losses) == 7
    traces = list(trace_dir.glob("*.pt.trace.json"))
    assert len(traces) == 1, traces
    events = json.loads(traces[0].read_text())["traceEvents"]
    # Each step embeds two towers' ids: two word-embedding lookups a step,
    # so the trace holds steps 1-5 and no other.
    lookups = [e for e in events if e.get("name") == "aten::embedding"]
    assert len(lookups) == 2 * 5
    assert "device trace of the first steps written to" in caplog.text
    assert "loop timing" not in caplog.text
    # The warm start trained the HF tower: final/ is in the shared format.
    params, cfg, _ = load_tower(result["final_dir"])
    assert (cfg.hidden_size, cfg.num_layers) == (32, 1)
    assert (tmp_path / "out" / "final" / "model_config.json").exists()


def test_loop_timing_logs_the_jax_line(hf_dir, tmp_path, monkeypatch, caplog):
    trainer, _ = _warm_start(
        hf_dir, tmp_path / "out", 208, monkeypatch, {"ITOR_LOOP_TIMING": "1"}, caplog
    )
    assert len(trainer.step_losses) >= 25
    lines = [r.getMessage() for r in caplog.records if "loop timing" in r.getMessage()]
    assert len(lines) == len(trainer.step_losses) // 25 >= 1
    assert all(re.fullmatch(r"\s*" + LOOP_LINE, line) for line in lines), lines
    assert not (tmp_path / "trace").exists()


def test_maybe_trace_is_free_without_the_env_var_and_traces_with_it(tmp_path):
    # The recorder that replaced maybe_trace/annotate: off, a span is one
    # shared no-op and records nothing; under recording() it records into
    # the block's own list; under the trainer's device_profiler
    # (ITOR_PROFILE_DIR) it records into spans() and the trace shows it.
    profiling.clear()
    assert profiling.span("a") is profiling.span("b")
    with profiling.span("off"):
        torch.ones(3).sum()
    assert profiling.spans() == []
    with profiling.recording() as got:
        with profiling.span("on"):
            torch.ones(3).sum()
    assert [s.name for s in got] == ["on"] and profiling.spans() == []
    with profiling.device_profiler(tmp_path / "section", cuda=False):
        with profiling.span("my_span"):
            torch.ones(3).sum()
    assert [s.name for s in profiling.spans()] == ["my_span"]
    profiling.clear()
    traces = list((tmp_path / "section").glob("*.pt.trace.json"))
    assert len(traces) == 1
    names = {e.get("name") for e in json.loads(traces[0].read_text())["traceEvents"]}
    assert "my_span" in names


def test_bf16_trajectory_matches_jax():
    """5 AdamW steps at dropout 0 in bf16 from the same params on the same
    batches. Limit: per-step losses within 5e-3 relative, about one bf16
    rounding (8 significant bits: 2^-8 = 3.9e-3) plus summation order; the
    two packages round the activations at the same cast points but sum in
    other orders."""
    cfg = JaxTowerConfig(
        vocab_size=120, hidden_size=64, num_layers=2, num_heads=2, intermediate_size=128,
        max_position=64, compute_dtype="bfloat16", hidden_dropout=0.0,
    )
    jax_params = jax_init_params(cfg, jax.random.key(7))
    rng = np.random.default_rng(8)
    batches = []
    for _ in range(5):
        batch = []
        for _ in range(2):
            lengths = rng.integers(4, 33, size=8)
            mask = (np.arange(32)[None] < lengths[:, None]).astype(np.int32)
            batch += [np.where(mask == 1, rng.integers(5, 120, size=(8, 32)), 0).astype(np.int32),
                      mask]
        batches.append(batch)

    def loss_fn(p, a_ids, a_mask, p_ids, p_mask):
        return jax_mnrl_loss(jax_encode(p, a_ids, a_mask, cfg), jax_encode(p, p_ids, p_mask, cfg),
                             scale=30.0)

    tx, _ = JaxTwoTowerTrainer._build_optimizer(
        SimpleNamespace(cfg=JaxTrainConfig({"learning_rate": 2e-3, "weight_decay": 0.01})), 10
    )
    value_and_grad = jax.jit(jax.value_and_grad(loss_fn))
    p_ref, opt_state, want = jax_params, tx.init(jax_params), []
    for b in batches:
        loss, grads = value_and_grad(p_ref, *(jnp.asarray(x) for x in b))
        updates, opt_state = tx.update(grads, opt_state, p_ref)
        p_ref = jax.tree.map(lambda p, u: p + u, p_ref, updates)
        want.append(float(loss))

    params = jax.tree.map(
        lambda t: t.requires_grad_(True),
        params_from_numpy(jax.tree.map(np.asarray, jax_params)),
    )
    step = TrainStep(
        params, TowerConfig.from_dict(cfg.to_dict()), build_optimizer(params, 0.01),
        warmup_cosine_schedule(2e-3, 10), loss_scale=30.0, accum=1, device=torch.device("cpu"),
    )
    got = [step([torch.from_numpy(x) for x in b], seed=i).item() for i, b in enumerate(batches)]
    assert step.opt_steps == 5
    assert got[-1] < got[0] and want[-1] < want[0]  # both learn over the 5 steps
    np.testing.assert_allclose(got, want, rtol=5e-3)
