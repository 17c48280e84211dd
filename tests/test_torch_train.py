"""The port's training slice on the CPU against the JAX package: batching,
IR metrics, the lr schedule, one train step's loss and gradients, three
AdamW steps, and an end-to-end ``TwoTowerTrainer.train()`` whose ``final/``
the JAX package reads."""

import dataclasses
import json
import shutil
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instacart_next_order_recommendation_tpu.data import InstacartDataPrep
from instacart_next_order_recommendation_tpu.data.batching import (
    no_duplicates_batches as jax_no_duplicates_batches,
    steps_per_epoch as jax_steps_per_epoch,
)
from instacart_next_order_recommendation_tpu.data.synthetic import generate_instacart_csvs
from instacart_next_order_recommendation_tpu.eval import metrics as jax_metrics
from instacart_next_order_recommendation_tpu.models import (
    TowerConfig as JaxTowerConfig,
    encode as jax_encode,
    init_params as jax_init_params,
    load_tower as jax_load_tower,
)
from instacart_next_order_recommendation_tpu.ops.mnrl import mnrl_loss as jax_mnrl_loss
from instacart_next_order_recommendation_tpu.train import (
    TrainConfig as JaxTrainConfig,
    TwoTowerTrainer as JaxTwoTowerTrainer,
)
from instacart_next_order_recommendation_tpu_torch.data.batching import (
    no_duplicates_batches,
    steps_per_epoch,
)
from instacart_next_order_recommendation_tpu_torch.eval import metrics
from instacart_next_order_recommendation_tpu_torch.models.checkpoint import (
    params_from_numpy,
    params_to_numpy,
)
from instacart_next_order_recommendation_tpu_torch.models.encoder import TowerConfig, encode
from instacart_next_order_recommendation_tpu_torch.train import trainer as trainer_mod
from instacart_next_order_recommendation_tpu_torch.train.trainer import (
    TrainConfig,
    TrainStep,
    TwoTowerTrainer,
    build_optimizer,
    warmup_cosine_schedule,
)

TINY = dict(
    hidden_size=64, num_layers=2, num_heads=2, intermediate_size=128, max_position=64,
    compute_dtype="float32",
)


def test_no_duplicates_batches_identical_to_jax():
    rng = np.random.default_rng(20)
    for n, bs, amod, pmod in ((300, 16, 9, 23), (257, 8, 5, 257), (64, 64, 64, 64)):
        anchors = [f"a{int(rng.integers(amod))}" for _ in range(n)]
        positives = [f"p{int(rng.integers(pmod))}" for _ in range(n)]
        for epoch in (0, 3):
            ours = list(no_duplicates_batches(anchors, positives, bs, seed=1, epoch=epoch))
            theirs = list(jax_no_duplicates_batches(anchors, positives, bs, seed=1, epoch=epoch))
            assert len(ours) == len(theirs)
            for a, b in zip(ours, theirs):
                np.testing.assert_array_equal(a, b)
        assert steps_per_epoch(n, bs) == jax_steps_per_epoch(n, bs)


def test_ir_metrics_identical_to_jax():
    rng = np.random.default_rng(21)
    n_q, n_docs, k = 40, 300, 100
    corpus_ids = [str(1000 + i) for i in range(n_docs)]
    query_ids = [f"q{i}" for i in range(n_q)]
    relevant = {
        q: {corpus_ids[j] for j in rng.choice(n_docs, size=int(rng.integers(0, 6)), replace=False)}
        for q in query_ids
    }
    ranked = np.stack([rng.permutation(n_docs)[:k] for _ in range(n_q)])
    ours = metrics.compute_ir_metrics_from_arrays(ranked, query_ids, relevant, corpus_ids)
    theirs = jax_metrics.compute_ir_metrics_from_arrays(ranked, query_ids, relevant, corpus_ids)
    assert ours == theirs
    rankings = {q: [corpus_ids[j] for j in row] for q, row in zip(query_ids, ranked)}
    assert metrics.compute_ir_metrics(rankings, relevant) == jax_metrics.compute_ir_metrics(
        rankings, relevant
    )
    assert metrics.METRIC_KEYS == jax_metrics.METRIC_KEYS


@pytest.mark.parametrize("total_steps", [2, 37, 400])
def test_lr_schedule_matches_optax(total_steps):
    cfg = JaxTrainConfig({"learning_rate": 3e-4})
    _, schedule = JaxTwoTowerTrainer._build_optimizer(SimpleNamespace(cfg=cfg), total_steps)
    ours = warmup_cosine_schedule(3e-4, total_steps)
    want = np.asarray([float(schedule(c)) for c in range(total_steps + 3)])
    got = np.asarray([ours(c) for c in range(total_steps + 3)])
    assert got[0] == 0.0 == want[0]  # the first step runs at lr 0
    # optax works in f32: agreement to f32 rounding, relative to the peak.
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=3e-4 * 1e-7)


def _tiny_pair(seed=0, dropout=0.0):
    cfg = JaxTowerConfig(vocab_size=120, hidden_dropout=dropout, **TINY)
    jax_params = jax_init_params(cfg, jax.random.key(seed))
    port_cfg = TowerConfig.from_dict(cfg.to_dict())
    np_params = jax.tree.map(np.asarray, jax_params)
    return cfg, jax_params, port_cfg, np_params


def _batch(rng, batch=8, seq=32, vocab=120):
    out = []
    for _ in range(2):
        lengths = rng.integers(4, seq + 1, size=batch)
        mask = (np.arange(seq)[None] < lengths[:, None]).astype(np.int32)
        ids = np.where(mask == 1, rng.integers(5, vocab, size=(batch, seq)), 0).astype(np.int32)
        out += [ids, mask]
    return out


def _jax_loss_fn(cfg, scale):
    def loss_fn(p, a_ids, a_mask, p_ids, p_mask):
        qa = jax_encode(p, a_ids, a_mask, cfg)
        qp = jax_encode(p, p_ids, p_mask, cfg)
        return jax_mnrl_loss(qa, qp, scale=scale)

    return loss_fn


def _trainable(np_params):
    return jax.tree.map(
        lambda t: t.requires_grad_(True), params_from_numpy(np_params)
    )


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def test_train_step_loss_and_grads_match_jax():
    """One step at dropout 0, f32, from the same params and batch."""
    cfg, jax_params, port_cfg, np_params = _tiny_pair()
    batch = _batch(np.random.default_rng(22))
    loss_ref, grads_ref = jax.jit(jax.value_and_grad(_jax_loss_fn(cfg, 30.0)))(
        jax_params, *(jnp.asarray(b) for b in batch)
    )
    params = _trainable(np_params)
    step = TrainStep(
        params, port_cfg, build_optimizer(params, 0.0), warmup_cosine_schedule(1e-3, 10),
        loss_scale=30.0, accum=2, device=torch.device("cpu"),
    )
    loss = step([torch.from_numpy(b) for b in batch], seed=0)  # accumulates only
    np.testing.assert_allclose(loss.item(), float(loss_ref), rtol=1e-5)
    ours = _flat(params)
    theirs = _flat(jax.tree.map(np.asarray, grads_ref))
    assert ours.keys() == theirs.keys()
    for name, t in ours.items():
        # The step's backward holds loss/accum: the mean over 2 micro-batches.
        # f32 sums in another order; the A&S erf in the JAX package's GELU is
        # not used on this unfused path, so the gap is summation order only.
        np.testing.assert_allclose(
            2 * t.grad.numpy(), theirs[name], atol=2e-6, rtol=2e-4, err_msg=name
        )


def test_three_adamw_steps_match_optax():
    cfg, jax_params, port_cfg, np_params = _tiny_pair(seed=1)
    rng = np.random.default_rng(23)
    batches = [_batch(rng) for _ in range(3)]
    jax_cfg = JaxTrainConfig({"learning_rate": 5e-3, "weight_decay": 0.01})
    tx, _ = JaxTwoTowerTrainer._build_optimizer(SimpleNamespace(cfg=jax_cfg), 10)
    loss_fn = jax.jit(jax.value_and_grad(_jax_loss_fn(cfg, 30.0)))
    p_ref, opt_state = jax_params, tx.init(jax_params)
    losses_ref = []
    for b in batches:
        loss, grads = loss_fn(p_ref, *(jnp.asarray(x) for x in b))
        updates, opt_state = tx.update(grads, opt_state, p_ref)
        p_ref = jax.tree.map(lambda p, u: p + u, p_ref, updates)
        losses_ref.append(float(loss))

    params = _trainable(np_params)
    step = TrainStep(
        params, port_cfg, build_optimizer(params, 0.01), warmup_cosine_schedule(5e-3, 10),
        loss_scale=30.0, accum=1, device=torch.device("cpu"),
    )
    losses = [step([torch.from_numpy(x) for x in b], g).item() for g, b in enumerate(batches)]
    np.testing.assert_allclose(losses, losses_ref, rtol=1e-4)
    assert step.opt_steps == 3
    # Params: Adam divides each update by sqrt(v), so a grad within
    # summation noise of 0 can flip its update's sign, moving that entry by
    # up to 2 * lr per step. The key bias k_b has no gradient in exact
    # arithmetic (it shifts all of a query's logits alike), so all of its
    # entries are such noise; elsewhere under 1% of entries move by more
    # than 1e-5.
    lrs = [warmup_cosine_schedule(5e-3, 10)(c) for c in range(3)]
    ours, theirs = _flat(params_to_numpy(params)), _flat(jax.tree.map(np.asarray, p_ref))
    for name in ours:
        diff = np.abs(ours[name] - theirs[name])
        assert diff.max() <= 2 * sum(lrs), name
        if name != "layers/k_b":
            assert np.mean(diff > 1e-5) < 0.01, name


# ---------------------------------------------------------------- end to end


@pytest.fixture(scope="module")
def processed(tmp_path_factory):
    base = tmp_path_factory.mktemp("torch_train")
    data_dir = generate_instacart_csvs(base / "data", n_users=120, n_products=150, seed=3)
    prep = InstacartDataPrep(data_dir=data_dir, output_dir=base / "processed", eval_frac=0.2)
    prep.prepare()
    return base, prep.effective_output_dir()


def _train_cfg(processed_dir, out, **kw):
    raw = {
        "processed_dir": str(processed_dir),
        "output_dir": str(out),
        "model_name": "minilm-l6",
        "max_seq_length": 64,
        "epochs": 3,
        "train_batch_size": 16,  # the 24 held-out users fill a no-duplicates batch
        "eval_batch_size": 32,
        "learning_rate": 2e-3,
        "vocab_size": 2000,
        "logging_steps": 5,
        **kw,
    }
    return TrainConfig(raw)


@pytest.fixture(scope="module")
def trained(processed):
    base, processed_dir = processed
    cfg = _train_cfg(processed_dir, base / "model")
    mp = pytest.MonkeyPatch()
    mp.setitem(
        trainer_mod._PRESETS, "minilm-l6", dataclasses.replace(trainer_mod.MINILM_L6, **TINY)
    )
    try:
        trainer = TwoTowerTrainer(cfg, device="cpu")
        result = trainer.train()
    finally:
        mp.undo()
    return cfg, result, trainer


def test_training_loss_falls_and_eval_runs(trained):
    _, result, trainer = trained
    hist = result["history"]
    assert [h["epoch"] for h in hist] == [1, 2, 3]
    assert hist[-1]["train_loss"] < hist[0]["train_loss"]
    assert all(np.isfinite(h["eval_loss"]) for h in hist)
    assert all(0.0 <= h["ndcg_at_10"] <= 1.0 for h in hist)
    assert len(trainer.step_losses) == sum(1 for _ in trainer.step_losses) > 0


def test_checkpoint_layout_matches_jax(trained):
    cfg, result, _ = trained
    out = cfg.output_dir
    for name in ("params.msgpack", "model_config.json", "vocab.txt"):
        assert (out / "final" / name).exists()
    assert (out / "eval_history.json").exists()
    best = json.loads((out / "best.json").read_text())
    assert best["metric"] == "ndcg_at_10" and best["best_epoch"] == result["best_epoch"]
    ckpts = sorted(out.glob("checkpoint-epoch*"))
    assert 1 <= len(ckpts) <= 3  # keep-2, plus the best when it is older
    assert f"checkpoint-epoch{result['best_epoch']}" in {c.name for c in ckpts}
    for ck in ckpts:
        assert (ck / "params.msgpack").exists() and (ck / "train_state.json").exists()
        assert (ck / trainer_mod.OPT_STATE_FILENAME).exists()


def test_jax_reads_the_final_tower_and_encodes_the_same(trained):
    cfg, _, _ = trained
    from instacart_next_order_recommendation_tpu_torch.models.checkpoint import load_tower

    params, tower_cfg, tok = load_tower(cfg.output_dir / "final")
    j_params, j_cfg, j_tok = jax_load_tower(cfg.output_dir / "final")
    texts = ["[+7d w4h14] Organic Milk, Whole Wheat Bread.", "Product: Banana. Aisle: fruit."]
    ids, mask = tok.encode_batch(texts, max_seq_length=64)
    j_ids, j_mask = j_tok.encode_batch(texts, max_seq_length=64)
    np.testing.assert_array_equal(ids, j_ids)
    ours = encode(params, torch.from_numpy(ids), torch.from_numpy(mask), tower_cfg).numpy()
    theirs = np.asarray(jax_encode(j_params, jnp.asarray(ids), jnp.asarray(mask), j_cfg))
    np.testing.assert_allclose(ours, theirs, atol=2e-5)


def test_resume_continues_the_same_run(processed, tmp_path, monkeypatch):
    """A run resumed from its epoch-1 checkpoint trains epoch 2 exactly as
    the uninterrupted run did (optimizer state, partial gradient
    accumulation, schedule position and dropout stream all carried)."""
    _, processed_dir = processed
    monkeypatch.setitem(
        trainer_mod._PRESETS, "minilm-l6",
        dataclasses.replace(trainer_mod.MINILM_L6, **{**TINY, "num_layers": 1}),
    )
    # The preset keeps MiniLM's hidden dropout of 0.1.
    kw = dict(epochs=2, run_information_retrieval_evaluator=False, gradient_accumulation_steps=3)
    whole = TwoTowerTrainer(_train_cfg(processed_dir, tmp_path / "a", **kw), device="cpu")
    whole_hist = whole.train()["history"]
    shutil.copytree(tmp_path / "a" / "checkpoint-epoch1", tmp_path / "b" / "checkpoint-epoch1")
    resumed = TwoTowerTrainer(
        _train_cfg(processed_dir, tmp_path / "b", **{**kw, "resume": True}), device="cpu"
    )
    hist = resumed.train()["history"]
    assert [h["epoch"] for h in hist] == [1, 2]
    assert hist[0] == whole_hist[0]
    n_epoch2 = len(resumed.step_losses)
    assert 0 < n_epoch2 < len(whole.step_losses)
    np.testing.assert_allclose(resumed.step_losses, whole.step_losses[-n_epoch2:], rtol=1e-6)


def test_multi_gpu_and_missing_cuda_raise(monkeypatch, tmp_path):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TwoTowerTrainer(TrainConfig({"data_parallel": 2}), device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TwoTowerTrainer(TrainConfig({"model_parallel": 2}), device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TwoTowerTrainer(TrainConfig({"output_dir": str(tmp_path)}))
