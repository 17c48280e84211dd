"""The port's process mesh on the CPU: gloo ranks from
``torch.multiprocessing.spawn``, against the JAX package's shard_map train
step and against the port's one-process step.

Three launches, each joined with its own timeout:

- dp=2: one step at dropout 0, each rank on its block of the global batch
  (MNRL's negatives gathered over the data group, the gradients averaged in
  one flat all-reduce), against JAX's shard_map step at dp=2 and the
  port's one-process step at the global batch;
- dp=2 x tp=2 (four ranks): the same against JAX's
  ``train_step_mode: shard_map`` step at model_parallel 2, each rank on its
  Megatron shards; and ``tp_enter``/``tp_exit`` gradients over a model
  group of two, as ``tests/test_parallel.py::test_tp_region_grads`` checks
  JAX's;
- ``TwoTowerTrainer.train()`` with ``data_parallel: 2`` on the CPU: only
  rank 0 writes, the histories are equal on both ranks, and a resume from
  a checkpoint only rank 0's directory holds continues on both as an
  uninterrupted run does.

The limits are JAX's own for its two step forms
(``tests/test_parallel.py``): loss within rel 1e-5, params within 4e-5.

The JAX package is imported inside the functions that use it: every spawned
rank imports this module, and the ranks run the port alone.
"""

import dataclasses
import json
import shutil
import time
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from instacart_next_order_recommendation_tpu_torch.models.checkpoint import (
    params_from_numpy,
    params_to_numpy,
)
from instacart_next_order_recommendation_tpu_torch.models.encoder import MINILM_L6, TowerConfig
from instacart_next_order_recommendation_tpu_torch.parallel import (
    MeshConfig,
    ProcessMesh,
    gather_params,
    shard_params,
    tp_enter,
    tp_exit,
)
from instacart_next_order_recommendation_tpu_torch.train import trainer as trainer_mod
from instacart_next_order_recommendation_tpu_torch.train.trainer import (
    TrainConfig,
    TrainStep,
    TwoTowerTrainer,
    build_optimizer,
)

LR = 1e-3
WEIGHT_DECAY = 1e-4  # optax.adamw's default, which JAX's step takes
LOSS_REL = 1e-5
PARAM_ATOL = 4e-5
LAUNCH_TIMEOUT_S = 120

TINY = dataclasses.replace(  # the port's TowerConfig: the same fields as JAX's
    MINILM_L6,
    vocab_size=256,
    hidden_size=64,
    num_layers=2,
    num_heads=4,
    intermediate_size=128,
    max_position=64,
    compute_dtype="float32",
    hidden_dropout=0.0,
)


def _launch(fn, world: int, out: Path, *inputs) -> None:
    """``fn(rank, world, init_file, out, *inputs)`` on ``world`` gloo ranks;
    fails the test if a rank fails or the launch outlives its timeout. The
    inputs go through a file: a spawn's arguments past the pipe's buffer
    would hold each rank's start until the one before has imported this
    module."""
    torch.save(inputs, out / "inputs.pt")
    ctx = mp.spawn(fn, args=(world, str(out / "pg_init"), str(out)), nprocs=world, join=False)
    deadline = time.monotonic() + LAUNCH_TIMEOUT_S
    while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"gloo launch of {world} ranks outlived {LAUNCH_TIMEOUT_S} s")


def _join(rank: int, world: int, init: str, out: str) -> tuple:
    """Join the launch's process group; returns the launch's inputs."""
    torch.set_num_threads(1)  # up to four ranks share the host's cores
    dist.init_process_group("gloo", init_method=f"file://{init}", rank=rank, world_size=world)
    return torch.load(Path(out) / "inputs.pt", weights_only=False)


def _batch(rng, b: int = 16, s: int = 16) -> list[np.ndarray]:
    ids = rng.integers(5, 256, (b, s)).astype(np.int32)
    mask = np.ones((b, s), np.int32)
    mask[1, 10:] = 0  # one padded row
    return [ids, mask, ids[::-1].copy(), mask[::-1].copy()]


def _port_step(params_np, batch, mesh=None, rows=slice(None), tp=1, model_rank=0):
    """One TrainStep at dropout 0 and a constant lr; returns (loss, new
    local params as numpy)."""
    cfg = TowerConfig.from_dict(TINY.to_dict())
    params = shard_params(params_from_numpy(params_np), cfg, tp, model_rank)
    params = {
        g: {k: t.clone().requires_grad_(True) for k, t in v.items()} for g, v in params.items()
    }
    step = TrainStep(
        params, cfg, build_optimizer(params, WEIGHT_DECAY), lambda count: LR,
        loss_scale=30.0, accum=1, device=torch.device("cpu"), mesh=mesh,
    )
    loss = step([torch.from_numpy(np.ascontiguousarray(b[rows])) for b in batch], seed=0)
    return float(loss), params_to_numpy(params)


def _jax_step(params_np, batch, dp: int, tp: int):
    """One step of the JAX trainer's shard_map form on a (dp, tp) mesh."""
    import jax
    import jax.numpy as jnp
    import optax

    import instacart_next_order_recommendation_tpu.train.trainer as jax_trainer
    from instacart_next_order_recommendation_tpu.models import TowerConfig as JaxTowerConfig

    raw = {"data_parallel": dp, "model_parallel": tp, "learning_rate": LR}
    if tp > 1:
        raw["train_step_mode"] = "shard_map"
    trainer = jax_trainer.TwoTowerTrainer(jax_trainer.TrainConfig(raw))
    tx = optax.adamw(LR)
    (mode, step), p_shard = trainer._make_train_step(JaxTowerConfig(**TINY.to_dict()), tx)
    assert mode == "shard_map"
    placed = jax.device_put(params_np, p_shard)
    new, _, loss = step(
        placed, jax.jit(tx.init)(placed), tuple(jnp.asarray(b) for b in batch), jax.random.key(0)
    )
    return float(loss), jax.tree.map(np.asarray, new)


def _jax_params(seed: int) -> dict:
    """The JAX package's init of the tower, as numpy."""
    import jax

    from instacart_next_order_recommendation_tpu.models import (
        TowerConfig as JaxTowerConfig,
        init_params,
    )

    params = init_params(JaxTowerConfig(**TINY.to_dict()), jax.random.key(seed))
    return jax.tree.map(np.asarray, params)


def _assert_step(got, want, what: str) -> None:
    (loss, params), (ref_loss, ref_params) = got, want
    assert loss == pytest.approx(ref_loss, rel=LOSS_REL), what
    for group, leaves in ref_params.items():
        for name, ref in leaves.items():
            np.testing.assert_allclose(
                params[group][name], ref, atol=PARAM_ATOL, rtol=0, err_msg=f"{what}: {group}/{name}"
            )


# ------------------------------------------------------------------ dp=2


def _rank_dp(rank, world, init, out):
    params_np, batch = _join(rank, world, init, out)
    mesh = ProcessMesh(MeshConfig(2, 1))
    b = batch[0].shape[0] // 2
    result = _port_step(params_np, batch, mesh, slice(mesh.data_rank * b, (mesh.data_rank + 1) * b))
    torch.save(result, Path(out) / f"dp_rank{rank}.pt")
    dist.destroy_process_group()


def test_dp2_step_matches_jax_and_the_global_batch(tmp_path):
    params_np = _jax_params(3)
    batch = _batch(np.random.default_rng(0))
    _launch(_rank_dp, 2, tmp_path, params_np, batch)
    ranks = [torch.load(tmp_path / f"dp_rank{r}.pt", weights_only=False) for r in range(2)]
    assert ranks[0][0] == ranks[1][0]  # the loss is averaged over the data group
    for group, leaves in ranks[0][1].items():
        for name, t in leaves.items():  # replicas stay equal
            np.testing.assert_array_equal(t, ranks[1][1][group][name])
    _assert_step(ranks[0], _jax_step(params_np, batch, 2, 1), "dp=2 vs JAX shard_map dp=2")
    _assert_step(ranks[0], _port_step(params_np, batch), "dp=2 vs one process at B=16")


# ------------------------------------------------------------------ dp=2 x tp=2


def _rank_dp_tp(rank, world, init, out):
    params_np, batch, region = _join(rank, world, init, out)
    mesh = ProcessMesh(MeshConfig(2, 2))
    b = batch[0].shape[0] // 2
    rows = slice(mesh.data_rank * b, (mesh.data_rank + 1) * b)
    result = _port_step(params_np, batch, mesh, rows, tp=2, model_rank=mesh.model_rank)
    # tp_enter/tp_exit on a column- then row-parallel pair over the model group.
    x, w1, w2 = (torch.from_numpy(a).requires_grad_(True) for a in region)
    m = mesh.model_rank
    w1_local = w1.detach().chunk(2, dim=1)[m].clone().requires_grad_(True)
    w2_local = w2.detach().chunk(2, dim=0)[m].clone().requires_grad_(True)
    y = tp_exit(torch.tanh(tp_enter(x, mesh.model_group) @ w1_local) @ w2_local, mesh.model_group)
    y.sum().backward()
    grads = (x.grad.numpy(), w1_local.grad.numpy(), w2_local.grad.numpy())
    torch.save((result, grads, mesh.data_rank, m), Path(out) / f"tp_rank{rank}.pt")
    dist.destroy_process_group()


def test_dp2_tp2_step_matches_jax_shard_map(tmp_path):
    params_np = _jax_params(7)
    batch = _batch(np.random.default_rng(1))
    rng = np.random.default_rng(2)
    region = tuple(
        rng.standard_normal(shape).astype(np.float32) for shape in ((4, 16), (16, 32), (32, 16))
    )
    _launch(_rank_dp_tp, 4, tmp_path, params_np, batch, region)
    ranks = [torch.load(tmp_path / f"tp_rank{r}.pt", weights_only=False) for r in range(4)]
    assert [(r[2], r[3]) for r in ranks] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    assert len({r[0][0] for r in ranks}) == 1  # one loss on every rank
    full = [
        (ranks[2 * d][0][0], params_to_numpy(gather_params(
            [params_from_numpy(ranks[2 * d + m][0][1]) for m in range(2)]
        )))
        for d in range(2)
    ]
    for group, leaves in full[0][1].items():
        for name, t in leaves.items():  # the data replicas stay equal
            np.testing.assert_array_equal(t, full[1][1][group][name])
    _assert_step(full[0], _jax_step(params_np, batch, 2, 2), "dp2 x tp2 vs JAX shard_map")
    _assert_step(full[0], _port_step(params_np, batch), "dp2 x tp2 vs one process at B=16")

    x, w1, w2 = (torch.from_numpy(a).requires_grad_(True) for a in region)
    (torch.tanh(x @ w1) @ w2).sum().backward()
    for _, grads, _, m in ranks:
        np.testing.assert_allclose(grads[0], x.grad.numpy(), rtol=2e-5, atol=1e-4)
        np.testing.assert_allclose(
            grads[1], w1.grad.chunk(2, dim=1)[m].numpy(), rtol=2e-5, atol=1e-4
        )
        np.testing.assert_allclose(
            grads[2], w2.grad.chunk(2, dim=0)[m].numpy(), rtol=2e-5, atol=1e-4
        )


# ------------------------------------------------------------------ the trainer


def _data(n_pairs: int = 96):
    nouns = ["milk", "bread", "banana", "cheese", "rice", "coffee", "apples", "yogurt"]
    products = {str(i): f"organic {nouns[i % 8]} {i} aisle a{i % 5}" for i in range(40)}
    rng = np.random.default_rng(4)
    anchors, positives = [], []
    for u in range(n_pairs):
        basket = rng.choice(40, size=4, replace=False)
        anchors.append("bought " + ", ".join(products[str(i)] for i in basket[:3]) + f" user {u}")
        positives.append(products[str(basket[3])])
    queries = {f"q{u}": anchors[u] for u in range(12)}
    relevant = {f"q{u}": {str(rng.integers(40))} for u in range(12)}
    return anchors, positives, (anchors[:48], positives[:48]), queries, products, relevant


def _rank_train(rank, world, init, out):
    _join(rank, world, init, out)
    trainer_mod._PRESETS["minilm-l6"] = dataclasses.replace(
        trainer_mod.MINILM_L6, hidden_size=64, num_layers=2, num_heads=4,
        intermediate_size=128, max_position=64, compute_dtype="float32",
    )
    base = Path(out)

    def run(name, epochs, resume=False):
        cfg = TrainConfig({
            "output_dir": str(base / f"{name}_rank{rank}"), "model_name": "minilm-l6",
            "max_seq_length": 32, "epochs": epochs, "train_batch_size": 8,
            "eval_batch_size": 8, "learning_rate": 2e-3, "vocab_size": 300,
            "data_parallel": 2, "logging_steps": 100, "resume": resume,
        })
        trainer = TwoTowerTrainer(cfg, device="cpu")
        result = trainer.train(data=_data())
        return {"history": result["history"], "losses": trainer.step_losses,
                "best_epoch": result["best_epoch"]}

    whole = run("whole", 2)
    if rank == 0:  # the epoch-1 checkpoint, in rank 0's directory alone
        shutil.copytree(
            base / "whole_rank0" / "checkpoint-epoch1", base / "resumed_rank0" / "checkpoint-epoch1"
        )
    dist.barrier()
    resumed = run("resumed", 2, resume=True)
    (base / f"train_rank{rank}.json").write_text(json.dumps({"resumed": resumed, "whole": whole}))
    dist.destroy_process_group()


def test_trainer_on_two_ranks_writes_once_and_resumes(tmp_path):
    _launch(_rank_train, 2, tmp_path)
    ranks = [json.loads((tmp_path / f"train_rank{r}.json").read_text()) for r in range(2)]
    assert ranks[0] == ranks[1]  # histories, losses and best epoch: equal on both ranks
    run = ranks[0]
    whole, resumed = run["whole"]["history"], run["resumed"]["history"]
    assert [h["epoch"] for h in resumed] == [1, 2] and resumed[0] == whole[0]
    assert all("ndcg_at_10" in h and "eval_loss" in h for h in whole)
    # The resumed run trained epoch 2 only, with the uninterrupted run's losses.
    n = len(run["resumed"]["losses"])
    assert 0 < n < len(run["whole"]["losses"])
    np.testing.assert_allclose(run["resumed"]["losses"], run["whole"]["losses"][-n:], rtol=1e-6)
    for name in ("resumed", "whole"):
        assert (tmp_path / f"{name}_rank0" / "final" / "params.msgpack").exists()
        assert sorted(p.name for p in (tmp_path / f"{name}_rank0").glob("checkpoint-epoch*"))
        assert not (tmp_path / f"{name}_rank1").exists()  # only rank 0 writes
