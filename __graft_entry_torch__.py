"""Harness entry points of the PyTorch/CUDA port: a one-card forward check and
a multi-rank dry run.

The port's counterpart of ``__graft_entry__.py``. It imports nothing of JAX.

``entry(device=None)`` returns ``(fn, example_args)``: ``fn`` is the port's
tower forward (``models.encoder.encode``) on MiniLM-L6 at full width (384
wide, 12 heads, 6 layers), with random weights from a seeded
``torch.Generator``, and the example arguments are a batch of 8 sequences of
128 token ids with the lengths ``__graft_entry__.entry`` draws. On the card
one call is 6 fused-layer launches (K1) and one pool launch (K2).

``dryrun_multichip(n, device=None)`` spawns ``n`` gloo ranks (a dp x tp
process mesh when ``n`` allows) that run, on tiny shapes: one
``TrainStep`` over the process mesh with global-batch MNRL (the only
train-step form the port has), and the row-sharded catalog top-k over a
device mesh, plain and category-masked. The ranks share ``cuda:0`` on a
one-card host (NCCL refuses two ranks on one GPU) or run on the CPU when
``device="cpu"``.

    python __graft_entry_torch__.py [n] [--device cpu]
"""

from __future__ import annotations

import functools
import json
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ENTRY_BATCH, ENTRY_SEQ = 8, 128
DRYRUN_SEQ = 32
DRYRUN_TIMEOUT_S = 300
DRYRUN_LR = 1e-4
DRYRUN_WEIGHT_DECAY = 1e-4  # optax.adamw's default, which the JAX dry run takes


def entry(device: str | torch.device | None = None):
    """``(fn, example_args)`` for a one-card forward check; ``device=None``
    means the GPU."""
    from instacart_next_order_recommendation_tpu_torch.device import resolve_device
    from instacart_next_order_recommendation_tpu_torch.models.encoder import (
        MINILM_L6,
        encode,
        init_params,
    )
    from instacart_next_order_recommendation_tpu_torch.models.text_encoder import (
        params_to_device,
    )

    dev = resolve_device(device)
    config = MINILM_L6
    params = params_to_device(init_params(config, torch.Generator().manual_seed(0)), dev)
    rng = np.random.default_rng(0)
    ids = rng.integers(5, config.vocab_size, (ENTRY_BATCH, ENTRY_SEQ))
    lengths = rng.integers(8, ENTRY_SEQ + 1, ENTRY_BATCH)
    mask = (np.arange(ENTRY_SEQ)[None, :] < lengths[:, None]).astype(np.int32)
    input_ids = torch.from_numpy(ids.astype(np.int32)).to(dev)
    attention_mask = torch.from_numpy(mask).to(dev)
    return functools.partial(encode, config=config), (params, input_ids, attention_mask)


def _tiny_config():
    """A tiny tower of the real architecture: head_dim 32 and S=32, so a
    data-parallel step takes the fused layer (K1-train, K5) on the card,
    and a tensor-parallel one the unfused layer (K6, K7)."""
    import dataclasses

    from instacart_next_order_recommendation_tpu_torch.models.encoder import MINILM_L6

    return dataclasses.replace(
        MINILM_L6, vocab_size=512, hidden_size=64, num_layers=2, num_heads=2,
        intermediate_size=128, max_position=64,
    )


def _mesh_shape(n: int) -> tuple[int, int]:
    """(dp, tp): tp 2 where ``n`` is even and at least 4, as the JAX dry run."""
    tp = 2 if n >= 4 and n % 2 == 0 else 1
    return n // tp, tp


def _rank_work(world: int, dev: torch.device) -> dict:
    """What one rank runs: a train step over the process mesh, then the
    sharded top-k over a device mesh; each part's launches by wrapper."""
    from instacart_next_order_recommendation_tpu_torch.index import ShardedCatalogIndex
    from instacart_next_order_recommendation_tpu_torch.models.encoder import init_params
    from instacart_next_order_recommendation_tpu_torch.ops import (
        launch_counts,
        reset_launch_counts,
    )
    from instacart_next_order_recommendation_tpu_torch.parallel import (
        MeshConfig,
        ProcessMesh,
        build_mesh,
        shard_params,
    )
    from instacart_next_order_recommendation_tpu_torch.train.trainer import (
        TrainStep,
        build_optimizer,
        dropout_seed,
    )

    dp, tp = _mesh_shape(world)
    pm = ProcessMesh(MeshConfig(dp, tp))
    config = _tiny_config()
    params = shard_params(init_params(config, torch.Generator().manual_seed(0)), config, tp,
                          pm.model_rank)
    params = {g: {k: t.to(dev).requires_grad_(True) for k, t in v.items()}
              for g, v in params.items()}
    step = TrainStep(
        params, config, build_optimizer(params, DRYRUN_WEIGHT_DECAY), lambda count: DRYRUN_LR,
        loss_scale=30.0, accum=1, device=dev, mesh=pm,
    )
    rng = np.random.default_rng(0)
    b = 2 * world  # the global batch; each data rank takes its block
    ids = [rng.integers(5, config.vocab_size, (b, DRYRUN_SEQ)) for _ in range(2)]
    rows = slice(pm.data_rank * (b // dp), (pm.data_rank + 1) * (b // dp))
    mask = torch.ones((b // dp, DRYRUN_SEQ), dtype=torch.int32, device=dev)
    batch = []
    for x in ids:
        batch += [torch.from_numpy(x[rows].astype(np.int32)).to(dev), mask]
    reset_launch_counts()
    loss = float(step(batch, dropout_seed(42, 1, 0, pm.data_rank)))
    out = {"rank": pm.rank, "data_rank": pm.data_rank, "model_rank": pm.model_rank,
           "loss": loss, "train_launches": launch_counts()}

    # Row-sharded catalog top-k over a device mesh of this rank's device.
    mesh = build_mesh(MeshConfig(dp, tp), devices=[dev] * world)
    catalog = rng.standard_normal((4 * world + 3, config.hidden_size)).astype(np.float32)
    catalog /= np.linalg.norm(catalog, axis=1, keepdims=True)
    queries = rng.standard_normal((4, config.hidden_size)).astype(np.float32)
    queries /= np.linalg.norm(queries, axis=1, keepdims=True)
    reset_launch_counts()
    index = ShardedCatalogIndex(catalog, mesh)
    scores, indices = index.topk(queries, k=5)
    expect = np.argsort(-(queries @ catalog.T), axis=1, kind="stable")[:, :5]
    cand_mask = (rng.random(catalog.shape[0]) < 0.5).astype(np.int32)
    _, m_idx = index.topk(queries, k=3, candidate_mask=cand_mask)
    out.update(
        catalog_shards=index.dp,
        topk_shape=list(scores.shape),
        topk_exact=bool(np.array_equal(indices, expect)),
        masked_ok=bool(all(cand_mask[j] == 1 for j in m_idx.ravel())),
        topk_launches=launch_counts(),
    )
    return out


def _rank(rank: int, world: int, device: str, init_method: str, out_dir: str) -> None:
    import torch.distributed as dist

    dev = torch.device(device)
    if dev.type == "cuda":
        # Gloo ranks share the host's cards: on one card, all on cuda:0.
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    else:
        torch.set_num_threads(1)  # the ranks share the host's cores
    dist.init_process_group("gloo", init_method=init_method, rank=rank, world_size=world)
    try:
        result = _rank_work(world, dev)
        (Path(out_dir) / f"rank{rank}.json").write_text(json.dumps(result))
    finally:
        dist.destroy_process_group()


def dryrun_multichip(n_devices: int, device: str | torch.device | None = None) -> dict:
    """Run the train step and the sharded retrieval on ``n_devices`` gloo
    ranks; raises when a rank fails or a check does not hold. Returns the
    ranks' results, the mesh shape and the launches summed over the ranks."""
    import torch.multiprocessing as mp

    from instacart_next_order_recommendation_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    with tempfile.TemporaryDirectory(prefix="dryrun_") as tmp:
        # A file in the run's own directory: no port to find free and then
        # lose to another socket of a busy host before rank 0 binds it.
        init = f"file://{tmp}/rendezvous"
        ctx = mp.start_processes(_rank, args=(n_devices, str(dev), init, tmp),
                                 nprocs=n_devices, join=False, start_method="spawn")
        deadline = time.monotonic() + DRYRUN_TIMEOUT_S
        while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
            if time.monotonic() > deadline:
                for p in ctx.processes:
                    p.kill()
                raise RuntimeError(f"dry run's {n_devices} ranks outlived {DRYRUN_TIMEOUT_S} s")
        ranks = [json.loads((Path(tmp) / f"rank{r}.json").read_text()) for r in range(n_devices)]
    losses = [r["loss"] for r in ranks]
    assert all(np.isfinite(losses)), f"train step produced a non-finite loss: {losses}"
    assert max(losses) - min(losses) <= 1e-6 * abs(losses[0]), (
        f"ranks disagree on the global-batch loss: {losses}"
    )
    for r in ranks:
        assert r["topk_shape"] == [4, 5], r
        assert r["topk_exact"], f"rank {r['rank']}: sharded top-k differs from the dense oracle"
        assert r["masked_ok"], f"rank {r['rank']}: masked top-k returned a filtered row"
    launches: dict[str, int] = {}
    for r in ranks:
        for part in ("train_launches", "topk_launches"):
            for name, n in r[part].items():
                launches[name] = launches.get(name, 0) + n
    dp, tp = _mesh_shape(n_devices)
    print(
        f"dryrun_multichip OK on {n_devices} ranks ({dev.type}, dp={dp} x tp={tp}): "
        f"loss={losses[0]:.4f} (+ sharded/masked top-k over {ranks[0]['catalog_shards']} "
        f"shards)",
        flush=True,
    )
    return {"n": n_devices, "dp": dp, "tp": tp, "device": dev.type, "loss": losses[0],
            "ranks": ranks, "launches": launches}


if __name__ == "__main__":
    import argparse

    parser = argparse.ArgumentParser(description="Multi-rank dry run of the port")
    parser.add_argument("n", type=int, nargs="?", default=2)
    parser.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = parser.parse_args()
    dryrun_multichip(args.n, args.device)
    sys.exit(0)
