"""Multi-process harness of the port: launch N training processes and bench them.

The port's counterpart of ``scripts/launch_multihost.py``. It checks the
multi-process path (torchrun's environment, ``parallel.init_distributed``,
the process mesh, the real trainer) on one host, and doubles as the launch
recipe where several hosts exist:

- **One host** (this script)::

    python scripts/torch_launch_multihost.py --processes 2 [--model-parallel 2]

  spawns N worker processes on 127.0.0.1, each with torchrun's environment
  (``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``,
  ``LOCAL_RANK``). Each joins the process group through
  ``parallel.init_distributed`` and runs (a) the real ``TwoTowerTrainer`` on
  a tiny synthetic workspace over a ``(dp, tp)`` process mesh
  (``--model-parallel``), and (b) row-sharded catalog retrieval
  (``ShardedCatalogIndex``). Process 0 reports global examples/s, queries/s,
  whether the loss is finite, whether the retrieval's top-1 is exact, and
  whether the model and data groups span processes; ``--baseline`` adds a
  one-process run of the same per-process workload and the weak-scaling
  efficiency against it.

  The port's serving mesh lives inside one process (a device mesh over
  that process's devices), so each process runs its own catalog index,
  ``--local-devices`` row shards on its device: there is no catalog that
  spans processes, and the retrieval reading is per process.

  Processes default to the GPU: one per card over NCCL, or, where the host
  has fewer cards than processes, sharing them over gloo (NCCL refuses two
  ranks on one GPU; ``init_distributed`` decides); ``--device cpu`` runs
  them on the CPU. Numbers from processes that share a card or the host's cores check
  function, not speed: the printed efficiency is a lower bound.

- **Several hosts** (one launcher per host, torchrun's rendezvous)::

    # on host i of N, each with G GPUs:
    torchrun --nnodes N --node-rank i --nproc-per-node G \\
        --rdzv-backend c10d --rdzv-endpoint <host0>:29500 \\
        -m instacart_next_order_recommendation_tpu_torch.train --config configs/train.yaml

  with ``data_parallel``/``model_parallel`` in the YAML; torchrun sets the
  environment that ``init_distributed`` reads on every process.
"""

from __future__ import annotations

# Allow running as `python scripts/<name>.py` from a repo checkout.
import sys as _sys
from pathlib import Path as _Path

_REPO_ROOT = _Path(__file__).resolve().parents[1]
if str(_REPO_ROOT) not in _sys.path:
    _sys.path.insert(0, str(_REPO_ROOT))

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

RETRIEVAL_REPS = 20
RETRIEVAL_QUERIES = 256
RETRIEVAL_DIM = 64


def _worker(args) -> None:
    """One training process: join the group, train, then the retrieval bench."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from datasets import load_from_disk

    from instacart_next_order_recommendation_tpu_torch.data.batching import steps_per_epoch
    from instacart_next_order_recommendation_tpu_torch.device import resolve_device
    from instacart_next_order_recommendation_tpu_torch.index import ShardedCatalogIndex
    from instacart_next_order_recommendation_tpu_torch.ops import (
        launch_counts,
        reset_launch_counts,
    )
    from instacart_next_order_recommendation_tpu_torch.parallel import (
        MeshConfig,
        build_mesh,
        init_distributed,
    )
    from instacart_next_order_recommendation_tpu_torch.train import TrainConfig, TwoTowerTrainer
    from instacart_next_order_recommendation_tpu_torch.utils.logging import (
        setup_colored_logging,
    )

    dev = resolve_device(args.device)
    if dev.type == "cpu":
        torch.set_num_threads(1)  # the processes share the host's cores
    setup_colored_logging(quiet_loggers=["datasets"])
    init_distributed(dev)
    world = dist.get_world_size() if dist.is_initialized() else 1
    result: dict = {
        "processes": world,
        "global_devices": world,  # one device per process
        "local_devices": 1,
        "backend": dist.get_backend() if dist.is_initialized() else None,
        "model_parallel": args.model_parallel,
    }

    # --- train bench: the real trainer over the process mesh ---------------
    out_name = f"model_np{world}" + (f"_mp{args.model_parallel}" if args.model_parallel > 1 else "")
    cfg = TrainConfig(
        {
            "processed_dir": str(args.workspace / "processed"),
            "output_dir": str(args.workspace / out_name),
            "model_name": str(args.workspace / "tiny_tower"),
            "max_seq_length": 32,
            "epochs": args.epochs,
            # train_batch_size is per data rank (global = batch x dp), so the
            # global batch grows with the mesh: weak scaling.
            "train_batch_size": args.per_device_batch,
            "model_parallel": args.model_parallel,
            "train_step_mode": "shard_map" if args.model_parallel > 1 else "auto",
            "run_information_retrieval_evaluator": False,
            "logging_steps": 10_000,
            "steps_per_dispatch": 1,
        }
    )
    reset_launch_counts()
    trainer = TwoTowerTrainer(cfg, device=dev)
    t_res = trainer.train()
    result["train_launches"] = launch_counts()
    pm = trainer.mesh
    # Which mesh axes span processes: the collectives along such an axis
    # cross a process boundary (sockets or NCCL's transport here, the
    # network between hosts on a cluster).
    for axis, group in (("tp", pm.model_group), ("dp", pm.data_group)):
        ranks = dist.get_process_group_ranks(group) if group is not None else [pm.rank]
        result[f"{axis}_crosses_process"] = len(set(ranks)) > 1
    last = t_res["history"][-1]  # steady state: the first epoch pays one-time costs
    global_batch = args.per_device_batch * pm.dp
    n_pairs = len(load_from_disk(str(args.workspace / "processed" / "train_dataset")))
    n_seen = global_batch * steps_per_epoch(n_pairs, global_batch)
    result["train_examples_per_s"] = round(n_seen / last["epoch_seconds"], 1)
    result["train_loss_final"] = last["train_loss"]
    result["train_loss_finite"] = bool(np.isfinite(last["train_loss"]))

    # --- retrieval bench: this process's row-sharded catalog ---------------
    rng = np.random.default_rng(0)
    cat = rng.standard_normal((args.catalog, RETRIEVAL_DIM), dtype=np.float32)
    cat /= np.linalg.norm(cat, axis=1, keepdims=True)
    queries = cat[rng.integers(0, args.catalog, size=RETRIEVAL_QUERIES)]
    mesh = build_mesh(MeshConfig(args.local_devices, 1), devices=[trainer.device] * args.local_devices)
    reset_launch_counts()
    index = ShardedCatalogIndex(cat, mesh=mesh)
    index.topk(queries, 10)  # warm-up: the kernel library loads
    t0 = time.time()
    for _ in range(RETRIEVAL_REPS):
        scores, ids = index.topk(queries, 10)  # host results: each call syncs
    dt = time.time() - t0
    result["retrieval_launches"] = launch_counts()
    result["catalog_shards"] = index.dp
    result["retrieval_qps"] = round(RETRIEVAL_REPS * len(queries) / dt, 1)
    expect = np.argsort(-(queries @ cat.T), axis=1)[:, :1]
    result["retrieval_exact_top1"] = bool((ids[:, :1] == expect).all())

    if pm.is_main:
        print("WORKER_RESULT " + json.dumps(result), flush=True)
    if dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()


def prepare_workspace(base: Path, n_users: int, n_products: int) -> None:
    """Synthetic workspace and a tiny warm-start tower, built once before the
    launch: head_dim 32 and S=32, so a data-parallel step takes the fused
    layer on the card and a tensor-parallel one the unfused layer."""
    import dataclasses

    import torch

    from instacart_next_order_recommendation_tpu_torch.data import InstacartDataPrep
    from instacart_next_order_recommendation_tpu_torch.data.synthetic import (
        generate_instacart_csvs,
    )
    from instacart_next_order_recommendation_tpu_torch.models.checkpoint import save_tower
    from instacart_next_order_recommendation_tpu_torch.models.encoder import (
        MINILM_L6,
        init_params,
    )
    from instacart_next_order_recommendation_tpu_torch.tokenizer import WordPieceTokenizer

    if (base / "processed" / "train_dataset").exists():
        return
    data_dir = generate_instacart_csvs(base / "data", n_users=n_users, n_products=n_products, seed=0)
    prep = InstacartDataPrep(data_dir=data_dir, output_dir=base / "p", eval_frac=0.15)
    prep.prepare()
    prep.effective_output_dir().rename(base / "processed")

    corpus = json.loads((base / "processed" / "eval_corpus.json").read_text())
    tok = WordPieceTokenizer.train(list(corpus.values()), vocab_size=4000)
    cfg = dataclasses.replace(
        MINILM_L6, hidden_size=64, num_layers=2, num_heads=2, intermediate_size=128,
        vocab_size=tok.vocab_size, max_position=64, max_seq_length=32,
    )
    save_tower(base / "tiny_tower", init_params(cfg, torch.Generator().manual_seed(0)), cfg, tok)


def _worker_argv(args) -> list[str]:
    argv = [
        "--worker",
        "--local-devices", str(args.local_devices),
        "--per-device-batch", str(args.per_device_batch),
        "--epochs", str(args.epochs),
        "--catalog", str(args.catalog),
        "--workspace", str(args.workspace),
        "--model-parallel", str(args.model_parallel),
    ]
    if args.device:
        argv += ["--device", args.device]
    return argv


def _run_group(args, n_processes: int, port: int) -> dict:
    """Spawn ``n_processes`` workers with torchrun's environment; return
    process 0's result. This process hosts the group's rendezvous store on
    ``port`` (0: one the OS picks) and holds it until the workers exit
    (``parallel.host_rendezvous``)."""
    from instacart_next_order_recommendation_tpu_torch.parallel import host_rendezvous

    store, rendezvous = host_rendezvous(port=port)
    procs = []
    for rank in range(n_processes):
        env = dict(os.environ, **rendezvous, RANK=str(rank), WORLD_SIZE=str(n_processes),
                   LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(n_processes))
        procs.append(
            subprocess.Popen(
                [sys.executable, __file__, *_worker_argv(args)], env=env,
                stdout=subprocess.PIPE if rank == 0 else subprocess.DEVNULL,
                stderr=subprocess.STDOUT,
            )
        )
    try:
        out, _ = procs[0].communicate(timeout=args.timeout)
        for p in procs[1:]:
            p.wait(timeout=60)
    except subprocess.TimeoutExpired:
        # A wedged worker must not leak processes holding the port.
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait(timeout=30)
        raise
    del store  # every worker has exited
    text = out.decode()
    bad = [p.returncode for p in procs if p.returncode != 0]
    for line in text.splitlines():
        if line.startswith("WORKER_RESULT ") and not bad:
            return json.loads(line[len("WORKER_RESULT "):])
    raise RuntimeError(
        f"worker group (n={n_processes}) produced no result (exit codes "
        f"{[p.returncode for p in procs]}); tail:\n" + "\n".join(text.splitlines()[-30:])
    )


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description="Multi-process scaling harness")
    parser.add_argument("--processes", type=int, default=2)
    parser.add_argument(
        "--local-devices", type=int, default=2,
        help="row shards of each process's catalog index, on that process's device",
    )
    parser.add_argument(
        "--model-parallel", type=int, default=1,
        help="Megatron-TP degree of the process mesh; with processes=2 and"
        " model-parallel=2 the TP collectives cross a process boundary.",
    )
    parser.add_argument("--per-device-batch", type=int, default=16)
    parser.add_argument("--epochs", type=int, default=2)
    parser.add_argument("--catalog", type=int, default=20_000)
    parser.add_argument("--users", type=int, default=200)
    parser.add_argument("--products", type=int, default=300)
    parser.add_argument("--workspace", type=Path, default=Path("torch_mh_workspace"))
    parser.add_argument(
        "--port", type=int, default=8476,
        help="port of the rendezvous store this launcher hosts (the baseline's is one above); "
        "0: ports the OS picks",
    )
    parser.add_argument("--timeout", type=int, default=1200)
    parser.add_argument(
        "--baseline", action="store_true",
        help="also run a 1-process group and report scaling efficiency",
    )
    parser.add_argument("--device", default=None, help="cuda (the default) or cpu")
    parser.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = parser.parse_args(argv)

    if args.worker:
        _worker(args)
        return 0

    from instacart_next_order_recommendation_tpu_torch.device import resolve_device

    resolve_device(args.device)  # before any work: no card and no --device cpu raises
    args.workspace.mkdir(parents=True, exist_ok=True)
    prepare_workspace(args.workspace, args.users, args.products)

    summary: dict = {"metric": "multihost_scaling", "config": {
        "processes": args.processes, "local_devices": args.local_devices,
        "per_device_batch": args.per_device_batch, "catalog": args.catalog,
        "model_parallel": args.model_parallel, "device": args.device or "cuda",
    }}
    if args.baseline:
        print("=== baseline: 1 process ===", flush=True)
        base = _run_group(args, 1, args.port + 1 if args.port else 0)
        summary["baseline"] = base
        print(json.dumps(base), flush=True)

    print(f"=== {args.processes} processes ===", flush=True)
    multi = _run_group(args, args.processes, args.port)
    summary["multi"] = multi
    print(json.dumps(multi), flush=True)

    if args.baseline:
        n = args.processes
        summary["scaling_efficiency"] = {
            # Weak scaling: the per-process workload is constant, so ideal = n x base.
            "train": round(multi["train_examples_per_s"] / (n * base["train_examples_per_s"]), 3),
            "retrieval": round(multi["retrieval_qps"] / (n * base["retrieval_qps"]), 3),
            "note": "processes on one host share its cores (and here its cards); this is a "
            "functional lower bound, not an interconnect number",
        }
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
