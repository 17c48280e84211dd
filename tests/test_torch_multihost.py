"""The port's multi-process harness (``scripts/torch_launch_multihost.py``)
on the CPU: two training processes on 127.0.0.1 with torchrun's environment,
joined by ``parallel.init_distributed`` over gloo, with the four cases of
``tests/test_multihost.py``: train and retrieval, the resume broadcast, the
scaling baseline, and tensor parallelism across the process boundary.

The port runs one process per device, so a run's devices are its
processes, and each process's catalog index shards over its own device
(``--local-devices`` shards): there is no catalog across processes."""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from instacart_next_order_recommendation_tpu_torch.parallel import host_rendezvous
from scripts.torch_launch_multihost import prepare_workspace

REPO = Path(__file__).resolve().parents[1]
LAUNCHER = REPO / "scripts" / "torch_launch_multihost.py"


@pytest.fixture(scope="module")
def workspace(tmp_path_factory) -> Path:
    ws = tmp_path_factory.mktemp("mh") / "ws"
    ws.mkdir()
    prepare_workspace(ws, 80, 120)
    return ws


def launch(workspace: Path, *flags: str, timeout: int = 420) -> dict:
    proc = subprocess.run(
        [
            sys.executable, str(LAUNCHER),
            "--processes", "2",
            "--epochs", "1",
            "--catalog", "2000",
            "--workspace", str(workspace),
            "--port", "0",  # the launcher holds its rendezvous port from start to end
            "--timeout", str(timeout - 60),
            "--device", "cpu",
            *flags,
        ],
        capture_output=True, text=True, timeout=timeout,
    )
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_two_process_train_and_retrieval(workspace):
    summary = launch(workspace, "--local-devices", "1", "--per-device-batch", "8")
    multi = summary["multi"]
    assert multi["processes"] == 2 and multi["global_devices"] == 2
    assert multi["backend"] == "gloo"
    assert multi["train_loss_finite"]
    assert multi["retrieval_exact_top1"]
    assert multi["train_examples_per_s"] > 0
    assert multi["retrieval_qps"] > 0
    assert multi["dp_crosses_process"] and not multi["tp_crosses_process"]
    # Only process 0 writes the output tree.
    model_dir = workspace / "model_np2"
    assert (model_dir / "final").exists()
    assert (model_dir / "eval_history.json").exists()


RESUME_WORKER = """
import os, sys
sys.path.insert(0, {repo!r})
import torch
torch.set_num_threads(1)
ws, epochs, resume = sys.argv[1:4]
from instacart_next_order_recommendation_tpu_torch.parallel import init_distributed
from instacart_next_order_recommendation_tpu_torch.train import TrainConfig, TwoTowerTrainer
init_distributed("cpu")
cfg = TrainConfig({{
    "processed_dir": ws + "/processed",
    "output_dir": ws + "/model",
    "model_name": ws + "/tiny_tower",
    "max_seq_length": 32,
    "epochs": int(epochs),
    "train_batch_size": 8,
    "run_information_retrieval_evaluator": False,
    "logging_steps": 10000,
    "resume": resume == "1",
}})
trainer = TwoTowerTrainer(cfg, device="cpu")
res = trainer.train()
print("EPOCHS " + ",".join(str(h["epoch"]) for h in res["history"]))
print("STEPS " + str(len(trainer.step_losses)))
"""


def test_two_process_resume_broadcast(workspace):
    """Rank 0 reads the checkpoint and broadcasts the state; both processes
    continue from epoch 2. The port broadcasts the history as well, so both
    ranks report epochs 1 and 2 (the JAX harness's rank 1 reports 2 alone);
    each trained one epoch's steps in the resumed run."""
    ws = workspace / "resume"
    ws.mkdir()
    for name in ("processed", "tiny_tower"):
        (ws / name).symlink_to(workspace / name)

    def run_pair(epochs: int, resume: str) -> list[str]:
        # This process hosts the rendezvous on a port it holds until both
        # ranks exit: a port found free and released may be given to another
        # socket on a busy host before rank 0 binds it.
        store, rendezvous = host_rendezvous()
        script = RESUME_WORKER.format(repo=str(REPO))
        procs = [
            subprocess.Popen(
                [sys.executable, "-c", script, str(ws), str(epochs), resume],
                env=dict(os.environ, **rendezvous, RANK=str(rank), WORLD_SIZE="2",
                         LOCAL_RANK=str(rank)),
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            for rank in (0, 1)
        ]
        outs = []
        try:
            for p in procs:
                out, _ = p.communicate(timeout=300)
                outs.append(out)
                assert p.returncode == 0, out[-2000:]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
            del store
        return outs

    def steps(out: str) -> int:
        return int(out.split("STEPS ")[1].split()[0])

    first = run_pair(1, "0")  # epoch 1 on both; only process 0 writes
    assert (ws / "model" / "checkpoint-epoch1").exists()
    assert all("EPOCHS 1" in o for o in first)
    outs = run_pair(2, "1")  # resume: both must continue at epoch 2
    for out in outs:
        assert "EPOCHS 1,2" in out, out[-1500:]
        assert steps(out) == steps(first[0]) > 0, out[-1500:]


def test_two_process_scaling_efficiency_baseline(workspace):
    """--baseline gives a weak-scaling efficiency. Processes on one host
    share its cores, so the floors only guard against collapse (a deadlock
    or collectives serializing the whole step), as the JAX test's do."""
    summary = launch(workspace, "--local-devices", "1", "--per-device-batch", "8", "--baseline",
                     timeout=600)
    eff = summary["scaling_efficiency"]
    assert summary["baseline"]["processes"] == 1 and summary["baseline"]["backend"] is None
    assert summary["multi"]["processes"] == 2
    assert eff["train"] >= 0.015, eff
    assert eff["retrieval"] >= 0.008, eff


def test_two_process_tensor_parallel_crosses_boundary(workspace):
    """2 processes, model_parallel 2: the Megatron-TP step's collectives
    cross the process boundary; each process's catalog in 2 shards."""
    summary = launch(workspace, "--local-devices", "2", "--model-parallel", "2",
                     "--per-device-batch", "32")
    multi = summary["multi"]
    assert multi["processes"] == 2 and multi["global_devices"] == 2
    assert multi["model_parallel"] == 2
    assert multi["train_loss_finite"]
    assert multi["retrieval_exact_top1"] and multi["catalog_shards"] == 2
    assert multi["tp_crosses_process"] and not multi["dp_crosses_process"], multi
    assert (workspace / "model_np2_mp2" / "final").exists()
