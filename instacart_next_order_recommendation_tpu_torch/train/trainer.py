"""Two-tower contrastive trainer on one GPU or one process per GPU.

Counterpart of the JAX package's ``train/trainer.py``: loads
the processed (anchor, positive) datasets and IR artifacts, trains the
shared tower with MultipleNegativesRankingLoss, AdamW on a warmup-cosine
schedule (10% warmup from 0), no-duplicates batching with drop_last,
per-epoch eval loss and IR evaluation, epoch checkpoints with keep-N
retention that never prunes the best, best-by-NDCG@10 selection, and a
``final/`` export. Towers are written in the shared format, so either
package reads the other's checkpoints; the optimizer state goes in the
port's own file.

Each step encodes both towers with dropout (the fused layer's training form:
forward kernel with masks, fused backward kernel; or, for a shape the fused
kernels do not take, the unfused layer with the attention kernels, each
layer rematerialized when ``remat`` resolves on) and takes one AdamW step
per ``gradient_accumulation_steps`` micro-batches on the mean of their
gradients, as ``optax.MultiSteps`` does. The schedule is evaluated at the
count of optimizer steps taken before the update, as optax does, so the
first step runs at lr 0.

Several processes (torchrun: one per GPU) form a ``(data_parallel,
model_parallel)`` process mesh (``parallel/mesh.py``), the JAX trainer's
shard_map step in PyTorch's terms: ``train_batch_size`` is per data rank
and the no-duplicates sampler draws the global batch, of which each data
rank takes its block; MNRL's negatives are the global batch (the positives
gathered over the data group); the dropout seed folds in the data rank
only, so the model ranks of one replica draw the same masks; the loss and
the gradients are averaged over the data group, the gradients in one flat
all-reduce a step; with ``model_parallel`` > 1 each rank holds its
Megatron shards (``parallel/shardings.py``) and the layers run unfused with
``tp_enter``/``tp_exit`` (``models/encoder.py``); AdamW steps each rank's
own tensors. Rank 0 alone evaluates (and sends every rank the metrics) and
writes; checkpoints hold the full params and optimizer state, gathered over
the model group, and a resume reads them on rank 0 and broadcasts them.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import itertools
import json
import logging
import math
import os
import shutil
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from instacart_next_order_recommendation_tpu_torch.constants import (
    DATA_PREP_PARAMS_FILENAME,
    DEFAULT_CONFIG_TRAIN,
    DEFAULT_OUTPUT_DIR,
    DEFAULT_PROCESSED_DIR,
    EVAL_CORPUS_FILENAME,
    EVAL_DATASET_SUBDIR,
    EVAL_QUERIES_FILENAME,
    EVAL_RELEVANT_DOCS_FILENAME,
    FINAL_SUBDIR,
    TRAIN_DATASET_SUBDIR,
)
from instacart_next_order_recommendation_tpu_torch.data.batching import (
    no_duplicates_batches,
    steps_per_epoch,
)
from instacart_next_order_recommendation_tpu_torch.device import resolve_device
from instacart_next_order_recommendation_tpu_torch.eval.evaluator import RetrievalEvaluator
from instacart_next_order_recommendation_tpu_torch.models.checkpoint import load_tower, save_tower
from instacart_next_order_recommendation_tpu_torch.models.encoder import (
    MINILM_L6,
    MPNET_BASE_CLASS,
    Params,
    TowerConfig,
    encode,
    init_params,
    tower_widths,
)
from instacart_next_order_recommendation_tpu_torch.models.text_encoder import (
    TextEncoder,
    params_to_device,
)
from instacart_next_order_recommendation_tpu_torch.ops import fused_layer, mnrl_loss
from instacart_next_order_recommendation_tpu_torch.parallel.mesh import (
    MeshConfig,
    ProcessMesh,
    gather_host,
    init_distributed,
)
from instacart_next_order_recommendation_tpu_torch.parallel.shardings import (
    shard,
    shard_params,
    split_dim,
    validate_tp,
)
from instacart_next_order_recommendation_tpu_torch.tokenizer import (
    WordPieceTokenizer,
    bucket_length,
)
from instacart_next_order_recommendation_tpu_torch.utils.config import (
    load_yaml_config,
    resolve_project_path,
)
from instacart_next_order_recommendation_tpu_torch.utils.logging import setup_colored_logging
from instacart_next_order_recommendation_tpu_torch.utils import profiling
from instacart_next_order_recommendation_tpu_torch.utils.profiling import (
    ENV_PROFILE_DIR,
    device_profiler,
    span,
)
from instacart_next_order_recommendation_tpu_torch.utils.resolve import resolve_processed_dir

logger = logging.getLogger(__name__)

_PRESETS = {"minilm-l6": MINILM_L6, "mpnet-base": MPNET_BASE_CLASS}

BEST_METRIC = "ndcg_at_10"
OPT_STATE_FILENAME = "opt_state.pt"  # the port's own; the JAX trainer writes opt_state.msgpack
TRAIN_STATE_FILENAME = "train_state.json"
ENV_LOOP_TIMING = "ITOR_LOOP_TIMING"
LOOP_PHASES = ("train.assemble", "train.seeds", "train.step")


class TrainConfig:
    """Typed training configuration: the JAX trainer's YAML keys."""

    def __init__(self, raw: dict):
        self.processed_dir = resolve_project_path(raw.get("processed_dir"), DEFAULT_PROCESSED_DIR)
        self.output_dir = resolve_project_path(raw.get("output_dir"), DEFAULT_OUTPUT_DIR)
        # Preset name or a tower directory to warm-start from.
        self.model_name = str(raw.get("model_name", "minilm-l6"))
        self.max_seq_length = int(raw.get("max_seq_length", 256))
        self.epochs = int(raw.get("epochs", 5))
        self.train_batch_size = int(raw.get("train_batch_size", 64))
        self.eval_batch_size = int(raw.get("eval_batch_size", 64))
        self.gradient_accumulation_steps = int(raw.get("gradient_accumulation_steps", 1))
        self.learning_rate = float(raw.get("learning_rate", 5e-5))
        self.loss_scale = float(raw.get("loss_scale", 30.0))
        self.weight_decay = float(raw.get("weight_decay", 0.0))
        self.run_information_retrieval_evaluator = bool(
            raw.get("run_information_retrieval_evaluator", True)
        )
        self.vocab_size = int(raw.get("vocab_size", 30000))
        self.seed = int(raw.get("seed", 42))
        # Processes on the data axis; None = every process the model axis leaves.
        self.data_parallel = raw.get("data_parallel")
        self.model_parallel = int(raw.get("model_parallel", 1))
        # The JAX trainer's choice between two formulations of its step,
        # validated as there; the port has one (``TrainStep``) and runs it
        # for each.
        self.train_step_mode = str(raw.get("train_step_mode", "auto"))
        if self.train_step_mode not in ("auto", "gspmd", "shard_map"):
            raise ValueError(
                f"train_step_mode must be auto|gspmd|shard_map, got {self.train_step_mode!r}"
            )
        self.save_total_limit = int(raw.get("save_total_limit", 2))
        self.logging_steps = int(raw.get("logging_steps", 100))
        self.resume = bool(raw.get("resume", False))
        # Batches are taken in groups of this many; a ragged trailing group
        # is dropped, so an epoch has as many steps as in the JAX trainer.
        self.steps_per_dispatch = int(raw.get("steps_per_dispatch", 1))
        # Layer rematerialization; None = auto (``_resolve_remat``): on at
        # batch >= 256 for a tower the fused kernels do not take, whose
        # unfused layers would otherwise keep every activation for the
        # backward. The fused backward keeps only the layer inputs (and at
        # most four residuals), so there remat changes nothing.
        self.remat = raw.get("remat")

    @classmethod
    def load(cls, config_path: Path | None = None) -> "TrainConfig":
        return cls(load_yaml_config(config_path, DEFAULT_CONFIG_TRAIN))


def warmup_cosine_schedule(peak: float, total_steps: int):
    """The JAX trainer's schedule (``optax.warmup_cosine_decay_schedule``
    from 0 to ``peak`` over max(1, 10% of total) steps, cosine to 0 at
    max(2, total)): a function of the optimizer-step count."""
    warmup = max(1, int(0.1 * total_steps))
    decay = max(2, total_steps) - warmup

    def lr(count: int) -> float:
        if count < warmup:
            return -peak * (1.0 - max(count, 0) / warmup) + peak
        c = min(count - warmup, decay)
        return peak * 0.5 * (1.0 + math.cos(math.pi * c / decay))

    return lr


def param_leaves(params: Params, prefix: str = "") -> list[tuple[str, torch.Tensor]]:
    """(path, tensor) for every parameter, in sorted key order."""
    out = []
    for key in sorted(params):
        value = params[key]
        if isinstance(value, dict):
            out += param_leaves(value, f"{prefix}{key}/")
        else:
            out.append((f"{prefix}{key}", value))
    return out


def dropout_seed(seed: int, epoch: int, step: int, data_rank: int = 0) -> int:
    """Dropout seed of one micro-step: a pure function of the run seed, the
    epoch, the step within it and the data rank (never the model rank: the
    ranks of one tensor-parallel group must draw the same masks), so a
    resumed run draws the same masks."""
    p = 1_000_003
    return ((seed * p + epoch) * p + step + data_rank * p**3) % (1 << 64)


def average_over_data(tensors: list[torch.Tensor], group, dp: int) -> None:
    """Replace each tensor by its mean over the data group, in one flat f32
    all-reduce (one collective a step, not one per leaf)."""
    flat = torch.cat([t.reshape(-1).to(torch.float32) for t in tensors])
    dist.all_reduce(flat, group=group)
    flat /= dp
    for t, part in zip(tensors, flat.split([t.numel() for t in tensors])):
        t.copy_(part.view_as(t))


class TrainStep:
    """One micro-step of the trainer: both towers with dropout drawn from a
    generator seeded per step, MNRL, backward; every
    ``accum``-th call also takes the AdamW step on the mean of the
    accumulated gradients, at the schedule's lr for the count of optimizer
    steps taken so far.

    Each tower runs only as wide as its batch's longest real row, rounded
    up to 16 (``encoder.tower_widths``: both widths in one device read,
    before anything of the step launches), so short positives do not run at
    the anchors' width. The dropout masks are drawn at the handed shape and
    then cut (``encoder.encode``), so a step's masks and the generator's
    state after it are those of the uncut step."""

    def __init__(
        self, params, tower_cfg, optimizer, schedule, *, loss_scale, accum, device, mesh=None
    ):
        """``mesh``: this process's ``ProcessMesh`` (None: one process).
        ``params`` are then this rank's shards, and ``__call__`` takes this
        rank's block of the global batch."""
        self.params = params
        self.data_group = None if mesh is None else mesh.data_group
        self.model_group = None if mesh is None else mesh.model_group
        self.dp = 1 if mesh is None else mesh.dp
        self.tower_cfg = tower_cfg
        self.optimizer = optimizer
        self.schedule = schedule
        self.loss_scale = loss_scale
        self.accum = max(1, accum)
        self.generator = torch.Generator(device=device)
        self.opt_steps = 0  # optimizer updates taken (the schedule's count)
        self.micro = 0  # micro-batches into the current accumulation

    def __call__(self, batch: list[torch.Tensor], seed: int) -> torch.Tensor:
        """The spans ``train.step``, and inside it ``train.forward``,
        ``train.backward`` and (on an optimizer step) ``train.optimizer``."""
        with span("train.step"):
            a_ids, a_mask, p_ids, p_mask = batch
            # Waits for the batch's copies (and for whatever the stream holds
            # before them), then launches the whole step without a read.
            a_width, p_width = tower_widths(a_mask, p_mask)
            self.generator.manual_seed(seed)
            kw = dict(generator=self.generator, model_group=self.model_group)
            with span("train.forward"):
                qa = encode(self.params, a_ids, a_mask, self.tower_cfg, width=a_width, **kw)
                qp = encode(self.params, p_ids, p_mask, self.tower_cfg, width=p_width, **kw)
                loss = mnrl_loss(qa, qp, scale=self.loss_scale, group=self.data_group)
            with span("train.backward"):
                (loss / self.accum).backward()  # grads sum to the mean over the micro-batches
                loss = loss.detach()
                self.micro += 1
                if self.data_group is not None:
                    # Gradients of split and replicated leaves alike: tp_enter has
                    # made the replicated ones whole on every model rank already.
                    box = [loss.reshape(1).clone()]
                    if self.micro == self.accum:
                        box = [t.grad for _, t in param_leaves(self.params)] + box
                    average_over_data(box, self.data_group, self.dp)
                    loss = box[-1][0]
            if self.micro == self.accum:
                with span("train.optimizer"):
                    lr = self.schedule(self.opt_steps)
                    for group in self.optimizer.param_groups:
                        group["lr"] = lr
                    self.optimizer.step()
                    self.optimizer.zero_grad(set_to_none=True)
                    self.opt_steps += 1
                    self.micro = 0
            return loss

    def state(self) -> dict:
        """What a checkpoint keeps to resume the optimizer exactly."""
        return {
            "optimizer": self.optimizer.state_dict(),
            "opt_steps": self.opt_steps,
            "micro": self.micro,
            "acc_grads": [
                None if t.grad is None else t.grad.detach().cpu()
                for _, t in param_leaves(self.params)
            ],
        }

    def load_state(self, state: dict) -> None:
        self.optimizer.load_state_dict(state["optimizer"])
        self.opt_steps, self.micro = int(state["opt_steps"]), int(state["micro"])
        for (_, t), g in zip(param_leaves(self.params), state["acc_grads"]):
            t.grad = None if g is None else g.to(t.device)


def loop_timing_line(recorded: list[profiling.Span], n: int, since_ns: int | None) -> int:
    """Log ``ITOR_LOOP_TIMING``'s line, the JAX trainer's, from the spans
    ``recorded`` of the last ``n`` dispatches: the mean host ms a dispatch
    of ``train.assemble`` (assembly and transfers), ``train.seeds`` (the
    dropout seeds, JAX's "fold_in"), ``train.step`` (the steps' submission)
    and the wall time since ``since_ns`` (the last line's end; the first
    line's first assembly otherwise). Returns the end of the last span."""
    done = [s for s in recorded if s.name in LOOP_PHASES]
    ms = {name: 0.0 for name in LOOP_PHASES}
    for s in done:
        ms[s.name] += 1e-6 * (s.end_ns - s.start_ns) / n
    end_ns = max(s.end_ns for s in done)
    if since_ns is None:
        since_ns = min(s.start_ns for s in done)
    logger.info(
        "  loop timing/dispatch: assemble %.0f ms, fold_in %.0f ms, submit %.0f ms, wall %.0f ms",
        *ms.values(), 1e-6 * (end_ns - since_ns) / n,
    )
    return end_ns


def build_optimizer(params: Params, weight_decay: float) -> torch.optim.AdamW:
    """AdamW as the JAX trainer's ``optax.adamw``: b1 0.9, b2 0.999, eps 1e-8,
    decoupled decay on every parameter; the lr is set per step."""
    return torch.optim.AdamW(
        [t for _, t in param_leaves(params)],
        lr=0.0,
        betas=(0.9, 0.999),
        eps=1e-8,
        weight_decay=weight_decay,
    )


class TwoTowerTrainer:
    """Runs the training pipeline on the GPU (``device=None``) or, for
    tests and small runs, the CPU (``device="cpu"``, the plain versions of
    the kernels), in this process alone or as one rank of a process group
    (``init_distributed``: torchrun's, or one the caller made)."""

    def __init__(self, config: TrainConfig, device: str | torch.device | None = None):
        self.cfg = config
        self.device = resolve_device(device)
        init_distributed(self.device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.mesh = ProcessMesh(MeshConfig(config.data_parallel, config.model_parallel))
        self.step_losses: list[float] = []

    # ------------------------------------------------------------------ data

    def _load_processed(self):
        from datasets import load_from_disk

        processed_dir, msg = resolve_processed_dir(self.cfg.processed_dir, DEFAULT_PROCESSED_DIR)
        if msg:
            logger.info("%s", msg)
        self.processed_dir = processed_dir
        train_ds = load_from_disk(str(processed_dir / TRAIN_DATASET_SUBDIR))
        eval_pairs = None
        if (processed_dir / EVAL_DATASET_SUBDIR).exists():
            eval_ds = load_from_disk(str(processed_dir / EVAL_DATASET_SUBDIR))
            eval_pairs = (list(eval_ds["anchor"]), list(eval_ds["positive"]))
        with open(processed_dir / EVAL_QUERIES_FILENAME) as f:
            eval_queries = json.load(f)
        with open(processed_dir / EVAL_CORPUS_FILENAME) as f:
            eval_corpus = json.load(f)
        with open(processed_dir / EVAL_RELEVANT_DOCS_FILENAME) as f:
            eval_relevant = {k: set(v) for k, v in json.load(f).items()}
        # list(): one bulk decode of the lazy Arrow columns.
        return (
            list(train_ds["anchor"]),
            list(train_ds["positive"]),
            eval_pairs,
            eval_queries,
            eval_corpus,
            eval_relevant,
        )

    # ------------------------------------------------------------------ model

    def _resolve_remat(self, hidden: int, num_heads: int, inter: int, seq: int) -> bool:
        """Remat policy: an explicit ``remat`` wins; below batch 256 it is
        off; at 256 and above it is on exactly when the fused kernels do not
        take the tower at ``seq``, the longest sequence a batch may run at
        (their backward keeps only the layer inputs, or the four residuals
        that ``fused_layer.saves_residuals`` asks for). They take head_dim
        16, 32, 64 and 128 at 16 <= S <= 512 with S % 16 == 0
        (``fused_layer.supports``), so remat stays on only for a ragged
        ``seq`` or a head_dim that does not divide 128.

        Two differences from the JAX trainer's policy. JAX also asks its
        backward kernel's VMEM gate (``bwd_supports``), which refuses
        mpnet-base-class on a v5e, and MiniLM-L6 at S = 512, so it keeps
        remat on for them at B >= 256 where the port, whose K5 takes both,
        turns it off: a TPU limit, not the function's. And JAX tests its
        gate at ``seq`` rounded down to a multiple of 16, though a batch
        that fills ``seq`` then takes the unfused layer; the port tests
        ``seq`` itself."""
        if self.cfg.remat is not None:
            return bool(self.cfg.remat)
        if self.cfg.train_batch_size < 256:
            return False
        return not fused_layer.supports(hidden, num_heads, seq, inter)

    def _build_model(self, corpus_texts_for_vocab):
        name = self.cfg.model_name
        preset = _PRESETS.get(name)

        def bounded_seq_len(tower_max_position: int) -> int:
            # max_seq_length cannot exceed the position-embedding table.
            if self.cfg.max_seq_length > tower_max_position:
                logger.warning(
                    "max_seq_length %d exceeds the tower's max_position %d; clamping",
                    self.cfg.max_seq_length,
                    tower_max_position,
                )
                return tower_max_position
            return self.cfg.max_seq_length

        def remat(tower: TowerConfig, seq: int) -> bool:
            return self._resolve_remat(
                tower.hidden_size, tower.num_heads, tower.intermediate_size, seq
            )

        if preset is not None:
            tokenizer = WordPieceTokenizer.train(
                corpus_texts_for_vocab, vocab_size=self.cfg.vocab_size
            )
            seq = bounded_seq_len(preset.max_position)
            config = dataclasses.replace(
                preset,
                vocab_size=tokenizer.vocab_size,
                max_seq_length=seq,
                remat=remat(preset, seq),
            )
            params = init_params(config, torch.Generator().manual_seed(self.cfg.seed))
            logger.info(
                "[2/5] model preset %s from scratch (vocab %d)", name, tokenizer.vocab_size
            )
        else:
            params, config, tokenizer = load_tower(name)
            if tokenizer is None:
                raise FileNotFoundError(f"warm-start dir {name} has no vocab.txt")
            seq = bounded_seq_len(config.max_position)
            config = dataclasses.replace(config, max_seq_length=seq, remat=remat(config, seq))
            logger.info("[2/5] warm start from %s", name)
        # Every later consumer (tokenization, TextEncoder, eval batches)
        # sees the clamped length.
        self.cfg.max_seq_length = config.max_seq_length
        logger.info("  remat %s", "on" if config.remat else "off")
        return params, config, tokenizer

    def _to_trainable(self, params: Params) -> Params:
        if isinstance(params, dict):
            return {k: self._to_trainable(v) for k, v in params.items()}
        return params.detach().to(self.device, torch.float32).clone().requires_grad_(True)

    # ------------------------------------------------------------------ checkpoints

    def _sorted_checkpoints(self) -> list:
        return sorted(
            self.cfg.output_dir.glob("checkpoint-epoch*"),
            key=lambda p: int(p.name.rsplit("epoch", 1)[1]),
        )

    def _save_epoch_checkpoint(self, epoch, params, opt_payload, tower_cfg, tokenizer, history):
        ckpt_dir = self.cfg.output_dir / f"checkpoint-epoch{epoch}"
        save_tower(ckpt_dir, params, tower_cfg, tokenizer)
        torch.save(opt_payload, ckpt_dir / OPT_STATE_FILENAME)
        (ckpt_dir / TRAIN_STATE_FILENAME).write_text(
            json.dumps({"epoch": epoch, "history": history})
        )
        # keep-N retention, but never prune the best-so-far checkpoint: the
        # end-of-run export loads it.
        ckpts = self._sorted_checkpoints()
        keep = {p.name for p in ckpts[-self.cfg.save_total_limit :]}
        scored = [h for h in history if BEST_METRIC in h]
        if scored:
            best = max(scored, key=lambda h: h[BEST_METRIC])["epoch"]
            keep.add(f"checkpoint-epoch{best}")
        for old in ckpts:
            if old.name not in keep:
                shutil.rmtree(old, ignore_errors=True)
        return ckpt_dir

    # ------------------------------------------------------------------ the mesh

    def _full_tree(self, leaves: list[tuple[str, torch.Tensor | None]]) -> list:
        """Host copies of ``(path, tensor)`` leaves shaped like the params,
        each whole: gathered over the model group where it is split."""
        pm = self.mesh
        out = []
        for path, t in leaves:
            if t is not None:
                t = t.detach().cpu()
                if pm.tp > 1 and split_dim(path) is not None:
                    t = gather_host(t, split_dim(path), pm.host_model_group)
            out.append(t)
        return out

    def _full_params(self, params: Params) -> Params:
        """The whole param tree (the one-process trainer's), on the host
        under tensor parallelism, else ``params`` itself."""
        if self.mesh.tp == 1:
            return params
        leaves = param_leaves(params)
        full: Params = {}
        for (path, _), t in zip(leaves, self._full_tree(leaves)):
            group, name = path.split("/")
            full.setdefault(group, {})[name] = t
        return full

    def _full_opt_state(self, train_step: "TrainStep") -> dict:
        """``train_step.state()`` with every moment and accumulated gradient
        whole, as a one-process run would save it."""
        state = train_step.state()
        if self.mesh.tp == 1:
            return state
        paths = [path for path, _ in param_leaves(train_step.params)]
        # state_dict() shares each parameter's state dict with the optimizer:
        # copy them before putting whole tensors in.
        moments = {i: dict(m) for i, m in state["optimizer"]["state"].items()}
        state["optimizer"] = {**state["optimizer"], "state": moments}
        for key in ("exp_avg", "exp_avg_sq"):
            have = [i for i in range(len(paths)) if key in moments.get(i, {})]  # none before a step
            full = self._full_tree([(paths[i], moments[i][key]) for i in have])
            for i, t in zip(have, full):
                moments[i][key] = t
        state["acc_grads"] = self._full_tree(list(zip(paths, state["acc_grads"])))
        return state

    def _local_opt_state(self, state: dict, params: Params) -> dict:
        """This rank's slice of a whole optimizer state (``_full_opt_state``)."""
        pm = self.mesh
        if pm.tp == 1:
            return state
        paths = [path for path, _ in param_leaves(params)]

        def cut(t, path):
            return None if t is None else shard(t, split_dim(path), pm.tp, pm.model_rank)

        for i, path in enumerate(paths):
            moments = state["optimizer"]["state"].get(i, {})
            for key in ("exp_avg", "exp_avg_sq"):
                if key in moments:
                    moments[key] = cut(moments[key], path)
        state["acc_grads"] = [cut(g, p) for g, p in zip(state["acc_grads"], paths)]
        return state

    def _resume(self) -> dict | None:
        """The newest checkpoint's state, read on rank 0 and broadcast to
        every rank (only rank 0 writes checkpoints, so on per-host disks only
        it can find one): epoch, history, whole params and optimizer state,
        tower config and vocab. None when there is none. Rank 0 keeps the
        checkpoint's tokenizer in ``_resume_tokenizer``."""
        state = None
        if self.mesh.is_main:
            ckpts = self._sorted_checkpoints()
            if ckpts:
                ckpt = ckpts[-1]
                params, tower_cfg, self._resume_tokenizer = load_tower(ckpt)
                train_state = json.loads((ckpt / TRAIN_STATE_FILENAME).read_text())
                state = {
                    "name": ckpt.name,
                    "epoch": int(train_state["epoch"]),
                    "history": train_state.get("history", []),
                    "params": params,
                    "opt": torch.load(ckpt / OPT_STATE_FILENAME, map_location="cpu"),
                    "tower": tower_cfg.to_dict(),
                    "vocab": self._resume_tokenizer.vocab,
                }
        return self.mesh.broadcast_object(state)

    def _evaluate(self, entry, params, tower_cfg, tokenizer, batch_size, evaluator) -> dict:
        """``entry`` with the eval loss and IR metrics of ``params`` (whole)
        added, on rank 0; every rank gets rank 0's entry, so the histories
        are equal."""
        if self.mesh.is_main:
            params = params_to_device(params, self.device)
            eval_loss = self._eval_loss(params, tower_cfg, tokenizer, batch_size)
            if eval_loss is not None:
                entry["eval_loss"] = eval_loss
            if evaluator is not None:
                encoder = TextEncoder(
                    params, tower_cfg, tokenizer, self.cfg.max_seq_length, device=self.device
                )
                entry.update(evaluator(encoder))
        return self.mesh.broadcast_object(entry)

    # ------------------------------------------------------------------ run

    def train(self, data=None) -> dict:
        """Run training; returns ``{"history", "best_epoch", "final_dir"}``
        (the same on every rank).

        ``data=None`` reads the processed directory, as the JAX trainer
        does. Otherwise ``data`` is ``(anchors, positives, eval_pairs,
        eval_queries, eval_corpus, eval_relevant)`` held in memory, with
        ``eval_pairs`` an ``(anchors, positives)`` pair of lists or None.
        """
        cfg = self.cfg
        pm = self.mesh
        if pm.is_main:
            cfg.output_dir.mkdir(parents=True, exist_ok=True)
        if data is None:
            data = self._load_processed()
        else:
            self.processed_dir = cfg.processed_dir
        anchors, positives, self.eval_pairs, eval_queries, eval_corpus, eval_relevant = data
        anchors, positives = list(anchors), list(positives)
        logger.info(
            "[1/5] train pairs: %d, queries: %d, corpus: %d",
            len(anchors), len(eval_queries), len(eval_corpus),
        )
        self._log_params()
        vocab_texts = list(eval_corpus.values()) + anchors[:50_000]
        params, tower_cfg, tokenizer = self._build_model(vocab_texts)
        validate_tp(tower_cfg, pm.tp)

        # Tokenize once on the host; pad every pair to one global bucket.
        logger.info("[3/5] tokenizing %d pairs...", len(anchors))
        t0 = time.time()
        a_chunks = self._tokenize(tokenizer, anchors)
        p_chunks = self._tokenize(tokenizer, positives)
        max_len = max(
            (int(lens.max()) for _, lens in a_chunks + p_chunks if len(lens)), default=2
        )
        self.seq_len = bucket_length(max_len, cfg.max_seq_length)
        a_ids, a_len = self._pack(tokenizer, a_chunks, len(anchors))
        p_ids, p_len = self._pack(tokenizer, p_chunks, len(positives))
        del a_chunks, p_chunks
        logger.info("  tokenized in %.1fs; padded seq len %d", time.time() - t0, self.seq_len)

        batch_size = cfg.train_batch_size  # per data rank
        global_batch = batch_size * pm.dp
        n_steps_epoch = steps_per_epoch(len(anchors), global_batch)
        # The schedule horizon counts optimizer steps: one per `accum`
        # micro-batches.
        accum = max(1, cfg.gradient_accumulation_steps)
        total_steps = max(2, cfg.epochs * n_steps_epoch // accum)
        schedule = warmup_cosine_schedule(cfg.learning_rate, total_steps)

        evaluator = None
        if cfg.run_information_retrieval_evaluator and pm.is_main:
            evaluator = RetrievalEvaluator(
                eval_queries, eval_corpus, eval_relevant, batch_size=cfg.eval_batch_size
            )

        start_epoch = 1
        history: list[dict] = []
        resumed = self._resume() if cfg.resume else None
        if resumed is not None:
            if pm.is_main:
                tower_cfg = TowerConfig.from_dict(resumed["tower"])
                tokenizer = self._resume_tokenizer
            elif resumed["tower"] != tower_cfg.to_dict() or resumed["vocab"] != tokenizer.vocab:
                raise RuntimeError(
                    "resume: this rank's tower config or vocab differs from the checkpoint's "
                    "on rank 0 (config or data changed between runs); restart without resume"
                )
            params = resumed["params"]
            start_epoch = resumed["epoch"] + 1
            history = resumed["history"]
            logger.info("Resuming from %s (epoch %d)", resumed["name"], start_epoch)
        params = self._to_trainable(shard_params(params, tower_cfg, pm.tp, pm.model_rank))
        train_step = TrainStep(
            params, tower_cfg, build_optimizer(params, cfg.weight_decay), schedule,
            loss_scale=cfg.loss_scale, accum=accum, device=self.device, mesh=pm,
        )
        if resumed is not None:
            train_step.load_state(self._local_opt_state(resumed["opt"], params))
        del resumed

        logger.info(
            "[4/5] training: %d epochs x %d steps, global batch %d (dp=%d, tp=%d), seq %d, "
            "on %s; train step mode: %s",
            cfg.epochs, n_steps_epoch, global_batch, pm.dp, pm.tp, self.seq_len, self.device,
            cfg.train_step_mode,
        )
        global_step = (start_epoch - 1) * n_steps_epoch
        col = np.arange(self.seq_len)[None, :]
        rows = slice(pm.data_rank * batch_size, (pm.data_rank + 1) * batch_size)

        def assemble(idx: np.ndarray) -> list[torch.Tensor]:
            idx = idx[rows]  # this data rank's block of the global batch
            out = []
            for ids_all, len_all in ((a_ids, a_len), (p_ids, p_len)):
                out += [
                    torch.from_numpy(ids_all[idx]).to(self.device),
                    torch.from_numpy((col < len_all[idx][:, None]).astype(np.int32)).to(
                        self.device
                    ),
                ]
            return out

        n_group = max(1, cfg.steps_per_dispatch)
        # ITOR_PROFILE_DIR: a torch.profiler trace of dispatches 1-5 of the
        # first epoch, written into the directory. ITOR_LOOP_TIMING=1: each
        # dispatch runs under profiling.recording(), and every 25 dispatches
        # loop_timing_line reads the spans recorded since its last line.
        profile_dir = os.getenv(ENV_PROFILE_DIR)
        profiler = None
        loop_timing = os.getenv(ENV_LOOP_TIMING, "").strip() in ("1", "true")
        lt_spans: list[profiling.Span] = []
        lt_n, lt_since = 0, None

        def stop_profiler() -> None:
            nonlocal profiler
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            profiler.stop()
            profiler = None
            logger.info("  device trace of the first steps written to %s", profile_dir)

        for epoch in range(start_epoch, cfg.epochs + 1):
            epoch_start = time.time()
            losses = []
            batch_iter = no_duplicates_batches(anchors, positives, global_batch, cfg.seed, epoch)
            step = 0
            while True:
                group = list(itertools.islice(batch_iter, n_group))
                if len(group) < n_group:
                    break  # drop the ragged trailing group (drop_last semantics)
                if profile_dir and epoch == start_epoch:
                    if step == 1:
                        if self.device.type == "cuda":  # no dispatch-0 work in the trace
                            torch.cuda.synchronize(self.device)
                        profiler = device_profiler(profile_dir, self.device.type == "cuda")
                        profiler.start()
                    elif step >= 6 and profiler is not None:
                        stop_profiler()
                with (profiling.recording() if loop_timing else contextlib.nullcontext()) as got:
                    with span("train.assemble"):
                        batches = [assemble(idx) for idx in group]
                    with span("train.seeds"):
                        seeds = [
                            dropout_seed(cfg.seed, epoch, len(losses) + i, pm.data_rank)
                            for i in range(n_group)
                        ]
                    for batch, seed in zip(batches, seeds):
                        loss = train_step(batch, seed)
                        global_step += 1
                        losses.append(loss)
                if loop_timing:
                    lt_spans += got
                    lt_n += 1
                    if lt_n >= 25:
                        lt_since = loop_timing_line(lt_spans, lt_n, lt_since)
                        lt_spans, lt_n = [], 0
                if step % max(1, cfg.logging_steps // n_group) == 0:
                    logger.info(
                        "  epoch %d step %d loss %.4f lr %.2e",
                        epoch, step * n_group, float(loss),
                        schedule(min(global_step // accum, total_steps - 1)),
                    )
                step += 1
            if profiler is not None:  # the epoch ended before dispatch 6
                stop_profiler()
            if step == 0:
                logger.warning(
                    "epoch %d yielded NO full batches: %d pairs cannot fill a "
                    "no-duplicates batch of %d. Lower train_batch_size or add "
                    "data; the model is NOT training.",
                    epoch, len(anchors), global_batch,
                )
            epoch_losses = torch.stack(losses).tolist() if losses else []
            self.step_losses.extend(epoch_losses)
            entry = {
                "epoch": epoch,
                "train_loss": float(np.mean(epoch_losses)) if epoch_losses else None,
                "epoch_seconds": time.time() - epoch_start,
            }
            full = self._full_params(params)  # collective under tensor parallelism
            entry = self._evaluate(entry, full, tower_cfg, tokenizer, global_batch, evaluator)
            if "eval_loss" in entry:
                logger.info("  epoch %d eval_loss %.4f", epoch, entry["eval_loss"])
            if BEST_METRIC in entry:
                logger.info(
                    "  epoch %d eval: ndcg@10 %.4f recall@10 %.4f mrr@10 %.4f acc@10 %.4f",
                    epoch, entry["ndcg_at_10"], entry["recall_at_10"],
                    entry["mrr_at_10"], entry["accuracy_at_10"],
                )
            history.append(entry)
            opt_state = self._full_opt_state(train_step) if pm.tp > 1 or pm.is_main else None
            if pm.is_main:
                self._save_epoch_checkpoint(epoch, full, opt_state, tower_cfg, tokenizer, history)
                (cfg.output_dir / "eval_history.json").write_text(json.dumps(history, indent=2))

        # Best checkpoint by NDCG@10.
        best_epoch = cfg.epochs
        scored = [h for h in history if BEST_METRIC in h]
        if cfg.run_information_retrieval_evaluator and scored:
            best_epoch = max(scored, key=lambda h: h[BEST_METRIC])["epoch"]
        final_dir = cfg.output_dir / FINAL_SUBDIR
        full = self._full_params(params)
        if pm.is_main:
            best_ckpt = cfg.output_dir / f"checkpoint-epoch{best_epoch}"
            if best_ckpt.exists():
                full, tower_cfg, tokenizer = load_tower(best_ckpt)
                logger.info("Loaded best checkpoint (epoch %d by %s)", best_epoch, BEST_METRIC)
            save_tower(final_dir, full, tower_cfg, tokenizer)
            best_entry = next((h for h in history if h["epoch"] == best_epoch), None)
            (cfg.output_dir / "best.json").write_text(
                json.dumps(
                    {"best_epoch": best_epoch, "metric": BEST_METRIC, "entry": best_entry},
                    indent=2,
                )
            )
            logger.info("[5/5] Done. Model saved to %s", final_dir)
        pm.barrier()  # every rank returns once final/ is written
        return {"history": history, "best_epoch": best_epoch, "final_dir": str(final_dir)}

    def _tokenize(self, tokenizer, texts: list[str]) -> list[tuple[np.ndarray, np.ndarray]]:
        """(ids, token counts) per chunk of texts, each chunk at its own
        bucketed width until the global bucket is known."""
        chunks = []
        chunk = 8192
        for lo in range(0, len(texts), chunk):
            ids, mask = tokenizer.encode_batch(
                texts[lo : lo + chunk], max_seq_length=self.cfg.max_seq_length
            )
            chunks.append((ids, mask.sum(axis=1)))
        return chunks

    def _pack(self, tokenizer, chunks, n: int) -> tuple[np.ndarray, np.ndarray]:
        """One padded ``[n, seq_len]`` id matrix and the token counts, so a
        batch is one fancy-index."""
        ids_all = np.full((n, self.seq_len), tokenizer.pad_id, np.int32)
        len_all = np.zeros(n, np.int64)
        lo = 0
        for ids, lens in chunks:
            w = min(ids.shape[1], self.seq_len)
            ids_all[lo : lo + len(ids), :w] = ids[:, :w]
            len_all[lo : lo + len(ids)] = lens
            lo += len(ids)
        return ids_all, len_all

    @torch.inference_mode()
    def _eval_loss(
        self, params, tower_cfg, tokenizer, batch_size: int, max_batches: int = 8
    ) -> float | None:
        """Deterministic MNRL loss on up to ``max_batches`` held-out batches."""
        if self.eval_pairs is None:
            return None
        anchors, positives = self.eval_pairs
        if len(anchors) < batch_size:
            return None
        if not hasattr(self, "_eval_loss_batches"):
            batches = []
            for bi, idx in enumerate(
                no_duplicates_batches(anchors, positives, batch_size, seed=0)
            ):
                if bi >= max_batches:
                    break
                batch = []
                for texts in (anchors, positives):
                    ids, mask = tokenizer.encode_batch(
                        [texts[i] for i in idx],
                        max_seq_length=self.cfg.max_seq_length,
                        pad_to=self.seq_len,
                    )
                    batch += [torch.from_numpy(ids), torch.from_numpy(mask)]
                batches.append(batch)
            self._eval_loss_batches = batches
        losses = []
        for a_ids, a_mask, p_ids, p_mask in self._eval_loss_batches:
            qa = encode(params, a_ids.to(self.device), a_mask.to(self.device), tower_cfg)
            qp = encode(params, p_ids.to(self.device), p_mask.to(self.device), tower_cfg)
            losses.append(mnrl_loss(qa, qp, scale=self.cfg.loss_scale))
        return float(torch.stack(losses).mean()) if losses else None

    def _log_params(self):
        params_path = Path(self.processed_dir) / DATA_PREP_PARAMS_FILENAME
        if params_path.exists():
            logger.info("data prep params: %s", params_path.read_text())


def main() -> None:
    """The training CLI: one process, or one rank of ``torchrun
    --nproc-per-node N -m instacart_next_order_recommendation_tpu_torch.train``."""
    parser = argparse.ArgumentParser(description="Train the two-tower model on the GPUs")
    parser.add_argument("--config", type=Path, default=None, help="Path to YAML config")
    args = parser.parse_args()
    setup_colored_logging(quiet_loggers=["datasets", "urllib3"])
    init_distributed()
    try:
        TwoTowerTrainer(TrainConfig.load(args.config)).train()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
