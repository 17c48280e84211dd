#!/usr/bin/env python3
"""Learning-rate probe for the mpnet-base-class tower trained from random
weights on one NVIDIA GPU, beside a witness that shares no tower code with
the PyTorch port.

Run from the repository root:

    python3 scripts/torch_mpnet_lr_probe.py

1. The port: ``TwoTowerTrainer`` with ``model_name: mpnet-base`` (hidden
   768, 12 layers, 12 heads, intermediate 3072), batch 64, one epoch, the
   recipe's schedule (10% warmup from 0, cosine to 0) and loss scale 30, on
   ``chip_smoke.py``'s synthetic p5_mp20 pairs (S=256), at each rate in
   ``PORT_LRS``.
2. The witness: the same architecture built from
   ``torch.nn.TransformerEncoderLayer`` (post-LN, exact GELU, hidden dropout
   0.1 only, as the tower has no attention-probability or FFN-inner
   dropout), its own embeddings, truncated-normal(0.02) init, mean-pool,
   MNRL, AdamW and schedule, under bf16 autocast, on the same tokenized
   pairs in the same batches, at each rate in ``WITNESS_LRS``. It shares
   the tokenizer and the data with the port, nothing else.

Each run prints one JSON line: the mean loss of the first and last 10
steps, how many steps lie within 1e-3 of ln(64) (every text mapped to one
embedding gives exactly ln(batch)), the mean pairwise cosine of 64 held-out
anchors' embeddings after training (1.0 = collapsed), and for the port the
NDCG@10 of its IR eval. Imports nothing of JAX.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

REPO = Path(__file__).resolve().parents[1]
PORT_LRS = (2e-4, 1e-4, 5e-5, 3e-5)
WITNESS_LRS = (2e-4, 3e-5)
BATCH = 64
SEQ = 256
LOSS_SCALE = 30.0
SEED = 42


def log(msg: str) -> None:
    print(msg, flush=True)


def mean_pairwise_cosine(emb: torch.Tensor) -> float:
    e = emb.float()
    sims = e @ e.T
    n = e.shape[0]
    return ((sims.sum() - sims.diagonal().sum()) / (n * (n - 1))).item()


def loss_summary(losses: list[float]) -> dict:
    flat = math.log(BATCH)
    return {
        "first10": float(np.mean(losses[:10])),
        "last10": float(np.mean(losses[-10:])),
        "steps": len(losses),
        "steps_at_ln64": int(sum(abs(v - flat) < 1e-3 for v in losses)),
    }


def port_run(phase, lr: float, probe_texts: list[str], dev) -> dict:
    """One epoch of the port's trainer at ``lr``; ``phase`` is a
    ``chip_smoke.MpnetTrainPhase`` holding the data and the config."""
    from instacart_next_order_recommendation_tpu_torch.models.text_encoder import TextEncoder
    from instacart_next_order_recommendation_tpu_torch.train import TwoTowerTrainer

    t0 = time.perf_counter()
    trainer = TwoTowerTrainer(
        phase.config(f"lr{lr:g}", epochs=1, learning_rate=lr), device=dev
    )
    result = trainer.train(data=phase.data)
    enc = TextEncoder.load(result["final_dir"], device=dev)
    emb = enc.encode_device(probe_texts)
    return {
        "route": "port",
        "lr": lr,
        **loss_summary(trainer.step_losses),
        "probe_mean_cosine": mean_pairwise_cosine(emb),
        "ndcg_at_10": result["history"][-1].get("ndcg_at_10"),
        "seconds": time.perf_counter() - t0,
        "losses": [round(v, 4) for v in trainer.step_losses],
    }


class WitnessTower(torch.nn.Module):
    """A BERT-style post-LN tower from ``torch.nn`` parts: embeddings +
    LayerNorm + dropout, ``layers`` TransformerEncoderLayers, masked mean
    pool, L2 norm."""

    def __init__(self, vocab: int, hidden: int, layers: int, heads: int, inter: int,
                 max_position: int = 512, dropout: float = 0.1, eps: float = 1e-12):
        super().__init__()
        self.word = torch.nn.Embedding(vocab, hidden)
        self.position = torch.nn.Embedding(max_position, hidden)
        self.token_type = torch.nn.Embedding(2, hidden)
        self.ln = torch.nn.LayerNorm(hidden, eps=eps)
        self.drop = torch.nn.Dropout(dropout)
        self.layers = torch.nn.ModuleList()
        for _ in range(layers):
            layer = torch.nn.TransformerEncoderLayer(
                hidden, heads, inter, dropout=dropout, activation="gelu",
                layer_norm_eps=eps, batch_first=True, norm_first=False,
            )
            layer.self_attn.dropout = 0.0  # no attention-probability dropout
            layer.dropout = torch.nn.Identity()  # no dropout inside the FFN
            self.layers.append(layer)
        for name, p in self.named_parameters():
            if p.dim() >= 2:
                torch.nn.init.trunc_normal_(p, std=0.02, a=-0.04, b=0.04)
            elif name.endswith("bias"):
                torch.nn.init.zeros_(p)

    def forward(self, ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        s = ids.shape[1]
        x = self.word(ids) + self.position.weight[:s] + self.token_type.weight[0]
        x = self.drop(self.ln(x))
        pad = mask == 0
        for layer in self.layers:
            x = layer(x, src_key_padding_mask=pad)
        m = mask.unsqueeze(-1).float()
        pooled = (x.float() * m).sum(1) / m.sum(1).clamp_min(1e-9)
        return F.normalize(pooled, dim=-1)


def witness_run(tokens, batches, lr: float, probe, config, dev) -> dict:
    """One epoch of the witness at ``lr`` over ``batches`` (index arrays)
    of ``tokens`` = (anchor ids, anchor mask, positive ids, positive mask)."""
    t0 = time.perf_counter()
    torch.manual_seed(SEED)
    model = WitnessTower(
        config.vocab_size, config.hidden_size, config.num_layers, config.num_heads,
        config.intermediate_size, config.max_position, config.hidden_dropout,
        config.layer_norm_eps,
    ).to(dev)
    opt = torch.optim.AdamW(
        model.parameters(), lr=0.0, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.0
    )
    total = len(batches)
    warmup = max(1, int(0.1 * total))
    labels = torch.arange(BATCH, device=dev)
    losses = []
    model.train()
    for count, idx in enumerate(batches):
        if count < warmup:
            rate = lr * count / warmup
        else:
            rate = 0.5 * lr * (1 + math.cos(math.pi * (count - warmup) / max(1, total - warmup)))
        for group in opt.param_groups:
            group["lr"] = rate
        a_ids, a_mask, p_ids, p_mask = (t[idx].to(dev) for t in tokens)
        with torch.autocast(dev.type, dtype=torch.bfloat16):
            qa = model(a_ids, a_mask)
            qp = model(p_ids, p_mask)
        loss = F.cross_entropy(LOSS_SCALE * qa.float() @ qp.float().T, labels)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        losses.append(loss.item())
    model.eval()
    with torch.no_grad(), torch.autocast(dev.type, dtype=torch.bfloat16):
        emb = model(probe[0].to(dev), probe[1].to(dev))
    return {
        "route": "witness",
        "lr": lr,
        **loss_summary(losses),
        "probe_mean_cosine": mean_pairwise_cosine(emb),
        "seconds": time.perf_counter() - t0,
        "losses": [round(v, 4) for v in losses],
    }


def tokenize(tokenizer, texts: list[str]) -> tuple[torch.Tensor, torch.Tensor]:
    ids, mask = tokenizer.encode_batch(texts, max_seq_length=SEQ, pad_to=SEQ)
    return torch.from_numpy(ids).long(), torch.from_numpy(mask)


def run(phase, config, dev, port_lrs=PORT_LRS, witness_lrs=WITNESS_LRS) -> list[dict]:
    """The port at ``port_lrs``, then the witness at ``witness_lrs``, on
    ``phase``'s data; ``config`` is the tower's ``TowerConfig``."""
    import dataclasses

    from instacart_next_order_recommendation_tpu_torch.data.batching import (
        no_duplicates_batches,
    )
    from instacart_next_order_recommendation_tpu_torch.tokenizer import WordPieceTokenizer

    anchors, positives, eval_pairs, _, corpus, _ = phase.data
    probe_texts = eval_pairs[0][:BATCH]
    rows = []
    for lr in port_lrs:
        rows.append(port_run(phase, lr, probe_texts, dev))
        log(json.dumps(rows[-1]))
    # The trainer's vocabulary, trained on the same texts; its epoch-1 batches.
    tokenizer = WordPieceTokenizer.train(list(corpus.values()) + anchors[:50_000], vocab_size=30_000)
    config = dataclasses.replace(config, vocab_size=tokenizer.vocab_size)
    tokens = (*tokenize(tokenizer, anchors), *tokenize(tokenizer, positives))
    probe = tokenize(tokenizer, probe_texts)
    batches = [torch.from_numpy(b) for b in no_duplicates_batches(anchors, positives, BATCH, SEED, 1)]
    for lr in witness_lrs:
        rows.append(witness_run(tokens, batches, lr, probe, config, dev))
        log(json.dumps(rows[-1]))
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_mpnet_lr_probe: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    import chip_smoke
    from instacart_next_order_recommendation_tpu_torch.models.encoder import MPNET_BASE_CLASS

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    log(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip())
    data = chip_smoke.build_training_data(chip_smoke.synthetic_users(np.random.default_rng(1)))
    build_root = REPO / "build"
    build_root.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_lr_probe_", dir=build_root) as tmp:
        phase = chip_smoke.MpnetTrainPhase(None, dev, Path(tmp), data=data)
        rows = run(phase, MPNET_BASE_CLASS, dev)
    log(json.dumps([{k: v for k, v in r.items() if k != "losses"} for r in rows]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
