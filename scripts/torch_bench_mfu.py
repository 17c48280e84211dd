#!/usr/bin/env python3
"""Encode and train-step TFLOP/s of the port, against the card's peak.

The port's counterpart of ``scripts/bench_mfu.py``, with its FLOP counts
(``encoder_flops``, ``gemm_chain_flops``, ``train_step_flops``) and its rows,
each a share of the H100's dense bf16 peak (989 TFLOP/s, SXM at 700 W,
NVIDIA's data sheet), beside the card's name and power limit:

- the fused encode (``models/encoder.py::encode``: K1 in every layer, K2) at
  batch 256 and the serve buckets S in {32, 64, 128, --seq};
- the GEMM chain at the tower's dims (``torch.matmul`` in bf16: per layer
  hidden -> 3 hidden -> hidden -> intermediate -> hidden), the yardstick a
  tower of plain products gives;
- the unfused tower: the embedding, each layer through
  ``models/encoder.py::_encoder_layer`` (cuBLAS products, eager LayerNorm and
  GELU, K6), the pool;
- ``--train``: a full training step (both towers with dropout, MNRL,
  backward, AdamW at lr 2e-4 and weight decay 0.01; mpnet-base-class at
  3e-5, the rate that trains it) through the trainer's own ``TrainStep``,
  at each batch size, in the form the port's rules pick
  (``fused_layer.supports``, ``fused_layer.saves_residuals``,
  ``TwoTowerTrainer._resolve_remat``).

Each reading is CUDA events around a chain of ``--iters`` calls (a train
step consumes the previous step's params), the median of three chains after
a warm call. Each function takes its sizes; ``main`` prints a row for each
and one JSON line last. On the CPU the times are the host's and every share
of the peak is null (not measured).

    python3 scripts/torch_bench_mfu.py [batch] [--seq N] [--device cpu]
    python3 scripts/torch_bench_mfu.py --train [batch ...] [--seq N] [--mpnet]

Defaults as the JAX script's: batch 256 and S=128 for the encode, batches 64
and 512 (S=128) for ``--train``; the training recipe's length is S=256
(``configs/train.yaml``: ``--seq 256``). Without a card and without
``--device cpu`` it exits non-zero before any work.
"""

from __future__ import annotations

# Allow running as `python scripts/<name>.py` from a repo checkout.
import sys as _sys
from pathlib import Path as _Path

_repo_root = str(_Path(__file__).resolve().parents[1])
if _repo_root not in _sys.path:
    _sys.path.insert(0, _repo_root)

import argparse
import dataclasses
import json
import sys

import numpy as np
import torch

PEAK_BF16_TFLOPS = 989.0  # H100 SXM, dense bf16 tensor cores (NVIDIA data sheet, 700 W)
VOCAB = 12_000  # the JAX script's vocab; ids drawn from [4, 11000)
ENCODE_ITERS = 32
TRAIN_ITERS = 16
REPEATS = 3
LR = 2e-4
MPNET_LR = 3e-5  # 2e-4 collapses mpnet-base-class from random weights (PERF.md)
WEIGHT_DECAY = 0.01
LOSS_SCALE = 30.0


def encoder_flops(config, b: int, s: int) -> int:
    """A tower forward's matmul FLOPs: per layer the four projections and the
    FFN (2BS(4h^2 + 2h inter)) and attention's two products (4BS^2 h)."""
    h, inter = config.hidden_size, config.intermediate_size
    return config.num_layers * (2 * b * s * (4 * h * h + 2 * h * inter) + 4 * b * s * s * h)


def gemm_chain_flops(config, b: int, s: int) -> int:
    """The GEMM chain's FLOPs: h -> 3h -> h -> inter -> h per layer."""
    h, inter = config.hidden_size, config.intermediate_size
    return config.num_layers * 2 * b * s * (6 * h * h + 2 * h * inter)


def train_step_flops(config, b: int, s: int) -> int:
    """Two tower forwards, each backward twice its forward."""
    return 2 * 3 * encoder_flops(config, b, s)


def peak_share(tflops: float, device: torch.device) -> float | None:
    """The share of the card's dense bf16 peak; null off the card."""
    return tflops / PEAK_BF16_TFLOPS if device.type == "cuda" else None


def chained_ms(fn, iters: int, device: torch.device, repeats: int = REPEATS) -> float:
    """ms a call: the median of ``repeats`` chains of ``iters`` calls, after
    one warm call."""
    from instacart_next_order_recommendation_tpu_torch.utils.bench_workload import chain_ms

    fn()
    return float(np.median([chain_ms(fn, iters, device) for _ in range(repeats)]))


def make_row(label: str, ms: float, flops: int, batch: int, device: torch.device,
             card: str, **extra) -> dict:
    tflops = flops / (ms / 1e3) / 1e12
    return {"label": label, "batch": batch, "ms": ms, "flops": flops, "tflops": tflops,
            "peak_share": peak_share(tflops, device), "per_s": batch / (ms / 1e3),
            "card": card, **extra}


def show(row: dict, unit: str = "ex/s") -> None:
    share = row["peak_share"]
    share_text = ("share of peak not measured" if share is None
                  else f"{100 * share:4.1f}% of {PEAK_BF16_TFLOPS:.0f} TFLOP/s bf16")
    print(f"{row['label']}: {row['ms']:8.3f} ms -> {row['tflops']:7.2f} TFLOP/s ({share_text}; "
          f"{row['card']}), {row['per_s']:8.0f} {unit}", flush=True)


def _counts() -> dict[str, int]:
    from instacart_next_order_recommendation_tpu_torch.ops import launch_counts

    return launch_counts()


def _launches_since(before: dict[str, int]) -> dict[str, int]:
    return {name: n - before.get(name, 0) for name, n in _counts().items()}


def random_ids(b: int, s: int, g: np.random.Generator, device) -> torch.Tensor:
    return torch.from_numpy(g.integers(4, 11000, size=(b, s))).to(device)


def tower(config, device, seed: int = 0):
    """The tower's params from a seeded generator, on ``device``, and their
    bf16 layer copies."""
    from instacart_next_order_recommendation_tpu_torch.models.encoder import (
        init_params,
        prepare_layers,
    )
    from instacart_next_order_recommendation_tpu_torch.models.text_encoder import (
        params_to_device,
    )

    params = params_to_device(init_params(config, torch.Generator().manual_seed(seed)), device)
    with torch.no_grad():
        return params, prepare_layers(params, config)


@torch.inference_mode()
def encode_rows(config, batch: int, seqs, device: torch.device, card: str,
                iters: int = ENCODE_ITERS) -> list[dict]:
    """The fused encode at ``batch`` and each S in ``seqs``."""
    from instacart_next_order_recommendation_tpu_torch.models.encoder import encode

    params, layers = tower(config, device)
    g = np.random.default_rng(0)
    rows = []
    for s in seqs:
        ids = random_ids(batch, s, g, device)
        mask = torch.ones_like(ids, dtype=torch.int32)
        before = _counts()
        ms = chained_ms(lambda: encode(params, ids, mask, config, layers=layers), iters, device)
        rows.append(make_row(f"fused encode S={s:<4}", ms, encoder_flops(config, batch, s), batch,
                             device, card, seq=s, launches=_launches_since(before)))
    return rows


@torch.inference_mode()
def gemm_chain_row(config, batch: int, seq: int, device: torch.device, card: str,
                   iters: int = ENCODE_ITERS) -> dict:
    """``torch.matmul`` in bf16 through the tower's products, no epilogue."""
    h, inter, n = config.hidden_size, config.intermediate_size, config.num_layers
    g = torch.Generator().manual_seed(0)
    x = torch.randn(batch * seq, h, generator=g).to(device, torch.bfloat16)
    ws = [[(torch.randn(k, m, generator=g) / k**0.5).to(device, torch.bfloat16)
           for k, m in ((h, 3 * h), (3 * h, h), (h, inter), (inter, h))] for _ in range(n)]

    def chain() -> torch.Tensor:
        y = x
        for layer in ws:
            for w in layer:
                y = torch.matmul(y, w)
        return y

    ms = chained_ms(chain, iters, device)
    return make_row(f"GEMM chain   S={seq:<4}", ms, gemm_chain_flops(config, batch, seq), batch,
                    device, card, seq=seq)


@torch.inference_mode()
def unfused_row(config, batch: int, seq: int, device: torch.device, card: str,
                iters: int = ENCODE_ITERS) -> dict:
    """The tower with every layer through ``_encoder_layer``."""
    from instacart_next_order_recommendation_tpu_torch.models.encoder import (
        _encoder_layer,
        embed,
    )
    from instacart_next_order_recommendation_tpu_torch.ops import masked_mean_pool_l2norm

    params, layers = tower(config, device)
    ids = random_ids(batch, seq, np.random.default_rng(0), device)
    mask = torch.ones_like(ids, dtype=torch.int32)

    def forward() -> torch.Tensor:
        x = embed(params, ids, config)
        for layer in layers:
            x = _encoder_layer(x, layer, mask, config)
        return masked_mean_pool_l2norm(x, mask)

    before = _counts()
    ms = chained_ms(forward, iters, device)
    return make_row(f"unfused      S={seq:<4}", ms, encoder_flops(config, batch, seq), batch,
                    device, card, seq=seq, launches=_launches_since(before))


def train_form(config, batch: int, seq: int, device: torch.device) -> tuple[str, bool]:
    """The form the port's rules give a training step at this shape, and
    the remat ``_resolve_remat`` picks."""
    from instacart_next_order_recommendation_tpu_torch.ops import fused_layer
    from instacart_next_order_recommendation_tpu_torch.train import TrainConfig, TwoTowerTrainer

    h, heads, inter = config.hidden_size, config.num_heads, config.intermediate_size
    trainer = TwoTowerTrainer(TrainConfig({"train_batch_size": batch}), device=device)
    remat = trainer._resolve_remat(h, heads, inter, seq)
    if fused_layer.supports(h, heads, seq, inter):
        kept = fused_layer.saves_residuals(batch, seq, h, inter)
        return f"fused fwd + fused bwd ({'residuals kept' if kept else 'recompute'})", remat
    return f"unfused fwd + bwd (remat {'on' if remat else 'off'})", remat


def train_rows(config, batches, seq: int, device: torch.device, card: str, lr: float = LR,
               iters: int = TRAIN_ITERS) -> list[dict]:
    """A full ``TrainStep`` (both towers, MNRL, backward, AdamW) at each
    batch size; each row's launches and steps (the warm step included)."""
    from instacart_next_order_recommendation_tpu_torch.train.trainer import (
        TrainStep,
        build_optimizer,
        param_leaves,
    )

    rows = []
    for b in batches:
        form, remat = train_form(config, b, seq, device)
        params, _ = tower(config, device)
        for _, t in param_leaves(params):
            t.requires_grad_(True)
        step = TrainStep(
            params, dataclasses.replace(config, remat=remat),
            build_optimizer(params, WEIGHT_DECAY), lambda _: lr, loss_scale=LOSS_SCALE,
            accum=1, device=device,
        )
        g = np.random.default_rng(0)
        mask = torch.ones((b, seq), dtype=torch.int32, device=device)
        batch = [random_ids(b, seq, g, device), mask, random_ids(b, seq, g, device), mask]
        seeds = iter(range(1 << 30))
        before = _counts()
        ms = chained_ms(lambda: step(batch, next(seeds)), iters, device)
        rows.append(make_row(f"{form:<40} B={b:<4} S={seq}", ms,
                             train_step_flops(config, b, seq), b, device, card, seq=seq,
                             form=form, remat=remat, lr=lr, steps=1 + REPEATS * iters,
                             launches=_launches_since(before)))
        del step, params
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return rows


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description="Encode and train-step MFU of the port")
    parser.add_argument("batches", nargs="*", type=int)
    parser.add_argument("--seq", type=int, default=128)
    parser.add_argument("--train", action="store_true")
    parser.add_argument("--mpnet", action="store_true", help="mpnet-base-class (--train)")
    parser.add_argument("--iters", type=int, default=None,
                        help=f"calls a chain (default {ENCODE_ITERS}, {TRAIN_ITERS} with --train)")
    parser.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = parser.parse_args(argv)
    if args.device is None and not torch.cuda.is_available():
        print("torch_bench_mfu: CUDA is not available; pass --device cpu for the plain PyTorch "
              "path", file=sys.stderr)
        return 1

    from instacart_next_order_recommendation_tpu_torch.device import resolve_device
    from instacart_next_order_recommendation_tpu_torch.models.encoder import (
        MINILM_L6,
        MPNET_BASE_CLASS,
    )
    from instacart_next_order_recommendation_tpu_torch.utils.bench_workload import card_line

    dev = resolve_device(args.device)
    card = card_line(dev)
    print(card, flush=True)
    preset = MPNET_BASE_CLASS if (args.train and args.mpnet) else MINILM_L6
    config = dataclasses.replace(preset, vocab_size=VOCAB)
    if args.train:
        lr = MPNET_LR if args.mpnet else LR
        rows = train_rows(config, args.batches or [64, 512], args.seq, dev, card, lr=lr,
                          iters=args.iters or TRAIN_ITERS)
        for row in rows:
            show(row, "pairs/s")
    else:
        b, iters = (args.batches or [256])[0], args.iters or ENCODE_ITERS
        rows = encode_rows(config, b, sorted({32, 64, 128, args.seq}), dev, card, iters)
        rows += [gemm_chain_row(config, b, args.seq, dev, card, iters),
                 unfused_row(config, b, args.seq, dev, card, iters)]
        for row in rows:
            show(row)
    print(json.dumps({"metric": "mfu", "model": "mpnet-base-class" if args.train and args.mpnet
                      else "minilm-l6", "train": args.train, "peak_tflops": PEAK_BF16_TFLOPS,
                      "card": card, "rows": rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
