#!/usr/bin/env python3
"""The readings behind ``fused_layer.saves_residuals``, on one NVIDIA GPU.

Three parts, each reading both forms of the training layer in turns:

- recompute: K1-train keeps only its inputs, K5 recomputes the forward;
- resid: K1-train keeps attn, ao, x1 and f (save_resid), K5 reads them.

``layers``: for MiniLM-L6's widths (384, 12 heads of 32, 1536) and
mpnet-base-class's (768, 12 heads of 64, 3072), at B in {1, 64, 512} and S
in {64, 256, 512}, one training layer's forward and backward read with
CUDA events (``chip_smoke.ms_in_turns``, medians): K1-train alone in both
forms, the step (K1-train then K5) in both forms, the peak device memory
of one step above its inputs (the residuals held from the forward to the
backward, as autograd holds them, and K5's workspace) and the residuals'
bytes. Random weights and inputs from fixed seeds, dropout masks at 0.1,
every batch above 1 with an all-pad row.

``b1``: the same step at B=1 (both widths, S in {64, 256, 512}) with ten
times the iterations and six turns, where one launch's host time is a
large share of the step.

``towers``: whole training steps (``TrainStep``: both towers, MNRL, AdamW)
of MiniLM-L6 at B in {512, 1024} and mpnet-base-class at B in {256, 512,
768}, all at S=512, every layer held in one form (``RESID_BYTES_PER_LAYER``
set to 0 or past any shape): the step's milliseconds on the host clock after a
device sync (median of three rounds of three steps, the forms in turns),
the device memory allocated before a step (params, AdamW state) and the
step's peak, or ``"oom"`` where the step did not fit. Random params from a
fixed seed, token ids from a fixed seed, lengths 300-512 with one row of
512.

Run from the repository root on a machine with nvcc:

    python3 scripts/torch_fused_resid_rule.py [--part layers|b1|towers ...] [--out FILE]

Prints one JSON line a reading, then the card's name and power limit;
``--out`` also writes all readings to FILE as JSON.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
WIDTHS = {"minilm": (384, 12, 1536), "mpnet": (768, 12, 3072)}
BATCHES = (1, 64, 512)
SEQS = (64, 256, 512)
TOWER_SEQ = 512
TOWER_BATCHES = {"minilm-l6": (512, 1024), "mpnet-base": (256, 512, 768)}
PARTS = ("layers", "b1", "towers")


def iters_for(b: int, s: int) -> int:
    return 20 if b * s <= 16_384 else 5 if b * s <= 65_536 else 2


def layer_reading(cs, fused_layer, name: str, b: int, s: int, iters: int, turns: int,
                  dev) -> dict:
    """One training layer's K1-train and step in both forms at (B, S)."""
    h, heads, inter = WIDTHS[name]
    kw = dict(num_heads=heads, scale=1.0 / (h // heads) ** 0.5, eps=1e-12)
    g = torch.Generator().manual_seed(50)
    layer = cs.random_layer(h, inter, g, dev)
    x, up = (torch.randn((b, s, h), generator=g).to(dev, torch.bfloat16) for _ in range(2))
    mask = cs.random_mask(b, s, g, dev)
    bias = ((1.0 - mask.float()) * -1e9).contiguous()
    gen = torch.Generator(device=dev).manual_seed(b * 1000 + s)
    masks = fused_layer.draw_dropout_masks((b, s, h), 0.1, gen, dev, torch.bfloat16)

    def k1(resid):
        return fused_layer._launch(x, bias, layer, masks, **kw, save_resid=resid)

    def step(resid):
        out = k1(resid)
        return fused_layer.fused_encoder_layer_backward(
            x, bias, up, masks, layer, **kw, resids=out[1] if resid else None
        )

    def peak(resid) -> int:
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = step(resid)
        torch.cuda.synchronize()
        del out
        return torch.cuda.max_memory_allocated() - base

    ms = cs.ms_in_turns({
        "k1": lambda: k1(False), "k1_resid": lambda: k1(True),
        "step": lambda: step(False), "step_resid": lambda: step(True),
    }, iters, turns)
    row = {
        "widths": name, "batch": b, "seq": s, "iters": iters, "turns": turns,
        **{f"{k}_ms": v for k, v in ms.items()},
        "k5_ms": ms["step"] - ms["k1"], "k5_resid_ms": ms["step_resid"] - ms["k1_resid"],
        "step_resid_over_step": ms["step_resid"] / ms["step"],
        "peak_step_bytes": peak(False), "peak_step_resid_bytes": peak(True),
        "resid_bytes": 4 * b * s * h * 2,
    }
    del x, up, mask, bias, masks
    torch.cuda.empty_cache()
    return row


def tower_reading(fused_layer, model: str, b: int, dev) -> dict:
    """Whole training steps of ``model`` at (B, S=512) in both forms."""
    from instacart_next_order_recommendation_tpu_torch.models.encoder import init_params
    from instacart_next_order_recommendation_tpu_torch.train.trainer import (
        _PRESETS,
        TrainStep,
        build_optimizer,
        warmup_cosine_schedule,
    )

    cfg = dataclasses.replace(_PRESETS[model], max_seq_length=TOWER_SEQ, remat=False)
    params = {
        k: {n: t.to(dev).requires_grad_(True) for n, t in v.items()}
        for k, v in init_params(cfg, torch.Generator().manual_seed(0)).items()
    }
    step = TrainStep(params, cfg, build_optimizer(params, 0.0), warmup_cosine_schedule(2e-4, 100),
                     loss_scale=30.0, accum=1, device=dev)
    rng = np.random.default_rng(b)
    batch = []
    for _ in range(2):  # anchors, positives
        lengths = rng.integers(TOWER_SEQ * 300 // 512, TOWER_SEQ + 1, b)
        lengths[0] = TOWER_SEQ
        ids = rng.integers(1000, cfg.vocab_size, (b, TOWER_SEQ)).astype(np.int32)
        mask = (np.arange(TOWER_SEQ)[None, :] < lengths[:, None]).astype(np.int32)
        batch += [torch.from_numpy(ids * mask).to(dev), torch.from_numpy(mask).to(dev)]
    caps = {"recompute": 0, "resid": 1 << 62}
    h = cfg.hidden_size
    row: dict = {"model": model, "batch": b, "seq": TOWER_SEQ,
                 "resid_bytes_per_layer": 4 * b * TOWER_SEQ * h * 2,
                 "resid_bytes_both_towers": 2 * cfg.num_layers * 4 * b * TOWER_SEQ * h * 2}
    fits = {}
    for form, cap in caps.items():
        fused_layer.RESID_BYTES_PER_LAYER = cap
        try:
            step(batch, seed=0)  # warm-up
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            step(batch, seed=1)
            torch.cuda.synchronize()
            row[f"{form}_allocated_before_bytes"] = base
            row[f"{form}_peak_bytes"] = torch.cuda.max_memory_allocated()
            row[f"{form}_peak_reserved_bytes"] = torch.cuda.max_memory_reserved()
            fits[form] = True
        except torch.cuda.OutOfMemoryError:
            row[f"{form}_peak_bytes"] = "oom"
            fits[form] = False
        for p in (t for v in params.values() for t in v.values()):
            p.grad = None
        torch.cuda.empty_cache()
    times: dict[str, list[float]] = {f: [] for f in caps if fits[f]}
    for turn in range(3):
        for form in (list(times) if turn % 2 == 0 else list(times)[::-1]):
            fused_layer.RESID_BYTES_PER_LAYER = caps[form]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i in range(3):
                step(batch, seed=2 + i)
            torch.cuda.synchronize()
            times[form].append((time.perf_counter() - t0) * 1e3 / 3)
    for form, t in times.items():
        row[f"{form}_step_ms"] = float(np.median(t))
        row[f"{form}_step_ms_rounds"] = t
    if len(times) == 2:
        row["resid_over_recompute"] = row["resid_step_ms"] / row["recompute_step_ms"]
    del step, params, batch
    torch.cuda.empty_cache()
    return row


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--part", action="append", choices=PARTS, default=None,
                        help="the parts to run (default: all three)")
    parser.add_argument("--out", type=Path, default=None)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs
    from instacart_next_order_recommendation_tpu_torch.ops import _build, fused_layer

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    _build.build()
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    parts = args.part or PARTS
    cap = fused_layer.RESID_BYTES_PER_LAYER
    readings: dict[str, list[dict]] = {part: [] for part in parts}

    def keep(part: str, row: dict) -> None:
        print(json.dumps({"part": part, **row}), flush=True)
        readings[part].append(row)

    if "layers" in parts:
        for name in WIDTHS:
            for b in BATCHES:
                for s in SEQS:
                    keep("layers", layer_reading(cs, fused_layer, name, b, s, iters_for(b, s),
                                                 2, dev))
    if "b1" in parts:
        for name in WIDTHS:
            for s in SEQS:
                keep("b1", layer_reading(cs, fused_layer, name, 1, s, 10 * iters_for(1, s),
                                         6, dev))
    if "towers" in parts:
        try:
            for model, batches in TOWER_BATCHES.items():
                for b in batches:
                    keep("towers", tower_reading(fused_layer, model, b, dev))
        finally:
            fused_layer.RESID_BYTES_PER_LAYER = cap

    print(smi, flush=True)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps({"device": smi, "readings": readings}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
