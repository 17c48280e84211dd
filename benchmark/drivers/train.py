"""MNRL training: the program's ``TrainStep`` driven step after step.

Set-up makes the synthetic users and their p5_mp20 pairs, trains the vocab
on the catalog and the anchors (as the trainer does), tokenizes every pair
once with the port's tokenizer and pads both sides to one global bucket,
makes the weights, and builds one ``TrainStep`` (both towers with hidden
dropout, MNRL, backward, AdamW on the trainer's warmup-cosine schedule).
Batches come from the no-duplicates sampler, the pool reshuffled each
epoch. The same step object takes ``check_steps`` steps in set-up, whose
losses, first gradient (from AdamW's first moment) and change of the
parameters the comparison holds to the reference, then goes on through the
window. ``train_pairs_per_s`` counts every pair of every step the window
ran, over the window's seconds, ending in a device sync.
"""

from __future__ import annotations

import gc
import math
import time

import numpy as np
import torch

from benchmark import counts, port, weights, workgen
from benchmark.harness import log
from benchmark.reference import bert
from benchmark.reference import train as ref_train

BETA1 = 0.9


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _tokenize(tok, texts: list[str], max_len: int):
    """Each distinct text tokenized once: (ids rows, lengths) in order."""
    distinct = list(dict.fromkeys(texts))
    where = {x: i for i, x in enumerate(distinct)}
    ids_all, lens_all = [], []
    for lo in range(0, len(distinct), 8192):
        ids, mask = tok.encode_batch(distinct[lo : lo + 8192], max_seq_length=max_len)
        ids_all.append(ids)
        lens_all.append(mask.sum(axis=1))
    pick = np.asarray([where[x] for x in texts])
    return ids_all, np.concatenate(lens_all)[pick], pick


def _pack(chunks, pick, seq: int, pad: int) -> np.ndarray:
    rows = np.full((sum(len(c) for c in chunks), seq), pad, np.int32)
    lo = 0
    for c in chunks:
        w = min(c.shape[1], seq)
        rows[lo : lo + len(c), :w] = c[:, :w]
        lo += len(c)
    return rows[pick]


def feed(anchors, positives, batch: int, seed: int):
    """(batch indices, step seed) forever: epoch after epoch of the
    no-duplicates sampler."""
    seeds = workgen.rng_for(seed, 7)
    epoch = 0
    while True:
        any_batch = False
        for idx in workgen.no_duplicates_batches(anchors, positives, batch, seed, epoch):
            any_batch = True
            yield idx, int(seeds.integers(0, 1 << 62))
        if not any_batch:
            raise ValueError("the pairs cannot fill one no-duplicates batch")
        epoch += 1


def setup(ctx) -> dict:
    from instacart_next_order_recommendation_tpu_torch.train.trainer import (
        TrainStep,
        build_optimizer,
        warmup_cosine_schedule,
    )

    t, cfg, dev = ctx.traffic, ctx.config, ctx.device
    log(f"imports done at {time.perf_counter() - ctx.t_start:.2f} s")
    syn = workgen.synthetic_users(t["users"], t["products"], ctx.seed)
    anchors, positives = workgen.training_pairs(syn, t["max_prior_orders"],
                                                t["max_product_names"])
    vocab = workgen.train_vocab(syn["catalog"] + anchors[:50_000], t["vocab_size"])
    tok = port.tokenizer(vocab)
    log(f"pairs and vocab at {time.perf_counter() - ctx.t_start:.2f} s")
    L = t["max_seq_length"]
    a_chunks, a_len, a_pick = _tokenize(tok, anchors, L)
    p_chunks, p_len, p_pick = _tokenize(tok, positives, L)
    seq = workgen.bucket_length(int(max(a_len.max(), p_len.max())), L)
    a_ids = _pack(a_chunks, a_pick, seq, tok.pad_id)
    p_ids = _pack(p_chunks, p_pick, seq, tok.pad_id)
    b = t["batch"]
    total = t["epochs"] * math.ceil(len(anchors) / b)

    log(f"tokenized at {time.perf_counter() - ctx.t_start:.2f} s")
    tower = port.tower_config(cfg, L, dropout=t["dropout"])
    w = weights.make(cfg, ctx.seed, dev)
    params = {g: {n: x.detach().clone().requires_grad_(True) for n, x in leaves.items()}
              for g, leaves in w.items()}
    del w
    leaves = [x for _, x in weights.leaves(params)]
    step = TrainStep(
        params, tower, build_optimizer(params, t["weight_decay"]),
        warmup_cosine_schedule(t["lr"], total), loss_scale=t["loss_scale"], accum=1,
        device=dev,
    )
    col = np.arange(seq)[None, :]

    def assemble(idx):
        out = []
        for ids, lens in ((a_ids, a_len), (p_ids, p_len)):
            out += [torch.from_numpy(ids[idx]).to(dev),
                    torch.from_numpy((col < lens[idx][:, None]).astype(np.int32)).to(dev)]
        if ctx.fault == "half":
            out = [x[: b // 2] for x in out]
        return out

    if ctx.fault == "unchanged":
        step.optimizer.step = lambda *a, **k: None
    elif ctx.fault == "answer":
        opt_step = step.optimizer.step

        def altered_step(*a, **k):
            params["layers"]["ffn_w1"].grad.mul_(0.5)
            return opt_step(*a, **k)

        step.optimizer.step = altered_step

    st = {"anchors": anchors, "positives": positives, "a_ids": a_ids, "p_ids": p_ids,
          "a_len": a_len, "p_len": p_len, "seq": seq, "total": total, "step": step,
          "params": params, "assemble": assemble, "pad": tok.pad_id, "vocab": vocab}
    st["feed"] = feed(anchors, positives, b, ctx.seed)

    # The check steps: the same call and feed as the window's.
    before = [x.detach().clone() for x in leaves]
    checked, losses = [], []
    for i in range(t["check_steps"]):
        idx, seed_i = next(st["feed"])
        losses.append(float(step(assemble(idx), seed_i)))
        checked.append((idx, seed_i))
        if i == 0:
            st["grad_norms"] = [
                float(step.optimizer.state[x]["exp_avg"].norm() / (1 - BETA1))
                if x in step.optimizer.state else 0.0
                for x in leaves
            ]
    st["change_norms"] = [float((x.detach() - x0).norm()) for x, x0 in zip(leaves, before)]
    st["losses"] = losses
    st["checked"] = checked
    del before
    sync(dev)
    log(f"{len(anchors)} pairs, padded to {seq}; check steps' losses {losses}")
    return st


def window(ctx, st):
    from benchmark.harness import Window

    spans, dev, b = ctx.spans, ctx.device, ctx.traffic["batch"]
    step, assemble = st["step"], st["assemble"]
    losses, steps = [], []
    sync(dev)
    t0 = time.perf_counter()
    t_end = t0 + ctx.seconds
    while time.perf_counter() < t_end:
        idx, seed_i = next(st["feed"])
        with spans.span("assemble"):
            batch = assemble(idx)
        with spans.span("train_step"):
            losses.append(step(batch, seed_i))
        steps.append(idx)
    sync(dev)
    elapsed = time.perf_counter() - t0
    finite = torch.isfinite(torch.stack(losses)).cpu().numpy()
    records = {
        "steps": [
            {"rows": b, "a_seq": counts.round_up(int(st["a_len"][i].max())),
             "p_seq": counts.round_up(int(st["p_len"][i].max())),
             "a_lengths": st["a_len"][i], "p_lengths": st["p_len"][i]}
            for i in steps
        ],
        "window_s": elapsed,
        "train_step_s": [d for d in spans.durations("train_step", t0, t_end)],
    }
    log(f"{len(steps)} steps of {b} pairs in {elapsed:.3f} s")
    return Window(end_to_end={"train_pairs_per_s": len(steps) * b / elapsed}, records=records,
                  attempted=len(steps) * b, failed=int((~finite).sum()) * b, seconds=elapsed)


def leaf_gap(got: list[float], want: list[float], keep: list[bool]) -> float:
    """The worst leaf's gap between the program's norm and the reference's,
    against the larger of that leaf's reference norm and the median leaf's."""
    kept = [w for w, k in zip(want, keep) if k]
    median = float(np.median(kept)) if kept else 0.0
    gaps = [abs(g - w) / max(w, median, 1e-30) for g, w, k in zip(got, want, keep) if k]
    return max(gaps) if gaps else 0.0


def reference_run(ctx, st, quant=bert.exact) -> dict:
    """The reference's losses, first gradient norms and change norms over
    the check steps, from the same weights, batches and dropout seeds."""
    bert.no_tf32()
    t, cfg, dev = ctx.traffic, ctx.config, ctx.device
    w = weights.make(cfg, ctx.seed, dev)
    leaves = [x.requires_grad_(True) for _, x in weights.leaves(w)]
    before = [x.detach().clone() for x in leaves]
    opt = ref_train.AdamW(leaves, t["weight_decay"])
    losses, grad_norms = [], None
    for i, (idx, seed_i) in enumerate(st["checked"]):
        batch = tuple(
            torch.from_numpy(np.ascontiguousarray(st[key][idx])).to(dev).long()
            for key in ("a_ids", "a_len", "p_ids", "p_len")
        )
        loss, grads = ref_train.step_loss_and_grads(
            w, leaves, batch, seed_i, cfg, t["dropout"], t["loss_scale"], t["ref_block"], quant,
        )
        losses.append(loss)
        if i == 0:
            grad_norms = [float(g.norm()) for g in grads]
        opt.step(grads, ref_train.warmup_cosine(t["lr"], st["total"], i))
        del grads
    changes = [float((x.detach() - x0).norm()) for x, x0 in zip(leaves, before)]
    return {"losses": losses, "grad_norms": grad_norms, "change_norms": changes}


def numbers(prog: dict, ref: dict, rule: float) -> dict:
    """The program's check steps against the reference's: ``loss_gap`` (the
    worst step's relative loss gap), ``grad_gap`` and ``change_gap`` (the
    worst leaf's gap of norms; leaves whose reference gradient is under
    ``rule`` times the median leaf's move by round-off alone and are left
    out of the change)."""
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"]))
    g_ref = ref["grad_norms"]
    median = float(np.median(g_ref))
    moving = [g >= rule * median for g in g_ref]
    return {
        "loss_gap": loss_gap,
        "grad_gap": leaf_gap(prog["grad_norms"], g_ref, [True] * len(g_ref)),
        "change_gap": leaf_gap(prog["change_norms"], ref["change_norms"], moving),
    }


def judge(ctx, st, win) -> dict:
    from benchmark.drivers.serving import with_limits

    prog = {k: st[k] for k in ("losses", "grad_norms", "change_norms")}
    for key in ("step", "params", "assemble", "feed"):
        st.pop(key, None)
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    ref = reference_run(ctx, st)
    return with_limits(numbers(prog, ref, ctx.traffic["leaf_rule"]), ctx.limits)
