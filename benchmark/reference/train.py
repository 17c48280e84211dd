"""The reference MNRL training step: BERT hidden dropout, the
MultipleNegativesRankingLoss, its gradient and AdamW with decoupled weight
decay on a warmup-cosine schedule, in float32.

The dropout masks are a stated function of each step's seed: one CUDA (or
CPU) generator seeded with it draws, for the anchors and then for the
positives, the embedding mask and then m1 and m2 of each layer in turn, each
``rand(B, S, H) < 1 - rate`` at the padded shape the step is given. The
reference draws them again from the seed.

A step is computed in blocks of rows so that it fits beside nothing: the
embeddings without a graph first, the loss and its gradient with respect to
them, then each block's forward again with a graph, back-propagated with
its rows of that gradient. Each block is cut to its longest real row, which
changes nothing for the real tokens.
"""

from __future__ import annotations

import math

import torch

from benchmark.reference import bert


def draw_masks(seed: int, shape: tuple, layers: int, rate: float, device):
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    keep = 1.0 - rate

    def draw():
        return torch.rand(shape, generator=gen, device=device) < keep

    towers = []
    for _ in range(2):
        emb = draw()
        per_layer = []
        for _ in range(layers):
            m1 = draw()
            per_layer.append((m1, draw()))
        towers.append((emb, per_layer))
    return towers


def mnrl(qa: torch.Tensor, qp: torch.Tensor, scale: float) -> torch.Tensor:
    """Cross-entropy of ``scale`` times the cosine similarities, each anchor's
    own positive the label, the batch's other positives its negatives."""
    logits = scale * qa @ qp.T
    return torch.nn.functional.cross_entropy(logits, torch.arange(qa.shape[0], device=qa.device))


def warmup_cosine(peak: float, total: int, count: int) -> float:
    """Linear warmup from 0 over max(1, 10% of total) optimizer steps, then
    a cosine to 0 at max(2, total); ``count`` steps taken before this one."""
    warmup = max(1, int(0.1 * total))
    decay = max(2, total) - warmup
    if count < warmup:
        return peak * max(count, 0) / warmup
    c = min(count - warmup, decay)
    return peak * 0.5 * (1.0 + math.cos(math.pi * c / decay))


class AdamW:
    """Adam (b1 0.9, b2 0.999, eps 1e-8, bias-corrected) with decoupled
    weight decay: p <- p (1 - lr wd) - lr m_hat / (sqrt(v_hat) + eps)."""

    def __init__(self, params: list[torch.Tensor], weight_decay: float):
        self.params = params
        self.wd = weight_decay
        self.m = [torch.zeros_like(p) for p in params]
        self.v = [torch.zeros_like(p) for p in params]
        self.t = 0

    @torch.no_grad()
    def step(self, grads: list[torch.Tensor], lr: float) -> None:
        self.t += 1
        c1, c2 = 1 - 0.9**self.t, 1 - 0.999**self.t
        for p, g, m, v in zip(self.params, grads, self.m, self.v):
            m.mul_(0.9).add_(g, alpha=0.1)
            v.mul_(0.999).addcmul_(g, g, value=0.001)
            p.mul_(1.0 - lr * self.wd)
            p.sub_(lr * (m / c1) / ((v / c2).sqrt() + 1e-8))


def step_loss_and_grads(weights, leaves, batch, seed: int, cfg: dict, rate: float,
                        scale: float, block: int, quant=bert.exact):
    """One step's loss and the gradient of every leaf. ``batch``: anchor ids
    and real lengths, positive ids and real lengths, ids ``[B, S]`` long on
    the device at the padded shape the program was handed."""
    a_ids, a_len, p_ids, p_len = batch
    b, s = a_ids.shape
    shape = (b, s, cfg["hidden_size"])
    towers = draw_masks(seed, shape, cfg["num_hidden_layers"], rate, a_ids.device)
    sides = ((a_ids, a_len, towers[0]), (p_ids, p_len, towers[1]))

    def block_embed(ids, lens, drop, lo):
        rows = slice(lo, lo + block)
        n = int(lens[rows].max())
        mask = (torch.arange(n, device=ids.device)[None, :] < lens[rows][:, None]).to(torch.int32)
        d = (drop[0][rows, :n], [(m1[rows, :n], m2[rows, :n]) for m1, m2 in drop[1]])
        return bert.embed(weights, ids[rows, :n], mask, cfg, d, quant)

    with torch.no_grad():
        emb = [torch.cat([block_embed(i, ln, d, lo) for lo in range(0, b, block)])
               for i, ln, d in sides]
    qa, qp = (e.requires_grad_(True) for e in emb)
    loss = mnrl(qa, qp, scale)
    loss.backward()
    for t in leaves:
        t.grad = None
    for (ids, lens, drop), up in zip(sides, (qa.grad, qp.grad)):
        for lo in range(0, b, block):
            out = block_embed(ids, lens, drop, lo)
            (out * up[lo : lo + block]).sum().backward()
    return float(loss.detach()), [t.grad.detach().clone() for t in leaves]
