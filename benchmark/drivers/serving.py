"""What the serve kinds share: the served catalog and its tower, the record
of a served batch, and the comparison with the reference.

Set-up makes the catalog and query texts from the seed, trains the vocab on
them (as the trainer trains it on its corpus and contexts), makes the weights on the device, and builds the program's
serve path as a deployment does: ``TextEncoder.encode_resident`` encodes
the catalog (timed: the ``encode_products_per_s.setup`` reading), a
``ShardedCatalogIndex`` holds it, and a ``FusedServePipeline`` serves
tokenized batches in one call (``topk_device``) whose packed result the
host ``unpack``s.

The comparison (``judge``) takes a sample of the answered batches drawn
from the seed, the batch with the longest queries among them, and holds
the program's token ids, top-k ids and scores to the reference: its own
tokenizer, the catalog and the queries encoded again in float32 from the
texts and the weights, and an exact top-k.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from benchmark import counts, port, weights, workgen
from benchmark.harness import log
from benchmark.reference import bert
from benchmark.reference.tokenizer import Tokenizer


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def setup(ctx) -> dict:
    """The catalog, its index and the fused pipeline over it; the queries."""
    from instacart_next_order_recommendation_tpu_torch.index import ShardedCatalogIndex
    from instacart_next_order_recommendation_tpu_torch.models.text_encoder import TextEncoder
    from instacart_next_order_recommendation_tpu_torch.serve.pipeline import FusedServePipeline

    t, cfg, dev = ctx.traffic, ctx.config, ctx.device
    log(f"imports done at {time.perf_counter() - ctx.t_start:.2f} s")
    catalog = workgen.catalog_texts(t["catalog"], ctx.seed)
    queries = workgen.query_texts(t["queries"], catalog, ctx.seed)
    vocab = workgen.train_vocab(catalog + queries, t["vocab_size"])
    tok = port.tokenizer(vocab)
    tower = port.tower_config(cfg, t["max_seq_length"])
    log(f"texts and vocab at {time.perf_counter() - ctx.t_start:.2f} s")
    w = weights.make(cfg, ctx.seed, dev)
    encoder = TextEncoder(w, tower, tok, max_seq_length=t["max_seq_length"], device=dev)
    sync(dev)
    t0 = time.perf_counter()
    with ctx.spans.span("encode_catalog"):
        emb = encoder.encode_resident(catalog, batch_size=t["catalog_batch"])
        sync(dev)
    encode_s = time.perf_counter() - t0
    log(f"weights and catalog encode ({encode_s:.2f} s) at {time.perf_counter() - ctx.t_start:.2f} s")
    index = ShardedCatalogIndex(emb, mesh=None, device=dev)
    log(f"index at {time.perf_counter() - ctx.t_start:.2f} s")
    fused = FusedServePipeline(
        encoder.params, tower, index.catalog, len(catalog), pad_id=tok.pad_id,
        layers=encoder.layers, device=dev,
    )
    st = {
        "catalog": catalog, "queries": queries, "vocab": vocab, "tok": tok,
        "encoder": encoder, "index": index, "fused": fused, "encode_s": encode_s,
        "pad": tok.pad_id,
    }
    if ctx.fault is not None:
        plant(ctx.fault, st)
    return st


class _Faulty:
    """The program's tokenizer or pipeline with one fault planted (the
    tests' and the control's broken runs): every other attribute passes
    through."""

    def __init__(self, inner, **overrides):
        self._inner = inner
        self.__dict__.update(overrides)

    def __getattr__(self, name):
        return getattr(self._inner, name)


def plant(fault: str, st: dict) -> None:
    """``token``: the tokenizer alters each row's first word piece;
    ``answer``: each row's best id is replaced where it is unpacked;
    ``half``: only the first half of each batch's rows is answered;
    ``unchanged``: every call returns the first call's result."""
    tok, fused, n = st["tok"], st["fused"], len(st["catalog"])
    if fault == "token":
        def encode_batch(*a, **k):
            ids, mask = tok.encode_batch(*a, **k)
            ids = ids.copy()
            other = np.where(ids[:, 1] == tok.unk_id, tok.sep_id, tok.unk_id)
            ids[:, 1] = np.where(mask[:, 1] != 0, other, ids[:, 1])
            return ids, mask

        st["tok"] = _Faulty(tok, encode_batch=encode_batch)
    elif fault == "answer":
        def unpack(packed, k):
            scores, top = fused.unpack(packed, k)
            top = top.copy()
            top[:, 0] = (top[:, 0] + n // 2) % n
            return scores, top

        st["fused"] = _Faulty(fused, unpack=unpack)
    elif fault == "half":
        def unpack(packed, k):
            scores, top = fused.unpack(packed, k)
            return scores[: len(top) // 2], top[: len(top) // 2]

        st["fused"] = _Faulty(fused, unpack=unpack)
    elif fault == "unchanged":
        first = []

        def topk_device(ids, mask, k):
            if not first:
                first.append(fused.topk_device(ids, mask, k))
            return first[0]

        st["fused"] = _Faulty(fused, topk_device=topk_device)
    else:
        raise ValueError(f"no such fault: {fault!r}")


def warm(ctx, st, batches, pad_batch_to: int | None) -> None:
    """One call of each distinct (rows, length) shape among ``batches`` (lists
    of texts), the way the window makes it."""
    t = ctx.traffic
    t0 = time.perf_counter()
    seen = set()
    for texts in batches:
        t1 = time.perf_counter()
        ids, _ = st["tok"].encode_batch(texts, max_seq_length=t["max_seq_length"],
                                        pad_batch_to=pad_batch_to)
        if ids.shape in seen:
            continue
        seen.add(ids.shape)
        t2 = time.perf_counter()
        packed, k = st["fused"].topk_device(ids, None, t["top_k"])
        t3 = time.perf_counter()
        st["fused"].unpack(packed.cpu().numpy(), k)
        log(f"warm {ids.shape}: tokenize {t2 - t1:.3f} s, launch {t3 - t2:.3f} s, "
            f"answer {time.perf_counter() - t3:.3f} s")
    sync(ctx.device)
    log(f"warmed {len(seen)} shapes in {time.perf_counter() - t0:.2f} s")


def batch_record(ids: np.ndarray, n_valid: int, pad: int) -> dict:
    """What the metric readers need of one answered batch: the rows handed
    to the program, the length it counts at (the longest real row rounded
    up to 16) and each real row's token count."""
    lengths = (ids[:n_valid] != pad).sum(axis=1)
    return {
        "rows": int(ids.shape[0]),
        "seq": counts.round_up(int(lengths.max()) if n_valid else 1),
        "lengths": lengths.astype(np.int32),
    }


def free_program(st: dict) -> None:
    for key in ("fused", "index", "encoder", "tok"):
        st.pop(key, None)
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def reference_embeddings(ctx, st, texts: list[str], quant=bert.exact):
    """The reference's catalog and query embeddings (float32, TF32 off)."""
    bert.no_tf32()
    cfg, dev, L = ctx.config, ctx.device, ctx.traffic["max_seq_length"]
    rtok = Tokenizer(st["vocab"])
    w = weights.make(cfg, ctx.seed, dev)
    cat_rows = [rtok.encode(x, L) for x in st["catalog"]]
    q_rows = [rtok.encode(x, L) for x in texts]
    cat = bert.embed_lists(w, cat_rows, cfg, dev, rtok.pad, quant=quant)
    q = bert.embed_lists(w, q_rows, cfg, dev, rtok.pad, quant=quant)
    del w
    return q_rows, q, cat


def serve_numbers(q_ref, cat_ref, scores: np.ndarray, ids: np.ndarray) -> dict:
    """The served answers against the reference's: ``malformed`` rows (an id
    out of range or repeated, a score not finite or out of order),
    ``score_gap`` (the widest gap between a served score and the
    reference's score of the same query and product) and ``rank_gap`` (the
    widest gap by which a served product's reference score lies below the
    reference's k-th best)."""
    n, k = ids.shape
    n_cat = cat_ref.shape[0]
    bad = (ids < 0) | (ids >= n_cat)
    malformed = sum(
        1 for r in range(n)
        if bad[r].any() or len(set(ids[r].tolist())) < k
        or not np.all(np.isfinite(scores[r])) or np.any(np.diff(scores[r]) > 0)
    )
    safe = torch.from_numpy(np.where(bad, 0, ids).astype(np.int64)).to(q_ref.device)
    s_ref = (q_ref[:, None, :] * cat_ref[safe]).sum(-1)  # [n, k]
    kth = bert.topk(q_ref, cat_ref, k)[0][:, -1:]
    got = torch.from_numpy(scores.astype(np.float32)).to(q_ref.device)
    return {
        "malformed": malformed,
        "score_gap": float((got - s_ref).abs().max()),
        "rank_gap": float((kth - s_ref).clamp_min(0).max()),
    }


def token_mismatch(rows: list[list[int]], ids: np.ndarray, pad: int) -> int:
    """Rows whose program ids differ from the reference tokenizer's."""
    bad = 0
    for r, ref in enumerate(rows):
        got = ids[r]
        if len(ref) > len(got) or list(got[: len(ref)]) != ref or np.any(got[len(ref):] != pad):
            bad += 1
    return bad


def judge(ctx, st, sample: list[dict]) -> dict:
    """``sample``: answered batches, each ``texts``, ``ids`` (the program's
    tokens), ``scores`` and ``top`` (its answer)."""
    free_program(st)
    texts = [x for b in sample for x in b["texts"]]
    q_rows, q, cat = reference_embeddings(ctx, st, texts)
    mismatch, lo = 0, 0
    for b in sample:
        n = len(b["texts"])
        mismatch += token_mismatch(q_rows[lo : lo + n], b["ids"], st["pad"])
        lo += n
    # Nothing answered in the window leaves nothing to judge: not correct.
    numbers = {"token_mismatch": mismatch, "nothing_answered": int(not sample)}
    if sample:
        numbers.update(serve_numbers(
            q, cat, np.concatenate([b["scores"] for b in sample]),
            np.concatenate([b["top"] for b in sample]),
        ))
    numbers["sampled"] = len(texts)
    return with_limits(numbers, ctx.limits)


def with_limits(numbers: dict, limits: dict) -> dict:
    """Each compared number beside its limit; a number with no limit is
    information (``sampled``) and is not compared."""
    limits = {"nothing_answered": 0, **limits}
    return {k: {"value": v, "limit": limits[k]} for k, v in numbers.items() if k in limits}


def sample_batches(answered: list, n: int, seed: int) -> list:
    """``n`` of the answered batches drawn from the seed, the one with the
    longest queries always among them."""
    if not answered:
        return []
    longest = max(range(len(answered)), key=lambda i: answered[i]["record"]["seq"])
    rng = workgen.rng_for(seed, 5)
    rest = [i for i in range(len(answered)) if i != longest]
    pick = [longest] + [int(i) for i in rng.choice(rest, size=min(n - 1, len(rest)),
                                                   replace=False)] if rest else [longest]
    return [answered[i] for i in pick]
