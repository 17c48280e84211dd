"""Long shopper histories through a ModernBERT tower: the staged batch serve
from text, closed loop, pass after pass.

The traffic: ``queries`` shopper histories, each ``query_prefix`` and then
whole orders, newest first, in the serve form ``[+Nd wDhH] name, name; ...``
(the oldest order has no ``+Nd``). Orders per history are log-uniform on
``min_orders``..``max_orders``, products per order uniform on
``min_products``..``max_products``, about ``reorder_share`` of each order
bought before; the order and product counts and the time tags are one fixed
multiset (``workgen.SHAPE_SEED``), and the seed picks the products and the
order of the queries, as ``workgen.query_texts`` does. The catalog is
``catalog`` products with ``workgen.synthetic_users``' real-length names
(6-10 words), each ``document_prefix`` and its text, encoded in set-up by
``TextEncoder.encode_resident``.

The queries are sorted by token length and cut into batches of consecutive
queries while rows x padded length (the tokenizer's bucket) stays within
``batch_tokens``; set-up warms every (rows, length) shape. The window is
``serve_closed``'s, rows unpadded: ``tokenizers`` threads tokenize, one
dispatcher launches ``FusedServePipeline.topk_device``, ``readers`` threads
``unpack``. ``judge`` holds a seed-drawn sample of ``sample_batches``
answered batches (the longest always among them) to the plain float32
ModernBERT of ``reference/modernbert.py`` by ``serving``'s numbers.

Faults (tests and ``control_serve_long.py``): ``serving.plant``'s, and in
the tower ``all_global`` (every layer global), ``all_window`` (every layer
windowed), ``thetas_swapped`` (each layer takes the other kind's RoPE
theta), ``geglu_swapped`` (Wi's input and gate halves swapped).
"""

from __future__ import annotations

import dataclasses
import math
import random
import time

import numpy as np
import torch

from benchmark import weights_modernbert, workgen
from benchmark.drivers import serve_closed, serving
from benchmark.harness import log
from benchmark.reference import modernbert as reference
from benchmark.reference.tokenizer import Tokenizer

MODEL_FAULTS = ("all_global", "all_window", "thetas_swapped", "geglu_swapped")


def bucket(longest: int, cap: int) -> int:
    """The length the program pads a batch to whose longest row holds
    ``longest`` tokens: its tokenizer's bucket (the rule the batches are cut
    by)."""
    from instacart_next_order_recommendation_tpu_torch.tokenizer.wordpiece import bucket_length

    return bucket_length(longest, cap)


def tower_config(cfg: dict, max_seq_length: int):
    """The port's ``TowerConfig`` of a ModernBERT configuration file."""
    from instacart_next_order_recommendation_tpu_torch.models.encoder import TowerConfig

    return TowerConfig(
        vocab_size=cfg["vocab_size"],
        hidden_size=cfg["hidden_size"],
        num_layers=cfg["num_hidden_layers"],
        num_heads=cfg["num_attention_heads"],
        intermediate_size=cfg["intermediate_size"],
        max_position=cfg["max_position_embeddings"],
        type_vocab_size=0,
        layer_norm_eps=cfg["norm_eps"],
        hidden_dropout=cfg["mlp_dropout"],
        max_seq_length=max_seq_length,
        compute_dtype=cfg["compute_dtype"],
        remat=False,
        architecture="modernbert",
        local_attention=cfg["local_attention"],
        global_attn_every_n_layers=cfg["global_attn_every_n_layers"],
        global_rope_theta=cfg["global_rope_theta"],
        local_rope_theta=cfg["local_rope_theta"],
    )


def history_texts(t: dict, names: list[str], seed: int) -> list[str]:
    """The shopper histories (see the module's docstring). Each order's new
    products come from the shopper's pool of 300, none twice in an order."""
    shapes = np.random.default_rng(workgen.SHAPE_SEED)
    rng = workgen.rng_for(seed, 7)
    pick = random.Random(int(rng.integers(1 << 62)))  # per-order draws, fast for small k
    lo, hi = math.log(t["min_orders"]), math.log(t["max_orders"])
    pool = list(range(len(names)))
    out = []
    for _ in range(t["queries"]):
        n_orders = int(round(math.exp(shapes.uniform(lo, hi))))
        sizes = shapes.integers(t["min_products"], t["max_products"] + 1, size=n_orders).tolist()
        tags = shapes.integers((1, 0, 0), (30, 7, 24), size=(n_orders, 3)).tolist()
        pref = pick.sample(pool, min(len(pool), 300))
        bought: dict[int, None] = {}
        segments = []
        for o, (k, (days, dow, hour)) in enumerate(zip(sizes, tags)):  # oldest first
            n_re = min(int(round(k * t["reorder_share"])), len(bought))
            basket = pick.sample(list(bought), n_re)
            taken = set(basket)
            basket += [p for p in pick.sample(pref, min(len(pref), k + n_re))
                       if p not in taken][: k - n_re]
            tag = f"w{dow}h{hour}" if o == 0 else f"+{days}d w{dow}h{hour}"
            segments.append(f"[{tag}] " + ", ".join(names[p] for p in basket))
            bought.update(dict.fromkeys(basket))
        out.append(t["query_prefix"] + "; ".join(reversed(segments)) + ".")
    order = rng.permutation(len(out))
    return [out[i] for i in order]


def make_texts(t: dict, seed: int) -> tuple[list[str], list[str], dict]:
    """The catalog's documents, the queries and the vocab for ``seed``."""
    syn = workgen.synthetic_users(0, t["catalog"], seed)
    catalog = [t["document_prefix"] + x for x in syn["catalog"]]
    queries = history_texts(t, syn["names"], seed)
    vocab = workgen.train_vocab(catalog + queries[: t["vocab_queries"]], t["vocab_size"])
    return catalog, queries, vocab


def make_batches(tok, queries: list[str], t: dict) -> list[list[str]]:
    """Length-sorted batches within ``batch_tokens`` padded tokens."""
    lengths = []
    for lo in range(0, len(queries), 64):
        _, mask = tok.encode_batch(queries[lo : lo + 64], max_seq_length=t["max_seq_length"])
        lengths += mask.sum(axis=1).tolist()
    order = np.argsort(lengths, kind="stable")
    batches, cur, longest = [], [], 0
    for i in order:
        longest_if = max(longest, lengths[i])
        if cur and (len(cur) + 1) * bucket(longest_if, t["max_seq_length"]) > t["batch_tokens"]:
            batches.append(cur)
            cur, longest_if = [], lengths[i]
        cur.append(queries[i])
        longest = longest_if
    if cur:
        batches.append(cur)
    return batches


_PLANTED: list = []  # (module, name, original) of a patched tower function


def _patch(module, name: str, fn) -> None:
    _PLANTED.append((module, name, getattr(module, name)))
    setattr(module, name, fn)


def unplant() -> None:
    while _PLANTED:
        module, name, original = _PLANTED.pop()
        setattr(module, name, original)


def plant_model(fault: str, w: dict) -> None:
    """A fault in the tower: its layer kinds or thetas (the port's
    ``layer_attention``), or its GeGLU halves (the weights it is handed)."""
    from instacart_next_order_recommendation_tpu_torch.models import modernbert

    sound = modernbert.layer_attention
    if fault == "geglu_swapped":
        wi = w["layers"]["wi"]
        inter = wi.shape[-1] // 2
        w["layers"]["wi"] = torch.cat([wi[..., inter:], wi[..., :inter]], dim=-1).contiguous()
    elif fault == "all_global":
        _patch(modernbert, "layer_attention",
               lambda config, layer: (sound(config, layer)[0], -1))
    elif fault == "all_window":
        _patch(modernbert, "layer_attention",
               lambda config, layer: (config.local_rope_theta, config.local_attention // 2))
    elif fault == "thetas_swapped":
        def swapped(config, layer):
            theta, half = sound(config, layer)
            other = config.local_rope_theta if half < 0 else config.global_rope_theta
            return other, half

        _patch(modernbert, "layer_attention", swapped)
    else:
        raise ValueError(f"no such fault: {fault!r}")


def build_program(ctx, tok, catalog: list[str]) -> dict:
    """The program for ``ctx.seed`` with ``ctx.fault``'s tower fault planted:
    its weights, the catalog encoded by ``TextEncoder.encode_resident``, the
    index and the serve pipeline."""
    from instacart_next_order_recommendation_tpu_torch.index import ShardedCatalogIndex
    from instacart_next_order_recommendation_tpu_torch.models.text_encoder import TextEncoder
    from instacart_next_order_recommendation_tpu_torch.serve.pipeline import FusedServePipeline

    t, cfg, dev = ctx.traffic, ctx.config, ctx.device
    tower = tower_config(cfg, t["max_seq_length"])
    w = weights_modernbert.make(cfg, ctx.seed, dev)
    if ctx.fault in MODEL_FAULTS:
        plant_model(ctx.fault, w)
    encoder = TextEncoder(w, tower, tok, max_seq_length=t["max_seq_length"], device=dev)
    serving.sync(dev)
    t0 = time.perf_counter()
    with ctx.spans.span("encode_catalog"):
        emb = encoder.encode_resident(catalog, batch_size=t["catalog_batch"])
        serving.sync(dev)
    encode_s = time.perf_counter() - t0
    index = ShardedCatalogIndex(emb, mesh=None, device=dev)
    fused = FusedServePipeline(
        encoder.params, tower, index.catalog, len(catalog), pad_id=tok.pad_id,
        layers=encoder.layers, device=dev,
    )
    return {"tok": tok, "encoder": encoder, "index": index, "fused": fused,
            "encode_s": encode_s, "pad": tok.pad_id}


def setup(ctx) -> dict:
    from benchmark import port

    unplant()
    tower_config(ctx.config, ctx.traffic["max_seq_length"])  # a program without ModernBERT stops here
    log(f"imports done at {time.perf_counter() - ctx.t_start:.2f} s")
    catalog, queries, vocab = make_texts(ctx.traffic, ctx.seed)
    tok = port.tokenizer(vocab)
    log(f"texts and vocab at {time.perf_counter() - ctx.t_start:.2f} s")
    st = {"catalog": catalog, "queries": queries, "vocab": vocab,
          **build_program(ctx, tok, catalog)}
    log(f"weights and catalog encode ({st['encode_s']:.2f} s) at "
        f"{time.perf_counter() - ctx.t_start:.2f} s")
    st["batches"] = make_batches(tok, queries, ctx.traffic)
    log(f"{len(st['batches'])} batches at {time.perf_counter() - ctx.t_start:.2f} s")
    if ctx.fault is not None and ctx.fault not in MODEL_FAULTS:
        serving.plant(ctx.fault, st)
    serving.warm(ctx, st, st["batches"], None)
    return st


def window(ctx, st):
    """``serve_closed``'s window, each batch handed at its own rows."""
    unpadded = dataclasses.replace(ctx, traffic={**ctx.traffic, "batch": None})
    return serve_closed.window(unpadded, st)


def reference_embeddings(ctx, st, texts: list[str], quant=reference.exact):
    """The reference's catalog and query embeddings (float32, TF32 off)."""
    reference.no_tf32()
    cfg, dev, L = ctx.config, ctx.device, ctx.traffic["max_seq_length"]
    rtok = Tokenizer(st["vocab"])
    w = weights_modernbert.make(cfg, ctx.seed, dev)
    cat_rows = [rtok.encode(x, L) for x in st["catalog"]]
    q_rows = [rtok.encode(x, L) for x in texts]
    cat = reference.embed_lists(w, cat_rows, cfg, dev, rtok.pad, quant=quant)
    q = reference.embed_lists(w, q_rows, cfg, dev, rtok.pad, quant=quant)
    del w
    return q_rows, q, cat


def port_embeddings(st, sample: list[dict]) -> torch.Tensor:
    """The program's query embeddings of the judged batches: the serve
    path's encode (``encode_from_ids`` on the pipeline's own weights and
    layers, as ``FusedServePipeline.run_device`` calls it) run again on the
    ids each batch was handed, one row a served answer."""
    from instacart_next_order_recommendation_tpu_torch.models.text_encoder import encode_from_ids

    fused = st["fused"]
    parts = []
    with torch.inference_mode():
        for b in sample:
            ids = torch.from_numpy(np.ascontiguousarray(b["ids"].astype(fused.wire_dtype)))
            emb = encode_from_ids(fused.params, ids.to(fused.device), config=fused.config,
                                  pad_id=fused.pad_id, layers=fused.layers)
            parts.append(emb[: len(b["top"])].float())
    return torch.cat(parts) if parts else torch.zeros(0)


def embedding_numbers(q_port: torch.Tensor, q_ref: torch.Tensor) -> dict:
    """``embed_gap``: the widest distance between the program's and the
    reference's unit query embeddings. Random weights give every history
    nearly the same embedding, so where a layer attends moves a cosine
    against the catalog little, but moves the query's own embedding several
    times as far as the program's rounding does."""
    gap = (q_port.to(q_ref.device, torch.float32) - q_ref.float()).norm(dim=1)
    return {"embed_gap": float(gap.max())}


def compare(sample: list[dict], q_port, q_rows, q_ref, cat_ref, pad: int) -> dict:
    """The cell's numbers for ``sample`` (answered batches: ``texts``, the
    program's tokens ``ids``, its answer ``scores`` and ``top``) and the
    program's query embeddings ``q_port``, against the reference's tokens
    and embeddings: ``serving``'s, and ``embedding_numbers``'s."""
    mismatch, lo = 0, 0
    for b in sample:
        n = len(b["texts"])
        mismatch += serving.token_mismatch(q_rows[lo : lo + n], b["ids"], pad)
        lo += n
    numbers = {"token_mismatch": mismatch, "nothing_answered": int(not sample)}
    if sample:
        numbers.update(serving.serve_numbers(
            q_ref, cat_ref, np.concatenate([b["scores"] for b in sample]),
            np.concatenate([b["top"] for b in sample]),
        ))
        numbers.update(embedding_numbers(q_port, q_ref))
    numbers["sampled"] = sum(len(b["texts"]) for b in sample)
    return numbers


def judge(ctx, st, win) -> dict:
    sample = serving.sample_batches(win.records.pop("answered"), ctx.traffic["sample_batches"],
                                    ctx.seed)
    q_port = port_embeddings(st, sample)
    unplant()
    serving.free_program(st)
    texts = [x for b in sample for x in b["texts"]]
    q_rows, q, cat = reference_embeddings(ctx, st, texts)
    return serving.with_limits(compare(sample, q_port, q_rows, q, cat, st["pad"]), ctx.limits)
