"""The readings that set each limit of a cell's comparison, on the card.

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3 [--fault F] [--seconds S]

Without ``--fault``: the control. The reference takes the program's place,
computed in the precision below the one the configuration states (float8
e4m3 with one scale per tensor for bf16 products), on the cell's own
inputs at the cell's own size, and is compared with the float32 reference
by the cell's numbers. With ``--fault``: a whole run of the cell with the
fault planted in the program (``token``, ``answer``, ``half``,
``unchanged``), window and all. One JSON line a seed on stdout. The
benchmark's own runs never run this.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def serve_control(ctx) -> dict:
    """The fp8 reference's top-k on the sample a run would judge: the
    batch of the longest queries and ``sample_batches - 1`` more."""
    import numpy as np

    from benchmark import workgen
    from benchmark.drivers import serving
    from benchmark.reference import bert

    t = ctx.traffic
    catalog = workgen.catalog_texts(t["catalog"], ctx.seed)
    queries = workgen.query_texts(t["queries"], catalog, ctx.seed)
    st = {"catalog": catalog, "vocab": workgen.train_vocab(catalog + queries, t["vocab_size"])}
    if t["kind"] == "serve_open":
        rng = workgen.rng_for(ctx.seed, 6)
        n = len(workgen.arrival_times(t["rate"], ctx.seconds, ctx.seed))
        batches = [[queries[j] for j in rng.choice(len(queries), t["call"], replace=False)]
                   for _ in range(n)]
    else:
        ordered = sorted(queries, key=len)
        batches = [ordered[lo : lo + t["batch"]] for lo in range(0, len(ordered), t["batch"])]
    answered = [{"texts": b, "record": {"seq": max(len(x) for x in b)}} for b in batches]
    sample = serving.sample_batches(answered, t["sample_batches"], ctx.seed)
    texts = [x for b in sample for x in b["texts"]]
    _, q, cat = serving.reference_embeddings(ctx, st, texts)
    _, q8, cat8 = serving.reference_embeddings(ctx, st, texts, quant=bert.fp8)
    scores, top = bert.topk(q8, cat8, t["top_k"])
    numbers = serving.serve_numbers(q, cat, scores.cpu().numpy(), top.cpu().numpy().astype(np.int64))
    numbers["sampled"] = len(texts)
    return numbers


def train_control(ctx) -> dict:
    """The fp8 reference's check steps against the float32 reference's."""
    import numpy as np

    from benchmark import workgen
    from benchmark.drivers import train
    from benchmark.reference import bert
    from benchmark.reference.tokenizer import Tokenizer

    t = ctx.traffic
    syn = workgen.synthetic_users(t["users"], t["products"], ctx.seed)
    anchors, positives = workgen.training_pairs(syn, t["max_prior_orders"], t["max_product_names"])
    vocab = workgen.train_vocab(syn["catalog"] + anchors[:50_000], t["vocab_size"])
    rtok = Tokenizer(vocab)
    L = t["max_seq_length"]
    memo: dict[str, list[int]] = {}
    rows_a = [memo.setdefault(x, rtok.encode(x, L)) for x in anchors]
    rows_p = [memo.setdefault(x, rtok.encode(x, L)) for x in positives]
    seq = workgen.bucket_length(max(len(r) for r in rows_a + rows_p), L)

    def pack(rows):
        ids = np.full((len(rows), seq), rtok.pad, np.int32)
        for i, r in enumerate(rows):
            ids[i, : len(r)] = r
        return ids, np.asarray([len(r) for r in rows])

    a_ids, a_len = pack(rows_a)
    p_ids, p_len = pack(rows_p)
    feed = train.feed(anchors, positives, t["batch"], ctx.seed)
    st = {"a_ids": a_ids, "a_len": a_len, "p_ids": p_ids, "p_len": p_len,
          "total": t["epochs"] * -(-len(anchors) // t["batch"]),
          "checked": [next(feed) for _ in range(t["check_steps"])]}
    ref = train.reference_run(ctx, st)
    ctrl = train.reference_run(ctx, st, quant=bert.fp8)
    return train.numbers(ctrl, ref, t["leaf_rule"])


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True, help="comma-separated")
    parser.add_argument("--fault", default=None)
    parser.add_argument("--seconds", type=float, default=3.0)
    args = parser.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from benchmark import run

    run.set_cache_dirs(ROOT)
    import torch

    from benchmark import harness

    spec = harness.benchmark_spec(ROOT)
    cell = harness.find_cell(spec, args.workload)
    if not torch.cuda.is_available():
        print("control.py: needs a CUDA device", file=sys.stderr)
        return 3
    config = harness.load_json(harness.config_file(spec, cell["config"]))
    traffic = harness.load_json(harness.traffic_file(cell["traffic"]))
    limits = harness.load_json(harness.limits_file(cell["name"]))
    device = torch.device("cuda", 0)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        if args.fault:
            res = harness.run_cell(cell, config, traffic, limits, seed, args.seconds, False,
                                   device, spec, time.perf_counter(), fault=args.fault)
            out = {"seed": seed, "fault": args.fault, "correct": res["correct"],
                   "failed": res["failed"], "checks": res["checks"]}
        else:
            ctx = harness.Ctx(cell, config, traffic, limits, seed, args.seconds, False, device,
                              None)
            kind = traffic["kind"]
            numbers = train_control(ctx) if kind == "train" else serve_control(ctx)
            out = {"seed": seed, "control": "fp8", "numbers": numbers}
        out["seconds"] = time.perf_counter() - t0
        print(json.dumps(out), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
