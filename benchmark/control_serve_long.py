"""The readings that set each limit of a ``serve_long`` cell's comparison,
on the card.

    python3 benchmark/control_serve_long.py --workload <cell> --seeds 1,2,3 [--fault F] [--seconds S]

Without ``--fault``: one panel a seed, all against one float32 reference on
the cell's own inputs at its own size, the batches a run would judge (the
longest and ``sample_batches - 1`` more, drawn from the seed): the control,
by ``control.py``'s rule (the reference in the precision below the one the
configuration states: float8 e4m3 with one scale per tensor on every
product's operands and every stored activation, ``reference.bert.fp8``),
then the program, sound and with each of the tower's faults planted
(``serve_long.MODEL_FAULTS``), each answering those batches through
``FusedServePipeline.topk_device``. With ``--fault``: a whole run of the
cell with the fault planted in the program (``serving.plant``'s ``token``,
``answer``, ``half``, ``unchanged``, or a tower fault). One JSON line a
seed and variant on stdout, the numbers unrounded. The benchmark's own
runs never run this.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def judged_sample(ctx, batches: list[list[str]]) -> list[list[str]]:
    """The batches' texts a run would judge, the longest first."""
    from benchmark.drivers import serving

    answered = [{"texts": b, "record": {"seq": max(len(x) for x in b)}} for b in batches]
    return [a["texts"] for a in serving.sample_batches(answered, ctx.traffic["sample_batches"],
                                                       ctx.seed)]


def panel(ctx) -> list[dict]:
    """The numbers of each variant (``fp8``, ``sound``, each tower fault) on
    one seed's judged batches."""
    import numpy as np
    import torch

    from benchmark import port
    from benchmark.drivers import serve_long, serving
    from benchmark.reference import bert

    t = ctx.traffic
    catalog, queries, vocab = serve_long.make_texts(t, ctx.seed)
    tok = port.tokenizer(vocab)
    texts = judged_sample(ctx, serve_long.make_batches(tok, queries, t))
    flat = [x for b in texts for x in b]
    st = {"catalog": catalog, "vocab": vocab}
    q_rows, q, cat = serve_long.reference_embeddings(ctx, st, flat)
    out = []
    for variant in ("fp8", "sound", *serve_long.MODEL_FAULTS):
        t0 = time.perf_counter()
        if variant == "fp8":
            _, q8, cat8 = serve_long.reference_embeddings(ctx, st, flat, quant=bert.fp8)
            scores, top = bert.topk(q8, cat8, t["top_k"])
            scores, top = scores.cpu().numpy(), top.cpu().numpy().astype(np.int64)
            numbers = serving.serve_numbers(q, cat, scores, top)
            numbers.update(serve_long.embedding_numbers(q8, q))
            del q8, cat8
        else:
            fault = None if variant == "sound" else variant
            prog = serve_long.build_program(dataclasses.replace(ctx, fault=fault), tok, catalog)
            sample = []
            for b in texts:
                ids, _ = tok.encode_batch(b, max_seq_length=t["max_seq_length"])
                packed, k = prog["fused"].topk_device(ids, None, t["top_k"])
                scores, top = prog["fused"].unpack(packed.cpu().numpy(), k)
                sample.append({"texts": b, "ids": ids, "scores": scores, "top": top})
            q_port = serve_long.port_embeddings(prog, sample)
            serve_long.unplant()
            del prog
            numbers = serve_long.compare(sample, q_port, q_rows, q, cat, tok.pad_id)
        numbers["sampled"] = len(flat)
        out.append({"variant": variant, "numbers": numbers,
                    "correct": all(numbers[k] <= v for k, v in ctx.limits.items()
                                   if k in numbers),
                    "seconds": time.perf_counter() - t0})
        torch.cuda.empty_cache()
    return out


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
        print("control_serve_long.py: needs a CUDA device", file=sys.stderr)
        return 3
    config = harness.load_json(harness.config_file(spec, cell["config"]))
    traffic = harness.load_json(harness.traffic_file(cell["traffic"]))
    limits = harness.load_json(harness.limits_file(cell["name"]))
    device = torch.device("cuda", 0)
    from benchmark import trace

    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        if args.fault:
            res = harness.run_cell(cell, config, traffic, limits, seed, args.seconds, False,
                                   device, spec, time.perf_counter(), fault=args.fault)
            out = {"seed": seed, "fault": args.fault, "correct": res["correct"],
                   "failed": res["failed"], "checks": res["checks"],
                   "seconds": time.perf_counter() - t0}
            print(json.dumps(out), flush=True)
        else:
            ctx = harness.Ctx(cell, config, traffic, limits, seed, args.seconds, False, device,
                              trace.Spans())
            for out in panel(ctx):
                print(json.dumps({"seed": seed, **out}), flush=True)
        torch.cuda.empty_cache()
    return 0

if __name__ == "__main__":
    sys.exit(main())
