"""The sweep that chose an open-loop cell's rate, kept to be run again.

    python3 benchmark/sweep.py --config e5-base-v2 --traffic serve-open --seed <n> --seconds <s> --rates 24,28,32

One set-up, then one window a rate, each with its own schedule and calls
(shapes warmed before its window). For each rate it prints the latency's
median and 95th percentile, and the backlog's growth: the median latency
of the last fifth of the calls less that of the first fifth, which stays
near zero below the highest rate the program sustains and grows with the
window above it. The benchmark's own runs never run this.
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


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--config", required=True)
    parser.add_argument("--traffic", required=True, help="an open-loop mix")
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--rates", required=True, help="calls/s, comma-separated")
    args = parser.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from benchmark import run

    run.set_cache_dirs(ROOT)
    import numpy as np
    import torch

    from benchmark import harness, trace, workgen
    from benchmark.drivers import serve_open, serving

    cell = {"name": f"{args.config}.{args.traffic}", "chips": 1}
    config = harness.load_json(harness.HERE / "configs" / f"{args.config}.json")
    traffic = harness.load_json(harness.traffic_file(args.traffic))
    device = torch.device("cuda", 0)
    ctx = harness.Ctx(cell, config, traffic, {}, args.seed, args.seconds, False, device,
                      trace.Spans(), t_start=T_START)
    st = serving.setup(ctx)
    for rate in (float(r) for r in args.rates.split(",")):
        rctx = dataclasses.replace(ctx, traffic={**traffic, "rate": rate}, spans=trace.Spans())
        due = workgen.arrival_times(rate, args.seconds, args.seed)
        rng = workgen.rng_for(args.seed, 6)
        pool = st["queries"]
        st["due"] = due
        st["calls"] = [[pool[j] for j in rng.choice(len(pool), traffic["call"], replace=False)]
                       for _ in range(len(due))]
        serving.warm(rctx, st, st["calls"], None)
        win = serve_open.window(rctx, st)
        lat = np.asarray(win.records["latencies_ms"])
        fifth = max(1, len(due) // 5)
        seqs = [a["record"]["seq"] for a in win.records["answered"]]
        out = {
            "rate": rate, "calls": len(due), "failed_queries": win.failed,
            "p50_ms": float(np.median(lat)), "p95_ms": win.end_to_end["serve_p95_ms"],
            "growth_ms": float(np.median(lat[-fifth:]) - np.median(lat[:fifth])),
            "seq_counts": {str(s): seqs.count(s) for s in sorted(set(seqs))},
        }
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
