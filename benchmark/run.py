"""Run one cell of ``BENCHMARK.json`` once, on one NVIDIA GPU.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. Progress and each compared number (beside its
limit) go to stderr; the last line of stdout is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``. It exits non-zero and prints no result
where CUDA is missing or has fewer cards than the cell asks for, where the
program is not beside the benchmark, or where JAX or the JAX package got
loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PORT = "instacart_next_order_recommendation_tpu_torch"


def set_cache_dirs(root: Path) -> None:
    """Every build and kernel cache at a fixed path inside the checkout (the
    program's own kernels build into ``build/kernels`` and ``build/native``
    beside it); no library may load JAX behind the program's back."""
    build = root / "build"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(build / "cuda_cache")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    os.environ["USE_TF"] = "0"


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    if not (ROOT / PORT).is_dir():
        print(f"run.py: the program ({PORT}) is not beside the benchmark in {ROOT}",
              file=sys.stderr)
        return 2
    set_cache_dirs(ROOT)
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))

    import torch

    from benchmark import harness

    spec = harness.benchmark_spec(ROOT)
    cell = harness.find_cell(spec, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        print(f"run.py: {args.workload} needs {cell['chips']} CUDA device(s); "
              f"this host has {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    config = harness.load_json(harness.config_file(spec, cell["config"]))
    traffic = harness.load_json(harness.traffic_file(cell["traffic"]))
    limits = harness.load_json(harness.limits_file(cell["name"]))
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    harness.log(f"{args.workload} seed {args.seed} seconds {args.seconds} trace {args.trace} "
                f"on {torch.cuda.get_device_name(device)}")
    result = harness.run_cell(
        cell, config, traffic, limits, args.seed, args.seconds, bool(args.trace), device,
        spec, T_START,
    )
    bad = harness.forbidden_loaded()
    if bad:
        print(f"run.py: JAX or the JAX package was loaded: {bad}", file=sys.stderr)
        return 4
    harness.report_checks(result["checks"])
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
