"""Full-shape rehearsal of the port's real-data runbook.

The port's counterpart of ``scripts/rehearsal_real_shapes.py``. The real
Instacart CSVs and the pretrained all-MiniLM-L6-v2 weights are not
available offline, so this script shows that the runbook survives the
reference's scale with everything else real:

  - synthetic CSVs at reference scale (``--users 200000``: about 1.2M train
    pairs over 50k products) with real-name geometry (long product names,
    so the p5_mp20 prep fills max_seq_length 256, the reference's training
    shape), from the port's ``data/synthetic.py``;
  - a full-architecture warm-start checkpoint (vocab 30,522, H=384, 6
    layers; random weights: ``scripts/torch_make_rehearsal_checkpoint.py``)
    loaded through the same ``models/hf_loader.py`` path the real download
    would take;
  - the unmodified ``scripts/torch_real_data_run.py`` recipe: the
    p5_mp20_ef0.1 prep, warm-started epochs at B=64, S=256, lr 5e-5, MNRL
    scale 30, with the per-epoch IR eval over the 50k corpus.

Quality numbers from random warm-start weights are not comparable to the
reference's pretrained run; what it delivers is shapes, wall clock and
memory (peak host RSS and ``torch.cuda.max_memory_allocated``). The report
goes to ``<workdir>/REHEARSAL_RESULTS.md``.

    python scripts/torch_rehearsal_real_shapes.py [--users 200000] [--epochs 5] [--device cpu]
"""

from __future__ import annotations

# Allow running as `python scripts/<name>.py` from a repo checkout.
import sys as _sys
from pathlib import Path as _Path

_repo_root = str(_Path(__file__).resolve().parents[1])
if _repo_root not in _sys.path:
    _sys.path.insert(0, _repo_root)

import argparse
import json
import logging
import re
import resource
import time
from pathlib import Path

PROCESSED_NAME = "p5_mp20_ef0.1"  # the runbook's prep directory
TRAINER_LOGGER = "instacart_next_order_recommendation_tpu_torch.train.trainer"


class SeqLenLog(logging.Handler):
    """Keeps the padded sequence length the trainer logs."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.seq_lens: list[int] = []

    def emit(self, record: logging.LogRecord) -> None:
        m = re.search(r"padded seq len (\d+)", record.getMessage())
        if m:
            self.seq_lens.append(int(m.group(1)))


def shapes(workdir: Path, ckpt: Path, seq_lens: list[int]) -> dict:
    """What the run trained and evaluated on, read from its files."""
    from datasets import load_from_disk

    processed = workdir / "run" / "processed" / PROCESSED_NAME
    cfg = json.loads((ckpt / "config.json").read_text())
    return {
        "train_pairs": len(load_from_disk(str(processed / "train_dataset"))),
        "eval_queries": len(json.loads((processed / "eval_queries.json").read_text())),
        "corpus": len(json.loads((processed / "eval_corpus.json").read_text())),
        "vocab": cfg["vocab_size"],
        "hidden": cfg["hidden_size"],
        "layers": cfg["num_hidden_layers"],
        "padded_seq_len": seq_lens,
    }


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--users", type=int, default=200_000)
    parser.add_argument("--products", type=int, default=50_000)
    parser.add_argument("--workdir", type=Path, default=Path("torch_rehearsal_ws"))
    parser.add_argument("--epochs", type=int, default=5)
    parser.add_argument("--skip-baselines", action="store_true")
    parser.add_argument("--skip-compare", action="store_true")
    parser.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = parser.parse_args(argv)

    import torch

    from instacart_next_order_recommendation_tpu_torch.data.synthetic import (
        generate_instacart_csvs,
    )
    from instacart_next_order_recommendation_tpu_torch.device import resolve_device
    from scripts.torch_make_rehearsal_checkpoint import write_checkpoint
    from scripts.torch_real_data_run import main as runbook_main

    dev = resolve_device(args.device)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    wd = args.workdir
    wd.mkdir(parents=True, exist_ok=True)

    t0 = time.time()
    data_dir = wd / "data"
    if not (data_dir / "orders.csv").exists():
        print(f"=== generating reference-scale CSVs ({args.users} users, "
              f"{args.products} products, long names) ===")
        generate_instacart_csvs(
            data_dir, n_users=args.users, n_products=args.products, long_names=True, seed=1,
        )
        print(f"generated in {time.time() - t0:.0f}s")
    else:
        print(f"reusing CSVs in {data_dir}")

    ckpt = wd / "all-MiniLM-L6-v2"
    if not (ckpt / "pytorch_model.bin").exists():
        print("=== writing the full-architecture warm-start checkpoint ===")
        write_checkpoint(ckpt)

    print("=== running the real-data runbook (scripts/torch_real_data_run.py) ===")
    results = wd / "REHEARSAL_RESULTS.md"
    runbook_argv = [
        "--data-dir", str(data_dir),
        "--base-model", str(ckpt),
        "--workdir", str(wd / "run"),
        "--epochs", str(args.epochs),
        "--results", str(results),
        "--device", dev.type,
    ]
    if args.skip_baselines:
        runbook_argv.append("--skip-baselines")
    if args.skip_compare:
        runbook_argv.append("--skip-compare")
    seq_log = SeqLenLog()
    logging.getLogger(TRAINER_LOGGER).addHandler(seq_log)
    try:
        rc = runbook_main(runbook_argv)
    finally:
        logging.getLogger(TRAINER_LOGGER).removeHandler(seq_log)

    total_min = (time.time() - t0) / 60
    peak_gb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6
    peak_device_gb = torch.cuda.max_memory_allocated(dev) / 1e9 if dev.type == "cuda" else None
    device_note = (f"{peak_device_gb:.2f} GB ({torch.cuda.get_device_name(dev)})"
                   if peak_device_gb is not None else "not measured (CPU run)")
    print(f"rehearsal total: {total_min:.1f} min, peak host RSS {peak_gb:.1f} GB, "
          f"peak device memory {device_note}")
    if rc != 0 or not results.exists():
        return rc or 1
    shape = shapes(wd, ckpt, seq_log.seq_lens)
    summary = {"metric": "rehearsal", "users": args.users, "products": args.products,
               "epochs": args.epochs, "device": dev.type, "total_min": total_min,
               "peak_host_rss_gb": peak_gb, "peak_device_gb": peak_device_gb, **shape}
    # A banner and the footprint around the runbook's report: its template is
    # titled for the real-data parity run, and a rehearsal's quality columns
    # must not read as that claim.
    banner = (
        "> **SHAPE REHEARSAL, NOT REAL DATA.** Synthetic long-name CSVs and a"
        " random-weight all-MiniLM-L6-v2-architecture checkpoint through the"
        " unmodified runbook on the PyTorch port"
        " (scripts/torch_rehearsal_real_shapes.py). Quality columns are NOT"
        " comparable to the reference's pretrained warm start; the deliverables"
        " are the runbook's completion at reference scale, per-stage wall clocks"
        " and the memory envelope.\n\n"
    )
    results.write_text(
        banner
        + results.read_text()
        + "\n## Rehearsal shapes and resource footprint\n\n"
        f"- scale: {args.users} users, {args.products} products, long-name geometry\n"
        f"- train pairs {shape['train_pairs']}, eval queries {shape['eval_queries']}, "
        f"corpus {shape['corpus']}, padded seq len {shape['padded_seq_len']}\n"
        f"- checkpoint: vocab {shape['vocab']}, hidden {shape['hidden']}, "
        f"{shape['layers']} layers\n"
        f"- total wall clock: {total_min:.1f} min (data generation included)\n"
        f"- peak host RSS: {peak_gb:.1f} GB\n"
        f"- peak device memory (torch.cuda.max_memory_allocated): {device_note}\n"
    )
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
