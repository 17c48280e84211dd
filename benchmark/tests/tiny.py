"""A cell of ``BENCHMARK.json`` cut to a size the CPU runs in seconds: the
tower as configured, a few hundred products and
queries, small batches. Everything else (the drivers, the generator, the
reference, the comparison and its limits) is the cell's own."""

from __future__ import annotations

import time

import torch

from benchmark import harness

TINY_TOWER: dict = {}
TINY_TRAFFIC = {
    "train": dict(batch=32, users=60, products=80, max_seq_length=64, ref_block=16),
    "serve_closed": dict(catalog=300, queries=64, batch=16, readers=2, sample_batches=2,
                         catalog_batch=64, max_seq_length=64),
    "serve_open": dict(catalog=300, queries=64, call=16, rate=4.0, readers=2, sample_batches=2,
                       catalog_batch=64, max_seq_length=64, grace_s=20),
}
SEED = 2**31 + 977  # over 32 signed bits, as the driver's seeds are
# The one limit a tiny run cannot share with its cell: MNRL's loss over a
# batch of 32 carries more of the bf16 towers' error than over 512 (the
# sound program reads 8e-5 to 1.1e-4 here on the CPU, the fp8 control 9e-4
# to 1.7e-3; at the cell's size on the card 4e-6 to 1.1e-5 against 1.4e-4).
TINY_LIMITS = {"train": {"loss_gap": 4e-4}}


def cell_files(name: str) -> tuple[dict, dict, dict, dict, dict]:
    spec = harness.benchmark_spec()
    cell = harness.find_cell(spec, name)
    config = harness.load_json(harness.config_file(spec, cell["config"]))
    traffic = harness.load_json(harness.traffic_file(cell["traffic"]))
    limits = harness.load_json(harness.limits_file(cell["name"]))
    return spec, cell, config, traffic, limits


def tiny(config: dict, traffic: dict) -> tuple[dict, dict]:
    return {**config, **TINY_TOWER}, {**traffic, **TINY_TRAFFIC[traffic["kind"]]}


def run_tiny(name: str, fault: str | None = None, seconds: float = 1.5, traced: bool = False,
             seed: int = SEED) -> dict:
    spec, cell, config, traffic, limits = cell_files(name)
    limits = {**limits, **TINY_LIMITS.get(traffic["kind"], {})}
    config, traffic = tiny(config, traffic)
    return harness.run_cell(cell, config, traffic, limits, seed, seconds, traced,
                            torch.device("cpu"), spec, time.perf_counter(), fault=fault)


def cells() -> list[str]:
    return [c["name"] for c in harness.benchmark_spec()["workloads"]]


def cells_of(kind: str) -> list[str]:
    out = []
    for name in cells():
        _, cell, _, traffic, _ = cell_files(name)
        if traffic["kind"] == kind:
            out.append(name)
    return out
