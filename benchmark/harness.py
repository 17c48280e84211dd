"""One run of one cell: find its files by name, set up, measure, judge.

A cell (an entry of ``workloads`` in ``BENCHMARK.json``) names a
configuration and a traffic mix. Everything else is found by those names:

- ``configs/<config>.json``: the model, as run;
- ``traffic/<traffic>.json``: the mix's parameters, whose ``kind`` names
  the driver in ``drivers/<kind>.py`` that runs it;
- ``limits/<cell>.json``: the limit of each number the comparison reads;
- ``metrics/<metric>.py`` (or ``metrics/<name before the first dot>.py``):
  the reader of each per-layer metric.

A later cell or metric is new files and new entries; nothing here changes.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib
import importlib.util
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "instacart_next_order_recommendation_tpu")


def log(msg: str) -> None:
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def load_json(path: Path) -> dict:
    return json.loads(path.read_text())


def benchmark_spec(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def find_cell(spec: dict, name: str) -> dict:
    for cell in spec["workloads"]:
        if cell["name"] == name:
            return cell
    raise KeyError(f"no workload named {name!r} in BENCHMARK.json")


def config_file(spec: dict, name: str) -> Path:
    for c in spec["configs"]:
        if c["name"] == name:
            return ROOT / c["file"]
    raise KeyError(f"no config named {name!r} in BENCHMARK.json")


def traffic_file(name: str) -> Path:
    return HERE / "traffic" / f"{name}.json"


def limits_file(cell: str) -> Path:
    return HERE / "limits" / f"{cell}.json"


def driver(kind: str):
    return importlib.import_module(f"benchmark.drivers.{kind}")


def metric_reader(name: str):
    """The reader module of a per-layer metric: ``metrics/<name>.py``, else
    the one of its family, ``metrics/<name up to the first dot>.py``."""
    for stem in (name, name.split(".")[0]):
        path = HERE / "metrics" / f"{stem}.py"
        if path.exists():
            spec = importlib.util.spec_from_file_location(f"benchmark_metric_{stem}", path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            return mod
    raise FileNotFoundError(f"no reader for metric {name!r} under {HERE / 'metrics'}")


def forbidden_loaded(modules=None) -> list[str]:
    """Top-level names of loaded modules that are JAX or the JAX package,
    compared whole (the port's name begins with the JAX package's)."""
    names = {m.split(".")[0] for m in (sys.modules if modules is None else modules)}
    return sorted(n for n in names if n in FORBIDDEN_MODULES)


@dataclasses.dataclass
class Ctx:
    """What a driver gets: the cell's files, the run's arguments, and where
    to record spans and results."""

    cell: dict
    config: dict
    traffic: dict
    limits: dict
    seed: int
    seconds: float
    traced: bool
    device: object
    spans: object
    fault: str | None = None  # a planted fault (tests and the control only)
    t_start: float = 0.0


@dataclasses.dataclass
class Window:
    """A driver's window: the end-to-end readings, the records its metric
    readers read, how many answers were attempted and failed."""

    end_to_end: dict
    records: dict
    attempted: int
    failed: int
    seconds: float


def run_cell(cell: dict, config: dict, traffic: dict, limits: dict, seed: int,
             seconds: float, traced: bool, device, metrics_spec: dict,
             t_start: float, fault: str | None = None) -> dict:
    """Set up, measure and judge one run; returns the result object the
    command prints (without the device check that ``run.py`` makes)."""
    import torch

    from benchmark import trace as tr

    spans = tr.Spans()
    ctx = Ctx(cell, config, traffic, limits, seed, seconds, traced, device, spans, fault, t_start)
    drv = driver(traffic["kind"])
    state = drv.setup(ctx)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t_start
    log(f"set-up {setup_s:.3f} s")

    prof = None
    if traced:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
        prof = profile(activities=acts)
        prof.start()
    t_traced = time.perf_counter()
    window = drv.window(ctx, state)
    trace = None
    if prof is not None:
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        traced_s = time.perf_counter() - t_traced
        prof.stop()
        trace = tr.reduce(prof, traced_s, spans.on_wall_clock())
        del prof
        log(f"trace: {len(trace.ops)} device operations, busy {trace.busy_s:.3f} of "
            f"{traced_s:.3f} s; {json.dumps(trace.census)}")
        if trace.ops and trace.spans:
            log(f"trace: first operation at {min(o.start for o in trace.ops):.3f}, first span "
                f"at {min(s[1] for s in trace.spans):.3f} (wall clock)")
    bad = forbidden_loaded()
    if bad:
        raise SystemExit(f"the run loaded {bad}: JAX or the JAX package must not load")
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0

    t_judge = time.perf_counter()
    checks = drv.judge(ctx, state, window)  # frees the program's state first
    log(f"comparison with the reference {time.perf_counter() - t_judge:.2f} s")
    del state
    gc.collect()
    failed = window.failed
    correct = failed == 0 and all(c["value"] <= c["limit"] for c in checks.values())

    metrics = {}
    breakdown = None
    if not traced:
        for m in metrics_spec["end_to_end"]:
            if m["name"] == "setup_s":
                metrics["setup_s"] = {"value": setup_s, "unit": "s"}
            elif m["name"] in window.end_to_end and (
                "workloads" not in m or cell["name"] in m["workloads"]
            ):
                metrics[m["name"]] = {"value": window.end_to_end[m["name"]], "unit": m["unit"]}
    else:
        reading = Reading(ctx, window, trace, setup_s)
        for m in metrics_spec["per_layer"]:
            if "workloads" in m and cell["name"] not in m["workloads"]:
                continue
            value = metric_reader(m["name"]).read(m["name"], reading)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        breakdown = tr.breakdown(trace) if trace is not None and trace.ops else None

    result = {
        "correct": bool(correct),
        "attempted": int(window.attempted),
        "failed": int(failed),
        "metrics": metrics,
        "device": device_block(device, peak, trace),
    }
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {k: {"value": c["value"], "limit": c["limit"]} for k, c in checks.items()}
    return result


@dataclasses.dataclass
class Reading:
    """What a per-layer metric reader gets."""

    ctx: Ctx
    window: Window
    trace: object  # trace.Trace, or None where nothing was traced
    setup_s: float


def device_block(device, peak: int, trace) -> dict:
    import torch

    if device.type == "cuda":
        block = {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1,
                 "memory_peak_bytes": int(peak)}
    else:
        block = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    if trace is not None:
        block["busy_s"] = trace.busy_s
        block["window_s"] = trace.window_s
    return block


def report_checks(checks: dict) -> None:
    """Each number compared beside its limit, as the last lines on stderr."""
    for name, c in checks.items():
        mark = "ok" if c["value"] <= c["limit"] else "OVER"
        print(f"check {name}: {c['value']!r} limit {c['limit']!r} {mark}",
              file=sys.stderr, flush=True)
