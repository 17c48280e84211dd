"""What the end-to-end metrics count: latency from the due time, the tail
over every call with a stalled one counted, rates over the whole window."""

import time

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark.drivers import serve_closed, serve_open
from benchmark.tests import tiny


def test_latency_runs_from_the_due_time_not_the_release():
    due = [0.0, 0.1, 0.2]
    # The third call was released late, behind a stall, and answered at 0.5.
    done = {0: 0.05, 1: 0.3, 2: 0.5}
    lat = serve_open.latencies_ms(due, 0.0, done, deadline=10.0)
    assert lat == pytest.approx([50.0, 200.0, 300.0])


def test_a_call_never_answered_counts_as_missing_in_the_tail():
    due = np.arange(100) * 0.01
    done = {i: d + 0.005 for i, d in enumerate(due)}
    assert serve_open.p95(serve_open.latencies_ms(due, 0.0, done, 10.0)) == pytest.approx(5.0)
    for i in range(90, 100):  # ten calls stall past the deadline
        done[i] = 99.0
    lat = serve_open.latencies_ms(due, 0.0, done, 10.0)
    assert sum(x >= serve_open.MISSING_MS for x in lat) == 10
    assert serve_open.p95(lat) >= serve_open.MISSING_MS


def test_closed_loop_counts_only_answers_inside_the_window():
    answered = {
        0: {"t": 0.5, "top": np.zeros((256, 10))},
        1: {"t": 1.0, "top": np.zeros((256, 10))},
        2: {"t": 1.2, "top": np.zeros((256, 10))},  # after the close
    }
    inside, served = serve_closed.served_inside(answered, 1.0)
    assert inside == [0, 1] and served == 512


def test_the_rates_are_taken_over_the_whole_window():
    res = tiny.run_tiny(tiny.cells_of("serve_closed")[0], seconds=1.5)
    qps = res["metrics"]["serve_qps"]["value"]
    assert qps > 0 and res["attempted"] >= qps * 1.5  # answered after the close: not counted
    res = tiny.run_tiny(tiny.cells_of("train")[0], seconds=1.5)
    rate = res["metrics"]["train_pairs_per_s"]["value"]
    assert res["attempted"] % 16 == 0 and res["attempted"] / rate >= 1.5


def test_the_open_loop_answers_every_call_due():
    # The open-loop kind has no cell yet (its tail spread too widely on the
    # card to hold a bound): driven here through the harness at a tiny size.
    config = harness.load_json(harness.HERE / "configs" / "e5-base-v2.json")
    traffic = harness.load_json(harness.traffic_file("serve-open"))
    limits = harness.load_json(harness.limits_file("e5-base-v2.serve-open"))
    config, traffic = tiny.tiny(config, traffic)
    spec = {"end_to_end": [{"name": "serve_p95_ms", "unit": "ms"},
                           {"name": "setup_s", "unit": "s"}], "per_layer": []}
    res = harness.run_cell({"name": "open", "chips": 1}, config, traffic, limits, tiny.SEED,
                           2.0, False, torch.device("cpu"), spec, time.perf_counter())
    assert res["correct"] and res["failed"] == 0
    assert res["attempted"] == 8 * traffic["call"]  # 4 calls/s for 2 s, all due in the window
    assert res["metrics"]["serve_p95_ms"]["value"] > 0
