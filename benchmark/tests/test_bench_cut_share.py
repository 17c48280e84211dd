"""``cut_share.train`` on the CPU: on a traced tiny run of the train cell it
reads the share the window's records give (each step's anchors and
positives at their longest row rounded up to 16, against drivers/train.py's one
padded width); from a program without the slot count it reads nothing, and
from one that counts slots but cuts nothing, 0."""

import types

import pytest
from torch.profiler import ProfilerActivity, profile

from benchmark import harness
from benchmark.metrics import cut_share
from benchmark.tests import tiny
from benchmark.tests.test_bench_program_trace import spied_run
from instacart_next_order_recommendation_tpu_torch.utils import profiling

NAME = "cut_share.train"


@pytest.fixture(autouse=True)
def empty_recorder():
    profiling.clear()
    yield
    profiling.clear()


def test_a_traced_tiny_train_run_reads_the_records_share(monkeypatch):
    cell = tiny.cells_of("train")[0]
    res, st, win = spied_run(monkeypatch, cell, traced=True)
    assert res["correct"], res["checks"]
    steps = win.records["steps"]
    seq = st["seq"]
    cut = sum(s["rows"] * ((seq - s["a_seq"]) + (seq - s["p_seq"])) for s in steps)
    want = 100.0 * cut / sum(2 * s["rows"] * seq for s in steps)
    assert res["metrics"][NAME]["value"] == pytest.approx(want, rel=0, abs=1e-9)
    # The positives (product names) run narrower than the contexts' width.
    assert all(s["p_seq"] < seq for s in steps) and 0.0 < want < 50.0
    # The reader's own log line reads the records at that width too.
    traffic = tiny.tiny({}, tiny.cell_files(cell)[3])[1]
    ctx = types.SimpleNamespace(traffic=traffic)
    r_cut, r_slots = cut_share.from_records(harness.Reading(ctx, win, None, 0.0))
    assert 100.0 * r_cut / r_slots == pytest.approx(want, rel=0, abs=1e-9)


def test_nothing_without_the_slot_count_and_zero_without_a_cut():
    reading = harness.Reading(
        types.SimpleNamespace(traffic={"max_seq_length": 64}),
        types.SimpleNamespace(records={}), None, 0.0,
    )
    reader = harness.metric_reader(NAME)
    assert reader.read(NAME, reading) is None
    with profile(activities=[ProfilerActivity.CPU]):
        profiling.count("tower.slots", 64)
    assert reader.read(NAME, reading) == 0.0
    with profile(activities=[ProfilerActivity.CPU]):
        profiling.count("tower.cut_slots", 16)
    assert reader.read(NAME, reading) == 25.0
