"""The port's recorder (``utils/profiling.py``) on the CPU: spans record only
under a profiler (on every thread) or a thread's own ``recording()``, on the
profiler's clock, with their parents; the tower counts its rows, padded
slots and real tokens in a serve call and a train step."""

import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from instacart_next_order_recommendation_tpu_torch.models.encoder import (
    TowerConfig,
    init_params,
)
from instacart_next_order_recommendation_tpu_torch.serve.pipeline import FusedServePipeline
from instacart_next_order_recommendation_tpu_torch.train.trainer import (
    TrainStep,
    build_optimizer,
    warmup_cosine_schedule,
)
from instacart_next_order_recommendation_tpu_torch.utils import profiling

TINY = TowerConfig(vocab_size=64, hidden_size=32, num_layers=1, num_heads=2,
                   intermediate_size=64, max_position=64, hidden_dropout=0.1)


@pytest.fixture(autouse=True)
def empty_recorder():
    profiling.clear()
    yield
    profiling.clear()


def ids_and_mask(rows: int, width: int, seed: int) -> tuple[np.ndarray, np.ndarray]:
    """Token ids with a pad (0) tail in each row, one row all pad."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(2, width + 1, size=rows)
    lengths[-1] = 0
    mask = (np.arange(width)[None] < lengths[:, None]).astype(np.int32)
    return np.where(mask == 1, rng.integers(5, TINY.vocab_size, size=(rows, width)), 0), mask


def serve_pipeline() -> FusedServePipeline:
    params = init_params(TINY, torch.Generator().manual_seed(0))
    catalog = torch.nn.functional.normalize(torch.randn(40, TINY.hidden_size), dim=-1)
    return FusedServePipeline(params, TINY, catalog, 40, pad_id=0, device="cpu")


def train_step() -> TrainStep:
    params = init_params(TINY, torch.Generator().manual_seed(1))
    params = {g: {n: t.requires_grad_(True) for n, t in v.items()} for g, v in params.items()}
    return TrainStep(params, TINY, build_optimizer(params, 0.01), warmup_cosine_schedule(1e-3, 4),
                     loss_scale=20.0, accum=1, device=torch.device("cpu"))


def test_nothing_is_recorded_without_a_profiler_or_recording():
    assert profiling.span("a") is profiling.span("b")  # one shared no-op
    with profiling.span("off"):
        profiling.count("n", 3)
        profiling.count_device("d", torch.ones(4))
    ids, mask = ids_and_mask(6, 16, 0)
    serve_pipeline().topk(ids, mask, 5)
    train_step()([torch.from_numpy(x) for x in (ids, mask, ids, mask)], seed=0)
    assert profiling.spans() == [] and profiling.counters() == {}


def test_a_span_on_a_second_thread_is_recorded_under_the_main_threads_profiler():
    def work():
        assert not torch.autograd._profiler_enabled()  # the profiler does not see this thread
        with profiling.span("worker"):
            profiling.count("n", 2)

    with profile(activities=[ProfilerActivity.CPU]):
        t = threading.Thread(target=work)
        t.start()
        t.join(timeout=30)
    assert not t.is_alive()
    (got,) = profiling.spans()
    assert got.name == "worker" and got.thread == t.ident
    assert profiling.counters() == {"n": 2}


def test_a_span_agrees_with_the_profilers_range_for_the_same_block():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        # The first range a process opens sets the profiler up after its
        # own start stamp (about 0.7 ms on a CPU build): not this block.
        with torch.profiler.record_function("first"):
            pass
        with profiling.span("block"):
            time.sleep(0.002)
    (got,) = profiling.spans()
    (rng,) = [e for e in prof.profiler.kineto_results.events() if e.name() == "block"]
    assert abs(got.start_ns - rng.start_ns()) < 100_000
    assert abs(got.end_ns - (rng.start_ns() + rng.duration_ns())) < 100_000


def test_nested_spans_link_to_their_parent():
    with profiling.recording() as got:
        with profiling.span("outer"):
            with profiling.span("middle"):
                with profiling.span("inner"):
                    pass
            with profiling.span("sibling"):
                pass
        with profiling.span("top"):
            pass
    by = {s.name: s for s in got}
    assert [s.name for s in got] == ["inner", "middle", "sibling", "outer", "top"]
    assert by["outer"].parent is None and by["top"].parent is None
    assert by["middle"].parent == by["sibling"].parent == by["outer"].id
    assert by["inner"].parent == by["middle"].id
    assert all(by["outer"].start_ns <= s.start_ns <= s.end_ns <= by["outer"].end_ns
               for s in (by["middle"], by["inner"], by["sibling"]))


def test_one_serve_call_counts_the_masks_and_the_shape():
    ids, mask = ids_and_mask(8, 32, 2)
    fused = serve_pipeline()
    with profile(activities=[ProfilerActivity.CPU]):
        fused.topk(ids, mask, 5)
    assert profiling.counters() == {"tower.rows": 8, "tower.slots": 8 * 32,
                                    "tower.tokens": int(mask.sum())}
    names = [s.name for s in profiling.spans()]
    assert names == ["serve.upload", "tower.encode", "serve.launch"]
    by = {s.name: s for s in profiling.spans()}
    assert by["tower.encode"].parent == by["serve.launch"].id


def test_one_train_step_counts_both_towers():
    a_ids, a_mask = ids_and_mask(6, 16, 3)
    p_ids, p_mask = ids_and_mask(6, 16, 4)
    step = train_step()
    with profile(activities=[ProfilerActivity.CPU]):
        step([torch.from_numpy(x) for x in (a_ids, a_mask, p_ids, p_mask)], seed=5)
    assert profiling.counters() == {"tower.rows": 12, "tower.slots": 2 * 6 * 16,
                                    "tower.tokens": int(a_mask.sum() + p_mask.sum())}
    by = {}
    for s in profiling.spans():
        by.setdefault(s.name, []).append(s)
    assert sorted(by) == ["tower.encode", "train.backward", "train.forward", "train.optimizer",
                          "train.step"]
    (root,) = by["train.step"]
    assert root.parent is None
    assert all(s.parent == root.id for n in ("train.forward", "train.backward",
                                             "train.optimizer") for s in by[n])
    assert [s.parent for s in by["tower.encode"]] == [by["train.forward"][0].id] * 2


def test_recording_keeps_one_threads_spans_to_itself_and_counts_nothing():
    def other():
        with profiling.span("elsewhere"):
            pass

    with profiling.recording() as got:
        with profiling.span("mine"):
            profiling.count("n", 1)
            profiling.count_device("d", torch.arange(4))
            t = threading.Thread(target=other)
            t.start()
            t.join(timeout=30)
    with profiling.span("after"):
        pass
    assert [s.name for s in got] == ["mine"]
    assert profiling.spans() == [] and profiling.counters() == {}


def test_clear_empties_the_list_and_the_counters():
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span("x"):
            profiling.count("n", 1)
            profiling.count_device("d", torch.arange(4))
    assert len(profiling.spans()) == 1 and profiling.counters() == {"n": 1, "d": 6}
    profiling.clear()
    assert profiling.spans() == [] and profiling.counters() == {}
