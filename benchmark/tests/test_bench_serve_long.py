"""The ModernBERT serve cell at a size the CPU runs: the driver's run reads
correct, and not correct under each planted fault; the fp8 control fails
the cell's limits; the band counts against brute force; the new readers on
a synthetic reading."""

from __future__ import annotations

import dataclasses
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from benchmark import counts_modernbert as cm, harness, workgen
from benchmark.drivers import serve_long
from benchmark.tests import tiny

CELL = "modernbert-embed-base.serve-long"
# The tower as configured but 128 wide and 4 layers deep (layers 0 and 3
# global), a 16-token window, and the projections' init 8x the published
# 0.02, so that where a layer attends moves the answer at this size (at
# 0.02 a 4-layer tower's embeddings hardly depend on it).
TINY_TOWER = dict(hidden_size=128, num_attention_heads=2, num_hidden_layers=4,
                  intermediate_size=192, local_attention=16, initializer_range=0.16)
TINY_TRAFFIC = dict(catalog=300, queries=24, min_orders=2, max_orders=6, batch_tokens=2048,
                    max_seq_length=512, readers=2, tokenizers=2, sample_batches=2,
                    catalog_batch=64, vocab_queries=24)
# The limits a tiny run cannot share with its cell: with the sharper init,
# bf16's rounding carries further at this size (the sound program reads
# score_gap 2.1e-3 to 2.9e-3, rank_gap 4.6e-4 to 8.6e-4 and embed_gap
# 5.7e-3 here on the CPU; every planted tower fault 0.058 or more on the
# first two and 0.26 or more on embed_gap, the fp8 control 0.083).
TINY_LIMITS = dict(score_gap=6e-3, rank_gap=3e-3, embed_gap=0.02)
FAULTS = ("unchanged", "half", "token", "answer") + serve_long.MODEL_FAULTS


def _files():
    spec, cell, config, traffic, limits = tiny.cell_files(CELL)
    return (spec, cell, {**config, **TINY_TOWER}, {**traffic, **TINY_TRAFFIC},
            {**limits, **TINY_LIMITS})


def _run(fault=None, seconds=1.0):
    spec, cell, config, traffic, limits = _files()
    return harness.run_cell(cell, config, traffic, limits, tiny.SEED, seconds, False,
                            torch.device("cpu"), spec, time.perf_counter(), fault=fault)


@pytest.mark.parametrize("fault", (None,) + FAULTS)
def test_correct_only_when_sound(fault):
    res = _run(fault)
    assert res["correct"] is (fault is None), res["checks"]
    assert (res["checks"]["token_mismatch"]["value"] > 0) is (fault == "token")


def test_the_panel_fails_the_control_and_every_tower_fault():
    """``control_serve_long``'s panel on one seed's judged batches: the fp8
    control and each planted tower fault read over a limit, the sound
    program under every one."""
    from benchmark import control_serve_long, trace

    spec, cell, config, traffic, limits = _files()
    ctx = harness.Ctx(cell, config, traffic, limits, tiny.SEED, 1.0, False, torch.device("cpu"),
                      trace.Spans())
    out = {r["variant"]: r for r in control_serve_long.panel(ctx)}
    assert out["sound"]["correct"], out["sound"]["numbers"]
    for variant in ("fp8", *serve_long.MODEL_FAULTS):
        assert not out[variant]["correct"], (variant, out[variant]["numbers"])


def test_histories_are_one_multiset_of_shapes():
    """Two seeds give the same order and product counts, other products."""
    t = {**tiny.cell_files(CELL)[3], "queries": 40}
    names = workgen.synthetic_users(0, 400, 5)["names"]

    def shape(text):  # products an order (each name holds one ", ": "..., 12 oz")
        body = text[len(t["query_prefix"]):]
        return tuple((seg.count(", ") + 1) // 2 for seg in body.split("; "))

    a, b = (serve_long.history_texts(t, names, s) for s in (5, 2**31 + 3))
    assert a != b and sorted(map(shape, a)) == sorted(map(shape, b))
    counts = [len(shape(x)) for x in a]
    assert min(counts) >= 8 and max(counts) <= 64
    assert all(5 <= n <= 15 for x in a for n in shape(x))
    assert all(x.startswith("search_query: [+") for x in a)


def test_batches_stay_within_the_token_budget():
    t = tiny.cell_files(CELL)[3]
    lengths = list(range(500, 8300, 7))

    def encode_batch(texts, max_seq_length):  # a text "n" is n tokens, cut at the cap
        mask = np.zeros((len(texts), max_seq_length), np.int32)
        for r, x in enumerate(texts):
            mask[r, : min(int(x), max_seq_length)] = 1
        return None, mask

    tok = SimpleNamespace(encode_batch=encode_batch)
    batches = serve_long.make_batches(tok, [str(n) for n in lengths], t)
    assert sum(len(b) for b in batches) == len(lengths)
    for b in batches:
        s = serve_long.bucket(min(max(int(x) for x in b), 8192), 8192)
        assert len(b) * s <= t["batch_tokens"] or len(b) == 1
    full = [len(b) for b in batches if min(int(b[0]), 8192) > 8192 - 256]
    assert max(full) == 16 and serve_long.bucket(8299, 8192) == 8192  # 16 rows at 8,192
    at_1024 = serve_long.make_batches(tok, ["1000"] * 300, t)
    assert [len(b) for b in at_1024] == [128, 128, 44]  # 128 rows at 1,024


@pytest.mark.parametrize("s", [1, 16, 64, 65, 100, 129, 200, 1000])
def test_band_counts_against_brute_force(s):
    brute = sum(1 for i in range(s) for j in range(s) if abs(i - j) <= 64)
    assert cm.band_pairs(s) == brute
    assert cm.band_attention_ops(s, 768) == 4 * 768 * brute
    if s >= 65:
        assert cm.band_pairs(s) == 129 * s - 4160
    # The kernel's scheduled tiles hold the band, and at most three key
    # tiles a query tile.
    assert brute <= cm.scheduled_band_pairs(s) <= min(s * s, 3 * 64 * s)


def test_counts_by_hand():
    cfg = {"hidden_size": 768, "intermediate_size": 1152, "num_hidden_layers": 22,
           "global_attn_every_n_layers": 3, "local_attention": 128}
    per_token = 2 * (4 * 768 * 768 + 3 * 768 * 1152)
    s = 1008  # 993 and 1,000 tokens both count at 1,008
    want = 22 * per_token * s + 8 * 4 * s * s * 768 + 14 * 4 * 768 * (129 * s - 4160)
    assert cm.tower_flops([993], cfg) == pytest.approx(want)
    assert cm.tower_flops([1000, 993], cfg) == pytest.approx(2 * want)
    assert cm.serve_flops([993], cfg, 100) == pytest.approx(want + 2 * 100 * 768)


def _reading(records, config, ops=(), counters=None):
    trace = SimpleNamespace(
        ops=[SimpleNamespace(name=n, dur=d, start=0.0, in_backward=False) for n, d in ops],
        ops_named=lambda pat, backward=None: [
            SimpleNamespace(dur=d) for n, d in ops if pat.search(n)],
    )
    ctx = SimpleNamespace(config=config, traffic={"max_seq_length": 8192, "top_k": 10})
    return harness.Reading(ctx, SimpleNamespace(records=records), trace, 1.0)


def test_readers_on_a_synthetic_reading(monkeypatch):
    config = harness.load_json(harness.config_file(harness.benchmark_spec(),
                                                   "modernbert-embed-base"))
    lengths = np.array([8000, 7000], dtype=np.int32)
    rec = {"all_batches": [{"rows": 2, "seq": 8000, "lengths": lengths}],
           "batches": [{"rows": 2, "seq": 8000, "lengths": lengths}],
           "window_s": 1.0, "n_catalog": 49688}
    h = 768
    g_bound = 8 * cm.global_attention_bound_s(2, 8000, h)
    w_bound = 14 * cm.band_attention_bound_s(2, 8000, h)
    ops = [("mb::mb_attn_global_kernel", 2 * g_bound), ("mb::mb_attn_band_kernel", 4 * w_bound),
           ("fl::gemm_wgmma_kernel<0, 0>", 1.0), ("mb::mb_rope_kernel", 1.0),
           ("mb::mb_geglu_kernel", 1.0), ("mb::mb_rownorm_kernel", 1.0)]
    reading = _reading(rec, config, ops)
    assert harness.metric_reader("attn_global_roofline.serve").read(
        "attn_global_roofline.serve", reading) == pytest.approx(50.0)
    assert harness.metric_reader("attn_window_roofline.serve").read(
        "attn_window_roofline.serve", reading) == pytest.approx(25.0)
    for name in ("mb_gemm_roofline.serve", "mb_rope_roofline.serve", "mb_geglu_roofline.serve",
                 "mb_rownorm_roofline.serve"):
        v = harness.metric_reader(name).read(name, reading)
        assert 0 < v < 100, (name, v)
    mfu = harness.metric_reader("mfu_modernbert.serve").read("mfu_modernbert.serve", reading)
    assert mfu == pytest.approx(100 * cm.serve_flops(lengths, config, 49688) / 989e12)
    # Nothing to read: a BERT serve run's records, or no kernel time.
    assert harness.metric_reader("attn_global_roofline.serve").read(
        "attn_global_roofline.serve", _reading(rec, config)) is None
    bert = _reading(rec, {"hidden_size": 768, "intermediate_size": 3072,
                          "num_hidden_layers": 12}, ops)
    assert harness.metric_reader("mfu_modernbert.serve").read("mfu_modernbert.serve", bert) is None
    from benchmark import program_trace

    full = 22 * 2 * 8192**2
    kept = 2 * (8 * 8192**2 + 14 * cm.scheduled_band_pairs(8192))
    monkeypatch.setattr(program_trace, "counters", lambda: {
        "attn.pairs.full": full, "attn.pairs.global": 2 * 8 * 8192**2,
        "attn.pairs.window": 2 * 14 * cm.scheduled_band_pairs(8192)})
    share = harness.metric_reader("window_share.serve").read("window_share.serve", reading)
    assert share == pytest.approx(100 * (1 - kept / full))
    assert 60 < share < 64
    monkeypatch.setattr(program_trace, "counters", lambda: {})
    assert harness.metric_reader("window_share.serve").read("window_share.serve", reading) is None
