"""The trace reduction and the readers, on a made-up trace: busy time is the
union of the device's intervals, gaps go to the spans open on the host, and
a reader with nothing to read returns None, never 0."""

import pytest

from benchmark import harness, trace
from benchmark.metrics import kernels


def made_up() -> trace.Trace:
    ops = [
        trace.DeviceOp("gemm_wgmma_kernel<0, 1>", 0.0, 1.0, False),
        trace.DeviceOp("attn_fwd_one_pass_kernel<32, 4, true>", 0.5, 1.0, False),  # overlaps
        trace.DeviceOp("gemm_wgmma_kernel<1, 3>", 3.0, 1.0, True),
        trace.DeviceOp("topk_slices_kernel<64, 16>", 5.0, 0.5, False),
    ]
    spans = [("dispatch", 1.4, 2.9), ("tokenize", 4.0, 4.9)]
    return trace.Trace(ops=ops, window_s=6.0, busy_s=3.0, spans=spans)


def test_busy_is_the_union():
    busy, merged = trace._busy([(0, 1), (0.5, 1.5), (3, 4)])
    assert busy == pytest.approx(2.5) and merged == [(0, 1.5), (3, 4)]


def test_breakdown_names_gaps_by_host_span():
    b = trace.breakdown(made_up())
    assert sorted(b["device_ops"], key=lambda x: x[0]) == [
        ["attn_fwd_one_pass_kernel<32, 4, true>", 1.0], ["gemm_wgmma_kernel<0, 1>", 1.0],
        ["gemm_wgmma_kernel<1, 3>", 1.0], ["topk_slices_kernel<64, 16>", 0.5]]
    gaps = dict(b["idle_gaps"])
    assert gaps == pytest.approx({"dispatch": 1.5, "tokenize": 1.0})


def test_kernel_tables_and_backward():
    t = made_up()
    assert kernels.seconds(t, kernels.K1, backward=False) == pytest.approx(2.0)
    assert kernels.seconds(t, kernels.K5, backward=True) == pytest.approx(1.0)
    assert kernels.seconds(t, kernels.K3) == pytest.approx(0.5)
    assert kernels.share(1.0, 0.0) is None and kernels.share(1.0, 4.0) == 25.0


def test_kernel_name_demangles():
    assert trace.kernel_name("void gemm_wgmma_kernel<0, 1>(CUtensorMap, float*)") == \
        "gemm_wgmma_kernel<0, 1>"


def test_readers_return_none_without_data():
    window = harness.Window(end_to_end={}, records={"all_batches": [], "batches": [],
                            "window_s": 1.0, "n_catalog": 10}, attempted=0, failed=0, seconds=1)
    ctx = harness.Ctx({"name": "x"}, {"hidden_size": 64, "intermediate_size": 128,
                      "num_hidden_layers": 2}, {"top_k": 10}, {}, 1, 1.0, True, None, None)
    reading = harness.Reading(ctx, window, None, 1.0)
    for name in ("idle.serve", "mfu.serve", "k1_roofline.serve", "k3_roofline.serve",
                 "k5_roofline.train", "tokenize_ms.serve", "dispatch_ms.train",
                 "encode_products_per_s.setup"):
        assert harness.metric_reader(name).read(name, reading) is None, name
