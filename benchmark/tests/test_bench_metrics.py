"""The metric arithmetic: interval union, idle gaps by host step, the
roofline counts against hand-worked shapes, the forward's operations
against the frozen generator's graph, and readers that find nothing."""

import math

import pytest

from benchmark.harness import context, roofline, trace
from benchmark.models import birdnet_v24, perch_v2
from benchmark.tests.small import small_cell


def test_union_of_intervals():
    assert trace.union_us([(0, 10), (5, 15), (20, 30), (21, 22)]) == 25
    assert trace.union_us([]) == 0
    assert trace.merged([(5, 6), (0, 2), (1, 3)]) == [(0, 3), (5, 6)]


def _event(name, ts, dur, cat=None):
    e = {"ph": "X", "name": name, "ts": ts, "dur": dur}
    if cat:
        e["cat"] = cat
    return e


def test_stretch_busy_idle_and_labels():
    events = [
        _event("bench.call", 0, 100), _event("bench.stage", 0, 20),
        _event("bench.replay", 20, 60), _event("bench.drain", 80, 20),
        _event("void k1", 10, 30, "kernel"), _event("void k1", 50, 20, "kernel"),
        _event("Memcpy HtoD", 35, 10, "gpu_memcpy"), _event("outside", 200, 10, "kernel"),
    ]
    s = trace.Stretch(events)
    assert s.window_s == pytest.approx(100e-6)
    assert s.busy_s == pytest.approx(55e-6)  # [10, 45) and [50, 70)
    assert s.kernel_s("k1") == pytest.approx(50e-6)
    assert s.kernel_s("k1", category="gpu_memcpy") == 0
    gaps = dict(s.idle_gaps())
    assert gaps == pytest.approx({"stage": 10e-6, "replay": 5e-6 + 10e-6, "drain": 20e-6})
    assert s.device_ops()[0] == ["void k1", pytest.approx(50e-6)]


def test_bound_takes_the_larger_term():
    t, by = roofline.bound_s(3.35e12, {"bf16": 989e12 / 2})
    assert (t, by) == (1.0, "bytes")
    t, by = roofline.bound_s(1.0, {"bf16": 989e12, "fp32": 67e12 * 2})
    assert (t, by) == (2.0, "operations")


def test_b2_count_at_the_v24_tile():
    cfg = small_cell("v24_stream_1h").config  # the frontend keeps its widths
    moved, ops = roofline.b2_work(cfg, 128)
    assert roofline.frontend_frames(cfg) == 511
    assert ops == {"bf16": 2.0 * 128 * 511 * 1024 * 96}
    assert moved == 2 * (128 * 144_000 + 96 * 1024 + 128 * 96 * 511)


def test_b4_count_by_hand():
    cfg = {"n_filters": 8, "sample_count": 1024 + 280 * 9, "hop": 280, "stem_channels": 4,
           "stages": [[8, 4, 3, 2], [8, 6, 5, 1]], "repeats": [1, 1], "b4_blocks": 1}
    moved, ops = roofline.b4_work(cfg, 2)
    # image 8x10 -> stem 4x5 (4 channels); block: expand 4->16 at 4x5,
    # depthwise stride 2 -> 2x3, squeeze-excite 16->1->16 (a quarter of the
    # block's 4 input channels), project 16->8; the second block is not B4's.
    mma = 4 * 16 * 20 + 16 * 8 * 6
    simt = 4 * 9 * 20 + 9 * 16 * 6 + 2 * 16 * 1
    assert ops == {"bf16": 2.0 * 2 * mma, "fp32": 2.0 * 2 * simt}
    weights = 40 + (4 * 16 + 16 + 160 + 2 * 16 * 1 + 1 + 16 + 16 * 8 + 8)
    assert moved == 2 * 2 * 80 + 2 * 2 * 8 * 6 + 4 * weights


@pytest.mark.parametrize("workload,gen", [("v24_stream_1h", birdnet_v24),
                                          ("perch_embed_1h", perch_v2)])
def test_forward_flops_by_hand(workload, gen):
    cfg = small_cell(workload, full_depth=True).config
    gb = gen.build(cfg)
    t = roofline.frontend_frames(cfg)
    h, w = math.ceil(cfg["n_filters"] / 2), math.ceil(t / 2)
    macs = cfg["n_filters"] * 1024 * t + cfg["stem_channels"] * 9 * h * w
    c_in = cfg["stem_channels"]
    for (c_out, e, k, stride), repeats in zip(cfg["stages"], cfg["repeats"]):
        for r in range(repeats):
            mid, s = c_in * e, (stride if r == 0 else 1)
            macs += c_in * mid * h * w
            h, w = math.ceil(h / s), math.ceil(w / s)
            macs += k * k * mid * h * w + 2 * mid * max(1, c_in // 4) + mid * c_out * h * w
            c_in = c_out
    head = cfg["head_channels"]
    macs += c_in * head * h * w + head * cfg["num_species"]
    assert roofline.forward_flops(gb, cfg["sample_count"]) == 2.0 * macs


def test_full_width_counts():
    cfg = small_cell("v24_stream_1h").config
    load = __import__("benchmark.harness.spec", fromlist=["load"]).load
    full, perch = load("v24_stream_1h").config, load("perch_embed_1h").config
    assert roofline.forward_flops(birdnet_v24.build(full), 144_000) == pytest.approx(
        0.870e9, rel=1e-3)
    assert roofline.forward_flops(perch_v2.build(perch), 160_000) == pytest.approx(
        1.632e9, rel=1e-3)
    assert cfg["n_filters"] == full["n_filters"]


def _ctx(trace_obj=None, **window):
    w = dict(seconds=2.0, latencies_s=[0.1] * 19 + [1.0], segments=400, setup_s=3.0,
             peak_bytes=2**21)
    w.update(window)
    return context.Context(cfg={"b4_blocks": 6}, traffic={}, window=context.Window(**w),
                           traced=trace_obj)


def test_end_to_end_readers():
    vals = context.read(["stream_seg_per_s", "recording_p95_ms", "peak_device_mib",
                         "setup_s"], _ctx())
    assert vals["stream_seg_per_s"] == 200.0 and vals["peak_device_mib"] == 2.0
    assert vals["recording_p95_ms"] == pytest.approx(1e3 * (0.1 + 0.05 * 0.9))
    assert vals["setup_s"] == 3.0


def test_readers_that_find_nothing_return_nothing():
    empty = trace.Stretch([_event("bench.call", 0, 100)])
    t = context.Traced(probe_seconds={}, probe_calls={}, stretch=empty, stretch_calls={},
                       stretch_segments=0, rows=None, flops_per_segment=1e9)
    names = ["classifier_host_ms_per_rec", "stage_ms_per_tile", "forward_device_ms_per_tile",
             "b4_roofline_pct", "b2_roofline_pct", "device_idle_pct", "stream_mfu_pct"]
    assert context.read(names, _ctx(t)) == {}
    assert context.read(["peak_device_mib"], _ctx(peak_bytes=0)) == {}
