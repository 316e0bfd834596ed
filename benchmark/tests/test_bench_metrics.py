"""The metric arithmetic: interval union, idle gaps by host step, the
roofline counts against hand-worked shapes, the forward's operations
against the frozen generator's graph and against a hand-counted
HuBERT-shaped graph, and readers that find nothing."""

import math

import numpy as np
import pytest

from benchmark.harness import context, roofline, trace
from benchmark.models import birdnet_v24, perch_v2
from benchmark.models._builder import GraphBuilder
from benchmark.models.weights import draw
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
    # The counts of the if/elif chain the table of rules replaced, to the bit.
    assert roofline.forward_flops(birdnet_v24.build(full), 144_000) == 870_369_280.0
    assert roofline.forward_flops(perch_v2.build(perch), 160_000) == 1_632_258_048.0
    assert cfg["n_filters"] == full["n_filters"]


# A HuBERT-shaped encoder at a size counted by hand: 400 samples, a 3-layer
# strided conv feature encoder of 8 channels, a projection to 16, a grouped
# positional conv, two pre-LN layers of 2 heads of 8 with a 32-wide GELU
# FFN, a mean over frames and a 6-class head.
HUBERT_SAMPLES, HUBERT_CLASSES = 400, 6


def _f32(gb, value):
    return gb.const("c", np.array(value, dtype=np.float32))


def _i64(gb, values):
    return gb.const("s", np.array(values, dtype=np.int64))


def _layer_norm(gb, x, width, name):
    return gb.node("LayerNormalization", [x, gb.spec(f"{name}.s", [width], "uniform", 0.8, 1.2),
                                          gb.spec(f"{name}.b", [width], "normal", 0.0, 0.05)],
                   axis=-1, epsilon=1e-5)


def _gelu(gb, x):
    erf = gb.node("Erf", [gb.node("Div", [x, _f32(gb, math.sqrt(2.0))])])
    return gb.node("Mul", [gb.node("Mul", [x, gb.node("Add", [erf, _f32(gb, 1.0)])]),
                           _f32(gb, 0.5)])


def _linear(gb, x, c_in, c_out, name):
    y = gb.node("MatMul", [x, gb.weight(f"{name}.w", [c_in, c_out], fan_in=c_in)])
    return gb.node("Add", [y, gb.spec(f"{name}.b", [c_out], "zeros")])


def _hubert_shaped():
    gb = GraphBuilder("hubert_shaped")
    x = gb.node("Unsqueeze", ["input", _i64(gb, [1])])  # [1, 1, 400]
    c_in = 1
    for i, (k, s) in enumerate([(10, 5), (3, 2), (2, 2)]):
        x = gb.conv(x, c_in, 8, [k], f"fe{i}", strides=[s], pads=[0, 0])
        x = gb.node("Transpose", [x], perm=[0, 2, 1])
        x = _gelu(gb, _layer_norm(gb, x, 8, f"fe{i}.ln"))
        x = gb.node("Transpose", [x], perm=[0, 2, 1])
        c_in = 8
    x = gb.node("Transpose", [x], perm=[0, 2, 1])  # [1, 19, 8]
    x = _linear(gb, _layer_norm(gb, x, 8, "proj.ln"), 8, 16, "proj")  # [1, 19, 16]
    pos = gb.conv(gb.node("Transpose", [x], perm=[0, 2, 1]), 16, 16, [4], "pos", pads=[2, 2],
                  group=4, bias=True)  # [1, 16, 20]
    pos = gb.node("Slice", [pos, _i64(gb, [0]), _i64(gb, [-1]), _i64(gb, [2])])
    x = gb.node("Add", [x, gb.node("Transpose", [_gelu(gb, pos)], perm=[0, 2, 1])])
    for layer in range(2):
        name = f"l{layer}"
        h = _layer_norm(gb, x, 16, f"{name}.ln1")
        q, k, v = (gb.node("Reshape", [_linear(gb, h, 16, 16, f"{name}.{p}"),
                                       _i64(gb, [0, 0, 2, -1])]) for p in "qkv")
        q = gb.node("Transpose", [q], perm=[0, 2, 1, 3])  # [1, 2, 19, 8]
        k = gb.node("Transpose", [k], perm=[0, 2, 3, 1])  # [1, 2, 8, 19]
        v = gb.node("Transpose", [v], perm=[0, 2, 1, 3])
        scores = gb.node("Mul", [gb.node("MatMul", [q, k]), _f32(gb, 8 ** -0.5)])
        ctx = gb.node("MatMul", [gb.node("Softmax", [scores], axis=-1), v])
        ctx = gb.node("Reshape", [gb.node("Transpose", [ctx], perm=[0, 2, 1, 3]),
                                  _i64(gb, [0, 0, -1])])
        x = gb.node("Add", [x, _linear(gb, ctx, 16, 16, f"{name}.o")])
        h = _gelu(gb, _linear(gb, _layer_norm(gb, x, 16, f"{name}.ln2"), 16, 32, f"{name}.ff1"))
        x = gb.node("Add", [x, _linear(gb, h, 32, 16, f"{name}.ff2")])
    x = gb.node("ReduceMean", [_layer_norm(gb, x, 16, "ln")], axes=[1], keepdims=0)
    gb.gemm(x, 16, HUBERT_CLASSES, "output")
    return gb


def test_forward_flops_of_a_hubert_shaped_graph():
    frames = [(400 - 10) // 5 + 1, (79 - 3) // 2 + 1, (39 - 2) // 2 + 1]
    assert frames == [79, 39, 19]
    macs = 8 * 79 * 1 * 10 + 8 * 39 * 8 * 3 + 8 * 19 * 8 * 2  # the conv feature encoder
    macs += 19 * 8 * 16  # the projection
    macs += 16 * 20 * (16 // 4) * 4  # the positional conv: 20 frames, 4 of 16 channels a group
    layer = 4 * 19 * 16 * 16  # q, k, v and the output projection
    layer += 2 * 19 * 8 * 19 + 2 * 19 * 19 * 8  # scores and context, 2 heads of 8
    layer += 19 * 16 * 32 + 19 * 32 * 16  # the FFN
    macs += 2 * layer + 16 * HUBERT_CLASSES
    assert roofline.forward_flops(_hubert_shaped(), HUBERT_SAMPLES) == 2.0 * macs == 249_632.0


def test_hubert_shaped_graph_runs_through_the_port():
    """The frozen writer's attributes and constants for these ops (the
    LayerNormalization axis and epsilon, Softmax's axis, Reshape's 0 and
    -1, Slice's bounds, ReduceMean's axes) are ones the program imports and
    runs, at float32 on the host."""
    import torch

    from birdnet_tpu_torch.compiler import importer

    gb = _hubert_shaped()
    data = gb.encode(draw(gb.specs, 2**31 + 24, "cpu"), [("input", ["batch", HUBERT_SAMPLES])],
                     [("output", ["batch", HUBERT_CLASSES])])
    model = importer.import_onnx(data)
    fwd = importer.make_forward(model, "fp32", "cpu")
    x = torch.from_numpy(np.random.default_rng(24).standard_normal((3, HUBERT_SAMPLES),
                                                                    dtype=np.float32))
    (y,) = fwd(importer.params_to_torch(model.params, "cpu"), x)
    assert tuple(y.shape) == (3, HUBERT_CLASSES) and torch.isfinite(y).all()


def _rule(op, shapes, attrs=None, consts=()):
    """The output shape and multiply-adds that the rule of ``op`` gives
    inputs of ``shapes`` followed by constant inputs ``consts`` (None: an
    optional input left out)."""
    ins, table = [f"x{i}" for i in range(len(shapes))], {}
    for j, c in enumerate(consts):
        ins.append("" if c is None else f"c{j}")
        if c is not None:
            table[f"c{j}"] = np.array(c, np.int64)
    xs = list(shapes) + [None if c is None else (len(c),) for c in consts]
    y, macs = roofline.SHAPE_RULES[op](xs, attrs or {}, roofline._Consts(op, ins, table))
    return tuple(y), macs


@pytest.mark.parametrize("op,shapes,attrs,consts,out,macs", [
    ("Gemm", [(6, 3), (6, 5)], {"transA": 1}, (), (3, 5), 3 * 6 * 5),
    ("Gemm", [(6, 3), (5, 6)], {"transA": 1, "transB": 1}, (), (3, 5), 3 * 6 * 5),
    ("MatMul", [(4, 1, 5, 7), (3, 7, 2)], {}, (), (4, 3, 5, 2), 4 * 3 * 5 * 7 * 2),
    ("MatMul", [(7,), (4, 7, 2)], {}, (), (4, 2), 4 * 7 * 2),
    ("MatMul", [(3, 5, 7), (7,)], {}, (), (3, 5), 3 * 5 * 7),
    # (20 + 2 - 2 * (3 - 1) - 1) // 1 + 1 = 18 frames.
    ("Conv", [(2, 3, 20), (4, 3, 3)], {"dilations": [2], "pads": [1, 1]}, (), (2, 4, 18),
     2 * 4 * 18 * 3 * 3),
    # 4 groups of 2 input channels, stride 2: (9 + 2 - 3) // 2 + 1 = 5.
    ("Conv", [(1, 8, 9, 9), (16, 2, 3, 3)], {"group": 4, "strides": [2, 2], "pads": [1] * 4},
     (), (1, 16, 5, 5), 16 * 25 * 2 * 9),
    ("Reshape", [(2, 3, 4)], {}, ([0, -1, 2],), (2, 6, 2), 0),
    ("Slice", [(10, 8)], {}, ([1, 7], [100, 0], [0, 1], [2, -2]), (5, 4), 0),
    ("Slice", [(10, 8)], {}, ([2], [-1], None, None), (7, 8), 0),
    ("Pad", [(2, 3)], {}, ([0, 1, 0, 2],), (2, 6), 0),
    ("Concat", [(2, 3), (2, 5)], {"axis": -1}, (), (2, 8), 0),
    ("Where", [(2, 1, 4), (3, 1), (1,)], {}, (), (2, 3, 4), 0),
    ("Squeeze", [(1, 3, 1, 2)], {}, (), (3, 2), 0),
    ("Unsqueeze", [(3, 2)], {}, ([0, -1],), (1, 3, 2, 1), 0),
    ("ReduceMean", [(2, 3, 4)], {"axes": [1]}, (), (2, 1, 4), 0),
    ("ReduceMean", [(2, 3, 4)], {"keepdims": 0}, ([-1],), (2, 3), 0),
    ("Flatten", [(2, 3, 4, 5)], {"axis": 2}, (), (6, 20), 0),
    ("Transpose", [(2, 3, 4)], {}, (), (4, 3, 2), 0),
    ("LayerNormalization", [(2, 3, 4), (4,), (4,)], {"axis": -1}, (), (2, 3, 4), 0),
], ids=["gemm_transA", "gemm_transA_transB", "matmul_batch_broadcast", "matmul_vector_first",
        "matmul_vector_second", "conv_dilated", "conv_grouped_strided", "reshape_0_and_-1",
        "slice_steps", "slice_defaults", "pad", "concat", "where", "squeeze_ones",
        "unsqueeze_negative", "reduce_mean_keepdims", "reduce_mean_axes_input", "flatten",
        "transpose_reversed", "layer_norm"])
def test_shape_rules(op, shapes, attrs, consts, out, macs):
    assert _rule(op, shapes, attrs, consts) == (out, macs)


def _refused(case):
    gb = GraphBuilder(case)
    x = gb.node("Unsqueeze", ["input", _i64(gb, [1])])
    if case == "no_rule":
        gb.node("GroupNormalization", [x, gb.spec("s", [1], "zeros"), gb.spec("b", [1], "zeros")],
                num_groups=1)
    elif case == "two_outputs":
        gb.node("LayerNormalization", [x, gb.spec("s", [8], "zeros")], ["y", "mean"])
    elif case == "shape_not_constant":
        gb.node("Reshape", [x, gb.spec("shape", [2], "zeros")])
    else:
        gb.node("MatMul", [x, gb.spec("w", [4, 2], "zeros")])
    return gb


@pytest.mark.parametrize("case,match", [
    ("no_rule", "no shape rule for GroupNormalization"),
    ("two_outputs", "LayerNormalization has 2 outputs"),
    ("shape_not_constant", "Reshape's input shape is not a constant"),
    ("matmul_mismatch", "MatMul of"),
])
def test_forward_flops_refuses_what_it_cannot_count(case, match):
    with pytest.raises(ValueError, match=match):
        roofline.forward_flops(_refused(case), 8)


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
