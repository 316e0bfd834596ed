"""Graphs of the port's control flow, recurrences, Resize and attention at
realistic shapes, built with the port's own codec: it imports numpy and
birdnet_tpu_torch only, so the card's machine, which has no JAX, runs it.
tests/test_torch_cuda.py and chip_smoke.py's control_flow phase hold the
card to the host with it (fp32, TF32 off, within ``TOL`` of the output's
largest magnitude).

``CASES[name] = (nodes, inputs, inits, outputs, opset)``. Every case but
``WHILE`` runs without a sync on the card; ``WHILE`` (a trip count given as
a tensor) reads its condition once per iteration, ``WHILE_STEPS + 1``
times (``HOST_READS`` of birdnet_tpu_torch/compiler/ops.py).
"""

from __future__ import annotations

import numpy as np

from birdnet_tpu_torch.onnx import proto as P

F = P.DataType
TOL = 1e-5
SEQ, BATCH = 64, 32
WHILE = "Loop_while"
CASES = {}


def _n(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


def _case(name, nodes, inputs, inits=None, outputs=("y",), opset=17):
    CASES[name] = (nodes, dict(inputs), dict(inits or {}), list(outputs), opset)


def _vi(name, dtype, shape):
    return P.make_value_info(name, dtype, list(shape))


def _rnn(name, kind, n_in, hidden, gates, seed, dirs=2, extra_ins=(), extra=None, **attrs):
    s = hidden ** -0.5
    inits = {"w": _n((dirs, gates * hidden, n_in), seed, s),
             "r": _n((dirs, gates * hidden, hidden), seed + 1, s),
             "b": _n((dirs, 2 * gates * hidden), seed + 2, 0.1), **(extra or {})}
    outs = ["y", "y_h", "y_c"] if kind == "LSTM" else ["y", "y_h"]
    node = P.make_node(kind, ["x", "w", "r", "b", *extra_ins], outs, hidden_size=hidden,
                       direction="bidirectional" if dirs == 2 else "forward", **attrs)
    _case(name, [node], {"x": _n((SEQ, BATCH, n_in), seed + 3)}, inits, outs)


# LSTM: bidirectional, hidden 512, peepholes, clip.
_rnn("LSTM", "LSTM", 256, 512, 4, 0, extra_ins=("", "", "", "p"),
     extra={"p": _n((2, 3 * 512), 4, 0.1)}, clip=3.0)
# GRU at the CRNN's widths (1280 in, hidden 128), both reset placements.
_rnn("GRU_lbr0", "GRU", 1280, 128, 3, 10, linear_before_reset=0)
_rnn("GRU_lbr1", "GRU", 1280, 128, 3, 20, linear_before_reset=1)
_rnn("RNN", "RNN", 256, 256, 1, 30, dirs=1)

# Resize.
_case("Resize_linear", [P.make_node("Resize", ["x", "", "scales"], ["y"], mode="linear",
                                    coordinate_transformation_mode="pytorch_half_pixel")],
      {"x": _n((BATCH, 1280, 16), 40)}, {"scales": np.array([1.0, 1.0, 4.0], np.float32)})
_case("Resize_cubic_antialias",
      [P.make_node("Resize", ["x", "", "", "sizes"], ["y"], mode="cubic", antialias=1)],
      {"x": _n((BATCH, 3, 96, 511), 41)}, {"sizes": np.array([BATCH, 3, 48, 256], np.int64)})
_case("Resize_nearest",
      [P.make_node("Resize", ["x", "", "scales"], ["y"], mode="nearest",
                   coordinate_transformation_mode="asymmetric", nearest_mode="floor")],
      {"x": _n((BATCH, 64, 48, 64), 42)},
      {"scales": np.array([1.0, 1.0, 2.0, 2.0], np.float32)})
_case("Resize_tf_crop_and_resize",
      [P.make_node("Resize", ["x", "roi", "", "sizes"], ["y"], mode="linear",
                   coordinate_transformation_mode="tf_crop_and_resize",
                   extrapolation_value=-1.0)],
      {"x": _n((8, 3, 96, 96), 43)},
      {"roi": np.array([0, 0, -0.1, 0.2, 1, 1, 0.8, 1.1], np.float32),
       "sizes": np.array([8, 3, 64, 64], np.int64)})

# Attention: GQA (8 query heads, 2 KV heads), causal, a past KV cache,
# softcap; RotaryEmbedding with position ids.
_case("Attention",
      [P.make_node("Attention", ["q", "k", "v", "", "pk", "pv"], ["y", "present_k",
                                                                  "present_v"],
                   is_causal=1, softcap=30.0)],
      {"q": _n((BATCH, 8, SEQ, 64), 50), "k": _n((BATCH, 2, SEQ, 64), 51),
       "v": _n((BATCH, 2, SEQ, 64), 52), "pk": _n((BATCH, 2, SEQ, 64), 53),
       "pv": _n((BATCH, 2, SEQ, 64), 54)},
      outputs=("y", "present_k", "present_v"), opset=23)
_theta = np.arange(128)[:, None] * (10000.0 ** (-np.arange(32) / 32))[None, :]
_case("RotaryEmbedding",
      [P.make_node("RotaryEmbedding", ["x", "c", "s", "pos"], ["y"])],
      {"x": _n((BATCH, 8, SEQ, 64), 55),
       "pos": np.random.default_rng(56).integers(0, 128, (BATCH, SEQ)).astype(np.int64)},
      {"c": np.cos(_theta).astype(np.float32), "s": np.sin(_theta).astype(np.float32)},
      opset=23)

# Control flow at width 1024: an If on a data-dependent condition (both
# branches run, one is selected), a for-form Loop above the unroll limit
# (80 steps, a scan output), and the while form.
W = 1024


def _branch(name, nodes, out):
    return P.GraphProto(name=name, node=nodes, output=[_vi(out, F.FLOAT, [])])


_case("If_tensor_condition",
      [P.make_node("ReduceSum", ["x"], ["s"], keepdims=0),
       P.make_node("Greater", ["s", "zero"], ["c"]),
       P.make_node("If", ["c"], ["y"],
                   then_branch=_branch("then", [P.make_node("MatMul", ["x", "wa"], ["ha"]),
                                                P.make_node("Tanh", ["ha"], ["o"])], "o"),
                   else_branch=_branch("else", [P.make_node("MatMul", ["x", "wb"], ["hb"]),
                                                P.make_node("Relu", ["hb"], ["p"])], "p"))],
      {"x": _n((BATCH, W), 60)},
      {"zero": np.float32(0.0), "wa": _n((W, W), 61, W ** -0.5), "wb": _n((W, W), 62, W ** -0.5)})


def _loop_body(cond_nodes=()):
    nodes = list(cond_nodes) or [P.make_node("Identity", ["cond_in"], ["cond_out"])]
    nodes += [P.make_node("MatMul", ["v", "wl"], ["h"]), P.make_node("Tanh", ["h"], ["t"]),
              P.make_node("Add", ["t", "x"], ["v_out"])]
    outs = [_vi("cond_out", F.BOOL, []), _vi("v_out", F.FLOAT, [BATCH, W])]
    if not cond_nodes:
        nodes.append(P.make_node("ReduceMean", ["v_out"], ["scan"], axes=[1], keepdims=0))
        outs.append(_vi("scan", F.FLOAT, [BATCH]))
    return P.GraphProto(name="body", node=nodes,
                        input=[_vi("i", F.INT64, []), _vi("cond_in", F.BOOL, []),
                               _vi("v", F.FLOAT, [BATCH, W])], output=outs)


_case("Loop_for_form",
      [P.make_node("Loop", ["m", "", "x"], ["y", "scans"], body=_loop_body())],
      {"x": _n((BATCH, W), 63, 0.5)}, {"m": np.int64(80), "wl": _n((W, W), 64, W ** -0.5)},
      outputs=("y", "scans"))
WHILE_STEPS = 6
_case(WHILE,
      [P.make_node("Loop", ["m", "", "x"], ["y"], body=_loop_body([
          P.make_node("ReduceMean", ["v"], ["mv"], keepdims=0),
          P.make_node("Abs", ["mv"], ["amv"]),
          P.make_node("Less", ["amv", "lim"], ["cond_out"])]))],
      {"x": _n((BATCH, W), 65, 0.5), "m": np.array(WHILE_STEPS, np.int64)},
      {"wl": _n((W, W), 66, W ** -0.5), "lim": np.float32(1e6)})


def model_bytes(name: str) -> bytes:
    nodes, inputs, inits, outputs, opset = CASES[name]
    init = [P.TensorProto.from_numpy(np.asarray(v), name=k) for k, v in inits.items()]
    in_vis = [P.make_value_info(k, P._NUMPY_TO_DTYPE[np.asarray(v).dtype],
                                list(np.asarray(v).shape)) for k, v in inputs.items()]
    out_vis = [P.make_value_info(n, F.FLOAT, []) for n in outputs]
    graph = P.GraphProto(name=name, node=nodes, initializer=init, input=in_vis, output=out_vis)
    return P.encode_model(P.make_model(graph, opset_version=opset))


def merged_decoder_bytes() -> bytes:
    """tests/test_freeze_inputs.py's ``_merged_decoder_like`` in the port's
    codec: If(use_cache_branch) gives Concat(past, x) along axis 1, else x
    alone (two output shapes), at width 1024. Inputs x [2, 1024],
    use_cache_branch [1] bool, past [2, 512]."""
    then_g = P.GraphProto(name="with_cache",
                          node=[P.make_node("Concat", ["past", "x"], ["out"], axis=1)],
                          output=[_vi("out", F.FLOAT, [2, W + W // 2])])
    else_g = P.GraphProto(name="no_cache", node=[P.make_node("Identity", ["x"], ["out"])],
                          output=[_vi("out", F.FLOAT, [2, W])])
    graph = P.GraphProto(
        name="merged",
        node=[P.make_node("If", ["use_cache_branch"], ["y"], then_branch=then_g,
                          else_branch=else_g)],
        input=[_vi("x", F.FLOAT, [2, W]), _vi("use_cache_branch", F.BOOL, [1]),
               _vi("past", F.FLOAT, [2, W // 2])],
        output=[_vi("y", F.FLOAT, [])])
    return P.encode_model(P.make_model(graph, opset_version=17))


def while_classifier_bytes(species: int = 10) -> bytes:
    """A graph on BirdNET v2.4's contract ([N, 144000] -> [N, species])
    whose Loop takes the while form: its condition is computed from the
    data (a tensor) before and in each iteration, its trip count is 3.
    Each forward reads the condition on the host 3 times (the host trip
    count ends the loop without a read), so a batch context cannot capture
    it."""
    body = P.GraphProto(
        name="halve",
        node=[P.make_node("Abs", ["v"], ["av"]),
              P.make_node("ReduceMax", ["av"], ["mx"], keepdims=0),
              P.make_node("Less", ["mx", "big"], ["cond_out"]),
              P.make_node("Mul", ["v", "half"], ["v_out"])],
        initializer=[P.TensorProto.from_numpy(np.float32(0.5), name="half"),
                     P.TensorProto.from_numpy(np.float32(1e6), name="big")],
        input=[_vi("i", F.INT64, []), _vi("cond_in", F.BOOL, []),
               _vi("v", F.FLOAT, [0, 1])],
        output=[_vi("cond_out", F.BOOL, []), _vi("v_out", F.FLOAT, [0, 1])])
    graph = P.GraphProto(
        name="while_v24",
        node=[P.make_node("ReduceMean", ["input"], ["m"], axes=[1], keepdims=1),
              P.make_node("ReduceMean", ["input"], ["s"], keepdims=0),
              P.make_node("Abs", ["s"], ["a"]),
              P.make_node("Less", ["a", "big"], ["go"]),
              P.make_node("Loop", ["trips", "go", "m"], ["h"], body=body),
              P.make_node("Mul", ["h", "w"], ["output_0"])],
        initializer=[P.TensorProto.from_numpy(np.float32(1e6), name="big"),
                     P.TensorProto.from_numpy(np.int64(3), name="trips"),
                     P.TensorProto.from_numpy(_n((1, species), 70), name="w")],
        input=[_vi("input", F.FLOAT, [0, 144_000])],
        output=[_vi("output_0", F.FLOAT, [0, species])])
    return P.encode_model(P.make_model(graph, opset_version=17))


def if_classifier_bytes(species: int = 10, seed: int = 0) -> bytes:
    """A graph on BirdNET v2.4's contract ([N, 144000] -> [N, species])
    whose If takes a tensor condition (the sign of the batch's mean), so
    both branches run on every forward. Each branch scales the rows' means
    by a weight of its own, an initializer of the branch ([1, species],
    seeded by ``seed``): the forward holds those on its device."""
    def branch(name, act):
        w = P.TensorProto.from_numpy(_n((1, species), 80 + 2 * seed + (act == "Relu")),
                                     name=f"w_{name}")
        return P.GraphProto(
            name=name,
            node=[P.make_node("Mul", ["m", f"w_{name}"], ["h"]),
                  P.make_node(act, ["h"], ["o"])],
            initializer=[w], output=[_vi("o", F.FLOAT, [0, species])])

    graph = P.GraphProto(
        name="if_v24",
        node=[P.make_node("ReduceMean", ["input"], ["m"], axes=[1], keepdims=1),
              P.make_node("ReduceMean", ["input"], ["s"], keepdims=0),
              P.make_node("Greater", ["s", "zero"], ["c"]),
              P.make_node("If", ["c"], ["output_0"], then_branch=branch("then", "Tanh"),
                          else_branch=branch("else", "Relu"))],
        initializer=[P.TensorProto.from_numpy(np.float32(0.0), name="zero")],
        input=[_vi("input", F.FLOAT, [0, 144_000])],
        output=[_vi("output_0", F.FLOAT, [0, species])])
    return P.encode_model(P.make_model(graph, opset_version=17))
