"""The port's control flow (If, Loop, Scan; birdnet_tpu_torch/compiler/ops.py)
against the JAX package's.

The cases of tests/test_control_flow_dynamic.py and the control-flow cases
of tests/test_compiler_ops.py run through both packages (tests/_torch_dual.py):
the JAX package's jitted forward and the port on the CPU, fp32, the port
within 1e-4 of each output's largest magnitude, and each case's own oracle
on the port's outputs. Then the port's own cases: Loop's for form above the
unroll limit, the while form's host reads, the error cases, an untaken
branch that would fault, and a Loop body reading a sparse initializer.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import test_compiler_ops as compiler_cases  # noqa: E402
import test_control_flow_dynamic as dynamic_cases  # noqa: E402
from _torch_dual import dual_run_graph, graph_model, run_jax, run_port, \
    through_the_port  # noqa: E402

from birdnet_tpu.onnx import proto as P  # noqa: E402
from birdnet_tpu_torch.compiler import ops as tops  # noqa: E402
from _torch_threads import torch_threads  # noqa: E402,F401

DYNAMIC = [
    "test_if_dynamic_condition", "test_loop_dynamic_trip_count",
    "test_loop_dynamic_initial_condition", "test_loop_hybrid_data_dependent_termination",
    "test_loop_dynamic_with_scan_outputs_rejected", "test_loop_long_for_loop_via_scan",
    "test_loop_long_with_real_termination_still_rejected",
    "test_loop_for_form_int64_max_rejected_cleanly",
    "test_loop_traced_trip_count_int64_max_saturates",
]
COMPILER_OPS = [
    ("test_if_static_condition", False), ("test_loop_static_trip_count", True),
    ("test_loop_early_exit_consumes_final_iteration", True),
    ("test_subgraph_outer_scope_capture", False), ("test_scan_cumulative_sum", True),
    ("test_scan_reverse_direction", True),
]


@pytest.mark.parametrize("case", DYNAMIC)
def test_dynamic_case_through_the_port(case, monkeypatch):
    through_the_port(monkeypatch, dynamic_cases, "_jit_run", dual_run_graph, case)


@pytest.mark.parametrize("case,takes_rng", COMPILER_OPS, ids=[c for c, _ in COMPILER_OPS])
def test_compiler_ops_case_through_the_port(case, takes_rng, monkeypatch):
    kwargs = {"rng": np.random.default_rng(42)} if takes_rng else {}
    through_the_port(monkeypatch, compiler_cases, "run_graph", dual_run_graph, case, **kwargs)


def _vi(name, dtype, shape):
    return P.make_value_info(name, dtype, list(shape))


def _counter_body(extra_nodes=(), inits=(), scan=True):
    """Body: v_out = v * 0.5 + iter; a scan output of v_out; cond
    passthrough unless ``extra_nodes`` compute cond_out."""
    nodes = list(extra_nodes) or [P.make_node("Identity", ["cond_in"], ["cond_out"])]
    nodes += [
        P.make_node("Cast", ["iter"], ["it_f"], to=P.DataType.FLOAT),
        P.make_node("Mul", ["v", "half"], ["vh"]),
        P.make_node("Add", ["vh", "it_f"], ["v_out"]),
    ]
    outs = [_vi("cond_out", P.DataType.BOOL, []), _vi("v_out", P.DataType.FLOAT, [3])]
    if scan:
        nodes.append(P.make_node("Identity", ["v_out"], ["s_out"]))
        outs.append(_vi("s_out", P.DataType.FLOAT, [3]))
    return P.GraphProto(
        name="body", node=nodes,
        initializer=[P.TensorProto.from_numpy(np.full(3, 0.5, np.float32), name="half"),
                     *inits],
        input=[_vi("iter", P.DataType.INT64, []), _vi("cond_in", P.DataType.BOOL, []),
               _vi("v", P.DataType.FLOAT, [3])],
        output=outs,
    )


def _both(nodes, inputs, inits=None, outputs=("y",)):
    data = P.encode_model(graph_model(nodes, inputs, inits, list(outputs)))
    return run_port(data, list(inputs.values())), run_jax(data, list(inputs.values()))


@pytest.mark.parametrize("m", [65, 200])
def test_loop_for_form_above_the_unroll_limit(m):
    """A for-form body above _LOOP_UNROLL_LIMIT runs its steps in Python (the
    counterpart of lax.scan): carried value and stacked scan outputs equal
    the JAX package's and a numpy recurrence, with no host read."""
    x = np.array([1.0, -2.0, 3.0], np.float32)
    node = P.make_node("Loop", ["M", "", "x"], ["final", "scans"], body=_counter_body())
    tops.HOST_READS["Loop"] = 0
    (final, scans), (j_final, j_scans) = _both(
        [node], {"x": x}, {"M": np.array(m, np.int64)}, ("final", "scans"))
    assert tops.HOST_READS["Loop"] == 0
    v, ref = x.astype(np.float64), []
    for i in range(m):
        v = v * 0.5 + i
        ref.append(v)
    np.testing.assert_allclose(scans, np.array(ref), rtol=1e-5)
    np.testing.assert_allclose(final, ref[-1], rtol=1e-5)
    np.testing.assert_allclose(scans, j_scans, rtol=1e-5)
    np.testing.assert_allclose(final, j_final, rtol=1e-5)


def test_while_form_reads_its_condition_once_per_iteration():
    """The while form's one host read per iteration (ROADMAP C): a tensor
    trip count, four iterations, five reads (the last one stops)."""
    x = np.array([1.0, 2.0, 3.0], np.float32)
    node = P.make_node("Loop", ["M", "", "x"], ["final"], body=_counter_body(scan=False))
    tops.HOST_READS["Loop"] = 0
    (got,), (want,) = _both([node], {"M": np.array(4, np.int64), "x": x}, {}, ("final",))
    assert tops.HOST_READS["Loop"] == 5
    np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("case", ["zero_iterations_with_scan_outputs",
                                  "unroll_cap_without_trip_count",
                                  "data_dependent_cond_out_with_scan_outputs"])
def test_loop_errors_match_the_jax_lowering(case):
    x = np.array([1.0, 2.0, 3.0], np.float32)
    if case == "zero_iterations_with_scan_outputs":
        node = P.make_node("Loop", ["M", "", "x"], ["final", "scans"], body=_counter_body())
        inputs, inits, outs, match = {"x": x}, {"M": np.array(0, np.int64)}, \
            ("final", "scans"), "zero iterations"
    elif case == "unroll_cap_without_trip_count":
        node = P.make_node("Loop", ["", "c", "x"], ["final"], body=_counter_body(scan=False))
        inputs, inits, outs, match = {"x": x}, {"c": np.array(True)}, ("final",), ">256"
    else:
        cond = [P.make_node("ReduceMax", ["v"], ["vmax"], keepdims=0),
                P.make_node("Less", ["vmax", "lim"], ["cond_out"])]
        lim = P.TensorProto.from_numpy(np.float32(100.0), name="lim")
        node = P.make_node("Loop", ["M", "", "x"], ["final", "scans"],
                           body=_counter_body(cond, [lim]))
        inputs, inits, outs, match = {"x": x}, {"M": np.array(10, np.int64)}, \
            ("final", "scans"), "data-dependent"
    data = P.encode_model(graph_model([node], inputs, inits, list(outs)))
    with pytest.raises(NotImplementedError, match=match):
        run_port(data, list(inputs.values()))
    with pytest.raises(NotImplementedError, match=match):
        run_jax(data, list(inputs.values()))


def _if_branches(then_nodes, then_out, else_nodes, else_out):
    return dict(
        then_branch=P.GraphProto(name="then", node=then_nodes,
                                 output=[_vi(then_out, P.DataType.FLOAT, [])]),
        else_branch=P.GraphProto(name="else", node=else_nodes,
                                 output=[_vi(else_out, P.DataType.FLOAT, [])]),
    )


def test_if_with_a_tensor_condition_and_branches_of_two_shapes_is_refused():
    """A data-dependent If whose branches differ in shape: a ValueError
    naming the node (XLA refuses the lax.cond too), before any host read."""
    branches = _if_branches([P.make_node("Concat", ["x", "x"], ["o"], axis=0)], "o",
                            [P.make_node("Neg", ["x"], ["p"])], "p")
    nodes = [P.make_node("ReduceSum", ["x"], ["s"], keepdims=0),
             P.make_node("Greater", ["s", "zero"], ["c"]),
             P.make_node("If", ["c"], ["y"], name="gate", **branches)]
    x = np.ones(3, np.float32)
    data = P.encode_model(graph_model(nodes, {"x": x}, {"zero": np.float32(0.0)}))
    tops.HOST_READS["Loop"] = 0
    with pytest.raises(ValueError, match="'gate'"):
        run_port(data, [x])
    with pytest.raises(Exception):
        run_jax(data, [x])


@pytest.mark.parametrize("take", [True, False])
def test_untaken_branch_with_an_out_of_range_gather_is_safe(take):
    """Both branches of a data-dependent If run in the port. The then
    branch gathers at an index that is in range only when the condition
    holds; the else branch is the guard. Gather answers an out-of-range
    index as the JAX lowering's jnp.take does (a fill, never a device
    fault), so the untaken branch is harmless and the taken one is exact."""
    table = np.arange(12, dtype=np.float32).reshape(4, 3)
    branches = _if_branches([P.make_node("Gather", ["table", "i"], ["o"], axis=0)], "o",
                            [P.make_node("Gather", ["table", "zero"], ["p"], axis=0)], "p")
    nodes = [P.make_node("Less", ["i", "four"], ["c"]),
             P.make_node("If", ["c"], ["y"], **branches)]
    i = np.array(2 if take else 9, np.int64)
    (got,), (want,) = _both(nodes, {"i": i, "table": table},
                            {"four": np.array(4, np.int64), "zero": np.array(0, np.int64)})
    np.testing.assert_array_equal(got, table[2] if take else table[0])
    np.testing.assert_array_equal(got, want)


def test_gather_out_of_range_fills_as_jnp_take():
    """Out-of-range tensor indices: NaN for floats, as the JAX lowering's
    jnp.take; negative in-range ones count from the end."""
    table = np.arange(12, dtype=np.float32).reshape(4, 3)
    idx = np.array([1, -1, 4, -5], np.int64)
    (got,), (want,) = _both([P.make_node("Gather", ["t", "i"], ["y"], axis=0)],
                            {"t": table, "i": idx})
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(got[:2], table[[1, 3]])
    assert np.isnan(got[2:]).all()


def test_sparse_initializer_in_a_loop_body():
    """A Loop body that reads its own sparse initializer. Both importers
    accept the graph (the reference check counts a subgraph's sparse
    initializers); the JAX package's subgraph environment seeds only the
    dense ones, so its forward fails, and the port's gives the numpy
    answer (ROADMAP C, fixed in the port)."""
    dense = np.array([0.0, 2.0, 0.0], np.float32)
    sparse = P.SparseTensorProto(
        values=P.TensorProto.from_numpy(np.array([2.0], np.float32), name="bump"),
        indices=P.TensorProto.from_numpy(np.array([1], np.int64), name="bump_idx"),
        dims=[3],
    )
    body = P.GraphProto(
        name="body",
        node=[P.make_node("Identity", ["cond_in"], ["cond_out"]),
              P.make_node("Add", ["v", "bump"], ["v_out"])],
        sparse_initializer=[sparse],
        input=[_vi("iter", P.DataType.INT64, []), _vi("cond_in", P.DataType.BOOL, []),
               _vi("v", P.DataType.FLOAT, [3])],
        output=[_vi("cond_out", P.DataType.BOOL, []), _vi("v_out", P.DataType.FLOAT, [3])],
    )
    x = np.array([1.0, 1.0, 1.0], np.float32)
    node = P.make_node("Loop", ["M", "", "x"], ["final"], body=body)
    data = P.encode_model(graph_model([node], {"x": x}, {"M": np.array(3, np.int64)},
                                      ["final"]))
    (got,) = run_port(data, [x])
    np.testing.assert_array_equal(got, x + 3 * dense)
    with pytest.raises(Exception, match="bump"):
        run_jax(data, [x])


@pytest.mark.parametrize("name", sorted(__import__("_torch_flow_cases").CASES))
def test_realistic_case_matches_jax(name):
    """tests/_torch_flow_cases.py's table (the graphs the card runs against
    the host) on the CPU against the JAX package's jitted forward, fp32,
    within 1e-4 of each output's scale."""
    import _torch_flow_cases as flow
    from _torch_core_common import assert_close

    data, inputs = flow.model_bytes(name), list(flow.CASES[name][1].values())
    got, want = run_port(data, inputs), run_jax(data, inputs)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert_close(g, w, 1e-4, f"{name} output {i}")


@pytest.mark.parametrize("flag", [True, False])
def test_merged_decoder_at_width_1024_matches_jax(flag):
    """The card's merged-decoder fixture (tests/_torch_flow_cases.py) on the
    CPU: the port's dispatch against the JAX package's (a concrete flag,
    its dispatching forward called eagerly) and the branch's numpy answer."""
    import _torch_flow_cases as flow
    from birdnet_tpu.compiler import import_onnx as j_import_onnx
    from birdnet_tpu.compiler import make_forward as j_make_forward

    data = flow.merged_decoder_bytes()
    x = np.random.default_rng(1).normal(size=(2, 1024)).astype(np.float32)
    past = np.random.default_rng(2).normal(size=(2, 512)).astype(np.float32)
    (got,) = run_port(data, [x, np.array([flag]), past])
    jm = j_import_onnx(data)
    assert jm.dispatch_inputs == ["use_cache_branch"]
    (want,) = j_make_forward(jm, "fp32")(jm.params, x, np.array([flag]), past)
    np.testing.assert_array_equal(got, np.asarray(want))
    np.testing.assert_array_equal(got, np.concatenate([past, x], 1) if flag else x)


def test_a_while_form_classifier_runs_on_the_host_and_reads_per_iteration(tmp_path):
    """A v2.4-contract graph with a while-form Loop through the port's
    Classifier on the CPU: predict_batch and the (eager, graph-less) batch
    context give the numpy answer, each forward reading its condition 3
    times. On the card the context's capture refuses it
    (tests/test_torch_cuda.py)."""
    import _torch_flow_cases as flow
    from birdnet_tpu_torch import Classifier

    path = tmp_path / "while_v24.onnx"
    path.write_bytes(flow.while_classifier_bytes(10))
    clf = (Classifier.builder().model_path(str(path)).labels([f"s{i}" for i in range(10)])
           .precision("fp32").with_device("cpu").build())
    segs = (np.random.default_rng(0).normal(size=(3, 144_000)) * 0.1).astype(np.float32)
    w = flow._n((1, 10), 70)
    want = segs.mean(axis=1, keepdims=True) * np.float32(0.125) * w
    tops.HOST_READS["Loop"] = 0
    got = np.stack([r.raw_scores for r in clf.predict_batch(segs)])
    assert tops.HOST_READS["Loop"] == 3
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-9)
    ctx = clf.create_batch_context(4)
    assert ctx.graph is None
    in_ctx = np.stack([r.raw_scores for r in clf.predict_batch_with_context(ctx, segs)])
    np.testing.assert_allclose(in_ctx, want, rtol=1e-5, atol=1e-9)


def test_a_forward_decodes_its_subgraph_initializers_once(monkeypatch):
    """A forward decodes and places its If branches' initializers when it
    is built and holds them: calling it, or building and running 40 other
    subgraph models beside it, decodes nothing of its own again, and its
    answer stays the JAX package's (fp32, 1e-4 of the output's scale)."""
    import _torch_flow_cases as flow

    from birdnet_tpu_torch.compiler import importer

    decoded = []
    real = importer.graph_consts_to_device
    monkeypatch.setattr(importer, "graph_consts_to_device",
                        lambda g, d: decoded.append(g.name) or real(g, d))
    data = flow.if_classifier_bytes(10, seed=0)
    model = importer.import_onnx(data)
    fwd = importer.make_forward(model, "fp32", "cpu")
    params = importer.params_to_torch(model.params, "cpu")
    assert sorted(decoded) == ["else", "then"]
    segs = (np.random.default_rng(3).normal(size=(2, 144_000)) * 0.1).astype(np.float32)
    (first,) = fwd(params, torch.from_numpy(segs))
    for seed in range(1, 41):
        other = importer.import_onnx(flow.if_classifier_bytes(10, seed))
        importer.make_forward(other, "fp32", "cpu")(
            importer.params_to_torch(other.params, "cpu"), torch.from_numpy(segs))
    decoded.clear()
    (again,) = fwd(params, torch.from_numpy(segs))
    assert decoded == []
    assert torch.equal(first, again)
    want = np.asarray(run_jax(data, [segs])[0])
    assert np.abs(first.numpy() - want).max() <= 1e-4 * np.abs(want).max()
