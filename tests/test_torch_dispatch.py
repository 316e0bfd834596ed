"""The port's importer: frozen inputs, merged-decoder dispatch and
model-local functions (birdnet_tpu_torch/compiler/importer.py,
birdnet_tpu_torch/compiler/functions.py) against the JAX package's.

The cases of tests/test_freeze_inputs.py, each through both packages on the
same file and inputs (fp32, the port on the CPU within 1e-6 of the JAX
package's jitted forward, and each case's numpy oracle), and the cases of
tests/test_onnx_functions.py through tests/_torch_dual.py. Then the
dispatching forward itself: one specialized forward per flag value, the
flag given as a host value or as a tensor, and each forward running only
its branch.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import test_onnx_functions as function_cases  # noqa: E402
from _torch_dual import dual_run  # noqa: E402
from test_contrib_ops import _model, _tensor, _vi  # noqa: E402
from test_freeze_inputs import _merged_decoder_like  # noqa: E402

from birdnet_tpu.compiler import import_onnx as j_import_onnx  # noqa: E402
from birdnet_tpu.compiler import make_forward as j_make_forward  # noqa: E402
from birdnet_tpu.onnx import proto as P  # noqa: E402
from birdnet_tpu_torch.compiler import ops as tops  # noqa: E402
from birdnet_tpu_torch.compiler.importer import import_onnx, make_forward, \
    params_to_torch  # noqa: E402
from birdnet_tpu_torch.errors import ModelLoadError  # noqa: E402

X = np.arange(6, dtype=np.float32).reshape(2, 3)
PAST = np.arange(8, dtype=np.float32).reshape(2, 4)


def _port(model, *inputs, **import_kw):
    im = import_onnx(P.encode_model(model), **import_kw)
    fwd = make_forward(im, "fp32", "cpu")
    return [np.asarray(o) for o in fwd(params_to_torch(im.params, "cpu"), *[
        torch.from_numpy(np.array(v)) if isinstance(v, np.ndarray) else v for v in inputs])]


def _jax(model, *inputs, jit=True, **import_kw):
    im = j_import_onnx(P.encode_model(model), **import_kw)
    fwd = j_make_forward(im, precision="fp32")
    fwd = jax.jit(fwd) if jit else fwd
    return [np.asarray(o) for o in fwd(im.params, *inputs)]


def _same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-7)


# -- tests/test_freeze_inputs.py ---------------------------------------------


def test_freeze_folds_shape_divergent_if():
    m = _merged_decoder_like()
    for flag, want in ((True, np.concatenate([PAST, X], axis=1)), (False, X)):
        im = import_onnx(P.encode_model(m), freeze_inputs={"use_cache_branch": flag})
        assert im.input_names == ["x", "past"]
        (y,) = _port(m, X, PAST, freeze_inputs={"use_cache_branch": flag})
        np.testing.assert_allclose(y, want)
        _same([y], _jax(m, X, PAST, freeze_inputs={"use_cache_branch": flag}))


def test_freeze_scalar_python_value_for_flag_shaped_input():
    frozen = import_onnx(P.encode_model(_merged_decoder_like()),
                         freeze_inputs={"use_cache_branch": 1})
    assert "use_cache_branch" not in frozen.input_names
    assert frozen.consts["use_cache_branch"].shape == (1,)
    assert frozen.consts["use_cache_branch"].dtype == np.bool_


def test_freeze_unknown_and_initializer_names_reject():
    with pytest.raises(ValueError, match="not a graph input"):
        import_onnx(P.encode_model(_merged_decoder_like()), freeze_inputs={"nope": True})
    m2 = _model([P.make_node("Add", ["x", "w"], ["y"])], [_vi("x", (2,))], [_vi("y", (2,))],
                [_tensor("w", np.ones(2, np.float32))])
    with pytest.raises(ValueError, match="initializer"):
        import_onnx(P.encode_model(m2), freeze_inputs={"w": np.zeros(2, np.float32)})


def test_freeze_shape_mismatch_rejects():
    with pytest.raises(ValueError, match="declares shape"):
        import_onnx(P.encode_model(_merged_decoder_like()),
                    freeze_inputs={"past": np.zeros((3, 4), np.float32)})


def test_auto_specialize_detects_flag_and_dispatches_both_values():
    m = _merged_decoder_like()
    im = import_onnx(P.encode_model(m))
    assert im.dispatch_inputs == ["use_cache_branch"]
    assert im.input_names == ["x", "use_cache_branch", "past"]
    for flag in (np.array([True]), np.array([False]), 1):
        got = _port(m, X, flag, PAST)
        _same(got, _jax(m, X, flag, PAST, jit=False))
    assert _port(m, X, 1, PAST)[0].shape == (2, 7)


def _cast_not_model():
    then_g = P.GraphProto(name="t", node=[P.make_node("Identity", ["x"], ["o"])],
                          output=[P.make_value_info("o", P.DataType.FLOAT, [2])])
    else_g = P.GraphProto(name="e", node=[P.make_node("Neg", ["x"], ["o"])],
                          output=[P.make_value_info("o", P.DataType.FLOAT, [2])])
    nodes = [P.make_node("Cast", ["flag"], ["fb"], to=P.DataType.BOOL),
             P.make_node("Not", ["fb"], ["nf"]),
             P.make_node("If", ["nf"], ["y"], then_branch=then_g, else_branch=else_g)]
    return _model(nodes, [_vi("x", (2,)), _vi("flag", (), P.DataType.INT32)],
                  [P.make_value_info("y", P.DataType.FLOAT, [2])], [])


def test_auto_specialize_flag_through_cast_not_chain():
    m = _cast_not_model()
    assert import_onnx(P.encode_model(m)).dispatch_inputs == ["flag"]
    x = np.array([1.0, -2.0], np.float32)
    np.testing.assert_allclose(_port(m, x, np.int32(0))[0], x)
    np.testing.assert_allclose(_port(m, x, np.int32(7))[0], -x)
    # The JAX package's traced flag takes its single-program path: the
    # same answer.
    _same(_port(m, x, np.int32(0)), _jax(m, x, np.int32(0)))


def test_auto_specialize_rejects_flags_with_data_uses():
    then_g = P.GraphProto(name="t", node=[P.make_node("Identity", ["x"], ["o"])],
                          output=[P.make_value_info("o", P.DataType.FLOAT, [1])])
    else_g = P.GraphProto(name="e", node=[P.make_node("Neg", ["x"], ["o"])],
                          output=[P.make_value_info("o", P.DataType.FLOAT, [1])])
    nodes = [P.make_node("If", ["flag"], ["a"], then_branch=then_g, else_branch=else_g),
             P.make_node("Where", ["flag", "a", "x"], ["y"])]
    m = _model(nodes, [_vi("x", (1,)), _vi("flag", (1,), P.DataType.BOOL)],
               [P.make_value_info("y", P.DataType.FLOAT, [1])], [])
    assert import_onnx(P.encode_model(m)).dispatch_inputs == []
    x = np.array([3.0], np.float32)
    for flag in (True, False):
        # Not dispatched: the If's condition is a tensor, both branches run
        # and the select gives the JAX package's lax.cond answer.
        _same(_port(m, x, np.array([flag])), _jax(m, x, np.array([flag])))


def test_auto_specialize_rejects_flag_exposed_as_output():
    m = _merged_decoder_like()
    m.graph.output.append(P.make_value_info("use_cache_branch", P.DataType.BOOL, [1]))
    assert import_onnx(P.encode_model(m)).dispatch_inputs == []


def test_auto_specialize_opt_out_and_freeze_interplay():
    data = P.encode_model(_merged_decoder_like())
    assert import_onnx(data, auto_specialize=False).dispatch_inputs == []
    assert import_onnx(data, freeze_inputs={"use_cache_branch": True}).dispatch_inputs == []


def test_freeze_casts_to_declared_dtype_and_folds_shape_math():
    m = _model([P.make_node("Reshape", ["x", "shp"], ["y"])],
               [_vi("x", (2, 6)), _vi("shp", (2,), P.DataType.INT64)],
               [P.make_value_info("y", P.DataType.FLOAT, [])], [])
    frozen = import_onnx(P.encode_model(m), freeze_inputs={"shp": [3, 4]})
    assert frozen.consts["shp"].dtype == np.int64
    x = np.arange(12, dtype=np.float32).reshape(2, 6)
    (y,) = _port(m, x, freeze_inputs={"shp": [3, 4]})
    np.testing.assert_allclose(y, x.reshape(3, 4))
    _same([y], _jax(m, x, freeze_inputs={"shp": [3, 4]}))


def test_auto_specialize_survives_checkpoint_roundtrip(tmp_path):
    """A .btck of a merged decoder keeps its dispatch list in either
    package: saved by the port, loaded by both; saved by the JAX package,
    loaded by the port."""
    from birdnet_tpu.checkpoint import load_checkpoint as j_load
    from birdnet_tpu.checkpoint import save_checkpoint as j_save
    from birdnet_tpu_torch.checkpoint import load_checkpoint, save_checkpoint

    m = _merged_decoder_like()
    data = P.encode_model(m)
    port_ck, jax_ck = tmp_path / "port.btck", tmp_path / "jax.btck"
    save_checkpoint(import_onnx(data), port_ck)
    j_save(j_import_onnx(data), jax_ck)
    for back in (load_checkpoint(port_ck), load_checkpoint(jax_ck)):
        assert back.dispatch_inputs == ["use_cache_branch"]
        fwd = make_forward(back, "fp32", "cpu")
        for flag, want in ((True, np.concatenate([PAST, X], 1)), (False, X)):
            (y,) = fwd(params_to_torch(back.params, "cpu"), torch.from_numpy(X),
                       np.array([flag]), torch.from_numpy(PAST))
            np.testing.assert_allclose(y.numpy(), want)
    assert j_load(port_ck).dispatch_inputs == ["use_cache_branch"]


def _two_flag_model():
    def branch(op, shape):
        return P.GraphProto(name=f"b_{op}", node=[P.make_node(op, ["x"], ["o"])],
                            output=[P.make_value_info("o", P.DataType.FLOAT, list(shape))])

    def graph(name, op):
        return P.GraphProto(name=name, node=[P.make_node(op, ["a", "a"] if op == "Mul"
                                                         else ["a"], ["o"])],
                            output=[P.make_value_info("o", P.DataType.FLOAT, [2])])

    nodes = [
        P.make_node("If", ["f1"], ["a"], then_branch=branch("Identity", [2]),
                    else_branch=branch("Neg", [2])),
        P.make_node("If", ["f2"], ["y"], then_branch=graph("t2", "Mul"),
                    else_branch=graph("e2", "Identity")),
    ]
    return _model(nodes, [_vi("x", (2,)), _vi("f1", (1,), P.DataType.BOOL),
                          _vi("f2", (1,), P.DataType.BOOL)],
                  [P.make_value_info("y", P.DataType.FLOAT, [2])], [])


def test_auto_specialize_two_independent_flags():
    m = _two_flag_model()
    assert import_onnx(P.encode_model(m)).dispatch_inputs == ["f1", "f2"]
    x = np.array([2.0, -3.0], np.float32)
    t, f = np.array([True]), np.array([False])
    for f1, f2, want in ((t, t, x * x), (t, f, x), (f, t, x * x), (f, f, -x)):
        (y,) = _port(m, x, f1, f2)
        np.testing.assert_allclose(y, want)
        _same([y], _jax(m, x, f1, f2, jit=False))


@pytest.mark.parametrize("seed", range(20))
def test_auto_specialize_fuzz_matches_freeze(seed):
    """The JAX case's random flag graphs: for both flag values the port's
    dispatch equals its frozen import and the JAX package's frozen one."""
    rng = np.random.default_rng(3000 + seed)
    n = int(rng.integers(2, 5))
    x = rng.normal(size=(2, n)).astype(np.float32)
    past = rng.normal(size=(2, int(rng.integers(1, 4)))).astype(np.float32)
    then_g = P.GraphProto(name="t", node=[P.make_node("Concat", ["past", "x"], ["o"], axis=1)],
                          output=[P.make_value_info("o", P.DataType.FLOAT, [])])
    op_name = ["Identity", "Neg", "Relu"][int(rng.integers(0, 3))]
    else_g = P.GraphProto(name="e", node=[P.make_node(op_name, ["x"], ["o"])],
                          output=[P.make_value_info("o", P.DataType.FLOAT, [])])
    flag_dt = [P.DataType.BOOL, P.DataType.INT32, P.DataType.INT64][int(rng.integers(0, 3))]
    chain = int(rng.integers(0, 3))
    nodes, cond = [], "flag"
    if chain >= 1:
        nodes.append(P.make_node("Cast", ["flag"], ["fb"], to=P.DataType.BOOL))
        cond = "fb"
    if chain == 2:
        nodes.append(P.make_node("Not", ["fb"], ["nf"]))
        cond = "nf"
    nodes.append(P.make_node("If", [cond], ["y"], then_branch=then_g, else_branch=else_g))
    m = _model(nodes, [_vi("x", (2, n)), _vi("flag", (1,), flag_dt), _vi("past", past.shape)],
               [P.make_value_info("y", P.DataType.FLOAT, [])], [])
    assert import_onnx(P.encode_model(m)).dispatch_inputs == ["flag"]
    for v in (True, False):
        got = _port(m, x, np.array([v]), past)
        _same(got, _port(m, x, past, freeze_inputs={"flag": v}))
        _same(got, _jax(m, x, past, freeze_inputs={"flag": v}))


def test_auto_specialize_rejects_narrowing_cast_chain():
    then_g = P.GraphProto(name="t", node=[P.make_node("Identity", ["x"], ["o"])],
                          output=[P.make_value_info("o", P.DataType.FLOAT, [2])])
    else_g = P.GraphProto(name="e", node=[P.make_node("Neg", ["x"], ["o"])],
                          output=[P.make_value_info("o", P.DataType.FLOAT, [2])])
    nodes = [P.make_node("Cast", ["flag"], ["f8"], to=P.DataType.UINT8),
             P.make_node("Cast", ["f8"], ["fb"], to=P.DataType.BOOL),
             P.make_node("If", ["fb"], ["y"], then_branch=then_g, else_branch=else_g)]
    m = _model(nodes, [_vi("x", (2,)), _vi("flag", (1,), P.DataType.INT32)],
               [P.make_value_info("y", P.DataType.FLOAT, [2])], [])
    assert import_onnx(P.encode_model(m)).dispatch_inputs == []
    x = np.array([1.0, -2.0], np.float32)
    (y,) = _port(m, x, np.array([256], np.int32))  # 256 → uint8 0 → False
    np.testing.assert_allclose(y, -x)
    _same([y], _jax(m, x, np.array([256], np.int32)))


def test_auto_specialize_opt_out_survives_checkpoint(tmp_path):
    from birdnet_tpu_torch.checkpoint import load_checkpoint, save_checkpoint

    im = import_onnx(P.encode_model(_merged_decoder_like()), auto_specialize=False)
    assert im.dispatch_inputs == []
    p = tmp_path / "optout.btck"
    save_checkpoint(im, p)
    assert load_checkpoint(p).dispatch_inputs == []


# -- the dispatching forward -------------------------------------------------


@pytest.mark.parametrize("as_tensor", [False, True])
def test_dispatch_keeps_one_forward_per_flag_value_and_runs_one_branch(as_tensor, monkeypatch):
    """Each flag value gets one specialized forward, built once; the flag
    may come as a host value or as a tensor (read once at the entry). In
    each, the If folds on the host: only its branch's nodes run."""
    im = import_onnx(P.encode_model(_merged_decoder_like()))
    params = params_to_torch(im.params, "cpu")
    ran = []
    for name in ("Concat", "Identity"):
        real = tops.get_lowering(name)
        monkeypatch.setitem(tops._REGISTRY, name,
                            lambda ctx, *a, real=real, name=name: ran.append(name) or real(ctx, *a))
    builds = []
    from birdnet_tpu_torch.compiler import importer

    real_plain = importer._make_plain_forward
    monkeypatch.setattr(importer, "_make_plain_forward",
                        lambda *a, **k: builds.append(1) or real_plain(*a, **k))
    fwd = make_forward(im, "fp32", "cpu")
    for _ in range(2):
        for flag, want, op_ran in ((True, np.concatenate([PAST, X], 1), "Concat"),
                                   (False, X, "Identity")):
            ran.clear()
            f = torch.tensor([flag]) if as_tensor else np.array([flag])
            (y,) = fwd(params, torch.from_numpy(X), f, torch.from_numpy(PAST))
            np.testing.assert_allclose(y.numpy(), want)
            assert ran == [op_ran]
    assert len(builds) == 2


def test_dispatch_counts_its_inputs():
    im = import_onnx(P.encode_model(_merged_decoder_like()))
    with pytest.raises(ValueError, match="expects 3 inputs"):
        make_forward(im, "fp32", "cpu")(params_to_torch(im.params, "cpu"), X)


def test_cli_inspect_prints_the_dispatch_line(tmp_path, capsys):
    """``--inspect`` of a merged decoder names its flag input in both
    packages' CLI."""
    from birdnet_tpu.cli import main as jmain
    from birdnet_tpu_torch.cli import main as tmain

    path = tmp_path / "merged.onnx"
    path.write_bytes(P.encode_model(_merged_decoder_like()))
    for main in (tmain, jmain):
        assert main(["--inspect", "-m", str(path)]) == 0
        assert "  dispatch: use_cache_branch (merged-decoder flag input(s)" in \
            capsys.readouterr().out


# -- tests/test_onnx_functions.py --------------------------------------------


def _dual_functions_run(m, feeds):
    return dual_run(P.encode_model(m), list(feeds), optimize=True)


@pytest.mark.parametrize("case", [
    "test_call_site_attr_and_default_resolution", "test_two_calls_do_not_collide",
    "test_nested_function_calls", "test_function_call_inside_if_subgraph",
    "test_default_domain_function_never_shadows_builtin",
    "test_default_domain_function_with_unknown_name_expands",
])
def test_functions_case_through_the_port(case, monkeypatch):
    monkeypatch.setattr(function_cases, "_run", _dual_functions_run)
    getattr(function_cases, case)()


def test_function_roundtrip_through_the_port_codec():
    """A model with functions written by the JAX codec decodes in the
    port's (a copy of the same codec) with every field."""
    from birdnet_tpu_torch.onnx import proto as TP

    f = function_cases._affine_fn()
    m = function_cases._model([P.make_node("Affine", ["x"], ["y"])], [("x", (2,))], ["y"], [f])
    (f2,) = TP.decode_model(P.encode_model(m)).functions
    assert (f2.name, f2.domain, f2.input, f2.output) == ("Affine", "custom", ["x"], ["y"])
    assert f2.attribute == ["alpha", "beta"]
    assert [n.op_type for n in f2.node] == ["Constant", "Constant", "Mul", "Add"]
    assert f2.node[0].attribute[0].ref_attr_name == "alpha"


def test_recursive_function_rejected():
    self_call = P.make_node("Rec", ["x"], ["y"])
    self_call.domain = "custom"
    rec = P.FunctionProto(name="Rec", domain="custom", input=["x"], output=["y"],
                          node=[self_call])
    call = P.make_node("Rec", ["x"], ["y"])
    call.domain = "custom"
    with pytest.raises(ModelLoadError, match="converge|recursive"):
        import_onnx(P.encode_model(function_cases._model([call], [("x", (2,))], ["y"], [rec])))


def test_subgraph_inside_function_body_renames_captures():
    then_g = P.GraphProto(name="then", node=[P.make_node("Identity", ["t"], ["o"])],
                          output=[P.make_value_info("o", P.DataType.FLOAT, [])])
    else_g = P.GraphProto(name="else", node=[P.make_node("Neg", ["t"], ["o2"])],
                          output=[P.make_value_info("o2", P.DataType.FLOAT, [])])
    fn = P.FunctionProto(
        name="CondScale", domain="custom", input=["x", "flag"], output=["y"],
        node=[P.make_node("Mul", ["x", "x"], ["t"]),
              P.make_node("If", ["flag"], ["y"], then_branch=then_g, else_branch=else_g)],
    )
    call = P.make_node("CondScale", ["x", "flag"], ["y"])
    call.domain = "custom"
    graph = P.GraphProto(
        name="g",
        node=[P.make_node("Constant", [], ["flag"],
                          value=P.TensorProto.from_numpy(np.array(True), name="flag")), call],
        input=[P.make_value_info("x", P.DataType.FLOAT, [2])],
        output=[P.make_value_info("y", P.DataType.FLOAT, [])],
    )
    m = P.make_model(graph, opset_version=17)
    m.functions.append(fn)
    x = np.array([2.0, -3.0], dtype=np.float32)
    (y,) = dual_run(P.encode_model(m), [x], optimize=True)
    np.testing.assert_allclose(y, x * x)
