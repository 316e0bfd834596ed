"""The port held to tests/test_compiler_conformance.py.

One case for each of that file's 42 tests:

- the 34 that run a graph through ``run_graph`` (27 directly, the seven
  Resize cases through its ``_resize_graph``) run with that runner swapped
  for ``tests/_torch_dual.py``'s: the JAX package's jitted forward and the
  port on the CPU at fp32, the port within 1e-4 of each output's largest
  magnitude, then the case's own torch or hand-computed oracle on the
  port's outputs (a case that expects an error gets it from the port, and
  the JAX package must raise the same type);
- the six BatchNormalization folding and pruning cases that call the
  import-time passes themselves run with those passes swapped for both
  packages' on the same graph and tensors: the same result, node list,
  initializer names and values, and, where the graph runs, the same
  optimized forward (within 1e-4 of its scale);
- the negative timeout against the port's ``_wait``, and the quantized
  graph's self-containment against the port's ``quantize_model``.
"""

import copy

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import test_compiler_conformance as conf  # noqa: E402
from _torch_dual import dual, dual_run_graph, jax_cases, run_case  # noqa: E402

from birdnet_tpu.compiler import optimize as j_optimize  # noqa: E402
from birdnet_tpu.compiler.importer import import_onnx as j_import_onnx  # noqa: E402
from birdnet_tpu.compiler.importer import make_forward as j_make_forward  # noqa: E402
from birdnet_tpu.compiler import quantize as j_quantize  # noqa: E402
from birdnet_tpu.onnx import proto as JP  # noqa: E402
from birdnet_tpu_torch.compiler import optimize as t_optimize  # noqa: E402
from birdnet_tpu_torch.compiler import quantize as t_quantize  # noqa: E402
from birdnet_tpu_torch.compiler.importer import import_onnx as t_import_onnx  # noqa: E402
from birdnet_tpu_torch.compiler.importer import make_forward as t_make_forward  # noqa: E402
from birdnet_tpu_torch.compiler.importer import params_to_torch  # noqa: E402
from birdnet_tpu_torch.onnx import proto as TP  # noqa: E402
from _torch_threads import torch_threads  # noqa: E402,F401

PARITY = 1e-4
J_QUANTIZE_MODEL = j_quantize.quantize_model

# The cases that call the passes themselves: {case: (module, names of the
# passes it calls)}. Each name is swapped for the dual pass below.
PASSES = {
    "test_fold_batchnorm_still_folds_simple_case": (conf, ("optimize_graph",)),
    "test_orphaned_bn_initializers_pruned": (conf, ("optimize_graph",)),
    "test_prune_keeps_subgraph_references": (conf, ("prune_dead_initializers",)),
    "test_fold_batchnorm_skips_subgraph_referenced_intermediate": (
        j_optimize, ("fold_batchnorm",)),
    "test_usage_counts_include_subgraph_references": (j_optimize, ("_usage_counts",)),
}
DIRECT = (*PASSES, "test_imported_model_params_free_of_bn_tensors",
          "test_negative_timeout_times_out_immediately",
          "test_quantized_graph_proto_is_self_contained")


@pytest.mark.parametrize("case,kwargs", jax_cases(conf, exclude=DIRECT))
def test_conformance_case_through_the_port(case, kwargs, monkeypatch):
    monkeypatch.setattr(conf, "run_graph", dual_run_graph)
    run_case(conf, case, kwargs)


# ---------------------------------------------------------------------------
# the import-time passes, both packages on one graph
# ---------------------------------------------------------------------------


def _plain(v):
    """A codec value as plain Python, comparable across the two packages."""
    if hasattr(v, "to_numpy") and hasattr(v, "dims"):
        arr = v.to_numpy()
        return ("tensor", str(arr.dtype), arr.shape, arr.tobytes())
    if hasattr(v, "node") and hasattr(v, "initializer"):
        return ("graph", [_node(n) for n in v.node])
    if isinstance(v, (list, tuple)):
        return [_plain(x) for x in v]
    return v


def _node(n):
    return (n.op_type, n.domain, list(n.input), list(n.output),
            {k: _plain(v) for k, v in sorted(n.attrs.items())})


def _port_graph(graph):
    """The JAX test's graph as the port's codec decodes it."""
    return TP.decode_model(JP.encode_model(JP.make_model(copy.deepcopy(graph)))).graph


def _same_tensors(got, want):
    assert list(got) == list(want)
    for name, arr in want.items():
        assert np.asarray(got[name]).dtype == np.asarray(arr).dtype, name
        np.testing.assert_array_equal(np.asarray(got[name]), np.asarray(arr), err_msg=name)


def _runnable(graph):
    """The graph's inputs (seeded normal values) when it runs as a model:
    every input a float tensor of static shape, no node holding a
    subgraph."""
    if any(isinstance(v, JP.GraphProto) for n in graph.node for v in n.attrs.values()):
        return None
    rng = np.random.default_rng(7)
    inputs = {}
    for vi in graph.input:
        tt = vi.type.tensor_type
        dims = [d.dim_value for d in tt.shape.dim]
        if tt.elem_type != JP.DataType.FLOAT or not dims or min(dims) <= 0:
            return None
        inputs[vi.name] = rng.normal(size=dims).astype(np.float32)
    return inputs


def _forwards_match(graph, tensors):
    """The graph as a model (its initializers from ``tensors``) through both
    packages' importers with the passes on, the port within PARITY."""
    inputs = _runnable(graph)
    if inputs is None:
        return False
    g = copy.deepcopy(graph)
    g.initializer = [JP.TensorProto.from_numpy(np.asarray(v), name=k)
                     for k, v in tensors.items()]
    dual(JP.encode_model(JP.make_model(g)), list(inputs.values()), jit=True, optimize=True)
    return True


def _dual_pass(name):
    """Pass ``name`` of both packages on one graph and its tensors: the
    JAX one rewrites the test's own objects, the port's rewrites the same
    graph decoded by its codec and a copy of the tensors; the results, the
    node lists and the tensors must be equal. Returns the JAX result, on
    which the test's own assertions then run."""
    j_fn, t_fn = getattr(j_optimize, name), getattr(t_optimize, name)
    ran = []

    def both(graph, *args):
        before = (copy.deepcopy(graph), {k: np.array(v) for k, v in args[0].items()}
                  if args else None)
        t_graph = _port_graph(graph)
        t_args = [{k: np.array(v) for k, v in a.items()} for a in args]
        got = t_fn(t_graph, *t_args)
        want = j_fn(graph, *args)
        assert got == want
        assert [_node(n) for n in t_graph.node] == [_node(n) for n in graph.node]
        for t_a, j_a in zip(t_args, args):
            _same_tensors(t_a, j_a)
        ran.append(before)
        return want

    both.ran = ran
    return both


@pytest.mark.parametrize("case", list(PASSES))
def test_batchnorm_pass_case_in_both_packages(case, monkeypatch):
    module, names = PASSES[case]
    swapped = {name: _dual_pass(name) for name in names}
    for name, fn in swapped.items():
        monkeypatch.setattr(module, name, fn)
    run_case(conf, case, {})
    ran = [r for fn in swapped.values() for r in fn.ran]
    assert ran, f"{case} called none of {names}"
    forwards = [_forwards_match(g, t) for g, t in ran if t is not None]
    if case in ("test_fold_batchnorm_still_folds_simple_case",
                "test_orphaned_bn_initializers_pruned"):
        assert forwards == [True]


def test_imported_model_params_free_of_bn_tensors(monkeypatch):
    """The JAX case with its importer and forward swapped for both
    packages': the same params and constants after folding, and the port's
    forward (within PARITY of the JAX one) against torch's BatchNorm."""

    def import_both(data, optimize=True):
        data = data if isinstance(data, bytes) else JP.encode_model(data)
        j_model = j_import_onnx(data, optimize=optimize)
        t_model = t_import_onnx(data, optimize=optimize)
        _same_tensors(t_model.params, j_model.params)
        _same_tensors(t_model.consts, j_model.consts)
        return j_model, t_model

    def forward_both(models, precision="fp32"):
        j_model, t_model = models
        j_fwd = jax.jit(j_make_forward(j_model, precision))
        t_fwd = t_make_forward(t_model, precision, "cpu")

        def run(_params, x):
            (want,) = j_fwd(j_model.params, x)
            (got,) = t_fwd(params_to_torch(t_model.params, "cpu"), torch.from_numpy(x))
            got = got.numpy()
            scale = float(np.abs(np.asarray(want)).max())
            assert np.abs(got - np.asarray(want)).max() <= PARITY * scale
            return (got,)

        return run

    class _Both(tuple):
        """(JAX model, port model) with the port's params and consts, the
        names the case reads."""

        @property
        def params(self):
            return self[1].params

        @property
        def consts(self):
            return self[1].consts

    monkeypatch.setattr(conf, "import_onnx", lambda d, optimize=True: _Both(import_both(d, optimize)))
    monkeypatch.setattr(conf, "make_forward", forward_both)
    run_case(conf, "test_imported_model_params_free_of_bn_tensors", {})


# ---------------------------------------------------------------------------
# the engine's wait and the quantizer
# ---------------------------------------------------------------------------


def test_negative_timeout_times_out_immediately():
    """A remaining budget gone negative times out at once in the port's
    ``_wait``, with work on the device pending or not, as in the JAX
    package's (whose case runs too)."""
    from birdnet_tpu_torch.compiler.engine import _wait
    from birdnet_tpu_torch.errors import InferenceTimeoutError
    from birdnet_tpu_torch.inference_options import InferenceOptions

    run_case(conf, "test_negative_timeout_times_out_immediately", {})

    class _Pending:
        def query(self):
            return False

        def synchronize(self):
            raise AssertionError("a negative budget must not block")

    opts = InferenceOptions.with_timeout(-0.01)
    assert opts.needs_monitor()
    for done in (None, _Pending()):
        with pytest.raises(InferenceTimeoutError) as info:
            _wait(done, opts)
        assert info.value.duration == -0.01


def test_quantized_graph_proto_is_self_contained(monkeypatch):
    """The JAX case with ``quantize_model`` and the importer swapped for the
    port's: every tensor a node of the port's quantized graph references
    is an initializer, a graph input or a node's output; the JAX package's
    quantized graph (same file, same calibration) has the same node list."""
    quantized = {}

    def port_quantize(model, calibration, **kwargs):
        calibration = list(calibration)
        quantized["port"] = t_quantize.quantize_model(model, calibration, device="cpu",
                                                      **kwargs)
        quantized["jax"] = J_QUANTIZE_MODEL(
            j_import_onnx(quantized["data"]), calibration, **kwargs)
        return quantized["port"]

    def port_import(data, optimize=True):
        quantized["data"] = (data if isinstance(data, bytes)
                             else JP.encode_model(data))
        return t_import_onnx(quantized["data"], optimize=optimize)

    monkeypatch.setattr(conf, "import_onnx", port_import)
    monkeypatch.setattr(j_quantize, "quantize_model", port_quantize)
    run_case(conf, "test_quantized_graph_proto_is_self_contained", {})
    ops = lambda m: [(n.op_type, list(n.input), list(n.output)) for n in m.graph.node]
    assert ops(quantized["port"]) == ops(quantized["jax"])
    assert any(n.op_type == "QLinearMatMul" for n in quantized["port"].graph.node)
