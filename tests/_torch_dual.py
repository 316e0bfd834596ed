"""Run the JAX package's op tests through the port too.

The JAX package's tests build each graph with its codec and run it through
a module-level runner (``run_graph`` of tests/test_compiler_ops.py,
``_jit_run`` of tests/test_control_flow_dynamic.py, ``_run`` of
tests/test_legacy_opset.py). ``through_the_port`` swaps that runner for one
that runs the same graph on the same numpy inputs through the JAX package's
jitted forward and through the port on the CPU, holds the port's outputs to
the JAX package's at ``PARITY`` of each output's largest magnitude (fp32;
ROADMAP's parity rule) and hands the port's outputs to the test, whose own
oracle (torch or numpy) then checks them.

When the port raises, the JAX package must raise the same exception type,
and the port's exception reaches the test.

Beside the jitted runner there is an eager one (``jit=False``): the JAX
package's forward called on numpy inputs, where every value is concrete, as
tests/test_ml_ops.py's ``_run(jit=False)`` and tests/test_compiler_ops.py's
``run_graph`` run it; the port then gets numeric inputs as CPU tensors
(which a lowering may read) and strings and maps as they are. Under
``jax.jit`` a graph input is a tracer; where that makes the JAX package
raise, the port must raise the same type on inputs on a device, which a
meta-device tensor stands for here.

Outputs compare by kind: tensors at ``PARITY`` of their scale, sequences
element by element, ``None`` to ``None``, maps key by key, string and
object arrays for equality.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from _torch_core_common import _host, assert_close, kind
from birdnet_tpu.compiler import ops as j_ops
from birdnet_tpu.compiler.importer import import_onnx as j_import_onnx
from birdnet_tpu.compiler.importer import make_forward as j_make_forward
from birdnet_tpu.onnx import proto as P
from birdnet_tpu_torch.compiler import ops as t_ops
from birdnet_tpu_torch.compiler.importer import import_onnx as t_import_onnx
from birdnet_tpu_torch.compiler.importer import make_forward as t_make_forward
from birdnet_tpu_torch.compiler.importer import params_to_torch

PARITY = 1e-4
ML = "ai.onnx.ml"
_J_GET_LOWERING, _J_OP_CONTEXT = j_ops.get_lowering, j_ops.OpContext


def value_dtype(v):
    arr = np.asarray(v)
    if arr.dtype.kind in ("U", "S", "O"):
        return P.DataType.STRING
    return P._NUMPY_TO_DTYPE[arr.dtype]


def graph_model(nodes, inputs, initializers=None, outputs=None, opset=17,
                ml_opset=None, ir_version=None):
    """The model the JAX tests' runners build: float outputs of unknown
    shape, strings allowed among the inputs, an ``ai.onnx.ml`` opset import
    when ``ml_opset`` is given."""
    init = [P.TensorProto.from_numpy(np.asarray(v), name=k)
            for k, v in (initializers or {}).items()]
    in_vis = [P.make_value_info(k, value_dtype(v), list(np.asarray(v).shape))
              for k, v in inputs.items()]
    out_vis = [P.make_value_info(n, P.DataType.FLOAT, []) for n in (outputs or ["y"])]
    graph = P.GraphProto(name="t", node=list(nodes), initializer=init, input=in_vis,
                         output=out_vis)
    if ml_opset is None and ir_version is None:
        return P.make_model(graph, opset_version=opset)
    imports = [P.OperatorSetId(domain="", version=opset)]
    if ml_opset is not None:
        imports.append(P.OperatorSetId(domain=ML, version=ml_opset))
    return P.ModelProto(ir_version=ir_version or 8, producer_name="t",
                        producer_version="0", graph=graph, opset_import=imports)


def _port_input(v, device):
    """A graph input as the port takes it: numeric arrays as tensors on
    ``device``, strings and maps as they are."""
    arr = np.asarray(v) if not isinstance(v, (list, dict)) else None
    if arr is not None and arr.dtype.kind in "biuf":
        return torch.from_numpy(np.array(arr)).to(device)
    return v


def _out(o):
    """An output as numpy (``_host``), or a sequence, map, absent optional
    or string array as it is."""
    if o is None or isinstance(o, dict):
        return o
    if isinstance(o, list):
        return [_out(e) for e in o]
    if isinstance(o, np.ndarray) and o.dtype.kind in ("U", "S", "O"):
        return o
    return _host(o)


def _plain(o):
    if isinstance(o, list):
        return [_plain(e) for e in o]
    if o is None or isinstance(o, dict) or not isinstance(o, np.ndarray):
        return o
    return np.asarray(o)


def run_jax(data: bytes, inputs, precision="fp32", optimize=False, jit=True):
    """The JAX package's forward, jitted or eager (every value concrete)."""
    import jax

    model = j_import_onnx(data, optimize=optimize)
    fwd = j_make_forward(model, precision)
    if jit:
        fwd = jax.jit(fwd)
    return [_out(o) for o in fwd(model.params, *[np.asarray(v) for v in inputs])]


def run_port(data: bytes, inputs, precision="fp32", optimize=False, device="cpu"):
    model = t_import_onnx(data, optimize=optimize)
    fwd = t_make_forward(model, precision, device)
    outs = fwd(params_to_torch(model.params, device),
               *[_port_input(v, device) for v in inputs])
    return [_out(o) for o in outs]


def dual_run(data: bytes, inputs, tol=PARITY, precision="fp32", optimize=False):
    """The port's outputs as numpy, after holding them to the JAX
    package's jitted forward."""
    try:
        got = run_port(data, inputs, precision, optimize)
    except Exception as e:
        with pytest.raises(type(e)):
            run_jax(data, inputs, precision, optimize)
        raise
    want = run_jax(data, inputs, precision, optimize)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert_close(g, w, tol, f"output {i}")
    return [np.asarray(g) for g in got]


def dual_run_graph(nodes, inputs, initializers=None, outputs=None, opset=17,
                   optimize=False):
    """``run_graph``/``_jit_run``'s signature, through both packages."""
    data = P.encode_model(graph_model(nodes, inputs, initializers, outputs, opset))
    return dual_run(data, list(inputs.values()), optimize=optimize)


def dual_run_model(model, *inputs):
    """``_run(model, *inputs)`` of tests/test_legacy_opset.py."""
    return dual_run(P.encode_model(model), inputs, optimize=True)


def through_the_port(monkeypatch, module, runner_name: str, runner, case: str, **kwargs):
    """Run ``module.case(**kwargs)`` with its runner swapped for ``runner``."""
    monkeypatch.setattr(module, runner_name, runner)
    getattr(module, case)(**kwargs)


# ---------------------------------------------------------------------------
# eager runs, host values, and outputs of any kind
# ---------------------------------------------------------------------------


def compare(got, want, tol=PARITY, what="output"):
    """Hold one port output to the JAX package's, by kind."""
    if want is None or got is None:
        assert got is None and want is None, f"{what}: {got!r} against {want!r}"
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), f"{what}: sequence"
        for i, (g, w) in enumerate(zip(got, want)):
            compare(g, w, tol, f"{what}[{i}]")
    elif isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), f"{what}: map keys"
        g = np.asarray(list(got.values()), np.float64)
        w = np.asarray(list(want.values()), np.float64)
        scale = max(float(np.abs(w).max()) if w.size else 0.0, 1e-30)
        np.testing.assert_allclose(g, w, rtol=0, atol=tol * scale, err_msg=what)
    elif np.asarray(want).dtype.kind in ("U", "S", "O"):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want), err_msg=what)
    else:
        assert_close(got, want, tol, what)


def dual(data, inputs, jit, tol=PARITY, optimize=False, n_outputs=None):
    """The port's outputs, after holding them to the JAX package's forward,
    jitted or eager (see the module's docstring)."""
    if jit:
        try:
            want = run_jax(data, inputs, optimize=optimize)
        except Exception as e:
            # A tracer in JAX: a tensor on a device in the port.
            with pytest.raises(type(e)) as info:
                run_port(data, inputs, optimize=optimize, device="meta")
            raise info.value
        got = run_port(data, inputs, optimize=optimize)
    else:
        try:
            got = run_port(data, inputs, optimize=optimize)
        except Exception as e:
            with pytest.raises(type(e)):
                run_jax(data, inputs, optimize=optimize, jit=False)
            raise
        want = run_jax(data, inputs, optimize=optimize, jit=False)
    assert len(got) == len(want)
    n = len(got) if n_outputs is None else n_outputs
    for i, (g, w) in enumerate(zip(got[:n], want[:n])):
        compare(g, w, tol, f"output {i}")
    return [_plain(g) for g in got[:n]]


def port_only(data, inputs, optimize=False):
    """The port's outputs where their values cannot match the JAX
    package's (the random ops: torch's bits, not jax.random's): the JAX
    package runs the same graph eagerly, and the outputs agree in number,
    shape and dtype class only."""
    got = run_port(data, inputs, optimize=optimize)
    want = run_jax(data, inputs, optimize=optimize, jit=False)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert np.shape(g) == np.shape(w)
        assert kind(g.dtype_name) == kind(w.dtype_name)
    return [_plain(g) for g in got]


def graph_runner(jit, opset, ml_opset=None, ir_version=None, optimize=False,
                 values=dual):
    """A runner with the signature of the JAX tests' graph runners
    (``run_graph``, ``jit_run``, ``_run``), through both packages."""

    def run(nodes, inputs, initializers=None, outputs=None, opset=opset,
            optimize=optimize, jit=jit):
        outs = tuple(outputs) if outputs else ("y",)
        model = graph_model(nodes, inputs, initializers, outs, opset, ml_opset, ir_version)
        data = P.encode_model(model)
        if values is port_only:
            return port_only(data, list(inputs.values()), optimize)
        return dual(data, list(inputs.values()), jit, optimize=optimize)

    return run


class _DualContext:
    """An ``OpContext`` for both packages' lowerings."""

    def __init__(self, op_type, attrs, **kwargs):
        self.op_type, self.attrs, self.kwargs = op_type, attrs, kwargs


def dual_get_lowering(op_type, domain=""):
    """``get_lowering`` for a test that calls a lowering itself: both
    packages' lowerings on the same host arguments, the port's outputs
    held to the JAX package's and returned."""
    j_fn = _J_GET_LOWERING(op_type, domain)
    t_fn = t_ops.get_lowering(op_type, domain)

    def call(ctx, *args):
        got = [_out(o) for o in t_fn(t_ops.OpContext(ctx.op_type, ctx.attrs, **ctx.kwargs),
                                     *args)]
        want = [_out(o) for o in j_fn(_J_OP_CONTEXT(ctx.op_type, ctx.attrs, **ctx.kwargs),
                                      *args)]
        assert len(got) == len(want)
        for i, (g, w) in enumerate(zip(got, want)):
            compare(g, w, PARITY, f"{op_type} output {i}")
        return [_plain(g) for g in got]

    return call


def lowerings_through_the_port(monkeypatch):
    """Route ``from birdnet_tpu.compiler.ops import get_lowering,
    OpContext`` inside a JAX test through both packages."""
    monkeypatch.setattr(j_ops, "get_lowering", dual_get_lowering)
    monkeypatch.setattr(j_ops, "OpContext", _DualContext)


def jax_cases(module, exclude=()):
    """``pytest.param(name, kwargs)`` for every test function of a JAX test
    module (its parametrizations expanded), less ``exclude``."""
    out = []
    for name in sorted(dir(module)):
        fn = getattr(module, name)
        if not name.startswith("test_") or not callable(fn) or name in exclude:
            continue
        combos = [{}]
        for mark in reversed(getattr(fn, "pytestmark", [])):
            if mark.name != "parametrize":
                continue
            argnames, argvalues = mark.args[0], mark.args[1]
            names = ([a.strip() for a in argnames.split(",")]
                     if isinstance(argnames, str) else list(argnames))
            expanded = []
            for c in combos:
                for v in argvalues:
                    vals = v.values if hasattr(v, "values") else (
                        (v,) if len(names) == 1 else tuple(v))
                    expanded.append({**c, **dict(zip(names, vals))})
            combos = expanded
        for c in combos:
            suffix = "-".join(str(v) for v in c.values())
            out.append(pytest.param(name, c, id=f"{name}[{suffix}]" if c else name))
    return out


def run_case(module, name, kwargs):
    """Run one JAX test function with the conftest's ``rng`` fixture."""
    import inspect

    fn = getattr(module, name)
    kwargs = dict(kwargs)
    if "rng" in inspect.signature(fn).parameters:
        kwargs["rng"] = np.random.default_rng(42)
    fn(**kwargs)
