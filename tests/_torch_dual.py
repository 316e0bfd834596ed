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
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from _torch_core_common import assert_close, _host
from birdnet_tpu.compiler.importer import import_onnx as j_import_onnx
from birdnet_tpu.compiler.importer import make_forward as j_make_forward
from birdnet_tpu.onnx import proto as P
from birdnet_tpu_torch.compiler.importer import import_onnx as t_import_onnx
from birdnet_tpu_torch.compiler.importer import make_forward as t_make_forward
from birdnet_tpu_torch.compiler.importer import params_to_torch

PARITY = 1e-4


def graph_model(nodes, inputs, initializers=None, outputs=None, opset=17):
    """The model the JAX tests' runners build (float outputs of unknown
    shape)."""
    init = [P.TensorProto.from_numpy(np.asarray(v), name=k)
            for k, v in (initializers or {}).items()]
    in_vis = [P.make_value_info(k, P._NUMPY_TO_DTYPE[np.asarray(v).dtype],
                                list(np.asarray(v).shape)) for k, v in inputs.items()]
    out_vis = [P.make_value_info(n, P.DataType.FLOAT, []) for n in (outputs or ["y"])]
    graph = P.GraphProto(name="t", node=list(nodes), initializer=init, input=in_vis,
                         output=out_vis)
    return P.make_model(graph, opset_version=opset)


def run_jax_jit(data: bytes, inputs, precision="fp32", optimize=False):
    import jax

    model = j_import_onnx(data, optimize=optimize)
    outs = jax.jit(j_make_forward(model, precision))(
        model.params, *[np.asarray(v) for v in inputs])
    return [_host(o) for o in outs]


def run_port_cpu(data: bytes, inputs, precision="fp32", optimize=False):
    model = t_import_onnx(data, optimize=optimize)
    fwd = t_make_forward(model, precision, "cpu")
    outs = fwd(params_to_torch(model.params, "cpu"),
               *[torch.from_numpy(np.array(v)) for v in inputs])
    return [_host(o) for o in outs]


def dual_run(data: bytes, inputs, tol=PARITY, precision="fp32", optimize=False):
    """The port's outputs as numpy, after holding them to the JAX
    package's jitted forward."""
    try:
        got = run_port_cpu(data, inputs, precision, optimize)
    except Exception as e:
        with pytest.raises(type(e)):
            run_jax_jit(data, inputs, precision, optimize)
        raise
    want = run_jax_jit(data, inputs, precision, optimize)
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
