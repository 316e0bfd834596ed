"""The port's tree ensembles and SVM classifier against recursive oracles:
every test function of tests/test_tree_fuzz.py (random forests against a
recursive walk) and tests/test_svm_platt_fuzz.py (the Platt coupling and
the binary conventions against a transcription of libsvm).

Each runner (``_run_model``, ``_run``) is swapped for one
that runs the same file through both packages (tests/_torch_dual.py), the
port within 1e-4 of each output's scale and its labels equal, and the
test's own oracle then checks the port's outputs. No case is taken out.
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import test_svm_platt_fuzz as svm_cases  # noqa: E402
import test_tree_fuzz as tree_cases  # noqa: E402
from _torch_dual import dual, graph_runner, jax_cases, run_case  # noqa: E402

from birdnet_tpu.onnx import proto as P  # noqa: E402

ML = "ai.onnx.ml"


def _dual_run_model(attrs, x, agg):
    node = P.make_node("TreeEnsembleRegressor", ["x"], ["y"], domain=ML,
                       aggregate_function=agg, **attrs)
    graph = P.GraphProto(
        name="f", node=[node],
        input=[P.make_value_info("x", P.DataType.FLOAT, list(x.shape))],
        output=[P.make_value_info("y", P.DataType.FLOAT, [])],
    )
    model = P.ModelProto(
        ir_version=8, producer_name="t", producer_version="0", graph=graph,
        opset_import=[P.OperatorSetId(domain="", version=17),
                      P.OperatorSetId(domain=ML, version=3)],
    )
    (y,) = dual(P.encode_model(model), [x], jit=True)
    return np.asarray(y)


@pytest.mark.parametrize("case,kwargs", jax_cases(tree_cases))
def test_tree_fuzz_case_through_the_port(case, kwargs, monkeypatch):
    monkeypatch.setattr(tree_cases, "_run_model", _dual_run_model)
    run_case(tree_cases, case, kwargs)


@pytest.mark.parametrize("case,kwargs", jax_cases(svm_cases))
def test_svm_platt_case_through_the_port(case, kwargs, monkeypatch):
    monkeypatch.setattr(svm_cases, "_run", graph_runner(jit=False, opset=17, ml_opset=3,
                                                        ir_version=8))
    run_case(svm_cases, case, kwargs)
