"""The port's ai.onnx.ml domain (birdnet_tpu_torch/compiler/ops_ml.py)
against the JAX package's: every test function of tests/test_ml_ops.py.

Its runner ``_run(..., jit=False)`` is swapped for one that runs the same
graph through both packages (tests/_torch_dual.py): ``jit=False`` against
the JAX package's eager forward, where strings and maps are host values
and the port reads its CPU tensors; ``jit=True`` against the jitted
forward, where a JAX raise on a tracer must be matched by the port on
inputs on a device. Scores within 1e-4 of their scale, labels (integer or
string) equal, maps key by key. The tests that call a lowering themselves
(DictVectorizer, CastMap) reach both packages' lowerings the same way. No
case is taken out.
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import test_ml_ops as ml_cases  # noqa: E402
from _torch_dual import (  # noqa: E402
    graph_runner, jax_cases, lowerings_through_the_port, run_case,
)

from birdnet_tpu.onnx import proto as P  # noqa: E402
from birdnet_tpu_torch.compiler import ops as tops  # noqa: E402

ML = "ai.onnx.ml"
# The cases that call a lowering themselves instead of the runner.
DIRECT = ("test_dict_vectorizer", "test_cast_map_dense_and_sparse")


@pytest.mark.parametrize("case,kwargs", jax_cases(ml_cases))
def test_ml_case_through_the_port(case, kwargs, monkeypatch):
    monkeypatch.setattr(ml_cases, "_run", graph_runner(jit=False, opset=17, ml_opset=3,
                                                       ir_version=8))
    if case in DIRECT:
        lowerings_through_the_port(monkeypatch)
    run_case(ml_cases, case, kwargs)


def _meta(x):
    return torch.from_numpy(np.asarray(x)).to("meta")


def test_string_labels_from_a_card_tensor_raise_unless_unbound():
    """String labels need the argmax on the host: scores on a device raise
    when the label output is bound, and nothing is read when it is not."""
    attrs = {"coefficients": [1.0, -1.0, 0.5, 0.5], "classlabels_strings": ["a", "b"],
             "post_transform": "NONE"}
    fn = tops.get_lowering("LinearClassifier", ML)
    x = _meta(np.zeros((3, 2), np.float32))
    bound = tops.OpContext("LinearClassifier", attrs, out_names=("lab", "s"),
                           device=torch.device("meta"))
    with pytest.raises(NotImplementedError, match="must be a compile-time constant"):
        fn(bound, x)
    unbound = tops.OpContext("LinearClassifier", attrs, out_names=("", "s"),
                             device=torch.device("meta"))
    lab, s = fn(unbound, x)
    assert lab is None and s.shape == (3, 2)


@pytest.mark.parametrize("op_type,attrs", [
    ("ZipMap", {"classlabels_int64s": [0, 1]}),
    ("CategoryMapper", {"cats_int64s": [1, 2], "cats_strings": ["a", "b"]}),
    ("OneHotEncoder", {"cats_int64s": [1, 2], "zeros": 0}),
])
def test_host_only_ml_inputs_on_the_card_raise(op_type, attrs):
    fn = tops.get_lowering(op_type, ML)
    with pytest.raises(NotImplementedError, match="must be a compile-time constant"):
        fn(tops.OpContext(op_type, attrs), _meta(np.zeros((2, 2), np.int64)))


def test_wants_output_reads_the_node_outputs():
    ctx = tops.OpContext("X", {}, out_names=("", "s"))
    assert not ctx.wants_output(0) and ctx.wants_output(1) and not ctx.wants_output(2)
    assert tops.OpContext("X", {}).wants_output(0)


def test_platt_loop_runs_a_fixed_count_and_freezes_converged_rows():
    """The coupling runs max(100, k) sweeps whatever the rows do; a row
    that converged early keeps its value, as the JAX while_loop leaves
    it."""
    from birdnet_tpu.compiler import ops_ml as jml
    from birdnet_tpu_torch.compiler import ops_ml as tml

    rng = np.random.default_rng(0)
    c = 4
    pairs = [(i, j) for i in range(c) for j in range(i + 1, c)]
    r = rng.uniform(0.05, 0.95, size=(64, len(pairs))).astype(np.float32)
    r[:8] = 0.5  # converged at the first check
    got = tml._wu_lin_weng_couple(tops.OpContext("SVMClassifier", {}), torch.from_numpy(r),
                                  pairs, c).numpy()
    want = np.asarray(jml._wu_lin_weng_couple(r, pairs, c))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got[:8], 1.0 / c, rtol=0, atol=1e-6)


def test_classifier_graph_binds_only_scores():
    """A scores-only head (the label output left unbound) runs with string
    labels through the port's import and forward."""
    from birdnet_tpu_torch.compiler.importer import import_onnx, make_forward

    node = P.make_node("LinearClassifier", ["x"], ["", "s"], domain=ML,
                       coefficients=[1.0, -1.0, 0.5, 0.5], classlabels_strings=["a", "b"],
                       post_transform="SOFTMAX")
    graph = P.GraphProto(name="t", node=[node],
                         input=[P.make_value_info("x", P.DataType.FLOAT, [3, 2])],
                         output=[P.make_value_info("s", P.DataType.FLOAT, [])])
    model = P.ModelProto(ir_version=8, producer_name="t", producer_version="0", graph=graph,
                         opset_import=[P.OperatorSetId(domain="", version=17),
                                       P.OperatorSetId(domain=ML, version=3)])
    m = import_onnx(P.encode_model(model), optimize=False)
    (s,) = make_forward(m, "fp32", "cpu")({}, torch.ones(3, 2))
    np.testing.assert_allclose(s.sum(-1).numpy(), 1.0, rtol=1e-6)
