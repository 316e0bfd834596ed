"""The port's op registries against the JAX package's: the core table
(all of its names), the (domain, name) table (the ai.onnx.ml names, with
the ONNX-ML opset-5 table, and the com.microsoft names), the ai.onnx
opset-24 table, and the seven
com.microsoft spellings that fall back to the core table
(``_GRADUATED_MS_OPS``), each as a one-node graph through both packages
on the CPU (tests/_torch_dual.py).
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from _torch_dual import dual  # noqa: E402

from birdnet_tpu.compiler import ops as jops  # noqa: E402
from birdnet_tpu.onnx import proto as P  # noqa: E402
from birdnet_tpu_torch.compiler import ops as tops  # noqa: E402

MS = "com.microsoft"


def test_core_table_is_the_jax_core_table():
    assert tops.supported_ops() == jops.supported_ops()
    assert len(tops.supported_ops()) == 204


def test_ml_names_are_the_jax_ml_names_and_the_opset_5_table():
    from _onnx_spec_table import SPEC_AI_ONNX_ML_OPSET5

    ml = [n for n in jops.supported_contrib_ops() if n.startswith("ai.onnx.ml.")]
    assert [n for n in tops.supported_contrib_ops() if n.startswith("ai.onnx.ml.")] == ml
    assert len(ml) == 19
    assert {n.removeprefix("ai.onnx.ml.") for n in ml} == set(SPEC_AI_ONNX_ML_OPSET5)


def test_contrib_table_is_the_jax_contrib_table():
    """The whole (domain, name) table: the 19 ai.onnx.ml names and the 44
    com.microsoft names of the JAX package's ops_contrib.py."""
    assert tops.supported_contrib_ops() == jops.supported_contrib_ops()
    assert len([n for n in tops.supported_contrib_ops() if n.startswith(f"{MS}.")]) == 44


def test_core_names_cover_the_opset_24_table():
    from _onnx_spec_table import SPEC_AI_ONNX_OPSET24

    assert set(SPEC_AI_ONNX_OPSET24) <= set(tops.supported_ops())


def test_graduated_spellings_are_the_jax_set():
    assert tops._GRADUATED_MS_OPS == jops._GRADUATED_MS_OPS
    # None of them is in the JAX contrib table: both packages serve them
    # from the core table.
    assert not {f"{MS}.{n}" for n in tops._GRADUATED_MS_OPS} & set(jops.supported_contrib_ops())


_RNG = np.random.default_rng(11)
X = _RNG.normal(size=(2, 3, 4, 5)).astype(np.float32)
GRADUATED = {
    "Gelu": ({}, {"x": X}, {}),
    "LayerNormalization": ({"axis": -1, "epsilon": 1e-5}, {"x": X},
                           {"s": _RNG.normal(size=5).astype(np.float32),
                            "b": _RNG.normal(size=5).astype(np.float32)}),
    "Trilu": ({"upper": 0}, {"x": X[0, 0]}, {}),
    "Range": ({}, {}, {"a": np.asarray(1.5, np.float32), "l": np.asarray(9.0, np.float32),
                       "d": np.asarray(2.0, np.float32)}),
    "GridSample": ({"mode": "bilinear", "align_corners": 1}, {"x": X},
                   {"g": _RNG.uniform(-1.1, 1.1, size=(2, 3, 3, 2)).astype(np.float32)}),
    "QuantizeLinear": ({}, {"x": X},
                       {"s": np.asarray(0.02, np.float32), "z": np.asarray(3, np.int8)}),
    "DequantizeLinear": ({}, {"x": _RNG.integers(-128, 127, size=(3, 4)).astype(np.int8)},
                         {"s": np.asarray(0.05, np.float32), "z": np.asarray(-2, np.int8)}),
}


@pytest.mark.parametrize("op_type", sorted(GRADUATED))
def test_graduated_com_microsoft_spelling_matches_jax(op_type):
    attrs, inputs, inits = GRADUATED[op_type]
    node = P.make_node(op_type, list(inputs) + list(inits), ["y"], domain=MS, **attrs)
    init = [P.TensorProto.from_numpy(v, name=k) for k, v in inits.items()]
    in_vis = [P.make_value_info(k, P._NUMPY_TO_DTYPE[v.dtype], list(v.shape))
              for k, v in inputs.items()]
    graph = P.GraphProto(name="t", node=[node], initializer=init, input=in_vis,
                         output=[P.make_value_info("y", P.DataType.FLOAT, [])])
    model = P.ModelProto(ir_version=8, producer_name="t", producer_version="0", graph=graph,
                         opset_import=[P.OperatorSetId(domain="", version=17),
                                       P.OperatorSetId(domain=MS, version=1)])
    (y,) = dual(P.encode_model(model), list(inputs.values()), jit=False)
    assert np.size(y) > 0


def test_other_com_microsoft_names_do_not_fall_back():
    """A contrib op whose core namesake has another contract is not served
    from the core table: com.microsoft Attention takes its contrib lowering
    (packed-QKV self-attention), and com.microsoft Unique, which neither
    package lowers, raises."""
    assert tops.get_lowering("Attention", MS) is tops._CONTRIB_REGISTRY[(MS, "Attention")]
    assert tops.get_lowering("Attention", MS) is not tops.get_lowering("Attention")
    with pytest.raises(NotImplementedError, match=f"'{MS}.Unique'"):
        tops.get_lowering("Unique", MS)
