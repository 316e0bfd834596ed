"""The port's com.microsoft contrib domain against the JAX package's, part
2: every test function of tests/test_contrib_transformer.py (the
com.microsoft Attention's KV cache, EmbedLayerNormalization,
MultiHeadAttention's forms, RotaryEmbedding, GroupQueryAttention, the UNet
set, MatMulNBits, GatherBlockQuantized, UnfoldTensor, DynamicTimeWarping
and the MHA and GQA fuzz seeds) with its runner ``_run`` swapped for one
that runs the same graph on the same numpy inputs through both packages
(tests/_torch_dual.py): fp32, the port within 1e-4 of each output's
scale, and the test's own oracle on the port's outputs.
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import _torch_contrib_cases as cc  # noqa: E402
import test_contrib_transformer as jct  # noqa: E402
from _torch_dual import dual, jax_cases, run_case, run_port  # noqa: E402

from birdnet_tpu.onnx import proto as P  # noqa: E402


def _dual_run(model_proto, *inputs, n_out=None):
    return dual(P.encode_model(model_proto), list(inputs), jit=True, n_outputs=n_out)


@pytest.mark.parametrize("case,kwargs", jax_cases(jct))
def test_contrib_transformer_case_through_the_port(case, kwargs, monkeypatch):
    monkeypatch.setattr(jct, "_run", _dual_run)
    run_case(jct, case, kwargs)


@pytest.mark.parametrize("precision", ["mixed", "fast"])
@pytest.mark.parametrize("name", ["Attention", "MultiHeadAttention", "GroupQueryAttention",
                                  "MatMulNBits", "FusedMatMul", "GemmFastGelu"])
def test_policies_round_where_jax_rounds(name, precision):
    """Under ``mixed`` the products take bf16 operands and float32 sums, as
    the JAX lowering's ``_mxu_operands`` / ``preferred_element_type`` give
    them: the port within 2^-7 of the JAX package at that policy; ``fast``
    also keeps bf16 activations (bf16 outputs in both)."""
    from _torch_dual import run_jax

    data, ins = cc.CASES[name]()
    got = run_port(data, list(ins.values()), precision=precision)
    want = run_jax(data, list(ins.values()), precision=precision)
    for g, w in zip(got, want):
        assert g.dtype_name == w.dtype_name
        w64 = np.asarray(w, np.float64)
        scale = float(np.abs(w64).max())
        assert float(np.abs(np.asarray(g, np.float64) - w64).max()) <= 2**-7 * scale
