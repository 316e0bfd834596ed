"""Randomly composed torch architectures (the grammars of
tests/test_random_torch_graphs.py), exported by libtorch's TorchScript
exporter and run through both packages at fp32: the port on the CPU
against torch eval and against the JAX package's jitted forward, at that
suite's tolerance.

Twenty-one fixed seeds over eleven grammars. ``_control_flow_net``'s five
templates (If, the static for form, the while form, an If inside a for
loop, two carried values) each have the first seed of its base that draws
that template (``pick``): seeds chosen by the template they draw, never by
whether they pass. ``_random_shape_net`` at seeds 25, 40, 46 and 97 draws
a chunk that libtorch writes as SplitToSequence + SequenceAt (the sequence
ops of ops_extended.py).
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import test_random_torch_graphs as grammar  # noqa: E402
from _torch_export import export_onnx_bytes, torch_outputs  # noqa: E402

from birdnet_tpu.compiler.importer import import_onnx as j_import_onnx  # noqa: E402
from birdnet_tpu.compiler.importer import make_forward as j_make_forward  # noqa: E402
from birdnet_tpu_torch.compiler.importer import import_onnx, make_forward, params_to_torch  # noqa: E402

ATOL = grammar.ATOL

# (grammar, its seed base in tests/test_random_torch_graphs.py, seed)
SAMPLES = [
    ("_random_conv_net", 1000, 0), ("_random_conv_net", 1000, 1),
    ("_random_mlp", 2000, 0), ("_random_conv1d_net", 3000, 0),
    ("_transformer_net", 4000, 0), ("_random_index_net", 6000, 0),
    ("_random_index_net", 6000, 1), ("_random_shape_net", 7000, 0),
    ("_random_reduce_net", 8000, 0), ("_random_dtype_net", 9000, 0),
    ("_ast_net", 11000, 0), ("_kv_decode_net", 12000, 0),
    # _control_flow_net: pick 0, 1, 2, 3, 4 in turn.
    ("_control_flow_net", 5000, 2), ("_control_flow_net", 5000, 8),
    ("_control_flow_net", 5000, 4), ("_control_flow_net", 5000, 0),
    ("_control_flow_net", 5000, 12),
    # _random_shape_net drawing SplitToSequence + SequenceAt.
    ("_random_shape_net", 7000, 25), ("_random_shape_net", 7000, 40),
    ("_random_shape_net", 7000, 46), ("_random_shape_net", 7000, 97),
]


@pytest.mark.parametrize("name,base,seed", SAMPLES,
                         ids=[f"{n.strip('_')}-{s}" for n, _, s in SAMPLES])
def test_random_graph_matches_torch_and_jax(name, base, seed):
    rng = np.random.default_rng(base + seed)
    torch.manual_seed(base + seed)
    module, args = getattr(grammar, name)(rng)
    module.eval()
    data = export_onnx_bytes(module, args)

    model = import_onnx(data)
    got = make_forward(model, "fp32", "cpu")(params_to_torch(model.params, "cpu"), *args)
    got = [o.numpy() if isinstance(o, torch.Tensor) else np.asarray(o) for o in got]
    jmodel = j_import_onnx(data)
    jfwd = jax.jit(j_make_forward(jmodel, precision="fp32"))
    ref = [np.asarray(o) for o in jfwd(jmodel.params, *[a.numpy() for a in args])]
    want = torch_outputs(module, args)
    assert len(got) == len(ref) == len(want)
    for g, r, w in zip(got, ref, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, atol=ATOL, rtol=1e-3, err_msg=f"{name} {seed}")
        np.testing.assert_allclose(g, r, atol=ATOL, rtol=1e-3, err_msg=f"{name} {seed}")
