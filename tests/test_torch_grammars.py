"""tests/_torch_grammars.py, the JAX-free copy of the random-architecture
grammars that the port's hunt and fuzz draw from, against the originals in
tests/test_random_torch_graphs.py: at seed 0 of each grammar's seed base,
both make modules whose exported ONNX is the same, byte for byte."""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_grammars as copy  # noqa: E402
import test_random_torch_graphs as original  # noqa: E402
from _torch_export import export_onnx_bytes  # noqa: E402

# (grammar, its seed base in tests/test_random_torch_graphs.py)
GRAMMARS = [
    ("_random_conv_net", 1000), ("_random_mlp", 2000), ("_random_conv1d_net", 3000),
    ("_transformer_net", 4000), ("_control_flow_net", 5000), ("_random_index_net", 6000),
    ("_random_shape_net", 7000), ("_random_reduce_net", 8000), ("_random_dtype_net", 9000),
    ("_ast_net", 11000), ("_kv_decode_net", 12000),
]


def _exported(grammar, seed):
    rng = np.random.default_rng(seed)
    torch.manual_seed(seed)
    module, args = grammar(rng)
    module.eval()
    return export_onnx_bytes(module, args)


@pytest.mark.parametrize("name,base", GRAMMARS, ids=[n.strip("_") for n, _ in GRAMMARS])
def test_copied_grammar_exports_the_same_onnx(name, base):
    assert getattr(copy, name) is not getattr(original, name)
    mine = _exported(getattr(copy, name), base)
    theirs = _exported(getattr(original, name), base)
    assert mine == theirs
