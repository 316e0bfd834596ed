"""Shared harness of tests/test_torch_core_*.py: one ONNX graph (usually
one node) built with the JAX package's codec, serialized, and run on the
same seeded numpy inputs through the JAX package (``import_onnx`` /
``make_forward``, eagerly, as tests/test_compiler_ops.py's ``run_graph``
does) and through the port (``import_onnx`` / ``make_forward`` on the CPU).

Graph inputs reach the port as tensors; initializers become params
(float tensors of 16 elements or more) or host constants (numpy), as the
importers split them, so shapes, axes, pads and ``k`` are host values on
both sides.

Tolerances, of the output's largest magnitude: ``EXACT`` for ops whose
float result is exact or one rounding away, ``TRANSCENDENTAL`` for those
that go through exp/log/sin/erf/sqrt/pow, ``POLICY`` (2^-7, the port's
``mixed`` bound) for the ``mixed``/``fast`` cases. Integer, bool and shape
outputs are equal. The JAX package computes ONNX int64 as int32 (x64 off)
and the port keeps int64, so integer outputs compare by value.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from birdnet_tpu.compiler import import_onnx as j_import_onnx
from birdnet_tpu.compiler import make_forward as j_make_forward
from birdnet_tpu.onnx import proto as P
from birdnet_tpu_torch.compiler.importer import import_onnx as t_import_onnx
from birdnet_tpu_torch.compiler.importer import make_forward as t_make_forward
from birdnet_tpu_torch.compiler.importer import params_to_torch

EXACT = 1e-6
TRANSCENDENTAL = 1e-5
POLICY = 2 ** -7


def rng(seed: int = 0) -> np.random.Generator:
    return np.random.default_rng(seed)


def normal(shape, seed: int = 0, scale: float = 1.0) -> np.ndarray:
    return (rng(seed).normal(size=shape) * scale).astype(np.float32)


def model_bytes(nodes, inputs: Dict[str, np.ndarray], inits: Dict[str, np.ndarray],
                outputs: Sequence[str], opset: int) -> bytes:
    init = [P.TensorProto.from_numpy(np.asarray(v), name=k) for k, v in inits.items()]
    in_vis = [P.make_value_info(k, P._NUMPY_TO_DTYPE[np.asarray(v).dtype],
                                list(np.asarray(v).shape)) for k, v in inputs.items()]
    out_vis = [P.make_value_info(n, P.DataType.FLOAT, []) for n in outputs]
    graph = P.GraphProto(name="t", node=list(nodes), initializer=init, input=in_vis,
                         output=out_vis)
    return P.encode_model(P.make_model(graph, opset_version=opset))


def run_jax(data: bytes, inputs: Dict[str, np.ndarray], precision: str = "fp32") -> List[np.ndarray]:
    model = j_import_onnx(data, optimize=False)
    outs = j_make_forward(model, precision)(model.params, *[np.asarray(v) for v in inputs.values()])
    return [_host(o) for o in outs]


def run_port(data: bytes, inputs: Dict[str, np.ndarray], precision: str = "fp32",
             device: str = "cpu") -> List[np.ndarray]:
    model = t_import_onnx(data, optimize=False)
    fwd = t_make_forward(model, precision, device)
    outs = fwd(params_to_torch(model.params, device),
               *[torch.from_numpy(np.array(v)).to(device) for v in inputs.values()])
    return [_host(o) for o in outs]


def _host(o) -> np.ndarray:
    """An output as numpy; bf16 (either package) as float32 with its dtype
    name kept in ``.dtype_name``."""
    if isinstance(o, torch.Tensor):
        name = str(o.dtype).replace("torch.", "")
        o = o.detach().cpu()
        arr = o.float().numpy() if o.dtype == torch.bfloat16 else o.numpy()
    else:
        arr = np.asarray(o)
        name = str(arr.dtype)
        if name == "bfloat16":
            arr = arr.astype(np.float32)
    return _Named(arr, name)


class _Named(np.ndarray):
    """A numpy array that remembers its producer's dtype name."""

    def __new__(cls, arr, name):
        obj = np.asarray(arr).view(cls)
        obj.dtype_name = name
        return obj

    def __array_finalize__(self, obj):
        self.dtype_name = getattr(obj, "dtype_name", None)


def kind(name: str) -> str:
    """The dtype class both packages must agree on: int32 and int64 are
    one class (the JAX package computes int64 as int32), float32 and
    float64 too (float64 as float32); bf16 and float16 stand alone."""
    if name == "bool":
        return "bool"
    if name.startswith(("int", "uint")):
        return "int"
    if name in ("float32", "float64"):
        return "float"
    return name


def assert_close(got, want, tol: float, what: str = "") -> None:
    got_a, want_a = np.asarray(got), np.asarray(want)
    assert got_a.shape == want_a.shape, f"{what}: shape {got_a.shape} != {want_a.shape}"
    assert kind(got.dtype_name) == kind(want.dtype_name), (
        f"{what}: dtype {got.dtype_name} != {want.dtype_name}")
    if kind(want.dtype_name) in ("int", "bool"):
        np.testing.assert_array_equal(got_a.astype(np.int64), want_a.astype(np.int64),
                                      err_msg=what)
        return
    g, w = got_a.astype(np.float64), want_a.astype(np.float64)
    np.testing.assert_array_equal(np.isnan(g), np.isnan(w), err_msg=what)
    fin = np.isfinite(w)
    np.testing.assert_array_equal(g[~fin & ~np.isnan(w)], w[~fin & ~np.isnan(w)], err_msg=what)
    if fin.any():
        scale = max(float(np.abs(w[fin]).max()), 1e-30)
        err = float(np.abs(g[fin] - w[fin]).max())
        assert err <= tol * scale, f"{what}: max |Δ| {err} > {tol} × {scale}"


def check_graph(nodes, inputs=None, inits=None, outputs=("y",), opset: int = 17,
                tol: float = EXACT, precision: str = "fp32") -> List[np.ndarray]:
    """Run the graph through both packages and hold every output of the
    port to the JAX package's; returns the port's outputs."""
    inputs, inits = dict(inputs or {}), dict(inits or {})
    data = model_bytes(nodes, inputs, inits, outputs, opset)
    want = run_jax(data, inputs, precision)
    got = run_port(data, inputs, precision)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert_close(g, w, tol, f"output {outputs[i]}")
    return got


def check_op(op_type: str, ins: Sequence[str], inputs=None, inits=None, n_out: int = 1,
             opset: int = 17, tol: float = EXACT, precision: str = "fp32", **attrs):
    """One ``op_type`` node over inputs named ``ins`` ("" for an absent
    optional input), each value in ``inputs`` (graph inputs) or ``inits``
    (initializers)."""
    outputs = ["y"] if n_out == 1 else [f"y{i}" for i in range(n_out)]
    node = P.make_node(op_type, list(ins), outputs, **attrs)
    return check_graph([node], inputs, inits, outputs, opset, tol, precision)


def check_after_matmul(op_type: str, precision: str, x_shape, k: int, inits=None,
                       extra_ins=(), tol: float = POLICY, n_out: int = 1, opset: int = 17,
                       **attrs):
    """``op_type`` applied to ``MatMul(x, W)``, so that under ``fast`` its
    input is the policy's bf16 activation and under ``mixed`` float32 sums
    of bf16 operands."""
    x = normal(x_shape, 1)
    w = normal((x_shape[-1], k), 2, scale=x_shape[-1] ** -0.5)
    outputs = ["y"] if n_out == 1 else [f"y{i}" for i in range(n_out)]
    nodes = [P.make_node("MatMul", ["x", "w"], ["h"]),
             P.make_node(op_type, ["h", *extra_ins], outputs, **attrs)]
    return check_graph(nodes, {"x": x}, {"w": w, **(inits or {})}, outputs, opset, tol,
                       precision)
