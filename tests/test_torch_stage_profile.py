"""scripts/torch_stage_profile.py on the tiny v2.4 (fp32, and int8 as
``--int8`` quantizes it) on the CPU: its milestones are the JAX script's
(scripts/stage_profile.py's ``milestones_of`` on the same graph); each
pruned prefix gives its milestone's tensor bit for bit as the whole
forward computes it (utils/activation_diff's ``capture_activations``; the
int8 codes, which it leaves out, from the forward with them as outputs);
and the JAX package's ``interpret_graph`` (jitted) on the same graph and
weights gives each milestone's tensor within 1e-4 of its scale.

At fp32 the JAX package runs the whole prefix. At int8 it runs each stage
from the port's values before it: a code that the two packages' float
sums put on either side of a rounding step flips, and downstream the
flips spread (2 codes of 196,608 after block 0, 3 % of the logits' scale
at the end), so only each stage's own arithmetic is compared. There the
codes are held within one: jitted, XLA turns the requantize's division by
the output scale into a multiply by its reciprocal (ROADMAP C); run
eagerly the JAX package matches them exactly, but takes 20 s. The default
fusions' table keeps the stage prefix as one milestone."""

from __future__ import annotations

import dataclasses
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir, "scripts"))

import stage_profile as jprofile  # noqa: E402
import torch_stage_profile as tprofile  # noqa: E402
from birdnet_tpu.compiler.importer import interpret_graph as j_interpret_graph  # noqa: E402
from birdnet_tpu_torch.compiler.importer import make_forward, params_to_torch  # noqa: E402
from birdnet_tpu_torch.utils.activation_diff import capture_activations  # noqa: E402

TINY = dict(width=0.1, depth=1)
JAX_SCALED_TOL = 1e-4
JAX_CODE_TOL = 1


def _whole_forward(imported, names, x):
    """``names``' tensors as one forward of the whole graph computes them:
    ``capture_activations`` for float tensors, the forward with the rest
    (int8 codes) as its outputs."""
    whole = capture_activations(imported, "fp32", x, "cpu")
    codes = [n for n in names if n not in whole]
    if codes:
        outs = make_forward(dataclasses.replace(imported, output_names=codes), "fp32", "cpu")(
            params_to_torch(imported.params, "cpu"), torch.from_numpy(x))
        whole.update((n, o.numpy()) for n, o in zip(codes, outs))
    return whole


def _jax_values(imported, nodes, names, known: dict) -> list:
    """The JAX package's jitted ``interpret_graph`` of ``nodes`` (of
    ``imported``'s graph) from its weights and the ``known`` values:
    ``names``' tensors, as numpy."""
    graph = dataclasses.replace(imported.graph, node=nodes)
    weights = dict(imported.consts)
    weights.update(imported.params)

    def run(known):
        env = dict(weights)
        env.update(known)
        return j_interpret_graph(graph, imported.opset, "fp32", env, names)

    return [np.asarray(v) for v in jax.jit(run)(known)]


def _agree(got: np.ndarray, want: np.ndarray) -> bool:
    """int8 codes within JAX_CODE_TOL, floats within JAX_SCALED_TOL of the
    tensor's scale."""
    d = np.abs(got.astype(np.float64) - want.astype(np.float64)).max()
    if want.dtype.kind in "iu":
        return bool(d <= JAX_CODE_TOL)
    return bool(d <= JAX_SCALED_TOL * max(float(np.abs(want).max()), 1e-6))


@pytest.fixture(scope="module")
def x():
    return (np.random.default_rng(0).normal(size=(2, 144_000)) * 0.1).astype(np.float32)


@pytest.mark.parametrize("int8", [False, True], ids=["fp32", "int8"])
def test_prefixes_match_the_forward_and_jax(int8, x):
    _, unfused, fused = tprofile.imported_models("v24", int8, "cpu", **TINY)
    assert (fused is None) == int8
    marks = tprofile.milestones_of(unfused.graph)
    assert marks == jprofile.milestones_of(unfused.graph)
    assert [m for m, _ in marks][:3] == ["frontend", "stem", "block00"]
    assert [m for m, _ in marks][-2:] == ["head", "logits"]
    assert marks[-1][1] == unfused.output_names[0]
    # The frontend milestone is the 1-D filterbank conv, not the stem (the
    # int8 graph's frontend stays float, fused again by quantization).
    first = next(n for n in unfused.graph.node if n.output[0] == marks[0][1])
    assert first.op_type == "Conv" and unfused.params[first.input[1]].ndim == 3

    nodes = unfused.graph.node
    names = [t for _, t in marks]
    whole = _whole_forward(unfused, [o for n in nodes for o in n.output if o] if int8 else names,
                           x)
    params = params_to_torch(unfused.params, "cpu")
    for name, tensor in marks:
        got = tprofile.prefix_forward(unfused, tensor, "fp32", params, "cpu")(torch.from_numpy(x))
        np.testing.assert_array_equal(got.numpy(), whole[tensor], err_msg=name)

    source = {unfused.input_names[0]: x}
    if not int8:
        ref = _jax_values(unfused, nodes, names, source)
    else:
        at = {o: i for i, n in enumerate(nodes) for o in n.output if o}
        ref, lo = [], 0
        for tensor in names:
            known = dict(source)
            known.update((o, whole[o]) for n in nodes[:lo] for o in n.output if o)
            ref += _jax_values(unfused, nodes[lo:at[tensor] + 1], [tensor], known)
            lo = at[tensor] + 1
    for (name, tensor), want in zip(marks, ref):
        assert whole[tensor].dtype == want.dtype, name
        assert _agree(whole[tensor], want), name


def test_default_fusions_table(x):
    """The stage prefix (stem and its blocks) is one milestone; every
    prefix equals the fused forward's tensor; the table's shares sum to
    one."""
    _, _, fused = tprofile.imported_models("v24", False, "cpu", **TINY)
    marks = tprofile.fused_milestones_of(fused.graph)
    prefix = next(n for n in fused.graph.node if n.op_type == "_FusedStagePrefix")
    k = len(prefix.attrs["block_outputs"])
    n_mbconv = sum(n.op_type == "_FusedMBConv" for n in fused.graph.node)
    assert [m for m, _ in marks] == (
        ["frontend", f"stem+block00-{k - 1:02d}"]
        + [f"block{b:02d}" for b in range(k, k + n_mbconv)] + ["head", "logits"])
    whole = _whole_forward(fused, [t for _, t in marks], x)
    params = params_to_torch(fused.params, "cpu")
    for name, tensor in marks:
        got = tprofile.prefix_forward(fused, tensor, "fp32", params, "cpu")(torch.from_numpy(x))
        np.testing.assert_array_equal(got.numpy(), whole[tensor], err_msg=name)
    cumulative = tprofile.profile(fused, marks[:3], torch.from_numpy(x[:1]), "fp32", 1, 1)
    rows = tprofile.stage_rows(cumulative, 1)
    assert [r["stage"] for r in rows] == [m for m, _ in marks[:3]]
    assert sum(r["share"] for r in rows) == pytest.approx(1.0)
