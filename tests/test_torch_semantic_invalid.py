"""Semantically invalid model files through both packages: the eight
defect classes of tests/test_semantic_invalid.py on the tiny v2.4, built
by each package's ``Classifier.builder()``, and that file's ten random
structural mutations of torch-exported graphs (seeds 90_000-90_009, and
one the wide fuzz found), run
through scripts/semantic_fuzz.py's validation (import + abstract trace) and
scripts/torch_semantic_fuzz.py's (import + a forward at zero inputs).
Per case both packages accept the file, or both reject it with the same
``BirdnetError`` subclass (a raw error during validation counts as the
``ModelLoadError`` that ``build`` wraps it into); a mutation that the port
accepts then runs on its seeded inputs without raising."""

from __future__ import annotations

import copy
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir, "scripts"))

import birdnet_tpu as jbt  # noqa: E402
import birdnet_tpu_torch as tbt  # noqa: E402
import semantic_fuzz as jfuzz  # noqa: E402
import torch_semantic_fuzz as tfuzz  # noqa: E402
from _torch_export import export_onnx_bytes  # noqa: E402
from birdnet_tpu.errors import BirdnetError as JBirdnetError  # noqa: E402
from birdnet_tpu.onnx import proto as JP  # noqa: E402
from birdnet_tpu_torch.errors import BirdnetError as TBirdnetError  # noqa: E402
from birdnet_tpu_torch.onnx import proto as TP  # noqa: E402

N_SPECIES = 7
LABELS = [f"s{i}" for i in range(N_SPECIES)]


@pytest.fixture(scope="module")
def tiny_v24(tmp_path_factory):
    from birdnet_tpu.models import birdnet_v24

    p = tmp_path_factory.mktemp("torch_semantic") / "v24_tiny.onnx"
    birdnet_v24.save_tiny(p, num_species=N_SPECIES)
    return TP.decode_model(p.read_bytes())


def _first_conv(model):
    return next(n for n in model.graph.node if n.op_type == "Conv")


def _set_ints(node, name, value):
    for a in node.attribute:
        if a.name == name:
            a.ints = [value] * len(a.ints)
            return
    node.attribute.append(TP.AttributeProto(name=name, type=7, ints=[value] * 2))


def _set_int(node, name, value):
    for a in node.attribute:
        if a.name == name:
            a.i = value
            return
    node.attribute.append(TP.AttributeProto(name=name, type=2, i=value))


def _dims_plus_three(m):
    m.graph.initializer[0].dims[0] = int(m.graph.initializer[0].dims[0]) + 3


# The eight classes of tests/test_semantic_invalid.py:54-123, each an edit
# of the decoded tiny v2.4 (``baseline`` leaves it whole).
DEFECTS = {
    "baseline": lambda m: None,
    "dangling_node_input": lambda m: _first_conv(m).input.__setitem__(1, "no_such_tensor"),
    "broken_producer_chain": lambda m: _first_conv(m).output.__setitem__(0, "renamed_out"),
    "unproduced_graph_output": lambda m: setattr(m.graph.output[0], "name",
                                                 "not_produced_anywhere"),
    "initializer_dims_mismatch": _dims_plus_three,
    "unknown_op": lambda m: setattr(m.graph.node[-1], "op_type", "NoSuchOp"),
    "zero_conv_strides": lambda m: _set_ints(_first_conv(m), "strides", 0),
    "bad_conv_group": lambda m: _set_int(_first_conv(m), "group", 7),
}


def _outcome(build, error_base) -> str:
    """``"accepted"``, or the name of the BirdnetError subclass the
    package's ``build`` raises (a raw error is wrapped into
    ModelLoadError)."""
    try:
        build()
    except error_base as e:
        return type(e).__name__
    except Exception:  # noqa: BLE001 - build() wraps it
        return "ModelLoadError"
    return "accepted"


@pytest.mark.parametrize("defect", list(DEFECTS))
def test_defect_class_fails_alike(tmp_path, tiny_v24, defect):
    m = copy.deepcopy(tiny_v24)
    DEFECTS[defect](m)
    path = tmp_path / "mutated.onnx"
    path.write_bytes(TP.encode_model(m))

    def build(pkg):
        b = pkg.Classifier.builder().model_path(str(path)).labels(LABELS)
        return (b.with_device("cpu") if pkg is tbt else b).build()

    mine = _outcome(lambda: build(tbt), TBirdnetError)
    theirs = _outcome(lambda: build(jbt), JBirdnetError)
    assert mine == theirs
    assert (mine == "accepted") == (defect == "baseline")


def _mutated(kind: str, seed: int):
    """The fuzz scripts' sample: (mutated file, example inputs, label),
    the copied ``mutate`` held to the JAX script's on the same draw."""
    rng = np.random.default_rng(seed)
    torch.manual_seed(seed)
    module, args = tfuzz.BASE_KINDS[kind](rng)
    module.eval()
    data = export_onnx_bytes(module, args)
    state = rng.bit_generator.state
    mutated = TP.decode_model(data)
    label = tfuzz.mutate(mutated, rng)
    rng.bit_generator.state = state
    jmutated = JP.decode_model(data)
    assert jfuzz.mutate(jmutated, rng) == label
    data = TP.encode_model(mutated)
    assert JP.encode_model(jmutated) == data
    return data, args, label


# tests/test_semantic_invalid.py's ten seeds, then the fuzz's seed 50760
# (scripts/torch_semantic_fuzz.py): two constants swapped, so a ReduceSum
# takes axis -3 on a rank-2 tensor, which the port once reduced as axis -1.
MUTATIONS = ([(list(tfuzz.BASE_KINDS)[s % len(tfuzz.BASE_KINDS)], 90_000 + s) for s in range(10)]
             + [("idx", 50_760)])


@pytest.mark.parametrize("kind,seed", MUTATIONS, ids=[f"{k}-{s}" for k, s in MUTATIONS])
def test_random_mutation_fails_alike(kind, seed):
    data, args, label = _mutated(kind, seed)
    found = {}
    mine = _outcome(lambda: found.update(run=tfuzz.validate_like_build(data, args)),
                    TBirdnetError)
    theirs = _outcome(lambda: jfuzz.validate_like_build(data, [a.numpy() for a in args]),
                      JBirdnetError)
    assert mine == theirs, (kind, label)
    if mine == "accepted":
        fwd, params = found["run"]
        with torch.inference_mode():
            fwd(params, *args)


def test_if_takes_a_float8_condition_by_its_truth():
    """The fuzz's seed 50901 casts an If's condition to float8e5m2fnuz. The
    port takes any numeric condition by its truth, as both packages take a
    float32 one; the JAX package's lax.cond refuses float8 (a deliberate
    difference, ROADMAP C)."""
    data, args, label = _mutated("ctrl", 50_901)
    assert label == "int-attr:Cast.to"
    fwd, params = tfuzz.validate_like_build(data, args)
    with torch.inference_mode():
        assert all(torch.isfinite(o).all() for o in fwd(params, *args))
    with pytest.raises(TypeError, match="float8_e5m2fnuz"):
        jfuzz.validate_like_build(data, [a.numpy() for a in args])
