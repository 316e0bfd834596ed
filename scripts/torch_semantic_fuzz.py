"""Semantic fuzz of the port: random structural mutations of valid ONNX
graphs through birdnet_tpu_torch.

The counterpart of scripts/semantic_fuzz.py, without JAX. It takes the
same torch-exported graphs (``BASE_KINDS``, from tests/_torch_grammars.py,
at seeds 50_000 + seed), applies the same random semantic mutation (rewired
names, flipped attributes, resized or retyped or removed initializers,
subgraph edits) and runs two phases:

1. validation, as the port's ``Classifier.build`` validates: import, then
   one forward at zero inputs of the example inputs' shapes and dtypes (not
   an abstract trace: the port has none). A mutation either passes or
   raises; a typed ``BirdnetError`` counts as ``typed``, any other
   exception as ``wrapped`` (``build`` wraps it into ``ModelLoadError``);
2. execution of what passed, on the seeded example inputs. Any exception
   there is a validation gap (``raw``): an input-dependent defect that the
   zero-input forward let through.

    python scripts/torch_semantic_fuzz.py [--start 0] [--count 200]

Prints the tally as the JAX script does and each raw error's kind, seed
and mutation; exits 1 if there was any.
"""

from __future__ import annotations

import argparse
import copy
import os
import sys
import traceback

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)
sys.path.insert(0, os.path.join(_REPO, "tests"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from _torch_export import export_onnx_bytes  # noqa: E402
import _torch_grammars as G  # noqa: E402

from birdnet_tpu_torch.compiler.importer import (  # noqa: E402
    import_onnx,
    make_forward,
    params_to_torch,
)
from birdnet_tpu_torch.errors import BirdnetError  # noqa: E402
from birdnet_tpu_torch.onnx import proto as P  # noqa: E402

SEED_BASE = 50_000

BASE_KINDS = {
    "cnn": G._random_conv_net,
    "mlp": G._random_mlp,
    "xfmr": G._transformer_net,
    "idx": G._random_index_net,
    "ctrl": G._control_flow_net,  # Loop/If bodies: subgraph mutations
}


def _all_names(model):
    names = set()
    for n in model.graph.node:
        names.update(i for i in n.input if i)
        names.update(o for o in n.output if o)
    return sorted(names)


def mutate(model, rng):
    """Apply one random semantic mutation in place; returns a label."""
    m = model
    nodes = m.graph.node
    pick = int(rng.integers(0, 12))
    if pick == 0 and nodes:
        n = nodes[int(rng.integers(0, len(nodes)))]
        if n.input:
            i = int(rng.integers(0, len(n.input)))
            n.input[i] = "fuzz_dangling"
            return f"dangling-input:{n.op_type}"
    if pick == 1 and nodes:
        n = nodes[int(rng.integers(0, len(nodes)))]
        if n.output:
            n.output[0] = "fuzz_renamed"
            return f"renamed-output:{n.op_type}"
    if pick == 2 and m.graph.initializer:
        t = m.graph.initializer[int(rng.integers(0, len(m.graph.initializer)))]
        if t.dims:
            d = int(rng.integers(0, len(t.dims)))
            t.dims[d] = int(t.dims[d]) + int(rng.integers(1, 4))
            return "initializer-dims"
    if pick == 3 and nodes:
        n = nodes[int(rng.integers(0, len(nodes)))]
        for a in n.attribute:
            if a.type == 2:  # INT
                a.i = int(rng.integers(-3, 100))
                return f"int-attr:{n.op_type}.{a.name}"
            if a.type == 7 and a.ints:  # INTS
                j = int(rng.integers(0, len(a.ints)))
                a.ints[j] = int(rng.integers(-2, 3))
                return f"ints-attr:{n.op_type}.{a.name}"
    if pick == 4 and nodes:
        n = nodes[int(rng.integers(0, len(nodes)))]
        n.input.append("fuzz_extra")
        return f"extra-input:{n.op_type}"
    if pick == 5 and m.graph.output:
        m.graph.output[0].name = "fuzz_not_produced"
        return "unproduced-output"
    if pick == 6 and nodes:
        n = nodes[int(rng.integers(0, len(nodes)))]
        if len(n.input) > 1:
            n.input.pop()
            return f"dropped-input:{n.op_type}"
    if pick == 7 and nodes:
        a, b = rng.integers(0, len(nodes), size=2)
        if a != b and nodes[int(a)].output and nodes[int(b)].output:
            nodes[int(a)].output[0], nodes[int(b)].output[0] = (
                nodes[int(b)].output[0],
                nodes[int(a)].output[0],
            )
            return "swapped-outputs"
    if pick == 8 and m.graph.initializer:
        t = m.graph.initializer[int(rng.integers(0, len(m.graph.initializer)))]
        t.data_type = int(rng.choice([P.DataType.INT64, P.DataType.BOOL,
                                      P.DataType.FLOAT16]))
        return "retyped-initializer"
    if pick == 9 and m.graph.initializer:
        i = int(rng.integers(0, len(m.graph.initializer)))
        name = m.graph.initializer[i].name
        del m.graph.initializer[i]
        return f"removed-initializer:{name[:20]}"
    if pick == 10 and m.graph.initializer:
        t = m.graph.initializer[int(rng.integers(0, len(m.graph.initializer)))]
        if t.raw_data:
            t.raw_data = t.raw_data[: len(t.raw_data) // 2]
            return "truncated-raw-data"
    if pick == 11:
        subs = []
        for n in nodes:
            for a in n.attribute:
                if a.name in ("body", "then_branch", "else_branch") and a.g:
                    subs.append((n.op_type, a.g))
        if subs:
            op, g = subs[int(rng.integers(0, len(subs)))]
            if g.node:
                bn = g.node[int(rng.integers(0, len(g.node)))]
                if bn.input and rng.random() < 0.5:
                    bn.input[int(rng.integers(0, len(bn.input)))] = "fuzz_sub"
                    return f"subgraph-dangling:{op}"
                if bn.output:
                    bn.output[0] = "fuzz_sub_out"
                    return f"subgraph-renamed:{op}"
    return "noop"


def validate_like_build(data, example_args):
    """What the port's ``Classifier.build`` runs: import, then one forward
    at zero inputs of the examples' shapes and dtypes on the host. Returns
    the forward and its params for the execution phase."""
    imp = import_onnx(data, optimize=True)
    fwd = make_forward(imp, "fp32", "cpu")
    params = params_to_torch(imp.params, "cpu")
    with torch.inference_mode():
        fwd(params, *[torch.zeros_like(a) for a in example_args])
    return fwd, params


def run_one(kind: str, seed: int) -> str:
    """One mutation: ``ok(label)``, ``typed(label)``, ``wrapped(label)``,
    ``RAW:<error>(label)``, ``invalid`` or ``export-refused``."""
    rng = np.random.default_rng(seed)
    torch.manual_seed(seed)
    module, args = BASE_KINDS[kind](rng)
    module.eval()
    try:
        with torch.no_grad():
            module(*args)
    except Exception:  # noqa: BLE001 - the grammar drew an invalid sample
        return "invalid"
    try:
        data = export_onnx_bytes(module, args)
    except Exception:  # noqa: BLE001
        return "export-refused"
    mutated = copy.deepcopy(P.decode_model(data))
    label = mutate(mutated, rng)
    # Phase 1: validation (what build() wraps into ModelLoadError).
    try:
        fwd, params = validate_like_build(P.encode_model(mutated), args)
    except BirdnetError:
        return f"typed({label})"
    except Exception:  # noqa: BLE001 - build() converts it to ModelLoadError
        return f"wrapped({label})"
    # Phase 2: a model that passed validation must execute.
    try:
        with torch.inference_mode():
            fwd(params, *args)
        return f"ok({label})"
    except Exception as e:  # noqa: BLE001 - a validation gap, reported
        print(f"\nVALIDATION GAP kind={kind} seed={seed} mutation={label}: "
              f"{type(e).__name__}: {str(e)[:120]}")
        traceback.print_exc()
        return f"RAW:{type(e).__name__}({label})"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--start", type=int, default=0)
    ap.add_argument("--count", type=int, default=200)
    args = ap.parse_args()
    tally = {"ok": 0, "typed": 0, "raw": 0, "skipped": 0}
    raws = []
    for seed in range(args.start, args.start + args.count):
        for kind in BASE_KINDS:
            res = run_one(kind, SEED_BASE + seed)
            if res.startswith("ok"):
                tally["ok"] += 1
            elif res.startswith("typed"):
                tally["typed"] += 1
            elif res.startswith("wrapped"):
                tally["wrapped"] = tally.get("wrapped", 0) + 1
            elif res.startswith("RAW"):
                tally["raw"] += 1
                raws.append((kind, SEED_BASE + seed, res))
            else:
                tally["skipped"] += 1
            print(".", end="", flush=True)
    print(f"\ntally: {tally}")
    for r in raws:
        print("RAW:", r)
    return 1 if tally["raw"] else 0


if __name__ == "__main__":
    sys.exit(main())
