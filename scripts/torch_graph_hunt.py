"""Differential bug hunt of the port: sweep many random torch-exported
architectures through birdnet_tpu_torch at fp32.

The counterpart of scripts/graph_hunt.py, without JAX: the same thirteen
kinds (tests/_torch_grammars.py: the eleven grammars of
tests/test_random_torch_graphs.py plus the hunt's rich CNN and recurrent
grammars), the same seeds (10_000 + seed), the same export opset drawn per
sample from (9, 11, 13, 17) unless ``--opset`` pins it, and the same
oracle: the torch module in eval mode at fp32, within atol 5e-4 / rtol
1e-3. On a card (``--device cuda``) TF32 is off, and the card's outputs are
also held to the port's on the host at the same tolerance.

    python scripts/torch_graph_hunt.py [--start 0] [--count 100]
        [--kind all] [--opset N] [--device cpu|cuda]

A failure prints its kind, seed and opset; ``python scripts/graph_hunt.py
--start S --count 1 --kind K`` (with the same ``--opset``) runs that
sample through the JAX package. Exits 1 if any sample failed.
"""

from __future__ import annotations

import argparse
import os
import sys
import traceback

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)
sys.path.insert(0, os.path.join(_REPO, "tests"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn as nn  # noqa: E402

from _torch_export import export_onnx_bytes, torch_outputs  # noqa: E402
from _torch_grammars import KINDS  # noqa: E402

from birdnet_tpu_torch.compiler.importer import (  # noqa: E402
    import_onnx,
    make_forward,
    params_to_torch,
)

ATOL, RTOL = 5e-4, 1e-3
SEED_BASE = 10_000
FAILURES = ("import-fail", "parity-fail", "card-fail")


def sample(kind: str, seed: int, opset=None):
    """``(module, args, onnx bytes, opset)`` of one sample, drawn as
    scripts/graph_hunt.py's ``run_one`` draws it; or a label string when the
    sample is shape-invalid (``invalid``) or cannot be exported
    (``export-refused@N``)."""
    rng = np.random.default_rng(seed)
    torch.manual_seed(seed)
    module, args = KINDS[kind](rng)
    module.eval()
    try:
        with torch.no_grad():
            module(*args)  # reject shape-invalid samples before export
    except Exception:  # noqa: BLE001 - the grammar drew an invalid sample
        return "invalid"
    pinned = opset is not None
    if opset is None:
        opset = int(rng.choice([9, 11, 13, 17]))
    if opset == 9 and not pinned and any(
            isinstance(m, nn.Upsample) and m.mode != "nearest" for m in module.modules()):
        # Opset-9 Upsample is specified asymmetric while torch eager is
        # half_pixel, and torch exports it anyway: the oracle itself
        # departs from the file (graph_hunt.py re-pins these to 11).
        opset = 11
    try:
        data = export_onnx_bytes(module, args, opset_version=opset)
    except Exception:  # noqa: BLE001 - the exporter refused this opset
        if pinned or opset == 17:
            return f"export-refused@{opset}"
        try:
            opset = 17
            data = export_onnx_bytes(module, args, opset_version=opset)
        except Exception:  # noqa: BLE001
            return "export-refused@17"
    return module, args, data, opset


def port_outputs(data: bytes, args, device) -> list:
    """The port's fp32 forward of ``data`` on ``device``, as numpy."""
    model = import_onnx(data)
    device = torch.device(device)
    fwd = make_forward(model, "fp32", device)
    with torch.inference_mode():
        outs = fwd(params_to_torch(model.params, device), *[a.to(device) for a in args])
    return [o.cpu().numpy() if isinstance(o, torch.Tensor) else np.asarray(o) for o in outs]


def _disagree(got: list, want: list):
    """The largest |Δ| of the first pair outside the tolerance (or inf for
    a count or shape mismatch), None when all agree."""
    if len(got) != len(want):
        return float("inf")
    for g, w in zip(got, want):
        if g.shape != w.shape:
            return float("inf")
        if not np.allclose(g, w, atol=ATOL, rtol=RTOL, equal_nan=True):
            return float(np.abs(g.astype(np.float64) - w.astype(np.float64)).max())
    return None


def run_one(kind: str, seed: int, opset=None, device="cpu") -> str:
    """One sample through the port: ``ok``, ``invalid``,
    ``export-refused@N`` or one of :data:`FAILURES` (printed with its
    kind, seed and opset)."""
    drawn = sample(kind, seed, opset)
    if isinstance(drawn, str):
        return drawn
    module, args, data, opset = drawn
    where = f"kind={kind} seed={seed} opset={opset}"
    try:
        got = port_outputs(data, args, device)
        host = port_outputs(data, args, "cpu") if torch.device(device).type != "cpu" else got
    except Exception as e:  # noqa: BLE001 - a hunt reports every failure
        print(f"\nIMPORT/RUN FAILURE {where}: {type(e).__name__}: {e}")
        traceback.print_exc()
        print(module)
        return "import-fail"
    d = _disagree(got, torch_outputs(module, args))
    if d is not None:
        print(f"\nPARITY FAILURE {where} device={device} max_diff={d:.3e}")
        print(module)
        return "parity-fail"
    d = _disagree(got, host)
    if d is not None:
        print(f"\nCARD FAILURE {where} (card against host) max_diff={d:.3e}")
        return "card-fail"
    return "ok"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--start", type=int, default=0)
    ap.add_argument("--count", type=int, default=100)
    ap.add_argument("--kind", default="all", choices=["all"] + list(KINDS))
    ap.add_argument("--opset", type=int, default=None,
                    help="pin the export opset (default: random per sample)")
    ap.add_argument("--device", default="cpu", help="cpu (default) or cuda[:N]")
    args = ap.parse_args()
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("torch_graph_hunt: --device cuda but torch.cuda.is_available() is false")

    kinds = list(KINDS) if args.kind == "all" else [args.kind]
    tally = {}
    for seed in range(args.start, args.start + args.count):
        for kind in kinds:
            res = run_one(kind, SEED_BASE + seed, opset=args.opset, device=args.device)
            tally[res] = tally.get(res, 0) + 1
            sys.stderr.write(".")
            sys.stderr.flush()
    print(f"\ntally: {tally}")
    return 1 if any(tally.get(f) for f in FAILURES) else 0


if __name__ == "__main__":
    raise SystemExit(main())
