"""Per-node activation diffing between precision policies, on the port.

The port's counterpart of scripts/activation_diff.py, with the same flags
and the same report: the SAME imported graph under fp32 and under another
precision policy (e.g. fast/bf16), node by node, through
``birdnet_tpu_torch``'s interpreter, worst layers first (max |Δ| over the
layer's own scale), then the top-1 agreement of the logits. It runs on the
card (``cuda:0``); ``--cpu`` runs it on the host.

Usage:
  python scripts/torch_activation_diff.py --model m.onnx [--policy fast]
      [--batch 4] [--top 15] [--cpu]
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


from birdnet_tpu_torch.utils.activation_diff import capture_activations  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", required=True)
    ap.add_argument("--policy", default="fast", choices=["mixed", "fast", "bf16"])
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--top", type=int, default=15, help="worst nodes to print")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cpu", action="store_true", help="run on the host, not the card")
    args = ap.parse_args()
    device = "cpu" if args.cpu else None

    from birdnet_tpu_torch.checkpoint import import_any
    from birdnet_tpu_torch.detection import detect_model_type

    imported = import_any(args.model)
    config = detect_model_type(*imported.detection_shapes())
    rng = np.random.default_rng(args.seed)
    x = rng.normal(size=(args.batch, config.sample_count)).astype(np.float32) * 0.2

    print(f"# comparing fp32 vs {args.policy} on {args.model}", file=sys.stderr)
    ref = capture_activations(imported, "fp32", x, device)
    test = capture_activations(imported, args.policy, x, device)

    node_of = {}
    for n in imported.graph.node:
        for o in n.output:
            node_of[o] = n.op_type

    from birdnet_tpu_torch.utils.activation_diff import layer_diffs

    rows = layer_diffs(ref, test, node_of)
    print(f"{'scale_rel':>10} {'max_abs':>10}  {'op':<22} value")
    for rel, absd, name, op in rows[: args.top]:
        print(f"{rel:>10.2e} {absd:>10.2e}  {op:<22} {name}")

    logits_name = imported.output_names[-1]
    if logits_name in ref and logits_name in test:
        a, b = ref[logits_name], test[logits_name]
        top_a = np.argsort(a, axis=-1)[:, ::-1][:, :5]
        top_b = np.argsort(b, axis=-1)[:, ::-1][:, :5]
        agree1 = float((top_a[:, 0] == top_b[:, 0]).mean())
        print(f"\ntop-1 agreement on {logits_name!r}: {agree1 * 100:.1f}%")
    return 0


if __name__ == "__main__":
    sys.exit(main())
