"""How many eager calls one forward of the port makes, per file.

    python scripts/torch_eager_calls.py                      # the card, fast
    python scripts/torch_eager_calls.py --device cpu --precision fp32

Builds, from seed 0, the generator's BirdNET v2.4 file (conv form) and the
TF-export-dialect v2.4 file of tests/_tf_dialect_models.py (96 mels), both
with 6522 species, and runs one forward of each at batch 32 (after a warm
one), counting the interpreter's lowering calls (the nodes it runs, fused
bodies included) and the ATen operators they dispatch (a
``TorchDispatchMode``; the CUDA kernels' own launches are not ATen calls).
Both counts depend on the graph and the policy, not on the batch. Prints
one JSON line per file. Without CUDA, pass ``--device cpu``.
"""

import argparse
import json
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tests"))

from birdnet_tpu_torch.compiler import importer  # noqa: E402
from birdnet_tpu_torch.models import birdnet_v24  # noqa: E402
from birdnet_tpu_torch.onnx import proto as P  # noqa: E402


class _CountOps(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops += 1
        return func(*args, **(kwargs or {}))


def count(path: str, device: str, precision: str, batch: int, samples: int) -> dict:
    model = importer.import_onnx(path)
    fwd = importer.make_forward(model, precision, device)
    params = importer.params_to_torch(model.params, device)
    x = torch.from_numpy((np.random.default_rng(0).normal(size=(batch, samples)) * 0.1)
                         .astype(np.float32)).to(device)
    fwd(params, x)
    lowerings = [0]
    real = importer.op_registry.get_lowering

    def counted(op_type, domain=""):
        fn = real(op_type, domain)

        def run(*args):
            lowerings[0] += 1
            return fn(*args)

        return run

    importer.op_registry.get_lowering = counted
    try:
        with _CountOps() as mode:
            fwd(params, x)
    finally:
        importer.op_registry.get_lowering = real
    return {"top_level_nodes": len(model.graph.node), "lowering_calls": lowerings[0],
            "aten_ops": mode.ops}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--precision", default="fast")
    ap.add_argument("--batch", type=int, default=32)
    args = ap.parse_args()
    from _tf_dialect_models import build_tf_dialect_model

    with tempfile.TemporaryDirectory() as tmp:
        files = {"generator_v24_conv": str(Path(tmp) / "gen.onnx"),
                 "tf_v24": str(Path(tmp) / "tf.onnx")}
        P.save_model(birdnet_v24.build_model(seed=0), files["generator_v24_conv"])
        data, _ = build_tf_dialect_model("v24", num_species=birdnet_v24.NUM_SPECIES, seed=0,
                                         n_mels=96)
        Path(files["tf_v24"]).write_bytes(data)
        for name, path in files.items():
            line = {"file": name, "device": args.device, "precision": args.precision,
                    "batch": args.batch,
                    **count(path, args.device, args.precision, args.batch,
                            birdnet_v24.SAMPLE_COUNT)}
            if args.device != "cpu":
                line["card"] = torch.cuda.get_device_name(0)
            print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
