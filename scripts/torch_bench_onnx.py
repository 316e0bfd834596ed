"""Generic ONNX model throughput bench of the PyTorch port: any importable
file, any inputs, on one CUDA card.

The counterpart of scripts/bench_onnx.py, without JAX. It synthesizes
random inputs from the graph's declared shapes (the same rules and, for the
same file and seed, the same arrays as the JAX tool), builds the port's
forward (``import_onnx`` + ``make_forward``) at the chosen precision policy
on the card, and reports inferences/s (each timed run ends with every
output read to the host; stall-filtered median) across a batch sweep.

Each row has two figures. The first is the eager forward, what a per-call
``predict_batch`` runs (``ms_per_batch``, ``inf_s``). The second stands
where the JAX tool's ``jax.jit`` program stood: the forward captured once
into a CUDA graph and replayed (``graph_ms_per_batch``, ``graph_inf_s``).
A forward that reads a value of the card on the host (a count of
``compiler.ops.HOST_READS`` grows during it: a while-form Loop, a
generation op's early stop) cannot be captured, and its graph figures are
null. ``compile_s`` covers the first call and the capture.

Usage:
  python scripts/torch_bench_onnx.py --model m.onnx [--batches 1,8,32,128]
      [--precision fast] [--runs 5] [--batch-size N] [--json]
      [--provider auto|cuda|cpu]

Symbolic leading dims are treated as the batch axis and swept; all other
symbolic dims must be static in the file (re-export with fixed shapes).
Without a card it raises, unless ``--provider cpu`` asks for the host
(where the numbers are host times, for tests, not device figures).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _stall_filter(dts):
    """Drop runs slower than 1.5x the fastest (bench.py's threshold, kept
    here so the tool needs nothing of the JAX side; a torch bench.py
    should import it from here or keep its own copy)."""
    return [d for d in dts if d <= 1.5 * min(dts)]


def _input_specs(model):
    """[(name, elem_type, dims)] for graph inputs that are not initializers."""
    inits = {t.name for t in model.graph.initializer}
    specs = []
    for vi in model.graph.input:
        if vi.name in inits:
            continue
        tt = vi.type.tensor_type if vi.type else None
        if tt is None:
            raise SystemExit(f"input {vi.name!r} has no tensor type")
        dims = []
        for i, d in enumerate(tt.shape.dim if tt.shape else []):
            if d.dim_value is not None and d.dim_value > 0:
                dims.append(int(d.dim_value))
            elif i == 0:
                dims.append(None)  # batch axis, swept
            else:
                raise SystemExit(
                    f"input {vi.name!r} has a symbolic non-leading dim; "
                    "re-export with static shapes"
                )
        specs.append((vi.name, tt.elem_type, dims))
    if not specs:
        raise SystemExit("model has no runtime inputs (all are initializers)")
    return specs


def _synth(rng, elem_type, shape):
    from birdnet_tpu_torch.onnx.proto import _DTYPE_TO_NUMPY

    dt = np.dtype(_DTYPE_TO_NUMPY[elem_type])
    if dt.kind == "f":
        return (rng.standard_normal(shape) * 0.5).astype(dt)
    if dt.kind in "iu":
        return rng.integers(0, 8, size=shape).astype(dt)
    if dt.kind == "b":
        return rng.integers(0, 2, size=shape).astype(bool)
    raise SystemExit(f"cannot synthesize dtype {dt}")


def _host_reads() -> int:
    from birdnet_tpu_torch.compiler.ops import HOST_READS

    return sum(HOST_READS.values())


def _read_back(outs) -> list:
    """Every output on the host, as ``np.asarray`` reads the JAX tool's."""
    return [o.detach().cpu() if isinstance(o, torch.Tensor) else np.asarray(o)
            for o in outs]


class Bench:
    """One imported model's forward on ``device`` at ``precision``."""

    def __init__(self, path: str, precision: str, device):
        from birdnet_tpu_torch.compiler.importer import import_onnx, make_forward, params_to_torch

        self.device = torch.device(device)
        self.model = import_onnx(path)
        self.specs = _input_specs(self.model)
        self.fwd = make_forward(self.model, precision, self.device)
        self.params = params_to_torch(self.model.params, self.device)

    def fixed_batch(self) -> bool:
        # Rank-0 (scalar) inputs have no batch axis and count as fixed.
        return all(not dims or dims[0] is not None for _, _, dims in self.specs)

    def inputs(self, rng, b):
        return [torch.from_numpy(_synth(rng, et, [b if d is None else d for d in dims]))
                .to(self.device) for _, et, dims in self.specs]

    def capture(self, inputs):
        """(graph, its static outputs, the cached operands it holds) of one
        forward, after a warm call on a side stream."""
        from birdnet_tpu_torch.ops.cuda.build import holding
        from birdnet_tpu_torch.utils.collector import collector_paused

        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side), torch.inference_mode():
            self.fwd(self.params, *inputs)
        torch.cuda.current_stream(self.device).wait_stream(side)
        torch.cuda.synchronize(self.device)
        graph = torch.cuda.CUDAGraph()
        # The graph keeps the cached operands it reads (build.hold).
        with holding() as held, collector_paused(), torch.cuda.graph(graph), \
                torch.inference_mode():
            outs = self.fwd(self.params, *inputs)
        return graph, outs, held

    def row(self, b, inputs, runs: int, batch_size=None) -> tuple:
        """(the JAX tool's row plus the graph's figures, the eager outputs
        on the host, the graph's outputs on the host or None)."""
        t0 = time.monotonic()
        before = _host_reads()
        eager = _read_back(self.fwd(self.params, *inputs))
        reads = _host_reads() - before
        captured = None
        if self.device.type == "cuda" and reads == 0:
            captured = self.capture(inputs)
            captured[0].replay()
            _read_back(captured[1])
        compile_s = time.monotonic() - t0

        def timed(call):
            dts = []
            for _ in range(runs):
                t0 = time.monotonic()
                _read_back(call())  # readback ends the run, as np.asarray does
                dts.append(time.monotonic() - t0)
            kept = _stall_filter(dts)
            return statistics.median(kept), f"{len(kept)}/{len(dts)}"

        med, kept = timed(lambda: self.fwd(self.params, *inputs))
        units = b if b is not None else batch_size
        rec = {"batch": b if b is not None else (batch_size or "fixed"),
               "ms_per_batch": round(med * 1e3, 3),
               "compile_s": round(compile_s, 2),
               "runs_kept": kept}
        rate_key = "inf_s" if units is not None else "dispatch_s"
        rec[rate_key] = round((units or 1) / med, 1 if units is not None else 2)
        graph_outs = None
        if captured is None:
            rec.update({"graph_ms_per_batch": None, f"graph_{rate_key}": None,
                        "graph_runs_kept": None})
        else:
            graph, outs, _ = captured

            def replay():
                graph.replay()
                return outs

            gmed, gkept = timed(replay)
            rec.update({"graph_ms_per_batch": round(gmed * 1e3, 3),
                        f"graph_{rate_key}": round((units or 1) / gmed,
                                                   1 if units is not None else 2),
                        "graph_runs_kept": gkept})
            graph_outs = _read_back(outs)
        rec["host_reads"] = reads
        return rec, eager, graph_outs


def sweep(bench: Bench, batches, runs: int, batch_size=None, seed: int = 0):
    """Yield (row, eager outputs, graph outputs) per batch point, the
    inputs drawn from ``np.random.default_rng(seed)`` in the JAX tool's
    order."""
    rng = np.random.default_rng(seed)
    points = [None] if bench.fixed_batch() else list(batches)
    for b in points:
        inputs = bench.inputs(rng, b)
        yield bench.row(b, inputs, runs, batch_size)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", required=True)
    ap.add_argument("--batches", default="1,8,32,128")
    ap.add_argument("--precision", default="fast",
                    choices=["fp32", "mixed", "fast", "bf16"])
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--batch-size", type=int, default=None,
                    help="fixed-shape models only: inferences per dispatch "
                         "for the inf/s math (a static leading dim is NOT "
                         "assumed to be a batch axis; without this flag, "
                         "fixed-shape models report dispatches/s)")
    ap.add_argument("--json", action="store_true",
                    help="one JSON line per batch point")
    ap.add_argument("--provider", default="auto",
                    help="auto = gpu = cuda: the CUDA card (the default); cpu: the host")
    args = ap.parse_args(argv)

    from birdnet_tpu_torch.runtime import check_provider, resolve_device
    from birdnet_tpu_torch.utils.profiling import card_description

    device = resolve_device(check_provider(args.provider))
    bench = Bench(args.model, args.precision, device)
    print(f"# card: {card_description(device)}", file=sys.stderr, flush=True)
    if not args.json:
        print(f"model: {args.model} ({len(bench.model.graph.node)} nodes, "
              f"{bench.model.param_bytes() / 1e6:.1f} MB params) on {device}, "
              f"precision={args.precision}")
    batches = [int(b) for b in args.batches.split(",")]
    for rec, _, _ in sweep(bench, batches, args.runs, args.batch_size):
        if args.json:
            print(json.dumps(rec), flush=True)
            continue
        unit = "inf/s" if "inf_s" in rec else "dispatches/s"
        rate = rec.get("inf_s", rec.get("dispatch_s"))
        grate = rec.get("graph_inf_s", rec.get("graph_dispatch_s"))
        graph = (f"graph {grate} {unit} ({rec['graph_ms_per_batch']} ms, kept "
                 f"{rec['graph_runs_kept']})" if grate is not None else "graph: none")
        print(f"  batch {rec['batch']:>5}: eager {rate:>10} {unit}  "
              f"({rec['ms_per_batch']} ms/dispatch, compile {rec['compile_s']}s, "
              f"kept {rec['runs_kept']});  {graph}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
