"""Per-stage device time of the port's forward of a full-width BirdNET
model (random weights from a seed), on one CUDA card.

The counterpart of scripts/stage_profile.py, without JAX. For each
milestone tensor (frontend out, stem out, each MBConv block's project conv
out, head, logits) the graph is pruned to the milestone's ancestors (the
port's interpreter runs every node it is given; XLA's dead-code
elimination made the JAX script's prefixes), and ``reps`` forwards of that
prefix on one fixed ``[tile, S]`` input are captured into one CUDA graph.
Its replays are timed with CUDA events; the median of ``runs`` replays over
``reps`` is the prefix's time per tile, and the difference between
consecutive milestones is that stage's time.

Two tables: the raw node chains (the import's fusions expanded, so each
block has its project conv; the JAX script's milestones), and the default
fusions the classifier runs (the frontend kernel and the stage prefix, B4,
each one milestone, then each later MBConv block). Under ``--int8`` the
second table is left out: the int8 graph has no stage prefix.

    python scripts/torch_stage_profile.py [--reps 64] [--tile 128]
        [--runs 3] [--precision fast] [--int8] [--model v24|v30|perch]

Prints one row per stage (µs/tile, µs/segment, % of total) and one JSON
line per table. Given a host tensor, the same functions time with
``time.perf_counter``: that is for tests, not a device number.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from birdnet_tpu_torch.compiler.fuse_frontend import unfuse_frontend  # noqa: E402
from birdnet_tpu_torch.compiler.fuse_mbconv import unfuse_mbconv  # noqa: E402
from birdnet_tpu_torch.compiler.fuse_stage_prefix import unfuse_stage_prefix  # noqa: E402
from birdnet_tpu_torch.compiler.importer import (  # noqa: E402
    import_onnx,
    make_forward,
    params_to_torch,
)
from birdnet_tpu_torch.onnx import proto as P  # noqa: E402
from birdnet_tpu_torch.utils.profiling import card_description  # noqa: E402

FUSED_FRONTENDS = ("_FusedFrontend", "_FusedStftFrontend")


def milestones_of(graph):
    """Pick milestone tensors: conv outputs that delimit architecture stages.

    After import-time Conv+BN folding the benchmark v2.4 graph's Conv nodes
    are: [frontend, stem, (expand, dw, se1, se2, project) x 12, head].
    Works for the QDQ-fused int8 graph too (QLinearConv nodes).
    """
    convs = [n for n in graph.node if n.op_type in ("Conv", "QLinearConv")]
    out = [("frontend", convs[0].output[0]), ("stem", convs[1].output[0])]
    n_blocks = (len(convs) - 3) // 5
    for b in range(n_blocks):
        proj = convs[2 + 5 * b + 4]
        out.append((f"block{b:02d}", proj.output[0]))
    out.append(("head", convs[-1].output[0]))
    gemms = [n for n in graph.node if n.op_type == "Gemm"]
    if gemms:
        out.append(("logits", gemms[-1].output[0]))
    return out


def fused_milestones_of(graph):
    """The milestones of a graph with the import's default fusions: the
    fused frontend, the stage prefix (stem and its blocks: one milestone),
    each later fused MBConv block, the head conv and the logits. None when
    the graph has no stage prefix."""
    prefix = [n for n in graph.node if n.op_type == "_FusedStagePrefix"]
    if not prefix:
        return None
    out = []
    blocks = 0
    for n in graph.node:
        if n.op_type in FUSED_FRONTENDS:
            out.append(("frontend", n.output[0]))
        elif n.op_type == "_FusedStagePrefix":
            blocks = len(n.attrs["block_outputs"])
            out.append((f"stem+block00-{blocks - 1:02d}", n.output[0]))
        elif n.op_type == "_FusedMBConv":
            out.append((f"block{blocks:02d}", n.output[0]))
            blocks += 1
    convs = [n for n in graph.node if n.op_type in ("Conv", "QLinearConv")]
    out.append(("head", convs[-1].output[0]))
    gemms = [n for n in graph.node if n.op_type == "Gemm"]
    if gemms:
        out.append(("logits", gemms[-1].output[0]))
    return out


def _subgraphs(node):
    for a in node.attribute:
        if a.g is not None:
            yield a.g
        yield from a.graphs


def _reads(node) -> list:
    """The names ``node`` reads: its inputs and the outer-scope names its
    subgraphs (fused bodies, If branches, Loop bodies) read."""
    names = [i for i in node.input if i]
    for g in _subgraphs(node):
        made = {vi.name for vi in g.input} | {t.name for t in g.initializer}
        for n in g.node:
            names.extend(x for x in _reads(n) if x not in made)
            made.update(o for o in n.output if o)
        names.extend(vi.name for vi in g.output if vi.name not in made)
    return names


def prune(imported, tensor: str):
    """``imported`` cut to the nodes that ``tensor`` depends on, with
    ``tensor`` its only output."""
    need, keep = {tensor}, []
    for n in reversed(imported.graph.node):
        if any(o in need for o in n.output if o):
            keep.append(n)
            need.update(_reads(n))
    graph = dataclasses.replace(imported.graph, node=keep[::-1],
                                output=[P.ValueInfoProto(name=tensor)])
    return dataclasses.replace(imported, graph=graph, output_names=[tensor],
                               output_shapes=[[]])


BUILDERS = {"v24": "birdnet_v24", "v30": "birdnet_v30", "perch": "perch_v2"}


def imported_models(model: str = "v24", int8: bool = False, device="cpu", **size):
    """The full-width file of ``model`` (the generator's seed and conv
    frontend; ``size``: ``width``/``depth`` to cut it) imported twice: with
    its fusions expanded (the first table) and as the import leaves it (the
    second). ``int8`` quantizes the first (synthetic calibration on
    ``device``) and expands its frontend again, which quantization fuses;
    the second is then None (the int8 graph the classifier runs has no
    stage prefix). Returns (sample count, unfused, fused)."""
    import importlib

    from birdnet_tpu_torch.compiler.quantize import (
        quantize_model,
        synthetic_calibration_segments,
    )

    builder = importlib.import_module(f"birdnet_tpu_torch.models.{BUILDERS[model]}")
    data = P.encode_model(builder.build_model(**size))
    unfused, fused = import_onnx(data), import_onnx(data)
    unfuse_frontend(unfused.graph)
    unfuse_stage_prefix(unfused.graph)
    unfuse_mbconv(unfused.graph)
    if int8:
        calib = synthetic_calibration_segments(builder.SAMPLE_COUNT, batches=2)
        unfused = quantize_model(unfused, calib, device=device)
        unfuse_frontend(unfused.graph)
        fused = None
    return builder.SAMPLE_COUNT, unfused, fused


def prefix_forward(imported, tensor: str, precision: str, params, device):
    """``fn(x) -> tensor``: the pruned prefix on ``device``, over ``params``
    (:func:`params_to_torch` of ``imported.params``)."""
    fwd = make_forward(prune(imported, tensor), precision, device)
    return lambda x: fwd(params, x)[0]


def _time_cuda(fn, x, reps: int, runs: int) -> float:
    """Median µs of one ``fn(x)`` over ``runs`` replays of a CUDA graph of
    ``reps`` calls (its cached operands held for the graph's life)."""
    from birdnet_tpu_torch.ops.cuda.build import holding
    from birdnet_tpu_torch.utils.collector import collector_paused

    device = x.device
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side), torch.inference_mode():
        for _ in range(2):
            fn(x)
    torch.cuda.current_stream(device).wait_stream(side)
    torch.cuda.synchronize(device)
    graph = torch.cuda.CUDAGraph()
    with holding() as held, collector_paused(), torch.cuda.graph(graph), \
            torch.inference_mode():
        for _ in range(reps):
            fn(x)
    graph.replay()
    torch.cuda.synchronize(device)
    times = []
    for _ in range(runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) * 1e3 / reps)
    return statistics.median(times)


def _time_host(fn, x, reps: int, runs: int) -> float:
    with torch.inference_mode():
        fn(x)
        times = []
        for _ in range(runs):
            t0 = time.perf_counter()
            for _ in range(reps):
                fn(x)
            times.append((time.perf_counter() - t0) * 1e6 / reps)
    return statistics.median(times)


def profile(imported, marks, x, precision: str, reps: int, runs: int) -> list:
    """``[(milestone, cumulative µs per tile)]`` of each prefix on ``x``."""
    timer = _time_cuda if x.device.type == "cuda" else _time_host
    params = params_to_torch(imported.params, x.device)
    return [(name, timer(prefix_forward(imported, tensor, precision, params, x.device),
                         x, reps, runs))
            for name, tensor in marks]


def stage_rows(cumulative: list, tile: int) -> list:
    """Per stage: µs per tile, µs per segment and its share of the total,
    from the milestones' cumulative times."""
    total = cumulative[-1][1]
    rows, prev = [], 0.0
    for name, cum in cumulative:
        d = cum - prev
        rows.append({"stage": name, "us_per_tile": d, "us_per_segment": d / tile,
                     "share": d / total})
        prev = cum
    return rows


def print_table(title: str, rows: list, tile: int) -> None:
    print(f"\n# {title}")
    print(f"{'stage':18s} {'us/tile':>10s} {'us/seg':>9s} {'% of total':>10s}")
    for r in rows:
        print(f"{r['stage']:18s} {r['us_per_tile']:10.1f} {r['us_per_segment']:9.3f} "
              f"{100 * r['share']:9.1f}%")
    total = sum(r["us_per_tile"] for r in rows)
    print(f"{'TOTAL':18s} {total:10.1f} {total / tile:9.3f}", flush=True)


def profile_tables(unfused, fused, x, precision: str, reps: int, runs: int) -> list:
    """The stage tables on ``x`` (``[tile, S]``): the unfused graph's, then,
    where ``fused`` is given and has a stage prefix, the default fusions'.
    Returns ``[{"table", "stages", "total_us_per_tile"}]``."""
    tables = [("unfused", unfused, milestones_of(unfused.graph))]
    marks = fused_milestones_of(fused.graph) if fused is not None else None
    if marks is not None:
        tables.append(("default_fusions", fused, marks))
    results = []
    for table, imported, marks in tables:
        rows = stage_rows(profile(imported, marks, x, precision, reps, runs), x.shape[0])
        results.append({"table": table, "total_us_per_tile": sum(r["us_per_tile"] for r in rows),
                        "stages": rows})
    return results


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=64)
    ap.add_argument("--tile", type=int, default=128)
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--precision", default="fast")
    ap.add_argument("--int8", action="store_true",
                    help="profile the PTQ-quantized graph instead")
    ap.add_argument("--model", default="v24", choices=list(BUILDERS))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_stage_profile: torch.cuda.is_available() is false")
    device = torch.device("cuda", 0)
    smi = card_description(device)
    print(f"# device: {smi}")
    S, unfused, fused = imported_models(args.model, args.int8, device)
    x = torch.from_numpy((np.random.default_rng(0).normal(size=(args.tile, S)) * 0.1)
                         .astype(np.float32)).to(device)
    setting = dict(model=args.model, precision=args.precision, int8=args.int8, tile=args.tile,
                   reps=args.reps, runs=args.runs, card=smi)
    for result in profile_tables(unfused, fused, x, args.precision, args.reps, args.runs):
        print_table(f"{result['table']}: " + ", ".join(f"{k} {v}" for k, v in setting.items()),
                    result["stages"], args.tile)
        print(json.dumps({"stage_profile": result.pop("table"), **setting, **result}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
