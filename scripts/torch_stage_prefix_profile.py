"""B4 (the port's stage-prefix kernel) on one CUDA card: what the compiler
made of it, whether it agrees with its plain version, and where its device
time goes, launch by launch.

    python3 scripts/torch_stage_prefix_profile.py [--batch 32 128]

Prints the ptxas report of csrc/stage_prefix.cu (registers, spills), the
number of tensor-core instructions (HMMA) in each kernel's SASS, the
scaled max |Δ| against the plain version at the full-width six-block
geometry and at the reduced one (bf16 with and without fast_act, f32),
then per batch the device time of one forward at [N, 1, 96, 511] (a CUDA
graph of 10 calls replayed) and each launch's device time
(torch.profiler), as one JSON line per batch. Imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from birdnet_tpu_torch.ops.cuda import build  # noqa: E402
from birdnet_tpu_torch.ops.cuda import stage_prefix as sp  # noqa: E402
from birdnet_tpu_torch.utils.collector import collector_paused  # noqa: E402

FULL = [(32, 32, 8, 24, 1, False), (24, 24, 6, 24, 1, True), (24, 96, 24, 40, 2, False),
        (40, 160, 40, 40, 1, True), (40, 160, 40, 80, 2, False), (80, 320, 80, 80, 1, True)]
SMALL = [(32, 32, 8, 16, 1, False), (16, 16, 8, 16, 1, True), (16, 24, 8, 16, 2, False),
         (16, 24, 8, 16, 1, True), (16, 24, 8, 24, 2, False), (24, 32, 8, 24, 1, True)]


def compiler_report() -> None:
    nvcc = build._nvcc()
    with tempfile.TemporaryDirectory() as tmp:
        r = subprocess.run([nvcc, *build.NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o",
                            os.path.join(tmp, "sp.o"), str(build.CSRC_DIR / "stage_prefix.cu")],
                           capture_output=True, text=True, check=True)
    for line in (r.stdout + r.stderr).splitlines():
        if "Compiling entry" in line or "registers" in line or "spill" in line:
            print(line.strip())
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(build.build())], capture_output=True,
                          text=True, check=True).stdout
    counts, kernel = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            kernel = line.split("Function :")[1].strip()
        elif kernel and "stage_prefix" in kernel and ("HMMA" in line or "HGMMA" in line):
            counts[kernel] = counts.get(kernel, 0) + 1
    print(json.dumps({"hmma_per_kernel": counts}))


def tables(blocks, dtype, dev, seed=3):
    rng = np.random.default_rng(seed)
    f = lambda *shape, s=1.0: (rng.normal(size=shape) * s).astype(np.float32)
    bws = [dict(w1=f(m, i, s=1.5 / np.sqrt(i)), b1=f(m, s=0.05), wd=f(m, 1, 3, 3, s=0.3),
                bd=f(m, s=0.05), se1=f(e, m, s=1 / np.sqrt(m)), bse1=f(e, s=0.05),
                se2=f(m, e, s=1 / np.sqrt(e)), bse2=f(m, s=0.05), w3=f(o, m, s=1 / np.sqrt(m)),
                b3=f(o, s=0.05)) for i, m, e, o, _, _ in blocks]
    return sp.prepare_weights(f(blocks[0][0], 1, 3, 3, s=0.4), f(blocks[0][0], s=0.05), bws,
                              [sp.BlockGeom(*g) for g in blocks], dtype, dev)


def image(n, dev, dtype, width=511):
    x = np.random.default_rng(4).normal(size=(n, 1, 96, width)) * 0.5
    return torch.from_numpy(x.astype(np.float32)).to(dev).to(dtype)


def check(dev) -> None:
    for name, blocks in (("full", FULL), ("small", SMALL)):
        for dtype, fast_act in ((torch.bfloat16, True), (torch.bfloat16, False),
                                (torch.float32, False)):
            t, x = tables(blocks, dtype, dev), image(4, dev, dtype)
            got = sp.stage_stack_forward(x, t, fast_act)
            want = sp.stage_stack_forward_plain(x, t, fast_act)
            scaled = float((got.float() - want.float()).abs().max() / want.float().abs().max())
            print(json.dumps({"check": name, "dtype": str(dtype), "fast_act": fast_act,
                              "scaled_max_abs_diff": scaled,
                              "share_of_outputs_differing": float((got != want).float().mean())}))


def device_ms(fn, reps: int = 10) -> float:
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with collector_paused(), torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def breakdown(dev, n: int) -> dict:
    from torch.profiler import ProfilerActivity, profile

    t, x = tables(FULL, torch.bfloat16, dev), image(n, dev, torch.bfloat16)
    ms = device_ms(lambda: sp.stage_stack_forward(x, t, True))
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        sp.stage_stack_forward(x, t, True)
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        prof.export_chrome_trace(os.path.join(tmp, "trace.json"))
        events = json.loads(Path(tmp, "trace.json").read_text())["traceEvents"]
    launches = sorted((e["ts"], e["dur"]) for e in events
                      if e.get("ph") == "X" and e.get("cat") == "kernel")
    names = ["stem"] + [f"block{b}_{k}" for b in range(1, 7)
                        for k in ("expand_depthwise", "gate", "project")]
    return {"batch": n, "us_per_segment": 1e3 * ms / n,
            "launch_us_per_segment": {name: dur / n for name, (_, dur) in zip(names, launches)}}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--batch", type=int, nargs="+", default=[32, 128])
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    compiler_report()
    check(dev)
    for n in args.batch:
        print(json.dumps(breakdown(dev, n)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
