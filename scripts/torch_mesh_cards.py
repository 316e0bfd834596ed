"""The port's mesh over every visible card, against one card.

    python3 scripts/torch_mesh_cards.py

Needs CUDA (at least two cards to say anything of scaling). Builds the
full-width BirdNET v2.4 conv file (random weights, seed 0) and, for each
mesh shape that the visible cards allow ((n, 1), the default
``make_mesh()`` and (1, n)), a classifier over the mesh beside a
single-device classifier on ``cuda:0``:

- fp32: the mesh's logits, top-K and confidences against the single
  card's (logits within 1e-4 of their scale, indices equal, confidences
  within 1e-4);
- ``fast``: the mesh's captured programs (``predict_batch(32)``, the batch
  context with row masks, the ten-minute stream) against its eager step
  bit for bit; the graphs one call replays (one per card and the merge);
  the kernel launches of one ``predict_batch(32)`` per kernel (B2 and B4
  once per running cell);
- ``fast`` ``predict_batch`` segments/s at batch 32 and 128 (the mesh's
  graphs, its eager step, the single card's ``predict_batch`` and batch
  context), and a ten-minute int16 stream's segments/s (graphs, eager,
  single card), in turns (host clock, median of each reading's calls).

Then two CLI processes joined by ``--coordinator`` on 127.0.0.1, each
seeing one card (``CUDA_VISIBLE_DEVICES``), over four seeded WAVs against
one process's CSV. Prints one JSON line per part and the cards' names and
power limits (nvidia-smi); exits non-zero when a check fails.
"""

from __future__ import annotations

import csv
import json
import os
import socket
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from birdnet_tpu_torch import Classifier  # noqa: E402
from birdnet_tpu_torch.models import birdnet_v24  # noqa: E402
from birdnet_tpu_torch.onnx import proto as P  # noqa: E402
from birdnet_tpu_torch.ops.cuda import frontend as fe  # noqa: E402
from birdnet_tpu_torch.ops.cuda import stage_prefix as spx  # noqa: E402
from birdnet_tpu_torch.parallel import make_mesh  # noqa: E402
from birdnet_tpu_torch.parallel.engine import _EagerBatch  # noqa: E402
from birdnet_tpu_torch.utils.audio_io import write_wav  # noqa: E402

SEED = 0
TOL = 1e-4
S = 144_000
LABELS = [f"Genus{i}_species{i}_Common {i}" for i in range(birdnet_v24.NUM_SPECIES)]
STREAM_SECONDS = 600


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def built(path: str, policy: str, mesh=None):
    b = Classifier.builder().model_path(path).labels(LABELS).precision(policy).top_k(5)
    return (b.with_mesh(mesh) if mesh is not None else b.with_device("cuda:0")).build()


def rate(fn, n_segments: int, calls: int = 5) -> float:
    fn()
    readings = []
    for _ in range(calls):
        t0 = time.perf_counter()
        fn()
        readings.append(n_segments / (time.perf_counter() - t0))
    return statistics.median(readings)


def in_turns(fns: dict, n_segments: int) -> dict:
    """Each rate function read twice, in turns (a, b, b, a); the medians."""
    got = {name: [] for name in fns}
    for order in (list(fns), list(fns)[::-1]):
        for name in order:
            got[name].append(rate(fns[name], n_segments))
    return {name: statistics.median(v) for name, v in got.items()}


def graph_vs_eager(clf, segs, pcm) -> dict:
    """The mesh's captured programs against its eager step on the same
    inputs, bit for bit: predict_batch's program, the row-mask program
    (as a batch context runs it) and the stream."""
    eng = clf._engine
    b = segs.shape[0]
    eager = _EagerBatch(eng, eng._batch_bucket(b), eng.embed_index is not None)
    rows = np.random.default_rng(SEED + 3).random((eager.bucket, birdnet_v24.NUM_SPECIES)) < 0.5
    same = {}
    for name, mask in (("predict_batch", None), ("row_masks", rows)):
        program = eng.compiled(b, with_row_mask=mask is not None)
        got, want = program.run(segs, mask, b, None), eager.run(segs, mask, b, None)
        same[name] = all((g is None and w is None) or np.array_equal(g, w)
                         for g, w in zip(got, want))
    graph = eng.analyze(pcm)
    plain = eager_stream(eng, pcm)
    same["stream"] = all(np.array_equal(g, w) for g, w in zip(graph, plain))
    program = eng.compiled(b)
    same["replays_per_call"] = len(program.step.graphs) + (program.step._merge_graph is not None)
    same["stream_keys_eager"] = [list(k) for k, p in eng.programs.items() if p.eager]
    return same


def eager_stream(eng, pcm):
    """``eng.analyze(pcm)`` through the mesh's eager tile loop."""
    eng._run_tiles = eng._eager_tiles
    try:
        return eng.analyze(pcm)
    finally:
        del eng._run_tiles


def agreement(got, want) -> dict:
    lg = np.stack([r.raw_scores for r in got])
    wl = np.stack([r.raw_scores for r in want])
    line = {"scaled_logit_diff": float(np.abs(lg - wl).max() / np.abs(wl).max()),
            "topk_indices_equal": all([p.index for p in g.predictions]
                                      == [p.index for p in w.predictions]
                                      for g, w in zip(got, want)),
            "max_conf_diff": max(abs(p.confidence - q.confidence) for g, w in zip(got, want)
                                 for p, q in zip(g.predictions, w.predictions))}
    line["ok"] = bool(line["scaled_logit_diff"] <= TOL and line["topk_indices_equal"]
                      and line["max_conf_diff"] <= TOL)
    return line


def cli_ranks(path: str, tmp: Path, n_cards: int) -> dict:
    rng = np.random.default_rng(SEED + 101)
    wavs = []
    for i in range(4):
        wav = tmp / f"rec{i}.wav"
        write_wav(wav, (rng.standard_normal(9 * 48_000) * 0.1).astype(np.float32), 48_000)
        wavs.append(str(wav))
    labels = tmp / "labels.txt"
    labels.write_text("\n".join(LABELS), encoding="utf-8")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    base = [sys.executable, "-m", "birdnet_tpu_torch.cli", *wavs, "-m", path, "-l", str(labels),
            "--min-confidence", "0", "-t", "0"]
    env = dict(os.environ, PYTHONPATH=str(REPO))
    runs = [(base + ["--csv", str(tmp / "out.csv"), "--coordinator", f"127.0.0.1:{port}",
                     "--num-processes", "2", "--process-id", str(r)],
             dict(env, CUDA_VISIBLE_DEVICES=str(r % n_cards))) for r in range(2)]
    runs.append((base + ["--csv", str(tmp / "single.csv")], env))
    procs = [subprocess.Popen(cmd, cwd=tmp, env=e, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for cmd, e in runs]
    try:
        outs = [p.communicate(timeout=120) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, (so, se) in zip(procs, outs):
        if p.returncode != 0:
            raise SystemExit(f"CLI exited {p.returncode}: {so[-1500:]} {se[-1500:]}")

    def rows(name):
        with open(tmp / name, newline="", encoding="utf-8") as f:
            return sorted((r[0], r[1], r[2], r[3], float(r[4])) for r in list(csv.reader(f))[1:])

    ranks = sorted(rows("out.csv.0") + rows("out.csv.1"))
    single = rows("single.csv")
    same = [r[:4] for r in ranks] == [r[:4] for r in single]
    conf = max(abs(a[4] - b[4]) for a, b in zip(ranks, single)) if same else None
    return {"part": "cli_two_ranks_one_card_each", "rows": len(ranks), "same_rows": same,
            "max_conf_diff": conf, "ok": bool(same and conf <= 1e-3)}


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("torch_mesh_cards: torch.cuda.is_available() is false")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout
    print(smi.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    n = torch.cuda.device_count()
    cards = [torch.device("cuda", i) for i in range(n)]
    shapes = [(n, 1)] + ([tuple(make_mesh().devices.shape)] if n >= 4 else []) + [(1, n)]
    failed = []
    segs = (np.random.default_rng(SEED + 1).normal(size=(128, S)) * 0.1).astype(np.float32)
    pcm = (np.random.default_rng(SEED + 2).standard_normal(STREAM_SECONDS * 48_000) * 3000
           ).clip(-32768, 32767).astype(np.int16)
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "v24_conv.onnx")
        P.save_model(birdnet_v24.build_model(seed=SEED, frontend="conv"), path)
        single = {policy: built(path, policy) for policy in ("fp32", "fast")}
        contexts = {}
        want = single["fp32"].predict_batch(segs[:32])
        for shape in dict.fromkeys(shapes):
            mesh = make_mesh(cards, shape=shape)
            fp32, fast = built(path, "fp32", mesh), built(path, "fast", mesh)
            fast.predict_batch(segs[:32])
            fe.reset_launches()
            spx.reset_launches()
            fast.predict_batch(segs[:32])
            line = {"part": "mesh", "shape": list(shape), "cards": n,
                    "head_sharded": fast._engine.head_sharded,
                    "fp32_vs_one_card": agreement(fp32.predict_batch(segs[:32]), want),
                    "launches_one_call": {"filterbank_logpower": fe.LAUNCHES["filterbank_logpower"],
                                          "stage_stack_forward":
                                              spx.LAUNCHES["stage_stack_forward"]}}
            line["graph_vs_eager"] = checks = graph_vs_eager(fast, segs[:32], pcm)
            eng = fast._engine
            for b in (32, 128):
                ctx = contexts.setdefault(b, single["fast"].create_batch_context(b))
                eager = _EagerBatch(eng, b, False)
                line[f"seg_per_s_fast_predict_batch{b}"] = in_turns(
                    {"one_card": lambda b=b: single["fast"].predict_batch(segs[:b]),
                     "one_card_context": lambda b=b, ctx=ctx: single[
                         "fast"].predict_batch_with_context(ctx, segs[:b]),
                     "mesh": lambda b=b: fast.predict_batch(segs[:b]),
                     "mesh_eager": lambda b=b, e=eager: e.run(segs[:b], None, b, None)}, b)
            line["seg_per_s_fast_stream_10min"] = in_turns(
                {"one_card": lambda: single["fast"].analyze_samples(pcm),
                 "mesh": lambda: fast.analyze_samples(pcm),
                 "mesh_eager": lambda: eager_stream(eng, pcm)}, STREAM_SECONDS // 3)
            line["ok"] = bool(line["fp32_vs_one_card"]["ok"] and checks["predict_batch"]
                              and checks["row_masks"] and checks["stream"]
                              and not checks["stream_keys_eager"]
                              and checks["replays_per_call"] == (1 if n == 1 else n + 1))
            emit(line)
            if not line["ok"]:
                failed.append(shape)
            del fp32, fast
        if n >= 2:
            line = cli_ranks(path, Path(tmp), n)
            emit(line)
            if not line["ok"]:
                failed.append("cli")
    if failed:
        raise SystemExit(f"torch_mesh_cards: {failed} failed")
    print(smi.strip().splitlines()[0], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
