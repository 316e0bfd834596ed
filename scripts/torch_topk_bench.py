"""Microbench of the port's sigmoid top-K on ``[tile, N]`` logits, on one
CUDA card: the full stable sort against ``torch.topk`` and a two-stage
top-K.

The counterpart of scripts/topk_bench.py, without JAX. Forms:

- ``fused_sigmoid_topk``: ``ops/topk.py``, what the stream, the batch
  context and the batcher run (a stable descending sort of every row).
- ``torch.topk``: one ``torch.topk`` over a packed key per logit, the
  logit's order-preserving bits above ``0xFFFF - index``, so that equal
  logits rank the lower index first, as the stable sort and ``lax.top_k``
  do (``torch.topk`` leaves the order of ties unspecified, and bf16 logits
  tie often).
- ``two-stage``: the same keys; pad N to ``c * chunk``, top-K per chunk,
  then top-K over the ``c * k`` candidates (scripts/topk_bench.py's
  two-stage, whose index remap the key carries). Exact for k <= chunk.
- ``torch.topk (raw)``: ``torch.topk`` on the logits themselves, timed as
  the library yardstick; ties come back in an unspecified order, so only
  its values are checked.

The three exact forms must give equal confidences and indices on the seeded
input (checked first). Then each form runs ``--reps`` times inside one
captured CUDA graph, each repetition on ``x * (1 + c)`` cast to ``--dtype``
with ``c`` carried from the previous result (so no repetition can be
skipped), timed with CUDA events beside a read-only baseline (the cast and a
sum). Prints µs per tile and per segment, and one JSON line.

Usage: python scripts/torch_topk_bench.py [--n 6522] [--tile 128] [--k 10]
    [--reps 256] [--dtype bfloat16] [--chunk 512] [--provider auto|cuda|cpu]

Without a card it raises, unless ``--provider cpu`` asks for the host (a
``perf_counter`` loop: host times for tests, not device figures).
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

from birdnet_tpu_torch.utils.collector import collector_paused  # noqa: E402
from birdnet_tpu_torch.ops.topk import fused_sigmoid_topk  # noqa: E402

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
# (key dtype, the logit's bit view, the index field's width in bits)
_KEYS = {torch.bfloat16: (torch.int32, torch.int16, 16),
         torch.float32: (torch.int64, torch.int32, 32)}


def packed_keys(logits: torch.Tensor) -> torch.Tensor:
    """One integer per logit, ordered as (logit descending, index
    ascending): the logit's bits made monotone (negative floats' magnitude
    bits flipped; -0 folded onto +0) above ``2^w - 1 - index``. Finite
    logits and N < 2^w."""
    key_dt, bits_dt, w = _KEYS[logits.dtype]
    bits = (logits + 0.0).view(bits_dt).to(key_dt)
    mono = torch.where(bits < 0, bits ^ ((1 << (w - 1)) - 1), bits)
    idx = torch.arange(logits.shape[-1], device=logits.device, dtype=key_dt)
    return (mono << w) | ((1 << w) - 1 - idx)


def unpack_keys(keys: torch.Tensor, dtype) -> tuple:
    """(logits, int32 indices) of :func:`packed_keys`' output."""
    _, bits_dt, w = _KEYS[dtype]
    mono = keys >> w
    bits = torch.where(mono < 0, mono ^ ((1 << (w - 1)) - 1), mono)
    idx = (1 << w) - 1 - (keys & ((1 << w) - 1))
    return bits.to(bits_dt).view(dtype), idx.to(torch.int32)


def keyed_topk(logits: torch.Tensor, k: int) -> tuple:
    """(confidences, int32 indices) from one ``torch.topk`` of the keys."""
    v, i = unpack_keys(torch.topk(packed_keys(logits), k).values, logits.dtype)
    return torch.sigmoid(v), i


def two_stage_topk(logits: torch.Tensor, k: int, chunk: int = 512) -> tuple:
    """(confidences, int32 indices): per-chunk ``torch.topk`` of the keys,
    then ``torch.topk`` over the candidates; the key keeps the global
    index, so no remap is needed."""
    b, n = logits.shape
    keys = packed_keys(logits)
    nc = -(-n // chunk)
    pad = nc * chunk - n
    if pad:
        lowest = torch.iinfo(keys.dtype).min
        keys = torch.cat([keys, keys.new_full((b, pad), lowest)], dim=1)
    cand = torch.topk(keys.reshape(b, nc, chunk), k).values  # [b, nc, k]
    v, i = unpack_keys(torch.topk(cand.reshape(b, nc * k), k).values, logits.dtype)
    return torch.sigmoid(v), i


def raw_topk(logits: torch.Tensor, k: int) -> tuple:
    v, i = torch.topk(logits, k)
    return torch.sigmoid(v), i.to(torch.int32)


def forms(k: int, chunk: int) -> dict:
    """name -> fn(logits) -> (confidences, int32 indices). The first three
    are exact (lower index first among equal logits)."""
    return {
        "fused_sigmoid_topk": lambda x: fused_sigmoid_topk(x, k),
        "torch.topk": lambda x: keyed_topk(x, k),
        f"two-stage (chunk {chunk})": lambda x: two_stage_topk(x, k, chunk),
        "torch.topk (raw)": lambda x: raw_topk(x, k),
    }


def check(logits: torch.Tensor, k: int, chunk: int) -> dict:
    """Hold every form to the port's on ``logits``: the exact forms' values
    and indices equal, the raw form's values equal. Raises on a mismatch;
    returns how many rows tie at the k-th logit (where a raw top-K may
    choose another index)."""
    fns = forms(k, chunk)
    names = list(fns)
    want_v, want_i = fns[names[0]](logits)
    for name in names[1:]:
        v, i = fns[name](logits)
        if not torch.equal(v, want_v):
            raise AssertionError(f"{name}: confidences differ from {names[0]}")
        if name != "torch.topk (raw)" and not torch.equal(i, want_i):
            raise AssertionError(f"{name}: indices differ from {names[0]}")
    srt = torch.sort(logits, dim=-1, descending=True).values
    return {"rows_tied_at_k": int((srt[:, k - 1] == srt[:, k]).sum())}


def _looped(body, x, dtype, reps):
    """``reps`` repetitions of ``body`` on ``x * (1 + c)`` in ``dtype``, each
    ``c`` taken from the last result."""
    c = torch.zeros((), device=x.device)
    for _ in range(reps):
        c = (body((x * (1.0 + c)).to(dtype)) > 1e30).float() * 1e-30
    return c


def time_us(body, x, dtype, reps) -> float:
    """Microseconds per repetition: on the card ``reps`` repetitions in one
    captured CUDA graph, CUDA events around 3 replays (median); on the host
    a ``perf_counter`` loop (median of 3)."""
    if x.device.type != "cuda":
        dts = []
        for _ in range(3):
            t0 = time.perf_counter()
            float(_looped(body, x, dtype, reps))
            dts.append(time.perf_counter() - t0)
        return statistics.median(dts) / reps * 1e6
    side = torch.cuda.Stream(x.device)
    side.wait_stream(torch.cuda.current_stream(x.device))
    with torch.cuda.stream(side):
        _looped(body, x, dtype, 2)
    torch.cuda.current_stream(x.device).wait_stream(side)
    torch.cuda.synchronize(x.device)
    graph = torch.cuda.CUDAGraph()
    with collector_paused(), torch.cuda.graph(graph):
        _looped(body, x, dtype, reps)
    graph.replay()
    dts = []
    for _ in range(3):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize(x.device)
        dts.append(start.elapsed_time(end) * 1e3)
    return statistics.median(dts) / reps


def run(device, n=6522, tile=128, k=10, reps=256, dtype="bfloat16", chunk=512) -> dict:
    """The check, then each form's time. Returns the JSON line's dict."""
    dt = DTYPES[dtype]
    base = torch.from_numpy(
        np.random.default_rng(0).normal(size=(tile, n)).astype(np.float32)).to(device)
    ties = check(base.to(dt), k, chunk)

    def reduced(fn):
        def body(logits):
            v, i = fn(logits)
            return v.float().sum() + i.sum()
        return body

    bodies = {"read-only baseline": lambda logits: logits.float().sum()}
    bodies.update({name: reduced(fn) for name, fn in forms(k, chunk).items()})
    us = {name: time_us(body, base, dt, reps) for name, body in bodies.items()}
    return {"n": n, "tile": tile, "k": k, "reps": reps, "dtype": dtype, "chunk": chunk,
            "device": str(device), **ties,
            "us_per_tile": us,
            "us_per_seg": {name: t / tile for name, t in us.items()}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=6522)
    ap.add_argument("--tile", type=int, default=128)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--reps", type=int, default=256)
    ap.add_argument("--dtype", default="bfloat16", choices=sorted(DTYPES))
    ap.add_argument("--chunk", type=int, default=512)
    ap.add_argument("--provider", default="auto",
                    help="auto = gpu = cuda: the CUDA card (the default); cpu: the host")
    args = ap.parse_args(argv)

    from birdnet_tpu_torch.runtime import check_provider, resolve_device
    from birdnet_tpu_torch.utils.profiling import card_description

    device = resolve_device(check_provider(args.provider))
    print(f"# card: {card_description(device)}")
    res = run(device, args.n, args.tile, args.k, args.reps, args.dtype, args.chunk)
    print(f"# exact forms agree (values and indices); rows tied at the k-th logit: "
          f"{res['rows_tied_at_k']}/{args.tile}")
    for name, t in res["us_per_tile"].items():
        print(f"{name:24s} {t:9.1f} us/tile ({res['us_per_seg'][name]:6.3f} us/seg)")
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
