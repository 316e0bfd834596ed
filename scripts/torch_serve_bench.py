"""Serving load test of the PyTorch port: DynamicBatcher throughput and
latency against its knobs, on one CUDA card.

The counterpart of scripts/serve_bench.py, without JAX. It drives
``birdnet_tpu_torch.serve.DynamicBatcher`` directly (no HTTP) with a
closed-loop pool of client threads, sweeping (max_batch, max_wait_ms,
workers, clients), and prints one JSON row per point: sustained requests/s,
latency percentiles, the batcher's mean batch fill and the requests that
failed. Each row gets a fresh batcher (its workers capture their CUDA
graphs when it is made), a warm-up, then ``metrics.reset()``.

Usage:
    python scripts/torch_serve_bench.py [--model PATH] [--seconds 5]
        [--clients 4,16,64] [--batches 8,32] [--waits 0,5] [--workers 1]
        [--precision fast] [--provider auto|cuda|cpu]

With no --model, writes the full-width random-weight BirdNET v2.4 file
(models/birdnet_v24.py) once under ~/.cache/birdnet_tpu_torch/bench. On the
card it measures the batcher's operating curve; under ``--provider cpu`` it
measures the scheduler on the host (for tests, not device figures). Without
a card and without ``--provider cpu`` it raises.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def build_classifier(model_path, precision, device):
    from birdnet_tpu_torch import Classifier
    from birdnet_tpu_torch.checkpoint import import_any
    from birdnet_tpu_torch.detection import detect_model_type

    # Generate exactly as many labels as the model expects — a v2.4
    # constant would LabelCountError on v3.0 / Perch v2 / custom models.
    cfg = detect_model_type(*import_any(model_path).detection_shapes())
    labels = [f"species_{i}" for i in range(cfg.num_species)]
    b = (
        Classifier.builder()
        .model_path(model_path)
        .labels(labels)
        .top_k(3)
        .with_device(str(device))
    )
    if precision:
        b = b.precision(precision)
    return b.build()


def closed_loop(batcher, segment, n_clients, seconds):
    """n_clients threads each submit→wait→repeat for `seconds`. Returns
    (requests_done, wall, sorted latencies, client errors)."""
    stop_at = time.monotonic() + seconds
    counts = [0] * n_clients
    errors = [0] * n_clients
    lats = [[] for _ in range(n_clients)]

    def client(i):
        rng = np.random.default_rng(i)
        while time.monotonic() < stop_at:
            seg = segment + rng.standard_normal(1).astype(np.float32) * 1e-6
            t0 = time.monotonic()
            try:
                batcher.predict(seg, timeout=120)
            except Exception:  # noqa: BLE001 - counted, never fatal
                # Overload/timeout must not silently kill the client: a row
                # with dead clients would report a healthy-looking number
                # for fewer clients than its label claims.
                errors[i] += 1
                continue
            lats[i].append(time.monotonic() - t0)
            counts[i] += 1

    threads = [
        threading.Thread(target=client, args=(i,)) for i in range(n_clients)
    ]
    t0 = time.monotonic()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.monotonic() - t0
    all_lats = sorted(x for l in lats for x in l)
    return sum(counts), wall, all_lats, sum(errors)


def bench_row(clf, segment, max_batch, wait, n_workers, n_clients, seconds) -> dict:
    """One point of the sweep on a fresh batcher."""
    from birdnet_tpu_torch.serve import DynamicBatcher

    with DynamicBatcher(
        clf, max_batch=max_batch, max_wait_ms=wait, workers=n_workers,
    ) as batcher:
        closed_loop(batcher, segment, 4, min(1.0, seconds))  # warm-up
        # Metrics are cumulative: zero out the warm-up's small batches so
        # mean_fill reflects this row only.
        batcher.metrics.reset()
        done, wall, lats, errs = closed_loop(batcher, segment, n_clients, seconds)
        snap = batcher.metrics.snapshot()
    return {
        "max_batch": max_batch,
        "max_wait_ms": wait,
        "workers": n_workers,
        "clients": n_clients,
        "req_per_s": round(done / wall, 1),
        "p50_ms": round(lats[len(lats) // 2] * 1000, 2) if lats else None,
        "p99_ms": round(lats[min(len(lats) - 1, int(0.99 * len(lats)))] * 1000, 2)
        if lats else None,
        "mean_fill": snap["mean_batch_fill"],
        "client_errors": errs,
    }


def sweep(clf, batches, waits, workers, clients, seconds):
    """Yield one row per (max_batch, max_wait_ms, workers, clients)."""
    segment = (
        np.sin(np.linspace(0, 2000, clf.config.sample_count), dtype=np.float32) * 0.3
    )
    for max_batch in batches:
        for wait in waits:
            for n_workers in workers:
                for n_clients in clients:
                    yield bench_row(clf, segment, max_batch, wait, n_workers,
                                    n_clients, seconds)


def _ints(text):
    return [int(x) for x in text.split(",")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default=None)
    ap.add_argument("--precision", default=None)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--clients", default="4,16,64")
    ap.add_argument("--batches", default="8,32")
    ap.add_argument("--waits", default="0,5")
    ap.add_argument(
        "--workers",
        default="1",
        help="comma list of batcher pipeline counts to sweep (2 overlaps "
        "host staging/readback with the card's compute)",
    )
    ap.add_argument("--provider", default="auto",
                    help="auto = gpu = cuda: the CUDA card (the default); cpu: the host")
    args = ap.parse_args(argv)

    from birdnet_tpu_torch.runtime import check_provider, resolve_device
    from birdnet_tpu_torch.utils.profiling import card_description

    device = resolve_device(check_provider(args.provider))
    model_path = args.model
    if model_path is None:
        cache = os.path.expanduser("~/.cache/birdnet_tpu_torch/bench")
        os.makedirs(cache, exist_ok=True)
        model_path = os.path.join(cache, "birdnet_v24_bench.onnx")
        if not os.path.exists(model_path):
            from birdnet_tpu_torch.models import birdnet_v24

            print("generating bench model...", file=sys.stderr)
            birdnet_v24.save(model_path)

    clf = build_classifier(model_path, args.precision, device)
    print(f"# card: {card_description(device)}", file=sys.stderr)
    print(f"device={clf.device} model={clf.model_type.name}", file=sys.stderr)

    rows = []
    for row in sweep(clf, _ints(args.batches), [float(x) for x in args.waits.split(",")],
                     _ints(args.workers), _ints(args.clients), args.seconds):
        rows.append(row)
        print(json.dumps(row), flush=True)
    # summary: best throughput row
    best = max(rows, key=lambda r: r["req_per_s"])
    print(f"# best: {json.dumps(best)}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
