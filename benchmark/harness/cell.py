"""One run of one cell: set-up, the measured window, the check and the
result line.

Set-up makes the recordings' audio and the model's weights from the seed on
the device (each batch norm's statistics set from the seed's audio by the
plain reference, :func:`benchmark.harness.program.calibrated`, whose
seconds ``setup_s`` leaves out and the result prints apart), writes the
model file into the run's temporary directory, builds the program through
its normal path (on a checkout's first run the program builds its kernels
here, and the result says so), and makes two warm calls of the cell's own
call on a recording of the cell's own length, so that the window captures
and compiles nothing. The window is a closed loop of one caller:
one recording per call, back to back, from the first call until the
return of the first call that ends past ``seconds``. With ``trace`` the
probe's wrappers time the program's host steps over the window and
torch.profiler traces a stretch of whole recordings inside it.

Once the window has closed: the peak device memory is read, the program is
freed, and the plain reference checks the answers kept for a seeded sample
of recordings and segments (:mod:`benchmark.harness.check`).
"""

from __future__ import annotations

import contextlib
import gc
import importlib
import tempfile
import time
from typing import Callable, Optional

from . import check as checks
from . import context, spec
from .audio import Recordings
from .program import build_classifier, calibrated, generator_module, write_model
from .roofline import forward_flops
from .trace import PREFIX, Probe, Stretch, export_events

WARM_CALLS = 2
TRACE_SKIP, TRACE_RECORDINGS = 2, 4


def run(workload: str, seed: int, seconds: float, trace: bool, t_start: float,
        device: str = "cuda", cell: Optional[spec.Cell] = None, int8: bool = False,
        patches: Optional[Callable] = None, keep_rows: bool = False) -> dict:
    """The result line's object, its compared numbers under ``checks``.
    ``cell`` replaces the one ``BENCHMARK.json`` names (the tests' small
    sizes); ``int8`` builds the program with its int8 path switched on (the
    control); ``patches`` is a context manager factory entered around the
    window (the tests' planted faults)."""
    import torch

    from ..models.weights import draw

    cell = cell or spec.load(workload)
    cfg, traffic = cell.config, cell.traffic
    call = importlib.import_module(f"benchmark.calls.{traffic['call']}")
    on_card = device != "cpu"

    kernels_built = on_card and not _kernels_on_disk()
    gb = generator_module(cfg).build(cfg)
    recordings = Recordings(traffic, cfg, seed, device)
    weights = draw(gb.specs, seed, device)
    t_cal = time.perf_counter()
    weights = calibrated(cfg, weights, recordings, device)
    calibration_s = time.perf_counter() - t_cal
    with tempfile.TemporaryDirectory() as tmp:
        path = write_model(cfg, gb, weights, tmp)
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        calibration = recordings.warm() if int8 else None
        clf = build_classifier(cfg, path, device, int8_calibration=calibration)
    for _ in range(WARM_CALLS):
        call.invoke(clf, recordings.warm(), traffic)
    if on_card:
        torch.cuda.synchronize()

    probe = Probe() if trace else None
    profile = None
    stretch_lo, stretch_hi = TRACE_SKIP, TRACE_SKIP + TRACE_RECORDINGS
    kept, last, result = [], None, None
    latencies, segments, attempted, failed = [], 0, 0, 0
    stretch_segments, stretch_calls0, stretch_calls = 0, {}, {}
    gc.collect()
    pauses = _GcPauses()
    with (patches() if patches else contextlib.nullcontext()), pauses:
        if probe:
            probe.install()
        t0 = time.perf_counter()
        setup_s = t0 - t_start - calibration_s
        end = t0
        try:
            while end - t0 < seconds or (trace and attempted < stretch_hi):
                if trace and attempted == stretch_lo:
                    activities = [torch.profiler.ProfilerActivity.CPU]
                    if on_card:
                        activities.append(torch.profiler.ProfilerActivity.CUDA)
                    profile = torch.profiler.profile(activities=activities)
                    profile.start()
                    probe.annotate = True
                    stretch_calls0 = probe.snapshot()
                recording = recordings.next()
                ordinal = attempted
                attempted += 1
                start = time.perf_counter()
                try:
                    with (torch.profiler.record_function(PREFIX + "call") if profile
                          else contextlib.nullcontext()):
                        result = call.invoke(clf, recording, traffic)
                    n = call.count(result)
                except Exception as e:  # noqa: BLE001 - a failed call counts, the loop goes on
                    result, n = None, -1
                    print(f"recording {ordinal}: {type(e).__name__}: {e}", flush=True)
                end = time.perf_counter()
                latencies.append(end - start)
                if n != recordings.n_segments:
                    failed += 1
                else:
                    segments += n
                    if profile is not None and ordinal < stretch_hi:
                        stretch_segments += n
                    if recordings.kept(ordinal):
                        kept.append((recording, result))
                        last = None
                    else:
                        last = (recording, result)
                if trace and ordinal == stretch_hi - 1:
                    if on_card:
                        torch.cuda.synchronize()
                    probe.annotate = False
                    profile.stop()
                    stretch_calls = {k: v - stretch_calls0.get(k, 0)
                                     for k, v in probe.snapshot().items()}
        finally:
            if probe:
                probe.uninstall()
    window_s = end - t0
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    if last is not None:
        kept.append(last)

    traced = None
    if trace:
        traced = context.Traced(
            probe_seconds=dict(probe.seconds), probe_calls=dict(probe.calls),
            stretch=Stretch(export_events(profile)), stretch_calls=stretch_calls,
            stretch_segments=stretch_segments, rows=probe.rows,
            flops_per_segment=forward_flops(gb, cfg["sample_count"]))
    del clf, result
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    rows = checks.compare(cfg, weights, kept, recordings, call, device)
    numbers = call.numbers(rows, cfg) if rows else {}
    judged = checks.judge(numbers, cfg.get("limits", {}))
    ctx = context.Context(cfg=cfg, traffic=traffic, window=context.Window(
        seconds=window_s, latencies_s=latencies, segments=segments, setup_s=setup_s,
        peak_bytes=peak, gc_pause_s=pauses.seconds), traced=traced)
    units = spec.units(cell)
    values = context.read([m["name"] for m in cell.metrics(trace)], ctx)
    out = {
        "correct": failed == 0 and bool(judged) and all(c["ok"] for c in judged.values()),
        "attempted": attempted,
        "failed": failed,
        "metrics": {k: {"value": v, "unit": units[k]} for k, v in values.items()},
        "device": device_info(device, peak, traced),
    }
    if traced:
        out["breakdown"] = {"device_ops": traced.stretch.device_ops(),
                            "idle_gaps": traced.stretch.idle_gaps()}
    lat_ms = sorted(1e3 * x for x in latencies)
    out["window"] = {"recordings": len(lat_ms), "seconds": window_s,
                     "p50_ms": lat_ms[len(lat_ms) // 2] if lat_ms else None,
                     "p95_ms": context.read(["recording_p95_ms"], ctx).get("recording_p95_ms"),
                     "max_ms": lat_ms[-1] if lat_ms else None,
                     "gc_pause_s": pauses.seconds, "gc_gen2": pauses.gen2,
                     "calibration_s": calibration_s, "kernels_built": kernels_built}
    if keep_rows:
        out["rows"] = {k: v.tolist() for k, v in rows.items()}
    out["checks"] = {k: {"value": c["value"], "limit": c["limit"]} for k, c in judged.items()}
    return out


def _kernels_on_disk() -> bool:
    """Whether the program's kernel library is already built in this
    checkout: where it is not, the run's set-up builds it (nvcc), and
    ``setup_s`` of that run stands apart from the others'."""
    from birdnet_tpu_torch.ops.cuda import build

    return build.library_path().exists()


class _GcPauses:
    """Seconds the interpreter's cyclic collector ran while entered, and
    its full (generation 2) collections: printed beside the window."""

    def __init__(self):
        self.seconds, self.gen2, self._t = 0.0, 0, None

    def _callback(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        elif self._t is not None:
            self.seconds += time.perf_counter() - self._t
            self.gen2 += info.get("generation") == 2

    def __enter__(self):
        gc.callbacks.append(self._callback)
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self._callback)


def power_limit():
    """The card's power limit as nvidia-smi gives it ("700.00 W"), or None:
    a card held below its maximum runs slower under load, so every result
    carries it beside the card's name."""
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0] if out.returncode == 0 and lines else None


def device_info(device: str, peak: int, traced) -> dict:
    import torch

    if device == "cpu":
        info = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    else:
        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(), "count": 1,
                "memory_peak_bytes": int(peak), "power_limit": power_limit()}
    if traced:
        info.update(busy_s=traced.stretch.busy_s, window_s=traced.stretch.window_s)
    return info
