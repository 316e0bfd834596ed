"""The port's spans and counters (birdnet_tpu_torch/utils/profiling.py's
recorder) along the streaming path on the CPU: ClassifierBuilder.build's span,
the classifier's and the stream engine's spans with their calls, the tile,
padded-row and result-row counters, the collector's time as a span's ``gc``
child, the spans in a torch.profiler trace inside the caller's own
annotation, two caller threads adding up, and answers untouched by the
recording."""

import contextlib
import gc
import json
import sys
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import birdnet_tpu_torch as tbt  # noqa: E402
from birdnet_tpu_torch import classifier as tclassifier  # noqa: E402
from birdnet_tpu_torch.compiler import stream as tstream  # noqa: E402
from birdnet_tpu_torch.models import birdnet_v24, perch_v2  # noqa: E402
from birdnet_tpu_torch.utils import profiling  # noqa: E402
from _torch_threads import torch_threads  # noqa: E402,F401

LABELS = [f"species_{i}" for i in range(10)]
RATE = 48_000
S = birdnet_v24.SAMPLE_COUNT
TILE = 4

# Spans of one streamed call on the host, by calls: once per call, once
# per superchunk, once per tile (eager tiles: no staging wait, no capture).
PER_CALL = ["birdnet.classifier.analyze_samples", "birdnet.classifier.results",
            "birdnet.stream.call", "birdnet.stream.lock_wait", "birdnet.stream.wait",
            "birdnet.stream.drain"]
PER_TILE = ["birdnet.stream.stage", "birdnet.stream.stage_copy", "birdnet.stream.upload",
            "birdnet.stream.replay"]


@pytest.fixture(scope="module")
def clf(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("spans") / "v24.onnx")
    birdnet_v24.save(path, num_species=10, width=0.1, depth=1, seed=0)
    before = profiling.snapshot()
    c = (tbt.Classifier.builder().model_path(path).labels(LABELS).top_k(3)
         .precision("fp32").with_device("cpu").build())
    c._streaming_engine().tile = TILE
    c.build_spans = profiling.snapshot() - before
    return c


def _pcm(segments, seed=0):
    """int16 audio of ``segments`` segments, the last one a partial."""
    rng = np.random.default_rng(seed)
    n = (segments - 1) * S + S // 3
    return (rng.normal(size=n) * 3000).clip(-32768, 32767).astype(np.int16)


def _recorded(fn, *args, **kwargs):
    before = profiling.snapshot()
    out = fn(*args, **kwargs)
    return out, profiling.snapshot() - before


def test_build_records_each_step_once(clf):
    """One ``birdnet.build`` span a build (what setup_build_s reads), and no
    span inside it: the warm-up the builder runs streams nothing."""
    spans = clf.build_spans
    assert {k: n for k, n in spans.calls.items() if not k.endswith(".gc")} == {"birdnet.build": 1}
    assert spans.seconds["birdnet.build"] > 0
    assert not spans.counters


@pytest.mark.parametrize("segments", [17, 20])
def test_one_call_records_its_spans_and_counters(clf, segments):
    """17 and 20 segments both take 5 tiles of 4: the counters follow the
    segments, and every span's calls the tiles alone."""
    collector_on = gc.isenabled()
    out, d = _recorded(clf.analyze_samples, _pcm(segments))
    assert len(out) == segments
    tiles = -(-segments // TILE)
    counters = {"birdnet.stream.tiles": tiles, "birdnet.stream.rows": tiles * TILE,
                "birdnet.stream.rows_padded": tiles * TILE - segments,
                "birdnet.stream.eager_tiles": tiles,
                "birdnet.classifier.result_rows": segments,
                "birdnet.classifier.results_paused": int(collector_on)}
    # A delta leaves out the counters that did not move.
    assert d.counters == {k: n for k, n in counters.items() if n}
    calls = {k: n for k, n in d.calls.items() if not k.endswith(".gc")}
    assert calls == {**{k: 1 for k in PER_CALL}, **{k: tiles for k in PER_TILE}}
    assert d.seconds["birdnet.classifier.results"] < d.seconds["birdnet.classifier.analyze_samples"]
    assert d.seconds["birdnet.stream.stage_copy"] <= d.seconds["birdnet.stream.stage"]


def test_embed_samples_records_its_call_and_no_results(tmp_path):
    path = str(tmp_path / "perch.onnx")
    perch_v2.save_tiny(path)
    perch = (tbt.Classifier.builder().model_path(path).labels([f"s{i}" for i in range(12)])
             .precision("fp32").with_device("cpu").build())
    samples = _pcm(3)[: 2 * perch.config.sample_count]
    (emb, _), d = _recorded(perch.embed_samples, samples)
    tile = perch._streaming_engine().tile
    assert d.calls["birdnet.classifier.embed_samples"] == 1
    assert "birdnet.classifier.results" not in d.calls
    assert d.counters["birdnet.stream.rows_padded"] == tile - len(emb)


def test_collection_inside_a_span_is_its_gc_child():
    before = profiling.snapshot()
    gc.collect()  # no span open: nothing recorded
    with profiling.span("birdnet.test.outer"):
        with profiling.span("birdnet.test.inner"):
            gc.collect()
        gc.collect()
    d = profiling.snapshot() - before
    assert not any(k.endswith(".gc") for k in d.calls if not k.startswith("birdnet.test."))
    assert d.calls["birdnet.test.inner.gc"] >= 1 and d.calls["birdnet.test.outer.gc"] >= 1
    assert 0 < d.seconds["birdnet.test.inner.gc"] <= d.seconds["birdnet.test.inner"]
    assert d.seconds["birdnet.test.outer"] >= (d.seconds["birdnet.test.inner"]
                                               + d.seconds["birdnet.test.outer.gc"])


def test_collections_at_every_call_stall_no_thread():
    """A collection due at nearly every allocation, so that the interpreter
    runs one (and the recorder's collector callback) at calls made while
    the recorder's lock is held, in 8 threads switching every 10 µs: every
    thread finishes and every span and count is there."""
    n_threads, n = 8, 200

    def work():
        for _ in range(n):
            with profiling.span("birdnet.test.stress"):
                junk = [[i] for i in range(16)]
                with profiling.span("birdnet.test.stress_inner"):
                    junk.append({})
                profiling.count("birdnet.test.stress_count")

    threshold, interval = gc.get_threshold(), sys.getswitchinterval()
    before = profiling.snapshot()
    threads = [threading.Thread(target=work, daemon=True) for _ in range(n_threads)]
    gc.set_threshold(1, 1000, 1000)
    sys.setswitchinterval(1e-5)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        gc.set_threshold(*threshold)
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    d = profiling.snapshot() - before
    assert d.calls["birdnet.test.stress"] == d.calls["birdnet.test.stress_inner"] == n_threads * n
    assert d.counters["birdnet.test.stress_count"] == n_threads * n
    assert d.calls["birdnet.test.stress.gc"] > 0


def test_spans_stand_in_the_trace_inside_the_callers_annotation(clf, tmp_path):
    pcm = _pcm(9)
    with profiling.trace(str(tmp_path)):
        with torch.profiler.record_function("caller.recording"):
            clf.analyze_samples(pcm)
    events = [e for e in json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
              if e.get("ph") == "X"]
    caller, = [e for e in events if e["name"] == "caller.recording"]
    spans = [e for e in events if e["name"].startswith("birdnet.")]
    assert {e["name"] for e in spans} == set(PER_CALL + PER_TILE)
    lo, hi = caller["ts"], caller["ts"] + caller["dur"]
    for e in spans:
        assert e["tid"] == caller["tid"] and e["pid"] == caller["pid"], e
        assert lo <= e["ts"] and e["ts"] + e["dur"] <= hi + 1e-3, e
    tiles = -(-9 // TILE)
    assert sum(e["name"] == "birdnet.stream.stage" for e in spans) == tiles
    (ordinal, name, tid), = json.loads((tmp_path / "spans.json").read_text())["calls"]
    assert name == "birdnet.classifier.analyze_samples" and tid == caller["tid"]


def test_two_caller_threads_add_up(clf):
    pcms = {17: _pcm(17, seed=1), 22: _pcm(22, seed=2)}
    alone = {n: clf.analyze_samples(p) for n, p in pcms.items()}
    got, errors = {}, []

    def call(n):
        try:
            got[n] = clf.analyze_samples(pcms[n])
        except Exception as e:  # noqa: BLE001 - reported by the test
            errors.append(e)

    before = profiling.snapshot()
    threads = [threading.Thread(target=call, args=(n,)) for n in pcms]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    d = profiling.snapshot() - before
    assert not errors and not any(t.is_alive() for t in threads)
    assert got == alone
    tiles = sum(-(-n // TILE) for n in pcms)
    assert d.counters["birdnet.stream.tiles"] == tiles
    assert d.counters["birdnet.stream.rows_padded"] == tiles * TILE - sum(pcms)
    assert all(d.calls[k] == 2 for k in PER_CALL)
    assert all(d.calls[k] == tiles for k in PER_TILE)


def test_answers_are_bitwise_those_without_the_recording(clf, monkeypatch):
    """The same call with the spans as they are, under a recording
    profiler, and with every span a no-op: the same numbers bit for bit."""
    pcm = _pcm(13, seed=5)
    eng = clf._streaming_engine()
    plain = eng.analyze(pcm, overlap_seconds=1.0)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        traced = eng.analyze(pcm, overlap_seconds=1.0)
        preds = clf.analyze_samples(pcm, overlap_seconds=1.0)
    nothing = lambda *a, **k: contextlib.nullcontext()  # noqa: E731
    monkeypatch.setattr(tstream, "span", nothing)
    monkeypatch.setattr(tstream, "count", lambda *a, **k: None)
    monkeypatch.setattr(tclassifier, "span", nothing)
    bare = eng.analyze(pcm, overlap_seconds=1.0)
    for a, b, c in zip(plain, traced, bare):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    assert preds == clf.analyze_samples(pcm, overlap_seconds=1.0)
