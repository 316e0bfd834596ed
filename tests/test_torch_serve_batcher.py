"""The port's DynamicBatcher (birdnet_tpu_torch/serve/batcher.py) on the
CPU, beside the JAX package's on the same tiny models and segments:
coalescing, the batching window, queue-full rejection, close with and
without drain, per-request species masks, Perch's padding path, an error in
one batch reaching every future, and two workers. Both batchers' results
agree: the same species and indices, confidences and embeddings within
1e-4 (fp32)."""

import threading
import time
from concurrent.futures import Future

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import birdnet_tpu.errors as JE  # noqa: E402
import birdnet_tpu_torch.errors as TE  # noqa: E402
from _torch_serve_common import (  # noqa: E402
    CONF_TOL,
    LABELS10,
    LABELS12,
    classifiers,
    save_models,
    segment,
)
from birdnet_tpu.serve import DynamicBatcher as JBatcher  # noqa: E402
from birdnet_tpu_torch.serve import DynamicBatcher as TBatcher  # noqa: E402
from birdnet_tpu_torch.serve.batcher import _resolve_future  # noqa: E402

PACKAGES = {"torch": (TBatcher, TE), "jax": (JBatcher, JE)}


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    return save_models(tmp_path_factory.mktemp("torch_serve_batcher"))


@pytest.fixture(scope="module")
def v24(paths):
    """{"torch": port classifier, "jax": JAX classifier}, tiny v2.4."""
    t, j = classifiers(paths["v24"], LABELS10)
    return {"torch": t, "jax": j}


@pytest.fixture(scope="module")
def perch(paths):
    t, j = classifiers(paths["perch"], LABELS12)
    return {"torch": t, "jax": j}


def _segs(clf, n, seed=0):
    return [segment(clf.config.sample_count, seed + i) for i in range(n)]


def _assert_results_agree(got, want, tol=CONF_TOL):
    """The port's PredictionResults against the JAX package's."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert [p.index for p in g.predictions] == [p.index for p in w.predictions]
        assert [p.species for p in g.predictions] == [p.species for p in w.predictions]
        np.testing.assert_allclose([p.confidence for p in g.predictions],
                                   [p.confidence for p in w.predictions], rtol=0, atol=tol)
        if w.embeddings is None:
            assert g.embeddings is None
        else:
            np.testing.assert_allclose(g.embeddings, w.embeddings, rtol=0, atol=tol)


class _Gated:
    """A classifier whose batch calls wait for ``gate`` (or raise
    ``fault``), so that a test decides when a batch finishes."""

    def __init__(self, clf, fault=None):
        self._clf = clf
        self.fault = fault
        self.gate = threading.Event()
        self.entered = threading.Event()

    def __getattr__(self, name):
        return getattr(self._clf, name)

    def _enter(self):
        self.entered.set()
        assert self.gate.wait(60)
        if self.fault is not None:
            raise self.fault

    def predict_batch_with_context(self, *args, **kwargs):
        self._enter()
        return self._clf.predict_batch_with_context(*args, **kwargs)

    def predict_batch(self, *args, **kwargs):
        self._enter()
        return self._clf.predict_batch(*args, **kwargs)


def test_single_request_matches_jax_and_direct_predict(v24):
    seg = segment(v24["torch"].config.sample_count)
    served = {}
    for name, (Batcher, _) in PACKAGES.items():
        with Batcher(v24[name], max_batch=8, max_wait_ms=1) as b:
            served[name] = b.predict(seg, timeout=60)
    _assert_results_agree([served["torch"]], [served["jax"]])
    _assert_results_agree([served["torch"]], [v24["torch"].predict(seg)], tol=1e-5)


def test_concurrent_requests_coalesce(v24):
    n = 16
    segs = _segs(v24["torch"], n, seed=10)
    results, stats = {}, {}
    for name, (Batcher, _) in PACKAGES.items():
        with Batcher(v24[name], max_batch=16, max_wait_ms=200) as b:
            futures = [b.submit(s) for s in segs]
            results[name] = [f.result(timeout=120) for f in futures]
            stats[name] = b.metrics.snapshot()
    for name in PACKAGES:
        assert stats[name]["requests_total"] == n
        assert stats[name]["segments_total"] == n
        assert stats[name]["batches_total"] <= 4
        assert stats[name]["mean_batch_fill"] >= n / 4
    _assert_results_agree(results["torch"], results["jax"])
    _assert_results_agree(results["torch"], v24["torch"].predict_batch(segs), tol=1e-5)


class _Timed:
    """A classifier that records how long each of its batch calls (the
    forward the batcher runs) takes."""

    def __init__(self, clf):
        self._clf = clf
        self.seconds = []

    def __getattr__(self, name):
        return getattr(self._clf, name)

    def _timed(self, fn, *args, **kwargs):
        t0 = time.monotonic()
        try:
            return fn(*args, **kwargs)
        finally:
            self.seconds.append(time.monotonic() - t0)

    def predict_batch_with_context(self, *args, **kwargs):
        return self._timed(self._clf.predict_batch_with_context, *args, **kwargs)

    def predict_batch(self, *args, **kwargs):
        return self._timed(self._clf.predict_batch, *args, **kwargs)


# A request's time in a zero-window batcher past its own forward: the queue
# and a thread's wake-up, well under the 600 ms window.
QUEUE_MARGIN_S = 0.3


def test_max_wait_holds_a_lone_request_for_company(v24):
    """A lone request waits out the window (measured from its submit) and
    then runs in a batch of one; with max_wait_ms=0 it runs at once: its
    time in the batcher past the forward it ran is under QUEUE_MARGIN_S,
    whatever that forward took on a loaded host."""
    seg = segment(v24["torch"].config.sample_count, 3)
    for name, (Batcher, _) in PACKAGES.items():
        with Batcher(v24[name], max_batch=8, max_wait_ms=600) as b:
            b.predict(seg, timeout=60)  # the first call may build lazily
            b.metrics.reset()
            t0 = time.monotonic()
            b.predict(seg, timeout=60)
            waited = time.monotonic() - t0
            snap = b.metrics.snapshot()
        assert waited >= 0.6, (name, waited)
        assert snap["batches_total"] == 1 and snap["mean_batch_fill"] == 1.0, name
        timed = _Timed(v24[name])
        with Batcher(timed, max_batch=8, max_wait_ms=0) as b:
            b.predict(seg, timeout=60)
            t0 = time.monotonic()
            b.predict(seg, timeout=60)
            took = time.monotonic() - t0
        forward = timed.seconds[-1]
        assert len(timed.seconds) == 2 and took - forward < QUEUE_MARGIN_S, (name, took, forward)


def test_submit_validates_in_caller_thread(v24):
    messages = {}
    for name, (Batcher, E) in PACKAGES.items():
        clf = v24[name]
        with Batcher(clf, max_batch=4) as b:
            with pytest.raises(E.InputSizeError) as size:
                b.submit(np.zeros(100, np.float32))
            with pytest.raises(E.InputSizeError) as mask:
                b.submit(segment(clf.config.sample_count), species_mask=np.ones(3, bool))
            assert len(b.predict(segment(clf.config.sample_count), timeout=60).predictions) == 3
            assert b.metrics.snapshot()["requests_total"] == 1
        messages[name] = (str(size.value), str(mask.value))
    assert messages["torch"] == messages["jax"]


def test_queue_full_rejects(v24):
    """With the worker held off the queue (the test holds the batcher's
    condition, which submit re-enters), the second request finds the
    one-slot queue full."""
    messages = {}
    for name, (Batcher, E) in PACKAGES.items():
        clf = v24[name]
        b = Batcher(clf, max_batch=1, max_wait_ms=0, max_queue=1)
        try:
            seg = segment(clf.config.sample_count, 4)
            with b._cond:
                first = b.submit(seg)
                with pytest.raises(E.InferenceError) as err:
                    b.submit(seg)
            assert first.result(timeout=60) is not None
            assert b.metrics.snapshot()["rejected_total"] == 1
            messages[name] = str(err.value)
        finally:
            b.close()
    assert "overloaded" in messages["torch"]
    assert messages["torch"] == messages["jax"]


def test_close_drains_pending(v24):
    for name, (Batcher, E) in PACKAGES.items():
        clf = v24[name]
        b = Batcher(clf, max_batch=4, max_wait_ms=50)
        futures = [b.submit(s) for s in _segs(clf, 6, seed=20)]
        b.close()  # drain=True: everything completes
        for f in futures:
            assert f.result(timeout=1) is not None
        with pytest.raises(E.InferenceError, match="closed"):
            b.submit(segment(clf.config.sample_count))
        b.close()  # a second close is a no-op


def test_close_without_drain_fails_queued_requests(v24):
    """The batch in flight finishes; requests still queued fail with
    InferenceError, in both packages with the same message."""
    messages = {}
    for name, (Batcher, E) in PACKAGES.items():
        gated = _Gated(v24[name])
        b = Batcher(gated, max_batch=1, max_wait_ms=0)
        segs = _segs(gated, 3, seed=30)
        running = b.submit(segs[0])
        assert gated.entered.wait(60)
        queued = [b.submit(s) for s in segs[1:]]
        closer = threading.Thread(target=b.close, kwargs={"drain": False})
        closer.start()
        for f in queued:
            with pytest.raises(E.InferenceError) as err:
                f.result(timeout=60)
        gated.gate.set()
        closer.join(timeout=60)
        assert not closer.is_alive()
        assert running.result(timeout=1) is not None
        messages[name] = str(err.value)
    assert messages["torch"] == messages["jax"]
    assert "batcher closed before execution" in messages["torch"]


@pytest.mark.parametrize("model", ["v24", "perch"])
def test_error_in_one_batch_reaches_every_future(v24, perch, model):
    """A device fault in one batch fails each of its requests with that
    exception and counts one error; the worker lives on."""
    for name, (Batcher, _) in PACKAGES.items():
        clf = {"v24": v24, "perch": perch}[model][name]
        fault = RuntimeError("device fault")
        gated = _Gated(clf, fault=fault)
        b = Batcher(gated, max_batch=4, max_wait_ms=0)
        try:
            with b._cond:  # the four requests coalesce into one batch
                futures = [b.submit(s) for s in _segs(clf, 4, seed=40)]
            gated.gate.set()
            for f in futures:
                assert f.exception(timeout=60) is fault
            snap = b.metrics.snapshot()
            assert snap["errors_total"] == 1 and snap["batches_total"] == 0
            gated.fault = None
            assert b.predict(segment(clf.config.sample_count), timeout=60) is not None
        finally:
            b.close()


def test_per_request_species_masks_coalesce(v24):
    """Requests with different masks (and none) share one batch; each gets
    top-K from its own candidates, as the JAX batcher gives them."""
    n_species = v24["torch"].config.num_species
    masks = [None, np.isin(np.arange(n_species), [2, 6]), np.isin(np.arange(n_species), [1, 4, 8]),
             None]
    segs = _segs(v24["torch"], len(masks), seed=50)
    results = {}
    for name, (Batcher, _) in PACKAGES.items():
        with Batcher(v24[name], max_batch=8, max_wait_ms=0) as b:
            with b._cond:
                futures = [b.submit(s, species_mask=m) for s, m in zip(segs, masks)]
            results[name] = [f.result(timeout=60) for f in futures]
            assert b.metrics.snapshot()["batches_total"] == 1
    _assert_results_agree(results["torch"], results["jax"])
    for r, m in zip(results["torch"], masks):
        if m is not None:
            assert {p.index for p in r.predictions} <= set(np.flatnonzero(m))
            assert len(r.predictions) == min(3, int(m.sum()))


def test_perch_pads_to_max_batch(perch):
    """Perch v2 has no batch context in either package: the batcher pads
    the batch to max_batch and calls predict_batch; results (embeddings
    included) equal predict_batch on the padded batch."""
    clf = perch["torch"]
    segs = _segs(clf, 3, seed=60)
    results = {}
    for name, (Batcher, _) in PACKAGES.items():
        with Batcher(perch[name], max_batch=4, max_wait_ms=0) as b:
            assert list(b._contexts) == [None]
            with b._cond:
                futures = [b.submit(s) for s in segs]
            results[name] = [f.result(timeout=120) for f in futures]
    _assert_results_agree(results["torch"], results["jax"])
    padded = segs + [np.zeros(clf.config.sample_count, np.float32)]
    want = clf.predict_batch(padded)[:3]
    for g, w in zip(results["torch"], want):
        np.testing.assert_array_equal(g.raw_scores, w.raw_scores)
        np.testing.assert_array_equal(g.embeddings, w.embeddings)


def test_two_workers_parity_and_progress(v24):
    n = 12
    segs = _segs(v24["torch"], n, seed=70)
    results = {}
    for name, (Batcher, _) in PACKAGES.items():
        with Batcher(v24[name], max_batch=4, max_wait_ms=1, workers=2) as b:
            assert len(b._workers) == 2 and len(b._contexts) == 2
            futures = [b.submit(s) for s in segs]
            results[name] = [f.result(timeout=300) for f in futures]
            assert b.metrics.snapshot()["segments_total"] == n
    _assert_results_agree(results["torch"], results["jax"])


def test_metrics_snapshot_matches_jax(v24):
    snaps = {}
    for name, (Batcher, _) in PACKAGES.items():
        with Batcher(v24[name], max_batch=4, max_wait_ms=1) as b:
            for i in range(3):
                b.predict(segment(v24[name].config.sample_count, 80 + i), timeout=60)
            snaps[name] = b.metrics.snapshot()
            b.metrics.reset()
            assert b.metrics.snapshot()["requests_total"] == 0
    assert snaps["torch"].keys() == snaps["jax"].keys()
    for name in PACKAGES:
        assert snaps[name]["latency_p50_ms"] > 0
        assert snaps[name]["requests_total"] == snaps[name]["segments_total"] == 3


def test_bad_arguments_raise_as_in_jax(v24):
    for name, (Batcher, E) in PACKAGES.items():
        with pytest.raises(E.InferenceError, match="max_batch"):
            Batcher(v24[name], max_batch=0)
        with pytest.raises(E.InferenceError, match="workers"):
            Batcher(v24[name], workers=0)


def test_resolve_future_tolerates_cancel():
    f = Future()
    assert f.cancel()
    _resolve_future(f, result=1)  # no raise
    f2 = Future()
    _resolve_future(f2, result=42)
    assert f2.result(timeout=0) == 42
    f3 = Future()
    _resolve_future(f3, exception=RuntimeError("boom"))
    with pytest.raises(RuntimeError):
        f3.result(timeout=0)
