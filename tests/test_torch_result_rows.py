"""A streamed recording's result rows (birdnet_tpu_torch/classifier.py's
``top_k_rows_from_device``, built by ``Classifier._result_rows`` inside one
``collector_paused()`` block) on the CPU: the one-pass builder equals the
JAX package's per-row ``_mask_preds(top_k_from_device(...))`` element for
element; ``analyze_samples``, ``analyze_samples_iter`` and ``predict_batch``
give the rows the per-row loops give; the cyclic collector is left as the caller had it, when the
build raises, when two threads build at once and when a consumer abandons
the generator; and the result-row counters count what they say."""

import gc
import threading
from types import SimpleNamespace

import numpy as np
import pytest

pytest.importorskip("torch")

import birdnet_tpu_torch as tbt  # noqa: E402
from birdnet_tpu_torch import classifier as tclassifier  # noqa: E402
from birdnet_tpu_torch.classifier import Classifier, top_k_rows_from_device  # noqa: E402
from birdnet_tpu_torch.models import birdnet_v24  # noqa: E402
from birdnet_tpu_torch.postprocess import top_k_from_device  # noqa: E402
from birdnet_tpu.classifier import Classifier as JaxClassifier  # noqa: E402
from birdnet_tpu_torch.utils import profiling  # noqa: E402
from _torch_threads import torch_threads  # noqa: E402,F401

LABELS = [f"species_{i}" for i in range(10)]
S = birdnet_v24.SAMPLE_COUNT
TILE = 4
ROWS = "birdnet.classifier.result_rows"
PAUSED = "birdnet.classifier.results_paused"


def _mask_preds(c, predictions, row_mask):
    """The JAX package's per-row mask filter, the reference of the builder's."""
    return JaxClassifier._mask_preds(c, predictions, row_mask)


def _key(rows):
    """Rows as comparable values: a NaN confidence equals a NaN, and the
    types of the fields count."""
    return [[(p.species, repr(p.confidence), p.index, type(p.confidence), type(p.index))
             for p in row] for row in rows]


# Index 10 is the first past the labels; the masks end before the largest
# index (13), so an index past a mask's end must be dropped.
BUILD_MASK = np.array([True, False, True, True, False, True, True, True, False, True,
                       True, True])
CALL_MASK = np.array([True, True, False, True, True, True, False, True, True, True, True])
MASKS = {"none": (None, None), "build": (BUILD_MASK, None), "call": (None, CALL_MASK),
         "both": (BUILD_MASK, CALL_MASK)}


@pytest.mark.parametrize("shape", [(0, 5), (9, 1), (9, 5)], ids=["n0", "k1", "k5"])
@pytest.mark.parametrize("masks", list(MASKS), ids=list(MASKS))
@pytest.mark.parametrize("min_confidence", [None, 0.5])
def test_rows_equal_the_per_row_builder(shape, masks, min_confidence):
    rng = np.random.default_rng(shape[1])
    conf = rng.random(shape).astype(np.float32)
    conf[rng.random(shape) < 0.2] = np.nan
    conf[rng.random(shape) < 0.1] = 0.5  # on the min-confidence boundary
    conf[rng.random(shape) < 0.1] = 0.0  # a masked straggler's confidence
    idx = rng.integers(0, 14, size=shape).astype(np.int64)
    if shape[0]:
        conf[0, 0] = np.nan
        idx[0, 0], idx[-1, -1] = 10, 13  # at and past the labels' end
    species_mask, call_mask = MASKS[masks]
    clf = SimpleNamespace(_species_mask=species_mask)
    want = [_mask_preds(clf, top_k_from_device(conf[i], idx[i], LABELS, min_confidence),
                        call_mask) for i in range(shape[0])]
    got = top_k_rows_from_device(conf, idx, LABELS, min_confidence,
                                 Classifier._allowed(clf, call_mask))
    assert _key(got) == _key(want)


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("rows") / "v24.onnx")
    birdnet_v24.save(path, num_species=10, width=0.1, depth=1, seed=0)
    return path


def _classifier(path, **kw):
    b = (tbt.Classifier.builder().model_path(path).labels(LABELS).top_k(3)
         .precision("fp32").with_device("cpu"))
    if "species" in kw:
        b = b.species_list(kw["species"])
    if "min_confidence" in kw:
        b = b.min_confidence(kw["min_confidence"])
    c = b.build()
    c._streaming_engine().tile = TILE
    return c


@pytest.fixture(scope="module")
def clf(model):
    return _classifier(model)


@pytest.fixture
def collector_on():
    was_on = gc.isenabled()
    gc.enable()
    yield
    # As it was before the test, whatever the test left.
    (gc.enable if was_on else gc.disable)()


def _pcm(segments, seed=0):
    rng = np.random.default_rng(seed)
    n = (segments - 1) * S + S // 3
    return (rng.normal(size=n) * 3000).clip(-32768, 32767).astype(np.int16)


def _per_row(c, conf, idx, mask):
    return [_mask_preds(c, top_k_from_device(conf[i], idx[i], c._labels, c._min_confidence),
                        mask) for i in range(conf.shape[0])]


def _analyze_per_row(c, samples, overlap, mask):
    """``analyze_samples``' rows as its per-row loop built them."""
    conf, idx, times = c._streaming_engine().analyze(samples, overlap, species_mask=mask)
    return [(float(times[i]), p) for i, p in enumerate(_per_row(c, conf, idx, mask))]


def _iter_per_row(c, samples, overlap, chunk, mask):
    """``analyze_samples_iter``'s rows as its per-row loop built them."""
    eng, cfg = c._streaming_engine(), c.config
    step = cfg.sample_count - int(overlap * cfg.sample_rate)
    n_segments = -(-samples.shape[0] // step)
    out = []
    for seg0 in range(0, n_segments, chunk):
        seg1 = min(seg0 + chunk, n_segments)
        lo, hi = seg0 * step, (seg1 - 1) * step + cfg.sample_count
        conf, idx, times = eng.analyze(samples[lo:hi], overlap, n_segments=seg1 - seg0,
                                       species_mask=mask)
        t0 = lo / cfg.sample_rate
        out += [(t0 + float(times[i]), p) for i, p in enumerate(_per_row(c, conf, idx, mask))]
    return out


def _rows_key(rows):
    return [(t, k) for (t, _), k in zip(rows, _key([p for _, p in rows]))]


@pytest.mark.parametrize("form", ["plain", "masked"])
def test_streamed_rows_are_those_of_the_per_row_loops(model, clf, form):
    """The build-time species list and a per-call mask leave fewer allowed
    species than top-K, so masked stragglers surface and are dropped."""
    c, mask = clf, None
    if form == "masked":
        c = _classifier(model, species=LABELS[2:4], min_confidence=0.2)
        mask = np.zeros(len(LABELS), dtype=bool)
        mask[[3, 5]] = True
    pcm = _pcm(11, seed=3)
    for overlap in (0.0, 1.5):
        got = c.analyze_samples(pcm, overlap_seconds=overlap, species_mask=mask)
        assert _rows_key(got) == _rows_key(_analyze_per_row(c, pcm, overlap, mask))
        it = list(c.analyze_samples_iter(pcm, overlap_seconds=overlap, chunk_segments=5,
                                         species_mask=mask))
        assert _rows_key(it) == _rows_key(_iter_per_row(c, pcm, overlap, 5, mask))
    if form == "masked":
        assert all({p.index for p in preds} <= {3} for _, preds in got)


@pytest.mark.parametrize("form", ["plain", "masked"])
def test_predicted_rows_are_those_of_the_per_row_builder(model, clf, form):
    """``predict_batch`` builds each segment's one row through the same
    builder, with the segment's own mask."""
    c, masks = clf, None
    if form == "masked":
        c = _classifier(model, species=LABELS[:6])
        masks = np.zeros((3, len(LABELS)), dtype=bool)
        masks[0, [3, 5]] = masks[1, [2]] = masks[2, [4, 5, 7]] = True
    segs = _pcm(4, seed=5)[:3 * S].reshape(3, S).astype(np.float32) / 32768
    conf, idx, _, _ = c._engine.run_batch(segs, row_masks=masks)
    want = _per_row(c, conf, idx, None) if masks is None else [
        _per_row(c, conf[i:i + 1], idx[i:i + 1], masks[i])[0] for i in range(3)]
    got = [r.predictions for r in c.predict_batch(segs, species_masks=masks)]
    assert _key(got) == _key(want)
    if form == "masked":  # the masked stragglers surfaced, and were dropped
        assert [len(p) for p in got] == [2, 1, 2]


@pytest.mark.parametrize("before", [True, False], ids=["on", "off"])
def test_the_collector_is_left_as_it_was(clf, collector_on, before):
    """On after the call if it was on, off if the caller had turned it off;
    the pause is counted only where it turned the collector off."""
    if not before:
        gc.disable()
    snap = profiling.snapshot()
    out = clf.analyze_samples(_pcm(6))
    d = profiling.snapshot() - snap
    assert gc.isenabled() is before
    assert d.counters[ROWS] == len(out) == 6
    assert d.counters.get(PAUSED, 0) == int(before)


@pytest.mark.parametrize("before", [True, False], ids=["on", "off"])
def test_the_collector_is_left_as_it_was_when_the_build_raises(clf, collector_on, monkeypatch,
                                                                 before):
    def fails(*args, **kwargs):
        assert not gc.isenabled()
        raise RuntimeError("row build failed")

    if not before:
        gc.disable()
    monkeypatch.setattr(tclassifier, "top_k_rows_from_device", fails)
    with pytest.raises(RuntimeError, match="row build failed"):
        clf.analyze_samples(_pcm(3))
    assert gc.isenabled() is before


def test_two_threads_building_at_once(clf, collector_on, monkeypatch):
    """Both builds inside their pauses at the same moment (a barrier inside
    the builder): the collector is off in both, on again after the second
    ends, and the pause is counted once, for the build that turned it off."""
    pcms = [_pcm(7, seed=1), _pcm(9, seed=2)]
    alone = [clf.analyze_samples(p) for p in pcms]
    both_inside = threading.Barrier(2, timeout=60)
    build = tclassifier.top_k_rows_from_device

    def meets(*args, **kwargs):
        assert not gc.isenabled()
        both_inside.wait()
        rows = build(*args, **kwargs)
        both_inside.wait()
        assert not gc.isenabled()
        return rows

    monkeypatch.setattr(tclassifier, "top_k_rows_from_device", meets)
    got, errors = [None, None], []

    def call(i):
        try:
            got[i] = clf.analyze_samples(pcms[i])
        except Exception as e:  # noqa: BLE001 - reported by the test
            errors.append(e)

    snap = profiling.snapshot()
    threads = [threading.Thread(target=call, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    d = profiling.snapshot() - snap
    assert not errors and not any(t.is_alive() for t in threads)
    assert gc.isenabled()
    assert _rows_key(got[0]) == _rows_key(alone[0]) and _rows_key(got[1]) == _rows_key(alone[1])
    assert d.counters[ROWS] == 16 and d.counters[PAUSED] == 1


def test_an_abandoned_iterator_leaves_the_collector_on(clf, collector_on):
    """Rows are yielded outside the pause: a consumer that stops after the
    first row, and one that drops the generator, leave the collector on."""
    snap = profiling.snapshot()
    it = clf.analyze_samples_iter(_pcm(10), chunk_segments=4)
    next(it)
    assert gc.isenabled()
    d = profiling.snapshot() - snap
    assert d.counters[ROWS] == 4 and d.counters[PAUSED] == 1
    del it
    assert gc.isenabled()


def test_the_iterator_counts_each_chunk(clf, collector_on):
    snap = profiling.snapshot()
    rows = list(clf.analyze_samples_iter(_pcm(10), chunk_segments=4))
    d = profiling.snapshot() - snap
    assert d.counters[ROWS] == len(rows) == 10
    assert d.counters[PAUSED] == 3
