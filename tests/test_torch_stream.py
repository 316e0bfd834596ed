"""The port's streaming path (birdnet_tpu_torch/compiler/stream.py and the
classifier's analyze methods) on the CPU at fp32, tile 32, against the JAX
package on the tiny v2.4 conv and STFT files, and against the port's own
``predict_batch`` on the same segments. The cases follow
tests/test_stream.py. fp32 rule: top-K indices equal, confidences within
1e-4 (the sigmoid only shrinks the logits' 1e-4)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import birdnet_tpu as jbt  # noqa: E402
import birdnet_tpu_torch as tbt  # noqa: E402
from birdnet_tpu_torch.compiler import stream as tstream  # noqa: E402
from birdnet_tpu_torch.models import birdnet_v24  # noqa: E402

LABELS = [f"species_{i}" for i in range(10)]
RATE = 48_000
S = birdnet_v24.SAMPLE_COUNT


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    d = tmp_path_factory.mktemp("stream_models")
    out = {}
    for frontend in ("conv", "stft"):
        out[frontend] = str(d / f"v24_{frontend}.onnx")
        birdnet_v24.save(out[frontend], num_species=10, width=0.1, depth=1, seed=0,
                         frontend=frontend)
    return out


def _build(pkg, path, **kw):
    b = pkg.Classifier.builder().model_path(path).labels(LABELS).top_k(3).precision("fp32")
    if "min_confidence" in kw:
        b = b.min_confidence(kw["min_confidence"])
    if "species" in kw:
        b = b.species_list(kw["species"])
    if pkg is tbt:
        b = b.with_device("cpu")
    return b.build()


@pytest.fixture(scope="module")
def pair(paths):
    """(port classifier, JAX classifier) per frontend form."""
    return {f: (_build(tbt, p), _build(jbt, p)) for f, p in paths.items()}


def _audio(seconds, seed=0):
    rng = np.random.default_rng(seed)
    n = int(RATE * seconds)
    return (0.3 * np.sin(2 * np.pi * 800 * np.arange(n) / RATE)
            + 0.05 * rng.normal(size=n)).astype(np.float32)


def _jax(fn, *args, **kw):
    with jax.default_matmul_precision("highest"):
        return fn(*args, **kw)


def _same(got, want, conf_tol=1e-4):
    assert len(got) == len(want)
    for (t, preds), (t_ref, ref) in zip(got, want):
        assert t == pytest.approx(t_ref)
        assert [p.index for p in preds] == [p.index for p in ref]
        assert [p.species for p in preds] == [p.species for p in ref]
        np.testing.assert_allclose([p.confidence for p in preds],
                                   [p.confidence for p in ref], rtol=0, atol=conf_tol)


@pytest.mark.parametrize("frontend", ["conv", "stft"])
@pytest.mark.parametrize("seconds,overlap", [
    pytest.param(2.0, 0.0, id="under-one-segment"),
    pytest.param(9.0, 0.0, id="at-a-multiple"),
    pytest.param(10.0, 0.0, id="past-a-multiple"),
    pytest.param(10.0, 1.5, id="overlap-1.5s"),
])
def test_stream_matches_jax(pair, frontend, seconds, overlap):
    mine, theirs = pair[frontend]
    samples = _audio(seconds)
    got = mine.analyze_samples(samples, overlap_seconds=overlap)
    _same(got, _jax(theirs.analyze_samples, samples, overlap_seconds=overlap))
    assert len(got) == -(-samples.shape[0] // (S - int(overlap * RATE)))


@pytest.mark.parametrize("frontend", ["conv", "stft"])
def test_stream_int16_matches_jax(pair, frontend):
    mine, theirs = pair[frontend]
    i16 = (np.clip(_audio(7.5), -1, 1 - 1 / 32768) * 32768).astype(np.int16)
    got = mine.analyze_samples(i16)
    _same(got, _jax(theirs.analyze_samples, i16))
    _same(got, mine.analyze_samples(i16.astype(np.float32) / 32768.0))


@pytest.mark.parametrize("float_or_int8", ["float", "int8"])
def test_stream_matches_own_predict_batch(paths, pair, float_or_int8):
    """The port's stream against its own predict_batch on the same
    segments framed on the host, for a float and an int8 classifier."""
    if float_or_int8 == "float":
        clf = pair["conv"][0]
    else:
        clf = (tbt.Classifier.builder().model_path(paths["conv"]).labels(LABELS)
               .top_k(3).precision("fp32").with_device("cpu").int8().build())
    samples = _audio(10.0, seed=3)
    segs, times = tbt.chunk_audio(samples, S, 1.5, RATE)
    want = [(t, r.predictions) for t, r in zip(times, clf.predict_batch(segs))]
    _same(clf.analyze_samples(samples, overlap_seconds=1.5), want)


def test_several_superchunks(pair, monkeypatch):
    """Superchunks of two segments (tile 1, two tiles) reassemble into the
    rows of one; without a monitor the loop waits on every chunk once (the
    second-oldest at each dispatch, then the last)."""
    mine, theirs = pair["conv"]
    samples = _audio(20.0)
    want = _jax(theirs.analyze_samples, samples, overlap_seconds=1.5)
    eng = mine._streaming_engine()
    monkeypatch.setattr(eng, "tile", 1)
    monkeypatch.setattr(tstream, "MAX_TILES", 2)
    waits = []
    real_wait = tstream._wait
    monkeypatch.setattr(tstream, "_wait",
                        lambda *a: waits.append(a[1]) or real_wait(*a))
    got = mine.analyze_samples(samples, overlap_seconds=1.5)
    _same(got, want)
    assert len(got) == 14 and len(waits) == 7


def test_monitored_superchunks_are_bounded(pair, monkeypatch):
    """With a cancellation token the superchunks shrink to
    MONITORED_MAX_TILES tiles; the rows are the same."""
    mine, _ = pair["conv"]
    samples = _audio(12.0)
    want = mine.analyze_samples(samples)
    eng = mine._streaming_engine()
    monkeypatch.setattr(eng, "tile", 1)
    monkeypatch.setattr(tstream, "MONITORED_MAX_TILES", 1)
    tiles = []
    run = eng._run_tiles
    monkeypatch.setattr(eng, "_run_tiles", lambda a, r, n, *rest: tiles.append(n) or run(a, r, n, *rest))
    opts = tbt.InferenceOptions(cancellation_token=tbt.CancellationToken())
    # Tiles of 1 against tiles of 32: CPU matmuls of another batch size sum
    # in another order.
    _same(mine.analyze_samples(samples, options=opts), want, conf_tol=1e-6)
    assert tiles == [1, 1, 1, 1]


def test_species_masks_match_jax(paths, pair):
    """A build-time species list, and a per-call mask on top of it."""
    allowed = LABELS[2:7]
    mine = _build(tbt, paths["conv"], species=allowed)
    theirs = _build(jbt, paths["conv"], species=allowed)
    samples = _audio(7.5)
    call = np.zeros(10, bool)
    call[4:9] = True
    got = mine.analyze_samples(samples, species_mask=call)
    _same(got, _jax(theirs.analyze_samples, samples, species_mask=call))
    assert all({p.index for p in preds} <= {4, 5, 6} for _, preds in got)
    with pytest.raises(tbt.InputSizeError):
        mine.analyze_samples(samples, species_mask=np.ones(3, bool))


def test_min_confidence_matches_jax(paths, pair):
    mine = _build(tbt, paths["conv"], min_confidence=0.52)
    samples = _audio(10.0)
    unfiltered = _jax(pair["conv"][1].analyze_samples, samples)
    want = [(t, [p for p in preds if p.confidence >= 0.52]) for t, preds in unfiltered]
    got = mine.analyze_samples(samples)
    _same(got, want)
    assert any(len(p) < 3 for _, p in got)


def test_analyze_samples_iter_matches_jax(pair):
    mine, theirs = pair["conv"]
    samples = _audio(10.0)
    want = _jax(theirs.analyze_samples, samples, overlap_seconds=1.5)
    _same(list(mine.analyze_samples_iter(samples, overlap_seconds=1.5, chunk_segments=2)),
          want)
    _same(list(mine.analyze_samples_iter(samples, chunk_segments=3)),
          _jax(theirs.analyze_samples, samples))


def test_analyze_wav_matches_jax(pair, tmp_path):
    """A 48 kHz WAV written by the port's write_wav, read as raw int16; a
    32 kHz one rejected without resample=True and resampled with it."""
    mine, theirs = pair["stft"]
    wav = tmp_path / "a.wav"
    tbt.write_wav(wav, _audio(7.0), RATE)
    got = mine.analyze_wav(wav)
    assert len(got) == 3
    _same(got, _jax(theirs.analyze_wav, wav))
    wav32 = tmp_path / "b.wav"
    tbt.write_wav(wav32, _audio(6.0, seed=5)[:32_000 * 4], 32_000)
    with pytest.raises(tbt.AudioFormatError):
        mine.analyze_wav(wav32)
    got = mine.analyze_wav(wav32, resample=True)
    assert len(got) == 2
    # The resampled int16 codes may differ by one from the JAX package's.
    _same(got, _jax(theirs.analyze_wav, wav32, resample=True), conf_tol=1e-3)


def test_errors_and_options_match_jax(pair):
    mine, theirs = pair["conv"]
    for clf, pkg in ((mine, tbt), (theirs, jbt)):
        assert clf.analyze_samples(np.zeros(0, np.float32)) == []
        with pytest.raises(pkg.InferenceError):
            clf.analyze_samples(_audio(5.0), overlap_seconds=3.0)
        with pytest.raises(pkg.InferenceError, match="does not produce embeddings"):
            clf.embed_samples(np.zeros(S, np.float32))
    token = tbt.CancellationToken()
    token.cancel()
    with pytest.raises(tbt.InferenceCancelledError):
        mine.analyze_samples(_audio(9.0), options=tbt.InferenceOptions(cancellation_token=token))
    with pytest.raises(tbt.InferenceTimeoutError):
        mine.analyze_samples(_audio(30.0), options=tbt.InferenceOptions(timeout=1e-9))


def test_engine_defaults_and_layout_helpers(paths):
    from birdnet_tpu_torch.compiler.importer import import_onnx

    imported = import_onnx(paths["conv"])
    config = tbt.detect_model_type(*imported.detection_shapes())
    eng = tstream.StreamingEngine(imported, config, device="cpu")
    assert (eng.precision, eng.tile) == ("fp32", tstream.CPU_TILE)
    assert tstream.audio_device_shape(3, 4, S, S) == (12, S)
    assert tstream.audio_device_shape(3, 4, 1000, S) == (11 * 1000 + S,)
    audio = torch.arange(11 * 1000 + S, dtype=torch.int16)
    frames = tstream.frame_tile(audio, 1, 4, 1000, S)
    assert frames.shape == (4, S) and int(frames[2, 0]) == 6000
    ready = tstream.prepare_frames(frames, "fast")
    assert ready.dtype == torch.bfloat16
    assert tstream.prepare_frames(frames, "fp32")[0, 1].item() == (4000 + 1) / 32768
