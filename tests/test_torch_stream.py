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
from _torch_threads import torch_threads  # noqa: E402,F401

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


# ---------------------------------------------------------------------------
# The tile programs: one per streaming key, over the engine's one ring of
# tile buffers. On the host every key runs the ring with the eager body
# (the card replays the key's captured graph instead,
# tests/test_torch_cuda.py).
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["int16", "float32"])
@pytest.mark.parametrize("seconds,overlap", [
    pytest.param(10.0, 0.0, id="overlap-0"),
    pytest.param(10.0, 1.5, id="overlap-1.5s"),
    pytest.param(0.5, 2.99, id="overlap-2.99s"),
])
def test_ring_at_a_tile_that_does_not_divide_matches_jax(pair, monkeypatch, seconds,
                                                         overlap, dtype):
    """Tile 3 (4, 7 and 50 segments: the last tile partial) against the JAX
    stream at its own tile, from int16 and float32 input."""
    mine, theirs = pair["conv"]
    samples = _audio(seconds, seed=7)
    if dtype == "int16":
        samples = (np.clip(samples, -1, 1 - 1 / 32768) * 32768).astype(np.int16)
    monkeypatch.setattr(mine._streaming_engine(), "tile", 3)
    got = mine.analyze_samples(samples, overlap_seconds=overlap)
    _same(got, _jax(theirs.analyze_samples, samples, overlap_seconds=overlap))
    step = S - int(overlap * RATE)
    assert len(got) == -(-samples.shape[0] // step)
    assert len(got) % 3 != 0


def test_one_program_per_key(paths):
    """A program per (tile, step, dtype, embeddings, mask): a second call
    with the same key reuses it, another overlap, dtype, tile or a per-call
    mask makes a new one; every key shares the engine's ring of RING_SLOTS
    host buffers, which hold the tile's largest span."""
    clf = _build(tbt, paths["conv"])
    eng = clf._streaming_engine()
    samples = _audio(10.0)
    clf.analyze_samples(samples)
    clf.analyze_samples(samples)
    assert len(eng.programs) == 1
    clf.analyze_samples(samples, overlap_seconds=1.5)
    clf.analyze_samples((samples * 1000).astype(np.int16))
    clf.analyze_samples(samples, species_mask=np.ones(10, bool))
    eng.tile = 3
    clf.analyze_samples(samples)
    keys = sorted(eng.programs)
    assert len(keys) == 5
    assert (3, S, "float32", False, False, False) in keys
    program = eng.programs[32, S - 72_000, "float32", False, False, False]
    assert program.eager and program.nbytes == (31 * (S - 72_000) + S) * 4
    ring = eng._ring
    assert len(ring.hosts) == tstream.RING_SLOTS and ring.devices is None
    assert ring.nbytes == 32 * S * 4
    assert all(h.shape == (32 * S * 4,) and not h.is_pinned() for h in ring.hosts)


def test_many_overlaps_keep_one_ring_and_at_most_max_programs(pair, monkeypatch):
    """Each distinct overlap is a key: past MAX_PROGRAMS keys the least
    recently used is dropped, and every key streams through the engine's one
    ring, so distinct overlaps cannot grow what the engine holds. Each
    result matches the JAX stream."""
    mine, theirs = pair["conv"]
    eng = mine._streaming_engine()
    monkeypatch.setattr(eng, "tile", 2)
    monkeypatch.setattr(eng, "_programs", type(eng._programs)())
    monkeypatch.setattr(eng, "_ring", None)
    samples = _audio(7.0, seed=11)
    overlaps = [round(0.25 * i, 2) for i in range(tstream.MAX_PROGRAMS + 4)]
    rings = set()
    for overlap in overlaps:
        got = mine.analyze_samples(samples, overlap_seconds=overlap)
        _same(got, _jax(theirs.analyze_samples, samples, overlap_seconds=overlap))
        rings.add(id(eng._ring))
        assert len(eng.programs) <= tstream.MAX_PROGRAMS
    assert len(rings) == 1 and eng._ring.nbytes == 2 * S * 4
    assert [k[1] for k in eng.programs] == [
        S - int(o * RATE) for o in overlaps[-tstream.MAX_PROGRAMS:]]
    # A key used again moves to the back: the next new key drops another.
    mine.analyze_samples(samples, overlap_seconds=overlaps[-tstream.MAX_PROGRAMS])
    mine.analyze_samples(samples, overlap_seconds=2.9)
    steps = [k[1] for k in eng.programs]
    assert S - int(overlaps[-tstream.MAX_PROGRAMS] * RATE) in steps
    assert S - int(overlaps[-tstream.MAX_PROGRAMS + 1] * RATE) not in steps


def test_a_larger_tile_grows_the_ring_and_drops_its_keys(pair, monkeypatch):
    """The ring is sized to the largest span of the tile; a larger tile
    replaces it, and the keys made over the old one go with it."""
    mine, theirs = pair["stft"]
    eng = mine._streaming_engine()
    monkeypatch.setattr(eng, "_programs", type(eng._programs)())
    monkeypatch.setattr(eng, "_ring", None)
    samples = _audio(12.0, seed=12)
    monkeypatch.setattr(eng, "tile", 2)
    mine.analyze_samples(samples)
    monkeypatch.setattr(eng, "tile", 1)
    mine.analyze_samples(samples, overlap_seconds=1.5)
    small = eng._ring
    assert len(eng.programs) == 2 and small.nbytes == 2 * S * 4
    monkeypatch.setattr(eng, "tile", 3)
    got = mine.analyze_samples(samples, overlap_seconds=1.5)
    _same(got, _jax(theirs.analyze_samples, samples, overlap_seconds=1.5))
    assert eng._ring is not small and eng._ring.nbytes == 3 * S * 4
    assert list(eng.programs) == [(3, S - 72_000, "float32", False, False, False)]


def test_ring_over_several_superchunks_matches_jax(pair, monkeypatch):
    """Superchunks of two tiles of 3 (the ring turns over within and across
    superchunks), at overlap 1.5 s, against the JAX stream."""
    mine, theirs = pair["stft"]
    samples = _audio(40.0, seed=9)
    eng = mine._streaming_engine()
    monkeypatch.setattr(eng, "tile", 3)
    monkeypatch.setattr(tstream, "MAX_TILES", 2)
    got = mine.analyze_samples(samples, overlap_seconds=1.5)
    _same(got, _jax(theirs.analyze_samples, samples, overlap_seconds=1.5))
    assert len(got) == 27


def test_monitored_ring_matches_jax(pair, monkeypatch):
    """A run with a timeout (monitored: superchunks of MONITORED_MAX_TILES
    tiles) at tile 3 and overlap 1.5 s, against the JAX stream."""
    mine, theirs = pair["conv"]
    samples = _audio(25.0, seed=11)
    monkeypatch.setattr(mine._streaming_engine(), "tile", 3)
    monkeypatch.setattr(tstream, "MONITORED_MAX_TILES", 2)
    opts = tbt.InferenceOptions(timeout=600.0)
    got = mine.analyze_samples(samples, overlap_seconds=1.5, options=opts)
    _same(got, _jax(theirs.analyze_samples, samples, overlap_seconds=1.5,
                    options=jbt.InferenceOptions(timeout=600.0)))


@pytest.fixture(scope="module")
def v30_pair(tmp_path_factory):
    """(port, JAX) classifiers on a tiny BirdNET v3.0 file (embeddings)."""
    from birdnet_tpu_torch.models import birdnet_v30

    path = str(tmp_path_factory.mktemp("stream_v30") / "v30.onnx")
    birdnet_v30.save_tiny(path, num_species=10)
    return _build(tbt, path), _build(jbt, path)


def test_ring_embeddings_and_mask_match_jax(v30_pair, monkeypatch):
    """The key with embeddings (embed_samples) and the key with a per-call
    mask, at tile 3 and overlap 1.5 s, against the JAX stream."""
    mine, theirs = v30_pair
    monkeypatch.setattr(mine._streaming_engine(), "tile", 3)
    rate = mine.config.sample_rate
    rng = np.random.default_rng(12)
    samples = (0.2 * rng.normal(size=rate * 22)).astype(np.float32)
    emb, times = mine.embed_samples(samples, overlap_seconds=1.5)
    want_emb, want_times = _jax(theirs.embed_samples, samples, overlap_seconds=1.5)
    np.testing.assert_allclose(times, want_times)
    np.testing.assert_allclose(emb, want_emb, rtol=0,
                               atol=1e-4 * np.abs(want_emb).max())
    call = np.zeros(10, bool)
    call[[1, 3, 8]] = True
    got = mine.analyze_samples(samples, overlap_seconds=1.5, species_mask=call)
    _same(got, _jax(theirs.analyze_samples, samples, overlap_seconds=1.5,
                    species_mask=call))
    assert all({p.index for p in preds} <= {1, 3, 8} for _, preds in got)
    assert {k[3:5] for k in mine._streaming_engine().programs} == {(True, False),
                                                                  (False, True)}


@pytest.mark.parametrize("overlap", [-1.0, 3.0, 4.5])
def test_warmup_guard_matches_jax(pair, overlap):
    mine, theirs = pair["conv"]
    errors = []
    for eng in (mine._streaming_engine(), theirs._streaming_engine()):
        with pytest.raises(Exception) as info:
            eng.warmup(overlap_seconds=overlap)
        errors.append(info.value)
    assert isinstance(errors[0], tbt.InferenceError)
    assert isinstance(errors[1], jbt.InferenceError)
    assert str(errors[0]) == str(errors[1])


def test_warmup_makes_the_key_analyze_takes(paths):
    """warmup(overlap, dtype) makes the program of that key; the first
    analyze with it adds none. n_tiles is checked and has no other effect."""
    clf = _build(tbt, paths["conv"])
    eng = clf._streaming_engine()
    eng.warmup(n_tiles=5, overlap_seconds=1.5, dtype=np.int16)
    eng.warmup(overlap_seconds=1.5, dtype=np.int16)
    assert list(eng.programs) == [(32, S - 72_000, "int16", False, False, False)]
    i16 = (np.clip(_audio(9.0), -1, 1 - 1 / 32768) * 32768).astype(np.int16)
    clf.analyze_samples(i16, overlap_seconds=1.5)
    assert len(eng.programs) == 1
    with pytest.raises(tbt.InferenceError, match="n_tiles"):
        eng.warmup(n_tiles=0)


def test_host_reads_are_counted_per_thread(tmp_path):
    """A forward whose Loop runs the while form reads its condition on the
    host: reads_host counts those reads in a tally (what decides, on the
    card, that a key runs eagerly), and such a file streams as the JAX
    package streams it."""
    from _torch_flow_cases import while_classifier_bytes

    from birdnet_tpu_torch.compiler.importer import import_onnx, make_forward, params_to_torch
    from birdnet_tpu_torch.ops.cuda.build import tally_launches

    data = while_classifier_bytes(10)
    model = import_onnx(data)
    fwd = make_forward(model, "fp32", "cpu")
    x = torch.from_numpy(_audio(3.0)[None])
    with tally_launches() as tally:
        fwd(params_to_torch(model.params, "cpu"), x)
    assert tstream.reads_host(tally) == 3
    with tally_launches() as tally:
        pass
    assert tstream.reads_host(tally) == 0
    path = tmp_path / "while.onnx"
    path.write_bytes(data)
    mine, theirs = _build(tbt, str(path)), _build(jbt, str(path))
    samples = _audio(10.0)
    _same(mine.analyze_samples(samples), _jax(theirs.analyze_samples, samples))


@pytest.mark.parametrize("cache", ["frontend_operands", "host_upload", "noise"])
def test_a_capture_holds_the_cached_operands_it_reads(cache):
    """The operand caches of the lowerings and kernel wrappers drop entries
    past their size; a CUDA graph reads its operands at their addresses on
    every replay, so whatever a cache hands out inside ``build.holding()``
    (a graph's capture) stays alive in the held list after the cache drops
    it (the fault: a stream key's graph read B4's freed weight tables once
    nine forwards had filled their cache)."""
    import gc
    import weakref

    from birdnet_tpu_torch.compiler import ops as tops
    from birdnet_tpu_torch.compiler import ops_extended as text
    from birdnet_tpu_torch.ops.cuda import build
    from birdnet_tpu_torch.ops.cuda import frontend as tfe

    cpu = torch.device("cpu")
    if cache == "frontend_operands":
        def take(i):
            return tfe._cached(lambda key: key == ("held", i),
                               lambda: (("held", i), torch.full((4,), float(i))))
        room = tfe._OPERANDS_KEPT
    elif cache == "host_upload":
        def take(i):
            if i:  # past 4,096 values the cache drops the oldest; drop it all
                tops._device_array.cache_clear()
            return tops._on_device(np.full((3,), i, np.float32), cpu)
        room = 0
    else:
        ctx = tops.OpContext(op_type="RandomNormal", attrs={"seed": None}, opset=17,
                             precision="fp32", node_name="n", num_outputs=1, env={},
                             out_names=["y"], device=cpu)

        def take(i):
            return text._noise(ctx, "normal", (i + 1,), torch.float32, cpu)
        room = text._NOISE_MAX
    with build.holding() as held:
        first = take(0)
    assert len(held) == 1 and held[0] is first
    ref = weakref.ref(first)
    del first
    for i in range(1, room + 2):
        take(i)
    gc.collect()
    assert ref() is not None
    del held
    gc.collect()
    assert ref() is None
