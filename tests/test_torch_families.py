"""BirdNET v3.0 and Google Perch v2 through the PyTorch port, against the JAX
package on the CPU: tiny models (width 0.1, one block per stage) in both
frontend forms, the same numpy inputs through both packages.

fp32 rule: every output within 1e-4 (ROADMAP's fp32 parity bound), the
same top-K indices. mixed: scaled max |Δ| <= 2^-7, the bound of
tests/test_torch_classifier.py::test_mixed_forward_matches_jax."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import birdnet_tpu as jbt  # noqa: E402
import birdnet_tpu_torch as tbt  # noqa: E402
from birdnet_tpu.compiler import importer as jimp  # noqa: E402
from birdnet_tpu_torch.compiler import importer as timp  # noqa: E402
from birdnet_tpu_torch.models import birdnet_v30, perch_v2  # noqa: E402
from _torch_threads import torch_threads  # noqa: E402,F401

FP32_TOL = 1e-4
RATE, S = 32_000, 160_000
# (generator, its save_tiny's species, embedding width and seed)
FAMILIES = {"v30": (birdnet_v30, 10, 32, 1), "perch": (perch_v2, 12, 48, 2)}
CASES = [(f, fe) for f in FAMILIES for fe in ("conv", "stft")]
IDS = [f"{f}-{fe}" for f, fe in CASES]


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    d = tmp_path_factory.mktemp("family_models")
    out = {}
    for family, frontend in CASES:
        module, n, emb, seed = FAMILIES[family]
        out[family, frontend] = str(d / f"{family}_{frontend}.onnx")
        module.save(out[family, frontend], num_species=n, embedding_dim=emb, width=0.1,
                    depth=1, seed=seed, frontend=frontend)
    return out


def _labels(family):
    return [f"Genus{i}_Species {i}" for i in range(FAMILIES[family][1])]


@pytest.fixture(scope="module")
def pairs(paths):
    """(port classifier, JAX classifier) at fp32 per case."""
    out = {}
    for (family, frontend), path in paths.items():
        build = lambda pkg: pkg.Classifier.builder().model_path(path).labels(
            _labels(family)).precision("fp32").top_k(3)
        out[family, frontend] = (build(tbt).with_device("cpu").build(), build(jbt).build())
    return out


@pytest.fixture(scope="module")
def segments():
    rng = np.random.default_rng(21)
    return (rng.normal(size=(3, S)) * 0.1).astype(np.float32)


def _forwards(path, precision, x):
    """Every output of make_forward, (port, JAX), as float32 numpy; both
    forwards take the JAX importer's params."""
    j = jimp.import_onnx(path)
    t = timp.import_onnx(path)
    want = jax.jit(jimp.make_forward(j, precision))(j.params, x)
    got = timp.make_forward(t, precision, "cpu")(timp.params_to_torch(j.params, "cpu"),
                                                  torch.from_numpy(x))
    return ([g.float().numpy() for g in got], [np.asarray(w, np.float32) for w in want])


@pytest.mark.parametrize("family,frontend", CASES, ids=IDS)
def test_fp32_every_output_matches_jax(paths, segments, family, frontend):
    with jax.default_matmul_precision("highest"):
        got, want = _forwards(paths[family, frontend], "fp32", segments)
    assert len(got) == len(want) == {"v30": 2, "perch": 4}[family]
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=FP32_TOL, atol=FP32_TOL)


@pytest.mark.parametrize("family,frontend", CASES, ids=IDS)
def test_mixed_every_output_matches_jax(paths, segments, family, frontend):
    got, want = _forwards(paths[family, frontend], "mixed", segments[:2])
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.float32 and g.shape == w.shape
        scaled = np.abs(g - w).max() / np.abs(w).max()
        print(f"mixed {family} {frontend} output {g.shape}: scaled max |d| {scaled:.3g}")
        assert scaled <= 2 ** -7


@pytest.mark.parametrize("family,frontend", CASES, ids=IDS)
def test_detected_model_type_matches_jax(pairs, family, frontend):
    t, j = pairs[family, frontend]
    assert t.model_type.value == j.model_type.value
    assert t.model_type is {"v30": tbt.ModelType.BIRDNET_V30,
                            "perch": tbt.ModelType.PERCH_V2}[family]
    assert t.config.embedding_dim == j.config.embedding_dim == FAMILIES[family][2]
    assert t.config.sample_count == S


def _same_result(r, q):
    assert [p.index for p in r.predictions] == [p.index for p in q.predictions]
    np.testing.assert_allclose([p.confidence for p in r.predictions],
                               [p.confidence for p in q.predictions], rtol=0, atol=FP32_TOL)
    np.testing.assert_allclose(r.raw_scores, q.raw_scores, rtol=0, atol=FP32_TOL)
    assert r.embeddings is not None and q.embeddings is not None
    np.testing.assert_allclose(r.embeddings, np.asarray(q.embeddings), rtol=0, atol=FP32_TOL)


@pytest.mark.parametrize("family,frontend", CASES, ids=IDS)
def test_predict_and_predict_batch_match_jax(pairs, segments, family, frontend):
    t, j = pairs[family, frontend]
    with jax.default_matmul_precision("highest"):
        want_one, want = j.predict(segments[0]), j.predict_batch(segments)
    _same_result(t.predict(segments[0]), want_one)
    got = t.predict_batch(segments)
    assert len(got) == len(want) == 3
    for r, q in zip(got, want):
        _same_result(r, q)


def _pcm(seconds, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=int(RATE * seconds)) * 3000).clip(-32768, 32767).astype(np.int16)


@pytest.mark.parametrize("family,frontend", CASES, ids=IDS)
@pytest.mark.parametrize("overlap", [0.0, 2.5])
def test_stream_and_embed_match_jax(pairs, family, frontend, overlap):
    """analyze_samples and embed_samples on 12 s of int16 audio (3 or 5
    segments, the last zero-padded): the same top-K indices and start times,
    confidences and embeddings within 1e-4."""
    t, j = pairs[family, frontend]
    pcm = _pcm(12.0, seed=22)
    with jax.default_matmul_precision("highest"):
        want = j.analyze_samples(pcm, overlap_seconds=overlap)
        want_emb, want_times = j.embed_samples(pcm, overlap_seconds=overlap)
    got = t.analyze_samples(pcm, overlap_seconds=overlap)
    assert len(got) == len(want) == {0.0: 3, 2.5: 5}[overlap]
    for (tt, preds), (tj, ref) in zip(got, want):
        assert tt == pytest.approx(tj)
        assert [p.index for p in preds] == [p.index for p in ref]
        np.testing.assert_allclose([p.confidence for p in preds],
                                   [p.confidence for p in ref], rtol=0, atol=FP32_TOL)
    emb, times = t.embed_samples(pcm, overlap_seconds=overlap)
    np.testing.assert_allclose(times, np.asarray(want_times))
    assert emb.shape == np.asarray(want_emb).shape == (len(want), FAMILIES[family][2])
    np.testing.assert_allclose(emb, np.asarray(want_emb), rtol=0, atol=FP32_TOL)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_analyze_samples_iter_and_wav_match_analyze_samples(tmp_path, pairs, family):
    """The generator and the WAV entry point (with ``resample``'s 48 kHz →
    32 kHz polyphase on the host) give analyze_samples' rows."""
    from birdnet_tpu_torch.ops.resample import resample_audio
    from birdnet_tpu_torch.utils.audio_io import write_wav

    t, _ = pairs[family, "conv"]
    pcm = _pcm(11.0, seed=23)
    whole = t.analyze_samples(pcm)
    it = list(t.analyze_samples_iter(pcm, chunk_segments=2))
    assert [(a, [p.index for p in b]) for a, b in it] == \
        [(a, [p.index for p in b]) for a, b in whole]
    wav = tmp_path / "a48k.wav"
    audio48 = (np.random.default_rng(24).normal(size=48_000 * 6) * 0.1).astype(np.float32)
    write_wav(wav, audio48, 48_000)
    from birdnet_tpu_torch.utils.audio_io import read_wav

    raw, _, _ = read_wav(wav, dtype="int16")
    resampled = resample_audio(raw, 48_000, RATE, out_dtype=np.int16, device="cpu")
    from_wav = t.analyze_wav(wav, resample=True)
    direct = t.analyze_samples(resampled)
    assert [(a, [p.index for p in b]) for a, b in from_wav] == \
        [(a, [p.index for p in b]) for a, b in direct]
    with pytest.raises(tbt.AudioFormatError, match="32000 Hz"):
        t.analyze_wav(wav)


def test_v24_embed_samples_raises_in_both_packages(tmp_path):
    from birdnet_tpu_torch.models import birdnet_v24

    path = tmp_path / "v24.onnx"
    birdnet_v24.save_tiny(path, num_species=10)
    labels = [f"s{i}" for i in range(10)]
    t = tbt.Classifier.builder().model_path(path).labels(labels).with_device("cpu").build()
    j = jbt.Classifier.builder().model_path(path).labels(labels).build()
    pcm = _pcm(4.0, seed=25)
    for clf, err in ((t, tbt.InferenceError), (j, jbt.InferenceError)):
        with pytest.raises(err, match="embeddings"):
            clf.embed_samples(pcm)
