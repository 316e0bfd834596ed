"""The port's main path end to end on the CPU, against the JAX package:
ONNX file → import → forward (fp32 and fast) → Classifier predict /
predict_batch, the fused top-K, the explicit-device rule, and the builder
and model surface both packages share (model_type, allowed_species,
param_bytes)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import birdnet_tpu as jbt  # noqa: E402
import birdnet_tpu_torch as tbt  # noqa: E402
from birdnet_tpu.compiler import importer as jimp  # noqa: E402
from birdnet_tpu.ops.topk import fused_sigmoid_topk as j_topk  # noqa: E402
from birdnet_tpu_torch.compiler import importer as timp  # noqa: E402
from birdnet_tpu_torch.models import birdnet_v24  # noqa: E402
from birdnet_tpu_torch.ops.topk import fused_sigmoid_topk as t_topk  # noqa: E402
from _torch_threads import torch_threads  # noqa: E402,F401

LABELS = [f"Genus{i}_Species {i}" for i in range(10)]

MODELS = {
    "tiny-conv": dict(num_species=10, width=0.1, depth=1, seed=0),
    "tiny-stft": dict(num_species=10, width=0.1, depth=1, seed=0, frontend="stft"),
}


@pytest.fixture(scope="module")
def model_paths(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_models")
    paths = {}
    for name, kwargs in MODELS.items():
        paths[name] = str(d / f"{name}.onnx")
        birdnet_v24.save(paths[name], **kwargs)
    return paths


@pytest.fixture(scope="module")
def audio():
    rng = np.random.default_rng(7)
    return (rng.normal(size=(3, birdnet_v24.SAMPLE_COUNT)) * 0.1).astype(np.float32)


def _forwards(path, precision):
    """(port logits, JAX logits) for one file; both forwards take the same
    imported params (the port's through params_to_torch)."""
    j = jimp.import_onnx(path)
    t = timp.import_onnx(path)

    def run(x):
        fwd = jax.jit(jimp.make_forward(j, precision))
        want = np.asarray(fwd(j.params, x)[0], np.float32)
        got = timp.make_forward(t, precision, "cpu")(
            timp.params_to_torch(j.params, "cpu"), torch.from_numpy(x)
        )[0]
        return got.float().numpy(), want

    return run


@pytest.mark.parametrize("name", sorted(MODELS))
def test_fp32_forward_matches_jax(model_paths, audio, name):
    """fp32: logits within 1e-4 (the ROADMAP's fp32 parity rule)."""
    with jax.default_matmul_precision("highest"):
        got, want = _forwards(model_paths[name], "fp32")(audio)
    assert got.shape == want.shape == (3, 10)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_fast_forward_matches_jax_kernel(model_paths, audio, name, monkeypatch):
    """fast: the port's plain frontend and stage prefix against the JAX
    package's Pallas kernels in interpret mode, scaled max |Δ| < 5e-2 (the
    bound of tests/test_fuse_stft_frontend.py for the same policy)."""
    monkeypatch.setenv("BIRDNET_FRONTEND_INTERPRET", "1")
    monkeypatch.setenv("BIRDNET_STAGE123_INTERPRET", "1")
    got, want = _forwards(model_paths[name], "fast")(audio[:2])
    assert np.all(np.isfinite(got))
    assert np.abs(got - want).max() / np.abs(want).max() < 5e-2


@pytest.mark.parametrize("name", sorted(MODELS))
def test_mixed_forward_matches_jax(model_paths, audio, name):
    """mixed: bf16 operands, float32 sums and float32 activations on both
    sides. Scaled max |Δ| <= 2^-7, half of _fast_close's bound: each op
    agrees to ~1e-7 (tests/test_torch_ops.py), but the float32 frontend's
    sum-order differences (~5e-6) flip the bf16 rounding of some of the
    next conv's operands, each flip one bf16 ulp (2^-8 relative), and those
    carry to the logits. Prints the measured value."""
    got, want = _forwards(model_paths[name], "mixed")(audio)
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape == (3, 10)
    scaled = np.abs(got - want).max() / np.abs(want).max()
    print(f"mixed forward, {name}: scaled max |d| {scaled:.3g}")
    assert scaled <= 2 ** -7


def _classifiers(path, **kw):
    def build(pkg):
        b = pkg.Classifier.builder().model_path(path).labels(LABELS)
        b = b.precision("fp32").top_k(kw.get("top_k", 3))
        if "species" in kw:
            b = b.species_list(kw["species"])
        if pkg is tbt:
            b = b.with_device("cpu")
        return b.build()

    return build(tbt), build(jbt)


def _same_result(r, q):
    assert r.model_type.value == q.model_type.value
    assert [p.species for p in r.predictions] == [p.species for p in q.predictions]
    np.testing.assert_allclose([p.confidence for p in r.predictions],
                               [p.confidence for p in q.predictions], atol=1e-5)
    np.testing.assert_allclose(r.raw_scores, q.raw_scores, atol=1e-4)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_classifier_matches_jax(model_paths, audio, name):
    mine, theirs = _classifiers(model_paths[name])
    assert mine.device == torch.device("cpu") and mine.precision == "fp32"
    assert repr(mine.config) == repr(theirs.config)
    _same_result(mine.predict(audio[0]), theirs.predict(audio[0]))
    for r, q in zip(mine.predict_batch(audio), theirs.predict_batch(audio)):
        _same_result(r, q)


def test_classifier_species_masks_match_jax(model_paths, audio):
    allowed = LABELS[2:6]
    mine, theirs = _classifiers(model_paths["tiny-conv"], species=allowed, top_k=6)
    rows = np.zeros((3, 10), bool)
    rows[:, 3:] = True
    for r, q in zip(mine.predict_batch(audio, species_masks=rows),
                    theirs.predict_batch(audio, species_masks=rows)):
        _same_result(r, q)
        assert {p.species for p in r.predictions} <= {"Genus3_Species 3",
                                                      "Genus4_Species 4",
                                                      "Genus5_Species 5"}


def test_classifier_errors_match_jax(model_paths):
    mine, theirs = _classifiers(model_paths["tiny-conv"])
    for clf, pkg in ((mine, tbt), (theirs, jbt)):
        with pytest.raises(pkg.InputSizeError, match="144000"):
            clf.predict(np.zeros(100, np.float32))
        with pytest.raises(pkg.BatchInputSizeError):
            clf.predict_batch([np.zeros(144000, np.float32), np.zeros(5, np.float32)])
    with pytest.raises(tbt.LabelCountError):
        tbt.Classifier.builder().model_path(model_paths["tiny-conv"]).labels(
            LABELS[:3]).with_device("cpu").build()
    with pytest.raises(tbt.ModelPathRequiredError):
        tbt.Classifier.builder().labels(LABELS).build()


def test_cancelled_call_raises(model_paths, audio):
    mine, _ = _classifiers(model_paths["tiny-conv"])
    token = tbt.CancellationToken()
    token.cancel()
    with pytest.raises(tbt.InferenceCancelledError):
        mine.predict(audio[0], options=tbt.InferenceOptions.with_cancellation(token))


def test_cuda_request_without_cuda_raises(model_paths):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    builder = tbt.Classifier.builder().model_path(model_paths["tiny-conv"]).labels(LABELS)
    with pytest.raises(tbt.RuntimeInitError):
        builder.with_device("cuda").build()
    with pytest.raises(tbt.RuntimeInitError):  # the default device is cuda:0
        tbt.Classifier.builder().model_path(model_paths["tiny-conv"]).labels(LABELS).build()


@pytest.mark.parametrize("request_", ["tpu", "cuda:x", "metal"])
def test_unknown_device_raises(request_):
    with pytest.raises(tbt.RuntimeInitError, match="unknown device"):
        tbt.resolve_device(request_)


def test_cpu_device_resolves():
    assert tbt.resolve_device("CPU") == torch.device("cpu")


def test_unported_surface_says_so(model_paths):
    """Every surface this test once found unported now runs: ``with_mesh``
    (ROADMAP A10) returns the builder, and a 1x1 host mesh predicts as the
    single-device classifier does."""
    from birdnet_tpu_torch.parallel import make_mesh

    builder = tbt.Classifier.builder()
    assert builder.with_mesh() is builder
    meshed = (tbt.Classifier.builder().model_path(model_paths["tiny-conv"]).labels(LABELS)
              .with_mesh(make_mesh([torch.device("cpu")])).build())
    single = tbt.Classifier.builder().model_path(model_paths["tiny-conv"]).labels(LABELS) \
        .with_device("cpu").build()
    seg = np.sin(np.linspace(0, 2000, 144000), dtype=np.float32)
    got, want = meshed.predict(seg), single.predict(seg)
    assert [p.index for p in got.predictions] == [p.index for p in want.predictions]
    np.testing.assert_allclose(got.raw_scores, want.raw_scores, rtol=1e-4, atol=1e-5)
    builder = tbt.Classifier.builder()
    assert builder.int8() is builder  # int8 is ported (ROADMAP A8)
    mine, _ = _classifiers(model_paths["tiny-conv"])
    # Batch contexts are ported (ROADMAP A3): on the host, the eager forward.
    ctx = mine.create_batch_context(4)
    assert ctx.max_batch_size == 4 and ctx.graph is None
    assert len(mine.predict_batch_with_context(ctx, np.zeros((2, 144000), np.float32))) == 2
    # Streaming is ported (ROADMAP A4): one silent segment, one result.
    assert len(mine.analyze_samples(np.zeros(144000, np.float32))) == 1


def test_streaming_timeout_scale_matches_jax(model_paths):
    """Equal to the JAX method wherever the recording's tile count is one of
    the JAX package's tile buckets (and past the 16-tile monitored cap);
    elsewhere the port counts the tiles it dispatches, ceil(n / tile), where
    JAX rounds up to the next bucket (ROADMAP C, deliberate differences)."""
    from birdnet_tpu.compiler.stream import _bucket_tiles

    mine, theirs = _classifiers(model_paths["tiny-conv"])
    tile = mine._streaming_engine().tile
    assert tile == theirs._streaming_engine().tile
    for batch in (1, 7, 32, 100):
        assert mine.streaming_timeout_scale(batch) == theirs.streaming_timeout_scale(batch)
        for n in (None, 0, 1, tile, tile + 1, 3 * tile, 5 * tile - 3, 7 * tile,
                  11 * tile, 16 * tile, 40 * tile + 5):
            got = mine.streaming_timeout_scale(batch, n)
            want = theirs.streaming_timeout_scale(batch, n)
            tiles = -(-n // tile) if n else 0
            if not n or tiles >= 16 or _bucket_tiles(tiles) == tiles:
                assert got == want, (batch, n)
            else:
                assert got == max(1, -(-tiles * tile // batch)) <= want, (batch, n)
    assert mine.streaming_timeout_scale(32, 5 * tile) < theirs.streaming_timeout_scale(32, 5 * tile)


@pytest.mark.parametrize("masked", [False, True])
def test_fused_topk_matches_jax_on_nan_and_inf(masked):
    logits = np.array([
        [0.5, np.nan, np.inf, -np.inf, 2.0, 0.5, -1.0, 3.0],
        [np.inf, np.inf, 1.0, np.nan, -np.inf, 0.0, 0.0, 0.0],
        [-np.inf] * 3 + [1.0, 1.0, 1.0, -2.0, 7.0],
    ], np.float32)
    mask = np.array([1, 1, 1, 0, 1, 1, 1, 0], bool) if masked else None
    rows = None
    if masked:
        rows = np.ones_like(logits, bool)
        rows[0, 2] = rows[1, 0] = False
    k = 6
    conf, idx = t_topk(torch.from_numpy(logits), k,
                       None if mask is None else torch.from_numpy(mask),
                       None if rows is None else torch.from_numpy(rows))
    jconf, jidx = j_topk(logits, k, mask, rows)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(conf.numpy(), np.asarray(jconf), rtol=1e-6)
    assert idx.dtype == torch.int32


def test_model_type_override_matches_jax(model_paths):
    """ClassifierBuilder.model_type overrides detection, validated against
    the file's shapes: the matching type builds the same config in both
    packages, a mismatching one raises the same error class."""
    path = model_paths["tiny-conv"]
    mine = (tbt.Classifier.builder().model_path(path).labels(LABELS)
            .model_type(tbt.ModelType.BIRDNET_V24).with_device("cpu").build())
    theirs = (jbt.Classifier.builder().model_path(path).labels(LABELS)
              .model_type(jbt.ModelType.BIRDNET_V24).build())
    assert repr(mine.config) == repr(theirs.config)
    errors = []
    for pkg in (tbt, jbt):
        builder = pkg.Classifier.builder().model_path(path).labels(LABELS)
        if pkg is tbt:
            builder = builder.with_device("cpu")
        with pytest.raises(pkg.ModelDetectionError) as e:
            builder.model_type(pkg.ModelType.BIRDNET_V30).build()
        errors.append((type(e.value).__name__, str(e.value)))
    assert errors[0] == errors[1]


def test_allowed_species_matches_jax(model_paths):
    allowed = LABELS[2:6]
    mine, theirs = _classifiers(model_paths["tiny-conv"], species=allowed)
    assert mine.allowed_species() == theirs.allowed_species() == allowed
    mine, theirs = _classifiers(model_paths["tiny-conv"])
    assert mine.allowed_species() is theirs.allowed_species() is None


@pytest.mark.parametrize("name", sorted(MODELS))
def test_param_bytes_matches_jax(model_paths, name):
    mine = timp.import_onnx(model_paths[name])
    theirs = jimp.import_onnx(model_paths[name])
    assert mine.param_bytes() == theirs.param_bytes() > 0
