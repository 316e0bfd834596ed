"""The PyTorch port's batch context (birdnet_tpu_torch/batch_context.py) on
the CPU, against the port's own predict_batch and the JAX package's batch
context: the same results for full and short batches, the same buffer
sizes, the same errors. On the CPU the context runs the eager forward on
its padded staging buffer; on the card (tests/test_torch_cuda.py) it
replays a captured CUDA graph."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import birdnet_tpu as jbt  # noqa: E402
import birdnet_tpu_torch as tbt  # noqa: E402
from birdnet_tpu_torch.batch_context import BatchInferenceContext  # noqa: E402
from birdnet_tpu_torch.models import birdnet_v24, birdnet_v30, perch_v2  # noqa: E402
from _torch_threads import torch_threads  # noqa: E402,F401

MODELS = {
    "v24": (birdnet_v24, dict(num_species=10), 144_000),
    "v30": (birdnet_v30, dict(num_species=10, embedding_dim=32), 160_000),
}
LABELS = [f"Genus{i}_Species {i}" for i in range(10)]
MAX_BATCH = 6


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_ctx")
    out = {}
    for name, (module, kw, _) in MODELS.items():
        out[name] = str(d / f"{name}.onnx")
        module.save(out[name], width=0.1, depth=1, **kw)
    out["perch"] = str(d / "perch.onnx")
    perch_v2.save_tiny(out["perch"], num_species=10)
    return out


@pytest.fixture(scope="module")
def pairs(paths):
    """(port classifier, JAX classifier) at fp32, top-3."""
    out = {}
    for name in MODELS:
        t = (tbt.Classifier.builder().model_path(paths[name]).labels(LABELS).top_k(3)
             .precision("fp32").with_device("cpu").build())
        j = (jbt.Classifier.builder().model_path(paths[name]).labels(LABELS).top_k(3)
             .precision("fp32").build())
        out[name] = (t, j)
    return out


def _segments(name, n, seed=41):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, MODELS[name][2])) * 0.1).astype(np.float32)


def _equal(got, want):
    assert len(got) == len(want)
    for r, q in zip(got, want):
        np.testing.assert_array_equal(r.raw_scores, q.raw_scores)
        assert [p.index for p in r.predictions] == [p.index for p in q.predictions]
        assert [p.confidence for p in r.predictions] == [p.confidence for p in q.predictions]
        if q.embeddings is not None:
            np.testing.assert_array_equal(r.embeddings, q.embeddings)


@pytest.mark.parametrize("name", sorted(MODELS))
@pytest.mark.parametrize("n", [MAX_BATCH, 3, 1])
def test_context_equals_predict_batch(pairs, name, n):
    """Full and short batches: equal to predict_batch on the batch padded
    as the context pads it; against predict_batch at the batch's own size
    the same top-K, logits within 1e-5 (another batch size may sum in
    another order)."""
    t, _ = pairs[name]
    ctx = t.create_batch_context(MAX_BATCH)
    assert ctx.graph is None  # the host runs the eager forward
    segs = _segments(name, n)
    got = t.predict_batch_with_context(ctx, segs)
    padded = np.concatenate([segs, np.zeros((MAX_BATCH - n, segs.shape[1]), np.float32)])
    _equal(got, t.predict_batch(padded)[:n])
    for r, q in zip(got, t.predict_batch(segs)):
        assert [p.index for p in r.predictions] == [p.index for p in q.predictions]
        np.testing.assert_allclose(r.raw_scores, q.raw_scores, rtol=0, atol=1e-5)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_context_matches_jax_context(pairs, name):
    t, j = pairs[name]
    tctx, jctx = t.create_batch_context(MAX_BATCH), j.create_batch_context(MAX_BATCH)
    for n in (MAX_BATCH, 2):
        segs = _segments(name, n, seed=42)
        with jax.default_matmul_precision("highest"):
            want = j.predict_batch_with_context(jctx, segs)
        got = t.predict_batch_with_context(tctx, segs)
        assert len(got) == len(want) == n
        for r, q in zip(got, want):
            assert [p.index for p in r.predictions] == [p.index for p in q.predictions]
            np.testing.assert_allclose(r.raw_scores, q.raw_scores, rtol=0, atol=1e-4)
            if q.embeddings is not None:
                np.testing.assert_allclose(r.embeddings, np.asarray(q.embeddings),
                                           rtol=0, atol=1e-4)
            else:
                assert r.embeddings is None


@pytest.mark.parametrize("name", sorted(MODELS))
@pytest.mark.parametrize("max_batch", [1, 4, 32])
def test_buffer_sizes_equal_jax(pairs, name, max_batch):
    t, j = pairs[name]
    tctx, jctx = t.create_batch_context(max_batch), j.create_batch_context(max_batch)
    assert tctx.max_batch_size == jctx.max_batch_size == max_batch
    assert tctx.input_buffer_bytes() == jctx.input_buffer_bytes()
    assert tctx.output_buffer_bytes() == jctx.output_buffer_bytes()
    assert tctx.total_buffer_bytes() == jctx.total_buffer_bytes()


def test_perch_rejected_with_the_jax_message(paths):
    t = (tbt.Classifier.builder().model_path(paths["perch"]).labels(LABELS)
         .with_device("cpu").build())
    j = jbt.Classifier.builder().model_path(paths["perch"]).labels(LABELS).build()
    with pytest.raises(tbt.InferenceError) as got:
        t.create_batch_context(4)
    with pytest.raises(jbt.InferenceError) as want:
        j.create_batch_context(4)
    assert str(got.value) == str(want.value)
    assert "PerchV2" in str(got.value)


def test_errors_match_jax(pairs):
    t, j = pairs["v24"]
    tctx, jctx = t.create_batch_context(2), j.create_batch_context(2)
    for ctx, pkg, clf in ((tctx, tbt, t), (jctx, jbt, j)):
        with pytest.raises(pkg.InferenceError, match="exceeds context max 2"):
            clf.predict_batch_with_context(ctx, _segments("v24", 3))
        bad = [np.zeros(144_000, np.float32), np.zeros(1000, np.float32)]
        with pytest.raises(pkg.BatchInputSizeError) as err:
            clf.predict_batch_with_context(ctx, bad)
        assert "1" in str(err.value) and "1000" in str(err.value)
    with pytest.raises(tbt.BatchInputSizeError) as got:
        tctx.prepare_input(bad)
    with pytest.raises(jbt.BatchInputSizeError) as want:
        jctx.prepare_input(bad)
    assert str(got.value) == str(want.value)
    for clf, pkg in ((t, tbt), (j, jbt)):
        with pytest.raises(pkg.InferenceError, match=">= 1"):
            clf.create_batch_context(0)


def test_staging_buffers_alternate_and_clear(pairs):
    t, _ = pairs["v24"]
    ctx = t.create_batch_context(3)
    segs = _segments("v24", 2)
    a, n = ctx.prepare_input(segs)
    b, _ = ctx.prepare_input(segs[:1])
    assert n == 2 and a is not b and a.shape == b.shape == (3, 144_000)
    np.testing.assert_array_equal(a[:2], segs)
    assert not a[2].any() and not b[1:].any()
    c, _ = ctx.prepare_input(segs)
    assert c is a
    ctx.clear_inputs()
    assert not a.any() and not b.any()


def test_species_masks_through_the_context(pairs):
    t, _ = pairs["v24"]
    ctx = t.create_batch_context(4, precompile_row_mask=True)
    segs = _segments("v24", 3)
    masks = np.zeros((3, 10), bool)
    masks[0, [1, 2]] = masks[1, [3]] = masks[2, :] = True
    got = t.predict_batch_with_context(ctx, segs, species_masks=masks)
    padded = np.concatenate([segs, np.zeros((1, 144_000), np.float32)])
    want = t.predict_batch(padded[:3], species_masks=masks)
    for r, q, m in zip(got, want, masks):
        assert {p.index for p in r.predictions} <= set(np.flatnonzero(m))
        assert [p.index for p in r.predictions] == [p.index for p in q.predictions]
    # Unmasked again afterwards.
    _equal(t.predict_batch_with_context(ctx, segs), t.predict_batch(padded)[:3])


def test_context_on_the_card_without_cuda_raises(pairs, monkeypatch):
    """A context for a classifier on the card, where CUDA is not available,
    raises a BirdnetError (RuntimeInitError) instead of running eagerly."""
    t, _ = pairs["v24"]

    class CardEngine:
        device = torch.device("cuda", 0)
        top_k = 3

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(tbt.RuntimeInitError):
        BatchInferenceContext(CardEngine(), t.config, 4)
