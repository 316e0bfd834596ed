"""The port's mesh Classifier (``with_mesh``) on host cells against the JAX
package's mesh Classifier on the conftest's 8 virtual CPU devices and
against the port's own single-device classifier, at fp32 on the same
numpy inputs: the same top-K indices, logits within rtol 1e-4 / atol 1e-5,
confidences and embeddings within 1e-4 (the JAX tests' tolerances)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import birdnet_tpu as jbt  # noqa: E402
import birdnet_tpu_torch as tbt  # noqa: E402
from birdnet_tpu.parallel import make_mesh as j_make_mesh  # noqa: E402
from birdnet_tpu.testutil import mock_labels, sine_segment  # noqa: E402
from birdnet_tpu_torch.parallel import make_mesh as t_make_mesh  # noqa: E402
from _torch_threads import torch_threads  # noqa: E402,F401

CPU = torch.device("cpu")
LABELS = mock_labels(10)
TOL = dict(rtol=1e-4, atol=1e-5)


def _port_mesh(shape):
    return t_make_mesh([CPU] * (shape[0] * shape[1]), shape=shape)


def _build(pkg, path, labels, shape=None, top_k=3, **kw):
    """A classifier of ``pkg`` (jbt or tbt) at fp32 on the host: over a mesh
    of ``shape``, or on one device when ``shape`` is None."""
    b = pkg.Classifier.builder().model_path(path).labels(labels).top_k(top_k).precision("fp32")
    for name, arg in kw.items():
        b = getattr(b, name)(*arg)
    if shape is not None:
        return b.with_mesh(_port_mesh(shape) if pkg is tbt else j_make_mesh(shape=shape)).build()
    return b.with_device("cpu").build() if pkg is tbt else b.build()


def _same(mine, theirs, emb=False):
    assert [p.index for p in mine.predictions] == [p.index for p in theirs.predictions]
    np.testing.assert_allclose([p.confidence for p in mine.predictions],
                               [p.confidence for p in theirs.predictions], **TOL)
    np.testing.assert_allclose(mine.raw_scores, theirs.raw_scores, **TOL)
    if emb:
        np.testing.assert_allclose(mine.embeddings, theirs.embeddings, **TOL)


def _same_stream(mine, theirs):
    assert len(mine) == len(theirs) > 0
    for (t1, p1), (t2, p2) in zip(mine, theirs):
        assert t1 == pytest.approx(t2)
        assert [p.index for p in p1] == [p.index for p in p2]
        np.testing.assert_allclose([p.confidence for p in p1], [p.confidence for p in p2],
                                   **TOL)


@pytest.fixture(scope="module")
def model_path(tmp_path_factory):
    from birdnet_tpu.models import birdnet_v24

    p = tmp_path_factory.mktemp("torch_shard") / "v24.onnx"
    birdnet_v24.save_tiny(p, num_species=10)
    return str(p)


@pytest.fixture(scope="module")
def single(model_path):
    return _build(tbt, model_path, LABELS)


@pytest.fixture(scope="module")
def sharded(model_path):
    return _build(tbt, model_path, LABELS, (4, 2))


@pytest.fixture(scope="module")
def jax_sharded(model_path):
    return _build(jbt, model_path, LABELS, (4, 2))


def test_mesh_classifier_layout(sharded):
    eng = sharded._engine
    assert sharded.device == CPU and sharded.precision == "fp32"
    assert eng.dp == 4 and eng.head_sharded and eng.tile == 32
    assert sharded._streaming_engine() is eng


def test_predict_matches(single, sharded, jax_sharded):
    seg = sine_segment()
    mine = sharded.predict(seg)
    _same(mine, jax_sharded.predict(seg))
    _same(mine, single.predict(seg))


@pytest.mark.parametrize("shape", [(8, 1), (4, 2), (2, 4)], ids=["8x1", "4x2", "2x4"])
def test_predict_batch_matches(model_path, single, shape):
    """Five segments (padded to the data axis) on each mesh shape, against
    the JAX mesh classifier of that shape and the port's single device."""
    segs = [sine_segment(freq=f) for f in (400.0, 900.0, 1400.0, 2100.0, 2600.0)]
    mine = _build(tbt, model_path, LABELS, shape).predict_batch(segs)
    theirs = _build(jbt, model_path, LABELS, shape).predict_batch(segs)
    ref = single.predict_batch(segs)
    assert len(mine) == len(theirs) == 5
    for a, b, c in zip(mine, theirs, ref):
        _same(a, b)
        _same(a, c)


def test_row_masks_match_jax(sharded, jax_sharded):
    rng = np.random.default_rng(1)
    segs = (0.1 * rng.standard_normal((6, 144_000))).astype(np.float32)
    masks = rng.random((6, 10)) < 0.5
    masks[:, 0] = True
    got = sharded.predict_batch(segs, species_masks=masks)
    for row, a, b in zip(masks, got, jax_sharded.predict_batch(segs, species_masks=masks)):
        _same(a, b)
        assert all(row[p.index] for p in a.predictions)


def test_species_list_matches_jax(model_path):
    wanted = ["species_2", "species_5", "species_7"]
    mine = _build(tbt, model_path, LABELS, (2, 4), species_list=(wanted,))
    theirs = _build(jbt, model_path, LABELS, (2, 4), species_list=(wanted,))
    seg = sine_segment(freq=700.0)
    _same(mine.predict(seg), theirs.predict(seg))
    assert {p.species for p in mine.predict(seg).predictions} <= set(wanted)


def test_batch_context_on_mesh(sharded):
    """The context runs the sharded step eagerly (no graph) and equals the
    mesh's predict_batch."""
    ctx = sharded.create_batch_context(8)
    assert ctx.graph is None
    segs = [sine_segment(freq=f) for f in (500.0, 1500.0, 2500.0)]
    results = sharded.predict_batch_with_context(ctx, segs)
    assert len(results) == 3
    for a, b in zip(results, sharded.predict_batch(segs)):
        assert [p.index for p in a.predictions] == [p.index for p in b.predictions]
        np.testing.assert_allclose(a.raw_scores, b.raw_scores, rtol=1e-5, atol=1e-5)


def test_streaming_on_mesh_matches(single, sharded, jax_sharded):
    rng = np.random.default_rng(4)
    audio = (0.2 * rng.normal(size=144_000 * 5)).astype(np.float32)
    mine = sharded.analyze_samples(audio, overlap_seconds=1.0)
    _same_stream(mine, jax_sharded.analyze_samples(audio, overlap_seconds=1.0))
    _same_stream(mine, single.analyze_samples(audio, overlap_seconds=1.0))


def test_streaming_int16_with_call_mask_matches_jax(sharded, jax_sharded):
    pcm = (np.random.default_rng(5).normal(size=144_000 * 4) * 3000).astype(np.int16)
    mask = np.zeros(10, bool)
    mask[[1, 3, 4, 8]] = True
    mine = sharded.analyze_samples(pcm, species_mask=mask)
    _same_stream(mine, jax_sharded.analyze_samples(pcm, species_mask=mask))
    assert all(mask[p.index] for _, preds in mine for p in preds)


def test_streaming_iter_on_mesh(single, sharded):
    audio = (0.1 * np.random.default_rng(6).normal(size=144_000 * 3)).astype(np.float32)
    out = list(sharded.analyze_samples_iter(audio, chunk_segments=2))
    assert len(out) == 3
    _same_stream(out, single.analyze_samples(audio))


def test_mesh_stream_keys_separate_the_call_mask(sharded):
    """A per-call mask makes a streaming key of its own (the JAX engine's
    ``with_mask``; ``streaming_analyze`` asks for it whenever a call passes
    a mask); on host cells every key runs the eager tile loop."""
    eng = sharded._engine
    plain = eng._program(144_000, np.int16, False, False)
    masked = eng._program(144_000, np.int16, False, True)
    assert plain is not masked and eng._program(144_000, np.int16) is plain
    keys = {k for k in eng.programs if k[:3] == (eng.tile, 144_000, "int16")}
    assert {k[4] for k in keys} == {False, True} and len(keys) == 2
    assert all(p.eager and not p.steps for p in eng.programs.values())


def test_mesh_program_caches_are_bounded(sharded):
    """At most MAX_PROGRAMS streaming keys and batch keys, the least
    recently used dropped; a batch key rounds its bucket up to the data
    axis and leaves out ``donate`` and v2.4's missing embeddings; host
    cells get the eager step (no graph)."""
    from birdnet_tpu_torch.compiler.stream import MAX_PROGRAMS

    eng = sharded._engine
    steps = list(range(1000, 1000 + MAX_PROGRAMS + 3))
    for step in steps:
        eng._program(step, np.float32)
    eng._program(steps[-MAX_PROGRAMS], np.float32)  # used again: now the newest
    assert [k[1] for k in eng.programs] == steps[-MAX_PROGRAMS + 1:] + [steps[-MAX_PROGRAMS]]
    program = eng.compiled(5)
    assert program is eng.compiled(8, with_embeddings=False, donate=True)
    assert program.eager and program.bucket == 8
    for b in range(1, MAX_PROGRAMS + 3):
        eng.compiled(4 * b, with_row_mask=True)
    assert len(eng._compiled) == MAX_PROGRAMS
    assert sharded.create_batch_context(4).graph is None


@pytest.mark.parametrize("shape", [(1, 1), (2, 2), (1, 4)], ids=["1x1", "2x2", "1x4"])
def test_batch_buckets_match_jax(model_path, shape):
    """Sizes 1-32 round up to a power of two, then to the data axis, as the
    JAX engine's ``_batch_bucket`` does (at most six buckets)."""
    from types import SimpleNamespace

    from birdnet_tpu.parallel.engine import ShardedEngine as JEngine

    eng = _build(tbt, model_path, LABELS, shape)._engine
    jdp = j_make_mesh(jax.devices()[:shape[0] * shape[1]], shape=shape).shape["data"]
    assert eng.dp == jdp
    mine = {b: eng._batch_bucket(b) for b in range(1, 33)}
    theirs = {b: JEngine._batch_bucket(SimpleNamespace(dp=jdp), b) for b in range(1, 33)}
    assert mine == theirs and len(set(mine.values())) <= 6


def test_padded_bucket_rows_are_sliced_off(model_path, single):
    """Five segments on a 2x2 mesh pad to a bucket of 8 (past the data
    axis' 6): per-request masks, predict_batch and a batch context agree
    with the single device on the real rows."""
    segs = [sine_segment(freq=f) for f in (400.0, 900.0, 1400.0, 2100.0, 2600.0)]
    masks = np.random.default_rng(2).random((5, 10)) < 0.5
    masks[:, 1] = True
    meshed = _build(tbt, model_path, LABELS, (2, 2))
    assert meshed._engine._batch_bucket(5) == 8
    ref = single.predict_batch(segs, species_masks=masks)
    got = meshed.predict_batch(segs, species_masks=masks)
    ctx = meshed.create_batch_context(5)
    in_ctx = meshed.predict_batch_with_context(ctx, segs, species_masks=masks)
    assert len(got) == len(in_ctx) == 5
    for row, a, b, c in zip(masks, got, in_ctx, ref):
        _same(a, c)
        _same(b, c)
        assert all(row[p.index] for p in a.predictions)


def test_cancelled_mesh_call_raises(sharded):
    token = tbt.CancellationToken()
    token.cancel()
    with pytest.raises(tbt.InferenceCancelledError):
        sharded.predict(sine_segment(), options=tbt.InferenceOptions(cancellation_token=token))


def test_embeddings_on_mesh(tmp_path):
    """v3.0 over a 2x4 mesh: embeddings from the m = 0 cells, per call and
    streamed, equal to the JAX mesh classifier's."""
    from birdnet_tpu.models import birdnet_v30

    p = str(tmp_path / "v30.onnx")
    birdnet_v30.save_tiny(p, num_species=10, embedding_dim=32)
    mine = _build(tbt, p, LABELS, (2, 4))
    theirs = _build(jbt, p, LABELS, (2, 4))
    seg = (0.1 * np.random.default_rng(7).standard_normal(160_000)).astype(np.float32)
    r = mine.predict(seg)
    assert r.embeddings.shape == (32,)
    _same(r, theirs.predict(seg), emb=True)
    audio = (0.1 * np.random.default_rng(8).standard_normal(160_000 * 3)).astype(np.float32)
    emb, times = mine.embed_samples(audio)
    j_emb, j_times = theirs.embed_samples(audio)
    assert emb.shape == (3, 32)
    np.testing.assert_allclose(emb, j_emb, **TOL)
    np.testing.assert_allclose(times, j_times)


def test_serving_tier_on_mesh(single, sharded):
    """The DynamicBatcher runs over a mesh classifier unchanged: results
    equal the single-device batcher's."""
    from birdnet_tpu_torch.serve import DynamicBatcher

    rng = np.random.default_rng(11)
    segs = [(0.1 * rng.standard_normal(144_000)).astype(np.float32) for _ in range(6)]
    with DynamicBatcher(single, max_batch=4, max_wait_ms=50) as b_single:
        want = [f.result(timeout=120) for f in [b_single.submit(s) for s in segs]]
    with DynamicBatcher(sharded, max_batch=4, max_wait_ms=50) as b_mesh:
        got = [f.result(timeout=120) for f in [b_mesh.submit(s) for s in segs]]
        assert b_mesh.metrics.snapshot()["batches_total"] <= 6
    for a, c in zip(want, got):
        _same(c, a)


def test_perch_real_head_width_on_mesh(tmp_path):
    """Perch v2 with the real 14,795-class head over a 2x4 mesh: the head
    pads to 14,796 and splits; predictions, logits and embeddings equal the
    JAX mesh classifier's and the port's single device's."""
    from birdnet_tpu.models import perch_v2
    from birdnet_tpu.onnx import proto as P
    from birdnet_tpu.types import ModelType

    p = tmp_path / "perch_real_head.onnx"
    p.write_bytes(P.encode_model(perch_v2.build_model(
        width=0.1, depth=1, num_species=14795, embedding_dim=40)))
    labels = [f"sp_{i}" for i in range(14795)]
    mine = _build(tbt, str(p), labels, (2, 4), top_k=5)
    assert mine._engine.head_sharded and mine._engine._cells.head.n_padded == 14796
    seg = sine_segment(model_type=ModelType.PERCH_V2)
    r = mine.predict(seg)
    assert len(r.raw_scores) == 14795 and r.embeddings.shape == (40,)
    _same(r, _build(jbt, str(p), labels, (2, 4), top_k=5).predict(seg), emb=True)
    _same(r, _build(tbt, str(p), labels, top_k=5).predict(seg), emb=True)


def test_int8_on_mesh_matches_the_single_device(model_path):
    """``.int8()`` then ``with_mesh``: quantized on the controller, the int8
    forward (B3's plain version on the host) in each cell, the same answer
    as the port's single-device int8 classifier."""
    cal = (0.1 * np.random.default_rng(12).standard_normal((4, 144_000))).astype(np.float32)
    mine = _build(tbt, model_path, LABELS, (2, 2), int8=(cal,))
    ref = _build(tbt, model_path, LABELS, int8=(cal,))
    segs = (0.1 * np.random.default_rng(13).standard_normal((4, 144_000))).astype(np.float32)
    for a, b in zip(mine.predict_batch(segs), ref.predict_batch(segs)):
        _same(a, b)
