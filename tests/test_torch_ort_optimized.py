"""BirdNET files as onnxruntime's offline optimizer saves them
(``ORT_ENABLE_ALL``): tests/_torch_contrib_cases.py's ``ort_optimized``
folds BatchNormalization into Conv, writes each ``x·sigmoid(x)`` as
com.microsoft QuickGelu(alpha=1) and each squeeze-excite gate (a Conv whose
only consumer is a Sigmoid) as com.microsoft FusedConv(activation=
"Sigmoid"). Tiny v2.4 (conv and STFT frontends) and Perch files, fp32:

- through ``Classifier``, the port equals the JAX package on the rewritten
  file (logits within 1e-4, the same top-K, per call and streamed);
- in each package the rewritten file gives the original file's logits
  (within 1e-4 of their scale);
- the frontend fusions still bundle (the learned filterbank or the STFT
  chain, B2 / B1 on the card), while the stage-prefix pass (B4) does not
  fire: its pattern is the plain Sigmoid/Mul spelling, in both packages.
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import _torch_contrib_cases as cc  # noqa: E402

import birdnet_tpu as jbt  # noqa: E402
import birdnet_tpu_torch as tbt  # noqa: E402
from birdnet_tpu.compiler.importer import import_onnx as j_import  # noqa: E402
from birdnet_tpu_torch.compiler.importer import import_onnx as t_import  # noqa: E402
from birdnet_tpu_torch.models import birdnet_v24, perch_v2  # noqa: E402
from _torch_threads import torch_threads  # noqa: E402,F401

TOL = 1e-4
CASES = [("v24", "conv"), ("v24", "stft"), ("perch", "conv")]
IDS = [f"{f}-{fe}" for f, fe in CASES]
SPECIES = {"v24": 10, "perch": 12}
SAMPLES = {"v24": (48_000, 144_000), "perch": (32_000, 160_000)}


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("ort")
    out = {}
    for family, frontend in CASES:
        if family == "v24":
            proto = birdnet_v24.build_model(num_species=10, width=0.1, depth=1, seed=0,
                                            frontend=frontend)
        else:
            proto = perch_v2.build_model(num_species=12, embedding_dim=48, width=0.1,
                                         depth=1, seed=2, frontend=frontend)
        from birdnet_tpu_torch.onnx import proto as P

        orig = P.encode_model(proto)
        paths = (d / f"{family}_{frontend}.onnx", d / f"{family}_{frontend}_ort.onnx")
        paths[0].write_bytes(orig)
        paths[1].write_bytes(cc.ort_optimized(orig))
        out[family, frontend] = tuple(str(p) for p in paths)
    return out


def _build(pkg, path, family):
    b = (pkg.Classifier.builder().model_path(path)
         .labels([f"Genus{i}_Species {i}" for i in range(SPECIES[family])])
         .precision("fp32").top_k(3))
    return (b.with_device("cpu") if pkg is tbt else b).build()


@pytest.fixture(scope="module")
def segments():
    return (np.random.default_rng(31).normal(size=(3, 160_000)) * 0.1).astype(np.float32)


@pytest.mark.parametrize("family,frontend", CASES, ids=IDS)
def test_the_rewrite_uses_the_ort_spellings_and_the_frontend_still_fuses(files, family,
                                                                         frontend):
    orig, ort = files[family, frontend]
    hist = cc.op_histogram(open(ort, "rb").read())
    assert "BatchNormalization" not in hist
    assert hist["com.microsoft.QuickGelu"] > 0 and hist["com.microsoft.FusedConv"] > 0
    fused = {"conv": "_FusedFrontend", "stft": "_FusedStftFrontend"}[frontend]
    for importer in (t_import, j_import):
        before = [n.op_type for n in importer(orig).graph.node]
        after = [n.op_type for n in importer(ort).graph.node]
        assert fused in after and fused in before
        if family == "v24":
            assert "_FusedStagePrefix" in before  # B4's pass on the plain spelling
        assert "_FusedStagePrefix" not in after and "_FusedMBConv" not in after


@pytest.mark.parametrize("family,frontend", CASES, ids=IDS)
def test_rewritten_file_matches_jax_and_the_original(files, segments, family, frontend):
    orig, ort = files[family, frontend]
    x = segments[:, :SAMPLES[family][1]]
    t_ort, t_orig = _build(tbt, ort, family), _build(tbt, orig, family)
    j_ort, j_orig = _build(jbt, ort, family), _build(jbt, orig, family)
    got = np.stack([r.raw_scores for r in t_ort.predict_batch(x)])
    with jax.default_matmul_precision("highest"):
        want = np.stack([np.asarray(r.raw_scores) for r in j_ort.predict_batch(x)])
        j_base = np.stack([np.asarray(r.raw_scores) for r in j_orig.predict_batch(x)])
    t_base = np.stack([r.raw_scores for r in t_orig.predict_batch(x)])
    for a, b in ((got, want), (got, t_base), (want, j_base)):
        scale = float(np.abs(b).max())
        assert float(np.abs(a - b).max()) <= TOL * scale
    assert [[p.index for p in r.predictions] for r in t_ort.predict_batch(x)] == \
        [[p.index for p in r.predictions] for r in j_ort.predict_batch(x)]


@pytest.mark.parametrize("family,frontend", CASES, ids=IDS)
def test_streamed_top_k_matches_jax(files, family, frontend):
    _, ort = files[family, frontend]
    rate, _ = SAMPLES[family]
    pcm = (np.random.default_rng(32).normal(size=rate * 10) * 3000).astype(np.int16)
    t, j = _build(tbt, ort, family), _build(jbt, ort, family)
    got = t.analyze_samples(pcm, overlap_seconds=1.0)
    with jax.default_matmul_precision("highest"):
        want = j.analyze_samples(pcm, overlap_seconds=1.0)
    assert len(got) == len(want) >= 3
    for (tt, preds), (tj, ref) in zip(got, want):
        assert tt == pytest.approx(tj)
        assert [p.index for p in preds] == [p.index for p in ref]
        np.testing.assert_allclose([p.confidence for p in preds],
                                   [p.confidence for p in ref], rtol=0, atol=TOL)
