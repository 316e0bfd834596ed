"""``.btck`` checkpoints in the PyTorch port (birdnet_tpu_torch/checkpoint.py)
against the JAX package's: the same format (version 2, a zip of a manifest,
the optimized graph and flat raw tensor entries), a file written by either
package loads in the other with logits within 1e-4, the same manifests, and
a merged decoder's ``dispatch_inputs`` kept across the two packages."""

import json
import zipfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import birdnet_tpu as jbt  # noqa: E402
import birdnet_tpu_torch as tbt  # noqa: E402
from birdnet_tpu import checkpoint as jck  # noqa: E402
from birdnet_tpu_torch import checkpoint as tck  # noqa: E402
from birdnet_tpu_torch.compiler.importer import import_onnx  # noqa: E402
from birdnet_tpu_torch.errors import ModelLoadError  # noqa: E402
from birdnet_tpu_torch.models import birdnet_v24, birdnet_v30, perch_v2  # noqa: E402
from birdnet_tpu_torch.testutil import mock_labels, sine_segment  # noqa: E402
from _torch_threads import torch_threads  # noqa: E402,F401

MODELS = {
    "v24-conv": (birdnet_v24, dict(num_species=10)),
    "v24-stft": (birdnet_v24, dict(num_species=10, frontend="stft")),
    "v30-conv": (birdnet_v30, dict(num_species=10, embedding_dim=32)),
    "perch-stft": (perch_v2, dict(num_species=12, embedding_dim=48, frontend="stft")),
}


@pytest.fixture(scope="module")
def model_paths(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_ck")
    out = {}
    for name, (module, kw) in MODELS.items():
        out[name] = str(d / f"{name}.onnx")
        module.save(out[name], width=0.1, depth=1, **kw)
    return out


def _labels(path):
    n = import_onnx(path).detection_shapes()[1][-1][-1]
    return mock_labels(n)


def _segments(path, n=2):
    s = import_onnx(path).input_shapes[0][-1]
    rng = np.random.default_rng(31)
    return (rng.normal(size=(n, s)) * 0.1).astype(np.float32)


def _entries(path):
    with zipfile.ZipFile(path) as zf:
        return {i.filename: zf.read(i.filename) for i in zf.infolist()}


@pytest.mark.parametrize("name", sorted(MODELS))
def test_roundtrip(model_paths, tmp_path, name):
    imp = import_onnx(model_paths[name])
    ck = tmp_path / "model.btck"
    tck.save_checkpoint(imp, ck)
    back = tck.load_checkpoint(ck)
    assert back.opset == imp.opset
    assert (back.input_names, back.input_shapes) == (imp.input_names, imp.input_shapes)
    assert (back.output_names, back.output_shapes) == (imp.output_names, imp.output_shapes)
    assert set(back.params) == set(imp.params) and set(back.consts) == set(imp.consts)
    for k in imp.params:
        np.testing.assert_array_equal(back.params[k], imp.params[k])
    for k in imp.consts:
        np.testing.assert_array_equal(back.consts[k], imp.consts[k])
    assert [n.op_type for n in back.graph.node] == [n.op_type for n in imp.graph.node]


@pytest.mark.parametrize("name", sorted(MODELS))
def test_same_file_as_the_jax_package(model_paths, tmp_path, name):
    """Both packages write the same entries from the same ONNX file: equal
    manifests, graph bytes and tensor bytes."""
    from birdnet_tpu.compiler.importer import import_onnx as j_import

    tck.save_checkpoint(import_onnx(model_paths[name]), tmp_path / "t.btck")
    jck.save_checkpoint(j_import(model_paths[name]), tmp_path / "j.btck")
    mine, theirs = _entries(tmp_path / "t.btck"), _entries(tmp_path / "j.btck")
    assert json.loads(mine.pop("manifest.json")) == json.loads(theirs.pop("manifest.json"))
    assert mine.keys() == theirs.keys()
    for key in theirs:
        assert mine[key] == theirs[key], key


def test_checkpoint_strips_stale_initializers(model_paths, tmp_path):
    imp = import_onnx(model_paths["v24-conv"])
    ck = tmp_path / "model.btck"
    tck.save_checkpoint(imp, ck)
    assert imp.graph.initializer  # save must not mutate the model
    assert tck.load_checkpoint(ck).graph.initializer == []
    with zipfile.ZipFile(ck) as zf:
        graph_pb = zf.getinfo("graph.pb").file_size
        flat = sum(i.file_size for i in zf.infolist() if i.filename.startswith(("p/", "c/")))
    assert graph_pb < flat / 4


def test_corrupt_graph_pb_raises_model_load_error(model_paths, tmp_path):
    ck = tmp_path / "model.btck"
    tck.save_checkpoint(import_onnx(model_paths["v24-conv"]), ck)
    ck2 = tmp_path / "corrupt.btck"
    with zipfile.ZipFile(ck) as zin, zipfile.ZipFile(ck2, "w") as zout:
        for item in zin.infolist():
            data = zin.read(item.filename)
            if item.filename == "graph.pb":
                data = data[: len(data) // 2] + b"\xff\xff\xff\xff"
            zout.writestr(item, data)
    with pytest.raises(ModelLoadError):
        tck.load_checkpoint(ck2)


def _rewrite_manifest(src, dst, edit):
    with zipfile.ZipFile(src) as zin, zipfile.ZipFile(dst, "w") as zout:
        for item in zin.infolist():
            data = zin.read(item.filename)
            if item.filename == "manifest.json":
                manifest = json.loads(data)
                edit(manifest)
                data = json.dumps(manifest)
            zout.writestr(item, data)


def test_dispatch_inputs_refused_naming_a11(tmp_path):
    """(Named for what it checked before the port had merged-decoder
    dispatch.) A checkpoint whose ``dispatch_inputs`` is not empty loads
    in either package and dispatches: written by the port, the JAX package
    and the port read the flag list and give the branch each flag value
    selects; a manifest without the key re-detects the flags."""
    from test_freeze_inputs import _merged_decoder_like

    from birdnet_tpu.compiler import make_forward as j_make_forward
    from birdnet_tpu.onnx import proto as jproto
    from birdnet_tpu_torch.compiler.importer import make_forward, params_to_torch

    data = jproto.encode_model(_merged_decoder_like())
    ck = tmp_path / "merged.btck"
    tck.save_checkpoint(import_onnx(data), ck)
    assert json.loads(_entries(ck)["manifest.json"])["dispatch_inputs"] == ["use_cache_branch"]
    older = tmp_path / "older.btck"
    _rewrite_manifest(ck, older, lambda m: m.pop("dispatch_inputs"))
    x = np.arange(6, dtype=np.float32).reshape(2, 3)
    past = np.arange(8, dtype=np.float32).reshape(2, 4)
    for path in (ck, older):
        port, ref = tck.load_checkpoint(path), jck.load_checkpoint(path)
        assert port.dispatch_inputs == ref.dispatch_inputs == ["use_cache_branch"]
        fwd = make_forward(port, "fp32", "cpu")
        jfwd = j_make_forward(ref, precision="fp32")
        for flag, want in ((True, np.concatenate([past, x], 1)), (False, x)):
            (y,) = fwd(params_to_torch(port.params, "cpu"), torch.from_numpy(x),
                       np.array([flag]), torch.from_numpy(past))
            (jy,) = jfwd(ref.params, x, np.array([flag]), past)
            np.testing.assert_array_equal(y.numpy(), want)
            np.testing.assert_array_equal(np.asarray(jy), want)


def test_wrong_version_and_bad_zip(model_paths, tmp_path):
    ck = tmp_path / "model.btck"
    tck.save_checkpoint(import_onnx(model_paths["v24-conv"]), ck)
    v1 = tmp_path / "v1.btck"
    _rewrite_manifest(ck, v1, lambda m: m.update(format_version=1))
    with pytest.raises(ModelLoadError, match="version"):
        tck.load_checkpoint(v1)
    junk = tmp_path / "junk.btck"
    junk.write_bytes(b"PK\x03\x04 but not a zip really")
    with pytest.raises(ModelLoadError):
        tck.import_any(junk)


def test_import_any_sniffs(model_paths, tmp_path):
    imp = tck.import_any(model_paths["v24-conv"])
    ck = tmp_path / "model.btck"
    tck.save_checkpoint(imp, ck)
    assert tck.import_any(ck).output_names == imp.output_names
    assert tck.import_any(open(model_paths["v24-conv"], "rb").read()).output_names == \
        imp.output_names


@pytest.mark.parametrize("name", sorted(MODELS))
def test_classifier_from_checkpoint_matches_onnx(model_paths, tmp_path, name):
    """The port's save_checkpoint, then build() from the .btck: the same
    logits bit for bit at fp32 on the CPU."""
    path, labels = model_paths[name], _labels(model_paths[name])
    build = lambda p: (tbt.Classifier.builder().model_path(p).labels(labels)
                       .precision("fp32").with_device("cpu").build())
    clf = build(path)
    ck = tmp_path / "model.btck"
    clf.save_checkpoint(ck)
    segs = _segments(path)
    for r1, r2 in zip(clf.predict_batch(segs), build(ck).predict_batch(segs)):
        np.testing.assert_array_equal(r1.raw_scores, r2.raw_scores)


@pytest.mark.parametrize("name", sorted(MODELS))
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_crosses_packages(model_paths, tmp_path, name, writer):
    """A .btck written by one package builds in the other: logits (and
    embeddings) within 1e-4 of the writer's own classifier at fp32."""
    path, labels = model_paths[name], _labels(model_paths[name])
    ck = tmp_path / f"{writer}.btck"
    t = (tbt.Classifier.builder().model_path(path if writer == "port" else ck)
         .labels(labels).precision("fp32").with_device("cpu"))
    j = jbt.Classifier.builder().model_path(path if writer == "jax" else ck).labels(
        labels).precision("fp32")
    if writer == "jax":
        j = j.build()
        j.save_checkpoint(ck)
        t = t.build()
    else:
        t = t.build()
        t.save_checkpoint(ck)
        j = j.build()
    segs = _segments(path)
    with jax.default_matmul_precision("highest"):
        want = j.predict_batch(segs)
    for r, q in zip(t.predict_batch(segs), want):
        np.testing.assert_allclose(r.raw_scores, q.raw_scores, rtol=0, atol=1e-4)
        if q.embeddings is not None:
            np.testing.assert_allclose(r.embeddings, np.asarray(q.embeddings), rtol=0, atol=1e-4)
        assert [p.index for p in r.predictions] == [p.index for p in q.predictions]


def test_testutil_segment_through_a_checkpoint(model_paths, tmp_path):
    labels = mock_labels(10)
    clf = (tbt.Classifier.builder().model_path(model_paths["v24-conv"]).labels(labels)
           .with_device("cpu").build())
    ck = tmp_path / "model.btck"
    clf.save_checkpoint(ck)
    clf2 = tbt.Classifier.builder().model_path(ck).labels(labels).with_device("cpu").build()
    np.testing.assert_array_equal(clf.predict(sine_segment()).raw_scores,
                                  clf2.predict(sine_segment()).raw_scores)
