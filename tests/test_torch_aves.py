"""HuBERT-large's encoder (the AVES/BirdAVES bioacoustic embedding models)
through the PyTorch port on the CPU, at a small size from the program's own
generator (``models/aves_hubert.py`` ``save_tiny``: 80,000 samples, conv
32, model 64 in 4 heads, FFN 128, 2 layers, 16 classes):

- the port's own model type: detection and override of ``(80000, 2)``, the
  demux, and a refused ``(80000, 3)``;
- ``Classifier.embed_samples`` and ``predict`` at fp32 within 1e-4 of the
  scale of the benchmark's plain reference (``benchmark/reference/
  hubert_encoder.py``) on the file's own weights, with and without overlap;
- the file's forward through both packages' importers at fp32, within 1e-4
  of the scale of the JAX package's (the port's lowering of these ops held
  to the JAX package's);
- the import-time attention bundling (``compiler/fuse_attention.py``): the
  model's two chains fused and each form of chain it takes, every one
  interpreted on the CPU bit for bit as unfused, and the chains it keeps
  counted;
- the interpreter's release schedule, the counters in the recorder and the
  CLI's ``--model-type aves``.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import birdnet_tpu_torch as tbt  # noqa: E402
from benchmark.reference import hubert_encoder  # noqa: E402
from birdnet_tpu.compiler import importer as jimp  # noqa: E402
from birdnet_tpu_torch import _demux  # noqa: E402
from birdnet_tpu_torch.compiler import fuse_attention, importer as timp  # noqa: E402
from birdnet_tpu_torch.errors import ModelDetectionError  # noqa: E402
from birdnet_tpu_torch.models import aves_hubert  # noqa: E402
from birdnet_tpu_torch.onnx import proto as P  # noqa: E402
from birdnet_tpu_torch.port_types import PortModelType, detect_model_type  # noqa: E402
from birdnet_tpu_torch.utils import profiling  # noqa: E402
from _torch_threads import torch_threads  # noqa: E402,F401

FP32_TOL = 1e-4
RATE, S, SPECIES = 16_000, 80_000, 16
# save_tiny's sizes, as the reference reads them.
TINY = {"conv_dim": [32] * 7, "conv_kernel": list(aves_hubert.CONV_KERNELS),
        "conv_stride": list(aves_hubert.CONV_STRIDES), "hidden_size": 64,
        "num_attention_heads": 4, "intermediate_size": 128, "num_hidden_layers": 2,
        "num_conv_pos_embeddings": 16, "num_conv_pos_embedding_groups": 4,
        "layer_norm_eps": aves_hubert.LAYER_NORM_EPS, "num_species": SPECIES}


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("aves") / "aves_tiny.onnx")
    aves_hubert.save_tiny(path, num_species=SPECIES)
    return path


def _classifier(path):
    return (tbt.Classifier.builder().model_path(path)
            .labels([f"s{i}" for i in range(SPECIES)]).precision("fp32")
            .with_device("cpu").build())


def _reference_weights(path):
    """The file's initializers under the reference's names (the program's
    builder names a convolution's weight and bias ``fe0_w``, ``fe0_b``)."""
    model = P.load_model(path)
    out = {}
    for t in model.graph.initializer:
        name = t.name
        for conv in [f"fe{i}" for i in range(7)] + ["pos"]:
            if name in (f"{conv}_w", f"{conv}_b"):
                name = f"{conv}.{name[-1]}"
        out[name] = torch.from_numpy(np.array(t.to_numpy(), np.float32))
    return out


def _pcm(samples, seed):
    rng = np.random.default_rng(seed)
    gain = rng.uniform(0.05, 1.0, samples // RATE + 1).repeat(RATE)[:samples]
    return (rng.normal(size=samples) * 3000 * gain).clip(-32768, 32767).astype(np.int16)


def _segments(pcm, step):
    n = -(-len(pcm) // step)
    out = np.zeros((n, S), np.int16)
    for i in range(n):
        part = pcm[i * step:i * step + S]
        out[i, :len(part)] = part
    return out


def _within(got, want, tol=FP32_TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


# -- the model type -----------------------------------------------------------


def test_detection_key_and_demux(tiny):
    clf = _classifier(tiny)
    assert clf.model_type is PortModelType.AVES
    assert clf.config.sample_rate == RATE and clf.config.sample_count == S
    assert clf.config.segment_duration == 5.0
    assert (clf.config.num_species, clf.config.embedding_dim) == (SPECIES, 64)
    assert _demux.demux_indices(PortModelType.AVES) == (1, 0)
    assert PortModelType.AVES.has_embeddings
    assert PortModelType.AVES.expected_label_format is tbt.LabelFormat.CSV


@pytest.mark.parametrize("override", [None, PortModelType.AVES])
def test_detection_of_the_port_key(override):
    cfg = detect_model_type([1, S], [[1, 1024], [1, 6522]], override)
    assert cfg.model_type is PortModelType.AVES
    assert (cfg.num_species, cfg.embedding_dim, cfg.sample_rate) == (6522, 1024, RATE)


@pytest.mark.parametrize("shapes,override,message", [
    ([[1, 8], [1, 8], [1, 8]], None, "unsupported model: 80000 samples, 3 outputs"),
    ([[1, 8], [1, 8], [1, 8]], PortModelType.AVES, "expects 2 outputs, got 3"),
    ([[1, 8], [1, 8]], tbt.ModelType.BIRDNET_V30, "expects 160000 samples"),
])
def test_detection_refuses(shapes, override, message):
    with pytest.raises(ModelDetectionError, match=message):
        detect_model_type([1, S], shapes, override)


@pytest.mark.parametrize("key", [((1, 144_000), 1), ((1, 160_000), 2), ((1, 160_000), 4)])
def test_reference_types_detect_as_before(key):
    from birdnet_tpu_torch.detection import detect_model_type as reference_detection

    (inp, n) = key
    outs = [[1, 12]] * n
    assert detect_model_type(inp, outs) == reference_detection(inp, outs)


def test_builder_override_validates_the_shapes(tiny):
    clf = (tbt.Classifier.builder().model_path(tiny).labels([f"s{i}" for i in range(SPECIES)])
           .model_type(PortModelType.AVES).with_device("cpu").build())
    assert clf.model_type is PortModelType.AVES
    with pytest.raises(ModelDetectionError):
        (tbt.Classifier.builder().model_path(tiny).labels([f"s{i}" for i in range(SPECIES)])
         .model_type(tbt.ModelType.PERCH_V2).with_device("cpu").build())


# -- the classifier against the plain reference ---------------------------------


@pytest.mark.parametrize("overlap", [0.0, 1.5])
def test_embed_samples_matches_the_reference(tiny, overlap):
    clf = _classifier(tiny)
    pcm = _pcm(3 * S, seed=int(overlap * 10) + 1)
    emb, starts = clf.embed_samples(pcm, overlap_seconds=overlap)
    step = S - int(overlap * RATE)
    segs = _segments(pcm, step)
    assert emb.shape == (len(segs), 64) and len(starts) == len(segs)
    with torch.inference_mode():
        want = hubert_encoder.forward(TINY, _reference_weights(tiny), torch.from_numpy(segs))
    _within(emb, want["embedding"].numpy())


def test_predict_matches_the_reference(tiny):
    clf = _classifier(tiny)
    seg = _pcm(S, seed=7)
    r = clf.predict(seg.astype(np.float32) / 32768.0)
    with torch.inference_mode():
        want = hubert_encoder.forward(TINY, _reference_weights(tiny), torch.from_numpy(seg[None]))
    _within(r.raw_scores, want["logits"].numpy()[0])
    _within(r.embeddings, want["embedding"].numpy()[0])


def test_file_through_both_importers(tiny):
    data = open(tiny, "rb").read()
    x = (_pcm(2 * S, seed=3).reshape(2, S) / 32768.0).astype(np.float32)
    jm = jimp.import_onnx(data)
    want = jax.jit(jimp.make_forward(jm, precision="fp32"))(jm.params, x)
    tm = timp.import_onnx(data)
    got = timp.make_forward(tm, "fp32", "cpu")(timp.params_to_torch(tm.params, "cpu"),
                                               torch.from_numpy(x))
    for g, w in zip(got, want):
        _within(g.numpy(), np.asarray(w))


# -- the attention bundling -------------------------------------------------------


def _unfused(monkeypatch, data):
    monkeypatch.setattr(fuse_attention, "fuse_attention", lambda graph, tensors, opset=17: (0, 0))
    return timp.import_onnx(data)


def _forward(model, *xs):
    return timp.make_forward(model, "fp32", "cpu")(timp.params_to_torch(model.params, "cpu"), *xs)


def test_the_model_chains_fuse_and_run_bit_for_bit(tiny, monkeypatch):
    data = open(tiny, "rb").read()
    before = profiling.snapshot()
    fused = timp.import_onnx(data)
    d = profiling.snapshot() - before
    assert [n.op_type for n in fused.graph.node].count("_FusedAttention") == 2
    assert "Softmax" not in [n.op_type for n in fused.graph.node]
    assert d.counters.get("birdnet.compiler.attention_fused") == 2
    assert "birdnet.compiler.attention_kept" not in d.counters
    unfused = _unfused(monkeypatch, data)
    assert [n.op_type for n in unfused.graph.node].count("Softmax") == 2
    x = torch.from_numpy((_pcm(2 * S, seed=9).reshape(2, S) / 32768.0).astype(np.float32))
    for a, b in zip(_forward(fused, x), _forward(unfused, x)):
        assert torch.equal(a, b)


def _attention_graph(form, k_layout, softmax_axis=-1, probs_out=False):
    """One attention chain over Q, K, V graph inputs (B 2, H 3, T 5, d 4):
    ``form`` places the scale (``pre_mul`` on Q, ``post_mul``/``post_div``
    on the scores, ``none``); ``k_layout`` ``bhsd`` transposes K
    ``[B, H, S, d]`` by ``[0, 1, 3, 2]``, ``bshd`` K ``[B, S, H, d]`` by
    ``[0, 2, 3, 1]``."""
    scale = np.array(0.5, np.float32)
    inits = [P.TensorProto.from_numpy(scale, name="c")]
    nodes = []
    q = "q"
    if form == "pre_mul":
        nodes.append(P.make_node("Mul", ["q", "c"], ["qs"]))
        q = "qs"
    perm = [0, 1, 3, 2] if k_layout == "bhsd" else [0, 2, 3, 1]
    nodes.append(P.make_node("Transpose", ["k"], ["kt"], perm=perm))
    nodes.append(P.make_node("MatMul", [q, "kt"], ["s"]))
    scores = "s"
    if form in ("post_mul", "post_div"):
        nodes.append(P.make_node("Mul" if form == "post_mul" else "Div", ["s", "c"], ["ss"]))
        scores = "ss"
    nodes.append(P.make_node("Softmax", [scores], ["p"], axis=softmax_axis))
    nodes.append(P.make_node("MatMul", ["p", "v"], ["y"]))
    k_shape = [2, 3, 5, 4] if k_layout == "bhsd" else [2, 5, 3, 4]
    inputs = [P.make_value_info(n, P.DataType.FLOAT, s)
              for n, s in (("q", [2, 3, 5, 4]), ("k", k_shape), ("v", [2, 3, 5, 4]))]
    outputs = [P.make_value_info("y", P.DataType.FLOAT, [2, 3, 5, 4])]
    if probs_out:
        outputs.append(P.make_value_info("p", P.DataType.FLOAT, [2, 3, 5, 5]))
    graph = P.GraphProto(name="attention", node=nodes, initializer=inits, input=inputs,
                         output=outputs)
    return P.encode_model(P.make_model(graph, opset_version=17)), k_shape


def _inputs(k_shape, seed=0):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            for s in ([2, 3, 5, 4], k_shape, [2, 3, 5, 4])]


@pytest.mark.parametrize("form", ["pre_mul", "post_mul", "post_div", "none"])
@pytest.mark.parametrize("k_layout", ["bhsd", "bshd"])
def test_each_chain_form_fuses_and_runs_as_unfused(form, k_layout, monkeypatch):
    data, k_shape = _attention_graph(form, k_layout)
    fused = timp.import_onnx(data)
    (node,) = fused.graph.node
    assert node.op_type == "_FusedAttention"
    assert list(node.input) == ["q", "k", "v"]
    assert list(node.attrs["k_perm"]) == ([0, 1, 3, 2] if k_layout == "bhsd" else [0, 2, 3, 1])
    assert node.attrs["scale"] == pytest.approx(1.0 if form == "none" else
                                               2.0 if form == "post_div" else 0.5)
    xs = _inputs(k_shape)
    (y,) = _forward(fused, *xs)
    (want,) = _forward(_unfused(monkeypatch, data), *xs)
    assert torch.equal(y, want)
    q, k, v = (x.double() for x in xs)
    k = k if k_layout == "bhsd" else k.transpose(1, 2)
    ref = torch.softmax(node.attrs["scale"] * q @ k.transpose(-1, -2), dim=-1) @ v
    assert torch.allclose(y.double(), ref, atol=1e-6)


@pytest.mark.parametrize("variant", ["softmax_axis_2", "probabilities_read_elsewhere"])
def test_other_chains_are_kept_and_counted(variant):
    if variant == "softmax_axis_2":
        data, _ = _attention_graph("post_mul", "bhsd", softmax_axis=2)
    else:
        data, _ = _attention_graph("post_mul", "bhsd", probs_out=True)
    before = profiling.snapshot()
    model = timp.import_onnx(data)
    d = profiling.snapshot() - before
    assert "_FusedAttention" not in [n.op_type for n in model.graph.node]
    assert d.counters.get("birdnet.compiler.attention_kept") == 1
    assert "birdnet.compiler.attention_fused" not in d.counters


# -- the interpreter, the recorder and the CLI ------------------------------------------


def test_release_schedule_drops_every_intermediate_once(tiny):
    model = timp.import_onnx(open(tiny, "rb").read())
    graph = model.graph
    release = timp.release_schedule(graph, set(model.output_names))
    dropped = [name for names in release for name in names]
    produced = {o for n in graph.node for o in n.output if o}
    assert sorted(dropped) == sorted(produced - set(model.output_names))
    # Each is dropped after its last reader: no later node reads it.
    for i, names in enumerate(release):
        later = {x for n in graph.node[i + 1:] for x in n.input}
        assert not later & set(names)
    env = {}
    env.update(timp.params_to_torch(model.params, "cpu"))
    env.update({k: v for k, v in model.consts.items()})
    x = torch.zeros(1, S)
    env["input"] = x
    timp.interpret_graph(graph, model.opset, "fp32", env, model.output_names, "cpu",
                         release=release)
    assert not (set(env) & (produced - set(model.output_names)))


def test_trace_writes_the_import_counters(tiny, tmp_path):
    timp.import_onnx(open(tiny, "rb").read())
    with profiling.trace(str(tmp_path / "prof")):
        pass
    spans = json.loads((tmp_path / "prof" / "spans.json").read_text())
    assert spans["compiler"]["birdnet.compiler.attention_fused"] >= 2
    assert "birdnet.compiler.attention_kept" in spans["compiler"]
    assert spans["compiler"]["birdnet.compiler.gelu_fused"] >= 10
    assert "birdnet.compiler.gelu_kept" in spans["compiler"]


def test_cli_takes_model_type_aves(tiny, tmp_path, capsys):
    from birdnet_tpu_torch.cli import PORT_MODEL_TYPES, main
    from birdnet_tpu_torch.utils.audio_io import write_wav

    assert PORT_MODEL_TYPES["aves"] is PortModelType.AVES
    labels = tmp_path / "labels.csv"
    labels.write_text("\n".join(f"s{i},Species {i}" for i in range(SPECIES)), encoding="utf-8")
    wav = tmp_path / "a.wav"
    write_wav(wav, (_pcm(2 * S, seed=5) / 32768.0).astype(np.float32), RATE)
    rc = main([str(wav), "-m", tiny, "-l", str(labels), "--provider", "cpu",
               "--model-type", "aves", "--min-confidence", "0.0", "-t", "0"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "AVES (HuBERT)" in out and "2 segments" in out
