"""Post-training int8 quantization in the port against the JAX package, on
tiny BirdNET v2.4 files (``save_tiny``'s size) in both frontend forms: the
same calibration statistics, the same quantized graph and tensors given the
same statistics, the same int8 forward, and ClassifierBuilder.int8's
calibration forms on the CPU; and on tiny BirdNET v3.0 and Perch v2 files
in both frontend forms, the int8 forward and the int8 stream
(``test_int8_v30_and_perch_match_jax``)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import birdnet_tpu as jbt  # noqa: E402
import birdnet_tpu_torch as tbt  # noqa: E402
from birdnet_tpu.compiler import importer as jimp  # noqa: E402
from birdnet_tpu.compiler import quantize as jq  # noqa: E402
from birdnet_tpu_torch.compiler import importer as timp  # noqa: E402
from birdnet_tpu_torch.compiler import quantize as tq  # noqa: E402
from birdnet_tpu_torch.models import birdnet_v24, birdnet_v30, perch_v2  # noqa: E402
from birdnet_tpu_torch.onnx import proto as P  # noqa: E402
from _torch_threads import torch_threads  # noqa: E402,F401

LABELS = [f"s{i}" for i in range(32)]
# Calibration interprets the float graph at fp32 in both packages; the sums
# run in other orders, so the abs-max statistics agree to float32 rounding.
STATS_RTOL = 1e-5
# The int8 forward of one quantized model through both packages at fp32:
# max |Δ| over the largest |logit|.
INT8_SCALED_TOL = 1e-2


@pytest.fixture(scope="module", params=["conv", "stft"])
def tiny_path(request, tmp_path_factory):
    p = tmp_path_factory.mktemp("q") / f"v24_tiny_{request.param}.onnx"
    # save_tiny's model (width 0.1, depth 1) in the requested frontend form
    birdnet_v24.save(p, num_species=32, width=0.1, depth=1, seed=0, frontend=request.param)
    return str(p)


def _segments(n, count=144_000, seed=3):
    """Sines plus noise, as tests/test_quantize.py draws them."""
    rng = np.random.default_rng(seed)
    t = np.arange(count, dtype=np.float32)
    rows = []
    for i in range(n):
        sig = 0.4 * np.sin(2 * np.pi * (300.0 + 700.0 * i) * t / 48_000.0)
        sig += 0.05 * rng.standard_normal(count)
        rows.append(sig.astype(np.float32))
    return np.stack(rows)


def _plain(v):
    """A codec value as plain Python, comparable across the two packages."""
    if hasattr(v, "to_numpy") and hasattr(v, "dims"):
        arr = v.to_numpy()
        return ("tensor", str(arr.dtype), arr.shape, arr.tobytes())
    if hasattr(v, "node") and hasattr(v, "initializer"):
        return ("graph", [_node(n) for n in v.node])
    if isinstance(v, (list, tuple)):
        return [_plain(x) for x in v]
    return v


def _node(n):
    return (n.op_type, n.domain, list(n.input), list(n.output),
            {k: _plain(v) for k, v in sorted(n.attrs.items())})


def _quantize_both(path, calibration, monkeypatch, same_stats):
    """(port model, JAX model, port stats, JAX stats). With ``same_stats``
    the port's calibration is replaced by the JAX package's statistics."""
    recorded = {}
    j_collect, t_collect = jq._collect_absmax, tq._collect_absmax

    def j_record(*args, **kwargs):
        recorded["jax"] = j_collect(*args, **kwargs)
        return recorded["jax"]

    def t_record(*args, **kwargs):
        recorded["port"] = t_collect(*args, **kwargs)
        return dict(recorded["jax"]) if same_stats else recorded["port"]

    monkeypatch.setattr(jq, "_collect_absmax", j_record)
    monkeypatch.setattr(tq, "_collect_absmax", t_record)
    jmodel = jq.quantize_model(jimp.import_onnx(path), calibration)
    tmodel = tq.quantize_model(timp.import_onnx(path), calibration, device="cpu")
    return tmodel, jmodel, recorded["port"], recorded["jax"]


def test_calibration_statistics_match_jax(tiny_path, monkeypatch):
    _, _, mine, theirs = _quantize_both(tiny_path, [_segments(2)], monkeypatch, False)
    assert mine.keys() == theirs.keys() and len(mine) > 10
    for name, value in theirs.items():
        assert mine[name] == pytest.approx(value, rel=STATS_RTOL), name


def test_quantized_model_matches_jax_given_same_stats(tiny_path, monkeypatch):
    mine, theirs, _, _ = _quantize_both(tiny_path, [_segments(2)], monkeypatch, True)
    assert [_node(n) for n in mine.graph.node] == [_node(n) for n in theirs.graph.node]
    assert any(n.op_type == "QLinearConv" for n in mine.graph.node)
    assert ([t.name for t in mine.graph.initializer]
            == [t.name for t in theirs.graph.initializer])
    for a, b in zip(mine.graph.initializer, theirs.graph.initializer):
        assert _plain(a) == _plain(b), a.name
    for got, want in ((mine.params, theirs.params), (mine.consts, theirs.consts)):
        assert got.keys() == want.keys()
        for name, arr in want.items():
            assert got[name].dtype == arr.dtype, name
            np.testing.assert_array_equal(got[name], arr, err_msg=name)
    assert (mine.input_names, mine.input_shapes, mine.output_names, mine.output_shapes) == (
        theirs.input_names, theirs.input_shapes, theirs.output_names, theirs.output_shapes)
    assert mine.param_bytes() == theirs.param_bytes()


def test_int8_forward_matches_jax(tiny_path):
    """The JAX-quantized model through both forwards at fp32 (the JAX side
    eagerly, as tests/test_quantize.py runs it): scaled max |Δ| within
    INT8_SCALED_TOL and the same top-1 on every row."""
    model = jq.quantize_model(jimp.import_onnx(tiny_path), [_segments(4, seed=1)])
    x = _segments(4, seed=9)
    want = np.asarray(jimp.make_forward(model, "fp32")(model.params, x)[0])
    got = timp.make_forward(model, "fp32", "cpu")(
        timp.params_to_torch(model.params, "cpu"), torch.from_numpy(x))[0].numpy()
    assert got.shape == want.shape == (4, 32)
    assert np.abs(got - want).max() / np.abs(want).max() <= INT8_SCALED_TOL
    np.testing.assert_array_equal(got.argmax(1), want.argmax(1))


def test_quantize_structure_and_params(tiny_path):
    model = timp.import_onnx(tiny_path)
    qmodel = tq.quantize_model(model, [_segments(2)], device="cpu")
    ops = [n.op_type for n in qmodel.graph.node]
    assert "QLinearConv" in ops and "QuantizeLinear" in ops
    assert any(p.dtype == np.int8 for p in qmodel.params.values())
    assert qmodel.param_bytes() < model.param_bytes()
    assert not any(n.op_type.startswith(("QLinear", "_QLinear")) for n in model.graph.node)


def test_quantized_top1_matches_fp32(tiny_path):
    """The bound of tests/test_quantize.py for the port's own quantization:
    the fp32 winner in the int8 top-3 on every row, max |Δ| < 0.1 and every
    row's logit correlation above 0.98."""
    model = timp.import_onnx(tiny_path)
    qmodel = tq.quantize_model(model, [_segments(4, seed=1), _segments(4, seed=2)],
                               device="cpu")
    x = torch.from_numpy(_segments(4, seed=9))
    run = lambda m: timp.make_forward(m, "fp32", "cpu")(
        timp.params_to_torch(m.params, "cpu"), x)[0].numpy()
    logits, qlogits = run(model), run(qmodel)
    top3 = np.argsort(qlogits, axis=1)[:, -3:]
    for i, win in enumerate(logits.argmax(axis=1)):
        assert win in top3[i]
    assert np.abs(logits - qlogits).max() < 0.1
    for row, qrow in zip(logits, qlogits):
        assert np.corrcoef(row, qrow)[0, 1] > 0.98


def _builder(pkg, path):
    b = pkg.Classifier.builder().model_path(path).labels(LABELS).top_k(5)
    return b.with_device("cpu") if pkg is tbt else b


def test_builder_int8_end_to_end_matches_jax(tiny_path):
    calibration = [_segments(4)]
    seg = _segments(1, seed=42)[0]
    fp = _builder(tbt, tiny_path).build().predict(seg)
    q = _builder(tbt, tiny_path).int8(calibration_segments=calibration).build().predict(seg)
    assert q.predictions[0].species == fp.predictions[0].species
    assert len({p.species for p in fp.predictions} & {p.species for p in q.predictions}) >= 3
    jq_result = _builder(jbt, tiny_path).int8(calibration_segments=calibration).build().predict(seg)
    assert q.predictions[0].species == jq_result.predictions[0].species
    scale = np.abs(jq_result.raw_scores).max()
    assert np.abs(q.raw_scores - jq_result.raw_scores).max() / scale <= INT8_SCALED_TOL


@pytest.mark.parametrize("calibration", ["synthetic", "raw-int16", "2d-stack"])
def test_builder_int8_calibration_forms(tiny_path, calibration):
    """None (synthetic audio), a raw 1-D int16 recording (chunked into
    segments) and a 2-D [N, sample_count] stack (split into batches)."""
    if calibration == "synthetic":
        arg = None
    elif calibration == "raw-int16":
        arg = (np.random.default_rng(0).normal(size=144_000 * 5) * 4000).astype(np.int16)
    else:
        arg = _segments(6)
    clf = _builder(tbt, tiny_path).int8(arg).build()
    assert clf.device == torch.device("cpu")
    res = clf.predict(_segments(1)[0])
    assert len(res.predictions) > 0 and np.isfinite(res.raw_scores).all()
    assert res.raw_scores.shape == (32,)


# v3.0 and Perch (tests/test_torch_families.py's tiny files): one
# JAX-quantized model through both packages' interpreters at fp32 (the JAX
# side eagerly, as its forward runs), every integer tensor compared. The conv
# forms agree code for code and their logits within FAMILY_INT8_TOL of the
# logits' scale. In the STFT forms the frontend's float sums run in another
# order, and its QuantizeLinear can move a code by one where the two
# packages' x / scale fall on either side of a half-integer: that is the first
# integer tensor to differ, and each of its moved codes sits at such a tie.
# From the JAX package's codes there on, the port's logits are within
# FAMILY_INT8_TOL; as computed, within FAMILY_INT8_TIE_TOL, set from the
# readings on these inputs (perch-stft 3.19e-3 with 4 of 190,848 codes
# moved, v30-stft 1.31e-3 with 1). Each package calibrating for itself, the
# streamed top-3 equal and confidences within FAMILY_STREAM_TOL.
FAMILY_INT8_TOL = 2e-3
FAMILY_INT8_TIE_TOL = 4e-3
FAMILY_STREAM_TOL = 5e-3
FAMILIES = {"v30": (birdnet_v30, 10, 32, 1), "perch": (perch_v2, 12, 48, 2)}


def _first_code_difference(graph, tenv, jenv):
    """(index, node, output name) of the first node whose integer output
    differs between the two packages' environments, or None."""
    for k, node in enumerate(graph.node):
        for name in filter(None, node.output):
            a, b = np.asarray(tenv[name]), np.asarray(jenv[name])
            if a.dtype.kind in "iu" and not np.array_equal(a, b):
                return k, node, name
    return None


@pytest.mark.parametrize("family,frontend", [(f, fe) for f in FAMILIES
                                             for fe in ("conv", "stft")])
def test_int8_v30_and_perch_match_jax(tmp_path, family, frontend):
    module, n, emb, seed = FAMILIES[family]
    path = str(tmp_path / f"{family}_{frontend}.onnx")
    module.save(path, num_species=n, embedding_dim=emb, width=0.1, depth=1, seed=seed,
                frontend=frontend)
    calibration = [_segments(4, count=160_000, seed=1)]
    model = jq.quantize_model(jimp.import_onnx(path), calibration)
    x = _segments(3, count=160_000, seed=9)
    (name,) = model.input_names
    jenv = {**model.consts, **model.params, name: x}
    want = np.asarray(jimp.interpret_graph(model.graph, model.opset, "fp32", jenv,
                                           model.output_names)[-1])
    params = timp.params_to_torch(model.params, "cpu")
    tenv = {**timp.consts_to_device(model.consts, "cpu", model.graph), **params,
            name: torch.from_numpy(x)}
    got = timp.interpret_graph(model.graph, model.opset, "fp32", tenv, model.output_names,
                               "cpu")[-1].numpy()
    forward = timp.make_forward(model, "fp32", "cpu")(params, torch.from_numpy(x))[-1]
    np.testing.assert_array_equal(forward.numpy(), got)
    assert got.shape == want.shape == (3, n)
    np.testing.assert_array_equal(got.argmax(1), want.argmax(1))
    scale = np.abs(want).max()
    first = _first_code_difference(model.graph, tenv, jenv)
    if frontend == "conv":
        assert first is None
        assert np.abs(got - want).max() <= FAMILY_INT8_TOL * scale
    else:
        k, node, out = first
        assert node.op_type == "QuantizeLinear"
        codes_t, codes_j = np.asarray(tenv[out]).astype(np.int64), np.asarray(jenv[out])
        moved = np.argwhere(codes_t != codes_j)
        assert np.abs(codes_t - codes_j).max() == 1
        q_scale = np.float32(np.asarray(jenv[node.input[1]]))
        pre_t = np.asarray(tenv[node.input[0]]).astype(np.float32) / q_scale
        pre_j = np.asarray(jenv[node.input[0]]).astype(np.float32) / q_scale
        for i in map(tuple, moved):
            lo, hi = sorted((pre_t[i], pre_j[i]))
            assert np.floor(hi - 0.5) + 0.5 >= lo, (i, pre_t[i], pre_j[i])
        assert np.abs(got - want).max() <= FAMILY_INT8_TIE_TOL * scale
        # The rest of the graph from the JAX package's codes.
        env = {**tenv, out: torch.from_numpy(np.array(jenv[out]))}
        tail = P.GraphProto(name="tail", node=list(model.graph.node[k + 1:]))
        from_codes = timp.interpret_graph(tail, model.opset, "fp32", env,
                                          model.output_names, "cpu")[-1].numpy()
        assert np.abs(from_codes - want).max() <= FAMILY_INT8_TOL * scale

    labels = [f"s{i}" for i in range(n)]
    pcm = (np.random.default_rng(5).normal(size=32_000 * 12) * 3000).astype(np.int16)
    rows = []
    for pkg in (tbt, jbt):
        b = pkg.Classifier.builder().model_path(path).labels(labels).top_k(3)
        b = b.with_device("cpu") if pkg is tbt else b
        rows.append(b.int8(calibration_segments=calibration).build().analyze_samples(pcm))
    mine, theirs = rows
    assert len(mine) == len(theirs) == 3
    for (tt, preds), (tj, ref) in zip(mine, theirs):
        assert tt == pytest.approx(tj)
        assert [p.index for p in preds] == [p.index for p in ref]
        np.testing.assert_allclose([p.confidence for p in preds],
                                   [p.confidence for p in ref], rtol=0,
                                   atol=FAMILY_STREAM_TOL)


def test_quantize_rejects_model_without_layers():
    g = P.GraphProto(
        name="t",
        node=[P.make_node("Sigmoid", ["x"], ["y"])],
        initializer=[],
        input=[P.make_value_info("x", P.DataType.FLOAT, [1, 4])],
        output=[P.make_value_info("y", P.DataType.FLOAT, [1, 4])],
    )
    model = timp.import_onnx(P.make_model(g))
    with pytest.raises(tbt.ModelLoadError, match="no quantizable layers"):
        tq.quantize_model(model, [np.ones((1, 4), np.float32)], device="cpu")


def test_quantize_keeps_float_weight_shared_with_unquantized_node():
    """A weight tied to an eligible MatMul and to a float-only consumer
    keeps its float copy (the JAX package's regression case, with ops the
    port carries)."""
    rng = np.random.default_rng(5)
    w = rng.normal(size=(16, 8)).astype(np.float32)
    x = rng.normal(size=(4, 16)).astype(np.float32)
    nodes = [
        P.make_node("MatMul", ["x", "w"], ["m"]),
        P.make_node("Sigmoid", ["m"], ["r"]),
        P.make_node("ReduceSumSquare", ["w"], ["wsum"], keepdims=1),
        P.make_node("Mul", ["r", "scale2"], ["r2"]),
        P.make_node("MatMul", ["r2", "w2"], ["y0"]),
        P.make_node("Add", ["y0", "wsum"], ["y"]),
    ]
    inits = {"w": w, "w2": rng.normal(size=(8, 1)).astype(np.float32),
             "scale2": np.full(8, 0.5, np.float32)}
    g = P.GraphProto(
        name="t", node=nodes,
        initializer=[P.TensorProto.from_numpy(v, name=k) for k, v in inits.items()],
        input=[P.make_value_info("x", P.DataType.FLOAT, [4, 16])],
        output=[P.make_value_info("y", P.DataType.FLOAT, [4, 1])],
    )
    model = timp.import_onnx(P.make_model(g), optimize=False)
    q = tq.quantize_model(model, [x], quantize_first_layer=True, device="cpu")
    assert "w" in q.params or "w" in q.consts
    xt = torch.from_numpy(x)
    run = lambda m: timp.make_forward(m, "fp32", "cpu")(timp.params_to_torch(m.params, "cpu"), xt)[0]
    y_ref, y_q = run(model), run(q)
    np.testing.assert_allclose(y_q.numpy(), y_ref.numpy(), rtol=0.1, atol=0.1)


def test_calibration_helpers_match_jax():
    for mine, theirs in zip(tq.synthetic_calibration_segments(1000, batches=3, batch_size=2),
                            jq.synthetic_calibration_segments(1000, batches=3, batch_size=2)):
        np.testing.assert_array_equal(mine, theirs)
    rec = (np.random.default_rng(1).normal(size=10_000) * 3000).astype(np.int16)
    for mine, theirs in zip(tq.calibration_from_samples(rec, 3_000),
                            jq.calibration_from_samples(rec, 3_000)):
        np.testing.assert_array_equal(mine, theirs)
