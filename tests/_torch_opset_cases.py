"""Graphs of the port's long-tail core ops and ai.onnx.ml heads at
realistic shapes, built with the port's own codec: it imports numpy and
birdnet_tpu_torch only, so the card's machine, which has no JAX, runs it.
tests/test_torch_cuda.py and chip_smoke.py's op_sets phase hold the card to
the host with it (fp32, TF32 off, within ``TOL`` of each output's largest
magnitude; the random ops bit for bit).

``CASES[name] = (nodes, inputs, inits, outputs, opset)``, ``inputs`` and
``inits`` functions that make their arrays when called (a worker that only
collects the tests allocates nothing; ``inputs_of(name)``): one graph per
op at the shapes a BirdNET user meets (spectrogram images [32, 1, 96, 511],
the backbone's head map [32, 1280, 3, 16], logits over 6,522 species, a
KV cache [32, 8, 1024, 64]). ``RANDOM`` names the random ops' cases.

``ml_heads(emb, seed)`` writes the ai.onnx.ml heads a user fits on
embeddings ``emb`` [N, E]: Scaler -> LinearClassifier (SOFTMAX, 20
classes, int64 labels), Normalizer -> SVMClassifier (RBF, one-vs-one over
5 classes, 256 support vectors, Platt probabilities),
TreeEnsembleClassifier (100 trees of depth 8) and a TreeEnsemble (v5)
regressor, their attributes drawn with numpy from ``seed``;
``linear_oracle`` is the linear head in numpy.
"""

from __future__ import annotations

import numpy as np

from birdnet_tpu_torch.onnx import proto as P

F = P.DataType
TOL = 1e-5
ML = "ai.onnx.ml"
BATCH = 32
IMG = (BATCH, 1, 96, 511)
HEAD_MAP = (BATCH, 1280, 3, 16)
SPECIES = 6522
N_ROIS = 300
CASES = {}
RANDOM = ("RandomNormal", "RandomNormal_seedless", "RandomUniformLike", "Bernoulli",
          "Multinomial")


def _n(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


def _u(shape, seed, lo, hi):
    return np.random.default_rng(seed).uniform(lo, hi, size=shape).astype(np.float32)


def _case(name, nodes, inputs, inits=dict, outputs=("y",), opset=21):
    CASES[name] = (nodes, inputs, inits, list(outputs), opset)


def inputs_of(name: str) -> dict:
    return CASES[name][1]()


def model_bytes(name: str) -> bytes:
    nodes, inputs, inits, outputs, opset = CASES[name]
    inputs, inits = inputs(), inits()
    init = [P.TensorProto.from_numpy(np.asarray(v), name=k) for k, v in inits.items()]
    in_vis = [P.make_value_info(k, P._NUMPY_TO_DTYPE[np.asarray(v).dtype],
                                list(np.asarray(v).shape)) for k, v in inputs.items()]
    out_vis = [P.make_value_info(n, F.FLOAT, []) for n in outputs]
    graph = P.GraphProto(name=name, node=list(nodes), initializer=init, input=in_vis,
                         output=out_vis)
    return P.encode_model(P.make_model(graph, opset_version=opset))


# GridSample and AffineGrid on spectrogram images (SpecAugment-style warps).
def _grid():
    return _u(IMG[:1] + IMG[2:] + (2,), 1, -1.05, 1.05)


_case("GridSample_bilinear", [P.make_node("GridSample", ["x", "g"], ["y"], mode="bilinear",
                                          padding_mode="zeros", align_corners=0)],
      lambda: {"x": _n(IMG, 0), "g": _grid()}, opset=16)
_case("GridSample_bicubic", [P.make_node("GridSample", ["x", "g"], ["y"], mode="cubic",
                                         padding_mode="border", align_corners=1)],
      lambda: {"x": _n(IMG, 0), "g": _grid()}, opset=20)
_case("AffineGrid_GridSample", [
    P.make_node("AffineGrid", ["theta", "size"], ["grid"], align_corners=0),
    P.make_node("GridSample", ["x", "grid"], ["y"], mode="linear", padding_mode="reflection"),
], lambda: {"x": _n(IMG, 0),
            "theta": np.eye(2, 3, dtype=np.float32)[None] + _n((BATCH, 2, 3), 2, 0.05)},
    lambda: {"size": np.asarray(IMG, np.int64)}, opset=20)


# RoiAlign and MaxRoiPool: 300 boxes over the backbone's head map.
def _rois():
    """([N_ROIS, 4] boxes (x1, y1, x2, y2) inside the map, their images)."""
    r = np.random.default_rng(3)
    xy = r.uniform([0, 0], [12, 2], size=(N_ROIS, 2))
    wh = r.uniform([1, 0.5], [6, 2], size=(N_ROIS, 2))
    boxes = np.concatenate([xy, np.minimum(xy + wh, [16, 3])], 1).astype(np.float32)
    return boxes, r.integers(0, BATCH, size=N_ROIS).astype(np.int64)


_case("RoiAlign", [P.make_node("RoiAlign", ["x", "rois", "bidx"], ["y"], mode="avg",
                               output_height=2, output_width=4, sampling_ratio=2)],
      lambda: {"x": _n(HEAD_MAP, 4), "rois": _rois()[0]}, lambda: {"bidx": _rois()[1]},
      opset=16)
_case("MaxRoiPool", [P.make_node("MaxRoiPool", ["x", "rois"], ["y"], pooled_shape=[2, 4])],
      lambda: {"x": _n(HEAD_MAP, 4),
               "rois": np.concatenate([_rois()[1][:, None].astype(np.float32), _rois()[0]],
                                      1)})

# DeformConv: a 3x3 deformable conv on a [32, 64, 48, 256] feature map.
_case("DeformConv", [P.make_node("DeformConv", ["x", "w", "off", "b"], ["y"],
                                 kernel_shape=[3, 3], pads=[1, 1, 1, 1])],
      lambda: {"x": _n((BATCH, 64, 48, 256), 5), "off": _n((BATCH, 18, 48, 256), 6)},
      lambda: {"w": _n((64, 64, 3, 3), 7, 1 / 24), "b": _n((64,), 8, 0.1)}, opset=19)

# Col2Im as overlap-add: 511 frames of 1024 at hop 280 into 143,920 samples.
_case("Col2Im", [P.make_node("Col2Im", ["x", "img", "blk"], ["y"], strides=[1, 280])],
      lambda: {"x": _n((BATCH, 1024, 511), 9)},
      lambda: {"img": np.asarray([1, 143_920], np.int64),
               "blk": np.asarray([1, 1024], np.int64)}, opset=18)


# Losses over the species logits, one target ignored.
def _targets():
    t = np.random.default_rng(10).integers(0, SPECIES, size=BATCH).astype(np.int64)
    t[3] = -100
    return t


_case("NegativeLogLikelihoodLoss", [
    P.make_node("LogSoftmax", ["x"], ["lp"], axis=1),
    P.make_node("NegativeLogLikelihoodLoss", ["lp", "t", "w"], ["y"], reduction="mean",
                ignore_index=-100),
], lambda: {"x": _n((BATCH, SPECIES), 11, 4.0), "t": _targets()},
    lambda: {"w": _u((SPECIES,), 12, 0.5, 2.0)}, opset=13)
_case("SoftmaxCrossEntropyLoss", [
    P.make_node("SoftmaxCrossEntropyLoss", ["x", "t"], ["y", "lp"], reduction="none",
                ignore_index=-100),
], lambda: {"x": _n((BATCH, SPECIES), 13, 4.0), "t": _targets()}, outputs=("y", "lp"),
    opset=13)

# The RMS normalizations on [32, 64, 1024] activations; MVN over time per
# mel band of a [32, 96, 511] spectrogram.
_case("RMSNormalization", [P.make_node("RMSNormalization", ["x", "s"], ["y"], axis=-1,
                                       epsilon=1e-6)],
      lambda: {"x": _n((BATCH, 64, 1024), 14)}, lambda: {"s": _u((1024,), 15, 0.5, 1.5)},
      opset=23)
_case("SimplifiedLayerNormalization", [
    P.make_node("SimplifiedLayerNormalization", ["x", "s"], ["y", "inv"], axis=-1,
                epsilon=1e-6)],
      lambda: {"x": _n((BATCH, 64, 1024), 16)}, lambda: {"s": _u((1024,), 17, 0.5, 1.5)},
      outputs=("y", "inv"), opset=17)
_case("MeanVarianceNormalization", [P.make_node("MeanVarianceNormalization", ["x"], ["y"],
                                                axes=[2])],
      lambda: {"x": _n((BATCH, 96, 511), 18, 3.0) + 5.0}, opset=13)


# TensorScatter: one decode step's keys written into a [32, 8, 1024, 64]
# cache at per-row positions given on the card, linear and circular.
def _kv_step(offset):
    pos = np.random.default_rng(19).integers(0, 1023, size=BATCH).astype(np.int64)
    return {"past": _n((BATCH, 8, 1024, 64), 20), "upd": _n((BATCH, 8, 1, 64), 21),
            "pos": pos + offset}


for _mode, _offset in (("linear", 0), ("circular", 1000)):
    _case(f"TensorScatter_{_mode}", [
        P.make_node("TensorScatter", ["past", "upd", "pos"], ["y"], axis=-2, mode=_mode)],
        lambda offset=_offset: _kv_step(offset), opset=24)

_case("Det", [P.make_node("Det", ["x"], ["y"])], lambda: {"x": _n((4096, 3, 3), 22)},
      opset=11)

# The random ops: noise over the species logits and the spectrogram.
_case("RandomNormal", [P.make_node("RandomNormal", [], ["y"], shape=[BATCH, SPECIES],
                                   mean=0.5, scale=2.0, seed=3.0)],
      lambda: {"x": np.zeros(1, np.float32)})
_case("RandomNormal_seedless", [P.make_node("RandomNormal", [], ["y"], shape=[BATCH, SPECIES],
                                            name="noise")],
      lambda: {"x": np.zeros(1, np.float32)})
_case("RandomUniformLike", [P.make_node("RandomUniformLike", ["x"], ["y"], low=-1.0, high=1.0,
                                        seed=4.0)], lambda: {"x": _n(IMG[:1] + IMG[2:], 23)})
_case("Bernoulli", [P.make_node("Bernoulli", ["p"], ["y"], seed=5.0)],
      lambda: {"p": _u((BATCH, SPECIES), 24, 0.0, 1.0)}, opset=15)
_case("Multinomial", [P.make_node("Multinomial", ["x"], ["y"], sample_size=8, seed=6.0)],
      lambda: {"x": _n((BATCH, SPECIES), 25, 3.0)}, opset=7)


# ---------------------------------------------------------------------------
# tests/test_compiler_conformance.py's ops at a BirdNET user's shapes
# ---------------------------------------------------------------------------

FMAP = (BATCH, 64, 96, 256)  # an early feature map of the backbone
I64 = np.int64


def _ties(shape, seed):
    """Values on a half-step grid, so that maxima and minima tie."""
    return np.round(_n(shape, seed) * 2) / 2


def _ints(shape, seed, lo, hi, dtype=np.int32):
    return np.random.default_rng(seed).integers(lo, hi, size=shape).astype(dtype)


def _nonzero_ints(shape, seed):
    v = _ints(shape, seed, -40, 40)
    return np.where(v == 0, 7, v).astype(np.int32)


_case("Mod_fmod", [P.make_node("Mod", ["a", "b"], ["y"], fmod=1)],
      lambda: {"a": _n((BATCH, SPECIES), 30, 50.0), "b": _u((SPECIES,), 31, 0.5, 7.0)},
      opset=13)
_case("Mod_integer", [P.make_node("Mod", ["a", "b"], ["y"])],
      lambda: {"a": _ints((BATCH, SPECIES), 32, -1000, 1000),
               "b": _nonzero_ints((SPECIES,), 33)}, opset=13)
_case("Reduce_noop_and_full", [
    P.make_node("ReduceSum", ["x"], ["y"], noop_with_empty_axes=1),
    P.make_node("ReduceMean", ["x"], ["z"])],
    lambda: {"x": _n(HEAD_MAP, 34)}, outputs=("y", "z"), opset=18)
_case("ArgMax_ArgMin_select_last_index", [
    P.make_node("ArgMax", ["x"], ["y"], axis=1, keepdims=0, select_last_index=1),
    P.make_node("ArgMin", ["x"], ["z"], axis=-1, keepdims=1, select_last_index=1)],
    lambda: {"x": _ties((BATCH, SPECIES), 35)}, outputs=("y", "z"), opset=13)
# Range on host values (a float step that does not divide, and integers),
# added to a row on the card.
_case("Range_float_and_int", [
    P.make_node("Range", ["s", "l", "d"], ["r"]),
    P.make_node("Add", ["x", "r"], ["y"]),
    P.make_node("Range", ["si", "li", "di"], ["ri"]),
    P.make_node("Cast", ["ri"], ["rf"], to=F.FLOAT),
    P.make_node("Add", ["x", "rf"], ["z"])],
    lambda: {"x": _n((BATCH, 1), 36)},
    lambda: {"s": np.float32(0.25), "l": np.float32(2413.3), "d": np.float32(0.37),
             "si": I64(-3000), "li": I64(3522), "di": I64(1)},
    outputs=("y", "z"), opset=11)
_case("Slice_negative_steps", [
    P.make_node("Slice", ["x", "s1", "e1", "a", "t1"], ["y"]),
    P.make_node("Slice", ["x", "s2", "e2", "a", "t2"], ["z"])],
    lambda: {"x": _n((BATCH, 96, 511), 37)},
    lambda: {"s1": np.array([-1], I64), "e1": np.array([-10 ** 9], I64),
             "t1": np.array([-1], I64), "a": np.array([2], I64),
             "s2": np.array([10 ** 6], I64), "e2": np.array([0], I64),
             "t2": np.array([-3], I64)},
    outputs=("y", "z"), opset=13)
# Resize's coordinate modes on the spectrogram image, the opset-10 form
# (scales only) and the opset-18 ``axes`` attribute.
_RESIZE_MODES = {
    "nearest_asymmetric": (dict(mode="nearest", coordinate_transformation_mode="asymmetric",
                                nearest_mode="floor"), [1.0, 1.0, 2.0, 2.0]),
    "linear_align_corners": (dict(mode="linear",
                                  coordinate_transformation_mode="align_corners"),
                             [1.0, 1.0, 0.5, 0.5]),
    "linear_pytorch_half_pixel": (dict(mode="linear",
                                       coordinate_transformation_mode="pytorch_half_pixel"),
                                  [1.0, 1.0, 1.5, 0.25]),
    "linear_half_pixel": (dict(mode="linear"), [1.0, 1.0, 2.0, 0.5]),
    "nearest_half_pixel_prefer_floor": (dict(mode="nearest",
                                             coordinate_transformation_mode="half_pixel",
                                             nearest_mode="round_prefer_floor"),
                                        [1.0, 1.0, 1.5, 1.5]),
}
_case("Resize_coordinate_modes", [
    P.make_node("Resize", ["x", "", f"sc_{m}"], [f"y_{m}"], **attrs)
    for m, (attrs, _) in _RESIZE_MODES.items()],
    lambda: {"x": _n(IMG, 38)},
    lambda: {f"sc_{m}": np.array(sc, np.float32) for m, (_, sc) in _RESIZE_MODES.items()},
    outputs=tuple(f"y_{m}" for m in _RESIZE_MODES), opset=13)
_case("Resize_opset10", [P.make_node("Resize", ["x", "sc"], ["y"], mode="linear")],
      lambda: {"x": _n(IMG, 39)}, lambda: {"sc": np.array([1.0, 1.0, 2.0, 0.5], np.float32)},
      opset=10)
_case("Resize_axes", [P.make_node("Resize", ["x", "", "", "sz"], ["y"], mode="linear",
                                  axes=[2, 3])],
      lambda: {"x": _n(IMG, 40)}, lambda: {"sz": np.array([128, 256], I64)}, opset=18)
# MaxPool's indices (row- and column-major storage, padded and dilated, 1-D,
# one column wide) and MaxUnpool back through them.
_case("MaxPool_indices_storage_orders", [
    P.make_node("MaxPool", ["x"], ["y", "i"], kernel_shape=[3, 3], strides=[2, 2],
                pads=[1, 1, 1, 1]),
    P.make_node("MaxPool", ["x"], ["y2", "i2"], kernel_shape=[3, 3], strides=[2, 2],
                pads=[1, 1, 1, 1], storage_order=1)],
    lambda: {"x": _ties(FMAP, 41)}, outputs=("y", "i", "y2", "i2"), opset=12)
_case("MaxPool_indices_padded_dilated", [
    P.make_node("MaxPool", ["x"], ["y", "i"], kernel_shape=[3, 3], strides=[1, 2],
                pads=[2, 2, 2, 2], dilations=[2, 2])],
    lambda: {"x": _n(FMAP, 42)}, outputs=("y", "i"), opset=12)
_case("MaxPool_indices_1d", [
    P.make_node("MaxPool", ["x"], ["y", "i"], kernel_shape=[3], strides=[2])],
    lambda: {"x": _n((BATCH, 96, 511), 43)}, outputs=("y", "i"), opset=12)
_case("MaxPool_indices_width_one", [
    P.make_node("MaxPool", ["x"], ["y", "i"], kernel_shape=[2, 1], strides=[2, 1]),
    P.make_node("MaxPool", ["x"], ["y2", "i2"], kernel_shape=[2, 1], strides=[2, 1],
                storage_order=1)],
    lambda: {"x": _n((BATCH, 64, 96, 1), 44)}, outputs=("y", "i", "y2", "i2"), opset=12)
_case("MaxUnpool_roundtrip", [
    P.make_node("MaxPool", ["x"], ["p", "i"], kernel_shape=[2, 2], strides=[2, 2]),
    P.make_node("MaxUnpool", ["p", "i"], ["y"], kernel_shape=[2, 2], strides=[2, 2])],
    lambda: {"x": _n(FMAP, 45)}, opset=12)
_case("ScatterElements_min_max", [
    P.make_node("ScatterElements", ["x", "idx", "u"], ["y"], axis=1, reduction="min"),
    P.make_node("ScatterElements", ["x", "idx", "u"], ["z"], axis=1, reduction="max")],
    lambda: {"x": _n((BATCH, SPECIES), 46), "idx": _ints((BATCH, 2048), 47, 0, SPECIES, I64),
             "u": _n((BATCH, 2048), 48, 3.0)}, outputs=("y", "z"), opset=18)
_case("ConvTranspose_grouped", [
    P.make_node("ConvTranspose", ["x", "w", "b"], ["y"], group=4, strides=[2, 2],
                pads=[1, 1, 1, 1], output_padding=[1, 1])],
    lambda: {"x": _n((BATCH, 64, 24, 64), 49)},
    lambda: {"w": _n((64, 16, 3, 3), 50, 0.1), "b": _n((64,), 51)}, opset=17)
_case("GatherND_batch_dims", [
    P.make_node("GatherND", ["x", "i1"], ["y"], batch_dims=1),
    P.make_node("GatherND", ["x", "i2"], ["z"], batch_dims=1)],
    lambda: {"x": _n((BATCH, 96, 511), 52), "i1": _ints((BATCH, 200, 1), 53, 0, 96, I64),
             "i2": np.concatenate([_ints((BATCH, 300, 1), 54, 0, 96, I64),
                                   _ints((BATCH, 300, 1), 55, 0, 511, I64)], axis=-1)},
    outputs=("y", "z"), opset=13)
_case("Pad_negative_crop", [
    P.make_node("Pad", ["x", "p"], ["y"]),
    P.make_node("Pad", ["x", "q"], ["z"], mode="constant")],
    lambda: {"x": _n(IMG, 56)},
    lambda: {"p": np.array([0, 0, -5, -11, 0, 0, -3, -7], I64),
             "q": np.array([0, 0, 2, -11, 0, 0, -3, 4], I64)}, outputs=("y", "z"), opset=13)
_case("LayerNormalization_skipped_output", [
    P.make_node("LayerNormalization", ["x", "s", "b"], ["y", "", "inv"], axis=-1)],
    lambda: {"x": _n((BATCH, 64, 1280), 57)},
    lambda: {"s": _u((1280,), 58, 0.5, 1.5), "b": _n((1280,), 59)},
    outputs=("y", "inv"), opset=17)
_case("Conv_BatchNormalization_folded", [
    P.make_node("Conv", ["x", "w", "cb"], ["c"], pads=[1, 1, 1, 1]),
    P.make_node("BatchNormalization", ["c", "scale", "bias", "mean", "var"], ["y"])],
    lambda: {"x": _n((BATCH, 32, 96, 128), 60)},
    lambda: {"w": _n((64, 32, 3, 3), 61, 0.1), "cb": _n((64,), 62),
             "scale": _u((64,), 63, 0.5, 1.5), "bias": _n((64,), 64),
             "mean": _n((64,), 65), "var": _u((64,), 66, 0.5, 2.0)}, opset=17)

# Batch-separable cases whose host reference may run on the first rows only
# (the card runs all 32): the host's CPU takes seconds for each.
HOST_SLICED = ("GridSample_bilinear", "GridSample_bicubic", "AffineGrid_GridSample",
               "DeformConv", "MaxPool_indices_storage_orders",
               "MaxPool_indices_padded_dilated", "MaxUnpool_roundtrip", "ConvTranspose_grouped",
               "Conv_BatchNormalization_folded")


# ---------------------------------------------------------------------------
# ai.onnx.ml heads on embeddings
# ---------------------------------------------------------------------------

HEADS = ("linear", "svm", "trees", "trees_v5")
N_LINEAR_CLASSES = 20
N_SVM_CLASSES, N_SV = 5, 256
N_TREES, TREE_DEPTH = 100, 8


def _ml_model(nodes, n_features, outputs, ml_opset) -> bytes:
    graph = P.GraphProto(
        name="head", node=nodes,
        input=[P.make_value_info("emb", F.FLOAT, ["N", n_features])],
        output=[P.make_value_info(n, F.FLOAT, []) for n in outputs])
    return P.encode_model(P.ModelProto(
        ir_version=8, producer_name="t", producer_version="0", graph=graph,
        opset_import=[P.OperatorSetId(domain="", version=17),
                      P.OperatorSetId(domain=ML, version=ml_opset)]))


def linear_attrs(emb: np.ndarray, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    e = emb.shape[1]
    return {"offset": emb.mean(0).astype(np.float32),
            "scale": (1.0 / (emb.std(0) + 1e-6)).astype(np.float32),
            "coef": (rng.normal(size=(N_LINEAR_CLASSES, e)) / np.sqrt(e)).astype(np.float32),
            "intercepts": rng.normal(size=N_LINEAR_CLASSES).astype(np.float32),
            "labels": np.arange(100, 100 + N_LINEAR_CLASSES, dtype=np.int64)}


def linear_oracle(emb: np.ndarray, a: dict) -> tuple:
    """(labels, scores) of the Scaler -> LinearClassifier head in float64."""
    z = (emb.astype(np.float64) - a["offset"]) * a["scale"]
    s = z @ a["coef"].T.astype(np.float64) + a["intercepts"]
    s = np.exp(s - s.max(1, keepdims=True))
    s /= s.sum(1, keepdims=True)
    return a["labels"][s.argmax(1)], s


def _tree_nodes(emb, rng, tree_id, depth):
    """One full binary tree of ``depth`` (v1 node lists): features drawn at
    random, each threshold a value of that feature in a random row."""
    n_inner = 2 ** depth - 1
    nodes = []
    for g in range(2 ** (depth + 1) - 1):
        if g < n_inner:
            f = int(rng.integers(emb.shape[1]))
            nodes.append((tree_id, g, f, float(emb[rng.integers(len(emb)), f]),
                          "BRANCH_LEQ", 2 * g + 1, 2 * g + 2))
        else:
            nodes.append((tree_id, g, 0, 0.0, "LEAF", 0, 0))
    return nodes


def ml_heads(emb: np.ndarray, seed: int) -> dict:
    """{head: model bytes} of the four heads on embeddings ``emb``."""
    rng = np.random.default_rng(seed)
    e = emb.shape[1]
    a = linear_attrs(emb, seed)
    heads = {"linear": _ml_model([
        P.make_node("Scaler", ["emb"], ["z"], domain=ML, offset=a["offset"].tolist(),
                    scale=a["scale"].tolist()),
        P.make_node("LinearClassifier", ["z"], ["label", "scores"], domain=ML,
                    coefficients=a["coef"].reshape(-1).tolist(),
                    intercepts=a["intercepts"].tolist(),
                    classlabels_int64s=a["labels"].tolist(), post_transform="SOFTMAX"),
    ], e, ("label", "scores"), 1)}

    # SVM: L2-normalized embeddings, support vectors from the rows.
    unit = emb / np.maximum(np.linalg.norm(emb, axis=1, keepdims=True), 1e-12)
    counts = np.full(N_SVM_CLASSES, N_SV // N_SVM_CLASSES)
    counts[: N_SV % N_SVM_CLASSES] += 1
    sv = unit[rng.choice(len(unit), N_SV, replace=len(unit) < N_SV)]
    sv = (sv + rng.normal(size=sv.shape) * 0.01).astype(np.float32)
    n_pairs = N_SVM_CLASSES * (N_SVM_CLASSES - 1) // 2
    heads["svm"] = _ml_model([
        P.make_node("Normalizer", ["emb"], ["z"], domain=ML, norm="L2"),
        P.make_node("SVMClassifier", ["z"], ["label", "scores"], domain=ML,
                    kernel_type="RBF", kernel_params=[1.0, 0.0, 3.0],
                    vectors_per_class=counts.tolist(),
                    support_vectors=sv.reshape(-1).tolist(),
                    coefficients=rng.normal(size=(N_SVM_CLASSES - 1) * N_SV).tolist(),
                    rho=rng.normal(size=n_pairs).tolist(),
                    prob_a=(-rng.uniform(1.0, 3.0, n_pairs)).tolist(),
                    prob_b=rng.normal(size=n_pairs, scale=0.1).tolist(),
                    classlabels_int64s=list(range(N_SVM_CLASSES))),
    ], e, ("label", "scores"), 1)

    # A forest of full trees (v1), a vote per leaf over 3 classes.
    nodes = [n for t in range(N_TREES) for n in _tree_nodes(emb, rng, t, TREE_DEPTH)]
    leaves = [(t, g) for t, g, _, _, mode, _, _ in nodes if mode == "LEAF"]
    heads["trees"] = _ml_model([P.make_node(
        "TreeEnsembleClassifier", ["emb"], ["label", "scores"], domain=ML,
        nodes_treeids=[n[0] for n in nodes], nodes_nodeids=[n[1] for n in nodes],
        nodes_featureids=[n[2] for n in nodes], nodes_values=[n[3] for n in nodes],
        nodes_modes=[n[4] for n in nodes], nodes_truenodeids=[n[5] for n in nodes],
        nodes_falsenodeids=[n[6] for n in nodes],
        class_treeids=[t for t, _ in leaves], class_nodeids=[g for _, g in leaves],
        class_ids=rng.integers(0, 3, size=len(leaves)).tolist(),
        class_weights=(rng.uniform(size=len(leaves)) / N_TREES).tolist(),
        classlabels_int64s=[0, 1, 2], post_transform="NONE")], e, ("label", "scores"), 1)

    # The v5 regressor: the same shape of forest, leaves apart, 2 targets.
    n_inner = 2 ** TREE_DEPTH - 1
    feats, splits, t_ids, f_ids, t_leaf, f_leaf, roots = [], [], [], [], [], [], []
    for t in range(N_TREES):
        base, leaf_base = t * n_inner, t * (n_inner + 1)
        roots.append(base)
        for g in range(n_inner):
            f = int(rng.integers(e))
            feats.append(f)
            splits.append(float(emb[rng.integers(len(emb)), f]))
            for kid, ids, leafs in ((2 * g + 1, t_ids, t_leaf), (2 * g + 2, f_ids, f_leaf)):
                if kid < n_inner:
                    ids.append(base + kid)
                    leafs.append(0)
                else:
                    ids.append(leaf_base + kid - n_inner)
                    leafs.append(1)
    n_leaves = N_TREES * (n_inner + 1)
    heads["trees_v5"] = _ml_model([P.make_node(
        "TreeEnsemble", ["emb"], ["y"], domain=ML,
        nodes_featureids=feats,
        nodes_splits=P.TensorProto.from_numpy(np.asarray(splits, np.float32)),
        nodes_modes=P.TensorProto.from_numpy(np.zeros(len(feats), np.uint8)),
        nodes_truenodeids=t_ids, nodes_falsenodeids=f_ids,
        nodes_trueleafs=t_leaf, nodes_falseleafs=f_leaf,
        leaf_targetids=rng.integers(0, 2, size=n_leaves).tolist(),
        leaf_weights=P.TensorProto.from_numpy(rng.normal(size=n_leaves).astype(np.float32)),
        tree_roots=roots, n_targets=2, aggregate_function=1, post_transform=0)],
        e, ("y",), 5)
    return heads
