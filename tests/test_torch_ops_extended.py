"""The port's long tail of the ai.onnx core (birdnet_tpu_torch/compiler/
ops_extended.py) against the JAX package's, part 1: trivial math, shape
surgery, data-dependent shapes, losses, sequences, optionals, the RMS
normalizations and TensorScatter.

Every test function of tests/test_ops_extended.py outside the spatial ops
(tests/test_torch_spatial_ops.py) runs with its runners (``run_graph``,
eager; ``jit_run``, jitted) swapped for ones that run the same graph on
the same numpy inputs through both packages (tests/_torch_dual.py): fp32,
the port within 1e-4 of each output's scale, sequences element by element,
and the test's own oracle on the port's outputs.

Taken out of that dual, with the reason: the random ops (``RANDOM``).
Their bits are torch's, drawn on the host, where the JAX package's are
jax.random's, so their values cannot match. Each of those tests runs on
the port alone, its own distribution and determinism checks on the port's
values, and the port's own cases below hold them by distribution (10^5
draws, within 5 standard errors) and by seed.
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import test_ops_extended as ext  # noqa: E402
from _torch_dual import graph_runner, jax_cases, port_only, run_case  # noqa: E402

from birdnet_tpu.onnx import proto as P  # noqa: E402
from birdnet_tpu_torch.compiler import ops as tops  # noqa: E402
from birdnet_tpu_torch.compiler.importer import import_onnx, make_forward  # noqa: E402

SPATIAL = ("grid_sample", "affine_grid", "roi_align", "col2im", "nms", "deform_conv",
           "max_roi_pool")
RANDOM = {
    "test_random_normal_stats_and_determinism": "RandomNormal's values are torch's bits",
    "test_random_uniform_range_dtype": "RandomUniform's values are torch's bits",
    "test_random_like_shapes": "the *Like ops' values are torch's bits",
    "test_bernoulli_extremes": "Bernoulli's uniform noise is torch's bits",
    "test_multinomial_peaked": "Multinomial's Gumbel noise is torch's bits",
    "test_unnamed_random_nodes_draw_independently": "RandomNormal's values are torch's bits",
}
CASES = [c for c in jax_cases(ext, exclude=RANDOM)
         if not any(k in c.values[0] for k in SPATIAL)]


def _dual_runners(monkeypatch, values=None):
    extra = {} if values is None else {"values": values}
    monkeypatch.setattr(ext, "run_graph", graph_runner(jit=False, opset=17, **extra))
    monkeypatch.setattr(ext, "jit_run", graph_runner(jit=True, opset=21, **extra))


@pytest.mark.parametrize("case,kwargs", CASES)
def test_ops_extended_case_through_the_port(case, kwargs, monkeypatch):
    _dual_runners(monkeypatch)
    run_case(ext, case, kwargs)


@pytest.mark.parametrize("case", sorted(RANDOM))
def test_random_case_on_the_port_alone(case, monkeypatch):
    """The JAX test's checks on the port's values (see ``RANDOM``); the JAX
    package runs the same graph, and the outputs agree in shape and dtype
    class."""
    _dual_runners(monkeypatch, values=port_only)
    run_case(ext, case, {})


def _forward(nodes, inputs=None, opset=21, outputs=("y",)):
    inputs = inputs or {"x": np.zeros(1, np.float32)}
    in_vis = [P.make_value_info(k, P._NUMPY_TO_DTYPE[v.dtype], list(v.shape))
              for k, v in inputs.items()]
    out_vis = [P.make_value_info(n, P.DataType.FLOAT, []) for n in outputs]
    graph = P.GraphProto(name="t", node=nodes, input=in_vis, output=out_vis)
    model = import_onnx(P.encode_model(P.make_model(graph, opset_version=opset)),
                        optimize=False)
    fwd = make_forward(model, "fp32", "cpu")
    args = [torch.from_numpy(v) for v in inputs.values()]
    return lambda: [o.numpy() for o in fwd({}, *args)]


N_DRAWS = 100_000


def _within(value, want, se, what):
    assert abs(value - want) <= 5 * se, f"{what}: {value} against {want} ± 5 × {se}"


@pytest.mark.parametrize("seed", [None, 7.0])
def test_random_normal_distribution_and_seed(seed):
    attrs = {"shape": [N_DRAWS], "mean": 3.0, "scale": 0.5}
    if seed is not None:
        attrs["seed"] = seed
    fwd = _forward([P.make_node("RandomNormal", [], ["y"], name="rn", **attrs)])
    (a,), (b,) = fwd(), fwd()
    np.testing.assert_array_equal(a, b)  # every forward replays its draws
    _within(a.mean(), 3.0, 0.5 / np.sqrt(N_DRAWS), "mean")
    _within(a.std(), 0.5, 0.5 / np.sqrt(2 * N_DRAWS), "std")


def test_random_uniform_distribution_and_seeds_differ():
    def draw(seed):
        fwd = _forward([P.make_node("RandomUniform", [], ["y"], shape=[N_DRAWS],
                                    low=-2.0, high=3.0, seed=seed)])
        return fwd()[0]

    a, b = draw(1.0), draw(2.0)
    np.testing.assert_array_equal(a, draw(1.0))
    assert not np.array_equal(a, b)
    assert (a >= -2.0).all() and (a < 3.0).all()
    _within(a.mean(), 0.5, 5.0 / np.sqrt(12 * N_DRAWS), "mean")
    _within(a.std(), 5.0 / np.sqrt(12), 5.0 / np.sqrt(60 * N_DRAWS), "std")


@pytest.mark.parametrize("p", [0.0, 0.3, 1.0])
def test_bernoulli_distribution(p):
    x = np.full(N_DRAWS, p, np.float32)
    fwd = _forward([P.make_node("Bernoulli", ["x"], ["y"], seed=4.0)], {"x": x})
    (y,) = fwd()
    if p in (0.0, 1.0):
        np.testing.assert_array_equal(y, x)
    else:
        _within(y.mean(), p, np.sqrt(p * (1 - p) / N_DRAWS), "mean")
    np.testing.assert_array_equal(y, fwd()[0])


def test_multinomial_frequencies_follow_the_logits():
    probs = np.array([0.2, 0.3, 0.5])
    x = np.log(probs).astype(np.float32)[None]
    fwd = _forward([P.make_node("Multinomial", ["x"], ["y"], sample_size=N_DRAWS,
                                seed=5.0)], {"x": x})
    (y,) = fwd()
    assert y.shape == (1, N_DRAWS) and y.dtype == np.int32
    freq = np.bincount(y.reshape(-1), minlength=3) / N_DRAWS
    for c, pc in enumerate(probs):
        _within(freq[c], pc, np.sqrt(pc * (1 - pc) / N_DRAWS), f"class {c}")


def test_seedless_nodes_key_on_name_and_draw_order():
    """Seedless draws key on crc32("node:op:n") with the draw counter:
    two nodes differ, and a forward built again replays the same values."""
    nodes = [P.make_node("RandomNormal", [], ["a"], shape=[16], name="n0"),
             P.make_node("RandomNormal", [], ["b"], shape=[16], name="n0")]
    a, b = _forward(nodes, outputs=("a", "b"))()
    assert not np.array_equal(a, b)
    a2, b2 = _forward(nodes, outputs=("a", "b"))()
    np.testing.assert_array_equal(a, a2)
    np.testing.assert_array_equal(b, b2)


def _meta(x):
    return torch.from_numpy(np.asarray(x)).to("meta")


# (op, attrs, args with the card value as _meta, message)
CARD_VALUES = {
    "Compress": ({"axis": 0}, lambda: (torch.zeros(3), _meta(np.array([1, 0, 1], bool))),
                 "Compress condition must be a compile-time constant"),
    "NonZero": ({}, lambda: (_meta(np.ones(3, np.float32)),),
                "NonZero input must be a compile-time constant"),
    "Unique": ({}, lambda: (_meta(np.ones(3, np.float32)),),
               "Unique input must be a compile-time constant"),
    "NonMaxSuppression": ({}, lambda: (_meta(np.zeros((1, 2, 4), np.float32)),
                                       np.zeros((1, 1, 2), np.float32)),
                          "NonMaxSuppression boxes must be a compile-time constant"),
    "SequenceAt": ({}, lambda: ([torch.zeros(2)], _meta(np.int64(0))),
                   "SequenceAt position must be a compile-time constant"),
    "RoiAlign": ({"sampling_ratio": 2},
                 lambda: (torch.zeros(1, 1, 4, 4), torch.zeros(1, 4),
                          _meta(np.zeros(1, np.int64))),
                 "RoiAlign batch_indices must be a compile-time constant"),
    "StringNormalizer": ({}, lambda: (_meta(np.zeros(2, np.int64)),),
                         "StringNormalizer input must be a compile-time constant"),
    "ImageDecoder": ({}, lambda: (_meta(np.zeros(8, np.uint8)),),
                     "ImageDecoder input must be a compile-time constant"),
}
STATIC_VALUES = {
    "CenterCropPad": (lambda: (torch.zeros(4, 4), _meta(np.array([2, 2], np.int64))),
                      "CenterCropPad shape"),
    "AffineGrid": (lambda: (torch.zeros(1, 2, 3), _meta(np.array([1, 1, 4, 4], np.int64))),
                   "AffineGrid size"),
    "SplitToSequence": (lambda: (torch.zeros(4), _meta(np.array([2, 2], np.int64))),
                        "SplitToSequence split"),
    "Col2Im": (lambda: (torch.zeros(1, 4, 9), _meta(np.array([4, 4], np.int64)),
                        np.array([2, 2], np.int64)), "Col2Im image_shape"),
}


@pytest.mark.parametrize("op_type", sorted(CARD_VALUES))
def test_data_dependent_shapes_need_host_values(op_type):
    """Where the JAX lowering raises NotImplementedError on a tracer (a
    data-dependent shape, a string), the port raises it on a tensor on a
    device, which a meta-device tensor stands for here."""
    attrs, args, what = CARD_VALUES[op_type]
    with pytest.raises(NotImplementedError, match=what):
        tops.get_lowering(op_type)(tops.OpContext(op_type, attrs), *args())


@pytest.mark.parametrize("op_type", sorted(STATIC_VALUES))
def test_static_values_on_the_card_must_be_compile_time_constants(op_type):
    """Shapes, splits and sizes follow the core table's rule: a ValueError
    naming the value."""
    args, what = STATIC_VALUES[op_type]
    with pytest.raises(ValueError, match=f"{what} must be a compile-time constant"):
        tops.get_lowering(op_type)(tops.OpContext(op_type, {}), *args())


def test_a_sequence_output_leaves_the_forward_as_a_list():
    x = np.arange(6, dtype=np.float32).reshape(2, 3)
    nodes = [P.make_node("SplitToSequence", ["x"], ["y"], axis=1, keepdims=0)]
    in_vis = [P.make_value_info("x", P.DataType.FLOAT, [2, 3])]
    graph = P.GraphProto(name="t", node=nodes, input=in_vis,
                         output=[P.make_value_info("y", P.DataType.FLOAT, [])])
    model = import_onnx(P.encode_model(P.make_model(graph, opset_version=17)),
                        optimize=False)
    (s,) = make_forward(model, "fp32", "cpu")({}, torch.from_numpy(x))
    assert isinstance(s, list) and len(s) == 3
    for i, part in enumerate(s):
        np.testing.assert_array_equal(part.numpy(), x[:, i])
