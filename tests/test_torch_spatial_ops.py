"""The port's spatial ops (birdnet_tpu_torch/compiler/ops_extended.py:
GridSample, AffineGrid, RoiAlign, Col2Im, NonMaxSuppression, DeformConv,
MaxRoiPool) against the JAX package's, part 2 of tests/test_ops_extended.py.

Every spatial test function of tests/test_ops_extended.py runs with its
runners swapped for ones that run the same graph through both packages
(tests/_torch_dual.py): fp32, the port within 1e-4 of each output's scale,
and the test's own oracle (torch, or the test's numpy reference) on the
port's outputs. No case is taken out.
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import test_ops_extended as ext  # noqa: E402
from _torch_dual import dual, graph_runner, jax_cases, run_case  # noqa: E402

from birdnet_tpu.onnx import proto as P  # noqa: E402
from _torch_threads import torch_threads  # noqa: E402,F401

SPATIAL = ("grid_sample", "affine_grid", "roi_align", "col2im", "nms", "deform_conv",
           "max_roi_pool")
CASES = [c for c in jax_cases(ext) if any(k in c.values[0] for k in SPATIAL)]


@pytest.mark.parametrize("case,kwargs", CASES)
def test_spatial_case_through_the_port(case, kwargs, monkeypatch):
    monkeypatch.setattr(ext, "run_graph", graph_runner(jit=False, opset=17))
    monkeypatch.setattr(ext, "jit_run", graph_runner(jit=True, opset=21))
    run_case(ext, case, kwargs)


def _model(nodes, inputs, inits, opset=20):
    init = [P.TensorProto.from_numpy(v, name=k) for k, v in inits.items()]
    in_vis = [P.make_value_info(k, P._NUMPY_TO_DTYPE[v.dtype], list(v.shape))
              for k, v in inputs.items()]
    graph = P.GraphProto(name="t", node=nodes, initializer=init, input=in_vis,
                         output=[P.make_value_info("y", P.DataType.FLOAT, [])])
    return P.encode_model(P.make_model(graph, opset_version=opset))


@pytest.mark.parametrize("mode", ["avg", "max"])
def test_roi_align_batched_rois_match_jax_per_roi(mode):
    """The port runs every ROI of a lattice at once and groups the
    adaptive ones by lattice; the JAX lowering loops over ROIs. Host ROIs
    of mixed sizes (several lattices), eager (the ROIs are a float param,
    which jax.jit traces), and a fixed ratio under jit."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 3, 12, 20)).astype(np.float32)
    lo = rng.uniform(0, 8, size=(9, 2))
    rois = np.concatenate([lo, lo + rng.uniform(1, 10, size=(9, 2))], 1).astype(np.float32)
    bidx = (np.arange(9) % 2).astype(np.int64)
    for ratio in (0, 2):
        node = P.make_node("RoiAlign", ["x", "r", "b"], ["y"], mode=mode,
                           output_height=3, output_width=4, sampling_ratio=ratio,
                           spatial_scale=0.75)
        data = _model([node], {"x": x}, {"r": rois, "b": bidx}, opset=16)
        (y,) = dual(data, [x], jit=ratio > 0)
        assert y.shape == (9, 3, 3, 4)


def test_col2im_gather_matches_the_scatter_with_padding_and_dilation():
    rng = np.random.default_rng(4)
    blocks, img = [2, 3], [7, 9]
    node = P.make_node("Col2Im", ["x", "i", "b"], ["y"], dilations=[2, 1],
                       pads=[1, 0, 2, 1], strides=[1, 2])
    n_pos = [(7 + 3 - 2 * 1 - 1) // 1 + 1, (9 + 1 - 1 * 2 - 1) // 2 + 1]
    x = rng.normal(size=(2, 3 * 6, n_pos[0] * n_pos[1])).astype(np.float32)
    data = _model([node], {"x": x}, {"i": np.asarray(img, np.int64),
                                     "b": np.asarray(blocks, np.int64)})
    (y,) = dual(data, [x], jit=True)
    assert y.shape == (2, 3, 7, 9)
