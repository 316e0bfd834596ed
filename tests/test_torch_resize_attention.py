"""The port's Resize, Upsample, Attention and RotaryEmbedding
(birdnet_tpu_torch/compiler/ops.py) and its opset 1-6 dialect against the
JAX package's.

Every Resize and Upsample case of tests/test_compiler_ops.py and
tests/test_compiler_ops_extra.py, the Attention and RotaryEmbedding cases of
tests/test_ops_wave3.py and every case of tests/test_legacy_opset.py run
through both packages (tests/_torch_dual.py): the JAX package's jitted
forward and the port on the CPU at fp32, the port within 1e-4 of each
output's largest magnitude, and each case's torch or numpy oracle on the
port's outputs. Then the ``mixed`` policy of Attention (within 2^-7 of the
scale) and Resize's host-side scales reaching the forward as host values.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import test_compiler_ops as compiler_cases  # noqa: E402
import test_compiler_ops_extra as extra_cases  # noqa: E402
import test_legacy_opset as legacy_cases  # noqa: E402
import test_ops_wave3 as wave3_cases  # noqa: E402
from _torch_core_common import POLICY, assert_close  # noqa: E402
from _torch_dual import dual_run_graph, dual_run_model, graph_model, run_jax, \
    run_port, through_the_port  # noqa: E402

from birdnet_tpu.onnx import proto as P  # noqa: E402

RESIZE = [
    (compiler_cases, "test_resize_linear_antialias_downscale_vs_torch"),
    (compiler_cases, "test_resize_cubic_vs_torch_bicubic"),
    (compiler_cases, "test_resize_cubic_antialias_downscale_vs_torch"),
    (compiler_cases, "test_resize_cubic_exclude_outside_vs_spec_oracle"),
    (compiler_cases, "test_resize_tf_crop_and_resize"),
    (compiler_cases, "test_resize_keep_aspect_ratio_policies"),
    (extra_cases, "test_resize_nearest_scales"),
    (extra_cases, "test_resize_linear_sizes"),
    (extra_cases, "test_upsample_legacy_input_scales"),
    (extra_cases, "test_upsample_legacy_attr_scales_bilinear"),
    (extra_cases, "test_upsample_fractional_scale_uses_original_scale"),
    (extra_cases, "test_upsample_nearest_noninteger_scale_vs_torch"),
]
ATTENTION = [
    "test_attention_basic_4d", "test_attention_causal", "test_attention_bool_and_float_masks",
    "test_attention_gqa", "test_attention_3d_form", "test_attention_kv_cache_and_present",
    "test_attention_scale_and_softcap", "test_attention_qk_output_modes",
    "test_rotary_embedding_with_position_ids", "test_rotary_embedding_interleaved_partial",
    "test_rotary_embedding_3d",
]
LEGACY = [
    *[("test_legacy_broadcast_at_axis", {"op_type": o, "npfn": f}) for o, f in
      [("Add", np.add), ("Sub", np.subtract), ("Mul", np.multiply), ("Div", np.divide)]],
    ("test_legacy_broadcast_trailing_default", {}),
    ("test_legacy_broadcast_scalar_and_exact", {}),
    ("test_legacy_broadcast_comparison_and_logical", {}),
    ("test_legacy_reshape_shape_attribute", {}),
    ("test_legacy_cast_string_to", {}),
    ("test_legacy_concat_default_axis_1", {}),
    ("test_legacy_tile_tiles_axis_inputs", {}),
    ("test_legacy_upsample_scale_attributes", {}),
    ("test_legacy_prelu_channel_slope", {}),
    ("test_legacy_batchnorm_inference_form_with_junk_attrs", {}),
    ("test_legacy_batchnorm_training_form_rejected", {}),
    ("test_legacy_zoo_style_cnn_end_to_end", {}),
    *[("test_legacy_broadcast_fuzz", {"seed": s}) for s in range(40)],
    ("test_legacy_prelu_channel_slope_when_c_equals_trailing_dim", {}),
    ("test_legacy_pad_opset1_paddings_attribute", {}),
]


@pytest.mark.parametrize("module,case", RESIZE, ids=[c for _, c in RESIZE])
def test_resize_case_through_the_port(module, case, monkeypatch):
    through_the_port(monkeypatch, module, "run_graph", dual_run_graph, case,
                     rng=np.random.default_rng(42))


@pytest.mark.parametrize("case", ATTENTION)
def test_attention_case_through_the_port(case, monkeypatch):
    through_the_port(monkeypatch, wave3_cases, "run_graph", dual_run_graph, case,
                     rng=np.random.default_rng(42))


@pytest.mark.parametrize("case,kwargs", LEGACY,
                         ids=[f"{c}-{list(k.values())[0] if k else ''}" for c, k in LEGACY])
def test_legacy_case_through_the_port(case, kwargs, monkeypatch):
    through_the_port(monkeypatch, legacy_cases, "_run", dual_run_model, case, **kwargs)


@pytest.mark.parametrize("causal", [0, 1])
def test_attention_mixed_policy_within_the_policy_bound(causal):
    """``mixed``: bf16 operands and float32 sums of both products, float32
    softmax; the port within 2^-7 of the scale of the JAX package's."""
    rng = np.random.default_rng(3)
    q = rng.normal(size=(2, 8, 6, 16)).astype(np.float32)
    k = rng.normal(size=(2, 2, 10, 16)).astype(np.float32)
    v = rng.normal(size=(2, 2, 10, 16)).astype(np.float32)
    past = rng.normal(size=(2, 2, 4, 16)).astype(np.float32)
    node = P.make_node("Attention", ["q", "k", "v", "", "pk", "pv"], ["y", "pres_k", "pres_v"],
                       is_causal=causal, softcap=5.0)
    inputs = {"q": q, "k": k, "v": v, "pk": past, "pv": past}
    data = P.encode_model(graph_model([node], inputs, None, ["y", "pres_k", "pres_v"],
                                      opset=23))
    got = run_port(data, list(inputs.values()), "mixed")
    want = run_jax(data, list(inputs.values()), "mixed")
    for i, (g, w) in enumerate(zip(got, want)):
        assert_close(g, w, POLICY, f"output {i}")


def test_resize_scales_from_an_initializer_stay_host_values():
    """A Resize whose scales are a float initializer (a device operand for
    any other op): the forward keeps it on the host, where the output shape
    is computed, and the result matches the JAX package's."""
    from birdnet_tpu_torch.compiler.importer import consts_to_device, import_onnx

    x = np.random.default_rng(4).normal(size=(2, 3, 5)).astype(np.float32)
    scales = np.array([1.0, 1.0, 4.0], np.float32)
    node = P.make_node("Resize", ["x", "", "scales"], ["y"], mode="linear",
                       coordinate_transformation_mode="half_pixel")
    data = P.encode_model(graph_model([node], {"x": x}, {"scales": scales}))
    model = import_onnx(data, optimize=False)
    env = consts_to_device(model.consts, "cpu", model.graph)
    assert isinstance(env["scales"], np.ndarray)
    assert isinstance(consts_to_device(model.consts, "cpu")["scales"], torch.Tensor)
    (got,) = run_port(data, [x])
    (want,) = run_jax(data, [x])
    assert got.shape == (2, 3, 20)
    assert_close(got, want, 1e-6, "resize")
