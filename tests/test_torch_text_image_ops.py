"""The port's host-only text and image ops (StringNormalizer,
TfIdfVectorizer, StringConcat, StringSplit, RegexFullMatch, ImageDecoder;
birdnet_tpu_torch/compiler/ops_extended.py) against the JAX package's.

Every test function of tests/test_text_ops.py and tests/test_image_decoder.py
runs with its runner swapped for one that runs the same graph through both
packages eagerly (tests/_torch_dual.py): strings and byte streams are host
values, numeric outputs within 1e-4 of their scale, string outputs equal.

Two JAX tests call ``jax.jit`` themselves instead of a runner, so the swap
cannot reach them; each has its counterpart here, through the dual's
jitted runner: ``test_tfidf_traced_under_jit`` (the integer form runs on
the input's device) and ``test_traced_stream_rejected`` (a stream on a
device raises).
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
pytest.importorskip("PIL")

import test_image_decoder as img_cases  # noqa: E402
import test_text_ops as text_cases  # noqa: E402
from _torch_dual import dual, graph_runner, jax_cases, run_case  # noqa: E402

from birdnet_tpu.onnx import proto as P  # noqa: E402

JIT_INSIDE = ("test_tfidf_traced_under_jit", "test_traced_stream_rejected")


def _decoder_model(stream, pixel_format=None) -> bytes:
    """tests/test_image_decoder.py's ``_run_decoder`` model."""
    attrs = {} if pixel_format is None else {"pixel_format": pixel_format}
    graph = P.GraphProto(
        name="g", node=[P.make_node("ImageDecoder", ["x"], ["y"], **attrs)],
        input=[P.make_value_info("x", P.DataType.UINT8, [len(stream)])],
        output=[P.make_value_info("y", P.DataType.UINT8, [])],
    )
    return P.encode_model(P.ModelProto(
        ir_version=9, producer_name="t", producer_version="0", graph=graph,
        opset_import=[P.OperatorSetId(domain="", version=20)]))


def _dual_decoder(stream, pixel_format=None):
    (out,) = dual(_decoder_model(stream, pixel_format), [stream], jit=False)
    return np.asarray(out)


@pytest.mark.parametrize("case,kwargs", jax_cases(text_cases, exclude=JIT_INSIDE))
def test_text_case_through_the_port(case, kwargs, monkeypatch):
    monkeypatch.setattr(text_cases, "_run", graph_runner(jit=False, opset=17))
    run_case(text_cases, case, kwargs)


@pytest.mark.parametrize("case,kwargs", jax_cases(img_cases, exclude=JIT_INSIDE))
def test_image_decoder_case_through_the_port(case, kwargs, monkeypatch):
    monkeypatch.setattr(img_cases, "_run_decoder", _dual_decoder)
    run_case(img_cases, case, kwargs)


def test_tfidf_traced_under_jit():
    graph = P.GraphProto(
        name="t", node=[text_cases._tfidf_node(1, 2, 5)],
        input=[P.make_value_info("x", P.DataType.INT32, [12])],
        output=[P.make_value_info("y", P.DataType.FLOAT, [7])],
    )
    data = P.encode_model(P.make_model(graph, opset_version=17))
    (y,) = dual(data, [text_cases._X1], jit=True)
    np.testing.assert_array_equal(y, [0, 3, 1, 0, 1, 3, 1])


def test_traced_stream_rejected():
    stream = img_cases._encode(img_cases._test_image(8, 8), "PNG")
    with pytest.raises(NotImplementedError, match="must be a compile-time constant"):
        dual(_decoder_model(stream), [stream], jit=True)


def test_image_decoder_names_pillow_when_it_is_missing(monkeypatch):
    """Without Pillow (the card's machine has none) the lowering raises
    NotImplementedError naming it, as the JAX lowering does."""
    import builtins

    from birdnet_tpu_torch.compiler import ops as tops

    real_import = builtins.__import__

    def no_pil(name, *args, **kwargs):
        if name == "PIL" or name.startswith("PIL."):
            raise ImportError("No module named 'PIL'")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_pil)
    stream = np.frombuffer(b"\x89PNG....", np.uint8)
    with pytest.raises(NotImplementedError, match="Pillow"):
        tops.get_lowering("ImageDecoder")(tops.OpContext("ImageDecoder", {}), stream)
