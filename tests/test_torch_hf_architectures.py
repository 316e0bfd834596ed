"""The port held to tests/test_hf_architectures.py: genuine Hugging Face
``transformers`` architectures at tiny widths with random weights,
exported by libtorch's ONNX serializer, imported by the port and run on
the CPU at fp32.

One case for each of that file's 29 tests:

- the 26 that go through its runner ``_assert_engine_matches_torch`` run
  with that runner swapped for one that exports once
  (``tests/_torch_export.py::export_onnx_bytes``), imports the same bytes
  with the port and holds the port's outputs to torch's at the JAX file's
  bounds (atol 1e-4, rtol 1e-3), then imports them with the JAX package
  and holds the port within 1e-4 of the scale of the JAX package's jitted
  forward;
- the one file at many shapes and the two real-width cases (gated behind
  ``BIRDNET_TEST_SLOW`` as theirs are) run with their importer and forward
  swapped for both packages': the port's outputs, held within 1e-4 of the
  scale of the JAX package's, go to the case's own torch comparison.

Token ids stay int64 in the port (the JAX package runs with x64 off).
Needs ``transformers`` and skips without it (the card's machine has none).
"""

from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
transformers = pytest.importorskip("transformers")
jax = pytest.importorskip("jax")

import test_hf_architectures as hf  # noqa: E402
from _torch_dual import jax_cases, run_case  # noqa: E402
from _torch_export import export_onnx_bytes, torch_outputs  # noqa: E402

from birdnet_tpu.compiler import importer as j_importer  # noqa: E402
from birdnet_tpu_torch.compiler import importer as t_importer  # noqa: E402
from _torch_threads import torch_threads  # noqa: E402,F401

PARITY = 1e-4
# The cases that import and run the file themselves.
DIRECT = ("test_dynamic_axes_one_file_many_shapes", "test_gpt2_124m_real_width_parity",
          "test_wav2vec2_base_real_width_parity")


def _port_forward(model):
    fwd = t_importer.make_forward(model, "fp32", "cpu")
    params = t_importer.params_to_torch(model.params, "cpu")
    return lambda *xs: [o.numpy() for o in fwd(params, *[torch.as_tensor(np.asarray(x))
                                                          for x in xs])]


def _held_to_jax(got, data, xs):
    """The JAX package's jitted forward of ``data`` on ``xs``; each port
    output within PARITY of its scale."""
    model = j_importer.import_onnx(data)
    want = jax.jit(j_importer.make_forward(model, precision="fp32"))(
        model.params, *[np.asarray(x) for x in xs])
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w)
        assert g.shape == w.shape, f"output {i}"
        if w.dtype.kind == "f":
            assert np.abs(g - w).max() <= PARITY * np.abs(w).max(), f"output {i}"
        else:
            np.testing.assert_array_equal(g, w, err_msg=f"output {i}")


def _port_matches_torch(module, args, opset=17, atol=hf.ATOL):
    """``_assert_engine_matches_torch`` for the port, held to the JAX
    package too; returns the port's imported model."""
    module.eval()
    data = export_onnx_bytes(module, args, opset_version=opset)
    model = t_importer.import_onnx(data)
    outs = _port_forward(model)(*args)
    refs = torch_outputs(module, args)
    assert len(outs) == len(refs)
    for got, ref in zip(outs, refs):
        np.testing.assert_allclose(got, ref, atol=atol, rtol=1e-3)
    _held_to_jax(outs, data, args)
    return model


def _import_both(data):
    """The port's import of the file, and its bytes for the JAX package's
    (made when the forward runs)."""
    return SimpleNamespace(data=data, params=None, port=t_importer.import_onnx(data))


def _forward_both(model, precision="fp32"):
    """``make_forward`` for a case that runs the file itself: the port's
    outputs, held to the JAX package's."""
    assert precision == "fp32"
    port = _port_forward(model.port)

    def run(_params, *xs):
        got = port(*xs)
        _held_to_jax(got, model.data, xs)
        return got

    return run


@pytest.mark.parametrize("case,kwargs", jax_cases(hf, exclude=DIRECT))
def test_architecture_through_the_port(case, kwargs, monkeypatch):
    monkeypatch.setattr(hf, "_assert_engine_matches_torch", _port_matches_torch)
    run_case(hf, case, kwargs)


@pytest.mark.parametrize("case", DIRECT)
def test_file_through_both_importers(case, monkeypatch):
    monkeypatch.setattr(hf, "import_onnx", _import_both)
    monkeypatch.setattr(hf, "make_forward", _forward_both)
    monkeypatch.setattr(hf, "jax", SimpleNamespace(jit=lambda f: f))
    run_case(hf, case, {})
