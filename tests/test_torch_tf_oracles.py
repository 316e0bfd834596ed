"""The port held to tests/test_tf_signal_oracle.py and
tests/test_tf_keras_oracle.py: real TensorFlow adjudicates its STFT / mel
frontend and its forward of whole TF-dialect files.

- The 12 signal cases (MelWeightMatrix against
  ``tf.signal.linear_to_mel_weight_matrix``, HannWindow against
  ``tf.signal.hann_window``, STFT against ``tf.signal.stft``, and the
  STFT → power → mel → log frontend against TF's pipeline) run with their
  ``run_graph`` swapped for ``tests/_torch_dual.py``'s eager runner (their
  sizes and steps are graph inputs, which ``run_graph`` hands the JAX
  forward as concrete values): the port on the CPU at fp32 within 1e-4 of
  each output's scale of the JAX package's forward, then the case's
  TensorFlow oracle at its own bound on the port's outputs.
- The 3 whole-model cases: the TF-dialect v2.4, v3.0 and Perch files of
  tests/_tf_dialect_models.py through the port at fp32 on the CPU against
  genuine TensorFlow kernels (the JAX case's ``_tf_forward``, at its
  bounds) and within 1e-4 of the scale of the JAX package's forward.

Both need TensorFlow and skip without it (the card's machine has none).
"""

import numpy as np
import pytest

tf = pytest.importorskip("tensorflow")
torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import test_tf_keras_oracle as keras_cases  # noqa: E402
import test_tf_signal_oracle as signal_cases  # noqa: E402
from _tf_dialect_models import build_tf_dialect_model  # noqa: E402
from _torch_dual import graph_runner, jax_cases, run_case  # noqa: E402

from birdnet_tpu.compiler import importer as j_importer  # noqa: E402
from birdnet_tpu_torch.compiler import importer as t_importer  # noqa: E402
from _torch_threads import torch_threads  # noqa: E402,F401

PARITY = 1e-4


@pytest.mark.parametrize("case,kwargs", jax_cases(signal_cases))
def test_signal_case_through_the_port(case, kwargs, monkeypatch):
    monkeypatch.setattr(signal_cases, "run_graph", graph_runner(jit=False, opset=17))
    run_case(signal_cases, case, kwargs)


@pytest.mark.parametrize("family,n_out", [("v24", 1), ("v30", 2), ("perch", 4)])
def test_engine_matches_real_tf(family, n_out):
    model_bytes, oracle = build_tf_dialect_model(family, num_species=12, seed=11)
    rng = np.random.default_rng(42)
    x = (rng.standard_normal((2, oracle.meta["sample_count"])) * 0.25).astype(np.float32)

    model = t_importer.import_onnx(model_bytes)
    got = [o.numpy() for o in t_importer.make_forward(model, "fp32", "cpu")(
        t_importer.params_to_torch(model.params, "cpu"), torch.from_numpy(x))]
    ref = keras_cases._tf_forward(oracle.w, oracle.meta, x)
    j_model = j_importer.import_onnx(model_bytes)
    want = jax.jit(j_importer.make_forward(j_model, precision="fp32"))(j_model.params, x)

    assert len(got) == len(ref) == len(want) == n_out
    for g, r, w in zip(got, ref, want):
        w = np.asarray(w)
        assert g.shape == r.shape == w.shape
        np.testing.assert_allclose(g, r, atol=2e-3, rtol=1e-3)
        assert np.abs(g - w).max() <= PARITY * np.abs(w).max()
