"""The port's recurrences (LSTM, GRU, RNN; birdnet_tpu_torch/compiler/ops.py)
against the JAX package's and torch's.

The cases of tests/test_rnn_ops.py run through both packages
(tests/_torch_dual.py): the JAX package's jitted forward and the port on
the CPU at fp32, the port within 1e-4 of each output's largest magnitude,
and each case's torch or numpy oracle on the port's outputs. Then clip,
input_forget, peepholes in both directions, sequence_lens, layout 1 with
initial states, a different activation per direction, the ``mixed``
policy (within 2^-7 of the scale) and ``fast`` after a bf16 activation.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import test_rnn_ops as rnn_cases  # noqa: E402
from _torch_core_common import POLICY, assert_close  # noqa: E402
from _torch_dual import PARITY, dual_run_graph, graph_model, run_jax, run_port, \
    through_the_port  # noqa: E402

from birdnet_tpu.onnx import proto as P  # noqa: E402

CASES = [
    ("test_lstm_vs_torch", {"bidirectional": False}),
    ("test_lstm_vs_torch", {"bidirectional": True}),
    ("test_lstm_reverse_direction", {}),
    ("test_lstm_initial_state_and_layout", {}),
    ("test_lstm_sequence_lens_masking", {}),
    ("test_gru_vs_torch", {"bidirectional": False}),
    ("test_gru_vs_torch", {"bidirectional": True}),
    ("test_gru_linear_before_reset_zero_differs", {}),
    ("test_rnn_vs_torch", {}),
    ("test_rnn_relu_activation", {}),
    ("test_lstm_peepholes_vs_numpy_oracle", {}),
    ("test_rnn_spec_activations_vs_numpy", {"act": "Affine", "alpha": 0.5, "beta": 0.25}),
    ("test_rnn_spec_activations_vs_numpy", {"act": "ScaledTanh", "alpha": 1.5, "beta": 0.8}),
    ("test_rnn_spec_activations_vs_numpy", {"act": "ThresholdedRelu", "alpha": 0.3,
                                            "beta": None}),
]


@pytest.mark.parametrize("case,kwargs", CASES,
                         ids=[f"{c}-{'-'.join(map(str, k.values()))}" for c, k in CASES])
def test_rnn_ops_case_through_the_port(case, kwargs, monkeypatch):
    through_the_port(monkeypatch, rnn_cases, "run_graph", dual_run_graph, case, **kwargs)


T, B, I, H = 6, 3, 5, 4
N_GATES = {"LSTM": 4, "GRU": 3, "RNN": 1}


def _weights(kind, dirs, seed):
    rng = np.random.default_rng(seed)
    g = N_GATES[kind]
    return {
        "w": (rng.normal(size=(dirs, g * H, I)) * 0.5).astype(np.float32),
        "r": (rng.normal(size=(dirs, g * H, H)) * 0.5).astype(np.float32),
        "b": (rng.normal(size=(dirs, 2 * g * H)) * 0.2).astype(np.float32),
    }


def _data(kind, dirs, seed, ins=("x", "w", "r", "b"), extra=None, n_out=2, x_shape=(T, B, I),
          **attrs):
    rng = np.random.default_rng(seed + 100)
    x = rng.normal(size=x_shape).astype(np.float32)
    inits = {**_weights(kind, dirs, seed), **(extra or {})}
    outs = ["y", "y_h", "y_c"][:n_out]
    node = P.make_node(kind, list(ins), outs, hidden_size=H, **attrs)
    return P.encode_model(graph_model([node], {"x": x}, inits, outs)), [x], inits


def _parity(data, inputs, tol=PARITY, precision="fp32"):
    got = run_port(data, inputs, precision)
    want = run_jax(data, inputs, precision)
    for i, (g, w) in enumerate(zip(got, want)):
        assert_close(g, w, tol, f"output {i}")
    return got


@pytest.mark.parametrize("kind", ["LSTM", "GRU", "RNN"])
def test_clip_matches_jax(kind):
    data, inputs, _ = _data(kind, 2, 1, clip=0.3, direction="bidirectional")
    _parity(data, inputs)


def test_lstm_peepholes_both_directions_match_jax():
    p = (np.random.default_rng(3).normal(size=(2, 3 * H)) * 0.5).astype(np.float32)
    data, inputs, _ = _data("LSTM", 2, 2, ins=("x", "w", "r", "b", "", "", "", "p"),
                            extra={"p": p}, n_out=3, direction="bidirectional")
    _parity(data, inputs)


def test_lstm_input_forget_couples_the_forget_gate():
    """input_forget=1: f = 1 - i (onnxruntime's coupling). The port
    computes it, against a numpy recurrence; the JAX package ignores the
    attribute (its answer equals its input_forget=0 answer; ROADMAP C)."""
    data, inputs, inits = _data("LSTM", 1, 4, n_out=3, input_forget=1)
    y, y_h, y_c = run_port(data, inputs)
    x = inputs[0].astype(np.float64)
    w, r, b = inits["w"][0], inits["r"][0], inits["b"][0]
    sig = lambda v: 1.0 / (1.0 + np.exp(-v))  # noqa: E731
    h, c = np.zeros((B, H)), np.zeros((B, H))
    for t in range(T):
        g = x[t] @ w.T + h @ r.T + b[:4 * H] + b[4 * H:]
        i_g = sig(g[:, :H])
        o_g = sig(g[:, H:2 * H])
        c = (1.0 - i_g) * c + i_g * np.tanh(g[:, 3 * H:])
        h = o_g * np.tanh(c)
        np.testing.assert_allclose(y[t, 0], h, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(y_c[0], c, rtol=1e-4, atol=1e-5)
    uncoupled, _, _ = _data("LSTM", 1, 4, n_out=3)
    np.testing.assert_array_equal(run_jax(data, inputs)[0],
                                  run_jax(uncoupled, inputs)[0])


@pytest.mark.parametrize("kind", ["GRU", "RNN"])
def test_sequence_lens_match_jax(kind):
    lens = np.array([6, 2, 4], np.int32)
    data, inputs, _ = _data(kind, 1, 5, ins=("x", "w", "r", "b", "lens"), extra={"lens": lens})
    y, _ = _parity(data, inputs)
    assert np.all(np.asarray(y)[2:, 0, 1] == 0)


@pytest.mark.parametrize("lbr", [0, 1])
def test_gru_layout_1_with_initial_state_matches_jax(lbr):
    h0 = np.random.default_rng(6).normal(size=(B, 2, H)).astype(np.float32)
    data, inputs, _ = _data("GRU", 2, 6, ins=("x", "w", "r", "b", "", "h0"), extra={"h0": h0},
                            x_shape=(B, T, I), layout=1, direction="bidirectional",
                            linear_before_reset=lbr)
    y, y_h = _parity(data, inputs)
    assert np.asarray(y).shape == (B, T, 2, H) and np.asarray(y_h).shape == (B, 2, H)


def test_a_different_activation_per_direction_matches_jax():
    data, inputs, _ = _data("RNN", 2, 7, direction="bidirectional",
                            activations=["Tanh", "LeakyRelu"], activation_alpha=[1.0, 0.2])
    _parity(data, inputs)


@pytest.mark.parametrize("kind", ["LSTM", "GRU"])
def test_mixed_policy_within_the_policy_bound(kind):
    """``mixed``: bf16 operands of the input projection, float32 sums and
    carry; within 2^-7 of the scale of the JAX package's ``mixed``."""
    data, inputs, _ = _data(kind, 2, 8, n_out=2, direction="bidirectional")
    _parity(data, inputs, POLICY, "mixed")


def test_fast_recurrence_after_a_bf16_activation():
    """Under ``fast`` the GRU's input is the bf16 output of a MatMul. The
    JAX lowering's scan then gets a bf16 initial carry and a float32 step
    output (its bias is float32) and raises TypeError; the port carries the
    promoted dtype (ROADMAP C, fixed in the port) and stays within 2^-6 of
    the scale of its own fp32 answer (bf16 input and projection
    operands)."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(T, B, I)).astype(np.float32)
    inits = {**_weights("GRU", 2, 9), "m": (rng.normal(size=(I, I)) * I ** -0.5).astype(np.float32)}
    nodes = [P.make_node("MatMul", ["x", "m"], ["h"]),
             P.make_node("GRU", ["h", "w", "r", "b"], ["y", "y_h"], hidden_size=H,
                         direction="bidirectional")]
    data = P.encode_model(graph_model(nodes, {"x": x}, inits, ["y", "y_h"]))
    with pytest.raises(TypeError, match="carry"):
        run_jax(data, [x], "fast")
    fast, ref = run_port(data, [x], "fast"), run_port(data, [x], "fp32")
    for f, r in zip(fast, ref):
        assert f.dtype_name == "float32"
        assert_close(f, r, 2 ** -6, "fast vs fp32")
