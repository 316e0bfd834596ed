"""The port's com.microsoft contrib domain (birdnet_tpu_torch/compiler/
ops_contrib.py) against the JAX package's, part 1: every name, and the
fused epilogues, quantized set and attention of tests/test_contrib_ops.py.

``test_each_contrib_name_matches_jax`` runs one seeded graph per name
(tests/_torch_contrib_cases.py) through both packages on the same numpy
inputs: fp32 within 1e-4 of each output's scale, integer codes, token
sequences, hashes and paths exact. Quantized codes requantized from a
float sum (``cc.ROUNDED``: pools, means, softmax, QGemm's product) are held
within one code, the bound of the JAX package's own tests of these ops:
the two packages add the float terms in different orders, so a value at a
rounding tie may land on either side. The generation cases run where the
two packages agree (``length_penalty = 0``, Sampling at ``top_p -> 0``).

Every test function of tests/test_contrib_ops.py then runs with its runner
``_run`` swapped for one that runs the same graph through both packages
(tests/_torch_dual.py), less the two that check the JAX package's own
error class (``JAX_ERRORS``), whose port counterparts are below.
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import _torch_contrib_cases as cc  # noqa: E402
import test_contrib_ops as jco  # noqa: E402
from _torch_dual import dual, jax_cases, run_case, run_jax, run_port  # noqa: E402

from birdnet_tpu.onnx import proto as P  # noqa: E402
from birdnet_tpu_torch.errors import ModelLoadError  # noqa: E402
from _torch_threads import torch_threads  # noqa: E402,F401

MS = "com.microsoft"
JAX_ERRORS = {
    "test_name_colliding_contrib_op_is_not_misdispatched":
        "raises the JAX package's ModelLoadError (the port's: below)",
    "test_unknown_contrib_op_names_the_domain":
        "raises the JAX package's ModelLoadError (the port's: below)",
}


@pytest.mark.parametrize("name", sorted(cc.CASES))
def test_each_contrib_name_matches_jax(name):
    data, ins = cc.CASES[name]()
    if name not in cc.ROUNDED:
        dual(data, list(ins.values()), jit=name not in cc.EAGER)
        return
    (got,) = run_port(data, list(ins.values()))
    (want,) = run_jax(data, list(ins.values()), jit=False)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.abs(got.astype(np.int64) - want.astype(np.int64)).max() <= 1


def _dual_run(model_proto, *inputs, n_out=None):
    return dual(P.encode_model(model_proto), list(inputs), jit=True, n_outputs=n_out)


@pytest.mark.parametrize("case,kwargs", jax_cases(jco, exclude=JAX_ERRORS))
def test_contrib_ops_case_through_the_port(case, kwargs, monkeypatch):
    monkeypatch.setattr(jco, "_run", _dual_run)
    run_case(jco, case, kwargs)


def _port_forward(nodes, inputs, outputs=("y",)):
    from birdnet_tpu_torch.compiler.importer import import_onnx, make_forward

    data = cc.model(nodes, inputs, outputs=outputs)
    return make_forward(import_onnx(data), "fp32", "cpu")


@pytest.mark.parametrize("op_type", ["Unique", "SomeProprietaryOp"])
def test_other_contrib_names_fail_at_import_naming_the_domain(op_type):
    """com.microsoft.Unique's contract differs from the core Unique's, and
    an unknown name has no lowering: both fail at import, named with their
    domain, in both packages."""
    from birdnet_tpu.errors import ModelLoadError as JModelLoadError

    nodes = [P.make_node(op_type, ["x"], ["y"], domain=MS)]
    data = cc.model(nodes, {"x": np.zeros(4, np.float32)})
    with pytest.raises(ModelLoadError, match=f"com.microsoft.{op_type}"):
        run_port(data, [np.zeros(4, np.float32)])
    with pytest.raises(JModelLoadError, match=f"com.microsoft.{op_type}"):
        run_jax(data, [np.zeros(4, np.float32)])


# ---------------------------------------------------------------------------
# MurmurHash3: the device path (int64 masked to 32 bits) and the host path,
# bit for bit against the JAX package and sklearn
# ---------------------------------------------------------------------------


def _murmur_model(x, seed, positive):
    return cc.model([cc._ms("MurmurHash3", ["x"], seed=seed, positive=positive)],
                    {"x": x})


@pytest.mark.parametrize("dtype", [np.int32, np.float32, np.int64])
@pytest.mark.parametrize("positive", [1, 0])
def test_murmurhash3_bits_match_jax_and_sklearn(dtype, positive):
    sklearn_hash = pytest.importorskip("sklearn.utils").murmurhash3_32
    r = np.random.default_rng(3)
    x = (r.integers(-2**31, 2**31, 257) if dtype != np.float32
         else r.standard_normal(257) * 1e3).astype(dtype)
    seed = 0x9747B28C
    data = _murmur_model(x, seed, positive)
    (host,) = dual(data, [x], jit=False)  # CPU tensor in the port, numpy in JAX
    want = np.asarray([sklearn_hash(v.tobytes(), seed=seed, positive=bool(positive))
                       for v in x]).astype(np.uint32 if positive else np.int32)
    assert host.dtype == want.dtype
    np.testing.assert_array_equal(host, want)
    from birdnet_tpu_torch.compiler.ops import OpContext, get_lowering

    fn = get_lowering("MurmurHash3", MS)
    ctx = OpContext("MurmurHash3", {"seed": seed, "positive": positive})
    (on_host,) = fn(ctx, x)  # a host value: the numpy path
    np.testing.assert_array_equal(np.asarray(on_host), want)


def test_murmurhash3_strings_match_sklearn():
    sklearn_hash = pytest.importorskip("sklearn.utils").murmurhash3_32
    from birdnet_tpu.compiler.ops import OpContext as JContext
    from birdnet_tpu.compiler.ops import get_lowering as j_lowering
    from birdnet_tpu_torch.compiler.ops import OpContext, get_lowering

    words = np.array(["", "a", "ab", "abc", "abcd", "robin", "Turdus migratorius"])
    attrs = {"seed": 7, "positive": 1}
    (got,) = get_lowering("MurmurHash3", MS)(OpContext("MurmurHash3", attrs), words)
    (want,) = j_lowering("MurmurHash3", MS)(JContext("MurmurHash3", attrs), words)
    np.testing.assert_array_equal(got, np.asarray(want))
    np.testing.assert_array_equal(
        got, [sklearn_hash(w, seed=7, positive=True) for w in words])


def test_eight_byte_hash_and_dtw_on_a_device_need_host_values():
    """8-byte hashes and DynamicTimeWarping's path run on the host: a
    tensor on a device raises, as the JAX lowering raises on a tracer
    (the JAX package's jitted int64 input is int32 already, so only the
    port's side is held for the hash)."""
    from birdnet_tpu_torch.compiler.ops import OpContext, get_lowering

    on_device = torch.arange(6, dtype=torch.int64, device="meta")
    with pytest.raises(NotImplementedError, match="compile-time constant"):
        get_lowering("MurmurHash3", MS)(OpContext("MurmurHash3", {}), on_device)
    x = np.ones((3, 4), np.float32)
    data = cc.model([cc._ms("DynamicTimeWarping", ["x"])], {"x": x})
    with pytest.raises(NotImplementedError, match="compile-time constant"):
        dual(data, [x], jit=True)
