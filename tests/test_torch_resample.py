"""The port's resampler (birdnet_tpu_torch/ops/resample.py) against the JAX
package's and against scipy.signal.resample_poly, within the tolerances of
tests/test_resample.py."""

from fractions import Fraction

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")
scipy_signal = pytest.importorskip("scipy.signal")

from birdnet_tpu.ops import resample as jrs  # noqa: E402
from birdnet_tpu_torch.ops import resample as trs  # noqa: E402

RATES = [
    pytest.param(44_100, 48_000, 44_100, id="44.1k-48k"),
    pytest.param(48_000, 32_000, 48_000, id="48k-32k"),
    pytest.param(22_050, 48_000, 10_000, id="22.05k-48k"),
    pytest.param(48_000, 16_000, 48_017, id="48k-16k-ragged"),
]


def _scipy(x, orig, tgt):
    f = Fraction(tgt, orig)
    return scipy_signal.resample_poly(
        np.asarray(x, np.float64), f.numerator, f.denominator
    ).astype(np.float32)


@pytest.mark.parametrize("orig,tgt,n", RATES)
def test_resample_poly_matches_jax_and_scipy(orig, tgt, n):
    x = np.random.default_rng(n).normal(size=n).astype(np.float32)
    got = trs.resample_poly(x, orig, tgt, device="cpu")
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    got = got.numpy()
    ref = _scipy(x, orig, tgt)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=2e-5)
    np.testing.assert_allclose(got, np.asarray(jrs.resample_poly(x, orig, tgt)),
                               atol=2e-5)


@pytest.mark.parametrize("orig,tgt,n", RATES[:3])
def test_resample_audio_int16_matches_jax(orig, tgt, n):
    """int16 in and out: the same codes as the JAX package's, but for a
    float32 rounding at a code boundary (at most one code)."""
    rng = np.random.default_rng(1)
    pcm = (rng.normal(size=n) * 6000).clip(-32768, 32767).astype(np.int16)
    got = trs.resample_audio(pcm, orig, tgt, out_dtype=np.int16, device="cpu")
    want = jrs.resample_audio(pcm, orig, tgt, out_dtype=np.int16)
    assert got.dtype == want.dtype == np.int16 and got.shape == want.shape
    assert np.abs(got.astype(np.int32) - want.astype(np.int32)).max() <= 1
    ref = np.clip(_scipy(pcm / 32768.0, orig, tgt) * 32768.0, -32768, 32767)
    assert np.abs(got.astype(np.int32) - ref.astype(np.int16)).max() <= 1


def test_identity_rate_and_host_path():
    x = np.random.default_rng(2).normal(size=1000).astype(np.float32)
    np.testing.assert_array_equal(trs.resample_poly(x, 48_000, 48_000, device="cpu").numpy(), x)
    np.testing.assert_array_equal(trs.resample_host(x, 32_000, 48_000),
                                  jrs.resample_host(x, 32_000, 48_000))
    np.testing.assert_array_equal(trs.design_kaiser_sinc(3, 2),
                                  jrs.design_kaiser_sinc(3, 2))
