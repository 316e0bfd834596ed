"""The port's CUDA kernels on the card: each kernel against its plain
PyTorch version at the main path's geometry, and the classifier's ``fast``
and int8 paths through them. Marked ``cuda``; every test skips where
``torch.cuda.is_available()`` is false. On a machine with a card:

    python -m pytest tests/test_torch_cuda.py -q --noconftest

(``--noconftest``: tests/conftest.py imports jax, which the port's
machine need not have.)
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from birdnet_tpu_torch.compiler._melbank import mel_weight_matrix  # noqa: E402
from birdnet_tpu_torch.ops.cuda import frontend as fe  # noqa: E402
from birdnet_tpu_torch.ops.cuda import qconv as qc  # noqa: E402

pytestmark = pytest.mark.cuda

S, HOP, FLEN, M = 144_000, 280, 1024, 96


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    fe.reset_launches()
    qc.reset_launches()
    return torch.device("cuda", 0)


def _segments(n, dev, dtype):
    rng = np.random.default_rng(0)
    x = torch.from_numpy((rng.normal(size=(n, S)) * 0.1).astype(np.float32))
    return x.to(dev).to(dtype)


def _close(got, want, dtype):
    """float32: 1e-3 rel/abs. bf16: |Δ| <= 2^-6 |plain| + 1e-2 (about two
    bf16 ulps: the kernel sums in another order than the plain matmul)."""
    got, want = got.float(), want.float()
    if dtype == torch.float32:
        return bool(torch.all((got - want).abs() <= 1e-3 + 1e-3 * want.abs()))
    return bool(torch.all((got - want).abs() <= 2 ** -6 * want.abs() + 1e-2))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_stft_melspec_kernel_matches_plain(dev, dtype):
    win = (0.5 - 0.5 * np.cos(2 * np.pi * np.arange(FLEN) / FLEN)).astype(np.float32)
    mel = mel_weight_matrix(M, FLEN, 48_000, 150.0, 15_000.0).astype(np.float32)
    x = _segments(4, dev, dtype)
    got = fe.segments_stft_melspec(x, win, mel, hop=HOP)
    torch.cuda.synchronize()
    assert fe.LAUNCHES["stft_melspec"] == 1
    want = fe.stft_melspec_plain(x, win, mel, hop=HOP)
    assert got.shape == want.shape == (4, M, 511) and got.dtype == dtype
    assert _close(got, want, dtype)
    if dtype == torch.float32:
        oracle = fe.stft_melspec_reference(x[:2].cpu().numpy(), win, mel, hop=HOP)
        assert _close(got[:2].cpu(), torch.from_numpy(oracle), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_filterbank_logpower_kernel_matches_plain(dev, dtype):
    rng = np.random.default_rng(1)
    w = torch.from_numpy((rng.normal(size=(M, 1, FLEN)) * 0.02).astype(np.float32)).to(dev)
    x = _segments(4, dev, dtype)
    got = fe.segments_filterbank_logpower(x, w, hop=HOP)
    torch.cuda.synchronize()
    assert fe.LAUNCHES["filterbank_logpower"] == 1
    want = fe.filterbank_logpower_plain(x, w, hop=HOP)
    assert got.shape == want.shape == (4, M, 511) and got.dtype == dtype
    assert _close(got, want, dtype)
    if dtype == torch.float32:
        oracle = fe.filterbank_logpower_reference(
            x[:2].cpu().numpy(), w.cpu().numpy(), hop=HOP
        )
        assert _close(got[:2].cpu(), torch.from_numpy(oracle), dtype)


@pytest.mark.parametrize("frontend,counter", [
    ("conv", "filterbank_logpower"), ("stft", "stft_melspec"),
])
def test_classifier_fast_runs_the_kernel(dev, tmp_path, frontend, counter):
    from birdnet_tpu_torch import Classifier
    from birdnet_tpu_torch.models import birdnet_v24
    from birdnet_tpu_torch.onnx import proto as P

    path = tmp_path / f"v24_{frontend}.onnx"
    P.save_model(birdnet_v24.build_model(num_species=10, width=0.1, depth=1,
                                         frontend=frontend), str(path))
    labels = [f"s{i}" for i in range(10)]
    clf = (Classifier.builder().model_path(path).labels(labels)
           .precision("fast").top_k(3).build())
    assert clf.device == dev
    fe.reset_launches()
    x = _segments(3, "cpu", torch.float32).numpy()
    results = clf.predict_batch(x)
    assert fe.LAUNCHES[counter] == 1
    ref = (Classifier.builder().model_path(path).labels(labels)
           .precision("fp32").top_k(3).build()).predict_batch(x)
    for r, q in zip(results, ref):
        assert np.all(np.isfinite(r.raw_scores))
        scale = np.abs(q.raw_scores).max()
        assert np.abs(r.raw_scores - q.raw_scores).max() / scale < 1e-1


@pytest.mark.parametrize("c_in,c_out,n,act,hostile", [
    (24, 96, 48 * 256, "silu", False),
    (96, 40, 12 * 256, "", False),
    (1280, 320, 1, "silu", False),
    (8, 16, 48 * 256, "", True),
])
def test_qconv1x1_requant_kernel_matches_plain(dev, c_in, c_out, n, act, hostile):
    """B3 at the int8 v2.4 graph's shapes, batch 32: the plain version's
    codes (with silu at most 1 code apart on at most 1e-4 of them). The
    hostile case's output scale 0.3 has an inexact float32 reciprocal."""
    rng = np.random.default_rng(c_in)
    if hostile:
        x = rng.integers(-10, 11, (32, c_in, n))
        w = rng.integers(-3, 4, (c_out, c_in))
        b = rng.integers(-20, 21, c_out)
        scale, y_scale = np.full(c_out, 0.15, np.float32), 0.3
    else:
        x = rng.integers(-127, 128, (32, c_in, n))
        w = rng.integers(-127, 128, (c_out, c_in))
        b = rng.integers(-5000, 5001, c_out)
        scale = (rng.uniform(0.5, 1.5, c_out) / (np.sqrt(c_in) * 5418.0)).astype(np.float32)
        y_scale = 3.0 / 127.0
    x, w, b, scale = (torch.from_numpy(np.asarray(a).astype(dt)).to(dev) for a, dt in (
        (x, np.int8), (w, np.int8), (b, np.int32), (scale, np.float32)))
    got = qc.qconv1x1_requant(x, w, b, scale, y_scale, act)
    torch.cuda.synchronize()
    assert qc.LAUNCHES["qconv1x1_requant"] == 1
    want = qc.qconv1x1_requant_plain(x, w, b, scale, y_scale, act)
    assert got.shape == want.shape == (32, c_out, n) and got.dtype == torch.int8
    diff = (got.int() - want.int()).abs()
    if act:
        assert int(diff.max()) <= 1 and int((diff > 0).sum()) <= 1e-4 * diff.numel()
    else:
        assert torch.equal(got, want)


@pytest.mark.parametrize("frontend,counter", [
    ("conv", "filterbank_logpower"), ("stft", "stft_melspec"),
])
@pytest.mark.parametrize("policy", ["fast", "mixed"])
def test_classifier_int8_runs_b3(dev, tmp_path, frontend, counter, policy):
    from birdnet_tpu_torch import Classifier
    from birdnet_tpu_torch.models import birdnet_v24
    from birdnet_tpu_torch.onnx import proto as P

    path = tmp_path / f"v24_{frontend}.onnx"
    P.save_model(birdnet_v24.build_model(num_species=10, width=0.1, depth=1,
                                         frontend=frontend), str(path))
    labels = [f"s{i}" for i in range(10)]
    clf = (Classifier.builder().model_path(path).labels(labels)
           .precision(policy).top_k(3).int8().build())
    assert clf.device == dev
    fe.reset_launches()
    qc.reset_launches()
    results = clf.predict_batch(_segments(3, "cpu", torch.float32).numpy())
    assert qc.LAUNCHES["qconv1x1_requant"] > 0
    assert fe.LAUNCHES[counter] == (1 if policy == "fast" else 0)
    for r in results:
        assert r.raw_scores.shape == (10,) and np.all(np.isfinite(r.raw_scores))
