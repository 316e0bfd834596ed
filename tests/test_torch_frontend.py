"""The port's frontend module (birdnet_tpu_torch/ops/cuda/frontend.py) on
the CPU: the plain versions of kernels B1 (STFT → mel), B2 (filterbank
log-power) and B5 (filterbank log-power over windows of one buffer) against
the JAX package's Pallas kernels run in interpret mode and against the f64
numpy oracles. The CUDA kernels themselves run only on
the card (tests/test_torch_cuda.py and chip_smoke.py)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from birdnet_tpu.ops.pallas import frontend as jfe  # noqa: E402
from birdnet_tpu_torch.ops.cuda import build  # noqa: E402
from birdnet_tpu_torch.ops.cuda import frontend as tfe  # noqa: E402

# (S, hop, flen/K, M, N): the BirdNET geometry cut to 9000 samples, a hop
# coprime with everything, and v3.0's hop.
GEOMETRIES = [
    pytest.param(9000, 280, 1024, 24, 3, id="v24-hop280"),
    pytest.param(6007, 277, 512, 16, 2, id="coprime-hop277"),
    pytest.param(9000, 320, 1024, 24, 2, id="v30-hop320"),
]

# float32: the existing Pallas tests' bound in log space (1e-3 rel/abs);
# the two sides sum the same f32 products in another order.
F32_TOL = 1e-3
# bf16: both sides round the same operands and the power to bf16, but the
# f32 sums run in another order, so a bf16 output value near log(eps)
# ~ -13.8 can flip by one ulp (2^-6 * 8 = 0.0625 at worst, rare); 3e-2 abs
# bounds the typical one-ulp flip of values in [-4, 4).
BF16_TOL = 3e-2


def _segments(S, n, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, S)) * 0.1).astype(np.float32)


def _hann(flen):
    return (0.5 - 0.5 * np.cos(2 * np.pi * np.arange(flen) / flen)).astype(np.float32)


def _banded_mel(flen, M):
    """A mel-like bank whose nonzero support starts past bin 0 and ends
    before the last bin, so the basis truncation is exercised."""
    bins = flen // 2 + 1
    mel = np.zeros((bins, M), np.float32)
    width = max(2, (bins - 20) // (M + 1))
    for m in range(M):
        c = 5 + (m + 1) * width
        for b in range(max(0, c - width), min(bins, c + width)):
            mel[b, m] = 1.0 - abs(b - c) / width
    return mel


def _weights(K, F, seed=1):
    return (np.random.default_rng(seed).normal(size=(F, 1, K)) * 0.02).astype(np.float32)


def _as_f32(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


@pytest.fixture(autouse=True)
def _zero_launches():
    tfe.reset_launches()
    yield
    assert tfe.LAUNCHES == dict.fromkeys(
        ("filterbank_logpower", "stft_melspec", "frame_filterbank_logpower"), 0
    ), "a CPU tensor must take the plain version, never the kernel"


@pytest.mark.parametrize("S,hop,flen,M,N", GEOMETRIES)
def test_stft_melspec_f32(S, hop, flen, M, N):
    segs, win, mel = _segments(S, N), _hann(flen), _banded_mel(flen, M)
    got = tfe.segments_stft_melspec(torch.from_numpy(segs), win, mel, hop=hop)
    assert got.dtype == torch.float32
    assert tuple(got.shape) == (N, M, (S - flen) // hop + 1)
    want = np.asarray(jfe.segments_stft_melspec(
        jnp.asarray(segs), win, mel, hop=hop, frame_length=flen,
        compute_dtype=jnp.float32, interpret=True,
    ))
    np.testing.assert_allclose(got.numpy(), want, rtol=F32_TOL, atol=F32_TOL)
    oracle = tfe.stft_melspec_reference(segs, win, mel, hop=hop)
    np.testing.assert_allclose(
        oracle, jfe.stft_melspec_reference(segs, win, mel, hop=hop), rtol=1e-6
    )
    np.testing.assert_allclose(got.numpy(), oracle, rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("S,hop,flen,M,N", GEOMETRIES)
def test_stft_melspec_bf16(S, hop, flen, M, N):
    segs, win, mel = _segments(S, N), _hann(flen), _banded_mel(flen, M)
    x = torch.from_numpy(segs).to(torch.bfloat16)
    got = tfe.segments_stft_melspec(x, win, mel, hop=hop)
    assert got.dtype == torch.bfloat16
    want = jfe.segments_stft_melspec(
        jnp.asarray(segs).astype(jnp.bfloat16), win, mel, hop=hop,
        frame_length=flen, compute_dtype=jnp.bfloat16, interpret=True,
    )
    assert np.abs(_as_f32(got) - _as_f32(want)).max() <= BF16_TOL


@pytest.mark.parametrize("S,hop,flen,M,N", GEOMETRIES)
def test_filterbank_logpower_f32(S, hop, flen, M, N):
    segs, w = _segments(S, N), _weights(flen, M)
    got = tfe.segments_filterbank_logpower(torch.from_numpy(segs),
                                           torch.from_numpy(w), hop=hop)
    assert got.dtype == torch.float32
    assert tuple(got.shape) == (N, M, (S - flen) // hop + 1)
    want = np.asarray(jfe.segments_filterbank_logpower(
        jnp.asarray(segs), w, hop=hop, compute_dtype=jnp.float32,
        interpret=True,
    ))
    np.testing.assert_allclose(got.numpy(), want, rtol=F32_TOL, atol=F32_TOL)
    # The JAX oracle's flat-stream form: segments back to back at step=S.
    flat = jfe.frontend_reference(
        segs.reshape(-1), w, n_segments=N, step=S, sample_count=S, hop=hop,
        scale=1.0,
    ).transpose(0, 2, 1)
    oracle = tfe.filterbank_logpower_reference(segs, w, hop=hop)
    np.testing.assert_allclose(oracle, flat, rtol=F32_TOL, atol=F32_TOL)
    np.testing.assert_allclose(got.numpy(), oracle, rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("S,hop,flen,M,N", GEOMETRIES)
def test_filterbank_logpower_bf16(S, hop, flen, M, N):
    segs, w = _segments(S, N), _weights(flen, M)
    x = torch.from_numpy(segs).to(torch.bfloat16)
    got = tfe.segments_filterbank_logpower(x, torch.from_numpy(w), hop=hop)
    assert got.dtype == torch.bfloat16
    want = jfe.segments_filterbank_logpower(
        jnp.asarray(segs).astype(jnp.bfloat16), w, hop=hop,
        compute_dtype=jnp.bfloat16, interpret=True,
    )
    assert np.abs(_as_f32(got) - _as_f32(want)).max() <= BF16_TOL


def test_stft_bases_match_jax_construction():
    """The host-side DFT bases: the mel bank's nonzero support, f64 angles
    with the window folded in, cast to float32."""
    flen, M = 1024, 24
    win, mel = _hann(flen), _banded_mel(flen, M)
    bc, bs, mel_used = tfe.stft_bases(win, mel)
    nz = np.flatnonzero(np.abs(mel).max(axis=1) > 0)
    assert bc.shape == bs.shape == (flen, nz[-1] + 1 - nz[0])
    assert mel_used.shape == (bc.shape[1], M)
    ang = (-2.0 * np.pi / flen) * np.outer(
        np.arange(flen, dtype=np.float64),
        np.arange(nz[0], nz[-1] + 1, dtype=np.float64),
    )
    np.testing.assert_array_equal(bc, (np.cos(ang) * win[:, None].astype(np.float64)).astype(np.float32))
    np.testing.assert_array_equal(bs, (np.sin(ang) * win[:, None].astype(np.float64)).astype(np.float32))


def test_wrappers_reject_what_the_kernels_do_not_take():
    x = torch.zeros(2, 4000, dtype=torch.float16)
    with pytest.raises(TypeError):
        tfe.segments_filterbank_logpower(x, torch.zeros(4, 1, 512), hop=100)
    with pytest.raises(ValueError):
        tfe.segments_stft_melspec(torch.zeros(4000), _hann(512),
                                  _banded_mel(512, 4), hop=100)
    with pytest.raises(ValueError, match="filterbank"):
        tfe.segments_filterbank_logpower(torch.zeros(2, 4000),
                                         torch.zeros(4, 2, 512), hop=100)
    with pytest.raises(ValueError, match="shorter than one"):
        tfe.segments_filterbank_logpower(torch.zeros(2, 100),
                                         torch.zeros(4, 1, 512), hop=100)


def test_failed_build_raises(monkeypatch):
    """No nvcc: the build raises, and nothing falls back."""
    monkeypatch.setenv("PATH", "")
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(build, "DEFAULT_NVCC", "/nonexistent/nvcc")
    monkeypatch.setattr(build, "library_path",
                        lambda: build.BUILD_DIR / "libmissing.so")
    with pytest.raises(build.KernelBuildError, match="nvcc not found"):
        build.build()


def test_library_name_tracks_sources_and_flags(monkeypatch):
    first = build.library_path()
    assert first.parent == build.BUILD_DIR
    monkeypatch.setattr(build, "NVCC_FLAGS", build.NVCC_FLAGS + ("-lineinfo",))
    assert build.library_path() != first


@pytest.mark.parametrize("failing", [None, "stage_prefix.cu"])
def test_build_runs_one_nvcc_per_source_then_links(monkeypatch, tmp_path, failing):
    """A stand-in nvcc logs its calls: one compile per source, then one
    link into the hashed library name; a failing source raises with its
    command and leaves no library."""
    log = tmp_path / "calls.txt"
    nvcc = tmp_path / "bin" / "nvcc"
    nvcc.parent.mkdir()
    nvcc.write_text(
        "#!/bin/sh\n"
        f'echo "$@" >> "{log}"\n'
        f'case "$*" in *"{failing or "-no-such-source-"}"*) echo broken; exit 2;; esac\n'
        'while [ $# -gt 0 ]; do [ "$1" = "-o" ] && : > "$2"; shift; done\n'
    )
    nvcc.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    sources = build._sources()
    if failing:
        with pytest.raises(build.KernelBuildError, match="nvcc failed.*stage_prefix.cu"):
            build.build()
        assert not build.library_path().exists()
        return
    assert build.build() == build.library_path() and build.library_path().exists()
    calls = log.read_text().splitlines()
    assert len(calls) == len(sources) + 1
    assert sorted(c.split()[-1] for c in calls[:-1]) == sorted(map(str, sources))
    assert all(" -c " in c for c in calls[:-1]) and " -shared " in calls[-1]


# B5 on the cases of tests/test_pallas_frontend.py, against the JAX function
# in interpret mode; its bound, 1e-3 rel/abs (float32 sums in another order).
@pytest.mark.parametrize("S,hop,K,F,step,n_seg", [
    pytest.param(4000, 280, 1024, 96, 3000, 4, id="overlapping"),
    pytest.param(4000, 280, 1024, 96, 4000, 3, id="zero-overlap"),
    pytest.param(2048, 128, 512, 64, 1024, 5, id="aligned-hop"),
])
def test_frame_filterbank_logpower_f32(S, hop, K, F, step, n_seg):
    rng = np.random.default_rng(S + step)
    audio = rng.normal(size=(n_seg - 1) * step + S + 2 * hop).astype(np.float32)
    w = (rng.normal(size=(F, K)) * 0.02).astype(np.float32)
    kw = dict(n_segments=n_seg, step=step, sample_count=S, hop=hop, scale=1.0)
    got = tfe.frame_filterbank_logpower(torch.from_numpy(audio), torch.from_numpy(w), **kw)
    want = np.asarray(jfe.frame_filterbank_logpower(audio, w, interpret=True, **kw))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=F32_TOL, atol=F32_TOL)
    np.testing.assert_allclose(got.numpy(), jfe.frontend_reference(audio, w, **kw),
                               rtol=F32_TOL, atol=F32_TOL)


def test_frame_filterbank_logpower_int16_dequant():
    S, hop, K, F, step, n_seg = 4000, 280, 1024, 96, 3000, 3
    rng = np.random.default_rng(3)
    audio = rng.normal(size=(n_seg - 1) * step + S + 2 * hop)
    i16 = (np.clip(audio, -1, 0.999) * 32768).astype(np.int16)
    w = (rng.normal(size=(F, K)) * 0.02).astype(np.float32)
    kw = dict(n_segments=n_seg, step=step, sample_count=S, hop=hop)
    got = tfe.frame_filterbank_logpower(torch.from_numpy(i16), torch.from_numpy(w), **kw)
    want = np.asarray(jfe.frame_filterbank_logpower(i16, w, interpret=True, **kw))
    np.testing.assert_allclose(got.numpy(), want, rtol=F32_TOL, atol=F32_TOL)


def test_frame_filterbank_logpower_conv_weight_layout():
    """[F, 1, K] Conv1d weights give what [F, K] gives."""
    S, hop, K, F, step, n_seg = 2048, 128, 512, 64, 2048, 2
    rng = np.random.default_rng(4)
    audio = rng.normal(size=n_seg * S + 2 * hop).astype(np.float32)
    w3 = (rng.normal(size=(F, 1, K)) * 0.02).astype(np.float32)
    kw = dict(n_segments=n_seg, step=step, sample_count=S, hop=hop, scale=1.0)
    got = tfe.frame_filterbank_logpower(torch.from_numpy(audio), torch.from_numpy(w3), **kw)
    want = np.asarray(jfe.frame_filterbank_logpower(audio, w3, interpret=True, **kw))
    np.testing.assert_allclose(got.numpy(), want, rtol=F32_TOL, atol=F32_TOL)
    flat = tfe.frame_filterbank_logpower(torch.from_numpy(audio),
                                         torch.from_numpy(w3[:, 0]), **kw)
    np.testing.assert_array_equal(got.numpy(), flat.numpy())


def test_frame_filterbank_logpower_rejects_short_audio():
    kw = dict(n_segments=2, step=100, sample_count=128, hop=32)
    with pytest.raises(ValueError, match="too short"):
        tfe.frame_filterbank_logpower(torch.zeros(100), torch.zeros(8, 64), **kw)
    with pytest.raises(ValueError):
        jfe.frame_filterbank_logpower(np.zeros(100, np.float32),
                                      np.zeros((8, 64), np.float32),
                                      interpret=True, **kw)
    with pytest.raises(TypeError):
        tfe.frame_filterbank_logpower(torch.zeros(1000, dtype=torch.float64),
                                      torch.zeros(8, 64), **kw)
