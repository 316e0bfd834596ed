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
# coprime with everything, v3.0's hop, and Perch's 128 mels.
GEOMETRIES = [
    pytest.param(9000, 280, 1024, 24, 3, id="v24-hop280"),
    pytest.param(6007, 277, 512, 16, 2, id="coprime-hop277"),
    pytest.param(9000, 320, 1024, 24, 2, id="v30-hop320"),
    pytest.param(9000, 320, 1024, 128, 1, id="perch-mel128"),
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


def _core_matrix_rows(a):
    """The inverse of tfe.core_matrix_order: ``[..., cols, 64]``."""
    *lead, groups, kgroups, rows, taps = a.shape
    return a.swapaxes(-3, -2).reshape(*lead, groups * rows, kgroups * taps)


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


# scale=: int16-range samples scaled in the kernel, by 2^-15 (the int16
# dequantization, exact in every dtype) and by 1/3000 (inexact, so a bf16
# rounding follows the float32 product, as in the JAX kernels).
SCALES = [1 / 32768, 1 / 3000]


def _pcm_like(S, n, seed=0):
    return np.round(np.random.default_rng(seed).normal(size=(n, S)) * 3000).astype(np.float32)


@pytest.mark.parametrize("scale", SCALES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_stft_melspec_scale_matches_jax(dtype, scale):
    S, hop, flen, M, N = 9000, 280, 1024, 24, 2
    segs, win, mel = _pcm_like(S, N), _hann(flen), _banded_mel(flen, M)
    x = torch.from_numpy(segs).to(getattr(torch, dtype))
    got = tfe.segments_stft_melspec(x, win, mel, hop=hop, scale=scale)
    assert got.dtype == x.dtype
    want = jfe.segments_stft_melspec(
        jnp.asarray(segs).astype(dtype), win, mel, hop=hop, frame_length=flen,
        scale=scale, compute_dtype=getattr(jnp, dtype), interpret=True,
    )
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(_as_f32(got), _as_f32(want), rtol=tol, atol=tol)
    unscaled = tfe.segments_stft_melspec(x, win, mel, hop=hop)
    assert np.abs(_as_f32(unscaled) - _as_f32(got)).max() > 1.0


@pytest.mark.parametrize("scale", SCALES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_filterbank_logpower_scale_matches_jax(dtype, scale):
    S, hop, flen, M, N = 9000, 280, 1024, 24, 2
    segs, w = _pcm_like(S, N), _weights(flen, M)
    x = torch.from_numpy(segs).to(getattr(torch, dtype))
    got = tfe.segments_filterbank_logpower(x, torch.from_numpy(w), hop=hop, scale=scale)
    assert got.dtype == x.dtype
    want = jfe.segments_filterbank_logpower(
        jnp.asarray(segs).astype(dtype), w, hop=hop, scale=scale,
        compute_dtype=getattr(jnp, dtype), interpret=True,
    )
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(_as_f32(got), _as_f32(want), rtol=tol, atol=tol)
    unscaled = tfe.segments_filterbank_logpower(x, torch.from_numpy(w), hop=hop)
    assert np.abs(_as_f32(unscaled) - _as_f32(got)).max() > 1.0


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


@pytest.mark.parametrize("F,K", [(24, 512), (96, 1024), (128, 1000), (160, 1024)])
def test_pack_filterbank_reproduces_the_filterbank(F, K):
    """B2's packed operand [groups, K/64, cols, 64] holds W [F, K] with
    zero padding: unpacked it is W, and zero past F and K."""
    w = torch.from_numpy(_weights(K, F))
    packed = tfe.pack_filterbank(w)
    groups, cols = tfe.col_groups(F)
    taps = -(-K // 64) * 64
    assert tuple(packed.shape) == (groups, taps // 64, cols // 8, 8, 8, 8)
    assert packed.is_contiguous() and cols % 32 == 0 and cols <= 128 and groups * cols >= F
    # Core matrix (column group q, tap group r) holds columns 8q.. x taps 8r..
    assert torch.equal(packed[0, 0, 1, 2], w[8:16, 0, 16:24])
    flat = _core_matrix_rows(packed).permute(0, 2, 1, 3).reshape(groups * cols, taps)
    assert torch.equal(flat[:F, :K], w[:, 0])
    assert not flat[F:].any() and not flat[:, K:].any()


def _unpack_stft(bases, melp):
    """(cos [taps, bins_p], sin [taps, bins_p], mel [bins_p, groups*cols])
    from pack_stft_operands' layout."""
    bases, melp = _core_matrix_rows(bases), _core_matrix_rows(melp)
    chunks, kchunks, _, _ = bases.shape
    b = bases.reshape(chunks, kchunks, 2, 64, 64).transpose(2, 1, 4, 0, 3)
    b = b.reshape(2, kchunks * 64, chunks * 64)
    groups, _, cols, _ = melp.shape
    mel = melp.transpose(1, 3, 0, 2).reshape(chunks * 64, groups * cols)
    return b[0], b[1], mel


@pytest.mark.parametrize("S,hop,flen,M,N", GEOMETRIES)
def test_pack_stft_operands_reproduces_the_bases(S, hop, flen, M, N):
    """B1's packed operands hold stft_bases' cos/sin bases and mel rows
    with zero padding, cos of a chunk's 64 bins before their sin."""
    bc, bs, mel_used = tfe.stft_bases(_hann(flen), _banded_mel(flen, M))
    bases, melp = tfe.pack_stft_operands(bc, bs, mel_used)
    bins = bc.shape[1]
    groups, cols = tfe.col_groups(M)
    assert bases.shape == (-(-bins // 64), -(-flen // 64), 16, 8, 8, 8)
    assert melp.shape == (groups, bases.shape[0], cols // 8, 8, 8, 8)
    cos, sin, mel = _unpack_stft(bases, melp)
    np.testing.assert_array_equal(cos[:flen, :bins], bc)
    np.testing.assert_array_equal(sin[:flen, :bins], bs)
    np.testing.assert_array_equal(mel[:bins, :M], mel_used)
    for pad in (cos[flen:], cos[:, bins:], sin[flen:], sin[:, bins:], mel[bins:], mel[:, M:]):
        assert not pad.any()


def _frames_padded(x, flen, hop, taps):
    return torch.nn.functional.pad(x.float().unfold(-1, flen, hop), (0, taps - flen))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,hop,flen,M,N", GEOMETRIES)
def test_stft_through_packed_operands_matches_plain(S, hop, flen, M, N, dtype):
    """B1 computed as the tensor-core kernel does, from its packed operands
    in the compute dtype: per 64-bin chunk c and s over the zero-padded
    taps, the power rounded to the compute dtype, the mel product summed
    over chunks. Within the plain version's tolerance (the sums run in
    another order)."""
    win, mel = _hann(flen), _banded_mel(flen, M)
    x = torch.from_numpy(_segments(S, N)).to(dtype)
    bases, melp = (_core_matrix_rows(torch.from_numpy(a).to(dtype).float())
                   for a in tfe.pack_stft_operands(*tfe.stft_bases(win, mel)))
    chunks, kchunks, _, _ = bases.shape
    frames = _frames_padded(x, flen, hop, kchunks * 64)
    fb = 0.0
    for j in range(chunks):
        cs = frames @ bases[j].permute(0, 2, 1).reshape(kchunks * 64, 128)
        c, s = cs[..., :64], cs[..., 64:]
        power = (c * c + s * s).to(dtype).float()
        fb = fb + power @ melp[:, j].permute(2, 0, 1).reshape(64, -1)
    got = torch.log(fb[..., :M] + 1e-6).to(dtype).transpose(1, 2)
    want = tfe.stft_melspec_plain(x, win, mel, hop=hop)
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    np.testing.assert_allclose(_as_f32(got), _as_f32(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,hop,flen,M,N", GEOMETRIES)
def test_filterbank_through_packed_operand_matches_plain(S, hop, flen, M, N, dtype):
    """B2 computed from its packed filterbank in the compute dtype over the
    zero-padded taps: the plain version, within its tolerance."""
    w = torch.from_numpy(_weights(flen, M))
    x = torch.from_numpy(_segments(S, N)).to(dtype)
    packed = _core_matrix_rows(tfe.pack_filterbank(w.to(dtype)).float())
    groups, kchunks, cols, _ = packed.shape
    flat = packed.permute(0, 2, 1, 3).reshape(groups * cols, kchunks * 64)
    y = (_frames_padded(x, flen, hop, kchunks * 64) @ flat.t())[..., :M]
    got = torch.log(y * y + 1e-6).to(dtype).transpose(1, 2)
    want = tfe.filterbank_logpower_plain(x, w, hop=hop)
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    np.testing.assert_allclose(_as_f32(got), _as_f32(want), rtol=tol, atol=tol)


def test_packed_filterbank_is_cached_per_tensor():
    """The bf16 pack of a filterbank is made once while the tensor lives
    and is unchanged; an in-place change packs it again."""
    w = torch.from_numpy(_weights(512, 24))
    first = tfe._packed_filterbank(w)
    assert first.dtype == torch.bfloat16 and tfe._packed_filterbank(w) is first
    w.mul_(2.0)
    again = tfe._packed_filterbank(w)
    assert again is not first and torch.equal(again.float(), 2 * first.float())


def test_packed_filterbank_of_an_inference_tensor_is_never_stale():
    """An inference tensor has no version counter: its pack is built on
    every call, so an in-place change is always seen."""
    with torch.inference_mode():
        w = torch.from_numpy(_weights(512, 24)).clone()
    first = tfe._packed_filterbank(w)
    with torch.inference_mode():
        w.mul_(2.0)
    again = tfe._packed_filterbank(w)
    assert torch.equal(again.float(), 2 * first.float())
    assert torch.equal(tfe._packed_filterbank(w), again)


def test_operand_cache_keeps_the_newest_entries():
    """B1's and B2's operands share one cache of the newest entries: an
    entry pushed out is built again, an entry kept is found."""
    win, mel = _hann(512), _banded_mel(512, 8)
    first = tfe._bases_for(win, mel, torch.bfloat16, "cpu", packed=True)
    banks = [torch.from_numpy(_weights(512, 8)) for _ in range(tfe._OPERANDS_KEPT)]
    packs = [tfe._packed_filterbank(w) for w in banks]
    assert tfe._bases_for(win, mel, torch.bfloat16, "cpu", packed=True) is not first
    assert tfe._packed_filterbank(banks[-1]) is packs[-1]


def test_stft_operands_are_cached_by_content():
    """B1's operands are built once per (window, mel, dtype, device) and
    found again from equal arrays; a changed bank gets its own."""
    win, mel = _hann(512), _banded_mel(512, 8)
    first = tfe._bases_for(win, mel, torch.bfloat16, "cpu", packed=True)
    assert tfe._bases_for(win.copy(), mel.copy(), torch.bfloat16, "cpu", packed=True) is first
    changed = mel.copy()
    changed[40, 2] += 0.5
    other = tfe._bases_for(win, changed, torch.bfloat16, "cpu", packed=True)
    assert other is not first and not torch.equal(other[1], first[1])
    assert tfe._bases_for(win, mel, torch.float32, "cpu") is not first


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


# B5's split-TF32 operands. TF32 keeps 10 of float32's 23 mantissa bits.
TF32_LOW_BITS = 0x1FFF


@pytest.mark.parametrize("scale", [1e-3, 1.0, 3e4])
def test_split_tf32_reconstructs_the_weights(scale):
    """big has at most 10 mantissa bits (its low 13 bits are zero) and is
    the nearest TF32 value; big + small gives w within 2^-22 relative."""
    w = torch.from_numpy((np.random.default_rng(6).normal(size=4096) * scale)
                         .astype(np.float32))
    big, small = tfe.split_tf32(w)
    for part in (big, small):
        assert not (part.view(torch.int32) & TF32_LOW_BITS).any()
    assert torch.all((w - big).abs() <= w.abs() * 2.0 ** -11)
    err = ((big.double() + small.double()) - w.double()).abs()
    assert torch.all(err <= w.abs().double() * 2.0 ** -22)


def test_split_tf32_rounds_ties_away_from_zero():
    """cvt.rna: a value halfway between two TF32 values goes away from 0."""
    signed = lambda u: u - (1 << 32) if u >= 1 << 31 else u
    bits = torch.tensor([signed(b) for b in (0x3F801000, 0xBF801000, 0x3F800FFF)],
                        dtype=torch.int32)
    big, _ = tfe.split_tf32(bits.view(torch.float32))
    assert big.view(torch.int32).tolist() == [signed(b) for b in (0x3F802000, 0xBF802000,
                                                                   0x3F800000)]


def test_split_tf32_is_exact_for_int16_samples():
    """Every int16 code scaled by 2^-15 (16 significant bits) splits
    exactly: big + small is the sample."""
    x = torch.arange(-32768, 32768, dtype=torch.int32).float() / 32768.0
    big, small = tfe.split_tf32(x)
    assert torch.equal(big + small, x)


def _unpack_tf32(packed):
    """(w_big, w_small) [groups * cols, taps] from pack_filterbank_tf32."""
    groups, kchunks, _, col_groups_, kgroups, rows, per = packed.shape
    parts = packed.permute(2, 0, 1, 3, 4, 5, 6).reshape(2, groups, kchunks, col_groups_, kgroups,
                                                         rows, per)
    parts = parts.permute(0, 1, 3, 5, 2, 4, 6)  # [2, g, col group, row, chunk, kgroup, per]
    flat = parts.reshape(2, groups * col_groups_ * rows, kchunks * kgroups * per)
    return flat[0], flat[1]


@pytest.mark.parametrize("F,K", [(24, 512), (96, 1024), (128, 1000), (160, 1024)])
def test_pack_filterbank_tf32_reproduces_the_filterbank(F, K):
    """B5's packed operand [groups, K/32, 2, cols/8, 8, 8, 4] holds the split
    W [F, K]: big + small is W, zero past F and K."""
    w = torch.from_numpy(_weights(K, F))
    packed = tfe.pack_filterbank_tf32(w)
    groups, cols = tfe.col_groups(F)
    taps = -(-K // 32) * 32
    assert tuple(packed.shape) == (groups, taps // 32, 2, cols // 8, 8, 8, 4)
    assert packed.is_contiguous() and packed.dtype == torch.float32
    # Core matrix (column group 1, tap group 2) of w_big: columns 8.. x taps 8..
    big, small = tfe.split_tf32(w[:, 0])
    assert torch.equal(packed[0, 0, 0, 1, 2], big[8:16, 8:12])
    got_big, got_small = _unpack_tf32(packed)
    assert torch.equal(got_big[:F, :K], big) and torch.equal(got_small[:F, :K], small)
    for pad in (got_big[F:], got_big[:, K:], got_small[F:], got_small[:, K:]):
        assert not pad.any()


@pytest.mark.parametrize("audio_dtype", ["float32", "int16"])
def test_frame_filterbank_through_split_tf32_matches_plain(audio_dtype):
    """B5 computed as its kernel does, from the packed operand: the frames
    split in TF32, then small·big + big·small + big·big summed in float64
    (the tensor cores' f32 sums are exact enough here): the plain version
    within its 1e-3 bound, and the f64 oracle too."""
    S, hop, K, F, step, n_seg = 4000, 280, 1000, 96, 3000, 3
    rng = np.random.default_rng(8)
    x = rng.normal(size=(n_seg - 1) * step + S + 2 * hop) * 0.2
    audio = (torch.from_numpy((x * 32768).astype(np.int16)) if audio_dtype == "int16"
             else torch.from_numpy(x.astype(np.float32)))
    scale = 1 / 32768 if audio_dtype == "int16" else 1.0
    w = torch.from_numpy(_weights(K, F)[:, 0])
    w_big, w_small = (p[:F].double() for p in _unpack_tf32(tfe.pack_filterbank_tf32(w)))
    kw = dict(n_segments=n_seg, step=step, sample_count=S, hop=hop, scale=scale)
    want = tfe.frame_filterbank_logpower_plain(audio, w, **kw)
    n_frames = want.shape[1]
    taps = w_big.shape[1]
    span = (n_frames - 1) * hop + taps
    scaled = torch.nn.functional.pad(audio.float() * scale, (0, taps))
    frames = scaled[:(n_seg - 1) * step + span].unfold(0, span, step)[:n_seg].unfold(
        1, taps, hop).clone()
    frames[..., K:] = 0.0  # the kernel zeroes taps at or past K
    big, small = (p.double() for p in tfe.split_tf32(frames))
    y = small @ w_big.t() + big @ w_small.t() + big @ w_big.t()
    got = torch.log(y * y + 1e-6).float()
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=F32_TOL, atol=F32_TOL)
    segs = torch.stack([(audio.float() * scale)[i * step:i * step + S] for i in range(n_seg)])
    oracle = tfe.filterbank_logpower_reference(segs.numpy(), w.numpy(), hop=hop)
    np.testing.assert_allclose(got.numpy(), oracle.transpose(0, 2, 1), rtol=F32_TOL, atol=F32_TOL)


def test_packed_filterbank_tf32_is_cached_per_tensor():
    """B5's pack is made once while the filterbank lives and is unchanged;
    an in-place change packs it again, as B2's."""
    w = torch.from_numpy(_weights(512, 24)[:, 0])
    first = tfe._packed_filterbank_tf32(w)
    assert tfe._packed_filterbank_tf32(w) is first
    w.mul_(2.0)
    again = tfe._packed_filterbank_tf32(w)
    assert again is not first and torch.equal(again, 2 * first)
