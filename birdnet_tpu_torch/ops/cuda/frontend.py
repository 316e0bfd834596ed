"""Fused audio frontends: hand-written CUDA kernels and their plain versions.

Three kernels, in ``birdnet_tpu_torch/csrc/frontend.cu``:

- :func:`segments_filterbank_logpower` (B2) — the conv-form frontend:
  frames ``[T, K]`` of each segment times the filterbank, then
  ``log(y² + eps)``. Replaces the Pallas kernel
  ``birdnet_tpu/ops/pallas/frontend.py::segments_filterbank_logpower``.
- :func:`segments_stft_melspec` (B1) — the STFT-form frontend: a windowed
  DFT cut to the mel bank's nonzero bins, power, mel projection and
  ``log(x + eps)``. Replaces
  ``birdnet_tpu/ops/pallas/frontend.py::segments_stft_melspec``.
- :func:`frame_filterbank_logpower` (B5) — the conv-form frontend over
  ``n_segments`` windows at ``step`` of ONE 1-D float32 or int16 buffer,
  the samples scaled in the kernel, float32 throughout, returning
  ``[n, T, F]``: the JAX package's public function of that name, with its
  signature. Replaces
  ``birdnet_tpu/ops/pallas/frontend.py::frame_filterbank_logpower``; any
  hop and step (the TPU's ``hop % 128`` rule is a Mosaic rule).

B1 and B2 take segments ``[N, S]`` in the compute dtype (float32 or bfloat16) and
return ``[N, F|M, T]`` in that dtype, the mel-image orientation. They keep
the TPU kernels' rounding points: the framed samples and the weights are in
the compute dtype, products accumulate in float32, B1's power is rounded to
the compute dtype before the mel product, and the log is taken in float32.

A wrapper dispatches on the tensor's device: a CPU tensor takes the plain
PyTorch version (``*_plain``), a CUDA tensor launches the kernel (building
it on first use) or raises. ``LAUNCHES`` counts kernel launches.

The f64 numpy oracles (``*_reference``) are the JAX package's
``stft_melspec_reference`` and ``frontend_reference`` in segment form.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from .build import check, load_library

LAUNCHES = {"filterbank_logpower": 0, "stft_melspec": 0,
            "frame_filterbank_logpower": 0}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def reset_launches() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def _n_frames(sample_count: int, flen: int, hop: int) -> int:
    n_frames = (sample_count - flen) // hop + 1
    if n_frames <= 0:
        raise ValueError(
            f"segment of {sample_count} samples shorter than one "
            f"{flen}-sample frame"
        )
    return n_frames


def _check_segments(segments: torch.Tensor) -> None:
    if segments.ndim != 2:
        raise ValueError(f"segments must be [N, S], got {tuple(segments.shape)}")
    if segments.dtype not in _DTYPE_CODES:
        raise TypeError(
            f"segments must be float32 or bfloat16, got {segments.dtype}"
        )


def _filterbank(weights: torch.Tensor) -> torch.Tensor:
    """The Conv1d filterbank ``[F, 1, K]`` (or ``[F, K]``) as ``[F, K]``."""
    if not (weights.ndim == 2 or (weights.ndim == 3 and weights.shape[1] == 1)):
        raise ValueError(
            f"filterbank must be [F, 1, K] or [F, K], got {tuple(weights.shape)}"
        )
    return weights.reshape(weights.shape[0], weights.shape[-1])


def _frames(segments: torch.Tensor, flen: int, hop: int) -> torch.Tensor:
    """[N, S] -> [N, T, flen] float32 frames (values already rounded to the
    compute dtype, which is the segments' dtype)."""
    return segments.float().unfold(-1, flen, hop)


def _launch_ready(segments: torch.Tensor, *others: torch.Tensor) -> None:
    if segments.device.type != "cuda":
        raise ValueError(
            f"frontend kernels run on CUDA tensors (got {segments.device}); "
            f"CPU tensors take the plain version"
        )
    for t in (segments,) + others:
        if t.device != segments.device:
            raise ValueError(f"tensor on {t.device}, segments on {segments.device}")
        if t.dtype != segments.dtype:
            raise TypeError(f"tensor of {t.dtype}, segments of {segments.dtype}")
        if not t.is_contiguous():
            raise ValueError("frontend kernels take contiguous tensors")


# ---------------------------------------------------------------------------
# B2: conv-form filterbank log-power
# ---------------------------------------------------------------------------


def filterbank_logpower_plain(segments: torch.Tensor, weights: torch.Tensor,
                              *, hop: int, eps: float = 1e-6) -> torch.Tensor:
    """Plain PyTorch version of :func:`segments_filterbank_logpower`."""
    _check_segments(segments)
    weights = _filterbank(weights)
    _n_frames(segments.shape[1], weights.shape[1], hop)
    frames = _frames(segments, weights.shape[1], hop)
    w = weights.to(segments.dtype).float()
    y = torch.matmul(frames, w.t())  # [N, T, F] float32
    out = torch.log(y * y + eps)
    return out.to(segments.dtype).transpose(1, 2).contiguous()


def segments_filterbank_logpower(segments: torch.Tensor, weights: torch.Tensor,
                                 *, hop: int, eps: float = 1e-6) -> torch.Tensor:
    """Conv-form frontend over segments ``[N, S]``: returns ``[N, F, T]``
    ``log((frames @ Wᵀ)² + eps)`` in the segments' dtype, where ``weights``
    is the Conv1d filterbank ``[F, 1, K]`` or ``[F, K]``."""
    _check_segments(segments)
    if segments.device.type == "cpu":
        return filterbank_logpower_plain(segments, weights, hop=hop, eps=eps)
    n, sample_count = segments.shape
    weights = _filterbank(weights)
    n_filters, kernel_size = weights.shape
    n_frames = _n_frames(sample_count, kernel_size, hop)
    wt = weights.to(segments.dtype).t().contiguous()  # [K, F]
    _launch_ready(segments, wt)
    out = torch.empty((n, n_filters, n_frames), dtype=segments.dtype,
                      device=segments.device)
    lib = load_library()
    status = lib.bn_filterbank_logpower(
        _DTYPE_CODES[segments.dtype], segments.data_ptr(), wt.data_ptr(),
        out.data_ptr(), n, sample_count, kernel_size, hop, n_filters,
        n_frames, float(eps), torch.cuda.current_stream(segments.device).cuda_stream,
    )
    check(status, "filterbank_logpower kernel")
    LAUNCHES["filterbank_logpower"] += 1
    return out


# ---------------------------------------------------------------------------
# B1: STFT -> power -> mel -> log
# ---------------------------------------------------------------------------


def stft_bases(window: np.ndarray, mel: np.ndarray
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Host-side operands of B1, built as the JAX kernel builds them: the
    DFT restricted to the mel bank's nonzero bin support, with f64 angles
    and the window folded in, then cast to float32. Returns
    ``(bc [flen, bins], bs [flen, bins], mel_used [bins, M])``."""
    window = np.asarray(window, np.float32).reshape(-1)
    mel = np.asarray(mel, np.float32)
    flen = int(window.shape[0])
    if mel.ndim != 2 or mel.shape[0] != flen // 2 + 1:
        raise ValueError(
            f"mel rows ({mel.shape[0]}) must equal flen//2+1 ({flen // 2 + 1})"
        )
    nz = np.flatnonzero(np.abs(mel).max(axis=1) > 0.0)
    lo_bin = int(nz[0]) if nz.size else 0
    hi_bin = int(nz[-1]) + 1 if nz.size else 1
    ang = (-2.0 * np.pi / flen) * np.outer(
        np.arange(flen, dtype=np.float64),
        np.arange(lo_bin, hi_bin, dtype=np.float64),
    )
    wcol = window.astype(np.float64)[:, None]
    bc = (np.cos(ang) * wcol).astype(np.float32)
    bs = (np.sin(ang) * wcol).astype(np.float32)
    return bc, bs, np.array(mel[lo_bin:hi_bin])


@functools.lru_cache(maxsize=8)
def _device_bases(window_bytes: bytes, mel_bytes: bytes, mel_shape,
                  dtype: torch.dtype, device: torch.device):
    window = np.frombuffer(window_bytes, np.float32)
    mel = np.frombuffer(mel_bytes, np.float32).reshape(mel_shape)
    return tuple(
        torch.from_numpy(a).to(device=device, dtype=dtype)
        for a in stft_bases(window, mel)
    )


def _bases_for(window, mel, dtype, device):
    window = np.ascontiguousarray(window, np.float32).reshape(-1)
    mel = np.ascontiguousarray(mel, np.float32)
    return _device_bases(window.tobytes(), mel.tobytes(), mel.shape, dtype,
                         torch.device(device))


def stft_melspec_plain(segments: torch.Tensor, window, mel, *, hop: int,
                       eps: float = 1e-6) -> torch.Tensor:
    """Plain PyTorch version of :func:`segments_stft_melspec`."""
    _check_segments(segments)
    bc, bs, mel_used = (
        b.float() for b in _bases_for(window, mel, segments.dtype, segments.device)
    )
    _n_frames(segments.shape[1], bc.shape[0], hop)
    frames = _frames(segments, bc.shape[0], hop)
    c = torch.matmul(frames, bc)
    s = torch.matmul(frames, bs)
    power = (c * c + s * s).to(segments.dtype).float()
    fb = torch.matmul(power, mel_used)  # [N, T, M] float32
    return torch.log(fb + eps).to(segments.dtype).transpose(1, 2).contiguous()


def segments_stft_melspec(segments: torch.Tensor, window, mel, *, hop: int,
                          eps: float = 1e-6) -> torch.Tensor:
    """STFT-form frontend over segments ``[N, S]``: framing at ``hop``,
    windowed DFT, power, mel projection and ``log(x + eps)``. ``window``
    ``[flen]`` and ``mel`` ``[flen//2+1, M]`` are host arrays. Returns
    ``[N, M, T]`` in the segments' dtype."""
    _check_segments(segments)
    if segments.device.type == "cpu":
        return stft_melspec_plain(segments, window, mel, hop=hop, eps=eps)
    bc, bs, mel_used = _bases_for(window, mel, segments.dtype, segments.device)
    n, sample_count = segments.shape
    flen, bins = bc.shape
    n_mels = mel_used.shape[1]
    n_frames = _n_frames(sample_count, flen, hop)
    _launch_ready(segments, bc, bs, mel_used)
    out = torch.empty((n, n_mels, n_frames), dtype=segments.dtype,
                      device=segments.device)
    lib = load_library()
    status = lib.bn_stft_melspec(
        _DTYPE_CODES[segments.dtype], segments.data_ptr(), bc.data_ptr(),
        bs.data_ptr(), mel_used.data_ptr(), out.data_ptr(), n, sample_count,
        flen, hop, bins, n_mels, n_frames, float(eps),
        torch.cuda.current_stream(segments.device).cuda_stream,
    )
    check(status, "stft_melspec kernel")
    LAUNCHES["stft_melspec"] += 1
    return out


# ---------------------------------------------------------------------------
# B5: the conv-form frontend over windows of one 1-D buffer
# ---------------------------------------------------------------------------

_AUDIO_CODES = {torch.float32: 0, torch.int16: 1}


def _frame_geometry(audio: torch.Tensor, weights: torch.Tensor, n_segments: int,
                    step: int, sample_count: int, hop: int):
    """``(weights [F, K] float32, n_frames)``; raises as the JAX function
    does when ``audio`` is too short for ``n_segments`` windows."""
    if audio.ndim != 1 or audio.dtype not in _AUDIO_CODES:
        raise TypeError(
            f"audio must be 1-D float32 or int16, got {audio.dtype} "
            f"{tuple(audio.shape)}"
        )
    weights = _filterbank(weights).float()
    kernel_size = weights.shape[1]
    n_frames = _n_frames(sample_count, kernel_size, hop)
    rows = n_frames + -(-kernel_size // hop) - 1
    need = (n_segments - 1) * step + rows * hop
    if audio.shape[0] < need:
        raise ValueError(
            f"audio too short: need {need} samples for {n_segments} segments "
            f"(have {audio.shape[0]}); pad before calling"
        )
    return weights, n_frames


def frame_filterbank_logpower_plain(audio, weights, *, n_segments: int, step: int,
                                    sample_count: int, hop: int, eps: float = 1e-6,
                                    scale: float = 1.0 / 32768.0) -> torch.Tensor:
    """Plain PyTorch version of :func:`frame_filterbank_logpower`: ``unfold``
    framing and a float32 matmul, TF32 off (process-wide, as the importer
    sets it)."""
    audio, weights = torch.as_tensor(audio), torch.as_tensor(weights)
    weights, n_frames = _frame_geometry(audio, weights, n_segments, step,
                                        sample_count, hop)
    torch.backends.cuda.matmul.allow_tf32 = False
    kernel_size = weights.shape[1]
    span = (n_frames - 1) * hop + kernel_size
    x = audio[:max(0, (n_segments - 1) * step) + span].float() * scale
    frames = x.unfold(0, span, step)[:n_segments].unfold(1, kernel_size, hop)
    y = torch.matmul(frames, weights.to(audio.device).t())  # [n, T, F]
    return torch.log(y * y + eps)


def frame_filterbank_logpower(audio, weights, *, n_segments: int, step: int,
                              sample_count: int, hop: int, eps: float = 1e-6,
                              scale: float = 1.0 / 32768.0) -> torch.Tensor:
    """Fused frontend over ``n_segments`` overlapping windows of ``audio``.

    ``audio``: 1-D float32 or int16; ``scale`` is applied to EVERY input
    dtype (the default dequantizes int16; pass ``scale=1.0`` for audio
    already in [-1, 1)). ``weights``: ``[F, K]`` or the Conv1d layout
    ``[F, 1, K]``. Returns float32 ``[n_segments, T, F]`` log-power, where
    ``T = (sample_count - K) // hop + 1``."""
    audio, weights = torch.as_tensor(audio), torch.as_tensor(weights)
    if audio.device.type == "cpu":
        return frame_filterbank_logpower_plain(
            audio, weights, n_segments=n_segments, step=step,
            sample_count=sample_count, hop=hop, eps=eps, scale=scale)
    weights, n_frames = _frame_geometry(audio, weights, n_segments, step,
                                        sample_count, hop)
    if audio.device.type != "cuda":
        raise ValueError(f"frontend kernels run on CUDA tensors, got {audio.device}")
    audio = audio.contiguous()
    wt = weights.to(audio.device).t().contiguous()  # [K, F]
    n_filters, kernel_size = weights.shape
    out = torch.empty((n_segments, n_frames, n_filters), dtype=torch.float32,
                      device=audio.device)
    if n_segments == 0:
        return out
    lib = load_library()
    status = lib.bn_frame_filterbank_logpower(
        _AUDIO_CODES[audio.dtype], audio.data_ptr(), wt.data_ptr(), out.data_ptr(),
        n_segments, audio.shape[0], step, kernel_size, hop, n_filters, n_frames,
        float(eps), float(scale), torch.cuda.current_stream(audio.device).cuda_stream,
    )
    check(status, "frame_filterbank_logpower kernel")
    LAUNCHES["frame_filterbank_logpower"] += 1
    return out


# ---------------------------------------------------------------------------
# f64 numpy oracles
# ---------------------------------------------------------------------------


def stft_melspec_reference(segments, window, mel, *, hop: int,
                           eps: float = 1e-6) -> np.ndarray:
    """f64 oracle for :func:`segments_stft_melspec` (the JAX package's
    ``stft_melspec_reference``)."""
    segments = np.asarray(segments, np.float64)
    window = np.asarray(window, np.float64).reshape(-1)
    mel = np.asarray(mel, np.float64)
    flen = window.shape[0]
    n, sample_count = segments.shape
    n_frames = (sample_count - flen) // hop + 1
    out = np.empty((n, mel.shape[1], n_frames), np.float64)
    for i in range(n):
        frames = np.stack(
            [segments[i, j * hop: j * hop + flen] for j in range(n_frames)]
        )
        spec = np.fft.rfft(frames * window[None, :], axis=-1)
        power = spec.real**2 + spec.imag**2  # [T, bins]
        out[i] = np.log(power @ mel + eps).T
    return out.astype(np.float32)


def filterbank_logpower_reference(segments, weights, *, hop: int,
                                  eps: float = 1e-6) -> np.ndarray:
    """f64 oracle for :func:`segments_filterbank_logpower` (the JAX
    package's ``frontend_reference`` over pre-sliced segments)."""
    segments = np.asarray(segments, np.float64)
    weights = np.asarray(weights, np.float64)
    weights = weights.reshape(weights.shape[0], -1)
    kernel_size = weights.shape[1]
    n, sample_count = segments.shape
    n_frames = (sample_count - kernel_size) // hop + 1
    out = np.empty((n, weights.shape[0], n_frames), np.float64)
    for i in range(n):
        patches = np.stack(
            [segments[i, j * hop: j * hop + kernel_size] for j in range(n_frames)]
        )
        fb = patches @ weights.T
        out[i] = np.log(fb * fb + eps).T
    return out.astype(np.float32)
