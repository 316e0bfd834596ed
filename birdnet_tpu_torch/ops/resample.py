"""Device-side polyphase audio resampling.

The counterpart of :mod:`birdnet_tpu.ops.resample`: rational L/M
resampling with the Kaiser-windowed sinc that ``scipy.signal.resample_poly``
designs, within float tolerance of it.

The JAX package runs it as one ``lax.conv_general_dilated`` whose
``lhs_dilation=L`` zero-stuffs the input. Here the zero-stuffed conv is
computed without materialising the zeros (an hour of 44.1 kHz audio
stuffed by L = 160 would be 25 G samples): output ``j = L*m + r`` only
ever meets the filter taps ``w[i*L + half - r*M]``, so the L phases ``r``
are the L output channels of ONE strided ``F.conv1d`` over the raw
samples, interleaved afterwards. The same products are summed; only the
zero terms are skipped.
"""

from __future__ import annotations

import functools
from fractions import Fraction
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..runtime import device_or_default


def design_kaiser_sinc(L: int, M: int, beta: float = 5.0, window_mult: int = 10) -> np.ndarray:
    """Windowed-sinc low-pass for rational L/M resampling (the filter
    ``scipy.signal.resample_poly`` designs by default)."""
    max_rate = max(L, M)
    f_c = 1.0 / max_rate  # cutoff in normalized (Nyquist=1) units
    half_len = window_mult * max_rate
    n = np.arange(-half_len, half_len + 1, dtype=np.float64)
    sinc = np.sinc(n * f_c) * f_c
    window = np.kaiser(2 * half_len + 1, beta)
    h = sinc * window
    h /= h.sum()  # unity DC gain (scipy firwin scale=True)
    return (h * L).astype(np.float64)


@functools.lru_cache(maxsize=16)
def _phase_filters(L: int, M: int) -> Tuple[np.ndarray, int]:
    """``(g [L, 1, taps] float32, i_min)``: phase ``r``'s taps over input
    offsets ``i_min .. i_min + taps - 1`` of the flipped filter ``w``,
    zero where ``i*L + half - r*M`` falls outside it."""
    w = design_kaiser_sinc(L, M)[::-1]
    taps_total = w.shape[0]
    half = (taps_total - 1) // 2
    c = half - np.arange(L) * M  # filter index of input offset 0, per phase
    i_min = int(np.min(-(c // L)))
    i_max = int(np.max((taps_total - 1 - c) // L))
    t = (np.arange(i_min, i_max + 1)[None, :] * L) + c[:, None]
    inside = (t >= 0) & (t < taps_total)
    g = np.where(inside, w[np.clip(t, 0, taps_total - 1)], 0.0)
    return g.astype(np.float32)[:, None, :], i_min


def resample_poly(
    samples,
    orig_rate: int,
    target_rate: int,
    dtype=torch.float32,
    device=None,
) -> torch.Tensor:
    """Resample 1-D audio from ``orig_rate`` to ``target_rate`` on
    ``device`` (default: a tensor's own device; for a host array
    ``cuda:0``, which raises :class:`RuntimeInitError` without CUDA, so a
    host run passes ``"cpu"``).

    Output length = ceil(len(samples) * L / M) for the reduced ratio L/M,
    matching scipy.signal.resample_poly. The conv runs in full float32:
    TF32 is turned off for cuDNN, process-wide, as the importer does.
    """
    if device is None:
        device = samples.device if isinstance(samples, torch.Tensor) else device_or_default()
    if not isinstance(samples, torch.Tensor):
        samples = torch.from_numpy(np.ascontiguousarray(samples))
    x = samples.to(device=device, dtype=dtype).reshape(-1)
    if orig_rate == target_rate:
        return x
    frac = Fraction(target_rate, orig_rate)
    L, M = frac.numerator, frac.denominator
    n_in = x.shape[0]
    n_out = -(-n_in * L // M)
    g, i_min = _phase_filters(L, M)
    taps = g.shape[2]
    m_out = -(-n_out // L)  # outputs per phase
    right = max(0, (m_out - 1) * M + taps + i_min - n_in)
    torch.backends.cudnn.allow_tf32 = False
    xp = F.pad(x.float().reshape(1, 1, -1), (-i_min, right))
    y = F.conv1d(xp, torch.from_numpy(g).to(x.device), stride=M)[0]  # [L, m]
    return y[:, :m_out].t().reshape(-1)[:n_out].to(dtype)


def resample_audio(
    samples: np.ndarray,
    orig_rate: int,
    target_rate: int,
    out_dtype=np.float32,
    device: Optional[torch.device] = None,
) -> np.ndarray:
    """Resample PCM audio (int16 or float32 in) to ``target_rate`` on
    ``device`` (default ``cuda:0``; without CUDA that raises
    :class:`RuntimeInitError`), returning host ``out_dtype`` (int16
    requantizes for the streaming engine's raw-PCM upload path)."""
    samples = np.asarray(samples)
    if samples.dtype == np.int16:
        f32 = samples.astype(np.float32) / 32768.0
    else:
        f32 = samples.astype(np.float32)
    y = resample_poly(f32, orig_rate, target_rate,
                      device=device_or_default(device)).cpu().numpy()
    if np.dtype(out_dtype) == np.int16:
        return np.clip(y * 32768.0, -32768, 32767).astype(np.int16)
    return y.astype(out_dtype)


def resample_host(samples: np.ndarray, orig_rate: int, target_rate: int) -> np.ndarray:
    """Host path using scipy (same algorithm)."""
    from scipy.signal import resample_poly as scipy_resample

    frac = Fraction(target_rate, orig_rate)
    return scipy_resample(
        np.asarray(samples, dtype=np.float64), frac.numerator, frac.denominator
    ).astype(np.float32)
