"""WAV reading + overlapped segment chunking.

WAV path mirrors the reference CLI's validation (reference:
src/bin/birdnet-analyze.rs:653-704): mono, 16-bit, integer PCM only;
samples are ``i16 / 32768`` → float32. Decoding uses the native C++ helper
(native/wavio.cpp via ctypes) when built, else a pure-numpy RIFF parser with
identical semantics.

Chunking mirrors birdnet-analyze.rs:707-743: step = segment − overlap,
zero-padded final chunk, per-segment start times — but returns a dense
``[N, S]`` float32 matrix, the TPU-friendly shape the batch engine consumes
directly.
"""

from __future__ import annotations

import ctypes
import os
import struct
from typing import Tuple

import numpy as np

from ..errors import AudioFormatError, AudioReadError

# ---------------------------------------------------------------------------
# Native loader
# ---------------------------------------------------------------------------

_NATIVE_ERRORS = {
    1: ("read", "cannot open file"),
    2: ("read", "not a RIFF/WAVE file"),
    3: ("read", "missing fmt chunk"),
    4: ("read", "missing data chunk"),
    5: ("read", "data shorter than declared"),
    6: ("format", "expected 16-bit integer PCM samples"),
    7: ("format", "expected mono audio, got multiple channels"),
    8: ("format", "expected 16-bit samples"),
}


class _WavInfo(ctypes.Structure):
    _fields_ = [
        ("sample_rate", ctypes.c_int32),
        ("channels", ctypes.c_int32),
        ("bits_per_sample", ctypes.c_int32),
        ("format", ctypes.c_int32),
        ("n_samples", ctypes.c_int64),
        ("data_offset", ctypes.c_int64),
    ]


def _maybe_build_native(lib_path: str) -> None:
    """Build (or rebuild) libwavio.so from source when it is missing or
    older than wavio.cpp. The binary is a build output, not a tracked file —
    loading a stale .so after a source edit would silently run old code."""
    pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    src = os.path.join(pkg_root, "native", "wavio.cpp")
    if not os.path.exists(src):
        return
    if os.path.exists(lib_path) and os.path.getmtime(lib_path) >= os.path.getmtime(src):
        return
    import shutil
    import subprocess

    cxx = shutil.which("g++") or shutil.which("c++") or shutil.which("clang++")
    if cxx is None:
        return
    os.makedirs(os.path.dirname(lib_path), exist_ok=True)
    try:
        subprocess.run(
            [cxx, "-O3", "-shared", "-fPIC", "-std=c++17", "-o", lib_path, src],
            check=True,
            capture_output=True,
            timeout=120,
        )
    except Exception:
        pass  # fall back to the pure-Python decoder


def _load_native():
    path = os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "_native",
        "libwavio.so",
    )
    try:
        _maybe_build_native(path)
    except Exception:
        pass
    if not os.path.exists(path):
        return None
    try:
        lib = ctypes.CDLL(path)
        lib.wav_info.argtypes = [ctypes.c_char_p, ctypes.POINTER(_WavInfo)]
        lib.wav_info.restype = ctypes.c_int
        lib.wav_read_f32.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_int64,
        ]
        lib.wav_read_f32.restype = ctypes.c_int
        lib.wav_read_i16.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_int16),
            ctypes.c_int64,
        ]
        lib.wav_read_i16.restype = ctypes.c_int
        lib.wav_read_f32_downmix.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_int64,
        ]
        lib.wav_read_f32_downmix.restype = ctypes.c_int
        return lib
    except OSError:
        return None


_native = _load_native()


def native_available() -> bool:
    return _native is not None


def _raise_native(path: str, code: int) -> None:
    kind, reason = _NATIVE_ERRORS.get(code, ("read", f"error code {code}"))
    if kind == "format":
        raise AudioFormatError(reason)
    raise AudioReadError(path=path, reason=reason)


# ---------------------------------------------------------------------------
# Pure-Python fallback (same validation + errors)
# ---------------------------------------------------------------------------


def _read_wav_python(path: str, downmix: bool = False) -> Tuple[np.ndarray, int]:
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError as e:
        raise AudioReadError(path=path, reason=str(e)) from e

    if len(data) < 12 or data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise AudioReadError(path=path, reason="not a RIFF/WAVE file")

    pos = 12
    fmt = None
    while pos + 8 <= len(data):
        cid = data[pos:pos + 4]
        (size,) = struct.unpack_from("<I", data, pos + 4)
        body = pos + 8
        if cid == b"fmt ":
            if size < 16:
                raise AudioReadError(path=path, reason="missing fmt chunk")
            if len(data) < body + 16:
                # Declared size runs past the file: truncated mid-chunk.
                raise AudioReadError(path=path, reason="truncated fmt chunk")
            audio_format, channels, rate = struct.unpack_from("<HHI", data, body)
            bits = struct.unpack_from("<H", data, body + 14)[0]
            if audio_format == 0xFFFE and size >= 40:
                # WAVE_FORMAT_EXTENSIBLE: real format is the first 2 bytes
                # of the SubFormat GUID (fmt body offset 24).
                if len(data) < body + 26:
                    raise AudioReadError(
                        path=path, reason="truncated extensible fmt chunk"
                    )
                audio_format = struct.unpack_from("<H", data, body + 24)[0]
            fmt = (audio_format, channels, rate, bits)
        elif cid == b"data":
            if fmt is None:
                raise AudioReadError(path=path, reason="missing fmt chunk")
            audio_format, channels, rate, bits = fmt
            if audio_format != 1:
                raise AudioFormatError("expected 16-bit integer PCM samples")
            if channels != 1 and not downmix:
                raise AudioFormatError("expected mono audio, got multiple channels")
            if bits != 16:
                raise AudioFormatError("expected 16-bit samples")
            raw = data[body:body + size]
            if len(raw) < size:
                # native decoder parity (wavio.cpp WAV_ERR_TRUNCATED): a
                # declared-but-missing payload is a corrupt file, not a
                # short read — and an odd byte count would otherwise
                # surface as a raw numpy ValueError.
                raise AudioReadError(
                    path=path, reason="data shorter than declared"
                )
            if len(raw) % 2:
                # whole samples only (native: n_samples = size / frame_bytes)
                raw = raw[:-1]
            samples = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
            if channels != 1:
                n_frames = samples.shape[0] // channels
                samples = samples[: n_frames * channels].reshape(
                    n_frames, channels
                ).mean(axis=1)
            return samples, rate
        pos = body + size + (size & 1)
    raise AudioReadError(path=path, reason="missing data chunk")


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------


def read_wav(path, dtype="float32", downmix: bool = False) -> Tuple[np.ndarray, int, float]:
    """Read a 16-bit PCM WAV file (mono; or multichannel with ``downmix``).

    Returns ``(samples, sample_rate, duration_seconds)``. ``dtype``:
    ``float32`` (samples scaled to [-1, 1)) or ``int16`` (raw PCM — half the
    bytes; the streaming engine scales on-device). ``downmix`` averages
    multichannel audio to mono (always float32 output; the reference rejects
    stereo, birdnet-analyze.rs:662-681 — this is an extension).
    Raises :class:`AudioFormatError` for unsupported formats,
    :class:`AudioReadError` for missing or corrupt files.
    """
    path = str(path)
    if downmix and _native is not None:
        info = _WavInfo()
        rc = _native.wav_info(path.encode(), ctypes.byref(info))
        if rc != 0:
            _raise_native(path, rc)
        if info.channels > 1:
            if info.format != 1:
                raise AudioFormatError("expected 16-bit integer PCM samples")
            if info.bits_per_sample != 16:
                raise AudioFormatError("expected 16-bit samples")
            out = np.empty(info.n_samples, dtype=np.float32)
            rc = _native.wav_read_f32_downmix(
                path.encode(),
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                info.n_samples,
            )
            if rc != 0:
                _raise_native(path, rc)
            rate = int(info.sample_rate)
            return out, rate, len(out) / rate if rate else 0.0
        downmix = False  # mono: take the normal (int16-capable) path
    elif downmix:
        samples, rate = _read_wav_python(path, downmix=True)
        return samples, rate, len(samples) / rate if rate else 0.0
    want_i16 = np.dtype(dtype) == np.int16
    if _native is not None:
        info = _WavInfo()
        rc = _native.wav_info(path.encode(), ctypes.byref(info))
        if rc != 0:
            _raise_native(path, rc)
        if info.format != 1:
            raise AudioFormatError("expected 16-bit integer PCM samples")
        if info.channels != 1:
            raise AudioFormatError("expected mono audio, got multiple channels")
        if info.bits_per_sample != 16:
            raise AudioFormatError("expected 16-bit samples")
        if want_i16:
            out = np.empty(info.n_samples, dtype=np.int16)
            rc = _native.wav_read_i16(
                path.encode(),
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
                info.n_samples,
            )
        else:
            out = np.empty(info.n_samples, dtype=np.float32)
            rc = _native.wav_read_f32(
                path.encode(),
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                info.n_samples,
            )
        if rc != 0:
            _raise_native(path, rc)
        samples, rate = out, int(info.sample_rate)
    else:
        samples, rate = _read_wav_python(path)
        if want_i16:
            samples = np.clip(samples * 32768.0, -32768, 32767).astype(np.int16)
    duration = len(samples) / rate if rate else 0.0
    return samples, rate, duration


def write_wav(path, samples: np.ndarray, sample_rate: int) -> None:
    """Write a mono 16-bit PCM WAV file (test/bench helper)."""
    pcm = np.clip(np.asarray(samples, dtype=np.float32), -1.0, 1.0 - 1 / 32768)
    pcm = (pcm * 32768.0).astype("<i2")
    data = pcm.tobytes()
    with open(str(path), "wb") as f:
        f.write(b"RIFF")
        f.write(struct.pack("<I", 36 + len(data)))
        f.write(b"WAVE")
        f.write(b"fmt ")
        f.write(struct.pack("<IHHIIHH", 16, 1, 1, sample_rate, sample_rate * 2, 2, 16))
        f.write(b"data")
        f.write(struct.pack("<I", len(data)))
        f.write(data)


def chunk_audio(
    samples: np.ndarray,
    sample_count: int,
    overlap_seconds: float,
    sample_rate: int,
) -> Tuple[np.ndarray, np.ndarray]:
    """Split audio into overlapping segments (reference:
    birdnet-analyze.rs:707-743).

    Returns ``(segments [N, sample_count] float32, start_times [N] float64)``.
    The final partial segment is zero-padded. ``step = sample_count −
    overlap·rate``; overlap must be smaller than the segment duration.
    """
    samples = np.asarray(samples, dtype=np.float32).reshape(-1)
    if overlap_seconds < 0:
        # A negative overlap would make step > sample_count, leaving the
        # padded buffer shorter than the input (raw broadcast crash).
        raise AudioFormatError("overlap must not be negative")
    overlap_samples = int(overlap_seconds * sample_rate)
    step = sample_count - overlap_samples
    if step <= 0:
        raise AudioFormatError(
            "overlap must be smaller than the segment duration"
        )
    n_total = samples.shape[0]
    if n_total == 0:
        return np.zeros((0, sample_count), np.float32), np.zeros(0)

    # One segment per step-start position below n_total (reference loop:
    # ``while pos < samples.len()``, birdnet-analyze.rs:727).
    n_segments = -(-n_total // step)
    # Zero-padded flat buffer so strided view covers the tail.
    padded_len = (n_segments - 1) * step + sample_count
    padded = np.zeros(padded_len, dtype=np.float32)
    padded[:n_total] = samples

    stride = padded.strides[0]
    view = np.lib.stride_tricks.as_strided(
        padded, shape=(n_segments, sample_count), strides=(step * stride, stride)
    )
    segments = np.ascontiguousarray(view)
    start_times = np.arange(n_segments, dtype=np.float64) * (step / sample_rate)
    return segments, start_times
