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
  the samples scaled in the kernel, float32-accurate throughout, returning
  ``[n, T, F]``: the JAX package's public function of that name, with its
  signature. Replaces
  ``birdnet_tpu/ops/pallas/frontend.py::frame_filterbank_logpower``; any
  step (the TPU's ``hop % 128`` rule is a Mosaic rule). Its product runs
  on the tensor cores in split TF32 (:func:`split_tf32`: each operand is
  ``big + small``, the sum ``big·big + big·small + small·big``), the
  JAX kernel's ``Precision.HIGHEST`` on this card; the filterbank is packed
  once per device (:func:`pack_filterbank_tf32`). Hops up to
  :func:`frame_max_hop` (2165 for float32 and 4398 for int16 samples at
  1024 taps and 96 filters), ``ValueError`` above.

B1 and B2 take segments ``[N, S]`` in the compute dtype (float32 or bfloat16) and
return ``[N, F|M, T]`` in that dtype, the mel-image orientation. They keep
the TPU kernels' rounding points: the samples times ``scale`` (in float32,
skipped at 1) and the weights are in the compute dtype, products accumulate
in float32, B1's power is rounded to
the compute dtype before the mel product, and the log is taken in float32.
In bfloat16 (the ``fast``/``bf16`` main path) they run on the tensor cores
(``wgmma``), with their B operands packed on the host into the layout the
MMA reads (:func:`pack_filterbank`, :func:`pack_stft_operands`) and cached
per device; in float32 they keep SIMT f32 FMAs (the TPU's
``Precision.HIGHEST``: exact f32 products, no TF32). The bf16 kernels take
hops up to :func:`bf16_max_hop` (1209 for B1 and 1437 for B2 at 1024 taps
and 96 mels or filters: the samples of 64 frames must fit in shared memory)
and raise ``ValueError`` above; a ``fast``/``bf16`` Classifier on such a
model fails in ``build()``'s validation forward.

A wrapper dispatches on the tensor's device: a CPU tensor takes the plain
PyTorch version (``*_plain``), a CUDA tensor launches the kernel (building
it on first use) or raises. ``LAUNCHES`` counts kernel launches.

The f64 numpy oracles (``*_reference``) are the JAX package's
``stft_melspec_reference`` and ``frontend_reference`` in segment form.
"""

from __future__ import annotations

import threading
import weakref
from typing import Tuple

import numpy as np
import torch

from .build import check, count_launch, load_library

LAUNCHES = {"filterbank_logpower": 0, "stft_melspec": 0,
            "frame_filterbank_logpower": 0}

_COMPUTE_DTYPES = (torch.float32, torch.bfloat16)

# The tensor-core kernels' tiling, which the packed operands follow: the B
# operand streams in chunks of MMA_TAPS taps; B1 takes the DFT MMA_BINS bins
# at a time (cos | sin side by side); a CTA covers at most MMA_MAX_COLS
# filters or mels, in a multiple of 32. They must equal csrc/frontend.cu's
# kMmaKc, kStftCols / 2 and its widest wgmma (m64n128, the largest `cols` its
# bf16 entry points take); change both files together.
MMA_TAPS = 64
MMA_BINS = 64
MMA_MAX_COLS = 128
# B5's B operand streams in chunks of TF32_TAPS taps (csrc/frontend.cu's
# kTf32Kc: 128 bytes of float32 per column, as MMA_TAPS bf16 taps).
TF32_TAPS = 32


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
    if segments.dtype not in _COMPUTE_DTYPES:
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


def _frames(segments: torch.Tensor, flen: int, hop: int, scale: float = 1.0) -> torch.Tensor:
    """[N, S] -> [N, T, flen] float32 frames of the samples times ``scale``
    (in float32), rounded to the compute dtype, which is the segments'
    dtype: the JAX kernels' ``seg * f32(scale)`` before the compute-type
    cast."""
    x = segments.float()
    if scale != 1.0:
        x = (x * scale).to(segments.dtype).float()
    return x.unfold(-1, flen, hop)


def bf16_max_hop(flen: int, n_cols: int, *, stft: bool) -> int:
    """The largest hop the bf16 kernel of B1 (``stft``) or B2 takes for
    ``flen`` taps and ``n_cols`` mels or filters. Builds the kernels."""
    return load_library().bn_frontend_bf16_max_hop(int(stft), flen, col_groups(n_cols)[1])


def _check_span(status: int, hop: int, flen: int, n_cols: int, stft: bool) -> None:
    """The bf16 kernels return -1, launching nothing, when the samples of 64
    frames do not fit in shared memory beside the B operand's ring."""
    if status == -1:
        raise ValueError(
            f"hop {hop}: the samples of 64 frames of {flen} taps do not fit in "
            f"shared memory (the bf16 {'STFT' if stft else 'filterbank'} kernel "
            f"takes hops up to {bf16_max_hop(flen, n_cols, stft=stft)} here)"
        )


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
                              *, hop: int, eps: float = 1e-6,
                              scale: float = 1.0) -> torch.Tensor:
    """Plain PyTorch version of :func:`segments_filterbank_logpower`."""
    _check_segments(segments)
    weights = _filterbank(weights)
    _n_frames(segments.shape[1], weights.shape[1], hop)
    frames = _frames(segments, weights.shape[1], hop, scale)
    w = weights.to(segments.dtype).float()
    y = torch.matmul(frames, w.t())  # [N, T, F] float32
    out = torch.log(y * y + eps)
    return out.to(segments.dtype).transpose(1, 2).contiguous()


def col_groups(n_cols: int) -> Tuple[int, int]:
    """``(groups, cols)``: the tensor-core kernels cover ``n_cols`` filters
    or mels in ``groups`` CTA column groups of ``cols`` each, a multiple of
    32 and at most 128 (the padding columns are zero and never stored)."""
    groups = -(-n_cols // MMA_MAX_COLS)
    per = -(-n_cols // groups)
    return groups, -(-per // 32) * 32


def core_matrix_order(a, per_row: int = 8):
    """``[..., cols, taps]`` (a chunk of ``cols`` columns, 128 bytes of taps
    each: 64 bf16 or 32 float32) as ``[..., cols/8, taps/per_row, 8,
    per_row]``: core matrices of 8 columns x 16 bytes (``per_row`` taps: 8
    bf16, 4 float32), 128 contiguous bytes, those of one 8-column group
    adjacent along the taps, the layout wgmma reads a K-major B operand in
    without swizzle. numpy arrays or tensors."""
    *lead, cols, taps = a.shape
    return a.reshape(*lead, cols // 8, 8, taps // per_row, per_row).swapaxes(-3, -2)


def pack_filterbank(weights: torch.Tensor) -> torch.Tensor:
    """B2's B operand: the filterbank ``[F, 1, K]`` or ``[F, K]`` as
    ``[groups, ceil(K/64), cols/8, 8, 8, 8]``: per column group (see
    :func:`col_groups`) and 64-tap chunk, ``cols`` filters x 64 taps in
    :func:`core_matrix_order`, each chunk one contiguous copy; taps and
    filters zero-padded. Same dtype and device as ``weights``."""
    weights = _filterbank(weights)
    n_filters, kernel_size = weights.shape
    groups, cols = col_groups(n_filters)
    taps = -(-kernel_size // MMA_TAPS) * MMA_TAPS
    padded = weights.new_zeros((groups * cols, taps))
    padded[:n_filters, :kernel_size] = weights
    chunks = padded.reshape(groups, cols, taps // MMA_TAPS, MMA_TAPS).permute(0, 2, 1, 3)
    return core_matrix_order(chunks).contiguous()


# The kernels' operands as built from the caller's (B1's bases, B2's packed
# filterbank), most recent last: (key, operands). A key names its source
# without reading the device: B1's host arrays (window, mel bank) by
# content, compared with np.array_equal, several times cheaper per call than
# hashing the mel bank's bytes; B2's filterbank, a device tensor, by
# identity and version counter. An inference tensor has no version counter,
# so its operand is built anew on every call. Locked: a server packs from
# its batcher workers and its streaming requests at once.
_OPERANDS: list = []
_OPERANDS_KEPT = 8
_OPERANDS_LOCK = threading.Lock()


def _cached(match, make):
    """The operands of the newest entry whose key ``match`` accepts; else
    ``make()``'s ``(key, operands)``, kept (and held by a graph being
    captured: ``build.hold``)."""
    from .build import hold

    with _OPERANDS_LOCK:
        for key, operands in reversed(_OPERANDS):
            if match(key):
                return hold(operands)
        key, operands = make()
        _OPERANDS.append((key, operands))
        del _OPERANDS[:-_OPERANDS_KEPT]
        return hold(operands)


def _packed_once(weights: torch.Tensor, name: str, pack) -> torch.Tensor:
    """``pack(weights)``, cached under ``name`` while ``weights`` lives and
    is not modified in place (a model's filterbank is packed once)."""
    if weights.is_inference():
        return pack(weights)
    version = weights._version
    return _cached(
        lambda key: key[0] == name and key[1]() is weights and key[2] == version,
        lambda: ((name, weakref.ref(weights), version), pack(weights)),
    )


def _packed_filterbank(weights: torch.Tensor) -> torch.Tensor:
    """B2's operand: :func:`pack_filterbank` in bfloat16, packed once."""
    return _packed_once(weights, "filterbank",
                        lambda w: pack_filterbank(w.to(torch.bfloat16)))


def segments_filterbank_logpower(segments: torch.Tensor, weights: torch.Tensor,
                                 *, hop: int, eps: float = 1e-6,
                                 scale: float = 1.0) -> torch.Tensor:
    """Conv-form frontend over segments ``[N, S]``: returns ``[N, F, T]``
    ``log((frames @ Wᵀ)² + eps)`` in the segments' dtype, where ``weights``
    is the Conv1d filterbank ``[F, 1, K]`` or ``[F, K]`` and the frames hold
    the samples times ``scale`` (applied in the kernel)."""
    _check_segments(segments)
    if segments.device.type == "cpu":
        return filterbank_logpower_plain(segments, weights, hop=hop, eps=eps, scale=scale)
    n, sample_count = segments.shape
    n_filters, kernel_size = _filterbank(weights).shape
    n_frames = _n_frames(sample_count, kernel_size, hop)
    out = torch.empty((n, n_filters, n_frames), dtype=segments.dtype,
                      device=segments.device)
    lib = load_library()
    stream = torch.cuda.current_stream(segments.device).cuda_stream
    # A kernel launches on the current device: make it the tensors'.
    with torch.cuda.device(segments.device):
        if segments.dtype == torch.bfloat16:
            wpack = _packed_filterbank(weights)
            _launch_ready(segments, wpack)
            status = lib.bn_filterbank_logpower_bf16(
                segments.data_ptr(), wpack.data_ptr(), out.data_ptr(), n, sample_count,
                kernel_size, hop, n_filters, 8 * wpack.shape[2], wpack.shape[0], n_frames,
                float(eps), float(scale), stream,
            )
            _check_span(status, hop, kernel_size, n_filters, stft=False)
        else:
            wt = _filterbank(weights).float().t().contiguous()  # [K, F]
            _launch_ready(segments, wt)
            status = lib.bn_filterbank_logpower_f32(
                segments.data_ptr(), wt.data_ptr(), out.data_ptr(), n, sample_count,
                kernel_size, hop, n_filters, n_frames, float(eps), float(scale), stream,
            )
    check(status, "filterbank_logpower kernel")
    count_launch(LAUNCHES, "filterbank_logpower")
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


def pack_stft_operands(bc: np.ndarray, bs: np.ndarray, mel_used: np.ndarray
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """B1's B operands from :func:`stft_bases`' ``(bc, bs, mel_used)``, each
    chunk in :func:`core_matrix_order` and one contiguous copy:

    - ``bases [ceil(bins/64), ceil(K/64), 16, 8, 8, 8]``: for bin chunk j
      and tap chunk c, 128 columns of 64 taps: the cos columns of bins
      64j..64j+63, then the sin columns of the same bins;
    - ``mel [groups, ceil(bins/64), cols/8, 8, 8, 8]``: the mel rows of
      chunk j's 64 bins as ``cols`` mel columns of 64 bins (see
      :func:`col_groups`).

    Taps, bins and mels are zero-padded; float32, as given."""
    flen, bins = bc.shape
    n_mels = mel_used.shape[1]
    chunks = -(-bins // MMA_BINS)
    taps = -(-flen // MMA_TAPS) * MMA_TAPS
    cs = np.zeros((2, taps, chunks * MMA_BINS), np.float32)
    cs[0, :flen, :bins] = bc
    cs[1, :flen, :bins] = bs
    # [cos|sin, tap chunk, tap, bin chunk, bin] -> [bin chunk, tap chunk, cos|sin, bin, tap]
    bases = cs.reshape(2, taps // MMA_TAPS, MMA_TAPS, chunks, MMA_BINS).transpose(3, 1, 0, 4, 2)
    groups, cols = col_groups(n_mels)
    mp = np.zeros((chunks * MMA_BINS, groups * cols), np.float32)
    mp[:bins, :n_mels] = mel_used
    # [bin chunk, bin, group, mel] -> [group, bin chunk, mel, bin]
    melp = mp.reshape(chunks, MMA_BINS, groups, cols).transpose(2, 0, 3, 1)
    bases = bases.reshape(chunks, taps // MMA_TAPS, 2 * MMA_BINS, MMA_TAPS)
    return (np.ascontiguousarray(core_matrix_order(bases)),
            np.ascontiguousarray(core_matrix_order(melp)))


def _bases_for(window, mel, dtype, device, packed=False):
    """:func:`stft_bases` (or, ``packed``, :func:`pack_stft_operands`) in
    ``dtype`` on ``device``, cached by content."""
    window = np.asarray(window, np.float32).reshape(-1)
    mel = np.asarray(mel, np.float32)
    device = torch.device(device)

    def make():
        arrays = stft_bases(window, mel)
        if packed:
            arrays = pack_stft_operands(*arrays)
        operands = tuple(torch.from_numpy(a).to(device=device, dtype=dtype) for a in arrays)
        return ("stft", window.copy(), mel.copy(), dtype, device, packed), operands

    return _cached(
        lambda key: (key[0] == "stft" and key[3:] == (dtype, device, packed)
                     and np.array_equal(key[1], window) and np.array_equal(key[2], mel)),
        make,
    )


def stft_melspec_plain(segments: torch.Tensor, window, mel, *, hop: int,
                       eps: float = 1e-6, scale: float = 1.0) -> torch.Tensor:
    """Plain PyTorch version of :func:`segments_stft_melspec`."""
    _check_segments(segments)
    bc, bs, mel_used = (
        b.float() for b in _bases_for(window, mel, segments.dtype, segments.device)
    )
    _n_frames(segments.shape[1], bc.shape[0], hop)
    frames = _frames(segments, bc.shape[0], hop, scale)
    c = torch.matmul(frames, bc)
    s = torch.matmul(frames, bs)
    power = (c * c + s * s).to(segments.dtype).float()
    fb = torch.matmul(power, mel_used)  # [N, T, M] float32
    return torch.log(fb + eps).to(segments.dtype).transpose(1, 2).contiguous()


def segments_stft_melspec(segments: torch.Tensor, window, mel, *, hop: int,
                          eps: float = 1e-6, scale: float = 1.0) -> torch.Tensor:
    """STFT-form frontend over segments ``[N, S]``: framing at ``hop`` of
    the samples times ``scale`` (applied in the kernel), windowed DFT,
    power, mel projection and ``log(x + eps)``. ``window`` ``[flen]`` and
    ``mel`` ``[flen//2+1, M]`` are host arrays. Returns ``[N, M, T]`` in the
    segments' dtype."""
    _check_segments(segments)
    if segments.device.type == "cpu":
        return stft_melspec_plain(segments, window, mel, hop=hop, eps=eps, scale=scale)
    n, sample_count = segments.shape
    flen = int(np.asarray(window).size)
    n_mels = int(np.asarray(mel).shape[-1])
    n_frames = _n_frames(sample_count, flen, hop)
    out = torch.empty((n, n_mels, n_frames), dtype=segments.dtype,
                      device=segments.device)
    lib = load_library()
    stream = torch.cuda.current_stream(segments.device).cuda_stream
    # A kernel launches on the current device: make it the tensors'.
    with torch.cuda.device(segments.device):
        if segments.dtype == torch.bfloat16:
            bases, melp = _bases_for(window, mel, segments.dtype, segments.device, packed=True)
            _launch_ready(segments, bases, melp)
            status = lib.bn_stft_melspec_bf16(
                segments.data_ptr(), bases.data_ptr(), melp.data_ptr(), out.data_ptr(), n,
                sample_count, flen, hop, n_mels, bases.shape[0], 8 * melp.shape[2],
                melp.shape[0], n_frames, float(eps), float(scale), stream,
            )
            _check_span(status, hop, flen, n_mels, stft=True)
        else:
            bc, bs, mel_used = _bases_for(window, mel, segments.dtype, segments.device)
            _launch_ready(segments, bc, bs, mel_used)
            status = lib.bn_stft_melspec_f32(
                segments.data_ptr(), bc.data_ptr(), bs.data_ptr(), mel_used.data_ptr(),
                out.data_ptr(), n, sample_count, flen, hop, bc.shape[1], n_mels, n_frames,
                float(eps), float(scale), stream,
            )
    check(status, "stft_melspec kernel")
    count_launch(LAUNCHES, "stft_melspec")
    return out


# ---------------------------------------------------------------------------
# B5: the conv-form frontend over windows of one 1-D buffer
# ---------------------------------------------------------------------------

_AUDIO_CODES = {torch.float32: 0, torch.int16: 1}


def split_tf32(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(big, small)`` of a float32 tensor: ``big`` is ``x`` rounded to
    TF32 (10 mantissa bits, round to nearest with ties away from zero, as
    ``cvt.rna.tf32.f32``), ``small`` is ``x - big`` rounded the same way. The
    kernel splits its A operand so in registers; its B operand is split here.
    ``big + small`` is ``x`` to about 2^-22 relative, and exactly for values
    of at most 22 significant bits (int16 samples scaled by a power of 2)."""
    def rna(v):
        bits = v.contiguous().view(torch.int32)
        return ((bits + 0x1000) & -0x2000).view(torch.float32)

    x = x.float()
    big = rna(x)
    return big, rna(x - big)


def pack_filterbank_tf32(weights: torch.Tensor) -> torch.Tensor:
    """B5's B operand: the filterbank ``[F, 1, K]`` or ``[F, K]`` split by
    :func:`split_tf32` as ``[groups, ceil(K/32), 2, cols/8, 8, 8, 4]``
    float32: per column group (see :func:`col_groups`) and 32-tap chunk,
    ``w_big`` then ``w_small``, each ``cols`` filters x 32 taps in
    :func:`core_matrix_order`, each chunk one contiguous copy; taps and
    filters zero-padded. Same device as ``weights``."""
    weights = _filterbank(weights).float()
    n_filters, kernel_size = weights.shape
    groups, cols = col_groups(n_filters)
    taps = -(-kernel_size // TF32_TAPS) * TF32_TAPS
    padded = weights.new_zeros((groups * cols, taps))
    padded[:n_filters, :kernel_size] = weights
    parts = torch.stack(split_tf32(padded))  # [2, groups * cols, taps]
    chunks = parts.reshape(2, groups, cols, taps // TF32_TAPS, TF32_TAPS).permute(1, 3, 0, 2, 4)
    return core_matrix_order(chunks, 4).contiguous()


def _packed_filterbank_tf32(weights: torch.Tensor) -> torch.Tensor:
    """B5's operand: :func:`pack_filterbank_tf32`, packed once."""
    return _packed_once(weights, "filterbank_tf32", pack_filterbank_tf32)


def frame_max_hop(kernel_size: int, n_filters: int, audio_dtype=torch.int16) -> int:
    """The largest hop B5's kernel takes for ``kernel_size`` taps,
    ``n_filters`` filters and samples of ``audio_dtype`` (int16 or float32):
    the samples of 16 frames must fit in shared memory beside the B ring.
    Builds the kernels."""
    return load_library().bn_frame_filterbank_max_hop(
        _AUDIO_CODES[audio_dtype], kernel_size, col_groups(n_filters)[1])


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
    w, n_frames = _frame_geometry(audio, weights, n_segments, step, sample_count, hop)
    if audio.device.type != "cuda":
        raise ValueError(f"frontend kernels run on CUDA tensors, got {audio.device}")
    if weights.device != audio.device:
        raise ValueError(f"weights on {weights.device}, audio on {audio.device}")
    audio = audio.contiguous()
    n_filters, kernel_size = w.shape
    out = torch.empty((n_segments, n_frames, n_filters), dtype=torch.float32,
                      device=audio.device)
    if n_segments == 0:
        return out
    wpack = _packed_filterbank_tf32(weights)
    lib = load_library()
    with torch.cuda.device(audio.device):
        status = lib.bn_frame_filterbank_logpower(
            _AUDIO_CODES[audio.dtype], audio.data_ptr(), wpack.data_ptr(), out.data_ptr(),
            n_segments, audio.shape[0], step, kernel_size, hop, n_filters, 8 * wpack.shape[3],
            wpack.shape[0], n_frames, float(eps), float(scale),
            torch.cuda.current_stream(audio.device).cuda_stream,
        )
    if status == -1:
        raise ValueError(
            f"hop {hop}: the samples of 16 frames of {kernel_size} taps do not fit "
            f"in shared memory (B5's kernel takes hops up to "
            f"{frame_max_hop(kernel_size, n_filters, audio.dtype)} for "
            f"{audio.dtype} samples here)"
        )
    check(status, "frame_filterbank_logpower kernel")
    count_launch(LAUNCHES, "frame_filterbank_logpower")
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
