"""Fused int8 1x1 convolution + requantize (B3): the CUDA kernel and its
plain version.

The kernel, ``qconv1x1_requant_kernel`` in ``birdnet_tpu_torch/csrc/qconv.cu``,
replaces the Pallas kernel
``birdnet_tpu/ops/pallas/qconv.py::qconv1x1_requant``. Per image it computes

    acc = w [C_out, C_in] @ x [C_in, N]          int8 x int8, int32 sums
    v   = float32(acc + bias) * scale            scale = x_s * w_s per channel
    y   = saturate_int8(round_half_even(act(v) / y_scale))

bit for bit as the unfused ``QLinearConv`` lowering: the activation runs on
the dequantized value, and the output scale divides (a multiply by its
float32 reciprocal flips round-half-even ties). The TPU kernel takes only
spatial sizes that are multiples of 128, its lane tiling; this one takes
every ``N >= 1``.

The kernel runs the product on the tensor cores (``wgmma`` s8 with s32
sums) with all positions of the batch as one GEMM dimension and ``w`` as
its B operand, packed once per weight tensor (:func:`pack_weights`: zero
padding to 32-channel chunks and to the kernel's column tiles, then the
core-matrix order ``wgmma`` reads) and cached while the tensor lives and
is not modified in place.

A wrapper dispatches on the tensor's device: a CPU tensor takes the plain
PyTorch version (:func:`qconv1x1_requant_plain`), a CUDA tensor launches the
kernel (building it on first use) or raises. ``LAUNCHES`` counts kernel
launches.
"""

from __future__ import annotations

import threading
import weakref
from typing import Optional, Tuple

import torch

from .build import check, count_launch, load_library
from .frontend import core_matrix_order

LAUNCHES = {"qconv1x1_requant": 0}

# Activations foldable into the requantize epilogue, on the dequantized
# float32 value. silu is v * sigmoid(v), as the JAX package writes it (not
# F.silu, which divides); the kernel's codes follow the same order.
EPILOGUE_ACTS = {
    "": lambda v: v,
    "relu": lambda v: torch.clamp_min(v, 0.0),
    "sigmoid": torch.sigmoid,
    "silu": lambda v: v * torch.sigmoid(v),
    "tanh": torch.tanh,
}
_ACT_CODES = {"": 0, "relu": 1, "sigmoid": 2, "silu": 3, "tanh": 4}

# The kernel's tiling, which the packed weights follow (csrc/qconv.cu): the
# input channels stream in chunks of K_CHUNK; a CTA covers one column tile
# of one of COL_TILES output channels.
K_CHUNK = 32
COL_TILES = (16, 32, 48, 64)


def reset_launches() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def _check(x: torch.Tensor, w: torch.Tensor, bias_i32: Optional[torch.Tensor],
           scale: torch.Tensor, act: str) -> None:
    if x.ndim != 3 or x.dtype != torch.int8:
        raise ValueError(f"x must be int8 [B, C_in, N], got {x.dtype} {tuple(x.shape)}")
    if w.ndim != 2 or w.dtype != torch.int8 or w.shape[1] != x.shape[1]:
        raise ValueError(
            f"w must be int8 [C_out, {x.shape[1]}], got {w.dtype} {tuple(w.shape)}"
        )
    c_out = w.shape[0]
    if bias_i32 is not None and (bias_i32.dtype != torch.int32
                                 or tuple(bias_i32.shape) != (c_out,)):
        raise ValueError(
            f"bias must be int32 [{c_out}], got {bias_i32.dtype} {tuple(bias_i32.shape)}"
        )
    if scale.dtype != torch.float32 or tuple(scale.shape) != (c_out,):
        raise ValueError(
            f"scale must be float32 [{c_out}], got {scale.dtype} {tuple(scale.shape)}"
        )
    if act not in EPILOGUE_ACTS:
        raise ValueError(f"unknown epilogue activation {act!r}")


def qconv1x1_requant_plain(x: torch.Tensor, w: torch.Tensor,
                           bias_i32: Optional[torch.Tensor], scale: torch.Tensor,
                           y_scale: float, act: str = "") -> torch.Tensor:
    """Plain PyTorch version of :func:`qconv1x1_requant`: the int32
    accumulator from a float64 matmul (exact while C_in * 127 * 128 < 2^53),
    then the same float32 epilogue."""
    _check(x, w, bias_i32, scale, act)
    acc = torch.matmul(w.double(), x.double()).to(torch.int32)  # [B, C_out, N]
    if bias_i32 is not None:
        acc = acc + bias_i32.reshape(1, -1, 1)
    v = EPILOGUE_ACTS[act](acc.float() * scale.reshape(1, -1, 1))
    # A divisor on the tensor's device: CUDA's true division turns a host
    # scalar divisor into a multiply by its reciprocal.
    divisor = torch.full((1,), float(y_scale), dtype=torch.float32, device=v.device)
    return torch.round(v / divisor).clamp(-128, 127).to(torch.int8)


def col_tiles(c_out: int) -> Tuple[int, int]:
    """``(tiles, cols)``: the kernel covers ``c_out`` output channels in
    ``tiles`` CTA column tiles of ``cols`` each, the narrowest of
    :data:`COL_TILES` that holds an even share (the padding columns are zero
    and never stored)."""
    tiles = -(-c_out // COL_TILES[-1])
    per = -(-c_out // tiles)
    return tiles, next(c for c in COL_TILES if c >= per)


def pack_weights(w: torch.Tensor) -> torch.Tensor:
    """B3's B operand: int8 ``w [C_out, C_in]`` as ``[tiles, ceil(C_in/32),
    cols/8, 2, 8, 16]``: per column tile (see :func:`col_tiles`) and
    32-channel chunk, ``cols`` rows of 32 channels in :func:`core_matrix_order`
    (core matrices of 8 rows x 16 channels), each chunk one contiguous copy;
    channels and rows zero-padded. Same device as ``w``."""
    c_out, c_in = w.shape
    tiles, cols = col_tiles(c_out)
    k = -(-c_in // K_CHUNK) * K_CHUNK
    padded = w.new_zeros((tiles * cols, k))
    padded[:c_out, :c_in] = w
    chunks = padded.reshape(tiles, cols, k // K_CHUNK, K_CHUNK).permute(0, 2, 1, 3)
    return core_matrix_order(chunks, 16).contiguous()


# Packed weights, most recent last: (key, pack). The key names the tensor
# whose storage holds w (w itself, or the base of the view the lowering
# passes) by identity and version counter, with the view's geometry; an
# inference tensor has no version counter, so it is packed on every call.
# Room for every 1x1 conv of a few int8 models. Locked, as the frontend's
# operand cache is: several host threads may pack at once.
_PACKS: list = []
_PACKS_KEPT = 256
_PACKS_LOCK = threading.Lock()


def _packed_weights(w: torch.Tensor) -> torch.Tensor:
    if w.is_inference():
        return pack_weights(w)
    from .build import hold

    root = w if w._base is None else w._base
    key = (root._version, w.storage_offset(), tuple(w.shape), tuple(w.stride()))
    with _PACKS_LOCK:
        for (ref, k), pack in reversed(_PACKS):
            if ref() is root and k == key:
                return hold(pack)
        pack = pack_weights(w)
        _PACKS.append(((weakref.ref(root), key), pack))
        del _PACKS[:-_PACKS_KEPT]
        return hold(pack)


def qconv1x1_requant(x: torch.Tensor, w: torch.Tensor,
                     bias_i32: Optional[torch.Tensor], scale: torch.Tensor,
                     y_scale: float, act: str = "") -> torch.Tensor:
    """Fused quantized 1x1 conv: ``x`` int8 ``[B, C_in, N]`` (N the flattened
    spatial size), ``w`` int8 ``[C_out, C_in]``, ``bias_i32`` int32
    ``[C_out]`` at scale ``x_s * w_s`` (or None), ``scale`` float32
    ``[C_out]`` = ``x_s * w_s``, ``y_scale`` the output scale, ``act`` one
    of ``""``, relu, sigmoid, silu, tanh. Returns int8 ``[B, C_out, N]``."""
    _check(x, w, bias_i32, scale, act)
    if x.device.type == "cpu":
        return qconv1x1_requant_plain(x, w, bias_i32, scale, y_scale, act)
    if x.device.type != "cuda":
        raise ValueError(f"qconv1x1_requant runs on CUDA or CPU tensors, got {x.device}")
    for t in (w, bias_i32, scale):
        if t is None:
            continue
        if t.device != x.device:
            raise ValueError(f"tensor on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError("qconv1x1_requant takes contiguous tensors")
    if not x.is_contiguous():
        raise ValueError("qconv1x1_requant takes contiguous tensors")
    n_img, c_in, n = x.shape
    c_out = w.shape[0]
    out = torch.empty((n_img, c_out, n), dtype=torch.int8, device=x.device)
    if out.numel() == 0:
        return out
    wpack = _packed_weights(w)
    lib = load_library()
    # A kernel launches on the current device: make it the tensors'.
    with torch.cuda.device(x.device):
        status = lib.bn_qconv1x1_requant(
            x.data_ptr(), wpack.data_ptr(),
            None if bias_i32 is None else bias_i32.data_ptr(),
            scale.data_ptr(), out.data_ptr(), n_img, c_in, c_out, n,
            8 * wpack.shape[2], wpack.shape[0], float(y_scale), _ACT_CODES[act],
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    check(status, "qconv1x1_requant kernel")
    count_launch(LAUNCHES, "qconv1x1_requant")
    return out
