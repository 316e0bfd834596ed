"""The backbone's stage prefix (stem + leading MBConv blocks): a hand-written
CUDA kernel (B4) and its plain version.

Replaces the Pallas TPU megakernel
``birdnet_tpu/ops/pallas/stage123.py::stage_stack_forward``. It computes
the same function with the same rounding points (stage123.py:187-238):

- the stem (3x3 stride-2 conv, C_in = 1, + bias, silu) in float32, cast to
  the compute type;
- per block: the 1x1 expand with compute-type operands and float32 sums,
  + bias, silu, kept in float32 through the depthwise 3x3 (stride 1 or 2)
  + bias + silu; the squeeze-excite gate in float32 with an exact sigmoid;
  ``h3 = h2 * gate`` cast to the compute type; the 1x1 project with float32
  sums, + bias, + the residual upcast, cast to the compute type.

``fast_act`` is the approximate silu of the big epilogues (stem, expand,
depthwise): ``v * rcp(1 + exp(-v))``; the squeeze-excite stays exact.

The layout is NCHW in and out, not the TPU's polyphase planes: ``img``
``[N, 1, H, W]`` in the compute type (float32 or bfloat16) gives
``[N, c_last, H', W']``, every conv zero-padded by one pixel (a 96 x 511
mel image gives 48 x 256 after the stem, as the TPU kernel's one padding
column does). The kernel takes any channel counts and image size.

:func:`stage_stack_forward` dispatches on the image's device: a CPU tensor
takes :func:`stage_stack_forward_plain`, a CUDA tensor launches the kernel
(``birdnet_tpu_torch/csrc/stage_prefix.cu``, built at first use) or raises.
``LAUNCHES`` counts kernel launches. Weights go through
:func:`prepare_weights` once per device and compute type.

In bfloat16 (the ``fast``/``bf16`` lowerings) both 1x1 convs run on the
tensor cores (``mma.sync`` m16n8k16, bf16 operands, float32 sums) from bf16
shared memory; in float32 the kernel keeps f32 SIMT FMAs. The two have
their own tile plans (:func:`launch_plan`).
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F

from .build import check, load_library

LAUNCHES = {"stage_stack_forward": 0}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# Launch geometry shared with csrc/stage_prefix.cu: threads per block,
# the depthwise run length, and the shared memory a block may take (half of
# the SM's, so two blocks fit on one SM). The float32 SIMT kernels: channels
# staged per pass and the 1x1 convs' register tile (pixels x channels). The
# bfloat16 tensor-core kernels: warps per block; expanded channels per
# block of launch (a) and the chunks of them it may take at a time; the
# pixels (one 16-row MMA tile per warp), the channels per cp.async stage and
# the output channels of a block of launch (b).
_THREADS = 256
_RUN = 4
_SMEM_BUDGET = 110 * 1024
_CHUNK = 32
_PX, _CH = 4, 8
_WARPS = _THREADS // 32
_MMA_GROUPS = (64, 32)
_MMA_CHUNKS = (32, 16)
_PROJ_PX = 16 * _WARPS
_PROJ_KC = 32
_PROJ_COLS = 128


def reset_launches() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


@dataclass(frozen=True)
class BlockGeom:
    """One MBConv block's static configuration (stage123.py's BlockGeom)."""

    c_in: int
    c_mid: int
    c_se: int
    c_out: int
    stride: int       # 1 or 2 (applies to the depthwise conv)
    residual: bool


@dataclass(frozen=True)
class StagePrefixWeights:
    """The kernel's weight tables on one device: the stem taps ``[C, 9]``
    and bias in float32; per block ``(w1 [c_mid, c_in], b1, wd [c_mid, 9],
    bd, se1 [c_se, c_mid], bse1, se2 [c_mid, c_se], bse2, w3 [c_out,
    c_mid], b3)``, the two 1x1 matrices in the compute type ``dtype`` and
    everything else in float32."""

    blocks: Tuple[BlockGeom, ...]
    stem_w: torch.Tensor
    stem_b: torch.Tensor
    tables: Tuple[Tuple[torch.Tensor, ...], ...]
    dtype: torch.dtype


def prepare_weights(stem_w, stem_b, block_weights: Sequence[dict],
                    blocks: Sequence[BlockGeom], dtype: torch.dtype,
                    device) -> StagePrefixWeights:
    """Build the tables from the BN-folded ONNX weights (numpy or tensors;
    ``block_weights`` holds ``w1, b1, wd, bd, se1, bse1, se2, bse2, w3,
    b3`` per block, as the JAX function takes them)."""
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"compute type must be float32 or bfloat16, got {dtype}")
    if not blocks:
        raise ValueError("the stage prefix needs at least one block")
    device = torch.device(device)

    def f32(a, *shape):
        return torch.as_tensor(a).to(device=device, dtype=torch.float32).reshape(shape).contiguous()

    c_stem = int(torch.as_tensor(stem_w).shape[0])
    tables = []
    for g, bw in zip(blocks, block_weights):
        tables.append((
            f32(bw["w1"], g.c_mid, g.c_in).to(dtype), f32(bw["b1"], g.c_mid),
            f32(bw["wd"], g.c_mid, 9), f32(bw["bd"], g.c_mid),
            f32(bw["se1"], g.c_se, g.c_mid), f32(bw["bse1"], g.c_se),
            f32(bw["se2"], g.c_mid, g.c_se), f32(bw["bse2"], g.c_mid),
            f32(bw["w3"], g.c_out, g.c_mid).to(dtype), f32(bw["b3"], g.c_out),
        ))
    return StagePrefixWeights(tuple(blocks), f32(stem_w, c_stem, 9),
                              f32(stem_b, c_stem), tuple(tables), dtype)


def _check(img: torch.Tensor, weights: StagePrefixWeights) -> None:
    if img.ndim != 4 or img.shape[1] != 1:
        raise ValueError(f"image must be [N, 1, H, W], got {tuple(img.shape)}")
    if img.dtype != weights.dtype:
        raise TypeError(f"image of {img.dtype}, weight tables of {weights.dtype}")
    if weights.blocks[0].c_in != weights.stem_w.shape[0]:
        raise ValueError("the first block's c_in must equal the stem's channels")
    for prev, g in zip(weights.blocks, weights.blocks[1:]):
        if g.c_in != prev.c_out:
            raise ValueError(f"block c_in {g.c_in} after a block of c_out {prev.c_out}")
    for g in weights.blocks:
        if g.stride not in (1, 2) or (g.residual and (g.stride != 1 or g.c_in != g.c_out)):
            raise ValueError(f"unsupported block {g}")


def _out_size(n: int, stride: int) -> int:
    """Output size of a pad-1 3x3 conv."""
    return (n - 1) // stride + 1


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------


def _silu(v: torch.Tensor) -> torch.Tensor:
    return v * torch.sigmoid(v)


def _silu_fast(v: torch.Tensor) -> torch.Tensor:
    return v * torch.reciprocal(1.0 + torch.exp(-v))


def stage_stack_forward_plain(img: torch.Tensor, weights: StagePrefixWeights,
                              fast_act: bool = False) -> torch.Tensor:
    """Plain PyTorch version of :func:`stage_stack_forward`: conv2d for the
    stem and the depthwise convs, matmuls for the 1x1s, all in float32 on
    compute-type values, rounding where the kernel rounds. TF32 is turned
    off process-wide, as the importer does."""
    _check(img, weights)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dtype = weights.dtype
    act = _silu_fast if fast_act else _silu
    c_stem = weights.stem_w.shape[0]
    y = F.conv2d(img.float(), weights.stem_w.reshape(c_stem, 1, 3, 3), stride=2, padding=1)
    x = act(y + weights.stem_b.reshape(1, -1, 1, 1)).to(dtype)
    for g, (w1, b1, wd, bd, se1, bse1, se2, bse2, w3, b3) in zip(weights.blocks, weights.tables):
        n, _, h, w = x.shape
        h1 = act(torch.matmul(w1.float(), x.float().reshape(n, g.c_in, h * w)) + b1[:, None])
        h2 = F.conv2d(h1.reshape(n, g.c_mid, h, w), wd.reshape(g.c_mid, 1, 3, 3),
                      stride=g.stride, padding=1, groups=g.c_mid)
        h2 = act(h2 + bd.reshape(1, -1, 1, 1))
        s1 = _silu(h2.mean(dim=(2, 3)) @ se1.t() + bse1)
        gate = torch.sigmoid(s1 @ se2.t() + bse2)
        h3 = (h2 * gate[:, :, None, None]).to(dtype)
        ho, wo = h2.shape[2:]
        y = torch.matmul(w3.float(), h3.float().reshape(n, g.c_mid, ho * wo)) + b3[:, None]
        if g.residual:
            y = y + x.float().reshape(n, g.c_out, ho * wo)
        x = y.to(dtype).reshape(n, g.c_out, ho, wo)
    return x


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def _expand_dw_smem(c_in: int, stride: int, th: int, tw: int) -> int:
    """Shared bytes of the float32 launch (a) for an output tile th x tw:
    the input tile with its halo (c_in planes), one chunk of expanded planes,
    and the chunk's expand weights, all float32; planes pitched to ``_PX``
    floats."""
    pitch = _round_up((stride * (th - 1) + 3) * (stride * (tw - 1) + 3), _PX)
    return 4 * (c_in * pitch + _CHUNK * pitch + c_in * _CHUNK)


def _project_smem(c_mid: int, c_se: int, c_out: int, p: int) -> int:
    """Shared bytes of the float32 launch (b): one chunk of h3 for p pixels
    and of the project weights, then gate, mean and s1."""
    return 4 * (_CHUNK * (p + _round_up(c_out, _CH)) + 2 * c_mid + c_se)


def _mma_pitch(n: int) -> int:
    """Pitch (elements) of bf16 rows that ldmatrix reads: an odd multiple of
    8, so that the 8 rows of one matrix fall on distinct bank groups."""
    n = _round_up(n, 8)
    return n if (n // 8) % 2 else n + 8


def _mma_expand_smem(c_in: int, stride: int, th: int, tw: int, ch: int, cg: int) -> int:
    """Shared bytes of the bfloat16 launch (a) (csrc's expand_smem): the
    input tile with its halo as bf16 channel planes, K = c_in padded to 16,
    the halo's pixels padded to 16; the group's ``cg`` rows of expand
    weights (bf16); one chunk of ``ch`` expanded planes in float32; a bit
    per halo pixel."""
    k = _round_up(c_in, 16)
    m = _round_up((stride * (th - 1) + 3) * (stride * (tw - 1) + 3), 16)
    return (2 * k * _mma_pitch(m) + 2 * cg * _mma_pitch(k) + 4 * ch * (_round_up(m, 8) + 4)
            + 4 * (m // 32 + 1))


def _mma_project_smem(c_mid: int, c_out: int) -> int:
    """Shared bytes of the bfloat16 launch (b) (csrc's project_smem): the
    project weights (bf16, K = c_mid padded to 16, up to ``_PROJ_COLS``
    output channels padded to 16), which the float32 output tile then
    reuses; two float32 cp.async stages of h2; one stage of h3 (bf16); the
    gate."""
    cols = min(_PROJ_COLS, _round_up(c_out, 16))
    w = max(2 * cols * _mma_pitch(_round_up(c_mid, 16)), 4 * cols * (_PROJ_PX + 4))
    return (w + 4 * 2 * _PROJ_KC * _PROJ_PX + 2 * _PROJ_KC * _mma_pitch(_PROJ_PX)
            + 4 * _round_up(c_mid, 4))


def halo_factor(h: int, w: int, stride: int, th: int, tw: int) -> float:
    """The expand's work on output tiles th x tw of a pad-1 3x3 conv at
    ``stride`` over an h x w input: the input pixels inside the image that
    the tiles' halos cover, summed over the tiles, over h * w (1 when the
    tiles' halos do not overlap)."""
    def cover(n: int, t: int) -> int:
        n_out = _out_size(n, stride)
        return sum(min(n - 1, stride * (min(o + t, n_out) - 1) + 1) - max(0, stride * o - 1) + 1
                   for o in range(0, n_out, t))

    return cover(h, th) * cover(w, tw) / (h * w)


def _simt_block_plan(g: BlockGeom, ho: int, wo: int) -> dict:
    """The float32 SIMT kernels' tiles: the largest output tile of launch
    (a) that fits ``_SMEM_BUDGET``, and the pixels ``p`` per block of launch
    (b), as many as give every thread one ``_PX`` x ``_CH`` register
    tile."""
    th, tw = 8, 32
    while _expand_dw_smem(g.c_in, g.stride, th, tw) > _SMEM_BUDGET:
        if th > 1:
            th //= 2
        elif tw > _RUN:
            tw //= 2
        else:
            raise ValueError(f"block {g}: c_in too large for the kernel")
    octs = -(-g.c_out // _CH)
    if octs > _THREADS:
        raise ValueError(f"block {g}: c_out too large for the kernel")
    p = min(_PX * (_THREADS // octs), _round_up(ho * wo, _PX))
    while _project_smem(g.c_mid, g.c_se, g.c_out, p) > _SMEM_BUDGET:
        if p == _PX:
            raise ValueError(f"block {g}: c_mid too large for the kernel")
        p = _round_up(p // 2, _PX)
    return dict(th=th, tw=tw, p=p)


_TILE_ROWS = (1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64)
_TILE_COLS = (8, 16, 32, 64, 128)


def _mma_block_plan(g: BlockGeom, h: int, w: int, ho: int, wo: int) -> dict:
    """The bfloat16 tensor-core kernels' tiles: of the output tiles (rows
    from ``_TILE_ROWS`` or all ``ho``, columns from ``_TILE_COLS`` or all
    ``wo`` rounded to a run), expanded channels per block (``_MMA_GROUPS``,
    up to c_mid) and chunks of them (``_MMA_CHUNKS``) whose launch (a) fits
    ``_SMEM_BUDGET``, the one of the least halo factor (to 0.01), then the
    larger group (fewer blocks staging the same input tile), then the
    larger chunk (fewer passes over it), then the larger tile. Launch (b)'s
    blocks are fixed (``_PROJ_PX`` pixels)."""
    smem_b = _mma_project_smem(g.c_mid, g.c_out)
    if smem_b > _SMEM_BUDGET:
        raise ValueError(f"block {g}: c_mid too large for the kernel")
    rows = sorted({t for t in _TILE_ROWS if t < ho} | {ho})
    wide = _round_up(wo, _RUN)
    cols = sorted({t for t in _TILE_COLS if t < wide} | {min(wide, _TILE_COLS[-1])})
    groups = [cg for cg in _MMA_GROUPS if cg == _MMA_GROUPS[-1] or cg <= _round_up(g.c_mid, 16)]
    best = None
    for th in rows:
        for tw in cols:
            halo = halo_factor(h, w, g.stride, th, tw)
            for cg in groups:
                for ch in _MMA_CHUNKS:
                    smem = _mma_expand_smem(g.c_in, g.stride, th, tw, ch, cg)
                    if smem > _SMEM_BUDGET or cg % ch:
                        continue
                    key = (round(halo, 2), -cg, -ch, -th * tw)
                    if best is None or key < best[0]:
                        best = (key, dict(th=th, tw=tw, ch=ch, cg=cg, halo=halo, smem_a=smem))
    if best is None:
        raise ValueError(f"block {g}: c_in too large for the kernel")
    # The MMA shapes: the expand's K (c_in) and the project's K (c_mid) and
    # N (c_out), each zero-padded to 16.
    return dict(best[1], smem_b=smem_b, k_expand=_round_up(g.c_in, 16),
                k_project=_round_up(g.c_mid, 16), n_project=_round_up(g.c_out, 16))


@functools.lru_cache(maxsize=64)
def _plan(blocks: Tuple[BlockGeom, ...], h: int, w: int, mma: bool) -> Tuple[dict, ...]:
    h, w = _out_size(h, 2), _out_size(w, 2)
    plan = []
    for g in blocks:
        ho, wo = _out_size(h, g.stride), _out_size(w, g.stride)
        tiles = _mma_block_plan(g, h, w, ho, wo) if mma else _simt_block_plan(g, ho, wo)
        count = -(-ho // tiles["th"]) * -(-wo // tiles["tw"])
        plan.append(dict(h=h, w=w, ho=ho, wo=wo, tiles=count, **tiles))
        h, w = ho, wo
    return tuple(plan)


def launch_plan(blocks: Sequence[BlockGeom], h: int, w: int,
                dtype: torch.dtype = torch.bfloat16) -> List[dict]:
    """Per block: its input and output size, the depthwise output tile
    ``(th, tw)`` of launch (a) and the tile count. In bfloat16 (the
    tensor-core kernels) also the expanded channels ``cg`` per block of
    launch (a) and the chunk ``ch`` of them it takes at a time, the
    tiles' ``halo`` factor (:func:`halo_factor`), the shared bytes of
    launch (a) and (b) (``smem_a``, ``smem_b``) and the MMA shapes padded to
    16 (``k_expand``, ``k_project``, ``n_project``); in float32 (the SIMT
    kernels) the pixels ``p`` per block of launch (b)."""
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"compute type must be float32 or bfloat16, got {dtype}")
    return [dict(p) for p in _plan(tuple(blocks), h, w, dtype == torch.bfloat16)]


def stage_stack_forward(img: torch.Tensor, weights: StagePrefixWeights,
                        fast_act: bool = False) -> torch.Tensor:
    """Stem + the weight tables' blocks over ``img`` ``[N, 1, H, W]`` in
    the compute type; returns ``[N, c_last, H', W']`` in it."""
    _check(img, weights)
    if img.device.type == "cpu":
        return stage_stack_forward_plain(img, weights, fast_act)
    if img.device.type != "cuda":
        raise ValueError(f"the stage-prefix kernel runs on CUDA tensors, got {img.device}")
    tensors = [weights.stem_w, weights.stem_b] + [t for tab in weights.tables for t in tab]
    for t in tensors:
        if t.device != img.device:
            raise ValueError(f"weight table on {t.device}, image on {img.device}")
    img = img.contiguous()
    n, _, h, w = img.shape
    blocks = weights.blocks
    plan = launch_plan(blocks, h, w, img.dtype)
    c_stem = weights.stem_w.shape[0]
    acts = [c_stem * plan[0]["h"] * plan[0]["w"]] + [
        g.c_out * pl["ho"] * pl["wo"] for g, pl in zip(blocks[:-1], plan[:-1])
    ]
    act_elems = n * max(acts)
    h2_elems = n * max(g.c_mid * _round_up(pl["ho"] * pl["wo"], 4) for g, pl in zip(blocks, plan))
    part_elems = n * max(g.c_mid * pl["tiles"] for g, pl in zip(blocks, plan))
    dev = img.device
    act0 = torch.empty(act_elems, dtype=img.dtype, device=dev)
    act1 = torch.empty(act_elems, dtype=img.dtype, device=dev)
    h2 = torch.empty(h2_elems, dtype=torch.float32, device=dev)
    part = torch.empty(part_elems, dtype=torch.float32, device=dev)
    gate = torch.empty(n * max(g.c_mid for g in blocks), dtype=torch.float32, device=dev)
    out = torch.empty((n, blocks[-1].c_out, plan[-1]["ho"], plan[-1]["wo"]),
                      dtype=img.dtype, device=dev)
    mma = img.dtype == torch.bfloat16
    geoms = (ctypes.c_int * (10 * len(blocks)))(*[
        v for g, pl in zip(blocks, plan)
        for v in (g.c_in, g.c_mid, g.c_se, g.c_out, g.stride, int(g.residual),
                  pl["th"], pl["tw"], pl["ch"] if mma else pl["p"], pl["cg"] if mma else 0)
    ])
    ptrs = (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])
    lib = load_library()
    status = lib.bn_stage_stack_forward(
        _DTYPE_CODES[img.dtype], int(fast_act), len(blocks), geoms, ptrs,
        img.data_ptr(), out.data_ptr(), act0.data_ptr(), act1.data_ptr(),
        h2.data_ptr(), part.data_ptr(), gate.data_ptr(), n, c_stem, h, w,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    check(status, "stage_stack_forward kernel")
    LAUNCHES["stage_stack_forward"] += 1
    return out
