"""Long-tail ONNX operators: spatial sampling, losses, random, sequences.

The counterpart of :mod:`birdnet_tpu.compiler.ops_extended`, section by
section, registered into the same table as ``ops.py`` (imported from its
tail), plus ``SimplifiedLayerNormalization``, which the JAX package
registers in the core table from ``ops_contrib.py``.

Design notes, beside those of ``ops.py``:

- **Data-dependent shapes** (NonZero, Unique, Compress's condition,
  NonMaxSuppression, SequenceAt's position, RoiAlign's batch indices and
  adaptive sampling): the deciding value must be a host value, or a CPU
  tensor, which is read. A tensor on the card raises
  ``NotImplementedError`` saying it "must be a compile-time constant", as
  the JAX lowering raises on a tracer: reading it back would sync every
  forward and break a CUDA graph's capture.
- **Sequences and optionals** live in the interpreter's environment as a
  Python list of values and as ``None`` (absent). The list's structure is
  fixed when the graph is built, so a CUDA graph captures the element
  compute.
- **Random ops** key their draws as the JAX lowering does (the ``seed``
  attribute's float32 bits, else crc32 of ``node:op:n`` with a draw
  counter in the environment), but the bits are torch's: the noise is
  drawn on the host by a CPU ``torch.Generator`` seeded with that key,
  uploaded once per (key, shape, dtype, device) and cached, and only the
  transform runs on the card. Every call gives the same values, the card
  gives the host's values bit for bit, and a CUDA graph captures the op.
- **Text and image ops** run on the host and answer in numpy.
"""

from __future__ import annotations

import threading
import zlib
from collections import OrderedDict

import numpy as np
import torch

from .ops import (
    _ONNX_TO_TORCH,
    OpContext,
    _attr_str,
    _axis,
    _device_of,
    _filled,
    _is_host,
    _jnp_mean,
    _keys_cubic,
    _promoted,
    _run_subgraph,
    _static_array,
    _static_int,
    _static_ints,
    _tensor,
    _torch_dtype,
    op,
)


def _host_value(x, what: str, why: str) -> np.ndarray:
    """``x`` as numpy for a lowering that needs its value on the host. A
    CPU tensor is read; a tensor on the card raises, as a tracer does in
    the JAX lowering."""
    if isinstance(x, torch.Tensor):
        if x.device.type != "cpu":
            raise NotImplementedError(f"{what} must be a compile-time constant: {why}")
        return x.detach().numpy()
    return np.asarray(x)


# ---------------------------------------------------------------------------
# trivial math
# ---------------------------------------------------------------------------


@op("Acosh", fold=True)
def _acosh(ctx, x):
    return [torch.acosh(_tensor(ctx, x))]


@op("Asinh", fold=True)
def _asinh(ctx, x):
    return [torch.asinh(_tensor(ctx, x))]


@op("Atanh", fold=True)
def _atanh(ctx, x):
    return [torch.atanh(_tensor(ctx, x))]


@op("Swish", fold=True)
def _swish(ctx, x):
    # opset 24: Swish(x) = x * sigmoid(alpha * x), alpha default 1.0
    x = _tensor(ctx, x)
    alpha = float(ctx.attr("alpha", 1.0))
    return [x * torch.sigmoid(alpha * x)]


@op("TensorScatter", fold=True)
def _tensor_scatter(ctx, past, update, write_indices=None):
    """Opset-24 TensorScatter, the KV-cache write: for each batch b the
    update rows land at ``write_indices[b] + i`` along ``axis`` (``linear``)
    or at that position modulo the cache length (``circular``). Host
    ``write_indices`` are bounds-checked; a position out of range on the
    card is dropped, as the JAX scatter drops it."""
    w_host = (np.asarray(write_indices)
              if write_indices is not None and _is_host(write_indices) else None)
    device = _device_of(ctx, past, update, write_indices)
    past = _tensor(ctx, past, device)
    update = _tensor(ctx, update, device)
    axis = int(ctx.attr("axis", -2))
    mode = _attr_str(ctx, "mode", "linear")
    if mode not in ("linear", "circular"):
        raise ValueError(
            f"TensorScatter mode must be 'linear' or 'circular', got {mode!r}"
        )
    axis = _axis(axis, past.ndim)
    if axis == 0:
        raise ValueError("TensorScatter axis cannot be the batch dimension")
    if past.ndim != update.ndim:
        raise ValueError(
            "TensorScatter past_cache and update must have the same rank; "
            f"got {past.ndim} vs {update.ndim}"
        )
    batch = past.shape[0]
    cache_len = past.shape[axis]
    upd_len = update.shape[axis]
    if upd_len > cache_len:
        raise ValueError(
            f"TensorScatter update length {upd_len} exceeds cache length "
            f"{cache_len} along axis {axis}"
        )
    if write_indices is None:
        w = torch.zeros((batch,), dtype=torch.int64, device=device)
    else:
        w = _tensor(ctx, write_indices, device).to(torch.int64).reshape(batch)
    if w_host is not None and mode == "linear":
        wmax = int(np.max(w_host)) if w_host.size else 0
        wmin = int(np.min(w_host)) if w_host.size else 0
        if wmin < 0 or wmax + upd_len > cache_len:
            raise ValueError(
                f"TensorScatter linear write_indices out of range: writes "
                f"[{wmin}, {wmax + upd_len}) exceed cache length {cache_len}"
            )
    pos = w[:, None] + torch.arange(upd_len, device=device)[None, :]
    if mode == "circular":
        pos = pos % cache_len
    # jnp's .at[].set: a negative position counts from the end, and one
    # still out of range is dropped (written to a spare slot cut off below).
    pos = torch.where(pos < 0, pos + cache_len, pos)
    pos = torch.where((pos < 0) | (pos >= cache_len), cache_len, pos)
    pastm = past.movedim(axis, 1)  # [B, S, rest...]
    updm = update.movedim(axis, 1).to(past.dtype)  # [B, S_u, rest...]
    spare = torch.zeros_like(pastm.narrow(1, 0, 1))
    idx = pos.reshape(pos.shape + (1,) * (updm.ndim - 2)).expand(updm.shape)
    outm = torch.cat([pastm, spare], dim=1).scatter(1, idx, updm)
    return [outm.narrow(1, 0, cache_len).movedim(1, axis)]


@op("MeanVarianceNormalization", fold=True)
def _mvn(ctx, x):
    x = _tensor(ctx, x)
    axes = tuple(int(a) for a in ctx.attr("axes", (0, 2, 3)))
    mean = _jnp_mean(x, axes)
    # The two-pass variance (non-negative; the spec's E(X^2) - (EX)^2
    # cancels below zero for near-constant inputs with a large mean).
    var = _jnp_mean(torch.square(x - mean), axes)
    return [(x - mean) / torch.sqrt(var)]


@op("Det", fold=True)
def _det(ctx, x):
    return [torch.linalg.det(_tensor(ctx, x))]


# ``Scatter`` (the deprecated opset-9 alias of ScatterElements,
# birdnet_tpu/compiler/ops_extended.py:161) is registered in ops.py.


# ---------------------------------------------------------------------------
# shape surgery
# ---------------------------------------------------------------------------


@op("CenterCropPad", fold=True)
def _center_crop_pad(ctx, x, shape):
    x = _tensor(ctx, x)
    target = _static_ints(shape, "CenterCropPad shape")
    axes = ctx.attr("axes")
    if axes is None:
        axes = list(range(len(target)))
    rank = x.ndim
    axes = [int(a) + rank if int(a) < 0 else int(a) for a in axes]
    for a, t in zip(axes, target):
        d = x.shape[a]
        if t < d:  # centered crop; the extra element goes to the end slice
            x = x.narrow(a, (d - t) // 2, t)
        elif t > d:  # centered pad; the extra zero goes to the end
            before = (t - d) // 2

            def zeros(n):
                shp = list(x.shape)
                shp[a] = n
                return x.new_zeros(shp)

            x = torch.cat([zeros(before), x, zeros(t - d - before)], dim=a)
    return [x]


@op("Compress", fold=True)
def _compress(ctx, x, condition):
    cond = _host_value(
        condition, "Compress condition",
        "the output length is data-dependent",
    ).astype(bool).reshape(-1)
    x = _tensor(ctx, x)
    axis = ctx.attr("axis")
    if axis is None:
        idx = np.flatnonzero(cond[:x.numel()])
        return [x.reshape(-1).index_select(0, _tensor(ctx, idx, x.device))]
    axis = int(axis)
    idx = np.flatnonzero(cond[:x.shape[axis]])
    return [x.index_select(axis, _tensor(ctx, idx, x.device))]


@op("NonZero")
def _nonzero(ctx, x):
    xv = _host_value(x, "NonZero input", "its output shape is data-dependent")
    return [np.stack(np.nonzero(xv)).astype(np.int64)]


@op("Unique")
def _unique(ctx, x):
    xv = _host_value(x, "Unique input", "its output shapes are data-dependent")
    axis = ctx.attr("axis")
    is_sorted = int(ctx.attr("sorted", 1))
    if axis is None:
        y, index, inverse, counts = np.unique(
            xv.reshape(-1), return_index=True, return_inverse=True,
            return_counts=True,
        )
    else:
        axis = int(axis)
        y, index, inverse, counts = np.unique(
            xv, axis=axis, return_index=True, return_inverse=True,
            return_counts=True,
        )
    if not is_sorted:
        # First-occurrence order: permute the sorted uniques by where each
        # was first seen in the input.
        order = np.argsort(index, kind="stable")
        rank = np.empty_like(order)
        rank[order] = np.arange(len(order))
        y = np.take(y, order, axis=0 if axis is None else axis)
        index = index[order]
        counts = counts[order]
        inverse = rank[inverse]
    return [
        y,
        index.astype(np.int64),
        inverse.reshape(-1).astype(np.int64),
        counts.astype(np.int64),
    ]


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------


def _nll_core(ctx, logp, target, weight, ignore_index, reduction):
    """Shared NLL: ``logp`` is [N, C, d...] log-probabilities (raw values
    for NegativeLogLikelihoodLoss), ``target`` [N, d...] class ids. An
    out-of-range target picks NaN, as jnp.take_along_axis fills it."""
    tgt = _tensor(ctx, target, logp.device).to(torch.int64)
    if ignore_index is not None:
        ignore = tgt == int(ignore_index)
        safe_tgt = torch.where(ignore, torch.zeros_like(tgt), tgt)
    else:
        ignore = torch.zeros(tgt.shape, dtype=torch.bool, device=logp.device)
        safe_tgt = tgt
    moved = logp.movedim(1, -1)  # [N, d..., C]
    n_cls = moved.shape[-1]
    ok = (safe_tgt >= 0) & (safe_tgt < n_cls)
    clamped = torch.where(ok, safe_tgt, torch.zeros_like(safe_tgt))
    picked = torch.gather(moved, -1, clamped.unsqueeze(-1)).squeeze(-1)
    picked = _filled(picked, ok, picked.shape)
    if weight is not None:
        wt = _tensor(ctx, weight, logp.device)
        w = wt[clamped.clamp(max=wt.shape[0] - 1)]  # jnp indexing clamps
    else:
        w = torch.ones(picked.shape, dtype=picked.dtype, device=logp.device)
    w = torch.where(ignore, torch.zeros_like(w), w).to(picked.dtype)
    loss = -picked * w
    loss = torch.where(ignore, torch.zeros_like(loss), loss)
    if reduction == "none":
        return loss
    if reduction == "sum":
        return loss.sum()
    # mean: weighted mean over the elements not ignored
    return loss.sum() / w.sum()


@op("NegativeLogLikelihoodLoss", fold=True)
def _nll_loss(ctx, x, target, weight=None):
    x = _tensor(ctx, x, _device_of(ctx, x, target, weight))
    return [_nll_core(ctx, x, target, weight, ctx.attr("ignore_index"),
                      _attr_str(ctx, "reduction", "mean"))]


@op("SoftmaxCrossEntropyLoss", fold=True)
def _softmax_xent(ctx, scores, labels, weights=None):
    scores = _tensor(ctx, scores, _device_of(ctx, scores, labels, weights))
    logp = torch.log_softmax(scores, dim=1)
    loss = _nll_core(ctx, logp, labels, weights, ctx.attr("ignore_index"),
                     _attr_str(ctx, "reduction", "mean"))
    if ctx.num_outputs > 1:
        return [loss, logp]
    return [loss]


# ---------------------------------------------------------------------------
# random
# ---------------------------------------------------------------------------


# Draw counter in the interpreter environment under a name no graph value
# can use. The list survives the copy into control-flow subgraphs, so every
# seedless node (and one node run again in an unrolled Loop or SequenceMap)
# draws its own stream, while each forward replays the same order.
_RAND_COUNTER = "\x00rand_draws"

# Host-drawn noise on its device, per (key, kind, shape, dtype, device).
_NOISE_MAX = 64
_NOISE: "OrderedDict[tuple, torch.Tensor]" = OrderedDict()
_NOISE_LOCK = threading.Lock()


def _rand_key(ctx: OpContext) -> int:
    seed = ctx.attr("seed")
    if seed is not None:
        raw = int.from_bytes(np.float32(seed).tobytes(), "little")
    else:
        counter = ctx.env.setdefault(_RAND_COUNTER, [0])
        n = counter[0]
        counter[0] += 1
        raw = zlib.crc32(f"{ctx.node_name}:{ctx.op_type}:{n}".encode())
    return raw & 0x7FFFFFFF


def _draw(kind: str, key: int, shape, dtype: torch.dtype) -> torch.Tensor:
    """The host draw: standard normal, uniform [0, 1), or Gumbel(0, 1)."""
    gen = torch.Generator().manual_seed(key)
    if kind == "normal":
        return torch.randn(shape, generator=gen, dtype=dtype)
    u = torch.rand(shape, generator=gen, dtype=dtype)
    if kind == "uniform":
        return u
    tiny = torch.finfo(dtype).tiny
    return -torch.log(-torch.log(u.clamp(min=tiny)))


def _noise(ctx, kind: str, shape, dtype: torch.dtype, device) -> torch.Tensor:
    """The node's noise on ``device``: drawn on the host once, uploaded
    once, shared (callers never write to it)."""
    from ..ops.cuda.build import hold

    key = (_rand_key(ctx), kind, tuple(int(s) for s in shape), dtype,
           torch.device(device))
    with _NOISE_LOCK:
        hit = _NOISE.get(key)
        if hit is not None:
            _NOISE.move_to_end(key)
            return hold(hit)
    t = _draw(kind, key[0], key[2], dtype).to(key[4])
    with _NOISE_LOCK:
        _NOISE[key] = t
        while len(_NOISE) > _NOISE_MAX:
            _NOISE.popitem(last=False)
    return hold(t)


def _rand_dtype(ctx, default=torch.float32) -> torch.dtype:
    dt = ctx.attr("dtype")
    return _ONNX_TO_TORCH[int(dt)] if dt is not None else default


def _draw_dtype(dtype: torch.dtype) -> torch.dtype:
    return torch.float64 if dtype == torch.float64 else torch.float32


def _like(ctx, x):
    """(shape, dtype, device) of a *Like op's input."""
    if isinstance(x, torch.Tensor):
        return tuple(x.shape), x.dtype, x.device
    arr = np.asarray(x)
    return arr.shape, _torch_dtype(arr.dtype), ctx.device


def _normal(ctx, shape, dtype, device):
    n = _noise(ctx, "normal", shape, _draw_dtype(dtype), device)
    mean = float(ctx.attr("mean", 0.0))
    scale = float(ctx.attr("scale", 1.0))
    return (n * scale + mean).to(dtype)


def _uniform(ctx, shape, dtype, device):
    u = _noise(ctx, "uniform", shape, _draw_dtype(dtype), device)
    low = float(ctx.attr("low", 0.0))
    high = float(ctx.attr("high", 1.0))
    return torch.clamp(u * (high - low) + low, min=low).to(dtype)


@op("RandomNormal")
def _random_normal(ctx):
    shape = tuple(int(s) for s in ctx.attr("shape"))
    return [_normal(ctx, shape, _rand_dtype(ctx), ctx.device)]


@op("RandomNormalLike")
def _random_normal_like(ctx, x):
    shape, x_dtype, device = _like(ctx, x)
    return [_normal(ctx, shape, _rand_dtype(ctx, x_dtype), device)]


@op("RandomUniform")
def _random_uniform(ctx):
    shape = tuple(int(s) for s in ctx.attr("shape"))
    return [_uniform(ctx, shape, _rand_dtype(ctx), ctx.device)]


@op("RandomUniformLike")
def _random_uniform_like(ctx, x):
    shape, x_dtype, device = _like(ctx, x)
    return [_uniform(ctx, shape, _rand_dtype(ctx, x_dtype), device)]


@op("Bernoulli")
def _bernoulli(ctx, x):
    x = _tensor(ctx, x)
    dtype = _rand_dtype(ctx, x.dtype)
    u = _noise(ctx, "uniform", x.shape, _draw_dtype(x.dtype), x.device)
    return [(u.to(x.dtype) < x).to(dtype)]


@op("Multinomial")
def _multinomial(ctx, x):
    """Input [B, C] of unnormalized log-probabilities: Gumbel-max over
    host-drawn noise, as jax.random.categorical samples."""
    x = _tensor(ctx, x)
    sample_size = int(ctx.attr("sample_size", 1))
    dtype = _rand_dtype(ctx, torch.int32)
    b, c = x.shape
    g = _noise(ctx, "gumbel", (sample_size, b, c), _draw_dtype(x.dtype), x.device)
    samples = torch.argmax(x.to(g.dtype)[None] + g, dim=-1)  # [sample_size, B]
    return [samples.T.to(dtype)]


# ---------------------------------------------------------------------------
# spatial sampling: GridSample / AffineGrid / RoiAlign / Col2Im / NMS
# ---------------------------------------------------------------------------


def _reflect(coord, lo: float, hi: float):
    """Reflect ``coord`` into [lo, hi] (torch grid_sampler semantics)."""
    span = hi - lo
    if span <= 0:  # size-1 axis under align_corners: the one valid coord
        return torch.full_like(coord, lo)
    c = torch.remainder(coord - lo, 2 * span)
    c = span - torch.abs(c - span)
    return c + lo


def _gs_unnormalize(g, size: int, align_corners: bool):
    if align_corners:
        return (g + 1) * 0.5 * (size - 1)
    return ((g + 1) * size - 1) * 0.5


def _gs_index(coord, size: int, padding_mode: str, align_corners: bool):
    """Map a (possibly out-of-range) coordinate per padding mode; 'zeros'
    keeps it and masks at the gather."""
    if padding_mode == "border":
        return torch.clamp(coord, 0, size - 1)
    if padding_mode == "reflection":
        if align_corners:
            c = _reflect(coord, 0.0, float(size - 1))
        else:
            c = _reflect(coord, -0.5, size - 0.5)
        return torch.clamp(c, 0, size - 1)
    return coord


def _gs_gather(img, idxs, zeros_mask: bool):
    """img [N, C, *S]; ``idxs`` one int64 tensor [N, *O] per spatial axis
    (out of range under 'zeros'): the values [N, C, *O]."""
    n, c = img.shape[:2]
    sizes = img.shape[2:]
    flat = torch.zeros_like(idxs[0])
    valid = None
    for ix, size in zip(idxs, sizes):
        ok = (ix >= 0) & (ix < size)
        valid = ok if valid is None else valid & ok
        flat = flat * size + ix.clamp(0, size - 1)
    out_shape = flat.shape[1:]
    v = torch.gather(img.reshape(n, c, -1), 2,
                     flat.reshape(n, 1, -1).expand(n, c, -1))
    v = v.reshape((n, c) + tuple(out_shape))
    if zeros_mask:
        v = torch.where(valid[:, None], v, torch.zeros_like(v))
    return v


def _cubic_weights(t, a=-0.75):
    """Cubic-convolution weights of the 4 taps around t in [0, 1)."""
    return [_keys_cubic(t + 1, a, xp=torch), _keys_cubic(t, a, xp=torch),
            _keys_cubic(1 - t, a, xp=torch), _keys_cubic(2 - t, a, xp=torch)]


def _grid_sample_3d(ctx, x, grid, mode, padding, align):
    """Volumetric (5-D) GridSample, opset 20: nearest and trilinear; cubic
    is 2-D only per the spec (and torch)."""
    if mode == "cubic":
        raise NotImplementedError("GridSample mode=cubic is 2-D only")
    _, _, d, h, w = x.shape
    g = _tensor(ctx, grid, x.device).float()  # [N, Do, Ho, Wo, 3] (x, y, z)
    fx = _gs_index(_gs_unnormalize(g[..., 0], w, align), w, padding, align)
    fy = _gs_index(_gs_unnormalize(g[..., 1], h, align), h, padding, align)
    fz = _gs_index(_gs_unnormalize(g[..., 2], d, align), d, padding, align)
    zeros = padding == "zeros"
    if mode == "nearest":
        idx = [torch.round(f).to(torch.int64) for f in (fz, fy, fx)]
        return [_gs_gather(x, idx, zeros).to(x.dtype)]
    x0, y0, z0 = torch.floor(fx), torch.floor(fy), torch.floor(fz)
    wx, wy, wz = fx - x0, fy - y0, fz - z0
    x0, y0, z0 = (v.to(torch.int64) for v in (x0, y0, z0))
    acc = 0.0
    for dz, wzt in ((0, 1 - wz), (1, wz)):
        for dy, wyt in ((0, 1 - wy), (1, wy)):
            for dx, wxt in ((0, 1 - wx), (1, wx)):
                v = _gs_gather(x, [z0 + dz, y0 + dy, x0 + dx], zeros)
                acc = acc + v * (wzt * wyt * wxt)[:, None]
    return [acc.to(x.dtype)]


@op("GridSample", fold=True)
def _grid_sample(ctx, x, grid):
    """GridSample (the opset-16 'bilinear/bicubic' and opset-20
    'linear/cubic' spellings), 4-D and 5-D inputs, padding
    zeros/border/reflection, align_corners: the JAX lowering's gathers,
    which follow torch.nn.functional.grid_sample."""
    x = _tensor(ctx, x, _device_of(ctx, x, grid))
    if x.ndim not in (4, 5):
        raise NotImplementedError(
            f"GridSample supports 4-D [N,C,H,W] or 5-D [N,C,D,H,W] inputs; "
            f"got rank {x.ndim}"
        )
    mode = _attr_str(ctx, "mode", "linear")
    mode = {"bilinear": "linear", "bicubic": "cubic"}.get(mode, mode)
    padding = _attr_str(ctx, "padding_mode", "zeros")
    align = bool(int(ctx.attr("align_corners", 0)))
    if x.ndim == 5:
        return _grid_sample_3d(ctx, x, grid, mode, padding, align)
    _, _, h, w = x.shape
    g = _tensor(ctx, grid, x.device).float()  # [N, Ho, Wo, 2] (x, y)
    fx = _gs_unnormalize(g[..., 0], w, align)
    fy = _gs_unnormalize(g[..., 1], h, align)
    zeros = padding == "zeros"

    if mode == "nearest":
        fx = _gs_index(fx, w, padding, align)
        fy = _gs_index(fy, h, padding, align)
        idx = [torch.round(fy).to(torch.int64), torch.round(fx).to(torch.int64)]
        return [_gs_gather(x, idx, zeros).to(x.dtype)]

    if mode == "linear":
        fx = _gs_index(fx, w, padding, align)
        fy = _gs_index(fy, h, padding, align)
        x0, y0 = torch.floor(fx), torch.floor(fy)
        wx, wy = (fx - x0)[:, None], (fy - y0)[:, None]
        x0, y0 = x0.to(torch.int64), y0.to(torch.int64)
        v00 = _gs_gather(x, [y0, x0], zeros)
        v01 = _gs_gather(x, [y0, x0 + 1], zeros)
        v10 = _gs_gather(x, [y0 + 1, x0], zeros)
        v11 = _gs_gather(x, [y0 + 1, x0 + 1], zeros)
        top = v00 * (1 - wx) + v01 * wx
        bot = v10 * (1 - wx) + v11 * wx
        return [(top * (1 - wy) + bot * wy).to(x.dtype)]

    if mode == "cubic":
        # Padding applies per tap on the integer pixel index (torch
        # get_value_bounded): reflect/clip the tap, or mask it under 'zeros'.
        x0, y0 = torch.floor(fx), torch.floor(fy)
        wxs = [t[:, None] for t in _cubic_weights(fx - x0)]
        wys = [t[:, None] for t in _cubic_weights(fy - y0)]

        def tap(base, off, size):
            c = base + off
            if padding in ("border", "reflection"):
                c = _gs_index(c, size, padding, align)
            return c.to(torch.int64)

        acc = 0.0
        for j in range(4):
            iy = tap(y0, j - 1, h)
            row = 0.0
            for i in range(4):
                row = row + _gs_gather(x, [iy, tap(x0, i - 1, w)], zeros) * wxs[i]
            acc = acc + row * wys[j]
        return [acc.to(x.dtype)]

    raise NotImplementedError(f"GridSample mode {mode!r}")


@op("AffineGrid", fold=True)
def _affine_grid(ctx, theta, size):
    dims = _static_ints(size, "AffineGrid size")
    align = bool(int(ctx.attr("align_corners", 0)))
    spatial = dims[2:]
    if len(spatial) not in (2, 3):
        raise NotImplementedError("AffineGrid supports 2-D or 3-D spatial")
    theta = _tensor(ctx, theta)

    def base(d):
        if align:
            return np.linspace(-1.0, 1.0, d, dtype=np.float32)
        return (2 * np.arange(d, dtype=np.float32) + 1) / np.float32(d) - 1

    # A grid point's coordinates are (x, y[, z]): the spatial axes reversed,
    # made on the host (one upload per geometry). The product with theta is
    # summed term by term in elementwise ops (the JAX lowering's einsum
    # order), so the card rounds as the host does: a GridSample after it
    # magnifies one ulp of a coordinate by the image's gradient.
    mesh = np.meshgrid(*[base(d) for d in spatial], indexing="ij")
    coords = [_tensor(ctx, c[None, ..., None], theta.device)
              for c in list(reversed(mesh)) + [np.ones(spatial, np.float32)]]
    th = theta.to(torch.float32).reshape((theta.shape[0],) + (1,) * len(spatial)
                                         + tuple(theta.shape[1:]))
    out = coords[0] * th[..., 0]
    for k in range(1, len(coords)):
        out = out + coords[k] * th[..., k]
    return [out.to(theta.dtype)]


def _roi_bilinear(xt, b, y, x, h: int, w: int):
    """ORT/Caffe2 bilinear_interpolate over ``xt`` [N*H*W, C] (channels
    last): b [R, 1, 1] image index, y/x [R, P, Q] sample points; a point
    outside [-1, size] gives 0. Returns [R, P, Q, C]."""
    invalid = (y < -1.0) | (y > h) | (x < -1.0) | (x > w)
    y = torch.clamp(y, min=0.0)
    x = torch.clamp(x, min=0.0)
    y_low = torch.clamp(torch.floor(y), max=h - 1).to(torch.int64)
    x_low = torch.clamp(torch.floor(x), max=w - 1).to(torch.int64)
    y_high = torch.clamp(y_low + 1, max=h - 1)
    x_high = torch.clamp(x_low + 1, max=w - 1)
    ly = torch.clamp(y - y_low, 0.0, 1.0)
    lx = torch.clamp(x - x_low, 0.0, 1.0)
    base = b * (h * w)

    def at(yy, xx):
        return xt[base + yy * w + xx]

    v = (at(y_low, x_low) * ((1 - ly) * (1 - lx))[..., None]
         + at(y_low, x_high) * ((1 - ly) * lx)[..., None]
         + at(y_high, x_low) * (ly * (1 - lx))[..., None]
         + at(y_high, x_high) * (ly * lx)[..., None])
    return torch.where(invalid[..., None], torch.zeros_like(v), v)


@op("RoiAlign", fold=True)
def _roi_align(ctx, x, rois, batch_indices):
    """RoiAlign over every ROI at once (the JAX lowering loops over them),
    grouped by their sample lattice when ``sampling_ratio`` is 0."""
    x = _tensor(ctx, x, _device_of(ctx, x, rois))
    orig_dtype = x.dtype
    x = x.float()
    out_h = int(ctx.attr("output_height", 1))
    out_w = int(ctx.attr("output_width", 1))
    ratio = int(ctx.attr("sampling_ratio", 0))
    scale = float(ctx.attr("spatial_scale", 1.0))
    mode = _attr_str(ctx, "mode", "avg")
    coord_mode = _attr_str(ctx, "coordinate_transformation_mode", "half_pixel")
    offset = 0.5 if coord_mode == "half_pixel" else 0.0
    bidx = _host_value(batch_indices, "RoiAlign batch_indices",
                       "they pick the image of each ROI").astype(np.int64).reshape(-1)
    if ratio <= 0:
        rois_np = _host_value(
            rois, "RoiAlign rois with sampling_ratio=0",
            "the sample count per ROI is derived from the ROI's size",
        ).astype(np.float32)
        grids = []
        for roi in rois_np:  # adaptive: ceil(roi_size / out_size)
            rw = max(float(roi[2] - roi[0]) * scale, 1.0)
            rh = max(float(roi[3] - roi[1]) * scale, 1.0)
            grids.append((max(int(np.ceil(rh / out_h)), 1),
                          max(int(np.ceil(rw / out_w)), 1)))
    else:
        grids = [(ratio, ratio)] * len(bidx)
    n, c, h, w = x.shape
    xt = x.permute(0, 2, 3, 1).reshape(n * h * w, c)
    rois_t = _tensor(ctx, rois, x.device).float()
    out = torch.empty((len(bidx), c, out_h, out_w), dtype=torch.float32, device=x.device)
    for gh, gw in sorted(set(grids)):
        sel = np.asarray([i for i, g in enumerate(grids) if g == (gh, gw)], np.int64)
        sel_t = _tensor(ctx, sel, x.device)
        roi = rois_t.index_select(0, sel_t)
        x1 = roi[:, 0] * scale - offset
        y1 = roi[:, 1] * scale - offset
        x2 = roi[:, 2] * scale - offset
        y2 = roi[:, 3] * scale - offset
        roi_w = x2 - x1
        roi_h = y2 - y1
        if coord_mode != "half_pixel":  # legacy: clamp degenerate ROIs
            roi_w = torch.clamp(roi_w, min=1.0)
            roi_h = torch.clamp(roi_h, min=1.0)
        bin_h = (roi_h / out_h)[:, None, None]
        bin_w = (roi_w / out_w)[:, None, None]
        ar_h = torch.arange(out_h, device=x.device)[None, :, None]
        ar_w = torch.arange(out_w, device=x.device)[None, :, None]
        gy_ = torch.arange(gh, dtype=torch.float32, device=x.device)[None, None]
        gx_ = torch.arange(gw, dtype=torch.float32, device=x.device)[None, None]
        py = ar_h * bin_h + y1[:, None, None] + (gy_ + 0.5) * bin_h / gh  # [R, oh, gh]
        px = ar_w * bin_w + x1[:, None, None] + (gx_ + 0.5) * bin_w / gw  # [R, ow, gw]
        r = len(sel)
        yy = py.reshape(r, -1, 1).expand(r, out_h * gh, out_w * gw)
        xx = px.reshape(r, 1, -1).expand(r, out_h * gh, out_w * gw)
        b = _tensor(ctx, bidx[sel], x.device).reshape(r, 1, 1)
        vals = _roi_bilinear(xt, b, yy, xx, h, w)  # [R, oh*gh, ow*gw, C]
        vals = vals.reshape(r, out_h, gh, out_w, gw, c)
        red = vals.amax(dim=(2, 4)) if mode == "max" else vals.mean(dim=(2, 4))
        out[sel_t] = red.permute(0, 3, 1, 2)
    return [out.to(orig_dtype)]


def _col2im_sources(img_dims, blk_dims, n_pos, dil, pads, strides):
    """For each image position, the (block, position) columns that add
    into it, in the JAX scatter's order: [img_size, depth] indices into the
    flattened [P * L] columns, padded with P * L (a zero column)."""
    nd = len(img_dims)
    P = int(np.prod(blk_dims))
    L = int(np.prod(n_pos))
    img_size = int(np.prod(img_dims))
    k_idx = np.stack(np.meshgrid(*[np.arange(b) for b in blk_dims], indexing="ij"),
                     -1).reshape(P, nd)
    p_idx = np.stack(np.meshgrid(*[np.arange(n) for n in n_pos], indexing="ij"),
                     -1).reshape(L, nd)
    coords = (p_idx[None] * np.asarray(strides) + k_idx[:, None] * np.asarray(dil)
              - np.asarray(pads[:nd]))  # [P, L, nd]
    valid = np.all((coords >= 0) & (coords < np.asarray(img_dims)), axis=-1)
    flat = np.zeros((P, L), np.int64)
    mult = 1
    for d in range(nd - 1, -1, -1):
        flat += coords[..., d] * mult
        mult *= img_dims[d]
    dest = flat.reshape(-1)[valid.reshape(-1)]
    src = np.flatnonzero(valid.reshape(-1))
    order = np.argsort(dest, kind="stable")
    dest, src = dest[order], src[order]
    counts = np.bincount(dest, minlength=img_size)
    depth = max(int(counts.max()) if counts.size else 0, 1)
    table = np.full((img_size, depth), P * L, np.int64)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    slot = np.arange(len(dest)) - starts[dest]
    table[dest, slot] = src
    return table


@op("Col2Im", fold=True)
def _col2im(ctx, data, image_shape, block_shape):
    """Col2Im as a gather: each image position sums the columns that land
    on it, from a table built on the host (no atomics, so the card sums in
    the host's order)."""
    img_dims = _static_ints(image_shape, "Col2Im image_shape")
    blk_dims = _static_ints(block_shape, "Col2Im block_shape")
    nd = len(img_dims)
    dil = [int(v) for v in ctx.attr("dilations", [1] * nd)]
    pads = [int(v) for v in ctx.attr("pads", [0] * (2 * nd))]
    strides = [int(v) for v in ctx.attr("strides", [1] * nd)]
    n_pos = [
        (img_dims[d] + pads[d] + pads[nd + d] - dil[d] * (blk_dims[d] - 1) - 1)
        // strides[d] + 1
        for d in range(nd)
    ]
    L = int(np.prod(n_pos))
    P = int(np.prod(blk_dims))
    data = _tensor(ctx, data)
    if data.shape[2] != L:
        raise ValueError(
            f"Col2Im data has {data.shape[2]} block positions but the "
            f"image/block/stride geometry implies {L}"
        )
    if data.shape[1] % P:
        raise ValueError(
            f"Col2Im data channel dim {data.shape[1]} is not a multiple of "
            f"the block size {P}"
        )
    n = data.shape[0]
    c = data.shape[1] // P
    table = _col2im_sources(img_dims, blk_dims, n_pos, dil, pads, strides)
    cols = torch.cat([data.reshape(n, c, P * L),
                      data.new_zeros((n, c, 1))], dim=2)
    out = cols[:, :, _tensor(ctx, table, data.device)].sum(dim=-1)
    return [out.reshape((n, c) + tuple(img_dims))]


@op("NonMaxSuppression")
def _nms(ctx, boxes, scores, max_out=None, iou_thr=None, score_thr=None):
    why = "its output shape is data-dependent"
    vals = {}
    for name, v in (("boxes", boxes), ("scores", scores), ("max", max_out),
                    ("iou", iou_thr), ("score", score_thr)):
        vals[name] = None if v is None else _host_value(
            v, f"NonMaxSuppression {name}", why)
    boxes = vals["boxes"].astype(np.float32)  # [B, nb, 4]
    scores = vals["scores"].astype(np.float32)  # [B, nc, nb]
    # Spec: max_output_boxes_per_class defaults to 0, which means NO output.
    max_per_class = (
        int(vals["max"].reshape(-1)[0])
        if vals["max"] is not None and vals["max"].size else 0
    )
    if max_per_class <= 0:
        return [np.zeros((0, 3), np.int64)]
    iou_t = float(vals["iou"].reshape(-1)[0]) if vals["iou"] is not None else 0.0
    score_t = (float(vals["score"].reshape(-1)[0])
               if vals["score"] is not None else None)
    center = bool(int(ctx.attr("center_point_box", 0)))

    def corners(b):
        if center:
            cx, cy, w, h = b[:, 0], b[:, 1], b[:, 2], b[:, 3]
            return np.stack([cy - h / 2, cx - w / 2, cy + h / 2, cx + w / 2], axis=1)
        y1 = np.minimum(b[:, 0], b[:, 2])
        y2 = np.maximum(b[:, 0], b[:, 2])
        x1 = np.minimum(b[:, 1], b[:, 3])
        x2 = np.maximum(b[:, 1], b[:, 3])
        return np.stack([y1, x1, y2, x2], axis=1)

    def iou(a, bs):
        yy1 = np.maximum(a[0], bs[:, 0])
        xx1 = np.maximum(a[1], bs[:, 1])
        yy2 = np.minimum(a[2], bs[:, 2])
        xx2 = np.minimum(a[3], bs[:, 3])
        inter = np.clip(yy2 - yy1, 0, None) * np.clip(xx2 - xx1, 0, None)
        area_a = (a[2] - a[0]) * (a[3] - a[1])
        area_b = (bs[:, 2] - bs[:, 0]) * (bs[:, 3] - bs[:, 1])
        union = area_a + area_b - inter
        return np.where(union > 0, inter / union, 0.0)

    selected = []
    for b in range(boxes.shape[0]):
        cb = corners(boxes[b])
        for c in range(scores.shape[1]):
            sc = scores[b, c]
            cand = np.arange(sc.shape[0])
            if score_t is not None:
                cand = cand[sc[cand] > score_t]
            cand = cand[np.argsort(-sc[cand], kind="stable")]
            kept = []
            for i in cand:
                if max_per_class and len(kept) >= max_per_class:
                    break
                if kept and np.any(iou(cb[i], cb[np.asarray(kept)]) > iou_t):
                    continue
                kept.append(i)
            selected.extend((b, c, int(i)) for i in kept)
    return [np.asarray(selected, np.int64).reshape(-1, 3)]


# ---------------------------------------------------------------------------
# sequences (Python lists of values, fixed when the graph is built)
# ---------------------------------------------------------------------------


@op("SequenceEmpty")
def _sequence_empty(ctx):
    return [[]]


@op("SequenceConstruct")
def _sequence_construct(ctx, *tensors):
    return [list(tensors)]


@op("SequenceLength")
def _sequence_length(ctx, s):
    return [np.int64(len(s))]


def _seq_pos(pos, n, what, insert=False):
    p = _static_int(pos, f"{what} position")
    hi = n if insert else n - 1
    if p < -n or p > hi:
        raise ValueError(f"{what} position {p} out of range for length {n}")
    return p


@op("SequenceAt")
def _sequence_at(ctx, s, pos):
    pos = _host_value(pos, "SequenceAt position",
                      "the elements' shapes may differ, so it fixes the output shape")
    return [s[_seq_pos(pos, len(s), "SequenceAt")]]


@op("SequenceInsert")
def _sequence_insert(ctx, s, t, pos=None):
    out = list(s)
    if pos is None:
        out.append(t)
    else:
        p = _seq_pos(pos, len(s), "SequenceInsert", insert=True)
        out.insert(p if p >= 0 else p + len(s), t)
    return [out]


@op("SequenceErase")
def _sequence_erase(ctx, s, pos=None):
    out = list(s)
    p = _seq_pos(pos, len(s), "SequenceErase") if pos is not None else -1
    del out[p]
    return [out]


@op("ConcatFromSequence")
def _concat_from_sequence(ctx, s):
    axis = int(ctx.attr("axis"))
    new_axis = int(ctx.attr("new_axis", 0))
    if all(_is_host(t) for t in s):
        parts = [np.asarray(t) for t in s]
        return [np.stack(parts, axis=axis) if new_axis else np.concatenate(parts, axis=axis)]
    parts = _promoted(ctx, *s)
    return [torch.stack(parts, dim=axis) if new_axis else torch.cat(parts, dim=axis)]


@op("SplitToSequence")
def _split_to_sequence(ctx, x, split=None):
    axis = int(ctx.attr("axis", 0))
    host = _is_host(x)
    xv = np.asarray(x) if host else x
    axis = _axis(axis, xv.ndim)
    n = xv.shape[axis]

    def part(off, size):
        if host:
            return np.take(xv, np.arange(off, off + size), axis=axis)
        return xv.narrow(axis, off, size)

    if split is None:
        parts = [part(i, 1) for i in range(n)]
        if not int(ctx.attr("keepdims", 1)):
            parts = [np.squeeze(p, axis=axis) if host else p.squeeze(axis) for p in parts]
        return [parts]
    arr = _static_array(split, "SplitToSequence split")
    sizes = [int(v) for v in arr.reshape(-1)]
    if arr.ndim == 0:
        size = sizes[0]
        sizes = [size] * (n // size)
        if n % size:
            sizes.append(n % size)
    parts, off = [], 0
    for sz in sizes:
        parts.append(part(off, sz))
        off += sz
    return [parts]


@op("SequenceMap")
def _sequence_map(ctx, s, *extras):
    """The ``body`` subgraph on each element; further inputs are mapped
    elementwise when they are sequences and broadcast when tensors."""
    body = ctx.attr("body")
    n_out = max(ctx.num_outputs, 1)
    results = [[] for _ in range(n_out)]
    for i, elem in enumerate(s):
        extra_env = {body.input[0].name: elem}
        for j, ex in enumerate(extras):
            extra_env[body.input[j + 1].name] = ex[i] if isinstance(ex, list) else ex
        outs = _run_subgraph(ctx, body, extra_env)
        for j in range(n_out):
            results[j].append(outs[j])
    return results


# ---------------------------------------------------------------------------
# optionals (absent = None)
# ---------------------------------------------------------------------------


@op("Optional")
def _optional(ctx, *args):
    return [args[0] if args else None]


@op("OptionalHasElement")
def _optional_has_element(ctx, *args):
    # An empty-name input arrives trimmed away (opset 18 allows calling
    # with no input at all).
    return [np.bool_(bool(args) and args[0] is not None)]


@op("OptionalGetElement")
def _optional_get_element(ctx, x=None):
    if x is None:
        raise ValueError("OptionalGetElement on an empty optional")
    return [x]


# ---------------------------------------------------------------------------
# DeformConv / MaxRoiPool
# ---------------------------------------------------------------------------


@op("DeformConv", fold=True)
def _deform_conv(ctx, x, w, offset, b=None, mask=None):
    """Deformable convolution v2 (opset 19): each kernel tap samples the
    input at (base + learned offset) bilinearly, optionally modulated by a
    mask; the contraction over (C_in, taps) is one float32 matmul per
    group (torchvision.ops.deform_conv2d semantics)."""
    device = _device_of(ctx, x, w, offset, b, mask)
    x = _tensor(ctx, x, device)
    w = _tensor(ctx, w, device)
    if x.ndim != 4:
        raise NotImplementedError("DeformConv supports 2-D spatial inputs")
    n, c, _, _ = x.shape
    o_c, wc, kh, kw = w.shape
    strides = [int(v) for v in ctx.attr("strides", [1, 1])]
    dil = [int(v) for v in ctx.attr("dilations", [1, 1])]
    pads = [int(v) for v in ctx.attr("pads", [0, 0, 0, 0])]
    group = int(ctx.attr("group", 1))
    og_n = int(ctx.attr("offset_group", 1))
    offset = _tensor(ctx, offset, device)
    oh, ow = offset.shape[2], offset.shape[3]
    k = kh * kw
    # Base sampling positions per output pixel and tap: [oH|oW, kH|kW].
    base_y = (torch.arange(oh, device=device)[:, None] * strides[0] - pads[0]
              + torch.arange(kh, device=device)[None] * dil[0]).float()
    base_x = (torch.arange(ow, device=device)[:, None] * strides[1] - pads[1]
              + torch.arange(kw, device=device)[None] * dil[1]).float()
    # offset layout [N, og*K*2, oH, oW], (y, x) interleaved per tap
    off = offset.reshape(n, og_n, k, 2, oh, ow).float()
    ky = torch.arange(kh, device=device).repeat_interleave(kw)
    kx = torch.arange(kw, device=device).repeat(kh)
    by = base_y[:, ky]  # [oH, K]
    bx = base_x[:, kx]  # [oW, K]
    sy = by.T[None, None, :, :, None] + off[:, :, :, 0]  # [N, og, K, oH, oW]
    sx = bx.T[None, None, :, None, :] + off[:, :, :, 1]
    m = None if mask is None else _tensor(ctx, mask, device).reshape(
        n, og_n, k, oh, ow).float()
    xf = x.float()
    cg = c // og_n  # channels per offset group
    parts = []
    for og in range(og_n):
        img = xf[:, og * cg:(og + 1) * cg]
        yy, xx = sy[:, og].reshape(n, -1), sx[:, og].reshape(n, -1)
        y0, x0 = torch.floor(yy), torch.floor(xx)
        wy, wx = (yy - y0)[:, None], (xx - x0)[:, None]
        y0, x0 = y0.to(torch.int64), x0.to(torch.int64)

        def g(iy, ix):
            return _gs_gather(img, [iy, ix], True)

        v = (g(y0, x0) * ((1 - wy) * (1 - wx))
             + g(y0, x0 + 1) * ((1 - wy) * wx)
             + g(y0 + 1, x0) * (wy * (1 - wx))
             + g(y0 + 1, x0 + 1) * (wy * wx)).reshape(n, cg, k, oh, ow)
        if m is not None:
            v = v * m[:, og][:, None]
        parts.append(v)
    cols = torch.cat(parts, dim=1) if og_n > 1 else parts[0]  # [N, C, K, oH, oW]
    icg, ocg = c // group, o_c // group
    cols_g = cols.reshape(n, group, icg * k, oh * ow)
    w_g = w.reshape(group, ocg, wc * k).float()
    y = torch.matmul(w_g[None], cols_g).reshape(n, o_c, oh, ow)
    if b is not None:
        y = y + _tensor(ctx, b, device).float()[None, :, None, None]
    return [y.to(x.dtype)]


@op("MaxRoiPool", fold=True)
def _max_roi_pool(ctx, x, rois):
    """Legacy ROI max pooling. Bin boundaries are data-dependent, so each
    output cell reduces a boundary mask over the whole feature map: no
    host read."""
    x = _tensor(ctx, x, _device_of(ctx, x, rois))
    orig_dtype = x.dtype
    x = x.float()
    ph, pw = (int(v) for v in ctx.attr("pooled_shape"))
    scale = float(ctx.attr("spatial_scale", 1.0))
    n, c, h, w = x.shape
    rois = _tensor(ctx, rois, x.device).float()  # [R, 5]: (batch, x1, y1, x2, y2)
    dev = x.device
    hs = torch.arange(h, dtype=torch.float32, device=dev)
    ws = torch.arange(w, dtype=torch.float32, device=dev)
    b = rois[:, 0].to(torch.int64)
    ok = (b >= 0) & (b < n)
    b = torch.where(ok, b, torch.zeros_like(b))
    x1 = torch.round(rois[:, 1] * scale)[:, None]
    y1 = torch.round(rois[:, 2] * scale)[:, None]
    x2 = torch.round(rois[:, 3] * scale)[:, None]
    y2 = torch.round(rois[:, 4] * scale)[:, None]
    bin_h = torch.clamp(y2 - y1 + 1, min=1.0) / ph
    bin_w = torch.clamp(x2 - x1 + 1, min=1.0) / pw
    p = torch.arange(ph, dtype=torch.float32, device=dev)[None]
    q = torch.arange(pw, dtype=torch.float32, device=dev)[None]
    # bin p covers rows [floor(y1 + p*bin_h), ceil(y1 + (p+1)*bin_h))
    hstart = torch.clamp(torch.floor(y1 + p * bin_h), 0, h)
    hend = torch.clamp(torch.ceil(y1 + (p + 1) * bin_h), 0, h)
    wstart = torch.clamp(torch.floor(x1 + q * bin_w), 0, w)
    wend = torch.clamp(torch.ceil(x1 + (q + 1) * bin_w), 0, w)
    hmask = (hs[None, None] >= hstart[..., None]) & (hs[None, None] < hend[..., None])
    wmask = (ws[None, None] >= wstart[..., None]) & (ws[None, None] < wend[..., None])
    mask = hmask[:, :, None, :, None] & wmask[:, None, :, None, :]  # [R, ph, pw, H, W]
    empty = ~mask.any(dim=(3, 4))
    img = x[b]  # [R, C, H, W]
    vals = torch.where(mask[:, None], img[:, :, None, None],
                       torch.full((), -torch.inf, device=dev))
    out = vals.amax(dim=(4, 5))  # [R, C, ph, pw]
    out = torch.where(empty[:, None], torch.zeros_like(out), out)
    out = torch.where(ok[:, None, None, None], out, torch.full_like(out, torch.nan))
    return [out.to(orig_dtype)]


@op("RMSNormalization", fold=True)
def _rms_norm(ctx, x, scale):
    """Opset-23 RMS normalization: x / sqrt(mean(x^2 over [axis:]) + eps)
    * scale, computed in ``stash_type`` (float32 by default), then cast
    back to x's dtype."""
    x = _tensor(ctx, x, _device_of(ctx, x, scale))
    axis = int(ctx.attr("axis", -1))
    eps = float(ctx.attr("epsilon", 1e-5))
    orig = x.dtype
    stash = _ONNX_TO_TORCH[int(ctx.attr("stash_type", 1))]
    xs = x.to(stash)
    axes = tuple(range(_axis(axis, x.ndim), x.ndim))
    ms = torch.mean(torch.square(xs), dim=axes, keepdim=True)
    y = xs * torch.rsqrt(ms + eps)
    return [(y * _tensor(ctx, scale, x.device).to(stash)).to(orig)]


@op("SimplifiedLayerNormalization", fold=True)
def _simplified_layer_norm(ctx, x, scale):
    """RMS norm as onnxruntime's optimizer writes it, in the core domain
    (birdnet_tpu/compiler/ops_contrib.py:269): float32 statistics, the
    normalized value in x's dtype times the scale; optional second output
    inv_std_var."""
    x = _tensor(ctx, x, _device_of(ctx, x, scale))
    axis = int(ctx.attr("axis", -1))
    eps = float(ctx.attr("epsilon", 1e-5))
    axes = tuple(range(_axis(axis, x.ndim), x.ndim))
    xf = x.float()
    inv = torch.rsqrt(torch.mean(xf * xf, dim=axes, keepdim=True) + eps)
    y = (xf * inv).to(x.dtype) * _tensor(ctx, scale, x.device).to(x.dtype)
    outs = [y]
    if ctx.num_outputs > 1:
        outs.append(inv)
    return outs


# ---------------------------------------------------------------------------
# text ops: host values (numpy object arrays), answered in numpy
# ---------------------------------------------------------------------------


def _static_strings(x, op_name):
    return _host_value(x, f"{op_name} input",
                       "strings are host values, never tensors on the card")


@op("StringNormalizer")
def _string_normalizer(ctx, x):
    """Opset-10 StringNormalizer: optional stopword removal and a case
    change. ``locale`` is accepted and ignored (Python str casing)."""
    arr = _static_strings(x, "StringNormalizer")
    if arr.ndim not in (1, 2) or (arr.ndim == 2 and arr.shape[0] != 1):
        raise ValueError(
            f"StringNormalizer input must be [C] or [1, C], got {arr.shape}"
        )
    flat = [str(s) for s in arr.reshape(-1)]
    action = str(_attr_str(ctx, "case_change_action", "NONE"))
    if action not in ("NONE", "LOWER", "UPPER"):
        raise ValueError(f"invalid case_change_action {action!r}")
    stopwords = ctx.attr("stopwords") or []
    if stopwords:
        if int(ctx.attr("is_case_sensitive", 0)):
            drop = {str(w) for w in stopwords}
            flat = [s for s in flat if s not in drop]
        else:
            drop = {str(w).lower() for w in stopwords}
            flat = [s for s in flat if s.lower() not in drop]
    if action == "LOWER":
        flat = [s.lower() for s in flat]
    elif action == "UPPER":
        flat = [s.upper() for s in flat]
    if not flat:
        # Spec: when everything is removed, one empty string: [1] for a
        # 1-D input, [1, 1] for a [1, C] one.
        out = np.asarray([""], dtype=object)
        return [out.reshape(1, 1) if arr.ndim == 2 else out]
    out = np.asarray(flat, dtype=object)
    return [out.reshape(1, -1) if arr.ndim == 2 else out]


@op("TfIdfVectorizer", fold=True)
def _tfidf_vectorizer(ctx, x):
    """Opset-9 TfIdfVectorizer: n-gram counting with skips (the ORT
    kernel's rule). A pool n-gram of length n matches at start i with
    stride d when ``x[i + j*d] == gram[j]`` for all j; unigrams count once,
    n >= 2 grams at every stride 1..max_skip_count+1, and only lengths in
    [min_gram_length, max_gram_length] contribute. The g-th pool gram
    writes column ``ngram_indexes[g]``: TF counts, IDF weight*(count > 0),
    TFIDF weight*count. The integer form runs on the input's device; the
    string pool folds the strings to ids on the host."""
    mode = str(_attr_str(ctx, "mode", None))
    if mode not in ("TF", "IDF", "TFIDF"):
        raise ValueError(f"invalid TfIdfVectorizer mode {mode!r}")
    min_n = int(ctx.attr("min_gram_length"))
    max_n = int(ctx.attr("max_gram_length"))
    max_skip = int(ctx.attr("max_skip_count"))
    ngram_counts = [int(v) for v in ctx.attr("ngram_counts")]
    ngram_indexes = np.asarray([int(v) for v in ctx.attr("ngram_indexes")], dtype=np.int64)
    weights = ctx.attr("weights")
    pool_ints = ctx.attr("pool_int64s")
    if pool_ints is not None:
        pool = np.asarray([int(v) for v in pool_ints], dtype=np.int64)
        xv = x
    else:
        pool_strings = ctx.attr("pool_strings")
        if pool_strings is None:
            raise ValueError("TfIdfVectorizer needs pool_int64s or pool_strings")
        xs = _static_strings(x, "TfIdfVectorizer")
        # Strings to dense ids: pool entries get their first-seen id, input
        # strings outside the pool -1 (matches nothing).
        ids: dict = {}
        for s in pool_strings:
            ids.setdefault(str(s), len(ids))
        pool = np.asarray([ids[str(s)] for s in pool_strings], dtype=np.int64)
        xv = np.asarray([ids.get(str(s), -1) for s in xs.reshape(-1)],
                        dtype=np.int64).reshape(xs.shape)
    x2 = _tensor(ctx, xv)
    one_d = x2.ndim == 1
    if one_d:
        x2 = x2[None]
    dev = x2.device
    n_rows, n_cols = x2.shape
    out_size = int(ngram_indexes.max()) + 1 if ngram_indexes.size else 0
    out = torch.zeros((n_rows, out_size), dtype=torch.float32, device=dev)
    gram_pos = 0  # running pool-gram index (for ngram_indexes/weights)
    for level, start in enumerate(ngram_counts):
        n = level + 1
        end = ngram_counts[level + 1] if level + 1 < len(ngram_counts) else len(pool)
        n_elems = end - start
        if n_elems < 0 or n_elems % n:
            raise ValueError(
                f"TfIdfVectorizer pool segment for {n}-grams has {n_elems} "
                f"elements, not a multiple of {n}"
            )
        n_grams = n_elems // n
        if n_grams == 0:
            continue
        grams = _tensor(ctx, pool[start:end].reshape(n_grams, n), dev).to(x2.dtype)
        if not (min_n <= n <= max_n):
            gram_pos += n_grams
            continue
        strides = (1,) if n == 1 else tuple(range(1, max_skip + 2))
        counts = torch.zeros((n_rows, n_grams), dtype=torch.float32, device=dev)
        for d in strides:
            p = n_cols - (n - 1) * d
            if p <= 0:
                continue
            idx = np.arange(p)[:, None] + np.arange(n)[None, :] * d
            windows = x2[:, _tensor(ctx, idx, dev)]  # [N, P, n]
            eq = torch.all(windows[:, :, None, :] == grams[None, None], dim=-1)
            counts = counts + eq.sum(dim=1, dtype=torch.float32)
        wts = (np.asarray([float(v) for v in weights], dtype=np.float32)[
            gram_pos:gram_pos + n_grams]
            if weights is not None else np.ones(n_grams, np.float32))
        wts = _tensor(ctx, wts, dev)[None, :]
        if mode == "IDF":
            vals = (counts > 0).float() * wts
        elif mode == "TFIDF":
            vals = counts * wts
        else:
            vals = counts
        cols = _tensor(ctx, ngram_indexes[gram_pos:gram_pos + n_grams], dev)
        out = out.index_add(1, cols, vals)
        gram_pos += n_grams
    return [out[0] if one_d else out]


@op("StringConcat")
def _string_concat(ctx, a, b):
    """Opset-20 StringConcat: elementwise, with numpy broadcasting."""
    av, bv = np.broadcast_arrays(_static_strings(a, "StringConcat"),
                                 _static_strings(b, "StringConcat"))
    out = np.asarray([str(x) + str(y) for x, y in zip(av.reshape(-1), bv.reshape(-1))],
                     dtype=object)
    return [out.reshape(av.shape)]


@op("StringSplit")
def _string_split(ctx, x):
    """Opset-20 StringSplit: rows padded with "" to the largest count; the
    second output is the count per element. An absent or empty
    ``delimiter`` splits on runs of whitespace (str.split())."""
    xv = _static_strings(x, "StringSplit")
    delim = ctx.attr("delimiter")
    maxsplit = ctx.attr("maxsplit")
    ms = int(maxsplit) if maxsplit is not None else -1
    parts = [str(s).split(delim if delim else None, ms) for s in xv.reshape(-1)]
    width = max((len(p) for p in parts), default=0)
    padded = np.asarray([p + [""] * (width - len(p)) for p in parts],
                        dtype=object).reshape(xv.shape + (width,))
    counts = np.asarray([len(p) for p in parts], dtype=np.int64).reshape(xv.shape)
    return [padded, counts]


@op("RegexFullMatch")
def _regex_full_match(ctx, x):
    """Opset-20 RegexFullMatch with Python's ``re`` (a superset of RE2's
    common constructs; an RE2-only extension fails in ``re.compile``)."""
    import re

    xv = _static_strings(x, "RegexFullMatch")
    pattern = ctx.attr("pattern")
    if pattern is None:
        raise ValueError("RegexFullMatch requires the 'pattern' attribute")
    rx = re.compile(str(pattern))
    out = np.asarray([rx.fullmatch(str(s)) is not None for s in xv.reshape(-1)],
                     dtype=np.bool_)
    return [out.reshape(xv.shape)]


@op("ImageDecoder")
def _image_decoder(ctx, stream):
    """Opset-20 ImageDecoder: a compressed image byte stream to uint8
    ``[H, W, C]`` on the host, with Pillow's codecs. ``pixel_format``: RGB
    (default), BGR or Grayscale (ITU-R 601-2 luma)."""
    arr = _host_value(stream, "ImageDecoder input",
                      "the encoded stream is decoded on the host")
    if arr.dtype != np.uint8 or arr.ndim != 1:
        raise ValueError(
            f"ImageDecoder input must be a 1-D uint8 byte stream, got "
            f"{arr.dtype} with shape {arr.shape}"
        )
    fmt = str(_attr_str(ctx, "pixel_format", "RGB"))
    if fmt not in ("RGB", "BGR", "Grayscale"):
        raise ValueError(f"invalid pixel_format {fmt!r}")
    try:
        from PIL import Image
    except ImportError as e:
        raise NotImplementedError(
            "ImageDecoder needs Pillow for the host-side image codecs, and "
            "it is not installed"
        ) from e
    import io

    try:
        img = Image.open(io.BytesIO(arr.tobytes()))
        img.load()
    except Exception as e:
        raise ValueError(f"ImageDecoder: undecodable image stream ({e})")
    if fmt == "Grayscale":
        out = np.asarray(img.convert("L"), dtype=np.uint8)[..., None]
    else:
        out = np.asarray(img.convert("RGB"), dtype=np.uint8)
        if fmt == "BGR":
            out = out[..., ::-1]
    return [np.ascontiguousarray(out)]
