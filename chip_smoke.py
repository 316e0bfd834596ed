"""Smoke run of the PyTorch port (birdnet_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure raises and the script
exits non-zero:

1. device  — CUDA must be available; prints the card's name and power limit
             (nvidia-smi) on a line of its own.
2. build   — compiles the CUDA kernels from birdnet_tpu_torch/csrc with nvcc.
3. kernel  — each frontend kernel (B1, B2) against its plain PyTorch
             version at the main path's shapes (32 segments of 144000
             samples, flen 1024, hop 280, 96 mels or filters), in bf16 and
             float32, and in float32 against the f64 oracle, and on
             int16-range samples with scale=1/32768 in both types; the int8 1x1
             conv + requantize kernel (B3) against its plain version at
             three shapes of the int8 v2.4 graph at batch 32 and in a case
             whose output scale has an inexact float32 reciprocal; the
             stage-prefix kernel (B4) at the full-width six-block geometry
             on [32, 1, 96, 511] in bf16 with and without fast_act and in
             float32; the framed-audio frontend (B5) on a 32-segment int16
             buffer at step 144000 and 72000, also against the f64 oracle
             on two windows; B3 at each of the 49 1x1 convs of the
             full-width int8 v2.4 forward at batch 32, summed (the
             qconv1x1_requant_forward line); times each kernel, its
             plain version and one PyTorch call computing the kernel's
             product on the same operands (library_ms, the yardstick: the
             port never calls it) as device time (a CUDA graph of 10
             calls replayed, CUDA events), beside the least time the card
             could take (bound_ms, from this run's shapes and the H100's
             published peaks).
4. slice   — generates full-width BirdNET v2.4 ONNX files (conv and STFT
             frontends, 6522 species, random weights from a seed), builds a
             Classifier on each at precision "fast", runs predict and
             predict_batch(32), checks that the frontend kernel and B4 ran,
             and compares the logits with the same file at "fp32"; prints
             predict_batch(32)'s rate at fast, mixed (the card's per-call
             default, whose logits must agree with fp32 as fast's do) and
             fp32.
5. stream  — on the same "fast" classifiers, analyze_samples over a seeded
             one-hour int16 recording at overlap 0 and 1.5 s (the second
             with a timeout, so 16-tile superchunks, two in flight), at the
             default tile and at tile 32; checks that the frontend kernel
             and B4 ran and that the streamed top-K equals predict_batch on
             the same segments framed on the host, in batches of the tile
             (the last zero-padded, as the stream pads it);
             prints sustained segments/s at tile 32, 64 and 128, for int16
             against float32 input, and BIRDNET_STAGE123_SPLIT=0 against
             the default, each pair in turns; then profiles one streamed
             hour per form at the default tile (torch.profiler: the
             device's busy time, its idle share and the largest device
             items).
6. int8    — on the same files, builds int8 Classifiers (synthetic
             calibration) at "fast" (B1 or B2, and B3) and at "mixed" (B3),
             runs predict and predict_batch(32) and checks that the kernels
             ran; checks every node of the full-width int8 graph on the
             card against the same node on the CPU, and the int8 logits of
             a small v2.4 model against its fp32 logits.

Before each of the three driven paths (slice, stream, int8) every launch
count is set to 0; the counts are read right after it. B5, which the JAX
package reaches only through its public function, counts its kernel
phase's calls to that function.

The line before the last is the kernels' summary; the last line is
``{"ok": true, "device": {...}}``. The script imports no JAX.

    python3 chip_smoke.py --ab

times only what every tree of the port with B4 shares through the same
wrappers (B4 at the full-width geometry, B5, the B3 forward sum) and
predict_batch(32) under mixed on the full-width files, so that this
script beside another tree's package (``git archive`` into the
git-ignored ``_ab/``) compares the two in one call, in turns.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from birdnet_tpu_torch import Classifier, InferenceOptions, chunk_audio
from birdnet_tpu_torch.compiler.importer import (
    consts_to_device,
    import_onnx,
    interpret_graph,
    params_to_torch,
)
from birdnet_tpu_torch.compiler.ops import OpContext, get_lowering
from birdnet_tpu_torch.compiler.quantize import (
    quantize_model,
    synthetic_calibration_segments,
)
from birdnet_tpu_torch.compiler._melbank import mel_weight_matrix
from birdnet_tpu_torch.models import birdnet_v24
from birdnet_tpu_torch.onnx import proto as P
from birdnet_tpu_torch.ops.cuda import build
from birdnet_tpu_torch.ops.cuda import frontend as fe
from birdnet_tpu_torch.ops.cuda import qconv as qc
from birdnet_tpu_torch.ops.cuda import stage_prefix as spx

N_SEG, S, HOP, FLEN, N_MELS = 32, 144_000, 280, 1024, 96
SEED = 0
CARD = torch.device("cuda", 0)
SOURCES = {
    "stft_melspec": "birdnet_tpu_torch/csrc/frontend.cu",
    "filterbank_logpower": "birdnet_tpu_torch/csrc/frontend.cu",
    "qconv1x1_requant": "birdnet_tpu_torch/csrc/qconv.cu",
    "stage_stack_forward": "birdnet_tpu_torch/csrc/stage_prefix.cu",
    "frame_filterbank_logpower": "birdnet_tpu_torch/csrc/frontend.cu",
    "qconv1x1_requant_forward": "birdnet_tpu_torch/csrc/qconv.cu",
}
# The TPU kernels these replace (the wrappers that reach pl.pallas_call).
REPLACES = {
    "stft_melspec": "birdnet_tpu/ops/pallas/frontend.py:463",
    "filterbank_logpower": "birdnet_tpu/ops/pallas/frontend.py:334",
    "qconv1x1_requant": "birdnet_tpu/ops/pallas/qconv.py:91",
    "stage_stack_forward": "birdnet_tpu/ops/pallas/stage123.py:255",
    "frame_filterbank_logpower": "birdnet_tpu/ops/pallas/frontend.py:194",
    "qconv1x1_requant_forward": "birdnet_tpu/ops/pallas/qconv.py:91",
}
# B3 at batch 32: (C_in, C_out, N = H*W, activation), 1x1 convs of the int8
# v2.4 graph; the first is the one the kernels line reports.
QCONV_SHAPES = [
    (24, 96, 48 * 256, "silu"),
    (96, 40, 12 * 256, ""),
    (1280, 320, 1, "silu"),  # squeeze-excite
]
# B3 against its plain version: equal codes without an activation or with
# relu; with sigmoid/silu (exp may round differently) at most 1 code apart
# on at most this share of the codes.
QCONV_MAX_DIFF_SHARE = 1e-4
# fast vs fp32 logits on the full-width files: scaled max |Δ| and top-1.
SCALED_LOGIT_TOL = 1e-1
MIN_TOP1_AGREE = 29
# int8 vs the float file at fp32 on the small model (the bound of
# tests/test_quantize.py): the fp32 winner in the int8 top-3 on this many
# of the 32 rows, every row's logit correlation at least this.
MIN_TOP3_HOLDS_FP32_WINNER = 29
MIN_LOGIT_CORRELATION = 0.98
# The small model: BirdNET v2.4's graph at a tenth of the width, one block
# per stage, all 6522 species.
SMALL = dict(width=0.1, depth=1)
# Each node of the int8 graph, card against CPU: float outputs within this
# share of their largest magnitude (fp32 sums in another order; under
# mixed/fast about two bf16 ulps).
FLOAT_NODE_TOL = {"fp32": 1e-4, "mixed": 2 ** -6, "fast": 2 ** -6}
# B4 against its plain version, max |Δ| over the largest magnitude: float32
# sums in another order; in bf16 a rounding flipped by that order, carried
# through six blocks. Measured on the H100 at this geometry: 1.4e-7 and
# 0.0041 (one bf16 ulp); the bounds keep a margin of 70 and 4.
PREFIX_TOL = {"float32": 1e-5, "bfloat16": 2 ** -6}
# The full-width v2.4 stage prefix: (c_in, c_mid, c_se, c_out, stride,
# residual) per block.
PREFIX_BLOCKS = [
    (32, 32, 8, 24, 1, False), (24, 24, 6, 24, 1, True), (24, 96, 24, 40, 2, False),
    (40, 160, 40, 40, 1, True), (40, 160, 40, 80, 2, False), (80, 320, 80, 80, 1, True),
]
# The stream phase: one hour of 48 kHz audio; streamed against predict_batch
# at tile 32, confidences within this, and equal top-1 wherever the top-1
# and top-2 confidences differ by more than it.
HOUR = 3600 * 48_000
STREAM_CONF_TOL = 1e-3
# The H100 SXM's published peaks (NVIDIA's data sheet, dense, at 700 W):
# the rates of bound_ms.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bf16": 989e12, "int8": 1979e12, "tf32": 495e12, "fp32": 67e12}


def reset_launches() -> None:
    fe.reset_launches()
    qc.reset_launches()
    spx.reset_launches()


def read_launches() -> dict:
    return {**fe.LAUNCHES, **qc.LAUNCHES, **spx.LAUNCHES}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def within(got: torch.Tensor, want: torch.Tensor, dtype) -> tuple:
    """(max |Δ|, ok). float32: |Δ| <= 1e-3 + 1e-3 |want|. bf16:
    |Δ| <= 2^-6 |want| + 1e-2, about two bf16 ulps (the kernel sums in
    another order than the plain matmul; one ulp of a log value near -13
    is already 0.0625)."""
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    if dtype == torch.float32:
        bound = 1e-3 + 1e-3 * want.abs()
    else:
        bound = 2 ** -6 * want.abs() + 1e-2
    return float(diff.max()), bool(torch.all(diff <= bound)) and bool(torch.isfinite(got).all())


def time_ms(fn, reps: int = 10) -> float:
    """Device milliseconds per call: ``reps`` calls captured in one CUDA
    graph and replayed, CUDA events around the replay, after one warm call
    and one warm replay. The host's work for each call (the wrapper, the
    launch) runs at capture, so this is the time the card spends, the
    figure bound_ms bounds."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(bytes_moved: float, ops: dict) -> dict:
    """The least time the card could take for a kernel's work: the larger
    of the bytes it must move (each input read once, each output written
    once) over the memory rate and, per operand type, its operations over
    that type's peak (``ops``: type -> operations)."""
    mem_s = bytes_moved / HBM_BYTES_PER_S
    ops_s = max(n / PEAK_OPS_PER_S[kind] for kind, n in ops.items())
    return {"bound_ms": 1e3 * max(mem_s, ops_s),
            "bound_by": "bytes" if mem_s >= ops_s else "operations"}


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def kernel_vs_plain_ms(run, plain) -> tuple:
    """(kernel ms, plain ms) of device time (time_ms), in turns kernel,
    plain, plain, kernel."""
    k1, p1, p2, k2 = time_ms(run), time_ms(plain), time_ms(plain), time_ms(run)
    return (k1 + k2) / 2, (p1 + p2) / 2


def phase_device() -> tuple:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    emit({"phase": "device", "name": name, "nvidia_smi": smi,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})
    return name, smi


def phase_build() -> None:
    t0 = time.perf_counter()
    path = build.build()
    build.load_library()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "library": path.name})


def frontend_yardsticks(name, x, window, mel, weights, out) -> dict:
    """B1's or B2's library call and bound on the bf16 main-path inputs.
    The library call is one bf16 matmul of the frames, materialised
    beforehand and not timed, with the kernel's B operand: B1's cos|sin
    bases ``[1024, 2 bins]``, B2's filterbank ``[1024, F]``."""
    frames = x.unfold(-1, FLEN, HOP).reshape(-1, FLEN).contiguous()
    n_rows = frames.shape[0]
    if name == "stft_melspec":
        bc, bs, mel_used = fe.stft_bases(window, mel)
        rhs = torch.from_numpy(np.concatenate([bc, bs], 1)).to(x.device, x.dtype)
        bins = bc.shape[1]
        ops = n_rows * (2 * 2 * FLEN * bins + 2 * bins * N_MELS)
        moved = nbytes(x, rhs, out) + bins * N_MELS * x.element_size()
    else:
        rhs = weights[:, 0, :].t().contiguous().to(x.dtype)
        ops = 2 * n_rows * FLEN * N_MELS
        moved = nbytes(x, rhs, out)
    return {"library_ms": time_ms(lambda: torch.matmul(frames, rhs)),
            "library": f"torch.matmul bf16 {list(frames.shape)} x {list(rhs.shape)}",
            **bound(moved, {"bf16": ops})}


def phase_kernels(dev) -> dict:
    rng = np.random.default_rng(SEED)
    audio = torch.from_numpy((rng.normal(size=(N_SEG, S)) * 0.1).astype(np.float32)).to(dev)
    window = (0.5 - 0.5 * np.cos(2 * np.pi * np.arange(FLEN) / FLEN)).astype(np.float32)
    mel = mel_weight_matrix(N_MELS, FLEN, 48_000, 150.0, 15_000.0).astype(np.float32)
    weights = torch.from_numpy(
        (rng.normal(size=(N_MELS, 1, FLEN)) * np.sqrt(2.0 / FLEN)).astype(np.float32)
    ).to(dev)
    cases = {
        "stft_melspec": (
            lambda x: fe.segments_stft_melspec(x, window, mel, hop=HOP),
            lambda x: fe.stft_melspec_plain(x, window, mel, hop=HOP),
            lambda x: fe.stft_melspec_reference(x, window, mel, hop=HOP),
        ),
        "filterbank_logpower": (
            lambda x: fe.segments_filterbank_logpower(x, weights, hop=HOP),
            lambda x: fe.filterbank_logpower_plain(x, weights, hop=HOP),
            lambda x: fe.filterbank_logpower_reference(
                x, weights.cpu().numpy(), hop=HOP),
        ),
    }
    summary = {}
    for name, (kernel, plain, oracle) in cases.items():
        for dtype in (torch.float32, torch.bfloat16):
            x = audio.to(dtype)
            got = kernel(x)
            torch.cuda.synchronize()
            want = plain(x)
            torch.cuda.synchronize()
            if got.shape != want.shape or got.shape != (N_SEG, N_MELS, 511):
                raise AssertionError(f"{name}: shape {tuple(got.shape)} vs {tuple(want.shape)}")
            err, ok = within(got, want, dtype)
            line = {"phase": "kernel", "name": name, "dtype": str(dtype).split(".")[1],
                    "max_abs_err_vs_plain": err, "ok": ok}
            if dtype == torch.float32:
                ref = torch.from_numpy(oracle(audio[:2].cpu().numpy()))
                oerr, ook = within(got[:2].cpu(), ref, dtype)
                line.update(max_abs_err_vs_f64_oracle=oerr, ok=ok and ook)
            ms, plain_ms = kernel_vs_plain_ms(lambda: kernel(x), lambda: plain(x))
            line.update(ms=ms, plain_ms=plain_ms,
                        us_per_segment=1e3 * ms / N_SEG,
                        plain_us_per_segment=1e3 * plain_ms / N_SEG)
            if dtype == torch.bfloat16:  # the dtype the main path runs
                line.update(frontend_yardsticks(name, x, window, mel, weights, got))
                line["share_of_bound"] = line["bound_ms"] / ms
            emit(line)
            if not line["ok"]:
                raise AssertionError(f"{name} ({dtype}) disagrees: {line}")
            if dtype == torch.bfloat16:
                summary[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                                 **{k: line[k] for k in ("library_ms", "library", "bound_ms",
                                                         "bound_by")}}
    phase_frontend_scale(dev, window, mel, weights)
    summary["qconv1x1_requant"] = phase_qconv(dev)
    summary["qconv1x1_requant_forward"] = phase_qconv_forward(dev)
    summary["stage_stack_forward"] = phase_stage_prefix(dev)
    summary["frame_filterbank_logpower"] = phase_frame_filterbank(dev, weights)
    return summary


def phase_frontend_scale(dev, window, mel, weights) -> None:
    """B1 and B2 with scale != 1: int16-range samples (as float32 and as
    bf16) times 1/32768 in the kernel, against the plain versions scaling
    the same way, within the bounds of the unscaled cases."""
    rng = np.random.default_rng(SEED + 7)
    pcm = torch.from_numpy(np.round(rng.normal(size=(4, S)) * 3000).astype(np.float32)).to(dev)
    scale = 1.0 / 32768.0
    cases = {
        "stft_melspec": (
            lambda x: fe.segments_stft_melspec(x, window, mel, hop=HOP, scale=scale),
            lambda x: fe.stft_melspec_plain(x, window, mel, hop=HOP, scale=scale)),
        "filterbank_logpower": (
            lambda x: fe.segments_filterbank_logpower(x, weights, hop=HOP, scale=scale),
            lambda x: fe.filterbank_logpower_plain(x, weights, hop=HOP, scale=scale)),
    }
    for name, (kernel, plain) in cases.items():
        for dtype in (torch.float32, torch.bfloat16):
            x = pcm.to(dtype)
            got = kernel(x)
            torch.cuda.synchronize()
            want = plain(x)
            err, ok = within(got, want, dtype)
            line = {"phase": "kernel", "name": name, "dtype": str(dtype).split(".")[1],
                    "scale": scale, "max_abs_err_vs_plain": err, "ok": ok}
            emit(line)
            if not ok:
                raise AssertionError(f"{name} ({dtype}, scale {scale}) disagrees: {line}")


def phase_stage_prefix(dev) -> dict:
    """B4 at the full-width six-block geometry on [32, 1, 96, 511], seeded
    random weights: bf16 with fast_act (the fast lowering), bf16 without it
    (bf16), and float32, each against its plain version. Returns the
    kernels-line summary (the fast lowering's case)."""
    rng = np.random.default_rng(SEED + 4)
    f = lambda *shape, s=1.0: (rng.normal(size=shape) * s).astype(np.float32)
    bws = [dict(w1=f(m, i, s=1.5 / np.sqrt(i)), b1=f(m, s=0.05), wd=f(m, 1, 3, 3, s=0.3),
                bd=f(m, s=0.05), se1=f(e, m, s=1 / np.sqrt(m)), bse1=f(e, s=0.05),
                se2=f(m, e, s=1 / np.sqrt(e)), bse2=f(m, s=0.05), w3=f(o, m, s=1 / np.sqrt(m)),
                b3=f(o, s=0.05))
           for i, m, e, o, _, _ in PREFIX_BLOCKS]
    stem_w, stem_b = f(32, 1, 3, 3, s=0.4), f(32, s=0.05)
    blocks = [spx.BlockGeom(*g) for g in PREFIX_BLOCKS]
    img = torch.from_numpy(f(N_SEG, 1, N_MELS, 511, s=0.5)).to(dev)
    summary = None
    for dtype, fast_act in ((torch.bfloat16, True), (torch.bfloat16, False),
                            (torch.float32, False)):
        tables = spx.prepare_weights(stem_w, stem_b, bws, blocks, dtype, dev)
        x = img.to(dtype)
        run = lambda: spx.stage_stack_forward(x, tables, fast_act)
        plain = lambda: spx.stage_stack_forward_plain(x, tables, fast_act)
        got = run()
        torch.cuda.synchronize()
        want = plain()
        torch.cuda.synchronize()
        if got.shape != want.shape or got.shape != (N_SEG, 80, 12, 64) or got.dtype != dtype:
            raise AssertionError(f"stage_stack_forward: shape {tuple(got.shape)} vs {tuple(want.shape)}")
        err = float((got.float() - want.float()).abs().max())
        scaled = err / float(want.float().abs().max())
        code_share = float((got != want).float().mean())
        dname = str(dtype).split(".")[1]
        ok = scaled <= PREFIX_TOL[dname] and bool(torch.isfinite(got).all())
        ms, plain_ms = kernel_vs_plain_ms(run, plain)
        line = {"phase": "kernel", "name": "stage_stack_forward", "dtype": dname,
                "fast_act": fast_act, "shape": [N_SEG, 1, N_MELS, 511],
                "max_abs_err_vs_plain": err, "scaled_err_vs_plain": scaled,
                "share_of_outputs_differing": code_share,
                "bound": PREFIX_TOL[dname], "ms": ms, "plain_ms": plain_ms,
                "us_per_segment": 1e3 * ms / N_SEG,
                "plain_us_per_segment": 1e3 * plain_ms / N_SEG, "ok": ok}
        emit(line)
        if not ok:
            raise AssertionError(f"stage_stack_forward disagrees with its plain version: {line}")
        if summary is None:
            summary = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "library_ms": None,
                       "library": "none: no one PyTorch call computes the stem and six "
                                  "MBConv blocks; the stream phase's split-0 rates "
                                  "compare B4 with the eager prefix",
                       **prefix_bound(x, got, tables)}
    return summary


def prefix_bound(x, out, tables) -> dict:
    """B4's bound on [N, 1, 96, 511]: the 1x1 expand and project products
    on the bf16 tensor cores, the stem, depthwise and squeeze-excite
    products on the f32 SIMT units; each input (image, weights) read and the
    output written once."""
    n, _, h, w = x.shape
    h, w = -(-h // 2), -(-w // 2)  # the stem's stride 2
    mma, simt = 0, tables.stem_w.shape[0] * 9 * h * w  # MACs; the stem's
    for c_in, c_mid, c_se, c_out, stride, _ in PREFIX_BLOCKS:
        mma += c_in * c_mid * h * w
        h, w = -(-h // stride), -(-w // stride)
        simt += 9 * c_mid * h * w + 2 * c_mid * c_se
        mma += c_mid * c_out * h * w
    weights = [tables.stem_w, tables.stem_b, *(t for block in tables.tables for t in block)]
    return bound(nbytes(x, out, *weights), {"bf16": 2 * n * mma, "fp32": 2 * n * simt})


def phase_frame_filterbank(dev, weights) -> dict:
    """B5 through its public function on a 32-segment int16 buffer at step
    144000 and 72000 (hop 280, K 1024, F 96) against its plain version and,
    on two windows, against the f64 oracle (the scaled windows through
    filterbank_logpower_reference, transposed to [T, F]). Its launches are
    the two compared calls. Returns the kernels-line summary (step 144000,
    the largest error of both). Its bound is the f32-accurate product on
    the card's fastest route, split TF32: three TF32 products."""
    rng = np.random.default_rng(SEED + 5)
    w = weights[:, 0, :]
    summary, worst = None, 0.0
    fe.LAUNCHES["frame_filterbank_logpower"] = 0
    for step in (S, S // 2):
        pcm = (rng.normal(size=(N_SEG - 1) * step + S) * 3000).clip(-32768, 32767)
        audio = torch.from_numpy(pcm.astype(np.int16)).to(dev)
        kw = dict(n_segments=N_SEG, step=step, sample_count=S, hop=HOP)
        got = fe.frame_filterbank_logpower(audio, w, **kw)
        torch.cuda.synchronize()
        want = fe.frame_filterbank_logpower_plain(audio, w, **kw)
        torch.cuda.synchronize()
        if got.shape != want.shape or got.shape != (N_SEG, 511, N_MELS):
            raise AssertionError(f"frame_filterbank_logpower: shape {tuple(got.shape)}")
        err, ok = within(got, want, torch.float32)
        worst = max(worst, err)
        scaled = audio.cpu().double() / 32768.0
        windows = torch.stack([scaled[i * step:i * step + S] for i in (0, N_SEG - 1)])
        oracle = torch.from_numpy(fe.filterbank_logpower_reference(
            windows.numpy(), w.cpu().numpy(), hop=HOP)).transpose(1, 2)
        oerr, ook = within(got[[0, N_SEG - 1]].cpu(), oracle, torch.float32)
        ok = ok and ook
        launches = fe.LAUNCHES["frame_filterbank_logpower"]
        ms, plain_ms = kernel_vs_plain_ms(
            lambda: fe.frame_filterbank_logpower(audio, w, **kw),
            lambda: fe.frame_filterbank_logpower_plain(audio, w, **kw))
        fe.LAUNCHES["frame_filterbank_logpower"] = launches
        line = {"phase": "kernel", "name": "frame_filterbank_logpower", "audio": "int16",
                "step": step, "max_abs_err_vs_plain": err, "max_abs_err_vs_f64_oracle": oerr,
                "ms": ms, "plain_ms": plain_ms,
                "us_per_segment": 1e3 * ms / N_SEG,
                "plain_us_per_segment": 1e3 * plain_ms / N_SEG, "ok": ok}
        emit(line)
        if not ok:
            raise AssertionError(f"frame_filterbank_logpower disagrees with its plain version: {line}")
        if summary is None:
            # The library call: one f32 matmul (TF32 off) of the scaled
            # frames, materialised beforehand and not timed.
            span = (511 - 1) * HOP + FLEN
            frames = (audio.float() / 32768.0).unfold(0, span, step)[:N_SEG].unfold(
                1, FLEN, HOP).reshape(-1, FLEN).contiguous()
            wt = w.t().contiguous()
            summary = {"ms": ms, "plain_ms": plain_ms,
                       "library_ms": time_ms(lambda: torch.matmul(frames, wt)),
                       "library": f"torch.matmul f32 {list(frames.shape)} x {list(wt.shape)}",
                       **bound(nbytes(audio, w, got),
                               {"tf32": 3 * 2 * N_SEG * 511 * FLEN * N_MELS})}
    summary["max_abs_err"] = worst
    return summary


def _qconv_case(rng, dev, c_in, c_out, n, hostile):
    """Inputs of one B3 call at batch 32. Random codes and scales that keep
    most outputs unsaturated; the hostile case has x_s * w_s = 0.15 and
    y_s = 0.3, whose float32 reciprocal is inexact."""
    if hostile:
        x = rng.integers(-10, 11, (N_SEG, c_in, n))
        w = rng.integers(-3, 4, (c_out, c_in))
        bias = rng.integers(-20, 21, c_out)
        scale, y_scale = np.full(c_out, 0.15, np.float32), 0.3
    else:
        x = rng.integers(-127, 128, (N_SEG, c_in, n))
        w = rng.integers(-127, 128, (c_out, c_in))
        bias = rng.integers(-5000, 5001, c_out)
        acc_std = np.sqrt(c_in) * 5418.0  # uniform int8 x int8 products
        scale = (rng.uniform(0.5, 1.5, c_out) / acc_std).astype(np.float32)
        y_scale = 3.0 / 127.0
    t = lambda a, dt: torch.from_numpy(np.ascontiguousarray(a).astype(dt)).to(dev)
    return (t(x, np.int8), t(w, np.int8), t(bias, np.int32), t(scale, np.float32),
            np.float32(y_scale))


def compare_codes(got, want, act) -> tuple:
    """(|Δ|, max |Δ|, codes differing, ok) of B3's codes against its plain
    version's: equal without an activation or with relu; with sigmoid/silu
    (exp may round differently) at most 1 code apart on at most
    QCONV_MAX_DIFF_SHARE of the codes."""
    diff = (got.int() - want.int()).abs()
    max_diff, n_diff = int(diff.max()), int((diff > 0).sum())
    if act in ("", "relu"):
        return diff, max_diff, n_diff, max_diff == 0
    return diff, max_diff, n_diff, max_diff <= 1 and n_diff <= QCONV_MAX_DIFF_SHARE * diff.numel()


def phase_qconv(dev) -> dict:
    """B3 against its plain version; returns the kernels-line summary (the
    first shape's times, the largest code difference over all cases)."""
    rng = np.random.default_rng(SEED + 2)
    cases = [(c_in, c_out, n, act, False) for c_in, c_out, n, act in QCONV_SHAPES]
    cases.append((8, 16, 48 * 256, "", True))
    summary = None
    worst = 0
    for c_in, c_out, n, act, hostile in cases:
        x, w, bias, scale, y_scale = _qconv_case(rng, dev, c_in, c_out, n, hostile)
        run = lambda: qc.qconv1x1_requant(x, w, bias, scale, y_scale, act)
        plain = lambda: qc.qconv1x1_requant_plain(x, w, bias, scale, y_scale, act)
        got = run()
        torch.cuda.synchronize()
        want = plain()
        torch.cuda.synchronize()
        if got.shape != want.shape or got.shape != (N_SEG, c_out, n) or got.dtype != torch.int8:
            raise AssertionError(f"qconv: shape {tuple(got.shape)} vs {tuple(want.shape)}")
        diff, max_diff, n_diff, ok = compare_codes(got, want, act)
        line = {"phase": "kernel", "name": "qconv1x1_requant",
                "shape": [N_SEG, c_in, n], "c_out": c_out, "act": act,
                "reciprocal_hostile": hostile, "max_code_diff": max_diff,
                "codes_differing": n_diff, "codes": diff.numel(),
                "unsaturated_share": float(((want > -128) & (want < 127)).float().mean())}
        if hostile:
            # What a multiply by the reciprocal would have given: the case
            # tests something only if that flips codes.
            acc = torch.matmul(w.double(), x.double()).to(torch.int32) + bias.reshape(1, -1, 1)
            v = acc.float() * scale.reshape(1, -1, 1)
            recip = 1.0 / torch.full((1,), float(y_scale), device=dev)
            flips = int((torch.round(v * recip).clamp(-128, 127).to(torch.int8) != want).sum())
            line["reciprocal_multiply_would_flip"] = flips
            ok = ok and flips > 0
        ms, plain_ms = kernel_vs_plain_ms(run, plain)
        line.update(ms=ms, plain_ms=plain_ms, us_per_image=1e3 * ms / N_SEG,
                    plain_us_per_image=1e3 * plain_ms / N_SEG, ok=ok)
        emit(line)
        if not ok:
            raise AssertionError(f"qconv1x1_requant disagrees with its plain version: {line}")
        worst = max(worst, max_diff)
        if summary is None:
            summary = {"ms": ms, "plain_ms": plain_ms, **qconv_yardsticks(x, w, bias, scale, got)}
    summary["max_abs_err"] = worst
    return summary


def qconv_yardsticks(x, w, bias, scale, out) -> dict:
    """B3's library call, ``torch._int_mm`` on ``[B·N, C_in] x [C_in,
    C_out]`` (the activations transposed beforehand, not timed; the first
    QCONV_SHAPES case meets its shape rules), and its bound."""
    b, c_in, n = x.shape
    xt = x.permute(0, 2, 1).reshape(-1, c_in).contiguous()
    return {"library_ms": time_ms(lambda: torch._int_mm(xt, w.t())),
            "library": f"torch._int_mm {list(xt.shape)} x {[c_in, w.shape[0]]}",
            **bound(nbytes(x, w, bias, scale, out), {"int8": 2 * b * n * c_in * w.shape[0]})}


# The v2.4 stage schedule (models/birdnet_v24.py): (c_in, c_out, stride,
# expand) per stage, two MBConv blocks each at full width.
V24_STAGES = [(32, 24, 1, 1), (24, 40, 2, 4), (40, 80, 2, 4), (80, 112, 2, 4),
              (112, 192, 2, 4), (192, 320, 1, 4)]


def qconv_forward_shapes() -> list:
    """(C_in, C_out, N, act) of the 49 int8 1x1 convs of the full-width
    v2.4 forward in graph order: per block the expand (silu), the
    squeeze-excite pair on the pooled map (silu, then sigmoid; N = 1) and
    the project, then the head conv. check_int8_nodes holds this list
    against the quantized graph."""
    shapes, h, w = [], 48, 256  # after the stride-2 stem on [96, 511]
    for c_in, c_out, stride, expand in V24_STAGES:
        for block in range(2):
            cin = c_in if block == 0 else c_out
            mid, s = cin * expand, stride if block == 0 else 1
            se = max(mid // 4, 4)
            shapes.append((cin, mid, h * w, "silu"))
            h, w = -(-h // s), -(-w // s)
            shapes += [(mid, se, 1, "silu"), (se, mid, 1, "sigmoid"), (mid, c_out, h * w, "")]
    shapes.append((320, 1280, h * w, "silu"))
    return shapes


def int_mm_ms(x, w):
    """torch._int_mm's device time on [B·N, C_in] x [C_in, C_out] (the
    activations transposed beforehand, not timed), or None where it refuses
    the shape: its own rules (more than 16 rows, K and N multiples of 8) or
    cuBLASLt's (CUBLAS_STATUS_NOT_SUPPORTED, raised before any launch)."""
    b, c_in, n = x.shape
    if b * n <= 16 or c_in % 8 or w.shape[0] % 8:
        return None
    xt = x.permute(0, 2, 1).reshape(-1, c_in).contiguous()
    try:
        torch._int_mm(xt, w.t())
    except RuntimeError as e:
        if "CUBLAS_STATUS_NOT_SUPPORTED" not in str(e):
            raise
        return None
    return time_ms(lambda: torch._int_mm(xt, w.t()))


def phase_qconv_forward(dev) -> dict:
    """B3 at each of the 49 1x1 convs of one int8 v2.4 forward at batch 32,
    each against its plain version (the codes rule of phase_qconv). Sums
    the kernel's device time, the plain version's, the bound and
    torch._int_mm's over the shapes its rules take (naming the others).
    Returns the kernels-line summary."""
    rng = np.random.default_rng(SEED + 7)
    launches = qc.LAUNCHES["qconv1x1_requant"]
    total = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "ms_where_library": 0.0,
             "bytes_ms": 0.0, "ops_ms": 0.0, "bound_ms": 0.0}
    per_shape, rejected, worst = [], [], 0
    for c_in, c_out, n, act in qconv_forward_shapes():
        x, w, bias, scale, y_scale = _qconv_case(rng, dev, c_in, c_out, n, False)
        run = lambda: qc.qconv1x1_requant(x, w, bias, scale, y_scale, act)
        plain = lambda: qc.qconv1x1_requant_plain(x, w, bias, scale, y_scale, act)
        got = run()
        torch.cuda.synchronize()
        want = plain()
        _, max_diff, n_diff, ok = compare_codes(got, want, act)
        if got.shape != (N_SEG, c_out, n) or not ok:
            raise AssertionError(f"qconv forward {c_in}->{c_out} N {n} {act}: shape "
                                 f"{tuple(got.shape)}, max code diff {max_diff} on {n_diff}")
        worst = max(worst, max_diff)
        ms, plain_ms = kernel_vs_plain_ms(run, plain)
        mem_s = nbytes(x, w, bias, scale, got) / HBM_BYTES_PER_S
        ops_s = 2 * N_SEG * n * c_in * c_out / PEAK_OPS_PER_S["int8"]
        total["ms"] += ms
        total["plain_ms"] += plain_ms
        total["bytes_ms"] += 1e3 * mem_s
        total["ops_ms"] += 1e3 * ops_s
        total["bound_ms"] += 1e3 * max(mem_s, ops_s)
        lib_ms = int_mm_ms(x, w)
        if lib_ms is None:
            rejected.append(f"{c_in}->{c_out} N {n}")
        else:
            total["library_ms"] += lib_ms
            total["ms_where_library"] += ms
        per_shape.append([c_in, c_out, n, act, ms, lib_ms])
    qc.LAUNCHES["qconv1x1_requant"] = launches
    line = {"phase": "kernel", "name": "qconv1x1_requant_forward", "shapes": len(per_shape),
            "batch": N_SEG, **total, "us_per_image": 1e3 * total["ms"] / N_SEG,
            "library_rejects": rejected, "per_shape_ms_and_library_ms": per_shape, "ok": True}
    emit(line)
    return {"ms": total["ms"], "plain_ms": total["plain_ms"], "max_abs_err": worst,
            "library_ms": total["library_ms"],
            "library": f"torch._int_mm summed over {len(per_shape) - len(rejected)} of the "
                       f"{len(per_shape)} shapes (the product only; the kernel takes "
                       f"{total['ms_where_library']:.4f} ms on those); it refuses "
                       + ", ".join(rejected),
            "bound_ms": total["bound_ms"],
            "bound_by": "bytes" if total["bytes_ms"] >= total["ops_ms"] else "operations"}


def seg_per_s(clf, segs, calls: int = 10) -> float:
    """Median segments/s of ``calls`` predict_batch calls (host clock; each
    call ends with the results on the host), after one warm call."""
    clf.predict_batch(segs)
    rates = []
    for _ in range(calls):
        t0 = time.perf_counter()
        clf.predict_batch(segs)
        rates.append(len(segs) / (time.perf_counter() - t0))
    return statistics.median(rates)


FRONTEND_KERNEL = {"conv": "filterbank_logpower", "stft": "stft_melspec"}
LABELS = [f"Genus{i}_species{i}_Common {i}" for i in range(birdnet_v24.NUM_SPECIES)]


def logits_of(results) -> np.ndarray:
    return np.stack([r.raw_scores for r in results])


def phase_slice(card: str, segs: np.ndarray, paths: dict) -> tuple:
    """The float path at ``fast``. Returns (its launch counts, the fp32
    logits per frontend, the fast classifiers per frontend)."""
    fast = {}
    ref_logits_of = {}
    # The main path's run: every count starts at 0 here.
    reset_launches()
    for frontend, counter in FRONTEND_KERNEL.items():
        before = read_launches()
        clf = (Classifier.builder().model_path(paths[frontend]).labels(LABELS)
               .precision("fast").top_k(5).build())
        one = clf.predict(segs[0])
        batch = clf.predict_batch(segs)
        after = read_launches()
        for kname in (counter, "stage_stack_forward"):
            if after[kname] <= before[kname]:
                raise AssertionError(f"{frontend}: the {kname} kernel never ran")
        fast[frontend] = (clf, one, batch)
    launches = read_launches()

    for frontend, (clf, one, batch) in fast.items():
        ref = (Classifier.builder().model_path(paths[frontend]).labels(LABELS)
               .precision("fp32").top_k(5).build())
        ref_batch = ref.predict_batch(segs)
        logits = logits_of(batch)
        ref_logits = ref_logits_of[frontend] = logits_of(ref_batch)
        if logits.shape != (N_SEG, birdnet_v24.NUM_SPECIES) or not np.isfinite(logits).all():
            raise AssertionError(f"{frontend}: logits {logits.shape}, finite={np.isfinite(logits).all()}")
        if len(one.predictions) != 5 or len(batch[0].predictions) != 5:
            raise AssertionError(f"{frontend}: expected 5 predictions per segment")
        one_vs_batch = float(np.abs(one.raw_scores - batch[0].raw_scores).max()
                             / np.abs(batch[0].raw_scores).max())
        if not one_vs_batch < SCALED_LOGIT_TOL:
            raise AssertionError(f"{frontend}: predict vs predict_batch row 0: {one_vs_batch}")
        scaled = float(np.abs(logits - ref_logits).max() / np.abs(ref_logits).max())
        top1 = int((logits.argmax(1) == ref_logits.argmax(1)).sum())
        mixed = (Classifier.builder().model_path(paths[frontend]).labels(LABELS)
                 .precision("mixed").top_k(5).build())
        mixed_logits = logits_of(mixed.predict_batch(segs))
        mixed_scaled = float(np.abs(mixed_logits - ref_logits).max() / np.abs(ref_logits).max())
        mixed_top1 = int((mixed_logits.argmax(1) == ref_logits.argmax(1)).sum())
        rates = {policy: seg_per_s(c, segs)
                 for policy, c in (("fast", clf), ("mixed", mixed), ("fp32", ref))}
        line = {"phase": "slice", "frontend": frontend, "kernel": FRONTEND_KERNEL[frontend],
                "card": card,
                "scaled_max_abs_logit_diff_fast_vs_fp32": scaled,
                "top1_agree": f"{top1}/{N_SEG}",
                "scaled_max_abs_logit_diff_mixed_vs_fp32": mixed_scaled,
                "top1_agree_mixed": f"{mixed_top1}/{N_SEG}",
                "predict_batch32_seg_per_s_fast": rates["fast"],
                "predict_batch32_seg_per_s_mixed": rates["mixed"],
                "predict_batch32_seg_per_s_fp32": rates["fp32"],
                "ok": (scaled < SCALED_LOGIT_TOL and top1 >= MIN_TOP1_AGREE
                       and mixed_scaled < SCALED_LOGIT_TOL and mixed_top1 >= MIN_TOP1_AGREE)}
        emit(line)
        if not line["ok"]:
            raise AssertionError(f"{frontend}: fast or mixed disagrees with fp32: {line}")
    return launches, ref_logits_of, {f: c for f, (c, _, _) in fast.items()}


def streamed(clf, pcm, overlap: float, options=None) -> tuple:
    """(conf [N, K], idx [N, K], seconds) of analyze_samples."""
    t0 = time.perf_counter()
    out = clf.analyze_samples(pcm, overlap_seconds=overlap, options=options)
    seconds = time.perf_counter() - t0
    conf = np.array([[p.confidence for p in preds] for _, preds in out], np.float32)
    idx = np.array([[p.index for p in preds] for _, preds in out], np.int64)
    return conf, idx, seconds


def stream_rate(clf, pcm) -> float:
    """Sustained segments/s of one analyze_samples over the recording
    (host clock; it ends with the results on the host)."""
    conf, _, seconds = streamed(clf, pcm, 0.0)
    return conf.shape[0] / seconds


def with_split_zero(fn):
    """``fn()`` with ``BIRDNET_STAGE123_SPLIT=0``: the stage prefix runs
    eagerly, without B4."""
    os.environ["BIRDNET_STAGE123_SPLIT"] = "0"
    try:
        return fn()
    finally:
        os.environ.pop("BIRDNET_STAGE123_SPLIT", None)


def phase_stream(card: str, fast: dict) -> dict:
    """Streaming on the full-width ``fast`` classifiers over one hour of
    seeded int16 audio, at the engine's default tile and at tile 32.
    Returns its launch counts.

    What decides that its output is right: the streamed top-K against
    predict_batch on the same segments, framed on the host and scaled as
    the device scales int16 (× 1/32768), in batches of the stream's tile."""
    pcm = (np.random.default_rng(SEED + 6).standard_normal(HOUR, dtype=np.float32) * 3000
           ).clip(-32768, 32767).astype(np.int16)
    audio_f32 = pcm.astype(np.float32) / 32768.0
    default_tile = next(iter(fast.values()))._streaming_engine().tile
    check_tiles = tuple(dict.fromkeys((default_tile, 32)))
    # The main path's run: every count starts at 0 here.
    reset_launches()
    runs = {}
    for frontend, counter in FRONTEND_KERNEL.items():
        before = read_launches()
        eng = fast[frontend]._streaming_engine()
        for tile in check_tiles:
            eng.tile = tile
            runs[frontend, tile, 0.0] = streamed(fast[frontend], pcm, 0.0)
            # A timeout makes the run monitored: 16-tile superchunks, two in
            # flight.
            runs[frontend, tile, 1.5] = streamed(fast[frontend], pcm, 1.5,
                                                 InferenceOptions(timeout=600.0))
        eng.tile = default_tile
        after = read_launches()
        for kname in (counter, "stage_stack_forward"):
            if after[kname] <= before[kname]:
                raise AssertionError(f"stream {frontend}: the {kname} kernel never ran")
    launches = read_launches()

    for (frontend, tile, overlap), (conf, idx, seconds) in runs.items():
        clf = fast[frontend]
        segs, _ = chunk_audio(audio_f32, S, overlap, 48_000)
        ref_conf, ref_idx = [], []
        for i in range(0, segs.shape[0], tile):
            # The stream zero-pads its last tile; so does the reference, so
            # that both run the same batch shapes (cuBLAS may pick another
            # kernel, and sum in another order, for another batch size).
            batch = segs[i:i + tile]
            n = batch.shape[0]
            batch = np.concatenate([batch, np.zeros((tile - n, S), np.float32)])
            for r in clf.predict_batch(batch)[:n]:
                ref_conf.append([p.confidence for p in r.predictions])
                ref_idx.append([p.index for p in r.predictions])
        ref_conf, ref_idx = np.array(ref_conf, np.float32), np.array(ref_idx)
        if conf.shape != ref_conf.shape or not np.isfinite(conf).all():
            raise AssertionError(f"stream {frontend} {overlap}: {conf.shape} vs {ref_conf.shape}")
        conf_diff = float(np.abs(conf - ref_conf).max())
        clear = ref_conf[:, 0] - ref_conf[:, 1] > STREAM_CONF_TOL
        top1_clear = int((idx[clear, 0] == ref_idx[clear, 0]).sum())
        line = {"phase": "stream", "frontend": frontend, "overlap_s": overlap,
                "segments": int(conf.shape[0]), "card": card, "tile": tile,
                "monitored": overlap > 0, "seconds": seconds,
                "seg_per_s": conf.shape[0] / seconds,
                "max_conf_diff_vs_predict_batch": conf_diff,
                "top1_equal_where_clear": f"{top1_clear}/{int(clear.sum())}",
                "top1_equal_all": int((idx[:, 0] == ref_idx[:, 0]).sum()),
                "ok": conf_diff <= STREAM_CONF_TOL and top1_clear == int(clear.sum())}
        emit(line)
        if not line["ok"]:
            raise AssertionError(f"stream {frontend} {overlap} disagrees with predict_batch: {line}")

    for frontend, clf in fast.items():
        eng = clf._streaming_engine()
        # One untimed call per setting first: tile 64 has not run yet, the
        # first float32 call sizes a pinned buffer twice as large, and the
        # first split-0 call loads the eager prefix's kernels.
        eng.tile = 64
        stream_rate(clf, pcm)
        eng.tile = default_tile
        stream_rate(clf, audio_f32)
        with_split_zero(lambda: stream_rate(clf, pcm))
        # In turns, so that the host clock's drift falls on both sides.
        tiles = {}
        for tile in (32, 64, 128, 128, 64, 32):
            eng.tile = tile
            tiles.setdefault(tile, []).append(stream_rate(clf, pcm))
        eng.tile = default_tile
        inputs = {"int16": [], "float32": []}
        for name in ("int16", "float32", "float32", "int16"):
            inputs[name].append(stream_rate(clf, pcm if name == "int16" else audio_f32))
        split = {"default": [], "0": []}
        for name in ("default", "0", "0", "default"):
            split[name].append(with_split_zero(lambda: stream_rate(clf, pcm)) if name == "0"
                               else stream_rate(clf, pcm))
        emit({"phase": "stream_rates", "frontend": frontend, "card": card,
              "segments": HOUR // S, "default_tile": default_tile,
              "seg_per_s_by_tile": tiles, "seg_per_s_by_input": inputs,
              "seg_per_s_by_split": split})
    for frontend, clf in fast.items():
        emit({"phase": "stream_profile", "frontend": frontend, "card": card,
              "tile": default_tile, **stream_profile(clf, pcm)})
    return launches


DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
# B4's kernels, by the names csrc/stage_prefix.cu gives them.
B4_KERNELS = ("stem_kernel", "expand_dw", "se_gate_kernel", "se_project")


def stream_profile(clf, pcm) -> dict:
    """torch.profiler over one analyze_samples call: its wall time, the
    device's busy time (the union of its kernel, copy and set intervals),
    the idle share 1 - busy / wall, B4's device time (its kernels summed)
    and the ten device items with the most time (ms, launches). The
    profiler slows the host, so the profiled wall time runs above the
    unprofiled one."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        clf.analyze_samples(pcm)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    with tempfile.TemporaryDirectory() as tmp:
        trace = os.path.join(tmp, "stream.json")
        prof.export_chrome_trace(trace)
        events = json.loads(Path(trace).read_text())["traceEvents"]
    spans, by_name = [], {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in DEVICE_CATEGORIES:
            spans.append((e["ts"], e["ts"] + e["dur"]))
            total, count = by_name.get(e["name"], (0.0, 0))
            by_name[e["name"]] = (total + e["dur"], count + 1)
    busy, end = 0.0, -1.0
    for s, t in sorted(spans):
        if t > end:
            busy += t - max(s, end)
            end = t
    if busy <= 0.0:
        raise AssertionError("stream profile: no device interval in the trace")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    b4 = [(total, count) for name, (total, count) in by_name.items()
          if any(k in name for k in B4_KERNELS)]
    return {"wall_ms": wall_ms, "device_busy_ms": busy / 1e3,
            "idle_share": 1.0 - busy / 1e3 / wall_ms,
            "b4_device_ms": sum(t for t, _ in b4) / 1e3, "b4_launches": sum(c for _, c in b4),
            "top_device_items_ms": [(name[:90], total / 1e3, count)
                                    for name, (total, count) in top]}


def int8_agreement(ref: np.ndarray, logits: np.ndarray) -> dict:
    """int8 logits against the float file's fp32 logits (the measures of
    tests/test_quantize.py)."""
    top3 = np.argsort(logits, axis=1)[:, -3:]
    holds = int(sum(win in top3[i] for i, win in enumerate(ref.argmax(axis=1))))
    corr = [float(np.corrcoef(a, b)[0, 1]) for a, b in zip(ref, logits)]
    return {"fp32_winner_in_int8_top3": holds, "rows": len(ref),
            "min_row_logit_correlation": min(corr),
            "median_row_logit_correlation": float(np.median(corr)),
            "scaled_max_abs_logit_diff_vs_fp32":
                float(np.abs(logits - ref).max() / np.abs(ref).max())}


def check_int8_nodes(path: str, policy: str, segs: np.ndarray) -> dict:
    """Every node of the full-width int8 graph run on the card, against the
    same node's lowering on the CPU fed the card's own inputs, so that no
    rounding difference upstream can spread. Integer outputs must be equal,
    except after a sigmoid/silu/tanh requantize epilogue (exp and tanh round
    differently on the two devices): there at most 1 code apart, on at most
    QCONV_MAX_DIFF_SHARE of all such codes of the graph. Float outputs agree
    within FLOAT_NODE_TOL[policy] of the output's largest magnitude."""
    dev, cpu = CARD, torch.device("cpu")
    model = quantize_model(import_onnx(path), synthetic_calibration_segments(S), device=dev)
    env = dict(consts_to_device(model.consts, dev))
    env.update(params_to_torch(model.params, dev))
    env[model.input_names[0]] = torch.from_numpy(segs).to(dev)
    with torch.inference_mode():
        interpret_graph(model.graph, model.opset, policy, env, model.output_names, dev)
    host = {k: v.cpu() if isinstance(v, torch.Tensor) else v for k, v in env.items()}
    nodes, worst_code, worst_float = {}, 0, 0.0
    transcendental = {"codes": 0, "differing": 0}
    with torch.inference_mode():
        for node in model.graph.node:
            args = [host[i] if i else None for i in node.input]
            while args and args[-1] is None:
                args.pop()
            ctx = OpContext(node.op_type, node.attrs, model.opset, policy, node.name,
                            len(node.output), env=host, out_names=node.output, device=cpu)
            outs = get_lowering(node.op_type, node.domain)(ctx, *args)
            for name, want in zip(node.output, outs):
                got = host[name]
                if not isinstance(want, torch.Tensor):
                    want = torch.from_numpy(np.asarray(want))
                if got.shape != want.shape or got.dtype != want.dtype:
                    raise AssertionError(f"{node.op_type} {name}: card {got.dtype} "
                                         f"{tuple(got.shape)}, CPU {want.dtype} {tuple(want.shape)}")
                if got.is_floating_point():
                    ref = want.float().abs().max().clamp_min(1e-30)
                    err = float((got.float() - want.float()).abs().max() / ref)
                    ok = err <= FLOAT_NODE_TOL[policy]
                    worst_float = max(worst_float, err)
                else:
                    diff = (got.long() - want.long()).abs()
                    max_diff = int(diff.max()) if diff.numel() else 0
                    if node.op_type == "QLinearConv" and node.attrs.get("_fused_act", "") in (
                            "sigmoid", "silu", "tanh"):
                        transcendental["codes"] += diff.numel()
                        transcendental["differing"] += int((diff > 0).sum())
                        ok = max_diff <= 1
                    else:
                        ok = max_diff == 0
                    worst_code = max(worst_code, max_diff)
                if not ok:
                    raise AssertionError(f"int8 node {node.op_type} {name} ({policy}) differs "
                                         f"between the card and the CPU: code diff "
                                         f"{worst_code}, scaled float diff {worst_float}")
            nodes[node.op_type] = nodes.get(node.op_type, 0) + 1
    # The B3 shapes of the kernel phase's forward line are this graph's.
    b3 = [(int(host[n.input[0]].shape[1]), int(host[n.input[3]].shape[0]),
           int(host[n.input[0]].shape[2] * host[n.input[0]].shape[3]),
           n.attrs.get("_fused_act", ""))
          for n in model.graph.node
          if n.op_type == "QLinearConv" and tuple(host[n.input[3]].shape[2:]) == (1, 1)]
    if b3 != qconv_forward_shapes():
        raise AssertionError(f"the int8 graph's 1x1 convs {b3} are not qconv_forward_shapes()")
    result = {"nodes_checked": nodes, "max_code_diff": worst_code,
              "max_scaled_float_diff": worst_float, "b3_shapes_as_forward_line": len(b3),
              "transcendental_epilogue_codes": transcendental}
    if transcendental["differing"] > QCONV_MAX_DIFF_SHARE * transcendental["codes"]:
        raise AssertionError(f"int8 nodes ({policy}): {result}")
    return result


def phase_int8(card: str, segs: np.ndarray, paths: dict, tiny_paths: dict,
               ref_logits_of: dict, float_fast: dict) -> dict:
    """The int8 path (synthetic calibration) at ``fast`` and ``mixed`` on
    the full-width files. Returns its launch counts.

    What decides that its output is right: each node of the full-width int8
    graph on the card against the CPU lowering of the same node
    (check_int8_nodes), and the agreement bound of tests/test_quantize.py on
    a small model calibrated on audio like the rows it classifies. The
    full-width agreement with the fp32 float model is printed but decides
    nothing: with random weights the full-width int8 model is chaotic (a
    1e-6 relative change of the input moves its logits by about 0.15-0.19 of
    their largest magnitude, the fp32 model's by 1e-5), so that bound
    measures the random model, not the port. The JAX package's own int8
    model misses it as well at half width."""
    reset_launches()
    int8 = {}
    for frontend, counter in FRONTEND_KERNEL.items():
        for policy in ("fast", "mixed"):
            before = read_launches()
            clf = (Classifier.builder().model_path(paths[frontend]).labels(LABELS)
                   .precision(policy).top_k(5).int8().build())
            one = clf.predict(segs[0])
            batch = clf.predict_batch(segs)
            after = read_launches()
            ran = [k for k in after if after[k] > before[k]]
            need = ["qconv1x1_requant"] + ([counter] if policy == "fast" else [])
            if any(k not in ran for k in need):
                raise AssertionError(f"int8 {frontend} {policy}: kernels {need} must run, ran {ran}")
            int8[frontend, policy] = (clf, one, batch)
    launches = read_launches()

    for (frontend, policy), (clf, one, batch) in int8.items():
        logits = logits_of(batch)
        if logits.shape != (N_SEG, birdnet_v24.NUM_SPECIES) or not np.isfinite(logits).all():
            raise AssertionError(f"int8 {frontend} {policy}: logits {logits.shape}, "
                                 f"finite={np.isfinite(logits).all()}")
        if len(one.predictions) != 5 or len(batch[0].predictions) != 5:
            raise AssertionError(f"int8 {frontend} {policy}: expected 5 predictions per segment")
        line = {"phase": "int8", "frontend": frontend, "policy": policy, "card": card,
                "full_width_vs_fp32": int8_agreement(ref_logits_of[frontend], logits)}
        line["nodes_card_vs_cpu"] = check_int8_nodes(paths[frontend], policy, segs[:4])
        if policy == "fast":
            # In turns: float fast, int8 fast, int8 mixed, float fast.
            rates = [seg_per_s(float_fast[frontend], segs), seg_per_s(clf, segs),
                     seg_per_s(int8[frontend, "mixed"][0], segs),
                     seg_per_s(float_fast[frontend], segs)]
            line.update(predict_batch32_seg_per_s_int8_fast=rates[1],
                        predict_batch32_seg_per_s_int8_mixed=rates[2],
                        predict_batch32_seg_per_s_float_fast=(rates[0] + rates[3]) / 2)
        # The small model, calibrated on a [16, S] stack of audio drawn as
        # the rows are: the fp32 winner in the int8 top-3, every row's logit
        # correlation.
        calibration = (np.random.default_rng(SEED + 3).normal(size=(16, S)) * 0.1
                       ).astype(np.float32)
        small = lambda b: b.model_path(tiny_paths[frontend]).labels(LABELS).top_k(5)
        small_ref = logits_of(small(Classifier.builder()).precision("fp32").build()
                              .predict_batch(segs))
        small_q = logits_of(small(Classifier.builder()).precision(policy)
                            .int8(calibration).build().predict_batch(segs))
        agree = line["small_model_vs_fp32"] = int8_agreement(small_ref, small_q)
        line["ok"] = (agree["fp32_winner_in_int8_top3"] >= MIN_TOP3_HOLDS_FP32_WINNER
                      and agree["min_row_logit_correlation"] >= MIN_LOGIT_CORRELATION)
        emit(line)
        if not line["ok"]:
            raise AssertionError(f"int8 {frontend} {policy} disagrees with fp32: {line}")
    return launches


def mixed_rates(card: str) -> dict:
    """predict_batch(32)'s segments/s under mixed (the card's per-call
    default) on the full-width files, per frontend."""
    rng = np.random.default_rng(SEED + 1)
    segs = (rng.normal(size=(N_SEG, S)) * 0.1).astype(np.float32)
    rates = {}
    with tempfile.TemporaryDirectory() as tmp:
        for frontend in FRONTEND_KERNEL:
            path = str(Path(tmp) / f"birdnet_v24_{frontend}.onnx")
            P.save_model(birdnet_v24.build_model(seed=SEED, frontend=frontend), path)
            clf = (Classifier.builder().model_path(path).labels(LABELS)
                   .precision("mixed").top_k(5).build())
            rates[frontend] = seg_per_s(clf, segs)
    return rates


def main_ab() -> int:
    """``--ab``: B4 at the full-width geometry, B5 at int16 step 144000
    (and 72000), the B3 forward sum and predict_batch(32) under mixed, only
    through wrappers and entry points whose signatures every tree of the port
    with B4 shares, so that this script beside another tree's package times that
    tree's kernels. Prints one line per phase and an "ab" line naming the
    package."""
    _, smi = phase_device()
    phase_build()
    rng = np.random.default_rng(SEED)
    weights = torch.from_numpy(
        (rng.normal(size=(N_MELS, 1, FLEN)) * np.sqrt(2.0 / FLEN)).astype(np.float32)).to(CARD)
    emit({"ab": str(Path(fe.__file__).resolve().parents[2]), "card": smi,
          "stage_stack_forward": phase_stage_prefix(CARD),
          "frame_filterbank_logpower": phase_frame_filterbank(CARD, weights),
          "qconv1x1_requant_forward": phase_qconv_forward(CARD),
          "predict_batch32_seg_per_s_mixed": mixed_rates(smi)})
    return 0


def main() -> int:
    if sys.argv[1:] == ["--ab"]:
        return main_ab()
    name, smi = phase_device()
    phase_build()
    summary = phase_kernels(CARD)
    b5_launches = fe.LAUNCHES["frame_filterbank_logpower"]
    rng = np.random.default_rng(SEED + 1)
    segs = (rng.normal(size=(N_SEG, S)) * 0.1).astype(np.float32)
    with tempfile.TemporaryDirectory() as tmp:
        paths, tiny_paths = {}, {}
        for frontend in FRONTEND_KERNEL:
            paths[frontend] = str(Path(tmp) / f"birdnet_v24_{frontend}.onnx")
            P.save_model(birdnet_v24.build_model(seed=SEED, frontend=frontend),
                         paths[frontend])
            tiny_paths[frontend] = str(Path(tmp) / f"birdnet_v24_{frontend}_small.onnx")
            P.save_model(birdnet_v24.build_model(seed=SEED, frontend=frontend, **SMALL),
                         tiny_paths[frontend])
        float_launches, ref_logits_of, float_fast = phase_slice(smi, segs, paths)
        stream_launches = phase_stream(smi, float_fast)
        int8_launches = phase_int8(smi, segs, paths, tiny_paths, ref_logits_of, float_fast)
    # Each kernel's launches on its paths; B5's from its kernel phase.
    launches = {k: float_launches[k] + stream_launches[k] + int8_launches[k]
                for k in float_launches}
    launches["frame_filterbank_logpower"] = b5_launches
    launches["qconv1x1_requant_forward"] = launches["qconv1x1_requant"]
    kernels = []
    for kname, s in summary.items():
        if launches[kname] <= 0:
            raise AssertionError(f"{kname} was not launched on any of its paths")
        kernels.append({"name": kname, "route": "cuda", "source": SOURCES[kname],
                        "replaces": REPLACES[kname], "launches": launches[kname],
                        "max_abs_err": s["max_abs_err"], "ms": s["ms"],
                        "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"],
                        "bound_by": s["bound_by"], "library_ms": s["library_ms"],
                        "library": s["library"]})
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
