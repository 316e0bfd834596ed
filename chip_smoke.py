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
             Classifier on each at precision "fast" (through
             with_tpu(TPUConfig(precision="fast", device_id=0)), the JAX
             package's device config on the card), runs predict and
             predict_batch(32), checks that the frontend kernel and B4 ran,
             and compares the logits with the same file at "fp32"; prints
             predict_batch(32)'s rate at fast, mixed (the card's per-call
             default, whose logits must agree with fp32 as fast's do) and
             fp32.
5. stream  — on the same "fast" classifiers, analyze_samples over a seeded
             one-hour int16 recording at overlap 0 and 1.5 s (the second
             with a timeout, so 16-tile superchunks, two in flight), at the
             default tile and at tile 32, each key replaying its captured
             CUDA graphs (one per ring slot); checks that the frontend
             kernel and B4 ran (each replay counts its graph's launches),
             that the streamed top-K equals predict_batch on the same
             segments framed on the host, in batches of the tile (the last
             zero-padded, as the stream pads it), and that the graphs equal
             the same engine's eager tile loop bit for bit; prints the keys
             (none eager) and graphs; streams 10 more hours (the key count
             unchanged, device memory within 1 MiB of the first hour's);
             prints sustained segments/s at tile 32, 64 and 128, for int16
             against float32 input, B4 (the default) against a classifier
             built and captured under BIRDNET_STAGE123_SPLIT=0 (a captured
             graph keeps its split), and the graphs against the eager loop,
             each pair in turns; then profiles streamed hours per form at
             the default tile, graph and eager in turns (torch.profiler: the
             device's busy time, its idle share and the largest device
             items).
6. int8    — on the same files, builds int8 Classifiers (synthetic
             calibration) at "fast" (B1 or B2, and B3) and at "mixed" (B3),
             runs predict and predict_batch(32) and checks that the kernels
             ran; checks every node of the full-width int8 graph on the
             card against the same node on the CPU, and the int8 logits of
             a small v2.4 model against its fp32 logits; streams ten
             minutes through the int8 conv file's graphs at fast (B3
             counted per replay), bit for bit against its eager tile loop.

7. families — full-width BirdNET v3.0 (6522 species, embeddings 1024) and
             Perch v2 (14795 species, embeddings 1536) files in both
             frontend forms: predict and predict_batch(32) at fast (B2 or
             B1 must run), mixed and fp32; fast and mixed held to fp32
             (scaled max |Δ| < 1e-1 on the logits and the embeddings; top-1
             equal wherever fp32's winner leads by more than CLEAR_LEAD, the
             count printed beside it); predict_batch(32) rates; one streamed
             hour of int16 at 32 kHz (720 segments) per classifier at fast
             against predict_batch on the same segments (the stream
             phase's rule) and embed_samples against predict_batch's
             embeddings, with sustained rates, both through the keys'
             graphs and bit for bit against the eager tile loop; then B1 and B2 at each
             family's geometry (hop 312 with 96 columns, hop 320 with 128;
             160000-sample segments) against their plain versions, with
             device time, bound and library call (kernel_geometry lines).
8. range    — the full-size meta model on the card against the CPU: every
             score within 1e-5, the same filtered predictions.
9. checkpoint — full-width v2.4 saved to .btck on the card and built from
             it: fp32 logits bitwise equal to the ONNX-built classifier's.
9b. dtypes  — full-width v2.4 (conv) re-stored in the three weight forms of
             tests/_torch_dtype_forms.py (bfloat16-stored with Cast,
             FLOAT8E4M3FN with DequantizeLinear per output channel, INT4 in
             blocks of 32 with DequantizeLinear(block_size=32)), each beside
             its yardstick file (the dequantized float32 weights, same
             graph). Per form: fp32 on the card within DTYPES_TOL of the
             yardstick's logit scale (TF32 off) and of the port on the host
             (4 rows); fast top-1 equal where fp32's lead exceeds CLEAR_LEAD
             and twice the yardstick's own fast-vs-fp32 drift, and on at
             least MIN_TOP1_AGREE rows (the slice phase's v2.4 rule);
             ten streamed minutes at fp32 against predict_batch (top-K
             equal, confidences within STREAM_CONF_TOL); the batch context
             bitwise against predict_batch at fast; a .btck round trip
             bitwise; the kernels launched; predict_batch(32), batch context
             and one streamed hour at tile 128 under fast, each in turns with
             the yardstick. ml_dtypes must never have been imported. The
             fourth form, bf16_direct (the SE convs of the last two blocks
             read a BFLOAT16 weight and bias directly between Casts), rounds
             its activations there on every device: its fp32 card within
             DIRECT_TOL of the host, its distance from the yardstick
             printed; then its .int8() on the card (the dtypes_int8 line:
             QLinearConv count equal to the host's, every int8 node against
             its CPU lowering, B3 launched).
9c. concurrency — one full-width v2.4 (conv) classifier at fast: four
             threads stream ten minutes of int16 each while a fifth makes
             the first batch context (its capture) and calls it and
             predict_batch(32); then four new streaming keys captured beside
             a second context; then a round on the same keys. Every answer
             bitwise equal to the serial call's, no error, the keys and the
             device memory unchanged by the last round, B2 and B4 launched.
10. batch context — full-width v2.4 (conv) at fast: create_batch_context(32)
             captures its CUDA graph (B2 and B4 count their launches
             there); top-K and logits against predict_batch on a full
             batch and on a batch of 7 (bitwise against the batch padded as
             the context pads it); a profiler trace of one replay shows B2's
             and B4's kernels; its rate against predict_batch(32) in turns.
11. serve   — ``make_server`` over full-width v2.4 (conv, fast) with the
             full-size meta model, one batcher worker and then two: 1,024 i16
             predicts from 64 client threads through ServeClient, each
             against the batch context on the same segment; two
             /v1/analyze posts of a 60 s WAV during that traffic against
             analyze_samples; /v1/rangefilter and a predict with a place and
             date against RangeFilter.predict; device memory flat across the
             1,024 requests; requests/s at concurrency 64 and /v1/metrics'
             latencies and batch fill, in turns with
             predict_batch_with_context(32)'s seg/s. Then full-width Perch v2
             (conv, fast, no batch context): 8 predicts with embeddings and
             one /v1/embed of 60 s against predict_batch and embed_samples.
12. cli     — ``python -m birdnet_tpu_torch.cli`` in subprocesses on a 60 s
             48 kHz WAV with the full-width v2.4 file: streamed and
             --no-stream (the batch context) give the same CSV rows; once
             more with the range filter; --list-providers names the card.

13. exported — exporter-written files at full width: a torch module with
             models/birdnet_v24.py's schedule and a learned log1p(t*t)
             frontend, written by libtorch's TorchScript exporter (image
             [N, 1, 96, 511]: B4 under fast), and the TF-export dialect of
             tests/_tf_dialect_models.py for v2.4 (96 mels, 6522 species),
             v3.0 (96, 6522, embeddings 1024) and Perch v2 (128, 14795,
             1536). Per file: fp32 on the card against the file's oracle
             (the torch module on the card, TF32 off; TfOracle) and against
             the port on the host; fast against fp32 (top-1 where fp32's
             winner leads by more than CLEAR_LEAD); predict_batch(32); a 60 s
             analyze_samples against predict_batch on the same segments (held
             at fp32, printed at fast); the batch context's graph bitwise against predict_batch; one forward
             per policy under torch.cuda.set_sync_debug_mode("error"); B4's
             launches and, in a profiler trace, its expand_dw_mma_kernel on
             the torch export; rates beside the generator's v2.4 conv file.
14. control_flow — a CRNN bird tagger at full width (the exported phase's
             frontend and backbone, image [N, 1, 96, 511]; the mean over
             frequency, a linear F.interpolate x4 along time (a Resize) to
             [N, 1280, 64], a 2-layer bidirectional GRU of hidden 128, frame
             and attention heads over 6522 species and attention pooling),
             exported by libtorch and built through Classifier.builder():
             fp32 against the torch module on the card and the port on the
             host; fast top-1 where clear; the stream at tile 128 against
             predict_batch (fp32); the batch context bitwise (its graph
             holds the GRU's step loop); one forward per policy without a
             sync; B4's launches and trace; rates beside the exported v2.4
             and ATen ops per forward. Then torch.jit.script control flow
             (tests/test_random_torch_graphs.py's five _control_flow_net
             templates at width 1024, batch 32) on the card against the host
             and torch, the If and for forms without a sync, the while
             form's host reads counted; the merged-decoder fixture with each
             flag value and a .btck round trip; a minute of a while-form
             file streamed through its eager key (its warm calls counted
             host reads, so nothing was captured) against the host; and
             tests/_torch_flow_cases.py's recurrences, Resize, Attention and
             RotaryEmbedding at realistic shapes, card against host.
15. op_sets — the long tail of ai.onnx and the ai.onnx.ml domain: (a) the
             exported phase's backbone (image [N, 1, 96, 511]: B4 under fast)
             with a scripted head that splits the [N, 1280, 3, 16] map into
             four time chunks (SplitToSequence, a Loop over the sequence,
             ConcatFromSequence), pools and projects each over 6522 species
             and averages them, through Classifier.builder(): fp32 against
             the torch module on the card and the port on the host, fast
             top-1 where clear, the batch context bitwise, one forward per
             policy without a sync, B4's launches; (b)
             tests/_torch_opset_cases.py's ops at realistic shapes (GridSample
             bilinear and bicubic and AffineGrid on [32, 1, 96, 511],
             RoiAlign and MaxRoiPool with 300 boxes over [32, 1280, 3, 16],
             DeformConv on [32, 64, 48, 256], Col2Im as overlap-add, the
             losses over [32, 6522], the RMS normalizations on [32, 64,
             1024], MeanVarianceNormalization, a TensorScatter KV-cache
             write into [32, 8, 1024, 64], Det of [4096, 3, 3], the random
             ops bit for bit and repeatable, and the ops of
             tests/test_compiler_conformance.py: Mod, the reductions'
             empty axes, ArgMax/ArgMin's last index, Range, negative Slice
             steps, Resize's coordinate modes, MaxPool's indices on [32, 64,
             96, 256], MaxUnpool, ScatterElements min/max, grouped
             ConvTranspose, GatherND's batch_dims, negative Pad,
             LayerNormalization's skipped output, a folded Conv +
             BatchNormalization), card against host (integer outputs
             exact) with each op's device ms; (c) its ai.onnx.ml heads (linear, RBF SVM with
             Platt coupling, a 100-tree forest, a TreeEnsemble regressor) on
             one hour of full-width v3.0 and Perch embeddings, card against
             host, the linear head against numpy, no sync in any head's
             forward, device ms per head and the SVM's launches per forward.

16. contrib — the com.microsoft contrib domain: (1) the full-width v2.4
             files (conv and STFT) rewritten as onnxruntime's offline
             optimizer writes them (BatchNormalization folded into Conv,
             QuickGelu, FusedConv(Sigmoid); tests/_torch_contrib_cases.py's
             ort_optimized), through Classifier.builder() at fast (with_tpu)
             and fp32: fp32 against the original file on the card and the
             port on the host, fast top-1 where clear, the batch context
             bitwise, one streamed hour (fp32: the original file's top-K),
             forwards without a sync, B1/B2's launches and B4's (0: its pass
             matches the plain Sigmoid/Mul spelling), rates beside the
             original file's; (2) that module's ops at realistic shapes
             (FusedConv and QLinear* at v2.4's, Attention,
             MultiHeadAttention, SkipLayerNormalization,
             EmbedLayerNormalization and FastGelu at BERT-base widths,
             GroupQueryAttention with rotary at 32/8 heads of 128 over a
             1,024-token prefill and 16 decode steps, 4-bit MatMulNBits
             4096 x 4096 at M 16 and 1,024, MurmurHash3 on 10^6 int32),
             card against host with each op's device ms; (3) GreedySearch,
             BeamSearch (4 beams) and Sampling over a GPT-2 small-width
             decoder (batch 2, prompt 16, max_length 64) and
             WhisperBeamSearch with the timestamp rules at whisper-tiny
             widths (80 x 3,000 features, 4 beams, max_length 48), card
             against host: sequences equal, scores within 1e-4, Sampling
             bit for bit; on the card a warm call timed (steps per second of
             one prompt row, and tokens per second over the batch's rows),
             the synchronizing operations per step counted under
             torch.cuda.set_sync_debug_mode("warn") beside the op's host
             reads, and for GreedySearch and WhisperBeamSearch a
             torch.profiler trace of one call (the device's busy share and
             its launches per step).
17. mesh    — the parallel tier on meshes that name cuda:0 more than once
             (it checks the layout and the kernels under it, not scaling):
             full-width v2.4 conv on (1, 1), (2, 2) and (1, 4) (6522
             species padded to 6524 over 4) at fast: the batch context
             (precompiled with the row-mask program) and predict_batch(32)
             replay the bucket's captured program (one replay a call on one
             card; B2 and B4 launched once per running cell per replay), the
             ten-minute int16 stream its key's graphs; each against the
             mesh's eager step bit for bit (predict_batch, the context with
             row masks, the stream); fp32 against the single-device
             classifier (logits within MESH_TOL of their scale, top-K equal,
             confidences within MESH_TOL) and fast top-1 where clear; the
             STFT form on (2, 2) (B1 once per cell); Perch v2 conv on (2, 2)
             at fp32 (14795 padded to 14796, embeddings 1536 within
             MESH_TOL, no pad index); ten minutes of int16 streamed on
             (2, 2) at fp32 against the single classifier's stream, with and
             without a per-call species mask (the masked key bitwise against
             the eager loop), the fast stream's device memory within
             MESH_DEVICE_GROWTH and its keys unchanged over
             MESH_STREAM_REPEATS more runs; the batch context against the
             mesh's predict_batch and a DynamicBatcher's 64 answers against
             the single classifier's; two CLI processes joined by
             --coordinator on 127.0.0.1 over four WAVs against one process's
             CSV. Prints, in turns, predict_batch(32), context and stream
             seg/s of each mesh (graph and eager) beside the single
             classifier's context, predict_batch and stream, and the idle
             share (torch.profiler) of one (2, 2) context call and one
             streamed ten minutes beside the single classifier's.
18. activation_diff — utils/activation_diff on the full-width v2.4 conv
             file (4 seeded rows): the worst ten nodes of fast against fp32
             on the card, and the card against the host at fp32, every node
             within 1e-4 of its layer's scale.
19. tools   — the port's counterparts of scripts/serve_bench.py,
             bench_onnx.py and topk_bench.py on the card:
             scripts/torch_serve_bench.py on the full-width v2.4 conv file
             at fast (max_batch 32, waits 0 and 5 ms, 1 and 2 workers, 4
             and 64 client threads, 2 s a row; no client may fail, the mean
             fill in [1, 32]); scripts/torch_bench_onnx.py on the
             torch-exported v2.4 and the CRNN at fast, batches 1 and 32,
             eager and one captured graph replayed (outputs finite, the
             graph's within FLOAT_NODE_TOL of the eager's); and
             scripts/torch_topk_bench.py at its defaults ([128, 6522] bf16
             logits, k 10: the exact forms agree, then us per tile).
20. hunt    — scripts/torch_graph_hunt.py on the card: for each of its
             thirteen kinds of random torch-exported architectures
             (tests/_torch_grammars.py), the first two samples from seed
             10000 that the grammar draws valid and the exporter writes, at
             fp32 (TF32 off) against the torch module in eval mode and
             against the port on the host (atol 5e-4, rtol 1e-3).
21. stage_profile — scripts/torch_stage_profile.py's two tables on the
             full-width v2.4 conv file at fast, tile 128: per milestone
             (frontend, stem, each MBConv block, head, logits; then with
             the default fusions: the frontend kernel, the stage prefix B4,
             each later block, head, logits) the pruned prefix captured 16
             times in one CUDA graph, replays timed with CUDA events; one
             line per table (us per tile and per segment, share of the
             total); the logits prefix against the model's forward.
22. gelu    — csrc/gelu.cu's two kernels at aves_embed_1h's shapes (a tile
             of 128 segments of 80,000 samples at 16 kHz): bias_gelu on the
             FFN's [128, 249, 4096] (bf16 and float32 stores) and the
             positional conv's [128, 1024, 249] slice of 250 frames (bare,
             float32), bit for bit against their plain versions;
             channel_ln_gelu on [128, 512, T] for each encoder T (bf16
             stores, float32 at the last), frames that differ at all at most
             GELU_LN_FRAME_SHARE and no element off by more than
             GELU_LN_REL of the largest magnitude; each timed against its
             plain version beside its byte bound (2 B read, 2 or 4 B written
             an element); then one hour of int16 through the full-width
             AVES (HuBERT-large) model's embed_samples at fast: each
             captured tile graph holds 24 bias, 7 channel_ln and 1 bare
             launch, the counts are set to 0 before a second hour and read
             after it (the kernels line's launches), and the embeddings
             against the same model imported without the GELU bundling,
             each row within the benchmark's emb_err of its largest entry.

Before each driven path (slice, stream, int8, families, the batch
context's capture, each server's run, the exported files, the CRNN, the
sequence head, the ORT-optimized files, each mesh run) every
launch count is set to 0;
the counts are read right after it, and the kernels line sums them. B5, which the JAX package
reaches only through its public function, counts its kernel phase's calls
to that function.

The line before the last is the kernels' summary; the last line is
``{"ok": true, "device": {...}}``. The script imports no JAX.

    python3 chip_smoke.py --ab

times only what every tree of the port with B4 shares through the same
wrappers (B4 at the full-width geometry, B5, the B3 forward sum) and
predict_batch(32) under mixed on the full-width files, so that this
script beside another tree's package (``git archive`` into the
git-ignored ``_ab/``) compares the two in one call, in turns.

    python3 chip_smoke.py --gelu

runs the device, build and gelu phases alone and prints their kernels
line.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from birdnet_tpu_torch import (
    Classifier,
    InferenceOptions,
    Prediction,
    RangeFilter,
    TPUConfig,
    chunk_audio,
)
from birdnet_tpu_torch.compiler.importer import (
    consts_to_device,
    import_onnx,
    interpret_graph,
    make_forward,
    params_to_torch,
)
from birdnet_tpu_torch.compiler.ops import OpContext, get_lowering
from birdnet_tpu_torch.compiler import stream
from birdnet_tpu_torch.compiler.quantize import (
    quantize_model,
    synthetic_calibration_segments,
)
from birdnet_tpu_torch.compiler._melbank import mel_weight_matrix
from birdnet_tpu_torch.compiler import fuse_gelu
from birdnet_tpu_torch.models import aves_hubert, birdnet_v24, birdnet_v30, meta, perch_v2
from birdnet_tpu_torch.onnx import proto as P
from birdnet_tpu_torch.parallel import make_mesh
from birdnet_tpu_torch.ops.cuda import build
from birdnet_tpu_torch.ops.cuda import frontend as fe
from birdnet_tpu_torch.ops.cuda import gelu
from birdnet_tpu_torch.ops.cuda import qconv as qc
from birdnet_tpu_torch.ops.cuda import stage_prefix as spx
from birdnet_tpu_torch.serve import ServeClient, make_server
from birdnet_tpu_torch.types import ModelType
from birdnet_tpu_torch.utils.audio_io import read_wav, write_wav
from birdnet_tpu_torch.utils.collector import collector_paused

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
    "bias_gelu": "birdnet_tpu_torch/csrc/gelu.cu",
    "channel_ln_gelu": "birdnet_tpu_torch/csrc/gelu.cu",
}
# The TPU kernels these replace (the wrappers that reach pl.pallas_call);
# None for the port's own kernels, whose chains the JAX package leaves to
# XLA's fusion.
REPLACES = {
    "stft_melspec": "birdnet_tpu/ops/pallas/frontend.py:463",
    "filterbank_logpower": "birdnet_tpu/ops/pallas/frontend.py:334",
    "qconv1x1_requant": "birdnet_tpu/ops/pallas/qconv.py:91",
    "stage_stack_forward": "birdnet_tpu/ops/pallas/stage123.py:255",
    "frame_filterbank_logpower": "birdnet_tpu/ops/pallas/frontend.py:194",
    "qconv1x1_requant_forward": "birdnet_tpu/ops/pallas/qconv.py:91",
    "bias_gelu": None,
    "channel_ln_gelu": None,
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
    with collector_paused(), torch.cuda.graph(graph):
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


def frontend_yardsticks(name, x, window, mel, weights, out, hop=HOP) -> dict:
    """B1's or B2's library call and bound on bf16 inputs ``x`` at ``hop``
    (``out`` ``[N, M|F, T]``, the kernel's result). The library call is one
    bf16 matmul of the frames, materialised beforehand and not timed, with
    the kernel's B operand: B1's cos|sin bases ``[flen, 2 bins]``, B2's
    filterbank ``[flen, F]``."""
    flen = int(np.asarray(window).size) if name == "stft_melspec" else weights.shape[-1]
    n_cols = out.shape[1]
    frames = x.unfold(-1, flen, hop).reshape(-1, flen).contiguous()
    n_rows = frames.shape[0]
    if name == "stft_melspec":
        bc, bs, mel_used = fe.stft_bases(window, mel)
        rhs = torch.from_numpy(np.concatenate([bc, bs], 1)).to(x.device, x.dtype)
        bins = bc.shape[1]
        ops = n_rows * (2 * 2 * flen * bins + 2 * bins * n_cols)
        moved = nbytes(x, rhs, out) + bins * n_cols * x.element_size()
    else:
        rhs = weights.reshape(weights.shape[0], -1).t().contiguous().to(x.dtype)
        ops = 2 * n_rows * flen * n_cols
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
        # The JAX package's device config, whose "TPU" is the card here.
        clf = (Classifier.builder().model_path(paths[frontend]).labels(LABELS)
               .with_tpu(TPUConfig(precision="fast", device_id=0)).top_k(5).build())
        if clf.precision != "fast" or clf.device != CARD:
            raise AssertionError(f"with_tpu: {clf.precision} on {clf.device}")
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


def eagerly(clf, fn):
    """``fn()`` with the classifier's stream running every key's tile body
    eagerly (``_use_graphs`` False): the plain version of the graphs."""
    eng = clf._streaming_engine()
    eng._use_graphs = False
    try:
        return fn()
    finally:
        eng._use_graphs = True


def graph_vs_eager(clf, samples, **kw) -> dict:
    """The engine's arrays (conf, idx, times[, emb]) from its graphs and
    from its eager tile loop on the same samples: equal bit for bit?"""
    eng = clf._streaming_engine()
    graph = eng.analyze(samples, **kw)
    eager = eagerly(clf, lambda: eng.analyze(samples, **kw))
    return {"bitwise": all(np.array_equal(g, e) for g, e in zip(graph, eager)),
            "max_abs_diff": max(float(np.abs(g.astype(np.float64) - e).max(initial=0.0))
                                for g, e in zip(graph, eager))}


def stream_keys(clf) -> list:
    """The stream's tile programs: key, eager or not, host reads counted."""
    return [{"key": list(key), "eager": p.eager, "host_reads": p.host_reads}
            for key, p in clf._streaming_engine().programs.items()]


def eager_graph_keys(keys: list) -> list:
    """The keys of :func:`stream_keys` that were to replay graphs (the
    key's last field) but run eagerly."""
    return [k for k in keys if k["key"][-1] and k["eager"]]


def with_split_zero(fn):
    """``fn()`` with ``BIRDNET_STAGE123_SPLIT=0``: the stage prefix runs
    eagerly, without B4. The lowering reads it when it runs, so a stream's
    graph keeps the split it was captured with."""
    os.environ["BIRDNET_STAGE123_SPLIT"] = "0"
    try:
        return fn()
    finally:
        os.environ.pop("BIRDNET_STAGE123_SPLIT", None)


# Device memory across repeated streamed hours may grow by at most this
# after the first hour (the keys' graphs and rings are made in the first).
STREAM_DEVICE_GROWTH = 1 << 20
STREAM_REPEATS = 10


def phase_stream(card: str, fast: dict, paths: dict) -> dict:
    """Streaming on the full-width ``fast`` classifiers over one hour of
    seeded int16 audio, at the engine's default tile and at tile 32: each
    key replays its captured graphs. Returns its launch counts (each replay
    adds its graph's captured launches).

    What decides that its output is right: the streamed top-K against
    predict_batch on the same segments, framed on the host and scaled as
    the device scales int16 (× 1/32768), in batches of the stream's tile;
    and the graphs against the same engine's eager tile loop, bit for bit."""
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
    for frontend, clf in fast.items():
        keys = stream_keys(clf)
        eng = clf._streaming_engine()
        emit({"phase": "stream_keys", "frontend": frontend, "card": card, "keys": keys,
              "graphs": sum(len(p.graphs) for p in eng.programs.values()),
              "ring_bytes": stream.RING_SLOTS * eng._ring.nbytes})
        if eager_graph_keys(keys):
            raise AssertionError(f"stream {frontend}: an eager key on the main path: {keys}")

    for (frontend, tile, overlap), (conf, idx, seconds) in runs.items():
        clf = fast[frontend]
        segs, _ = chunk_audio(audio_f32, S, overlap, 48_000)
        ref_conf, ref_idx, _ = tiled_reference(clf, segs, tile)
        if conf.shape != ref_conf.shape or not np.isfinite(conf).all():
            raise AssertionError(f"stream {frontend} {overlap}: {conf.shape} vs {ref_conf.shape}")
        conf_diff = float(np.abs(conf - ref_conf).max())
        clear = ref_conf[:, 0] - ref_conf[:, 1] > STREAM_CONF_TOL
        top1_clear = int((idx[clear, 0] == ref_idx[clear, 0]).sum())
        eng = clf._streaming_engine()
        eng.tile = tile
        eager = graph_vs_eager(clf, pcm, overlap_seconds=overlap)
        eng.tile = default_tile
        line = {"phase": "stream", "frontend": frontend, "overlap_s": overlap,
                "segments": int(conf.shape[0]), "card": card, "tile": tile,
                "monitored": overlap > 0, "seconds": seconds,
                "seg_per_s": conf.shape[0] / seconds,
                "max_conf_diff_vs_predict_batch": conf_diff,
                "top1_equal_where_clear": f"{top1_clear}/{int(clear.sum())}",
                "top1_equal_all": int((idx[:, 0] == ref_idx[:, 0]).sum()),
                "graph_vs_eager": eager,
                "ok": (conf_diff <= STREAM_CONF_TOL and top1_clear == int(clear.sum())
                       and eager["bitwise"])}
        emit(line)
        if not line["ok"]:
            raise AssertionError(f"stream {frontend} {overlap} disagrees: {line}")

    # Device memory and the key count across repeated hours on the default
    # key: the first hour may make nothing new (its key ran above), the
    # others must leave memory where the first left it.
    clf = fast["conv"]
    keys0 = len(clf._streaming_engine().programs)
    memory = []
    for _ in range(STREAM_REPEATS):
        stream_rate(clf, pcm)
        torch.cuda.synchronize()
        memory.append(torch.cuda.memory_allocated())
    line = {"phase": "stream_memory", "frontend": "conv", "card": card,
            "hours": STREAM_REPEATS, "keys_before": keys0,
            "keys_after": len(clf._streaming_engine().programs),
            "memory_allocated_bytes": memory,
            "max_change_after_first_bytes": max(abs(m - memory[0]) for m in memory[1:])}
    line["ok"] = (line["keys_after"] == keys0
                  and line["max_change_after_first_bytes"] <= STREAM_DEVICE_GROWTH)
    emit(line)
    if not line["ok"]:
        raise AssertionError(f"stream memory: {line}")

    # Each distinct overlap a request sends is a key with its own graph:
    # two rounds of more overlaps than the engine keeps keys must hold the
    # key count at MAX_PROGRAMS, keep the one ring, and leave the card's
    # memory after the second round where the first left it.
    eng = clf._streaming_engine()
    minute = pcm[:60 * 48_000]
    overlaps = [0.25 * i for i in range(stream.MAX_PROGRAMS + 4)]
    ring = eng._ring
    rounds = []
    for _ in range(2):
        keys_max = 0
        for overlap in overlaps:
            clf.analyze_samples(minute, overlap_seconds=overlap)
            keys_max = max(keys_max, len(eng.programs))
        torch.cuda.synchronize()
        free, total = torch.cuda.mem_get_info()
        rounds.append({"keys_max": keys_max, "allocated": torch.cuda.memory_allocated(),
                       "reserved": torch.cuda.memory_reserved(), "used": total - free})
    line = {"phase": "stream_overlap_keys", "frontend": "conv", "card": card,
            "overlaps": len(overlaps), "max_programs": stream.MAX_PROGRAMS,
            "rounds": rounds, "same_ring": eng._ring is ring,
            "ring_bytes": stream.RING_SLOTS * ring.nbytes,
            "allocated_change_bytes": rounds[1]["allocated"] - rounds[0]["allocated"],
            "reserved_change_bytes": rounds[1]["reserved"] - rounds[0]["reserved"],
            "used_change_bytes": rounds[1]["used"] - rounds[0]["used"]}
    line["ok"] = (line["same_ring"]
                  and all(r["keys_max"] <= stream.MAX_PROGRAMS for r in rounds)
                  and abs(line["allocated_change_bytes"]) <= STREAM_DEVICE_GROWTH
                  and abs(line["reserved_change_bytes"]) <= STREAM_DEVICE_GROWTH)
    emit(line)
    if not line["ok"]:
        raise AssertionError(f"stream keys of distinct overlaps: {line}")

    # warmup captures a key ahead of its first call (an overlap no call
    # above used), which then captures nothing: the same program and
    # graphs, no new key.
    overlap = 2.9
    keys0 = set(eng.programs)
    t0 = time.perf_counter()
    eng.warmup(overlap_seconds=overlap, dtype=np.int16)
    warmup_s = time.perf_counter() - t0
    (key, program), = [(k, p) for k, p in eng.programs.items() if k not in keys0]
    graphs = list(program.graphs)
    t0 = time.perf_counter()
    clf.analyze_samples(minute, overlap_seconds=overlap)
    line = {"phase": "stream_warmup", "frontend": "conv", "card": card, "key": list(key),
            "graphs": len(graphs), "warmup_s": warmup_s,
            "first_analyze_s": time.perf_counter() - t0,
            "same_program_and_graphs": (eng.programs.get(key) is program
                                        and program.graphs == graphs),
            "keys_after": len(eng.programs)}
    line["ok"] = bool(graphs) and line["same_program_and_graphs"]
    emit(line)
    if not line["ok"]:
        raise AssertionError(f"stream warmup: {line}")

    for frontend, clf in fast.items():
        eng = clf._streaming_engine()
        # B4's A/B on a classifier of its own built and captured under split
        # 0: a running engine keeps the split its graphs were captured with.
        split0 = with_split_zero(lambda: built(paths[frontend], LABELS, "fast"))
        # One untimed call per setting first: each makes (captures) its key.
        for tile in (32, 64):
            eng.tile = tile
            stream_rate(clf, pcm)
        eng.tile = default_tile
        stream_rate(clf, pcm)
        stream_rate(clf, audio_f32)
        with_split_zero(lambda: stream_rate(split0, pcm))
        eagerly(clf, lambda: stream_rate(clf, pcm))
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
            split[name].append(with_split_zero(lambda: stream_rate(split0, pcm)) if name == "0"
                               else stream_rate(clf, pcm))
        modes = {"graph": [], "eager": []}
        for name in ("graph", "eager", "eager", "graph"):
            modes[name].append(eagerly(clf, lambda: stream_rate(clf, pcm)) if name == "eager"
                               else stream_rate(clf, pcm))
        emit({"phase": "stream_rates", "frontend": frontend, "card": card,
              "segments": HOUR // S, "default_tile": default_tile,
              "seg_per_s_by_tile": tiles, "seg_per_s_by_input": inputs,
              "seg_per_s_by_split": split, "seg_per_s_graph_vs_eager": modes,
              "keys": len(eng.programs), "split0_keys": stream_keys(split0)})
        del split0
    for frontend, clf in fast.items():
        profiles = {"graph": [], "eager": []}
        for name in ("graph", "eager", "eager", "graph"):
            run = lambda: stream_profile(clf, pcm, FRONTEND_KERNEL[frontend])  # noqa: E731
            profiles[name].append(eagerly(clf, run) if name == "eager" else run())
        emit({"phase": "stream_profile", "frontend": frontend, "card": card,
              "tile": default_tile, **profiles})
        graph = profiles["graph"][0]
        if graph["frontend_kernel_launches"] <= 0 or graph["b4_launches"] <= 0:
            raise AssertionError(f"stream profile {frontend}: the graph-streamed hour's trace "
                                 f"names no frontend kernel or B4: {graph}")
    return launches


DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
# B4's kernels, by the names csrc/stage_prefix.cu gives them.
B4_KERNELS = ("stem_kernel", "expand_dw", "se_gate_kernel", "se_project")


def _profile_events(fn) -> tuple:
    """(wall ms, chrome-trace events) of one call of ``fn`` under
    torch.profiler. The profiler slows the host, so the profiled wall time
    runs above the unprofiled one."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    with tempfile.TemporaryDirectory() as tmp:
        trace = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(trace)
        return wall_ms, json.loads(Path(trace).read_text())["traceEvents"]


def _device_busy_ms(events) -> float:
    """The union of the trace's device intervals (kernels, copies, sets)."""
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                   if e.get("ph") == "X" and e.get("cat") in DEVICE_CATEGORIES)
    busy, end = 0.0, -1.0
    for s, t in spans:
        if t > end:
            busy += t - max(s, end)
            end = t
    return busy / 1e3


def stream_profile(clf, pcm, frontend_kernel: str) -> dict:
    """torch.profiler over one analyze_samples call: its wall time, the
    device's busy time (the union of its kernel, copy and set intervals),
    the idle share 1 - busy / wall, B4's device time (its kernels summed),
    the frontend kernel's launches in the trace and the ten device items
    with the most time (ms, launches). The profiler slows the host, so the
    profiled wall time runs above the unprofiled one."""
    wall_ms, events = _profile_events(lambda: clf.analyze_samples(pcm))
    by_name = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in DEVICE_CATEGORIES:
            total, count = by_name.get(e["name"], (0.0, 0))
            by_name[e["name"]] = (total + e["dur"], count + 1)
    busy_ms = _device_busy_ms(events)
    if busy_ms <= 0.0:
        raise AssertionError("stream profile: no device interval in the trace")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    b4 = [(total, count) for name, (total, count) in by_name.items()
          if any(k in name for k in B4_KERNELS)]
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "idle_share": 1.0 - busy_ms / wall_ms,
            "b4_device_ms": sum(t for t, _ in b4) / 1e3, "b4_launches": sum(c for _, c in b4),
            "frontend_kernel_launches": sum(c for name, (_, c) in by_name.items()
                                            if frontend_kernel in name),
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


def check_int8_nodes(path: str, policy: str, segs: np.ndarray, forward_line: bool = True) -> dict:
    """Every node of the full-width int8 graph run on the card, against the
    same node's lowering on the CPU fed the card's own inputs, so that no
    rounding difference upstream can spread. Integer outputs must be equal,
    except after a sigmoid/silu/tanh requantize epilogue (exp and tanh round
    differently on the two devices): there at most 1 code apart, on at most
    QCONV_MAX_DIFF_SHARE of all such codes of the graph. Float outputs agree
    within FLOAT_NODE_TOL[policy] of the output's largest magnitude. With
    ``forward_line``, the graph's B3 shapes must be qconv_forward_shapes()."""
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
    if forward_line and b3 != qconv_forward_shapes():
        raise AssertionError(f"the int8 graph's 1x1 convs {b3} are not qconv_forward_shapes()")
    result = {"nodes_checked": nodes, "max_code_diff": worst_code,
              "max_scaled_float_diff": worst_float, "b3_shapes_as_forward_line": len(b3),
              "transcendental_epilogue_codes": transcendental}
    if transcendental["differing"] > QCONV_MAX_DIFF_SHARE * transcendental["codes"]:
        raise AssertionError(f"int8 nodes ({policy}): {result}")
    return result


# The int8 stream: ten minutes of int16 (200 segments, two tiles of 128).
INT8_STREAM_SECONDS = 600


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
    int8_pcm = (np.random.default_rng(SEED + 14).standard_normal(INT8_STREAM_SECONDS * 48_000)
                * 3000).clip(-32768, 32767).astype(np.int16)
    reset_launches()
    int8 = {}
    for frontend, counter in FRONTEND_KERNEL.items():
        for policy in ("fast", "mixed"):
            before = read_launches()
            clf = (Classifier.builder().model_path(paths[frontend]).labels(LABELS)
                   .precision(policy).top_k(5).int8().build())
            one = clf.predict(segs[0])
            batch = clf.predict_batch(segs)
            if (frontend, policy) == ("conv", "fast"):
                # One int8 stream through the key's graphs (B3 inside).
                b3_before = read_launches()["qconv1x1_requant"]
                int8_stream = clf._streaming_engine().analyze(int8_pcm)
                b3_stream = read_launches()["qconv1x1_requant"] - b3_before
            after = read_launches()
            ran = [k for k in after if after[k] > before[k]]
            need = ["qconv1x1_requant"] + ([counter] if policy == "fast" else [])
            if any(k not in ran for k in need):
                raise AssertionError(f"int8 {frontend} {policy}: kernels {need} must run, ran {ran}")
            int8[frontend, policy] = (clf, one, batch)
    launches = read_launches()
    clf = int8["conv", "fast"][0]
    segs_i8 = chunk_audio(int8_pcm.astype(np.float32) / 32768.0, S, 0.0, 48_000)[0]
    ref_conf, ref_idx, _ = tiled_reference(clf, segs_i8, clf._streaming_engine().tile)
    # Decides: the graphs against the eager tile loop bit for bit, B3
    # launched by the stream, every row finite. Printed: the agreement with
    # predict_batch, which the chaotic random int8 model (see above) would
    # amplify from any difference in the order of a sum.
    line = {"phase": "int8_stream", "frontend": "conv", "policy": "fast", "card": card,
            "segments": int(int8_stream[0].shape[0]), "keys": stream_keys(clf),
            "qconv1x1_requant_launches": b3_stream,
            "graph_vs_eager": graph_vs_eager(clf, int8_pcm),
            "max_conf_diff_vs_predict_batch": float(np.abs(int8_stream[0] - ref_conf).max()),
            "top1_equal_all": int((int8_stream[1][:, 0] == ref_idx[:, 0]).sum())}
    line["ok"] = (line["graph_vs_eager"]["bitwise"] and b3_stream > 0
                  and int8_stream[0].shape == ref_conf.shape
                  and bool(np.isfinite(int8_stream[0]).all())
                  and not eager_graph_keys(line["keys"]))
    emit(line)
    if not line["ok"]:
        raise AssertionError(f"int8 stream: {line}")

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


# BirdNET v3.0 and Perch v2 at their generators' full widths (v3.0: 6522
# species, embeddings 1024; Perch: 14795 species, embeddings 1536), 5 s
# segments at 32 kHz; their stream phase is one hour of seeded int16.
FAMILIES = {"v30": birdnet_v30, "perch": perch_v2}
FAMILY_RATE, FAMILY_S = 32_000, 160_000
FAMILY_HOUR = 3600 * FAMILY_RATE
FAMILY_TILE = 128
# The families' fast and mixed top-1 against fp32: equal on every row whose
# fp32 winner leads the runner-up by more than this share of the logits'
# largest magnitude (four bf16 ulps). v2.4's count rule (MIN_TOP1_AGREE)
# is printed beside it: at full width the random v3.0 and Perch heads leave
# rows whose lead is below the bf16 policies' own disagreement with fp32
# (PERF.md, section 6), where a flip says nothing of the port.
CLEAR_LEAD = 2 ** -5
# The range filter on the card against the host: scores within this (fp32,
# TF32 off on both).
RANGE_TOL = 1e-5
# The CLI's streamed and --no-stream CSV confidences agree within this.
CLI_CONF_TOL = 1e-3
REPO = Path(__file__).resolve().parent


def family_labels(n: int) -> list:
    return [f"Genus{i}_species{i}_Common {i}" for i in range(n)]


def embeddings_of(results) -> np.ndarray:
    return np.stack([r.embeddings for r in results])


def scaled_diff(got: np.ndarray, ref: np.ndarray) -> float:
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def built(path: str, labels: list, policy: str, top_k: int = 5):
    return (Classifier.builder().model_path(path).labels(labels)
            .precision(policy).top_k(top_k).build())


def tiled_reference(clf, segs: np.ndarray, tile: int) -> tuple:
    """(conf [N, K], idx [N, K], embeddings [N, E] or None) of predict_batch
    over ``segs`` in batches of ``tile``, the last zero-padded: the stream
    zero-pads its last tile, so that both run the same batch shapes (cuBLAS
    may pick another kernel, and sum in another order, for another batch
    size)."""
    conf, idx, emb = [], [], []
    for i in range(0, segs.shape[0], tile):
        batch = segs[i:i + tile]
        n = batch.shape[0]
        batch = np.concatenate([batch, np.zeros((tile - n,) + batch.shape[1:], np.float32)])
        for r in clf.predict_batch(batch)[:n]:
            conf.append([p.confidence for p in r.predictions])
            idx.append([p.index for p in r.predictions])
            emb.append(r.embeddings)
    emb = np.stack(emb) if emb[0] is not None else None
    return np.array(conf, np.float32), np.array(idx), emb


def frontend_node(path: str) -> tuple:
    """The imported graph's fused frontend node and, for the conv form, its
    filterbank (a numpy param)."""
    model = import_onnx(path)
    node = next(n for n in model.graph.node
                if n.op_type in ("_FusedFrontend", "_FusedStftFrontend"))
    weights = model.params[node.input[1]] if node.op_type == "_FusedFrontend" else None
    return node, weights


def phase_family_kernels(family: str, frontend: str, path: str, card: str) -> dict:
    """B1 or B2 at one family's geometry (hop 312 with 96 mels or filters,
    hop 320 with 128; 160,000-sample segments), on the imported graph's own
    window, mel bank or filterbank, in bf16 at batch 32 against the plain
    version, with its device time, bound and library yardstick."""
    node, weights = frontend_node(path)
    hop, eps = int(node.attrs["hop"]), float(node.attrs["eps"])
    rng = np.random.default_rng(SEED + 8)
    x = torch.from_numpy((rng.normal(size=(N_SEG, FAMILY_S)) * 0.1).astype(np.float32)
                         ).to(CARD, torch.bfloat16)
    name = FRONTEND_KERNEL[frontend]
    window = mel = w = None
    if frontend == "stft":
        window, mel = node.attrs["window"].to_numpy(), node.attrs["mel"].to_numpy()
        run = lambda: fe.segments_stft_melspec(x, window, mel, hop=hop, eps=eps)
        plain = lambda: fe.stft_melspec_plain(x, window, mel, hop=hop, eps=eps)
    else:
        w = torch.from_numpy(np.array(weights)).to(CARD)
        run = lambda: fe.segments_filterbank_logpower(x, w, hop=hop, eps=eps)
        plain = lambda: fe.filterbank_logpower_plain(x, w, hop=hop, eps=eps)
    launches = fe.LAUNCHES[name]
    got = run()
    torch.cuda.synchronize()
    want = plain()
    torch.cuda.synchronize()
    err, ok = within(got, want, torch.bfloat16)
    ms, plain_ms = kernel_vs_plain_ms(run, plain)
    fe.LAUNCHES[name] = launches  # comparison launches do not count
    groups, cols = fe.col_groups(got.shape[1])
    line = {"phase": "kernel_geometry", "family": family, "name": name, "dtype": "bfloat16",
            "card": card, "shape": list(x.shape), "hop": hop, "cols": got.shape[1],
            "frames": got.shape[2], "col_groups": groups, "mma_cols": cols,
            "max_abs_err_vs_plain": err, "ms": ms, "plain_ms": plain_ms,
            "us_per_segment": 1e3 * ms / N_SEG,
            "plain_us_per_segment": 1e3 * plain_ms / N_SEG,
            **frontend_yardsticks(name, x, window, mel, w, got, hop=hop),
            "ok": ok and tuple(got.shape) == tuple(want.shape)}
    line["share_of_bound"] = line["bound_ms"] / ms
    emit(line)
    if not line["ok"]:
        raise AssertionError(f"{name} at the {family} geometry disagrees: {line}")
    return line


def top1_where_clear(logits: np.ndarray, ref: np.ndarray,
                     clear_lead: float = CLEAR_LEAD) -> dict:
    """Top-1 of ``logits`` against ``ref`` (fp32): the count over all rows,
    and whether every row whose ref winner leads by more than ``clear_lead``
    of ref's largest magnitude agrees; each disagreeing row's lead."""
    scale = np.abs(ref).max()
    top2 = np.sort(ref, axis=1)[:, -2:]
    lead = (top2[:, 1] - top2[:, 0]) / scale
    agree = logits.argmax(1) == ref.argmax(1)
    clear = lead > clear_lead
    return {"all": f"{int(agree.sum())}/{len(agree)}",
            "where_clear": f"{int(agree[clear].sum())}/{int(clear.sum())}",
            "leads_of_disagreeing_rows": [float(v) for v in lead[~agree]],
            "ok": bool(agree[clear].all())}


def phase_families(card: str) -> dict:
    """Full-width BirdNET v3.0 and Perch v2, conv and STFT forms, random
    weights from SEED: predict and predict_batch(32) at fast (B2 or B1 must
    run), mixed and fp32, fast and mixed held to fp32 on the logits and the
    embeddings; then one streamed hour per classifier at fast against
    predict_batch on the same segments, and embed_samples against
    predict_batch's embeddings; then B1 and B2 at each geometry. Returns the
    family path's launch counts (per call and streamed)."""
    rng = np.random.default_rng(SEED + 9)
    segs = (rng.normal(size=(N_SEG, FAMILY_S)) * 0.1).astype(np.float32)
    pcm = (np.random.default_rng(SEED + 10).standard_normal(FAMILY_HOUR, dtype=np.float32)
           * 3000).clip(-32768, 32767).astype(np.int16)
    audio = chunk_audio(pcm.astype(np.float32) / 32768.0, FAMILY_S, 0.0, FAMILY_RATE)[0]
    with tempfile.TemporaryDirectory() as tmp:
        paths = {}
        for family, module in FAMILIES.items():
            for frontend in FRONTEND_KERNEL:
                path = paths[family, frontend] = str(Path(tmp) / f"{family}_{frontend}.onnx")
                P.save_model(module.build_model(seed=SEED, frontend=frontend), path)
        labels = {f: family_labels(m.NUM_SPECIES) for f, m in FAMILIES.items()}
        # The family path's run: every count starts at 0 here.
        reset_launches()
        fast, streams = {}, {}
        for (family, frontend), path in paths.items():
            counter = FRONTEND_KERNEL[frontend]
            before = read_launches()
            clf = built(path, labels[family], "fast")
            one, batch = clf.predict(segs[0]), clf.predict_batch(segs)
            conf, idx, _ = streamed(clf, pcm, 0.0)
            emb, times = clf.embed_samples(pcm)
            after = read_launches()
            if after[counter] <= before[counter]:
                raise AssertionError(f"{family} {frontend}: the {counter} kernel never ran")
            fast[family, frontend] = (clf, one, batch)
            streams[family, frontend] = (conf, idx, emb, times, after[counter] - before[counter])
        launches = read_launches()

        failed = []
        for (family, frontend), (clf, one, batch) in fast.items():
            n_species = FAMILIES[family].NUM_SPECIES
            ref = built(paths[family, frontend], labels[family], "fp32")
            mixed = built(paths[family, frontend], labels[family], "mixed")
            ref_batch, mixed_batch = ref.predict_batch(segs), mixed.predict_batch(segs)
            logits, ref_logits = logits_of(batch), logits_of(ref_batch)
            emb, ref_emb = embeddings_of(batch), embeddings_of(ref_batch)
            if logits.shape != (N_SEG, n_species) or not np.isfinite(logits).all() \
                    or emb.shape[0] != N_SEG or not np.isfinite(emb).all():
                raise AssertionError(f"{family} {frontend}: logits {logits.shape}, "
                                     f"embeddings {emb.shape}")
            if len(one.predictions) != 5 or one.embeddings is None:
                raise AssertionError(f"{family} {frontend}: predict lacks predictions or embeddings")
            line = {"phase": "family", "family": family, "frontend": frontend,
                    "kernel": FRONTEND_KERNEL[frontend], "card": card,
                    "species": n_species, "embedding_dim": int(emb.shape[1]),
                    "predict_vs_batch_row0": scaled_diff(one.raw_scores, batch[0].raw_scores)}
            ok = line["predict_vs_batch_row0"] < SCALED_LOGIT_TOL
            for policy, got in (("fast", batch), ("mixed", mixed_batch)):
                lg, em = logits_of(got), embeddings_of(got)
                top1 = line[f"top1_{policy}_vs_fp32"] = top1_where_clear(lg, ref_logits)
                line[f"scaled_logit_diff_{policy}_vs_fp32"] = scaled_diff(lg, ref_logits)
                line[f"scaled_embedding_diff_{policy}_vs_fp32"] = scaled_diff(em, ref_emb)
                ok = ok and (line[f"scaled_logit_diff_{policy}_vs_fp32"] < SCALED_LOGIT_TOL
                             and line[f"scaled_embedding_diff_{policy}_vs_fp32"] < SCALED_LOGIT_TOL
                             and top1["ok"])
            rates = {policy: seg_per_s(c, segs)
                     for policy, c in (("fast", clf), ("mixed", mixed), ("fp32", ref))}
            line.update({f"predict_batch32_seg_per_s_{k}": v for k, v in rates.items()})
            # The stream, against predict_batch on the same segments in
            # batches of the stream's tile (v2.4's rule), and embed_samples
            # against the same calls' embeddings; then one more streamed and
            # one more embedded hour, timed (the first calls also sized the
            # pinned staging buffers).
            conf, idx, s_emb, times, kernel_launches = streams[family, frontend]
            t0 = time.perf_counter()
            clf.analyze_samples(pcm)
            stream_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            clf.embed_samples(pcm)
            embed_s = time.perf_counter() - t0
            tile = clf._streaming_engine().tile
            ref_conf, ref_idx, ref_stream_emb = tiled_reference(clf, audio, tile)
            conf_diff = float(np.abs(conf - ref_conf).max())
            clear = ref_conf[:, 0] - ref_conf[:, 1] > STREAM_CONF_TOL
            top1_clear = int((idx[clear, 0] == ref_idx[clear, 0]).sum())
            emb_diff = scaled_diff(s_emb, ref_stream_emb)
            eager = {"analyze": graph_vs_eager(clf, pcm),
                     "embed": graph_vs_eager(clf, pcm, with_embeddings=True)}
            line.update(stream_graph_vs_eager=eager, stream_keys=stream_keys(clf))
            ok = ok and all(e["bitwise"] for e in eager.values()) and not eager_graph_keys(
                line["stream_keys"])
            line.update(stream_segments=int(conf.shape[0]), stream_tile=tile,
                        stream_seg_per_s=conf.shape[0] / stream_s,
                        embed_seg_per_s=s_emb.shape[0] / embed_s,
                        stream_max_conf_diff_vs_predict_batch=conf_diff,
                        stream_top1_equal_where_clear=f"{top1_clear}/{int(clear.sum())}",
                        embed_scaled_diff_vs_predict_batch=emb_diff,
                        frontend_kernel_launches=kernel_launches)
            ok = ok and (conf.shape == ref_conf.shape and conf.shape[0] == -(-FAMILY_HOUR // FAMILY_S)
                         and conf_diff <= STREAM_CONF_TOL and top1_clear == int(clear.sum())
                         and s_emb.shape == ref_stream_emb.shape and emb_diff < SCALED_LOGIT_TOL
                         and np.allclose(times, np.arange(conf.shape[0]) * 5.0))
            line["ok"] = ok
            emit(line)
            if not ok:
                failed.append(f"{family} {frontend}")
            del ref, mixed
        if failed:
            raise AssertionError(f"families disagree: {failed}")
        for (family, frontend), path in paths.items():
            phase_family_kernels(family, frontend, path, card)
    return launches


def phase_rangefilter(card: str) -> None:
    """The full-size meta model (6522 species, seeded) on the card against
    the same file on the host, at four places and dates: every species'
    score within RANGE_TOL (fp32, TF32 off), and the same filtered
    predictions."""
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "meta.onnx")
        P.save_model(meta.build_model(seed=SEED), path)
        labels = family_labels(meta.NUM_SPECIES)
        builder = lambda: RangeFilter.builder().model_path(path).labels(labels).threshold(0.0)
        on_card, on_host = builder().build(), builder().with_device("cpu").build()
    worst, times = 0.0, []
    preds = [Prediction(species=labels[i], confidence=0.9 - 0.1 * i, index=i) for i in range(5)]
    for lat, lon, month, day in ((42.5, -76.4, 6, 15), (-33.9, 151.2, 12, 31),
                                 (0.0, 0.0, 1, 1), (89.9, -179.9, 3, 8)):
        t0 = time.perf_counter()
        got = on_card.predict(lat, lon, month, day)
        times.append(time.perf_counter() - t0)
        want = on_host.predict(lat, lon, month, day)
        a, b = ({s.species: s.score for s in v} for v in (got, want))
        if a.keys() != b.keys() or len(a) != meta.NUM_SPECIES:
            raise AssertionError(f"range filter: {len(a)} species on the card, {len(b)} on the host")
        worst = max(worst, max(abs(a[k] - b[k]) for k in a))
        filtered = [p.species for p in on_card.filter_predictions(preds, got, rerank=True)]
        if filtered != [p.species for p in on_host.filter_predictions(preds, want, rerank=True)]:
            raise AssertionError("range filter: filtered predictions differ")
    line = {"phase": "range_filter", "card": card, "device": str(on_card.device),
            "species": meta.NUM_SPECIES, "max_abs_score_diff_vs_cpu": worst,
            "predict_ms_median": 1e3 * statistics.median(times[1:]),
            "ok": worst <= RANGE_TOL and on_card.device.type == "cuda"}
    emit(line)
    if not line["ok"]:
        raise AssertionError(f"range filter disagrees with the host: {line}")


def phase_checkpoint(card: str, path: str, segs: np.ndarray) -> None:
    """Full-width v2.4 (conv) saved to .btck on the card and built from it:
    its fp32 logits equal the ONNX-built classifier's bit for bit."""
    t0 = time.perf_counter()
    onnx_clf = built(path, LABELS, "fp32")
    onnx_s = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        ck = str(Path(tmp) / "birdnet_v24.btck")
        onnx_clf.save_checkpoint(ck)
        size = os.path.getsize(ck)
        t0 = time.perf_counter()
        ck_clf = built(ck, LABELS, "fp32")
        ck_s = time.perf_counter() - t0
    a, b = logits_of(onnx_clf.predict_batch(segs)), logits_of(ck_clf.predict_batch(segs))
    line = {"phase": "checkpoint", "card": card, "bytes": size,
            "build_s_from_onnx": onnx_s, "build_s_from_btck": ck_s,
            "logits_bitwise_equal": bool(np.array_equal(a, b)),
            "max_abs_logit_diff": float(np.abs(a - b).max()),
            "ok": bool(np.array_equal(a, b)) and ck_clf.device.type == "cuda"}
    emit(line)
    if not line["ok"]:
        raise AssertionError(f"checkpoint: {line}")


# The dtypes phase: the three weight forms of tests/_torch_dtype_forms.py at
# full width, each held to its yardstick file (the same graph holding the
# dequantized float32 weights) at fp32 on the card within this share of the
# yardstick's logit scale, and to the port on the host (DTYPES_CPU_ROWS
# rows) within it; ten streamed minutes at fp32 against predict_batch; the
# rates of one streamed hour at tile DTYPES_TILE under fast.
DTYPES_TOL = 1e-4
# bf16_direct's layers round to bfloat16 on every device: its fp32 forward on
# the card within the mixed policy's bound of the host's.
DIRECT_TOL = 2 ** -7
DTYPES_CPU_ROWS = 4
DTYPES_STREAM_SECONDS = 600
DTYPES_TILE = 128


def direct_int8_check(card: str, path: str, segs: np.ndarray) -> tuple:
    """``.int8()`` of the bf16_direct file on the card (fast, calibrated on
    four of the rows): as many QLinearConv nodes as the port's quantizer
    makes on the host from the same calibration, every node of the card's
    int8 graph against its CPU lowering (check_int8_nodes: codes equal, 1
    apart only after a transcendental epilogue; floats within
    FLOAT_NODE_TOL), B3 launched. Returns (its line, its run's launch
    counts)."""
    t0 = time.perf_counter()
    calibration = segs[:4]
    # The int8 run: every count starts at 0 here.
    reset_launches()
    clf = (Classifier.builder().model_path(path).labels(LABELS).precision("fast")
           .top_k(5).int8(calibration).build())
    logits = logits_of(clf.predict_batch(segs))
    launches = read_launches()
    qlinear = lambda m: sum(n.op_type == "QLinearConv" for n in m.graph.node)
    host = quantize_model(import_onnx(path), [calibration], device="cpu")
    line = {"phase": "dtypes_int8", "form": "bf16_direct", "card": card,
            "qlinearconv_card": qlinear(clf._imported), "qlinearconv_host": qlinear(host),
            "nodes_card_vs_cpu": check_int8_nodes(path, "fast", segs[:4], forward_line=False),
            "launches": {k: n for k, n in launches.items() if n},
            "check_s": time.perf_counter() - t0}
    line["ok"] = bool(line["qlinearconv_card"] == line["qlinearconv_host"] > 0
                      and launches["qconv1x1_requant"] > 0
                      and logits.shape == (N_SEG, birdnet_v24.NUM_SPECIES)
                      and np.isfinite(logits).all())
    return line, launches


def phase_dtypes(card: str, segs: np.ndarray, forms=None) -> dict:
    """BirdNET v2.4 at full width (conv) in the weight forms users ship:
    bfloat16-stored, FP8 QDQ and int4 blocks, each against its yardstick
    file on the card and against the port on the host; and with four
    interior layers computing in bfloat16 (bf16_direct: its card within
    DIRECT_TOL of the host, its distance from the yardstick printed, and its
    ``.int8()``, direct_int8_check); the stream, the batch context and a
    .btck round trip; the rates beside the yardstick's. Returns the phase's
    launch counts (the forms' own runs)."""
    t_phase = time.perf_counter()
    sys.path.insert(0, str(REPO / "tests"))
    from _torch_dtype_forms import FORMS, form_bytes

    model = birdnet_v24.build_model(seed=SEED, frontend="conv")
    pcm = (np.random.default_rng(SEED + 30).standard_normal(HOUR, dtype=np.float32) * 3000
           ).clip(-32768, 32767).astype(np.int16)
    minutes = pcm[:DTYPES_STREAM_SECONDS * 48_000]
    audio = chunk_audio(minutes.astype(np.float32) / 32768.0, S, 0.0, 48_000)[0]
    failed, launches = [], {k: 0 for k in read_launches()}
    with tempfile.TemporaryDirectory() as tmp:
        for form in forms or FORMS:
            t_form = time.perf_counter()
            path, yard_path = str(Path(tmp) / f"{form}.onnx"), str(Path(tmp) / f"{form}_yard.onnx")
            stored, yard_bytes = form_bytes(model, form)
            Path(path).write_bytes(stored)
            Path(yard_path).write_bytes(yard_bytes)
            # The form's run: every count starts at 0 here.
            reset_launches()
            fp32, fast = built(path, LABELS, "fp32"), built(path, LABELS, "fast")
            ref = logits_of(fp32.predict_batch(segs))
            fast_logits = logits_of(fast.predict_batch(segs))
            ctx = fast.create_batch_context(N_SEG)
            in_ctx = logits_of(fast.predict_batch_with_context(ctx, segs))
            stream_fp32 = streamed(fp32, minutes, 0.0)
            after = read_launches()
            yard32, yard_fast = built(yard_path, LABELS, "fp32"), built(yard_path, LABELS, "fast")
            yard_ref = logits_of(yard32.predict_batch(segs))
            # A lead below twice the drift that fast shows on the same
            # weights stored in float32 (the yardstick, on the main path)
            # can flip there too: the top-1 rule reads rows that lead by
            # more than that and by more than CLEAR_LEAD.
            yard_drift = scaled_diff(logits_of(yard_fast.predict_batch(segs)), yard_ref)
            clear_lead = max(CLEAR_LEAD, 2 * yard_drift)
            host = (Classifier.builder().model_path(path).labels(LABELS).precision("fp32")
                    .with_device("cpu").build())
            host_logits = logits_of(host.predict_batch(segs[:DTYPES_CPU_ROWS]))
            del host
            with tempfile.TemporaryDirectory() as ck_dir:
                ck = str(Path(ck_dir) / f"{form}.btck")
                fp32.save_checkpoint(ck)
                from_ck = logits_of(built(ck, LABELS, "fp32").predict_batch(segs))
            stream_vs = stream_against_predict_batch(fp32, audio, stream_fp32)
            yard_ctx = yard_fast.create_batch_context(N_SEG)
            for clf in (fast, yard_fast):
                clf._streaming_engine().tile = DTYPES_TILE
                streamed(clf, minutes, 0.0)  # captures the key's graphs
            # Each rate in turns with the yardstick's (form, yardstick,
            # yardstick, form), medians.
            pairs = {form: (fast, ctx), "yardstick": (yard_fast, yard_ctx)}
            rates = {
                "predict_batch32": in_turns(
                    {k: lambda n, c=c: seg_per_s(c, segs, n) for k, (c, _) in pairs.items()}),
                "context": in_turns(
                    {k: lambda n, c=c, x=x: statistics.median(context_rates(c, x, segs, n))
                     for k, (c, x) in pairs.items()}),
                f"stream_hour_tile{DTYPES_TILE}": in_turns(
                    {k: lambda n, c=c: stream_rate(c, pcm) for k, (c, _) in pairs.items()}),
            }
            line = {"phase": "dtypes", "form": form, "card": card,
                    "initializer_types": sorted({
                        P.WIRE_NAMES.get(t.data_type) or str(P._DTYPE_TO_NUMPY[t.data_type])
                        for t in P.decode_model(stored).graph.initializer}),
                    "ops": sorted({n.op_type for n in import_onnx(path).graph.node}),
                    "fp32_scaled_diff_vs_yardstick": scaled_diff(ref, yard_ref),
                    "fp32_scaled_diff_card_vs_cpu": scaled_diff(ref[:DTYPES_CPU_ROWS],
                                                                host_logits),
                    "scaled_logit_diff_fast_vs_fp32": scaled_diff(fast_logits, ref),
                    "yardstick_scaled_logit_diff_fast_vs_fp32": yard_drift,
                    "top1_fast_vs_fp32": top1_where_clear(fast_logits, ref, clear_lead),
                    "top1_clear_lead": clear_lead,
                    "stream_segments": int(stream_fp32[0].shape[0]),
                    "stream_vs_predict_batch": stream_vs,
                    "context_logits_bitwise_equal": bool(np.array_equal(in_ctx, fast_logits)),
                    "btck_logits_bitwise_equal": bool(np.array_equal(from_ck, ref)),
                    "launches": {k: n for k, n in after.items() if n},
                    "seg_per_s": rates, "form_s": time.perf_counter() - t_form}
            direct = form == "bf16_direct"
            ok = (np.isfinite(ref).all() and ref.shape == (N_SEG, birdnet_v24.NUM_SPECIES)
                  and (direct or line["fp32_scaled_diff_vs_yardstick"] <= DTYPES_TOL)
                  and line["fp32_scaled_diff_card_vs_cpu"] <= (
                      DIRECT_TOL if direct else DTYPES_TOL)
                  and line["top1_fast_vs_fp32"]["ok"]
                  and int((fast_logits.argmax(1) == ref.argmax(1)).sum()) >= MIN_TOP1_AGREE
                  and line["stream_segments"] == audio.shape[0]
                  and stream_vs["topk_equal"]
                  and stream_vs["max_conf_diff"] <= STREAM_CONF_TOL
                  and ctx.graph is not None
                  and line["context_logits_bitwise_equal"]
                  and line["btck_logits_bitwise_equal"])
            line["ok"] = bool(ok)
            emit(line)
            if not ok:
                failed.append(form)
            launches = {k: launches[k] + after[k] for k in launches}
            del fp32, fast, ctx, yard32, yard_fast, yard_ctx
            torch.cuda.empty_cache()
            if direct:
                int8_line, int8_after = direct_int8_check(card, path, segs)
                emit(int8_line)
                if not int8_line["ok"]:
                    failed.append("bf16_direct int8")
                launches = {k: launches[k] + int8_after[k] for k in launches}
                torch.cuda.empty_cache()
    mld = "ml_dtypes" in sys.modules and sys.modules["ml_dtypes"] is not None
    emit({"phase": "dtypes_done", "card": card, "ml_dtypes_imported": mld,
          "phase_s": time.perf_counter() - t_phase})
    if failed or mld:
        raise AssertionError(f"dtypes: forms {failed} disagree, ml_dtypes imported: {mld}")
    return launches


# The concurrency phase: CONC_STREAMS threads each stream CONC_SECONDS of
# int16 on one classifier while a fifth makes and calls a batch context.
CONC_STREAMS = 4
CONC_SECONDS = 600
CONC_CALLS = 3
# (c)'s overlaps: a new streaming key for each stream thread.
CONC_NEW_OVERLAPS = (0.5, 1.0, 1.5, 2.0)
CONC_MEMORY_SLACK = 1 << 20


def stream_arrays(results) -> tuple:
    """(start times, indices, confidences) of analyze_samples' results."""
    return (np.array([t for t, _ in results], np.float64),
            np.array([[p.index for p in preds] for _, preds in results], np.int64),
            np.array([[p.confidence for p in preds] for _, preds in results], np.float32))


def bitwise(a: tuple, b: tuple) -> bool:
    return all(np.array_equal(x, y) for x, y in zip(a, b))


def concurrent_round(workers, clf, recs, overlaps, segs, ctx=None) -> dict:
    """On ``workers`` (one single-thread executor per caller, so that each
    caller keeps its thread, and the cuBLAS workspace that torch keeps on
    the card for each thread and stream, from round to round),
    CONC_STREAMS threads stream ``recs[k]`` at ``overlaps[k]`` (at least
    CONC_CALLS calls each, and until the fifth is done) while a fifth
    thread makes a batch context of N_SEG (when ``ctx`` is None: its capture
    runs beside the streams) and calls it and predict_batch(N_SEG)
    CONC_CALLS times. Returns every answer and every error."""
    streams = [[] for _ in recs]
    out = {"errors": [], "streams": streams, "context": [], "predict_batch": [], "ctx": ctx}
    start, fifth_done = threading.Barrier(len(recs) + 1), threading.Event()

    def streamer(k):
        try:
            start.wait()
            while len(streams[k]) < CONC_CALLS or not fifth_done.is_set():
                streams[k].append(stream_arrays(
                    clf.analyze_samples(recs[k], overlap_seconds=overlaps[k])))
        except Exception as e:  # noqa: BLE001 - reported and failed below
            out["errors"].append(f"stream {k}: {type(e).__name__}: {e}")

    def fifth():
        try:
            start.wait()
            if out["ctx"] is None:
                out["ctx"] = clf.create_batch_context(N_SEG)
            for _ in range(CONC_CALLS):
                out["context"].append(logits_of(clf.predict_batch_with_context(out["ctx"], segs)))
                out["predict_batch"].append(logits_of(clf.predict_batch(segs)))
        except Exception as e:  # noqa: BLE001 - reported and failed below
            out["errors"].append(f"context: {type(e).__name__}: {e}")
        finally:
            fifth_done.set()

    tasks = [workers[k].submit(streamer, k) for k in range(len(recs))]
    tasks.append(workers[-1].submit(fifth))
    for task in tasks:
        task.result()
    return out


def round_agrees(out, serial_streams, serial_logits) -> dict:
    """Every answer of a concurrent round against the serial ones."""
    return {"errors": out["errors"],
            "stream_calls": [len(s) for s in out["streams"]],
            "streams_bitwise": all(bitwise(got, serial_streams[k])
                                   for k, calls in enumerate(out["streams"]) for got in calls),
            "context_calls": len(out["context"]),
            "context_bitwise": all(np.array_equal(g, serial_logits) for g in out["context"]),
            "predict_batch_bitwise": all(np.array_equal(g, serial_logits)
                                         for g in out["predict_batch"])}


def phase_concurrency(card: str, path: str) -> dict:
    """Concurrent callers on one classifier (full-width v2.4 conv at fast),
    the reference's thread-safety claim (tests/test_engine_internals.py's
    four streaming threads) on the card: (a) CONC_STREAMS threads stream ten
    minutes of int16 each, every result equal to a serial call bit for
    bit; (b) during (a), a fifth thread makes the classifier's first batch
    context (its CUDA graph capture) and calls it and predict_batch(32)
    CONC_CALLS times, every answer equal to the serial one bit for bit;
    (c) (a) and (b) again with each stream thread's first call at a new
    streaming key (its capture) and a second context, so that captures of
    the stream and of the context overlap; then a round on the same keys and
    context, after which the keys and the device memory are what they were
    (within CONC_MEMORY_SLACK). No call may raise. Returns the phase's
    launch counts (B2 and B4 must launch)."""
    t_phase = time.perf_counter()
    clf = built(path, LABELS, "fast")
    eng = clf._streaming_engine()
    rng = np.random.default_rng(SEED + 70)
    recs = [(rng.standard_normal(CONC_SECONDS * 48_000, dtype=np.float32) * 3000)
            .clip(-32768, 32767).astype(np.int16) for _ in range(CONC_STREAMS)]
    segs = (np.random.default_rng(SEED + 71).normal(size=(N_SEG, S)) * 0.1).astype(np.float32)
    zero = [0.0] * CONC_STREAMS
    # The serial answers (overlap 0's key is captured here).
    serial = [stream_arrays(clf.analyze_samples(r)) for r in recs]
    serial_logits = logits_of(clf.predict_batch(segs))
    # The phase's run: every count starts at 0 here.
    reset_launches()
    workers = [ThreadPoolExecutor(1) for _ in range(CONC_STREAMS + 1)]
    try:
        a_b = concurrent_round(workers, clf, recs, zero, segs)
        torch.cuda.synchronize()
        after_a_b = torch.cuda.memory_allocated()
        c = concurrent_round(workers, clf, recs, CONC_NEW_OVERLAPS, segs)
        torch.cuda.synchronize()
        serial_c = [stream_arrays(clf.analyze_samples(r, overlap_seconds=o))
                    for r, o in zip(recs, CONC_NEW_OVERLAPS)]
        keys, memory = sorted(eng.programs), torch.cuda.memory_allocated()
        again = concurrent_round(workers, clf, recs, CONC_NEW_OVERLAPS, segs,
                                 ctx=c["ctx"] or clf.create_batch_context(N_SEG))
        torch.cuda.synchronize()
    finally:
        for worker in workers:
            worker.shutdown()
    launches = read_launches()
    rounds = {"a_b": round_agrees(a_b, serial, serial_logits),
              "c": round_agrees(c, serial_c, serial_logits),
              "same_keys": round_agrees(again, serial_c, serial_logits)}
    line = {"phase": "concurrency", "card": card, "threads": CONC_STREAMS + 1,
            "stream_seconds": CONC_SECONDS, "rounds": rounds,
            "contexts_captured": [r["ctx"] is not None and r["ctx"].graph is not None
                                  for r in (a_b, c)],
            "keys": stream_keys(clf), "keys_stable": sorted(eng.programs) == keys,
            "memory_delta_bytes": torch.cuda.memory_allocated() - memory,
            "memory_after_rounds": [after_a_b, memory, torch.cuda.memory_allocated()],
            "launches": {k: n for k, n in launches.items() if n},
            "phase_s": time.perf_counter() - t_phase}
    line["ok"] = bool(
        all(not r["errors"] and r["streams_bitwise"] and r["context_bitwise"]
            and r["predict_batch_bitwise"] and r["context_calls"] == CONC_CALLS
            and min(r["stream_calls"]) >= CONC_CALLS for r in rounds.values())
        and all(line["contexts_captured"]) and line["keys_stable"]
        and len(keys) == 1 + len(CONC_NEW_OVERLAPS) and not eager_graph_keys(line["keys"])
        and abs(line["memory_delta_bytes"]) <= CONC_MEMORY_SLACK
        and launches["filterbank_logpower"] > 0 and launches["stage_stack_forward"] > 0)
    emit(line)
    if not line["ok"]:
        raise AssertionError(f"concurrency: {line}")
    del clf, a_b, c, again
    torch.cuda.empty_cache()
    return launches


def device_kernel_names(fn) -> dict:
    """{device kernel name: launches} in a torch.profiler trace of one call
    of ``fn``: the third of three, the first two a wait and a warm-up step
    of the profiler's schedule (traced right after the profiler starts, a
    graph replay's first kernels can be missing from the trace)."""
    from torch.profiler import ProfilerActivity, profile, schedule

    with tempfile.TemporaryDirectory() as tmp:
        trace = os.path.join(tmp, "replay.json")
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=1, warmup=1, active=1, repeat=1),
                     on_trace_ready=lambda prof: prof.export_chrome_trace(trace)) as prof:
            for _ in range(3):
                fn()
                torch.cuda.synchronize()
                prof.step()
        events = json.loads(Path(trace).read_text())["traceEvents"]
    names = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == "kernel":
            names[e["name"]] = names.get(e["name"], 0) + 1
    return names


def phase_batch_context(card: str, path: str, segs: np.ndarray) -> dict:
    """Full-width v2.4 (conv) at fast: create_batch_context(32) captures
    its CUDA graph (B2 and B4 count their launches then); the context's
    top-K and logits against predict_batch on a full batch and on a batch
    of 7; a profiler trace of one replay must show B2's and B4's kernels;
    then its rate against predict_batch(32), a median of 10 calls each in
    turns. Returns the capture's launch counts."""
    clf = built(path, LABELS, "fast")
    reset_launches()
    t0 = time.perf_counter()
    ctx = clf.create_batch_context(N_SEG)
    capture_s = time.perf_counter() - t0
    launches = read_launches()
    if ctx.graph is None:
        raise AssertionError("batch context: no CUDA graph on the card")
    for kname in ("filterbank_logpower", "stage_stack_forward"):
        if launches[kname] <= 0:
            raise AssertionError(f"batch context: {kname} was not captured")

    def compare(got, want) -> dict:
        lg, wl = logits_of(got), logits_of(want)
        idx_equal = all([p.index for p in g.predictions] == [p.index for p in w.predictions]
                        for g, w in zip(got, want))
        conf = max(abs(p.confidence - q.confidence) for g, w in zip(got, want)
                   for p, q in zip(g.predictions, w.predictions))
        return {"logits_equal": bool(np.array_equal(lg, wl)),
                "scaled_logit_diff": scaled_diff(lg, wl), "topk_indices_equal": idx_equal,
                "max_conf_diff": conf}

    full = compare(clf.predict_batch_with_context(ctx, segs), clf.predict_batch(segs))
    short_got = clf.predict_batch_with_context(ctx, segs[:7])
    short = compare(short_got, clf.predict_batch(segs[:7]))
    padded = np.concatenate([segs[:7], np.zeros((N_SEG - 7, S), np.float32)])
    short_padded = compare(short_got, clf.predict_batch(padded)[:7])
    kernels = device_kernel_names(lambda: clf.predict_batch_with_context(ctx, segs))
    b2 = sum(n for k, n in kernels.items() if "filterbank_logpower" in k)
    b4 = sum(n for k, n in kernels.items() if any(b in k for b in B4_KERNELS))
    rates = {"context": [], "predict_batch": []}
    for _ in range(10):
        for name, fn in (("context", lambda: clf.predict_batch_with_context(ctx, segs)),
                         ("predict_batch", lambda: clf.predict_batch(segs))):
            t0 = time.perf_counter()
            fn()
            rates[name].append(N_SEG / (time.perf_counter() - t0))
    line = {"phase": "batch_context", "card": card, "max_batch": ctx.max_batch_size,
            "capture_s": capture_s, "captured_launches": launches,
            "full_batch_vs_predict_batch": full, "batch7_vs_predict_batch": short,
            "batch7_vs_padded_predict_batch": short_padded,
            "replay_trace_b2_kernels": b2, "replay_trace_b4_kernels": b4,
            "replay_trace_kernels": len(kernels),
            "seg_per_s_context_median": statistics.median(rates["context"]),
            "seg_per_s_predict_batch_median": statistics.median(rates["predict_batch"]),
            "input_buffer_bytes": ctx.input_buffer_bytes()}
    line["ok"] = (full["logits_equal"] and full["topk_indices_equal"]
                  and short_padded["logits_equal"] and short_padded["topk_indices_equal"]
                  and short["topk_indices_equal"] and short["scaled_logit_diff"] < 1e-2
                  and b2 > 0 and b4 > 0)
    emit(line)
    if not line["ok"]:
        raise AssertionError(f"batch context: {line}")
    return launches

# The serve phase: 64 client threads of 16 requests each (1,024) cycle
# through a pool of seeded int16 segments; each answer's top-K against the
# batch context's on the same segment, confidences within SERVE_CONF_TOL
# (bitwise expected: every batch replays a graph captured at max_batch);
# device memory across the 1,024 requests may grow by at most
# SERVE_DEVICE_GROWTH bytes.
SERVE_THREADS, SERVE_PER_THREAD, SERVE_POOL = 64, 16, 128
SERVE_MAX_BATCH, SERVE_WAIT_MS = 32, 5.0
SERVE_CONF_TOL = 1e-3
SERVE_DEVICE_GROWTH = 1 << 20
PERCH_SERVE_REQUESTS = 8


def rss_mib() -> float:
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS"):
                return int(line.split()[1]) / 1024.0
    return float("nan")


class Serving:
    """A port server on an ephemeral localhost port, serving in a thread
    until the ``with`` block ends; then shut down, its batcher closed."""

    def __init__(self, clf, **kwargs):
        self.server = make_server(clf, host="127.0.0.1", port=0, **kwargs)
        self.base = "http://%s:%d" % self.server.server_address[:2]
        self.thread = threading.Thread(target=self.server.serve_forever, daemon=True)

    def __enter__(self) -> "Serving":
        self.thread.start()
        return self

    def __exit__(self, *exc) -> None:
        self.server.shutdown()
        self.server.state.close()
        self.server.server_close()
        self.thread.join(timeout=60)
        if self.thread.is_alive():
            raise AssertionError("serve: the server thread did not stop")


def warm_blas_handles(n: int) -> int:
    """Run one cuBLAS product in each of ``n`` host threads alive at once;
    returns the device bytes this left allocated. PyTorch gives each host
    thread that calls cuBLAS a handle of its own with a workspace from the
    caching allocator (32 MiB each on an H100) and, when
    the thread ends, returns the handle, workspace and all, to a pool that
    later threads draw from. A server's /v1/analyze requests run on new
    handler threads, so the first ones grow the allocation by one
    workspace per request in flight; later ones reuse the pool."""
    a = torch.ones((64, 64), device=CARD)
    barrier = threading.Barrier(n)

    def product() -> None:
        barrier.wait(timeout=60)
        (a @ a).sum().item()
        barrier.wait(timeout=60)

    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    threads = [threading.Thread(target=product) for _ in range(n)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=60)
    torch.cuda.synchronize()
    return torch.cuda.memory_allocated() - before


# The load generator of serve_traffic_elsewhere: stdlib and numpy only, so
# the process starts in well under a second. Arguments: the server's URL,
# the pool's seed, its size, the segment length, threads, requests per
# thread. Prints one JSON line: seconds, client latencies (ms), and each
# answer's (indices, confidences).
LOADGEN = r"""
import json, sys, threading, time, urllib.request
import numpy as np
base, seed, pool_n, s, threads, per = sys.argv[1], *map(int, sys.argv[2:])
pool = (np.random.default_rng(seed).standard_normal((pool_n, s), dtype=np.float32) * 3000
        ).clip(-32768, 32767).astype(np.int16)
n = threads * per
answers, lat, errors = [None] * n, [0.0] * n, []
# urlopen builds its opener (an SSL context with the system's certificates)
# on first use; build it once here, not in 64 threads at once.
urllib.request.install_opener(urllib.request.build_opener())

def client(t):
    for j in range(per):
        r = t * per + j
        req = urllib.request.Request(base + "/v1/predict?dtype=i16",
                                     data=pool[r % pool_n].astype("<i2").tobytes(),
                                     headers={"Content-Type": "application/octet-stream"})
        t0 = time.perf_counter()
        try:
            with urllib.request.urlopen(req, timeout=300) as resp:
                preds = json.loads(resp.read())["predictions"]
        except Exception as e:
            errors.append(repr(e))
            return
        lat[r] = 1e3 * (time.perf_counter() - t0)
        answers[r] = ([p["index"] for p in preds], [p["confidence"] for p in preds])

ths = [threading.Thread(target=client, args=(t,)) for t in range(threads)]
t0 = time.perf_counter()
for th in ths:
    th.start()
for th in ths:
    th.join()
print(json.dumps({"seconds": time.perf_counter() - t0, "latencies": lat,
                  "answers": answers, "errors": errors[:3]}))
"""


def serve_traffic_elsewhere(base: str, seed: int) -> tuple:
    """serve_traffic's load from a process of its own (LOADGEN), so that
    the clients do not share the server's interpreter: (answers as
    (indices, confidences), seconds, client latencies in ms)."""
    proc = subprocess.run(
        [sys.executable, "-c", LOADGEN, base, str(seed), str(SERVE_POOL), str(S),
         str(SERVE_THREADS), str(SERVE_PER_THREAD)],
        capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"serve load generator exited {proc.returncode}: {proc.stderr[-2000:]}")
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    if out["errors"] or any(a is None for a in out["answers"]):
        raise AssertionError(f"serve load generator: failed requests, e.g. {out['errors']}")
    return out["answers"], out["seconds"], out["latencies"]


def serve_traffic(base: str, pool: np.ndarray, during=()) -> tuple:
    """SERVE_THREADS client threads, each posting SERVE_PER_THREAD segments
    of ``pool`` (request r takes ``pool[r % len(pool)]``) as i16 PCM through
    ServeClient.predict, with the callables ``during`` running in threads of
    their own beside them. Returns (answers in request order, seconds until
    the last predict answered, client-side latencies in ms)."""
    n = SERVE_THREADS * SERVE_PER_THREAD
    answers, latencies, errors = [None] * n, [0.0] * n, []

    def client(t: int) -> None:
        c = ServeClient(base)
        for j in range(SERVE_PER_THREAD):
            r = t * SERVE_PER_THREAD + j
            t0 = time.perf_counter()
            try:
                answers[r] = c.predict(pool[r % len(pool)])
            except Exception as e:  # noqa: BLE001 - every failure is reported below
                errors.append(repr(e))
                return
            latencies[r] = 1e3 * (time.perf_counter() - t0)

    clients = [threading.Thread(target=client, args=(t,)) for t in range(SERVE_THREADS)]
    others = [threading.Thread(target=fn) for fn in during]
    t0 = time.perf_counter()
    for th in others + clients:
        th.start()
    for th in clients:
        th.join(timeout=600)
    seconds = time.perf_counter() - t0
    for th in others:
        th.join(timeout=600)
    if errors or any(th.is_alive() for th in clients + others):
        raise AssertionError(f"serve: {len(errors)} failed requests, e.g. {errors[:2]}")
    return answers, seconds, latencies


def detections_agree(got, want) -> dict:
    """Served detections against analyze_samples, by the stream phase's
    rule: the same start times, confidences within STREAM_CONF_TOL, equal
    top-1 wherever its lead over the runner-up exceeds it."""
    conf = np.array([[p.confidence for p in ps] for _, ps in got], np.float32)
    ref = np.array([[p.confidence for p in ps] for _, ps in want], np.float32)
    idx = np.array([[p.index for p in ps] for _, ps in got])
    ref_idx = np.array([[p.index for p in ps] for _, ps in want])
    same_times = [round(t, 3) for t, _ in got] == [round(t, 3) for t, _ in want]
    if not same_times or conf.shape != ref.shape:
        return {"ok": False, "same_times": same_times, "shapes": [conf.shape, ref.shape]}
    diff = float(np.abs(conf - ref).max())
    clear = ref[:, 0] - ref[:, 1] > STREAM_CONF_TOL
    top1 = int((idx[clear, 0] == ref_idx[clear, 0]).sum())
    return {"segments": int(conf.shape[0]), "max_conf_diff": diff,
            "top1_equal_where_clear": f"{top1}/{int(clear.sum())}",
            "bitwise": bool(np.array_equal(conf, ref) and np.array_equal(idx, ref_idx)),
            "ok": diff <= STREAM_CONF_TOL and top1 == int(clear.sum())}


def phase_serve(card: str, path: str) -> dict:
    """The serving tier on the card: make_server over full-width v2.4
    (conv, fast) with the full-size meta model, first with one batcher
    worker and then with two, each started after the previous one closed.
    1,024 i16 predicts from 64 client threads, each answer against the
    batch context on the same segment (top-K indices equal, confidences
    within SERVE_CONF_TOL); two /v1/analyze posts of a 60 s 48 kHz WAV
    during that traffic, against analyze_samples (the stream phase's rule);
    one /v1/rangefilter and one predict with lat/lon/date against
    RangeFilter.predict (RANGE_TOL); device memory across the 1,024 requests
    flat (SERVE_DEVICE_GROWTH). Then, with no analyze beside them, requests/s
    at concurrency 64 and /v1/metrics' latencies and batch fill, in turns
    with predict_batch_with_context(32)'s seg/s. Then full-width Perch v2
    (conv, fast; no batch context: the batcher pads to max_batch and calls
    predict_batch): 8 concurrent predicts with embeddings and one /v1/embed
    of 60 s at 32 kHz against predict_batch and embed_samples (the families
    phase's rule). Returns the launch counts of the servers' runs (the
    contexts' captures, the analyze streams, Perch's eager path)."""
    # LOADGEN makes the same pool from the same seed.
    rng = np.random.default_rng(SEED + 12)
    pool = (rng.standard_normal((SERVE_POOL, S), dtype=np.float32) * 3000
            ).clip(-32768, 32767).astype(np.int16)
    pool_f32 = pool.astype(np.float32) / 32768.0
    launches = {k: 0 for k in read_launches()}

    def add_launches() -> None:
        for k, v in read_launches().items():
            launches[k] += v

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        wav, meta_path = tmp / "a.wav", str(tmp / "meta.onnx")
        write_wav(wav, (np.random.default_rng(SEED + 13).standard_normal(60 * 48_000) * 0.1
                        ).astype(np.float32), 48_000)
        samples = read_wav(wav, dtype="int16")[0]
        P.save_model(meta.build_model(seed=SEED), meta_path)
        clf = built(path, LABELS, "fast")
        rf = RangeFilter.builder().model_path(meta_path).labels(LABELS).build()
        ctx = clf.create_batch_context(SERVE_MAX_BATCH)
        ref = [r for i in range(0, SERVE_POOL, SERVE_MAX_BATCH)
               for r in clf.predict_batch_with_context(ctx, pool_f32[i:i + SERVE_MAX_BATCH])]
        ref_detections = clf.analyze_samples(samples)
        ref_scores = {s.species: s.score for s in rf.predict(42.5, -76.4, 6, 15)}
        ref_filtered = [p.species for p in rf.filter_predictions(
            ref[0].predictions, rf.predict(42.5, -76.4, 6, 15))]
        failed = []
        for workers in (1, 2):
            reset_launches()
            with Serving(clf, max_batch=SERVE_MAX_BATCH, max_wait_ms=SERVE_WAIT_MS,
                         range_filter=rf, workers=workers) as srv:
                c = ServeClient(srv.base)
                c.predict(pool[0])
                # The two analyze posts below run on handler threads of their
                # own: their cuBLAS handles are drawn (the first time, made)
                # before the window opens.
                blas_growth = warm_blas_handles(2)
                analyzed = []
                during = [lambda: analyzed.append(c.analyze_wav(str(wav)))] * 2
                torch.cuda.synchronize()
                mem0, rss0 = torch.cuda.memory_allocated(), rss_mib()
                answers, seconds, _ = serve_traffic(srv.base, pool, during)
                torch.cuda.synchronize()
                mem1, rss1 = torch.cuda.memory_allocated(), rss_mib()
                conf_diff, topk_equal, bitwise = 0.0, True, True
                for r, preds in enumerate(answers):
                    want = ref[r % SERVE_POOL].predictions
                    topk_equal &= [p.index for p in preds] == [p.index for p in want]
                    d = [abs(p.confidence - q.confidence) for p, q in zip(preds, want)]
                    conf_diff = max(conf_diff, max(d))
                    bitwise &= max(d) == 0.0
                analyze = [detections_agree(a, ref_detections) for a in analyzed]
                scores = {s.species: s.score for s in c.rangefilter(42.5, -76.4, date="06-15")}
                range_diff = (max(abs(scores[k] - ref_scores[k]) for k in ref_scores)
                              if scores.keys() == ref_scores.keys() else float("inf"))
                filtered = [p.species for p in c.predict(pool[0], lat=42.5, lon=-76.4,
                                                         date="06-15")]
                # Rates with no analyze beside them, in turns with the
                # batch context's: the clients as threads of this process
                # (sharing the server's interpreter), then as threads of a
                # process of their own.
                rates = {"serve_req_per_s": [], "context_seg_per_s": [],
                         "serve_req_per_s_clients_elsewhere": []}
                metrics, elsewhere_topk_equal = [], True
                for name in ("serve", "context", "elsewhere", "elsewhere", "context", "serve"):
                    if name == "context":
                        rates["context_seg_per_s"].append(
                            statistics.median(context_rates(clf, ctx, pool_f32)))
                        continue
                    srv.server.state.batcher.metrics.reset()
                    if name == "serve":
                        _, secs, lat = serve_traffic(srv.base, pool)
                        rates["serve_req_per_s"].append(len(lat) / secs)
                    else:
                        got, secs, lat = serve_traffic_elsewhere(srv.base, SEED + 12)
                        rates["serve_req_per_s_clients_elsewhere"].append(len(lat) / secs)
                        elsewhere_topk_equal &= all(
                            idx == [p.index for p in ref[r % SERVE_POOL].predictions]
                            for r, (idx, _) in enumerate(got))
                    m = c.metrics()
                    metrics.append({"clients": name, "latency_p50_ms": m["latency_p50_ms"],
                                    "latency_p99_ms": m["latency_p99_ms"],
                                    "mean_batch_fill": m["mean_batch_fill"],
                                    "client_p50_ms": float(np.percentile(lat, 50)),
                                    "client_p99_ms": float(np.percentile(lat, 99))})
                errors_total = c.metrics()["errors_total"]
            add_launches()
            line = {"phase": "serve", "model": "birdnet_v24 conv fast", "workers": workers,
                    "card": card, "max_batch": SERVE_MAX_BATCH, "max_wait_ms": SERVE_WAIT_MS,
                    "concurrency": SERVE_THREADS, "requests": len(answers),
                    "checked_run_seconds": seconds,
                    "topk_equal_to_context": topk_equal,
                    "max_abs_conf_diff_vs_context": conf_diff, "bitwise": bitwise,
                    "analyze_under_load": analyze, "range_filter_max_abs_diff": range_diff,
                    "predict_with_location_equal": filtered == ref_filtered,
                    "device_mem_growth_bytes": mem1 - mem0,
                    "blas_handle_warmup_bytes": blas_growth,
                    "topk_equal_clients_elsewhere": elsewhere_topk_equal,
                    "host_rss_growth_mib": rss1 - rss0, "errors_total": errors_total,
                    **rates, "metrics": metrics,
                    "launches": {k: v for k, v in read_launches().items() if v}}
            line["ok"] = (topk_equal and elsewhere_topk_equal and conf_diff <= SERVE_CONF_TOL
                          and len(analyze) == 2
                          and all(a["ok"] for a in analyze) and range_diff <= RANGE_TOL
                          and filtered == ref_filtered and errors_total == 0
                          and mem1 - mem0 <= SERVE_DEVICE_GROWTH)
            emit(line)
            if not line["ok"]:
                failed.append(f"v2.4 workers={workers}")
        del clf, ctx, rf

        perch_path = str(tmp / "perch_conv.onnx")
        P.save_model(perch_v2.build_model(seed=SEED, frontend="conv"), perch_path)
        perch = built(perch_path, family_labels(perch_v2.NUM_SPECIES), "fast")
        rng = np.random.default_rng(SEED + 14)
        segs = (rng.standard_normal((PERCH_SERVE_REQUESTS, FAMILY_S), dtype=np.float32)
                * 3000).clip(-32768, 32767).astype(np.int16)
        padded = np.zeros((SERVE_MAX_BATCH, FAMILY_S), np.float32)
        padded[:PERCH_SERVE_REQUESTS] = segs.astype(np.float32) / 32768.0
        ref = perch.predict_batch(padded)[:PERCH_SERVE_REQUESTS]
        pcm = (np.random.default_rng(SEED + 15).standard_normal(60 * FAMILY_RATE) * 3000
               ).clip(-32768, 32767).astype(np.int16)
        ref_emb, ref_times = perch.embed_samples(pcm)
        reset_launches()
        with Serving(perch, max_batch=SERVE_MAX_BATCH, max_wait_ms=SERVE_WAIT_MS) as srv:
            got = [None] * PERCH_SERVE_REQUESTS

            def post(i: int) -> None:
                got[i] = ServeClient(srv.base).predict(segs[i], embeddings=True)

            threads = [threading.Thread(target=post, args=(i,))
                       for i in range(PERCH_SERVE_REQUESTS)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=600)
            emb, times = ServeClient(srv.base).embed(pcm, rate=FAMILY_RATE)
            fill = ServeClient(srv.base).metrics()["mean_batch_fill"]
        add_launches()
        perch_launches = read_launches()
        if any(g is None for g in got):
            raise AssertionError("serve perch: a predict did not answer")
        conf_diff = max(abs(p.confidence - q.confidence) for (preds, _), r in zip(got, ref)
                        for p, q in zip(preds, r.predictions))
        topk_equal = all([p.index for p in preds] == [p.index for p in r.predictions]
                         for (preds, _), r in zip(got, ref))
        vec_diff = scaled_diff(np.stack([v for _, v in got]), embeddings_of(ref))
        line = {"phase": "serve", "model": "perch_v2 conv fast", "card": card,
                "requests": PERCH_SERVE_REQUESTS, "mean_batch_fill": fill,
                "topk_equal_to_predict_batch": topk_equal,
                "max_abs_conf_diff_vs_predict_batch": conf_diff,
                "embedding_scaled_diff_vs_predict_batch": vec_diff,
                "embed_segments": int(emb.shape[0]),
                "embed_scaled_diff_vs_embed_samples": scaled_diff(emb, ref_emb),
                "launches": {k: v for k, v in perch_launches.items() if v}}
        line["ok"] = (topk_equal and conf_diff <= STREAM_CONF_TOL
                      and vec_diff < SCALED_LOGIT_TOL and emb.shape == ref_emb.shape
                      and line["embed_scaled_diff_vs_embed_samples"] < SCALED_LOGIT_TOL
                      and np.allclose(times, np.round(ref_times, 3))
                      and perch_launches["filterbank_logpower"] > 0)
        emit(line)
        if not line["ok"]:
            failed.append("perch")
    if failed:
        raise AssertionError(f"serve: {failed}")
    for kname in ("filterbank_logpower", "stage_stack_forward"):
        if launches[kname] <= 0:
            raise AssertionError(f"serve: {kname} was never launched")
    return launches


def context_rates(clf, ctx, segs: np.ndarray, calls: int = 10) -> list:
    """segments/s of ``calls`` predict_batch_with_context calls on the first
    max_batch rows of ``segs`` (host clock, results on the host)."""
    batch = segs[:ctx.max_batch_size]
    rates = []
    for _ in range(calls):
        t0 = time.perf_counter()
        clf.predict_batch_with_context(ctx, batch)
        rates.append(len(batch) / (time.perf_counter() - t0))
    return rates


def cli_rows(path: str) -> list:
    """The CSV's rows as (start, end, species, confidence), sorted by start
    and species."""
    import csv

    with open(path, newline="", encoding="utf-8") as f:
        rows = list(csv.reader(f))
    if rows[0] != ["start_s", "end_s", "species", "confidence"]:
        raise AssertionError(f"CLI CSV header {rows[0]}")
    return sorted((r[0], r[1], r[2], float(r[3])) for r in rows[1:])


def phase_cli(card: str, path: str) -> None:
    """``python -m birdnet_tpu_torch.cli`` in a subprocess on a 60 s 48 kHz
    int16 WAV with the full-width v2.4 file and generated labels, streamed
    and with --no-stream (the batch context), both with --csv: both exit 0
    and give the same rows (start, end, species; confidence within
    CLI_CONF_TOL); once more with the range filter; and --list-providers
    names the card."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        wav, labels, meta_path = tmp / "a.wav", tmp / "labels.txt", tmp / "meta.onnx"
        rng = np.random.default_rng(SEED + 11)
        write_wav(wav, (rng.standard_normal(60 * 48_000) * 0.1).astype(np.float32), 48_000)
        labels.write_text("\n".join(LABELS), encoding="utf-8")
        P.save_model(meta.build_model(seed=SEED), str(meta_path))

        def run(*args) -> tuple:
            t0 = time.perf_counter()
            proc = subprocess.run([sys.executable, "-m", "birdnet_tpu_torch.cli", *args],
                                  cwd=tmp, env=env, capture_output=True, text=True, timeout=300)
            if proc.returncode != 0:
                raise AssertionError(f"CLI {args} exited {proc.returncode}: "
                                     f"{proc.stdout[-2000:]} {proc.stderr[-2000:]}")
            return proc.stdout, time.perf_counter() - t0

        common = [str(wav), "-m", path, "-l", str(labels), "--min-confidence", "0", "-t", "0"]
        out_stream, stream_s = run(*common, "--csv", str(tmp / "stream.csv"))
        out_batch, batch_s = run(*common, "--no-stream", "--csv", str(tmp / "batch.csv"))
        out_range, range_s = run(*common, "--lat", "42.5", "--lon", "-76.4", "--date", "06-15",
                                 "--meta-model", str(meta_path), "--csv", str(tmp / "range.csv"))
        out_providers, _ = run("--list-providers")
        a, b = cli_rows(tmp / "stream.csv"), cli_rows(tmp / "batch.csv")
        ranged = cli_rows(tmp / "range.csv")
    same_rows = [r[:3] for r in a] == [r[:3] for r in b]
    conf = max(abs(x[3] - y[3]) for x, y in zip(a, b)) if same_rows else None
    name = torch.cuda.get_device_name(0)
    line = {"phase": "cli", "card": card, "rows": len(a), "same_rows": same_rows,
            "max_conf_diff_stream_vs_no_stream": conf,
            "no_stream_used_batch_context": "CUDA graph batch context" in out_batch,
            "range_filter_rows": len(ranged), "card_listed": name in out_providers,
            "seconds": {"stream": stream_s, "no_stream": batch_s, "range_filter": range_s},
            "summary_stream": out_stream.strip().splitlines()[-1],
            "summary_no_stream": out_batch.strip().splitlines()[-1]}
    line["ok"] = (same_rows and len(a) == 20 * 3 and conf <= CLI_CONF_TOL
                  and line["no_stream_used_batch_context"] and line["card_listed"]
                  and "Using device: cuda:0" in out_stream and 0 < len(ranged) <= len(a))
    emit(line)
    if not line["ok"]:
        raise AssertionError(f"cli: {line}")


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


# The exported phase: exporter-written files at full width. (a) a torch
# module with models/birdnet_v24.py's schedule (learned Conv1d filterbank
# with log1p(t*t), stem 32, six stages of depth 2, head 1280, 6522 species)
# written by libtorch's TorchScript exporter; (b) the TF-export dialect of
# tests/_tf_dialect_models.py (STFT, Mul/ReduceSum power, MelWeightMatrix,
# NHWC Transpose sandwiches, SAME_UPPER, MaxPool, the Shape/Gather/Concat
# flatten) at each family's frontend width and species count. fp32 on the
# card against each file's own oracle within these shares of the logits'
# scale (the JAX suite's: 1e-4 for the torch export, 5e-4 for the TF
# dialect), and against the port on the host within EXPORTED_CPU_TOL.
EXPORTED_ORACLE_TOL = {"torch": 1e-4, "tf": 5e-4}
EXPORTED_CPU_TOL = 1e-4
EXPORTED_CPU_ROWS = 4
EXPORTED_SECONDS = 60
# (family, mel bins, species, embedding width) of the TF-dialect files; the
# backbone keeps the fixture's own widths (c1 8, c2 16).
EXPORTED_TF = {"tf_v24": ("v24", 96, 6522, 24), "tf_v30": ("v30", 96, 6522, 1024),
               "tf_perch": ("perch", 128, 14795, 1536)}


class _SE(torch.nn.Module):
    """Squeeze-excite as models/_builder.py's se_block: GAP, 1x1, SiLU, 1x1,
    sigmoid, scale (hidden max(C // 4, 4))."""

    def __init__(self, ch):
        super().__init__()
        mid = max(ch // 4, 4)
        self.fc1, self.fc2 = torch.nn.Conv2d(ch, mid, 1), torch.nn.Conv2d(mid, ch, 1)

    def forward(self, x):
        g = torch.nn.functional.adaptive_avg_pool2d(x, 1)
        return x * torch.sigmoid(self.fc2(torch.nn.functional.silu(self.fc1(g))))


def _conv_bn_silu(c_in, c_out, k, stride=1, groups=1):
    return [torch.nn.Conv2d(c_in, c_out, k, stride=stride, padding=k // 2, groups=groups,
                            bias=False), torch.nn.BatchNorm2d(c_out), torch.nn.SiLU()]


class _MBConv(torch.nn.Module):
    """models/_builder.py's mbconv: a 1x1 expand (also at expand 1), a 3x3
    depthwise, squeeze-excite, a 1x1 project, the residual where shapes
    allow."""

    def __init__(self, c_in, c_out, stride, expand):
        super().__init__()
        mid = c_in * expand
        self.body = torch.nn.Sequential(
            *_conv_bn_silu(c_in, mid, 1), *_conv_bn_silu(mid, mid, 3, stride, mid), _SE(mid),
            torch.nn.Conv2d(mid, c_out, 1, bias=False), torch.nn.BatchNorm2d(c_out))
        self.residual = stride == 1 and c_in == c_out

    def forward(self, x):
        y = self.body(x)
        return x + y if self.residual else y


class TorchBirdnetV24(torch.nn.Module):
    """BirdNET v2.4's contract and the generator's schedule at full width,
    with tests/test_external_full_models.py's conv frontend (log1p(t*t)):
    its image is [N, 1, 96, 511], B4's envelope."""

    STAGES = [(32, 24, 1, 1), (24, 40, 2, 4), (40, 80, 2, 4), (80, 112, 2, 4),
              (112, 192, 2, 4), (192, 320, 1, 4)]

    def __init__(self, depth=2):
        super().__init__()
        self.frontend = torch.nn.Conv1d(1, N_MELS, FLEN, stride=HOP)
        layers = _conv_bn_silu(1, 32, 3, 2)
        for c_in, c_out, stride, expand in self.STAGES:
            layers.append(_MBConv(c_in, c_out, stride, expand))
            layers += [_MBConv(c_out, c_out, 1, expand) for _ in range(depth - 1)]
        self.backbone = torch.nn.Sequential(*layers, *_conv_bn_silu(320, 1280, 1))
        self.classifier = torch.nn.Linear(1280, birdnet_v24.NUM_SPECIES)

    def forward(self, x):
        t = self.frontend(x.unsqueeze(1))
        img = torch.log1p(t * t).unsqueeze(1)
        return self.classifier(self.backbone(img).mean(dim=(2, 3)))


def torch_v24_file(tmp: str) -> tuple:
    """(path, the torch module) of the torch-exported v2.4, written from
    SEED with BatchNorm statistics away from 0 and 1 and a dynamic batch.
    The exporter comes from tests/ by path (it imports neither package)."""
    sys.path.insert(0, str(REPO / "tests"))
    from _torch_export import export_onnx_bytes

    torch.manual_seed(SEED)
    module = TorchBirdnetV24().eval()
    with torch.no_grad():  # BatchNorm statistics away from 0 and 1
        for m in module.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.uniform_(-0.1, 0.1)
                m.running_var.uniform_(0.5, 1.5)
    path = str(Path(tmp) / "torch_v24.onnx")
    Path(path).write_bytes(export_onnx_bytes(
        module, (torch.zeros(1, S),), input_names=["input"], output_names=["output_0"],
        dynamic_axes={"input": {0: "batch"}}))
    return path, module


def exported_files(tmp: str) -> dict:
    """{name: (path, labels, oracle, sample rate, samples, family)}: the
    torch-exported v2.4 and the three TF-dialect files, written from SEED;
    ``oracle(batch)`` gives the file's outputs as numpy. The helpers come
    from tests/ by path (they import neither package)."""
    sys.path.insert(0, str(REPO / "tests"))
    from _tf_dialect_models import build_tf_dialect_model

    files = {}
    path, module = torch_v24_file(tmp)
    on_card = module.to(CARD)

    def torch_oracle(batch):
        with torch.no_grad():
            return [on_card(torch.from_numpy(batch).to(CARD)).cpu().numpy()]

    files["torch_v24"] = (path, LABELS, torch_oracle, 48_000, S, "v24")
    for name, (family, n_mels, species, emb) in EXPORTED_TF.items():
        data, oracle = build_tf_dialect_model(family, num_species=species, seed=SEED,
                                              n_mels=n_mels, emb_dim=emb)
        path = str(Path(tmp) / f"{name}.onnx")
        Path(path).write_bytes(data)
        del data
        rate, samples = (48_000, S) if family == "v24" else (FAMILY_RATE, FAMILY_S)
        files[name] = (path, family_labels(species), oracle.forward, rate, samples, family)
    return files


def exported_logits(family: str, outs: list) -> np.ndarray:
    return outs[3] if family == "perch" else outs[-1]


def stream_against_predict_batch(clf, audio: np.ndarray, stream: tuple) -> dict:
    """A stream's top-K against predict_batch on the same segments in
    batches of the stream's tile (tiled_reference)."""
    conf, idx, _ = stream
    ref_conf, ref_idx, _ = tiled_reference(clf, audio, clf._streaming_engine().tile)
    clear = ref_conf[:, 0] - ref_conf[:, 1] > STREAM_CONF_TOL
    return {"topk_equal": bool(np.array_equal(idx, ref_idx)),
            "max_conf_diff": float(np.abs(conf - ref_conf).max()),
            "top1_equal_where_clear":
                f"{int((idx[clear, 0] == ref_idx[clear, 0]).sum())}/{int(clear.sum())}"}


def forward_without_sync_of(fwd, params, inputs) -> bool:
    """One forward (after a warm one) under
    torch.cuda.set_sync_debug_mode("error"): True when nothing syncs."""
    fwd(params, *inputs)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fwd(params, *inputs)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return True


def forward_without_sync(clf, segs: np.ndarray) -> bool:
    """One forward of ``clf``'s engine on the card under
    torch.cuda.set_sync_debug_mode("error") (after a warm one): True when
    nothing in it synchronizes. Only the forward is wrapped."""
    eng = clf._engine
    return forward_without_sync_of(eng._forward, eng.params, [torch.from_numpy(segs).to(CARD)])


def phase_exported(card: str, generator_path: str) -> dict:
    """The exported files on the card: fp32 against each file's oracle and
    against the port on the host; fast against fp32 (top-1 where clear);
    predict_batch(32); a 60 s analyze_samples against predict_batch on the
    same segments, held at fp32 (the same top-K, confidences within
    STREAM_CONF_TOL) and printed at fast (the stream casts its frames to
    bf16 before the forward under fast, in both packages, and predict_batch
    does not: where no fused frontend rounds the input anyway, as in the TF
    dialect's unfused STFT, the two differ by that rounding); the batch
    context's graph against predict_batch bit for
    bit (not for Perch, which neither package's context takes); one forward per policy without a sync; B4's launches and kernels
    on the torch-exported v2.4 under fast; rates beside the generator's v2.4
    conv file. Returns the phase's launch counts and the torch-exported
    v2.4's rates."""
    t_phase = time.perf_counter()
    rates = {}
    gen = built(generator_path, LABELS, "fast")
    rng = np.random.default_rng(SEED + 20)
    gen_segs = (rng.normal(size=(N_SEG, S)) * 0.1).astype(np.float32)
    gen_ctx = gen.create_batch_context(N_SEG)
    rates["generator_v24_conv"] = {"predict_batch32": seg_per_s(gen, gen_segs),
                                   "context": statistics.median(
                                       context_rates(gen, gen_ctx, gen_segs))}
    del gen, gen_ctx
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        files = exported_files(tmp)
        build_s = time.perf_counter() - t0
        # The exported path's run: every count starts at 0 here.
        reset_launches()
        failed = []
        for name, (path, labels, oracle, rate, samples, family) in files.items():
            segs = (np.random.default_rng(SEED + 21).normal(size=(N_SEG, samples)) * 0.1
                    ).astype(np.float32)
            pcm = (np.random.default_rng(SEED + 22).standard_normal(
                EXPORTED_SECONDS * rate, dtype=np.float32) * 3000).clip(
                -32768, 32767).astype(np.int16)
            before = read_launches()
            fp32, fast = built(path, labels, "fp32"), built(path, labels, "fast")
            ref = logits_of(fp32.predict_batch(segs))
            fast_batch = fast.predict_batch(segs)
            streams = {policy: streamed(c, pcm, 0.0) for policy, c in (("fp32", fp32),
                                                                         ("fast", fast))}
            # Perch has no batch context in either package (the reference's
            # BatchInferenceContext refuses it); its forward is held to the
            # rest.
            ctx = None if family == "perch" else fast.create_batch_context(N_SEG)
            in_ctx = fast_batch if ctx is None else fast.predict_batch_with_context(ctx, segs)
            no_sync = forward_without_sync(fp32, segs) and forward_without_sync(fast, segs)
            after = read_launches()
            host = (Classifier.builder().model_path(path).labels(labels).precision("fp32")
                    .with_device("cpu").build())
            host_logits = logits_of(host.predict_batch(segs[:EXPORTED_CPU_ROWS]))
            del host
            want = exported_logits(family, oracle(segs))
            audio = chunk_audio(pcm.astype(np.float32) / 32768.0, samples, 0.0, rate)[0]
            stream_vs = {policy: stream_against_predict_batch(c, audio, streams[policy])
                         for policy, c in (("fp32", fp32), ("fast", fast))}
            fast_logits = logits_of(fast_batch)
            tol = EXPORTED_ORACLE_TOL[name.split("_")[0]]
            line = {"phase": "exported", "file": name, "card": card,
                    "shape": [N_SEG, samples], "species": len(labels),
                    "ops": sorted({n.op_type for n in import_onnx(path).graph.node}),
                    "fp32_scaled_diff_vs_oracle": scaled_diff(ref, want),
                    "oracle_tol": tol,
                    "fp32_scaled_diff_card_vs_cpu": scaled_diff(ref[:EXPORTED_CPU_ROWS],
                                                                host_logits),
                    "top1_fast_vs_fp32": top1_where_clear(fast_logits, ref),
                    "scaled_logit_diff_fast_vs_fp32": scaled_diff(fast_logits, ref),
                    "stream_segments": int(streams["fp32"][0].shape[0]),
                    "stream_vs_predict_batch": stream_vs,
                    "context_graph": None if ctx is None else ctx.graph is not None,
                    "context_logits_bitwise_equal": bool(np.array_equal(
                        logits_of(in_ctx), fast_logits)),
                    "context_topk_equal": all(
                        [p.index for p in a.predictions] == [p.index for p in b.predictions]
                        for a, b in zip(in_ctx, fast_batch)),
                    "no_sync_in_forward": no_sync,
                    "launches": {k: after[k] - before[k] for k in after
                                 if after[k] != before[k]}}
            if name == "torch_v24":
                kernels = device_kernel_names(lambda: fast.predict_batch(segs))
                line["trace_expand_dw_mma_kernel"] = sum(
                    n for k, n in kernels.items() if "expand_dw_mma_kernel" in k)
            rates[name] = {"predict_batch32": seg_per_s(fast, segs), "context": None if ctx is None
                           else statistics.median(context_rates(fast, ctx, segs))}
            ok = (np.isfinite(ref).all() and ref.shape == (N_SEG, len(labels))
                  and line["fp32_scaled_diff_vs_oracle"] <= tol
                  and line["fp32_scaled_diff_card_vs_cpu"] <= EXPORTED_CPU_TOL
                  and line["top1_fast_vs_fp32"]["ok"]
                  and line["stream_segments"] == -(-EXPORTED_SECONDS * rate // samples)
                  and stream_vs["fp32"]["topk_equal"]
                  and stream_vs["fp32"]["max_conf_diff"] <= STREAM_CONF_TOL
                  and line["context_graph"] is not False
                  and line["context_logits_bitwise_equal"]
                  and line["context_topk_equal"] and no_sync)
            if name == "torch_v24":
                ok = ok and (line["launches"].get("stage_stack_forward", 0) > 0
                             and line["trace_expand_dw_mma_kernel"] > 0)
            line["ok"] = bool(ok)
            emit(line)
            if not ok:
                failed.append(name)
            del fp32, fast, ctx
            torch.cuda.empty_cache()
        launches = read_launches()
    emit({"phase": "exported_rates", "card": card, "precision": "fast",
          "seg_per_s_median": rates, "build_files_s": build_s,
          "phase_s": time.perf_counter() - t_phase})
    if failed:
        raise AssertionError(f"exported files disagree: {failed}")
    return launches, rates["torch_v24"]


# The control_flow phase.
CRNN_HIDDEN = 128  # the recurrent width of the DCASE 2023 Task 4 baseline CRNN
CRNN_UPSAMPLE = 4
CRNN_STREAM_SECONDS = 600
CRNN_TILE = 128
SCRIPTED_WIDTH = 1024
SCRIPTED_TOL = 1e-4


class TorchCrnnV24(torch.nn.Module):
    """A CRNN bird tagger on v2.4's contract: TorchBirdnetV24's frontend and
    backbone (head [N, 1280, 3, 16]), the mean over frequency, a linear
    F.interpolate x4 along time (a Resize) to [N, 1280, 64], a 2-layer
    bidirectional GRU of hidden 128, frame and attention Linear(256 ->
    6522), softmax over time and attention pooling (PANNs' decision-level
    attention): [N, 6522]."""

    def __init__(self, depth=2):
        super().__init__()
        base = TorchBirdnetV24(depth)
        self.frontend, self.backbone = base.frontend, base.backbone
        self.gru = torch.nn.GRU(1280, CRNN_HIDDEN, num_layers=2, bidirectional=True,
                                batch_first=True)
        self.frame = torch.nn.Linear(2 * CRNN_HIDDEN, birdnet_v24.NUM_SPECIES)
        self.att = torch.nn.Linear(2 * CRNN_HIDDEN, birdnet_v24.NUM_SPECIES)

    def forward(self, x):
        t = self.frontend(x.unsqueeze(1))
        img = torch.log1p(t * t).unsqueeze(1)
        z = self.backbone(img).mean(dim=2)
        z = torch.nn.functional.interpolate(z, scale_factor=float(CRNN_UPSAMPLE), mode="linear")
        h, _ = self.gru(z.transpose(1, 2))
        att = torch.softmax(self.att(h), dim=1)
        return (self.frame(h) * att).sum(dim=1)


# tests/test_random_torch_graphs.py::_control_flow_net's five templates, at
# SCRIPTED_WIDTH with n = 5; the thresholds are set for this width's data so
# that each branch and loop does work.
class ScriptedIf(torch.nn.Module):
    def __init__(self, d):
        super().__init__()
        self.a, self.b, self.t = torch.nn.Linear(d, d), torch.nn.Linear(d, d), 0.0

    def forward(self, x):
        if x.sum() > self.t:
            y = torch.tanh(self.a(x))
        else:
            y = torch.relu(self.b(x)) - 1.0
        return y * 2.0


class ScriptedFor(torch.nn.Module):
    def __init__(self, d):
        super().__init__()
        self.fc, self.n = torch.nn.Linear(d, d), 5

    def forward(self, x):
        y = x
        for _ in range(self.n):
            y = torch.tanh(self.fc(y)) + x
        return y


class ScriptedWhile(torch.nn.Module):
    def __init__(self, d):
        super().__init__()
        self.n, self.t = 5, 1e5

    def forward(self, x):
        y = x
        i = 0
        while y.abs().sum() < self.t and i < self.n * 3:
            y = y * 1.5 + 0.1
            i = i + 1
        return y


class ScriptedIfInFor(torch.nn.Module):
    def __init__(self, d):
        super().__init__()
        self.fc, self.n, self.t = torch.nn.Linear(d, d), 5, 0.0

    def forward(self, x):
        y = x
        for _ in range(self.n):
            if y.mean() > self.t:
                y = self.fc(y) * 0.5
            else:
                y = y + 1.0
        return y


class ScriptedTwoCarried(torch.nn.Module):
    def __init__(self, d):
        super().__init__()
        self.fc, self.n = torch.nn.Linear(d, d), 5

    def forward(self, x):
        y = x
        acc = torch.zeros_like(x)
        for _ in range(self.n):
            y = torch.sigmoid(self.fc(y))
            acc = acc + y
        return acc / float(self.n)


SCRIPTED = {"if": (ScriptedIf, 1.0), "for": (ScriptedFor, 1.0),
            "while": (ScriptedWhile, 1e-4), "if_in_for": (ScriptedIfInFor, 1.0),
            "two_carried": (ScriptedTwoCarried, 1.0)}


def port_forward(data: bytes, device):
    model = import_onnx(data)
    return make_forward(model, "fp32", device), params_to_torch(model.params, device)


def aten_ops_per_forward(path: str, precision: str) -> dict:
    """scripts/torch_eager_calls.py's counts for one forward of ``path``
    on the card at batch 32."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "torch_eager_calls", REPO / "scripts" / "torch_eager_calls.py")
    calls = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(calls)
    return calls.count(path, "cuda", precision, N_SEG, S)


def crnn_file(tmp: str) -> tuple:
    """(path, the torch module on the card) of the CRNN, exported from SEED
    with the exported phase's BatchNorm statistics and a dynamic batch."""
    sys.path.insert(0, str(REPO / "tests"))
    from _torch_export import export_onnx_bytes

    torch.manual_seed(SEED)
    module = TorchCrnnV24().eval()
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.uniform_(-0.1, 0.1)
                m.running_var.uniform_(0.5, 1.5)
    path = str(Path(tmp) / "crnn_v24.onnx")
    Path(path).write_bytes(export_onnx_bytes(
        module, (torch.zeros(1, S),), input_names=["input"], output_names=["output_0"],
        dynamic_axes={"input": {0: "batch"}}))
    return path, module.to(CARD)


def crnn_check(card: str, path: str, module, v24_rates: dict) -> dict:
    """The CRNN's checks and rates (the phase's main path). Returns its
    launch counts."""
    segs = (np.random.default_rng(SEED + 30).normal(size=(N_SEG, S)) * 0.1).astype(np.float32)
    pcm = (np.random.default_rng(SEED + 31).standard_normal(CRNN_STREAM_SECONDS * 48_000,
                                                            dtype=np.float32) * 3000
           ).clip(-32768, 32767).astype(np.int16)
    # The CRNN's run: every count starts at 0 here.
    reset_launches()
    fp32, fast = built(path, LABELS, "fp32"), built(path, LABELS, "fast")
    ref = logits_of(fp32.predict_batch(segs))
    fast_logits = logits_of(fast.predict_batch(segs))
    for clf in (fp32, fast):
        clf._streaming_engine().tile = CRNN_TILE
    stream = streamed(fp32, pcm, 0.0)
    ctx = fast.create_batch_context(N_SEG)
    in_ctx = logits_of(fast.predict_batch_with_context(ctx, segs))
    no_sync = forward_without_sync(fp32, segs) and forward_without_sync(fast, segs)
    launches = read_launches()
    kernels = device_kernel_names(lambda: fast.predict_batch(segs))
    with torch.no_grad():
        want = module(torch.from_numpy(segs).to(CARD)).cpu().numpy()
    host = (Classifier.builder().model_path(path).labels(LABELS).precision("fp32")
            .with_device("cpu").build())
    host_logits = logits_of(host.predict_batch(segs[:EXPORTED_CPU_ROWS]))
    del host
    audio = chunk_audio(pcm.astype(np.float32) / 32768.0, S, 0.0, 48_000)[0]
    stream_vs = stream_against_predict_batch(fp32, audio, stream)
    streamed(fast, pcm[:CRNN_TILE * S], 0.0)  # one untimed tile of 128 first
    rates = {"predict_batch32": seg_per_s(fast, segs),
             "context": statistics.median(context_rates(fast, ctx, segs)),
             "stream_tile128": stream_rate(fast, pcm)}
    ops = sorted({n.op_type for n in import_onnx(path).graph.node})
    line = {"phase": "control_flow", "part": "crnn", "card": card, "shape": [N_SEG, S],
            "model_type": fast.model_type.value, "ops": ops,
            "fp32_scaled_diff_vs_torch": scaled_diff(ref, want),
            "fp32_scaled_diff_card_vs_cpu": scaled_diff(ref[:EXPORTED_CPU_ROWS], host_logits),
            "top1_fast_vs_fp32": top1_where_clear(fast_logits, ref),
            "scaled_logit_diff_fast_vs_fp32": scaled_diff(fast_logits, ref),
            "stream_segments": int(stream[0].shape[0]), "stream_vs_predict_batch": stream_vs,
            "context_graph": ctx.graph is not None,
            "context_logits_bitwise_equal": bool(np.array_equal(in_ctx, fast_logits)),
            "no_sync_in_forward": no_sync, "launches": launches,
            "trace_expand_dw_mma_kernel": sum(
                n for k, n in kernels.items() if "expand_dw_mma_kernel" in k),
            "seg_per_s_fast": rates, "seg_per_s_fast_exported_v24": v24_rates,
            "aten_ops_per_forward": {p: aten_ops_per_forward(path, p)
                                     for p in ("fast", "fp32")}}
    ok = (np.isfinite(ref).all() and ref.shape == (N_SEG, birdnet_v24.NUM_SPECIES)
          and fast.model_type is ModelType.BIRDNET_V24
          and {"GRU", "Resize", "_FusedStagePrefix"} <= set(ops)
          and line["fp32_scaled_diff_vs_torch"] <= EXPORTED_ORACLE_TOL["torch"]
          and line["fp32_scaled_diff_card_vs_cpu"] <= EXPORTED_CPU_TOL
          and line["top1_fast_vs_fp32"]["ok"]
          and line["stream_segments"] == CRNN_STREAM_SECONDS // 3
          and stream_vs["topk_equal"] and stream_vs["max_conf_diff"] <= STREAM_CONF_TOL
          and line["context_graph"] and line["context_logits_bitwise_equal"] and no_sync
          and launches.get("stage_stack_forward", 0) > 0
          and line["trace_expand_dw_mma_kernel"] > 0)
    line["ok"] = bool(ok)
    emit(line)
    if not ok:
        raise AssertionError("control_flow: the CRNN disagrees")
    return launches


def scripted_check(card: str) -> None:
    """The five scripted templates: the port on the card against the port
    on the host and torch on the card (fp32, SCRIPTED_TOL of the scale);
    the If and for forms without a sync; the while form's host reads."""
    from _torch_export import export_onnx_bytes

    from birdnet_tpu_torch.compiler import ops as tops

    failed = []
    for i, (name, (cls, x_scale)) in enumerate(SCRIPTED.items()):
        torch.manual_seed(SEED + 40 + i)
        module = torch.jit.script(cls(SCRIPTED_WIDTH).eval())
        x = torch.randn(N_SEG, SCRIPTED_WIDTH) * x_scale
        data = export_onnx_bytes(module, (x,))
        with torch.no_grad():
            want = module.to(CARD)(x.to(CARD)).cpu().numpy()
        fwd, params = port_forward(data, CARD)
        tops.HOST_READS["Loop"] = 0
        (got,) = fwd(params, x.to(CARD))
        reads = tops.HOST_READS["Loop"]
        got = got.cpu().numpy()
        hfwd, hparams = port_forward(data, "cpu")
        (host,) = hfwd(hparams, x)
        no_sync = None if name == "while" else forward_without_sync_of(fwd, params,
                                                                       [x.to(CARD)])
        line = {"phase": "control_flow", "part": "scripted", "template": name, "card": card,
                "ops": sorted({n.op_type for n in import_onnx(data).graph.node}),
                "scaled_diff_vs_torch": scaled_diff(got, want),
                "scaled_diff_card_vs_cpu": scaled_diff(got, host.numpy()),
                "no_sync_in_forward": no_sync, "host_reads": reads}
        ok = (line["scaled_diff_vs_torch"] <= SCRIPTED_TOL
              and line["scaled_diff_card_vs_cpu"] <= SCRIPTED_TOL
              and (reads > 1 if name == "while" else reads == 0 and no_sync))
        line["ok"] = bool(ok)
        emit(line)
        if not ok:
            failed.append(name)
    if failed:
        raise AssertionError(f"control_flow: scripted templates disagree: {failed}")


def dispatch_check(card: str, tmp: str) -> None:
    """The merged decoder (tests/_torch_flow_cases.py) with each flag value,
    card against host, and through a .btck round trip."""
    from _torch_flow_cases import merged_decoder_bytes

    from birdnet_tpu_torch.checkpoint import load_checkpoint, save_checkpoint

    model = import_onnx(merged_decoder_bytes())
    ck = str(Path(tmp) / "merged.btck")
    save_checkpoint(model, ck)
    back = load_checkpoint(ck)
    x = torch.randn(2, SCRIPTED_WIDTH, generator=torch.Generator().manual_seed(SEED))
    past = torch.randn(2, SCRIPTED_WIDTH // 2, generator=torch.Generator().manual_seed(SEED + 1))
    line = {"phase": "control_flow", "part": "dispatch", "card": card,
            "dispatch_inputs": model.dispatch_inputs,
            "btck_dispatch_inputs": back.dispatch_inputs}
    ok = back.dispatch_inputs == model.dispatch_inputs == ["use_cache_branch"]
    for flag in (True, False):
        outs = {}
        for where, m, dev in (("card", model, CARD), ("host", model, "cpu"),
                              ("btck_card", back, CARD)):
            fwd = make_forward(m, "fp32", dev)
            (y,) = fwd(params_to_torch(m.params, dev), x.to(dev), np.array([flag]),
                       past.to(dev))
            outs[where] = y.cpu()
        want = torch.cat([past, x], 1) if flag else x
        line[f"flag_{flag}"] = {k: bool(torch.equal(v, want)) for k, v in outs.items()}
        ok = ok and all(line[f"flag_{flag}"].values())
    line["ok"] = bool(ok)
    emit(line)
    if not ok:
        raise AssertionError("control_flow: merged-decoder dispatch disagrees")


def flow_ops_check(card: str) -> None:
    """tests/_torch_flow_cases.py on the card against the host: fp32 within
    its TOL of each output's scale, every case but the while form without a
    sync, the while form's host reads counted."""
    import _torch_flow_cases as flow

    from birdnet_tpu_torch.compiler import ops as tops

    cases, failed = {}, []
    for name in flow.CASES:
        data = flow.model_bytes(name)
        inputs = list(flow.CASES[name][1].values())
        outs = {}
        for dev in ("cpu", CARD):
            fwd, params = port_forward(data, dev)
            args = [torch.from_numpy(np.array(v)).to(dev) for v in inputs]
            tops.HOST_READS["Loop"] = 0
            outs[str(dev)] = [o.cpu() for o in fwd(params, *args)]
        reads = tops.HOST_READS["Loop"]
        no_sync = None if name == flow.WHILE else forward_without_sync_of(fwd, params, args)
        err = max(scaled_diff(g.numpy(), w.numpy())
                  for g, w in zip(outs[str(CARD)], outs["cpu"]))
        # Device time of a graph replay; the while form cannot be captured.
        ms = None if name == flow.WHILE else time_ms(lambda: fwd(params, *args), reps=3)
        cases[name] = {"scaled_diff_card_vs_cpu": err, "no_sync_in_forward": no_sync,
                       "host_reads": reads, "ms": ms}
        if not (err <= flow.TOL and (reads == flow.WHILE_STEPS + 1 if name == flow.WHILE
                                     else reads == 0 and no_sync)):
            failed.append(name)
    emit({"phase": "control_flow", "part": "ops", "card": card, "tol": flow.TOL,
          "cases": cases, "ok": not failed})
    if failed:
        raise AssertionError(f"control_flow: ops disagree on the card: {failed}")


def eager_key_check(card: str, tmp: str) -> None:
    """A v2.4-shaped file whose Loop takes the while form
    (tests/_torch_flow_cases.py) streamed for a minute at 1.5 s overlap:
    its warm calls count host reads, so its key runs eagerly (no capture is
    tried), and the card's rows match the host's (indices equal,
    confidences within 1e-6)."""
    from _torch_flow_cases import while_classifier_bytes

    path = Path(tmp) / "while_v24.onnx"
    path.write_bytes(while_classifier_bytes(10))
    pcm = (np.random.default_rng(SEED + 15).standard_normal(60 * 48_000) * 3000
           ).clip(-32768, 32767).astype(np.int16)
    out = {}
    for device in ("cuda", "cpu"):
        clf = (Classifier.builder().model_path(str(path)).labels(LABELS[:10]).top_k(3)
               .precision("fp32").with_device(device).build())
        out[device] = clf._streaming_engine().analyze(pcm, overlap_seconds=1.5)
        if device == "cuda":
            keys = stream_keys(clf)
    conf_diff = float(np.abs(out["cuda"][0] - out["cpu"][0]).max())
    line = {"phase": "control_flow", "part": "eager_key", "card": card, "keys": keys,
            "max_conf_diff_card_vs_cpu": conf_diff,
            "indices_equal": bool(np.array_equal(out["cuda"][1], out["cpu"][1]))}
    line["ok"] = (len(keys) == 1 and keys[0]["eager"] and keys[0]["host_reads"] > 0
                  and line["indices_equal"] and conf_diff <= 1e-6)
    emit(line)
    if not line["ok"]:
        raise AssertionError(f"control_flow: the while form's stream: {line}")


def phase_control_flow(card: str, v24_rates: dict) -> dict:
    """The control_flow phase (see the module docstring). Returns the CRNN
    run's launch counts."""
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        path, module = crnn_file(tmp)
        launches = crnn_check(card, path, module, v24_rates)
        del module
        torch.cuda.empty_cache()
        scripted_check(card)
        dispatch_check(card, tmp)
        eager_key_check(card, tmp)
    flow_ops_check(card)
    emit({"phase": "control_flow_time", "card": card, "phase_s": time.perf_counter() - t_phase})
    return launches


# The op_sets phase.
SEQ_HEAD_CHUNK = 4  # frames of the [N, 1280, 3, 16] map per chunk: four chunks
# The batch-separable cases of tests/_torch_opset_cases.py (its
# HOST_SLICED) run on the host's first OPSET_HOST_ROWS rows.
OPSET_HOST_ROWS = 4
ML_HEAD_SEED = SEED + 60
ML_TOL = 1e-5


@torch.jit.script
def _chunk_head(h: torch.Tensor, w: torch.Tensor, b: torch.Tensor, chunk: int) -> torch.Tensor:
    """The sequence head: the map split along time into chunks, each pooled
    and projected, the chunks' logits stacked and averaged. Scripted, so
    libtorch writes the split as SplitToSequence and the loop over the
    chunks as a Loop over that sequence."""
    parts = torch.split(h, chunk, dim=3)
    outs = [torch.nn.functional.linear(p.mean(dim=(2, 3)), w, b) for p in parts]
    return torch.stack(outs, 0).mean(0)


class TorchSeqHeadV24(torch.nn.Module):
    """TorchBirdnetV24's frontend and backbone (head [N, 1280, 3, 16]) with
    a scripted head over four time chunks: [N, 6522]."""

    def __init__(self, depth=2):
        super().__init__()
        base = TorchBirdnetV24(depth)
        self.frontend, self.backbone = base.frontend, base.backbone
        self.proj = torch.nn.Linear(1280, birdnet_v24.NUM_SPECIES)

    def forward(self, x):
        t = self.frontend(x.unsqueeze(1))
        img = torch.log1p(t * t).unsqueeze(1)
        return _chunk_head(self.backbone(img), self.proj.weight, self.proj.bias,
                           SEQ_HEAD_CHUNK)


def graph_op_types(graph) -> set:
    """The op types of ``graph`` and of every subgraph in it."""
    ops = set()
    for node in graph.node:
        ops.add(node.op_type)
        for v in node.attrs.values():
            if isinstance(v, P.GraphProto):
                ops |= graph_op_types(v)
    return ops


def seq_head_check(card: str, tmp: str) -> dict:
    """(a) The sequence head on the exported backbone through
    Classifier.builder(), held as the control_flow phase holds the CRNN.
    Returns its launch counts."""
    from _torch_export import export_onnx_bytes

    torch.manual_seed(SEED + 50)
    module = TorchSeqHeadV24().eval()
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.uniform_(-0.1, 0.1)
                m.running_var.uniform_(0.5, 1.5)
    path = str(Path(tmp) / "seq_head_v24.onnx")
    written = P.decode_model(export_onnx_bytes(
        module, (torch.zeros(1, S),), input_names=["input"], output_names=["output_0"],
        dynamic_axes={"input": {0: "batch"}}))
    # libtorch's shape inference stops at the Loop and leaves the output's
    # axes symbolic; the classifier reads the species count from the last
    # one, so the file declares it (the graph stays as libtorch wrote it).
    written.graph.output[0].type.tensor_type.shape.dim[-1] = P.Dimension(
        dim_value=birdnet_v24.NUM_SPECIES)
    P.save_model(written, path)
    module = module.to(CARD)
    segs = (np.random.default_rng(SEED + 51).normal(size=(N_SEG, S)) * 0.1).astype(np.float32)
    # The sequence head's run: every count starts at 0 here.
    reset_launches()
    fp32, fast = built(path, LABELS, "fp32"), built(path, LABELS, "fast")
    ref = logits_of(fp32.predict_batch(segs))
    fast_logits = logits_of(fast.predict_batch(segs))
    ctx = fast.create_batch_context(N_SEG)
    in_ctx = logits_of(fast.predict_batch_with_context(ctx, segs))
    no_sync = forward_without_sync(fp32, segs) and forward_without_sync(fast, segs)
    launches = read_launches()
    with torch.no_grad():
        want = module(torch.from_numpy(segs).to(CARD)).cpu().numpy()
    host = (Classifier.builder().model_path(path).labels(LABELS).precision("fp32")
            .with_device("cpu").build())
    host_logits = logits_of(host.predict_batch(segs[:EXPORTED_CPU_ROWS]))
    del host
    ops = graph_op_types(import_onnx(path).graph)
    rates = {"predict_batch32": seg_per_s(fast, segs),
             "context": statistics.median(context_rates(fast, ctx, segs))}
    line = {"phase": "op_sets", "part": "sequence_head", "card": card, "shape": [N_SEG, S],
            "model_type": fast.model_type.value, "ops": sorted(ops),
            "fp32_scaled_diff_vs_torch": scaled_diff(ref, want),
            "fp32_scaled_diff_card_vs_cpu": scaled_diff(ref[:EXPORTED_CPU_ROWS], host_logits),
            "top1_fast_vs_fp32": top1_where_clear(fast_logits, ref),
            "context_graph": ctx.graph is not None,
            "context_logits_bitwise_equal": bool(np.array_equal(in_ctx, fast_logits)),
            "no_sync_in_forward": no_sync, "launches": launches, "seg_per_s_fast": rates}
    ok = (np.isfinite(ref).all() and ref.shape == (N_SEG, birdnet_v24.NUM_SPECIES)
          and fast.model_type is ModelType.BIRDNET_V24
          and "SplitToSequence" in ops
          and bool(ops & {"SequenceAt", "ConcatFromSequence", "SequenceMap"})
          and line["fp32_scaled_diff_vs_torch"] <= EXPORTED_ORACLE_TOL["torch"]
          and line["fp32_scaled_diff_card_vs_cpu"] <= EXPORTED_CPU_TOL
          and line["top1_fast_vs_fp32"]["ok"]
          and line["context_graph"] and line["context_logits_bitwise_equal"] and no_sync
          and launches.get("stage_stack_forward", 0) > 0)
    line["ok"] = bool(ok)
    emit(line)
    if not ok:
        raise AssertionError("op_sets: the sequence head disagrees")
    return launches


def _sync_free(fwd, params, args):
    """(no sync in a forward, the error if one synced)."""
    try:
        return forward_without_sync_of(fwd, params, args), None
    except RuntimeError as e:
        torch.cuda.set_sync_debug_mode("default")
        return False, str(e).splitlines()[0]


def _graph_ms(fwd, params, args):
    """Device ms of a graph replay of the forward, or None and why when the
    forward cannot be captured."""
    try:
        return time_ms(lambda: fwd(params, *args), reps=3), None
    except RuntimeError as e:
        torch.cuda.synchronize()
        return None, str(e).splitlines()[0]


def opset_ops_check(card: str) -> None:
    """(b) tests/_torch_opset_cases.py on the card against the host: fp32
    within its TOL of each output's scale (the heavy batch-separable cases
    on the host's first OPSET_HOST_ROWS rows), integer outputs (MaxPool's
    indices, ArgMax) and the random ops bit for bit and equal across two
    calls; each op's device ms (graph replay) and whether its forward
    syncs."""
    import _torch_opset_cases as oc

    cases, failed = {}, []
    for name in oc.CASES:
        data = oc.model_bytes(name)
        inputs = [np.array(v) for v in oc.inputs_of(name).values()]
        fwd, params = port_forward(data, CARD)
        args = [torch.from_numpy(v).to(CARD) for v in inputs]
        got = [o.cpu() for o in fwd(params, *args)]
        again = [o.cpu() for o in fwd(params, *args)]
        rows = OPSET_HOST_ROWS if name in oc.HOST_SLICED else None
        hfwd, hparams = port_forward(data, "cpu")
        host = hfwd(hparams, *[torch.from_numpy(v[:rows] if rows else v) for v in inputs])
        got_rows = [g[:rows] if rows else g for g in got]
        exact = [name in oc.RANDOM or not h.is_floating_point() for h in host]
        if not all(torch.equal(g, h) for g, h, e in zip(got_rows, host, exact) if e):
            err = None
        else:
            err = max([scaled_diff(g.double().numpy(), h.double().numpy())
                       for g, h, e in zip(got_rows, host, exact) if not e], default=0.0)
        repeat = all(torch.equal(a, b) for a, b in zip(got, again))
        no_sync, sync_error = _sync_free(fwd, params, args)
        ms, capture_error = _graph_ms(fwd, params, args)
        cases[name] = {"shapes": [list(g.shape) for g in got],
                       "scaled_diff_card_vs_cpu": err, "host_rows": rows,
                       "repeat_bitwise": repeat, "no_sync_in_forward": no_sync,
                       "sync_error": sync_error, "ms": ms, "capture_error": capture_error}
        if err is None or err > oc.TOL or (name in oc.RANDOM and not repeat) or not all(
                torch.isfinite(g.float()).all() for g in got):
            failed.append(name)
        del fwd, params, args, got, again, host
        torch.cuda.empty_cache()
    emit({"phase": "op_sets", "part": "ops", "card": card, "tol": oc.TOL, "cases": cases,
          "ok": not failed})
    if failed:
        raise AssertionError(f"op_sets: ops disagree on the card: {failed}")


def ml_heads_check(card: str, tmp: str) -> None:
    """(c) tests/_torch_opset_cases.py's ai.onnx.ml heads on one hour of
    full-width v3.0 and Perch embeddings (conv, fast, embed_samples): card
    against the port on the host (scores within ML_TOL of their scale,
    labels equal), the linear head against its numpy oracle, no sync in
    any head's forward (the Platt loop's included), device ms per head and
    the SVM head's kernel launches per forward."""
    import _torch_opset_cases as oc

    pcm = (np.random.default_rng(SEED + 61).standard_normal(FAMILY_HOUR, dtype=np.float32)
           * 3000).clip(-32768, 32767).astype(np.int16)
    failed = []
    for family, module in FAMILIES.items():
        path = str(Path(tmp) / f"{family}_heads.onnx")
        P.save_model(module.build_model(seed=SEED, frontend="conv"), path)
        clf = built(path, family_labels(module.NUM_SPECIES), "fast")
        emb, _ = clf.embed_samples(pcm)
        del clf
        torch.cuda.empty_cache()
        emb = np.ascontiguousarray(np.asarray(emb, np.float32))
        heads = oc.ml_heads(emb, ML_HEAD_SEED)
        x_card, x_host = torch.from_numpy(emb).to(CARD), torch.from_numpy(emb)
        line = {"phase": "op_sets", "part": "ml_heads", "card": card, "family": family,
                "embeddings": list(emb.shape), "heads": {}}
        for head, data in heads.items():
            fwd, params = port_forward(data, CARD)
            hfwd, hparams = port_forward(data, "cpu")
            got = [o.cpu() for o in fwd(params, x_card)]
            want = hfwd(hparams, x_host)
            scores_diff = max(scaled_diff(g.double().numpy(), w.double().numpy())
                              for g, w in zip(got, want) if w.is_floating_point())
            labels_equal = all(torch.equal(g, w) for g, w in zip(got, want)
                               if not w.is_floating_point())
            no_sync, sync_error = _sync_free(fwd, params, [x_card])
            ms, capture_error = _graph_ms(fwd, params, [x_card])
            h = {"outputs": [list(g.shape) for g in got], "scaled_diff_card_vs_cpu": scores_diff,
                 "labels_equal": labels_equal, "no_sync_in_forward": no_sync,
                 "sync_error": sync_error, "ms": ms, "capture_error": capture_error}
            ok = scores_diff <= ML_TOL and labels_equal and no_sync
            if head == "linear":
                want_labels, want_scores = oc.linear_oracle(emb, oc.linear_attrs(emb, ML_HEAD_SEED))
                top2 = np.sort(want_scores, axis=1)[:, -2:]
                clear = top2[:, 1] - top2[:, 0] > ML_TOL
                h["scaled_diff_vs_numpy"] = scaled_diff(got[1].double().numpy(), want_scores)
                h["labels_vs_numpy_where_clear"] = (
                    f"{int((got[0].numpy() == want_labels)[clear].sum())}/{int(clear.sum())}")
                ok = (ok and h["scaled_diff_vs_numpy"] <= ML_TOL
                      and bool((got[0].numpy() == want_labels)[clear].all()))
            if head == "svm":
                h["kernel_launches_per_forward"] = sum(
                    device_kernel_names(lambda: fwd(params, x_card)).values())
            h["ok"] = bool(ok)
            line["heads"][head] = h
            if not ok:
                failed.append(f"{family}/{head}")
        emit(line)
    if failed:
        raise AssertionError(f"op_sets: ml heads disagree on the card: {failed}")


def phase_op_sets(card: str) -> dict:
    """The op_sets phase (see the module docstring). Returns the sequence
    head's launch counts."""
    t_phase = time.perf_counter()
    sys.path.insert(0, str(REPO / "tests"))
    with tempfile.TemporaryDirectory() as tmp:
        launches = seq_head_check(card, tmp)
        torch.cuda.empty_cache()
        opset_ops_check(card)
        ml_heads_check(card, tmp)
    emit({"phase": "op_sets_time", "card": card, "phase_s": time.perf_counter() - t_phase})
    return launches


# The contrib phase.
CONTRIB_FP32_TOL = 1e-4
CONTRIB_OP_TOL = 1e-5
CONTRIB_SCORE_RTOL = 1e-4
GQA_DECODE_STEPS = 16
# GPT-2 small's widths (12 layers of 768, 12 heads, vocab 50,257) and
# whisper-tiny's (d 384, 4 + 4 layers, 6 heads, vocab 51,865, 80 mels x 3,000
# frames; EOS 50257, <|notimestamps|> 50363), random weights from a seed.
GPT2_SMALL = dict(vocab=50257, d=768, layers=12, heads=12, n_pos=1024)
WHISPER_TINY = dict(vocab=51865, d=384, enc_layers=4, dec_layers=4, heads=6, mels=80,
                    n_pos=448, enc_pos=1500)
WHISPER_FRAMES, WHISPER_EOS, WHISPER_NO_TS = 3000, 50257, 50363


def ort_file_check(card: str, frontend: str, path: str, tmp: str, segs: np.ndarray,
                   pcm: np.ndarray) -> dict:
    """(1) The full-width v2.4 file rewritten as onnxruntime's offline
    optimizer writes it, through Classifier.builder() (fast through
    with_tpu(TPUConfig(...))). Returns its fast run's launch counts."""
    import _torch_contrib_cases as cc

    t0 = time.perf_counter()
    ort_path = str(Path(tmp) / f"birdnet_v24_{frontend}_ort.onnx")
    Path(ort_path).write_bytes(cc.ort_optimized(Path(path).read_bytes()))
    hist = cc.op_histogram(Path(ort_path).read_bytes())
    orig32 = built(path, LABELS, "fp32")
    ref = logits_of(orig32.predict_batch(segs))
    # The ORT file's run: every count starts at 0 here.
    reset_launches()
    fast = (Classifier.builder().model_path(ort_path).labels(LABELS)
            .with_tpu(TPUConfig(precision="fast", device_id=0)).top_k(5).build())
    fast_logits = logits_of(fast.predict_batch(segs))
    ctx = fast.create_batch_context(N_SEG)
    in_ctx = logits_of(fast.predict_batch_with_context(ctx, segs))
    fast_stream = fast.analyze_samples(pcm)
    no_sync = forward_without_sync(fast, segs)
    launches = read_launches()
    fp32 = built(ort_path, LABELS, "fp32")
    logits32 = logits_of(fp32.predict_batch(segs))
    no_sync = no_sync and forward_without_sync(fp32, segs)
    stream32, orig_stream32 = fp32.analyze_samples(pcm), orig32.analyze_samples(pcm)
    same_idx = all([p.index for p in a[1]] == [p.index for p in b[1]]
                   for a, b in zip(stream32, orig_stream32))
    conf_diff = max(abs(p.confidence - q.confidence) for a, b in zip(stream32, orig_stream32)
                    for p, q in zip(a[1], b[1]))
    host = (Classifier.builder().model_path(ort_path).labels(LABELS).precision("fp32")
            .with_device("cpu").build())
    host_logits = logits_of(host.predict_batch(segs[:EXPORTED_CPU_ROWS]))
    del host
    orig_fast = built(path, LABELS, "fast")
    orig_fast.analyze_samples(pcm)  # its key's capture, as fast's above
    rates = {"ort_context": statistics.median(context_rates(fast, ctx, segs))}
    for which, clf in (("ort", fast), ("original", orig_fast), ("original", orig_fast),
                       ("ort", fast)):  # in turns
        rates.setdefault(f"{which}_predict_batch32", []).append(seg_per_s(clf, segs))
        rates.setdefault(f"{which}_stream_hour", []).append(stream_rate(clf, pcm))
    line = {"phase": "contrib", "part": "ort_optimized", "card": card, "frontend": frontend,
            "ops": hist, "fp32_scaled_diff_vs_original": scaled_diff(logits32, ref),
            "fp32_scaled_diff_card_vs_cpu": scaled_diff(logits32[:EXPORTED_CPU_ROWS],
                                                        host_logits),
            "top1_fast_vs_fp32": top1_where_clear(fast_logits, logits32),
            "context_logits_bitwise_equal": bool(np.array_equal(in_ctx, fast_logits)),
            "stream_rows": [len(fast_stream), len(stream32)],
            "fp32_stream_topk_equal_original": same_idx,
            "fp32_stream_max_conf_diff_vs_original": conf_diff,
            "no_sync_in_forward": no_sync, "launches": launches,
            "b4_launches": launches.get("stage_stack_forward", 0), "seg_per_s_fast": rates,
            "part_s": time.perf_counter() - t0}
    ok = (line["fp32_scaled_diff_vs_original"] <= CONTRIB_FP32_TOL
          and line["fp32_scaled_diff_card_vs_cpu"] <= CONTRIB_FP32_TOL
          and line["top1_fast_vs_fp32"]["ok"] and line["context_logits_bitwise_equal"]
          and same_idx and conf_diff <= CONTRIB_FP32_TOL and no_sync
          and len(fast_stream) == len(stream32) == len(orig_stream32) > 0
          and hist.get("com.microsoft.FusedConv", 0) > 0
          and hist.get("com.microsoft.QuickGelu", 0) > 0
          and launches.get(FRONTEND_KERNEL[frontend], 0) > 0)
    line["ok"] = bool(ok)
    emit(line)
    if not ok:
        raise AssertionError(f"contrib: the ORT-optimized {frontend} file disagrees")
    del fast, fp32, orig32, orig_fast, ctx
    torch.cuda.empty_cache()
    return launches


def contrib_ops_check(card: str) -> None:
    """(2) tests/_torch_contrib_cases.py's BIG cases on the card against the
    host (floats within CONTRIB_OP_TOL of each output's scale, integers
    exact or, for codes from a float sum, within one), each op's device ms
    (graph replay); 16 GroupQueryAttention decode steps over the prefill's
    cache; MurmurHash3 on the card bit for bit against the host's numpy
    path."""
    import _torch_contrib_cases as cc

    t0 = time.perf_counter()
    cases, failed = {}, []
    for name, case in cc.BIG.items():
        data, vals = case()
        args = {dev: [torch.from_numpy(np.array(v)).to(dev) for v in vals.values()]
                for dev in (CARD, "cpu")}
        fwd, params = port_forward(data, CARD)
        got = [o.cpu() for o in fwd(params, *args[CARD])]
        hfwd, hparams = port_forward(data, "cpu")
        want = hfwd(hparams, *args["cpu"])
        err, ints_ok = cc.compare(name, got, want)
        ms, capture_error = _graph_ms(fwd, params, args[CARD])
        cases[name] = {"shapes": [list(g.shape) for g in got], "scaled_diff_card_vs_cpu": err,
                       "integers_ok": ints_ok, "ms": ms, "capture_error": capture_error}
        if name == "MurmurHash3":
            host_np = get_lowering("MurmurHash3", "com.microsoft")(
                OpContext("MurmurHash3", {"seed": 42, "positive": 1}), vals["x"])[0]
            cases[name]["bitwise_vs_host_numpy"] = bool(
                np.array_equal(got[0].view(torch.int32).numpy().view(np.uint32), host_np))
            ints_ok = ints_ok and cases[name]["bitwise_vs_host_numpy"]
        if not (err <= CONTRIB_OP_TOL and ints_ok and ms is not None):
            failed.append(name)
        del fwd, params, hfwd, hparams, args, got, want
        torch.cuda.empty_cache()
    # 16 decode steps: each step's presents are the next step's past.
    data, vals = cc.BIG["GroupQueryAttention_prefill"]()
    decode, _ = cc.gqa_case(1, 1, 1024, 32, 8, 128, SEED + 70, cache=1024 + 24)
    pres, step_err = {}, 0.0
    for dev in (CARD, "cpu"):
        fwd, params = port_forward(data, dev)
        _, pk, pv = fwd(params, *[torch.from_numpy(np.array(v)).to(dev) for v in vals.values()])
        dfwd, dparams = port_forward(decode, dev)
        rng = np.random.default_rng(SEED + 71)
        outs = []
        for i in range(GQA_DECODE_STEPS):
            total = 1024 + i + 1
            step = [rng.standard_normal((1, 1, n)).astype(np.float32) for n in (4096, 1024, 1024)]
            args = [torch.from_numpy(a).to(dev) for a in step] + [
                pk, pv, torch.tensor([total - 1], dtype=torch.int32, device=dev),
                torch.tensor([total], dtype=torch.int32, device=dev)]
            y, pk, pv = dfwd(dparams, *args)
            outs.append(y.cpu())
        pres[str(dev)] = (outs, pk.cpu())
    for g, w in zip(pres[str(CARD)][0], pres["cpu"][0]):
        step_err = max(step_err, scaled_diff(g.double().numpy(), w.double().numpy()))
    cache_err = scaled_diff(pres[str(CARD)][1].double().numpy(), pres["cpu"][1].double().numpy())
    cases["GroupQueryAttention_16_decode_steps"] = {
        "scaled_diff_card_vs_cpu": max(step_err, cache_err),
        "cache": list(pres["cpu"][1].shape)}
    if max(step_err, cache_err) > CONTRIB_OP_TOL:
        failed.append("GroupQueryAttention_16_decode_steps")
    emit({"phase": "contrib", "part": "ops", "card": card, "tol": CONTRIB_OP_TOL,
          "cases": cases, "part_s": time.perf_counter() - t0, "ok": not failed})
    if failed:
        raise AssertionError(f"contrib: ops disagree on the card: {failed}")


def _generation_call(data: bytes, vals: dict, dev):
    """One generation forward on ``dev`` as a call without arguments; the
    inputs the lowering reads on the host stay numpy."""
    import _torch_contrib_cases as cc

    fwd, params = port_forward(data, dev)
    args = [np.array(v) if k in cc.HOST_INPUTS else torch.from_numpy(np.array(v)).to(dev)
            for k, v in vals.items()]
    return lambda: fwd(params, *args)


def _generation_run(call, dev, op: str) -> tuple:
    """(outputs on the host, host reads of the op, seconds) of one call."""
    from birdnet_tpu_torch.compiler import ops as tops

    tops.HOST_READS[op] = 0
    if dev == CARD:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = call()
    if dev == CARD:
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return [o.cpu() for o in outs], tops.HOST_READS[op], seconds


def _synchronizing_ops(call) -> tuple:
    """(outputs on the host, the synchronizing CUDA operations of one call),
    counted as torch.cuda.set_sync_debug_mode("warn") reports them."""
    import warnings

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            outs = call()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return [o.cpu() for o in outs], sum("synchroniz" in str(w.message) for w in caught)


def generation_profile(call, steps: int, wall_s: float) -> dict:
    """One generation call under torch.profiler: the device's busy time,
    its share of the unprofiled call's ``wall_s``, and the kernels and
    device-to-host copies per generated step."""
    wall_ms, events = _profile_events(call)
    busy_ms = _device_busy_ms(events)
    kernels = sum(1 for e in events if e.get("ph") == "X" and e.get("cat") == "kernel")
    dtoh = sum(1 for e in events if e.get("ph") == "X" and e.get("cat") == "gpu_memcpy"
               and "DtoH" in e.get("name", ""))
    return {"profiled_wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_busy_share_of_unprofiled_call": busy_ms / (1e3 * wall_s),
            "kernels_per_step": kernels / steps, "dtoh_copies_per_step": dtoh / steps}


def _top2_margin(m, prefix: np.ndarray) -> float:
    """The top-2 margin of ``m``'s next-token logits after ``prefix`` (one
    row), on the host."""
    rows, length = prefix.shape
    hd = m.head_dim()
    empty = [torch.zeros(2, rows, m.heads, 0, hd) for _ in range(m.layers_n)]
    with torch.no_grad():
        ids = torch.from_numpy(prefix.astype(np.int32))
        pos = torch.arange(length, dtype=torch.int32)[None].expand(rows, length)
        logits = m(ids, pos, torch.ones((rows, length), dtype=torch.int32), *empty)[0][0, -1]
    top2 = torch.topk(logits, 2).values
    return float(top2[0] - top2[1])


def generation_check(card: str) -> None:
    """(3) GreedySearch, BeamSearch (4 beams) and Sampling over a GPT-2
    small-width decoder, and WhisperBeamSearch (4 beams, the timestamp
    rules) at whisper-tiny widths, card against host at fp32."""
    import _torch_contrib_cases as cc

    t_part = time.perf_counter()
    gpt = cc.TinyGpt(seed=SEED + 80, **GPT2_SMALL)
    t0 = time.perf_counter()
    step = cc.gpt_step_graph(gpt)
    export_s = time.perf_counter() - t0
    prompt = np.random.default_rng(SEED + 81).integers(0, GPT2_SMALL["vocab"], (2, 16))
    beams = dict(num_beams=np.array([4], np.int32), num_return_sequences=np.array([2], np.int32),
                 length_penalty=np.array([1.0], np.float32),
                 repetition_penalty=np.array([1.0], np.float32))
    runs = {
        "GreedySearch": cc.generation_model(
            "GreedySearch", {"decoder": step}, cc.gen_values(
                prompt, 64, repetition_penalty=np.array([1.1], np.float32)),
            eos=GPT2_SMALL["vocab"] + 1, pad=0),
        "Sampling": cc.generation_model(
            "Sampling", {"decoder": step}, cc.gen_values(prompt, 64),
            eos=GPT2_SMALL["vocab"] + 1, pad=0, temperature=0.8, top_p=0.9, seed=SEED + 82),
        "BeamSearch": cc.generation_model(
            "BeamSearch", {"decoder": step}, cc.gen_values(prompt, 64, **beams),
            eos=GPT2_SMALL["vocab"] + 1, pad=0, outputs=("sequences", "sequences_scores"),
            model_type=0),
    }
    whisper = cc.EncDec(kind="whisper", seed=SEED + 83, **WHISPER_TINY)
    feats = (np.random.default_rng(SEED + 84).standard_normal(
        (1, WHISPER_TINY["mels"], WHISPER_FRAMES)) * 0.5).astype(np.float32)
    t0 = time.perf_counter()
    enc, dec = cc.encdec_graphs(whisper, feats)
    export_s += time.perf_counter() - t0
    wvals = cc.gen_values([[WHISPER_EOS + 1, WHISPER_EOS + 2, WHISPER_EOS + 3]], 48, **beams)
    wvals["decoder_input_ids"] = wvals["input_ids"]
    wvals["input_ids"] = feats
    wvals["logits_processor"] = np.array([1], np.int32)
    runs["WhisperBeamSearch"] = cc.generation_model(
        "WhisperBeamSearch", {"encoder": enc, "decoder": dec}, wvals, eos=WHISPER_EOS, pad=0,
        outputs=("sequences", "sequences_scores"), model_type=2,
        no_timestamps_token_id=WHISPER_NO_TS, max_initial_timestamp_index=50)
    del whisper
    failed, line = [], {"phase": "contrib", "part": "generation", "card": card,
                        "export_s": export_s, "runs": {}}
    for op, (data, vals) in runs.items():
        # The card: a first call (the CUDA libraries' warm-up and the
        # upload of host values), a timed one, and one under the sync
        # debug mode; then the host's.
        call = _generation_call(data, vals, CARD)
        first, _, first_s = _generation_run(call, CARD, op)
        got, reads, card_s = _generation_run(call, CARD, op)
        counted, syncs = _synchronizing_ops(call)
        want, _, host_s = _generation_run(_generation_call(data, vals, "cpu"), "cpu", op)
        seq, ref = got[0].numpy(), want[0].numpy()
        s0 = vals["decoder_input_ids" if op == "WhisperBeamSearch" else "input_ids"].shape[1]
        generated = int((seq[..., s0:] != 0).sum())
        steps = seq.shape[-1] - s0
        # A step generates one position of every prompt row (seq.shape[0]).
        r = {"sequences": list(seq.shape), "sequences_equal": bool(np.array_equal(seq, ref)),
             "host_reads": reads, "host_reads_per_step": reads / max(steps - 1, 1),
             "synchronizing_ops": syncs, "synchronizing_ops_per_step": syncs / steps,
             "first_call_s": first_s, "card_s": card_s, "host_s": host_s,
             "steps_per_s": steps / card_s, "rows": int(seq.shape[0]),
             "tokens_per_s_all_rows": seq.shape[0] * steps / card_s,
             "generated_non_pad": generated}
        if op in ("GreedySearch", "WhisperBeamSearch"):
            r["profile"] = generation_profile(call, steps, card_s)
        if len(got) > 1:
            g, w = got[1].double().numpy(), want[1].double().numpy()
            r["scores_max_rel_diff"] = float((np.abs(g - w) / np.abs(w)).max())
            r["scores_ok"] = r["scores_max_rel_diff"] <= CONTRIB_SCORE_RTOL
        if not r["sequences_equal"]:
            diff = np.argwhere(seq != ref)[0]
            r["first_difference"] = [int(v) for v in diff]
            if op in ("GreedySearch", "Sampling"):
                r["top2_margin_there"] = _top2_margin(gpt, ref[diff[0]:diff[0] + 1, :diff[-1]])
        if op == "Sampling":
            r["card_repeat_bitwise"] = all(np.array_equal(o[0].numpy(), seq)
                                           for o in (first, counted))
        del call
        ok = r["sequences_equal"] and r.get("scores_ok", True) and r.get(
            "card_repeat_bitwise", True) and reads >= 1
        r["ok"] = bool(ok)
        line["runs"][op] = r
        if not ok:
            failed.append(op)
    line["ok"] = not failed
    line["part_s"] = time.perf_counter() - t_part
    emit(line)
    if failed:
        raise AssertionError(f"contrib: generation disagrees on the card: {failed}")


def phase_contrib(card: str, paths: dict) -> dict:
    """The contrib phase (see the module docstring). Returns the
    ORT-optimized files' launch counts."""
    t_phase = time.perf_counter()
    sys.path.insert(0, str(REPO / "tests"))
    segs = (np.random.default_rng(SEED + 90).normal(size=(N_SEG, S)) * 0.1).astype(np.float32)
    pcm = (np.random.default_rng(SEED + 91).standard_normal(HOUR, dtype=np.float32)
           * 3000).clip(-32768, 32767).astype(np.int16)
    runs = []
    with tempfile.TemporaryDirectory() as tmp:
        for frontend in FRONTEND_KERNEL:
            runs.append(ort_file_check(card, frontend, paths[frontend], tmp, segs, pcm))
    contrib_ops_check(card)
    generation_check(card)
    emit({"phase": "contrib_time", "card": card, "phase_s": time.perf_counter() - t_phase})
    return {k: sum(run.get(k, 0) for run in runs) for k in runs[0]}


# The mesh phase: one process drives meshes that name cuda:0 more than once,
# so it checks the layout and the kernels under it and says nothing about
# scaling. fp32 mesh against the single-device classifier on the card:
# logits within MESH_TOL of their scale, top-K indices equal, confidences
# within MESH_TOL; the batch context against the mesh's predict_batch within
# MESH_CTX_TOL; the CLI's two ranks against one process within CLI_CONF_TOL.
MESHES = ((1, 1), (2, 2), (1, 4))
MESH_TOL = 1e-4
MESH_CTX_TOL = 1e-5
MESH_STREAM_SECONDS = 600
MESH_STREAM_REPEATS = 5
MESH_DEVICE_GROWTH = 1 << 20
MESH_BATCHER_REQUESTS = 64
MESH_WAVS, MESH_WAV_SECONDS = 4, 9
MESH_PROC_TIMEOUT_S = 120


def mesh_built(path: str, labels: list, policy: str, shape: tuple, top_k: int = 5):
    """A classifier over a mesh of ``shape`` whose every cell is the card."""
    mesh = make_mesh([CARD] * (shape[0] * shape[1]), shape=shape)
    return (Classifier.builder().model_path(path).labels(labels).precision(policy)
            .top_k(top_k).with_mesh(mesh).build())


def mesh_vs_single(got, want, emb: bool = False) -> dict:
    """A mesh classifier's results against the single-device classifier's
    (fp32): scaled logit (and embedding) difference, top-K indices equal,
    the largest confidence difference."""
    lg, wl = logits_of(got), logits_of(want)
    line = {"scaled_logit_diff": scaled_diff(lg, wl),
            "topk_indices_equal": all([p.index for p in g.predictions]
                                      == [p.index for p in w.predictions]
                                      for g, w in zip(got, want)),
            "max_conf_diff": max(abs(p.confidence - q.confidence)
                                 for g, w in zip(got, want)
                                 for p, q in zip(g.predictions, w.predictions))}
    ok = (line["scaled_logit_diff"] <= MESH_TOL and line["topk_indices_equal"]
          and line["max_conf_diff"] <= MESH_TOL)
    if emb:
        line["scaled_embedding_diff"] = scaled_diff(embeddings_of(got), embeddings_of(want))
        ok = ok and line["scaled_embedding_diff"] <= MESH_TOL
    line["ok"] = bool(ok)
    return line


def streams_agree(got, want) -> dict:
    """Two analyze_samples results: the same segments and top-K indices,
    confidences within MESH_TOL."""
    same = len(got) == len(want) and all(
        t1 == t2 and [p.index for p in p1] == [p.index for p in p2]
        for (t1, p1), (t2, p2) in zip(got, want))
    conf = max((abs(p.confidence - q.confidence) for (_, p1), (_, p2) in zip(got, want)
                for p, q in zip(p1, p2)), default=0.0) if same else None
    return {"segments": len(got), "topk_equal": same, "max_conf_diff": conf,
            "ok": bool(same and conf <= MESH_TOL)}


def in_turns(fns: dict, rounds: int = 2, calls: int = 5) -> dict:
    """Median of each rate function's readings, taken in turns (a, b, b, a)."""
    rates = {name: [] for name in fns}
    for r in range(rounds):
        for name in (list(fns) if r % 2 == 0 else list(fns)[::-1]):
            rates[name].append(fns[name](calls))
    return {name: statistics.median(v) for name, v in rates.items()}


def mesh_cli_check(path: str, tmp: Path) -> dict:
    """Two CLI processes on cuda:0 joined by --coordinator over MESH_WAVS
    seeded WAVs, each writing out.csv.<rank>, against one process's CSV."""
    import csv
    import socket

    env = dict(os.environ, PYTHONPATH=str(REPO))
    rng = np.random.default_rng(SEED + 101)
    wavs = []
    for i in range(MESH_WAVS):
        wav = tmp / f"rec{i}.wav"
        write_wav(wav, (rng.standard_normal(MESH_WAV_SECONDS * 48_000) * 0.1).astype(np.float32),
                  48_000)
        wavs.append(str(wav))
    labels = tmp / "labels.txt"
    labels.write_text("\n".join(LABELS), encoding="utf-8")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    base = [sys.executable, "-m", "birdnet_tpu_torch.cli", *wavs, "-m", path, "-l", str(labels),
            "--min-confidence", "0", "-t", "0"]
    cmds = [base + ["--csv", str(tmp / "out.csv"), "--coordinator", f"127.0.0.1:{port}",
                    "--num-processes", "2", "--process-id", str(rank)] for rank in range(2)]
    cmds.append(base + ["--csv", str(tmp / "single.csv")])
    t0 = time.perf_counter()
    procs = [subprocess.Popen(cmd, cwd=tmp, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for cmd in cmds]
    try:
        outs = [p.communicate(timeout=MESH_PROC_TIMEOUT_S) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, (so, se) in zip(procs, outs):
        if p.returncode != 0:
            raise AssertionError(f"mesh: CLI exited {p.returncode}: {so[-1500:]} {se[-1500:]}")

    def rows(name):
        with open(tmp / name, newline="", encoding="utf-8") as f:
            return [(r[0], r[1], r[2], r[3], float(r[4])) for r in list(csv.reader(f))[1:]]

    ranks = sorted(rows("out.csv.0") + rows("out.csv.1"))
    single = sorted(rows("single.csv"))
    same = [r[:4] for r in ranks] == [r[:4] for r in single]
    conf = max(abs(a[4] - b[4]) for a, b in zip(ranks, single)) if same else None
    line = {"rows": len(ranks), "files": len({r[0] for r in ranks}), "same_rows": same,
            "max_conf_diff": conf, "seconds": time.perf_counter() - t0,
            "rank_shards": [next((ln for ln in se.splitlines() if ln.startswith("Distributed:")),
                                 None) for _, se in outs[:2]]}
    line["ok"] = bool(same and line["files"] == MESH_WAVS and conf <= CLI_CONF_TOL
                      and "analyzing 2 file(s)" in outs[0][1]
                      and "analyzing 2 file(s)" in outs[1][1])
    return line


def eager_batch(eng, bucket: int):
    """The mesh's eager step of a batch bucket (the plain version its
    captured program is held to)."""
    from birdnet_tpu_torch.parallel.engine import _EagerBatch

    return _EagerBatch(eng, bucket, eng.embed_index is not None)


def arrays_equal(got, want) -> bool:
    return all((g is None and w is None) or np.array_equal(g, w) for g, w in zip(got, want))


def mesh_eager_stream(eng, samples, **kw):
    """``eng.analyze`` through the mesh's eager tile loop (the plain
    version of its captured tiles)."""
    eng._run_tiles = eng._eager_tiles
    try:
        return eng.analyze(samples, **kw)
    finally:
        del eng._run_tiles


def calls_rate(fn, rows: int):
    """A rate function for :func:`in_turns`: the median rows/s of ``n``
    calls of ``fn`` (host clock; each ends with its results on the host),
    after one warm call."""
    def rate(n):
        fn()
        readings = []
        for _ in range(n):
            t0 = time.perf_counter()
            fn()
            readings.append(rows / (time.perf_counter() - t0))
        return statistics.median(readings)
    return rate


def mesh_replays(program) -> int:
    """Graphs one call of a mesh program replays: one per card and the
    merge's where the cells span cards."""
    return len(program.step.graphs) + (program.step._merge_graph is not None)


def idle_share(fn) -> dict:
    """torch.profiler over one call of ``fn``: wall, device busy (the union
    of its kernel, copy and set intervals) and the idle share."""
    wall_ms, events = _profile_events(fn)
    busy_ms = _device_busy_ms(events)
    if busy_ms <= 0.0:
        raise AssertionError("mesh profile: no device interval in the trace")
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms, "idle_share": 1.0 - busy_ms / wall_ms}


def phase_mesh(card: str, paths: dict, segs: np.ndarray) -> dict:
    """The mesh phase (see the module docstring). Returns the launch counts
    of the mesh runs."""
    t_phase = time.perf_counter()
    total = {k: 0 for k in read_launches()}
    failed = []

    def launches_of(fn):
        reset_launches()
        out = fn()
        return out, read_launches()

    def counted(fn):
        out, got = launches_of(fn)
        for k in total:
            total[k] += got[k]
        return out, got

    def check(line):
        emit(line)
        if not line["ok"]:
            failed.append(line["part"])

    pcm = (np.random.default_rng(SEED + 103).standard_normal(MESH_STREAM_SECONDS * 48_000)
           * 3000).clip(-32768, 32767).astype(np.int16)
    n_stream = -(-pcm.shape[0] // S)

    def stream_rate(analyze):
        def rate(n):
            readings = []
            for _ in range(n):
                t0 = time.perf_counter()
                analyze(pcm)
                readings.append(n_stream / (time.perf_counter() - t0))
            return statistics.median(readings)
        return rate

    # (1) v2.4 conv on each mesh at fast: predict_batch(32), the batch
    # context and the ten-minute stream replay the captured programs, held
    # to the eager step bit for bit; fp32 against the single classifier.
    single = {policy: built(paths["conv"], LABELS, policy) for policy in ("fp32", "fast")}
    ref = single["fp32"].predict_batch(segs)
    single_ctx = single["fast"].create_batch_context(N_SEG)
    # The single device's launches per call: the yardstick, not the mesh path.
    _, per_call = launches_of(lambda: single["fast"].predict_batch(segs))
    rows_mask = np.random.default_rng(SEED + 106).random((N_SEG, birdnet_v24.NUM_SPECIES)) < 0.5
    rows_mask[:, 0] = True
    conv_meshes = {}
    for shape in MESHES:
        fast = mesh_built(paths["conv"], LABELS, "fast", shape)
        fp32 = mesh_built(paths["conv"], LABELS, "fp32", shape)
        conv_meshes[shape] = {"fast": fast, "fp32": fp32}
        eng = fast._engine
        cells = shape[0] * (shape[1] if eng.head_sharded else 1)
        t0 = time.perf_counter()
        ctx = fast.create_batch_context(N_SEG, precompile_row_mask=True)
        capture_s = time.perf_counter() - t0
        program = eng.compiled(N_SEG)
        got_fast, launches = counted(lambda: fast.predict_batch(segs))
        eager = eager_batch(eng, N_SEG)
        graph_out = program.run(segs, None, N_SEG, None)
        masks = np.ones((N_SEG, birdnet_v24.NUM_SPECIES), bool)
        masks[:N_SEG - 3] = rows_mask[:N_SEG - 3]
        got_ctx = fast.predict_batch_with_context(ctx, segs[:N_SEG - 3],
                                                  species_masks=rows_mask[:N_SEG - 3])
        want_ctx = eager.run(segs[:N_SEG - 3], masks, N_SEG - 3, None)
        eng.analyze(pcm)  # captures the key's graphs (the warm calls count)
        stream_graph, stream_launches = counted(lambda: eng.analyze(pcm))
        line = {"phase": "mesh", "part": f"v24_conv_{shape[0]}x{shape[1]}", "card": card,
                "cells_run": cells, "head_sharded": eng.head_sharded,
                "species_padded": eng._cells.head.n_padded,
                "context_graph": ctx.graph is program, "capture_s": capture_s,
                "replays_per_call": mesh_replays(program),
                "stream_keys": [list(k) for k in eng.programs],
                "stream_keys_eager": [list(k) for k, p in eng.programs.items() if p.eager],
                "graph_vs_eager_predict_batch_bitwise": arrays_equal(
                    graph_out, eager.run(segs, None, N_SEG, None)),
                "graph_vs_eager_context_row_masks_bitwise": bool(np.array_equal(
                    logits_of(got_ctx), want_ctx[2])) and all(
                    [p.index for p in r.predictions] == list(i[:len(r.predictions)])
                    for r, i in zip(got_ctx, want_ctx[1])),
                "graph_vs_eager_stream_bitwise": arrays_equal(
                    stream_graph, mesh_eager_stream(eng, pcm)),
                "fp32_vs_single": mesh_vs_single(fp32.predict_batch(segs), ref),
                "fast_top1_vs_single_fp32": top1_where_clear(logits_of(got_fast),
                                                             logits_of(ref)),
                "launches_one_call": {k: launches[k] for k in
                                      ("filterbank_logpower", "stage_stack_forward")},
                "expected_launches": {k: cells * per_call[k] for k in
                                      ("filterbank_logpower", "stage_stack_forward")},
                "stream_launches": {k: stream_launches[k] for k in
                                    ("filterbank_logpower", "stage_stack_forward")},
                "stream_tiles": -(-n_stream // eng.tile)}
        line["seg_per_s_fast_predict_batch32"] = in_turns(
            {"single_context": lambda n: statistics.median(
                context_rates(single["fast"], single_ctx, segs, n)),
             "single_predict_batch": lambda n: seg_per_s(single["fast"], segs, n),
             "mesh_graph": lambda n: seg_per_s(fast, segs, n),
             "mesh_context": lambda n: statistics.median(context_rates(fast, ctx, segs, n)),
             "mesh_graph_step": calls_rate(lambda: program.run(segs, None, N_SEG, None), N_SEG),
             "mesh_eager_step": calls_rate(lambda: eager.run(segs, None, N_SEG, None), N_SEG)})
        line["seg_per_s_fast_stream"] = in_turns(
            {"single": stream_rate(single["fast"].analyze_samples),
             "mesh_graph": stream_rate(eng.analyze),
             "mesh_eager": stream_rate(lambda x: mesh_eager_stream(eng, x))}, calls=2)
        line["rates_note"] = "one card named by every cell: layout, not scaling"
        expected_stream = {k: v * line["stream_tiles"]
                           for k, v in line["expected_launches"].items()}
        line["ok"] = bool(line["fp32_vs_single"]["ok"] and line["fast_top1_vs_single_fp32"]["ok"]
                          and line["launches_one_call"] == line["expected_launches"]
                          and line["stream_launches"] == expected_stream
                          and line["context_graph"] and line["replays_per_call"] == 1
                          and line["graph_vs_eager_predict_batch_bitwise"]
                          and line["graph_vs_eager_context_row_masks_bitwise"]
                          and line["graph_vs_eager_stream_bitwise"]
                          and not line["stream_keys_eager"]
                          and eng.head_sharded == (shape[1] > 1)
                          and launches["filterbank_logpower"] > 0)
        check(line)
        del ctx

    # (2) The STFT form on (2, 2) at fast: B1 once per cell per replay.
    stft_ref = built(paths["stft"], LABELS, "fp32").predict_batch(segs)
    stft = mesh_built(paths["stft"], LABELS, "fast", (2, 2))
    stft._engine.warmup((N_SEG,))
    got, launches = counted(lambda: stft.predict_batch(segs))
    line = {"phase": "mesh", "part": "v24_stft_2x2", "card": card,
            "stft_melspec_launches": launches["stft_melspec"],
            "stage_stack_forward_launches": launches["stage_stack_forward"],
            "graph_vs_eager_bitwise": arrays_equal(
                stft._engine.compiled(N_SEG).run(segs, None, N_SEG, None),
                eager_batch(stft._engine, N_SEG).run(segs, None, N_SEG, None)),
            "fast_top1_vs_single_fp32": top1_where_clear(logits_of(got), logits_of(stft_ref))}
    line["ok"] = bool(launches["stft_melspec"] == 4 and line["fast_top1_vs_single_fp32"]["ok"]
                      and line["graph_vs_eager_bitwise"]
                      and launches["stage_stack_forward"] == 4 * per_call["stage_stack_forward"])
    check(line)
    del stft, stft_ref

    # (3) Perch v2 conv on (2, 2) at fp32: the real head padded to 14,796.
    with tempfile.TemporaryDirectory() as tmp:
        perch_path = str(Path(tmp) / "perch_conv.onnx")
        P.save_model(perch_v2.build_model(seed=SEED, frontend="conv"), perch_path)
        labels = family_labels(perch_v2.NUM_SPECIES)
        perch_segs = (np.random.default_rng(SEED + 102).normal(size=(N_SEG, FAMILY_S))
                      * 0.1).astype(np.float32)
        want = built(perch_path, labels, "fp32").predict_batch(perch_segs)
        perch = mesh_built(perch_path, labels, "fp32", (2, 2))
        got, _ = counted(lambda: perch.predict_batch(perch_segs))
    line = {"phase": "mesh", "part": "perch_conv_2x2", "card": card,
            "species_padded": perch._engine._cells.head.n_padded,
            "head_sharded": perch._engine.head_sharded,
            "embedding_width": int(got[0].embeddings.shape[0]),
            "max_index": max(p.index for r in got for p in r.predictions),
            "graph_vs_eager_bitwise": arrays_equal(
                perch._engine.compiled(N_SEG).run(perch_segs, None, N_SEG, None),
                eager_batch(perch._engine, N_SEG).run(perch_segs, None, N_SEG, None)),
            "fp32_vs_single": mesh_vs_single(got, want, emb=True)}
    line["ok"] = bool(line["fp32_vs_single"]["ok"] and line["species_padded"] == 14796
                      and line["head_sharded"] and line["embedding_width"] == 1536
                      and line["max_index"] < perch_v2.NUM_SPECIES
                      and line["graph_vs_eager_bitwise"])
    check(line)
    del perch, want, got

    # (4) Ten minutes of int16 streamed on (2, 2) at fp32 against the single
    # classifier's stream, with and without a per-call species mask (the
    # masked key against the eager loop bit for bit); the fast stream's
    # device memory and keys across MESH_STREAM_REPEATS more runs; the idle
    # share of one profiled fast stream and one profiled context call.
    mask = np.random.default_rng(SEED + 104).random(birdnet_v24.NUM_SPECIES) < 0.1
    mesh22 = conv_meshes[2, 2]
    eng22 = mesh22["fast"]._engine
    streamed_mesh, _ = counted(lambda: mesh22["fp32"].analyze_samples(pcm))
    masked_mesh, _ = counted(lambda: mesh22["fp32"].analyze_samples(pcm, species_mask=mask))
    fp32_eng = mesh22["fp32"]._engine
    masked_bitwise = arrays_equal(fp32_eng.analyze(pcm, species_mask=mask),
                                  mesh_eager_stream(fp32_eng, pcm, species_mask=mask))
    eng22.analyze(pcm)
    torch.cuda.synchronize()
    keys = list(eng22.programs)
    memory = torch.cuda.memory_allocated()
    for _ in range(MESH_STREAM_REPEATS):
        eng22.analyze(pcm)
    torch.cuda.synchronize()
    growth = torch.cuda.memory_allocated() - memory
    ctx22 = mesh22["fast"].create_batch_context(N_SEG)
    mesh22["fast"].predict_batch_with_context(ctx22, segs)
    single["fast"].analyze_samples(pcm)
    line = {"phase": "mesh", "part": "stream_2x2", "card": card,
            "segments": n_stream,
            "fp32_vs_single": streams_agree(streamed_mesh, single["fp32"].analyze_samples(pcm)),
            "fp32_masked_vs_single": streams_agree(
                masked_mesh, single["fp32"].analyze_samples(pcm, species_mask=mask)),
            "fp32_masked_graph_vs_eager_bitwise": masked_bitwise,
            "masked_only_allowed": all(mask[p.index] for _, ps in masked_mesh for p in ps),
            "fp32_keys": [list(k) for k in fp32_eng.programs],
            "fast_repeats": MESH_STREAM_REPEATS, "fast_device_growth_bytes": growth,
            "fast_keys_unchanged": list(eng22.programs) == keys,
            "profile_fast_stream": idle_share(lambda: mesh22["fast"].analyze_samples(pcm)),
            "profile_single_fast_stream": idle_share(
                lambda: single["fast"].analyze_samples(pcm)),
            "profile_fast_context": idle_share(
                lambda: mesh22["fast"].predict_batch_with_context(ctx22, segs)),
            "profile_single_fast_context": idle_share(
                lambda: single["fast"].predict_batch_with_context(single_ctx, segs)),
            "seg_per_s_fp32_stream": in_turns(
                {"single": stream_rate(single["fp32"].analyze_samples),
                 "mesh_graph": stream_rate(mesh22["fp32"].analyze_samples),
                 "mesh_eager": stream_rate(lambda x: mesh_eager_stream(fp32_eng, x))},
                calls=2),
            "rates_note": "one card named by every cell: layout, not scaling"}
    line["ok"] = bool(line["fp32_vs_single"]["ok"] and line["fp32_masked_vs_single"]["ok"]
                      and line["masked_only_allowed"] and masked_bitwise
                      and not any(p.eager for p in fp32_eng.programs.values())
                      and sorted(k[4] for k in fp32_eng.programs) == [False, True]
                      and growth <= MESH_DEVICE_GROWTH and line["fast_keys_unchanged"])
    check(line)

    # (5) The batch context and the batcher on (2, 2).
    ctx = mesh22["fast"].create_batch_context(N_SEG)
    got_ctx, ctx_launches = counted(lambda: mesh22["fast"].predict_batch_with_context(ctx, segs))
    want_ctx = mesh22["fast"].predict_batch(segs)
    from birdnet_tpu_torch.serve import DynamicBatcher

    reqs = (np.random.default_rng(SEED + 105).normal(size=(MESH_BATCHER_REQUESTS, S))
            * 0.1).astype(np.float32)
    want_reqs = single["fp32"].predict_batch(reqs)

    def batched():
        with DynamicBatcher(mesh22["fp32"], max_batch=N_SEG, max_wait_ms=5.0) as batcher:
            futures = [batcher.submit(seg) for seg in reqs]
            return [f.result(timeout=120) for f in futures]

    got_reqs, _ = counted(batched)
    ctx_lg, want_lg = logits_of(got_ctx), logits_of(want_ctx)
    line = {"phase": "mesh", "part": "batch_context_and_batcher_2x2", "card": card,
            "context_graph": ctx.graph is not None,
            "context_topk_equal": all([p.index for p in g.predictions]
                                      == [p.index for p in w.predictions]
                                      for g, w in zip(got_ctx, want_ctx)),
            "context_scaled_logit_diff": scaled_diff(ctx_lg, want_lg),
            "context_launches": {k: ctx_launches[k] for k in
                                 ("filterbank_logpower", "stage_stack_forward")},
            "batcher_requests": len(got_reqs),
            "batcher_topk_equal_single": all(
                [p.index for p in g.predictions] == [p.index for p in w.predictions]
                for g, w in zip(got_reqs, want_reqs))}
    line["ok"] = bool(line["context_graph"] and line["context_topk_equal"]
                      and line["context_scaled_logit_diff"] <= MESH_CTX_TOL
                      and line["context_launches"] == {"filterbank_logpower": 4,
                                                       "stage_stack_forward": 4}
                      and line["batcher_topk_equal_single"]
                      and line["batcher_requests"] == MESH_BATCHER_REQUESTS)
    check(line)
    del conv_meshes, mesh22, single, ctx, ctx22, single_ctx

    # (6) Two CLI processes joined by --coordinator on the card.
    with tempfile.TemporaryDirectory() as tmp:
        line = {"phase": "mesh", "part": "multihost_cli", "card": card,
                **mesh_cli_check(paths["conv"], Path(tmp))}
    check(line)
    emit({"phase": "mesh_time", "card": card, "phase_s": time.perf_counter() - t_phase,
          "launches": total})
    if failed:
        raise AssertionError(f"mesh: {failed} failed")
    return total


# The activation_diff phase: utils/activation_diff on the full-width v2.4
# conv file, ACT_DIFF_ROWS seeded rows: fast against fp32 on the card (the
# worst ACT_DIFF_WORST nodes printed), and the card against the host at
# fp32, every node within ACT_DIFF_TOL of its layer's scale.
ACT_DIFF_ROWS, ACT_DIFF_WORST, ACT_DIFF_TOL = 4, 10, 1e-4


def phase_activation_diff(card: str, path: str) -> None:
    from birdnet_tpu_torch.checkpoint import import_any
    from birdnet_tpu_torch.utils.activation_diff import (
        capture_activations,
        layer_diffs,
        top_k_agreement,
    )

    t0 = time.perf_counter()
    imported = import_any(path)
    node_of = {o: n.op_type for n in imported.graph.node for o in n.output}
    x = (np.random.default_rng(SEED + 107).normal(size=(ACT_DIFF_ROWS, S)) * 0.2
         ).astype(np.float32)
    fp32 = capture_activations(imported, "fp32", x)
    fast = capture_activations(imported, "fast", x)
    host = capture_activations(imported, "fp32", x, "cpu")
    fast_rows = layer_diffs(fp32, fast, node_of)
    host_rows = layer_diffs(host, fp32, node_of)
    logits = imported.output_names[-1]
    line = {"phase": "activation_diff", "card": card, "nodes": len(fp32),
            "same_names": set(fp32) == set(fast) == set(host),
            "all_finite": all(np.isfinite(v).all() for v in fp32.values()),
            "fast_vs_fp32_worst": [(rel, absd, name, op)
                                   for rel, absd, name, op in fast_rows[:ACT_DIFF_WORST]],
            "fast_vs_fp32_top1_top5": top_k_agreement(fp32[logits], fast[logits]),
            "card_vs_host_fp32_worst": [(rel, absd, name, op)
                                        for rel, absd, name, op in host_rows[:ACT_DIFF_WORST]],
            "card_vs_host_fp32_compared": len(host_rows),
            "seconds": time.perf_counter() - t0}
    line["ok"] = bool(line["same_names"] and line["all_finite"]
                      and len(host_rows) == len(fp32) and host_rows[0][0] <= ACT_DIFF_TOL)
    emit(line)
    if not line["ok"]:
        raise AssertionError(f"activation_diff: {line}")


# The hunt phase: scripts/torch_graph_hunt.py's thirteen kinds, the first
# HUNT_SEEDS valid samples of each from its seed base (a sample the grammar
# draws shape-invalid, or that the exporter refuses, is skipped before the
# port runs it, and counted); HUNT_MAX_DRAWS bounds the draws per kind.
HUNT_SEEDS, HUNT_MAX_DRAWS = 2, 10


# The tools phase: torch_serve_bench's sweep on the conv file at fast (each
# row a fresh batcher, a warm-up of at most 1 s, then TOOLS_SERVE_SECONDS),
# torch_bench_onnx on the torch-exported v2.4 and the CRNN at fast
# (TOOLS_ONNX_RUNS timed runs per batch, eager and graph), torch_topk_bench
# at its defaults.
TOOLS_SERVE = {"batches": [32], "waits": [0.0, 5.0], "workers": [1, 2],
               "clients": [4, 64], "seconds": 2.0}
TOOLS_ONNX_BATCHES, TOOLS_ONNX_RUNS = (1, 32), 5


def tools_onnx_rows(card: str, bench_onnx, name: str, path: str) -> None:
    """torch_bench_onnx's rows of one file, each checked: both forms ran,
    every output finite, the graph's outputs within FLOAT_NODE_TOL["fast"]
    of the eager forward's scale."""
    bench = bench_onnx.Bench(path, "fast", CARD)
    for rec, eager, graph in bench_onnx.sweep(bench, TOOLS_ONNX_BATCHES, TOOLS_ONNX_RUNS):
        if graph is None:
            raise AssertionError(f"tools: {name} batch {rec['batch']}: no graph ({rec})")
        finite = all(bool(torch.isfinite(o.float()).all()) for o in eager + graph)
        scaled = max(float((g.float() - e.float()).abs().max() / e.float().abs().max())
                     for e, g in zip(eager, graph))
        line = {"phase": "tools_onnx", "card": card, "model": name, "precision": "fast",
                **rec, "finite": finite, "graph_vs_eager_scaled": scaled}
        emit(line)
        if not finite or not scaled <= FLOAT_NODE_TOL["fast"]:
            raise AssertionError(f"tools: {line}")


def phase_tools(card: str, conv_path: str) -> None:
    """The tools phase (see the module docstring)."""
    sys.path.insert(0, str(REPO / "scripts"))
    import torch_bench_onnx as bench_onnx
    import torch_serve_bench as serve_bench
    import torch_topk_bench as topk_bench

    t0 = time.perf_counter()
    clf = serve_bench.build_classifier(conv_path, "fast", CARD)
    for row in serve_bench.sweep(clf, **TOOLS_SERVE):
        emit({"phase": "tools_serve", "card": card, "model": "v24_conv", **row})
        if row["client_errors"] or not 1 <= row["mean_fill"] <= row["max_batch"]:
            raise AssertionError(f"tools: serve row {row}")
    del clf
    t_serve = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        tools_onnx_rows(card, bench_onnx, "torch_v24", torch_v24_file(tmp)[0])
        tools_onnx_rows(card, bench_onnx, "crnn_v24", crnn_file(tmp)[0])
    torch.cuda.empty_cache()
    t_onnx = time.perf_counter() - t0 - t_serve
    emit({"phase": "tools_topk", "card": card, **topk_bench.run(CARD)})
    emit({"phase": "tools_seconds", "card": card, "serve_s": t_serve, "onnx_s": t_onnx,
          "seconds": time.perf_counter() - t0})


def phase_hunt(card: str) -> None:
    sys.path.insert(0, str(REPO / "tests"))
    sys.path.insert(0, str(REPO / "scripts"))
    import torch_graph_hunt as hunt

    t0 = time.perf_counter()
    tally, ran = {}, {}
    for kind in hunt.KINDS:
        ran[kind] = []
        for seed in range(hunt.SEED_BASE, hunt.SEED_BASE + HUNT_MAX_DRAWS):
            res = hunt.run_one(kind, seed, device=CARD)
            tally[res] = tally.get(res, 0) + 1
            if res in hunt.FAILURES:
                raise AssertionError(f"hunt: kind {kind} seed {seed}: {res}")
            if res == "ok":
                ran[kind].append(seed)
                if len(ran[kind]) == HUNT_SEEDS:
                    break
        if len(ran[kind]) < HUNT_SEEDS:
            raise AssertionError(f"hunt: {kind} drew {ran[kind]} valid samples "
                                 f"in {HUNT_MAX_DRAWS} seeds")
    emit({"phase": "hunt", "card": card, "kinds": len(ran), "seeds": ran, "tally": tally,
          "atol": hunt.ATOL, "rtol": hunt.RTOL, "seconds": time.perf_counter() - t0})


# The stage_profile phase: scripts/torch_stage_profile.py's two tables on
# the full-width v2.4 conv file at fast, tile 128 (STAGE_REPS forwards per
# captured graph, median of STAGE_RUNS replays); the logits prefix (every
# node is the logits' ancestor, so the pruning keeps the whole graph) against
# the imported model's forward on the same tile, within FLOAT_NODE_TOL["fast"]
# of the logits' scale.
STAGE_TILE, STAGE_REPS, STAGE_RUNS = 128, 16, 3


def phase_stage_profile(card: str) -> None:
    sys.path.insert(0, str(REPO / "scripts"))
    import torch_stage_profile as sprof

    t0 = time.perf_counter()
    S, unfused, fused = sprof.imported_models("v24", device=CARD)
    x = torch.from_numpy((np.random.default_rng(SEED + 109).normal(size=(STAGE_TILE, S)) * 0.1)
                         .astype(np.float32)).to(CARD)
    results = sprof.profile_tables(unfused, fused, x, "fast", STAGE_REPS, STAGE_RUNS)
    if [r["table"] for r in results] != ["unfused", "default_fusions"]:
        raise AssertionError(f"stage_profile: tables {[r['table'] for r in results]}")
    for result, imported in zip(results, (unfused, fused)):
        params = params_to_torch(imported.params, CARD)
        logits = imported.output_names[0]
        got = sprof.prefix_forward(imported, logits, "fast", params, CARD)(x).float()
        want = make_forward(imported, "fast", CARD)(params, x)[0].float()
        scaled = float((got - want).abs().max() / want.abs().max())
        cumulative = np.cumsum([r["us_per_tile"] for r in result["stages"]])
        line = {"phase": "stage_profile", "card": card, "model": "v24", "frontend": "conv",
                "precision": "fast", "tile": STAGE_TILE, "reps": STAGE_REPS,
                "runs": STAGE_RUNS, **result, "logits_prefix_scaled_diff": scaled}
        line["ok"] = bool(np.isfinite(cumulative).all() and (cumulative > 0).all()
                          and scaled <= FLOAT_NODE_TOL["fast"])
        emit(line)
        if not line["ok"]:
            raise AssertionError(f"stage_profile: {line}")
    emit({"phase": "stage_profile_seconds", "card": card, "seconds": time.perf_counter() - t0})


# The gelu phase: aves_embed_1h's tile (128 segments of 80,000 samples).
# (form, x's shape, stores bf16, launches a tile); the positional conv's x is
# a slice of 250 frames to 249, as the graph's Slice leaves it.
GELU_CASES = [("bias", (128, 249, 4096), True, 24), ("bias", (128, 249, 4096), False, 0),
              ("bare", (128, 1024, 250), False, 1)] + [
    ("channel_ln", (128, 512, t), t != 249, 1)
    for t in (15999, 7999, 3999, 1999, 999, 499, 249)]
# channel_ln against its plain version: the statistics sum in another order
# than ATen's reductions, so a bf16 rounding of a frame's mean or variance
# may flip and move the frame by about one bf16 ulp of its largest values
# (two after the roundings that follow): frames that differ at all at most
# this share, no element off by more than this share of the largest
# magnitude (tests/test_torch_fuse_gelu.py holds the same).
GELU_LN_FRAME_SHARE, GELU_LN_REL = 1e-3, 2 ** -5
# The chain's float32 operations an element (the kernels line's bound_by):
# the bias Add or none, then / sqrt 2, erf, + 1 and two Muls; the channel
# LayerNorm's sums, difference, scaling and affine before them.
GELU_OPS = {"bias": 6, "bare": 5, "channel_ln": 13}
AVES_HOUR = 3600 * 16_000


def phase_gelu(card: str) -> dict:
    """The gelu phase (see the module's docstring). Returns the kernels
    line's summaries of bias_gelu and channel_ln_gelu, summed over an
    AVES tile's launches, with the launches counted in the second hour."""
    t0 = time.perf_counter()
    g = torch.Generator(device=CARD).manual_seed(SEED)
    c = float(np.float32(math.sqrt(2.0)))
    summary = {name: {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                      "bound_by": "bytes", "library_ms": None, "library": None}
               for name in ("bias_gelu", "channel_ln_gelu")}
    for form, shape, bf16_out, per_tile in GELU_CASES:
        x = torch.randn(shape, device=CARD, generator=g)
        if form == "channel_ln":
            x = x + 0.5 * torch.randn(shape[0], 1, shape[2], device=CARD, generator=g)
        x = x.to(torch.bfloat16)
        if form == "bare":
            x = x[..., :-1]
        out = torch.bfloat16 if bf16_out else torch.float32
        if form == "channel_ln":
            name = "channel_ln_gelu"
            vecs = (1.0 + 0.1 * torch.randn(shape[1], device=CARD, generator=g),
                    0.1 * torch.randn(shape[1], device=CARD, generator=g), 1e-5)
            args = (*vecs, c, True, False, out)
            kernel = lambda: gelu.channel_ln_gelu(x, *args)  # noqa: E731
            plain = lambda: gelu.channel_ln_gelu_plain(x, *args)  # noqa: E731
        else:
            name = "bias_gelu"
            bias = (0.02 * torch.randn(shape[-1], device=CARD, generator=g)
                    if form == "bias" else None)
            args = (bias, c, True, False, out)
            kernel = lambda: gelu.bias_gelu(x, *args)  # noqa: E731
            plain = lambda: gelu.bias_gelu_plain(x, *args)  # noqa: E731
        got, want = kernel(), plain()
        torch.cuda.synchronize()
        diff = (got.float() - want.float()).abs()
        err = float(diff.max())
        line = {"phase": "gelu", "card": card, "form": form, "shape": list(x.shape),
                "out": str(out).split(".")[1], "max_abs_err": err}
        if form == "channel_ln":
            share = float((diff.amax(dim=1) > 0).float().mean())
            line.update(frames_off_share=share, ok=bool(
                share <= GELU_LN_FRAME_SHARE
                and err <= GELU_LN_REL * float(want.float().abs().max())))
        else:
            line["ok"] = bool(torch.equal(got, want))
        del got, want, diff
        ms, plain_ms = kernel_vs_plain_ms(kernel, plain)
        n = x.numel()
        moved = n * (x.element_size() + out.itemsize)
        line.update(ms=ms, plain_ms=plain_ms, **bound(moved, {"fp32": GELU_OPS[form] * n}))
        line["share_of_bound"] = line["bound_ms"] / ms
        emit(line)
        if not line["ok"]:
            raise AssertionError(f"gelu: {line}")
        total = summary[name]
        total["max_abs_err"] = max(total["max_abs_err"], err)
        for key in ("ms", "plain_ms", "bound_ms"):
            total[key] += per_tile * line[key]
        del x
        torch.cuda.empty_cache()
    for total in summary.values():
        total["share_of_bound"] = total["bound_ms"] / total["ms"]

    rng = np.random.default_rng(SEED + 26)
    pcm = (rng.normal(size=AVES_HOUR) * 3000).clip(-32768, 32767).astype(np.int16)
    cfg = json.loads((REPO / "benchmark" / "configs" / "aves_hubert_large_fast.json")
                     .read_text())
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "aves_hubert_large.onnx")
        aves_hubert.save(path, seed=SEED)

        def classifier():
            return (Classifier.builder().model_path(path)
                    .labels([f"s{i}" for i in range(aves_hubert.NUM_SPECIES)])
                    .precision("fast").build())

        clf = classifier()
        clf.embed_samples(pcm)
        graphs = [sorted(key for launches, key in tally if launches is gelu.LAUNCHES)
                  for program in clf._streaming_engine().programs.values()
                  for tally in program.launches]
        gelu.reset_launches()
        emb, _ = clf.embed_samples(pcm)
        torch.cuda.synchronize()
        launches = dict(gelu.LAUNCHES)
        del clf
        torch.cuda.empty_cache()
        real = fuse_gelu.fuse_gelu
        fuse_gelu.fuse_gelu = lambda graph, tensors: (0, 0)
        try:
            unfused = classifier()
        finally:
            fuse_gelu.fuse_gelu = real
        want, _ = unfused.embed_samples(pcm)
        del unfused
        torch.cuda.empty_cache()
    got, want = np.asarray(emb, np.float64), np.asarray(want, np.float64)
    rows = np.abs(got - want).max(axis=1) / np.abs(want).max(axis=1)
    tiles = launches["bare"]
    line = {"phase": "gelu_aves", "card": card, "segments": int(got.shape[0]),
            "graph_launches": graphs, "launches": launches,
            "emb_err_max": float(rows.max()), "emb_err_limit": cfg["row_limits"]["emb_err"],
            "seconds": time.perf_counter() - t0}
    line["ok"] = bool(
        graphs and all(f == ["bare"] + ["bias"] * 24 + ["channel_ln"] * 7 for f in graphs)
        and tiles > 0 and launches == {"bias": 24 * tiles, "bare": tiles, "channel_ln": 7 * tiles}
        and got.shape == want.shape and line["emb_err_max"] <= line["emb_err_limit"])
    emit(line)
    if not line["ok"]:
        raise AssertionError(f"gelu_aves: {line}")
    summary["bias_gelu"]["launches"] = launches["bias"] + launches["bare"]
    summary["channel_ln_gelu"]["launches"] = launches["channel_ln"]
    return summary


def kernels_line(summary: dict, launches: dict) -> dict:
    """The kernels' summary line: each kernel of ``summary`` with its
    launches on the driven paths (``launches``)."""
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
    return {"kernels": kernels}


def main_gelu() -> int:
    """``--gelu``: the device, build and gelu phases and their kernels line."""
    name, smi = phase_device()
    phase_build()
    summary = phase_gelu(smi)
    emit(kernels_line(summary, {k: s["launches"] for k, s in summary.items()}))
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


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
    if sys.argv[1:] == ["--gelu"]:
        return main_gelu()
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
        path_launches = [
            float_launches, phase_stream(smi, float_fast, paths),
            phase_int8(smi, segs, paths, tiny_paths, ref_logits_of, float_fast)]
        del float_fast
        path_launches.append(phase_families(smi))
        phase_rangefilter(smi)
        phase_checkpoint(smi, paths["conv"], segs)
        path_launches.append(phase_dtypes(smi, segs))
        path_launches.append(phase_concurrency(smi, paths["conv"]))
        path_launches.append(phase_batch_context(smi, paths["conv"], segs))
        path_launches.append(phase_serve(smi, paths["conv"]))
        phase_cli(smi, paths["conv"])
        exported_launches, v24_rates = phase_exported(smi, paths["conv"])
        path_launches.append(exported_launches)
        path_launches.append(phase_control_flow(smi, v24_rates))
        path_launches.append(phase_op_sets(smi))
        path_launches.append(phase_contrib(smi, paths))
        path_launches.append(phase_mesh(smi, paths, segs))
        phase_activation_diff(smi, paths["conv"])
        phase_tools(smi, paths["conv"])
    phase_hunt(smi)
    phase_stage_profile(smi)
    gelu_summary = phase_gelu(smi)
    # Each kernel's launches summed over its paths; B5's from its kernel
    # phase.
    launches = {k: sum(run[k] for run in path_launches) for k in path_launches[0]}
    launches["frame_filterbank_logpower"] = b5_launches
    launches["qconv1x1_requant_forward"] = launches["qconv1x1_requant"]
    for kname, s in gelu_summary.items():
        summary[kname] = s
        launches[kname] = s["launches"]
    emit(kernels_line(summary, launches))
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
