"""The port's CUDA kernels on the card: each kernel against its plain
PyTorch version at the main path's geometry, and the classifier's ``fast``,
int8 and streaming paths through them. Marked ``cuda``; every test skips where
``torch.cuda.is_available()`` is false. On a machine with a card:

    python -m pytest tests/test_torch_cuda.py -q --noconftest

(``--noconftest``: tests/conftest.py imports jax, which the port's
machine need not have.)
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_contrib_cases as contrib  # noqa: E402
from _torch_core_cases import BITWISE as CORE_BITWISE  # noqa: E402
from _torch_core_cases import CASES as CORE_CASES  # noqa: E402
from _torch_core_cases import model_bytes as core_model_bytes  # noqa: E402
from _torch_flow_cases import CASES as FLOW_CASES  # noqa: E402
from _torch_flow_cases import TOL as FLOW_TOL  # noqa: E402
from _torch_flow_cases import WHILE, WHILE_STEPS, merged_decoder_bytes  # noqa: E402
from _torch_flow_cases import model_bytes as flow_model_bytes  # noqa: E402
from _torch_opset_cases import CASES as OPSET_CASES  # noqa: E402
from _torch_opset_cases import HEADS as ML_HEADS  # noqa: E402
from _torch_opset_cases import HOST_SLICED as OPSET_HOST_SLICED  # noqa: E402
from _torch_opset_cases import RANDOM as OPSET_RANDOM  # noqa: E402
from _torch_opset_cases import TOL as OPSET_TOL  # noqa: E402
from _torch_opset_cases import inputs_of as opset_inputs  # noqa: E402
from _torch_opset_cases import ml_heads  # noqa: E402
from _torch_opset_cases import model_bytes as opset_model_bytes  # noqa: E402
from _v24_qconv_shapes import v24_qconv_shapes  # noqa: E402
from birdnet_tpu_torch.compiler._melbank import mel_weight_matrix  # noqa: E402
from birdnet_tpu_torch.ops.cuda import frontend as fe  # noqa: E402
from birdnet_tpu_torch.ops.cuda import qconv as qc  # noqa: E402
from birdnet_tpu_torch.ops.cuda import stage_prefix as sp  # noqa: E402

pytestmark = pytest.mark.cuda

S, HOP, FLEN, M = 144_000, 280, 1024, 96


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    fe.reset_launches()
    qc.reset_launches()
    sp.reset_launches()
    return torch.device("cuda", 0)


def _segments(n, dev, dtype, samples=S):
    rng = np.random.default_rng(0)
    x = torch.from_numpy((rng.normal(size=(n, samples)) * 0.1).astype(np.float32))
    return x.to(dev).to(dtype)


def _close(got, want, dtype):
    """float32: 1e-3 rel/abs. bf16: |Δ| <= 2^-6 |plain| + 1e-2 (about two
    bf16 ulps: the kernel sums in another order than the plain matmul)."""
    got, want = got.float(), want.float()
    if dtype == torch.float32:
        return bool(torch.all((got - want).abs() <= 1e-3 + 1e-3 * want.abs()))
    return bool(torch.all((got - want).abs() <= 2 ** -6 * want.abs() + 1e-2))


# (S, hop, M, N) of the frontend kernels, reaching each load path of the
# bf16 tensor-core kernels: v2.4 (ldmatrix A rows, conflict free); hop 312
# with one segment; hop 320 (ldmatrix rows on one bank) with 128 mels or
# filters on 160000 samples (497 frames, not a multiple of the 128-frame
# tile); an odd hop on an odd length (16-bit loads; segment n starts at
# element n * 6007, not 16-byte aligned); hop 700 (16-bit loads: its rows
# start 8-byte aligned), where B1's span of 128 frames does not fit, so its
# CTA takes one warpgroup of 64 frames.
FRONTEND_GEOMETRIES = [
    pytest.param(S, HOP, M, 4, id="v24"),
    pytest.param(S, 312, M, 1, id="hop312-n1"),
    pytest.param(160_000, 320, 128, 2, id="hop320-m128-s160000"),
    pytest.param(160_000, 312, 96, 2, id="hop312-s160000"),
    pytest.param(6007, 277, 96, 3, id="hop277-s6007"),
    pytest.param(S, 700, M, 2, id="hop700-one-warpgroup"),
]


@pytest.mark.parametrize("S_,hop,m,n", FRONTEND_GEOMETRIES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_stft_melspec_kernel_matches_plain(dev, dtype, S_, hop, m, n):
    win = (0.5 - 0.5 * np.cos(2 * np.pi * np.arange(FLEN) / FLEN)).astype(np.float32)
    mel = mel_weight_matrix(m, FLEN, 48_000, 150.0, 15_000.0).astype(np.float32)
    x = _segments(n, dev, dtype, S_)
    got = fe.segments_stft_melspec(x, win, mel, hop=hop)
    torch.cuda.synchronize()
    assert fe.LAUNCHES["stft_melspec"] == 1
    want = fe.stft_melspec_plain(x, win, mel, hop=hop)
    assert got.shape == want.shape == (n, m, (S_ - FLEN) // hop + 1) and got.dtype == dtype
    assert _close(got, want, dtype)
    if dtype == torch.float32:
        oracle = fe.stft_melspec_reference(x[:2].cpu().numpy(), win, mel, hop=hop)
        assert _close(got[:2].cpu(), torch.from_numpy(oracle), dtype)


@pytest.mark.parametrize("S_,hop,m,n", FRONTEND_GEOMETRIES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_filterbank_logpower_kernel_matches_plain(dev, dtype, S_, hop, m, n):
    rng = np.random.default_rng(1)
    w = torch.from_numpy((rng.normal(size=(m, 1, FLEN)) * 0.02).astype(np.float32)).to(dev)
    x = _segments(n, dev, dtype, S_)
    got = fe.segments_filterbank_logpower(x, w, hop=hop)
    torch.cuda.synchronize()
    assert fe.LAUNCHES["filterbank_logpower"] == 1
    want = fe.filterbank_logpower_plain(x, w, hop=hop)
    assert got.shape == want.shape == (n, m, (S_ - FLEN) // hop + 1) and got.dtype == dtype
    assert _close(got, want, dtype)
    if dtype == torch.float32:
        oracle = fe.filterbank_logpower_reference(
            x[:2].cpu().numpy(), w.cpu().numpy(), hop=hop
        )
        assert _close(got[:2].cpu(), torch.from_numpy(oracle), dtype)


@pytest.mark.parametrize("scale", [1 / 32768, 1 / 3000])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_frontend_kernels_scale_matches_plain(dev, dtype, scale):
    """B1 and B2 with scale != 1 on int16-range samples: the kernel scales
    the staged samples as the plain version scales the segments."""
    win = (0.5 - 0.5 * np.cos(2 * np.pi * np.arange(FLEN) / FLEN)).astype(np.float32)
    mel = mel_weight_matrix(M, FLEN, 48_000, 150.0, 15_000.0).astype(np.float32)
    w = torch.from_numpy((np.random.default_rng(1).normal(size=(M, 1, FLEN)) * 0.02)
                         .astype(np.float32)).to(dev)
    x = torch.from_numpy(np.round(np.random.default_rng(0).normal(size=(3, S)) * 3000)
                         .astype(np.float32)).to(dev).to(dtype)
    for kernel, plain in (
        (lambda v, **kw: fe.segments_stft_melspec(v, win, mel, hop=HOP, **kw),
         lambda v, **kw: fe.stft_melspec_plain(v, win, mel, hop=HOP, **kw)),
        (lambda v, **kw: fe.segments_filterbank_logpower(v, w, hop=HOP, **kw),
         lambda v, **kw: fe.filterbank_logpower_plain(v, w, hop=HOP, **kw)),
    ):
        got = kernel(x, scale=scale)
        torch.cuda.synchronize()
        assert _close(got, plain(x, scale=scale), dtype)
        assert not _close(got, plain(x), dtype)
    assert fe.LAUNCHES["stft_melspec"] == fe.LAUNCHES["filterbank_logpower"] == 1


@pytest.mark.parametrize("stft,limit", [(True, 1209), (False, 1437)])
def test_bf16_kernels_refuse_a_span_too_large(dev, stft, limit):
    """Where the bf16 kernels' hop limit lies at 1024 taps and 96 mels or
    filters (the samples of 64 frames beside the B ring in 227 KB of shared
    memory): at the limit the kernel runs and agrees with its plain version,
    one sample above it the wrapper raises and launches nothing."""
    assert fe.bf16_max_hop(FLEN, M, stft=stft) == limit
    win = np.hanning(FLEN).astype(np.float32)
    mel = mel_weight_matrix(M, FLEN, 48_000, 150.0, 15_000.0).astype(np.float32)
    w = torch.from_numpy((np.random.default_rng(2).normal(size=(M, 1, FLEN)) * 0.02)
                         .astype(np.float32)).to(dev)
    x = _segments(2, dev, torch.bfloat16)
    if stft:
        run = lambda hop: fe.segments_stft_melspec(x, win, mel, hop=hop)
        plain = lambda hop: fe.stft_melspec_plain(x, win, mel, hop=hop)
        counter = "stft_melspec"
    else:
        run = lambda hop: fe.segments_filterbank_logpower(x, w, hop=hop)
        plain = lambda hop: fe.filterbank_logpower_plain(x, w, hop=hop)
        counter = "filterbank_logpower"
    assert _close(run(limit), plain(limit), torch.bfloat16)
    assert fe.LAUNCHES[counter] == 1
    with pytest.raises(ValueError, match=f"hop {limit + 1}.*up to {limit}"):
        run(limit + 1)
    assert fe.LAUNCHES[counter] == 1


@pytest.mark.parametrize("frontend,hop", [("conv", 1500), ("stft", 1300)])
def test_classifier_refuses_a_hop_too_large_at_build(dev, tmp_path, frontend, hop):
    """A fast Classifier whose frontend hop is above the bf16 kernel's limit
    fails in build() (its validation forward), naming the hop, and not at
    its first predict; at fp32, which interprets the frontend's body, the
    same file builds."""
    from birdnet_tpu_torch import Classifier
    from birdnet_tpu_torch.errors import ModelLoadError
    from birdnet_tpu_torch.models._builder import (
        GraphBuilder, learned_frontend, stft_mel_frontend)
    from birdnet_tpu_torch.onnx import proto as P

    gb = GraphBuilder("hop_limit", seed=0)
    if frontend == "conv":
        img, _ = learned_frontend(gb, "input", S, n_filters=M, stride=hop)
    else:
        img, _ = stft_mel_frontend(gb, "input", S, sample_rate=48_000, hop=hop, n_mels=M)
    gb.gemm(gb.gap(img), 1, 10, name="output")
    path = tmp_path / f"hop{hop}_{frontend}.onnx"
    P.save_model(gb.build(
        inputs=[P.make_value_info("input", P.DataType.FLOAT, ["batch", S])],
        outputs=[P.make_value_info("output", P.DataType.FLOAT, ["batch", 10])]), str(path))
    builder = lambda: Classifier.builder().model_path(path).labels([f"s{i}" for i in range(10)])
    with pytest.raises(ModelLoadError, match=f"hop {hop}"):
        builder().precision("fast").build()
    assert builder().precision("fp32").build().device == dev


@pytest.mark.parametrize("op_type,x_shape,w_shape,attrs", [
    ("Conv", (2, 1, 9000), (24, 1, 1024), dict(kernel_shape=[1024], strides=[280], pads=[0, 0])),
    ("Conv", (2, 8, 12, 20), (16, 8, 1, 1), dict(kernel_shape=[1, 1], pads=[0, 0, 0, 0])),
    ("Conv", (2, 16, 12, 21), (16, 1, 3, 3),
     dict(kernel_shape=[3, 3], strides=[2, 2], pads=[1, 1, 1, 1], group=16)),
    ("Gemm", (4, 64), (30, 64), dict(transB=1)),
    ("MatMul", (2, 7, 33), (33, 12), {}),
])
def test_mixed_ops_on_the_card_match_the_cpu(dev, op_type, x_shape, w_shape, attrs):
    """mixed on the card (cuDNN convs on bf16-rounded operands with TF32
    off; torch.mm/bmm with out_dtype=float32 for matmuls) against the same
    lowering on the CPU: float32 out, within 1e-4 of the largest magnitude
    (sum order)."""
    from birdnet_tpu_torch.compiler import ops as tops

    rng = np.random.default_rng(0)
    x = torch.from_numpy((rng.normal(size=x_shape) * 0.5).astype(np.float32))
    w = torch.from_numpy((rng.normal(size=w_shape) * 0.1).astype(np.float32))
    outs = []
    for device in (dev, torch.device("cpu")):
        ctx = tops.OpContext(op_type, attrs, precision="mixed", device=device)
        outs.append(tops.get_lowering(op_type)(ctx, x.to(device), w.to(device))[0].cpu())
    got, want = outs
    assert got.dtype == want.dtype == torch.float32 and got.shape == want.shape
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())


@pytest.mark.parametrize("frontend,counter", [
    ("conv", "filterbank_logpower"), ("stft", "stft_melspec"),
])
def test_classifier_fast_runs_the_kernel(dev, tmp_path, frontend, counter):
    from birdnet_tpu_torch import Classifier
    from birdnet_tpu_torch.models import birdnet_v24
    from birdnet_tpu_torch.onnx import proto as P

    path = tmp_path / f"v24_{frontend}.onnx"
    P.save_model(birdnet_v24.build_model(num_species=10, width=0.1, depth=1,
                                         frontend=frontend), str(path))
    labels = [f"s{i}" for i in range(10)]
    clf = (Classifier.builder().model_path(path).labels(labels)
           .precision("fast").top_k(3).build())
    assert clf.device == dev
    fe.reset_launches()
    x = _segments(3, "cpu", torch.float32).numpy()
    results = clf.predict_batch(x)
    assert fe.LAUNCHES[counter] == 1
    ref = (Classifier.builder().model_path(path).labels(labels)
           .precision("fp32").top_k(3).build()).predict_batch(x)
    for r, q in zip(results, ref):
        assert np.all(np.isfinite(r.raw_scores))
        scale = np.abs(q.raw_scores).max()
        assert np.abs(r.raw_scores - q.raw_scores).max() / scale < 1e-1


QCONV_CASES = [(*shape, False) for shape in v24_qconv_shapes()] + [(8, 16, 48 * 256, "", True)]


@pytest.mark.parametrize("c_in,c_out,n,act,hostile", QCONV_CASES,
                         ids=[f"{i}-{a}to{b}-n{n}{'-hostile' if h else ''}"
                              for i, (a, b, n, _, h) in enumerate(QCONV_CASES)])
def test_qconv1x1_requant_kernel_matches_plain(dev, c_in, c_out, n, act, hostile):
    """B3 at each of the 49 1x1 convs of the full-width int8 v2.4 forward,
    batch 32: the plain version's codes (with sigmoid or silu at most 1
    code apart on at most 1e-4 of them). The hostile case's output scale
    0.3 has an inexact float32 reciprocal, and a multiply by it would flip
    codes that the kernel's division keeps."""
    rng = np.random.default_rng(c_in * 7 + c_out)
    if hostile:
        x = rng.integers(-10, 11, (32, c_in, n))
        w = rng.integers(-3, 4, (c_out, c_in))
        b = rng.integers(-20, 21, c_out)
        scale, y_scale = np.full(c_out, 0.15, np.float32), 0.3
    else:
        x = rng.integers(-127, 128, (32, c_in, n))
        w = rng.integers(-127, 128, (c_out, c_in))
        b = rng.integers(-5000, 5001, c_out)
        scale = (rng.uniform(0.5, 1.5, c_out) / (np.sqrt(c_in) * 5418.0)).astype(np.float32)
        y_scale = 3.0 / 127.0
    x, w, b, scale = (torch.from_numpy(np.asarray(a).astype(dt)).to(dev) for a, dt in (
        (x, np.int8), (w, np.int8), (b, np.int32), (scale, np.float32)))
    got = qc.qconv1x1_requant(x, w, b, scale, y_scale, act)
    torch.cuda.synchronize()
    assert qc.LAUNCHES["qconv1x1_requant"] == 1
    want = qc.qconv1x1_requant_plain(x, w, b, scale, y_scale, act)
    assert got.shape == want.shape == (32, c_out, n) and got.dtype == torch.int8
    diff = (got.int() - want.int()).abs()
    if act in ("", "relu"):
        assert torch.equal(got, want)
    else:
        assert int(diff.max()) <= 1 and int((diff > 0).sum()) <= 1e-4 * diff.numel()
    if hostile:
        acc = torch.matmul(w.double(), x.double()).to(torch.int32) + b.reshape(1, -1, 1)
        recip = 1.0 / torch.full((1,), float(y_scale), device=dev)
        by_recip = torch.round(acc.float() * scale.reshape(1, -1, 1) * recip).clamp(-128, 127)
        assert int((by_recip.to(torch.int8) != want).sum()) > 0


@pytest.mark.parametrize("frontend,counter", [
    ("conv", "filterbank_logpower"), ("stft", "stft_melspec"),
])
@pytest.mark.parametrize("policy", ["fast", "mixed"])
def test_classifier_int8_runs_b3(dev, tmp_path, frontend, counter, policy):
    from birdnet_tpu_torch import Classifier
    from birdnet_tpu_torch.models import birdnet_v24
    from birdnet_tpu_torch.onnx import proto as P

    path = tmp_path / f"v24_{frontend}.onnx"
    P.save_model(birdnet_v24.build_model(num_species=10, width=0.1, depth=1,
                                         frontend=frontend), str(path))
    labels = [f"s{i}" for i in range(10)]
    clf = (Classifier.builder().model_path(path).labels(labels)
           .precision(policy).top_k(3).int8().build())
    assert clf.device == dev
    fe.reset_launches()
    qc.reset_launches()
    results = clf.predict_batch(_segments(3, "cpu", torch.float32).numpy())
    assert qc.LAUNCHES["qconv1x1_requant"] > 0
    assert fe.LAUNCHES[counter] == (1 if policy == "fast" else 0)
    for r in results:
        assert r.raw_scores.shape == (10,) and np.all(np.isfinite(r.raw_scores))


# The full-width v2.4 stage prefix: (c_in, c_mid, c_se, c_out, stride, residual).
FULL_BLOCKS = [
    (32, 32, 8, 24, 1, False), (24, 24, 6, 24, 1, True), (24, 96, 24, 40, 2, False),
    (40, 160, 40, 40, 1, True), (40, 160, 40, 80, 2, False), (80, 320, 80, 80, 1, True),
]
# tests/test_torch_stage_prefix.py's reduced-width schedule: channel counts
# that are no multiple of 16 (24 expanded, 24 out), so the MMAs' K and N
# padding carries real zeros.
SMALL_BLOCKS = [
    (32, 32, 8, 16, 1, False), (16, 16, 8, 16, 1, True), (16, 24, 8, 16, 2, False),
    (16, 24, 8, 16, 1, True), (16, 24, 8, 24, 2, False), (24, 32, 8, 24, 1, True),
]


def _prefix_tables(dev, dtype, blocks=FULL_BLOCKS):
    rng = np.random.default_rng(3)
    f = lambda *shape, s=1.0: (rng.normal(size=shape) * s).astype(np.float32)
    bws = [dict(w1=f(m, i, s=1.5 / np.sqrt(i)), b1=f(m, s=0.05), wd=f(m, 1, 3, 3, s=0.3),
                bd=f(m, s=0.05), se1=f(e, m, s=1 / np.sqrt(m)), bse1=f(e, s=0.05),
                se2=f(m, e, s=1 / np.sqrt(e)), bse2=f(m, s=0.05), w3=f(o, m, s=1 / np.sqrt(m)),
                b3=f(o, s=0.05))
           for i, m, e, o, _, _ in blocks]
    return sp.prepare_weights(f(blocks[0][0], 1, 3, 3, s=0.4), f(blocks[0][0], s=0.05), bws,
                              [sp.BlockGeom(*g) for g in blocks], dtype, dev)


@pytest.mark.parametrize("dtype,fast_act", [
    (torch.bfloat16, True), (torch.bfloat16, False), (torch.float32, False),
])
def test_stage_stack_forward_kernel_matches_plain(dev, dtype, fast_act):
    """B4 at the full-width six-block prefix: float32 within 1e-5 of the
    largest magnitude (sum order), bf16 within 2^-6 of it (a bf16 rounding
    flipped by sum order, carried through six blocks); chip_smoke.py's
    bounds, which its measurement allowed."""
    tables = _prefix_tables(dev, dtype)
    img = torch.from_numpy((np.random.default_rng(4).normal(size=(4, 1, 96, 511)) * 0.5)
                           .astype(np.float32)).to(dev).to(dtype)
    got = sp.stage_stack_forward(img, tables, fast_act)
    torch.cuda.synchronize()
    assert sp.LAUNCHES["stage_stack_forward"] == 1
    want = sp.stage_stack_forward_plain(img, tables, fast_act)
    assert got.shape == want.shape == (4, 80, 12, 64) and got.dtype == dtype
    scaled = float((got.float() - want.float()).abs().max() / want.float().abs().max())
    assert scaled <= (1e-5 if dtype == torch.float32 else 2 ** -6)


@pytest.mark.parametrize("fast_act", [True, False])
@pytest.mark.parametrize("schedule", ["full", "small"])
@pytest.mark.parametrize("n,width", [(1, 511), (3, 512), (32, 511), (32, 512)])
def test_stage_stack_forward_bf16_kernel_shapes(dev, n, width, schedule, fast_act):
    """B4's tensor-core kernels against the plain version at batch 1, 3 and
    32, image widths 511 and 512, full width and the reduced schedule: the
    bf16 bound above; prints the share of output codes that differ."""
    blocks = FULL_BLOCKS if schedule == "full" else SMALL_BLOCKS
    tables = _prefix_tables(dev, torch.bfloat16, blocks)
    img = torch.from_numpy((np.random.default_rng(n).normal(size=(n, 1, 96, width)) * 0.5)
                           .astype(np.float32)).to(dev).to(torch.bfloat16)
    got = sp.stage_stack_forward(img, tables, fast_act)
    torch.cuda.synchronize()
    assert sp.LAUNCHES["stage_stack_forward"] == 1
    want = sp.stage_stack_forward_plain(img, tables, fast_act)
    assert got.shape == want.shape == (n, blocks[-1][3], 12, 64)
    scaled = float((got.float() - want.float()).abs().max() / want.float().abs().max())
    print(f"B4 bf16 n={n} W={width} {schedule} fast_act={fast_act}: scaled max |d| "
          f"{scaled:.3g}, {float((got != want).float().mean()):.4%} of output codes differ")
    assert bool(torch.isfinite(got).all()) and scaled <= 2 ** -6


# Channel counts that are no multiple of 8 and an image 500 wide (250, 125,
# 63 after the strides): 2-byte staging loads, no 16-byte h2 stores, the
# project's per-pixel epilogue at 12 x 63, K and N padded to 16.
ODD_BLOCKS = [
    (32, 36, 8, 20, 1, False), (20, 44, 6, 20, 1, True), (20, 52, 8, 28, 2, False),
    (28, 60, 10, 28, 2, False),
]


@pytest.mark.parametrize("fast_act", [True, False])
def test_stage_stack_forward_bf16_kernel_odd_shapes(dev, fast_act):
    """B4's tensor-core kernels off v2.4's widths (their fallback paths)
    against the plain version, within the bf16 bound above."""
    tables = _prefix_tables(dev, torch.bfloat16, ODD_BLOCKS)
    img = torch.from_numpy((np.random.default_rng(5).normal(size=(3, 1, 96, 500)) * 0.5)
                           .astype(np.float32)).to(dev).to(torch.bfloat16)
    got = sp.stage_stack_forward(img, tables, fast_act)
    torch.cuda.synchronize()
    want = sp.stage_stack_forward_plain(img, tables, fast_act)
    assert got.shape == want.shape == (3, 28, 12, 63)
    scaled = float((got.float() - want.float()).abs().max() / want.float().abs().max())
    print(f"B4 bf16 odd shapes fast_act={fast_act}: scaled max |d| {scaled:.3g}, "
          f"{float((got != want).float().mean()):.4%} of output codes differ")
    assert bool(torch.isfinite(got).all()) and scaled <= 2 ** -6


@pytest.mark.parametrize("audio_dtype", [torch.int16, torch.float32])
@pytest.mark.parametrize("step", [S, S // 2])
def test_frame_filterbank_logpower_kernel_matches_plain(dev, audio_dtype, step):
    rng = np.random.default_rng(5)
    n = 4
    x = rng.normal(size=(n - 1) * step + S) * 0.1
    audio = torch.from_numpy((x * 32768).astype(np.int16) if audio_dtype == torch.int16
                             else x.astype(np.float32)).to(dev)
    w = torch.from_numpy((rng.normal(size=(M, FLEN)) * 0.02).astype(np.float32)).to(dev)
    kw = dict(n_segments=n, step=step, sample_count=S, hop=HOP,
              scale=1 / 32768 if audio_dtype == torch.int16 else 1.0)
    got = fe.frame_filterbank_logpower(audio, w, **kw)
    torch.cuda.synchronize()
    assert fe.LAUNCHES["frame_filterbank_logpower"] == 1
    want = fe.frame_filterbank_logpower_plain(audio, w, **kw)
    assert got.shape == want.shape == (n, 511, M) and got.dtype == torch.float32
    assert _close(got, want, torch.float32)
    # Against the f64 oracle on two windows: the split-TF32 product keeps
    # f32 accuracy.
    scaled = audio.cpu().double() * kw["scale"]
    windows = torch.stack([scaled[i * step:i * step + S] for i in (0, n - 1)]).numpy()
    oracle = fe.filterbank_logpower_reference(windows, w.cpu().numpy(), hop=HOP)
    assert _close(got[[0, n - 1]].cpu(), torch.from_numpy(oracle).transpose(1, 2),
                  torch.float32)


@pytest.mark.parametrize("audio_dtype,limit", [(torch.int16, 4398), (torch.float32, 2165)])
def test_frame_filterbank_refuses_a_hop_too_large(dev, audio_dtype, limit):
    """B5's hop limit at 1024 taps and 96 filters (the samples of 16 frames
    beside the B ring in 227 KB of shared memory): at the limit the kernel
    runs and agrees with its plain version, one sample above it the wrapper
    raises and launches nothing."""
    assert fe.frame_max_hop(FLEN, M, audio_dtype) == limit
    rng = np.random.default_rng(6)
    x = rng.normal(size=2 * S) * 0.1
    audio = torch.from_numpy((x * 32768).astype(np.int16) if audio_dtype == torch.int16
                             else x.astype(np.float32)).to(dev)
    w = torch.from_numpy((rng.normal(size=(M, FLEN)) * 0.02).astype(np.float32)).to(dev)
    kw = dict(n_segments=2, step=S // 2, sample_count=S)
    got = fe.frame_filterbank_logpower(audio, w, hop=limit, **kw)
    assert _close(got, fe.frame_filterbank_logpower_plain(audio, w, hop=limit, **kw),
                  torch.float32)
    assert fe.LAUNCHES["frame_filterbank_logpower"] == 1
    with pytest.raises(ValueError, match=f"hop {limit + 1}.*up to {limit}"):
        fe.frame_filterbank_logpower(audio, w, hop=limit + 1, **kw)
    assert fe.LAUNCHES["frame_filterbank_logpower"] == 1


@pytest.mark.parametrize("frontend,counter", [
    ("conv", "filterbank_logpower"), ("stft", "stft_melspec"),
])
def test_classifier_streams_on_the_card(dev, tmp_path, frontend, counter):
    """One 30 s recording with 1.5 s overlap streamed at ``fast`` through
    the frontend kernel and B4: the same top-K as predict_batch on the same
    segments, confidences within 1e-3."""
    from birdnet_tpu_torch import Classifier, chunk_audio
    from birdnet_tpu_torch.models import birdnet_v24
    from birdnet_tpu_torch.onnx import proto as P

    path = tmp_path / f"v24_{frontend}.onnx"
    P.save_model(birdnet_v24.build_model(num_species=10, width=0.1, depth=1,
                                         frontend=frontend), str(path))
    clf = (Classifier.builder().model_path(path).labels([f"s{i}" for i in range(10)])
           .precision("fast").top_k(3).build())
    rng = np.random.default_rng(6)
    pcm = (rng.normal(size=30 * 48_000) * 3000).clip(-32768, 32767).astype(np.int16)
    fe.reset_launches()
    sp.reset_launches()
    stream = clf.analyze_samples(pcm, overlap_seconds=1.5)
    assert fe.LAUNCHES[counter] > 0 and sp.LAUNCHES["stage_stack_forward"] > 0
    segs, times = chunk_audio(pcm.astype(np.float32) / 32768.0, 144_000, 1.5, 48_000)
    # One tile, zero-padded as the stream pads it: the same batch shape.
    tile = clf._streaming_engine().tile
    batch = clf.predict_batch(np.concatenate(
        [segs, np.zeros((tile - len(segs), segs.shape[1]), np.float32)]))[:len(segs)]
    assert len(stream) == len(batch) == 20
    for (t, preds), t_ref, ref in zip(stream, times, batch):
        assert t == pytest.approx(t_ref)
        got = np.array([p.confidence for p in preds])
        want = np.array([p.confidence for p in ref.predictions])
        assert np.abs(got - want).max() <= 1e-3
        if want[0] - want[1] > 1e-3:
            assert preds[0].index == ref.predictions[0].index


@pytest.mark.parametrize("frontend,policy", [
    ("conv", "fast"), ("stft", "fast"), ("conv", "mixed"), ("conv", "fp32"),
])
def test_batch_context_graph_matches_eager_predict_batch(dev, tmp_path, frontend, policy):
    """The batch context's CUDA graph (captured at batch 8) against the
    eager predict_batch: equal logits and top-K on a full batch and on a
    short batch padded as the context pads it, top-K equal and logits within
    1e-2 of their scale against the short batch run eagerly at its own
    size; under fast the capture counts the frontend kernel and B4."""
    from birdnet_tpu_torch import Classifier
    from birdnet_tpu_torch.models import birdnet_v24
    from birdnet_tpu_torch.onnx import proto as P

    path = tmp_path / f"v24_{frontend}.onnx"
    P.save_model(birdnet_v24.build_model(num_species=10, width=0.1, depth=1,
                                         frontend=frontend), str(path))
    clf = (Classifier.builder().model_path(path).labels([f"s{i}" for i in range(10)])
           .precision(policy).top_k(3).build())
    fe.reset_launches()
    sp.reset_launches()
    ctx = clf.create_batch_context(8)
    assert ctx.graph is not None
    if policy == "fast":
        counter = "filterbank_logpower" if frontend == "conv" else "stft_melspec"
        assert fe.LAUNCHES[counter] > 0 and sp.LAUNCHES["stage_stack_forward"] > 0
    x = _segments(8, "cpu", torch.float32).numpy()
    padded = np.concatenate([x[:3], np.zeros((5, S), np.float32)])
    for got, want in ((clf.predict_batch_with_context(ctx, x), clf.predict_batch(x)),
                      (clf.predict_batch_with_context(ctx, x[:3]),
                       clf.predict_batch(padded)[:3])):
        assert len(got) == len(want)
        for r, q in zip(got, want):
            np.testing.assert_array_equal(r.raw_scores, q.raw_scores)
            assert [p.index for p in r.predictions] == [p.index for p in q.predictions]
    for r, q in zip(clf.predict_batch_with_context(ctx, x[:3]), clf.predict_batch(x[:3])):
        assert [p.index for p in r.predictions] == [p.index for p in q.predictions]
        scale = np.abs(q.raw_scores).max()
        assert np.abs(r.raw_scores - q.raw_scores).max() <= 1e-2 * scale
    # A per-request species mask goes through the graph's mask buffer.
    masks = np.zeros((3, 10), bool)
    masks[:, [2, 5]] = True
    for r in clf.predict_batch_with_context(ctx, x[:3], species_masks=masks):
        assert {p.index for p in r.predictions} <= {2, 5}
    for r, q in zip(clf.predict_batch_with_context(ctx, x), clf.predict_batch(x)):
        np.testing.assert_array_equal(r.raw_scores, q.raw_scores)


@pytest.mark.parametrize("family", ["v30", "perch"])
@pytest.mark.parametrize("frontend", ["conv", "stft"])
def test_family_classifier_on_the_card_matches_the_cpu(dev, tmp_path, family, frontend):
    """Tiny v3.0 and Perch v2 at fp32 on the card against the CPU (logits
    and embeddings within 1e-4 of their scale: float32 sums in another
    order, TF32 off), and at fast through the frontend kernel (within the
    fast bound of the fp32 logits)."""
    from birdnet_tpu_torch import Classifier
    from birdnet_tpu_torch.models import birdnet_v30, perch_v2
    from birdnet_tpu_torch.onnx import proto as P

    module = {"v30": birdnet_v30, "perch": perch_v2}[family]
    path = tmp_path / f"{family}_{frontend}.onnx"
    P.save_model(module.build_model(num_species=10, embedding_dim=32, width=0.1, depth=1,
                                    frontend=frontend), str(path))
    labels = [f"s{i}" for i in range(10)]
    build = lambda policy, device=None: (
        Classifier.builder().model_path(path).labels(labels).precision(policy).top_k(3)
        .with_device(device or "cuda").build())
    x = _segments(4, "cpu", torch.float32, samples=160_000).numpy()
    card, host = build("fp32").predict_batch(x), build("fp32", "cpu").predict_batch(x)
    for r, q in zip(card, host):
        for got, want in ((r.raw_scores, q.raw_scores), (r.embeddings, q.embeddings)):
            assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
    counter = "filterbank_logpower" if frontend == "conv" else "stft_melspec"
    fe.reset_launches()
    fast = build("fast").predict_batch(x)
    assert fe.LAUNCHES[counter] > 0
    for r, q in zip(fast, card):
        assert np.abs(r.raw_scores - q.raw_scores).max() < 1e-1 * np.abs(q.raw_scores).max()
        assert np.abs(r.embeddings - q.embeddings).max() < 1e-1 * np.abs(q.embeddings).max()


def test_server_on_the_card_matches_the_batch_context(dev, tmp_path):
    """A port server on cuda:0 (tiny v2.4 conv at fast, max_batch 8) takes
    32 concurrent /v1/predict calls; each answer's top-K equals the batch
    context's on the same segment (confidences within 1e-3: every batch
    replays the server's graph at batch 8, as the context's does)."""
    import threading

    from birdnet_tpu_torch import Classifier
    from birdnet_tpu_torch.models import birdnet_v24
    from birdnet_tpu_torch.onnx import proto as P
    from birdnet_tpu_torch.serve import ServeClient, make_server

    path = tmp_path / "v24_conv.onnx"
    P.save_model(birdnet_v24.build_model(num_species=10, width=0.1, depth=1), str(path))
    clf = (Classifier.builder().model_path(path).labels([f"s{i}" for i in range(10)])
           .precision("fast").top_k(3).build())
    segs = (_segments(32, "cpu", torch.float32).numpy() * 32768.0).clip(-32768, 32767)
    segs = segs.astype(np.int16)
    ctx = clf.create_batch_context(8)
    want = [r for i in range(0, 32, 8) for r in clf.predict_batch_with_context(
        ctx, segs[i:i + 8].astype(np.float32) / 32768.0)]
    srv = make_server(clf, host="127.0.0.1", port=0, max_batch=8, max_wait_ms=5)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        base = "http://%s:%d" % srv.server_address[:2]
        got = [None] * 32

        def hit(i):
            got[i] = ServeClient(base).predict(segs[i])

        threads = [threading.Thread(target=hit, args=(i,)) for i in range(32)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive()
        assert ServeClient(base).health()["device"] == "cuda:0"
        assert srv.state.batcher.metrics.snapshot()["errors_total"] == 0
    finally:
        srv.shutdown()
        srv.state.close()
        srv.server_close()
        thread.join(timeout=10)
    for preds, ref in zip(got, want):
        assert [p.index for p in preds] == [p.index for p in ref.predictions]
        np.testing.assert_allclose([p.confidence for p in preds],
                                   [p.confidence for p in ref.predictions], rtol=0, atol=1e-3)


# The ai.onnx core op table (tests/_torch_core_cases.py): every op on the
# card against the same graph on the host. fp32 with TF32 off: floats within
# 1e-5 of the output's scale; integers, shapes, TopK and the scatters equal.
# One forward runs under torch.cuda.set_sync_debug_mode("error") after a
# warm one (which uploads the host constants once): no lowering reads the
# card back inside the forward.


def _core_outputs(name, device, sync_debug=False):
    from birdnet_tpu_torch.compiler.importer import import_onnx, make_forward, params_to_torch

    model = import_onnx(core_model_bytes(name), optimize=False)
    fwd = make_forward(model, "fp32", device)
    params = params_to_torch(model.params, device)
    inputs = [torch.from_numpy(np.array(v)).to(device) for v in CORE_CASES[name][1].values()]
    outs = fwd(params, *inputs)
    if sync_debug:
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            outs = fwd(params, *inputs)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return [o.cpu() if isinstance(o, torch.Tensor) else torch.from_numpy(np.asarray(o))
            for o in outs]


@pytest.mark.parametrize("name", sorted(CORE_CASES))
def test_core_op_on_the_card_matches_the_cpu(dev, name):
    want = _core_outputs(name, "cpu")
    got = _core_outputs(name, dev, sync_debug=True)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, (g.shape, w.shape, g.dtype, w.dtype)
        if not w.is_floating_point() or name in CORE_BITWISE:
            assert torch.equal(g, w) or (w.is_floating_point() and torch.equal(
                torch.nan_to_num(g), torch.nan_to_num(w))), name
            continue
        g64, w64 = g.double(), w.double()
        assert torch.equal(torch.isnan(g64), torch.isnan(w64))
        fin = torch.isfinite(w64)
        scale = max(float(w64[fin].abs().max()) if fin.any() else 0.0, 1e-30)
        assert float((g64[fin] - w64[fin]).abs().max()) <= 1e-5 * scale, name


# Control flow, recurrences, Resize and attention at realistic shapes
# (tests/_torch_flow_cases.py): each graph on the card against the same
# graph on the host, fp32 with TF32 off, within 1e-5 of each output's
# scale. Every case but the while-form Loop runs a forward under
# torch.cuda.set_sync_debug_mode("error") after a warm one; the while form
# reads its condition on the host once per iteration, counted.


def _flow_outputs(name, device, sync_debug=False):
    from birdnet_tpu_torch.compiler.importer import import_onnx, make_forward, params_to_torch

    model = import_onnx(flow_model_bytes(name), optimize=False)
    fwd = make_forward(model, "fp32", device)
    params = params_to_torch(model.params, device)
    inputs = [torch.from_numpy(np.array(v)).to(device) for v in FLOW_CASES[name][1].values()]
    outs = fwd(params, *inputs)
    if sync_debug:
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            outs = fwd(params, *inputs)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return [o.cpu() for o in outs]


@pytest.mark.parametrize("name", sorted(FLOW_CASES))
def test_flow_op_on_the_card_matches_the_cpu(dev, name):
    from birdnet_tpu_torch.compiler import ops as tops

    want = _flow_outputs(name, "cpu")
    tops.HOST_READS["Loop"] = 0
    got = _flow_outputs(name, dev, sync_debug=name != WHILE)
    assert tops.HOST_READS["Loop"] == (WHILE_STEPS + 1 if name == WHILE else 0)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        scale = max(float(w.abs().max()), 1e-30)
        assert float((g.double() - w.double()).abs().max()) <= FLOW_TOL * scale, name


@pytest.mark.parametrize("flag", [True, False])
def test_merged_decoder_dispatch_on_the_card(dev, flag, tmp_path):
    """The merged decoder on the card: the flag as a host value (no sync
    in the forward) and as a card tensor (one read at the entry), the
    branch's answer; a .btck round trip keeps ``dispatch_inputs``."""
    from birdnet_tpu_torch.checkpoint import load_checkpoint, save_checkpoint
    from birdnet_tpu_torch.compiler.importer import import_onnx, make_forward, params_to_torch

    model = import_onnx(merged_decoder_bytes())
    ck = tmp_path / "merged.btck"
    save_checkpoint(model, ck)
    back = load_checkpoint(ck)
    assert back.dispatch_inputs == model.dispatch_inputs == ["use_cache_branch"]
    x = torch.randn(2, 1024, generator=torch.Generator().manual_seed(0))
    past = torch.randn(2, 512, generator=torch.Generator().manual_seed(1))
    want = torch.cat([past, x], 1) if flag else x
    fwd = make_forward(back, "fp32", dev)
    params = params_to_torch(back.params, dev)
    xd, pd = x.to(dev), past.to(dev)
    fwd(params, xd, np.array([flag]), pd)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        (y,) = fwd(params, xd, np.array([flag]), pd)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.equal(y.cpu(), want)
    (y,) = fwd(params, xd, torch.tensor([flag], device=dev), pd)
    assert torch.equal(y.cpu(), want)


def test_batch_context_refuses_a_while_form_graph(dev, tmp_path):
    """A while-form Loop reads its condition on the host once per
    iteration: predict_batch runs it on the card, and the batch context's
    CUDA graph capture raises InferenceError."""
    from _torch_flow_cases import while_classifier_bytes

    from birdnet_tpu_torch import Classifier
    from birdnet_tpu_torch.compiler import ops as tops
    from birdnet_tpu_torch.errors import InferenceError

    path = tmp_path / "while_v24.onnx"
    path.write_bytes(while_classifier_bytes(10))
    clf = (Classifier.builder().model_path(str(path)).labels([f"s{i}" for i in range(10)])
           .precision("fp32").build())
    segs = (np.random.default_rng(0).normal(size=(3, 144_000)) * 0.1).astype(np.float32)
    tops.HOST_READS["Loop"] = 0
    got = np.stack([r.raw_scores for r in clf.predict_batch(segs)])
    assert tops.HOST_READS["Loop"] == 3
    assert np.isfinite(got).all()
    with pytest.raises(InferenceError, match="capture"):
        clf.create_batch_context(4)


def test_batch_context_keeps_its_subgraph_constants(dev, tmp_path):
    """The initializers of an If's branches belong to the forward that
    runs them: a batch context captured on an If model replays bit for bit
    equal to predict_batch after 40 other If models (80 branches) have run
    on the card and been freed, and their memory has been taken again."""
    import gc

    from _torch_flow_cases import if_classifier_bytes

    from birdnet_tpu_torch import Classifier

    path = tmp_path / "if_v24.onnx"
    path.write_bytes(if_classifier_bytes(10, seed=0))
    clf = (Classifier.builder().model_path(str(path)).labels([f"s{i}" for i in range(10)])
           .precision("fp32").build())
    ctx = clf.create_batch_context(4)
    assert ctx.graph is not None
    x = _segments(4, "cpu", torch.float32).numpy()
    for seed in range(1, 41):
        fwd, params = _forward_on(if_classifier_bytes(10, seed), dev)
        fwd(params, torch.zeros(2, S, device=dev))
        del fwd, params
    gc.collect()
    torch.cuda.synchronize()
    junk = [torch.full((1, 10), float("nan"), device=dev) for _ in range(4096)]
    got = clf.predict_batch_with_context(ctx, x)
    del junk
    for r, q in zip(got, clf.predict_batch(x)):
        assert np.isfinite(r.raw_scores).all()
        np.testing.assert_array_equal(r.raw_scores, q.raw_scores)


# The long tail of ai.onnx and the ai.onnx.ml heads (tests/_torch_opset_cases.py,
# chip_smoke.py's op_sets phase): each graph on the card against the host,
# fp32 with TF32 off, within 1e-5 of each output's scale, the random ops bit
# for bit; the heavy batch-separable graphs (HOST_SLICED) on the host's
# first 4 rows.


def _forward_on(data, device):
    from birdnet_tpu_torch.compiler.importer import import_onnx, make_forward, params_to_torch

    model = import_onnx(data)
    return make_forward(model, "fp32", device), params_to_torch(model.params, device)


def _sync_free_forward(fwd, params, args):
    fwd(params, *args)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fwd(params, *args)
    finally:
        torch.cuda.set_sync_debug_mode("default")


@pytest.mark.parametrize("name", sorted(OPSET_CASES))
def test_opset_op_on_the_card_matches_the_cpu(dev, name):
    data = opset_model_bytes(name)
    inputs = [np.array(v) for v in opset_inputs(name).values()]
    rows = 4 if name in OPSET_HOST_SLICED else None
    fwd, params = _forward_on(data, dev)
    got = [o.cpu() for o in fwd(params, *[torch.from_numpy(v).to(dev) for v in inputs])]
    hfwd, hparams = _forward_on(data, "cpu")
    want = hfwd(hparams, *[torch.from_numpy(v[:rows] if rows else v) for v in inputs])
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g = g[:rows] if rows else g
        assert g.shape == w.shape and g.dtype == w.dtype, name
        if name in OPSET_RANDOM or not w.is_floating_point():
            assert torch.equal(g, w), name
            continue
        scale = max(float(w.double().abs().max()), 1e-30)
        assert float((g.double() - w.double()).abs().max()) <= OPSET_TOL * scale, name


@pytest.mark.parametrize("name", ["RoiAlign", "TensorScatter_linear", "Multinomial"])
def test_opset_op_forward_does_not_sync(dev, name):
    fwd, params = _forward_on(opset_model_bytes(name), dev)
    args = [torch.from_numpy(np.array(v)).to(dev) for v in opset_inputs(name).values()]
    _sync_free_forward(fwd, params, args)


@pytest.mark.parametrize("head", ML_HEADS)
def test_ml_head_on_the_card_matches_the_cpu(dev, head):
    """Each ai.onnx.ml head on 720 embeddings of width 1024: scores within
    1e-5 of their scale, labels equal, a forward without a sync."""
    emb = np.random.default_rng(0).normal(size=(720, 1024)).astype(np.float32)
    data = ml_heads(emb, 1)[head]
    fwd, params = _forward_on(data, dev)
    x = torch.from_numpy(emb).to(dev)
    got = [o.cpu() for o in _sync_free_forward(fwd, params, [x])]
    hfwd, hparams = _forward_on(data, "cpu")
    want = hfwd(hparams, torch.from_numpy(emb))
    for g, w in zip(got, want):
        if not w.is_floating_point():
            assert torch.equal(g, w), head
            continue
        scale = max(float(w.double().abs().max()), 1e-30)
        assert float((g.double() - w.double()).abs().max()) <= OPSET_TOL * scale, head


def test_random_op_in_a_batch_context_graph_replays_its_noise(dev):
    """A CUDA graph of a graph with a random op replays the same noise,
    equal to the host's draws (the noise is drawn on the host and
    uploaded once)."""
    fwd, params = _forward_on(opset_model_bytes("RandomNormal"), dev)
    x = torch.zeros(1, device=dev)
    (first,) = fwd(params, x)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        (out,) = fwd(params, x)
    graph.replay()
    a = out.clone()
    graph.replay()
    hfwd, hparams = _forward_on(opset_model_bytes("RandomNormal"), "cpu")
    (host,) = hfwd(hparams, torch.zeros(1))
    assert torch.equal(a, out) and torch.equal(a.cpu(), host) and torch.equal(first, a)


# ---------------------------------------------------------------------------
# The stream's tile programs: per streaming key one CUDA graph over each
# slot of the engine's ring, held bit for bit to the same engine's eager
# tile loop (_use_graphs False).
# ---------------------------------------------------------------------------


def _small_classifier(tmp_path, family, frontend, policy="fast"):
    from birdnet_tpu_torch import Classifier
    from birdnet_tpu_torch.models import birdnet_v24, birdnet_v30
    from birdnet_tpu_torch.onnx import proto as P

    module = {"v24": birdnet_v24, "v30": birdnet_v30}[family]
    path = tmp_path / f"{family}_{frontend}.onnx"
    P.save_model(module.build_model(num_species=10, width=0.1, depth=1,
                                    frontend=frontend), str(path))
    return (Classifier.builder().model_path(path).labels([f"s{i}" for i in range(10)])
            .precision(policy).top_k(3).build())


def _recording(seconds, rate, dtype):
    pcm = (np.random.default_rng(21).normal(size=seconds * rate) * 3000
           ).clip(-32768, 32767).astype(np.int16)
    return pcm if dtype == "int16" else pcm.astype(np.float32) / 32768.0


def _graph_and_eager(eng, samples, **kw):
    eng._use_graphs = True
    graph = eng.analyze(samples, **kw)
    eng._use_graphs = False
    try:
        eager = eng.analyze(samples, **kw)
    finally:
        eng._use_graphs = True
    return graph, eager


@pytest.mark.parametrize("dtype", ["int16", "float32"])
@pytest.mark.parametrize("overlap", [0.0, 1.5])
@pytest.mark.parametrize("tile", [32, 128])
@pytest.mark.parametrize("frontend", ["conv", "stft"])
def test_graph_stream_matches_the_eager_tile_loop_bitwise(dev, tmp_path, frontend, tile,
                                                          overlap, dtype):
    """Five minutes of audio (100 or 200 segments: partial last tiles) at
    fast through the key's graphs and through the eager tile loop: the same
    confidences and indices bit for bit; a second graph run counts exactly
    one frontend kernel and one B4 call per tile."""
    clf = _small_classifier(tmp_path, "v24", frontend)
    eng = clf._streaming_engine()
    eng.tile = tile
    samples = _recording(300, 48_000, dtype)
    graph, eager = _graph_and_eager(eng, samples, overlap_seconds=overlap)
    for got, want in zip(graph, eager):
        np.testing.assert_array_equal(got, want)
    program = next(p for k, p in eng.programs.items() if k[-1])
    assert not program.eager and program.host_reads == 0
    fe.reset_launches()
    sp.reset_launches()
    eng.analyze(samples, overlap_seconds=overlap)
    n_tiles = -(-len(graph[0]) // tile)
    counter = "filterbank_logpower" if frontend == "conv" else "stft_melspec"
    assert fe.LAUNCHES[counter] == n_tiles
    assert sp.LAUNCHES["stage_stack_forward"] == n_tiles


@pytest.mark.parametrize("frontend", ["conv", "stft"])
def test_graph_stream_with_embeddings_and_masks_is_bitwise(dev, tmp_path, frontend):
    """v3.0 (embeddings) with a build-time species list and a per-call
    mask: the keys with embeddings and with a mask, graph against eager."""
    from birdnet_tpu_torch import Classifier
    from birdnet_tpu_torch.models import birdnet_v30
    from birdnet_tpu_torch.onnx import proto as P

    path = tmp_path / f"v30_{frontend}.onnx"
    P.save_model(birdnet_v30.build_model(num_species=10, width=0.1, depth=1,
                                         frontend=frontend), str(path))
    clf = (Classifier.builder().model_path(path).labels([f"s{i}" for i in range(10)])
           .species_list([f"s{i}" for i in range(8)]).precision("fast").top_k(3).build())
    eng = clf._streaming_engine()
    eng.tile = 32
    samples = _recording(200, 32_000, "int16")
    call = np.zeros(10, bool)
    call[[0, 2, 5, 9]] = True
    for kw in ({"with_embeddings": True}, {"species_mask": call}):
        graph, eager = _graph_and_eager(eng, samples, overlap_seconds=1.5, **kw)
        for got, want in zip(graph, eager):
            np.testing.assert_array_equal(got, want)
    assert sorted(k[3:5] for k in eng.programs) == [
        (False, True), (False, True), (True, False), (True, False)]


def test_warmup_then_analyze_captures_nothing(dev, tmp_path):
    """warmup captures the key's graphs; the first analyze then replays
    them: the same program and graphs, and launches only the replays'."""
    from birdnet_tpu_torch.compiler import stream

    clf = _small_classifier(tmp_path, "v24", "conv")
    eng = clf._streaming_engine()
    eng.warmup(overlap_seconds=1.5, dtype=np.int16)
    (key, program), = eng.programs.items()
    graphs = list(program.graphs)
    assert len(graphs) == stream.RING_SLOTS
    fe.reset_launches()
    sp.reset_launches()
    conf, _, _ = eng.analyze(_recording(120, 48_000, "int16"), overlap_seconds=1.5)
    assert list(eng.programs) == [key]
    assert program.graphs == graphs
    assert fe.LAUNCHES["filterbank_logpower"] == -(-len(conf) // eng.tile)


def test_distinct_overlaps_keep_the_card_memory_bounded(dev, tmp_path):
    """Every distinct overlap is a key with its own graph: two rounds of
    MAX_PROGRAMS + 4 overlaps keep at most MAX_PROGRAMS keys, one ring, and
    the card's allocated memory after the second round within 1 MiB of the
    first's."""
    import torch

    from birdnet_tpu_torch.compiler import stream

    clf = _small_classifier(tmp_path, "v24", "conv")
    eng = clf._streaming_engine()
    samples = _recording(30, 48_000, "int16")
    overlaps = [0.25 * i for i in range(stream.MAX_PROGRAMS + 4)]
    after = []
    for _ in range(2):
        for overlap in overlaps:
            eng.analyze(samples, overlap_seconds=overlap)
            assert len(eng.programs) <= stream.MAX_PROGRAMS
        ring = eng._ring
        torch.cuda.synchronize()
        after.append(torch.cuda.memory_allocated())
    assert eng._ring is ring and ring.nbytes == eng.tile * 144_000 * 4
    assert all(h.is_pinned() for h in ring.hosts) and len(ring.hosts) == stream.RING_SLOTS
    assert len(ring.devices) == stream.RING_SLOTS
    assert abs(after[1] - after[0]) <= 1 << 20


def test_while_form_streams_through_an_eager_key(dev, tmp_path):
    """A Loop on a data-dependent condition reads the card on the host:
    its key is eager (counted in the warm calls, before any capture), and
    the stream matches the host's."""
    from _torch_flow_cases import while_classifier_bytes

    from birdnet_tpu_torch import Classifier

    path = tmp_path / "while_v24.onnx"
    path.write_bytes(while_classifier_bytes(10))
    built = [Classifier.builder().model_path(str(path)).labels([f"s{i}" for i in range(10)])
             .precision("fp32").top_k(3).with_device(device).build()
             for device in ("cuda", "cpu")]
    samples = _recording(60, 48_000, "float32")
    card, host = (c._streaming_engine().analyze(samples, overlap_seconds=1.5) for c in built)
    (program,) = built[0]._streaming_engine().programs.values()
    assert program.eager and program.host_reads > 0
    np.testing.assert_array_equal(card[1], host[1])
    np.testing.assert_allclose(card[0], host[0], rtol=0, atol=1e-6)


def test_failed_stream_capture_raises_inference_error(dev, tmp_path):
    """A tile body that syncs inside the capture (a read the host-read count
    does not see) makes the capture fail: InferenceError, no program kept,
    nothing run eagerly."""
    from birdnet_tpu_torch.errors import InferenceError

    clf = _small_classifier(tmp_path, "v24", "conv", policy="fp32")
    eng = clf._streaming_engine()
    forward = eng._forward

    def syncing(params, x):
        outs = forward(params, x)
        outs[0].sum().item()
        return outs

    eng._forward = syncing
    with pytest.raises(InferenceError, match="capture"):
        eng.analyze(_recording(30, 48_000, "float32"))
    assert eng.programs == {}


@pytest.mark.parametrize("saturate", [0, 1])
@pytest.mark.parametrize("target", ["FLOAT8E4M3FN", "FLOAT8E4M3FNUZ", "FLOAT8E5M2",
                                    "FLOAT8E5M2FNUZ"])
def test_float8_quantize_linear_on_the_card_matches_the_host(dev, target, saturate):
    """QuantizeLinear to each float8 type (output_dtype form, opset 21) on
    the card against the host, bit for bit: in-range values, ties at the
    overflow threshold, overflows, infinities and NaN of both signs."""
    from birdnet_tpu_torch.compiler.importer import import_onnx, make_forward, params_to_torch
    from birdnet_tpu_torch.onnx import proto as P

    code = int(getattr(P.DataType, target))
    graph = P.GraphProto(
        name="q8",
        node=[P.make_node("QuantizeLinear", ["x", "s"], ["y"], output_dtype=code,
                          saturate=saturate)],
        initializer=[P.TensorProto.from_numpy(np.float32(0.5), name="s")],
        input=[P.make_value_info("x", P.DataType.FLOAT, [4, 16])],
        output=[P.make_value_info("y", code, [4, 16])])
    model = import_onnx(P.encode_model(P.make_model(graph, opset_version=21)))
    special = np.array([464.0, 464.01, 248.0, 247.99, 61440.0, 61439.9, 1e6, np.inf,
                        np.nan, 0.0, 1e-9], np.float32)
    x = np.concatenate([np.random.default_rng(5).normal(size=42).astype(np.float32) * 300,
                        special, -special]).reshape(4, 16)
    bits = []
    for device in ("cuda", "cpu"):
        (y,) = make_forward(model, "fp32", device)(params_to_torch(model.params, device),
                                                   torch.from_numpy(x).to(device))
        bits.append(y.view(torch.uint8).cpu().numpy())
    np.testing.assert_array_equal(bits[0], bits[1])


# The com.microsoft contrib domain (tests/_torch_contrib_cases.py, chip_smoke.py's
# contrib phase): each name's graph on the card against the host, fp32 with
# TF32 off, floats within 1e-5 of each output's scale, integer codes, token
# sequences and hashes equal (codes requantized from a float sum within one),
# generation scores within 1e-4 relative; the inputs a lowering reads on the
# host (max_length...) stay numpy.
def _contrib_args(vals, device):
    return [np.array(v) if k in contrib.HOST_INPUTS else torch.from_numpy(np.array(v)).to(device)
            for k, v in vals.items()]


def _contrib_compare(name, got, want):
    err, ints_ok = contrib.compare(name, got, want)
    assert ints_ok, name
    assert err <= (1e-4 if name in contrib.GENERATION else 1e-5), (name, err)


@pytest.mark.parametrize("name", sorted(n for n in contrib.CASES if n != "DynamicTimeWarping"))
def test_contrib_op_on_the_card_matches_the_cpu(dev, name):
    data, vals = contrib.CASES[name]()
    fwd, params = _forward_on(data, dev)
    got = fwd(params, *_contrib_args(vals, dev))
    hfwd, hparams = _forward_on(data, "cpu")
    _contrib_compare(name, got, hfwd(hparams, *_contrib_args(vals, "cpu")))


def test_dynamic_time_warping_on_the_card_needs_a_host_value(dev):
    data, vals = contrib.CASES["DynamicTimeWarping"]()
    fwd, params = _forward_on(data, dev)
    with pytest.raises(NotImplementedError, match="compile-time constant"):
        fwd(params, *_contrib_args(vals, dev))


def test_ort_optimized_v24_batch_context_is_bitwise(dev, tmp_path):
    """A tiny ORT-optimized v2.4 (FusedConv / QuickGelu) at ``fast``: the
    batch context's graph equals predict_batch bit for bit, the frontend
    kernel (B2) runs, B4 does not (its pass matches the plain spelling)."""
    from birdnet_tpu_torch import Classifier
    from birdnet_tpu_torch.models import birdnet_v24
    from birdnet_tpu_torch.onnx import proto as P

    path = tmp_path / "v24_ort.onnx"
    path.write_bytes(contrib.ort_optimized(P.encode_model(
        birdnet_v24.build_model(num_species=10, width=0.1, depth=1))))
    clf = (Classifier.builder().model_path(path).labels([f"s{i}" for i in range(10)])
           .precision("fast").top_k(3).build())
    fe.reset_launches()
    sp.reset_launches()
    ctx = clf.create_batch_context(8)
    assert fe.LAUNCHES["filterbank_logpower"] > 0 and sp.LAUNCHES["stage_stack_forward"] == 0
    x = _segments(8, "cpu", torch.float32).numpy()
    for r, q in zip(clf.predict_batch_with_context(ctx, x), clf.predict_batch(x)):
        np.testing.assert_array_equal(r.raw_scores, q.raw_scores)


def test_generation_reads_the_card_once_per_step(dev):
    """GreedySearch on the card: the early stop is read once per step."""
    from birdnet_tpu_torch.compiler import ops as tops

    data, vals = contrib.CASES["GreedySearch"]()
    fwd, params = _forward_on(data, dev)
    args = _contrib_args(vals, dev)
    tops.HOST_READS["GreedySearch"] = 0
    (seq,) = fwd(params, *args)
    steps = vals["max_length"][0] - vals["input_ids"].shape[1] - 1
    assert 1 <= tops.HOST_READS["GreedySearch"] <= steps + 1
    assert seq.shape == (2, vals["max_length"][0])


@pytest.mark.parametrize("shape", [(1, 1), (2, 2), (1, 4)], ids=["1x1", "2x2", "1x4"])
def test_mesh_on_one_card_runs_the_kernels_per_cell(dev, tmp_path, shape):
    """A mesh whose every cell is the card: under fast each running cell
    launches B2 and B4 as one single-device call does; at fp32 its answer
    equals the single-device classifier's (logits within 1e-4 of their
    scale, top-K equal). 10 species pad to 12 over the 4-way axis."""
    from birdnet_tpu_torch import Classifier
    from birdnet_tpu_torch.models import birdnet_v24
    from birdnet_tpu_torch.parallel import make_mesh

    path = tmp_path / "v24.onnx"
    birdnet_v24.save_tiny(path, num_species=10)
    labels = [f"s{i}" for i in range(10)]

    def build(policy, mesh=None):
        b = Classifier.builder().model_path(path).labels(labels).precision(policy).top_k(3)
        return (b.with_mesh(mesh) if mesh is not None else b).build()

    mesh = make_mesh([dev] * (shape[0] * shape[1]), shape=shape)
    x = _segments(8, "cpu", torch.float32).numpy()
    single = build("fast")
    single.predict_batch(x)
    fe.reset_launches()
    sp.reset_launches()
    single.predict_batch(x)
    per_call = (fe.LAUNCHES["filterbank_logpower"], sp.LAUNCHES["stage_stack_forward"])
    meshed = build("fast", mesh)
    meshed.predict_batch(x)  # captures the bucket's graphs (warm calls count)
    fe.reset_launches()
    sp.reset_launches()
    meshed.predict_batch(x)
    cells = shape[0] * shape[1]
    assert meshed._engine.head_sharded == (shape[1] > 1)
    assert (fe.LAUNCHES["filterbank_logpower"], sp.LAUNCHES["stage_stack_forward"]) == (
        cells * per_call[0], cells * per_call[1])
    for got, want in zip(build("fp32", mesh).predict_batch(x), build("fp32").predict_batch(x)):
        assert [p.index for p in got.predictions] == [p.index for p in want.predictions]
        scale = np.abs(want.raw_scores).max()
        assert np.abs(got.raw_scores - want.raw_scores).max() <= 1e-4 * scale


# ---------------------------------------------------------------------------
# The mesh's compiled programs: per key one CUDA graph per card and the
# merge (parallel/graphs.py), held bit for bit to the eager step.
# ---------------------------------------------------------------------------


def _mesh_classifier(dev, tmp_path, shape=(2, 2), policy="fast", num_species=10):
    from birdnet_tpu_torch import Classifier
    from birdnet_tpu_torch.models import birdnet_v24
    from birdnet_tpu_torch.parallel import make_mesh

    path = tmp_path / "v24.onnx"
    birdnet_v24.save_tiny(path, num_species=num_species)
    mesh = make_mesh([dev] * (shape[0] * shape[1]), shape=shape)
    return (Classifier.builder().model_path(path).labels([f"s{i}" for i in range(num_species)])
            .precision(policy).top_k(3).with_mesh(mesh).build())


def _mesh_eager_stream(eng, samples, **kw):
    """``eng.analyze`` through the eager tile loop (the plain version)."""
    eng._run_tiles = eng._eager_tiles
    try:
        return eng.analyze(samples, **kw)
    finally:
        del eng._run_tiles


def test_mesh_graphs_match_the_eager_step_bitwise(dev, tmp_path):
    """A one-card (2, 2) mesh at fast: predict_batch (one replay per call),
    its batch context with and without row masks and its stream with and
    without the call mask equal the eager step bit for bit; each replay
    counts B2 and B4 once per running cell."""
    from birdnet_tpu_torch.parallel.engine import _EagerBatch

    clf = _mesh_classifier(dev, tmp_path)
    eng = clf._engine
    x = _segments(8, "cpu", torch.float32).numpy()
    rows = np.random.default_rng(3).random((8, 10)) < 0.5
    rows[:, 0] = True
    for masked in (False, True):
        program = eng.compiled(8, with_row_mask=masked)
        assert not program.eager and len(program.step.graphs) == 1
        mask = rows if masked else None
        got = program.run(x, mask, 8, None)
        want = _EagerBatch(eng, 8, False).run(x, mask, 8, None)
        for a, b in zip(got[:3], want[:3]):
            np.testing.assert_array_equal(a, b)
    fe.reset_launches()
    sp.reset_launches()
    clf.predict_batch(x)
    assert (fe.LAUNCHES["filterbank_logpower"], sp.LAUNCHES["stage_stack_forward"]) == (4, 4)

    ctx = clf.create_batch_context(8, precompile_row_mask=True)
    assert ctx.graph is eng.compiled(8)
    for masks in (None, rows[:5]):
        got = clf.predict_batch_with_context(ctx, x[:5], species_masks=masks)
        want = _EagerBatch(eng, 8, False).run(x[:5], None if masks is None else np.vstack(
            [masks, np.ones((3, 10), bool)]), 5, None)
        np.testing.assert_array_equal(np.stack([r.raw_scores for r in got]), want[2])

    pcm = _recording(120, 48_000, "int16")
    call = np.zeros(10, bool)
    call[[0, 2, 5, 9]] = True
    for kw in ({}, {"species_mask": call}, {"overlap_seconds": 1.5}):
        graph = eng.analyze(pcm, **kw)
        for a, b in zip(graph, _mesh_eager_stream(eng, pcm, **kw)):
            np.testing.assert_array_equal(a, b)
    assert sorted(k[4] for k in eng.programs) == [False, False, True]
    assert not any(p.eager for p in eng.programs.values())
    fe.reset_launches()
    conf, _, _ = eng.analyze(pcm)
    assert fe.LAUNCHES["filterbank_logpower"] == 4 * -(-len(conf) // eng.tile)


def test_mesh_batch_sizes_1_to_32_make_at_most_six_captures(dev, tmp_path, monkeypatch):
    """A (1, 1) card mesh: predict_batch at every size 1-32 captures one
    program per power-of-two bucket (six), none evicted, as the JAX engine
    compiles one executable per bucket."""
    from birdnet_tpu_torch.parallel import engine as engine_mod

    made = []

    class Counted(engine_mod._MeshBatch):
        def __init__(self, *args, **kwargs):
            made.append(args[1])
            super().__init__(*args, **kwargs)

    monkeypatch.setattr(engine_mod, "_MeshBatch", Counted)
    clf = _mesh_classifier(dev, tmp_path, (1, 1))
    x = _segments(32, "cpu", torch.float32).numpy()
    for b in range(1, 33):
        assert len(clf.predict_batch(x[:b])) == b
    assert made == [1, 2, 4, 8, 16, 32]
    assert sorted(k[0] for k in clf._engine._compiled) == made


def test_mesh_graphs_match_the_eager_step_on_other_layouts(dev, tmp_path):
    """(1, 4) and (2, 1) one-card meshes: the graphs equal the eager step
    (head split four ways with 10 species padded to 12; no split)."""
    from birdnet_tpu_torch.parallel.engine import _EagerBatch

    x = _segments(4, "cpu", torch.float32).numpy()
    for shape in ((1, 4), (2, 1)):
        eng = _mesh_classifier(dev, tmp_path, shape, policy="fp32")._engine
        got = eng.compiled(4).run(x, None, 4, None)
        want = _EagerBatch(eng, 4, False).run(x, None, 4, None)
        for a, b in zip(got[:3], want[:3]):
            np.testing.assert_array_equal(a, b)


def test_failed_mesh_capture_raises(dev, tmp_path, monkeypatch):
    """A cell that synchronizes while captured: the program, the context
    and the stream raise InferenceError; a while-form forward (host reads)
    predicts through an eager key, and its context refuses."""
    from _torch_flow_cases import while_classifier_bytes

    from birdnet_tpu_torch import Classifier
    from birdnet_tpu_torch.errors import InferenceError
    from birdnet_tpu_torch.parallel import make_mesh

    clf = _mesh_classifier(dev, tmp_path)
    cells = clf._engine._cells
    cell = cells.cell

    def syncing(*args, **kw):
        if torch.cuda.is_current_stream_capturing():
            torch.cuda.synchronize()
        return cell(*args, **kw)

    monkeypatch.setattr(cells, "cell", syncing)
    with pytest.raises(InferenceError, match="capture"):
        clf._engine.compiled(8)
    with pytest.raises(InferenceError, match="capture"):
        clf.create_batch_context(8)
    with pytest.raises(InferenceError, match="capture"):
        clf.analyze_samples(_recording(30, 48_000, "int16"))

    path = tmp_path / "while_v24.onnx"
    path.write_bytes(while_classifier_bytes(10))
    mesh = make_mesh([dev] * 4, shape=(2, 2))
    loop = (Classifier.builder().model_path(str(path)).labels([f"s{i}" for i in range(10)])
            .precision("fp32").with_mesh(mesh).build())
    segs = (np.random.default_rng(0).normal(size=(3, 144_000)) * 0.1).astype(np.float32)
    assert np.isfinite(np.stack([r.raw_scores for r in loop.predict_batch(segs)])).all()
    assert loop._engine.compiled(4).eager
    with pytest.raises(InferenceError, match="capture"):
        loop.create_batch_context(4)


def test_capture_activations_card_against_host(dev, tmp_path):
    """utils/activation_diff on the card against the host at fp32: the
    same value names, every layer within 1e-4 of its own scale."""
    from birdnet_tpu_torch.checkpoint import import_any
    from birdnet_tpu_torch.models import birdnet_v24
    from birdnet_tpu_torch.utils.activation_diff import capture_activations, layer_diffs

    path = tmp_path / "v24.onnx"
    birdnet_v24.save_tiny(path, num_species=10)
    imported = import_any(str(path))
    x = _segments(2, "cpu", torch.float32).numpy()
    card = capture_activations(imported, "fp32", x)
    host = capture_activations(imported, "fp32", x, "cpu")
    assert set(card) == set(host)
    worst = layer_diffs(host, card)[0]
    assert worst[0] <= 1e-4, worst


def test_stream_graph_outlives_the_operand_caches(dev, tmp_path):
    """A stream key's graph reads B4's weight tables and B2's packed
    filterbank from the lowerings' caches. Nine more forwards fill both
    caches past their size, and what they drop is freed and released: the
    graph's next replay gives the same answer bit for bit (before a graph
    held what it read, an illegal memory access)."""
    import gc

    from birdnet_tpu_torch.compiler import ops as tops

    clf = _small_classifier(tmp_path, "v24", "conv")
    eng = clf._streaming_engine()
    pcm = _recording(60, 48_000, "int16")
    first = eng.analyze(pcm)
    x = _segments(2, "cpu", torch.float32).numpy()
    for i in range(tops._PREFIX_TABLES_MAX + 1):
        _small_classifier(tmp_path, "v24", "conv").predict_batch(x)
    gc.collect()
    torch.cuda.empty_cache()
    again = eng.analyze(pcm)
    torch.cuda.synchronize()
    for a, b in zip(first, again):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("where", ["stream", "batch_context"])
def test_capture_survives_a_dead_graph_in_reach_of_the_collector(dev, tmp_path,
                                                                 monkeypatch, where):
    """Python's collector, run during a capture, finalizes the dead cycles
    it finds; one that holds another CUDA graph destroys it there, which
    invalidates the capture (cudaErrorStreamCaptureInvalidated: a stream
    key's capture after earlier classifiers were dropped). Here the forward
    drops such a cycle in each capture and then allocates enough to set off
    a collection: the captures hold (the collector is paused), every cycle
    was dropped, and the graphs answer as the eager path does."""
    import gc

    x = torch.ones(1024, device=dev)
    victims = []
    for _ in range(4):
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            x.mul(3)
        victims.append(graph)
    del graph
    clf = _small_classifier(tmp_path, "v24", "conv", policy="fp32")
    eng = clf._streaming_engine() if where == "stream" else clf._engine
    forward, dropped = eng._forward, []

    def dropping(params, frames):
        if victims and torch.cuda.is_current_stream_capturing():
            cycle = [victims.pop()]
            cycle.append(cycle)
            del cycle
            junk = [[] for _ in range(4 * gc.get_threshold()[0])]
            dropped.append(len(junk))
        return forward(params, frames)

    monkeypatch.setattr(eng, "_forward", dropping)
    if where == "stream":
        eng.tile = 4
        graph, eager = _graph_and_eager(eng, _recording(30, 48_000, "float32"))
        for got, want in zip(graph, eager):
            np.testing.assert_array_equal(got, want)
        assert len(dropped) == 2  # one capture per ring slot
    else:
        ctx = clf.create_batch_context(4)
        assert ctx.graph is not None and len(dropped) == 1
        segs = _segments(4, "cpu", torch.float32).numpy()
        for r, q in zip(clf.predict_batch_with_context(ctx, segs), clf.predict_batch(segs)):
            np.testing.assert_array_equal(r.raw_scores, q.raw_scores)
    gc.collect()


@pytest.mark.parametrize("new_keys", [False, True], ids=["replaying", "capturing"])
def test_batch_context_capture_beside_streaming_threads(dev, tmp_path, new_keys):
    """Three threads stream on one classifier while a fourth makes its
    first batch context (a CUDA graph capture) and calls it and
    predict_batch: no call raises, and every answer equals the serial one
    bit for bit (chip_smoke.py's concurrency phase at a small width). With
    ``new_keys`` each stream thread's first call captures a streaming key of
    its own, so that the captures overlap; else the fourth captures once
    every stream has answered, so that its capture meets running streams.
    A context that captured in CUDA's global mode refused the other
    threads' event waits and blocking copies (and was invalidated by
    them)."""
    import threading

    clf = _small_classifier(tmp_path, "v24", "conv")
    clf._streaming_engine().tile = 4
    pcm = _recording(40, 48_000, "int16")
    recs = [pcm[k * 48_000:] for k in range(3)]
    overlaps = [0.5, 1.0, 1.5] if new_keys else [0.0] * 3
    segs = _segments(8, "cpu", torch.float32).numpy()
    arrays = lambda out: [(t, [p.index for p in ps], [p.confidence for p in ps]) for t, ps in out]
    serial_logits = np.stack([r.raw_scores for r in clf.predict_batch(segs)])
    if not new_keys:
        serial = [arrays(clf.analyze_samples(r)) for r in recs]
    errors, streams, answers = [], [[] for _ in recs], []
    start, done = threading.Barrier(len(recs) + 1), threading.Event()
    answered = threading.Barrier(len(recs) + 1)

    def streamer(k):
        try:
            start.wait()
            while len(streams[k]) < 3 or not done.is_set():
                streams[k].append(arrays(clf.analyze_samples(recs[k],
                                                             overlap_seconds=overlaps[k])))
                if len(streams[k]) == 1 and not new_keys:
                    answered.wait(60)
        except Exception as e:  # noqa: BLE001 - asserted below
            answered.abort()
            errors.append(e)

    def fourth():
        try:
            start.wait()
            if not new_keys:
                answered.wait(60)
            ctx = clf.create_batch_context(8)
            assert ctx.graph is not None
            for _ in range(3):
                answers.append(clf.predict_batch_with_context(ctx, segs))
                answers.append(clf.predict_batch(segs))
        except Exception as e:  # noqa: BLE001 - asserted below
            errors.append(e)
        finally:
            done.set()

    threads = [threading.Thread(target=streamer, args=(k,)) for k in range(len(recs))]
    threads.append(threading.Thread(target=fourth))
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert errors == []
    if new_keys:
        serial = [arrays(clf.analyze_samples(r, overlap_seconds=o))
                  for r, o in zip(recs, overlaps)]
    for k, calls in enumerate(streams):
        assert calls and all(c == serial[k] for c in calls)
    assert len(answers) == 6
    for results in answers:
        np.testing.assert_array_equal(np.stack([r.raw_scores for r in results]), serial_logits)
