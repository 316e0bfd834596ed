"""The import-time GELU bundling (``compiler/fuse_gelu.py``) and its kernel
(``csrc/gelu.cu``, ``ops/cuda/gelu.py``).

On the CPU: the tiny AVES model's chains fuse (2 FFN, 7 encoder, 1
positional) and run bit for bit as unfused; each prologue form, Mul order
and operand side fuses and is interpreted bit for bit as unfused, and the
kernels' plain versions compute the chain's own steps; the kept forms are
counted; the output-type rule; graphs without ``Erf`` (v2.4, Perch) fuse
nothing.

On the card (marked ``cuda``; each test skips without a CUDA device):

    python -m pytest tests/test_torch_fuse_gelu.py -q --noconftest -m cuda

the kernel against the interpreted chain at AVES's shapes, the tiny model
streamed through ``embed_samples`` fused and unfused, and the launches a
captured tile counts.
"""

import json
import math
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from birdnet_tpu_torch.compiler import fuse_gelu, importer as timp, ops  # noqa: E402
from birdnet_tpu_torch.models import aves_hubert, birdnet_v24, perch_v2  # noqa: E402
from birdnet_tpu_torch.onnx import proto as P  # noqa: E402
from birdnet_tpu_torch.ops.cuda import gelu  # noqa: E402
from birdnet_tpu_torch.utils import profiling  # noqa: E402

SPECIES, S = 16, 80_000
SQRT2 = np.float32(math.sqrt(2.0))
RSQRT2 = np.float32(1.0 / math.sqrt(2.0))
# The encoder's frames at 80,000 samples (kernels 10,3,3,3,3,2,2, strides 5,2,...).
ENCODER_FRAMES = (15999, 7999, 3999, 1999, 999, 499, 249)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("aves") / "aves_tiny.onnx")
    aves_hubert.save_tiny(path, num_species=SPECIES)
    return path


def _unfused(monkeypatch, data):
    monkeypatch.setattr(fuse_gelu, "fuse_gelu", lambda graph, tensors: (0, 0))
    model = timp.import_onnx(data)
    monkeypatch.undo()
    return model


def _forward(model, precision, *xs):
    fwd = timp.make_forward(model, precision, "cpu")
    return fwd(timp.params_to_torch(model.params, "cpu"), *xs)


def _gelus(model):
    return [n for n in model.graph.node if n.op_type == "_FusedGelu"]


def _import_counting(data):
    before = profiling.snapshot()
    model = timp.import_onnx(data)
    return model, (profiling.snapshot() - before).counters


# -- the tiny AVES model -----------------------------------------------------------


def test_the_tiny_model_chains_fuse_and_run_bit_for_bit(tiny, monkeypatch):
    data = open(tiny, "rb").read()
    fused, counters = _import_counting(data)
    nodes = _gelus(fused)
    forms = [len(n.input) for n in nodes]
    # 7 encoder layers (channel LayerNorm), the positional conv (bare), 2 FFNs (bias).
    assert forms == [3] * 7 + [1] + [2] * 2
    assert "Erf" not in [n.op_type for n in fused.graph.node]
    assert counters.get("birdnet.compiler.gelu_fused") == 10
    assert counters.get("birdnet.compiler.gelu_kept", 0) == 0
    # Conv and MatMul readers round to bf16; the last encoder layer feeds a
    # Transpose (proj.ln), the positional GELU a Transpose (the residual).
    assert [n.attrs["bf16_out"] for n in nodes] == [1] * 6 + [0, 0] + [1, 1]
    unfused = _unfused(monkeypatch, data)
    assert [n.op_type for n in unfused.graph.node].count("Erf") == 10
    x = torch.from_numpy((np.random.default_rng(9).normal(size=(2, S)) * 0.1)
                         .astype(np.float32))
    # One thread: MKL's threaded float32 GEMM may split its sums another way
    # from one call to the next (the products, not the chains, then differ).
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for precision in ("fp32", "fast"):
            for a, b in zip(_forward(fused, precision, x), _forward(unfused, precision, x)):
                assert torch.equal(a, b)
    finally:
        torch.set_num_threads(threads)


# -- each form of chain ----------------------------------------------------------------


def _chain_graph(prologue="bias", order="half_last", scale="div", swap=False, reader=None,
                 variant=None, channels=8, ln_width=None):
    """One GELU chain over the graph input: ``prologue`` ``bias`` (input
    ``y [2, 5, 8]``, ``[10, 8]`` when a Gemm reads the result, + a constant
    [8]), ``channel_ln`` (input ``X [2, 8, 5]`` normalized over its 8
    channels between two Transposes) or ``bare`` (input ``x`` as ``y``);
    ``order`` of the Muls, ``half_last`` (x * (erf
    + 1)) * 0.5 or ``half_first`` (x * 0.5) * (erf + 1); ``scale`` Div by
    sqrt 2 or Mul by its inverse; ``swap`` puts every operand on the other
    side. ``reader``: None (the result is the graph output) or op types that
    read it (``MatMul``, ``Gemm``, ``Conv``, ``Relu``, ``Transpose``).
    ``variant``: ``erf_read_elsewhere``, ``interior_output`` (erf + 1 is an
    output too) or ``prologue_output`` (the bias Add's result is one).
    ``channels`` of ``X`` and ``ln_width`` (default ``channels``) of the
    LayerNorm's scale and shift, for ``channel_ln``."""
    rng = np.random.default_rng(3)
    inits = {"sqrt2": SQRT2, "rsqrt2": RSQRT2, "one": np.float32(1.0),
             "half": np.float32(0.5)}
    nodes = []

    def node(op, inputs, out, **attrs):
        if swap and op in ("Add", "Mul") and len(inputs) == 2:
            inputs = inputs[::-1]
        nodes.append(P.make_node(op, inputs, [out], **attrs))
        return out

    rows = [10, 8] if "Gemm" in (reader or ()) else [2, 5, 8]
    if prologue == "bias":
        inits["b"] = rng.normal(size=8).astype(np.float32)
        inp, shape = "y", rows
        x = node("Add", ["y", "b"], "v")
    elif prologue == "channel_ln":
        width = channels if ln_width is None else ln_width
        inits["s"] = (1.0 + 0.1 * rng.normal(size=width)).astype(np.float32)
        inits["sh"] = (0.1 * rng.normal(size=width)).astype(np.float32)
        inp, shape = "X", [2, channels, 5]
        t = node("Transpose", ["X"], "t", perm=[0, 2, 1])
        t = node("LayerNormalization", [t, "s", "sh"], "ln", axis=-1, epsilon=1e-5)
        x = node("Transpose", [t], "v", perm=[0, 2, 1])
    else:
        inp, shape = "x", rows
        x = "x"
    u = node("Div", [x, "sqrt2"], "u") if scale == "div" else node("Mul", [x, "rsqrt2"], "u")
    e = node("Erf", [u], "e")
    e1 = node("Add", [e, "one"], "e1")
    if order == "half_last":
        g = node("Mul", ["half", node("Mul", [x, e1], "m")], "g")
    else:
        g = node("Mul", [e1, node("Mul", ["half", x], "h")], "g")
    outputs = []
    if reader is None:
        outputs.append(("g", shape))
    for i, op in enumerate(reader or ()):
        out = f"r{i}"
        if op in ("MatMul", "Gemm"):
            inits[f"w{i}"] = rng.normal(size=(shape[-1], 3)).astype(np.float32)
            nodes.append(P.make_node(op, ["g", f"w{i}"], [out]))
            outputs.append((out, shape[:-1] + [3]))
        elif op == "Conv":
            inits[f"w{i}"] = rng.normal(size=(4, shape[1], 1)).astype(np.float32)
            nodes.append(P.make_node(op, ["g", f"w{i}"], [out]))
            outputs.append((out, [shape[0], 4, shape[2]]))
        else:
            nodes.append(P.make_node(op, ["g"], [out]))
            outputs.append((out, shape[::-1] if op == "Transpose" else shape))
    if variant == "erf_read_elsewhere":
        nodes.append(P.make_node("Neg", ["e"], ["n"]))
        outputs.append(("n", shape))
    elif variant == "interior_output":
        outputs.append(("e1", shape))
    elif variant == "prologue_output":
        outputs.append(("v", shape))
    graph = P.GraphProto(
        name="gelu", node=nodes,
        initializer=[P.TensorProto.from_numpy(np.asarray(v), name=k) for k, v in inits.items()],
        input=[P.make_value_info(inp, P.DataType.FLOAT, shape)],
        output=[P.make_value_info(n, P.DataType.FLOAT, s) for n, s in outputs])
    return P.encode_model(P.make_model(graph, opset_version=17)), shape, inits


def _input(shape, seed=0, dtype=torch.float32):
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32) * 2.0
    return torch.from_numpy(x).to(dtype)


@pytest.mark.parametrize("scale", ["div", "mul"])
@pytest.mark.parametrize("swap", [False, True])
@pytest.mark.parametrize("order", ["half_last", "half_first"])
@pytest.mark.parametrize("prologue", ["bias", "channel_ln", "bare"])
def test_each_form_fuses_and_runs_as_unfused(prologue, order, swap, scale, monkeypatch):
    data, shape, inits = _chain_graph(prologue, order, scale, swap)
    fused, counters = _import_counting(data)
    (node,) = fused.graph.node
    assert node.op_type == "_FusedGelu"
    assert counters.get("birdnet.compiler.gelu_fused") == 1
    assert list(node.input) == {"bias": ["y", "b"], "channel_ln": ["X", "s", "sh"],
                                "bare": ["x"]}[prologue]
    assert node.attrs["c"] == float(SQRT2 if scale == "div" else RSQRT2)
    assert (node.attrs["divide"], node.attrs["half_first"]) == (
        int(scale == "div"), int(order == "half_first"))
    assert node.attrs["bf16_out"] == 0
    unfused = _unfused(monkeypatch, data)
    x = _input(shape)
    for precision in ("fp32", "fast"):
        (got,), (want,) = _forward(fused, precision, x), _forward(unfused, precision, x)
        assert torch.equal(got, want)
    # The kernels' plain versions: the chain's steps on a bf16 activation, as
    # the body runs them under ``fast``.
    xb = _input(shape, seed=1, dtype=torch.bfloat16)
    (want,) = _forward(fused, "fast", xb)
    args = (node.attrs["c"], bool(node.attrs["divide"]), bool(node.attrs["half_first"]),
            torch.float32)
    if prologue == "channel_ln":
        got = gelu.channel_ln_gelu(xb, torch.from_numpy(inits["s"]),
                                   torch.from_numpy(inits["sh"]), 1e-5, *args)
    else:
        bias = torch.from_numpy(inits["b"]) if prologue == "bias" else None
        got = gelu.bias_gelu(xb, bias, *args)
    assert got.dtype == want.dtype and torch.equal(got, want)


@pytest.mark.parametrize("variant", ["erf_read_elsewhere", "interior_output"])
def test_chains_read_inside_are_kept_and_counted(variant, monkeypatch):
    data, shape, _ = _chain_graph("bias", variant=variant)
    model, counters = _import_counting(data)
    assert not _gelus(model)
    assert counters.get("birdnet.compiler.gelu_kept") == 1
    assert counters.get("birdnet.compiler.gelu_fused", 0) == 0
    x = _input(shape)
    for a, b in zip(_forward(model, "fast", x), _forward(_unfused(monkeypatch, data), "fast", x)):
        assert torch.equal(a, b)


def test_a_prologue_read_elsewhere_stays_outside_the_chain(monkeypatch):
    data, shape, _ = _chain_graph("bias", variant="prologue_output")
    model, counters = _import_counting(data)
    (node,) = _gelus(model)
    assert list(node.input) == ["v"]  # the bare form, over the bias Add's result
    assert [n.op_type for n in model.graph.node] == ["Add", "_FusedGelu"]
    assert counters.get("birdnet.compiler.gelu_fused") == 1
    x = _input(shape)
    for a, b in zip(_forward(model, "fast", x), _forward(_unfused(monkeypatch, data), "fast", x)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("channels,ln_width", [(gelu.MAX_CHANNELS + 1, None), (8, 1)],
                         ids=["wider_than_the_kernel", "one_scale_for_all"])
def test_a_layernorm_the_kernel_cannot_hold_stays_outside_the_chain(channels, ln_width,
                                                                     monkeypatch):
    data, shape, _ = _chain_graph("channel_ln", channels=channels, ln_width=ln_width)
    model, counters = _import_counting(data)
    (node,) = _gelus(model)
    assert list(node.input) == ["v"]  # the bare form, over the second Transpose
    assert [n.op_type for n in model.graph.node] == [
        "Transpose", "LayerNormalization", "Transpose", "_FusedGelu"]
    assert counters.get("birdnet.compiler.gelu_fused") == 1
    x = _input(shape)
    for a, b in zip(_forward(model, "fast", x), _forward(_unfused(monkeypatch, data), "fast", x)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("readers,bf16_out", [
    (("MatMul",), 1), (("Gemm",), 1), (("MatMul", "MatMul"), 1), (None, 0),
    (("Transpose",), 0), (("MatMul", "Relu"), 0),
])
def test_the_output_type_follows_the_readers(readers, bf16_out, monkeypatch):
    data, shape, _ = _chain_graph("bias", reader=readers)
    model = timp.import_onnx(data)
    (node,) = _gelus(model)
    assert node.attrs["bf16_out"] == bf16_out
    x = _input(shape)
    for a, b in zip(_forward(model, "fast", x), _forward(_unfused(monkeypatch, data), "fast", x)):
        assert torch.equal(a, b)


def test_a_conv_reader_takes_bf16():
    data, _, _ = _chain_graph("channel_ln", reader=("Conv",))
    (node,) = _gelus(timp.import_onnx(data))
    assert node.attrs["bf16_out"] == 1


@pytest.mark.parametrize("save_tiny", [birdnet_v24.save_tiny, perch_v2.save_tiny],
                         ids=["v24", "perch"])
def test_swish_graphs_fuse_nothing(save_tiny, tmp_path):
    path = str(tmp_path / "m.onnx")
    save_tiny(path)
    model, counters = _import_counting(open(path, "rb").read())
    assert not _gelus(model)
    assert counters.get("birdnet.compiler.gelu_fused", 0) == 0
    assert counters.get("birdnet.compiler.gelu_kept", 0) == 0


def test_the_kernel_takes_only_its_operands():
    """The wrappers take bf16, f16 and float32 activations with float32
    vectors (a bias broadcast over the last axis) and refuse every other
    operand with ValueError, on the CPU as on the card."""
    x = torch.zeros(4, 6, 8, dtype=torch.bfloat16)
    assert gelu.rows(x) == (24, 8, 8)
    assert gelu.rows(torch.zeros(4, 6, 9)[..., :8]) == (24, 8, 9)  # a sliced view
    assert gelu.rows(x.transpose(1, 2)) is None  # copied before a launch
    args = (float(SQRT2), True, False, torch.float32)
    for dtype in (torch.bfloat16, torch.float16, torch.float32):
        xd = _input((4, 6, 8), dtype=dtype)
        assert gelu.bias_gelu(xd, torch.zeros(8), *args).shape == (4, 6, 8)
        assert gelu.bias_gelu(xd, None, *args).dtype == torch.float32
        got = gelu.channel_ln_gelu(xd, torch.ones(6), torch.zeros(6), 1e-5, *args)
        assert got.shape == (4, 6, 8) and bool(torch.isfinite(got).all())
    assert gelu.bias_gelu(x, torch.zeros(1), *args).shape == (4, 6, 8)
    big = torch.zeros(1, gelu.MAX_CHANNELS + 1, 4, dtype=torch.bfloat16)
    wide = torch.ones(gelu.MAX_CHANNELS + 1)
    refused = {
        "float64 x": lambda: gelu.bias_gelu(x.double(), None, *args),
        "bf16 bias": lambda: gelu.bias_gelu(x, torch.zeros(8, dtype=torch.bfloat16), *args),
        "bias of another width": lambda: gelu.bias_gelu(x, torch.zeros(6), *args),
        "a matrix bias": lambda: gelu.bias_gelu(x, torch.zeros(6, 8), *args),
        "f16 store": lambda: gelu.bias_gelu(x, None, *args[:3], torch.float16),
        "scale not [C]": lambda: gelu.channel_ln_gelu(x, torch.ones(8), torch.ones(8), 1e-5,
                                                      *args),
        "x not 3-D": lambda: gelu.channel_ln_gelu(x[0], torch.ones(6), torch.ones(6), 1e-5,
                                                  *args),
        "wider than the kernel": lambda: gelu.channel_ln_gelu(big, wide, wide, 1e-5, *args),
        "float64 shift": lambda: gelu.channel_ln_gelu(x, torch.ones(6),
                                                      torch.ones(6, dtype=torch.float64),
                                                      1e-5, *args),
    }
    for what, call in refused.items():
        with pytest.raises(ValueError):
            call()
            pytest.fail(what)


# -- on the card ---------------------------------------------------------------------


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gelu.reset_launches()
    return torch.device("cuda", 0)


def _kernel_and_body(prologue, dev, x, bf16_out, seed=0):
    """The ``_FusedGelu`` lowering (the kernel) and its interpreted body,
    under ``fast`` on the card, over ``x`` and operands drawn from ``seed``;
    the body's float32 result rounded as the node's readers round it."""
    data, _, _ = _chain_graph(prologue)
    model = timp.import_onnx(data)
    (node,) = _gelus(model)
    g = torch.Generator(device=dev).manual_seed(seed)
    width = x.shape[1] if prologue == "channel_ln" else x.shape[-1]
    env = {"sqrt2": SQRT2, "one": np.float32(1.0), "half": np.float32(0.5), node.input[0]: x}
    if prologue == "bias":
        env["b"] = 0.02 * torch.randn(width, device=dev, generator=g)
    elif prologue == "channel_ln":
        env["s"] = 1.0 + 0.1 * torch.randn(width, device=dev, generator=g)
        env["sh"] = 0.1 * torch.randn(width, device=dev, generator=g)
    ctx = ops.OpContext("_FusedGelu", dict(node.attrs, bf16_out=bf16_out), precision="fast",
                        env=env, device=dev)
    with torch.inference_mode():
        (got,) = ops.get_lowering("_FusedGelu")(ctx, *[env[i] for i in node.input])
        (want,) = ops._run_subgraph(ctx, node.attrs["body"])
    return got, want.to(got.dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("prologue,shape,bf16_out", [
    ("bias", (128, 249, 4096), 1),   # the FFN, read by ff2's MatMul
    ("bias", (128, 249, 4096), 0),
    ("bare", (128, 1024, 249), 0),   # the positional conv's, a slice of 250 frames
])
def test_bias_and_bare_kernels_match_the_chain_bit_for_bit(dev, prologue, shape, bf16_out):
    g = torch.Generator(device=dev).manual_seed(26)
    if prologue == "bare":
        x = torch.randn(shape[:-1] + (shape[-1] + 1,), device=dev, generator=g)
        x = x.to(torch.bfloat16)[..., :-1]
    else:
        x = torch.randn(shape, device=dev, generator=g).to(torch.bfloat16)
    got, want = _kernel_and_body(prologue, dev, x, bf16_out)
    torch.cuda.synchronize()
    assert gelu.LAUNCHES[prologue] == 1
    assert got.dtype == (torch.bfloat16 if bf16_out else torch.float32)
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("frames", ENCODER_FRAMES)
def test_channel_ln_kernel_matches_the_chain(dev, frames):
    """[128, 512, T] for every encoder T, bf16 out (layers 0-5) and float32
    (layer 6, read by proj.ln), checked on the same input. The kernel sums
    the statistics in another order than ATen's mean and variance
    reductions: where a float32 mean or variance lies within a few ulps of
    a bf16 rounding boundary, its bf16 value can move by one ulp, and the
    frame's normalized values with it (by about one bf16 ulp of the largest,
    two after the roundings that follow). So: frames that differ at all are
    at most 0.1 %, and no element is off by more than 2^-5 of the largest
    magnitude."""
    g = torch.Generator(device=dev).manual_seed(frames)
    # A conv output's scale, with an offset per frame that the mean removes.
    x = (torch.randn(128, 512, frames, device=dev, generator=g)
         + 0.5 * torch.randn(128, 1, frames, device=dev, generator=g)).to(torch.bfloat16)
    for bf16_out in (1, 0):
        got, want = _kernel_and_body("channel_ln", dev, x, bf16_out)
        assert got.dtype == (torch.bfloat16 if bf16_out else torch.float32)
        diff = (got.float() - want.float()).abs()
        frames_off = (diff.amax(dim=1) > 0).float().mean().item()
        assert frames_off <= 1e-3, frames_off
        assert diff.max().item() <= 2 ** -5 * want.float().abs().max().item()
        del got, want, diff
    torch.cuda.synchronize()
    assert gelu.LAUNCHES["channel_ln"] == 2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float16, torch.float32], ids=["f16", "f32"])
def test_the_kernels_take_float16_and_float32_activations(dev, dtype):
    """The activation types other than bf16 that the bfloat16 policies can
    hand the node (a float32 graph input, a float16 model's tensor). The
    bias and bare forms bit for bit, both stores. channel_ln stores
    float32: a float16 activation's statistics round to float16 as bf16's
    round to bf16, so a flipped rounding moves a frame by about one float16
    ulp of its largest values, within 2^-8 of the largest magnitude; a
    float32 activation's statistics are not rounded, so the other summation
    order moves every frame by a few float32 ulps, within 2^-16."""
    g = torch.Generator(device=dev).manual_seed(27)
    x = torch.randn(32, 249, 4096, device=dev, generator=g).to(dtype)
    for bf16_out in (1, 0):
        got, want = _kernel_and_body("bias", dev, x, bf16_out)
        assert torch.equal(got, want)
    x = torch.randn(32, 1024, 250, device=dev, generator=g).to(dtype)[..., :-1]
    got, want = _kernel_and_body("bare", dev, x, 0)
    assert torch.equal(got, want)
    x = (torch.randn(32, 512, 3999, device=dev, generator=g)
         + 0.5 * torch.randn(32, 1, 3999, device=dev, generator=g)).to(dtype)
    got, want = _kernel_and_body("channel_ln", dev, x, 0)
    diff = (got - want).abs().max().item()
    assert diff <= (2 ** -8 if dtype == torch.float16 else 2 ** -16) * want.abs().max().item()
    torch.cuda.synchronize()
    assert gelu.LAUNCHES == {"bias": 2, "bare": 1, "channel_ln": 1}


def _emb_err_limit() -> float:
    cfg = Path(__file__).resolve().parents[1] / "benchmark" / "configs" / \
        "aves_hubert_large_fast.json"
    return float(json.loads(cfg.read_text())["row_limits"]["emb_err"])


@pytest.mark.cuda
def test_the_tiny_model_streams_as_unfused_and_counts_its_launches(dev, tiny, monkeypatch):
    """The tiny model streamed through ``embed_samples`` under ``fast``: each
    row's largest embedding difference from the unfused stream within the
    benchmark's ``emb_err`` of the row's largest entry, and each captured
    tile graph counting one launch per chain: 2 bias, 7 channel_ln, 1 bare."""
    import birdnet_tpu_torch as tbt

    def classifier():
        return (tbt.Classifier.builder().model_path(tiny)
                .labels([f"s{i}" for i in range(SPECIES)]).precision("fast").build())

    rng = np.random.default_rng(26)
    pcm = (rng.normal(size=12 * S) * 3000).clip(-32768, 32767).astype(np.int16)
    clf = classifier()
    emb, _ = clf.embed_samples(pcm)
    graphs = [tally for program in clf._streaming_engine().programs.values()
              for tally in program.launches]
    assert graphs
    for tally in graphs:
        forms = [key for launches, key in tally if launches is ops.GELU_LAUNCHES]
        assert sorted(forms) == ["bare"] + ["bias"] * 2 + ["channel_ln"] * 7
    monkeypatch.setattr(fuse_gelu, "fuse_gelu", lambda graph, tensors: (0, 0))
    want, _ = classifier().embed_samples(pcm)
    got, want = np.asarray(emb, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape == (12, 64)
    rows = np.abs(got - want).max(axis=1) / np.abs(want).max(axis=1)
    assert rows.max() <= _emb_err_limit(), rows
