"""The port's stage prefix on the CPU: B4's plain version
(birdnet_tpu_torch/ops/cuda/stage_prefix.py) against the JAX package's
Pallas megakernel in interpret mode, and the port's ``_FusedStagePrefix``
lowering against the JAX package's on the tiny v2.4 model. The CUDA kernel
itself runs only on the card (tests/test_torch_cuda.py, chip_smoke.py)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from birdnet_tpu.compiler import importer as jimp  # noqa: E402
from birdnet_tpu.ops.pallas import stage123 as j123  # noqa: E402
from birdnet_tpu_torch.compiler import importer as timp  # noqa: E402
from birdnet_tpu_torch.compiler import ops as tops  # noqa: E402
from birdnet_tpu_torch.compiler.fuse_mbconv import unfuse_mbconv  # noqa: E402
from birdnet_tpu_torch.compiler.fuse_stage_prefix import unfuse_stage_prefix  # noqa: E402
from birdnet_tpu_torch.models import birdnet_v24  # noqa: E402
from birdnet_tpu_torch.ops.cuda import stage_prefix as sp  # noqa: E402
from _torch_threads import torch_threads  # noqa: E402,F401

# tests/test_stage123.py's reduced-width six-block schedule (the real
# strides and residuals, channel counts shrunk for interpret mode).
SMALL_BLOCKS = (
    (32, 32, 8, 16, 1, False),
    (16, 16, 8, 16, 1, True),
    (16, 24, 8, 16, 2, False),
    (16, 24, 8, 16, 1, True),
    (16, 24, 8, 24, 2, False),
    (24, 32, 8, 24, 1, True),
)
# The full-width v2.4 prefix: (c_in, c_mid, c_se, c_out, stride, residual).
FULL_BLOCKS = (
    (32, 32, 8, 24, 1, False),
    (24, 24, 6, 24, 1, True),
    (24, 96, 24, 40, 2, False),
    (40, 160, 40, 40, 1, True),
    (40, 160, 40, 80, 2, False),
    (80, 320, 80, 80, 1, True),
)


def _weights(rng, blocks):
    """tests/test_stage123.py's random weights."""
    stem_w = rng.normal(size=(32, 1, 3, 3)).astype(np.float32) * 0.4
    stem_b = rng.normal(size=32).astype(np.float32) * 0.05
    bws = []
    for c_in, c_mid, c_se, c_out, _, _ in blocks:
        bws.append({
            "w1": rng.normal(size=(c_mid, c_in)).astype(np.float32) * (1.5 / np.sqrt(c_in)),
            "b1": rng.normal(size=c_mid).astype(np.float32) * 0.05,
            "wd": rng.normal(size=(c_mid, 1, 3, 3)).astype(np.float32) * 0.3,
            "bd": rng.normal(size=c_mid).astype(np.float32) * 0.05,
            "se1": rng.normal(size=(c_se, c_mid)).astype(np.float32) * (1.0 / np.sqrt(c_mid)),
            "bse1": rng.normal(size=c_se).astype(np.float32) * 0.05,
            "se2": rng.normal(size=(c_mid, c_se)).astype(np.float32) * (1.0 / np.sqrt(c_se)),
            "bse2": rng.normal(size=c_mid).astype(np.float32) * 0.05,
            "w3": rng.normal(size=(c_out, c_mid)).astype(np.float32) * (1.0 / np.sqrt(c_mid)),
            "b3": rng.normal(size=c_out).astype(np.float32) * 0.05,
        })
    return stem_w, stem_b, bws


def _both(n_blocks, fast_act, jdtype, tdtype):
    """(port [1, C, H', W'] float32, JAX the same) on one 96 x 511 image."""
    rng = np.random.default_rng(n_blocks)
    geoms = SMALL_BLOCKS[:n_blocks]
    stem_w, stem_b, bws = _weights(rng, geoms)
    img = rng.normal(size=(1, 1, 96, 511)).astype(np.float32) * 0.5
    jblocks = [j123.BlockGeom(*g) for g in geoms]
    y = j123.stage_stack_forward(
        j123.to_planes(img).astype(jdtype), stem_w, stem_b, bws, jblocks,
        fast_act=fast_act, compute_dtype=jdtype, interpret=True,
    )
    a = 4 // int(np.prod([g[4] for g in geoms]))
    want = np.asarray(j123.from_planes(y, a, a)).astype(np.float32)
    tables = sp.prepare_weights(stem_w, stem_b, bws, [sp.BlockGeom(*g) for g in geoms],
                                tdtype, "cpu")
    got = sp.stage_stack_forward(torch.from_numpy(img).to(tdtype), tables, fast_act)
    assert got.dtype == tdtype
    return got.float().numpy(), want


@pytest.fixture(autouse=True)
def _zero_launches():
    sp.reset_launches()
    yield
    assert sp.LAUNCHES == {"stage_stack_forward": 0}, (
        "a CPU tensor must take the plain version, never the kernel"
    )


@pytest.mark.parametrize("n_blocks", [1, 3, 6])
def test_plain_matches_jax_kernel_f32(n_blocks):
    """float32: tests/test_stage123.py's bound (atol 2e-4, rtol 1e-3)."""
    got, want = _both(n_blocks, False, jnp.float32, torch.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-3)


def test_plain_matches_jax_kernel_bf16_fast_act():
    """bf16 with fast_act: the same rounding points, so at most a few bf16
    ulps from sums in another order, <= 1e-2 of the largest magnitude."""
    got, want = _both(6, True, jnp.bfloat16, torch.bfloat16)
    assert got.shape == want.shape == (1, 24, 12, 64)
    assert np.abs(got - want).max() / np.abs(want).max() <= 1e-2


@pytest.mark.parametrize("width", [511, 512])
@pytest.mark.parametrize("schedule", ["full", "small"])
def test_launch_plan_fits_shared_memory(schedule, width):
    """The bfloat16 tensor-core plan at 96 x W, at full width and at the
    reduced SMALL_BLOCKS widths: every launch within the shared-memory
    budget; the MMA shapes zero-padded to 16 (the expand's K = c_in, the
    project's K = c_mid and N = c_out); the expand's recompute over the
    halo at most 1.2 times the image; tiles covering each output in whole
    depthwise runs; sizes halving at the stride-2 blocks."""
    geoms = FULL_BLOCKS if schedule == "full" else SMALL_BLOCKS
    blocks = [sp.BlockGeom(*g) for g in geoms]
    plan = sp.launch_plan(blocks, 96, width)
    assert [(p["ho"], p["wo"]) for p in plan] == [(48, 256)] * 2 + [(24, 128)] * 2 + [(12, 64)] * 2
    for g, p in zip(blocks, plan):
        assert p["smem_a"] == sp._mma_expand_smem(g.c_in, g.stride, p["th"], p["tw"], p["ch"],
                                                   p["cg"])
        assert p["smem_a"] <= sp._SMEM_BUDGET
        assert p["smem_b"] == sp._mma_project_smem(g.c_mid, g.c_out) <= sp._SMEM_BUDGET
        assert p["halo"] == sp.halo_factor(p["h"], p["w"], g.stride, p["th"], p["tw"])
        assert 1.0 <= p["halo"] <= 1.2
        assert p["ch"] in sp._MMA_CHUNKS and p["cg"] in sp._MMA_GROUPS and p["cg"] % p["ch"] == 0
        assert p["tw"] % sp._RUN == 0
        assert p["tiles"] * p["th"] * p["tw"] >= p["ho"] * p["wo"]
        for key, c in (("k_expand", g.c_in), ("k_project", g.c_mid), ("n_project", g.c_out)):
            assert p[key] % 16 == 0 and c <= p[key] < c + 16
    if schedule == "full":
        assert [p["k_expand"] for p in plan] == [32, 32, 32, 48, 48, 80]
        assert [p["k_project"] for p in plan] == [32, 32, 96, 160, 160, 320]
        assert [p["n_project"] for p in plan] == [32, 32, 48, 48, 80, 80]
    # The factor itself: one tile over the image covers it once; 4 x 4
    # tiles of an 8 x 8 image at stride 1 each cover 5 x 5 of it.
    assert sp.halo_factor(48, 256, 1, 48, 256) == 1.0
    assert sp.halo_factor(8, 8, 1, 4, 4) == (10 / 8) ** 2
    assert sp.halo_factor(48, 256, 2, 24, 128) == 1.0


def test_simt_launch_plan_fits_shared_memory():
    """The float32 SIMT plan at 96 x 511 (the kernels the f32 variant
    keeps): every launch within the budget, tiles in whole depthwise runs,
    one register tile per thread of launch (b)."""
    blocks = [sp.BlockGeom(*g) for g in FULL_BLOCKS]
    plan = sp.launch_plan(blocks, 96, 511, torch.float32)
    assert [(p["ho"], p["wo"]) for p in plan] == [(48, 256)] * 2 + [(24, 128)] * 2 + [(12, 64)] * 2
    for g, p in zip(blocks, plan):
        assert sp._expand_dw_smem(g.c_in, g.stride, p["th"], p["tw"]) <= sp._SMEM_BUDGET
        assert sp._project_smem(g.c_mid, g.c_se, g.c_out, p["p"]) <= sp._SMEM_BUDGET
        assert p["tw"] % sp._RUN == 0 and p["p"] % sp._PX == 0
        assert (p["p"] // sp._PX) * -(-g.c_out // sp._CH) <= sp._THREADS
        assert p["tiles"] * p["th"] * p["tw"] >= p["ho"] * p["wo"]


def test_wrapper_rejects_what_the_kernel_does_not_take():
    rng = np.random.default_rng(0)
    stem_w, stem_b, bws = _weights(rng, SMALL_BLOCKS[:2])
    tables = sp.prepare_weights(stem_w, stem_b, bws,
                                [sp.BlockGeom(*g) for g in SMALL_BLOCKS[:2]],
                                torch.bfloat16, "cpu")
    with pytest.raises(TypeError):
        sp.stage_stack_forward(torch.zeros(1, 1, 96, 511), tables)
    with pytest.raises(ValueError):
        sp.stage_stack_forward(torch.zeros(1, 2, 96, 511, dtype=torch.bfloat16), tables)
    with pytest.raises(TypeError):
        sp.prepare_weights(stem_w, stem_b, bws, [sp.BlockGeom(*g) for g in SMALL_BLOCKS[:2]],
                           torch.float16, "cpu")


# ---------------------------------------------------------------------------
# the _FusedStagePrefix lowering on the tiny v2.4 model (strides 1, 2, 2)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny_bytes():
    from birdnet_tpu_torch.onnx import proto as P

    return P.encode_model(birdnet_v24.build_model(num_species=10, width=0.1, depth=1, seed=0))


@pytest.fixture(scope="module")
def audio():
    rng = np.random.default_rng(7)
    return (rng.normal(size=(2, birdnet_v24.SAMPLE_COUNT)) * 0.1).astype(np.float32)


def _port_fast(model, audio):
    fwd = timp.make_forward(model, "fast", "cpu")
    return fwd(timp.params_to_torch(model.params, "cpu"), torch.from_numpy(audio))[0].float().numpy()


@pytest.mark.parametrize("split", [None, "1", "2"])
def test_lowering_matches_jax_at_split(tiny_bytes, audio, split, monkeypatch):
    """The port's lowering (B4's plain version, then the interpreted rest)
    against the JAX package's kernel in interpret mode, both frontends on
    their kernels: the JAX package's own 5e-2 scaled bound
    (tests/test_fuse_stage_prefix.py)."""
    monkeypatch.setenv("BIRDNET_STAGE123_INTERPRET", "1")
    monkeypatch.setenv("BIRDNET_FRONTEND_INTERPRET", "1")
    if split is None:
        monkeypatch.delenv("BIRDNET_STAGE123_SPLIT", raising=False)
    else:
        monkeypatch.setenv("BIRDNET_STAGE123_SPLIT", split)
    calls = []
    plain = sp.stage_stack_forward_plain
    monkeypatch.setattr(sp, "stage_stack_forward_plain",
                        lambda img, w, fast: calls.append(len(w.blocks)) or plain(img, w, fast))
    j = jimp.import_onnx(tiny_bytes)
    want = np.asarray(jimp.make_forward(j, "fast")(j.params, audio)[0], np.float32)
    got = _port_fast(timp.import_onnx(tiny_bytes), audio)
    assert calls == [3 if split is None else int(split)]
    assert np.all(np.isfinite(got))
    assert np.abs(got - want).max() / np.abs(want).max() < 5e-2


def test_split_zero_is_the_body(tiny_bytes, audio, monkeypatch):
    """Split 0 interprets ``body``: bitwise the unfused graph's output."""
    monkeypatch.setenv("BIRDNET_STAGE123_SPLIT", "0")
    monkeypatch.setattr(sp, "stage_stack_forward_plain", None)  # must not run
    got = _port_fast(timp.import_onnx(tiny_bytes), audio)
    plain = timp.import_onnx(tiny_bytes)
    unfuse_stage_prefix(plain.graph)
    unfuse_mbconv(plain.graph)
    np.testing.assert_array_equal(got, _port_fast(plain, audio))


def test_wide_image_interprets_body(tiny_bytes, monkeypatch):
    """A 96 x 568 mel image (v3.0's frame count) is outside the kernel's
    envelope: the lowering interprets ``body``, bitwise."""
    monkeypatch.delenv("BIRDNET_STAGE123_SPLIT", raising=False)
    monkeypatch.setattr(sp, "stage_stack_forward_plain", None)  # must not run
    model = timp.import_onnx(tiny_bytes)
    node = next(n for n in model.graph.node if n.op_type == "_FusedStagePrefix")
    env = dict(timp.consts_to_device(model.consts, "cpu"))
    env.update(timp.params_to_torch(model.params, "cpu"))
    x = torch.from_numpy(np.random.default_rng(1).normal(size=(1, 1, 96, 568))
                         .astype(np.float32)).to(torch.bfloat16)
    env[node.input[0]] = x
    ctx = tops.OpContext(node.op_type, node.attrs, model.opset, "fast", node.name,
                         1, env=env, out_names=node.output)
    with torch.inference_mode():
        got = tops.get_lowering(node.op_type)(ctx, *[env[i] for i in node.input])[0]
        want = tops._run_subgraph(ctx, node.attrs["body"])[0]
    assert got.shape[-1] == 71
    assert torch.equal(got, want)
