"""The port's mesh sharding (birdnet_tpu_torch/parallel/sharding.py) against
the JAX package's: the same meshes, partition specs, species pads and
refusals, and the same sharded answers at fp32 on the same numpy inputs
(the JAX side on the conftest's 8 virtual CPU devices, the port on a mesh
of host cells), within the JAX tests' tolerances: logits rtol 1e-4 / atol
1e-5, indices exact, confidences and embeddings 1e-4."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import birdnet_tpu.parallel.sharding as JS  # noqa: E402
import birdnet_tpu_torch.parallel.sharding as TS  # noqa: E402
from birdnet_tpu.compiler import importer as jimp  # noqa: E402
from birdnet_tpu.detection import detect_model_type  # noqa: E402
from birdnet_tpu_torch.detection import detect_model_type as t_detect  # noqa: E402
from birdnet_tpu.errors import ModelLoadError as JModelLoadError  # noqa: E402
from birdnet_tpu.onnx import proto as P  # noqa: E402
from birdnet_tpu_torch.compiler import importer as timp  # noqa: E402
from birdnet_tpu_torch.errors import ModelLoadError as TModelLoadError  # noqa: E402
from _torch_threads import torch_threads  # noqa: E402,F401

CPU = torch.device("cpu")
TOL = dict(rtol=1e-4, atol=1e-5)


def _family(name):
    """(JAX import, port import, JAX config, port config) of a tiny model: v2.4 with 10 species (padded
    to 12 over a 4-way model axis), v3.0 with dual outputs, Perch at the
    real 14,795-class head (padded to 14,796)."""
    from birdnet_tpu.models import birdnet_v24, birdnet_v30, perch_v2

    model = {
        "v24": lambda: birdnet_v24.build_model(width=0.1, depth=1, num_species=10),
        "v30": lambda: birdnet_v30.build_model(width=0.1, depth=1, num_species=24,
                                               embedding_dim=16),
        "perch": lambda: perch_v2.build_model(width=0.1, depth=1, num_species=14795,
                                              embedding_dim=40),
    }[name]()
    return _both(P.encode_model(model))


def _both(data):
    j, t = jimp.import_onnx(data), timp.import_onnx(data)
    return j, t, detect_model_type(*j.detection_shapes()), t_detect(*t.detection_shapes())


@pytest.fixture(scope="module")
def families():
    return {name: _family(name) for name in ("v24", "v30", "perch")}


def _meshes(shape):
    n = shape[0] * shape[1]
    return JS.make_mesh(shape=shape), TS.make_mesh([CPU] * n, shape=shape)


@pytest.mark.parametrize("n", range(1, 9))
def test_make_mesh_shapes_match_jax(n):
    mine = TS.make_mesh([CPU] * n)
    theirs = JS.make_mesh(devices=jax.devices()[:n])
    assert mine.shape == dict(theirs.shape)
    assert mine.axis_names == tuple(theirs.axis_names)
    assert mine.devices.shape == theirs.devices.shape


def test_make_mesh_default_devices():
    """``devices=None``: the default platform's devices; the host alone under
    set_platform("cpu"), and RuntimeInitError on the card platform without
    CUDA."""
    from birdnet_tpu_torch import runtime
    from birdnet_tpu_torch.errors import RuntimeInitError

    runtime.set_platform("cpu")
    try:
        mesh = TS.make_mesh()
    finally:
        runtime.set_platform("cuda")
    assert mesh.shape == {"data": 1, "model": 1} and mesh.devices[0, 0] == CPU
    if torch.cuda.is_available():
        assert TS.make_mesh().size == torch.cuda.device_count()
    else:
        with pytest.raises(RuntimeInitError):
            TS.make_mesh()


@pytest.mark.parametrize("model_size", [1, 2, 4])
@pytest.mark.parametrize("name", ["v24", "v30", "perch"])
def test_param_specs_match_jax(families, name, model_size):
    j, t, jcfg, cfg = families[name]
    theirs = JS.param_specs(j.params, jcfg, model_size=model_size)
    mine = TS.param_specs(t.params, cfg, model_size=model_size)
    assert mine == {k: tuple(v) for k, v in theirs.items()}


@pytest.mark.parametrize("model_size", [2, 4, 5])
@pytest.mark.parametrize("name", ["v24", "perch"])
def test_species_pad_matches_jax(families, name, model_size):
    j, t, jcfg, cfg = families[name]
    theirs, n_theirs = JS._species_pad(j.params, jcfg, model_size)
    mine, n_mine = TS._species_pad(t.params, cfg, model_size)
    assert n_mine == n_theirs
    assert sorted(mine) == sorted(theirs)
    for k in mine:
        np.testing.assert_array_equal(mine[k], theirs[k])


def _head_graph(n, tail):
    """x [1, 64] → MatMul w [64, n] (+ b) → ``tail`` nodes; the JAX tests'
    custom heads."""
    rng = np.random.default_rng(0)
    nodes = [P.make_node("MatMul", ["x", "w"], ["h"]),
             P.make_node("Add", ["h", "b"], ["logits"])]
    last = "logits"
    for i, (op, attrs) in enumerate(tail):
        nodes.append(P.make_node(op, [last], [f"t{i}"], **attrs))
        last = f"t{i}"
    graph = P.GraphProto(
        name="head",
        node=nodes,
        initializer=[P.TensorProto.from_numpy(rng.normal(size=(64, n)).astype(np.float32), name="w"),
                     P.TensorProto.from_numpy(rng.normal(size=(n,)).astype(np.float32), name="b")],
        input=[P.make_value_info("x", P.DataType.FLOAT, [1, 64])],
        output=[P.make_value_info(last, P.DataType.FLOAT, [1, n])],
    )
    data = P.encode_model(P.make_model(graph))
    j, t = jimp.import_onnx(data), timp.import_onnx(data)
    return j, t, detect_model_type([1, 144000], [[1, n]]), t_detect([1, 144000], [[1, n]])


@pytest.mark.parametrize("tail", [[("Softmax", {"axis": -1})], [("ReduceMax", {"keepdims": 1})],
                                  [("Sigmoid", {}), ("ArgMax", {"axis": -1})]],
                         ids=["softmax", "reducemax", "sigmoid-argmax"])
def test_pad_refusals_match_jax(tail):
    """A padded head that feeds a cross-position op is refused with the same
    error type by both packages; a divisible model axis pads nothing and
    refuses nothing."""
    j, t, jcfg, cfg = _head_graph(15, tail)
    with pytest.raises(JModelLoadError, match="species-pad"):
        JS._species_pad_model(j, jcfg, 4)
    with pytest.raises(TModelLoadError, match="species-pad"):
        TS._species_pad_model(t, cfg, 4)
    mesh = TS.make_mesh([CPU] * 4, shape=(1, 4))
    with pytest.raises(TModelLoadError, match="species-pad"):
        TS.make_sharded_program(t, cfg, mesh)
    same, n_same = TS._species_pad_model(t, cfg, 5)
    assert n_same == 15 and same is t


@pytest.mark.parametrize("tail", [[("Sigmoid", {})], [("Relu", {}), ("Sigmoid", {})]],
                         ids=["sigmoid", "relu-sigmoid"])
def test_positionwise_tail_pads_as_jax(tail):
    j, t, jcfg, cfg = _head_graph(15, tail)
    jp, jn = JS._species_pad_model(j, jcfg, 4)
    tp, tn = TS._species_pad_model(t, cfg, 4)
    assert tn == jn == 16
    for k in jp.params:
        np.testing.assert_array_equal(tp.params[k], jp.params[k])
    head = TS._head_partition(t, cfg, TS.make_mesh([CPU] * 4, shape=(1, 4)), "model", None)
    assert head.sharded and head.n_padded == 16
    assert head.specs["w"] == (None, "model")


def _jax_program(j, jcfg, shape, x, **kw):
    mesh = JS.make_mesh(shape=shape)
    fn, shard_inputs = JS.make_sharded_program(j, jcfg, mesh, **kw)
    return [np.asarray(o) for o in fn(*shard_inputs(j.params, x))]


def _port_program(t, cfg, shape, x, **kw):
    mesh = TS.make_mesh([CPU] * (shape[0] * shape[1]), shape=shape)
    fn, shard_inputs = TS.make_sharded_program(t, cfg, mesh, **kw)
    return [o.numpy() for o in fn(*shard_inputs(t.params, x))]


def _assert_same(mine, theirs):
    conf, idx, logits = mine[:3]
    np.testing.assert_allclose(logits, theirs[2], **TOL)
    np.testing.assert_array_equal(idx, theirs[1])
    np.testing.assert_allclose(conf, theirs[0], **TOL)
    if len(theirs) > 3:
        assert len(mine) == 4
        np.testing.assert_allclose(mine[3], theirs[3], **TOL)


@pytest.mark.parametrize("shape", [(8, 1), (4, 2), (2, 4)], ids=["8x1", "4x2", "2x4"])
@pytest.mark.parametrize("name", ["v24", "v30", "perch"])
def test_sharded_program_matches_jax(families, name, shape):
    """The sharded step on the same batch: v2.4 (10 species, padded to 12
    over 4), v3.0's dual outputs with embeddings, Perch's real 14,795-class
    head padded to 14,796; the head splits whenever the model axis is
    wider than 1, and no pad index ever wins."""
    j, t, jcfg, cfg = families[name]
    emb = name != "v24"
    x = np.random.default_rng(3).normal(size=(shape[0] * 2, cfg.sample_count)).astype(np.float32)
    kw = dict(top_k=5, with_embeddings=emb)
    mine = _port_program(t, cfg, shape, x, **kw)
    theirs = _jax_program(j, jcfg, shape, x, **kw)
    _assert_same(mine, theirs)
    assert mine[2].shape == (x.shape[0], cfg.num_species)
    assert int(mine[1].max()) < cfg.num_species
    mesh = TS.make_mesh([CPU] * (shape[0] * shape[1]), shape=shape)
    assert TS._head_partition(t, cfg, mesh, "model", None).sharded == (shape[1] > 1)


def test_sharded_program_species_mask_matches_jax(families):
    j, t, jcfg, cfg = families["perch"]
    mask = np.random.default_rng(5).random(cfg.num_species) < 0.01
    x = np.random.default_rng(6).normal(size=(4, cfg.sample_count)).astype(np.float32)
    kw = dict(top_k=5, species_mask=mask)
    mine = _port_program(t, cfg, (2, 4), x, **kw)
    _assert_same(mine, _jax_program(j, jcfg, (2, 4), x, **kw))
    assert mask[mine[1]].all()


def test_shard_params_match_jax_shards(families):
    """shard_params: each cell holds the block of the head that the JAX
    package's NamedSharding places on the same mesh coordinate (v3.0: 24
    species over a 2-way axis, no pad)."""
    j, t, jcfg, cfg = families["v30"]
    jmesh, tmesh = _meshes((4, 2))
    theirs = JS.shard_params(j.params, jcfg, jmesh)
    mine = TS.shard_params(t.params, cfg, tmesh)
    index = {dev: pos for pos, dev in np.ndenumerate(jmesh.devices)}
    split = 0
    for name, arr in theirs.items():
        for shard in arr.addressable_shards:
            got = mine[index[shard.device]][name].numpy()
            np.testing.assert_array_equal(got, np.asarray(shard.data))
        split += got.shape != t.params[name].shape
    assert split >= 2  # the head's weight and bias


def test_colliding_backbone_dims_stay_whole():
    """A backbone tensor whose dim equals num_species (tiny v2.4 with 16
    species has 16-channel convs) is not part of the head: only the Gemm's
    weight and bias split, and the answer equals the JAX package's."""
    from birdnet_tpu.models import birdnet_v24

    j, t, jcfg, cfg = _both(P.encode_model(
        birdnet_v24.build_model(width=0.1, depth=1, num_species=16)))
    mesh = TS.make_mesh([CPU] * 8, shape=(4, 2))
    head = TS._head_partition(t, cfg, mesh, "model", None)
    assert head.sharded
    assert sorted(k for k, s in head.specs.items() if s) == ["output_b", "output_w"]
    assert len([k for k, s in TS.param_specs(t.params, cfg, model_size=2).items() if s]) > 2
    x = np.random.default_rng(7).normal(size=(8, cfg.sample_count)).astype(np.float32)
    _assert_same(_port_program(t, cfg, (4, 2), x, top_k=5),
                 _jax_program(j, jcfg, (4, 2), x, top_k=5))


def test_head_that_cannot_split_stays_whole_and_matches_jax():
    """A softmax after the head with a species count that divides the model
    axis: the JAX package shards it (no pad, XLA partitions the softmax);
    the port keeps the head whole in every cell (``head_sharded`` False)
    and gives the same answer."""
    from birdnet_tpu_torch.parallel.engine import ShardedEngine

    j, t, jcfg, cfg = _head_graph(16, [("Softmax", {"axis": -1})])
    x = np.random.default_rng(8).normal(size=(8, 64)).astype(np.float32)
    mine = _port_program(t, cfg, (4, 2), x, top_k=5)
    theirs = _jax_program(j, jcfg, (4, 2), x, top_k=5)
    _assert_same(mine, theirs)
    mesh = TS.make_mesh([CPU] * 8, shape=(4, 2))
    assert not TS._head_partition(t, cfg, mesh, "model", None).sharded
    assert not ShardedEngine(t, cfg, mesh).head_sharded


def _stream_case(families, name, shape, step_frac, dtype, n_tiles=2):
    j, t, jcfg, cfg = families[name]
    tile = shape[0] * 2
    step = int(cfg.sample_count * step_frac)
    n_seg = n_tiles * tile
    rng = np.random.default_rng(9)
    audio = rng.normal(size=(n_seg - 1) * step + cfg.sample_count)
    audio = (audio * 3000).astype(np.int16) if dtype == "int16" else (audio * 0.1).astype(
        np.float32)
    kw = dict(n_tiles=n_tiles, step=step, tile=tile, top_k=4)
    jmesh, tmesh = _meshes(shape)
    jfn, jshard = JS.make_sharded_stream_program(j, jcfg, jmesh, **kw)
    theirs = [np.asarray(o) for o in jfn(*jshard(j.params, audio))]
    tfn, tshard = TS.make_sharded_stream_program(t, cfg, tmesh, **kw)
    mine = [o.numpy() for o in tfn(*tshard(t.params, audio))]
    assert mine[0].shape == (n_seg, 4)
    np.testing.assert_array_equal(mine[1], theirs[1])
    np.testing.assert_allclose(mine[0], theirs[0], **TOL)
    return mine


@pytest.mark.parametrize("dtype", ["float32", "int16"])
@pytest.mark.parametrize("step_frac,shape", [(1.0, (4, 2)), (0.5, (8, 1))],
                         ids=["step1-4x2", "step0.5-8x1"])
def test_sharded_stream_matches_jax(families, step_frac, shape, dtype):
    _stream_case(families, "v24", shape, step_frac, dtype)


def test_sharded_perch_stream_real_head_matches_jax(families):
    mine = _stream_case(families, "perch", (2, 4), 1.0, "int16")
    assert int(mine[1].max()) < 14795
