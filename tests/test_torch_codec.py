"""The PyTorch port's copied modules, codec and importer against the JAX
package: byte-identical copies, the same decoded graphs and the same
import results, and a port that imports neither jax nor ml_dtypes."""

import ast
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from birdnet_tpu.compiler import importer as j_importer  # noqa: E402
from birdnet_tpu.onnx import proto as j_proto  # noqa: E402
from birdnet_tpu_torch.compiler import importer as t_importer  # noqa: E402
from birdnet_tpu_torch.errors import ModelLoadError  # noqa: E402
from birdnet_tpu_torch.models import birdnet_v24  # noqa: E402
from birdnet_tpu_torch.onnx import proto as t_proto  # noqa: E402

REPO = Path(__file__).resolve().parents[1]

# Modules the port carries as byte-identical copies (birdnet_tpu_torch's
# package docstring lists them).
COPIES = [
    "errors.py", "types.py", "_demux.py", "inference_options.py",
    "detection.py", "postprocess.py", "labels.py", "testutil.py",
    "utils/__init__.py", "utils/export.py",
    "compiler/optimize.py", "compiler/fuse_mbconv.py",
    "compiler/fuse_stage_prefix.py", "compiler/fuse_frontend.py",
    "compiler/_melbank.py", "compiler/functions.py",
    "models/__init__.py", "models/_builder.py", "models/birdnet_v24.py",
    "models/birdnet_v30.py", "models/perch_v2.py", "models/meta.py",
    "onnx/__init__.py", "serve/client.py",
]
# The one edit a copy carries: the docstring of models/_builder.py names
# the upstream checkout's blob list by file name instead of by an absolute
# path. The comparison masks that reference in both files.
_BLOB_LIST_REF = re.compile(rb"see( its)?\n\S*\.MISSING_LARGE_BLOBS\)")


@pytest.mark.parametrize("rel", COPIES)
def test_copy_is_byte_identical(rel):
    src = (REPO / "birdnet_tpu" / rel).read_bytes()
    dst = (REPO / "birdnet_tpu_torch" / rel).read_bytes()
    if rel == "models/_builder.py":
        src, n_src = _BLOB_LIST_REF.subn(b"", src)
        dst, n_dst = _BLOB_LIST_REF.subn(b"", dst)
        assert n_src == n_dst == 1
    assert dst == src, f"birdnet_tpu_torch/{rel} drifted from birdnet_tpu/{rel}"


# compiler/quantize.py is a copy with one function rewritten and one keyword
# added: _collect_absmax interprets the graph with the port's interpreter on
# an explicit device (the JAX package's runs jax on the host CPU), and
# quantize_model passes that device through. The comparison drops
# _collect_absmax from both files and the two device edits from the port's.
_QUANTIZE_DEVICE_EDITS = [
    (b'    device=None,\n) -> ImportedModel:', b") -> ImportedModel:"),
    (b"graph=graph, device=device)", b"graph=graph)"),
]


def _without_collect_absmax(src: bytes) -> bytes:
    start = src.index(b"def _collect_absmax(")
    end = src.index(b"def quantize_model(")
    assert start < end
    return src[:start] + src[end:]


def test_quantize_copy_differs_only_in_calibration():
    src = _without_collect_absmax((REPO / "birdnet_tpu/compiler/quantize.py").read_bytes())
    dst = _without_collect_absmax(
        (REPO / "birdnet_tpu_torch/compiler/quantize.py").read_bytes())
    for edit, original in _QUANTIZE_DEVICE_EDITS:
        assert dst.count(edit) == 1, edit
        dst = dst.replace(edit, original)
    assert dst == src, "birdnet_tpu_torch/compiler/quantize.py drifted"


# utils/audio_io.py is a copy whose native-library build writes a file of
# its own and renames it onto libwavio.so, so that processes importing the
# module at once never load a half-written library (the JAX package's
# build writes the final path directly). The comparison drops
# _maybe_build_native from both files.
def _without_native_build(src: bytes) -> bytes:
    start = src.index(b"def _maybe_build_native(")
    end = src.index(b"def _load_native(")
    assert start < end
    return src[:start] + src[end:]


def test_audio_io_copy_differs_only_in_native_build():
    src = (REPO / "birdnet_tpu/utils/audio_io.py").read_bytes()
    dst = (REPO / "birdnet_tpu_torch/utils/audio_io.py").read_bytes()
    assert b"os.replace(tmp, lib_path)" in dst
    assert _without_native_build(dst) == _without_native_build(src), \
        "birdnet_tpu_torch/utils/audio_io.py drifted outside _maybe_build_native"


# serve/batcher.py and serve/__init__.py are copies whose module docstrings
# describe the card (one CUDA graph per worker, pinned staging) in place of
# the TPU's compiled executable and donated buffers.
_SERVE_DOCSTRINGS = {
    "serve/batcher.py": (b'"""Dynamic request batching', b"from __future__ import annotations"),
    "serve/__init__.py": (b'"""Production serving', b"from .batcher import"),
}


@pytest.mark.parametrize("rel", sorted(_SERVE_DOCSTRINGS))
def test_serve_copy_differs_only_in_docstring(rel):
    regions = [_SERVE_DOCSTRINGS[rel]]
    src = (REPO / "birdnet_tpu" / rel).read_bytes()
    dst = (REPO / "birdnet_tpu_torch" / rel).read_bytes()
    assert _without_regions(dst, regions) == _without_regions(src, regions), \
        f"birdnet_tpu_torch/{rel} drifted from birdnet_tpu/{rel} outside its docstring"


# serve/server.py is a copy whose device handling is torch's: the module
# docstring, the runtime import, the server's name, the resampler's device,
# the listen backlog (the JAX server's stdlib default of 5 resets
# connections under 64 concurrent clients), the --provider and --warmup
# help, main() without the native-stderr filter with the provider mapping,
# the device or mesh request, the range filter's device and the warm-up's
# messages.
_SERVER_REGIONS = [
    (b'"""HTTP inference server', b"from __future__ import annotations"),
    (b"    SpeciesListError,\n)\n", b"from ..types import Prediction"),
    (b"    server_version = ", b'    protocol_version = "HTTP/1.1"'),
    (b"            samples = resample_audio(\n", b"        return samples\n"),
    (b"    return samples, rate\n", b"def make_server("),
    (b"    shared classifier + batcher.", b"    server.daemon_threads = True"),
    (b'    p.add_argument("--port", type=int', b'    p.add_argument("--precision"'),
    (b'        "--warmup",\n', b'    p.add_argument("-v", "--verbose"'),
    (b"def main(argv=None) -> int:", b"    builder = (\n        Classifier.builder()"),
    (b"        builder = builder.precision(args.precision)\n", b"    species_wanted = None\n"),
    (b"            .from_classifier_labels(classifier.labels)\n",
     b"    server = make_server(\n        classifier,"),
    (b"    if args.warmup:\n", b"    host, port = server.server_address[:2]"),
]


def test_server_copy_differs_only_in_device_handling():
    src = (REPO / "birdnet_tpu/serve/server.py").read_bytes()
    dst = (REPO / "birdnet_tpu_torch/serve/server.py").read_bytes()
    assert _without_regions(dst, _SERVER_REGIONS) == _without_regions(src, _SERVER_REGIONS), \
        "birdnet_tpu_torch/serve/server.py drifted from birdnet_tpu/serve/server.py " \
        "outside its device regions"


# cli.py is a copy whose device handling is torch's. Each region below,
# from its first marker to the next occurrence of its second, may differ
# (the module docstring, the provider list and its help, the GPU batch-size
# and profiler help, --coordinator's help (a torch.distributed address),
# --list-providers, the runtime and device resolution around the
# multi-host block, the device or mesh request, the batch context's
# messages, the range filter's and the resampler's device, main() without
# the native-stderr filter); everything outside them, the multi-host block
# included, must equal the JAX package's file byte for byte once the one
# edit below is undone: the port resolves its device where the JAX CLI
# initializes its runtime.
_CLI_REGIONS = [
    (b'"""birdnet-analyze CLI', b"from __future__ import annotations"),
    (b"DEFAULT_ACCEL_BATCH_SIZE = 32", b"\n\n\ndef build_parser"),
    (b'        "--provider",\n', b'    p.add_argument("-t", "--timeout"'),
    (b'        "--profile",\n', b"    return p\n"),
    (b"def list_providers_and_exit() -> int:", b"def inspect_model_and_exit("),
    (b'        "--coordinator",\n', b'    p.add_argument("--num-processes"'),
    (b"    from . import (\n        CancellationToken,",
     b"    total_files = len(audio_files)\n"),
    (b'    _debug(args.verbose, f"Runtime initialized in',
     b"    model_type_override = parse_model_type"),
    (b'    _debug(args.verbose, f"Building classifier on', b"    builder = (\n"),
    (b"        builder = builder.int8(calibration_segments=first[0])\n",
     b"    species_wanted = None\n"),
    (b"            batch_context = classifier.create_batch_context(batch_size)",
     b'        f"Model: {model_name}'),
    (b"            .from_classifier_labels(classifier.labels)\n",
     b"        location_scores = range_filter.predict("),
    (b"                out_dtype=np.int16 if use_stream else np.float32,\n",
     b"            sample_rate = config.sample_rate\n"),
    (b"def main(argv=None) -> int:", b'if __name__ == "__main__":'),
]


def _without_regions(src: bytes, regions) -> bytes:
    for i, (start, end) in enumerate(regions):
        assert src.count(start) == 1, start
        lo = src.index(start)
        hi = src.index(end, lo + len(start))
        src = src[:lo] + b"<region %d>" % i + src[hi:]
    return src


_CLI_DEVICE_EDIT = (b"    device = resolve_device(device_request)\n    _debug(args.verbose, f\"Runtime",
                    b"    init_runtime()\n    _debug(args.verbose, f\"Runtime")


def test_cli_copy_differs_only_in_device_handling():
    src = (REPO / "birdnet_tpu/cli.py").read_bytes()
    dst = (REPO / "birdnet_tpu_torch/cli.py").read_bytes()
    edit, original = _CLI_DEVICE_EDIT
    assert dst.count(edit) == 1 and src.count(original) == 1
    dst = dst.replace(edit, original)
    assert _without_regions(dst, _CLI_REGIONS) == _without_regions(src, _CLI_REGIONS), \
        "birdnet_tpu_torch/cli.py drifted from birdnet_tpu/cli.py outside its device regions"


# parallel/multihost.py is a copy whose process group is torch.distributed's
# (gloo): it may differ in its module docstring, distributed_init,
# shard_files's rank lookup and _allgather_results;
# analyze_files_distributed and everything else equal the JAX file.
_MULTIHOST_REGIONS = [
    (b'"""Multi-host', b"from __future__ import annotations"),
    (b"def distributed_init(", b"def shard_files("),
    (b"analyzed exactly once).\"\"\"\n", b"    return [f for i, f in enumerate(files)"),
]


def test_multihost_copy_differs_only_in_torch_distributed():
    def body(rel):
        src = (REPO / rel).read_bytes()
        return _without_regions(src[:src.index(b"def _allgather_results(")], _MULTIHOST_REGIONS)

    assert body("birdnet_tpu_torch/parallel/multihost.py") == \
        body("birdnet_tpu/parallel/multihost.py"), \
        "birdnet_tpu_torch/parallel/multihost.py drifted outside its torch.distributed regions"
    dst = (REPO / "birdnet_tpu_torch/parallel/multihost.py").read_text()
    assert 'init_process_group(\n            "gloo"' in dst and "import jax" not in dst


# device_config.py is a copy whose docstrings and comments give the fields'
# CUDA meanings and whose TPUConfig.apply sets the allocator's share of the
# card (the JAX one sets XLA's preallocation variable). The comparison is of
# the two modules' syntax trees without docstrings (comments never reach
# them) and without that method.
def _config_tree(rel: str) -> str:
    tree = ast.parse((REPO / rel).read_text())
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if (isinstance(body, list) and body and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)):
            node.body = body[1:] or [ast.Pass()]
    tpu = next(n for n in tree.body if isinstance(n, ast.ClassDef) and n.name == "TPUConfig")
    tpu.body = [n for n in tpu.body
                if not (isinstance(n, ast.FunctionDef) and n.name == "apply")]
    return ast.dump(tree)


def test_device_config_copy_differs_only_in_cuda_meanings():
    src = (REPO / "birdnet_tpu_torch/device_config.py").read_text()
    assert "torch.cuda.set_per_process_memory_fraction(" in src
    assert _config_tree("birdnet_tpu_torch/device_config.py") == \
        _config_tree("birdnet_tpu/device_config.py"), \
        "birdnet_tpu_torch/device_config.py drifted outside its docstrings and TPUConfig.apply"


# utils/activation_diff.py is a copy whose capture_activations runs the
# port's interpreter eagerly on an explicit device (the JAX package's jits
# its own); layer_diffs and top_k_agreement are numpy and stay as they are.
def _without_capture(src: bytes) -> bytes:
    start = src.index(b"def capture_activations(")
    end = src.index(b"def layer_diffs(")
    assert start < end
    return src[:start] + src[end:]


def test_activation_diff_copy_differs_only_in_capture():
    src = (REPO / "birdnet_tpu/utils/activation_diff.py").read_bytes()
    dst = (REPO / "birdnet_tpu_torch/utils/activation_diff.py").read_bytes()
    assert b"interpret_graph(graph, imported.opset, precision, env" in dst
    assert b"import jax" not in dst
    assert _without_capture(dst) == _without_capture(src), \
        "birdnet_tpu_torch/utils/activation_diff.py drifted outside capture_activations"


def test_port_main_is_guarded():
    """The JAX package's __main__ calls main() on import; the port's runs it
    only as a script, so importing every module (the walk below) never
    starts the CLI."""
    src = (REPO / "birdnet_tpu_torch/__main__.py").read_text()
    assert 'if __name__ == "__main__":\n    sys.exit(main())' in src


@pytest.fixture(scope="module", params=["conv", "stft"])
def model_bytes(request):
    model = birdnet_v24.build_model(
        num_species=10, width=0.1, depth=1, seed=0, frontend=request.param
    )
    return t_proto.encode_model(model)


def _plain(v):
    """A codec value as plain Python, comparable across the two packages."""
    if hasattr(v, "to_numpy") and hasattr(v, "dims"):
        arr = v.to_numpy()
        return ("tensor", str(arr.dtype), arr.shape, arr.tobytes())
    if hasattr(v, "node") and hasattr(v, "initializer"):
        return ("graph", [_node(n) for n in v.node])
    if isinstance(v, (list, tuple)):
        return [_plain(x) for x in v]
    if isinstance(v, np.ndarray):
        return ("array", str(v.dtype), v.shape, v.tobytes())
    return v


def _node(n):
    return (n.op_type, n.domain, list(n.input), list(n.output),
            {k: _plain(v) for k, v in sorted(n.attrs.items())})


def test_decode_matches_jax_codec(model_bytes):
    t_model = t_proto.decode_model(model_bytes)
    j_model = j_proto.decode_model(model_bytes)
    assert [_node(n) for n in t_model.graph.node] == [
        _node(n) for n in j_model.graph.node
    ]
    t_inits = {t.name: t.to_numpy() for t in t_model.graph.initializer}
    j_inits = {t.name: t.to_numpy() for t in j_model.graph.initializer}
    assert t_inits.keys() == j_inits.keys()
    for name, arr in j_inits.items():
        assert t_inits[name].dtype == arr.dtype
        np.testing.assert_array_equal(t_inits[name], arr)


def test_reencode_matches_jax_codec(model_bytes):
    t_bytes = t_proto.encode_model(t_proto.decode_model(model_bytes))
    j_bytes = j_proto.encode_model(j_proto.decode_model(model_bytes))
    assert t_bytes == j_bytes == model_bytes


def test_import_matches_jax_importer(model_bytes):
    t = t_importer.import_onnx(model_bytes)
    j = j_importer.import_onnx(model_bytes)
    assert [_node(n) for n in t.graph.node] == [_node(n) for n in j.graph.node]
    assert any(n.op_type.startswith("_Fused") for n in t.graph.node)
    for mine, theirs in ((t.params, j.params), (t.consts, j.consts)):
        assert mine.keys() == theirs.keys()
        for name, arr in theirs.items():
            np.testing.assert_array_equal(mine[name], arr)
    assert (t.input_names, t.input_shapes) == (j.input_names, j.input_shapes)
    assert (t.output_names, t.output_shapes) == (j.output_names, j.output_shapes)


def test_unsupported_op_is_a_load_error():
    P = t_proto
    graph = P.GraphProto(
        name="g",
        node=[P.make_node("DecoderMaskedMultiHeadAttention", ["x"], ["y"],
                          domain="com.microsoft")],
        initializer=[],
        input=[P.make_value_info("x", P.DataType.FLOAT, [1, 4])],
        output=[P.make_value_info("y", P.DataType.FLOAT, [1, 4])],
    )
    with pytest.raises(ModelLoadError, match="com.microsoft.DecoderMaskedMultiHeadAttention"):
        t_importer.import_onnx(P.make_model(graph))


def _run_isolated(code: str) -> str:
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    return proc.stdout


def test_port_never_imports_jax():
    out = _run_isolated(
        "import importlib, pkgutil, sys\n"
        "import birdnet_tpu_torch as pkg\n"
        "import birdnet_tpu_torch.compiler.quantize\n"
        "import birdnet_tpu_torch.ops.cuda.qconv\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules\n"
        "             if k.split('.')[0] in ('jax', 'jaxlib', 'birdnet_tpu', 'triton',\n"
        "                                    'ml_dtypes'))\n"
        "print('BAD', bad)\n"
        "print('INT8', all(m in sys.modules for m in (\n"
        "    'birdnet_tpu_torch.compiler.quantize', 'birdnet_tpu_torch.ops.cuda.qconv')))\n"
        "print('NEW', all(m in sys.modules for m in (\n"
        "    'birdnet_tpu_torch.cli', 'birdnet_tpu_torch.__main__', 'birdnet_tpu_torch.rangefilter',\n"
        "    'birdnet_tpu_torch.checkpoint', 'birdnet_tpu_torch.batch_context',\n"
        "    'birdnet_tpu_torch.execution_providers', 'birdnet_tpu_torch.testutil',\n"
        "    'birdnet_tpu_torch.utils.profiling', 'birdnet_tpu_torch.serve.batcher',\n"
        "    'birdnet_tpu_torch.serve.server', 'birdnet_tpu_torch.serve.client',\n"
        "    'birdnet_tpu_torch.serve.__main__')))\n"
    )
    assert "BAD []" in out and "INT8 True" in out and "NEW True" in out


def test_codec_without_ml_dtypes():
    """With ml_dtypes blocked, the codec imports, decodes a float32 model,
    and decodes bfloat16, float8 and int4 tensors into the port's own
    representation (a CPU ``WireTensor``) without importing it."""
    out = _run_isolated(
        "import sys\n"
        "sys.modules['ml_dtypes'] = None\n"
        "import numpy as np\n"
        "from birdnet_tpu_torch.compiler.importer import import_onnx\n"
        "from birdnet_tpu_torch.models import birdnet_v24\n"
        "from birdnet_tpu_torch.onnx import proto as P\n"
        "m = import_onnx(P.encode_model(birdnet_v24.build_model(\n"
        "    num_species=10, width=0.1, depth=1)))\n"
        "print('PARAMS', len(m.params))\n"
        "t = P.TensorProto(name='w', data_type=P.DataType.BFLOAT16, dims=[2],\n"
        "                  raw_data=b'\\x00\\x00\\x80\\x3f').to_numpy()\n"
        "print('BF16', type(t).__name__, t.float().tolist())\n"
        "t = P.TensorProto(name='w', data_type=P.DataType.FLOAT8E4M3FN, dims=[2],\n"
        "                  int32_data=[0x38, 0xC0]).to_numpy()\n"
        "print('FP8', t.float().tolist())\n"
        "t = P.TensorProto(name='w', data_type=P.DataType.INT4, dims=[3],\n"
        "                  raw_data=b'\\x8f\\x07').to_numpy()\n"
        "print('INT4', type(t).__name__, t.tolist())\n"
        "print('MLD', 'ml_dtypes' in sys.modules and sys.modules['ml_dtypes'] is not None)\n"
    )
    assert "PARAMS" in out and int(out.split("PARAMS")[1].split()[0]) > 0
    assert "BF16 WireTensor [0.0, 1.0]" in out
    assert "FP8 [1.0, -2.0]" in out
    assert "INT4 Int4Tensor [-1, -8, 7]" in out
    assert "MLD False" in out


def test_bf16_wire_tensor_with_ml_dtypes():
    """Where ml_dtypes is present the port still decodes into its own
    representation; the values and the type's name are the JAX codec's."""
    raw = np.array([1.0, -2.5], np.float32).view(np.uint32) >> 16
    raw = raw.astype(np.uint16).tobytes()
    t = t_proto.TensorProto(name="w", data_type=t_proto.DataType.BFLOAT16,
                            dims=[2], raw_data=raw).to_numpy()
    j = j_proto.TensorProto(name="w", data_type=j_proto.DataType.BFLOAT16,
                            dims=[2], raw_data=raw).to_numpy()
    assert isinstance(t, t_proto.WireTensor)
    assert t_proto.WIRE_NAMES[t.data_type] == j.dtype.name
    np.testing.assert_array_equal(t.float().numpy(), j.astype(np.float32))


# The port's onnx/proto.py is the JAX codec with its modern-dtype section
# rewritten: bfloat16, float8 and int4/uint4 decode into the port's own
# WireTensor (a CPU torch tensor; Int4Tensor for the 4-bit types) instead
# of ml_dtypes arrays, and encode back from it. The comparison drops, from
# both files, the dtype tables between DataType and _DATA_LOCATION_EXTERNAL
# and the TensorProto / SparseTensorProto methods that read or write
# tensor payloads.
_PROTO_PAYLOAD_METHODS = {
    "TensorProto": {"to_numpy", "_to_wire", "_unpack_int4", "from_numpy",
                    "_from_wire"},
    "SparseTensorProto": {"to_dense", "_scatter"},
}


def _proto_without_dtype_section(path: Path) -> str:
    tree = ast.parse(path.read_text())
    body, skipping = [], False
    for node in tree.body:
        if isinstance(node, ast.ClassDef) and node.name == "DataType":
            body.append(node)
            skipping = True
            continue
        if skipping:
            names = [t.id for t in getattr(node, "targets", []) if isinstance(t, ast.Name)]
            if names == ["_DATA_LOCATION_EXTERNAL"]:
                skipping = False
            else:
                continue
        if isinstance(node, ast.ClassDef) and node.name in _PROTO_PAYLOAD_METHODS:
            drop = _PROTO_PAYLOAD_METHODS[node.name]
            node.body = [n for n in node.body
                         if not (isinstance(n, ast.FunctionDef) and n.name in drop)]
        body.append(node)
    tree.body = body
    return ast.dump(tree)


def test_proto_copy_differs_only_in_modern_dtypes():
    src = _proto_without_dtype_section(REPO / "birdnet_tpu" / "onnx" / "proto.py")
    dst = _proto_without_dtype_section(REPO / "birdnet_tpu_torch" / "onnx" / "proto.py")
    assert dst == src, (
        "birdnet_tpu_torch/onnx/proto.py drifted outside its modern-dtype "
        "section and its tensor payload methods"
    )
