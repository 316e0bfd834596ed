"""The PyTorch port's copied modules, codec and importer against the JAX
package: byte-identical copies, the same decoded graphs and the same
import results, and a port that imports neither jax nor ml_dtypes."""

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
    "detection.py", "postprocess.py", "labels.py",
    "utils/__init__.py", "utils/export.py", "utils/audio_io.py",
    "compiler/optimize.py", "compiler/fuse_mbconv.py",
    "compiler/fuse_stage_prefix.py", "compiler/fuse_frontend.py",
    "compiler/_melbank.py",
    "models/__init__.py", "models/_builder.py", "models/birdnet_v24.py",
    "models/birdnet_v30.py", "models/perch_v2.py", "models/meta.py",
    "onnx/__init__.py",
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
        node=[P.make_node("Softmax", ["x"], ["y"])],
        initializer=[],
        input=[P.make_value_info("x", P.DataType.FLOAT, [1, 4])],
        output=[P.make_value_info("y", P.DataType.FLOAT, [1, 4])],
    )
    with pytest.raises(ModelLoadError, match="Softmax"):
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
        "             if k.split('.')[0] in ('jax', 'jaxlib', 'birdnet_tpu', 'triton'))\n"
        "print('BAD', bad)\n"
        "print('INT8', all(m in sys.modules for m in (\n"
        "    'birdnet_tpu_torch.compiler.quantize', 'birdnet_tpu_torch.ops.cuda.qconv')))\n"
    )
    assert "BAD []" in out and "INT8 True" in out


def test_codec_without_ml_dtypes():
    """With ml_dtypes blocked, the codec imports and decodes a float32
    model; a bf16 tensor raises a ModelLoadError naming the package."""
    out = _run_isolated(
        "import sys\n"
        "sys.modules['ml_dtypes'] = None\n"
        "import numpy as np\n"
        "from birdnet_tpu_torch.compiler.importer import import_onnx\n"
        "from birdnet_tpu_torch.errors import ModelLoadError\n"
        "from birdnet_tpu_torch.models import birdnet_v24\n"
        "from birdnet_tpu_torch.onnx import proto as P\n"
        "m = import_onnx(P.encode_model(birdnet_v24.build_model(\n"
        "    num_species=10, width=0.1, depth=1)))\n"
        "print('PARAMS', len(m.params))\n"
        "t = P.TensorProto(name='w', data_type=P.DataType.BFLOAT16, dims=[2],\n"
        "                  raw_data=b'\\x00\\x00\\x80\\x3f')\n"
        "try:\n"
        "    t.to_numpy()\n"
        "except ModelLoadError as e:\n"
        "    print('ERR', e)\n"
    )
    assert "PARAMS" in out and int(out.split("PARAMS")[1].split()[0]) > 0
    assert "ERR" in out and "ml_dtypes" in out


def test_bf16_wire_tensor_with_ml_dtypes():
    """Where ml_dtypes is present the codec behaves as the JAX package's."""
    raw = np.array([1.0, -2.5], np.float32).view(np.uint32) >> 16
    raw = raw.astype(np.uint16).tobytes()
    t = t_proto.TensorProto(name="w", data_type=t_proto.DataType.BFLOAT16,
                            dims=[2], raw_data=raw)
    j = j_proto.TensorProto(name="w", data_type=j_proto.DataType.BFLOAT16,
                            dims=[2], raw_data=raw)
    assert t.to_numpy().dtype == j.to_numpy().dtype
    np.testing.assert_array_equal(t.to_numpy(), j.to_numpy())
