"""The port's counterparts of scripts/serve_bench.py, scripts/bench_onnx.py
and scripts/topk_bench.py, on the CPU at tiny sizes.

- ``torch_bench_onnx``: for the same file and seed its inputs equal the JAX
  tool's, array for array, and its fp32 forward agrees with the JAX tool's
  jitted forward within 1e-4 of the outputs' scale (the tiny v2.4 file, and
  a file with a symbolic batch and an int input); its rows lead with the
  JAX tool's keys, in order.
- ``torch_serve_bench``: one row on the tiny v2.4 file under ``--provider
  cpu``; its keys are serve_bench.py's row keys, in order; no client
  failed and the mean fill lies in [1, max_batch].
- ``torch_topk_bench``: the exact top-K forms agree on the CPU at n=6522,
  tile 8 (values and indices), in bf16 with ties and in float32, and on
  negative logits.
- Each new script, and every module it names, imports neither jax nor
  birdnet_tpu.
"""

from __future__ import annotations

import ast
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from birdnet_tpu.onnx import proto as P

REPO = Path(__file__).resolve().parents[1]
SCRIPTS = REPO / "scripts"
TOOLS = ("torch_serve_bench", "torch_bench_onnx", "torch_topk_bench")
PARITY = 1e-4


def _script(name: str):
    spec = importlib.util.spec_from_file_location(f"_tool_{name}", SCRIPTS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def tiny_v24(tmp_path_factory):
    from birdnet_tpu_torch.models import birdnet_v24

    path = tmp_path_factory.mktemp("tools") / "v24_tiny.onnx"
    birdnet_v24.save_tiny(str(path), num_species=10)
    return str(path)


@pytest.fixture(scope="module")
def symbolic_int(tmp_path_factory):
    """A file with a symbolic batch (float [N, 8]) and a fixed int input
    (int64 [3]): y = Gather(x, idx, axis=1) * 2."""
    nodes = [P.make_node("Gather", ["x", "idx"], ["g"], axis=1),
             P.make_node("Mul", ["g", "two"], ["y"])]
    graph = P.GraphProto(
        name="g", node=nodes,
        initializer=[P.TensorProto.from_numpy(np.array(2.0, np.float32), name="two")],
        input=[P.make_value_info("x", P.DataType.FLOAT, ["N", 8]),
               P.make_value_info("idx", P.DataType.INT64, [3])],
        output=[P.make_value_info("y", P.DataType.FLOAT, ["N", 3])])
    path = tmp_path_factory.mktemp("tools") / "symbolic_int.onnx"
    path.write_bytes(P.encode_model(P.make_model(graph, opset_version=13)))
    return str(path)


@pytest.mark.parametrize("which", ["tiny_v24", "symbolic_int"])
def test_bench_onnx_inputs_and_forward_match_the_jax_tool(which, request):
    import jax

    from birdnet_tpu.compiler.importer import import_onnx, make_forward

    path = request.getfixturevalue(which)
    jtool, ttool = _script("bench_onnx"), _script("torch_bench_onnx")
    jmodel = import_onnx(path)
    bench = ttool.Bench(path, "fp32", "cpu")
    jspecs, tspecs = jtool._input_specs(jmodel), ttool._input_specs(bench.model)
    assert jspecs == tspecs
    assert tspecs[0][2][0] is None  # the batch axis is swept
    jfwd = jax.jit(make_forward(jmodel, precision="fp32"))
    jrng, trng = np.random.default_rng(0), np.random.default_rng(0)
    for b in (1, 3):
        want_in = [jtool._synth(jrng, et, [b if d is None else d for d in dims])
                   for _, et, dims in jspecs]
        got_in = bench.inputs(trng, b)
        for g, w in zip(got_in, want_in):
            np.testing.assert_array_equal(g.numpy(), w)
        want = [np.asarray(o) for o in jfwd(jmodel.params, *want_in)]
        rec, eager, graph = bench.row(b, got_in, runs=2)
        assert len(eager) == len(want)
        for g, w in zip(eager, want):
            g = g.numpy()
            assert g.shape == w.shape
            scale = max(float(np.abs(w).max()), 1e-30)
            assert float(np.abs(g - w).max()) <= PARITY * scale
        assert list(rec)[:5] == ["batch", "ms_per_batch", "compile_s", "runs_kept", "inf_s"]
        assert rec["batch"] == b and graph is None and rec["graph_inf_s"] is None
        assert rec["host_reads"] == 0


def test_bench_onnx_draws_the_jax_tools_arrays(symbolic_int):
    """Same file, same seed: every synthesized array equal, float and int."""
    from birdnet_tpu.compiler.importer import import_onnx
    from birdnet_tpu_torch.compiler.importer import import_onnx as t_import_onnx

    jtool, ttool = _script("bench_onnx"), _script("torch_bench_onnx")
    jspecs = jtool._input_specs(import_onnx(symbolic_int))
    tspecs = ttool._input_specs(t_import_onnx(symbolic_int))
    jrng, trng = np.random.default_rng(0), np.random.default_rng(0)
    kinds = set()
    for b in (1, 8, 32):
        for (_, je, jd), (_, te, td) in zip(jspecs, tspecs):
            want = jtool._synth(jrng, je, [b if d is None else d for d in jd])
            got = ttool._synth(trng, te, [b if d is None else d for d in td])
            assert got.dtype == want.dtype and got.shape == want.shape
            np.testing.assert_array_equal(got, want)
            kinds.add(got.dtype.kind)
    assert kinds == {"f", "i"}


def test_bench_onnx_json_rows_on_the_host(symbolic_int, capsys):
    tool = _script("torch_bench_onnx")
    assert tool.main(["--model", symbolic_int, "--provider", "cpu", "--batches", "1,8",
                      "--runs", "2", "--json"]) == 0
    rows = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert [r["batch"] for r in rows] == [1, 8]
    assert all(r["runs_kept"].endswith("/2") and r["inf_s"] > 0 for r in rows)


def _jax_row_keys() -> list:
    """The keys of scripts/serve_bench.py's row, in order, read from its
    source (running it would build a JAX classifier)."""
    tree = ast.parse((SCRIPTS / "serve_bench.py").read_text())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and any(isinstance(t, ast.Name) and t.id == "row" for t in node.targets)):
            return [k.value for k in node.value.keys]
    raise AssertionError("serve_bench.py has no row dict")


def test_serve_bench_row_on_the_host(tiny_v24, capsys):
    tool = _script("torch_serve_bench")
    assert tool.main(["--model", tiny_v24, "--provider", "cpu", "--seconds", "0.3",
                      "--batches", "4", "--waits", "0", "--clients", "2"]) == 0
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("{")]
    assert len(lines) == 1
    row = json.loads(lines[0])
    assert list(row) == _jax_row_keys()
    assert row["client_errors"] == 0
    assert 1 <= row["mean_fill"] <= row["max_batch"] == 4
    assert row["req_per_s"] > 0 and row["p50_ms"] <= row["p99_ms"]


@pytest.mark.parametrize("dtype,sign", [("bfloat16", 1.0), ("float32", 1.0), ("bfloat16", -1.0)])
def test_topk_forms_agree_on_the_host(dtype, sign):
    tool = _script("torch_topk_bench")
    base = np.random.default_rng(0).normal(size=(8, 6522)).astype(np.float32)
    if sign < 0:
        base = -np.abs(base)
    logits = torch.from_numpy(base).to(tool.DTYPES[dtype])
    ties = tool.check(logits, 10, 512)
    if dtype == "bfloat16" and sign > 0:
        assert ties["rows_tied_at_k"] > 0  # the keys' tie rule is exercised
    conf, idx = tool.forms(10, 512)["torch.topk"](logits)
    want, order = torch.sort(logits, dim=-1, descending=True, stable=True)
    assert torch.equal(conf, torch.sigmoid(want[:, :10]))
    assert torch.equal(idx, order[:, :10].to(torch.int32))


def test_topk_bench_line_on_the_host(capsys):
    tool = _script("torch_topk_bench")
    assert tool.main(["--provider", "cpu", "--tile", "8", "--reps", "1"]) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(res["us_per_tile"]) == {"read-only baseline", "fused_sigmoid_topk", "torch.topk",
                                       "two-stage (chunk 512)", "torch.topk (raw)"}
    assert all(t > 0 for t in res["us_per_tile"].values())


def _named_modules(path: Path) -> list:
    """Every absolute module an import statement in the file names, at any
    depth (the scripts import the package lazily, inside functions)."""
    names = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module)
    return sorted(set(names))


@pytest.mark.parametrize("tool", TOOLS)
def test_tool_imports_neither_jax_nor_the_jax_package(tool):
    path = SCRIPTS / f"{tool}.py"
    mods = _named_modules(path)
    assert "birdnet_tpu_torch.runtime" in mods
    code = (
        "import importlib, importlib.util, sys\n"
        f"spec = importlib.util.spec_from_file_location('t', {str(path)!r})\n"
        "spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules\n"
        "             if k.split('.')[0] in ('jax', 'jaxlib', 'birdnet_tpu', 'bench'))\n"
        "print('BAD', bad)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=str(REPO), timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "BAD []" in proc.stdout
