"""Per-node activation capture + diffing.

The reference mitigates import parity risk with per-layer activation
diffing against ONNX Runtime CPU on fixtures (SURVEY §7 "hard parts";
reference: tests/integration_test.rs:75-199 runs the real models). This
module is the library form used by both ``scripts/activation_diff.py``
(CLI report) and the env-gated real-weight tests
(``tests/test_real_models.py``), which assert per-layer bounds instead of
just "runs without crashing".
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np


def capture_activations(imported, precision: str, x: np.ndarray,
                        device=None) -> Dict[str, np.ndarray]:
    """Run the graph and return {value_name: np.ndarray} for every node
    output (float tensors only, bf16 included, as float32).

    The port's interpreter runs eagerly on ``device`` (default ``cuda:0``;
    without CUDA that raises :class:`RuntimeInitError`, so a host run
    passes ``"cpu"``), with TF32 off as ``make_forward`` sets it."""
    import torch

    from ..compiler.importer import (
        _validate_ops,
        consts_to_device,
        interpret_graph,
        params_to_torch,
        subgraph_consts_to_device,
    )
    from ..runtime import device_or_default

    graph = imported.graph
    names = [o for n in graph.node for o in n.output if o]
    device = device_or_default(device)
    _validate_ops(imported)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    env = consts_to_device(imported.consts, device, graph)
    env.update(params_to_torch(imported.params, device))
    env[imported.input_names[0]] = torch.from_numpy(
        np.ascontiguousarray(x, np.float32)).to(device)
    with torch.inference_mode():
        interpret_graph(graph, imported.opset, precision, env, imported.output_names,
                        device, subgraph_consts_to_device(graph, device))
    result = {}
    for name in names:
        val = env[name]
        if isinstance(val, torch.Tensor) and val.is_floating_point():
            result[name] = val.float().cpu().numpy()
        elif isinstance(val, np.ndarray) and np.issubdtype(val.dtype, np.floating):
            result[name] = val.astype(np.float32)
    return result


def layer_diffs(
    ref: Dict[str, np.ndarray], test: Dict[str, np.ndarray], node_of=None
) -> List[Tuple[float, float, str, str]]:
    """Rows of (scale_rel, max_abs, value_name, op_type), worst first.

    ``scale_rel`` is the max absolute difference normalized by the LAYER's
    activation scale (max |ref| over the tensor) — per-element relative
    error divides by values arbitrarily close to zero and reports huge
    ratios for sub-roundoff noise, which is useless as a gate."""
    rows = []
    for name, a in ref.items():
        b = test.get(name)
        if b is None or b.shape != a.shape:
            continue
        absd = float(np.max(np.abs(a - b))) if a.size else 0.0
        scale = float(np.max(np.abs(a))) if a.size else 0.0
        rel = absd / max(scale, 1e-6)
        rows.append((rel, absd, name, (node_of or {}).get(name, "?")))
    rows.sort(reverse=True)
    return rows


def top_k_agreement(a: np.ndarray, b: np.ndarray, k: int = 5) -> Tuple[float, float]:
    """(top-1 agreement fraction, top-k set-overlap fraction) between two
    [batch, classes] logit arrays."""
    top_a = np.argsort(a, axis=-1)[:, ::-1][:, :k]
    top_b = np.argsort(b, axis=-1)[:, ::-1][:, :k]
    agree1 = float((top_a[:, 0] == top_b[:, 0]).mean())
    overlap = float(
        np.mean([
            len(set(ra) & set(rb)) / k for ra, rb in zip(top_a, top_b)
        ])
    )
    return agree1, overlap
