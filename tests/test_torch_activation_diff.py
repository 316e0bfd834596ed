"""The port's ``utils/activation_diff.py`` against the JAX package's: the
per-node capture of a tiny BirdNET v2.4 (conv and STFT frontends) at fp32
from one seeded numpy batch on the host, node by node (the same value
names, every layer within 1e-4 of its own scale by ``layer_diffs``), and
the numpy-only ``layer_diffs`` / ``top_k_agreement`` on seeded arrays."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from birdnet_tpu.checkpoint import import_any as j_import_any  # noqa: E402
from birdnet_tpu.utils import activation_diff as jad  # noqa: E402
from birdnet_tpu_torch.checkpoint import import_any as t_import_any  # noqa: E402
from birdnet_tpu_torch.models import birdnet_v24  # noqa: E402
from birdnet_tpu_torch.onnx import proto as P  # noqa: E402
from birdnet_tpu_torch.utils import activation_diff as tad  # noqa: E402

LAYER_TOL = 1e-4


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(0)
    return (rng.normal(size=(2, birdnet_v24.SAMPLE_COUNT)) * 0.2).astype(np.float32)


@pytest.mark.parametrize("frontend", ["conv", "stft"])
def test_capture_matches_jax_node_by_node(tmp_path, batch, frontend):
    path = str(tmp_path / f"v24_{frontend}.onnx")
    P.save_model(birdnet_v24.build_model(num_species=10, width=0.1, depth=1,
                                         frontend=frontend), path)
    mine = tad.capture_activations(t_import_any(path), "fp32", batch, "cpu")
    theirs = jad.capture_activations(j_import_any(path), "fp32", batch)
    assert set(mine) == set(theirs) and len(mine) >= 10
    rows = tad.layer_diffs(theirs, mine)
    assert len(rows) == len(theirs)
    worst = rows[0]
    assert worst[0] <= LAYER_TOL, worst


def test_capture_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("the default device exists here")
    from birdnet_tpu_torch.errors import RuntimeInitError

    imported = t_import_any(P.encode_model(birdnet_v24.build_model(
        num_species=4, width=0.1, depth=1)))
    with pytest.raises(RuntimeInitError):
        tad.capture_activations(imported, "fp32", np.zeros((1, birdnet_v24.SAMPLE_COUNT)))


def _seeded_activations(seed):
    rng = np.random.default_rng(seed)
    ref = {f"v{i}": rng.normal(size=(3, 5 + i)).astype(np.float32) for i in range(6)}
    test = {k: v + rng.normal(size=v.shape).astype(np.float32) * 10.0 ** -(i + 1)
            for i, (k, v) in enumerate(ref.items())}
    test["v5"] = test["v5"][:, :2]  # a shape mismatch is skipped
    ref["empty"] = test["empty"] = np.zeros((0, 4), np.float32)
    ref["only_ref"] = ref["v0"]
    return ref, test


@pytest.mark.parametrize("seed", [0, 1])
def test_layer_diffs_and_agreement_match_jax(seed):
    ref, test = _seeded_activations(seed)
    node_of = {"v0": "Conv", "v3": "Mul"}
    assert tad.layer_diffs(ref, test, node_of) == jad.layer_diffs(ref, test, node_of)
    assert tad.layer_diffs(ref, test) == jad.layer_diffs(ref, test)
    rng = np.random.default_rng(seed + 10)
    a = rng.normal(size=(16, 40))
    b = a + rng.normal(size=a.shape) * 0.3
    for k in (1, 5):
        assert tad.top_k_agreement(a, b, k) == jad.top_k_agreement(a, b, k)
