"""The port's entry points run on the card unless the caller asks for the CPU:
``make_forward``, ``quantize_model`` (and its calibration), ``resample_poly``
on a host array and ``resample_audio`` default to ``cuda:0``, so without
CUDA a call that names no device raises ``RuntimeInitError`` and nothing
falls back to the host. A tensor handed to ``resample_poly`` keeps its own
device."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from birdnet_tpu_torch.compiler import importer as timp  # noqa: E402
from birdnet_tpu_torch.compiler import quantize as tq  # noqa: E402
from birdnet_tpu_torch.errors import RuntimeInitError  # noqa: E402
from birdnet_tpu_torch.models import birdnet_v24  # noqa: E402
from birdnet_tpu_torch.onnx import proto as P  # noqa: E402
from birdnet_tpu_torch.ops import resample as trs  # noqa: E402
from birdnet_tpu_torch.runtime import device_or_default  # noqa: E402


@pytest.fixture(scope="module")
def tiny_model():
    return timp.import_onnx(P.encode_model(
        birdnet_v24.build_model(num_species=4, width=0.1, depth=1, seed=0)))


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _segments(n):
    return (np.random.default_rng(0).normal(size=(n, birdnet_v24.SAMPLE_COUNT)) * 0.1
            ).astype(np.float32)


ENTRY_POINTS = {
    "make_forward": lambda model: timp.make_forward(model, "fp32"),
    "quantize_model": lambda model: tq.quantize_model(model, [_segments(1)]),
    "collect_absmax": lambda model: tq._collect_absmax(model, [_segments(1)], set()),
    "resample_poly_host_array": lambda model: trs.resample_poly(
        np.zeros(1000, np.float32), 44_100, 48_000),
    "resample_audio": lambda model: trs.resample_audio(
        np.zeros(1000, np.int16), 44_100, 48_000),
}


@pytest.mark.parametrize("entry", sorted(ENTRY_POINTS))
def test_entry_point_without_device_needs_cuda(tiny_model, no_cuda, entry):
    with pytest.raises(RuntimeInitError, match="CUDA was requested"):
        ENTRY_POINTS[entry](tiny_model)


@pytest.mark.parametrize("entry", sorted(ENTRY_POINTS))
def test_entry_point_runs_on_the_cpu_when_asked(tiny_model, no_cuda, entry):
    """The same calls with ``device="cpu"`` run on the host."""
    cpu = "cpu"
    if entry == "make_forward":
        fwd = timp.make_forward(tiny_model, "fp32", cpu)
        out = fwd(timp.params_to_torch(tiny_model.params, cpu), torch.from_numpy(_segments(1)))
        assert out[0].device.type == "cpu" and out[0].shape == (1, 4)
    elif entry == "quantize_model":
        q = tq.quantize_model(tiny_model, [_segments(1)], device=cpu)
        assert any(n.op_type == "QLinearConv" for n in q.graph.node)
    elif entry == "collect_absmax":
        name = tiny_model.graph.node[0].output[0]
        stats = tq._collect_absmax(tiny_model, [_segments(1)], {name}, device=cpu)
        assert stats[name] > 0
    elif entry == "resample_poly_host_array":
        y = trs.resample_poly(np.zeros(1000, np.float32), 44_100, 48_000, device=cpu)
        assert y.device.type == "cpu" and y.shape == (1089,)
    else:
        y = trs.resample_audio(np.zeros(1000, np.int16), 44_100, 48_000, device=cpu)
        assert isinstance(y, np.ndarray) and y.shape == (1089,)


def test_resample_poly_keeps_a_tensors_device(no_cuda):
    y = trs.resample_poly(torch.zeros(1000), 44_100, 48_000)
    assert y.device.type == "cpu" and y.shape == (1089,)


def test_device_or_default(no_cuda):
    assert device_or_default("cpu") == torch.device("cpu")
    assert device_or_default(torch.device("cpu")) == torch.device("cpu")
    with pytest.raises(RuntimeInitError):
        device_or_default(None)
