"""The port held to tests/test_engine_internals.py.

One case for each of that file's 11 tests. The JAX package's ``_wait``
takes its device arrays (``is_ready()``); the port's takes the
``torch.cuda.Event`` recorded after the work (``query()`` /
``synchronize()``), or ``None`` for work already finished on the host. So
the fakes here are events, and each wait case runs the JAX case too and
holds the port to its outcome: the error raised and the timeout's bound.
Then the import-time BatchNormalization folding (the port's forwards with
and without it, and against the JAX package's), four threads streaming on
one port classifier (against a serial call and the JAX package's indices),
and the import-time reference checks (the same error type and message from
both packages' importers on the same bytes).
"""

import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import test_engine_internals as internals  # noqa: E402
from _torch_dual import run_case  # noqa: E402

import birdnet_tpu_torch.errors as TE  # noqa: E402
from birdnet_tpu.compiler import importer as j_importer  # noqa: E402
from birdnet_tpu_torch.compiler import importer as t_importer  # noqa: E402
from birdnet_tpu_torch.compiler.engine import _wait  # noqa: E402
from birdnet_tpu_torch.inference_options import CancellationToken, InferenceOptions  # noqa: E402
from _torch_threads import torch_threads  # noqa: E402,F401

PARITY = 1e-4


class _NeverDone:
    """A recorded event whose work never finishes."""

    def query(self):
        return False

    def synchronize(self):
        raise AssertionError("a monitored wait must poll, not block")


class _Done:
    def __init__(self):
        self.synchronized = 0

    def query(self):
        return True

    def synchronize(self):
        self.synchronized += 1


def test_wait_no_options_fast_path():
    """No monitor: the wait blocks on the event once (``None``: nothing to
    wait for)."""
    run_case(internals, "test_wait_no_options_fast_path", {})
    done = _Done()
    _wait(done, None)
    _wait(done, InferenceOptions())
    assert done.synchronized == 2
    _wait(None, None)


def test_wait_timeout_fires():
    run_case(internals, "test_wait_timeout_fires", {})
    t0 = time.monotonic()
    with pytest.raises(TE.InferenceTimeoutError) as ei:
        _wait(_NeverDone(), InferenceOptions(timeout=0.05))
    assert 0.04 < time.monotonic() - t0 < 2.0
    assert ei.value.duration == 0.05


def test_wait_precancelled():
    run_case(internals, "test_wait_precancelled", {})
    tok = CancellationToken()
    tok.cancel()
    for done in (_NeverDone(), _Done(), None):
        with pytest.raises(TE.InferenceCancelledError):
            _wait(done, InferenceOptions(cancellation_token=tok))


def test_wait_cancel_from_other_thread():
    run_case(internals, "test_wait_cancel_from_other_thread", {})
    tok = CancellationToken()
    timer = threading.Timer(0.05, tok.cancel)
    timer.start()
    t0 = time.monotonic()
    with pytest.raises(TE.InferenceCancelledError):
        _wait(_NeverDone(), InferenceOptions(cancellation_token=tok))
    assert time.monotonic() - t0 < 2.0
    timer.join()


def test_wait_ready_passes_with_monitor():
    run_case(internals, "test_wait_ready_passes_with_monitor", {})
    done = _Done()
    _wait(done, InferenceOptions(timeout=5.0))  # completes immediately
    _wait(None, InferenceOptions(timeout=5.0))
    assert done.synchronized == 0


# --- import-time optimization equivalence ------------------------------------


def test_batchnorm_folding_preserves_outputs():
    """The port's forward of the folded graph within the JAX case's CPU
    bound of its unfolded one, and within PARITY of the JAX package's
    folded forward; the same BatchNormalization counts as the JAX
    package's."""
    from birdnet_tpu_torch.models import birdnet_v24
    from birdnet_tpu_torch.onnx import proto as P

    data = P.encode_model(birdnet_v24.build_model(width=0.1, depth=1, num_species=8))
    raw = t_importer.import_onnx(data, optimize=False)
    opt = t_importer.import_onnx(data, optimize=True)
    n_bn = lambda m: sum(1 for n in m.graph.node if n.op_type == "BatchNormalization")
    assert n_bn(raw) > 0
    assert n_bn(opt) < n_bn(raw)
    j_opt = j_importer.import_onnx(data, optimize=True)
    assert (n_bn(raw), n_bn(opt)) == (n_bn(j_importer.import_onnx(data, optimize=False)),
                                      n_bn(j_opt))

    x = np.random.default_rng(3).normal(size=(2, 144_000)).astype(np.float32)
    run = lambda m: t_importer.make_forward(m, "fp32", "cpu")(
        t_importer.params_to_torch(m.params, "cpu"), torch.from_numpy(x))[0].numpy()
    y_raw, y_opt = run(raw), run(opt)
    np.testing.assert_allclose(y_opt, y_raw, rtol=1e-3, atol=1e-4)
    want = np.asarray(jax.jit(j_importer.make_forward(j_opt, "fp32"))(j_opt.params, x)[0])
    assert np.abs(y_opt - want).max() <= PARITY * np.abs(want).max()


def test_streaming_concurrent_calls(tmp_path):
    """Four threads stream the same audio on one port classifier: each
    result equals the serial call's (times and indices exactly,
    confidences bit for bit), whose indices equal the JAX package's."""
    from birdnet_tpu import Classifier as JClassifier
    from birdnet_tpu_torch import Classifier
    from birdnet_tpu_torch.models import birdnet_v24
    from birdnet_tpu_torch.testutil import mock_labels

    p = tmp_path / "m.onnx"
    birdnet_v24.save_tiny(p, num_species=10)
    clf = Classifier.builder().model_path(p).labels(mock_labels(10)).with_device("cpu").build()
    audio = np.random.default_rng(0).normal(size=144_000 * 4).astype(np.float32)
    expected = clf.analyze_samples(audio)
    theirs = JClassifier.builder().model_path(p).labels(mock_labels(10)).build() \
        .analyze_samples(audio)
    assert len(expected) == len(theirs) == 4
    for (t1, p1), (t2, p2) in zip(expected, theirs):
        assert t1 == pytest.approx(t2)
        assert [x.index for x in p1] == [x.index for x in p2]

    errors, results = [], []
    start = threading.Barrier(4)

    def worker():
        try:
            start.wait()
            results.append(clf.analyze_samples(audio))
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=worker) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert errors == []
    assert len(results) == 4
    for got in results:
        assert len(got) == len(expected)
        for (t1, p1), (t2, p2) in zip(got, expected):
            assert t1 == t2
            assert [x.index for x in p1] == [x.index for x in p2]
            assert [x.confidence for x in p1] == [x.confidence for x in p2]


# ---------------------------------------------------------------------------
# import-time reference/topology validation
# ---------------------------------------------------------------------------

J_IMPORT_ONNX = j_importer.import_onnx


def _import_both(imported):
    """``import_onnx`` for a JAX case: the port imports the same bytes
    first; both must fail with the same error type and message, or both
    load (the port's model is kept in ``imported``)."""

    def both(source, *args, **kwargs):
        try:
            imported.append(t_importer.import_onnx(source, *args, **kwargs))
            port_error = None
        except Exception as e:  # noqa: BLE001 - compared with the JAX error
            port_error = e
        try:
            model = J_IMPORT_ONNX(source, *args, **kwargs)
        except Exception as e:
            assert port_error is not None, f"the port loaded what JAX refused: {e}"
            assert (type(port_error).__name__, str(port_error)) == (type(e).__name__, str(e))
            raise
        assert port_error is None, f"the port refused what JAX loaded: {port_error}"
        return model

    return both


@pytest.mark.parametrize("case", [
    "test_import_rejects_dangling_reference",
    "test_import_rejects_non_topological_order",
    "test_import_rejects_dangling_reference_in_subgraph",
    "test_subgraph_closure_capture_still_validates",
])
def test_import_validation_case_in_both_packages(case, monkeypatch):
    imported = []
    monkeypatch.setattr(j_importer, "import_onnx", _import_both(imported))
    run_case(internals, case, {})
    if case == "test_subgraph_closure_capture_still_validates":
        # The port's forward of the same file, on the JAX case's inputs.
        (model,) = imported
        fwd = t_importer.make_forward(model, "fp32", "cpu")
        x = torch.tensor([-1.0, 2.0])
        for cond, want in ((True, [0.0, 2.0]), (False, [1.0, -2.0])):
            out = fwd(t_importer.params_to_torch(model.params, "cpu"), torch.tensor(cond), x)[0]
            np.testing.assert_array_equal(out.numpy(), np.asarray(want, np.float32))
    else:
        assert imported == []
