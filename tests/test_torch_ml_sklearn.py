"""The port's ai.onnx.ml models against real fits: every test function of
tests/test_sklearn_oracle.py (scikit-learn SVC, SVR, logistic and linear
regression, random forests and gradient boosting, exported in the
skl2onnx layout). tests/test_torch_ml_fuzz.py holds the fuzzed forests
and the Platt coupling.

The runner ``_run_bytes`` is swapped for one that runs the same file
through both packages (tests/_torch_dual.py), the
port within 1e-4 of each output's scale and its labels equal, and the
test's own oracle then checks the port's outputs. No case is taken out.
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
pytest.importorskip("sklearn")

import test_sklearn_oracle as sk_cases  # noqa: E402
from _torch_dual import dual, jax_cases, run_case  # noqa: E402


def _dual_run_bytes(data: bytes, x, outputs=2):
    return dual(data, [np.asarray(x, np.float32)], jit=False, optimize=True,
                n_outputs=outputs)


@pytest.mark.parametrize("case,kwargs", jax_cases(sk_cases))
def test_sklearn_case_through_the_port(case, kwargs, monkeypatch):
    monkeypatch.setattr(sk_cases, "_run_bytes", _dual_run_bytes)
    run_case(sk_cases, case, kwargs)
