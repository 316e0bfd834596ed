"""The int8 quantizer's layer picker over bfloat16, float8 and int4 weights.

``compiler/quantize.py`` is a copy of the JAX package's module. Its
``_eligible_nodes`` keeps a Conv, MatMul or Gemm only when its weight (and
bias) is ``np.floating``. The JAX package decodes a bfloat16, float8 or
4-bit initializer into an ml_dtypes array, which is not ``np.floating``, so
a layer that reads one directly stays float there and the rest are
quantized. The port decodes it into a ``WireTensor`` (a CPU torch tensor),
whose dtype numpy cannot read: the copy's test raised ``TypeError`` at
``build()`` of ``ClassifierBuilder.int8()``.

:func:`eligible_nodes` hands the copy's picker a view of the tensors in
which each ``WireTensor`` reads as a numpy array of its shape and of an
opaque (void) dtype, as an ml_dtypes array reads to ``np.issubdtype``. The
picker reads only dtypes and ranks and returns nodes, so the view changes
nothing else. ``compiler/__init__.py`` installs it in the copy's module.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from ..onnx.proto import WireTensor


def _opaque(t: WireTensor) -> np.ndarray:
    """A read-only array of ``t``'s shape whose dtype is void of ``t``'s
    item size: neither floating nor integer, as an ml_dtypes array."""
    return np.broadcast_to(np.zeros((), np.dtype((np.void, t.element_size()))),
                           tuple(t.shape))


def wire_view(tensors: Dict[str, object]) -> Dict[str, object]:
    """``tensors`` with every ``WireTensor`` as :func:`_opaque`."""
    return {k: _opaque(v) if isinstance(v, WireTensor) else v
            for k, v in tensors.items()}


def install(quantize) -> None:
    """Wrap ``quantize._eligible_nodes`` (the copy's picker) so that it
    reads :func:`wire_view` of its tensors."""
    picker = quantize._eligible_nodes

    def eligible_nodes(graph, tensors, quantize_first_layer=False):
        return picker(graph, wire_view(tensors), quantize_first_layer)

    quantize._eligible_nodes = eligible_nodes
