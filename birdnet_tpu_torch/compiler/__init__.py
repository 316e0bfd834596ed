"""ONNX → eager PyTorch compiler: import, the op registry, the engine."""

from . import quantize as _quantize
from .importer import ImportedModel, import_onnx, make_forward  # noqa: F401
from .ops import supported_ops  # noqa: F401
from .quantize_wire import install as _install_wire_picker

_install_wire_picker(_quantize)
