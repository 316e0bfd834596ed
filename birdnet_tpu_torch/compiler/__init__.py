"""ONNX → eager PyTorch compiler: import, the op registry, the engine."""

from .importer import ImportedModel, import_onnx, make_forward  # noqa: F401
from .ops import supported_ops  # noqa: F401
