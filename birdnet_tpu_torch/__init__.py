"""birdnet_tpu_torch — the PyTorch / CUDA port of birdnet_tpu.

BirdNET v2.4 per-call classification on an NVIDIA H100: ONNX file →
``import_onnx`` (decode, Conv+BN folding, fused-node bundling) →
``Classifier.builder()...build()`` → ``predict`` / ``predict_batch``, in
float or after int8 post-training quantization (``.int8()``), with the
audio frontend's two Pallas kernels and the fused int8 1x1 conv +
requantize kernel rewritten by hand in CUDA (``csrc/frontend.cu``,
``csrc/qconv.cu``, built by nvcc at first use).

The package imports torch and numpy, never jax, and never the JAX package
``birdnet_tpu`` (importing it would import jax). So these modules are
byte-identical copies of their ``birdnet_tpu`` counterparts, kept from
drifting by ``tests/test_torch_codec.py``: ``errors``, ``types``,
``_demux``, ``inference_options``, ``detection``, ``postprocess``,
``labels``, ``utils/__init__``, ``utils/export``, ``compiler/optimize``,
``compiler/fuse_mbconv``, ``compiler/fuse_stage_prefix``,
``compiler/fuse_frontend``, ``compiler/_melbank``, ``models/*`` and
``onnx/__init__``. Two copies carry one change each: ``onnx/proto`` makes
``ml_dtypes`` optional, and the docstring of ``models/_builder`` names the
upstream blob list by file name rather than by an absolute path.
``compiler/quantize`` is a copy whose calibration (``_collect_absmax``)
runs on the port's interpreter on an explicit device.

Every device is explicit: the classifier runs on ``cuda:0`` unless the
builder asks for another device, and a CUDA request without CUDA raises
:class:`RuntimeInitError`.
"""

__version__ = "0.5.0"

from .classifier import Classifier, ClassifierBuilder  # noqa: F401
from .detection import detect_model_type  # noqa: F401
from .errors import (  # noqa: F401
    BatchInputSizeError,
    BirdnetError,
    InferenceCancelledError,
    InferenceError,
    InferenceTimeoutError,
    InputSizeError,
    LabelCountError,
    LabelsRequiredError,
    ModelDetectionError,
    ModelLoadError,
    ModelPathRequiredError,
    RuntimeInitError,
    SpeciesListError,
)
from .inference_options import CancellationToken, InferenceOptions  # noqa: F401
from .labels import load_labels_from_file, parse_labels  # noqa: F401
from .runtime import resolve_device  # noqa: F401
from .types import (  # noqa: F401
    ModelConfig,
    ModelType,
    Prediction,
    PredictionResult,
)
