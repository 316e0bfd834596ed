"""birdnet_tpu_torch — the PyTorch / CUDA port of birdnet_tpu.

BirdNET v2.4 on an NVIDIA H100: ONNX file → ``import_onnx`` (decode,
Conv+BN folding, fused-node bundling) → ``Classifier.builder()...build()``
→ per-call ``predict`` / ``predict_batch``, or whole-recording streaming
(``analyze_samples``, ``analyze_samples_iter``, ``analyze_wav``,
``embed_samples``), in float or after int8 post-training quantization
(``.int8()``). Every Pallas kernel of the JAX package is rewritten by hand
in CUDA (``csrc/frontend.cu``: the audio frontends; ``csrc/qconv.cu``: the
fused int8 1x1 conv + requantize; ``csrc/stage_prefix.cu``: the stem and
leading MBConv blocks), built by nvcc at first use.

The package imports torch and numpy, never jax, and never the JAX package
``birdnet_tpu`` (importing it would load jax). So these modules are
byte-identical copies of their ``birdnet_tpu`` counterparts, kept from
drifting by ``tests/test_torch_codec.py``: ``errors``, ``types``,
``_demux``, ``inference_options``, ``detection``, ``postprocess``,
``labels``, ``utils/__init__``, ``utils/export``, ``utils/audio_io``,
``compiler/optimize``, ``compiler/fuse_mbconv``,
``compiler/fuse_stage_prefix``, ``compiler/fuse_frontend``,
``compiler/_melbank``, ``models/*`` and ``onnx/__init__``. Two copies carry one change each: ``onnx/proto`` makes
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
    AudioFormatError,
    AudioReadError,
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
from .utils.audio_io import chunk_audio, read_wav, write_wav  # noqa: F401
from .types import (  # noqa: F401
    ModelConfig,
    ModelType,
    Prediction,
    PredictionResult,
)
