"""birdnet_tpu_torch — the PyTorch / CUDA port of birdnet_tpu.

BirdNET v2.4, BirdNET v3.0 and Google Perch v2 on an NVIDIA H100: ONNX file
or ``.btck`` checkpoint → ``import_onnx`` (decode, Conv+BN folding,
fused-node bundling) → ``Classifier.builder()...build()`` → per-call
``predict`` / ``predict_batch`` (or a batch context replaying one CUDA
graph, ``create_batch_context``), or whole-recording streaming
(``analyze_samples``, ``analyze_samples_iter``, ``analyze_wav``,
``embed_samples``), in float or after int8 post-training quantization
(``.int8()``); the BirdNET meta-model range filter (``RangeFilter``); the
``birdnet-analyze`` CLI (``python -m birdnet_tpu_torch``); and the serving
tier (``birdnet_tpu_torch.serve``: the dynamic batcher, the
``birdnet-serve`` HTTP server started by ``python -m
birdnet_tpu_torch.serve``, and its client). Every Pallas
kernel of the JAX package is rewritten by hand in CUDA
(``csrc/frontend.cu``: the audio frontends; ``csrc/qconv.cu``: the fused
int8 1x1 conv + requantize; ``csrc/stage_prefix.cu``: the stem and leading
MBConv blocks), built by nvcc at first use.

The package imports torch and numpy, never jax, and never the JAX package
``birdnet_tpu`` (importing it would load jax). So these modules are
byte-identical copies of their ``birdnet_tpu`` counterparts, kept from
drifting by ``tests/test_torch_codec.py``: ``errors``, ``types``,
``_demux``, ``inference_options``, ``detection``, ``postprocess``,
``labels``, ``testutil``, ``utils/__init__``, ``utils/export``,
``serve/client``, ``compiler/optimize``, ``compiler/fuse_mbconv``,
``compiler/fuse_stage_prefix``, ``compiler/fuse_frontend``,
``compiler/_melbank``, ``models/*`` and ``onnx/__init__``. Two copies carry one change each: ``onnx/proto``
decodes bfloat16, float8 and int4/uint4 into its own ``WireTensor`` (a
CPU torch tensor) instead of ml_dtypes arrays, so the package never
imports ``ml_dtypes``, and the docstring of ``models/_builder`` names the
upstream blob list by file name rather than by an absolute path.
``compiler/quantize`` is a copy whose calibration (``_collect_absmax``)
runs on the port's interpreter on an explicit device, and whose layer
picker ``compiler/__init__`` wraps so that it reads bfloat16, float8 and
4-bit weights as the JAX package's picker reads ml_dtypes arrays
(``compiler/quantize_wire``); ``utils/audio_io`` a
copy whose native decoder builds into a file of its own and renames it
into place; ``utils/activation_diff`` a copy whose
``capture_activations`` runs the port's interpreter on an explicit
device; ``serve/batcher`` and ``serve/__init__`` copies whose
docstrings describe the card; ``cli`` and ``serve/server`` copies whose
device handling is torch's (the test lists each edit).

Every device is explicit: the classifier, the range filter, the CLI and
the server run on ``cuda:0`` unless the caller asks for another device
(or ``set_platform("cpu")`` makes the host the default), and a CUDA
request without CUDA raises :class:`RuntimeInitError`. The JAX package's
device configs keep their names (``TPUConfig``, ``CPUConfig``,
``ClassifierBuilder.with_tpu``/``with_cpu``) with CUDA meanings
(``device_config``, a copy held by ``tests/test_torch_codec.py``).
"""

__version__ = "0.5.0"

from .batch_context import BatchInferenceContext  # noqa: F401
from .checkpoint import import_any, load_checkpoint, save_checkpoint  # noqa: F401
from .classifier import Classifier, ClassifierBuilder  # noqa: F401
from .detection import detect_model_type  # noqa: F401
from .device_config import CPUConfig, TPUConfig  # noqa: F401
from .errors import (  # noqa: F401
    AudioFormatError,
    AudioReadError,
    BatchInputSizeError,
    BirdnetError,
    InferenceCancelledError,
    InferenceError,
    InferenceTimeoutError,
    InputSizeError,
    InvalidCoordinatesError,
    InvalidDateError,
    LabelCountError,
    LabelLoadError,
    LabelParseError,
    LabelsRequiredError,
    ModelDetectionError,
    ModelLoadError,
    ModelPathRequiredError,
    RangeFilterInferenceError,
    RuntimeInitError,
    SpeciesListError,
)
from .execution_providers import (  # noqa: F401
    available_execution_providers,
    is_device_available,
)
from .inference_options import CancellationToken, InferenceOptions  # noqa: F401
from .labels import load_labels_from_file, parse_labels  # noqa: F401
from .runtime import (  # noqa: F401
    available_devices,
    default_device,
    init_runtime,
    resolve_device,
)
from .utils.audio_io import chunk_audio, read_wav, write_wav  # noqa: F401
from .rangefilter import (  # noqa: F401
    RangeFilter,
    RangeFilterBuilder,
    calculate_week,
    filter_predictions,
    validate_coordinates,
    validate_date,
)
from .postprocess import sigmoid, top_k_predictions  # noqa: F401
from .types import (  # noqa: F401
    DeviceBackend,
    DeviceInfo,
    LabelFormat,
    LocationScore,
    ModelConfig,
    ModelType,
    Prediction,
    PredictionResult,
)
