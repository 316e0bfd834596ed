"""Classifier with builder API, on PyTorch.

The counterpart of :mod:`birdnet_tpu.classifier`: ``Classifier.builder()``
with a model path and labels, ``build()`` (load → shape extraction →
detection → validation forward → label checks), then ``predict`` and
``predict_batch`` with the same validation errors and results.

Differences from the JAX package:

- The device is explicit: ``cuda:0`` unless the builder asks for another
  (``.with_device("cpu")``, ``.with_device("cuda:1")``, ``.with_cpu()``,
  ``.with_tpu(TPUConfig(device_id=1))``: the JAX names, whose "TPU" is the
  card here). Asking for CUDA where there is none raises
  :class:`~birdnet_tpu_torch.errors.RuntimeInitError`.
- Build-time validation is one forward pass at batch 1 on that device.
- int8 calibration runs on that device (the JAX package pins it to the
  host CPU).
- Streaming (``analyze_samples``, ``analyze_samples_iter``, ``analyze_wav``,
  ``embed_samples``) runs on the classifier's device at its precision;
  ``analyze_wav(resample=True)`` resamples there too.
- ``.btck`` checkpoints load and save in the JAX package's format
  (:mod:`birdnet_tpu_torch.checkpoint`); ``model_path`` takes either form.
- A batch context (:meth:`Classifier.create_batch_context`) replays one
  CUDA graph captured at its maximum batch on the card, where the JAX
  package runs one fixed-shape donated executable; on the host it runs the
  eager forward.
- ``with_mesh`` runs one process over a :class:`~birdnet_tpu_torch.parallel.Mesh`
  of devices (:mod:`birdnet_tpu_torch.parallel`): the mesh's controller
  device (``devices[0, 0]``) validates the model and calibrates int8; over
  a mesh of cards ``predict_batch``, a batch context and the stream replay
  the mesh's programs, captured as CUDA graphs once per key
  (:mod:`birdnet_tpu_torch.parallel.graphs`).
"""

from __future__ import annotations

import threading
from typing import List, Optional, Sequence

import numpy as np

from .batch_context import BatchInferenceContext
from .compiler.engine import InferenceEngine, default_precision
from .detection import detect_model_type
from .device_config import CPUConfig, TPUConfig
from .errors import (
    BatchInputSizeError,
    BirdnetError,
    InferenceError,
    InputSizeError,
    LabelCountError,
    LabelsRequiredError,
    ModelLoadError,
    ModelPathRequiredError,
    SpeciesListError,
)
from .inference_options import InferenceOptions
from .labels import load_labels_from_file, species_mask_from_names
from .types import ModelConfig, ModelType, Prediction, PredictionResult
from .utils.collector import collector_paused
from .utils.profiling import count, span

_PRECISIONS = ("fp32", "mixed", "fast", "bf16")


def top_k_rows_from_device(
    values: np.ndarray,
    indices: np.ndarray,
    labels: Sequence[str],
    min_confidence: Optional[float] = None,
    allowed: Optional[np.ndarray] = None,
) -> List[List[Prediction]]:
    """:func:`~birdnet_tpu_torch.postprocess.top_k_from_device` over every
    row of ``[N, K]`` arrays in one pass: each array is read once by
    ``tolist()``, not row by row.

    ``allowed`` (bool, or None for every species) drops the species-mask
    stragglers: index ``i`` stays only where ``i < len(allowed)`` and
    ``allowed[i]``. Confidences are Python floats of the device's values and
    indices Python ints, as ``top_k_from_device`` gives them.
    """
    n_labels = len(labels)
    indices = np.asarray(indices)
    if allowed is None:
        keep = np.ones(indices.shape, dtype=bool)
    else:
        # One False past the mask's end stands for every index beyond it.
        allowed = np.append(np.asarray(allowed, dtype=bool), False)
        keep = allowed[np.minimum(indices, len(allowed) - 1)]
    return [
        [Prediction(labels[i] if i < n_labels else f"unknown_{i}", v, i)
         for v, i, ok in zip(vals, idxs, oks)
         if ok and (min_confidence is None or v >= min_confidence)]
        for vals, idxs, oks in zip(values.tolist(), indices.tolist(), keep.tolist())
    ]


class ClassifierBuilder:
    """Builder for :class:`Classifier` (reference: classifier.rs:46-383)."""

    def __init__(self) -> None:
        self._model_path: Optional[str] = None
        self._labels_path: Optional[str] = None
        self._labels: Optional[List[str]] = None
        self._top_k: int = 10
        self._min_confidence: Optional[float] = None
        self._requested_device: Optional[str] = None  # first non-CPU wins
        self._device_config = None
        self._precision: Optional[str] = None
        self._warmup_batches: Sequence[int] = ()
        self._species_list: Optional[List[str]] = None
        self._model_type: Optional[ModelType] = None
        self._int8 = False
        self._int8_calibration = None
        self._use_mesh = False
        self._mesh = None

    # -- required inputs --------------------------------------------------

    def model_path(self, path) -> "ClassifierBuilder":
        self._model_path = str(path)
        return self

    def labels_path(self, path) -> "ClassifierBuilder":
        self._labels_path = str(path)
        return self

    def labels(self, labels: Sequence[str]) -> "ClassifierBuilder":
        """Provide labels directly (in-memory)."""
        self._labels = list(labels)
        return self

    # -- options -----------------------------------------------------------

    def top_k(self, k: int) -> "ClassifierBuilder":
        self._top_k = int(k)
        return self

    def min_confidence(self, c: float) -> "ClassifierBuilder":
        self._min_confidence = float(c)
        return self

    def model_type(self, mt: ModelType) -> "ClassifierBuilder":
        """Override auto-detection (validated against actual shapes)."""
        self._model_type = mt
        return self

    def precision(self, p: str) -> "ClassifierBuilder":
        """Precision policy: fp32 | mixed | fast | bf16 (``fast`` and
        ``bf16`` run the CUDA frontend kernels)."""
        if p not in _PRECISIONS:
            raise ValueError(
                f"unknown precision policy {p!r}; expected one of "
                f"'fp32', 'mixed', 'fast', 'bf16'"
            )
        self._precision = p
        return self

    def warmup(self, batch_sizes: Sequence[int]) -> "ClassifierBuilder":
        """Run the forward at these batch sizes during ``build()``."""
        self._warmup_batches = tuple(batch_sizes)
        return self

    def species_list(self, species) -> "ClassifierBuilder":
        """Restrict predictions to a subset of species: disallowed logits
        are masked to -inf on the device before the fused top-K."""
        self._species_list = [str(s) for s in species]
        return self

    # -- device selection ("first non-CPU device wins", classifier.rs:25-31)

    def with_device(self, device: str) -> "ClassifierBuilder":
        """Request a device: ``"cuda"``, ``"cuda:<n>"``, ``"gpu"`` or
        ``"cpu"``. Without a request the classifier runs on ``cuda:0``."""
        if self._requested_device is None or self._requested_device == "cpu":
            self._requested_device = device
        return self

    def with_tpu(self, config: Optional[TPUConfig] = None) -> "ClassifierBuilder":
        """Request the card with a :class:`TPUConfig` (the JAX package's
        name): ``cuda:<config.device_id>`` at ``config.precision``. An
        accelerator request overrides an earlier CPU request, never another
        accelerator (classifier.rs:25-31)."""
        if self._requested_device is None or self._requested_device == "cpu":
            self._requested_device = "cuda"
        self._device_config = config or TPUConfig()
        return self

    def with_tpu_config(self, config: TPUConfig) -> "ClassifierBuilder":
        return self.with_tpu(config)

    def with_cpu(self, config: Optional[CPUConfig] = None) -> "ClassifierBuilder":
        # CPU never overrides a previously requested accelerator (parity with
        # "first non-CPU provider wins", classifier.rs:25-31); its config is
        # honored only when CPU actually is the selected device.
        if self._requested_device is None:
            self._requested_device = "cpu"
        if self._requested_device == "cpu" and config is not None:
            self._device_config = config
        return self

    def with_mesh(self, mesh=None) -> "ClassifierBuilder":
        """Run over several devices: shard batches over the mesh's ``data``
        axis and the classifier head over ``model`` (no reference
        counterpart — the reference is single-device). ``mesh=None`` builds
        a default mesh over the default platform's devices
        (:func:`~birdnet_tpu_torch.parallel.make_mesh`)."""
        self._use_mesh = True
        self._mesh = mesh
        return self

    def int8(self, calibration_segments=None) -> "ClassifierBuilder":
        """Post-training int8 quantization (compiler/quantize.py): symmetric
        int8 weights and activations, the 1x1 convs on the B3 kernel.

        ``calibration_segments``: real audio for activation calibration —
        an iterable of [B, sample_count] float32 batches, a 2-D
        [N, sample_count] stack (split into batches of 4), or a raw 1-D
        recording (float32 or int16 PCM) that gets chunked into
        evenly-spaced segments. ``None`` falls back to synthetic
        noise/sweep audio, which keeps scales sane but calibrates less
        accurately than real recordings.
        """
        self._int8 = True
        self._int8_calibration = calibration_segments
        return self

    # -- build -------------------------------------------------------------

    def build(self) -> "Classifier":
        if self._model_path is None:
            raise ModelPathRequiredError()
        if self._labels_path is None and self._labels is None:
            raise LabelsRequiredError()
        with span("birdnet.build"):
            return self._build()

    def _build(self) -> "Classifier":
        from .checkpoint import import_any
        from .compiler.importer import make_forward, params_to_torch
        from .ops.cuda.build import KernelBuildError
        from .runtime import default_device, init_runtime

        imported = import_any(self._model_path)
        input_shape, output_shapes = imported.detection_shapes()
        config = detect_model_type(input_shape, output_shapes, self._model_type)
        # The device config's card and policy (birdnet_tpu/classifier.py:
        # 194-203, 279-293); CUDA must be there before the config touches it.
        dev_config = self._device_config
        mesh = None
        if self._use_mesh:
            from .parallel.sharding import make_mesh

            mesh = self._mesh if self._mesh is not None else make_mesh()
            device = mesh.devices.flat[0]
        else:
            device = default_device(self._requested_device,
                                    dev_config.device_id if dev_config is not None else 0)
        if device.type == "cuda":
            init_runtime(dev_config.compilation_cache_dir
                         if dev_config is not None else None)
        if dev_config is not None:
            dev_config.apply()
        precision = (self._precision
                     or (dev_config.precision if dev_config is not None else None)
                     or default_precision(device))
        if self._int8:
            imported = self._quantize(imported, config, device)

        # Validation forward (reference analog: ORT validates the graph at
        # session creation — commit_from_file, classifier.rs:348-350):
        # structural defects surface here as ModelLoadError, not at the
        # first predict.
        params = params_to_torch(imported.params, device)
        try:
            import torch

            x = torch.zeros(tuple(input_shape), dtype=torch.float32, device=device)
            make_forward(imported, precision, device)(params, x)
        except (BirdnetError, KernelBuildError):
            raise
        except Exception as e:  # noqa: BLE001 - untrusted model structure
            raise ModelLoadError(f"model failed validation forward: {e}") from e

        if self._labels is not None:
            labels = list(self._labels)
        else:
            labels = load_labels_from_file(self._labels_path, config.model_type)
        if len(labels) != config.num_species:
            raise LabelCountError(expected=config.num_species, got=len(labels))

        species_mask = None
        if self._species_list is not None:
            species_mask = species_mask_from_names(labels, self._species_list)
            if not species_mask.any():
                raise SpeciesListError(
                    "species list matches none of the model's labels"
                )

        if mesh is not None:
            from .parallel.engine import ShardedEngine

            engine = ShardedEngine(
                imported,
                config,
                mesh=mesh,
                precision=precision,
                top_k=self._top_k,
                species_mask=species_mask,
            )
        else:
            engine = InferenceEngine(
                imported,
                config,
                device=device,
                precision=precision,
                top_k=self._top_k,
                species_mask=species_mask,
                params=params,
            )
        if self._warmup_batches:
            engine.warmup(self._warmup_batches)
        return Classifier(
            engine=engine,
            imported=imported,
            config=config,
            labels=labels,
            top_k=self._top_k,
            min_confidence=self._min_confidence,
            species_mask=species_mask,
        )

    def _quantize(self, imported, config: ModelConfig, device):
        """The int8 model, calibrated on ``device``."""
        from .compiler.quantize import (
            calibration_from_samples,
            quantize_model,
            synthetic_calibration_segments,
        )

        calibration = self._int8_calibration
        if calibration is None:
            calibration = synthetic_calibration_segments(config.sample_count)
        elif isinstance(calibration, np.ndarray):
            if calibration.ndim == 1:
                # Raw recording: chunk into evenly-spaced segments.
                calibration = calibration_from_samples(
                    calibration, config.sample_count
                )
            elif calibration.ndim == 2:
                # [N, sample_count] segment stack: split into batches (a
                # bare 2-D array would otherwise iterate into 1-D rows, each
                # misread as a whole model input).
                calibration = [
                    calibration[i:i + 4]
                    for i in range(0, calibration.shape[0], 4)
                ]
        return quantize_model(imported, calibration, device=device)


class Classifier:
    """Classifier over one device or a mesh (reference:
    classifier.rs:422-1058). All state is immutable after build."""

    def __init__(
        self,
        engine: InferenceEngine,
        imported,
        config: ModelConfig,
        labels: List[str],
        top_k: int,
        min_confidence: Optional[float],
        species_mask=None,
    ):
        self._engine = engine
        self._imported = imported
        self._stream = None
        self._stream_lock = threading.Lock()
        self._config = config
        self._labels = labels
        self._top_k = top_k
        self._min_confidence = min_confidence
        self._species_mask = species_mask

    @staticmethod
    def builder() -> ClassifierBuilder:
        return ClassifierBuilder()

    # -- introspection ------------------------------------------------------

    @property
    def config(self) -> ModelConfig:
        return self._config

    @property
    def model_type(self) -> ModelType:
        return self._config.model_type

    @property
    def labels(self) -> List[str]:
        return self._labels

    @property
    def num_species(self) -> int:
        return self._config.num_species

    @property
    def top_k_value(self) -> int:
        return self._top_k

    @property
    def min_confidence_value(self) -> Optional[float]:
        return self._min_confidence

    @property
    def device(self):
        return self._engine.device

    @property
    def precision(self) -> str:
        return self._engine.precision

    @property
    def species_mask(self):
        """Boolean [num_species] candidate mask from
        :meth:`ClassifierBuilder.species_list`, or None when unrestricted."""
        return self._species_mask

    def allowed_species(self) -> Optional[List[str]]:
        """Labels retained by the build-time species list (label order),
        or None when unrestricted."""
        if self._species_mask is None:
            return None
        return [
            label
            for label, keep in zip(self._labels, self._species_mask)
            if keep
        ]

    # -- prediction ---------------------------------------------------------

    def predict(
        self,
        segment,
        options: Optional[InferenceOptions] = None,
        species_mask: Optional[np.ndarray] = None,
    ) -> PredictionResult:
        """Classify one audio segment of exactly ``config.sample_count``
        float samples (reference: classifier.rs:610-643). ``species_mask``:
        optional bool [num_species] per-call candidate mask."""
        seg = np.asarray(segment, dtype=np.float32).reshape(-1)
        if seg.shape[0] != self._config.sample_count:
            raise InputSizeError(
                expected=self._config.sample_count, got=seg.shape[0]
            )
        rows = (
            None if species_mask is None
            else self._validate_species_masks(
                np.asarray(species_mask, dtype=bool).reshape(1, -1), 1
            )
        )
        conf, idx, logits, emb = self._engine.run_batch(
            seg[None, :], options=options, row_masks=rows
        )
        return self._result(
            conf[0], idx[0], logits[0],
            emb[0] if emb is not None else None,
            row_mask=rows[0] if rows is not None else None,
        )

    def predict_batch(
        self,
        segments,
        options: Optional[InferenceOptions] = None,
        species_masks: Optional[np.ndarray] = None,
    ) -> List[PredictionResult]:
        """Classify a batch of segments (reference: classifier.rs:676-727).
        ``species_masks``: optional per-segment bool [B, num_species]
        candidate masks."""
        segs = [np.asarray(s, dtype=np.float32).reshape(-1) for s in segments]
        if not segs:
            return []
        for i, s in enumerate(segs):
            if s.shape[0] != self._config.sample_count:
                raise BatchInputSizeError(
                    index=i, expected=self._config.sample_count, got=s.shape[0]
                )
        batch = np.stack(segs, axis=0)
        rows = self._validate_species_masks(species_masks, len(segs))
        conf, idx, logits, emb = self._engine.run_batch(
            batch, options=options, row_masks=rows
        )
        return [
            self._result(
                conf[i], idx[i], logits[i],
                emb[i] if emb is not None else None,
                row_mask=rows[i] if rows is not None else None,
            )
            for i in range(len(segs))
        ]

    def _validate_species_masks(self, species_masks, b: int):
        if species_masks is None:
            return None
        rows = np.asarray(species_masks, dtype=bool)
        if rows.ndim != 2:
            raise InferenceError(
                "species_masks must be a 2-D [batch, num_species] bool "
                f"array, got {rows.ndim}-D; broadcast a shared mask with "
                "np.tile(mask, (batch, 1)) if all segments use one list"
            )
        if rows.shape[1] != self._config.num_species:
            raise InputSizeError(
                expected=self._config.num_species,
                got=int(rows.shape[1]),
            )
        if rows.shape[0] != b:
            raise InferenceError(
                f"species_masks has {rows.shape[0]} rows for a batch of {b}"
            )
        return rows

    # -- batch context path -------------------------------------------------

    def create_batch_context(
        self, max_batch_size: int, precompile_row_mask: bool = False
    ) -> BatchInferenceContext:
        """Create a buffer-reusing batch context (reference:
        classifier.rs:757-784 → batch_context.rs:69-122). On the card it
        captures the forward at ``max_batch_size`` into a CUDA graph and
        raises :class:`InferenceError` if the capture fails.
        ``precompile_row_mask``: on one card the one graph already reads
        per-request species masks; over a mesh of cards it also captures
        the mesh's row-mask program, as the JAX context compiles it."""
        return BatchInferenceContext(
            engine=self._engine,
            config=self._config,
            max_batch_size=max_batch_size,
            precompile_row_mask=precompile_row_mask,
        )

    def predict_batch_with_context(
        self,
        context: BatchInferenceContext,
        segments,
        options: Optional[InferenceOptions] = None,
        species_masks: Optional[np.ndarray] = None,
    ) -> List[PredictionResult]:
        """Batched inference reusing pre-allocated buffers (reference:
        classifier.rs:826-866). ``species_masks`` as in
        :meth:`predict_batch`."""
        _, b = context.prepare_input(segments)
        rows = self._validate_species_masks(species_masks, b)
        conf, idx, logits, emb = context.run(b, options, rows)
        return [
            self._result(
                conf[i], idx[i], logits[i],
                emb[i] if emb is not None else None,
                row_mask=rows[i] if rows is not None else None,
            )
            for i in range(b)
        ]

    def save_checkpoint(self, path) -> None:
        """Persist the imported (optimized) weights as a fast-loading
        ``.btck`` checkpoint in the JAX package's format; pass its path to
        ``model_path`` later (SURVEY §5.4)."""
        from .checkpoint import save_checkpoint

        save_checkpoint(self._imported, path)

    # -- streaming whole-recording path ---------------------------------------

    def streaming_timeout_scale(
        self, batch_size: int, n_segments: Optional[int] = None
    ) -> int:
        """Factor converting a per-batch timeout budget into a
        per-superchunk one: the streaming paths wait on whole superchunks
        (up to MONITORED_MAX_TILES x tile segments, a run with a timeout
        being monitored), so a timeout meant to bound one
        ``predict_batch(batch_size)`` call scales to the same per-segment
        allowance.

        ``n_segments``, when known, caps the scale at the tiles the
        recording dispatches, ``ceil(n_segments / tile)``: this engine runs
        exactly that many tiles. The JAX package rounds the count up to its
        compiled tile buckets (1, 2, 3, 4, 6, 8, 12, 16, ...), so the two
        agree wherever the count is a bucket size and this one is smaller
        elsewhere (ROADMAP C, deliberate differences)."""
        from .compiler.stream import MONITORED_MAX_TILES

        tile = self._streaming_engine().tile
        tiles = MONITORED_MAX_TILES
        if n_segments is not None and n_segments > 0:
            tiles = min(tiles, -(-int(n_segments) // tile))
        return max(1, -(-tiles * tile // max(1, batch_size)))

    def _streaming_engine(self):
        """The streaming engine, built on first use. It shares the per-call
        engine's params (no second copy on the device) and runs at its
        precision. A mesh engine streams through itself."""
        if getattr(self._engine, "streams_natively", False):
            return self._engine
        if self._stream is None:
            with self._stream_lock:
                if self._stream is None:
                    from .compiler.stream import StreamingEngine

                    self._stream = StreamingEngine(
                        self._imported,
                        self._config,
                        device=self._engine.device,
                        precision=self._engine.precision,
                        top_k=self._top_k,
                        params=self._engine.params,
                        species_mask=self._species_mask,
                    )
        return self._stream

    def analyze_samples(
        self,
        samples,
        overlap_seconds: float = 0.0,
        options: Optional[InferenceOptions] = None,
        species_mask: Optional[np.ndarray] = None,
    ):
        """Classify every (overlapping) segment of a full recording in one
        streaming pass (the reference CLI's host-side chunk → predict_batch
        loop, birdnet-analyze.rs:707-743, on the device): audio uploads once
        per superchunk, framing, inference and top-K run on the device, and
        only top-K results come back.

        ``samples``: 1-D float32 in [-1, 1) or raw int16 PCM (scaled on the
        device). Returns ``list[(start_time_seconds, list[Prediction])]``.
        ``species_mask``: optional per-call bool [num_species] candidate
        mask (composes with the build-time species list).
        """
        with span("birdnet.classifier.analyze_samples", numbered=True):
            mask = self._validate_call_mask(species_mask)
            eng = self._streaming_engine()
            conf, idx, times = eng.analyze(
                samples, overlap_seconds, options, species_mask=mask
            )
            # The per-segment result objects, and the collections they set
            # off (the span's ``.gc`` child) once the pause has ended.
            with span("birdnet.classifier.results"):
                return self._result_rows(conf, idx, times.tolist(), mask)

    def _validate_call_mask(self, species_mask):
        if species_mask is None:
            return None
        mask = np.asarray(species_mask, dtype=bool).reshape(-1)
        if mask.shape[0] != self._config.num_species:
            raise InputSizeError(
                expected=self._config.num_species, got=mask.shape[0]
            )
        return mask

    def analyze_samples_iter(
        self,
        samples,
        overlap_seconds: float = 0.0,
        options: Optional[InferenceOptions] = None,
        chunk_segments: Optional[int] = None,
        species_mask: Optional[np.ndarray] = None,
    ):
        """Generator variant of :meth:`analyze_samples`: yields
        ``(start_time, predictions)`` chunk by chunk, so callers see partial
        results before the whole recording finishes and cancellation between
        chunks loses at most one chunk of output."""
        from .compiler.stream import MAX_TILES

        mask = self._validate_call_mask(species_mask)
        eng = self._streaming_engine()
        samples = np.asarray(samples)
        S = self._config.sample_count
        step = S - int(overlap_seconds * self._config.sample_rate)
        if step <= 0:
            raise InferenceError("overlap must be smaller than the segment duration")
        n_total = samples.shape[0]
        n_segments = -(-n_total // step) if n_total else 0
        if chunk_segments is None:
            chunk_segments = MAX_TILES * eng.tile
        for seg0 in range(0, n_segments, chunk_segments):
            seg1 = min(seg0 + chunk_segments, n_segments)
            lo = seg0 * step
            hi = (seg1 - 1) * step + S
            conf, idx, times = eng.analyze(
                samples[lo:hi], overlap_seconds, options,
                n_segments=seg1 - seg0, species_mask=mask,
            )
            t0 = lo / self._config.sample_rate
            # Built inside the collector's pause, yielded outside it: a
            # consumer that stops iterating must not hold the collector off.
            yield from self._result_rows(
                conf, idx, [t0 + t for t in times.tolist()], mask)

    def analyze_wav(
        self,
        path,
        overlap_seconds: float = 0.0,
        options: Optional[InferenceOptions] = None,
        resample: bool = False,
        species_mask: Optional[np.ndarray] = None,
    ):
        """One-call WAV analysis: read (raw int16), validate the sample rate
        (optionally resampling on the classifier's device), and stream the
        whole recording. Returns ``list[(start_time_seconds,
        list[Prediction])]`` (the reference CLI's end-to-end flow,
        birdnet-analyze.rs:275-650)."""
        from .errors import AudioFormatError
        from .utils.audio_io import read_wav

        samples, rate, _ = read_wav(path, dtype="int16")
        if rate != self._config.sample_rate:
            if not resample:
                raise AudioFormatError(
                    f"model expects {self._config.sample_rate} Hz audio, WAV is "
                    f"{rate} Hz (pass resample=True to convert)"
                )
            from .ops.resample import resample_audio

            samples = resample_audio(
                samples, rate, self._config.sample_rate, out_dtype=np.int16,
                device=self._engine.device,
            )
        return self.analyze_samples(
            samples, overlap_seconds, options, species_mask=species_mask
        )

    def embed_samples(
        self,
        samples,
        overlap_seconds: float = 0.0,
        options: Optional[InferenceOptions] = None,
    ):
        """Bulk embedding extraction over a full recording (v3.0/Perch):
        returns ``(embeddings [N, E], start_times [N])``. A model without
        embeddings (v2.4) raises :class:`InferenceError`."""
        with span("birdnet.classifier.embed_samples", numbered=True):
            eng = self._streaming_engine()
            _, _, times, emb = eng.analyze(
                samples, overlap_seconds, options, with_embeddings=True
            )
            return emb, times

    # -- helpers -------------------------------------------------------------

    def _result_rows(self, conf, idx, starts, row_mask):
        """``[(start, list[Prediction])]`` of a streamed stretch, built in
        one pass over its ``[N, K]`` top-K with the cyclic collector paused:
        the rows are acyclic and the caller keeps them, so a collection
        inside the build would free nothing and scan every row on its way
        to the oldest generation. A collection that falls due meanwhile
        runs once, as the pause ends."""
        with collector_paused() as paused:
            rows = list(zip(starts, top_k_rows_from_device(
                conf, idx, self._labels, self._min_confidence,
                self._allowed(row_mask))))
        count("birdnet.classifier.result_rows", len(rows))
        if paused:
            count("birdnet.classifier.results_paused")
        return rows

    def _allowed(self, row_mask):
        """The build-time species mask AND the per-call one as one bool
        array (an index past either mask's end is not allowed), or None
        when neither restricts."""
        masks = [m for m in (self._species_mask, row_mask) if m is not None]
        if not masks:
            return None
        n = min(len(m) for m in masks)
        allowed = np.ones(n, dtype=bool)
        for m in masks:
            allowed &= np.asarray(m[:n], dtype=bool)
        return allowed

    def _result(self, conf, idx, logits, emb, row_mask=None) -> PredictionResult:
        predictions = top_k_rows_from_device(
            conf[None], idx[None], self._labels, self._min_confidence,
            self._allowed(row_mask),
        )[0]
        embeddings = None
        if emb is not None and self._config.model_type.has_embeddings:
            embeddings = np.asarray(emb)
        return PredictionResult(
            model_type=self._config.model_type,
            predictions=predictions,
            embeddings=embeddings,
            raw_scores=np.asarray(logits),
        )
