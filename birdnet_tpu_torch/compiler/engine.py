"""Inference engine: the eager forward plus the fused top-K, per call.

The counterpart of :mod:`birdnet_tpu.compiler.engine`. Differences that
follow from eager PyTorch:

- No batch buckets. XLA needs static shapes, so the JAX engine pads a batch
  up to a power of two; eager torch runs the batch at its own size.
  ``n_valid`` keeps its meaning: results are sliced back to the real rows.
- No compile step: ``warmup`` runs the forward once per batch size (and
  builds the CUDA kernels when the policy reaches them).
- The fused top-K runs on the device; only ``[B, K]`` results and the
  logits (and embeddings, when asked for) are read back.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np
import torch

from .._demux import demux_indices
from ..errors import (
    InferenceCancelledError,
    InferenceError,
    InferenceTimeoutError,
)
from ..inference_options import InferenceOptions
from ..types import ModelConfig
from .importer import ImportedModel, make_forward, params_to_torch

_MONITOR_POLL_S = 0.01  # 10 ms poll, matching the reference monitor thread
                        # (reference: src/classifier.rs:527-554)


def default_precision(device: torch.device) -> str:
    """``mixed`` on CUDA, ``fp32`` on the host (as the JAX engine picks
    ``mixed`` on an accelerator)."""
    return "mixed" if device.type == "cuda" else "fp32"


class InferenceEngine:
    """Model forward + fused top-K on one explicit device."""

    def __init__(
        self,
        imported: ImportedModel,
        config: ModelConfig,
        device: torch.device,
        precision: Optional[str] = None,
        top_k: int = 10,
        species_mask: Optional[np.ndarray] = None,
        params: Optional[Dict[str, torch.Tensor]] = None,
    ):
        self.device = torch.device(device)
        self.precision = precision or default_precision(self.device)
        self.config = config
        self.top_k = max(0, min(top_k, config.num_species))
        self.species_mask = (
            None if species_mask is None
            else torch.as_tensor(np.asarray(species_mask, bool), device=self.device)
        )
        self._forward = make_forward(imported, self.precision, self.device)
        self.params = (
            params if params is not None
            else params_to_torch(imported.params, self.device)
        )
        self.logits_index, self.embed_index = demux_indices(config.model_type)
        for what, i in (("logits", self.logits_index), ("embeddings", self.embed_index)):
            if i is not None and i >= imported.num_outputs:
                raise InferenceError(
                    f"model has {imported.num_outputs} outputs; expected "
                    f"{what} at index {i}"
                )

    def warmup(self, batch_sizes=(1,)) -> None:
        """Run the forward once per batch size (builds the kernels)."""
        for b in batch_sizes:
            self.run_batch(np.zeros((b, self.config.sample_count), np.float32))

    def run_batch(
        self,
        segments: np.ndarray,
        options: Optional[InferenceOptions] = None,
        with_embeddings: bool = True,
        row_masks: Optional[np.ndarray] = None,
        n_valid: Optional[int] = None,
    ):
        """Run a ``[B, S]`` float32 batch. Returns numpy
        (conf [B,k], idx [B,k], logits [B,N], embeddings [B,E] or None).

        ``row_masks``: optional per-row bool ``[n_valid, num_species]``
        candidate masks. ``n_valid``: the real row count when ``segments``
        arrives padded; padded rows get all-True masks and are sliced off.
        """
        b = n_valid if n_valid is not None else segments.shape[0]
        try:
            x = torch.from_numpy(np.ascontiguousarray(segments, np.float32)).to(self.device)
            rows = None
            if row_masks is not None:
                full = np.ones((segments.shape[0], self.config.num_species), bool)
                full[:b] = row_masks
                rows = torch.from_numpy(full).to(self.device)
            with torch.inference_mode():
                outs = self._forward(self.params, x)
                logits = outs[self.logits_index]
                if self.top_k > 0:
                    from ..ops.topk import fused_sigmoid_topk

                    conf, idx = fused_sigmoid_topk(
                        logits, self.top_k, self.species_mask, rows
                    )
                else:
                    conf = logits.new_zeros((logits.shape[0], 0))
                    idx = torch.zeros((logits.shape[0], 0), dtype=torch.int32,
                                      device=logits.device)
                emb = (
                    outs[self.embed_index]
                    if with_embeddings and self.embed_index is not None
                    else None
                )
            done = None
            if self.device.type == "cuda":
                done = torch.cuda.Event()
                done.record(torch.cuda.current_stream(self.device))
            _wait(done, options)
            conf, idx, logits = (_host(t[:b]) for t in (conf, idx, logits))
            emb = _host(emb[:b]) if emb is not None else None
        except (InferenceCancelledError, InferenceTimeoutError):
            raise
        except Exception as e:  # noqa: BLE001 - device runtime failures (OOM, …)
            raise InferenceError(str(e)) from e
        return conf, idx, logits, emb


def _host(t: torch.Tensor) -> np.ndarray:
    """Read a result back; bf16 (``fast``/``bf16`` activations) comes back
    as float32, because numpy has no bfloat16."""
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()


def _wait(done: Optional["torch.cuda.Event"], options: Optional[InferenceOptions],
          started: Optional[float] = None) -> None:
    """Block until the device work recorded by ``done`` is finished,
    honouring timeout and cancellation (``done`` None: host work, already
    finished). The timeout runs from ``started`` (``time.monotonic()``,
    default now): a streaming superchunk's budget starts at its dispatch,
    so host work that already took longer than the timeout times out.

    A launched CUDA kernel cannot be killed (unlike
    ``ort::RunOptions::terminate``, reference: src/classifier.rs:539-547);
    on timeout/cancel the wait is abandoned and the device work completes
    in the background — the same observable errors.
    """
    if options is None or not options.needs_monitor():
        if done is not None:
            done.synchronize()
        return
    token = options.cancellation_token
    # A non-positive timeout is an already-expired deadline.
    deadline = (
        (time.monotonic() if started is None else started) + options.timeout
        if options.timeout is not None
        else None
    )
    if token is not None and token.is_cancelled():
        raise InferenceCancelledError()
    if deadline is not None and (
        options.timeout <= 0 or (done is None and time.monotonic() > deadline)
    ):
        raise InferenceTimeoutError(options.timeout)
    while True:
        if done is None or done.query():
            return
        if token is not None and token.is_cancelled():
            raise InferenceCancelledError()
        if deadline is not None and time.monotonic() > deadline:
            raise InferenceTimeoutError(options.timeout)
        time.sleep(_MONITOR_POLL_S)
