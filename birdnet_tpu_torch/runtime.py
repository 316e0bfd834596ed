"""Device discovery on CUDA.

The device is always explicit: :func:`resolve_device` maps a request
(``None`` meaning ``cuda:0``, ``"cuda"``, ``"cuda:1"``, ``"gpu"``,
``"cpu"``) to a ``torch.device``. A CUDA request where CUDA is not
available raises :class:`~birdnet_tpu_torch.errors.RuntimeInitError`;
nothing falls back to the CPU.
"""

from __future__ import annotations

from typing import Optional

import torch

from .errors import RuntimeInitError


def resolve_device(request: Optional[str] = None) -> torch.device:
    """The ``torch.device`` for a request; CUDA unless the CPU is asked for."""
    name = (request or "cuda").lower()
    if name == "gpu":
        name = "cuda"
    if name == "cpu":
        return torch.device("cpu")
    device_id = 0
    if name.startswith("cuda:") and name[5:].isdigit():
        name, device_id = "cuda", int(name[5:])
    if name != "cuda":
        raise RuntimeInitError(
            f"unknown device {request!r}; expected 'cuda', 'cuda:<n>' or 'cpu'"
        )
    if not torch.cuda.is_available():
        raise RuntimeInitError(
            "CUDA was requested but torch.cuda.is_available() is false; "
            "pass .with_device('cpu') to run on the host"
        )
    count = torch.cuda.device_count()
    if not 0 <= device_id < count:
        raise RuntimeInitError(
            f"device_id {device_id} out of range: {count} CUDA device(s)"
        )
    return torch.device("cuda", device_id)


def device_or_default(device=None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` is :func:`resolve_device`'s
    default, ``cuda:0`` (raising without CUDA)."""
    return resolve_device(None) if device is None else torch.device(device)
