"""A model's weights, drawn from the seed on the device in a few large
calls, then read back once to be written into the model file.

Every weight's spec (:class:`benchmark.models._builder.GraphBuilder`) is
one of: normal (mean, std), uniform (low, high) or zeros. All the normal
draws come from one ``torch.randn`` over their summed size, each leaf's
mean and std spread over its elements by ``repeat_interleave``; all the
uniform draws from one ``torch.rand``. The same seed on the same device
gives the same weights.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def generator(seed: int, device, stream: int) -> torch.Generator:
    """A generator on ``device`` for one stream of draws (weights 0,
    audio 1) of the run's seed; any whole number is taken modulo 2**63."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + stream) % (1 << 63))
    return g


def draw(specs, seed: int, device) -> Dict[str, np.ndarray]:
    """name -> float32 host array for every spec."""
    g = generator(seed, device, 0)
    by_kind = {"normal": [], "uniform": []}
    for spec in specs:
        if spec[2] in by_kind:
            by_kind[spec[2]].append(spec)
    flat = {}
    for kind, group in by_kind.items():
        if not group:
            continue
        counts = torch.tensor([int(np.prod(s[1])) for s in group], device=device)
        a = torch.tensor([s[3] for s in group], dtype=torch.float32, device=device)
        b = torch.tensor([s[4] for s in group], dtype=torch.float32, device=device)
        total = int(counts.sum())
        if kind == "normal":
            x = torch.randn(total, generator=g, device=device)
            x = x * b.repeat_interleave(counts) + a.repeat_interleave(counts)
        else:
            x = torch.rand(total, generator=g, device=device)
            x = a.repeat_interleave(counts) + x * (b - a).repeat_interleave(counts)
        flat[kind] = (group, x.cpu().numpy())
    out = {}
    for group, values in flat.values():
        pos = 0
        for name, shape, *_ in group:
            n = int(np.prod(shape))
            out[name] = values[pos:pos + n].reshape(shape)
            pos += n
    for name, shape, kind, *_ in specs:
        if kind == "zeros":
            out[name] = np.zeros(shape, np.float32)
    return out
