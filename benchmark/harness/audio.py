"""The traffic generator: whole recordings of seeded int16 audio.

One pool of int16 samples is made on the device from the run's seed at
set-up (Gaussian noise under a gain drawn per block, so segments differ in
loudness), read back once, and every recording is a view of it at an
offset drawn from the seed. Every seed gets recordings of the same length,
so every seed does the same work. The samples are ``N(0, 1) *
NOISE_SIGMA * U(GAIN_LOW, GAIN_HIGH)``, the gain drawn per block of
``GAIN_BLOCK_SECONDS``. A traffic file gives the parameters:

- ``recording_seconds``, ``overlap_seconds``: each call's recording and
  the overlap the call asks for;
- ``check_every``: which recordings' answers are kept for the check (one in
  ``check_every``, at a seeded phase, and the last); the check compares
  ``CHECK_SEGMENTS`` segments of each drawn from the seed, besides the
  first and the last.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..models.weights import generator

# Samples drawn on the device per call: bounds the pool's transient device
# memory to a few hundred MB.
CHUNK = 1 << 24
# The pool's length past one recording: the room for the offsets.
POOL_EXTRA_SECONDS = 120.0
NOISE_SIGMA = 3000.0
GAIN_BLOCK_SECONDS, GAIN_LOW, GAIN_HIGH = 1.0, 0.05, 1.0
CHECK_SEGMENTS = 48


class Recordings:
    def __init__(self, traffic: dict, cfg: dict, seed: int, device):
        rate = cfg["sample_rate"]
        self.length = int(round(traffic["recording_seconds"] * rate))
        self.step = cfg["sample_count"] - int(traffic["overlap_seconds"] * rate)
        self.n_segments = -(-self.length // self.step)
        pool_len = self.length + int(round(POOL_EXTRA_SECONDS * rate))
        block = max(1, int(round(GAIN_BLOCK_SECONDS * rate)))
        g = generator(seed, device, 1)
        gains = GAIN_LOW + (GAIN_HIGH - GAIN_LOW) * torch.rand(
            math.ceil(pool_len / block), generator=g, device=device)
        self.pool = np.empty(pool_len, np.int16)
        for lo in range(0, pool_len, CHUNK):
            hi = min(lo + CHUNK, pool_len)
            gain = gains[torch.arange(lo, hi, device=device) // block]
            x = torch.randn(hi - lo, generator=g, device=device) * NOISE_SIGMA * gain
            self.pool[lo:hi] = x.round_().clamp_(-32768, 32767).to(torch.int16).cpu().numpy()
        self._offsets = np.random.default_rng([int(seed) % (1 << 63), 2])
        self._check = np.random.default_rng([int(seed) % (1 << 63), 3])
        self.check_every = int(traffic["check_every"])
        self.check_phase = int(self._check.integers(self.check_every))
        self.check_segments = CHECK_SEGMENTS

    def warm(self) -> np.ndarray:
        """A recording for set-up's warm calls, at the pool's start."""
        return self.pool[:self.length]

    def next(self) -> np.ndarray:
        """The next recording of the window, at a seeded offset."""
        off = int(self._offsets.integers(0, self.pool.shape[0] - self.length + 1))
        return self.pool[off:off + self.length]

    def kept(self, ordinal: int) -> bool:
        """Whether the check keeps the answers of the window's recording
        ``ordinal`` (the last recording is kept besides)."""
        return ordinal % self.check_every == self.check_phase

    def sample(self) -> np.ndarray:
        """Segments of a kept recording the check compares: the first, the
        last and ``check_segments`` (``CHECK_SEGMENTS``) drawn from the
        seed."""
        n = self.n_segments
        drawn = self._check.choice(n, size=min(n, self.check_segments), replace=False)
        return np.unique(np.concatenate([[0, n - 1], drawn]))

    def segments(self, recording: np.ndarray, idx: np.ndarray, sample_count: int) -> np.ndarray:
        """The int16 samples ``[len(idx), sample_count]`` of segments
        ``idx``, zero past the recording's end."""
        out = np.zeros((len(idx), sample_count), np.int16)
        for row, i in enumerate(idx):
            part = recording[i * self.step:i * self.step + sample_count]
            out[row, :part.shape[0]] = part
        return out
