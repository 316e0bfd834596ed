"""The check that the run loaded neither JAX nor the JAX package: every
module in ``sys.modules`` compared by its top-level name (the part before
the first dot) as a whole, so that ``birdnet_tpu_torch`` is not taken for
``birdnet_tpu``."""

from __future__ import annotations

import sys
from typing import Iterable, List

FORBIDDEN = frozenset(("jax", "jaxlib", "flax", "birdnet_tpu"))


def forbidden_modules(names: Iterable[str] = None) -> List[str]:
    names = list(sys.modules) if names is None else names
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)
