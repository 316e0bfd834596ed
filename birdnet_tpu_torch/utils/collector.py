"""Python's cyclic garbage collector paused around a block of host work.

Nothing here touches the device: the CPU tier imports it, and so do the
CUDA graph captures and the classifier's result rows.
"""

from __future__ import annotations

import contextlib
import gc
import threading

_collector_lock = threading.Lock()
_collector_pauses = 0
_collector_was_on = False


@contextlib.contextmanager
def collector_paused():
    """Python's cyclic garbage collector off, in every thread, inside the
    block. Blocks may nest and overlap across threads; the collector runs
    again after the last one ends, if it ran before the first began. The
    block is given whether it turned the collector off: False inside
    another block, or where the collector was off already.

    The state is read once, as the first block begins: a ``gc.disable()``
    that another thread makes while a block is open is undone when the
    last one ends.

    Two kinds of block use it:

    - a CUDA graph's capture. A collection inside a capture finalizes
      whatever dead cycles it finds, and one that holds another CUDA graph
      (a dropped engine's stream keys, a batch context) or a pinned buffer
      last used on the capturing stream makes an unsafe CUDA call in the
      middle of the capture: the capture is invalidated, and its next
      launch or its end raises ``cudaErrorStreamCaptureInvalidated``. Such
      cycles wait for a collection after the block.
    - the classifier's result rows of a streamed recording (thousands of
      acyclic ``Prediction`` lists the caller keeps): collections inside
      the build could free none of them, yet would scan each on its way to
      the oldest generation and set off full collections of the heap."""
    global _collector_pauses, _collector_was_on
    with _collector_lock:
        turned_off = False
        if _collector_pauses == 0:
            _collector_was_on = turned_off = gc.isenabled()
            gc.disable()
        _collector_pauses += 1
    try:
        yield turned_off
    finally:
        with _collector_lock:
            _collector_pauses -= 1
            if _collector_pauses == 0 and _collector_was_on:
                gc.enable()
