"""Build and load the port's CUDA kernels.

Every ``*.cu`` file under ``birdnet_tpu_torch/csrc/`` is compiled by
``nvcc`` for ``sm_90a`` into ONE shared library with a plain C interface,
which :func:`load_library` loads with ``ctypes``. The build runs at first
use, into ``birdnet_tpu_torch/_build/`` (git-ignored). The library's file
name carries a hash of the sources and the flags, so a stale build is
never loaded. A failed build raises :class:`KernelBuildError` with the
compiler's output; nothing falls back.

Nothing here runs at import time: the CPU tier imports this module on
machines that have no ``nvcc``.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

_PKG_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = _PKG_DIR / "csrc"
BUILD_DIR = _PKG_DIR / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)

DEFAULT_NVCC = "/usr/local/cuda/bin/nvcc"

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_launch_lock = threading.Lock()
_tallies = threading.local()


def count_launch(launches: dict, key: str) -> None:
    """Add one to ``launches[key]``, a wrapper's launch count. Wrappers run
    in several host threads at once (a server's batcher workers beside its
    streaming requests), and ``+=`` on a dict entry reads, adds and stores
    in steps that two threads can interleave, losing a count. Inside
    :func:`tally_launches` the count is also noted for the calling thread."""
    with _launch_lock:
        launches[key] += 1
    tally = getattr(_tallies, "current", None)
    if tally is not None:
        tally.append((launches, key))


@contextlib.contextmanager
def tally_launches():
    """Note each count this thread makes inside the block, as a list of
    ``(launches, key)`` pairs, so that a CUDA graph knows which launches it
    captured (other threads' counts are not in it)."""
    outer = getattr(_tallies, "current", None)
    _tallies.current = tally = []
    try:
        yield tally
    finally:
        _tallies.current = outer


def add_launches(tally, times: int = 1) -> None:
    """Add ``times`` to the count of each ``(launches, key)`` in ``tally``
    (a negative ``times`` takes counts back): a graph replay runs the
    kernels its capture counted without passing through their wrappers."""
    with _launch_lock:
        for launches, key in tally:
            launches[key] += times


_holds = threading.local()


def hold(obj):
    """``obj`` (device memory that a lowering or a kernel wrapper takes
    from a cache of its own), noted for the CUDA graph this thread is
    capturing, if any (:func:`holding`): a graph reads its operands at
    their addresses on every replay, so it keeps them alive, and a cache
    may drop them while the graph lives."""
    held = getattr(_holds, "current", None)
    if held is not None:
        held.append(obj)
    return obj


@contextlib.contextmanager
def holding():
    """Collect what :func:`hold` notes in this thread inside the block, as a
    list for the graph captured there to keep."""
    outer = getattr(_holds, "current", None)
    _holds.current = held = []
    try:
        yield held
    finally:
        _holds.current = outer


_capture_lock = threading.RLock()


@contextlib.contextmanager
def one_capture_at_a_time():
    """Hold the process's capture lock inside the block: a CUDA graph is
    captured there, with its warm-up calls and the device-wide synchronize
    before it (``torch.cuda.graph`` adds one of its own and empties the
    allocator's cache as it begins). Each capture runs in CUDA's
    thread-local mode, so that other threads' event waits, blocking copies
    and replays go on beside it; the lock keeps two captures, and a
    capture and another thread's device-wide synchronize made under it,
    from overlapping. Re-entrant."""
    with _capture_lock:
        yield


class KernelBuildError(RuntimeError):
    """The CUDA kernels could not be compiled or loaded."""


def _sources():
    srcs = sorted(CSRC_DIR.glob("*.cu"))
    if not srcs:
        raise KernelBuildError(f"no CUDA sources under {CSRC_DIR}")
    return srcs


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(cuda_home, "bin", "nvcc")] if cuda_home else []
    candidates += [shutil.which("nvcc") or "", DEFAULT_NVCC]
    for c in candidates:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise KernelBuildError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH); the CUDA "
        "kernels are built from birdnet_tpu_torch/csrc at first use"
    )


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256()
    for src in _sources() + sorted(CSRC_DIR.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libbirdnet_kernels-{h.hexdigest()[:16]}.so"


def _run_all(cmds) -> None:
    """Run the commands at once; raise with the output of the first that
    fails."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                    text=True)) for cmd in cmds]
    failed = None
    for cmd, proc in procs:
        output, _ = proc.communicate()
        if proc.returncode != 0 and failed is None:
            failed = f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{output}"
    if failed is not None:
        raise KernelBuildError(failed)


def build() -> Path:
    """Compile the sources if their library is not built yet; return its
    path. Each source compiles in its own ``nvcc``, all started together;
    then one ``nvcc`` links the objects. The link writes to a temporary
    name that is renamed into place, so a concurrent or interrupted build
    never leaves a partial library under the final name."""
    out = library_path()
    if out.exists():
        return out
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as work:
        objs = [os.path.join(work, f"{src.stem}.o") for src in _sources()]
        _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)]
                  for src, obj in zip(_sources(), objs)])
        tmp = os.path.join(work, out.name)
        _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", tmp, *objs]])
        os.replace(tmp, out)
    return out


def _declare(lib: ctypes.CDLL) -> None:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.bn_filterbank_logpower_f32.argtypes = [p, p, p, i, i, i, i, i, i, f, f, p]
    lib.bn_filterbank_logpower_f32.restype = i
    lib.bn_filterbank_logpower_bf16.argtypes = [p, p, p, i, i, i, i, i, i, i, i, f, f, p]
    lib.bn_filterbank_logpower_bf16.restype = i
    lib.bn_stft_melspec_f32.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, f, f, p]
    lib.bn_stft_melspec_f32.restype = i
    lib.bn_stft_melspec_bf16.argtypes = [p, p, p, p, i, i, i, i, i, i, i, i, i, f, f, p]
    lib.bn_stft_melspec_bf16.restype = i
    lib.bn_frontend_bf16_max_hop.argtypes = [i, i, i]
    lib.bn_frontend_bf16_max_hop.restype = i
    lib.bn_qconv1x1_requant.argtypes = [p, p, p, p, p, i, i, i, i, i, i, f, i, p]
    lib.bn_qconv1x1_requant.restype = i
    ints, ptrs = ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_void_p)
    lib.bn_stage_stack_forward.argtypes = [i, i, i, ints, ptrs, p, p, p, p, p, p, p,
                                           i, i, i, i, p]
    lib.bn_stage_stack_forward.restype = i
    lib.bn_frame_filterbank_logpower.argtypes = [i, p, p, p, i, ctypes.c_longlong,
                                                 i, i, i, i, i, i, i, f, f, p]
    lib.bn_frame_filterbank_logpower.restype = i
    lib.bn_frame_filterbank_max_hop.argtypes = [i, i, i]
    lib.bn_frame_filterbank_max_hop.restype = i
    ll = ctypes.c_longlong
    lib.bn_bias_gelu.argtypes = [p, p, p, ll, i, ll, i, f, i, i, i, p]
    lib.bn_bias_gelu.restype = i
    lib.bn_channel_ln_gelu.argtypes = [p, p, p, p, i, i, i, i, f, f, i, i, i, p]
    lib.bn_channel_ln_gelu.restype = i


def load_library() -> ctypes.CDLL:
    """The kernels' library, built on first call and loaded once."""
    global _lib
    with _lock:
        if _lib is None:
            path = build()
            try:
                lib = ctypes.CDLL(str(path))
            except OSError as e:
                raise KernelBuildError(f"cannot load {path}: {e}") from e
            _declare(lib)
            _lib = lib
        return _lib


def check(status: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA error {status} at launch")
