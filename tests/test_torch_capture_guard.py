"""The collector pause around the port's CUDA graph captures
(``birdnet_tpu_torch/utils/collector.py::collector_paused``): Python's
cyclic collector, run in the middle of a capture, finalizes dead cycles,
and one holding another CUDA graph or a pinned buffer makes an unsafe CUDA
call that invalidates the capture. The card's side is in
tests/test_torch_cuda.py; here, on the host, the pause itself and that
every capture in the port, its scripts and chip_smoke.py runs inside one."""

import ast
import gc
import threading
from pathlib import Path

import pytest

pytest.importorskip("torch")

from birdnet_tpu_torch.utils.collector import collector_paused  # noqa: E402

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture
def collector_on():
    was_on = gc.isenabled()
    gc.enable()
    yield
    # As it was before the test, whatever the test left.
    (gc.enable if was_on else gc.disable)()


@pytest.mark.parametrize("before", [True, False])
def test_the_pause_restores_what_was_there(collector_on, before):
    """Off inside the block; after it, on again only if it was on before."""
    if not before:
        gc.disable()
    with collector_paused():
        assert not gc.isenabled()
    assert gc.isenabled() is before


def test_the_pause_holds_a_cycle_until_it_ends(collector_on):
    """A dead cycle made inside the block outlives allocations that would
    set off collections, and goes at the first collection after it."""
    gone = []

    class Node:
        def __del__(self):
            gone.append(1)

    with collector_paused():
        node = Node()
        node.self = node
        del node
        junk = [[] for _ in range(20 * gc.get_threshold()[0])]
        assert gone == [] and len(junk)
    gc.collect()
    assert gone == [1]


def test_overlapping_pauses_in_two_threads(collector_on):
    """The collector stays off until the last of two overlapping blocks
    (one in another thread) ends, whichever ends first."""
    entered, release, done = threading.Event(), threading.Event(), threading.Event()

    def other():
        with collector_paused():
            entered.set()
            release.wait(10)
        done.set()

    t = threading.Thread(target=other)
    with collector_paused():
        t.start()
        assert entered.wait(10)
    assert not gc.isenabled()  # the other thread's block is still open
    release.set()
    assert done.wait(10)
    t.join(10)
    assert gc.isenabled()


def test_the_pause_ends_when_the_block_raises(collector_on):
    with pytest.raises(RuntimeError), collector_paused(), collector_paused():
        raise RuntimeError("capture refused")
    assert gc.isenabled()


@pytest.mark.parametrize("before", [True, False])
def test_only_the_block_that_turned_it_off_is_told_so(collector_on, before):
    """The outer block is given True where it turned the collector off; a
    nested block, and any block while the caller had it off, False."""
    if not before:
        gc.disable()
    with collector_paused() as outer:
        with collector_paused() as inner:
            assert (outer, inner) == (before, False)
    assert gc.isenabled() is before


def test_a_block_beside_another_threads_block_is_told_false(collector_on):
    entered, release = threading.Event(), threading.Event()
    told = []

    def other():
        with collector_paused() as turned_off:
            told.append(turned_off)
            entered.set()
            release.wait(10)

    t = threading.Thread(target=other)
    t.start()
    assert entered.wait(10)
    with collector_paused() as turned_off:
        assert not turned_off
    release.set()
    t.join(10)
    assert not t.is_alive() and told == [True] and gc.isenabled()


def _capture_files():
    files = sorted((REPO / "birdnet_tpu_torch").rglob("*.py"))
    files += sorted((REPO / "scripts").glob("torch_*.py")) + [REPO / "chip_smoke.py"]
    return [f for f in files if "torch.cuda.graph(" in f.read_text()]


def _calls(item: ast.withitem, name: str) -> bool:
    f = item.context_expr.func if isinstance(item.context_expr, ast.Call) else None
    return (isinstance(f, ast.Name) and f.id == name) or (
        isinstance(f, ast.Attribute) and f.attr == name)


def _unpaused_captures(tree: ast.AST) -> list:
    """Line numbers of ``with torch.cuda.graph(...)`` items that no
    ``collector_paused()`` item, in the same ``with`` or one around it,
    covers."""
    bad = []

    def walk(node, paused):
        if isinstance(node, ast.With):
            for item in node.items:
                paused = paused or _calls(item, "collector_paused")
                if _calls(item, "graph") and not paused:
                    bad.append(node.lineno)
        for child in ast.iter_child_nodes(node):
            walk(child, paused and not isinstance(
                child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)))

    walk(tree, False)
    return bad


@pytest.mark.parametrize("path", _capture_files(), ids=lambda p: str(p.relative_to(REPO)))
def test_every_capture_runs_with_the_collector_paused(path):
    """Each ``torch.cuda.graph`` capture in the port, its scripts and
    chip_smoke.py sits inside ``collector_paused()``."""
    assert _unpaused_captures(ast.parse(path.read_text())) == []


def _global_captures(tree: ast.AST) -> list:
    """Line numbers of ``torch.cuda.graph(...)`` calls without
    ``capture_error_mode="thread_local"``."""
    return [node.lineno for node in ast.walk(tree)
            if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
            and node.func.attr == "graph"
            and not any(k.arg == "capture_error_mode" and isinstance(k.value, ast.Constant)
                        and k.value.value == "thread_local" for k in node.keywords)]


@pytest.mark.parametrize("path", [p for p in _capture_files()
                                  if p.is_relative_to(REPO / "birdnet_tpu_torch")],
                         ids=lambda p: str(p.relative_to(REPO)))
def test_every_capture_in_the_port_is_thread_local(path):
    """A capture in CUDA's global mode refuses every other thread's event
    waits and blocking copies, and they invalidate it: the port's captures
    (stream keys, batch context, mesh steps) run in thread-local mode, so
    that concurrent callers of one classifier go on beside them
    (tests/test_torch_cuda.py::test_batch_context_capture_beside_streaming_threads
    on the card)."""
    assert _global_captures(ast.parse(path.read_text())) == []
