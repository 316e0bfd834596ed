"""The comparison that decides ``correct``, driven through a whole run at
a small size on the CPU (the look for a card skipped): the program as the
configuration states it passes, and its int8 path (the control) and each
fault a cell can have, planted under the timed path, come out not correct:
among them faults confined to a few rows (one tile slot, each recording's
last segment), which the 90th percentiles let through and the share of
rows over the per-row limit does not."""

import contextlib
import dataclasses
import time

import numpy as np
import pytest

from benchmark.harness import audio, cell
from benchmark.tests.small import small_cell

WORKLOADS = ["v24_stream_1h", "perch_embed_1h"]
SEGMENT_SECONDS = {"v24_stream_1h": 3, "perch_embed_1h": 5}


# The tile slot the one-slot fault alters; the small cells' species.
SLOT, SPECIES = 5, 24


@pytest.fixture
def every_segment(monkeypatch):
    """The check compares every segment of each kept recording (up to 200)."""
    monkeypatch.setattr(audio, "CHECK_SEGMENTS", 200)


def _run(workload, int8=False, patches=None, width=0.1, full_depth=False, keep_rows=False,
         **traffic):
    c = small_cell(workload, width=width, full_depth=full_depth, **traffic)
    return cell.run(workload, 2**31 + 21, 0.5, False, time.perf_counter(), device="cpu",
                    cell=c, int8=int8, patches=patches, keep_rows=keep_rows)


@contextlib.contextmanager
def _answer_altered():
    """Each answer altered where it is produced: the top species moved to
    its neighbour, or each embedding shifted by half its largest entry."""
    from birdnet_tpu_torch.compiler import stream

    orig = stream.StreamingEngine._drain

    def drain(self, outs, n):
        arrays = [np.array(a) for a in orig(self, outs, n)]
        if len(arrays) > 2:
            e = arrays[2]
            arrays[2] = e + 0.5 * np.abs(e).max(axis=1, keepdims=True)
        else:
            arrays[1][:, 0] = (arrays[1][:, 0] + 1) % self.config.num_species
        return arrays

    stream.StreamingEngine._drain = drain
    try:
        yield
    finally:
        stream.StreamingEngine._drain = orig


def _alter_rows(arrays, rows, num_species):
    """The answers of ``rows`` altered: the top species moved to its
    neighbour, or the embedding shifted by its largest entry."""
    arrays = [np.array(a) for a in arrays]
    if len(arrays) > 2:
        e = arrays[2][rows]
        arrays[2][rows] = e + np.abs(e).max(axis=1, keepdims=True)
    else:
        arrays[1][rows, 0] = (arrays[1][rows, 0] + 1) % num_species
    return arrays


@contextlib.contextmanager
def _one_slot_altered():
    """One tile slot's answer altered in every tile the stream runs."""
    from birdnet_tpu_torch.compiler import stream

    orig = stream.StreamingEngine._drain

    def drain(self, outs, n):
        return _alter_rows(orig(self, outs, n), np.arange(SLOT, n, self.tile),
                           self.config.num_species)

    stream.StreamingEngine._drain = drain
    try:
        yield
    finally:
        stream.StreamingEngine._drain = orig


@contextlib.contextmanager
def _last_segment_altered():
    """Each recording's last segment answered wrong."""
    from birdnet_tpu_torch import classifier

    analyze, embed = classifier.Classifier.analyze_samples, classifier.Classifier.embed_samples

    def analyze_samples(self, *args, **kwargs):
        out = analyze(self, *args, **kwargs)
        t, preds = out[-1]
        out[-1] = (t, [dataclasses.replace(p, index=(p.index + 1) % SPECIES) for p in preds])
        return out

    def embed_samples(self, *args, **kwargs):
        emb, *rest = embed(self, *args, **kwargs)
        emb = np.array(emb)
        emb[-1] += np.abs(emb[-1]).max()
        return (emb, *rest)

    classifier.Classifier.analyze_samples = analyze_samples
    classifier.Classifier.embed_samples = embed_samples
    try:
        yield
    finally:
        classifier.Classifier.analyze_samples = analyze
        classifier.Classifier.embed_samples = embed


@contextlib.contextmanager
def _half_tile_left_out():
    """Half of each tile left out: its second half's rows given the first
    half's frames."""
    from birdnet_tpu_torch.compiler import stream

    orig = stream.frame_tile

    def frame_tile(*args, **kwargs):
        frames = orig(*args, **kwargs).clone()
        half = frames.shape[0] // 2
        frames[half:2 * half] = frames[:half]
        return frames

    stream.frame_tile = frame_tile
    try:
        yield
    finally:
        stream.frame_tile = orig


@pytest.mark.parametrize("workload", WORKLOADS)
def test_sound_program_is_correct(workload):
    r = _run(workload)
    assert r["failed"] == 0 and r["attempted"] >= 1
    assert r["correct"], r["checks"]
    assert all(c["value"] <= c["limit"] for c in r["checks"].values())


@pytest.mark.parametrize("workload", WORKLOADS)
def test_int8_control_reads_far_above_the_program(workload, monkeypatch):
    # Half the width at the configuration's depth and embedding width, 20
    # segments a recording: smaller, the int8 forward drifts too little to
    # show. At the cells' own size the control is refused outright
    # (test_int8_control_at_the_cells_size, on the card).
    monkeypatch.setattr(audio, "CHECK_SEGMENTS", 20)
    kw = dict(width=0.5, recording_seconds=20 * SEGMENT_SECONDS[workload], full_depth=True,
              keep_rows=True)
    sound, control = _run(workload, **kw), _run(workload, int8=True, **kw)
    assert control["failed"] == 0
    # The 90th percentile of each per-row reading.
    p90 = {r: [np.percentile(run["rows"][r], 90) for run in (sound, control)]
           for r in sound["rows"]}
    assert max(c / s for s, c in p90.values()) >= 3, p90


@pytest.mark.cuda
@pytest.mark.parametrize("workload", WORKLOADS)
def test_int8_control_at_the_cells_size(workload):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control runs at the cell's own size")
    for seed in (2**31 + 31, 2**31 + 32, 2**31 + 33):
        r = cell.run(workload, seed, 3.0, False, time.perf_counter(), int8=True)
        assert r["failed"] == 0 and not r["correct"], r["checks"]


@pytest.mark.parametrize("workload", WORKLOADS)
@pytest.mark.parametrize("fault", [_answer_altered, _half_tile_left_out])
def test_planted_fault_is_not_correct(workload, fault, every_segment):
    # 40 segments: the CPU's 32-segment tile and part of a second one, every
    # segment in the check's sample.
    r = _run(workload, patches=fault, recording_seconds=40 * SEGMENT_SECONDS[workload])
    assert r["failed"] == 0
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("workload", WORKLOADS)
@pytest.mark.parametrize("fault,segments", [(_one_slot_altered, 100),
                                            (_last_segment_altered, 40)])
def test_fault_in_a_few_rows_is_not_correct(workload, fault, segments, every_segment):
    # One row in 32 (the CPU's tile) or in 40: under the tenth that a 90th
    # percentile ignores, so the share of rows over the per-row limit is
    # what refuses the run.
    r = _run(workload, patches=fault, recording_seconds=segments * SEGMENT_SECONDS[workload])
    assert r["failed"] == 0
    over = next(k for k in r["checks"] if k.endswith("_rows_over"))
    assert r["checks"][over]["value"] > r["checks"][over]["limit"], r["checks"]
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("workload", WORKLOADS)
def test_wrong_segment_count_fails(workload):
    from birdnet_tpu_torch import classifier

    def short(self, samples, *args, **kwargs):
        out = orig(self, samples, *args, **kwargs)
        return out[:-1] if isinstance(out, list) else (out[0][:-1], out[1][:-1])

    name = "analyze_samples" if workload.startswith("v24") else "embed_samples"
    orig = getattr(classifier.Classifier, name)
    setattr(classifier.Classifier, name, short)
    try:
        r = _run(workload)
    finally:
        setattr(classifier.Classifier, name, orig)
    assert r["failed"] == r["attempted"] and not r["correct"]
