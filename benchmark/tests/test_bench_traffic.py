"""The traffic generator: the same seed gives the same audio and the same
recordings, another seed other ones, every seed the same amount of work."""

import numpy as np

from benchmark.harness import audio
from benchmark.harness.audio import Recordings
from benchmark.tests.small import small_cell


def _recordings(seed, workload="v24_stream_1h", **traffic):
    cell = small_cell(workload, **traffic)
    return Recordings(cell.traffic, cell.config, seed, "cpu")


def test_same_seed_same_recordings():
    a, b = _recordings(2**31 + 11), _recordings(2**31 + 11)
    assert np.array_equal(a.pool, b.pool)
    for _ in range(5):
        assert np.array_equal(a.next(), b.next())
    assert a.check_phase == b.check_phase
    assert np.array_equal(a.sample(), b.sample())


def test_other_seed_other_audio_same_work():
    a, b = _recordings(3), _recordings(4)
    assert not np.array_equal(a.pool, b.pool)
    assert a.pool.shape == b.pool.shape and a.next().shape == b.next().shape
    assert a.n_segments == b.n_segments


def test_pool_is_int16_noise_under_block_gains():
    r = _recordings(7)
    assert r.pool.dtype == np.int16
    x = r.pool.astype(np.float64)
    assert 100 < x.std() < 3000 and np.abs(x.mean()) < 50


def test_segments_follow_the_overlap_and_pad_past_the_end():
    r = _recordings(5, overlap_seconds=1.5)
    S = 144_000
    assert r.step == S // 2
    rec = r.next()
    assert r.n_segments == -(-rec.shape[0] // r.step)
    idx = np.array([0, 1, r.n_segments - 1])
    seg = r.segments(rec, idx, S)
    assert np.array_equal(seg[1], rec[r.step:r.step + S])
    tail = rec[(r.n_segments - 1) * r.step:]
    assert np.array_equal(seg[2, :tail.shape[0]], tail) and not seg[2, tail.shape[0]:].any()


def test_check_sample_holds_first_and_last_segment(monkeypatch):
    monkeypatch.setattr(audio, "CHECK_SEGMENTS", 4)
    r = _recordings(9)
    s = r.sample()
    assert s[0] == 0 and s[-1] == r.n_segments - 1 and len(s) <= 6
    kept = [i for i in range(10) if r.kept(i)]
    assert kept == list(range(10))  # check_every 1 at the small size
