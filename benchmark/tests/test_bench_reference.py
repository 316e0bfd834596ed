"""The frozen generators keep the published widths and schedules, and the
plain reference computes the same model as the program: at a tenth of the
width on the CPU, the program at fp32 against the reference."""

import tempfile

import numpy as np
import pytest
import torch

from benchmark.harness import spec
from benchmark.harness.audio import Recordings
from benchmark.harness.program import build_classifier, calibrated, generator_module, write_model
from benchmark.models.weights import draw
from benchmark.reference import efficientnet_audio as ref
from benchmark.tests.small import small_cell

FAMILIES = [("v24_stream_1h", "birdnet_v24"), ("perch_embed_1h", "perch_v2")]


# EfficientNet's published schedules (Tan and Le, 2019, table 1, and the
# Keras application's block arguments scaled by width 1.2 for B3): per
# stage the output width, expand ratio, depthwise kernel, stride, blocks.
B0 = [(16, 1, 3, 1, 1), (24, 6, 3, 2, 2), (40, 6, 5, 2, 2), (80, 6, 3, 2, 3),
      (112, 6, 5, 1, 3), (192, 6, 5, 2, 4), (320, 6, 3, 1, 1)]
B3 = [(24, 1, 3, 1, 2), (32, 6, 3, 2, 3), (48, 6, 5, 2, 3), (96, 6, 3, 2, 5),
      (136, 6, 5, 1, 5), (232, 6, 5, 2, 6), (384, 6, 3, 1, 2)]
PUBLISHED = {"v24_stream_1h": (32, B0, 1024), "perch_embed_1h": (40, B3, 1536)}


@pytest.mark.parametrize("workload", sorted(PUBLISHED))
def test_generator_keeps_the_published_widths(workload):
    cfg = spec.load(workload).config
    stem, stages, head = PUBLISHED[workload]
    shapes = {name: shape for name, shape, *_ in generator_module(cfg).build(cfg).specs}
    assert shapes["stem.conv.w"] == (stem, 1, 3, 3) and shapes["head.conv.w"][0] == head
    b, c_in = 0, stem
    for (c_out, expand, kernel, stride, repeats), used in zip(stages, cfg["repeats"]):
        assert 1 <= used <= repeats
        for r in range(used):
            mid = c_in * expand
            assert shapes[f"b{b}.expand.conv.w"] == (mid, c_in, 1, 1)
            assert shapes[f"b{b}.dw.conv.w"] == (mid, 1, kernel, kernel)
            assert shapes[f"b{b}.se.reduce.w"] == (max(1, c_in // 4), mid, 1, 1)
            assert shapes[f"b{b}.project.conv.w"] == (c_out, mid, 1, 1)
            b, c_in = b + 1, c_out
    assert f"b{b}.expand.conv.w" not in shapes
    published = [s[4] for s in stages]
    assert cfg["repeats"] == published or "repeats" in cfg["reduced"]


@pytest.mark.parametrize("workload,family", FAMILIES)
def test_reference_computes_the_programs_model(workload, family):
    cell = small_cell(workload, width=0.1, species=24)
    cfg = dict(cell.config, precision="fp32")
    gb = generator_module(cfg).build(cfg)
    rec = Recordings(cell.traffic, cfg, 11, "cpu")
    weights = calibrated(cfg, draw(gb.specs, 11, "cpu"), rec, "cpu")
    pcm = rec.segments(rec.next(), np.arange(4), cfg["sample_count"])
    with tempfile.TemporaryDirectory() as tmp:
        clf = build_classifier(cfg, write_model(cfg, gb, weights, tmp), "cpu")
    got = clf.predict_batch(pcm.astype(np.float32) / 32768.0)
    with torch.inference_mode():
        want = ref.forward(cfg, {k: torch.from_numpy(v) for k, v in weights.items()},
                           torch.from_numpy(pcm))
    logits = np.stack([r.raw_scores for r in got])
    z = want["logits"].numpy()
    assert np.abs(logits - z).max() <= 1e-4 * np.abs(z).max()
    if cfg.get("embedding_dim"):
        emb = np.stack([r.embeddings for r in got])
        e = want["embedding"].numpy()
        assert np.abs(emb - e).max() <= 1e-4 * np.abs(e).max()


def test_calibration_normalizes_every_batch_norm():
    cell = small_cell("v24_stream_1h")
    cfg = dict(cell.config)
    gb = generator_module(cfg).build(cfg)
    rec = Recordings(cell.traffic, cfg, 5, "cpu")
    raw = draw(gb.specs, 5, "cpu")
    w = calibrated(cfg, raw, rec, "cpu")
    moved = [k for k in raw if k.endswith((".m", ".v")) and not np.array_equal(raw[k], w[k])]
    assert len(moved) == sum(1 for k in raw if k.endswith((".m", ".v")))
    assert all(np.array_equal(raw[k], w[k]) for k in raw if not k.endswith((".m", ".v")))
    assert min(w[k].min() for k in w if k.endswith(".v")) >= 0


def test_weights_are_drawn_from_the_seed():
    cfg = small_cell("v24_stream_1h").config
    specs = generator_module(cfg).build(cfg).specs
    a, b, c = draw(specs, 2**31 + 3, "cpu"), draw(specs, 2**31 + 3, "cpu"), draw(specs, 4, "cpu")
    assert all(np.array_equal(a[k], b[k]) for k in a)
    assert not np.array_equal(a["stem.conv.w"], c["stem.conv.w"])
    w = a["b1.expand.conv.w"]
    assert abs(w.std() - np.sqrt(2.0 / w[0].size)) < 0.2 * np.sqrt(2.0 / w[0].size)
    assert not a["output.b"].any()
