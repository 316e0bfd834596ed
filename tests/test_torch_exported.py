"""Exporter-written BirdNET v2.4 / v3.0 / Perch v2 files through the port's
public API on the CPU, against the JAX package and each file's own oracle.

- The TF-export dialect (tests/_tf_dialect_models.py, bytes from the
  independent wire writer): STFT -> Mul/ReduceSum power -> MelWeightMatrix
  -> Log, NHWC Transpose sandwiches, SAME_UPPER convs, MaxPool, the Shape ->
  Gather -> Unsqueeze -> Concat -> Reshape flatten, axes as inputs; its
  oracle is ``TfOracle`` (float64 rfft, torch convs).
- The torch-export dialect (tests/test_external_full_models.py's modules,
  written by libtorch's TorchScript exporter): Constant,
  ConstantOfShape/Equal/Where/Expand (Perch's spatial embedding); its
  oracle is the module in eval mode.

Model-type detection, ``predict``, ``predict_batch``, ``analyze_samples``,
the embeddings demux (v3.0's at output 0, Perch's logits at index 3) and,
for the TF v2.4 file, the CLI, at fp32: against the oracle at the JAX
suite's tolerance (5e-4 for the TF dialect, 1e-4 for the torch export);
against the JAX package within 1e-4 of the output's scale (at least 1).
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from _tf_dialect_models import build_tf_dialect_model  # noqa: E402
from test_external_full_models import TorchPerch, TorchV24, TorchV30, _export  # noqa: E402

import birdnet_tpu as jbt  # noqa: E402
import birdnet_tpu_torch as tbt  # noqa: E402
from birdnet_tpu_torch.types import ModelType  # noqa: E402
from _torch_threads import torch_threads  # noqa: E402,F401

JAX_TOL = 1e-4


def _jax_atol(want) -> float:
    """1e-4 of the output's scale (at least 1): the TF files' logits reach
    ~50, where float32 sums over 12,288 terms differ by more than 1e-4."""
    return JAX_TOL * max(1.0, float(np.abs(np.asarray(want)).max()))

ORACLE_TOL = {"tf": 5e-4, "torch": 1e-4}
FAMILY = {
    "v24": (144_000, 48_000, ModelType.BIRDNET_V24),
    "v30": (160_000, 32_000, ModelType.BIRDNET_V30),
    "perch": (160_000, 32_000, ModelType.PERCH_V2),
}
TF_SPECIES = {"v24": 12, "v30": 15, "perch": 20}
TORCH_MODULES = {"v24": (TorchV24, 24, 1), "v30": (TorchV30, 40, 2), "perch": (TorchPerch, 50, 4)}
CASES = [(d, f) for d in ("tf", "torch") for f in FAMILY]
IDS = [f"{d}-{f}" for d, f in CASES]


def _segments(family, n=3, seed=7):
    s, sr, _ = FAMILY[family]
    r = np.random.default_rng(seed)
    t = np.arange(s, dtype=np.float32)
    return [(0.1 * np.sin(2 * np.pi * (700 + 250 * i) * t / sr)
             + 0.01 * r.standard_normal(s)).astype(np.float32) for i in range(n)]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """{(dialect, family): (path, labels, oracle)}; the oracle maps a batch
    ``[N, S]`` to the file's outputs as numpy."""
    d = tmp_path_factory.mktemp("exported")
    out = {}
    for seed, family in enumerate(FAMILY):
        data, tf_oracle = build_tf_dialect_model(family, num_species=TF_SPECIES[family],
                                                 seed=seed)
        path = d / f"tf_{family}.onnx"
        path.write_bytes(data)
        labels = [f"Genus{i}_Species {i}" for i in range(TF_SPECIES[family])]
        out["tf", family] = (str(path), labels, tf_oracle.forward)

        cls, n, n_out = TORCH_MODULES[family]
        torch.manual_seed(10 + seed)
        module = cls().eval()
        path = _export(d, module, FAMILY[family][0], n_out, f"torch_{family}")

        def oracle(x, module=module):
            with torch.no_grad():
                o = module(torch.from_numpy(np.asarray(x, np.float32)))
            return [t.numpy() for t in ((o,) if isinstance(o, torch.Tensor) else o)]

        out["torch", family] = (path, [f"Genus{i}_Species {i}" for i in range(n)], oracle)
    return out


@pytest.fixture(scope="module")
def pairs(files):
    """(port classifier, JAX classifier) at fp32 per file."""
    out = {}
    for key, (path, labels, _) in files.items():
        def build(pkg, path=path, labels=labels):
            b = pkg.Classifier.builder().model_path(path).labels(labels).top_k(5)
            b = b.precision("fp32")
            return b.with_device("cpu").build() if pkg is tbt else b.build()

        out[key] = (build(tbt), build(jbt))
    return out


def _oracle_logits(family, outs):
    return outs[3] if family == "perch" else outs[-1]


def _oracle_embeddings(family, outs):
    return None if family == "v24" else outs[0]


@pytest.mark.parametrize("dialect,family", CASES, ids=IDS)
def test_detection_and_predict(dialect, family, files, pairs):
    _, labels, oracle = files[dialect, family]
    port, ref = pairs[dialect, family]
    assert port.model_type is FAMILY[family][2]
    assert ref.model_type.value == port.model_type.value
    assert port.num_species == len(labels)
    seg = _segments(family, n=1, seed=3)[0]
    got, want = port.predict(seg), ref.predict(seg)
    outs = oracle(seg[None])
    np.testing.assert_allclose(got.raw_scores, want.raw_scores, rtol=0,
                               atol=_jax_atol(want.raw_scores))
    np.testing.assert_allclose(got.raw_scores, _oracle_logits(family, outs)[0], rtol=0,
                               atol=ORACLE_TOL[dialect])
    assert [p.index for p in got.predictions] == [p.index for p in want.predictions]
    emb = _oracle_embeddings(family, outs)
    if emb is None:
        assert got.embeddings is None and want.embeddings is None
    else:
        np.testing.assert_allclose(got.embeddings, want.embeddings, rtol=0,
                                   atol=_jax_atol(want.embeddings))
        np.testing.assert_allclose(got.embeddings, emb[0], rtol=0, atol=ORACLE_TOL[dialect])


@pytest.mark.parametrize("dialect,family", CASES, ids=IDS)
def test_predict_batch(dialect, family, files, pairs):
    _, _, oracle = files[dialect, family]
    port, ref = pairs[dialect, family]
    batch = _segments(family, n=3, seed=11)
    got, want = port.predict_batch(batch), ref.predict_batch(batch)
    logits = _oracle_logits(family, oracle(np.stack(batch)))
    for g, w, o in zip(got, want, logits):
        np.testing.assert_allclose(g.raw_scores, w.raw_scores, rtol=0,
                                   atol=_jax_atol(w.raw_scores))
        np.testing.assert_allclose(g.raw_scores, o, rtol=0, atol=ORACLE_TOL[dialect])
        assert [p.index for p in g.predictions] == [p.index for p in w.predictions]


@pytest.mark.parametrize("dialect,family", CASES, ids=IDS)
def test_analyze_samples(dialect, family, pairs):
    """Two full segments and a zero-padded half: the same start times, the
    same top-K and confidences within 1e-4 in both packages."""
    port, ref = pairs[dialect, family]
    segs = _segments(family, n=2, seed=5)
    audio = np.concatenate(segs + [segs[0][: len(segs[0]) // 2]])
    got, want = port.analyze_samples(audio), ref.analyze_samples(audio)
    assert [t for t, _ in got] == [t for t, _ in want]
    assert len(got) == 3
    for (_, gp), (_, wp) in zip(got, want):
        assert [p.index for p in gp] == [p.index for p in wp]
        np.testing.assert_allclose([p.confidence for p in gp], [p.confidence for p in wp],
                                   rtol=0, atol=JAX_TOL)


def test_tf_dialect_v24_through_the_cli(files, tmp_path, capsys):
    """The TF v2.4 file through both packages' CLI on the CPU: the same
    detection rows."""
    from birdnet_tpu.cli import main as jmain
    from birdnet_tpu_torch.cli import main as tmain
    from birdnet_tpu_torch.utils.audio_io import write_wav

    path, labels, _ = files["tf", "v24"]
    label_file = tmp_path / "labels.txt"
    label_file.write_text("\n".join(labels), encoding="utf-8")
    wav = tmp_path / "tf.wav"
    write_wav(wav, np.concatenate(_segments("v24", n=2, seed=9)), 48_000)
    rows = {}
    for name, main in (("port", tmain), ("jax", jmain)):
        rc = main([str(wav), "-m", path, "-l", str(label_file), "--provider", "cpu",
                   "--min-confidence", "0.0", "-t", "0"])
        out = capsys.readouterr().out
        assert rc == 0
        assert "Model: BirdNET v2.4 (3.0s segments, 0.0s overlap)" in out
        rows[name] = [line for line in out.splitlines() if line.startswith("00:0")]
    assert len(rows["port"]) >= 2
    assert [r.split(" (")[0] for r in rows["port"]] == [r.split(" (")[0] for r in rows["jax"]]


class SmallCrnn(torch.nn.Module):
    """A CRNN bird tagger at small width: test_external_full_models'
    conv frontend, stem and MBConv blocks, the mean over frequency, an
    average pool and a linear ``F.interpolate`` x4 along time (a Resize), a
    2-layer bidirectional GRU of hidden 16, frame and attention heads, and
    softmax-over-time attention pooling (PANNs' decision-level attention):
    v2.4's contract, [N, 144000] -> [N, 24]."""

    def __init__(self, n=24, hidden=16):
        super().__init__()
        from test_external_full_models import _Backbone

        b = _Backbone()
        self.frontend, self.stem, self.blocks, self.head = b.frontend, b.stem, b.blocks, b.head
        self.gru = torch.nn.GRU(32, hidden, num_layers=2, bidirectional=True,
                                batch_first=True)
        self.frame = torch.nn.Linear(2 * hidden, n)
        self.att = torch.nn.Linear(2 * hidden, n)

    def forward(self, x):
        t = self.frontend(x.unsqueeze(1))
        img = torch.log1p(t * t).unsqueeze(1)
        z = self.head(self.blocks(self.stem(img))).mean(dim=2)  # [N, 32, 128]
        z = torch.nn.functional.avg_pool1d(z, 8)  # [N, 32, 16]
        z = torch.nn.functional.interpolate(z, scale_factor=4.0, mode="linear")
        h, _ = self.gru(z.transpose(1, 2))  # [N, 64, 2 * hidden]
        att = torch.softmax(self.att(h), dim=1)
        return (self.frame(h) * att).sum(dim=1)


@pytest.fixture(scope="module")
def crnn(tmp_path_factory):
    from test_external_full_models import _export

    torch.manual_seed(20)
    module = SmallCrnn().eval()
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.uniform_(-0.1, 0.1)
                m.running_var.uniform_(0.5, 1.5)
    path = _export(tmp_path_factory.mktemp("crnn"), module, 144_000, 1, "crnn")
    return path, [f"Genus{i}_Species {i}" for i in range(24)], module


@pytest.mark.parametrize("precision,tol", [("fp32", JAX_TOL), ("mixed", 2 ** -7)])
def test_small_crnn_matches_jax(crnn, precision, tol):
    """The CRNN through both packages' Classifier on the CPU: detected as
    v2.4, its graph holding the two GRUs and the Resize; fp32 within 1e-4
    of the logits' scale of the JAX package (and of the torch module),
    mixed within 2^-7 of the scale of the JAX package's mixed."""
    from birdnet_tpu_torch.compiler.importer import import_onnx

    path, labels, module = crnn
    ops = [n.op_type for n in import_onnx(path).graph.node]
    assert ops.count("GRU") == 2 and ops.count("Resize") == 1
    port = (tbt.Classifier.builder().model_path(path).labels(labels).precision(precision)
            .with_device("cpu").build())
    ref = jbt.Classifier.builder().model_path(path).labels(labels).precision(precision).build()
    assert port.model_type is ModelType.BIRDNET_V24
    assert ref.model_type.value == port.model_type.value
    batch = _segments("v24", n=3, seed=13)
    got = np.stack([r.raw_scores for r in port.predict_batch(batch)])
    want = np.stack([r.raw_scores for r in ref.predict_batch(batch)])
    scale = float(np.abs(want).max())
    assert np.abs(got - want).max() <= tol * scale
    if precision == "fp32":
        with torch.no_grad():
            oracle = module(torch.from_numpy(np.stack(batch))).numpy()
        assert np.abs(got - oracle).max() <= JAX_TOL * float(np.abs(oracle).max())
