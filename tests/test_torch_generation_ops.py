"""The port's generation ops (GreedySearch, Sampling, BeamSearch,
WhisperBeamSearch; birdnet_tpu_torch/compiler/ops_contrib.py) against the
JAX package's and against plain-torch loops with a growing KV cache.

The decoders are tests/_torch_contrib_cases.py's plain-torch modules (2
layers, width 32, max_length <= 12), built once per module:

- greedy with a repetition penalty, min_length, a vocab mask and an EOS
  that stops one row early, against a growing-cache torch loop and JAX;
- BeamSearch over the GPT decoder (EOS absorption, early stopping, a
  repetition penalty) and over a T5-style encoder-decoder, equal to JAX at
  ``length_penalty = 0``;
- WhisperBeamSearch, batched, with the timestamp rules, equal to JAX;
- the length penalty as onnxruntime's scorer applies it (a numpy oracle of
  ``BeamSearchScorer``), where the JAX package divides by the generated
  length instead (ROADMAP C);
- the typed rejections, with the JAX package's error types;
- Sampling three ways: ``top_p -> 0`` equals GreedySearch; the first
  token's distribution over many draws is within 5 standard errors of the
  filtered softmax; a torch loop mirroring the port's key schedule
  reproduces it;
- a ``.btck`` round trip of a GreedySearch file across the two packages.
"""

from __future__ import annotations

import copy
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import _torch_contrib_cases as cc  # noqa: E402
from _torch_dual import run_jax, run_port  # noqa: E402

from birdnet_tpu_torch.compiler import ops as tops  # noqa: E402
from birdnet_tpu_torch.compiler.ops_contrib import sampling_key  # noqa: E402
from birdnet_tpu_torch.compiler.ops_extended import _draw  # noqa: E402
from _torch_threads import torch_threads  # noqa: E402,F401

VOCAB = 50
F32 = np.float32


@functools.lru_cache(maxsize=None)
def _gpt():
    m = cc.TinyGpt(vocab=VOCAB, seed=0)
    return m, cc.gpt_step_graph(m)


def _gpt_logprobs(m, seqs: np.ndarray) -> torch.Tensor:
    """Last-position logits of ``seqs`` [rows, L] by a full recompute."""
    rows, length = seqs.shape
    hd = m.head_dim()
    empty = [torch.zeros(2, rows, m.heads, 0, hd) for _ in range(m.layers_n)]
    with torch.no_grad():
        ids = torch.from_numpy(seqs.astype(np.int32))
        pos = torch.arange(length, dtype=torch.int32)[None].expand(rows, length)
        logits = m(ids, pos, torch.ones((rows, length), dtype=torch.int32), *empty)[0]
    return logits[:, -1].float()


def _torch_greedy(m, prompt, *, max_len, min_len=1, rep_pen=1.0, eos=-1, pad=-1,
                  vocab_mask=None):
    """Greedy decoding with a TRUE growing cache (the module's own past)."""
    b_sz, s0 = prompt.shape
    hd = m.head_dim()
    out = np.full((b_sz, max_len), pad, np.int32)
    out[:, :s0] = prompt
    seen = [set(prompt[b].tolist()) for b in range(b_sz)]
    done = [False] * b_sz
    pasts = [torch.zeros(2, b_sz, m.heads, 0, hd) for _ in range(m.layers_n)]
    cur = torch.from_numpy(prompt.astype(np.int32))
    with torch.no_grad():
        for t in range(s0, max_len):
            past_len = pasts[0].shape[3]
            s = cur.shape[1]
            pos = torch.arange(past_len, past_len + s, dtype=torch.int32)[None].expand(b_sz, s)
            logits, *pasts = m(cur, pos, torch.ones((b_sz, past_len + s), dtype=torch.int32),
                               *pasts)
            lg = logits[:, -1].double().numpy()
            if vocab_mask is not None:
                lg = np.where(vocab_mask.astype(bool), lg, -np.inf)
            nxt = []
            for b in range(b_sz):
                lb = lg[b].copy()
                for tok in seen[b]:
                    lb[tok] = lb[tok] / rep_pen if lb[tok] > 0 else lb[tok] * rep_pen
                if t < min_len:
                    lb[eos] = -np.inf
                tok = int(lb.argmax())
                if done[b]:
                    tok = pad
                else:
                    done[b] = tok == eos
                    out[b, t] = tok
                    seen[b].add(tok)
                nxt.append(tok)
            if all(done):
                break
            cur = torch.tensor(nxt, dtype=torch.int32)[:, None]
    return out


def _new_token(free, row, start):
    """The first token row ``row`` of a free run emits at or after
    ``start`` that it has not emitted before (an EOS that stops it there)."""
    s0 = start - 2
    for t in range(start, free.shape[1]):
        if free[row, t] not in free[row, s0:t]:
            return int(free[row, t]), t
    raise AssertionError(f"no new token in {free[row]}")


def _gen(op, values, subgraphs=None, **attrs):
    subgraphs = subgraphs or {"decoder": _gpt()[1]}
    return cc.generation_model(op, subgraphs, values, **attrs)


# ---------------------------------------------------------------------------
# GreedySearch
# ---------------------------------------------------------------------------


def test_greedy_search_matches_a_growing_cache_loop():
    m, _ = _gpt()
    prompt = np.random.default_rng(60).integers(0, VOCAB, (2, 3)).astype(np.int32)
    max_len, min_len, rep_pen = 11, 6, 1.3
    free = _torch_greedy(m, prompt, max_len=max_len, rep_pen=rep_pen)
    eos, _ = _new_token(free, 1, 7)  # row 1 emits it at step 7 or later ...
    vocab_mask = np.ones(VOCAB, np.int32)
    vocab_mask[int(free[0, 3])] = 0  # ... and row 0's first choice is banned
    want = _torch_greedy(m, prompt, max_len=max_len, min_len=min_len, rep_pen=rep_pen,
                         eos=eos, pad=VOCAB - 1, vocab_mask=vocab_mask)
    assert (want[1] == VOCAB - 1).any()  # the early stop happened
    data, vals = _gen("GreedySearch", cc.gen_values(
        prompt, max_len, min_len=min_len, repetition_penalty=np.array([rep_pen], F32),
        vocab_mask=vocab_mask), eos=eos, pad=VOCAB - 1)
    tops.HOST_READS["GreedySearch"] = 0
    (got,) = run_port(data, list(vals.values()))
    reads = tops.HOST_READS["GreedySearch"]
    np.testing.assert_array_equal(got, want)
    # one read of the early stop per step after the first token
    assert reads == max_len - prompt.shape[1] - 1


def test_greedy_search_early_stop_reads_once_per_generated_step():
    """When every row has emitted EOS the loop stops: the steps run equal
    the JAX while_loop's, and the last read is the one that stops it."""
    m, _ = _gpt()
    prompt = np.random.default_rng(62).integers(0, VOCAB, (1, 4)).astype(np.int32)
    free = _torch_greedy(m, prompt, max_len=12)
    eos, first = _new_token(free, 0, 6)  # the row emits EOS at ``first``
    data, vals = _gen("GreedySearch", cc.gen_values(prompt, 12), eos=eos, pad=0)
    tops.HOST_READS["GreedySearch"] = 0
    (got,) = run_port(data, list(vals.values()))
    np.testing.assert_array_equal(got, _torch_greedy(m, prompt, max_len=12, eos=eos, pad=0))
    # one read per step after the first token, and the read that stops
    assert first < 11
    assert tops.HOST_READS["GreedySearch"] == first - 4 + 1


# ---------------------------------------------------------------------------
# BeamSearch
# ---------------------------------------------------------------------------


def _beam_values(prompt, max_len, k, r, lp, rp=1.0):
    return cc.gen_values(prompt, max_len, num_beams=np.array([k], np.int32),
                         num_return_sequences=np.array([r], np.int32),
                         length_penalty=np.array([lp], F32),
                         repetition_penalty=np.array([rp], F32))


def _assert_scores(got, want):
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=0)


def test_the_beam_case_absorbs_eos_and_stops_early():
    """tests/test_torch_contrib_ops.py holds the BeamSearch case (EOS
    absorption, early stopping, a repetition penalty, length_penalty 0) to
    the JAX package; here: the EOS is absorbed, and the loop reads its
    condition once per step it runs."""
    data, vals = cc.CASES["BeamSearch"]()
    tops.HOST_READS["BeamSearch"] = 0
    seq, _ = run_port(data, list(vals.values()))
    assert (seq == cc.GPT_BEAM_EOS).any()
    steps = (seq != VOCAB - 1).sum(-1).max() - 4  # tokens after the prompt
    assert 1 <= tops.HOST_READS["BeamSearch"] <= steps


def _ort_beam_oracle(logprobs, prompt, *, k, r, max_len, eos, pad, lp, early_stopping):
    """onnxruntime's BeamSearchScorer in numpy (Process, BeamHypotheses
    Add/IsDone, Finalize): a hypothesis' score is its sum of log-probs over
    its length to the power ``lp``, the length counting the prompt and
    excluding the EOS; ``logprobs(seqs)`` gives each row's next-token
    log-probs. Returns the sequences (EOS appended, pad-filled) and
    scores, best first."""
    b_sz, s0 = prompt.shape
    seqs = np.repeat(prompt, k, axis=0)
    beam_scores = np.zeros((b_sz, k), np.float64)
    beam_scores[:, 1:] = -1e9
    hyps = [[] for _ in range(b_sz)]
    done = [False] * b_sz

    def add(b, hyp, total, length):
        hyps[b].append((total / float(length) ** lp, hyp))
        hyps[b].sort(key=lambda h: -h[0])
        del hyps[b][k:]

    cur = s0
    while cur < max_len:
        scores = logprobs(seqs).double().numpy() + beam_scores.reshape(-1, 1)
        vocab = scores.shape[1]
        scores = scores.reshape(b_sz, -1)
        new_seqs, new_scores = [], np.zeros((b_sz, k))
        for b in range(b_sz):
            if done[b]:
                new_seqs += [np.append(seqs[b * k], pad)] * k
                continue
            order = np.argsort(-scores[b], kind="stable")[:2 * k]
            n = 0
            for j, idx in enumerate(order):
                parent, tok = divmod(int(idx), vocab)
                if tok == eos:
                    if j < k:
                        add(b, np.append(seqs[b * k + parent], eos), scores[b, idx], cur)
                else:
                    new_scores[b, n] = scores[b, idx]
                    new_seqs.append(np.append(seqs[b * k + parent], tok))
                    n += 1
                if n == k:
                    break
            best = scores[b, order[0]]
            if len(hyps[b]) == k and (early_stopping
                                      or hyps[b][-1][0] >= best / float(cur) ** lp):
                done[b] = True
        seqs, beam_scores, cur = np.stack(new_seqs), new_scores, cur + 1
        if all(done):
            break
    for b in range(b_sz):
        if not done[b]:
            for j in range(k):
                add(b, seqs[b * k + j], beam_scores[b, j], cur)
    out = np.full((b_sz, r, max_len), pad, np.int32)
    out_scores = np.zeros((b_sz, r), np.float64)
    for b in range(b_sz):
        for j, (score, hyp) in enumerate(hyps[b][:r]):
            out[b, j, :len(hyp)] = hyp
            out_scores[b, j] = score
    return out, out_scores


@pytest.mark.parametrize("absorbs,lp", [(False, 2.0), (True, 1.0)])
def test_beam_length_penalty_divides_by_the_full_length(absorbs, lp):
    """onnxruntime divides a hypothesis' summed log-probs by its full
    length, prompt included (``BeamHypotheses::Add`` / ``IsDone``); the
    JAX package divides by the generated length (ROADMAP C). The port
    equals a numpy oracle of ORT's scorer, with EOS out of the vocabulary
    (every beam runs to max_length) and with an EOS that several beams
    absorb; the JAX package's scores differ from it."""
    m, _ = _gpt()
    prompt = np.random.default_rng(62).integers(0, VOCAB, (2, 3)).astype(np.int32)
    k, r, max_len = 3, 3, 10
    eos = int(_torch_greedy(m, prompt, max_len=max_len)[0, 5]) if absorbs else VOCAB + 1
    want, want_scores = _ort_beam_oracle(
        lambda s: torch.log_softmax(_gpt_logprobs(m, s), dim=-1), prompt, k=k, r=r,
        max_len=max_len, eos=eos, pad=VOCAB - 1, lp=lp, early_stopping=False)
    data, vals = _gen("BeamSearch", _beam_values(prompt, max_len, k, r, lp), eos=eos,
                      pad=VOCAB - 1, outputs=("sequences", "sequences_scores"),
                      model_type=0)
    seq, scores = run_port(data, list(vals.values()))
    np.testing.assert_array_equal(seq, want)
    _assert_scores(scores, want_scores)
    if absorbs:
        assert (want == eos).any()
    else:
        _, j_scores = run_jax(data, list(vals.values()), jit=False)
        assert np.abs(j_scores - want_scores).max() > 1e-2


@functools.lru_cache(maxsize=None)
def _t5():
    m = cc.EncDec(kind="t5", vocab=80, seed=1)
    src = np.random.default_rng(72).integers(2, 80, (1, 7)).astype(np.int32)
    return src, cc.encdec_graphs(m, src)


def test_t5_beam_search_matches_jax():
    src, (enc, dec) = _t5()
    vals = _beam_values([[0, 9]], 9, 3, 2, 0.0)
    vals["decoder_input_ids"] = vals["input_ids"]
    vals["input_ids"] = src
    data, vals = _gen("BeamSearch", vals, {"encoder": enc, "decoder": dec}, eos=1, pad=0,
                      outputs=("sequences", "sequences_scores"), model_type=1,
                      decoder_start_token_id=0)
    seq, scores = run_port(data, list(vals.values()))
    j_seq, j_scores = run_jax(data, list(vals.values()), jit=False)
    np.testing.assert_array_equal(seq, j_seq)
    _assert_scores(scores, j_scores)


# ---------------------------------------------------------------------------
# WhisperBeamSearch
# ---------------------------------------------------------------------------

NO_TS = cc.NO_TIMESTAMPS


def _whisper():
    _, src, graphs = cc.tiny_encdec("whisper", vocab=cc.WHISPER_VOCAB, batch=2)
    return src, graphs


def test_whisper_timestamp_rules_bite():
    """tests/test_torch_contrib_ops.py holds the batched WhisperBeamSearch
    case with the timestamp rules to the JAX package; here: the rules bit,
    every first generated token being a timestamp inside the initial cap."""
    data, vals = cc.CASES["WhisperBeamSearch"]()
    seq, _ = run_port(data, list(vals.values()))
    assert ((seq[:, :, 2] > NO_TS) & (seq[:, :, 2] <= NO_TS + 6)).all()


# ---------------------------------------------------------------------------
# typed rejections
# ---------------------------------------------------------------------------


def _both_raise(data, vals, exc, match):
    with pytest.raises(exc, match=match):
        run_port(data, list(vals.values()))
    with pytest.raises(exc):
        run_jax(data, list(vals.values()), jit=False)


def _pastless_decoder():
    from birdnet_tpu_torch.onnx import proto as P

    return P.GraphProto(
        name="no_past", node=[P.make_node("Identity", ["input_ids"], ["logits"])],
        input=[P.make_value_info(n, P.DataType.INT32, [1, "s"])
               for n in ("input_ids", "position_ids", "attention_mask")],
        output=[P.make_value_info("logits", P.DataType.FLOAT, [1, "s", 5])])


REJECTIONS = {
    "model_type": ("GreedySearch", dict(model_type=1), NotImplementedError, "model_type"),
    "no_repeat_ngram_size": ("GreedySearch", dict(no_repeat_ngram_size=2),
                             NotImplementedError, "no_repeat_ngram_size"),
    "prefix_vocab_mask": ("GreedySearch", {}, NotImplementedError, "prefix_vocab_mask"),
    "custom": ("Sampling", dict(custom=1), NotImplementedError, "custom"),
    "pastless": ("GreedySearch", {}, NotImplementedError, "no past inputs"),
    "beam_no_repeat": ("BeamSearch", dict(no_repeat_ngram_size=3, model_type=0),
                       NotImplementedError, "no_repeat_ngram_size"),
    "too_many_returns": ("BeamSearch", dict(model_type=0), ValueError,
                         "num_return_sequences > num_beams"),
    "padded_prompt": ("GreedySearch", {}, NotImplementedError, "padded prompts"),
}


@pytest.mark.parametrize("case", sorted(REJECTIONS))
def test_generation_rejections_have_the_jax_error_types(case):
    op, attrs, exc, match = REJECTIONS[case]
    prompt = np.array([[1, 2], [3, 4]], np.int32)
    if op == "BeamSearch":
        vals = _beam_values(prompt, 6, 2, 3 if case == "too_many_returns" else 1, 0.0)
    else:
        vals = cc.gen_values(prompt, 6)
    if case == "prefix_vocab_mask":
        vals["prefix_vocab_mask"] = np.ones((2, VOCAB), np.int32)
    if case == "padded_prompt":
        vals["attention_mask"] = np.array([[1, 1], [0, 1]], np.int32)
    subgraphs = {"decoder": _pastless_decoder()} if case == "pastless" else None
    data, vals = _gen(op, vals, subgraphs, eos=3, pad=0, **attrs)
    _both_raise(data, vals, exc, match)


def _whisper_rejection(**kw):
    feats, (enc, dec) = _whisper()
    vals = _beam_values([[1, 5]], 8, 2, 1, 0.0)
    vals["decoder_input_ids"] = vals["input_ids"]
    vals["input_ids"] = feats[:1]
    vals.update(kw.pop("values", {}))
    return _gen("WhisperBeamSearch", vals, {"encoder": kw.pop("encoder", enc),
                                            "decoder": kw.pop("decoder", dec)},
                eos=2, pad=0, outputs=kw.pop("outputs", ("sequences",)), model_type=2,
                extra_inputs=kw.pop("extra_inputs", ()), **kw)


def test_whisper_rejections_have_the_jax_error_types():
    cases = [
        (_whisper_rejection(values={"logits_processor": np.array([2], np.int32)}),
         NotImplementedError, "logits_processor"),
        (_whisper_rejection(outputs=("sequences", "sequences_scores", "cross_qk")),
         NotImplementedError, "outputs beyond"),
        (_whisper_rejection(values={"cross_qk_layer_head": np.zeros((1, 2), np.int32)},
                            extra_inputs=("cross_qk_layer_head",)),
         NotImplementedError, "cross_qk_layer_head"),
    ]
    t5_enc = copy.deepcopy(_whisper()[1][0])
    t5_enc.input[1].name = "encoder_attention_mask"
    cases.append((_whisper_rejection(encoder=t5_enc), NotImplementedError, "whisper form"))
    for (data, vals), exc, match in cases:
        _both_raise(data, vals, exc, match)


def test_a_decoder_without_its_present_raises_naming_it():
    """The JAX package raises a bare KeyError here (ROADMAP C); the port a
    ValueError naming the missing present."""
    feats, (enc, dec) = _whisper()
    dec = copy.deepcopy(dec)
    dec.output = [o for o in dec.output if o.name != "present_value_self_1"]
    data, vals = _whisper_rejection(decoder=dec)
    with pytest.raises(ValueError, match="present_value_self_1"):
        run_port(data, list(vals.values()))


@pytest.mark.parametrize("name", ["length_penalty", "num_beams", "max_length"])
def test_beam_sizes_on_a_device_must_be_compile_time_constants(name):
    """The port reads num_beams, length_penalty and max_length on the
    host; a tensor on a device raises (the JAX encoder-decoder branch
    reads length_penalty as data, ROADMAP C)."""
    from birdnet_tpu_torch.compiler.importer import import_onnx, make_forward
    from birdnet_tpu_torch.compiler.importer import params_to_torch

    data, vals = _whisper_rejection()
    model = import_onnx(data)
    fwd = make_forward(model, "fp32", "cpu")
    args = [torch.from_numpy(np.array(v)) for v in vals.values()]
    args[list(vals).index(name)] = args[list(vals).index(name)].to("meta")
    with pytest.raises(ValueError, match="must be a compile-time constant"):
        fwd(params_to_torch(model.params, "cpu"), *args)


# ---------------------------------------------------------------------------
# Sampling
# ---------------------------------------------------------------------------


def _sampling(prompt, max_len, *, temperature, top_p, seed):
    return _gen("Sampling", cc.gen_values(prompt, max_len), eos=VOCAB + 1, pad=VOCAB - 1,
                temperature=temperature, top_p=top_p, seed=seed)


def test_sampling_at_top_p_zero_is_greedy():
    prompt = np.random.default_rng(66).integers(0, VOCAB, (2, 3)).astype(np.int32)
    greedy = _torch_greedy(_gpt()[0], prompt, max_len=9)
    for seed in (0, 7):
        data, vals = _sampling(prompt, 9, temperature=1.0, top_p=1e-6, seed=seed)
        (seq,) = run_port(data, list(vals.values()))
        np.testing.assert_array_equal(seq, greedy)


def _filtered_probs(logits, temperature, top_p):
    lg = logits.double().numpy() / temperature
    order = np.argsort(-lg, axis=-1)
    srt = np.take_along_axis(lg, order, axis=-1)
    p = np.exp(srt - srt.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    keep_sorted = (np.cumsum(p, -1) - p) <= top_p
    keep_sorted[:, 0] = True
    keep = np.zeros_like(keep_sorted)
    np.put_along_axis(keep, order, keep_sorted, -1)
    q = np.where(keep, np.exp(lg - lg.max(-1, keepdims=True)), 0.0)
    return q / q.sum(-1, keepdims=True)


def test_sampling_first_token_distribution():
    """4,000 rows of one prompt draw their first token from the filtered
    softmax: every token's frequency within 5 standard errors."""
    m, _ = _gpt()
    n, temperature, top_p = 4000, 0.8, 0.9
    prompt = np.tile(np.random.default_rng(67).integers(0, VOCAB, (1, 3)), (n, 1)).astype(
        np.int32)
    data, vals = _sampling(prompt, 4, temperature=temperature, top_p=top_p, seed=13)
    (seq,) = run_port(data, list(vals.values()))
    p = _filtered_probs(_gpt_logprobs(m, prompt[:1]), temperature, top_p)[0]
    freq = np.bincount(seq[:, 3], minlength=VOCAB) / n
    se = np.sqrt(np.maximum(p * (1 - p), 1e-12) / n)
    assert (np.abs(freq - p) <= 5 * se + 1e-12).all()
    assert (freq[p == 0] == 0).all()
    assert (p > 0).sum() > 3  # the draw is not degenerate


def test_sampling_matches_a_mirrored_key_schedule():
    """A growing-cache torch loop that draws step t's Gumbel noise from a
    CPU generator seeded with ``sampling_key(seed, t)`` gives the port's
    tokens exactly."""
    m, _ = _gpt()
    prompt = np.random.default_rng(68).integers(0, VOCAB, (2, 3)).astype(np.int32)
    max_len, temperature, top_p, seed = 9, 0.8, 0.9, 13
    want = prompt.copy()
    for t in range(3, max_len):
        logits = _gpt_logprobs(m, want) / np.float32(temperature)
        srt = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(srt, -1)
        remove = (torch.cumsum(probs, -1) - probs) > top_p
        remove[:, :1] = False
        thr = torch.gather(srt, -1, ((~remove).sum(-1) - 1)[:, None])
        filtered = torch.where(logits >= thr, logits, -np.inf)
        noise = _draw("gumbel", sampling_key(seed, t), tuple(filtered.shape), torch.float32)
        nxt = torch.argmax(filtered + noise, dim=-1).numpy().astype(np.int32)
        want = np.concatenate([want, nxt[:, None]], axis=1)
    data, vals = _sampling(prompt, max_len, temperature=temperature, top_p=top_p, seed=seed)
    (seq,) = run_port(data, list(vals.values()))
    np.testing.assert_array_equal(seq, want)


# ---------------------------------------------------------------------------
# .btck across the packages
# ---------------------------------------------------------------------------


def test_greedy_search_checkpoint_crosses_the_packages(tmp_path):
    """A GreedySearch file saved as ``.btck`` by either package loads in the
    other with its decoder graph, and gives the same sequences."""
    from birdnet_tpu import checkpoint as jck
    from birdnet_tpu.compiler.importer import import_onnx as j_import
    from birdnet_tpu.compiler.importer import make_forward as j_forward
    from birdnet_tpu_torch import checkpoint as tck
    from birdnet_tpu_torch.compiler.importer import import_onnx, make_forward
    from birdnet_tpu_torch.compiler.importer import params_to_torch

    prompt = np.array([[3, 7, 11, 2], [9, 1, 4, 40]], np.int32)
    data, vals = _gen("GreedySearch", cc.gen_values(
        prompt, 9, repetition_penalty=np.array([1.1], F32)), eos=VOCAB + 1, pad=VOCAB - 1)
    tck.save_checkpoint(import_onnx(data), tmp_path / "port.btck")
    jck.save_checkpoint(j_import(data), tmp_path / "jax.btck")
    from_jax = jck.load_checkpoint(tmp_path / "port.btck")
    from_port = tck.load_checkpoint(tmp_path / "jax.btck")
    args = list(vals.values())
    (a,) = j_forward(from_jax, "fp32")(from_jax.params, *args)
    (b,) = make_forward(from_port, "fp32", "cpu")(
        params_to_torch(from_port.params, "cpu"), *[torch.from_numpy(v) for v in args])
    want = _torch_greedy(_gpt()[0], prompt, max_len=9, rep_pen=1.1, pad=VOCAB - 1)
    np.testing.assert_array_equal(np.asarray(a), want)
    np.testing.assert_array_equal(b.numpy(), want)
