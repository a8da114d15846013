"""Beam search of the port (`tfde_tpu_torch/inference/beam.py`) against the
JAX package's (`tfde_tpu/inference/beam.py`, the twin of
`tests/test_beam.py`).

On converted weights, fp32: tokens and lengths EQUAL JAX `beam_search`'s,
scores within 1e-5 (log-softmax sums in another order); beam 1 is greedy
`generate`; beams come back sorted and distinct; EOS freezes a beam and
pads after it; exhaustive search (beams == vocab, two tokens) finds the
brute-force optimum with its full-forward joint log-prob (1e-5); a
windowed model decodes on the rolling cache; `gpt_lm --beams` logs the
best beam of each prompt.
"""

import ast
import itertools
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfde_tpu.inference import beam as jbeam
from tfde_tpu.models.gpt import GPT as JGPT
from tfde_tpu_torch import gpt_lm
from tfde_tpu_torch.inference import beam as tbeam
from tfde_tpu_torch.inference import decode as tdecode
from tfde_tpu_torch.models.flax_weights import from_flax_params
from tfde_tpu_torch.models.gpt import GPT
from tfde_tpu_torch.testing import one_thread

#: one intra-op torch thread for the module (`testing.one_thread`)
_one_thread = pytest.fixture(autouse=True, scope="module")(one_thread)

#: the scores: the same log-softmax sums as JAX's, in another order
SCORE_TOL = 1e-5
#: vocab small enough to brute-force two tokens; depth 2, width 64
NANO = dict(vocab_size=7, hidden_size=64, depth=2, num_heads=4, mlp_dim=128,
            max_position=16)


def _pair(fields, key):
    jm = JGPT(**fields, dtype=jnp.float32)
    params = jm.init(jax.random.key(key), jnp.zeros((1, 8), jnp.int32))[
        "params"]
    tm = GPT(**fields, dtype=torch.float32, device="cpu")
    tm.load_state_dict(from_flax_params(jax.tree.map(np.asarray, params)))
    return jm, params, tm


@pytest.fixture(scope="module")
def nano():
    return _pair(NANO, 0)


def _both(pair, prompt, **kw):
    jm, params, tm = pair
    want = jbeam.beam_search(jm, params, jnp.asarray(prompt, jnp.int32),
                             **kw)
    got = tbeam.beam_search(tm, prompt, device="cpu", **kw)
    return [np.asarray(w) for w in want], [g.numpy() for g in got]


def _hold_equal(want, got):
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=SCORE_TOL)
    np.testing.assert_array_equal(got[2], want[2])


@pytest.mark.parametrize("num_beams,length_penalty", [(2, 0.6), (4, 0.0)])
def test_beam_search_matches_jax(nano, num_beams, length_penalty):
    prompt = np.random.default_rng(1).integers(0, 7, (2, 3))
    want, got = _both(nano, prompt, max_new_tokens=5, num_beams=num_beams,
                      length_penalty=length_penalty)
    _hold_equal(want, got)
    assert got[0].shape == (2, num_beams, 8)


def test_beam1_equals_greedy(nano):
    _jm, _params, tm = nano
    prompt = np.random.default_rng(2).integers(0, 7, (2, 3))
    greedy, _ = tdecode.generate(tm, prompt, 5, device="cpu")
    beams, _scores, lengths = tbeam.beam_search(
        tm, prompt, 5, num_beams=1, length_penalty=0.0, device="cpu")
    assert torch.equal(beams[:, 0], greedy)
    assert lengths[:, 0].tolist() == [8, 8]


def test_beams_sorted_and_distinct(nano):
    _jm, _params, tm = nano
    prompt = np.random.default_rng(3).integers(0, 7, (2, 3))
    beams, scores, _ = tbeam.beam_search(tm, prompt, 4, num_beams=4,
                                         length_penalty=0.0, device="cpu")
    assert (np.diff(scores.numpy(), axis=1) <= 1e-6).all()
    for row in beams.numpy():
        assert len({tuple(x) for x in row}) == 4


def test_beam_exhaustive_optimality(nano):
    """num_beams == vocab and two new tokens search exhaustively: the best
    beam is the brute-force argmax over all 49 continuations, its score
    their joint log-prob from cache-free forwards."""
    _jm, _params, tm = nano
    prompt = np.random.default_rng(4).integers(0, 7, (1, 3))
    beams, scores, _ = tbeam.beam_search(tm, prompt, 2, num_beams=7,
                                         length_penalty=0.0, device="cpu")
    conts = list(itertools.product(range(7), repeat=2))
    seqs = torch.as_tensor([list(prompt[0]) + list(c) for c in conts])
    with torch.no_grad():
        logp = torch.log_softmax(tm(seqs), dim=-1)
    joint = (logp[:, 2].gather(1, seqs[:, 3:4])
             + logp[:, 3].gather(1, seqs[:, 4:5]))[:, 0]
    best = int(joint.argmax())
    assert tuple(beams[0, 0, 3:].tolist()) == conts[best]
    assert abs(float(scores[0, 0]) - float(joint[best])) <= SCORE_TOL


def test_beam_eos_freezes_and_pads(nano):
    """EOS = the best beam's first token: finished beams stop at it, pad
    after, and their lengths count it; every beam as in JAX."""
    _jm, _params, tm = nano
    prompt = np.random.default_rng(5).integers(0, 7, (1, 3))
    free, _, _ = tbeam.beam_search(tm, prompt, 4, num_beams=3,
                                   length_penalty=0.0, device="cpu")
    eos = int(free[0, 0, 3])
    want, got = _both(nano, prompt, max_new_tokens=4, num_beams=3,
                      length_penalty=0.0, eos_id=eos, pad_id=0)
    _hold_equal(want, got)
    rows, lens = got[0][0], got[2][0]
    finished = [i for i in range(3) if eos in rows[i, 3:]]
    assert finished
    for i in finished:
        e = list(rows[i, 3:]).index(eos)
        assert lens[i] == 3 + e + 1 and (rows[i, 3 + e + 1:] == 0).all()


@pytest.mark.parametrize("kw,match", [
    ({"max_new_tokens": 2, "num_beams": 0}, "num_beams"),
    ({"max_new_tokens": 0}, "max_new_tokens"),
    ({"max_new_tokens": 20}, "max_position"),
])
def test_beam_refusals(nano, kw, match):
    """The same ValueErrors, with JAX's messages."""
    jm, params, tm = nano
    prompt = np.zeros((1, 3), np.int64)
    with pytest.raises(ValueError, match=match) as jerr:
        jbeam.beam_search(jm, params, jnp.asarray(prompt, jnp.int32), **kw)
    with pytest.raises(ValueError, match=match) as terr:
        tbeam.beam_search(tm, prompt, device="cpu", **kw)
    assert str(terr.value) == str(jerr.value)


def test_beam_windowed_model_on_the_rolling_cache():
    """A rope + GQA model with window 4 decodes past the window on the
    rolling cache (its planes hold 4 slots; the reorder selects them as
    the full cache's), as JAX's beam search does."""
    pair = _pair(dict(vocab_size=31, hidden_size=64, depth=2, num_heads=4,
                      num_kv_heads=2, mlp_dim=128, max_position=64,
                      position="rope", sliding_window=4), 7)
    prompt = np.random.default_rng(6).integers(0, 31, (2, 6))
    want, got = _both(pair, prompt, max_new_tokens=8, num_beams=3)
    _hold_equal(want, got)
    cache = tdecode.init_cache(pair[2], 6, 14, rolling=True)
    assert cache.rolling and cache.keys[0].shape[1] == 4


def test_gpt_lm_beams_logs_the_best_beam(caplog):
    """`gpt_lm --generate 4 --beams 2` on the tiny model: one "beam best"
    line a prompt, its tokens `beam_search`'s best beam on the trained
    model."""
    with caplog.at_level(logging.INFO, logger="gpt_lm"):
        state, _ = gpt_lm.main([
            "--tiny", "--device", "cpu", "--max-steps", "2",
            "--batch-size", "4", "--seq-len", "16", "--train-examples",
            "64", "--generate", "4", "--beams", "2"])
    logged = [r.getMessage() for r in caplog.records
              if r.getMessage().startswith("beam best")]
    assert len(logged) == 2
    rows = [ast.literal_eval(m.split(": ", 1)[1]) for m in logged]
    assert all(len(row) == 20 for row in rows)
    prompts = np.asarray(rows)[:, :16]
    best, _, _ = tbeam.beam_search(state.model, prompts, 4, num_beams=2,
                                   device="cpu")
    np.testing.assert_array_equal(best[:, 0].numpy(), np.asarray(rows))
