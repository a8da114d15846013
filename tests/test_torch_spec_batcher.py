"""The port's `SpeculativeContinuousBatcher` against the JAX package's on
the same submit stream (the scenarios of `tests/test_server.py`'s
speculative cases).

On converted weights, fp32: greedy outputs EQUAL the JAX batcher's and
each request's solo `generate`, and `stats()` (rounds, tokens, tokens a
round, acceptance rate, dispatches and syncs in the JAX units) equals the
JAX batcher's, with a wrong, a near and a perfect draft; EOS with a
request queued behind another; a rope + GQA target; custom prompt buckets;
the metrics under ``serving/speculative``. Sampled mode completes with the
right lengths and is reproducible under one generator seed. Admission
control comes from the base: every admission scenario of the JAX tests
runs on the port's speculative batcher, and those the JAX speculative
batcher can take (no `admission_ctl` argument there) give the same
outcomes on both. What JAX's batcher refuses the port refuses: prefix
cache, paged and int8 arguments (TypeError), the primed hand-off; the
``TFDE_*`` cache knobs are not read. `serve_gpt --num-draft` serves and
refuses `--prefix-cache` and sampling.
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfde_tpu.inference import admission as jadmission
from tfde_tpu.inference import server as jserver
from tfde_tpu.models.gpt import GPT as JGPT
from tfde_tpu.observability import metrics as jmetrics
from tfde_tpu.observability import trace as jtrace
from tfde_tpu_torch import serve_gpt, testing
from tfde_tpu_torch.inference import admission as tadmission
from tfde_tpu_torch.inference import decode as tdecode
from tfde_tpu_torch.inference import server as tserver
from tfde_tpu_torch.models.flax_weights import from_flax_params
from tfde_tpu_torch.models.gpt import GPT
from tfde_tpu_torch.observability import metrics as tmetrics
from tfde_tpu_torch.observability import trace as ttrace
from tfde_tpu_torch.testing import one_thread

#: one intra-op torch thread for the module (`testing.one_thread`)
_one_thread = pytest.fixture(autouse=True, scope="module")(one_thread)

VOCAB = 97
TARGET = dict(vocab_size=VOCAB, hidden_size=64, depth=2, num_heads=4,
              mlp_dim=128, max_position=64)
SMALL = dict(vocab_size=VOCAB, hidden_size=16, depth=1, num_heads=2,
             mlp_dim=32, max_position=64)
#: the near draft: the target's parameters plus this much noise, relative
#: to each parameter's spread
NEAR_NOISE = 0.35
#: the JAX speculative test's stream: (prompt length, max_new_tokens)
STREAM = [(3, 8), (5, 5), (2, 11), (6, 4), (4, 9)]


def _pair(fields, key, noise_of=None):
    jm = JGPT(**fields, dtype=jnp.float32)
    if noise_of is None:
        params = jm.init(jax.random.key(key), jnp.zeros((1, 8), jnp.int32))[
            "params"]
    else:
        rng = np.random.default_rng(key)
        params = jax.tree.map(
            lambda a: a + NEAR_NOISE * (np.std(a) + 1e-3)
            * rng.standard_normal(a.shape).astype(np.float32), noise_of)
    tm = GPT(**fields, dtype=torch.float32, device="cpu")
    tm.load_state_dict(from_flax_params(jax.tree.map(np.asarray, params)))
    return jm, params, tm


@pytest.fixture(scope="module")
def models():
    target = _pair(TARGET, 1)
    return {"target": target, "perfect": target, "wrong": _pair(SMALL, 9),
            "near": _pair(TARGET, 2, noise_of=target[1])}


def _make(models, draft, **kw):
    """(JAX batcher, port batcher) over the same weights."""
    jm, params, tm = models["target"]
    jd, dparams, td = models[draft]
    return (jserver.SpeculativeContinuousBatcher(jm, jd, params, dparams,
                                                 **kw),
            tserver.SpeculativeContinuousBatcher(tm, td, device="cpu", **kw))


def _serve(srv, stream, late=()):
    """Submit `stream`, step twice, submit `late`, run to idle; the tokens
    in submit order."""
    rids = [srv.submit(p, n) for p, n in stream]
    done = {}
    for _ in range(2):
        done.update(srv.step())
    rids += [srv.submit(p, n) for p, n in late]
    done.update(srv.run())
    assert srv.idle and sorted(done) == sorted(rids)
    return [np.asarray(done[r]) for r in rids]


def _solo(tm, prompt, n, **kw):
    toks, lengths = tdecode.generate(tm, prompt[None, :], n, device="cpu",
                                     **kw)
    return toks[0, prompt.size:int(lengths[0])].numpy()


def _stream(seed):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, VOCAB, p), n) for p, n in STREAM]


@pytest.mark.parametrize("draft", ["wrong", "near", "perfect"])
def test_batcher_matches_jax_and_solo(models, draft):
    jsrv, tsrv = _make(models, draft, batch_size=2, max_len=40, num_draft=3)
    stream = _stream(0)
    want = _serve(jsrv, stream[:3], stream[3:])
    got = _serve(tsrv, stream[:3], stream[3:])
    tm = models["target"][2]
    for (p, n), w, g in zip(stream, want, got):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, _solo(tm, p, n))
    assert tsrv.stats() == jsrv.stats()
    stats = tsrv.stats()
    assert stats["generated"] == sum(n for _, n in stream)
    if draft == "perfect":
        assert stats["tokens_per_round"] > 2.0
        assert stats["acceptance_rate"] > 0.8
    elif draft == "near":
        assert 0.0 < stats["acceptance_rate"] < 1.0


def test_metrics_under_the_speculative_prefix(models):
    """`stats()` mirrors into ``serving/speculative/*`` gauges and every
    round observes ``serving/ms_per_token``, as in JAX."""
    reg = tmetrics.default_registry()
    hist = reg.histogram("serving/ms_per_token")
    before = hist.count
    _jsrv, tsrv = _make(models, "perfect", batch_size=2, max_len=48,
                        num_draft=3)
    rids = [tsrv.submit(p, 12) for p, _n in _stream(1)[:2]]
    done = dict(tsrv.run())
    assert sorted(done) == rids
    stats = tsrv.stats()
    assert (reg.get("serving/speculative/acceptance_rate").value
            == pytest.approx(stats["acceptance_rate"]))
    assert reg.get("serving/speculative/generated").value == 24
    assert hist.count - before == stats["rounds"]


def test_eos_and_a_queued_request(models):
    """Batch 1: the second request waits for the first's row; EOS cuts the
    first, and both equal JAX and their solo runs."""
    tm = models["target"][2]
    p0, p1 = _stream(2)[0][0], _stream(2)[1][0]
    free = _solo(tm, p0, 10)
    eos = int(free[3])
    outs = []
    for srv in _make(models, "near", batch_size=1, max_len=40, num_draft=4,
                     eos_id=eos):
        r0 = srv.submit(p0, 10)
        r1 = srv.submit(p1, 5)
        done = dict(srv.run())
        outs.append([np.asarray(done[r0]), np.asarray(done[r1])])
    for w, g in zip(*outs):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(outs[1][0], _solo(tm, p0, 10, eos_id=eos))
    np.testing.assert_array_equal(outs[1][1], _solo(tm, p1, 5, eos_id=eos))
    assert outs[1][0][-1] == eos


def test_rope_gqa_target():
    fields = dict(TARGET, position="rope", num_kv_heads=2)
    target = _pair(fields, 3)
    pair = {"target": target, "near": _pair(fields, 4, noise_of=target[1])}
    jsrv, tsrv = _make(pair, "near", batch_size=2, max_len=36, num_draft=3)
    stream = [(p, 6) for p, _n in _stream(3)[:3]]
    want, got = _serve(jsrv, stream), _serve(tsrv, stream)
    for (p, n), w, g in zip(stream, want, got):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, _solo(target[2], p, n))
    assert tsrv.stats() == jsrv.stats()


def test_prompt_buckets(models):
    """Custom buckets shape the waves (one wave a bucket): the same tokens
    and host accounting as JAX's."""
    jsrv, tsrv = _make(models, "near", batch_size=4, max_len=40,
                       num_draft=2, prompt_buckets=(4, 40))
    stream = _stream(4)
    want, got = _serve(jsrv, stream), _serve(tsrv, stream)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
    assert tsrv.stats() == jsrv.stats()
    assert tsrv.wave_counts() == {"cold": 3}


def test_sampled_mode(models):
    """temperature > 0: every request gets its budget, and one generator
    seed gives the same tokens again (another seed others)."""
    prompts = [np.asarray([7, 11, 2]), np.asarray([3, 1, 4, 1, 5]),
               np.asarray([9, 2, 6, 5])]

    def serve(seed):
        tm, td = models["target"][2], models["near"][2]
        srv = tserver.SpeculativeContinuousBatcher(
            tm, td, batch_size=2, max_len=40, num_draft=3, temperature=0.8,
            generator=torch.Generator().manual_seed(seed), device="cpu")
        rids = [srv.submit(p, 6) for p in prompts]
        done = dict(srv.run())
        return [tuple(done[r].tolist()) for r in rids]

    a, b, c = serve(11), serve(11), serve(12)
    assert a == b and a != c
    assert all(len(row) == 6 for row in a)


def test_queue_full_from_its_admission(models):
    """The base's admission gate: a depth cap of one queued request
    rejects the next submit with QueueFull, through `admission_ctl` and
    through ``TFDE_ADMIT_MAX_QUEUE`` (as the JAX batcher reads it)."""
    p = _stream(5)[0][0]
    tm, td = models["target"][2], models["near"][2]
    srv = tserver.SpeculativeContinuousBatcher(
        tm, td, batch_size=1, max_len=40, num_draft=2, device="cpu",
        admission_ctl=tadmission.AdmissionController(max_queue=1))
    srv.submit(p, 4)
    with pytest.raises(tadmission.QueueFull) as e:
        srv.submit(p, 4)
    assert e.value.reason == "queue_depth"
    with testing.env_set(TFDE_ADMIT_MAX_QUEUE="1"):
        jsrv, tsrv = _make(models, "near", batch_size=1, max_len=40,
                           num_draft=2)
    outs = []
    for srv, adm in ((jsrv, jadmission), (tsrv, tadmission)):
        first = srv.submit(p, 4)
        with pytest.raises(adm.QueueFull) as e:
            srv.submit(p, 4)
        done = dict(srv.run())
        outs.append((e.value.reason, e.value.queue_depth,
                     done[first].tolist()))
    assert outs[0] == outs[1]


#: the admission scenarios that pass no `admission_ctl` (JAX's
#: speculative batcher has no such argument)
_JAX_SCENARIOS = ("priority", "deadline_shed", "forced_overload",
                  "env_drill", "default_off", "progress")


@pytest.mark.parametrize("name", list(testing.ADMISSION_SCENARIOS))
def test_admission_scenarios(models, name):
    tm, td = models["target"][2], models["near"][2]
    prompt = _stream(6)[0][0]
    got = testing.admission_scenario(
        name, lambda **kw: tserver.SpeculativeContinuousBatcher(
            tm, td, num_draft=2, device="cpu", **kw),
        tadmission, tmetrics.default_registry(), prompt)
    if name in _JAX_SCENARIOS:
        jm, params, _ = models["target"]
        jd, dparams, _ = models["near"]
        want = testing.admission_scenario(
            name, lambda **kw: jserver.SpeculativeContinuousBatcher(
                jm, jd, params, dparams, num_draft=2, **kw),
            jadmission, jmetrics.default_registry(), prompt)
        assert got == want


@pytest.mark.parametrize("kw", [{"prefix_cache": True}, {"paged": True},
                                {"kv_quant": "int8"}, {"role": "decode"}])
def test_refused_arguments(models, kw):
    """Arguments the JAX speculative batcher does not have: TypeError in
    both packages."""
    jm, params, tm = models["target"]
    with pytest.raises(TypeError, match=list(kw)[0]):
        jserver.SpeculativeContinuousBatcher(jm, jm, params, params,
                                             batch_size=1, max_len=16, **kw)
    with pytest.raises(TypeError, match=list(kw)[0]):
        tserver.SpeculativeContinuousBatcher(tm, tm, batch_size=1,
                                             max_len=16, device="cpu", **kw)


def test_primed_and_trace_refused_and_cache_knobs_ignored(models,
                                                          monkeypatch):
    """`submit_primed` raises RuntimeError in both; `trace=` is taken by
    both and records the same event names (the trace ring on); under
    ``TFDE_PAGED_KV=1``, ``TFDE_KV_QUANT=int8`` and
    ``TFDE_PREFIX_CACHE=on`` both serve from the dense full-precision
    slabs with the same tokens and accounting."""
    for var, val in (("TFDE_PAGED_KV", "1"), ("TFDE_KV_QUANT", "int8"),
                     ("TFDE_PREFIX_CACHE", "on")):
        monkeypatch.setenv(var, val)
    jsrv, tsrv = _make(models, "near", batch_size=2, max_len=40,
                       num_draft=3)
    assert not tsrv._tgt_cache.quantized and not tsrv._drf_cache.quantized
    assert tsrv._tgt_cache.keys[0].shape == (2, 44, 4, 16)
    for srv in (jsrv, tsrv):
        with pytest.raises(RuntimeError, match="primed"):
            srv.submit_primed(tserver.PrimedRequest(
                prompt=np.asarray([1, 2]), first_token=3, max_new_tokens=2,
                kv={}))
    names = []
    for srv, trace in ((jsrv, jtrace), (tsrv, ttrace)):
        trace.enable()
        try:
            srv.submit(np.asarray([1, 2]), 2, trace="t")
            srv.run()
            # compile/* events come from the JAX recompile sentinel,
            # which the port does not have
            names.append([e["name"] for e in trace.events("t")
                          if not e["name"].startswith("compile/")])
        finally:
            trace.disable()
    assert names[1] == names[0]
    assert names[1][0] == "serve/queued" and "serve/done" in names[1]
    stream = _stream(7)
    want, got = _serve(jsrv, stream), _serve(tsrv, stream)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
    assert tsrv.stats() == jsrv.stats()
    assert tsrv.kv_stats()["kv_dtype"] == "float32"


def test_serve_gpt_num_draft(caplog):
    """`serve_gpt --num-draft 2 --tiny --device cpu` serves every request
    through the speculative batcher; `--prefix-cache` and sampling flags
    are refused as in the JAX example."""
    with caplog.at_level(logging.INFO, logger="serve_gpt"):
        done = serve_gpt.main(["--tiny", "--device", "cpu", "--num-draft",
                               "2", "--requests", "5", "--batch-size", "2",
                               "--max-new-tokens", "6"])
    assert len(done) == 5 and all(len(t) == 6 for _, t in done)
    assert any("acceptance_rate" in r.getMessage() for r in caplog.records)
    with pytest.raises(SystemExit):
        serve_gpt.main(["--tiny", "--device", "cpu", "--num-draft", "2",
                        "--prefix-cache", "on"])
    with pytest.raises(ValueError, match="greedy"):
        serve_gpt.main(["--tiny", "--device", "cpu", "--num-draft", "2",
                        "--temperature", "0.5"])
