"""The port's serving path (tfde_tpu_torch/inference) against the JAX package.

On `gpt_tiny_test`'s weights, shared through `from_flax_params`, the port's
ContinuousBatcher must emit greedy tokens IDENTICAL to the JAX
ContinuousBatcher and to JAX `generate` — staggered mid-flight
submissions, rows recycled, scan depths 1 and 4, an EOS case — with the
same dispatch/sync accounting. `sample_logits`' filters are compared on
the filtered logits (captured from JAX's categorical draw), not on random
draws. The batcher's host helpers match the JAX ones, and the entry
points refuse to run without CUDA unless asked for the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfde_tpu.inference import decode as jdecode
from tfde_tpu.inference import server as jserver
from tfde_tpu.models.gpt import gpt_tiny_test as j_tiny
from tfde_tpu_torch import serve_gpt
from tfde_tpu_torch.inference import decode as tdecode
from tfde_tpu_torch.inference import server as tserver
from tfde_tpu_torch.models.flax_weights import from_flax_params
from tfde_tpu_torch.models.gpt import gpt_tiny_test
from tfde_tpu_torch.utils.devices import resolve_device
from tfde_tpu_torch.testing import one_thread

#: one intra-op torch thread for the module (`testing.one_thread`)
_one_thread = pytest.fixture(autouse=True, scope="module")(one_thread)


@pytest.fixture(scope="module")
def lm():
    jm = j_tiny()
    params = jm.init(jax.random.key(1), jnp.zeros((1, 8), jnp.int32))["params"]
    tm = gpt_tiny_test(device="cpu")
    tm.load_state_dict(from_flax_params(jax.tree.map(np.asarray, params)))
    return jm, params, tm


#: (prompt length, max_new_tokens); the first 4 are submitted up front,
#: the rest after two steps, while rows are mid-generation
REQUESTS = [(3, 9), (5, 4), (2, 12), (7, 7), (4, 1), (6, 10), (11, 5)]


def _serve(srv, prompts):
    rids = [srv.submit(p, n) for p, n in prompts[:4]]
    done = {}
    for _ in range(2):
        done.update(srv.step())
    rids += [srv.submit(p, n) for p, n in prompts[4:]]
    done.update(srv.run())
    assert srv.idle and sorted(done) == sorted(rids)
    return [np.asarray(done[r]) for r in rids]


def _jax_solo(jm, params, prompt, n, **kw):
    toks, lengths = jdecode.generate(
        jm, params, jnp.asarray(prompt[None, :], jnp.int32),
        max_new_tokens=n, **kw)
    return np.asarray(toks)[0, prompt.size:int(lengths[0])]


@pytest.mark.parametrize("scan_depth", [1, 4])
def test_batcher_tokens_identical_to_jax(lm, scan_depth):
    jm, params, tm = lm
    rng = np.random.default_rng(10)
    prompts = [(rng.integers(0, 97, p).astype(np.int64), n)
               for p, n in REQUESTS]
    jsrv = jserver.ContinuousBatcher(
        jm, params, batch_size=3, max_len=48, scan_depth=scan_depth,
        kv_quant="fp", paged=False, prefix_cache=False)
    tsrv = tserver.ContinuousBatcher(tm, batch_size=3, max_len=48,
                                     scan_depth=scan_depth, device="cpu")
    want = _serve(jsrv, prompts)
    got = _serve(tsrv, prompts)
    for (p, n), w, g in zip(prompts, want, got):
        np.testing.assert_array_equal(g, w)
        assert len(g) == n
    # same host accounting: one dispatch per device program the JAX
    # batcher runs, one sync per fetch
    tstats = tsrv.stats()
    assert tstats.pop("prefill_waves") > 0
    assert tstats.pop("prefill_s") > 0 and tstats.pop("decode_s") > 0
    assert tstats == jsrv.stats()
    if scan_depth == 4:
        for (p, n), g in zip(prompts, got):
            np.testing.assert_array_equal(g, _jax_solo(jm, params, p, n))
            toks, lengths = tdecode.generate(tm, p[None, :], n,
                                             device="cpu")
            np.testing.assert_array_equal(
                toks[0, p.size:int(lengths[0])].numpy(), g)


def test_eos_and_instant_finish_identical_to_jax(lm):
    jm, params, tm = lm
    prompt = np.random.default_rng(11).integers(0, 97, 4).astype(np.int64)
    free = _jax_solo(jm, params, prompt, 10)
    eos = int(free[2])  # the third generated token
    ref = _jax_solo(jm, params, prompt, 10, eos_id=eos, pad_id=0)
    srv = tserver.ContinuousBatcher(tm, batch_size=2, max_len=48,
                                    eos_id=eos, device="cpu")
    rid = srv.submit(prompt, max_new_tokens=10)
    one = srv.submit(prompt, max_new_tokens=1)  # budget 1: first token only
    done = dict(srv.run())
    np.testing.assert_array_equal(done[rid], ref)
    np.testing.assert_array_equal(done[one], free[:1])
    toks, lengths = tdecode.generate(tm, prompt[None, :], 10, eos_id=eos,
                                     device="cpu")
    jt, jl = jdecode.generate(jm, params, jnp.asarray(prompt[None, :]), 10,
                              eos_id=eos, pad_id=0)
    np.testing.assert_array_equal(toks.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(lengths.numpy(), np.asarray(jl))


def test_repetition_penalty_batcher_identical_to_jax(lm):
    jm, params, tm = lm
    rng = np.random.default_rng(12)
    prompts = [(rng.integers(0, 97, p).astype(np.int64), n)
               for p, n in [(3, 6), (6, 5), (2, 8), (5, 4), (4, 6)]]
    kw = dict(batch_size=2, max_len=32, scan_depth=2,
              repetition_penalty=1.8)
    jsrv = jserver.ContinuousBatcher(jm, params, kv_quant="fp", paged=False,
                                     prefix_cache=False, **kw)
    tsrv = tserver.ContinuousBatcher(tm, device="cpu", **kw)
    for w, g in zip(_serve(jsrv, prompts), _serve(tsrv, prompts)):
        np.testing.assert_array_equal(g, w)


SAMPLING = [
    dict(temperature=0.7),
    dict(temperature=1.3, top_k=5),
    dict(temperature=1.0, top_p=0.6),
    dict(temperature=0.9, min_p=0.2),
    dict(temperature=1.1, top_k=20, top_p=0.8, min_p=0.05,
         repetition_penalty=1.5),
]


@pytest.mark.parametrize("cfg", SAMPLING, ids=lambda c: "-".join(c))
def test_filtered_logits_match_jax(cfg, monkeypatch):
    rng = np.random.default_rng(13)
    logits = (rng.standard_normal((4, 97)) * 3).astype(np.float32)
    seen = rng.random((4, 97)) < 0.2
    captured = []

    def capture(key, lg, axis=-1):
        captured.append(np.asarray(lg))
        return jnp.zeros(lg.shape[:-1], jnp.int32)

    monkeypatch.setattr(jax.random, "categorical", capture)
    jdecode.sample_logits(jnp.asarray(logits), jax.random.key(0),
                          seen=jnp.asarray(seen), **cfg)
    got = tdecode.filter_logits(torch.as_tensor(logits),
                                seen=torch.as_tensor(seen), **cfg)
    (want,) = captured
    np.testing.assert_array_equal(np.isfinite(got.numpy())
                                  & (got.numpy() > -1e30),
                                  want > -1e30)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    # a draw only ever lands on a kept token
    gen = torch.Generator().manual_seed(0)
    tok = tdecode.sample_logits(torch.as_tensor(logits), gen,
                                seen=torch.as_tensor(seen), **cfg)
    assert all(want[i, t] > -1e30 for i, t in enumerate(tok.tolist()))


@pytest.mark.parametrize("penalty", [1.0, 1.7])
def test_greedy_sample_matches_jax(penalty):
    rng = np.random.default_rng(14)
    logits = rng.standard_normal((5, 97)).astype(np.float32)
    seen = rng.random((5, 97)) < 0.3
    want = jdecode.sample_logits(jnp.asarray(logits), jax.random.key(0),
                                 temperature=0.0, seen=jnp.asarray(seen),
                                 repetition_penalty=penalty)
    got = tdecode.sample_logits(torch.as_tensor(logits), temperature=0.0,
                                seen=torch.as_tensor(seen),
                                repetition_penalty=penalty)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_host_helpers_match_jax():
    for max_len in (8, 9, 48, 100, 1024):
        assert tserver._normalize_buckets(None, max_len) \
            == jserver._normalize_buckets(None, max_len)
    assert tserver._normalize_buckets((4, 30, 200), 64) \
        == jserver._normalize_buckets((4, 30, 200), 64)
    with pytest.raises(ValueError, match="cover"):
        tserver._normalize_buckets((4, 8), 64)
    buckets = tserver._normalize_buckets(None, 64)
    for p in (1, 8, 9, 33, 64):
        prompt = np.arange(1, p + 1)
        tp, tl = tserver._bucketed(prompt, buckets, 0)
        jp, jl = jserver._bucketed(prompt, buckets, 0)
        np.testing.assert_array_equal(tp, np.asarray(jp))
        assert tl == jl
    for cap in (1, 4, 8, 16):
        for bound in range(-1, 20):
            assert tserver._ladder_depth(cap, bound) \
                == jserver._ladder_depth(cap, bound)
        for r in range(1, 20):
            assert tserver._pad_wave(r, cap) == jserver._pad_wave(r, cap)


def test_priority_queue_drains_highest_first(lm):
    _jm, _params, tm = lm
    srv = tserver.ContinuousBatcher(tm, batch_size=1, max_len=32,
                                    device="cpu")
    order = [("best_effort", 1), ("batch", 2), ("interactive", 3),
             ("batch", 4)]
    rids = {srv.submit(np.array([t]), 1, priority=p): t for p, t in order}
    finished = [rids[rid] for rid, _toks in srv.run()]
    assert finished == [3, 2, 4, 1]
    with pytest.raises(ValueError, match="priority"):
        srv.submit(np.array([1]), 1, priority="urgent")
    with pytest.raises(ValueError, match="max_len"):
        srv.submit(np.zeros(30, np.int64), 10)
    with pytest.raises(ValueError, match="at least one"):
        srv.submit(np.zeros(0, np.int64), 4)


def test_scatter_rows_with_duplicate_rows(lm):
    _jm, _params, tm = lm
    big = tdecode.init_cache(tm, 4, 8)
    small = tdecode.init_cache(tm, 3, 8)
    gen = torch.Generator().manual_seed(0)
    for t in small.keys + small.values:
        t.copy_(torch.randn(t.shape, generator=gen))
        t[2] = t[0]  # ladder padding repeats row 0 verbatim
    big.scatter_rows(small, torch.tensor([2, 0, 2]))
    torch.testing.assert_close(big.keys[0][2], small.keys[0][0])
    torch.testing.assert_close(big.values[1][0], small.values[1][1])
    assert float(big.keys[1][1].abs().sum()) == 0.0


def test_entry_points_raise_without_cuda(lm, monkeypatch):
    """Without a GPU, every entry point raises unless given device='cpu'
    — none falls back to the CPU on its own."""
    _jm, _params, tm = lm
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        gpt_tiny_test()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tserver.ContinuousBatcher(tm, batch_size=1, max_len=16)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tdecode.generate(tm, np.ones((1, 3), np.int64), 2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve_gpt.main(["--tiny", "--requests", "1"])
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="cuda"):
        resolve_device("meta")


def test_serve_gpt_runs_on_cpu():
    done = serve_gpt.main(["--tiny", "--device", "cpu", "--requests", "3",
                           "--batch-size", "2", "--max-new-tokens", "5"])
    assert len(done) == 3 and all(len(t) == 5 for _rid, t in done)
