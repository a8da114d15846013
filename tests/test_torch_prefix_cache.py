"""The port's dense prefix-KV cache (tfde_tpu_torch/inference/prefix_cache.py
and the ContinuousBatcher's warm admissions) against the JAX package.

The same sequence of trie operations on the JAX `PrefixCache` (numpy K/V)
and the port's (tensors) gives the same matched lengths, stored blocks,
evictions, statistics and segments. Through the batcher, on
`gpt_tiny_test`'s weights shared by `from_flax_params`, the five-request
stream of `tests/test_paged.py` (two waves, a reused row, a duplicate
19-token prompt) gives the JAX batcher's greedy tokens and host
accounting with the prefix cache on, and the port's `generate` tokens
with the repetition penalty; a warm admission's first-token logits lie
within 1e-5 of the JAX model's over the whole prompt. The planner's suffix-bucket clamp, the
`TFDE_PREFIX_CACHE` spec and `serve_gpt --prefix-cache` are covered too.
Each JAX batcher is built once per module: each one compiles.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfde_tpu.inference import prefix_cache as jpc
from tfde_tpu.inference import server as jserver
from tfde_tpu.models.gpt import gpt_tiny_test as j_tiny
from tfde_tpu_torch import serve_gpt
from tfde_tpu_torch.inference import decode as tdecode
from tfde_tpu_torch.inference import prefix_cache as tpc
from tfde_tpu_torch.inference import server as tserver
from tfde_tpu_torch.inference.decode import KVCache
from tfde_tpu_torch.models.flax_weights import from_flax_params
from tfde_tpu_torch.models.gpt import gpt_tiny_test

#: the JAX paged tests' stream (tests/test_paged.py:44-51)
PROMPTS = [np.arange(3, 10) % 97, np.arange(5, 11) % 97,
           np.arange(40, 59) % 97, np.arange(7, 12) % 97,
           np.arange(40, 59) % 97]
BUDGETS = [8, 5, 12, 6, 9]
KW = dict(batch_size=3, max_len=48, scan_depth=4)
PENALTY = 1.8


@pytest.fixture(scope="module")
def lm():
    jm = j_tiny()
    params = jm.init(jax.random.key(1), jnp.zeros((1, 8), jnp.int32))["params"]
    tm = gpt_tiny_test(device="cpu")
    tm.load_state_dict(from_flax_params(jax.tree.map(np.asarray, params)))
    return jm, params, tm


def drain(srv, prompts=PROMPTS, budgets=BUDGETS):
    ids = [srv.submit(p, n) for p, n in zip(prompts, budgets)]
    out = {}
    for _ in range(60):
        for rid, toks in srv.step():
            out[rid] = list(map(int, toks))
        if len(out) == len(ids):
            break
    assert len(out) == len(ids), "batcher did not drain"
    return [out[i] for i in ids]


@pytest.fixture(scope="module")
def jax_run(lm):
    """(tokens, stats, prefix stats) of the JAX batcher with the dense
    prefix cache on."""
    jm, params, _ = lm
    srv = jserver.ContinuousBatcher(jm, params, kv_quant="fp", paged=False,
                                    prefix_cache=True, **KW)
    return drain(srv), srv.stats(), srv.prefix_cache.stats()


def _row_caches(seed=0, rows=2, length=40, layers=2, kv=3, d=2):
    """The same random K/V as a JAX cache-collection tree and a port
    KVCache ([rows, length, kv, d] a layer and k/v)."""
    rng = np.random.default_rng(seed)
    ks = [rng.standard_normal((rows, length, kv, d)).astype(np.float32)
          for _ in range(layers)]
    vs = [rng.standard_normal((rows, length, kv, d)).astype(np.float32)
          for _ in range(layers)]
    jtree = {"decoder": {f"block_{i}": {"attn": {
        "cached_key": jnp.asarray(ks[i]), "cached_value": jnp.asarray(vs[i]),
        "cache_index": jnp.zeros((), jnp.int32)}} for i in range(layers)},
        "position_index": jnp.zeros((), jnp.int32)}
    tcache = KVCache([torch.as_tensor(k) for k in ks],
                     [torch.as_tensor(v) for v in vs])
    return jtree, tcache


def _jax_name(layer: int, kv: str) -> str:
    leaf = "cached_key" if kv == "k" else "cached_value"
    return f"decoder/block_{layer}/attn/{leaf}"


def _same_kv(jkv, tkv):
    assert (jkv is None) == (tkv is None)
    if tkv is None:
        return
    assert len(jkv) == len(tkv)
    for (layer, kv), seg in tkv.items():
        np.testing.assert_array_equal(seg.numpy(),
                                      np.asarray(jkv[_jax_name(layer, kv)]))


def test_trie_operations_match_jax():
    """Inserts, lookups (hits, partial matches, misses, the one-token
    rule), LRU evictions under a byte budget and a refused overrun: every
    return value, the statistics after each step and every segment agree
    with the JAX trie's."""
    jtree, tcache = _row_caches()
    node = 2 * 2 * 4 * 3 * 2 * 4  # layers x k/v x block x kv x d x fp32
    j = jpc.PrefixCache(byte_budget=5 * node, block=4)
    t = tpc.PrefixCache(byte_budget=5 * node, block=4)
    a = np.arange(10)
    b = np.concatenate([a[:4], [90, 91, 92, 93, 94, 95]])
    c = np.arange(50, 75)
    ops = [("insert", a, 0), ("lookup", a), ("lookup", a[:8]),
           ("lookup", b), ("insert", b, 1), ("lookup", b),
           ("lookup", np.asarray([77, 78, 79, 80, 81])), ("lookup", a[:3]),
           ("insert", c, 1), ("lookup", a), ("lookup", c),
           ("insert", np.arange(100, 140), 0), ("lookup", c)]
    for op in ops:
        if op[0] == "insert":
            got = (j.insert(op[1], jtree, op[2]),
                   t.insert(op[1], tcache, op[2]))
            assert got[0] == got[1], op
        else:
            (jl, jkv), (tl, tkv) = j.lookup(op[1]), t.lookup(op[1])
            assert jl == tl, op
            _same_kv(jkv, tkv)
        assert t.stats() == j.stats(), op
        assert t.resident_bytes <= t.byte_budget
    assert t.stats()["evictions"] > 0


def test_resolve_spec_matches_jax(monkeypatch):
    """TFDE_PREFIX_CACHE off/on/<bytes> and the explicit specs resolve as
    in JAX; a value that cannot be read raises (JAX warns and stays
    off)."""
    for raw in ("off", "on", "1", "0", "", "1048576"):
        monkeypatch.setenv("TFDE_PREFIX_CACHE", raw)
        j, t = jpc.resolve(None), tpc.resolve(None)
        assert (j is None) == (t is None), raw
        if t is not None:
            assert t.byte_budget == j.byte_budget
    monkeypatch.setenv("TFDE_PREFIX_CACHE", "bogus")
    with pytest.raises(ValueError, match="TFDE_PREFIX_CACHE"):
        tpc.resolve(None)
    monkeypatch.delenv("TFDE_PREFIX_CACHE")
    assert tpc.resolve(None) is None
    for spec in (False, 0, "off", True, "on", 2048):
        j, t = jpc.resolve(spec), tpc.resolve(spec)
        assert (j is None) == (t is None), spec
        if t is not None:
            assert t.byte_budget == j.byte_budget
    pc = tpc.PrefixCache(block=4)
    assert tpc.resolve(pc) is pc
    with pytest.raises(ValueError):
        tpc.resolve("bogus")


def test_batcher_prefix_tokens_identical_to_jax(lm, jax_run):
    """The five-request stream with the prefix cache on: greedy tokens,
    host accounting and trie statistics equal to the JAX batcher's, the
    duplicate prompt admitted warm, and every request equal to the port's
    solo `generate`."""
    _, _, tm = lm
    want, jstats, jprefix = jax_run
    srv = tserver.ContinuousBatcher(tm, prefix_cache=True, device="cpu",
                                    **KW)
    got = drain(srv)
    assert got == want
    stats = srv.stats()
    for k in ("prefill_waves", "prefill_s", "decode_s"):
        stats.pop(k)
    assert stats == jstats
    assert srv.prefix_cache.stats() == jprefix
    assert jprefix["hits"] >= 1 and srv.wave_counts()["warm"] >= 1
    assert max(srv.reused_tokens().values()) == 16
    for p, n, g in zip(PROMPTS, BUDGETS, got):
        toks, lengths = tdecode.generate(tm, p[None], n, device="cpu")
        assert toks[0, p.size:int(lengths[0])].tolist() == g


def test_batcher_prefix_repetition_penalty(lm):
    """With the repetition penalty, a warm row's presence mask covers the
    whole prompt, cached prefix included: the stream's tokens equal the
    port's solo `generate` with the penalty (held to JAX `generate` by
    tests/test_torch_server.py; the paged file holds the penalised paged
    batcher to the JAX batcher)."""
    _, _, tm = lm
    srv = tserver.ContinuousBatcher(tm, prefix_cache=True,
                                    repetition_penalty=PENALTY,
                                    device="cpu", **KW)
    got = drain(srv)
    assert srv.wave_counts()["warm"] >= 1
    for p, n, g in zip(PROMPTS, BUDGETS, got):
        toks, lengths = tdecode.generate(tm, p[None], n, device="cpu",
                                         repetition_penalty=PENALTY)
        assert toks[0, p.size:int(lengths[0])].tolist() == g


def test_warm_first_token_logits_match_jax(lm, monkeypatch):
    """A warm admission (a 32-token prompt whose 16-token prefix another
    request cached) samples from logits within 1e-5 of the JAX model's
    over the whole prompt, and the sampled token is their argmax."""
    jm, params, tm = lm
    rng = np.random.default_rng(3)
    sysp = rng.integers(1, 90, 16)
    prompts = [np.concatenate([sysp, rng.integers(1, 90, k)]) for k in (3, 16)]
    seen = []
    real = tserver.sample_logits

    def spy(logits, *a, **kw):
        seen.append(logits.clone())
        return real(logits, *a, **kw)

    monkeypatch.setattr(tserver, "sample_logits", spy)
    srv = tserver.ContinuousBatcher(tm, prefix_cache=True, device="cpu",
                                    **KW)
    srv.submit(prompts[0], 4)
    srv.run()
    seen.clear()
    rid = srv.submit(prompts[1], 4)
    srv._admit()
    assert srv.reused_tokens()[rid] == 16 and srv.wave_counts()["warm"] == 1
    forward = jax.jit(lambda p, x: jm.apply({"params": p}, x, train=False))
    want = np.asarray(forward(params, jnp.asarray(prompts[1][None],
                                                   jnp.int32)))[0, -1]
    got = seen[0][0].numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert int(np.argmax(got)) == int(np.argmax(want))
    srv.run()


def test_plan_clamps_warm_suffix_bucket(lm):
    """The suffix feeds at cache position pre_len, so its bucket must fit
    past the prefix (pre_len + bucket <= max_len) or the clamped write
    would overwrite the prefix K/V: the planner shortens the prefix a
    block at a time (24 -> 16 with buckets 8, 48, 64) or admits cold
    (pow-2 buckets, a 33-token suffix); the shortened warm wave still
    gives the solo tokens."""
    _, _, tm = lm
    t = np.arange(1, 65, dtype=np.int64)
    _, cache = _row_caches(rows=1, length=64, layers=2, kv=4, d=8)
    pc = tpc.PrefixCache(block=8)
    pc.insert(t[:32], cache, row=0)
    srv = tserver.ContinuousBatcher(tm, batch_size=2, max_len=64,
                                    prompt_buckets=(8, 48, 64),
                                    prefix_cache=pc, device="cpu")
    prompt = np.concatenate([t[:24], t[:30] + 30])
    [(kind, key, group)] = srv._plan_wave([(0, prompt, 4)])
    assert kind == "warm" and key[:2] == (16, 48)
    assert all(a.shape[0] == 16 for a in group[0][3].values())

    pc2 = tpc.PrefixCache(block=16)
    pc2.insert(t[:32], cache, row=0)
    srv2 = tserver.ContinuousBatcher(tm, batch_size=2, max_len=64,
                                     prefix_cache=pc2, device="cpu")
    prompt2 = np.concatenate([t[:16], t[:33] + 30])
    [(kind2, key2, _)] = srv2._plan_wave([(0, prompt2, 3)])
    assert kind2 == "cold" and key2 == 64

    # end to end through the shortened prefix: real K/V this time
    srv3 = tserver.ContinuousBatcher(tm, batch_size=2, max_len=64,
                                     prompt_buckets=(8, 48, 64),
                                     prefix_cache=tpc.PrefixCache(block=8),
                                     device="cpu")
    base = t[:32] % 97
    p1 = np.concatenate([base[:24], (t[:30] + 30) % 97])
    done = {}
    r0 = srv3.submit(base, 6)
    done.update(srv3.run())
    r1 = srv3.submit(p1, 6)
    done.update(srv3.run())
    assert srv3.reused_tokens()[r1] == 16
    for rid, p in ((r0, base), (r1, p1)):
        toks, _ = tdecode.generate(tm, p[None], 6, device="cpu")
        assert done[rid].tolist() == toks[0, p.size:].tolist()


@pytest.mark.parametrize("paged", ["0", "1"])
def test_serve_gpt_prefix_cache_on_cpu(paged, monkeypatch):
    """`serve_gpt --prefix-cache on --shared-prefix 32` serves on the CPU,
    dense and with TFDE_PAGED_KV=1, and its requests after the first wave
    reuse the system prompt (tests/test_torch_serve_hf.py holds that an
    unreadable spec is an argparse error)."""
    monkeypatch.setenv("TFDE_PAGED_KV", paged)
    seen = []
    real = tserver.ContinuousBatcher.__init__

    def spy(self, *a, **kw):
        real(self, *a, **kw)
        seen.append(self)

    monkeypatch.setattr(tserver.ContinuousBatcher, "__init__", spy)
    done = serve_gpt.main(["--tiny", "--device", "cpu", "--requests", "4",
                           "--batch-size", "2", "--max-new-tokens", "4",
                           "--prefix-cache", "on", "--shared-prefix", "32"])
    assert len(done) == 4 and all(len(t) == 4 for _, t in done)
    [srv] = seen
    assert srv.paged == (paged == "1")
    assert sorted(srv.reused_tokens().values()) == [0, 0, 32, 32]
