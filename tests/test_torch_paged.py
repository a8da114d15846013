"""The port's paged KV (tfde_tpu_torch/inference/paged.py, the paged cache
layout, `MultiHeadAttention._paged_attention` and the ContinuousBatcher's
paged mode) against the JAX package.

The same operation sequences on the JAX `BlockPool`/`PagedPrefixCache`
and the port's give the same block ids, refcounts, free lists,
fragmentation, defrag plans, evictions and remapped tables, and
`apply_defrag` moves the same payloads. Through the batcher, on
`gpt_tiny_test`'s weights shared by `from_flax_params`, the five-request
stream of `tests/test_paged.py` gives the JAX paged batcher's greedy
tokens and host accounting with the trie off, on, and on with the
repetition penalty, and with a pool cut to two rows' worth (admission
stalls, the trie evicts, a stall defragments). Each row's table gathered
into position order equals the dense cache over its committed cells
(1e-6); `cancel` returns every block; `TFDE_PAGED_KV` picks the layout;
a pool too small for one row, an unreadable knob and a bad role raise,
and the role split's guards are JAX's. Each JAX batcher is built once
per module.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfde_tpu.inference import paged as jpaged
from tfde_tpu.inference import server as jserver
from tfde_tpu.models.gpt import gpt_tiny_test as j_tiny
from tfde_tpu_torch.inference import decode as tdecode
from tfde_tpu_torch.inference import paged as tpaged
from tfde_tpu_torch.inference import server as tserver
from tfde_tpu_torch.models.flax_weights import from_flax_params
from tfde_tpu_torch.models.gpt import gpt_tiny_test
from tfde_tpu_torch.testing import one_thread

#: one intra-op torch thread for the module (`testing.one_thread`)
_one_thread = pytest.fixture(autouse=True, scope="module")(one_thread)

#: tests/test_paged.py:44-51: two waves through three rows, a row reused
#: mid-flight, a duplicate 19-token prompt (its first block is complete,
#: so the trie shares it) and rider rows decoding through later chunks
PROMPTS = [np.arange(3, 10) % 97, np.arange(5, 11) % 97,
           np.arange(40, 59) % 97, np.arange(7, 12) % 97,
           np.arange(40, 59) % 97]
BUDGETS = [8, 5, 12, 6, 9]
KW = dict(batch_size=3, max_len=48, scan_depth=4)
PENALTY = 1.8
#: a stream that fills a cut pool: three requests on a shared 32-token
#: system prompt, four others, the system prompt again, a repeat
_SYS = np.arange(20, 52) % 97
STALL_PROMPTS = ([np.concatenate([_SYS, np.arange(k, k + 3 + k % 4) % 97])
                  for k in (1, 5, 9)]
                 + [np.arange(60, 80) % 97, np.arange(10, 27) % 97,
                    np.arange(30, 50) % 97, np.concatenate([_SYS, [7, 8]]),
                    np.arange(60, 80) % 97])
STALL_BUDGETS = [6, 9, 4, 8, 5, 7, 5, 6]
#: the cut pool: 5 blocks besides the null block, where nmax is 4
SMALL_POOL = 6
#: (trie, repetition penalty, pool blocks) of each JAX reference run
RUNS = {"paged": (False, 1.0, None), "paged_trie": (True, 1.0, None),
        "paged_trie_penalty": (True, PENALTY, None),
        "paged_trie_small_pool": (True, 1.0, SMALL_POOL)}


def _stream(run):
    return ((STALL_PROMPTS, STALL_BUDGETS) if RUNS[run][2] is not None
            else (PROMPTS, BUDGETS))


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
    for _ in range(80):
        for rid, toks in srv.step():
            out[rid] = list(map(int, toks))
        if len(out) == len(ids):
            break
    assert len(out) == len(ids), "batcher did not drain"
    return [out[i] for i in ids]


def _summary(srv) -> dict:
    """What the two batchers must agree on after the stream."""
    pool = srv.block_pool
    return {
        "stats": {k: v for k, v in srv.stats().items()
                  if k not in ("prefill_waves", "prefill_s", "decode_s")},
        "pool": pool.stats(),
        "refcounts": [pool.refcount(b) for b in range(pool.num_blocks)],
        "fragmentation": pool.fragmentation(),
        "prefix": (srv.prefix_cache.stats()
                   if srv.prefix_cache is not None else None),
    }


@pytest.fixture(scope="module")
def jax_runs(lm):
    """{run: (tokens, summary)} of the JAX paged batcher; the small-pool
    run with TFDE_KV_DEFRAG_THRESHOLD=0.1."""
    jm, params, _ = lm
    runs = {}
    mp = pytest.MonkeyPatch()
    try:
        for name, (trie, penalty, blocks) in RUNS.items():
            if blocks is not None:
                mp.setenv("TFDE_KV_DEFRAG_THRESHOLD", "0.1")
            srv = jserver.ContinuousBatcher(
                jm, params, kv_quant="fp", paged=True, prefix_cache=trie,
                repetition_penalty=penalty, pool_blocks=blocks, **KW)
            runs[name] = (drain(srv, *_stream(name)), _summary(srv))
            mp.delenv("TFDE_KV_DEFRAG_THRESHOLD", raising=False)
    finally:
        mp.undo()
    return runs


# --------------------------------------------------------------------------
# host parity: the pool, the paged trie, defrag
# --------------------------------------------------------------------------

def _pool_state(pool):
    return (pool.stats(), [pool.refcount(b) for b in range(pool.num_blocks)],
            pool.fragmentation())


def test_block_pool_matches_jax():
    """alloc (lowest id first), incref, free, an exhausted alloc rolled
    back, the evictor on starvation, fragmentation and a defrag plan:
    every result and the pool's state after each step as in JAX."""
    pools = {m: m.BlockPool(10, 16) for m in (jpaged, tpaged)}
    log = {m: [] for m in pools}
    for m, pool in pools.items():
        out = log[m]
        a = pool.alloc(6)
        pool.incref([a[5]])
        pool.free([a[0], a[2], a[4]])
        out += [a, _pool_state(pool)]
        with pytest.raises(m.PoolExhausted):
            pool.alloc(7)
        out.append(_pool_state(pool))
        held = pool.alloc(2)
        pool.set_evictor(lambda need, pool=pool, held=held:
                         pool.free(held[:need]) or need)
        five = pool.alloc(5)
        out += [held, five, _pool_state(pool)]
        pool.set_evictor(None)
        pool.free(five[::2])
        out += [pool.available(evictable=3), pool.defrag(),
                _pool_state(pool), pool.defrag()]
        with pytest.raises(ValueError, match="pinned"):
            pool.free([0])
        last = held[:1]
        pool.free(last)
        with pytest.raises(ValueError, match="double free"):
            pool.free(last)
        with pytest.raises(ValueError, match="unallocated"):
            pool.incref(last)
    assert log[tpaged] == log[jpaged]
    assert log[tpaged][1][2] > 0 and log[tpaged][-3]  # holes, then a plan


def _trie_run(m, ops):
    """Run trie operations on a fresh pool + paged trie of module `m`;
    returns every result and the state after each step."""
    pool = m.BlockPool(14, 4)
    trie = m.PagedPrefixCache(pool, block_bytes=100.0, byte_budget=600)
    pool.set_evictor(trie.evict)
    rows, out = {}, []
    for op in ops:
        kind = op[0]
        if kind == "row":          # a row takes blocks for its prompt
            _, name, tokens, claim = op
            pre, ids = (trie.lookup(tokens, claim=True) if claim
                        else (0, None))
            fresh = pool.alloc(m.blocks_for(len(tokens) + 1, 4)
                               - len(ids or []))
            rows[name] = (ids or []) + fresh
            out.append((pre, ids, fresh))
            if not pre:
                out.append(trie.insert(tokens, rows[name]))
        elif kind == "free":
            pool.free(rows.pop(op[1]))
        elif kind == "lookup":
            out.append(trie.lookup(op[1]))
        elif kind == "defrag":
            plan = pool.defrag()
            rows = {k: [plan.get(b, b) for b in v] for k, v in rows.items()}
            out += [plan, trie.remap(plan), sorted(rows.items())]
        out.append((trie.stats(), trie.evictable_blocks(), _pool_state(pool)))
    return out


def test_paged_trie_matches_jax():
    """A cold row whose blocks the trie adopts, warm rows claiming them,
    allocation pressure draining the trie LRU-first, a budget overrun, a
    defrag with its trie remap and the rows' tables remapped: every
    result and state as in JAX."""
    t = np.arange(1, 40)
    ops = [("row", "a", t[:13], False), ("row", "b", t[:10], True),
           ("lookup", t[:9]), ("free", "a"),
           ("row", "c", np.arange(60, 75), True),
           ("row", "d", t[:13], True), ("free", "b"), ("defrag",),
           ("lookup", t[:13]), ("row", "e", np.arange(80, 95), True),
           ("free", "c"), ("defrag",), ("lookup", np.arange(60, 75))]
    want = _trie_run(jpaged, ops)
    got = _trie_run(tpaged, ops)
    assert got == want
    assert any(isinstance(x, dict) and x for x in got)  # a non-empty plan
    assert got[-1][0]["evictions"] > 0


def test_apply_defrag_matches_jax():
    """`apply_defrag` moves each pool's rows to their new ids and
    remaps the tables exactly as the JAX function does."""
    rng = np.random.default_rng(0)
    pools = [rng.standard_normal((7, 4, 2, 3)).astype(np.float32)
             for _ in range(4)]
    tables = np.asarray([[5, 2, 0], [6, 3, 0]], np.int32)
    plan = {2: 1, 3: 2, 5: 3, 6: 4}
    jcache = {f"l{i}": {"pool_key": jnp.asarray(pools[2 * i]),
                        "pool_value": jnp.asarray(pools[2 * i + 1]),
                        "block_table": jnp.asarray(tables)}
              for i in range(2)}
    jcache, jtables = jpaged.apply_defrag(jcache, tables, plan)
    tcache = tdecode.PagedKVCache([torch.as_tensor(pools[0]),
                                   torch.as_tensor(pools[2])],
                                  [torch.as_tensor(pools[1]),
                                   torch.as_tensor(pools[3])],
                                  torch.as_tensor(tables, dtype=torch.int64),
                                  block=4)
    ttables = tpaged.apply_defrag(tcache, tables, plan)
    np.testing.assert_array_equal(ttables, jtables)
    for i in range(2):
        np.testing.assert_array_equal(tcache.keys[i].numpy(),
                                      np.asarray(jcache[f"l{i}"]["pool_key"]))
        np.testing.assert_array_equal(
            tcache.values[i].numpy(), np.asarray(jcache[f"l{i}"]["pool_value"]))
    assert tpaged.apply_defrag(tcache, tables, {}) is tables


# --------------------------------------------------------------------------
# the batcher
# --------------------------------------------------------------------------

@pytest.mark.parametrize("run", list(RUNS))
def test_paged_batcher_identical_to_jax(lm, jax_runs, run, monkeypatch):
    """The stream through the paged batcher: greedy tokens, host
    accounting, the pool's refcounts and the trie's statistics equal to
    the JAX paged batcher's; every request equals the port's solo
    `generate`. With the cut pool, admission stalls, the trie evicts and
    a stall defragments the pool."""
    _, _, tm = lm
    trie, penalty, blocks = RUNS[run]
    if blocks is not None:
        monkeypatch.setenv("TFDE_KV_DEFRAG_THRESHOLD", "0.1")
    want, jsummary = jax_runs[run]
    srv = tserver.ContinuousBatcher(tm, paged=True, prefix_cache=trie,
                                    repetition_penalty=penalty,
                                    pool_blocks=blocks, device="cpu", **KW)
    prompts, budgets = _stream(run)
    got = drain(srv, prompts, budgets)
    assert got == want
    assert _summary(srv) == jsummary
    assert srv.wave_counts().keys() == {"paged"}
    # a drained batcher holds only the trie's blocks
    assert srv.block_pool.stats()["active"] == (
        srv.prefix_cache.segments if trie else 0)
    if trie:
        assert srv.prefix_cache.stats()["hits"] >= 1
    if blocks is not None:
        assert srv.capacity_stalls > 0 and srv.defrag_passes > 0
        assert srv.prefix_cache.stats()["evictions"] > 0
    for p, n, g in zip(prompts, budgets, got):
        toks, lengths = tdecode.generate(tm, p[None], n, device="cpu",
                                         repetition_penalty=penalty)
        assert toks[0, p.size:int(lengths[0])].tolist() == g


@pytest.mark.parametrize("blocks", [5, 8])
def test_cut_pools_where_the_jax_gate_fails(lm, blocks, monkeypatch):
    """Two pools where the JAX batcher does not finish the stall stream:
    at 5 blocks its gate stalls forever with no row active (it counts the
    trie's leaves, not the interior nodes eviction reaches), at 8 its
    wave raises PoolExhausted (it counts a trie leaf a row shares as
    free). The port admits the first (only the trie holds blocks) and
    gives the second's requests back to the queue: every request ends
    with the solo `generate` tokens and every row's blocks return."""
    _, _, tm = lm
    monkeypatch.setenv("TFDE_KV_DEFRAG_THRESHOLD", "0.1")
    srv = tserver.ContinuousBatcher(tm, paged=True, prefix_cache=True,
                                    pool_blocks=blocks, device="cpu", **KW)
    got = drain(srv, STALL_PROMPTS, STALL_BUDGETS)
    assert srv.capacity_stalls > 0
    assert srv.block_pool.stats()["active"] == srv.prefix_cache.segments
    for p, n, g in zip(STALL_PROMPTS, STALL_BUDGETS, got):
        toks, _ = tdecode.generate(tm, p[None], n, device="cpu")
        assert toks[0, p.size:].tolist() == g


def _gathered(cache, layer, kv):
    pool = (cache.keys if kv == "k" else cache.values)[layer]
    return pool[cache.table].reshape(cache.table.shape[0], -1,
                                     *pool.shape[2:])


def test_paged_gather_matches_dense_cache(lm):
    """After the first wave of a warm-sharing stream and one decode
    round, each row's table gathered into position order equals the
    dense (prefix-cached) batcher's cache over the row's committed cells,
    within 1e-6, at every layer."""
    _, _, tm = lm
    sysp = np.arange(20, 52) % 97
    prompts = [np.concatenate([sysp, [k, k + 1, k + 2]]) for k in (1, 5, 9)]
    dense = tserver.ContinuousBatcher(tm, prefix_cache=True, device="cpu",
                                      **KW)
    paged = tserver.ContinuousBatcher(tm, paged=True, prefix_cache=True,
                                      device="cpu", **KW)
    for srv in (dense, paged):
        srv.submit(prompts[0], 3)
        srv.run()                        # seeds the trie
        for p in prompts[1:]:
            srv.submit(p, 6)
        srv.step()                       # a warm wave, then one round
    assert paged.reused_tokens()[1] == 32 and dense.reused_tokens()[1] == 32
    assert not paged._tables_dirty
    np.testing.assert_array_equal(paged.block_pool.stats()["active"] > 0,
                                  True)
    for layer in range(tm.depth):
        for kv in ("k", "v"):
            slab = (dense._cache.keys if kv == "k"
                    else dense._cache.values)[layer]
            got = _gathered(paged._cache, layer, kv)
            for r in range(KW["batch_size"]):
                c = int(dense._committed[r])
                assert c == int(paged._committed[r])
                if c:
                    torch.testing.assert_close(got[r, :c], slab[r, :c],
                                               rtol=0, atol=1e-6)


def test_cancel_returns_every_block(lm):
    """cancel() frees an in-flight row's blocks and re-points its table
    at the null block before the next program; a queued request leaves
    the queue; an unknown id is not found."""
    _, _, tm = lm
    srv = tserver.ContinuousBatcher(tm, batch_size=2, max_len=48,
                                    scan_depth=2, paged=True,
                                    prefix_cache=False, device="cpu")
    rid = srv.submit(np.arange(5, 30) % 97, 16)
    srv.step()
    assert srv.block_pool.stats()["active"] >= tpaged.blocks_for(25, 16)
    queued = [srv.submit(np.arange(3, 9), 4) for _ in range(3)]
    assert srv.cancel(queued[-1])
    assert srv.cancel(rid)
    assert srv.block_pool.stats()["active"] == 0
    assert srv.block_pool.free_blocks == srv.block_pool.num_blocks - 1
    assert srv._tables_dirty and (srv._tables == 0).all()
    assert not srv.cancel(12345)
    done = dict(srv.run())
    assert sorted(done) == queued[:-1]
    assert srv.block_pool.stats()["active"] == 0
    # the dense layout cancels the same way
    dense = tserver.ContinuousBatcher(tm, batch_size=2, max_len=48,
                                      paged=False, device="cpu")
    rid = dense.submit(np.arange(5, 30) % 97, 16)
    dense.step()
    assert dense.cancel(rid) and dense.idle


def test_env_knobs_select_the_layouts(lm, monkeypatch):
    """TFDE_PAGED_KV and TFDE_PREFIX_CACHE pick the layout and the trie
    when the arguments defer to them; values the knobs cannot read
    raise."""
    _, _, tm = lm
    kw = dict(batch_size=2, max_len=32, device="cpu")
    monkeypatch.setenv("TFDE_PAGED_KV", "on")
    monkeypatch.setenv("TFDE_PREFIX_CACHE", "on")
    srv = tserver.ContinuousBatcher(tm, **kw)
    assert srv.paged and isinstance(srv.prefix_cache, tpaged.PagedPrefixCache)
    assert srv.block_pool.num_blocks == 2 * 3 + 1   # nmax = ceil(33 / 16)
    monkeypatch.setenv("TFDE_PAGED_KV", "off")
    srv = tserver.ContinuousBatcher(tm, **kw)
    assert not srv.paged and srv.block_pool is None
    assert type(srv.prefix_cache).__name__ == "PrefixCache"
    monkeypatch.setenv("TFDE_PREFIX_CACHE", "off")
    assert tserver.ContinuousBatcher(tm, **kw).prefix_cache is None
    monkeypatch.setenv("TFDE_PAGED_KV", "paged")
    with pytest.raises(ValueError, match="TFDE_PAGED_KV"):
        tserver.ContinuousBatcher(tm, **kw)


def test_paged_refuses_what_it_cannot_serve(lm, monkeypatch):
    """A pool smaller than one max-length row, a dense trie handed to a
    paged batcher, pool_blocks without paging, a bad role and a KV format
    the port does not have all raise; the role split's guards are the JAX
    batcher's (a prefill replica refuses `submit_primed`)."""
    _, _, tm = lm
    kw = dict(batch_size=2, max_len=32, device="cpu")
    with pytest.raises(ValueError, match="cannot hold even one"):
        tserver.ContinuousBatcher(tm, paged=True, pool_blocks=3, **kw)
    with pytest.raises(ValueError, match="dense PrefixCache"):
        tserver.ContinuousBatcher(
            tm, paged=True, prefix_cache=tserver._resolve_prefix(True), **kw)
    with pytest.raises(ValueError, match="pool_blocks"):
        tserver.ContinuousBatcher(tm, paged=False, pool_blocks=9, **kw)
    assert tserver.ContinuousBatcher(tm, paged=True, role="decode",
                                     **kw).role == "decode"
    with pytest.raises(ValueError, match="role"):
        tserver.ContinuousBatcher(tm, paged=True, role="bogus", **kw)
    # int8 KV is ported (tests/test_torch_kv_quant.py); a format the port
    # does not have raises, by argument or by knob
    with pytest.raises(ValueError, match="kv_quant"):
        tserver.ContinuousBatcher(tm, kv_quant="int4", **kw)
    monkeypatch.setenv("TFDE_KV_QUANT", "int4")
    with pytest.raises(ValueError, match="TFDE_KV_QUANT"):
        tserver.ContinuousBatcher(tm, **kw)
    monkeypatch.delenv("TFDE_KV_QUANT")
    srv = tserver.ContinuousBatcher(tm, paged=True, **kw)
    primed = srv.prime(np.arange(4), 2)
    assert primed.kv[(0, "k")].shape[0] == 4
    pre = tserver.ContinuousBatcher(tm, paged=True, role="prefill", **kw)
    with pytest.raises(RuntimeError, match="prefill-only"):
        pre.submit_primed(primed)
