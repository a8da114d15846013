"""The port's int8 KV (`TFDE_KV_QUANT`: tfde_tpu_torch/ops/quant.py, the
int8 cache layouts of inference/decode.py, the quantize-on-write /
dequantize-on-read attention of models/transformer.py, the scale planes
in the trie, the pool and defrag) against the JAX package.

- `kv_quantize` is bit-equal to JAX's on the same fp32 input, non-finite
  junk included: int8 payload equal, scales equal bit for bit.
- Through the batcher, on `gpt_tiny_test`'s weights shared by
  `from_flax_params`, the five-request stream of `tests/test_kv_quant.py`
  with a mid-flight cancel gives the JAX int8 batcher's greedy tokens,
  `stats()`, trie stats (the int8 segment bytes), pool refcounts, ledger
  (`kv_stats()`, the `kv/*` gauges and the pad-waste histogram) and usage
  token totals, dense and paged, trie off and on. Each JAX batcher is
  built once per module.
- The int8 logits of a prefill and six greedy steps lie within 0.1 of the
  fp ones (the JAX bound; the argmax never flips) and within 1e-5 of the
  JAX int8 logits; the cells keep the round-trip bound amax/254 + 0.02.
- Defrag moves the scale pools with the payload as JAX's does, and a
  defragmented int8 run (the trie remapped) serves the same tokens as
  one without defrag.
- `TFDE_KV_QUANT` resolution, and the refusals: a bad spelling, int8 with
  a rolling cache, a scatter between layouts, an int8 generative export.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfde_tpu.inference import decode as jdecode
from tfde_tpu.inference import paged as jpaged
from tfde_tpu.inference import server as jserver
from tfde_tpu.models.gpt import gpt_tiny_test as j_tiny
from tfde_tpu.observability import metrics as jmetrics
from tfde_tpu.ops.quant import kv_dequantize as j_dequant
from tfde_tpu.ops.quant import kv_quantize as j_quant
from tfde_tpu_torch.export.generative import export_generate
from tfde_tpu_torch.inference import decode as tdecode
from tfde_tpu_torch.inference import paged as tpaged
from tfde_tpu_torch.inference import server as tserver
from tfde_tpu_torch.models.flax_weights import from_flax_params
from tfde_tpu_torch.models.gpt import gpt_tiny_test
from tfde_tpu_torch.observability import metrics as tmetrics
from tfde_tpu_torch.ops.quant import kv_dequantize, kv_quantize
from tfde_tpu_torch.testing import one_thread

#: one intra-op torch thread for the module (`testing.one_thread`)
_one_thread = pytest.fixture(autouse=True, scope="module")(one_thread)

#: tests/test_kv_quant.py:54-57: two waves over three rows, a duplicate
#: 19-token prompt (the warm trie case), mixed budgets
PROMPTS = [np.arange(3, 10) % 97, np.arange(5, 11) % 97,
           np.arange(40, 59) % 97, np.arange(7, 12) % 97,
           np.arange(40, 59) % 97]
BUDGETS = [8, 5, 12, 6, 9]
KW = dict(batch_size=3, max_len=48, scan_depth=4)
#: (paged, trie) of each run; every run cancels request 2 after the
#: first step (a row-side cancel: it holds a row by then, its prompt
#: already in the trie for request 4)
RUNS = {"dense": (False, False), "dense_trie": (False, True),
        "paged": (True, False), "paged_trie": (True, True)}
CANCELLED = 2
#: the JAX acceptance bound on an int8 step's logits against fp
#: (tests/test_kv_quant.py::test_int8_logit_error_bounded_per_step)
LOGIT_BOUND = 0.1
#: the port's int8 logits against JAX's: the same quantizer on K/V that
#: agree to fp32 rounding
JAX_LOGIT_TOL = 1e-5


@pytest.fixture(scope="module")
def lm():
    jm = j_tiny()
    params = jm.init(jax.random.key(1), jnp.zeros((1, 8), jnp.int32))["params"]
    tm = gpt_tiny_test(device="cpu")
    tm.load_state_dict(from_flax_params(jax.tree.map(np.asarray, params)))
    return jm, params, tm


def _serve(srv, registry):
    """The stream with request 2 cancelled after the first step; returns
    the surviving requests' tokens and what the two batchers must agree
    on afterwards."""
    registry.reset("kv/")
    registry.reset("usage/")
    ids = [srv.submit(p, n) for p, n in zip(PROMPTS, BUDGETS)]
    out = dict(srv.step())
    assert srv.cancel(ids[CANCELLED])
    for _ in range(80):
        if srv.idle:
            break
        out.update(srv.step())
    assert srv.idle, "batcher did not drain"
    tokens = [list(map(int, out[r])) for i, r in enumerate(ids)
              if i != CANCELLED]
    scalars = registry.scalars("kv/")
    hist = registry.get("kv/pad_waste_frac")
    usage = registry.scalars("usage/")
    usage.pop("usage/kv_token_seconds")
    pool = srv.block_pool
    summary = {
        "stats": {k: v for k, v in srv.stats().items()
                  if k not in ("prefill_waves", "prefill_s", "decode_s")},
        "prefix": (srv.prefix_cache.stats()
                   if srv.prefix_cache is not None else None),
        "refcounts": (None if pool is None else
                      [pool.refcount(b) for b in range(pool.num_blocks)]),
        "kv_stats": srv.kv_stats(),
        "gauges": scalars,
        "waste_hist": (hist.count, hist.sum),
        "usage": usage,
        "usage_totals": {k: v for k, v in srv.usage.totals().items()
                         if k != "kv_token_seconds"},
    }
    return tokens, summary


@pytest.fixture(scope="module")
def jax_runs(lm):
    jm, params, _ = lm
    return {name: _serve(jserver.ContinuousBatcher(
        jm, params, kv_quant="int8", paged=paged, prefix_cache=trie, **KW),
        jmetrics.default_registry())
        for name, (paged, trie) in RUNS.items()}


# --------------------------------------------------------------------------
# the quantizer
# --------------------------------------------------------------------------

def test_kv_quantize_bit_equal_to_jax():
    """Wide dynamic range, exact ties (x / scale on a .5), all-zero
    vectors and NaN/+-inf junk: the int8 payload and the fp32 scales
    equal JAX's bit for bit; dequantize matches too, in fp32 and bf16."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4, 9, 3, 16)).astype(np.float32) * 7.0
    x[0, 0] *= 1e3
    x[1, 1] *= 1e-4
    x[2, 0, 0] = np.arange(16, dtype=np.float32) * 0.5 - 3.75 + 0.5
    x[2, 0, 0, -1] = 127.0           # scale 1: every .5 value is a tie
    x[3, 0] = 0.0
    x[3, 1, 0, 0] = np.nan
    x[3, 1, 1, 1] = np.inf
    x[3, 1, 2, 2] = -np.inf
    jq, js = j_quant(jnp.asarray(x))
    tq, ts = kv_quantize(torch.as_tensor(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    assert tq.shape == x.shape and ts.shape == x.shape[:-1]
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy().view(np.int32),
                                  np.asarray(js).view(np.int32))
    assert np.isfinite(ts.numpy()).all()
    for jd, td in ((jnp.float32, torch.float32),
                   (jnp.bfloat16, torch.bfloat16)):
        want = np.asarray(j_dequant(jq, js, jd).astype(jnp.float32))
        got = kv_dequantize(tq, ts, td)
        assert got.dtype == td
        np.testing.assert_array_equal(got.float().numpy(), want)
    # the round-trip bound on the finite vectors: half a quantization step
    back = kv_dequantize(tq, ts, torch.float32).numpy()[:3]
    amax = np.abs(x[:3]).max(-1, keepdims=True)
    assert (np.abs(back - x[:3]) <= amax / 254.0 + 1e-7).all()


# --------------------------------------------------------------------------
# the batcher against the JAX int8 batcher
# --------------------------------------------------------------------------

@pytest.mark.parametrize("run", list(RUNS))
def test_int8_batcher_matches_jax(lm, jax_runs, run):
    """Tokens, host accounting, trie and pool, the ledger's gauges and
    the usage counters of the int8 batcher equal the JAX int8 batcher's
    on the same stream and cancel (exact: the ledger's numbers are host
    arithmetic over the same bytes and counts)."""
    _, _, tm = lm
    paged, trie = RUNS[run]
    srv = tserver.ContinuousBatcher(tm, kv_quant="int8", paged=paged,
                                    prefix_cache=trie, device="cpu", **KW)
    assert srv.kv_quant == "int8" and srv._cache.quantized
    tokens, summary = _serve(srv, tmetrics.default_registry())
    want_tokens, want = jax_runs[run]
    assert tokens == want_tokens
    if trie:
        assert summary["prefix"]["hits"] >= 1     # the warm path ran
    assert summary == want
    # the census prices the scale planes: allocated = payload + scales
    kv = summary["kv_stats"]
    assert kv["kv_dtype"] == "int8" and kv["kv_quant_bits"] == 8
    if not paged:
        assert (kv["kv_payload_bytes"] + kv["kv_scale_bytes"]
                == kv["allocated_bytes"])
    assert kv["kv_fp32_equiv_bytes"] == 4 * kv["kv_payload_bytes"]
    assert summary["usage_totals"]["requests"] == len(PROMPTS)
    if paged:
        assert srv.block_pool.stats()["active"] == (
            summary["prefix"]["segments"] if trie else 0)


def test_int8_logit_error_bounded_per_step(lm):
    """Prefill (the flash path's shortcut at index 0, over dequantized
    K/V) and six greedy decode steps on the dense cache: int8 logits
    within LOGIT_BOUND of fp with the same argmax, and within
    JAX_LOGIT_TOL of the JAX int8 model's; layer-0 cells bit-equal to the
    quantizer of the fp cache, deeper cells within amax/254 + 0.02."""
    jm, params, tm = lm
    prompt = (np.arange(11) * 5 + 2) % 97

    def port(kv_quant):
        cache = tdecode.init_cache(tm, 1, 24, kv_quant=kv_quant)
        ids = torch.as_tensor(prompt[None])
        outs = []
        with torch.no_grad():
            logits = tm(ids, cache=cache)[:, -1]
            outs.append(logits.numpy())
            for _ in range(6):
                tok = logits.argmax(-1)
                logits = tm(tok[:, None], cache=cache)[:, -1]
                outs.append(logits.numpy())
        return outs, cache

    def jax_run():
        dm = jdecode._decode_clone(jm, kv_quant="int8")
        cache = jdecode.init_cache(jm, 1, 24, kv_quant="int8")
        toks = jnp.asarray(prompt[None], jnp.int32)
        step = jax.jit(lambda cache, toks: dm.apply(
            {"params": params, "cache": cache}, toks, train=False,
            mutable=["cache"]))
        outs = []
        for _ in range(7):
            logits, mut = step(cache, toks)
            cache = mut["cache"]
            outs.append(np.asarray(logits[:, -1], np.float32))
            toks = jnp.argmax(logits[:, -1:], -1).astype(jnp.int32)
        return outs

    fp, cache_fp = port(None)
    q8, cache_q8 = port("int8")
    for a, b, j in zip(fp, q8, jax_run()):
        assert np.abs(a - b).max() < LOGIT_BOUND
        assert int(a.argmax()) == int(b.argmax())
        assert np.abs(b - j).max() <= JAX_LOGIT_TOL
    c = prompt.size + 6
    for layer in range(tm.depth):
        for q, s, f in ((cache_q8.keys, cache_q8.key_scales, cache_fp.keys),
                        (cache_q8.values, cache_q8.value_scales,
                         cache_fp.values)):
            if layer == 0:
                want_q, want_s = kv_quantize(f[0][:, :c])
                assert torch.equal(q[0][:, :c], want_q)
                assert torch.equal(s[0][:, :c], want_s)
            back = kv_dequantize(q[layer], s[layer], torch.float32)[:, :c]
            ref = f[layer][:, :c]
            bound = ref.abs().amax(-1, keepdim=True) / 254.0 + 0.02
            assert bool(((back - ref).abs() <= bound).all())


# --------------------------------------------------------------------------
# defrag and the trie remap
# --------------------------------------------------------------------------

def test_apply_defrag_moves_scale_pools_as_jax():
    """A plan applied to an int8 pool moves every payload and scale
    block as the JAX `apply_defrag` moves its leaves; the tables remap
    the same way."""
    n, blk = 6, 4
    model = gpt_tiny_test(device="cpu")
    cache = tdecode.init_cache(model, 1, 8, paged_blocks=n, kv_block=blk,
                               kv_quant="int8")
    ids = torch.arange(n)
    for m, plane in enumerate(cache.planes().values()):
        shape = (n,) + (1,) * (plane.dim() - 1)
        plane.copy_((ids.view(shape) * (m + 1)).to(plane.dtype)
                    .expand_as(plane))
    jcache = {"layer": {
        "pool_key": cache.keys[0].numpy().copy(),
        "pool_value": cache.values[0].numpy().copy(),
        "pool_key_scale": cache.key_scales[0].numpy().copy(),
        "pool_value_scale": cache.value_scales[0].numpy().copy()}}
    tables = np.asarray([[4, 2, 0]], np.int32)
    plan = {2: 1, 4: 2}
    jout, jtables = jpaged.apply_defrag(
        jax.tree.map(jnp.asarray, jcache), tables, plan)
    ttables = tpaged.apply_defrag(cache, tables, plan)
    assert ttables.tolist() == np.asarray(jtables).tolist() == [[2, 1, 0]]
    for name, got in (("pool_key", cache.keys[0]),
                      ("pool_value", cache.values[0]),
                      ("pool_key_scale", cache.key_scales[0]),
                      ("pool_value_scale", cache.value_scales[0])):
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(jout["layer"][name]))
    # layer 0's planes are k, v, k_scale, v_scale: multipliers 1-4
    assert cache.key_scales[0][1, 0, 0] == 2.0 * 3   # followed block 2


def test_defrag_on_stall_keeps_int8_outputs(lm, monkeypatch):
    """An int8 paged run with the trie on, defragmented whenever the pool
    is fragmented, serves the same tokens as the same run without defrag;
    the trie's block ids follow the plan (every trie block is live and
    its lookups return the remapped ids), and kv/pool_defrags counts the
    passes."""
    _, _, tm = lm
    prompts = PROMPTS + [np.arange(17, 30) % 97]
    budgets = BUDGETS + [7]

    def run(thr):
        monkeypatch.setenv("TFDE_KV_DEFRAG_THRESHOLD", thr)
        srv = tserver.ContinuousBatcher(tm, kv_quant="int8", paged=True,
                                        prefix_cache=True, device="cpu",
                                        batch_size=3, max_len=48,
                                        scan_depth=2)
        ids = [srv.submit(p, n) for p, n in zip(prompts, budgets)]
        out = {}
        while not srv.idle:
            if srv.block_pool.fragmentation() > 0:
                srv._on_capacity_stall()
            out.update(srv.step())
        return [list(map(int, out[i])) for i in ids], srv

    counter = tmetrics.default_registry().counter("kv/pool_defrags")
    before = counter.value
    ref, _ = run("0")
    assert counter.value == before
    got, srv = run("0.01")
    assert got == ref
    assert srv.defrag_passes >= 1 and counter.value >= before + 1
    pool, trie = srv.block_pool, srv.prefix_cache
    assert trie.segments and pool.stats()["active"] == trie.segments
    _, matched = trie.lookup(PROMPTS[2])
    assert all(pool.refcount(b) == 1 for b in matched)


# --------------------------------------------------------------------------
# the knob and the refusals
# --------------------------------------------------------------------------

def test_kv_quant_knob_and_refusals(lm, monkeypatch):
    """TFDE_KV_QUANT picks the layout (the argument wins); a spelling the
    port cannot read raises where JAX warns and serves fp; int8 refuses a
    rolling cache (ValueError, as JAX's `_decode_clone`); GPT's kv_quant
    field builds and sets the default cache format; a scatter between an
    int8 and an fp cache and an int8 generative export raise."""
    _, _, tm = lm
    kw = dict(batch_size=2, max_len=32, scan_depth=2, prefix_cache=False,
              device="cpu")
    monkeypatch.setenv("TFDE_KV_QUANT", "INT8")
    srv = tserver.ContinuousBatcher(tm, **kw)
    assert srv.kv_quant == "int8" and srv._cache.quantized
    assert srv._cache.keys[0].dtype == torch.int8
    assert srv.kv_stats()["kv_scale_bytes"] > 0
    assert tserver.ContinuousBatcher(tm, kv_quant="fp", **kw).kv_quant is None
    monkeypatch.setenv("TFDE_KV_QUANT", "fp")
    srv = tserver.ContinuousBatcher(tm, **kw)
    assert srv.kv_quant is None and not srv._cache.quantized
    assert srv.kv_stats()["kv_scale_bytes"] == 0
    assert tserver.ContinuousBatcher(tm, kv_quant="int8",
                                     **kw).kv_quant == "int8"
    monkeypatch.setenv("TFDE_KV_QUANT", "int5")
    with pytest.raises(ValueError, match="TFDE_KV_QUANT"):
        tserver.ContinuousBatcher(tm, **kw)
    monkeypatch.delenv("TFDE_KV_QUANT")
    with pytest.raises(ValueError, match="kv_quant"):
        tdecode.init_cache(tm, 1, 8, kv_quant="int4")
    with pytest.raises(ValueError, match="rolling"):
        tdecode.init_cache(tm, 1, 8, kv_quant="int8", rolling=True)
    # without int8 the rolling request builds: the full cache here, as
    # the model has no window (tests/test_torch_rolling.py)
    assert not tdecode.init_cache(tm, 1, 8, rolling=True).rolling
    big = tdecode.init_cache(tm, 2, 8)
    with pytest.raises(ValueError, match="int8"):
        big.scatter_rows(tdecode.init_cache(tm, 1, 8, kv_quant="int8"),
                         torch.tensor([0]))
    qm = gpt_tiny_test(device="cpu", kv_quant="int8")
    assert qm.config["kv_quant"] == "int8"
    assert tdecode.init_cache(qm, 1, 8).quantized
    assert not tdecode.init_cache(gpt_tiny_test(device="cpu"), 1, 8).quantized
    with pytest.raises(ValueError, match="kv_quant"):
        gpt_tiny_test(device="cpu", kv_quant="int4")
    with pytest.raises(NotImplementedError, match="kv_quant"):
        export_generate(qm, "unused", 4, 2)
