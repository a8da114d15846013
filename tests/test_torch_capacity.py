"""The port's KV capacity ledger and usage meter
(tfde_tpu_torch/observability/{capacity,metrics}.py and the batcher's
`kv_stats()`/`usage`) against the JAX package's.

- The ledgers (dense and paged), the headroom models and the usage log
  give the JAX classes' numbers, gauges and counters on the same inputs,
  and the hand-computed ones of `tests/test_capacity.py`; a byte knob the
  port cannot read raises.
- In the batcher: the pad-ladder cells of real admission waves;
  `kv/used_bytes` equal to the bytes of the live cache cells counted
  from the tensors (fp and int8, dense and paged: the scale planes are
  priced); headroom under ``TFDE_CAPACITY_BUDGET_BYTES`` (int8 buys
  4D / (D + 4) times the fp32 tokens below the free-row cap); usage
  totals equal to solo `generate` runs token for token, the journal
  record for record, and cancels stamped.
"""

import json
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfde_tpu.observability import capacity as jcapacity
from tfde_tpu.observability import metrics as jmetrics
from tfde_tpu_torch.inference import decode as tdecode
from tfde_tpu_torch.inference import server as tserver
from tfde_tpu_torch.models.flax_weights import from_flax_params
from tfde_tpu_torch.models.gpt import gpt_tiny_test
from tfde_tpu_torch.observability import capacity as tcapacity
from tfde_tpu_torch.observability import metrics as tmetrics
from tfde_tpu_torch.testing import live_kv_bytes, one_thread

#: one intra-op torch thread for the module (`testing.one_thread`)
_one_thread = pytest.fixture(autouse=True, scope="module")(one_thread)

PACKAGES = {"jax": (jcapacity, jmetrics), "port": (tcapacity, tmetrics)}


@pytest.fixture(scope="module")
def tm():
    """The port's `gpt_tiny_test` on the JAX model's initial weights."""
    from tfde_tpu.models.gpt import gpt_tiny_test as j_tiny

    params = j_tiny().init(jax.random.key(1),
                           jnp.zeros((1, 8), jnp.int32))["params"]
    model = gpt_tiny_test(device="cpu")
    model.load_state_dict(from_flax_params(jax.tree.map(np.asarray, params)))
    return model


def _both(fn):
    """{package: fn(capacity module, fresh registry)} for both packages."""
    out = {}
    for name, (cap, met) in PACKAGES.items():
        reg = met.Registry()
        out[name] = (fn(cap, reg), reg.scalars())
    return out


# --------------------------------------------------------------------------
# host classes against JAX
# --------------------------------------------------------------------------

def test_ledger_observe_and_pad_waste_match_jax():
    """A 4-row/32-cell slab of 1024 bytes (8 bytes a cell) observed at
    known committed counts, then three admission waves of known buckets:
    every stat, gauge and counter as in JAX and as computed by hand."""
    def drive(cap, reg):
        led = cap.CapacityLedger(4, 32, 1024, registry=reg)
        occ = led.observe(np.asarray([5, 0, 12, 7]), [1, None, 3, 4])
        empty = led.observe(np.zeros(4, np.int64), [None] * 4)
        for kind, bucket, used in (("cold", 8, 5), ("cold", 8, 8),
                                   ("cold", 16, 9), ("warm", 8, 3)):
            led.note_admission(kind, bucket, used)
        hist = reg.get("kv/pad_waste_frac")
        return (led.cell_bytes, led.row_bytes, occ, empty, led.pad_stats(),
                hist.count, hist.sum)

    runs = _both(drive)
    assert runs["port"] == runs["jax"]
    (cell, row, occ, empty, pad, count, total), gauges = runs["port"]
    assert (cell, row) == (8.0, 256.0)
    assert occ["used_cells"] == 24 and occ["used_bytes"] == 24 * 8.0
    assert occ["rows_active"] == 3 and occ["rows_free"] == 1
    assert occ["waste_frac"] == pytest.approx(1.0 - 24 / 128.0)
    assert empty["used_cells"] == 0 and empty["waste_frac"] == 1.0
    assert pad["pad_alloc_tokens"] == 40 and pad["pad_waste_tokens"] == 15
    assert pad["per_bucket"] == {8: {"alloc": 24, "waste": 8},
                                 16: {"alloc": 16, "waste": 7}}
    assert gauges["kv/pad_alloc_tokens/bucket_8"] == 24
    assert count == 4 and total == pytest.approx(3 / 8 + 7 / 16 + 5 / 8)


@pytest.mark.parametrize("budget", [0, 600, 64])
def test_headroom_matches_jax(budget):
    """Budget off (the free rows), binding (600 B: 2 rows, 65 tokens)
    and exhausted (64 B: zero, never negative), dense and paged, as in
    JAX."""
    def drive(cap, reg):
        led = cap.CapacityLedger(4, 32, 1024, registry=reg)
        occ = led.observe(np.asarray([10, 0, 0, 0]), [1, None, None, None])
        dense = cap.CapacityModel(led, budget_bytes=budget,
                                  registry=reg).headroom(occ)
        snap = {"total": 11, "free": 7, "active": 4, "trie_blocks": 1,
                "shared_cells": 4}
        pled = cap.PagedCapacityLedger(3, 40, 12 * 16 * 8, 12, 16,
                                       lambda: snap, registry=reg,
                                       census={"kv_quant_bits": 8})
        pocc = pled.observe(np.asarray([20, 9, 0]), [1, 2, None])
        paged = cap.PagedCapacityModel(pled, budget_bytes=budget,
                                       registry=reg).headroom(pocc)
        return dense, pocc, paged, pled.row_bytes

    runs = _both(drive)
    assert runs["port"] == runs["jax"]
    dense = runs["port"][0][0]
    assert dense == {0: {"headroom_rows": 3, "headroom_tokens": 96},
                     600: {"headroom_rows": 2, "headroom_tokens": 65},
                     64: {"headroom_rows": 0, "headroom_tokens": 0}}[budget]


def test_capacity_knobs(monkeypatch):
    """TFDE_CAPACITY_BUDGET_BYTES and TFDE_CAPACITY_USAGE_LOG_BYTES are
    read at construction, as in JAX; a value the port cannot read
    raises where JAX warns and falls back."""
    led = tcapacity.CapacityLedger(4, 32, 1024,
                                   registry=tmetrics.Registry())
    occ = led.observe(np.asarray([10, 0, 0, 0]), [1, None, None, None])
    monkeypatch.setenv("TFDE_CAPACITY_BUDGET_BYTES", "600")
    model = tcapacity.CapacityModel(led, registry=tmetrics.Registry())
    assert model.budget_bytes == 600
    assert model.headroom(occ)["headroom_rows"] == 2
    for bad in ("lots", "-1"):
        monkeypatch.setenv("TFDE_CAPACITY_BUDGET_BYTES", bad)
        with pytest.raises(ValueError, match="TFDE_CAPACITY_BUDGET_BYTES"):
            tcapacity.CapacityModel(led)
    monkeypatch.setenv("TFDE_CAPACITY_USAGE_LOG_BYTES", "8MB")
    with pytest.raises(ValueError, match="TFDE_CAPACITY_USAGE_LOG_BYTES"):
        tcapacity.UsageLog("unused.jsonl")


def test_usage_log_compacts_as_jax(tmp_path):
    """50 records through a 400-byte log, then a reopen: the port's file
    is byte-equal to the JAX log's, within the bound, newest kept."""
    texts = {}
    for name, (cap, _met) in PACKAGES.items():
        path = str(tmp_path / f"{name}.jsonl")
        log = cap.UsageLog(path, max_bytes=400)
        for i in range(50):
            log.write({"rid": i, "prompt_tokens": 7})
        log.close()
        log = cap.UsageLog(path, max_bytes=400)
        log.write({"rid": 50, "prompt_tokens": 7})
        log.close()
        with open(path) as f:
            texts[name] = f.read()
    assert texts["port"] == texts["jax"]
    recs = [json.loads(ln) for ln in texts["port"].splitlines()]
    assert len(texts["port"]) <= 400 and recs[-1]["rid"] == 50
    assert [r["rid"] for r in recs] == sorted(r["rid"] for r in recs)


def test_resolve_usage_log_spec(tmp_path, monkeypatch):
    monkeypatch.delenv("TFDE_USAGE_LOG", raising=False)
    assert tcapacity.resolve_usage_log(str(tmp_path)) is None
    monkeypatch.setenv("TFDE_USAGE_LOG", "off")
    assert tcapacity.resolve_usage_log(str(tmp_path)) is None
    monkeypatch.setenv("TFDE_USAGE_LOG", "on")
    monkeypatch.setenv("TFDE_PROCESS_ID", "3")
    assert tcapacity.resolve_usage_log(None) is None  # nothing to anchor
    log = tcapacity.resolve_usage_log(str(tmp_path))
    assert log.path == str(tmp_path / "metrics" / "usage_3.jsonl")
    log.close()
    explicit = str(tmp_path / "explicit.jsonl")
    monkeypatch.setenv("TFDE_USAGE_LOG", explicit)
    log = tcapacity.resolve_usage_log(None)
    assert log.path == explicit
    log.close()


def test_usage_meter_residency_and_outcomes():
    """The trapezoid residency over a real resident window, a queue-side
    shed (never admitted: zero residency; the batcher has no shed path
    until admission control is ported), idempotent finish, totals and
    the usage/* counters."""
    reg = tmetrics.Registry()
    meter = tcapacity.UsageMeter(registry=reg)
    meter.begin(1, 10, "interactive")
    meter.admitted(1)
    time.sleep(0.02)
    rec = meter.finish(1, 6)
    assert rec["kv_token_seconds"] == pytest.approx(
        13.0 * rec["resident_s"], rel=1e-3)
    assert (rec["prompt_tokens"], rec["generated_tokens"]) == (10, 6)
    assert rec["outcome"] == "ok" and rec["priority"] == "interactive"
    meter.begin(2, 4, "batch")
    rec = meter.finish(2, 0, outcome="shed")
    assert rec["kv_token_seconds"] == 0.0 and rec["resident_s"] == 0.0
    assert meter.finish(2, 0) is None
    totals = meter.totals()
    assert totals == {"requests": 2, "prompt_tokens": 14,
                      "generated_tokens": 6,
                      "kv_token_seconds": pytest.approx(
                          reg.get("usage/kv_token_seconds").value)}
    got = reg.scalars("usage/")
    for name, want in (("requests", 2), ("requests/interactive", 1),
                       ("requests/batch", 1), ("requests/ok", 1),
                       ("requests/shed", 1), ("prompt_tokens", 14),
                       ("generated_tokens", 6)):
        assert got[f"usage/{name}"] == want


# --------------------------------------------------------------------------
# the batcher
# --------------------------------------------------------------------------

def test_ledger_tracks_batcher_waves(tm):
    """Prompts of 5, 6 and 12 tokens on the default ladder (8, 16, 32,
    64) land in buckets 8, 8 and 16; the slab drains to zero use."""
    srv = tserver.ContinuousBatcher(tm, batch_size=4, max_len=64,
                                    device="cpu")
    rng = np.random.default_rng(0)
    for plen in (5, 6, 12):
        srv.submit(rng.integers(0, 97, plen), 4)
    srv.run()
    p = srv._ledger.pad_stats()
    assert p["pad_alloc_tokens"] == 8 + 8 + 16
    assert p["pad_waste_tokens"] == 3 + 2 + 4
    assert p["per_bucket"] == {8: {"alloc": 16, "waste": 5},
                               16: {"alloc": 16, "waste": 4}}
    s = srv.kv_stats()
    assert s["rows_active"] == 0 and s["used_cells"] == 0
    assert s["headroom_rows"] == 4
    assert s["allocated_bytes"] == srv._ledger.slab_bytes == sum(
        t.numel() * t.element_size() for t in srv._cache.planes().values())


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("kv_quant", ["fp", "int8"])
def test_used_bytes_equal_live_cell_bytes(tm, paged, kv_quant):
    """Mid-flight, after the trie shared a prompt: kv/used_bytes equals
    the bytes of the live cells counted from the tensors (exact: the
    per-cell cost is the cache's own bytes, int8 scale planes included),
    and the gauge is what kv_stats() returned."""
    srv = tserver.ContinuousBatcher(tm, batch_size=3, max_len=64,
                                    paged=paged, prefix_cache=True,
                                    kv_quant=kv_quant, device="cpu")
    shared = np.arange(20, 53) % 97
    for tail, n in (([1, 2], 24), ([3], 20), ([4, 5, 6], 28)):
        srv.submit(np.concatenate([shared, tail]), n)
        if n == 24:
            srv.step()    # the first prompt's blocks enter the trie
    srv.step()            # the other two admit warm
    s = srv.kv_stats()
    assert s["rows_active"] == 3 and s["used_cells"] > 0
    assert any(srv.reused_tokens().values())
    assert s["used_bytes"] == live_kv_bytes(srv)
    reg = tmetrics.default_registry()
    assert reg.get("kv/used_bytes").value == s["used_bytes"]
    assert reg.get("kv/scale_bytes").value == s["kv_scale_bytes"]
    assert (s["kv_scale_bytes"] > 0) == (kv_quant == "int8")
    srv.run()


@pytest.mark.parametrize("paged", [False, True])
def test_int8_headroom_at_a_fixed_budget(tm, monkeypatch, paged):
    """An idle batcher under a budget below its free-row cap: int8 fits
    (4 D) / (D + 4) times the fp32 tokens (D 8 here: 8/3), to within the
    floor of the byte division; the dense rows follow the same ratio's
    floor."""
    d = tm.head_dim
    cell_fp = 2 * tm.depth * tm.kv_heads * d * 4
    monkeypatch.setenv("TFDE_CAPACITY_BUDGET_BYTES", str(8 * 16 * cell_fp))
    kv = {q: tserver.ContinuousBatcher(
        tm, batch_size=8, max_len=64, paged=paged, prefix_cache=False,
        kv_quant=q, device="cpu").kv_stats() for q in ("fp", "int8")}
    ratio = 4 * d / (d + 4)
    fp, q8 = kv["fp"]["headroom_tokens"], kv["int8"]["headroom_tokens"]
    assert fp == 128 < 8 * 64     # below the free rows' cells
    block = 1 if not paged else 16
    assert fp * ratio - block < q8 <= fp * ratio
    assert kv["fp"]["headroom_rows"] == 2
    assert kv["int8"]["headroom_rows"] == int(2 * ratio)


def test_usage_totals_bit_exact_vs_solo_staggered(tm, tmp_path, monkeypatch):
    """Staggered admission on recycled rows: every request's tokens equal
    a solo `generate` run, the usage totals and the JSONL journal count
    exactly those tokens, record for record; a queued and an active
    cancel are stamped 'cancelled' with the tokens delivered so far."""
    monkeypatch.setenv("TFDE_USAGE_LOG", str(tmp_path / "usage.jsonl"))
    reg = tmetrics.default_registry()
    reg.reset("usage/")
    srv = tserver.ContinuousBatcher(tm, kv_quant="fp", batch_size=2,
                                    max_len=48, device="cpu")
    rng = np.random.default_rng(1)
    reqs = [(rng.integers(0, 97, plen), n)
            for plen, n in [(3, 9), (5, 4), (2, 12), (7, 1), (4, 7)]]
    rids = [srv.submit(p, n) for p, n in reqs[:3]]
    done = dict(srv.step())
    rids += [srv.submit(p, n) for p, n in reqs[3:]]
    done.update(srv.run())
    solos = []
    for p, n in reqs:
        toks, lengths = tdecode.generate(tm, p[None], n, device="cpu")
        solos.append(toks[0, p.size:int(lengths[0])].numpy())
    for rid, ref in zip(rids, solos):
        np.testing.assert_array_equal(done[rid], ref)
    totals = srv.usage.totals()
    assert totals["requests"] == len(reqs)
    assert totals["prompt_tokens"] == sum(p.size for p, _ in reqs)
    assert totals["generated_tokens"] == sum(len(s) for s in solos)
    assert totals["kv_token_seconds"] > 0.0
    # cancels: one active (its delivered tokens metered), one queued
    active = srv.submit(reqs[0][0], 20)
    queued = [srv.submit(reqs[1][0], 6) for _ in range(2)]
    srv.step()
    delivered = len(srv._out[srv._req.index(active)])
    assert srv.cancel(queued[1]) and srv.cancel(active)
    srv.run()
    srv.usage.close()
    with open(str(tmp_path / "usage.jsonl")) as f:
        recs = {r["rid"]: r for r in map(json.loads, f)}
    assert set(recs) == set(rids) | {active} | set(queued)
    for rid, ref in zip(rids, solos):
        assert recs[rid]["generated_tokens"] == len(ref)
        assert recs[rid]["outcome"] == "ok"
    assert recs[active]["outcome"] == "cancelled"
    assert recs[active]["generated_tokens"] == delivered > 0
    assert recs[queued[1]]["outcome"] == "cancelled"
    assert recs[queued[1]]["kv_token_seconds"] == 0.0
    assert reg.get("usage/requests/cancelled").value == 2
    assert reg.get("usage/requests/ok").value == len(reqs) + 1
