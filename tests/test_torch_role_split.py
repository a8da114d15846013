"""The port's prefill/decode role split (`ContinuousBatcher(role=)`,
`prime`, `submit_primed`, the 'primed' admission groups, the K/V landing
in `decode.KVCache.land_planes` / `PagedKVCache.land_blocks`) and its wire
format (tfde_tpu_torch/inference/router.py) against the JAX package
(`tests/test_server.py::test_role_split_primed_handoff_parity`).

On `gpt_tiny_test`'s weights shared by `from_flax_params`, for the dense
and the paged layout, full precision and int8 KV:

- JAX `prime()` and port `prime()` on the same prompt give the same first
  token, the same plane names (the port's `(layer, plane)` under the
  wire's leaf paths) and planes within PLANE_TOL (fp32); int8 payloads
  bit-equal, their scales within PLANE_TOL;
- JAX payloads through JAX `primed_to_json` and the port's
  `primed_from_json` into a port decode-role batcher, mixed in one wave
  with a plain `submit`, give the JAX decode replica's greedy tokens, and
  port payloads through the port's `primed_to_json` and JAX's
  `primed_from_json` into a JAX decode replica give them too (exact);
- the shipped planes equal, bit for bit, the slab rows a solo cold
  admission of the same prompt writes (the same one-row program);
- the role guards raise RuntimeError in both packages; a payload of
  another layout raises ValueError at `submit_primed`; bf16 planes cross
  the wire both ways bit for bit; an unknown dtype or leaf raises.
"""

import json

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from tfde_tpu.inference import router as jrouter
from tfde_tpu.inference import server as jserver
from tfde_tpu.models.gpt import gpt_tiny_test as j_tiny
from tfde_tpu_torch.inference import router as trouter
from tfde_tpu_torch.inference import server as tserver
from tfde_tpu_torch.models.flax_weights import from_flax_params
from tfde_tpu_torch.models.gpt import gpt_tiny_test
from tfde_tpu_torch.testing import one_thread

#: one intra-op torch thread for the module (`testing.one_thread`)
_one_thread = pytest.fixture(autouse=True, scope="module")(one_thread)

#: tests/test_server.py's hand-off: three primed prompts and one plain
#: one through a four-row decode replica, 8 new tokens each; the 19-token
#: prompt spans a whole 16-token block
PROMPTS = [np.asarray([12, 80, 3]), np.asarray([44, 7, 61, 2, 19, 88, 30]),
           np.arange(40, 59) % 97, np.asarray([9, 71, 25, 50])]
NEW = 8
#: the planes of the two packages' prefills: the same fp32 K/V from
#: matmuls ordered otherwise (measured ~1e-7)
PLANE_TOL = 1e-5
#: (paged, kv_quant) of each layout
LAYOUTS = {"dense": (False, "fp"), "paged": (True, "fp"),
           "dense_int8": (False, "int8"), "paged_int8": (True, "int8")}


@pytest.fixture(scope="module")
def lm():
    jm = j_tiny()
    params = jm.init(jax.random.key(1), jnp.zeros((1, 8), jnp.int32))["params"]
    tm = gpt_tiny_test(device="cpu")
    tm.load_state_dict(from_flax_params(jax.tree.map(np.asarray, params)))
    return jm, params, tm


def _jax(lm, paged, kvq, **kw):
    jm, params, _ = lm
    return jserver.ContinuousBatcher(jm, params, kv_quant=kvq, paged=paged,
                                     max_len=64, **kw)


def _port(lm, paged, kvq, **kw):
    return tserver.ContinuousBatcher(lm[2], kv_quant=kvq, paged=paged,
                                     max_len=64, device="cpu", **kw)


def _decode(srv, primed, plain):
    """Primed requests and one plain submit through a decode replica:
    every request's tokens, in order, and the host accounting (dispatches
    and syncs in the JAX units: a primed wave is its scatter, with no
    fetch)."""
    rids = [srv.submit_primed(p) for p in primed] + [srv.submit(plain, NEW)]
    done = dict(srv.run())
    stats = {k: srv.stats()[k]
             for k in ("rounds", "generated", "dispatches", "syncs")}
    return [[int(t) for t in done[r]] for r in rids], stats


@pytest.fixture(scope="module")
def jax_runs(lm):
    """Each layout's JAX hand-off: the primed payloads and the decode
    replica's tokens."""
    out = {}
    for name, (paged, kvq) in LAYOUTS.items():
        pre = _jax(lm, paged, kvq, batch_size=1, role="prefill")
        primed = [pre.prime(p, NEW) for p in PROMPTS[:3]]
        dec = _jax(lm, paged, kvq, batch_size=4, role="decode")
        out[name] = (primed, _decode(dec, primed, PROMPTS[3]))
    return out


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_prime_matches_jax(lm, jax_runs, layout):
    paged, kvq = LAYOUTS[layout]
    pre = _port(lm, paged, kvq, batch_size=1, role="prefill")
    for prompt, want in zip(PROMPTS[:3], jax_runs[layout][0]):
        got = pre.prime(prompt, NEW)
        assert got.first_token == want.first_token
        assert got.max_new_tokens == want.max_new_tokens
        assert list(got.prompt) == list(want.prompt)
        assert {trouter.leaf_name(n) for n in got.kv} == set(want.kv)
        for name, t in got.kv.items():
            w = np.asarray(want.kv[trouter.leaf_name(name)])
            assert t.shape == w.shape and t.device.type == "cpu"
            if name[1] in ("k", "v") and kvq == "int8":
                assert t.dtype == torch.int8
                np.testing.assert_array_equal(t.numpy(), w)
            else:
                assert t.dtype == torch.float32
                np.testing.assert_allclose(t.numpy(), w, rtol=0,
                                           atol=PLANE_TOL)
    assert pre.stats()["syncs"] == 3  # one fetch a prime


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_handoff_across_packages(lm, jax_runs, layout):
    """JAX payloads decode on the port, port payloads on JAX, both mixed
    in one wave with a plain submit: the JAX replica's tokens and host
    accounting."""
    paged, kvq = LAYOUTS[layout]
    jprimed, want = jax_runs[layout]
    wire = [json.loads(json.dumps(jrouter.primed_to_json(p)))
            for p in jprimed]
    dec = _port(lm, paged, kvq, batch_size=4, role="decode")
    assert _decode(dec, [trouter.primed_from_json(w) for w in wire],
                   PROMPTS[3]) == want
    # two primed buckets (8 and 32 cells) and the plain request's wave
    waves = dec.wave_counts()
    assert waves["primed"] == 2 and waves["paged" if paged else "cold"] == 1
    pre = _port(lm, paged, kvq, batch_size=1, role="prefill")
    tprimed = [pre.prime(p, NEW) for p in PROMPTS[:3]]
    jdec = _jax(lm, paged, kvq, batch_size=4, role="decode")
    back = [jrouter.primed_from_json(json.loads(json.dumps(
        trouter.primed_to_json(p)))) for p in tprimed]
    assert _decode(jdec, back, PROMPTS[3]) == want


@pytest.mark.parametrize("layout", ["dense", "dense_int8"])
def test_shipped_planes_equal_solo_admission(lm, layout):
    """`prime()` and a solo cold admission run the same one-row program
    at the same bucket: the shipped planes equal the slab row bit for
    bit, and the primed request decodes the solo tokens."""
    paged, kvq = LAYOUTS[layout]
    both = _port(lm, paged, kvq, batch_size=1, role="both")
    for prompt in PROMPTS:
        primed = both.prime(prompt, NEW)
        solo = _port(lm, paged, kvq, batch_size=1)
        rid = solo.submit(prompt, NEW)
        solo.step()
        row = solo._req.index(rid)
        for name, t in primed.kv.items():
            assert torch.equal(t, solo._cache.planes()[name][row,
                                                             :prompt.size])
        want = list(dict(solo.run())[rid])
        rid = both.submit_primed(primed)
        assert list(dict(both.run())[rid]) == want


def test_role_guards_and_layout_refusals(lm):
    """Each half of the split refuses the other's entry point in both
    packages; a bad role is a ValueError; a payload of another layout is
    refused at submit."""
    for make in (_jax, _port):
        pre = make(lm, False, "fp", batch_size=1, role="prefill")
        dec = make(lm, False, "fp", batch_size=2, role="decode")
        with pytest.raises(RuntimeError):
            pre.submit(PROMPTS[0], 4)
        with pytest.raises(RuntimeError):
            dec.prime(PROMPTS[0], 4)
        primed = pre.prime(PROMPTS[0], 4)
        with pytest.raises(RuntimeError):
            pre.submit_primed(primed)
        with pytest.raises(ValueError, match="role"):
            make(lm, False, "fp", batch_size=1, role="bogus")
    fp = _port(lm, False, "fp", batch_size=1, role="prefill").prime(
        PROMPTS[1], 4)
    q8 = _port(lm, False, "int8", batch_size=1, role="prefill").prime(
        PROMPTS[1], 4)
    for kvq, payload in (("int8", fp), ("fp", q8)):
        for paged in (False, True):
            dec = _port(lm, paged, kvq, batch_size=2, role="decode")
            with pytest.raises(ValueError, match="planes"):
                dec.submit_primed(payload)
            assert dec.idle and dec._next_id == 0
    bare = tserver.PrimedRequest(
        q8.prompt, q8.first_token, 4,
        {n: t for n, t in q8.kv.items() if n[1] in ("k", "v")})
    dec = _port(lm, False, "int8", batch_size=2, role="decode")
    with pytest.raises(ValueError, match="missing"):
        dec.submit_primed(bare)
    short = tserver.PrimedRequest(fp.prompt, fp.first_token, 4,
                                  {n: t[:-1] for n, t in fp.kv.items()})
    with pytest.raises(ValueError, match="cells"):
        _port(lm, False, "fp", batch_size=2, role="decode").submit_primed(
            short)


def test_wire_bf16_and_refusals():
    """bf16 planes cross the wire bit for bit both ways (the port carries
    the raw 16-bit words, JAX reads them through ml_dtypes); an unknown
    dtype or leaf path raises."""
    rng = np.random.default_rng(3)
    planes = {(0, "k"): rng.standard_normal((5, 2, 4)),
              (0, "v"): rng.standard_normal((5, 2, 4)),
              (1, "k"): rng.standard_normal((5, 2, 4)) * 1e4,
              (1, "v"): rng.standard_normal((5, 2, 4)) * 1e-4}
    tplanes = {n: torch.as_tensor(a, dtype=torch.bfloat16)
               for n, a in planes.items()}
    tp = tserver.PrimedRequest(np.arange(5), 7, 3, tplanes)
    back = jrouter.primed_from_json(json.loads(json.dumps(
        trouter.primed_to_json(tp))))
    for n, t in tplanes.items():
        a = back.kv[trouter.leaf_name(n)]
        assert a.dtype == ml_dtypes.bfloat16
        np.testing.assert_array_equal(a.view(np.int16),
                                      t.view(torch.int16).numpy())
    jp = jserver.PrimedRequest(
        np.arange(5, dtype=np.int32), 7, 3,
        {trouter.leaf_name(n): a.astype(ml_dtypes.bfloat16)
         for n, a in planes.items()})
    got = trouter.primed_from_json(json.loads(json.dumps(
        jrouter.primed_to_json(jp))))
    assert (got.first_token, got.max_new_tokens) == (7, 3)
    assert list(got.prompt) == list(range(5))
    for n, t in got.kv.items():
        assert t.dtype == torch.bfloat16
        np.testing.assert_array_equal(
            t.view(torch.int16).numpy(),
            jp.kv[trouter.leaf_name(n)].view(np.int16))
    wire = trouter.primed_to_json(tp)
    bad = dict(wire, kv={**wire["kv"]})
    bad["kv"]["decoder/block_0/attn/cached_key"] = dict(
        wire["kv"]["decoder/block_0/attn/cached_key"], dtype="float64")
    with pytest.raises(ValueError, match="dtype"):
        trouter.primed_from_json(bad)
    bad = dict(wire, kv={"decoder/block_0/mlp/cached_key":
                         wire["kv"]["decoder/block_0/attn/cached_key"]})
    with pytest.raises(ValueError, match="leaf"):
        trouter.primed_from_json(bad)
    with pytest.raises(ValueError, match="plane"):
        trouter.leaf_name((0, "q"))


def test_prime_and_primed_trace_events_match_jax(lm):
    """`prime(trace=)` records ``serve/prime`` and a primed submit's
    trace reads queued (primed) -> prefill_primed -> first token ->
    rounds -> done, with the JAX package's names in both halves."""
    from tfde_tpu.observability import trace as jtrace
    from tfde_tpu_torch.observability import trace as ttrace

    names = []
    for pkg, make in ((jtrace, _jax), (ttrace, _port)):
        pre = make(lm, False, "fp", batch_size=1, role="prefill")
        dec = make(lm, False, "fp", batch_size=2, role="decode")
        pkg.enable()
        try:
            primed = pre.prime(PROMPTS[1], NEW, trace="h")
            dec.submit_primed(primed, trace="h")
            dec.run()
            evs = [e for e in pkg.events("h")
                   if not e["name"].startswith("compile/")]
        finally:
            pkg.disable()
        names.append([e["name"] for e in evs])
        assert evs[0]["prompt_tokens"] == PROMPTS[1].size
        assert evs[1]["primed"] is True
    assert names[1] == names[0]
    assert names[1][:3] == ["serve/prime", "serve/queued",
                            "serve/prefill_primed"]
    assert names[1][-1] in ("serve/done", "serve/decode_round")
