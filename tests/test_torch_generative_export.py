"""The flash kernels as `torch.library` custom ops, and generative export,
held against the JAX package.

- The three ops (`tfde::flash_forward`, `tfde::flash_bwd_dkv`,
  `tfde::flash_bwd_dq`): `torch.library.opcheck` of each on its CPU
  implementation (the plain version: schema, fake implementation against
  the real outputs, autograd registration), the fake implementations'
  shapes under `FakeTensorMode`, and a module calling `flash_attention`
  exported with `torch.export`: the op is a node of the program, which
  computes the eager outputs.
- `export_serving` of a GPT whose attention takes the flash op records it
  and serves the live model's outputs.
- `decode.gumbel_noise`: a pure function of (seed, step, row, token), and
  its Gumbel-max draws follow the softmax.
- `export_generate` -> `load_generate` on the JAX tiny GPT's weights: the
  greedy artifact's tokens equal the JAX `generate`'s and the port's
  in-process `generate`'s; a sampled artifact's tokens equal in-process
  `generate(seed=...)` for one seed and differ for another.
- `gpt_lm --generate N --export-generate DIR --device cpu --tiny`: the
  artifact reproduces the logged tokens; the JAX example's refusals
  raise (`--beams` beam-decodes: tests/test_torch_beam.py).
"""

import json
import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from tfde_tpu.inference.decode import generate as j_generate
from tfde_tpu.models.gpt import gpt_tiny_test as j_tiny
from tfde_tpu_torch import gpt_lm
from tfde_tpu_torch.export import (
    export_generate, export_serving, load_generate, load_serving)
from tfde_tpu_torch.inference.decode import generate, gumbel_noise
from tfde_tpu_torch.models.flax_weights import from_flax_params
from tfde_tpu_torch.models.gpt import gpt_tiny_test
from tfde_tpu_torch.ops import flash_attention as tfa
from tfde_tpu_torch.testing import one_thread

#: one intra-op torch thread for the module (`testing.one_thread`)
_one_thread = pytest.fixture(autouse=True, scope="module")(one_thread)

OPS = {"flash_forward": torch.ops.tfde.flash_forward.default,
       "flash_bwd_dkv": torch.ops.tfde.flash_bwd_dkv.default,
       "flash_bwd_dq": torch.ops.tfde.flash_bwd_dq.default}


def _qkv(seed, s=24, h=4, kv=2, d=16):
    rng = np.random.default_rng(seed)
    return [torch.as_tensor(rng.standard_normal(shape).astype(np.float32))
            for shape in ((2, s, h, d), (2, s, kv, d), (2, s, kv, d),
                          (2, s, h, d))]


def _op_args(name):
    q, k, v, do = _qkv(1)
    opts = (True, 9, 0.2, 20.0)
    if name == "flash_forward":
        return tuple(t.requires_grad_() for t in (q, k, v)) + opts
    out, lse = tfa.flash_forward(q, k, v, *opts)
    return (q, k, v, do, lse, tfa._delta(out, do)) + opts


@pytest.mark.parametrize("name", sorted(OPS))
def test_opcheck_on_the_cpu_implementation(name):
    # the AOT-dispatch check is the export test's below
    result = torch.library.opcheck(
        OPS[name], _op_args(name),
        test_utils=("test_schema", "test_autograd_registration",
                    "test_faketensor"))
    assert set(result.values()) == {"SUCCESS"}, result


def test_fake_implementations_and_export_record_the_op():
    q, k, v, do = _qkv(2)
    with FakeTensorMode() as mode:
        fq, fk, fv, fdo = (mode.from_tensor(t) for t in (q, k, v, do))
        out, lse = OPS["flash_forward"](fq, fk, fv, True, None, 0.25, None)
        assert out.shape == q.shape and out.dtype == q.dtype
        assert lse.shape == (2, 4, 24) and lse.dtype == torch.float32
        delta = fq.new_empty((2, 4, 24))
        dk, dv = OPS["flash_bwd_dkv"](fq, fk, fv, fdo, lse, delta, True,
                                      None, 0.25, None)
        dq = OPS["flash_bwd_dq"](fq, fk, fv, fdo, lse, delta, True, None,
                                 0.25, None)
        assert (dq.shape, dk.shape, dv.shape) == (q.shape, k.shape, v.shape)

    class Attend(torch.nn.Module):
        def forward(self, q, k, v):
            return tfa.flash_attention(q, k, v, causal=True, window=9,
                                       logit_cap=20.0)

    program = torch.export.export(Attend(), (q, k, v), strict=False)
    targets = [n.target for n in program.graph.nodes
               if n.op == "call_function"]
    assert OPS["flash_forward"] in targets
    torch.testing.assert_close(program.module()(q, k, v),
                               Attend()(q, k, v), rtol=0, atol=0)


def test_export_serving_records_the_flash_op(tmp_path):
    model = gpt_tiny_test(device="cpu", seed=3)
    model.set_attn_impl("flash")
    out = export_serving(model, (None, 12), str(tmp_path),
                         input_dtype=torch.int64, apply_softmax=False)
    served = load_serving(out, device="cpu")
    assert OPS["flash_forward"] in [n.target for n in
                                    served.module.graph.nodes]
    ids = np.random.default_rng(4).integers(0, 97, (3, 12))
    with torch.no_grad():
        want = model(torch.as_tensor(ids)).numpy()
    np.testing.assert_allclose(served.predict(ids), want, rtol=0, atol=1e-6)


def test_gumbel_noise_is_a_pure_function_that_samples_the_softmax():
    a = gumbel_noise(7, 3, 2, 50)
    assert a.shape == (2, 50) and a.dtype == torch.float32
    assert torch.equal(a, gumbel_noise(torch.tensor(7), 3, 2, 50))
    for other in (gumbel_noise(8, 3, 2, 50), gumbel_noise(7, 4, 2, 50)):
        assert not torch.equal(a, other)
    assert not torch.equal(a[0], a[1])  # rows draw apart
    logits = torch.tensor([0.0, 1.0, 2.0, 3.0])
    n = 40000
    draws = torch.argmax(logits + gumbel_noise(0, 0, n, 4), dim=-1)
    freq = torch.bincount(draws, minlength=4).double() / n
    # each frequency within 4 standard errors of its probability
    p = torch.softmax(logits.double(), 0)
    assert bool(((freq - p).abs() <= 4 * (p * (1 - p) / n).sqrt()).all())


@pytest.fixture(scope="module")
def pair():
    """The JAX tiny GPT's params, the port's GPT on them, and a prompt."""
    jm = j_tiny()
    params = jm.init(jax.random.key(1), jnp.zeros((1, 8), jnp.int32))["params"]
    tm = gpt_tiny_test(device="cpu")
    tm.load_state_dict(from_flax_params(jax.tree.map(np.asarray, params)))
    prompt = np.random.default_rng(5).integers(0, 97, (2, 5))
    return jm, params, tm, prompt


N = 6


def test_greedy_artifact_equals_jax_and_in_process_generate(pair, tmp_path):
    jm, params, tm, prompt = pair
    out = export_generate(tm, str(tmp_path), prompt_len=5, max_new_tokens=N,
                          batch_size=2)
    with open(os.path.join(out, "signature.json")) as f:
        sig = json.load(f)
    assert sig["kind"] == "generate" and sig["framework"] == "tfde_tpu_torch"
    assert sig["outputs"]["tokens"]["shape"] == [2, 5 + N]
    assert sig["sampling"]["temperature"] == 0.0
    assert sorted(os.listdir(out)) == ["model.pt2", "params.npz",
                                       "signature.json", "step.pt2"]
    art = load_generate(str(tmp_path), device="cpu")
    toks, lens = art.generate(prompt, seed=0)
    want, want_lens = j_generate(jm, params, jnp.asarray(prompt, jnp.int32),
                                 N, temperature=0.0)
    np.testing.assert_array_equal(toks, np.asarray(want))
    np.testing.assert_array_equal(lens, np.asarray(want_lens))
    mine, _ = generate(tm, prompt, N, device="cpu")
    np.testing.assert_array_equal(toks, mine.numpy())
    with pytest.raises(ValueError, match="load_generate"):
        load_serving(out, device="cpu")


def test_sampled_artifact_follows_its_seed(pair, tmp_path):
    _jm, _params, tm, prompt = pair
    sampling = dict(temperature=0.8, top_k=40)
    export_generate(tm, str(tmp_path), prompt_len=5, max_new_tokens=N,
                    batch_size=2, **sampling)
    art = load_generate(str(tmp_path), device="cpu")
    toks = {seed: art.generate(prompt, seed)[0] for seed in (3, 4)}
    want = generate(tm, prompt, N, device="cpu", seed=3, **sampling)[0]
    np.testing.assert_array_equal(toks[3], want.numpy())
    assert not np.array_equal(toks[3], toks[4])
    np.testing.assert_array_equal(toks[3][:, :5], prompt)


def test_gpt_lm_generate_exports_what_it_logs(tmp_path, caplog):
    with caplog.at_level(logging.INFO, logger="gpt_lm"):
        gpt_lm.main(["--tiny", "--device", "cpu", "--max-steps", "1",
                     "--warmup-steps", "0", "--batch-size", "4",
                     "--seq-len", "8", "--train-examples", "16",
                     "--generate", "4", "--export-generate",
                     str(tmp_path)])
    logged = [json.loads(r.getMessage().split(": ", 1)[1])
              for r in caplog.records
              if r.getMessage().startswith("generated: ")]
    assert len(logged) == 2 and all(len(row) == 12 for row in logged)
    toks, lens = load_generate(str(tmp_path), device="cpu").generate(
        np.asarray(logged)[:, :8], seed=2)
    np.testing.assert_array_equal(toks, np.asarray(logged))
    assert lens.tolist() == [12, 12]


@pytest.mark.parametrize("flags,error,match", [
    (["--beams", "2"], ValueError, "--generate N to produce"),
    (["--export-generate", "d"], ValueError, "--generate N to export"),
    (["--generate", "4", "--beams", "2", "--export-generate", "d"],
     ValueError, "beam search is not supported"),
])
def test_gpt_lm_generate_refusals(flags, error, match):
    with pytest.raises(error, match=match):
        gpt_lm.main(["--tiny", "--device", "cpu", *flags])
