"""The MoE families through the port's converter and server: transformers
`MixtralForCausalLM` and `Qwen2MoeForCausalLM` (the configs of
`tests/test_convert.py`, built from a config with seeded weights) ->
`models/convert.py` -> artifact -> `serve_gpt --hf-dir`, on the CPU.

The converted port model's logits are held to HF's and to the JAX
conversion's (`mixtral_from_hf`/`qwen2moe_from_hf` of `tfde_tpu`) within
2e-4 max abs (fp32, as `tests/test_convert.py` holds JAX to HF); both pin
the dropless capacity E / k. `save_converted` -> `load_converted` gives
the same logits bit for bit, the JAX `load_converted` reads the port's
artifact, and the CLI converts a `save_pretrained` directory. `serve_gpt
--hf-dir ... --device cpu` gives HF's greedy tokens and the port's
`generate` tokens for every request. The published MoE widths
(`testing.FULL_WIDTH`: Qwen1.5-MoE-A2.7B, Mixtral-8x7B-v0.1) build on the
meta device with their parameter counts.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

from tfde_tpu.models import convert as jconvert  # noqa: E402
from tfde_tpu_torch import serve_gpt  # noqa: E402
from tfde_tpu_torch.inference.decode import generate  # noqa: E402
from tfde_tpu_torch.models import convert  # noqa: E402
from tfde_tpu_torch.models.gpt import GPT  # noqa: E402
from tfde_tpu_torch.testing import FULL_WIDTH, one_thread  # noqa: E402

#: one intra-op torch thread for the module (`testing.one_thread`)
_one_thread = pytest.fixture(autouse=True, scope="module")(one_thread)

T = transformers
NEW = 6
#: logits against HF and the JAX conversion, max abs (fp32)
TOL = 2e-4

#: family -> (converter, transformers model and config classes, fields,
#: torch seed): tests/test_convert.py:1016-1025 and :1539-1546
HF = {
    "mixtral": ("mixtral_from_hf", "MixtralForCausalLM", "MixtralConfig",
                dict(vocab_size=101, hidden_size=32, intermediate_size=48,
                     num_hidden_layers=2, num_attention_heads=4,
                     num_key_value_heads=2, num_local_experts=4,
                     num_experts_per_tok=2, max_position_embeddings=64,
                     attention_dropout=0.0, sliding_window=None,
                     tie_word_embeddings=False), 40),
    "qwen2-moe": ("qwen2moe_from_hf", "Qwen2MoeForCausalLM",
                  "Qwen2MoeConfig",
                  dict(vocab_size=101, hidden_size=32, num_attention_heads=4,
                       num_key_value_heads=2, intermediate_size=64,
                       moe_intermediate_size=24,
                       shared_expert_intermediate_size=48, num_experts=4,
                       num_experts_per_tok=2, num_hidden_layers=2,
                       decoder_sparse_step=1, max_position_embeddings=64,
                       attention_dropout=0.0, tie_word_embeddings=False), 90),
}


@pytest.fixture(scope="module")
def hf_models():
    out = {}
    for family, (_fn, model_cls, config_cls, fields, seed) in HF.items():
        torch.manual_seed(seed)
        out[family] = getattr(T, model_cls)(
            getattr(T, config_cls)(**fields)).eval()
    return out


def _ids(seed, shape):
    return np.random.default_rng(seed).integers(0, 101, shape)


@pytest.mark.parametrize("family", sorted(HF))
def test_logits_match_hf_and_the_jax_conversion(hf_models, family):
    hf = hf_models[family]
    fn = HF[family][0]
    model, state = getattr(convert, fn)(hf, dtype=torch.float32,
                                        device="cpu")
    cfg = hf.config
    e = cfg.num_local_experts if family == "mixtral" else cfg.num_experts
    assert model.config["num_experts"] == e
    assert model.config["moe_every"] == 1
    assert model.config["moe_capacity_factor"] == pytest.approx(
        e / cfg.num_experts_per_tok)
    assert all(b.moe is not None for b in model.decoder.blocks())
    if family == "qwen2-moe":
        assert not model.config["moe_normalize_topk"]
        assert model.config["moe_shared_expert_dim"] == 48
        assert "decoder.block_0.moe.shared_expert_gate.weight" in state
    ids = _ids(0, (2, 12))
    with torch.no_grad():
        got = model(torch.as_tensor(ids)).numpy()
        want_hf = hf(torch.as_tensor(ids)).logits.numpy()
    jm, jparams = getattr(jconvert, fn)(hf, dtype=jnp.float32)
    want_jax = np.asarray(jax.jit(jm.apply)({"params": jparams},
                                   jnp.asarray(ids, jnp.int32)))
    np.testing.assert_allclose(got, want_hf, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got, want_jax, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("family", sorted(HF))
def test_artifact_round_trip_both_packages(hf_models, family, tmp_path):
    hf = hf_models[family]
    model, _ = getattr(convert, HF[family][0])(hf, dtype=torch.float32,
                                               device="cpu")
    out = convert.save_converted(model, str(tmp_path / "artifact"), family)
    with open(f"{out}/model_config.json") as f:
        conf = json.load(f)
    assert conf["family"] == family and conf["moe_every"] == 1
    loaded = convert.load_converted(out, device="cpu")
    assert loaded.dtype == torch.float32
    ids = torch.as_tensor(_ids(1, (2, 10)))
    with torch.no_grad():
        assert torch.equal(loaded(ids), model(ids))
    jm, jparams = jconvert.load_converted(out)
    want = np.asarray(jax.jit(jm.apply)({"params": jparams},
                               jnp.asarray(ids.numpy(), jnp.int32)))
    np.testing.assert_allclose(loaded(ids).detach().numpy(), want,
                               rtol=TOL, atol=TOL)


def test_convert_cli_takes_the_moe_families(hf_models, tmp_path):
    hf = hf_models["mixtral"]
    src, out = str(tmp_path / "hf"), str(tmp_path / "converted")
    hf.save_pretrained(src)
    assert convert._cli(["mixtral", src, out]) == out
    loaded = convert.load_converted(out, dtype=torch.float32, device="cpu")
    ids = torch.as_tensor(_ids(2, (1, 9)))
    with torch.no_grad():
        np.testing.assert_allclose(loaded(ids).numpy(),
                                   hf(ids).logits.numpy(), rtol=TOL,
                                   atol=TOL)
    assert "qwen2-moe" in convert._FAMILIES
    assert "mixtral" not in convert._UNPORTED_FAMILIES


def _serve_prompts(seed, n, vocab):
    """The prompts `serve_gpt.main` submits (its module docstring)."""
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, int(rng.integers(2, 9))) for _ in range(n)]


@pytest.mark.parametrize("family", sorted(HF))
def test_serve_gpt_hf_dir_gives_hf_greedy_tokens(hf_models, family,
                                                 tmp_path):
    hf = hf_models[family]
    model, _ = getattr(convert, HF[family][0])(hf, dtype=torch.float32,
                                               device="cpu")
    out = convert.save_converted(model, str(tmp_path / "artifact"), family)
    done = dict(serve_gpt.main([
        "--hf-dir", out, "--device", "cpu", "--requests", "3",
        "--batch-size", "2", "--max-new-tokens", str(NEW), "--max-len",
        "24", "--seed", "7"]))
    loaded = convert.load_converted(out, device="cpu")
    prompts = _serve_prompts(7, 3, 101)
    assert sorted(done) == list(range(len(prompts)))
    for rid, prompt in enumerate(prompts):
        ids = torch.as_tensor(prompt)[None]
        with torch.no_grad():
            want = hf.generate(ids, attention_mask=torch.ones_like(ids),
                               max_new_tokens=NEW, do_sample=False,
                               eos_token_id=None, pad_token_id=0)
        np.testing.assert_array_equal(done[rid], want[0, prompt.size:])
        toks, _ = generate(loaded, prompt[None], NEW, device="cpu")
        np.testing.assert_array_equal(done[rid], toks[0, prompt.size:])


class _OnMeta(torch.overrides.TorchFunctionMode):
    """Every tensor a factory makes lands on the meta device whatever
    device it names: a full-width model's shapes without its storage."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if kwargs.get("device") is not None:
            kwargs = {**kwargs, "device": "meta"}
        return func(*args, **kwargs)


@pytest.mark.parametrize("name,count,experts", [
    ("Qwen1.5-MoE-A2.7B", 14_315_784_192, 519_045_120),
    ("Mixtral-8x7B-v0.1", 46_702_792_704, 1_409_286_144)])
def test_full_width_moe_parameter_counts(name, count, experts):
    family, fields = FULL_WIDTH[name]
    assert family in convert._FAMILIES
    with _OnMeta():
        model = GPT(**fields, device="cpu")
    assert model.wte.weight.is_meta
    assert sum(p.numel() for p in model.parameters()) == count
    moe = model.decoder.block_0.moe
    assert sum(w.numel() for w in moe.expert_weights()) == experts
