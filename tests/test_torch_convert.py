"""The port's checkpoint conversion (tfde_tpu_torch/models/convert.py)
against transformers and against the JAX package's converter.

Tiny randomly initialised transformers models of the thirteen dense
families (the configs of `tests/test_convert.py`, copied) are the oracle:
the port's `*_from_hf` model must give HF's logits within that file's
tolerance for the family (2e-4; 5e-3 where HF runs the erf gelu and the
port, like JAX, the tanh one), hold the very flax tree JAX's converter
builds (bit for bit, through `to_flax_params`), and give JAX's logits
within 1e-5 relative Frobenius. Every refusal of the JAX converters
raises here too, with its wording. Artifacts cross between the packages
both ways with equal logits, and the forward CLI converts a local
`save_pretrained` directory. fp32 on the CPU throughout.
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

transformers = pytest.importorskip("transformers")
torch = pytest.importorskip("torch")

from tfde_tpu.models import convert as jconvert  # noqa: E402
from tfde_tpu_torch.models import convert  # noqa: E402
from tfde_tpu_torch.models.flax_weights import to_flax_params  # noqa: E402
from tfde_tpu_torch.testing import one_thread

#: one intra-op torch thread for the module (`testing.one_thread`)
_one_thread = pytest.fixture(autouse=True, scope="module")(one_thread)

T = transformers
V = 101


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _leaves(tree, prefix=()):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _leaves(value, prefix + (key,))
        else:
            yield prefix + (key,), np.asarray(value)


def _assert_same_tree(got, want):
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert got.keys() == want.keys()
    for path, value in want.items():
        np.testing.assert_array_equal(got[path], value, err_msg=str(path))


#: family case -> (converter name, transformers model class, config
#: class, config fields, seed, HF logits tolerance)
CASES = {
    "gpt2": ("gpt2_from_hf", "GPT2LMHeadModel", "GPT2Config", dict(
        vocab_size=97, n_positions=64, n_embd=32, n_layer=2, n_head=4,
        resid_pdrop=0.0, embd_pdrop=0.0, attn_pdrop=0.0), 0, 2e-4),
    "llama": ("llama_from_hf", "LlamaForCausalLM", "LlamaConfig", dict(
        vocab_size=V, hidden_size=32, intermediate_size=96,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=64, attention_dropout=0.0,
        tie_word_embeddings=False), 2, 2e-4),
    "mistral": ("mistral_from_hf", "MistralForCausalLM", "MistralConfig",
                dict(vocab_size=V, hidden_size=32, intermediate_size=96,
                     num_hidden_layers=2, num_attention_heads=4,
                     num_key_value_heads=2, max_position_embeddings=64,
                     attention_dropout=0.0, sliding_window=8,
                     tie_word_embeddings=False), 3, 2e-4),
    # head_dim 16 with hidden 32 / 4 heads: the gemma-7b-shaped decoupling
    "gemma": ("gemma_from_hf", "GemmaForCausalLM", "GemmaConfig", dict(
        vocab_size=V, hidden_size=32, intermediate_size=96,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=1,
        head_dim=16, max_position_embeddings=64, attention_dropout=0.0,
        hidden_activation="gelu_pytorch_tanh"), 3, 2e-4),
    "gemma2": ("gemma2_from_hf", "Gemma2ForCausalLM", "Gemma2Config", dict(
        vocab_size=V, hidden_size=32, num_attention_heads=4,
        num_key_value_heads=2, head_dim=8, intermediate_size=64,
        num_hidden_layers=2, max_position_embeddings=64, sliding_window=8,
        attention_dropout=0.0), 80, 2e-4),
    "qwen2": ("qwen2_from_hf", "Qwen2ForCausalLM", "Qwen2Config", dict(
        vocab_size=V, hidden_size=32, intermediate_size=96,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=64, attention_dropout=0.0,
        tie_word_embeddings=False, use_sliding_window=False), 4, 2e-4),
    "qwen3": ("qwen3_from_hf", "Qwen3ForCausalLM", "Qwen3Config", dict(
        vocab_size=V, hidden_size=32, intermediate_size=96,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        head_dim=16, max_position_embeddings=64, attention_dropout=0.0,
        tie_word_embeddings=False), 60, 2e-4),
    "phi": ("phi_from_hf", "PhiForCausalLM", "PhiConfig", dict(
        vocab_size=V, hidden_size=32, intermediate_size=96,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=4,
        max_position_embeddings=64, partial_rotary_factor=0.5,
        attention_dropout=0.0, embd_pdrop=0.0, resid_pdrop=0.0), 7, 2e-4),
    "phi3": ("phi3_from_hf", "Phi3ForCausalLM", "Phi3Config", dict(
        vocab_size=V, hidden_size=32, num_attention_heads=4,
        num_key_value_heads=2, intermediate_size=64, num_hidden_layers=2,
        max_position_embeddings=64, pad_token_id=0, attention_dropout=0.0,
        resid_pdrop=0.0, embd_pdrop=0.0, sliding_window=None), 70, 2e-4),
    "neox": ("neox_from_hf", "GPTNeoXForCausalLM", "GPTNeoXConfig", dict(
        vocab_size=V, hidden_size=32, intermediate_size=96,
        num_hidden_layers=2, num_attention_heads=4,
        max_position_embeddings=64, rotary_pct=0.5,
        use_parallel_residual=True, attention_dropout=0.0,
        hidden_dropout=0.0), 8, 5e-3),
    "bigcode": ("bigcode_from_hf", "GPTBigCodeForCausalLM",
                "GPTBigCodeConfig", dict(
                    vocab_size=V, n_embd=32, n_layer=2, n_head=4,
                    n_positions=64, multi_query=True, attn_pdrop=0.0,
                    embd_pdrop=0.0, resid_pdrop=0.0), 10, 2e-4),
    "opt": ("opt_from_hf", "OPTForCausalLM", "OPTConfig", dict(
        vocab_size=V, hidden_size=32, ffn_dim=96, num_hidden_layers=2,
        num_attention_heads=4, max_position_embeddings=64,
        word_embed_proj_dim=32, do_layer_norm_before=True,
        attention_dropout=0.0, dropout=0.0), 12, 2e-4),
    # the 40B shape (grouped KV, two parallel norms) and the 7B shape
    # (one KV head, one parallel norm)
    "falcon_40b": ("falcon_from_hf", "FalconForCausalLM", "FalconConfig",
                   dict(vocab_size=V, hidden_size=32, num_hidden_layers=2,
                        num_attention_heads=4, num_kv_heads=2,
                        new_decoder_architecture=True, multi_query=True,
                        parallel_attn=True, alibi=False, bias=False,
                        max_position_embeddings=64, hidden_dropout=0.0,
                        attention_dropout=0.0), 31, 5e-3),
    "falcon_7b": ("falcon_from_hf", "FalconForCausalLM", "FalconConfig",
                  dict(vocab_size=V, hidden_size=32, num_hidden_layers=2,
                       num_attention_heads=4, num_kv_heads=None,
                       new_decoder_architecture=False, multi_query=True,
                       parallel_attn=True, alibi=False, bias=False,
                       max_position_embeddings=64, hidden_dropout=0.0,
                       attention_dropout=0.0), 30, 5e-3),
}


@functools.lru_cache(maxsize=None)
def _hf(case):
    _fn, model_cls, config_cls, fields, seed, _tol = CASES[case]
    torch.manual_seed(seed)
    model = getattr(T, model_cls)(getattr(T, config_cls)(**fields))
    return model.eval()


def _hf_logits(hf, ids):
    with torch.no_grad():
        return hf(torch.as_tensor(ids)).logits.numpy()


@pytest.mark.parametrize("case", sorted(CASES))
def test_family_matches_transformers_and_jax(case):
    fn, *_, tol = CASES[case]
    hf = _hf(case)
    vocab = hf.config.vocab_size
    ids = np.random.default_rng(1).integers(0, vocab, (2, 16))
    model, state = getattr(convert, fn)(hf, dtype=torch.float32,
                                        device="cpu")
    assert model.device == torch.device("cpu")
    assert state.keys() == model.state_dict().keys()
    with torch.no_grad():
        got = model(torch.as_tensor(ids)).numpy()
    np.testing.assert_allclose(got, _hf_logits(hf, ids), rtol=tol, atol=tol)
    jm, jparams = getattr(jconvert, fn)(hf, dtype=jnp.float32)
    _assert_same_tree(to_flax_params(model), jparams)
    want = jax.jit(jm.apply)({"params": jparams}, jnp.asarray(ids))
    assert _rel(got, want) <= 1e-5


def _refusal(config_cls, model_cls, fields):
    torch.manual_seed(0)
    return getattr(T, model_cls)(getattr(T, config_cls)(**fields))


@pytest.mark.parametrize("fn,config_cls,model_cls,fields,match", [
    ("gemma_from_hf", "GemmaConfig", "GemmaForCausalLM", dict(
        vocab_size=51, hidden_size=16, intermediate_size=32,
        num_hidden_layers=1, num_attention_heads=2, num_key_value_heads=1,
        head_dim=8, max_position_embeddings=32,
        hidden_activation="gelu_pytorch_tanh", tie_word_embeddings=False),
     "untied"),
    ("qwen2_from_hf", "Qwen2Config", "Qwen2ForCausalLM", dict(
        vocab_size=51, hidden_size=16, intermediate_size=32,
        num_hidden_layers=2, num_attention_heads=2, num_key_value_heads=1,
        max_position_embeddings=32, use_sliding_window=True,
        sliding_window=16, max_window_layers=1), "use_sliding_window"),
    ("opt_from_hf", "OPTConfig", "OPTForCausalLM", dict(
        vocab_size=53, hidden_size=16, ffn_dim=32, num_hidden_layers=1,
        num_attention_heads=2, max_position_embeddings=32,
        word_embed_proj_dim=8), "word_embed_proj_dim"),
    ("falcon_from_hf", "FalconConfig", "FalconForCausalLM", dict(
        vocab_size=53, hidden_size=16, num_hidden_layers=1,
        num_attention_heads=2, alibi=True, bias=True, multi_query=False,
        new_decoder_architecture=False), "alibi"),
    ("falcon_from_hf", "FalconConfig", "FalconForCausalLM", dict(
        vocab_size=53, hidden_size=16, num_hidden_layers=1,
        num_attention_heads=2, alibi=False, bias=False,
        rope_scaling={"rope_type": "linear", "factor": 2.0}),
     "rope_scaling"),
    ("phi3_from_hf", "Phi3Config", "Phi3ForCausalLM", dict(
        vocab_size=53, hidden_size=16, num_attention_heads=2,
        num_key_value_heads=1, intermediate_size=32, num_hidden_layers=1,
        max_position_embeddings=64, original_max_position_embeddings=32,
        pad_token_id=0, rope_scaling={"type": "longrope",
                                      "short_factor": [1.0] * 4,
                                      "long_factor": [2.0] * 4}),
     "longrope"),
])
def test_refusals_keep_the_jax_wording(fn, config_cls, model_cls, fields,
                                       match):
    hf = _refusal(config_cls, model_cls, fields)
    with pytest.raises(NotImplementedError, match=match) as port:
        getattr(convert, fn)(hf, dtype=torch.float32, device="cpu")
    with pytest.raises(NotImplementedError, match=match) as jax_side:
        getattr(jconvert, fn)(hf, dtype=jnp.float32)
    assert str(port.value) == str(jax_side.value)


def test_rope_scaling_helpers():
    for rs in ({"rope_type": "linear", "factor": 4.0},
               {"rope_type": "llama3", "factor": 8.0,
                "low_freq_factor": 1.0, "high_freq_factor": 4.0,
                "original_max_position_embeddings": 32},
               {"rope_type": "yarn", "factor": 4.0,
                "original_max_position_embeddings": 32}):
        got = convert._rope_scaling_tuple(rs, max_position=128)
        assert got == jconvert._rope_scaling_tuple(rs, max_position=128)
        back = convert._rope_scaling_dict(got)
        assert back == jconvert._rope_scaling_dict(got)
        assert convert._rope_scaling_tuple(back) == got
    assert convert._rope_scaling_tuple(None) is None
    assert convert._rope_scaling_tuple({"rope_type": "default"}) is None
    with pytest.raises(NotImplementedError, match="longrope"):
        convert._rope_scaling_tuple({"rope_type": "longrope", "factor": 4.0})
    with pytest.raises(NotImplementedError, match="max_position"):
        convert._rope_scaling_tuple({"rope_type": "yarn", "factor": 4.0})


# ------------------------------------------------------------ artifacts --

@pytest.mark.parametrize("case,family", [("gemma2", "gemma2"),
                                         ("qwen3", "qwen3"), ("phi", "phi")])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_artifacts_cross_between_the_packages(tmp_path, case, family,
                                              writer):
    """An artifact written by either package loads into the other with
    the same parameters, bit for bit, and the same logits."""
    fn = CASES[case][0]
    hf = _hf(case)
    ids = np.random.default_rng(2).integers(0, V, (2, 12))
    out = str(tmp_path / "artifact")
    if writer == "jax":
        jm, jparams = getattr(jconvert, fn)(hf, dtype=jnp.float32)
        jconvert.save_converted(jm, jparams, out, family)
        model = convert.load_converted(out, device="cpu")
    else:
        model, _ = getattr(convert, fn)(hf, dtype=torch.float32,
                                        device="cpu")
        convert.save_converted(model, out, family)
        jm, jparams = jconvert.load_converted(out)
        model = convert.load_converted(out, device="cpu")
    assert model.dtype == torch.float32 and jm.dtype == jnp.float32
    _assert_same_tree(to_flax_params(model), jparams)
    with torch.no_grad():
        got = model(torch.as_tensor(ids)).numpy()
    want = jax.jit(jm.apply)({"params": jparams}, jnp.asarray(ids))
    assert _rel(got, want) <= 1e-5


def test_artifact_config_and_unported_families(tmp_path):
    model, _ = convert.llama_from_hf(_hf("llama"), device="cpu")
    out = str(tmp_path / "artifact")
    convert.save_converted(model, out, "llama")
    with open(f"{out}/model_config.json") as f:
        conf = json.load(f)
    assert conf["family"] == "llama" and conf["dtype"] == "bfloat16"
    assert conf["norm"] == "rms" and conf["kv_block"] == 16
    assert convert.load_converted(out, device="cpu").dtype == torch.bfloat16
    with pytest.raises(ValueError, match="unknown family"):
        convert.save_converted(model, str(tmp_path / "bad"), "nope")
    # a JAX-only serving field is dropped, a non-default unported one
    # raises, an unknown name is a TypeError, an unported family raises
    for edit, error, match in (
            ({"decode": True}, None, None),
            ({"quant": "int8"}, NotImplementedError, "quant"),
            ({"bogus": 1}, TypeError, "bogus"),
            ({"family": "bert"}, NotImplementedError, "bert")):
        with open(f"{out}/model_config.json", "w") as f:
            json.dump({**conf, **edit}, f)
        if error is None:
            convert.load_converted(out, device="cpu")
        else:
            with pytest.raises(error, match=match):
                convert.load_converted(out, device="cpu")


def test_convert_cli(tmp_path):
    """The offline CLI: a save_pretrained directory -> params.npz +
    model_config.json, which rebuilds the model with HF's logits."""
    hf = _hf("llama")
    src, out = str(tmp_path / "hf"), str(tmp_path / "converted")
    hf.save_pretrained(src)
    assert convert._cli(["llama", src, out]) == out
    with open(f"{out}/model_config.json") as f:
        assert json.load(f)["family"] == "llama"
    model = convert.load_converted(out, dtype=torch.float32, device="cpu")
    ids = np.random.default_rng(3).integers(0, V, (1, 10))
    with torch.no_grad():
        got = model(torch.as_tensor(ids)).numpy()
    np.testing.assert_allclose(got, _hf_logits(hf, ids), rtol=2e-4,
                               atol=2e-4)
    with pytest.raises(SystemExit, match="not a directory"):
        convert._cli(["llama", str(tmp_path / "missing"), out])
    with pytest.raises(SystemExit, match="not ported"):
        convert._cli(["t5", src, out])
