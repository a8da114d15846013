"""Serving converted checkpoints on the port: the path convert -> artifact
-> `serve_gpt --hf-dir` -> `ContinuousBatcher`, on the CPU.

`serve_gpt.main(["--hf-dir", d, "--device", "cpu", ...])` over tiny
Llama, Qwen3 and Gemma-2 artifacts (fp32, converted from transformers
models built from a config) must give HF's greedy tokens and the port's
`generate` tokens for every request. The batcher, whose admission
prefill and per-row decode ticks differ from `generate`'s path, is held
to `generate` on each field group of `testing.FIELD_GROUPS` (qk_norm
under rope, the softcaps, the untied head, Phi's padded head dim 80 ...).
An artifact that records `remat` serves through `decode.remat_off`.
"""

import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

from tfde_tpu_torch import serve_gpt  # noqa: E402
from tfde_tpu_torch.inference.decode import generate  # noqa: E402
from tfde_tpu_torch.inference.server import ContinuousBatcher  # noqa: E402
from tfde_tpu_torch.models import convert  # noqa: E402
from tfde_tpu_torch.models.gpt import GPT  # noqa: E402
from tfde_tpu_torch.testing import FIELD_GROUPS  # noqa: E402
from tfde_tpu_torch.testing import one_thread  # noqa: E402

#: one intra-op torch thread for the module (`testing.one_thread`)
_one_thread = pytest.fixture(autouse=True, scope="module")(one_thread)

T = transformers
NEW = 6

#: family -> (converter, transformers model and config classes, fields)
HF = {
    "llama": ("llama_from_hf", "LlamaForCausalLM", "LlamaConfig", dict(
        vocab_size=101, hidden_size=32, intermediate_size=96,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=64, tie_word_embeddings=False)),
    "qwen3": ("qwen3_from_hf", "Qwen3ForCausalLM", "Qwen3Config", dict(
        vocab_size=101, hidden_size=32, intermediate_size=96,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        head_dim=16, max_position_embeddings=64)),
    # the window of 4 is passed by the prompts and the generated tokens
    "gemma2": ("gemma2_from_hf", "Gemma2ForCausalLM", "Gemma2Config", dict(
        vocab_size=101, hidden_size=32, num_attention_heads=4,
        num_key_value_heads=2, head_dim=8, intermediate_size=64,
        num_hidden_layers=2, max_position_embeddings=64, sliding_window=4,
        attn_logit_softcapping=2.0, final_logit_softcapping=3.0)),
}


def _serve_prompts(seed, n, vocab):
    """The prompts `serve_gpt.main` submits (its module docstring)."""
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, int(rng.integers(2, 9))) for _ in range(n)]


@pytest.mark.parametrize("family", sorted(HF))
def test_serve_gpt_hf_dir_gives_hf_greedy_tokens(tmp_path, family):
    fn, model_cls, config_cls, fields = HF[family]
    torch.manual_seed(5)
    hf = getattr(T, model_cls)(getattr(T, config_cls)(**fields)).eval()
    model, _ = getattr(convert, fn)(hf, dtype=torch.float32, device="cpu")
    out = convert.save_converted(model, str(tmp_path / "artifact"), family)
    done = dict(serve_gpt.main([
        "--hf-dir", out, "--device", "cpu", "--requests", "3",
        "--batch-size", "2", "--max-new-tokens", str(NEW), "--max-len",
        "24", "--seed", "7"]))
    loaded = convert.load_converted(out, device="cpu")
    prompts = _serve_prompts(7, 3, fields["vocab_size"])
    assert sorted(done) == list(range(len(prompts)))
    for rid, prompt in enumerate(prompts):
        ids = torch.as_tensor(prompt)[None]
        with torch.no_grad():
            # every prompt token is real, id 0 included (HF would take it
            # for padding without the mask)
            want = hf.generate(ids, attention_mask=torch.ones_like(ids),
                               max_new_tokens=NEW, do_sample=False,
                               eos_token_id=None, pad_token_id=0)
        np.testing.assert_array_equal(done[rid], want[0, prompt.size:])
        toks, _ = generate(loaded, prompt[None], NEW, device="cpu")
        np.testing.assert_array_equal(done[rid], toks[0, prompt.size:])


@pytest.mark.parametrize("group", sorted(FIELD_GROUPS))
def test_batcher_matches_generate(group):
    """Admission prefill waves and per-row ticks (rows at different
    positions, rows recycled) against the solo `generate`, greedy."""
    _family, fields = FIELD_GROUPS[group]
    model = GPT(**fields, dtype=torch.float32, device="cpu", seed=3)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, 256, p) for p in (5, 19, 3, 11)]
    srv = ContinuousBatcher(model, batch_size=2, max_len=32, scan_depth=2,
                            device="cpu")
    rids = [srv.submit(p, 8) for p in prompts]
    done = dict(srv.run())
    for rid, prompt in zip(rids, prompts):
        toks, _ = generate(model, prompt[None], 8, device="cpu")
        np.testing.assert_array_equal(done[rid], toks[0, prompt.size:])


def test_remat_artifact_serves(tmp_path):
    """An artifact whose config records remat loads with remat on and
    serves (generate and the batcher) through `decode.remat_off`, with the
    tokens of the same weights without remat."""
    _family, fields = FIELD_GROUPS["llama"]
    model = GPT(**fields, dtype=torch.float32, device="cpu", seed=6,
                remat="full")
    out = convert.save_converted(model, str(tmp_path / "artifact"), "llama")
    loaded = convert.load_converted(out, device="cpu")
    assert loaded.decoder.remat == "full"
    plain = GPT(**fields, dtype=torch.float32, device="cpu")
    plain.load_state_dict(loaded.state_dict())
    prompt = np.random.default_rng(7).integers(0, 256, (1, 9))
    want, _ = generate(plain, prompt, 5, device="cpu")
    got, _ = generate(loaded, prompt, 5, device="cpu")
    assert torch.equal(got, want)
    assert loaded.decoder.remat == "full"
    srv = ContinuousBatcher(loaded, batch_size=1, max_len=16, device="cpu")
    rid = srv.submit(prompt[0], 5)
    np.testing.assert_array_equal(dict(srv.run())[rid], want[0, 9:])


@pytest.mark.parametrize("flag", [
    # --prefix-cache, --num-draft and --serve are ported: a value they
    # cannot read is the error
    ["--num-draft", "two"], ["--prefix-cache", "bogus"], ["--serve", "zero"],
    ["--tokenizer", "tok"], ["--prompt", "hi"], ["--fake-devices", "1"]])
def test_unported_serving_flags_are_argparse_errors(flag):
    with pytest.raises(SystemExit):
        serve_gpt.main(["--tiny", "--device", "cpu", *flag])
