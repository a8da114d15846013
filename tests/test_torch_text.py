"""The port's text pipeline (tfde_tpu_torch/data/text.py) against
`tfde_tpu.data.text`: the same documents from each split mode, the same
token arrays (eos appended, vocab guarded), and the same packed batch
stream (three epochs of a small corpus), with a character-level
WordLevel tokenizer built and saved in the test (nothing downloads);
then one packed train step of the port's tiny GPT on a streamed batch.
"""

import numpy as np
import pytest
import torch

from tfde_tpu.data import text as jtext
from tfde_tpu_torch.data import text
from tfde_tpu_torch.data.packing import packed_next_token_loss
from tfde_tpu_torch.models.gpt import gpt_tiny_test
from tfde_tpu_torch.training.optimizers import adamw
from tfde_tpu_torch.training.step import init_state, make_custom_train_step
from tfde_tpu_torch.testing import one_thread

#: one intra-op torch thread for the module (`testing.one_thread`)
_one_thread = pytest.fixture(autouse=True, scope="module")(one_thread)

pytest.importorskip("transformers")


@pytest.fixture(scope="module")
def tokenizer(tmp_path_factory):
    """A character-level WordLevel tokenizer saved locally and loaded
    back through `load_tokenizer`."""
    from tokenizers import Tokenizer, models, pre_tokenizers
    from transformers import PreTrainedTokenizerFast

    chars = {c: i for i, c in enumerate("abcdefghijklmnopqrstuvwxyz .,!?")}
    chars["<eos>"] = len(chars)
    chars["<unk>"] = len(chars)
    t = Tokenizer(models.WordLevel(chars, unk_token="<unk>"))
    t.pre_tokenizer = pre_tokenizers.Split("", "isolated")
    fast = PreTrainedTokenizerFast(tokenizer_object=t, eos_token="<eos>",
                                   unk_token="<unk>")
    d = tmp_path_factory.mktemp("tok")
    fast.save_pretrained(str(d))
    return text.load_tokenizer(str(d))


@pytest.fixture()
def corpus(tmp_path):
    a = tmp_path / "a.txt"
    a.write_text("the cat sat.\n\non the mat!\n\nbirds fly high.\n\n\n"
                 "a much longer paragraph, which spans more than one row "
                 "of sixteen tokens.")
    b = tmp_path / "b.txt"
    b.write_text("one line\nper document\n\nhere")
    return [str(a), str(b)]


@pytest.mark.parametrize("split", ["paragraph", "line", "file"])
def test_documents_and_tokens_match_jax(tokenizer, corpus, split):
    docs = text.read_documents(corpus, split=split)
    assert docs == jtext.read_documents(corpus, split=split)
    for eos in (True, False):
        got = text.tokenize_documents(docs, tokenizer, append_eos=eos)
        want = jtext.tokenize_documents(docs, tokenizer, append_eos=eos)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.dtype == np.int32
            np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError, match="split"):
        text.read_documents(corpus, split="sentence")


def test_tokenizer_guards(tokenizer, corpus):
    docs = text.read_documents(corpus)
    with pytest.raises(ValueError, match="vocab"):
        text.tokenize_documents(docs, tokenizer, vocab_limit=3)

    class NoEos:
        eos_token_id = None

    with pytest.raises(ValueError, match="eos"):
        text.tokenize_documents(docs, NoEos())


def test_packed_text_batches_match_jax(tokenizer, corpus, tmp_path):
    kw = dict(seq_len=16, batch_size=4, seed=3, vocab_limit=33)
    got = text.packed_text_batches(corpus, tokenizer, **kw)
    want = jtext.packed_text_batches(corpus, tokenizer, **kw)
    for _ in range(6):
        (gt, gs), (wt, ws) = next(got), next(want)
        assert gt.shape == (4, 16)
        np.testing.assert_array_equal(gt, wt)
        np.testing.assert_array_equal(gs, ws)
    empty = tmp_path / "empty.txt"
    empty.write_text("\n\n")
    with pytest.raises(ValueError, match="no documents"):
        next(text.packed_text_batches([str(empty)], tokenizer, 16, 4))


def test_a_streamed_batch_trains_the_tiny_gpt(tokenizer, corpus):
    tokens, seg = next(text.packed_text_batches(corpus, tokenizer, 16, 4,
                                                vocab_limit=97))
    model = gpt_tiny_test(device="cpu", position="rope")
    state = init_state(model, adamw(model, 1e-3))
    step = make_custom_train_step(packed_next_token_loss)
    batch = (torch.as_tensor(tokens), torch.as_tensor(seg))
    state, metrics = step(state, batch)
    assert state.step == 1
    assert set(metrics) == {"loss", "packed_accuracy", "grad_norm"}
    assert np.isfinite(float(metrics["loss"]))
