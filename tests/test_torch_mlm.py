"""The port's masked-LM example construction (tfde_tpu_torch/data/mlm.py, a
numpy copy) held against the JAX package's: the same `MlmConfig` and the
same generator give the same input ids and labels bit for bit, and the
generator ends in the same state; with the BERT entry point's stream
(`bert_mlm.batch_stream` over `synthetic_tokens`) too."""

import itertools

import numpy as np
import pytest

from tfde_tpu.data import datasets as jdatasets
from tfde_tpu.data import mlm as jmlm
from tfde_tpu_torch import bert_mlm
from tfde_tpu_torch.data import datasets, mlm
from tfde_tpu_torch.testing import one_thread

#: one intra-op torch thread for the module (`testing.one_thread`)
_one_thread = pytest.fixture(autouse=True, scope="module")(one_thread)

#: (vocab_size, mask_id, num_special, mask_rate, shape)
CASES = {
    "bert_base": (30521, 30521, 0, 0.15, (8, 128)),
    "tiny": (96, 96, 0, 0.15, (16, 32)),
    "special": (1000, 999, 5, 0.15, (20, 64)),
    "sparse_rows": (50, 49, 3, 0.02, (12, 8)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_mask_tokens_is_the_jax_packages(case):
    vocab, mask_id, special, rate, shape = CASES[case]
    tokens = np.random.default_rng(1).integers(0, vocab, shape).astype(
        np.int32)
    tokens[0, :] = 0  # a row of special/padding tokens only (when special)
    want_cfg = jmlm.MlmConfig(vocab_size=vocab, mask_id=mask_id,
                              num_special=special, mask_rate=rate)
    got_cfg = mlm.MlmConfig(vocab_size=vocab, mask_id=mask_id,
                            num_special=special, mask_rate=rate)
    jrng, trng = np.random.default_rng(3), np.random.default_rng(3)
    for _ in range(3):
        want = jmlm.mask_tokens(tokens, want_cfg, jrng)
        got = mlm.mask_tokens(tokens, got_cfg, trng)
        for g, w in zip(got, want, strict=True):
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(g, w)
    assert jrng.random() == trng.random()
    assert mlm.IGNORE_ID == jmlm.IGNORE_ID


def test_bert_stream_is_the_jax_examples():
    """The entry point's global batches: `synthetic_tokens` over vocab - 1
    and `batch_stream(seed=0)`, against the JAX example's arithmetic."""
    import os
    import sys

    sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
    from examples import bert_mlm as jbert_mlm

    vocab = 97
    tokens = datasets.synthetic_tokens(64, 32, vocab=vocab - 1)
    np.testing.assert_array_equal(
        tokens, jdatasets.synthetic_tokens(64, 32, vocab=vocab - 1))
    got = bert_mlm.batch_stream(tokens, mlm.MlmConfig(vocab - 1, vocab - 1),
                                16, seed=0)
    want = jbert_mlm.batch_stream(
        tokens, jmlm.MlmConfig(vocab - 1, vocab - 1), 16, seed=0)
    for g, w in itertools.islice(zip(got, want), 4):
        np.testing.assert_array_equal(g[0], w[0])
        np.testing.assert_array_equal(g[1], w[1])
