"""The port's sequence packing (tfde_tpu_torch/data/packing.py and GPT
`segment_ids`) against `tfde_tpu.data.packing` and the JAX GPT: packing
and the boundary labels equal the JAX package's arrays; packed logits,
the packed loss, its `packed_accuracy` and `grad_weight` and every
gradient match on the JAX weights (fp32, the same 1e-5 / 1e-4 relative
Frobenius as tests/test_torch_train.py; a gradient zero in exact
arithmetic is held to 1e-6 of the global norm); under rope the packed
forward equals each document's solo forward.
"""

import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfde_tpu.data import packing as jpacking
from tfde_tpu.models.gpt import gpt_tiny_test as j_tiny
from tfde_tpu_torch.data import packing
from tfde_tpu_torch.inference.decode import init_cache
from tfde_tpu_torch.models.flax_weights import from_flax_params
from tfde_tpu_torch.models.gpt import gpt_tiny_test
from tfde_tpu_torch.testing import one_thread

#: one intra-op torch thread for the module (`testing.one_thread`)
_one_thread = pytest.fixture(autouse=True, scope="module")(one_thread)


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _docs(n, lo, hi, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 97, (int(rng.integers(lo, hi)),)).astype(
        np.int32) for _ in range(n)]


@pytest.mark.parametrize("seq_len,max_open_rows,lo,hi", [
    (16, 1024, 2, 15), (16, 2, 2, 15), (8, 1024, 0, 30), (32, 4, 1, 33)])
def test_pack_documents_equals_jax(seq_len, max_open_rows, lo, hi):
    docs = _docs(120, lo, hi)
    got = packing.pack_documents(docs, seq_len, pad_id=3,
                                 max_open_rows=max_open_rows)
    want = jpacking.pack_documents(docs, seq_len, pad_id=3,
                                   max_open_rows=max_open_rows)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    tokens, seg = got
    np.testing.assert_array_equal(
        packing.packed_labels(tokens, seg),
        jpacking.packed_labels(tokens, seg))
    np.testing.assert_array_equal(
        packing.valid_targets(torch.as_tensor(seg)).numpy(),
        jpacking.valid_targets(seg))


def test_pack_documents_refuses_bad_input():
    with pytest.raises(ValueError, match="seq_len"):
        packing.pack_documents([np.arange(3)], 0)
    with pytest.raises(ValueError, match="1-D"):
        packing.pack_documents([np.zeros((2, 2))], 4)


def _batch():
    tokens, seg = packing.pack_documents(_docs(12, 3, 14, seed=1), 16)
    return tokens[:4], seg[:4]


@functools.cache
def _jax(position):
    """(numpy params, packed logits, packed loss + metrics, gradients) of
    the JAX tiny GPT with `position` on `_batch()`."""
    jm = j_tiny(position=position)
    params = jax.jit(jm.init)(jax.random.key(1),
                              jnp.zeros((1, 16), jnp.int32))["params"]
    tokens, seg = (jnp.asarray(a) for a in _batch())
    logits = jax.jit(jm.apply)({"params": params}, tokens,
                               segment_ids=seg)
    state = types.SimpleNamespace(apply_fn=jm.apply)

    def loss_fn(p):
        return jpacking.packed_next_token_loss(state, p, (tokens, seg),
                                               jax.random.key(0))

    (loss, metrics), grads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(params)
    np_tree = functools.partial(jax.tree.map, np.asarray)
    return (np_tree(params), np.asarray(logits), float(loss),
            {k: float(v) for k, v in metrics.items()},
            from_flax_params(np_tree(grads)))


def _port(position):
    model = gpt_tiny_test(device="cpu", position=position)
    model.load_state_dict(from_flax_params(_jax(position)[0]))
    return model


@pytest.mark.parametrize("position", ["learned", "rope"])
def test_packed_logits_loss_and_gradients_match_jax(position):
    _, logits, loss, metrics, grads = _jax(position)
    model = _port(position)
    tokens, seg = (torch.as_tensor(a) for a in _batch())
    with torch.no_grad():
        assert _rel(model(tokens, segment_ids=seg).numpy(), logits) <= 1e-5
    got, got_metrics = packing.packed_next_token_loss(model, (tokens, seg))
    got.backward()
    assert abs(got.item() - loss) <= 1e-5 * abs(loss)
    assert float(got_metrics["grad_weight"]) == metrics["grad_weight"]
    assert abs(float(got_metrics["packed_accuracy"])
               - metrics["packed_accuracy"]) <= 1e-6
    total = np.sqrt(sum(float(np.sum(np.square(w.numpy(), dtype=np.float64)))
                        for w in grads.values()))
    for name, p in model.named_parameters():
        w = grads[name].numpy()
        if np.linalg.norm(w) < 1e-6 * total:  # zero in exact arithmetic
            assert np.linalg.norm(p.grad.numpy()) < 1e-6 * total, name
        else:
            assert _rel(p.grad.numpy(), w) <= 1e-4, name


def test_packed_forward_equals_solo_forward_under_rope():
    """The exactness oracle of tests/test_packing.py on the port: each
    packed document's logits equal its solo run; without the mask the
    second document's differ."""
    model = _port("rope")
    rng = np.random.default_rng(4)
    d1 = rng.integers(1, 97, (6,)).astype(np.int32)
    d2 = rng.integers(1, 97, (5,)).astype(np.int32)
    tokens, seg = packing.pack_documents([d1, d2], seq_len=16)
    assert tokens.shape[0] == 1 and seg[0].max() == 2
    with torch.no_grad():
        packed = model(torch.as_tensor(tokens),
                       segment_ids=torch.as_tensor(seg)).numpy()
        solo1 = model(torch.as_tensor(d1[None])).numpy()
        solo2 = model(torch.as_tensor(d2[None])).numpy()
        unmasked = model(torch.as_tensor(tokens)).numpy()
    np.testing.assert_allclose(packed[0, :6], solo1[0], rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(packed[0, 6:11], solo2[0], rtol=1e-5,
                               atol=1e-5)
    assert np.abs(unmasked[0, 6:11] - solo2[0]).max() > 1e-3


def test_segment_ids_refused_in_decode_and_window():
    seg = torch.ones((1, 8), dtype=torch.int32)
    ids = torch.zeros((1, 8), dtype=torch.long)
    model = gpt_tiny_test(device="cpu", position="rope")
    with pytest.raises(NotImplementedError, match="packing"):
        model(ids, cache=init_cache(model, 1, 8), segment_ids=seg)
    windowed = gpt_tiny_test(device="cpu", position="rope",
                             sliding_window=4)
    with pytest.raises(NotImplementedError, match="sliding_window"):
        windowed(ids, segment_ids=seg)
