"""Rematerialisation in the port's encoder (tfde_tpu_torch/models/
transformer.Encoder `remat`): checkpointed blocks compute the same
function and the same gradients, bit for bit on the CPU, as the plain
blocks, for GPT (rope, GQA, window), BERT and ViT with dropout on (the
recompute replays the block's dropout masks from its own generator
state), under 'full' and 'dots'. 'dots' saves the outputs of the GEMMs
without batch dims: its backward runs the Dense GEMMs no more often than
the plain backward, 'full' runs them again, and both run the attention's
batched products again. Decode refuses remat; `generate` serves a
remat-trained model with the plain model's tokens, as the JAX decode
clone does.
"""

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from tfde_tpu_torch.bert_mlm import mlm_loss_fn
from tfde_tpu_torch.data.mlm import MlmConfig, mask_tokens
from tfde_tpu_torch.inference.decode import generate, init_cache
from tfde_tpu_torch.models.bert import Bert
from tfde_tpu_torch.models.gpt import gpt_tiny_test, next_token_loss
from tfde_tpu_torch.models.vit import vit_tiny_test
from tfde_tpu_torch.ops.losses import sparse_categorical_crossentropy
from tfde_tpu_torch.testing import one_thread

#: one intra-op torch thread for the module (`testing.one_thread`)
_one_thread = pytest.fixture(autouse=True, scope="module")(one_thread)

REMATS = [True, "full", "dots"]
GPT_KW = dict(position="rope", num_kv_heads=2, sliding_window=6)


def _gpt(remat):
    return gpt_tiny_test(device="cpu", seed=3, remat=remat, **GPT_KW)


def _bert(remat):
    """bert_tiny_test's widths with dropout on."""
    return Bert(vocab_size=97, hidden_size=32, depth=2, num_heads=4,
                mlp_dim=64, max_position=64, dtype=torch.float32,
                dropout_rate=0.1, device="cpu", seed=3, remat=remat)


def _vit(remat):
    return vit_tiny_test(device="cpu", seed=3, dropout_rate=0.1,
                         remat=remat)


def _gpt_loss(model, gen):
    ids = torch.as_tensor(np.random.default_rng(0).integers(0, 97, (3, 16)))
    return next_token_loss(model, ids, gen)[0]


def _bert_loss(model, gen):
    rng = np.random.default_rng(1)
    batch = mask_tokens(rng.integers(0, 96, (4, 16)),
                        MlmConfig(vocab_size=96, mask_id=96), rng)
    return mlm_loss_fn(model, tuple(torch.as_tensor(b) for b in batch),
                       gen)[0]


def _vit_loss(model, gen):
    rng = np.random.default_rng(2)
    images = torch.as_tensor(rng.random((4, 32, 32, 3), np.float32))
    labels = torch.as_tensor(rng.integers(0, 10, (4, 1)))
    return sparse_categorical_crossentropy(
        model(images, train=True, generator=gen), labels)


MODELS = {"gpt": (_gpt, _gpt_loss), "bert": (_bert, _bert_loss),
          "vit": (_vit, _vit_loss)}


class _CountOps(TorchDispatchMode):
    """Counts the aten ops run while it is active."""

    def __init__(self):
        super().__init__()
        self.counts = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.counts[func] = self.counts.get(func, 0) + 1
        return func(*args, **(kwargs or {}))


def _run(name, remat, count=False):
    """(loss, {name: gradient}, the generator's state after, the aten op
    counts of the backward) of one forward and backward, the dropout
    generator seeded 7."""
    build, loss_fn = MODELS[name]
    model = build(remat)
    gen = torch.Generator().manual_seed(7)
    loss = loss_fn(model, gen)
    mode = _CountOps()
    if count:
        with mode:
            loss.backward()
    else:
        loss.backward()
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    return loss.detach(), grads, gen.get_state(), mode.counts


@pytest.mark.parametrize("remat", REMATS)
@pytest.mark.parametrize("name", MODELS)
def test_remat_gradients_equal_plain_bit_for_bit(name, remat):
    loss0, grads0, state0, _ = _run(name, False)
    loss1, grads1, state1, _ = _run(name, remat)
    assert torch.equal(loss0, loss1)
    assert grads0.keys() == grads1.keys()
    for n, g in grads0.items():
        assert torch.equal(g, grads1[n]), n
    # the caller's generator ends where the plain forward leaves it
    assert torch.equal(state0, state1)


def test_dots_saves_the_gemms_and_full_recomputes_them():
    mm = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)
    counts = {r: _run("bert", r, count=True)[3]
              for r in (False, "full", "dots")}

    def n(ops, remat):
        return sum(counts[remat].get(op, 0) for op in ops)

    # the forward's Dense GEMMs of the blocks (6 a block: q, k, v, out,
    # fc1, fc2) run again under 'full', not under 'dots'
    assert n(mm, "full") == n(mm, False) + 2 * 6
    assert n(mm, "dots") == n(mm, False)
    # the attention's batched products (QK^T, PV) are recomputed by both
    bmm = (torch.ops.aten.bmm.default,)
    assert n(bmm, "full") == n(bmm, "dots") == n(bmm, False) + 2 * 2


def test_bad_remat_raises():
    with pytest.raises(ValueError, match="remat"):
        gpt_tiny_test(device="cpu", remat="sideways")


def test_decode_refuses_remat_and_generate_serves_the_model():
    model = _gpt("full")
    with pytest.raises(ValueError, match="remat"), torch.no_grad():
        model(torch.zeros((1, 4), dtype=torch.long),
              cache=init_cache(model, 1, 8))
    prompt = np.random.default_rng(3).integers(0, 97, (2, 5))
    got, _ = generate(model, prompt, 6, device="cpu")
    want, _ = generate(_gpt(False), prompt, 6, device="cpu")
    assert torch.equal(got, want)
    assert model.decoder.remat == "full"  # restored after serving
