"""The port's MNIST CNNs (tfde_tpu_torch.models.cnn), accuracy and
synthetic MNIST held against the JAX package.

Logits of `PlainCNN` and `BatchNormCNN` in training and eval mode against
`flax.apply` on the same weights (carried by `from_flax_params`, conv
kernels HWIO -> OIHW, batch statistics included), and the BatchNorm
running statistics after one training forward, within 2e-5 (fp32, sums
in another order). Eval mode runs on perturbed running statistics, so
that they matter. The SAME pads against `jax.lax.padtype_to_pads`, at
MNIST's sizes and at odd ones where they are uneven. Synthetic MNIST
equal to the JAX package's bit for bit. Dropout at its default 0.5: the
two frameworks' random streams never agree, so it is held to its own
contract (eval deterministic, the loss falls).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfde_tpu.data import datasets as jdatasets
from tfde_tpu.models import cnn as jcnn
from tfde_tpu.ops import metrics as jmetrics
from tfde_tpu_torch.data import datasets
from tfde_tpu_torch.models import cnn
from tfde_tpu_torch.models.flax_weights import from_flax_params
from tfde_tpu_torch.ops import metrics

ATOL = 2e-5


def _images(n, seed=0, flat=False):
    x = np.random.default_rng(seed).random((n, 28, 28, 1), dtype=np.float32)
    return x.reshape(n, 784) if flat else x


def _pair(name, seed=0):
    """(flax module, its variables as numpy, the port's model on them)."""
    if name == "PlainCNN":
        jm, tm = jcnn.PlainCNN(), cnn.PlainCNN(device="cpu")
    else:
        jm = jcnn.BatchNormCNN(dropout_rate=0.0)
        tm = cnn.BatchNormCNN(dropout_rate=0.0, device="cpu")
    variables = jm.init(jax.random.key(seed), jnp.zeros((1, 28, 28, 1)))
    variables = jax.tree.map(np.asarray, variables)
    if "batch_stats" in variables:  # running statistics away from 0 / 1
        rng = np.random.default_rng(seed + 1)
        variables["batch_stats"] = jax.tree.map(
            lambda a: (a + rng.uniform(0.2, 1.5, a.shape)).astype(np.float32),
            variables["batch_stats"])
    tm.load_state_dict(from_flax_params(variables["params"],
                                        variables.get("batch_stats")))
    return jm, variables, tm


@pytest.mark.parametrize("size,kernel,stride", [
    (28, 3, 1), (28, 6, 2), (14, 6, 2),   # the BN-CNN's three convolutions
    (7, 6, 2), (13, 3, 2), (5, 4, 3), (1, 6, 2), (9, 2, 1), (28, 1, 1)])
def test_same_pads_match_lax(size, kernel, stride):
    want = jax.lax.padtype_to_pads((size,), (kernel,), (stride,), "SAME")[0]
    assert cnn.same_pads(size, kernel, stride) == tuple(want)


@pytest.mark.parametrize("name", ["PlainCNN", "BatchNormCNN"])
@pytest.mark.parametrize("train", [False, True])
def test_logits_match_flax(name, train):
    jm, variables, tm = _pair(name)
    x = _images(16)
    if train:
        want, _ = jm.apply(variables, x, train=True, mutable=["batch_stats"])
    else:
        want = jm.apply(variables, x, train=False)
    got = tm(torch.as_tensor(x), train=train)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=ATOL, rtol=0)


@pytest.mark.parametrize("name", ["PlainCNN", "BatchNormCNN"])
def test_flat_and_nhwc_inputs_agree(name):
    _, _, tm = _pair(name)
    x = _images(4)
    a = tm(torch.as_tensor(x))
    b = tm(torch.as_tensor(x.reshape(4, 784)))
    assert torch.equal(a, b)


def test_batch_stats_after_one_train_forward_match_flax():
    jm, variables, tm = _pair("BatchNormCNN")
    x = _images(32, seed=3)
    _, mutated = jm.apply(variables, x, train=True, mutable=["batch_stats"])
    tm(torch.as_tensor(x), train=True)
    want = {k: v.numpy() for k, v in from_flax_params(
        {}, jax.tree.map(np.asarray, mutated["batch_stats"])).items()}
    got = {k: v.numpy() for k, v in tm.state_dict().items()
           if k.endswith(("running_mean", "running_var"))}
    assert set(got) == set(want) and len(got) == 8
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=ATOL, rtol=0,
                                   err_msg=k)


def test_conv_kernel_and_batch_stats_conversion():
    kernel = np.arange(3 * 5 * 2 * 4, dtype=np.float32).reshape(3, 5, 2, 4)
    sd = from_flax_params({"Conv_0": {"kernel": kernel}},
                          {"BatchNorm_0": {"mean": np.ones(4),
                                           "var": np.full(4, 2.0)}})
    assert sd["Conv_0.weight"].shape == (4, 2, 3, 5)   # OIHW
    assert sd["Conv_0.weight"][3, 1, 2, 4] == kernel[2, 4, 1, 3]
    assert torch.equal(sd["BatchNorm_0.running_var"], torch.full((4,), 2.0))


@pytest.mark.parametrize("label_shape", ["column", "flat"])
def test_accuracy_matches_jax(label_shape):
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((50, 10)).astype(np.float32)
    labels = rng.integers(0, 10, (50, 1))
    labels[:20, 0] = logits[:20].argmax(-1)
    if label_shape == "flat":
        labels = labels[:, 0]
    want = float(jmetrics.accuracy(jnp.asarray(logits), jnp.asarray(labels)))
    got = float(metrics.accuracy(torch.as_tensor(logits),
                                 torch.as_tensor(labels)))
    assert got == want


@pytest.mark.parametrize("flatten", [True, False])
def test_synthetic_mnist_is_the_jax_packages_bit_for_bit(flatten,
                                                          monkeypatch):
    # neither side may find a local mnist.npz: the synthetic stand-ins
    monkeypatch.setattr(jdatasets, "_SEARCH_DIRS", [])
    monkeypatch.setattr(datasets, "_SEARCH_DIRS", [])
    want = jdatasets.mnist(flatten=flatten, n_train=256, n_test=64)
    got = datasets.mnist(flatten=flatten, n_train=256, n_test=64)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert np.array_equal(g, w)


def test_dropout_trains_and_eval_is_deterministic():
    """BatchNormCNN at its default dropout 0.5: training needs a
    generator, the same generator seed gives the same logits, eval
    ignores dropout, and ten SGD steps lower the loss."""
    from tfde_tpu_torch.parallel.strategies import MultiWorkerMirroredStrategy
    from tfde_tpu_torch.runtime.mesh import LocalMesh
    from tfde_tpu_torch.training.optimizers import sgd
    from tfde_tpu_torch.training.step import init_state, make_train_step

    (tx, ty), _ = datasets.mnist(flatten=True, n_train=640, n_test=8)
    model = cnn.BatchNormCNN(device="cpu")
    x = torch.as_tensor(tx[:32])
    with pytest.raises(ValueError, match="Generator"):
        model(x, train=True)
    a = model(x, train=True, generator=torch.Generator().manual_seed(5))
    b = model(x, train=True, generator=torch.Generator().manual_seed(5))
    assert torch.equal(a, b)
    assert torch.equal(model(x), model(x))
    state = init_state(model, sgd(model, 0.1, momentum=0.9))
    step = make_train_step(
        MultiWorkerMirroredStrategy(mesh=LocalMesh(("data",))), state)
    gen = torch.Generator().manual_seed(0)
    losses = []
    for i in range(10):
        state, m = step(state, (tx[i * 64:(i + 1) * 64],
                                ty[i * 64:(i + 1) * 64]), gen)
        losses.append(float(m["loss"]))
    assert all(np.isfinite(losses))
    assert np.mean(losses[-3:]) < np.mean(losses[:3]), losses
