"""The port's data-parallel classification step (tfde_tpu_torch.training
step.make_train_step / make_eval_step under MultiWorkerMirroredStrategy
on DDP) held against the JAX package's.

- One process against the JAX `make_train_step` on one device: five
  sgd(0.05) steps of each CNN on the same weights and global batches.
- Two gloo ranks against the JAX `MultiWorkerMirroredStrategy` over two
  CPU devices, on the same global batches: `BatchNormCNN` with
  global-batch statistics, five sgd(0.05) steps. Both ranks end with the
  same bits. Global BatchNorm and its gradient, the biased running
  variance, the SAME pads and the flatten order all have to be right.

Tolerances of a run against the JAX one: the loss and accuracy of every
step and the final running statistics within 2e-5; grad_norm and the
final parameters within 5e-5. Why 5e-5: in `BatchNormCNN` the first
BatchNorm's fast variance E[x^2] - E[x]^2 over 50176 values a channel
cancels, so fp32 rounding there is amplified, and at step 5 the JAX
package's fp32 run ends 2.5e-5 (the first conv kernel) from an fp64 run
of the same five steps, where the port's ends 1.8e-7 from it (measured
on the CPU: one process and two ranks alike, 2.45e-5 and 2.5e-5 from the
JAX run; grad_norm 1.3e-5 at step 5). So every run is also held to the
port's own fp64 run of the same steps, within 1e-6.
- Masked eval of a ragged final batch, padded by `pad_batch_for_mesh`, at
  one and two ranks: the summed loss, correct count and weight of the
  JAX `eval_step` (the loss sum within 1e-6 relative: fp32 sums of up to
  32 terms in another order; the counts exactly).
- optax.sgd and the constant-schedule TrainState.

fp32 on the CPU, dropout off (the two frameworks' random streams never
agree), data from the synthetic MNIST.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tfde_tpu.data import datasets as jdatasets
from tfde_tpu.models import cnn as jcnn
from tfde_tpu.parallel.strategies import MultiWorkerMirroredStrategy
from tfde_tpu.runtime.mesh import make_mesh
from tfde_tpu.training.step import init_state as j_init_state
from tfde_tpu.training.step import make_eval_step as j_make_eval_step
from tfde_tpu.training.step import make_train_step as j_make_train_step
from tfde_tpu.training.step import pad_batch_for_mesh as j_pad
from tfde_tpu_torch import testing
from tfde_tpu_torch.models.cnn import BatchNormCNN, PlainCNN
from tfde_tpu_torch.models.flax_weights import from_flax_params
from tfde_tpu_torch.parallel import strategies
from tfde_tpu_torch.runtime.mesh import LocalMesh
from tfde_tpu_torch.training import optimizers as optim
from tfde_tpu_torch.training.step import (
    init_state, make_train_step, pad_batch_for_mesh)

#: one intra-op torch thread for the module (`testing.one_thread`)
_one_thread = pytest.fixture(autouse=True, scope="module")(testing.one_thread)

ATOL = 2e-5
PARAM_ATOL = 5e-5  # the JAX fp32 run's own error: see the docstring
FP64_ATOL = 1e-6
STEPS, BATCH = 5, 64


def _batches():
    (tx, ty), _ = jdatasets.mnist(flatten=False, n_train=1024, n_test=8)
    order = np.random.default_rng(0).permutation(len(tx))
    return [(tx[order[i * BATCH:(i + 1) * BATCH]],
             ty[order[i * BATCH:(i + 1) * BATCH]]) for i in range(STEPS)]


def _ragged_eval():
    """Batches of 32, 13 and 1 test images, the last two ragged."""
    _, (ex, ey) = jdatasets.mnist(flatten=False, n_train=8, n_test=46)
    return [(ex[a:b], ey[a:b]) for a, b in [(0, 32), (32, 45), (45, 46)]]


def _jax_model(name):
    return (jcnn.PlainCNN() if name == "PlainCNN"
            else jcnn.BatchNormCNN(dropout_rate=0.0))


def _jax_strategy(n):
    return MultiWorkerMirroredStrategy(
        mesh=make_mesh({"data": n}, devices=jax.devices()[:n]))


def _jax_run(name, n, batches, lr, momentum=None, eval_batches=(),
             stats_seed=None):
    """Initial state_dict (torch names), then the JAX run's per-step
    metrics, eval sums and final state_dict (torch names). `stats_seed`
    moves the initial running statistics away from 0 and 1."""
    strat = _jax_strategy(n)
    state, _ = j_init_state(_jax_model(name), optax.sgd(lr, momentum),
                            strat, jnp.zeros((BATCH, 28, 28, 1)))
    if stats_seed is not None:
        rng = np.random.default_rng(stats_seed)
        state = state.replace(batch_stats=jax.tree.map(
            lambda a: a + jnp.asarray(rng.uniform(0.2, 1.0, a.shape),
                                      jnp.float32), state.batch_stats))

    def state_dict(s):
        return {k: v.numpy() for k, v in from_flax_params(
            jax.tree.map(np.asarray, s.params),
            jax.tree.map(np.asarray, s.batch_stats) or None).items()}

    initial = state_dict(state)
    step = j_make_train_step(strat, state, donate=False)
    history = []
    for batch in batches:
        state, m = step(state, batch, jax.random.key(0))
        history.append({k: float(v) for k, v in m.items()})
    ev = j_make_eval_step(strat, state)
    evals = [{k: float(v) for k, v in ev(state, b).items()}
             for b in eval_batches]
    return initial, {"history": history, "eval": evals,
                     "state_dict": state_dict(state)}


def _is_stat(name):
    return name.endswith(("running_mean", "running_var"))


def _assert_runs_match(got, want, fp64):
    assert len(got["history"]) == len(want["history"])
    for g, w in zip(got["history"], want["history"]):
        assert set(g) == set(w) == {"loss", "accuracy", "grad_norm"}
        for k in w:
            np.testing.assert_allclose(
                g[k], w[k], atol=PARAM_ATOL if k == "grad_norm" else ATOL,
                rtol=0, err_msg=k)
    assert set(got["state_dict"]) == set(want["state_dict"]) == set(fp64)
    for k, w in want["state_dict"].items():
        np.testing.assert_allclose(got["state_dict"][k], w, rtol=0,
                                   atol=ATOL if _is_stat(k) else PARAM_ATOL,
                                   err_msg=k)
        np.testing.assert_allclose(got["state_dict"][k], fp64[k], rtol=0,
                                   atol=FP64_ATOL, err_msg=k)


def _port_fp64_run(name, initial, batches, lr):
    """The final state_dict of the port's one-process run in fp64."""
    model = (BatchNormCNN(dropout_rate=0.0, device="cpu")
             if name == "BatchNormCNN" else PlainCNN(device="cpu"))
    model.load_state_dict({k: torch.as_tensor(v) for k, v in initial.items()})
    model.double()
    state = init_state(model, optim.sgd(model, lr))
    step = make_train_step(strategies.MultiWorkerMirroredStrategy(
        mesh=LocalMesh(("data",))), state)
    for x, y in batches:
        step(state, (x.astype(np.float64), y))
    return {k: v.numpy() for k, v in model.state_dict().items()}


@pytest.mark.parametrize("name", ["PlainCNN", "BatchNormCNN"])
def test_one_process_matches_jax_single_device(name):
    batches = _batches()
    initial, want = _jax_run(name, 1, batches, lr=0.05)
    got = testing.train_cnn(name, initial, batches, 0.05)
    _assert_runs_match(got, want, _port_fp64_run(name, initial, batches, 0.05))


def test_two_gloo_ranks_match_jax_data_parallel_over_two_devices(tmp_path):
    batches = _batches()
    initial, want = _jax_run("BatchNormCNN", 2, batches, lr=0.05)
    args = (2, str(tmp_path / "store"), "BatchNormCNN", initial, batches,
            0.05)
    out = testing.run_ranks(testing.dp_train_worker, [args] * 2)
    fp64 = _port_fp64_run("BatchNormCNN", initial, batches, 0.05)
    for got in out:
        _assert_runs_match(got, want, fp64)
    assert out[0]["history"] == out[1]["history"]
    for k, v in out[0]["state_dict"].items():
        assert np.array_equal(v, out[1]["state_dict"][k]), k
    stats = [k for k in want["state_dict"] if k.startswith("BatchNorm")
             and k.endswith(("running_mean", "running_var"))]
    assert len(stats) == 8


@pytest.mark.parametrize("world", [1, 2])
def test_masked_eval_of_a_ragged_batch_matches_jax(world, tmp_path):
    jax_batches = [j_pad(b, world) for b in _ragged_eval()]
    batches = [pad_batch_for_mesh(b, world) for b in _ragged_eval()]
    for ours, theirs in zip(batches, jax_batches):
        for a, b in zip(ours, theirs):
            assert np.array_equal(a, b)
    initial, want = _jax_run("BatchNormCNN", world, [], lr=0.05,
                             eval_batches=jax_batches, stats_seed=1)
    args = ("BatchNormCNN", initial, [], 0.05, None, batches)
    if world == 1:
        outs = [testing.train_cnn(*args)]
    else:
        outs = testing.run_ranks(
            testing.dp_train_worker,
            [(2, str(tmp_path / "store")) + args] * 2)
    assert [w["weight"] for w in want["eval"]] == [32, 13, 1]
    for got in outs:
        for g, w in zip(got["eval"], want["eval"], strict=True):
            np.testing.assert_allclose(g["loss_sum"], w["loss_sum"],
                                       rtol=1e-6)
            assert g["correct_sum"] == w["correct_sum"]
            assert g["weight"] == w["weight"]


@pytest.mark.parametrize("momentum,nesterov", [(None, False), (0.9, False),
                                               (0.9, True), (0.0, False)])
def test_sgd_matches_optax(momentum, nesterov):
    rng = np.random.default_rng(0)
    p0 = rng.standard_normal((7, 3)).astype(np.float32)
    grads = [rng.standard_normal((7, 3)).astype(np.float32)
             for _ in range(4)]
    tx = optax.sgd(0.1, momentum, nesterov)
    params, opt_state = jnp.asarray(p0), tx.init(jnp.asarray(p0))
    model = torch.nn.Linear(3, 7, bias=False)
    with torch.no_grad():
        model.weight.copy_(torch.as_tensor(p0))
    state = init_state(model, optim.sgd(model, 0.1, momentum, nesterov))
    for g in grads:
        updates, opt_state = tx.update(jnp.asarray(g), opt_state, params)
        params = optax.apply_updates(params, updates)
        model.weight.grad = torch.as_tensor(g)
        state.apply_gradients()
        np.testing.assert_allclose(model.weight.detach().numpy(),
                                   np.asarray(params), atol=1e-6, rtol=0)
    assert state.step == 4


def test_train_state_takes_a_torch_optimizer_and_a_number():
    model = PlainCNN(device="cpu")
    tx = torch.optim.SGD(model.parameters(), lr=1.0)
    state = init_state(model, tx, 0.25)
    assert state.schedule(0) == state.schedule(100) == 0.25
    for p in model.parameters():
        p.grad = torch.ones_like(p)
    before = model.Dense_1.bias.detach().clone()
    state.apply_gradients()
    assert torch.allclose(model.Dense_1.bias, before - 0.25)
    assert state.step == 1 and tx.param_groups[0]["lr"] == 0.25
    with pytest.raises(ValueError, match="nesterov"):
        optim.sgd(model, 0.1, nesterov=True)
