"""The port's ParameterServerStrategy (ZeRO-1: tfde_tpu_torch.parallel.
strategies, training.train_state.ShardedUpdate, parallel.sharding) held
against the port's MultiWorkerMirroredStrategy and the JAX package's
ParameterServerStrategy, on the CPU.

- Parity: two gloo ranks, PlainCNN and BatchNormCNN (dropout off), five
  steps of 64 under sgd(0.05, momentum 0.9) and adam(1e-3) (the port's
  adamw with weight decay 0), from the JAX init carried over by
  `from_flax_params`:
  - against the port's mirrored run of the same steps at 1e-7 (the math
    is the same; ``pytest -s`` prints whether the bits are equal: they
    were in every case on the CPU), parameters and optimizer state;
  - against the JAX ParameterServerStrategy over two CPU devices: PlainCNN
    at 2e-5 (tests/test_train_dp.py:91). BatchNormCNN: the JAX fp32 run's
    first BatchNorm (fast variance E[x^2] - E[x]^2 over 50176 values a
    channel) cancels, and under momentum 0.9 and Adam the JAX fp32 run
    ends 4.7e-4 and 1.9e-3 from the same JAX run computed in fp64 (the
    anchor: `dtype=float64` under `jax.enable_x64`), so there the port is
    held to the anchor: 5e-5 with momentum SGD (it lies 3.9e-7 away), and
    1e-4 with Adam, which divides each update by the gradient's RMS, so
    an element whose gradient sits at fp32 rounding moves by rounding (the
    port lies 5.8e-5 away, in Dense_0's weight). Without momentum, the
    JAX fp32 run is sound enough (2.5e-5 from the port) to hold the port
    to it at 5e-5 (ROADMAP's BN caveat).
- Shard sizes: each rank's optimizer state (the tensors of at least one
  dim; the scalar step counters are left out on both sides) holds as many
  elements as a JAX device holds under the JAX spec, at
  `min_shard_elems=1024` and at the default 2**14; at four ranks, by the
  rule alone. BatchNormCNN with momentum SGD at two ranks: 531,464 bytes
  a rank against 1,001,864 replicated.
- Checkpoints: a PS checkpoint resumes under the mirrored strategy and
  the other way round, restored before and after the train step is built;
  each resumed run ends with the uninterrupted run's parameters and
  optimizer state.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
from jax.sharding import PartitionSpec

from tfde_tpu.data import datasets as jdatasets
from tfde_tpu.models import cnn as jcnn
from tfde_tpu.parallel.sharding import shard_pytree_spec
from tfde_tpu.parallel.strategies import (
    ParameterServerStrategy as JParameterServerStrategy)
from tfde_tpu.runtime.mesh import make_mesh
from tfde_tpu.training.step import init_state as j_init_state
from tfde_tpu.training.step import make_train_step as j_make_train_step
from tfde_tpu_torch import testing
from tfde_tpu_torch.models.cnn import BatchNormCNN, PlainCNN
from tfde_tpu_torch.models.flax_weights import from_flax_params
from tfde_tpu_torch.parallel import strategies
from tfde_tpu_torch.parallel.sharding import largest_divisible_dim, shard_dims
from tfde_tpu_torch.runtime.mesh import LocalMesh
from tfde_tpu_torch.training.optimizers import sgd
from tfde_tpu_torch.training.step import init_state, make_train_step

STEPS, BATCH = 5, 64
MIRRORED_ATOL = 1e-7
#: (model, optimizer) -> (reference, atol): "jax" the JAX fp32 PS run,
#: "anchor" the same run in fp64 (see the module docstring)
CASES = {
    ("PlainCNN", "sgd"): ("jax", 2e-5),
    ("PlainCNN", "adam"): ("jax", 2e-5),
    ("BatchNormCNN", "sgd"): ("anchor", 5e-5),
    ("BatchNormCNN", "adam"): ("anchor", 1e-4),
}
BN_PLAIN_SGD_ATOL = 5e-5
OPTS = {"sgd": (0.05, 0.9), "adam": (1e-3, None), "sgd0": (0.05, None)}


def _batches():
    (tx, ty), _ = jdatasets.mnist(flatten=False, n_train=1024, n_test=8)
    order = np.random.default_rng(0).permutation(len(tx))
    return [(tx[order[i * BATCH:(i + 1) * BATCH]],
             ty[order[i * BATCH:(i + 1) * BATCH]]) for i in range(STEPS)]


def _jax_tx(opt):
    lr, momentum = OPTS[opt]
    return optax.adam(lr) if opt == "adam" else optax.sgd(lr, momentum)


def _jax_model(name, dtype=jnp.float32):
    return (jcnn.PlainCNN(dtype=dtype) if name == "PlainCNN"
            else jcnn.BatchNormCNN(dropout_rate=0.0, dtype=dtype))


def _jax_ps(n, min_elems=2**14):
    return JParameterServerStrategy(
        mesh=make_mesh({"data": n}, devices=jax.devices()[:n]),
        min_shard_elems=min_elems)


def _state_dict(s):
    return {k: v.numpy() for k, v in from_flax_params(
        jax.tree.map(np.asarray, s.params),
        jax.tree.map(np.asarray, s.batch_stats) or None).items()}


@functools.cache
def _jax_run(name, opt, fp64=False):
    """(initial state_dict, final state_dict) of the JAX PS run over two
    CPU devices; with `fp64` the model computes in fp64 under x64."""
    with jax.enable_x64(fp64):
        strat = _jax_ps(2)
        state, _ = j_init_state(
            _jax_model(name, jnp.float64 if fp64 else jnp.float32),
            _jax_tx(opt), strat, jnp.zeros((BATCH, 28, 28, 1)))
        initial = _state_dict(state)
        step = j_make_train_step(strat, state, donate=False)
        for batch in _batches():
            state, _ = step(state, batch, jax.random.key(0))
        return initial, _state_dict(state)


@pytest.fixture(scope="module")
def port_runs(tmp_path_factory):
    """Every port run of this file's parity and shard-size tests, on one
    two-rank gloo group: {(model, optimizer, strategy, min_shard_elems):
    rank 0's result, with "ranks_equal"}."""
    keys = [(name, opt, strat, 2**14) for name, opt in CASES
            for strat in ("MultiWorkerMirroredStrategy",
                          "ParameterServerStrategy")]
    keys += [(name, opt, "ParameterServerStrategy", 1024)
             for name, opt in CASES]
    keys.append(("BatchNormCNN", "sgd0", "ParameterServerStrategy", 2**14))
    runs = []
    for name, opt, strat, min_elems in keys:
        lr, momentum = OPTS[opt]
        initial, _ = _jax_run(name, opt)
        runs.append(((name, initial, _batches(), lr, momentum),
                     {"strategy": strat, "optimizer": opt.rstrip("0"),
                      "min_shard_elems": min_elems}))
    store = str(tmp_path_factory.mktemp("ps") / "store")
    out = testing.run_ranks(testing.dp_train_runs_worker,
                            [(2, store, runs)] * 2, timeout=300)
    results = {}
    for key, r0, r1 in zip(keys, *out):
        r0["ranks_equal"] = all(np.array_equal(v, r1["state_dict"][k])
                                for k, v in r0["state_dict"].items())
        results[key] = r0
    return results


def _max_abs(got, want):
    errs = {k: float(np.max(np.abs(np.float64(got[k]) - want[k])))
            for k in want}
    k = max(errs, key=errs.get)
    return errs[k], k


def _opt_arrays(run):
    return [v for i in sorted(run["opt_state"])
            for _, v in sorted(run["opt_state"][i].items())]


@pytest.mark.parametrize("name,opt", list(CASES))
def test_ps_matches_the_mirrored_run(port_runs, name, opt):
    ps = port_runs[name, opt, "ParameterServerStrategy", 2**14]
    mirrored = port_runs[name, opt, "MultiWorkerMirroredStrategy", 2**14]
    assert ps["ranks_equal"] and mirrored["ranks_equal"]
    err, where = _max_abs(ps["state_dict"], mirrored["state_dict"])
    bits = all(np.array_equal(v, mirrored["state_dict"][k])
               for k, v in ps["state_dict"].items())
    print(f"{name} {opt}: PS vs mirrored max abs {err:.3e} ({where}); "
          f"bits equal: {bits}")
    assert err <= MIRRORED_ATOL, where
    for a, b in zip(_opt_arrays(ps), _opt_arrays(mirrored), strict=True):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, atol=MIRRORED_ATOL, rtol=0)
    for got, want in zip(ps["history"], mirrored["history"], strict=True):
        np.testing.assert_allclose(got["loss"], want["loss"],
                                   atol=MIRRORED_ATOL, rtol=0)


@pytest.mark.parametrize("name,opt", list(CASES))
def test_ps_matches_jax_ps_over_two_devices(port_runs, name, opt):
    ref, atol = CASES[name, opt]
    got = port_runs[name, opt, "ParameterServerStrategy", 2**14]
    _, want = _jax_run(name, opt)
    err, where = _max_abs(got["state_dict"], want)
    line = f"{name} {opt}: port PS vs JAX PS fp32 {err:.3e} ({where})"
    if ref == "anchor":
        _, anchor = _jax_run(name, opt, fp64=True)
        jerr, jwhere = _max_abs(want, anchor)
        aerr, where = _max_abs(got["state_dict"], anchor)
        line += (f"; the JAX fp32 run vs the anchor {jerr:.3e} ({jwhere}); "
                 f"port vs the anchor {aerr:.3e} ({where})")
        err = aerr
    print(line)
    assert err <= atol, where


def test_bn_ps_without_momentum_matches_the_jax_fp32_run(port_runs):
    got = port_runs["BatchNormCNN", "sgd0", "ParameterServerStrategy", 2**14]
    _, want = _jax_run("BatchNormCNN", "sgd0")
    err, where = _max_abs(got["state_dict"], want)
    assert err <= BN_PLAIN_SGD_ATOL, where


def _jax_per_device_elems(name, opt, n, min_elems):
    """Elements a device holds of the JAX PS optimizer state (leaves of at
    least one dim) under the strategy's spec over `n` devices, from
    abstract shapes."""
    strat = _jax_ps(n, min_elems)
    params = jax.eval_shape(lambda x: _jax_model(name).init(
        jax.random.key(0), x), jnp.zeros((BATCH, 28, 28, 1)))["params"]
    opt_state = jax.eval_shape(_jax_tx(opt).init, params)
    specs = strat.opt_state_spec(opt_state, params)
    leaves = jax.tree_util.tree_leaves(opt_state)
    spec_leaves = jax.tree_util.tree_leaves(
        specs, is_leaf=lambda x: isinstance(x, PartitionSpec))
    return sum(leaf.size // (n if "data" in spec else 1)
               for leaf, spec in zip(leaves, spec_leaves, strict=True)
               if leaf.ndim)


@pytest.mark.parametrize("min_elems", [1024, 2**14])
@pytest.mark.parametrize("name,opt", list(CASES))
def test_each_rank_holds_the_jax_share_of_the_optimizer_state(
        port_runs, name, opt, min_elems):
    got = port_runs[name, opt, "ParameterServerStrategy", min_elems]
    elems = sum(a.size for a in _opt_arrays(got))  # the replicated layout
    want = _jax_per_device_elems(name, opt, 2, min_elems)
    assert got["opt_state_bytes"] == 4 * want
    assert want < elems
    if (name, opt, min_elems) == ("BatchNormCNN", "sgd", 2**14):
        assert got["opt_state_bytes"] == 4 * (117_600 + 15_266) == 531_464
        mirrored = port_runs[name, opt, "MultiWorkerMirroredStrategy", 2**14]
        assert mirrored["opt_state_bytes"] == 4 * 250_466 == 1_001_864


@pytest.mark.parametrize("min_elems", [1024, 2**14])
@pytest.mark.parametrize("name", ["PlainCNN", "BatchNormCNN"])
def test_the_rule_gives_a_jax_device_share_at_four_ranks(name, min_elems):
    model = (BatchNormCNN(dropout_rate=0.0, device="cpu")
             if name == "BatchNormCNN" else PlainCNN(device="cpu"))
    dims = shard_dims(model.named_parameters(), 4, min_elems)
    per_rank = sum(p.numel() // (4 if dims[n] is not None else 1)
                   for n, p in model.named_parameters())
    assert per_rank == _jax_per_device_elems(name, "sgd", 4, min_elems)
    if (name, min_elems) == ("BatchNormCNN", 2**14):
        assert dims == {n: (1 if n == "Dense_0.weight" else None)
                        for n, _ in model.named_parameters()}
        assert 4 * per_rank == 296_264


@pytest.mark.parametrize("shape,size,min_elems", [
    ((1176, 200), 2, 2**14), ((200, 1176), 2, 2**14), ((3, 3, 1, 6), 2, 1),
    ((7, 5), 2, 1), ((64, 64), 4, 1), ((10, 6), 2, 61), ((8,), 4, 1)])
def test_largest_divisible_dim_is_the_jax_rule(shape, size, min_elems):
    mesh = make_mesh({"data": size}, devices=jax.devices()[:size])
    spec = shard_pytree_spec({"x": jnp.zeros(shape)}, mesh, "data",
                             min_elems=min_elems)["x"]
    want = next((i for i, a in enumerate(spec) if a == "data"), None)
    assert largest_divisible_dim(shape, size, min_elems) == want


@pytest.mark.parametrize("first,second", [
    ("ParameterServerStrategy", "MultiWorkerMirroredStrategy"),
    ("MultiWorkerMirroredStrategy", "ParameterServerStrategy")])
def test_checkpoints_move_between_ps_and_mirrored(tmp_path, first, second):
    initial, _ = _jax_run("BatchNormCNN", "sgd")
    args = (2, str(tmp_path / "store"), str(tmp_path / "ckpt"), initial,
            _batches(), first, second, 2)
    out = testing.run_ranks(testing.ps_checkpoint_worker, [args] * 2,
                            timeout=180)
    for rank in out:
        whole = rank["whole"]
        assert whole["step"] == STEPS
        for order in ("restore_first", "step_first"):
            got = rank[order]
            assert (got["restored_at"], got["step"]) == (2, STEPS)
            for k, v in whole["state_dict"].items():
                np.testing.assert_allclose(got["state_dict"][k], v,
                                           atol=MIRRORED_ATOL, rtol=0,
                                           err_msg=f"{order} {k}")
            for a, b in zip(_opt_arrays(got), _opt_arrays(whole),
                            strict=True):
                assert a.shape == b.shape
                np.testing.assert_allclose(a, b, atol=MIRRORED_ATOL, rtol=0)


@pytest.mark.parametrize("kwargs,error", [
    ({"grad_transport": "int8"}, NotImplementedError),
    ({"opt_sharding": "shard"}, NotImplementedError),
    ({"opt_sharding": "sharded"}, ValueError)])
def test_ps_unported_options_raise(kwargs, error):
    with pytest.raises(error):
        strategies.ParameterServerStrategy(**kwargs)


def test_ps_at_one_rank_keeps_the_update_replicated():
    model = BatchNormCNN(dropout_rate=0.0, device="cpu")
    state = init_state(model, sgd(model, 0.05, momentum=0.9))
    strat = strategies.ParameterServerStrategy(mesh=LocalMesh(("data",)))
    step = make_train_step(strat, state)
    x, y = _batches()[0]
    step(state, (x, y))
    assert state.sharded is None and strat.min_shard_elems == 2**14
    assert state.optimizer_params() == list(model.parameters())
