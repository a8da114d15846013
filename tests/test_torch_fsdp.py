"""The port's FSDPStrategy (tfde_tpu_torch/parallel/strategies.py, on
FSDP2) with TrainState, global_norm, the checkpoint manager and the
Estimator under it, at two gloo ranks, held against the JAX package.

Every two-rank run of this file shares one spawn (`testing.jobs_worker`):
- three `vit_tiny_test` steps of masked AdamW under FSDPStrategy, against
  the JAX FSDPStrategy over two CPU devices (losses, grad norms and final
  parameters within STEP_ATOL; the key biases, whose gradient is zero in
  exact arithmetic and which Adam moves by ~lr in the noise's direction,
  held to a bound instead), and against the port's mirrored run (the
  same values: at two ranks the reduce-scatter's and the all-reduce's
  averages are one sum); each rank holds its dim-0 shard of every
  parameter (half, where dim 0 divides by two) and about half the
  optimizer state;
- a checkpoint written under FSDP restores under
  MultiWorkerMirroredStrategy, and the other way round, with the same
  bits, before and after the train step is built;
- `Estimator.train` under FSDP with dropout on, stopped at a checkpoint
  and resumed by a fresh Estimator, ends with the uninterrupted run's
  bits, which are also the mirrored Estimator's; `evaluate` gives the
  mirrored Estimator's metrics;
- the all-gathers and reduce-scatters of one step, counted by
  torch.profiler;
- under `remat`, whose recompute runs inside FSDP2's pre-backward
  gathering, the same steps give the same bits as without it, with the
  collectives a step counted again.
"""

import functools

import jax
import numpy as np
import optax
import pytest

from tfde_tpu.models.vit import vit_tiny_test as j_vit_tiny
from tfde_tpu.parallel.strategies import FSDPStrategy as JFSDPStrategy
from tfde_tpu.runtime.mesh import make_mesh
from tfde_tpu.training import optimizers as joptim
from tfde_tpu.training.step import init_state as j_init_state
from tfde_tpu.training.step import make_train_step as j_make_train_step
from tfde_tpu_torch import testing
from tfde_tpu_torch.models.flax_weights import from_flax_params
from tfde_tpu_torch.parallel.strategies import FSDPStrategy

#: one intra-op torch thread for the module (`testing.one_thread`)
_one_thread = pytest.fixture(autouse=True, scope="module")(testing.one_thread)

STEPS, BATCH = 3, 16
SCHEDULE = (1e-3, 1, 3)  # peak lr, warmup steps, decay steps
WD = 0.05
#: the port's final parameters against the JAX FSDP run's, max abs
STEP_ATOL = 1e-6
#: |key bias| after the steps: 3.2 (Adam's largest normalised step) times
#: the sum of the steps' lrs (0, 1e-3, 5e-4)
KEY_BIAS, KEY_BIAS_BOUND = "attn.key.bias", 3.2 * 1.5e-3
#: Estimator runs: steps, checkpoint cadence, the step the stopped run
#: stops at
EST_STEPS, EST_SAVE, EST_STOP = 6, 2, 3


def _data():
    rng = np.random.default_rng(0)
    images = rng.random((64, 32, 32, 3), np.float32)
    labels = rng.integers(0, 10, (64, 1)).astype(np.int64)
    return images, labels


def _batches():
    images, labels = _data()
    return [(images[i * BATCH:(i + 1) * BATCH],
             labels[i * BATCH:(i + 1) * BATCH]) for i in range(STEPS)]


def _state_dict(params):
    return {k: v.numpy() for k, v in
            from_flax_params(jax.tree.map(np.asarray, params)).items()}


@functools.cache
def _jax_run():
    """(initial state_dict, per-step metrics, final state_dict) of the JAX
    FSDPStrategy over two CPU devices."""
    strat = JFSDPStrategy(mesh=make_mesh({"data": 1, "fsdp": 2},
                                         devices=jax.devices()[:2]))
    tx = joptim.adamw(optax.warmup_cosine_decay_schedule(0.0, *SCHEDULE),
                      weight_decay=WD)
    state, _ = j_init_state(j_vit_tiny(), tx, strat,
                            np.zeros((BATCH, 32, 32, 3), np.float32))
    initial = _state_dict(state.params)
    step = j_make_train_step(strat, state, donate=False)
    history = []
    for batch in _batches():
        state, m = step(state, batch, jax.random.key(0))
        history.append({k: float(v) for k, v in m.items()})
    return initial, history, _state_dict(state.params)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every two-rank run of this file, one spawn: {name: [rank 0's
    result, rank 1's]}."""
    root = tmp_path_factory.mktemp("fsdp")
    initial, _, _ = _jax_run()
    images, labels = _data()
    train, test = (images[:48], labels[:48]), (images[48:], labels[48:])
    est = (initial, train, test, BATCH)
    jobs = {
        "fsdp": ("train_vit", ({}, initial, _batches(), SCHEDULE, WD), {}),
        "mirrored": ("train_vit", ({}, initial, _batches(), SCHEDULE, WD),
                     {"strategy": "MultiWorkerMirroredStrategy"}),
        "to_mirrored": ("vit_checkpoint_swap", (
            str(root / "a"), initial, _batches()[:2], "FSDPStrategy",
            "MultiWorkerMirroredStrategy"), {}),
        "to_fsdp": ("vit_checkpoint_swap", (
            str(root / "b"), initial, _batches()[:2],
            "MultiWorkerMirroredStrategy", "FSDPStrategy"), {}),
        "whole": ("vit_estimator_run", (str(root / "c"), *est, EST_STEPS,
                                        EST_SAVE), {}),
        "stopped": ("vit_estimator_run", (str(root / "d"), *est, EST_STOP,
                                          EST_SAVE), {}),
        "resumed": ("vit_estimator_run", (str(root / "d"), *est, EST_STEPS,
                                          EST_SAVE), {}),
        "mirrored_est": ("vit_estimator_run", (
            str(root / "e"), *est, EST_STEPS, EST_SAVE),
            {"strategy": "MultiWorkerMirroredStrategy"}),
        "collectives": ("fsdp_collectives", (_batches()[0],), {}),
        "fsdp_remat": ("train_vit", ({"remat": "full"}, initial,
                                     _batches(), SCHEDULE, WD), {}),
        "collectives_remat": ("fsdp_collectives",
                              (_batches()[0], {"remat": "full"}), {}),
    }
    out = testing.run_ranks(testing.jobs_worker,
                            [(2, str(root / "store"), list(jobs.values()))]
                            * 2, timeout=300)
    return {name: [out[0][i], out[1][i]] for i, name in enumerate(jobs)}


def _max_abs(got, want):
    """(max abs difference, where) over every tensor but the key biases,
    which must lie within KEY_BIAS_BOUND on both sides."""
    for k in want:
        if k.endswith(KEY_BIAS):
            assert np.max(np.abs(got[k])) <= KEY_BIAS_BOUND, k
            assert np.max(np.abs(want[k])) <= KEY_BIAS_BOUND, k
    errs = {k: float(np.max(np.abs(np.float64(got[k]) - want[k])))
            for k in want if not k.endswith(KEY_BIAS)}
    k = max(errs, key=errs.get)
    return errs[k], k


def _same_bits(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(np.array_equal(v, b[k])
                                        for k, v in a.items())


def _same_opt(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(_same_bits(v, b[i])
                                        for i, v in a.items())


def test_fsdp_steps_match_jax_fsdp_over_two_devices(runs):
    _, history, want = _jax_run()
    r0, r1 = runs["fsdp"]
    err, where = _max_abs(r0["state_dict"], want)
    print(f"FSDP at two gloo ranks vs JAX FSDP over two devices: {err:.3e} "
          f"({where})")
    assert err <= STEP_ATOL, where
    for g, w in zip(r0["history"], history, strict=True):
        assert set(g) == set(w) == {"loss", "accuracy", "grad_norm"}
        for k in w:
            assert abs(g[k] - w[k]) <= 1e-5 * max(1.0, abs(w[k])), k
    assert r0["history"] == r1["history"]
    assert _same_bits(r0["state_dict"], r1["state_dict"])


def test_fsdp_equals_the_mirrored_run(runs):
    fsdp, mirrored = runs["fsdp"][0], runs["mirrored"][0]
    err = max(float(np.max(np.abs(v - mirrored["state_dict"][k])))
              for k, v in fsdp["state_dict"].items())
    print(f"FSDP vs mirrored: max abs {err:.3e}, the same bits: "
          f"{_same_bits(fsdp['state_dict'], mirrored['state_dict'])}")
    assert err <= 1e-7
    for g, w in zip(fsdp["history"], mirrored["history"], strict=True):
        for k in w:
            assert abs(g[k] - w[k]) <= 1e-6 * max(1.0, abs(w[k])), k


def test_each_rank_holds_its_shard(runs):
    (r0, r1), mirrored = runs["fsdp"], runs["mirrored"][0]
    shapes = {k: v.shape for k, v in r0["state_dict"].items()}
    for name, shape in shapes.items():
        n = int(np.prod(shape))
        a, b = r0["local_numel"][name], r1["local_numel"][name]
        assert a + b == n, name
        rows = -(-shape[0] // 2)  # torch.chunk's split of dim 0
        assert a == rows * n // shape[0], name
        if shape[0] % 2 == 0:
            assert a == b == n // 2, name
    halves = [r["opt_state_bytes"] / mirrored["opt_state_bytes"]
              for r in (r0, r1)]
    print(f"optimizer bytes a rank / replicated: {halves}")
    assert all(0.4 <= h <= 0.6 for h in halves)
    assert r0["opt_state_bytes"] + r1["opt_state_bytes"] == \
        mirrored["opt_state_bytes"]


@pytest.mark.parametrize("swap", ["to_mirrored", "to_fsdp"])
@pytest.mark.parametrize("order", ["restore_first", "step_first"])
def test_checkpoints_move_between_fsdp_and_mirrored_with_the_same_bits(
        runs, swap, order):
    for out in runs[swap]:
        saved, restored = out["saved"], out[order]
        assert restored["step"] == saved["step"] == 2
        assert _same_bits(restored["state_dict"], saved["state_dict"])
        assert _same_opt(restored["opt_state"], saved["opt_state"])
        assert np.isfinite(restored["next"]["loss"])
    assert runs[swap][0][order]["next"] == runs[swap][1][order]["next"]


def test_estimator_resumes_under_fsdp_with_the_same_bits(runs):
    whole, stopped, resumed = (runs[k][0] for k in ("whole", "stopped",
                                                    "resumed"))
    # the stopped run's end-of-train save is the newest checkpoint
    assert (stopped["step"], resumed["resumed_from"], resumed["step"]) == (
        EST_STOP, EST_STOP, EST_STEPS)
    assert _same_bits(resumed["state_dict"], whole["state_dict"])
    assert _same_opt(resumed["opt_state"], whole["opt_state"])
    assert resumed["loss"] == whole["loss"]
    assert _same_bits(runs["whole"][1]["state_dict"], whole["state_dict"])


def test_estimator_under_fsdp_equals_the_mirrored_estimator(runs):
    fsdp, mirrored = runs["whole"][0], runs["mirrored_est"][0]
    err = max(float(np.max(np.abs(v - mirrored["state_dict"][k])))
              for k, v in fsdp["state_dict"].items())
    assert err <= 1e-7
    for k, v in mirrored["eval"].items():
        assert abs(fsdp["eval"][k] - v) <= 1e-6 * max(1.0, abs(v)), k
    assert set(fsdp["eval"]) == {"loss", "accuracy"}


def test_fsdp_collectives_a_step(runs):
    """FSDP2 all-gathers the root's parameters once and each block's in the
    forward and again in the backward, and reduce-scatters the root's and
    each block's gradients once: 2 x depth + 1 and depth + 1 a step."""
    depth = 2
    for counts in runs["collectives"]:
        assert counts == {"c10d::_allgather_base_": 2 * depth + 1,
                          "c10d::_reduce_scatter_base_": depth + 1}


def test_fsdp_under_remat_gives_the_same_bits(runs):
    for plain, remat in zip(runs["fsdp"], runs["fsdp_remat"]):
        assert remat["history"] == plain["history"]
        assert _same_bits(remat["state_dict"], plain["state_dict"])


def test_fsdp_collectives_a_step_under_remat(runs):
    """The recompute runs while FSDP2 holds each block gathered for its
    backward: no collective is added to a step."""
    for counts, plain in zip(runs["collectives_remat"], runs["collectives"]):
        assert counts == plain


def test_fsdp_at_one_process_is_the_unsharded_model():
    """Without a process group the mesh has one rank and no group: the
    model trains unsharded, as under every strategy of the port."""
    from tfde_tpu_torch.models.vit import vit_tiny_test

    strat = FSDPStrategy()
    model = vit_tiny_test(device="cpu")
    assert strat.replicate(model) is model
    assert (strat.batch_divisor, strat.data_rank(), strat.data_group) == (
        1, 0, None)
    assert strat.describe() == "FSDPStrategy(mesh={'data': 1, 'fsdp': 1})"
