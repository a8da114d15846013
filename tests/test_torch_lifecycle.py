"""The port's Estimator lifecycle (tfde_tpu_torch.training.lifecycle)
against the JAX package's, on the CPU.

- Parity: the JAX `Estimator` and the port's train the same model from
  the same initial weights (the JAX init, `init_state(..., seed=0)`,
  carried over by `from_flax_params`) on the same `Dataset` batches, five
  sgd(0.05) steps, dropout off; then both evaluate a ragged test set.
  The port's fp32 run is held to two JAX runs of the same steps:
  - the JAX package's fp32 run: every step's loss and accuracy (from the
    summaries each writes every step) within 2e-5, the eval loss within
    1e-5 relative and the accuracy exactly; grad_norm within 5e-5
    relative, the parameters within 2e-6 (PlainCNN) and 1.5e-4
    (BatchNormCNN), the running statistics within 2e-5;
  - the anchor: the same JAX model with `dtype=float64` under
    `jax.enable_x64`, which computes in fp64 (its parameters stay fp32
    and its last Dense computes in fp32, as the model fixes them). Losses,
    parameters and running statistics within 1e-6, grad_norm within 1e-6
    relative.
  Why 1.5e-4 for the fp32 pair: in BatchNormCNN the first BatchNorm's
  fast variance E[x^2] - E[x]^2 cancels in fp32, and on these batches the
  JAX package's fp32 run itself ends about 7e-5 from the anchor in its
  parameters (tests/test_torch_train_dp.py). The test holds that JAX run
  to the anchor within the same 1.5e-4, so the loose bound stays tied to
  the JAX run's own error; the port is held to the anchor at 1e-6 (both
  distances print under ``pytest -s -k match``). At one
  process against one JAX device, and at two gloo ranks under
  `AutoShardPolicy.OFF` against `MultiWorkerMirroredStrategy` over two
  JAX CPU devices: there a batch sliced twice (the feed's rows cut again
  by the step) would train on a quarter of the batch and fail. One anchor
  run, on one JAX device, serves both.
- Resume skips completed steps; evaluate's full-pass weighting over a
  ragged last batch; evaluate and predict from a checkpoint after a
  restart, and the error with neither state nor checkpoint;
  train_and_evaluate inline (throttle 0) and from_checkpoint;
  continuous_eval as a standalone evaluator job.
- The custom-loss lifecycle with a tiny GPT: resume bit-exact against an
  uninterrupted run, grad_accum, and the refusals without eval_fn or
  above one rank.
- Every option that is not ported raises NotImplementedError.
- Preemption (SIGTERM, the guard): tests/test_torch_preemption.py.
- The TensorBoard writer: the CRC-32C known vectors, and the event file
  parsed back by hand (tests/test_tensorboard.py).
"""

import functools
import glob
import os
import struct
import tempfile
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tfde_tpu.data import datasets as jdatasets
from tfde_tpu.data.pipeline import AutoShardPolicy as JPolicy
from tfde_tpu.data.pipeline import Dataset as JDataset
from tfde_tpu.models import cnn as jcnn
from tfde_tpu.parallel.strategies import (
    MultiWorkerMirroredStrategy as JMirrored)
from tfde_tpu.runtime.mesh import make_mesh
from tfde_tpu.training import lifecycle as jlife
from tfde_tpu.training.step import init_state as j_init_state
from tfde_tpu_torch import testing
from tfde_tpu_torch.checkpoint.manager import CheckpointManager
from tfde_tpu_torch.data import AutoShardPolicy, Dataset
from tfde_tpu_torch.export.serving import FinalExporter
from tfde_tpu_torch.models.cnn import BatchNormCNN, PlainCNN
from tfde_tpu_torch.models.flax_weights import from_flax_params
from tfde_tpu_torch.models.gpt import gpt_tiny_test, next_token_loss
from tfde_tpu_torch.observability import tensorboard as tb
from tfde_tpu_torch.parallel.strategies import (
    MultiWorkerMirroredStrategy, Strategy)
from tfde_tpu_torch.runtime.mesh import LocalMesh
from tfde_tpu_torch.training import (
    Estimator, EvalSpec, RunConfig, TrainSpec, continuous_eval,
    train_and_evaluate)
from tfde_tpu_torch.training.optimizers import adamw, sgd
from tfde_tpu_torch.training.step import make_eval_step, pad_batch_for_mesh

STEPS, BATCH, EVAL_BATCH, LR = 5, 64, 50, 0.05
ATOL, GRAD_RTOL, ANCHOR_TOL = 2e-5, 5e-5, 1e-6
PARAM_ATOL = {"BatchNormCNN": 1.5e-4, "PlainCNN": 2e-6}

(_TX, _TY), (_EX, _EY) = jdatasets.mnist(flatten=True, n_train=512,
                                         n_test=128)


def _train_fn(ds_cls=Dataset, batch=BATCH):
    return (ds_cls.from_tensor_slices((_TX, _TY)).shuffle(len(_TX), seed=0)
            .repeat().batch(batch, drop_remainder=True))


def _eval_fn(ds_cls=Dataset, batch=EVAL_BATCH):
    """128 test images in batches of 50: 50 + 50 + 28."""
    return ds_cls.from_tensor_slices((_EX, _EY)).batch(batch)


def _local():
    return MultiWorkerMirroredStrategy(mesh=LocalMesh(("data",)))


def _model(name, seed=0):
    return (BatchNormCNN(dropout_rate=0.0, device="cpu", seed=seed)
            if name == "BatchNormCNN" else PlainCNN(device="cpu", seed=seed))


def _estimator(name, model_dir=None, seed=0, every=5, lr=0.1, **cfg):
    model = _model(name, seed)
    return Estimator(model, sgd(model, lr), _local(),
                     RunConfig(model_dir=model_dir,
                               save_checkpoints_steps=every, **cfg))


# -- TensorBoard event files, read back by hand ------------------------------
def _records(path):
    with open(path, "rb") as f:
        data = f.read()
    out, off = [], 0
    while off < len(data):
        (length,) = struct.unpack_from("<Q", data, off)
        (len_crc,) = struct.unpack_from("<I", data, off + 8)
        assert len_crc == tb._masked_crc(data[off:off + 8])
        payload = data[off + 12:off + 12 + length]
        (crc,) = struct.unpack_from("<I", data, off + 12 + length)
        assert crc == tb._masked_crc(payload)
        out.append(payload)
        off += 12 + length + 4
    return out


def _varint(b, i):
    n = shift = 0
    while True:
        c = b[i]
        i += 1
        n |= (c & 0x7F) << shift
        shift += 7
        if not c & 0x80:
            return n, i


def _fields(msg):
    i = 0
    while i < len(msg):
        key, i = _varint(msg, i)
        field, wire = key >> 3, key & 7
        if wire == 0:
            v, i = _varint(msg, i)
        elif wire == 1:
            v, i = msg[i:i + 8], i + 8
        elif wire == 5:
            v, i = msg[i:i + 4], i + 4
        else:
            n, i = _varint(msg, i)
            v, i = msg[i:i + n], i + n
        yield field, v


def _scalars(logdir):
    """{step: {tag: value}} of every event file directly in `logdir`."""
    out = {}
    for path in glob.glob(os.path.join(logdir, "events.out.tfevents.*")):
        for rec in _records(path):
            step, values = 0, {}
            for f, v in _fields(rec):
                if f == 2:
                    step = v
                elif f == 5:
                    for _, value in _fields(v):
                        kv = dict(_fields(value))
                        values[kv[1].decode()] = struct.unpack("<f", kv[2])[0]
            if values:
                out.setdefault(step, {}).update(values)
    return out


# -- parity with the JAX Estimator -------------------------------------------
def _jax_run(name, devices, model_dir, fp64=False):
    """The JAX Estimator's run: (initial state_dict in torch names, the
    per-step summaries, the final state_dict, the eval metrics). With
    `fp64` the model computes in fp64 under x64 (the anchor) and the run
    does not evaluate."""
    strat = JMirrored(mesh=make_mesh({"data": devices},
                                     devices=jax.devices()[:devices]))
    dtype = jnp.float64 if fp64 else jnp.float32
    model = (jcnn.BatchNormCNN(dropout_rate=0.0, dtype=dtype)
             if name == "BatchNormCNN" else jcnn.PlainCNN(dtype=dtype))

    def state_dict(s):
        return {k: v.numpy() for k, v in from_flax_params(
            jax.tree.map(np.asarray, s.params),
            jax.tree.map(np.asarray, s.batch_stats) or None).items()}

    with jax.enable_x64(fp64):
        init, _ = j_init_state(model, optax.sgd(LR), strat,
                               jnp.zeros((BATCH, 784)), seed=0)
        est = jlife.Estimator(model, optax.sgd(LR), strategy=strat,
                              config=jlife.RunConfig(
                                  model_dir=model_dir, save_summary_steps=1,
                                  save_checkpoints_steps=None,
                                  log_step_count_steps=1000))
        state = est.train(lambda: _train_fn(JDataset), STEPS,
                          shard_policy=JPolicy.OFF)
        metrics = None if fp64 else est.evaluate(lambda: _eval_fn(JDataset))
        est.close()
    return state_dict(init), _scalars(model_dir), state_dict(state), metrics


@functools.cache
def _anchor(name):
    """The anchor run of `name`, on one JAX device: in fp64 the device count
    changes nothing the tolerances can see, so one run serves both ranks."""
    with tempfile.TemporaryDirectory() as d:
        return _jax_run(name, 1, d, fp64=True)


def _jax_runs(name, devices, tmp_path):
    """The JAX package's fp32 run over `devices` and the anchor, from the
    same weights."""
    want = _jax_run(name, devices, str(tmp_path / "jax"))
    anchor = _anchor(name)
    for k, v in want[0].items():
        assert np.array_equal(anchor[0][k], v), k
    # the JAX fp32 run's own error fits the bound its pair is held to
    _assert_params(want[2], anchor[2], PARAM_ATOL[name], ANCHOR_TOL)
    print(f"{name} at {devices} JAX device(s): the JAX fp32 run's "
          f"parameters lie {_max_param_diff(want[2], anchor[2]):.2e} from "
          f"the anchor")
    return want, anchor


def _max_param_diff(got, want):
    return max(float(np.max(np.abs(np.float64(got[k]) - want[k])))
               for k in want if not k.endswith(("running_mean", "running_var")))


def _assert_params(got, want, atol, stat_atol):
    assert set(got) == set(want)
    for k, w in want.items():
        stat = k.endswith(("running_mean", "running_var"))
        np.testing.assert_allclose(got[k], w, rtol=0, err_msg=k,
                                   atol=stat_atol if stat else atol)


def _assert_matches(name, got_scalars, got_params, got_eval, want, anchor):
    _, want_scalars, want_params, want_eval = want
    _, anchor_scalars, anchor_params, _ = anchor
    assert sorted(got_scalars) == sorted(want_scalars) == sorted(
        anchor_scalars) == list(range(1, STEPS + 1))
    for step, w in want_scalars.items():
        got, a = got_scalars[step], anchor_scalars[step]
        for k in ("loss", "accuracy"):
            np.testing.assert_allclose(got[k], w[k], rtol=0, atol=ATOL,
                                       err_msg=f"{k} {step}")
            np.testing.assert_allclose(got[k], a[k], rtol=0, atol=ANCHOR_TOL,
                                       err_msg=f"{k} {step}")
        np.testing.assert_allclose(got["grad_norm"], w["grad_norm"],
                                   rtol=GRAD_RTOL, err_msg=f"grad_norm {step}")
        np.testing.assert_allclose(got["grad_norm"], a["grad_norm"],
                                   rtol=ANCHOR_TOL, err_msg=f"grad_norm {step}")
    _assert_params(got_params, want_params, PARAM_ATOL[name], ATOL)
    _assert_params(got_params, anchor_params, ANCHOR_TOL, ANCHOR_TOL)
    print(f"{name}: the port's parameters lie "
          f"{_max_param_diff(got_params, anchor_params):.2e} from the anchor")
    np.testing.assert_allclose(got_eval["loss"], want_eval["loss"], rtol=1e-5)
    assert got_eval["accuracy"] == pytest.approx(want_eval["accuracy"],
                                                 abs=1e-9)


@pytest.mark.parametrize("name", ["PlainCNN", "BatchNormCNN"])
def test_estimator_matches_jax_at_one_rank(name, tmp_path):
    want, anchor = _jax_runs(name, 1, tmp_path)
    model = _model(name, seed=1)
    model.load_state_dict({k: torch.as_tensor(v) for k, v in want[0].items()})
    est = Estimator(model, sgd(model, LR), _local(),
                    RunConfig(model_dir=str(tmp_path / "port"),
                              save_summary_steps=1, save_checkpoints_steps=None))
    state = est.train(_train_fn, STEPS, shard_policy=AutoShardPolicy.OFF)
    got_eval = est.evaluate(_eval_fn)
    est.close()
    assert state.step == STEPS
    _assert_matches(name, _scalars(str(tmp_path / "port")),
                    {k: v.numpy() for k, v in model.state_dict().items()},
                    got_eval, want, anchor)


def test_two_gloo_ranks_match_jax_over_two_devices(tmp_path):
    want, anchor = _jax_runs("BatchNormCNN", 2, tmp_path)
    args = (2, str(tmp_path / "store"), "BatchNormCNN", want[0], (_TX, _TY),
            BATCH, STEPS, LR, str(tmp_path / "port"), (_EX, _EY), EVAL_BATCH)
    out = testing.run_ranks(testing.estimator_worker, [args] * 2)
    for got in out:
        _assert_matches("BatchNormCNN", _scalars(str(tmp_path / "port")),
                        got["state_dict"], got["eval"], want, anchor)
    assert out[0]["eval"] == out[1]["eval"]
    for k, v in out[0]["state_dict"].items():
        assert np.array_equal(v, out[1]["state_dict"][k]), k


# -- the lifecycle -----------------------------------------------------------
def test_resume_skips_completed_steps(tmp_path):
    d = str(tmp_path / "run")
    est1 = _estimator("PlainCNN", d)
    est1.train(_train_fn, 7)
    est1.close()
    trained = {k: v.clone() for k, v in est1.model.state_dict().items()}
    assert CheckpointManager(os.path.join(d, "checkpoints")).all_steps() == [
        5, 7]

    est2 = _estimator("PlainCNN", d, seed=3)  # a restarted process
    state = est2.train(_train_fn, 7)  # already done: nothing to do
    assert state.step == 7
    for k, v in est2.model.state_dict().items():
        assert torch.equal(v, trained[k]), k
    assert est2.train(_train_fn, 10).step == 10
    est2.close()


def test_evaluate_full_pass_weighting():
    """Batches of 50 over 128 images (50 + 50 + 28) give the metrics of
    one batch of all 128."""
    est = _estimator("BatchNormCNN", None)
    state = est.train(_train_fn, 3)
    m = est.evaluate(_eval_fn)
    sums = make_eval_step(_local(), state)(
        state, pad_batch_for_mesh((_EX, _EY), 1))
    assert float(sums["weight"]) == 128
    np.testing.assert_allclose(m["loss"], float(sums["loss_sum"]) / 128,
                               rtol=1e-6)
    assert m["accuracy"] == float(sums["correct_sum"]) / 128
    assert est.evaluate(_eval_fn, steps=1) != m


def test_evaluate_and_predict_from_checkpoint_after_restart(tmp_path):
    d = str(tmp_path / "run")
    est1 = _estimator("BatchNormCNN", d)
    est1.train(_train_fn, 6)
    want = est1.evaluate(_eval_fn)
    probs1 = next(iter(est1.predict(_eval_fn)))
    est1.close()

    est2 = _estimator("BatchNormCNN", d, seed=3)  # restart
    assert est2.evaluate(_eval_fn) == want
    probs = next(iter(est2.predict(_eval_fn)))
    assert probs.shape == (50, 10)
    np.testing.assert_allclose(probs.sum(-1), 1.0, rtol=1e-5)
    assert np.array_equal(probs, probs1)
    est2.close()


def test_evaluate_without_state_or_checkpoint_errors(tmp_path):
    est = _estimator("PlainCNN", None)
    with pytest.raises(RuntimeError, match="no checkpoint"):
        est.evaluate(_eval_fn)
    est = _estimator("PlainCNN", str(tmp_path / "empty"))
    with pytest.raises(RuntimeError, match="no checkpoint"):
        next(iter(est.predict(_eval_fn)))


def test_train_and_evaluate_inline(tmp_path):
    d = str(tmp_path / "run")
    est = _estimator("BatchNormCNN", d, save_summary_steps=2)
    state, metrics = train_and_evaluate(
        est, TrainSpec(_train_fn, 4),
        EvalSpec(_eval_fn, start_delay_secs=0, throttle_secs=0))
    assert state.step == 4
    assert metrics == est.evaluate(_eval_fn)
    evals = _scalars(os.path.join(d, "eval"))
    assert sorted(evals) == [1, 2, 3, 4]  # throttle 0: after every step
    assert set(evals[4]) == {"loss", "accuracy"}
    assert sorted(_scalars(d)) == [2, 4]
    est.close()


def test_train_and_evaluate_from_checkpoint(tmp_path):
    d = str(tmp_path / "run")
    est = _estimator("BatchNormCNN", d)
    state, metrics = train_and_evaluate(
        est, TrainSpec(_train_fn, 12),
        EvalSpec(_eval_fn, start_delay_secs=0, throttle_secs=0.05),
        eval_mode="from_checkpoint")
    assert state.step == 12
    # the evaluator's last eval is of the final (force-saved) checkpoint
    assert metrics == est.evaluate(_eval_fn)
    assert 12 in _scalars(os.path.join(d, "eval"))
    est.close()
    with pytest.raises(ValueError, match="model_dir"):
        train_and_evaluate(_estimator("PlainCNN", None), TrainSpec(
            _train_fn, 2), EvalSpec(_eval_fn), eval_mode="from_checkpoint")


def test_continuous_eval_standalone_evaluator_job(tmp_path):
    d = str(tmp_path / "run")
    trainer = _estimator("PlainCNN", d)
    trainer.train(_train_fn, 10)
    want = trainer.evaluate(_eval_fn)
    trainer.close()
    evaluator = _estimator("PlainCNN", d, seed=3)
    step, metrics = continuous_eval(evaluator, EvalSpec(
        _eval_fn, throttle_secs=0.05), stop_after_step=10)
    evaluator.close()
    assert step == 10 and metrics == want


# -- the custom-loss lifecycle (tiny GPT) ------------------------------------
_TOKENS = np.random.default_rng(0).integers(0, 97, (64, 16)).astype(np.int64)


def _tokens_fn():
    return (Dataset.from_tensor_slices((_TOKENS,)).shuffle(64, seed=0)
            .repeat().batch(8, drop_remainder=True))


def _gpt_eval(model, batch, generator):
    loss, metrics = next_token_loss(model, batch, generator)
    return {"loss": loss, **metrics}


def _gpt_estimator(model_dir, grad_accum=1, eval_fn=_gpt_eval, every=2):
    model = gpt_tiny_test(device="cpu", seed=0)
    return Estimator(model, adamw(model, 1e-2), _local(),
                     RunConfig(model_dir=model_dir,
                               save_checkpoints_steps=every),
                     loss_fn=next_token_loss, eval_fn=eval_fn,
                     grad_accum=grad_accum)


def test_custom_loss_lifecycle_resumes_bit_exact(tmp_path):
    whole = _gpt_estimator(None)
    whole.train(_tokens_fn, 6)
    d = str(tmp_path / "run")
    first = _gpt_estimator(d)
    first.train(_tokens_fn, 4)
    first.close()
    resumed = _gpt_estimator(d)

    def skipping():  # the stream of an uninterrupted run, from step 4
        it = iter(_tokens_fn())
        for _ in range(4):
            next(it)
        return it

    assert resumed.train(skipping, 6).step == 6
    for k, v in whole.model.state_dict().items():
        assert torch.equal(v, resumed.model.state_dict()[k]), k
    m = resumed.evaluate(lambda: Dataset.from_tensor_slices((_TOKENS,))
                         .batch(24))
    assert set(m) == {"loss", "next_token_accuracy"}
    assert np.isfinite(m["loss"]) and m["loss"] < np.log(97)
    resumed.close()


def test_custom_loss_grad_accum():
    one, two = _gpt_estimator(None), _gpt_estimator(None, grad_accum=2)
    one.train(_tokens_fn, 3)
    two.train(_tokens_fn, 3)
    for k, v in one.model.state_dict().items():
        np.testing.assert_allclose(two.model.state_dict()[k].numpy(),
                                   v.numpy(), atol=1e-5, rtol=0, err_msg=k)
    assert float(one.metrics["loss"]) == pytest.approx(
        float(two.metrics["loss"]), abs=1e-5)


def test_custom_loss_refusals(tmp_path):
    est = _gpt_estimator(None, eval_fn=None)
    with pytest.raises(RuntimeError, match="needs eval_fn"):
        train_and_evaluate(est, TrainSpec(_tokens_fn, 2),
                           EvalSpec(_tokens_fn))
    est.train(_tokens_fn, 1)
    with pytest.raises(RuntimeError, match="needs eval_fn"):
        est.evaluate(_tokens_fn)
    two = Strategy(mesh=types.SimpleNamespace(mesh_dim_names=("data",),
                                              shape=(2,)))
    model = gpt_tiny_test(device="cpu")
    with pytest.raises(NotImplementedError, match="one device"):
        Estimator(model, adamw(model, 1e-2), two, loss_fn=next_token_loss)


# -- what is not ported ------------------------------------------------------
@pytest.mark.parametrize("field,value", [
    ("profile_steps", (2, 4)), ("metrics_port", 0),
    ("metrics_push_url", "http://chief:9100/push"),
    ("metrics_push_interval", 1.0), ("sentry", True),
    ("grad_transport", "int8"), ("opt_sharding", "shard")])
def test_unported_run_config_fields_raise(field, value):
    with pytest.raises(NotImplementedError, match=field.split("_")[0]):
        RunConfig(**{field: value})


def test_unported_estimator_options_raise(tmp_path):
    with pytest.raises(NotImplementedError, match="savedmodel"):
        FinalExporter("exporter", (None, 784), savedmodel=True)
    model = PlainCNN(device="cpu")
    with pytest.raises(NotImplementedError,
                       match="'LoRA through the Estimator'"):
        Estimator(model, sgd(model, 0.1), _local(), lora=object(),
                  lora_base_params={})
    est = Estimator(model, sgd(model, 0.1), _local(),
                    eval_strategy=Strategy(mesh=LocalMesh(("data",))))
    est.train(_train_fn, 1)
    with pytest.raises(NotImplementedError, match="mirrored"):
        est.evaluate(_eval_fn)


# -- TensorBoard -------------------------------------------------------------
def test_crc32c_known_vectors():
    assert tb.crc32c(b"\x00" * 32) == 0x8A9136AA  # RFC 3720
    assert tb.crc32c(b"123456789") == 0xE3069283


def test_event_file_structure(tmp_path):
    w = tb.SummaryWriter(str(tmp_path))
    w.scalars(10, {"loss": 0.5, "accuracy": 0.9})
    w.scalar(20, "loss", 0.25)
    w.close()
    (path,) = glob.glob(str(tmp_path / "events.out.tfevents.*"))
    records = _records(path)
    assert len(records) == 3 and b"brain.Event:2" in records[0]
    assert _scalars(str(tmp_path)) == {
        10: {"loss": 0.5, "accuracy": pytest.approx(0.9, abs=1e-7)},
        20: {"loss": 0.25}}
