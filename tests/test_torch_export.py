"""The port's serving export (tfde_tpu_torch.export.serving over
`torch.export`), its model summary and TensorBoard launcher, on the CPU.

- Round trip: a BatchNormCNN (running statistics moved off 0 and 1)
  exported and loaded on the CPU serves batches of 1, 7 and 128 from one
  artifact (the batch dim is symbolic), equal to the live model's softmax
  within 1e-6; `load_serving` on the parent directory resolves the newest
  timestamp; two exports in one second get two directories; the
  signature has the JAX keys with the port's framework and platforms;
  params.npz holds the state_dict; an int-signature export of the tiny
  GPT serves [N, 16] tokens on the CPU.
- Parity with the JAX package: the port's artifact and the JAX
  `export_serving` artifact of the same BatchNormCNN weights (the JAX
  init and moved statistics, carried over by `from_flax_params`) give the
  same probabilities within 1e-5.
- BestExporter: inline (an eval after every step) and
  eval_mode='from_checkpoint', the newest artifact being the one
  best_metric.json names; an unknown metric raises; a NaN is never
  written as the bar; only strict improvements export; a gated exporter
  with no metrics is skipped.
- What is refused: a generative artifact, FinalExporter(savedmodel=True).
- `model_summary` totals equal the JAX table's (BatchNormCNN 250,466
  parameters and 484 non-trainable values; PlainCNN 347,146), and
  `start_tensorboard` logs the command line when TensorBoard cannot
  start.
"""

import json
import logging
import os
import re
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfde_tpu.export.serving import export_serving as j_export_serving
from tfde_tpu.export.serving import load_serving as j_load_serving
from tfde_tpu.models import cnn as jcnn
from tfde_tpu.utils import model_summary as j_model_summary
from tfde_tpu_torch.data import Dataset
from tfde_tpu_torch.data.datasets import mnist
from tfde_tpu_torch.export import (
    BestExporter, FinalExporter, export_serving, load_serving)
from tfde_tpu_torch.models.cnn import BatchNormCNN, PlainCNN
from tfde_tpu_torch.models.flax_weights import from_flax_params
from tfde_tpu_torch.models.gpt import gpt_tiny_test
from tfde_tpu_torch.observability.tb_server import start_tensorboard
from tfde_tpu_torch.parallel.strategies import MultiWorkerMirroredStrategy
from tfde_tpu_torch.runtime.mesh import LocalMesh
from tfde_tpu_torch.training import (
    Estimator, EvalSpec, RunConfig, TrainSpec, train_and_evaluate)
from tfde_tpu_torch.training.optimizers import sgd
from tfde_tpu_torch.utils.summary import model_summary
from tfde_tpu_torch.testing import one_thread

#: one intra-op torch thread for the module (`testing.one_thread`)
_one_thread = pytest.fixture(autouse=True, scope="module")(one_thread)

#: served probabilities against the live model on the CPU: the same
#: operations, traced
LIVE_ATOL = 1e-6
#: the port's artifact against the JAX package's (ROADMAP: 1e-5)
JAX_ATOL = 1e-5

(_TX, _TY), (_EX, _EY) = mnist(flatten=True, n_train=256, n_test=64)


def _bn_model(seed=0):
    """BatchNormCNN with running statistics away from 0 and 1."""
    model = BatchNormCNN(dropout_rate=0.0, device="cpu", seed=seed)
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, b in model.named_buffers():
            b.copy_(torch.as_tensor(rng.uniform(0.2, 1.0, b.shape),
                                    dtype=b.dtype))
    return model


def _live(model, x):
    with torch.no_grad():
        return torch.softmax(model(torch.as_tensor(x)), dim=-1).numpy()


def test_round_trip_serves_any_batch_size_and_the_newest(tmp_path):
    old, new = _bn_model(0), _bn_model(1)
    first = export_serving(old, (None, 784), str(tmp_path))
    second = export_serving(new, (None, 784), str(tmp_path))
    assert first != second
    assert int(os.path.basename(second)) > int(os.path.basename(first))
    served = load_serving(str(tmp_path), device="cpu")
    x = np.random.default_rng(0).random((128, 784), np.float32)
    for n in (1, 7, 128):
        probs = served.predict(x[:n])
        assert probs.shape == (n, 10)
        np.testing.assert_allclose(probs, _live(new, x[:n]), atol=LIVE_ATOL,
                                   rtol=0)
    assert served.signature == {
        "input": {"shape": [None, 784], "dtype": "float32"},
        "output": {"shape": [None, 10], "dtype": "float32"},
        "apply_softmax": True, "platforms": ["cpu", "cuda"],
        "framework": "tfde_tpu_torch"}
    assert sorted(os.listdir(second)) == ["model.pt2", "params.npz",
                                          "signature.json"]
    flat = {f"{kind}/{k}": v for kind in ("params", "buffers")
            for k, v in _flat(served.params[kind]).items()}
    want = {("buffers/" if "running" in k else "params/")
            + k.replace(".", "/"): v.numpy()
            for k, v in new.state_dict().items()}
    assert set(flat) == set(want)
    for k, v in want.items():
        assert np.array_equal(flat[k], v), k
    logits = load_serving(first, device="cpu")
    np.testing.assert_allclose(logits.predict(x[:3]), _live(old, x[:3]),
                               atol=LIVE_ATOL, rtol=0)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        name = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, name) if isinstance(v, dict) else {name: v})
    return out


def test_logits_and_an_int_signature_of_the_tiny_gpt(tmp_path):
    model = gpt_tiny_test(device="cpu")
    out = export_serving(model, (None, 16), str(tmp_path),
                         input_dtype=torch.int64, apply_softmax=False)
    served = load_serving(out, device="cpu")
    assert served.signature["input"] == {"shape": [None, 16],
                                         "dtype": "int64"}
    assert served.signature["output"] == {"shape": [None, 16, 97],
                                          "dtype": "float32"}
    tokens = np.random.default_rng(0).integers(0, 97, (3, 16))
    with torch.no_grad():
        want = model(torch.as_tensor(tokens)).numpy()
    np.testing.assert_allclose(served.predict(tokens), want, atol=LIVE_ATOL,
                               rtol=0)


def test_export_matches_the_jax_artifact(tmp_path):
    jmodel = jcnn.BatchNormCNN()
    variables = jmodel.init(jax.random.key(0), jnp.zeros((1, 784)),
                            train=False)
    rng = np.random.default_rng(3)
    variables = {"params": variables["params"],
                 "batch_stats": jax.tree.map(
                     lambda a: a + jnp.asarray(rng.uniform(0.2, 1.0, a.shape),
                                               jnp.float32),
                     variables["batch_stats"])}
    j_out = j_export_serving(
        lambda v, x: jmodel.apply(v, x, train=False), variables, (None, 784),
        str(tmp_path / "jax"))
    model = BatchNormCNN(device="cpu")
    model.load_state_dict(from_flax_params(
        jax.tree.map(np.asarray, variables["params"]),
        jax.tree.map(np.asarray, variables["batch_stats"])))
    out = export_serving(model, (None, 784), str(tmp_path / "port"))
    x = np.random.default_rng(0).random((64, 784), np.float32)
    want = j_load_serving(j_out).predict(x)
    got = load_serving(out, device="cpu").predict(x)
    print(f"port artifact vs JAX artifact: max abs "
          f"{np.abs(got - want).max():.3e}")
    np.testing.assert_allclose(got, want, atol=JAX_ATOL, rtol=0)
    assert np.array_equal(got.argmax(-1), want.argmax(-1))


def _estimator(model_dir, save_every=None):
    model = BatchNormCNN(dropout_rate=0.0, device="cpu")
    return Estimator(model, sgd(model, 0.05),
                     MultiWorkerMirroredStrategy(mesh=LocalMesh(("data",))),
                     RunConfig(model_dir=model_dir,
                               save_checkpoints_steps=save_every,
                               log_step_count_steps=1000))


def _specs(exporters, steps, throttle=0.0):
    train = TrainSpec(lambda: Dataset.from_tensor_slices((_TX, _TY))
                      .shuffle(256, seed=0).repeat()
                      .batch(32, drop_remainder=True), steps)
    ev = EvalSpec(lambda: Dataset.from_tensor_slices((_EX, _EY)).batch(32),
                  exporters=exporters, start_delay_secs=0.0,
                  throttle_secs=throttle)
    return train, ev


def _artifacts(directory):
    return sorted((d for d in os.listdir(directory) if d.isdigit()), key=int)


def _assert_newest_is_best(directory):
    with open(os.path.join(directory, "best_metric.json")) as f:
        bar = json.load(f)
    newest = os.path.join(directory, _artifacts(directory)[-1])
    assert bar["artifact"] == newest and bar["metric"] == "loss"
    return bar


def test_best_exporter_inline(tmp_path):
    est = _estimator(str(tmp_path))
    train, ev = _specs([BestExporter("best", (None, 784)),
                        FinalExporter("final", (None, 784))], 4)
    _, metrics = train_and_evaluate(est, train, ev)
    est.close()
    best = str(tmp_path / "export" / "best")
    bar = _assert_newest_is_best(best)
    # an eval after each of the 4 steps and the final one: each strict
    # improvement exported, the final eval repeating step 4's exported none
    assert 1 <= len(_artifacts(best)) <= 4
    assert bar["value"] <= metrics["loss"]
    assert len(_artifacts(str(tmp_path / "export" / "final"))) == 1
    served = load_serving(best, device="cpu")
    np.testing.assert_allclose(served.predict(_EX[:5]),
                               _live(est.model, _EX[:5]), atol=LIVE_ATOL,
                               rtol=0)


def test_best_exporter_from_checkpoint(tmp_path):
    est = _estimator(str(tmp_path), save_every=2)
    train, ev = _specs([BestExporter("best", (None, 784))], 6, throttle=0.05)
    _, metrics = train_and_evaluate(est, train, ev,
                                    eval_mode="from_checkpoint")
    est.close()
    best = str(tmp_path / "export" / "best")
    bar = _assert_newest_is_best(best)
    assert np.isfinite(bar["value"]) and metrics


def test_best_exporter_gates(tmp_path):
    model, d = _bn_model(), str(tmp_path)
    exporter = BestExporter("b", (None, 784))
    with pytest.raises(ValueError, match="monitors 'loss'"):
        exporter.maybe_export(d, model, {"accuracy": 0.5})
    assert exporter.maybe_export(d, model, {"loss": float("nan")}) is None
    assert not os.path.exists(os.path.join(d, "export", "b"))
    first = exporter.maybe_export(d, model, {"loss": 1.0})
    assert exporter.maybe_export(d, model, {"loss": float("nan")}) is None
    assert exporter.maybe_export(d, model, {"loss": 1.0}) is None
    second = exporter.maybe_export(d, model, {"loss": 0.5})
    assert first and second and second != first
    assert _assert_newest_is_best(os.path.join(d, "export", "b"))[
        "value"] == 0.5
    higher = BestExporter("h", (None, 784), metric="accuracy",
                          higher_is_better=True)
    assert higher.maybe_export(d, model, {"accuracy": 0.5})
    assert higher.maybe_export(d, model, {"accuracy": 0.4}) is None
    est = _estimator(d)
    est.train(_specs([], 1)[0].input_fn, 1)
    assert est.export_saved_model(exporter) is None  # gated, no metrics
    assert est.export_saved_model(FinalExporter("f", (None, 784)))
    est.close()


def test_refused_artifacts_and_options(tmp_path):
    out = export_serving(_bn_model(), (None, 784), str(tmp_path))
    with open(os.path.join(out, "signature.json")) as f:
        sig = json.load(f)
    sig["kind"] = "generate"
    with open(os.path.join(out, "signature.json"), "w") as f:
        json.dump(sig, f)
    with pytest.raises(ValueError, match="generative"):
        load_serving(str(tmp_path), device="cpu")
    with pytest.raises(NotImplementedError, match="tensorflow"):
        FinalExporter("e", (None, 784), savedmodel=True)
    with pytest.raises(FileNotFoundError):
        load_serving(str(tmp_path / "none"), device="cpu")


def _totals(table):
    total = int(re.search(r"Total params: ([\d,]+)", table)[1]
                .replace(",", ""))
    extra = re.search(r"\n\w+: ([\d,]+) \(.*non-trainable", table)
    return total, int(extra[1].replace(",", "")) if extra else 0


@pytest.mark.parametrize("name,params,stats", [
    ("BatchNormCNN", 250_466, 484), ("PlainCNN", 347_146, 0)])
def test_model_summary_totals_match_jax(name, params, stats):
    jmodel = getattr(jcnn, name)()
    model = (BatchNormCNN(device="cpu") if name == "BatchNormCNN"
             else PlainCNN(device="cpu"))
    got = model_summary(model, torch.zeros(128, 784))
    assert _totals(got) == _totals(j_model_summary(
        jmodel, jnp.zeros((128, 784)))) == (params, stats)
    assert got.startswith(f'Model: "{name}"')
    assert "Dense_0/weight" in got


def test_start_tensorboard_logs_the_command(monkeypatch, caplog):
    broken = types.ModuleType("tensorboard")
    monkeypatch.setitem(sys.modules, "tensorboard", broken)
    monkeypatch.setitem(sys.modules, "tensorboard.program", None)
    monkeypatch.setenv("TB_PORT", "6123")
    with caplog.at_level(logging.INFO):
        assert start_tensorboard("/tmp/logs") is None
        assert start_tensorboard("/tmp/logs", port=7000) is None
    text = caplog.text
    assert "tensorboard --logdir=/tmp/logs --port=6123" in text
    assert "--port=7000" in text
