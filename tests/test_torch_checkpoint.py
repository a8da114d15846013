"""The port's checkpoint manager (tfde_tpu_torch.checkpoint.manager), the
counterpart of tfde_tpu/checkpoint/manager.py, on the CPU.

- Round trip: a BatchNormCNN after three sgd(momentum 0.9) or adamw steps
  restores into a model and optimizer of other values with the same bits
  in every parameter, BatchNorm running statistic and optimizer state
  tensor (momentum; adamw's moments and counts), and the step; then both
  take the same next step bit for bit. A checkpoint
  written before the first step (no momentum buffer yet: torch makes it
  lazily) restores too.
- The commit protocol: a leftover ``<step>.tmp-<pid>`` directory and a
  step directory without its file are not steps; `max_to_keep` removes
  the oldest; `save` of a step on disk returns False; `reload` sees
  another writer's steps; a failed write raises from `wait`.
- Structure errors name the first difference, as the JAX manager's
  structure check does (tests/test_checkpoint.py::
  test_structure_check_discriminates, ::test_optimizer_change_relabeled_
  with_guidance): an adamw checkpoint into sgd(momentum), a PlainCNN
  checkpoint into a BatchNormCNN.
- Two gloo ranks save (rank 0 writes, a barrier after), and one process
  restores the same bits.
"""

import os

import numpy as np
import pytest
import torch

from tfde_tpu_torch import testing
from tfde_tpu_torch.checkpoint.manager import (
    STATE_FILE, CheckpointManager, _first_difference)
from tfde_tpu_torch.data.datasets import mnist
from tfde_tpu_torch.models.cnn import BatchNormCNN, PlainCNN
from tfde_tpu_torch.parallel.strategies import MultiWorkerMirroredStrategy
from tfde_tpu_torch.runtime.mesh import LocalMesh
from tfde_tpu_torch.training.optimizers import adamw, sgd
from tfde_tpu_torch.training.step import init_state, make_train_step

(_X, _Y), _ = mnist(flatten=True, n_train=96, n_test=8)


def _batch(i):
    return _X[i * 32:(i + 1) * 32], _Y[i * 32:(i + 1) * 32]


def _state(seed=0, model_cls=BatchNormCNN, opt="sgd"):
    model = (model_cls(dropout_rate=0.0, device="cpu", seed=seed)
             if model_cls is BatchNormCNN else model_cls(device="cpu",
                                                         seed=seed))
    tx = (sgd(model, 0.05, momentum=0.9) if opt == "sgd"
          else adamw(model, 1e-3))
    return init_state(model, tx)


def _train(state, steps, first=0):
    step = make_train_step(MultiWorkerMirroredStrategy(
        mesh=LocalMesh(("data",))), state)
    for i in range(first, first + steps):
        step(state, _batch(i % 3))
    return state


def _assert_same(a, b):
    assert a.step == b.step
    sa, sb = a.model.state_dict(), b.model.state_dict()
    assert set(sa) == set(sb) and any(k.endswith("running_var") for k in sa)
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    pa, pb = list(a.model.parameters()), list(b.model.parameters())
    for p, q in zip(pa, pb):
        ea, eb = a.tx.state.get(p, {}), b.tx.state.get(q, {})
        assert set(ea) == set(eb)
        for name, v in ea.items():
            if isinstance(v, torch.Tensor):
                assert torch.equal(v, eb[name]), name
            else:
                assert v == eb[name], name


@pytest.mark.parametrize("opt", ["sgd", "adamw"])
def test_round_trip_then_the_same_next_step(tmp_path, opt):
    saved = _train(_state(opt=opt), 3)
    assert saved.tx.state  # the optimizer holds per-parameter state
    mngr = CheckpointManager(str(tmp_path))
    assert mngr.save(saved) and mngr.latest_step == 3
    mngr.wait()
    restored = _state(seed=1, opt=opt)
    assert CheckpointManager(str(tmp_path)).restore_latest(restored) is restored
    _assert_same(restored, saved)
    _assert_same(_train(restored, 1, 3), _train(saved, 1, 3))


def test_checkpoint_before_the_first_step(tmp_path):
    fresh = _state()
    mngr = CheckpointManager(str(tmp_path))
    mngr.save(fresh)
    mngr.wait()
    assert not fresh.tx.state  # no momentum buffer yet
    restored = _state(seed=1)
    mngr.restore_latest(restored)
    _assert_same(restored, fresh)
    _assert_same(_train(restored, 2), _train(fresh, 2))


def test_uncommitted_directories_are_not_steps(tmp_path):
    state = _train(_state(), 1)
    mngr = CheckpointManager(str(tmp_path))
    mngr.save(state)
    mngr.wait()
    os.makedirs(tmp_path / "7.tmp-12345")
    (tmp_path / "7.tmp-12345" / STATE_FILE).write_bytes(b"half a file")
    os.makedirs(tmp_path / "9")  # a step directory without its file
    again = CheckpointManager(str(tmp_path))
    assert again.latest_step == 1 and again.all_steps() == [1]
    restored = _state(seed=1)
    again.restore_latest(restored)
    _assert_same(restored, state)


def test_max_to_keep_save_twice_reload_and_errors(tmp_path):
    state = _state()
    mngr = CheckpointManager(str(tmp_path / "ckpt"), max_to_keep=2)
    assert CheckpointManager(str(tmp_path / "ckpt")).restore_latest(
        _state()) is None
    for i in range(4):
        _train(state, 1, i)
        assert mngr.save(state)
    assert not mngr.save(state)  # step 4 is there already
    mngr.wait()
    assert sorted(os.listdir(tmp_path / "ckpt")) == ["3", "4"]
    assert mngr.all_steps() == [3, 4]
    reader = CheckpointManager(str(tmp_path / "ckpt"))
    _train(state, 1, 4)
    mngr.save(state)
    mngr.wait()
    assert reader.latest_step == 4
    reader.reload()
    assert reader.latest_step == 5
    (tmp_path / "file").write_text("not a directory")
    broken = CheckpointManager(str(tmp_path / "file"))
    broken.save(state)
    with pytest.raises(RuntimeError, match="checkpoint write"):
        broken.wait()


def test_optimizer_change_is_named(tmp_path):
    mngr = CheckpointManager(str(tmp_path / "adamw"))
    mngr.save(_state(opt="adamw"))
    mngr.wait()
    with pytest.raises(ValueError, match=r"at optimizer\.param_groups \(2 "
                       r"saved, 1 live\).*optimizer configuration"):
        mngr.restore_latest(_state(seed=1))
    saved = torch.load(tmp_path / "adamw" / "0" / STATE_FILE,
                       weights_only=True)
    assert _first_difference(saved, _state(opt="adamw")) is None
    assert _first_difference(saved, _state()) is not None
    mngr = CheckpointManager(str(tmp_path / "sgd"))
    mngr.save(_state())
    mngr.wait()
    model = BatchNormCNN(dropout_rate=0.0, device="cpu")
    adam = init_state(model, torch.optim.Adam(model.parameters()), 1e-3)
    with pytest.raises(ValueError, match=r"at optimizer\.param_groups\[0\]"
                       r"\.amsgrad"):
        mngr.restore_latest(adam)


def test_model_change_is_named(tmp_path):
    mngr = CheckpointManager(str(tmp_path))
    mngr.save(_state(model_cls=PlainCNN))
    mngr.wait()
    with pytest.raises(ValueError, match=r"model\.Conv_0\.weight \(saved "
                       r"\(32, 1, 3, 3\)"):
        mngr.restore_latest(_state())


def test_two_gloo_ranks_save_and_one_process_restores(tmp_path):
    initial = {k: v.numpy() for k, v in BatchNormCNN(
        dropout_rate=0.0, device="cpu", seed=0).state_dict().items()}
    directory = str(tmp_path / "ckpt")
    out = testing.run_ranks(testing.checkpoint_worker, [
        (2, str(tmp_path / "store"), directory, initial, _batch(0), 3)] * 2)
    assert [o["saved"] for o in out] == [True, True]
    assert os.listdir(directory) == ["3"]
    restored = _state(seed=1)
    CheckpointManager(directory).restore_latest(restored)
    assert restored.step == 3
    for o in out:
        for k, v in restored.model.state_dict().items():
            assert np.array_equal(v.numpy(), o["state_dict"][k]), k
        for p, m in zip(restored.model.parameters(), o["momentum"]):
            assert np.array_equal(
                restored.tx.state[p]["momentum_buffer"].numpy(), m)
