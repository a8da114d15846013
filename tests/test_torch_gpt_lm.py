"""The slice as a whole: `python -m tfde_tpu_torch.gpt_lm` with the rope,
GQA, sliding-window and remat flags, and with `--packed`, against the
JAX example `examples/gpt_lm.py` given the same flags.

Both entry points build the same synthetic corpus (and the same packed
rows) and draw the same batches from `default_rng(0)`; the JAX example
trains on the 8-device CPU mesh, the port on the CPU. The port's model
takes the JAX run's initial parameters (the two initialisers differ) and
both runs' per-step losses are read from their train steps: each step's
loss is held to the JAX one within 1e-5 relative (measured below 1e-6 at
four AdamW steps: 9e-8 and 1.9e-7, fp32), and the flags the port refuses stay argparse
errors.
"""

import jax
import numpy as np
import pytest

from examples import gpt_lm as j_gpt_lm
from tfde_tpu_torch import gpt_lm
from tfde_tpu_torch.models.flax_weights import from_flax_params
from tfde_tpu_torch.testing import one_thread

#: one intra-op torch thread for the module (`testing.one_thread`)
_one_thread = pytest.fixture(autouse=True, scope="module")(one_thread)

COMMON = ["--tiny", "--seq-len", "32", "--batch-size", "8", "--max-steps",
          "4", "--warmup-steps", "2", "--train-examples", "64"]
RUNS = {
    "rope_gqa_window_remat": ["--rope", "--kv-heads", "2",
                              "--sliding-window", "8", "--remat"],
    "packed_rope_gqa_dots": ["--packed", "--rope", "--kv-heads", "2",
                             "--remat", "dots"],
}


def _recording(make_step, losses):
    def make(*args, **kwargs):
        step = make_step(*args, **kwargs)

        def run(state, batch, rng=None):
            state, metrics = step(state, batch, rng)
            losses.append(float(metrics["loss"]))
            return state, metrics

        return run

    return make


def _jax_run(flags, monkeypatch):
    """(initial numpy params, per-step losses) of the JAX example."""
    losses, initial = [], []
    real_init = j_gpt_lm.init_state

    def init_state(*args, **kwargs):
        state, spec = real_init(*args, **kwargs)
        initial.append(jax.tree.map(np.asarray, state.params))
        return state, spec

    monkeypatch.setattr(j_gpt_lm, "init_state", init_state)
    monkeypatch.setattr(j_gpt_lm, "make_custom_train_step", _recording(
        j_gpt_lm.make_custom_train_step, losses))
    j_gpt_lm.main(COMMON + flags)
    return initial[0], losses


@pytest.mark.parametrize("name", RUNS)
def test_entry_point_follows_the_jax_example(name, monkeypatch):
    flags = RUNS[name]
    params, want = _jax_run(flags, monkeypatch)
    losses = []
    real_model = gpt_lm.gpt_tiny_test

    def model(**kw):
        m = real_model(**kw)
        m.load_state_dict(from_flax_params(params))
        return m

    monkeypatch.setattr(gpt_lm, "gpt_tiny_test", model)
    monkeypatch.setattr(gpt_lm, "make_custom_train_step", _recording(
        gpt_lm.make_custom_train_step, losses))
    state, metrics = gpt_lm.main(COMMON + flags + ["--device", "cpu"])
    assert state.step == 4 and len(losses) == len(want) == 4
    for got, w in zip(losses, want):
        assert abs(got - w) <= 1e-5 * abs(w), (losses, want)
    packed = "--packed" in flags
    assert ("packed_accuracy" in metrics) == packed
    model = state.model
    assert model.decoder.remat == ("dots" if packed else "full")
    assert model.kv_heads == 2 and model.wpe is None


def test_packed_refuses_the_sliding_window():
    with pytest.raises(ValueError, match="sliding-window"):
        gpt_lm.main(["--tiny", "--device", "cpu", "--packed",
                     "--sliding-window", "8"])


@pytest.mark.parametrize("flag", [["--seq-parallel", "2"], ["--tensor", "2"],
                                  ["--pipeline", "2"],
                                  ["--schedule", "1f1b"],
                                  ["--fake-devices", "8"]])
def test_unported_flags_stay_argparse_errors(flag, capsys):
    with pytest.raises(SystemExit) as exc:
        gpt_lm.main(["--tiny", "--device", "cpu", *flag])
    assert exc.value.code == 2
    assert "unrecognized arguments" in capsys.readouterr().err
