"""The port's twins of the reference's two Estimator recipes
(tfde_tpu_torch.mnist_estimator, tfde_tpu_torch.mnist_tf2, the
counterparts of examples/mnist_estimator.py and examples/mnist_tf2.py),
and the Estimator's evaluation under another strategy, on the CPU.

- `mnist_estimator.main` with ``--device cpu --num-epochs 0.01`` (four
  steps of 128 under ParameterServerStrategy, one rank) prints the
  BatchNormCNN summary, checkpoints, and leaves an export that
  `load_serving` reads: its argmax accuracy over the 10000 test images
  equals the Estimator's final eval accuracy (within 1e-4).
- `mnist_tf2.main` with ``--custom-loop --max-steps 5`` (PlainCNN through
  `make_train_step` and `device_prefetch`) and with ``--max-steps 4``
  (BatchNormCNN through `train_and_evaluate` with a FinalExporter); both
  entry points raise without ``--device cpu`` where there is no GPU.
- The reference's DistributeConfig (train under ParameterServerStrategy,
  evaluate under MirroredStrategy, mnist_keras:240-243): at two gloo
  ranks, with the update sharded, the mirrored evaluation gives the
  accuracy (and, within 1e-6, the loss) of the same checkpoint evaluated
  under ParameterServerStrategy.
"""

import math
import os

import numpy as np
import pytest
import torch

from tfde_tpu_torch import mnist_estimator, mnist_tf2, testing
from tfde_tpu_torch.data.datasets import mnist
from tfde_tpu_torch.export import load_serving
from tfde_tpu_torch.models.cnn import BatchNormCNN

#: one intra-op torch thread for the module (`testing.one_thread`)
_one_thread = pytest.fixture(autouse=True, scope="module")(testing.one_thread)

ACC_ATOL = 1e-4


def test_mnist_estimator_trains_and_exports(tmp_path, capsys):
    d = str(tmp_path / "work")
    state, metrics = mnist_estimator.main(
        ["--working-dir", d, "--device", "cpu", "--num-epochs", "0.01",
         "--no-tensorboard", "--an-extra-flag"])
    assert state.step == int(0.01 * 60000 // 128) == 4
    assert 'Model: "BatchNormCNN"' in capsys.readouterr().out
    assert os.listdir(os.path.join(d, "checkpoints")) == ["4"]
    served = load_serving(os.path.join(d, "export", "exporter"),
                          device="cpu")
    _, (ex, ey) = mnist(flatten=True)
    probs = served.predict(ex)
    assert probs.shape == (10000, 10)
    acc = float((probs.argmax(-1) == ey.reshape(-1)).mean())
    assert abs(acc - metrics["accuracy"]) <= ACC_ATOL
    assert math.isfinite(metrics["loss"])


def test_mnist_tf2_custom_loop_and_estimator(tmp_path):
    state = mnist_tf2.main(["--device", "cpu", "--custom-loop",
                            "--max-steps", "5"])
    assert state.step == 5
    assert type(state.model).__name__ == "PlainCNN"
    d = str(tmp_path / "mode")
    state, metrics = mnist_tf2.main(["--device", "cpu", "--model-dir", d,
                                     "--max-steps", "4"])
    assert state.step == 4 and math.isfinite(metrics["loss"])
    assert len(os.listdir(os.path.join(d, "export", "exporter"))) == 1


@pytest.mark.parametrize("main,argv", [
    (mnist_estimator.main, ["--working-dir", "unused"]),
    (mnist_tf2.main, ["--custom-loop", "--max-steps", "1"])])
def test_entry_points_need_a_gpu_unless_asked_for_the_cpu(main, argv):
    if torch.cuda.is_available():
        pytest.skip("a GPU is available, so there is nothing to refuse")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(argv)


def test_mirrored_eval_of_ps_training_matches_ps_eval(tmp_path):
    (tx, ty), (ex, ey) = mnist(flatten=True, n_train=256, n_test=100)
    initial = {k: v.numpy() for k, v in BatchNormCNN(
        dropout_rate=0.0, device="cpu").state_dict().items()}
    args = (2, str(tmp_path / "store"), str(tmp_path / "model"), initial,
            (tx, ty), (ex, ey), 32, 4)
    out = testing.run_ranks(testing.ps_eval_worker, [args] * 2, timeout=180)
    for rank in out:
        assert rank["sharded"]
        assert rank["mirrored"]["accuracy"] == rank["ps"]["accuracy"]
        np.testing.assert_allclose(rank["mirrored"]["loss"],
                                   rank["ps"]["loss"], rtol=1e-6)
    assert out[0] == out[1]
