"""The port's ResNet family (tfde_tpu_torch.models.resnet) held against the
JAX package's `tfde_tpu/models/resnet.py`, on the CPU.

- Parameter counts at full width on the `meta` device: 23,520,842 for
  `resnet50_cifar`, 25,557,032 for `ResNet50(num_classes=1000)` (the JAX
  `test_resnet50_imagenet_param_count`).
- `from_flax_params` carries the JAX `params` and `batch_stats` onto the
  port's names, every key and shape.
- Forward parity on the same weights, tiny widths (`stage_sizes=[1, 1]`,
  8 filters): Bottleneck and Basic blocks, CIFAR and ImageNet stems (the
  ImageNet stem on 32x32 pads its max-pool with -inf), eval mode on
  perturbed running statistics and train mode with the updated running
  statistics. Every BatchNorm scale is perturbed by a seeded draw first:
  the last of each block starts at zero, which would hide its conv. fp32
  within 1e-5 relative (measured <= 1.3e-6: the same sums in another
  order); bf16 within 1e-2 (measured <= 2.7e-3 in training: a bf16
  rounding at every conv and BatchNorm output, where a sum in another
  order flips the last bit; eval mode rounds the same way in both).
- Uneven SAME padding: a 3x3 stride-2 conv on 16 pads (0, 1) as
  `lax.conv_general_dilated(..., "SAME")` does, and torch's `padding=1`
  twin gives other numbers; the -inf max-pool against flax's.
- Three `make_train_step` steps under the entry point's optimizer (sgd,
  momentum 0.9, nesterov, warmup-cosine schedule) against the JAX
  `make_train_step` on one device, anchored in fp64: the JAX fp32 run
  ends 4.6e-5 (Bottleneck) and 4.8e-7 (Basic) from the same JAX model
  computed in fp64 (`dtype=float64` under `jax.enable_x64`; its head
  stays fp32), the port's fp32 run 1.5e-7 from its own fp64 run
  (measured on the CPU, `pytest -s` prints them; `JAX_FP32_GAP`). So the
  port is held to its fp64 run at 1e-6, to the JAX fp32 run at twice the
  JAX gap, and its fp64 run to the JAX anchor at 1e-6.
- Two gloo ranks (global-batch BatchNorm over the group) against the JAX
  `MultiWorkerMirroredStrategy` over two CPU devices, at the same bounds
  (the JAX fp32 run there ends 1.04e-4 from its fp64 run, the port's
  1.6e-7 from its own); both ranks end with the same bits.
- `GlobalBatchNorm`'s defaults (no scale, no output dtype) compute what
  they computed before the options came, bit for bit.
"""

import functools

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tfde_tpu.models import resnet as jresnet
from tfde_tpu.parallel.strategies import MultiWorkerMirroredStrategy
from tfde_tpu.runtime.mesh import make_mesh
from tfde_tpu.training.step import init_state as j_init_state
from tfde_tpu.training.step import make_train_step as j_make_train_step
from tfde_tpu_torch import testing
from tfde_tpu_torch.models import resnet
from tfde_tpu_torch.models.cnn import GlobalBatchNorm
from tfde_tpu_torch.models.flax_weights import from_flax_params

#: one intra-op torch thread for the module (`testing.one_thread`)
_one_thread = pytest.fixture(autouse=True, scope="module")(testing.one_thread)

FP32_REL, BF16_REL = 1e-5, 1e-2
FP64_ATOL = 1e-6
#: how far the JAX fp32 run ends from its fp64 run (max abs over the
#: final parameters and statistics), measured, by (block, devices)
JAX_FP32_GAP = {("BottleneckBlock", 1): 4.62e-5, ("BasicBlock", 1): 4.8e-7,
                ("BottleneckBlock", 2): 1.05e-4}
METRIC_ATOL = 1e-5  # a step's loss, accuracy and grad_norm, beyond 2 x gap
STEPS, BATCH, SIDE = 3, 16, 16
SCHEDULE = (0.1, 1, STEPS)  # peak lr, warmup steps, decay steps
BLOCKS = ("BottleneckBlock", "BasicBlock")


def _rel(got, want):
    got, want = np.float64(got), np.float64(want)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _jax_model(block, cifar_stem, dtype):
    return jresnet.ResNet(stage_sizes=[1, 1],
                          block_cls=getattr(jresnet, block), num_filters=8,
                          dtype=dtype, cifar_stem=cifar_stem)


def _perturb_scales(params, seed):
    """Every BatchNorm scale plus a seeded normal draw (sd 0.3)."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map_with_path(
        lambda path, a: (a + jnp.asarray(rng.normal(0.0, 0.3, a.shape),
                                         a.dtype))
        if path[-1].key == "scale" else a, params)


def _pair(block, cifar_stem, dtype, side):
    """(flax module, its variables as numpy with perturbed scales and
    running statistics, the port's model on them)."""
    jm = _jax_model(block, cifar_stem, getattr(jnp, dtype))
    v = jm.init(jax.random.key(0), jnp.zeros((1, side, side, 3)))
    v = jax.tree.map(np.asarray, dict(v))
    v["params"] = jax.tree.map(np.asarray, _perturb_scales(v["params"], 1))
    rng = np.random.default_rng(2)
    v["batch_stats"] = jax.tree.map(
        lambda a: (a + rng.uniform(0.2, 1.0, a.shape)).astype(np.float32),
        v["batch_stats"])
    tm = resnet.ResNet(stage_sizes=[1, 1], block_cls=getattr(resnet, block),
                       num_filters=8, dtype=getattr(torch, dtype),
                       cifar_stem=cifar_stem, device="cpu")
    tm.load_state_dict(from_flax_params(v["params"], v["batch_stats"]))
    return jm, v, tm


def _images(n, side, seed=0):
    return np.random.default_rng(seed).random((n, side, side, 3),
                                              dtype=np.float32)


@pytest.mark.parametrize("make,want", [
    (lambda: resnet.resnet50_cifar(device="meta"), 23_520_842),
    (lambda: resnet.ResNet50(num_classes=1000, device="meta"), 25_557_032),
])
def test_full_width_parameter_counts(make, want):
    model = make()
    assert sum(p.numel() for p in model.parameters()) == want


def test_resnet50_cifar_batchnorm_count():
    model = resnet.resnet50_cifar(device="meta")
    norms = [m for m in model.modules() if isinstance(m, GlobalBatchNorm)]
    assert len(norms) == 53
    assert 2 * sum(m.running_mean.numel() for m in norms) == 53_120


@pytest.mark.parametrize("block", BLOCKS)
@pytest.mark.parametrize("cifar_stem", [True, False])
def test_flax_conversion_covers_every_tensor(block, cifar_stem):
    side = SIDE if cifar_stem else 32
    _, v, tm = _pair(block, cifar_stem, "float32", side)
    sd = from_flax_params(v["params"], v["batch_stats"])
    live = tm.state_dict()
    assert set(sd) == set(live)
    for k, t in sd.items():
        assert t.shape == live[k].shape, k
        assert torch.equal(live[k], t), k
    # the perturbed zero-initialised scale reached the port
    last = max(k for k in v["params"][f"{block}_0"] if k.startswith("Batch"))
    np.testing.assert_array_equal(
        getattr(getattr(tm, f"{block}_0"), last).weight.detach().numpy(),
        v["params"][f"{block}_0"][last]["scale"])


@pytest.mark.parametrize("block", BLOCKS)
@pytest.mark.parametrize("cifar_stem", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("train", [False, True])
def test_forward_matches_flax(block, cifar_stem, dtype, train):
    side = SIDE if cifar_stem else 32
    jm, v, tm = _pair(block, cifar_stem, dtype, side)
    x = _images(8, side)
    if train:
        want, updated = jm.apply(v, x, train=True, mutable=["batch_stats"])
    else:
        want = jm.apply(v, x, train=False)
    got = tm(torch.as_tensor(x), train=train)
    assert got.dtype == torch.float32 and got.shape == (8, 10)
    tol = FP32_REL if dtype == "float32" else BF16_REL
    err = _rel(got.detach().numpy(), np.asarray(want))
    assert err <= tol, err
    if train:
        stats = {k: t.numpy() for k, t in from_flax_params(
            {}, jax.tree.map(np.asarray, updated["batch_stats"])).items()}
        live = tm.state_dict()
        for k, w in stats.items():
            assert _rel(live[k].numpy(), w) <= tol, k


def test_same_padding_is_uneven_where_torch_pads_evenly():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 16, 16, 4)).astype(np.float32)
    k = rng.standard_normal((3, 3, 4, 5)).astype(np.float32)  # HWIO
    want = np.asarray(jax.lax.conv_general_dilated(
        x, k, (2, 2), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC")))
    conv = resnet.Conv(4, 5, 3, 2, device="cpu")
    twin = torch.nn.Conv2d(4, 5, 3, stride=2, padding=1, bias=False)
    with torch.no_grad():
        conv.weight.copy_(torch.as_tensor(k.transpose(3, 2, 0, 1)))
        twin.weight.copy_(conv.weight)
    xt = torch.as_tensor(x).permute(0, 3, 1, 2)
    got = conv(xt).permute(0, 2, 3, 1).detach().numpy()
    other = twin(xt).permute(0, 2, 3, 1).detach().numpy()
    assert got.shape == other.shape == want.shape == (2, 8, 8, 5)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    assert np.abs(other - want).max() > 0.1  # (1, 1) is not (0, 1)
    # the 1x1 stride-2 projection pads nothing
    assert resnet._pad_same(xt, 1, 2).shape == xt.shape


def test_max_pool_pads_with_minus_infinity():
    x = -np.random.default_rng(4).random((2, 16, 16, 3), dtype=np.float32)
    want = np.asarray(fnn.max_pool(jnp.asarray(x), (3, 3), strides=(2, 2),
                                   padding="SAME"))
    xt = torch.as_tensor(x).permute(0, 3, 1, 2)
    got = torch.nn.functional.max_pool2d(
        resnet._pad_same(xt, 3, 2, -float("inf")), 3, 2)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)
    zero_padded = torch.nn.functional.max_pool2d(resnet._pad_same(xt, 3, 2),
                                                 3, 2)
    assert (zero_padded.permute(0, 2, 3, 1).numpy() != want).any()


def test_global_batchnorm_defaults_unchanged():
    torch.manual_seed(0)
    bn = GlobalBatchNorm(6)
    with torch.no_grad():
        bn.bias.normal_()
    x = torch.randn(8, 6, 5, 5)
    y = bn(x, train=True)
    xf = x
    mean = xf.sum((0, 2, 3)) / 200
    var = torch.clamp_min((xf * xf).sum((0, 2, 3)) / 200 - mean * mean, 0.0)
    shape = (1, 6, 1, 1)
    want = ((x - mean.view(shape)) * torch.rsqrt(var.view(shape) + 1e-3)
            + bn.bias.view(shape))
    assert torch.equal(y, want)
    assert bn.weight is None and y.dtype == torch.float32


def _batches(n_steps=STEPS, batch=BATCH):
    rng = np.random.default_rng(0)
    return [(rng.random((batch, SIDE, SIDE, 3), dtype=np.float32),
             rng.integers(0, 10, (batch, 1)).astype(np.int64))
            for _ in range(n_steps)]


def _spec(block, dtype="float32"):
    return dict(stage_sizes=[1, 1], block=block, num_filters=8, dtype=dtype,
                cifar_stem=True)


def _state_dict(s):
    return {k: v.numpy() for k, v in from_flax_params(
        jax.tree.map(np.asarray, s.params),
        jax.tree.map(np.asarray, s.batch_stats)).items()}


@functools.cache
def _jax_run(block, n, fp64=False):
    """(initial state_dict, per-step metrics, final state_dict) of the JAX
    run of `make_train_step` over `n` CPU devices, scales perturbed; with
    `fp64` the model computes in fp64 under x64."""
    with jax.enable_x64(fp64):
        strat = MultiWorkerMirroredStrategy(
            mesh=make_mesh({"data": n}, devices=jax.devices()[:n]))
        tx = optax.sgd(optax.warmup_cosine_decay_schedule(0.0, *SCHEDULE),
                       momentum=0.9, nesterov=True)
        state, _ = j_init_state(
            _jax_model(block, True, jnp.float64 if fp64 else jnp.float32),
            tx, strat, jnp.zeros((BATCH, SIDE, SIDE, 3)))
        state = state.replace(params=_perturb_scales(state.params, 5))
        initial = _state_dict(state)
        step = j_make_train_step(strat, state, donate=False)
        history = []
        for batch in _batches():
            state, m = step(state, batch, jax.random.key(0))
            history.append({k: float(v) for k, v in m.items()})
        return initial, history, _state_dict(state)


def _max_abs(got, want):
    errs = {k: float(np.max(np.abs(np.float64(got[k]) - want[k])))
            for k in want}
    k = max(errs, key=errs.get)
    return errs[k], k


def _assert_anchored(got, port64, block, n):
    _, history, want = _jax_run(block, n)
    _, _, anchor = _jax_run(block, n, fp64=True)
    gap, _ = _max_abs(want, anchor)
    print(f"{block} at {n}: JAX fp32 vs its fp64 {gap:.3e}; port fp32 vs "
          f"its fp64 {_max_abs(got['state_dict'], port64)}; port vs JAX "
          f"{_max_abs(got['state_dict'], want)}")
    measured = JAX_FP32_GAP[block, n]
    assert gap <= 1.5 * measured  # the gap the bound below is made of
    err, where = _max_abs(got["state_dict"], port64)
    assert err <= FP64_ATOL, where
    err, where = _max_abs(got["state_dict"], want)
    assert err <= 2 * measured, where
    err, where = _max_abs(port64, anchor)
    assert err <= FP64_ATOL, where
    for g, w in zip(got["history"], history, strict=True):
        assert set(g) == set(w) == {"loss", "accuracy", "grad_norm"}
        for k in w:
            assert abs(g[k] - w[k]) <= 2 * measured + METRIC_ATOL, k


@functools.cache
def _port64(block):
    initial, _, _ = _jax_run(block, 1)
    return testing.train_resnet(_spec(block, "float64"), initial, _batches(),
                                SCHEDULE)["state_dict"]


@pytest.mark.parametrize("block", BLOCKS)
def test_train_steps_match_jax_single_device(block):
    initial, _, _ = _jax_run(block, 1)
    got = testing.train_resnet(_spec(block), initial, _batches(), SCHEDULE)
    assert set(got["grads"]) == {n for n in initial
                                 if not n.endswith(("running_mean",
                                                    "running_var"))}
    _assert_anchored(got, _port64(block), block, 1)


def test_two_gloo_ranks_match_jax_data_parallel_over_two_devices(tmp_path):
    block = "BottleneckBlock"
    initial, _, _ = _jax_run(block, 2)
    args = (2, str(tmp_path / "store"), _spec(block), initial, _batches(),
            SCHEDULE)
    out = testing.run_ranks(testing.resnet_train_worker, [args] * 2,
                            timeout=300)
    # the same initial weights as the one-device run the fp64 anchor used
    for k, v in _jax_run(block, 1)[0].items():
        np.testing.assert_array_equal(initial[k], v, err_msg=k)
    for got in out:
        _assert_anchored(got, _port64(block), block, 2)
    assert out[0]["history"] == out[1]["history"]
    for k, v in out[0]["state_dict"].items():
        assert np.array_equal(v, out[1]["state_dict"][k]), k
