"""The reference's two MNIST models — counterpart of
`tfde_tpu/models/cnn.py`.

- `PlainCNN`: Conv(32, 3x3, VALID, relu) -> MaxPool(2) -> Flatten ->
  Dense(64, relu) -> Dense(10 logits).
- `BatchNormCNN`: three Conv(no bias) -> BatchNorm(bias, no scale) -> relu
  blocks with filters 6/12/24, kernels 3/6/6, strides 1/2/2, SAME
  padding; Flatten; Dense(200, no bias) -> BatchNorm -> relu ->
  Dropout(0.5); Dense(10).

Both take [N, 784] or [N, 28, 28, 1] (NHWC, as flax does), compute in
NCHW, return fp32 logits, and name their layers as flax does (`Conv_0`,
`BatchNorm_0`, `Dense_0`, ...), so that
`models.flax_weights.from_flax_params` output loads directly. Where the
two frameworks differ by default, the port follows flax:

- SAME padding is TF's (`same_pads`): torch's ``padding='same'`` refuses
  a stride of 2, so the pads go through `F.pad`;
- the Flatten is NHWC: the model permutes to NHWC before it flattens, so
  the Dense kernels' rows mean what they mean in the JAX model;
- BatchNorm is `GlobalBatchNorm`: statistics over the global batch (the
  JAX package's sync-BN under a sharded batch), flax's fast variance
  E[x^2] - E[x]^2 with epsilon 1e-3, and running statistics updated with
  the biased variance at momentum 0.99 (torch's BatchNorm would use the
  unbiased one);
- Dropout draws its mask from an explicit `torch.Generator`;
- initialisation is flax's: lecun-normal kernels (a normal truncated at
  two standard deviations), zero biases, running mean 0 and variance 1,
  drawn from `seed`.

The train/eval switch is the `train` argument of `forward`, as in the
JAX models, not `nn.Module.train()`.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.distributed.nn.functional as dist_nn
import torch.nn.functional as F
from torch import nn

from tfde_tpu_torch.utils.devices import resolve_device


def same_pads(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """TF's SAME padding of one spatial dimension: (low, high) pads so that
    the output has ceil(size / stride) positions; the odd pixel, if any,
    goes on the high side."""
    total = max((-(-size // stride) - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class GlobalBatchNorm(nn.Module):
    """flax `nn.BatchNorm(use_scale=False, use_bias=True, momentum,
    epsilon)` over channel dimension 1 of [N, C] or [N, C, H, W].

    In training the per-channel sum, sum of squares and count are summed
    over `group`, the data-parallel group the train step passes down
    (`training.step.make_train_step`), with the autograd all-reduce, whose
    backward sums the gradient over the group too, so each rank's gradient
    is its share of the gradient of the global-batch loss. With no group,
    or a group of one, the statistics are this process's. Running statistics: ``r = momentum * r + (1 -
    momentum) * batch``, with the biased batch variance.
    """

    def __init__(self, num_features: int, momentum: float = 0.99,
                 eps: float = 1e-3, device=None):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.bias = nn.Parameter(torch.zeros(num_features, device=device))
        self.register_buffer("running_mean",
                             torch.zeros(num_features, device=device))
        self.register_buffer("running_var",
                             torch.ones(num_features, device=device))

    def forward(self, x: torch.Tensor, train: bool = False,
                group: Optional[dist.ProcessGroup] = None) -> torch.Tensor:
        c = x.shape[1]
        if train:
            dims = [d for d in range(x.dim()) if d != 1]
            xf = x.to(torch.promote_types(x.dtype, torch.float32))
            count = torch.full((1,), x.numel() // c, dtype=xf.dtype,
                               device=x.device)
            stats = torch.cat([xf.sum(dims), (xf * xf).sum(dims), count])
            if group is not None and dist.get_world_size(group) > 1:
                stats = dist_nn.all_reduce(stats, group=group)
            mean = stats[:c] / stats[-1]
            var = torch.clamp_min(stats[c:2 * c] / stats[-1] - mean * mean,
                                  0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.copy_(m * self.running_mean
                                        + (1.0 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1.0 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        shape = (1, c) + (1,) * (x.dim() - 2)
        y = (x - mean.view(shape)) * torch.rsqrt(var.view(shape) + self.eps)
        return y + self.bias.view(shape)


def dropout(x: torch.Tensor, rate: float, train: bool,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax `nn.Dropout`: in training, keep each element with probability
    1 - rate and scale it by 1 / (1 - rate); the mask is drawn from
    `generator`, which training with rate > 0 requires."""
    if rate == 0.0 or not train:
        return x
    if rate == 1.0:
        return torch.zeros_like(x)
    if generator is None:
        raise ValueError("dropout in training needs a torch.Generator")
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))


@torch.no_grad()
def _init_flax_(model: nn.Module, generator: torch.Generator) -> None:
    """lecun_normal kernels (std sqrt(1 / fan_in), truncated at two
    standard deviations, rescaled as flax's variance scaling does), zero
    biases."""
    for mod in model.modules():
        if isinstance(mod, (nn.Conv2d, nn.Linear)):
            fan_in = mod.weight[0].numel()
            std = math.sqrt(1.0 / fan_in) / .87962566103423978
            nn.init.trunc_normal_(mod.weight, 0.0, std, -2 * std, 2 * std,
                                  generator=generator)
            if mod.bias is not None:
                mod.bias.zero_()


def _nchw(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """[N, 784] or [N, 28, 28, 1] -> [N, 1, 28, 28] in the weights' dtype
    (fp32 unless the model was cast, e.g. to fp64 for a reference run)."""
    return x.reshape(-1, 28, 28, 1).permute(0, 3, 1, 2).to(dtype)


def _flatten_nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)


class PlainCNN(nn.Module):
    """distributed_with_keras.py:32-44: input [N, 784] or [N, 28, 28, 1],
    returns [N, num_classes] logits."""

    def __init__(self, num_classes: int = 10, device=None, seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        self.Conv_0 = nn.Conv2d(1, 32, 3, device=device)
        self.Dense_0 = nn.Linear(13 * 13 * 32, 64, device=device)
        self.Dense_1 = nn.Linear(64, num_classes, device=device)
        _init_flax_(self, torch.Generator(device=device).manual_seed(seed))

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None,
                group: Optional[dist.ProcessGroup] = None) -> torch.Tensor:
        """`generator` and `group` are BatchNormCNN's; unused here."""
        x = F.relu(self.Conv_0(_nchw(x, self.Conv_0.weight.dtype)))
        x = F.max_pool2d(x, 2, 2)
        x = F.relu(self.Dense_0(_flatten_nhwc(x)))
        return self.Dense_1(x)


class BatchNormCNN(nn.Module):
    """mnist_keras_distributed.py:67-120: input [N, 784] or [N, 28, 28, 1],
    returns [N, num_classes] logits."""

    def __init__(self, num_classes: int = 10, dropout_rate: float = 0.5,
                 features: Sequence[int] = (6, 12, 24),
                 kernels: Sequence[int] = (3, 6, 6),
                 strides: Sequence[int] = (1, 2, 2),
                 device=None, seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        self.dropout_rate = dropout_rate
        self.kernels = tuple(kernels)
        self.strides = tuple(strides)
        cin, side = 1, 28
        for i, (f, k, s) in enumerate(zip(features, kernels, strides)):
            self.add_module(f"Conv_{i}", nn.Conv2d(cin, f, k, stride=s,
                                                   bias=False, device=device))
            self.add_module(f"BatchNorm_{i}", GlobalBatchNorm(f, device=device))
            cin, side = f, -(-side // s)
        n = len(self.kernels)
        self.Dense_0 = nn.Linear(side * side * cin, 200, bias=False,
                                 device=device)
        self.add_module(f"BatchNorm_{n}", GlobalBatchNorm(200, device=device))
        self.Dense_1 = nn.Linear(200, num_classes, device=device)
        _init_flax_(self, torch.Generator(device=device).manual_seed(seed))

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None,
                group: Optional[dist.ProcessGroup] = None) -> torch.Tensor:
        """`generator` draws the dropout mask in training; `group` is the
        data-parallel group the BatchNorms sum their statistics over."""
        x = _nchw(x, self.Conv_0.weight.dtype)
        n = len(self.kernels)
        for i, (k, s) in enumerate(zip(self.kernels, self.strides)):
            ph, pw = (same_pads(size, k, s) for size in x.shape[2:])
            x = F.pad(x, (*pw, *ph))
            x = getattr(self, f"Conv_{i}")(x)
            x = F.relu(getattr(self, f"BatchNorm_{i}")(x, train, group))
        x = self.Dense_0(_flatten_nhwc(x))
        x = F.relu(getattr(self, f"BatchNorm_{n}")(x, train, group))
        x = dropout(x, self.dropout_rate, train, generator)
        return self.Dense_1(x)
