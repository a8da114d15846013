"""The ResNet family — counterpart of `tfde_tpu/models/resnet.py`
(`BottleneckBlock` :31, `BasicBlock` :61, `ResNet` :85, `ResNet18`,
`ResNet50`, `ResNet101` :132-134, `resnet50_cifar` :137).

BASELINE.json configs[2], "CIFAR-10 ResNet-50 (distributed_with_keras.py
scaled to v4-32)", is `resnet50_cifar`: ResNet-50 (v1.5: the stride on
the 3x3 of a bottleneck) with the CIFAR stem (a 3x3 stride-1 conv, no
max-pool), 10 classes, 23,520,842 parameters.

The numerics are flax's, so that the JAX model's weights
(`models.flax_weights.from_flax_params`) give its outputs:

- dtypes: parameters in fp32 (the master weights the optimizer updates);
  the trunk computes in `dtype` (bf16 by default): each conv casts its
  input and kernel to it, each BatchNorm (`cnn.GlobalBatchNorm`:
  statistics in fp32, momentum 0.9, epsilon 1e-5) returns it, and the
  residual adds run in it; the global average pool is an fp32 mean
  rounded to `dtype` (jnp.mean of a bf16 map), and the head is fp32 (fp64
  in an fp64 model);
- padding is TF's SAME (`cnn.same_pads`), which is uneven where a stride
  of 2 meets an even size: a 3x3 stride-2 conv on 32 pads (0, 1), where
  torch's ``padding=1`` pads (1, 1); the ImageNet stem's max-pool pads
  with -inf;
- initialisation: lecun-normal kernels, the head's bias zero, every
  BatchNorm's scale one and bias zero, except the last BatchNorm of each
  block, whose scale starts at zero (the block starts as its shortcut);
- names are flax's auto-names (`conv_init`, `bn_init`,
  `BottleneckBlock_<i>` / `BasicBlock_<i>` counted over the whole net,
  `Conv_<j>`, `BatchNorm_<j>`, `conv_proj`, `norm_proj`, `Dense_0`).

Layout: `forward` takes NHWC images, as the JAX model and the port's
CNNs do, and permutes them to an NCHW view whose strides are
channels-last; the convolutions keep that memory format. The train/eval
switch is `forward`'s `train`; `group` is the data-parallel group the
BatchNorms sum their statistics over (`training.step.make_train_step`
passes it), `generator` is unused (the ResNet has no dropout). The
`meta` device builds the shapes only (parameter counts), with no
initialisation.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from tfde_tpu_torch.models.cnn import GlobalBatchNorm, _init_flax_, same_pads
from tfde_tpu_torch.utils.devices import resolve_device


def _pad_same(x: torch.Tensor, kernel: int, stride: int,
              value: float = 0.0) -> torch.Tensor:
    """`x` [N, C, H, W] padded as TF's SAME pads a `kernel` x `kernel`
    window at `stride`."""
    ph, pw = (same_pads(size, kernel, stride) for size in x.shape[2:])
    if not any(ph + pw):
        return x
    return F.pad(x, (*pw, *ph), value=value)


class Conv(nn.Conv2d):
    """flax `nn.Conv(features, (k, k), strides, padding='SAME',
    use_bias=False, dtype, param_dtype=float32)`: an fp32 kernel, the
    input and kernel cast to the input's dtype (the model casts the image
    to its compute dtype once), SAME pads."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1,
                 device=None):
        super().__init__(cin, cout, kernel, stride=stride, bias=False,
                         device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _pad_same(x, self.kernel_size[0], self.stride[0])
        return F.conv2d(x, self.weight.to(x.dtype), None, self.stride)


class _Block(nn.Module):
    """What the two blocks share: their convs and BatchNorms in order
    (`Conv_j`, `BatchNorm_j`; `conv` and `norm` make them, as the JAX
    blocks take theirs), the shortcut's (`conv_proj`, `norm_proj`) where
    the shape changes, and the residual add."""

    def _build(self, cin: int, widths: Sequence[int], kernels: Sequence[int],
               strides: Sequence[int], out: int, stride: int, conv, norm):
        last = len(widths) - 1
        c = cin
        for j, (w, k, s) in enumerate(zip(widths, kernels, strides)):
            self.add_module(f"Conv_{j}", conv(c, w, k, s))
            self.add_module(f"BatchNorm_{j}", norm(w, zero_scale=j == last))
            c = w
        self.depth = len(widths)
        # the JAX block projects where `residual.shape != y.shape`; in
        # these stage layouts a stride of 2 always comes with more channels
        self.project = cin != out or stride != 1
        if self.project:
            self.conv_proj = conv(cin, out, 1, stride)
            self.norm_proj = norm(out)

    def forward(self, x: torch.Tensor, train: bool = False,
                group: Optional[dist.ProcessGroup] = None) -> torch.Tensor:
        y = x
        for j in range(self.depth):
            y = getattr(self, f"Conv_{j}")(y)
            y = getattr(self, f"BatchNorm_{j}")(y, train, group)
            if j < self.depth - 1:
                y = F.relu(y)
        residual = x
        if self.project:
            residual = self.norm_proj(self.conv_proj(x), train, group)
        return F.relu(residual + y)


class BottleneckBlock(_Block):
    """1x1 reduce -> 3x3 (the stride, v1.5) -> 1x1 expand to 4 x
    `features`, residual add."""

    expansion = 4

    def __init__(self, cin: int, features: int, stride: int, conv, norm):
        super().__init__()
        self._build(cin, (features, features, 4 * features), (1, 3, 1),
                    (1, stride, 1), 4 * features, stride, conv, norm)


class BasicBlock(_Block):
    """Two 3x3 convs (the first strided), residual add: ResNet-18/34."""

    expansion = 1

    def __init__(self, cin: int, features: int, stride: int, conv, norm):
        super().__init__()
        self._build(cin, (features, features), (3, 3), (stride, 1),
                    features, stride, conv, norm)


class ResNet(nn.Module):
    """`stage_sizes` picks the depth (ResNet-50: [3, 4, 6, 3]),
    `block_cls` the block; stage i has `num_filters` x 2^i features and
    strides 2 in its first block (but the first stage's). Input [N, H, W,
    3] (RGB) images; returns [N, num_classes] logits in fp32 (fp64 in an
    fp64 model)."""

    def __init__(self, stage_sizes: Sequence[int], block_cls=BottleneckBlock,
                 num_classes: int = 10, num_filters: int = 64,
                 dtype: torch.dtype = torch.bfloat16, cifar_stem: bool = False,
                 device=None, seed: int = 0):
        super().__init__()
        device = (torch.device("meta") if str(device) == "meta"
                  else resolve_device(device))
        self.dtype = dtype
        self.cifar_stem = cifar_stem
        self.head_dtype = torch.promote_types(dtype, torch.float32)
        conv = functools.partial(Conv, device=device)
        # flax's BatchNorm as the JAX model sets it: momentum 0.9, epsilon
        # 1e-5, a scale, the output in the compute dtype
        norm = functools.partial(GlobalBatchNorm, momentum=0.9, eps=1e-5,
                                 device=device, use_scale=True, dtype=dtype)
        self.conv_init = conv(3, num_filters, 3 if cifar_stem else 7,
                              1 if cifar_stem else 2)
        self.bn_init = norm(num_filters)
        self.blocks = []
        cin = num_filters
        for i, count in enumerate(stage_sizes):
            for j in range(count):
                features = num_filters * 2 ** i
                name = f"{block_cls.__name__}_{len(self.blocks)}"
                self.add_module(name, block_cls(
                    cin, features, 2 if i > 0 and j == 0 else 1, conv, norm))
                self.blocks.append(name)
                cin = features * block_cls.expansion
        self.Dense_0 = nn.Linear(cin, num_classes, device=device)
        if device.type != "meta":
            _init_flax_(self, torch.Generator(device=device).manual_seed(seed))

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None,
                group: Optional[dist.ProcessGroup] = None) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2).to(self.dtype)
        x = F.relu(self.bn_init(self.conv_init(x), train, group))
        if not self.cifar_stem:
            x = F.max_pool2d(_pad_same(x, 3, 2, -float("inf")), 3, 2)
        for name in self.blocks:
            x = getattr(self, name)(x, train, group)
        # jnp.mean of a bf16 map: an fp32 mean rounded to bf16
        x = x.to(self.head_dtype).mean((2, 3)).to(self.dtype)
        x = x.to(self.head_dtype)
        w = self.Dense_0.weight.to(self.head_dtype)
        return F.linear(x, w, self.Dense_0.bias.to(self.head_dtype))


ResNet18 = functools.partial(ResNet, stage_sizes=[2, 2, 2, 2],
                             block_cls=BasicBlock)
ResNet50 = functools.partial(ResNet, stage_sizes=[3, 4, 6, 3])
ResNet101 = functools.partial(ResNet, stage_sizes=[3, 4, 23, 3])


def resnet50_cifar(num_classes: int = 10, dtype: torch.dtype = torch.bfloat16,
                   device=None, seed: int = 0) -> ResNet:
    """The BASELINE.json configs[2] model: ResNet-50, CIFAR stem, 10
    classes, initialised from `seed`."""
    return ResNet50(num_classes=num_classes, dtype=dtype, cifar_stem=True,
                    device=device, seed=seed)
