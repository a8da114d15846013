"""Vision Transformer — counterpart of `tfde_tpu/models/vit.py`
(BASELINE.json configs[3], ImageNet ViT-B/16 under FSDP).

The JAX model over [B, H, W, C] (NHWC) images: the patch embedding is a
strided `Conv` with VALID padding on the input cast to the compute dtype
(the images are permuted once to NCHW for cuDNN), a `cls_token` (or
`pool='gap'`, a mean over the patches), `pos_embed`, dropout after the
positions, the shared pre-LN encoder (`models/transformer.Encoder`,
non-causal, unmasked: on a CUDA tensor every attention takes the flash
kernels) and an fp32 head. Parameter names are flax's (`patch_embed`,
`cls_token`, `pos_embed`, `encoder.block_i...`, `head`).

What differs from the JAX model: flax sizes `pos_embed` from the sample
it is initialised on; here the constructor takes `image_size` (224 by
default, as ViT-B/16 is published). Weights are initialised from `seed`
with flax's default initialisers (`pos_embed` normal(0, 0.02), the cls
token zero). `remat` checkpoints each encoder block
(`transformer.Encoder`); the JAX field `fused_qkv` raises
NotImplementedError when set, and a field the JAX `ViT` does not have
(the decoder fields `norm`, `mlp_act`, `use_bias` ...) raises TypeError
(`_UNPORTED`).
"""

from __future__ import annotations

import functools
from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from tfde_tpu_torch.models.cnn import dropout
from tfde_tpu_torch.models.transformer import (
    Dense, Encoder, check_unported, init_flax_)
from tfde_tpu_torch.utils.devices import resolve_device

#: the JAX `ViT` fields outside the port, with the default the port
#: implements; any other name is not a field of the JAX `ViT`
_UNPORTED = {"fused_qkv": False}


class ViT(nn.Module):
    """Vision Transformer classifier: [B, image_size, image_size, 3]
    images -> [B, num_classes] fp32 logits (fp64 in an fp64 model)."""

    def __init__(self, num_classes: int = 1000, patch_size: int = 16,
                 embed_dim: int = 768, depth: int = 12, num_heads: int = 12,
                 mlp_dim: int = 3072, dropout_rate: float = 0.0,
                 dtype: torch.dtype = torch.bfloat16, pool: str = "cls",
                 attn_impl: str = "auto", image_size: int = 224,
                 remat=False, device=None, seed: int = 0, **fields):
        super().__init__()
        check_unported("ViT", fields, _UNPORTED)
        if pool not in ("cls", "gap"):
            raise ValueError(f"pool must be 'cls' or 'gap', got {pool!r}")
        if image_size % patch_size:
            raise ValueError(f"image_size {image_size} must divide by "
                             f"patch_size {patch_size}")
        device = resolve_device(device)
        self.dtype = dtype
        self.pool = pool
        self.dropout_rate = dropout_rate
        self.depth = depth
        self.num_heads = num_heads
        self.head_dtype = torch.promote_types(dtype, torch.float32)
        self.patch_embed = nn.Conv2d(3, embed_dim, patch_size,
                                     stride=patch_size, device=device)
        tokens = (image_size // patch_size) ** 2 + (pool == "cls")
        if pool == "cls":
            self.cls_token = nn.Parameter(
                torch.zeros(1, 1, embed_dim, device=device))
        self.pos_embed = nn.Parameter(
            torch.empty(1, tokens, embed_dim, device=device))
        self.encoder = Encoder(depth, embed_dim, num_heads,
                               embed_dim // num_heads, mlp_dim, dtype,
                               attn_impl=attn_impl,
                               dropout_rate=dropout_rate, remat=remat,
                               device=device)
        self.head = Dense(embed_dim, num_classes, self.head_dtype,
                          device=device)
        gen = torch.Generator(device=device).manual_seed(seed)
        init_flax_(self, gen)
        with torch.no_grad():
            self.pos_embed.normal_(0.0, 0.02, generator=gen)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None,
                group: Optional[dist.ProcessGroup] = None) -> torch.Tensor:
        """`generator` draws the dropout masks in training; `group` is the
        classification step's BatchNorm group, unused (no BatchNorm)."""
        w = self.patch_embed.weight.to(self.dtype)
        b = self.patch_embed.bias.to(self.dtype)
        x = F.conv2d(x.to(self.dtype).permute(0, 3, 1, 2), w, b,
                     stride=self.patch_embed.stride)
        x = x.flatten(2).transpose(1, 2)  # [B, patches, E], row-major
        if self.pool == "cls":
            cls = self.cls_token.to(self.dtype).expand(x.shape[0], -1, -1)
            x = torch.cat([cls, x], dim=1)
        x = x + self.pos_embed.to(self.dtype)
        x = dropout(x, self.dropout_rate, train, generator)
        x = self.encoder(x, train=train, generator=generator)
        x = x[:, 0] if self.pool == "cls" else x.mean(dim=1)
        return self.head(x)

    def set_attn_impl(self, impl: str) -> None:
        """Attention implementation of every layer ('auto' | 'reference' |
        'flash', ops/attention.attention)."""
        for block in self.encoder.blocks():
            block.attn.attn_impl = impl


ViT_B16 = functools.partial(
    ViT, patch_size=16, embed_dim=768, depth=12, num_heads=12, mlp_dim=3072)
ViT_L16 = functools.partial(
    ViT, patch_size=16, embed_dim=1024, depth=24, num_heads=16,
    mlp_dim=4096)
ViT_S16 = functools.partial(
    ViT, patch_size=16, embed_dim=384, depth=12, num_heads=6, mlp_dim=1536)


def vit_tiny_test(num_classes: int = 10, image_size: int = 32,
                  **kw) -> ViT:
    """The JAX package's CI config (patch 4, width 32, 2 layers, 4 heads,
    fp32) on `image_size` px images (32, as its tests run it)."""
    return ViT(num_classes=num_classes, patch_size=4, embed_dim=32, depth=2,
               num_heads=4, mlp_dim=64, dtype=torch.float32,
               image_size=image_size, **kw)
