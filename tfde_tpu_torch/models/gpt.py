"""GPT-style causal LM — counterpart of `tfde_tpu/models/gpt.py`.

Ported: the GPT-2 arrangement — token embedding `wte`, learned position
table `wpe` (positions continue per row from the cache index), pre-LN
blocks, final LayerNorm, and the tied head `x @ wte.T` computed in the
compute dtype with fp32 logits (flax `Embed.attend`). Every other field
of the JAX `GPT` raises NotImplementedError when set away from its
default (`_UNPORTED`), so a configuration the port does not implement is
never served as a different model.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch import nn

from tfde_tpu_torch.models.transformer import Dense, Encoder, LayerNorm
from tfde_tpu_torch.utils.devices import resolve_device

#: JAX `GPT` fields outside this slice, with the default the port implements
_UNPORTED = {
    "dropout_rate": 0.0,
    "remat": False,
    "fused_qkv": False,
    "num_experts": 0,
    "rolling_cache": False,
    "paged_blocks": None,
    "kv_quant": None,
    "position": "learned",
    "num_kv_heads": None,
    "norm": "layer",
    "mlp_act": "gelu",
    "use_bias": True,
    "qkv_bias": False,
    "qk_norm": False,
    "norm_style": "pre",
    "head_bias": False,
    "embed_scale": None,
    "head_dim": None,
    "tie_embeddings": True,
    "quant": None,
    "sliding_window": None,
    "attn_scale": None,
    "attn_logit_cap": None,
    "final_logit_cap": None,
}


class GPT(nn.Module):
    """Decoder-only LM over [B, S] int token ids -> [B, S, vocab] fp32
    logits. Parameters are fp32 and initialised from `seed` with an
    explicit generator (normal(0, 0.02) weights, zero biases, unit
    LayerNorm scales); load real or shared weights with
    `load_state_dict(models.flax_weights.from_flax_params(...))`."""

    def __init__(self, vocab_size: int = 50257, hidden_size: int = 768,
                 depth: int = 12, num_heads: int = 12, mlp_dim: int = 3072,
                 max_position: int = 1024,
                 dtype: torch.dtype = torch.bfloat16,
                 attn_impl: str = "auto", ln_eps: float = 1e-6,
                 device=None, seed: int = 0, **fields):
        super().__init__()
        for name, value in fields.items():
            if name not in _UNPORTED:
                raise TypeError(f"GPT got an unexpected field {name!r}")
            if value != _UNPORTED[name]:
                raise NotImplementedError(
                    f"GPT field {name}={value!r} is not ported yet (the "
                    f"port implements {name}={_UNPORTED[name]!r})")
        if hidden_size % num_heads:
            raise ValueError(f"hidden_size {hidden_size} must divide by "
                             f"num_heads {num_heads}")
        device = resolve_device(device)
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.depth = depth
        self.num_heads = num_heads
        self.head_dim = hidden_size // num_heads
        self.mlp_dim = mlp_dim
        self.max_position = max_position
        self.dtype = dtype
        self.wte = nn.Embedding(vocab_size, hidden_size, device=device)
        self.wpe = nn.Embedding(max_position, hidden_size, device=device)
        self.decoder = Encoder(depth, hidden_size, num_heads, self.head_dim,
                               mlp_dim, dtype, attn_impl=attn_impl,
                               ln_eps=ln_eps, device=device)
        self.init_weights_(torch.Generator(device=device).manual_seed(seed))

    @property
    def device(self) -> torch.device:
        return self.wte.weight.device

    @torch.no_grad()
    def init_weights_(self, generator: torch.Generator) -> None:
        for mod in self.modules():
            if isinstance(mod, (Dense, nn.Embedding)):
                mod.weight.normal_(0.0, 0.02, generator=generator)
                if getattr(mod, "bias", None) is not None:
                    mod.bias.zero_()
            elif isinstance(mod, LayerNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()

    @torch.no_grad()
    def cast_compute_weights_(self) -> "GPT":
        """Cast the matmul weights and embeddings to the compute dtype
        once, in place. Every forward casts them to that dtype anyway, so
        the values are the same; the LayerNorms stay fp32."""
        for mod in self.modules():
            if isinstance(mod, (Dense, nn.Embedding)):
                for p in mod.parameters(recurse=False):
                    p.data = p.data.to(self.dtype)
        return self

    def set_attn_impl(self, impl: str) -> None:
        """Attention implementation of every layer ('auto' | 'reference' |
        'flash', ops/attention.attention)."""
        for block in self.decoder.blocks():
            block.attn.attn_impl = impl

    def hidden(self, input_ids: torch.Tensor, cache=None) -> torch.Tensor:
        """[B, S] ids -> [B, S, E] final-LayerNorm states (fp32). With a
        cache, positions continue from `cache.index` (an int, or a [B]
        tensor of per-row positions) and the index advances by S."""
        s = input_ids.shape[1]
        positions = torch.arange(s, device=input_ids.device)
        if cache is not None:
            idx = cache.index
            positions = (idx + positions if isinstance(idx, int)
                         else idx[:, None] + positions)
        x = (self.wte(input_ids).to(self.dtype)
             + self.wpe(positions).to(self.dtype))
        x = self.decoder(x, cache)
        if cache is not None:
            cache.advance(s)
        return x

    def head(self, h: torch.Tensor) -> torch.Tensor:
        """Tied LM head: h @ wte.T in the compute dtype, logits in fp32."""
        return F.linear(h.to(self.dtype),
                        self.wte.weight.to(self.dtype)).float()

    def forward(self, input_ids: torch.Tensor, cache=None) -> torch.Tensor:
        return self.head(self.hidden(input_ids, cache))


GPT2Small = functools.partial(
    GPT, hidden_size=768, depth=12, num_heads=12, mlp_dim=3072)


def gpt_tiny_test(**kw) -> GPT:
    """The JAX package's CI config (vocab 97, width 32, 2 layers, fp32)."""
    return GPT(vocab_size=97, hidden_size=32, depth=2, num_heads=4,
               mlp_dim=64, max_position=64, dtype=torch.float32, **kw)
