"""GPT-style causal LM — counterpart of `tfde_tpu/models/gpt.py`.

Ported: the decoder-only LM with the fields the converted checkpoint
families use — token embedding `wte` (times `embed_scale` in the compute
dtype: Gemma's sqrt(hidden)), a learned position table `wpe` (positions
continue per row from the cache index) or rotary positions
(`position='rope'`: no table, q and k rotated inside each layer), the
blocks of `models/transformer.py` (`norm` 'layer' | 'rms', `norm_style`,
`mlp_act`, `use_bias`, `qkv_bias`, `qk_norm`, a decoupled `head_dim`,
`attn_scale`, `attn_logit_cap`, grouped-query attention `num_kv_heads`,
the sliding window `sliding_window`/`sliding_window_pattern`, `remat`),
the final norm, and the head: tied, `x @ wte.T` in the compute dtype with
fp32 logits (flax `Embed.attend`), or an untied `lm_head` Dense (with a
bias under `head_bias`), then `final_logit_cap`'s fp32 softcap; sequence
packing (`segment_ids`) and the training objective `next_token_loss`.
`kv_quant` (None or 'int8') is the storage format of the caches the
model decodes with by default (`inference/decode.init_cache`); the
layers read the format from the cache they are given. `rolling_cache` is
accepted and kept in `config`: JAX's `_decode_clone(rolling=True)` sets
it, and in the port the drivers pick the layout (`generate`,
`generate_ragged` and beam search decode a windowed model on the rolling
cache, the rewinding paths on the full one). Every other field of the JAX `GPT` raises NotImplementedError when set
away from its default (`_UNPORTED`), so a configuration the port does not
implement is never served as a different model. `config` holds the JAX
fields the model was built with (`models/convert.save_converted` writes
it).
"""

from __future__ import annotations

import functools
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from tfde_tpu_torch.models.transformer import (
    Dense, Encoder, LayerNorm, RMSNorm)
from tfde_tpu_torch.ops.losses import masked_lm_loss
from tfde_tpu_torch.utils.devices import resolve_device

#: JAX `GPT` fields outside the port, with the default the port implements
_UNPORTED = {
    "dropout_rate": 0.0,
    "fused_qkv": False,
    "num_experts": 0,
    "moe_every": 2,
    "experts_per_token": 2,
    "moe_capacity_factor": 1.25,
    "moe_normalize_topk": True,
    "moe_shared_expert_dim": None,
    "router_z_loss_weight": 0.0,
    "paged_blocks": None,
    "kv_block": 16,
    "quant": None,
}


class GPT(nn.Module):
    """Decoder-only LM over [B, S] int token ids -> [B, S, vocab] fp32
    logits. Parameters are fp32 and initialised from `seed` with an
    explicit generator (normal(0, 0.02) weights, zero biases, unit norm
    scales); load real or shared weights with
    `load_state_dict(models.flax_weights.from_flax_params(...))`, or a
    converted checkpoint with `models.convert.load_converted`."""

    def __init__(self, vocab_size: int = 50257, hidden_size: int = 768,
                 depth: int = 12, num_heads: int = 12, mlp_dim: int = 3072,
                 max_position: int = 1024,
                 dtype: torch.dtype = torch.bfloat16,
                 attn_impl: str = "auto", ln_eps: float = 1e-6,
                 position: str = "learned", rope_theta: float = 10_000.0,
                 rope_scaling=None, rope_dim: Optional[int] = None,
                 num_kv_heads: Optional[int] = None,
                 sliding_window: Optional[int] = None,
                 sliding_window_pattern: str = "all", remat=False,
                 norm: str = "layer", mlp_act: str = "gelu",
                 use_bias: bool = True, qkv_bias: bool = False,
                 qk_norm: bool = False, norm_style: str = "pre",
                 head_bias: bool = False,
                 embed_scale: Optional[float] = None,
                 head_dim: Optional[int] = None,
                 tie_embeddings: bool = True,
                 attn_scale: Optional[float] = None,
                 attn_logit_cap: Optional[float] = None,
                 final_logit_cap: Optional[float] = None,
                 kv_quant: Optional[str] = None,
                 rolling_cache: bool = False,
                 device=None, seed: int = 0, **fields):
        super().__init__()
        for name, value in fields.items():
            if name not in _UNPORTED:
                raise TypeError(f"GPT got an unexpected field {name!r}")
            if value != _UNPORTED[name]:
                raise NotImplementedError(
                    f"GPT field {name}={value!r} is not ported yet (the "
                    f"port implements {name}={_UNPORTED[name]!r})")
        if head_dim is None and hidden_size % num_heads:
            raise ValueError(f"hidden_size {hidden_size} must divide by "
                             f"num_heads {num_heads} (or pass head_dim)")
        if kv_quant not in (None, "int8"):
            raise ValueError(
                f"kv_quant must be None or 'int8', got {kv_quant!r}")
        if position not in ("learned", "rope"):
            raise ValueError(
                f"position must be 'learned' or 'rope', got {position!r}")
        if tie_embeddings and head_bias:
            raise ValueError(
                "head_bias=True requires tie_embeddings=False (the tied "
                "head is wte^T via Embed.attend, which carries no bias) — "
                "a silently dropped bias would change the architecture")
        device = resolve_device(device)
        self.config = dict(
            vocab_size=vocab_size, hidden_size=hidden_size, depth=depth,
            num_heads=num_heads, mlp_dim=mlp_dim, max_position=max_position,
            attn_impl=attn_impl, ln_eps=ln_eps, position=position,
            rope_theta=rope_theta,
            rope_scaling=(None if rope_scaling is None
                          else tuple(rope_scaling)),
            rope_dim=rope_dim, num_kv_heads=num_kv_heads,
            sliding_window=sliding_window,
            sliding_window_pattern=sliding_window_pattern, remat=remat,
            norm=norm, mlp_act=mlp_act, use_bias=use_bias,
            qkv_bias=qkv_bias, qk_norm=qk_norm, norm_style=norm_style,
            head_bias=head_bias, embed_scale=embed_scale, head_dim=head_dim,
            tie_embeddings=tie_embeddings, attn_scale=attn_scale,
            attn_logit_cap=attn_logit_cap, final_logit_cap=final_logit_cap,
            kv_quant=kv_quant, rolling_cache=rolling_cache)
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.depth = depth
        self.num_heads = num_heads
        self.head_dim = head_dim or hidden_size // num_heads
        self.mlp_dim = mlp_dim
        self.max_position = max_position
        self.dtype = dtype
        self.position = position
        self.kv_heads = num_kv_heads or num_heads
        self.sliding_window = sliding_window
        self.embed_scale = embed_scale
        self.final_logit_cap = final_logit_cap
        self.kv_quant = kv_quant
        self.rolling_cache = rolling_cache
        self.wte = nn.Embedding(vocab_size, hidden_size, device=device)
        self.wpe = (nn.Embedding(max_position, hidden_size, device=device)
                    if position == "learned" else None)
        self.decoder = Encoder(
            depth, hidden_size, num_heads, self.head_dim, mlp_dim, dtype,
            attn_impl=attn_impl, ln_eps=ln_eps, causal=True,
            norm_style=norm_style, norm=norm, mlp_act=mlp_act,
            use_bias=use_bias, window=sliding_window,
            window_pattern=sliding_window_pattern, remat=remat,
            rope=position == "rope", rope_theta=rope_theta,
            rope_scaling=rope_scaling, rope_dim=rope_dim,
            num_kv_heads=num_kv_heads, qkv_bias=qkv_bias, qk_norm=qk_norm,
            attn_scale=attn_scale, attn_logit_cap=attn_logit_cap,
            device=device)
        self.lm_head = (None if tie_embeddings else
                        Dense(hidden_size, vocab_size, dtype, bias=head_bias,
                              device=device))
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
            elif isinstance(mod, RMSNorm):
                mod.weight.fill_(1.0)

    @torch.no_grad()
    def cast_compute_weights_(self) -> "GPT":
        """Cast the matmul weights and embeddings to the compute dtype
        once, in place, for serving. Every forward casts them to that dtype
        anyway, so the values are the same; the norms stay fp32.
        Training keeps the fp32 master weights and never calls this."""
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

    def hidden(self, input_ids: torch.Tensor, cache=None,
               segment_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        """[B, S] ids -> [B, S, E] final-norm states (fp32). With a
        cache, positions continue from `cache.index` (an int, or a [B]
        tensor of per-row positions) and the index advances by S.

        `segment_ids` [B, S] (sequence packing, data/packing.py): a token
        attends only within its own segment, the [B, 1, S, S] mask
        `seg_q == seg_k` composed with the causal triangle inside
        attention (padding is segment 0 and attends only padding, so its
        softmax rows stay finite); the masked attention takes the
        reference einsum. Positions stay the row's: exact per document
        under rope, offset but consistent for learned positions."""
        mask = None
        if segment_ids is not None:
            if cache is not None:
                raise NotImplementedError(
                    "segment_ids (sequence packing) is a training-side "
                    "capability; the decode cache has no segment plane")
            if self.sliding_window is not None:
                raise NotImplementedError(
                    "segment_ids does not compose with sliding_window yet "
                    "(the band would need per-segment offsets)")
            seg = segment_ids.to(torch.int32)
            mask = seg[:, None, :, None] == seg[:, None, None, :]
        s = input_ids.shape[1]
        x = self.wte(input_ids).to(self.dtype)
        if self.embed_scale is not None:
            # the scale rounded to the compute dtype, as JAX's
            # jnp.asarray(embed_scale, dtype)
            x = x * torch.tensor(self.embed_scale, dtype=self.dtype,
                                 device=x.device)
        if self.wpe is not None:
            positions = torch.arange(s, device=input_ids.device)
            if cache is not None:
                idx = cache.index
                positions = (idx + positions if isinstance(idx, int)
                             else idx[:, None] + positions)
            # a position past the table embeds NaN, as JAX's `take`
            # fills it (a paged prefill pad-feeds rows past their
            # committed count; the paged cache sanitizes what they write)
            n = self.wpe.num_embeddings
            pe = self.wpe(positions.clamp(max=n - 1)).masked_fill(
                (positions >= n)[..., None], float("nan"))
            x = x + pe.to(self.dtype)
        x = self.decoder(x, cache, mask=mask)
        if cache is not None:
            cache.advance(s)
        return x

    def head(self, h: torch.Tensor) -> torch.Tensor:
        """The LM head in the compute dtype, logits in fp32: tied, h @
        wte.T (flax `Embed.attend`), or the untied `lm_head`; then the
        fp32 softcap `final_logit_cap * tanh(logits / final_logit_cap)`."""
        h = h.to(self.dtype)
        if self.lm_head is None:
            logits = F.linear(h, self.wte.weight.to(self.dtype)).float()
        else:
            logits = self.lm_head(h).float()
        if self.final_logit_cap is not None:
            cap = self.final_logit_cap
            logits = cap * torch.tanh(logits / cap)
        return logits

    def forward(self, input_ids: torch.Tensor, cache=None,
                segment_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.head(self.hidden(input_ids, cache, segment_ids))


GPT2Small = functools.partial(
    GPT, hidden_size=768, depth=12, num_heads=12, mlp_dim=3072)


def gpt_tiny_test(**kw) -> GPT:
    """The JAX package's CI config (vocab 97, width 32, 2 layers, fp32)."""
    return GPT(vocab_size=97, hidden_size=32, depth=2, num_heads=4,
               mlp_dim=64, max_position=64, dtype=torch.float32, **kw)


def next_token_loss(model: GPT, batch, generator: Optional[torch.Generator]
                    = None):
    """(loss, {"next_token_accuracy": acc}) for `make_custom_train_step`:
    the CE of logits[:, :-1] against tokens[:, 1:] (predict token t+1 from
    the prefix up to t). `batch` is the [B, S] token ids or a 1-tuple of
    them. The model has no dropout, so `generator` draws nothing; the
    JAX package's MoE sown losses have no counterpart (experts raise at
    construction)."""
    (tokens,) = batch if isinstance(batch, tuple) else (batch,)
    logits = model(tokens)
    loss, acc = masked_lm_loss(logits[:, :-1], tokens[:, 1:])
    return loss, {"next_token_accuracy": acc}
