"""BERT encoder with the masked-LM head and the classifier — counterpart of
`tfde_tpu/models/bert.py` (BASELINE.json configs[4], BERT-base MLM).

The shared encoder (`models/transformer.Encoder`) in the original BERT
arrangement: post-LN blocks, non-causal attention, an optional padding
mask (`attention_mask` [B, S], 1 for a real token). The embeddings sum
word + position + token-type in the compute dtype, rounding after each
add as flax's bf16 `nn.Embed` outputs do, then the fp32 LayerNorm, the
cast back and dropout. The MLM head is Dense + gelu + LayerNorm and the
tied decoder `h @ E^T` in the compute dtype (flax `Embed.attend`), then
the fp32 `mlm_bias`. `pad_vocab` rounds the tables up to a multiple of
128 rows, as in JAX.

Parameter names are flax's (`embeddings.word`, `encoder.block_i.attn.
query`, `mlm_dense`, `mlm_ln`, `mlm_bias`; the classifier's `pooler`
and `classifier`), so `models.flax_weights.from_flax_params` loads a JAX
tree as it is. Weights are initialised from `seed` with flax's default
initialisers; dropout draws from the `generator` the forward is given.
`remat` checkpoints each encoder block (`transformer.Encoder`); the JAX
field `fused_qkv` raises NotImplementedError when set, and a field the
JAX `Bert` does not have (the decoder fields `norm`, `mlp_act`,
`use_bias` ...) raises TypeError (`_UNPORTED`).
"""

from __future__ import annotations

import functools
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from tfde_tpu_torch.models.cnn import dropout
from tfde_tpu_torch.models.transformer import (
    Dense, Encoder, LayerNorm, check_unported, init_flax_)
from tfde_tpu_torch.ops.attention import padding_mask
from tfde_tpu_torch.utils.devices import resolve_device

#: the JAX `Bert`/`BertClassifier` fields outside the port, with the
#: default the port implements; any other name is not a field of theirs
_UNPORTED = {"fused_qkv": False}


class BertEmbeddings(nn.Module):
    """word + position + token-type embeddings, LayerNorm, dropout."""

    def __init__(self, vocab_size: int, hidden_size: int,
                 max_position: int = 512, type_vocab_size: int = 2,
                 dropout_rate: float = 0.1,
                 dtype: torch.dtype = torch.bfloat16, ln_eps: float = 1e-6,
                 device=None):
        super().__init__()
        self.dtype = dtype
        self.dropout_rate = dropout_rate
        self.word = nn.Embedding(vocab_size, hidden_size, device=device)
        self.position = nn.Embedding(max_position, hidden_size,
                                     device=device)
        self.token_type = nn.Embedding(type_vocab_size, hidden_size,
                                       device=device)
        self.ln = LayerNorm(hidden_size, eps=ln_eps, device=device)

    def forward(self, input_ids: torch.Tensor,
                token_type_ids: Optional[torch.Tensor] = None,
                train: bool = False,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        positions = torch.arange(input_ids.shape[1], device=input_ids.device)
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        x = self.word(input_ids).to(self.dtype)
        x = x + self.position(positions).to(self.dtype)
        x = x + self.token_type(token_type_ids).to(self.dtype)
        x = self.ln(x).to(self.dtype)
        return dropout(x, self.dropout_rate, train, generator)


class _Trunk(nn.Module):
    """The embeddings + encoder trunk `Bert` and `BertClassifier` share
    (the JAX `_trunk`: one construction site, one set of names)."""

    def __init__(self, vocab_size: int = 30522, hidden_size: int = 768,
                 depth: int = 12, num_heads: int = 12, mlp_dim: int = 3072,
                 max_position: int = 512, type_vocab_size: int = 2,
                 dropout_rate: float = 0.1,
                 dtype: torch.dtype = torch.bfloat16,
                 attn_impl: str = "auto", pad_vocab: bool = False,
                 ln_eps: float = 1e-6, device=None, **fields):
        super().__init__()
        remat = fields.pop("remat", False)
        check_unported(type(self).__name__, fields, _UNPORTED)
        if hidden_size % num_heads:
            raise ValueError(f"hidden_size {hidden_size} must divide by "
                             f"num_heads {num_heads}")
        self.vocab_size = vocab_size
        self.pad_vocab = pad_vocab
        self.hidden_size = hidden_size
        self.depth = depth
        self.num_heads = num_heads
        self.dtype = dtype
        self.embeddings = BertEmbeddings(
            self.padded_vocab, hidden_size, max_position, type_vocab_size,
            dropout_rate, dtype, ln_eps, device=device)
        self.encoder = Encoder(depth, hidden_size, num_heads,
                               hidden_size // num_heads, mlp_dim, dtype,
                               attn_impl=attn_impl, ln_eps=ln_eps,
                               norm_style="post", dropout_rate=dropout_rate,
                               remat=remat, device=device)

    @property
    def padded_vocab(self) -> int:
        if not self.pad_vocab:
            return self.vocab_size
        return -(-self.vocab_size // 128) * 128

    @property
    def device(self) -> torch.device:
        return self.embeddings.word.weight.device

    def trunk(self, input_ids, attention_mask, token_type_ids, train,
              generator) -> torch.Tensor:
        x = self.embeddings(input_ids, token_type_ids, train, generator)
        mask = None if attention_mask is None else padding_mask(
            attention_mask)
        return self.encoder(x, mask=mask, train=train, generator=generator)

    def set_attn_impl(self, impl: str) -> None:
        """Attention implementation of every layer ('auto' | 'reference' |
        'flash', ops/attention.attention)."""
        for block in self.encoder.blocks():
            block.attn.attn_impl = impl


class Bert(_Trunk):
    """BERT with the tied masked-LM head over [B, S] int token ids ->
    [B, S, padded vocab] fp32 logits."""

    def __init__(self, vocab_size: int = 30522, hidden_size: int = 768,
                 depth: int = 12, num_heads: int = 12, mlp_dim: int = 3072,
                 max_position: int = 512, type_vocab_size: int = 2,
                 dropout_rate: float = 0.1,
                 dtype: torch.dtype = torch.bfloat16,
                 attn_impl: str = "auto", pad_vocab: bool = False,
                 ln_eps: float = 1e-6, device=None, seed: int = 0,
                 **fields):
        device = resolve_device(device)
        super().__init__(vocab_size, hidden_size, depth, num_heads, mlp_dim,
                         max_position, type_vocab_size, dropout_rate, dtype,
                         attn_impl, pad_vocab, ln_eps, device, **fields)
        self.mlm_dense = Dense(hidden_size, hidden_size, dtype,
                               device=device)
        self.mlm_ln = LayerNorm(hidden_size, eps=ln_eps, device=device)
        self.mlm_bias = nn.Parameter(torch.zeros(self.padded_vocab,
                                                 device=device))
        init_flax_(self, torch.Generator(device=device).manual_seed(seed))

    def forward(self, input_ids: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None,
                token_type_ids: Optional[torch.Tensor] = None,
                train: bool = False,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        x = self.trunk(input_ids, attention_mask, token_type_ids, train,
                       generator)
        h = self.mlm_ln(F.gelu(self.mlm_dense(x), approximate="tanh"))
        logits = F.linear(h.to(self.dtype),
                          self.embeddings.word.weight.to(self.dtype))
        return logits.to(self.mlm_bias.dtype) + self.mlm_bias


class BertClassifier(_Trunk):
    """BERT + pooler (tanh(Dense) on the [CLS] position) + classifier over
    [B, S] ids -> [B, num_labels] fp32 logits. The trunk has `Bert`'s
    names and shapes: `classifier_params_from_mlm` grafts an MLM-trained
    trunk under fresh heads."""

    def __init__(self, num_labels: int, vocab_size: int = 30522,
                 hidden_size: int = 768, depth: int = 12, num_heads: int = 12,
                 mlp_dim: int = 3072, max_position: int = 512,
                 type_vocab_size: int = 2, dropout_rate: float = 0.1,
                 dtype: torch.dtype = torch.bfloat16,
                 attn_impl: str = "auto", pad_vocab: bool = False,
                 ln_eps: float = 1e-6, device=None, seed: int = 0,
                 **fields):
        device = resolve_device(device)
        super().__init__(vocab_size, hidden_size, depth, num_heads, mlp_dim,
                         max_position, type_vocab_size, dropout_rate, dtype,
                         attn_impl, pad_vocab, ln_eps, device, **fields)
        self.dropout_rate = dropout_rate
        self.pooler = Dense(hidden_size, hidden_size, dtype, device=device)
        head = torch.promote_types(dtype, torch.float32)
        self.classifier = Dense(hidden_size, num_labels, head, device=device)
        init_flax_(self, torch.Generator(device=device).manual_seed(seed))

    def forward(self, input_ids: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None,
                token_type_ids: Optional[torch.Tensor] = None,
                train: bool = False,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        x = self.trunk(input_ids, attention_mask, token_type_ids, train,
                       generator)
        pooled = torch.tanh(self.pooler(x[:, 0]))
        pooled = dropout(pooled, self.dropout_rate, train, generator)
        return self.classifier(pooled)


def classifier_params_from_mlm(classifier: BertClassifier,
                               mlm_state: dict) -> dict:
    """A state_dict for `classifier`: its own (freshly initialised) pooler
    and classifier, with the embeddings and encoder grafted from an
    MLM-trained `Bert` state_dict — the standard fine-tuning start."""
    for k in ("embeddings.", "encoder."):
        if not any(name.startswith(k) for name in mlm_state):
            raise ValueError(f"the MLM state carries no {k[:-1]!r} subtree "
                             f"— pass a Bert state_dict")
    out = dict(classifier.state_dict())
    out.update({k: v for k, v in mlm_state.items()
                if k.startswith(("embeddings.", "encoder."))})
    return out


BertBase = functools.partial(
    Bert, hidden_size=768, depth=12, num_heads=12, mlp_dim=3072)
BertLarge = functools.partial(
    Bert, hidden_size=1024, depth=24, num_heads=16, mlp_dim=4096)


def bert_tiny_test(**kw) -> Bert:
    """The JAX package's CI config (vocab 97, width 32, 2 layers, 4 heads,
    fp32, dropout 0)."""
    return Bert(vocab_size=97, hidden_size=32, depth=2, num_heads=4,
                mlp_dim=64, max_position=64, dtype=torch.float32,
                dropout_rate=0.0, **kw)

