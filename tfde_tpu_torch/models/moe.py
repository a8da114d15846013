"""Mixture-of-Experts MLP — counterpart of `tfde_tpu/models/moe.py`.

`MoEMlp` computes the function of the JAX `MoEMlp`: tokens in groups of
m = n / G (G = the batch by default), the fp32 router's softmax over
all E experts, the top k (equal values: the lower expert index first, as
`jax.lax.top_k` orders them), renormalised under `normalize_topk`; each
(token, choice) takes a slot in its expert's per-group capacity C =
ceil(k m / E cf) by a running count over the group's choice-major stream
(every token's first choice ranks ahead of any second choice), choices
at slot >= C are dropped and their gate mass is missing; the experts are
gelu + bias (Switch/GShard) or bias-free swiglu (Mixtral), and
`shared_expert_dim` adds the Qwen2-MoE dense shared expert under its
fp32 sigmoid gate.

The JAX layer dispatches and combines with [G, m, E, C] one-hot einsums,
which are O(m^2 E) at the dropless capacity the converters pin (C = m).
The port builds no such tensor. Each kept choice gets a row in an expert
input buffer, the experts run their products on their rows, and each
token gathers its kept choices' rows back and adds them under their
gates. The buffer has one of two layouts (`expert_layout`), chosen from
the static shapes alone:

- 'padded': [E, G * C', d] (C' = min(C, m): a token takes an expert at
  most once, so slots past m stay empty), each expert's slots in stream
  order, empty slots zero; one batched product a projection, no host
  sync. It is taken where the padding is cheap: few rows an expert (a
  decode tick, a short prefill wave) or little padding (a droppy
  training capacity);
- 'sorted': the kept choices sorted by (expert, group, slot), each
  expert's rows contiguous; one host sync a layer reads the counts, then
  each expert's products run on its own rows. A long dropless prefill
  takes it, where the padded layout would be E / k times the work.

Both gather one input row a (token, choice) with `index_select`, so no
row of a backward's `index_add_` takes two values: the gradients are the
same bits run to run on the card.

Casts follow `moe.py:183-214`: the expert input in `dtype`, the products
accumulated in fp32 with the biases added in fp32 (a product in bf16
comes out rounded to bf16 first, one rounding more than JAX's fp32
accumulation output), silu and the gate product in `dtype`, the combine
weights cast to `dtype` and summed in fp32.

The losses are returned to the caller through `losses`, a dict the
caller passes (the counterpart of flax's 'losses' collection): each call
appends its Switch load-balance loss `aux_loss_weight * E * sum(f * P)`
(f from the top-1 choices over all tokens, P the mean router
probability) under ``moe_aux`` and, when `router_z_loss_weight` > 0, the
ST-MoE z-loss `w * mean(logsumexp(logits)^2)` under ``moe_z``. Without a
dict they are not computed (JAX discards them then). `sown_losses_by_name`
sums them by name.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from tfde_tpu_torch.models.cnn import dropout

#: the padded layout is taken when an expert holds at most this many rows
#: ... Measured on H100s (700 W) in four runs at Qwen1.5-MoE-A2.7B's
#: widths, where the padded layout does E / k = 15 times the routed rows'
#: products, a 24-layer prefill wave padded / sorted (CUDA events): [8,
#: 128] tokens (1024 rows an expert) 92.36-139.27 / 279.33-588.99 ms;
#: [8, 512] (4096 rows) 345.48-347.39 / 295.27-469.01, padded faster in
#: three runs; [8, 1024] (8192 rows) 679.58-686.08 / 350.15-735.24,
#: sorted faster in three. The sorted layout's time is host time (its
#: per-expert loop after a sync), so the crossover moves with the host
#: (chip_smoke.py's moe phase)
PADDED_MAX_ROWS = 4096
#: ... or when the padded rows are at most this multiple of the choices:
#: gpt_lm --moe 8's layer (2560 rows an expert, 1.25 times its choices)
#: took 4.230-4.269 ms forward and backward padded and 8.077-14.306 ms
#: sorted on the same cards; the [8, 1024] wave above (15 times) was
#: faster sorted
PADDED_MAX_WASTE = 2


def group_capacity(tokens_per_group: int, num_experts: int,
                   experts_per_token: int, capacity_factor: float) -> int:
    """Per-group expert capacity C = ceil(k * m / E * cf) — linear in the
    group's token count m, never in the global token count."""
    return max(1, math.ceil(
        experts_per_token * tokens_per_group / num_experts * capacity_factor))


def dispatch_shape(batch: int, seq: int, num_experts: int,
                   experts_per_token: int = 2, capacity_factor: float = 1.25,
                   num_groups: Optional[int] = None) -> tuple:
    """The [G, m, E, C] dispatch shape of the JAX `MoEMlp`: the groups, the
    tokens a group, the experts and the per-group capacity. The port never
    builds a tensor of this shape; it is kept so capacity scaling is
    testable without running the layer."""
    n = batch * seq
    g = num_groups or batch
    if n % g:
        raise ValueError(f"{n} tokens not divisible into {g} groups")
    m = n // g
    c = group_capacity(m, num_experts, experts_per_token, capacity_factor)
    return (g, m, num_experts, c)


def expert_layout(num_experts: int, rows_per_expert: int,
                  choices: int) -> str:
    """'padded' or 'sorted' (module docstring) for `rows_per_expert` = G *
    C' padded rows an expert and `choices` = n * k routed choices."""
    if (rows_per_expert <= PADDED_MAX_ROWS
            or num_experts * rows_per_expert <= PADDED_MAX_WASTE * choices):
        return "padded"
    return "sorted"


def sown_losses_by_name(losses: Optional[dict]) -> dict:
    """{name: the sum of every value under that name} for a `losses`
    dict the model filled (name -> list of per-layer scalars): the JAX
    `training.step.sown_losses_by_name`."""
    return {name: torch.stack(list(vals)).sum()
            for name, vals in (losses or {}).items() if vals}


def top_k(probs: torch.Tensor, k: int):
    """The k largest values of the last dim and their indices, equal values
    in index order (`jax.lax.top_k`'s order; `torch.topk` promises none):
    a stable descending sort."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


class MoEMlp(nn.Module):
    """Top-k routed expert MLP over [B, S, d] inputs, the JAX `MoEMlp`'s
    fields and parameters: `router` (fp32 Dense d -> E, no bias),
    `experts_fc1` [E, d, f], `experts_fc2` [E, f, d], `experts_gate` [E,
    d, f] (swiglu), `experts_b1` [E, 1, f] and `experts_b2` [E, 1, d]
    (`use_bias`), and with `shared_expert_dim` s the Dense layers
    `shared_gate` and `shared_fc1` (d -> s), `shared_fc2` (s -> d) in
    `dtype` and the fp32 `shared_expert_gate` (d -> 1). Parameters are
    fp32 and left uninitialised: the owner initialises them
    (`transformer.init_flax_`, `GPT.init_weights_`) or loads them."""

    def __init__(self, embed: int, num_experts: int, mlp_dim: int,
                 experts_per_token: int = 2, capacity_factor: float = 1.25,
                 act: str = "gelu", use_bias: bool = True,
                 normalize_topk: bool = True,
                 shared_expert_dim: Optional[int] = None,
                 aux_loss_weight: float = 0.01,
                 router_z_loss_weight: float = 0.0,
                 dropout_rate: float = 0.0,
                 dtype: torch.dtype = torch.bfloat16,
                 num_groups: Optional[int] = None, device=None):
        from tfde_tpu_torch.models.transformer import Dense

        super().__init__()
        if act not in ("gelu", "swiglu"):
            raise ValueError(f"act must be 'gelu' or 'swiglu', got {act!r}")
        if shared_expert_dim is not None and (act != "swiglu" or use_bias):
            raise NotImplementedError(
                "shared_expert_dim is the Qwen2-MoE arrangement: bias-free "
                "swiglu experts only")
        if not 0 < experts_per_token <= num_experts:
            raise ValueError(f"experts_per_token={experts_per_token} must "
                             f"be in [1, num_experts={num_experts}]")
        self.num_experts = num_experts
        self.experts_per_token = experts_per_token
        self.capacity_factor = capacity_factor
        self.act = act
        self.normalize_topk = normalize_topk
        self.aux_loss_weight = aux_loss_weight
        self.router_z_loss_weight = router_z_loss_weight
        self.dropout_rate = dropout_rate
        self.dtype = dtype
        self.num_groups = num_groups
        e, d, f = num_experts, embed, mlp_dim

        def param(*shape):
            return nn.Parameter(torch.empty(*shape, device=device))

        self.router = Dense(d, e, torch.float32, bias=False, device=device)
        self.experts_fc1 = param(e, d, f)
        self.experts_fc2 = param(e, f, d)
        self.experts_gate = param(e, d, f) if act == "swiglu" else None
        if use_bias:
            self.experts_b1 = nn.Parameter(torch.zeros(e, 1, f,
                                                       device=device))
            self.experts_b2 = nn.Parameter(torch.zeros(e, 1, d,
                                                       device=device))
        else:
            self.experts_b1 = self.experts_b2 = None
        if shared_expert_dim is not None:
            s = shared_expert_dim
            self.shared_gate = Dense(d, s, dtype, bias=False, device=device)
            self.shared_fc1 = Dense(d, s, dtype, bias=False, device=device)
            self.shared_fc2 = Dense(s, d, dtype, bias=False, device=device)
            self.shared_expert_gate = Dense(d, 1, torch.float32, bias=False,
                                            device=device)
        else:
            self.shared_gate = None

    def expert_weights(self):
        """The expert stacks a product reads ([E, ...]; the biases are
        added in fp32 and are not among them)."""
        return [w for w in (self.experts_fc1, self.experts_fc2,
                            self.experts_gate) if w is not None]

    @torch.no_grad()
    def init_flax_(self, generator: torch.Generator) -> None:
        """flax's initialisers for the expert stacks: lecun_normal over
        the fan-in dim (`batch_axis=0`: fan-in d for fc1 and the gate, f
        for fc2), zero biases. `transformer.init_flax_` sets the Dense
        layers."""
        for w in self.expert_weights():
            std = math.sqrt(1.0 / w.shape[-2]) / .87962566103423978
            nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                                  generator=generator)
        for b in (self.experts_b1, self.experts_b2):
            if b is not None:
                b.zero_()

    @torch.no_grad()
    def cast_compute_weights_(self) -> None:
        """Cast the expert stacks to the compute dtype once, in place, for
        serving; every product casts them to it anyway. The biases stay
        fp32 (they are added in fp32), and so do the fp32 router and the
        shared expert's gate (`Dense.dtype`)."""
        for w in self.expert_weights():
            w.data = w.data.to(self.dtype)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None,
                losses: Optional[dict] = None) -> torch.Tensor:
        bsz, seq, d = x.shape
        e, k = self.num_experts, self.experts_per_token
        n = bsz * seq
        g = self.num_groups or bsz
        if n % g:
            raise ValueError(f"{n} tokens not divisible into {g} groups")
        m = n // g
        capacity = group_capacity(m, e, k, self.capacity_factor)
        slots = min(capacity, m)
        dev = x.device

        tokens = x.reshape(g, m, d)
        # the router in fp32: routing decisions are precision-sensitive
        logits = self.router(tokens.float())  # [g, m, e]
        probs = torch.softmax(logits, dim=-1)
        gates, choice = top_k(probs, k)  # [g, m, k]
        if self.normalize_topk:
            gates = gates / gates.sum(dim=-1, keepdim=True).clamp_min(1e-9)

        # each choice's slot in its expert's per-group capacity: a running
        # count over the group's choice-major stream [g, k * m]
        stream = choice.transpose(1, 2).reshape(g, k * m)
        hits = stream[..., None] == torch.arange(e, device=dev)
        pos = hits.cumsum(dim=1, dtype=torch.int32).gather(
            2, stream[..., None]).squeeze(-1) - 1
        pos = pos.view(g, k, m).transpose(1, 2)  # [g, m, k]
        kept = pos < capacity
        # a kept choice's row in the padded [E, G, C'] layout (unique);
        # the sorted layout orders the kept choices by it
        group = torch.arange(g, device=dev).view(g, 1, 1)
        key = torch.where(kept, (choice * g + group) * slots + pos,
                          e * g * slots).flatten()
        # one input row a choice (choice c of token t at t * k + c) and a
        # zero row after them: every row the experts read is one choice's
        # or the zero row, so each backward (index_add_) adds at most one
        # value into a choice's row — the same bits run to run — and the
        # k choices of a token add up in the expand's backward
        nk = n * k
        xk = F.pad(tokens.reshape(n, 1, d).to(self.dtype).expand(n, k, d)
                   .reshape(nk, d), (0, 0, 0, 1))

        if expert_layout(e, g * slots, nk) == "padded":
            rows = e * g * slots
            # each padded row's choice (nk: the zero row); dropped
            # choices all land on the extra row `rows`, which is cut off
            take = torch.full((rows + 1,), nk, dtype=torch.long, device=dev)
            take.scatter_(0, key, torch.arange(nk, device=dev))
            out = self._experts(xk.index_select(0, take[:rows])
                                .view(e, g * slots, d))
            row = key
        else:
            order = torch.argsort(key, stable=True)
            counts = torch.zeros(e + 1, dtype=torch.long, device=dev)
            counts.index_add_(0, torch.where(kept, choice, e).flatten(),
                              torch.ones_like(key))
            counts = counts[:e].tolist()  # the layer's one host sync
            total = sum(counts)
            xs = xk.index_select(0, order[:total])
            pieces, start = [], 0
            for j, cnt in enumerate(counts):
                # an expert with no rows still joins the graph in training
                # (a zero gradient, as in JAX), so DDP sees every parameter
                if cnt or torch.is_grad_enabled():
                    pieces.append(self._experts(xs[start:start + cnt], j))
                start += cnt
            out = torch.cat(pieces) if pieces else xs
            rank = torch.empty_like(order)
            rank[order] = torch.arange(order.numel(), device=dev)
            row = rank.clamp(max=total)  # dropped choices: the zero row
            rows = total
        out = F.pad(out.reshape(rows, d), (0, 0, 0, 1))
        picked = out.index_select(0, row).view(g, m, k, d).float()
        weights = torch.where(kept, gates, 0.0).to(self.dtype).float()
        y = (weights[..., None] * picked).sum(dim=2)
        y = y.to(x.dtype).reshape(bsz, seq, d)

        if self.shared_gate is not None:
            sh = F.silu(self.shared_gate(x)) * self.shared_fc1(x)
            sh = self.shared_fc2(sh)
            # a scalar sigmoid gate a token, in fp32 (a saturating gate is
            # precision-sensitive)
            gate = torch.sigmoid(self.shared_expert_gate(x.float()))
            y = y + (gate * sh.float()).to(x.dtype)

        if losses is not None:
            # Switch load balance: top-1 fraction x mean probability over
            # ALL tokens (global, not per group)
            top1 = torch.zeros(e, dtype=torch.float32, device=dev)
            top1.index_add_(0, choice[..., 0].flatten(),
                            torch.ones(n, dtype=torch.float32, device=dev))
            frac = top1 / n
            mean_p = probs.mean(dim=(0, 1))
            losses.setdefault("moe_aux", []).append(
                self.aux_loss_weight * e * (frac * mean_p).sum())
            if self.router_z_loss_weight > 0.0:
                z = torch.logsumexp(logits, dim=-1)
                losses.setdefault("moe_z", []).append(
                    self.router_z_loss_weight * (z * z).mean())
        return dropout(y, self.dropout_rate, train, generator)

    def _experts(self, xs: torch.Tensor, expert: Optional[int] = None
                 ) -> torch.Tensor:
        """The expert MLPs on their rows in `dtype`: xs [E, r, d] through
        every expert at once (batched products), or [r, d] through expert
        `expert`. Returns the rows' outputs in `dtype`."""
        dt = self.dtype

        def w(p):
            p = p if expert is None else p[expert]
            return p.to(dt)

        def bias(b):
            return b.float() if expert is None else b[expert].float()

        h = torch.matmul(xs, w(self.experts_fc1)).float()
        if self.experts_b1 is not None:
            h = h + bias(self.experts_b1)
        if self.act == "swiglu":
            gate = torch.matmul(xs, w(self.experts_gate))
            h = F.silu(gate.to(dt)) * h.to(dt)
        else:
            h = F.gelu(h.to(dt), approximate="tanh")
        out = torch.matmul(h, w(self.experts_fc2)).float()
        if self.experts_b2 is not None:
            out = out + bias(self.experts_b2)
        return out.to(dt)
