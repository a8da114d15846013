"""The port's routed MoE layer (tfde_tpu_torch/models/moe.py) against the
JAX `MoEMlp` on the same weights.

Seeded numpy weights in the flax layout of a JAX `MoEMlp`
(`testing.seeded_params`: no compiled `init`) go through
`from_flax_params` into the port's layer; on the same inputs (fp32, the
CPU) the output, the load-balance loss, the z-loss and the gradients of
a scalar of the output and the losses with respect to the input, the
router, the expert stacks and the shared expert are held to the JAX
layer's and `jax.grad`'s within 1e-5 max abs over max(1, the largest
magnitude). The cases are the twins of
`tests/test_moe.py`'s (gelu + bias, swiglu, the Qwen2-MoE shared expert
with raw top-k gates, k = 1, 2, 4, capacity 1.0 and 1.25 over several
groups with choices really dropped, explicit `num_groups`, the z-loss),
each through both expert-buffer layouts ('padded' and 'sorted'). The
layer never builds the [G, m, E, C] one-hot, and `group_capacity` and
`dispatch_shape` equal JAX's over a grid.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from tfde_tpu.models import moe as jmoe
from tfde_tpu_torch.models import moe as tmoe
from tfde_tpu_torch.models.flax_weights import from_flax_params
from tfde_tpu_torch.models.transformer import TransformerBlock
from tfde_tpu_torch.testing import one_thread, seeded_params

#: one intra-op torch thread for the module (`testing.one_thread`)
_one_thread = pytest.fixture(autouse=True, scope="module")(one_thread)

#: output, losses and gradients, max abs error over max(1, the largest
#: magnitude of the JAX tensor) (fp32: the same sums in another order;
#: the expert gradients reach 25)
TOL = 1e-5


def _close(got, want) -> bool:
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max()) <= TOL * max(
        1.0, float(np.abs(want).max()))


#: JAX `MoEMlp` fields of each case (dtype float32); `router_scale`
#: multiplies the router kernel so that routing is skewed and the
#: capacity-limited cases drop choices
CASES = {
    "gelu_bias_z_loss": dict(num_experts=4, mlp_dim=12,
                             router_z_loss_weight=1e-3),
    "shared_raw_k4": dict(num_experts=6, mlp_dim=12, act="swiglu",
                          use_bias=False, experts_per_token=4,
                          normalize_topk=False, shared_expert_dim=10),
    "k1_cap1_drops": dict(num_experts=4, mlp_dim=12, experts_per_token=1,
                          capacity_factor=1.0, router_scale=3.0),
    "k2_cap125_groups_drops": dict(num_experts=4, mlp_dim=12,
                                   capacity_factor=1.25, num_groups=6,
                                   router_scale=3.0),
    "swiglu_k2_cap1_drops": dict(num_experts=4, mlp_dim=12, act="swiglu",
                                 use_bias=False, capacity_factor=1.0,
                                 router_scale=3.0),
}
#: the cases whose routing must drop some choices
DROPPY = ("k1_cap1_drops", "k2_cap125_groups_drops", "swiglu_k2_cap1_drops")
B, S, D = 3, 16, 8


def _port_layer(fields: dict) -> tmoe.MoEMlp:
    return tmoe.MoEMlp(
        D, fields["num_experts"], fields["mlp_dim"],
        experts_per_token=fields.get("experts_per_token", 2),
        capacity_factor=fields.get("capacity_factor", 1.25),
        act=fields.get("act", "gelu"), use_bias=fields.get("use_bias", True),
        normalize_topk=fields.get("normalize_topk", True),
        shared_expert_dim=fields.get("shared_expert_dim"),
        router_z_loss_weight=fields.get("router_z_loss_weight", 0.0),
        num_groups=fields.get("num_groups"), dtype=torch.float32,
        device="cpu")


def _dropped(x, kernel, fields) -> int:
    """Routed choices at a slot past the capacity, counted in numpy from
    the routing rule (softmax, top-k with ties in index order, slots by a
    running count over each group's choice-major stream)."""
    e, k = fields["num_experts"], fields.get("experts_per_token", 2)
    g = fields.get("num_groups") or x.shape[0]
    tokens = x.reshape(g, -1, x.shape[-1]).astype(np.float64)
    m = tokens.shape[1]
    cap = jmoe.group_capacity(m, e, k, fields.get("capacity_factor", 1.25))
    dropped = 0
    for grp in tokens:
        idx = np.argsort(-(grp @ kernel), axis=-1, kind="stable")[:, :k]
        count = np.zeros(e, int)
        for j in range(k):
            for t in range(m):
                dropped += count[idx[t, j]] >= cap
                count[idx[t, j]] += 1
    return int(dropped)


@pytest.fixture(scope="module")
def jax_runs():
    """{case: (x, flax params, y, losses, grads)}: the JAX layer's output,
    its sown losses by name, and the gradients of sum(y cos y) + the
    losses with respect to the params and x."""
    runs = {}
    rng = np.random.default_rng(0)
    for name, fields in CASES.items():
        fields = dict(fields)
        scale = fields.pop("router_scale", 1.0)
        jm = jmoe.MoEMlp(dtype=jnp.float32, **fields)
        x = rng.standard_normal((B, S, D)).astype(np.float32)
        params = seeded_params(jax.eval_shape(
            jm.init, jax.random.key(0), jnp.asarray(x))["params"], len(runs))
        params["router"]["kernel"] = params["router"]["kernel"] * scale

        def apply(p, xs):
            y, mut = jm.apply({"params": p}, xs, mutable=["losses"])
            return y, {k: sum(jnp.sum(v) for v in jax.tree.leaves(t))
                       for k, t in mut["losses"].items()}

        def objective(p, xs):
            y, losses = apply(p, xs)
            return jnp.sum(y * jnp.cos(y)) + sum(losses.values()), (y, losses)

        (_, (y, losses)), (gp, gx) = jax.jit(jax.value_and_grad(
            objective, argnums=(0, 1), has_aux=True))(params, jnp.asarray(x))
        runs[name] = (x, params, np.asarray(y),
                      {k: float(v) for k, v in losses.items()},
                      (jax.tree.map(np.asarray, gp), np.asarray(gx)))
    return runs


@pytest.mark.parametrize("layout", ["padded", "sorted"])
@pytest.mark.parametrize("case", list(CASES))
def test_moe_layer_matches_jax(jax_runs, case, layout, monkeypatch):
    x, params, want_y, want_losses, (want_gp, want_gx) = jax_runs[case]
    fields = CASES[case]
    layer = _port_layer(fields)
    layer.load_state_dict(from_flax_params(params))
    monkeypatch.setattr(tmoe, "expert_layout", lambda *a: layout)
    xt = torch.tensor(x, requires_grad=True)
    losses = {}
    y = layer(xt, losses=losses)
    got_losses = {k: sum(v) for k, v in losses.items()}
    assert set(got_losses) == set(want_losses)
    assert ("moe_z" in got_losses) == ("router_z_loss_weight" in fields)
    assert _close(y.detach().numpy(), want_y)
    for k, v in want_losses.items():
        assert _close(float(got_losses[k].detach()), v)
    ((y * torch.cos(y)).sum() + sum(got_losses.values())).backward()
    assert _close(xt.grad.numpy(), want_gx)
    want = from_flax_params(want_gp)
    assert set(want) == {n for n, _ in layer.named_parameters()}
    for n, p in layer.named_parameters():
        assert _close(p.grad.numpy(), want[n].numpy()), n
    if case in DROPPY:
        assert _dropped(x, params["router"]["kernel"], fields) > 0


def test_without_losses_dict_nothing_is_computed_for_them():
    layer = _port_layer(CASES["gelu_bias_z_loss"])
    torch.nn.init.normal_(layer.router.weight)
    for w in layer.expert_weights():
        torch.nn.init.normal_(w)
    x = torch.randn(B, S, D)
    losses = {}
    with torch.no_grad():
        y0 = layer(x)
        y1 = layer(x, losses=losses)
    assert torch.equal(y0, y1)
    assert sorted(losses) == ["moe_aux", "moe_z"]
    assert tmoe.sown_losses_by_name({"moe_aux": [torch.tensor(1.0),
                                                 torch.tensor(2.5)]}) \
        == {"moe_aux": torch.tensor(3.5)}


class _Shapes(TorchDispatchMode):
    """Records the element count of every tensor an op returns."""

    def __init__(self):
        super().__init__()
        self.largest = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor):
                self.largest = max(self.largest, t.numel())
        return out


@pytest.mark.parametrize("layout", ["padded", "sorted"])
def test_no_dispatch_one_hot_at_the_dropless_capacity(layout, monkeypatch):
    """At the converters' capacity E / k (C = m) the JAX layer's dispatch
    tensor is [G, m, E, m]; the port's largest intermediate (forward and
    backward) stays far below it."""
    e, k, m, g = 8, 2, 256, 2
    layer = tmoe.MoEMlp(D, e, 12, experts_per_token=k,
                        capacity_factor=e / k, dtype=torch.float32,
                        device="cpu")
    torch.nn.init.normal_(layer.router.weight)
    for w in layer.expert_weights():
        torch.nn.init.normal_(w)
    monkeypatch.setattr(tmoe, "expert_layout", lambda *a: layout)
    c = jmoe.dispatch_shape(g, m, e, k, e / k)[3]
    assert c >= m
    x = torch.randn(g, m, D, requires_grad=True)
    with _Shapes() as shapes:
        losses = {}
        y = layer(x, losses=losses)
        (y.square().sum() + sum(losses["moe_aux"])).backward()
    one_hot = g * m * e * c
    assert shapes.largest * 16 <= one_hot


@pytest.mark.parametrize("m", [1, 3, 16, 100])
@pytest.mark.parametrize("e,k,cf", [(4, 2, 1.25), (8, 1, 1.0), (60, 4, 15.0),
                                    (8, 2, 4.0), (16, 2, 0.5)])
def test_capacity_matches_jax(m, e, k, cf):
    assert tmoe.group_capacity(m, e, k, cf) == jmoe.group_capacity(m, e, k,
                                                                  cf)
    for batch, groups in ((4, None), (4, 2), (2, 4)):
        assert tmoe.dispatch_shape(batch, m * 2, e, k, cf, groups) \
            == jmoe.dispatch_shape(batch, m * 2, e, k, cf, groups)
    with pytest.raises(ValueError, match="groups"):
        tmoe.dispatch_shape(3, 5, e, k, cf, num_groups=2)


def test_layouts_and_refusals():
    assert tmoe.expert_layout(60, 8, 32) == "padded"       # a decode tick
    assert tmoe.expert_layout(60, 4096, 16384) == "padded"  # [8, 512] wave
    assert tmoe.expert_layout(8, 2560, 16384) == "padded"  # gpt_lm --moe
    assert tmoe.expert_layout(60, 8192, 32768) == "sorted"  # [8, 1024]
    with pytest.raises(ValueError, match="act must be"):
        tmoe.MoEMlp(8, 4, 12, act="relu", device="cpu")
    with pytest.raises(NotImplementedError, match="Qwen2-MoE"):
        tmoe.MoEMlp(8, 4, 12, shared_expert_dim=8, device="cpu")
    # the JAX block's refusals keep their wording: other expert MLPs, and
    # MoE under int8 weights (quant stays unported in the port)
    with pytest.raises(NotImplementedError, match="MoE expert MLPs"):
        TransformerBlock(16, 2, 8, 32, torch.float32, mlp_act="swiglu",
                         use_bias=True, num_experts=4, device="cpu")
    with pytest.raises(NotImplementedError, match="quant"):
        TransformerBlock(16, 2, 8, 32, torch.float32, num_experts=4,
                         quant="int8", device="cpu")
    with pytest.raises(ValueError, match="groups"):
        tmoe.MoEMlp(8, 4, 12, num_groups=5, dtype=torch.float32,
                    device="cpu")(torch.zeros(2, 3, 8))


def test_ties_route_to_the_lower_expert_first():
    """Equal router probabilities pick the lower expert index first, as
    `jax.lax.top_k` does."""
    probs = torch.tensor([[0.1, 0.3, 0.3, 0.3], [0.25, 0.25, 0.25, 0.25]])
    vals, idx = tmoe.top_k(probs, 2)
    jvals, jidx = jax.lax.top_k(jnp.asarray(probs.numpy()), 2)
    assert idx.tolist() == np.asarray(jidx).tolist() == [[1, 2], [0, 1]]
    assert np.allclose(vals.numpy(), np.asarray(jvals))
