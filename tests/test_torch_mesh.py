"""The port's meshes and strategies (tfde_tpu_torch.runtime.mesh,
parallel.strategies) held against the JAX package's.

`MeshSpec` on the cases of tests/test_mesh.py (fill, non-divisible,
unknown axis, two fills, canonical order) against the JAX `MeshSpec`:
the same sizes in the same order, or the same exception. The meshes at
world size 1 (no process group: a `LocalMesh`, and no group is built
behind the caller's back) and at world size 2 (a gloo group of two
processes: `DeviceMesh`es with the JAX axis names in canonical order,
laid over the ranks in order). The strategies' unported options raise.
"""

import jax
import pytest
import torch
import torch.distributed as dist

from tfde_tpu.runtime import mesh as jmesh
from tfde_tpu_torch import testing
from tfde_tpu_torch.models.cnn import PlainCNN
from tfde_tpu_torch.parallel import strategies
from tfde_tpu_torch.runtime import mesh

#: one intra-op torch thread for the module (`testing.one_thread`)
_one_thread = pytest.fixture(autouse=True, scope="module")(testing.one_thread)

#: (shape, devices) cases of MeshSpec(shape).resolve(devices)
SPEC_CASES = {
    "fill": ({"data": -1, "tensor": 2}, 8),
    "fill_alone": ({"data": -1}, 8),
    "rejects_nondivisible": ({"data": 3}, 8),
    "rejects_unknown_axis": ({"bogus": 2}, 8),
    "rejects_two_fills": ({"data": -1, "fsdp": -1}, 8),
    "rejects_wrong_product": ({"data": 2, "tensor": 2}, 8),
    "canonical_order": ({"tensor": 2, "data": 4}, 8),
    "canonical_order_all_axes": ({"tensor": 1, "seq": 1, "expert": 1,
                                  "fsdp": 2, "data": -1, "pipe": 1}, 4),
}


def _resolve(module, shape, n):
    try:
        return ("ok", list(module.MeshSpec(shape).resolve(n).items()))
    except ValueError as e:
        return (ValueError, str(e))


@pytest.mark.parametrize("case", list(SPEC_CASES))
def test_meshspec_matches_jax(case):
    shape, n = SPEC_CASES[case]
    want = _resolve(jmesh, shape, n)
    assert _resolve(mesh, shape, n) == want
    assert (want[0] == "ok") == case.startswith(("fill", "canonical"))


def test_axis_order_is_the_jax_packages():
    assert mesh.AXIS_ORDER == jmesh.AXIS_ORDER


def test_meshes_without_a_group_have_one_rank():
    assert not dist.is_initialized()
    dp = mesh.data_parallel_mesh()
    assert isinstance(dp, mesh.LocalMesh)
    assert (dp.mesh_dim_names, dp.shape, dp.size()) == (("data",), (1,), 1)
    two = mesh.make_mesh({"tensor": 1, "data": -1})
    assert two.mesh_dim_names == ("data", "tensor")
    assert mesh.local_mirrored_mesh() == dp
    with pytest.raises(ValueError, match="does not divide"):
        mesh.make_mesh({"data": 2})
    assert not dist.is_initialized()  # never built behind our back


def test_meshes_of_a_two_rank_group(tmp_path):
    out = testing.run_ranks(testing.mesh_worker,
                            [(2, str(tmp_path / "store"))] * 2)
    want_two = jax.make_mesh((1, 2), ("data", "tensor"),
                             devices=jax.devices()[:2])
    for rank, o in enumerate(out):
        assert o["dp"] == (("data",), (2,), rank)
        assert o["two"] == (tuple(want_two.axis_names),
                            tuple(want_two.devices.shape), [[0, 1]])
        assert o["mirrored"] == (2, 2, rank)


def test_strategy_at_one_rank():
    strat = strategies.MultiWorkerMirroredStrategy()
    assert (strat.num_replicas, strat.batch_divisor, strat.data_rank()) == (
        1, 1, 0)
    assert strat.data_group is None
    assert strat.describe() == "MultiWorkerMirroredStrategy(mesh={'data': 1})"
    model = PlainCNN(device="cpu")
    assert strat.replicate(model) is model
    x = torch.arange(6)
    assert torch.equal(strat.local_rows(x), x)


@pytest.mark.parametrize("kwargs,error", [
    ({"grad_transport": "int8"}, NotImplementedError),
    ({"opt_sharding": "shard"}, NotImplementedError),
    ({"grad_transport": "fp16"}, ValueError),
    ({"opt_sharding": "sharded"}, ValueError),
])
def test_unported_strategy_options_raise(kwargs, error):
    with pytest.raises(error):
        strategies.MirroredStrategy(**kwargs)
    strategies.MirroredStrategy(grad_transport="fp32",
                                opt_sharding="replicated")


#: the strategies not ported, and FSDPStrategy (ported on FSDP2) with the
#: int8 gradient transport it does not take yet
UNPORTED = {"FSDPStrategy": {"grad_transport": "int8"},
            "TensorParallelStrategy": {}, "SequenceParallelStrategy": {},
            "ExpertParallelStrategy": {}, "PipelineParallelStrategy": {}}


@pytest.mark.parametrize("name", list(UNPORTED))
def test_unported_strategies_raise(name):
    with pytest.raises(NotImplementedError, match="scale-out slice"):
        getattr(strategies, name)(**UNPORTED[name])
