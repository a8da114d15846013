"""The port's rotary embeddings (tfde_tpu_torch/ops/rotary.py) against
`tfde_tpu.ops.rotary`: the same numpy inputs from a seed through both,
every frequency-scaling rule, full and partial rotary, shared [S] and
per-row [B, S] positions; fp32 within 1e-6 relative Frobenius (measured
2e-8 to 4e-8: fp32 trig in two libraries), bf16 inputs stay bf16."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfde_tpu.ops import rotary as jrotary
from tfde_tpu_torch.ops import rotary
from tfde_tpu_torch.testing import one_thread

#: one intra-op torch thread for the module (`testing.one_thread`)
_one_thread = pytest.fixture(autouse=True, scope="module")(one_thread)

SCALINGS = [
    None,
    ("linear", 4.0),
    ("llama3", 8.0, 1.0, 4.0, 16),
    ("yarn", 4.0, 32.0, 1.0, 16, 1.1, True),
    ("yarn", 4.0, 32.0, 1.0, 16, 1.1, False),
]


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("scaling", SCALINGS, ids=str)
def test_angles_match_jax(scaling):
    pos = np.random.default_rng(0).integers(0, 64, (3, 11))
    want = jrotary.rotary_angles(jnp.asarray(pos), 16, 500.0, scaling)
    got = rotary.rotary_angles(torch.as_tensor(pos), 16, 500.0, scaling)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape
        assert _rel(g.numpy(), w) <= 1e-6


@pytest.mark.parametrize("scaling", SCALINGS, ids=str)
@pytest.mark.parametrize("rotary_dim", [None, 8])
@pytest.mark.parametrize("per_row", [False, True])
def test_rotation_matches_jax(scaling, rotary_dim, per_row):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 9, 3, 16)).astype(np.float32)
    pos = (rng.integers(0, 40, (2, 9)) if per_row
           else np.arange(5, 14))
    want = jrotary.apply_rotary(jnp.asarray(x), jnp.asarray(pos), 1000.0,
                                rotary_dim=rotary_dim, scaling=scaling)
    got = rotary.apply_rotary(torch.as_tensor(x), torch.as_tensor(pos),
                              1000.0, rotary_dim=rotary_dim,
                              scaling=scaling)
    assert _rel(got.numpy(), want) <= 1e-6
    if rotary_dim is not None:  # the rest passes through untouched
        np.testing.assert_array_equal(got[..., rotary_dim:].numpy(),
                                      x[..., rotary_dim:])


def test_bf16_input_stays_bf16_and_rounds_like_jax():
    x = np.random.default_rng(2).standard_normal((1, 6, 2, 8))
    want = jrotary.apply_rotary(jnp.asarray(x, jnp.bfloat16),
                                jnp.arange(6))
    got = rotary.apply_rotary(torch.as_tensor(x).to(torch.bfloat16),
                              torch.arange(6))
    assert got.dtype == torch.bfloat16
    assert _rel(got.float().numpy(), np.asarray(want, np.float32)) <= 1e-2


def test_bad_arguments_raise_as_in_jax():
    x = torch.zeros((1, 4, 1, 6))
    with pytest.raises(ValueError, match="even"):
        rotary.apply_rotary(torch.zeros((1, 4, 1, 5)), torch.arange(4))
    with pytest.raises(ValueError, match="rotary_dim"):
        rotary.apply_rotary(x, torch.arange(4), rotary_dim=8)
    with pytest.raises(ValueError, match="scaling kind"):
        rotary.rotary_angles(torch.arange(4), 6, scaling=("ntk", 2.0))
