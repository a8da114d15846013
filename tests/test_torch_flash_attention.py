"""The port's attention ops (tfde_tpu_torch/ops) held against the JAX package.

`flash_forward_reference` — the plain PyTorch version of the CUDA flash
kernel, and what a CPU tensor runs — against the Pallas forward
`_flash_forward(..., interpret=True)`: out and lse within 1e-5 relative
Frobenius (the bound of tests/test_softcap_flash.py) over causal /
non-causal x MHA / GQA x window x cap x scale, multi-tile. A ragged S (the
Pallas kernel refuses it; the CUDA kernel masks the edge) is held against
`reference_attention`. The band helpers, the grouped einsum and the
dispatcher are compared too. Inputs come from numpy seeds, fp32. The CUDA
kernel itself is compared with this plain version on the card by
chip_smoke.py.
"""

import ast
import ctypes
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfde_tpu.ops import attention as jattn
from tfde_tpu.ops import flash_attention as jfa
from tfde_tpu_torch.ops import attention as tattn
from tfde_tpu_torch.ops import flash_attention as tfa

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _qkv(seed, b, s, h, kv, d):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((b, s, h, d), (b, s, kv, d), (b, s, kv, d))]


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


# (name, causal, window, scale, cap, kv heads of 4 query heads);
# S=64 with 32-blocks -> 2x2 tiles on the JAX side
CASES = [
    ("causal", True, None, None, None, 4),
    ("bidir", False, None, None, None, 4),
    ("causal_gqa", True, None, None, None, 2),
    ("bidir_mqa", False, None, None, None, 1),
    ("window", True, 24, None, None, 4),
    ("cap", True, None, None, 20.0, 4),
    ("window_gqa_cap_scale", True, 24, 0.2, 30.0, 2),
    ("bidir_gqa_cap_scale", False, None, 0.25, 40.0, 2),
]


@pytest.mark.parametrize("name,causal,window,scale,cap,kv", CASES,
                         ids=[c[0] for c in CASES])
def test_flash_reference_matches_pallas_forward(name, causal, window, scale,
                                                cap, kv):
    q, k, v = _qkv(sum(map(ord, name)), 2, 64, 4, kv, 16)
    j_out, j_lse = jfa._flash_forward(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal, 32, 32, True,
        window, scale, cap)
    t_out, t_lse = tfa.flash_forward(
        torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v), causal,
        window, scale, cap)
    assert t_out.shape == j_out.shape and t_lse.shape == j_lse.shape
    assert _rel(t_out.numpy(), j_out) <= 1e-5
    assert _rel(t_lse.numpy(), j_lse) <= 1e-5


@pytest.mark.parametrize("causal,window,cap,kv", [
    (True, None, None, 4), (True, 9, 25.0, 2), (False, None, None, 2)])
def test_flash_ragged_s_matches_jax_reference(causal, window, cap, kv):
    # S=37 divides no tile: the Pallas kernel refuses it, the port masks it
    q, k, v = _qkv(7, 2, 37, 4, kv, 16)
    want = jattn.reference_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        window=window, logit_cap=cap)
    got = tfa.flash_attention(torch.as_tensor(q), torch.as_tensor(k),
                              torch.as_tensor(v), causal, window, None, cap)
    assert _rel(got.numpy(), want) <= 1e-5


BANDS = [(64, 16, 16, True, None), (64, 16, 32, True, 20),
         (96, 32, 16, True, 7), (64, 32, 32, False, None),
         (128, 32, 64, True, 1)]


@pytest.mark.parametrize("s,bq,bk,causal,window", BANDS)
def test_band_helpers_match_jax(s, bq, bk, causal, window):
    for qi in range(s // bq):
        for kb in range(s // bk):
            assert bool(tfa._tile_in_band(qi, kb, bq, bk, causal, window)) \
                == bool(jfa._tile_in_band(qi, kb, bq, bk, causal, window))
    assert tfa._band_tile_pairs(s, bq, bk, causal, window) \
        == jfa._band_tile_pairs(s, bq, bk, causal, window)
    for blocks in ((bq, bk), (None, None)):
        assert tfa.bwd_tile_plan(s, *blocks, causal=causal, window=window) \
            == jfa.bwd_tile_plan(s, *blocks, causal=causal, window=window)


@pytest.mark.parametrize("mask_ndim", [None, 2, 3, 4])
@pytest.mark.parametrize("causal,window,kv", [(False, None, 2),
                                              (True, 5, 4), (True, None, 1)])
def test_grouped_attention_matches_jax(mask_ndim, causal, window, kv):
    q, k, v = _qkv(3, 2, 12, 4, kv, 8)
    rng = np.random.default_rng(4)
    mask = None
    if mask_ndim is not None:
        shape = {2: (12, 12), 3: (2, 12, 12), 4: (2, 1, 12, 12)}[mask_ndim]
        mask = rng.random(shape) < 0.8
        mask[..., 0] = True  # every row keeps a key (col 0 is causal too)
    want = jattn.grouped_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        mask=None if mask is None else jnp.asarray(mask), causal=causal,
        window=window, scale=0.3, logit_cap=15.0)
    got = tattn.grouped_attention(
        torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v),
        mask=None if mask is None else torch.as_tensor(mask), causal=causal,
        window=window, scale=0.3, logit_cap=15.0)
    assert _rel(got.numpy(), want) <= 1e-5


def test_attention_dispatch_on_cpu():
    q, k, v = (torch.as_tensor(t) for t in _qkv(5, 1, 16, 4, 2, 8))
    before = tfa.flash_forward.launches
    ref = tattn.attention(q, k, v, causal=True, impl="reference")
    for impl in ("auto", "flash"):
        got = tattn.attention(q, k, v, causal=True, impl=impl)
        assert _rel(got.numpy(), ref.numpy()) <= 1e-5
    # a CPU tensor never launches the kernel
    assert tfa.flash_forward.launches == before
    with pytest.raises(NotImplementedError, match="ring"):
        tattn.attention(q, k, v, causal=True, impl="ring")
    with pytest.raises(NotImplementedError, match="mask"):
        tattn.attention(q, k, v, mask=torch.ones(16, 16, dtype=torch.bool),
                        impl="flash")
    with pytest.raises(ValueError, match="unknown"):
        tattn.attention(q, k, v, impl="bogus")
    pm = tattn.padding_mask(torch.tensor([[1, 1, 0]]))
    assert pm.shape == (1, 1, 1, 3) and pm.dtype == torch.bool


class _ReportsCuda(torch.Tensor):
    """A CPU tensor that reports a CUDA device: it drives the dispatcher's
    CUDA branch here without a card."""

    @property
    def device(self):
        return torch.device("cuda")


@pytest.mark.parametrize("head_dim", [8, 32])
def test_auto_on_cuda_takes_the_kernel_and_raises_on_its_head_dim(head_dim):
    """'auto' on a CUDA tensor goes to the kernel's wrapper whatever the
    shape: a head dim the kernel does not take raises there, and never
    falls back to the plain version."""
    q, k, v = (torch.as_tensor(t).as_subclass(_ReportsCuda)
               for t in _qkv(8, 1, 16, 4, 4, head_dim))
    before = tfa.flash_forward.launches
    with pytest.raises(ValueError, match="head_dim"):
        tattn.attention(q, k, v, causal=True, impl="auto")
    assert tfa.flash_forward.launches == before


@pytest.mark.parametrize("kw,match", [
    (dict(causal=False, window=4), "window"),
    (dict(causal=True, window=0), "window"),
    (dict(causal=True, logit_cap=0.0), "logit_cap"),
])
def test_flash_rejects_what_the_kernel_rejects(kw, match):
    q, k, v = (torch.as_tensor(t) for t in _qkv(6, 1, 8, 4, 4, 8))
    with pytest.raises(ValueError, match=match):
        tfa.flash_forward(q, k, v, **kw)
    with pytest.raises(ValueError, match="multiple"):
        tfa.flash_forward(q, k[:, :, :3], v[:, :, :3])
    with pytest.raises(ValueError, match="self-attention"):
        tfa.flash_forward(q, k[:, :4], v[:, :4])


def test_ctypes_signature_matches_the_c_entry_point():
    """The binding's argtypes against the C prototype in the source: a
    mismatch would truncate a pointer or shift every argument."""
    with open(os.path.join(ROOT, "tfde_tpu_torch", "csrc",
                           "flash_fwd.cu")) as f:
        src = f.read()
    proto = re.search(r'extern "C" int tfde_flash_fwd\((.*?)\)\s*\{', src,
                      re.S).group(1)
    kinds = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p,
             "int": ctypes.c_int, "long long": ctypes.c_longlong,
             "float": ctypes.c_float}
    params = [" ".join(p.split()[:-1]) for p in proto.split(",")]
    assert [kinds[p] for p in params] == list(tfa.ARGTYPES)


def test_port_imports_no_jax():
    """No module of tfde_tpu_torch, and not chip_smoke.py, imports jax, flax
    or tfde_tpu — the machine with the card has none of them."""
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _dirs, names in os.walk(os.path.join(ROOT,
                                                      "tfde_tpu_torch")):
        files += [os.path.join(dirpath, n) for n in names
                  if n.endswith(".py")]
    assert len(files) > 10
    banned = ("jax", "flax", "tfde_tpu")
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            else:
                continue
            for mod in mods:
                assert mod.split(".")[0] not in banned, f"{path}: {mod}"
