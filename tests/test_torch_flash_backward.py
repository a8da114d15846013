"""The port's flash backward (tfde_tpu_torch/ops/flash_attention.py) held
against the JAX package.

`flash_backward_reference` — the plain PyTorch version of the CUDA
backward pair, and what a CPU tensor runs — against the Pallas pair
`_bwd_pallas(..., interpret=True)` for MHA (residuals from the Pallas
forward), against `jax.vjp` of the JAX `flash_attention` for GQA (which
reaches `_bwd_blockwise`), and against `jax.vjp` of `reference_attention`
for a ragged S (the Pallas path refuses it). dq, dk and dv each within
1e-5 relative Frobenius; inputs from numpy seeds, fp32. Then the autograd
path, the CUDA wrapper's checks (through a tensor that reports a CUDA
device), the kernels' tile loops against `_tile_in_band`, the ctypes
signatures and the build digest. The CUDA kernels themselves are held
against this plain version on the card by chip_smoke.py.
"""

import ctypes
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfde_tpu.ops import attention as jattn
from tfde_tpu.ops import flash_attention as jfa
from tfde_tpu_torch.ops import attention as tattn
from tfde_tpu_torch.ops import flash_attention as tfa
from tfde_tpu_torch.utils import build as tbuild

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "tfde_tpu_torch", "csrc")


def _arrays(seed, b, s, h, kv, d):
    """q, k, v and an output gradient dO, fp32 numpy."""
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((b, s, h, d), (b, s, kv, d), (b, s, kv, d),
                          (b, s, h, d))]


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _port_backward(q, k, v, do, causal, window, scale, cap):
    """The port's plain backward on its own forward's residuals."""
    q, k, v, do = (torch.as_tensor(t) for t in (q, k, v, do))
    out, lse = tfa.flash_forward(q, k, v, causal, window, scale, cap)
    return tfa.flash_backward(q, k, v, out, lse, do, causal, window, scale,
                              cap)


# (name, causal, window, scale, cap); S=64 with 32-tiles on the JAX side
PALLAS_CASES = [
    ("causal", True, None, None, None),
    ("bidir", False, None, None, None),
    ("window", True, 24, None, None),
    ("cap", True, None, None, 20.0),
    ("window_cap_scale", True, 24, 0.2, 30.0),
]


@pytest.mark.parametrize("name,causal,window,scale,cap", PALLAS_CASES,
                         ids=[c[0] for c in PALLAS_CASES])
def test_plain_backward_matches_the_pallas_pair(name, causal, window, scale,
                                                cap):
    q, k, v, do = _arrays(sum(map(ord, name)), 2, 64, 4, 4, 16)
    jq, jk, jv, jdo = (jnp.asarray(t) for t in (q, k, v, do))
    out, lse = jfa._flash_forward(jq, jk, jv, causal, 32, 32, True, window,
                                  scale, cap)
    want = jfa._bwd_pallas((jq, jk, jv, out, lse), jdo, causal=causal,
                           block_q=32, block_k=32, interpret=True,
                           window=window, scale=scale, logit_cap=cap)
    got = tfa.flash_backward(
        *(torch.as_tensor(np.array(t)) for t in (q, k, v, out, lse, do)),
        causal, window, scale, cap)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert _rel(g.numpy(), w) <= 1e-5


@pytest.mark.parametrize("kv", [2, 1])
@pytest.mark.parametrize("causal", [True, False])
def test_gqa_gradient_matches_the_jax_vjp(kv, causal):
    q, k, v, do = _arrays(11 + kv, 2, 64, 4, kv, 16)
    _, vjp = jax.vjp(
        lambda a, b, c: jfa.flash_attention(a, b, c, causal, 32, 32, True),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    got = _port_backward(q, k, v, do, causal, None, None, None)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert _rel(g.numpy(), w) <= 1e-5


@pytest.mark.parametrize("causal,window,cap,kv", [
    (True, None, None, 4), (True, 9, 25.0, 2), (False, None, None, 2)])
def test_ragged_s_gradient_matches_the_jax_reference(causal, window, cap,
                                                     kv):
    q, k, v, do = _arrays(7, 2, 37, 4, kv, 16)

    def grads(a, b, c, g):
        return jax.vjp(lambda *x: jattn.reference_attention(
            *x, causal=causal, window=window, scale=0.3, logit_cap=cap),
            a, b, c)[1](g)

    want = jax.jit(grads)(*(jnp.asarray(t) for t in (q, k, v, do)))
    got = _port_backward(q, k, v, do, causal, window, 0.3, cap)
    for g, w in zip(got, want):
        assert _rel(g.numpy(), w) <= 1e-5


@pytest.mark.parametrize("causal,window,cap,kv", [
    (True, None, None, 4), (True, 20, 30.0, 2), (False, None, 15.0, 1)])
def test_autograd_through_flash_attention(causal, window, cap, kv):
    """torch.autograd through the port's flash_attention on the CPU is
    `flash_backward_reference`, and agrees with autograd through the
    reference einsum."""
    q, k, v, do = (torch.as_tensor(t)
                   for t in _arrays(5, 2, 48, 4, kv, 16))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = tfa.flash_attention(*leaves, causal, window, 0.25, cap)
    got = torch.autograd.grad(out, leaves, do)
    fwd_out, lse = tfa.flash_forward(q, k, v, causal, window, 0.25, cap)
    want = tfa.flash_backward_reference(q, k, v, fwd_out, lse, do, causal,
                                        window, 0.25, cap)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    ref = tattn.reference_attention(*leaves, causal=causal, window=window,
                                    scale=0.25, logit_cap=cap)
    for g, w in zip(got, torch.autograd.grad(ref, leaves, do)):
        assert _rel(g.numpy(), w.numpy()) <= 1e-5
    # without a gradient the Function is not entered
    with torch.no_grad():
        plain = tfa.flash_attention(*leaves, causal, window, 0.25, cap)
    assert not plain.requires_grad


def test_attention_dispatch_differentiates_through_flash():
    q, k, v, do = (torch.as_tensor(t) for t in _arrays(9, 1, 24, 4, 2, 8))
    grads = {}
    for impl in ("flash", "reference"):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        out = tattn.attention(*leaves, causal=True, impl=impl)
        grads[impl] = torch.autograd.grad(out, leaves, do)
    for g, w in zip(grads["flash"], grads["reference"]):
        assert _rel(g.numpy(), w.numpy()) <= 1e-5


class _ReportsCuda(torch.Tensor):
    """A CPU tensor that reports a CUDA device: it drives the wrappers' CUDA
    branch here without a card."""

    @property
    def device(self):
        return torch.device("cuda")


def _cuda_args(d=64, dtype=torch.float32, kv=4, s=16):
    q, k, v, do = (torch.as_tensor(t).to(dtype)
                   for t in _arrays(3, 1, s, 4, kv, d))
    out, lse = tfa.flash_forward_reference(q, k, v, True)
    return [t.as_subclass(_ReportsCuda) for t in (q, k, v, out, lse, do)]


@pytest.mark.parametrize("case,match", [
    ("head_dim", "head_dim"), ("dtype", "dtype"), ("device", "one CUDA"),
    ("strided", "contiguous head dim"), ("misaligned", "16-byte"),
    ("lse", "lse")])
def test_cuda_backward_checks_raise_before_any_launch(case, match):
    if case == "head_dim":
        args = _cuda_args(d=8)
    elif case == "dtype":
        args = _cuda_args(dtype=torch.float16)
    elif case == "device":  # k on the CPU beside a CUDA q
        args = _cuda_args()
        args[1] = args[1].as_subclass(torch.Tensor)
    elif case == "strided":
        args = _cuda_args()
        wide = torch.zeros(args[0].shape[:3] + (128,))
        wide[..., ::2] = args[0]
        args[0] = wide[..., ::2].as_subclass(_ReportsCuda)
    elif case == "misaligned":
        args = _cuda_args(dtype=torch.bfloat16)
        wide = torch.zeros(args[0].shape[:3] + (65,), dtype=torch.bfloat16)
        wide[..., 1:] = args[0]
        args[0] = wide[..., 1:].as_subclass(_ReportsCuda)
    else:
        args = _cuda_args()
        args[4] = args[4].transpose(1, 2).contiguous().transpose(1, 2)
    before = (tfa.flash_backward.dkv_launches, tfa.flash_backward.dq_launches)
    with pytest.raises(ValueError, match=match):
        tfa.flash_backward(*args, causal=True)
    assert (tfa.flash_backward.dkv_launches,
            tfa.flash_backward.dq_launches) == before


def test_cuda_flash_attention_with_gradients_takes_the_kernels():
    """A CUDA call that needs gradients no longer raises for being
    differentiated: it enters the autograd Function, whose forward goes
    to the kernel's wrapper (which raises here on its head dim)."""
    q, k, v = (t.detach().requires_grad_() for t in _cuda_args(d=8)[:3])
    before = tfa.flash_forward.launches
    with pytest.raises(ValueError, match="head_dim"):
        tfa.flash_attention(q, k, v, causal=True)
    assert tfa.flash_forward.launches == before


def _q_tile_range(kb, s, causal, window, bm=64, bn=64):
    """`q_band` of csrc/flash_common.cuh, transcribed."""
    begin, end = 0, -(-s // bm)
    if causal:
        begin = kb * bn // bm
        if window is not None:
            end = min(end, (kb * bn + bn - 1 + window - 1) // bm + 1)
    return range(begin, end)


def _k_tile_range(qi, s, causal, window, bm=64, bn=64):
    """`band` of csrc/flash_common.cuh, transcribed."""
    begin, end = 0, -(-s // bn)
    if causal:
        end = min(end, (qi * bm + bm - 1) // bn + 1)
        if window is not None:
            lo = qi * bm - (window - 1)
            begin = lo // bn if lo > 0 else 0
    return range(begin, end)


#: each kernel's (Q tile rows, K tile columns): the forward's 128 x 128,
#: the dK/dV kernel's 64-row Q tiles against 128 keys, the dQ kernel's
#: (and the fp32 kernels') 64 x 64
KERNEL_TILES = [(128, 128), (64, 128), (64, 64)]


@pytest.mark.parametrize("bm,bn", KERNEL_TILES)
@pytest.mark.parametrize("s,causal,window", [
    (1024, True, None), (1024, False, None), (384, True, 100),
    (333, True, 70), (512, True, 1), (512, True, 64), (512, True, 65),
    (200, True, 1000)])
def test_kernel_tile_loops_are_the_band_predicate(s, causal, window, bm, bn):
    """Both kernels' loops (`band` from the Q side, `q_band` from the K
    side) visit exactly the tiles `_tile_in_band` accepts, with each
    kernel's tile shape, the ragged edge included."""
    nq, nk = -(-s // bm), -(-s // bn)
    live = {(qi, kb) for qi in range(nq) for kb in range(nk)
            if bool(tfa._tile_in_band(qi, kb, bm, bn, causal, window))}
    from_q = {(qi, kb) for qi in range(nq)
              for kb in _k_tile_range(qi, s, causal, window, bm, bn)}
    from_k = {(qi, kb) for kb in range(nk)
              for qi in _q_tile_range(kb, s, causal, window, bm, bn)}
    assert from_q == live and from_k == live


@pytest.mark.parametrize("name,argtypes", [
    ("tfde_flash_fwd", tfa.ARGTYPES),
    ("tfde_flash_bwd_dkv", tfa.DKV_ARGTYPES),
    ("tfde_flash_bwd_dq", tfa.DQ_ARGTYPES)])
def test_ctypes_signatures_match_the_c_entry_points(name, argtypes):
    """Each binding's argtypes against its C prototype: a mismatch would
    truncate a pointer or shift every argument."""
    source = next(src for src, fns in tfa.SOURCES.items() if name in fns)
    assert tfa.SOURCES[source][name] == argtypes
    with open(os.path.join(CSRC, source)) as f:
        src = f.read()
    proto = re.search(rf'extern "C" int {name}\((.*?)\)\s*\{{', src,
                      re.S).group(1)
    kinds = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p,
             "int": ctypes.c_int, "long long": ctypes.c_longlong,
             "float": ctypes.c_float}
    params = [" ".join(p.split()[:-1]) for p in proto.split(",")]
    assert [kinds[p] for p in params] == list(argtypes)


def test_build_digest_covers_included_headers(tmp_path):
    """An edited header changes the digest of every source that includes
    it (directly or through another header), so a stale library is never
    loaded; computed without nvcc."""
    (tmp_path / "a.cu").write_text('#include "h1.cuh"\nint a;\n')
    (tmp_path / "h1.cuh").write_text('#include "h2.cuh"\n#include <x.h>\n')
    (tmp_path / "h2.cuh").write_text("int h2;\n")
    base = tbuild.source_digest(str(tmp_path / "a.cu"))
    assert tbuild.source_digest(str(tmp_path / "a.cu")) == base
    (tmp_path / "h2.cuh").write_text("int h2 = 1;\n")
    edited = tbuild.source_digest(str(tmp_path / "a.cu"))
    assert edited != base
    (tmp_path / "h1.cuh").write_text('#include "h2.cuh"\n')
    assert tbuild.source_digest(str(tmp_path / "a.cu")) != edited
    # the repo's kernels both include the shared header
    for source in tfa.SOURCES:
        with open(os.path.join(CSRC, source)) as f:
            assert '#include "flash_common.cuh"' in f.read()


def test_build_links_the_driver_api(tmp_path, monkeypatch):
    """The kernels' tensor maps come from the CUDA driver API: the nvcc command
    links -lcuda after the source, and the link flags are in the digest."""
    calls = []

    def fake_run(cmd, **kw):
        calls.append(cmd)
        out = cmd[cmd.index("-o") + 1]
        open(out, "w").close()
        return type("P", (), {"returncode": 0, "stdout": "", "stderr": ""})()

    monkeypatch.setattr(tbuild, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(tbuild, "nvcc_path",
                        lambda: str(tmp_path / "cuda" / "bin" / "nvcc"))
    monkeypatch.setattr(tbuild.subprocess, "run", fake_run)
    monkeypatch.setattr(tbuild.ctypes, "CDLL", lambda path: path)
    lib = tbuild.build_library("flash_fwd.cu", force=True)
    (cmd,) = calls
    src = cmd.index(os.path.join(CSRC, "flash_fwd.cu"))
    assert cmd.index("-lcuda") > src
    assert lib.path.startswith(str(tmp_path))
    digest = tbuild.source_digest(os.path.join(CSRC, "flash_fwd.cu"))
    monkeypatch.setattr(tbuild, "LINK_FLAGS", ())
    assert tbuild.source_digest(os.path.join(CSRC, "flash_fwd.cu")) != digest


def test_sass_opcode_counts_per_kernel():
    """chip_smoke's instruction check: opcodes counted per kernel section
    of `cuobjdump -sass`, whole opcodes only."""
    sass = """
\t\tFunction : _Z3fwdILi64EEvv
        /*0000*/   UTMALDG.4D [UR8], [UR4] ;
        /*0010*/   HGMMA.64x128x16.F32.BF16 R24, gdesc[UR4], RZ ;
        /*0020*/   HGMMA.64x64x16.F32.BF16 R88, R152, gdesc[UR8], R88 ;
\t\tFunction : _Z2dqILi64EEvv
        /*0000*/   HMMA.16816.F32.BF16 R4, R8, R12, R4 ;
        /*0010*/   LDSM.16.MT88.4 R8, [R2] ;
"""
    counts = tbuild.count_opcodes(sass, ("HGMMA", "UTMALDG", "HMMA"))
    assert counts == {
        "_Z3fwdILi64EEvv": {"HGMMA": 2, "UTMALDG": 1, "HMMA": 0},
        "_Z2dqILi64EEvv": {"HGMMA": 0, "UTMALDG": 0, "HMMA": 1},
    }
