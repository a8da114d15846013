"""The tile logic of the port's Hopper flash kernels, held against the JAX
package's band predicate and a brute force over the (row, col) pairs.

`tile_live` and `tile_unmasked` of tfde_tpu_torch/csrc/flash_common.cuh,
transcribed: the first lets a warpgroup skip a block of pairs that holds
no visible pair inside S, the second sends a block whose every pair is
visible and inside S down the mask-free path. Then the kernels' whole
loops (the block's band of tiles, the warpgroups' blocks within a tile,
the skip) cover every visible pair exactly once, with the forward's
128 x 128 tiles and the dK/dV kernel's 128 keys x 64 queries (taken in
halves at D 128). Pure Python and numpy; the kernels themselves are held
against the plain versions on the card by chip_smoke.py.
"""

import numpy as np
import pytest

from tfde_tpu_torch.ops import flash_attention as tfa

from test_torch_flash_backward import _k_tile_range, _q_tile_range

#: (rows, cols) of the block one warpgroup computes: the forward's 64 query
#: rows x 128 keys, the dK/dV kernel's 64 queries x 64 keys (D 64) and 32
#: queries x 64 keys (D 128, a Q tile in two halves)
WG_BLOCKS = [(64, 128), (64, 64), (32, 64)]
WINDOWS = [None, 1, 64, 65, 127, 128, 129]


def _tile_live(s, causal, window, r0, c0, tm, tn):
    """`tile_live` of csrc/flash_common.cuh, transcribed."""
    if r0 >= s or c0 >= s:
        return False
    if not causal:
        return True
    if c0 > r0 + tm - 1:
        return False
    return window is None or c0 + tn - 1 >= r0 - (window - 1)


def _tile_unmasked(s, causal, window, r0, c0, tm, tn):
    """`tile_unmasked` of csrc/flash_common.cuh, transcribed."""
    if r0 + tm > s or c0 + tn > s:
        return False
    if not causal:
        return True
    if c0 + tn - 1 > r0:
        return False
    return window is None or r0 + tm - 1 - c0 < window


def _visible(s, causal, window, r0, c0, tm, tn):
    """The brute force: which pairs of the block are visible and inside
    S (rows are queries, columns keys)."""
    r = np.arange(r0, r0 + tm)[:, None]
    c = np.arange(c0, c0 + tn)[None, :]
    keep = (r < s) & (c < s)
    if causal:
        keep &= r >= c
        if window is not None:
            keep &= r - c < window
    return keep


def _cases():
    cases = [(s, False, None) for s in (129, 200, 333, 1024)]
    cases += [(s, True, w) for s in (129, 200, 333, 1024) for w in WINDOWS]
    return cases


@pytest.mark.parametrize("tm,tn", WG_BLOCKS)
@pytest.mark.parametrize("s,causal,window", _cases())
def test_tile_predicates_against_brute_force(s, causal, window, tm, tn):
    """Over every warpgroup block the kernels form (rows from multiples of
    the block height, columns from multiples of the block width):
    `tile_unmasked` holds exactly when every pair is visible and inside S,
    and a block `tile_live` rejects has no such pair."""
    n_unmasked = 0
    for r0 in range(0, s + tm, tm):
        for c0 in range(0, s + tn, tn):
            vis = _visible(s, causal, window, r0, c0, tm, tn)
            unmasked = _tile_unmasked(s, causal, window, r0, c0, tm, tn)
            assert unmasked == bool(vis.all()), (r0, c0)
            n_unmasked += unmasked
            if not _tile_live(s, causal, window, r0, c0, tm, tn):
                assert not vis.any(), (r0, c0)
    # the mask-free path is taken wherever a whole block is visible
    if s == 1024 and (window is None or window >= 2 * tn):
        assert n_unmasked > 0


def _covered(s, pairs):
    seen = np.zeros((s, s), np.int32)
    for r0, c0, tm, tn in pairs:
        r1, c1 = min(r0 + tm, s), min(c0 + tn, s)
        seen[r0:r1, c0:c1] += 1
    return seen


@pytest.mark.parametrize("s,causal,window", _cases())
def test_forward_loops_cover_every_visible_pair_once(s, causal, window):
    """The forward: one block per 128-row Q tile, its K loop over
    `band<128, 128>`, two warpgroups of 64 rows that skip what `tile_live`
    rejects. Every visible pair inside S is computed once, and nothing
    outside the band is."""
    pairs = []
    for qi in range(-(-s // 128)):
        for kb in _k_tile_range(qi, s, causal, window, 128, 128):
            assert bool(tfa._tile_in_band(qi, kb, 128, 128, causal, window))
            for w in range(2):
                r0 = qi * 128 + 64 * w
                if _tile_live(s, causal, window, r0, kb * 128, 64, 128):
                    pairs.append((r0, kb * 128, 64, 128))
    seen = _covered(s, pairs)
    want = _visible(s, causal, window, 0, 0, s, s)
    assert seen.max() <= 1
    assert (seen[want] == 1).all()


@pytest.mark.parametrize("qn", [64, 32])
@pytest.mark.parametrize("s,causal,window", _cases())
def test_dkv_loops_cover_every_visible_pair_once(s, causal, window, qn):
    """The dK/dV kernel: one block per 128 keys, its Q loop over
    `q_band<64, 128>`, two warpgroups of 64 keys, each Q tile taken in
    parts of qn queries (64 at D 64, 32 at D 128) that skip what
    `tile_live` rejects (rows are queries, columns keys)."""
    pairs = []
    for kb in range(-(-s // 128)):
        for qi in _q_tile_range(kb, s, causal, window, 64, 128):
            assert bool(tfa._tile_in_band(qi, kb, 64, 128, causal, window))
            for w in range(2):
                c0 = kb * 128 + 64 * w
                for r0 in range(qi * 64, qi * 64 + 64, qn):
                    if _tile_live(s, causal, window, r0, c0, qn, 64):
                        pairs.append((r0, c0, qn, 64))
    seen = _covered(s, pairs)
    want = _visible(s, causal, window, 0, 0, s, s)
    assert seen.max() <= 1
    assert (seen[want] == 1).all()
