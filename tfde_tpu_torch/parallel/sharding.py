"""Sharding rules — counterpart of `tfde_tpu/parallel/sharding.py`
(`_largest_divisible_dim` :42, `shard_pytree_spec` :63).

The JAX package declares where each array lives as a PartitionSpec over
mesh axes. The port has one sharded layout so far, ZeRO-1's optimizer
state (`training.train_state.ShardedUpdate`), and it needs only the
rule's answer: for each named tensor, the dimension whose slices the
ranks own, or None where the tensor stays whole on every rank.

The rule is the JAX rule: a tensor of at least `min_elems` elements is
split along its largest dimension divisible by the rank count (the
first such dimension on a tie); smaller tensors, and tensors with no
divisible dimension, stay replicated. It reads only the shape's sizes,
so the torch layout (a Linear weight is a flax Dense kernel transposed)
gives each rank the same number of elements as a JAX device holds.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional, Sequence, Tuple

import torch


def largest_divisible_dim(shape: Sequence[int], size: int,
                          min_elems: int) -> Optional[int]:
    """The largest dim of `shape` divisible by `size` (the first on a tie),
    or None when the shape has fewer than `min_elems` elements or no dim
    divides."""
    total = 1
    for s in shape:
        total *= s
    if total < min_elems:
        return None
    best, best_size = None, 0
    for i, s in enumerate(shape):
        if s % size == 0 and s > best_size:
            best, best_size = i, s
    return best


def shard_dims(named: Iterable[Tuple[str, torch.Tensor]], size: int,
               min_elems: int = 2**14) -> Dict[str, Optional[int]]:
    """{name: the dim split over `size` ranks, or None (replicated)} for
    each named tensor: `shard_pytree_spec`'s rule over the ``data`` axis.
    With one rank (or none) every tensor stays replicated; so does a
    scalar."""
    return {name: (largest_divisible_dim(t.shape, size, min_elems)
                   if size > 1 and t.dim() else None)
            for name, t in named}
