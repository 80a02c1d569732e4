"""The sharded Merkle commit: a subtree a rank and a replicated top.

Port of `plonky3_tpu/parallel/merkle.py` (SURVEY.md §7.5): each rank owns
a contiguous row shard, which is one subtree. It hashes its rows and
compresses them down to its subtree root with the MMCS's own hashers (the
keccak sponge and ladder kernels on a CUDA tensor, the plain-torch
Poseidon2 sponge and compression), the roots are all-gathered (one small
collective), and every rank finishes the top log(world) levels itself,
the same on every rank (merkle_tree.rs:95).
"""

from __future__ import annotations

from ..merkle.mmcs import levels_by_compress
from ..utils.bits import log2_strict
from . import all_gather_rows, world_rank


def _levels(mmcs, digests):
    """[digests, ..., one node] by the compressor's ladder where it has
    one (as merkle/mmcs.py::_build_layers does)."""
    if digests.shape[0] == 1:
        return [digests]
    ladder = getattr(mmcs.compressor, "ladder_device", None)
    if ladder:
        return ladder(digests, 1)
    return levels_by_compress(mmcs.compressor, digests, 1)


def sharded_tree_layers(mmcs, local, group=None):
    """The digest layers of one row-sharded matrix, leaves first: each
    rank passes its (h/world, w) block and gets, for every layer of world
    or more nodes, its own contiguous block of that layer, and every
    smaller layer whole (the same on every rank). Gathered, they are
    `merkle/mmcs.py::_build_layers`'s layers."""
    world, _ = world_rank(group)
    log2_strict(world)
    if local.shape[0] < 2:
        raise ValueError("need at least 2 rows per shard")
    log2_strict(local.shape[0])
    layers = _levels(mmcs, mmcs.sponge.hash_rows_words([local]))
    roots = all_gather_rows(layers[-1], group)
    return layers + _levels(mmcs, roots)[1:]
