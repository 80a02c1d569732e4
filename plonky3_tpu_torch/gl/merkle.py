"""Goldilocks Merkle commitments: the Poseidon2-GL sponge and compression.

Port of `plonky3_tpu/gl/merkle.py`. The committed matrices are (h, w)
int64 tensors of Goldilocks elements (`gl/field.py`); a leaf digest is
PaddingFreeSponge(rate 4, out 4) over the row (symmetric/src/sponge.rs:157
semantics: each block of four elements overwrites the state's first
lanes, the last block of w mod 4 elements its first lanes only), a node
the first four lanes of the permuted [left | right] (TruncatedPermutation,
chunk 4): the Goldilocks analogue of examples/src/types.rs:44-62 at
width 8. On the device both run the kernels of `csrc/goldilocks.cu`
(`hashes/poseidon2_goldilocks_cuda.py`), a tree level a launch; the host
verifier hashes with the batched numpy permutation
(`hashes/poseidon2_goldilocks.py`), every query of a level at once.
Digests and opened values are canonical u64 ints on the wire.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..hashes.poseidon2_goldilocks import (
    poseidon2_goldilocks_permute,
    poseidon2_goldilocks_permute_np,
)
from ..hashes.poseidon2_goldilocks_cuda import gl_compress, gl_sponge_rows
from ..merkle.mmcs import MerkleTreeMmcs
from .field import GLF

RATE = 4
OUT = 4
WIDTH = 8


class _GLPermShim:
    """The permutation as the host duplex challenger reads it."""

    width = WIDTH
    F = GLF

    def permute_host(self, state):
        return poseidon2_goldilocks_permute(state)


def _rows(mats):
    h = mats[0].shape[0]
    if len(mats) == 1:
        return mats[0].reshape(h, -1)
    cat = torch.cat if isinstance(mats[0], torch.Tensor) else np.concatenate
    return cat([m.reshape(h, -1) for m in mats], 1)


@dataclass(frozen=True)
class GLPoseidonSponge:
    digest_is_field = True
    F = GLF

    def hash_rows_device(self, mats):
        """Same-height (h, w_i) int64 matrices, their rows side by side ->
        (h, 4) digests."""
        return gl_sponge_rows(_rows(mats).contiguous())

    hash_rows_words = hash_rows_device

    def hash_rows_np(self, mats):
        """Host batch: same-height uint64 matrices -> (h, 4) uint64."""
        flat = _rows([np.asarray(m, dtype=np.uint64) for m in mats])
        state = np.zeros((flat.shape[0], WIDTH), dtype=np.uint64)
        for start in range(0, flat.shape[1], RATE):
            blk = flat[:, start:start + RATE]
            state[:, :blk.shape[1]] = blk
            state = poseidon2_goldilocks_permute_np(state)
        return state[:, :OUT].copy()

    def hash_iter_host(self, elems):
        """One row of canonical ints -> its digest (4 ints)."""
        state = [0] * WIDTH
        elems = [int(v) % GLF.P for v in elems]
        for start in range(0, len(elems), RATE):
            blk = elems[start:start + RATE]
            state[:len(blk)] = blk
            state = poseidon2_goldilocks_permute(state)
        return tuple(state[:OUT])


@dataclass(frozen=True)
class GLCompressor:
    chunk = OUT

    def compress_device(self, left, right):
        return gl_compress(left, right)

    def compress_np(self, left, right):
        state = np.concatenate([np.asarray(left, dtype=np.uint64),
                                np.asarray(right, dtype=np.uint64)], axis=1)
        return poseidon2_goldilocks_permute_np(state)[:, :OUT].copy()

    def compress_host(self, a, b):
        state = [int(x) for x in a] + [int(x) for x in b]
        return tuple(poseidon2_goldilocks_permute(state)[:OUT])


@dataclass(frozen=True)
class GLMerkleTreeMmcs(MerkleTreeMmcs):
    """MerkleTreeMmcs whose wire values are u64 Goldilocks elements."""

    wire_dtype = np.uint64


def gl_merkle_mmcs(cap_height: int = 0) -> GLMerkleTreeMmcs:
    return GLMerkleTreeMmcs(sponge=GLPoseidonSponge(),
                            compressor=GLCompressor(), cap_height=cap_height)
