"""Keccak-f[1600] leaf hasher and compressor for the Merkle MMCS.

Port of `plonky3_tpu/hashes/keccak_sponge.py`, the benchmark config of
examples/src/types.rs:19-42: leaves are SerializingHasher<PaddingFreeSponge
<KeccakF, 25, 17, 4>>, nodes CompressionFunctionFromHasher<_, 2, 4>.
Field rows serialize their Montgomery-form u32 words, two columns per u64
lane (lo = column 2j, hi = column 2j+1, an odd tail zero-padded). Digests
are (h, 8) int64 tensors of u32 words in (lo, hi) lane order: raw bits,
not field elements. Both go through the kernel wrappers in `keccak_cuda`,
which take int32 words: the leaf words reach the Merkle ladder as the
sponge kernel wrote them, and a tree's levels are converted to int64 once.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .keccak_cuda import (
    keccak_compress,
    keccak_merkle_ladder,
    keccak_sponge_rows,
)

_M32 = 0xFFFFFFFF


def _to_words(x):
    return x.to(torch.int32).contiguous()


def _from_words(x):
    return x.to(torch.int64) & _M32


@dataclass(frozen=True)
class KeccakFieldSponge:
    """Leaf hasher over field rows (SerializingHasher + keccak sponge)."""

    F: object  # Monty31, for the openings' Montgomery -> standard form

    def hash_rows_words(self, mats):
        """Hash the rows of same-height matrices, concatenated row-wise:
        list of (h, ...) int64 tensors -> (h, 8) int32 digest words, the
        form `KeccakCompressor.ladder_device` reads."""
        h = mats[0].shape[0]
        flat = torch.cat([m.reshape(h, -1) for m in mats], dim=1)
        return keccak_sponge_rows(_to_words(flat))

    def hash_rows_device(self, mats):
        """As `hash_rows_words`, as (h, 8) int64 digest words."""
        return _from_words(self.hash_rows_words(mats))


@dataclass(frozen=True)
class KeccakCompressor:
    """2-to-1 compression of [u64; 4] digests."""

    def compress_device(self, left, right):
        """(h, 8) + (h, 8) int64 digest words -> (h, 8)."""
        return _from_words(keccak_compress(_to_words(left),
                                           _to_words(right)))

    def ladder_device(self, digests, top=1):
        """The Merkle levels above (n, 8) digest words (int32 or int64) up
        to `top` nodes: [digests, n/2 nodes, ..., top nodes], int64 views
        into one buffer, from one `keccak_merkle_ladder` call."""
        words = _to_words(digests)
        tree = _from_words(torch.cat([words,
                                      keccak_merkle_ladder(words, top)]))
        n = words.shape[0]
        sizes = [n >> k for k in range((n // top).bit_length())]
        return list(torch.split(tree, sizes))
