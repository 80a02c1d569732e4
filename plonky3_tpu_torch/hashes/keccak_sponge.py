"""Keccak-f[1600] leaf hasher and compressor for the Merkle MMCS.

Port of `plonky3_tpu/hashes/keccak_sponge.py`, the benchmark config of
examples/src/types.rs:19-42: leaves are SerializingHasher<PaddingFreeSponge
<KeccakF, 25, 17, 4>>, nodes CompressionFunctionFromHasher<_, 2, 4>.
Field rows serialize their Montgomery-form u32 words, two columns per u64
lane (lo = column 2j, hi = column 2j+1, an odd tail zero-padded). Digests
are 8 u32 words in (lo, hi) lane order: raw bits, not field elements.
On the device they are (h, 8) int64 tensors,
and both device paths go through the kernel wrappers in `keccak_cuda`,
which take int32 words: the leaf words reach the Merkle ladder as the
sponge kernel wrote them, and a tree's levels are converted to int64 once.

The host paths serve the verifier: `hash_rows_np` and `compress_np` hash
a batch of rows or digest pairs as numpy uint32 words with the numpy
keccak-f; `hash_iter_host` and `compress_host` one row (standard-form
ints) or one node (words as ints of any integer type: each is taken by
`int`, where the reference's shifts numpy uint32 words in 32 bits);
`compress_many_np` and `compress_host_many` N children, absorbed in one
rate block while N <= 4 (the N-ary trees of `merkle/generalized.py`).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .keccak import keccak_f1600_host, keccak_f1600_np
from .keccak_cuda import (
    keccak_compress,
    keccak_merkle_ladder,
    keccak_sponge_rows,
)

RATE = 17  # u64 lanes absorbed a block
OUT = 4  # u64 lanes of a digest (8 u32 words)
_M32 = 0xFFFFFFFF


def _lanes_np(words):
    """(h, n) u32 words -> (h, ceil(n/2)) u64 lanes, word 2j the low half
    of lane j."""
    w = np.asarray(words).astype(np.uint64)
    if w.shape[1] % 2:
        w = np.concatenate([w, np.zeros((w.shape[0], 1), np.uint64)], axis=1)
    return w[:, 0::2] | (w[:, 1::2] << np.uint64(32))


def _digest_np(st):
    """(h, 25) u64 states -> (h, 8) uint32 digest words."""
    out = st[:, :OUT]
    return np.stack([out & np.uint64(_M32), out >> np.uint64(32)],
                    axis=-1).reshape(-1, 2 * OUT).astype(np.uint32)


def _to_words(x):
    return x.to(torch.int32).contiguous()


def _from_words(x):
    return x.to(torch.int64) & _M32


@dataclass(frozen=True)
class KeccakFieldSponge:
    """Leaf hasher over field rows (SerializingHasher + keccak sponge)."""

    F: object  # Monty31, for the openings' Montgomery -> standard form

    digest_is_field = False

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

    def hash_rows_np(self, mats):
        """Host batch: same-height numpy matrices of Montgomery u32 words,
        concatenated row-wise -> (h, 8) uint32 digest words."""
        h = mats[0].shape[0]
        lanes = _lanes_np(np.concatenate(
            [np.asarray(m).reshape(h, -1) for m in mats], axis=1))
        st = np.zeros((h, 25), np.uint64)
        for start in range(0, lanes.shape[1], RATE):
            block = lanes[:, start:start + RATE]
            st[:, :block.shape[1]] = block  # overwrite mode
            st = keccak_f1600_np(st)
        return _digest_np(st)

    def hash_iter_host(self, elems):
        """One row: standard-form ints -> the 8 digest words."""
        words = np.asarray([self.F.to_monty_h(int(x) % self.F.P)
                            for x in elems], dtype=np.uint32)
        return _host_digest(self.hash_rows_np([words.reshape(1, -1)]))


def _host_digest(d):
    """A (1, 8) digest array -> a tuple of 8 ints."""
    return tuple(int(x) for x in d[0])


def _words_row(children):
    """Digests (int sequences) -> one (1, 8N) uint32 row."""
    return np.asarray([[int(x) for c in children for x in c]],
                      dtype=np.uint32)


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

    def compress_np(self, left, right):
        """(h, 8) + (h, 8) u32 digest words (numpy) -> (h, 8) uint32."""
        return self.compress_many_np([left, right])

    def compress_many_np(self, children):
        """N (h, 8) u32 digest words (numpy), N <= 4, in one block ->
        (h, 8) uint32."""
        lanes = _lanes_np(np.concatenate([np.asarray(c) for c in children],
                                         axis=1))
        if lanes.shape[1] > RATE:
            raise ValueError(f"{len(children)} children exceed one keccak "
                             f"block")
        st = np.zeros((lanes.shape[0], 25), np.uint64)
        st[:, :lanes.shape[1]] = lanes
        return _digest_np(keccak_f1600_np(st))

    def compress_host_many(self, children):
        """N digests (8 ints each) -> one."""
        return _host_digest(self.compress_many_np([_words_row(children)]))

    def compress_host(self, left, right):
        """Two digests (8 ints each) -> one."""
        return self.compress_host_many([left, right])

