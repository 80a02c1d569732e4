"""Poseidon2 sponge and compression for the Merkle MMCS.

Port of `plonky3_tpu/hashes/sponge.py`, the benchmark config of
examples/src/types.rs:44-62: leaves are PaddingFreeSponge<Perm24, 24, 16,
8> (symmetric/src/sponge.rs:157: overwrite mode, a permutation after each
rate block, a trailing partial block permuted only when non-empty, the
first 8 lanes squeezed), nodes TruncatedPermutation<Perm16, 2, 8, 16>
(symmetric/src/compression.rs:17: left || right zero-extended, permuted,
truncated). Digests are field elements (`digest_is_field`): Montgomery
words on the device, standard-form ints in the proof.

The device paths hash every row of a level at once, as (h, width) int64
states in standard form (`Poseidon2.permute_std`); they take and return
Montgomery-form int64 tensors. The `_np` paths take and return
Montgomery-form numpy words, as the reference's do, and serve the
verifier. The `_host` paths hash one row or one node of standard-form
Python ints (the unpruned Merkle verifies); `compress_many_np` and
`compress_host_many` take N children (the N-ary trees of
`merkle/generalized.py`). Plain PyTorch: the JAX package computes these
in jnp, not in a TPU kernel.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .poseidon2 import Poseidon2


def _rows(mats):
    """Same-height matrices -> their rows concatenated, (h, total)."""
    h = mats[0].shape[0]
    if len(mats) == 1:
        return mats[0].reshape(h, -1)
    cat = torch.cat if isinstance(mats[0], torch.Tensor) else np.concatenate
    return cat([m.reshape(h, -1) for m in mats], 1)


@dataclass(frozen=True)
class PaddingFreeSponge:
    perm: Poseidon2
    rate: int
    out: int

    digest_is_field = True

    @property
    def F(self):
        return self.perm.F

    def _hash(self, flat, to_std, state, tables):
        """Absorb (h, total) Montgomery rows into the zero (h, width)
        `state`, a block at a time in standard form."""
        for start in range(0, flat.shape[1], self.rate):
            block = flat[:, start:start + self.rate]
            state[:, :block.shape[1]] = to_std(block)  # overwrite mode
            state = self.perm.permute_std(state, tables)
        return state[:, :self.out]

    def hash_rows_device(self, mats):
        """The rows of same-height matrices, concatenated row-wise: list
        of (h, w_i) Montgomery int64 tensors -> (h, out) digests."""
        F = self.F
        flat = _rows(mats)
        state = torch.zeros((flat.shape[0], self.perm.width),
                            dtype=torch.int64, device=flat.device)
        digest = self._hash(flat, F.from_monty_tensor, state,
                            self.perm.std_tables(flat.device))
        return F.to_monty_tensor(digest)

    # the leaf digests in the form the compression ladder reads
    hash_rows_words = hash_rows_device

    def hash_rows_np(self, mats):
        """Host batch: same-height numpy matrices of Montgomery words ->
        (h, out) uint32 Montgomery digests."""
        F = self.F
        flat = _rows([np.asarray(m) for m in mats])
        state = np.zeros((flat.shape[0], self.perm.width), np.int64)
        digest = self._hash(flat, F.from_monty_np, state,
                            self.perm.tables_np)
        return F.to_monty_np(digest)

    def hash_iter_host(self, elems):
        """One row: standard-form ints -> the digest's standard-form ints."""
        row = np.asarray([int(x) % self.F.P for x in elems],
                         dtype=np.int64).reshape(1, -1)
        state = np.zeros((1, self.perm.width), np.int64)
        digest = self._hash(row, lambda b: b, state, self.perm.tables_np)
        return tuple(int(x) for x in digest[0])


@dataclass(frozen=True)
class TruncatedPermutation:
    """2-to-1 digest compression (compression.rs:17 with N = 2)."""

    perm: Poseidon2
    chunk: int  # digest size (8)

    def compress_device(self, left, right):
        """(h, chunk) + (h, chunk) Montgomery int64 tensors -> (h, chunk)."""
        pad = torch.zeros((left.shape[0], self.perm.width - 2 * self.chunk),
                          dtype=torch.int64, device=left.device)
        state = torch.cat([left, right, pad], dim=1)
        return self.perm.permute(state)[:, :self.chunk]

    def compress_np(self, left, right):
        """(h, chunk) + (h, chunk) uint32 Montgomery words (numpy) ->
        (h, chunk) uint32."""
        F = self.F
        left, right = np.asarray(left), np.asarray(right)
        state = np.zeros((left.shape[0], self.perm.width), np.int64)
        state[:, :self.chunk] = F.from_monty_np(left)
        state[:, self.chunk:2 * self.chunk] = F.from_monty_np(right)
        out = self.perm.permute_std(state, self.perm.tables_np)
        return F.to_monty_np(out[:, :self.chunk])

    def compress_many_np(self, children):
        """N (h, chunk) uint32 Montgomery digests (numpy) -> (h, chunk):
        the children side by side, zero-extended, permuted, truncated."""
        F = self.F
        children = [np.asarray(c) for c in children]
        if len(children) * self.chunk > self.perm.width:
            raise ValueError(f"{len(children)} children of {self.chunk} "
                             f"words exceed width {self.perm.width}")
        state = np.zeros((children[0].shape[0], self.perm.width), np.int64)
        for i, c in enumerate(children):
            state[:, i * self.chunk:(i + 1) * self.chunk] = (
                F.from_monty_np(c))
        out = self.perm.permute_std(state, self.perm.tables_np)
        return F.to_monty_np(out[:, :self.chunk])

    def compress_host_many(self, children):
        """N standard-form digests (int sequences) -> one."""
        words = [int(x) for c in children for x in c]
        if len(words) > self.perm.width:
            raise ValueError(f"{len(words)} words exceed width "
                             f"{self.perm.width}")
        state = np.zeros(self.perm.width, np.int64)
        state[:len(words)] = words
        out = self.perm.permute_std(state, self.perm.tables_np)
        return tuple(int(x) for x in out[:self.chunk])

    def compress_host(self, left, right):
        """Two standard-form digests -> one."""
        return self.compress_host_many([left, right])

    @property
    def F(self):
        return self.perm.F
