"""Hiding Merkle MMCS: random salt columns on every leaf.

Port of `plonky3_tpu/merkle/hiding_mmcs.py`
(merkle-tree/src/hiding_mmcs.rs:42, MerkleTreeHidingMmcs). `commit`
appends `salt_elems` uniformly random columns to every matrix, so a leaf
digest tells nothing of its row; opened rows carry their salts, and the
verifier hashes the whole salted row. The salts come from the caller's
numpy Generator: one draw of (h, salt_elems) per matrix, in the order of
the matrices, as the reference draws them, so the same seed gives the
same words. They are appended on the device of the matrix.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from .mmcs import MerkleProverData, MerkleTreeMmcs


def draw_std(F, rng, shape):
    """The reference's one draw of standard-form words:
    rng.integers(0, P, shape, uint64)."""
    return rng.integers(0, F.P, size=shape, dtype=np.uint64)


def monty_words(F, x, device):
    """A uint64 array of standard-form words as an int64 Montgomery tensor
    on `device` (the words are below 2^31, so their bits read as the same
    int64 values; the conversion runs on the device)."""
    return F.to_monty_tensor(torch.from_numpy(x.view(np.int64)).to(device))


def draw_words(F, rng, shape, device):
    """`draw_std` as an int64 Montgomery tensor on `device`."""
    return monty_words(F, draw_std(F, rng, shape), device)


@dataclass(frozen=True)
class MerkleTreeHidingMmcs:
    inner: MerkleTreeMmcs
    salt_elems: int
    rng: np.random.Generator = field(
        default_factory=lambda: np.random.default_rng())

    @property
    def F(self):
        return self.inner.F

    @property
    def sponge(self):
        return self.inner.sponge

    @property
    def compressor(self):
        return self.inner.compressor

    @property
    def digest_is_field(self) -> bool:
        return self.inner.digest_is_field

    def commit(self, mats) -> MerkleProverData:
        salted = [torch.cat([m, draw_words(self.F, self.rng,
                                           (m.shape[0], self.salt_elems),
                                           m.device)], dim=1)
                  for m in mats]
        data = self.inner.commit(salted)
        data.salt_elems = self.salt_elems
        return data

    # openings pass through: the committed rows carry their salts
    def open_multi_batch(self, data, indices):
        return self.inner.open_multi_batch(data, indices)

    def _omb_plan(self, data, indices):
        return self.inner._omb_plan(data, indices)

    def _omb_finish(self, data, plan, pulled):
        return self.inner._omb_finish(data, plan, pulled)

    def salted_dims(self, dims):
        return [(h, w + self.salt_elems) for (h, w) in dims]

    def verify_batch(self, root_std, dims, index, rows, proof) -> bool:
        """One unpruned opening; dims carry the real widths, the rows
        their salts."""
        return self.inner.verify_batch(root_std, self.salted_dims(dims),
                                       index, rows, proof)

    def verify_multi_batch(self, root_std, dims, indices, rows_pq,
                           sibling_hashes) -> bool:
        """dims carry the polynomial widths; the salts ride in the rows."""
        return self.inner.verify_multi_batch(
            root_std, self.salted_dims(dims), indices, rows_pq,
            sibling_hashes)
