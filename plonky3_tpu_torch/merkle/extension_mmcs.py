"""ExtensionMmcs: commit extension-field matrices through a base MMCS.

Port of `plonky3_tpu/merkle/extension_mmcs.py`
(commit/src/adapters/extension_mmcs.rs:17): an (h, w, D) extension matrix
is committed as the flattened (h, w·D) base matrix, and opened rows are
regrouped into D-tuples; to verify (pruned, or one unpruned path),
they are flattened back and checked by the base MMCS.
"""

from __future__ import annotations

from dataclasses import dataclass

from .mmcs import MerkleProverData, MerkleTreeMmcs


@dataclass(frozen=True)
class ExtensionMmcs:
    inner: MerkleTreeMmcs
    D: int

    def commit_ext_matrix(self, mat) -> MerkleProverData:
        return self.commit_ext_matrices([mat])

    def commit_ext_matrices(self, mats) -> MerkleProverData:
        """(h, w, D) extension matrices in one tree (several: the circle
        PCS's first layer)."""
        for m in mats:
            if m.shape[2] != self.D:
                raise ValueError(f"expected {self.D} components, got "
                                 f"{m.shape[2]}")
        return self.inner.commit([m.reshape(m.shape[0], -1) for m in mats])

    def _regroup(self, rows_pq):
        D = self.D
        return [
            [[tuple(row[i:i + D]) for i in range(0, len(row), D)]
             for row in rows]
            for rows in rows_pq
        ]

    def open_multi_batch(self, data: MerkleProverData, indices):
        rows_pq, sibling_hashes = self.inner.open_multi_batch(data, indices)
        return self._regroup(rows_pq), sibling_hashes

    # PullBatcher protocol: the inner tree plans the gathers; rows are
    # regrouped into extension tuples when they arrive
    def _omb_plan(self, data, indices):
        return self.inner._omb_plan(data, indices)

    def _omb_finish(self, data, plan, pulled):
        rows_pq, sibs = self.inner._omb_finish(data, plan, pulled)
        return self._regroup(rows_pq), sibs

    def verify_batch(self, root_std, dims, index, ext_rows, proof) -> bool:
        """One unpruned opening; dims: [(height, extension width)]."""
        return self.inner.verify_batch(
            root_std, [(h, w * self.D) for (h, w) in dims], index,
            _flat_rows(ext_rows), proof)

    def verify_multi_batch(self, root_std, dims, indices, ext_rows_pq,
                           sibling_hashes) -> bool:
        """dims: [(height, extension width)] per matrix."""
        return self.inner.verify_multi_batch(
            root_std, [(h, w * self.D) for (h, w) in dims], indices,
            [_flat_rows(rows) for rows in ext_rows_pq], sibling_hashes)


def _flat_rows(ext_rows):
    """Rows of extension tuples -> rows of base values."""
    return [[c for e in row for c in e] for row in ext_rows]
