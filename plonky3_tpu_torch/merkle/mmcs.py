"""Merkle-tree MMCS: batched tree build on the device, pruned openings.

Port of the parts of `plonky3_tpu/merkle/mmcs.py` that the prover reaches
(merkle-tree/src/merkle_tree.rs:95,141-170; mmcs/batch.rs:42,275). The leaf
layer hashes every row at once, and each compression layer halves the
digest count. Matrices of a shorter height are injected when the ladder
reaches their height (taller matrices first, same-height matrices
concatenated row-wise in input order).

The compressor builds the levels between two injection heights in one
call (`ladder_device`; for keccak, the Merkle ladder kernel in two launches
for a 2^18-leaf tree), so without injection the whole tree is one call and
its layers are views into one buffer. The injection level itself is one
`compress_device` call. A compressor without a ladder kernel of its own
(the Poseidon2 `TruncatedPermutation`) climbs by `levels_by_compress`, one
`compress_device` call per level.

Openings are pruned multiproofs (merkle-tree/src/pruning.rs): a sibling
digest is shipped only when no queried leaf lies under it, in the
normative wire order (level 0 first; within a level by ascending parent;
within a group missing positions ascending). `PullBatcher` gathers the
rows and digests of several trees and copies them to the host in one
transfer.

Digests are the sponge's: raw keccak words, or field elements
(`digest_is_field`, the Poseidon2 sponge), which are Montgomery words on
the device and standard-form ints in commitments and proofs.

Verification of a pruned opening (mmcs/batch.rs verify_multi_batch) runs
on the host with the compressor's exact numpy hashes, batched over the
queries a level at a time. Opened rows arrive in standard form and are
hashed as their Montgomery words, as the leaves were committed; field
digests likewise. The unpruned single-path verifiers (mmcs.rs
verify_batch) check one path a query: `verify_batch` hashes it with the
one-row host hashes, `verify_batch_many` many paths at once with the
batched numpy hashes.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..utils.bits import log2_strict


@dataclass
class MerkleProverData:
    matrices: list  # committed (h, w) int64 tensors, rows in committed order
    layers: list  # digest layers, layers[0] = leaf digests (h, 8)
    root_std: tuple  # root digest words (host ints)
    # Merkle cap (merkle_tree.rs:182-198): the 2^cap_height digests
    # cap_height levels below the root; (root_std,) for cap height 0
    cap_std: tuple = None
    coeffs: list = None  # scaled interpolant coefficients (set by the PCS)
    # the hiding MMCS's salt columns at the end of every matrix
    salt_elems: int = 0
    # the hiding PCS's random codeword columns precede the salts
    zk_randomized: bool = False

    def poly_matrices(self):
        """The committed matrices without their salt columns: the columns
        the polynomials fill (the reference's `_poly_mats`)."""
        if not self.salt_elems:
            return self.matrices
        return [m[:, :m.shape[1] - self.salt_elems] for m in self.matrices]

    @property
    def commitment(self):
        """Wire commitment: the root, or the cap when it has > 1 digest."""
        if self.cap_std is not None and len(self.cap_std) > 1:
            return self.cap_std
        return self.root_std


def levels_by_compress(compressor, layer, top=1):
    """[layer, then each level above it up to `top` nodes], one
    `compress_device` call per level."""
    levels = [layer]
    while levels[-1].shape[0] > top:
        pairs = levels[-1].reshape(levels[-1].shape[0] // 2, 2, -1)
        levels.append(compressor.compress_device(pairs[:, 0], pairs[:, 1]))
    return levels


def _build_layers(mmcs, mats):
    """Leaf sponge and compression ladder with mixed-height injection."""
    heights = [m.shape[0] for m in mats]
    order = sorted(range(len(mats)), key=lambda i: -heights[i])

    def take(h):
        return [mats[i] for i in order if heights[i] == h]

    h = max(heights)
    layers, cur = [], mmcs.sponge.hash_rows_words(take(h))
    # the ladder stops at each shorter height, then at the root
    for top in sorted((set(heights) | {1}) - {h}, reverse=True) or [1]:
        ladder = getattr(mmcs.compressor, "ladder_device", None)
        levels = (ladder(cur, top) if ladder else
                  levels_by_compress(mmcs.compressor, cur, top))
        layers += levels[1:] if layers else levels
        inject = take(top) if top < h else []
        if inject:
            tips = mmcs.sponge.hash_rows_device(inject)
            layers[-1] = mmcs.compressor.compress_device(layers[-1], tips)
        cur = layers[-1]
    return layers


def pull_all(arrays, idxs):
    """Gather rows idxs[k] of arrays[k] for every k and copy them to the
    host in one transfer; returns numpy arrays of the gathered shapes."""
    if not arrays:
        return []
    flat = torch.cat([a.index_select(0, i).reshape(-1)
                      for a, i in zip(arrays, idxs)]).cpu().numpy()
    out, off = [], 0
    for a, i in zip(arrays, idxs):
        shape = (int(i.shape[0]),) + tuple(a.shape[1:])
        cnt = int(np.prod(shape, dtype=np.int64))
        out.append(flat[off:off + cnt].reshape(shape))
        off += cnt
    return out


class _Fut:
    """Resolved by PullBatcher.flush()."""

    __slots__ = ("value",)


class PullBatcher:
    """Share one device-to-host transfer across several trees' pruned
    multi-openings: fut = batcher.add(mmcs, data, indices); flush();
    rows, proof = fut.value."""

    def __init__(self):
        self.entries = []

    def add(self, mmcs, data, indices):
        fut = _Fut()
        self.entries.append((mmcs, data, mmcs._omb_plan(data, indices), fut))
        return fut

    def flush(self):
        arrays, idxs = [], []
        for _, _, plan, _ in self.entries:
            arrays.extend(plan["dev_arrays"])
            idxs.extend(plan["dev_idx"])
        pulled = pull_all(arrays, idxs)
        off = 0
        for mmcs, data, plan, fut in self.entries:
            k = len(plan["dev_arrays"])
            fut.value = mmcs._omb_finish(data, plan, pulled[off:off + k])
            off += k
        self.entries = []


@dataclass(frozen=True)
class MerkleTreeMmcs:
    sponge: object
    compressor: object
    cap_height: int = 0
    # the dtype of opened values and digests on the wire (Goldilocks:
    # uint64, `gl/merkle.py`)
    wire_dtype = np.uint32

    def _eff_cap(self, log_max: int) -> int:
        """The cap height clamps to the tree height."""
        return min(self.cap_height, log_max)

    @property
    def F(self):
        return self.sponge.F

    @property
    def digest_is_field(self) -> bool:
        return self.sponge.digest_is_field

    def digests_std(self, words):
        """Device digest words (numpy) -> their wire values: field digests
        leave Montgomery form, keccak words stay as they are."""
        return self.F.from_monty_np(words) if self.digest_is_field else words

    def _digests_m(self, wire):
        """Wire digests -> the words the compressor hashes."""
        d = np.asarray(wire, dtype=self.wire_dtype)
        return self.F.to_monty_np(d) if self.digest_is_field else d

    def commit(self, mats) -> MerkleProverData:
        """Commit to (h, w) int64 tensors whose heights are powers of two
        (rows already in their final order)."""
        mats = list(mats)
        for m in mats:
            log2_strict(m.shape[0])
        layers = _build_layers(self, mats)
        root_std = tuple(int(x) for x in self.digests_std(
            layers[-1][0].cpu().numpy()))
        log_max = log2_strict(max(m.shape[0] for m in mats))
        eff_cap = self._eff_cap(log_max)
        if eff_cap == 0:
            cap_std = (root_std,)
        else:
            if min(m.shape[0] for m in mats) < (1 << eff_cap):
                raise ValueError("a matrix shorter than the Merkle cap "
                                 "layer cannot be opened")
            cap_std = tuple(tuple(int(x) for x in row)
                            for row in self.digests_std(
                                layers[log_max - eff_cap].cpu().numpy()))
        return MerkleProverData(matrices=mats, layers=layers,
                                root_std=root_std, cap_std=cap_std)

    def open_multi_batch(self, data: MerkleProverData, indices):
        """Open many indices with one pruned proof: (rows per query,
        sibling digests in frontier order)."""
        plan = self._omb_plan(data, indices)
        return self._omb_finish(
            data, plan, pull_all(plan["dev_arrays"], plan["dev_idx"]))

    def _omb_plan(self, data: MerkleProverData, indices):
        """Frontier walk and gather list (no transfer yet)."""
        log_max = log2_strict(data.layers[0].shape[0])
        frontier = sorted(set(int(i) for i in indices))
        want, by_level = [], {}
        for lvl in range(log_max - self._eff_cap(log_max)):
            present = set(frontier)
            for node in frontier:
                if node ^ 1 not in present:
                    want.append((lvl, node ^ 1))
                    by_level.setdefault(lvl, []).append(node ^ 1)
            frontier = sorted({node >> 1 for node in frontier})
        dev_arrays, dev_idx, dev_tags = [], [], []
        for k, m in enumerate(data.matrices):
            shift = log_max - log2_strict(m.shape[0])
            dev_arrays.append(m)
            dev_idx.append(torch.tensor([i >> shift for i in indices],
                                        dtype=torch.int64, device=m.device))
            dev_tags.append(("mat", k))
        for lvl, nodes in by_level.items():
            layer = data.layers[lvl]
            dev_arrays.append(layer)
            dev_idx.append(torch.tensor(nodes, dtype=torch.int64,
                                        device=layer.device))
            dev_tags.append(("lvl", lvl))
        return dict(dev_arrays=dev_arrays, dev_idx=dev_idx,
                    dev_tags=dev_tags, by_level=by_level, want=want,
                    Q=len(indices))

    def _omb_finish(self, data: MerkleProverData, plan, pulled):
        """Pulled arrays -> standard-form rows and the pruned proof."""
        F = self.F
        Q = plan["Q"]
        mat_rows, lvl_digs = {}, {}
        for (kind, key), arr in zip(plan["dev_tags"], pulled):
            if kind == "mat":
                mat_rows[key] = arr
            else:
                lvl_digs[key] = arr
        mat_lists = [
            F.from_monty_np(mat_rows[k]).reshape(Q, -1).tolist()
            for k in range(len(data.matrices))
        ]
        rows_pq = [[mat_lists[k][q] for k in range(len(data.matrices))]
                   for q in range(Q)]
        digests = {}
        for lvl, nodes in plan["by_level"].items():
            for node, d in zip(nodes, self.digests_std(lvl_digs[lvl])):
                digests[(lvl, node)] = tuple(int(x) for x in d)
        return rows_pq, [digests[key] for key in plan["want"]]

    # ---- verification (host) -------------------------------------------
    def _cap_ok(self, root_std, log_max):
        """The commitment as a (2^cap, 8) array, or None when its shape
        does not match the effective cap height."""
        cap = np.array(root_std, dtype=self.wire_dtype)
        if cap.ndim != 2 or cap.shape[0] != 1 << self._eff_cap(log_max):
            return None
        return cap

    def _heights_ok(self, dims, rows_list, log_levels, proofs):
        """The shared shape checks of the unpruned verifies: each row
        has its matrix's width (commit/src/mmcs.rs:145), each path
        `log_levels` siblings, and no matrix is shorter than the cap."""
        heights = [d[0] for d in dims]
        log_max = log2_strict(max(heights))
        if min(heights) < (1 << self._eff_cap(log_max)):
            return False
        if any(len(p) != log_levels for p in proofs):
            return False
        return all(len(rows) == len(dims) and all(
            len(rows[i]) == d[1] for i, d in enumerate(dims))
            for rows in rows_list)

    def verify_batch(self, root_std, dims, index: int, rows, proof) -> bool:
        """One unpruned opening: rows a matrix (standard form), proof
        the sibling digests from the leaf up (wire form); dims [(height,
        width)]."""
        heights = [d[0] for d in dims]
        max_h = max(heights)
        log_max = log2_strict(max_h)
        eff_cap = self._eff_cap(log_max)
        if not self._heights_ok(dims, [rows], log_max - eff_cap, [proof]):
            return False
        order = sorted(range(len(dims)), key=lambda i: -heights[i])

        def rows_at(h):
            return [x for i in order if heights[i] == h for x in rows[i]]

        digest = self.sponge.hash_iter_host(rows_at(max_h))
        idx, h = index, max_h
        for sib in proof:
            h //= 2
            digest = (self.compressor.compress_host(sib, digest) if idx & 1
                      else self.compressor.compress_host(digest, sib))
            idx >>= 1
            inj = rows_at(h)
            if inj:
                digest = self.compressor.compress_host(
                    digest, self.sponge.hash_iter_host(inj))
        if eff_cap == 0:
            return tuple(digest) == tuple(root_std)
        if len(root_std) != 1 << eff_cap:
            return False
        return tuple(digest) == tuple(root_std[idx])

    def verify_batch_many(self, root_std, dims, indices, rows_pq,
                          proofs_pq) -> bool:
        """Many unpruned openings at once: one batched hash a tree level
        covering every query."""
        heights = [d[0] for d in dims]
        max_h = max(heights)
        log_max = log2_strict(max_h)
        eff_cap = self._eff_cap(log_max)
        if not self._heights_ok(dims, rows_pq, log_max - eff_cap, proofs_pq):
            return False
        order = sorted(range(len(dims)), key=lambda i: -heights[i])
        to_m = self.F.to_monty_np

        def tips(h):
            """Leaf digests of the height-h matrices' rows, or None."""
            parts = [np.array([rows[i] for rows in rows_pq],
                              dtype=self.wire_dtype)
                     for i in order if heights[i] == h]
            if not parts:
                return None
            return self.sponge.hash_rows_np(
                [to_m(np.concatenate(parts, axis=1))])

        digest = tips(max_h)
        idx = np.array(indices, dtype=np.int64)
        h = max_h
        for lvl in range(log_max - eff_cap):
            h //= 2
            sib = self._digests_m([proof[lvl] for proof in proofs_pq])
            bit = (idx & 1).astype(bool)[:, None]
            digest = self.compressor.compress_np(
                np.where(bit, sib, digest), np.where(bit, digest, sib))
            idx >>= 1
            inj = tips(h)
            if inj is not None:
                digest = self.compressor.compress_np(digest, inj)
        digest = self.digests_std(digest)
        if eff_cap == 0:
            return bool((digest == np.array(root_std, self.wire_dtype)).all())
        cap = self._cap_ok(root_std, log_max)
        return cap is not None and bool((digest == cap[idx]).all())

    def verify_multi_batch(self, root_std, dims, indices, rows_pq,
                           sibling_hashes) -> bool:
        """Verify a pruned multi-opening. Duplicate indices must carry
        identical rows; the sibling digests are consumed in wire order and
        a trailing or missing one fails."""
        Q = len(indices)
        if len(rows_pq) != Q:
            return False
        heights = [d[0] for d in dims]
        max_h = max(heights)
        log_max = log2_strict(max_h)
        order = sorted(range(len(dims)), key=lambda i: -heights[i])
        for rows in rows_pq:
            if len(rows) != len(dims):
                return False
            for i, d in enumerate(dims):
                if len(rows[i]) != d[1]:
                    return False
        if min(heights) < (1 << self._eff_cap(log_max)):
            return False

        def tips_for(h, leads):
            """Leaf digests of the height-h matrices' rows of the lead
            queries, or None when no matrix has height h."""
            parts = [np.array([rows_pq[q][i] for q in leads],
                              dtype=self.wire_dtype)
                     for i in order if heights[i] == h]
            if not parts:
                return None
            return self.sponge.hash_rows_np(
                [self.F.to_monty_np(np.concatenate(parts, axis=1))])

        # frontier: node -> the first query that opened it
        lead_for = {}
        for q, idx in enumerate(indices):
            node = int(idx)
            if node not in lead_for:
                lead_for[node] = q
            elif rows_pq[q] != rows_pq[lead_for[node]]:
                return False
        nodes = sorted(lead_for)
        digests = tips_for(max_h, [lead_for[n] for n in nodes])
        sibs = iter(sibling_hashes)
        consumed, h = 0, max_h
        for _ in range(log_max - self._eff_cap(log_max)):
            h //= 2
            node_set = set(nodes)
            pos = {n: i for i, n in enumerate(nodes)}
            left, right = [], []
            try:
                for n in nodes:
                    if n & 1:
                        if n ^ 1 in node_set:
                            continue  # paired by its even sibling
                        left.append(self._digests_m(next(sibs)))
                        right.append(digests[pos[n]])
                        consumed += 1
                    else:
                        left.append(digests[pos[n]])
                        if n ^ 1 in node_set:
                            right.append(digests[pos[n ^ 1]])
                        else:
                            right.append(self._digests_m(next(sibs)))
                            consumed += 1
            except StopIteration:
                return False
            digests = self.compressor.compress_np(np.stack(left),
                                                  np.stack(right))
            parent_lead = {}
            for n in nodes:
                parent_lead.setdefault(n >> 1, lead_for[n])
            lead_for = parent_lead
            nodes = sorted(lead_for)
            tips = tips_for(h, [lead_for[n] for n in nodes])
            if tips is not None:
                digests = self.compressor.compress_np(digests, tips)
        if consumed != len(sibling_hashes):
            return False
        digests = self.digests_std(digests)
        if self._eff_cap(log_max) == 0:
            want = np.array(root_std, dtype=self.wire_dtype)
            return bool((digests[0] == want).all())
        # frontier nodes that reach the cap layer each meet their entry
        cap = self._cap_ok(root_std, log_max)
        return cap is not None and all(
            bool((digests[i] == cap[n]).all()) for i, n in enumerate(nodes))
