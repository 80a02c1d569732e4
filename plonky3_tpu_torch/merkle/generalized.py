"""Generalized Merkle tree: arity-N schedule, non-power-of-two heights,
Merkle caps.

Port of `plonky3_tpu/merkle/generalized.py`, on the host (numpy words and
the hashes' `_np` and `_host` paths), as the reference's is.

Parity target: `merkle-tree/src/merkle_tree.rs:95-245` (padded ladder +
`select_arity_step` binary bridges + `compress_and_inject`) and
`mmcs/geometry.rs` (the `ceil(max/2^k)` valid-height ladder; caps per
`merkle_tree.rs:198`). The default MMCS (mmcs.py) keeps the fast
pow-2/arity-2 path used by the bit-exact fixture configs; this module
adds the general geometry.

Geometry summary:
  * tallest matrices fix the leaf layer, padded to a multiple of N with
    ZERO digests (`padded_len`);
  * each level compresses with `step ∈ {2, N}`: a binary bridge step is
    taken whenever a shorter matrix must inject before the next N-ary
    target level (`select_arity_step`, merkle_tree.rs:229);
  * a matrix of height h injects at the level whose next-power-of-two
    count equals next_power_of_two(h); its digest joins via
    c([c(children), h(rows), 0…]) (compress_and_inject);
  * valid heights are exactly `ceil(max_height / 2^k)`;
  * `cap(height)` exposes the top `prod(arity_schedule[-height:])`
    digests instead of the root.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


def next_pow2(x: int) -> int:
    return 1 << (x - 1).bit_length() if x > 1 else 1


def padded_len(raw_len: int, n: int) -> int:
    """merkle_tree.rs:473."""
    if raw_len <= 1:
        return raw_len
    if raw_len >= n:
        return -(-raw_len // n) * n
    return n


def select_arity_step(n: int, curr_len_padded: int, leaf_height_npt: int,
                      remaining_heights) -> int:
    """merkle_tree.rs:229."""
    if curr_len_padded < n:
        return 2
    n_ary_target = next_pow2(curr_len_padded // n)
    has_intermediate = any(
        next_pow2(h) > n_ary_target
        for h in remaining_heights
        if next_pow2(h) != leaf_height_npt
    )
    return 2 if has_intermediate else n


def valid_heights(max_height: int):
    """geometry.rs ceil-ladder: {ceil(max/2^k)}."""
    out, h = [], max_height
    while True:
        out.append(h)
        if h == 1:
            break
        h = -(-h // 2)
    return out


@dataclass
class GeneralizedProverData:
    matrices: list  # numpy std-order committed matrices (wire form)
    layers: list  # numpy digest layers (padded), layers[0] = leaves
    arity_schedule: list
    root_std: tuple
    digest_is_field: bool = True

    def cap(self, cap_height: int):
        """merkle_tree.rs:198: top `prod(schedule[-cap_height:])` digests
        of the layer `cap_height` levels below the root."""
        num_layers = len(self.layers)
        if cap_height >= num_layers:
            raise ValueError("cap_height exceeds tree depth")
        layer_idx = num_layers - 1 - cap_height
        layer = self.layers[layer_idx]
        cap_len = 1
        for s in self.arity_schedule[layer_idx:]:
            cap_len *= s
        cap_len = min(cap_len, layer.shape[0])
        return layer[:cap_len]


@dataclass(frozen=True)
class GeneralizedMerkleMmcs:
    """Host (numpy-exact) generalized MMCS. The hot pow-2 trees stay on
    the device MMCS; this covers the long-trace / mixed-geometry cases
    the reference handles with the same ladder. No prover on the card
    commits through it yet: `commit` takes numpy matrices or CPU tensors
    and raises on a tensor on another device rather than hash it on the
    host."""

    sponge: object
    compressor: object
    arity: int = 2
    cap_height: int = 0

    @property
    def F(self):
        return self.sponge.F

    def commit(self, mats) -> GeneralizedProverData:
        N = self.arity
        for m in mats:
            if isinstance(m, torch.Tensor) and m.device.type != "cpu":
                raise NotImplementedError(
                    f"GeneralizedMerkleMmcs commits on the host; a matrix "
                    f"on {m.device} needs the device sponge and "
                    f"compression (ROADMAP §3)")
        mats = [np.asarray(m) for m in mats]
        heights = [m.shape[0] for m in mats]
        max_h = max(heights)
        ladder = set(valid_heights(max_h))
        for h in heights:
            if h not in ladder:
                raise ValueError(
                    f"height {h} is not on the ceil(max/2^k) ladder of "
                    f"{max_h} (valid: {sorted(ladder, reverse=True)})")
        order = sorted(range(len(mats)), key=lambda i: -heights[i])
        leaf_npt = next_pow2(max_h)

        def take_npt(npt, used):
            picked = []
            for i in order:
                if i in used:
                    continue
                if next_pow2(heights[i]) == npt:
                    picked.append(i)
                    used.add(i)
            return picked

        used = set()
        tallest = [
            mats[i] for i in order if heights[i] == max_h
        ]
        for i in order:
            if heights[i] == max_h:
                used.add(i)

        leaf = self.sponge.hash_rows_np(tallest)
        dw = leaf.shape[1]
        pad = padded_len(max_h, N) - max_h
        if pad:
            leaf = np.concatenate(
                [leaf, np.zeros((pad, dw), np.uint32)], axis=0
            )
        layers = [leaf]
        schedule = []
        while layers[-1].shape[0] > 1:
            prev = layers[-1]
            remaining = [heights[i] for i in order if i not in used]
            step = select_arity_step(
                N, prev.shape[0], leaf_npt, remaining
            )
            raw_next = prev.shape[0] // step
            next_layer_len = next_pow2(raw_next)
            inject_idx = take_npt(next_layer_len, used)
            inject = [mats[i] for i in inject_idx]

            groups = prev.reshape(raw_next, step, dw)
            layer = self._compress_group(groups, dw)
            if inject:
                inj_h = inject[0].shape[0]
                tips = self.sponge.hash_rows_np(inject)
                merged = np.zeros((raw_next, dw), np.uint32)
                both = np.stack(
                    [layer[:inj_h], tips], axis=1
                )  # (inj_h, 2, dw)
                merged[:inj_h] = self._compress_group(
                    self._pad_groups(both, dw), dw
                )
                if raw_next > inj_h:
                    rest = np.stack(
                        [
                            layer[inj_h:],
                            np.zeros((raw_next - inj_h, dw), np.uint32),
                        ],
                        axis=1,
                    )
                    merged[inj_h:] = self._compress_group(
                        self._pad_groups(rest, dw), dw
                    )
                layer = merged
            pad = padded_len(raw_next, N) - raw_next
            if pad:
                layer = np.concatenate(
                    [layer, np.zeros((pad, dw), np.uint32)], axis=0
                )
            schedule.append(step)
            layers.append(layer)

        F = self.F
        dif = self.sponge.digest_is_field
        root_m = layers[-1][0]
        root_std = tuple(
            int(x)
            for x in (F.from_monty_np(root_m) if dif else root_m)
        )
        data = GeneralizedProverData(
            matrices=mats,
            layers=layers,
            arity_schedule=schedule,
            root_std=root_std,
            digest_is_field=dif,
        )
        return data

    def _pad_groups(self, groups, dw):
        """(g, k, dw) -> (g, N, dw) zero-padded when compressing 2-ary
        inputs under an N-ary compressor."""
        g, k, _ = groups.shape
        if k == self.arity:
            return groups
        pad = np.zeros((g, self.arity - k, dw), np.uint32)
        return np.concatenate([groups, pad], axis=1)

    def _compress_group(self, groups, dw):
        """(g, step, dw) -> (g, dw) via the N-ary compressor (binary
        steps pad with zero digests)."""
        groups = self._pad_groups(groups, dw)
        children = [groups[:, i] for i in range(self.arity)]
        return self.compressor.compress_many_np(children)

    def commitment(self, data: GeneralizedProverData):
        """Root, or the Merkle cap when cap_height > 0 (std form)."""
        if self.cap_height == 0:
            return (data.root_std,)
        cap = data.cap(self.cap_height)
        F = self.F
        conv = F.from_monty_np if data.digest_is_field else (lambda x: x)
        return tuple(
            tuple(int(x) for x in conv(row)) for row in cap
        )

    # ------------------------------------------------------------------
    def open_batch(self, data: GeneralizedProverData, index: int):
        """Returns (rows_per_matrix, proof): proof is a list of
        per-level sibling groups (step-1 digests each, std form),
        stopping cap_height levels below the root."""
        F = self.F
        conv = F.from_monty_np if data.digest_is_field else (lambda x: x)
        max_h = max(m.shape[0] for m in data.matrices)
        log_max = (max_h - 1).bit_length()
        rows = []
        for m in data.matrices:
            shift = log_max - (m.shape[0] - 1).bit_length()
            rows.append(
                [int(x) for x in F.from_monty_np(m[index >> shift])]
            )
        proof = []
        idx = index
        num_levels = len(data.arity_schedule) - self.cap_height
        for lvl in range(num_levels):
            step = data.arity_schedule[lvl]
            layer = data.layers[lvl]
            group = idx // step
            sibs = []
            for pos in range(step):
                j = group * step + pos
                if pos == idx % step:
                    continue
                sibs.append(
                    tuple(int(x) for x in conv(layer[j]))
                )
            proof.append(sibs)
            idx = group
        return rows, proof

    def verify_batch(self, commitment, dims, index: int, rows, proof
                     ) -> bool:
        """dims: [(height, width)] in commit order. Recomputes the
        digest chain, injecting row hashes at their ladder levels, and
        compares against the root or cap entry."""
        N = self.arity
        heights = [h for h, _ in dims]
        for (h, w), row in zip(dims, rows):
            if len(row) != w:
                return False
        max_h = max(heights)
        ladder = set(valid_heights(max_h))
        if any(h not in ladder for h in heights):
            return False
        order = sorted(range(len(dims)), key=lambda i: -heights[i])
        leaf_npt = next_pow2(max_h)

        # reconstruct the layer schedule from the public dims
        sched = []
        cur = padded_len(max_h, N)
        used = {i for i in order if heights[i] == max_h}
        while cur > 1:
            remaining = [heights[i] for i in order if i not in used]
            step = select_arity_step(N, cur, leaf_npt, remaining)
            raw_next = cur // step
            nl = next_pow2(raw_next)
            inject = [
                i for i in order
                if i not in used and next_pow2(heights[i]) == nl
            ]
            used |= set(inject)
            sched.append((step, inject, raw_next))
            cur = padded_len(raw_next, N)

        digest = self.sponge.hash_iter_host(
            [
                x
                for i in order
                if heights[i] == max_h
                for x in rows[i]
            ]
        )
        idx = index
        num_levels = len(sched) - self.cap_height
        if len(proof) != num_levels:
            return False
        for lvl, (step, inject, raw_next) in enumerate(sched[:num_levels]):
            sibs = proof[lvl]
            if len(sibs) != step - 1:
                return False
            pos = idx % step
            children = []
            si = 0
            for p in range(step):
                if p == pos:
                    children.append(digest)
                else:
                    children.append(tuple(int(x) for x in sibs[si]))
                    si += 1
            while len(children) < N:
                children.append(
                    tuple(0 for _ in range(len(digest)))
                )
            digest = self.compressor.compress_host_many(children)
            idx //= step
            if inject:
                tip = self.sponge.hash_iter_host(
                    [x for i in inject for x in rows[i]]
                )
                children = [digest, tip] + [
                    tuple(0 for _ in range(len(digest)))
                ] * (N - 2)
                digest = self.compressor.compress_host_many(children)
        if self.cap_height == 0:
            return tuple(digest) == tuple(commitment[0])
        # cap: the digest must equal the cap entry at the residual index
        if idx >= len(commitment):
            return False
        return tuple(digest) == tuple(commitment[idx])
