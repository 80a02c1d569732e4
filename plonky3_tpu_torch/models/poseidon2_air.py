"""Vectorized Poseidon2 AIR over KoalaBear: the benchmark workload.

Port of `plonky3_tpu/models/poseidon2_air.py` for the KoalaBear s-box
(degree 3, no s-box registers): V permutations per row, each a block of
columns

    inputs[W]
    4 × post[W]        beginning full rounds
    PR × post_sbox     partial rounds
    4 × post[W]        ending full rounds

`eval` states the constraints over the builder's symbolic values (the
verifier runs it at zeta); `fold_constraints_device` evaluates the same
constraints over the whole quotient domain for the prover. Both take them
in the reference's order: per round, the post columns w-major and V-minor
(a partial round contributes V), so each gets the same alpha power. The
fold is exact modular arithmetic; each constraint·alpha product is
reduced mod P before the sums.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import default_device
from ..air.api import BaseAir
from ..air.builder import stack_syms
from ..hashes.poseidon2 import Poseidon2, default_poseidon2, mds_light

HALF_FULL_ROUNDS = 4
_FOLD_CHUNK = 1 << 15  # rows per fold step (bounds the temporaries)


class _SymOps:
    """The `mds_light` ops protocol over AIR Syms: the permutation and the
    AIR share the linear layer (poseidon2/src/generic.rs:32)."""

    def add(self, a, b):
        return a + b

    def double(self, a):
        return a + a


class Poseidon2VectorAir(BaseAir):
    num_public_values = 0

    def __init__(self, field, state_width: int = 16, vector_len: int = 8,
                 perm: Poseidon2 | None = None):
        self.field = field
        self.perm = perm or default_poseidon2(field, state_width)
        if self.perm.d != 3:
            raise NotImplementedError("only the degree-3 s-box is ported")
        self.W = state_width
        self.V = vector_len
        self.PR = len(self.perm.rc_internal)
        self.cols_per_perm = (self.W + 2 * HALF_FULL_ROUNDS * self.W
                              + self.PR)
        self.width = vector_len * self.cols_per_perm

    def max_constraint_degree(self):
        return 3

    # -- column offsets within one permutation's block --------------------
    def _off_full(self, section: int, r: int):
        """The first post column of full round r of section 0 (beginning)
        or 1 (ending)."""
        base = self.W + r * self.W
        if section == 1:
            base += HALF_FULL_ROUNDS * self.W + self.PR
        return base

    def _off_partial(self, r: int):
        """The post_sbox column of partial round r."""
        return self.W + HALF_FULL_ROUNDS * self.W + r

    def eval(self, b):
        """The constraints, a block of V (one per permutation) for each
        post column: computed round output minus the committed one."""
        V, W, C = self.V, self.W, self.cols_per_perm
        cols = b.main.local
        ops = _SymOps()

        def lane(c):
            return stack_syms([cols[v * C + c] for v in range(V)])

        def sbox(x):  # degree 3, no registers
            return x * x * x

        state = mds_light(ops, [lane(w) for w in range(W)])
        for section, rcs in ((0, self.perm.rc_external_initial),
                             (None, self.perm.rc_internal),
                             (1, self.perm.rc_external_final)):
            for r, rc in enumerate(rcs):
                if section is None:  # partial round
                    post = lane(self._off_partial(r))
                    b.assert_eq_block(sbox(state[0] + int(rc)), post, V)
                    state[0] = post
                    total = state[0]
                    for s in state[1:]:
                        total = total + s
                    state = [total + state[i] * int(self.perm.diag_std[i])
                             for i in range(W)]
                else:  # full round
                    post_base = self._off_full(section, r)
                    state = mds_light(ops, [sbox(state[w] + int(rc[w]))
                                            for w in range(W)])
                    for w in range(W):
                        post = lane(post_base + w)
                        b.assert_eq_block(state[w], post, V)
                        state[w] = post

    def fold_constraints_device(self, F, E, local, nxt, sels, publics_m,
                                alpha_pows):
        """(Nq, width) rows -> (Nq, D) alpha-folded constraints:
        Σ_k alpha_pows[k]·C_k with C_k = computed - committed post value.
        The constraints read no next row, so `nxt` is unused."""
        perm, P = self.perm, F.P
        V, W, C, PR = self.V, self.W, self.cols_per_perm, self.PR
        c = perm.consts(local.device)
        per_full = V * W
        k_ei = HALF_FULL_ROUNDS * per_full
        k_ef = k_ei + PR * V
        out = []
        for r0 in range(0, local.shape[0], _FOLD_CHUNK):
            xc = local[r0:r0 + _FOLD_CHUNK]
            rows = xc.shape[0]
            xc = xc.reshape(rows, V, C)
            acc = torch.zeros((rows, E.D), dtype=torch.int64,
                              device=local.device)

            def fold(cons, k0, acc=acc):
                a = alpha_pows[k0:k0 + cons.shape[1]]
                acc += (cons[:, :, None] * a[None] % P).sum(dim=1)

            def full_rounds(state, rcs, col0, k0):
                for r, rc in enumerate(rcs):
                    post = xc[:, :, col0 + r * W:col0 + (r + 1) * W]
                    sm = perm._mds_light_arr(perm.sbox(F.add(state, rc)))
                    cons = F.sub(sm, post).transpose(1, 2).reshape(rows, -1)
                    fold(cons, k0 + r * per_full)
                    state = post
                return state

            state = perm._mds_light_arr(xc[:, :, :W])
            state = full_rounds(state, c["rc_ei"], W, 0)
            p0 = W + HALF_FULL_ROUNDS * W
            for r in range(PR):
                post = xc[:, :, p0 + r]
                s0 = perm.sbox(F.add(state[..., 0], c["rc_int"][r]))
                fold(F.sub(s0, post), k_ei + r * V)
                state = perm.internal_layer(
                    torch.cat([post[..., None], state[..., 1:]], dim=-1),
                    c["diag"])
            full_rounds(state, c["rc_ef"], p0 + PR, k_ef)
            out.append(acc % P * F.RINV % P)
        return torch.cat(out, dim=0)


def generate_vectorized_trace(air: Poseidon2VectorAir, inputs, device=None):
    """Trace generation: (n_perms, W) Montgomery inputs (numpy uint32 or a
    tensor) -> ((n_perms / V, width) int64 trace, final states), on
    `device` (default cuda). n_perms must be a multiple of V."""
    dev = default_device(device)
    if isinstance(inputs, np.ndarray):
        inputs = torch.from_numpy(inputs.astype(np.int64))
    x_in = inputs.to(device=dev, dtype=torch.int64)
    n = x_in.shape[0]
    if n % air.V:
        raise ValueError(f"{n} permutations do not fill rows of {air.V}")
    perm, F = air.perm, air.field
    c = perm.consts(dev)
    cols = [x_in]
    x = perm._mds_light_arr(x_in)
    for rc in c["rc_ei"]:
        x = perm._mds_light_arr(perm.sbox(F.add(x, rc)))
        cols.append(x)
    for rc in c["rc_int"]:
        s0 = perm.sbox(F.add(x[..., 0], rc))
        x = perm.internal_layer(torch.cat([s0[..., None], x[..., 1:]],
                                          dim=-1), c["diag"])
        cols.append(s0[..., None])
    for rc in c["rc_ef"]:
        x = perm._mds_light_arr(perm.sbox(F.add(x, rc)))
        cols.append(x)
    per_perm = torch.cat(cols, dim=1)
    return per_perm.reshape(n // air.V, air.V * air.cols_per_perm), x
