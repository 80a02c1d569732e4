"""Vectorized Poseidon2 AIR: the benchmark workload.

Port of `plonky3_tpu/models/poseidon2_air.py`: V permutations per row,
each a block of columns (REG s-box registers per s-box, `_sbox_registers`)

    inputs[W]
    4 × (sbox[W·REG], post[W])     beginning full rounds
    PR × (sbox[REG], post_sbox)    partial rounds
    4 × (sbox[W·REG], post[W])     ending full rounds

KoalaBear's s-box x^3 has no register (REG 0). BabyBear's x^7 has one
(the reference's (7, 1) case, air.rs:305-341): the register holds x^3,
constrained by reg - x·x·x, and the s-box's value is reg·reg·x, so every
constraint keeps degree 3. Mersenne31's degree 5 waits for that field.

`eval` states the constraints over the builder's symbolic values (the
verifier runs it at zeta); `fold_constraints_device` evaluates the same
constraints over the whole quotient domain for the prover. Both take them
in the reference's order: per round, the register constraints and then
the post columns', each w-major and V-minor (a partial round contributes
V of each), so each gets the same alpha power. The fold is exact modular
arithmetic; each constraint·alpha product is reduced mod P before the
sums.
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


def _sbox_registers(d: int) -> int:
    """Committed registers per s-box: none for x^3, one (x^3) for x^7."""
    if d not in (3, 7):
        raise NotImplementedError(f"the degree-{d} s-box is not ported "
                                  f"(Mersenne31's degree 5 comes with it)")
    return {3: 0, 7: 1}[d]


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
        self.d = self.perm.d
        self.REG = _sbox_registers(self.d)
        self.W = state_width
        self.V = vector_len
        self.PR = len(self.perm.rc_internal)
        W, REG = self.W, self.REG
        self.cols_per_perm = (W + 2 * HALF_FULL_ROUNDS * (W * REG + W)
                              + self.PR * (REG + 1))
        self.width = vector_len * self.cols_per_perm

    def max_constraint_degree(self):
        return 3

    # -- column offsets within one permutation's block --------------------
    def _off_full(self, section: int, r: int):
        """(sbox_base, post_base) of full round r of section 0 (beginning)
        or 1 (ending)."""
        W, REG = self.W, self.REG
        block = W * REG + W
        base = W + r * block
        if section == 1:
            base += HALF_FULL_ROUNDS * block + self.PR * (REG + 1)
        return base, base + W * REG

    def _off_partial(self, r: int):
        """(sbox_base, post_sbox) of partial round r."""
        W, REG = self.W, self.REG
        base = W + HALF_FULL_ROUNDS * (W * REG + W) + r * (REG + 1)
        return base, base + REG

    def eval(self, b):
        """The constraints, a block of V (one per permutation) for each
        register (reg - x^3) and each post column (computed round output
        minus the committed one)."""
        V, W, C = self.V, self.W, self.cols_per_perm
        cols = b.main.local
        ops = _SymOps()

        def lane(c):
            return stack_syms([cols[v * C + c] for v in range(V)])

        def sbox(x, reg_col):
            if not self.REG:  # degree 3, no register
                return x * x * x
            x3 = lane(reg_col)  # degree 7: the register holds x^3
            b.assert_eq_block(x3, x * x * x, V)
            return x3 * x3 * x

        state = mds_light(ops, [lane(w) for w in range(W)])
        for section, rcs in ((0, self.perm.rc_external_initial),
                             (None, self.perm.rc_internal),
                             (1, self.perm.rc_external_final)):
            for r, rc in enumerate(rcs):
                if section is None:  # partial round
                    sbox_base, post_c = self._off_partial(r)
                    post = lane(post_c)
                    b.assert_eq_block(sbox(state[0] + int(rc), sbox_base),
                                      post, V)
                    state[0] = post
                    total = state[0]
                    for s in state[1:]:
                        total = total + s
                    state = [total + state[i] * int(self.perm.diag_std[i])
                             for i in range(W)]
                else:  # full round
                    sbox_base, post_base = self._off_full(section, r)
                    state = mds_light(ops, [
                        sbox(state[w] + int(rc[w]), sbox_base + w * self.REG)
                        for w in range(W)])
                    for w in range(W):
                        post = lane(post_base + w)
                        b.assert_eq_block(state[w], post, V)
                        state[w] = post

    def fold_constraints_device(self, F, E, local, nxt, sels, publics_m,
                                alpha_pows):
        """(Nq, width) rows -> (Nq, D) alpha-folded constraints:
        Σ_k alpha_pows[k]·C_k with C_k = reg - x^3 for a register and
        computed - committed post value for a post column. The constraints
        read no next row, so `nxt` is unused."""
        perm, P = self.perm, F.P
        V, W, C, PR, REG = self.V, self.W, self.cols_per_perm, self.PR, \
            self.REG
        c = perm.consts(local.device)
        block = W * REG + W
        per_full = V * W * (REG + 1)
        per_part = V * (REG + 1)
        k_ei = HALF_FULL_ROUNDS * per_full
        k_ef = k_ei + PR * per_part
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

            def sbox(s, regs):
                """(the s-box's value, the register constraints or None)."""
                if not REG:
                    return perm.sbox(s), None
                return (F.mul(F.square(regs), s),
                        F.sub(regs, F.mul(F.square(s), s)))

            def full_rounds(state, rcs, col0, k0):
                for r, rc in enumerate(rcs):
                    base, k = col0 + r * block, k0 + r * per_full
                    regs = xc[:, :, base:base + W] if REG else None
                    post = xc[:, :, base + W * REG:base + block]
                    val, reg_cons = sbox(F.add(state, rc), regs)
                    if REG:
                        fold(reg_cons.transpose(1, 2).reshape(rows, -1), k)
                        k += V * W
                    cons = F.sub(perm._mds_light_arr(val), post)
                    fold(cons.transpose(1, 2).reshape(rows, -1), k)
                    state = post
                return state

            state = perm._mds_light_arr(xc[:, :, :W])
            state = full_rounds(state, c["rc_ei"], W, 0)
            p0 = W + HALF_FULL_ROUNDS * block
            for r in range(PR):
                base, k = p0 + r * (REG + 1), k_ei + r * per_part
                post = xc[:, :, base + REG]
                val, reg_cons = sbox(F.add(state[..., 0], c["rc_int"][r]),
                                     xc[:, :, base] if REG else None)
                if REG:
                    fold(reg_cons, k)
                    k += V
                fold(F.sub(val, post), k)
                state = perm.internal_layer(
                    torch.cat([post[..., None], state[..., 1:]], dim=-1),
                    c["diag"])
            full_rounds(state, c["rc_ef"], p0 + PR * (REG + 1), k_ef)
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

    def sbox(s):
        """(the s-box's value, its register columns: x^3, or none)."""
        if not air.REG:
            return perm.sbox(s), []
        x3 = F.mul(F.square(s), s)
        return F.mul(F.square(x3), s), [x3]

    cols = [x_in]
    x = perm._mds_light_arr(x_in)
    for rc in c["rc_ei"]:
        val, regs = sbox(F.add(x, rc))
        x = perm._mds_light_arr(val)
        cols += regs + [x]
    for rc in c["rc_int"]:
        s0, regs = sbox(F.add(x[..., 0], rc))
        x = perm.internal_layer(torch.cat([s0[..., None], x[..., 1:]],
                                          dim=-1), c["diag"])
        cols += [r[..., None] for r in regs] + [s0[..., None]]
    for rc in c["rc_ef"]:
        val, regs = sbox(F.add(x, rc))
        x = perm._mds_light_arr(val)
        cols += regs + [x]
    per_perm = torch.cat(cols, dim=1)
    return per_perm.reshape(n // air.V, air.V * air.cols_per_perm), x
