"""SHA-256 compression AIR: one compression a row, 7,728 columns.

Port of `plonky3_tpu/models/sha256_air.py` (sha256-air/src/columns.rs:
84-210, air.rs:105-762). The column layout, the constraints and their
emission order are the reference's: a 32-bit word is either 32 boolean
columns (the w schedule, the a and e working-variable chains, h_out) or
a [lo, hi] pair of 16-bit limbs (h_in and each round's packed
intermediates); the sigma rotations are per-bit XOR3 expressions folded
limb-wise by Horner, Ch and Maj use their degree-2 and degree-3 bit
identities, and the modular additions use the acc·(acc + 2^32)(·...)
checks. The 48 schedule extensions and the 64 rounds each stack into one
lane axis (`stack_syms`), so each constraint family emits as one block;
the round constants enter as a lane vector (`const_vec`).

The constraints read no next row, but the AIR declares its next-row
columns as the reference's does (all, by default), so its proof opens the
trace at zeta and zeta·g like every model's. The trace is built on the
device in blocks of rows from the inputs' words (int64, masked to 32
bits) and is the reference's, bit for bit (`generate_sha256_trace`).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import default_device
from ..air.api import BaseAir
from ..air.builder import Sym, stack_syms
from ..hashes.sha256 import K as _K
from ..hashes.sha256 import (big_sigma0, big_sigma1, small_sigma0,
                             small_sigma1, words_ops)

N_ROUNDS = 64
SCHED_EXT = 48
CHAIN_LEN = 4 + N_ROUNDS  # 68
K = tuple(int(k) for k in _K)

# ---- flat column offsets (columns.rs struct order) ----
OFF_H_IN = 0  # [8][2]
OFF_A_CHAIN = OFF_H_IN + 16  # [68][32]
OFF_E_CHAIN = OFF_A_CHAIN + CHAIN_LEN * 32
OFF_W = OFF_E_CHAIN + CHAIN_LEN * 32  # [64][32]
OFF_S_SIG0 = OFF_W + N_ROUNDS * 32  # [48][2]
OFF_S_SIG1 = OFF_S_SIG0 + SCHED_EXT * 2
OFF_S_TMP = OFF_S_SIG1 + SCHED_EXT * 2
OFF_ROUNDS = OFF_S_TMP + SCHED_EXT * 2  # [64][6][2]
ROUND_W = 6 * 2  # sigma1_e, ch, tmp1, t1, sigma0_a, maj
OFF_H_OUT = OFF_ROUNDS + N_ROUNDS * ROUND_W  # [8][32]
NUM_SHA256_COLS = OFF_H_OUT + 8 * 32
assert NUM_SHA256_COLS == 7728

# the packed slots of a round
R_SIG1E, R_CH, R_TMP1, R_T1, R_SIG0A, R_MAJ = range(6)

SIGMA = dict(
    big0=(2, 13, 22, True),
    big1=(6, 11, 25, True),
    small0=(7, 18, 3, False),
    small1=(17, 19, 10, False),
)


def _horner(bits_exprs):
    acc = bits_exprs[-1]
    for e in reversed(bits_exprs[:-1]):
        acc = acc + acc + e
    return acc


class Sha256Air(BaseAir):
    width = NUM_SHA256_COLS
    num_public_values = 0

    def __init__(self, field):
        self.field = field

    def max_constraint_degree(self):
        return 3

    # -- constraint families ---------------------------------------------
    def _bools(self, b, syms, lanes=1):
        v = stack_syms(syms)
        b.assert_zero_block(v * (v - 1), len(syms) * lanes)

    def _add2(self, b, a, x, c, lanes=1):
        """a = x + c mod 2^32 on limb expressions (air.rs add2)."""
        two16, two32 = 1 << 16, (1 << 32) % self.field.P
        acc16 = a[0] - x[0] - c[0]
        acc32 = a[1] - x[1] - c[1]
        acc = acc16 + acc32 * two16
        b.assert_zero_block(acc * (acc + two32), lanes)
        b.assert_zero_block(acc16 * (acc16 + two16), lanes)

    def _add3(self, b, a, x, c, d, lanes=1):
        two16, two32 = 1 << 16, (1 << 32) % self.field.P
        acc16 = a[0] - x[0] - c[0] - d[0]
        acc32 = a[1] - x[1] - c[1] - d[1]
        acc = acc16 + acc32 * two16
        b.assert_zero_block(acc * (acc + two32) * (acc + 2 * two32), lanes)
        b.assert_zero_block(
            acc16 * (acc16 + two16) * (acc16 + 2 * two16), lanes)

    def _pack(self, bits):
        return [_horner(bits[:16]), _horner(bits[16:])]

    def _sigma(self, b, bits, spec, packed, lanes=1):
        """packed = the XOR3 of rotated or shifted bit reads (air.rs:624)."""
        r1, r2, r3, rotate = SIGMA[spec]

        def third(i):
            if rotate:
                return bits[(i + r3) % 32]
            src = i + r3
            return bits[src] if src < 32 else None

        exprs = []
        for i in range(32):
            b1, b2, b3 = bits[(i + r1) % 32], bits[(i + r2) % 32], third(i)
            if b3 is None:  # xor3 with zero is xor2
                e = b1 + b2 - 2 * (b1 * b2)
            else:
                p12 = b1 * b2
                e = (b1 + b2 + b3 - 2 * (p12 + b1 * b3 + b2 * b3)
                     + 4 * (p12 * b3))
            exprs.append(e)
        built = self._pack(exprs)
        b.assert_zero_block(packed[0] - built[0], lanes)
        b.assert_zero_block(packed[1] - built[1], lanes)

    def _ch(self, b, e, f, g, packed, lanes=1):
        built = self._pack([e[i] * f[i] + (1 - e[i]) * g[i]
                            for i in range(32)])
        b.assert_zero_block(packed[0] - built[0], lanes)
        b.assert_zero_block(packed[1] - built[1], lanes)

    def _maj(self, b, a, x, c, packed, lanes=1):
        built = self._pack([a[i] * x[i] + c[i] * (a[i] + x[i]
                                                  - 2 * (a[i] * x[i]))
                            for i in range(32)])
        b.assert_zero_block(packed[0] - built[0], lanes)
        b.assert_zero_block(packed[1] - built[1], lanes)

    def eval(self, b):
        cols = b.main.local

        def bits(off):
            return cols[off:off + 32]

        def w_bits(t):
            return bits(OFF_W + 32 * t)

        def a_chain(i):
            return bits(OFF_A_CHAIN + 32 * i)

        def e_chain(i):
            return bits(OFF_E_CHAIN + 32 * i)

        def limbs(off):
            return list(cols[off:off + 2])

        def round_slot(t, which):
            return limbs(OFF_ROUNDS + t * ROUND_W + 2 * which)

        def lane_stack(per_lane):
            return [stack_syms([lane[j] for lane in per_lane])
                    for j in range(len(per_lane[0]))]

        # booleanity (air.rs:127): one block over all 6,656 bit columns
        all_bits = []
        for t in range(N_ROUNDS):
            all_bits.extend(w_bits(t))
        for i in range(CHAIN_LEN):
            all_bits.extend(a_chain(i))
            all_bits.extend(e_chain(i))
        for i in range(8):
            all_bits.extend(bits(OFF_H_OUT + 32 * i))
        self._bools(b, all_bits)

        # h_in equals the reversed chain prefixes (air.rs:164)
        for i in range(4):
            pk = self._pack(a_chain(3 - i))
            b.assert_zero(cols[OFF_H_IN + 2 * i] - pk[0])
            b.assert_zero(cols[OFF_H_IN + 2 * i + 1] - pk[1])
            pk = self._pack(e_chain(3 - i))
            b.assert_zero(cols[OFF_H_IN + 2 * (4 + i)] - pk[0])
            b.assert_zero(cols[OFF_H_IN + 2 * (4 + i) + 1] - pk[1])

        # the message schedule, 48 lanes (air.rs:193)
        ext = range(16, 64)
        s_w15 = lane_stack([w_bits(t - 15) for t in ext])
        s_w2 = lane_stack([w_bits(t - 2) for t in ext])
        s_w7 = lane_stack([w_bits(t - 7) for t in ext])
        s_w16 = lane_stack([w_bits(t - 16) for t in ext])
        s_wt = lane_stack([w_bits(t) for t in ext])
        s_sig0 = lane_stack([limbs(OFF_S_SIG0 + 2 * i)
                             for i in range(SCHED_EXT)])
        s_sig1 = lane_stack([limbs(OFF_S_SIG1 + 2 * i)
                             for i in range(SCHED_EXT)])
        s_tmp = lane_stack([limbs(OFF_S_TMP + 2 * i)
                            for i in range(SCHED_EXT)])
        L = SCHED_EXT
        self._sigma(b, s_w15, "small0", s_sig0, L)
        self._sigma(b, s_w2, "small1", s_sig1, L)
        self._add2(b, s_tmp, s_sig1, self._pack(s_w7), L)
        self._add3(b, self._pack(s_wt), s_tmp, s_sig0, self._pack(s_w16), L)

        # the compression, 64 lanes (air.rs:273)
        rounds = range(N_ROUNDS)
        a_s = lane_stack([a_chain(t + 3) for t in rounds])
        b_s = lane_stack([a_chain(t + 2) for t in rounds])
        c_s = lane_stack([a_chain(t + 1) for t in rounds])
        d_s = lane_stack([a_chain(t) for t in rounds])
        e_s = lane_stack([e_chain(t + 3) for t in rounds])
        f_s = lane_stack([e_chain(t + 2) for t in rounds])
        g_s = lane_stack([e_chain(t + 1) for t in rounds])
        h_s = lane_stack([e_chain(t) for t in rounds])
        na_s = lane_stack([a_chain(t + 4) for t in rounds])
        ne_s = lane_stack([e_chain(t + 4) for t in rounds])
        slots = [lane_stack([round_slot(t, wh) for t in rounds])
                 for wh in range(6)]
        k_lo = Sym(b.backend, b.backend.const_vec([K[t] & 0xFFFF
                                                   for t in rounds]))
        k_hi = Sym(b.backend, b.backend.const_vec([K[t] >> 16
                                                   for t in rounds]))
        L = N_ROUNDS
        self._sigma(b, e_s, "big1", slots[R_SIG1E], L)
        self._ch(b, e_s, f_s, g_s, slots[R_CH], L)
        self._add3(b, slots[R_TMP1], slots[R_SIG1E], slots[R_CH],
                   self._pack(h_s), L)
        self._add3(b, slots[R_T1], slots[R_TMP1], [k_lo, k_hi],
                   self._pack(lane_stack([w_bits(t) for t in rounds])), L)
        self._sigma(b, a_s, "big0", slots[R_SIG0A], L)
        self._maj(b, a_s, b_s, c_s, slots[R_MAJ], L)
        self._add3(b, self._pack(na_s), slots[R_T1], slots[R_SIG0A],
                   slots[R_MAJ], L)
        self._add2(b, self._pack(ne_s), slots[R_T1], self._pack(d_s), L)

        # finalization (air.rs:394)
        fin_a = lane_stack([a_chain(CHAIN_LEN - 1 - i) for i in range(4)])
        fin_e = lane_stack([e_chain(CHAIN_LEN - 1 - i) for i in range(4)])
        ho_a = lane_stack([bits(OFF_H_OUT + 32 * i) for i in range(4)])
        ho_e = lane_stack([bits(OFF_H_OUT + 32 * (4 + i)) for i in range(4)])
        hin_a = lane_stack([limbs(OFF_H_IN + 2 * i) for i in range(4)])
        hin_e = lane_stack([limbs(OFF_H_IN + 2 * (4 + i)) for i in range(4)])
        self._add2(b, self._pack(ho_a), hin_a, self._pack(fin_a), 4)
        self._add2(b, self._pack(ho_e), hin_e, self._pack(fin_e), 4)


# ---------------------------------------------------------------------------
# trace generation: int64 words below 2^32, a block of rows at a time
# ---------------------------------------------------------------------------
def _trace_block(out, inputs):
    """Write the standard-form rows of `inputs` ((B, 24) int64 words: 16
    block words, then 8 input state words) into `out`, a (B, 7728) int64
    tensor on the same device."""
    o = words_ops(torch)
    z = torch.arange(32, device=out.device)

    def put_bits(base, words):
        out[:, base:base + 32] = (words[:, None] >> z) & 1

    def put_limbs(base, words):
        out[:, base] = words & 0xFFFF
        out[:, base + 1] = words >> 16

    h_in = [inputs[:, 16 + i] for i in range(8)]
    for i in range(8):
        put_limbs(OFF_H_IN + 2 * i, h_in[i])

    w = [inputs[:, t] for t in range(16)]
    for t in range(16, 64):
        s0, s1 = small_sigma0(o, w[t - 15]), small_sigma1(o, w[t - 2])
        i = t - 16
        put_limbs(OFF_S_SIG0 + 2 * i, s0)
        put_limbs(OFF_S_SIG1 + 2 * i, s1)
        tmp = o.add(s1, w[t - 7])
        put_limbs(OFF_S_TMP + 2 * i, tmp)
        w.append(o.add(tmp, s0, w[t - 16]))
    for t in range(64):
        put_bits(OFF_W + 32 * t, w[t])

    # the chains: the reversed prefix, then one entry a round
    a_chain = [h_in[3], h_in[2], h_in[1], h_in[0]]
    e_chain = [h_in[7], h_in[6], h_in[5], h_in[4]]
    a, bb, c, d = h_in[0], h_in[1], h_in[2], h_in[3]
    e, f, g, h = h_in[4], h_in[5], h_in[6], h_in[7]
    for t in range(64):
        s1 = big_sigma1(o, e)
        ch = (e & f) ^ (o.inv(e) & g)
        tmp1 = o.add(h, s1, ch)
        t1 = o.add(tmp1, K[t], w[t])
        s0 = big_sigma0(o, a)
        maj = (a & bb) ^ (a & c) ^ (bb & c)
        new_a = o.add(t1, s0, maj)
        new_e = o.add(d, t1)
        base = OFF_ROUNDS + t * ROUND_W
        for slot, v in ((R_SIG1E, s1), (R_CH, ch), (R_TMP1, tmp1),
                        (R_T1, t1), (R_SIG0A, s0), (R_MAJ, maj)):
            put_limbs(base + 2 * slot, v)
        a_chain.append(new_a)
        e_chain.append(new_e)
        a, bb, c, d = new_a, a, bb, c
        e, f, g, h = new_e, e, f, g
    for i in range(CHAIN_LEN):
        put_bits(OFF_A_CHAIN + 32 * i, a_chain[i])
        put_bits(OFF_E_CHAIN + 32 * i, e_chain[i])
    for i in range(8):
        final = (a_chain, e_chain)[i // 4][CHAIN_LEN - 1 - (i % 4)]
        put_bits(OFF_H_OUT + 32 * i, o.add(h_in[i], final))


# rows a trace block holds: a (2^14, 7728) int64 block is 1 GB
TRACE_BLOCK_ROWS = 1 << 14


def generate_sha256_trace(F, inputs: np.ndarray, device=None):
    """inputs (n, 24) uint32: the (n, 7728) trace, one compression a row
    (the reference's `generate_sha256_trace`), as an int64 Montgomery
    tensor on `device` (default cuda), built there TRACE_BLOCK_ROWS rows
    at a time: the host holds the inputs only."""
    n = inputs.shape[0]
    if n & (n - 1) or n == 0:
        raise ValueError(f"{n} rows is not a power of two")
    dev = default_device(device)
    words = torch.from_numpy(np.asarray(inputs, np.uint32).astype(np.int64))
    out = torch.empty((n, NUM_SHA256_COLS), dtype=torch.int64, device=dev)
    block = TRACE_BLOCK_ROWS
    for a in range(0, n, block):
        part = out[a:a + block]
        _trace_block(part, words[a:a + block].to(dev))
        part.copy_(F.to_monty_tensor(part))
    return out
