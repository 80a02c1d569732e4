"""Keccak-f[1600] AIR: 24 rows a permutation, 2,633 columns.

Port of `plonky3_tpu/models/keccak_air.py` (keccak-air/src/columns.rs:18-
120, air.rs:44-206, round_flags.rs:21). The column layout, the
constraints and their emission order are the reference's: step_flags[24],
export, preimage[y][x][limb], a[y][x][limb], c[x][z], c_prime[x][z],
a_prime[y][x][z], a_prime_prime[y][x][limb], a_prime_prime_0_0_bits[z],
a_prime_prime_prime_0_0_limbs; 64-bit words as four 16-bit limbs
(lib.rs:25-30); theta, rho-pi, chi and iota through the arithmetic xor and
andn (field/src/field.rs:178-198). Each constraint family is one stacked
block (`assert_zero_block`), which the prover folds with one batched
product a coordinate. The trace is generated in numpy over all
permutations at once.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import default_device
from ..air.api import BaseAir
from ..air.builder import Sym, stack_syms

NUM_ROUNDS = 24
U64_LIMBS = 4

# rho rotation offsets R[x][y] (keccak-air/src/constants.rs:1)
R = (
    (0, 36, 3, 41, 18),
    (1, 44, 10, 45, 2),
    (62, 6, 43, 15, 61),
    (28, 55, 25, 21, 56),
    (27, 20, 39, 8, 14),
)

RC = (
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A,
    0x8000000080008000, 0x000000000000808B, 0x0000000080000001,
    0x8000000080008081, 0x8000000000008009, 0x000000000000008A,
    0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089,
    0x8000000000008003, 0x8000000000008002, 0x8000000000000080,
    0x000000000000800A, 0x800000008000000A, 0x8000000080008081,
    0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
)

# ---- flat column offsets (columns.rs order) ----
OFF_STEP = 0
OFF_EXPORT = OFF_STEP + NUM_ROUNDS
OFF_PREIMAGE = OFF_EXPORT + 1  # [y][x][limb]
OFF_A = OFF_PREIMAGE + 100
OFF_C = OFF_A + 100  # [x][z]
OFF_C_PRIME = OFF_C + 320
OFF_A_PRIME = OFF_C_PRIME + 320  # [y][x][z]
OFF_A_PP = OFF_A_PRIME + 1600  # [y][x][limb]
OFF_A_PP_00_BITS = OFF_A_PP + 100
OFF_A_PPP_00 = OFF_A_PP_00_BITS + 64
NUM_KECCAK_COLS = OFF_A_PPP_00 + U64_LIMBS
assert NUM_KECCAK_COLS == 2633


def _pre(y, x, limb):
    return OFF_PREIMAGE + (y * 5 + x) * U64_LIMBS + limb


def _a(y, x, limb):
    return OFF_A + (y * 5 + x) * U64_LIMBS + limb


def _c(x, z):
    return OFF_C + x * 64 + z


def _cp(x, z):
    return OFF_C_PRIME + x * 64 + z


def _ap(y, x, z):
    return OFF_A_PRIME + (y * 5 + x) * 64 + z


def _app(y, x, limb):
    return OFF_A_PP + (y * 5 + x) * U64_LIMBS + limb


def _b_col(x, y, z):
    """Column of B[x,y,z] — an alias into a_prime (columns.rs:64-80)."""
    a = (x + 3 * y) % 5
    b = x
    rot = R[a][b]
    return _ap(b, a, (z + 64 - rot) % 64)


# ---------------------------------------------------------------------------
# trace generation (vectorized over permutations)
# ---------------------------------------------------------------------------
def _gen_block(state_xy, out):
    """Fill out (B, 24, 2633) uint32 with the rounds of B permutations
    from state_xy, (x, y) -> (B,) uint64 words."""
    zbits = np.arange(64, dtype=np.uint64)

    def bits(w):  # (B,) u64 -> (B, 64) u32
        return ((w[:, None] >> zbits[None, :]) & np.uint64(1)).astype(
            np.uint32)

    def limbs(w):  # (B,) u64 -> (B, 4) u32 16-bit limbs
        sh = (np.arange(4, dtype=np.uint64) * np.uint64(16))[None, :]
        return ((w[:, None] >> sh) & np.uint64(0xFFFF)).astype(np.uint32)

    def rotl(w, r):
        r = np.uint64(r % 64)
        if r == 0:
            return w
        return (w << r) | (w >> (np.uint64(64) - r))

    preimage = {k: v.copy() for k, v in state_xy.items()}
    cur = {k: v.copy() for k, v in state_xy.items()}
    for rnd in range(NUM_ROUNDS):
        row = out[:, rnd]
        row[:, OFF_STEP + rnd] = 1
        for y in range(5):
            for x in range(5):
                row[:, _pre(y, x, 0):_pre(y, x, 0) + 4] = limbs(
                    preimage[(x, y)])
                row[:, _a(y, x, 0):_a(y, x, 0) + 4] = limbs(cur[(x, y)])
        C = [cur[(x, 0)] ^ cur[(x, 1)] ^ cur[(x, 2)] ^ cur[(x, 3)]
             ^ cur[(x, 4)] for x in range(5)]
        Cp = [C[x] ^ C[(x + 4) % 5] ^ rotl(C[(x + 1) % 5], 1)
              for x in range(5)]
        for x in range(5):
            row[:, _c(x, 0):_c(x, 0) + 64] = bits(C[x])
            row[:, _cp(x, 0):_cp(x, 0) + 64] = bits(Cp[x])
        # A'[x,y] = A ^ D[x], D[x] = C[x-1] ^ rotl(C[x+1], 1)
        Ap = {}
        for x in range(5):
            D = C[(x + 4) % 5] ^ rotl(C[(x + 1) % 5], 1)
            for y in range(5):
                Ap[(x, y)] = cur[(x, y)] ^ D
                row[:, _ap(y, x, 0):_ap(y, x, 0) + 64] = bits(Ap[(x, y)])
        # B[x,y] = rot(A'[a,b], R[a][b]), a = (x+3y)%5, b = x
        Bw = {}
        for x in range(5):
            for y in range(5):
                a, b = (x + 3 * y) % 5, x
                Bw[(x, y)] = rotl(Ap[(a, b)], R[a][b])
        App = {}
        for x in range(5):
            for y in range(5):
                App[(x, y)] = Bw[(x, y)] ^ (
                    ~Bw[((x + 1) % 5, y)] & Bw[((x + 2) % 5, y)])
                row[:, _app(y, x, 0):_app(y, x, 0) + 4] = limbs(App[(x, y)])
        row[:, OFF_A_PP_00_BITS:OFF_A_PP_00_BITS + 64] = bits(App[(0, 0)])
        appp00 = App[(0, 0)] ^ np.uint64(RC[rnd])
        row[:, OFF_A_PPP_00:OFF_A_PPP_00 + 4] = limbs(appp00)
        App[(0, 0)] = appp00
        cur = App


def keccak_trace_rows(inputs: np.ndarray) -> np.ndarray:
    """inputs: (B, 25) uint64, input[i, x + 5y] = state[x][y]
    (generation.rs:16). Returns the (next_pow2(24B), 2633) standard-form
    uint32 trace; the padding rows repeat the rounds of the all-zero
    input, cut at the end."""
    B = inputs.shape[0]
    num_rows = 24 * B
    n = 1 << max(int(np.ceil(np.log2(num_rows))), 0)
    if n < num_rows:
        n = num_rows
    state = {(x, y): inputs[:, x + 5 * y].astype(np.uint64)
             for x in range(5) for y in range(5)}
    trace = np.zeros((n, NUM_KECCAK_COLS), np.uint32)
    _gen_block(state, trace[:num_rows].reshape(B, NUM_ROUNDS,
                                               NUM_KECCAK_COLS))
    if n > num_rows:
        zero = {(x, y): np.zeros(1, np.uint64)
                for x in range(5) for y in range(5)}
        pad_block = np.zeros((1, NUM_ROUNDS, NUM_KECCAK_COLS), np.uint32)
        _gen_block(zero, pad_block)
        pad = np.tile(pad_block[0], ((n - num_rows) // NUM_ROUNDS + 1, 1))
        trace[num_rows:] = pad[:n - num_rows]
    return trace


def generate_keccak_trace(F, inputs: np.ndarray, device=None):
    """The trace of `keccak_trace_rows(inputs)` as an int64 Montgomery
    tensor on `device` (default cuda). Every entry is a bit, a 16-bit
    limb or a flag, so the words cross to the device as int32."""
    rows = keccak_trace_rows(inputs)
    words = torch.from_numpy(rows.view(np.int32)).to(default_device(device))
    return F.to_monty_tensor(words.to(torch.int64))


def keccak_f_reference(state25: np.ndarray) -> np.ndarray:
    """Plain keccak-f[1600] on (25,) uint64 (for trace cross-checks)."""
    s = {
        (x, y): int(state25[x + 5 * y]) for x in range(5) for y in range(5)
    }
    M = (1 << 64) - 1

    def rotl(v, r):
        return ((v << r) | (v >> (64 - r))) & M

    for rnd in range(NUM_ROUNDS):
        C = [s[(x, 0)] ^ s[(x, 1)] ^ s[(x, 2)] ^ s[(x, 3)] ^ s[(x, 4)]
             for x in range(5)]
        D = [C[(x + 4) % 5] ^ rotl(C[(x + 1) % 5], 1) for x in range(5)]
        Ap = {(x, y): s[(x, y)] ^ D[x] for x in range(5) for y in range(5)}
        Bw = {}
        for x in range(5):
            for y in range(5):
                a, b = (x + 3 * y) % 5, x
                Bw[(x, y)] = rotl(Ap[(a, b)], R[a][b])
        s = {
            (x, y): Bw[(x, y)] ^ ((~Bw[((x + 1) % 5, y)] & M)
                                  & Bw[((x + 2) % 5, y)])
            for x in range(5)
            for y in range(5)
        }
        s[(0, 0)] ^= RC[rnd]
    out = np.zeros(25, np.uint64)
    for x in range(5):
        for y in range(5):
            out[x + 5 * y] = s[(x, y)]
    return out


# ---------------------------------------------------------------------------
# the AIR
# ---------------------------------------------------------------------------
def _xor(a, b):
    return a + b - (a * b) * 2


def _xor3(a, b, c):
    return _xor(_xor(a, b), c)


def _andn(a, b):
    return (1 - a) * b


class KeccakAir(BaseAir):
    """keccak-f[1600], 24 rows a permutation (keccak-air/src/air.rs)."""

    width = NUM_KECCAK_COLS
    num_public_values = 0

    def __init__(self, field):
        self.field = field

    def max_constraint_degree(self):
        return 3  # xor3 / chi terms (air.rs families)

    def eval(self, b):
        local, nxt = b.main.local, b.main.next

        def lstack(idxs):
            return stack_syms([local[i] for i in idxs])

        def nstack(idxs):
            return stack_syms([nxt[i] for i in idxs])

        sf = [local[OFF_STEP + r] for r in range(NUM_ROUNDS)]
        nsf = [nxt[OFF_STEP + r] for r in range(NUM_ROUNDS)]

        # round flags (round_flags.rs:21)
        b.when_first_row().assert_one(sf[0])
        b.when_first_row().assert_zero_block(
            lstack(range(OFF_STEP + 1, OFF_STEP + NUM_ROUNDS)), NUM_ROUNDS - 1
        )
        b.when_transition().assert_zero_block(
            stack_syms(
                [sf[i] - nsf[(i + 1) % NUM_ROUNDS] for i in range(NUM_ROUNDS)]
            ),
            NUM_ROUNDS,
        )

        first_step = sf[0]
        final_step = sf[NUM_ROUNDS - 1]
        not_final = 1 - final_step
        tanf = b.is_transition * not_final

        pre_idx = [
            _pre(y, x, l) for y in range(5) for x in range(5) for l in range(4)
        ]
        a_idx = [
            _a(y, x, l) for y in range(5) for x in range(5) for l in range(4)
        ]
        # first step: preimage == a (air.rs:58-66)
        b.when(first_step).assert_zero_block(
            lstack(pre_idx) - lstack(a_idx), 100
        )
        # not-final transition: preimage matches next (air.rs:69-77)
        b.when(tanf).assert_zero_block(
            lstack(pre_idx) - nstack(pre_idx), 100
        )

        b.assert_bool(local[OFF_EXPORT])
        b.when(not_final).assert_zero(local[OFF_EXPORT])

        # theta: c bools + c_prime = xor3(c[x], c[x-1], rot(c[x+1],1))
        for x in range(5):
            c_x = lstack([_c(x, z) for z in range(64)])
            b.assert_zero_block(c_x * (c_x - 1), 64)
            c_xm = lstack([_c((x + 4) % 5, z) for z in range(64)])
            c_xp_rot = lstack([_c((x + 1) % 5, (z + 63) % 64)
                               for z in range(64)])
            cp_x = lstack([_cp(x, z) for z in range(64)])
            b.assert_zero_block(cp_x - _xor3(c_x, c_xm, c_xp_rot), 64)

        # A = A' ^ C ^ C' limb recomposition + A' bools (air.rs:101-128)
        for x in range(5):
            c_x = lstack([_c(x, z) for z in range(64)])
            cp_x = lstack([_cp(x, z) for z in range(64)])
            c_xor_cp = _xor(c_x, cp_x)
            for y in range(5):
                ap = lstack([_ap(y, x, z) for z in range(64)])
                b.assert_zero_block(ap * (ap - 1), 64)
                bits = _xor(ap, c_xor_cp)
                limb_terms = []
                for limb in range(U64_LIMBS):
                    acc = None
                    for z in reversed(
                        range(limb * 16, (limb + 1) * 16)
                    ):
                        bit = _bit_of(bits, z)
                        acc = bit if acc is None else acc * 2 + bit
                    limb_terms.append(acc - local[_a(y, x, limb)])
                b.assert_zero_block(stack_syms(limb_terms), U64_LIMBS)

        # xor_{i} A'[x,i,z] = C'[x,z]: diff(diff-2)(diff-4)=0 (air.rs:131-141)
        for x in range(5):
            s = None
            for y in range(5):
                ap = lstack([_ap(y, x, z) for z in range(64)])
                s = ap if s is None else s + ap
            cp_x = lstack([_cp(x, z) for z in range(64)])
            diff = s - cp_x
            b.assert_zero_block(diff * (diff - 2) * (diff - 4), 64)

        # chi: A''[x,y] limbs from B bits (air.rs:144-160)
        for y in range(5):
            for x in range(5):
                bit_cols_b0 = [_b_col(x, y, z) for z in range(64)]
                bit_cols_b1 = [_b_col((x + 1) % 5, y, z) for z in range(64)]
                bit_cols_b2 = [_b_col((x + 2) % 5, y, z) for z in range(64)]
                b0 = lstack(bit_cols_b0)
                b1 = lstack(bit_cols_b1)
                b2 = lstack(bit_cols_b2)
                bits = _xor(_andn(b1, b2), b0)
                limb_terms = []
                for limb in range(U64_LIMBS):
                    acc = None
                    for z in reversed(range(limb * 16, (limb + 1) * 16)):
                        bit = _bit_of(bits, z)
                        acc = bit if acc is None else acc * 2 + bit
                    limb_terms.append(acc - local[_app(y, x, limb)])
                b.assert_zero_block(stack_syms(limb_terms), U64_LIMBS)

        # iota: A''[0,0] bits bool + limb recomposition (air.rs:163-173)
        pp_bits = lstack(
            [OFF_A_PP_00_BITS + z for z in range(64)]
        )
        b.assert_zero_block(pp_bits * (pp_bits - 1), 64)
        limb_terms = []
        for limb in range(U64_LIMBS):
            acc = None
            for z in reversed(range(limb * 16, (limb + 1) * 16)):
                bit = local[OFF_A_PP_00_BITS + z]
                acc = bit if acc is None else acc * 2 + bit
            limb_terms.append(acc - local[_app(0, 0, limb)])
        b.assert_zero_block(stack_syms(limb_terms), U64_LIMBS)

        # A'''[0,0] = A''[0,0] xor RC (air.rs:175-194)
        limb_terms = []
        for limb in range(U64_LIMBS):
            acc = None
            for z in reversed(range(limb * 16, (limb + 1) * 16)):
                rc_rounds = [
                    r for r in range(NUM_ROUNDS) if (RC[r] >> z) & 1
                ]
                rc_bit = None
                for r in rc_rounds:
                    rc_bit = sf[r] if rc_bit is None else rc_bit + sf[r]
                bit = local[OFF_A_PP_00_BITS + z]
                xored = _xor(rc_bit, bit) if rc_bit is not None else bit
                acc = xored if acc is None else acc * 2 + xored
            limb_terms.append(acc - local[OFF_A_PPP_00 + limb])
        b.assert_zero_block(stack_syms(limb_terms), U64_LIMBS)

        # output of this round == input of next (air.rs:197-206); x outer
        out_terms = []
        for x in range(5):
            for y in range(5):
                for limb in range(U64_LIMBS):
                    src = (
                        local[OFF_A_PPP_00 + limb]
                        if (x, y) == (0, 0)
                        else local[_app(y, x, limb)]
                    )
                    out_terms.append(src - nxt[_a(y, x, limb)])
        b.when(tanf).assert_zero_block(stack_syms(out_terms), 100)


def _bit_of(stacked: Sym, z: int) -> Sym:
    """Entry z of a stacked Sym's leading (bit) axis: a row of a tensor
    (prover) or an item of a list (the host backends)."""
    return Sym(stacked.b, stacked.v[z])
