"""Monolith-Mersenne31 AIR: one permutation a row, 3,520 columns.

Port of `plonky3_tpu/models/monolith_air.py` (monolith-air/src/
{columns.rs, air.rs}, instantiated as in lib.rs:45-89): WIDTH 16, 5 full
rounds and a final one, 8 Bars with limbs of [8, 8, 8, 7] bits
(FIELD_BITS 31, 24 committed chi cells, 15 match flags a Bar). A round:

  Bars: boolean bits; their sum is the round input; chi AND products
    chi[j] = (1 - x[j-2])·x[j-3]·x[j-4] (the 7-bit limb inlines its
    two-input AND); the committed Bar output is the recombined chi
    S-box; the canonical bit-pattern walk pairs the modulus's one-bits
    two a flag and rejects any encoding >= p (air.rs:482-525; every bit
    of the Mersenne modulus is 1: 15 pairs, the last bit folds into the
    closing assertion).
  Bricks: post[i] = bars[i] + bars[i-1]^2 (degree 2).
  Concrete: the circulant, plus the round constants except in the final
    round. The bound post columns keep every round at degree <= 3.

The 48 (round, bar) slots and the 6 round bindings are stacked on a lane
axis, so each constraint family is one block, in the reference's order.
`generate_monolith_trace` computes the trace with int64 tensors on the
device, all rows at once.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import default_device
from ..air.api import BaseAir
from ..air.builder import Sym, stack_syms
from ..hashes.monolith import (MDS_ROW_16, MonolithM31, bar, bricks,
                               concrete, device_tables)

WIDTH = 16
N_ROUNDS = 5  # full rounds with constants; then the final round
N_BARS = 8
FIELD_BITS = 31
LIMB_BITS = (8, 8, 8, 7)
N_CHI = 24  # committed chi cells a bar (8 + 8 + 8; the 7-bit limb inlined)
N_MFLAGS = 15  # Mersenne31: 31 one-bits -> 15 pairs
P = (1 << 31) - 1

# a round's block: bits 8·31, chi 8·24, mflags 8·15, bar outputs 8,
# post 16
BAR_BLOCK = FIELD_BITS + N_CHI + N_MFLAGS  # 70 a bar
ROUND_W = N_BARS * BAR_BLOCK + N_BARS + WIDTH  # 584
OFF_INPUTS = 0
OFF_ROUNDS = WIDTH
NUM_MONOLITH_COLS = WIDTH + (N_ROUNDS + 1) * ROUND_W  # 3520


def _round_off(r):
    return OFF_ROUNDS + r * ROUND_W


def _bits_off(r, b):
    return _round_off(r) + b * FIELD_BITS


def _chi_off(r, b):
    return _round_off(r) + N_BARS * FIELD_BITS + b * N_CHI


def _mflag_off(r, b):
    return _round_off(r) + N_BARS * (FIELD_BITS + N_CHI) + b * N_MFLAGS


def _barout_off(r):
    return _round_off(r) + N_BARS * BAR_BLOCK


def _post_off(r):
    return _barout_off(r) + N_BARS


def _pack(bits):
    acc = bits[-1]
    for b in reversed(bits[:-1]):
        acc = acc + acc + b
    return acc


class MonolithAir(BaseAir):
    width = NUM_MONOLITH_COLS
    num_public_values = 0

    def __init__(self, field):
        self.field = field
        self.perm = MonolithM31()

    def max_constraint_degree(self):
        return 3

    def _mds(self, state):
        return [sum((state[j] * int(MDS_ROW_16[(j - i) % WIDTH])
                     for j in range(WIDTH)), start=state[i] * 0)
                for i in range(WIDTH)]

    def eval(self, b):
        cols = b.main.local

        def lane_stack(per_lane):
            return [stack_syms([lane[j] for lane in per_lane])
                    for j in range(len(per_lane[0]))]

        # each round's input: expressions in round 0, post columns after
        round_inputs = [self._mds([cols[OFF_INPUTS + i]
                                   for i in range(WIDTH)])]
        for r in range(N_ROUNDS):
            round_inputs.append([cols[_post_off(r) + i]
                                 for i in range(WIDTH)])

        # ---- Bars: 48 stacked (round, bar) lanes ----
        lanes = [dict(
            bits=cols[_bits_off(r, k):_bits_off(r, k) + FIELD_BITS],
            chi=cols[_chi_off(r, k):_chi_off(r, k) + N_CHI],
            mflags=cols[_mflag_off(r, k):_mflag_off(r, k) + N_MFLAGS],
            out=[cols[_barout_off(r) + k]],
            state=[round_inputs[r][k]])
            for r in range(N_ROUNDS + 1) for k in range(N_BARS)]
        L = len(lanes)
        bits = lane_stack([ln["bits"] for ln in lanes])
        chi = lane_stack([ln["chi"] for ln in lanes])
        mflags = lane_stack([ln["mflags"] for ln in lanes])
        bar_out = lane_stack([ln["out"] for ln in lanes])[0]
        state_in = lane_stack([ln["state"] for ln in lanes])[0]

        bools = stack_syms(bits)
        b.assert_zero_block(bools * (bools - 1), FIELD_BITS * L)
        b.assert_zero_block(_pack(bits) - state_in, L)

        # chi witnesses and the S-box recombination (air.rs:567-636)
        result, bit_off, chi_off = None, 0, 0
        for n in LIMB_BITS:
            x = bits[bit_off:bit_off + n]

            def sub(base, k, n=n):
                return (base + n - (k % n)) % n

            if n < 8:
                out_bits = []
                for j in range(n):
                    andn = (1 - x[sub(j, 2)]) * x[sub(j, 3)]
                    xj = x[sub(j, 1)]
                    out_bits.append(xj + andn - 2 * (xj * andn))
            else:
                cx = chi[chi_off:chi_off + n]
                binds = []
                for j in range(n):
                    andn = (1 - x[sub(j, 2)]) * x[sub(j, 3)]
                    binds.append(cx[j] - andn * x[sub(j, 4)])
                b.assert_zero_block(stack_syms(binds), n * L)
                out_bits = []
                for j in range(n):
                    xj = x[sub(j, 1)]
                    out_bits.append(xj + cx[j] - 2 * (xj * cx[j]))
                chi_off += n
            shifted = _pack(out_bits) * ((1 << bit_off) % P)
            result = shifted if result is None else result + shifted
            bit_off += n
        b.assert_zero_block(bar_out - result, L)

        # the canonical-pattern walk (air.rs:482-525); M31: all bits one
        prev, flag_idx, pending = None, 0, None
        for i in range(FIELD_BITS - 1, -1, -1):
            if pending is None:
                pending = bits[i]
            else:
                m_i = mflags[flag_idx]
                expr = (m_i - pending * bits[i] if prev is None
                        else m_i - prev * pending * bits[i])
                b.assert_zero_block(expr, L)
                prev, pending = m_i, None
                flag_idx += 1
        # an odd weight: the last bit 0 folds into the closing check
        b.assert_zero_block(prev * pending if pending is not None else prev,
                            L)

        # ---- round bindings: 6 stacked lanes ----
        post_lanes = []
        for r in range(N_ROUNDS + 1):
            st = list(round_inputs[r])
            for k in range(N_BARS):
                st[k] = cols[_barout_off(r) + k]
            post_lanes.append(dict(
                bars=st, post=[cols[_post_off(r) + i]
                               for i in range(WIDTH)]))
        bars_s = lane_stack([ln["bars"] for ln in post_lanes])
        post_s = lane_stack([ln["post"] for ln in post_lanes])
        brick = [bars_s[0]] + [bars_s[i] + bars_s[i - 1] * bars_s[i - 1]
                               for i in range(1, WIDTH)]
        conc = self._mds(brick)
        # the round constants; zeros in the final round
        rc, R = self.perm.rc, N_ROUNDS + 1
        for i in range(WIDTH):
            rc_col = Sym(b.backend, b.backend.const_vec(
                [int(rc[r][i]) if r < N_ROUNDS else 0 for r in range(R)]))
            b.assert_zero_block(conc[i] + rc_col - post_s[i], R)


def generate_monolith_trace(F, inputs, device=None):
    """The (n, 3520) trace of the permutations of `inputs` ((n, 16)
    words < P: a numpy array or an int64 tensor), as an int64 tensor on
    `device` (default cuda; a tensor's own device when given a
    tensor)."""
    if isinstance(inputs, torch.Tensor):
        x = inputs.to(torch.int64) % P
    else:
        x = torch.from_numpy(np.asarray(inputs).astype(np.int64) % P).to(
            default_device(device))
    n = x.shape[0]
    if n & (n - 1):
        raise ValueError(f"{n} rows: a power of two is needed")
    dev = x.device
    perm = MonolithM31()
    low16, high15, mds = device_tables(dev)
    tr = torch.zeros((n, NUM_MONOLITH_COLS), dtype=torch.int64, device=dev)
    tr[:, :WIDTH] = x
    shifts = torch.arange(FIELD_BITS, device=dev)
    state = concrete(x, mds)
    for r in range(N_ROUNDS + 1):
        for k in range(N_BARS):
            v = state[:, k]
            bits = (v[:, None] >> shifts) & 1  # (n, 31)
            tr[:, _bits_off(r, k):_bits_off(r, k) + FIELD_BITS] = bits
            # the chi products of the three 8-bit limbs
            ci, bo = 0, 0
            for n_l in LIMB_BITS[:3]:
                for j in range(n_l):
                    def at(k2, j=j, n_l=n_l, bo=bo):
                        return bits[:, bo + (j + n_l - (k2 % n_l)) % n_l]
                    tr[:, _chi_off(r, k) + ci] = (1 - at(2)) * at(3) * at(4)
                    ci += 1
                bo += n_l
            # the match flags: bit pairs from the top
            prev = torch.ones_like(v)
            fi, pending = 0, None
            for i in range(FIELD_BITS - 1, -1, -1):
                if pending is None:
                    pending = bits[:, i]
                else:
                    prev = prev * pending * bits[:, i]
                    tr[:, _mflag_off(r, k) + fi] = prev
                    pending = None
                    fi += 1
            out = bar(v, low16, high15)
            tr[:, _barout_off(r) + k] = out
            state = state.clone()
            state[:, k] = out
        state = concrete(bricks(state), mds)
        if r < N_ROUNDS:
            state = (state + torch.tensor(perm.rc[r], dtype=torch.int64,
                                          device=dev)) % P
        tr[:, _post_off(r):_post_off(r) + WIDTH] = state
    return tr
