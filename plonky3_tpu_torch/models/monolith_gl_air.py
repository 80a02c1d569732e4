"""Monolith-Goldilocks AIR: one width-8 permutation a row, 3,536 columns.

Port of `plonky3_tpu/models/monolith_gl_air.py` (monolith-air/src/
air.rs:52-55, GOLDILOCKS_8_LIMB_BITS): the structure of
`models/monolith_air.py` with the Goldilocks parameters. WIDTH 8, 4 Bars,
FIELD_BITS 64, eight 8-bit limbs (every limb the 3-input AND chi with
committed product cells), and the canonical-pattern walk for the modulus
0xFFFFFFFF00000001: its 32 leading one-bits pair into 16 committed match
flags, the 31 zero-bits assert prev·bit = 0 with no committed cell
(air.rs:516-520), and the last one-bit (bit 0) folds into the closing
assertion. The constants and the MDS row are `hashes/monolith.py`'s
MonolithGoldilocks(width=8).

`generate_monolith_gl_trace` computes the trace with int64 tensors (the
u64 bits of each element, `gl/field.py`) on the device, all rows at once;
the reference's generator walks the rows in Python ints. The words are
the same.
"""

from __future__ import annotations

import torch

from .. import default_device
from ..air.api import BaseAir
from ..air.builder import Sym, stack_syms
from ..fields import goldilocks_device as gd
from ..gl.field import GLF, to_tensor
from ..hashes.monolith import MDS_ROW_8_GL, MonolithGoldilocks, bar64_tensor

WIDTH = 8
N_ROUNDS = 5  # full rounds with constants; +1 final round
N_BARS = 4
FIELD_BITS = 64
LIMB_BITS = (8,) * 8
N_CHI = 64  # eight 8-bit limbs x 8 committed chi cells
N_MFLAGS = 16  # 32 leading modulus one-bits -> 16 pairs
P = GLF.P
_MOD_BITS_LSB = [(P >> i) & 1 for i in range(FIELD_BITS)]

BAR_BLOCK = FIELD_BITS + N_CHI + N_MFLAGS  # 144
ROUND_W = N_BARS * BAR_BLOCK + N_BARS + WIDTH  # 588
OFF_INPUTS = 0
OFF_ROUNDS = WIDTH
NUM_MONOLITH_GL_COLS = WIDTH + (N_ROUNDS + 1) * ROUND_W  # 3536


def _round_off(r):
    return OFF_ROUNDS + r * ROUND_W


def _bits_off(r, bar):
    return _round_off(r) + bar * BAR_BLOCK


def _chi_off(r, bar):
    return _bits_off(r, bar) + FIELD_BITS


def _mflag_off(r, bar):
    return _chi_off(r, bar) + N_CHI


def _barout_off(r):
    return _round_off(r) + N_BARS * BAR_BLOCK


def _post_off(r):
    return _barout_off(r) + N_BARS


def _pack(bits):
    acc = None
    for i, x in enumerate(bits):
        term = x * ((1 << i) % P)
        acc = term if acc is None else acc + term
    return acc


class MonolithGoldilocksAir(BaseAir):
    width = NUM_MONOLITH_GL_COLS
    num_public_values = 0

    def __init__(self, field=GLF):
        self.field = field
        self.perm = MonolithGoldilocks(width=WIDTH)

    def max_constraint_degree(self):
        return 3

    def _mds(self, state):
        w = WIDTH
        return [
            sum(
                (state[j] * int(MDS_ROW_8_GL[(j - i) % w])
                 for j in range(w)),
                start=state[i] * 0,
            )
            for i in range(w)
        ]

    def eval(self, b):
        cols = b.main.local

        def lane_stack(per_lane):
            k = len(per_lane[0])
            return [
                stack_syms([lane[j] for lane in per_lane])
                for j in range(k)
            ]

        inputs = [cols[OFF_INPUTS + i] for i in range(WIDTH)]
        round_inputs = [self._mds(inputs)]
        for r in range(N_ROUNDS):
            round_inputs.append(
                [cols[_post_off(r) + i] for i in range(WIDTH)]
            )

        # ---- Bars: 24 stacked (round, bar) lanes ----
        lanes = []
        for r in range(N_ROUNDS + 1):
            for bar in range(N_BARS):
                o_bits = _bits_off(r, bar)
                o_chi = _chi_off(r, bar)
                o_mf = _mflag_off(r, bar)
                lanes.append(dict(
                    bits=cols[o_bits : o_bits + FIELD_BITS],
                    chi=cols[o_chi : o_chi + N_CHI],
                    mflags=cols[o_mf : o_mf + N_MFLAGS],
                    out=[cols[_barout_off(r) + bar]],
                    state=[round_inputs[r][bar]],
                ))
        L = len(lanes)
        bits = lane_stack([ln["bits"] for ln in lanes])
        chi = lane_stack([ln["chi"] for ln in lanes])
        mflags = lane_stack([ln["mflags"] for ln in lanes])
        bar_out = lane_stack([ln["out"] for ln in lanes])[0]
        state_in = lane_stack([ln["state"] for ln in lanes])[0]

        bools = stack_syms(bits)
        b.assert_zero_block(bools * (bools - 1), FIELD_BITS * L)
        b.assert_zero_block(_pack(bits) - state_in, L)

        # chi witnesses + S-box recombination (all 8-bit limbs)
        result = None
        bit_off = 0
        chi_idx = 0
        for n_l in LIMB_BITS:
            x = bits[bit_off : bit_off + n_l]

            def sub(base, k, n=n_l):
                return (base + n - (k % n)) % n

            cx = chi[chi_idx : chi_idx + n_l]
            binds = []
            for j in range(n_l):
                andn = (1 - x[sub(j, 2)]) * x[sub(j, 3)]
                binds.append(cx[j] - andn * x[sub(j, 4)])
            b.assert_zero_block(stack_syms(binds), n_l * L)
            out_bits = []
            for j in range(n_l):
                xj = x[sub(j, 1)]
                out_bits.append(xj + cx[j] - 2 * (xj * cx[j]))
            limb = _pack(out_bits)
            chi_idx += n_l
            shifted = limb * ((1 << bit_off) % P)
            result = shifted if result is None else result + shifted
            bit_off += n_l
        b.assert_zero_block(bar_out - result, L)

        # canonical-pattern walk (air.rs:482-525): MSB -> LSB; paired
        # one-bits commit flags, zero-bits assert prev·x = 0 cell-free
        prev = None  # None == the implicit leading ONE
        flag_idx = 0
        pending = None
        for i in range(FIELD_BITS - 1, -1, -1):
            x_i = bits[i]
            if _MOD_BITS_LSB[i]:
                if pending is None:
                    pending = x_i
                else:
                    m_i = mflags[flag_idx]
                    expr = (
                        m_i - pending * x_i
                        if prev is None
                        else m_i - prev * pending * x_i
                    )
                    b.assert_zero_block(expr, L)
                    prev = m_i
                    pending = None
                    flag_idx += 1
            else:
                gate = x_i if prev is None else prev * x_i
                b.assert_zero_block(gate, L)
        assert flag_idx == N_MFLAGS
        closing = (
            prev * pending if pending is not None
            else (prev if prev is not None else None)
        )
        assert closing is not None
        b.assert_zero_block(closing, L)

        # ---- round bindings ----
        post_lanes = []
        for r in range(N_ROUNDS + 1):
            st = list(round_inputs[r])
            for bar in range(N_BARS):
                st[bar] = cols[_barout_off(r) + bar]
            post_lanes.append(dict(
                bars=st,
                post=[cols[_post_off(r) + i] for i in range(WIDTH)],
            ))
        bars_s = lane_stack([ln["bars"] for ln in post_lanes])
        post_s = lane_stack([ln["post"] for ln in post_lanes])
        bricks = [bars_s[0]]
        for i in range(1, WIDTH):
            bricks.append(bars_s[i] + bars_s[i - 1] * bars_s[i - 1])
        concrete = self._mds(bricks)
        rc = self.perm.rc
        R = N_ROUNDS + 1
        for i in range(WIDTH):
            rc_col = Sym(
                b.backend,
                b.backend.const_vec(
                    [int(rc[r][i]) if r < N_ROUNDS else 0
                     for r in range(R)]
                ),
            )
            b.assert_zero_block(concrete[i] + rc_col - post_s[i], R)


def _concrete(st):
    """The width-8 circulant of MDS_ROW_8_GL on (n, 8): the 32-bit halves
    times its small coefficients (a row sums to 96), reduced once."""
    m = torch.tensor([[MDS_ROW_8_GL[(j - i) % WIDTH] for i in range(WIDTH)]
                      for j in range(WIDTH)], dtype=torch.int64,
                     device=st.device)
    halves = torch.stack([st & 0xFFFFFFFF, (st >> 32) & 0xFFFFFFFF])
    t = (halves[..., :, None] * m).sum(dim=-2)
    return gd._combine(t[0], t[1])


def _chi_index():
    """(3, 64) bit positions of each chi cell's three inputs: limb base +
    (j + 8 - k) mod 8 for k = 2, 3, 4."""
    out = [[], [], []]
    for bo in range(0, FIELD_BITS, 8):
        for j in range(8):
            for row, k in enumerate((2, 3, 4)):
                out[row].append(bo + (j + 8 - k) % 8)
    return out


def generate_monolith_gl_trace(inputs, device=None):
    """The (n, 3536) trace of the permutations of `inputs` ((n, 8)
    elements < P: uint64 numpy or an int64 tensor of their bits), an
    int64 tensor on `device` (default cuda; a tensor's own device when
    given a tensor)."""
    if isinstance(inputs, torch.Tensor):
        x = inputs.to(torch.int64)
    else:
        x = to_tensor(inputs, default_device(device))
    n = x.shape[0]
    if n & (n - 1):
        raise ValueError(f"{n} rows: a power of two is needed")
    dev = x.device
    rc = MonolithGoldilocks(width=WIDTH).rc
    chi_a, chi_b, chi_c = (torch.tensor(i, device=dev) for i in _chi_index())
    shifts = torch.arange(FIELD_BITS, device=dev)
    tr = torch.zeros((n, NUM_MONOLITH_GL_COLS), dtype=torch.int64,
                     device=dev)
    tr[:, :WIDTH] = x
    st = _concrete(x)
    for r in range(N_ROUNDS + 1):
        st = st.clone()
        for bar in range(N_BARS):
            v = st[:, bar]
            bits = (v[:, None] >> shifts) & 1  # (n, 64)
            o = _bits_off(r, bar)
            tr[:, o:o + FIELD_BITS] = bits
            tr[:, _chi_off(r, bar):_chi_off(r, bar) + N_CHI] = (
                (1 - bits[:, chi_a]) * bits[:, chi_b] * bits[:, chi_c])
            # the match flags: products of the top bits, two at a time
            pairs = bits[:, FIELD_BITS - 2 * N_MFLAGS:].flip(1).reshape(
                n, N_MFLAGS, 2).prod(dim=2)
            tr[:, _mflag_off(r, bar):_mflag_off(r, bar) + N_MFLAGS] = (
                pairs.cumprod(dim=1))
            out = bar64_tensor(v)
            tr[:, _barout_off(r) + bar] = out
            st[:, bar] = out
        # bricks: s_i += s_{i-1}^2, from the old s_{i-1}
        st = torch.cat([st[:, :1], gd.add(st[:, 1:], gd.square(st[:, :-1]))],
                       dim=1)
        st = _concrete(st)
        if r < N_ROUNDS:
            st = gd.add(st, to_tensor(rc[r], dev))
        tr[:, _post_off(r):_post_off(r) + WIDTH] = st
    return tr
