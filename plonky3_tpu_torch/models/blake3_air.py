"""Blake3 compression AIR: one compression a row, 9,168 columns.

Port of `plonky3_tpu/models/blake3_air.py` (blake3-air/src/columns.rs:
10-68, air.rs:44-457, generation.rs:49-247). The column layout, the
constraints and their emission order are the reference's: u32 words as
two 16-bit limbs on state rows 0 and 2 and as 32 bits on rows 1 and 3;
each of the 7 rounds stores four intermediate states (prime, middle,
middle_prime, output); the additions are checked with the acc·(acc +
2^32)(·...) products (air/src/utils.rs:82-185 add2/add3) and the xors with
rotation by xor_32_shift (utils.rs:202). The 56 quarter rounds are
stacked on one lane axis (`stack_syms`), and the boolean, addition and
xor families emit as `assert_zero_block`s.

The trace is built in blocks of rows, column-major in numpy (every
column write is contiguous), and goes to the device block by block as an
int64 Montgomery tensor (`generate_blake3_trace`).
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

from .. import default_device
from ..air.api import BaseAir
from ..air.builder import stack_syms

BPL = 16  # bits per limb
IV = (
    0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
    0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19,
)
MSG_PERMUTATION = (2, 6, 3, 10, 7, 0, 4, 13, 1, 11, 12, 5, 9, 14, 15, 8)

# ---- flat column offsets (columns.rs struct order) ----
OFF_INPUTS = 0  # [16][32] bits
OFF_CHAIN = OFF_INPUTS + 16 * 32  # [2][4][32] bits
OFF_CTR_LO = OFF_CHAIN + 8 * 32
OFF_CTR_HI = OFF_CTR_LO + 32
OFF_BLEN = OFF_CTR_HI + 32
OFF_FLAGS = OFF_BLEN + 32
OFF_IR0 = OFF_FLAGS + 32  # initial_row0 [4][2]
OFF_IR2 = OFF_IR0 + 8  # initial_row2 [4][2]
OFF_ROUNDS = OFF_IR2 + 8
STATE_W = 4 * 2 + 4 * 32 + 4 * 2 + 4 * 32  # 272
ROUND_W = 4 * STATE_W  # prime, middle, middle_prime, output
OFF_FRH = OFF_ROUNDS + 7 * ROUND_W  # final_round_helpers [4][32]
OFF_OUT = OFF_FRH + 4 * 32  # outputs [4][4][32]
NUM_BLAKE3_COLS = OFF_OUT + 16 * 32
assert NUM_BLAKE3_COLS == 9168


def _state_off(r, which):
    return OFF_ROUNDS + r * ROUND_W + which * STATE_W


class _StateView:
    """row0[i] -> 2 limb cols; row1/row3[i] -> 32 bit cols."""

    def __init__(self, cols, base):
        self.cols = cols
        self.base = base

    def row0(self, i):
        b = self.base + 2 * i
        return self.cols[b : b + 2]

    def row1(self, i):
        b = self.base + 8 + 32 * i
        return self.cols[b : b + 32]

    def row2(self, i):
        b = self.base + 8 + 128 + 2 * i
        return self.cols[b : b + 2]

    def row3(self, i):
        b = self.base + 8 + 128 + 8 + 32 * i
        return self.cols[b : b + 32]


def _pack16(bits):
    """Σ bit_i · 2^i over 16 Syms (utils.rs pack_bits_le)."""
    acc = bits[-1]
    for bit in reversed(bits[:-1]):
        acc = acc + acc + bit
    return acc


class Blake3Air(BaseAir):
    width = NUM_BLAKE3_COLS
    num_public_values = 0

    def __init__(self, field):
        self.field = field

    def max_constraint_degree(self):
        return 3  # air.rs:246

    # -- helpers (air/src/utils.rs), lane-stacked ----------------------
    # The quarter-round constraints operate on Syms whose prover-backend
    # value carries a leading lane axis (all 56 quarter rounds at once),
    # so each emission is one batched block instead of 56.
    def _bools(self, b, syms, lanes=1):
        v = stack_syms(syms)
        b.assert_zero_block(v * (v - 1), len(syms) * lanes)

    def _add3(self, b, a, x, c, d, lanes=1):
        """a = x + c + d mod 2^32; a/x are limb pairs, c/d limb exprs."""
        two16, two32 = 1 << 16, (1 << 32) % self.field.P
        acc16 = a[0] - x[0] - c[0] - d[0]
        acc32 = a[1] - x[1] - c[1] - d[1]
        acc = acc16 + acc32 * two16
        b.assert_zero_block(acc * (acc + two32) * (acc + 2 * two32),
                            lanes)
        b.assert_zero_block(
            acc16 * (acc16 + two16) * (acc16 + 2 * two16), lanes
        )

    def _add2(self, b, a, x, c, lanes=1):
        two16, two32 = 1 << 16, (1 << 32) % self.field.P
        acc16 = a[0] - x[0] - c[0]
        acc32 = a[1] - x[1] - c[1]
        acc = acc16 + acc32 * two16
        b.assert_zero_block(acc * (acc + two32), lanes)
        b.assert_zero_block(acc16 * (acc16 + two16), lanes)

    def _xor32_shift(self, b, a, x_bits, c_bits, shift, lanes=1):
        """a = x ^ (c <<< shift) (utils.rs:202): bool-check c, then pack
        x ^ rot(c) and compare limbs. a: 2 limbs; x, c: 32 bits."""
        self._bools(b, c_bits, lanes)
        rot = [c_bits[(32 + i - shift) % 32] for i in range(32)]
        xor = [
            x_bits[i] + rot[i] - 2 * (x_bits[i] * rot[i])
            for i in range(32)
        ]
        b.assert_zero_block(a[0] - _pack16(xor[:16]), lanes)
        b.assert_zero_block(a[1] - _pack16(xor[16:]), lanes)

    def _quarter(self, b, qr, lanes=1):
        """air.rs:43 quarter_round_function (lane-stacked)."""
        (a, bb, c, d, m0, ap, bp, cp, dp, m1, ao, bo, co, do_) = qr
        b_lims = [_pack16(bb[:16]), _pack16(bb[16:])]
        self._add3(b, ap, a, b_lims, m0, lanes)
        self._xor32_shift(b, ap, d, dp, 16, lanes)
        dp_lims = [_pack16(dp[:16]), _pack16(dp[16:])]
        self._add2(b, cp, c, dp_lims, lanes)
        self._xor32_shift(b, cp, bb, bp, 12, lanes)
        bp_lims = [_pack16(bp[:16]), _pack16(bp[16:])]
        self._add3(b, ao, ap, bp_lims, m1, lanes)
        self._xor32_shift(b, ao, dp, do_, 8, lanes)
        do_lims = [_pack16(do_[:16]), _pack16(do_[16:])]
        self._add2(b, co, cp, do_lims, lanes)
        self._xor32_shift(b, co, bp, bo, 7, lanes)

    def eval(self, b):
        cols = b.main.local

        def bits(off, k=32):
            return cols[off : off + k]

        # booleanity of every initialization input (air.rs:253)
        for i in range(16):
            self._bools(b, bits(OFF_INPUTS + 32 * i))
        for i in range(8):
            self._bools(b, bits(OFF_CHAIN + 32 * i))
        for off in (OFF_CTR_LO, OFF_CTR_HI, OFF_BLEN, OFF_FLAGS):
            self._bools(b, bits(off))

        # initial_row0 packs chaining_values[0]; initial_row2 = IV[0..4]
        for i in range(4):
            cv = bits(OFF_CHAIN + 32 * i)
            b.assert_zero(cols[OFF_IR0 + 2 * i] - _pack16(cv[:16]))
            b.assert_zero(cols[OFF_IR0 + 2 * i + 1] - _pack16(cv[16:]))
            b.assert_zero(cols[OFF_IR2 + 2 * i] - (IV[i] & 0xFFFF))
            b.assert_zero(cols[OFF_IR2 + 2 * i + 1] - (IV[i] >> 16))

        # packed m-vector expressions
        m = []
        for i in range(16):
            w = bits(OFF_INPUTS + 32 * i)
            m.append([_pack16(w[:16]), _pack16(w[16:])])

        init = SimpleNamespace(
            row0=lambda i: cols[OFF_IR0 + 2 * i:OFF_IR0 + 2 * i + 2],
            row1=lambda i: bits(OFF_CHAIN + 32 * (4 + i)),
            row2=lambda i: cols[OFF_IR2 + 2 * i:OFF_IR2 + 2 * i + 2],
            row3=lambda i: bits(
                (OFF_CTR_LO, OFF_CTR_HI, OFF_BLEN, OFF_FLAGS)[i]),
        )

        state = init
        lanes = []  # 56 quarter-round role tuples
        for r in range(7):
            prime = _StateView(cols, _state_off(r, 0))
            middle = _StateView(cols, _state_off(r, 1))
            mprime = _StateView(cols, _state_off(r, 2))
            out = _StateView(cols, _state_off(r, 3))
            # columns (air.rs:189-206)
            for i in range(4):
                lanes.append((
                    state.row0(i), state.row1(i), state.row2(i),
                    state.row3(i), m[2 * i],
                    prime.row0(i), prime.row1(i), prime.row2(i),
                    prime.row3(i), m[2 * i + 1],
                    middle.row0(i), middle.row1(i), middle.row2(i),
                    middle.row3(i),
                ))
            # diagonals (air.rs:208-227)
            for i in range(4):
                lanes.append((
                    middle.row0(i), middle.row1((i + 1) % 4),
                    middle.row2((i + 2) % 4), middle.row3((i + 3) % 4),
                    m[2 * i + 8],
                    mprime.row0(i), mprime.row1((i + 1) % 4),
                    mprime.row2((i + 2) % 4), mprime.row3((i + 3) % 4),
                    m[2 * i + 9],
                    out.row0(i), out.row1((i + 1) % 4),
                    out.row2((i + 2) % 4), out.row3((i + 3) % 4),
                ))
            state = out
            m = [m[MSG_PERMUTATION[i]] for i in range(16)]

        # Stack all 56 quarter rounds into one lane axis: every helper
        # emission below becomes a single batched block over 56 lanes.
        n_lanes = len(lanes)
        stacked = []
        for role in range(14):
            k = len(lanes[0][role])
            stacked.append([
                stack_syms([lane[role][j] for lane in lanes])
                for j in range(k)
            ])
        self._quarter(b, tuple(stacked), lanes=n_lanes)

        # final xors (air.rs:378-456)
        final = _StateView(cols, _state_off(6, 3))
        for i in range(4):
            frh = bits(OFF_FRH + 32 * i)
            b.assert_zero(final.row2(i)[0] - _pack16(frh[:16]))
            b.assert_zero(final.row2(i)[1] - _pack16(frh[16:]))
        for i in range(4):
            self._bools(b, bits(OFF_OUT + 32 * i))
        for i in range(4):
            # out0 = row0 ^ frh, via xor_32_shift(row0, out0, frh, 0)
            self._xor32_shift(
                b, final.row0(i), bits(OFF_OUT + 32 * i),
                bits(OFF_FRH + 32 * i), 0,
            )
        for grp, (l_fn, r_fn) in enumerate([
            (final.row1, final.row3),
            (lambda i: bits(OFF_CHAIN + 32 * i),
             lambda i: bits(OFF_FRH + 32 * i)),
            (lambda i: bits(OFF_CHAIN + 32 * (4 + i)), final.row3),
        ], start=1):
            for i in range(4):
                outb = bits(OFF_OUT + 32 * (4 * grp + i))
                lb, rb = l_fn(i), r_fn(i)
                xor = stack_syms([
                    lb[z] + rb[z] - 2 * (lb[z] * rb[z]) - outb[z]
                    for z in range(32)
                ])
                b.assert_zero_block(xor, 32)


# ---------------------------------------------------------------------------
# trace generation (generation.rs), column-major over a block of rows
# ---------------------------------------------------------------------------
_Z = np.arange(32, dtype=np.uint32)[:, None]


def _put_bits(tr, base, words):
    tr[base:base + 32] = (words[None, :] >> _Z) & 1


def _rotr(x, r):
    return (x >> np.uint32(r)) | (x << np.uint32(32 - r))


def _half_round(st, m, i_map, m_idx, flag):
    r1, r2 = (8, 7) if flag else (16, 12)
    i0, i1, i2, i3 = i_map
    a, bb, c, d = st[0][i0], st[1][i1], st[2][i2], st[3][i3]
    a = a + bb + m[m_idx]
    d = _rotr(d ^ a, r1)
    c = c + d
    bb = _rotr(bb ^ c, r2)
    st[0][i0], st[1][i1], st[2][i2], st[3][i3] = a, bb, c, d


def _save_state(tr, base, st):
    for i in range(4):
        tr[base + 2 * i] = st[0][i] & 0xFFFF
        tr[base + 2 * i + 1] = st[0][i] >> 16
        _put_bits(tr, base + 8 + 32 * i, st[1][i])
        tr[base + 136 + 2 * i] = st[2][i] & 0xFFFF
        tr[base + 136 + 2 * i + 1] = st[2][i] >> 16
        _put_bits(tr, base + 144 + 32 * i, st[3][i])


def _trace_columns(inputs: np.ndarray, row0: int, n: int) -> np.ndarray:
    """(9168, B) standard-form uint32 columns of rows row0..row0+B-1 of an
    n-row trace; inputs (B, 24) uint32, 16 block words then 8 chaining
    values. The counter is the row index and block_len is n, flags 0
    (generation.rs:41), so a row depends on n."""
    inputs = inputs.astype(np.uint32)
    rows = inputs.shape[0]
    tr = np.zeros((NUM_BLAKE3_COLS, rows), dtype=np.uint32)
    for i in range(16):
        _put_bits(tr, OFF_INPUTS + 32 * i, inputs[:, i])
    for i in range(8):
        _put_bits(tr, OFF_CHAIN + 32 * i, inputs[:, 16 + i])
    counter = np.arange(row0, row0 + rows, dtype=np.uint64)
    ctr_lo = counter.astype(np.uint32)
    ctr_hi = (counter >> np.uint64(32)).astype(np.uint32)
    blen = np.full(rows, n, dtype=np.uint32)
    _put_bits(tr, OFF_CTR_LO, ctr_lo)
    _put_bits(tr, OFF_CTR_HI, ctr_hi)
    _put_bits(tr, OFF_BLEN, blen)
    # the flags columns stay zero
    for i in range(4):
        tr[OFF_IR0 + 2 * i] = inputs[:, 16 + i] & 0xFFFF
        tr[OFF_IR0 + 2 * i + 1] = inputs[:, 16 + i] >> 16
        tr[OFF_IR2 + 2 * i] = IV[i] & 0xFFFF
        tr[OFF_IR2 + 2 * i + 1] = IV[i] >> 16

    m = [inputs[:, i].copy() for i in range(16)]
    st = [
        [inputs[:, 16 + i].copy() for i in range(4)],
        [inputs[:, 20 + i].copy() for i in range(4)],
        [np.full(rows, IV[i], dtype=np.uint32) for i in range(4)],
        [ctr_lo, ctr_hi, blen, np.zeros(rows, dtype=np.uint32)],
    ]
    with np.errstate(over="ignore"):
        for r in range(7):
            for i in range(4):
                _half_round(st, m, (i, i, i, i), 2 * i, False)
            _save_state(tr, _state_off(r, 0), st)
            for i in range(4):
                _half_round(st, m, (i, i, i, i), 2 * i + 1, True)
            _save_state(tr, _state_off(r, 1), st)
            diag = [(i, (i + 1) % 4, (i + 2) % 4, (i + 3) % 4)
                    for i in range(4)]
            for i in range(4):
                _half_round(st, m, diag[i], 8 + 2 * i, False)
            _save_state(tr, _state_off(r, 2), st)
            for i in range(4):
                _half_round(st, m, diag[i], 9 + 2 * i, True)
            _save_state(tr, _state_off(r, 3), st)
            m = [m[MSG_PERMUTATION[i]] for i in range(16)]

    for i in range(4):
        _put_bits(tr, OFF_FRH + 32 * i, st[2][i])
    for i in range(4):
        _put_bits(tr, OFF_OUT + 32 * i, st[0][i] ^ st[2][i])
        _put_bits(tr, OFF_OUT + 32 * (4 + i), st[1][i] ^ st[3][i])
        _put_bits(tr, OFF_OUT + 32 * (8 + i), st[2][i] ^ inputs[:, 16 + i])
        _put_bits(tr, OFF_OUT + 32 * (12 + i), st[3][i] ^ inputs[:, 20 + i])
    return tr


def blake3_trace_rows(inputs: np.ndarray) -> np.ndarray:
    """inputs (n, 24) uint32: the (n, 9168) standard-form uint32 trace,
    one compression a row (the reference's `generate_blake3_trace`)."""
    n = inputs.shape[0]
    if n & (n - 1) or n == 0:
        raise ValueError(f"{n} rows is not a power of two")
    return np.ascontiguousarray(_trace_columns(inputs, 0, n).T)


# rows a trace block holds on the host: (9168, 8192) uint32 is 300 MB
TRACE_BLOCK_ROWS = 1 << 13


def generate_blake3_trace(F, inputs: np.ndarray, device=None,
                          block_rows: int = TRACE_BLOCK_ROWS):
    """The (n, 9168) trace of `blake3_trace_rows` as an int64 Montgomery
    tensor on `device` (default cuda), built and moved `block_rows` rows
    at a time: the host holds one block's columns, never the whole
    trace. Every entry is a bit or a 16-bit limb, so the words cross to
    the device as int32 and are transposed there."""
    n = inputs.shape[0]
    if n & (n - 1) or n == 0:
        raise ValueError(f"{n} rows is not a power of two")
    dev = default_device(device)
    out = torch.empty((n, NUM_BLAKE3_COLS), dtype=torch.int64, device=dev)
    for a in range(0, n, block_rows):
        cols = _trace_columns(inputs[a:a + block_rows], a, n)
        words = torch.from_numpy(cols.view(np.int32)).to(dev)
        out[a:a + cols.shape[1]] = F.to_monty_tensor(
            words.t().to(torch.int64))
    return out
