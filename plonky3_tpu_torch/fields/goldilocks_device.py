"""Goldilocks arithmetic on int64 tensors, and the plain Poseidon2-GL.

Port of `plonky3_tpu/fields/goldilocks_device.py`. The reference keeps an
element as a (lo, hi) pair of uint32 arrays; here one int64 element holds
the element's 64 bits (two's complement: values of 2^63 and above read
negative), and every op returns the canonical value in [0, P), as the
reference's do (see `gl/field.py` for the word rule). So the bits agree
with the reference's wherever its inputs are canonical.

  add   the wrapping sum; a carry out of 2^64 adds 2^32 - 1
        (2^64 = 2^32 - 1 mod P, goldilocks.rs:102); one conditional
        subtraction of P
  sub   the wrapping difference; a borrow subtracts 2^32 - 1
  mul   the 128-bit product from four 32 x 32 partial products (each
        exact as a wrapping int64 product), as 32-bit words w0..w3;
        then w0 + w1·2^32 + w2·(2^32 - 1) - w3 mod P (2^96 = -1)

Unsigned compares flip the sign bit. `sum_mod` reduces a sum along an
axis exactly by summing the 32-bit halves apart (fewer than 2^31 terms).

The batched Poseidon2-Goldilocks width-8 permutation (x^7 S-box, 4 + 4
full rounds and 22 partial rounds; hashes/poseidon2_goldilocks.py) and
the leaf sponge and 2-to-1 compression over it are the plain versions of
the kernels in `csrc/goldilocks.cu` (`hashes/poseidon2_goldilocks_cuda.py`
launches them); the CPU path and the tests run these.
"""

from __future__ import annotations

import torch

from ..hashes.constants.poseidon2_goldilocks_constants import (
    MATRIX_DIAG_8,
    RC8_EXTERNAL_FINAL,
    RC8_EXTERNAL_INITIAL,
    RC8_INTERNAL,
)
from .goldilocks import Goldilocks

P = Goldilocks.P
WIDTH = 8
RATE = 4
OUT = 4
_M32 = 0xFFFFFFFF
_EPS = 0xFFFFFFFF  # 2^64 mod P
_SIGN = -(1 << 63)


def to_i64(x: int) -> int:
    """A u64 value as the int64 that holds its bits."""
    x = int(x)
    return x - (1 << 64) if x >= 1 << 63 else x


def from_i64(x: int) -> int:
    """The u64 value held in an int64."""
    return int(x) & ((1 << 64) - 1)


_P_I64 = to_i64(P)


def _ult(a, b):
    """a < b as unsigned 64-bit values."""
    return (a ^ _SIGN) < (b ^ _SIGN)


def _canon(x):
    """x mod P for any u64 x (one subtraction of P)."""
    return torch.where(_ult(x, _P_I64), x, x - _P_I64)


def const(x: int, device=None):
    """A 0-dim int64 tensor of the canonical value of x."""
    return torch.tensor(to_i64(int(x) % P), dtype=torch.int64, device=device)


def add(a, b):
    s = a + b
    s = torch.where(_ult(s, a), s + _EPS, s)
    return _canon(s)


def sub(a, b):
    d = a - b
    return torch.where(_ult(a, b), d - _EPS, d)


def neg(a):
    return torch.where(a == 0, a, _P_I64 - a)


def double(a):
    return add(a, a)


def _hi(x):
    return (x >> 32) & _M32


def reduce128(w0, w1, w2, w3):
    """w0 + w1·2^32 + w2·2^64 + w3·2^96 mod P for 32-bit words (int64
    tensors in [0, 2^32)): w0 + w1·2^32 + w2·(2^32 - 1) - w3."""
    lo = (w1 << 32) | w0
    r = lo + w2 * _EPS  # w2·(2^32 - 1) < 2^64
    r = torch.where(_ult(r, lo), r + _EPS, r)
    d = r - w3
    d = torch.where(_ult(r, w3), d - _EPS, d)
    return _canon(d)


def mul(a, b):
    a0, a1 = a & _M32, _hi(a)
    b0, b1 = b & _M32, _hi(b)
    ll, lh, hl, hh = a0 * b0, a0 * b1, a1 * b0, a1 * b1
    t1 = _hi(ll) + (lh & _M32) + (hl & _M32)
    t2 = (t1 >> 32) + _hi(lh) + _hi(hl) + (hh & _M32)
    return reduce128(ll & _M32, t1 & _M32, t2 & _M32,
                     (t2 >> 32) + _hi(hh))


def square(a):
    return mul(a, a)


def sum_mod(x, dim: int):
    """The sum of x along `dim` mod P, exact (fewer than 2^31 terms): the
    low and high 32-bit halves summed apart, then combined."""
    return _combine((x & _M32).sum(dim=dim), _hi(x).sum(dim=dim))


def pow_const(a, e: int):
    """a^e by square and multiply, e a Python int >= 1."""
    acc, base = None, a
    while e:
        if e & 1:
            acc = base if acc is None else mul(acc, base)
        e >>= 1
        if e:
            base = square(base)
    return acc


def inv(a):
    """a^(P-2): the inverse of a nonzero element."""
    return pow_const(a, P - 2)


# ---------------------------------------------------------------------------
# the plain batched Poseidon2-Goldilocks width-8 permutation
# ---------------------------------------------------------------------------
_TABLES = {}


def _tables(device):
    """(initial (4, 8), internal (22,), final (4, 8), diag (8,)) int64
    round constants on `device`, made once."""
    hit = _TABLES.get(device)
    if hit is None:
        def t(v):
            return torch.tensor([[to_i64(x) for x in r] for r in v]
                                if isinstance(v[0], (list, tuple)) else
                                [to_i64(x) for x in v], dtype=torch.int64,
                                device=device)

        hit = _TABLES[device] = (t(RC8_EXTERNAL_INITIAL), t(RC8_INTERNAL),
                                 t(RC8_EXTERNAL_FINAL), t(MATRIX_DIAG_8))
    return hit


def _sbox7(x):
    """x^7 = x4·x3 in three product calls: x2, then x3 and x4 in one."""
    x2 = square(x)
    x34 = mul(torch.stack([x2, x2]), torch.stack([x, x2]))
    return mul(x34[0], x34[1])


def _mds_matrix():
    """The width-8 external light layer as its 8 x 8 matrix of small
    coefficients (poseidon2/src/external.rs:96-170: [[2·M4, M4], [M4,
    2·M4]] with M4 = MDSMat4), transposed: m[j, i] multiplies lane j into
    lane i."""
    m4 = [[2, 3, 1, 1], [1, 2, 3, 1], [1, 1, 2, 3], [3, 1, 1, 2]]
    m = [[(2 if (i < 4) == (j < 4) else 1) * m4[i % 4][j % 4]
          for i in range(WIDTH)] for j in range(WIDTH)]
    return m


_MDS_T = _mds_matrix()
_MDS = {}


def _mds_light(s):
    """The external layer on (..., 8): the 32-bit halves of the lanes
    times the matrix's coefficients (a row sums to 21, so each sum is
    below 2^37), then L + H·2^32 reduced once (`_combine`). The same
    field values as the reference's add schedule."""
    m = _MDS.get(s.device)
    if m is None:
        m = _MDS[s.device] = torch.tensor(_MDS_T, dtype=torch.int64,
                                          device=s.device)
    halves = torch.stack([s & _M32, _hi(s)])
    t = (halves[..., :, None] * m).sum(dim=-2)
    return _combine(t[0], t[1])


def _combine(sl, sh):
    """SL + SH·2^32 mod P for 0 <= SL, SH < 2^62: with SH + (SL >> 32) =
    h1·2^32 + h0, it is (SL mod 2^32) + h0·2^32 + h1·(2^32 - 1)."""
    sh = sh + (sl >> 32)
    lo = _canon(((sh & _M32) << 32) | (sl & _M32))
    return add(lo, (sh >> 32) * _EPS)


def poseidon2_goldilocks_plain(states):
    """The permutation of every row of an (..., 8) int64 tensor of
    canonical values; the plain version of `gl_permute_kernel`."""
    rc_i, rc_p, rc_f, diag = _tables(states.device)
    s = _mds_light(states)
    for r in range(rc_i.shape[0]):
        s = _mds_light(_sbox7(add(s, rc_i[r])))
    for r in range(rc_p.shape[0]):
        lane0 = _sbox7(add(s[..., :1], rc_p[r]))
        s = torch.cat([lane0, s[..., 1:]], dim=-1)
        s = add(sum_mod(s, -1)[..., None], mul(diag, s))
    for r in range(rc_f.shape[0]):
        s = _mds_light(_sbox7(add(s, rc_f[r])))
    return s


def gl_sponge_rows_plain(mat):
    """PaddingFreeSponge (rate 4, out 4) over each row of an (h, w) int64
    tensor: every rate-4 block overwrites the state's first lanes (the
    last block its first w mod 4 only) and permutes. Returns (h, 4); the
    plain version of `gl_sponge_rows_kernel`."""
    h, w = mat.shape
    s = torch.zeros((h, WIDTH), dtype=torch.int64, device=mat.device)
    for c in range(0, w, RATE):
        blk = mat[:, c:c + RATE]
        s = poseidon2_goldilocks_plain(
            torch.cat([blk, s[:, blk.shape[1]:]], dim=1))
    return s[:, :OUT].contiguous()


def gl_compress_plain(left, right):
    """The 2-to-1 truncated permutation of (n, 4) digest pairs: the first
    4 lanes of the permuted [left | right]; the plain version of
    `gl_compress_kernel`."""
    return poseidon2_goldilocks_plain(
        torch.cat([left, right], dim=1))[:, :OUT].contiguous()
