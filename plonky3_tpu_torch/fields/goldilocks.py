"""The Goldilocks field (P = 2^64 - 2^32 + 1) on the host: exact ints
and numpy uint64 arrays.

Port of `plonky3_tpu/fields/goldilocks.py` (goldilocks/src/goldilocks.rs:
TWO_ADICITY = 32, GENERATOR = 7, the squaring-consistent
TWO_ADIC_GENERATORS chain, :107). Host ops are exact Python ints; the
`*_np` ops take uint64 arrays of canonical values and build the 128-bit
product from four 32-bit partial products, reduced with 2^64 = 2^32 - 1
(mod P) (goldilocks.rs:102). GoldilocksExt2 is X^2 - 7
(goldilocks/src/extension.rs:22-48) over (a0, a1) tuples. The tensor
arithmetic is `fields/goldilocks_device.py`.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

_P = 0xFFFFFFFF00000001


@dataclass(frozen=True)
class GoldilocksField:
    name: str = "Goldilocks"
    P: int = _P
    TWO_ADICITY: int = 32
    GENERATOR: int = 7

    TWO_ADIC_GENERATORS = (
        0x0000000000000001, 0xFFFFFFFF00000000, 0x0001000000000000,
        0xFFFFFFFEFF000001, 0xEFFFFFFF00000001, 0x00003FFFFFFFC000,
        0x0000008000000000, 0xF80007FF08000001, 0xBF79143CE60CA966,
        0x1905D02A5C411F4E, 0x9D8F2AD78BFED972, 0x0653B4801DA1C8CF,
        0xF2C35199959DFCB6, 0x1544EF2335D17997, 0xE0EE099310BBA1E2,
        0xF6B2CFFE2306BAAC, 0x54DF9630BF79450E, 0xABD0A6E8AA3D8A0E,
        0x81281A7B05F9BEAC, 0xFBD41C6B8CAA3302, 0x30BA2ECD5E93E76D,
        0xF502AEF532322654, 0x4B2A18ADE67246B5, 0xEA9D5A1336FBC98B,
        0x86CDCC31C307E171, 0x4BBAF5976ECFEFD8, 0xED41D05B78D6E286,
        0x10D78DD8915A171D, 0x59049500004A4485, 0xDFA8C93BA46D2666,
        0x7E9BD009B86A0845, 0x400A7F755588E659, 0x185629DCDA58878C,
    )

    # ---- host ----
    def add_h(self, a, b):
        return (a + b) % _P

    def sub_h(self, a, b):
        return (a - b) % _P

    def mul_h(self, a, b):
        return (a * b) % _P

    def neg_h(self, a):
        return (-a) % _P

    def inv_h(self, a):
        return pow(a, _P - 2, _P)

    def exp_h(self, a, e):
        return pow(a, e, _P)

    def two_adic_generator_h(self, bits):
        return self.TWO_ADIC_GENERATORS[bits]

    # ---- numpy (lo, hi) u32 limb pairs ----
    @staticmethod
    def split_np(x64: np.ndarray):
        x64 = np.asarray(x64, dtype=np.uint64)
        return (
            (x64 & np.uint64(0xFFFFFFFF)).astype(np.uint32),
            (x64 >> np.uint64(32)).astype(np.uint32),
        )

    @staticmethod
    def join_np(lo, hi):
        return lo.astype(np.uint64) | (hi.astype(np.uint64) << np.uint64(32))

    def add_np(self, a64, b64):
        """Exact add mod P on uint64 arrays (via u128 emulation)."""
        a64 = np.asarray(a64, np.uint64)
        b64 = np.asarray(b64, np.uint64)
        s = a64 + b64  # wraps mod 2^64
        carried = s < a64
        # 2^64 ≡ 2^32 - 1 (NEG_ORDER)
        s = np.where(carried, s + np.uint64(0xFFFFFFFF), s)
        over = s >= np.uint64(_P)
        return np.where(over, s - np.uint64(_P), s)

    def mul_np(self, a64, b64):
        """Exact mul mod P using 32-bit limb partial products."""
        a64 = np.asarray(a64, np.uint64)
        b64 = np.asarray(b64, np.uint64)
        a0 = a64 & np.uint64(0xFFFFFFFF)
        a1 = a64 >> np.uint64(32)
        b0 = b64 & np.uint64(0xFFFFFFFF)
        b1 = b64 >> np.uint64(32)
        ll = a0 * b0
        lh = a0 * b1
        hl = a1 * b0
        hh = a1 * b1
        # n = hh·2^64 + (lh + hl)·2^32 + ll
        mid = lh + (hl & np.uint64(0xFFFFFFFFFFFFFFFF))
        mid_carry = (mid < lh).astype(np.uint64)  # 2^64 overflow of mid
        lo = ll + (mid << np.uint64(32))
        lo_carry = (lo < ll).astype(np.uint64)
        hi = (hh + (mid >> np.uint64(32)) + (mid_carry << np.uint64(32))
              + lo_carry)
        # reduce: hi·2^64 + lo ≡ lo + hi·(2^32 - 1) with
        # hi = hi_hi·2^32 + hi_lo:
        #   hi_lo·(2^32-1)        =  (hi_lo << 32) - hi_lo
        #   hi_hi·2^32·(2^32-1)   =  hi_hi·(2^64 - 2^32) ≡ -hi_hi
        hi_lo = hi & np.uint64(0xFFFFFFFF)
        hi_hi = hi >> np.uint64(32)
        t = self.add_np(lo, (hi_lo << np.uint64(32)))
        t = self.sub_np(t, hi_lo)
        t = self.sub_np(t, hi_hi)
        return t

    def sub_np(self, a64, b64):
        a64 = np.asarray(a64, np.uint64)
        b64 = np.asarray(b64, np.uint64)
        d = a64 - b64
        borrow = a64 < b64
        # -2^64 ≡ -(2^32 - 1)
        d = np.where(borrow, d - np.uint64(0xFFFFFFFF), d)
        return np.where(d >= np.uint64(_P), d - np.uint64(_P), d)

    def rand_np(self, rng, shape):
        return rng.integers(0, _P, size=shape, dtype=np.uint64)


Goldilocks = GoldilocksField()


@dataclass(frozen=True)
class GoldilocksExt2:
    """Binomial degree-2 extension X^2 - 7 (goldilocks/src/extension.rs:
    22-48): W = 7, DTH_ROOT = W^((p-1)/2), EXT_TWO_ADICITY = 33 with the
    vendored order-2^33 generator. Host-exact ops over (a0, a1) tuples."""

    base = None  # set below
    D: int = 2
    W: int = 7
    DTH_ROOT: int = 18446744069414584320
    EXT_GENERATOR = (18081566051660590251, 16121475356294670766)
    EXT_TWO_ADICITY: int = 33

    @property
    def P(self):
        return Goldilocks.P

    def zero_h(self):
        return (0, 0)

    def one_h(self):
        return (1, 0)

    def from_base_h(self, x):
        return (int(x) % Goldilocks.P, 0)

    def add_h(self, a, b):
        p = Goldilocks.P
        return ((a[0] + b[0]) % p, (a[1] + b[1]) % p)

    def sub_h(self, a, b):
        p = Goldilocks.P
        return ((a[0] - b[0]) % p, (a[1] - b[1]) % p)

    def neg_h(self, a):
        p = Goldilocks.P
        return ((-a[0]) % p, (-a[1]) % p)

    def mul_h(self, a, b):
        p = Goldilocks.P
        c0 = (a[0] * b[0] + self.W * a[1] * b[1]) % p
        c1 = (a[0] * b[1] + a[1] * b[0]) % p
        return (c0, c1)

    def base_mul_h(self, s, a):
        p = Goldilocks.P
        return (s * a[0] % p, s * a[1] % p)

    def exp_h(self, a, e):
        acc = self.one_h()
        for bit in bin(int(e))[2:]:
            acc = self.mul_h(acc, acc)
            if bit == "1":
                acc = self.mul_h(acc, a)
        return acc

    def frobenius_h(self, a):
        """a -> a^p: (a0, DTH_ROOT·a1)."""
        return (a[0], self.DTH_ROOT * a[1] % Goldilocks.P)

    def inv_h(self, a):
        """Norm-based inverse: a^-1 = frob(a) / N(a)."""
        p = Goldilocks.P
        conj = self.frobenius_h(a)
        norm = self.mul_h(a, conj)[0]  # base field
        ninv = pow(norm, p - 2, p)
        return self.base_mul_h(ninv, conj)

    def two_adic_generator_h(self, bits):
        assert bits <= self.EXT_TWO_ADICITY
        if bits == 33:
            return (0, 15659105665374529263)
        return (Goldilocks.two_adic_generator_h(bits), 0)


GoldilocksExt2Field = GoldilocksExt2()
