"""Additional extension towers: a generic host binomial extension and the
quintic trinomial (field/src/extension/mod.rs:28-60 inventory).

Port of `plonky3_tpu/fields/more_extensions.py` (host Python ints only;
no prover path calls these).

* `HostBinomialExt` — X^D - W over any field exposing host scalar ops;
  instantiates the Mersenne31 cubic X^3 - 5
  (`mersenne-31/src/extension.rs:21-39`).
* `KoalaBearQuintic` — F[X]/(X^5 + X^2 - 1)
  (`field/src/extension/quintic_extension.rs:540` trinomial_quintic_mul
  reduction rules; Frobenius coefficient table from
  `koala-bear/src/koala_bear.rs:128` TrinomialQuinticData).
"""

from __future__ import annotations

from dataclasses import dataclass

from .mersenne31 import Mersenne31
from .params import KoalaBear


@dataclass(frozen=True)
class HostBinomialExt:
    """X^D - W binomial extension, host-exact tuple ops."""

    base: object
    D: int
    W: int
    name: str = "ext"

    @property
    def P(self):
        return self.base.P

    def zero_h(self):
        return (0,) * self.D

    def one_h(self):
        return (1,) + (0,) * (self.D - 1)

    def from_base_h(self, x):
        return (int(x) % self.base.P,) + (0,) * (self.D - 1)

    def add_h(self, a, b):
        p = self.base.P
        return tuple((x + y) % p for x, y in zip(a, b))

    def sub_h(self, a, b):
        p = self.base.P
        return tuple((x - y) % p for x, y in zip(a, b))

    def neg_h(self, a):
        p = self.base.P
        return tuple((-x) % p for x in a)

    def base_mul_h(self, s, a):
        p = self.base.P
        return tuple(s * x % p for x in a)

    def mul_h(self, a, b):
        p, D, W = self.base.P, self.D, self.W
        out = [0] * D
        for i in range(D):
            for j in range(D):
                k = i + j
                c = a[i] * b[j] % p
                if k >= D:
                    out[k - D] = (out[k - D] + c * W) % p
                else:
                    out[k] = (out[k] + c) % p
        return tuple(out)

    def exp_h(self, a, e):
        acc = self.one_h()
        for bit in bin(int(e))[2:]:
            acc = self.mul_h(acc, acc)
            if bit == "1":
                acc = self.mul_h(acc, a)
        return acc

    def inv_h(self, a):
        return self.exp_h(a, self.base.P ** self.D - 2)


# Mersenne31 cubic: X^3 - 5, EXT_GENERATOR = [10, 1, 0]
Mersenne31Cubic = HostBinomialExt(
    base=Mersenne31, D=3, W=5, name="M31^3"
)
M31_CUBIC_EXT_GENERATOR = (10, 1, 0)


# KoalaBear quintic trinomial F[X]/(X^5 + X^2 - 1)
_KB_FROBENIUS_COEFFS = (
    (1576402667, 1173144480, 1567662457, 1206866823, 2428146),
    (1680345488, 1381986, 615237464, 1380104858, 295431824),
    (441230756, 323126830, 704986542, 1445620072, 503505220),
    (1364444097, 1144738982, 2008416047, 143367062, 1027410849),
)
KB_QUINTIC_EXT_GENERATOR = (2, 1, 0, 0, 0)


@dataclass(frozen=True)
class QuinticTrinomialExt:
    """F[X]/(X^5 + X^2 - 1): X^5 = 1 - X^2 (quintic_extension.rs:540)."""

    base: object
    frobenius_coeffs: tuple
    D: int = 5

    @property
    def P(self):
        return self.base.P

    def zero_h(self):
        return (0,) * 5

    def one_h(self):
        return (1, 0, 0, 0, 0)

    def from_base_h(self, x):
        return (int(x) % self.base.P, 0, 0, 0, 0)

    def add_h(self, a, b):
        p = self.base.P
        return tuple((x + y) % p for x, y in zip(a, b))

    def sub_h(self, a, b):
        p = self.base.P
        return tuple((x - y) % p for x, y in zip(a, b))

    def neg_h(self, a):
        p = self.base.P
        return tuple((-x) % p for x in a)

    def base_mul_h(self, s, a):
        p = self.base.P
        return tuple(s * x % p for x in a)

    def mul_h(self, a, b):
        """Convolution + reduction X^5 = 1 - X^2 (so X^6 = X - X^3,
        X^7 = X^2 - X^4, X^8 = X^3 + X^2 - 1)."""
        p = self.base.P
        c = [0] * 9
        for i in range(5):
            for j in range(5):
                c[i + j] = (c[i + j] + a[i] * b[j]) % p
        c5m8 = (c[5] - c[8]) % p
        return (
            (c[0] + c5m8) % p,
            (c[1] + c[6]) % p,
            (c[2] - c5m8 + c[7]) % p,
            (c[3] - c[6] + c[8]) % p,
            (c[4] - c[7]) % p,
        )

    def exp_h(self, a, e):
        acc = self.one_h()
        for bit in bin(int(e))[2:]:
            acc = self.mul_h(acc, acc)
            if bit == "1":
                acc = self.mul_h(acc, a)
        return acc

    def frobenius_h(self, a):
        """φ(a) = a_0 + Σ_k a_k·X^{kp}, X^{kp} = coeffs[k-1]
        (quintic_extension.rs:73-86)."""
        p = self.base.P
        fc = self.frobenius_coeffs
        out = [a[0], 0, 0, 0, 0]
        for k in range(1, 5):
            for j in range(5):
                out[j] = (out[j] + a[k] * fc[k - 1][j]) % p
        return tuple(out)

    def inv_h(self, a):
        """a^{-1} = Π_{k=1}^{4} φ^k(a) / N(a) (norm in the base field)."""
        f1 = self.frobenius_h(a)
        f2 = self.frobenius_h(f1)
        f3 = self.frobenius_h(f2)
        f4 = self.frobenius_h(f3)
        conj = self.mul_h(self.mul_h(f1, f2), self.mul_h(f3, f4))
        norm = self.mul_h(a, conj)
        assert all(x == 0 for x in norm[1:]), "norm must be base-field"
        ninv = pow(norm[0], self.base.P - 2, self.base.P)
        return self.base_mul_h(ninv, conj)


KoalaBearQuintic = QuinticTrinomialExt(
    base=KoalaBear, frobenius_coeffs=_KB_FROBENIUS_COEFFS
)
