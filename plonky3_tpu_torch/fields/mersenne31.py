"""The Mersenne-31 prime field (P = 2^31 - 1) on int64 tensors.

Port of `plonky3_tpu/fields/mersenne31.py` (mersenne-31/src/
mersenne_31.rs). M31 has no Montgomery form: the canonical value is the
wire form, so `to_monty_*` and `from_monty_*` reduce mod P and change
nothing else. R = RINV = 1 keeps the generic code's Montgomery factor
(`acc % P * RINV % P`) exact. A product of two canonical values is below
2^62 and exact in int64.

M31 is not two-adic (TWO_ADICITY = 0): its FFT domain is the circle group
(`ops/circle.py`). CIRCLE_TWO_ADIC_GENERATORS is copied from the
reference (complex.rs:16), and M31Ext3 is the cubic binomial extension
X^3 - 5 (mersenne-31/src/extension.rs:21-38), the circle fixtures'
challenge field.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .extension import BinomialExtension
from .monty31 import Field31

_P = (1 << 31) - 1
_U32 = np.uint32


@dataclass(frozen=True)
class Mersenne31Field(Field31):
    """Tensor ops take and return canonical int64 tensors in [0, P); a
    Python int operand is a canonical constant."""

    name: str = "Mersenne31"
    P: int = _P
    TWO_ADICITY: int = 0
    GENERATOR: int = 7
    R: int = 1  # the Montgomery factor of the generic code: none
    RINV: int = 1

    def two_adic_generator_h(self, bits: int) -> int:
        if bits > 0:
            raise ValueError(f"bits {bits} > two-adicity 0: Mersenne31 "
                             f"has no two-adic subgroup (use the circle "
                             f"group)")
        return 1

    def to_monty_h(self, x: int) -> int:
        return x % _P

    from_monty_h = to_monty_h

    def to_monty_np(self, x: np.ndarray) -> np.ndarray:
        return (np.asarray(x).astype(np.uint64) % np.uint64(_P)).astype(_U32)

    from_monty_np = to_monty_np

    def to_monty_tensor(self, x):
        return x % _P

    from_monty_tensor = to_monty_tensor

    def rand_np(self, rng: np.random.Generator, shape, monty: bool = True):
        """Uniform field elements as uint32 (the reference's draws)."""
        return rng.integers(0, _P, size=shape, dtype=np.uint32)

    def const(self, std_value: int) -> int:
        return std_value % _P

    def mul(self, a, b):
        return a * b % _P

    def neg(self, a):
        return self.sub(0, a)


Mersenne31 = Mersenne31Field()

# Generators of the order-2^i subgroups of the unit circle x^2 + y^2 = 1
# over M31 (complex.rs:16, normative for the circle FFT domain).
CIRCLE_TWO_ADIC_GENERATORS = (
    (1, 0),
    (2147483646, 0),
    (0, 2147483646),
    (32768, 2147450879),
    (590768354, 978592373),
    (1179735656, 1241207368),
    (1567857810, 456695729),
    (1774253895, 1309288441),
    (736262640, 1553669210),
    (1819216575, 1662816114),
    (1323191254, 1936974060),
    (605622498, 1964232216),
    (343674985, 501786993),
    (1995316534, 149306621),
    (2107600913, 1378821388),
    (541476169, 2101081972),
    (2135874973, 483411332),
    (2097144245, 1684033590),
    (1662322247, 670236780),
    (1172215635, 595888646),
    (241940101, 323856519),
    (1957194259, 2139647100),
    (1957419629, 1541039442),
    (1062045235, 1824580421),
    (1929382196, 1664698822),
    (1889294251, 331248939),
    (1214231414, 1646302518),
    (1765392370, 461136547),
    (1629751483, 66485474),
    (1501355827, 1439063420),
    (509778402, 800467507),
    (311014874, 1584694829),
)

# F[X]/(X^3 - 5): W = 5, DTH_ROOT = 1513477735, EXT_GENERATOR = [10, 1, 0]
M31Ext3 = BinomialExtension(base=Mersenne31, D=3, W=5, DTH_ROOT=1513477735,
                            EXT_GENERATOR=(10, 1, 0), EXT_TWO_ADICITY=1)
