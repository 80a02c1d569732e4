"""The BN254 scalar field on the host, in exact ints.

Port of `plonky3_tpu/fields/bn254.py` (the reference's `bn254` crate,
bn254/src/bn254.rs:29,58): arithmetic mod the 254-bit prime in Python
ints, and the reference's Montgomery wire form (R = 2^256). It serves the
Groth16-wrapper digest configuration (`challenger/multi_field.py`), which
is digest-sized host work.
"""

from __future__ import annotations

from dataclasses import dataclass

# bn254/src/bn254.rs:29 (little-endian u64 limbs)
_P = int.from_bytes(
    b"".join(
        x.to_bytes(8, "little")
        for x in (
            0x43E1F593F0000001,
            0x2833E84879B97091,
            0xB85045B68181585D,
            0x30644E72E131A029,
        )
    ),
    "little",
)
_R = (1 << 256) % _P


@dataclass(frozen=True)
class BN254Field:
    name: str = "BN254"
    P: int = _P
    TWO_ADICITY: int = 28  # ord_2(P - 1)
    GENERATOR: int = 5

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

    def to_monty_h(self, x):
        """Wire form: x·R mod P (monty_31.rs-style serialization)."""
        return (x * _R) % _P

    def from_monty_h(self, x):
        return (x * pow(_R, _P - 2, _P)) % _P

    def two_adic_generator_h(self, bits):
        if bits > self.TWO_ADICITY:
            raise ValueError(f"bits {bits} > two-adicity {self.TWO_ADICITY}")
        g = pow(self.GENERATOR, (_P - 1) >> self.TWO_ADICITY, _P)
        return pow(g, 1 << (self.TWO_ADICITY - bits), _P)


BN254 = BN254Field()
