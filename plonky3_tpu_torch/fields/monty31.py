"""31-bit Montgomery prime fields on int64 tensors.

Port of `plonky3_tpu/fields/monty31.py`. Elements live on the device in
Montgomery form (value·2^32 mod P) as canonical int64 values in [0, P).
The reference builds the 64-bit product from 16-bit limbs because the TPU
has no widening multiply; here the product of two canonical values fits in
int64, so `mul` is the exact formula a·b·R^-1 mod P. It returns the same
canonical value as the reference's REDC.

Host scalar math (`*_h`) uses Python ints in standard form; the `*_np`
helpers convert numpy arrays, the `*_tensor` ones int64 tensors, between
standard and Montgomery form. `Field31` holds the ops that read only P,
R (the Montgomery factor, 1 for a field without that form) and `mul`:
Mersenne-31 shares them.
"""

from __future__ import annotations

from dataclasses import dataclass, field as dc_field

import numpy as np
import torch

_U32 = np.uint32


class Field31:
    """The ops of a 31-bit prime field on canonical int64 tensors that read
    only `P`, `R` (the form's one) and `mul`; a subclass defines those."""

    # ---- host scalar math (standard-form Python ints) -----------------
    def sub_h(self, a: int, b: int) -> int:
        return (a - b) % self.P

    def mul_h(self, a: int, b: int) -> int:
        return (a * b) % self.P

    def inv_h(self, a: int) -> int:
        if a % self.P == 0:
            raise ZeroDivisionError("field inverse of zero")
        return pow(a, self.P - 2, self.P)

    def exp_h(self, a: int, e: int) -> int:
        return pow(a, e, self.P)

    # ---- tensor math ----------------------------------------------------
    def add(self, a, b):
        s = a + b
        return torch.where(s >= self.P, s - self.P, s)

    def sub(self, a, b):
        d = a - b
        return torch.where(d < 0, d + self.P, d)

    def square(self, a):
        return self.mul(a, a)

    def double(self, a):
        return self.add(a, a)

    def halve(self, a):
        """a/2: (a + P)/2 when a is odd."""
        return torch.where((a & 1) == 1, (a >> 1) + (self.P + 1) // 2,
                           a >> 1)

    def exp(self, a, e: int):
        """a^e for a Python-int exponent (square-and-multiply)."""
        e %= self.P - 1
        acc = torch.full_like(a, self.R)
        base = a
        while e:
            if e & 1:
                acc = self.mul(acc, base)
            e >>= 1
            if e:
                base = self.square(base)
        return acc

    def inv(self, a):
        """Elementwise inverse by Fermat; 0 maps to 0."""
        return self.exp(a, self.P - 2)

    def batch_inv(self, a):
        """Elementwise inverse by the Montgomery trick: two log-depth
        scans and one Fermat inverse; 0 maps to 0."""
        from .batch_inv import batch_inv

        return batch_inv(self, a)

    def batch_inv_np(self, a: np.ndarray) -> np.ndarray:
        from .batch_inv import batch_inv_np

        return batch_inv_np(self, a)

    def try_sqrt_h(self, a: int):
        """Tonelli–Shanks: r with r² = a, or None."""
        from .batch_inv import try_sqrt_h

        return try_sqrt_h(self, a)

    def sum(self, x, dim=0):
        """Exact modular sum along `dim` (fewer than 2^32 terms)."""
        return x.sum(dim=dim) % self.P


@dataclass(frozen=True)
class Monty31(Field31):
    """A concrete 31-bit Montgomery field (KoalaBear, BabyBear).

    Tensor ops take and return int64 tensors in Montgomery form, canonical
    range [0, P); a Python int operand is a Montgomery-form constant."""

    name: str
    P: int
    MU: int  # P^-1 mod 2^32
    TWO_ADICITY: int
    GENERATOR: int  # multiplicative generator, standard form
    TWO_ADIC_GENERATORS: tuple = ()  # [i] = 2^i-th root of unity, standard

    R: int = dc_field(init=False)  # 2^32 mod P
    RINV: int = dc_field(init=False)  # 2^-32 mod P

    def __post_init__(self):
        if (self.P * self.MU) & 0xFFFFFFFF != 1:
            raise ValueError("MU must be P^-1 mod 2^32")
        r = (1 << 32) % self.P
        object.__setattr__(self, "R", r)
        object.__setattr__(self, "RINV", pow(r, self.P - 2, self.P))

    def two_adic_generator_h(self, bits: int) -> int:
        if bits > self.TWO_ADICITY:
            raise ValueError(f"bits {bits} > two-adicity {self.TWO_ADICITY}")
        return self.TWO_ADIC_GENERATORS[bits]

    def to_monty_h(self, x: int) -> int:
        return (x << 32) % self.P

    def from_monty_h(self, x: int) -> int:
        return (x * self.RINV) % self.P

    # ---- host array conversions (numpy) --------------------------------
    def to_monty_np(self, x: np.ndarray) -> np.ndarray:
        """Standard-form array -> Montgomery-form uint32."""
        return ((np.asarray(x).astype(np.uint64) << np.uint64(32))
                % np.uint64(self.P)).astype(_U32)

    def from_monty_np(self, x: np.ndarray) -> np.ndarray:
        return ((np.asarray(x).astype(np.uint64) * np.uint64(self.RINV))
                % np.uint64(self.P)).astype(_U32)

    # ---- tensor conversions (int64, canonical) -------------------------
    def to_monty_tensor(self, x):
        """Standard-form int64 tensor in [0, 2^31) -> Montgomery form."""
        return (x << 32) % self.P

    def from_monty_tensor(self, x):
        """Montgomery-form int64 tensor in [0, P) -> standard form."""
        return x * self.RINV % self.P

    def shoup_np(self, w_std: np.ndarray) -> np.ndarray:
        """Shoup precomputation floor(w·2^32/P) for standard-form w."""
        return ((np.asarray(w_std).astype(np.uint64) << np.uint64(32))
                // np.uint64(self.P)).astype(_U32)

    def rand_np(self, rng: np.random.Generator, shape, monty: bool = True):
        """Uniform field elements as uint32 (same draws as the reference)."""
        x = rng.integers(0, self.P, size=shape, dtype=np.uint64)
        if monty:
            return ((x << np.uint64(32)) % np.uint64(self.P)).astype(_U32)
        return x.astype(_U32)

    # ---- tensor math (int64, Montgomery form) --------------------------
    def const(self, std_value: int) -> int:
        """Montgomery form of a standard-form constant, as a Python int."""
        return self.to_monty_h(std_value % self.P)

    def mul(self, a, b):
        """Montgomery product a·b·2^-32 mod P, canonical."""
        return (a * b) % self.P * self.RINV % self.P
