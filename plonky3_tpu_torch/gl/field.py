"""Goldilocks field adapters: the word rule of the Goldilocks stack.

Port of `plonky3_tpu/gl/field.py`.

Word representation. One Goldilocks element is one int64 tensor element
holding the element's 64 bits, canonical (< P = 2^64 - 2^32 + 1); an
element of 2^63 or more reads negative as int64. Torch has no unsigned
64-bit add, shift or compare on the CPU, so:
  * sums and differences wrap (two's complement) and a carry or borrow
    out of 2^64 is found by an unsigned compare;
  * unsigned compares flip the sign bit (`(a ^ 2^63) < (b ^ 2^63)`);
  * products split each operand into 32-bit halves (`x & 0xFFFFFFFF`,
    `(x >> 32) & 0xFFFFFFFF`); the product of two halves wraps in int64
    and its bits are the exact u64 product (fields/goldilocks_device.py).
The reference keeps an element as a (lo, hi) pair of u32 arrays and
commits and proves the interleaved u32 form [lo0, hi0, lo1, hi1, ...]:
that is `x.view(torch.int32)` of an (n, w) int64 tensor (little-endian,
no copy), on the CPU and on the card alike (`wire32`). Host values are
Python ints or numpy uint64 arrays; `to_numpy` and `to_tensor` convert
without copying a bit.

An extension element of GL[X]/(X^2 - 7) (goldilocks/src/extension.rs:
22-48) is a (..., 2) tensor of its coordinates. `GLF` and `GLE` give the
base field and the extension what the port's shared protocol code asks
of a field (the host ops `*_h` of the transcript, the domains and the
verifiers; `to_monty_np`/`from_monty_np`, the MMCS's wire conversions:
Goldilocks has no Montgomery form here, and the wire values are the
canonical u64 ints; the tensor ops of the FRI prover's roll-in).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..fields import goldilocks_device as gd
from ..fields.goldilocks import Goldilocks, GoldilocksExt2Field

_P = Goldilocks.P
_W = 7  # X^2 - 7
_INV2_HALF = (_P + 1) // 2  # (a + P) / 2 for odd a: (a - 1) / 2 + this


# ---------------------------------------------------------------------------
# host <-> tensor, and the reference's interleaved u32 wire
# ---------------------------------------------------------------------------
def to_numpy(t) -> np.ndarray:
    """An int64 tensor -> the uint64 numpy array of its elements."""
    return t.detach().cpu().numpy().view(np.uint64)


def to_tensor(x64, device=None):
    """uint64 values (any integer array or list) -> an int64 tensor."""
    a = np.ascontiguousarray(np.asarray(x64, dtype=np.uint64))
    return torch.from_numpy(a.view(np.int64)).to(device)


def wire32(t):
    """(..., w) int64 -> (..., 2w) int32: the reference's interleaved
    (lo, hi) u32 wire form, a view."""
    return t.contiguous().view(torch.int32)


def split_host(x64):
    """u64 host array -> interleaved u32 array (trailing axis doubled)."""
    x64 = np.ascontiguousarray(np.asarray(x64, np.uint64))
    return x64.view(np.uint32).reshape(x64.shape[:-1] + (-1,))


def join_host(x32):
    """Interleaved u32 array -> u64 host array (trailing axis halved)."""
    x32 = np.ascontiguousarray(np.asarray(x32, np.uint32))
    return x32.view(np.uint64).reshape(x32.shape[:-1] + (-1,))


def _u64(arr):
    a = np.asarray(arr)
    return a.view(np.uint64) if a.dtype == np.int64 else a.astype(np.uint64)


# ---------------------------------------------------------------------------
# tensor ops beyond goldilocks_device
# ---------------------------------------------------------------------------
def halve(a):
    """a / 2: a >> 1, plus (P + 1) / 2 where a is odd."""
    h = (a >> 1) & 0x7FFFFFFFFFFFFFFF
    return torch.where((a & 1) == 1, gd.add(h, gd.to_i64(_INV2_HALF)), h)


def mul7(a):
    """7·a by an add chain."""
    t = gd.add(gd.double(a), a)
    return gd.add(gd.double(t), a)


def ext_mul(a, b):
    """(a0 + a1·X)(b0 + b1·X) mod X^2 - 7 on (..., 2) tensors."""
    a0, a1 = a[..., 0], a[..., 1]
    b0, b1 = b[..., 0], b[..., 1]
    c0 = gd.add(gd.mul(a0, b0), mul7(gd.mul(a1, b1)))
    c1 = gd.add(gd.mul(a0, b1), gd.mul(a1, b0))
    return torch.stack(torch.broadcast_tensors(c0, c1), dim=-1)


def ext_base_mul(s, a):
    """A base value s (...) times an extension value a (..., 2)."""
    return gd.mul(s[..., None], a)


def ext_inv(a):
    """conj(a) / N(a), N = a0^2 - 7·a1^2."""
    norm = gd.sub(gd.square(a[..., 0]), mul7(gd.square(a[..., 1])))
    ninv = gd.inv(norm)
    return torch.stack([gd.mul(a[..., 0], ninv),
                        gd.mul(gd.neg(a[..., 1]), ninv)], dim=-1)


# ---------------------------------------------------------------------------
# power tables
# ---------------------------------------------------------------------------
_POWER_CACHE: dict = {}


def powers_host(base: int, n: int, scale: int = 1) -> np.ndarray:
    """[s, s·b, ..., s·b^(n-1)] as uint64 numpy (by doubling, exact)."""
    key = (base % _P, n, scale % _P)
    p = _POWER_CACHE.get(key)
    if p is None:
        p = np.array([scale % _P], dtype=np.uint64)
        cur = base % _P
        while p.shape[0] < n:
            p = np.concatenate([p, Goldilocks.mul_np(p, np.uint64(cur))])
            cur = (cur * cur) % _P
        p = p[:n]
        _POWER_CACHE[key] = p
    return p


def powers_device(base: int, n: int, device, scale: int = 1):
    """The host power table as an int64 tensor on `device`."""
    return to_tensor(powers_host(base, n, scale), device)


# ---------------------------------------------------------------------------
# the field adapters
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class GLBaseField:
    name: str = "Goldilocks"
    P: int = _P
    TWO_ADICITY: int = 32
    GENERATOR: int = 7

    # ---- host ints ----
    def add_h(self, a, b):
        return Goldilocks.add_h(a, b)

    def sub_h(self, a, b):
        return Goldilocks.sub_h(a, b)

    def mul_h(self, a, b):
        return Goldilocks.mul_h(a, b)

    def neg_h(self, a):
        return Goldilocks.neg_h(a)

    def inv_h(self, a):
        return Goldilocks.inv_h(a)

    def exp_h(self, a, e):
        return Goldilocks.exp_h(a, e)

    def two_adic_generator_h(self, bits):
        return Goldilocks.two_adic_generator_h(bits)

    # ---- wire values (canonical u64) ----
    def from_monty_np(self, arr):
        """Tensor words (int64 numpy) or u64 values -> uint64 values."""
        return _u64(arr)

    def to_monty_np(self, arr):
        """Host values -> the uint64 words the host hashes read."""
        return _u64(arr)

    # ---- int64 tensors (the FRI prover's roll-in) ----
    def add(self, a, b):
        return gd.add(a, b)


@dataclass(frozen=True)
class GLExt2Field:
    """GL[X]/(X^2 - 7): host tuples and (..., 2) int64 tensors."""

    D: int = 2
    W: int = _W

    @property
    def base(self):
        return GLF

    @property
    def P(self):
        return _P

    # ---- host tuples ----
    def zero_h(self):
        return (0, 0)

    def one_h(self):
        return (1, 0)

    def from_base_h(self, x):
        return (int(x) % _P, 0)

    def add_h(self, a, b):
        return GoldilocksExt2Field.add_h(a, b)

    def sub_h(self, a, b):
        return GoldilocksExt2Field.sub_h(a, b)

    def mul_h(self, a, b):
        return GoldilocksExt2Field.mul_h(a, b)

    def neg_h(self, a):
        return GoldilocksExt2Field.neg_h(a)

    def base_mul_h(self, s, a):
        return GoldilocksExt2Field.base_mul_h(s, a)

    def inv_h(self, a):
        return GoldilocksExt2Field.inv_h(a)

    def exp_h(self, a, e):
        return GoldilocksExt2Field.exp_h(a, e)

    def powers_np(self, alpha, n: int) -> np.ndarray:
        """(n, 2) uint64 [1, alpha, alpha^2, ...]."""
        out = np.empty((n, 2), dtype=np.uint64)
        cur = self.one_h()
        for i in range(n):
            out[i] = cur
            cur = self.mul_h(cur, alpha)
        return out

    # ---- (..., 2) int64 tensors ----
    def const(self, ext, device=None):
        """An extension tuple as a (2,) tensor."""
        return to_tensor([int(c) % _P for c in ext], device)

    def from_base(self, x):
        return torch.stack([x, torch.zeros_like(x)], dim=-1)

    def mul(self, a, b):
        return ext_mul(a, b)


GLF = GLBaseField()
GLE = GLExt2Field()
