"""Binomial extension fields F[X]/(X^D - W) on a trailing axis of size D.

Port of `plonky3_tpu/fields/extension.py`. An extension element is a
tensor with a trailing axis of D Montgomery-form components (int64). The
product is the schoolbook convolution with the X^D = W fold; each partial
product is reduced mod P before the sums, and the sum is reduced once with
R^-1 (the Montgomery factor). The inverse uses the Frobenius norm method:
a^-1 = (a^p · a^{p^2} · … · a^{p^{D-1}}) / Norm(a).

The same product serves numpy int64 arrays (the `*_np` host helpers) and
torch tensors.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .monty31 import Monty31


def _ext_mul(F: Monty31, D: int, W: int, a, b, stack):
    """Montgomery-form extension product on int64 arrays or tensors."""
    P = F.P
    out = []
    for k in range(D):
        acc = None
        for i in range(D):
            j = k - i if i <= k else k - i + D
            t = a[..., i] * b[..., j] % P
            if i > k:
                t = t * W
            acc = t if acc is None else acc + t
        out.append(acc % P * F.RINV % P)
    return stack(out)


def _np_stack(xs):
    return np.stack(xs, axis=-1)


def _torch_stack(xs):
    return torch.stack(xs, dim=-1)


@dataclass(frozen=True)
class BinomialExtension:
    base: Monty31
    D: int
    W: int
    DTH_ROOT: int
    EXT_GENERATOR: tuple
    EXT_TWO_ADICITY: int

    # ---- host scalar math: D-tuples of standard-form ints --------------
    def zero_h(self):
        return (0,) * self.D

    def one_h(self):
        return (1,) + (0,) * (self.D - 1)

    def from_base_h(self, x: int):
        return (x % self.base.P,) + (0,) * (self.D - 1)

    def add_h(self, a, b):
        p = self.base.P
        return tuple((x + y) % p for x, y in zip(a, b))

    def sub_h(self, a, b):
        p = self.base.P
        return tuple((x - y) % p for x, y in zip(a, b))

    def neg_h(self, a):
        p = self.base.P
        return tuple((-x) % p for x in a)

    def mul_h(self, a, b):
        p, d, w = self.base.P, self.D, self.W
        c = [0] * d
        for i in range(d):
            for j in range(d):
                k = i + j
                if k < d:
                    c[k] = (c[k] + a[i] * b[j]) % p
                else:
                    c[k - d] = (c[k - d] + w * a[i] * b[j]) % p
        return tuple(c)

    def base_mul_h(self, s: int, a):
        p = self.base.P
        return tuple((s * x) % p for x in a)

    def exp_h(self, a, e: int):
        acc = self.one_h()
        base = a
        while e:
            if e & 1:
                acc = self.mul_h(acc, base)
            base = self.mul_h(base, base)
            e >>= 1
        return acc

    def frobenius_h(self, a):
        p = self.base.P
        return tuple((a[i] * pow(self.DTH_ROOT, i, p)) % p
                     for i in range(self.D))

    def inv_h(self, a):
        conj, prod = a, None
        for _ in range(self.D - 1):
            conj = self.frobenius_h(conj)
            prod = conj if prod is None else self.mul_h(prod, conj)
        norm = self.mul_h(a, prod)
        return self.base_mul_h(self.base.inv_h(norm[0]), prod)

    def rand_h(self, rng: np.random.Generator):
        """A uniform element (the reference's draws from the same rng)."""
        return tuple(int(x) for x in rng.integers(0, self.base.P, self.D))

    # ---- host <-> arrays ----------------------------------------------
    def to_monty_np(self, a) -> np.ndarray:
        """Host tuple (standard ints) -> (D,) uint32 Montgomery array."""
        return np.array([self.base.to_monty_h(x) for x in a], dtype=np.uint32)

    def from_monty_np(self, arr) -> tuple:
        arr = np.asarray(arr, dtype=np.uint32).reshape(self.D)
        return tuple(self.base.from_monty_h(int(x)) for x in arr)

    def mul_np(self, a, b) -> np.ndarray:
        """Host product of Montgomery uint32 arrays (..., D)."""
        a = np.asarray(a).astype(np.int64)
        b = np.asarray(b).astype(np.int64)
        a, b = np.broadcast_arrays(a, b)
        return _ext_mul(self.base, self.D, self.W, a, b,
                        _np_stack).astype(np.uint32)

    def powers_np(self, a_host, count: int) -> np.ndarray:
        """[1, a, a^2, ...] as a (count, D) uint32 Montgomery array."""
        out = np.zeros((max(count, 1), self.D), dtype=np.uint32)
        out[0] = self.to_monty_np(self.one_h())
        m, apow = 1, a_host
        while m < count:
            k = min(m, count - m)
            out[m:m + k] = self.mul_np(out[:k], self.to_monty_np(apow))
            m += k
            apow = self.mul_h(apow, apow)
        return out

    # ---- tensor math: (..., D) int64 Montgomery tensors -----------------
    def const(self, a_host, device):
        """Host tuple -> (D,) int64 tensor on `device`."""
        return torch.from_numpy(
            self.to_monty_np(a_host).astype(np.int64)).to(device)

    def from_base(self, x):
        pad = torch.zeros(x.shape + (self.D - 1,), dtype=x.dtype,
                          device=x.device)
        return torch.cat([x[..., None], pad], dim=-1)

    def add(self, a, b):
        return self.base.add(a, b)

    def sub(self, a, b):
        return self.base.sub(a, b)

    def neg(self, a):
        return self.base.sub(0, a)

    def mul(self, a, b):
        a, b = torch.broadcast_tensors(a, b)
        return _ext_mul(self.base, self.D, self.W, a, b, _torch_stack)

    def base_mul(self, s, a):
        """base tensor (...,) × ext tensor (..., D)."""
        return self.base.mul(s[..., None], a)

    def frobenius(self, a):
        F = self.base
        scales = [F.to_monty_h(pow(self.DTH_ROOT, i, F.P))
                  for i in range(self.D)]
        return F.mul(a, torch.tensor(scales, dtype=a.dtype, device=a.device))

    def inv(self, a, base_inv=None):
        """Elementwise inverse via the Frobenius norm; 0 maps to 0. The
        norm's base-field inverse is `base_inv` (default the Fermat
        inverse `base.inv`; `base.batch_inv` gives the same bits)."""
        conj, prod = a, None
        for _ in range(self.D - 1):
            conj = self.frobenius(conj)
            prod = conj if prod is None else self.mul(prod, conj)
        norm = self.mul(a, prod)[..., 0]
        return self.base_mul((base_inv or self.base.inv)(norm), prod)
