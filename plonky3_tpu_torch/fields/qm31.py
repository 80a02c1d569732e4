"""CM31 and QM31, the degree-2 and degree-4 extensions of Mersenne-31.

Port of `plonky3_tpu/fields/qm31.py`: CM31 = M31[i]/(i^2 + 1)
(mersenne-31/src/complex.rs); QM31 = CM31[u]/(u^2 - W), W = 2 + i
(mersenne-31/src/qm31.rs:31). A QM31 element is a trailing axis of four
words [a.re, a.im, b.re, b.im] for a + b·u (the reference's flattening
order, which the extension MMCS and the transcript read); on the host it
is a 4-tuple of canonical ints. It is not a binomial extension, but it
offers the interface the generic code calls on `E` (`D`, `mul`,
`from_base`, `base_mul`, `inv`, `powers_np`, the `*_h` and `*_np`
helpers), with canonical int64 tensors on the device.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .mersenne31 import Mersenne31 as F

_P = F.P


def _cm_mul_h(a, b):
    return ((a[0] * b[0] - a[1] * b[1]) % _P,
            (a[0] * b[1] + a[1] * b[0]) % _P)


def _cm_inv_h(a):
    ni = pow((a[0] * a[0] + a[1] * a[1]) % _P, _P - 2, _P)
    return ((a[0] * ni) % _P, (-a[1] * ni) % _P)


def _cm_mul(ar, ai, br, bi):
    """CM31 product on canonical int64 arrays or tensors."""
    return ((ar * br - ai * bi) % _P, (ar * bi + ai * br) % _P)


def _qm_mul(a, b, stack):
    """QM31 product on (..., 4) canonical int64 arrays or tensors: the
    reference's (ac + W·bd) + (ad + bc)·u, every sum reduced mod P
    (Python's % on int64 is non-negative)."""
    ar, ai, br, bi = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    cr, ci, dr, di = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    acr, aci = _cm_mul(ar, ai, cr, ci)
    bdr, bdi = _cm_mul(br, bi, dr, di)
    # W·bd = (2 + i)(p + qi) = (2p - q) + (p + 2q)i
    rer = (acr + 2 * bdr - bdi) % _P
    rei = (aci + bdr + 2 * bdi) % _P
    adr, adi = _cm_mul(ar, ai, dr, di)
    bcr, bci = _cm_mul(br, bi, cr, ci)
    return stack([rer, rei, (adr + bcr) % _P, (adi + bci) % _P])


def _np_stack(xs):
    return np.stack(xs, axis=-1)


def _torch_stack(xs):
    return torch.stack(xs, dim=-1)


@dataclass(frozen=True)
class QM31Field:
    D: int = 4
    name: str = "QM31"

    @property
    def base(self):
        return F

    # ---- host: 4-tuples of canonical ints ----------------------------------
    def zero_h(self):
        return (0, 0, 0, 0)

    def one_h(self):
        return (1, 0, 0, 0)

    def from_base_h(self, x: int):
        return (x % _P, 0, 0, 0)

    def add_h(self, a, b):
        return tuple((x + y) % _P for x, y in zip(a, b))

    def sub_h(self, a, b):
        return tuple((x - y) % _P for x, y in zip(a, b))

    def neg_h(self, a):
        return tuple((-x) % _P for x in a)

    def base_mul_h(self, s: int, a):
        return tuple((s * x) % _P for x in a)

    def mul_h(self, a, b):
        x, y = (a[0], a[1]), (a[2], a[3])
        c, d = (b[0], b[1]), (b[2], b[3])
        ac, bd = _cm_mul_h(x, c), _cm_mul_h(y, d)
        w_bd = _cm_mul_h((2, 1), bd)
        ad, bc = _cm_mul_h(x, d), _cm_mul_h(y, c)
        return ((ac[0] + w_bd[0]) % _P, (ac[1] + w_bd[1]) % _P,
                (ad[0] + bc[0]) % _P, (ad[1] + bc[1]) % _P)

    def inv_h(self, a):
        """(x - y·u) / (x^2 - W·y^2), the norm a CM31 element."""
        x, y = (a[0], a[1]), (a[2], a[3])
        x2 = _cm_mul_h(x, x)
        wy2 = _cm_mul_h((2, 1), _cm_mul_h(y, y))
        ni = _cm_inv_h(((x2[0] - wy2[0]) % _P, (x2[1] - wy2[1]) % _P))
        re = _cm_mul_h(x, ni)
        im = _cm_mul_h(((-y[0]) % _P, (-y[1]) % _P), ni)
        return (re[0], re[1], im[0], im[1])

    def exp_h(self, a, e: int):
        acc, cur = self.one_h(), a
        while e:
            if e & 1:
                acc = self.mul_h(acc, cur)
            cur = self.mul_h(cur, cur)
            e >>= 1
        return acc

    # ---- host arrays -------------------------------------------------------
    def to_monty_np(self, a) -> np.ndarray:
        """Host tuple or array -> uint32 words (no Montgomery form)."""
        return (np.asarray(a, dtype=np.uint64) % np.uint64(_P)).astype(
            np.uint32)

    def from_monty_np(self, arr) -> tuple:
        arr = np.asarray(arr, dtype=np.uint64).reshape(self.D)
        return tuple(int(x) % _P for x in arr)

    def mul_np(self, a, b) -> np.ndarray:
        a = np.asarray(a).astype(np.int64)
        b = np.asarray(b).astype(np.int64)
        a, b = np.broadcast_arrays(a, b)
        return _qm_mul(a, b, _np_stack).astype(np.uint32)

    def powers_np(self, a, count: int) -> np.ndarray:
        """[1, a, a^2, ...] as a (count, 4) uint32 array."""
        out = np.empty((count, 4), dtype=np.uint32)
        acc = self.one_h()
        for i in range(count):
            out[i] = acc
            acc = self.mul_h(acc, a)
        return out

    # ---- tensors: (..., 4) canonical int64 ---------------------------------
    def const(self, a_host, device):
        return torch.tensor([int(x) % _P for x in a_host], dtype=torch.int64,
                            device=device)

    def from_base(self, x):
        pad = torch.zeros(x.shape + (3,), dtype=x.dtype, device=x.device)
        return torch.cat([x[..., None], pad], dim=-1)

    def add(self, a, b):
        return F.add(a, b)

    def sub(self, a, b):
        return F.sub(a, b)

    def neg(self, a):
        return F.neg(a)

    def mul(self, a, b):
        a, b = torch.broadcast_tensors(a, b)
        return _qm_mul(a, b, _torch_stack)

    def square(self, a):
        return self.mul(a, a)

    def base_mul(self, s, a):
        """base tensor (...,) × extension tensor (..., 4)."""
        return F.mul(s[..., None], a)

    def inv(self, a, base_inv=None):
        """Elementwise inverse through the CM31 norm; 0 maps to 0. The
        base-field inverse is `base_inv` (default Fermat)."""
        ar, ai, br, bi = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
        x2r, x2i = _cm_mul(ar, ai, ar, ai)
        y2r, y2i = _cm_mul(br, bi, br, bi)
        nr = (x2r - 2 * y2r + y2i) % _P
        ni = (x2i - y2r - 2 * y2i) % _P
        di = (base_inv or F.inv)((nr * nr + ni * ni) % _P)
        invr, invi = nr * di % _P, (_P - ni) * di % _P
        rer, rei = _cm_mul(ar, ai, invr, invi)
        imr, imi = _cm_mul((_P - br) % _P, (_P - bi) % _P, invr, invi)
        return torch.stack([rer, rei, imr, imi], dim=-1)


QM31 = QM31Field()
