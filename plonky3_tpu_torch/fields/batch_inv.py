"""Batched field inversion (the Montgomery product trick) and the
Tonelli–Shanks square root.

Port of `plonky3_tpu/fields/batch_inv.py` (field/src/batch_inverse.rs:29).
One Fermat inverse of the total product serves every element:

    inv(a_i) = prefix(a_0..a_{i-1}) · suffix(a_{i+1}..) · total^-1

The reference takes the prefix and suffix products with two
`lax.associative_scan`s; torch has no scan with a modular-product
combiner, so here each is a log-depth doubling scan (Hillis–Steele: step
s multiplies every element by the one s places before it) of Montgomery
products on int64 tensors. An inverse is unique, so the bits are the
reference's. Zero maps to zero, as everywhere in the package.
"""

from __future__ import annotations

import numpy as np
import torch


def _scan_mul(F, x):
    """Inclusive prefix products along axis 0, log-depth, in place on `x`
    (each step's product is computed before it is written)."""
    s = 1
    while s < x.shape[0]:
        x[s:] = F.mul(x[s:], x[:-s])
        s <<= 1
    return x


def batch_inv(F, a):
    """Elementwise inverse of an int64 Montgomery tensor of any shape;
    zero -> zero."""
    flat = a.reshape(-1)
    if flat.shape[0] <= 2:
        return F.inv(a)
    one = F.const(1)
    zero = flat == 0
    safe = torch.where(zero, torch.full_like(flat, one), flat)
    pref = _scan_mul(F, safe.clone())
    suf = _scan_mul(F, safe.flip(0)).flip(0)  # flip copies
    total_inv = F.inv(pref[-1:])  # the one Fermat inverse
    ones = torch.full_like(flat[:1], one)
    pref_excl = torch.cat([ones, pref[:-1]])
    suf_excl = torch.cat([suf[1:], ones])
    out = F.mul(F.mul(pref_excl, suf_excl), total_inv)
    return torch.where(zero, torch.zeros_like(out), out).reshape(a.shape)


def batch_inv_np(F, a: np.ndarray) -> np.ndarray:
    """Host sequential Montgomery trick on a uint32 Montgomery-form array
    (batch_inverse.rs:29): forward prefix products, one modular inverse,
    backward substitution; zero -> zero. Exact Python ints."""
    flat = np.ascontiguousarray(a).reshape(-1)
    n = flat.shape[0]
    if n == 0:
        return np.array(a, copy=True)
    P = F.P
    std = [F.from_monty_h(int(x)) or 1 for x in flat]  # zeros -> one
    pref, acc = [], 1
    for x in std:
        acc = acc * x % P
        pref.append(acc)
    acc = F.inv_h(pref[-1])
    out = [0] * n
    for i in range(n - 1, 0, -1):
        out[i] = acc * pref[i - 1] % P
        acc = acc * std[i] % P
    out[0] = acc
    res = np.array([F.to_monty_h(x) for x in out], dtype=flat.dtype)
    return np.where(flat == 0, np.zeros_like(res), res).reshape(a.shape)


def try_sqrt_h(F, a: int):
    """Tonelli–Shanks square root of a standard-form int (the reference's
    `Field::try_sqrt`): r with r² = a mod P, or None for a non-residue."""
    p = F.P
    a %= p
    if a == 0:
        return 0
    if pow(a, (p - 1) // 2, p) != 1:
        return None
    q, s = p - 1, 0  # p - 1 = q · 2^s
    while q % 2 == 0:
        q //= 2
        s += 1
    if s == 1:
        return pow(a, (p + 1) // 4, p)
    z = 2  # a non-residue
    while pow(z, (p - 1) // 2, p) != p - 1:
        z += 1
    m, c, t, r = s, pow(z, q, p), pow(a, q, p), pow(a, (q + 1) // 2, p)
    while t != 1:
        i, t2 = 0, t
        while t2 != 1:
            t2 = t2 * t2 % p
            i += 1
        b = pow(c, 1 << (m - i - 1), p)
        m, c = i, b * b % p
        t = t * c % p
        r = r * b % p
    return r
