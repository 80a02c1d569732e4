"""The multilinear hot loops as whole-tensor arithmetic.

Port of `plonky3_tpu/multilinear/device_kernels.py`, whose functions are
jnp programs (no Pallas): here they are plain torch on (N, D) int64
Montgomery tensors, on the device of their inputs. Every table is one
(N, D) extension tensor; a sumcheck round is an affine extension, a
product and a modular sum; the weighted eq table of C batched
constraints builds over a (C, nv, D) point tensor. They back the WHIR
prover (`whir.py`), the zerocheck (`sumcheck.py`) and the multilinear
STARK's product sumchecks (`multi_stark.py`).
"""

from __future__ import annotations

import numpy as np
import torch

# constraints a weighted-eq chunk: bounds the (C, 2^nv, D) temporaries
_EQ_CHUNK = 16


def fold_at(E, table, r_m):
    """(2m, D) ext table -> (m, D): even + r·(odd - even)."""
    v = table.reshape(-1, 2, E.D)
    even, odd = v[:, 0], v[:, 1]
    return E.add(even, E.mul(E.sub(odd, even), r_m))


def round_poly_012(E, evals, w):
    """The quadratic sumcheck round evaluations (s(0), s(1), s(2)) of
    Σ_x f(x)·w(x) over the lowest variable, as a (3, D) tensor; s(2) by
    the affine extrapolation g(2) = 2·g(1) - g(0)."""
    F = E.base
    g = evals.reshape(-1, 2, E.D)
    wv = w.reshape(-1, 2, E.D)
    g0, g1 = g[:, 0], g[:, 1]
    w0, w1 = wv[:, 0], wv[:, 1]
    s0 = F.sum(E.mul(g0, w0), dim=0)
    s1 = F.sum(E.mul(g1, w1), dim=0)
    g2 = E.add(g1, E.sub(g1, g0))
    w2 = E.add(w1, E.sub(w1, w0))
    s2 = F.sum(E.mul(g2, w2), dim=0)
    return torch.stack([s0, s1, s2])


def weighted_eq_table(E, points_m, scales_m, nv: int):
    """Σ_c scales[c] · eq(points[c], ·) as one (2^nv, D) ext table.

    points_m: (C, nv, D) Montgomery; scales_m: (C, D). Each chunk of
    constraints builds by interleaving over a (C, cur, D) tensor
    (variable i is index bit i), then one modular sum over C."""
    F = E.base
    one = E.const(E.one_h(), points_m.device)
    out = None
    for c0 in range(0, points_m.shape[0], _EQ_CHUNK):
        pts = points_m[c0:c0 + _EQ_CHUNK]
        table = scales_m[c0:c0 + _EQ_CHUNK, None, :]
        for i in range(nv - 1, -1, -1):
            r = pts[:, i, None, :]  # (C, 1, D)
            lo = E.mul(table, E.sub(one, r))
            hi = E.mul(table, r)
            table = torch.stack([lo, hi], dim=2).reshape(
                pts.shape[0], -1, E.D)
        part = F.sum(table, dim=0)
        out = part if out is None else F.add(out, part)
    return out


def coeffs_to_evals_device(E, coeffs):
    """Multilinear coefficients -> hypercube evaluations ((N, D) ext; the
    inverse of the Möbius transform)."""
    c = coeffs
    n = c.shape[0]
    step = 1
    while step < n:
        v = c.reshape(-1, 2, step, E.D)
        c = torch.stack([v[:, 0], E.add(v[:, 1], v[:, 0])],
                        dim=1).reshape(n, E.D)
        step <<= 1
    return c


def dot_ext(E, a, b):
    """Σ_i a_i·b_i of two (N, D) ext tensors -> (D,)."""
    return E.base.sum(E.mul(a, b), dim=0)


def ext_powers(E, z_m, log_n: int):
    """[1, z, ..., z^{2^log_n - 1}] as a (2^log_n, D) Montgomery tensor
    (z_m a (D,) Montgomery tensor)."""
    from ..fri.two_adic_pcs import _ext_powers_device

    return _ext_powers_device(E, z_m, log_n)


def horner_fold_pair(E, coeffs, z_m):
    """One Horner-doubling step over pairs: c'(x) = c_even(x) +
    z·c_odd(x)."""
    v = coeffs.reshape(-1, 2, E.D)
    return E.add(v[:, 0], E.mul(v[:, 1], z_m))


def eval_univariate_device(E, coeffs, z):
    """Σ c_i z^i of (N, D) device coefficients at a host ext z: log N
    folds c'(x²) = c_e + z·c_o, z squaring each step. A host tuple."""
    z_cur = z
    while coeffs.shape[0] > 1:
        coeffs = horner_fold_pair(E, coeffs, E.const(z_cur, coeffs.device))
        z_cur = E.mul_h(z_cur, z_cur)
    return pull_ext(E, coeffs[0])


def pull_ext(E, dev):
    """A (..., D) Montgomery tensor -> host tuple(s) of standard ints."""
    a = E.base.from_monty_np(dev.cpu().numpy())
    if a.ndim == 1:
        return tuple(int(x) for x in a)
    return [tuple(int(x) for x in row) for row in a.reshape(-1, E.D)]


def ext_tensor(E, values, device):
    """Host ext tuples (standard ints) -> an (n, D) Montgomery tensor."""
    arr = np.asarray(values, dtype=np.uint64).reshape(-1, E.D)
    return torch.from_numpy(
        E.base.to_monty_np(arr).astype(np.int64)).to(device)
