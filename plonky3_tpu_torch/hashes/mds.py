"""MDS permutations (the reference `mds` crate).

Port of `plonky3_tpu/hashes/mds.py`: the circulant MDS as an explicit
matrix (host ints, numpy, int64 tensors), the Reed–Solomon coset MDS
(mds/src/coset_mds.rs:25) whose tensor path runs the port's coset LDE,
and the Karatsuba circulant product (karatsuba_convolution.rs) on host
ints.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .poseidon1 import mds_mul


@dataclass(frozen=True)
class CirculantMds:
    """M[i][j] = first_row[(j - i) mod w] (mds/src/util.rs
    first_row_to_first_col)."""

    F: object
    first_row: tuple

    @property
    def width(self):
        return len(self.first_row)

    def _matrix_np(self):
        w = self.width
        return np.array([[self.first_row[(j - i) % w] % self.F.P
                          for j in range(w)] for i in range(w)],
                        dtype=np.uint64)

    def permute_host(self, state):
        P, w = self.F.P, self.width
        row = self.first_row
        return [sum(row[(j - i) % w] * state[j] for j in range(w)) % P
                for i in range(w)]

    def permute_np(self, states):
        m = self._matrix_np()
        x = np.asarray(states, dtype=np.uint64)
        return (((x[..., None, :] * m) % self.F.P).sum(axis=-1)
                % self.F.P).astype(np.uint32)

    def permute_device(self, states):
        """(..., w) Montgomery int64 tensors: the matrix's standard-form
        entries times the values (Montgomery form is linear)."""
        m = torch.from_numpy(self._matrix_np().astype(np.int64)).to(
            states.device)
        return mds_mul(states, m, self.F.P)


@dataclass(frozen=True)
class CosetMds:
    """Reed–Solomon coset-evaluation MDS (mds/src/coset_mds.rs:25): the
    input as evaluations over the size-N subgroup, the output N times the
    interpolant's evaluations over the GENERATOR coset (the unnormalized
    inverse DFT of the reference's Bowers G/Gᵀ pipeline keeps the factor
    N)."""

    F: object
    width: int

    def _coeffs_unscaled_np(self, state):
        """N times the interpolant's coefficients (host exact)."""
        F, n = self.F, self.width
        log_n = n.bit_length() - 1
        g_inv = F.inv_h(F.two_adic_generator_h(log_n))
        return [sum(F.mul_h(int(state[k]), F.exp_h(g_inv, (i * k) % n))
                    for k in range(n)) % F.P for i in range(n)]

    def permute_host(self, state):
        F, n = self.F, self.width
        log_n = n.bit_length() - 1
        coeffs = self._coeffs_unscaled_np(state)
        g = F.two_adic_generator_h(log_n)
        out = []
        for k in range(n):
            x = F.mul_h(F.GENERATOR, F.exp_h(g, k))
            acc, xp = 0, 1
            for c in coeffs:
                acc = (acc + F.mul_h(c, xp)) % F.P
                xp = F.mul_h(xp, x)
            out.append(acc)
        return out

    def _matrix_np(self):
        n = self.width
        cols = []
        for j in range(n):
            e = [0] * n
            e[j] = 1
            cols.append(self.permute_host(e))
        return np.array(cols, dtype=np.uint64).T

    def permute_np(self, states):
        m = self._matrix_np()
        x = np.asarray(states, dtype=np.uint64)
        out = np.zeros_like(x)
        P = np.uint64(self.F.P)
        for i in range(self.width):
            out[..., i] = ((x * m[i][None, :]) % P).sum(axis=-1) % P
        return out.astype(np.uint32)

    def permute_device(self, states):
        """(..., w) Montgomery int64 tensors through the coset LDE (the
        PCS's iDFT, shift, DFT), batched over the states on the column
        axis, then N times the result (the skipped 1/N)."""
        from ..ops.ntt import coset_lde_batch
        from ..utils.bits import bitrev_permute_axis0, log2_strict

        F, n = self.F, self.width
        x = states.reshape(-1, n).t().contiguous()  # (w, states)
        lde_br = coset_lde_batch(F, x, 0, F.GENERATOR)
        lde = bitrev_permute_axis0(lde_br, log2_strict(n))
        scaled = F.mul(lde, F.const(n))
        return scaled.t().reshape(states.shape)


def karatsuba_circulant_mul(F, first_col, states):
    """Circulant times vector by the split cyclic/negacyclic convolution
    with Karatsuba negacyclic halves (mds/src/karatsuba_convolution.rs):
    u * v mod (x^N - 1) splits by CRT into mod (x^{N/2} - 1) (cyclic,
    recursed) and mod (x^{N/2} + 1) (negacyclic, Karatsuba). Host exact
    (Python ints); `first_col` is the circulant's first column c, so the
    output is C·x with C[i][j] = c[(i-j) % N]."""
    P = F.P
    c = [int(v) % P for v in first_col]
    out_rows = []
    for row in np.atleast_2d(np.asarray(states, dtype=np.uint64)):
        out_rows.append(_cyclic_conv(c, [int(v) % P for v in row], P))
    return np.array(out_rows, dtype=np.uint64).astype(np.uint32)


def _cyclic_conv(u, v, P):
    n = len(u)
    if n == 1:
        return [(u[0] * v[0]) % P]
    if n % 2:  # odd length: the plain product
        return [sum(u[(i - j) % n] * v[j] for j in range(n)) % P
                for i in range(n)]
    h = n // 2
    u_c = [(u[i] + u[i + h]) % P for i in range(h)]
    v_c = [(v[i] + v[i + h]) % P for i in range(h)]
    u_n = [(u[i] - u[i + h]) % P for i in range(h)]
    v_n = [(v[i] - v[i + h]) % P for i in range(h)]
    r_c = _cyclic_conv(u_c, v_c, P)  # mod x^h - 1
    r_n = _negacyclic_conv(u_n, v_n, P)  # mod x^h + 1
    inv2 = pow(2, P - 2, P)
    lo = [((r_c[i] + r_n[i]) * inv2) % P for i in range(h)]
    hi = [((r_c[i] - r_n[i]) * inv2) % P for i in range(h)]
    return lo + hi


def _negacyclic_conv(u, v, P):
    """u·v mod (x^n + 1) from the Karatsuba linear product."""
    n = len(u)
    lin = _karatsuba(u, v, P)  # length 2n - 1
    return [(lin[i] - (lin[i + n] if i + n < len(lin) else 0)) % P
            for i in range(n)]


def _karatsuba(u, v, P):
    n = len(u)
    if n <= 4 or n % 2:
        out = [0] * (2 * n - 1)
        for i in range(n):
            for j in range(n):
                out[i + j] = (out[i + j] + u[i] * v[j]) % P
        return out
    h = n // 2
    u0, u1 = u[:h], u[h:]
    v0, v1 = v[:h], v[h:]
    z0 = _karatsuba(u0, v0, P)
    z2 = _karatsuba(u1, v1, P)
    z1 = _karatsuba([(a + b) % P for a, b in zip(u0, u1)],
                    [(a + b) % P for a, b in zip(v0, v1)], P)
    out = [0] * (2 * n - 1)
    for i, z in enumerate(z0):
        out[i] = (out[i] + z) % P
        out[i + h] = (out[i + h] - z) % P
    for i, z in enumerate(z1):
        out[i + h] = (out[i + h] + z) % P
    for i, z in enumerate(z2):
        out[i + h] = (out[i + h] - z) % P
        out[i + 2 * h] = (out[i + 2 * h] + z) % P
    return out
