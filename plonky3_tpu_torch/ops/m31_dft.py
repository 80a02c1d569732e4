"""Mersenne31 real->complex DFT (`mersenne-31/src/dft.rs`).

Port of `plonky3_tpu/ops/m31_dft.py` (host numpy; no prover path calls
it).

An M31 DFT of length n folds into a CM31 (complex) DFT of length n/2:
even rows become real parts, odd rows imaginary parts; after the
half-length complex transform, a pre/post-processing pass (the standard
real-FFT split, robinscheibler.org/2013/02/13/real-fft.html) recovers
spectrum values satisfying the convolution theorem. Only the first
n/2 + 1 spectrum rows are returned — the remainder is determined by
conjugate symmetry (dft.rs:7-11).

The complex transform itself is a vectorized numpy radix-2 DIF over
(h, w, 2) (re, im) arrays — CM31 is where M31 gains its two-adicity
(|CM31*| has 2^32 | p^2 - 1), which is exactly why this fold exists.
"""

from __future__ import annotations

import numpy as np

from ..utils.bits import log2_strict, reverse_bits_len

P = np.uint64((1 << 31) - 1)
_PI = (1 << 31) - 1


def _cm_mul(a, b):
    """(..., 2) x (..., 2) complex M31 multiply (u64 lanes)."""
    ar, ai = a[..., 0], a[..., 1]
    br, bi = b[..., 0], b[..., 1]
    re = (ar * br % P + P - ai * bi % P) % P
    im = (ar * bi % P + ai * br % P) % P
    return np.stack([re, im], axis=-1)


def _cm_generator(bits: int):
    """Order-2^bits element of CM31* (squaring chain from an order-2^32
    generator; (2+i) has order divisible by 2^32... derived instead from
    g = (g31, 1)-style search done once, host exact)."""
    # Find a generator of the full 2-Sylow subgroup: x^((p^2-1)/2^32)
    # for a multiplicative generator x of CM31. x = 2 + i works.
    assert bits <= 32
    p2 = _PI * _PI + 2 * _PI + 1 - 1  # p^2 - 1 with p = 2^31 - 1
    odd = (p2) >> 32

    def mul_h(a, b):
        return (
            (a[0] * b[0] - a[1] * b[1]) % _PI,
            (a[0] * b[1] + a[1] * b[0]) % _PI,
        )

    def exp_h(a, e):
        acc = (1, 0)
        for bit in bin(e)[2:]:
            acc = mul_h(acc, acc)
            if bit == "1":
                acc = mul_h(acc, a)
        return acc

    g = exp_h((2, 1), odd)  # order 2^32 (verified in tests)
    for _ in range(32 - bits):
        g = mul_h(g, g)
    return g


_TW_CACHE: dict = {}


def _twiddles(log_n: int, inverse: bool):
    key = (log_n, inverse)
    t = _TW_CACHE.get(key)
    if t is None:
        g = _cm_generator(log_n)
        if inverse:
            # g^-1 = g^(2^log_n - 1)
            def mul_h(a, b):
                return (
                    (a[0] * b[0] - a[1] * b[1]) % _PI,
                    (a[0] * b[1] + a[1] * b[0]) % _PI,
                )

            acc, base = (1, 0), g
            e = (1 << log_n) - 1
            for bit in bin(e)[2:]:
                acc = mul_h(acc, acc)
                if bit == "1":
                    acc = mul_h(acc, base)
            g = acc
        half = max(1 << (log_n - 1), 1)
        tw = np.zeros((half, 2), np.uint64)
        cur = (1, 0)
        for i in range(half):
            tw[i] = cur
            cur = (
                (cur[0] * g[0] - cur[1] * g[1]) % _PI,
                (cur[0] * g[1] + cur[1] * g[0]) % _PI,
            )
        _TW_CACHE[key] = tw
        t = tw
    return t


def _cm_dif(x, log_n: int, inverse: bool):
    """(n, w, 2) radix-2 DIF: natural in, bit-reversed out."""
    n = 1 << log_n
    if log_n == 0:
        return x
    tw_full = _twiddles(log_n, inverse)
    x = x.reshape((1, n) + x.shape[1:])
    for s in range(log_n):
        m = n >> s
        half = m >> 1
        tw = tw_full[:: 1 << s][:half].reshape(1, half, 1, 2)
        t = x[:, :half]
        u = x[:, half:]
        top = (t + u) % P
        bot = _cm_mul((t + P - u) % P, tw)
        x = np.concatenate([top, bot], axis=1).reshape(
            (2 << s, half) + x.shape[2:]
        )
    return x.reshape((n,) + x.shape[2:])


def _bitrev_rows(x, log_n):
    idx = np.array(
        [reverse_bits_len(i, log_n) for i in range(1 << log_n)]
    )
    return x[idx]


def _cm_dft(x, inverse=False):
    """(h, w, 2) natural -> natural complex DFT (unscaled iDFT)."""
    log_n = log2_strict(x.shape[0])
    out = _bitrev_rows(_cm_dif(x, log_n, inverse), log_n)
    if inverse:
        n_inv = pow(1 << log_n, _PI - 2, _PI)
        out = out * np.uint64(n_inv) % P
    return out


def m31_dft_batch(mat: np.ndarray) -> np.ndarray:
    """(h, w) M31 columns -> (h/2 + 1, w, 2) CM31 spectrum rows
    (dft.rs:183 Mersenne31Dft::dft_batch)."""
    h, w = mat.shape
    assert h % 2 == 0
    packed = np.stack(
        [mat[0::2].astype(np.uint64), mat[1::2].astype(np.uint64)],
        axis=-1,
    )  # (h/2, w, 2)
    spec = _cm_dft(packed)
    n = h // 2
    log_n = log2_strict(max(n, 1))
    omega = _cm_generator(log_n + 1)
    out = np.zeros((n + 1, w, 2), np.uint64)
    out[0, :, 0] = (spec[0, :, 0] + spec[0, :, 1]) % P
    out[n, :, 0] = (spec[0, :, 0] + P - spec[0, :, 1]) % P
    omega_j = omega
    half_inv = np.uint64(pow(2, _PI - 2, _PI))
    for j in range(1, n):
        x = spec[j]
        y = spec[n - j]
        y_conj = np.stack([y[:, 0], (P - y[:, 1]) % P], axis=-1)
        even = (x + y_conj) % P
        odd = np.stack(
            [(x[:, 1] + y[:, 1]) % P, (y[:, 0] + P - x[:, 0]) % P],
            axis=-1,
        )
        wj = np.array(omega_j, np.uint64).reshape(1, 2)
        term = (
            even + _cm_mul(odd, np.broadcast_to(wj, odd.shape))
        ) % P
        out[j] = term * half_inv % P
        omega_j = (
            (omega_j[0] * omega[0] - omega_j[1] * omega[1]) % _PI,
            (omega_j[0] * omega[1] + omega_j[1] * omega[0]) % _PI,
        )
    return out


def m31_idft_batch(spec: np.ndarray) -> np.ndarray:
    """(h/2 + 1, w, 2) spectrum -> (h, w) M31 (dft.rs:191)."""
    n = spec.shape[0] - 1
    w = spec.shape[1]
    log_n = log2_strict(max(n, 1))
    omega = _cm_generator(log_n + 1)
    # inverse omega
    e = (1 << (log_n + 1)) - 1
    acc, base = (1, 0), omega
    for bit in bin(e)[2:]:
        acc = (
            (acc[0] * acc[0] - acc[1] * acc[1]) % _PI,
            (2 * acc[0] * acc[1]) % _PI,
        )
        if bit == "1":
            acc = (
                (acc[0] * base[0] - acc[1] * base[1]) % _PI,
                (acc[0] * base[1] + acc[1] * base[0]) % _PI,
            )
    omega_inv = acc
    packed = np.zeros((n, w, 2), np.uint64)
    omega_j = (1, 0)
    half_inv = np.uint64(pow(2, _PI - 2, _PI))
    for j in range(n):
        x = spec[j]
        y = spec[n - j]
        y_conj = np.stack([y[:, 0], (P - y[:, 1]) % P], axis=-1)
        even = (x + y_conj) % P
        odd = np.stack(
            [(x[:, 1] + y[:, 1]) % P, (y[:, 0] + P - x[:, 0]) % P],
            axis=-1,
        )
        wj = np.array(omega_j, np.uint64).reshape(1, 2)
        term = (even + P - _cm_mul(odd, np.broadcast_to(wj, odd.shape))
                ) % P
        packed[j] = term * half_inv % P
        omega_j = (
            (omega_j[0] * omega_inv[0] - omega_j[1] * omega_inv[1])
            % _PI,
            (omega_j[0] * omega_inv[1] + omega_j[1] * omega_inv[0])
            % _PI,
        )
    vals = _cm_dft(packed, inverse=True)
    out = np.zeros((2 * n, w), np.uint64)
    out[0::2] = vals[:, :, 0]
    out[1::2] = vals[:, :, 1]
    return out.astype(np.uint32)
