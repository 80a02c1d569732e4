"""Radix-2 NTT and coset LDE over two-adic Montgomery-31 fields.

Port of `plonky3_tpu/ops/ntt.py` (dft/src/traits.rs:28,227). Transforms
run along axis 0 of an int64 (n, ...) tensor. The forward transform is
decimation in frequency: natural rows in, bit-reversed rows out.

`_dif` sends every transform through `ntt_cuda.dif_fused`: on a CUDA
tensor that launches the four-step kernels, on a CPU tensor it runs the
radix-2 network `_dif_plain`. The two give the same bits.
`coset_lde_batch` (inverse DIF, bit reversal, shift powers with n^-1
folded in, forward DIF) keeps the zero pad implicit (`zero_top`).
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.bits import bitrev_permute_axis0, log2_strict

_TWIDDLES: dict = {}


def powers_np(F, base_std: int, n: int, scale_std: int = 1) -> np.ndarray:
    """[s, s·b, ..., s·b^(n-1)] as a Montgomery-form uint32 host array."""
    return F.to_monty_np(powers_std_np(F, base_std, n, scale_std))


def powers_std_np(F, base_std: int, n: int, scale_std: int = 1):
    """[s, s·b, ..., s·b^(n-1)] as a standard-form uint32 host array
    (log-doubling, exact uint64 products)."""
    P = np.uint64(F.P)
    out = np.array([scale_std % F.P], dtype=np.uint64)
    cur = np.uint64(base_std % F.P)
    while out.shape[0] < n:
        out = np.concatenate([out, (out * cur) % P])
        cur = (cur * cur) % P
    return out[:n].astype(np.uint32)


def powers_device(F, base_std: int, n: int, device, scale_std: int = 1):
    """`powers_np` as an int64 tensor on `device`."""
    p = powers_np(F, base_std, n, scale_std).astype(np.int64)
    return torch.from_numpy(p).to(device)


def _twiddles(F, log_n: int, inverse: bool, device):
    key = (F.name, log_n, inverse, str(device))
    tw = _TWIDDLES.get(key)
    if tw is None:
        g = F.two_adic_generator_h(log_n)
        if inverse:
            g = F.inv_h(g)
        tw = powers_device(F, g, max(1 << (log_n - 1), 1), device)
        _TWIDDLES[key] = tw
    return tw


def _dif_plain(F, x, log_n: int, inverse: bool):
    """The radix-2 DIF network along axis 0 of an int64 (n, ...) tensor:
    natural in, bit-reversed out (the reference's `_dif` arithmetic)."""
    n = 1 << log_n
    if log_n == 0:
        return x
    tw_full = _twiddles(F, log_n, inverse, x.device)
    rest = x.shape[1:]
    bcast = (1,) * len(rest)
    for s in range(log_n):
        m = n >> s
        half = m >> 1
        x4 = x.reshape((1 << s, m) + rest)
        t, u = x4[:, :half], x4[:, half:]
        tw = tw_full[:: 1 << s][:half].reshape((1, half) + bcast)
        x = torch.cat([F.add(t, u), F.mul(F.sub(t, u), tw)], dim=1)
    return x.reshape((n,) + rest)


def _dif(F, x, log_n: int, inverse: bool, zero_top: bool = False):
    """DIF along axis 0 of an int64 (n, ...) tensor through the kernel
    wrapper. With zero_top the upper half is an implicit zero pad: x has
    at most n/2 rows, zero-padded to n/2 in the kernel's int32 words."""
    from .ntt_cuda import dif_fused

    if log_n == 0:
        return x
    rest = x.shape[1:]
    words = x.reshape(x.shape[0], -1).to(torch.int32).contiguous()
    half = (1 << log_n) >> 1
    if zero_top and words.shape[0] < half:
        words = torch.cat([words, words.new_zeros(
            (half - words.shape[0], words.shape[1]))])
    out = dif_fused(F, words, log_n, inverse, zero_top)
    del words  # the int32 input goes before the int64 output comes
    return out.to(torch.int64).reshape((1 << log_n,) + rest)


def dft(F, mat):
    """Forward DFT, natural order in and out (dft/src/traits.rs:53)."""
    log_n = log2_strict(mat.shape[0])
    return bitrev_permute_axis0(_dif(F, mat, log_n, inverse=False), log_n)


def idft(F, mat):
    """Inverse DFT, natural order in and out (dft/src/traits.rs:150)."""
    log_n = log2_strict(mat.shape[0])
    out = bitrev_permute_axis0(_dif(F, mat, log_n, inverse=True), log_n)
    return F.mul(out, F.const(F.inv_h(1 << log_n)))


def coset_lde_batch(F, mat, added_bits: int, shift_std: int,
                    out_order: str = "bitrev", with_coeffs: bool = False):
    """Low-degree extension of the columns of `mat` (natural order over
    the subgroup H) onto the coset shift·K, |K| = n·2^added_bits
    (dft/src/traits.rs:227). Output rows 'bitrev' or 'natural'; with
    `with_coeffs` also the scaled coefficients a_i = c_i·shift^i."""
    log_n = log2_strict(mat.shape[0])
    log_N = log_n + added_bits
    n, N = 1 << log_n, 1 << log_N
    coeffs = bitrev_permute_axis0(_dif(F, mat, log_n, inverse=True), log_n)
    sp = powers_device(F, shift_std, n, mat.device, scale_std=F.inv_h(n))
    coeffs = F.mul(coeffs, sp.reshape((n,) + (1,) * (mat.dim() - 1)))
    out = _dif(F, coeffs, log_N, inverse=False, zero_top=added_bits > 0)
    if out_order == "natural":
        out = bitrev_permute_axis0(out, log_N)
    if with_coeffs:
        return out, coeffs
    return out


def dot_rows(F, mat, wx, chunk: int = 1 << 14):
    """Σ_i wx[i, d]·mat[i, j] for (h, w) mat and (h, D) wx (Montgomery in
    and out): (w, D). Each product is reduced before the row sum."""
    h = mat.shape[0]
    out = None
    for r0 in range(0, h, chunk):
        m = mat[r0:r0 + chunk]
        part = torch.stack(
            [(m * wx[r0:r0 + chunk, d:d + 1] % F.P).sum(dim=0)
             for d in range(wx.shape[1])], dim=-1)
        out = part if out is None else out + part
    return out % F.P * F.RINV % F.P


def eval_coeffs_at_point_ext(E, F, coeffs, z_powers):
    """Per-column p_j(z) = Σ_i c_ij z^i for (n, w) base coefficients and
    (n, D) extension powers of z: (w, D)."""
    return dot_rows(F, coeffs, z_powers)


def coset_evals_from_coeffs(F, coeffs, added_bits: int, shift_std: int):
    """Evaluate natural-order coefficients `coeffs` (m, w) over the coset
    shift·K, |K| = m·2^added_bits; bit-reversed rows out."""
    log_m = log2_strict(coeffs.shape[0])
    m = 1 << log_m
    sp = powers_device(F, shift_std, m, coeffs.device)
    scaled = F.mul(coeffs, sp.reshape((m,) + (1,) * (coeffs.dim() - 1)))
    pad = torch.zeros(((m << added_bits) - m,) + tuple(coeffs.shape[1:]),
                      dtype=scaled.dtype, device=scaled.device)
    return _dif(F, torch.cat([scaled, pad], dim=0), log_m + added_bits,
                inverse=False)
