"""Radix-2 NTT and coset LDE over Goldilocks on int64 tensors.

Port of `plonky3_tpu/gl/ntt.py` (dft/src/radix_2_dit_parallel.rs;
goldilocks/src/goldilocks.rs:243, TWO_ADICITY 32). The reference's is jnp
(no Pallas), so this is plain torch: a DIF butterfly network along axis 0,
natural order in and bit-reversed out, one radix-2 stage at a time in
place (a' = a + b, b' = (a - b)·w^j); the coset LDE is the inverse DIF,
the scale by shift^i·n^-1, zero padding and the forward DIF, its rows in
bit-reversed order (the FRI commit layout). Every result is exact, so the
bits are the reference's (its stages fused three at a time).

Every column transforms on its own, so a matrix goes through in blocks of
columns (`_col_block`, as `ops/circle.py` does): no temporary of a
butterfly spans the whole LDE.
"""

from __future__ import annotations

import torch

from ..fields import goldilocks_device as gd
from ..fields.goldilocks import Goldilocks
from ..utils.bits import bitrev_permute_axis0, log2_strict
from .field import powers_device

# the bytes of one column block's output (its temporaries are a few times
# this)
_BLOCK_BYTES = 1 << 29

_TWIDDLES: dict = {}


def _col_block(rows: int) -> int:
    return max(1, _BLOCK_BYTES // (8 * rows))


def _twiddles(log_n: int, inverse: bool, device):
    """[w^j, j < n/2] for w the 2^log_n-th root of unity (or its
    inverse), an int64 tensor kept per size and device."""
    key = (log_n, inverse, device)
    tw = _TWIDDLES.get(key)
    if tw is None:
        g = Goldilocks.two_adic_generator_h(log_n)
        if inverse:
            g = Goldilocks.inv_h(g)
        tw = _TWIDDLES[key] = powers_device(g, max((1 << log_n) >> 1, 1),
                                            device)
    return tw


def gl_dif_(x, log_n: int, inverse: bool):
    """In place: the DIF network along axis 0 of a contiguous (n, w)
    tensor, natural order in, bit-reversed out."""
    n, w = x.shape
    tw = _twiddles(log_n, inverse, x.device)
    for t in range(log_n):
        half = n >> (t + 1)
        v = x.view(1 << t, 2, half, w)
        a, b = v[:, 0], v[:, 1]
        d = gd.sub(a, b)
        v[:, 0] = gd.add(a, b)
        v[:, 1] = gd.mul(d, tw[::1 << t][:, None])
        del d
    return x


def _blocks(x, fn, out_rows):
    """fn(column block copy) for each block of x's columns into one
    (out_rows, w) tensor."""
    n, w = x.shape
    out = torch.empty((out_rows, w), dtype=torch.int64, device=x.device)
    step = _col_block(max(n, out_rows))
    for c in range(0, w, step):
        out[:, c:c + step] = fn(x[:, c:c + step].clone(
            memory_format=torch.contiguous_format))
    return out


def gl_dft(x):
    """Forward DFT of each column, natural order in and out."""
    log_n = log2_strict(x.shape[0])
    return _blocks(x, lambda b: bitrev_permute_axis0(
        gl_dif_(b, log_n, False), log_n), x.shape[0])


def gl_idft(x):
    """Inverse DFT of each column, natural order in and out."""
    n = x.shape[0]
    log_n = log2_strict(n)
    n_inv = gd.to_i64(Goldilocks.inv_h(n))
    return _blocks(x, lambda b: gd.mul(bitrev_permute_axis0(
        gl_dif_(b, log_n, True), log_n), n_inv), n)


def gl_coset_lde_batch(x, added_bits: int, shift: int,
                       with_coeffs: bool = False):
    """The LDE of each column of the natural-order (n, w) evaluations onto
    the coset shift·K, |K| = n·2^added_bits, rows in bit-reversed order;
    with_coeffs: also the scaled coefficients a_i = c_i·shift^i (natural
    order), which open at z as one dot product (gl/pcs.py)."""
    n, w = x.shape
    log_n = log2_strict(n)
    big = n << added_bits
    scale = powers_device(shift, n, x.device,
                          scale=Goldilocks.inv_h(n))[:, None]
    lde = torch.empty((big, w), dtype=torch.int64, device=x.device)
    coeffs = (torch.empty((n, w), dtype=torch.int64, device=x.device)
              if with_coeffs else None)
    step = _col_block(big)
    for c in range(0, w, step):
        blk = x[:, c:c + step].clone(memory_format=torch.contiguous_format)
        cf = gd.mul(bitrev_permute_axis0(gl_dif_(blk, log_n, True), log_n),
                    scale)
        del blk
        if coeffs is not None:
            coeffs[:, c:c + step] = cf
        padded = torch.zeros((big, cf.shape[1]), dtype=torch.int64,
                             device=x.device)
        padded[:n] = cf
        del cf
        lde[:, c:c + step] = gl_dif_(padded, log_n + added_bits, False)
        del padded
    return (lde, coeffs) if with_coeffs else lde
