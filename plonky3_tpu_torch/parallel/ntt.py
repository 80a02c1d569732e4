"""The sharded NTT and coset LDE over `torch.distributed`.

Port of `plonky3_tpu/parallel/ntt.py` (Radix2DitParallel's two-half
decomposition, dft/src/radix_2_dit_parallel.rs:22-28). Viewing the
length-n axis as (A, B), the first log A DIF stages pair rows within a
column of that view and the other log B stages within a row. So a DIF
of size n is: a DIF of size A down every column, a twiddle ω^(b·k1) on
column b's output k1 (natural order k1, at bit-reversed position), then a
DIF of size B along every row; the output's position a·B + j is the
reference's. Each rank holds B/world whole columns for the first half and
A/world whole rows for the second, and `route_rows` moves the matrix
between the two layouts (an all_to_all). Both halves are ordinary batched
DIFs through `ops/ntt.py::_dif`: K1/K2 on a CUDA tensor, the plain radix-2
network on a CPU one, the same bits.

The coset LDE composes the inverse transform, a bit reversal (one more
all_to_all), the shift powers, the zero pad (the routing places each
coefficient straight into the forward transform's column layout) and the
forward transform. Where the matrix is too short for every rank to hold
whole columns and rows (the reference's `log_a <= 0` and more), every rank
gathers the matrix and runs `coset_lde_batch` itself.
"""

from __future__ import annotations

import torch

from ..ops.ntt import _dif, coset_lde_batch, powers_device
from ..utils.bits import bitrev_indices, log2_strict
from . import all_gather_rows, route_rows, world_rank

_POWERS: dict = {}


def split(log_n: int, log_w: int):
    """log A of the (A, B) view, as the reference picks it: A covers the
    cross-device stages and B holds at least `world` columns. None when
    some rank would hold a part of a column or of a row."""
    log_a = min(max(log_w, log_n // 2), log_n - log_w)
    if log_a <= 0 or log_a < log_w or log_n - log_a < log_w:
        return None
    return log_a


def _powers(F, g, n, device):
    key = (F.name, g, n, str(device))
    hit = _POWERS.get(key)
    if hit is None:
        hit = _POWERS[key] = powers_device(F, g, n, device)
    return hit


def _batched_dif(F, x, log_len, inverse):
    """DIF along axis 1 of an (m, 2^log_len, w) tensor: (m, 2^log_len, w)
    with each length-2^log_len sequence in bit-reversed order."""
    m, ln, w = x.shape
    y = x.permute(1, 0, 2).reshape(ln, m * w)
    y = _dif(F, y, log_len, inverse)
    return y.reshape(ln, m, w).permute(1, 0, 2)


def _transposed(log_a, log_b):
    """Position a·B + b of the natural order -> b·A + a of the column
    layout."""
    def dst_of(i):
        return (i & ((1 << log_b) - 1)) << log_a | (i >> log_b)
    return dst_of


def _untransposed(log_a, log_b):
    def dst_of(t):
        return (t & ((1 << log_a) - 1)) << log_b | (t >> log_a)
    return dst_of


def _column_phase(F, cols, log_n, log_a, inverse, b0):
    """The first half on this rank's columns b0.. (a (B/world, A, w)
    tensor, column b's A values in natural order): a DIF of size A down
    each, then the twiddle ω^(b·k1) at output position bitrev(k1)."""
    n = 1 << log_n
    nb, A, w = cols.shape
    out = _batched_dif(F, cols, log_a, inverse)
    g = F.two_adic_generator_h(log_n)
    if inverse:
        g = F.inv_h(g)
    k1 = torch.from_numpy(bitrev_indices(log_a)).to(cols.device)
    b = torch.arange(b0, b0 + nb, device=cols.device)
    tw = _powers(F, g, n, cols.device)[(b[:, None] * k1[None, :]) % n]
    return F.mul(out, tw[:, :, None])


def dif_sharded(F, local, log_n: int, inverse: bool, group=None,
                log_a: int = None):
    """The DIF network of size 2^log_n (natural rows in, bit-reversed rows
    out, as `ops/ntt.py::_dif`) on a row-sharded (n/world, w) int64
    matrix; returns this rank's block of the output rows. `log_a` must be
    `split(log_n, log world)` (given: the caller routed the input into
    the column layout already, a (B/world·A, w) block)."""
    world, rank = world_rank(group)
    log_w = log2_strict(world)
    w = local.shape[1]
    if log_a is None:
        log_a = split(log_n, log_w)
        if log_a is None:
            raise ValueError(f"2^{log_n} rows are too few for {world} "
                             f"ranks")
        local = route_rows(local, _transposed(log_a, log_n - log_a),
                           (1 << log_n) // world, (1 << log_n) // world,
                           group)
    log_b = log_n - log_a
    A, B = 1 << log_a, 1 << log_b
    nb = B // world
    cols = _column_phase(F, local.reshape(nb, A, w), log_n, log_a, inverse,
                         rank * nb)
    rows = route_rows(cols.reshape(nb * A, w), _untransposed(log_a, log_b),
                      nb * A, nb * A, group)
    out = _batched_dif(F, rows.reshape(A // world, B, w), log_b, inverse)
    return out.reshape(A // world * B, w)


def coset_lde_batch_sharded(F, local, added_bits: int, shift_std: int,
                            group=None):
    """The row-sharded coset LDE: each rank passes its contiguous block of
    the natural-order (n, w) int64 Montgomery matrix and gets its
    contiguous block of the bit-reversed (n·2^added_bits, w) LDE rows, the
    same bits as `ops/ntt.py::coset_lde_batch` (two_adic_pcs.rs:300)."""
    world, rank = world_rank(group)
    log_w = log2_strict(world)
    m = local.shape[0]
    log_n = log2_strict(m * world)
    log_N = log_n + added_bits
    n, N = 1 << log_n, 1 << log_N
    log_a = split(log_n, log_w)
    if log_a is None:
        # too small to shard: every rank runs the whole LDE
        full = all_gather_rows(local, group)
        lde = coset_lde_batch(F, full, added_bits, shift_std)
        return lde[rank * (N // world):(rank + 1) * (N // world)]

    coeffs_br = dif_sharded(F, local, log_n, True, group)
    # bit reversal, then the shift powers with n^-1 folded in
    rev = bitrev_indices(log_n)
    coeffs = route_rows(coeffs_br, lambda i: rev[i], m, m, group)
    sp = powers_device(F, shift_std, n, local.device, scale_std=F.inv_h(n))
    coeffs = F.mul(coeffs, sp[rank * m:(rank + 1) * m, None])
    # the zero pad: coefficient c goes to the forward transform's column
    # layout of N rows at once
    log_a2 = split(log_N, log_w)
    cols = route_rows(coeffs, _transposed(log_a2, log_N - log_a2), m,
                      N // world, group)
    return dif_sharded(F, cols, log_N, False, group, log_a=log_a2)
