"""Bit utilities (port of `plonky3_tpu/utils/bits.py`; util/src/lib.rs
log2_strict_usize:78, reverse_bits_len:203, reverse_slice_index_bits:239).
"""

from __future__ import annotations

import numpy as np
import torch


def log2_strict(n: int) -> int:
    """log2 of a power of two; raises otherwise."""
    k = n.bit_length() - 1
    if n <= 0 or (1 << k) != n:
        raise ValueError(f"{n} is not a positive power of two")
    return k


def log2_ceil(n: int) -> int:
    if n <= 0:
        raise ValueError("n must be positive")
    return (n - 1).bit_length()


def reverse_bits_len(x: int, bit_len: int) -> int:
    """Reverse the low `bit_len` bits of x."""
    r = 0
    for _ in range(bit_len):
        r = (r << 1) | (x & 1)
        x >>= 1
    return r


def bitrev_indices(log_n: int) -> np.ndarray:
    """Length-2^log_n int64 array: i -> reverse_bits_len(i, log_n)."""
    idx = np.arange(1 << log_n, dtype=np.int64)
    r = np.zeros_like(idx)
    for _ in range(log_n):
        r = (r << 1) | (idx & 1)
        idx >>= 1
    return r


def bitrev_permute_axis0(x: torch.Tensor, log_n: int) -> torch.Tensor:
    """Bit-reversal permutation of axis 0 (an involution) as one row
    gather."""
    if log_n == 0:
        return x
    idx = torch.from_numpy(bitrev_indices(log_n)).to(x.device)
    return x.index_select(0, idx)
