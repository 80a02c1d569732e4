"""The Poseidon2-Goldilocks kernels (csrc/goldilocks.cu): wrappers.

The JAX package computes these in jnp (`plonky3_tpu/gl/merkle.py:55`
GLPoseidonSponge.hash_rows_device, `:125` GLCompressor.compress_device,
`plonky3_tpu/gl/stark.py:62` the grind's batches, all over
`plonky3_tpu/fields/goldilocks_device.py:233`); the source says why they
are kernels here. Every tensor is int64, one Goldilocks element a word
(`gl/field.py`). A CPU tensor takes the plain version
(`fields/goldilocks_device.py`); a CUDA tensor launches the kernel.

- `gl_sponge_rows`: the leaf hash, (h, w) rows -> (h, 4) digests.
- `gl_compress`: one tree level, (n, 4) + (n, 4) -> (n, 4); either side
  may be a row-strided view (the two children of a reshaped level).
- `gl_permute`: (n, 8) states -> their permutations.
"""

from __future__ import annotations

import torch

from .. import kernels
from ..fields import goldilocks_device as gd
from .constants.poseidon2_goldilocks_constants import (
    MATRIX_DIAG_8,
    RC8_EXTERNAL_FINAL,
    RC8_EXTERNAL_INITIAL,
    RC8_INTERNAL,
)

_TABLES = {}


def kernel_table(device):
    """The kernels' constants on `device` (int64, u64 bits): the initial
    full rounds' (4 x 8), the partial rounds' (22), the final full
    rounds' (4 x 8), the internal diagonal (8)."""
    hit = _TABLES.get(device)
    if hit is None:
        vals = ([x for r in RC8_EXTERNAL_INITIAL for x in r]
                + list(RC8_INTERNAL)
                + [x for r in RC8_EXTERNAL_FINAL for x in r]
                + list(MATRIX_DIAG_8))
        hit = _TABLES[device] = torch.tensor(
            [gd.to_i64(v) for v in vals], dtype=torch.int64, device=device)
    return hit


def _rows_of(t, what, width=None):
    if t.dim() != 2 or (width is not None and t.shape[1] != width):
        raise ValueError(f"{what}: expected (n, {width or 'w'}) rows, got "
                         f"{tuple(t.shape)}")
    if t.dtype != torch.int64:
        raise ValueError(f"{what}: expected int64, got {t.dtype}")


def gl_sponge_rows(mat):
    """(h, w) int64 rows -> (h, 4) digests."""
    _rows_of(mat, "gl_sponge_rows")
    if mat.device.type == "cpu":
        return gd.gl_sponge_rows_plain(mat)
    kernels.require_cuda_tensor(mat, "gl_sponge_rows", torch.int64)
    h, w = mat.shape
    out = torch.empty((h, gd.OUT), dtype=torch.int64, device=mat.device)
    if h == 0:
        return out
    kernels.check(kernels.lib("goldilocks").gl_sponge_rows(
        mat.data_ptr(), h, w, out.data_ptr(),
        kernel_table(mat.device).data_ptr(), kernels.stream_of(mat)),
        "gl_sponge_rows")
    kernels.LAUNCHES["gl_sponge"] += 1
    return out


def _row_stride(t, what):
    """The element stride between t's rows; each row contiguous."""
    if t.stride(1) != 1:
        raise ValueError(f"{what}: each row must be contiguous")
    return t.stride(0)


def gl_compress(left, right):
    """2-to-1 compression of (n, 4) digest rows."""
    _rows_of(left, "gl_compress", gd.OUT)
    _rows_of(right, "gl_compress", gd.OUT)
    if left.shape != right.shape or left.device != right.device:
        raise ValueError("gl_compress: left and right must match")
    if left.device.type == "cpu":
        return gd.gl_compress_plain(left, right)
    if left.device.type != "cuda":
        raise ValueError(f"gl_compress: expected a CUDA tensor, got "
                         f"{left.device}")
    n = left.shape[0]
    out = torch.empty((n, gd.OUT), dtype=torch.int64, device=left.device)
    if n == 0:
        return out
    kernels.check(kernels.lib("goldilocks").gl_compress(
        left.data_ptr(), _row_stride(left, "gl_compress"),
        right.data_ptr(), _row_stride(right, "gl_compress"), n,
        out.data_ptr(), kernel_table(left.device).data_ptr(),
        kernels.stream_of(left)), "gl_compress")
    kernels.LAUNCHES["gl_compress"] += 1
    return out


def gl_permute(states):
    """(n, 8) int64 states -> their permutations (a new tensor)."""
    _rows_of(states, "gl_permute", gd.WIDTH)
    if states.device.type == "cpu":
        return gd.poseidon2_goldilocks_plain(states)
    kernels.require_cuda_tensor(states, "gl_permute", torch.int64)
    out = states.clone()
    if out.shape[0] == 0:
        return out
    kernels.check(kernels.lib("goldilocks").gl_permute(
        out.data_ptr(), out.shape[0], kernel_table(out.device).data_ptr(),
        kernels.stream_of(out)), "gl_permute")
    kernels.LAUNCHES["gl_permute"] += 1
    return out
