"""The keccak Merkle kernels (csrc/keccak.cu): wrappers and plain versions.

Port of `plonky3_tpu/hashes/keccak_pallas.py` (`keccak_sponge_rows_pallas`,
`keccak_compress_pallas`). Both take and return int32 tensors holding u32
words. A CPU tensor takes the plain version (torch int64 lanes with masked
right shifts); a CUDA tensor launches the kernel.
"""

from __future__ import annotations

import torch

from .. import kernels
from .keccak import RC64, keccak_f

RATE = 17  # u64 lanes per absorb block
OUT_WORDS = 8  # digest: 4 u64 lanes as 8 u32 words

_M32 = 0xFFFFFFFF


def _signed64(x: int) -> int:
    return x - (1 << 64) if x >> 63 else x


_RC_SIGNED = tuple(_signed64(rc) for rc in RC64)


def _rotl_t(x, r):
    return (x << r) | ((x >> (64 - r)) & ((1 << r) - 1))


def _lanes(words):
    """(h, w) int32 words -> list of ceil(w/2) int64 lane columns."""
    v = words.to(torch.int64) & _M32
    if v.shape[1] % 2:
        v = torch.cat([v, torch.zeros_like(v[:, :1])], dim=1)
    lo, hi = v[:, 0::2], v[:, 1::2]
    lanes = lo | (hi << 32)
    return [lanes[:, j] for j in range(lanes.shape[1])]


def _digest(st):
    """First 4 lanes -> (h, 8) int32 words (lo, hi)."""
    words = []
    for i in range(4):
        words.append(st[i] & _M32)
        words.append((st[i] >> 32) & _M32)
    return torch.stack(words, dim=1).to(torch.int32)


def _sponge(lanes, h, device):
    zero = torch.zeros(h, dtype=torch.int64, device=device)
    st = [zero] * 25
    for start in range(0, len(lanes), RATE):
        block = lanes[start:start + RATE]
        st = list(block) + st[len(block):]
        st = keccak_f(st, _rotl_t, _RC_SIGNED)
    return _digest(st)


def keccak_sponge_rows_plain(flat):
    """(h, w) int32 rows -> (h, 8) int32 digests, in plain PyTorch."""
    return _sponge(_lanes(flat), flat.shape[0], flat.device)


def keccak_compress_plain(left, right):
    """(h, 8) + (h, 8) int32 digests -> (h, 8), in plain PyTorch."""
    return keccak_sponge_rows_plain(torch.cat([left, right], dim=1))


def _check_rows(t, what, width=None):
    if t.dim() != 2 or (width is not None and t.shape[1] != width):
        raise ValueError(f"{what}: bad shape {tuple(t.shape)}")


def keccak_sponge_rows(flat):
    """Merkle leaf hash: (h, w) int32 rows -> (h, 8) int32 digests."""
    _check_rows(flat, "keccak_sponge_rows")
    if flat.device.type == "cpu":
        return keccak_sponge_rows_plain(flat)
    kernels.require_cuda_tensor(flat, "keccak_sponge_rows", torch.int32)
    h, w = flat.shape
    out = torch.empty((h, OUT_WORDS), dtype=torch.int32, device=flat.device)
    if h == 0:
        return out
    kernels.check(kernels.lib("keccak").keccak_sponge_rows(
        flat.data_ptr(), out.data_ptr(), h, w, kernels.stream_of(flat)),
        "keccak_sponge_rows")
    kernels.LAUNCHES["keccak_sponge"] += 1
    return out


def keccak_compress(left, right):
    """2-to-1 compression: (h, 8) + (h, 8) int32 digests -> (h, 8)."""
    _check_rows(left, "keccak_compress", OUT_WORDS)
    _check_rows(right, "keccak_compress", OUT_WORDS)
    if left.shape != right.shape or left.device != right.device:
        raise ValueError("keccak_compress: left and right must match")
    if left.device.type == "cpu":
        return keccak_compress_plain(left, right)
    kernels.require_cuda_tensor(left, "keccak_compress", torch.int32)
    kernels.require_cuda_tensor(right, "keccak_compress", torch.int32)
    h = left.shape[0]
    out = torch.empty((h, OUT_WORDS), dtype=torch.int32, device=left.device)
    if h == 0:
        return out
    kernels.check(kernels.lib("keccak").keccak_compress(
        left.data_ptr(), right.data_ptr(), out.data_ptr(), h,
        kernels.stream_of(left)), "keccak_compress")
    kernels.LAUNCHES["keccak_compress"] += 1
    return out
