"""Keccak-f[1600] and Keccak-256.

Port of `plonky3_tpu/hashes/keccak.py` (keccak/src/lib.rs:70 KeccakF,
:100 Keccak256Hash). The host paths go through the C library of
`native/`, as the reference's do: `keccak256` (the transcript's),
`keccak_f1600_np` and `keccak_f1600_arrays` (the host keccak-f batches)
and `keccak_f1600_host`. One round function `keccak_f` runs on (25, ...)
lanes, lanes first: numpy uint64 and torch int64 tensors; it makes the
plain versions (`keccak256_plain`, `keccak_f1600_plain`,
`keccak256_np_batch`) that the tests hold the C functions against, and
the plain versions of the kernels in `keccak_cuda.py`. The CUDA kernels in
csrc/keccak.cu follow the same round structure.

Lanes are indexed x + 5·y.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import native

RC64 = (
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A,
    0x8000000080008000, 0x000000000000808B, 0x0000000080000001,
    0x8000000080008081, 0x8000000000008009, 0x000000000000008A,
    0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089,
    0x8000000000008003, 0x8000000000008002, 0x8000000000000080,
    0x000000000000800A, 0x800000008000000A, 0x8000000080008081,
    0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
)
# rho offsets and pi lane order along the rho-pi cycle starting at lane 1
ROTC = (1, 3, 6, 10, 15, 21, 28, 36, 45, 55, 2, 14, 27, 41, 56, 8, 25, 43,
        62, 18, 39, 61, 20, 44)
PILN = (10, 7, 11, 17, 18, 3, 5, 16, 8, 21, 24, 4, 15, 23, 19, 13, 12, 2,
        20, 14, 22, 9, 6, 1)

# rho and pi as one gather and one rotation of all 25 lanes: lane PILN[i]
# takes lane PILN[i - 1] (lane 1 for i = 0) rotated left by ROTC[i]
_PI_SRC = [0] * 25
_RHO = [0] * 25
for _i, _j in enumerate(PILN):
    _PI_SRC[_j] = PILN[_i - 1] if _i else 1
    _RHO[_j] = ROTC[_i]
_TABLES = {}


def _signed64(x: int) -> int:
    return x - (1 << 64) if x >> 63 else x


def _tables(st):
    """The gathers, rotations and iota constants in `st`'s lane type:
    numpy uint64, or torch int64 on `st`'s device (cached per device)."""
    key = "np" if isinstance(st, np.ndarray) else st.device
    if key not in _TABLES:
        rows = ([1, 2, 3, 4, 0], [2, 3, 4, 0, 1], [4, 0, 1, 2, 3])
        masks = [(1 << r) - 1 for r in _RHO]
        right = [(64 - r) % 64 for r in _RHO]
        if key == "np":
            arr = [np.array(t, np.uint64).reshape(25, 1)
                   for t in (_RHO, right, masks)]
            _TABLES[key] = ([np.array(r) for r in rows], np.array(_PI_SRC),
                            *arr, np.uint64(1), np.uint64(63),
                            tuple(np.uint64(rc) for rc in RC64))
        else:
            arr = [torch.tensor(t, dtype=torch.int64,
                                device=key).reshape(25, 1)
                   for t in (_RHO, right, masks)]
            _TABLES[key] = ([torch.tensor(r, device=key) for r in rows],
                            torch.tensor(_PI_SRC, device=key), *arr, 1, 63,
                            tuple(_signed64(rc) for rc in RC64))
    return _TABLES[key]


def keccak_f(st):
    """The 24 rounds on (25, ...) lanes (x + 5·y) first, each lane a row
    of states: numpy uint64, or torch int64 with the right shifts masked
    (int64 shifts are arithmetic)."""
    (x1, x2, x4), src, rho, rho_right, rho_mask, one, s63, rcs = _tables(st)
    rest = tuple(st.shape[1:])
    st = st.reshape((25, -1))
    for rc in rcs:
        s = st.reshape((5, 5, -1))  # [y, x, state]
        c = s[0] ^ s[1] ^ s[2] ^ s[3] ^ s[4]
        c1 = c[x1]
        d = c[x4] ^ ((c1 << one) | ((c1 >> s63) & one))
        b = (s ^ d).reshape((25, -1))[src]
        b = ((b << rho) | ((b >> rho_right) & rho_mask)).reshape((5, 5, -1))
        st = (b ^ (~b[:, x1] & b[:, x2])).reshape((25, -1))
        st[0] ^= rc
    return st.reshape((25,) + rest)


def keccak_f1600_host(lanes) -> list:
    """lanes: 25 Python ints (u64) -> the permuted lanes."""
    return [int(x) for x in native.keccakf_batch_u64(
        np.array(lanes, dtype=np.uint64))]


def keccak256(data: bytes) -> bytes:
    """Keccak-256 (original 0x01 padding, not SHA3-256), in C."""
    return native.keccak256(data)


def keccak256_plain(data: bytes) -> bytes:
    """`keccak256` by the numpy round function."""
    rate = 136
    padded = bytearray(data)
    padded += b"\x00" * (rate - len(padded) % rate)
    padded[len(data)] ^= 0x01
    padded[-1] ^= 0x80
    words = np.frombuffer(bytes(padded), dtype="<u8").astype(np.uint64)
    st = np.zeros(25, np.uint64)
    for off in range(0, words.shape[0], rate // 8):
        st[:rate // 8] ^= words[off:off + rate // 8]
        st = keccak_f(st)
    return st[:4].astype("<u8").tobytes()


# ---- numpy uint64 (batched host hashing) ---------------------------------
def keccak_f1600_np(st: np.ndarray) -> np.ndarray:
    """Batched permutation of (..., 25) uint64 states, in C."""
    return native.keccakf_batch_u64(st)


def keccak_f1600_plain(st: np.ndarray) -> np.ndarray:
    """`keccak_f1600_np` through torch on the CPU: its threads outrun
    numpy on a batch (2^16 states: ~0.14 s against numpy's ~0.3 s, 8
    cores)."""
    lanes = np.ascontiguousarray(np.moveaxis(st, -1, 0)).view(np.int64)
    out = keccak_f(torch.from_numpy(lanes)).numpy().view(np.uint64)
    return np.moveaxis(out, 0, -1)


def keccak_f1600_arrays(lo: np.ndarray, hi: np.ndarray):
    """(..., 25) uint32 lane halves (lane = lo | hi << 32) -> permuted
    halves (the reference's lane-pair interface)."""
    st = lo.astype(np.uint64) | (hi.astype(np.uint64) << np.uint64(32))
    st = keccak_f1600_np(st)
    return ((st & np.uint64(0xFFFFFFFF)).astype(np.uint32),
            (st >> np.uint64(32)).astype(np.uint32))


def keccak256_np_batch(prefix: bytes, candidates: np.ndarray) -> np.ndarray:
    """Keccak-256 of (prefix || candidate as 4 LE bytes) for a batch of
    u32 candidates: (batch, 32) uint8 digests."""
    rate = 136
    n = candidates.shape[0]
    msg_len = len(prefix) + 4
    total = msg_len + rate - msg_len % rate
    buf = np.zeros((n, total), dtype=np.uint8)
    if prefix:
        buf[:, :len(prefix)] = np.frombuffer(prefix, dtype=np.uint8)
    buf[:, len(prefix):msg_len] = (
        candidates.astype("<u4").view(np.uint8).reshape(n, 4))
    buf[:, msg_len] ^= 0x01
    buf[:, -1] ^= 0x80
    words = buf.view("<u8")  # (n, total / 8)
    st = np.zeros((n, 25), dtype=np.uint64)
    for off in range(0, total // 8, rate // 8):
        st[:, :rate // 8] ^= words[:, off:off + rate // 8]
        st = keccak_f1600_plain(st)
    return np.ascontiguousarray(st[:, :4]).astype("<u8").view(
        np.uint8).reshape(n, 32)
