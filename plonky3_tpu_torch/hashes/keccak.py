"""Keccak-f[1600] and Keccak-256.

Port of `plonky3_tpu/hashes/keccak.py` (keccak/src/lib.rs:70 KeccakF,
:100 Keccak256Hash). One round function `keccak_f` runs on a list of 25
lanes of any type with ^, &, ~ and a rotate: Python ints (the transcript's
keccak256), numpy uint64 arrays (the batched proof-of-work search) and
torch int64 tensors (the plain versions of the Merkle kernels, where the
right shift is masked because int64 shifts are arithmetic). The CUDA
kernel in csrc/keccak.cu follows the same round structure.

Lanes are indexed x + 5·y.
"""

from __future__ import annotations

import numpy as np

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

_M64 = (1 << 64) - 1


def keccak_f(st: list, rotl, round_constants) -> list:
    """The 24 rounds on a list of 25 lanes; `rotl(x, r)` rotates a lane
    left by 0 < r < 64, `round_constants` holds the 24 iota constants in
    the lane type."""
    st = list(st)
    for rc in round_constants:
        bc = [st[i] ^ st[i + 5] ^ st[i + 10] ^ st[i + 15] ^ st[i + 20]
              for i in range(5)]
        for i in range(5):
            t = bc[(i + 4) % 5] ^ rotl(bc[(i + 1) % 5], 1)
            for j in range(0, 25, 5):
                st[j + i] = st[j + i] ^ t
        t = st[1]
        for i in range(24):
            j = PILN[i]
            nxt = st[j]
            st[j] = rotl(t, ROTC[i])
            t = nxt
        for j in range(0, 25, 5):
            row = st[j:j + 5]
            for i in range(5):
                st[j + i] = row[i] ^ (~row[(i + 1) % 5] & row[(i + 2) % 5])
        st[0] = st[0] ^ rc
    return st


# ---- Python ints (host transcript) ---------------------------------------
def _rotl_int(x, r):
    return ((x << r) | (x >> (64 - r))) & _M64


def keccak_f1600_host(lanes) -> list:
    """lanes: 25 Python ints (u64) -> the permuted lanes."""
    out = keccak_f(list(lanes), _rotl_int, RC64)
    return [x & _M64 for x in out]


def keccak256(data: bytes) -> bytes:
    """Keccak-256 (original 0x01 padding, not SHA3-256)."""
    rate = 136
    padded = bytearray(data)
    padded += b"\x00" * (rate - len(padded) % rate)
    padded[len(data)] ^= 0x01
    padded[-1] ^= 0x80
    lanes = [0] * 25
    for off in range(0, len(padded), rate):
        for i in range(rate // 8):
            lanes[i] ^= int.from_bytes(padded[off + 8 * i:off + 8 * i + 8],
                                       "little")
        lanes = keccak_f1600_host(lanes)
    return b"".join(lanes[i].to_bytes(8, "little") for i in range(4))


# ---- numpy uint64 (batched host hashing) ---------------------------------
_RC_NP = tuple(np.uint64(rc) for rc in RC64)


def _rotl_np(x, r):
    return (x << np.uint64(r)) | (x >> np.uint64(64 - r))


def keccak_f1600_np(st: np.ndarray) -> np.ndarray:
    """Batched permutation of (..., 25) uint64 states."""
    out = keccak_f([st[..., i] for i in range(25)], _rotl_np, _RC_NP)
    return np.stack(out, axis=-1)


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
        st = keccak_f1600_np(st)
    return np.ascontiguousarray(st[:, :4]).astype("<u8").view(
        np.uint8).reshape(n, 32)
