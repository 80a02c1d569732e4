"""Keccak-256 byte-digest Merkle hashers: the circle fixtures' config.

Port of `plonky3_tpu/hashes/keccak256_mmcs.py` (`SerializingHasher
<Keccak256Hash>` leaves and `CompressionFunctionFromHasher<Keccak256Hash,
2, 32>` nodes, uni-stark/tests/fib_air.rs:203-209). A digest is 32 raw
bytes: a (h, 32) array of byte values, a tuple of 32 ints on the host. A
row serializes its canonical u32 words as little-endian bytes (Mersenne31
serde, mersenne_31.rs:180-185).

The reference hashes these on the host (a conformance target, not the
benchmark's path, which is the u64-lane KeccakF sponge); so does the
port, every row by the C library of `native/` (`keccak256_rows`, the
reference's route), and the device methods move the digests to the
matrices' device. `keccak256_rows_np` (numpy batches of equal-length
messages) is the plain version the tests hold it against.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import native
from .keccak import keccak256, keccak_f1600_plain

_RATE = 136


def keccak256_rows_np(msgs: np.ndarray) -> np.ndarray:
    """Keccak-256 of each row of an (h, L) uint8 array: (h, 32) uint8."""
    h, n = msgs.shape
    total = n + _RATE - n % _RATE
    buf = np.zeros((h, total), dtype=np.uint8)
    buf[:, :n] = msgs
    buf[:, n] ^= 0x01
    buf[:, -1] ^= 0x80
    words = buf.view("<u8")
    st = np.zeros((h, 25), dtype=np.uint64)
    for off in range(0, total // 8, _RATE // 8):
        st[:, :_RATE // 8] ^= words[:, off:off + _RATE // 8]
        st = keccak_f1600_plain(st)
    return np.ascontiguousarray(st[:, :4]).astype("<u8").view(
        np.uint8).reshape(h, 32)


def _rows_to_bytes(flat: np.ndarray) -> np.ndarray:
    """(h, W) u32 words -> (h, 4W) uint8, little-endian."""
    return np.ascontiguousarray(flat.astype("<u4")).view(np.uint8).reshape(
        flat.shape[0], -1)


def _to_device(arr, like):
    return torch.from_numpy(arr.astype(np.int64)).to(like.device)


@dataclass(frozen=True)
class Keccak256FieldHasher:
    """Leaf hasher: keccak-256 of each row's bytes."""

    F: object  # the field (Mersenne31: the wire form is the value)

    digest_is_field = False

    def hash_rows_np(self, mats):
        h = mats[0].shape[0]
        flat = np.concatenate([np.asarray(m).reshape(h, -1) for m in mats],
                              axis=1)
        return native.keccak256_rows(_rows_to_bytes(flat)).astype(np.uint32)

    def hash_rows_device(self, mats):
        """Same-height (h, ...) int64 tensors -> (h, 32) int64 digests on
        their device, hashed on the host."""
        return _to_device(self.hash_rows_np(
            [m.cpu().numpy() for m in mats]), mats[0])

    hash_rows_words = hash_rows_device

    def hash_iter_host(self, elems):
        data = b"".join(int(x).to_bytes(4, "little") for x in elems)
        return tuple(keccak256(data))


@dataclass(frozen=True)
class Keccak256Compressor:
    """compress(l, r) = keccak256(l_bytes || r_bytes)."""

    def compress_np(self, left, right):
        msgs = np.concatenate([np.asarray(left, dtype=np.uint8),
                               np.asarray(right, dtype=np.uint8)], axis=1)
        return native.keccak256_rows(msgs).astype(np.uint32)

    def compress_device(self, left, right):
        return _to_device(self.compress_np(left.cpu().numpy(),
                                           right.cpu().numpy()), left)

    def compress_host(self, left, right):
        data = (bytes(int(x) & 0xFF for x in left)
                + bytes(int(x) & 0xFF for x in right))
        return tuple(keccak256(data))
