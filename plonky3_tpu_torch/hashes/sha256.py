"""SHA-256: the hash and the padding-free compression.

Port of `plonky3_tpu/hashes/sha256.py` (sha256/src/lib.rs:14,43). The
hash wraps hashlib; `compress_arrays` is the raw compression of (8-word
state, 16-word block) pairs, batched over leading axes, for numpy uint32
arrays or int64 tensors. The numpy branch relies on uint32 wrap-around,
as the reference does. Torch on the CPU has no uint32 add, shift or
compare, so the torch branch keeps each word in the low 32 bits of an
int64: every sum and rotation is masked with 0xFFFFFFFF, and ~x is
x ^ 0xFFFFFFFF. Both give the reference's words.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

_M32 = 0xFFFFFFFF

K = np.array([  # the round constants
    0x428A2F98, 0x71374491, 0xB5C0FBCF, 0xE9B5DBA5, 0x3956C25B,
    0x59F111F1, 0x923F82A4, 0xAB1C5ED5, 0xD807AA98, 0x12835B01,
    0x243185BE, 0x550C7DC3, 0x72BE5D74, 0x80DEB1FE, 0x9BDC06A7,
    0xC19BF174, 0xE49B69C1, 0xEFBE4786, 0x0FC19DC6, 0x240CA1CC,
    0x2DE92C6F, 0x4A7484AA, 0x5CB0A9DC, 0x76F988DA, 0x983E5152,
    0xA831C66D, 0xB00327C8, 0xBF597FC7, 0xC6E00BF3, 0xD5A79147,
    0x06CA6351, 0x14292967, 0x27B70A85, 0x2E1B2138, 0x4D2C6DFC,
    0x53380D13, 0x650A7354, 0x766A0ABB, 0x81C2C92E, 0x92722C85,
    0xA2BFE8A1, 0xA81A664B, 0xC24B8B70, 0xC76C51A3, 0xD192E819,
    0xD6990624, 0xF40E3585, 0x106AA070, 0x19A4C116, 0x1E376C08,
    0x2748774C, 0x34B0BCB5, 0x391C0CB3, 0x4ED8AA4A, 0x5B9CCA4F,
    0x682E6FF3, 0x748F82EE, 0x78A5636F, 0x84C87814, 0x8CC70208,
    0x90BEFFFA, 0xA4506CEB, 0xBEF9A3F7, 0xC67178F2,
], dtype=np.uint32)

IV = np.array([
    0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
    0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19,
], dtype=np.uint32)


def sha256(data: bytes) -> bytes:
    return hashlib.sha256(data).digest()


class _NpWords:
    """uint32 words: numpy wraps sums and shifts at 32 bits."""

    @staticmethod
    def add(*xs):
        out = xs[0]
        for x in xs[1:]:
            out = out + x
        return out

    @staticmethod
    def rotr(x, r):
        return (x >> np.uint32(r)) | (x << np.uint32(32 - r))

    @staticmethod
    def shr(x, r):
        return x >> np.uint32(r)

    @staticmethod
    def inv(x):
        return ~x

    @staticmethod
    def const(k):
        return np.uint32(k)

    @staticmethod
    def stack(xs):
        return np.stack(xs, axis=-1)


class _TorchWords:
    """u32 words in the low bits of int64 tensors, masked after each sum
    and rotation."""

    @staticmethod
    def add(*xs):
        out = xs[0]
        for x in xs[1:]:
            out = out + x
        return out & _M32

    @staticmethod
    def rotr(x, r):
        return ((x >> r) | (x << (32 - r))) & _M32

    @staticmethod
    def shr(x, r):
        return x >> r

    @staticmethod
    def inv(x):
        return x ^ _M32

    @staticmethod
    def const(k):
        return int(k)

    @staticmethod
    def stack(xs):
        return torch.stack(xs, dim=-1)


def words_ops(xp):
    """The word arithmetic for `xp` (numpy or torch)."""
    return _TorchWords if xp is torch else _NpWords


def small_sigma0(o, x):
    return o.rotr(x, 7) ^ o.rotr(x, 18) ^ o.shr(x, 3)


def small_sigma1(o, x):
    return o.rotr(x, 17) ^ o.rotr(x, 19) ^ o.shr(x, 10)


def big_sigma0(o, x):
    return o.rotr(x, 2) ^ o.rotr(x, 13) ^ o.rotr(x, 22)


def big_sigma1(o, x):
    return o.rotr(x, 6) ^ o.rotr(x, 11) ^ o.rotr(x, 25)


def compress_arrays(xp, state, block):
    """One compression: state (..., 8), block (..., 16) words (big-endian
    word convention, as in the FIPS spec), numpy uint32 or torch int64
    below 2^32."""
    o = words_ops(xp)
    w = [block[..., i] for i in range(16)]
    for i in range(16, 64):
        w.append(o.add(w[i - 16], small_sigma0(o, w[i - 15]), w[i - 7],
                       small_sigma1(o, w[i - 2])))
    a, b, c, d, e, f, g, h = [state[..., i] for i in range(8)]
    for i in range(64):
        ch = (e & f) ^ (o.inv(e) & g)
        t1 = o.add(h, big_sigma1(o, e), ch, o.const(K[i]), w[i])
        maj = (a & b) ^ (a & c) ^ (b & c)
        t2 = o.add(big_sigma0(o, a), maj)
        h, g, f, e, d, c, b, a = g, f, e, o.add(d, t1), c, b, a, o.add(t1,
                                                                        t2)
    out = [a, b, c, d, e, f, g, h]
    return o.stack([o.add(state[..., i], out[i]) for i in range(8)])


def sha256_compress(state_words, block_words):
    """Padding-free compression on Python ints (Sha256Compress,
    sha256/src/lib.rs:43)."""
    with np.errstate(over="ignore"):
        out = compress_arrays(np, np.array(state_words, dtype=np.uint32),
                              np.array(block_words, dtype=np.uint32))
    return [int(x) for x in out]
