"""BLAKE3 compression and hashing, on 32-bit word lanes.

Port of `plonky3_tpu/hashes/blake3.py` (BLAKE3 spec §2.1-2.3; the
reference crate wraps the upstream implementation, blake3/src/lib.rs:9).
The compression runs batched, one state per row, on numpy uint32 arrays
(host, exact) or on int64 tensors holding u32 words (`compress_device`);
every sum and rotation is masked to 32 bits, so both give the same words.
`blake3` hashes inputs of any length through the chunk and parent tree.

The same round structure feeds `models/blake3_air.py`.
"""

from __future__ import annotations

import numpy as np

IV = np.array(
    [
        0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
        0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19,
    ],
    dtype=np.uint32,
)

# flags
CHUNK_START = 1 << 0
CHUNK_END = 1 << 1
PARENT = 1 << 2
ROOT = 1 << 3

# message schedule permutation applied between rounds
_PERM = [2, 6, 3, 10, 7, 0, 4, 13, 1, 11, 12, 5, 9, 14, 15, 8]

_MASK = 0xFFFFFFFF


def _rotr(x, r):
    return ((x >> r) | (x << (32 - r))) & _MASK


def _g(state, a, b, c, d, mx, my):
    state[a] = (state[a] + state[b] + mx) & _MASK
    state[d] = _rotr(state[d] ^ state[a], 16)
    state[c] = (state[c] + state[d]) & _MASK
    state[b] = _rotr(state[b] ^ state[c], 12)
    state[a] = (state[a] + state[b] + my) & _MASK
    state[d] = _rotr(state[d] ^ state[a], 8)
    state[c] = (state[c] + state[d]) & _MASK
    state[b] = _rotr(state[b] ^ state[c], 7)


def compress_arrays(xp, cv, block_words, counter_lo, counter_hi,
                    block_len, flags):
    """BLAKE3 compression of (..., 8) cv and (..., 16) block word arrays;
    `xp` is numpy (uint32 arrays) or torch (int64 tensors of u32 words).
    counter/block_len/flags: Python ints or (...,) arrays of that kind.
    Returns the full 16-word output (truncate to 8 for chaining)."""
    m = [block_words[..., i] for i in range(16)]
    zeros = xp.zeros_like(m[0])

    def lane(x):
        return zeros + (int(x) if np.isscalar(x) else x)

    state = [cv[..., i] for i in range(8)]
    state += [zeros + int(IV[i]) for i in range(4)]
    state += [lane(counter_lo), lane(counter_hi), lane(block_len),
              lane(flags)]
    for rnd in range(7):
        _g(state, 0, 4, 8, 12, m[0], m[1])
        _g(state, 1, 5, 9, 13, m[2], m[3])
        _g(state, 2, 6, 10, 14, m[4], m[5])
        _g(state, 3, 7, 11, 15, m[6], m[7])
        _g(state, 0, 5, 10, 15, m[8], m[9])
        _g(state, 1, 6, 11, 12, m[10], m[11])
        _g(state, 2, 7, 8, 13, m[12], m[13])
        _g(state, 3, 4, 9, 14, m[14], m[15])
        if rnd < 6:
            m = [m[_PERM[i]] for i in range(16)]
    out = [state[i] ^ state[i + 8] for i in range(8)] + [
        state[i + 8] ^ cv[..., i] for i in range(8)
    ]
    return xp.stack(out, -1)


def compress_device(cv, block_words, counter_lo=0, counter_hi=0,
                    block_len=64, flags=0):
    """Batched compression of int64 tensors of u32 words: cv (..., 8),
    block (..., 16); (..., 16) out."""
    import torch

    return compress_arrays(torch, cv, block_words, counter_lo, counter_hi,
                           block_len, flags)


def _words_le(data: bytes) -> list[int]:
    if len(data) % 4:
        raise ValueError("a block of whole words")
    return [int.from_bytes(data[i:i + 4], "little")
            for i in range(0, len(data), 4)]


def _compress_host(cv, block_words, counter, block_len, flags):
    cv_a = np.array(cv, dtype=np.uint32)
    bw = np.array(block_words, dtype=np.uint32)
    with np.errstate(over="ignore"):
        out = compress_arrays(np, cv_a, bw, counter & _MASK, counter >> 32,
                              block_len, flags)
    return [int(x) for x in out]


def blake3(data: bytes, out_len: int = 32) -> bytes:
    """BLAKE3 hash (host, exact; any length through the chunk tree)."""
    CHUNK = 1024
    chunks = [data[i:i + CHUNK] for i in range(0, len(data), CHUNK)]
    if not chunks:
        chunks = [b""]

    def chunk_cv(chunk: bytes, counter: int, is_only: bool):
        blocks = [chunk[i:i + 64] for i in range(0, len(chunk), 64)]
        if not blocks:
            blocks = [b""]
        cv = list(IV)
        for i, blk in enumerate(blocks):
            padded = blk + b"\x00" * (64 - len(blk))
            flags = 0
            if i == 0:
                flags |= CHUNK_START
            if i == len(blocks) - 1:
                flags |= CHUNK_END
                if is_only:
                    flags |= ROOT
            out = _compress_host(cv, _words_le(padded), counter, len(blk),
                                 flags)
            if i == len(blocks) - 1 and is_only:
                return out  # root output (16 words for XOF)
            cv = out[:8]
        return cv

    def to_bytes(words):
        return b"".join(int(x).to_bytes(4, "little") for x in words)

    if len(chunks) == 1:
        return to_bytes(chunk_cv(chunks[0], 0, True))[:out_len]

    # parent tree: the left subtree takes the largest power of two below
    # the count (spec §2.1)
    cvs = [chunk_cv(c, i, False) for i, c in enumerate(chunks)]

    def build(nodes, root):
        if len(nodes) == 1:
            return nodes[0]
        split = 1 << (len(nodes) - 1).bit_length() - 1
        left = build(nodes[:split], False)
        right = build(nodes[split:], False)
        return _compress_host(list(IV), left[:8] + right[:8], 0, 64,
                              PARENT | (ROOT if root else 0))

    return to_bytes(build(cvs, True))[:out_len]
