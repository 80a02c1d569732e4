"""The keccak Merkle kernels (csrc/keccak.cu): wrappers and plain versions.

Port of `plonky3_tpu/hashes/keccak_pallas.py` (`keccak_sponge_rows_pallas`,
`keccak_compress_pallas`). All take and return int32 tensors holding u32
words. A CPU tensor takes the plain version (`hashes/keccak.py::keccak_f`
on a (25, h) int64 tensor, lanes first); a CUDA tensor launches the
kernel.

- `keccak_sponge_rows`: the leaf hash, (h, w) rows -> (h, 8) digests.
- `keccak_compress`: one tree level, (h, 8) + (h, 8) -> (h, 8).
- `keccak_merkle_ladder`: every level of a tree above n digests, in
  `len(ladder_plan(n))` launches of a kernel that builds up to
  LADDER_LOG_NODES + 1 levels per launch (two for a 2^18-leaf tree). Its
  plain version is `keccak_compress_plain` applied level by level.

The transcript's keccak-256 (`challenger/device_serializing.py`; the JAX
counterparts are jnp code, not TPU kernels):

- `keccak256_chain`: (n,) words -> the (k, 8) digests d1 = keccak256(words),
  d_{i+1} = keccak256(d_i), in one launch.
- `keccak_grind`: the smallest proof-of-work witness, as a (1,) tensor on
  the device, in one launch of a grid sized to the card, searching in
  ascending rounds.
"""

from __future__ import annotations

import torch

from .. import kernels
from .keccak import keccak_f

RATE = 17  # u64 lanes per absorb block
RATE_WORDS = 34  # keccak-256 rate, 136 bytes, as u32 words
OUT_WORDS = 8  # digest: 4 u64 lanes as 8 u32 words
LADDER_LOG_NODES = 9  # log2 of LADDER_NODES in csrc/keccak.cu

_M32 = 0xFFFFFFFF


def _lanes(words):
    """(h, w) int32 words -> (ceil(w/2), h) int64 lanes, lanes first."""
    v = words.to(torch.int64) & _M32
    if v.shape[1] % 2:
        v = torch.cat([v, torch.zeros_like(v[:, :1])], dim=1)
    return (v[:, 0::2] | (v[:, 1::2] << 32)).T


def _digest(st):
    """A (25, h) state's first 4 lanes -> (h, 8) int32 words (lo, hi)."""
    lanes = st[:4].T
    return torch.stack([lanes & _M32, (lanes >> 32) & _M32],
                       dim=2).reshape(-1, OUT_WORDS).to(torch.int32)


def keccak_sponge_rows_plain(flat):
    """(h, w) int32 rows -> (h, 8) int32 digests, in plain PyTorch:
    overwrite-mode absorb of RATE lanes a block."""
    lanes = _lanes(flat)
    st = torch.zeros((25, flat.shape[0]), dtype=torch.int64,
                     device=flat.device)
    for start in range(0, lanes.shape[0], RATE):
        block = lanes[start:start + RATE]
        st = keccak_f(torch.cat([block, st[block.shape[0]:]]))
    return _digest(st)


def keccak_compress_plain(left, right):
    """(h, 8) + (h, 8) int32 digests -> (h, 8), in plain PyTorch."""
    return keccak_sponge_rows_plain(torch.cat([left, right], dim=1))


def keccak_merkle_ladder_plain(digests, top=1):
    """(n, 8) int32 digests -> the levels above them up to `top` nodes,
    bottom-up in one (n - top, 8) tensor, in plain PyTorch."""
    levels, cur = [], digests
    while cur.shape[0] > top:
        pairs = cur.reshape(-1, 2, OUT_WORDS)
        cur = keccak_compress_plain(pairs[:, 0], pairs[:, 1])
        levels.append(cur)
    return torch.cat(levels) if levels else digests[:0]


def _keccak256_rows(msgs):
    """keccak-256 of each row of an (h, n) int64 tensor of u32 words ->
    (h, 8) int32 digest words: xor absorb in blocks of RATE_WORDS words,
    0x01 after the message, 0x80000000 into the last word."""
    h, n = msgs.shape
    nb = n // RATE_WORDS + 1
    buf = torch.zeros((h, nb * RATE_WORDS), dtype=torch.int64,
                      device=msgs.device)
    buf[:, :n] = msgs
    buf[:, n] ^= 1
    buf[:, -1] ^= 0x80000000
    pairs = buf.view(h, nb, RATE, 2)
    blocks = pairs[..., 0] | (pairs[..., 1] << 32)  # (h, nb, RATE) lanes
    st = torch.zeros((25, h), dtype=torch.int64, device=msgs.device)
    for b in range(nb):
        st[:RATE] ^= blocks[:, b].T
        st = keccak_f(st)
    return _digest(st)


def keccak256_chain_plain(words, k):
    """(n,) int32 words -> (k, 8) int32 digests d1 = keccak256(words),
    d_{i+1} = keccak256(d_i), in plain PyTorch."""
    d = _keccak256_rows(words.to(torch.int64).reshape(1, -1) & _M32)
    out = [d]
    for _ in range(k - 1):
        d = _keccak256_rows(d.to(torch.int64) & _M32)
        out.append(d)
    return torch.cat(out)


def bswap32(x):
    """Byte swap of u32 values held in int64."""
    return (((x & 0xFF) << 24) | ((x & 0xFF00) << 8) | ((x >> 8) & 0xFF00)
            | ((x >> 24) & 0xFF))


def grind_batch(pow_bits):
    """The plain version's window: about four times the expected
    2^pow_bits tries, at most 2^17 candidates hashed at once. The kernel
    does not read it (its grid is sized to the card), and the witness
    found does not depend on it."""
    return 1 << min(17, pow_bits + 2)


def keccak_grind_plain(words, pow_bits, p):
    """The smallest w in [0, p) whose keccak256(words ++ [w·2^32 mod p])
    has a first popped u32 (byte swap of digest word 7) with pow_bits low
    zero bits, as a (1,) int32 tensor (-1 if none exists), in plain
    PyTorch (windows of `grind_batch` candidates)."""
    w = words.to(torch.int64).reshape(1, -1) & _M32
    mask, batch = (1 << pow_bits) - 1, grind_batch(pow_bits)
    for start in range(0, p, batch):
        cand = torch.arange(start, min(start + batch, p), dtype=torch.int64,
                            device=words.device)
        msgs = torch.cat([w.expand(cand.shape[0], -1),
                          ((cand << 32) % p)[:, None]], dim=1)
        d = _keccak256_rows(msgs).to(torch.int64) & _M32
        hit = (bswap32(d[:, 7]) & mask) == 0
        if bool(hit.any()):
            return cand[hit.to(torch.int8).argmax()].reshape(1).to(torch.int32)
    return torch.full((1,), -1, dtype=torch.int32, device=words.device)


def ladder_plan(n, top=1, log_nodes=LADDER_LOG_NODES):
    """The ladder kernel's launches for n digests up to `top` nodes:
    (src, dst, m, levels) each, in nodes. A launch reads m digests at row
    `src` of the output (None: the input) and writes `levels` levels from
    row `dst`; a block owning 2^log_nodes nodes of its first level covers
    at most log_nodes + 1."""
    steps, src, dst, m = [], None, 0, n
    while m > top:
        levels = min((m // top).bit_length() - 1, log_nodes + 1)
        steps.append((src, dst, m, levels))
        nxt = m >> levels
        src, dst, m = dst + m - 2 * nxt, dst + m - nxt, nxt
    return steps


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


def keccak_merkle_ladder(digests, top=1):
    """Merkle ladder: (n, 8) int32 digests, n a power of two -> the levels
    above them up to `top` nodes (a power of two, default the root),
    bottom-up in one (n - top, 8) int32 tensor: n/2 parents first. Node i
    of a level compresses nodes 2i and 2i+1 of the level below."""
    _check_rows(digests, "keccak_merkle_ladder", OUT_WORDS)
    n = digests.shape[0]
    if n < 1 or n & (n - 1) or top < 1 or top & (top - 1) or top > n:
        raise ValueError(f"keccak_merkle_ladder: {n} digests up to {top} "
                         "nodes (both powers of two, top <= n)")
    if digests.device.type == "cpu":
        return keccak_merkle_ladder_plain(digests, top)
    kernels.require_cuda_tensor(digests, "keccak_merkle_ladder", torch.int32)
    if digests.data_ptr() % 16:
        raise ValueError("keccak_merkle_ladder: digests must be 16-byte "
                         "aligned")
    out = torch.empty((n - top, OUT_WORDS), dtype=torch.int32,
                      device=digests.device)
    lib = kernels.lib("keccak")
    stream = kernels.stream_of(digests)
    for src, dst, m, levels in ladder_plan(n, top):
        s_ptr = digests.data_ptr() if src is None else out[src].data_ptr()
        kernels.check(lib.keccak_merkle_ladder(
            s_ptr, out[dst].data_ptr(), m, levels, stream),
            "keccak_merkle_ladder")
        kernels.LAUNCHES["keccak_ladder"] += 1
    return out


def keccak256_chain(words, k):
    """Digest chain: (n,) int32 words, n >= 0 -> (k, 8) int32 digests,
    d1 = keccak256(words), d_{i+1} = keccak256(d_i)."""
    if words.dim() != 1 or k < 1:
        raise ValueError(f"keccak256_chain: {tuple(words.shape)} words, "
                         f"k = {k}")
    if words.device.type == "cpu":
        return keccak256_chain_plain(words, k)
    kernels.require_cuda_tensor(words, "keccak256_chain", torch.int32)
    out = torch.empty((k, OUT_WORDS), dtype=torch.int32, device=words.device)
    kernels.check(kernels.lib("keccak").keccak256_chain(
        words.data_ptr(), out.data_ptr(), words.shape[0], k,
        kernels.stream_of(words)), "keccak256_chain")
    kernels.LAUNCHES["keccak256_chain"] += 1
    return out


def keccak_grind(words, pow_bits, p):
    """Proof-of-work search: (m,) int32 words -> the smallest witness w in
    [0, p) of `keccak_grind_plain`, as a (1,) int32 tensor on the device of
    `words` (-1 if none exists); nothing is copied to the host. p is an
    odd prime below 2^31 (the kernel forms Montgomery products mod p)."""
    if (words.dim() != 1 or not 1 <= pow_bits <= 31 or not 2 < p < 1 << 31
            or p % 2 == 0):
        raise ValueError(f"keccak_grind: {tuple(words.shape)} words, "
                         f"{pow_bits} bits, p = {p}")
    if words.device.type == "cpu":
        return keccak_grind_plain(words, pow_bits, p)
    kernels.require_cuda_tensor(words, "keccak_grind", torch.int32)
    best = torch.full((1,), -1, dtype=torch.int32, device=words.device)
    kernels.check(kernels.lib("keccak").keccak_grind(
        words.data_ptr(), words.shape[0], pow_bits, p, best.data_ptr(),
        kernels.stream_of(words)), "keccak_grind")
    kernels.LAUNCHES["keccak_grind"] += 1
    return best
