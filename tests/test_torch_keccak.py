"""plonky3_tpu_torch keccak layer and transcript against plonky3_tpu:
the permutation, Keccak-256, the Merkle sponge and compressor (through
the kernel wrappers, which run their plain versions on the CPU), and the
SerializingChallenger32 in lockstep, grind included."""

import numpy as np
import pytest
import torch

from plonky3_tpu.challenger.serializing import (
    SerializingChallenger32 as JChallenger,
)
from plonky3_tpu.fields import KoalaBear as JF
from plonky3_tpu.hashes import keccak as jk
from plonky3_tpu.hashes.keccak_sponge import (
    KeccakCompressor as JCompressor,
    KeccakFieldSponge as JSponge,
)
from plonky3_tpu_torch.challenger.serializing import SerializingChallenger32
from plonky3_tpu_torch.fields import KoalaBear as F
from plonky3_tpu_torch.hashes import keccak, keccak_cuda
from plonky3_tpu_torch.hashes.keccak_sponge import (
    KeccakCompressor,
    KeccakFieldSponge,
)


def _words(x):
    return torch.from_numpy(np.ascontiguousarray(x).view(np.int32))


def _u32(t):
    return t.numpy().view(np.uint32)


def test_permutation_matches_reference():
    rng = np.random.default_rng(0)
    lo = rng.integers(0, 2**32, (9, 25), dtype=np.uint64).astype(np.uint32)
    hi = rng.integers(0, 2**32, (9, 25), dtype=np.uint64).astype(np.uint32)
    want = jk.keccak_f1600_arrays(np, lo, hi)
    got = keccak.keccak_f1600_arrays(lo, hi)
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])
    lanes = [int(x) | (int(y) << 32) for x, y in zip(lo[0], hi[0])]
    assert keccak.keccak_f1600_host(lanes) == jk.keccak_f1600_host(lanes)
    assert keccak.keccak_f1600_host([0] * 25)[:2] == [
        0xF1258F7940E1DDE7, 0x84D5CCF933C0478A]


@pytest.mark.parametrize("n", [0, 3, 135, 136, 137, 500])
def test_keccak256_matches_reference(n):
    data = bytes((7 * i + n) % 256 for i in range(n))
    assert keccak.keccak256(data) == jk.keccak256(data)


@pytest.mark.parametrize("prefix_len", [0, 36, 132, 140])
def test_keccak256_batch_matches_reference(prefix_len):
    rng = np.random.default_rng(prefix_len)
    prefix = bytes(rng.integers(0, 256, prefix_len, dtype=np.uint8))
    cands = rng.integers(0, 2**32, 50, dtype=np.uint64).astype(np.uint32)
    assert np.array_equal(keccak.keccak256_np_batch(prefix, cands),
                          jk.keccak256_np_batch(prefix, cands))


# widths: odd tails, rem 0 (34 = 17 lanes, 68), rem != 0, nb > 1, the
# quotient leaves (8), the FRI arity-8 leaves (32) and a trace-like row
@pytest.mark.parametrize("w", [1, 3, 8, 32, 33, 34, 35, 68, 71, 164, 1312])
def test_sponge_rows_match_reference(w):
    rng = np.random.default_rng(w)
    x = JF.rand_np(rng, (6, w))
    want = JSponge(JF).hash_rows_np([x])
    got = keccak_cuda.keccak_sponge_rows(_words(x))
    assert got.dtype == torch.int32 and np.array_equal(_u32(got), want)
    # the MMCS entry: two same-height matrices hash as one concatenation
    a, b = x[:, : w // 2], x[:, w // 2:]
    if a.shape[1]:
        got = KeccakFieldSponge(F).hash_rows_device(
            [torch.from_numpy(a.astype(np.int64)),
             torch.from_numpy(b.astype(np.int64))])
        assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("h", [1, 2, 17])
def test_compress_matches_reference(h):
    rng = np.random.default_rng(h)
    left = rng.integers(0, 2**32, (h, 8), dtype=np.uint64).astype(np.uint32)
    right = rng.integers(0, 2**32, (h, 8), dtype=np.uint64).astype(np.uint32)
    want = JCompressor().compress_np(left, right)
    got = keccak_cuda.keccak_compress(_words(left), _words(right))
    assert np.array_equal(_u32(got), want)
    got = KeccakCompressor().compress_device(
        torch.from_numpy(left.astype(np.int64)),
        torch.from_numpy(right.astype(np.int64)))
    assert np.array_equal(got.numpy(), want)


def test_challenger_lockstep_with_grind():
    ours, ref = SerializingChallenger32(F), JChallenger(JF)
    rng = np.random.default_rng(5)
    digest = tuple(int(x) for x in rng.integers(0, 2**32, 8))
    ys = rng.integers(0, F.P, 300, dtype=np.uint64).astype(np.uint32)
    for ch in (ours, ref):
        ch.observe_many([17, 17, 0])
        ch.observe_digest(digest)
        ch.observe_digest([digest, digest])
    assert ours.sample_ext(4) == ref.sample_ext(4)
    for ch in (ours, ref):
        ch.observe_base_array(ys)
        ch.observe_ext((1, 2, 3, 4))
    assert [ours.sample() for _ in range(40)] == [
        ref.sample() for _ in range(40)]
    assert ours.grind(8) == ref.grind(8)
    assert [ours.sample_bits(18) for _ in range(25)] == [
        ref.sample_bits(18) for _ in range(25)]
    assert ours.grind(0) == ref.grind(0) == 0
    assert ours.sample_ext(4) == ref.sample_ext(4)
