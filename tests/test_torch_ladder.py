"""The keccak Merkle ladder of plonky3_tpu_torch against plonky3_tpu: its
plain version against `KeccakCompressor.compress_np` level by level, a
numpy model of the CUDA kernel's schedule (launches, blocks, subtree
offsets, the threads at work at each level, the shared-memory ping-pong)
against the plain version, and the Merkle layers built through the ladder
against the reference's `_build_layers_np`. numpy and CPU torch only."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from plonky3_tpu.fields import KoalaBear as JF
from plonky3_tpu.hashes.keccak_sponge import (
    KeccakCompressor as JCompressor,
    KeccakFieldSponge as JSponge,
)
from plonky3_tpu.merkle.mmcs import MerkleTreeMmcs as JMmcs
from plonky3_tpu.merkle.mmcs import _build_layers_np
from plonky3_tpu_torch.fields import KoalaBear as F
from plonky3_tpu_torch.hashes import keccak_cuda as kc
from plonky3_tpu_torch.hashes.keccak_sponge import (
    KeccakCompressor,
    KeccakFieldSponge,
)
from plonky3_tpu_torch.merkle.mmcs import MerkleTreeMmcs, levels_by_compress

_JC = JCompressor()


def _digests(n, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 2**32, (n, 8), dtype=np.uint64).astype(np.uint32)


def _levels_np(digests, top=1):
    """The reference: compress_np level by level, concatenated."""
    levels, cur = [], digests
    while cur.shape[0] > top:
        pairs = cur.reshape(-1, 2, 8)
        cur = _JC.compress_np(pairs[:, 0], pairs[:, 1])
        levels.append(cur)
    return np.concatenate(levels) if levels else digests[:0]


def _ladder_model(digests, top, log_nodes, threads, warps):
    """The kernel's schedule in numpy: a block owns 2^log_nodes nodes of its
    first level; a level of more nodes than `warps` gives thread t the
    nodes t, t + threads, ...; a smaller one gives warp w node w. Returns
    the output and how often each output row was written."""
    n = digests.shape[0]
    out = np.zeros((n - top, 8), np.uint32)
    written = np.zeros(n - top, np.int64)
    for src, dst, m, levels in kc.ladder_plan(n, top, log_nodes):
        inp = digests if src is None else out[src:src + m]
        cnt0 = min(1 << log_nodes, m // 2)
        assert cnt0 >> (levels - 1) >= 1  # the C entry's launch check
        for b in range(m // 2 // cnt0):
            sh = np.zeros((2, 1 << log_nodes, 8), np.uint32)
            level_off, level_nodes, cnt = 0, m // 2, cnt0
            for j in range(levels):
                if cnt <= warps:
                    work = [[w] for w in range(cnt)]
                else:
                    work = [list(range(t, cnt, threads))
                            for t in range(threads)]
                nodes = np.array(sorted(i for w in work for i in w))
                assert np.array_equal(nodes, np.arange(cnt))
                kids = (inp[(b * cnt0 + nodes)[:, None] * 2 + [0, 1]]
                        if j == 0
                        else sh[(j - 1) & 1][nodes[:, None] * 2 + [0, 1]])
                d = _JC.compress_np(kids[:, 0], kids[:, 1])
                rows = dst + level_off + b * cnt + nodes
                out[rows] = d
                written[rows] += 1
                sh[j & 1][nodes] = d
                level_off += level_nodes
                level_nodes //= 2
                cnt //= 2
    return out, written


def _u32(t):
    return t.numpy().view(np.uint32)


@pytest.mark.parametrize("log_n", range(1, 8))
def test_plain_ladder_matches_reference(log_n):
    d = _digests(1 << log_n, log_n)
    got = kc.keccak_merkle_ladder(torch.from_numpy(d.view(np.int32)))
    assert got.dtype == torch.int32 and got.shape == ((1 << log_n) - 1, 8)
    assert np.array_equal(_u32(got), _levels_np(d))


# (log2 nodes of a block's first level, threads, warps); the kernel's is
# (9, 256, 8)
BLOCKS = [(0, 1, 1), (1, 1, 1), (2, 2, 1), (3, 4, 2)]


@pytest.mark.parametrize("block", BLOCKS)
@pytest.mark.parametrize("log_n", range(1, 8))
def test_kernel_schedule_matches_plain(block, log_n):
    n = 1 << log_n
    d = _digests(n, 100 + log_n)
    got, written = _ladder_model(d, 1, *block)
    want = _u32(kc.keccak_merkle_ladder_plain(
        torch.from_numpy(d.view(np.int32))))
    assert np.array_equal(got, want)
    assert (written == 1).all()
    # one launch per log_nodes + 1 levels
    assert len(kc.ladder_plan(n, 1, block[0])) == -(-log_n // (block[0] + 1))


@pytest.mark.parametrize("n,top", [(8, 2), (64, 2), (64, 8), (128, 64)])
def test_ladder_stops_at_top(n, top):
    d = _digests(n, n + top)
    got, written = _ladder_model(d, top, 2, 2, 1)
    want = _levels_np(d, top)
    assert np.array_equal(got, want) and (written == 1).all()
    plain = kc.keccak_merkle_ladder(torch.from_numpy(d.view(np.int32)), top)
    assert np.array_equal(_u32(plain), want)


def test_main_path_launch_counts():
    # the trace and quotient trees, then the six FRI commit trees
    leaves = [1 << 18, 1 << 18, 1 << 15, 1 << 12, 1 << 9, 1 << 6, 1 << 3, 2]
    assert [len(kc.ladder_plan(n)) for n in leaves] == [2, 2, 2, 2, 1, 1,
                                                       1, 1]


def test_ladder_nodes_match_the_source():
    src = (Path(kc.__file__).resolve().parent.parent / "csrc"
           / "keccak.cu").read_text()
    nodes = int(re.search(r"LADDER_NODES = (\d+);", src).group(1))
    assert nodes == 1 << kc.LADDER_LOG_NODES


@pytest.mark.parametrize("n,top", [(3, 1), (8, 3), (4, 8), (0, 1)])
def test_ladder_refuses_bad_sizes(n, top):
    with pytest.raises(ValueError):
        kc.keccak_merkle_ladder(torch.zeros((n, 8), dtype=torch.int32), top)


def test_ladder_device_gives_int64_views_of_one_buffer():
    d = _digests(32, 9)
    levels = KeccakCompressor().ladder_device(
        torch.from_numpy(d.view(np.int32)))
    assert [lv.shape[0] for lv in levels] == [32, 16, 8, 4, 2, 1]
    base = levels[0].untyped_storage().data_ptr()
    assert all(lv.dtype == torch.int64
               and lv.untyped_storage().data_ptr() == base for lv in levels)
    assert np.array_equal(torch.cat(levels[1:]).numpy(), _levels_np(d))
    assert np.array_equal(levels[0].numpy(), d)


class _PerLevel:
    """A compressor without a ladder kernel: one call per level."""

    compress_device = KeccakCompressor.compress_device

    def ladder_device(self, digests, top=1):
        return levels_by_compress(self, digests.to(torch.int64) & 0xFFFFFFFF,
                                  top)


SHAPES = [
    [(16, 5)],
    [(32, 3), (32, 4), (8, 7), (2, 1)],
    [(4, 2), (64, 9), (16, 35)],
]


@pytest.mark.parametrize("shapes", SHAPES)
@pytest.mark.parametrize("cap", [0, 2])
def test_per_level_compressor_builds_the_same_layers(shapes, cap):
    rng = np.random.default_rng(len(shapes) + 5 * cap)
    mats = [JF.rand_np(rng, s) for s in shapes]
    tensors = [torch.from_numpy(m.astype(np.int64)) for m in mats]
    want = _build_layers_np(JMmcs(JSponge(JF), JCompressor(), cap_height=cap),
                            mats)
    for comp in (KeccakCompressor(), _PerLevel()):
        mmcs = MerkleTreeMmcs(KeccakFieldSponge(F), comp, cap_height=cap)
        if min(s[0] for s in shapes) < (1 << cap):
            with pytest.raises(ValueError):
                mmcs.commit(tensors)
            continue
        layers = mmcs.commit(tensors).layers
        assert len(layers) == len(want)
        for got, exp in zip(layers, want):
            assert got.dtype == torch.int64
            assert np.array_equal(got.numpy(), exp)
