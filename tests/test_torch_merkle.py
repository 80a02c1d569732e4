"""plonky3_tpu_torch Merkle MMCS against plonky3_tpu: layers and roots
with mixed-height injection, Merkle caps, pruned multi-openings (alone and
batched over several trees), and the extension adapter."""

import numpy as np
import pytest
import torch

from plonky3_tpu.fields import KoalaBear as JF
from plonky3_tpu.hashes.keccak_sponge import (
    KeccakCompressor as JCompressor,
    KeccakFieldSponge as JSponge,
)
from plonky3_tpu.merkle.extension_mmcs import ExtensionMmcs as JExtMmcs
from plonky3_tpu.merkle.mmcs import MerkleTreeMmcs as JMmcs
from plonky3_tpu.merkle.mmcs import _build_layers_np
from plonky3_tpu_torch.fields import KoalaBear as F
from plonky3_tpu_torch.hashes.keccak_sponge import (
    KeccakCompressor,
    KeccakFieldSponge,
)
from plonky3_tpu_torch.merkle.extension_mmcs import ExtensionMmcs
from plonky3_tpu_torch.merkle.mmcs import MerkleTreeMmcs, PullBatcher


def _mmcs(cap=0):
    ours = MerkleTreeMmcs(KeccakFieldSponge(F), KeccakCompressor(),
                          cap_height=cap)
    ref = JMmcs(JSponge(JF), JCompressor(), cap_height=cap)
    return ours, ref


def _mats(seed, shapes):
    rng = np.random.default_rng(seed)
    return [JF.rand_np(rng, s) for s in shapes]


SHAPES = [
    [(16, 5)],
    [(32, 3), (32, 4), (8, 7), (2, 1)],  # same-height concat + injection
    [(4, 2), (64, 9), (16, 35)],  # taller matrices come first
]


@pytest.mark.parametrize("shapes", SHAPES)
@pytest.mark.parametrize("cap", [0, 2])
def test_layers_and_commitment_match_reference(shapes, cap):
    mats = _mats(len(shapes) + cap, shapes)
    ours, ref = _mmcs(cap)
    tensors = [torch.from_numpy(m.astype(np.int64)) for m in mats]
    if min(s[0] for s in shapes) < (1 << cap):
        # a matrix below the cap layer cannot be opened: both refuse
        with pytest.raises(ValueError):
            ours.commit(tensors)
        with pytest.raises(AssertionError):
            ref.commit(mats, jit_tree="np")
        return
    data = ours.commit(tensors)
    want = _build_layers_np(ref, mats)
    assert len(data.layers) == len(want)
    for got, exp in zip(data.layers, want):
        assert np.array_equal(got.numpy(), exp)
    assert data.commitment == ref.commit(mats, jit_tree="np").commitment


@pytest.mark.parametrize("shapes", SHAPES)
@pytest.mark.parametrize("cap", [0, 1])
def test_pruned_openings_match_reference(shapes, cap):
    mats = _mats(7 + cap, shapes)
    ours, ref = _mmcs(cap)
    data = ours.commit([torch.from_numpy(m.astype(np.int64)) for m in mats])
    jdata = ref.commit(mats, jit_tree="np")
    h = max(s[0] for s in shapes)
    rng = np.random.default_rng(3)
    indices = [int(i) for i in rng.integers(0, h, 9)] + [0, h - 1, 0]
    assert ours.open_multi_batch(data, indices) == tuple(
        ref.open_multi_batch(jdata, indices))


def test_pull_batcher_and_extension_adapter():
    rng = np.random.default_rng(11)
    base = JF.rand_np(rng, (16, 6))
    ext = JF.rand_np(rng, (8, 8, 4))
    ours, ref = _mmcs()
    e_ours, e_ref = ExtensionMmcs(ours, 4), JExtMmcs(ref, 4)
    d_base = ours.commit([torch.from_numpy(base.astype(np.int64))])
    d_ext = e_ours.commit_ext_matrix(torch.from_numpy(ext.astype(np.int64)))
    j_base = ref.commit([base], jit_tree="np")
    j_ext = e_ref.commit_ext_matrix(ext)
    assert d_ext.commitment == j_ext.commitment
    batcher = PullBatcher()
    f1 = batcher.add(ours, d_base, [3, 9, 3])
    f2 = batcher.add(e_ours, d_ext, [1, 6])
    batcher.flush()
    assert f1.value == tuple(ref.open_multi_batch(j_base, [3, 9, 3]))
    assert f2.value == tuple(e_ref.open_multi_batch(j_ext, [1, 6]))
