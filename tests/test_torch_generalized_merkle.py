"""The generalized Merkle tree of plonky3_tpu_torch against plonky3_tpu's
(`merkle/generalized.py`: arity schedule, non-power-of-two heights,
caps), the reference test's cases (`tests/test_generalized_merkle.py`)
with both sponges: the layers, schedule, commitment and every opening
equal the JAX package's, the port's `verify_batch` accepts them, and a
changed row is rejected by both. Then the unpruned verifies of the
power-of-two MMCS family (`MerkleTreeMmcs.verify_batch`,
`verify_batch_many`, `ExtensionMmcs.verify_batch`,
`MerkleTreeHidingMmcs.verify_batch`) on openings the JAX MMCS makes of
the same matrices, and the one-row host hashes they call against the
reference's."""

import numpy as np
import pytest
import torch

from plonky3_tpu.fields.params import KoalaBear as JF
from plonky3_tpu.hashes import keccak_sponge as j_ks
from plonky3_tpu.hashes import sponge as j_sponge
from plonky3_tpu.hashes.poseidon2 import default_poseidon2 as j_poseidon2
from plonky3_tpu.merkle import extension_mmcs as j_ext
from plonky3_tpu.merkle import generalized as j_gen
from plonky3_tpu.merkle import hiding_mmcs as j_hiding
from plonky3_tpu.merkle import mmcs as j_mmcs
from plonky3_tpu_torch.fields import KoalaBear as F
from plonky3_tpu_torch.hashes import keccak_sponge as ks
from plonky3_tpu_torch.hashes import sponge
from plonky3_tpu_torch.hashes.poseidon2 import default_poseidon2
from plonky3_tpu_torch.merkle import extension_mmcs, generalized, hiding_mmcs
from plonky3_tpu_torch.merkle import mmcs


def _hashes(kind, port, compress_width=24):
    if kind == "keccak":
        if port:
            return ks.KeccakFieldSponge(F), ks.KeccakCompressor()
        return j_ks.KeccakFieldSponge(JF), j_ks.KeccakCompressor()
    if port:
        return (sponge.PaddingFreeSponge(default_poseidon2(F, 24), 16, 8),
                sponge.TruncatedPermutation(
                    default_poseidon2(F, compress_width), 8))
    return (j_sponge.PaddingFreeSponge(j_poseidon2(JF, 24), rate=16, out=8),
            j_sponge.TruncatedPermutation(j_poseidon2(JF, compress_width),
                                          chunk=8))


def _mats(seed, shapes):
    rng = np.random.default_rng(seed)
    return [F.to_monty_np(rng.integers(0, F.P, (h, w), dtype=np.uint64)
                          .astype(np.uint32)) for h, w in shapes]


@pytest.mark.parametrize("max_h", [1, 2, 3, 7, 10, 16, 33])
def test_ladder_helpers_equal_reference(max_h):
    assert generalized.valid_heights(max_h) == j_gen.valid_heights(max_h)
    assert generalized.next_pow2(max_h) == j_gen.next_pow2(max_h)
    for n in (2, 4):
        assert (generalized.padded_len(max_h, n)
                == j_gen.padded_len(max_h, n))
        for rem in ([], [max_h // 2], [max(1, max_h // 4)]):
            got = generalized.select_arity_step(n, 16, 16, rem)
            assert got == j_gen.select_arity_step(n, 16, 16, rem)


def test_ladder_helpers_known_values():
    assert generalized.valid_heights(10) == [10, 5, 3, 2, 1]
    assert generalized.padded_len(10, 4) == 12
    assert generalized.select_arity_step(4, 16, 16, [8]) == 2
    assert generalized.select_arity_step(4, 16, 16, [4]) == 4


# (sponge, arity, cap height, shapes, opened indices): the reference
# test's cases
CASES = {
    "non_pow2_poseidon": ("poseidon", 2, 0, [(10, 3), (5, 2), (3, 4)],
                          range(10)),
    "non_pow2_keccak": ("keccak", 2, 0, [(10, 3), (5, 2), (3, 4)],
                        range(10)),
    "arity4": ("keccak", 4, 0, [(64, 3), (16, 2)], (0, 5, 31, 63)),
    "arity4_bridge": ("keccak", 4, 0, [(32, 2), (16, 3), (8, 1)],
                      (0, 7, 19, 31)),
    "cap": ("poseidon", 2, 2, [(32, 2)], (0, 13, 31)),
}


def _trees(case):
    kind, arity, cap, shapes, idxs = CASES[case]
    mats = _mats(len(shapes) + arity + cap, shapes)
    ours = generalized.GeneralizedMerkleMmcs(*_hashes(kind, True),
                                             arity=arity, cap_height=cap)
    ref = j_gen.GeneralizedMerkleMmcs(*_hashes(kind, False), arity=arity,
                                      cap_height=cap)
    return ours, ours.commit(mats), ref, ref.commit(mats), shapes, idxs


@pytest.mark.parametrize("case", list(CASES))
def test_commit_equals_reference(case):
    ours, data, ref, j_data, _, _ = _trees(case)
    assert data.arity_schedule == j_data.arity_schedule
    assert len(data.layers) == len(j_data.layers)
    for a, b in zip(data.layers, j_data.layers):
        assert np.array_equal(a, b)
    assert ours.commitment(data) == ref.commitment(j_data)
    if case == "arity4_bridge":
        assert 2 in data.arity_schedule
    if case == "cap":
        assert len(ours.commitment(data)) == 4


@pytest.mark.parametrize("case", list(CASES))
def test_openings_verify_as_reference(case):
    ours, data, ref, j_data, shapes, idxs = _trees(case)
    commitment = ours.commitment(data)
    for idx in idxs:
        rows, proof = ours.open_batch(data, idx)
        assert (rows, proof) == ref.open_batch(j_data, idx)
        assert ours.verify_batch(commitment, shapes, idx, rows, proof)
        assert ref.verify_batch(commitment, shapes, idx, rows, proof)
    rows, proof = ours.open_batch(data, idxs[-1])
    rows[0][0] = (rows[0][0] + 1) % F.P
    assert not ours.verify_batch(commitment, shapes, idxs[-1], rows, proof)
    assert not ref.verify_batch(commitment, shapes, idxs[-1], rows, proof)


def test_rejects_off_ladder_height():
    mmcs_ = generalized.GeneralizedMerkleMmcs(*_hashes("poseidon", True))
    with pytest.raises(ValueError, match="ladder"):
        mmcs_.commit(_mats(5, [(10, 2), (6, 2)]))


def test_commits_cpu_tensors_and_refuses_device_tensors():
    """The tree hashes on the host: CPU tensors commit as their numpy
    words do; a tensor on another device (here `meta`, as `cuda` would)
    raises rather than be hashed on the host."""
    mmcs_ = generalized.GeneralizedMerkleMmcs(*_hashes("keccak", True))
    mats = _mats(6, [(8, 3), (4, 2)])
    want = mmcs_.commitment(mmcs_.commit(mats))
    got = mmcs_.commitment(mmcs_.commit(
        [torch.from_numpy(m.astype(np.int64)) for m in mats]))
    assert got == want
    with pytest.raises(NotImplementedError, match="on the host"):
        mmcs_.commit([torch.empty((8, 3), dtype=torch.int64,
                                  device="meta")])


@pytest.mark.parametrize("w", [1, 2, 7, 17, 35])
@pytest.mark.parametrize("kind", ["poseidon", "keccak"])
def test_host_hashes_equal_reference(kind, w):
    (sp, cp), (j_sp, j_cp) = _hashes(kind, True), _hashes(kind, False)
    rng = np.random.default_rng(w)
    row = [int(x) for x in rng.integers(0, F.P, w)]
    assert sp.hash_iter_host(row) == j_sp.hash_iter_host(row)
    bound = F.P if kind == "poseidon" else 1 << 32
    d = [tuple(int(x) for x in rng.integers(0, bound, 8)) for _ in range(3)]
    assert cp.compress_host(d[0], d[1]) == j_cp.compress_host(d[0], d[1])
    assert (cp.compress_host_many(d) == j_cp.compress_host_many(d))
    arr = [rng.integers(0, bound, (4, 8)).astype(np.uint32)
           for _ in range(3)]
    if kind == "poseidon":
        arr = [F.to_monty_np(a) for a in arr]
    assert np.array_equal(cp.compress_many_np(arr),
                          j_cp.compress_many_np(arr))


# ---- the unpruned verifies of the power-of-two MMCS family --------------
SHAPES = [(16, 3), (16, 2), (4, 5), (2, 1)]


def _pow2_trees(kind, cap):
    compress_width = 16 if kind == "poseidon" else 24
    ours = mmcs.MerkleTreeMmcs(*_hashes(kind, True, compress_width),
                               cap_height=cap)
    ref = j_mmcs.MerkleTreeMmcs(*_hashes(kind, False, compress_width),
                                cap_height=cap)
    mats = _mats(7 + cap, SHAPES)
    j_data = ref.commit(mats, jit_tree="np")
    return ours, ref, j_data


@pytest.mark.parametrize("cap", [0, 1])
@pytest.mark.parametrize("kind", ["poseidon", "keccak"])
def test_verify_batch_family(kind, cap):
    ours, ref, j_data = _pow2_trees(kind, cap)
    root = j_data.commitment if cap else j_data.root_std
    idxs = [0, 3, 7, 15, 9]
    rows_pq, proofs_pq = ref.open_batch_many(j_data, idxs)
    for idx, rows, proof in zip(idxs, rows_pq, proofs_pq):
        assert ours.verify_batch(root, SHAPES, idx, rows, proof)
    assert ours.verify_batch_many(root, SHAPES, idxs, rows_pq, proofs_pq)
    bad = [[list(r) for r in rows] for rows in rows_pq]
    bad[1][2][0] = (bad[1][2][0] + 1) % F.P
    assert not ours.verify_batch(root, SHAPES, idxs[1], bad[1],
                                 proofs_pq[1])
    assert not ref.verify_batch(root, SHAPES, idxs[1], bad[1], proofs_pq[1])
    assert not ours.verify_batch_many(root, SHAPES, idxs, bad, proofs_pq)
    assert not ours.verify_batch(root, SHAPES, idxs[0], rows_pq[0],
                                 proofs_pq[0][:-1])
    wrong = [(h, w + 1) for h, w in SHAPES]
    assert not ours.verify_batch(root, wrong, idxs[0], rows_pq[0],
                                 proofs_pq[0])


def test_extension_verify_batch():
    ours, ref, _ = _pow2_trees("poseidon", 0)
    mats = _mats(11, [(8, 8), (4, 4)])
    j_ext_mmcs = j_ext.ExtensionMmcs(inner=ref, D=4)
    j_data = ref.commit(mats, jit_tree="np")
    ext = extension_mmcs.ExtensionMmcs(inner=ours, D=4)
    dims = [(8, 2), (4, 1)]
    for idx in range(8):
        rows, proof = j_ext_mmcs.open_batch(j_data, idx)
        assert ext.verify_batch(j_data.root_std, dims, idx, rows, proof)
    rows[0][0] = tuple((x + 1) % F.P for x in rows[0][0])
    assert not ext.verify_batch(j_data.root_std, dims, 7, rows, proof)


def test_hiding_verify_batch():
    ours, ref, _ = _pow2_trees("poseidon", 0)
    j_hide = j_hiding.MerkleTreeHidingMmcs(
        inner=ref, salt_elems=4, rng=np.random.default_rng(3))
    hide = hiding_mmcs.MerkleTreeHidingMmcs(inner=ours, salt_elems=4)
    j_data = j_hide.commit(_mats(12, [(8, 3), (2, 2)]), jit_tree="np")
    dims = [(8, 3), (2, 2)]
    for idx in range(8):
        rows, proof = j_hide.open_batch(j_data, idx)
        assert hide.verify_batch(j_data.root_std, dims, idx, rows, proof)
    rows[0][-1] = (rows[0][-1] + 1) % F.P  # a salt word
    assert not hide.verify_batch(j_data.root_std, dims, 7, rows, proof)
