"""The Poseidon2 config of the port against the reference's.

plonky3_tpu_torch's Poseidon2 sponge (24/16/8) and compression (width 16)
against plonky3_tpu's numpy hashes; the field-digest MMCS (roots, caps,
pruned openings, `verify_multi_batch`) against the reference's numpy
tree; and end to end under `poseidon2_stark_config` (Poseidon2VectorAir
vector_len 1, log_n 6, 10 queries, 8-bit query PoW, on the CPU): the
port's `prove()` and its device-transcript prover give the reference's
proof, the reference verifier accepts the port's proof, the port's
verifier accepts both, Merkle caps and a commit proof of work keep the
fast proof equal to `prove()`'s, and both verifiers raise the same error
on tampered proofs.
"""

import copy
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from plonky3_tpu.fields import KoalaBearExt4 as JE
from plonky3_tpu.fields.params import KoalaBear as JF
from plonky3_tpu.fri.config import FriParameters as JFriParameters
from plonky3_tpu.hashes.poseidon2 import default_poseidon2 as j_poseidon2
from plonky3_tpu.hashes.sponge import PaddingFreeSponge as JSponge
from plonky3_tpu.hashes.sponge import TruncatedPermutation as JCompress
from plonky3_tpu.merkle.mmcs import MerkleTreeMmcs as JMmcs
from plonky3_tpu.models.poseidon2_air import (
    Poseidon2VectorAir as JAir,
    generate_vectorized_trace as j_generate,
)
from plonky3_tpu.stark.config import poseidon2_stark_config as j_config
from plonky3_tpu.stark.prover import prove as j_prove
from plonky3_tpu.stark.verifier import verify as j_verify
from plonky3_tpu_torch.compat import fri_params_from, trace_inputs_from_numpy
from plonky3_tpu_torch.fields import KoalaBear as F
from plonky3_tpu_torch.fields import KoalaBearExt4 as E
from plonky3_tpu_torch.hashes.poseidon2 import default_poseidon2
from plonky3_tpu_torch.hashes.sponge import (
    PaddingFreeSponge,
    TruncatedPermutation,
)
from plonky3_tpu_torch.merkle.mmcs import MerkleTreeMmcs
from plonky3_tpu_torch.models.poseidon2_air import (
    Poseidon2VectorAir,
    generate_vectorized_trace,
)
from plonky3_tpu_torch.stark import fast_prover
from plonky3_tpu_torch.stark.config import poseidon2_stark_config
from plonky3_tpu_torch.stark.prover import prove
from plonky3_tpu_torch.stark.verifier import VerificationError, verify
from test_torch_prove import _raised, _tamper, as_plain, to_port, to_reference

LOG_N = 6
PARAMS = JFriParameters(log_blowup=1, log_final_poly_len=0, max_log_arity=3,
                        num_queries=10, commit_proof_of_work_bits=0,
                        query_proof_of_work_bits=8)

SPONGE = PaddingFreeSponge(default_poseidon2(F, 24), rate=16, out=8)
J_SPONGE = JSponge(j_poseidon2(JF, 24), rate=16, out=8)
COMPRESS = TruncatedPermutation(default_poseidon2(F, 16), chunk=8)
J_COMPRESS = JCompress(j_poseidon2(JF, 16), chunk=8)


def _tensor(x):
    return torch.from_numpy(np.asarray(x).astype(np.int64))


@pytest.mark.parametrize("w", [1, 5, 16, 17, 40, 1312])
def test_sponge_matches_reference(w):
    rng = np.random.default_rng(w)
    rows = JF.rand_np(rng, (3, w))
    want = J_SPONGE.hash_rows_np([rows])
    assert np.array_equal(SPONGE.hash_rows_np([rows]), want)
    assert np.array_equal(SPONGE.hash_rows_device([_tensor(rows)]).numpy(),
                          want)
    # same-height matrices are hashed as their rows concatenated
    parts = [rows[:, :w // 2], rows[:, w // 2:]] if w > 1 else [rows]
    assert np.array_equal(
        SPONGE.hash_rows_device([_tensor(p) for p in parts]).numpy(), want)


def test_compression_matches_reference():
    rng = np.random.default_rng(2)
    left, right = JF.rand_np(rng, (6, 8)), JF.rand_np(rng, (6, 8))
    want = J_COMPRESS.compress_np(left, right)
    assert np.array_equal(COMPRESS.compress_np(left, right), want)
    got = COMPRESS.compress_device(_tensor(left), _tensor(right))
    assert np.array_equal(got.numpy(), want)


def _mmcs_pair(cap_height):
    return (MerkleTreeMmcs(SPONGE, COMPRESS, cap_height=cap_height),
            JMmcs(sponge=J_SPONGE, compressor=J_COMPRESS,
                  cap_height=cap_height))


# mixed heights: shorter matrices are injected on the way up (a height
# below 2^3 cannot be opened under cap height 3)
@pytest.mark.parametrize("cap_height,heights", [
    (0, (32, 32, 8, 2)), (3, (32, 32, 8))])
def test_mmcs_matches_reference(cap_height, heights):
    rng = np.random.default_rng(cap_height)
    mats = [JF.rand_np(rng, (h, w)) for h, w in zip(heights, (3, 4, 7, 1))]
    ours, ref = _mmcs_pair(cap_height)
    data = ours.commit([_tensor(m) for m in mats])
    want = ref.commit(mats, jit_tree="np")
    assert data.commitment == want.commitment
    assert data.cap_std == want.cap_std
    indices = [5, 17, 17, 30, 2, 9]
    rows, sibs = ours.open_multi_batch(data, indices)
    assert (rows, sibs) == ref.open_multi_batch(want, indices)
    dims = [m.shape for m in mats]
    assert ours.verify_multi_batch(data.commitment, dims, indices, rows,
                                   sibs)
    bad_sibs = [sibs[0][:3] + ((sibs[0][3] + 1) % F.P,) + sibs[0][4:]]
    bad_rows = copy.deepcopy(rows)
    bad_rows[0][1][2] = (bad_rows[0][1][2] + 1) % F.P
    for args in ((rows, bad_sibs + sibs[1:]), (bad_rows, sibs),
                 (rows, sibs[:-1]), (rows, sibs + [sibs[0]])):
        assert not ours.verify_multi_batch(data.commitment, dims, indices,
                                           *args)
        assert not ref.verify_multi_batch(want.commitment, dims, indices,
                                          *args)


@pytest.fixture(scope="module")
def proofs():
    """The one reference prove of this file, and the port's prove and
    device-transcript prove of the same inputs on the CPU."""
    inputs = JF.rand_np(np.random.default_rng(3), (1 << LOG_N, 16))
    j_air = JAir(JF, 16, vector_len=1)
    j_cfg = j_config(JF, JE, PARAMS)
    j_trace, _ = j_generate(j_air, jnp.asarray(inputs))
    ref = j_prove(j_cfg, j_air, j_trace, [])

    air = Poseidon2VectorAir(F, 16, vector_len=1)
    trace, _ = generate_vectorized_trace(
        air, trace_inputs_from_numpy(inputs, "cpu"), device="cpu")
    cfg = poseidon2_stark_config(F, E, fri_params_from(PARAMS), device="cpu")
    ours = prove(cfg, air, trace, [])
    pulls = fast_prover.PULLS["count"]
    fast = fast_prover._prove_device_fs(cfg, air, trace, [])
    return dict(ref=ref, ours=ours, fast=fast, j_cfg=j_cfg, j_air=j_air,
                air=air, trace=trace, cfg=cfg,
                fast_pulls=fast_prover.PULLS["count"] - pulls)


def test_proofs_equal_reference(proofs):
    assert as_plain(proofs["ours"]) == as_plain(proofs["ref"])
    assert proofs["fast"] == proofs["ours"]
    assert proofs["fast_pulls"] == 1
    cfg, air, trace = proofs["cfg"], proofs["air"], proofs["trace"]
    assert fast_prover.prove_fast(cfg, air, trace, []) == proofs["ours"]


def test_reference_verifier_accepts_port_proof(proofs):
    rebuilt = to_reference(proofs["fast"])
    assert rebuilt == proofs["ref"]
    j_verify(proofs["j_cfg"], proofs["j_air"], rebuilt, [])


@pytest.mark.parametrize("which", ["ours", "ref"])
def test_verify_accepts_port_and_reference_proofs(proofs, which):
    proof = proofs[which]
    if which == "ref":
        proof = to_port(proof)
    assert verify(proofs["cfg"], proofs["air"], proof, []) is None


@pytest.mark.parametrize("cap_height", [0, 3])
@pytest.mark.parametrize("commit_pow", [0, 2])
def test_fast_proof_caps_and_commit_pow(proofs, cap_height, commit_pow):
    """The caps × commit proof-of-work matrix of the reference's
    tests/test_device_fs.py for field digests."""
    params = dataclasses.replace(fri_params_from(PARAMS),
                                 commit_proof_of_work_bits=commit_pow)
    cfg = poseidon2_stark_config(F, E, params, cap_height=cap_height,
                                 device="cpu")
    air, trace = proofs["air"], proofs["trace"]
    fast = fast_prover._prove_device_fs(cfg, air, trace, [])
    assert fast == prove(cfg, air, trace, [])
    assert isinstance(fast.commitments.trace[0], tuple) == (cap_height > 0)
    assert any(fast.opening_proof.commit_pow_witnesses) == (commit_pow > 0)
    verify(cfg, air, fast, [])


@pytest.mark.parametrize("name", [
    "trace_local", "trace_commitment", "quotient_commitment",
    "commit_phase_sibling_digest", "input_row", "query_pow"])
def test_verify_rejects_tampered_proof_as_reference(proofs, name):
    """The same error class and message from the port's verifier and the
    reference's on a tampered proof: opened values, field-digest roots,
    a sibling digest, an opened row, the PoW witness."""
    bad = copy.deepcopy(proofs["ours"])
    publics = _tamper(name, bad)
    got = _raised(lambda: verify(proofs["cfg"], proofs["air"], bad,
                                 publics))
    want = _raised(lambda: j_verify(proofs["j_cfg"], proofs["j_air"],
                                    to_reference(bad), publics))
    assert got == want
    with pytest.raises(VerificationError):
        verify(proofs["cfg"], proofs["air"], bad, publics)
