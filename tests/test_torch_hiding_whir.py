"""The port's hiding WHIR (plonky3_tpu_torch/multilinear/hiding_whir.py
and the paired round-0 branches of whir.py) against the reference's.

The same inputs, made from a seed with numpy, go through both packages at
n_vars 6 under tests/test_zk_multilinear.py's `make_hiding_pcs` config:
the commitment, the value and the HidingWhirProof must be equal field for
field (tolerance zero), and each package's verifier accepts the other's
proof. The reference tests' tampers (a changed value, a changed v_mask)
and the paired round's own (a changed mask row, witness row or combined
value, a missing paired proof) raise the same error class and message in
both verifiers. The leakage check of the reference's tests runs on the
port's proofs. The JAX proof is made once, in a module-scoped fixture
(its XLA compiles take most of this file's time; the same shapes as
tests/test_zk_multilinear.py's, so the compile cache serves both).
`open_hiding_multi` of a three-point statement is held the same way: the
commitment and HidingWhirProof equal the reference's from the same seed,
both packages' `verify_hiding_multi` accept either proof, and three
tampers raise the same error in both.
"""

import copy

import numpy as np
import pytest
import torch

from plonky3_tpu.challenger.duplex import DuplexChallenger as JDuplex
from plonky3_tpu.fields import KoalaBear as JF
from plonky3_tpu.fields import KoalaBearExt4 as JE
from plonky3_tpu.hashes.poseidon2 import default_poseidon2 as j_poseidon2
from plonky3_tpu.hashes.sponge import PaddingFreeSponge as JSponge
from plonky3_tpu.hashes.sponge import TruncatedPermutation as JCompress
from plonky3_tpu.merkle.extension_mmcs import ExtensionMmcs as JExtMmcs
from plonky3_tpu.merkle.mmcs import MerkleTreeMmcs as JMmcs
from plonky3_tpu.multilinear import hiding_whir as jhw
from plonky3_tpu.multilinear import whir as jwhir
from plonky3_tpu_torch.challenger.duplex import DuplexChallenger
from plonky3_tpu_torch.fields import KoalaBear as F
from plonky3_tpu_torch.fields import KoalaBearExt4 as E
from plonky3_tpu_torch.hashes.poseidon2 import default_poseidon2
from plonky3_tpu_torch.hashes.sponge import (
    PaddingFreeSponge,
    TruncatedPermutation,
)
from plonky3_tpu_torch.merkle.extension_mmcs import ExtensionMmcs
from plonky3_tpu_torch.merkle.mmcs import MerkleTreeMmcs
from plonky3_tpu_torch.multilinear import eval_mle_host
from plonky3_tpu_torch.multilinear import hiding_whir as hw
from plonky3_tpu_torch.multilinear import whir
from test_torch_stir import as_plain

N_VARS = 6


def _cfg(mod, n1):
    k = 2
    return mod.WhirConfig(log_blowup=2, folding_factor=k,
                          final_vars=n1 % k if n1 % k else k, num_queries=8,
                          ood_samples=1, pow_bits=2)


def pcs(n1=N_VARS + 1):
    m = MerkleTreeMmcs(
        sponge=PaddingFreeSponge(default_poseidon2(F, 24), rate=16, out=8),
        compressor=TruncatedPermutation(default_poseidon2(F, 16), chunk=8))
    return hw.HidingWhirPcs(F=F, E=E, config=_cfg(whir, n1), mmcs=m,
                            fri_mmcs=ExtensionMmcs(inner=m, D=E.D))


def jpcs(n1=N_VARS + 1):
    m = JMmcs(sponge=JSponge(j_poseidon2(JF, 24), rate=16, out=8),
              compressor=JCompress(j_poseidon2(JF, 16), chunk=8))
    return jhw.HidingWhirPcs(F=JF, E=JE, config=_cfg(jwhir, n1), mmcs=m,
                             fri_mmcs=JExtMmcs(inner=m, D=JE.D))


def ch():
    return DuplexChallenger(default_poseidon2(F, 24), rate=16)


def jch():
    return JDuplex(j_poseidon2(JF, 24), rate=16)


def commit_open(p, seed, evals=None):
    """tests/test_zk_multilinear.py::_commit_open on either package."""
    rng = np.random.default_rng(seed)
    if evals is None:
        evals = F.rand_np(rng, (1 << N_VARS,), monty=False)
    ours = isinstance(p, hw.HidingWhirPcs)
    commit, data = p.commit_hiding(
        torch.from_numpy(evals.astype(np.int64)) if ours else evals, rng)
    point = [tuple(int(v) for v in F.rand_np(rng, (E.D,), monty=False))
             for _ in range(N_VARS)]
    value, proof = p.open_hiding(data, point, ch() if ours else jch(), rng)
    return dict(evals=evals, commit=commit, point=point, value=value,
                proof=proof)


@pytest.fixture(scope="module")
def runs():
    return {"ours": commit_open(pcs(), 3), "ref": commit_open(jpcs(), 3)}


def verify(package, run, proof=None, value=None):
    p, c = (pcs(), ch()) if package == "ours" else (jpcs(), jch())
    p.verify_hiding(run["commit"], N_VARS, run["point"],
                    run["value"] if value is None else value,
                    run["proof"] if proof is None else proof, c)


def test_commit_value_and_proof_equal_reference(runs):
    ours, ref = runs["ours"], runs["ref"]
    assert ours["commit"] == ref["commit"]
    assert ours["value"] == ref["value"]
    assert as_plain(ours["proof"]) == as_plain(ref["proof"])
    # round 0 opened both trees
    assert ours["proof"].inner.rounds[0].query_proof[0] == "paired"


def test_value_is_the_witness_mle(runs):
    run = runs["ours"]
    assert run["value"] == eval_mle_host(
        E, [int(v) for v in run["evals"]], run["point"])


@pytest.mark.parametrize("verifier", ["ours", "ref"])
@pytest.mark.parametrize("prover", ["ours", "ref"])
def test_each_verifier_accepts_each_proof(runs, verifier, prover):
    verify(verifier, runs[prover])


def _bump(e):
    return tuple((c + 1) % F.P for c in e)


def _v_mask(proof):
    proof.v_mask = _bump(proof.v_mask)


def _mask_commit(proof):
    proof.mask_commit = (proof.mask_commit[0] + 1,) + tuple(
        proof.mask_commit[1:])


def _paired_part(proof, part):
    rp = proof.inner.rounds[0]
    q = list(rp.query_proof)
    rows = copy.deepcopy(q[part])
    first = rows[0][0]
    rows[0][0] = (_bump(first) if isinstance(first, tuple)
                  else (first + 1) % F.P)
    q[part] = rows
    rp.query_proof = tuple(q)


def _combined_value(proof):
    g = list(proof.inner.rounds[0].query_values[0])
    g[0] = _bump(g[0])
    proof.inner.rounds[0].query_values[0] = g


def _unpaired(proof):
    rp = proof.inner.rounds[0]
    rp.query_proof = list(rp.query_proof[4])


TAMPERS = {"value": None, "v_mask": _v_mask, "mask_commit": _mask_commit,
           "mask_row": lambda p: _paired_part(p, 3),
           "witness_row": lambda p: _paired_part(p, 1),
           "combined_value": _combined_value, "unpaired": _unpaired}


@pytest.mark.parametrize("tamper", list(TAMPERS))
def test_tamper_raises_the_reference_error(runs, tamper):
    run = runs["ours"]
    proof, value = copy.deepcopy(run["proof"]), None
    if TAMPERS[tamper] is None:
        value = _bump(run["value"])
    else:
        TAMPERS[tamper](proof)
    raised = []
    for package in ("ours", "ref"):
        with pytest.raises(Exception) as info:
            verify(package, run, proof, value)
        raised.append((type(info.value).__name__, str(info.value)))
    assert raised[0] == raised[1]
    assert raised[0][0] == "WhirError"


def test_mask_row_tamper_is_an_mmcs_error(runs):
    """A changed round-0 mask row fails the mask tree's authentication."""
    proof = copy.deepcopy(runs["ours"]["proof"])
    _paired_part(proof, 3)
    with pytest.raises(whir.WhirError, match="MmcsError"):
        verify("ours", runs["ours"], proof)


def test_hiding_leakage():
    """Two openings of the same witness at the same point share nothing
    beyond the claimed value: every mask value, commitment and final
    polynomial differs (one-time masks), and fresh commitment randomness
    gives another codeword commitment."""
    evals = F.rand_np(np.random.default_rng(7), (1 << N_VARS,), monty=False)
    a = commit_open(pcs(), 8, evals)
    b = commit_open(pcs(), 9, evals)
    assert a["commit"] != b["commit"]
    assert a["proof"].mask_commit != b["proof"].mask_commit
    assert a["proof"].v_mask != b["proof"].v_mask
    assert a["proof"].inner.final_poly != b["proof"].inner.final_poly
    for r1, r2 in zip(a["proof"].inner.rounds, b["proof"].inner.rounds):
        assert r1.sumcheck_polys != r2.sumcheck_polys


def test_commit_hiding_coeffs_equals_reference():
    rng, jrng = np.random.default_rng(5), np.random.default_rng(5)
    coeffs = F.rand_np(rng, (1 << N_VARS,), monty=False)
    JF.rand_np(jrng, (1 << N_VARS,), monty=False)
    got = pcs().commit_hiding_coeffs(
        torch.from_numpy(coeffs.astype(np.int64)), rng)
    want = jpcs().commit_hiding_coeffs(coeffs, jrng)
    assert got[0] == want[0]
    assert (F.from_monty_np(got[1].coeffs_zk.numpy())
            == np.asarray(want[1].coeffs_zk)).all()


def test_randomness_budget_refused():
    evals = torch.zeros(1 << 3, dtype=torch.int64)
    with pytest.raises(ValueError):
        pcs(4).commit_hiding(evals, np.random.default_rng(0))


def test_device_tensors_and_the_reference_helpers_agree():
    """eval_coeffs_at (one batched fold) against the reference's host
    eval_multilinear_coeffs, at several points at once."""
    rng = np.random.default_rng(11)
    coeffs = [JE.rand_h(rng) for _ in range(1 << 5)]
    points = [[JE.rand_h(rng) for _ in range(5)] for _ in range(3)]
    cd = torch.from_numpy(np.stack([E.to_monty_np(c) for c in coeffs])
                          .astype(np.int64))
    assert hw.eval_coeffs_at(E, cd, points) == [
        jwhir.eval_multilinear_coeffs(JE, coeffs, p) for p in points]


def _multi_statement(seed, evals):
    rng = np.random.default_rng(seed)
    points_scales = [([E.rand_h(rng) for _ in range(N_VARS)], E.rand_h(rng))
                     for _ in range(3)]
    claim = E.zero_h()
    for p, sc in points_scales:
        claim = E.add_h(claim, E.mul_h(
            sc, eval_mle_host(E, [int(v) for v in evals], p)))
    return points_scales, claim


def commit_open_multi(p):
    """commit_hiding and open_hiding_multi of a three-point weighted
    statement, on either package."""
    rng = np.random.default_rng(12)
    evals = F.rand_np(rng, (1 << N_VARS,), monty=False)
    ours = isinstance(p, hw.HidingWhirPcs)
    commit, data = p.commit_hiding(
        torch.from_numpy(evals.astype(np.int64)) if ours else evals, rng)
    points_scales, claim = _multi_statement(13, evals)
    proof = p.open_hiding_multi(data, points_scales, claim,
                                ch() if ours else jch(), rng)
    return dict(commit=commit, points_scales=points_scales, claim=claim,
                proof=proof)


@pytest.fixture(scope="module")
def multi_runs():
    return {"ours": commit_open_multi(pcs()),
            "ref": commit_open_multi(jpcs())}


@pytest.fixture(scope="module")
def multi_run(multi_runs):
    return multi_runs["ours"]


def verify_multi(package, run, claim=None, proof=None):
    p, c = (pcs(), ch()) if package == "ours" else (jpcs(), jch())
    p.verify_hiding_multi(run["commit"], N_VARS, run["points_scales"],
                          run["claim"] if claim is None else claim,
                          run["proof"] if proof is None else proof, c)


def test_open_hiding_multi_equals_reference(multi_runs):
    ours, ref = multi_runs["ours"], multi_runs["ref"]
    assert ours["commit"] == ref["commit"]
    assert ours["claim"] == ref["claim"]
    assert as_plain(ours["proof"]) == as_plain(ref["proof"])
    assert ours["proof"].inner.rounds[0].query_proof[0] == "paired"


@pytest.mark.parametrize("verifier", ["ours", "ref"])
@pytest.mark.parametrize("prover", ["ours", "ref"])
def test_open_hiding_multi_accepted_by_both(multi_runs, verifier, prover):
    """The batched opening's proof (its round 0 paired) from each package
    passes each package's verify_hiding_multi."""
    verify_multi(verifier, multi_runs[prover])


@pytest.mark.parametrize("tamper", ["claim", "v_mask", "mask_row"])
def test_open_hiding_multi_tamper_raises_the_same_error(multi_run, tamper):
    claim, proof = None, copy.deepcopy(multi_run["proof"])
    if tamper == "claim":
        claim = _bump(multi_run["claim"])
    elif tamper == "v_mask":
        _v_mask(proof)
    else:
        _paired_part(proof, 3)
    raised = []
    for package in ("ours", "ref"):
        with pytest.raises(Exception) as info:
            verify_multi(package, multi_run, claim, proof)
        raised.append((type(info.value).__name__, str(info.value)))
    assert raised[0] == raised[1]
    assert raised[0][0] == "WhirError"
