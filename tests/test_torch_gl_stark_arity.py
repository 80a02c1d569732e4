"""The Goldilocks STARK with a Merkle cap, FRI arity 4, a final
polynomial of two coefficients and proofs of work in every round (the
parameters of `tests/test_goldilocks_stark.py::
test_gl_fibonacci_e2e_cap_and_arity`, at log_n 6): the port's `prove_gl`
of FibonacciAir equals the JAX package's, each verifier accepts the
other's proof, and both reject tampered proofs alike."""

import copy

import pytest

from plonky3_tpu.fields.goldilocks import Goldilocks as JG
from plonky3_tpu.fri.config import FriParameters as JFriParameters
from plonky3_tpu.models.fibonacci import FibonacciAir as JFibonacciAir
from plonky3_tpu.stark.verifier import verify as j_verify
from plonky3_tpu_torch.fields.goldilocks import Goldilocks as G
from plonky3_tpu_torch.compat import fri_params_from
from plonky3_tpu_torch.gl import field as gf
from plonky3_tpu_torch.gl.stark import goldilocks_stark_config, prove_gl
from plonky3_tpu_torch.models.fibonacci import FibonacciAir
from plonky3_tpu_torch.stark.verifier import VerificationError, verify
from torch_gl_reference import (
    as_plain,
    fib_trace,
    reference_config,
    reference_prove,
    to_port,
    to_reference,
)

LOG_N = 6
CAP = 2
PARAMS = JFriParameters(log_blowup=1, log_final_poly_len=1, max_log_arity=2,
                        num_queries=4, commit_proof_of_work_bits=2,
                        query_proof_of_work_bits=2)
P = G.P


@pytest.fixture(scope="module")
def proofs():
    rows, publics = fib_trace(LOG_N, 2, 3)
    j_cfg = reference_config(PARAMS, cap_height=CAP)
    j_air = JFibonacciAir(JG)
    ref = reference_prove(j_cfg, j_air, rows, publics)
    cfg = goldilocks_stark_config(fri_params_from(PARAMS), cap_height=CAP,
                                  device="cpu")
    air = FibonacciAir(gf.GLF)
    ours = prove_gl(cfg, air, gf.to_tensor(rows), publics)
    return dict(ref=ref, ours=ours, j_cfg=j_cfg, j_air=j_air, cfg=cfg,
                air=air, publics=publics)


def test_proof_equals_reference(proofs):
    ours = proofs["ours"]
    assert as_plain(ours) == as_plain(proofs["ref"])
    assert len(ours.commitments.trace) == 1 << CAP  # a cap of 4 digests
    # arity 4 until the last fold, which reaches the final height by 2
    assert [s.log_arity for s in ours.opening_proof.commit_phase_steps] == [
        2, 2, 1]
    assert len(ours.opening_proof.final_poly) == 2


def test_each_verifier_accepts_the_others_proof(proofs):
    j_verify(proofs["j_cfg"], proofs["j_air"], to_reference(proofs["ours"]),
             proofs["publics"])
    assert verify(proofs["cfg"], proofs["air"], to_port(proofs["ref"]),
                  proofs["publics"]) is None


def _bump_ext(v):
    return G.add_h(v[0], 1), v[1]


def _tamper(name, proof):
    fri = proof.opening_proof
    if name == "cap_digest":
        cap = list(proof.commitments.trace)
        cap[3] = ((cap[3][0] + 1) % P,) + tuple(cap[3][1:])
        proof.commitments.trace = tuple(cap)
    elif name == "cap_size":
        proof.commitments.trace = proof.commitments.trace[:2]
    elif name == "final_poly_coefficient":
        fri.final_poly[1] = _bump_ext(fri.final_poly[1])
    elif name == "commit_pow":
        fri.commit_pow_witnesses[1] += 1
    elif name == "arity_group_value":
        sib = fri.commit_phase_steps[0].sibling_values[2]
        sib[2] = _bump_ext(sib[2])
    elif name == "input_row":
        row = fri.input_openings[1].opened_values[2][0]
        row[0] = (row[0] + 1) % P
    else:
        raise ValueError(name)


@pytest.mark.parametrize("name", ["cap_digest", "cap_size",
                                  "final_poly_coefficient", "commit_pow",
                                  "arity_group_value", "input_row"])
def test_verifiers_reject_tampered_proof_alike(proofs, name):
    bad = copy.deepcopy(proofs["ours"])
    _tamper(name, bad)
    with pytest.raises(Exception) as got:
        verify(proofs["cfg"], proofs["air"], bad, proofs["publics"])
    with pytest.raises(Exception) as want:
        j_verify(proofs["j_cfg"], proofs["j_air"], to_reference(bad),
                 proofs["publics"])
    assert (type(got.value).__name__, str(got.value)) == (
        type(want.value).__name__, str(want.value))
    assert isinstance(got.value, VerificationError)
