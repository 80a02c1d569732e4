"""The Goldilocks STARK end to end: the port's `prove_gl` of FibonacciAir
at log_n 6 under `goldilocks_stark_config(FriParameters.new_testing())`
equals the JAX package's `prove_gl` (run as `tests/torch_gl_reference.py`
says), each package's verifier accepts the other's proof, and both reject
every tampered proof with the same error class and message. Also the
transcript's grind against the reference's, and the pieces the proof does
not isolate (the GL quotient, the FRI fold, the selectors)."""

import copy

import numpy as np
import pytest
import torch

from plonky3_tpu.fields.goldilocks import Goldilocks as JG
from plonky3_tpu.fri.config import FriParameters as JFriParameters
from plonky3_tpu.gl import pcs as jpcs
from plonky3_tpu.gl import stark as jstark
from plonky3_tpu.models.fibonacci import FibonacciAir as JFibonacciAir
from plonky3_tpu.stark.verifier import verify as j_verify
from plonky3_tpu_torch.fields.goldilocks import Goldilocks as G
from plonky3_tpu_torch.fri.config import FriParameters
from plonky3_tpu_torch.gl import field as gf
from plonky3_tpu_torch.gl.pcs import GLFriFolding
from plonky3_tpu_torch.gl.stark import (
    GLDuplexChallenger,
    gl_selectors_on_coset,
    goldilocks_stark_config,
    prove_gl,
)
from plonky3_tpu_torch.models.fibonacci import FibonacciAir
from plonky3_tpu_torch.stark.verifier import VerificationError, verify
from torch_gl_reference import (
    HostGrindChallenger,
    as_plain,
    fib_trace,
    reference_config,
    reference_prove,
    to_port,
    to_reference,
)

LOG_N = 6
P = G.P


@pytest.fixture(scope="module")
def proofs():
    """The reference's proof (the file's one reference prove) and the
    port's, of the same trace."""
    rows, publics = fib_trace(LOG_N)
    j_cfg = reference_config(JFriParameters.new_testing())
    j_air = JFibonacciAir(JG)
    ref = reference_prove(j_cfg, j_air, rows, publics)
    cfg = goldilocks_stark_config(FriParameters.new_testing(), device="cpu")
    air = FibonacciAir(gf.GLF)
    ours = prove_gl(cfg, air, gf.to_tensor(rows), publics)
    return dict(ref=ref, ours=ours, j_cfg=j_cfg, j_air=j_air, cfg=cfg,
                air=air, publics=publics, rows=rows)


def test_proof_equals_reference(proofs):
    assert as_plain(proofs["ours"]) == as_plain(proofs["ref"])
    assert proofs["ours"].degree_bits == LOG_N


def test_reference_verifier_accepts_port_proof(proofs):
    j_verify(proofs["j_cfg"], proofs["j_air"], to_reference(proofs["ours"]),
             proofs["publics"])


def test_port_verifier_accepts_reference_proof(proofs):
    assert verify(proofs["cfg"], proofs["air"], to_port(proofs["ref"]),
                  proofs["publics"]) is None
    assert verify(proofs["cfg"], proofs["air"], proofs["ours"],
                  proofs["publics"]) is None


def _bump_ext(v):
    return G.add_h(v[0], 1), v[1]


def _bump_digest(d):
    return ((d[0] + 1) % P,) + tuple(d[1:])


def _tamper(name, proof, publics):
    """Change one part of `proof` in place; returns the public values the
    verifier is given."""
    ov, fri = proof.opened_values, proof.opening_proof
    if name == "public_values":
        return [publics[0], publics[1], 12345]
    if name == "trace_local":
        ov.trace_local[0] = _bump_ext(ov.trace_local[0])
    elif name == "trace_next":
        ov.trace_next[1] = _bump_ext(ov.trace_next[1])
    elif name == "quotient_chunks":
        ov.quotient_chunks[0][1] = _bump_ext(ov.quotient_chunks[0][1])
    elif name == "trace_width":
        ov.trace_local.pop()
    elif name == "trace_commitment":
        proof.commitments.trace = _bump_digest(proof.commitments.trace)
    elif name == "quotient_commitment":
        proof.commitments.quotient_chunks = _bump_digest(
            proof.commitments.quotient_chunks)
    elif name == "final_poly":
        fri.final_poly[0] = _bump_ext(fri.final_poly[0])
    elif name == "query_pow":
        fri.query_pow_witness += 1
    elif name == "commit_pow":
        fri.commit_pow_witnesses[0] += 1
    elif name == "commit_phase_sibling_digest":
        step = fri.commit_phase_steps[0]
        step.opening_proof[0] = _bump_digest(step.opening_proof[0])
    elif name == "commit_phase_sibling_value":
        sib = fri.commit_phase_steps[0].sibling_values[1]
        sib[0] = _bump_ext(sib[0])
    elif name == "input_row":
        row = fri.input_openings[0].opened_values[1][0]
        row[1] = (row[1] + 1) % P
    elif name == "quotient_chunk_count":
        ov.quotient_chunks.pop()
    elif name == "final_poly_length":
        fri.final_poly.append(fri.final_poly[0])
    elif name == "commit_pow_count":
        fri.commit_pow_witnesses.pop()
    elif name == "commit_phase_count":
        fri.commit_phase_steps.pop()
    elif name == "log_arity":
        fri.commit_phase_steps[0].log_arity = 0
    elif name == "commit_phase_query_count":
        fri.commit_phase_steps[0].sibling_values.pop()
    elif name == "sibling_values_length":
        fri.commit_phase_steps[0].sibling_values[0].pop()
    elif name == "commit_phase_extra_digest":
        fri.commit_phase_steps[0].opening_proof.append((0,) * 4)
    elif name == "input_batch_count":
        fri.input_openings.pop()
    elif name == "input_query_count":
        fri.input_openings[1].opened_values.pop()
    elif name == "input_extra_digest":
        fri.input_openings[0].opening_proof.append((0,) * 4)
    else:
        raise ValueError(name)
    return publics


TAMPERS = ["public_values", "trace_local", "trace_next", "quotient_chunks",
           "trace_width", "trace_commitment", "quotient_commitment",
           "final_poly", "query_pow", "commit_pow",
           "commit_phase_sibling_digest", "commit_phase_sibling_value",
           "input_row", "quotient_chunk_count", "final_poly_length",
           "commit_pow_count", "commit_phase_count", "log_arity",
           "commit_phase_query_count", "sibling_values_length",
           "commit_phase_extra_digest", "input_batch_count",
           "input_query_count", "input_extra_digest"]


def _raised(fn):
    with pytest.raises(Exception) as info:
        fn()
    return info.value


@pytest.mark.parametrize("name", TAMPERS)
def test_verifiers_reject_tampered_proof_alike(proofs, name):
    """The same error class and message from both verifiers; the port's
    is a VerificationError."""
    bad = copy.deepcopy(proofs["ours"])
    publics = _tamper(name, bad, list(proofs["publics"]))
    got = _raised(lambda: verify(proofs["cfg"], proofs["air"], bad, publics))
    want = _raised(lambda: j_verify(proofs["j_cfg"], proofs["j_air"],
                                    to_reference(bad), publics))
    assert (type(got).__name__, str(got)) == (type(want).__name__,
                                               str(want))
    assert isinstance(got, VerificationError)


@pytest.mark.parametrize("bits", [1, 5, 9])
def test_grind_witness_equals_reference(bits):
    """The smallest witness after the same observations, with 0 to 3
    inputs queued: the port's batched search (`gl_permute`, plain on the
    CPU) against the reference transcript's search one witness at a
    time; afterwards both transcripts sample alike."""
    for queued in range(4):
        ours, ref = GLDuplexChallenger(), HostGrindChallenger()
        for ch in (ours, ref):
            ch.observe_many([7, P - 1, 3, 1 << 63, 5, 11, 13][:4 + queued])
        w = ours.grind(bits)
        assert w == ref.grind(bits)
        assert ours.sample_ext(2) == ref.sample_ext(2)


def test_fri_fold_matches_reference_numpy():
    """GLFriFolding's arity-2 and arity-4 folds against the reference's
    host-exact fold (`GLFriFolding._fold_step_np`)."""
    rng = np.random.default_rng(4)
    vals = rng.integers(0, P, (32, 2), dtype=np.uint64)
    beta = (int(vals[0, 0]), int(vals[1, 1]))
    got = gf.to_numpy(GLFriFolding().fold_matrix(gf.to_tensor(vals), beta, 2))
    want = gf.split_host(vals)
    b = beta
    for log_h in (4, 3):
        want = jpcs.GLFriFolding._fold_step_np(want, b, log_h)
        b = jstark.GLE.mul_h(b, b)
    assert (got == gf.join_host(want)).all()


@pytest.mark.parametrize("log_n,rate_bits", [(3, 1), (4, 2)])
def test_selectors_match_reference(log_n, rate_bits):
    from plonky3_tpu.commit.domain import TwoAdicCoset as JCoset
    from plonky3_tpu_torch.commit.domain import TwoAdicCoset

    dom = TwoAdicCoset(gf.GLF, 1, log_n)
    coset = dom.create_disjoint_domain(1 << (log_n + rate_bits))
    got = gl_selectors_on_coset(dom, coset, torch.device("cpu"))
    jdom = JCoset(jstark.GLF, 1, log_n)
    jcos = jdom.create_disjoint_domain(1 << (log_n + rate_bits))
    want = jstark.gl_selectors_on_coset(jdom, jcos)
    for k, v in want.items():
        w64 = gf.join_host(np.stack([np.asarray(v[0]), np.asarray(v[1])],
                                    axis=-1).reshape(v[0].shape[0], 2))
        assert (gf.to_numpy(got[k]) == w64[:, 0]).all(), k
