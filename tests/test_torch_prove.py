"""End to end: the plonky3_tpu_torch prover's Proof equals the plonky3_tpu
prover's Proof on the same trace (the setup of tests/test_device_fs.py:
keccak config, Poseidon2VectorAir vector_len 1, log_n 6, 10 queries, 8-bit
query PoW), and the reference verifier accepts the port's proof; the same
for the port's device-transcript prover (`_prove_device_fs`, whose proof
the reference's own tests hold equal to the reference's `prove_fast`).
The port's verifier accepts all of them and the reference's proof, and
rejects each tampered proof with the error the reference's verifier
raises. Also the pieces of the prover that the end-to-end run does not
isolate: FRI folding, the coset selectors and the bit-reversed quotient
rows."""

import copy
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from plonky3_tpu.challenger import serializing as jserializing
from plonky3_tpu.commit.domain import TwoAdicCoset as JCoset
from plonky3_tpu.fields import KoalaBearExt4 as JE
from plonky3_tpu.fields.params import KoalaBear as JF
from plonky3_tpu.fri import proof as jfri_proof
from plonky3_tpu.fri.config import FriParameters as JFriParameters
from plonky3_tpu.fri.prover import fold_step_np
from plonky3_tpu.models.poseidon2_air import (
    Poseidon2VectorAir as JAir,
    generate_vectorized_trace as j_generate,
)
from plonky3_tpu.stark import proof as jstark_proof
from plonky3_tpu.stark.config import keccak_stark_config as j_config
from plonky3_tpu.stark.prover import prove as j_prove
from plonky3_tpu.stark.verifier import verify as j_verify
from plonky3_tpu_torch.air.api import get_symbolic_layout
from plonky3_tpu_torch.challenger import serializing
from plonky3_tpu_torch.commit.domain import TwoAdicCoset
from plonky3_tpu_torch.compat import fri_params_from, trace_inputs_from_numpy
from plonky3_tpu_torch.fields import KoalaBear as F
from plonky3_tpu_torch.fields import KoalaBearExt4 as E
from plonky3_tpu_torch.fri import proof as fri_proof
from plonky3_tpu_torch.fri.prover import fold_matrix, fold_step
from plonky3_tpu_torch.models.poseidon2_air import (
    Poseidon2VectorAir,
    generate_vectorized_trace,
)
from plonky3_tpu_torch.stark import fast_prover
from plonky3_tpu_torch.stark import proof as stark_proof
from plonky3_tpu_torch.stark.config import keccak_stark_config
from plonky3_tpu_torch.stark.prover import prove, quotient_values
from plonky3_tpu_torch.stark.verifier import VerificationError, verify

LOG_N = 6
PARAMS = JFriParameters(log_blowup=1, log_final_poly_len=0, max_log_arity=3,
                        num_queries=10, commit_proof_of_work_bits=0,
                        query_proof_of_work_bits=8)


def as_plain(x):
    """Nested tuples of ints (a dataclass == would also compare classes)."""
    if dataclasses.is_dataclass(x):
        return tuple((f.name, as_plain(getattr(x, f.name)))
                     for f in dataclasses.fields(x))
    if isinstance(x, (list, tuple)):
        return tuple(as_plain(v) for v in x)
    return x


_REF_CLASSES = {
    cls.__name__: cls
    for mod in (jstark_proof, jfri_proof)
    for cls in vars(mod).values()
    if dataclasses.is_dataclass(cls)
}


_PORT_CLASSES = {
    cls.__name__: cls
    for mod in (stark_proof, fri_proof)
    for cls in vars(mod).values()
    if dataclasses.is_dataclass(cls)
}


def _rebuild(x, classes):
    if dataclasses.is_dataclass(x):
        cls = classes[type(x).__name__]
        return cls(**{f.name: _rebuild(getattr(x, f.name), classes)
                      for f in dataclasses.fields(x)})
    if isinstance(x, list):
        return [_rebuild(v, classes) for v in x]
    if isinstance(x, tuple):
        return tuple(_rebuild(v, classes) for v in x)
    return x


def to_reference(x):
    """Rebuild a port proof object as the reference's classes."""
    return _rebuild(x, _REF_CLASSES)


def to_port(x):
    """Rebuild a reference proof object as the port's classes."""
    return _rebuild(x, _PORT_CLASSES)


@pytest.fixture(scope="module")
def proofs():
    """The one cold reference prove of the port's tests, and the port's
    prove and device-transcript prove of the same inputs on the CPU."""
    inputs = JF.rand_np(np.random.default_rng(3), (1 << LOG_N, 16))
    j_air = JAir(JF, 16, vector_len=1)
    j_cfg = j_config(JF, JE, PARAMS)
    j_trace, _ = j_generate(j_air, jnp.asarray(inputs))
    ref = j_prove(j_cfg, j_air, j_trace, [])

    air = Poseidon2VectorAir(F, 16, vector_len=1)
    trace, _ = generate_vectorized_trace(
        air, trace_inputs_from_numpy(inputs, "cpu"), device="cpu")
    cfg = keccak_stark_config(F, E, fri_params_from(PARAMS), device="cpu")
    ours = prove(cfg, air, trace, [])
    pulls = fast_prover.PULLS["count"]
    fast = fast_prover._prove_device_fs(cfg, air, trace, [])
    return dict(ref=ref, ours=ours, fast=fast, j_cfg=j_cfg, j_air=j_air,
                air=air, trace=trace,
                fast_pulls=fast_prover.PULLS["count"] - pulls)


def test_proof_equals_reference(proofs):
    assert as_plain(proofs["ours"]) == as_plain(proofs["ref"])
    assert proofs["ours"].degree_bits == LOG_N


def test_reference_verifier_accepts_port_proof(proofs):
    rebuilt = to_reference(proofs["ours"])
    assert rebuilt == proofs["ref"]
    j_verify(proofs["j_cfg"], proofs["j_air"], rebuilt, [])


def test_fast_proof_equals_reference(proofs):
    """The device transcript gives the host transcript's proof, with one
    device-to-host copy, and the reference verifier accepts it."""
    assert as_plain(proofs["fast"]) == as_plain(proofs["ref"])
    assert proofs["fast"] == proofs["ours"]
    assert proofs["fast_pulls"] == 1
    rebuilt = to_reference(proofs["fast"])
    assert rebuilt == proofs["ref"]
    j_verify(proofs["j_cfg"], proofs["j_air"], rebuilt, [])


def test_fast_proof_with_cap_and_commit_pow(proofs):
    """Merkle caps and a per-round FRI commit proof of work."""
    params = dataclasses.replace(fri_params_from(PARAMS),
                                 commit_proof_of_work_bits=4)
    cfg = keccak_stark_config(F, E, params, cap_height=1, device="cpu")
    air, trace = proofs["air"], proofs["trace"]
    fast = fast_prover._prove_device_fs(cfg, air, trace, [])
    assert fast == prove(cfg, air, trace, [])
    assert any(fast.opening_proof.commit_pow_witnesses)


def test_prove_fast_falls_back_without_query_pow(proofs):
    """No query proof of work (grind(0)) stays on the device path: the
    witness is 0 and the indices are sampled directly, as prove() does;
    nothing falls back."""
    params = dataclasses.replace(fri_params_from(PARAMS),
                                 query_proof_of_work_bits=0)
    cfg = keccak_stark_config(F, E, params, device="cpu")
    air, trace = proofs["air"], proofs["trace"]
    want = prove(cfg, air, trace, [])
    assert want.opening_proof.query_pow_witness == 0
    assert fast_prover._prove_device_fs(cfg, air, trace, []) == want
    assert fast_prover.prove_fast(cfg, air, trace, []) == want


def test_prove_fast_falls_back_on_cpu_only(proofs, monkeypatch):
    """Outside the device path's scope a CPU trace is proved by prove();
    the fallback is decided by the trace's device (a CUDA trace re-raises,
    tests/test_torch_cuda.py)."""
    def unsupported(*args, **kw):
        raise fast_prover._Unsupported("out of scope")

    monkeypatch.setattr(fast_prover, "_prove_device_fs", unsupported)
    cfg = keccak_stark_config(F, E, fri_params_from(PARAMS), device="cpu")
    assert fast_prover.prove_fast(cfg, proofs["air"], proofs["trace"],
                                  []) == proofs["ours"]


@pytest.mark.parametrize("which", ["ours", "fast", "ref"])
def test_verify_accepts_port_and_reference_proofs(proofs, which):
    proof = proofs[which]
    if which == "ref":
        proof = to_port(proof)
        assert proof == proofs["ours"] and type(proof) is stark_proof.Proof
    cfg = keccak_stark_config(F, E, fri_params_from(PARAMS), device="cpu")
    assert verify(cfg, proofs["air"], proof, []) is None


def test_verify_accepts_cap_and_commit_pow(proofs):
    """A Merkle cap and a commit proof of work: the port's verifier and
    the reference's accept the fast prover's proof."""
    params = dataclasses.replace(PARAMS, commit_proof_of_work_bits=4)
    cfg = keccak_stark_config(F, E, fri_params_from(params), cap_height=1,
                              device="cpu")
    proof = fast_prover._prove_device_fs(cfg, proofs["air"], proofs["trace"],
                                         [])
    assert isinstance(proof.commitments.trace[0], tuple)  # a cap
    verify(cfg, proofs["air"], proof, [])
    j_verify(j_config(JF, JE, params, cap_height=1), proofs["j_air"],
             to_reference(proof), [])


def _bump_ext(v):
    return E.add_h(v, E.one_h())


def _bump_digest(d):
    return ((d[0] + 1) & 0xFFFFFFFF,) + tuple(d[1:])


def _tamper(name, proof):
    """Change one part of `proof` in place; returns the public values the
    verifier is given."""
    ov, fri = proof.opened_values, proof.opening_proof
    if name == "public_values":
        return [1]
    if name == "trace_local":
        ov.trace_local[0] = _bump_ext(ov.trace_local[0])
    elif name == "trace_next":
        ov.trace_next[7] = _bump_ext(ov.trace_next[7])
    elif name == "quotient_chunks":
        ov.quotient_chunks[1][2] = _bump_ext(ov.quotient_chunks[1][2])
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
    elif name == "commit_phase_sibling_digest":
        step = fri.commit_phase_steps[0]
        step.opening_proof[0] = _bump_digest(step.opening_proof[0])
    elif name == "commit_phase_sibling_value":
        sib = fri.commit_phase_steps[0].sibling_values[4]
        sib[0] = _bump_ext(sib[0])
    elif name == "input_row":
        row = fri.input_openings[0].opened_values[3][0]
        row[5] = (row[5] + 1) % F.P
    # the shape checks of the PCS and FRI verifiers
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
        fri.commit_phase_steps[0].sibling_values[2].pop()
    elif name == "commit_phase_extra_digest":
        fri.commit_phase_steps[0].opening_proof.append((0,) * 8)
    elif name == "input_batch_count":
        fri.input_openings.pop()
    elif name == "input_query_count":
        fri.input_openings[1].opened_values.pop()
    elif name == "input_extra_digest":
        fri.input_openings[0].opening_proof.append((0,) * 8)
    else:
        raise ValueError(name)
    return []


TAMPERS = ["public_values", "trace_local", "trace_next", "quotient_chunks",
           "trace_width", "trace_commitment", "quotient_commitment",
           "final_poly", "query_pow", "commit_phase_sibling_digest",
           "commit_phase_sibling_value", "input_row",
           "quotient_chunk_count", "final_poly_length", "commit_pow_count",
           "commit_phase_count", "log_arity", "commit_phase_query_count",
           "sibling_values_length", "commit_phase_extra_digest",
           "input_batch_count", "input_query_count", "input_extra_digest"]


def _raised(fn):
    with pytest.raises(Exception) as info:
        fn()
    return type(info.value).__name__, str(info.value)


@pytest.mark.parametrize("name", TAMPERS)
def test_verify_rejects_tampered_proof_as_reference(proofs, name):
    """The port's verifier and the reference's raise the same error class
    with the same message on the same tampered proof."""
    bad = copy.deepcopy(proofs["ours"])
    publics = _tamper(name, bad)
    cfg = keccak_stark_config(F, E, fri_params_from(PARAMS), device="cpu")
    got = _raised(lambda: verify(cfg, proofs["air"], bad, publics))
    want = _raised(lambda: j_verify(proofs["j_cfg"], proofs["j_air"],
                                    to_reference(bad), publics))
    assert got == want
    with pytest.raises(VerificationError):
        verify(cfg, proofs["air"], bad, publics)


def test_verify_rejects_other_air(proofs):
    """An honest proof held against an AIR with one more constraint
    passes the opening checks and fails the out-of-domain check in both
    verifiers."""
    class Extra:
        def eval(self, b):
            super().eval(b)
            b.assert_zero(b.main.local[0])

    air = type("PortExtra", (Extra, Poseidon2VectorAir), {})(
        F, 16, vector_len=1)
    j_air = type("RefExtra", (Extra, JAir), {})(JF, 16, vector_len=1)
    cfg = keccak_stark_config(F, E, fri_params_from(PARAMS), device="cpu")
    got = _raised(lambda: verify(cfg, air, proofs["ours"], []))
    want = _raised(lambda: j_verify(proofs["j_cfg"], j_air, proofs["ref"],
                                    []))
    assert got == want == ("OodEvaluationMismatch", "OodEvaluationMismatch")


def test_verify_rejects_zeta_in_trace_domain(proofs, monkeypatch):
    """zeta forced onto the trace domain: OodPointInDomain from both
    verifiers (uni-stark/src/verifier.rs:448)."""
    cfg = keccak_stark_config(F, E, fri_params_from(PARAMS), device="cpu")
    point = cfg.pcs.natural_domain_for_degree(1 << LOG_N).first_point()
    for mod in (serializing, jserializing):
        orig = mod.SerializingChallenger32.sample_ext
        calls = {"n": 0}

        def patched(self, d, orig=orig, calls=calls):
            calls["n"] += 1
            out = orig(self, d)
            return E.from_base_h(point) if calls["n"] == 2 else out

        monkeypatch.setattr(mod.SerializingChallenger32, "sample_ext",
                            patched)
    got = _raised(lambda: verify(cfg, proofs["air"], proofs["ours"], []))
    want = _raised(lambda: j_verify(proofs["j_cfg"], proofs["j_air"],
                                    proofs["ref"], []))
    assert got == want == ("OodPointInDomain", "OodPointInDomain")


@pytest.mark.parametrize("log_h,log_arity", [(1, 1), (4, 1), (5, 3)])
def test_fri_fold_matches_reference(log_h, log_arity):
    rng = np.random.default_rng(log_h)
    folded = JF.rand_np(rng, (1 << log_h, 4))
    beta = JE.rand_h(rng)
    want = folded
    b = beta
    for _ in range(log_arity):
        want = fold_step_np(JE, want, b)
        b = JE.mul_h(b, b)
    t = torch.from_numpy(folded.astype(np.int64))
    got = fold_matrix(E, t, beta, log_arity)
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(fold_step(E, t, beta).numpy(),
                          fold_step_np(JE, folded, beta))


def test_selectors_match_reference():
    trace = TwoAdicCoset(F, 1, 4)
    quot = trace.create_disjoint_domain(1 << 6)
    j_trace = JCoset(JF, 1, 4)
    j_quot = j_trace.create_disjoint_domain(1 << 6)
    assert (quot.shift, quot.log_n) == (j_quot.shift, j_quot.log_n)
    got = trace.selectors_on_coset_device(quot, "cpu")
    want = j_trace.selectors_on_coset_device(j_quot)
    assert set(got) == set(want)
    for k in want:
        assert np.array_equal(got[k].numpy(), np.asarray(want[k])), k
    assert [(d.shift, d.log_n) for d in quot.split_domains(4)] == [
        (d.shift, d.log_n) for d in j_quot.split_domains(4)]


class _NoNextRowAir(Poseidon2VectorAir):
    def main_next_row_columns(self):
        return []


def test_quotient_rows_bitrev_equal_natural():
    """The bit-reversed quotient path, permuted back, gives the natural
    one for an AIR that reads no next row."""
    from plonky3_tpu_torch.utils.bits import bitrev_permute_axis0

    air = _NoNextRowAir(F, 16, vector_len=1)
    cfg = keccak_stark_config(F, E, fri_params_from(PARAMS), device="cpu")
    trace, _ = generate_vectorized_trace(
        air, F.rand_np(np.random.default_rng(1), (16, 16)), device="cpu")
    domain = cfg.pcs.natural_domain_for_degree(16)
    data = cfg.pcs.commit([(domain, trace)])
    qd = domain.create_disjoint_domain(32)
    k, _ = get_symbolic_layout(air)
    alpha = torch.from_numpy(E.powers_np((1, 2, 3, 4), k).astype(np.int64))
    args = (cfg, air, domain, qd)
    nat = quotient_values(
        *args, cfg.pcs.get_evaluations_on_domain(data, 0, qd), None, alpha)
    br = quotient_values(
        *args, cfg.pcs.get_evaluations_on_domain(data, 0, qd, "bitrev"),
        None, alpha, rows_order="bitrev")
    assert torch.equal(bitrev_permute_axis0(br, qd.log_n), nat)
