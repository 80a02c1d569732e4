"""The port's uni-stark `Proof` to the reference's wire records and back.

Port of `plonky3_tpu/compat/uni_stark_wire.py`. Wire values are
Montgomery-form u32 (monty-31 serde, monty_31.rs:167-184); the port's
proof objects hold standard-form ints. A commitment on the wire is a
MerkleCap: one digest at cap height 0, the cap's digests otherwise.
The two-adic conversions take field digests (the Poseidon2 configs and
the fixtures'). The circle ones (`circle_proof_to_wire`,
`circle_wire_to_proof`) take the circle fixtures' proofs: Mersenne-31's
canonical words, [u8; 32] keccak-256 digests and the CirclePcsProof
layout (circle/src/{pcs,proof}.rs).
"""

from __future__ import annotations

from ..fri.proof import BatchMultiOpening, CommitPhaseStep, FriProof
from ..serde.proof_codec import (WireBatchMultiOpening, WireCommitPhaseStep,
                                 WireFriProof, WireProof, WireSpec,
                                 decode_proof, encode_proof)
from ..stark.proof import Commitments, OpenedValues, Proof


def _words(conv):
    """Sequence of words (an ext element, a digest) -> the tuple of
    conv(word)."""
    return lambda seq: tuple(conv(int(c)) for c in seq)


def cap_to_wire(commitment, digest):
    """A commitment (a root digest, or a cap: a tuple of digests) -> the
    wire's cap (a list of digests)."""
    if commitment and isinstance(commitment[0], (tuple, list)):
        return [digest(d) for d in commitment]
    return [digest(commitment)]


def cap_from_wire(cap, digest):
    if len(cap) == 1:
        return digest(cap[0])
    return tuple(digest(d) for d in cap)


def _exts(ext, values):
    return None if values is None else [ext(v) for v in values]


def fri_to_wire(fp: FriProof, F) -> WireFriProof:
    m = F.to_monty_h
    ext = digest = _words(m)
    return WireFriProof(
        commit_phase_commits=[cap_to_wire(c, digest)
                              for c in fp.commit_phase_commits],
        commit_pow_witnesses=[m(int(w)) for w in fp.commit_pow_witnesses],
        input_openings=[
            WireBatchMultiOpening(
                opened_values=[[[m(int(v)) for v in row] for row in q]
                               for q in b.opened_values],
                sibling_hashes=[digest(d) for d in b.opening_proof])
            for b in fp.input_openings],
        commit_phase_openings=[
            WireCommitPhaseStep(
                log_arity=s.log_arity,
                sibling_values=[[ext(v) for v in q]
                                for q in s.sibling_values],
                sibling_hashes=[digest(d) for d in s.opening_proof])
            for s in fp.commit_phase_steps],
        final_poly=[ext(c) for c in fp.final_poly],
        query_pow_witness=m(int(fp.query_pow_witness)))


def wire_to_fri(wf: WireFriProof, F) -> FriProof:
    s = F.from_monty_h
    ext = digest = _words(s)
    return FriProof(
        commit_phase_commits=[cap_from_wire(c, digest)
                              for c in wf.commit_phase_commits],
        commit_pow_witnesses=[s(int(x)) for x in wf.commit_pow_witnesses],
        input_openings=[
            BatchMultiOpening(
                opened_values=[[[s(int(v)) for v in row] for row in q]
                               for q in b.opened_values],
                opening_proof=[digest(d) for d in b.sibling_hashes])
            for b in wf.input_openings],
        commit_phase_steps=[
            CommitPhaseStep(
                log_arity=st.log_arity,
                sibling_values=[[ext(v) for v in q]
                                for q in st.sibling_values],
                opening_proof=[digest(d) for d in st.sibling_hashes])
            for st in wf.commit_phase_openings],
        final_poly=[ext(c) for c in wf.final_poly],
        query_pow_witness=s(int(wf.query_pow_witness)))


def proof_to_wire(proof: Proof, F) -> WireProof:
    ext = digest = _words(F.to_monty_h)
    ov = proof.opened_values
    return WireProof(
        trace_commit=cap_to_wire(proof.commitments.trace, digest),
        quotient_commit=cap_to_wire(proof.commitments.quotient_chunks,
                                    digest),
        random_commit=None,
        trace_local=[ext(t) for t in ov.trace_local],
        trace_next=_exts(ext, ov.trace_next),
        preprocessed_local=None,
        preprocessed_next=None,
        quotient_chunks=[[ext(t) for t in ch] for ch in ov.quotient_chunks],
        random_values=None,
        opening_proof=fri_to_wire(proof.opening_proof, F),
        degree_bits=proof.degree_bits)


def wire_to_proof(w: WireProof, F) -> Proof:
    ext = digest = _words(F.from_monty_h)
    return Proof(
        commitments=Commitments(
            trace=cap_from_wire(w.trace_commit, digest),
            quotient_chunks=cap_from_wire(w.quotient_commit, digest)),
        opened_values=OpenedValues(
            trace_local=[ext(t) for t in w.trace_local],
            trace_next=_exts(ext, w.trace_next),
            quotient_chunks=[[ext(t) for t in ch]
                             for ch in w.quotient_chunks]),
        opening_proof=wire_to_fri(w.opening_proof, F),
        degree_bits=w.degree_bits)


def encode_our_proof(proof: Proof, F, spec: WireSpec) -> bytes:
    return encode_proof(proof_to_wire(proof, F), spec)


def decode_to_our_proof(data: bytes, F, spec: WireSpec) -> Proof:
    return wire_to_proof(decode_proof(data, spec), F)


def _byte_digest(d):
    return bytes(int(c) & 0xFF for c in d)


def circle_pcs_proof_to_wire(op) -> "WireCirclePcsProof":
    """A CirclePcsProof -> its wire record: canonical words, [u8; 32]
    digests, caps as the commitments are."""
    from ..serde.proof_codec import WireCircleInput, WireCirclePcsProof

    ext = _words(int)
    fp = op.fri_proof
    ci = fp.input_openings  # a CircleInputProof
    wire_inputs = WireCircleInput(
        input_openings=[
            WireBatchMultiOpening(
                opened_values=[[[int(v) for v in row] for row in q]
                               for q in b.opened_values],
                sibling_hashes=[_byte_digest(d) for d in b.opening_proof])
            for b in ci.input_openings],
        first_layer_siblings=[[ext(v) for v in q]
                              for q in ci.first_layer_siblings],
        first_layer_sibling_hashes=[_byte_digest(d)
                                    for d in ci.first_layer_proofs])
    wire_fri = WireFriProof(
        commit_phase_commits=[cap_to_wire(c, _byte_digest)
                              for c in fp.commit_phase_commits],
        commit_pow_witnesses=[int(w) for w in fp.commit_pow_witnesses],
        input_openings=wire_inputs,
        commit_phase_openings=[
            WireCommitPhaseStep(
                log_arity=s.log_arity,
                sibling_values=[[ext(v) for v in q]
                                for q in s.sibling_values],
                sibling_hashes=[_byte_digest(d) for d in s.opening_proof])
            for s in fp.commit_phase_steps],
        final_poly=ext(fp.final_poly[0]),
        query_pow_witness=int(fp.query_pow_witness))
    return WireCirclePcsProof(
        first_layer_commitment=cap_to_wire(op.first_layer_commitment,
                                           _byte_digest),
        lambdas=[ext(v) for v in op.lambdas], fri=wire_fri)


def circle_pcs_proof_from_wire(wop):
    from ..circle_pcs.pcs import CircleInputProof, CirclePcsProof

    ext = digest = _words(int)
    wf = wop.fri
    ci = wf.input_openings
    inputs = CircleInputProof(
        input_openings=[
            BatchMultiOpening(
                opened_values=[[[int(v) for v in row] for row in q]
                               for q in b.opened_values],
                opening_proof=[digest(d) for d in b.sibling_hashes])
            for b in ci.input_openings],
        first_layer_siblings=[[ext(v) for v in q]
                              for q in ci.first_layer_siblings],
        first_layer_proofs=[digest(d)
                            for d in ci.first_layer_sibling_hashes])
    fri = FriProof(
        commit_phase_commits=[cap_from_wire(c, digest)
                              for c in wf.commit_phase_commits],
        commit_pow_witnesses=[int(x) for x in wf.commit_pow_witnesses],
        input_openings=inputs,
        commit_phase_steps=[
            CommitPhaseStep(
                log_arity=st.log_arity,
                sibling_values=[[ext(v) for v in q]
                                for q in st.sibling_values],
                opening_proof=[digest(d) for d in st.sibling_hashes])
            for st in wf.commit_phase_openings],
        final_poly=[ext(wf.final_poly)],
        query_pow_witness=int(wf.query_pow_witness))
    return CirclePcsProof(
        first_layer_commitment=cap_from_wire(wop.first_layer_commitment,
                                             digest),
        lambdas=[ext(v) for v in wop.lambdas], fri_proof=fri)


def circle_proof_to_wire(proof: Proof) -> WireProof:
    ext = _words(int)
    ov = proof.opened_values
    return WireProof(
        trace_commit=cap_to_wire(proof.commitments.trace, _byte_digest),
        quotient_commit=cap_to_wire(proof.commitments.quotient_chunks,
                                    _byte_digest),
        random_commit=None,
        trace_local=[ext(t) for t in ov.trace_local],
        trace_next=_exts(ext, ov.trace_next),
        preprocessed_local=None,
        preprocessed_next=None,
        quotient_chunks=[[ext(t) for t in ch] for ch in ov.quotient_chunks],
        random_values=None,
        opening_proof=circle_pcs_proof_to_wire(proof.opening_proof),
        degree_bits=proof.degree_bits)


def circle_wire_to_proof(w: WireProof) -> Proof:
    ext = digest = _words(int)
    return Proof(
        commitments=Commitments(
            trace=cap_from_wire(w.trace_commit, digest),
            quotient_chunks=cap_from_wire(w.quotient_commit, digest)),
        opened_values=OpenedValues(
            trace_local=[ext(t) for t in w.trace_local],
            trace_next=_exts(ext, w.trace_next),
            quotient_chunks=[[ext(t) for t in ch]
                             for ch in w.quotient_chunks]),
        opening_proof=circle_pcs_proof_from_wire(w.opening_proof),
        degree_bits=w.degree_bits)
