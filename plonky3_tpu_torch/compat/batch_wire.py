"""The port's `BatchRefProof` to the reference's batch wire record and
back (batch-stark/src/proof.rs layout; Montgomery-form u32 values on the
wire).

Port of `plonky3_tpu/compat/batch_wire.py`: the two-adic records
(Montgomery words, field digests) and the circle ones
(`batch_circle_proof_to_wire`, `wire_to_batch_circle_proof`: canonical
Mersenne-31 words, [u8; 32] digests, the CirclePcsProof layout).
"""

from __future__ import annotations

from ..serde.proof_codec import (WireBatchProof, WireInstanceOpened,
                                 WireSpec, decode_batch_proof,
                                 encode_batch_proof)
from ..stark.batch_ref import BatchRefOpened, BatchRefProof
from .uni_stark_wire import (_byte_digest, _exts, _words, cap_from_wire,
                             cap_to_wire, circle_pcs_proof_from_wire,
                             circle_pcs_proof_to_wire, fri_to_wire,
                             wire_to_fri)


def _cap_or_none(commitment, conv):
    return None if commitment is None else conv(commitment)


def batch_proof_to_wire(proof: BatchRefProof, F,
                        circle: bool = False) -> WireBatchProof:
    """circle: the circle layout (`batch_circle_proof_to_wire`)."""
    ext = _words(F.to_monty_h)
    digest = _byte_digest if circle else ext
    insts = [
        WireInstanceOpened(
            trace_local=[ext(t) for t in i.trace_local],
            trace_next=_exts(ext, i.trace_next),
            preprocessed_local=_exts(ext, i.preprocessed_local),
            preprocessed_next=_exts(ext, i.preprocessed_next),
            quotient_chunks=[[ext(t) for t in ch]
                             for ch in i.quotient_chunks],
            random_values=None,
            permutation_local=[ext(t) for t in i.permutation_local],
            permutation_next=[ext(t) for t in i.permutation_next])
        for i in proof.instances]
    return WireBatchProof(
        main_commit=cap_to_wire(proof.main_commit, digest),
        permutation_commit=_cap_or_none(
            proof.permutation_commit, lambda c: cap_to_wire(c, digest)),
        quotient_commit=cap_to_wire(proof.quotient_commit, digest),
        random_commit=None,
        instances=insts,
        opening_proof=(circle_pcs_proof_to_wire(proof.opening_proof)
                       if circle else fri_to_wire(proof.opening_proof, F)),
        lookup_terminals=[None if t is None else ext(t)
                          for t in proof.lookup_terminals],
        degree_bits=proof.degree_bits)


def wire_to_batch_proof(w: WireBatchProof, F,
                        circle: bool = False) -> BatchRefProof:
    """circle: the circle layout (`wire_to_batch_circle_proof`)."""
    ext = digest = _words(F.from_monty_h)
    insts = [
        BatchRefOpened(
            trace_local=[ext(t) for t in i.trace_local],
            trace_next=_exts(ext, i.trace_next),
            preprocessed_local=_exts(ext, i.preprocessed_local),
            preprocessed_next=_exts(ext, i.preprocessed_next),
            quotient_chunks=[[ext(t) for t in ch]
                             for ch in i.quotient_chunks],
            permutation_local=[ext(t) for t in i.permutation_local],
            permutation_next=[ext(t) for t in i.permutation_next])
        for i in w.instances]
    return BatchRefProof(
        main_commit=cap_from_wire(w.main_commit, digest),
        permutation_commit=_cap_or_none(
            w.permutation_commit, lambda c: cap_from_wire(c, digest)),
        quotient_commit=cap_from_wire(w.quotient_commit, digest),
        instances=insts,
        opening_proof=(circle_pcs_proof_from_wire(w.opening_proof)
                       if circle else wire_to_fri(w.opening_proof, F)),
        lookup_terminals=[None if t is None else ext(t)
                          for t in w.lookup_terminals],
        degree_bits=list(w.degree_bits))


def batch_circle_proof_to_wire(proof: BatchRefProof) -> WireBatchProof:
    from ..fields.mersenne31 import Mersenne31

    return batch_proof_to_wire(proof, Mersenne31, circle=True)


def wire_to_batch_circle_proof(w: WireBatchProof) -> BatchRefProof:
    from ..fields.mersenne31 import Mersenne31

    return wire_to_batch_proof(w, Mersenne31, circle=True)


def encode_batch_ref_proof(proof: BatchRefProof, F,
                           spec: WireSpec) -> bytes:
    return encode_batch_proof(batch_proof_to_wire(proof, F), spec)


def decode_to_batch_ref_proof(data: bytes, F,
                              spec: WireSpec) -> BatchRefProof:
    return wire_to_batch_proof(decode_batch_proof(data, spec), F)
