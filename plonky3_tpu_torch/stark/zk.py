"""Zero-knowledge uni-stark prove and verify (uni-stark/src/prover.rs
:120-380 with `SC::Pcs::ZK = true`; the verifier's ZK branches).

Port of `plonky3_tpu/stark/zk.py`. What differs from the transparent
path:
  * the trace is committed over the DOUBLED domain through HidingFriPcs
    (random rows interleaved, random codeword columns, salted leaves);
  * the quotient has twice the chunks (and more where the doubled trace
    degree needs them: `zk_log_quotient_chunks`), and their LDEs are
    masked with v_{H_i}·t_i (`HidingFriPcs.commit_quotient`);
  * a random extension polynomial R over the doubled domain is committed
    and opened at zeta (round 0 of the FRI batch), to blind the batch
    polynomial;
  * degree_bits in the proof is log n + 1; the selectors and Z_H stay on
    the trace's own domain, and the trace opens at zeta and zeta·g.

The quotient folds by row blocks gathered from the committed rows, which
carry the random codeword column and salts after the AIR's columns; the
generic fold reads its columns by index. An AIR with its own fold takes
exactly its width, so it raises here (the reference raises a reshape
error).
"""

from __future__ import annotations

from ..air.api import BaseAir, _make_builder, get_log_num_quotient_chunks
from ..air.builder import SymbolicBackend
from ..fri.verifier import FriError
from ..utils.bits import log2_ceil, log2_strict
from ..utils.timing import stage_timer
from .config import StarkConfig
from .proof import Commitments, OpenedValues, Proof
from .prover import alpha_powers, publics_tensor, quotient_of_commitment
from .verifier import (VerificationError, check_constraints_at_zeta,
                       recompose_quotient)


def zk_log_quotient_chunks(air: BaseAir) -> int:
    """k, where the ZK quotient has 2^(k+1) chunks over a quotient domain
    of 2n·2^k rows.

    The reference takes k = get_log_num_quotient_chunks(air), which sizes
    the quotient for a trace of degree n. The ZK trace has degree 2n, so
    where the constraints multiply trace entries (KeccakAir's degree-3
    products) the quotient has degree up to (D - 1)·n, D the constraint
    degree with each trace entry counted twice: more than the reference's
    domain holds, and the reference's verifier rejects its own proof
    (OodEvaluationMismatch). Here k is the least whose domain holds it,
    and never less than the reference's: wherever the reference's proofs
    verify (FibonacciAir, whose degree-2 constraints are a selector times
    an entry) the port's are the same. Plonky3 sizes it as
    log2_ceil(degree - 1 + 1) under ZK (uni-stark/src/symbolic_builder.rs
    get_log_quotient_degree). A quotient domain larger than the trace's
    LDE needs a larger blowup (KeccakAir: log_blowup 2)."""
    backend = SymbolicBackend()
    air.eval(_make_builder(
        backend, air.width, air.num_public_values,
        lambda kind, j: {"local": 2, "next": 2, "is_transition": 0}.get(
            kind, 1),
        lambda j: 0, num_periodic=len(air.periodic_columns()),
        periodic_entry=lambda j: 1))
    d = max(backend.constraint_degrees, default=0)
    return max(get_log_num_quotient_chunks(air),
               log2_ceil(max(1, -(-(d - 1) // 2))))


def prove_zk(config: StarkConfig, air: BaseAir, trace, public_values,
             spans=None) -> Proof:
    """As stark.prover.prove, under a ZK PCS."""
    F, E, pcs = config.F, config.E, config.pcs
    device = trace.device
    mark = stage_timer(spans, device)
    n = trace.shape[0]
    log_n = log2_strict(n)
    log_ext = log_n + 1
    log_num_chunks = zk_log_quotient_chunks(air)
    num_chunks = 1 << (log_num_chunks + 1)  # ZK doubles the chunk count

    trace_domain = pcs.natural_domain_for_degree(n)
    ext_trace_domain = pcs.natural_domain_for_degree(2 * n)
    trace_data = pcs.commit([(ext_trace_domain, trace)], mark=mark)
    mark("commit trace")

    ch = config.initialise_challenger()
    ch.observe(log_ext)
    ch.observe(log_n)
    ch.observe(0)  # preprocessed width
    ch.observe_digest(trace_data.commitment)
    ch.observe_many(public_values)
    alpha = ch.sample_ext(E.D)

    quotient_domain = ext_trace_domain.create_disjoint_domain(
        1 << (log_ext + log_num_chunks))
    q_vals = quotient_of_commitment(
        config, air, [(trace_data, 0)], trace_domain, quotient_domain,
        publics_tensor(F, public_values, device),
        alpha_powers(E, air, alpha, device))
    mark("quotient eval")
    quotient_data = pcs.commit_quotient(quotient_domain, q_vals, num_chunks)
    ch.observe_digest(quotient_data.commitment)
    mark("commit quotient")
    r_commit, r_data = pcs.get_opt_randomization_poly_commitment(
        ext_trace_domain, device)
    ch.observe_digest(r_commit)
    mark("zk: commit R")

    zeta = ch.sample_ext(E.D)
    zeta_next = trace_domain.next_point_ext(E, zeta)
    (rand_cw, opened), fri_proof = pcs.open(
        [(r_data, [[zeta]]),
         (trace_data, [[zeta, zeta_next]]),
         (quotient_data, [[zeta]] * num_chunks)], ch, spans=spans)
    mark("open (pcs + fri)")
    return Proof(
        commitments=Commitments(trace=trace_data.commitment,
                                quotient_chunks=quotient_data.commitment,
                                random=r_commit),
        opened_values=OpenedValues(
            trace_local=opened[1][0][0],
            trace_next=opened[1][0][1],
            quotient_chunks=[opened[2][i][0] for i in range(num_chunks)],
            random=opened[0][0][0],
            random_codewords=rand_cw),
        opening_proof=fri_proof,
        degree_bits=log_ext,
    )


def verify_zk(config: StarkConfig, air: BaseAir, proof: Proof,
              public_values):
    """Return None for an accepted proof; raise a VerificationError with
    the reference's message."""
    F, E, pcs = config.F, config.E, config.pcs
    log_ext = proof.degree_bits
    log_n = log_ext - 1
    n = 1 << log_n
    if proof.commitments.random is None or proof.opened_values.random is None:
        raise VerificationError("MissingRandomization")

    log_num_chunks = zk_log_quotient_chunks(air)
    num_chunks = 1 << (log_num_chunks + 1)
    ov = proof.opened_values
    if (len(ov.trace_local) != air.width
            or len(ov.trace_next) != air.width
            or len(ov.quotient_chunks) != num_chunks
            or any(len(c) != E.D for c in ov.quotient_chunks)
            or len(ov.random) != E.D):
        raise VerificationError("InvalidProofShape")

    trace_domain = pcs.natural_domain_for_degree(n)
    ext_trace_domain = pcs.natural_domain_for_degree(2 * n)
    chunk_domains = ext_trace_domain.create_disjoint_domain(
        1 << (log_ext + log_num_chunks)).split_domains(num_chunks)

    ch = config.initialise_challenger()
    ch.observe(log_ext)
    ch.observe(log_n)
    ch.observe(0)
    ch.observe_digest(proof.commitments.trace)
    ch.observe_many(public_values)
    alpha = ch.sample_ext(E.D)
    ch.observe_digest(proof.commitments.quotient_chunks)
    ch.observe_digest(proof.commitments.random)
    zeta = ch.sample_ext(E.D)
    zeta_next = trace_domain.next_point_ext(E, zeta)

    if trace_domain.vanishing_poly_at_point_ext(E, zeta) == E.zero_h():
        raise VerificationError("OodPointInDomain")

    rounds = [
        (proof.commitments.random,
         [(ext_trace_domain, [(zeta, ov.random)])]),
        (proof.commitments.trace,
         [(ext_trace_domain,
           [(zeta, ov.trace_local), (zeta_next, ov.trace_next)])]),
        # the chunks are committed at blowup + 1 (commit_quotient): each
        # domain is reported one log larger, so the PCS's heights match
        # the committed trees; the recomposition keeps the true domains
        (proof.commitments.quotient_chunks,
         [(type(dom)(F=F, shift=dom.shift, log_n=dom.log_n + 1),
           [(zeta, vals)])
          for dom, vals in zip(chunk_domains, ov.quotient_chunks)]),
    ]
    try:
        pcs.verify(rounds, ov.random_codewords, proof.opening_proof, ch)
    except FriError as e:
        raise VerificationError(f"InvalidOpeningArgument: {e}") from e

    check_constraints_at_zeta(
        E, air, alpha, zeta, trace_domain, ov.trace_local, ov.trace_next,
        [E.from_base_h(v) for v in public_values],
        recompose_quotient(E, chunk_domains, ov.quotient_chunks, zeta))
