"""uni-stark verifier (uni-stark/src/verifier.rs:273).

Port of `plonky3_tpu/stark/verifier.py`. It replays the prover's
transcript, checks the proof's shape, runs the PCS verification, rebuilds
the quotient at zeta from its chunks (recompose_quotient_from_chunks :98)
and checks C_fold(zeta) / Z_H(zeta) == Q(zeta) (verify_constraints :142).

Under a ZK PCS `verify` runs `stark/zk.py::verify_zk`. The verifier
runs on the host, as the reference's does: it takes a `Proof`
of Python ints, works on Python ints and numpy, and launches nothing.
"""

from __future__ import annotations

from ..air.api import BaseAir, _make_builder, get_log_num_quotient_chunks
from ..air.builder import VerifierBackend
from ..fri.verifier import FriError
from .config import StarkConfig
from .proof import Proof
from .prover import periodic_coeffs


class VerificationError(Exception):
    """A rejected proof (uni-stark/src/error.rs:10); the subclasses are
    the reference's error variants."""


class InvalidProofShape(VerificationError):
    """Widths, chunk counts or the degree do not fit the AIR."""


class OodPointInDomain(VerificationError):
    """The sampled out-of-domain point lies on the trace domain."""


class InvalidOpeningArgument(VerificationError):
    """The PCS / FRI opening proof failed (the FriError's message
    follows)."""


class OodEvaluationMismatch(VerificationError):
    """C_fold(zeta) / Z_H(zeta) != Q(zeta) (verifier.rs:197)."""


def recompose_quotient(E, chunk_domains, chunks, zeta):
    """Q(zeta) from its chunks' openings (verifier.rs:98): chunk i
    weighted by the product over the other chunks' vanishing polynomials,
    normalised at chunk i's first point; chunk[d] is Q's d-th basis
    coordinate polynomial at zeta."""
    quotient = E.zero_h()
    for i, (dom, chunk) in enumerate(zip(chunk_domains, chunks)):
        zp = E.one_h()
        for j, other in enumerate(chunk_domains):
            if j != i:
                num = other.vanishing_poly_at_point_ext(E, zeta)
                den = other.vanishing_poly_at_point_ext(
                    E, E.from_base_h(dom.first_point()))
                zp = E.mul_h(zp, E.mul_h(num, E.inv_h(den)))
        val = E.zero_h()
        for d, c in enumerate(chunk):
            basis = [0] * E.D
            basis[d] = 1
            val = E.add_h(val, E.mul_h(c, tuple(basis)))
        quotient = E.add_h(quotient, E.mul_h(zp, val))
    return quotient


def periodic_at_zeta(F, E, air, zeta, n):
    """Each periodic column's f(zeta^r), r = n/p, by Horner over the
    period's coefficients: extension tuples."""
    out = []
    for col in air.periodic_columns():
        z_r = E.exp_h(zeta, n // len(col))
        acc = E.zero_h()
        for c in reversed(periodic_coeffs(F, col)):
            acc = E.add_h(E.mul_h(acc, z_r), E.from_base_h(c))
        out.append(acc)
    return out


def check_constraints_at_zeta(E, air, alpha, zeta, trace_domain,
                              trace_local, trace_next, publics, quotient,
                              message="OodEvaluationMismatch",
                              error=VerificationError, periodic=(),
                              after_eval=None):
    """C_fold(zeta)·Z_H(zeta)^-1 against the recomposed quotient; raises
    error(message). publics and periodic (the periodic columns at zeta,
    `periodic_at_zeta`): extension tuples. after_eval(builder, backend)
    emits further constraints after air.eval (the batch's lookups)."""
    sels = trace_domain.selectors_at_point_ext(E, zeta)
    backend = VerifierBackend(E, alpha)

    def entry(kind, j):
        if kind == "local":
            return trace_local[j]
        if kind == "next":
            return trace_next[j]
        return sels[kind]

    builder = _make_builder(backend, air.width, air.num_public_values,
                            entry, lambda j: publics[j],
                            num_periodic=len(periodic),
                            periodic_entry=lambda j: periodic[j])
    air.eval(builder)
    if after_eval is not None:
        after_eval(builder, backend)
    if E.mul_h(backend.acc, sels["inv_vanishing"]) != quotient:
        raise error(message)


def verify(config: StarkConfig, air: BaseAir, proof: Proof, public_values):
    """Return None for an accepted proof; raise a VerificationError."""
    F, E, pcs = config.F, config.E, config.pcs
    if getattr(pcs, "ZK", False):
        from .zk import verify_zk

        return verify_zk(config, air, proof, public_values)
    log_n = proof.degree_bits
    # the PCS's largest LDE where it says (the circle group's 30), else
    # the two-adicity (the reference's rule, stark/verifier.py:55-56)
    log_max = getattr(pcs, "log_max_lde_height", None)
    log_max = log_max() if log_max else F.TWO_ADICITY
    if log_n > log_max - pcs.fri.log_blowup:
        raise InvalidProofShape("InvalidProofShape: degree too large")
    n = 1 << log_n
    num_chunks = 1 << get_log_num_quotient_chunks(air)

    ov = proof.opened_values
    uses_next = air.main_next_row_columns() != []
    if (len(ov.trace_local) != air.width
            or (uses_next and (ov.trace_next is None
                               or len(ov.trace_next) != air.width))
            or (not uses_next and ov.trace_next is not None)
            or len(ov.quotient_chunks) != num_chunks
            or any(len(ch) != E.D for ch in ov.quotient_chunks)):
        raise InvalidProofShape("InvalidProofShape: opened value shapes")

    trace_domain = pcs.natural_domain_for_degree(n)
    chunk_domains = trace_domain.create_disjoint_domain(
        n * num_chunks).split_domains(num_chunks)

    ch = config.initialise_challenger()
    ch.observe(log_n)  # log_ext_degree (== log_n without ZK)
    ch.observe(log_n)
    ch.observe(0)  # preprocessed width
    ch.observe_digest(proof.commitments.trace)
    ch.observe_many(public_values)
    alpha = ch.sample_ext(E.D)
    ch.observe_digest(proof.commitments.quotient_chunks)
    zeta = ch.sample_ext(E.D)
    zeta_next = trace_domain.next_point_ext(E, zeta)

    # the opening at zeta divides by Z_H, zero exactly on the trace domain
    # (verifier.rs:448); honest sampling lands there with probability
    # |H| / |E|
    if trace_domain.vanishing_poly_at_point_ext(E, zeta) == E.zero_h():
        raise OodPointInDomain("OodPointInDomain")

    trace_claims = [(zeta, ov.trace_local)]
    if uses_next:
        trace_claims.append((zeta_next, ov.trace_next))
    try:
        pcs.verify(
            [(proof.commitments.trace, [(trace_domain, trace_claims)]),
             (proof.commitments.quotient_chunks,
              [(dom, [(zeta, vals)])
               for dom, vals in zip(chunk_domains, ov.quotient_chunks)])],
            proof.opening_proof, ch)
    except FriError as e:
        raise InvalidOpeningArgument(f"InvalidOpeningArgument: {e}") from e

    quotient = recompose_quotient(E, chunk_domains, ov.quotient_chunks,
                                  zeta)

    # the folded constraints at zeta (verify_constraints :142); without
    # next-row reads the window's next entries are zeros the AIR never
    # reads
    trace_next = ov.trace_next
    if trace_next is None:
        trace_next = [E.zero_h()] * air.width
    check_constraints_at_zeta(
        E, air, alpha, zeta, trace_domain, ov.trace_local, trace_next,
        [E.from_base_h(v) for v in public_values], quotient,
        error=OodEvaluationMismatch,
        periodic=periodic_at_zeta(F, E, air, zeta, n))
