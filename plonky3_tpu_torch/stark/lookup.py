"""The LogUp lookup argument (the `lookup` crate's core) over uni-stark.

Port of `plonky3_tpu/stark/lookup.py` (lookup/src/logup.rs:1-18). The
log-derivative form

    Σ_i m_i/(β - a_i)  =  Σ_j m'_j/(β - b_j)

is a running sum s over the extension field in an auxiliary trace:

    s_first = 0
    s_next - s = term(row)            (transition)
    s_last + term(last) = 0           (terminal balance)

with term = m_a/(β - a) - m_b/(β - b). The auxiliary trace is committed
in a SECOND commitment, after β is sampled from the main one. The
constraints stay polynomial by multiplying through the denominators:

    (s_next - s)·(β-a)·(β-b) - m_a·(β-b) + m_b·(β-a) = 0

Extension arithmetic inside the constraints runs over the D base columns
of s (explicit bilinear formulas), so the composite is a base-field AIR
and the generic prover and verifier apply unchanged.

Scope, as the reference's: one lookup a proof, one column sent and one
received, each with a multiplicity column (a, m_a, b, m_b by index). The
bus and interaction builder come with `stark/interaction.py` (M17).

The reference builds the running sum by a host loop of extension
inverses, a row at a time; here every row's two terms come at once on the
trace's device and the sum is a prefix sum per coordinate. The words are
the same.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..air.api import BaseAir, get_log_num_quotient_chunks
from ..air.builder import AirBuilder, RowWindow
from ..fri.verifier import FriError
from ..utils.bits import log2_strict
from ..utils.timing import stage_timer
from .config import StarkConfig
from .proof import Commitments, OpenedValues, Proof
from .prover import alpha_powers, publics_tensor, quotient_of_commitment
from .verifier import (VerificationError, check_constraints_at_zeta,
                       recompose_quotient)


@dataclass(frozen=True)
class LookupColumns:
    """Column indices in the main trace: the sent value and multiplicity,
    the received (table) value and multiplicity."""

    a: int
    m_a: int
    b: int
    m_b: int


def _ext_mul_syms(E, x, y):
    """The extension product over lists of D Syms (X^D - W algebra)."""
    D, W = E.D, E.W
    out = [None] * D
    for i in range(D):
        for j in range(D):
            prod = x[i] * y[j]
            k = i + j
            if k >= D:
                k -= D
                prod = prod * W
            out[k] = prod if out[k] is None else out[k] + prod
    return out


class LogUpAir(BaseAir):
    """The inner AIR's constraints and the LogUp running sum.

    Trace: [main (inner.width) | s (D columns)]. Public values: the
    inner's, then β (D components)."""

    def __init__(self, inner: BaseAir, cols: LookupColumns, E):
        self.inner = inner
        self.cols = cols
        self.E = E
        self.field = inner.field
        self.width = inner.width + E.D
        self.num_public_values = inner.num_public_values + E.D

    def eval(self, b):
        inner_w = self.inner.width
        D = self.E.D
        self.inner.eval(AirBuilder(
            b.backend, RowWindow(local=b.main.local[:inner_w],
                                 next=b.main.next[:inner_w]),
            b.public_values[:self.inner.num_public_values],
            b.is_first_row, b.is_last_row, b.is_transition))

        beta = b.public_values[self.inner.num_public_values:]
        s = b.main.local[inner_w:]
        s_next = b.main.next[inner_w:]
        c = self.cols
        a, m_a = b.main.local[c.a], b.main.local[c.m_a]
        bb, m_b = b.main.local[c.b], b.main.local[c.m_b]

        # β - a and β - b as extension lists (the base value in slot 0)
        beta_minus_a = [beta[0] - a] + [beta[k] for k in range(1, D)]
        beta_minus_b = [beta[0] - bb] + [beta[k] for k in range(1, D)]
        prod_den = _ext_mul_syms(self.E, beta_minus_a, beta_minus_b)

        def term_expr(diff):
            """diff·(β-a)(β-b) - m_a·(β-b) + m_b·(β-a)."""
            lhs = _ext_mul_syms(self.E, diff, prod_den)
            return [lhs[k] - m_a * beta_minus_b[k] + m_b * beta_minus_a[k]
                    for k in range(D)]

        first = b.when_first_row()
        for k in range(D):
            first.assert_zero(s[k])
        trans = b.when_transition()
        for e in term_expr([s_next[k] - s[k] for k in range(D)]):
            trans.assert_zero(e)
        # the last row: (0 - s) - term(last) = 0, the terminal balance
        last = b.when_last_row()
        for e in term_expr([-s[k] for k in range(D)]):
            last.assert_zero(e)


def build_permutation_trace(E, trace, cols: LookupColumns, beta,
                            base_inv=None):
    """The (n, D) running sum, Montgomery words on the trace's device:
    row i holds the sum of the terms of rows 0..i-1. Both terms of every
    row by one extension inverse of (2, n) denominators, whose norms take
    `base_inv` (default the base field's `batch_inv`; the Fermat inverse
    gives the same bits), then a prefix sum per coordinate. Raises
    ValueError when the sum does not return to 0."""
    F = E.base
    vals = torch.stack([trace[:, cols.a], trace[:, cols.b]])
    mults = torch.stack([trace[:, cols.m_a], trace[:, cols.m_b]])
    den = E.sub(E.const(beta, trace.device), E.from_base(vals))
    t = E.base_mul(mults, E.inv(den, base_inv or F.batch_inv))
    total = torch.cumsum(E.sub(t[0], t[1]), dim=0) % F.P
    if bool(total[-1].any()):
        raise ValueError("unbalanced lookup: terminal != 0")
    return torch.cat([torch.zeros_like(total[:1]), total[:-1]])


def prove_with_lookup(config: StarkConfig, air: BaseAir, trace,
                      public_values, cols: LookupColumns, spans=None):
    """uni-stark with one LogUp lookup: main commit -> β -> permutation
    commit -> α -> the quotient of the composite AIR -> one opening.
    Returns (Proof, the permutation trace's commitment). spans: as in
    stark.prover.prove."""
    F, E, pcs = config.F, config.E, config.pcs
    device = trace.device
    mark = stage_timer(spans, device)
    n = trace.shape[0]
    log_n = log2_strict(n)

    trace_domain = pcs.natural_domain_for_degree(n)
    main_data = pcs.commit([(trace_domain, trace)])
    mark("commit trace")

    ch = config.initialise_challenger()
    ch.observe(log_n)
    ch.observe(log_n)
    ch.observe(0)
    ch.observe_digest(main_data.commitment)
    ch.observe_many(public_values)
    beta = ch.sample_ext(E.D)

    perm = build_permutation_trace(E, trace, cols, beta)
    mark("lookup: permutation trace")
    perm_data = pcs.commit([(trace_domain, perm)])
    ch.observe_digest(perm_data.commitment)
    mark("lookup: commit permutation trace")
    alpha = ch.sample_ext(E.D)

    lair = LogUpAir(air, cols, E)
    num_chunks = 1 << get_log_num_quotient_chunks(lair)
    qd = trace_domain.create_disjoint_domain(num_chunks << log_n)
    q = quotient_of_commitment(
        config, lair, [(main_data, 0), (perm_data, 0)], trace_domain, qd,
        publics_tensor(F, list(public_values) + list(beta), device),
        alpha_powers(E, lair, alpha, device))
    mark("quotient eval")
    quotient_data = pcs.commit(list(zip(qd.split_domains(num_chunks),
                                        qd.split_evals(num_chunks, q))))
    ch.observe_digest(quotient_data.commitment)
    mark("commit quotient")

    zeta = ch.sample_ext(E.D)
    zeta_next = trace_domain.next_point_ext(E, zeta)
    opened, fri_proof = pcs.open(
        [(main_data, [[zeta, zeta_next]]),
         (perm_data, [[zeta, zeta_next]]),
         (quotient_data, [[zeta]] * num_chunks)], ch, spans=spans)
    mark("open (pcs + fri)")
    return Proof(
        commitments=Commitments(trace=main_data.commitment,
                                quotient_chunks=quotient_data.commitment),
        opened_values=OpenedValues(
            trace_local=opened[0][0][0] + opened[1][0][0],
            trace_next=opened[0][0][1] + opened[1][0][1],
            quotient_chunks=[opened[2][i][0] for i in range(num_chunks)]),
        opening_proof=fri_proof,
        degree_bits=log_n,
    ), perm_data.commitment


def verify_with_lookup(config: StarkConfig, air: BaseAir, proof: Proof,
                       perm_root, public_values, cols: LookupColumns):
    """Return None for an accepted proof; raise a VerificationError with
    the reference's message."""
    E, pcs = config.E, config.pcs
    log_n = proof.degree_bits
    lair = LogUpAir(air, cols, E)
    num_chunks = 1 << get_log_num_quotient_chunks(lair)

    ov = proof.opened_values
    if (len(ov.trace_local) != lair.width
            or len(ov.trace_next) != lair.width):
        raise VerificationError("InvalidProofShape")

    trace_domain = pcs.natural_domain_for_degree(1 << log_n)
    chunk_domains = trace_domain.create_disjoint_domain(
        num_chunks << log_n).split_domains(num_chunks)

    ch = config.initialise_challenger()
    ch.observe(log_n)
    ch.observe(log_n)
    ch.observe(0)
    ch.observe_digest(proof.commitments.trace)
    ch.observe_many(public_values)
    beta = ch.sample_ext(E.D)
    ch.observe_digest(perm_root)
    alpha = ch.sample_ext(E.D)
    ch.observe_digest(proof.commitments.quotient_chunks)
    zeta = ch.sample_ext(E.D)
    zeta_next = trace_domain.next_point_ext(E, zeta)

    mw = air.width
    try:
        pcs.verify(
            [(proof.commitments.trace,
              [(trace_domain, [(zeta, ov.trace_local[:mw]),
                               (zeta_next, ov.trace_next[:mw])])]),
             (perm_root,
              [(trace_domain, [(zeta, ov.trace_local[mw:]),
                               (zeta_next, ov.trace_next[mw:])])]),
             (proof.commitments.quotient_chunks,
              [(dom, [(zeta, vals)])
               for dom, vals in zip(chunk_domains, ov.quotient_chunks)])],
            proof.opening_proof, ch)
    except FriError as e:
        raise VerificationError(f"InvalidOpeningArgument: {e}") from e

    check_constraints_at_zeta(
        E, lair, alpha, zeta, trace_domain, ov.trace_local, ov.trace_next,
        [E.from_base_h(v) for v in list(public_values) + list(beta)],
        recompose_quotient(E, chunk_domains, ov.quotient_chunks, zeta))
