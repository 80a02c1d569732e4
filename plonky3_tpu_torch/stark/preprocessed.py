"""Preprocessed (fixed) traces for uni-stark.

Port of `plonky3_tpu/stark/preprocessed.py` (uni-stark/src/
preprocessed.rs, prover.rs:24-72 prove_with_preprocessed). A one-time
`setup_preprocessed` commits the AIR's fixed columns; each proof opens
them at zeta and zeta·g beside the main trace. An AIR gives its fixed
columns by `preprocessed_trace(log_n)` (numpy, standard form) and reads
them in `eval` through `builder.preprocessed`, a RowWindow
(air/src/air.rs:28-45).

The prover and verifier evaluate the pair as one AIR over [main |
preprocessed] columns, so the generic quotient and the verifier's fold
apply unchanged (as in stark/lookup.py).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
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


class _WithPreprocessed(BaseAir):
    """The AIR over [main | preprocessed] columns."""

    def __init__(self, inner: BaseAir, pre_width: int):
        self.inner = inner
        self.pre_width = pre_width
        self.field = inner.field
        self.width = inner.width + pre_width
        self.num_public_values = inner.num_public_values

    def eval(self, b):
        mw = self.inner.width
        child = AirBuilder(
            b.backend, RowWindow(local=b.main.local[:mw],
                                 next=b.main.next[:mw]),
            b.public_values, b.is_first_row, b.is_last_row,
            b.is_transition)
        child.preprocessed = RowWindow(local=b.main.local[mw:],
                                       next=b.main.next[mw:])
        self.inner.eval(child)


@dataclass
class PreprocessedData:
    data: object  # the PCS's prover data
    root: tuple
    width: int


def setup_preprocessed(config: StarkConfig, air: BaseAir,
                       log_n: int) -> PreprocessedData:
    """The one-time commitment to the AIR's fixed columns at height
    2^log_n, on the config's device."""
    F, pcs = config.F, config.pcs
    pre = air.preprocessed_trace(log_n)
    if pre is None or pre.shape[0] != 1 << log_n:
        raise ValueError(f"the AIR's preprocessed trace is not 2^{log_n} "
                         f"rows")
    mat = torch.from_numpy(F.to_monty_np(pre).astype(np.int64))
    data = pcs.commit([(pcs.natural_domain_for_degree(1 << log_n),
                        mat.to(config.device))])
    return PreprocessedData(data=data, root=data.commitment,
                            width=pre.shape[1])


def prove_with_preprocessed(config: StarkConfig, air: BaseAir, trace,
                            public_values, pre: PreprocessedData,
                            spans=None) -> Proof:
    """prove() with the preprocessed columns opened beside the trace.
    spans: as in stark.prover.prove."""
    F, E, pcs = config.F, config.E, config.pcs
    device = trace.device
    mark = stage_timer(spans, device)
    n = trace.shape[0]
    log_n = log2_strict(n)
    comp = _WithPreprocessed(air, pre.width)
    num_chunks = 1 << get_log_num_quotient_chunks(comp)

    trace_domain = pcs.natural_domain_for_degree(n)
    trace_data = pcs.commit([(trace_domain, trace)])
    mark("commit trace")

    ch = config.initialise_challenger()
    ch.observe(log_n)
    ch.observe(log_n)
    ch.observe(pre.width)
    ch.observe_digest(trace_data.commitment)
    ch.observe_digest(pre.root)
    ch.observe_many(public_values)
    alpha = ch.sample_ext(E.D)

    qd = trace_domain.create_disjoint_domain(num_chunks << log_n)
    q = quotient_of_commitment(
        config, comp, [(trace_data, 0), (pre.data, 0)], trace_domain, qd,
        publics_tensor(F, public_values, device),
        alpha_powers(E, comp, alpha, device))
    mark("quotient eval")
    quotient_data = pcs.commit(list(zip(qd.split_domains(num_chunks),
                                        qd.split_evals(num_chunks, q))))
    ch.observe_digest(quotient_data.commitment)
    mark("commit quotient")

    zeta = ch.sample_ext(E.D)
    zeta_next = trace_domain.next_point_ext(E, zeta)
    opened, fri_proof = pcs.open(
        [(trace_data, [[zeta, zeta_next]]),
         (pre.data, [[zeta, zeta_next]]),
         (quotient_data, [[zeta]] * num_chunks)], ch, spans=spans)
    mark("open (pcs + fri)")
    return Proof(
        commitments=Commitments(trace=trace_data.commitment,
                                quotient_chunks=quotient_data.commitment),
        opened_values=OpenedValues(
            trace_local=opened[0][0][0] + opened[1][0][0],
            trace_next=opened[0][0][1] + opened[1][0][1],
            quotient_chunks=[opened[2][i][0] for i in range(num_chunks)]),
        opening_proof=fri_proof,
        degree_bits=log_n,
    )


def verify_with_preprocessed(config: StarkConfig, air: BaseAir,
                             proof: Proof, public_values, pre_root,
                             pre_width: int):
    """Return None for an accepted proof; raise a VerificationError with
    the reference's message."""
    E, pcs = config.E, config.pcs
    log_n = proof.degree_bits
    comp = _WithPreprocessed(air, pre_width)
    num_chunks = 1 << get_log_num_quotient_chunks(comp)

    ov = proof.opened_values
    if (len(ov.trace_local) != comp.width
            or len(ov.trace_next) != comp.width):
        raise VerificationError("InvalidProofShape")

    trace_domain = pcs.natural_domain_for_degree(1 << log_n)
    chunk_domains = trace_domain.create_disjoint_domain(
        num_chunks << log_n).split_domains(num_chunks)

    ch = config.initialise_challenger()
    ch.observe(log_n)
    ch.observe(log_n)
    ch.observe(pre_width)
    ch.observe_digest(proof.commitments.trace)
    ch.observe_digest(pre_root)
    ch.observe_many(public_values)
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
             (pre_root,
              [(trace_domain, [(zeta, ov.trace_local[mw:]),
                               (zeta_next, ov.trace_next[mw:])])]),
             (proof.commitments.quotient_chunks,
              [(dom, [(zeta, vals)])
               for dom, vals in zip(chunk_domains, ov.quotient_chunks)])],
            proof.opening_proof, ch)
    except FriError as e:
        raise VerificationError(f"InvalidOpeningArgument: {e}") from e

    check_constraints_at_zeta(
        E, comp, alpha, zeta, trace_domain, ov.trace_local, ov.trace_next,
        [E.from_base_h(v) for v in public_values],
        recompose_quotient(E, chunk_domains, ov.quotient_chunks, zeta))
