"""uni-stark prover with the host transcript (uni-stark/src/prover.rs:24,
379; no ZK). Port of `plonky3_tpu/stark/prover.py`.

Transcript order (prover.rs:159-173,216,255,299): observe log_ext_degree,
log_degree, preprocessed width; the trace commitment; the public values;
sample alpha; commit the quotient chunks and observe them; sample zeta;
open [(trace, [zeta, zeta·g]), (quotient chunks, [zeta] each)].

The proof runs on the device of the trace.
"""

from __future__ import annotations

import numpy as np
import torch

from ..air.api import (
    BaseAir,
    _make_builder,
    get_log_num_quotient_chunks,
    get_symbolic_layout,
)
from ..air.builder import ProverBackend
from ..utils.bits import bitrev_permute_axis0, log2_strict
from ..utils.timing import stage_timer
from .config import StarkConfig
from .proof import Commitments, OpenedValues, Proof


def quotient_values(config: StarkConfig, air: BaseAir, trace_domain,
                    quotient_domain, trace_on_quotient_domain, publics_m,
                    alpha_pows, rows_order: str = "natural"):
    """C(T(x), T(hx), sels(x)) / Z_H(x) over the quotient domain: (Nq, D).

    rows_order 'bitrev': the rows come in the committed bit-reversed
    order (a prefix of the LDE) and the output stays in that order; only
    for AIRs that read no next row. An AIR with `fold_constraints_device`
    folds its constraints itself; any other runs its `eval` over the
    `ProverBackend` (prover.rs:399-555, the whole domain at once)."""
    F, E = config.F, config.E
    sels = trace_domain.selectors_on_coset_device(
        quotient_domain, trace_on_quotient_domain.device)
    if rows_order == "bitrev":
        if air.main_next_row_columns() != []:
            raise ValueError("bitrev rows need an AIR without next rows")
        sels = {k: bitrev_permute_axis0(v, quotient_domain.log_n)
                for k, v in sels.items()}
    if hasattr(air, "fold_constraints_device"):
        # the folds that exist read no next row (Poseidon2VectorAir), so
        # the rolled copy of the rows is not built
        folded = air.fold_constraints_device(
            F, E, trace_on_quotient_domain, None, sels, publics_m,
            alpha_pows)
    else:
        step = (0 if rows_order == "bitrev"
                else quotient_domain.size // trace_domain.size)
        folded = _fold_generic(F, E, air, trace_on_quotient_domain, step,
                               sels, publics_m, alpha_pows)
    return E.base_mul(sels["inv_vanishing"], folded)


def _fold_generic(F, E, air, rows, step, sels, publics_m, alpha_pows):
    """The alpha-folded constraints of `air.eval` over (Nq, w) rows: (Nq,
    D). The next row of x is `step` rows ahead, cyclically (the
    reference's roll). The rows are copied once, transposed, with their
    first `step` rows appended, so that every local and next column is a
    contiguous view of that copy."""
    nq, w = rows.shape
    cols = rows.new_empty((w, nq + step))
    cols[:, :nq] = rows.t()
    cols[:, nq:] = rows[:step].t()
    backend = ProverBackend(F, E, alpha_pows)

    def entry(kind, j):
        if kind == "local":
            return cols[j, :nq]
        if kind == "next":
            return cols[j, step:step + nq]
        return sels[kind]

    air.eval(_make_builder(backend, air.width, air.num_public_values,
                           entry, lambda j: publics_m[j]))
    return backend.finalize((nq,))


def prove(config: StarkConfig, air: BaseAir, trace, public_values,
          spans=None) -> Proof:
    """trace: (n, width) int64 Montgomery tensor, natural row order, on
    the config's device. spans: optional dict that collects wall-clock
    seconds per stage (the device is synchronized at each stage end)."""
    F, E, pcs = config.F, config.E, config.pcs
    if getattr(pcs, "ZK", False):
        raise NotImplementedError("ZK proofs come with ROADMAP M16")
    if trace.device.type != config.device.type:
        raise ValueError(f"trace on {trace.device}, config on "
                         f"{config.device}")
    device = trace.device
    mark = stage_timer(spans, device)
    n = trace.shape[0]
    log_n = log2_strict(n)
    num_chunks = 1 << get_log_num_quotient_chunks(air)

    trace_domain = pcs.natural_domain_for_degree(n)
    trace_data = pcs.commit([(trace_domain, trace)])
    mark("commit trace")

    ch = config.initialise_challenger()
    ch.observe(log_n)  # log_ext_degree (== log_n without ZK)
    ch.observe(log_n)
    ch.observe(0)  # preprocessed width
    ch.observe_digest(trace_data.commitment)
    ch.observe_many(public_values)
    alpha = ch.sample_ext(E.D)

    quotient_domain = trace_domain.create_disjoint_domain(n * num_chunks)
    uses_next = air.main_next_row_columns() != []
    q_order = "natural" if uses_next else "bitrev"
    trace_on_qd = pcs.get_evaluations_on_domain(trace_data, 0,
                                                quotient_domain,
                                                order=q_order)
    num_constraints, _ = get_symbolic_layout(air)
    alpha_pows = E.powers_np(alpha, num_constraints)[::-1].astype(np.int64)
    publics_m = torch.from_numpy(F.to_monty_np(np.asarray(
        public_values, dtype=np.uint32)).astype(np.int64)).to(device)
    q_vals = quotient_values(config, air, trace_domain, quotient_domain,
                             trace_on_qd, publics_m,
                             torch.from_numpy(alpha_pows).to(device),
                             rows_order=q_order)
    del trace_on_qd
    if q_order == "bitrev":
        q_vals = bitrev_permute_axis0(q_vals, quotient_domain.log_n)
    mark("quotient eval")

    # ext values -> D base columns, split into chunks, commit
    # (prover.rs:235-255, univariate.rs:98 commit_quotient)
    sub_evals = quotient_domain.split_evals(num_chunks, q_vals)
    sub_domains = quotient_domain.split_domains(num_chunks)
    quotient_data = pcs.commit(list(zip(sub_domains, sub_evals)))
    ch.observe_digest(quotient_data.commitment)
    mark("commit quotient")

    zeta = ch.sample_ext(E.D)
    zeta_next = trace_domain.next_point_ext(E, zeta)
    trace_points = [zeta, zeta_next] if uses_next else [zeta]
    opened, fri_proof = pcs.open(
        [(trace_data, [trace_points]),
         (quotient_data, [[zeta]] * num_chunks)], ch, spans=spans)
    mark("open (pcs + fri)")
    return Proof(
        commitments=Commitments(trace=trace_data.commitment,
                                quotient_chunks=quotient_data.commitment),
        opened_values=OpenedValues(
            trace_local=opened[0][0][0],
            trace_next=opened[0][0][1] if uses_next else None,
            quotient_chunks=[opened[1][i][0] for i in range(num_chunks)]),
        opening_proof=fri_proof,
        degree_bits=log_n,
    )
