"""batch-stark, the lookup-free subset: many AIR instances under ONE trace
commitment and ONE shared FRI opening (batch-stark/src/prover.rs:103; no
ZK, no lookups).

Port of `plonky3_tpu/stark/batch.py`. The reference's canonical batch
prover, `stark/batch_ref.py` (lookups, global preprocessed columns), comes
with M17's interactions.

Transcript (batch-stark/src/transcript.rs): observe the number of
instances; per instance (log_ext_degree, log_degree, width, number of
quotient chunks); the main commitment; each instance's public values;
each preprocessed width (0); alpha; the quotient commitment; zeta; then
pcs.open([(main, [[zeta, g_i·zeta]] per instance), (quotient, [[zeta]]
per chunk)]).

The instances may differ in height: the Merkle tree injects the shorter
matrices as it climbs (under the keccak config through `compress_kernel`).
"""

from __future__ import annotations

from dataclasses import dataclass

from ..air.api import get_log_num_quotient_chunks
from ..fri.verifier import FriError
from ..utils.timing import stage_timer
from .config import StarkConfig
from .prover import alpha_powers, publics_tensor, quotient_of_commitment
from .verifier import (VerificationError, check_constraints_at_zeta,
                       recompose_quotient)


@dataclass
class BatchInstance:
    air: object
    trace: object  # (n, width) int64 Montgomery tensor
    public_values: list


@dataclass
class BatchProof:
    main_commit: tuple
    quotient_commit: tuple
    opened_main: list  # [instance] -> (local, next) lists of ext tuples
    opened_quotient: list  # [instance] -> [chunk] -> ext tuple list
    opening_proof: object
    degree_bits: list


def _observe_bindings(ch, log_ns, airs, chunk_counts):
    ch.observe(len(airs))
    for log_n, air, n_chunks in zip(log_ns, airs, chunk_counts):
        ch.observe(log_n)  # log_ext_degree (== log_degree without ZK)
        ch.observe(log_n)
        ch.observe(air.width)
        ch.observe(n_chunks)


def prove_batch(config: StarkConfig, instances: list,
                spans=None) -> BatchProof:
    """One proof of every instance. spans: as in stark.prover.prove."""
    F, E, pcs = config.F, config.E, config.pcs
    device = instances[0].trace.device
    mark = stage_timer(spans, device)
    airs = [inst.air for inst in instances]
    chunk_counts = [1 << get_log_num_quotient_chunks(a) for a in airs]
    trace_domains = [pcs.natural_domain_for_degree(inst.trace.shape[0])
                     for inst in instances]
    main_data = pcs.commit([(dom, inst.trace)
                            for dom, inst in zip(trace_domains, instances)])
    mark("commit traces")

    ch = config.initialise_challenger()
    _observe_bindings(ch, [d.log_n for d in trace_domains], airs,
                      chunk_counts)
    ch.observe_digest(main_data.commitment)
    for inst in instances:
        ch.observe_many(inst.public_values)
    for _ in instances:
        ch.observe(0)  # preprocessed width
    alpha = ch.sample_ext(E.D)

    all_chunks = []
    for i, (inst, dom, n_chunks) in enumerate(
            zip(instances, trace_domains, chunk_counts)):
        qd = dom.create_disjoint_domain(n_chunks << dom.log_n)
        q = quotient_of_commitment(
            config, inst.air, [(main_data, i)], dom, qd,
            publics_tensor(F, inst.public_values, device),
            alpha_powers(E, inst.air, alpha, device))
        all_chunks += zip(qd.split_domains(n_chunks),
                          qd.split_evals(n_chunks, q))
    mark("quotient eval")
    quotient_data = pcs.commit(all_chunks)
    ch.observe_digest(quotient_data.commitment)
    mark("commit quotient")

    zeta = ch.sample_ext(E.D)
    opened, fri_proof = pcs.open(
        [(main_data, [[zeta, dom.next_point_ext(E, zeta)]
                      for dom in trace_domains]),
         (quotient_data, [[zeta]] * len(all_chunks))], ch, spans=spans)
    mark("open (pcs + fri)")
    opened_quotient, k = [], 0
    for n_chunks in chunk_counts:
        opened_quotient.append([opened[1][k + j][0]
                                for j in range(n_chunks)])
        k += n_chunks
    return BatchProof(
        main_commit=main_data.commitment,
        quotient_commit=quotient_data.commitment,
        opened_main=[(opened[0][i][0], opened[0][i][1])
                     for i in range(len(instances))],
        opened_quotient=opened_quotient,
        opening_proof=fri_proof,
        degree_bits=[d.log_n for d in trace_domains],
    )


def verify_batch(config: StarkConfig, airs, proof: BatchProof,
                 public_values) -> None:
    """Return None for an accepted proof; raise a VerificationError with
    the reference's message (verifier/mod.rs)."""
    E, pcs = config.E, config.pcs
    n_inst = len(airs)
    if (len(proof.degree_bits) != n_inst or len(proof.opened_main) != n_inst
            or len(proof.opened_quotient) != n_inst
            or len(public_values) != n_inst):
        raise VerificationError("InvalidProofShape: instance count")

    chunk_counts = [1 << get_log_num_quotient_chunks(a) for a in airs]
    trace_domains = [pcs.natural_domain_for_degree(1 << lb)
                     for lb in proof.degree_bits]
    for air, (lo, nx), chunks, n_chunks in zip(
            airs, proof.opened_main, proof.opened_quotient, chunk_counts):
        if len(lo) != air.width or len(nx) != air.width:
            raise VerificationError("InvalidProofShape: trace width")
        if len(chunks) != n_chunks or any(len(c) != E.D for c in chunks):
            raise VerificationError("InvalidProofShape: quotient chunks")

    ch = config.initialise_challenger()
    _observe_bindings(ch, proof.degree_bits, airs, chunk_counts)
    ch.observe_digest(proof.main_commit)
    for pv in public_values:
        ch.observe_many(pv)
    for _ in airs:
        ch.observe(0)
    alpha = ch.sample_ext(E.D)
    ch.observe_digest(proof.quotient_commit)
    zeta = ch.sample_ext(E.D)

    main_coords, quotient_coords, chunk_domain_list = [], [], []
    for dom, (lo, nx), chunks, n_chunks in zip(
            trace_domains, proof.opened_main, proof.opened_quotient,
            chunk_counts):
        main_coords.append(
            (dom, [(zeta, lo), (dom.next_point_ext(E, zeta), nx)]))
        cds = dom.create_disjoint_domain(
            n_chunks << dom.log_n).split_domains(n_chunks)
        chunk_domain_list.append(cds)
        quotient_coords += [(cdom, [(zeta, cvals)])
                            for cdom, cvals in zip(cds, chunks)]
    try:
        pcs.verify([(proof.main_commit, main_coords),
                    (proof.quotient_commit, quotient_coords)],
                   proof.opening_proof, ch)
    except FriError as e:
        raise VerificationError(f"InvalidOpeningArgument: {e}") from e

    for air, dom, (lo, nx), chunks, cds, pv in zip(
            airs, trace_domains, proof.opened_main, proof.opened_quotient,
            chunk_domain_list, public_values):
        check_constraints_at_zeta(
            E, air, alpha, zeta, dom, lo, nx,
            [E.from_base_h(v) for v in pv],
            recompose_quotient(E, cds, chunks, zeta))
