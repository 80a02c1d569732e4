"""Lookup buses, the interaction builder and LogUp across batch-stark
instances.

Port of `plonky3_tpu/stark/interaction.py` (lookup/src/bus.rs:26,137
LookupBus and PermutationCheckBus, builder.rs InteractionBuilder,
challenges.rs the bus-offset challenge table, logup.rs the LogUp gadget,
protocol.rs the terminal sum; batch-stark/src/prover.rs the wiring).

An AIR speaks on a bus inside its ordinary `eval`: the builder records
each `push_interaction`, so one eval serves the degree count (symbolic),
the auxiliary trace (here Montgomery tensors over the trace's rows on
its device), the quotient (the blocked fold) and the verifier's check at
zeta.

LogUp layout per instance (logup.rs:88-104): auxiliary columns 0..D the
running sum, then D columns per interaction, its fraction f_c. With
`denom_c = prefix[bus] - Σ_j β^(k-1-j)·field_j` (the last field on β^0,
the bus offset at β^W one power above any payload, challenges.rs):

    f_c · denom_c - count_c = 0            (fraction pin, every row)
    acc[0] = 0                             (first row)
    acc[i+1] = acc[i] + Σ_c f_c[i]         (transition)
    acc[n-1] + Σ_c f_c[n-1] = terminal     (last row)

Every instance commits one terminal; the verifier accepts only when the
terminals sum to zero across the batch (protocol.rs verify_terminal_sum).

The reference builds the fractions on the host with one batched
extension inverse; here they and the running sum are the canonical
batch's permutation trace with one column an interaction
(`batch_ref.generate_perm_trace`), built on the trace's device. The
words are the same.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..air.api import BaseAir, get_log_num_quotient_chunks
from ..air.builder import AirBuilder, RowWindow
from ..fri.verifier import FriError
from ..utils.timing import stage_timer
from .batch import BatchProof
from .batch_ref import bus_prefixes, generate_perm_trace, symbolic_builder
from .config import StarkConfig
from .lookup import _ext_mul_syms
from .prover import alpha_powers, publics_tensor, quotient_of_commitment
from .verifier import (VerificationError, check_constraints_at_zeta,
                       recompose_quotient)


# ---------------------------------------------------------------------------
# buses (bus.rs)
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class LookupBus:
    """Subset bus: one AIR provides a table, others query it."""

    name: str

    def lookup_key(self, builder, key, count=1, count_weight=1):
        builder.push_interaction(self.name, key, count, count_weight)

    def table_entry(self, builder, key, num_lookups):
        # a provided entry is a negative send with zero height weight
        builder.push_interaction(self.name, key,
                                 -builder.lift(num_lookups), 0)


@dataclass(frozen=True)
class PermutationCheckBus:
    """Multiset-equality bus: the sends must equal the receives."""

    name: str

    def send(self, builder, fields, count=1, count_weight=1):
        builder.push_interaction(self.name, fields, count, count_weight)

    def receive(self, builder, fields, count=1, count_weight=1):
        builder.push_interaction(self.name, fields,
                                 -builder.lift(count), count_weight)


# ---------------------------------------------------------------------------
# the challenge table (challenges.rs)
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class Challenges:
    """denominator(bus, payload) = alpha + (bus+1)·β^W - combine(payload)."""

    E: object
    alpha: tuple
    beta: tuple
    max_width: int
    bus_prefix: tuple  # per bus index

    @staticmethod
    def new(E, alpha, beta, max_width, num_buses):
        if max_width <= 0:
            raise ValueError("the widest message must have a field")
        return Challenges(E=E, alpha=alpha, beta=beta, max_width=max_width,
                          bus_prefix=tuple(bus_prefixes(
                              E, alpha, beta, max_width, num_buses)))

    def beta_powers(self, k):
        out, acc = [], self.E.one_h()
        for _ in range(k):
            out.append(acc)
            acc = self.E.mul_h(acc, self.beta)
        return out


def collect_interactions(air: BaseAir):
    """Symbolic pass: the interactions' shapes (bus, width,
    count_weight)."""
    _, builder = symbolic_builder(air)
    air.eval(builder)
    return [dict(bus=i["bus"], width=len(i["fields"]),
                 count_weight=i["count_weight"])
            for i in builder.interactions]


def bus_index_map(airs):
    """Bus name -> index, the same for prover and verifier (sorted)."""
    names = sorted({i["bus"] for air in airs
                    for i in collect_interactions(air)})
    return {n: k for k, n in enumerate(names)}


# ---------------------------------------------------------------------------
# the composite AIR (logup.rs constraints over flattened ext columns)
# ---------------------------------------------------------------------------
class BusLogUpAir(BaseAir):
    """The inner constraints, then the LogUp fraction and accumulator
    constraints.

    Trace: [main (inner.width) | acc (D) | f_0 (D) | ...]. Public values:
    the inner's, then the terminal (D components). The challenges are
    constants of the AIR (built after alpha and beta are sampled)."""

    def __init__(self, inner: BaseAir, E, challenges: Challenges,
                 bus_index: dict, n_interactions: int):
        self.inner = inner
        self.E = E
        self.challenges = challenges
        self.bus_index = bus_index
        self.n_int = n_interactions
        self.field = inner.field
        self.width = inner.width + (n_interactions + 1) * E.D
        self.num_public_values = inner.num_public_values + E.D

    def eval(self, b):
        E, D = self.E, self.E.D
        inner_w = self.inner.width
        ch = self.challenges
        inner_builder = AirBuilder(
            b.backend, RowWindow(local=b.main.local[:inner_w],
                                 next=b.main.next[:inner_w]),
            b.public_values[:self.inner.num_public_values],
            b.is_first_row, b.is_last_row, b.is_transition, b.periodic)
        self.inner.eval(inner_builder)
        inters = inner_builder.interactions
        if len(inters) != self.n_int:
            raise ValueError(f"{len(inters)} interactions, the AIR was "
                             f"built for {self.n_int}")

        acc = b.main.local[inner_w:inner_w + D]
        acc_next = b.main.next[inner_w:inner_w + D]
        terminal = b.public_values[self.inner.num_public_values:]

        frac_cols = []
        for c, inter in enumerate(inters):
            base = inner_w + (c + 1) * D
            f = b.main.local[base:base + D]
            frac_cols.append(f)
            k = len(inter["fields"])
            bpows = ch.beta_powers(k)
            # denom = prefix - Σ_j β^(k-1-j)·field_j
            denom = [b.lift(x) for x in
                     ch.bus_prefix[self.bus_index[inter["bus"]]]]
            for j, fld in enumerate(inter["fields"]):
                bp = bpows[k - 1 - j]
                for d in range(D):
                    denom[d] = denom[d] - fld * b.lift(bp[d])
            # f·denom - count = 0 (a base count: component 0)
            pin = _ext_mul_syms(E, list(f), denom)
            pin[0] = pin[0] - inter["count"]
            for d in range(D):
                b.assert_zero(pin[d])

        fsum = [None] * D
        for f in frac_cols:
            for d in range(D):
                fsum[d] = f[d] if fsum[d] is None else fsum[d] + f[d]
        if fsum[0] is None:
            fsum = [b.lift(0) for _ in range(D)]
        first = b.when_first_row()
        for d in range(D):
            first.assert_zero(acc[d])
        trans = b.when_transition()
        for d in range(D):
            trans.assert_zero(acc_next[d] - acc[d] - fsum[d])
        last = b.when_last_row()
        for d in range(D):
            last.assert_zero(acc[d] + fsum[d] - terminal[d])


# ---------------------------------------------------------------------------
# the auxiliary trace (logup.rs generate_permutation)
# ---------------------------------------------------------------------------
def generate_interaction_trace(E, air: BaseAir, trace, public_values,
                               challenges: Challenges, bus_index: dict):
    """The canonical batch's permutation trace with one column an
    interaction, on the trace's device. Returns (aux (n, (n_int+1)·D)
    Montgomery int64, the terminal ext tuple in standard form)."""
    meta = collect_interactions(air)
    if not meta:
        return (torch.zeros((trace.shape[0], E.D), dtype=torch.int64,
                            device=trace.device), E.zero_h())
    return generate_perm_trace(
        E, air, trace, public_values, [[c] for c in range(len(meta))],
        [(challenges.bus_prefix[bus_index[m["bus"]]], challenges.beta)
         for m in meta])


# ---------------------------------------------------------------------------
# batch-stark with lookups (batch-stark/src/prover.rs lookup wiring)
# ---------------------------------------------------------------------------
@dataclass
class BatchLookupProof:
    base: BatchProof
    perm_commit: tuple
    opened_perm: list  # [instance] -> (local, next)
    terminals: list  # [instance] -> ext tuple


MAX_WIDTH_DEFAULT = 8


def _max_width(metas):
    return max([MAX_WIDTH_DEFAULT]
               + [m["width"] for meta in metas for m in meta])


def _observe_shapes(ch, log_ns, airs):
    ch.observe(len(airs))
    for log_n, air in zip(log_ns, airs):
        ch.observe(log_n)
        ch.observe(log_n)
        ch.observe(air.width)


def prove_batch_with_lookups(config: StarkConfig, instances: list,
                             spans=None) -> BatchLookupProof:
    """One proof of every instance with the buses' LogUp columns in a
    second commitment. spans: as in stark.prover.prove."""
    F, E, pcs = config.F, config.E, config.pcs
    device = instances[0].trace.device
    mark = stage_timer(spans, device)
    airs = [inst.air for inst in instances]
    bus_index = bus_index_map(airs)
    metas = [collect_interactions(a) for a in airs]
    # soundness: Σ count_weight · height < P (types.rs:48)
    total = sum(m["count_weight"] * inst.trace.shape[0]
                for inst, meta in zip(instances, metas) for m in meta)
    if total >= F.P:
        raise ValueError("lookup multiplicity height bound exceeded")

    trace_domains = [pcs.natural_domain_for_degree(inst.trace.shape[0])
                     for inst in instances]
    main_data = pcs.commit([(dom, inst.trace)
                            for dom, inst in zip(trace_domains, instances)])
    mark("commit traces")

    ch = config.initialise_challenger()
    # the raw instance shapes: the composites' widths and chunk counts
    # follow from the challenges
    _observe_shapes(ch, [d.log_n for d in trace_domains], airs)
    ch.observe_digest(main_data.root_std)
    for inst in instances:
        ch.observe_many(inst.public_values)
    alpha_l = ch.sample_ext(E.D)
    beta_l = ch.sample_ext(E.D)
    challenges = Challenges.new(E, alpha_l, beta_l, _max_width(metas),
                                len(bus_index))

    aux_traces, terminals = [], []
    for inst in instances:
        aux, terminal = generate_interaction_trace(
            E, inst.air, inst.trace, inst.public_values, challenges,
            bus_index)
        aux_traces.append(aux)
        terminals.append(terminal)
    mark("interaction: permutation traces")
    perm_data = pcs.commit(list(zip(trace_domains, aux_traces)))
    del aux_traces
    ch.observe_digest(perm_data.root_std)
    for t in terminals:
        ch.observe_ext(t)
    mark("interaction: commit permutation traces")
    alpha = ch.sample_ext(E.D)

    composites = [BusLogUpAir(inst.air, E, challenges, bus_index, len(meta))
                  for inst, meta in zip(instances, metas)]
    chunk_counts = [1 << get_log_num_quotient_chunks(c) for c in composites]
    all_chunks = []
    for i, (inst, comp, dom, n_chunks, terminal) in enumerate(zip(
            instances, composites, trace_domains, chunk_counts, terminals)):
        qd = dom.create_disjoint_domain(n_chunks << dom.log_n)
        q = quotient_of_commitment(
            config, comp, [(main_data, i), (perm_data, i)], dom, qd,
            publics_tensor(F, list(inst.public_values) + list(terminal),
                           device),
            alpha_powers(E, comp, alpha, device))
        all_chunks += zip(qd.split_domains(n_chunks),
                          qd.split_evals(n_chunks, q))
    mark("quotient eval")
    quotient_data = pcs.commit(all_chunks)
    ch.observe_digest(quotient_data.root_std)
    mark("commit quotient")

    zeta = ch.sample_ext(E.D)
    main_points = [[zeta, dom.next_point_ext(E, zeta)]
                   for dom in trace_domains]
    opened, fri_proof = pcs.open(
        [(main_data, main_points),
         (perm_data, [list(p) for p in main_points]),
         (quotient_data, [[zeta]] * len(all_chunks))], ch, spans=spans)
    mark("open (pcs + fri)")
    opened_quotient, k = [], 0
    for n_chunks in chunk_counts:
        opened_quotient.append([opened[2][k + j][0]
                                for j in range(n_chunks)])
        k += n_chunks
    n_inst = len(instances)
    base = BatchProof(
        main_commit=main_data.root_std,
        quotient_commit=quotient_data.root_std,
        opened_main=[(opened[0][i][0], opened[0][i][1])
                     for i in range(n_inst)],
        opened_quotient=opened_quotient,
        opening_proof=fri_proof,
        degree_bits=[d.log_n for d in trace_domains])
    return BatchLookupProof(
        base=base, perm_commit=perm_data.root_std,
        opened_perm=[(opened[1][i][0], opened[1][i][1])
                     for i in range(n_inst)],
        terminals=terminals)


def verify_batch_with_lookups(config: StarkConfig, airs,
                              proof: BatchLookupProof, public_values):
    """Replay the transcript, require the terminals to sum to zero, check
    the shared opening, then each composite's constraints at zeta.
    Returns None for an accepted proof; raises a VerificationError with
    the reference's message."""
    E, pcs = config.E, config.pcs
    bus_index = bus_index_map(airs)
    metas = [collect_interactions(a) for a in airs]
    base = proof.base

    total = E.zero_h()
    for t in proof.terminals:
        total = E.add_h(total, t)
    if total != E.zero_h():
        raise VerificationError("cross-AIR lookup terminal sum non-zero")

    ch = config.initialise_challenger()
    _observe_shapes(ch, base.degree_bits, airs)
    ch.observe_digest(base.main_commit)
    for pv in public_values:
        ch.observe_many(pv)
    alpha_l = ch.sample_ext(E.D)
    beta_l = ch.sample_ext(E.D)
    challenges = Challenges.new(E, alpha_l, beta_l, _max_width(metas),
                                len(bus_index))
    ch.observe_digest(proof.perm_commit)
    for t in proof.terminals:
        ch.observe_ext(t)
    alpha = ch.sample_ext(E.D)
    ch.observe_digest(base.quotient_commit)
    zeta = ch.sample_ext(E.D)

    composites = [BusLogUpAir(air, E, challenges, bus_index, len(meta))
                  for air, meta in zip(airs, metas)]
    chunk_counts = [1 << get_log_num_quotient_chunks(c) for c in composites]
    trace_domains = [pcs.natural_domain_for_degree(1 << lb)
                     for lb in base.degree_bits]

    main_coords, perm_coords, quotient_coords = [], [], []
    chunk_domain_list = []
    for dom, (lo, nx), (lp, np_), chunks, n_chunks in zip(
            trace_domains, base.opened_main, proof.opened_perm,
            base.opened_quotient, chunk_counts):
        zeta_next = dom.next_point_ext(E, zeta)
        main_coords.append((dom, [(zeta, lo), (zeta_next, nx)]))
        perm_coords.append((dom, [(zeta, lp), (zeta_next, np_)]))
        cds = dom.create_disjoint_domain(
            n_chunks << dom.log_n).split_domains(n_chunks)
        chunk_domain_list.append(cds)
        quotient_coords += [(cdom, [(zeta, cvals)])
                            for cdom, cvals in zip(cds, chunks)]
    try:
        pcs.verify([(base.main_commit, main_coords),
                    (proof.perm_commit, perm_coords),
                    (base.quotient_commit, quotient_coords)],
                   base.opening_proof, ch)
    except FriError as e:
        raise VerificationError(f"InvalidOpeningArgument: {e}") from e

    for comp, meta, dom, (lo_m, nx_m), (lo_p, nx_p), chunks, cds, pv, \
            terminal in zip(composites, metas, trace_domains,
                            base.opened_main, proof.opened_perm,
                            base.opened_quotient, chunk_domain_list,
                            public_values, proof.terminals):
        if (len(lo_m) != comp.inner.width
                or len(lo_p) != (len(meta) + 1) * E.D):
            raise VerificationError("InvalidProofShape: opened widths")
        check_constraints_at_zeta(
            E, comp, alpha, zeta, dom, list(lo_m) + list(lo_p),
            list(nx_m) + list(nx_p),
            [E.from_base_h(int(x)) for x in list(pv) + list(terminal)],
            recompose_quotient(E, cds, chunks, zeta),
            "OodEvaluationMismatch (lookup batch)")
