"""The canonical batch STARK: LogUp lookups and global preprocessed
columns.

Port of `plonky3_tpu/stark/batch_ref.py`, the reference's canonical
batch prover (the lookup-free `stark/batch.py` is its lean subset; both
take `BatchInstance`s):
  * transcript order       batch-stark/src/transcript.rs
  * prover flow            batch-stark/src/prover.rs:103 (prove_batch)
  * keygen / CommonData    batch-stark/src/common.rs (from_airs_and_degrees)
  * lookup gadget          lookup/src/logup.rs (eval_fraction /
                           eval_accumulator), lookup/src/protocol.rs:56
                           (eval_all order), lookup/src/challenges.rs (the
                           bus-offset table), lookup/src/types.rs:249
                           (pack_same_bus)
  * proof layout           batch-stark/src/proof.rs

Constraint order (it fixes the alpha powers): the inner AIR's
constraints (air.eval), then one fraction pin per lookup column, then
the accumulator's first-row, transition and last-row constraints. The
pins and the accumulator's constraints are extension constraints, each
taking one alpha power (`assert_zero_ext`).

Where the port differs from the reference, with the same bits:
  * the permutation trace is built on the trace's device, every row at
    once (`generate_perm_trace`; the reference evaluates on the host and
    lists a periodic column row by row);
  * the quotient of an instance with lookups folds by row blocks
    (`stark/prover.py`'s blocked fold) over its main and permutation
    columns side by side, gathered from the committed LDEs, where the
    reference rolls the whole quotient domain; an instance without
    lookups folds as the uni-stark prover does (its own fold where the
    AIR has one). Each row's fold is the reference's.

This is the layout whose proofs reproduce the reference's
`batch-stark/tests/fixtures/batch_stark_two_adic_v1.postcard`.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..air.api import BaseAir, _make_builder
from ..air.builder import ProverBackend, Sym, SymbolicBackend
from ..air.composition import sub_builder
from ..fri.verifier import FriError
from ..utils.bits import log2_ceil, log2_strict
from ..utils.timing import stage_timer
from .config import StarkConfig
from .lookup import _ext_mul_syms
from .prover import alpha_powers, publics_tensor, quotient_of_commitment
from .verifier import (VerificationError, check_constraints_at_zeta,
                       periodic_at_zeta, recompose_quotient)


# ---------------------------------------------------------------------------
# the interactions' values over a trace's rows, on its device
# ---------------------------------------------------------------------------
class _ValueBackend(ProverBackend):
    """The prover backend's Montgomery arithmetic over the trace's rows,
    with every constraint dropped: what an eval's interactions carry."""

    def __init__(self, F, E, device):
        super().__init__(F, E, torch.zeros((0, E.D), dtype=torch.int64,
                                           device=device))

    def emit(self, c):
        pass

    def emit_ext(self, comps):
        pass

    def emit_block(self, v, count):
        pass


def row_values(v, n, device):
    """A value of `_ValueBackend` (a Python int or a tensor that
    broadcasts to the rows) as an (n,) int64 tensor."""
    return torch.as_tensor(v, dtype=torch.int64, device=device).expand(n)


def eval_interactions(F, E, air: BaseAir, trace, public_values):
    """air.eval over every row of the (n, width) Montgomery `trace`, the
    next row of the last wrapping to the first; returns the builder's
    interactions, their values Montgomery words over the rows (ints or
    tensors; `row_values` gives (n,) tensors)."""
    n, device = trace.shape[0], trace.device
    one = F.const(1)
    first = torch.zeros(n, dtype=torch.int64, device=device)
    first[0] = one
    last = torch.zeros(n, dtype=torch.int64, device=device)
    last[-1] = one
    trans = torch.full((n,), one, dtype=torch.int64, device=device)
    trans[-1] = 0
    sels = {"is_first_row": first, "is_last_row": last,
            "is_transition": trans}

    def entry(kind, j):
        if kind == "local":
            return trace[:, j]
        if kind == "next":
            return torch.roll(trace[:, j], -1)
        return sels[kind]

    pcols = air.periodic_columns()
    rows = torch.arange(n, device=device)

    def periodic_entry(j):
        col = torch.as_tensor(F.to_monty_np(np.asarray(
            pcols[j], dtype=np.uint32)).astype(np.int64), device=device)
        return col[rows % len(pcols[j])]

    builder = _make_builder(
        _ValueBackend(F, E, device), air.width, air.num_public_values,
        entry, lambda j: F.const(int(public_values[j])),
        num_periodic=len(pcols), periodic_entry=periodic_entry)
    air.eval(builder)
    return builder.interactions


def running_sum(E, fracs):
    """(acc (n, D) with acc[0] = 0 and acc[i+1] = acc[i] + Σ_c
    fracs[c][i], the terminal ext tuple in standard form) for (n_cols, n,
    D) Montgomery fractions: Montgomery sums are plain sums mod P."""
    P = E.base.P
    inc = torch.cumsum(fracs.sum(dim=0) % P, dim=0) % P
    acc = torch.cat([torch.zeros_like(inc[:1]), inc[:-1]])
    return acc, E.from_monty_np(inc[-1].cpu().numpy())


# ---------------------------------------------------------------------------
# symbolic interaction collection and same-bus packing (types.rs:249)
# ---------------------------------------------------------------------------
def symbolic_builder(air: BaseAir):
    """(backend, builder) of the symbolic pass over `air`'s columns,
    selectors, public values and periodic columns."""
    backend = SymbolicBackend()
    return backend, _make_builder(
        backend, air.width, air.num_public_values,
        lambda kind, j: 0 if kind == "is_transition" else 1, lambda j: 0,
        num_periodic=len(air.periodic_columns()),
        periodic_entry=lambda j: 1)


def _collect_sym(air):
    """The AIR's eval, symbolic: (backend, interactions)."""
    backend, b = symbolic_builder(air)
    air.eval(b)
    return backend, b.interactions


def _tuples_of(inter):
    """An interaction record -> (tuples, counts), the multi-tuple form."""
    if "tuples" in inter:
        return inter["tuples"], inter["counts"]
    return [inter["fields"]], [inter["count"]]


def _pin_degree(col_inters):
    """The symbolic degree of a (possibly merged) column's fraction pin:
    deg(Π denom · frac - Σ m·prefix·suffix), frac and the permutation
    entries of degree 1 (logup.rs constraint_degree)."""
    denom_degs, mult_degs = [], []
    for inter in col_inters:
        tuples, counts = _tuples_of(inter)
        for t, c in zip(tuples, counts):
            denom_degs.append(max((f.v for f in t), default=0))
            mult_degs.append(c.v if isinstance(c, Sym) else 0)
    total_denom = sum(denom_degs)
    rhs = max((m + total_denom - d for m, d in zip(mult_degs, denom_degs)),
              default=0)
    return max(total_denom + 1, rhs)


def pack_plan(sym_inters, budget):
    """types.rs pack_same_bus: a local keeps its own column (in order);
    globals bucket by bus in first-appearance order and merge greedily
    while the merged pin's degree stays within `budget`. Returns the
    columns, each a list of interaction indices."""
    plan, buses = [], []  # buses: (name, [indices]) by first appearance
    for i, inter in enumerate(sym_inters):
        if inter.get("kind", "global") == "local":
            plan.append([i])
            continue
        for name, members in buses:
            if name == inter["bus"]:
                members.append(i)
                break
        else:
            buses.append((inter["bus"], [i]))
    for _, members in buses:
        current = None
        for idx in members:
            if current is None:
                current = [idx]
                continue
            trial = current + [idx]
            if _pin_degree([sym_inters[j] for j in trial]) <= budget:
                current = trial
            else:
                plan.append(current)
                current = [idx]
        if current:
            plan.append(current)
    return plan


# ---------------------------------------------------------------------------
# the LogUp gadget over any backend (logup.rs eval_fraction/eval_accumulator)
# ---------------------------------------------------------------------------
def _ext_const(b, ext):
    """A host ext tuple -> D component Syms (base constants)."""
    return [b.lift(int(c)) for c in ext]


def _combine(b, E, fields, beta_c):
    """fold(0, |acc, e| e + acc·β) = Σ e_j·β^(k-1-j) (logup.rs:125), base
    field Syms to an ext Sym list."""
    comb = None
    for f in fields:
        if comb is None:
            comb = [f] + [b.lift(0) for _ in range(E.D - 1)]
        else:
            comb = _ext_mul_syms(E, comb, beta_c)
            comb[0] = comb[0] + f
    if comb is None:
        comb = [b.lift(0) for _ in range(E.D)]
    return comb


def eval_lookups(b, E, plan, inters, chal_pairs, perm_local, perm_next,
                 terminal):
    """Emit the lookup constraints into builder `b` in protocol.rs:56
    order: one fraction pin a column, then the accumulator's three.

    chal_pairs: [(prefix, beta)] a column (host ext tuples); perm_local,
    perm_next: the auxiliary row's (n_cols + 1)·D Syms; terminal: a host
    ext tuple."""
    D = E.D
    fracs = []
    for c, col in enumerate(plan):
        prefix_c = _ext_const(b, chal_pairs[c][0])
        beta_c = _ext_const(b, chal_pairs[c][1])
        denoms, mults = [], []
        for idx in col:
            tuples, counts = _tuples_of(inters[idx])
            for t, m in zip(tuples, counts):
                comb = _combine(b, E, t, beta_c)
                denoms.append([prefix_c[d] - comb[d] for d in range(D)])
                mults.append(b.lift(m))
        # prefix and suffix products of the denominators (logup.rs:178)
        n = len(denoms)
        one = _ext_const(b, E.one_h())
        pref = [one]
        for d_ in denoms:
            pref.append(_ext_mul_syms(E, pref[-1], d_))
        suff = [one] * (n + 1)
        for i in range(n - 1, -1, -1):
            suff[i] = _ext_mul_syms(E, suff[i + 1], denoms[i])
        numerator = None
        for i in range(n):
            term = [mults[i] * t
                    for t in _ext_mul_syms(E, pref[i], suff[i + 1])]
            numerator = term if numerator is None else [
                a + t for a, t in zip(numerator, term)]
        frac = [perm_local[(c + 1) * D + d] for d in range(D)]
        fracs.append(frac)
        pin = _ext_mul_syms(E, pref[n], frac)
        b.assert_zero_ext([pin[d] - numerator[d] for d in range(D)])

    acc = [perm_local[d] for d in range(D)]
    acc_next = [perm_next[d] for d in range(D)]
    fsum = [None] * D
    for f in fracs:
        for d in range(D):
            fsum[d] = f[d] if fsum[d] is None else fsum[d] + f[d]
    if fsum[0] is None:
        fsum = [b.lift(0)] * D
    term_c = _ext_const(b, terminal)
    b.when_first_row().assert_zero_ext(acc)
    b.when_transition().assert_zero_ext(
        [acc_next[d] - acc[d] - fsum[d] for d in range(D)])
    b.when_last_row().assert_zero_ext(
        [term_c[d] - acc[d] - fsum[d] for d in range(D)])


def layout_with_lookups(air, E, plan):
    """(number of constraints, max degree) of the inner and lookup
    constraints."""
    backend, b = symbolic_builder(air)
    air.eval(b)
    if plan:
        perm = [Sym(backend, 1) for _ in range((len(plan) + 1) * E.D)]
        chal = [(E.zero_h(), E.zero_h())] * len(plan)
        eval_lookups(b, E, plan, b.interactions, chal, perm, perm,
                     E.zero_h())
    degs = backend.constraint_degrees
    return len(degs), (max(degs) if degs else 0)


def log_chunks_with_lookups(air, E, plan):
    _, deg = layout_with_lookups(air, E, plan)
    return log2_ceil(max(max(deg, 2) - 1, 1))


class _WithLookups(BaseAir):
    """The prover's AIR of an instance with lookups: its columns, then
    its permutation trace's; the inner AIR's constraints, then the
    lookup constraints (constants: the challenges and the terminal)."""

    def __init__(self, inner, E, plan, chal_pairs, terminal):
        self.inner, self.E = inner, E
        self.plan, self.chal_pairs, self.terminal = (plan, chal_pairs,
                                                     terminal)
        self.field = inner.field
        self.width = inner.width + (len(plan) + 1) * E.D
        self.num_public_values = inner.num_public_values

    def periodic_columns(self):
        return self.inner.periodic_columns()

    def eval(self, b):
        w = self.inner.width
        self.inner.eval(sub_builder(b, 0, w))
        eval_lookups(b, self.E, self.plan, b.interactions, self.chal_pairs,
                     b.main.local[w:], b.main.next[w:], self.terminal)


# ---------------------------------------------------------------------------
# challenges (challenges.rs, transcript.rs sample_perm_challenges)
# ---------------------------------------------------------------------------
def assign_buses(all_sym_inters, all_plans):
    """Walk the instances' packed columns in order: globals share an id
    by name (first appearance), locals take fresh ids. Returns (bus ids
    per instance, number of buses, widest message)."""
    global_index, next_bus, max_w = {}, 0, 1
    per_instance = []
    for inters, plan in zip(all_sym_inters, all_plans):
        ids = []
        for col in plan:
            first = inters[col[0]]
            for idx in col:
                for t in _tuples_of(inters[idx])[0]:
                    max_w = max(max_w, len(t))
            if first.get("kind", "global") == "local":
                ids.append(next_bus)
                next_bus += 1
            else:
                name = first["bus"]
                if name not in global_index:
                    global_index[name] = next_bus
                    next_bus += 1
                ids.append(global_index[name])
        per_instance.append(ids)
    return per_instance, next_bus, max_w


def bus_prefixes(E, alpha, beta, max_w, num_buses):
    """prefix[i] = alpha + (i+1)·gamma, gamma = beta^max_w."""
    gamma = E.exp_h(beta, max_w)
    out, prefix = [], alpha
    for _ in range(num_buses):
        prefix = E.add_h(prefix, gamma)
        out.append(prefix)
    return out


def _challenges(ch, E, airs, plans):
    """Sample the lookup challenges when any instance has a lookup:
    [(prefix, beta)] a column per instance, or None."""
    if not any(plans):
        return [None] * len(airs)
    alpha_l = ch.sample_ext(E.D)
    beta_l = ch.sample_ext(E.D)
    bus_ids, num_buses, max_w = assign_buses(
        [_collect_sym(air)[1] for air in airs], plans)
    prefixes = bus_prefixes(E, alpha_l, beta_l, max_w, num_buses)
    return [[(prefixes[bid], beta_l) for bid in ids] for ids in bus_ids]


# ---------------------------------------------------------------------------
# the permutation trace (logup.rs generate_permutation)
# ---------------------------------------------------------------------------
def generate_perm_trace(E, air, trace, public_values, plan, chal_pairs):
    """The packed lookup columns of an (n, width) Montgomery trace on its
    device: per column the combined payloads, the denominators' prefix
    and suffix products, one extension inverse of their product, then
    the running sum. Returns (aux (n, (n_cols + 1)·D) Montgomery int64,
    the terminal ext tuple in standard form)."""
    F = E.base
    n, dev = trace.shape[0], trace.device
    inters = eval_interactions(F, E, air, trace, public_values)
    one = E.const(E.one_h(), dev)
    fracs = []
    for c, col in enumerate(plan):
        prefix = E.const(chal_pairs[c][0], dev)
        beta = E.const(chal_pairs[c][1], dev)
        denoms, mults = [], []
        for idx in col:
            tuples, counts = _tuples_of(inters[idx])
            for t, m in zip(tuples, counts):
                comb = None
                for f in t:
                    fv = E.from_base(row_values(f.v, n, dev))
                    comb = fv if comb is None else E.add(E.mul(comb, beta),
                                                         fv)
                denoms.append(E.sub(prefix, comb))
                mults.append(row_values(m.v, n, dev))
        k = len(denoms)
        pref = [one]
        for d_ in denoms:
            pref.append(E.mul(pref[-1], d_))
        suff = [one] * (k + 1)
        for i in range(k - 1, -1, -1):
            suff[i] = E.mul(suff[i + 1], denoms[i])
        num = None
        for i in range(k):
            term = E.base_mul(mults[i], E.mul(pref[i], suff[i + 1]))
            num = term if num is None else E.add(num, term)
        fracs.append(E.mul(num, E.inv(pref[k])))
    fracs = torch.stack(fracs)
    acc, terminal = running_sum(E, fracs)
    return torch.cat([acc] + list(fracs), dim=1), terminal


# ---------------------------------------------------------------------------
# keygen (common.rs from_airs_and_degrees)
# ---------------------------------------------------------------------------
@dataclass
class BatchRefData:
    plans: list  # per instance: the packed column plan
    log_chunks: list  # per instance
    prep_meta: list  # per instance: None | (matrix index, width)
    matrix_to_instance: list
    prep_data: object  # the PCS's prover data, or None
    prep_traces: list  # per instance: None | standard-form numpy matrix


def keygen(config: StarkConfig, airs, log_degrees) -> BatchRefData:
    """The column plans, quotient chunk counts and the one commitment of
    every instance's preprocessed columns (on the config's device)."""
    F, E, pcs = config.F, config.E, config.pcs
    plans, log_chunks = [], []
    for air in airs:
        _, sym_inters = _collect_sym(air)
        # the budget from the unpacked lookups (common.rs:276-291)
        lc = log_chunks_with_lookups(
            air, E, [[i] for i in range(len(sym_inters))])
        plan = pack_plan(sym_inters, (1 << lc) + 1)
        if log_chunks_with_lookups(air, E, plan) != lc:
            raise ValueError("packing changed the quotient's chunk count")
        plans.append(plan)
        log_chunks.append(lc)

    prep_meta, prep_traces, matrix_to_instance, mats = [], [], [], []
    for i, (air, log_n) in enumerate(zip(airs, log_degrees)):
        prep = getattr(air, "preprocessed_trace", lambda: None)()
        if prep is None or prep.shape[1] == 0:
            prep_meta.append(None)
            prep_traces.append(None)
            continue
        if prep.shape[0] != 1 << log_n:
            raise ValueError(f"instance {i}: a preprocessed trace of "
                             f"{prep.shape[0]} rows for 2^{log_n}")
        prep_meta.append((len(mats), prep.shape[1]))
        matrix_to_instance.append(i)
        mats.append((pcs.natural_domain_for_degree(1 << log_n),
                     torch.from_numpy(F.to_monty_np(prep.astype(np.uint32))
                                      .astype(np.int64)).to(config.device)))
        prep_traces.append(prep)
    return BatchRefData(
        plans=plans, log_chunks=log_chunks, prep_meta=prep_meta,
        matrix_to_instance=matrix_to_instance,
        prep_data=pcs.commit(mats) if mats else None,
        prep_traces=prep_traces)


# ---------------------------------------------------------------------------
# the proof (proof.rs)
# ---------------------------------------------------------------------------
@dataclass
class BatchRefOpened:
    trace_local: list
    trace_next: object
    preprocessed_local: object
    preprocessed_next: object
    quotient_chunks: list
    permutation_local: list
    permutation_next: list


@dataclass
class BatchRefProof:
    main_commit: object
    permutation_commit: object  # None without lookups
    quotient_commit: object
    instances: list  # [BatchRefOpened]
    opening_proof: object
    lookup_terminals: list  # per instance: ext tuple | None
    degree_bits: list


def _observe_usize(ch, E, v):
    """transcript.rs observe_usize: observe EF::from(v) = (v, 0, .., 0)."""
    ch.observe_ext(tuple([int(v)] + [0] * (E.D - 1)))


def _observe_preamble(ch, E, airs, log_degrees, n_chunks):
    _observe_usize(ch, E, len(airs))
    for air, log_n, chunks in zip(airs, log_degrees, n_chunks):
        _observe_usize(ch, E, log_n)  # log_ext_degree (no ZK)
        _observe_usize(ch, E, log_n)
        _observe_usize(ch, E, air.width)
        _observe_usize(ch, E, chunks)


def _observe_preprocessed(ch, E, data: BatchRefData):
    for meta in data.prep_meta:
        _observe_usize(ch, E, meta[1] if meta else 0)
    if data.prep_data is not None:
        ch.observe_digest(data.prep_data.commitment)


# ---------------------------------------------------------------------------
# the prover (prover.rs:103)
# ---------------------------------------------------------------------------
def prove_batch_ref(config: StarkConfig, instances, data: BatchRefData,
                    spans=None) -> BatchRefProof:
    """One proof of every instance. spans: as in stark.prover.prove."""
    F, E, pcs = config.F, config.E, config.pcs
    device = instances[0].trace.device
    mark = stage_timer(spans, device)
    airs = [inst.air for inst in instances]
    n_inst = len(instances)
    log_degrees = [log2_strict(inst.trace.shape[0]) for inst in instances]
    plans = data.plans
    n_chunks = [1 << lc for lc in data.log_chunks]
    trace_domains = [pcs.natural_domain_for_degree(1 << lb)
                     for lb in log_degrees]

    ch = config.initialise_challenger()
    _observe_preamble(ch, E, airs, log_degrees, n_chunks)
    main_data = pcs.commit([(dom, inst.trace)
                            for dom, inst in zip(trace_domains, instances)])
    mark("commit traces")
    ch.observe_digest(main_data.commitment)
    for inst in instances:
        ch.observe_many(inst.public_values)
    _observe_preprocessed(ch, E, data)
    chal_per_instance = _challenges(ch, E, airs, plans)

    terminals = [None] * n_inst
    perm_inputs, perm_index = [], {}
    for i, inst in enumerate(instances):
        if not plans[i]:
            continue
        aux, terminals[i] = generate_perm_trace(
            E, inst.air, inst.trace, inst.public_values, plans[i],
            chal_per_instance[i])
        perm_index[i] = len(perm_inputs)
        perm_inputs.append((trace_domains[i], aux))
    mark("batch_ref: perm trace")
    perm_data = pcs.commit(perm_inputs) if perm_inputs else None
    del perm_inputs
    if perm_data is not None:
        ch.observe_digest(perm_data.commitment)
        for t in terminals:
            if t is not None:
                ch.observe_ext(t)
        mark("batch_ref: commit perm trace")
    alpha = ch.sample_ext(E.D)

    all_chunks, chunk_ranges = [], []
    for i, inst in enumerate(instances):
        dom = trace_domains[i]
        qd = dom.create_disjoint_domain(n_chunks[i] << dom.log_n)
        if plans[i]:
            air = _WithLookups(inst.air, E, plans[i], chal_per_instance[i],
                               terminals[i])
            parts = [(main_data, i), (perm_data, perm_index[i])]
        else:
            air, parts = inst.air, [(main_data, i)]
        q = quotient_of_commitment(
            config, air, parts, dom, qd,
            publics_tensor(F, inst.public_values, device),
            alpha_powers(E, air, alpha, device))
        start = len(all_chunks)
        all_chunks += zip(qd.split_domains(n_chunks[i]),
                          qd.split_evals(n_chunks[i], q))
        chunk_ranges.append((start, len(all_chunks)))
    mark("quotient eval")
    quotient_data = pcs.commit(all_chunks)
    ch.observe_digest(quotient_data.commitment)
    mark("commit quotient")

    zeta = ch.sample_ext(E.D)
    uses_next = [air.main_next_row_columns() != [] for air in airs]
    rounds = [(main_data, [[zeta, dom.next_point_ext(E, zeta)] if nxt
                           else [zeta]
                           for dom, nxt in zip(trace_domains, uses_next)]),
              (quotient_data, [[zeta]] * len(all_chunks))]
    if data.prep_data is not None:
        rounds.append((data.prep_data, [
            [zeta, trace_domains[i].next_point_ext(E, zeta)]
            for i in data.matrix_to_instance]))
    if perm_data is not None:
        rounds.append((perm_data, [
            [zeta, trace_domains[i].next_point_ext(E, zeta)]
            for i in range(n_inst) if plans[i]]))
    opened, fri_proof = pcs.open(rounds, ch, spans=spans)
    mark("open (pcs + fri)")

    prep_round = 2 if data.prep_data is not None else None
    perm_round = 2 + (data.prep_data is not None)
    insts = []
    for i in range(n_inst):
        tv = opened[0][i]
        s, e = chunk_ranges[i]
        pre_l = pre_n = None
        if data.prep_meta[i] is not None:
            pre_l, pre_n = opened[prep_round][data.prep_meta[i][0]]
        pl = pn = []
        if plans[i]:
            pl, pn = opened[perm_round][perm_index[i]]
        insts.append(BatchRefOpened(
            trace_local=tv[0], trace_next=tv[1] if uses_next[i] else None,
            preprocessed_local=pre_l, preprocessed_next=pre_n,
            quotient_chunks=[opened[1][j][0] for j in range(s, e)],
            permutation_local=pl, permutation_next=pn))
    return BatchRefProof(
        main_commit=main_data.commitment,
        permutation_commit=(perm_data.commitment
                            if perm_data is not None else None),
        quotient_commit=quotient_data.commitment,
        instances=insts, opening_proof=fri_proof,
        lookup_terminals=terminals, degree_bits=log_degrees)


# ---------------------------------------------------------------------------
# the verifier (batch-stark/src/verifier)
# ---------------------------------------------------------------------------
def verify_batch_ref(config: StarkConfig, airs, proof: BatchRefProof,
                     public_values, data: BatchRefData):
    """Return None for an accepted proof; raise a VerificationError with
    the reference's message."""
    F, E, pcs = config.F, config.E, config.pcs
    n_inst = len(airs)
    plans = data.plans
    n_chunks = [1 << lc for lc in data.log_chunks]

    # the cross-AIR terminal sum (protocol.rs verify_terminal_sum)
    total = E.zero_h()
    for t in proof.lookup_terminals:
        if t is not None:
            total = E.add_h(total, t)
    if total != E.zero_h():
        raise VerificationError("lookup terminal sum non-zero")

    log_degrees = proof.degree_bits
    trace_domains = [pcs.natural_domain_for_degree(1 << d)
                     for d in log_degrees]
    ch = config.initialise_challenger()
    _observe_preamble(ch, E, airs, log_degrees, n_chunks)
    ch.observe_digest(proof.main_commit)
    for pv in public_values:
        ch.observe_many(pv)
    _observe_preprocessed(ch, E, data)
    chal_per_instance = _challenges(ch, E, airs, plans)
    if any(plans):
        if proof.permutation_commit is None:
            raise VerificationError("missing permutation commitment")
        ch.observe_digest(proof.permutation_commit)
        for t in proof.lookup_terminals:
            if t is not None:
                ch.observe_ext(t)
    alpha = ch.sample_ext(E.D)
    ch.observe_digest(proof.quotient_commit)
    zeta = ch.sample_ext(E.D)

    for i, (air, inst) in enumerate(zip(airs, proof.instances)):
        if len(inst.trace_local) != air.width:
            raise VerificationError("InvalidProofShape: trace width")
        if len(inst.quotient_chunks) != n_chunks[i]:
            raise VerificationError("InvalidProofShape: chunk count")
        want_perm = (len(plans[i]) + 1) * E.D if plans[i] else 0
        if len(inst.permutation_local) != want_perm:
            raise VerificationError("InvalidProofShape: perm width")
        if (inst.preprocessed_local is None) != (data.prep_meta[i] is None):
            raise VerificationError("InvalidProofShape: preprocessed")

    # the opening claims in round order
    main_coords, quotient_coords, prep_coords, perm_coords = [], [], [], []
    chunk_domain_list = []
    for i, (dom, inst) in enumerate(zip(trace_domains, proof.instances)):
        pts = [(zeta, inst.trace_local)]
        if airs[i].main_next_row_columns() != []:
            pts.append((dom.next_point_ext(E, zeta), inst.trace_next))
        main_coords.append((dom, pts))
        cds = dom.create_disjoint_domain(
            n_chunks[i] << dom.log_n).split_domains(n_chunks[i])
        chunk_domain_list.append(cds)
        quotient_coords += [(cdom, [(zeta, cvals)])
                            for cdom, cvals in zip(cds, inst.quotient_chunks)]
    for i in data.matrix_to_instance:
        dom, inst = trace_domains[i], proof.instances[i]
        prep_coords.append((dom, [
            (zeta, inst.preprocessed_local),
            (dom.next_point_ext(E, zeta), inst.preprocessed_next)]))
    for i in range(n_inst):
        if plans[i]:
            dom, inst = trace_domains[i], proof.instances[i]
            perm_coords.append((dom, [
                (zeta, inst.permutation_local),
                (dom.next_point_ext(E, zeta), inst.permutation_next)]))
    commits_coords = [(proof.main_commit, main_coords),
                      (proof.quotient_commit, quotient_coords)]
    if prep_coords:
        commits_coords.append((data.prep_data.commitment, prep_coords))
    if perm_coords:
        commits_coords.append((proof.permutation_commit, perm_coords))
    try:
        pcs.verify(commits_coords, proof.opening_proof, ch)
    except FriError as e:
        raise VerificationError(f"InvalidOpeningArgument: {e}") from e

    # each instance's constraints at zeta
    for i, (air, inst, dom, cds) in enumerate(
            zip(airs, proof.instances, trace_domains, chunk_domain_list)):
        if dom.vanishing_poly_at_point_ext(E, zeta) == E.zero_h():
            raise VerificationError("OodPointInDomain")

        def lookups(b, backend, i=i, inst=inst):
            eval_lookups(
                b, E, plans[i], b.interactions, chal_per_instance[i],
                [Sym(backend, v) for v in inst.permutation_local],
                [Sym(backend, v) for v in inst.permutation_next],
                proof.lookup_terminals[i])

        check_constraints_at_zeta(
            E, air, alpha, zeta, dom, inst.trace_local,
            inst.trace_next if inst.trace_next is not None
            else inst.trace_local,
            [E.from_base_h(int(v)) for v in public_values[i]],
            recompose_quotient(E, cds, inst.quotient_chunks, zeta),
            "OodEvaluationMismatch (batch ref)",
            periodic=periodic_at_zeta(F, E, air, zeta, dom.size),
            after_eval=lookups if plans[i] else None)
