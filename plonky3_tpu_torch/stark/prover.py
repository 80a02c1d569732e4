"""uni-stark prover with the host transcript (uni-stark/src/prover.rs:24,
379). Port of `plonky3_tpu/stark/prover.py`; under a ZK PCS `prove` runs
`stark/zk.py::prove_zk`.

Transcript order (prover.rs:159-173,216,255,299): observe log_ext_degree,
log_degree, preprocessed width; the trace commitment; the public values;
sample alpha; commit the quotient chunks and observe them; sample zeta;
open [(trace, [zeta, zeta·g]), (quotient chunks, [zeta] each)].

The proof runs on the device of the trace.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..air.api import (
    BaseAir,
    _make_builder,
    get_log_num_quotient_chunks,
    get_symbolic_layout,
    get_widest_stack,
)
from ..air.builder import ProverBackend
from ..ops.ntt import coset_evals_from_coeffs
from ..utils.bits import bitrev_indices, bitrev_permute_axis0, log2_strict
from ..utils.timing import stage_timer
from .config import StarkConfig
from .proof import Commitments, OpenedValues, Proof

# blocks of quotient-domain rows folded so far and the rows of the last
# one (read by the tests and chip_smoke.py)
FOLD_BLOCKS = {"count": 0, "rows": 0}

# What one row of a fold block costs in int64 values: _ROW_COPIES of the
# AIR's width (the block's transposed rows, one copy) and _STACK_COPIES
# of its widest stacked Sym (the stacks built from it, their products
# and the Montgomery temporaries). fold_sweep.py measured 230 KB a row
# for Blake3Air (9,168 columns, widest stack 1,792), 8·(9,168 +
# 10.9·1,792), and 31 KB for KeccakAir (2,633, 100), 8·(2,633 +
# 12.6·100), on an H100 80GB HBM3 at a 700 W power limit; the constants
# hold 1.4 and 1.7 times that. A block takes at most _MEMORY_SHARE of
# the free memory.
_ROW_COPIES = 2
_STACK_COPIES = 12
_MEMORY_SHARE = 0.6


def _free_bytes(device) -> int:
    """Free memory of `device`: the driver's free memory plus the caching
    allocator's unused blocks on the card; the available physical memory
    on the host."""
    if device.type == "cuda":
        free, _ = torch.cuda.mem_get_info(device)
        return (free + torch.cuda.memory_reserved(device)
                - torch.cuda.memory_allocated(device))
    return os.sysconf("SC_AVPHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")


def fold_block_rows(air: BaseAir, nq: int, device) -> int:
    """Rows of one fold block: the largest power of two, at most nq,
    whose temporaries (`_ROW_COPIES` of the AIR's width and
    `_STACK_COPIES` of its widest stack, int64 values) fit in
    `_MEMORY_SHARE` of the device's free memory."""
    per_row = 8 * (_ROW_COPIES * air.width
                   + _STACK_COPIES * get_widest_stack(air))
    rows = max(1, int(_free_bytes(device) * _MEMORY_SHARE) // per_row)
    return min(nq, 1 << (rows.bit_length() - 1))


def periodic_coeffs(F, col):
    """The coefficients of one period of a periodic column (standard form,
    its inverse DFT exactly on the host)."""
    p = len(col)
    log_p = log2_strict(p)
    g_inv = F.inv_h(F.two_adic_generator_h(log_p)) if p > 1 else 1
    p_inv = F.inv_h(p)
    coeffs = []
    for k in range(p):
        acc, x, xp = 0, F.exp_h(g_inv, k), 1
        for i in range(p):
            acc = (acc + col[i] * xp) % F.P
            xp = F.mul_h(xp, x)
        coeffs.append(F.mul_h(acc, p_inv))
    return coeffs


def periodic_on_coset(F, pcols, trace_domain, quotient_domain, device):
    """(Nq, k) Montgomery values of each periodic column's extension
    f(X^r) over the quotient coset, natural order; None without periodic
    columns (prover.rs:434 build_periodic_lde_table). f has period p and
    r = n/p: over the coset s·<g_Nq> the values cycle with period Nq/r,
    so one small coset evaluation tiles the domain."""
    if not pcols:
        return None
    if not isinstance(quotient_domain.shift, int):
        # a circle domain's shift is a point: the reference's two-adic
        # evaluation fails there too (a periodic column's period needs
        # a two-adic generator, which Mersenne-31 lacks)
        raise NotImplementedError(
            "periodic columns need a two-adic coset; the circle STARK has "
            "none")
    n, nq = trace_domain.size, quotient_domain.size
    cols = []
    for col in pcols:
        p = len(col)
        if p > n or n % p:
            raise ValueError(f"a period of {p} rows does not divide {n}")
        r = n // p
        small = nq // r
        cm = torch.from_numpy(F.to_monty_np(np.asarray(
            periodic_coeffs(F, col), dtype=np.uint32)).astype(np.int64))
        ev_br = coset_evals_from_coeffs(
            F, cm.reshape(p, 1).to(device), log2_strict(small // p),
            F.exp_h(quotient_domain.shift, r))
        ev = bitrev_permute_axis0(ev_br, log2_strict(small))[:, 0]
        cols.append(ev.repeat(r))
    return torch.stack(cols, dim=1)


def quotient_values(config: StarkConfig, air: BaseAir, trace_domain,
                    quotient_domain, trace_on_quotient_domain, publics_m,
                    alpha_pows, rows_order: str = "natural",
                    block_rows=None):
    """C(T(x), T(hx), sels(x)) / Z_H(x) over the quotient domain: (Nq, D)
    in the order of the (Nq, w) rows.

    rows_order 'bitrev': the rows come in the committed bit-reversed
    order (a prefix of the LDE) and the output stays in that order; only
    for AIRs that read no next row. An AIR with `fold_constraints_device`
    folds its constraints itself; any other runs its `eval` over the
    `ProverBackend` block by block (`_fold_blocks`; prover.rs:399-555)."""
    if rows_order == "bitrev" and air.main_next_row_columns() != []:
        raise ValueError("bitrev rows need an AIR without next rows")
    return _quotient(config, air, trace_domain, quotient_domain,
                     trace_on_quotient_domain, rows_order, rows_order,
                     publics_m, alpha_pows, block_rows)


def committed_quotient(config: StarkConfig, air: BaseAir, trace_domain,
                       quotient_domain, lde_prefix, publics_m, alpha_pows,
                       block_rows=None):
    """The quotient in natural order, (Nq, D), from the committed
    bit-reversed LDE rows of the quotient domain (natural row i is row
    bitrev(i) of `lde_prefix`), without a whole-domain copy of them. A
    fold that reads no next row (an AIR that declares none, or the AIR's
    own `fold_constraints_device`) takes them in their own order, in
    slices; any other gathers each block's rows and next rows from
    them."""
    if (hasattr(air, "fold_constraints_device")
            or air.main_next_row_columns() == []):
        q = _quotient(config, air, trace_domain, quotient_domain,
                      lde_prefix, "bitrev", "bitrev", publics_m,
                      alpha_pows, block_rows)
        return bitrev_permute_axis0(q, quotient_domain.log_n)
    return _quotient(config, air, trace_domain, quotient_domain, lde_prefix,
                     "bitrev", "natural", publics_m, alpha_pows, block_rows)


def _quotient(config, air, trace_domain, quotient_domain, rows, rows_order,
              fold_order, publics_m, alpha_pows, block_rows):
    """The quotient over `rows` (in rows_order), folded and returned in
    fold_order."""
    F, E = config.F, config.E
    nq, device = quotient_domain.size, rows.device
    if rows.shape[0] != nq:
        raise ValueError(f"{rows.shape[0]} rows for a domain of {nq}")
    sels = trace_domain.selectors_on_coset_device(quotient_domain, device)
    periodic = periodic_on_coset(F, air.periodic_columns(), trace_domain,
                                 quotient_domain, device)
    if fold_order == "bitrev":
        sels = {k: bitrev_permute_axis0(v, quotient_domain.log_n)
                for k, v in sels.items()}
        if periodic is not None:
            periodic = bitrev_permute_axis0(periodic, quotient_domain.log_n)
    if hasattr(air, "fold_constraints_device"):
        # the folds that exist read no next row (Poseidon2VectorAir), so
        # the rolled copy of the rows is not built
        if rows_order != fold_order:
            raise ValueError("an AIR's own fold takes rows in its order")
        if rows.shape[1] != air.width:
            # the ZK rows carry a random codeword column and salts
            raise ValueError(
                f"{type(air).__name__}'s own fold reads {air.width} "
                f"columns, the rows have {rows.shape[1]}")
        folded = air.fold_constraints_device(F, E, rows, None, sels,
                                             publics_m, alpha_pows)
    else:
        step = 0 if fold_order == "bitrev" else nq // trace_domain.size
        src = (None if rows_order == fold_order else torch.from_numpy(
            bitrev_indices(quotient_domain.log_n)).to(device))

        def columns(a, b):
            # rows a..b-1 of the fold's order (mod nq), transposed: one
            # copy, gathered straight into the (w, b - a) layout
            if src is None and b <= nq:
                return rows[a:b].t().contiguous()
            idx = torch.arange(a, b, device=device) % nq
            if src is not None:
                idx = src[idx]
            return torch.index_select(rows.t(), 1, idx).contiguous()

        if block_rows is None:
            block_rows = fold_block_rows(air, nq, device)
        folded = _fold_blocks(F, E, air, nq, step, columns, sels, periodic,
                              publics_m, alpha_pows, block_rows)
    return E.base_mul(sels["inv_vanishing"], folded)


def _fold_blocks(F, E, air, nq, step, columns, sels, periodic, publics_m,
                 alpha_pows, block_rows, backend=ProverBackend):
    """The alpha-folded constraints of `air.eval` over nq rows: (nq, D),
    `block_rows` rows at a time. The next row of a row is `step` rows
    ahead, cyclically (the reference's roll); columns(a, b) gives rows a
    to b-1 (mod nq) transposed, a contiguous (w, b - a) tensor, so each
    block's rows, with the `step` rows after it, are one copy in which
    every local and next column is a contiguous view. `sels` (nq,) and
    `periodic` (nq, k) are in the fold's row order. The fold of a row
    reads no other row's, so the blocks give the whole domain's bits.
    `backend(F, E, alpha_pows)` folds a block (Goldilocks:
    gl/stark.py::GLProverBackend)."""
    if block_rows < 1 or nq % block_rows or block_rows & (block_rows - 1):
        raise ValueError(f"a fold block of {block_rows} rows for {nq}")
    out = None
    for a in range(0, nq, block_rows):
        b = a + block_rows
        cols = columns(a, b + step)
        part = _fold_block(
            F, E, air, cols, step, {k: v[a:b] for k, v in sels.items()},
            None if periodic is None else periodic[a:b].t().contiguous(),
            publics_m, alpha_pows, backend)
        del cols
        if out is None:
            out = part.new_empty((nq, part.shape[1]))
        out[a:b] = part
        FOLD_BLOCKS["count"] += 1
    FOLD_BLOCKS["rows"] = block_rows
    return out


def _fold_block(F, E, air, cols, step, sels, periodic, publics_m,
                alpha_pows, backend=ProverBackend):
    """One block: cols (w, B + step) transposed rows, sels (B,) and
    periodic (k, B) for its B rows. Returns (B, D)."""
    nb = cols.shape[1] - step
    backend = backend(F, E, alpha_pows)

    def entry(kind, j):
        if kind == "local":
            return cols[j, :nb]
        if kind == "next":
            return cols[j, step:step + nb]
        return sels[kind]

    air.eval(_make_builder(
        backend, air.width, air.num_public_values, entry,
        lambda j: publics_m[j],
        num_periodic=0 if periodic is None else periodic.shape[0],
        periodic_entry=lambda j: periodic[j]))
    return backend.finalize((nb,))


def quotient_of_commitment(config: StarkConfig, air: BaseAir, parts,
                           trace_domain, quotient_domain, publics_m,
                           alpha_pows):
    """The prover's natural-order quotient (Nq, D) from committed
    matrices: parts [(prover data, matrix index)], whose evaluations side
    by side are the AIR's rows (the trace; with a preprocessed or a
    permutation trace after it). Straight from the committed bit-reversed
    LDEs where the PCS lays them out so (`supports_bitrev_evals`, the
    reference's gate, stark/prover.py:205-211), else from their
    natural-order evaluations."""
    pcs = config.pcs
    bitrev = getattr(pcs, "supports_bitrev_evals", False)
    kw = {"order": "bitrev"} if bitrev else {}
    rows = [pcs.get_evaluations_on_domain(data, i, quotient_domain, **kw)
            for data, i in parts]
    rows = rows[0] if len(rows) == 1 else torch.cat(rows, dim=1)
    if bitrev:
        return committed_quotient(config, air, trace_domain,
                                  quotient_domain, rows, publics_m,
                                  alpha_pows)
    return quotient_values(config, air, trace_domain, quotient_domain, rows,
                           publics_m, alpha_pows)


def publics_tensor(F, public_values, device):
    """The public values as an int64 Montgomery tensor on `device`."""
    return torch.from_numpy(F.to_monty_np(np.asarray(
        public_values, dtype=np.uint32)).astype(np.int64)).to(device)


def alpha_powers(E, air, alpha, device):
    """[alpha^(K-1), ..., 1] for the K constraints of `air`, on `device`
    (constraint i folds with alpha^(K-1-i))."""
    num_constraints, _ = get_symbolic_layout(air)
    return torch.from_numpy(E.powers_np(alpha, num_constraints)[::-1]
                            .astype(np.int64)).to(device)


def prove(config: StarkConfig, air: BaseAir, trace, public_values,
          spans=None) -> Proof:
    """trace: (n, width) int64 Montgomery tensor, natural row order, on
    the config's device. spans: optional dict that collects wall-clock
    seconds per stage (the device is synchronized at each stage end)."""
    F, E, pcs = config.F, config.E, config.pcs
    if trace.device.type != config.device.type:
        raise ValueError(f"trace on {trace.device}, config on "
                         f"{config.device}")
    if getattr(pcs, "ZK", False):
        from .zk import prove_zk

        return prove_zk(config, air, trace, public_values, spans=spans)
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
    q_vals = quotient_of_commitment(
        config, air, [(trace_data, 0)], trace_domain, quotient_domain,
        publics_tensor(F, public_values, device),
        alpha_powers(E, air, alpha, device))
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
