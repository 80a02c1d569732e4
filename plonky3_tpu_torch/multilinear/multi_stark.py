"""The multilinear (SuperSpartan-style) STARK over the WHIR PCS.

Port of `plonky3_tpu/multilinear/multi_stark.py` (behavioral model:
`multi-stark/src/prover.rs:59`, phases :20-39, `zerocheck.rs:121,217`,
`keys.rs:30`, `rounds.rs`): a zerocheck by sumcheck over the hypercube,
then multilinear PCS openings at the bound point. The rotation of
`rounds.rs` is two explicit reductions:

  1. the zerocheck (`sumcheck.py`) binds the row variables to r' and
     claims {T_j(r'), T_j_next(r')} for every column.
  2. SHIFT REDUCTION: T_next is the cyclic rotation of T, so
     T_j_next(r') = Σ_y S(r', y)·T_j(y), S the MLE of the cyclic
     increment (a closed O(n²) form). One δ-batched sumcheck over y
     reduces the next-claims to local claims {T_j(u')}.
  3. COLUMN BINDING: the trace is committed as ONE stacked MLE with the
     column index in the HIGH variables, T_j(p) = stacked(p, bits(j)). A
     γ-batched sumcheck over the log(w) column variables reduces the w
     claims at p to one opening stacked(p, q).

Each of r' and u' then takes one WHIR opening of the committed MLE.

The prover's tables as large as the trace (the stacked MLE, its
coefficients, the shift and combined tables) are int64 Montgomery
tensors on the trace's device; the host keeps the padded column count's
tables and the transcript values. The verifier is host Python.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..utils.bits import log2_strict
from ..utils.timing import stage_timer
from .device_kernels import (ext_tensor, fold_at, horner_fold_pair, pull_ext,
                             round_poly_012)
from .mle import eq_table_device
from .sumcheck import (
    SumcheckProof,
    _lagrange_at,
    prove_zerocheck,
    verify_zerocheck,
)
from .whir import WhirPcs, coeffs_to_evals_ext, eq_factor, eq_table


class MultiStarkError(Exception):
    pass


# ---------------------------------------------------------------------------
# the cyclic-increment MLE S(x, y) = eq(y, x + 1 mod 2^n)
# ---------------------------------------------------------------------------
def shift_kernel_at(E, x: list, y: list):
    """S(x, y) for fixed ext points, O(n²): increment flips a trailing
    run of ones to zeros and the first zero to one; plus the wrap term."""
    n = len(x)
    one = E.one_h()
    total = E.zero_h()
    for i in range(n):
        term = one
        for l in range(i):  # trailing ones -> zeros
            term = E.mul_h(
                term, E.mul_h(x[l], E.sub_h(one, y[l]))
            )
        term = E.mul_h(
            term, E.mul_h(E.sub_h(one, x[i]), y[i])
        )  # first zero -> one
        for l in range(i + 1, n):  # higher bits unchanged
            term = E.mul_h(term, eq_factor(E, [x[l]], [y[l]]))
        total = E.add_h(total, term)
    wrap = one
    for l in range(n):  # all-ones -> all-zeros
        wrap = E.mul_h(wrap, E.mul_h(x[l], E.sub_h(one, y[l])))
    return E.add_h(total, wrap)


def shift_kernel_table(E, x: list, n: int) -> list:
    """[S(x, y)]_y as a table: S(x, y) = eq-table of x permuted — row y
    holds eq(x, y-1 mod 2^n)."""
    et = eq_table(E, x)
    n_rows = 1 << n
    # S(x, y) = [y == x+1] -> S(x, y) = eq(x, y-1)
    return [et[(y - 1) % n_rows] for y in range(n_rows)]


# ---------------------------------------------------------------------------
# the sumcheck over a product of two EF tables
# ---------------------------------------------------------------------------
def prove_product_sumcheck_device(E, a_dev, b_dev, challenger):
    """The sumcheck for Σ_x A(x)·B(x) over (N, D) Montgomery tensors,
    binding variable 1 (LSB) first (the reference's prove_product_sumcheck
    over host lists): each round is one round polynomial, two folds and
    one (3, D) pull. Returns (round_polys, point, final_a, final_b)."""
    polys, point = [], []
    while a_dev.shape[0] > 1:
        s = pull_ext(E, round_poly_012(E, a_dev, b_dev))
        for v in s:
            challenger.observe_ext(v)
        r = challenger.sample_ext(E.D)
        point.append(r)
        polys.append(s)
        r_m = E.const(r, a_dev.device)
        a_dev = fold_at(E, a_dev, r_m)
        b_dev = fold_at(E, b_dev, r_m)
    return polys, point, pull_ext(E, a_dev[0]), pull_ext(E, b_dev[0])


def _combined_cols(E, trace, dp_m):
    """combined(y) = Σ_j δ^j·T_j(y): (n, w) base × (w, D) ext -> (n, D)."""
    F = E.base
    return torch.stack([F.sum(F.mul(trace, dp_m[None, :, d]), dim=1)
                        for d in range(E.D)], dim=-1)


def verify_product_sumcheck(E, claim, polys, challenger):
    """Returns (point, final_claim) after replaying the chain."""
    point = []
    for s in polys:
        if len(s) != 3:
            raise MultiStarkError("RoundPolyShapeMismatch")
        if E.add_h(s[0], s[1]) != claim:
            raise MultiStarkError("SumcheckClaimMismatch")
        for v in s:
            challenger.observe_ext(v)
        r = challenger.sample_ext(E.D)
        point.append(r)
        claim = _lagrange_at(E, s, r)
    return point, claim


# ---------------------------------------------------------------------------
# setup keys (multi-stark/src/keys.rs:30,64 — ProvingKey/VerifyingKey).
# The reference's keys carry preprocessed commitments and the cached
# constraint layout; ours cache the layout (there is no multilinear
# preprocessed trace yet) and pin the AIR shape so prover and verifier
# agree on the round-polynomial degrees without re-tracing per proof.
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class VerifyingKey:
    width: int
    num_public_values: int
    n_constraints: int
    max_ml_degree: int
    log_wp: int  # log2 of the padded (stacked) column count


@dataclass(frozen=True)
class ProvingKey:
    vk: VerifyingKey


def setup(pcs: "WhirPcs", air):
    """One-time per-AIR preprocessing (keys.rs setup analog)."""
    from .sumcheck import get_ml_layout

    n_cons, max_deg = get_ml_layout(air)
    wp = 1 << max((air.width - 1).bit_length(), 0)
    vk = VerifyingKey(
        width=air.width,
        num_public_values=air.num_public_values,
        n_constraints=n_cons,
        max_ml_degree=max_deg,
        log_wp=log2_strict(wp),
    )
    return ProvingKey(vk=vk), vk


# ---------------------------------------------------------------------------
# proof object
# ---------------------------------------------------------------------------
@dataclass
class MultiStarkProof:
    trace_commit: tuple
    zerocheck: SumcheckProof
    zc_local: list  # [w] ext: T_j(r')
    zc_next: list  # [w] ext: T_j_next(r')
    shift_polys: list  # shift-reduction sumcheck round polys
    shift_locals: list  # [w] ext: T_j(u')
    colbind_polys: list  # [2][log_wp] col-binding round polys (per point)
    whir_openings: list  # [2] -> (value, WhirProof) at the stacked points
    degree_bits: int


def _stack_trace(trace):
    """(n, w) tensor -> the stacked (n·w_pad,) MLE evaluations (column
    bits HIGH), and w_pad."""
    n, w = trace.shape
    wp = 1 << max((w - 1).bit_length(), 0)
    out = trace.new_zeros((wp, n))
    out[:w] = trace.T
    return out.reshape(-1), wp


def prove_multi_stark(pcs: WhirPcs, air, trace, publics, challenger,
                      pk: ProvingKey | None = None, spans=None):
    """trace: (n, w) int64 Montgomery tensor (the port's trace form); the
    proof is made on its device. spans: a dict of stage seconds."""
    from ..challenger.schema import SchemaChallenger, multi_stark_schema

    F, E = pcs.F, pcs.E
    dev = trace.device
    mark = stage_timer(spans, dev)
    n, w = trace.shape
    n_vars = log2_strict(n)
    if pk is not None and (pk.vk.width != w
                           or pk.vk.num_public_values != len(publics)):
        raise ValueError("the proving key does not match the trace")

    stacked, wp = _stack_trace(trace)
    log_wp = log2_strict(wp)
    commit, data = pcs.commit(F.from_monty_tensor(stacked))
    del stacked
    mark("ms: commit")
    # the declared transcript (fiat_shamir/domain_separator.rs analog)
    challenger = SchemaChallenger(
        challenger,
        multi_stark_schema(pcs.config, air, n_vars, log_wp, len(publics)))
    challenger.observe(n_vars)
    challenger.observe_digest(commit)
    challenger.observe_many(publics)

    # 1. zerocheck
    zc_proof, zc_local, zc_next, r_prime = prove_zerocheck(
        E, air, trace, publics, challenger)
    for v in zc_local:
        challenger.observe_ext(v)
    for v in zc_next:
        challenger.observe_ext(v)
    mark("ms: zerocheck")

    # 2. shift reduction: Σ_j δ^j T_j_next(r') = Σ_y S(r', y)·(Σ_j δ^j T_j(y))
    delta = challenger.sample_ext(E.D)
    # S(r', y) = eq(r', y-1): the eq table rolled forward one row
    s_table = torch.roll(eq_table_device(E, r_prime, dev), 1, dims=0)
    dpows = [E.one_h()]
    for _ in range(w - 1):
        dpows.append(E.mul_h(dpows[-1], delta))
    dp_m = torch.stack([E.const(d, dev) for d in dpows])
    combined = _combined_cols(E, trace, dp_m)
    shift_polys, u_prime, _, _ = prove_product_sumcheck_device(
        E, s_table, combined, challenger)
    del s_table, combined
    # the per-column openings at u': bind the row variables of the
    # stacked coefficients on the device, read the columns off the rest
    cs = E.from_base(data.coeffs)

    def ctab_at(p_pt):
        cd = cs
        for p in p_pt:
            cd = horner_fold_pair(E, cd, E.const(p, dev))
        return pull_ext(E, cd)  # wp host coefficients over the c-vars

    ctab_u_coeffs = ctab_at(u_prime)
    ctab_u_evals = coeffs_to_evals_ext(E, list(ctab_u_coeffs))
    # an MLE at a binary point is a table entry
    shift_locals = [ctab_u_evals[j] for j in range(w)]
    for v in shift_locals:
        challenger.observe_ext(v)
    mark("ms: shift reduction")

    # 3. column binding and the WHIR openings, one per point
    colbind_polys, whir_openings = [], []
    for p_pt, ctab_coeffs in ((r_prime, None), (u_prime, ctab_u_coeffs)):
        gamma = challenger.sample_ext(E.D)
        gtab = _gamma_table(E, gamma, w, wp)
        if ctab_coeffs is None:
            ctab_coeffs = ctab_at(p_pt)
        ctab = coeffs_to_evals_ext(E, list(ctab_coeffs))
        polys, q_pt, _, _ = prove_product_sumcheck_device(
            E, ext_tensor(E, ctab, dev), ext_tensor(E, gtab, dev), challenger)
        colbind_polys.append(polys)
        mark("ms: column binding")
        ch_value, whir_proof = pcs.open(data, list(p_pt) + q_pt, challenger,
                                        spans=spans)
        whir_openings.append((ch_value, whir_proof))
        mark("ms: whir opens (total)")

    challenger.finish()
    return MultiStarkProof(
        trace_commit=commit,
        zerocheck=zc_proof,
        zc_local=zc_local,
        zc_next=zc_next,
        shift_polys=shift_polys,
        shift_locals=shift_locals,
        colbind_polys=colbind_polys,
        whir_openings=whir_openings,
        degree_bits=n_vars,
    )


def _col_bits(E, j, log_wp):
    return [
        E.from_base_h((j >> b) & 1) for b in range(log_wp)
    ]


def _gamma_table(E, gamma, w, wp):
    """MLE evals over column index with value γ^j at column j (0 pad)."""
    out = []
    gp = E.one_h()
    for j in range(wp):
        out.append(gp if j < w else E.zero_h())
        if j < w - 1:
            gp = E.mul_h(gp, gamma)
    return out


def verify_multi_stark(
    pcs: WhirPcs, air, proof: MultiStarkProof, publics, challenger,
    vk: VerifyingKey | None = None,
):
    F, E = pcs.F, pcs.E
    n_vars = proof.degree_bits
    w = air.width
    if vk is not None and (
        vk.width != w or vk.num_public_values != len(publics)
    ):
        raise MultiStarkError("KeyShapeMismatch")
    wp = 1 << max((w - 1).bit_length(), 0)
    log_wp = log2_strict(wp)

    from ..challenger.schema import SchemaChallenger, multi_stark_schema

    challenger = SchemaChallenger(
        challenger,
        multi_stark_schema(pcs.config, air, n_vars, log_wp, len(publics)),
    )
    challenger.observe(n_vars)
    challenger.observe_digest(proof.trace_commit)
    challenger.observe_many(publics)

    r_prime = verify_zerocheck(
        E, air, n_vars, publics, proof.zerocheck,
        proof.zc_local, proof.zc_next, challenger,
    )
    for v in proof.zc_local:
        challenger.observe_ext(v)
    for v in proof.zc_next:
        challenger.observe_ext(v)

    # 2. shift reduction
    delta = challenger.sample_ext(E.D)
    claim = E.zero_h()
    dp = E.one_h()
    for j in range(w):
        claim = E.add_h(claim, E.mul_h(dp, proof.zc_next[j]))
        dp = E.mul_h(dp, delta)
    u_prime, final_claim = verify_product_sumcheck(
        E, claim, proof.shift_polys, challenger
    )
    if len(u_prime) != n_vars:
        raise MultiStarkError("ShiftRoundCountMismatch")
    s_val = shift_kernel_at(E, r_prime, u_prime)
    t_comb = E.zero_h()
    dp = E.one_h()
    for j in range(w):
        t_comb = E.add_h(t_comb, E.mul_h(dp, proof.shift_locals[j]))
        dp = E.mul_h(dp, delta)
    if E.mul_h(s_val, t_comb) != final_claim:
        raise MultiStarkError("ShiftFinalMismatch")
    for v in proof.shift_locals:
        challenger.observe_ext(v)

    # 3. column binding + WHIR verifies
    if len(proof.colbind_polys) != 2 or len(proof.whir_openings) != 2:
        raise MultiStarkError("OpeningCountMismatch")
    for (p_pt, col_claims), polys, (val, wproof) in zip(
        ((r_prime, proof.zc_local), (u_prime, proof.shift_locals)),
        proof.colbind_polys,
        proof.whir_openings,
    ):
        gamma = challenger.sample_ext(E.D)
        claim = E.zero_h()
        gp = E.one_h()
        for j in range(w):
            claim = E.add_h(claim, E.mul_h(gp, col_claims[j]))
            if j < w - 1:
                gp = E.mul_h(gp, gamma)
        q_pt, final_claim = verify_product_sumcheck(
            E, claim, polys, challenger
        )
        if len(q_pt) != log_wp:
            raise MultiStarkError("ColBindRoundCountMismatch")
        # γ-table MLE at q
        g_val = E.zero_h()
        gp = E.one_h()
        for j in range(w):
            g_val = E.add_h(
                g_val,
                E.mul_h(gp, _eq_point_bits(E, q_pt, j, log_wp)),
            )
            if j < w - 1:
                gp = E.mul_h(gp, gamma)
        # final_claim must equal stacked(p, q)·γtable(q)
        if E.mul_h(val, g_val) != final_claim:
            raise MultiStarkError("ColBindFinalMismatch")
        full_pt = list(p_pt) + q_pt
        pcs.verify(
            proof.trace_commit,
            n_vars + log_wp,
            full_pt,
            val,
            wproof,
            challenger,
        )
    challenger.finish()


def _eq_point_bits(E, q_pt, j, log_wp):
    bits = [(j >> b) & 1 for b in range(log_wp)]
    acc = E.one_h()
    for qb, bit in zip(q_pt, bits):
        acc = E.mul_h(acc, qb if bit else E.sub_h(E.one_h(), qb))
    return acc
