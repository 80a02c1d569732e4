"""STIR verifier (stir/src/verifier.rs), on the host.

Port of `plonky3_tpu/stir/verifier.py`: the same checks in the same
order, each failure raising the reference's error class.

Each round's oracle is VIRTUAL: the committed rows of round i are the
codeword g_i, and the witness f_i the fold consumes is
DegCor((g_i − Ans_{i-1}) / Z_{i-1}) materialized per fiber from the
previous round's Ans/vanishing polynomials (verifier.rs:45
materialize_virtual_fiber). Merkle checks use one shared pruned
multi-opening per round.
"""

from __future__ import annotations

from dataclasses import dataclass

from .utils import (
    check_shake_consistency,
    eval_degree_correction,
    eval_poly,
    fold_domain_params,
    lagrange_eval_at,
    next_domain_shift,
    reduce_mod_x_pow_minus_c,
    sample_ood_points,
    vanishing_poly_from_roots,
)


class StirError(Exception):
    pass


class InvalidPowWitness(StirError):
    pass


class InvalidMerkleProof(StirError):
    pass


class InvalidShakeConsistency(StirError):
    pass


class InvalidRoundConsistency(StirError):
    pass


class FinalPolyMismatch(StirError):
    pass


class InvalidProofShape(StirError):
    pass


@dataclass
class _VirtualCtx:
    ans_poly: list
    vanishing_coeffs: list
    all_points: list
    r_comb: tuple


def _materialize_virtual_fiber(E, row_evals, subgroup_points, shift, ctx):
    """verifier.rs:45: f(x) = DegCor((g(x) − Ans(x)) / Z(x)) over one
    fiber; Ans/Z are reduced mod X^arity − x0^arity first so each
    evaluation is O(arity) (the fiber is a coset of arity-th roots)."""
    if ctx is None:
        return list(row_evals)
    F = E.base
    arity = len(row_evals)
    points = [F.mul_h(shift, x) for x in subgroup_points]
    common_power = F.exp_h(points[0], arity)
    ans_rem = reduce_mod_x_pow_minus_c(E, ctx.ans_poly, arity, common_power)
    van_rem = reduce_mod_x_pow_minus_c(
        E, ctx.vanishing_coeffs, arity, common_power
    )
    out = []
    for g_val, x in zip(row_evals, points):
        xe = E.from_base_h(x)
        van = eval_poly(E, van_rem, xe)
        if van == E.zero_h():
            return None
        q = E.mul_h(
            E.sub_h(g_val, eval_poly(E, ans_rem, xe)), E.inv_h(van)
        )
        out.append(
            eval_degree_correction(
                E, q, xe, ctx.r_comb, len(ctx.all_points)
            )
        )
    return out


def _query_fold_value(E, row_evals, j, domain_gen, fiber_step, arity,
                      cur_shift, fold_beta, ctx):
    F = E.base
    x = F.exp_h(domain_gen, j)
    subgroup_points = []
    for _ in range(arity):
        subgroup_points.append(x)
        x = F.mul_h(x, fiber_step)
    fiber = _materialize_virtual_fiber(
        E, row_evals, subgroup_points, cur_shift, ctx
    )
    if fiber is None:
        raise InvalidRoundConsistency()
    return lagrange_eval_at(E, subgroup_points, fiber, fold_beta)


def _fetch_round_rows(E, mmcs, is_external, external_fibers, openings,
                      query_indices, arity, commitment, height):
    if is_external:
        rows = external_fibers(query_indices)
        if len(rows) != len(query_indices):
            raise InvalidProofShape()
        return rows
    if openings is None or len(openings.row_evals) != len(query_indices):
        raise InvalidProofShape()
    for row in openings.row_evals:
        if len(row) != arity:
            raise InvalidProofShape()
    ok = mmcs.verify_multi_batch(
        commitment,
        [(height, arity)],
        list(query_indices),
        [[row] for row in openings.row_evals],
        list(openings.proof),
    )
    if not ok:
        raise InvalidMerkleProof()
    return openings.row_evals


def _verify_round(config, rnd, rp, challenger, cur_shift, cur_log_dom,
                  ctx, is_external, external_fibers, commitment):
    E, F = config.E, config.F
    rc = config.round_configs[rnd]
    log_arity = rc.log_folding_factor
    arity = 1 << log_arity
    fold_log_dom, fold_shift = fold_domain_params(
        F, cur_shift, cur_log_dom, log_arity
    )
    fold_height = 1 << fold_log_dom
    next_log_dom = cur_log_dom - 1
    next_shift = next_domain_shift(F, cur_shift, log_arity)

    if not challenger.check_witness(
        rc.folding_pow_bits, rp.folding_pow_witness
    ):
        raise InvalidPowWitness(f"round {rnd} folding PoW")
    gamma = challenger.sample_ext(E.D)
    fold_beta = E.base_mul_h(F.inv_h(cur_shift), gamma)
    challenger.observe_digest(rp.commitment)

    if len(rp.ood_answers) != rc.num_ood_samples:
        raise InvalidProofShape()
    ood_points = sample_ood_points(
        E, challenger,
        [
            (cur_shift, cur_log_dom),
            (next_shift, next_log_dom),
            (fold_shift, fold_log_dom),
        ],
        rc.num_ood_samples,
    )
    for y in rp.ood_answers:
        challenger.observe_ext(y)

    if not challenger.check_witness(rc.pow_bits, rp.pow_witness):
        raise InvalidPowWitness(f"round {rnd} query PoW")
    r_comb = challenger.sample_ext(E.D)

    query_indices = [
        challenger.sample_uniform_bits(fold_log_dom)
        for _ in range(rc.num_queries)
    ]
    rows = _fetch_round_rows(
        E, config.mmcs, is_external, external_fibers, rp.query_openings,
        query_indices, arity, commitment, fold_height,
    )

    domain_gen = F.two_adic_generator_h(cur_log_dom)
    fiber_step = F.exp_h(domain_gen, fold_height)
    g_fold = F.two_adic_generator_h(fold_log_dom)

    query_points, query_answers = [], []
    first_round_pairs = []
    seen = set()
    for j, row_evals in zip(query_indices, rows):
        fold_val = _query_fold_value(
            E, row_evals, j, domain_gen, fiber_step, arity, cur_shift,
            fold_beta, ctx,
        )
        if j not in seen:
            seen.add(j)
            pt = E.from_base_h(F.mul_h(fold_shift, F.exp_h(g_fold, j)))
            query_points.append(pt)
            query_answers.append(fold_val)
            if rnd == 0:
                first_round_pairs.append((j, list(row_evals)))

    all_points = list(ood_points) + query_points
    all_values = list(rp.ood_answers) + query_answers
    max_ans_len = len(all_points)
    if (len(rp.ans_polynomial) > max_ans_len
            or len(rp.shake_polynomial) > max(max_ans_len - 1, 0)):
        raise InvalidProofShape()
    for c in rp.ans_polynomial:
        challenger.observe_ext(c)
    for c in rp.shake_polynomial:
        challenger.observe_ext(c)
    rho = challenger.sample_ext(E.D)
    if not check_shake_consistency(
        E, rp.ans_polynomial, rp.shake_polynomial, all_points, all_values,
        rho,
    ):
        raise InvalidShakeConsistency(f"round {rnd}")

    new_ctx = _VirtualCtx(
        ans_poly=list(rp.ans_polynomial),
        vanishing_coeffs=vanishing_poly_from_roots(E, all_points),
        all_points=all_points,
        r_comb=r_comb,
    )
    return new_ctx, next_shift, next_log_dom, first_round_pairs


def _verify_final_round(config, proof, challenger, cur_shift, cur_log_dom,
                        ctx, is_external, external_fibers, commitment):
    E, F = config.E, config.F
    log_arity = config.log_folding_factor
    arity = 1 << log_arity
    final_log_dom, final_shift = fold_domain_params(
        F, cur_shift, cur_log_dom, log_arity
    )
    final_height = 1 << final_log_dom

    if not challenger.check_witness(
        config.final_folding_pow_bits, proof.final_folding_pow_witness
    ):
        raise InvalidPowWitness("final folding PoW")
    final_gamma = challenger.sample_ext(E.D)
    fold_beta = E.base_mul_h(F.inv_h(cur_shift), final_gamma)

    if len(proof.final_polynomial) != config.final_poly_len:
        raise InvalidProofShape()
    for c in proof.final_polynomial:
        challenger.observe_ext(c)
    if not challenger.check_witness(
        config.final_pow_bits, proof.final_pow_witness
    ):
        raise InvalidPowWitness("final query PoW")

    final_indices = [
        challenger.sample_uniform_bits(final_log_dom)
        for _ in range(config.final_queries)
    ]
    rows = _fetch_round_rows(
        E, config.mmcs, is_external, external_fibers,
        proof.final_query_openings, final_indices, arity, commitment,
        final_height,
    )

    domain_gen = F.two_adic_generator_h(cur_log_dom)
    fiber_step = F.exp_h(domain_gen, final_height)
    g_final = F.two_adic_generator_h(final_log_dom)

    first_round_pairs = []
    seen = set()
    for j, row_evals in zip(final_indices, rows):
        fold_val = _query_fold_value(
            E, row_evals, j, domain_gen, fiber_step, arity, cur_shift,
            fold_beta, ctx,
        )
        x_j = E.from_base_h(F.mul_h(final_shift, F.exp_h(g_final, j)))
        if eval_poly(E, proof.final_polynomial, x_j) != fold_val:
            raise FinalPolyMismatch()
        if config.num_rounds == 0 and j not in seen:
            seen.add(j)
            first_round_pairs.append((j, list(row_evals)))
    return first_round_pairs


def verify_stir(config, proof, challenger):
    """Verify a self-contained STIR proof (committed initial oracle).

    Returns the deduplicated (index, fiber) pairs of the first round
    (the PCS binding hook, verifier.rs:621)."""
    return _verify_stir_inner(config, proof, challenger, None)


def verify_stir_with_external_initial(config, proof, challenger,
                                      initial_fibers):
    """Initial oracle is external: `initial_fibers(indices)` returns the
    queried fibers, bound by the caller (verifier.rs:665)."""
    return _verify_stir_inner(config, proof, challenger, initial_fibers)


def _verify_stir_inner(config, proof, challenger, initial_fibers):
    E, F = config.E, config.F
    is_external = initial_fibers is not None
    if is_external:
        if proof.initial_commitment is not None:
            raise InvalidProofShape()
    else:
        if proof.initial_commitment is None:
            raise InvalidProofShape()
        challenger.observe_digest(proof.initial_commitment)

    if len(proof.round_proofs) != config.num_rounds:
        raise InvalidProofShape()

    cur_shift, cur_log_dom = F.GENERATOR, config.log_starting_domain_size
    ctx = None
    commitment = proof.initial_commitment
    first_round_pairs = []
    for rnd, rp in enumerate(proof.round_proofs):
        ext_now = is_external and rnd == 0
        ctx, cur_shift, cur_log_dom, pairs = _verify_round(
            config, rnd, rp, challenger, cur_shift, cur_log_dom, ctx,
            ext_now, initial_fibers if ext_now else None, commitment,
        )
        if rnd == 0:
            first_round_pairs = pairs
        commitment = rp.commitment

    pairs = _verify_final_round(
        config, proof, challenger, cur_shift, cur_log_dom, ctx,
        is_external and config.num_rounds == 0,
        initial_fibers if config.num_rounds == 0 else None, commitment,
    )
    if config.num_rounds == 0:
        first_round_pairs = pairs
    return first_round_pairs
