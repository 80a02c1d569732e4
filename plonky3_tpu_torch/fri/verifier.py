"""FRI verifier: exact host arithmetic, typed errors.

Port of `plonky3_tpu/fri/verifier.py` (fri/src/verifier.rs:158
verify_fri): sample alpha; per round observe the commitment, check the
commit proof of work and sample beta; check the final polynomial's length
and observe it; observe the arity schedule; check the query proof of work;
sample the indices; per query authenticate the input openings, walk the
fold chain (`fold_query` :490), roll in the reduced openings of matching
heights scaled by beta^arity, and hold the last fold against the final
polynomial at x = g^{rev(index)}; last, authenticate every round's opened
groups, one batched Merkle check a round.

fold_row (two_adic_pcs.rs:109-131): Lagrange-interpolate the sibling group
at beta over the points {s·w^j} in bit-reversed order,
s = g_{h·a}^{rev(parent)}.

Another folding scheme (the circle PCS's) comes as `folding`, with its
own `fold_row`, `extra_query_index_bits`, `observe_arity_schedule` and
`scale_roll_in`; such a PCS samples alpha itself (`alpha`), reduces the
openings itself (`open_inputs_fn(indices)` -> per query [(log_h,
ext)]), and checks its own height bound (`check_global_height=False`).
"""

from __future__ import annotations

import numpy as np

from ..utils.bits import reverse_bits_len
from .config import FriParameters
from .proof import FriProof


class FriError(Exception):
    """Verification failure; the message names the reference's error
    variant (fri/src/verifier.rs:21)."""


def _lagrange_interpolate_at(E, xs_base, ys_ext, z_ext):
    """Interpolate (xs, ys) at z: xs base ints forming a bit-reversed
    coset, ys and z extension tuples."""
    F = E.base
    n = len(xs_base)
    for x, y in zip(xs_base, ys_ext):
        if z_ext == E.from_base_h(x):
            return y
    coset_power = F.exp_h(xs_base[0], n)
    weight_scale = F.inv_h(F.mul_h(n, coset_power))
    diffs = [E.sub_h(z_ext, E.from_base_h(x)) for x in xs_base]
    l_z = E.one_h()
    for d in diffs:
        l_z = E.mul_h(l_z, d)
    acc = E.zero_h()
    for x, y, d in zip(xs_base, ys_ext, diffs):
        w = F.mul_h(x, weight_scale)
        acc = E.add_h(acc, E.mul_h(E.base_mul_h(w, y), E.inv_h(d)))
    return E.mul_h(acc, l_z)


def fold_row_host(E, index, log_height, log_arity, beta, evals):
    """Fold one sibling group (two_adic_pcs.rs fold_row)."""
    F = E.base
    arity = 1 << log_arity
    if len(evals) != arity:
        raise ValueError(f"{len(evals)} values for arity {arity}")
    x = F.exp_h(F.two_adic_generator_h(log_height + log_arity),
                reverse_bits_len(index, log_height))
    w = F.two_adic_generator_h(log_arity)
    xs = []
    for _ in range(arity):
        xs.append(x)
        x = F.mul_h(x, w)
    # the committed group is in bit-reversed order
    xs = [xs[reverse_bits_len(j, log_arity)] for j in range(arity)]
    return _lagrange_interpolate_at(E, xs, evals, beta)


class TwoAdicRowFolding:
    """The verifier's default folding (two_adic_pcs.rs fold_row)."""

    extra_query_index_bits = 0
    observe_arity_schedule = True
    scale_roll_in = True

    def fold_row(self, E, index, log_folded, log_arity, beta, group):
        return fold_row_host(E, index, log_folded, log_arity, beta, group)


def verify_fri(E, params: FriParameters, proof: FriProof, challenger,
               commitments_with_opening_points, input_mmcs, fri_mmcs,
               folding=None, open_inputs_fn=None, alpha=None,
               check_global_height=True):
    """commitments_with_opening_points: [(commitment, [(domain,
    [(z, ys)])])], the reference's CommitmentWithOpeningPoints with a
    TwoAdicCoset for each matrix (None with `open_inputs_fn`). Raises
    FriError."""
    F = E.base
    if folding is None:
        folding = TwoAdicRowFolding()
    if params.num_queries == 0:
        raise FriError("ZeroQueries")
    if alpha is None:
        alpha = challenger.sample_ext(E.D)

    rounds = len(proof.commit_phase_commits)
    if len(proof.commit_phase_steps) != rounds:
        raise FriError("CommitPhaseOpeningsCountMismatch")
    log_arities = []
    for r, step in enumerate(proof.commit_phase_steps):
        if not (1 <= step.log_arity <= params.max_log_arity):
            raise FriError(f"InvalidLogArity round {r}")
        log_arities.append(step.log_arity)
        if len(step.sibling_values) != params.num_queries:
            raise FriError(f"CommitPhaseQueryCountMismatch round {r}")
        for sib in step.sibling_values:
            if len(sib) != (1 << step.log_arity) - 1:
                raise FriError(f"SiblingValuesLengthMismatch round {r}")

    log_global_max_height = (sum(log_arities) + params.log_blowup
                             + params.log_final_poly_len)
    if check_global_height and log_global_max_height > F.TWO_ADICITY:
        raise FriError("GlobalMaxHeightTooLarge")
    committed_heights = [dom.log_n + params.log_blowup
                         for (_, mats) in commitments_with_opening_points
                         or [] for (dom, _) in mats]
    if (check_global_height and committed_heights
            and max(committed_heights) != log_global_max_height):
        raise FriError("GlobalMaxHeightMismatch")
    if len(proof.commit_pow_witnesses) != rounds:
        raise FriError("CommitPowWitnessCountMismatch")

    betas = []
    for commit, witness in zip(proof.commit_phase_commits,
                               proof.commit_pow_witnesses):
        challenger.observe_digest(commit)
        if not challenger.check_witness(params.commit_proof_of_work_bits,
                                        witness):
            raise FriError("InvalidPowWitness (commit)")
        betas.append(challenger.sample_ext(E.D))

    if len(proof.final_poly) != params.final_poly_len:
        raise FriError("FinalPolyLengthMismatch")
    for coeff in proof.final_poly:
        challenger.observe_ext(coeff)
    if folding.observe_arity_schedule:
        for la in log_arities:
            challenger.observe(la)
    if not challenger.check_witness(params.query_proof_of_work_bits,
                                    proof.query_pow_witness):
        raise FriError("InvalidPowWitness (query)")

    log_final_height = params.log_blowup + params.log_final_poly_len
    extra = folding.extra_query_index_bits
    indices = [challenger.sample_bits(log_global_max_height + extra)
               for _ in range(params.num_queries)]
    if open_inputs_fn is not None:
        reduced_openings = open_inputs_fn(indices)
    else:
        reduced_openings = _open_inputs(
            E, params, log_global_max_height, indices, proof.input_openings,
            alpha, input_mmcs, commitments_with_opening_points)

    # fold chains; each round's opened groups are authenticated together
    # after the loop, one batched Merkle check a round
    round_groups = [[] for _ in range(rounds)]
    round_indices = [[] for _ in range(rounds)]
    for query, (index, ro) in enumerate(zip(indices, reduced_openings)):
        if not ro or ro[0][0] != log_global_max_height:
            raise FriError("InitialReducedOpeningHeightMismatch")
        ro = list(ro)
        folded_eval = ro.pop(0)[1]
        domain_index = index >> extra
        log_current = log_global_max_height
        for r, (beta, log_arity, step) in enumerate(
                zip(betas, log_arities, proof.commit_phase_steps)):
            pos = domain_index % (1 << log_arity)
            sibs = iter(step.sibling_values[query])
            group = [folded_eval if j == pos else next(sibs)
                     for j in range(1 << log_arity)]
            log_folded = log_current - log_arity
            domain_index >>= log_arity
            folded_eval = folding.fold_row(E, domain_index, log_folded,
                                           log_arity, beta, group)
            round_groups[r].append([group])
            round_indices[r].append(domain_index)
            log_current = log_folded
            if ro and ro[0][0] == log_folded:
                rolled = ro.pop(0)[1]
                if folding.scale_roll_in:
                    beta_pow = beta
                    for _ in range(log_arity):
                        beta_pow = E.mul_h(beta_pow, beta_pow)
                    rolled = E.mul_h(beta_pow, rolled)
                folded_eval = E.add_h(folded_eval, rolled)
        if log_current != log_final_height:
            raise FriError("FinalFoldHeightMismatch")
        if ro:
            raise FriError("UnconsumedReducedOpenings")

        if len(proof.final_poly) == 1:
            eval_fp = proof.final_poly[0]
        else:
            x = F.exp_h(F.two_adic_generator_h(log_final_height),
                        reverse_bits_len(domain_index, log_final_height))
            eval_fp = E.zero_h()  # Horner
            for coeff in reversed(proof.final_poly):
                eval_fp = E.add_h(E.base_mul_h(x, eval_fp), coeff)
        if eval_fp != folded_eval:
            raise FriError("FinalPolyMismatch")

    log_current = log_global_max_height
    for r, (log_arity, step) in enumerate(zip(log_arities,
                                              proof.commit_phase_steps)):
        log_folded = log_current - log_arity
        if not fri_mmcs.verify_multi_batch(
                proof.commit_phase_commits[r],
                [(1 << log_folded, 1 << log_arity)],
                round_indices[r], round_groups[r], step.opening_proof):
            raise FriError(f"CommitPhaseMmcsError round {r}")
        log_current = log_folded


def _open_inputs(E, params, log_global_max_height, indices, input_openings,
                 alpha, input_mmcs, commitments_with_opening_points):
    """Authenticate the input openings and reduce them (verifier.rs
    open_inputs:617): per query, [(log_height, Σ alpha^k·(p_k(z) -
    p_k(x)) / (z - x))], tallest first. One batched Merkle check a
    commitment and one numpy Mred a matrix cover every query."""
    F = E.base
    Q = len(indices)
    if len(input_openings) != len(commitments_with_opening_points):
        raise FriError("InputProofBatchCountMismatch")

    for batch, (opening, (commit, mats)) in enumerate(
            zip(input_openings, commitments_with_opening_points)):
        if len(opening.opened_values) != Q:
            raise FriError(f"InputOpeningsQueryCountMismatch batch {batch}")
        for q in range(Q):
            if len(opening.opened_values[q]) != len(mats):
                raise FriError(
                    f"BatchOpenedValuesCountMismatch batch {batch}")
        heights = [dom.size << params.log_blowup for (dom, _) in mats]
        dims = []
        for m, (dom, points_and_values) in enumerate(mats):
            if not points_and_values:
                raise FriError(f"MatrixWithoutOpeningPoints {batch},{m}")
            dims.append((heights[m], len(points_and_values[0][1])))
        bits_reduced = log_global_max_height - max(heights).bit_length() + 1
        if not input_mmcs.verify_multi_batch(
                commit, dims, [index >> bits_reduced for index in indices],
                opening.opened_values, opening.opening_proof):
            raise FriError(f"InputError batch {batch}")

    # the alpha offset of each height advances the same way for every
    # query (two_adic_pcs.rs:601-655), so Mred is vectorized over queries
    max_k = sum(len(pv) * len(pv[0][1])
                for _, mats in commitments_with_opening_points
                for _, pv in mats)
    alpha_pows = [E.one_h()]
    for _ in range(max(max_k, 1) - 1):
        alpha_pows.append(E.mul_h(alpha_pows[-1], alpha))

    accs = [dict() for _ in range(Q)]  # log_height -> extension value
    offsets = {}  # log_height -> next alpha exponent
    P = np.uint64(F.P)
    for opening, (_, mats) in zip(input_openings,
                                  commitments_with_opening_points):
        for m, (dom, points_and_values) in enumerate(mats):
            log_height = dom.log_n + params.log_blowup
            bits_reduced = log_global_max_height - log_height
            w = len(points_and_values[0][1])
            rows = np.array([opening.opened_values[q][m] for q in range(Q)],
                            dtype=np.uint64)
            if rows.shape[1] < w:
                raise FriError("PointEvaluationCountMismatch")
            rows = rows[:, :w]
            # query points x_q = GENERATOR · g^rev(index)
            g = F.two_adic_generator_h(log_height)
            xs = [F.mul_h(F.GENERATOR,
                          F.exp_h(g, reverse_bits_len(index >> bits_reduced,
                                                      log_height)))
                  for index in indices]
            k0 = offsets.setdefault(log_height, 0)
            ap = np.array(alpha_pows[k0:k0 + w], dtype=np.uint64)
            # Mred0[q] = Σ_j alpha^(k0+j)·row[q, j]; each product < 2^62
            # is reduced before the sum, so the sum stays below 2^64
            mred0 = [((rows * ap[None, :, d]) % P).sum(axis=1) % P
                     for d in range(E.D)]
            mred0 = [tuple(int(mred0[d][q]) for d in range(E.D))
                     for q in range(Q)]
            for p_i, (z, ps_at_z) in enumerate(points_and_values):
                if len(ps_at_z) != w:
                    raise FriError("PointEvaluationCountMismatch")
                # C = Σ_j alpha^(k0 + p_i·w + j)·ps_at_z[j]
                scale = E.exp_h(alpha, p_i * w)
                c_z = E.zero_h()
                for j, pz in enumerate(ps_at_z):
                    c_z = E.add_h(c_z, E.mul_h(alpha_pows[k0 + j], pz))
                c_z = E.mul_h(scale, c_z)
                for q in range(Q):
                    denom = E.sub_h(z, E.from_base_h(xs[q]))
                    if denom == E.zero_h():
                        raise FriError("OpeningPointMatchesQueryPoint")
                    quot = E.mul_h(E.sub_h(c_z, E.mul_h(scale, mred0[q])),
                                   E.inv_h(denom))
                    accs[q][log_height] = E.add_h(
                        accs[q].get(log_height, E.zero_h()), quot)
            offsets[log_height] = k0 + len(points_and_values) * w

    out = []
    for acc in accs:
        if acc.get(params.log_blowup, E.zero_h()) != E.zero_h():
            raise FriError("FinalPolyMismatch (height-1 quotient nonzero)")
        out.append(sorted(acc.items(), key=lambda t: -t[0]))
    return out
