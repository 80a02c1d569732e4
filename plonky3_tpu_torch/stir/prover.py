"""STIR prover (stir/src/prover.rs, Construction 5.2).

Port of `plonky3_tpu/stir/prover.py`. Codewords are natural-order (N, D)
int64 Montgomery tensors over the extension, on the device of the input
codeword; they stay there between the fold, the coset transforms (K1/K2
on a CUDA tensor), the degree correction and the Merkle commit. The
transcript-sized work (OOD answers, the Ans and shake interpolation)
stays host exact. Before committing, a codeword is arranged as a
(new_height x arity) fiber matrix, so one MMCS opening reveals a whole
fiber (prover.rs:1-7).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.ntt import powers_device
from ..utils.bits import log2_strict
from ..utils.timing import stage_timer
from .proof import StirProof, StirQueryOpenings, StirRoundProof
from .utils import (
    codeword_from_coeffs,
    coeffs_from_codeword,
    compute_shake_polynomial,
    eval_coeffs_at_ext_point,
    fold_codeword,
    fold_domain_params,
    interpolate_poly,
    next_domain_shift,
    sample_ood_points,
    vanishing_poly_from_roots,
)


def commit_as_fiber_matrix(E, mmcs, codeword, log_arity):
    """(N, D) natural codeword -> (N/k, k, D) fiber matrix, committed.
    Row j = [cw[j], cw[j+nh], ..., cw[j+(k-1)nh]] (prover.rs:5-7)."""
    arity = 1 << log_arity
    nh = codeword.shape[0] // arity
    mat = codeword.reshape(arity, nh, E.D).transpose(0, 1).contiguous()
    return mmcs.commit_ext_matrices([mat])


def _open_fiber_rows(mmcs, indices, data):
    rows_pq, pruned = mmcs.open_multi_batch(data, list(indices))
    return StirQueryOpenings(row_evals=[rows[0] for rows in rows_pq],
                             proof=pruned)


def _ext_coeff_tensor(E, poly, device):
    """Host ext coefficients -> (m, D) Montgomery tensor, zero-padded to
    a power of two."""
    m = 1
    while m < len(poly):
        m <<= 1
    cm = np.zeros((m, E.D), np.int64)
    if poly:
        cm[:len(poly)] = E.base.to_monty_np(np.asarray(poly, np.uint64))
    return torch.from_numpy(cm).to(device)


def prove_stir(config, poly_coeffs, challenger):
    """Prove low degree of an ext-coefficient polynomial (prover.rs:42).

    poly_coeffs: (m, D) Montgomery tensor, m <= 2^log_starting_degree."""
    E, F = config.E, config.F
    coeffs = poly_coeffs.new_zeros((1 << config.log_starting_degree, E.D))
    coeffs[:poly_coeffs.shape[0]] = poly_coeffs
    initial = codeword_from_coeffs(E, coeffs, F.GENERATOR,
                                   config.log_starting_domain_size)
    return prove_stir_from_codeword(config, initial, challenger)


def prove_stir_from_codeword(config, initial_codeword, challenger,
                             spans=None):
    return _prove_stir_inner(config, initial_codeword, challenger, True,
                             spans)


def prove_stir_from_external_codeword(config, initial_codeword, challenger,
                                      spans=None):
    """The initial oracle is bound by the caller: it is not committed and
    its query fibers are not shipped (prover.rs:70-100, where the
    soundness requirement on the caller is stated). spans: a dict of
    stage seconds (`utils.timing.stage_timer`)."""
    return _prove_stir_inner(config, initial_codeword, challenger, False,
                             spans)


def _prove_round(config, rnd, challenger, cur_cw, cur_shift, cur_log_dom,
                 cur_data, mark):
    E, F = config.E, config.F
    dev = cur_cw.device
    rc = config.round_configs[rnd]
    log_arity = rc.log_folding_factor

    fold_log_dom, fold_shift = fold_domain_params(
        F, cur_shift, cur_log_dom, log_arity)
    next_log_dom = cur_log_dom - 1
    next_shift = next_domain_shift(F, cur_shift, log_arity)

    # Step 1: fold (gamma after the folding PoW)
    folding_pow_witness = challenger.grind(rc.folding_pow_bits)
    mark("stir: grinds")
    gamma = challenger.sample_ext(E.D)
    fold_beta = E.base_mul_h(F.inv_h(cur_shift), gamma)
    folded = fold_codeword(E, cur_cw, fold_beta, log_arity, cur_log_dom)
    fold_coeffs = coeffs_from_codeword(E, folded, fold_shift)

    next_commit_cw = codeword_from_coeffs(E, fold_coeffs, next_shift,
                                          next_log_dom)
    mark("stir: fold + transforms")
    new_data = commit_as_fiber_matrix(E, config.mmcs, next_commit_cw,
                                      config.log_folding_factor)
    challenger.observe_digest(new_data.root_std)
    mark("stir: round commits")

    # Step 2: OOD samples outside the current, next and fold domains
    ood_points = sample_ood_points(
        E, challenger,
        [(cur_shift, cur_log_dom), (next_shift, next_log_dom),
         (fold_shift, fold_log_dom)],
        rc.num_ood_samples)
    folded_degree_bound = 1 << (rc.log_degree - log_arity)
    trunc = fold_coeffs[:min(folded_degree_bound, fold_coeffs.shape[0])]
    ood_answers = [eval_coeffs_at_ext_point(E, trunc, z) for z in ood_points]
    for y in ood_answers:
        challenger.observe_ext(y)

    mark("stir: ood")
    # Step 3: query-phase PoW
    pow_witness = challenger.grind(rc.pow_bits)
    mark("stir: grinds")

    # Step 4: queries (unbiased indices; dedup on first occurrence)
    g_fold = F.two_adic_generator_h(fold_log_dom)
    r_comb = challenger.sample_ext(E.D)
    query_indices = [challenger.sample_uniform_bits(fold_log_dom)
                     for _ in range(rc.num_queries)]
    unique = list(dict.fromkeys(query_indices))
    pulled = F.from_monty_np(folded[torch.tensor(unique, device=dev)]
                             .cpu().numpy())
    query_points = [E.from_base_h(F.mul_h(fold_shift, F.exp_h(g_fold, j)))
                    for j in unique]
    query_answers = [tuple(int(x) for x in row) for row in pulled]

    query_openings = (_open_fiber_rows(config.mmcs, query_indices, cur_data)
                      if cur_data is not None else None)

    # Step 4b: Ans and shake polynomials, bound before rho
    all_points = list(ood_points) + query_points
    all_values = list(ood_answers) + query_answers
    ans_poly = interpolate_poly(E, all_points, all_values)
    shake_poly = compute_shake_polynomial(E, ans_poly, all_points)
    for c in ans_poly:
        challenger.observe_ext(c)
    for c in shake_poly:
        challenger.observe_ext(c)
    challenger.sample_ext(E.D)  # rho: sampled and discarded by the prover
    mark("stir: queries + ans/shake")

    # Step 5: the next virtual witness f' = DegCor((g - Ans) / Z) on L_{i+1}
    N = 1 << next_log_dom
    num_answers = len(all_points)
    vanishing = vanishing_poly_from_roots(E, all_points)

    def low_degree_evals(poly):
        return codeword_from_coeffs(E, _ext_coeff_tensor(E, poly, dev),
                                    next_shift, next_log_dom)

    ans_evals = low_degree_evals(ans_poly if ans_poly else [E.zero_h()])
    van_evals = low_degree_evals(vanishing)

    g_next = F.two_adic_generator_h(next_log_dom)
    xs = powers_device(F, g_next, N, dev, scale_std=next_shift)
    one = E.const(E.one_h(), dev)
    step = E.base_mul(xs, E.const(r_comb, dev))  # r_comb · x_j
    combined = E.mul(van_evals, E.sub(one, step))

    # numerator 1 - (r_comb x)^{num_answers+1}
    na1 = num_answers + 1
    xs_hi = powers_device(F, F.exp_h(g_next, na1), N, dev,
                          scale_std=F.exp_h(next_shift, na1))
    numer = E.sub(one, E.base_mul(xs_hi,
                                  E.const(E.exp_h(r_comb, na1), dev)))
    next_cw = E.mul(E.mul(E.sub(next_commit_cw, ans_evals),
                          E.inv(combined)), numer)
    mark("stir: degree correction")

    proof = StirRoundProof(
        commitment=tuple(new_data.root_std),
        folding_pow_witness=folding_pow_witness,
        ood_answers=ood_answers,
        pow_witness=pow_witness,
        ans_polynomial=ans_poly,
        shake_polynomial=shake_poly,
        query_openings=query_openings,
    )
    return (proof, next_cw, new_data, next_shift, next_log_dom,
            sorted(unique))


def _prove_final_round(config, challenger, cur_cw, cur_shift, cur_log_dom,
                       cur_data, mark):
    E, F = config.E, config.F
    log_arity = config.log_folding_factor
    final_log_dom, final_shift = fold_domain_params(
        F, cur_shift, cur_log_dom, log_arity)

    final_folding_pow = challenger.grind(config.final_folding_pow_bits)
    mark("stir: grinds")
    final_gamma = challenger.sample_ext(E.D)
    beta = E.base_mul_h(F.inv_h(cur_shift), final_gamma)
    final_cw = fold_codeword(E, cur_cw, beta, log_arity, cur_log_dom)

    # a small inverse DFT on the stride-subsampled coset (prover.rs:434-441)
    final_len = config.final_poly_len
    stride = final_cw.shape[0] // final_len
    sub = final_cw[::stride][:final_len].contiguous()
    final_poly_m = coeffs_from_codeword(E, sub, final_shift)
    final_poly = [tuple(int(x) for x in row)
                  for row in F.from_monty_np(final_poly_m.cpu().numpy())]

    for c in final_poly:
        challenger.observe_ext(c)
    mark("stir: fold + transforms")
    final_pow = challenger.grind(config.final_pow_bits)
    mark("stir: grinds")

    final_indices = [challenger.sample_uniform_bits(final_log_dom)
                     for _ in range(config.final_queries)]
    final_openings = (_open_fiber_rows(config.mmcs, final_indices, cur_data)
                      if cur_data is not None else None)
    mark("stir: queries + ans/shake")
    return (final_poly, final_folding_pow, final_pow, final_openings,
            sorted(set(final_indices)))


def _prove_stir_inner(config, initial_codeword, challenger, commit_initial,
                      spans=None):
    E, F = config.E, config.F
    mark = stage_timer(spans, initial_codeword.device)
    log_dom = config.log_starting_domain_size
    if initial_codeword.shape[0] != 1 << log_dom:
        raise ValueError(f"the codeword has {initial_codeword.shape[0]} "
                         f"rows, not 2^{log_dom}")
    log2_strict(initial_codeword.shape[0])

    initial_commit = None
    cur_data = None
    if commit_initial:
        cur_data = commit_as_fiber_matrix(E, config.mmcs, initial_codeword,
                                          config.log_folding_factor)
        initial_commit = tuple(cur_data.root_std)
        challenger.observe_digest(cur_data.root_std)
        mark("stir: round commits")

    cur_cw, cur_shift, cur_log_dom = initial_codeword, F.GENERATOR, log_dom
    round_proofs = []
    first_round_query_indices = []
    for rnd in range(config.num_rounds):
        (proof, cur_cw, cur_data, cur_shift, cur_log_dom, seen) = (
            _prove_round(config, rnd, challenger, cur_cw, cur_shift,
                         cur_log_dom, cur_data, mark))
        if rnd == 0:
            first_round_query_indices = seen
        round_proofs.append(proof)

    (final_poly, ffp, fp, final_openings, final_seen) = _prove_final_round(
        config, challenger, cur_cw, cur_shift, cur_log_dom, cur_data, mark)
    if config.num_rounds == 0:
        first_round_query_indices = final_seen

    proof = StirProof(
        initial_commitment=initial_commit,
        round_proofs=round_proofs,
        final_polynomial=final_poly,
        final_folding_pow_witness=ffp,
        final_pow_witness=fp,
        final_query_openings=final_openings,
    )
    return proof, first_round_query_indices
