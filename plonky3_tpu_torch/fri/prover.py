"""FRI prover: folding on the device, transcript on the host.

Port of `plonky3_tpu/fri/prover.py` (fri/src/prover.rs:43 prove_fri, :192
commit_phase). Per round: reshape the bit-reversed codeword into rows of
`arity` adjacent (conjugate) evaluations, commit, observe, grind, sample
beta, fold, and roll in the next input scaled by beta^arity. Then the
final polynomial, the arity schedule, the query grind, the query indices
and the openings.

Folding a bit-reversed codeword by 2 (fold_matrix, two_adic_pcs.rs:134):
    new[i] = (lo + hi)/2 + (lo - hi)·beta·hip[i],  hip = bitrev(g^-i / 2);
arity 2^k is k such steps with beta, beta^2, beta^4, ...
"""

from __future__ import annotations

from ..ops.ntt import idft, powers_device
from ..utils.bits import bitrev_permute_axis0, log2_strict
from ..utils.timing import stage_timer
from .config import FriParameters, compute_log_arity_for_round
from .proof import CommitPhaseStep, FriProof


def _halve_inv_powers(F, log_h: int, device):
    """bitrev([g^-i / 2, i < 2^log_h]) with g = two_adic_gen(log_h + 1)."""
    g_inv = F.inv_h(F.two_adic_generator_h(log_h + 1))
    p = powers_device(F, g_inv, 1 << log_h, device, scale_std=F.inv_h(2))
    return bitrev_permute_axis0(p, log_h)


def fold_step(E, folded, beta_host):
    """One arity-2 fold of a bit-reversed (2h, D) codeword -> (h, D)."""
    return fold_step_device(E, folded, E.const(beta_host, folded.device))


def fold_step_device(E, folded, beta_m):
    """`fold_step` with beta as a (D,) Montgomery tensor on the device (the
    device transcript's sample): the same bits as the host beta."""
    F = E.base
    h = folded.shape[0] // 2
    m = folded.reshape(h, 2, E.D)
    lo, hi = m[:, 0], m[:, 1]
    hip = _halve_inv_powers(F, log2_strict(h), folded.device)
    even = F.halve(F.add(lo, hi))
    odd = E.mul(F.sub(lo, hi), beta_m)
    return F.add(even, E.base_mul(hip, odd))


def fold_matrix(E, folded, beta_host, log_arity: int):
    """Arity-2^k fold as k arity-2 steps with beta^(2^j)."""
    b = beta_host
    for _ in range(log_arity):
        folded = fold_step(E, folded, b)
        b = E.mul_h(b, b)
    return folded


class TwoAdicFriFolding:
    """The default folding (fri/src/two_adic_pcs.rs fold_matrix): arity
    2^k folds of bit-reversed codewords over two-adic cosets; the arity
    schedule is observed (prover.rs:103) and each rolled-in input scaled
    by beta^arity (prover.rs:258-265)."""

    extra_query_index_bits = 0
    observe_arity_schedule = True
    scale_roll_in = True

    def __init__(self, E):
        self.E = E

    def fold_matrix(self, folded, beta, log_arity):
        return fold_matrix(self.E, folded, beta, log_arity)

    def idft_final(self, evals):
        return idft(self.E.base, evals)


def prove_fri(E, params: FriParameters, fri_mmcs, inputs: list, challenger,
              log_global_max_height: int, open_input_fn,
              spans=None, folding=None) -> FriProof:
    """inputs: (h, D) int64 codewords, heights strictly decreasing;
    open_input_fn(indices, batcher) registers the input openings and
    returns their finisher. spans: see stark.prover.prove. folding:
    default `TwoAdicFriFolding`."""
    from ..merkle.mmcs import PullBatcher

    F = E.base
    if folding is None:
        folding = TwoAdicFriFolding(E)
    if not inputs or params.num_queries <= 0 or params.max_log_arity <= 0:
        raise ValueError("FRI needs inputs, queries and a positive arity")
    if log_global_max_height != log2_strict(inputs[0].shape[0]):
        raise ValueError("the first input must have the global max height")
    mark = stage_timer(spans, inputs[0].device)

    folded = inputs[0]
    rest = list(inputs[1:])
    commits, datas, log_arities, pow_witnesses = [], [], [], []
    log_final_height = params.log_blowup + params.log_final_poly_len
    while folded.shape[0] > params.blowup * params.final_poly_len:
        log_h = log2_strict(folded.shape[0])
        next_log_h = log2_strict(rest[0].shape[0]) if rest else None
        log_arity = compute_log_arity_for_round(
            log_h, next_log_h, log_final_height, params.max_log_arity)
        log_arities.append(log_arity)
        data = fri_mmcs.commit_ext_matrix(
            folded.reshape(-1, 1 << log_arity, E.D))
        commits.append(data.commitment)
        challenger.observe_digest(data.commitment)
        pow_witnesses.append(
            challenger.grind(params.commit_proof_of_work_bits))
        beta = challenger.sample_ext(E.D)
        folded = folding.fold_matrix(folded, beta, log_arity)
        datas.append(data)
        if rest and rest[0].shape[0] == folded.shape[0]:
            if folding.scale_roll_in:
                beta_pow = beta
                for _ in range(log_arity):
                    beta_pow = E.mul_h(beta_pow, beta_pow)
                folded = F.add(folded, E.mul(
                    rest.pop(0), E.const(beta_pow, folded.device)))
            else:
                folded = F.add(folded, rest.pop(0))

    mark("fri: commit phase")
    # final polynomial (prover.rs:271): the bitrev prefix is the
    # restriction to the subgroup of size L
    L = params.final_poly_len
    final_evals = folded[:L]
    if L > 1:
        final_evals = folding.idft_final(bitrev_permute_axis0(
            final_evals, log2_strict(L)))
    fc = F.from_monty_np(final_evals.cpu().numpy())
    final_poly = [tuple(int(c) for c in row) for row in fc]
    for coeff in final_poly:
        challenger.observe_ext(coeff)
    if folding.observe_arity_schedule:  # prover.rs:103
        for la in log_arities:
            challenger.observe(la)

    mark("fri: final poly")
    query_pow = challenger.grind(params.query_proof_of_work_bits)
    extra = folding.extra_query_index_bits
    indices = [challenger.sample_bits(log_global_max_height + extra)
               for _ in range(params.num_queries)]
    mark("fri: grind + indices")

    batcher = PullBatcher()
    input_finish = open_input_fn(indices, batcher)
    steps_finish = _answer_queries(fri_mmcs, log_arities, datas,
                                   [i >> extra for i in indices], batcher)
    batcher.flush()
    proof = FriProof(
        commit_phase_commits=commits,
        commit_pow_witnesses=pow_witnesses,
        input_openings=input_finish(),
        commit_phase_steps=steps_finish(),
        final_poly=final_poly,
        query_pow_witness=query_pow,
    )
    mark("fri: query openings")
    return proof


def _answer_queries(fri_mmcs, log_arities, datas, start_indices, batcher):
    """Sibling values and pruned paths per round (prover.rs
    answer_queries:308): registers the gathers on `batcher` and returns a
    finisher to call after the flush."""
    futs = []
    indices = list(start_indices)
    for log_arity, data in zip(log_arities, datas):
        row_indices = [idx >> log_arity for idx in indices]
        futs.append((log_arity, list(indices),
                     batcher.add(fri_mmcs, data, row_indices)))
        indices = row_indices

    def finish():
        steps = []
        for log_arity, idx_list, fut in futs:
            arity = 1 << log_arity
            ext_pq, pruned = fut.value
            sibs = []
            for idx, ext_rows in zip(idx_list, ext_pq):
                group = ext_rows[0]  # one matrix per round
                pos = idx % arity
                sibs.append([g for j, g in enumerate(group) if j != pos])
            steps.append(CommitPhaseStep(log_arity=log_arity,
                                         sibling_values=sibs,
                                         opening_proof=pruned))
        return steps

    return finish
