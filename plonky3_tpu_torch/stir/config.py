"""STIR configuration and its paper-backed parameter schedule.

Port of `plonky3_tpu/stir/config.py`: `stir/src/config.rs`
(StirParameters, StirRoundConfig, StirConfig) and `stir/src/soundness.rs`
(the eta, query and PoW derivation under the Johnson-bound and
capacity-bound security assumptions), host Python. The schedule
folds degree by k = 2^log_folding_factor per round while the domain only
halves, so the rate improves by 2^(k-1) per round — STIR's core trick.
"""

from __future__ import annotations

import math
from dataclasses import dataclass


JOHNSON = "johnson"
CAPACITY = "capacity"


def _require(cond, msg):
    """The reference asserts these conditions; the port raises."""
    if not cond:
        raise ValueError(msg)


# ---------------------------------------------------------------------------
# soundness formulas (soundness.rs)
# ---------------------------------------------------------------------------
def _rate(log_inv_rate):
    return 2.0 ** (-log_inv_rate)


def _log2_field_minus_domain(field_bits, log_domain):
    _require(field_bits > log_domain, "the domain exceeds the field")
    ratio = 2.0 ** (log_domain - field_bits)
    return field_bits + math.log2(1.0 - ratio)


def num_ood_samples(assumption):
    return 1 if assumption == JOHNSON else 2


def query_failure_base(assumption, log_inv_rate, eta):
    if assumption == JOHNSON:
        return math.sqrt(_rate(log_inv_rate)) + eta
    return _rate(log_inv_rate) + eta


def eta_upper_bound(assumption, log_inv_rate):
    if assumption == JOHNSON:
        return math.sqrt(_rate(log_inv_rate)) / 20.0
    return _rate(log_inv_rate) / 2.0


def queries_for_base(security_bits, failure_base):
    _require(0.0 < failure_base < 1.0, "failure base outside (0, 1)")
    return math.ceil(security_bits / -math.log2(failure_base))


def _list_size_bits(assumption, log_degree, log_inv_rate, log_eta):
    if assumption == JOHNSON:
        return log_inv_rate / 2.0 - (1.0 + log_eta)
    return (log_degree + log_inv_rate) - log_eta


def _prox_gaps_error(assumption, log_degree, log_inv_rate, field_bits,
                     num_functions, log_eta):
    _require(num_functions >= 2, "need at least two functions")
    if assumption == JOHNSON:
        # BCSS25 Thm 1.5 dominant term at the protocol's eta
        log_sqrt_rho_over_2eta = -(log_inv_rate) / 2.0 - 1.0 - log_eta
        m = max(math.ceil(2.0 ** log_sqrt_rho_over_2eta), 3.0)
        log_n = log_degree + log_inv_rate
        constant = math.log2(2.0 * (m + 0.5) ** 5 / 3.0)
        exceptional = log_n + constant + 1.5 * log_inv_rate
    else:
        exceptional = (log_degree + 2 * log_inv_rate) - log_eta
    return field_bits - (exceptional + math.log2(num_functions - 1.0))


def _ood_error(assumption, log_degree, log_inv_rate, field_bits,
               ood_samples, log_eta):
    ls = _list_size_bits(assumption, log_degree, log_inv_rate, log_eta)
    error = 2.0 * ls + log_degree * ood_samples
    return ood_samples * field_bits + 1.0 - error


def _fold_sumcheck_error(assumption, field_bits, log_degree, log_inv_rate,
                         log_eta):
    ls = _list_size_bits(assumption, log_degree, log_inv_rate, log_eta)
    return field_bits - (ls + 1.0)


def _queries_combination_error(assumption, field_bits, log_degree,
                               log_inv_rate, ood_samples, num_queries,
                               log_eta):
    ls = _list_size_bits(assumption, log_degree, log_inv_rate, log_eta)
    return field_bits - (math.log2(ood_samples + num_queries) + ls + 1.0)


def _shake_check_error(field_bits, num_queries, ood_samples):
    num_points = num_queries + ood_samples
    return field_bits - max(math.log2(2.0 * num_points), 0.0)


def fold_algebraic_bits(assumption, field_bits, log_degree, log_inv_rate,
                        log_eta):
    return min(
        _prox_gaps_error(assumption, log_degree, log_inv_rate, field_bits,
                         2, log_eta),
        _fold_sumcheck_error(assumption, field_bits, log_degree,
                             log_inv_rate, log_eta),
    )


def query_pow_eligible_bits(assumption, field_bits, log_degree,
                            log_inv_rate, eta, num_queries, ood_samples):
    base = query_failure_base(assumption, log_inv_rate, eta)
    query_failure = -num_queries * math.log2(base)
    comb = _queries_combination_error(
        assumption, field_bits, log_degree, log_inv_rate, ood_samples,
        num_queries, math.log2(eta),
    )
    return min(query_failure, comb)


def query_unprotected_bits(assumption, field_bits, log_degree,
                           log_inv_rate, eta, num_queries, ood_samples):
    ood = _ood_error(assumption, log_degree, log_inv_rate, field_bits,
                     ood_samples, math.log2(eta))
    shake = _shake_check_error(field_bits, num_queries, ood_samples)
    return min(ood, shake)


def final_query_algebraic_bits(assumption, log_inv_rate, eta, num_queries):
    base = query_failure_base(assumption, log_inv_rate, eta)
    return -num_queries * math.log2(base)


def _minimum_eta_for_target(upper, target_bits, bits_at_eta, label):
    upper_bits = bits_at_eta(upper)
    _require(upper_bits >= target_bits,
             f"{label} reaches only {upper_bits:.4f} bits at eta={upper}; "
             f"target is {target_bits}")
    low, high = 0.0, upper
    for _ in range(80):
        mid = (low + high) / 2.0
        if bits_at_eta(mid) >= target_bits:
            high = mid
        else:
            low = mid
    return high


def initial_eta(assumption, pow_target, unprotected_target, log_degree,
                log_inv_rate, log_folding_factor, field_bits):
    upper = eta_upper_bound(assumption, log_inv_rate)
    oods = num_ood_samples(assumption)
    fold_eta = _minimum_eta_for_target(
        upper, pow_target,
        lambda eta: fold_algebraic_bits(
            assumption, field_bits, log_degree, log_inv_rate,
            math.log2(eta)),
        "initial STIR folding bound",
    )
    ood_eta = _minimum_eta_for_target(
        upper, unprotected_target,
        lambda eta: _ood_error(assumption, log_degree, log_inv_rate,
                               field_bits, oods, math.log2(eta)),
        "initial STIR OOD bound",
    )
    if assumption == JOHNSON:
        schedule_eta = 0.0
    else:
        k = 1 << log_folding_factor
        log_eta_proxgap = (
            pow_target + math.log2(k - 1)
            + (log_degree - log_folding_factor)
            + 2.0 * log_inv_rate - field_bits
        )
        rho = _rate(log_inv_rate)
        log_fb_max = math.log2(1.5 * rho)
        t0_max = math.ceil(pow_target / -log_fb_max)
        third = (t0_max + 1.0) + (k - 1) / k
        log_eta_comb = (
            pow_target + 1.0 + log_degree + 2.0 * log_inv_rate
            - field_bits + math.log2(third)
        )
        schedule_eta = 2.0 ** max(log_eta_proxgap, log_eta_comb)
    return max(schedule_eta, fold_eta, ood_eta)


def recursive_eta(assumption, pow_target, unprotected_target, log_degree,
                  log_inv_rate, log_domain, log_folding_factor,
                  field_bits, prev_queries):
    k = 1 << log_folding_factor
    lfmd = _log2_field_minus_domain(field_bits, log_domain)
    if assumption == JOHNSON:
        log_ood_term = (
            unprotected_target + log_degree - 3.0 + log_inv_rate - lfmd
        ) / 2.0
        schedule_eta = 2.0 ** log_ood_term
    else:
        t1 = 1.0 - log_domain
        t2 = log_domain + (
            pow_target + 2.0 * log_degree - 1.0 - 2.0 * lfmd
        ) / 2.0
        third = (prev_queries + 1) + (k - 1) / k
        t3 = (pow_target + 1.0 + log_degree + 2.0 * log_inv_rate
              - field_bits + math.log2(third))
        schedule_eta = 2.0 ** max(t1, t2, t3)
    upper = eta_upper_bound(assumption, log_inv_rate)
    fold_eta = _minimum_eta_for_target(
        upper, pow_target,
        lambda eta: fold_algebraic_bits(
            assumption, field_bits, log_degree, log_inv_rate,
            math.log2(eta)),
        "recursive STIR folding bound",
    )
    ood_eta = _minimum_eta_for_target(
        upper, unprotected_target,
        lambda eta: _ood_error(
            assumption, log_degree, log_inv_rate, field_bits,
            num_ood_samples(assumption), math.log2(eta)),
        "recursive STIR OOD bound",
    )
    return max(schedule_eta, fold_eta, ood_eta)


# ---------------------------------------------------------------------------
# configuration (config.rs)
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class StirParameters:
    """User-facing knobs (config.rs StirParameters)."""

    log_blowup: int
    log_folding_factor: int
    security_level: int = 80
    max_pow_bits: int = 20
    soundness_type: str = CAPACITY


@dataclass(frozen=True)
class StirRoundConfig:
    log_degree: int
    log_domain_size: int
    log_fold_domain_size: int
    domain_shift: int  # standard-form base element
    log_folding_factor: int
    eta: float
    num_queries: int
    num_ood_samples: int
    pow_bits: int
    folding_pow_bits: int


@dataclass(frozen=True)
class StirConfig:
    """Full derived schedule (config.rs:127 StirConfig + ::new)."""

    F: object
    E: object
    mmcs: object  # ExtensionMmcs over E
    log_starting_degree: int
    log_blowup: int
    log_folding_factor: int
    security_level: int
    max_pow_bits: int
    soundness_type: str
    round_configs: tuple
    log_final_degree: int
    final_queries: int
    final_eta: float
    final_pow_bits: int
    final_folding_pow_bits: int

    @property
    def log_starting_domain_size(self):
        return self.log_starting_degree + self.log_blowup

    @property
    def num_rounds(self):
        return len(self.round_configs)

    @property
    def final_poly_len(self):
        return 1 << self.log_final_degree

    @staticmethod
    def new(F, E, mmcs, log_starting_degree: int, params: StirParameters):
        """The paper-backed schedule (config.rs:191)."""
        a = params.soundness_type
        _require(a in (JOHNSON, CAPACITY), f"unknown soundness type {a}")
        _require(2 <= params.log_folding_factor <= log_starting_degree,
                 "log_folding_factor must lie in [2, log_starting_degree]")
        log_starting_domain = log_starting_degree + params.log_blowup
        _require(log_starting_domain <= F.TWO_ADICITY,
                 "the starting domain exceeds the two-adicity")
        _require(params.security_level > params.max_pow_bits,
                 "security_level must exceed max_pow_bits")

        field_bits = math.log2(F.P) * E.D
        lff = params.log_folding_factor
        sec = params.security_level
        max_pow = params.max_pow_bits
        alg_sec = sec - max_pow
        oods = num_ood_samples(a)

        total_folds = log_starting_degree // lff
        _require(total_folds > 0, "no fold fits the starting degree")
        n_rounds = max(total_folds - 1, 0)
        log_final_degree = log_starting_degree - total_folds * lff

        TERMS_PER_ROUND, FINAL_TERMS = 6, 3
        n_alg_terms = TERMS_PER_ROUND * (total_folds - 1) + FINAL_TERMS
        buffer = math.ceil(math.log2(n_alg_terms)) if n_alg_terms > 1 else 0
        buffered = sec + buffer
        pow_target = alg_sec + buffer

        def derive_pow(label, round_label, algebraic_bits):
            gap = max(buffered - algebraic_bits, 0.0)
            needed = math.ceil(gap)
            _require(needed <= max_pow,
                     f"{round_label} {label} requires {needed} PoW bits "
                     f"(> max_pow_bits={max_pow}); increase log_blowup or "
                     f"use a larger field")
            return needed

        def query_count(stage_log_inv_rate, eta):
            return queries_for_base(
                pow_target, query_failure_base(a, stage_log_inv_rate, eta)
            )

        def validate_eta(stage, stage_log_inv_rate, eta):
            _require(math.isfinite(eta)
                     and 0.0 < eta <= eta_upper_bound(a, stage_log_inv_rate),
                     f"round {stage}: eta {eta} violates side condition")

        round_configs = []
        log_degree = log_starting_degree
        log_domain_size = log_starting_domain
        log_inv_rate = params.log_blowup
        domain_shift = F.GENERATOR

        eta = initial_eta(a, pow_target, buffered, log_degree,
                          log_inv_rate, lff, field_bits)
        validate_eta(0, log_inv_rate, eta)
        prev_queries = 0
        for rnd in range(n_rounds):
            if rnd != 0:
                eta = recursive_eta(a, pow_target, buffered, log_degree,
                                    log_inv_rate, log_domain_size, lff,
                                    field_bits, prev_queries)
                validate_eta(rnd, log_inv_rate, eta)
            nq = query_count(log_inv_rate, eta)
            # disjoint-coset side condition (config.rs:330)
            n_i = (rnd + 1) * lff + log_domain_size
            if n_i <= 64:
                _require(F.exp_h(F.GENERATOR, 1 << n_i) != 1,
                         f"round {rnd}: disjoint-coset condition fails")
            fold_alg = fold_algebraic_bits(a, field_bits, log_degree,
                                           log_inv_rate, math.log2(eta))
            query_alg = query_pow_eligible_bits(
                a, field_bits, log_degree, log_inv_rate, eta, nq, oods)
            unprot = query_unprotected_bits(
                a, field_bits, log_degree, log_inv_rate, eta, nq, oods)
            _require(unprot >= buffered,
                     f"round {rnd}: OOD/shake reach only {unprot:.2f} bits "
                     f"(< buffered target {buffered}); use a larger field")
            round_configs.append(StirRoundConfig(
                log_degree=log_degree,
                log_domain_size=log_domain_size,
                log_fold_domain_size=log_domain_size - lff,
                domain_shift=domain_shift,
                log_folding_factor=lff,
                eta=eta,
                num_queries=nq,
                num_ood_samples=oods,
                pow_bits=derive_pow("query", f"round {rnd}", query_alg),
                folding_pow_bits=derive_pow(
                    "folding", f"round {rnd}", fold_alg),
            ))
            prev_queries = nq
            log_degree -= lff
            log_domain_size -= 1
            log_inv_rate += lff - 1
            domain_shift = F.mul_h(
                F.exp_h(domain_shift, 1 << lff), F.GENERATOR
            )

        if total_folds != 1:
            eta = recursive_eta(a, pow_target, buffered, log_degree,
                                log_inv_rate, log_domain_size, lff,
                                field_bits, prev_queries)
            validate_eta(n_rounds, log_inv_rate, eta)
        final_queries = query_count(log_inv_rate, eta)
        final_fold_alg = fold_algebraic_bits(
            a, field_bits, log_degree, log_inv_rate, math.log2(eta))
        final_query_alg = final_query_algebraic_bits(
            a, log_inv_rate, eta, final_queries)
        return StirConfig(
            F=F, E=E, mmcs=mmcs,
            log_starting_degree=log_starting_degree,
            log_blowup=params.log_blowup,
            log_folding_factor=lff,
            security_level=sec,
            max_pow_bits=max_pow,
            soundness_type=a,
            round_configs=tuple(round_configs),
            log_final_degree=log_final_degree,
            final_queries=final_queries,
            final_eta=eta,
            final_pow_bits=derive_pow("query", "final", final_query_alg),
            final_folding_pow_bits=derive_pow(
                "folding", "final", final_fold_alg),
        )
