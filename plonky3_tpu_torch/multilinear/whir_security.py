"""WHIR soundness calculators (security/src/{assumption,whir}.rs).

Port of `plonky3_tpu/multilinear/whir_security.py`, host math.

Three regimes (assumption.rs:41): "unique" (unique decoding, no
conjectures), "johnson" (Johnson bound at delta = 1 - sqrt(rho) - eta,
eta = sqrt(rho)/20), "capacity" (capacity bound at delta = 1 - rho -
eta, eta = rho/20). All outputs are BITS of security (higher = better).
"""

from __future__ import annotations

import math

LOG2_10 = math.log2(10.0)

UNIQUE = "unique"
JOHNSON = "johnson"
CAPACITY = "capacity"


def log_eta(assumption: str, log_inv_rate: int) -> float:
    """log2(eta) — the safety gap below the regime's decoding distance
    (assumption.rs:67)."""
    if assumption == JOHNSON:  # eta = sqrt(rho)/20
        return -(0.5 * log_inv_rate + LOG2_10 + 1.0)
    if assumption == CAPACITY:  # eta = rho/20
        return -(log_inv_rate + LOG2_10 + 1.0)
    raise ValueError("log_eta undefined for unique decoding")


def list_size_bits(assumption: str, log_degree: int,
                   log_inv_rate: int) -> float:
    """log2(L+) — list size at the regime's distance (assumption.rs:79)."""
    if assumption == UNIQUE:
        return 0.0
    if assumption == JOHNSON:
        le = log_eta(assumption, log_inv_rate)
        return log_inv_rate / 2.0 - (1.0 + le)
    return (log_degree + log_inv_rate) - log_eta(assumption, log_inv_rate)


def log_1_delta(assumption: str, log_inv_rate: int) -> float:
    """log2(1 - delta) at the regime's proximity parameter
    (assumption.rs:186)."""
    rate = 1.0 / (1 << log_inv_rate)
    if assumption == UNIQUE:
        delta = 0.5 * (1.0 - rate)
    elif assumption == JOHNSON:
        delta = 1.0 - math.sqrt(rate) - 2.0 ** log_eta(
            assumption, log_inv_rate
        )
    else:
        delta = 1.0 - rate - 2.0 ** log_eta(assumption, log_inv_rate)
    return math.log2(1.0 - delta)


def queries(assumption: str, protocol_security_level: int,
            log_inv_rate: int) -> int:
    """Smallest t with (1 - delta)^t < 2^-level (assumption.rs:200)."""
    return math.ceil(
        -protocol_security_level / log_1_delta(assumption, log_inv_rate)
    )


def queries_error(assumption: str, log_inv_rate: int,
                  num_queries: int) -> float:
    """Bits of security from num_queries queries (assumption.rs:208)."""
    return -num_queries * log_1_delta(assumption, log_inv_rate)


def ood_error(assumption: str, log_degree: int, log_inv_rate: int,
              field_size_bits: int, ood_samples: int) -> float:
    """OOD sampling error bits (whir.rs:17, STIR Lemma 4.5)."""
    if assumption == UNIQUE:
        return float("inf")
    ls = list_size_bits(assumption, log_degree, log_inv_rate)
    error = 2.0 * ls + log_degree * ood_samples
    return ood_samples * field_size_bits + 1.0 - error


def determine_ood_samples(assumption: str, security_level: int,
                          log_degree: int, log_inv_rate: int,
                          field_size_bits: int) -> int:
    """Smallest OOD count clearing security_level bits (whir.rs:42)."""
    if assumption == UNIQUE:
        return 0
    for n in range(1, 64):
        if ood_error(
            assumption, log_degree, log_inv_rate, field_size_bits, n
        ) >= security_level:
            return n
    raise ValueError("field too small for requested OOD security")


def prox_gaps_error(assumption: str, log_degree: int, log_inv_rate: int,
                    field_size_bits: int, num_functions: int) -> float:
    """Proximity-gap error bits for combining num_functions codewords
    (assumption.rs prox_gaps_error; JB branch = [BCSS25] Thm 1.5 at
    m = 10, dominant term only)."""
    if assumption == UNIQUE:
        # error = deg / |F| * num_functions
        return field_size_bits - (
            log_degree + math.log2(max(num_functions, 1))
        )
    if assumption == JOHNSON:
        m_plus_half = 10.5
        log_n = log_degree + log_inv_rate
        lead = math.log2(2.0 * m_plus_half**5 / 3.0)
        err = lead + 1.5 * log_inv_rate + log_n + math.log2(
            max(num_functions - 1, 1)
        )
        return field_size_bits - err
    # capacity: (d/(rho*eta))^2-ish conjecture; mirror the reference's
    # (log list)^... conservative: err = 2*list + log(num_functions)
    ls = list_size_bits(assumption, log_degree, log_inv_rate)
    return field_size_bits - (
        ls + log_degree + math.log2(max(num_functions - 1, 1))
    )


def fold_sumcheck_error(assumption: str, field_size_bits: int,
                        num_variables: int, log_inv_rate: int) -> float:
    """Fold-step sumcheck bits (whir.rs:71)."""
    ls = list_size_bits(assumption, num_variables, log_inv_rate)
    return field_size_bits - (ls + 1.0)


def queries_combination_error(assumption: str, field_size_bits: int,
                              num_variables: int, log_inv_rate: int,
                              ood_samples: int,
                              num_queries: int) -> float:
    """Random-linear-combination soundness bits (whir.rs:93)."""
    ls = list_size_bits(assumption, num_variables, log_inv_rate)
    return field_size_bits - (
        math.log2(max(ood_samples + num_queries, 1)) + ls + 1.0
    )


def folding_pow_bits(assumption: str, security_level: int,
                     field_size_bits: int, num_variables: int,
                     log_inv_rate: int) -> float:
    """PoW closing the fold-step gap (whir.rs:115)."""
    pg = prox_gaps_error(
        assumption, num_variables, log_inv_rate, field_size_bits, 2
    )
    sc = fold_sumcheck_error(
        assumption, field_size_bits, num_variables, log_inv_rate
    )
    return max(0.0, security_level - min(pg, sc))
