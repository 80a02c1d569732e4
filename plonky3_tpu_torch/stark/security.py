"""Soundness-bit calculators — port of the `security` crate surface.

A copy of `plonky3_tpu/stark/security.py` (pure Python; the port keeps its
own copy and imports nothing of the JAX package). The CLI's report calls
`conjectured_security` and `proven_security`.

Mirrors `security/src/{fri,air,deep,proximity,stark}.rs`: conjectured
(ethSTARK/random-words) and proven (UDR + best-m LDR) regimes, composed
from AIR-composition (ALI), DEEP-ALI, and FRI commit/query errors, capped
at the hash collision resistance. Formula sources cited per function.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

LDR_M_CAP = 100


@dataclass(frozen=True)
class StarkAirParams:
    """security/src/shape.rs: AIR-side inputs."""

    num_constraints: int
    max_constraint_degree: int
    max_combo: int  # max number of opening points per polynomial (2)


@dataclass(frozen=True)
class InstanceShape:
    log_trace_length: int
    modulus_bits: float  # log2(|challenge field|)
    collision_resistance: float  # digest bits / 2


@dataclass(frozen=True)
class FriRegime:
    """security/src/fri.rs:32 — mirror of FriParameters."""

    log_blowup: int
    num_queries: int
    log_final_poly_len: int
    max_log_arity: int
    commit_pow_bits: int
    query_pow_bits: int

    @property
    def folding_factor(self):
        return float(1 << self.max_log_arity)


def conjectured_error(regime: FriRegime, shape: InstanceShape) -> float:
    """Conjectured LDT bits (fri.rs:69, random-words 2025/2010 §1.5)."""
    if regime.log_blowup == 0 or shape.modulus_bits == 0:
        return float(regime.query_pow_bits)
    rho = 2.0 ** -regime.log_blowup
    eta = ((math.log2(math.e) + regime.log_blowup) * rho) / shape.modulus_bits
    eff = rho + eta
    if eff <= 0 or eff >= 1:
        return float(regime.query_pow_bits)
    return regime.num_queries * -math.log2(eff) + regime.query_pow_bits


def alpha_udr(log_trace_length, log_blowup, max_combo):
    k = float(1 << log_trace_length)
    n = float(1 << (log_trace_length + log_blowup))
    return (1.0 + (k + max_combo) / n) * 0.5


def alpha_ldr_m(log_blowup, m):
    return (1.0 + 0.5 / m) * math.sqrt(2.0 ** -log_blowup)


def gamma_ldr_m(log_blowup, m):
    return 1.0 - alpha_ldr_m(log_blowup, m)


def list_size_udr():
    return 1.0


def list_size_ldr_m(log_blowup, m):
    return (m + 0.5) / math.sqrt(2.0 ** -log_blowup)


def query_phase_error(alpha, num_queries, query_pow_bits) -> float:
    if not math.isfinite(alpha) or alpha <= 0 or alpha >= 1:
        return 0.0
    return query_pow_bits - num_queries * math.log2(alpha)


def commit_phase_error_udr(regime: FriRegime, shape: InstanceShape):
    """fri.rs:90: ε ≤ (folding−1)·(n+1)/|F| per round."""
    lde_log = shape.log_trace_length + regime.log_blowup
    if lde_log - regime.log_final_poly_len <= 0:
        return None
    n = float(1 << lde_log)
    fm1 = max(regime.folding_factor - 1.0, 1.0)
    return max(
        shape.modulus_bits - math.log2(fm1 * (n + 1.0))
        + regime.commit_pow_bits,
        0.0,
    )


def commit_phase_error_ldr_m(regime, shape, m):
    """fri.rs:112 (BCHKS25 Thm 1.5 eq (1), min with n/q-style bound)."""
    rho = 2.0 ** -regime.log_blowup
    sq = math.sqrt(rho)
    ms = m + 0.5
    pp = gamma_ldr_m(regime.log_blowup, m)
    if pp <= 0:
        return 0.0
    n = float(1 << (shape.log_trace_length + regime.log_blowup))
    fm1 = max(regime.folding_factor - 1.0, 1.0)
    eps_lin = ((2 * ms**5 + 3 * ms * pp * rho) * n) / (3 * rho * sq) + ms / sq
    bits_lin = (
        shape.modulus_bits - math.log2(max(eps_lin * fm1, 1.0))
        + regime.commit_pow_bits
    )
    bits_nq = (
        shape.modulus_bits - math.log2(regime.folding_factor)
        - math.log2(n + 1.0) - math.log2(2.0 * m + 1.0)
        + 0.5 * math.log2(rho) + regime.commit_pow_bits
    )
    return max(min(bits_lin, bits_nq), 0.0)


def proven_error_udr(regime, air: StarkAirParams, shape) -> float:
    """fri.rs:153."""
    if regime.log_blowup == 0 or shape.log_trace_length == 0:
        return 0.0
    alpha = alpha_udr(
        shape.log_trace_length, regime.log_blowup, air.max_combo
    )
    lde = float(1 << (shape.log_trace_length + regime.log_blowup))
    k = float(1 << shape.log_trace_length)
    if k + air.max_combo >= alpha * lde:
        return 0.0
    query = query_phase_error(
        alpha, regime.num_queries, regime.query_pow_bits
    )
    commit = commit_phase_error_udr(regime, shape)
    return query if commit is None else min(commit, query)


def proven_error_ldr_m(regime, air, shape, m) -> float:
    if regime.log_blowup == 0 or shape.log_trace_length == 0:
        return 0.0
    alpha = alpha_ldr_m(regime.log_blowup, m)
    if alpha >= 1.0:
        return 0.0
    pp = gamma_ldr_m(regime.log_blowup, m)
    if pp <= 0:
        return 0.0
    lde = float(1 << (shape.log_trace_length + regime.log_blowup))
    k = float(1 << shape.log_trace_length)
    if k + air.max_combo >= (1.0 - pp) * lde:
        return 0.0
    return min(
        commit_phase_error_ldr_m(regime, shape, m),
        query_phase_error(alpha, regime.num_queries, regime.query_pow_bits),
    )


def compute_upper_m(trace_length) -> int:
    if trace_length == 0:
        return 0
    ratio = (trace_length + 2.0) / trace_length
    return math.ceil(1.0 / (2.0 * (math.sqrt(ratio) - 1.0)))


def composition_error(num_constraints, list_size, modulus_bits) -> float:
    """air.rs:11 (ALI)."""
    if num_constraints == 0 or list_size <= 0:
        return 0.0
    return max(
        modulus_bits - math.log2(list_size) - math.log2(num_constraints),
        0.0,
    )


def deep_ali_error(air, shape, list_size) -> float:
    """deep.rs:19."""
    if list_size <= 0:
        return 0.0
    k = float(1 << shape.log_trace_length)
    factor = max(
        air.max_constraint_degree * (k + air.max_combo - 1.0) + (k - 1.0),
        1.0,
    )
    return max(
        shape.modulus_bits - math.log2(list_size) - math.log2(factor), 0.0
    )


def proven_security(regime: FriRegime, air: StarkAirParams,
                    shape: InstanceShape) -> float:
    """stark.rs:86: max over regimes of min(ALI, DEEP, LDT), capped at
    hash collision resistance."""

    def regime_bits(list_size, ldt):
        return min(
            composition_error(
                air.num_constraints, list_size, shape.modulus_bits
            ),
            deep_ali_error(air, shape, list_size),
            ldt,
            shape.collision_resistance,
        )

    best = regime_bits(
        list_size_udr(), proven_error_udr(regime, air, shape)
    )
    m_max = min(compute_upper_m(1 << shape.log_trace_length), LDR_M_CAP)
    for m in range(3, m_max + 1):
        bits = regime_bits(
            list_size_ldr_m(regime.log_blowup, m),
            proven_error_ldr_m(regime, air, shape, m),
        )
        best = max(best, bits)
    return best


def conjectured_security(regime: FriRegime, shape: InstanceShape) -> float:
    return min(conjectured_error(regime, shape), shape.collision_resistance)
