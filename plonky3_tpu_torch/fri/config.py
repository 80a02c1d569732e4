"""FRI protocol parameters (fri/src/config.rs:10), copied from
`plonky3_tpu/fri/config.py`."""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class FriParameters:
    log_blowup: int
    log_final_poly_len: int
    max_log_arity: int
    num_queries: int
    commit_proof_of_work_bits: int
    query_proof_of_work_bits: int

    @property
    def blowup(self) -> int:
        return 1 << self.log_blowup

    @property
    def final_poly_len(self) -> int:
        return 1 << self.log_final_poly_len

    def conjectured_soundness_bits(self) -> int:
        """ethSTARK conjecture (config.rs:43)."""
        return self.log_blowup * self.num_queries + self.query_proof_of_work_bits

    @staticmethod
    def new_testing(log_final_poly_len: int = 0) -> "FriParameters":
        """Cheap test parameters (config.rs:76)."""
        return FriParameters(
            log_blowup=2,
            log_final_poly_len=log_final_poly_len,
            max_log_arity=1,
            num_queries=2,
            commit_proof_of_work_bits=1,
            query_proof_of_work_bits=1,
        )

    @staticmethod
    def new_benchmark() -> "FriParameters":
        """Production-like parameters (config.rs:104)."""
        return FriParameters(
            log_blowup=1,
            log_final_poly_len=0,
            max_log_arity=1,
            num_queries=100,
            commit_proof_of_work_bits=0,
            query_proof_of_work_bits=16,
        )

    @staticmethod
    def new_benchmark_high_arity() -> "FriParameters":
        """config.rs:118 — arity up to 2^3."""
        return FriParameters(
            log_blowup=1,
            log_final_poly_len=0,
            max_log_arity=3,
            num_queries=100,
            commit_proof_of_work_bits=0,
            query_proof_of_work_bits=16,
        )


def compute_log_arity_for_round(
    log_current_height: int,
    next_input_log_height,
    log_final_height: int,
    max_log_arity: int,
) -> int:
    """Per-round arity so every input height gets a commitment
    (fri/src/config.rs:180)."""
    if max_log_arity <= 0 or log_current_height <= log_final_height:
        raise ValueError("no FRI round left to fold")
    max_fold = log_current_height - log_final_height
    if next_input_log_height is not None:
        max_fold = min(max_fold, log_current_height - next_input_log_height)
    return min(max_fold, max_log_arity)
