"""FRI proof objects, copied field for field from `plonky3_tpu/fri/proof.py`
(fri/src/proof.rs shapes, Python-int standard form).

Values are stored canonically (standard form ints; extension elements as
D-tuples). Opening proofs are PRUNED multiproofs — one shared frontier-order
sibling list per tree, exactly the reference's `PrunedMerklePaths`
(`merkle-tree/src/pruning.rs`) — so the wire encoding is byte-compatible
with the reference's postcard fixtures.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class BatchMultiOpening:
    """Openings of one input commitment at every query index
    (fri/src/proof.rs BatchMultiOpening)."""

    opened_values: list  # [query][matrix] -> list[int] (base row values)
    opening_proof: list  # pruned: flat list of digest tuples


@dataclass
class CommitPhaseStep:
    """One FRI fold round's openings (CommitPhaseMultiStep)."""

    log_arity: int
    sibling_values: list  # [query] -> list of (arity-1) ext tuples
    opening_proof: list  # pruned: flat list of digest tuples


@dataclass
class FriProof:
    commit_phase_commits: list  # [round] -> digest tuple (8 ints)
    commit_pow_witnesses: list  # [round] -> int
    input_openings: list  # [batch] -> BatchMultiOpening
    commit_phase_steps: list  # [round] -> CommitPhaseStep
    final_poly: list  # ext tuples, coefficient order
    query_pow_witness: int
