"""STIR proof containers (stir/src/proof.rs).

Port of `plonky3_tpu/stir/proof.py`, field for field (Python ints,
tuples and lists), so `==` compares a port proof with the reference's.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class StirQueryOpenings:
    """One shared pruned multi-opening for a round's query fibers
    (proof.rs StirQueryOpenings)."""

    row_evals: list  # [query] -> fiber: [arity] ext tuples (std form)
    proof: list  # pruned sibling digests (mmcs.open_multi_batch)


@dataclass
class StirRoundProof:
    """One intermediate round (proof.rs StirRoundProof)."""

    commitment: tuple  # folded-oracle Merkle root (std digest tuple)
    folding_pow_witness: int
    ood_answers: list  # [num_ood_samples] ext tuples
    pow_witness: int
    ans_polynomial: list  # ascending ext coefficients
    shake_polynomial: list
    query_openings: StirQueryOpenings | None  # None for external oracle


@dataclass
class StirProof:
    """Whole proof (proof.rs StirProof)."""

    initial_commitment: tuple | None  # None when the input is external
    round_proofs: list  # [StirRoundProof]
    final_polynomial: list  # ext coefficients, length final_poly_len
    final_folding_pow_witness: int
    final_pow_witness: int
    final_query_openings: StirQueryOpenings | None

    def size_in_bytes(self, E) -> int:
        """Rough wire size (4 bytes per base element / digest word)."""
        D = E.D

        def openings(q):
            if q is None:
                return 0
            return (4 * D * sum(len(f) for f in q.row_evals)
                    + 4 * sum(len(d) for d in q.proof))

        total = 0
        if self.initial_commitment is not None:
            total += 4 * len(self.initial_commitment)
        for rp in self.round_proofs:
            total += 4 * len(rp.commitment) + 8
            total += 4 * D * (len(rp.ood_answers) + len(rp.ans_polynomial)
                              + len(rp.shake_polynomial))
            total += openings(rp.query_openings)
        total += 4 * D * len(self.final_polynomial) + 8
        return total + openings(self.final_query_openings)
