"""uni-stark proof objects, copied field for field from
`plonky3_tpu/stark/proof.py` (uni-stark/src/proof.rs shapes)."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class Commitments:
    trace: tuple  # digest (8 standard ints)
    quotient_chunks: tuple
    random: tuple | None = None  # ZK randomization commitment (R)


@dataclass
class OpenedValues:
    trace_local: list  # [ext tuple] per trace column
    trace_next: list
    quotient_chunks: list  # [chunk] -> [ext tuple] per flattened column
    random: list | None = None  # ZK: R's opening at zeta
    # ZK: random-codeword openings from the hiding PCS, per opening round
    random_codewords: object = None


@dataclass
class Proof:
    commitments: Commitments
    opened_values: OpenedValues
    opening_proof: object  # FriProof
    degree_bits: int

    def size_in_bytes(self) -> int:
        """Serialized size with 4-byte field elements / digest words
        (the reference's report_proof_size analog)."""

        def count(x):
            if isinstance(x, (int, np.integer)):
                return 4
            if isinstance(x, (list, tuple)):
                return sum(count(v) for v in x)
            if hasattr(x, "__dict__"):
                return sum(count(v) for v in vars(x).values())
            return 0

        return count(self)
