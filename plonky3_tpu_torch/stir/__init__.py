"""STIR low-degree test and PCS (the `stir/` crate).

Port of `plonky3_tpu/stir/`.

Construction 5.2: each round folds the oracle's degree by
k = 2^log_folding_factor while the evaluation domain only halves, so the
code rate improves by 2^(k-1) per round; OOD samples + Ans/shake
polynomials + degree correction carry consistency between rounds."""

from .config import CAPACITY, JOHNSON, StirConfig, StirParameters
from .proof import StirProof, StirQueryOpenings, StirRoundProof
from .prover import (
    prove_stir,
    prove_stir_from_codeword,
    prove_stir_from_external_codeword,
)
from .verifier import (
    StirError,
    verify_stir,
    verify_stir_with_external_initial,
)

__all__ = [
    "CAPACITY",
    "JOHNSON",
    "StirConfig",
    "StirParameters",
    "StirProof",
    "StirQueryOpenings",
    "StirRoundProof",
    "StirError",
    "prove_stir",
    "prove_stir_from_codeword",
    "prove_stir_from_external_codeword",
    "verify_stir",
    "verify_stir_with_external_initial",
]
