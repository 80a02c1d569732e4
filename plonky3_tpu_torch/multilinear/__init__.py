"""Multilinear proving: WHIR, the zerocheck and the multilinear STARK,
and their zero-knowledge half (the zk codes, hiding WHIR, the masked
zerocheck).

Port of `plonky3_tpu/multilinear/` (the `whir`, `sumcheck`, `zk-codes`,
`multilinear-util` and `multi-stark` crates' analogs).
"""

from .hiding_whir import HidingWhirPcs, HidingWhirProof
from .mle import eq_table_device, eval_mle_host
from .sumcheck import SumcheckProof, prove_zerocheck, verify_zerocheck
from .zk_codes import ReedSolomonZkEncoding
from .zk_sumcheck import (
    MaskedZerocheckProof,
    prove_masked_zerocheck,
    verify_masked_zerocheck,
)

__all__ = [
    "eq_table_device",
    "eval_mle_host",
    "HidingWhirPcs",
    "HidingWhirProof",
    "MaskedZerocheckProof",
    "prove_masked_zerocheck",
    "ReedSolomonZkEncoding",
    "SumcheckProof",
    "prove_zerocheck",
    "verify_masked_zerocheck",
    "verify_zerocheck",
]
