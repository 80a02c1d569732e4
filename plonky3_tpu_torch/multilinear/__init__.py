"""Multilinear proving: WHIR, the zerocheck and the multilinear STARK.

Port of `plonky3_tpu/multilinear/` (the `whir`, `sumcheck`,
`multilinear-util` and `multi-stark` crates' analogs).
"""

from .mle import eq_table_device, eval_mle_host
from .sumcheck import SumcheckProof, prove_zerocheck, verify_zerocheck

__all__ = [
    "eq_table_device",
    "eval_mle_host",
    "SumcheckProof",
    "prove_zerocheck",
    "verify_zerocheck",
]
