"""KoalaBear and its degree-4 extension: the normative constants.

Copied from `plonky3_tpu/fields/params.py` (koala-bear/src/koala_bear.rs:
PRIME :21, MONTY_MU :24, MONTY_GEN :56, TWO_ADIC_GENERATORS :70-77, the
D=4 binomial extension :101-113). Proofs depend on every value.
"""

from __future__ import annotations

from .monty31 import Monty31

KoalaBear = Monty31(
    name="KoalaBear",
    P=0x7F000001,  # 2^31 - 2^24 + 1
    MU=0x81000001,
    TWO_ADICITY=24,
    GENERATOR=3,
    TWO_ADIC_GENERATORS=(
        0x1, 0x7F000000, 0x7E010002, 0x6832FE4A, 0x8DBD69C, 0xA28F031,
        0x5C4A5B99, 0x29B75A80, 0x17668B8A, 0x27AD539B, 0x334D48C7,
        0x7744959C, 0x768FC6FA, 0x303964B2, 0x3E687D4D, 0x45A60E61,
        0x6E2F4D7A, 0x163BD499, 0x6C4A8A45, 0x143EF899, 0x514DDCAD,
        0x484EF19B, 0x205D63C3, 0x68E7DD49, 0x6AC49F88,
    ),
)

# D=4: W=3, DTH_ROOT=2113994754, EXT_GENERATOR=[2,1,0,0], two-adicity 26.
KOALABEAR_EXT4 = dict(
    D=4, W=3, DTH_ROOT=2113994754, EXT_GENERATOR=(2, 1, 0, 0),
    EXT_TWO_ADICITY=26,
)
