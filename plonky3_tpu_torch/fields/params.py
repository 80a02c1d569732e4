"""KoalaBear, BabyBear and their degree-4 and degree-8 extensions: the
normative constants.

Copied from `plonky3_tpu/fields/params.py` (koala-bear/src/koala_bear.rs:
PRIME :21, MONTY_MU :24, MONTY_GEN :56, TWO_ADIC_GENERATORS :70-77, the
binomial extensions D=4 :101-113 and D=8 :116-131; baby-bear/src/
baby_bear.rs: PRIME 0x78000001, MONTY_MU 0x88000001, MONTY_GEN 31,
TWO_ADICITY 27, the D=4 and D=8 extensions). Proofs depend on every
value.
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

BabyBear = Monty31(
    name="BabyBear",
    P=0x78000001,  # 2^31 - 2^27 + 1
    MU=0x88000001,
    TWO_ADICITY=27,
    GENERATOR=31,
    TWO_ADIC_GENERATORS=(
        0x1, 0x78000000, 0x67055C21, 0x5EE99486, 0xBB4C4E4, 0x2D4CC4DA,
        0x669D6090, 0x17B56C64, 0x67456167, 0x688442F9, 0x145E952D,
        0x4FE61226, 0x4C734715, 0x11C33E2A, 0x62C3D2B1, 0x77CAD399,
        0x54C131F4, 0x4CABD6A6, 0x5CF5713F, 0x3E9430E8, 0xBA067A3,
        0x18ADC27D, 0x21FD55BC, 0x4B859B3D, 0x3BD57996, 0x4483D85A,
        0x3A26EEF8, 0x1A427A41,
    ),
)

# D=4: W=3, DTH_ROOT=2113994754, EXT_GENERATOR=[2,1,0,0], two-adicity 26.
KOALABEAR_EXT4 = dict(
    D=4, W=3, DTH_ROOT=2113994754, EXT_GENERATOR=(2, 1, 0, 0),
    EXT_TWO_ADICITY=26,
)
# D=8: W=3, DTH_ROOT=1748172362, EXT_GENERATOR=[10,1,0,...], two-adicity 27.
KOALABEAR_EXT8 = dict(
    D=8, W=3, DTH_ROOT=1748172362,
    EXT_GENERATOR=(10, 1, 0, 0, 0, 0, 0, 0), EXT_TWO_ADICITY=27,
)
# D=4: W=11, DTH_ROOT=1728404513, EXT_GENERATOR=[8,1,0,0], two-adicity 29.
BABYBEAR_EXT4 = dict(
    D=4, W=11, DTH_ROOT=1728404513, EXT_GENERATOR=(8, 1, 0, 0),
    EXT_TWO_ADICITY=29,
)
# D=8: W=11, DTH_ROOT=420899707, EXT_GENERATOR=[5,1,0,...], two-adicity 30.
BABYBEAR_EXT8 = dict(
    D=8, W=11, DTH_ROOT=420899707,
    EXT_GENERATOR=(5, 1, 0, 0, 0, 0, 0, 0), EXT_TWO_ADICITY=30,
)
