from .extension import BinomialExtension
from .monty31 import Monty31
from .params import (BABYBEAR_EXT4, BABYBEAR_EXT8, KOALABEAR_EXT4,
                     KOALABEAR_EXT8, BabyBear, KoalaBear)

KoalaBearExt4 = BinomialExtension(base=KoalaBear, **KOALABEAR_EXT4)
KoalaBearExt8 = BinomialExtension(base=KoalaBear, **KOALABEAR_EXT8)
BabyBearExt4 = BinomialExtension(base=BabyBear, **BABYBEAR_EXT4)
BabyBearExt8 = BinomialExtension(base=BabyBear, **BABYBEAR_EXT8)

__all__ = ["BabyBear", "BabyBearExt4", "BabyBearExt8", "BinomialExtension",
           "KoalaBear", "KoalaBearExt4", "KoalaBearExt8", "Monty31"]
