from .extension import BinomialExtension
from .monty31 import Monty31
from .params import BABYBEAR_EXT4, KOALABEAR_EXT4, BabyBear, KoalaBear

KoalaBearExt4 = BinomialExtension(base=KoalaBear, **KOALABEAR_EXT4)
BabyBearExt4 = BinomialExtension(base=BabyBear, **BABYBEAR_EXT4)

__all__ = ["BabyBear", "BabyBearExt4", "BinomialExtension", "KoalaBear",
           "KoalaBearExt4", "Monty31"]
