from .extension import BinomialExtension
from .monty31 import Monty31
from .params import KOALABEAR_EXT4, KoalaBear

KoalaBearExt4 = BinomialExtension(base=KoalaBear, **KOALABEAR_EXT4)

__all__ = ["BinomialExtension", "KoalaBear", "KoalaBearExt4", "Monty31"]
