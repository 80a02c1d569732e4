from .pcs import CircleFriFolding, CircleInputProof, CirclePcs, CirclePcsProof

__all__ = ["CircleFriFolding", "CircleInputProof", "CirclePcs",
           "CirclePcsProof"]
