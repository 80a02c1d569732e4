"""Rescue-XLIX and RPO permutations (the reference `rescue` crate), on
host ints and numpy.

Port of `plonky3_tpu/hashes/rescue.py`. A Rescue round (rescue/src/
rescue.rs:127-158) is the s-box x^alpha, the MDS and the round constants,
then the inverse s-box x^(1/alpha), the MDS and the constants. RPO
(rpo/mod.rs) takes per half-round the MDS, the constants and then the
s-box, with an optional concluding MDS and constants after the last
round (rpo/koala_bear.rs:59-85). The round constants are SHAKE-256 of a
seed string, little-endian `bytes_per_constant` chunks reduced mod p
(rpo/mod.rs:90-110). `RpoGeneric` takes p as an int, so the BabyBear,
Mersenne31 and Goldilocks instances need no field module.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass

import numpy as np

from .constants.poseidon1_constants import KOALABEAR_MDS_FIRST_ROW_24


def shake_round_constants(F, seed: bytes, width: int, num_rounds: int,
                          bytes_per_constant: int,
                          include_final_layer: bool):
    n = 2 * width * num_rounds + (width if include_final_layer else 0)
    raw = hashlib.shake_256(seed).digest(bytes_per_constant * n)
    out = []
    for i in range(n):
        chunk = raw[i * bytes_per_constant : (i + 1) * bytes_per_constant]
        out.append(int.from_bytes(chunk, "little") % F.P)
    return out


def _mds_host(F, first_row, state):
    P, w = F.P, len(state)
    return [
        sum(first_row[(j - i) % w] * state[j] for j in range(w)) % P
        for i in range(w)
    ]


@dataclass(frozen=True)
class Rescue:
    """Rescue-XLIX (rescue.rs permute_mut ordering)."""

    F: object
    width: int
    alpha: int
    num_rounds: int
    round_constants: tuple  # flat, 2·width·num_rounds
    mds_first_row: tuple

    def __post_init__(self):
        object.__setattr__(
            self, "alpha_inv", pow(self.alpha, -1, self.F.P - 1)
        )

    def permute_host(self, state):
        P, w = self.F.P, self.width
        rc = self.round_constants
        state = [x % P for x in state]
        for r in range(self.num_rounds):
            state = [pow(x, self.alpha, P) for x in state]
            state = _mds_host(self.F, self.mds_first_row, state)
            state = [
                (x + rc[r * 2 * w + i]) % P for i, x in enumerate(state)
            ]
            state = [pow(x, self.alpha_inv, P) for x in state]
            state = _mds_host(self.F, self.mds_first_row, state)
            state = [
                (x + rc[r * 2 * w + w + i]) % P
                for i, x in enumerate(state)
            ]
        return state


@dataclass(frozen=True)
class RpoKoalaBear:
    """RPO over KoalaBear, width 24, 7 rounds, concluding linear step
    (rpo/koala_bear.rs; seed RPO-KB:p=2130706433,m=24,c=8,n=7)."""

    F: object
    width: int = 24
    alpha: int = 3
    num_rounds: int = 7

    def __post_init__(self):
        seed = (
            f"RPO-KB:p={self.F.P},m={self.width},c=8,n={self.num_rounds}"
        ).encode()
        rcs = shake_round_constants(
            self.F, seed, self.width, self.num_rounds, 5, True
        )
        object.__setattr__(self, "rcs", rcs)
        object.__setattr__(
            self, "alpha_inv", pow(self.alpha, -1, self.F.P - 1)
        )

    def permute_host(self, state):
        P, w = self.F.P, self.width
        row = KOALABEAR_MDS_FIRST_ROW_24
        rcs = self.rcs
        state = [x % P for x in state]
        for r in range(self.num_rounds):
            state = _mds_host(self.F, row, state)
            state = [
                (x + rcs[2 * r * w + i]) % P for i, x in enumerate(state)
            ]
            state = [pow(x, self.alpha, P) for x in state]
            state = _mds_host(self.F, row, state)
            state = [
                (x + rcs[(2 * r + 1) * w + i]) % P
                for i, x in enumerate(state)
            ]
            state = [pow(x, self.alpha_inv, P) for x in state]
        state = _mds_host(self.F, row, state)
        state = [
            (x + rcs[2 * self.num_rounds * w + i]) % P
            for i, x in enumerate(state)
        ]
        return state

    def permute_np(self, states):
        """Batched numpy permutation (..., 24) canonical u32."""
        F = self.F
        w = self.width
        row = np.array(KOALABEAR_MDS_FIRST_ROW_24, dtype=np.uint64)
        mds = np.array(
            [[row[(j - i) % w] for j in range(w)] for i in range(w)],
            dtype=np.uint64,
        )
        rcs = np.array(self.rcs, dtype=np.uint64)
        P = np.uint64(F.P)

        def mds_mul(x):
            # each product is below 2^62: reduced before the sum
            prods = (x[..., None, :].astype(np.uint64) * mds) % P
            return prods.sum(axis=-1) % P

        def exp(x, e):
            acc = np.ones_like(x)
            base = x.copy()
            while e:
                if e & 1:
                    acc = (acc * base) % P
                base = (base * base) % P
                e >>= 1
            return acc

        x = np.asarray(states, dtype=np.uint64) % P
        for r in range(self.num_rounds):
            x = (mds_mul(x) + rcs[2 * r * w : (2 * r + 1) * w]) % P
            x = exp(x, self.alpha)
            x = (mds_mul(x) + rcs[(2 * r + 1) * w : (2 * r + 2) * w]) % P
            x = exp(x, self.alpha_inv)
        x = (mds_mul(x) + rcs[2 * self.num_rounds * w :]) % P
        return x.astype(np.uint32)


def _mds_coeff_host(P, coeff, state):
    """Dense MDS with an explicit coefficient function C[i][j]."""
    w = len(state)
    return [
        sum(coeff(i, j) * state[j] for j in range(w)) % P for i in range(w)
    ]


@dataclass(frozen=True)
class RpoGeneric:
    """RPO over an arbitrary prime field with an explicit MDS coefficient
    rule (rpo/{baby_bear,mersenne_31,goldilocks}.rs): per round
    MDS -> ARK -> x^alpha -> MDS -> ARK -> x^(1/alpha), then a concluding
    MDS + ARK layer. Round constants from SHAKE-256 of the per-field seed
    (little-endian chunks mod p)."""

    P: int
    width: int
    alpha: int
    seed: bytes
    bytes_per_constant: int
    coeff: object  # (i, j) -> int
    num_rounds: int = 7
    final_layer: bool = True  # concluding MDS+ARK (absent for the
    # Miden-interoperable Goldilocks instance, rpo/goldilocks.rs:71)

    def __post_init__(self):
        class _F:
            P = self.P

        rcs = shake_round_constants(
            _F, self.seed, self.width, self.num_rounds,
            self.bytes_per_constant, self.final_layer,
        )
        object.__setattr__(self, "rcs", rcs)
        object.__setattr__(
            self, "alpha_inv", pow(self.alpha, -1, self.P - 1)
        )

    def permute_host(self, state):
        P, w = self.P, self.width
        rcs = self.rcs
        state = [x % P for x in state]
        for r in range(self.num_rounds):
            state = _mds_coeff_host(P, self.coeff, state)
            state = [
                (x + rcs[2 * r * w + i]) % P for i, x in enumerate(state)
            ]
            state = [pow(x, self.alpha, P) for x in state]
            state = _mds_coeff_host(P, self.coeff, state)
            state = [
                (x + rcs[(2 * r + 1) * w + i]) % P
                for i, x in enumerate(state)
            ]
            state = [pow(x, self.alpha_inv, P) for x in state]
        if self.final_layer:
            state = _mds_coeff_host(P, self.coeff, state)
            state = [
                (x + rcs[2 * self.num_rounds * w + i]) % P
                for i, x in enumerate(state)
            ]
        return state


# BabyBear: width 24, alpha 7, the BB 24-circulant MDS
# (baby-bear/src/mds.rs:21, rpo/baby_bear.rs:14-26)
_BB_MDS_ROW_24 = (
    0x2D0AAAAB, 0x64850517, 0x17F5551D, 0x04ECBEB5, 0x6D91A8D5,
    0x60703026, 0x18D6F3CA, 0x729601A7, 0x77CDA9E2, 0x3C0F5038,
    0x26D52A61, 0x0360405D, 0x68FC71C8, 0x2495A71D, 0x5D57AFC2,
    0x1689DD98, 0x3C2C3DBE, 0x0C23DC41, 0x0524C7F2, 0x6BE4DF69,
    0x0A6E572C, 0x5C7790FA, 0x17E118F6, 0x0878A07F,
)


def rpo_baby_bear():
    return RpoGeneric(
        P=2013265921, width=24, alpha=7,
        seed=b"RPO-BB:p=2013265921,m=24,c=8,n=7",
        bytes_per_constant=5,
        coeff=lambda i, j: _BB_MDS_ROW_24[(j - i) % 24],
    )


# Mersenne31: width 24, alpha 5, a 24x24 slice of a 32-circulant
# (rpo/mersenne_31.rs:17-32; seed uses U+2011 NON-BREAKING HYPHEN)
_M31_MDS_ROW_32 = (
    185870542, 2144994796, 1696461115, 215190769, 930115258, 766567118,
    2003379079, 1770558586, 1779722644, 434368282, 289154277, 1979813463,
    1436360233, 1342944808, 63026005, 903393155, 1512525948, 105409451,
    1072974295, 979558870, 436105640, 2126764826, 1981550821, 636196459,
    645360517, 412540024, 1649351985, 1485803845, 53244687, 719457988,
    270924307, 82564914,
)


def rpo_mersenne31():
    return RpoGeneric(
        P=(1 << 31) - 1, width=24, alpha=5,
        seed="RPO‑M31:p=2147483647,m=24,c=8,n=7".encode("utf-8"),
        bytes_per_constant=5,
        coeff=lambda i, j: _M31_MDS_ROW_32[(j + 32 - i) % 32],
    )


# Goldilocks: width 12, alpha 7, the RPO-paper circulant (interoperable
# with Miden's RPO; rpo/goldilocks.rs:12-68,330)
_GL_MDS_ROW_12 = (7, 23, 8, 26, 13, 10, 9, 7, 6, 22, 21, 8)


def rpo_goldilocks():
    p = (1 << 64) - (1 << 32) + 1
    return RpoGeneric(
        P=p, width=12, alpha=7,
        seed=f"RPO({p},12,4,128)".encode(),
        bytes_per_constant=9,
        coeff=lambda i, j: _GL_MDS_ROW_12[(j - i) % 12],
        final_layer=False,
    )
