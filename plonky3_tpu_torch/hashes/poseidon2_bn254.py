"""Poseidon2 over the BN254 scalar field, width 3, on the host.

Port of `plonky3_tpu/hashes/poseidon2_bn254.py` (bn254/src/poseidon2.rs):
S-box x^5, 4 + 4 full rounds and 56 partial rounds; the width-3 external
layer x_i += sum (poseidon2/src/external.rs:128-133), the internal layer
1 + Diag([1, 1, 2]) (bn254/src/poseidon2.rs:80-89). The round constants
come from `SmallRng::seed_from_u64(1)` (`compat/smallrng.py`) through the
reference's rejection sampler (bn254/src/bn254.rs:534-550: 32 random
little-endian bytes, the top two bits cleared, kept when below P; the
kept bytes are the Montgomery form, stored here as the canonical value),
drawn in new_from_rng_128 order (external initial, external terminal,
internal).
"""

from __future__ import annotations

from ..compat.smallrng import SmallRng
from ..fields.bn254 import BN254 as Bn254

P = Bn254.P
HALF_FULL_ROUNDS = 4
PARTIAL_ROUNDS = 56
WIDTH = 3
# Monty R for the reference's 4x64-limb Monty representation
_R_BN254 = (1 << 256) % P


def _rng_bytes32(rng: SmallRng) -> bytes:
    out = b""
    for _ in range(4):
        out += rng.next_u64().to_bytes(8, "little")
    return out


def _sample_bn254(rng: SmallRng) -> int:
    """bn254.rs:534 rejection sampler; returns the CANONICAL value of
    the accepted Monty-form bytes."""
    while True:
        b = bytearray(_rng_bytes32(rng))
        b[31] &= (1 << 6) - 1
        monty = int.from_bytes(bytes(b), "little")
        if monty < P:
            # from_bytes_monty: the bytes are the Monty form; canonical
            # value = monty · R^{-1} mod P
            return (monty * pow(_R_BN254, P - 2, P)) % P


def _constants(seed: int = 1):
    rng = SmallRng.seed_from_u64(seed)
    initial = [
        [_sample_bn254(rng) for _ in range(WIDTH)]
        for _ in range(HALF_FULL_ROUNDS)
    ]
    terminal = [
        [_sample_bn254(rng) for _ in range(WIDTH)]
        for _ in range(HALF_FULL_ROUNDS)
    ]
    internal = [_sample_bn254(rng) for _ in range(PARTIAL_ROUNDS)]
    return initial, terminal, internal


_CONSTS = None


def _consts():
    global _CONSTS
    if _CONSTS is None:
        _CONSTS = _constants()
    return _CONSTS


def _sbox(x: int) -> int:
    x2 = (x * x) % P
    x4 = (x2 * x2) % P
    return (x4 * x) % P


def _external_linear(s):
    total = sum(s) % P
    return [(x + total) % P for x in s]


def _internal_linear(s):
    total = sum(s) % P
    return [
        (s[0] + total) % P,
        (s[1] + total) % P,
        (2 * s[2] + total) % P,
    ]


def poseidon2_bn254_permute(state):
    """[3] canonical ints -> [3] canonical ints."""
    initial, terminal, internal = _consts()
    s = [x % P for x in state]
    s = _external_linear(s)
    for rc in initial:
        s = [_sbox((x + c) % P) for x, c in zip(s, rc)]
        s = _external_linear(s)
    for c in internal:
        s[0] = _sbox((s[0] + c) % P)
        s = _internal_linear(s)
    for rc in terminal:
        s = [_sbox((x + c) % P) for x, c in zip(s, rc)]
        s = _external_linear(s)
    return s
