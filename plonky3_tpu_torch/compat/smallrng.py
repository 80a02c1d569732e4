"""rand::rngs::SmallRng emulation (Xoshiro256++) for fixture compatibility.

Port of `plonky3_tpu/compat/smallrng.py` (Python ints).

The reference's golden-fixture configs build their Poseidon2 permutations
from `SmallRng::seed_from_u64(1)` (`uni-stark/tests/fib_air.rs:134`). rand's
64-bit SmallRng is Xoshiro256PlusPlus with the SplitMix64 `seed_from_u64`
recommended by the xoshiro authors; `next_u32` takes the HIGH 32 bits of
`next_u64` (the low bits of ++ output have weak linear dependencies).

Field sampling follows `Distribution<MontyField31> for StandardUniform`
(`monty-31/src/monty_31.rs:154-165`): rejection-sample `next_u32() >> 1`
until `< P`; the accepted u31 IS the Monty-form representation.

Poseidon2 constants from an rng follow `Poseidon2::new_from_rng_128`
(`poseidon2/src/lib.rs:100-128`): external-initial rounds, then
external-terminal, then internal — each `[F; WIDTH]` array element-by-element.
"""

from __future__ import annotations

_M64 = (1 << 64) - 1


class SmallRng:
    """Xoshiro256PlusPlus, rand-compatible."""

    def __init__(self, s0: int, s1: int, s2: int, s3: int):
        self.s = [s0 & _M64, s1 & _M64, s2 & _M64, s3 & _M64]

    @classmethod
    def seed_from_u64(cls, seed: int) -> "SmallRng":
        """SplitMix64 expansion of a u64 seed into the 256-bit state."""
        state = seed & _M64
        out = []
        for _ in range(4):
            state = (state + 0x9E3779B97F4A7C15) & _M64
            z = state
            z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _M64
            z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _M64
            z ^= z >> 31
            out.append(z)
        return cls(*out)

    def next_u64(self) -> int:
        s = self.s

        def rotl(x, k):
            return ((x << k) | (x >> (64 - k))) & _M64

        result = (rotl((s[0] + s[3]) & _M64, 23) + s[0]) & _M64
        t = (s[1] << 17) & _M64
        s[2] ^= s[0]
        s[3] ^= s[1]
        s[1] ^= s[2]
        s[0] ^= s[3]
        s[2] ^= t
        s[3] = rotl(s[3], 45)
        return result

    def next_u32(self) -> int:
        # Upper bits: the ++ scrambler's low bits are weaker (rand's impl).
        return self.next_u64() >> 32

    # ------------------------------------------------------------------
    def sample_monty31(self, P: int) -> int:
        """One uniform field element; returns the MONTY-form u32."""
        while True:
            v = self.next_u32() >> 1
            if v < P:
                return v

    def sample_monty31_array(self, P: int, n: int) -> list:
        return [self.sample_monty31(P) for _ in range(n)]


def poseidon2_constants_from_rng(
    F, width: int, rounds_f: int, rounds_p: int, seed: int = 1
):
    """Round constants exactly as `Poseidon2::new_from_rng_128` draws them
    from `SmallRng::seed_from_u64(seed)`. Returns standard-form int lists
    (external_initial, external_terminal, internal)."""
    rng = SmallRng.seed_from_u64(seed)
    half_f = rounds_f // 2
    to_std = F.from_monty_h

    def draw_row():
        return [to_std(rng.sample_monty31(F.P)) for _ in range(width)]

    ext_initial = [draw_row() for _ in range(half_f)]
    ext_terminal = [draw_row() for _ in range(half_f)]
    internal = [to_std(rng.sample_monty31(F.P)) for _ in range(rounds_p)]
    return ext_initial, ext_terminal, internal
