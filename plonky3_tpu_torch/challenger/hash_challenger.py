"""HashChallenger: a Fiat-Shamir transcript over any hasher of field
elements (challenger/src/hash_challenger.rs).

Port of `plonky3_tpu/challenger/hash_challenger.py`, on the host.

  observe:  clear the output; buffer the value.
  flush:    digest = H(input buffer); the input buffer becomes the digest
            (chaining), and so does the output buffer.
  sample:   flush when the output is empty; pop from the end.

The hasher is any object with `hash_iter_host(elems) -> tuple` (the
Poseidon2 sponge, the keccak sponges, the BN254 MultiField32 sponge).
"""

from __future__ import annotations


def sample_uniform_bits(challenger, F, bits: int) -> int:
    """The unbiased bit sampler (duplex_challenger.rs:378): draw field
    elements, rejecting any >= m_k = (P >> k) << k, and keep the low k
    bits; above the field's two-adicity (where a rejection stops being
    rare) two half-width draws combine. Port of the reference's
    `challenger/duplex.py::_sample_uniform_bits`."""
    if bits == 0:
        return 0
    P = F.P
    if (1 << bits) >= P:
        raise ValueError(f"{bits} bits exceed the field")

    def draw(k: int) -> int:
        m = (P >> k) << k
        v = challenger.sample()
        while v >= m:
            v = challenger.sample()
        return v & ((1 << k) - 1)

    if bits <= getattr(F, "TWO_ADICITY", 24):
        return draw(bits)
    half = bits // 2
    return draw(half) | (draw(bits - half) << half)


class HashChallenger:
    def __init__(self, hasher, F, initial_state=()):
        self.hasher = hasher
        self.F = F
        self.input_buffer = list(initial_state)
        self.output_buffer = []

    def _flush(self):
        digest = list(self.hasher.hash_iter_host(self.input_buffer))
        self.input_buffer = list(digest)
        self.output_buffer = list(digest)

    def observe(self, value: int):
        self.output_buffer.clear()
        self.input_buffer.append(int(value) % self.F.P)

    def observe_many(self, values):
        for v in values:
            self.observe(int(v))

    def observe_ext(self, ext_tuple):
        for c in ext_tuple:
            self.observe(int(c))

    def observe_digest(self, values):
        if values and isinstance(values[0], (tuple, list, bytes)):
            for d in values:  # Merkle cap: observe each digest in order
                self.observe_many(d)
        else:
            self.observe_many(values)

    def sample(self) -> int:
        if not self.output_buffer:
            self._flush()
        return self.output_buffer.pop()

    def sample_ext(self, D: int) -> tuple:
        return tuple(self.sample() for _ in range(D))

    def sample_bits(self, bits: int) -> int:
        if (1 << bits) >= self.F.P:
            raise ValueError(f"{bits} bits exceed the field")
        return self.sample() & ((1 << bits) - 1)

    def sample_uniform_bits(self, bits: int) -> int:
        return sample_uniform_bits(self, self.F, bits)

    def check_witness(self, bits: int, witness: int) -> bool:
        if bits == 0:
            return True
        self.observe(witness)
        return self.sample_bits(bits) == 0

    def grind(self, bits: int) -> int:
        if bits == 0:
            return 0
        import copy

        for w in range(self.F.P):
            trial = copy.deepcopy(self)
            if trial.check_witness(bits, w):
                self.check_witness(bits, w)
                return w
        raise RuntimeError("no grind witness found")
