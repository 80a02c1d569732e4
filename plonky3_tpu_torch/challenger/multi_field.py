"""MultiField32Challenger: 31-bit samples from a BN254-sponge transcript.

Port of `plonky3_tpu/challenger/multi_field.py`
(challenger/src/multi_field_challenger.rs:35): the transcript's sponge
works in a large prime field PF (BN254, Poseidon2 width 3, rate 2), while
observations and samples are 32-bit field elements.

  observe(F):  buffered; on a flush, chunks of `absorb_n` values pack by
               Horner (radix 2^b, b the bit length of F.P - 1, the first
               value most significant) into PF rate cells, absorbed with
               the length tag (the number of F values;
               multi_field_challenger.rs:113-128).
  observe_digest(PF words): flush, then absorb the words in RATE-sized
               blocks, the tag the words a block (:185-205).
  sample():    each squeezed PF rate cell splits into `squeeze_n`
               base-|F| limbs (little-endian divmod by |F|,
               field/src/helpers.rs:340), popped from the end.
  sample_bits: the low bits of a sampled F value (:274-300).

The whole transcript is digest-sized, so it runs on the host in exact
ints, as the reference's does.
"""

from __future__ import annotations

from ..fields.bn254 import BN254 as Bn254
from ..hashes.poseidon2_bn254 import WIDTH, poseidon2_bn254_permute
from .hash_challenger import sample_uniform_bits

PF_P = Bn254.P
RATE = 2


def absorb_radix_bits(F) -> int:
    return (F.P - 1).bit_length()


def max_absorb_injective_limbs(F) -> int:
    """helpers.rs:197: largest k with (P-1)·Σ 2^{bi} < |PF|."""
    b = absorb_radix_bits(F)
    max_digit = F.P - 1
    k, max_val, power = 0, 0, 1
    while True:
        new_max = max_val + max_digit * power
        if new_max >= PF_P:
            return k
        max_val = new_max
        power <<= b
        k += 1


def squeeze_field_order_num_limbs(F) -> int:
    """helpers.rs:319: count-1 where p^count < |PF|."""
    count, power = 0, 1
    while power * F.P < PF_P:
        power *= F.P
        count += 1
    return max(count - 1, 0)


def reduce_packed(vals, radix_bits: int) -> int:
    """Horner with the FIRST value most significant (helpers.rs:173)."""
    acc = 0
    for v in vals:
        acc = (acc * (1 << radix_bits) + int(v)) % PF_P
    return acc


def split_pf_limbs(val: int, num_limbs: int, p: int):
    """helpers.rs:340: little-endian divmod-by-p limbs."""
    out, rem = [], int(val)
    for _ in range(num_limbs):
        out.append(rem % p)
        rem //= p
    return out


class MultiField32Challenger:
    def __init__(self, F, permute=poseidon2_bn254_permute):
        if F.P >= PF_P:
            raise ValueError("the observed field must be smaller than BN254")
        self.F = F
        self.permute = permute
        self.state = [0] * WIDTH
        self.output_buffer = []  # PF values, state[..RATE] after absorb
        self.f_buffer = []  # pending F observations
        self.f_squeeze_buffer = []  # expanded F limbs (pop from end)
        self._absorb_n = max_absorb_injective_limbs(F)
        self._squeeze_n = squeeze_field_order_num_limbs(F)
        self._radix = absorb_radix_bits(F)

    # -- sponge core ---------------------------------------------------
    def _absorb_tagged(self, values, tag: int):
        if len(values) > RATE:
            raise ValueError(f"{len(values)} values for a rate of {RATE}")
        for i, v in enumerate(values):
            self.state[i] = int(v) % PF_P
        for i in range(len(values), RATE):
            self.state[i] = 0
        self.state[RATE] = (self.state[RATE] + tag) % PF_P
        self.state = self.permute(self.state)
        self.output_buffer = list(self.state[:RATE])

    def _flush(self):
        if not self.f_buffer:
            return
        n_in = len(self.f_buffer)
        packed = [
            reduce_packed(
                self.f_buffer[i : i + self._absorb_n], self._radix
            )
            for i in range(0, n_in, self._absorb_n)
        ]
        self._absorb_tagged(packed, n_in)
        self.f_buffer.clear()
        self.f_squeeze_buffer.clear()

    def _refill(self):
        self.f_squeeze_buffer = []
        for pf in self.output_buffer:
            self.f_squeeze_buffer.extend(
                split_pf_limbs(pf, self._squeeze_n, self.F.P)
            )
        self.output_buffer = []

    # -- observation ----------------------------------------------------
    def observe(self, value: int):
        self.output_buffer = []
        self.f_squeeze_buffer = []
        self.f_buffer.append(int(value) % self.F.P)
        if len(self.f_buffer) == self._absorb_n * RATE:
            self._flush()

    def observe_many(self, values):
        for v in values:
            self.observe(int(v))

    def observe_ext(self, ext_tuple):
        for c in ext_tuple:
            self.observe(int(c))

    def observe_digest(self, words):
        """words: PF (BN254) digest words (multi_field_challenger.rs:185).
        A Merkle cap (nested) observes each digest in order."""
        if words and isinstance(words[0], (tuple, list)):
            for d in words:
                self.observe_digest(d)
            return
        self.output_buffer = []
        self.f_squeeze_buffer = []
        self._flush()
        words = list(words)
        for start in range(0, len(words), RATE):
            chunk = words[start : start + RATE]
            self._absorb_tagged(chunk, len(chunk))
            self.f_squeeze_buffer = []

    # -- sampling -------------------------------------------------------
    def sample(self) -> int:
        self._flush()
        if not self.f_squeeze_buffer:
            if not self.output_buffer:
                # duplex on empty state (no pending inputs): zero-block
                # absorb with tag 0, matching DuplexChallenger.duplexing
                self._absorb_tagged([], 0)
            self._refill()
        return self.f_squeeze_buffer.pop()

    def sample_ext(self, D: int) -> tuple:
        return tuple(self.sample() for _ in range(D))

    def sample_bits(self, bits: int) -> int:
        if (1 << bits) >= self.F.P:
            raise ValueError(f"{bits} bits exceed the field")
        return self.sample() & ((1 << bits) - 1)

    def sample_uniform_bits(self, bits: int) -> int:
        return sample_uniform_bits(self, self.F, bits)

    # -- proof of work ----------------------------------------------------
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


class MultiField32Sponge:
    """MultiField32PaddingFreeSponge<F, Bn254, perm, 3, RATE, OUT>
    (symmetric/src/sponge.rs:408): F rows pack into PF rate slots with
    SHIFTED radix packing (each digit + 1, helpers.rs:149), one permute
    per block; digest = state[..OUT] BN254 words."""

    digest_is_field = False
    host_only = True
    perm = None

    def __init__(self, F, rate: int = 2, out: int = 1,
                 permute=poseidon2_bn254_permute):
        if not 0 < out <= rate < WIDTH:
            raise ValueError(f"out {out}, rate {rate} for width {WIDTH}")
        self.F = F
        self.rate = rate
        self.out = out
        self.permute = permute
        self._radix = absorb_radix_bits(F)
        # shifted packing: digits are value+1, max digit = P
        b, max_digit = self._radix, F.P
        k, max_val, power = 0, 0, 1
        while True:
            new_max = max_val + max_digit * power
            if new_max >= PF_P:
                break
            max_val = new_max
            power <<= b
            k += 1
        self.num_f_elms = k

    def _pack_shifted(self, vals) -> int:
        acc = 0
        for v in vals:
            acc = (acc * (1 << self._radix) + int(v) + 1) % PF_P
        return acc

    def hash_iter_host(self, elems):
        elems = [int(x) % self.F.P for x in elems]
        state = [0] * WIDTH
        block = self.rate * self.num_f_elms
        for start in range(0, max(len(elems), 1), block):
            chunk = elems[start : start + block]
            for ci in range(0, len(chunk), self.num_f_elms):
                state[ci // self.num_f_elms] = self._pack_shifted(
                    chunk[ci : ci + self.num_f_elms]
                )
            state = self.permute(state)
        return tuple(state[: self.out])


class MultiFieldCompressor:
    """TruncatedPermutation over BN254 digest words (2-to-1, width 3)."""

    perm = None

    def __init__(self, chunk: int = 1, permute=poseidon2_bn254_permute):
        if 2 * chunk > WIDTH:
            raise ValueError(f"two chunks of {chunk} exceed width {WIDTH}")
        self.chunk = chunk
        self.permute = permute

    def compress_host(self, left, right):
        state = list(left) + list(right)
        state += [0] * (WIDTH - len(state))
        return tuple(self.permute(state)[: self.chunk])
