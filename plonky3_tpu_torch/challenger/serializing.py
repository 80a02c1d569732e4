"""SerializingChallenger32 over HashChallenger<u8, Keccak256, 32>.

Port of `plonky3_tpu/challenger/serializing.py`
(challenger/src/serializing_challenger.rs:25, hash_challenger.rs:10):

  observe(F):   LE bytes of the Montgomery form (monty_31.rs:688)
  observe u64 digests: 8 u32 words as LE bytes; with digest_bytes
                (the circle fixtures' [u8; 32] keccak-256 digests), one
                raw byte a digest word
  flush():      digest = keccak256(input_buffer); the digest becomes the
                new input buffer and the output buffer
  sample byte:  pop from the end of the output buffer
  sample F:     4 popped bytes as a LE u32, masked to 2^ceil(log2 P) - 1,
                rejection-sampled until < P
  sample_bits:  4 popped bytes as a LE u32 & (2^bits - 1)
  grind(bits):  the smallest witness w with sample_bits(bits) == 0 after
                observe(w), searched by `native.keccak256_grind` in C, as
                the reference's (`grind_plain`: the batched numpy
                keccak256, its plain version).
"""

from __future__ import annotations

import numpy as np

from .. import native
from ..hashes.keccak import keccak256, keccak256_np_batch


class SerializingChallenger32:
    def __init__(self, F, digest_bytes: bool = False):
        self.F = F
        self.digest_bytes = digest_bytes
        self.input_buffer = bytearray()
        self.output_buffer = []  # bytes as ints; sampled from the end

    # -- observation ------------------------------------------------------
    def observe(self, value: int):
        """Observe a field element (standard-form int)."""
        m = self.F.to_monty_h(int(value) % self.F.P)
        self.output_buffer.clear()
        self.input_buffer += m.to_bytes(4, "little")

    def observe_many(self, values):
        for v in values:
            self.observe(int(v))

    def observe_ext(self, ext_tuple):
        for c in ext_tuple:
            self.observe(int(c))

    def observe_base_array(self, values_std: np.ndarray):
        """Observe an array of standard-form field elements in row-major
        order (the same bytes as observing them one by one)."""
        v = np.ascontiguousarray(values_std).reshape(-1)
        if v.size == 0:
            return
        self.output_buffer.clear()
        self.input_buffer += self.F.to_monty_np(v).astype("<u4").tobytes()

    def observe_digest(self, values):
        """A digest of 8 u32 words (4 LE u64 lanes) or of 32 bytes
        (digest_bytes), or a Merkle cap (a sequence of digests, observed
        in order)."""
        if values and isinstance(values[0], (tuple, list, bytes)):
            for d in values:
                self.observe_digest(d)
            return
        self.output_buffer.clear()
        if self.digest_bytes:
            self.input_buffer += bytes(int(v) & 0xFF for v in values)
            return
        for v in values:
            self.input_buffer += (int(v) & 0xFFFFFFFF).to_bytes(4, "little")

    # -- sampling -----------------------------------------------------------
    def _flush(self):
        digest = keccak256(bytes(self.input_buffer))
        self.input_buffer = bytearray(digest)
        self.output_buffer = list(digest)

    def _sample_byte(self) -> int:
        if not self.output_buffer:
            self._flush()
        return self.output_buffer.pop()

    def _sample_u32(self) -> int:
        b = [self._sample_byte() for _ in range(4)]
        return b[0] | (b[1] << 8) | (b[2] << 16) | (b[3] << 24)

    def sample(self) -> int:
        bound = (1 << (self.F.P - 1).bit_length()) - 1
        while True:
            v = self._sample_u32() & bound
            if v < self.F.P:
                return v

    def sample_ext(self, D: int) -> tuple:
        return tuple(self.sample() for _ in range(D))

    def sample_bits(self, bits: int) -> int:
        if (1 << bits) >= self.F.P:
            raise ValueError(f"{bits} bits exceed the field")
        return self._sample_u32() & ((1 << bits) - 1)

    # -- proof of work --------------------------------------------------------
    def check_witness(self, bits: int, witness: int) -> bool:
        if bits == 0:
            return True
        self.observe(witness)
        return self.sample_bits(bits) == 0

    def grind(self, bits: int, batch: int = 1 << 17) -> int:
        """Smallest witness; grind(0) returns 0 and touches nothing
        (grinding_challenger.rs). Candidates go in order, `batch` at a
        time, through the C search."""
        if bits == 0:
            return 0
        prefix = bytes(self.input_buffer)
        mask = (1 << bits) - 1
        for start in range(0, self.F.P, batch):
            cands = np.arange(start, min(start + batch, self.F.P),
                              dtype=np.uint32)
            i = native.keccak256_grind(prefix, self.F.to_monty_np(cands),
                                       mask)
            if i >= 0:
                return self._replayed(bits, start + i)
        raise RuntimeError("no grind witness found")

    def _replayed(self, bits: int, w: int) -> int:
        if not self.check_witness(bits, w):
            raise RuntimeError("grind witness failed its replay")
        return w

    def grind_plain(self, bits: int, batch: int = 1 << 16) -> int:
        """`grind` by the batched numpy keccak256."""
        if bits == 0:
            return 0
        prefix = bytes(self.input_buffer)
        mask = np.uint32((1 << bits) - 1)
        # a batch of 16·2^bits candidates holds a witness but for e^-16 of
        # the time; the scan goes in order, so the witness is the smallest
        batch = min(batch, 1 << (bits + 4))
        start = 0
        while start < self.F.P:
            n = min(batch, self.F.P - start)
            cands = np.arange(start, start + n, dtype=np.uint32)
            digests = keccak256_np_batch(prefix, self.F.to_monty_np(cands))
            # sample_bits reads bytes 31, 30, 29, 28 of the digest
            v = (digests[:, 31].astype(np.uint32)
                 | (digests[:, 30].astype(np.uint32) << 8)
                 | (digests[:, 29].astype(np.uint32) << 16)
                 | (digests[:, 28].astype(np.uint32) << 24))
            hits = np.nonzero((v & mask) == 0)[0]
            if hits.size:
                return self._replayed(bits, int(start + hits[0]))
            start += n
        raise RuntimeError("no grind witness found")
