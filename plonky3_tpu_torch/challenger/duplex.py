"""DuplexChallenger: the Poseidon2 duplex-sponge Fiat-Shamir transcript on
the host.

Port of `plonky3_tpu/challenger/duplex.py` (challenger/src/
duplex_challenger.rs:33), the transcript of the Poseidon2 config
(DuplexChallenger<F, Perm24, 24, 16>), on standard-form Python ints:

  observe:      clear the output buffer, queue the input; duplex when RATE
                inputs are queued
  duplexing:    overwrite state[0..k] with the k queued inputs; when k > 0
                zero the other rate lanes and add the length tag k to
                state[RATE] (:92-117); permute; the output buffer is
                state[..RATE], popped from the end
  sample:       duplex if inputs are queued or the outputs are spent; pop
  sample_bits:  the low `bits` bits of a sample (:278-284)
  sample_uniform_bits: the unbiased sampler with rejection (:378)
  grind(bits):  the smallest witness w with sample_bits(bits) == 0 after
                observe(w) (grinding_challenger.rs:33), searched by
                `poseidon2_grind` on the challenger's device

An explicit `rate` takes another width (the golden fixtures'
DuplexChallenger<BabyBear, Perm16, 16, 8>, `compat/fixture_configs.py`);
the grind kernel fixes width 24 and rate 16, so such a transcript grinds
on the host, as the reference's does.

The permutation is the C one of `native/` (`Poseidon2.permute_host`), and
`observe_base_array` absorbs its full rate blocks in one C call
(`native.poseidon2_duplex_chain`), as the reference's do. The prover's
`prove()` and the verifier use this class; the fast prover uses
`device_duplex.DeviceDuplexChallenger`, which samples the same values.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import native
from ..hashes.poseidon2_cuda import RATE, WIDTH, poseidon2_grind
from .hash_challenger import sample_uniform_bits


class DuplexChallenger:
    def __init__(self, perm, device="cpu", rate=None):
        if rate is None:
            if perm.width != WIDTH:
                raise ValueError(f"the duplex transcript takes a width-"
                                 f"{WIDTH} permutation, not {perm.width}")
            rate = RATE
        if not 0 < rate < perm.width:
            raise ValueError(f"a rate of {rate} for width {perm.width}")
        self.perm = perm
        self.rate = rate
        self.device = torch.device(device)  # where `grind` searches
        self.state = [0] * perm.width
        self.input_buffer: list[int] = []
        self.output_buffer: list[int] = []

    def _duplexing(self):
        k = len(self.input_buffer)
        self.state[:k] = self.input_buffer
        self.input_buffer = []
        if k:
            self.state[k:self.rate] = [0] * (self.rate - k)
            self.state[self.rate] = ((self.state[self.rate] + k)
                                     % self.perm.F.P)
        self.state = self.perm.permute_host(self.state)
        self.output_buffer = self.state[:self.rate]

    # -- observation ------------------------------------------------------
    def observe(self, value: int):
        self.output_buffer = []
        self.input_buffer.append(int(value) % self.perm.F.P)
        if len(self.input_buffer) == self.rate:
            self._duplexing()

    def observe_many(self, values):
        for v in values:
            self.observe(int(v))

    def observe_ext(self, ext_tuple):
        self.observe_many(ext_tuple)

    def observe_base_array(self, values_std: np.ndarray):
        """Standard-form elements in row-major order (the same transcript
        as observing them one by one). The full rate blocks after the
        queued inputs absorb in one C call, where the permutation has one
        (the reference's `observe_base_array`); the head and the tail go
        one by one. A permutation without a C chain (Goldilocks, whose
        words do not fit in 32 bits) observes them all one by one."""
        args = getattr(self.perm, "native_args", None)
        if args is None:
            self.observe_many(np.asarray(values_std).reshape(-1).tolist())
            return
        F = self.perm.F
        v = (np.asarray(values_std).reshape(-1).astype(np.uint64)
             % np.uint64(F.P)).astype(np.uint32)
        head = min(v.size, (self.rate - len(self.input_buffer)) % self.rate)
        nblocks = (v.size - head) // self.rate
        if nblocks == 0:
            self.observe_many(v.tolist())
            return
        self.observe_many(v[:head].tolist())
        P, width, d, *tables = args
        end = head + nblocks * self.rate
        st = native.poseidon2_duplex_chain(
            np.asarray(self.state, dtype=np.uint32),
            v[head:end].reshape(nblocks, self.rate), P, width, self.rate, d,
            *tables)
        self.state = st.tolist()
        self.input_buffer = []
        self.output_buffer = self.state[:self.rate]
        self.observe_many(v[end:].tolist())

    def observe_digest(self, values):
        """A field digest, or a Merkle cap (a sequence of digests, observed
        in order; duplex_challenger.rs:221)."""
        if values and isinstance(values[0], (tuple, list)):
            for d in values:
                self.observe_many(d)
        else:
            self.observe_many(values)

    # -- sampling -----------------------------------------------------------
    def sample(self) -> int:
        if self.input_buffer or not self.output_buffer:
            self._duplexing()
        return self.output_buffer.pop()

    def sample_ext(self, D: int) -> tuple:
        return tuple(self.sample() for _ in range(D))

    def sample_bits(self, bits: int) -> int:
        if (1 << bits) >= self.perm.F.P:
            raise ValueError(f"{bits} bits exceed the field")
        return self.sample() & ((1 << bits) - 1)

    def sample_uniform_bits(self, bits: int) -> int:
        return sample_uniform_bits(self, self.perm.F, bits)

    # -- proof of work --------------------------------------------------------
    def check_witness(self, bits: int, witness: int) -> bool:
        if bits == 0:
            return True
        self.observe(witness)
        return self.sample_bits(bits) == 0

    def grind(self, bits: int) -> int:
        """The smallest witness; grind(0) returns 0 and touches nothing.
        observe(w) queues w after the k queued inputs, and sample_bits then
        duplexes k + 1 inputs: the search permutes that staged state with
        every candidate in lane k."""
        if bits == 0:
            return 0
        F, rate = self.perm.F, self.rate
        k = len(self.input_buffer)
        base = list(self.state)
        base[:k] = self.input_buffer
        base[k + 1:rate] = [0] * (rate - k - 1)
        base[rate] = (base[rate] + k + 1) % F.P
        if (self.perm.width, rate) == (WIDTH, RATE):
            base_m = torch.from_numpy(F.to_monty_np(np.asarray(
                base, dtype=np.uint64)).astype(np.int32)).to(self.device)
            w = int(poseidon2_grind(self.perm, base_m, k, bits)[0])
        else:
            w = self._grind_host(base, k, bits)
        if w < 0 or not self.check_witness(bits, w):
            raise RuntimeError("grind witness failed its replay")
        return w

    def _grind_host(self, base, k, bits, batch=1 << 12):
        """The smallest witness by the numpy permutation, `batch`
        candidates at a time: the staged state with the candidate in
        lane k, whose last output lane's low bits must be zero."""
        mask = (1 << bits) - 1
        for start in range(0, self.perm.F.P, batch):
            cand = np.arange(start, min(start + batch, self.perm.F.P))
            states = np.tile(np.asarray(base, dtype=np.int64),
                             (cand.shape[0], 1))
            states[:, k] = cand
            out = self.perm.permute_np(states)[:, self.rate - 1]
            hit = np.nonzero((out & mask) == 0)[0]
            if hit.size:
                return int(cand[hit[0]])
        return -1
