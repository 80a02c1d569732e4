"""DuplexChallenger with its state on the device.

Port of `plonky3_tpu/challenger/device_duplex.py`: the Poseidon2 duplex
transcript of `duplex.py` (challenger/src/duplex_challenger.rs:33) as
tensor work on the device of its tensors, so every challenge (alpha,
zeta, alpha2, the FRI betas, the proof-of-work witnesses, the query
indices) feeds the next kernel there; nothing here copies a tensor to the
host.

The state is a (24,) int32 tensor of Montgomery words. Observed words
queue up (`pending`) until a sample or a grind needs the state; then one
`poseidon2_duplex_chain` launch absorbs them all: the full rate blocks the
host transcript duplexes as they arrive, and the partial block it
duplexes at the sample, which is the same sequence of duplexings. A
sample with nothing queued and no outputs left is a bare permutation, one
launch with no words. The outputs are the state's rate lanes, popped from
the end; a duplex sample is a field element, so there is no rejection
sampling, and bit samples take the low bits of the standard form. A grind
is one `poseidon2_grind` launch on the staged state; the witness stays on
the device and is replayed through the state machine as the host does,
its check kept in `flags`. On a CPU tensor both kernels run their plain
PyTorch versions.
"""

from __future__ import annotations

import numpy as np
import torch

from ..hashes.poseidon2_cuda import (
    RATE, WIDTH, poseidon2_duplex_chain, poseidon2_grind)


class DeviceDuplexChallenger:
    """The duplex transcript of the Poseidon2 config on `device`.

    Samples return Montgomery-form int64 tensors (ready for the field
    code); witnesses and indices are int64 tensors in standard form."""

    def __init__(self, F, perm, device):
        if perm.width != WIDTH:
            raise ValueError(f"the duplex transcript takes a width-{WIDTH} "
                             f"permutation, not {perm.width}")
        self.F = F
        self.perm = perm
        self.device = torch.device(device)
        self.state = torch.zeros((WIDTH,), dtype=torch.int32,
                                 device=self.device)
        self.pending = []  # int32 Montgomery words observed since a duplexing
        self.n_pending = 0
        self.n_out = 0  # outputs left: state[:n_out], popped from the end
        self.flags = []  # 0-d bool tensors that must all be true

    # -- observation ------------------------------------------------------
    def observe_words(self, words):
        """Montgomery-form field elements (any shape, row-major order)."""
        w = words.reshape(-1).to(torch.int32)
        if w.numel():
            self.pending.append(w)
            self.n_pending += w.numel()
            self.n_out = 0

    def observe_host_ints(self, values_std):
        """Standard-form host ints."""
        if not values_std:
            return
        m = self.F.to_monty_np(np.asarray(values_std, dtype=np.uint64))
        self.observe_words(torch.from_numpy(m.astype(np.int32)).to(
            self.device))

    # -- duplexing (duplex_challenger.rs:92-117) --------------------------
    def _absorb(self, n_words):
        """Absorb the first `n_words` pending words (a bare permutation for
        none) in one chain launch; the rest stay pending."""
        words = (torch.cat(self.pending) if self.pending else
                 torch.zeros((0,), dtype=torch.int32, device=self.device))
        self.state = poseidon2_duplex_chain(self.perm, self.state,
                                            words[:n_words])
        rest = words[n_words:]
        self.pending = [rest] if rest.numel() else []
        self.n_pending -= n_words
        self.n_out = RATE

    def _pop(self, num: int):
        """The next `num` outputs, Montgomery form, as (num,) int64."""
        out = []
        while num:
            if self.n_pending or not self.n_out:
                self._absorb(self.n_pending)
            take = min(num, self.n_out)
            out.append(self.state[self.n_out - take:self.n_out].flip(0))
            self.n_out -= take
            num -= take
        return torch.cat(out).to(torch.int64)

    # -- sampling -----------------------------------------------------------
    def sample_fields_m(self, num: int):
        """`num` field elements as a (num,) Montgomery tensor."""
        return self._pop(num)

    def sample_bits_array(self, bits: int, num: int):
        """`num` samples masked to `bits` bits: (num,) int64."""
        return self.F.from_monty_tensor(self._pop(num)) & ((1 << bits) - 1)

    # -- proof of work ------------------------------------------------------
    def _grind(self, pow_bits: int):
        """Search and replay the witness (grinding_challenger.rs:33): the
        full blocks queued are absorbed, the k words left stay in lanes
        0..k-1 of the staged state, the witness goes to lane k. Returns the
        witness as a (1,) int64 tensor in standard form."""
        if pow_bits <= 0:
            raise ValueError("a grind needs pow_bits > 0")
        F = self.F
        k = self.n_pending % RATE
        if self.n_pending - k:
            self._absorb(self.n_pending - k)
        base = self.state.to(torch.int64)
        lanes = [torch.cat(self.pending).to(torch.int64)] if k else []
        lanes.append(torch.zeros((RATE - k,), dtype=torch.int64,
                                 device=self.device))
        tag = F.add(base[RATE:RATE + 1], F.to_monty_h(k + 1))
        base = torch.cat(lanes + [tag, base[RATE + 1:]])
        w = poseidon2_grind(self.perm, base.to(torch.int32), k,
                            pow_bits).to(torch.int64)
        found = w[0] >= 0
        self.observe_words(F.to_monty_tensor(w.clamp(min=0)))
        check = self.sample_bits_array(pow_bits, 1)[0] == 0
        self.flags.append(found & check)
        return w

    def grind_then_sample_fields(self, pow_bits: int, num: int):
        """grind(pow_bits), then `num` field samples (a FRI round's commit
        PoW and beta). Returns (witness (1,) int64, (num,) Montgomery)."""
        w = self._grind(pow_bits)
        return w, self.sample_fields_m(num)

    def grind_and_sample_indices(self, pow_bits: int, n_idx: int,
                                 idx_bits: int):
        """grind(pow_bits), then `n_idx` samples of `idx_bits` bits.
        Returns (witness (1,) int64, indices (n_idx,) int64). grind(0) is
        witness 0 and leaves the transcript as it was, as on the host."""
        if pow_bits == 0:
            w = torch.zeros((1,), dtype=torch.int64, device=self.device)
        else:
            w = self._grind(pow_bits)
        return w, self.sample_bits_array(idx_bits, n_idx)
