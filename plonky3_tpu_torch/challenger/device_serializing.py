"""SerializingChallenger32 with its state on the device.

Port of `plonky3_tpu/challenger/device_serializing.py`: the keccak-256
Fiat-Shamir transcript of `serializing.py` (challenger/src/
serializing_challenger.rs:25, hash_challenger.rs:10), byte for byte, with
observes, flushes and samples as tensor work on the device of its tensors.
Every challenge (alpha, zeta, the FRI betas, the proof-of-work witnesses,
the query indices) stays on the device and feeds the next kernel; nothing
here copies a tensor to the host.

State between transcript touches is the host challenger's:

  digest   (8,) int32 words, the last flush digest (the input buffer's
           prefix); None before the first flush
  pending  int32 word tensors observed since (all observes are u32 words:
           Montgomery-form field elements and digest words)
  flags    0-d bool tensors that must all be true for the transcript to
           be valid (enough supply for the rejection sampling, the PoW
           replay)

A sample computes a chain of flush digests d1 = keccak256(input),
d_{i+1} = keccak256(d_i) up front with one `keccak256_chain` launch
(rejection sampling consumes a data-dependent count, so the chain has
spare digests), then replays the pop-from-the-end byte order over that
supply with device indices. A grind is one `keccak_grind` launch; the
witness stays on the device and the following chain reads it. On a CPU
tensor both run their plain PyTorch versions.

As in the reference, a sample leaves the transcript at the digest of the
last supply word it used and drops the unused bytes: exact because every
sample of the protocol is followed by an observe, which clears them.
"""

from __future__ import annotations

import numpy as np
import torch

from ..hashes.keccak_cuda import (
    bswap32,
    keccak256_chain,
    keccak_grind,
)

_M32 = 0xFFFFFFFF


def _supply(digests):
    """(k, 8) int32 digests -> int64 u32 values in pop-from-the-end order:
    the j-th popped u32 of a digest is the byte swap of its word 7 - j."""
    return bswap32(digests.to(torch.int64).flip(1) & _M32).reshape(-1)


def _rejection_sample(F, values, num: int):
    """The first `num` of `values` masked to 2^ceil(log2 P) - 1 that fall
    below P, with their positions and whether there were enough."""
    bound = (1 << (F.P - 1).bit_length()) - 1
    v = values & bound
    cs = torch.cumsum((v < F.P).to(torch.int64), 0)
    want = torch.arange(1, num + 1, dtype=torch.int64, device=v.device)
    # cs rises by 0 or 1: the first position where it reaches j + 1 is
    # the j-th accepted value
    pos = torch.searchsorted(cs, want).clamp(max=v.shape[0] - 1)
    return v.index_select(0, pos), pos, cs[-1] >= num


class DeviceSerializingChallenger32:
    """The keccak transcript of the u32-word configs on `device`.

    Samples return Montgomery-form int64 tensors (ready for the field
    code); witnesses and indices are int64 tensors in standard form."""

    def __init__(self, F, device):
        self.F = F
        self.device = torch.device(device)
        self.digest = None
        self.pending = []
        self.flags = []

    # -- observation ------------------------------------------------------
    def observe_words(self, words):
        """Raw wire words (an int tensor of u32 values, any shape, read in
        row-major order): Montgomery-form field elements or digest words."""
        w = words.reshape(-1).to(torch.int32)
        if w.numel():
            self.pending.append(w)

    def observe_host_ints(self, values_std):
        """Standard-form host ints, observed in Montgomery form like the
        host challenger's observe."""
        if not values_std:
            return
        m = self.F.to_monty_np(np.asarray(values_std, dtype=np.uint64))
        self.pending.append(torch.from_numpy(m.astype(np.int32)).to(
            self.device))

    # -- sampling -----------------------------------------------------------
    def _input_words(self):
        parts = ([self.digest] if self.digest is not None else [])
        parts += self.pending
        if not parts:
            raise ValueError("the transcript must observe before sampling")
        return parts[0] if len(parts) == 1 else torch.cat(parts)

    def _advance(self, digests, last_word):
        """Leave the transcript at the digest holding supply word
        `last_word` (an int or a 0-d device tensor)."""
        if isinstance(last_word, int):
            self.digest = digests[last_word // 8]
        else:
            self.digest = digests.index_select(
                0, (last_word // 8).reshape(1)).reshape(-1)
        self.pending = []

    def _grind(self, inp, pow_bits: int):
        """(witness (1,) int64, the input with its Montgomery form appended,
        the witness's own validity flag)."""
        if pow_bits <= 0:
            raise ValueError("a grind needs pow_bits > 0")
        w = keccak_grind(inp, pow_bits, self.F.P).to(torch.int64) & _M32
        wm = self.F.to_monty_tensor(w.clamp(max=self.F.P - 1))
        return w, torch.cat([inp, wm.to(torch.int32)]), w[0] < self.F.P

    def sample_fields_m(self, num: int):
        """`num` rejection-sampled field elements as a (num,) Montgomery
        tensor (one extension element for num == D)."""
        k = (num + 4 + 7) // 8 + 1  # at least 12 spare u32s
        digs = keccak256_chain(self._input_words(), k)
        vals, pos, ok = _rejection_sample(self.F, _supply(digs), num)
        self._advance(digs, pos[num - 1])
        self.flags.append(ok)
        return self.F.to_monty_tensor(vals)

    def _sample_bits(self, inp, bits: int, num: int, skip: int = 0):
        """`num` u32s of the supply of `inp` after its first `skip`,
        masked to `bits` bits. Returns (the supply, (num,) int64)."""
        digs = keccak256_chain(inp, (skip + num + 7) // 8)
        sup = _supply(digs)
        self._advance(digs, skip + num - 1)
        return sup, sup[skip:skip + num] & ((1 << bits) - 1)

    def sample_bits_array(self, bits: int, num: int):
        """`num` u32s masked to `bits` bits (query indices): (num,) int64."""
        return self._sample_bits(self._input_words(), bits, num)[1]

    def grind_then_sample_fields(self, pow_bits: int, num: int):
        """grind(pow_bits), then `num` field samples (a FRI round's commit
        PoW and beta). Returns (witness (1,) int64, (num,) Montgomery)."""
        w, inp, w_ok = self._grind(self._input_words(), pow_bits)
        digs = keccak256_chain(inp, (1 + num + 4 + 7) // 8 + 1)
        sup = _supply(digs)
        pow_ok = (sup[0] & ((1 << pow_bits) - 1)) == 0
        vals, pos, ok = _rejection_sample(self.F, sup[1:], num)
        self._advance(digs, pos[num - 1] + 1)
        self.flags.append(w_ok & pow_ok & ok)
        return w, self.F.to_monty_tensor(vals)

    def grind_and_sample_indices(self, pow_bits: int, n_idx: int,
                                 idx_bits: int):
        """grind(pow_bits), then `n_idx` samples of `idx_bits` bits.
        Returns (witness (1,) int64, indices (n_idx,) int64). grind(0) is
        witness 0 and leaves the transcript as it was, as on the host."""
        if pow_bits == 0:
            return (torch.zeros((1,), dtype=torch.int64, device=self.device),
                    self.sample_bits_array(idx_bits, n_idx))
        w, inp, w_ok = self._grind(self._input_words(), pow_bits)
        sup, indices = self._sample_bits(inp, idx_bits, n_idx, skip=1)
        pow_ok = (sup[0] & ((1 << pow_bits) - 1)) == 0
        self.flags.append(w_ok & pow_ok)
        return w, indices
