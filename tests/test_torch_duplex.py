"""The port's Poseidon2 duplex transcript against the reference's.

plonky3_tpu_torch's width-16 and width-24 permutations (Montgomery tensors
and standard-form numpy) against plonky3_tpu's; the plain versions of the
two transcript kernels (`poseidon2_duplex_chain`, `poseidon2_grind`)
against the reference's host DuplexChallenger state machine; and the
port's host `DuplexChallenger` and device `DeviceDuplexChallenger` (on
the CPU, so with the kernels' plain versions) in lockstep with the
reference's host `DuplexChallenger` over one script of observes, samples
and grinds.
"""

import numpy as np
import pytest
import torch

from plonky3_tpu.challenger.duplex import DuplexChallenger as JDuplex
from plonky3_tpu.fields.params import KoalaBear as JF
from plonky3_tpu.hashes.poseidon2 import default_poseidon2 as j_poseidon2
from plonky3_tpu_torch.challenger.device_duplex import DeviceDuplexChallenger
from plonky3_tpu_torch.challenger.duplex import DuplexChallenger
from plonky3_tpu_torch.fields import KoalaBear as F
from plonky3_tpu_torch.hashes import poseidon2_cuda as pc
from plonky3_tpu_torch.hashes.poseidon2 import default_poseidon2

PERM24 = default_poseidon2(F, 24)


def _t(words):
    """uint32 numpy words -> an int32 tensor of the same u32 values."""
    return torch.from_numpy(np.asarray(words, dtype=np.uint32)
                            .astype(np.int64)).to(torch.int32)


@pytest.mark.parametrize("width", [16, 24])
def test_permutations_match_reference(width):
    x = JF.rand_np(np.random.default_rng(width), (20, width))
    ref = j_poseidon2(JF, width)
    perm = default_poseidon2(F, width)
    want = ref.permute_np(x)
    got = perm.permute(torch.from_numpy(x.astype(np.int64)))
    assert np.array_equal(got.numpy(), want)
    std = JF.from_monty_np(x)
    got_np = perm.permute_np(std)
    assert np.array_equal(got_np, JF.from_monty_np(want))
    assert got_np[0].tolist() == ref.permute_host_py(std[0].tolist())


def test_unported_widths_raise():
    with pytest.raises(NotImplementedError):
        default_poseidon2(F, 8)


def _reference_absorb(state_std, words_std):
    """The state the reference's host challenger reaches from `state_std`
    after observing `words_std` and duplexing what is left queued (a bare
    permutation when nothing is)."""
    ch = JDuplex(j_poseidon2(JF, 24), rate=16)
    ch.state = list(state_std)
    ch.observe_many(words_std)
    if ch.input_buffer or not words_std:
        ch._duplexing()
    return ch.state


@pytest.mark.parametrize("n", [0, 1, 15, 16, 17, 48, 100])
def test_duplex_chain_plain_matches_reference(n):
    rng = np.random.default_rng(n)
    state, words = JF.rand_np(rng, 24), JF.rand_np(rng, n)
    got = pc.poseidon2_duplex_chain(PERM24, _t(state), _t(words))
    want = _reference_absorb(JF.from_monty_np(state).tolist(),
                             JF.from_monty_np(words).tolist())
    assert JF.from_monty_np(got.numpy().astype(np.uint32)).tolist() == want


@pytest.mark.parametrize("k,bits", [(0, 1), (3, 6), (15, 9)])
def test_grind_plain_matches_reference(k, bits):
    """The port's host grind (`poseidon2_grind` on the CPU) finds the
    reference's witness with k inputs queued, and both transcripts stay
    aligned after it."""
    rng = np.random.default_rng(k)
    queued = JF.from_monty_np(JF.rand_np(rng, 16 + k)).tolist()
    host, ours = JDuplex(j_poseidon2(JF, 24), rate=16), DuplexChallenger(
        PERM24)
    for ch in (host, ours):
        ch.observe_many(queued)
    assert ours.grind(bits) == host.grind(bits)
    assert ours.sample_ext(4) == host.sample_ext(4)


class _Host:
    """The script's operations on a host challenger (standard form)."""

    def __init__(self, ch):
        self.ch = ch

    def observe(self, values):
        self.ch.observe_many(values)

    def observe_array(self, values):
        self.ch.observe_base_array(values)

    def fields(self, num):
        return [self.ch.sample() for _ in range(num)]

    def bits(self, bits, num):
        return [self.ch.sample_bits(bits) for _ in range(num)]

    def grind_indices(self, pow_bits, num, bits):
        return self.ch.grind(pow_bits), self.bits(bits, num)

    def grind_fields(self, pow_bits, num):
        return self.ch.grind(pow_bits), self.fields(num)


class _Device:
    """The script's operations on the device transcript."""

    def __init__(self, ch):
        self.ch = ch

    def observe(self, values):
        self.ch.observe_host_ints(list(values))

    def observe_array(self, values):
        self.ch.observe_words(F.to_monty_tensor(torch.from_numpy(
            np.asarray(values, dtype=np.int64))))

    def fields(self, num):
        return F.from_monty_tensor(self.ch.sample_fields_m(num)).tolist()

    def bits(self, bits, num):
        return self.ch.sample_bits_array(bits, num).tolist()

    def grind_indices(self, pow_bits, num, bits):
        w, idx = self.ch.grind_and_sample_indices(pow_bits, num, bits)
        return int(w[0]), idx.tolist()

    def grind_fields(self, pow_bits, num):
        w, vals = self.ch.grind_then_sample_fields(pow_bits, num)
        return int(w[0]), F.from_monty_tensor(vals).tolist()


def _script(t):
    """Observes and samples in the prover's patterns; returns every
    sample."""
    rng = np.random.default_rng(11)

    def words(n):
        return JF.from_monty_np(JF.rand_np(rng, n))

    out = []
    t.observe([6, 6, 0])  # a partial block: 3 ints and a digest
    t.observe(words(8).tolist())
    out.append(t.fields(4))
    t.observe_array(words(1203))  # full blocks, then a partial one
    out.append(t.fields(4))
    t.observe_array(words(48))  # a 3-block absorb: the sample pops its
    out.append(t.fields(20))  # outputs, then a bare permutation
    t.observe([5])
    out.append(t.bits(18, 40))  # across re-duplexes
    t.observe(words(8).tolist())
    out.append(t.grind_fields(5, 4))  # a FRI round's commit PoW and beta
    t.observe(words(35).tolist())  # two full blocks queue before the grind
    out.append(t.grind_indices(7, 30, 12))
    t.observe(words(4).tolist())
    out.append(t.grind_indices(0, 3, 9))  # grind(0) touches nothing
    out.append(t.fields(4))
    return out


def test_transcripts_in_lockstep_with_reference():
    want = _script(_Host(JDuplex(j_poseidon2(JF, 24), rate=16)))
    assert _script(_Host(DuplexChallenger(PERM24))) == want
    dev = DeviceDuplexChallenger(F, PERM24, "cpu")
    assert _script(_Device(dev)) == want
    assert dev.flags and all(bool(f) for f in dev.flags)


@pytest.mark.parametrize("make", [
    lambda perm: DuplexChallenger(perm),
    lambda perm: DeviceDuplexChallenger(F, perm, "cpu"),
], ids=["host", "device"])
def test_transcripts_take_only_the_width_24_permutation(make):
    """The chain and grind kernels fix width 24 and rate 16."""
    with pytest.raises(ValueError, match="width-24"):
        make(default_poseidon2(F, 16))
