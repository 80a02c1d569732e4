"""The port's device transcript against the reference's host transcript.

plonky3_tpu_torch's DeviceSerializingChallenger32, run on the CPU (its
keccak kernels take their plain PyTorch versions there), must sample what
plonky3_tpu's host SerializingChallenger32 samples on the same observe and
sample script, word for word (the script of tests/test_device_fs.py). The
plain versions of the two transcript kernels are held against the host
keccak-256 at the padding's edge lengths and against the host grind.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from plonky3_tpu.challenger.serializing import SerializingChallenger32
from plonky3_tpu.fields import KoalaBearExt4 as JE
from plonky3_tpu.fields.params import KoalaBear as JF
from plonky3_tpu.fri.prover import fold_step_np
from plonky3_tpu_torch.challenger.device_serializing import (
    DeviceSerializingChallenger32,
)
from plonky3_tpu_torch.fields import KoalaBear as F
from plonky3_tpu_torch.fields import KoalaBearExt4 as E
from plonky3_tpu_torch.fri.prover import fold_step, fold_step_device
from plonky3_tpu_torch.hashes import keccak_cuda as kc
from plonky3_tpu_torch.hashes.keccak import keccak256


def _std(t):
    """A Montgomery-form tensor -> standard-form Python ints."""
    return [int(x) for x in F.from_monty_tensor(t)]


def _pair():
    return SerializingChallenger32(JF), DeviceSerializingChallenger32(F, "cpu")


def _t(words):
    return torch.from_numpy(np.asarray(words, dtype=np.uint32)
                            .astype(np.int64))


def test_sample_fields_lockstep():
    host, dev = _pair()
    rng = np.random.default_rng(7)

    # scalar observes and a digest, then an extension sample
    ints = [17, 17, 0]
    digest = tuple(int(x) for x in rng.integers(0, 2**32, 8))
    host.observe_many(ints)
    host.observe_digest(digest)
    dev.observe_host_ints(ints)
    dev.observe_words(_t(digest))
    assert list(host.sample_ext(4)) == _std(dev.sample_fields_m(4))

    # a 1,200-word observe (the ys pattern), then a sample
    ys = rng.integers(0, JF.P, 1200, dtype=np.uint64).astype(np.uint32)
    host.observe_base_array(ys)
    dev.observe_words(_t(JF.to_monty_np(ys)))
    assert list(host.sample_ext(4)) == _std(dev.sample_fields_m(4))

    # an observe, then raw bit samples
    host.observe(5)
    dev.observe_host_ints([5])
    bits_h = [host.sample_bits(18) for _ in range(25)]
    assert bits_h == [int(x) for x in dev.sample_bits_array(18, 25)]
    assert all(bool(f) for f in dev.flags)


def test_many_single_samples_lockstep():
    """Rejection sampling across flush boundaries: 40 samples at once walk
    the digest chain as the host's 40 single samples do."""
    host, dev = _pair()
    host.observe(123)
    dev.observe_host_ints([123])
    want = [host.sample() for _ in range(40)]
    assert want == _std(dev.sample_fields_m(40))
    assert all(bool(f) for f in dev.flags)


def _aligned_pair():
    """Both transcripts after a seed, one sample and four observes."""
    host, dev = _pair()
    seed = [9, 9, 3]
    host.observe_many(seed)
    dev.observe_host_ints(seed)
    host.sample_ext(4)
    dev.sample_fields_m(4)
    coeffs = [4, 8, 15, 16]
    host.observe_many(coeffs)
    dev.observe_host_ints(coeffs)
    return host, dev


def _still_aligned(host, dev):
    host.observe(1)
    dev.observe_host_ints([1])
    assert list(host.sample_ext(4)) == _std(dev.sample_fields_m(4))
    assert all(bool(f) for f in dev.flags)


@pytest.mark.parametrize("pow_bits", [0, 6, 11])
def test_grind_and_indices_lockstep(pow_bits):
    host, dev = _aligned_pair()
    w_h = host.grind(pow_bits)
    idx_h = [host.sample_bits(18) for _ in range(30)]
    w_d, idx_d = dev.grind_and_sample_indices(pow_bits, 30, 18)
    assert int(w_d[0]) == w_h
    assert [int(x) for x in idx_d] == idx_h
    _still_aligned(host, dev)


def test_grind_then_sample_fields_lockstep():
    host, dev = _aligned_pair()
    w_h = host.grind(4)
    beta_h = host.sample_ext(4)
    w_d, beta_d = dev.grind_then_sample_fields(4, 4)
    assert int(w_d[0]) == w_h
    assert list(beta_h) == _std(beta_d)
    _still_aligned(host, dev)


@pytest.mark.parametrize("n", [0, 1, 8, 33, 34, 35, 67, 68, 69, 150])
def test_chain_plain_matches_host_keccak256(n):
    """n = 33 (mod 34): both pads in one word; n = 34, 68: the padding
    takes a fresh block."""
    words = np.random.default_rng(n).integers(0, 2**32, n, dtype=np.uint64)
    d = keccak256(words.astype("<u4").tobytes())
    want = [d]
    for _ in range(2):
        d = keccak256(d)
        want.append(d)
    got = kc.keccak256_chain_plain(_t(words).to(torch.int32), 3)
    assert got.dtype == torch.int32 and got.shape == (3, 8)
    assert got.numpy().astype("<u4").tobytes() == b"".join(want)
    assert torch.equal(kc.keccak256_chain(_t(words).to(torch.int32), 3), got)


@pytest.mark.parametrize("m,pow_bits", [(18, 1), (18, 8), (33, 1), (33, 6),
                                        (40, 2), (40, 7)])
def test_grind_plain_matches_host_grind(m, pow_bits):
    """18 words: the benchmark's message (digest, final poly, arities);
    33: the witness ends a block, so the padding takes a fresh one; 40: a
    block before the witness. pow_bits 1 and 2: several candidates of the
    first window pass, and the smallest must be returned."""
    words = np.random.default_rng(m + pow_bits).integers(
        0, 2**32, m, dtype=np.uint64)
    host = SerializingChallenger32(JF)
    host.observe_digest(tuple(int(x) for x in words))
    got = kc.keccak_grind(_t(words).to(torch.int32), pow_bits, F.P)
    assert got.dtype == torch.int32 and got.shape == (1,)
    assert int(got[0]) == host.grind(pow_bits)


def test_monty_tensor_forms_match_reference():
    x = np.random.default_rng(2).integers(0, JF.P, 500, dtype=np.uint64)
    x = np.concatenate([x, [0, 1, JF.P - 1]]).astype(np.uint32)
    to_m = F.to_monty_tensor(_t(x))
    assert np.array_equal(to_m.numpy(), np.asarray(JF.to_monty(jnp.asarray(x))))
    assert np.array_equal(F.from_monty_tensor(to_m).numpy(), x)
    assert np.array_equal(F.from_monty_tensor(_t(x)).numpy(),
                          np.asarray(JF.from_monty(jnp.asarray(x))))


@pytest.mark.parametrize("log_h", [1, 5])
def test_fold_step_device_matches_host_beta(log_h):
    rng = np.random.default_rng(log_h)
    folded = JF.rand_np(rng, (1 << log_h, 4))
    beta = JE.rand_h(rng)
    t = torch.from_numpy(folded.astype(np.int64))
    got = fold_step_device(E, t, E.const(beta, "cpu"))
    assert torch.equal(got, fold_step(E, t, beta))
    assert np.array_equal(got.numpy(), fold_step_np(JE, folded, beta))
