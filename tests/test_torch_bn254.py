"""BN254 (M20's second half): the field, Poseidon2-BN254, and the
MultiField32Challenger and HashChallenger transcripts of the port against
the JAX package's (plonky3_tpu/fields/bn254.py, hashes/poseidon2_bn254.py,
challenger/multi_field.py, challenger/hash_challenger.py), value for
value. All of it is host code in exact ints, as in the reference."""

import numpy as np
import pytest

from plonky3_tpu.challenger import hash_challenger as jhc
from plonky3_tpu.challenger import multi_field as jmf
from plonky3_tpu.fields import bn254 as jbn
from plonky3_tpu.fields.params import BabyBear as JBabyBear
from plonky3_tpu.fields.params import KoalaBear as JKoalaBear
from plonky3_tpu.gl.field import GLF as JGLF
from plonky3_tpu.gl.merkle import GLPoseidonSponge as JGLSponge
from plonky3_tpu.hashes import poseidon2_bn254 as jp2
from plonky3_tpu_torch.challenger import hash_challenger as hc
from plonky3_tpu_torch.challenger import multi_field as mf
from plonky3_tpu_torch.fields import BabyBear, KoalaBear
from plonky3_tpu_torch.fields import bn254 as bn
from plonky3_tpu_torch.gl.field import GLF
from plonky3_tpu_torch.gl.merkle import GLPoseidonSponge
from plonky3_tpu_torch.hashes import poseidon2_bn254 as p2

P = bn.BN254.P
FIELDS = {"koala": (KoalaBear, JKoalaBear), "baby": (BabyBear, JBabyBear)}


def _values(seed, n, bound):
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.bytes(32), "little") % bound
            for _ in range(n)]


def test_field_matches_reference():
    F, J = bn.BN254, jbn.BN254
    assert (F.P, F.TWO_ADICITY, F.GENERATOR) == (J.P, J.TWO_ADICITY,
                                                J.GENERATOR)
    xs = _values(1, 20, P) + [0, 1, P - 1]
    for a, b in zip(xs, reversed(xs)):
        for op in ("add_h", "sub_h", "mul_h"):
            assert getattr(F, op)(a, b) == getattr(J, op)(a, b)
        assert F.neg_h(a) == J.neg_h(a)
        assert F.to_monty_h(a) == J.to_monty_h(a)
        assert F.from_monty_h(F.to_monty_h(a)) == a
        if a:
            assert F.inv_h(a) == J.inv_h(a) and F.mul_h(a, F.inv_h(a)) == 1
    for bits in (0, 1, 17, 28):
        g = F.two_adic_generator_h(bits)
        assert g == J.two_adic_generator_h(bits)
        assert pow(g, 1 << bits, P) == 1
    with pytest.raises(ValueError):
        F.two_adic_generator_h(29)


def test_poseidon2_bn254_matches_reference():
    assert p2._consts() == jp2._consts()
    states = [[0, 0, 0], [1, 0, 0], [P - 1, P - 2, P - 3]] + [
        _values(s, 3, P) for s in range(5)]
    for s in states:
        out = p2.poseidon2_bn254_permute(s)
        assert out == jp2.poseidon2_bn254_permute(s)
        assert all(0 <= v < P for v in out)


def _script(ch, F, rng):
    """A transcript: observations across the flush boundary, digests,
    samples, bits, a cap; returns what it sampled."""
    out = []
    n = mf.max_absorb_injective_limbs(F) * mf.RATE
    for k in (1, n - 1, n, n + 3, 5):
        ch.observe_many(int(v) for v in rng.integers(0, F.P, k))
        out.append(ch.sample())
        out.append(ch.sample_bits(9))
    ch.observe_digest(_values(7, 3, P))
    out.extend(ch.sample_ext(4))
    ch.observe_digest([tuple(_values(8, 2, P)), tuple(_values(9, 2, P))])
    out.append(ch.sample_uniform_bits(20))
    out.extend(ch.sample() for _ in range(30))  # several refills
    return out


@pytest.mark.parametrize("field", ["koala", "baby"])
def test_multi_field_challenger_stream_matches_reference(field):
    F, JF = FIELDS[field]
    assert mf.max_absorb_injective_limbs(F) == \
        jmf.max_absorb_injective_limbs(JF)
    assert mf.squeeze_field_order_num_limbs(F) == \
        jmf.squeeze_field_order_num_limbs(JF)
    ours = _script(mf.MultiField32Challenger(F), F,
                   np.random.default_rng(3))
    ref = _script(jmf.MultiField32Challenger(JF), JF,
                  np.random.default_rng(3))
    assert ours == ref


@pytest.mark.parametrize("field", ["koala", "baby"])
def test_multi_field_grind_matches_reference(field):
    F, JF = FIELDS[field]
    a, b = mf.MultiField32Challenger(F), jmf.MultiField32Challenger(JF)
    for ch in (a, b):
        ch.observe_many([1, 2, 3])
    assert a.grind(6) == b.grind(6)
    assert a.sample() == b.sample()


@pytest.mark.parametrize("field", ["koala", "baby"])
def test_multi_field_sponge_and_compressor_match_reference(field):
    F, JF = FIELDS[field]
    for rate, out in ((2, 1), (2, 2)):
        ours = mf.MultiField32Sponge(F, rate=rate, out=out)
        ref = jmf.MultiField32Sponge(JF, rate=rate, out=out)
        assert ours.num_f_elms == ref.num_f_elms
        for k in (0, 1, 15, 16, 17, 40):
            row = [int(v) for v in
                   np.random.default_rng(k).integers(0, F.P, k)]
            assert ours.hash_iter_host(row) == ref.hash_iter_host(row)
    left, right = _values(4, 1, P), _values(5, 1, P)
    assert mf.MultiFieldCompressor().compress_host(left, right) == \
        jmf.MultiFieldCompressor().compress_host(left, right)


@pytest.mark.parametrize("hasher", ["poseidon2", "goldilocks"])
def test_hash_challenger_stream_matches_reference(hasher):
    """HashChallenger over the Poseidon2-24 sponge (KoalaBear, as
    tests/test_merkle_challenger.py::test_hash_challenger_generic) and
    over the Poseidon2-GL sponge (Goldilocks): observe, digest, sample,
    sample_bits, uniform bits and grind."""
    if hasher == "poseidon2":
        from plonky3_tpu.hashes.poseidon2 import default_poseidon2 as j_p2
        from plonky3_tpu.hashes.sponge import PaddingFreeSponge as JSponge
        from plonky3_tpu_torch.hashes.poseidon2 import default_poseidon2
        from plonky3_tpu_torch.hashes.sponge import PaddingFreeSponge

        ours = hc.HashChallenger(PaddingFreeSponge(
            default_poseidon2(KoalaBear, 24), 16, 8), KoalaBear, [5])
        ref = jhc.HashChallenger(JSponge(j_p2(JKoalaBear, 24), 16, 8),
                                 JKoalaBear, [5])
        F = KoalaBear
    else:
        ours = hc.HashChallenger(GLPoseidonSponge(), GLF, [1, 2])
        ref = jhc.HashChallenger(JGLSponge(), JGLF, [1, 2])
        F = GLF
    streams = []
    for ch in (ours, ref):
        rng = np.random.default_rng(12)
        got = []
        for k in (3, 1, 6):
            bound = min(F.P, 1 << 62)
            ch.observe_many(int(v) for v in rng.integers(0, bound, k))
            got.append(ch.sample())
            got.append(ch.sample_bits(11))
        ch.observe_digest([(1, 2), (3, 4)])
        got.extend(ch.sample_ext(3))
        got.append(ch.sample_uniform_bits(12))
        got.append(ch.grind(4))
        got.append(ch.sample())
        streams.append(got)
    assert streams[0] == streams[1]
