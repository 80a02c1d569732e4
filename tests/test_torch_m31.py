"""Mersenne-31 in the port against the reference's: the field, its cubic
extension M31Ext3, QM31, `more_extensions`, `m31_dft`, the keccak sponge
on canonical M31 rows, the circle fixtures' Keccak-256 byte hashers and
the challenger's byte digests.

Inputs come from numpy seeds (with 0 and P - 1 among them), go through
plonky3_tpu's numpy and host paths and the port's tensors and host
paths, and are compared exactly: integer words, equality is the
tolerance. Host work only; no proof is made here.
"""

import numpy as np
import pytest
import torch

from plonky3_tpu.challenger.serializing import (
    SerializingChallenger32 as JChallenger,
)
from plonky3_tpu.fields.mersenne31 import M31Ext3 as JExt3
from plonky3_tpu.fields.mersenne31 import Mersenne31 as JF
from plonky3_tpu.fields.more_extensions import (
    KoalaBearQuintic as JQuintic,
    Mersenne31Cubic as JCubic,
)
from plonky3_tpu.fields.qm31 import QM31 as JQ
from plonky3_tpu.hashes.keccak256_mmcs import (
    Keccak256Compressor as JCompressor,
    Keccak256FieldHasher as JHasher,
)
from plonky3_tpu.hashes.keccak_sponge import KeccakFieldSponge as JSponge
from plonky3_tpu.ops.m31_dft import m31_dft_batch as j_dft
from plonky3_tpu.ops.m31_dft import m31_idft_batch as j_idft
from plonky3_tpu_torch.challenger.serializing import SerializingChallenger32
from plonky3_tpu_torch.compat import field_from, trace_inputs_from_numpy
from plonky3_tpu_torch.fields.mersenne31 import (
    CIRCLE_TWO_ADIC_GENERATORS,
    M31Ext3,
    Mersenne31 as F,
)
from plonky3_tpu_torch.fields.more_extensions import (
    KB_QUINTIC_EXT_GENERATOR,
    KoalaBearQuintic,
    M31_CUBIC_EXT_GENERATOR,
    Mersenne31Cubic,
)
from plonky3_tpu_torch.fields.qm31 import QM31
from plonky3_tpu_torch.hashes.keccak256_mmcs import (
    Keccak256Compressor,
    Keccak256FieldHasher,
)
from plonky3_tpu_torch.hashes.keccak_sponge import KeccakFieldSponge
from plonky3_tpu_torch.ops.m31_dft import (
    _cm_generator,
    m31_dft_batch,
    m31_idft_batch,
)

P = (1 << 31) - 1


def _words(rng, shape):
    """Canonical words with the edge values 0, 1 and P - 1 up front."""
    w = rng.integers(0, P, size=shape, dtype=np.uint64).astype(np.uint32)
    flat = w.reshape(-1)
    flat[:3] = (0, 1, P - 1)
    return w


def _t(x):
    return torch.from_numpy(np.asarray(x).astype(np.int64))


def test_field_constants_carry_over():
    assert field_from(JF) is F
    assert field_from(JExt3) is M31Ext3
    assert field_from(JQ) is QM31
    assert (F.P, F.TWO_ADICITY, F.GENERATOR, F.R, F.RINV) == (P, 0, 7, 1, 1)
    from plonky3_tpu.fields.mersenne31 import (
        CIRCLE_TWO_ADIC_GENERATORS as J_GENS,
    )

    assert CIRCLE_TWO_ADIC_GENERATORS == J_GENS
    with pytest.raises(ValueError, match="two-adicity"):
        F.two_adic_generator_h(1)


def test_field_ops_match_reference():
    rng = np.random.default_rng(0)
    a, b = _words(rng, 600), _words(rng, 600)[::-1].copy()
    ta, tb = _t(a), _t(b)
    for ours, ref in ((F.add, JF.add_np), (F.sub, JF.sub_np),
                      (F.mul, JF.mul_np)):
        assert np.array_equal(ours(ta, tb).numpy(), ref(a, b))
    assert np.array_equal(F.halve(ta).numpy(), JF.halve_np(a))
    assert np.array_equal(F.square(ta).numpy(), JF.square_np(a))
    nz = a != 0
    inv = F.inv(ta).numpy()
    assert np.array_equal(inv[nz], JF.batch_inv_np(a[nz]))
    assert not inv[~nz].any()
    assert np.array_equal(F.batch_inv(ta).numpy(), inv)
    assert np.array_equal(F.exp(ta, 12345).numpy(),
                          np.array([pow(int(x), 12345, P) for x in a]))
    # M31 has no Montgomery form: the conversions reduce and change nothing
    assert np.array_equal(F.to_monty_np(a), JF.to_monty_np(a))
    assert np.array_equal(F.from_monty_np(a), a)
    assert F.to_monty_h(P + 5) == JF.to_monty_h(P + 5) == 5
    assert np.array_equal(F.rand_np(np.random.default_rng(4), 50),
                          JF.rand_np(np.random.default_rng(4), 50))
    assert int(F.sum(ta).item()) == int(JF.sum_np(a))


def test_cubic_extension_matches_reference():
    rng = np.random.default_rng(1)
    a, b = _words(rng, (40, 3)), _words(rng, (40, 3))
    assert np.array_equal(M31Ext3.mul(_t(a), _t(b)).numpy(),
                          np.asarray(JExt3.mul_np(a, b)))
    assert np.array_equal(M31Ext3.mul_np(a, b), JExt3.mul_np(a, b))
    inv = M31Ext3.inv(_t(a[1:])).numpy()
    one = M31Ext3.mul(_t(a[1:]), _t(inv)).numpy()
    assert (one == [1, 0, 0]).all()
    for _ in range(5):
        x = tuple(int(v) for v in _words(rng, 3))
        y = tuple(int(v) for v in _words(rng, 3))
        assert M31Ext3.mul_h(x, y) == JExt3.mul_h(x, y)
        if any(y):
            assert M31Ext3.inv_h(y) == JExt3.inv_h(y)
    assert np.array_equal(M31Ext3.powers_np((5, 6, 7), 9),
                          JExt3.powers_np((5, 6, 7), 9))


def test_qm31_matches_reference():
    rng = np.random.default_rng(2)
    a, b = _words(rng, (300, 4)), _words(rng, (300, 4))[::-1].copy()
    got = QM31.mul(_t(a), _t(b)).numpy()
    assert np.array_equal(got, JQ.mul_np(a, b))
    assert np.array_equal(QM31.mul_np(a, b), JQ.mul_np(a, b))
    s = _words(rng, 300)
    assert np.array_equal(QM31.base_mul(_t(s), _t(a)).numpy(),
                          JQ.base_mul_np(s, a))
    inv = QM31.inv(_t(a)).numpy()
    nz = a.any(axis=1)
    prod = QM31.mul(_t(a[nz]), _t(inv[nz])).numpy()
    assert (prod == [1, 0, 0, 0]).all()
    assert not inv[~nz].any()
    assert np.array_equal(QM31.inv(_t(a), base_inv=F.batch_inv).numpy(), inv)
    assert np.array_equal(QM31.from_base(_t(s)).numpy(),
                          np.stack([s, 0 * s, 0 * s, 0 * s], -1))
    for i in range(20):
        x = tuple(int(v) for v in a[i])
        y = tuple(int(v) for v in b[i])
        assert QM31.mul_h(x, y) == JQ.mul_h(x, y)
        assert QM31.add_h(x, y) == JQ.add_h(x, y)
        assert QM31.sub_h(x, y) == JQ.sub_h(x, y)
        assert QM31.exp_h(x, 1000 + i) == JQ.exp_h(x, 1000 + i)
        if any(x):
            assert QM31.inv_h(x) == JQ.inv_h(x) == tuple(inv[i])
    alpha = tuple(int(v) for v in a[5])
    assert np.array_equal(QM31.powers_np(alpha, 17), JQ.powers_np(alpha, 17))
    assert np.array_equal(QM31.to_monty_np(alpha), JQ.to_monty_np(alpha))


def test_more_extensions_match_reference():
    rng = np.random.default_rng(3)
    for _ in range(5):
        x = tuple(int(v) for v in rng.integers(0, KoalaBearQuintic.P, 5))
        y = tuple(int(v) for v in rng.integers(0, KoalaBearQuintic.P, 5))
        assert KoalaBearQuintic.mul_h(x, y) == JQuintic.mul_h(x, y)
        assert KoalaBearQuintic.inv_h(y) == JQuintic.inv_h(y)
        assert KoalaBearQuintic.frobenius_h(x) == JQuintic.frobenius_h(x)
        assert KoalaBearQuintic.frobenius_h(x) == KoalaBearQuintic.exp_h(
            x, KoalaBearQuintic.P)
        c, d = x[:3], y[:3]
        c = tuple(v % P for v in c)
        d = tuple(v % P for v in d)
        assert Mersenne31Cubic.mul_h(c, d) == JCubic.mul_h(c, d)
        assert Mersenne31Cubic.inv_h(d) == JCubic.inv_h(d)
        assert Mersenne31Cubic.mul_h(c, d) == M31Ext3.mul_h(c, d)
    q = KoalaBearQuintic
    assert q.exp_h(KB_QUINTIC_EXT_GENERATOR, (q.P ** 5 - 1) // 2) == q.neg_h(
        q.one_h())
    c3 = Mersenne31Cubic
    assert c3.exp_h(M31_CUBIC_EXT_GENERATOR, (P ** 3 - 1) // 2) == c3.neg_h(
        c3.one_h())


def test_m31_dft_matches_reference():
    rng = np.random.default_rng(4)
    g = _cm_generator(32)
    x = g
    for _ in range(31):
        x = ((x[0] * x[0] - x[1] * x[1]) % P, (2 * x[0] * x[1]) % P)
    assert x == (P - 1, 0)  # g has order exactly 2^32
    for h, w in [(4, 1), (16, 3), (64, 2)]:
        mat = _words(rng, (h, w))
        spec = m31_dft_batch(mat)
        assert np.array_equal(spec, j_dft(mat))
        assert np.array_equal(m31_idft_batch(spec), mat)
        assert np.array_equal(m31_idft_batch(spec), j_idft(spec))


def test_keccak_sponge_on_m31_rows():
    """The leaf sponge (its plain version on the CPU) on canonical M31
    rows, widths odd and even, against the reference's numpy sponge."""
    rng = np.random.default_rng(5)
    for width in (1, 2, 33, 2633):
        rows = _words(rng, (16, width))
        rows[-1] = P - 1
        rows[-2] = 0
        sponge = KeccakFieldSponge(F)
        got = sponge.hash_rows_device(
            [trace_inputs_from_numpy(rows, "cpu", F=F)]).numpy()
        want = JSponge(JF).hash_rows_np([rows])
        assert np.array_equal(got, want)
        assert np.array_equal(sponge.hash_rows_np([rows]), want)
        assert sponge.hash_iter_host(rows[-1].tolist()) == tuple(
            int(v) for v in want[-1])
    with pytest.raises(ValueError, match="canonical"):
        trace_inputs_from_numpy(np.full((2, 2), P, np.uint32), "cpu", F=F)


def test_keccak256_byte_hashers_match_reference():
    rng = np.random.default_rng(6)
    rows = _words(rng, (9, 37))
    ours, ref = Keccak256FieldHasher(F), JHasher(JF)
    digests = ours.hash_rows_np([rows])
    assert np.array_equal(digests, ref.hash_rows_np([rows]))
    assert np.array_equal(ours.hash_rows_device([_t(rows)]).numpy(), digests)
    assert ours.hash_iter_host(rows[3].tolist()) == ref.hash_iter_host(
        rows[3].tolist())
    comp, jcomp = Keccak256Compressor(), JCompressor()
    left, right = digests[:4], digests[4:8]
    both = comp.compress_np(left, right)
    assert np.array_equal(both, jcomp.compress_np(left, right))
    assert np.array_equal(
        comp.compress_device(_t(left), _t(right)).numpy(), both)
    assert comp.compress_host(left[0], right[0]) == jcomp.compress_host(
        left[0], right[0])


@pytest.mark.parametrize("digest_bytes", [False, True])
def test_challenger_digests_match_reference(digest_bytes):
    ours = SerializingChallenger32(F, digest_bytes=digest_bytes)
    ref = JChallenger(JF, digest_bytes=digest_bytes)
    n = 32 if digest_bytes else 8
    digest = tuple(int(v) for v in np.random.default_rng(7).integers(
        0, 256, n))
    for ch in (ours, ref):
        ch.observe(P - 1)
        ch.observe_digest(digest)
        ch.observe_digest([tuple(range(n)), tuple(range(1, n + 1))])
        ch.observe_ext((1, 2, 3, 4))
    for _ in range(3):
        assert ours.sample_ext(4) == ref.sample_ext(4)
        assert ours.sample_bits(20) == ref.sample_bits(20)
    assert ours.grind(4) == ref.grind(4)
