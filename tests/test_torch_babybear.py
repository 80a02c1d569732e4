"""BabyBear in the port against the reference's: the field and its
degree-4 extension, Poseidon2-16/24 with the degree-7 s-box, the plain
versions of the duplex transcript kernels, and a whole proof under the
Poseidon2 config.

plonky3_tpu_torch's BabyBear and BabyBearExt4 against plonky3_tpu's numpy
and host paths; `compat.field_from` and `poseidon2_from` carry the
reference's objects over and their constants agree table for table; the
permutations against Plonky3's known-answer vectors and the reference's
`permute_np`; `poseidon2_duplex_chain` and `poseidon2_grind` (their plain
versions, on the CPU) against the reference's host `DuplexChallenger`,
and the port's transcripts in lockstep with it; the kernels refuse a
permutation outside their two instantiations; and under
`poseidon2_stark_config` (Poseidon2VectorAir(BabyBear) vector_len 1, 298
columns, log_n 6, 10 queries, 8-bit query PoW, on the CPU) the port's
`prove()` and device-transcript prover give the reference's proof, and
both verifiers accept it.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from plonky3_tpu.challenger.duplex import DuplexChallenger as JDuplex
from plonky3_tpu.fields import BabyBear as JF
from plonky3_tpu.fields import BabyBearExt4 as JE
from plonky3_tpu.fields import KoalaBear as JKoala
from plonky3_tpu.fri.config import FriParameters as JFriParameters
from plonky3_tpu.hashes.poseidon2 import default_poseidon2 as j_poseidon2
from plonky3_tpu.models.poseidon2_air import (
    Poseidon2VectorAir as JAir,
    generate_vectorized_trace as j_generate,
)
from plonky3_tpu.stark.config import poseidon2_stark_config as j_config
from plonky3_tpu.stark.prover import prove as j_prove
from plonky3_tpu.stark.verifier import verify as j_verify
from plonky3_tpu_torch.challenger.device_duplex import DeviceDuplexChallenger
from plonky3_tpu_torch.challenger.duplex import DuplexChallenger
from plonky3_tpu_torch.compat import (
    field_from,
    fri_params_from,
    poseidon2_from,
    trace_inputs_from_numpy,
)
from plonky3_tpu_torch.fields import BabyBear as F
from plonky3_tpu_torch.fields import BabyBearExt4 as E
from plonky3_tpu_torch.fields import KoalaBear
from plonky3_tpu_torch.hashes import poseidon2_cuda as pc
from plonky3_tpu_torch.hashes.poseidon2 import Poseidon2, default_poseidon2
from plonky3_tpu_torch.models.poseidon2_air import (
    Poseidon2VectorAir,
    generate_vectorized_trace,
)
from plonky3_tpu_torch.stark import fast_prover
from plonky3_tpu_torch.stark.config import poseidon2_stark_config
from plonky3_tpu_torch.stark.prover import prove
from plonky3_tpu_torch.stark.verifier import verify
from test_poseidon2 import KATS
from test_torch_duplex import _Device, _Host, _script, _t
from test_torch_prove import as_plain, to_reference

PERM24 = default_poseidon2(F, 24)
LOG_N = 6
PARAMS = JFriParameters(log_blowup=1, log_final_poly_len=0, max_log_arity=3,
                        num_queries=10, commit_proof_of_work_bits=0,
                        query_proof_of_work_bits=8)


def _i64(x):
    return torch.from_numpy(np.asarray(x).astype(np.int64))


def test_field_constants_carry_over():
    assert field_from(JF) is F
    assert field_from(JE) is E
    assert (F.P, F.MU, F.TWO_ADICITY, F.GENERATOR) == (
        0x78000001, 0x88000001, 27, 31)
    assert (E.W, E.DTH_ROOT, E.EXT_GENERATOR, E.EXT_TWO_ADICITY) == (
        11, 1728404513, (8, 1, 0, 0), 29)
    with pytest.raises(ValueError, match="P differs"):
        field_from(dataclasses.replace(JKoala, name="BabyBear"))


def test_field_ops_match_reference():
    rng = np.random.default_rng(0)
    a, b = JF.rand_np(rng, 500), JF.rand_np(rng, 500)
    b[:3] = 0
    ta, tb = _i64(a), _i64(b)
    for ours, ref in ((F.add, JF.add_np), (F.sub, JF.sub_np),
                      (F.mul, JF.mul_np)):
        assert np.array_equal(ours(ta, tb).numpy(), ref(a, b))
    inv = F.inv(tb).numpy()
    assert np.array_equal(inv[3:], JF.batch_inv_np(b[3:]))
    assert not inv[:3].any()
    assert np.array_equal(F.halve(ta).numpy(), JF.halve_np(a))
    std = JF.from_monty_np(a)
    assert np.array_equal(F.from_monty_np(a), std)
    assert np.array_equal(F.to_monty_tensor(_i64(std)).numpy(), a)
    for bits in range(F.TWO_ADICITY + 1):
        g = F.two_adic_generator_h(bits)
        assert pow(g, 1 << bits, F.P) == 1
        assert bits == 0 or pow(g, 1 << (bits - 1), F.P) != 1


def test_ext4_ops_match_reference():
    rng = np.random.default_rng(1)
    a, b = JF.rand_np(rng, (50, 4)), JF.rand_np(rng, (50, 4))
    got = E.mul(_i64(a), _i64(b)).numpy()
    assert np.array_equal(got, JE.mul_np(a, b))
    assert np.array_equal(E.mul_np(a, b), JE.mul_np(a, b))
    inv = E.inv(_i64(a)).numpy()
    assert np.array_equal(E.mul(_i64(a), _i64(inv)).numpy()[:, 0],
                          np.full(50, F.R))
    for _ in range(5):
        x, y = JE.rand_h(rng), JE.rand_h(rng)
        assert E.mul_h(x, y) == JE.mul_h(x, y)
        assert E.inv_h(x) == JE.inv_h(x)
        assert E.frobenius_h(x) == JE.frobenius_h(x)
    g = E.EXT_GENERATOR
    assert E.exp_h(g, (F.P ** 4 - 1) >> 1) != E.one_h()


@pytest.mark.parametrize("width", [16, 24])
def test_poseidon2_known_answers_and_reference(width):
    inp, want = KATS[("BabyBear", width)]
    perm = default_poseidon2(F, width)
    assert (perm.d, len(perm.rc_internal)) == (7, {16: 13, 24: 21}[width])
    assert perm.permute_np(np.array([inp]))[0].tolist() == want
    got = perm.permute(_i64(F.to_monty_np(np.array([inp], np.uint64))))
    assert F.from_monty_np(got.numpy()[0]).tolist() == want
    ref = j_poseidon2(JF, width)
    carried = poseidon2_from(ref)
    for k in ("rc_external_initial", "rc_external_final", "rc_internal",
              "diag_std", "d", "width"):
        assert getattr(carried, k) == getattr(perm, k), k
    x = JF.rand_np(np.random.default_rng(width), (20, width))
    assert np.array_equal(perm.permute(_i64(x)).numpy(), ref.permute_np(x))
    assert np.array_equal(perm.permute_np(JF.from_monty_np(x)),
                          JF.from_monty_np(ref.permute_np(x)))


def _reference_absorb(state_std, words_std):
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
    rng = np.random.default_rng(k)
    queued = JF.from_monty_np(JF.rand_np(rng, 16 + k)).tolist()
    host, ours = JDuplex(j_poseidon2(JF, 24), rate=16), DuplexChallenger(
        PERM24)
    for ch in (host, ours):
        ch.observe_many(queued)
    assert ours.grind(bits) == host.grind(bits)
    assert ours.sample_ext(4) == host.sample_ext(4)


class _BabyBearDevice(_Device):
    """The KoalaBear test's device operations in BabyBear's Montgomery
    form."""

    def observe_array(self, values):
        self.ch.observe_words(F.to_monty_tensor(torch.from_numpy(
            np.asarray(values, dtype=np.int64) % F.P)))

    def fields(self, num):
        return F.from_monty_tensor(self.ch.sample_fields_m(num)).tolist()

    def grind_fields(self, pow_bits, num):
        w, vals = self.ch.grind_then_sample_fields(pow_bits, num)
        return int(w[0]), F.from_monty_tensor(vals).tolist()


def test_transcripts_in_lockstep_with_reference():
    """The KoalaBear test's script of observes, samples and grinds over
    BabyBear. Its words are drawn below KoalaBear's P, above BabyBear's;
    every transcript reduces them mod P as it observes them."""
    want = _script(_Host(JDuplex(j_poseidon2(JF, 24), rate=16)))
    assert _script(_Host(DuplexChallenger(PERM24))) == want
    dev = DeviceDuplexChallenger(F, PERM24, "cpu")
    assert _script(_BabyBearDevice(dev)) == want
    assert dev.flags and all(bool(f) for f in dev.flags)


@pytest.mark.parametrize("change", ["rounds", "degree", "width"])
def test_kernels_refuse_other_instantiations(change):
    """`<23, 3>` and `<21, 7>` only: a BabyBear table with KoalaBear's
    round count, a degree-3 BabyBear permutation or width 16 raise
    ValueError, on the CPU too; nothing falls back."""
    perm = {"rounds": dataclasses.replace(
                PERM24, rc_internal=PERM24.rc_internal + (1, 2)),
            "degree": dataclasses.replace(PERM24, d=3),
            "width": default_poseidon2(F, 16)}[change]
    state = torch.zeros(24, dtype=torch.int32)
    with pytest.raises(ValueError, match="duplex kernels take"):
        pc.poseidon2_duplex_chain(perm, state, state[:3])
    with pytest.raises(ValueError, match="duplex kernels take"):
        pc.poseidon2_grind(perm, state, 0, 4)
    assert pc.launch_name("poseidon2_grind", PERM24) == \
        "poseidon2_grind_babybear"
    assert pc.launch_name("poseidon2_grind",
                          default_poseidon2(KoalaBear, 24)) == \
        "poseidon2_grind"


def test_other_degrees_raise():
    with pytest.raises(NotImplementedError, match="degree-5"):
        Poseidon2(F=F, width=16, d=5, rc_external_initial=(),
                  rc_external_final=(), rc_internal=())


@pytest.fixture(scope="module")
def proofs():
    """The reference's prove under its Poseidon2 config over BabyBear, and
    the port's prove and device-transcript prove of the same inputs."""
    inputs = JF.rand_np(np.random.default_rng(3), (1 << LOG_N, 16))
    j_air = JAir(JF, 16, vector_len=1)
    j_cfg = j_config(JF, JE, PARAMS)
    j_trace, _ = j_generate(j_air, jnp.asarray(inputs))
    ref = j_prove(j_cfg, j_air, j_trace, [])

    air = Poseidon2VectorAir(F, 16, vector_len=1)
    trace, _ = generate_vectorized_trace(
        air, trace_inputs_from_numpy(inputs, "cpu"), device="cpu")
    cfg = poseidon2_stark_config(F, E, fri_params_from(PARAMS), device="cpu")
    return dict(ref=ref, ours=prove(cfg, air, trace, []),
                fast=fast_prover._prove_device_fs(cfg, air, trace, []),
                j_cfg=j_cfg, j_air=j_air, air=air, cfg=cfg)


def test_poseidon2_config_proofs_equal_reference(proofs):
    assert proofs["air"].width == 298
    assert as_plain(proofs["ours"]) == as_plain(proofs["ref"])
    assert proofs["fast"] == proofs["ours"]


def test_poseidon2_config_both_verifiers_accept(proofs):
    verify(proofs["cfg"], proofs["air"], proofs["fast"], [])
    j_verify(proofs["j_cfg"], proofs["j_air"], to_reference(proofs["fast"]),
             [])
