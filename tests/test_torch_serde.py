"""The postcard wire of plonky3_tpu_torch against plonky3_tpu's
(`serde/`, `compat/`): rand's SmallRng streams and the fixture configs'
Poseidon2 constants; postcard varints and records; the bytes of a
uni-stark proof and a canonical batch proof under TWO_ADIC_SPEC equal
the JAX encoder's on the same proofs (the golden fixture files are not
in the repository, so the JAX package's encoder is the yardstick), and
decoding then encoding is the identity; CIRCLE_SPEC on a hand-built
record."""

import dataclasses

import numpy as np
import pytest
import torch

from plonky3_tpu.compat import batch_wire as j_batch_wire
from plonky3_tpu.compat import fixture_configs as j_fixture
from plonky3_tpu.compat import smallrng as j_smallrng
from plonky3_tpu.compat import uni_stark_wire as j_uni_wire
from plonky3_tpu.fields import BabyBear as JF
from plonky3_tpu.serde import postcard as j_postcard
from plonky3_tpu.serde import proof_codec as j_codec
from plonky3_tpu_torch.compat import batch_fixture_airs as airs_mod
from plonky3_tpu_torch.compat import batch_wire, fixture_configs, smallrng
from plonky3_tpu_torch.compat import uni_stark_wire
from plonky3_tpu_torch.fields import BabyBear as F
from plonky3_tpu_torch.models.fibonacci import (FibonacciAir,
                                                generate_fibonacci_trace)
from plonky3_tpu_torch.serde import postcard, proof_codec
from plonky3_tpu_torch.stark import batch, batch_ref
from plonky3_tpu_torch.stark.prover import prove
from plonky3_tpu_torch.stark.verifier import verify
from test_torch_batch_ref import _to_reference
from test_torch_prove import as_plain, to_reference


@pytest.mark.parametrize("seed", [0, 1, 777, 2**63 + 5])
def test_smallrng_stream_equals_reference(seed):
    ours = smallrng.SmallRng.seed_from_u64(seed)
    ref = j_smallrng.SmallRng.seed_from_u64(seed)
    assert [ours.next_u64() for _ in range(64)] == [
        ref.next_u64() for _ in range(64)]
    assert [ours.next_u32() for _ in range(16)] == [
        ref.next_u32() for _ in range(16)]
    assert ours.sample_monty31_array(F.P, 32) == ref.sample_monty31_array(
        JF.P, 32)


def test_smallrng_known_answer():
    """rand's SmallRng::seed_from_u64(0): the SplitMix64 expansion's first
    output word is 0xe220a8397b1dcdaf."""
    assert smallrng.SmallRng.seed_from_u64(0).s[0] == 0xE220A8397B1DCDAF


@pytest.mark.parametrize("seed", [1, 777])
def test_poseidon2_baby_bear_16_equals_reference(seed):
    ours = fixture_configs.poseidon2_baby_bear_16(seed)
    ref = j_fixture.poseidon2_baby_bear_16(seed)
    assert ours.rc_external_initial == ref.rc_external_initial
    assert ours.rc_external_final == ref.rc_external_final
    assert ours.rc_internal == ref.rc_internal
    x = np.arange(16, dtype=np.int64)
    assert [int(v) for v in ours.permute_np(x)] == ref.permute_host_py(
        [int(v) for v in x])


VARINTS = [0, 1, 127, 128, 255, 300, 16383, 16384, 2**31 - 1, 2**32,
           2**63, 2**64 - 1]


@pytest.mark.parametrize("v", VARINTS)
def test_varint_equals_reference(v):
    w, jw = postcard.Writer(), j_postcard.Writer()
    w.varint(v)
    jw.varint(v)
    assert w.getvalue() == jw.getvalue()
    assert postcard.Reader(w.getvalue()).varint() == v


def test_postcard_records():
    w = postcard.Writer()
    w.u8(7)
    w.bool(True)
    w.option(None, w.varint)
    w.option(5, w.varint)
    w.vec([1, 200, 3], w.varint)
    w.bytes(b"ab")
    data = w.getvalue()
    jw = j_postcard.Writer()
    jw.u8(7)
    jw.bool(True)
    jw.option(None, jw.varint)
    jw.option(5, jw.varint)
    jw.vec([1, 200, 3], jw.varint)
    jw.bytes(b"ab")
    assert data == jw.getvalue()
    r = postcard.Reader(data)
    assert (r.u8(), r.bool(), r.option(r.varint), r.option(r.varint),
            r.vec(r.varint), r.bytes(2)) == (7, True, None, 5, [1, 200, 3],
                                             b"ab")
    assert r.eof()
    with pytest.raises(ValueError):
        postcard.Reader(b"\x02").bool()
    with pytest.raises(ValueError):
        postcard.Writer().varint(-1)


@pytest.fixture(scope="module")
def uni_proof():
    """FibonacciAir at 16 rows under the uni-stark fixture config."""
    cfg = fixture_configs.two_adic_fixture_config(device="cpu")
    trace, publics = generate_fibonacci_trace(F, 4, device="cpu")
    proof = prove(cfg, FibonacciAir(F), trace, publics)
    verify(cfg, FibonacciAir(F), proof, publics)
    return proof


@pytest.fixture(scope="module")
def batch_proof():
    """The batch fixture's case at 32 rows, proven by the port."""
    cfg = fixture_configs.batch_two_adic_fixture_config(device="cpu")
    airs = [airs_mod.MulAirLookups(F, reps=2),
            airs_mod.FibAirLookups(F, log_height=5)]
    ft, fpis = airs_mod.fibonacci_trace(F, 5)
    traces = [airs_mod.mul_trace(F, 32, 2), ft]
    common = batch_ref.keygen(cfg, airs, [5, 5])
    inst = [batch.BatchInstance(a, torch.from_numpy(
        F.to_monty_np(t).astype(np.int64)), pv)
        for a, t, pv in zip(airs, traces, [[], fpis])]
    proof = batch_ref.prove_batch_ref(cfg, inst, common)
    batch_ref.verify_batch_ref(cfg, airs, proof, [[], fpis], common)
    return proof


def test_uni_stark_bytes_equal_reference(uni_proof):
    got = uni_stark_wire.encode_our_proof(uni_proof, F,
                                          proof_codec.TWO_ADIC_SPEC)
    want = j_uni_wire.encode_our_proof(to_reference(uni_proof), JF,
                                       j_codec.TWO_ADIC_SPEC)
    assert got == want


def test_uni_stark_decode_encode_identity(uni_proof):
    spec = proof_codec.TWO_ADIC_SPEC
    data = uni_stark_wire.encode_our_proof(uni_proof, F, spec)
    back = uni_stark_wire.decode_to_our_proof(data, F, spec)
    assert as_plain(back) == as_plain(uni_proof)
    wire = proof_codec.decode_proof(data, spec)
    assert proof_codec.encode_proof(wire, spec) == data
    assert as_plain(j_codec.decode_proof(data, j_codec.TWO_ADIC_SPEC)) == (
        as_plain(wire))


def test_batch_bytes_equal_reference(batch_proof):
    got = batch_wire.encode_batch_ref_proof(batch_proof, F,
                                            proof_codec.TWO_ADIC_SPEC)
    want = j_batch_wire.encode_batch_ref_proof(
        _to_reference(batch_proof), JF, j_codec.TWO_ADIC_SPEC)
    assert got == want
    # the cap of height 1: two digests a commitment
    assert len(batch_proof.main_commit) == 2


def test_batch_decode_encode_identity(batch_proof):
    spec = proof_codec.TWO_ADIC_SPEC
    data = batch_wire.encode_batch_ref_proof(batch_proof, F, spec)
    back = batch_wire.decode_to_batch_ref_proof(data, F, spec)
    assert as_plain(back) == as_plain(batch_proof)
    assert proof_codec.encode_batch_proof(
        proof_codec.decode_batch_proof(data, spec), spec) == data


@pytest.mark.parametrize("cut", [1, 7])
def test_decode_rejects_short_and_long_input(batch_proof, cut):
    spec = proof_codec.TWO_ADIC_SPEC
    data = batch_wire.encode_batch_ref_proof(batch_proof, F, spec)
    with pytest.raises((IndexError, EOFError, ValueError)):
        proof_codec.decode_batch_proof(data[:-cut], spec)
    with pytest.raises(ValueError, match="trailing"):
        proof_codec.decode_batch_proof(data + bytes(cut), spec)


def _circle_record(codec):
    """A hand-built uni-stark wire record in the circle layout."""
    dig = bytes(range(32))
    ext = (1, 2, 3)
    bmo = codec.WireBatchMultiOpening([[[5, 6], [7]]], [dig])
    fri = codec.WireFriProof(
        commit_phase_commits=[[dig]], commit_pow_witnesses=[9],
        input_openings=codec.WireCircleInput([bmo], [[ext]], [dig]),
        commit_phase_openings=[codec.WireCommitPhaseStep(1, [[ext]],
                                                         [dig])],
        final_poly=ext, query_pow_witness=300)
    return codec.WireProof(
        trace_commit=[dig], quotient_commit=[dig], random_commit=None,
        trace_local=[ext], trace_next=[ext], preprocessed_local=None,
        preprocessed_next=None, quotient_chunks=[[ext, ext]],
        random_values=None,
        opening_proof=codec.WireCirclePcsProof([dig], [ext], fri),
        degree_bits=3)


def test_circle_spec_equals_reference():
    data = proof_codec.encode_proof(_circle_record(proof_codec),
                                    proof_codec.CIRCLE_SPEC)
    assert data == j_codec.encode_proof(_circle_record(j_codec),
                                        j_codec.CIRCLE_SPEC)
    back = proof_codec.decode_proof(data, proof_codec.CIRCLE_SPEC)
    assert as_plain(back) == as_plain(_circle_record(proof_codec))


def test_circle_configs_wait_for_m19():
    """M19 brought the circle fixture configs: each has the reference's
    FRI parameters, Merkle cap, challenge field and byte-digest
    transcript."""
    for make, j_make in (
            (fixture_configs.circle_fixture_config,
             j_fixture.circle_fixture_config),
            (fixture_configs.batch_circle_fixture_config,
             j_fixture.batch_circle_fixture_config)):
        cfg, ref = make(device="cpu"), j_make()
        assert dataclasses.asdict(cfg.pcs.fri) == dataclasses.asdict(
            ref.pcs.fri)
        assert cfg.pcs.mmcs.cap_height == ref.pcs.mmcs.cap_height
        assert (cfg.E.D, cfg.E.W) == (ref.pcs.ext.D, ref.pcs.ext.W)
        assert cfg.initialise_challenger().digest_bytes
        assert ref.initialise_challenger().digest_bytes
