"""The port's STIR (plonky3_tpu_torch/stir/) against the reference's.

The same inputs, made from a seed with numpy, go through both packages:
the schedule of `StirConfig.new` over a grid of parameters, the host
polynomial algebra of `stir/utils.py`, the codeword fold against the
reference's numpy fold, and the TwoAdicStirPcs proof at 2^6 x 3 with one
opening point and with two, which must be equal field for field
(tolerance zero). Each package's verifier accepts the other's proof and
the two raise the same error class on the reference tests' tampers. The
JAX proofs are made once, in a module-scoped fixture (their XLA compiles
take most of this file's time).
"""

import copy
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from plonky3_tpu.challenger.duplex import DuplexChallenger as JDuplex
from plonky3_tpu.fields import KoalaBear as JF
from plonky3_tpu.fields import KoalaBearExt4 as JE
from plonky3_tpu.hashes.poseidon2 import default_poseidon2 as j_poseidon2
from plonky3_tpu.hashes.sponge import PaddingFreeSponge as JSponge
from plonky3_tpu.hashes.sponge import TruncatedPermutation as JCompress
from plonky3_tpu.merkle.extension_mmcs import ExtensionMmcs as JExtMmcs
from plonky3_tpu.merkle.mmcs import MerkleTreeMmcs as JMmcs
from plonky3_tpu.stir import StirConfig as JStirConfig
from plonky3_tpu.stir import StirParameters as JStirParameters
from plonky3_tpu.stir import utils as ju
from plonky3_tpu.stir import verify_stir as j_verify_stir
from plonky3_tpu.stir.pcs import TwoAdicStirPcs as JStirPcs
from plonky3_tpu_torch.challenger.duplex import DuplexChallenger
from plonky3_tpu_torch.fields import KoalaBear as F
from plonky3_tpu_torch.fields import KoalaBearExt4 as E
from plonky3_tpu_torch.hashes.poseidon2 import default_poseidon2
from plonky3_tpu_torch.hashes.sponge import (
    PaddingFreeSponge,
    TruncatedPermutation,
)
from plonky3_tpu_torch.merkle.extension_mmcs import ExtensionMmcs
from plonky3_tpu_torch.merkle.mmcs import MerkleTreeMmcs
from plonky3_tpu_torch.stir import (
    StirConfig,
    StirError,
    StirParameters,
    prove_stir,
    verify_stir,
)
from plonky3_tpu_torch.stir import utils as pu
from plonky3_tpu_torch.stir.pcs import TwoAdicStirPcs

PARAMS = dict(log_blowup=2, log_folding_factor=2, security_level=60,
              max_pow_bits=12)


def as_plain(x):
    """Nested tuples of ints (a dataclass == would also compare classes)."""
    if dataclasses.is_dataclass(x):
        return tuple((f.name, as_plain(getattr(x, f.name)))
                     for f in dataclasses.fields(x))
    if isinstance(x, (list, tuple)):
        return tuple(as_plain(v) for v in x)
    if isinstance(x, np.integer):
        return int(x)
    return x


def _mmcs():
    return MerkleTreeMmcs(
        sponge=PaddingFreeSponge(default_poseidon2(F, 24), rate=16, out=8),
        compressor=TruncatedPermutation(default_poseidon2(F, 16), chunk=8))


def _jmmcs():
    return JMmcs(
        sponge=JSponge(j_poseidon2(JF, 24), rate=16, out=8),
        compressor=JCompress(j_poseidon2(JF, 16), chunk=8))


def _pcs():
    m = _mmcs()
    return TwoAdicStirPcs(F=F, E=E, params=StirParameters(**PARAMS), mmcs=m,
                          stir_mmcs=ExtensionMmcs(inner=m, D=E.D))


def _jpcs():
    m = _jmmcs()
    return JStirPcs(F=JF, E=JE, params=JStirParameters(**PARAMS), mmcs=m,
                    stir_mmcs=JExtMmcs(inner=m, D=JE.D))


def _ch():
    return DuplexChallenger(default_poseidon2(F, 24), rate=16)


def _jch():
    return JDuplex(j_poseidon2(JF, 24), rate=16)


CASES = {"one_point": (6, 3, 1), "two_points": (6, 3, 2)}


def _inputs(case):
    log_n, w, n_points = CASES[case]
    rng = np.random.default_rng(7 + n_points)
    evals_m = F.to_monty_np(rng.integers(0, F.P, (1 << log_n, w),
                                         dtype=np.uint64))
    points = [JE.rand_h(rng) for _ in range(n_points)]
    return log_n, evals_m, points


def _prove(case, pcs, challenger, to_matrix):
    log_n, evals_m, points = _inputs(case)
    domain = pcs.natural_domain_for_degree(1 << log_n)
    data = pcs.commit([(domain, to_matrix(evals_m))])
    ch = challenger()
    ch.observe_many(data.root_std)
    opened, proof = pcs.open([(data, [points])], ch)
    claims = [(data.root_std,
               [(domain, list(zip(points, opened[0][0])))])]
    return dict(opened=opened, proof=proof, claims=claims, data=data)


@pytest.fixture(scope="module")
def proofs():
    out = {}
    for case in CASES:
        out[case] = dict(
            ours=_prove(case, _pcs(), _ch,
                        lambda m: torch.from_numpy(m.astype(np.int64))),
            ref=_prove(case, _jpcs(), _jch, jnp.asarray))
    return out


def _verify(pcs, challenger, run, proof=None, claims=None):
    ch = challenger()
    ch.observe_many(run["data"].root_std)
    pcs.verify(claims or run["claims"], run["proof"] if proof is None
               else proof, ch)


@pytest.mark.parametrize("case", list(CASES))
def test_pcs_proof_equals_reference(proofs, case):
    ours, ref = proofs[case]["ours"], proofs[case]["ref"]
    assert ours["data"].root_std == ref["data"].root_std
    assert as_plain(ours["opened"]) == as_plain(ref["opened"])
    assert as_plain(ours["proof"]) == as_plain(ref["proof"])


@pytest.mark.parametrize("case", list(CASES))
def test_each_verifier_accepts_the_others_proof(proofs, case):
    ours, ref = proofs[case]["ours"], proofs[case]["ref"]
    _verify(_pcs(), _ch, ours)
    _verify(_pcs(), _ch, ref)
    _verify(_jpcs(), _jch, ours)
    _verify(_jpcs(), _jch, ref)


def _wrong_eval(run):
    (root, [(domain, claims)]), = run["claims"]
    z, ys = claims[0]
    ys = list(ys)
    ys[0] = tuple((x + 1) % F.P for x in ys[0])
    return None, [(root, [(domain, [(z, ys)] + claims[1:])])]


def _tampered_input_row(run):
    proof = copy.deepcopy(run["proof"])
    for opening in proof[0].input_openings:
        if opening is not None:
            rows_pq, _ = opening
            rows_pq[0][0][0] = (int(rows_pq[0][0][0]) + 1) % F.P
    return proof, None


def _tampered_final_poly(run):
    proof = copy.deepcopy(run["proof"])
    fp = proof[0].stir_proof.final_polynomial
    fp[0] = tuple((c + 1) % F.P for c in fp[0])
    return proof, None


def _tampered_round_commitment(run):
    proof = copy.deepcopy(run["proof"])
    rp = proof[0].stir_proof.round_proofs[0]
    rp.commitment = tuple((c + 1) % F.P for c in rp.commitment)
    return proof, None


TAMPERS = {"wrong_eval": _wrong_eval,
           "input_row": _tampered_input_row,
           "final_poly": _tampered_final_poly,
           "round_commitment": _tampered_round_commitment}


@pytest.mark.parametrize("tamper", list(TAMPERS))
def test_tamper_raises_the_reference_error(proofs, tamper):
    run = proofs["one_point"]["ours"]
    proof, claims = TAMPERS[tamper](run)
    names = []
    for pcs, challenger in ((_pcs(), _ch), (_jpcs(), _jch)):
        with pytest.raises(Exception) as info:
            _verify(pcs, challenger, run, proof, claims)
        names.append(type(info.value).__name__)
        assert any(c.__name__ == "StirError"
                   for c in type(info.value).__mro__)
    assert names[0] == names[1]


# ---------------------------------------------------------------------------
# the plain STIR protocol (committed initial oracle)
# ---------------------------------------------------------------------------
def test_prove_stir_accepted_by_both_verifiers():
    cfg = StirConfig.new(F, E, ExtensionMmcs(inner=_mmcs(), D=E.D), 6,
                         StirParameters(**PARAMS))
    jcfg = JStirConfig.new(JF, JE, JExtMmcs(inner=_jmmcs(), D=JE.D), 6,
                           JStirParameters(**PARAMS))
    rng = np.random.default_rng(11)
    coeffs = F.to_monty_np(rng.integers(0, F.P, (64, E.D), dtype=np.uint64))
    proof, _ = prove_stir(cfg, torch.from_numpy(coeffs.astype(np.int64)),
                          _ch())
    verify_stir(cfg, proof, _ch())
    j_verify_stir(jcfg, proof, _jch())
    bad = copy.deepcopy(proof)
    bad.final_polynomial[0] = tuple((c + 1) % F.P
                                    for c in bad.final_polynomial[0])
    with pytest.raises(StirError):
        verify_stir(cfg, bad, _ch())


# ---------------------------------------------------------------------------
# host math
# ---------------------------------------------------------------------------
GRID = [(ld, lb, lff, sec, pw, st)
        for ld in (6, 9, 14, 18)
        for lb, lff in ((1, 2), (2, 2), (2, 3), (3, 4))
        for sec, pw in ((60, 12), (100, 16))
        for st in ("capacity", "johnson")]


@pytest.mark.parametrize("lb,lff,sec,pw,st", sorted({g[1:] for g in GRID}))
def test_config_schedule_matches_reference(lb, lff, sec, pw, st):
    for ld in (6, 9, 14, 18):
        if lff > ld:
            continue
        kw = dict(log_blowup=lb, log_folding_factor=lff,
                  security_level=sec, max_pow_bits=pw, soundness_type=st)
        try:
            want = JStirConfig.new(JF, JE, None, ld, JStirParameters(**kw))
        except AssertionError:
            with pytest.raises(ValueError):
                StirConfig.new(F, E, None, ld, StirParameters(**kw))
            continue
        got = StirConfig.new(F, E, None, ld, StirParameters(**kw))
        skip = {"F", "E", "mmcs"}
        for f in dataclasses.fields(want):
            if f.name not in skip:
                assert as_plain(getattr(got, f.name)) == as_plain(
                    getattr(want, f.name)), (ld, f.name)


def _ext(rng, n):
    return [JE.rand_h(rng) for _ in range(n)]


def test_polynomial_algebra_matches_reference():
    rng = np.random.default_rng(3)
    for n in (1, 2, 5, 9):
        poly, pts = _ext(rng, n), _ext(rng, n)
        z = JE.rand_h(rng)
        assert pu.eval_poly(E, poly, z) == ju.eval_poly(JE, poly, z)
        assert pu.divide_by_linear(E, poly, z) == ju.divide_by_linear(
            JE, poly, z)
        assert pu.add_polys(E, poly, pts[:2]) == ju.add_polys(
            JE, poly, pts[:2])
        assert pu.vanishing_poly_from_roots(E, pts) == (
            ju.vanishing_poly_from_roots(JE, pts))
        ans = pu.interpolate_poly(E, pts, poly)
        assert ans == ju.interpolate_poly(JE, pts, poly)
        shake = pu.compute_shake_polynomial(E, ans, pts)
        assert shake == ju.compute_shake_polynomial(JE, ans, pts)
        assert pu.check_shake_consistency(E, ans, shake, pts, poly, z)
        assert ju.check_shake_consistency(JE, ans, shake, pts, poly, z)
        c = int(rng.integers(1, F.P))
        assert pu.reduce_mod_x_pow_minus_c(E, poly, 2, c) == (
            ju.reduce_mod_x_pow_minus_c(JE, poly, 2, c))
        assert pu.eval_degree_correction(E, poly[0], z, pts[0], n) == (
            ju.eval_degree_correction(JE, poly[0], z, pts[0], n))
        xs = [int(x) for x in rng.integers(1, F.P, n)]
        assert pu.lagrange_eval_at(E, xs, poly, z) == ju.lagrange_eval_at(
            JE, xs, poly, z)
    fiber = _ext(rng, 4)
    beta = JE.rand_h(rng)
    assert pu.fold_fiber(E, fiber, 3, 4, 2, beta) == ju.fold_fiber(
        JE, fiber, 3, 4, 2, beta)
    assert pu.next_domain_shift(F, 5, 2) == ju.next_domain_shift(JF, 5, 2)
    assert pu.fold_domain_params(F, 5, 8, 2) == ju.fold_domain_params(
        JF, 5, 8, 2)


@pytest.mark.parametrize("log_arity", [1, 2, 3])
def test_fold_codeword_matches_reference_numpy_fold(log_arity):
    rng = np.random.default_rng(log_arity)
    log_n = 7
    cw = F.to_monty_np(rng.integers(0, F.P, (1 << log_n, E.D),
                                    dtype=np.uint64))
    beta = JE.rand_h(rng)
    want = ju.fold_codeword_np(JE, cw, beta, log_arity, log_n)
    got = pu.fold_codeword(E, torch.from_numpy(cw.astype(np.int64)), beta,
                           log_arity, log_n)
    assert np.array_equal(got.numpy(), np.asarray(want).astype(np.int64))


def test_codeword_round_trip_and_ext_point_eval():
    """codeword_from_coeffs then coeffs_from_codeword gives the
    coefficients back; the codeword's entries are the polynomial's values
    at shift·g^i (the host Horner of the reference)."""
    rng = np.random.default_rng(5)
    coeffs = F.to_monty_np(rng.integers(0, F.P, (8, E.D), dtype=np.uint64))
    ct = torch.from_numpy(coeffs.astype(np.int64))
    shift = F.GENERATOR
    cw = pu.codeword_from_coeffs(E, ct, shift, 5)
    host = [JE.from_monty_np(c) for c in coeffs]
    g = F.two_adic_generator_h(5)
    for i in (0, 1, 17, 31):
        x = JE.from_base_h(F.mul_h(shift, F.exp_h(g, i)))
        assert E.from_monty_np(cw[i].numpy()) == ju.eval_poly(JE, host, x)
    back = pu.coeffs_from_codeword(E, cw, shift)
    assert torch.equal(back[:8], ct) and not back[8:].any()
    z = JE.rand_h(rng)
    assert pu.eval_coeffs_at_ext_point(E, ct, z) == ju.eval_poly(
        JE, host, z)
