"""The port's WHIR (plonky3_tpu_torch/multilinear/whir.py) and its host
math, transcript schemas and plain-torch kernels against the reference's.

The same inputs, made from a seed with numpy, go through both packages:
the WHIR proof at n_vars 6 (k 2) must be equal field for field
(tolerance zero) and each verifier accepts the other's; the reference
tests' tampers raise the same WhirError in both; a verifier under a
wrong schema raises SchemaViolation at the same slot with the same
message; `whir_security`, `WhirConfig.from_security` and its soundness
report agree over a grid. The JAX proof is made once, in a
module-scoped fixture (its XLA compiles take most of this file's time).
`test_torch_whir_k3.py` holds the n_vars 9 (k 3) proof and the kernels.
"""

import copy

import numpy as np
import pytest
import torch

from plonky3_tpu.challenger.duplex import DuplexChallenger as JDuplex
from plonky3_tpu.challenger import schema as jschema
from plonky3_tpu.fields import KoalaBear as JF
from plonky3_tpu.fields import KoalaBearExt4 as JE
from plonky3_tpu.hashes.poseidon2 import default_poseidon2 as j_poseidon2
from plonky3_tpu.hashes.sponge import PaddingFreeSponge as JSponge
from plonky3_tpu.hashes.sponge import TruncatedPermutation as JCompress
from plonky3_tpu.merkle.extension_mmcs import ExtensionMmcs as JExtMmcs
from plonky3_tpu.merkle.mmcs import MerkleTreeMmcs as JMmcs
from plonky3_tpu.multilinear import whir as jwhir
from plonky3_tpu.multilinear import whir_security as jsec
from plonky3_tpu_torch.challenger import schema
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
from plonky3_tpu_torch.multilinear import whir
from plonky3_tpu_torch.multilinear import whir_security as sec
from test_torch_stir import as_plain

CASES = {"n6_k2": (6, 2, 2), "n9_k3": (9, 3, 3)}


def _cfg(mod, case):
    n_vars, k, final = CASES[case]
    return mod.WhirConfig(log_blowup=2, folding_factor=k, final_vars=final,
                          num_queries=8, ood_samples=1, pow_bits=2)


def _pcs(case, cfg=None):
    m = MerkleTreeMmcs(
        sponge=PaddingFreeSponge(default_poseidon2(F, 24), rate=16, out=8),
        compressor=TruncatedPermutation(default_poseidon2(F, 16), chunk=8))
    return whir.WhirPcs(F=F, E=E, config=cfg or _cfg(whir, case), mmcs=m,
                        fri_mmcs=ExtensionMmcs(inner=m, D=E.D))


def _jpcs(case, cfg=None):
    m = JMmcs(sponge=JSponge(j_poseidon2(JF, 24), rate=16, out=8),
              compressor=JCompress(j_poseidon2(JF, 16), chunk=8))
    return jwhir.WhirPcs(F=JF, E=JE, config=cfg or _cfg(jwhir, case),
                         mmcs=m, fri_mmcs=JExtMmcs(inner=m, D=JE.D))


def _ch():
    return DuplexChallenger(default_poseidon2(F, 24), rate=16)


def _jch():
    return JDuplex(j_poseidon2(JF, 24), rate=16)


def _inputs(case):
    n_vars = CASES[case][0]
    rng = np.random.default_rng(n_vars)
    evals = F.rand_np(rng, (1 << n_vars,), monty=False)
    point = [JE.rand_h(rng) for _ in range(n_vars)]
    return n_vars, evals, point


def _observed(challenger, commit, point):
    ch = challenger()
    ch.observe_digest(commit)
    for p in point:
        ch.observe_ext(p)
    return ch


def _prove(case, pcs, challenger):
    n_vars, evals, point = _inputs(case)
    # the port commits a tensor; the reference a numpy array
    if isinstance(pcs, whir.WhirPcs):
        evals = torch.from_numpy(evals.astype(np.int64))
    commit, data = pcs.commit(evals)
    value, proof = pcs.open(data, point, _observed(challenger, commit, point))
    return dict(commit=commit, value=value, proof=proof, point=point,
                n_vars=n_vars)


def both_proofs(case):
    return dict(ours=_prove(case, _pcs(case), _ch),
                ref=_prove(case, _jpcs(case), _jch))


@pytest.fixture(scope="module")
def proofs():
    return {"n6_k2": both_proofs("n6_k2")}


def _verify(pcs, challenger, run, proof=None, value=None):
    pcs.verify(run["commit"], run["n_vars"], run["point"],
               run["value"] if value is None else value,
               run["proof"] if proof is None else proof,
               _observed(challenger, run["commit"], run["point"]))


def check_equal(ours, ref, case):
    """The port's WHIR run equals the reference's field for field."""
    assert ours["commit"] == ref["commit"]
    assert ours["value"] == ref["value"]
    assert as_plain(ours["proof"]) == as_plain(ref["proof"])
    # the value is the MLE at the point (host oracle)
    _, evals, point = _inputs(case)
    coeffs = [JE.from_base_h(int(c))
              for c in jwhir.evals_to_coeffs_np(JF, evals)]
    assert ours["value"] == jwhir.eval_multilinear_coeffs(JE, coeffs, point)


def check_cross_verify(runs, case):
    """Both verifiers accept both packages' proofs."""
    for run in runs.values():
        _verify(_pcs(case), _ch, run)
        _verify(_jpcs(case), _jch, run)


def test_whir_proof_equals_reference(proofs):
    check_equal(proofs["n6_k2"]["ours"], proofs["n6_k2"]["ref"], "n6_k2")


def test_each_verifier_accepts_the_others_proof(proofs):
    check_cross_verify(proofs["n6_k2"], "n6_k2")


def _bump(e):
    return tuple((c + 1) % F.P for c in e)


def _final_poly(proof):
    proof.final_poly[0] = _bump(proof.final_poly[0])


def _ood(proof):
    proof.rounds[0].ood_values[0] = _bump(proof.rounds[0].ood_values[0])


def _query_values(proof):
    g = list(proof.rounds[0].query_values[0])
    g[0] = _bump(g[0])
    proof.rounds[0].query_values[0] = g


def _sumcheck_poly(proof):
    s = list(proof.rounds[0].sumcheck_polys[0])
    s[2] = _bump(s[2])
    proof.rounds[0].sumcheck_polys[0] = s


def _pow_witness(proof):
    proof.rounds[0].pow_witness += 1


TAMPERS = {"final_poly": _final_poly, "ood": _ood,
           "query_values": _query_values, "sumcheck_poly": _sumcheck_poly,
           "pow_witness": _pow_witness, "value": None}


@pytest.mark.parametrize("tamper", list(TAMPERS))
def test_tamper_raises_the_reference_error(proofs, tamper):
    run = proofs["n6_k2"]["ours"]
    proof, value = copy.deepcopy(run["proof"]), None
    if TAMPERS[tamper] is None:
        value = _bump(run["value"])
    else:
        TAMPERS[tamper](proof)
    raised = []
    for pcs, challenger in ((_pcs("n6_k2"), _ch), (_jpcs("n6_k2"), _jch)):
        with pytest.raises(Exception) as info:
            _verify(pcs, challenger, run, proof, value)
        raised.append((type(info.value).__name__, str(info.value)))
    assert raised[0] == raised[1]
    assert raised[0][0] == "WhirError"


@pytest.mark.parametrize("drop", [0, 5, 17])
def test_schema_violation_at_the_same_slot(proofs, drop):
    """The verifier under a schema with one slot taken out raises
    SchemaViolation where the reference's does, with its message."""
    run = proofs["n6_k2"]["ours"]
    raised = []
    for mod, pcs, challenger in ((schema, _pcs("n6_k2"), _ch),
                                 (jschema, _jpcs("n6_k2"), _jch)):
        bad = mod.whir_schema(pcs.config, run["n_vars"])
        del bad.ops[drop]
        ch = mod.SchemaChallenger(
            _observed(challenger, run["commit"], run["point"]), bad)
        with pytest.raises(mod.SchemaViolation) as info:
            pcs.verify(run["commit"], run["n_vars"], run["point"],
                       run["value"], run["proof"], ch)
        raised.append(str(info.value))
    assert raised[0] == raised[1]


def test_schema_challenger_passes_and_finishes():
    for mod in (schema, jschema):
        s = mod.TranscriptSchema("t").observe("a", 2).sample_ext("b")
        ch = mod.SchemaChallenger(_ch(), s)
        ch.observe(1)
        with pytest.raises(mod.SchemaViolation):
            ch.finish()
        ch.observe(2)
        ch.sample_ext(4)
        ch.finish()
        with pytest.raises(mod.SchemaViolation):
            ch.observe(3)


def test_from_security_schedule_and_open():
    """A security-derived schedule (the pcs-comparison's) proves and
    both verifiers accept."""
    kw = dict(log_blowup=2, folding_factor=2, final_vars=2, max_pow_bits=8)
    cfg = whir.WhirConfig.from_security(60, "johnson", 6, 4 * 31, **kw)
    jcfg = jwhir.WhirConfig.from_security(60, "johnson", 6, 4 * 31, **kw)
    assert as_plain(cfg) == as_plain(jcfg)
    run = dict(n_vars=6)
    _, evals, run["point"] = _inputs("n6_k2")
    pcs = _pcs("n6_k2", cfg)
    run["commit"], data = pcs.commit(torch.from_numpy(
        evals.astype(np.int64)))
    run["value"], run["proof"] = pcs.open(
        data, run["point"], _observed(_ch, run["commit"], run["point"]))
    _verify(pcs, _ch, run)
    _verify(_jpcs("n6_k2", jcfg), _jch, run)


# ---------------------------------------------------------------------------
# host math
# ---------------------------------------------------------------------------
ASSUMPTIONS = ("unique", "johnson", "capacity")


@pytest.mark.parametrize("a", ASSUMPTIONS)
def test_whir_security_matches_reference(a):
    for lr in (1, 2, 3, 5):
        for ld in (6, 14, 22):
            for fb in (124, 128):
                if a != "unique":
                    assert sec.log_eta(a, lr) == jsec.log_eta(a, lr)
                    assert sec.ood_error(a, ld, lr, fb, 2) == (
                        jsec.ood_error(a, ld, lr, fb, 2))
                    assert sec.determine_ood_samples(a, 100, ld, lr, fb) == (
                        jsec.determine_ood_samples(a, 100, ld, lr, fb))
                for fn in (
                        lambda m: m.list_size_bits(a, ld, lr),
                        lambda m: m.log_1_delta(a, lr),
                        lambda m: m.queries(a, 84, lr),
                        lambda m: m.queries_error(a, lr, 40),
                        lambda m: m.prox_gaps_error(a, ld, lr, fb, 3),
                        lambda m: m.fold_sumcheck_error(a, fb, ld, lr),
                        lambda m: m.queries_combination_error(
                            a, fb, ld, lr, 1, 40),
                        lambda m: m.folding_pow_bits(a, 100, fb, ld, lr)):
                    assert fn(sec) == fn(jsec)


@pytest.mark.parametrize("a", ("johnson", "capacity"))
@pytest.mark.parametrize("bits,max_pow", [(60, 8), (100, 16), (128, 20)])
def test_from_security_matches_reference(a, bits, max_pow):
    for n_vars in (6, 9, 21, 22):
        for lb, k in ((1, 2), (2, 2), (2, 3), (3, 4)):
            kw = dict(log_blowup=lb, folding_factor=k, max_pow_bits=max_pow)
            try:
                want = jwhir.WhirConfig.from_security(bits, a, n_vars, 124,
                                                      **kw)
            except (AssertionError, ValueError):
                with pytest.raises(ValueError):
                    whir.WhirConfig.from_security(bits, a, n_vars, 124, **kw)
                continue
            got = whir.WhirConfig.from_security(bits, a, n_vars, 124, **kw)
            assert as_plain(got) == as_plain(want)
            assert got.soundness_report(n_vars, 124) == (
                want.soundness_report(n_vars, 124))


def test_multilinear_host_helpers_match_reference():
    rng = np.random.default_rng(9)
    n = 4
    coeffs = [JE.rand_h(rng) for _ in range(1 << n)]
    pt = [JE.rand_h(rng) for _ in range(n)]
    assert whir.coeffs_to_evals_ext(E, coeffs) == jwhir.coeffs_to_evals_ext(
        JE, coeffs)
    assert whir.eval_multilinear_coeffs(E, coeffs, pt) == (
        jwhir.eval_multilinear_coeffs(JE, coeffs, pt))
    assert whir.eval_univariate(E, coeffs, pt[0]) == jwhir.eval_univariate(
        JE, coeffs, pt[0])
    assert whir.power_point(E, pt[0], 5) == jwhir.power_point(JE, pt[0], 5)
    assert whir.eq_factor(E, pt, pt[::-1]) == jwhir.eq_factor(JE, pt,
                                                             pt[::-1])
    assert whir.eq_table(E, pt) == jwhir.eq_table(JE, pt)
    assert whir._lagrange_012(E, pt[:3], pt[3]) == jwhir._lagrange_012(
        JE, pt[:3], pt[3])
    group = coeffs[:8]
    assert whir.fold_group(E, F, group, 5, 9, pt[:3]) == jwhir.fold_group(
        JE, JF, group, 5, 9, pt[:3])
    assert whir._group_base_point(F, 5, 9, 3) == jwhir._group_base_point(
        JF, 5, 9, 3)
    evals = F.rand_np(rng, (64,), monty=False)
    got = whir.evals_to_coeffs(F, torch.from_numpy(evals.astype(np.int64)))
    assert np.array_equal(got.numpy(), jwhir.evals_to_coeffs_np(
        JF, evals).astype(np.int64))
