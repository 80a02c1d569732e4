"""The port's masked (HVZK) zerocheck (plonky3_tpu_torch/multilinear/
zk_sumcheck.py) against the reference's.

FibonacciAir at log_n 4 (first-row, transition and last-row constraints,
three public values) with the mask PCS sized as tests/test_zk_multilinear.py
sizes it (`_mask_pcs_for`): the same seeded masks and hiding-WHIR draws go
through both packages, and the MaskedZerocheckProof must be equal field
for field (tolerance zero). The proof carries the mask oracle's batched
`open_hiding_multi` proof, so that opening is held against the
reference's too, and each package's `verify_hiding_multi` checks it
inside its verifier. Each verifier accepts the other's proof; a changed
wire, mask value or mask-opening value raises the same error in both. Two
proofs of the same statement share no wire (the reference's
`test_masked_zerocheck_wires_hide_the_trace`). The JAX proof is made once,
in a module-scoped fixture; it takes about 85 s on an 8-core CPU (the hiding
WHIR's XLA compiles), so the three tests that need it are `-m slow`, and
tier 1 holds the port's proof against the reference's verifier (both
verifiers accept it and raise the same error on every tamper).
"""

import copy

import numpy as np
import pytest

from plonky3_tpu.challenger.duplex import DuplexChallenger as JDuplex
from plonky3_tpu.fields import KoalaBear as JF
from plonky3_tpu.fields import KoalaBearExt4 as JE
from plonky3_tpu.hashes.poseidon2 import default_poseidon2 as j_poseidon2
from plonky3_tpu.hashes.sponge import PaddingFreeSponge as JSponge
from plonky3_tpu.hashes.sponge import TruncatedPermutation as JCompress
from plonky3_tpu.merkle.extension_mmcs import ExtensionMmcs as JExtMmcs
from plonky3_tpu.merkle.mmcs import MerkleTreeMmcs as JMmcs
from plonky3_tpu.models.fibonacci import FibonacciAir as JFibonacciAir
from plonky3_tpu.models.fibonacci import (
    generate_fibonacci_trace as j_generate,
)
from plonky3_tpu.multilinear import hiding_whir as jhw
from plonky3_tpu.multilinear import whir as jwhir
from plonky3_tpu.multilinear import zk_sumcheck as jzk
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
from plonky3_tpu_torch.models.fibonacci import (
    FibonacciAir,
    generate_fibonacci_trace,
)
from plonky3_tpu_torch.multilinear import (
    prove_masked_zerocheck,
    verify_masked_zerocheck,
)
from plonky3_tpu_torch.multilinear import hiding_whir as hw
from plonky3_tpu_torch.multilinear import whir
from plonky3_tpu_torch.multilinear import zk_sumcheck as zk
from test_torch_stir import as_plain

LOG_N = 4


def _cfg(mod, air_vars):
    _, _, _, flat_len = zk._mask_layout(E, air_vars, 4)
    n1 = flat_len.bit_length() - 1 + 1  # the committed vars, zk var too
    k = 2
    return mod.WhirConfig(log_blowup=2, folding_factor=k,
                          final_vars=n1 % k if n1 % k else k, num_queries=6,
                          ood_samples=1, pow_bits=1)


def mask_pcs():
    """tests/test_zk_multilinear.py::_mask_pcs_for(LOG_N), the port's."""
    m = MerkleTreeMmcs(
        sponge=PaddingFreeSponge(default_poseidon2(F, 24), rate=16, out=8),
        compressor=TruncatedPermutation(default_poseidon2(F, 16), chunk=8))
    return hw.HidingWhirPcs(F=F, E=E, config=_cfg(whir, LOG_N), mmcs=m,
                            fri_mmcs=ExtensionMmcs(inner=m, D=E.D))


def j_mask_pcs():
    m = JMmcs(sponge=JSponge(j_poseidon2(JF, 24), rate=16, out=8),
              compressor=JCompress(j_poseidon2(JF, 16), chunk=8))
    return jhw.HidingWhirPcs(F=JF, E=JE, config=_cfg(jwhir, LOG_N),
                             mmcs=m, fri_mmcs=JExtMmcs(inner=m, D=JE.D))


def ch():
    return DuplexChallenger(default_poseidon2(F, 24), rate=16)


def jch():
    return JDuplex(j_poseidon2(JF, 24), rate=16)


def prove(seed):
    trace, publics = generate_fibonacci_trace(F, LOG_N, device="cpu")
    proof = prove_masked_zerocheck(E, FibonacciAir(F), trace, publics, ch(),
                                   mask_pcs(), np.random.default_rng(seed))
    return proof, publics


def j_prove(seed):
    trace, publics = j_generate(JF, LOG_N)
    proof = jzk.prove_masked_zerocheck(
        JE, JFibonacciAir(JF), trace.astype(np.uint64), publics, jch(),
        j_mask_pcs(), np.random.default_rng(seed))
    return proof, publics


@pytest.fixture(scope="module")
def proofs():
    return {"ours": prove(11)}


@pytest.fixture(scope="module")
def ref_proof():
    return j_prove(11)


def verify(package, proof, publics):
    if package == "ours":
        return verify_masked_zerocheck(E, FibonacciAir(F), LOG_N, publics,
                                       proof, ch(), mask_pcs())
    return jzk.verify_masked_zerocheck(JE, JFibonacciAir(JF), LOG_N,
                                       publics, proof, jch(), j_mask_pcs())


@pytest.mark.slow
def test_proof_equals_reference(proofs, ref_proof):
    (ours, publics), (ref, jpublics) = proofs["ours"], ref_proof
    assert [int(p) for p in publics] == [int(p) for p in jpublics]
    assert as_plain(ours) == as_plain(ref)


@pytest.mark.slow
def test_mask_opening_equals_reference(proofs, ref_proof):
    """The batched hiding-WHIR opening of the masks (open_hiding_multi),
    its round 0 paired."""
    ours = proofs["ours"][0].mask_opening
    assert as_plain(ours) == as_plain(ref_proof[0].mask_opening)
    assert ours.inner.rounds[0].query_proof[0] == "paired"


@pytest.mark.parametrize("verifier", ["ours", "ref"])
def test_each_verifier_accepts_the_ports_proof(proofs, verifier):
    """The port's proof (its mask opening through each package's
    verify_hiding_multi) is accepted by both verifiers."""
    proof, publics = proofs["ours"]
    chs = verify(verifier, proof, publics)
    assert len(chs) == LOG_N


@pytest.mark.slow
def test_the_ports_verifier_accepts_the_reference_proof(ref_proof):
    proof, publics = ref_proof
    assert len(verify("ours", proof, publics)) == LOG_N


def _bump(e):
    return tuple((c + 1) % F.P for c in e)


def _wire(p):
    p.rounds[0][0] = _bump(p.rounds[0][0])


def _last_wire(p):
    p.rounds[-1][-1] = _bump(p.rounds[-1][-1])


def _mask_value(p):
    p.mask_values[0][0] = _bump(p.mask_values[0][0])


def _mu(p):
    p.mu = _bump(p.mu)


def _opening_v_mask(p):
    p.mask_opening.v_mask = _bump(p.mask_opening.v_mask)


def _final_local(p):
    p.final_local[0] = _bump(p.final_local[0])


TAMPERS = {"wire": _wire, "last_wire": _last_wire, "mask_value": _mask_value,
           "mu": _mu, "opening_v_mask": _opening_v_mask,
           "final_local": _final_local}


@pytest.mark.parametrize("tamper", list(TAMPERS))
def test_tamper_raises_the_reference_error(proofs, tamper):
    proof, publics = proofs["ours"]
    bad = copy.deepcopy(proof)
    bad.rounds = [list(r) for r in bad.rounds]
    bad.mask_values = [list(c) for c in bad.mask_values]
    bad.final_local = list(bad.final_local)
    TAMPERS[tamper](bad)
    raised = []
    for package in ("ours", "ref"):
        with pytest.raises(Exception) as info:
            verify(package, bad, publics)
        raised.append((type(info.value).__name__, str(info.value)))
    assert raised[0] == raised[1]
    assert raised[0][0] in ("ValueError", "WhirError")


def test_wires_hide_the_trace():
    """Two proofs of the same statement have entirely different wires (the
    one-time masks): nothing of the trace leaks through them."""
    p1, _ = prove(21)
    p2, _ = prove(22)
    assert p1.mu != p2.mu
    for r1, r2 in zip(p1.rounds, p2.rounds):
        assert all(a != b for a, b in zip(r1, r2))
    assert p1.mask_values != p2.mask_values


@pytest.mark.parametrize("n", [1, 2, 4, 5, 20])
@pytest.mark.parametrize("ell", [2, 3, 4, 5])
def test_mask_layout_equals_reference(n, ell):
    assert zk._mask_layout(E, n, ell) == jzk._mask_layout(JE, n, ell)
