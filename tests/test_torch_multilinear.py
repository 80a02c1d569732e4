"""The port's zerocheck and multilinear STARK (plonky3_tpu_torch/
multilinear/sumcheck.py, multi_stark.py) against the reference's.

The same seeded inputs go through both packages, and the proofs must be
equal field for field (tolerance zero): the zerocheck of a
transition-only AIR at n_vars 5, and the multilinear STARK of that AIR
at 2^3 rows under WHIR. Each verifier accepts the other's proofs, and on
the reference tests' tampers both raise the same error. FibonacciAir at
2^5 rows (first-row, transition and last-row constraints, three public
values): the port's proof is accepted by both verifiers and a changed
public value is rejected by both; its equality with the JAX proof is
`-m slow`. The host helpers (the shift kernel, the product sumchecks,
the setup keys, the transcript schema) agree with the reference's.

The JAX proofs are made once, in module-scoped fixtures. Their zerocheck
runs under `jax.disable_jit()`: jitted, every round shape of the round
kernel compiles for tens of seconds on this CPU (the reference's own
multi-stark tests take 72-78 s each). Op by op, a round costs about a
second for the one-constraint AIR here and about 20 s for FibonacciAir,
so the FibonacciAir comparison (about 2 minutes) is `-m slow`. The WHIR
part stays jitted.
"""

import copy

import jax
import numpy as np
import pytest
import torch

from plonky3_tpu.challenger import schema as jschema
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
from plonky3_tpu.air.api import BaseAir as JBaseAir
from plonky3_tpu.multilinear import multi_stark as jms
from plonky3_tpu.multilinear.mle import eval_mle_host as j_eval_mle_host
from plonky3_tpu.multilinear import sumcheck as jsc
from plonky3_tpu.multilinear import whir as jwhir
from plonky3_tpu_torch.air.api import BaseAir
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
from plonky3_tpu_torch.models.fibonacci import (
    FibonacciAir,
    generate_fibonacci_trace,
)
from plonky3_tpu_torch.multilinear import eval_mle_host
from plonky3_tpu_torch.multilinear import multi_stark as ms
from plonky3_tpu_torch.multilinear import sumcheck as sc
from plonky3_tpu_torch.multilinear import whir
from test_torch_stir import as_plain

LOG_N = 5
CFG = dict(log_blowup=1, folding_factor=2, final_vars=2, num_queries=4,
           ood_samples=1, pow_bits=2)


def _pcs():
    m = MerkleTreeMmcs(
        sponge=PaddingFreeSponge(default_poseidon2(F, 24), rate=16, out=8),
        compressor=TruncatedPermutation(default_poseidon2(F, 16), chunk=8))
    return whir.WhirPcs(F=F, E=E, config=whir.WhirConfig(**CFG), mmcs=m,
                        fri_mmcs=ExtensionMmcs(inner=m, D=E.D))


def _jpcs():
    m = JMmcs(sponge=JSponge(j_poseidon2(JF, 24), rate=16, out=8),
              compressor=JCompress(j_poseidon2(JF, 16), chunk=8))
    return jwhir.WhirPcs(F=JF, E=JE, config=jwhir.WhirConfig(**CFG), mmcs=m,
                         fri_mmcs=JExtMmcs(inner=m, D=JE.D))


def _ch():
    return DuplexChallenger(default_poseidon2(F, 24), rate=16)


def _jch():
    return JDuplex(j_poseidon2(JF, 24), rate=16)


def _cyclic_air(base):
    """The reference tests' transition-only AIR over either package's
    BaseAir: next[0] = local[1], the next row wrapping."""

    class CyclicFibAir(base):
        width = 2
        num_public_values = 0

        def eval(self, b):
            b.when_transition().assert_eq(b.main.local[1], b.main.next[0])

    return CyclicFibAir()


def _cyclic_trace(log_n):
    rng = np.random.default_rng(7)
    c0 = F.rand_np(rng, (1 << log_n,), monty=False)
    return np.stack([c0, np.roll(c0, -1)], axis=1).astype(np.uint32)


def _monty(trace_std):
    return torch.from_numpy(F.to_monty_np(trace_std).astype(np.int64))


def _op_by_op(fn):
    def run(*args, **kw):
        with jax.disable_jit():
            return fn(*args, **kw)

    return run


def _j_prove(pcs, air, trace, publics):
    """The reference's prove_multi_stark with its zerocheck op by op."""
    jitted = jms.prove_zerocheck
    jms.prove_zerocheck = _op_by_op(jitted)
    try:
        return jms.prove_multi_stark(pcs, air, trace, publics, _jch())
    finally:
        jms.prove_zerocheck = jitted


@pytest.fixture(scope="module")
def zerocheck():
    trace = _cyclic_trace(5)
    ours = sc.prove_zerocheck(E, _cyclic_air(BaseAir), _monty(trace), [],
                              _ch())
    ref = _op_by_op(jsc.prove_zerocheck)(JE, _cyclic_air(JBaseAir), trace,
                                         [], _jch())
    return dict(ours=ours, ref=ref, trace=trace)


def test_zerocheck_equals_reference(zerocheck):
    assert as_plain(zerocheck["ours"]) == as_plain(zerocheck["ref"])
    # the claimed openings are the trace's MLEs at the bound point
    _, local, nxt, chs = zerocheck["ours"]
    trace = zerocheck["trace"]
    for j in range(2):
        col = [int(x) for x in trace[:, j]]
        assert j_eval_mle_host(JE, col, chs) == local[j]
        assert eval_mle_host(E, col, chs) == local[j]
        assert j_eval_mle_host(JE, col[1:] + col[:1], chs) == nxt[j]


@pytest.mark.parametrize("which", ["ours", "ref"])
def test_zerocheck_verifiers_accept(zerocheck, which):
    proof, local, nxt, chs = zerocheck[which]
    assert sc.verify_zerocheck(E, _cyclic_air(BaseAir), 5, [], proof, local,
                               nxt, _ch()) == chs
    assert jsc.verify_zerocheck(JE, _cyclic_air(JBaseAir), 5, [], proof,
                                local, nxt, _jch()) == chs


@pytest.mark.parametrize("tamper", ["round_poly", "opening"])
def test_zerocheck_tamper_raises_the_reference_error(zerocheck, tamper):
    proof, local, nxt, _ = copy.deepcopy(zerocheck["ours"])
    if tamper == "round_poly":
        proof.round_polys[1][0] = _bump(proof.round_polys[1][0])
    else:
        nxt[0] = _bump(nxt[0])
    raised = []
    for mod, air, ch in ((sc, _cyclic_air(BaseAir), _ch),
                         (jsc, _cyclic_air(JBaseAir), _jch)):
        with pytest.raises(ValueError) as info:
            mod.verify_zerocheck(E, air, 5, [], proof, local, nxt, ch())
        raised.append(str(info.value))
    assert raised[0] == raised[1]


@pytest.fixture(scope="module")
def proofs():
    trace = _cyclic_trace(3)
    pcs, air = _pcs(), _cyclic_air(BaseAir)
    pk, vk = ms.setup(pcs, air)
    ours = ms.prove_multi_stark(pcs, air, _monty(trace), [], _ch(), pk=pk)
    ref = _j_prove(_jpcs(), _cyclic_air(JBaseAir), trace, [])
    return dict(ours=ours, ref=ref, publics=[], vk=vk)


@pytest.fixture(scope="module")
def fibonacci():
    trace, publics = generate_fibonacci_trace(F, LOG_N, device="cpu")
    j_trace, j_publics = j_generate(JF, LOG_N)
    assert publics == j_publics
    assert np.array_equal(F.from_monty_tensor(trace).numpy(),
                          j_trace.astype(np.int64))
    proof = ms.prove_multi_stark(_pcs(), FibonacciAir(F), trace, publics,
                                 _ch())
    return dict(ours=proof, publics=publics, j_trace=j_trace)


def test_multi_stark_proof_equals_reference(proofs):
    assert as_plain(proofs["ours"]) == as_plain(proofs["ref"])


@pytest.mark.slow
def test_fibonacci_multi_stark_proof_equals_reference(fibonacci):
    ref = _j_prove(_jpcs(), JFibonacciAir(JF), fibonacci["j_trace"],
                   fibonacci["publics"])
    assert as_plain(fibonacci["ours"]) == as_plain(ref)


@pytest.mark.parametrize("which", ["ours", "ref"])
def test_each_verifier_accepts_the_proof(proofs, which):
    proof = proofs[which]
    ms.verify_multi_stark(_pcs(), _cyclic_air(BaseAir), proof, [], _ch(),
                          vk=proofs["vk"])
    jms.verify_multi_stark(_jpcs(), _cyclic_air(JBaseAir), proof, [],
                           _jch())


def test_both_verifiers_accept_the_fibonacci_proof(fibonacci):
    ms.verify_multi_stark(_pcs(), FibonacciAir(F), fibonacci["ours"],
                          fibonacci["publics"], _ch())
    jms.verify_multi_stark(_jpcs(), JFibonacciAir(JF), fibonacci["ours"],
                           fibonacci["publics"], _jch())


def _bump(e):
    return tuple((c + 1) % F.P for c in e)


def _shift_local(proof, publics):
    proof.shift_locals[0] = _bump(proof.shift_locals[0])


def _zc_local(proof, publics):
    proof.zc_local[1] = _bump(proof.zc_local[1])


def _colbind(proof, publics):
    proof.colbind_polys[1][0][1] = _bump(proof.colbind_polys[1][0][1])


def _whir_value(proof, publics):
    value, wproof = proof.whir_openings[0]
    proof.whir_openings[0] = (_bump(value), wproof)


TAMPERS = {"shift_local": _shift_local,
           "zc_local": _zc_local, "colbind_poly": _colbind,
           "whir_value": _whir_value}


def _raised_by_both(proof, publics, port_air, ref_air):
    raised = []
    for mod, pcs, air, ch in ((ms, _pcs(), port_air, _ch),
                              (jms, _jpcs(), ref_air, _jch)):
        with pytest.raises(Exception) as info:
            mod.verify_multi_stark(pcs, air, proof, publics, ch())
        raised.append((type(info.value).__name__, str(info.value)))
    assert raised[0] == raised[1]


@pytest.mark.parametrize("tamper", list(TAMPERS))
def test_tamper_raises_the_reference_error(proofs, tamper):
    proof, publics = copy.deepcopy(proofs["ours"]), []
    TAMPERS[tamper](proof, publics)
    _raised_by_both(proof, publics, _cyclic_air(BaseAir),
                    _cyclic_air(JBaseAir))


@pytest.mark.parametrize("index", [0, 1, 2])
def test_changed_public_value_rejected_by_both(fibonacci, index):
    publics = list(fibonacci["publics"])
    publics[index] = (publics[index] + 1) % F.P
    _raised_by_both(fibonacci["ours"], publics, FibonacciAir(F),
                    JFibonacciAir(JF))


def test_bad_trace_is_caught():
    """A trace that breaks only the first-row constraint gives a proof
    that the verifier rejects."""
    trace, publics = generate_fibonacci_trace(F, 3, device="cpu")
    trace[0, 0] = (trace[0, 0] + F.R) % F.P
    pcs, air = _pcs(), FibonacciAir(F)
    proof = ms.prove_multi_stark(pcs, air, trace, publics, _ch())
    with pytest.raises(ValueError):
        ms.verify_multi_stark(pcs, air, proof, publics, _ch())


# ---------------------------------------------------------------------------
# host helpers
# ---------------------------------------------------------------------------
def test_setup_and_schema_match_reference():
    pk, vk = ms.setup(_pcs(), FibonacciAir(F))
    jpk, jvk = jms.setup(_jpcs(), JFibonacciAir(JF))
    assert as_plain(vk) == as_plain(jvk) and vk.max_ml_degree == 2
    for air, j_air in ((FibonacciAir(F), JFibonacciAir(JF)),
                       (_cyclic_air(BaseAir), _cyclic_air(JBaseAir))):
        assert sc.get_ml_layout(air) == jsc.get_ml_layout(j_air)
    got = schema.multi_stark_schema(_pcs().config, FibonacciAir(F), LOG_N,
                                    1, 3)
    want = jschema.multi_stark_schema(_jpcs().config, JFibonacciAir(JF),
                                      LOG_N, 1, 3)
    assert got.ops == want.ops


@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_shift_kernel_matches_reference(n):
    rng = np.random.default_rng(n)
    x = [JE.rand_h(rng) for _ in range(n)]
    y = [JE.rand_h(rng) for _ in range(n)]
    assert ms.shift_kernel_at(E, x, y) == jms.shift_kernel_at(JE, x, y)
    assert ms.shift_kernel_table(E, x, n) == jms.shift_kernel_table(JE, x, n)
    # the table's MLE at y is the closed form
    et = whir.eq_table(E, y)
    mle = E.zero_h()
    for i, t in enumerate(ms.shift_kernel_table(E, x, n)):
        mle = E.add_h(mle, E.mul_h(et[i], t))
    assert mle == ms.shift_kernel_at(E, x, y)


@pytest.mark.parametrize("log_n", [1, 3, 5])
def test_product_sumchecks_match_reference(log_n):
    rng = np.random.default_rng(log_n)
    a = [JE.rand_h(rng) for _ in range(1 << log_n)]
    b = [JE.rand_h(rng) for _ in range(1 << log_n)]
    want = jms.prove_product_sumcheck(JE, a, b, _jch())
    t = lambda v: torch.from_numpy(F.to_monty_np(  # noqa: E731
        np.asarray(v, np.uint64)).astype(np.int64))
    assert ms.prove_product_sumcheck_device(E, t(a), t(b), _ch()) == want
    claim = E.zero_h()
    for x, y in zip(a, b):
        claim = E.add_h(claim, E.mul_h(x, y))
    point, final = ms.verify_product_sumcheck(E, claim, want[0], _ch())
    assert (point, final) == jms.verify_product_sumcheck(JE, claim, want[0],
                                                         _jch())
    assert final == E.mul_h(want[2], want[3])
    assert ms._gamma_table(E, a[0], 3, 4) == jms._gamma_table(JE, a[0], 3, 4)
