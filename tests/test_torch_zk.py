"""Zero knowledge in plonky3_tpu_torch against plonky3_tpu's
(`stark/zk.py`, `fri/hiding_pcs.py`, `merkle/hiding_mmcs.py`,
`zk_stark_config`): with the same seed the port's FibonacciAir proof at
log_n 3 equals the JAX `prove`'s under `new_testing()` (under
`new_benchmark_high_arity()` in test_torch_zk_high_arity.py), each
verifier accepts the other package's proof, and a tampered copy (public
values, the random opening, an opened trace value, a random codeword, a
salt, no R) raises the same error class with the same message in both
verifiers. The hiding PCS's three commits give the reference's roots at
small shapes; two seeds give two sets of roots; an AIR with its own fold
raises in both packages; the fast prover refuses a ZK config; the ZK
chunk count is the reference's for FibonacciAir. Every comparison is
exact."""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plonky3_tpu.fields import KoalaBear as JF
from plonky3_tpu.fields import KoalaBearExt4 as JE
from plonky3_tpu.fri.config import FriParameters as JFriParameters
from plonky3_tpu.models.fibonacci import FibonacciAir as JFibonacciAir
from plonky3_tpu.models.fibonacci import (
    generate_fibonacci_trace as j_fibonacci_trace,
)
from plonky3_tpu.models.poseidon2_air import Poseidon2VectorAir as JP2Air
from plonky3_tpu.models.poseidon2_air import (
    generate_vectorized_trace as j_generate,
)
from plonky3_tpu.stark.config import zk_stark_config as j_zk_config
from plonky3_tpu.stark.prover import prove as j_prove
from plonky3_tpu.stark.verifier import verify as j_verify
from plonky3_tpu_torch.compat import fri_params_from, trace_inputs_from_numpy
from plonky3_tpu_torch.fields import KoalaBear as F
from plonky3_tpu_torch.fields import KoalaBearExt4 as E
from plonky3_tpu_torch.models.fibonacci import (
    FibonacciAir,
    generate_fibonacci_trace,
)
from plonky3_tpu_torch.models.poseidon2_air import (
    Poseidon2VectorAir,
    generate_vectorized_trace,
)
from plonky3_tpu_torch.stark import fast_prover
from plonky3_tpu_torch.stark.config import zk_stark_config
from plonky3_tpu_torch.stark.prover import prove
from plonky3_tpu_torch.stark.verifier import VerificationError, verify
from test_torch_prove import _raised, as_plain, to_port, to_reference

LOG_N = 3
PARAMS = {"testing": JFriParameters.new_testing(),
          "high_arity": JFriParameters.new_benchmark_high_arity()}
_PROOFS = {}


def _config(name, seed):
    return zk_stark_config(F, E, fri_params_from(PARAMS[name]), seed=seed,
                           device="cpu")


def _port_proof(name, seed):
    trace, publics = generate_fibonacci_trace(F, LOG_N, device="cpu")
    return prove(_config(name, seed), FibonacciAir(F), trace, publics)


def zk_proofs(name):
    """The JAX ZK proof and the port's under FRI parameters `name`, both
    from seed 1 (made once a process)."""
    if name not in _PROOFS:
        rows, publics = j_fibonacci_trace(JF, LOG_N)
        j_cfg = j_zk_config(JF, JE, PARAMS[name], seed=1)
        ref = j_prove(j_cfg, JFibonacciAir(JF),
                      jnp.asarray(JF.to_monty_np(rows)), publics)
        _PROOFS[name] = dict(name=name, ref=ref, ours=_port_proof(name, 1),
                             j_cfg=j_cfg, publics=publics)
    return _PROOFS[name]


@pytest.fixture(scope="module")
def proofs():
    return zk_proofs("testing")


def test_proof_equals_reference(proofs):
    assert as_plain(proofs["ours"]) == as_plain(proofs["ref"])
    assert proofs["ours"].degree_bits == LOG_N + 1
    assert proofs["ours"].commitments.random is not None


def test_verifiers_accept_each_others_proofs(proofs):
    j_verify(proofs["j_cfg"], JFibonacciAir(JF), to_reference(proofs["ours"]),
             proofs["publics"])
    verify(_config(proofs["name"], 1), FibonacciAir(F),
           to_port(proofs["ref"]), proofs["publics"])


def _bump_ext(values, i):
    values[i] = tuple((c + 1) % F.P for c in values[i])


def _tamper(name, proof, publics):
    ov = proof.opened_values
    if name == "public_values":
        publics = list(publics)
        publics[2] = (publics[2] + 1) % F.P
    elif name == "random_opening":
        _bump_ext(ov.random, 0)
    elif name == "trace_local":
        _bump_ext(ov.trace_local, 1)
    elif name == "random_codeword":
        _bump_ext(ov.random_codewords[1][0][0], 0)
    elif name == "salt":
        # the last salt word of the trace round's first query row
        row = proof.opening_proof.input_openings[1].opened_values[0][0]
        row[-1] = (row[-1] + 1) % F.P
    elif name == "missing_random":
        proof.commitments.random = None
    return publics


@pytest.mark.parametrize("name", ["public_values", "random_opening",
                                  "trace_local", "random_codeword", "salt",
                                  "missing_random"])
def test_tampered_proof_rejected_as_reference(proofs, name):
    bad = copy.deepcopy(proofs["ours"])
    publics = _tamper(name, bad, proofs["publics"])
    got = _raised(lambda: verify(_config("testing", 1), FibonacciAir(F),
                                 bad, publics))
    want = _raised(lambda: j_verify(proofs["j_cfg"], JFibonacciAir(JF),
                                    to_reference(bad), publics))
    assert got == want
    assert got[0] == "VerificationError"
    with pytest.raises(VerificationError):
        verify(_config("testing", 1), FibonacciAir(F), bad, publics)


def test_seeds_give_different_roots():
    p1, p2 = _port_proof("testing", 1), _port_proof("testing", 2)
    assert p1.commitments.trace != p2.commitments.trace
    assert (p1.commitments.quotient_chunks
            != p2.commitments.quotient_chunks)
    assert p1.commitments.random != p2.commitments.random
    assert as_plain(_port_proof("testing", 1)) == as_plain(p1)


def test_hiding_pcs_commits_equal_reference():
    """commit (random rows and codewords, salts), commit_quotient (the
    masked chunks) and commit_preprocessing (zero rows), one Generator
    through all three as in a proof, at the Fibonacci proof's shapes."""
    rng = np.random.default_rng(11)
    mat = JF.rand_np(rng, (8, 2))
    q = JF.rand_np(rng, (16, 4))
    j_pcs = j_zk_config(JF, JE, PARAMS["testing"], seed=5).pcs
    pcs = _config("testing", 5).pcs
    dom16 = pcs.natural_domain_for_degree(16)
    j_dom16 = j_pcs.natural_domain_for_degree(16)
    qd = dom16.create_disjoint_domain(16)
    j_qd = j_dom16.create_disjoint_domain(16)
    got = [pcs.commit([(dom16, torch.from_numpy(mat.astype(np.int64)))]),
           pcs.commit_quotient(qd, torch.from_numpy(q.astype(np.int64)), 2),
           pcs.commit_preprocessing(
               [(dom16, torch.from_numpy(mat.astype(np.int64)))])]
    want = [j_pcs.commit([(j_dom16, jnp.asarray(mat))]),
            j_pcs.commit_quotient(j_qd, jnp.asarray(q), 2),
            j_pcs.commit_preprocessing([(j_dom16, jnp.asarray(mat))])]
    for g, w in zip(got, want):
        assert g.commitment == w.root_std
        for gm, wm in zip(g.matrices, w.matrices):
            assert np.array_equal(gm.numpy(), np.asarray(wm).astype(np.int64))
    assert [m.shape[1] for m in got[0].matrices] == [2 + 1 + 4]
    # the natural-order evaluations keep the codeword and three salts
    rows = pcs.get_evaluations_on_domain(got[0], 0, qd)
    j_rows = j_pcs.get_evaluations_on_domain(want[0], 0, j_qd)
    assert np.array_equal(rows.numpy(), np.asarray(j_rows).astype(np.int64))
    assert rows.shape == (16, 2 + 1 + 4 - 1)


def test_own_fold_air_raises_under_zk():
    """Poseidon2VectorAir folds its own constraints over exactly its
    width: under ZK the rows carry the random codeword and salts, and
    both packages raise (the reference's reshape TypeError, the port's
    ValueError naming the widths)."""
    inputs = JF.rand_np(np.random.default_rng(4), (8, 16))
    air = Poseidon2VectorAir(F, 16, vector_len=1)
    trace, _ = generate_vectorized_trace(
        air, trace_inputs_from_numpy(inputs, "cpu"), device="cpu")
    with pytest.raises(ValueError, match=f"reads {air.width} columns, "
                       f"the rows have {air.width + 4}"):
        prove(_config("testing", 1), air, trace, [])
    j_air = JP2Air(JF, 16, vector_len=1)
    j_trace, _ = j_generate(j_air, jnp.asarray(inputs))
    with pytest.raises(TypeError):
        j_prove(j_zk_config(JF, JE, PARAMS["testing"], seed=1), j_air,
                j_trace, [])


def test_fast_prover_refuses_zk():
    """The device-transcript prover covers the non-ZK PCS only, as the
    reference's; prove_fast on a CPU trace then proves with prove()."""
    trace, publics = generate_fibonacci_trace(F, LOG_N, device="cpu")
    with pytest.raises(fast_prover._Unsupported, match="non-ZK"):
        fast_prover._prove_device_fs(_config("testing", 1), FibonacciAir(F),
                                     trace, publics)
    got = fast_prover.prove_fast(_config("testing", 1), FibonacciAir(F),
                                 trace, publics)
    assert as_plain(got) == as_plain(_port_proof("testing", 1))


def test_zk_quotient_chunks():
    """The ZK quotient's chunk count: the reference's where its domain
    holds the quotient of the doubled-degree trace (FibonacciAir: a
    selector times an entry), more where it does not (KeccakAir's
    degree-3 products: 8 chunks, not 4; test_torch_zk_keccak.py)."""
    from plonky3_tpu.air.api import (
        get_log_num_quotient_chunks as j_log_chunks,
    )
    from plonky3_tpu.models.keccak_air import KeccakAir as JKeccakAir
    from plonky3_tpu_torch.models.keccak_air import KeccakAir
    from plonky3_tpu_torch.stark.zk import zk_log_quotient_chunks

    assert zk_log_quotient_chunks(FibonacciAir(F)) == j_log_chunks(
        JFibonacciAir(JF)) == 0
    assert j_log_chunks(JKeccakAir(JF)) == 1
    assert zk_log_quotient_chunks(KeccakAir(F)) == 2
