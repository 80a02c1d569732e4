"""KeccakAir under ZK, the port against plonky3_tpu.

The quotient: a 32-row KeccakAir trace (one permutation) committed by the
port's HidingFriPcs over its doubled domain of 64 rows; the natural-order
rows of the reference's quotient domain (128 rows of 2,633 columns, then
the random codeword column and three salts) folded by the port's
`quotient_values`, by the row-block path `quotient_of_commitment` takes
in `prove_zk`, and by the JAX `quotient_values` (eager under
`jax.disable_jit()`, as test_torch_keccak_quotient.py runs it): all three
the same words. The generic fold reads its columns by index and ignores
the trailing ones, in both packages.

The proof: the reference's ZK quotient domain (2n·2, for a trace of
degree n) cannot hold KeccakAir's quotient over the doubled-degree ZK
trace, so the JAX verifier rejects the JAX proof (OodEvaluationMismatch;
`-m slow`, a cold JAX prove of 2,633 columns takes minutes). The port
proves it over 8 chunks (`zk_log_quotient_chunks`), which needs a blowup
of 4, and its verifier accepts the proof and rejects a changed opened
value."""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plonky3_tpu.fields import KoalaBear as JF
from plonky3_tpu.fields import KoalaBearExt4 as JE
from plonky3_tpu.fri.config import FriParameters as JFriParameters
from plonky3_tpu.models.keccak_air import KeccakAir as JKeccakAir
from plonky3_tpu.models.keccak_air import (
    generate_keccak_trace as j_keccak_trace,
)
from plonky3_tpu.stark.config import zk_stark_config as j_zk_config
from plonky3_tpu.stark.prover import prove as j_prove
from plonky3_tpu.stark.prover import quotient_values as j_quotient_values
from plonky3_tpu.stark.verifier import VerificationError as JError
from plonky3_tpu.stark.verifier import verify as j_verify
from plonky3_tpu_torch.air.api import (
    get_log_num_quotient_chunks,
    get_symbolic_layout,
)
from plonky3_tpu_torch.compat import fri_params_from
from plonky3_tpu_torch.fields import KoalaBear as F
from plonky3_tpu_torch.fields import KoalaBearExt4 as E
from plonky3_tpu_torch.models.keccak_air import (
    KeccakAir,
    generate_keccak_trace,
)
from plonky3_tpu_torch.stark.config import zk_stark_config
from plonky3_tpu_torch.stark.prover import (
    prove,
    quotient_of_commitment,
    quotient_values,
)
from plonky3_tpu_torch.stark.verifier import VerificationError, verify

LOG_N = 5
PARAMS = JFriParameters.new_testing()


def _inputs():
    return np.random.default_rng(3).integers(0, 1 << 64, size=(1, 25),
                                             dtype=np.uint64)


def test_zk_quotient_equals_reference():
    air = KeccakAir(F)
    trace = generate_keccak_trace(F, _inputs(), device="cpu")
    assert trace.shape == (1 << LOG_N, air.width)
    params = PARAMS
    cfg = zk_stark_config(F, E, fri_params_from(params), seed=7,
                          device="cpu")
    pcs = cfg.pcs
    domain = pcs.natural_domain_for_degree(1 << LOG_N)
    ext = pcs.natural_domain_for_degree(2 << LOG_N)
    qd = ext.create_disjoint_domain(
        1 << (LOG_N + 1 + get_log_num_quotient_chunks(air)))
    data = pcs.commit([(ext, trace)])
    rows = pcs.get_evaluations_on_domain(data, 0, qd)
    assert rows.shape == (qd.size, air.width + 1 + 4 - 1)
    k, _ = get_symbolic_layout(air)
    rng = np.random.default_rng(17)
    pows = JF.rand_np(rng, (k, JE.D))
    publics = torch.zeros((0,), dtype=torch.int64)

    got = quotient_values(cfg, air, domain, qd, rows, publics,
                          torch.from_numpy(pows.astype(np.int64)))
    blocked = quotient_values(cfg, air, domain, qd, rows, publics,
                              torch.from_numpy(pows.astype(np.int64)),
                              block_rows=qd.size // 4)
    proved = quotient_of_commitment(
        cfg, air, [(data, 0)], domain, qd, publics,
        torch.from_numpy(pows.astype(np.int64)))
    j_cfg = j_zk_config(JF, JE, params, seed=7)
    j_domain = j_cfg.pcs.natural_domain_for_degree(1 << LOG_N)
    j_qd = j_cfg.pcs.natural_domain_for_degree(2 << LOG_N) \
        .create_disjoint_domain(qd.size)
    with jax.disable_jit():
        want = j_quotient_values(
            j_cfg, JKeccakAir(JF), j_domain, j_qd,
            jnp.asarray(rows.numpy().astype(np.uint32)),
            jnp.zeros((0,), jnp.uint32), jnp.asarray(pows))
    want = np.asarray(want).astype(np.int64).reshape(qd.size, E.D)
    assert got.shape == (qd.size, E.D)
    assert np.array_equal(got.numpy(), want)
    assert torch.equal(blocked, got)
    assert torch.equal(proved, got)


def _port_proof(log_blowup=2):
    air = KeccakAir(F)
    params = dataclasses.replace(fri_params_from(PARAMS),
                                 log_blowup=log_blowup)
    cfg = zk_stark_config(F, E, params, seed=1, device="cpu")
    trace = generate_keccak_trace(F, _inputs(), device="cpu")
    return cfg, air, prove(cfg, air, trace, [])


def test_zk_proof_verifies():
    cfg, air, proof = _port_proof()
    assert len(proof.opened_values.quotient_chunks) == 8
    verify(cfg, air, proof, [])
    bad = copy.deepcopy(proof)
    ov = bad.opened_values
    ov.trace_local[5] = tuple((c + 1) % F.P for c in ov.trace_local[5])
    with pytest.raises(VerificationError):
        verify(cfg, air, bad, [])
    with pytest.raises(ValueError, match="needs a larger blowup"):
        _port_proof(log_blowup=1)


@pytest.mark.slow
def test_reference_zk_proof_fails_its_verifier():
    """The reference's fault: its ZK KeccakAir proof (4 chunks) is
    rejected by its own verifier."""
    rows = j_keccak_trace(JF, _inputs())
    j_cfg = j_zk_config(JF, JE, PARAMS, seed=1)
    proof = j_prove(j_cfg, JKeccakAir(JF),
                    jnp.asarray(JF.to_monty_np(np.asarray(rows))), [])
    assert len(proof.opened_values.quotient_chunks) == 4
    with pytest.raises(JError, match="OodEvaluationMismatch"):
        j_verify(j_zk_config(JF, JE, PARAMS, seed=1), JKeccakAir(JF),
                 proof, [])
