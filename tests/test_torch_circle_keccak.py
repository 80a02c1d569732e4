"""KeccakAir (2,633 columns) under the circle STARK: the port against the
reference.

The trace of one keccak-f permutation (32 rows) committed by both
circle PCSs gives the same root, and its evaluations over the quotient
domain (`get_evaluations_on_domain`: the LDE's prefix interpolated and
evaluated again) are the same; on those rows, with random alpha powers,
the port's generic quotient (next rows Nq/n ahead in the circle domain's
natural order) equals the JAX `quotient_values`, which runs eagerly under
`jax.disable_jit()` (jitted, the KeccakAir program takes minutes of XLA
compile on a CPU). Exact equality. The whole KeccakAir proof against the
JAX `prove()` is `-m slow`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plonky3_tpu.fields.mersenne31 import Mersenne31 as JF
from plonky3_tpu.fields.qm31 import QM31 as JQ
from plonky3_tpu.fri.config import FriParameters as JFri
from plonky3_tpu.models.keccak_air import KeccakAir as JKeccakAir
from plonky3_tpu.models.keccak_air import generate_keccak_trace as j_trace
from plonky3_tpu.stark.config import circle_stark_config as j_config
from plonky3_tpu.stark.prover import prove as j_prove
from plonky3_tpu.stark.prover import quotient_values as j_quotient_values
from plonky3_tpu_torch.air.api import (
    get_log_num_quotient_chunks,
    get_symbolic_layout,
)
from plonky3_tpu_torch.compat import fri_params_from, trace_inputs_from_numpy
from plonky3_tpu_torch.fields.mersenne31 import Mersenne31 as F
from plonky3_tpu_torch.models.keccak_air import KeccakAir
from plonky3_tpu_torch.stark.config import circle_stark_config
from plonky3_tpu_torch.stark.prover import prove, quotient_values
from plonky3_tpu_torch.stark.verifier import verify
from test_torch_prove import as_plain

LOG_N = 5


def _rows():
    inputs = np.random.default_rng(21).integers(0, 1 << 64, size=(1, 25),
                                                dtype=np.uint64)
    return np.asarray(j_trace(JF, inputs)).astype(np.uint32)


def _configs():
    return (j_config(JFri.new_testing()),
            circle_stark_config(fri_params_from(JFri.new_testing()),
                                device="cpu"))


def test_keccak_quotient_equals_reference():
    rows = _rows()
    assert rows.shape == (1 << LOG_N, 2633)
    air, j_air = KeccakAir(F), JKeccakAir(JF)
    j_cfg, cfg = _configs()
    log_q = LOG_N + get_log_num_quotient_chunks(air)

    j_domain = j_cfg.pcs.natural_domain_for_degree(1 << LOG_N)
    j_qdom = j_domain.create_disjoint_domain(1 << log_q)
    j_data = j_cfg.pcs.commit([(j_domain, jnp.asarray(rows))])
    j_rows = np.asarray(j_cfg.pcs.get_evaluations_on_domain(j_data, 0,
                                                            j_qdom))

    domain = cfg.pcs.natural_domain_for_degree(1 << LOG_N)
    qdom = domain.create_disjoint_domain(1 << log_q)
    data = cfg.pcs.commit([(domain,
                            trace_inputs_from_numpy(rows, "cpu", F=F))])
    assert data.root_std == j_data.root_std
    q_rows = cfg.pcs.get_evaluations_on_domain(data, 0, qdom)
    assert np.array_equal(q_rows.numpy(), j_rows.astype(np.int64))

    k, _ = get_symbolic_layout(air)
    pows = JF.rand_np(np.random.default_rng(22), (k, JQ.D))
    with jax.disable_jit():
        want = np.asarray(j_quotient_values(
            j_cfg, j_air, j_domain, j_qdom, jnp.asarray(j_rows),
            jnp.zeros((0,), jnp.uint32), jnp.asarray(pows)))
    got = quotient_values(cfg, air, domain, qdom, q_rows,
                          torch.zeros(0, dtype=torch.int64),
                          torch.from_numpy(pows.astype(np.int64)))
    assert got.shape == (1 << log_q, 4)
    assert np.array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.slow
def test_keccak_proof_equals_reference():
    rows = _rows()
    j_cfg, cfg = _configs()
    ref = j_prove(j_cfg, JKeccakAir(JF), jnp.asarray(rows), [])
    ours = prove(cfg, KeccakAir(F), trace_inputs_from_numpy(rows, "cpu",
                                                            F=F), [])
    assert as_plain(ours) == as_plain(ref)
    verify(cfg, KeccakAir(F), ours, [])
