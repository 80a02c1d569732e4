"""The generic quotient of plonky3_tpu_torch against plonky3_tpu's: the
port's `quotient_values` (the AIR's `eval` over the ProverBackend, the
next rows Nq/n ahead) equals the JAX `quotient_values` on a random
quotient-domain matrix with random alpha powers, for KeccakAir at 64 rows
(Nq 128, 2,633 columns, 3,182 constraints) and FibonacciAir (public
values, every filter). The JAX side runs eagerly under
`jax.disable_jit()`: jitted, the KeccakAir program takes minutes of XLA
compile on a CPU. Exact equality."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plonky3_tpu.fields import KoalaBear as JF
from plonky3_tpu.fields import KoalaBearExt4 as JE
from plonky3_tpu.models.fibonacci import FibonacciAir as JFibonacciAir
from plonky3_tpu.models.keccak_air import KeccakAir as JKeccakAir
from plonky3_tpu.stark.config import keccak_stark_config as j_config
from plonky3_tpu.stark.prover import quotient_values as j_quotient_values
from plonky3_tpu_torch.air.api import (
    get_log_num_quotient_chunks,
    get_symbolic_layout,
)
from plonky3_tpu_torch.compat import fri_params_from
from plonky3_tpu_torch.fields import KoalaBear as F
from plonky3_tpu_torch.fields import KoalaBearExt4 as E
from plonky3_tpu_torch.models.fibonacci import FibonacciAir
from plonky3_tpu_torch.models.keccak_air import KeccakAir
from plonky3_tpu_torch.stark.config import keccak_stark_config
from plonky3_tpu_torch.stark.prover import quotient_values
from test_torch_prove import PARAMS

LOG_N = 6


@pytest.mark.parametrize("name", ["keccak", "fibonacci"])
def test_quotient_values_equal_reference(name):
    air, j_air = {"keccak": (KeccakAir(F), JKeccakAir(JF)),
                  "fibonacci": (FibonacciAir(F), JFibonacciAir(JF))}[name]
    log_q = LOG_N + get_log_num_quotient_chunks(air)
    rng = np.random.default_rng(17)
    k, _ = get_symbolic_layout(air)
    rows = JF.rand_np(rng, (1 << log_q, air.width))
    pows = JF.rand_np(rng, (k, JE.D))
    publics = JF.rand_np(rng, (air.num_public_values,))

    j_cfg = j_config(JF, JE, PARAMS)
    j_domain = j_cfg.pcs.natural_domain_for_degree(1 << LOG_N)
    with jax.disable_jit():
        want = j_quotient_values(
            j_cfg, j_air, j_domain,
            j_domain.create_disjoint_domain(1 << log_q), jnp.asarray(rows),
            jnp.asarray(publics), jnp.asarray(pows))
    want = np.asarray(want)

    cfg = keccak_stark_config(F, E, fri_params_from(PARAMS), device="cpu")
    domain = cfg.pcs.natural_domain_for_degree(1 << LOG_N)
    got = quotient_values(
        cfg, air, domain, domain.create_disjoint_domain(1 << log_q),
        torch.from_numpy(rows.astype(np.int64)),
        torch.from_numpy(publics.astype(np.int64)),
        torch.from_numpy(pows.astype(np.int64)))
    assert got.shape == (1 << log_q, E.D)
    assert np.array_equal(got.numpy(), want.astype(np.int64))
