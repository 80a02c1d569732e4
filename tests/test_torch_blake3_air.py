"""Blake3Air and the BLAKE3 hash of plonky3_tpu_torch against
plonky3_tpu's: the compression and the hash against the JAX package's
host functions, the trace (bit for bit at n = 4 and 8, built in row
blocks), the symbolic layout (9,632 constraints of degree 3), the debug
check on honest and tampered traces, and the generic quotient at 8 rows
(Nq 16, 9,168 columns) against the JAX `quotient_values`, which runs
eagerly under `jax.disable_jit()`. Every comparison is exact. The proofs
are in `tests/test_torch_blake3_proof.py`."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plonky3_tpu.air.api import check_constraints as j_check_constraints
from plonky3_tpu.air.api import get_symbolic_layout as j_symbolic_layout
from plonky3_tpu.fields import KoalaBear as JF
from plonky3_tpu.fields import KoalaBearExt4 as JE
from plonky3_tpu.hashes import blake3 as j_blake3
from plonky3_tpu.models import blake3_air as j_air
from plonky3_tpu.stark.config import keccak_stark_config as j_config
from plonky3_tpu.stark.prover import quotient_values as j_quotient_values
from plonky3_tpu_torch.air.api import (
    check_constraints,
    get_log_num_quotient_chunks,
    get_symbolic_layout,
    get_widest_stack,
)
from plonky3_tpu_torch.compat import fri_params_from
from plonky3_tpu_torch.fields import KoalaBear as F
from plonky3_tpu_torch.fields import KoalaBearExt4 as E
from plonky3_tpu_torch.hashes import blake3
from plonky3_tpu_torch.models import blake3_air
from plonky3_tpu_torch.stark.config import keccak_stark_config
from plonky3_tpu_torch.stark.prover import quotient_values
from test_torch_prove import PARAMS

LOG_N = 3


def _inputs(n, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 1 << 32, size=(n, 24),
                        dtype=np.uint64).astype(np.uint32)


@pytest.mark.parametrize("length", [0, 1, 63, 64, 65, 1024, 1025, 3000,
                                    8192])
def test_hash_equals_reference(length):
    data = np.random.default_rng(length).integers(
        0, 256, size=length, dtype=np.uint8).tobytes()
    assert blake3.blake3(data) == j_blake3.blake3(data)
    assert blake3.blake3(data, 64) == j_blake3.blake3(data, 64)


def test_compression_equals_reference():
    """The host compression and the batched tensor compression against
    the JAX package's host compression, counters past 2^32 and every
    flag."""
    rng = np.random.default_rng(9)
    cv = rng.integers(0, 1 << 32, size=(6, 8), dtype=np.uint64)
    block = rng.integers(0, 1 << 32, size=(6, 16), dtype=np.uint64)
    got = blake3.compress_device(
        torch.from_numpy(cv.astype(np.int64)),
        torch.from_numpy(block.astype(np.int64)),
        torch.arange(6) * 977, torch.full((6,), 3), 64, 11)
    for r in range(6):
        counter = (3 << 32) | (r * 977)
        want = j_blake3._compress_host(cv[r].tolist(), block[r].tolist(),
                                       counter, 64, 11)
        assert got[r].tolist() == want
        assert blake3._compress_host(cv[r].tolist(), block[r].tolist(),
                                     counter, 64, 11) == want


@pytest.mark.parametrize("n", [4, 8])
def test_trace_equals_reference(n):
    inputs = _inputs(n, n)
    want = j_air.generate_blake3_trace(JF, inputs)
    got = blake3_air.blake3_trace_rows(inputs)
    assert got.dtype == np.uint32 and np.array_equal(got, want)
    # built and moved in blocks of 1 and 2 rows: the counter and
    # block_len stay those of the whole trace
    for block in (1, 2, n):
        dev = blake3_air.generate_blake3_trace(F, inputs, device="cpu",
                                               block_rows=block)
        assert np.array_equal(dev.numpy(),
                              JF.to_monty_np(want).astype(np.int64))


def test_outputs_are_the_compression():
    """The output bits of every row are the 16-word compression of its
    inputs (counter the row, block_len n, flags 0)."""
    n = 4
    inputs = _inputs(n, 1)
    trace = blake3_air.blake3_trace_rows(inputs)
    off = blake3_air.OFF_OUT
    for row in range(n):
        words = [int(sum(int(b) << z for z, b in enumerate(
            trace[row, off + 32 * i:off + 32 * (i + 1)]))) for i in range(16)]
        assert words == blake3._compress_host(
            inputs[row, 16:].tolist(), inputs[row, :16].tolist(), row, n, 0)


def test_symbolic_layout_equals_reference():
    air = blake3_air.Blake3Air(F)
    assert air.width == blake3_air.NUM_BLAKE3_COLS == 9168
    assert get_symbolic_layout(air) == (9632, 3)
    assert j_symbolic_layout(j_air.Blake3Air(JF)) == (9632, 3)
    assert get_log_num_quotient_chunks(air) == 1
    assert get_widest_stack(air) == 32 * 56  # the quarter rounds' bits


@pytest.mark.parametrize("col", [None, blake3_air.OFF_OUT + 3,
                                 blake3_air.OFF_CTR_LO,
                                 blake3_air.OFF_ROUNDS + 9,
                                 blake3_air.OFF_FRH + 31])
def test_check_constraints_equals_reference(col):
    trace = blake3_air.blake3_trace_rows(_inputs(4, 2))
    if col is not None:
        trace[1, col] ^= 1
    got = check_constraints(blake3_air.Blake3Air(F), trace, [])
    assert got == j_check_constraints(j_air.Blake3Air(JF), trace, [])
    assert (got == []) == (col is None)


def test_quotient_values_equal_reference():
    """The generic quotient at 8 rows on random quotient-domain rows
    with random alpha powers, the port's in blocks of 4 rows."""
    air = blake3_air.Blake3Air(F)
    log_q = LOG_N + get_log_num_quotient_chunks(air)
    rng = np.random.default_rng(23)
    k, _ = get_symbolic_layout(air)
    rows = JF.rand_np(rng, (1 << log_q, air.width))
    pows = JF.rand_np(rng, (k, JE.D))

    j_cfg = j_config(JF, JE, PARAMS)
    j_domain = j_cfg.pcs.natural_domain_for_degree(1 << LOG_N)
    with jax.disable_jit():
        want = j_quotient_values(
            j_cfg, j_air.Blake3Air(JF), j_domain,
            j_domain.create_disjoint_domain(1 << log_q), jnp.asarray(rows),
            jnp.zeros((0,), jnp.uint32), jnp.asarray(pows))
    want = np.asarray(want).astype(np.int64)

    cfg = keccak_stark_config(F, E, fri_params_from(PARAMS), device="cpu")
    domain = cfg.pcs.natural_domain_for_degree(1 << LOG_N)
    got = quotient_values(
        cfg, air, domain, domain.create_disjoint_domain(1 << log_q),
        torch.from_numpy(rows.astype(np.int64)), None,
        torch.from_numpy(pows.astype(np.int64)), block_rows=4)
    assert got.shape == (1 << log_q, E.D)
    assert np.array_equal(got.numpy(), want)
