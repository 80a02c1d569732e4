"""Sha256Air and SHA-256 of plonky3_tpu_torch against plonky3_tpu's: the
compression (numpy and int64 torch branches) against the reference's
`compress_arrays(np, ...)` and hashlib, the trace (bit for bit at n = 4
and 8, built on the device's side in row blocks), the symbolic layout
(8,096 constraints of degree 3), the debug check on honest and tampered
traces, the generic quotient at 8 rows against the JAX
`quotient_values` (eager, under `jax.disable_jit()`), and proofs at 8
rows under the Poseidon2 config: `prove()` and the device-transcript
prover agree, both verifiers accept, a tampered copy is rejected by both
alike. The proof against the JAX `prove` (a cold JAX prove of 7,728
columns) is marked slow. Every comparison is exact."""

import copy
import hashlib
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plonky3_tpu.air import builder as j_builder
from plonky3_tpu.air.api import check_constraints as j_check_constraints
from plonky3_tpu.air.api import get_symbolic_layout as j_symbolic_layout
from plonky3_tpu.fields import KoalaBear as JF
from plonky3_tpu.fields import KoalaBearExt4 as JE
from plonky3_tpu.hashes import sha256 as j_sha256
from plonky3_tpu.models import sha256_air as j_air
from plonky3_tpu.stark.config import keccak_stark_config as j_keccak_config
from plonky3_tpu.stark.config import poseidon2_stark_config as j_config
from plonky3_tpu.stark.prover import prove as j_prove
from plonky3_tpu.stark.prover import quotient_values as j_quotient_values
from plonky3_tpu.stark.verifier import verify as j_verify
from plonky3_tpu_torch.air.api import (
    check_constraints,
    get_log_num_quotient_chunks,
    get_symbolic_layout,
    get_widest_stack,
)
from plonky3_tpu_torch.compat import fri_params_from
from plonky3_tpu_torch.fields import KoalaBear as F
from plonky3_tpu_torch.fields import KoalaBearExt4 as E
from plonky3_tpu_torch.hashes import sha256
from plonky3_tpu_torch.models import sha256_air
from plonky3_tpu_torch.stark import fast_prover, prover
from plonky3_tpu_torch.stark.config import (keccak_stark_config,
                                            poseidon2_stark_config)
from plonky3_tpu_torch.stark.verifier import verify
from test_torch_prove import PARAMS, _raised, as_plain, to_reference

LOG_N = 3


def _inputs(n, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 1 << 32, size=(n, 24),
                        dtype=np.uint64).astype(np.uint32)


def test_compress_equals_reference():
    rng = np.random.default_rng(5)
    st = rng.integers(0, 1 << 32, (7, 8), dtype=np.uint64).astype(np.uint32)
    blk = rng.integers(0, 1 << 32, (7, 16),
                       dtype=np.uint64).astype(np.uint32)
    with np.errstate(over="ignore"):
        want = j_sha256.compress_arrays(np, st, blk)
        got_np = sha256.compress_arrays(np, st, blk)
    got_t = sha256.compress_arrays(torch, torch.from_numpy(st.astype(
        np.int64)), torch.from_numpy(blk.astype(np.int64)))
    assert got_np.dtype == np.uint32 and np.array_equal(got_np, want)
    assert np.array_equal(got_t.numpy(), want.astype(np.int64))
    for r in range(7):
        assert sha256.sha256_compress(st[r].tolist(), blk[r].tolist()) == \
            j_sha256.sha256_compress(st[r].tolist(), blk[r].tolist())


@pytest.mark.parametrize("length", [0, 3, 55])
def test_compress_is_hashlib(length):
    """A message of one padded block: its digest is the compression of
    the IV with that block."""
    msg = bytes(range(length))
    pad = msg + b"\x80" + b"\x00" * (55 - length) + struct.pack(">Q",
                                                               8 * length)
    block = np.array(struct.unpack(">16I", pad), dtype=np.int64)
    out = sha256.compress_arrays(torch, torch.from_numpy(
        sha256.IV.astype(np.int64)), torch.from_numpy(block))
    digest = b"".join(int(x).to_bytes(4, "big") for x in out)
    assert digest == hashlib.sha256(msg).digest() == sha256.sha256(msg)
    assert sha256.sha256(msg) == j_sha256.sha256(msg)


def _trace_rows(inputs):
    """The port's trace on the CPU in standard form, as uint32."""
    trace = sha256_air.generate_sha256_trace(F, inputs, device="cpu")
    return F.from_monty_tensor(trace).numpy().astype(np.uint32)


@pytest.mark.parametrize("n", [4, 8])
def test_trace_equals_reference(n, monkeypatch):
    inputs = _inputs(n, n)
    want = j_air.generate_sha256_trace(JF, inputs)
    got = _trace_rows(inputs)
    assert np.array_equal(got, want)
    for block in (1, 2, n):
        monkeypatch.setattr(sha256_air, "TRACE_BLOCK_ROWS", block)
        dev = sha256_air.generate_sha256_trace(F, inputs, device="cpu")
        assert np.array_equal(dev.numpy(),
                              JF.to_monty_np(want).astype(np.int64))


def test_outputs_are_the_compression():
    inputs = _inputs(4, 1)
    trace = _trace_rows(inputs)
    off = sha256_air.OFF_H_OUT
    for row in range(4):
        words = [int(sum(int(b) << z for z, b in enumerate(
            trace[row, off + 32 * i:off + 32 * (i + 1)]))) for i in range(8)]
        assert words == sha256.sha256_compress(inputs[row, 16:].tolist(),
                                               inputs[row, :16].tolist())


def test_symbolic_layout_equals_reference():
    air = sha256_air.Sha256Air(F)
    assert air.width == sha256_air.NUM_SHA256_COLS == 7728
    assert get_symbolic_layout(air) == (8096, 3)
    assert j_symbolic_layout(j_air.Sha256Air(JF)) == (8096, 3)
    assert get_log_num_quotient_chunks(air) == 1
    assert get_widest_stack(air) == 6656  # the booleanity block
    for name in ("OFF_H_IN", "OFF_A_CHAIN", "OFF_E_CHAIN", "OFF_W",
                 "OFF_S_SIG0", "OFF_S_SIG1", "OFF_S_TMP", "OFF_ROUNDS",
                 "OFF_H_OUT", "K", "SIGMA"):
        assert getattr(sha256_air, name) == getattr(j_air, name)


@pytest.mark.parametrize("col", [None, sha256_air.OFF_H_OUT + 5,
                                 sha256_air.OFF_H_IN + 1,
                                 sha256_air.OFF_W + 32 * 20 + 7,
                                 sha256_air.OFF_S_TMP + 3,
                                 sha256_air.OFF_ROUNDS + 12 * 30 + 7,
                                 sha256_air.OFF_E_CHAIN + 32 * 67])
def test_check_constraints_equals_reference(col):
    trace = _trace_rows(_inputs(4, 2))
    if col is not None:
        trace[1, col] ^= 1
    got = check_constraints(sha256_air.Sha256Air(F), trace, [])
    assert got == j_check_constraints(j_air.Sha256Air(JF), trace, [])
    assert (got == []) == (col is None)


def _stack_once(self, vals):
    """The reference ProverBackend's `stack` with the common shape taken
    once: the reference takes it again for every value, which is
    quadratic in Sha256Air's 6,656-value booleanity stack (over three
    minutes eagerly). The stacked array is the same."""
    shape = jnp.broadcast_shapes(*[jnp.shape(x) for x in vals])
    return jnp.stack([jnp.broadcast_to(v, shape) for v in vals], axis=0)


def test_quotient_values_equal_reference(monkeypatch):
    """The generic quotient at 8 rows on random quotient-domain rows with
    random alpha powers, the port's in blocks of 4 rows."""
    monkeypatch.setattr(j_builder.ProverBackend, "stack", _stack_once)
    air = sha256_air.Sha256Air(F)
    log_q = LOG_N + get_log_num_quotient_chunks(air)
    rng = np.random.default_rng(29)
    k, _ = get_symbolic_layout(air)
    rows = JF.rand_np(rng, (1 << log_q, air.width))
    pows = JF.rand_np(rng, (k, JE.D))

    j_cfg = j_keccak_config(JF, JE, PARAMS)
    j_domain = j_cfg.pcs.natural_domain_for_degree(1 << LOG_N)
    with jax.disable_jit():
        want = j_quotient_values(
            j_cfg, j_air.Sha256Air(JF), j_domain,
            j_domain.create_disjoint_domain(1 << log_q), jnp.asarray(rows),
            jnp.zeros((0,), jnp.uint32), jnp.asarray(pows))
    want = np.asarray(want).astype(np.int64)

    cfg = keccak_stark_config(F, E, fri_params_from(PARAMS), device="cpu")
    domain = cfg.pcs.natural_domain_for_degree(1 << LOG_N)
    got = prover.quotient_values(
        cfg, air, domain, domain.create_disjoint_domain(1 << log_q),
        torch.from_numpy(rows.astype(np.int64)), None,
        torch.from_numpy(pows.astype(np.int64)), block_rows=4)
    assert got.shape == (1 << log_q, E.D)
    assert np.array_equal(got.numpy(), want)


@pytest.fixture(scope="module")
def proofs():
    inputs = _inputs(1 << LOG_N, 3)
    air = sha256_air.Sha256Air(F)
    cfg = poseidon2_stark_config(F, E, fri_params_from(PARAMS), device="cpu")
    trace = sha256_air.generate_sha256_trace(F, inputs, device="cpu")
    return dict(inputs=inputs, air=air, cfg=cfg, trace=trace,
                ours=prover.prove(cfg, air, trace, []),
                fast=fast_prover._prove_device_fs(cfg, air, trace, []),
                j_air=j_air.Sha256Air(JF), j_cfg=j_config(JF, JE, PARAMS))


def test_provers_agree(proofs):
    proof = proofs["ours"]
    assert as_plain(proofs["fast"]) == as_plain(proof)
    assert proof.degree_bits == LOG_N
    assert len(proof.opened_values.trace_local) == 7728
    assert len(proof.opened_values.trace_next) == 7728
    assert len(proof.opened_values.quotient_chunks) == 2


@pytest.mark.parametrize("which", ["ours", "fast"])
def test_both_verifiers_accept(proofs, which):
    proof = proofs[which]
    assert verify(proofs["cfg"], proofs["air"], proof, []) is None
    j_verify(proofs["j_cfg"], proofs["j_air"], to_reference(proof), [])


@pytest.mark.parametrize("name", ["trace_local", "trace_next"])
def test_tampered_rejected_as_reference(proofs, name):
    bad = copy.deepcopy(proofs["ours"])
    ov = bad.opened_values
    vals = ov.trace_local if name == "trace_local" else ov.trace_next
    vals[sha256_air.OFF_H_OUT] = E.add_h(vals[sha256_air.OFF_H_OUT],
                                         E.one_h())
    got = _raised(lambda: verify(proofs["cfg"], proofs["air"], bad, []))
    want = _raised(lambda: j_verify(proofs["j_cfg"], proofs["j_air"],
                                    to_reference(bad), []))
    assert got == want


@pytest.mark.slow
def test_proof_equals_reference(proofs):
    trace_std = j_air.generate_sha256_trace(JF, proofs["inputs"])
    ref = j_prove(proofs["j_cfg"], proofs["j_air"],
                  jnp.asarray(JF.to_monty_np(trace_std)), [])
    assert as_plain(proofs["ours"]) == as_plain(ref)
