"""Poseidon2VectorAir over BabyBear (s-box x^7, one register per s-box) in
the port against the reference's.

The column and constraint layout (298 columns and 282 constraints a
permutation) against the reference's symbolic layout; trace generation
at V = 8 on 16 rows; the prover's alpha fold at V = 8 against the
reference's quotient fold; `eval` at an extension point against the
reference's and, at trace rows, against the prover's fold; and under
`keccak_stark_config` (vector_len 1, log_n 6, 10 queries, 8-bit query
PoW, on the CPU) the port's `prove()` and device-transcript prover give
the reference's proof, and the port's verifier raises what the
reference's raises on every tamper case of `test_torch_prove.py`. The
whole proof at V = 8 (2,384 columns) against the reference's is `-m slow`.
"""

import copy

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from plonky3_tpu.air.api import _make_builder as j_make_builder
from plonky3_tpu.air.api import get_symbolic_layout as j_layout
from plonky3_tpu.air.builder import VerifierBackend as JVerifierBackend
from plonky3_tpu.fields import BabyBear as JF
from plonky3_tpu.fields import BabyBearExt4 as JE
from plonky3_tpu.fri.config import FriParameters as JFriParameters
from plonky3_tpu.models.poseidon2_air import (
    Poseidon2VectorAir as JAir,
    generate_vectorized_trace as j_generate,
)
from plonky3_tpu.stark.config import keccak_stark_config as j_config
from plonky3_tpu.stark.prover import prove as j_prove
from plonky3_tpu.stark.verifier import verify as j_verify
from plonky3_tpu_torch.air.api import _make_builder, get_symbolic_layout
from plonky3_tpu_torch.air.builder import VerifierBackend
from plonky3_tpu_torch.compat import fri_params_from, trace_inputs_from_numpy
from plonky3_tpu_torch.fields import BabyBear as F
from plonky3_tpu_torch.fields import BabyBearExt4 as E
from plonky3_tpu_torch.models.poseidon2_air import (
    Poseidon2VectorAir,
    generate_vectorized_trace,
)
from plonky3_tpu_torch.stark import fast_prover
from plonky3_tpu_torch.stark.config import keccak_stark_config
from plonky3_tpu_torch.stark.prover import prove
from plonky3_tpu_torch.stark.verifier import VerificationError, verify
from test_torch_prove import TAMPERS, _raised, _tamper, as_plain, \
    to_reference

LOG_N = 6
PARAMS = JFriParameters(log_blowup=1, log_final_poly_len=0, max_log_arity=3,
                        num_queries=10, commit_proof_of_work_bits=0,
                        query_proof_of_work_bits=8)


def _i64(x):
    return torch.from_numpy(np.asarray(x).astype(np.int64))


@pytest.mark.parametrize("vector_len", [1, 8])
def test_layout_matches_reference(vector_len):
    """A permutation: 16 inputs, 4 × (16 registers + 16 posts), 13 ×
    (register + post), 4 × 32 columns; 8 × 32 + 13 × 2 constraints of
    degree 3."""
    ours = Poseidon2VectorAir(F, 16, vector_len=vector_len)
    ref = JAir(JF, 16, vector_len=vector_len)
    assert (ours.REG, ours.PR) == (1, 13)
    assert ours.width == ref.width == 298 * vector_len
    assert get_symbolic_layout(ours) == j_layout(ref) == (
        282 * vector_len, 3)
    for r in range(4):
        for section in (0, 1):
            assert ours._off_full(section, r) == ref._off_full(section, r)
    for r in range(13):
        assert ours._off_partial(r) == ref._off_partial(r)


def test_trace_matches_reference():
    inputs = JF.rand_np(np.random.default_rng(8), (16 * 8, 16))
    want, want_out = j_generate(JAir(JF, 16, vector_len=8),
                                jnp.asarray(inputs))
    got, got_out = generate_vectorized_trace(
        Poseidon2VectorAir(F, 16, vector_len=8), inputs, device="cpu")
    assert got.shape == (16, 2384)
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert np.array_equal(got_out.numpy(), np.asarray(want_out))


def test_fold_matches_reference():
    """Random (non-trace) rows, so every constraint is nonzero."""
    ref = JAir(JF, 16, vector_len=8)
    ours = Poseidon2VectorAir(F, 16, vector_len=8)
    rng = np.random.default_rng(18)
    local = JF.rand_np(rng, (8, ref.width))
    k, _ = j_layout(ref)
    alpha_pows = JF.rand_np(rng, (k, 4))
    want = ref.fold_constraints_device(JF, JE, jnp.asarray(local), None,
                                       None, None, jnp.asarray(alpha_pows))
    got = ours.fold_constraints_device(F, E, _i64(local), None, None, None,
                                       _i64(alpha_pows))
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_eval_at_a_point_matches_reference_and_prover_fold():
    """At a random extension point the port's `eval` folds to the
    reference's value. At trace rows it equals the prover's fold with the
    alpha powers descending; a changed register breaks only its row."""
    air = Poseidon2VectorAir(F, 16, vector_len=2)
    j_air = JAir(JF, 16, vector_len=2)
    rng = np.random.default_rng(2)
    alpha = JE.rand_h(rng)
    sels = {k: JE.rand_h(rng) for k in ("is_first_row", "is_last_row",
                                        "is_transition")}
    point = [JE.rand_h(rng) for _ in range(air.width)]

    def run(a, backend, make, vals):
        def entry(kind, j):
            return vals[j] if kind in ("local", "next") else sels[kind]

        a.eval(make(backend, a.width, 0, entry, None))
        return backend.acc

    assert run(air, VerifierBackend(E, alpha), _make_builder, point) == \
        run(j_air, JVerifierBackend(JE, alpha), j_make_builder, point)

    trace, _ = generate_vectorized_trace(air, F.rand_np(rng, (4, 16)),
                                         device="cpu")
    reg = air._off_full(0, 2)[0] + 5  # a register of the third round
    trace[1, reg] = (trace[1, reg] + 1) % F.P
    k, _ = get_symbolic_layout(air)
    pows = _i64(E.powers_np(alpha, k)[::-1])
    folded = air.fold_constraints_device(F, E, trace, None, None, None, pows)
    for r in range(2):
        row = [E.from_base_h(int(x))
               for x in F.from_monty_np(trace[r].numpy())]
        acc = run(air, VerifierBackend(E, alpha), _make_builder, row)
        assert acc == E.from_monty_np(folded[r].numpy())
        assert (acc == E.zero_h()) == (r == 0)


def _proofs(vector_len, log_n):
    inputs = JF.rand_np(np.random.default_rng(3),
                        (vector_len << log_n, 16))
    j_air = JAir(JF, 16, vector_len=vector_len)
    j_cfg = j_config(JF, JE, PARAMS)
    j_trace, _ = j_generate(j_air, jnp.asarray(inputs))
    ref = j_prove(j_cfg, j_air, j_trace, [])

    air = Poseidon2VectorAir(F, 16, vector_len=vector_len)
    trace, _ = generate_vectorized_trace(
        air, trace_inputs_from_numpy(inputs, "cpu"), device="cpu")
    cfg = keccak_stark_config(F, E, fri_params_from(PARAMS), device="cpu")
    return dict(ref=ref, ours=prove(cfg, air, trace, []),
                fast=fast_prover._prove_device_fs(cfg, air, trace, []),
                j_cfg=j_cfg, j_air=j_air, air=air, cfg=cfg)


@pytest.fixture(scope="module")
def proofs():
    """The reference's prove under its keccak config over BabyBear, and
    the port's prove and device-transcript prove of the same inputs."""
    return _proofs(1, LOG_N)


def test_keccak_config_proofs_equal_reference(proofs):
    assert as_plain(proofs["ours"]) == as_plain(proofs["ref"])
    assert proofs["fast"] == proofs["ours"]
    verify(proofs["cfg"], proofs["air"], proofs["fast"], [])
    j_verify(proofs["j_cfg"], proofs["j_air"], to_reference(proofs["fast"]),
             [])


@pytest.mark.parametrize("name", TAMPERS)
def test_verify_rejects_tampered_proof_as_reference(proofs, name):
    """The same error class and message from the port's verifier and the
    reference's on the same tampered proof."""
    bad = copy.deepcopy(proofs["ours"])
    publics = _tamper(name, bad)
    got = _raised(lambda: verify(proofs["cfg"], proofs["air"], bad,
                                 publics))
    want = _raised(lambda: j_verify(proofs["j_cfg"], proofs["j_air"],
                                    to_reference(bad), publics))
    assert got == want
    with pytest.raises(VerificationError):
        verify(proofs["cfg"], proofs["air"], bad, publics)


@pytest.mark.slow
def test_vector_len_8_proof_equals_reference():
    """The benchmark's vector length (2,384 columns) at 16 rows."""
    got = _proofs(8, 4)
    assert as_plain(got["ours"]) == as_plain(got["ref"])
    assert got["fast"] == got["ours"]
    verify(got["cfg"], got["air"], got["fast"], [])
