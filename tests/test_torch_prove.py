"""End to end: the plonky3_tpu_torch prover's Proof equals the plonky3_tpu
prover's Proof on the same trace (the setup of tests/test_device_fs.py:
keccak config, Poseidon2VectorAir vector_len 1, log_n 6, 10 queries, 8-bit
query PoW), and the reference verifier accepts the port's proof; the same
for the port's device-transcript prover (`_prove_device_fs`, whose proof
the reference's own tests hold equal to the reference's `prove_fast`).
Also the pieces of the prover that the end-to-end run does not isolate:
FRI folding, the coset selectors and the bit-reversed quotient rows."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from plonky3_tpu.commit.domain import TwoAdicCoset as JCoset
from plonky3_tpu.fields import KoalaBearExt4 as JE
from plonky3_tpu.fields.params import KoalaBear as JF
from plonky3_tpu.fri import proof as jfri_proof
from plonky3_tpu.fri.config import FriParameters as JFriParameters
from plonky3_tpu.fri.prover import fold_step_np
from plonky3_tpu.models.poseidon2_air import (
    Poseidon2VectorAir as JAir,
    generate_vectorized_trace as j_generate,
)
from plonky3_tpu.stark import proof as jstark_proof
from plonky3_tpu.stark.config import keccak_stark_config as j_config
from plonky3_tpu.stark.prover import prove as j_prove
from plonky3_tpu.stark.verifier import verify as j_verify
from plonky3_tpu_torch.commit.domain import TwoAdicCoset
from plonky3_tpu_torch.compat import fri_params_from, trace_inputs_from_numpy
from plonky3_tpu_torch.fields import KoalaBear as F
from plonky3_tpu_torch.fields import KoalaBearExt4 as E
from plonky3_tpu_torch.fri.prover import fold_matrix, fold_step
from plonky3_tpu_torch.models.poseidon2_air import (
    Poseidon2VectorAir,
    generate_vectorized_trace,
)
from plonky3_tpu_torch.stark import fast_prover
from plonky3_tpu_torch.stark.config import keccak_stark_config
from plonky3_tpu_torch.stark.prover import prove, quotient_values

LOG_N = 6
PARAMS = JFriParameters(log_blowup=1, log_final_poly_len=0, max_log_arity=3,
                        num_queries=10, commit_proof_of_work_bits=0,
                        query_proof_of_work_bits=8)


def as_plain(x):
    """Nested tuples of ints (a dataclass == would also compare classes)."""
    if dataclasses.is_dataclass(x):
        return tuple((f.name, as_plain(getattr(x, f.name)))
                     for f in dataclasses.fields(x))
    if isinstance(x, (list, tuple)):
        return tuple(as_plain(v) for v in x)
    return x


_REF_CLASSES = {
    cls.__name__: cls
    for mod in (jstark_proof, jfri_proof)
    for cls in vars(mod).values()
    if dataclasses.is_dataclass(cls)
}


def to_reference(x):
    """Rebuild a port proof object as the reference's classes."""
    if dataclasses.is_dataclass(x):
        cls = _REF_CLASSES[type(x).__name__]
        return cls(**{f.name: to_reference(getattr(x, f.name))
                      for f in dataclasses.fields(x)})
    if isinstance(x, list):
        return [to_reference(v) for v in x]
    if isinstance(x, tuple):
        return tuple(to_reference(v) for v in x)
    return x


@pytest.fixture(scope="module")
def proofs():
    """The one cold reference prove of the port's tests, and the port's
    prove and device-transcript prove of the same inputs on the CPU."""
    inputs = JF.rand_np(np.random.default_rng(3), (1 << LOG_N, 16))
    j_air = JAir(JF, 16, vector_len=1)
    j_cfg = j_config(JF, JE, PARAMS)
    j_trace, _ = j_generate(j_air, jnp.asarray(inputs))
    ref = j_prove(j_cfg, j_air, j_trace, [])

    air = Poseidon2VectorAir(F, 16, vector_len=1)
    trace, _ = generate_vectorized_trace(
        air, trace_inputs_from_numpy(inputs, "cpu"), device="cpu")
    cfg = keccak_stark_config(F, E, fri_params_from(PARAMS), device="cpu")
    ours = prove(cfg, air, trace, [])
    pulls = fast_prover.PULLS["count"]
    fast = fast_prover._prove_device_fs(cfg, air, trace, [])
    return dict(ref=ref, ours=ours, fast=fast, j_cfg=j_cfg, j_air=j_air,
                air=air, trace=trace,
                fast_pulls=fast_prover.PULLS["count"] - pulls)


def test_proof_equals_reference(proofs):
    assert as_plain(proofs["ours"]) == as_plain(proofs["ref"])
    assert proofs["ours"].degree_bits == LOG_N


def test_reference_verifier_accepts_port_proof(proofs):
    rebuilt = to_reference(proofs["ours"])
    assert rebuilt == proofs["ref"]
    j_verify(proofs["j_cfg"], proofs["j_air"], rebuilt, [])


def test_fast_proof_equals_reference(proofs):
    """The device transcript gives the host transcript's proof, with one
    device-to-host copy, and the reference verifier accepts it."""
    assert as_plain(proofs["fast"]) == as_plain(proofs["ref"])
    assert proofs["fast"] == proofs["ours"]
    assert proofs["fast_pulls"] == 1
    rebuilt = to_reference(proofs["fast"])
    assert rebuilt == proofs["ref"]
    j_verify(proofs["j_cfg"], proofs["j_air"], rebuilt, [])


def test_fast_proof_with_cap_and_commit_pow(proofs):
    """Merkle caps and a per-round FRI commit proof of work."""
    params = dataclasses.replace(fri_params_from(PARAMS),
                                 commit_proof_of_work_bits=4)
    cfg = keccak_stark_config(F, E, params, cap_height=1, device="cpu")
    air, trace = proofs["air"], proofs["trace"]
    fast = fast_prover._prove_device_fs(cfg, air, trace, [])
    assert fast == prove(cfg, air, trace, [])
    assert any(fast.opening_proof.commit_pow_witnesses)


def test_prove_fast_falls_back_without_query_pow(proofs):
    """No query proof of work (grind(0)) stays on the device path: the
    witness is 0 and the indices are sampled directly, as prove() does;
    nothing falls back."""
    params = dataclasses.replace(fri_params_from(PARAMS),
                                 query_proof_of_work_bits=0)
    cfg = keccak_stark_config(F, E, params, device="cpu")
    air, trace = proofs["air"], proofs["trace"]
    want = prove(cfg, air, trace, [])
    assert want.opening_proof.query_pow_witness == 0
    assert fast_prover._prove_device_fs(cfg, air, trace, []) == want
    assert fast_prover.prove_fast(cfg, air, trace, []) == want


def test_prove_fast_falls_back_on_cpu_only(proofs, monkeypatch):
    """Outside the device path's scope a CPU trace is proved by prove();
    the fallback is decided by the trace's device (a CUDA trace re-raises,
    tests/test_torch_cuda.py)."""
    def unsupported(*args, **kw):
        raise fast_prover._Unsupported("out of scope")

    monkeypatch.setattr(fast_prover, "_prove_device_fs", unsupported)
    cfg = keccak_stark_config(F, E, fri_params_from(PARAMS), device="cpu")
    assert fast_prover.prove_fast(cfg, proofs["air"], proofs["trace"],
                                  []) == proofs["ours"]


@pytest.mark.parametrize("log_h,log_arity", [(1, 1), (4, 1), (5, 3)])
def test_fri_fold_matches_reference(log_h, log_arity):
    rng = np.random.default_rng(log_h)
    folded = JF.rand_np(rng, (1 << log_h, 4))
    beta = JE.rand_h(rng)
    want = folded
    b = beta
    for _ in range(log_arity):
        want = fold_step_np(JE, want, b)
        b = JE.mul_h(b, b)
    t = torch.from_numpy(folded.astype(np.int64))
    got = fold_matrix(E, t, beta, log_arity)
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(fold_step(E, t, beta).numpy(),
                          fold_step_np(JE, folded, beta))


def test_selectors_match_reference():
    trace = TwoAdicCoset(F, 1, 4)
    quot = trace.create_disjoint_domain(1 << 6)
    j_trace = JCoset(JF, 1, 4)
    j_quot = j_trace.create_disjoint_domain(1 << 6)
    assert (quot.shift, quot.log_n) == (j_quot.shift, j_quot.log_n)
    got = trace.selectors_on_coset_device(quot, "cpu")
    want = j_trace.selectors_on_coset_device(j_quot)
    assert set(got) == set(want)
    for k in want:
        assert np.array_equal(got[k].numpy(), np.asarray(want[k])), k
    assert [(d.shift, d.log_n) for d in quot.split_domains(4)] == [
        (d.shift, d.log_n) for d in j_quot.split_domains(4)]


class _NoNextRowAir(Poseidon2VectorAir):
    def main_next_row_columns(self):
        return []


def test_quotient_rows_bitrev_equal_natural():
    """The bit-reversed quotient path, permuted back, gives the natural
    one for an AIR that reads no next row."""
    from plonky3_tpu_torch.utils.bits import bitrev_permute_axis0

    air = _NoNextRowAir(F, 16, vector_len=1)
    cfg = keccak_stark_config(F, E, fri_params_from(PARAMS), device="cpu")
    trace, _ = generate_vectorized_trace(
        air, F.rand_np(np.random.default_rng(1), (16, 16)), device="cpu")
    domain = cfg.pcs.natural_domain_for_degree(16)
    data = cfg.pcs.commit([(domain, trace)])
    qd = domain.create_disjoint_domain(32)
    k, _ = air.constraint_layout()
    alpha = torch.from_numpy(E.powers_np((1, 2, 3, 4), k).astype(np.int64))
    args = (cfg, air, domain, qd)
    nat = quotient_values(
        *args, cfg.pcs.get_evaluations_on_domain(data, 0, qd), None, alpha)
    br = quotient_values(
        *args, cfg.pcs.get_evaluations_on_domain(data, 0, qd, "bitrev"),
        None, alpha, rows_order="bitrev")
    assert torch.equal(bitrev_permute_axis0(br, qd.log_n), nat)
