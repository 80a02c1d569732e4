"""Blake3Air proofs of plonky3_tpu_torch at 8 rows (9,168 columns) under
the Poseidon2 config: `prove()` and the device-transcript prover give the
same proof, through the blocked generic fold; both the port's verifier
and the JAX verifier accept it, and each tampered copy is rejected by
both with the same error. The proof against the JAX `prove` (a cold JAX
prove of 9,168 columns) is marked slow. Every comparison is exact."""

import copy

import jax.numpy as jnp
import numpy as np
import pytest

from plonky3_tpu.fields import KoalaBear as JF
from plonky3_tpu.fields import KoalaBearExt4 as JE
from plonky3_tpu.models import blake3_air as j_air
from plonky3_tpu.stark.config import poseidon2_stark_config as j_config
from plonky3_tpu.stark.prover import prove as j_prove
from plonky3_tpu.stark.verifier import verify as j_verify
from plonky3_tpu_torch.compat import fri_params_from
from plonky3_tpu_torch.fields import KoalaBear as F
from plonky3_tpu_torch.fields import KoalaBearExt4 as E
from plonky3_tpu_torch.models import blake3_air
from plonky3_tpu_torch.stark import fast_prover, prover
from plonky3_tpu_torch.stark.config import poseidon2_stark_config
from plonky3_tpu_torch.stark.verifier import verify
from test_torch_prove import PARAMS, _raised, as_plain, to_reference

N = 8


@pytest.fixture(scope="module")
def blake3():
    inputs = np.random.default_rng(3).integers(
        0, 1 << 32, size=(N, 24), dtype=np.uint64).astype(np.uint32)
    air = blake3_air.Blake3Air(F)
    cfg = poseidon2_stark_config(F, E, fri_params_from(PARAMS), device="cpu")
    trace = blake3_air.generate_blake3_trace(F, inputs, device="cpu")
    before = prover.FOLD_BLOCKS["count"]
    ours = prover.prove(cfg, air, trace, [])
    blocks = prover.FOLD_BLOCKS["count"] - before
    return dict(inputs=inputs, air=air, cfg=cfg, ours=ours, blocks=blocks,
                fast=fast_prover._prove_device_fs(cfg, air, trace, []),
                j_air=j_air.Blake3Air(JF), j_cfg=j_config(JF, JE, PARAMS))


def test_provers_agree(blake3):
    proof = blake3["ours"]
    assert as_plain(blake3["fast"]) == as_plain(proof)
    assert proof.degree_bits == 3
    assert len(proof.opened_values.trace_local) == 9168
    assert len(proof.opened_values.trace_next) == 9168
    assert len(proof.opened_values.quotient_chunks) == 2
    # Nq = 16 rows, one block of the host's free memory
    assert blake3["blocks"] == 1 and prover.FOLD_BLOCKS["rows"] == 16


@pytest.mark.parametrize("which", ["ours", "fast"])
def test_both_verifiers_accept(blake3, which):
    proof = blake3[which]
    assert verify(blake3["cfg"], blake3["air"], proof, []) is None
    j_verify(blake3["j_cfg"], blake3["j_air"], to_reference(proof), [])


def _with_extra_constraint(air):
    """`air` with one more constraint: its first trace column is zero."""
    class Extra(type(air)):
        def eval(self, b):
            super().eval(b)
            b.assert_zero(b.main.local[0])

    extra = copy.copy(air)
    extra.__class__ = Extra
    return extra


def _tampered(proof, name):
    bad = copy.deepcopy(proof)
    ov = bad.opened_values
    if name == "trace_local":
        ov.trace_local[5] = E.add_h(ov.trace_local[5], E.one_h())
    elif name == "trace_next":
        ov.trace_next[0] = E.add_h(ov.trace_next[0], E.one_h())
    elif name == "quotient_chunk":
        ov.quotient_chunks[1][2] = E.add_h(ov.quotient_chunks[1][2],
                                           E.one_h())
    else:
        raise ValueError(name)
    return bad


@pytest.mark.parametrize("name,error", [
    ("trace_local", "InvalidOpeningArgument"),
    ("trace_next", "InvalidOpeningArgument"),
    ("quotient_chunk", "InvalidOpeningArgument"),
    ("other_air", "OodEvaluationMismatch")])
def test_verifiers_reject_tampered_proof_alike(blake3, name, error):
    air, j_air_ = blake3["air"], blake3["j_air"]
    if name == "other_air":
        bad = blake3["ours"]
        air, j_air_ = (_with_extra_constraint(air),
                       _with_extra_constraint(j_air_))
    else:
        bad = _tampered(blake3["ours"], name)
    ours = _raised(lambda: verify(blake3["cfg"], air, bad, []))
    ref = _raised(lambda: j_verify(blake3["j_cfg"], j_air_,
                                   to_reference(bad), []))
    assert ours == ref
    assert ours[0] == error


@pytest.mark.slow
def test_proof_equals_reference(blake3):
    trace = JF.to_monty_np(j_air.generate_blake3_trace(JF, blake3["inputs"]))
    ref = j_prove(blake3["j_cfg"], blake3["j_air"], jnp.asarray(trace), [])
    assert as_plain(blake3["ours"]) == as_plain(ref)
