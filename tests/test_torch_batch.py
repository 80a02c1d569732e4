"""The lookup-free batch STARK of plonky3_tpu_torch against plonky3_tpu's
(`stark/batch.py`): the reference test's three instances (FibonacciAir
at 16 and 64 rows, Poseidon2VectorAir(KoalaBear, 16, 1) at 8 rows) under
one commitment give a `BatchProof` equal to the JAX `prove_batch`'s under
the Poseidon2 config (under the keccak config, whose tree injects the
mixed heights by its compression entry, in test_torch_batch_keccak.py,
so that the two cold JAX proves run side by side); each verifier
accepts the other's proof, and a changed public value or opened value is
rejected by both with the same error class and message."""

import copy
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

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
from plonky3_tpu.stark import batch as j_batch
from plonky3_tpu.stark import config as j_stark_config
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
from plonky3_tpu_torch.stark import batch
from plonky3_tpu_torch.stark import config as stark_config
from test_torch_prove import _raised, as_plain, to_port, to_reference

PARAMS = JFriParameters.new_testing()
# the reference test's instances: (kind, log_n)
SHAPES = [("fibonacci", 4), ("poseidon2", 3), ("fibonacci", 6)]


def port_instances(device="cpu"):
    inputs = JF.rand_np(np.random.default_rng(0xBA7C4), (8, 16))
    out = []
    for kind, log_n in SHAPES:
        if kind == "fibonacci":
            trace, publics = generate_fibonacci_trace(F, log_n,
                                                      device=device)
            out.append(batch.BatchInstance(FibonacciAir(F), trace, publics))
        else:
            air = Poseidon2VectorAir(F, 16, vector_len=1)
            trace, _ = generate_vectorized_trace(
                air, trace_inputs_from_numpy(inputs, device), device=device)
            out.append(batch.BatchInstance(air, trace, []))
    return out


def _reference_instances():
    inputs = JF.rand_np(np.random.default_rng(0xBA7C4), (8, 16))
    out = []
    for kind, log_n in SHAPES:
        if kind == "fibonacci":
            rows, publics = j_fibonacci_trace(JF, log_n)
            out.append(j_batch.BatchInstance(
                JFibonacciAir(JF), jnp.asarray(JF.to_monty_np(rows)),
                publics))
        else:
            air = JP2Air(JF, 16, vector_len=1)
            trace, _ = j_generate(air, jnp.asarray(inputs))
            out.append(j_batch.BatchInstance(air, trace, []))
    return out


def batch_to_reference(proof):
    """The port's BatchProof as the reference's class."""
    return j_batch.BatchProof(**{
        f.name: (to_reference(getattr(proof, f.name))
                 if f.name == "opening_proof" else getattr(proof, f.name))
        for f in dataclasses.fields(proof)})


def _batch_to_port(proof):
    return batch.BatchProof(**{
        f.name: (to_port(getattr(proof, f.name))
                 if f.name == "opening_proof" else getattr(proof, f.name))
        for f in dataclasses.fields(proof)})


def batch_proofs(kind):
    """Both packages' proofs of the three instances under config `kind`
    (poseidon2 or keccak)."""
    j_cfg = getattr(j_stark_config, f"{kind}_stark_config")(JF, JE, PARAMS)
    j_inst = _reference_instances()
    ref = j_batch.prove_batch(j_cfg, j_inst)
    cfg = getattr(stark_config, f"{kind}_stark_config")(
        F, E, fri_params_from(PARAMS), device="cpu")
    inst = port_instances()
    ours = batch.prove_batch(cfg, inst)
    return dict(ref=ref, ours=ours, j_cfg=j_cfg, cfg=cfg,
                j_airs=[i.air for i in j_inst], airs=[i.air for i in inst],
                publics=[i.public_values for i in inst])


@pytest.fixture(scope="module")
def proofs():
    return batch_proofs("poseidon2")


def test_proof_equals_reference(proofs):
    assert as_plain(proofs["ours"]) == as_plain(proofs["ref"])
    assert proofs["ours"].degree_bits == [4, 3, 6]
    j_batch.verify_batch(proofs["j_cfg"], proofs["j_airs"],
                         batch_to_reference(proofs["ours"]),
                         proofs["publics"])
    batch.verify_batch(proofs["cfg"], proofs["airs"],
                       _batch_to_port(proofs["ref"]), proofs["publics"])


@pytest.mark.parametrize("name", ["public_values", "opened_main"])
def test_tampered_proof_rejected_as_reference(proofs, name):
    bad = copy.deepcopy(proofs["ours"])
    publics = [list(p) for p in proofs["publics"]]
    if name == "public_values":
        publics[2][2] = (publics[2][2] + 1) % F.P
    else:
        lo, nx = bad.opened_main[1]
        lo = list(lo)
        lo[3] = tuple((x + 1) % F.P for x in lo[3])
        bad.opened_main[1] = (lo, nx)
    got = _raised(lambda: batch.verify_batch(proofs["cfg"], proofs["airs"],
                                             bad, publics))
    want = _raised(lambda: j_batch.verify_batch(
        proofs["j_cfg"], proofs["j_airs"], batch_to_reference(bad),
        publics))
    assert got == want
    assert got[0] == "VerificationError"
