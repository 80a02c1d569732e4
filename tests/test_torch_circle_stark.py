"""The uni-STARK over the circle PCS (Mersenne-31): the port against the
reference (uni-stark/tests/fib_air.rs's circle path).

Under `circle_stark_config(new_testing())`, FibonacciAir at log_n 5: the
port's `prove()` on the CPU gives the JAX `prove()`'s proof from the same
numpy trace; each verifier accepts the other's proof; both reject the
reference test's bad public value; the verifier's degree bound is the
PCS's (30 for the circle); a periodic AIR fails on a circle domain in
both. The circle fixtures' config (M31Ext3, Keccak-256 byte digests):
the port's proof on the postcard wire byte for byte as the JAX encoder
writes it, decoded back, and accepted by both verifiers. The canonical
batch STARK takes the circle PCS as it is: the batch fixture's AIRs
under its circle config, proven, verified, and on the wire as the JAX
batch encoder writes it. The CLI's `--field mersenne-31` (the explicit
`prove()` choice) and its Poseidon2 error. One JAX proof serves the
file (a module fixture).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from plonky3_tpu.compat.batch_wire import (
    batch_circle_proof_to_wire as j_batch_to_wire,
)
from plonky3_tpu.compat.fixture_configs import (
    circle_fixture_config as j_fixture_config,
)
from plonky3_tpu.compat.uni_stark_wire import (
    circle_proof_to_wire as j_to_wire,
)
from plonky3_tpu.fields.mersenne31 import Mersenne31 as JF
from plonky3_tpu.fri.config import FriParameters as JFri
from plonky3_tpu.models.fibonacci import FibonacciAir as JFib
from plonky3_tpu.models.fibonacci import generate_fibonacci_trace as j_fib
from plonky3_tpu.models.poseidon2_air import Poseidon2VectorAir as JP2Air
from plonky3_tpu.serde.proof_codec import CIRCLE_SPEC as J_SPEC
from plonky3_tpu.serde.proof_codec import (
    encode_batch_proof as j_encode_batch,
)
from plonky3_tpu.serde.proof_codec import encode_proof as j_encode
from plonky3_tpu.stark import batch_ref as j_br
from plonky3_tpu.stark.config import circle_stark_config as j_config
from plonky3_tpu.stark.prover import prove as j_prove
from plonky3_tpu.stark.verifier import VerificationError as JError
from plonky3_tpu.stark.verifier import verify as j_verify
from plonky3_tpu_torch import cli
from plonky3_tpu_torch.compat import fri_params_from, trace_inputs_from_numpy
from plonky3_tpu_torch.compat import batch_fixture_airs as airs_mod
from plonky3_tpu_torch.compat.batch_wire import (
    batch_circle_proof_to_wire,
    wire_to_batch_circle_proof,
)
from plonky3_tpu_torch.compat.fixture_configs import (
    batch_circle_fixture_config,
    circle_fixture_config,
)
from plonky3_tpu_torch.compat.uni_stark_wire import (
    circle_proof_to_wire,
    circle_wire_to_proof,
)
from plonky3_tpu_torch.fields.mersenne31 import Mersenne31 as F
from plonky3_tpu_torch.models.fibonacci import FibonacciAir
from plonky3_tpu_torch.serde.proof_codec import (
    CIRCLE_SPEC,
    decode_batch_proof,
    decode_proof,
    encode_batch_proof,
    encode_proof,
)
from plonky3_tpu_torch.stark import batch, batch_ref
from plonky3_tpu_torch.stark.config import circle_stark_config
from plonky3_tpu_torch.stark.prover import prove
from plonky3_tpu_torch.stark.verifier import (
    InvalidProofShape,
    VerificationError,
    verify,
)
from test_periodic import PeriodicAir as JPeriodicAir
from test_periodic import _trace as j_periodic_trace
from test_torch_circle import to_port, to_reference
from test_torch_prove import as_plain
from torch_periodic_airs import PeriodicAir, periodic_trace

LOG_N = 5


def _port_trace(rows):
    return trace_inputs_from_numpy(rows.astype(np.uint32), "cpu", F=F)


@pytest.fixture(scope="module")
def proofs():
    """The JAX prove and the port's prove of one numpy trace."""
    rows, publics = j_fib(JF, LOG_N)
    j_cfg = j_config(JFri.new_testing())
    ref = j_prove(j_cfg, JFib(JF), jnp.asarray(JF.to_monty_np(rows)), publics)
    cfg = circle_stark_config(fri_params_from(JFri.new_testing()),
                              device="cpu")
    ours = prove(cfg, FibonacciAir(F), _port_trace(rows), publics)
    return dict(ref=ref, ours=ours, j_cfg=j_cfg, cfg=cfg, publics=publics,
                rows=rows)


def test_fibonacci_proof_equals_reference(proofs):
    assert as_plain(proofs["ours"]) == as_plain(proofs["ref"])
    assert proofs["ours"].degree_bits == LOG_N


def test_verifiers_accept_each_others_proofs(proofs):
    verify(proofs["cfg"], FibonacciAir(F), to_port(proofs["ref"]),
           proofs["publics"])
    j_verify(proofs["j_cfg"], JFib(JF), to_reference(proofs["ours"]),
             proofs["publics"])


def test_bad_publics_rejected_by_both(proofs):
    p = proofs["publics"]
    bad = [p[0], p[1], (p[2] + 1) % F.P]
    with pytest.raises(VerificationError):
        verify(proofs["cfg"], FibonacciAir(F), proofs["ours"], bad)
    with pytest.raises(JError):
        j_verify(proofs["j_cfg"], JFib(JF), to_reference(proofs["ours"]),
                 bad)


def test_degree_bound_is_the_pcs(proofs):
    """The circle PCS's LDE bound (30) is the verifier's, not the field's
    two-adicity (0): an honest degree passes the bound, one past it
    fails the shape check in both verifiers."""
    assert proofs["cfg"].pcs.log_max_lde_height() == 30
    bad = to_port(proofs["ours"])
    bad.degree_bits = 30
    with pytest.raises(InvalidProofShape, match="degree too large"):
        verify(proofs["cfg"], FibonacciAir(F), bad, proofs["publics"])
    with pytest.raises(JError, match="degree too large"):
        j_verify(proofs["j_cfg"], JFib(JF), to_reference(bad),
                 proofs["publics"])


def test_periodic_air_fails_on_a_circle_domain_in_both(proofs):
    rows = j_periodic_trace(8)
    with pytest.raises(Exception):
        j_prove(proofs["j_cfg"], JPeriodicAir(JF), jnp.asarray(rows), [])
    assert np.array_equal(rows, periodic_trace(F.P, 8))
    with pytest.raises(NotImplementedError, match="two-adic"):
        prove(proofs["cfg"], PeriodicAir(F), _port_trace(rows), [])


def test_fixture_config_wire_round_trip():
    """The circle fixtures' config: the port's proof, its wire bytes
    against the JAX encoder's, the decode back, both verifiers."""
    rows, publics = j_fib(JF, 4)
    cfg = circle_fixture_config(device="cpu")
    proof = prove(cfg, FibonacciAir(F), _port_trace(rows), publics)
    wire = encode_proof(circle_proof_to_wire(proof), CIRCLE_SPEC)
    ref = to_reference(proof)
    assert wire == j_encode(j_to_wire(ref), J_SPEC)
    back = circle_wire_to_proof(decode_proof(wire, CIRCLE_SPEC))
    assert as_plain(back) == as_plain(proof)
    verify(cfg, FibonacciAir(F), back, publics)
    j_verify(j_fixture_config(), JFib(JF), ref, publics)


def test_cli_mersenne31_proves_with_prove(capsys):
    job = cli.build("mersenne-31", "fibonacci", 4, fri="testing",
                    device="cpu")
    assert cli.chosen_prover(job.config, "fast") == "host"
    proof = cli.run(job, prover="fast")
    out = capsys.readouterr().out
    assert "prover: host (prove(); the device-transcript prover" in out
    assert proof.degree_bits == 4
    with pytest.raises(ValueError, match="folds by 2"):
        cli.build("mersenne-31", "fibonacci", 4,
                  fri="benchmark-high-arity", device="cpu")


def test_cli_mersenne31_poseidon2_fails_as_reference():
    """Poseidon2 has no Mersenne-31 constants: the reference fails on
    them, and so does the port."""
    with pytest.raises(AttributeError, match="MERSENNE31_POSEIDON2"):
        JP2Air(JF, 16, vector_len=8)
    with pytest.raises(NotImplementedError, match="Mersenne31"):
        cli.build("mersenne-31", "poseidon-2-permutations", 3, 0,
                  "testing", device="cpu")


def test_batch_circle_wire_round_trip():
    """MulAirLookups and FibAirLookups at 32 rows under
    batch_circle_fixture_config (a Merkle cap of height 3, M31Ext3):
    `batch_ref` proves and verifies over the circle PCS; the proof's
    wire bytes equal the JAX batch encoder's; decoded back, it verifies."""
    log_n = 5
    airs = [airs_mod.MulAirLookups(F, reps=2, is_local=False,
                                   is_global=True),
            airs_mod.FibAirLookups(F, log_height=log_n, is_global=True)]
    mul = airs_mod.mul_trace(F, 1 << log_n, 2)
    fib, publics = j_fib(JF, log_n)
    cfg = batch_circle_fixture_config(device="cpu")
    data = batch_ref.keygen(cfg, airs, [log_n, log_n])
    proof = batch_ref.prove_batch_ref(cfg, [
        batch.BatchInstance(airs[0], _port_trace(mul), []),
        batch.BatchInstance(airs[1], _port_trace(fib), publics)], data)
    pvs = [[], publics]
    batch_ref.verify_batch_ref(cfg, airs, proof, pvs, data)
    wire = encode_batch_proof(batch_circle_proof_to_wire(proof), CIRCLE_SPEC)
    ref = j_br.BatchRefProof(
        main_commit=proof.main_commit,
        permutation_commit=proof.permutation_commit,
        quotient_commit=proof.quotient_commit,
        instances=[j_br.BatchRefOpened(**vars(i)) for i in proof.instances],
        opening_proof=to_reference(proof.opening_proof),
        lookup_terminals=list(proof.lookup_terminals),
        degree_bits=list(proof.degree_bits))
    assert wire == j_encode_batch(j_batch_to_wire(ref), J_SPEC)
    back = wire_to_batch_circle_proof(decode_batch_proof(wire, CIRCLE_SPEC))
    assert as_plain(back) == as_plain(proof)
    batch_ref.verify_batch_ref(cfg, airs, back, pvs, data)
