"""The ZK FibonacciAir proof of test_torch_zk.py under the main path's
FRI parameters, `new_benchmark_high_arity()` (100 queries, arity up to
8, 16-bit query proof of work): the port's proof from seed 1 equals the
JAX `prove`'s, and each verifier accepts the other package's proof. Its
own file, so that its cold JAX prove runs beside the other's."""

from plonky3_tpu.models.fibonacci import FibonacciAir as JFibonacciAir
from plonky3_tpu.stark.verifier import verify as j_verify
from plonky3_tpu_torch.fields import KoalaBear as F
from plonky3_tpu_torch.models.fibonacci import FibonacciAir
from plonky3_tpu_torch.stark.verifier import verify
from test_torch_prove import as_plain, to_port, to_reference
from test_torch_zk import JF, LOG_N, _config, zk_proofs


def test_high_arity_proof_equals_reference_and_verifies():
    p = zk_proofs("high_arity")
    assert as_plain(p["ours"]) == as_plain(p["ref"])
    assert p["ours"].degree_bits == LOG_N + 1
    j_verify(p["j_cfg"], JFibonacciAir(JF), to_reference(p["ours"]),
             p["publics"])
    verify(_config("high_arity", 1), FibonacciAir(F), to_port(p["ref"]),
           p["publics"])
