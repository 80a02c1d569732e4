"""The port's CLI (`plonky3_tpu_torch/cli.py`) and its soundness
calculator (`stark/security.py`) against the reference's.

The security functions equal the reference's on a grid of FRI regimes and
AIR shapes; `cli.main(["prove", ..., "--device", "cpu"])` for fibonacci
and a small poseidon-2-permutations run, over both fields and both Merkle
hashes, prints the reference's objective line, its proof size (the
reference `Proof.size_in_bytes` of the port's proof, which equals the
reference's proof where the other tests compare them, and here once
against a reference prove) and its soundness bits; Mersenne-31 refuses
the default FRI (arity 8) and has no Poseidon2 constants, and the
unported command raises NotImplementedError; without a card the default
device exits with an error; and importing the CLI imports no JAX.
"""

import itertools
import math
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from plonky3_tpu.air.api import get_symbolic_layout as j_layout
from plonky3_tpu.fields import BabyBear as JBabyBear
from plonky3_tpu.fields import BabyBearExt4 as JBabyBearExt4
from plonky3_tpu.fields import KoalaBear as JKoalaBear
from plonky3_tpu.fri.config import FriParameters as JFriParameters
from plonky3_tpu.models.fibonacci import (
    FibonacciAir as JFibonacci,
    generate_fibonacci_trace as j_fibonacci_trace,
)
from plonky3_tpu.models.poseidon2_air import Poseidon2VectorAir as JAir
from plonky3_tpu.stark import security as jsec
from plonky3_tpu.stark.config import poseidon2_stark_config as j_config
from plonky3_tpu.stark.prover import prove as j_prove
from plonky3_tpu_torch import cli
from plonky3_tpu_torch.stark import security
from test_torch_prove import as_plain, to_reference

REPO = Path(__file__).resolve().parent.parent
REGIMES = [dict(log_blowup=b, num_queries=q, log_final_poly_len=f,
                max_log_arity=a, commit_pow_bits=c, query_pow_bits=p)
           for b, q, f, a, c, p in itertools.product(
               (0, 1, 2, 3), (2, 100), (0, 3), (1, 3), (0, 4), (0, 16))]


@pytest.mark.parametrize("log_n", [0, 3, 17, 22])
@pytest.mark.parametrize("bits", [31.0 * 4, 31.0 * 8, 0.0])
def test_security_matches_reference(log_n, bits):
    """conjectured_security and proven_security, and the pieces they are
    made of, on every regime of the grid."""
    shape = dict(log_trace_length=log_n, modulus_bits=bits,
                 collision_resistance=128.0)
    for kw, (cons, deg) in itertools.product(REGIMES, [(1, 2), (2256, 3)]):
        air = dict(num_constraints=cons, max_constraint_degree=deg,
                   max_combo=2)
        got = (security.FriRegime(**kw), security.StarkAirParams(**air),
               security.InstanceShape(**shape))
        want = (jsec.FriRegime(**kw), jsec.StarkAirParams(**air),
                jsec.InstanceShape(**shape))
        assert security.conjectured_security(got[0], got[2]) == \
            jsec.conjectured_security(want[0], want[2])
        assert security.proven_security(*got) == jsec.proven_security(*want)
        assert security.proven_error_udr(*got) == \
            jsec.proven_error_udr(*want)
        for m in (3, 7):
            a, b = (security.proven_error_ldr_m(*got, m),
                    jsec.proven_error_ldr_m(*want, m))
            assert a == b or (math.isnan(a) and math.isnan(b))


def _reference_report(field, objective, fri, log_n, vector_len):
    """The reference's objective line and soundness line (cli.py:179-206)
    for the same run, from its own AIR and security module."""
    F = {"baby-bear": JBabyBear, "koala-bear": JKoalaBear}[field]
    if objective == "fibonacci":
        air, line = JFibonacci(F), None
    else:
        air = JAir(F, 16, vector_len=vector_len)
        line = (f"objective: {vector_len << log_n} Poseidon2-16 "
                f"permutations ({vector_len}/row x 2^{log_n} rows, width "
                f"{air.width})")
    n_cons, max_deg = j_layout(air)
    regime = jsec.FriRegime(
        log_blowup=fri.log_blowup, num_queries=fri.num_queries,
        log_final_poly_len=fri.log_final_poly_len,
        max_log_arity=fri.max_log_arity,
        commit_pow_bits=fri.commit_proof_of_work_bits,
        query_pow_bits=fri.query_proof_of_work_bits)
    shape = jsec.InstanceShape(log_trace_length=log_n,
                               modulus_bits=31.0 * 4,
                               collision_resistance=128.0)
    air_params = jsec.StarkAirParams(num_constraints=n_cons,
                                     max_constraint_degree=max_deg,
                                     max_combo=2)
    soundness = (f"  soundness: {jsec.conjectured_security(regime, shape):.1f}"
                 f" bits conjectured, "
                 f"{jsec.proven_security(regime, air_params, shape):.1f} "
                 f"proven")
    return line, soundness


@pytest.mark.parametrize("merkle", ["keccak-f", "poseidon2"])
@pytest.mark.parametrize("field", ["baby-bear", "koala-bear"])
@pytest.mark.parametrize("objective,log_n,log_v", [
    ("fibonacci", 4, 0), ("poseidon-2-permutations", 3, 1)])
def test_prove_prints_reference_report(capsys, field, merkle, objective,
                                       log_n, log_v):
    proof = cli.main(["prove", "--field", field, "--objective", objective,
                      "--log-trace-length", str(log_n), "--log-vector-len",
                      str(log_v), "--fri", "testing", "--merkle-hash",
                      merkle, "--prover", "fast", "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    line, soundness = _reference_report(field, objective,
                                        JFriParameters.new_testing(), log_n,
                                        1 << log_v)
    assert (out[0] == line) if line else not out[0].startswith("objective")
    assert f"  proof size: {to_reference(proof).size_in_bytes()} bytes" \
        in out
    assert soundness in out
    for span in ("prove (total, run 0)", "  prove: commit trace",
                 "verify (host)", "TOTAL"):
        assert any(s.strip().startswith(span.strip()) for s in out), span


def test_prove_equals_reference_proof(capsys):
    """One run against the reference's own prove: BabyBear fibonacci
    under the Poseidon2 config, its proof and printed size."""
    proof = cli.main(["prove", "--field", "baby-bear", "--objective",
                      "fibonacci", "--log-trace-length", "4", "--fri",
                      "testing", "--device", "cpu"])
    rows, publics = j_fibonacci_trace(JBabyBear, 4)
    ref = j_prove(j_config(JBabyBear, JBabyBearExt4,
                           JFriParameters.new_testing()),
                  JFibonacci(JBabyBear),
                  jnp.asarray(JBabyBear.to_monty_np(rows)), publics)
    assert as_plain(proof) == as_plain(ref)
    assert f"  proof size: {ref.size_in_bytes()} bytes" in \
        capsys.readouterr().out.splitlines()


def test_unported_field_and_command_raise(capsys):
    # the default FRI folds by 8, which circle FRI refuses (the
    # reference asserts max_log_arity == 1), and Poseidon2 has no
    # Mersenne-31 constants
    with pytest.raises(ValueError, match="folds by 2"):
        cli.main(["prove", "--field", "mersenne-31", "--device", "cpu"])
    with pytest.raises(NotImplementedError,
                       match="Poseidon2 over Mersenne31"):
        cli.main(["prove", "--field", "mersenne-31", "--fri", "testing",
                  "--device", "cpu"])
    # pcs-comparison runs: FRI, STIR and WHIR each prove, verify and
    # print their line, then WHIR's soundness line
    capsys.readouterr()
    results = cli.main(["pcs-comparison", "--device", "cpu",
                        "--log-trace-length", "6", "--width", "4"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == ("pcs comparison: 2^6 x 4 koala-bear matrix, "
                        "1 opening point")
    for line, name in zip(lines[1:4], ("fri", "stir", "whir")):
        assert line.startswith(f"  {name:<6s} commit+open ")
        assert line.endswith(f"proof {results[name][2]} bytes")
    assert lines[4].lstrip().startswith("whir soundness (johnson, target "
                                        "60b): ")


def test_default_device_is_cuda():
    """Without --device the CLI proves on the card, and exits with an
    error where there is none; it never carries on on the CPU."""
    if torch.cuda.is_available():
        assert cli.build(objective="fibonacci", log_trace_length=3,
                         fri="testing").trace.device.type == "cuda"
        return
    with pytest.raises(SystemExit, match="--device cpu"):
        cli.main(["prove", "--objective", "fibonacci",
                  "--log-trace-length", "3"])


def test_cli_imports_no_jax():
    code = ("import sys, plonky3_tpu_torch.cli, plonky3_tpu_torch.stark."
            "security; print(sorted(m for m in sys.modules if m == 'jax' "
            "or m.startswith('jax.') or m == 'plonky3_tpu' or "
            "m.startswith('plonky3_tpu.')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"


def test_build_gives_what_prove_proves():
    """`build` at the benchmark's vector length: the trace's shape and the
    AIR's width over BabyBear (2^3 rows of 8 permutations, 2,384 columns)."""
    job = cli.build("baby-bear", "poseidon-2-permutations", 3, 3, "testing",
                    "keccak-f", "cpu")
    assert job.trace.shape == (8, 2384) and job.air.width == 2384
    assert job.objective.startswith("objective: 64 Poseidon2-16")
    assert job.config.F.name == "BabyBear" and job.config.E.W == 11
    assert isinstance(job.trace, torch.Tensor) and job.publics == []
    assert np.array_equal(job.trace[0, :16].numpy(),
                          JBabyBear.rand_np(np.random.default_rng(1),
                                            (64, 16))[0])
