"""The port's command line: `prove`, as `plonky3_tpu/cli.py` has it (the
`examples/examples/prove_prime_field_31.rs` analog, :51-73 flag matrix).

    python -m plonky3_tpu_torch.cli prove --field baby-bear \
        --objective poseidon-2-permutations --log-trace-length 17 \
        --fri benchmark-high-arity --merkle-hash keccak-f --prover fast

It takes the reference's flags and defaults, and `--device` (default
`cuda`; `--device cpu` runs the kernels' plain versions). With no CUDA
device and no `--device cpu` it exits with an error. It prints what the
reference prints: the objective line, the spans (trace generation, each
prove and its stages, the host verify), the proof size and the soundness
bits. `build` makes the (config, AIR, trace, public values) of a run and
`run` proves, verifies and reports it; `chip_smoke.py` proves through
`build` what this command proves.

`--field mersenne-31` proves under `circle_stark_config` (the circle PCS
over QM31, the KeccakF Merkle tree, SerializingChallenger32), whatever
`--merkle-hash` says, as the reference does; its FRI must fold by 2
(`--fri testing` or `benchmark`). The device-transcript prover covers the
two-adic PCS only, so a circle run proves with `prove()` and says so.
`poseidon-2-permutations` over Mersenne-31 fails as the reference's does:
there are no Poseidon2 constants for it.

Not ported yet: the `pcs-comparison` command (FRI against STIR and WHIR),
which raises NotImplementedError.
"""

from __future__ import annotations

import argparse
import contextlib
import time
from dataclasses import dataclass

import numpy as np

FIELDS = ("koala-bear", "baby-bear", "mersenne-31")
OBJECTIVES = ("poseidon-2-permutations", "fibonacci", "keccak-f-permutations",
              "blake3-permutations")
FRIS = ("testing", "benchmark", "benchmark-high-arity")
MERKLE_HASHES = ("poseidon2", "keccak-f")
PROVERS = ("host", "fast")


def field_pair(name):
    """(base field, degree-4 extension) of a `--field` value."""
    from .fields import BabyBear, BabyBearExt4, KoalaBear, KoalaBearExt4
    from .fields.mersenne31 import Mersenne31
    from .fields.qm31 import QM31

    return {"koala-bear": (KoalaBear, KoalaBearExt4),
            "baby-bear": (BabyBear, BabyBearExt4),
            "mersenne-31": (Mersenne31, QM31)}[name]



def fri_params(name):
    from .fri.config import FriParameters

    return {"testing": FriParameters.new_testing,
            "benchmark": FriParameters.new_benchmark,
            "benchmark-high-arity":
                FriParameters.new_benchmark_high_arity}[name]()


class Spans:
    """The reference's span list (a tracing-forest analog): (name,
    seconds) rows in order; a nested row's name starts with two spaces. A
    span on a CUDA device waits for the device at its end."""

    def __init__(self, device=None):
        self.rows = []
        self.device = device

    @contextlib.contextmanager
    def span(self, name):
        t0 = time.perf_counter()
        yield
        if self.device is not None and self.device.type == "cuda":
            import torch

            torch.cuda.synchronize(self.device)
        self.rows.append((name, time.perf_counter() - t0))

    def report(self):
        total = sum(t for n, t in self.rows if not n.startswith("  "))
        for name, t in self.rows:
            print(f"  {name:<28s} {t*1e3:10.1f} ms")
        print(f"  {'TOTAL':<28s} {total*1e3:10.1f} ms")
        return total


@dataclass
class Job:
    """What `build` makes: a proof's inputs and the line that names them."""

    config: object
    air: object
    trace: object
    publics: list
    log_n: int
    objective: str  # the reference's objective line ("" for fibonacci)


def build(field="koala-bear", objective="poseidon-2-permutations",
          log_trace_length=10, log_vector_len=3, fri="benchmark-high-arity",
          merkle_hash="poseidon2", device=None, spans=None) -> Job:
    """The config, AIR, trace and public values of one `prove` run, on
    `device` (default cuda), the inputs from np.random.default_rng(1) as
    the reference makes them (plonky3_tpu/cli.py:108-156). Trace
    generation is timed into `spans` (a `Spans`) when given."""
    from . import default_device
    from .compat import trace_inputs_from_numpy
    from .stark.config import (circle_stark_config, keccak_stark_config,
                               poseidon2_stark_config)

    dev = default_device(device)
    F, E = field_pair(field)
    if field == "mersenne-31":
        fp = fri_params(fri)
        if fp.max_log_arity != 1:
            raise ValueError("circle FRI folds by 2: use --fri testing or "
                             "benchmark")
        config = circle_stark_config(fp, device=dev)
    else:
        make_config = {"poseidon2": poseidon2_stark_config,
                       "keccak-f": keccak_stark_config}[merkle_hash]
        config = make_config(F, E, fri_params(fri), device=dev)
    spans = spans or Spans(dev)
    log_n = log_trace_length
    rng = np.random.default_rng(1)
    publics, line = [], ""
    if objective == "poseidon-2-permutations":
        from .models.poseidon2_air import (Poseidon2VectorAir,
                                           generate_vectorized_trace)

        vector_len = 1 << log_vector_len
        air = Poseidon2VectorAir(F, 16, vector_len=vector_len)
        n_perms = vector_len << log_n
        inputs = trace_inputs_from_numpy(F.rand_np(rng, (n_perms, 16)), dev)
        with spans.span("generate trace (device)"):
            trace, _ = generate_vectorized_trace(air, inputs, device=dev)
        line = (f"objective: {n_perms} Poseidon2-16 permutations "
                f"({vector_len}/row x 2^{log_n} rows, width {air.width})")
    elif objective == "keccak-f-permutations":
        from .models.keccak_air import KeccakAir, generate_keccak_trace

        air = KeccakAir(F)
        n_perms = max((1 << log_n) // 24, 1)
        inputs = rng.integers(0, 1 << 64, size=(n_perms, 25),
                              dtype=np.uint64)
        with spans.span("generate trace (host)"):
            trace = generate_keccak_trace(F, inputs, device=dev)
        line = (f"objective: {n_perms} keccak-f[1600] permutations "
                f"(24 rows each, width {air.width})")
    elif objective == "blake3-permutations":
        from .models.blake3_air import Blake3Air, generate_blake3_trace

        air = Blake3Air(F)
        n_perms = 1 << log_n
        inputs = rng.integers(0, 1 << 32, size=(n_perms, 24),
                              dtype=np.uint64).astype(np.uint32)
        with spans.span("generate trace (host)"):
            trace = generate_blake3_trace(F, inputs, device=dev)
        line = (f"objective: {n_perms} blake3 compressions "
                f"(1 row each, width {air.width})")
    elif objective == "fibonacci":
        from .models.fibonacci import FibonacciAir, generate_fibonacci_trace

        air = FibonacciAir(F)
        with spans.span("generate trace (host)"):
            trace, publics = generate_fibonacci_trace(F, log_n, device=dev)
    else:
        raise ValueError(f"unknown objective {objective}")
    return Job(config, air, trace, publics, log_n, line)


def soundness_bits(config, air, log_n):
    """(conjectured, proven) soundness bits of a proof, as the reference's
    report computes them (cli.py:179-206)."""
    from .air.api import get_symbolic_layout
    from .stark.security import (FriRegime, InstanceShape, StarkAirParams,
                                 conjectured_security, proven_security)

    fp = config.pcs.fri
    n_cons, max_deg = get_symbolic_layout(air)
    regime = FriRegime(
        log_blowup=fp.log_blowup, num_queries=fp.num_queries,
        log_final_poly_len=fp.log_final_poly_len,
        max_log_arity=fp.max_log_arity,
        commit_pow_bits=fp.commit_proof_of_work_bits,
        query_pow_bits=fp.query_proof_of_work_bits)
    shape = InstanceShape(log_trace_length=log_n,
                          modulus_bits=31.0 * config.E.D,
                          collision_resistance=128.0)
    air_params = StarkAirParams(num_constraints=n_cons,
                                max_constraint_degree=max_deg, max_combo=2)
    return (conjectured_security(regime, shape),
            proven_security(regime, air_params, shape))


def chosen_prover(config, prover="host") -> str:
    """The prover a run takes: `fast` (the device transcript) covers the
    two-adic PCS only, so a circle config proves with `host`."""
    from .circle_pcs import CirclePcs

    return "host" if isinstance(config.pcs, CirclePcs) else prover


def run(job: Job, prover="host", repeat=1, spans=None):
    """Prove `job` `repeat` times with the host-transcript prover
    (`host`) or the device-transcript one (`fast`; `chosen_prover`),
    verify the last proof on the host, and print the report. Returns the
    proof."""
    from .stark.verifier import verify

    chosen = chosen_prover(job.config, prover)
    if chosen == "fast":
        from .stark.fast_prover import prove_fast as prove
    else:
        from .stark.prover import prove
    spans = spans or Spans(job.config.device)
    if job.objective:
        print(job.objective)
    if chosen != prover:
        print(f"prover: {chosen} (prove(); the device-transcript prover "
              f"covers the two-adic PCS only)")
    else:
        print(f"prover: {chosen}")
    for rep in range(repeat):
        phase = {}
        with spans.span(f"prove (total, run {rep})"):
            proof = prove(job.config, job.air, job.trace, job.publics,
                          spans=phase)
        spans.rows.extend((f"  prove: {k}", v) for k, v in phase.items())
    with spans.span("verify (host)"):
        verify(job.config, job.air, proof, job.publics)
    spans.report()
    print(f"  proof size: {proof.size_in_bytes()} bytes")
    conj, proven = soundness_bits(job.config, job.air, job.log_n)
    print(f"  soundness: {conj:.1f} bits conjectured, {proven:.1f} proven")
    return proof


def cmd_prove(args):
    from . import default_device

    try:
        dev = default_device(args.device)
    except RuntimeError:
        raise SystemExit("plonky3_tpu_torch.cli: no CUDA device is "
                         "available; pass --device cpu to run the kernels' "
                         "plain versions on the CPU") from None
    spans = Spans(dev)
    job = build(args.field, args.objective, args.log_trace_length,
                args.log_vector_len, args.fri, args.merkle_hash, dev, spans)
    return run(job, args.prover, args.repeat, spans)


def cmd_pcs_comparison(args):
    raise NotImplementedError("pcs-comparison compares FRI with STIR and "
                              "WHIR, which are not ported yet (M21)")


def main(argv=None):
    ap = argparse.ArgumentParser(prog="plonky3_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("prove")
    p.add_argument("--field", default="koala-bear", choices=FIELDS)
    p.add_argument("--objective", default="poseidon-2-permutations",
                   choices=OBJECTIVES)
    p.add_argument("--log-trace-length", type=int, default=10)
    p.add_argument("--log-vector-len", type=int, default=3)
    p.add_argument("--fri", default="benchmark-high-arity", choices=FRIS)
    p.add_argument("--merkle-hash", default="poseidon2",
                   choices=MERKLE_HASHES)
    p.add_argument("--prover", default="host", choices=PROVERS,
                   help="host = the host-transcript prover; fast = the "
                        "device-transcript prover")
    p.add_argument("--repeat", type=int, default=1,
                   help="prove N times; report each (steady-state timing)")
    p.add_argument("--device", default="cuda",
                   help="cuda (the default) or cpu (the kernels' plain "
                        "versions)")
    sub.add_parser("pcs-comparison", help="not ported yet (M21)")
    args = ap.parse_args(argv)
    if args.cmd == "prove":
        return cmd_prove(args)
    return cmd_pcs_comparison(args)


if __name__ == "__main__":
    main()
